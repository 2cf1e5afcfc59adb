"""Composable cluster-dynamics event primitives (copy of ``repro/sim/events.py``).

The paper's allocation assumes the group parameters ``(a_j, mu_j)`` are
known and static; deployed clusters drift. Each primitive below perturbs
one aspect of a ``ClusterSpec`` over simulated rounds — straggler-rate
drift, worker churn, bandwidth degradation, a correlated rack failure —
and a ``ScenarioSpec`` (``repro_torch.sim.scenario``) composes them into a
seeded, deterministic ``ClusterTrace``.

Mechanics: the trace generator walks a mutable ``TraceState`` (per-group
``num_workers/mu/alpha/bandwidth`` arrays) through the horizon, calling
``event.step(state, t, rng)`` for every event each round, then snapshots
a ``ClusterSpec``. Persistent events (random walks, step changes, churn)
mutate the state once; windowed events (bandwidth fade, bad rack) apply
a multiplicative factor on entry and undo it on exit, so they compose
with any drift that happened inside the window.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.runtime_model import ClusterSpec, GroupSpec

#: clamp band for perturbed mu — mirrors StragglerTracker's MLE clamp
#: (the shifted-exp model is only meaningful below ~750)
MU_MIN, MU_MAX = 1e-3, 750.0


@dataclasses.dataclass
class TraceState:
    """Mutable per-group state the event primitives evolve."""

    num_workers: np.ndarray  # (G,) int
    mu: np.ndarray  # (G,) float
    alpha: np.ndarray  # (G,) float
    bandwidth: np.ndarray  # (G,) float (inf = free links)

    @classmethod
    def from_cluster(cls, cluster: ClusterSpec) -> "TraceState":
        return cls(
            num_workers=np.asarray(
                [g.num_workers for g in cluster.groups], np.int64
            ),
            mu=np.asarray([g.mu for g in cluster.groups], float),
            alpha=np.asarray([g.alpha for g in cluster.groups], float),
            bandwidth=cluster.bandwidths.copy(),
        )

    def snapshot(self) -> ClusterSpec:
        """Current state as an immutable ClusterSpec (mu clamped sane)."""
        mu = np.clip(self.mu, MU_MIN, MU_MAX)
        return ClusterSpec(
            tuple(
                GroupSpec(int(n), float(m), float(a), float(b))
                for n, m, a, b in zip(
                    self.num_workers, mu, self.alpha, self.bandwidth
                )
            )
        )


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: ``step`` is called once per round, in composition order."""

    def step(self, state: TraceState, t: int, rng: np.random.Generator):
        raise NotImplementedError

    def _groups(self, state: TraceState, group: int | None) -> np.ndarray:
        if group is None:
            return np.arange(state.mu.shape[0])
        if not 0 <= group < state.mu.shape[0]:
            raise ValueError(
                f"{type(self).__name__}: group {group} out of range for a "
                f"{state.mu.shape[0]}-group cluster"
            )
        return np.asarray([group])


@dataclasses.dataclass(frozen=True)
class MuRandomWalk(Event):
    """Lognormal per-round random walk of a group's straggling rate.

    ``mu <- mu * exp(N(bias, sigma^2))`` each round: ``sigma`` is the
    per-round drift scale, ``bias`` an optional deterministic trend
    (negative = the group slowly degrades — the classic shared-cluster
    pattern where a worker pool gets progressively busier).
    """

    sigma: float = 0.05
    bias: float = 0.0
    group: int | None = None  # None = every group walks independently

    def __post_init__(self):
        if self.sigma < 0:
            raise ValueError(f"MuRandomWalk sigma must be >= 0, got {self.sigma}")

    def step(self, state, t, rng):
        idx = self._groups(state, self.group)
        steps = rng.normal(self.bias, self.sigma, size=idx.shape[0])
        state.mu[idx] = np.clip(state.mu[idx] * np.exp(steps), MU_MIN, MU_MAX)


@dataclasses.dataclass(frozen=True)
class MuStep(Event):
    """One-shot step change of a group's mu at round ``at`` (x ``factor``).

    ``factor < 1`` is the canonical straggler onset (the group suddenly
    slows down); ``factor > 1`` models recovery or an upgrade.
    """

    at: int
    group: int
    factor: float

    def __post_init__(self):
        if self.at < 0:
            raise ValueError(f"MuStep at must be >= 0, got {self.at}")
        if not self.factor > 0:
            raise ValueError(f"MuStep factor must be > 0, got {self.factor}")

    def step(self, state, t, rng):
        if t == self.at:
            idx = self._groups(state, self.group)
            state.mu[idx] = np.clip(state.mu[idx] * self.factor, MU_MIN, MU_MAX)


@dataclasses.dataclass(frozen=True)
class WorkerChurn(Event):
    """Join/leave burst: round ``at`` resizes a group by ``frac``.

    ``frac = -0.4`` removes 40% of the group's CURRENT workers (leave
    burst, never below one worker); ``frac = +0.5`` adds 50% (join
    burst / scale-up). Joins only become load-bearing once the
    controller replans them in — exactly the elasticity gap the
    adaptive loop closes.
    """

    at: int
    group: int
    frac: float

    def __post_init__(self):
        if self.at < 0:
            raise ValueError(f"WorkerChurn at must be >= 0, got {self.at}")
        if self.frac == 0 or not np.isfinite(self.frac):
            raise ValueError(
                f"WorkerChurn frac must be a nonzero fraction, got {self.frac}"
            )

    def step(self, state, t, rng):
        if t == self.at:
            idx = int(self._groups(state, self.group)[0])
            cur = int(state.num_workers[idx])
            delta = int(round(self.frac * cur))
            state.num_workers[idx] = max(1, cur + delta)


@dataclasses.dataclass(frozen=True)
class _WindowedEvent(Event):
    """Multiplicative perturbation active on rounds ``[start, end)``."""

    start: int = 0
    end: int = 0

    def __post_init__(self):
        if not 0 <= self.start < self.end:
            raise ValueError(
                f"{type(self).__name__} needs 0 <= start < end, got "
                f"[{self.start}, {self.end})"
            )

    def _apply(self, state: TraceState, invert: bool):
        raise NotImplementedError

    def step(self, state, t, rng):
        if t == self.start:
            self._apply(state, invert=False)
        elif t == self.end:
            self._apply(state, invert=True)


@dataclasses.dataclass(frozen=True)
class BandwidthFade(_WindowedEvent):
    """Link degradation: a group's bandwidth x ``factor`` during the window.

    Recovery is the window's end. Only schemes under the CommDelay model
    react (infinite-bandwidth groups are unaffected by construction —
    ``inf * factor == inf``).
    """

    group: int = 0
    factor: float = 0.1

    def __post_init__(self):
        super().__post_init__()
        if not 0 < self.factor:
            raise ValueError(
                f"BandwidthFade factor must be > 0, got {self.factor}"
            )

    def _apply(self, state, invert):
        idx = self._groups(state, self.group)
        f = 1.0 / self.factor if invert else self.factor
        state.bandwidth[idx] = state.bandwidth[idx] * f


@dataclasses.dataclass(frozen=True)
class BadRack(_WindowedEvent):
    """Correlated rack-level incident: one group's mu AND bandwidth collapse.

    Models a top-of-rack switch brownout or thermal event — compute slows
    (``mu_factor``) and the link degrades (``bw_factor``) together for
    the whole group, then both recover at the window's end.
    """

    group: int = 0
    mu_factor: float = 0.1
    bw_factor: float = 0.1

    def __post_init__(self):
        super().__post_init__()
        if not (self.mu_factor > 0 and self.bw_factor > 0):
            raise ValueError(
                f"BadRack factors must be > 0, got mu_factor={self.mu_factor}, "
                f"bw_factor={self.bw_factor}"
            )

    def _apply(self, state, invert):
        idx = self._groups(state, self.group)
        mf = 1.0 / self.mu_factor if invert else self.mu_factor
        bf = 1.0 / self.bw_factor if invert else self.bw_factor
        state.mu[idx] = np.clip(state.mu[idx] * mf, MU_MIN, MU_MAX)
        state.bandwidth[idx] = state.bandwidth[idx] * bf
