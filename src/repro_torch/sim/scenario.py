"""ScenarioSpec / ClusterTrace: seeded cluster-dynamics scenarios.

A ``ScenarioSpec`` is a frozen, registered description of how a cluster
misbehaves over time — a composition of the event primitives in
``repro_torch.sim.events`` plus a horizon and a classification ``kind``
(``drift`` / ``churn`` / ``control``). ``spec.trace(base, seed)``
expands it against a concrete base ``ClusterSpec`` into a
``ClusterTrace``: a time-indexed tuple of perturbed ``ClusterSpec``s,
fully deterministic in ``(spec, base, seed)`` so scenario replays are
exact (and equal to the reference's ``repro/sim/scenario.py``).

The registry mirrors the allocation-scheme registry
(``repro_torch.core.schemes``): scenarios are registered by name with a
factory whose *named* keyword parameters are the accepted params;
``make_scenario`` rejects anything else, and ``scenario_names()`` feeds
CLI ``choices`` so ``--scenario`` is validated for free.

Built-in scenarios assume >= 2 groups (events target group indices 0/1)
with group 0 conventionally the fastest — the shape every benchmark
fleet in this repo has.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import numpy as np

from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.sim.events import (
    BadRack,
    BandwidthFade,
    Event,
    MuRandomWalk,
    MuStep,
    TraceState,
    WorkerChurn,
)

#: scenario classifications: ``control`` scenarios are stationary (the
#: adaptive controller should HOLD); ``drift``/``churn`` are the
#: non-stationary cases it must win on.
KINDS = ("drift", "churn", "control")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named cluster-dynamics scenario (frozen, registry citizen)."""

    name: str
    events: tuple[Event, ...]
    horizon: int = 120
    kind: str = "control"
    #: the registered allocation scheme whose adaptivity this scenario
    #: exercises (bandwidth scenarios need a CommDelay scheme to matter)
    scheme: str = "optimal"
    description: str = ""

    def __post_init__(self):
        if self.horizon <= 0:
            raise ValueError(f"scenario horizon must be > 0, got {self.horizon}")
        if self.kind not in KINDS:
            raise ValueError(
                f"scenario kind must be one of {KINDS}, got {self.kind!r}"
            )

    def trace(
        self,
        base: ClusterSpec,
        seed: int = 0,
        horizon: int | None = None,
    ) -> "ClusterTrace":
        """Expand against a base cluster into a deterministic trace.

        Events step BEFORE each round's snapshot, so an event ``at=0``
        already shapes the first round. ``horizon`` overrides the
        spec's (e.g. a trainer clamps the trace to its step budget).
        """
        h = self.horizon if horizon is None else int(horizon)
        if h <= 0:
            raise ValueError(f"trace horizon must be > 0, got {h}")
        rng = np.random.default_rng(seed)
        state = TraceState.from_cluster(base)
        clusters = []
        for t in range(h):
            for ev in self.events:
                ev.step(state, t, rng)
            clusters.append(state.snapshot())
        return ClusterTrace(scenario=self.name, clusters=tuple(clusters))


@dataclasses.dataclass(frozen=True)
class ClusterTrace:
    """Time-indexed sequence of perturbed ClusterSpecs (one per round)."""

    scenario: str
    clusters: tuple[ClusterSpec, ...]

    @property
    def horizon(self) -> int:
        return len(self.clusters)

    def at(self, t: int) -> ClusterSpec:
        """Cluster state at round t (clamped to the trace's ends)."""
        return self.clusters[min(max(int(t), 0), len(self.clusters) - 1)]

    def membership(self, t: int) -> tuple[int, ...]:
        """Per-group worker counts at round t (the registration truth)."""
        return tuple(g.num_workers for g in self.at(t).groups)

    def change_rounds(self) -> tuple[int, ...]:
        """Rounds whose cluster differs from the previous round's."""
        return tuple(
            t
            for t in range(1, len(self.clusters))
            if self.clusters[t] != self.clusters[t - 1]
        )


# --------------------------------------------------------------- registry
ScenarioFactory = Callable[..., ScenarioSpec]


@dataclasses.dataclass(frozen=True)
class _Registration:
    factory: ScenarioFactory
    params: frozenset


_REGISTRY: dict[str, _Registration] = {}


def _factory_params(factory: ScenarioFactory) -> frozenset:
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):
        return frozenset()
    return frozenset(
        p.name
        for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    )


def register_scenario(
    name: str, factory: ScenarioFactory, *, params=None
) -> None:
    """Register a scenario factory under a lookup name (scheme-registry
    semantics: the factory's named keyword params are the accepted
    params; ``make_scenario`` rejects anything outside them)."""
    if name in _REGISTRY:
        raise ValueError(f"scenario {name!r} already registered")
    accepted = _factory_params(factory) if params is None else frozenset(params)
    _REGISTRY[name] = _Registration(factory, accepted)


def scenario_names() -> tuple[str, ...]:
    """All registered scenario names (CLI choices, benchmark sweeps)."""
    return tuple(sorted(_REGISTRY))


def scenario_kinds() -> dict[str, str]:
    """name -> kind for every registered scenario (default params)."""
    return {name: make_scenario(name).kind for name in scenario_names()}


def make_scenario(name: str, **params) -> ScenarioSpec:
    """Resolve a registered scenario name + params to a ScenarioSpec.

    ``None`` values mean "not provided" and are dropped (so CLI callers
    can pass optional flags unconditionally); unknown parameters raise.
    """
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(scenario_names())}"
        )
    reg = _REGISTRY[name]
    provided = {key: v for key, v in params.items() if v is not None}
    unknown = sorted(set(provided) - reg.params)
    if unknown:
        accepted = ", ".join(sorted(reg.params)) or "(none)"
        raise ValueError(
            f"scenario {name!r} does not accept parameter(s) "
            f"{', '.join(unknown)}; accepted: {accepted}"
        )
    return reg.factory(**provided)


# ------------------------------------------------------ built-in scenarios
def _make_static(*, horizon=None):
    return ScenarioSpec(
        name="static",
        events=(),
        horizon=int(horizon or 120),
        kind="control",
        description="stationary cluster — the adaptive controller must "
                    "hold (any replan here is wasted recompilation)",
    )


def _make_noise(*, horizon=None, sigma=None):
    return ScenarioSpec(
        name="noise",
        events=(MuRandomWalk(sigma=float(sigma if sigma is not None else 0.01)),),
        horizon=int(horizon or 120),
        kind="control",
        description="estimation noise only: a tiny unbiased mu walk — "
                    "hysteresis must absorb it without replanning",
    )


def _make_mu_drift(*, horizon=None, sigma=None, bias=None):
    h = int(horizon or 120)
    # per-round defaults scale with the horizon so the TOTAL drift is
    # horizon-invariant (walk dispersion ~ sigma*sqrt(h), trend ~ bias*h):
    # a reduced-horizon replay stresses the controller identically
    sigma = float(sigma) if sigma is not None else 0.44 / np.sqrt(h)
    bias = float(bias) if bias is not None else -3.6 / h
    return ScenarioSpec(
        name="mu_drift",
        events=(
            MuRandomWalk(sigma=sigma),
            # the fast group slowly degrades (shared-cluster contention):
            # a deterministic trend the static plan cannot track
            MuRandomWalk(sigma=0.0, bias=bias, group=0),
        ),
        horizon=h,
        kind="drift",
        description="all groups random-walk; the fast group trends slower "
                    "round over round (total drift horizon-invariant)",
    )


def _make_mu_step(*, horizon=None, factor=None, at=None):
    h = int(horizon or 120)
    return ScenarioSpec(
        name="mu_step",
        events=(
            MuStep(
                at=int(at if at is not None else h // 3),
                group=0,
                factor=float(factor if factor is not None else 0.05),
            ),
        ),
        horizon=h,
        kind="drift",
        description="the fastest group's mu collapses 20x mid-trace — the "
                    "canonical straggler onset the controller must catch",
    )


def _make_churn(*, horizon=None, frac=None):
    h = int(horizon or 120)
    f = float(frac if frac is not None else 0.5)
    if not 0 < f < 1:
        raise ValueError(f"churn frac must be in (0, 1), got {f}")
    return ScenarioSpec(
        name="churn",
        events=(
            WorkerChurn(at=h // 4, group=1, frac=-f),
            # frac applies to the group's CURRENT (shrunken) size, so
            # restoring the original capacity needs f/(1-f), not f
            WorkerChurn(at=(2 * h) // 3, group=1, frac=f / (1.0 - f)),
        ),
        horizon=h,
        kind="churn",
        description="the biggest group loses half its workers, then a "
                    "join burst restores the original capacity "
                    "(load-bearing only after a replan)",
    )


def _make_bw_collapse(*, horizon=None, factor=None):
    h = int(horizon or 120)
    return ScenarioSpec(
        name="bw_collapse",
        events=(
            BandwidthFade(
                start=h // 3, end=(2 * h) // 3, group=0,
                factor=float(factor if factor is not None else 0.02),
            ),
        ),
        horizon=h,
        kind="drift",
        scheme="comm_aware",
        description="the fast group's link degrades 50x then recovers — "
                    "only a CommDelay scheme can route around it",
    )


def _make_bad_rack(*, horizon=None):
    h = int(horizon or 120)
    return ScenarioSpec(
        name="bad_rack",
        events=(
            BadRack(start=h // 3, end=(2 * h) // 3, group=0,
                    mu_factor=0.1, bw_factor=0.1),
        ),
        horizon=h,
        kind="drift",
        scheme="comm_aware",
        description="correlated rack incident: one group's compute AND "
                    "link collapse together, then recover",
    )


register_scenario("static", _make_static)
register_scenario("noise", _make_noise)
register_scenario("mu_drift", _make_mu_drift)
register_scenario("mu_step", _make_mu_step)
register_scenario("churn", _make_churn)
register_scenario("bw_collapse", _make_bw_collapse)
register_scenario("bad_rack", _make_bad_rack)
