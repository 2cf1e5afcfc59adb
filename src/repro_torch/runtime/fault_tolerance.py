"""Fault tolerance and elasticity around the coded runtime.

Counterpart of ``repro/runtime/fault_tolerance.py`` (host-side numpy):

* ``StragglerTracker`` — online per-group (mu, alpha) estimation from
  observed round-trip times (shifted-exponential MLE with exponential
  forgetting), per-group link-bandwidth MLE from observed transfer
  times (``observe_transfers``), and deadline-based failure detection;
* ``ElasticController`` — a membership change or an estimate update
  replans in closed form through a ``CodedComputeEngine``, so any
  registered scheme keeps its parameters; with a ``threshold`` estimate
  updates pass the controller's hysteresis rule
  (``repro_torch.runtime.control.replan_decision``) first;
* ``deadline_for`` — a plan's expected latency times a safety factor
  (``plan_deadline``), finite for every registered scheme.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import CodedComputeEngine, plan_deadline
from repro_torch.core.planner import DeploymentPlan
from repro_torch.core.runtime_model import ClusterSpec, GroupSpec
from repro_torch.core.schemes import AllocationScheme


def deadline_for(
    plan: DeploymentPlan,
    safety: float = 3.0,
    *,
    generator=None,
    num_trials: int = 2_048,
) -> float:
    """Per-round cutoff: expected latency times a safety factor.

    The plan's analytic T* when finite, else the scheme's own Monte-Carlo
    estimate drawn from ``generator``; an alias of ``plan_deadline``.
    """
    return plan_deadline(plan, safety, generator=generator, num_trials=num_trials)


@dataclasses.dataclass
class StragglerTracker:
    """Tracks per-group runtime estimates and detects failed workers."""

    cluster: ClusterSpec
    forget: float = 0.9  # exponential forgetting of old estimates
    fail_after: int = 3  # consecutive missed deadlines => failed
    # paper Section IV: the shifted-exp latency model is only meaningful
    # for mu < ~750 (W_{-1} underflows beyond); clamp the MLE accordingly
    mu_max: float = 750.0
    mu_min: float = 1e-6

    def __post_init__(self):
        self._mu = np.asarray([g.mu for g in self.cluster.groups], float)
        self._alpha = np.asarray([g.alpha for g in self.cluster.groups], float)
        self._missed = np.zeros((self.cluster.total_workers,), int)
        self._bw = self.cluster.bandwidths.copy()
        self._bw_seen = np.zeros((self.cluster.num_groups,), bool)

    def observe_round(self, times: np.ndarray, loads: np.ndarray, k: int,
                      deadline: float | None = None):
        """Update estimates from one round of per-worker round-trip times.

        times: (N,) seconds (np.inf for workers that never responded).
        loads: (N,) rows assigned. Returns the boolean finished mask.
        """
        times = np.asarray(times, float)
        # defense in depth: the controller clamps at its ingest point,
        # but a direct caller feeding measured times can still hand us
        # non-positives (clock jitter) — the MLE normalization divides
        # and mins over these, so keep finite times positive here too
        times = np.where(np.isfinite(times), np.maximum(times, 1e-9), times)
        finished = np.isfinite(times)
        if deadline is not None:
            finished &= times <= deadline
        self._missed = np.where(finished, 0, self._missed + 1)
        # group-wise shifted-exp MLE on the finished workers
        start = 0
        for j, g in enumerate(self.cluster.groups):
            sl = slice(start, start + g.num_workers)
            t = times[sl][finished[sl]]
            l = loads[sl][finished[sl]]
            start += g.num_workers
            if t.size < 2:
                continue
            norm = t * (k / np.maximum(l, 1))  # normalize to full-task scale
            a_hat = float(norm.min())
            mu_hat = 1.0 / max(float(norm.mean() - a_hat), 1e-9)
            mu_hat = float(np.clip(mu_hat, self.mu_min, self.mu_max))
            self._alpha[j] = self.forget * self._alpha[j] + (1 - self.forget) * a_hat
            self._mu[j] = self.forget * self._mu[j] + (1 - self.forget) * mu_hat
        return finished

    def rebind(self, cluster: ClusterSpec) -> None:
        """Re-anchor per-worker state to a new membership (post-replan).

        The replanned cluster embeds the tracker's own estimates as its
        spec values (``estimated_cluster`` built it), so re-initializing
        from it preserves the (mu, alpha, bandwidth) state while the
        per-worker miss counters reset to the new fleet shape. Without
        this, ``observe_round`` would slice the next round's times with
        the OLD group sizes.
        """
        self.cluster = cluster
        self.__post_init__()

    def observe_transfers(self, transfer_times: np.ndarray,
                          payload: float = 1.0) -> np.ndarray:
        """Per-group bandwidth MLE from observed per-worker transfer times.

        Under the CommDelay model a group-j worker pays ``payload / b_j``
        time units of transfer per round, so given observed transfer
        times the MLE of the link bandwidth is ``payload / mean(t)``
        (the transfer shift is deterministic in the model; averaging
        de-noises real measurements). First observation replaces the
        spec prior (often ``inf`` = "never measured"); later ones are
        smoothed with the same exponential forgetting as (mu, alpha).
        Estimates flow into ``estimated_cluster`` and from there into
        elastic replans, so ``CommAware`` plans track measured links.

        transfer_times: (N,) per-worker transfer times (np.nan/np.inf or
        <= 0 for workers with no measurement this round). Returns the
        current per-group bandwidth estimates.
        """
        t = np.asarray(transfer_times, float)
        start = 0
        for j, g in enumerate(self.cluster.groups):
            tj = t[start:start + g.num_workers]
            start += g.num_workers
            tj = tj[np.isfinite(tj) & (tj > 0)]
            if tj.size == 0:
                continue
            b_hat = float(payload / tj.mean())
            if self._bw_seen[j] and np.isfinite(self._bw[j]):
                self._bw[j] = (
                    self.forget * self._bw[j] + (1 - self.forget) * b_hat
                )
            else:
                self._bw[j] = b_hat
            self._bw_seen[j] = True
        return self._bw.copy()

    @property
    def bandwidth_estimates(self) -> np.ndarray:
        """Current per-group bandwidth estimates (spec prior if unseen)."""
        return self._bw.copy()

    @property
    def mu_estimates(self) -> np.ndarray:
        """Current per-group straggling-rate estimates."""
        return self._mu.copy()

    @property
    def alpha_estimates(self) -> np.ndarray:
        """Current per-group shift estimates."""
        return self._alpha.copy()

    @property
    def failed_workers(self) -> np.ndarray:
        return np.flatnonzero(self._missed >= self.fail_after)

    def estimated_cluster(self) -> ClusterSpec:
        """Current membership (failed workers removed) + current estimates.

        Carries the per-group bandwidth estimates via
        ``ClusterSpec.with_bandwidths``: comm-aware schemes must not
        silently degenerate to comm-blind on replan, and measured links
        override the spec's static values.
        """
        groups, bws = [], []
        start = 0
        for j, g in enumerate(self.cluster.groups):
            sl = np.arange(start, start + g.num_workers)
            start += g.num_workers
            alive = int(np.sum(self._missed[sl] < self.fail_after))
            if alive > 0:
                groups.append(GroupSpec(alive, float(self._mu[j]),
                                        float(self._alpha[j])))
                bws.append(float(self._bw[j]))
        return ClusterSpec(tuple(groups)).with_bandwidths(bws)


class ElasticController:
    """Re-plans the coded deployment when the fleet changes.

    The plan is recomputed from the scheme's closed form — re-planning is
    O(G) and happens inline (no coordinator round trip), which is what
    makes elasticity practical at 1000+ workers. Thin wrapper over
    ``CodedComputeEngine.replan``; scheme params travel with the engine's
    typed scheme object across every membership change.

    With a ``threshold`` the controller applies the shared hysteresis
    rule of ``repro_torch.runtime.control.replan_decision`` to estimate
    updates: membership changes still always replan, but pure parameter
    drift only replans when the estimated-latency improvement crosses
    the threshold (inclusive). ``threshold=None`` keeps the legacy
    replan-on-every-update behaviour.
    """

    def __init__(
        self,
        cluster: ClusterSpec,
        k: int,
        *,
        scheme: str | AllocationScheme = "optimal",
        scheme_params: dict | None = None,
        threshold: float | None = None,
        replan_cost: float = 0.0,
        horizon: int = 50,
    ):
        self.k = k
        self.engine = CodedComputeEngine(
            cluster, k, scheme, scheme_params=scheme_params
        )
        self.threshold = threshold
        self.replan_cost = replan_cost
        self.horizon = horizon
        self.last_decision = None  # the most recent hysteresis Decision

    @property
    def plan(self) -> DeploymentPlan:
        return self.engine.plan

    @property
    def replans(self) -> int:
        return self.engine.replans

    def on_membership_change(self, new_cluster: ClusterSpec) -> DeploymentPlan:
        return self.engine.replan(new_cluster)

    def on_estimates_update(self, tracker: StragglerTracker) -> DeploymentPlan:
        est = tracker.estimated_cluster()
        if self.threshold is not None:
            from repro_torch.runtime.control import replan_decision

            self.last_decision = replan_decision(
                self.engine.scheme,
                self.engine.plan,
                est,
                threshold=self.threshold,
                replan_cost=self.replan_cost,
                horizon=self.horizon,
            )
            if not self.last_decision.replanned:
                return self.engine.plan
        return self.on_membership_change(est)
