"""AdaptiveController: the closed replan loop over one round executor.

Counterpart of ``repro/runtime/control.py`` (host-side numpy):

* **observations** — ``observe_truth`` samples a scenario's true fleet
  with the executor's own sampler (simulated times); ``observe_timing``
  ingests a ``RoundTiming`` of ``runtime/timing.RoundClock`` (measured
  wall-clock times, decomposed per worker);
* **cadence** — fold ``StragglerTracker`` estimates every ``every``
  rounds (estimates between cadence points only accumulate);
* **hysteresis** — replan only when the estimated-latency improvement
  clears ``threshold`` (relative), judged by the deterministic
  mean-field ``coverage_latency``, so decisions never flap on
  Monte-Carlo noise;
* **replan cost** — the saving ``(t_cur - t_new) * horizon`` must also
  pay for ``replan_cost`` (round-latency units; a structural replan
  re-encodes the coded head through B3 or rebuilds the train step). A
  bucket-mode executor whose ``bucket_probe`` says the candidate lands
  in an admitted bucket replans for free;
* **membership changes always replan**;
* **telemetry** — every decision is an ``adapt_decision`` event, and new
  allocation-memo hits an ``alloc_cache_hit`` event.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.planner import DeploymentPlan
from repro_torch.core.runtime_model import (
    ClusterSpec,
    GroupSpec,
    LatencyModel,
    comm_terms,
)
from repro_torch.core.schemes import AllocationScheme, allocate_cache_info
from repro_torch.obs.trace import NULL_TRACER


def coverage_latency(
    cluster: ClusterSpec,
    loads_per_group: Sequence[float],
    k: int,
    *,
    model: LatencyModel = LatencyModel.MODEL_1,
    upload: float = 0.0,
    download: float = 0.0,
) -> float:
    """Deterministic mean-field round latency of per-group loads.

    The smallest ``t`` with ``sum_j N_j l_j F_j(t) >= k`` — the expected
    coded-row coverage reaching the decode threshold, the same fixed
    point the paper's allocation equalizes (at the optimal loads this
    recovers ``T*`` up to the paper's harmonic-number approximation).
    Used as the controller's decision metric precisely because it is
    noise-free: hysteresis comparisons of current-vs-candidate plans
    must not flap on Monte-Carlo resampling.

    ``F_j`` is the group's shifted-exponential CDF under ``model``
    (CommDelay transfer terms derived from the cluster's bandwidths and
    the given costs). Returns ``inf`` when the loads cannot cover ``k``
    even with every worker finished (e.g. after a leave burst) — the
    caller maps that to a deadline-timeout penalty. Group-code schemes
    (``uniform_r``) use per-group completion semantics this threshold
    approximation only bounds; for controller decisions that is
    acceptable (both sides of the comparison use the same metric).
    """
    l = np.asarray(loads_per_group, float)
    n_w = np.asarray([g.num_workers for g in cluster.groups], float)
    mu = np.asarray([g.mu for g in cluster.groups], float)
    al = np.asarray([g.alpha for g in cluster.groups], float)
    if l.shape != n_w.shape:
        raise ValueError(
            f"loads shape {l.shape} does not match the cluster's "
            f"{n_w.shape[0]} groups"
        )
    if model is LatencyModel.COMM_DELAY:
        shift_c, dal = comm_terms(cluster, upload, download)
        al = al + dal
    else:
        shift_c = np.zeros_like(al)
    live = (l > 0) & (n_w > 0)
    if not np.any(live) or float(np.sum(n_w[live] * l[live])) < k - 1e-9:
        return float("inf")
    l, n_w, mu, al, shift_c = (
        a[live] for a in (l, n_w, mu, al, shift_c)
    )
    scale = l if model.per_row else l / float(k)
    shift = al * scale + shift_c  # per-worker deterministic part
    rate = mu / scale  # exponential tail rate

    def coverage(t: float) -> float:
        f = 1.0 - np.exp(-rate * np.maximum(t - shift, 0.0))
        return float(np.sum(n_w * l * f))

    lo = float(np.min(shift))
    hi = float(np.max(shift)) + 1.0
    for _ in range(200):
        if coverage(hi) >= k - 1e-9:
            break
        hi *= 2.0
    else:
        return float("inf")  # coverage only reaches k asymptotically
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if coverage(mid) >= k - 1e-9:
            hi = mid
        else:
            lo = mid
    return hi


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Cadence + hysteresis policy of the adaptive controller."""

    every: int = 10  # consume estimates every R rounds
    threshold: float = 0.05  # relative latency improvement needed to act
    replan_cost: float = 0.0  # one replan's cost, in round-latency units
    horizon: int = 50  # rounds a replan's improvement amortizes over
    #: exponential forgetting of the default tracker's estimates — faster
    #: than StragglerTracker's 0.9 default because the control loop's
    #: whole point is reacting to drift within a few cadence periods
    forget: float = 0.7

    def __post_init__(self):
        if self.every <= 0:
            raise ValueError(f"AdaptConfig.every must be > 0, got {self.every}")
        if not 0 <= self.forget < 1:
            raise ValueError(
                f"AdaptConfig.forget must be in [0, 1), got {self.forget}"
            )
        if self.threshold < 0:
            raise ValueError(
                f"AdaptConfig.threshold must be >= 0, got {self.threshold}"
            )
        if self.replan_cost < 0 or self.horizon <= 0:
            raise ValueError(
                f"AdaptConfig needs replan_cost >= 0 and horizon > 0, got "
                f"replan_cost={self.replan_cost}, horizon={self.horizon}"
            )


@dataclasses.dataclass(frozen=True)
class Decision:
    """One controller decision (held OR replanned), telemetry-ready."""

    round: int
    replanned: bool
    reason: str  # "membership" | "improvement" | "hold" | "forced"
    current: float  # est. latency of the incumbent plan on the estimates
    candidate: float  # est. latency of a fresh plan on the estimates
    gain: float  # relative improvement (current - candidate) / current


def replan_decision(
    scheme: AllocationScheme,
    plan: DeploymentPlan,
    est_cluster: ClusterSpec,
    *,
    threshold: float,
    replan_cost: float = 0.0,
    horizon: int = 50,
    round: int = 0,
) -> Decision:
    """The controller's decision rule (pure — does not execute the replan).

    Membership changes (group count or any per-group worker count)
    always replan. Otherwise both the incumbent plan's loads and a
    candidate allocation are evaluated on the ESTIMATED cluster with
    ``coverage_latency``; the controller acts iff the relative gain
    crosses ``threshold`` (inclusive — a gain exactly at threshold
    replans) AND the absolute saving amortized over ``horizon`` rounds
    pays for ``replan_cost``.
    """
    cur_cluster = plan.cluster
    membership_changed = est_cluster.num_groups != cur_cluster.num_groups or any(
        a.num_workers != b.num_workers
        for a, b in zip(est_cluster.groups, cur_cluster.groups)
    )
    if membership_changed:
        return Decision(
            round=round, replanned=True, reason="membership",
            current=float("nan"), candidate=float("nan"), gain=float("nan"),
        )
    model = scheme.latency_model
    upload = float(getattr(scheme, "upload", 0.0))
    download = float(getattr(scheme, "download", 0.0))
    alloc = plan.allocation
    if alloc is not None:
        cur_loads = np.asarray(alloc.loads, float)
    else:  # legacy plan: recover per-group loads from the worker expansion
        loads_w = np.asarray(plan.loads_per_worker, float)
        gid = np.asarray(plan.group_of_worker)
        cur_loads = np.asarray(
            [loads_w[gid == j][0] if np.any(gid == j) else 0.0
             for j in range(cur_cluster.num_groups)]
        )
    t_cur = coverage_latency(
        est_cluster, cur_loads, plan.k,
        model=model, upload=upload, download=download,
    )
    cand = scheme.allocate(est_cluster, plan.k)
    t_new = coverage_latency(
        est_cluster, np.asarray(cand.loads, float), plan.k,
        model=model, upload=upload, download=download,
    )
    if not np.isfinite(t_cur):
        # the incumbent plan cannot cover k on the estimated cluster:
        # any feasible candidate is an unbounded improvement
        replan = np.isfinite(t_new)
        gain = 1.0 if replan else 0.0
    else:
        gain = (t_cur - t_new) / t_cur
        replan = gain >= threshold and (t_cur - t_new) * horizon >= replan_cost
    return Decision(
        round=round, replanned=bool(replan),
        reason="improvement" if replan else "hold",
        current=float(t_cur), candidate=float(t_new), gain=float(gain),
    )


class AdaptiveController:
    """Closed-loop straggler-adaptive replanning over one executor.

    Feed it one ``observe_round`` per executed round (per-worker round
    times; ``inf`` for workers that never responded, plus the current
    registration ``membership`` when the fleet can grow). Every
    ``cfg.every`` rounds it folds the tracker's (mu, alpha, bandwidth)
    estimates into an estimated cluster and applies ``replan_decision``;
    on a replan it drives ``executor.replan`` (scheme params preserved
    by the engine), re-anchors the tracker to the new membership, and
    invokes ``on_replan`` so the consumer can rebuild what depends on the
    plan (``Server.refresh_coded_head`` re-encodes the coded head).
    """

    def __init__(
        self,
        executor,
        cfg: AdaptConfig | None = None,
        *,
        tracker=None,
        telemetry=None,
        on_replan: Callable[[], None] | None = None,
    ):
        self.executor = executor
        self.cfg = cfg or AdaptConfig()
        if tracker is None:
            from repro_torch.runtime.fault_tolerance import StragglerTracker

            tracker = StragglerTracker(executor.cluster, forget=self.cfg.forget)
        self.tracker = tracker
        self.telemetry = telemetry
        self.on_replan = on_replan
        self.round = 0  # monotonic executed-round counter
        self.decisions: list[Decision] = []
        self._membership: tuple[int, ...] | None = None
        self._alloc_hits_seen = allocate_cache_info()["hits"]

    # ------------------------------------------------------------- views
    @property
    def plan(self) -> DeploymentPlan:
        return self.executor.plan

    @property
    def replans(self) -> int:
        return self.executor.replans

    # ------------------------------------------------------ observation
    def observe_round(
        self,
        times,
        *,
        loads=None,
        membership: Sequence[int] | None = None,
        transfer_times=None,
        payload: float = 1.0,
    ) -> Decision | None:
        """Ingest one round of observations; adapt when the cadence hits.

        ``times``: (W,) per-worker round-trip times for the CURRENT
        plan's workers (``inf`` = never responded — repeated infs are
        how leavers are detected). ``membership``: per-group registered
        worker counts from the cluster's membership service; required
        for join bursts to become visible (times alone can only shrink
        the fleet). ``transfer_times``: separately-measured per-worker
        UPLOAD delays — they feed the bandwidth MLE AND all comm terms
        (the upload shift directly, the per-load download term via the
        freshly-updated bandwidth estimates) are subtracted from
        ``times`` before the (mu, alpha) MLE, so comm delay is not
        double-counted as compute slowness when the scheme later adds
        its transfer terms back on top of the estimated alphas. Returns
        the cadence decision, or None off-cadence.
        """
        times = np.asarray(times, float)
        loads = np.asarray(
            self.executor.plan.loads_per_worker if loads is None else loads
        )
        if transfer_times is not None:
            tt = np.asarray(transfer_times, float)
            bw = self.tracker.observe_transfers(tt, payload)
            times = times - np.where(np.isfinite(tt), tt, 0.0)
            download = float(getattr(self.executor.scheme, "download", 0.0))
            if download > 0:
                gid = np.asarray(self.executor.plan.group_of_worker)
                inv_b = np.where(np.isfinite(bw), 1.0 / bw, 0.0)[gid]
                times = times - download * inv_b * np.asarray(loads, float) \
                    / self.executor.k
        # single ingest point for the MLE: finite times must be positive.
        # Bandwidth-estimate lag can overshoot the comm-term subtraction
        # above, so the clamp sits outside the transfer branch (inf =
        # missing stays inf).
        times = np.where(np.isfinite(times), np.maximum(times, 1e-9), times)
        self.tracker.observe_round(times, loads, self.executor.k)
        if membership is not None:
            self._membership = tuple(int(m) for m in membership)
        self.round += 1
        if self.round % self.cfg.every:
            return None
        return self.update()

    def observe_truth(
        self, generator, true_cluster: ClusterSpec | None = None
    ) -> Decision | None:
        """Sample one round of ground-truth observations and ingest them.

        Maps the CURRENT plan's workers onto the true cluster's parameters
        (``worker_param_arrays``), draws one round of times from
        ``generator`` with the executor's own sampler, feeds the upload
        shifts as measured transfer times for comm-delay schemes, and
        takes the registration membership from the truth.
        ``true_cluster=None`` observes the plan's own cluster.
        """
        exe = self.executor
        times, shifts = exe.round_observation(generator, true_cluster)
        sch = exe.scheme
        comm = (
            sch.latency_model is LatencyModel.COMM_DELAY
            and getattr(sch, "upload", 0.0) > 0
        )
        return self.observe_round(
            times,
            membership=(
                None if true_cluster is None
                else tuple(g.num_workers for g in true_cluster.groups)
            ),
            transfer_times=shifts if comm else None,
            payload=float(sch.upload) if comm else 1.0,
        )

    def observe_timing(self, timing) -> Decision | None:
        """Ingest one measured round (a ``RoundTiming`` of ``RoundClock``).

        The wall-clock counterpart of ``observe_truth``: times and
        transfer shares were measured and decomposed by the clock, the
        membership comes with the timing. A timing the clock did not feed
        (warmup, outlier, flagged rebuild: ``timing.times is None``) is a
        no-op, so callers may feed every round.
        """
        if timing is None or timing.times is None:
            return None
        return self.observe_round(timing.times, membership=timing.membership,
                                  transfer_times=timing.transfer_times,
                                  payload=timing.payload)

    def estimated_cluster(self) -> ClusterSpec:
        """Tracker estimates + registration membership, as a ClusterSpec.

        Worker counts come from the registration truth when one has been
        observed (joins included), minus nothing — workers the tracker
        flagged as failed but registration still lists are the
        registration's problem; without a membership feed the tracker's
        own failure detection drives the counts. Parameters (mu, alpha,
        bandwidth) are always the tracker's current estimates. Groups
        with zero workers are dropped.
        """
        m = self._membership
        if m is None or len(m) != self.tracker.cluster.num_groups:
            return self.tracker.estimated_cluster()
        mu = self.tracker.mu_estimates
        al = self.tracker.alpha_estimates
        bw = self.tracker.bandwidth_estimates
        groups, bws = [], []
        for j, count in enumerate(m):
            if count <= 0:
                continue
            groups.append(GroupSpec(int(count), float(mu[j]), float(al[j])))
            bws.append(float(bw[j]))
        return ClusterSpec(tuple(groups)).with_bandwidths(bws)

    def coverage_latency(self, cluster: ClusterSpec | None = None) -> float:
        """Mean-field round latency of the DEPLOYED plan's loads (rounds).

        The serving front-end's admission-control signal: the scheduler
        scales each request's projected completion by
        ``coverage_latency() / reference`` so the fleet sheds load when
        the tracker's estimates say rounds are running slow. Evaluated
        on the tracker-estimated cluster by default (``cluster``
        overrides, e.g. for a no-drift baseline); returns ``inf`` when
        the deployed loads cannot cover ``k`` on the estimates.
        """
        exe = self.executor
        plan = exe.plan
        est = cluster if cluster is not None else self.estimated_cluster()
        alloc = plan.allocation
        if alloc is not None:
            loads = np.asarray(alloc.loads, float)
        else:
            loads_w = np.asarray(plan.loads_per_worker, float)
            gid = np.asarray(plan.group_of_worker)
            loads = np.asarray(
                [loads_w[gid == j][0] if np.any(gid == j) else 0.0
                 for j in range(plan.cluster.num_groups)]
            )
        if est.num_groups != len(loads):
            # membership drifted since the plan deployed (replan pending):
            # the plan's loads no longer map onto the estimated groups, so
            # evaluate on the plan's own cluster (conservative hold-over)
            est = plan.cluster
        sch = exe.scheme
        return coverage_latency(
            est, loads, plan.k,
            model=sch.latency_model,
            upload=float(getattr(sch, "upload", 0.0)),
            download=float(getattr(sch, "download", 0.0)),
        )

    def recommend_slots(
        self, *, base: int, lo: int = 1, hi: int | None = None,
        reference: float | None = None,
    ) -> int:
        """Pick the serve batch width from measured round latency.

        ``base`` slots are calibrated for ``reference`` round latency
        (default: the deployed plan's coverage latency on its OWN
        cluster — the planned, no-drift value). When the tracker's
        estimates say rounds run ``r``× slower than planned,
        the recommended in-flight width shrinks to ``base / r`` — fewer
        concurrent streams keep per-request backlog projections inside
        their deadline budgets — and grows symmetrically when rounds run
        fast, clamped to ``[lo, hi]`` (``hi`` defaults to ``4 * base``).
        """
        if base <= 0:
            raise ValueError(f"base must be > 0, got {base}")
        hi = 4 * base if hi is None else hi
        if reference is None:
            reference = self.coverage_latency(self.executor.plan.cluster)
        cur = self.coverage_latency()
        if (
            not np.isfinite(cur) or not np.isfinite(reference)
            or cur <= 0 or reference <= 0
        ):
            return int(min(max(base, lo), hi))
        rec = int(round(base * reference / cur))
        return int(min(max(rec, lo), hi))

    # ---------------------------------------------------------- decision
    def update(self) -> Decision:
        """Run one decision now (the cadence calls this automatically).

        With a bucket-mode executor, ``bucket_probe`` asks whether the
        candidate plan lands in an admitted bucket (a replan that keeps
        every shape); only when it does not is ``cfg.replan_cost``
        charged. Without bucket mode every replan is charged. The
        decision's span shares the executor's tracer, so the executor's
        ``replan`` span nests inside it.
        """
        tracer = getattr(self.executor, "tracer", NULL_TRACER)
        with tracer.span("adapt_update", round=self.round) as sp:
            est = self.estimated_cluster()
            probe = self.executor.bucket_probe(est)
            d = replan_decision(
                self.executor.scheme,
                self.executor.plan,
                est,
                threshold=self.cfg.threshold,
                replan_cost=0.0 if probe else self.cfg.replan_cost,
                horizon=self.cfg.horizon,
                round=self.round,
            )
            if d.replanned:
                self.executor.replan(est)
                self.tracker.rebind(self.executor.cluster)
                self._membership = tuple(
                    g.num_workers for g in self.executor.cluster.groups
                )
                if self.on_replan is not None:
                    self.on_replan()
            sp.set(replanned=d.replanned, reason=d.reason)
        self.decisions.append(d)
        if self.telemetry is not None:
            self.telemetry.event(
                "adapt_decision",
                round=d.round,
                replanned=d.replanned,
                reason=d.reason,
                current=d.current,
                candidate=d.candidate,
                gain=d.gain,
                deadline=float(self.executor.deadline),
                workers=int(self.executor.num_workers),
            )
            info = allocate_cache_info()
            new_hits = info["hits"] - self._alloc_hits_seen
            if new_hits > 0:
                self._alloc_hits_seen = info["hits"]
                self.telemetry.event(
                    "alloc_cache_hit",
                    round=d.round,
                    new_hits=new_hits,
                    hits=info["hits"],
                    misses=info["misses"],
                    size=info["size"],
                )
        return d
