"""CodedRoundExecutor: the per-round coded-execution mechanics.

Counterpart of ``repro/runtime/executor.py``:

* **deadline** — the scheme's expected latency x safety, finite for every
  registered scheme; Monte Carlo on the integer loads when integerization
  inflates a load past ``INTEGERIZATION_SLACK``;
* **erasure-mask sampling** — ``finish_mask`` draws per-worker round
  times under the scheme's own latency model (the comm-delay schemes'
  per-worker transfer shifts included) from a ``torch.Generator`` on the
  executor's device; ``mus``/``alphas``/``shifts`` overrides inject a
  scenario's true fleet (``worker_param_arrays(cluster)``);
* **worker -> slot scatter map** — ``slot_owner[i]`` is the worker that
  holds coded slot ``i``, so a (W,) finish mask gathers to an (n,)
  slot-erasure mask in one device op (``slot_mask``);
* **elastic replan** — ``replan`` / ``on_estimates_update`` rebuild the
  plan, deadline and scatter map on a membership or estimate change,
  inside a ``replan`` span of ``tracer``. Without bucket mode every
  replan changes shapes, so ``last_replan_structural`` stays True;
* **bucket mode** (``bucket_config``) — integer loads are quantized onto
  bucket shapes and the admitted buckets are held as stacked state on
  the device (``bucket_args``: the ``(B, ...)`` tensors and a 0-d device
  index, rewritten in place). ``round_times``, ``finish_mask`` and
  ``slot_mask`` then read the active row on the device themselves, and
  the slot mask spans the slot capacity ``n_slots`` (padding rows dead),
  so callers use one API in both modes. A replan that keeps the worker
  count and fits the slot capacity (``last_replan_structural`` False)
  changes only tensor values; the ``plan_bucket_hit`` /
  ``plan_bucket_miss`` events report each replan.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coding import make_generator
from repro_torch.core.engine import CodedComputeEngine, plan_deadline
from repro_torch.core.planner import DeploymentPlan
from repro_torch.core.runtime_model import (
    ClusterSpec,
    LatencyModel,
    comm_terms,
    sample_worker_times,
)
from repro_torch.core.schemes import AllocationScheme
from repro_torch.device import resolve_device
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.plan_bucket import (
    BucketConfig,
    PlanBucketSet,
    bucket_signature,
    quantize_loads_int,
    quantize_plan,
)


class CodedRoundExecutor:
    """Per-round mechanics for one coded workload, on ``device`` (CUDA by default)."""

    #: integer/real load ratio beyond which the analytic deadline is
    #: distrusted and the integer loads are Monte-Carlo'd
    INTEGERIZATION_SLACK = 1.05

    def __init__(
        self,
        cluster: ClusterSpec,
        k: int,
        scheme: str | AllocationScheme = "optimal",
        *,
        scheme_params: dict | None = None,
        deadline_safety: float = 3.0,
        device: str | torch.device = "cuda",
        bucket_config: BucketConfig | None = None,
        telemetry=None,
        tracer=None,
    ):
        self.engine = CodedComputeEngine(cluster, k, scheme,
                                         scheme_params=scheme_params)
        self.deadline_safety = float(deadline_safety)
        self.device = resolve_device(device)
        self.bucket_config = bucket_config
        self.telemetry = telemetry
        #: span tracer; the owning loop may share its own
        self.tracer = tracer if tracer is not None else NULL_TRACER
        #: admitted bucket branches (None: bucket mode off)
        self.buckets: PlanBucketSet | None = None
        #: the buckets' stacked device state and the 0-d device index of
        #: the active one (``bucket_args``)
        self._bucket_state: dict | None = None
        self._bucket_index: torch.Tensor | None = None
        #: row of ``buckets`` the current plan lives in
        self.active_bucket = 0
        #: did the last (re)plan change shapes (consumers must rebuild)?
        self.last_replan_structural = True
        #: did the last replan land in an already admitted bucket?
        self.last_bucket_hit = False
        self._refresh()

    def _refresh(self) -> None:
        """Structural (re)build from the engine's plan (quantized in
        bucket mode, with a fresh bucket set)."""
        plan = self.engine.plan
        if self.bucket_config is not None:
            plan = quantize_plan(plan, self.bucket_config.quantum)
        self._bind_plan(plan)
        if self.bucket_config is not None:
            self._init_buckets()

    def _init_buckets(self) -> None:
        cfg, plan = self.bucket_config, self.plan
        n_cap = int(np.ceil(plan.n * cfg.n_headroom))
        self.buckets = PlanBucketSet(plan.num_workers, n_cap, cfg.capacity, self.device)
        sig = bucket_signature(plan.cluster, plan.allocation.loads_int, self.k)
        self.active_bucket, _ = self.buckets.admit(sig, plan, self.deadline,
                                                   *self.worker_params)
        self._bucket_state = self.buckets.device_state()
        self._bucket_index = torch.tensor(self.active_bucket, dtype=torch.int64,
                                          device=self.device)

    def _publish_bucket(self) -> None:
        """Copy the set's rows and the active index into the device state
        in place, so every holder of ``bucket_args`` sees the switch."""
        for key, value in self.buckets.device_state().items():
            self._bucket_state[key].copy_(value)
        self._bucket_index.fill_(self.active_bucket)

    def _active(self, key: str) -> torch.Tensor:
        """The active bucket's row of ``key``, gathered on the device."""
        return self._bucket_state[key].index_select(0, self._bucket_index.reshape(1))[0]

    def _emit_bucket_event(self, *, hit: bool, structural: bool) -> None:
        if self.telemetry is None:
            return
        self.telemetry.event(
            "plan_bucket_hit" if hit else "plan_bucket_miss",
            structural=structural,
            bucket=self.active_bucket,
            buckets=len(self.buckets) if self.buckets is not None else 0,
            n=self.plan.n,
            n_cap=self.buckets.n_cap if self.buckets is not None else 0,
            workers=self.plan.num_workers,
        )

    def _bind_plan(self, plan: DeploymentPlan) -> None:
        """Recompute the deadline and device arrays for ``plan``."""
        self.plan = plan
        self.deadline = self._integer_load_deadline(self.deadline_safety)
        owner = np.zeros((plan.n,), np.int64)
        for w, (s, e) in enumerate(plan.row_ranges):
            owner[s:e] = w
        #: (n,) worker index holding each coded slot
        self.slot_owner = torch.from_numpy(owner).to(self.device)
        self._loads_w = torch.as_tensor(plan.loads_per_worker,
                                        dtype=torch.float32, device=self.device)
        self._mus_w, self._alphas_w, self._shift_w = self.worker_param_arrays()

    def worker_param_arrays(self, cluster: ClusterSpec | None = None):
        """(mus_w, alphas_w, shift_w) float32 tensors for the plan's workers.

        ``cluster`` (default: the plan's own) maps the CURRENT plan's
        workers onto that cluster's group parameters, group by index: a
        scenario's true fleet. Where a true group has fewer workers than
        planned (a leave burst) the planned tail gets an infinite shift
        and never finishes; extra true workers (joins) stay invisible
        until a replan deploys them. A comm-delay scheme adds
        ``download / b_j`` to each worker's alpha and shifts its time by
        ``upload / b_j`` (``comm_terms``, from ``cluster``'s bandwidths);
        every other scheme has zero shifts.
        """
        plan, sch = self.plan, self.engine.scheme
        cluster = plan.cluster if cluster is None else cluster
        ng = cluster.num_groups
        if sch.latency_model is LatencyModel.COMM_DELAY:
            shift_g, dal_g = comm_terms(cluster, sch.upload, sch.download)
        else:
            shift_g, dal_g = np.zeros(ng), np.zeros(ng)
        mus, alphas, shifts = [], [], []
        rank_in_group: dict[int, int] = {}
        for j in plan.group_of_worker.tolist():
            rank = rank_in_group.get(j, 0)
            rank_in_group[j] = rank + 1
            if j < ng and rank < cluster.groups[j].num_workers:
                g = cluster.groups[j]
                mus.append(g.mu)
                alphas.append(g.alpha + dal_g[j])
                shifts.append(shift_g[j])
            else:  # a departed worker never responds
                mus.append(1.0)
                alphas.append(1.0)
                shifts.append(np.inf)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                         device=self.device)
        return as_t(mus), as_t(alphas), as_t(shifts)

    @property
    def worker_params(self):
        """(mus_w, alphas_w, shift_w) the finish-mask sampler draws with."""
        return self._mus_w, self._alphas_w, self._shift_w

    @property
    def scheme(self) -> AllocationScheme:
        return self.engine.scheme

    @property
    def cluster(self) -> ClusterSpec:
        return self.plan.cluster

    @property
    def k(self) -> int:
        return self.engine.k

    @property
    def n(self) -> int:
        """Total coded slots deployed."""
        return self.plan.n

    @property
    def n_slots(self) -> int:
        """Rows of a slot mask and of the code that consumers build: the
        slot capacity ``n_cap`` in bucket mode, else ``n``."""
        return self.buckets.n_cap if self.buckets is not None else self.plan.n

    @property
    def num_workers(self) -> int:
        return self.plan.num_workers

    def generator(self, *, g: np.ndarray | None = None) -> torch.Tensor:
        """(n_slots, k) MDS generator on the executor's device: sized to the
        plan, or in bucket mode to the slot capacity (its first ``n`` rows
        are the plan's code)."""
        return make_generator(self.n_slots, self.k, g=g, device=self.device)

    def _integer_load_deadline(self, safety: float) -> float:
        """Deadline commensurate with the INTEGERIZED deployment.

        When every ``ceil(l)/l`` is within ``INTEGERIZATION_SLACK`` the
        analytic ``plan_deadline`` holds; otherwise Monte-Carlo the
        scheme's latency on the integer loads (2,048 trials from a CPU
        generator seeded 0), floored by the analytic bound.
        """
        plan = self.plan
        alloc = plan.allocation
        real = np.asarray(alloc.loads, float)
        live = real > 0
        inflation = float(np.max(alloc.loads_int[live] / real[live], initial=1.0))
        if inflation <= self.INTEGERIZATION_SLACK:
            return plan_deadline(plan, safety)
        t = float(torch.mean(self.engine.scheme.simulate(
            torch.Generator().manual_seed(0), plan.cluster, alloc, 2_048,
            use_integer_loads=True,
        )))
        if np.isfinite(plan.t_star):
            t = max(t, float(plan.t_star))
        return t * safety

    def round_times(self, generator: torch.Generator, *, mus=None, alphas=None,
                    shifts=None) -> torch.Tensor:
        """(W,) per-worker round times under the scheme's own latency model.

        ``mus``/``alphas``/``shifts`` (W,) override the plan's worker
        parameters: a closed loop samples the true fleet
        (``worker_param_arrays(true_cluster)``) while loads and deadline
        stay those of the plan the controller last chose. In bucket mode
        the loads and default parameters are the active bucket's row.
        """
        if self.buckets is None:
            loads, mus0, alphas0, shifts0 = (self._loads_w, self._mus_w, self._alphas_w,
                                             self._shift_w)
        else:
            loads, mus0, alphas0, shifts0 = (self._active(key) for key in
                                             ("loads", "mus", "alphas", "shifts"))
        return sample_worker_times(
            generator, loads,
            mus0 if mus is None else mus,
            alphas0 if alphas is None else alphas, self.k, 1,
            model=self.engine.scheme.latency_model,
            shift_per_worker=shifts0 if shifts is None else shifts,
        )[0]

    def finish_mask(self, generator: torch.Generator, deadline=None, *, mus=None,
                    alphas=None, shifts=None) -> torch.Tensor:
        """(W,) bool: which workers finish by ``deadline`` (default planned;
        in bucket mode the active bucket's, on the device); the overrides
        are ``round_times``'s."""
        if deadline is None:
            deadline = self.deadline if self.buckets is None else self._active("deadline")
        return self.round_times(generator, mus=mus, alphas=alphas,
                                shifts=shifts) <= deadline

    def slot_mask(self, worker_mask: torch.Tensor) -> torch.Tensor:
        """Gather a (W,) worker finish mask to the (n_slots,) slot-erasure
        mask; in bucket mode through the active bucket's owner map, with
        the capacity padding rows always dead."""
        worker_mask = worker_mask.to(torch.bool)
        if self.buckets is None:
            return worker_mask[self.slot_owner]
        return worker_mask[self._active("owner")] & self._active("alive")

    def sample_round_times(self, generator: torch.Generator,
                           cluster: ClusterSpec | None = None) -> np.ndarray:
        """Host-side: one (W,) draw of round times, under ``cluster``'s
        parameters when given (a tracker's or controller's observation)."""
        return self.round_observation(generator, cluster)[0]

    def round_observation(self, generator: torch.Generator,
                          cluster: ClusterSpec | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Host-side: one round's ((W,) times, (W,) per-worker shifts).

        ``cluster`` injects a scenario's true parameters; leavers carry an
        ``inf`` shift, so their times come back ``inf``.
        """
        if cluster is None:
            mus, alphas, shifts = self.worker_params
        else:
            mus, alphas, shifts = self.worker_param_arrays(cluster)
        times = self.round_times(generator, mus=mus, alphas=alphas, shifts=shifts)
        return times.cpu().numpy(), shifts.cpu().numpy()

    # ------------------------------------------------------- bucket mode
    def bucket_args(self) -> tuple[dict, torch.Tensor]:
        """(stacked ``(B, ...)`` bucket state, 0-d device index of the active
        bucket), the tensors the samplers read. A replan within capacity
        rewrites them in place; a structural one replaces them."""
        if self.buckets is None:
            raise RuntimeError("bucket_args requires bucket_config")
        return self._bucket_state, self._bucket_index

    def bucket_probe(self, candidate_cluster: ClusterSpec) -> bool | None:
        """Would replanning onto ``candidate_cluster`` keep every shape?

        True iff the candidate's quantized signature is already admitted
        (the controller charges ``replan_cost`` only when this is not
        True); the set is left unchanged. None when bucket mode is off.
        """
        if self.buckets is None:
            return None
        if candidate_cluster.total_workers != self.buckets.num_workers:
            return False
        alloc = self.engine.scheme.allocate(candidate_cluster, self.k)
        q = quantize_loads_int(alloc.loads_int, self.bucket_config.quantum)
        n_w = np.asarray([g.num_workers for g in candidate_cluster.groups], np.int64)
        if int(np.sum(n_w * q)) > self.buckets.n_cap:
            return False
        return bucket_signature(candidate_cluster, q, self.k) in self.buckets

    def replan(self, new_cluster: ClusterSpec) -> DeploymentPlan:
        """Re-plan on a membership or estimate change, scheme params kept;
        rebuilds the deadline, scatter map and sampling arrays.

        In bucket mode a replan that keeps the worker count and fits
        ``n_cap`` only admits (or refreshes) its bucket and moves the
        active index (``last_replan_structural`` False); otherwise the
        bucket set is rebuilt around the new plan.
        """
        with self.tracer.span("replan") as sp:
            self.engine.replan(new_cluster)
            if self.bucket_config is None:
                self._refresh()
                self.last_replan_structural = True
                sp.set(structural=True, workers=self.plan.num_workers)
                return self.plan
            qplan = quantize_plan(self.engine.plan, self.bucket_config.quantum)
            if (self.buckets is None or qplan.num_workers != self.buckets.num_workers
                    or qplan.n > self.buckets.n_cap):
                self._refresh()
                self.last_replan_structural = True
                self.last_bucket_hit = False
                self._emit_bucket_event(hit=False, structural=True)
                sp.set(structural=True, workers=self.plan.num_workers)
                return self.plan
            with self.tracer.span("bucket_switch") as bsp:
                self._bind_plan(qplan)
                sig = bucket_signature(qplan.cluster, qplan.allocation.loads_int, self.k)
                self.active_bucket, hit = self.buckets.admit(
                    sig, qplan, self.deadline, *self.worker_params)
                self._publish_bucket()
                self.last_replan_structural = False
                self.last_bucket_hit = hit
                self._emit_bucket_event(hit=hit, structural=False)
                bsp.set(hit=hit, bucket=self.active_bucket)
            sp.set(structural=False, hit=hit, workers=self.plan.num_workers)
        return self.plan

    def on_estimates_update(self, tracker) -> DeploymentPlan:
        """Replan onto a ``StragglerTracker``'s current estimated cluster."""
        return self.replan(tracker.estimated_cluster())

    @property
    def replans(self) -> int:
        return self.engine.replans
