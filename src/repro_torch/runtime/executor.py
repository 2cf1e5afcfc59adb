"""CodedRoundExecutor: the per-round coded-execution mechanics.

Counterpart of ``repro/runtime/executor.py`` without bucket mode:

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
  replan changes shapes, so ``last_replan_structural`` stays True.
"""
from __future__ import annotations

import numpy as np
import torch

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
        tracer=None,
    ):
        self.engine = CodedComputeEngine(cluster, k, scheme,
                                         scheme_params=scheme_params)
        self.deadline_safety = float(deadline_safety)
        self.device = resolve_device(device)
        #: span tracer; the owning loop may share its own
        self.tracer = tracer if tracer is not None else NULL_TRACER
        #: did the last (re)plan change shapes? Always, without bucket mode
        self.last_replan_structural = True
        self._bind_plan(self.engine.plan)

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
    def num_workers(self) -> int:
        return self.plan.num_workers

    def generator(self, *, g: np.ndarray | None = None) -> torch.Tensor:
        """(n, k) MDS generator sized to the plan, on the executor's device."""
        return self.engine.generator(g=g, device=self.device)

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
        stay those of the plan the controller last chose.
        """
        return sample_worker_times(
            generator, self._loads_w,
            self._mus_w if mus is None else mus,
            self._alphas_w if alphas is None else alphas, self.k, 1,
            model=self.engine.scheme.latency_model,
            shift_per_worker=self._shift_w if shifts is None else shifts,
        )[0]

    def finish_mask(self, generator: torch.Generator, deadline=None, *, mus=None,
                    alphas=None, shifts=None) -> torch.Tensor:
        """(W,) bool: which workers finish by ``deadline`` (default planned);
        the overrides are ``round_times``'s."""
        if deadline is None:
            deadline = self.deadline
        return self.round_times(generator, mus=mus, alphas=alphas,
                                shifts=shifts) <= deadline

    def slot_mask(self, worker_mask: torch.Tensor) -> torch.Tensor:
        """Gather a (W,) worker finish mask to the (n,) slot-erasure mask."""
        return worker_mask.to(torch.bool)[self.slot_owner]

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

    def replan(self, new_cluster: ClusterSpec) -> DeploymentPlan:
        """Re-plan on a membership or estimate change, scheme params kept;
        rebuilds the deadline, scatter map and sampling arrays."""
        with self.tracer.span("replan") as sp:
            self.engine.replan(new_cluster)
            self._bind_plan(self.engine.plan)
            self.last_replan_structural = True
            sp.set(structural=True, workers=self.plan.num_workers)
        return self.plan

    def on_estimates_update(self, tracker) -> DeploymentPlan:
        """Replan onto a ``StragglerTracker``'s current estimated cluster."""
        return self.replan(tracker.estimated_cluster())

    @property
    def replans(self) -> int:
        return self.engine.replans
