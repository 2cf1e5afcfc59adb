"""Training loop: heterogeneity-aware gradient coding on the coded substrate.

Counterpart of ``repro/runtime/train_loop.py``. The global batch is split
into ``k`` partitions; the ``grad_coding`` scheme (Theorem-2 balancing,
``core/allocation.py``) assigns each worker a speed-proportional number
of coded partition-gradients, and the master recovers the full-batch
gradient from any ``k`` coded rows through a decode vector
(``core/gradient_coding.py``). ``TrainConfig(cluster=...)`` turns coded
execution on; without a cluster the plain step runs.

The coded step takes the worker finish mask as an argument (``Trainer.run``
draws it from a ``torch.Generator`` on the executor's device; tests
inject the reference's). The mask and the decode vector do not depend on
the gradients, so the step samples the mask first, solves ``a``, forms
``w = a B`` and runs ONE backward of ``sum_p (w_p / k) loss_p``. By
linearity that equals the reference's vmapped per-partition gradients
contracted with ``w / k``, without k gradient copies; an MoE layer routes
each partition as its own pool (``Model.token_ce(groups=k)``), as the
vmap does, so its capacity drops are the reference's. When fewer than k
rows survive, the backward is not run and the parameters, m, v and
``count`` stay bit-unchanged.

Parameters live in the ``Model``; the optimizer state is the dict of
``optim/adamw.py``. A step updates both in place, leaf by leaf
(``adamw_update``), so no second copy of either is held.

Cluster dynamics close the loop as in the reference: ``scenario`` drifts
the true fleet over the run (the finish masks draw from it, the plan
stays the controller's), ``adapt_every`` attaches an
``AdaptiveController`` that replans when its hysteresis rule fires,
``measure_times`` feeds it the steps' measured wall times through a
``RoundClock`` instead of simulated ones, and ``bucket_quantum`` puts
the executor in bucket mode, where a replan within the bucket capacity
keeps the step (the assignment matrix is sized at the slot capacity).
``Trainer.replan`` replans by hand.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.core.allocation import optimal_allocation
from repro_torch.core.gradient_coding import assignment_matrix, decode_vector_torch
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import AllocationScheme
from repro_torch.models import layers as L
from repro_torch.models.model import Model, jax_path
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import SpanTracer
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime.control import AdaptConfig, AdaptiveController
from repro_torch.runtime.executor import CodedRoundExecutor
from repro_torch.runtime.plan_bucket import BucketConfig
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.timing import RoundClock
from repro_torch.sim import ScenarioSpec, make_scenario


def heterogeneous_batch_split(cluster: ClusterSpec, global_batch: int) -> np.ndarray:
    """Per-group microbatch sizes from the paper's optimal allocation.

    Group j's share is ``N_j l*_j / n*``, rounded to integers preserving
    the total (largest remainder).
    """
    plan = optimal_allocation(cluster, k=global_batch)
    n_w = np.asarray([g.num_workers for g in cluster.groups], float)
    raw = n_w * plan.loads / float(plan.n) * global_batch
    base = np.floor(raw).astype(int)
    rem = global_batch - base.sum()
    base[np.argsort(-(raw - base))[:rem]] += 1
    return base


def aggregate_with_erasures(grads_list, token_counts, finished_mask, *,
                            prev_grads=None, telemetry: Telemetry | None = None):
    """Token-weighted mean of the gradient dicts of the workers that finished.

    When every worker misses the deadline the step degrades: ``prev_grads``
    when given, else zeros, and the event goes to ``telemetry``.
    """
    w = np.asarray(token_counts, np.float64) * np.asarray(finished_mask, np.float64)
    total = w.sum()
    if total <= 0:
        if telemetry is not None:
            telemetry.event("all_workers_missed_deadline", workers=len(grads_list))
        if prev_grads is not None:
            return prev_grads
        return {n: torch.zeros_like(g, dtype=torch.float32) for n, g in grads_list[0].items()}
    scale = [float(x / total) for x in w]
    return {
        n: sum(s * g[n].float() for s, g in zip(scale, grads_list))
        for n in grads_list[0]
    }


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 10
    telemetry_path: str | None = None
    #: bound the in-memory event window (ring buffer); the JSONL sink
    #: at ``telemetry_path`` stays complete regardless
    telemetry_max_events: int | None = None
    seed: int = 0
    # ---- coded execution (gradient coding on the shared substrate) ----
    #: straggler fleet to plan against; None = plain (uncoded) training
    cluster: ClusterSpec | None = None
    #: registry name or typed scheme for the partition-load allocation
    scheme: str | AllocationScheme = "grad_coding"
    scheme_params: dict | None = None
    #: gradient partitions k (must divide the global batch); None = one
    #: partition per batch row
    partitions: int | None = None
    deadline_safety: float = 3.0
    # ---- cluster dynamics + closed-loop adaptation ----
    #: registered scenario name (or a ScenarioSpec) perturbing the TRUE
    #: cluster over the run; the plan only tracks it when adaptive
    scenario: object | None = None
    #: consume straggler estimates and maybe replan every this many
    #: steps; None = no adaptive control (caller-initiated replans only)
    adapt_every: int | None = None
    #: hysteresis: minimum relative estimated-latency improvement
    adapt_threshold: float = 0.05
    #: modeled cost of one structural replan, in round-latency units
    adapt_replan_cost: float = 0.0
    #: adapt from MEASURED wall-clock round times instead of simulated
    #: ground truth: each step runs under a ``RoundClock`` (decomposed per
    #: worker) and the controller ingests the timings via ``observe_timing``
    measure_times: bool = False
    # ---- plan bucketing ----
    #: quantize integer loads to this multiple and replan by a bucket
    #: switch; None = off (every replan rebuilds the step)
    bucket_quantum: int | None = None
    bucket_capacity: int = 8
    bucket_headroom: float = 1.5

    def bucket_config(self) -> BucketConfig | None:
        if self.bucket_quantum is None:
            return None
        return BucketConfig(quantum=self.bucket_quantum, capacity=self.bucket_capacity,
                            n_headroom=self.bucket_headroom)


def _params(model: Model) -> dict:
    return dict(model.named_parameters())


@torch.no_grad()
def _load_params(model: Model, new: dict) -> None:
    for n, p in model.named_parameters():
        p.copy_(new[n])


def make_train_step_fn(model: Model, opt_cfg: AdamWConfig):
    """Plain step: (opt_state, batch) -> (opt_state, metrics); params in place."""

    def train_step(opt_state, batch):
        params = _params(model)
        loss, metrics = model.loss_fn(batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        _, opt_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state, params)
        return opt_state, {**metrics, **opt_metrics}

    return train_step


def partition_losses(lse, ll, argmax, labels, partitions: int):
    """Per-partition (loss, accuracy), each (k,), from per-token (B*S,) values.

    Partition p is batch rows ``[p B/k, (p+1) B/k)``; each is the
    reference's ``loss_fn`` of that sub-batch (masked token mean with z-loss).
    """
    labels = labels.reshape(partitions, -1)
    mask = labels >= 0
    loss_p = L.ce_from_lse(lse.reshape(partitions, -1), ll.reshape(partitions, -1), mask)
    hits = (argmax.reshape(partitions, -1) == labels) & mask
    return loss_p, hits.sum(1) / mask.sum(1).clamp_min(1)


def weighted_gradient(model: Model, batch: dict, weights: torch.Tensor, partitions: int):
    """Gradient of ``sum_p weights[p] loss_p`` in one forward and one backward.

    Returns (grads {name: tensor}, loss_p, accuracy_p); with ``weights =
    a^T B / k`` this is the coded aggregate ``sum_i a_i g~_i / k``. An MoE
    layer routes each partition as its own pool (``groups=partitions``),
    as the reference's per-partition gradients do.
    """
    params = _params(model)
    with torch.enable_grad():
        lse, ll, am = model.token_ce(batch["tokens"], batch["labels"], groups=partitions)
        loss_p, acc_p = partition_losses(lse, ll, am, batch["labels"], partitions)
        objective = (weights.detach() * loss_p).sum()
        grads = torch.autograd.grad(objective, list(params.values()))
    return dict(zip(params, grads)), loss_p.detach(), acc_p


def make_coded_train_step_fn(model: Model, opt_cfg: AdamWConfig,
                             executor: CodedRoundExecutor, b_matrix: torch.Tensor,
                             partitions: int):
    """Coded step: (opt_state, batch, worker_mask) -> (opt_state, metrics).

    ``worker_mask`` is the (W,) bool finish mask of this round;
    ``executor.slot_mask`` gathers it to ``b_matrix``'s rows (in bucket
    mode the slot capacity's, padding rows never alive). The parameters are
    updated in place unless the round is undecodable; then only the
    forward runs (for the metrics). A batch with family ``extras`` (vlm,
    audio) raises the reference's ``NotImplementedError``.
    """
    b_mat = b_matrix.to(torch.float32)

    def coded_step(opt_state, batch, worker_mask):
        if batch.get("extras") is not None:
            raise NotImplementedError("coded training does not partition family extras yet")
        row_alive = executor.slot_mask(worker_mask)
        a, ok = decode_vector_torch(b_mat, row_alive)
        if bool(ok):
            w_part = (a @ b_mat) / partitions  # (k,), 1/k each up to the solve
            grads, loss_p, acc_p = weighted_gradient(model, batch, w_part, partitions)
            _, opt_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state, _params(model))
        else:
            # fewer than k coded rows: skip (params, m, v, count unchanged);
            # the reference reports its zero aggregate's norm and next lr
            with torch.no_grad():
                lse, ll, am = model.token_ce(batch["tokens"], batch["labels"],
                                             groups=partitions)
            loss_p, acc_p = partition_losses(lse, ll, am, batch["labels"], partitions)
            opt_metrics = {"grad_norm": torch.zeros((), device=lse.device),
                           "lr": cosine_schedule(opt_cfg, opt_state["count"] + 1)}
        metrics = {"loss": loss_p.mean(), "accuracy": acc_p.mean(), **opt_metrics}
        metrics["survivors"] = worker_mask.sum().float()
        metrics["coded_rows_alive"] = row_alive.sum().float()
        metrics["skipped"] = 1.0 - ok.float()
        return opt_state, metrics

    return coded_step


def state_tree(model: Model, opt_state: dict) -> dict:
    """Flat ``{reference path: tensor}`` of params and optimizer state."""
    out = {"opt/count": opt_state["count"]}
    for n, p in model.named_parameters():
        path = jax_path(n)
        out[f"params/{path}"] = p
        out[f"opt/m/{path}"] = opt_state["m"][n]
        out[f"opt/v/{path}"] = opt_state["v"][n]
    return out


class Trainer:
    """Single-device trainer with checkpoint/restart and coded execution.

    With ``TrainConfig(cluster=...)`` a ``CodedRoundExecutor`` plans the
    partition loads under the configured scheme on the model's device and
    every step runs ``make_coded_train_step_fn`` with a finish mask drawn
    from ``self.generator``. The port builds no compiled program, so where
    the reference counts retraces of its jitted step, ``step_builds``
    counts ``_build_coded_step`` calls: 1 at start and one more per
    structural replan. ``step_seconds`` holds each step's wall time
    (host clock; the step ends in a host read of its metrics).

    ``scenario``, ``adapt_every`` and ``measure_times`` close the loop as
    the reference's trainer does: the scenario's true fleet is injected
    into the finish-mask draw each step, the controller observes the
    same draw (or the clock's decomposition of the measured step) and
    replans through ``_on_replan``, and every decision is an
    ``adapt_decision`` event.

    It trains every family, plain or coded, as the reference's does, with
    one exception: the coded step does not partition the ``extras`` that
    vlm and audio batches carry, so a coded vlm or audio trainer builds
    and its ``run`` raises the reference's ``NotImplementedError`` at the
    first step. An MoE model's coded step routes each partition as its
    own pool.
    """

    def __init__(self, model: Model, data, opt_cfg: AdamWConfig, cfg: TrainConfig):
        self.model = model
        self.data = data
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.executor: CodedRoundExecutor | None = None
        self.step_seconds: list[float] = []
        #: ``_build_coded_step`` calls (the coded step is rebuilt only on
        #: a structural replan)
        self.step_builds = 0
        if cfg.cluster is not None:
            # validate before acquiring file handles, so a raising
            # __init__ leaks nothing
            gb = data.shape.global_batch if hasattr(data, "shape") else None
            k = cfg.partitions if cfg.partitions is not None else gb
            if k is None:
                raise ValueError("coded training needs cfg.partitions when the data "
                                 "pipeline has no .shape to infer the batch from")
            if gb is not None and gb % k:
                raise ValueError(f"partitions ({k}) must divide the global batch ({gb})")
            self.partitions = int(k)
        if cfg.cluster is None and (cfg.scenario is not None or cfg.adapt_every is not None
                                    or cfg.measure_times):
            raise ValueError("scenario / adapt_every / measure_times require coded "
                             "training (cfg.cluster)")
        if cfg.adapt_every is not None and cfg.adapt_every <= 0:
            raise ValueError(f"adapt_every must be a positive cadence, got {cfg.adapt_every}")
        self.telemetry = Telemetry(cfg.telemetry_path, max_events=cfg.telemetry_max_events)
        #: span tracer: a ``dispatch`` span per step, shared with the
        #: executor so its replan and bucket-switch spans nest on one stack
        self.tracer = SpanTracer(self.telemetry)
        self._ckpt = AsyncCheckpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        self.controller = None
        self.trace = None
        self.clock = None
        if cfg.cluster is not None:
            self.executor = CodedRoundExecutor(
                cfg.cluster, self.partitions, cfg.scheme,
                scheme_params=cfg.scheme_params, deadline_safety=cfg.deadline_safety,
                device=model.device, bucket_config=cfg.bucket_config(),
                telemetry=self.telemetry, tracer=self.tracer,
            )
            self._build_coded_step()
            self.generator = torch.Generator(device=model.device).manual_seed(cfg.seed + 1)
            if cfg.scenario is not None:
                # a registered name is built AT the step budget so its
                # events land inside the run; an explicit ScenarioSpec
                # keeps its own horizon
                spec = (cfg.scenario if isinstance(cfg.scenario, ScenarioSpec)
                        else make_scenario(str(cfg.scenario), horizon=cfg.steps))
                self.trace = spec.trace(cfg.cluster, seed=cfg.seed, horizon=cfg.steps)
            if cfg.adapt_every is not None:
                self.controller = AdaptiveController(
                    self.executor,
                    AdaptConfig(every=cfg.adapt_every, threshold=cfg.adapt_threshold,
                                replan_cost=cfg.adapt_replan_cost),
                    telemetry=self.telemetry, on_replan=self._on_replan,
                )
            if cfg.measure_times:
                self.clock = RoundClock(self.executor, telemetry=self.telemetry)
        else:
            self.step_fn = make_train_step_fn(model, opt_cfg)

    def _build_coded_step(self) -> None:
        """(Re)build the coded step against the executor's current plan.

        Bucket mode sizes the assignment matrix at the bucket slot
        capacity: the decode masks the padding rows dead, so one matrix
        and one step serve every admitted bucket.
        """
        self.step_builds += 1
        self.b_matrix = assignment_matrix(self.executor.n_slots, self.partitions, seed=self.cfg.seed,
                                          device=self.model.device)
        self.coded_step_fn = make_coded_train_step_fn(
            self.model, self.opt_cfg, self.executor, self.b_matrix, self.partitions)

    def _on_replan(self) -> None:
        """Replan hook: rebuild the step only when shapes moved. A bucket
        switch keeps it; the executor's masks read the new bucket."""
        if not self.executor.last_replan_structural:
            return
        self._build_coded_step()

    def replan(self, new_cluster: ClusterSpec):
        """Elastic replan mid-training, scheme params kept: the deadline,
        assignment matrix and step follow the new membership (kept on a
        bucket switch), and a ``replan`` event records it."""
        if self.executor is None:
            raise ValueError("replan requires coded training (cfg.cluster)")
        plan = self.executor.replan(new_cluster)
        self._on_replan()
        self.telemetry.event("replan", workers=plan.num_workers, n=plan.n,
                             deadline=self.executor.deadline)
        return plan

    def _clone_generator(self) -> torch.Generator:
        """A generator in ``self.generator``'s current state."""
        g = torch.Generator(device=self.generator.device)
        g.set_state(self.generator.get_state())
        return g

    def _coded_dispatch(self, opt_state, batch, truth):
        """One coded round: the finish mask drawn from ``self.generator``
        (under ``truth``'s parameters when given, from the active bucket in
        bucket mode), then the coded step. Returns (opt_state, metrics)."""
        exe = self.executor
        mus = alphas = shifts = None
        if truth is not None:
            mus, alphas, shifts = exe.worker_param_arrays(truth)
        wmask = exe.finish_mask(self.generator, mus=mus, alphas=alphas, shifts=shifts)
        return self.coded_step_fn(opt_state, batch, wmask)

    def init_or_restore(self):
        """(params, opt_state, start): the model's parameters, fresh or restored."""
        params = _params(self.model)
        opt_state = adamw_init(self.opt_cfg, params)
        start = 0
        if self.cfg.checkpoint_dir:
            last = latest_step(self.cfg.checkpoint_dir)
            if last is not None:
                like = state_tree(self.model, opt_state)
                state, meta = restore_checkpoint(self.cfg.checkpoint_dir, last, like)
                _load_params(self.model, {n: state[f"params/{jax_path(n)}"]
                                          for n in params})
                opt_state = {
                    "m": {n: state[f"opt/m/{jax_path(n)}"] for n in params},
                    "v": {n: state[f"opt/v/{jax_path(n)}"] for n in params},
                    "count": state["opt/count"],
                }
                start = meta["step"]
                self.data._step = meta.get("data_step", start)
        return params, opt_state, start

    def run(self):
        params, opt_state, start = self.init_or_restore()
        tokens_per_step = self.data.shape.global_batch * self.data.shape.seq_len
        history = []
        for step in range(start, self.cfg.steps):
            t0 = time.perf_counter()
            batch = self.data.next_batch()
            if self.executor is not None:
                # scenario truth: this round straggles under the TRUE
                # (drifted) fleet while loads and deadline stay the plan's
                truth = self.trace.at(step) if self.trace is not None else None
                # the mask's generator state: the controller (or the
                # clock's decomposition) sees the draw that gated the step
                draw = self._clone_generator()
                with self.tracer.span("dispatch", step=step):
                    if self.clock is not None:
                        timing = self.clock.measure(
                            lambda: self._coded_dispatch(opt_state, batch, truth),
                            generator=draw, true_cluster=truth)
                        opt_state, metrics = timing.result
                    else:
                        opt_state, metrics = self._coded_dispatch(opt_state, batch, truth)
                if self.controller is not None:
                    if self.clock is not None:
                        d = self.controller.observe_timing(timing)
                        if (d is not None and d.replanned
                                and self.executor.last_replan_structural):
                            # the next step runs on a rebuilt step and
                            # re-encoded state: not a round latency
                            self.clock.discard_next()
                    else:
                        self.controller.observe_truth(draw, truth)
            else:
                opt_state, metrics = self.step_fn(opt_state, batch)
            metrics = {n: float(torch.as_tensor(v).detach()) for n, v in metrics.items()}
            self.step_seconds.append(time.perf_counter() - t0)
            self.telemetry.tick()
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                history.append(self.telemetry.log(step + 1, metrics, tokens_per_step))
            if self._ckpt and (step + 1) % self.cfg.checkpoint_every == 0:
                self._ckpt.save(step + 1, state_tree(self.model, opt_state),
                                {"data_step": self.data.state()["step"]})
        if self._ckpt:
            self._ckpt.wait()
        # the process-global registry's counters land in the JSONL too
        REGISTRY.emit(self.telemetry, phase="train", rounds=float(self.cfg.steps))
        self.telemetry.close()
        return params, opt_state, history
