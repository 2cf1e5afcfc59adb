"""Shape-bucketed deployment plans (counterpart of ``repro/runtime/plan_bucket.py``).

A replan changes the integer per-group loads, hence the slot count ``n``
and every ``(n,)`` / ``(W,)`` array a consumer holds. Bucketing keeps
those shapes for most replans:

* **Quantization** — per-group integer loads round UP to multiples of a
  small ``quantum``: coverage is kept (workers compute at least the rows
  the real-valued optimum asks for) at a bounded overshoot, and nearby
  plans collapse onto one *bucket signature*. Two plans of one bucket
  deploy identical shapes and worker -> slot maps.
* **Stacked branch state** — ``PlanBucketSet`` holds up to ``capacity``
  admitted buckets as stacked host arrays padded to a slot capacity
  ``n_cap``. ``device_state()`` gives them as ``(B, ...)`` tensors on the
  set's device (the executor's), and ``select_bucket`` picks the active row by
  indexing with a 0-d device index tensor: no host read, so a captured
  step (a CUDA graph) serves every admitted bucket, and a replan within
  capacity changes only tensor values and the index.

``CodedRoundExecutor`` owns admission, eviction and the structural
escape (a changed worker count, or ``n`` past ``n_cap``: the only
replans that still rebuild).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.planner import DeploymentPlan, integerize
from repro_torch.core.runtime_model import ClusterSpec


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """Quantization and capacity knobs of plan bucketing.

    quantum: per-group integer loads round UP to multiples of this.
    capacity: most buckets held at once (least recently used evicted).
    n_headroom: slot capacity ``n_cap = ceil(n0 * n_headroom)`` over the
      initial plan's quantized slot count; a replan needing more slots is
      a structural rebuild.
    """

    quantum: int = 4
    capacity: int = 8
    n_headroom: float = 1.5

    def __post_init__(self):
        if self.quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {self.quantum}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.n_headroom < 1.0:
            raise ValueError(f"n_headroom must be >= 1.0, got {self.n_headroom}")


def quantize_loads_int(loads_int, quantum: int) -> np.ndarray:
    """Round per-group integer loads UP to multiples of ``quantum``; zero
    loads stay zero (a comm-excluded group gets no rows)."""
    loads_int = np.asarray(loads_int, dtype=np.int64)
    q = int(quantum)
    return -(-loads_int // q) * q


def quantize_plan(plan: DeploymentPlan, quantum: int) -> DeploymentPlan:
    """Re-integerize a deployment plan onto quantized per-group loads.

    The real-valued allocation rides along unchanged (the controller's
    coverage metric keeps the true loads); only the deployed integer
    loads, row ranges and slot count are quantized.
    """
    alloc = plan.allocation
    if alloc is None:
        raise ValueError("plan bucketing needs the real-valued allocation")
    q_loads = quantize_loads_int(alloc.loads_int, quantum)
    n_w = np.asarray([g.num_workers for g in plan.cluster.groups], dtype=np.int64)
    q_alloc = dataclasses.replace(alloc, loads_int=q_loads,
                                  n_int=int(np.sum(n_w * q_loads)))
    return integerize(plan.cluster, q_alloc)


def bucket_signature(cluster: ClusterSpec, loads_int_q, k: int) -> tuple:
    """Hashable identity of a quantized deployment shape: k, the per-group
    worker counts in order (the scatter map is positional) and the
    quantized loads."""
    return (
        int(k),
        tuple(int(g.num_workers) for g in cluster.groups),
        tuple(int(v) for v in np.asarray(loads_int_q)),
    )


def select_bucket(state: dict, index: torch.Tensor) -> dict:
    """One bucket's row of the ``(B, ...)`` stacked ``state``.

    ``index`` is a 0-d integer tensor on the state's device; the rows are
    gathered on the device with no host read, so the choice is made when
    the step runs, not when it is built.
    """
    return {k: v.index_select(0, index.reshape(1))[0] for k, v in state.items()}


class PlanBucketSet:
    """LRU set of admitted plan buckets as stacked, padded host arrays.

    Per bucket: per-worker loads and shifted-exponential parameters
    ``(W,)``, the slot owner map and alive mask padded to ``(n_cap,)``,
    and the deadline. Padding slots point at worker 0 but are never
    alive, so decoders mask them out like erasures (the first ``n`` rows
    of a systematic ``(n_cap, k)`` code are a valid ``(n, k)`` code).
    ``device`` is where ``device_state`` puts the stacked tensors.
    """

    def __init__(self, num_workers: int, n_cap: int, capacity: int,
                 device: str | torch.device = "cpu"):
        self.num_workers = int(num_workers)
        self.n_cap = int(n_cap)
        self.capacity = int(capacity)
        self.device = torch.device(device)
        #: signature -> row, in LRU order (oldest first)
        self._slots: OrderedDict[tuple, int] = OrderedDict()
        b, w, n = self.capacity, self.num_workers, self.n_cap
        self._owner = np.zeros((b, n), np.int64)
        self._alive = np.zeros((b, n), bool)
        self._loads = np.zeros((b, w), np.float32)
        self._deadline = np.full((b,), np.inf, np.float32)
        self._mus = np.ones((b, w), np.float32)
        self._alphas = np.ones((b, w), np.float32)
        self._shifts = np.full((b, w), np.inf, np.float32)

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, sig: tuple) -> bool:
        return sig in self._slots

    def slot_of(self, sig: tuple) -> int:
        return self._slots[sig]

    @property
    def signatures(self) -> tuple:
        return tuple(self._slots)

    def _write_params(self, slot: int, deadline, mus, alphas, shifts) -> None:
        as_np = lambda a: np.asarray(a.cpu() if torch.is_tensor(a) else a)  # noqa: E731
        self._deadline[slot] = float(deadline)
        self._mus[slot] = as_np(mus)
        self._alphas[slot] = as_np(alphas)
        self._shifts[slot] = as_np(shifts)

    def admit(self, sig: tuple, plan: DeploymentPlan, deadline, mus, alphas,
              shifts) -> tuple[int, bool]:
        """Admit (or refresh) a bucket; returns ``(row, hit)``.

        On a hit the shape rows (owner, alive, loads) are already right by
        signature identity and only the deadline and worker parameters are
        rewritten; on a miss the least recently used bucket is evicted when
        the set is full.
        """
        if plan.num_workers != self.num_workers or plan.n > self.n_cap:
            raise ValueError("structural change cannot be admitted")
        hit = sig in self._slots
        if hit:
            slot = self._slots[sig]
            self._slots.move_to_end(sig)
        else:
            if len(self._slots) >= self.capacity:
                _, slot = self._slots.popitem(last=False)  # LRU evict
            else:
                slot = len(self._slots)
            self._slots[sig] = slot
            owner = np.zeros((self.n_cap,), np.int64)
            for w_i, (s, e) in enumerate(plan.row_ranges):
                owner[s:e] = w_i
            self._owner[slot] = owner
            self._alive[slot] = np.arange(self.n_cap) < plan.n
            self._loads[slot] = np.asarray(plan.loads_per_worker, np.float32)
        self._write_params(slot, deadline, mus, alphas, shifts)
        return slot, hit

    def device_state(self) -> dict:
        """The stacked state as ``(B, ...)`` tensors on the set's device, to
        pass to a step every round (a few KB at serving scale)."""
        arrays = {"owner": self._owner, "alive": self._alive, "loads": self._loads,
                  "deadline": self._deadline, "mus": self._mus,
                  "alphas": self._alphas, "shifts": self._shifts}
        return {k: torch.from_numpy(v.copy()).to(self.device) for k, v in arrays.items()}
