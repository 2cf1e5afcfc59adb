"""Cluster planner: AllocationPlan -> per-worker DeploymentPlan.

Counterpart of ``repro/core/planner.py``: integer per-worker row
counts, the worker -> coded-row ranges, and the scheme object carried
along so a later replan keeps its parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import AllocationScheme


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    """Integerized, executable plan for one coded matvec deployment."""

    cluster: ClusterSpec
    k: int
    loads_per_worker: np.ndarray  # (N,) int rows of coded A per worker
    group_of_worker: np.ndarray  # (N,) int group index per worker
    row_ranges: tuple  # worker -> (start, stop) into coded rows
    n: int  # total coded rows actually deployed
    t_star: float  # lower bound of the underlying real plan
    scheme: str
    scheme_obj: AllocationScheme | None = None
    allocation: AllocationPlan | None = None

    @property
    def num_workers(self) -> int:
        return int(self.loads_per_worker.shape[0])

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def max_load(self) -> int:
        return int(self.loads_per_worker.max())


def _expand(cluster: ClusterSpec, per_group: Sequence[int]):
    loads, gid = [], []
    for j, g in enumerate(cluster.groups):
        loads += [int(per_group[j])] * g.num_workers
        gid += [j] * g.num_workers
    return np.asarray(loads, dtype=np.int64), np.asarray(gid, dtype=np.int64)


def integerize(cluster: ClusterSpec, plan: AllocationPlan) -> DeploymentPlan:
    """Expand a per-group AllocationPlan into a per-worker DeploymentPlan."""
    loads_w, gid = _expand(cluster, plan.loads_int)
    starts = np.concatenate([[0], np.cumsum(loads_w)[:-1]])
    ranges = tuple((int(s), int(s + l)) for s, l in zip(starts, loads_w))
    return DeploymentPlan(
        cluster=cluster,
        k=plan.k,
        loads_per_worker=loads_w,
        group_of_worker=gid,
        row_ranges=ranges,
        n=int(loads_w.sum()),
        t_star=plan.t_star,
        scheme=plan.scheme,
        scheme_obj=plan.scheme_obj,
        allocation=plan,
    )


def deploy(scheme: AllocationScheme, cluster: ClusterSpec, k: int
           ) -> DeploymentPlan:
    """Allocate with a typed scheme and integerize for deployment."""
    return integerize(cluster, scheme.allocate(cluster, k))
