"""Cluster planner: AllocationPlan -> per-worker DeploymentPlan.

Counterpart of ``repro/core/planner.py``: integer per-worker row
counts, the worker -> coded-row ranges, and the scheme object carried
along so a later replan keeps its parameters
(``replan_on_membership_change``); ``estimate_mu_online`` is the
shifted-exponential MLE of a group's (mu, alpha) from observed times.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.runtime_model import ClusterSpec, LatencyModel
from repro_torch.core.schemes import AllocationScheme, make_scheme, scheme_for_plan


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


def plan_deployment(
    cluster: ClusterSpec,
    k: int,
    *,
    scheme: str | AllocationScheme = "optimal",
    per_row: bool | None = None,
    model: LatencyModel | None = None,
    n: float | None = None,
    r: int | None = None,
) -> DeploymentPlan:
    """``deploy`` with a scheme given by registry name (and its params) or object."""
    if not isinstance(scheme, AllocationScheme):
        scheme = make_scheme(scheme, per_row=per_row, model=model, n=n, r=r)
    return deploy(scheme, cluster, k)


def replan_on_membership_change(plan: DeploymentPlan, new_cluster: ClusterSpec
                                ) -> DeploymentPlan:
    """The plan's own scheme (parameters included) on a new membership."""
    return deploy(scheme_for_plan(plan), new_cluster, plan.k)


def estimate_mu_online(samples_per_group: Sequence[np.ndarray], k: int, loads):
    """MLE of (mu_j, alpha_j) from observed per-worker round-trip times.

    Shifted exponential on times scaled to the full task (``t k / l``):
    ``alpha_hat = min``, ``mu_hat = 1 / (mean - min)``.
    """
    mus, alphas = [], []
    for t, l in zip(samples_per_group, loads):
        t = np.asarray(t, dtype=np.float64) * (k / float(l))
        t0 = float(t.min())
        alphas.append(t0)
        mus.append(1.0 / max(float(t.mean() - t0), 1e-12))
    return np.asarray(mus), np.asarray(alphas)
