"""Load-allocation algorithms (the paper's Section III), float64 numpy.

Counterpart of ``repro/core/allocation.py``, eager path only:

* ``optimal_allocation`` — Theorem 2 (model (1)); Corollary 2 under
  ``LatencyModel.MODEL_30``.
* ``t_star``             — minimum expected latency, eq. (18)/(33).
* ``uniform_given_n``    — Section III-D-1: ``l = n/N``;
* ``gradient_coding_allocation`` — Theorem 2 on gradient partitions,
  loads clamped to k.

Every function works on per-group ``(N, mu, alpha)`` arrays from
``ClusterSpec.arrays`` and returns an ``AllocationPlan``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lambertw import lambertwm1_neg_exp
from repro_torch.core.runtime_model import (
    ClusterSpec,
    LatencyModel,
    resolve_latency_model,
)


@dataclasses.dataclass(frozen=True)
class AllocationPlan:
    """Result of a load-allocation computation.

    ``loads``/``r`` are per-group real values, ``loads_int`` their
    ``ceil``, ``n``/``n_int`` the total coded rows, ``t_star`` the
    scheme's expected-latency value (NaN when unknown), ``scheme`` the
    name tag and ``scheme_obj`` the typed scheme that produced the plan.
    """

    loads: np.ndarray
    loads_int: np.ndarray
    r: np.ndarray
    n: float
    n_int: int
    k: int
    t_star: float
    scheme: str
    scheme_obj: object | None = None

    @property
    def rate(self) -> float:
        """MDS code rate k/n."""
        return self.k / self.n


def _w_term(mu, alpha):
    """W_{-1}(-exp(-(alpha*mu + 1))), evaluated in log space."""
    return lambertwm1_neg_exp(alpha * mu + 1.0)


def optimal_r(n_workers, mu, alpha):
    """r*_j = N_j (1 + 1 / W_{-1}(-e^{-(alpha mu + 1)}))  (eq. (15))."""
    return n_workers * (1.0 + 1.0 / _w_term(mu, alpha))


def xi_star(mu, alpha):
    """xi(r*_j, N_j, mu_j) = alpha + log(-W_{-1}(.))/mu  (eq. (17))."""
    return alpha + np.log(-_w_term(mu, alpha)) / mu


def t_star(n_workers, mu, alpha, k: int | None = None, *,
           per_row: bool | None = None, model: LatencyModel | None = None):
    """Minimum expected latency T* (eq. (18)); T*_b (eq. (33)) for MODEL_30."""
    model = resolve_latency_model(model, per_row)
    t = 1.0 / np.sum(-mu * n_workers / _w_term(mu, alpha))
    if model.per_row:
        if k is None:
            raise ValueError("per-row model (30) latency scales with k")
        t = t * k
    return t


def _n_int(n_workers, loads_int) -> int:
    return int(np.sum(np.asarray(n_workers, np.int64) * loads_int))


def optimal_allocation(cluster: ClusterSpec, k: int, *,
                       per_row: bool | None = None,
                       model: LatencyModel | None = None) -> AllocationPlan:
    """Theorem 2 (or Corollary 2 under ``LatencyModel.MODEL_30``)."""
    model = resolve_latency_model(model, per_row)
    n_w, mu, al = cluster.arrays()
    r = optimal_r(n_w, mu, al)
    xs = xi_star(mu, al)
    # l*_j = k / (xi_j * sum_{j'} r_j' / xi_j')   (eq. (16))
    loads = k / (xs * np.sum(r / xs))
    loads_int = np.ceil(loads - 1e-9).astype(np.int64)
    return AllocationPlan(
        loads=loads,
        loads_int=loads_int,
        r=r,
        n=float(np.sum(n_w * loads)),
        n_int=_n_int(n_w, loads_int),
        k=k,
        t_star=float(t_star(n_w, mu, al, k, model=model)),
        scheme="optimal_per_row" if model.per_row else "optimal",
    )


def uniform_given_n(cluster: ClusterSpec, k: int, n: float) -> AllocationPlan:
    """Section III-D-1: every worker gets l = n/N rows of the (n, k) code.

    ``t_star`` is NaN (no closed form); use the Monte-Carlo simulator.
    """
    n_w, _, _ = cluster.arrays()
    big_n = cluster.total_workers
    loads = np.full((cluster.num_groups,), n / big_n)
    # informational: the total requirement r = kN/n spread proportionally
    r = n_w / big_n * (k * big_n / n)
    loads_int = np.ceil(loads - 1e-9).astype(np.int64)
    return AllocationPlan(
        loads=loads,
        loads_int=loads_int,
        r=r,
        n=float(n),
        n_int=_n_int(n_w, loads_int),
        k=k,
        t_star=float("nan"),
        scheme="uniform_n",
    )


def gradient_coding_allocation(cluster: ClusterSpec, k: int, *,
                               model: LatencyModel | None = None) -> AllocationPlan:
    """Theorem-2 load balancing on gradient partitions (arXiv:1901.09339).

    ``k`` is the number of partitions of the global batch; a group-j
    worker computes ``l_j`` coded partition-gradients per step and any k
    coded rows recover the full-batch gradient. Loads are Theorem 2's,
    clamped to k (no worker usefully holds more than every partition).
    """
    model = resolve_latency_model(model)
    plan = optimal_allocation(cluster, k, model=model)
    loads = np.minimum(plan.loads, float(k))
    loads_int = np.minimum(plan.loads_int, k)
    n_w = np.asarray([g.num_workers for g in cluster.groups], dtype=np.int64)
    return dataclasses.replace(
        plan,
        loads=loads,
        loads_int=loads_int,
        n=float(np.sum(n_w * loads)),
        n_int=int(np.sum(n_w * loads_int)),
        scheme="grad_coding_per_row" if model.per_row else "grad_coding",
    )
