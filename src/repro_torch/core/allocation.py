"""Load-allocation algorithms (the paper's Section III), float64 numpy.

Counterpart of ``repro/core/allocation.py``, eager path only:

* ``optimal_allocation`` — Theorem 2 (model (1)); Corollary 2 under
  ``LatencyModel.MODEL_30``.
* ``t_star``             — minimum expected latency, eq. (18)/(33).
* ``uniform_given_n``    — Section III-D-1: ``l = n/N``;
* ``uniform_given_r``    — Section III-D-2 / Theorem 4 (the group code of
  [33]): ``l = k/r``, per-group split ``r_j`` from eq. (28)+(26);
* ``reisizadeh_allocation`` — Appendix D (the scheme of [32]);
* ``comm_aware_allocation`` / ``comm_uniform_allocation`` — the
  communication-delay-aware optimum (arXiv:2109.11246) and its
  uniform-split baseline; the outer deadline equation is solved by
  bisection (``comm_t_star``);
* ``gradient_coding_allocation`` — Theorem 2 on gradient partitions,
  loads clamped to k;
* ``uncoded``            — n = k, uniform split.

The bisections stop early at a residual of ``BISECT_TOL`` and assert a
final residual below ``BISECT_RESIDUAL_BOUND``, as the reference's eager
path does. The reference's fused fast path (``alloc_fastpath``, whose
gain is jit fusion) has no counterpart: written as eager torch float64
cores it solved a replan's allocation slower than these numpy solvers
on the H100 machine's host (PERF.md).

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
    comm_terms,
    resolve_latency_model,
)

#: residual tolerance of the bisections' early exit
BISECT_TOL = 1e-12
#: bound on the final residual of a bisection (else it raises)
BISECT_RESIDUAL_BOUND = 1e-9


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


def _bisect(f, lo: float, hi: float, scale: float) -> float:
    """Root of the increasing ``f`` on [lo, hi], 200 halvings at most."""
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        res = f(mid)
        if abs(res) <= BISECT_TOL * scale:  # converged: stop early
            return mid
        if res < 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def group_code_split(cluster: ClusterSpec, r: int) -> np.ndarray:
    """Solve eq. (28)+(26) for the per-group split (r_1..r_G), sum = r.

    The equalized tail gives r_j = N_j (1 - exp(-mu_j c)) for a common
    c > 0, and sum_j r_j = r fixes c. The sum is increasing in c with
    range (0, N), so bisection converges for 0 < r < N.
    """
    if not 0 < r < cluster.total_workers:
        raise ValueError(f"need r in (0, N={cluster.total_workers}), got {r}")
    n_w, mu, _ = cluster.arrays()

    def total(c):
        return float(np.sum(n_w * (1.0 - np.exp(-mu * c))))

    scale = max(1.0, float(r))
    hi = 1.0
    while total(hi) < r:
        hi *= 2.0
    c = _bisect(lambda x: total(x) - r, 0.0, hi, scale)
    residual = abs(total(c) - r)
    if not residual < BISECT_RESIDUAL_BOUND * scale:
        raise ArithmeticError(f"group split bisection residual {residual:.3e} (r={r})")
    return n_w * (1.0 - np.exp(-mu * c))


def uniform_given_r(cluster: ClusterSpec, k: int, r: int) -> AllocationPlan:
    """Section III-D-2 / Theorem 4: the group-code scheme of [33].

    Every worker stores l = k/r rows; group j runs an (N_j, r_j) MDS code
    with the split of ``group_code_split``. ``t_star`` records the
    scheme's latency floor 1/r.
    """
    n_w, _, _ = cluster.arrays()
    loads = np.full((cluster.num_groups,), k / r)
    loads_int = np.ceil(loads - 1e-9).astype(np.int64)
    return AllocationPlan(
        loads=loads,
        loads_int=loads_int,
        r=group_code_split(cluster, r),
        n=float(k / r * cluster.total_workers),
        n_int=_n_int(n_w, loads_int),
        k=k,
        t_star=1.0 / r,
        scheme="uniform_r_group_code",
    )


def reisizadeh_allocation(cluster: ClusterSpec, k: int) -> AllocationPlan:
    """Appendix D: the heterogeneous allocation of [32] (per-row model (30)).

    l_j = k / (s delta_j) with delta_j = -(W_{-1}(-e^{-(alpha mu + 1)}) + 1)/mu
    and s = sum_j N_j mu_j / (1 + mu_j delta_j); r records r*_j.
    """
    n_w, mu, al = cluster.arrays()
    delta = -(_w_term(mu, al) + 1.0) / mu
    s = np.sum(n_w * mu / (1.0 + mu * delta))
    loads = k / (s * delta)
    loads_int = np.ceil(loads - 1e-9).astype(np.int64)
    return AllocationPlan(
        loads=loads,
        loads_int=loads_int,
        r=optimal_r(n_w, mu, al),
        n=float(np.sum(n_w * loads)),
        n_int=_n_int(n_w, loads_int),
        k=k,
        t_star=float("nan"),
        scheme="reisizadeh",
    )


def comm_deadline_terms(cluster: ClusterSpec, upload: float, download: float):
    """CommDelay per-group terms ``(c, g, xi*)`` of the deadline equation.

    ``c_j = upload/b_j`` is the fixed transfer shift; ``download/b_j``
    adds to ``alpha_j`` before the Lambert-W inner problem, giving the
    throughput slope ``g_j = -mu_j N_j / W_j`` and
    ``xi*_j = -(1 + W_j)/mu_j``.
    """
    n_w, mu, al = cluster.arrays()
    c, dal = comm_terms(cluster, upload, download)
    w = _w_term(mu, al + dal)
    return c, -mu * n_w / w, -(1.0 + w) / mu


def comm_t_star(cluster: ClusterSpec, upload: float, download: float) -> float:
    """Comm-augmented minimum expected latency: the root of
    ``sum_j g_j (t - c_j)_+ = 1``.

    Piecewise linear and increasing in t, so bisection on
    ``[min c, max c + 1/sum g]`` converges; with every ``c_j = 0`` the
    closed form ``1/sum_j g_j`` is returned.
    """
    c, g, _ = comm_deadline_terms(cluster, upload, download)
    if np.all(c == 0.0):
        return float(1.0 / np.sum(g))

    def covered(t):
        return float(np.sum(g * np.maximum(t - c, 0.0)))

    t = _bisect(lambda x: covered(x) - 1.0, float(np.min(c)),
                float(np.max(c) + 1.0 / np.sum(g)), 1.0)
    residual = abs(covered(t) - 1.0)
    if not residual < BISECT_RESIDUAL_BOUND:
        raise ArithmeticError(f"comm deadline bisection residual {residual:.3e}")
    return t


def comm_aware_allocation(cluster: ClusterSpec, k: int, *, upload: float = 1.0,
                          download: float = 1.0) -> AllocationPlan:
    """Communication-delay-aware optimal allocation (arXiv:2109.11246).

    Loads ``l_j = k (t* - c_j)_+ / xi*_j`` at the root t* of
    ``comm_t_star``: a group whose transfer shift exceeds t* gets zero
    load. With every transfer term zero this is ``optimal_allocation``'s
    plan. The typed scheme is attached here, since the transfer costs are
    not recoverable from the plan's own fields.
    """
    from repro_torch.core.schemes import CommAware  # schemes imports us

    scheme_obj = CommAware(upload=float(upload), download=float(download))
    c, dal = comm_terms(cluster, upload, download)
    if np.all(c == 0.0) and np.all(dal == 0.0):
        plan = optimal_allocation(cluster, k)
        return dataclasses.replace(plan, scheme="comm_aware", scheme_obj=scheme_obj)
    n_w, mu, al = cluster.arrays()
    _, _, xs = comm_deadline_terms(cluster, upload, download)
    t = comm_t_star(cluster, upload, download)
    loads = k * np.maximum(t - c, 0.0) / xs
    loads_int = np.ceil(loads - 1e-9).astype(np.int64)
    return AllocationPlan(
        loads=loads,
        loads_int=loads_int,
        r=np.where(loads > 0, optimal_r(n_w, mu, al + dal), 0.0),
        n=float(np.sum(n_w * loads)),
        n_int=_n_int(n_w, loads_int),
        k=k,
        t_star=float(t),
        scheme="comm_aware",
        scheme_obj=scheme_obj,
    )


def comm_uniform_allocation(cluster: ClusterSpec, k: int, *, n: float | None = None,
                            upload: float = 1.0, download: float = 1.0
                            ) -> AllocationPlan:
    """Uniform-split baseline under the CommDelay model.

    Every worker, slow links included, gets ``l = n/N`` rows; ``n``
    defaults to the comm-aware optimum's code size. ``t_star`` is NaN
    (Monte Carlo gives the latency).
    """
    from repro_torch.core.schemes import CommUniform  # schemes imports us

    if n is None:
        n = comm_aware_allocation(cluster, k, upload=upload, download=download).n
    plan = uniform_given_n(cluster, k, float(n))
    return dataclasses.replace(
        plan, scheme="comm_uniform",
        scheme_obj=CommUniform(n=float(n), upload=float(upload), download=float(download)),
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


def uncoded(cluster: ClusterSpec, k: int) -> AllocationPlan:
    """Uncoded baseline: n = k, uniform split, wait for every worker."""
    return dataclasses.replace(uniform_given_n(cluster, k, float(k)), scheme="uncoded")
