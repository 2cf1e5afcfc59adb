"""Real-valued MDS coding for distributed matrix-vector multiplication.

Counterpart of ``repro/core/coding.py``. An (n, k) MDS code over the
ROWS of ``A in R^{k x d}``: ``A~ = G A`` with a systematic generator
``G = [I_k; P]`` (i.i.d. Gaussian parity, MDS with probability 1). The
master recovers ``A x`` from any k coded products by solving
``G_S z = y~_S``; for a systematic G, only for the erased systematic rows
(each surviving one is its own unknown), in a static (n - k)-square system.

* ``make_generator`` — the port's own seeded G, or an injected numpy G
  (the parity tests hand over the reference's);
* ``encode``         — ``A~ = G A`` through the B3 ``mds_encode`` kernel;
* ``split_loads``    — each worker's row range of A~ from integer loads;
* ``is_systematic`` — whether G's top k rows are I_k (one host read,
  where a generator is bound);
* ``decode_systematic`` — the torch twin of the reference's
  ``decode_systematic_jit``: fixed shape, no host branch on the data, the
  reduced solve when its caller says G is systematic;
* ``decode_from_rows`` — least-squares recovery from any >= k surviving
  rows (the reference's host-side oracle).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.mds_encode.ops import mds_encode
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.trace import stage


def make_generator(n: int, k: int, *, seed: int = 0, g: np.ndarray | None = None,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """(n, k) float32 systematic Gaussian generator ``[I_k; P]`` on ``device``.

    ``P`` is drawn from a CPU ``torch.Generator`` seeded with ``seed``, so
    the code is the same on every device. ``g`` injects a given (n, k)
    matrix instead.
    """
    device = resolve_device(device)
    if not n >= k >= 1:
        raise ValueError(f"need n >= k >= 1, got n={n}, k={k}")
    if g is not None:
        g = np.asarray(g, np.float32)
        if g.shape != (n, k):
            raise ValueError(f"injected generator has shape {g.shape}, want {(n, k)}")
        return torch.from_numpy(g.copy()).to(device)
    gen = torch.Generator().manual_seed(seed)
    p = torch.randn((n - k, k), generator=gen, dtype=torch.float32) / math.sqrt(k)
    return torch.cat([torch.eye(k, dtype=torch.float32, device=device), p.to(device)])


def encode(generator: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A~ = G A (rows of A are coded; columns untouched), via ``mds_encode``."""
    return mds_encode(generator, a)


def split_loads(loads_int_per_worker):
    """Row ranges [(start, stop)) of A~ for each worker, from integer loads."""
    starts = np.concatenate([[0], np.cumsum(loads_int_per_worker)[:-1]])
    return [(int(s), int(s + l)) for s, l in zip(starts, loads_int_per_worker)]


def decode_from_rows(generator_rows: torch.Tensor, coded_values: torch.Tensor
                     ) -> torch.Tensor:
    """Recover A x from >= k coded products: the least-squares solution of
    ``generator_rows (m, k) z = coded_values (m,) or (m, c)``."""
    rhs = coded_values if coded_values.dim() == 2 else coded_values[:, None]
    z = torch.linalg.lstsq(generator_rows, rhs.to(generator_rows.dtype)).solution
    return z if coded_values.dim() == 2 else z[:, 0]


def is_systematic(generator: torch.Tensor) -> bool:
    """Whether the generator's top k rows are I_k, so that
    ``decode_systematic(..., systematic=True)`` may take the reduced solve.

    One pass over the top (k, k) block on its device and one host read: a
    check for where a generator is bound, never for a query.
    """
    k = generator.shape[1]
    top = generator[:k]
    return bool((torch.count_nonzero(top) == k) & (top.diagonal() == 1).all())


#: decodes by path, counted on the host as each is called (a replay of a
#: captured decode is not a call, and is not counted)
_DECODES = {path: _METRICS.counter("erasure_decodes", path=path)
            for path in ("reduced", "general")}


def _reduced_system(generator: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """The block-eliminated system of the erased systematic unknowns, at
    the static size c = min(n - k, k).

    For G = [I_k; P] the survivors-first rows are every surviving
    systematic row J and the first e surviving parity rows R, e the count
    of erased systematic rows E. They give z_J = y_J and
    ``P[R, E] z_E = y_R - P[R, J] y_J``. E (erased first) and R (survivors
    first) are stable argsorts cut to c; M is ``P[R, E]`` in its leading
    e x e block and the identity elsewhere (zero off the diagonal blocks,
    so pivoting never mixes the padding in), b is zero past e. More than c
    erased systematic rows leave fewer than k survivors: ``ok`` is False.

    Returns (M (c, c), b (c, cols), slot (c,): the row of z each unknown
    fills, k (a dropped row) past e, y_known (k, cols): y on J and zero on
    E, e as a 0-d tensor).
    """
    n, k = generator.shape
    c = min(n - k, k)
    alive = mask[:k]
    erased = torch.argsort(alive.to(torch.int8), stable=True)[:c]
    parity = torch.argsort((~mask[k:]).to(torch.int8), stable=True)[:c]
    e = (~alive).sum()
    y_known = torch.where(alive[:, None], y[:k], 0)
    p = generator[k:]
    b = y[k:][parity] - (p @ y_known)[parity]
    live = torch.arange(c, device=generator.device) < e
    # entries past e are dropped: gather them from one row and one column,
    # so that they read what the cache already holds
    rows = torch.where(live, parity, parity[0])
    cols = torch.where(live, erased, erased[0])
    m = torch.where(live[:, None] & live[None, :], p[rows[:, None], cols[None, :]], 0)
    m.diagonal().add_(~live)
    return (m, torch.where(live[:, None], b, 0), torch.where(live, erased, k), y_known,
            e)


def _factor(a: torch.Tensor):
    """LU factors of ``a`` and the row order the solve takes its
    right-hand side in (a = P L U)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    return lu, torch.lu_unpack(lu, piv, unpack_data=False)[0].argmax(0)


def _refined_solve(a: torch.Tensor, lu: torch.Tensor, perm: torch.Tensor,
                   rhs: torch.Tensor) -> torch.Tensor:
    """``a z = rhs`` on ``_factor``'s factors, with one step of iterative
    refinement: the row permutation and two triangular solves, not
    ``lu_solve``, whose choice of backend by size reaches MAGMA's batched
    solve at some sizes, a call a CUDA-graph capture refuses."""
    def solve(b):
        y = torch.linalg.solve_triangular(lu, b[perm], upper=False, unitriangular=True)
        return torch.linalg.solve_triangular(lu, y, upper=True)

    z = solve(rhs)
    return z + solve(rhs - a @ z)


def decode_systematic(generator: torch.Tensor, coded_values: torch.Tensor,
                      finished_mask: torch.Tensor, *, systematic: bool = False):
    """Fixed-shape erasure decode on the tensors' device.

    The rows are the first k survivors (stable argsort of ``~mask``, index
    order kept). With ``systematic`` (the caller's ``is_systematic`` of
    the generator, decided where it binds one) and n > k, the same system
    is solved block-eliminated (``_reduced_system``): each surviving
    systematic row is its own unknown, and only the erased systematic
    unknowns are solved for, in a static (n - k) x (n - k) system (at most
    k x k). Otherwise the (k, k) system G_S of those rows is gathered and
    solved whole. Either solve is an LU with one step of iterative
    refinement in the generator's precision. ``ok`` is a 0-d bool tensor,
    False when fewer than k rows survived; the output is then zeroed.
    Nothing syncs with the host, so a CUDA graph can hold the decode.
    Inside a profiled Path M query its stages are the spans
    ``decode.gather`` (the system built, and on the reduced path the
    count of erased systematic rows as its attribute ``erased``, a 0-d
    tensor read when the span is), ``decode.lu`` and ``decode.trisolve``
    (``obs.trace.stage``). Each call counts once in
    ``obs.metrics.REGISTRY``'s ``erasure_decodes`` by ``path``,
    ``reduced`` or ``general``.

    Args:
      generator: (n, k) generator used at encode time.
      coded_values: (n,) or (n, c) coded products (garbage where erased).
      finished_mask: (n,) bool — which coded rows arrived by the deadline.
      systematic: the generator's top k rows are I_k.

    Returns (z, ok) with z of shape (k,) or (k, c) in ``coded_values``'s
    dtype.
    """
    n, k = generator.shape
    dev = generator.device
    reduced = systematic and n > k
    _DECODES["reduced" if reduced else "general"].inc()
    with stage("decode.gather", dev) as span:
        mask = finished_mask.to(torch.bool)
        if reduced:
            y = coded_values.to(generator.dtype)
            a, rhs, slot, y_known, erased = _reduced_system(
                generator, y if y.dim() == 2 else y[:, None], mask)
            span.set(erased=erased)
        else:
            order = torch.argsort((~mask).to(torch.int8), stable=True)
            idx = order[:k]
            a = generator[idx]
            y_s = coded_values[idx].to(generator.dtype)
            rhs = y_s if y_s.dim() == 2 else y_s[:, None]
    with stage("decode.lu", dev):
        lu, perm = _factor(a)
    with stage("decode.trisolve", dev):
        z = _refined_solve(a, lu, perm, rhs)
        if reduced:  # z_J = y_J, and z_E into E through the dropped row k
            full = torch.cat([y_known, y_known.new_zeros((1, z.shape[1]))])
            z = full.index_put_((slot,), z)[:k]
        z = z if coded_values.dim() == 2 else z[:, 0]
        ok = mask.sum() >= k
        z = z.to(coded_values.dtype)
        return torch.where(ok, z, torch.zeros_like(z)), ok
