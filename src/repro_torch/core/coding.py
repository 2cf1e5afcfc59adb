"""Real-valued MDS coding for distributed matrix-vector multiplication.

Counterpart of ``repro/core/coding.py``. An (n, k) MDS code over the
ROWS of ``A in R^{k x d}``: ``A~ = G A`` with a systematic generator
``G = [I_k; P]`` (i.i.d. Gaussian parity, MDS with probability 1). The
master recovers ``A x`` from any k coded products by solving
``G_S z = y~_S``; for a systematic G, only for the erased systematic rows
(each surviving one is its own unknown): in a static (n - k)-square
system where no host read is allowed (the serve head's captured decode),
or sized by the query's count of erased rows, read once on the host (Path
M's master step).

* ``make_generator`` — the port's own seeded G, or an injected numpy G
  (the parity tests hand over the reference's);
* ``encode``         — ``A~ = G A`` through the B3 ``mds_encode`` kernel;
* ``split_loads``    — each worker's row range of A~ from integer loads;
* ``is_systematic`` — whether G's top k rows are I_k (one host read,
  where a generator is bound);
* ``decode_systematic`` — the torch twin of the reference's
  ``decode_systematic_jit``: the reduced solve when its caller says G is
  systematic, at a fixed shape with no host read, or with ``sized`` at
  the query's size after one read of e;
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

#: the sized solve's step: e rounds up to a multiple of it (never past c),
#: so that a deployment meets at most c / 128 + 1 sizes of the system
SIZE_STEP = 128


def _reduced_system(generator: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    size: int, e):
    """The block-eliminated system of the erased systematic unknowns, at
    ``size`` rows: the static c = min(n - k, k), or e rounded up to
    ``SIZE_STEP``.

    For G = [I_k; P] the survivors-first rows are every surviving
    systematic row J and the first e surviving parity rows R, e the count
    of erased systematic rows E (``e``: a 0-d tensor, or the host's int).
    They give z_J = y_J and ``P[R, E] z_E = y_R - P[R, J] y_J``. E (erased
    first) and R (survivors first) are stable argsorts cut to ``size``,
    and the parity term comes from those ``size`` rows of P alone. M is
    ``P[R, E]`` in its leading e x e block and the identity elsewhere (zero
    off the diagonal blocks, so pivoting never mixes the padding in), b is
    zero past e. More than ``size`` erased systematic rows (at c: fewer
    than k survivors) leave z wrong; the caller zeroes it on ``ok``.

    Returns (M (size, size), b (size, cols), slot (size,): the row of z
    each unknown fills, k (a dropped row) past e, y_known (k, cols): y on J
    and zero on E).
    """
    k = generator.shape[1]
    alive = mask[:k]
    erased = torch.argsort(alive.to(torch.int8), stable=True)[:size]
    parity = torch.argsort((~mask[k:]).to(torch.int8), stable=True)[:size]
    # masked_fill, not torch.where with a number, which first makes the
    # number a tensor on the card
    y_known = y[:k].masked_fill(~alive[:, None], 0)
    p = generator[k:][parity]
    pad = torch.arange(size, device=generator.device) >= e
    b = (y[k:][parity] - p @ y_known).masked_fill_(pad[:, None], 0)
    m = p[:, erased].masked_fill_(pad[:, None] | pad[None, :], 0)
    m.diagonal().add_(pad)
    return m, b, erased.masked_fill(pad, k), y_known


def _sized(mask: torch.Tensor, survivors: torch.Tensor, k: int, c: int) -> tuple[int, int]:
    """(e, size) on the host, from one read of the card: the count of
    erased systematic rows, and the system's size, e rounded up to
    ``SIZE_STEP`` and at most c, or 0 where there is nothing to solve (no
    erased row, or fewer than k ``survivors``). Each is counted in
    ``obs.metrics.REGISTRY``'s ``erasure_solve_rows`` by ``size``."""
    e, survived = torch.stack([(~mask[:k]).sum(), survivors]).tolist()
    size = min(-(-e // SIZE_STEP) * SIZE_STEP, c) if survived >= k else 0
    _METRICS.counter("erasure_solve_rows", size=size).inc()
    return e, size


def _scatter(n: int, row_of: torch.Tensor, partials: torch.Tensor,
             finished_workers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (n, ...), alive (n,)): the workers' packed per-slot products,
    (W, max_load) or (W, max_load, c), in coded-row order, and the rows
    that arrived. Pad slots (``row_of`` -1) and the slots of workers that
    missed the deadline go to a dropped row ``n``."""
    fin = finished_workers.to(device=row_of.device, dtype=torch.bool)
    rows = row_of.long().masked_fill_((row_of < 0) | ~fin[:, None], n).reshape(-1)
    cols = partials.shape[2:]
    y = torch.zeros((n + 1, *cols), dtype=partials.dtype, device=partials.device)
    y.index_put_((rows,), partials.reshape(-1, *cols))
    alive = torch.zeros((n + 1,), dtype=torch.bool, device=partials.device)
    alive.index_fill_(0, rows, True)  # no host value copied to the card
    return y[:n], alive[:n]


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
                      finished_mask: torch.Tensor, *, systematic: bool = False,
                      sized: bool = False, row_of: torch.Tensor | None = None):
    """Erasure decode on the tensors' device.

    The rows are the first k survivors (stable argsort of ``~mask``, index
    order kept). With ``systematic`` (the caller's ``is_systematic`` of
    the generator, decided where it binds one) and n > k, the same system
    is solved block-eliminated (``_reduced_system``): each surviving
    systematic row is its own unknown, and only the erased systematic
    unknowns are solved for. By default in a static c x c system, c =
    min(n - k, k), with no read of the host, so a CUDA graph can hold the
    decode (the serve head's). With ``sized`` (Path M's master step) the
    query's e and whether k rows survived are read to the host in one
    transfer, and the system is e rounded up to ``SIZE_STEP`` rows (at most
    c): no solve where e is 0 (z is y) or fewer than k survived. Otherwise
    the (k, k) system G_S of those rows is gathered and solved whole. Each
    solve is an LU with one step of iterative refinement in the
    generator's precision. ``ok`` is a 0-d bool tensor, ``mask.sum() >=
    k``; the output is zeroed where it is False.

    Inside a profiled Path M query its stages are the spans
    ``decode.gather`` (the system built, after ``row_of``'s scatter of the
    workers' slots where it is given; on the reduced path with the
    attributes ``erased``, the count of erased systematic rows, a 0-d
    tensor read when the span is or the host's int, and ``size``, the
    system's rows), ``decode.lu`` and ``decode.trisolve``
    (``obs.trace.stage``), each opened on every call, empty where there is
    nothing to solve. Each call counts once in ``obs.metrics.REGISTRY``'s
    ``erasure_decodes`` by ``path``, ``reduced`` or ``general``.

    Args:
      generator: (n, k) generator used at encode time.
      coded_values: (n,) or (n, c) coded products (garbage where erased).
      finished_mask: (n,) bool — which coded rows arrived by the deadline.
      systematic: the generator's top k rows are I_k.
      sized: size the reduced solve by the query's e, read on the host.
      row_of: (W, max_load) int, each worker slot's coded row (-1: pad).
        With it ``coded_values`` are the workers' packed products (W,
        max_load) or (W, max_load, c) and ``finished_mask`` is (W,), which
        workers met the deadline: they are scattered into coded-row order
        first (``_scatter``).

    Returns (z, ok) with z of shape (k,) or (k, c) in ``coded_values``'s
    dtype.
    """
    n, k = generator.shape
    dev = generator.device
    reduced = systematic and n > k
    _DECODES["reduced" if reduced else "general"].inc()
    known = None  # z where there is nothing to solve
    with stage("decode.gather", dev) as span:
        if row_of is not None:
            coded_values, finished_mask = _scatter(n, row_of, coded_values, finished_mask)
        mask = finished_mask.to(torch.bool)
        survivors = mask.sum()
        ok = survivors >= k
        if reduced:
            y = coded_values.to(generator.dtype)
            y = y if y.dim() == 2 else y[:, None]
            c = min(n - k, k)
            e, size = _sized(mask, survivors, k, c) if sized else ((~mask[:k]).sum(), c)
            span.set(erased=e, size=size)
            if size:
                a, rhs, slot, y_known = _reduced_system(generator, y, mask, size, e)
            else:  # all k systematic rows survived (z = y), or fewer than k rows did
                known = y[:k].clone() if e == 0 else torch.zeros_like(y[:k])
        else:
            order = torch.argsort((~mask).to(torch.int8), stable=True)
            idx = order[:k]
            a = generator[idx]
            y_s = coded_values[idx].to(generator.dtype)
            rhs = y_s if y_s.dim() == 2 else y_s[:, None]
    with stage("decode.lu", dev):
        if known is None:
            lu, perm = _factor(a)
    with stage("decode.trisolve", dev):
        if known is None:
            z = _refined_solve(a, lu, perm, rhs)
            if reduced:  # z_J = y_J, and z_E into E through the dropped row k
                full = torch.cat([y_known, y_known.new_zeros((1, z.shape[1]))])
                z = full.index_put_((slot,), z)[:k]
            if not (reduced and sized):  # sized, a solve runs only where k rows survived
                z = torch.where(ok, z, torch.zeros_like(z))
        else:
            z = known
        z = z if coded_values.dim() == 2 else z[:, 0]
        return z.to(coded_values.dtype), ok
