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
  where a decoder is bound);
* ``slot_map``      — each worker's packed slots -> coded rows, which
  ``pack_coded_matrix`` packs by and the decode scatters by;
* ``ErasureDecoder`` — the decode bound to one G, which picks its solve
  once: the general (k, k) one, or for a systematic G the reduced one,
  static (no host read) or sized by the query's e (one read);
* ``decode_systematic`` — the torch twin of the reference's
  ``decode_systematic_jit``: a decoder bound for one call;
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
    """Whether the generator's top k rows are I_k, so that an
    ``ErasureDecoder`` may take the reduced solve.

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


def slot_map(row_ranges, max_load: int) -> np.ndarray:
    """(W, max_load) int32: the coded row of each worker's packed slot,
    worker i's rows [start_i, stop_i) of ``row_ranges`` in its first
    slots, -1 in a pad. ``_scatter`` reads it."""
    row_of = np.full((len(row_ranges), max_load), -1, np.int32)
    for i, (s, e) in enumerate(row_ranges):
        row_of[i, : e - s] = np.arange(s, e, dtype=np.int32)
    return row_of


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


def _columns(y: torch.Tensor) -> torch.Tensor:
    """``y`` as (rows, cols): a vector gets one column."""
    return y if y.dim() == 2 else y[:, None]


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


def _fill(y_known: torch.Tensor, slot: torch.Tensor, z_erased: torch.Tensor) -> torch.Tensor:
    """z: y on the surviving systematic rows, ``z_erased`` into the erased
    ones through ``slot`` (its padding into a dropped row k)."""
    full = torch.cat([y_known, y_known.new_zeros((1, z_erased.shape[1]))])
    return full.index_put_((slot,), z_erased)[:-1]


class ErasureDecoder:
    """The erasure decode of one generator, on its device: ``decoder(y,
    mask)`` -> (z, ok), z = A x of shape (k,) or (k, c) in y's dtype and
    ``ok`` a 0-d bool tensor, ``mask.sum() >= k``; z is zero where ``ok``
    is False.

    The solve is chosen here, once, from G and the two options; a call
    never tests it again. G's shape and ``is_systematic`` (one host read)
    decide between
      * general: G is not [I_k; P], or n == k. The first k survivors
        (stable argsort of ``~mask``) give G_S, solved whole, (k, k);
      * reduced (``_reduced_system``): each surviving systematic row is
        its own unknown, and only the erased ones are solved for, in a
        system of the first surviving parity rows. ``sized`` False, the
        static c x c system, c = min(n - k, k), with no read of the host,
        so a CUDA graph can hold the decode (the serve head's); ``sized``
        True (Path M's), the query's e and whether k rows survived read
        to the host in one transfer, and the system is e rounded up to
        ``SIZE_STEP`` rows (at most c): no solve where e is 0 (z is y) or
        fewer than k survived.
    Each solve is an LU with one step of iterative refinement in G's
    precision.

    With ``row_of`` (W, max_load) int (``slot_map``), the decoder takes
    the workers' packed products, (W, max_load) or (W, max_load, c), and
    a (W,) mask of the workers that met the deadline, and scatters them
    into coded-row order first (``_scatter``); without it, (n,) or (n, c)
    coded products (garbage where erased) and an (n,) mask of the rows
    that arrived.

    Inside a profiled Path M query a call opens the spans
    ``decode.gather`` (the scatter, the mask and the system built; on the
    reduced path with the attributes ``erased``, the count of erased
    systematic rows, a 0-d tensor read when the span is or the host's
    int, and ``size``, the system's rows), ``decode.lu`` and
    ``decode.trisolve`` (``obs.trace.stage``), each on every call, empty
    where there is nothing to solve. Each solve is a generator that runs
    a stage's work a step and yields z last. ``obs.metrics.REGISTRY``
    counts each call once in ``erasure_decodes`` by ``path``, and each
    sized call once in ``erasure_solve_rows`` by its ``size`` (0: no
    solve).
    """

    def __init__(self, generator: torch.Tensor, *, row_of: torch.Tensor | None = None,
                 sized: bool = False):
        self.generator = generator
        self.row_of = row_of
        self.n, self.k = generator.shape
        self.c = min(self.n - self.k, self.k)
        reduced = is_systematic(generator) and self.n > self.k
        #: the solve's ``erasure_decodes`` label: "reduced" or "general"
        self.path = "reduced" if reduced else "general"
        self._decodes = _DECODES[self.path]
        self._solve = self._general if not reduced else self._sized if sized else self._static
        self._solve_rows = {}  # size -> its erasure_solve_rows counter

    def __call__(self, coded_values: torch.Tensor, finished_mask: torch.Tensor):
        self._decodes.inc()
        dev = self.generator.device
        with stage("decode.gather", dev) as gather:
            if self.row_of is not None:
                coded_values, finished_mask = _scatter(self.n, self.row_of, coded_values,
                                                       finished_mask)
            mask = finished_mask.to(torch.bool)
            survivors = mask.sum()
            ok = survivors >= self.k
            steps = self._solve(coded_values, mask, survivors, ok, gather)
            next(steps)
        with stage("decode.lu", dev):
            next(steps)
        with stage("decode.trisolve", dev):
            z = next(steps)
            z = z if coded_values.dim() == 2 else z[:, 0]
            return z.to(coded_values.dtype), ok

    def _general(self, y, mask, survivors, ok, gather):
        """The (k, k) solve of the first k survivors' G_S."""
        idx = torch.argsort((~mask).to(torch.int8), stable=True)[:self.k]
        a = self.generator[idx]
        rhs = _columns(y[idx].to(self.generator.dtype))
        yield
        lu, perm = _factor(a)
        yield
        z = _refined_solve(a, lu, perm, rhs)
        yield torch.where(ok, z, torch.zeros_like(z))

    def _static(self, y, mask, survivors, ok, gather):
        """The reduced solve at c, no host read."""
        y = _columns(y.to(self.generator.dtype))
        e = (~mask[:self.k]).sum()
        gather.set(erased=e, size=self.c)
        a, rhs, slot, y_known = _reduced_system(self.generator, y, mask, self.c, e)
        yield
        lu, perm = _factor(a)
        yield
        z = _fill(y_known, slot, _refined_solve(a, lu, perm, rhs))
        yield torch.where(ok, z, torch.zeros_like(z))

    def _sized(self, y, mask, survivors, ok, gather):
        """The reduced solve at the query's size, read once on the host:
        ``_solve_at`` it, or no solve where it is 0."""
        y = _columns(y.to(self.generator.dtype))
        e, size = self._size(mask, survivors)
        gather.set(erased=e, size=size)
        if size:
            yield from self._solve_at(size, y, mask, e)
        else:  # all k systematic rows survived (z = y), or fewer than k rows did
            z = y[:self.k].clone() if e == 0 else torch.zeros_like(y[:self.k])
            yield
            yield
            yield z

    def _solve_at(self, size: int, y, mask, e):
        """The sized solve's work at ``size`` rows once e (the host's int)
        is read, with no host read of its own; it runs only where k rows
        survived, so nothing is zeroed."""
        a, rhs, slot, y_known = _reduced_system(self.generator, y, mask, size, e)
        yield
        lu, perm = _factor(a)
        yield
        yield _fill(y_known, slot, _refined_solve(a, lu, perm, rhs))

    def _size(self, mask, survivors) -> tuple[int, int]:
        """(e, size) on the host, from one read of the card: the count of
        erased systematic rows, and the system's size, e rounded up to
        ``SIZE_STEP`` and at most c, or 0 where there is nothing to solve (no
        erased row, or fewer than k ``survivors``), counted by size."""
        e, survived = torch.stack([(~mask[:self.k]).sum(), survivors]).tolist()
        size = min(-(-e // SIZE_STEP) * SIZE_STEP, self.c) if survived >= self.k else 0
        counter = self._solve_rows.get(size)
        if counter is None:
            counter = self._solve_rows[size] = _METRICS.counter("erasure_solve_rows", size=size)
        counter.inc()
        return e, size


def decode_systematic(generator: torch.Tensor, coded_values: torch.Tensor,
                      finished_mask: torch.Tensor):
    """The torch twin of the reference's ``decode_systematic_jit``: an
    ``ErasureDecoder`` of ``generator`` bound for one decode (the static
    reduced solve for a systematic G, the general one otherwise). Returns
    (z, ok)."""
    return ErasureDecoder(generator)(coded_values, finished_mask)
