"""Real-valued MDS coding for distributed matrix-vector multiplication.

Counterpart of ``repro/core/coding.py``. An (n, k) MDS code over the
ROWS of ``A in R^{k x d}``: ``A~ = G A`` with a systematic generator
``G = [I_k; P]`` (i.i.d. Gaussian parity, MDS with probability 1). The
master recovers ``A x`` from any k coded products by solving
``G_S z = y~_S``.

* ``make_generator`` — the port's own seeded G, or an injected numpy G
  (the parity tests hand over the reference's);
* ``encode``         — ``A~ = G A`` through the B3 ``mds_encode`` kernel;
* ``split_loads``    — each worker's row range of A~ from integer loads;
* ``decode_systematic`` — the torch twin of the reference's
  ``decode_systematic_jit``: fixed shape, no host branch on the data;
* ``decode_from_rows`` — least-squares recovery from any >= k surviving
  rows (the reference's host-side oracle).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.mds_encode.ops import mds_encode
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


def decode_systematic(generator: torch.Tensor, coded_values: torch.Tensor,
                      finished_mask: torch.Tensor):
    """Fixed-shape erasure decode on the tensors' device.

    Survivors first (stable argsort of ``~mask``, index order kept), the
    first k of them gathered into a static (k, k) system, LU-solved with
    one step of iterative refinement. ``ok`` is a 0-d bool tensor, False
    when fewer than k rows survived; the output is then zeroed. Nothing
    syncs with the host, so a CUDA graph can hold the decode: the solve is
    the row permutation and two triangular solves on the LU factors, not
    ``lu_solve``, whose choice of backend by size reaches MAGMA's batched
    solve at some (k, c), a call a capture refuses. Inside a profiled
    Path M query its stages are the spans ``decode.gather``, ``decode.lu``
    and ``decode.trisolve`` (``obs.trace.stage``).

    Args:
      generator: (n, k) generator used at encode time.
      coded_values: (n,) or (n, c) coded products (garbage where erased).
      finished_mask: (n,) bool — which coded rows arrived by the deadline.

    Returns (z, ok) with z of shape (k,) or (k, c) in ``coded_values``'s
    dtype.
    """
    n, k = generator.shape
    dev = generator.device
    with stage("decode.gather", dev):
        mask = finished_mask.to(torch.bool)
        order = torch.argsort((~mask).to(torch.int8), stable=True)
        idx = order[:k]
        g_s = generator[idx]
        y_s = coded_values[idx].to(generator.dtype)
        rhs = y_s if y_s.dim() == 2 else y_s[:, None]
    with stage("decode.lu", dev):
        lu, piv, _ = torch.linalg.lu_factor_ex(g_s)
        perm = torch.lu_unpack(lu, piv, unpack_data=False)[0].argmax(0)  # g_s = P L U

    def solve(b):
        y = torch.linalg.solve_triangular(lu, b[perm], upper=False, unitriangular=True)
        return torch.linalg.solve_triangular(lu, y, upper=True)

    with stage("decode.trisolve", dev):
        z = solve(rhs)
        z = z + solve(rhs - g_s @ z)  # refine
        z = z if y_s.dim() == 2 else z[:, 0]
        ok = mask.sum() >= k
        z = z.to(coded_values.dtype)
        return torch.where(ok, z, torch.zeros_like(z)), ok
