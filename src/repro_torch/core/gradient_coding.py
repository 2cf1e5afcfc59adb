"""Gradient coding over batch partitions (Wang et al. 2019, arXiv:1901.09339).

Counterpart of ``repro/core/gradient_coding.py``. The global batch is
split into ``k`` partitions; coded row ``i`` carries ``sum_j B[i, j] g_j``
and the master recovers the full-batch gradient from any ``k`` surviving
rows through one decode vector ``a`` with ``a^T B_S = 1^T``:

* ``assignment_matrix`` — B, the systematic Gaussian generator shared
  with the coded LM head (``coding.make_generator``);
* ``partition_weights`` — ``w = a^T B`` (ones when the decode is exact);
* ``decode_vector``     — the numpy oracle;
* ``decode_vector_torch`` — the fixed-shape twin of the reference's
  ``decode_vector_jit``: survivors-first stable argsort, a (k, k) LU
  with one refinement step, an ``ok`` flag, a zeroed vector on failure;
* ``encode_gradients`` / ``aggregate_coded`` — the explicit worker-side
  encode and master-side aggregate over dicts of tensors (the trainer
  never materializes them: it weights partitions by ``a^T B``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coding import make_generator


def assignment_matrix(n: int, k: int, *, seed: int = 0, b: np.ndarray | None = None,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """(n, k) float32 assignment matrix B (``b`` injects a given one)."""
    return make_generator(n, k, seed=seed, g=b, device=device)


def partition_weights(b_matrix, decode_vec) -> np.ndarray:
    """Effective per-partition weights ``w = a^T B`` of a decode vector."""
    return np.asarray(decode_vec) @ np.asarray(b_matrix)


def decode_vector(b_matrix, finished_rows) -> tuple[np.ndarray, bool]:
    """Numpy oracle: (a, ok) with ``a^T B_S = 1^T`` on the first k survivors.

    ``a`` is zero on every unused row, and all zero (ok False) when fewer
    than k rows survived.
    """
    b = np.asarray(b_matrix, np.float64)
    fin = np.asarray(finished_rows, bool)
    n, k = b.shape
    a = np.zeros((n,), np.float64)
    if fin.sum() < k:
        return a, False
    use = np.flatnonzero(fin)[:k]
    a[use] = np.linalg.solve(b[use].T, np.ones((k,)))
    return a, True


def decode_vector_torch(b_matrix: torch.Tensor, finished_rows: torch.Tensor):
    """Fixed-shape decode vector on the tensors' device; no host sync.

    Returns (a (n,) in B's dtype, ok 0-d bool tensor).
    """
    n, k = b_matrix.shape
    mask = finished_rows.to(torch.bool)
    idx = torch.argsort((~mask).to(torch.int8), stable=True)[:k]
    bs_t = b_matrix[idx].T  # (k, k)
    rhs = torch.ones((k, 1), dtype=b_matrix.dtype, device=b_matrix.device)
    lu, piv, _ = torch.linalg.lu_factor_ex(bs_t)
    c = torch.linalg.lu_solve(lu, piv, rhs)
    c = c + torch.linalg.lu_solve(lu, piv, rhs - bs_t @ c)  # refine
    ok = mask.sum() >= k
    a = torch.zeros((n,), dtype=b_matrix.dtype, device=b_matrix.device)
    a = a.index_copy(0, idx, c[:, 0])
    return torch.where(ok, a, torch.zeros_like(a)), ok


def aggregate_coded(coded_grads: dict, decode_vec: torch.Tensor) -> dict:
    """Master-side ``g = sum_i a_i g~_i``; leaves have a leading (n,) axis."""
    return {name: torch.tensordot(decode_vec.to(g.dtype), g, dims=1)
            for name, g in coded_grads.items()}


def encode_gradients(partition_grads: dict, b_matrix: torch.Tensor) -> dict:
    """Worker-side ``g~_i = sum_j B[i, j] g_j``; (k,) leading axis -> (n,)."""
    return {name: torch.tensordot(b_matrix.to(g.dtype), g, dims=1)
            for name, g in partition_grads.items()}
