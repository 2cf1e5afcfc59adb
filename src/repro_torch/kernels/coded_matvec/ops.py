"""B1 coded matvec ``Y = A X``: CUDA kernel on the card, plain torch on the CPU.

Counterpart of ``repro/kernels/coded_matvec/ops.py``. The reference vmaps
its Pallas matvec over the columns of X and over the workers; here both
are kernel dimensions (source note in ``csrc/coded_matvec.cu``):

* N > 8 columns (the coded head's block mix) is one GEMM launch;
  ``gemm_plan`` splits K so that the card fills, and with more than one
  split a second launch sums the partials in split order;
* N <= 8 (``NARROW_N``; the paper's matvec) is one launch of the narrow
  branch, which streams A with 16-byte loads against X staged in shared
  memory; ``blocked_matvec_batch`` runs the workers' (W, L, D) blocks as
  one such launch on the (W*L, D) view.

A ``meta`` tensor returns an empty output of the kernel's shape and
dtype and computes nothing; every call reports ``blocked_matvec_cost``
to the active cost tallies (``_cuda.record_cost``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import CudaKernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel(
    "coded_matvec",
    Path(__file__).parent / "csrc" / "coded_matvec.cu",
    {"repro_coded_matvec_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _P],
     "repro_coded_matvec_narrow_f32": [_P, _P, _P, _I, _I, _I, _I, _P]},
)

NARROW_N = 8       # widest X the narrow (matvec) branch takes

BK = 16            # K slice depth of the mainloop (csrc/pipe_sgemm.cuh)
TILE = (128, 256)  # the block tile of csrc/coded_matvec.cu, one block an SM


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """The split of K of one ``Y = A X`` (M, K) x (K, N) launch."""

    per_split: int   # K slices a split runs
    splits: int      # splits of K (1: no partials, no second launch)
    blocks: int      # GEMM blocks: tiles x splits


def partial_stride(m: int, n: int) -> int:
    """Floats between two split partials in the scratch: M N rounded up to
    4, so every partial starts 16-byte aligned."""
    return -(-m * n // 4) * 4


@functools.lru_cache(maxsize=256)
def gemm_plan(m: int, n: int, k: int, sms: int) -> GemmPlan:
    """Split K of ``(M, K) x (K, N)`` on ``sms`` SMs so that the tiles
    times the splits give each SM a block: ``ceil(sms / tiles)`` splits,
    at most one a K slice. Splits never come out empty: the count is
    ``ceil(slices / per_split)``."""
    tiles = -(-m // TILE[0]) * -(-n // TILE[1])
    slices = max(1, -(-k // BK))
    per = -(-slices // min(slices, max(1, -(-sms // max(1, tiles)))))
    splits = -(-slices // per)
    return GemmPlan(per, splits, tiles * splits)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def blocked_matvec_cost(m: int, k: int, n: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one ``Y = A X`` launch, (M, K) x (K, N) float32:
    2 M K N, and A, X read once and Y written once."""
    return 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)


def blocked_matvec_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x with f32 accumulation, output in A's dtype (``matvec_ref``)."""
    return torch.matmul(a.float(), x.float()).to(a.dtype)


def blocked_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (M, K) times x (K,) or X (K, N) -> (M,) or (M, N).

    A CUDA ``a`` launches the kernel (float32, contiguous, same device;
    anything else raises): the narrow branch for N <= ``NARROW_N``, else
    the GEMM split as ``gemm_plan`` says. A ``meta`` ``a`` takes the same
    checks and returns the empty (M, N) float32 output. A CPU ``a`` runs
    ``blocked_matvec_plain``.
    """
    if a.device.type == "cpu":
        with _cuda.uncounted():
            y = blocked_matvec_plain(a, x)
        if _cuda.TALLIES:
            _cuda.record_cost(KERNEL.name, *blocked_matvec_cost(
                a.shape[0], a.shape[-1], 1 if x.dim() == 1 else x.shape[-1]), (a, x), (y,))
        return y
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"blocked_matvec: unsupported device {a.device}")
    x2 = x[:, None] if x.dim() == 1 else x
    if a.dim() != 2 or x2.dim() != 2 or a.shape[1] != x2.shape[0]:
        raise ValueError(f"blocked_matvec: shapes {tuple(a.shape)} x {tuple(x.shape)}")
    if a.dtype != torch.float32 or x2.dtype != torch.float32:
        raise TypeError("blocked_matvec kernel takes float32 operands")
    if x2.device != a.device or not (a.is_contiguous() and x2.is_contiguous()):
        raise ValueError("blocked_matvec kernel takes contiguous operands on one device")
    (m, k), n = a.shape, x2.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if a.device.type == "cuda" and y.numel() and n <= NARROW_N and k > 0:
        KERNEL.launch("repro_coded_matvec_narrow_f32", a.device, a.data_ptr(),
                      x2.data_ptr(), y.data_ptr(), m, n, k)
    elif a.device.type == "cuda" and y.numel():
        index = a.device.index if a.device.index is not None else torch.cuda.current_device()
        plan = gemm_plan(m, n, k, sm_count(index))
        stride = partial_stride(m, n)
        scratch = (torch.empty(plan.splits * stride, dtype=torch.float32, device=a.device)
                   if plan.splits > 1 else None)
        KERNEL.launch("repro_coded_matvec_f32", a.device, a.data_ptr(), x2.data_ptr(),
                      y.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                      m, n, k, plan.per_split, plan.splits, stride)
    y = y[:, 0] if x.dim() == 1 else y
    if _cuda.TALLIES:
        _cuda.record_cost(KERNEL.name, *blocked_matvec_cost(m, k, n), (a, x), (y,))
    return y


def blocked_matvec_batch(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-worker products: a (W, L, D) times x (D,) -> (W, L).

    One ``blocked_matvec`` on the (W*L, D) view: on the card one launch of
    the narrow branch, on the CPU ``blocked_matvec_plain``.
    """
    if a.dim() != 3 or x.dim() != 1:
        raise ValueError(f"blocked_matvec_batch: shapes {tuple(a.shape)} x {tuple(x.shape)}")
    w, l, d = a.shape
    return blocked_matvec(a.reshape(w * l, d), x).reshape(w, l)
