"""B1 coded matvec ``Y = A X``: CUDA kernel on the card, plain torch on the CPU.

Counterpart of ``repro/kernels/coded_matvec/ops.py``. The reference vmaps
its Pallas matvec over the columns of X; here the column batch is a
kernel dimension, so the coded head's whole block mix is one launch
(source note in ``csrc/coded_matvec.cu``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._cuda import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "coded_matvec",
    Path(__file__).parent / "csrc" / "coded_matvec.cu",
    {"repro_coded_matvec_f32": [_P, _P, _P, _I, _I, _I, _I, _P]},
)


def blocked_matvec_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x with f32 accumulation, output in A's dtype (``matvec_ref``)."""
    return torch.matmul(a.float(), x.float()).to(a.dtype)


def blocked_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (M, K) times x (K,) or X (K, N) -> (M,) or (M, N).

    A CUDA ``a`` launches the kernel (float32, contiguous, same device;
    anything else raises); a CPU ``a`` runs ``blocked_matvec_plain``.
    """
    if a.device.type == "cpu":
        return blocked_matvec_plain(a, x)
    if a.device.type != "cuda":
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
    if y.numel():
        KERNEL.launch("repro_coded_matvec_f32", a.device, a.data_ptr(), x2.data_ptr(),
                      y.data_ptr(), m, n, k)
    return y[:, 0] if x.dim() == 1 else y
