"""B3 MDS encode ``A~ = G A``: CUDA kernel on the card, plain torch on the CPU.

Counterpart of ``repro/kernels/mds_encode/ops.py`` (source note in
``csrc/mds_encode.cu``). A ``meta`` tensor returns an empty output of the
kernel's shape and dtype; every call reports ``mds_encode_cost`` to the
active cost tallies (``_cuda.record_cost``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "mds_encode",
    Path(__file__).parent / "csrc" / "mds_encode.cu",
    {"repro_mds_encode_f32": [_P, _P, _P, _I, _I, _I, _I, _P]},
)


def mds_encode_cost(n: int, k: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one ``A~ = G A`` launch, (n, k) x (k, d) float32:
    2 n k d, and G, A read once and A~ written once."""
    return 2.0 * n * k * d, 4.0 * (n * k + k * d + n * d)


def mds_encode_plain(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A~ = G A with f32 accumulation, output in A's dtype (``encode_ref``)."""
    return torch.matmul(g.float(), a.float()).to(a.dtype)


def mds_encode(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """G (n, k) times A (k, d) -> (n, d).

    A CUDA ``a`` launches the kernel (float32, contiguous, same device;
    anything else raises); a ``meta`` ``a`` takes the same checks and
    returns the empty (n, d) float32 output; a CPU ``a`` runs
    ``mds_encode_plain``.
    """
    if a.device.type == "cpu":
        with _cuda.uncounted():
            out = mds_encode_plain(g, a)
        if _cuda.TALLIES:
            _cuda.record_cost(KERNEL.name, *mds_encode_cost(
                g.shape[0], g.shape[-1], a.shape[-1]), (g, a), (out,))
        return out
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"mds_encode: unsupported device {a.device}")
    if g.dim() != 2 or a.dim() != 2 or g.shape[1] != a.shape[0]:
        raise ValueError(f"mds_encode: shapes {tuple(g.shape)} x {tuple(a.shape)}")
    if g.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("mds_encode kernel takes float32 operands")
    if g.device != a.device or not (g.is_contiguous() and a.is_contiguous()):
        raise ValueError("mds_encode kernel takes contiguous operands on one device")
    (n, k), d = g.shape, a.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=a.device)
    if a.device.type == "cuda" and out.numel():
        KERNEL.launch("repro_mds_encode_f32", a.device, g.data_ptr(), a.data_ptr(),
                      out.data_ptr(), n, d, k)
    if _cuda.TALLIES:
        _cuda.record_cost(KERNEL.name, *mds_encode_cost(n, k, d), (g, a), (out,))
    return out
