"""B4 fused linear cross-entropy: per-token ``(lse, ll, argmax)`` of ``H E^T``.

Counterpart of ``repro/kernels/fused_ce/ops.py``. The reference wraps the
Pallas kernel in a custom VJP of the scalar mean loss; here the
``torch.autograd.Function`` sits one level lower, at the per-token
``(lse, label logit)`` pair, so the z-loss, the label mask, the
per-partition normalization and the coded partition weights stay plain
torch on (T,) vectors and autograd composes them.

``fused_ce`` is the wrapper: CUDA tensors run the three hand-written
kernels of ``csrc/fused_ce.cu`` (forward, then ``bwd_dh`` and ``bwd_de``
in the backward), CPU tensors run ``fused_ce_plain``, which materializes
the logits. Labels < 0 have ``ll = 0`` and no one-hot term.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._cuda import CudaKernel

SOURCE = Path(__file__).parent / "csrc" / "fused_ce.cu"
MAX_D = 1024  # hidden width the kernels hold per thread (csrc MAX_D)

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 7 + [_I] * 4 + [_P]
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _kernel(name: str, args: list) -> CudaKernel:
    return CudaKernel(name, SOURCE,
                      {f"repro_{name}_{s}": args for s in _SUFFIX.values()},
                      library_name="fused_ce")


FWD = _kernel("fused_ce_fwd", _FWD_ARGS)
BWD_DH = _kernel("fused_ce_bwd_dh", _BWD_ARGS)
BWD_DE = _kernel("fused_ce_bwd_de", _BWD_ARGS)
KERNELS = (FWD, BWD_DH, BWD_DE)


def fused_ce_plain(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor):
    """Materialized oracle: logits = h table^T in f32 from the given operands.

    Returns (lse f32, ll f32, argmax int64), each (T,); differentiable in
    ``h`` and ``table`` through autograd.
    """
    logits = torch.matmul(h.float(), table.float().T)
    lse = torch.logsumexp(logits, dim=-1)
    hit = labels >= 0
    picked = logits.gather(1, labels.clamp_min(0).long()[:, None])[:, 0]
    ll = torch.where(hit, picked, torch.zeros_like(picked))
    return lse, ll, logits.argmax(dim=-1)


def _check(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor) -> None:
    if h.dim() != 2 or table.dim() != 2 or h.shape[1] != table.shape[1]:
        raise ValueError(f"fused_ce: shapes {tuple(h.shape)} x {tuple(table.shape)}")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"fused_ce: labels {tuple(labels.shape)} for {h.shape[0]} tokens")
    if h.dtype not in _SUFFIX or table.dtype != h.dtype:
        raise TypeError("fused_ce kernel takes bf16 or f32 h and table of one dtype")
    d = h.shape[1]
    if d % 4 or d > MAX_D:
        raise ValueError(f"fused_ce kernel: hidden width {d} unsupported "
                         f"(a multiple of 4, at most {MAX_D})")
    for t in (h, table, labels):
        if t.device != h.device or not t.is_contiguous():
            raise ValueError("fused_ce kernel takes contiguous tensors on one device")
        if t.data_ptr() % 16:
            raise ValueError("fused_ce kernel takes 16-byte aligned tensors")


def fused_ce_forward(h, table, labels32):
    """Launch the forward kernel: (lse, ll, argmax) for CUDA tensors."""
    t, d = h.shape
    v = table.shape[0]
    lse = torch.empty(t, dtype=torch.float32, device=h.device)
    ll = torch.empty(t, dtype=torch.float32, device=h.device)
    am = torch.empty(t, dtype=torch.int64, device=h.device)
    if t and v:
        FWD.launch(f"repro_fused_ce_fwd_{_SUFFIX[h.dtype]}", h.device, h.data_ptr(),
                   table.data_ptr(), labels32.data_ptr(), lse.data_ptr(),
                   ll.data_ptr(), am.data_ptr(), t, v, d)
    return lse, ll, am


def fused_ce_backward(kernel: CudaKernel, h, table, labels32, lse, g_lse, g_ll):
    """Launch ``bwd_dh`` (-> (T, D)) or ``bwd_de`` (-> (V, D)) in h's dtype."""
    (t, d), v = h.shape, table.shape[0]
    out = torch.empty((t if kernel is BWD_DH else v, d), dtype=h.dtype, device=h.device)
    if t and v:
        kernel.launch(f"repro_{kernel.name}_{_SUFFIX[h.dtype]}", h.device,
                      h.data_ptr(), table.data_ptr(), labels32.data_ptr(),
                      lse.data_ptr(), g_lse.data_ptr(), g_ll.data_ptr(),
                      out.data_ptr(), t, v, d)
    return out


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, labels32):
        lse, ll, am = fused_ce_forward(h, table, labels32)
        ctx.save_for_backward(h, table, labels32, lse)
        ctx.mark_non_differentiable(am)
        return lse, ll, am

    @staticmethod
    def backward(ctx, g_lse, g_ll, _g_am):
        h, table, labels32, lse = ctx.saved_tensors

        def grad_or_zeros(g):
            if g is None:
                return torch.zeros_like(lse)
            return g.float().contiguous()

        g_lse, g_ll = grad_or_zeros(g_lse), grad_or_zeros(g_ll)
        args = (h, table, labels32, lse, g_lse, g_ll)
        dh = fused_ce_backward(BWD_DH, *args) if ctx.needs_input_grad[0] else None
        de = fused_ce_backward(BWD_DE, *args) if ctx.needs_input_grad[1] else None
        return dh, de, None


def fused_ce(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor):
    """Per-token (lse, ll, argmax) of ``h table^T``; never writes logits on the card.

    h: (T, D) and table: (V, D) in the compute dtype (bf16 or f32),
    labels: (T,) int (< 0 = masked: ll 0, no one-hot gradient). lse and
    ll are f32, argmax int64 (first index on ties). A CPU ``h`` runs
    ``fused_ce_plain``; a CUDA ``h`` launches the kernels (anything they
    do not take raises).
    """
    if h.device.type == "cpu":
        return fused_ce_plain(h, table, labels)
    if h.device.type != "cuda":
        raise ValueError(f"fused_ce: unsupported device {h.device}")
    labels32 = labels.to(torch.int32).contiguous()
    _check(h, table, labels32)
    return _FusedCE.apply(h, table, labels32)
