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

The bf16 kernels run on the tensor cores, and the wrapper allocates
their scratch (the kernels allocate nothing): the forward's per-(token,
256-row vocab tile) partials (``forward_scratch``), and the backward's
(T, Vc) bf16 dlogits chunk over vocab chunks of ``vocab_chunk`` rows,
plus for ``bwd_dh`` an f32 (T, D) running sum when there is more than
one chunk (``backward_scratch``). They read H and E through TMA, which
needs 16-byte row strides: the bf16 path takes any hidden width that is
a multiple of 8 (the GEMMs loop over D in 64-wide boxes). The f32 SIMT
kernels, the parity dtype, take a multiple of 4 up to ``MAX_D``.

``meta`` tensors take the kernels' checks and return empty outputs of
their shapes and dtypes, forward and backward. Every launch reports its
work to the active cost tallies (``_cuda.record_cost``): ``fused_ce_cost``,
2 T V D FLOPs forward and 4 T V D for each backward, which recomputes the
logits. A CPU call runs through the same autograd function, each kernel
replaced by its plain version (``fused_ce_plain``, ``_grad_plain``)
hidden from the tallies, so a count is the same on every device.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import CudaKernel

SOURCE = Path(__file__).parent / "csrc" / "fused_ce.cu"
MAX_D = 1024  # hidden width the f32 SIMT kernels hold per thread (csrc MAX_D)
TILE_V = 256  # vocab rows of a tensor-core output tile (csrc wg::BN)
SCRATCH_BYTES = 64 * 2**20  # bound on the bf16 dlogits chunk of the backward

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_FWD_TC_ARGS = [_P] * 9 + [_I] * 4 + [_P]  # + the three partial planes
_BWD_ARGS = [_P] * 7 + [_I] * 4 + [_P]
_BWD_TC_ARGS = [_P] * 9 + [_I] * 5 + [_P]  # + dlogits and sum scratch, Vc
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _kernel(name: str, bf16_args: list, f32_args: list) -> CudaKernel:
    return CudaKernel(name, SOURCE, {f"repro_{name}_bf16": bf16_args,
                                     f"repro_{name}_f32": f32_args},
                      library_name="fused_ce")


FWD = _kernel("fused_ce_fwd", _FWD_TC_ARGS, _FWD_ARGS)
BWD_DH = _kernel("fused_ce_bwd_dh", _BWD_TC_ARGS, _BWD_ARGS)
BWD_DE = _kernel("fused_ce_bwd_de", _BWD_TC_ARGS, _BWD_ARGS)
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


def fused_ce_cost(kernel: CudaKernel, t: int, v: int, d: int,
                  itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch of ``kernel`` on h (T, D) and the table
    (V, D) of ``itemsize`` bytes an element: the forward's 2 T V D and
    each backward's 4 T V D (logits recomputed, then one product); h, the
    table and the int32 labels read once, and the forward's (lse, ll f32,
    argmax int64) written, or the backward's (lse, g_lse, g_ll) f32 read
    and dH (T, D) or dE (V, D) written."""
    io = itemsize * (t * d + v * d) + 4 * t
    if kernel is FWD:
        return 2.0 * t * v * d, float(io + 16 * t)
    out_rows = t if kernel is BWD_DH else v
    return 4.0 * t * v * d, float(io + 12 * t + itemsize * out_rows * d)


def _grad_plain(wrt: str, h, table, labels32, lse, g_lse, g_ll):
    """dH or dE of ``g_lse . lse + g_ll . ll`` from recomputed f32 logits
    (the backward kernels' math), in h's or the table's dtype."""
    logits = torch.matmul(h.float(), table.float().T)
    dlog = torch.exp(logits - lse[:, None]) * g_lse[:, None]
    hit = labels32 >= 0
    rows = torch.arange(h.shape[0], device=h.device)[hit]
    dlog[rows, labels32[hit].long()] += g_ll[hit]
    if wrt == "dh":
        return torch.matmul(dlog, table.float()).to(h.dtype)
    return torch.matmul(dlog.T, h.float()).to(table.dtype)


def _check(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor) -> None:
    if h.dim() != 2 or table.dim() != 2 or h.shape[1] != table.shape[1]:
        raise ValueError(f"fused_ce: shapes {tuple(h.shape)} x {tuple(table.shape)}")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"fused_ce: labels {tuple(labels.shape)} for {h.shape[0]} tokens")
    if h.dtype not in _SUFFIX or table.dtype != h.dtype:
        raise TypeError("fused_ce kernel takes bf16 or f32 h and table of one dtype")
    d = h.shape[1]
    if h.dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"fused_ce kernel: hidden width {d} unsupported in bf16 "
                         f"(TMA rows need a multiple of 8)")
    if h.dtype == torch.float32 and (d % 4 or d > MAX_D):
        # the SIMT kernels hold a row in registers; bf16 (the training
        # dtype) tiles D through the tensor-core K loop and takes any width
        raise ValueError(f"fused_ce kernel: hidden width {d} unsupported in f32 "
                         f"(a multiple of 4, at most {MAX_D})")
    for t in (h, table, labels):
        if t.device != h.device or not t.is_contiguous():
            raise ValueError("fused_ce kernel takes contiguous tensors on one device")
        if t.data_ptr() % 16:
            raise ValueError("fused_ce kernel takes 16-byte aligned tensors")


def forward_scratch(t: int, v: int) -> dict[str, tuple]:
    """Scratch of one bf16 forward launch: name -> (shape, dtype).

    One partial per (token, ``TILE_V``-row vocab tile): the tile's max
    logit, its sum of exp(logit - max) and the first index of the max.
    """
    tiles = (t, -(-v // TILE_V))
    return {"max": (tiles, torch.float32), "sum": (tiles, torch.float32),
            "argmax": (tiles, torch.int32)}


def fused_ce_forward(h, table, labels32):
    """Launch the forward kernel: (lse, ll, argmax) for CUDA tensors.

    bf16 runs the tensor-core GEMM and its combine on partials allocated
    here (``forward_scratch``); f32 runs the SIMT kernel. ``meta``
    tensors return the empty outputs, CPU ones ``fused_ce_plain``.
    """
    t, d = h.shape
    v = table.shape[0]
    if h.device.type == "cpu":
        with _cuda.uncounted():
            lse, ll, am = fused_ce_plain(h, table, labels32)
    else:
        lse = torch.empty(t, dtype=torch.float32, device=h.device)
        ll = torch.empty(t, dtype=torch.float32, device=h.device)
        am = torch.empty(t, dtype=torch.int64, device=h.device)
    if _cuda.TALLIES:
        _cuda.record_cost(FWD.name, *fused_ce_cost(FWD, t, v, d, h.element_size()),
                          (h, table, labels32), (lse, ll, am))
    if h.device.type in ("cpu", "meta") or not (t and v):
        return lse, ll, am
    args = (h.data_ptr(), table.data_ptr(), labels32.data_ptr(), lse.data_ptr(),
            ll.data_ptr(), am.data_ptr())
    if h.dtype == torch.float32:
        FWD.launch("repro_fused_ce_fwd_f32", h.device, *args, t, v, d)
        return lse, ll, am
    part = [torch.empty(shape, dtype=dtype, device=h.device)
            for shape, dtype in forward_scratch(t, v).values()]
    FWD.launch("repro_fused_ce_fwd_bf16", h.device, *args,
               *(x.data_ptr() for x in part), t, v, d)
    return lse, ll, am


def vocab_chunk(t: int, v: int, chunk: int | None = None) -> int:
    """Vocab rows per chunk of the bf16 backward, a multiple of ``TILE_V``.

    By default the largest whose (t, Vc) bf16 dlogits scratch fits in
    ``SCRATCH_BYTES`` (at least one tile); never more than V rounded up
    to a tile. ``chunk`` overrides the default (tests reach chunk edges
    with it).
    """
    if chunk is None:
        chunk = max(TILE_V, SCRATCH_BYTES // (2 * max(t, 1)) // TILE_V * TILE_V)
    elif chunk <= 0 or chunk % TILE_V:
        raise ValueError(f"fused_ce: chunk {chunk} is not a positive multiple of {TILE_V}")
    return min(chunk, -(-v // TILE_V) * TILE_V)


def backward_scratch(kernel: CudaKernel, t: int, v: int, d: int,
                     chunk: int | None = None) -> dict[str, tuple]:
    """Scratch of one bf16 backward launch: name -> (shape, dtype).

    ``dlogits`` is the (t, Vc) bf16 chunk; ``bwd_dh`` adds an f32 (t, d)
    running sum when the vocab takes more than one chunk.
    """
    vc = vocab_chunk(t, v, chunk)
    out = {"dlogits": ((t, vc), torch.bfloat16)}
    if kernel is BWD_DH and v > vc:
        out["sum"] = ((t, d), torch.float32)
    return out


def scratch_bytes(kernel: CudaKernel, t: int, v: int, d: int,
                  chunk: int | None = None) -> int:
    """Bytes of the scratch of one bf16 launch of ``kernel``:
    ``forward_scratch`` for ``FWD``, else ``backward_scratch``."""
    spec = (forward_scratch(t, v) if kernel is FWD
            else backward_scratch(kernel, t, v, d, chunk))
    return sum(math.prod(shape) * dtype.itemsize for shape, dtype in spec.values())


def fused_ce_backward(kernel: CudaKernel, h, table, labels32, lse, g_lse, g_ll,
                      chunk: int | None = None):
    """Launch ``bwd_dh`` (-> (T, D)) or ``bwd_de`` (-> (V, D)) in h's dtype.

    bf16 runs the chunked tensor-core kernels on scratch allocated here
    (``chunk``: vocab rows per chunk, ``vocab_chunk``'s default if None);
    f32 runs the SIMT kernels. ``meta`` tensors return the empty output,
    CPU ones the plain gradient (``_grad_plain``).
    """
    (t, d), v = h.shape, table.shape[0]
    args = (h, table, labels32, lse, g_lse, g_ll)
    if h.device.type == "cpu":
        with _cuda.uncounted():
            out = _grad_plain("dh" if kernel is BWD_DH else "de", *args)
    else:
        out = torch.empty((t if kernel is BWD_DH else v, d), dtype=h.dtype, device=h.device)
    if _cuda.TALLIES:
        _cuda.record_cost(kernel.name, *fused_ce_cost(kernel, t, v, d, h.element_size()),
                          args, (out,))
    if h.device.type in ("cpu", "meta") or not (t and v):
        return out
    fn = f"repro_{kernel.name}_{_SUFFIX[h.dtype]}"
    args = (h.data_ptr(), table.data_ptr(), labels32.data_ptr(), lse.data_ptr(),
            g_lse.data_ptr(), g_ll.data_ptr(), out.data_ptr())
    if h.dtype == torch.float32:
        kernel.launch(fn, h.device, *args, t, v, d)
        return out
    scratch = {name: torch.empty(shape, dtype=dtype, device=h.device)
               for name, (shape, dtype) in backward_scratch(kernel, t, v, d, chunk).items()}
    total = scratch.get("sum")
    kernel.launch(fn, h.device, *args, scratch["dlogits"].data_ptr(),
                  total.data_ptr() if total is not None else None,
                  t, v, d, scratch["dlogits"].shape[1])
    return out


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, labels32, chunk):
        lse, ll, am = fused_ce_forward(h, table, labels32)
        ctx.chunk = chunk
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
        dh = (fused_ce_backward(BWD_DH, *args, chunk=ctx.chunk)
              if ctx.needs_input_grad[0] else None)
        de = (fused_ce_backward(BWD_DE, *args, chunk=ctx.chunk)
              if ctx.needs_input_grad[1] else None)
        return dh, de, None, None


def fused_ce(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
             chunk: int | None = None):
    """Per-token (lse, ll, argmax) of ``h table^T``; never writes logits on the card.

    h: (T, D) and table: (V, D) in the compute dtype (bf16 or f32),
    labels: (T,) int (< 0 = masked: ll 0, no one-hot gradient). lse and
    ll are f32, argmax int64 (first index on ties). A CPU ``h`` runs the
    plain versions (``fused_ce_plain`` forward, ``_grad_plain`` backward);
    a CUDA ``h`` launches the kernels (anything they do not take raises);
    a ``meta`` ``h`` takes the same checks and returns empty outputs.
    ``chunk``: vocab rows per chunk of the bf16 backward (``vocab_chunk``).
    """
    if h.device.type == "cpu":
        return _FusedCE.apply(h, table, labels.to(torch.int32), chunk)
    if h.device.type not in ("cuda", "meta"):
        raise ValueError(f"fused_ce: unsupported device {h.device}")
    labels32 = labels.to(torch.int32).contiguous()
    _check(h, table, labels32)
    if h.dtype == torch.bfloat16:
        vocab_chunk(h.shape[0], table.shape[0], chunk)  # refuse a bad chunk now
    return _FusedCE.apply(h, table, labels32, chunk)
