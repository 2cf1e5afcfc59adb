"""Paged attention over a KV block pool: scatters, gathers and attends.

Counterpart of ``repro/kernels/paged_attention/ops.py``. The pool is
``(num_blocks + 1, block_len, KV, hd)`` per layer; physical block
``num_blocks`` is the WRITE SINK: inactive, frozen and padded rows
scatter there, and no block table ever references it. The port scatters
in place (the reference returns updated copies).

``paged_decode_attend`` is the B2 kernel's wrapper: a CUDA tensor
launches the hand-written split-KV kernel (``csrc/paged_decode.cu``: one
launch over (slot x KV head, table block), one that folds the splits), a
CPU tensor runs ``paged_decode_attend_plain``. ``decode_splits`` sizes
the split grid from the table's width. A ``meta`` ``q`` returns an empty
output of the kernel's shape and dtype; every call reports
``paged_decode_cost`` to the active cost tallies (``_cuda.record_cost``).
The chunked-prefill attend has no TPU kernel and stays plain torch on
every device.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import CudaKernel

NEG_INF = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I, _P]
KERNEL = CudaKernel(
    "paged_decode",
    Path(__file__).parent / "csrc" / "paged_decode.cu",
    {"repro_paged_decode_bf16": _ARGS, "repro_paged_decode_f32": _ARGS},
)
_ENTRY = {torch.bfloat16: "repro_paged_decode_bf16",
          torch.float32: "repro_paged_decode_f32"}
MAX_G = 8  # query rows per KV head the kernel holds (csrc MAX_G)


def decode_splits(table_width: int) -> int:
    """Splits of the split-KV decode grid: one per table entry, at least
    one (an empty table still writes zeros).

    Sized from the table's width MB, never from ``pos``: reading ``pos``
    on the host would synchronise once per layer. Splits that start past
    a slot's ``pos`` exit at once on the card.
    """
    return max(1, table_width)


def paged_decode_cost(s: int, kv: int, g: int, hd: int, table_width: int, block_len: int,
                      itemsize: int, tokens: int | None = None) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode attend: ``tokens`` KV entries attended
    in all (by default every table entry, ``s * table_width * block_len``:
    the most the shapes allow; a caller that knows the positions passes
    the valid count). 4 tokens KV G hd FLOPs (scores and the weighted
    sum); q read and the output written once, each attended K and V row
    read once, the table and positions read once."""
    tokens = s * table_width * block_len if tokens is None else tokens
    nbytes = itemsize * (2 * s * kv * g * hd + 2 * tokens * kv * hd) + 4 * s * (table_width + 1)
    return 4.0 * tokens * kv * g * hd, float(nbytes)


def decode_scratch_floats(s: int, kv: int, g: int, hd: int, nsplit: int) -> int:
    """Floats of the split partials: (m, l, acc[hd]) per (slot, head, row, split)."""
    return s * kv * g * nsplit * (hd + 2)


def _phys(table: torch.Tensor, sink: int) -> torch.Tensor:
    """Physical block per table entry; unallocated -> sink."""
    return torch.where(table >= 0, table, sink)


def gather_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(NBp, BL, KV, hd), (S, MB) -> (S, MB*BL, KV, hd) logical view."""
    s, mb = table.shape
    return pool[_phys(table, pool.shape[0] - 1)].reshape(
        s, mb * pool.shape[1], *pool.shape[2:]
    )


def valid_mask(table: torch.Tensor, block_len: int, q_pos: torch.Tensor
               ) -> torch.Tensor:
    """(S, MB), BL, (S,) -> (S, MB*BL) attendable-entry mask."""
    alloc = torch.repeat_interleave(table >= 0, block_len, dim=1)
    j = torch.arange(alloc.shape[1], device=table.device)
    return alloc & (j[None, :] <= q_pos[:, None])


def scatter_decode(k_pool, v_pool, k_new, v_new, table, pos, active):
    """Write one token per slot at logical position ``pos``, in place.

    k_new/v_new: (S, KV, hd); pos: (S,) int; active: (S,) bool — rows
    that are not actively decoding write to the sink block.
    """
    sink = k_pool.shape[0] - 1
    bl, mb = k_pool.shape[1], table.shape[1]
    bidx = torch.clamp(pos // bl, 0, mb - 1)
    blk = torch.gather(table, 1, bidx[:, None].long())[:, 0]
    blk = torch.where(active & (blk >= 0), blk, sink).long()
    off = (pos % bl).long()
    k_pool[blk, off] = k_new.to(k_pool.dtype)
    v_pool[blk, off] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def scatter_chunk(k_pool, v_pool, k_new, v_new, table, start, chunk_len):
    """Write a prefill chunk per slot into the pool, in place.

    k_new/v_new: (S, C, KV, hd); row ``i`` of slot ``s`` lands at logical
    position ``start[s] + i`` when ``i < chunk_len[s]``; padded rows (and
    slots not prefilling) go to the sink.
    """
    s, c = k_new.shape[:2]
    sink = k_pool.shape[0] - 1
    bl, mb = k_pool.shape[1], table.shape[1]
    ar = torch.arange(c, device=table.device)
    p = start[:, None] + ar[None, :]
    writing = ar[None, :] < chunk_len[:, None]
    bidx = torch.clamp(p // bl, 0, mb - 1)
    blk = torch.gather(table, 1, bidx.long())
    blk = torch.where(writing & (blk >= 0), blk, sink).long().reshape(-1)
    off = (p % bl).long().reshape(-1)
    k_pool[blk, off] = k_new.reshape(s * c, *k_new.shape[2:]).to(k_pool.dtype)
    v_pool[blk, off] = v_new.reshape(s * c, *v_new.shape[2:]).to(v_pool.dtype)
    return k_pool, v_pool


def paged_decode_attend_plain(q, k_pool, v_pool, table, pos):
    """Single-query paged attention, float32 softmax, over the gathered pool.

    q: (S, KV, G, hd) post-rope; pos: (S,) write positions (already
    scattered). Masked entries get weight exactly 0 and their gathered
    K/V are zeroed (the sink may hold anything, NaN included), and the
    output is divided by ``max(l, 1e-30)``, so a slot with no valid entry
    returns zeros, as the kernel does (an empty table too). Returns
    (S, KV, G, hd) in v's dtype.
    """
    if table.shape[1] == 0:
        return torch.zeros(q.shape, dtype=v_pool.dtype, device=q.device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid = valid_mask(table, k_pool.shape[1], pos)
    keep = valid[:, :, None, None]
    k = torch.where(keep, gather_kv(k_pool, table).float(), 0.0)
    v = torch.where(keep, gather_kv(v_pool, table).float(), 0.0)
    sc = torch.einsum("bkgh,bskh->bkgs", q.float(), k) * scale
    valid = valid[:, None, None, :]
    sc = sc.masked_fill(~valid, NEG_INF)
    w = torch.exp(sc - sc.amax(-1, keepdim=True)) * valid
    out = torch.einsum("bkgs,bskh->bkgh", w, v)
    out = out / w.sum(-1)[..., None].clamp_min(1e-30)
    return out.to(v_pool.dtype)


def paged_decode_attend(q, k_pool, v_pool, table, pos):
    """The B2 wrapper: kernel for CUDA tensors, plain torch for CPU ones,
    the empty output for ``meta`` ones (after the kernel's checks).

    Shapes as ``paged_decode_attend_plain``; ``table``/``pos`` int32. On
    the card q and the pools must share a dtype (bfloat16 or float32),
    be contiguous, and have a head_dim of whole 16-byte vectors (a
    multiple of 8 in bf16, of 4 in f32; at most 1024) and at most
    ``MAX_G`` query rows per KV head; anything else raises.
    """
    s, kv, g, hd = q.shape
    nbp, bl = k_pool.shape[:2]
    mb = table.shape[1]
    if q.device.type == "cpu":
        with _cuda.uncounted():
            out = paged_decode_attend_plain(q, k_pool, v_pool, table, pos)
        _record_cost(q, k_pool, v_pool, table, pos, out)
        return out
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_decode_attend: unsupported device {q.device}")
    if k_pool.shape != (nbp, bl, kv, hd) or v_pool.shape != k_pool.shape:
        raise ValueError("paged_decode_attend: pool shape does not match q")
    if table.shape[0] != s or pos.shape != (s,):
        raise ValueError("paged_decode_attend: table/pos do not match q")
    if q.dtype not in _ENTRY or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_decode_attend kernel takes bf16 or f32 q/k/v of one dtype")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_decode_attend kernel takes int32 table and pos")
    if hd % (16 // q.element_size()) or hd > 1024 or g > MAX_G:
        raise ValueError(f"paged_decode_attend kernel: hd={hd}, G={g} unsupported "
                         f"(head_dim a whole number of 16-byte vectors, at most "
                         f"1024; G at most {MAX_G})")
    tensors = (q, k_pool, v_pool, table, pos)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attend kernel takes contiguous tensors on one device")
    out = torch.empty_like(q)
    if q.device.type == "cuda" and s * kv * g:
        # the kernel reads K and V rows 16 bytes at a time; a pool view that
        # starts off a 16-byte boundary is copied to one that does not
        k_pool, v_pool = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (k_pool, v_pool))
        nsplit = decode_splits(mb)
        part = torch.empty(decode_scratch_floats(s, kv, g, hd, nsplit),
                           dtype=torch.float32, device=q.device)
        KERNEL.launch(_ENTRY[q.dtype], q.device, q.data_ptr(), k_pool.data_ptr(),
                      v_pool.data_ptr(), table.data_ptr(), pos.data_ptr(),
                      part.data_ptr(), out.data_ptr(), s, kv, g, hd, bl, mb, nbp, nsplit,
                      1.0 / math.sqrt(hd))
    _record_cost(q, k_pool, v_pool, table, pos, out)
    return out


def _record_cost(q, k_pool, v_pool, table, pos, out) -> None:
    """Report one call's ``paged_decode_cost`` to the active tallies, if any."""
    if _cuda.TALLIES:
        s, kv, g, hd = q.shape
        cost = paged_decode_cost(s, kv, g, hd, table.shape[1], k_pool.shape[1],
                                 q.element_size())
        _cuda.record_cost(KERNEL.name, *cost, (q, k_pool, v_pool, table, pos), (out,))


def paged_decode_attend_kernel(q, k_pool, v_pool, table, pos):
    """The kernel route alone (the reference's Pallas route of the same
    name): ``paged_decode_attend`` on a CUDA or ``meta`` q; a CPU q, where
    no kernel runs, raises."""
    if q.device.type == "cpu":
        raise ValueError("paged_decode_attend_kernel: no kernel runs on the CPU "
                         "(paged_decode_attend runs the plain version there)")
    return paged_decode_attend(q, k_pool, v_pool, table, pos)


def paged_chunk_attend(q, k_pool, v_pool, table, q_pos):
    """Chunked-prefill paged attention: C queries per slot (plain torch).

    q: (S, C, KV, G, hd) post-rope; q_pos: (S, C) absolute positions. One
    mask covers cross-chunk history and in-chunk causality; promotion
    points follow the reference (scores in q's dtype then f32 softmax,
    weights cast to v's dtype). Returns (S, C, KV, G, hd).
    """
    bl = k_pool.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    k = gather_kv(k_pool, table)
    v = gather_kv(v_pool, table)
    sc = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    alloc = torch.repeat_interleave(table >= 0, bl, dim=1)  # (S, L)
    j = torch.arange(alloc.shape[1], device=table.device)
    valid = alloc[:, None, :] & (j[None, None, :] <= q_pos[:, :, None])
    sc = sc.masked_fill(~valid[:, None, None], NEG_INF)
    w = torch.softmax(sc, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bkgqh", w, v)
    return out.permute(0, 3, 1, 2, 4)  # (S, C, KV, G, hd)
