"""GQA attention (counterpart of ``repro/models/attention.py``).

The paged serving paths, ``decode_attention_paged`` (one query per slot,
the B2 kernel on the card) and ``prefill_attention_paged`` (a chunk of C
queries per slot); the training and prefill path, ``attention`` over
``chunked_attention`` (causal, flash-style online softmax over key
blocks, an optional sliding window, and ``causal_skip``: key blocks
wholly above the diagonal or outside the window left out; ``return_kv``
hands back the post-rope K/V a batched prefill splices into a dense
cache); and the dense-cache decode paths, ``decode_attention`` (one
position for the whole batch; a rolling cache for sliding-window models
and an int8 cache with per-(token, head) float16 scales) and
``decode_attention_slots`` (a position per row). ``attention`` also
takes cross attention (K and V from ``xkv`` at ``kv_positions``) and
``use_rope=False``, as ``decode_attention`` does (whisper's encoder and
decoder). The reference computes
all but the paged decode attend in jnp outside any Pallas kernel, so
they are plain torch here. The dense caches (``init_attn_cache``) are
updated in place. Layer weights arrive as a dict of this layer's tensors
(``wq``, ``wk``, ``wv``, ``wo`` and optionally ``q_norm``/``k_norm``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.layers import rope

NEG_INF = -1e30


def _qkv(p: dict, x: torch.Tensor, num_heads: int, num_kv_heads: int,
         head_dim: int, xkv: torch.Tensor | None = None):
    """Q from x; K and V from ``xkv`` (cross attention), else from x."""
    xkv = x if xkv is None else xkv
    b, s, _ = x.shape
    skv = xkv.shape[1]
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, num_heads, head_dim)
    k = (xkv @ p["wk"].to(x.dtype)).reshape(b, skv, num_kv_heads, head_dim)
    v = (xkv @ p["wv"].to(x.dtype)).reshape(b, skv, num_kv_heads, head_dim)
    return q, k, v


def _maybe_qk_norm(p: dict, q: torch.Tensor, k: torch.Tensor, eps: float = 1e-6):
    if "q_norm" not in p:
        return q, k

    def rn(t, scale):
        t32 = t.float()
        var = torch.mean(t32 * t32, dim=-1, keepdim=True)
        return (t32 * torch.rsqrt(var + eps) * scale.float()).to(t.dtype)

    return rn(q, p["q_norm"]), rn(k, p["k_norm"])


def decode_attention_paged(p: dict, x, k_pool, v_pool, table, pos, active, *,
                           num_heads, num_kv_heads, head_dim,
                           rope_theta=10_000.0):
    """Per-slot decode against a shared KV block pool.

    x: (S, 1, D); pools: (NB+1, BL, KV, hd), updated in place (inactive
    rows write the sink); table: (S, MB) int32; pos: (S,) int32 write
    positions; active: (S,) bool. Returns y (S, 1, D).
    """
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, num_heads, num_kv_heads, head_dim)
    q, k_new = _maybe_qk_norm(p, q, k_new)
    pp = pos[:, None]
    q = rope(q, pp, rope_theta)
    k_new = rope(k_new, pp, rope_theta)
    paged_ops.scatter_decode(k_pool, v_pool, k_new[:, 0], v_new[:, 0], table,
                             pos, active)
    qr = q.reshape(b, num_kv_heads, num_heads // num_kv_heads, head_dim)
    out = paged_ops.paged_decode_attend(qr.contiguous(), k_pool, v_pool,
                                        table, pos)
    out = out.reshape(b, 1, num_heads * head_dim)
    return out @ p["wo"].to(x.dtype)


def prefill_attention_paged(p: dict, x, k_pool, v_pool, table, start,
                            chunk_len, *, num_heads, num_kv_heads, head_dim,
                            rope_theta=10_000.0):
    """One chunked-prefill pass of C prompt tokens per slot into the pool.

    x: (S, C, D); chunk row ``i`` of slot ``s`` sits at absolute position
    ``start[s] + i`` (rows past ``chunk_len[s]`` are padding: their KV
    goes to the sink). KV is scattered first, then every query attends
    the slot's gathered history up to itself. Returns y (S, C, D).
    """
    b, c = x.shape[:2]
    q, k_new, v_new = _qkv(p, x, num_heads, num_kv_heads, head_dim)
    q, k_new = _maybe_qk_norm(p, q, k_new)
    pp = start[:, None] + torch.arange(c, dtype=start.dtype, device=x.device)[None, :]
    q = rope(q, pp, rope_theta)
    k_new = rope(k_new, pp, rope_theta)
    paged_ops.scatter_chunk(k_pool, v_pool, k_new, v_new, table, start, chunk_len)
    qr = q.reshape(b, c, num_kv_heads, num_heads // num_kv_heads, head_dim)
    out = paged_ops.paged_chunk_attend(qr, k_pool, v_pool, table, pp)
    out = out.reshape(b, c, num_heads * head_dim).to(x.dtype)
    return out @ p["wo"].to(x.dtype)


def needed_blocks(q_pos, kv_pos, *, causal=True, window=None) -> list:
    """(nq, nk) nested list: may key block j hold a key query block i sees?

    q_pos: (nq, qb), kv_pos: (nk, kb) host integer arrays of positions
    (kv_pos < 0: a padded key). A block is left out when all of it lies
    above the causal diagonal or outside the window, the reference's
    ``causal_skip`` rule.
    """
    q_pos, kv_pos = np.asarray(q_pos), np.asarray(kv_pos)
    need = np.ones((q_pos.shape[0], kv_pos.shape[0]), bool)
    if causal:
        need &= kv_pos.min(1)[None, :] <= q_pos.max(1)[:, None]
    if window is not None:
        need &= kv_pos.max(1)[None, :] >= q_pos.min(1)[:, None] - window + 1
    return need.tolist()


def chunked_attention(q, k, v, q_pos, kv_pos, *, num_heads, num_kv_heads, head_dim,
                      causal=True, window=None, q_block=512, kv_block=1024,
                      causal_skip=False, host_pos=None):
    """Flash-style attention. q: (B, S, H, hd); k, v: (B, Skv, KV, hd).

    q_pos: (S,), kv_pos: (Skv,) absolute positions (kv_pos < 0 marks a
    padded key). Blocks must divide S and Skv. Scores are taken in q's
    dtype and then f32, the weights cast to v's dtype for the P V
    product, as the reference promotes. ``window``: a query sees keys
    with ``q_pos - kv_pos < window``. ``causal_skip`` leaves out key
    blocks no query of a block can see (``needed_blocks``); the result
    equals the unskipped one. The decision reads the positions once per
    call, from ``host_pos`` (host copies of ``(q_pos, kv_pos)``) when the
    caller has them, else by one device-to-host copy. Returns (B, S, H, hd).
    """
    b, s = q.shape[:2]
    skv = k.shape[1]
    g = num_heads // num_kv_heads
    scale = 1.0 / math.sqrt(head_dim)
    qb, kb = min(q_block, s), min(kv_block, skv)
    if s % qb or skv % kb:
        raise ValueError(f"blocks ({qb}, {kb}) must divide ({s}, {skv})")
    qr = q.reshape(b, s // qb, qb, num_kv_heads, g, head_dim)
    kr = k.reshape(b, skv // kb, kb, num_kv_heads, head_dim)
    vr = v.reshape(b, skv // kb, kb, num_kv_heads, head_dim)
    qp = q_pos.reshape(-1, qb)
    kp = kv_pos.reshape(-1, kb)
    needed = None
    if causal_skip:
        if host_pos is None:
            both = torch.cat([q_pos, kv_pos]).cpu().numpy()
            host_pos = both[:s], both[s:]
        needed = needed_blocks(np.asarray(host_pos[0]).reshape(-1, qb),
                               np.asarray(host_pos[1]).reshape(-1, kb),
                               causal=causal, window=window)
    outs = []
    for qi in range(s // qb):
        m = torch.full((b, num_kv_heads, g, qb), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, num_kv_heads, g, qb, head_dim), dtype=torch.float32,
                          device=q.device)
        for kj in range(skv // kb):
            if needed is not None and not needed[qi][kj]:
                continue
            sc = (torch.einsum("bqkgh,bskh->bkgqs", qr[:, qi], kr[:, kj]) * scale).float()
            mask = (kp[kj][None, :] >= 0).expand(qb, kb)
            if causal:
                mask = mask & (qp[qi][:, None] >= kp[kj][None, :])
            if window is not None:
                mask = mask & (qp[qi][:, None] - kp[kj][None, :] < window)
            sc = sc.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype), vr[:, kj]).float()
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qb, num_heads, head_dim)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def attention(p: dict, x, positions, *, num_heads, num_kv_heads, head_dim,
              causal=True, window=None, use_rope=True, rope_theta=10_000.0,
              xkv=None, kv_positions=None, q_block=512, kv_block=1024,
              causal_skip=False, host_positions=None, return_kv=False):
    """Full attention layer (train/prefill path). x: (B, S, D); positions: (S,).

    ``xkv`` (B, Skv, D): cross attention, K and V from it at
    ``kv_positions`` (Skv,) (default: self attention at ``positions``).
    ``use_rope=False`` leaves Q and K unrotated. Sequences that do not
    divide the blocks are padded: queries with continuation positions
    (sliced back), keys with position -1 (masked). ``window`` and
    ``causal_skip`` as in ``chunked_attention``; ``host_positions`` is a
    host copy of ``positions`` (a caller that knows them, such as a
    forward over ``arange``, saves the skip decision its device read).
    Returns y (B, S, D); with ``return_kv`` also the post-rope (B, Skv,
    KV, hd) keys and values, what ``decode_attention`` would have written
    into its cache one position at a time.
    """
    b, s = x.shape[:2]
    q, k, v = _qkv(p, x, num_heads, num_kv_heads, head_dim, xkv)
    q, k = _maybe_qk_norm(p, q, k)
    skv = k.shape[1]
    host = None if host_positions is None else np.asarray(host_positions)
    host_kv = host
    if kv_positions is None:
        kv_positions = positions
    else:
        host_kv = None  # the skip decision reads these from the device
    if use_rope:
        q = rope(q, positions[None, :].expand(b, s), rope_theta)
        k = rope(k, kv_positions[None, :].expand(b, skv), rope_theta)
    k_cache, v_cache = k, v  # before padding: the decode cache's payload
    qb, kb = min(q_block, s), min(kv_block, skv)
    pad_q, pad_k = (-s) % qb, (-skv) % kb
    q_pos, kv_pos = positions, kv_positions
    host_q, host_k = host, host_kv
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.cat([positions, positions[-1] + 1 + torch.arange(
            pad_q, dtype=positions.dtype, device=x.device)])
        if host is not None:
            host_q = np.concatenate([host, host[-1] + 1 + np.arange(pad_q)])
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_pos = torch.cat([kv_positions, torch.full(
            (pad_k,), -1, dtype=kv_positions.dtype, device=x.device)])
        if host_kv is not None:
            host_k = np.concatenate([host_kv, np.full(pad_k, -1)])
    both = host_q is not None and host_k is not None
    out = chunked_attention(q, k, v, q_pos, kv_pos, num_heads=num_heads,
                            num_kv_heads=num_kv_heads, head_dim=head_dim,
                            causal=causal, window=window, q_block=qb, kv_block=kb,
                            causal_skip=causal_skip,
                            host_pos=(host_q, host_k) if both else None)[:, :s]
    y = out.reshape(b, s, num_heads * head_dim) @ p["wo"].to(x.dtype)
    if return_kv:
        return y, k_cache, v_cache
    return y


def init_attn_cache(batch: int, cache_len: int, num_kv_heads: int, head_dim: int,
                    dtype: torch.dtype, device, quantized: bool = False) -> dict:
    """Dense KV cache: ``k``, ``v`` (B, S, KV, hd) and ``pos`` (S,) int32,
    the absolute position each entry holds (-1 = empty). ``cache_len`` is
    the context, or the window of a sliding-window model (a rolling
    cache). ``quantized``: int8 ``k``/``v`` with float16 ``k_scale`` /
    ``v_scale`` (B, S, KV), one scale per (token, head)."""
    shape = (batch, cache_len, num_kv_heads, head_dim)
    pos = torch.full((cache_len,), -1, dtype=torch.int32, device=device)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float16, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float16, device=device),
                "pos": pos}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": pos}


def _quantize_kv(t: torch.Tensor):
    """(B, 1, KV, hd) -> int8 values and (B, 1, KV) float16 scales.

    Symmetric per (token, head): scale = max(amax / 127, 1e-8), values
    round(t / scale) (half to even, as ``jnp.round``) clipped to +-127.
    """
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def _attend_cache(p: dict, q, k, v, valid, num_heads, num_kv_heads, head_dim):
    """One query per row over a dense cache. q: (B, 1, H, hd); k, v: (B, S,
    KV, hd); valid: (B, S). Scores in q's dtype then f32, masked entries
    at -1e30, the softmax weights cast to v's dtype, as the reference."""
    b = q.shape[0]
    qr = q.reshape(b, num_kv_heads, num_heads // num_kv_heads, head_dim)
    sc = torch.einsum("bkgh,bskh->bkgs", qr, k).float() * (1.0 / math.sqrt(head_dim))
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(sc, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", w, v).reshape(b, 1, num_heads * head_dim)
    return out @ p["wo"].to(q.dtype)


def _project_rope(p: dict, x, positions, num_heads, num_kv_heads, head_dim, rope_theta,
                  use_rope=True):
    """q, k, v of one new token per row, rope'd at ``positions`` (B, 1)
    unless ``use_rope`` is False."""
    q, k_new, v_new = _qkv(p, x, num_heads, num_kv_heads, head_dim)
    q, k_new = _maybe_qk_norm(p, q, k_new)
    if not use_rope:
        return q, k_new, v_new
    return rope(q, positions, rope_theta), rope(k_new, positions, rope_theta), v_new


def decode_attention(p: dict, x, cache: dict, pos: int, *, num_heads, num_kv_heads,
                     head_dim, window=None, use_rope=True, rope_theta=10_000.0):
    """Single-token decode at one position for the whole batch, in place.

    x: (B, 1, D); cache: ``init_attn_cache``'s (this layer's views);
    pos: int. Writes the new K/V and ``pos`` at entry ``pos % S`` (rolling
    when the cache is shorter than the context), then attends every entry
    holding a position in [0, pos] (and, with ``window``, within the last
    ``window`` positions). An int8 cache stores the quantized K/V and
    their scales and attends the whole cache dequantized in x's dtype.
    ``use_rope=False``: Q and K unrotated (whisper's decoder). Returns y
    (B, 1, D).
    """
    b = x.shape[0]
    pp = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_rope(p, x, pp, num_heads, num_kv_heads, head_dim,
                                    rope_theta, use_rope)
    slot = pos % cache["k"].shape[1]
    if "k_scale" in cache:
        for name, t in (("k", k_new), ("v", v_new)):
            vals, scales = _quantize_kv(t)
            cache[name][:, slot] = vals[:, 0]
            cache[f"{name}_scale"][:, slot] = scales[:, 0]
        k = cache["k"].to(x.dtype) * cache["k_scale"][..., None].to(x.dtype)
        v = cache["v"].to(x.dtype) * cache["v_scale"][..., None].to(x.dtype)
    else:
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
    cache["pos"][slot].fill_(pos)
    valid = (cache["pos"] >= 0) & (cache["pos"] <= pos)
    if window is not None:
        valid = valid & (pos - cache["pos"] < window)
    return _attend_cache(p, q, k, v, valid[None, :].expand(b, -1),
                         num_heads, num_kv_heads, head_dim)


def decode_attention_slots(p: dict, x, cache: dict, pos_map, pos, slot, *, num_heads,
                           num_kv_heads, head_dim, rope_theta=10_000.0):
    """Per-slot decode: every row at its own position, in place.

    x: (B, 1, D); cache: ``{"k", "v"}`` (B, S, KV, hd) of this layer;
    pos_map: (B, S) the position each entry holds after this step's write
    (-1 = empty; one map shared by every layer); pos: (B,) int32 write
    positions; slot: (B,) the entries to write (``pos % S``). Returns y.
    """
    b = x.shape[0]
    q, k_new, v_new = _project_rope(p, x, pos[:, None], num_heads, num_kv_heads,
                                    head_dim, rope_theta)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    valid = (pos_map >= 0) & (pos_map <= pos[:, None])
    return _attend_cache(p, q, cache["k"], cache["v"], valid, num_heads, num_kv_heads,
                         head_dim)
