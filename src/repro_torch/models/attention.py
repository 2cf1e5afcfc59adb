"""Paged GQA attention (counterpart of ``repro/models/attention.py``).

Only the paged paths of the serving slice: ``decode_attention_paged``
(one query per slot, the B2 kernel on the card) and
``prefill_attention_paged`` (a chunk of C queries per slot). Layer
weights arrive as a dict of this layer's tensors (``wq``, ``wk``, ``wv``,
``wo`` and optionally ``q_norm``/``k_norm``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.layers import rope


def _qkv(p: dict, x: torch.Tensor, num_heads: int, num_kv_heads: int,
         head_dim: int):
    b, s, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, num_heads, head_dim)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, num_kv_heads, head_dim)
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
