"""The yardstick's arithmetic: published peaks, least times, and the work
of each measured kernel and step counted from the shapes of its call.

``bound_ms`` and the peaks are a frozen copy of ``chip_smoke.py``'s
(NVIDIA's data sheet, H100 SXM, dense rates, at its 700 W limit). Work is
counted as the algorithm needs it: every input byte read once, every
output byte written once, whatever a kernel reads again.
"""
from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """Least time for the work: max(bytes / HBM rate, ops / peak), in ms."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def share(bound: float, measured: float) -> float | None:
    """A roofline share in percent, or None when nothing was measured."""
    return None if not measured > 0 else 100.0 * bound / measured


def head_mix_work(nb: int, kb: int, batch: int, block_rows: int) -> tuple[float, float]:
    """B1 at the coded head, one decode step: the (nb, kb) generator times
    the (kb, batch * block_rows) logit blocks, float32, written (nb, ...)."""
    n = batch * block_rows
    return 2.0 * nb * kb * n, 4.0 * (nb * kb + kb * n + nb * n)


def packed_matvec_work(workers: int, max_load: int, d: int) -> tuple[float, float]:
    """B1's narrow branch on Path M: the packed (W, max_load, d) A~ read
    once, x read, the (W, max_load) products written, float32."""
    rows = workers * max_load
    return 2.0 * rows * d, 4.0 * (rows * d + d + rows)


def paged_decode_work(entries: int, slots: int, kv: int, g: int, hd: int,
                      itemsize: int) -> tuple[float, float]:
    """B2 for one layer of one decode step: ``entries`` valid KV entries
    over the slots (each slot's positions 0 .. pos), every valid K and V
    row read once, q read, the output written, the positions read."""
    flops = 4.0 * entries * kv * g * hd
    nbytes = itemsize * (2.0 * slots * kv * g * hd + 2.0 * entries * kv * hd) + 4.0 * slots
    return flops, nbytes


def dense_layer_params(d: int, heads: int, kv_heads: int, hd: int, d_ff: int) -> int:
    """Weights of one llama-style layer: q, k, v, o and the gated MLP."""
    return d * (heads * hd + 2 * kv_heads * hd) + heads * hd * d + 3 * d * d_ff


def token_flops(cfg: dict, context: int, *, decoded: bool) -> float:
    """Model FLOPs of one token at ``context`` visible positions: 2 x the
    layers' parameters, the attention over the context (scores and the
    weighted sum, 4 x context x heads x head_dim a layer), and for a
    decoded token the head's 2 V d. The coding's own work is not counted."""
    layers = cfg["num_hidden_layers"]
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim", d // heads)
    p = dense_layer_params(d, heads, cfg["num_key_value_heads"], hd, cfg["intermediate_size"])
    f = layers * (2.0 * p + 4.0 * context * heads * hd)
    if decoded:
        f += 2.0 * cfg["vocab_size"] * d
    return f
