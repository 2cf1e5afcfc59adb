"""Mamba2 (SSD) block (counterpart of ``repro/models/ssm.py``).

Per head h with state size N and head dim P,
    S_t = exp(dt_t A_h) S_{t-1} + dt_t B_t x_t^T        (S in R^{N x P})
    y_t = C_t^T S_t + D_h x_t
computed as the reference does: over a sequence, the SSD block
decomposition (a quadratic intra-chunk term and a recurrence over chunk
states, a Python loop where the reference has ``lax.scan``); in decode,
one state update per token. The scan and its state are float32 (``dt``
float32 after ``softplus``), the conv history is in the compute dtype,
and a gated RMSNorm (``norm_scale``) precedes ``w_out``, all as the
reference. Layer weights arrive as a dict of this layer's tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal_init, rmsnorm

CONV_K = 4  # causal depthwise conv kernel size

#: the mamba2 block's parameter names (the reference's ``blocks/mamba/*``)
MAMBA_PARAMS = ("w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
                "norm_scale", "w_out")


def dims(d_model: int, d_state: int, expand: int = 2, head_dim: int = 64):
    """(d_inner, n_heads, conv_dim) of a mamba2 block."""
    d_inner = expand * d_model
    return d_inner, d_inner // head_dim, d_inner + 2 * d_state


def init_mamba2(layers: int, d_model: int, d_state: int, dtype: torch.dtype, *,
                expand: int = 2, head_dim: int = 64, generator=None, device=None
                ) -> dict:
    """Stacked (``layers`` leading) parameters with the reference's shapes,
    dtypes and constants; the random ones drawn from ``generator`` a layer
    at a time into stacks in their final dtype (``normal_init``)."""
    d_inner, n_heads, conv_dim = dims(d_model, d_state, expand, head_dim)

    def normal(shape, scale):
        return normal_init((layers, *shape), scale, dtype, generator=generator,
                           device=device, stacked=True)

    def const(row: torch.Tensor) -> torch.Tensor:  # float32, as the reference
        return row.to(device).repeat(layers, 1)

    return {
        # fused in_proj: [z, x, B, C, dt]
        "w_in": normal((d_model, 2 * d_inner + 2 * d_state + n_heads),
                       1 / math.sqrt(d_model)),
        "conv_w": normal((CONV_K, conv_dim), 0.1),
        "conv_b": torch.zeros((layers, conv_dim), dtype=dtype, device=device),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, n_heads))),
        "dt_bias": const(torch.full((n_heads,), math.log(math.expm1(0.01)))),
        "d_skip": const(torch.ones(n_heads)),
        "norm_scale": torch.ones((layers, d_inner), dtype=dtype, device=device),
        "w_out": normal((d_inner, d_model), 1 / math.sqrt(d_inner)),
    }


def init_mamba2_state(batch: int, d_model: int, d_state: int, dtype: torch.dtype, *,
                      expand: int = 2, head_dim: int = 64, device=None) -> dict:
    """Decode state: ``ssm`` (B, H, N, P) float32, ``conv`` (B, CONV_K - 1,
    conv_dim) in the compute dtype."""
    _, n_heads, conv_dim = dims(d_model, d_state, expand, head_dim)
    return {"ssm": torch.zeros((batch, n_heads, d_state, head_dim), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, CONV_K - 1, conv_dim), dtype=dtype, device=device)}


def _split_in(p: dict, x: torch.Tensor, d_state: int, d_inner: int):
    """The fused in-projection split into (z, x, B, C, dt), in x's dtype."""
    zxbcdt = x @ p["w_in"].to(x.dtype)
    return torch.split(zxbcdt, [d_inner, d_inner, d_state, d_state,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * d_state], dim=-1)


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv over time, then silu. xbc: (B, S, C).

    With ``conv_state`` (decode: the (B, CONV_K - 1, C) history) returns
    (y, the new history); else (y, None) over a zero-padded sequence.
    """
    w = conv_w.to(xbc.dtype)
    b = conv_b.to(xbc.dtype)
    if conv_state is not None:
        window = torch.cat([conv_state, xbc], dim=1)  # (B, K, C)
        y = torch.einsum("bkc,kc->bc", window, w)[:, None]
        return F.silu(y + b), window[:, 1:]
    s = xbc.shape[1]
    xp = F.pad(xbc, (0, 0, CONV_K - 1, 0))
    views = torch.stack([xp[:, i: i + s] for i in range(CONV_K)], dim=2)  # (B, S, K, C)
    y = torch.einsum("bskc,kc->bsc", views, w)
    return F.silu(y + b), None


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < t <= i} a_t below the diagonal, -inf above.

    The upper triangle is filled before any ``exp``, so the caller's
    ``exp`` gives exact zeros there and no NaN reaches a value or a
    gradient.
    """
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def mamba2(p: dict, x: torch.Tensor, *, d_state: int, expand: int = 2,
           head_dim: int = 64, chunk: int = 256, state: dict | None = None):
    """x: (B, S, D). With ``state`` (decode; S must be 1) returns (y, new
    state) and leaves ``state`` untouched; else y, by the chunked SSD
    (S a multiple of ``min(chunk, S)``).

    state = {"ssm": (B, H, N, P) float32, "conv": (B, CONV_K - 1, conv_dim)}.
    """
    b, s, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    z, xs, bmat, cmat, dt = _split_in(p, x, d_state, d_inner)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    a = -torch.exp(p["a_log"].float())  # (H,) negative
    conv_out, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                      None if state is None else state["conv"])
    xs, bmat, cmat = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)
    xh = xs.reshape(b, s, n_heads, head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B, S, H)
    d_skip = p["d_skip"].float()

    if state is not None:
        # one step: S' = exp(dt a) S + dt B x^T ; y = C S' + D x
        x0 = xh[:, 0].float()
        da = torch.exp(dt[:, 0] * a)  # (B, H)
        dbx = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], bmat[:, 0].float(), x0)
        ssm_new = da[..., None, None] * state["ssm"] + dbx
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), ssm_new)
        y = (y + d_skip[None, :, None] * x0).reshape(b, 1, d_inner).to(x.dtype)
        y = rmsnorm(p["norm_scale"], y * F.silu(z))
        return y @ p["w_out"].to(x.dtype), {"ssm": ssm_new, "conv": new_conv}

    # ---- chunked SSD (train / prefill) ----
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nc = s // q
    xh = xh.reshape(b, nc, q, n_heads, head_dim)
    bm = bmat.reshape(b, nc, q, d_state).float()
    cm = cmat.reshape(b, nc, q, d_state).float()
    dtc = dt.reshape(b, nc, q, n_heads)
    ac = dtc * a  # (B, NC, Q, H) log-decay increments
    ac_cum = torch.cumsum(ac, dim=2)  # within-chunk cumulative
    xdt = xh.float() * dtc[..., None]  # dt-weighted inputs

    # intra-chunk: the attention-like quadratic term
    lmat = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # (B, NC, H, Q, Q)
    scores = torch.einsum("bcin,bcjn->bcij", cm, bm)  # (B, NC, Q, Q)
    y_intra = torch.einsum("bchij,bcij,bcjhp->bcihp", lmat, scores, xdt)
    # chunk states: S_c = sum_j exp(a_end - a_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(ac_cum[:, :, -1:, :] - ac_cum)  # (B, NC, Q, H)
    s_local = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_to_end, bm, xdt)

    # inter-chunk recurrence over the chunk index: the state entering each chunk
    chunk_decay = torch.exp(ac_cum[:, :, -1, :])  # (B, NC, H)
    carry = torch.zeros((b, n_heads, d_state, head_dim), dtype=torch.float32,
                        device=x.device)
    prevs = []
    for ci in range(nc):
        prevs.append(carry)
        carry = chunk_decay[:, ci, :, None, None] * carry + s_local[:, ci]
    s_prevs = torch.stack(prevs, dim=1)  # (B, NC, H, N, P)

    # inter-chunk contribution: C_i exp(cum_a_i) S_{c-1}
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", cm, torch.exp(ac_cum), s_prevs)
    y = y_intra + y_inter + d_skip[None, None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rmsnorm(p["norm_scale"], y * F.silu(z))
    return y @ p["w_out"].to(x.dtype)
