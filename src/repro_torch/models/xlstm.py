"""xLSTM blocks (counterpart of ``repro/models/xlstm.py``): mLSTM and sLSTM.

mLSTM: per-head matrix memory C in R^{hd x hd} with exponential gating,
    C_t = f_t C_{t-1} + i_t v_t k_t^T,   n_t = f_t n_{t-1} + i_t k_t,
    h_t = (C_t q_t) / max(|n_t^T q_t|, exp(-m_t))
stabilised in log space (m_t tracks the running max exponent). sLSTM:
scalar memory with block-diagonal recurrent gate weights (H, hd, 4 hd).
Both scans run in float32 over time in a Python loop (the reference's
``lax.scan``); with a state, a call is one decode step (S = 1) that
returns the new state. Layer weights arrive as a dict of this layer's
tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal_init, rmsnorm

#: the cells' parameter names (the reference's ``blocks/<i>/cell/*``)
MLSTM_PARAMS = ("w_up", "wq", "wk", "wv", "w_if", "b_i", "b_f", "norm_scale", "w_down")
SLSTM_PARAMS = ("w_x", "w_h", "b", "norm_scale", "w_out")


def _dense(d_in, d_out, dtype, generator, device, scale=None):
    return normal_init((d_in, d_out), 1 / math.sqrt(d_in) if scale is None else scale,
                       dtype, generator=generator, device=device)


# ---------------------------------------------------------------- mLSTM
def init_mlstm(d_model: int, num_heads: int, dtype: torch.dtype,
               proj_factor: float = 2.0, *, generator=None, device=None) -> dict:
    d_in = int(d_model * proj_factor)
    kw = dict(generator=generator, device=device)
    return {
        "w_up": _dense(d_model, 2 * d_in, dtype, **kw),  # [x_in, z gate]
        "wq": _dense(d_in, d_in, dtype, **kw),
        "wk": _dense(d_in, d_in, dtype, **kw),
        "wv": _dense(d_in, d_in, dtype, **kw),
        "w_if": _dense(d_in, 2 * num_heads, torch.float32, scale=0.01, **kw),
        "b_i": torch.zeros(num_heads, device=device),
        "b_f": torch.linspace(3.0, 6.0, num_heads).to(device),
        "norm_scale": torch.ones(d_in, dtype=dtype, device=device),
        "w_down": _dense(d_in, d_model, dtype, **kw),
    }


def init_mlstm_state(batch: int, d_model: int, num_heads: int,
                     proj_factor: float = 2.0, *, device=None) -> dict:
    hd = int(d_model * proj_factor) // num_heads
    z = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, num_heads, hd, hd), **z),
            "n": torch.zeros((batch, num_heads, hd), **z),
            "m": torch.zeros((batch, num_heads), **z)}


def _mlstm_scan(q, k, v, log_i, log_f, c, n, m):
    """Sequential stabilised mLSTM, float32. q, k, v: (B, S, H, hd); gates
    (B, S, H). Returns (h (B, S, H, hd), (c, n, m))."""
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, li, lf = q[:, t], k[:, t], v[:, t], log_i[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        i_s = torch.exp(li - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s[..., None, None] * c + i_s[..., None, None] * (vt[..., :, None] * kt[..., None, :])
        n = f_s[..., None] * n + i_s[..., None] * kt
        num = torch.einsum("bhij,bhj->bhi", c, qt)
        den = torch.maximum(torch.einsum("bhj,bhj->bh", n, qt).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (c, n, m)


def mlstm(p: dict, x: torch.Tensor, *, num_heads: int, proj_factor: float = 2.0,
          state: dict | None = None):
    """x: (B, S, D) -> y; with ``state`` {"c", "n", "m"} (decode, S = 1)
    -> (y, new state)."""
    b, s, d_model = x.shape
    d_in = int(d_model * proj_factor)
    hd = d_in // num_heads
    x_in, z = torch.chunk(x @ p["w_up"].to(x.dtype), 2, dim=-1)
    q = (x_in @ p["wq"].to(x.dtype)).reshape(b, s, num_heads, hd)
    k = (x_in @ p["wk"].to(x.dtype)).reshape(b, s, num_heads, hd) / math.sqrt(hd)
    v = (x_in @ p["wv"].to(x.dtype)).reshape(b, s, num_heads, hd)
    gates = x_in.float() @ p["w_if"].float()
    log_i = F.logsigmoid(gates[..., :num_heads] + p["b_i"].float())
    log_f = F.logsigmoid(gates[..., num_heads:] + p["b_f"].float())
    st = state if state is not None else init_mlstm_state(b, d_model, num_heads,
                                                          proj_factor, device=x.device)
    h, (c, n, m) = _mlstm_scan(q.float(), k.float(), v.float(), log_i, log_f,
                               st["c"], st["n"], st["m"])
    h = rmsnorm(p["norm_scale"], h.reshape(b, s, d_in).to(x.dtype))
    out = (h * F.silu(z)) @ p["w_down"].to(x.dtype)
    if state is None:
        return out
    return out, {"c": c, "n": n, "m": m}


# ---------------------------------------------------------------- sLSTM
def init_slstm(d_model: int, num_heads: int, dtype: torch.dtype, *, generator=None,
               device=None) -> dict:
    hd = d_model // num_heads
    kw = dict(generator=generator, device=device)
    return {
        # input projections of the gates (i, f, z, o)
        "w_x": _dense(d_model, 4 * d_model, dtype, **kw),
        # recurrent, block-diagonal per head
        "w_h": normal_init((num_heads, hd, 4 * hd), 1 / math.sqrt(hd), dtype, **kw),
        "b": torch.cat([torch.zeros(d_model), torch.ones(d_model),  # forget bias > 0
                        torch.zeros(2 * d_model)]).to(device),
        "norm_scale": torch.ones(d_model, dtype=dtype, device=device),
        "w_out": _dense(d_model, d_model, dtype, **kw),
    }


def init_slstm_state(batch: int, d_model: int, num_heads: int, *, device=None) -> dict:
    shape = (batch, num_heads, d_model // num_heads)
    return {n: torch.zeros(shape, dtype=torch.float32, device=device)
            for n in ("c", "n", "m", "h")}


def slstm(p: dict, x: torch.Tensor, *, num_heads: int, state: dict | None = None):
    """x: (B, S, D) -> y; with ``state`` {"c", "n", "m", "h"} (decode,
    S = 1) -> (y, new state). The scan is float32."""
    b, s, d_model = x.shape
    hd = d_model // num_heads
    xg = (x @ p["w_x"].to(x.dtype)).float() + p["b"].float()
    xg = xg.reshape(b, s, 4, num_heads, hd)
    w_h = p["w_h"].float()
    st = state if state is not None else init_slstm_state(b, d_model, num_heads,
                                                          device=x.device)
    c, n, m, h = st["c"], st["n"], st["m"], st["h"]
    hs = []
    for t in range(s):
        rec = torch.einsum("bhi,hij->bhj", h, w_h)
        rec = rec.reshape(b, num_heads, 4, hd).permute(0, 2, 1, 3)
        gi, gf, gz, go = (xg[:, t, i] + rec[:, i] for i in range(4))
        m_new = torch.maximum(gf + m, gi)
        i_s = torch.exp(gi - m_new)
        f_s = torch.exp(gf + m - m_new)
        c = f_s * c + i_s * torch.tanh(gz)
        n = f_s * n + i_s
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, d_model).to(x.dtype)
    out = rmsnorm(p["norm_scale"], y) @ p["w_out"].to(x.dtype)
    if state is None:
        return out
    return out, {"c": c, "n": n, "m": m, "h": h}
