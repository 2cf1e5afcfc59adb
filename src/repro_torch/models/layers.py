"""Shared layers on tensors (counterpart of ``repro/models/layers.py``).

Weights are stored in the parameter dtype and cast to the activation
dtype at use, exactly where the reference casts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal_init(shape: tuple, scale: float, dtype: torch.dtype, *, generator=None,
                device=None, stacked: bool = False) -> torch.Tensor:
    """A normal(0, scale^2) leaf in ``dtype``: a float32 draw scaled in place,
    then cast. ``stacked``: ``shape[0]`` layers, allocated in ``dtype`` and
    filled a layer at a time from a float32 draw of that layer, so the
    peak is the leaf plus one layer's draw, and a seed gives the same
    values in every dtype up to the cast."""
    if not stacked:
        return torch.randn(shape, generator=generator, device=device).mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type != "meta":  # a meta model holds shapes only
        for layer in out:
            layer.copy_(torch.randn(shape[1:], generator=generator, device=device).mul_(scale))
    return out


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (population variance), then
    scale and bias, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def mlp(w_gate: torch.Tensor | None, w_up: torch.Tensor, w_down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """The reference's two MLP forms, in x's dtype: SwiGLU, (silu(x W_g) *
    x W_u) W_d, when there is a gate (``activation == "silu"``); else the
    plain GELU MLP gelu(x W_u) W_d with ``jax.nn.gelu``'s default tanh
    approximation."""
    if w_gate is None:
        return F.gelu(x @ w_up.to(x.dtype), approximate="tanh") @ w_down.to(x.dtype)
    g = F.silu(x @ w_gate.to(x.dtype))
    return (g * (x @ w_up.to(x.dtype))) @ w_down.to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)


def unembed(table: torch.Tensor, x: torch.Tensor,
            logit_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Tied LM head ``x @ table^T`` with float32 accumulation.

    The reference contracts in x's dtype with ``preferred_element_type=f32``.
    ``torch.matmul`` on bf16 would round the product to bf16, so both
    operands are first rounded to x's dtype (as the reference rounds the
    table) and then multiplied in float32.
    """
    return torch.matmul(x.float(), table.to(x.dtype).float().T).to(logit_dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0
         ) -> torch.Tensor:
    """Rotary embeddings, half-split layout. x: (..., S, H, hd); positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def ce_from_lse(lse: torch.Tensor, ll: torch.Tensor, mask: torch.Tensor | None = None,
                z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean ``lse - ll + z_loss lse^2`` over ``mask``, along the last axis.

    Per-token f32 inputs (..., T) -> (...); a leading axis gives one loss
    per partition.
    """
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse**2
    if mask is None:
        return nll.mean(-1)
    mask = mask.float()
    return (nll * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None, z_loss: float = 1e-4
                       ) -> torch.Tensor:
    """Token-mean cross entropy with z-loss over materialized logits.

    The oracle of the fused path: lse and the label logit in f32 from
    (..., V) logits, then ``ce_from_lse``.
    """
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0].float()
    return ce_from_lse(lse.reshape(-1), ll.reshape(-1),
                       None if mask is None else mask.reshape(-1), z_loss)
