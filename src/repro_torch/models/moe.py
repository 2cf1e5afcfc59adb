"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch
(counterpart of ``repro/models/moe.py``).

Tokens x slots are sorted (stably) by expert id and placed into an
(E, C) buffer with ``C = ceil(T K / E capacity_factor)``; entries past an
expert's capacity are dropped (their combine weight is zero) and go to a
trash row. With ``groups`` > 1 the T tokens are ``groups`` contiguous
pools of T / groups, each routed as the reference routes one call of its
own: ranked and capped within its pool at ``C = ceil((T / groups) K / E
capacity_factor)``, in its own C rows of each expert's buffer (the coded
training step routes each gradient partition so, as the reference's
vmap over the partitions does). The SwiGLU experts run as batched
products over (E, groups C, D), a
plain matrix product the reference computes outside any Pallas kernel,
and the outputs are combined back to their tokens with ``index_add_``,
weighted by the renormalised gates. Routing is in float32; the router
weight stays float32 whatever the parameter dtype.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal_init


def init_moe(layers: int, d_model: int, d_ff: int, num_experts: int, dtype: torch.dtype,
             *, generator: torch.Generator, device) -> dict:
    """``layers`` stacked MoE layers: ``w_router`` (L, D, E) float32 and the
    experts ``w_gate``, ``w_up`` (L, E, D, F) and ``w_down`` (L, E, F, D) in
    ``dtype``, each layer drawn as the reference's ``_dense_init`` (normal
    over the square root of its first dimension) into a stack allocated
    in its final dtype (``normal_init``)."""

    def normal(shape, dt):
        return normal_init((layers,) + shape, 1.0 / math.sqrt(shape[0]), dt,
                           generator=generator, device=device, stacked=True)

    return {"w_router": normal((d_model, num_experts), torch.float32),
            "w_gate": normal((num_experts, d_model, d_ff), dtype),
            "w_up": normal((num_experts, d_model, d_ff), dtype),
            "w_down": normal((num_experts, d_ff, d_model), dtype)}


@dataclasses.dataclass(frozen=True)
class Routing:
    """One routing of T tokens in ``groups`` pools: the (T, K) gates and
    experts, and the T*K entries in (pool, expert) order (``order`` into
    the flat (token, slot) entries) with their buffer ``slot`` (expert e,
    pool g, rank r at ``(e groups + g) cap + r``; ``E groups cap`` = the
    trash row) and ``keep`` flag. ``cap`` is one pool's capacity."""

    gates: torch.Tensor
    experts: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int
    groups: int = 1

    @property
    def rows(self) -> int:
        """Buffer rows of one expert: ``groups cap``."""
        return self.groups * self.cap


def route(w_router: torch.Tensor, xf: torch.Tensor, *, num_experts: int, top_k: int,
          capacity_factor: float = 1.25, groups: int = 1) -> Routing:
    """Top-k routing and capacity placement of xf (T, D), the reference's
    steps, in each of ``groups`` contiguous pools of T / groups tokens."""
    t, e, k = xf.shape[0], num_experts, top_k
    if t % groups:
        raise ValueError(f"{groups} routing groups do not divide {t} tokens")
    logits = xf.float() @ w_router.float()
    gate_vals, experts = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(gate_vals, dim=-1)  # renormalised over the selected
    cap = int(math.ceil(t // groups * k / e * capacity_factor))
    e_flat = experts.reshape(-1)
    # (pool, expert) as one key: pool-major, so one stable sort orders each
    # pool's entries by expert, ties in token order, as a call per pool would
    entry = torch.arange(t * k, device=xf.device)
    key = e_flat + e * torch.div(entry, t // groups * k, rounding_mode="floor")
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    start_of = torch.searchsorted(key_sorted, torch.arange(groups * e, device=xf.device,
                                                           dtype=key_sorted.dtype))
    rank = entry - start_of[key_sorted]
    keep = rank < cap
    e_sorted, g_sorted = key_sorted % e, torch.div(key_sorted, e, rounding_mode="floor")
    slot = torch.where(keep, (e_sorted * groups + g_sorted) * cap + rank,
                       torch.full_like(rank, e * groups * cap))
    return Routing(gates, experts, order, keep, slot, cap, groups)


def moe_ffn(p: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, groups: int = 1) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). ``p``: ``w_router``, ``w_gate``, ``w_up``,
    ``w_down`` as ``init_moe`` makes them (one layer). ``groups`` routing
    pools of B / groups rows each (``route``)."""
    b, s, d = x.shape
    t, e = b * s, num_experts
    xf = x.reshape(t, d)
    r = route(p["w_router"], xf, num_experts=e, top_k=top_k,
              capacity_factor=capacity_factor, groups=groups)
    tok_sorted = torch.div(r.order, top_k, rounding_mode="floor")
    gate_sorted = r.gates.reshape(-1)[r.order]
    n = e * r.rows

    # gather tokens into an (E groups cap + 1, D) buffer (last row: trash)
    buf = x.new_zeros((n + 1, d))
    buf[r.slot] = xf[tok_sorted]
    expert_in = buf[:n].reshape(e, r.rows, d)

    g = F.silu(torch.bmm(expert_in, p["w_gate"].to(x.dtype)))
    u = torch.bmm(expert_in, p["w_up"].to(x.dtype))
    h = torch.bmm(g * u, p["w_down"].to(x.dtype)).reshape(n, d)

    weight = torch.where(r.keep, gate_sorted, torch.zeros_like(gate_sorted)).to(x.dtype)
    vals = weight[:, None] * h[r.slot.clamp(max=n - 1)]
    vals = torch.where(r.keep[:, None], vals, torch.zeros_like(vals))
    out = x.new_zeros((t, d)).index_add_(0, tok_sorted, vals)
    return out.reshape(b, s, d)


def aux_load_balance_loss(p: dict, x: torch.Tensor, *, num_experts: int,
                          top_k: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E sum_e f_e p_e / K."""
    xf = x.reshape(-1, x.shape[-1])
    logits = xf.float() @ p["w_router"].float()
    probs = torch.softmax(logits, dim=-1)
    _, experts = torch.topk(logits, top_k, dim=-1)
    onehot = F.one_hot(experts, num_experts).float()
    frac = onehot.sum(1).mean(0)  # tokens per expert
    prob = probs.mean(0)
    return num_experts * torch.sum(frac * prob) / top_k
