"""AdamW + warmup-cosine schedule + global-norm clipping on dicts of tensors.

Counterpart of ``repro/optim/adamw.py``: functions on a ``{name: tensor}``
dict (not ``torch.optim.AdamW``), so the step is the reference's
arithmetic, term for term. The optimizer state is ``{"m": {...},
"v": {...}, "count": int32 tensor}``. ``adamw_update`` writes the new
values into the parameters and the state's ``m`` and ``v``, leaf by leaf,
so an update holds one leaf's temporaries beside the state instead of a
second copy of the parameters and both moments (granite-3-2b: 30 GB);
the reference returns new arrays. A caller that must keep the old state
does not call it: the coded trainer's skip step keeps it bit for bit so.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"  # "bfloat16" for memory-bound archs


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine to ``min_lr_ratio * lr``; f32 tensor."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(cfg: AdamWConfig, params: dict) -> dict:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, opt_state: dict, params: dict):
    """One AdamW step, in place. Returns (params, new_opt_state, metrics):
    ``params``' tensors and the state's ``m`` and ``v`` hold the new
    values; ``count`` is a new tensor.

    Weight decay applies where ``p.ndim >= 2``, as the reference's; the
    port's stacked layer shapes equal the reference's, so the stacked
    norm scales (L, d) are decayed in both.
    """
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = cosine_schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** count.float()
    bc2 = 1 - b2 ** count.float()
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        m, v = opt_state["m"][n], opt_state["v"][n]
        g32 = grads[n].float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * p.float()
        new_p[n] = p.copy_(p.float() - lr * step)
        new_m[n], new_v[n] = m.copy_(m32), v.copy_(v32)
    return new_p, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gnorm, "lr": lr}
