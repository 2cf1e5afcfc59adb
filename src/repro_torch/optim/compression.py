"""Gradient compression for a cross-node reduction.

Counterpart of ``repro/optim/compression.py``, over dicts of tensors.
bf16 compression with error feedback: the quantization residual is
carried to the next step so the compressed SGD direction is unbiased in
the long run (EF-SGD). Meant for the scarce link only (the reduction
between nodes); a reduction inside a node stays full precision.
"""
from __future__ import annotations

import torch


def init_error_feedback(params: dict) -> dict:
    """A float32 zero residual per parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_bf16_ef(grads: dict, ef: dict) -> tuple[dict, dict]:
    """(grads, ef) -> (compressed bf16 grads, new ef residuals)."""
    comp, new_ef = {}, {}
    for k, g in grads.items():
        corrected = g.float() + ef[k]
        q = corrected.to(torch.bfloat16)
        comp[k], new_ef[k] = q, corrected - q.float()
    return comp, new_ef


def decompress_bf16_ef(comp: dict) -> dict:
    return {k: g.float() for k, g in comp.items()}
