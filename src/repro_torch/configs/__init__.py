"""Architecture registry: arch id -> ModelConfig (the port's dense slice)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.qwen3_0p6b import CONFIG as QWEN3_0P6B

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (QWEN3_0P6B,)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_arch"]
