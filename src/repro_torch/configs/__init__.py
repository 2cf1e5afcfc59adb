"""Architecture registry: ``--arch <id>`` -> ModelConfig (the reference's ten)."""
from __future__ import annotations

from repro_torch.configs.base import (
    ALL_SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    shapes_for,
)
from repro_torch.configs.granite_3_2b import CONFIG as GRANITE_3_2B
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.h2o_danube_3_4b import CONFIG as H2O_DANUBE_3_4B
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from repro_torch.configs.paligemma_3b import CONFIG as PALIGEMMA_3B
from repro_torch.configs.qwen3_0p6b import CONFIG as QWEN3_0P6B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.xlstm_125m import CONFIG as XLSTM_125M
from repro_torch.configs.yi_9b import CONFIG as YI_9B
from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA2_1P2B

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        ZAMBA2_1P2B,
        MOONSHOT_V1_16B_A3B,
        GROK_1_314B,
        XLSTM_125M,
        GRANITE_3_2B,
        QWEN3_0P6B,
        H2O_DANUBE_3_4B,
        YI_9B,
        PALIGEMMA_3B,
        WHISPER_TINY,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every (arch, shape) dry-run cell — 40 total."""
    for cfg in ARCHS.values():
        for shape in shapes_for(cfg):
            yield cfg, shape


__all__ = [
    "ALL_SHAPES",
    "ARCHS",
    "ModelConfig",
    "SHAPES_BY_NAME",
    "ShapeConfig",
    "all_cells",
    "get_arch",
    "shapes_for",
]
