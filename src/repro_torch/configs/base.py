"""ModelConfig (the architecture fields the port's dense family reads) and
ShapeConfig (one batch shape).

Counterpart of ``repro/configs/base.py``. Only the dense-family fields
are carried; dtypes resolve to torch dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # the port implements "dense"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    logits_dtype: str = "float32"
    #: recompute each layer in the backward (``torch.utils.checkpoint``)
    remat: bool = True
    #: query / key block sizes of the training attention's online softmax
    attn_q_block: int = 512
    attn_kv_block: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def ldtype(self) -> torch.dtype:
        return DTYPES[self.logits_dtype]

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (the reference's sizes)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 1 else 1,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            param_dtype="float32",
            compute_dtype="float32",
            attn_q_block=32,
            attn_kv_block=32,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
