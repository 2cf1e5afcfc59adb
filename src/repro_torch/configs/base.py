"""ModelConfig (architecture) and ShapeConfig (one batch shape).

Counterpart of ``repro/configs/base.py``: every field of the reference's
``ModelConfig`` with its default, so a registered config and its
``reduced()`` variant equal the reference's field for field. Dtypes
resolve to torch dtypes. ``Model`` implements every family. The shape
cells (``TRAIN_4K`` ... ``LONG_500K``, ``shapes_for``) are the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qk_norm: bool = False
    #: attend to the last ``sliding_window`` positions only (rolling cache)
    sliding_window: int | None = None
    rope_theta: float = 10_000.0
    activation: str = "silu"
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    attn_every: int = 0  # hybrid: shared attn+mlp block every k mamba layers
    # --- xLSTM ---
    slstm_every: int = 0  # every k-th layer is sLSTM (others mLSTM)
    proj_factor: float = 2.0
    # --- enc-dec (audio) ---
    num_encoder_layers: int = 0
    encoder_seq: int = 0
    # --- vlm ---
    num_image_tokens: int = 0
    # --- numerics / execution ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = True
    #: recompute each layer in the backward (``torch.utils.checkpoint``)
    remat: bool = True
    #: the reference's scan over stacked layers; the port always loops
    scan_layers: bool = True
    logits_dtype: str = "float32"
    #: leave out key blocks wholly above the causal diagonal or outside the
    #: window in the training and prefill attention (same result)
    causal_block_skip: bool = False
    #: int8 KV cache with per-(token, head) float16 scales
    kv_quant: bool = False
    #: query / key block sizes of the training attention's online softmax
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    mamba_chunk: int = 256

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

    @property
    def sub_quadratic(self) -> bool:
        """O(1) or O(window) decode state (ssm, hybrid, sliding window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decode(self) -> bool:
        return True  # every registered config is decoder-bearing

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (the reference's sizes)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.attn_every == 0 else self.attn_every + 1),
            d_model=128,
            num_heads=max(4, min(self.num_heads, 4)),
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 1 else 1,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            num_experts=min(self.num_experts, 8),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            mamba_head_dim=32,
            sliding_window=64 if self.sliding_window else None,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq=32 if self.encoder_seq else 0,
            num_image_tokens=16 if self.num_image_tokens else 0,
            param_dtype="float32",
            compute_dtype="float32",
            attn_q_block=32,
            attn_kv_block=32,
            mamba_chunk=16,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(config: ModelConfig) -> tuple[ShapeConfig, ...]:
    """The shape cells defined for an architecture (the dry-run's cells).

    ``long_500k`` needs sub-quadratic attention: run for SSM/hybrid/SWA
    archs, skip for pure full-attention archs.
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if config.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)
