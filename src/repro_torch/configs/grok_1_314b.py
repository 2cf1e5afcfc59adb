"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32_768,  # per-expert FFN width
    vocab_size=131_072,
    num_experts=8,
    top_k=2,
    head_dim=128,
)
