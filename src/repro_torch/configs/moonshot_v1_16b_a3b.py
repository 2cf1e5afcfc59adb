"""moonshot-v1-16b-a3b — Moonlight MoE, 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,  # per-expert FFN width
    vocab_size=163_840,
    num_experts=64,
    top_k=6,
)
