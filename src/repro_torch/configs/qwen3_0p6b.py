"""qwen3-0.6b — dense GQA with qk-norm [hf:Qwen/Qwen3-0.6B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
