"""zamba2-1.2b — Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    mamba_expand=2,
    mamba_head_dim=64,
    attn_every=6,  # shared attn+MLP block invoked every 6 Mamba2 layers
)
