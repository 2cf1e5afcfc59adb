"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention [arXiv:2401.16818]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10_240,
    vocab_size=32_000,
    sliding_window=4096,  # rolling KV cache -> eligible for long_500k decode
)
