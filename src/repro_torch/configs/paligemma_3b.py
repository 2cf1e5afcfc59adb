"""paligemma-3b — SigLIP + Gemma decoder [arXiv:2407.07726].

The reference stubs the SigLIP vision tower with precomputed patch
embeddings (B, 256, d_model); the decoder is the Gemma-style transformer
below (MQA: kv=1), with the plain GELU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16_384,
    vocab_size=257_216,
    head_dim=256,
    activation="gelu",
    num_image_tokens=256,
)
