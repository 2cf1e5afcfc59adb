"""whisper-tiny — enc-dec audio [arXiv:2212.04356].

The reference stubs the conv frontend with precomputed frame embeddings
(B, 1500, d_model). 4 encoder + 4 decoder layers, LayerNorm + GELU,
sinusoidal positions in the encoder (no RoPE; the decoder has no
positional signal, as the reference's).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    activation="gelu",
    num_encoder_layers=4,
    encoder_seq=1500,
)
