"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff = 0: xLSTM blocks carry their own up/down projections (proj_factor),
so there is no separate FFN sublayer. Every 6th layer is sLSTM (the
paper's sparse-sLSTM placements), the rest mLSTM.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=6,
    proj_factor=2.0,
)
