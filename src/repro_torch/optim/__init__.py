"""Optimizers on dicts of tensors (counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.compression import (
    compress_bf16_ef,
    decompress_bf16_ef,
    init_error_feedback,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compress_bf16_ef",
           "cosine_schedule", "decompress_bf16_ef", "global_norm", "init_error_feedback"]
