"""Sharding rules: parameter, batch and cache specs, and their DTensor
placements (counterpart of ``repro/sharding``)."""
from repro_torch.sharding.rules import (
    batch_specs,
    cache_spec,
    distribute,
    make_batch_sharding,
    make_cache_sharding,
    make_param_sharding,
    param_spec,
    param_specs,
)

__all__ = [
    "batch_specs",
    "cache_spec",
    "distribute",
    "make_batch_sharding",
    "make_cache_sharding",
    "make_param_sharding",
    "param_spec",
    "param_specs",
]
