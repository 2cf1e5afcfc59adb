"""Synthetic training data (counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import SyntheticLMData, make_batch_specs, make_extras

__all__ = ["SyntheticLMData", "make_batch_specs", "make_extras"]
