"""Synthetic training data (counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import SyntheticLMData, make_extras

__all__ = ["SyntheticLMData", "make_extras"]
