"""PyTorch/CUDA port of the coded-computation serving stack.

Mirrors ``repro``'s module tree (``repro_torch/core/coding.py`` is the
counterpart of ``repro/core/coding.py``, and so on). The port imports
``torch``, numpy and scipy only. Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``; nothing falls back to the
CPU on its own (``repro_torch.device.resolve_device``).

The three TPU kernels on the serving path are CUDA C++ for Hopper under
``repro_torch/kernels``: each wrapper launches its kernel on a CUDA
tensor and runs the plain PyTorch version kept beside it on a CPU tensor.
"""
import os

# The serving path replays CUDA graphs. A graph that outlives a
# torch.profiler session whose end tore CUPTI down can crash the process
# when a later session replays it, so CUPTI stays up across sessions. The
# setting holds only if made before the process's first profiler session.
os.environ.setdefault("TEARDOWN_CUPTI", "0")
