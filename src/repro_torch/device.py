"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (the default everywhere) raises when no CUDA device is
    present: the port never falls back to the CPU on its own. Callers
    that want the CPU (the parity tests) pass ``device="cpu"``; the
    dry-run passes ``device="meta"`` (shapes only, no memory, no values).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch paths"
        )
    return dev
