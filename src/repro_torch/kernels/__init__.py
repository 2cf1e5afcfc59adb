"""Hand-written CUDA kernels for Hopper, one family per TPU kernel.

* ``coded_matvec``    — B1, ``Y = G X`` block mix of the coded LM head;
* ``paged_attention`` — B2, single-query decode attend over the KV pool;
* ``mds_encode``      — B3, ``A~ = G A`` coded vocab blocks, once per plan;
* ``fused_ce``        — B4, per-token (lse, label logit, argmax) of
  ``H E^T`` for the training loss, forward and its two backward kernels
  (``fused_ce_fwd``, ``fused_ce_bwd_dh``, ``fused_ce_bwd_de``, one library).

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it for CPU tensors, and counts its launches
(``launch_counts``). Nothing is compiled at import; ``build_all`` builds
every library in parallel (one ``nvcc`` per source).
"""
from __future__ import annotations

from repro_torch.kernels import _cuda
from repro_torch.kernels.coded_matvec import ops as coded_matvec_ops
from repro_torch.kernels.fused_ce import ops as fused_ce_ops
from repro_torch.kernels.mds_encode import ops as mds_encode_ops
from repro_torch.kernels.paged_attention import ops as paged_attention_ops

KERNELS = (
    coded_matvec_ops.KERNEL,
    paged_attention_ops.KERNEL,
    mds_encode_ops.KERNEL,
    *fused_ce_ops.KERNELS,
)


def build_all() -> None:
    """Compile every kernel library not built yet, all at once."""
    _cuda.build_all(KERNELS)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
