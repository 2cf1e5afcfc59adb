"""B2 paged decode attend and the pool scatters (``ops``).

The reference's names: ``paged_decode_attend_kernel`` is the kernel route
alone; ``paged_decode_attend_ref`` and ``paged_chunk_attend_ref`` (its
numpy oracles) are the port's plain torch versions.
"""
from repro_torch.kernels.paged_attention.ops import (
    gather_kv,
    paged_chunk_attend,
    paged_decode_attend,
    paged_decode_attend_kernel,
    paged_decode_attend_plain,
    scatter_chunk,
    scatter_decode,
    valid_mask,
)

paged_decode_attend_ref = paged_decode_attend_plain
paged_chunk_attend_ref = paged_chunk_attend

__all__ = [
    "gather_kv",
    "paged_chunk_attend",
    "paged_decode_attend",
    "paged_decode_attend_kernel",
    "scatter_chunk",
    "scatter_decode",
    "valid_mask",
    "paged_chunk_attend_ref",
    "paged_decode_attend_ref",
]
