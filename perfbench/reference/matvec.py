"""Plain references of the paper's coded matvec, ``z = A x`` decoded from
the k coded rows that arrived.

``exact`` is A x in float64. ``coded`` is the coded matvec done plainly
at the configuration's float32: the surviving rows of A~ = G A encoded
exactly (float64, stored float32), their products with x in float32,
and a float32 solve of G_S z = y_S. Its error is the error float32
carries through this code on this mask, since the solve amplifies it by
the condition of G_S. With ``tf32`` it is the control, one precision
step below: the products from operands rounded to TF32's 10 mantissa
bits (to nearest, ties away, as the tensor cores' conversion does) and
summed in float32 with TF32 off, so the control reads the same on the
CPU and on the card. Imports nothing of the program.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def exact(a: torch.Tensor, xs: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """A (k, d) times the columns of xs (d, q) in float64, a block of rows
    of A at a time; returns (k, q) float64."""
    x64 = xs.double()
    return torch.cat([a[i:i + block].double() @ x64 for i in range(0, a.shape[0], block)])


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32 (10 mantissa bits), kept as float32."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@torch.no_grad()
def coded(g: torch.Tensor, a: torch.Tensor, x: torch.Tensor, rows: torch.Tensor, *,
          tf32: bool = False) -> torch.Tensor:
    """z from the coded rows ``rows`` (k indices into G's rows) of A~ = G A."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g_s = g[rows].float()
    a_s = (g_s.double() @ a.double()).float()
    y = (to_tf32(a_s) @ to_tf32(x)) if tf32 else a_s @ x.float()
    return torch.linalg.solve(g_s, y)
