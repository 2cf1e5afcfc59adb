"""The paper's coded matrix-vector product on one card, workers as a batch.

Counterpart of ``repro/core/coded_matvec.py``. The master encodes
``A~ = G A`` (B3 ``mds_encode``), packs each worker's coded rows into a
block padded to the plan's ``max_load``, every worker computes its block
times x (one B1 launch over the (W * max_load, d) view: the reference's
``workers`` mesh axis is the leading dimension here), and the master
decodes ``A x`` from the workers that met the deadline.

* ``DecodePipeline`` — the hot path: products, erasure mask and the
  fixed-shape decode (``masked_decode`` -> ``decode_systematic``) on the
  device, with no sync with the host;
* ``coded_matvec`` / ``decode_coded_result`` — the split pair, the decode
  on the host by least squares (the reference's oracle path).

On the card the kernels always run (the reference's ``use_kernel``); on
the CPU their plain versions do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coding import (
    decode_from_rows,
    decode_systematic,
    encode,
    make_generator,
)
from repro_torch.core.planner import DeploymentPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.coded_matvec.ops import blocked_matvec_batch


def pack_coded_matrix(generator: torch.Tensor, a: torch.Tensor, plan: DeploymentPlan):
    """Encode A and pack per-worker blocks padded to ``max_load``.

    Returns, on ``a``'s device:
      packed: (W, max_load, d) float32 — worker i's rows in [i, :load_i];
      row_of: (W, max_load) int32 — the coded row of each packed slot,
        -1 for a pad.
    """
    coded = encode(generator, a)
    w, ml, d = plan.num_workers, plan.max_load, coded.shape[1]
    row_of = np.full((w, ml), -1, np.int32)
    for i, (s, e) in enumerate(plan.row_ranges):
        row_of[i, : e - s] = np.arange(s, e, dtype=np.int32)
    slots = np.flatnonzero(row_of.ravel() >= 0)
    packed = torch.zeros((w * ml, d), dtype=torch.float32, device=coded.device)
    packed[torch.from_numpy(slots).to(coded.device)] = coded[
        torch.from_numpy(row_of.ravel()[slots].astype(np.int64)).to(coded.device)]
    return packed.reshape(w, ml, d), torch.from_numpy(row_of).to(coded.device)


def coded_matvec(packed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """All workers' products ``A~_i x``: (W, max_load), one B1 launch."""
    return blocked_matvec_batch(packed, x)


def decode_coded_result(generator, row_of, partials, finished_workers, k: int):
    """Master-side decode on the host, from the workers that met the deadline.

    Args:
      generator: (n, k) generator used at pack time.
      row_of: (W, max_load) packed-slot -> coded-row map (-1 pads).
      partials: (W, max_load) per-slot products.
      finished_workers: (W,) bool mask.
      k: uncoded rows.

    Returns (z, ok) as numpy and a bool: the least-squares recovery of
    A x, or zeros and False when fewer than k rows survive.
    """
    host = lambda t: t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)  # noqa: E731
    row_of, partials, fin = host(row_of), host(partials), host(finished_workers)
    slot_ok = (row_of >= 0) & fin.astype(bool)[:, None]
    rows, vals = row_of[slot_ok], partials[slot_ok]
    if rows.size < k:
        return np.zeros((k,), dtype=partials.dtype), False
    g_rows = torch.from_numpy(np.ascontiguousarray(host(generator)[rows]))
    return decode_from_rows(g_rows, torch.from_numpy(vals)).numpy(), True


def masked_decode(generator: torch.Tensor, row_of: torch.Tensor, partials: torch.Tensor,
                  finished_workers: torch.Tensor):
    """Erasure mask and decode on the device, no sync with the host.

    Scatters the packed per-slot products, (W, max_load) or (W, max_load,
    c), into coded-row order (pad slots and the slots of workers that
    missed the deadline go to a dropped row ``n``), marks the surviving
    rows and runs ``decode_systematic``. Returns (z, ok), ``ok`` a 0-d
    bool tensor (False: < k rows survived).
    """
    n = generator.shape[0]
    fin = finished_workers.to(device=row_of.device, dtype=torch.bool)
    rows = torch.where((row_of >= 0) & fin[:, None], row_of.long(), n).reshape(-1)
    cols = partials.shape[2:]
    y = torch.zeros((n + 1, *cols), dtype=partials.dtype, device=partials.device)
    y.index_put_((rows,), partials.reshape(-1, *cols))
    alive = torch.zeros((n + 1,), dtype=torch.bool, device=partials.device)
    alive[rows] = True
    return decode_systematic(generator, y[:n], alive[:n])


class DecodePipeline:
    """The master step: worker products -> erasure mask -> decode, on the
    device, bound to one deployment's generator and slot map."""

    def __init__(self, generator: torch.Tensor, row_of: torch.Tensor):
        self.generator = generator
        self.row_of = row_of

    def __call__(self, packed: torch.Tensor, x: torch.Tensor,
                 finished_workers: torch.Tensor):
        partials = coded_matvec(packed, x)
        return masked_decode(self.generator, self.row_of, partials, finished_workers)


def end_to_end_coded_matvec(a, x, plan: DeploymentPlan, finished_workers=None, *,
                            seed: int = 0, g: np.ndarray | None = None,
                            host_decode: bool = False,
                            device: str | torch.device = "cuda"):
    """Encode -> distribute -> compute -> decode, on ``device``.

    ``a`` (k, d) and ``x`` (d,) are numpy arrays or tensors; the generator
    is the seeded one (``seed``) or an injected numpy ``g``; every worker
    finishes unless ``finished_workers`` (W,) says otherwise. Returns
    ``DecodePipeline``'s (z, ok) on the device, or with ``host_decode``
    ``decode_coded_result``'s host least squares.
    """
    dev = resolve_device(device)
    a = torch.as_tensor(a, dtype=torch.float32).to(dev)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    k = a.shape[0]
    if k != plan.k:
        raise ValueError(f"A has {k} rows, the plan codes k={plan.k}")
    gen = make_generator(plan.n, k, seed=seed, g=g, device=dev)
    packed, row_of = pack_coded_matrix(gen, a.contiguous(), plan)
    if finished_workers is None:
        finished_workers = torch.ones((plan.num_workers,), dtype=torch.bool)
    finished_workers = torch.as_tensor(finished_workers, dtype=torch.bool).to(dev)
    if host_decode:
        partials = coded_matvec(packed, x)
        return decode_coded_result(gen, row_of, partials, finished_workers, k)
    return DecodePipeline(gen, row_of)(packed, x, finished_workers)
