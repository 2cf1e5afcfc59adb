"""The paper's coded matrix-vector product: the master/worker pattern,
in one process or split over the ranks of a ``workers`` mesh.

Counterpart of ``repro/core/coded_matvec.py``. The master encodes
``A~ = G A`` (B3 ``mds_encode``), packs each worker's coded rows into a
block padded to the plan's ``max_load``, every worker computes its block
times x, and the master decodes ``A x`` from the workers that met the
deadline. With no mesh the workers are the leading dimension of one
(W * max_load, d) B1 launch.

With a 1-D ``workers`` mesh of R ranks (``launch.mesh.make_workers_mesh``)
the packed A~ is sharded over the axis, as the reference's ``shard_map``
takes it (``in_specs=P(axis, None, None)``: its single controller encodes
once and each device receives its workers' block). Here the master, rank
0 of the axis's group, draws G, runs B3 and packs; ``shard_packed`` sends
rank r the (W/R, max_load, d) block of workers [r W/R, (r+1) W/R), so no
other rank holds G, A or the whole A~. Each rank computes its block in
one B1 launch (``coded_matvec_block``), the products are all-gathered in
worker order, and the master decodes and broadcasts (z, ok): every rank
returns the same result.

* ``DecodePipeline`` — the hot path: products, erasure mask and the
  decode (its ``coding.ErasureDecoder``, sized) on the device, with one
  read of the query's e on the host, which sizes the solve (the serve
  head's static solve reads none);
* ``coded_matvec`` / ``decode_coded_result`` — the split pair, the decode
  on the host by least squares (the reference's oracle path).

On the card the kernels always run (the reference's ``use_kernel``); on
the CPU their plain versions do. Collectives go through the mesh's group
as they are: gloo for ranks that share a card, NCCL for one card a rank.
Under a profiler the master step's stages are spans of
``obs.trace.STAGES``: ``pathm.query`` around ``pathm.products`` and
``pathm.decode``, the solve's stages under it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.coding import (
    ErasureDecoder,
    decode_from_rows,
    encode,
    make_generator,
    slot_map,
)
from repro_torch.core.planner import DeploymentPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.coded_matvec.ops import blocked_matvec_batch
from repro_torch.obs.trace import stage


def pack_coded_matrix(generator: torch.Tensor, a: torch.Tensor, plan: DeploymentPlan):
    """Encode A and pack per-worker blocks padded to ``max_load``.

    Returns, on ``a``'s device:
      packed: (W, max_load, d) float32 — worker i's rows in [i, :load_i];
      row_of: (W, max_load) int32 — the coded row of each packed slot,
        -1 for a pad (``coding.slot_map``).
    """
    coded = encode(generator, a)
    w, ml, d = plan.num_workers, plan.max_load, coded.shape[1]
    row_of = slot_map(plan.row_ranges, ml)
    slots = np.flatnonzero(row_of.ravel() >= 0)
    packed = torch.zeros((w * ml, d), dtype=torch.float32, device=coded.device)
    packed[torch.from_numpy(slots).to(coded.device)] = coded[
        torch.from_numpy(row_of.ravel()[slots].astype(np.int64)).to(coded.device)]
    return packed.reshape(w, ml, d), torch.from_numpy(row_of).to(coded.device)


def _workers_group(mesh, axis: str, device: torch.device):
    """(group, R, this rank's index in it) of the mesh's ``axis``."""
    if mesh.device_type != device.type:
        raise ValueError(f"tensors on {device.type}, the mesh on {mesh.device_type}")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _mesh_device(mesh) -> torch.device:
    """This rank's device of the mesh's type (the current card on CUDA)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _per_rank(w: int, r: int, axis: str) -> int:
    if w % r:
        raise ValueError(f"{w} workers do not split over {r} ranks of the {axis!r} axis")
    return w // r


def shard_packed(packed: torch.Tensor | None, plan: DeploymentPlan, mesh, *,
                 axis: str = "workers") -> torch.Tensor:
    """This rank's (W/R, max_load, d) block of the packed A~: workers
    [r W/R, (r+1) W/R) of a ``workers`` mesh of R ranks.

    The master, rank 0 of the axis's group, passes the whole packed array
    (float32, as ``pack_coded_matrix`` gives it) and scatters it; its own
    block is a view of it. Every other rank passes ``None`` and allocates
    only its block (d comes from the master in a one-element broadcast).
    R must divide the plan's W.
    """
    dev = _mesh_device(mesh) if packed is None else packed.device
    group, r, rank = _workers_group(mesh, axis, dev)
    w, ml = plan.num_workers, plan.max_load
    per = _per_rank(w, r, axis)
    if (rank == 0) != (packed is not None):
        raise ValueError("the master (rank 0 of the axis) passes the packed A~, "
                         f"every other rank None; rank {rank} passed "
                         f"{'None' if packed is None else 'an array'}")
    if packed is not None and (tuple(packed.shape[:2]) != (w, ml)
                               or packed.dtype != torch.float32):
        raise ValueError(f"packed A~ of shape {tuple(packed.shape)} in {packed.dtype}, "
                         f"the plan packs ({w}, {ml}, d) in torch.float32")
    if r == 1:
        return packed
    master = dist.get_global_rank(group, 0)
    d = torch.tensor([0 if packed is None else packed.shape[2]], dtype=torch.int64,
                     device=dev)
    dist.broadcast(d, master, group=group)
    if rank == 0:
        chunks = list(packed.contiguous().split(per))
        block = chunks[0]
    else:
        chunks = None
        block = torch.empty((per, ml, int(d)), dtype=torch.float32, device=dev)
    dist.scatter(block, chunks, master, group=group)
    return block


def coded_matvec_block(block: torch.Tensor, x: torch.Tensor, mesh, *,
                       axis: str = "workers") -> torch.Tensor:
    """All workers' products ``A~_i x``, (W, max_load), from this rank's
    (W/R, max_load, d) block (``shard_packed``) of a ``workers`` mesh of R
    ranks: one B1 launch on the block, then an all-gather of the
    (W/R, max_load) products into worker order, returned on every rank
    (the reference's ``out_specs=P(axis, None)``)."""
    group, r, _ = _workers_group(mesh, axis, block.device)
    with stage("pathm.products", block.device):
        local = blocked_matvec_batch(block, x)
        per = block.shape[0]
        out = torch.empty((r * per, block.shape[1]), dtype=local.dtype, device=local.device)
        dist.all_gather(list(out.split(per)), local, group=group)
        return out


def coded_matvec(packed: torch.Tensor, x: torch.Tensor, *, mesh=None,
                 axis: str = "workers") -> torch.Tensor:
    """All workers' products ``A~_i x``: (W, max_load).

    With no mesh, one B1 launch over the (W * max_load, d) view. With a
    mesh of R ranks on ``axis`` (R must divide W), for a caller that holds
    the whole packed A~ on every rank: this rank's slice of workers
    [r W/R, (r+1) W/R) through ``coded_matvec_block``. The mesh path
    proper (``end_to_end_coded_matvec``) has only the master pack A~ and
    hands each rank its block (``shard_packed``).
    """
    if mesh is None:
        with stage("pathm.products", packed.device):
            return blocked_matvec_batch(packed, x)
    _, r, rank = _workers_group(mesh, axis, packed.device)
    per = _per_rank(packed.shape[0], r, axis)
    return coded_matvec_block(packed[rank * per:(rank + 1) * per], x, mesh, axis=axis)


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
    """Erasure mask and decode on the device, with one read of the host:
    a sized ``ErasureDecoder`` with ``row_of`` bound for one call.

    It scatters the packed per-slot products, (W, max_load) or (W,
    max_load, c), into coded-row order (pad slots and the slots of workers
    that missed the deadline go to a dropped row ``n``) and marks the
    surviving rows, inside its ``decode.gather`` span, then decodes (for a
    systematic G, the reduced solve sized by the query's e: the one read,
    of e and whether k rows survived). Returns (z, ok), ``ok`` a 0-d bool
    tensor (False: < k rows survived).
    """
    return ErasureDecoder(generator, row_of=row_of, sized=True)(partials, finished_workers)


class DecodePipeline:
    """The master step: worker products -> erasure mask -> decode, on the
    device, bound to one deployment's generator and slot map.

    The master binds its ``ErasureDecoder`` here (one host read), sized
    and with ``row_of``. A systematic generator, [I_k; P] as the
    program's own, is decoded by the reduced solve: each surviving
    systematic row is its own unknown, and the e erased ones come from the
    first e surviving parity rows, in a system of e rounded up to 128
    rows, the rest of it identity. A query reads e (and whether k rows
    survived) to the host once, after B1 and the scatter are queued; it
    solves nothing where e is 0. Any other G is decoded by the (k, k)
    solve of the first k survivors.

    With a ``workers`` mesh the products are split over its ranks; the
    master, rank 0 of the axis's group, decodes and broadcasts (z, ok), so
    that every rank returns the same result and one solve runs, not R
    copies of it. Only the master needs ``generator`` and ``row_of``:
    every other rank may pass ``None`` for both and gives ``k``, the
    decoded length.
    """

    def __init__(self, generator: torch.Tensor | None, row_of: torch.Tensor | None, *,
                 mesh=None, axis: str = "workers", k: int | None = None):
        if generator is None and (mesh is None or k is None):
            raise ValueError("without the generator, give a mesh and k "
                             "(a rank other than the master)")
        self.mesh = mesh
        self.axis = axis
        self.k = generator.shape[1] if k is None else int(k)
        self.decoder = (None if generator is None or row_of is None
                        else ErasureDecoder(generator, row_of=row_of, sized=True))

    def __call__(self, packed: torch.Tensor, x: torch.Tensor,
                 finished_workers: torch.Tensor):
        """A round from the whole packed A~ (on every rank, with a mesh)."""
        with stage("pathm.query", packed.device, root=True):
            partials = coded_matvec(packed, x, mesh=self.mesh, axis=self.axis)
            return self.decode(partials, finished_workers)

    def on_block(self, block: torch.Tensor, x: torch.Tensor,
                 finished_workers: torch.Tensor):
        """A round from this rank's block of the mesh (``shard_packed``)."""
        with stage("pathm.query", block.device, root=True):
            partials = coded_matvec_block(block, x, self.mesh, axis=self.axis)
            return self.decode(partials, finished_workers)

    def decode(self, partials: torch.Tensor, finished_workers: torch.Tensor):
        """The decoder's (z, ok) of the gathered (W, max_load) products:
        here, or with a mesh at the master and broadcast to every rank."""
        def decode():
            if self.decoder is None:
                raise ValueError("the master (rank 0 of the axis) decodes: "
                                 "give it the generator and row_of")
            return self.decoder(partials, finished_workers)

        with stage("pathm.decode", partials.device):
            if self.mesh is None:
                return decode()
            return _at_master(self.mesh, self.axis, partials, (self.k, *partials.shape[2:]),
                              decode)


def _at_master(mesh, axis: str, like: torch.Tensor, shape: tuple, decode):
    """Run ``decode`` () -> (z, ok) at the master, rank 0 of the mesh
    axis's group, and broadcast it: every rank returns the master's z, of
    ``shape`` and ``like``'s dtype and device, and ok as a 0-d bool."""
    group, _, rank = _workers_group(mesh, axis, like.device)
    if rank == 0:
        z, ok = decode()
        z = torch.as_tensor(z).to(like.device)
        flag = torch.as_tensor(ok).to(device=like.device, dtype=torch.int32).reshape(1)
    else:
        z = torch.empty(shape, dtype=like.dtype, device=like.device)
        flag = torch.empty((1,), dtype=torch.int32, device=like.device)  # gloo takes no bool
    master = dist.get_global_rank(group, 0)
    dist.broadcast(z, master, group=group)
    dist.broadcast(flag, master, group=group)
    return z, flag[0].bool()


def end_to_end_coded_matvec(a, x, plan: DeploymentPlan, finished_workers=None, *,
                            seed: int = 0, g: np.ndarray | None = None,
                            host_decode: bool = False,
                            device: str | torch.device = "cuda", mesh=None):
    """Encode -> distribute -> compute -> decode, on ``device``.

    ``a`` (k, d) and ``x`` (d,) are numpy arrays or tensors; the generator
    is the seeded one (``seed``) or an injected numpy ``g``; every worker
    finishes unless ``finished_workers`` (W,) says otherwise. Returns
    ``DecodePipeline``'s (z, ok) on the device, or with ``host_decode``
    ``decode_coded_result``'s host least squares of the gathered products
    (numpy z, bool ok).

    With a ``workers`` ``mesh`` (on ``device``'s type) only the master,
    rank 0 of the axis, reads ``a`` (any other rank may pass ``None``),
    draws the generator, runs B3 and packs; ``shard_packed`` hands each
    rank its block, each rank runs B1 on it, and the master decodes: every
    rank returns the master's (z, ok).
    """
    if mesh is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device} and a {mesh.device_type} mesh")
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if finished_workers is None:
        finished_workers = torch.ones((plan.num_workers,), dtype=torch.bool)
    finished_workers = torch.as_tensor(finished_workers, dtype=torch.bool).to(dev)
    master = mesh is None or _workers_group(mesh, "workers", dev)[2] == 0
    gen = row_of = packed = None
    if master:
        a = torch.as_tensor(a, dtype=torch.float32).to(dev)
        if a.shape[0] != plan.k:
            raise ValueError(f"A has {a.shape[0]} rows, the plan codes k={plan.k}")
        gen = make_generator(plan.n, plan.k, seed=seed, g=g, device=dev)
        packed, row_of = pack_coded_matrix(gen, a.contiguous(), plan)
        del a
    if mesh is None:
        if host_decode:
            return decode_coded_result(gen, row_of, coded_matvec(packed, x),
                                       finished_workers, plan.k)
        return DecodePipeline(gen, row_of)(packed, x, finished_workers)
    block = shard_packed(packed, plan, mesh)
    if host_decode:
        partials = coded_matvec_block(block, x, mesh)
        decode = lambda: decode_coded_result(gen, row_of, partials,  # noqa: E731
                                             finished_workers, plan.k)
        z, ok = _at_master(mesh, "workers", partials, (plan.k,), decode)
        return z.cpu().numpy(), bool(ok)
    return DecodePipeline(gen, row_of, mesh=mesh, k=plan.k).on_block(block, x,
                                                                     finished_workers)
