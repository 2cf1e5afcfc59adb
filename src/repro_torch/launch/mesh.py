"""Mesh definitions (counterpart of ``repro/launch/mesh.py``).

``make_production_mesh`` is shape-only: the reference builds its 16 x 16
(one pod) and 2 x 16 x 16 (two pods) meshes on placeholder devices so
that a dry-run can plan them on one host, and no process of the port
holds 256 cards either. The dry-run and the sharding rules read only its
axis names and extents.

``make_local_mesh`` is a real ``DeviceMesh`` of ("data", "model") over
this process's world: with no process group yet it starts a world of one
rank from an in-process ``HashStore`` (no environment variables, no
network), NCCL on the card and gloo when the caller passes
``device="cpu"``. A multi-card host runs one process per card, each
initialising its group first; the mesh then spans that world.
``make_workers_mesh`` is the paper's 1-D ("workers",) mesh over the same
world (the reference's ``jax.make_mesh((n,), ("workers",))``), on which
``core.coded_matvec`` splits the workers' products over the ranks.
``destroy_local_mesh`` ends a group this module started, so that later
phases start clean.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_OWN_GROUP = False


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A shape-only mesh: ``shape`` maps axis name to extent, in order."""

    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips per pod; 2 pods = 512 chips when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(dict(zip(axes, shape)))


def _ensure_group(device: str, who: str) -> int:
    """The world size of this process's group; starts a one-rank group
    from an in-process store when there is none (NCCL for ``"cuda"``,
    gloo for ``"cpu"``)."""
    import torch.distributed as dist

    global _OWN_GROUP
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' for a gloo mesh")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
        _OWN_GROUP = True
    return dist.get_world_size()


def make_local_mesh(model_axis: int = 1, *, device: str = "cuda"):
    """A ("data", "model") ``DeviceMesh`` over this process's world, of
    shape (world // model_axis, model_axis); starts a one-rank group when
    there is none (NCCL for ``"cuda"``, gloo for ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _ensure_group(device, "make_local_mesh")
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the world of {n}")
    return init_device_mesh(device, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def make_workers_mesh(*, device: str = "cuda"):
    """The paper's 1-D ("workers",) ``DeviceMesh`` over this process's
    world: one rank a slice of the workers. Starts a one-rank group when
    there is none (NCCL for ``"cuda"``, gloo for ``"cpu"``).

    A caller that runs R ranks starts its group first (each rank
    ``torch.distributed.init_process_group``). NCCL needs one card a rank;
    ranks that share one card use gloo, whose collectives on CUDA tensors
    stage through the host.
    """
    from torch.distributed.device_mesh import init_device_mesh

    n = _ensure_group(device, "make_workers_mesh")
    return init_device_mesh(device, (n,), mesh_dim_names=("workers",))


def destroy_local_mesh() -> None:
    """Destroy the process group ``make_local_mesh`` or ``make_workers_mesh``
    started (no-op otherwise)."""
    import torch.distributed as dist

    global _OWN_GROUP
    if _OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP = False
