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


def make_local_mesh(model_axis: int = 1, *, device: str = "cuda"):
    """A ("data", "model") ``DeviceMesh`` over this process's world, of
    shape (world // model_axis, model_axis); starts a one-rank group when
    there is none (NCCL for ``"cuda"``, gloo for ``"cpu"``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    global _OWN_GROUP
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_local_mesh: CUDA requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' for a gloo mesh")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
        _OWN_GROUP = True
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the world of {n}")
    return init_device_mesh(device, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def destroy_local_mesh() -> None:
    """Destroy the process group ``make_local_mesh`` started (no-op otherwise)."""
    import torch.distributed as dist

    global _OWN_GROUP
    if _OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP = False
