"""Sharding rules: parameter path -> partition spec, with divisibility
fallbacks (counterpart of ``repro/sharding/rules.py``).

The reference's strategy, rule for rule:

* 2D logical layout per weight matrix — FSDP shard along the ``data``
  axis and tensor-parallel shard along the ``model`` axis:
    in-projections  (D, X):     ("data", "model")
    out-projections (X, D):     ("model", "data")
    embedding       (V, D):     ("model", "data")   (vocab-parallel)
    experts         (E, D, F):  ("model", "data", None)  (expert-parallel)
* Stacked layer params carry a leading L dim -> specs shift right one.
* The ``pod`` axis replicates params (pure DP across pods); the batch is
  sharded over ("pod", "data").
* Any dim not divisible by its mesh-axis extent falls back to unsharded
  on that axis (GQA head counts, odd vocab, tiny models).

A spec is a tuple with one entry per tensor dim: a mesh axis name, a
tuple of axis names, or None (the reference's ``PartitionSpec``). A mesh
is anything whose ``.shape`` maps axis name to extent (``launch/mesh``'s
shape-only production mesh), or a ``DeviceMesh`` with
``mesh_dim_names``. Rules match on each port parameter's reference path
(``models.model.jax_path``: the port keeps the reference's stacked
leading-L leaves, so the table carries over unchanged); a leaf is stacked
when it belongs to a stacked group of ``Model._groups`` (the decoder
blocks, the encoder), and the xLSTM's ``cells.<i>.<n>`` are not, like the
reference's Python-list blocks. Optimizer moments take their parameter's
spec.

``make_param_sharding``, ``make_batch_sharding`` and
``make_cache_sharding`` turn specs into DTensor placements (one
``Shard(d)`` or ``Replicate()`` per mesh dim) for a ``DeviceMesh``;
``distribute`` places tensors by them with ``distribute_tensor``.
"""
from __future__ import annotations

import math
import re

from repro_torch.models.model import jax_path

# (path regex, spec WITHOUT the stacked-layer dim). Longest match wins.
_RULES: tuple[tuple[str, tuple], ...] = (
    # embeddings / lm head (tied)
    (r"embed/table$", ("model", "data")),
    # attention
    (r"(attn|self_attn|cross_attn)/wq$", ("data", "model")),
    (r"(attn|self_attn|cross_attn)/wk$", ("data", "model")),
    (r"(attn|self_attn|cross_attn)/wv$", ("data", "model")),
    (r"(attn|self_attn|cross_attn)/wo$", ("model", "data")),
    # dense mlp
    (r"mlp/w_gate$", ("data", "model")),
    (r"mlp/w_up$", ("data", "model")),
    (r"mlp/w_down$", ("model", "data")),
    # moe (expert-parallel on model axis)
    (r"moe/w_router$", ("data", None)),
    (r"moe/w_gate$", ("model", "data", None)),
    (r"moe/w_up$", ("model", "data", None)),
    (r"moe/w_down$", ("model", None, "data")),
    # mamba2
    (r"mamba/w_in$", ("data", "model")),
    (r"mamba/w_out$", ("model", "data")),
    (r"mamba/conv_w$", (None, "model")),
    # xlstm
    (r"cell/w_up$", ("data", "model")),
    (r"cell/w[qkv]$", ("data", "model")),
    (r"cell/w_if$", ("data", None)),
    (r"cell/w_down$", ("model", "data")),
    (r"cell/w_x$", ("data", "model")),
    (r"cell/w_h$", ("model", None, None)),
    (r"cell/w_out$", ("data", "model")),
)

_STACKED_CONTAINERS = ("blocks", "encoder")
#: the decode cache's attention leaves, under ``kv/`` in the reference's tree
_KV_LEAVES = ("k", "v", "pos", "k_scale", "v_scale")


def mesh_axes(mesh) -> dict:
    """{axis name: extent} of a mesh: its ``.shape`` mapping, or a
    ``DeviceMesh``'s ``mesh_dim_names`` against its shape."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _fit(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop axes whose extent does not divide the corresponding dim."""
    extent = mesh_axes(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        size = math.prod(extent[a] for a in axes)
        out.append(ax if dim % size == 0 else None)
    # pad to rank
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def param_spec(path: str, leaf_shape, mesh, *, stacked_depth: int = 0) -> tuple:
    """Spec of one parameter leaf at reference path ``path`` ("blocks/attn/wq").

    stacked_depth: how many leading dims are layer-stacking dims.

    MoE expert weights whose expert count does not divide the `model`
    axis (e.g. grok's 8 experts on a 16-wide axis) fall back to sharding
    the FFN dim on `model` instead of replicating: a replicated expert
    tensor has every model shard compute every expert.
    """
    leaf_shape = tuple(leaf_shape)
    moe = re.search(r"moe/w_(gate|up|down)$", path)
    if moe:
        experts = leaf_shape[stacked_depth]
        model = mesh_axes(mesh).get("model", 1)
        if experts % model != 0:
            if moe.group(1) == "down":  # (E, F, D)
                spec = (None, "model", "data")
            else:  # (E, D, F)
                spec = (None, "data", "model")
            return _fit((None,) * stacked_depth + spec, leaf_shape, mesh)
    for pat, spec in _RULES:
        if re.search(pat, path):
            return _fit((None,) * stacked_depth + tuple(spec), leaf_shape, mesh)
    return _fit((None,) * len(leaf_shape), leaf_shape, mesh)  # replicated


def is_stacked(path: str) -> bool:
    """Whether a reference path is a stacked-layer leaf: under ``blocks`` or
    ``encoder``, and not a per-layer list entry (``blocks/<i>/...``, the
    xLSTM's cells); the hybrid's ``shared_attn`` is not stacked."""
    parts = path.split("/")
    return parts[0] in _STACKED_CONTAINERS and not parts[1].isdigit()


def _stacked_names(model) -> set:
    return set(model._groups["blocks"]) | set(model._groups["encoder"])


def param_specs(mesh, params, *, strategy: str = "2d", stacked=None) -> dict:
    """{port parameter name: spec} of a ``Model`` (its ``_groups`` say which
    leaves are stacked) or of a {port name: tensor} dict such as an
    optimizer moment (``stacked``: the stacked names; default by
    ``is_stacked`` on each reference path).

    strategy: "2d" (FSDP on ``data`` + TP on ``model``, the baseline) or
    "replicated" (pure data parallelism: every parameter replicated).
    """
    if strategy not in ("2d", "replicated"):
        raise ValueError(f"unknown strategy {strategy!r} (2d | replicated)")
    if hasattr(params, "named_parameters"):
        stacked = _stacked_names(params) if stacked is None else stacked
        params = dict(params.named_parameters())
    out = {}
    for name, t in params.items():
        if strategy == "replicated":
            out[name] = (None,) * t.dim()
            continue
        path = jax_path(name)
        depth = int(name in stacked if stacked is not None else is_stacked(path))
        out[name] = param_spec(path, t.shape, mesh, stacked_depth=depth)
    return out


def batch_specs(mesh, global_batch: int, *, include_model: bool = False) -> tuple:
    """Token batches shard over every data-like axis that divides B."""
    extent = mesh_axes(mesh)
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    axes = [a for a in names if a in extent]
    size = math.prod(extent[a] for a in axes)
    while axes and global_batch % size != 0:
        axes.pop(0)
        size = math.prod(extent[a] for a in axes)
    if not axes:
        return (None, None)
    # one axis is named alone, as ``PartitionSpec`` normalises it
    return (axes[0] if len(axes) == 1 else tuple(axes), None)


def batch_leaf_spec(mesh, shape, *, include_model: bool = False) -> tuple:
    """Spec of one batch leaf: its leading dim by ``batch_specs``."""
    shape = tuple(shape)
    spec = batch_specs(mesh, shape[0], include_model=include_model)
    return _fit(spec + (None,) * (len(shape) - len(spec)), shape, mesh)


def cache_path(path: str) -> str:
    """The reference's path of a port cache leaf: the attention leaves sit
    under ``kv/`` there (the port's cache dict is flat)."""
    head = path.split("/")[0]
    return f"kv/{path}" if head in _KV_LEAVES else path


def cache_spec(path: str, leaf_shape, mesh) -> tuple:
    """Decode caches: batch on data axes, heads/features on model.

    ``path`` is the reference's ("kv/k", "ssm", "xlstm/0/c"; ``cache_path``
    maps a port key).
    kv k/v: (L, B, S, KV, hd) -> (None, data, None, model, None)
    ssm state: (L, B, H, N, P) -> (None, data, model, None, None)
    everything else: batch-sharded on dim of size B where possible.
    """
    leaf_shape = tuple(leaf_shape)
    model = mesh_axes(mesh).get("model", 1)
    if re.search(r"kv/(k|v)$", path):
        # Prefer KV-head sharding on "model"; GQA counts that don't divide
        # the axis fall back to sharding the cache SEQ dim instead.
        kv_heads, seq = leaf_shape[3], leaf_shape[2]
        if kv_heads % model == 0:
            return _fit((None, "data", None, "model", None), leaf_shape, mesh)
        if seq % model == 0:
            return _fit((None, "data", "model", None, None), leaf_shape, mesh)
        return _fit((None, "data", None, None, None), leaf_shape, mesh)
    if re.search(r"kv/(k|v)_scale$", path):  # (L, B, S, KV)
        kv_heads, seq = leaf_shape[3], leaf_shape[2]
        if kv_heads % model == 0:
            return _fit((None, "data", None, "model"), leaf_shape, mesh)
        if seq % model == 0:
            return _fit((None, "data", "model", None), leaf_shape, mesh)
        return _fit((None, "data", None, None), leaf_shape, mesh)
    if re.search(r"kv/pos$", path):
        return (None,) * len(leaf_shape)
    if re.search(r"^ssm$", path) or re.search(r"/ssm$", path):
        return _fit((None, "data", "model", None, None), leaf_shape, mesh)
    if re.search(r"conv$", path):
        return _fit((None, "data", None, None), leaf_shape, mesh)
    if re.search(r"enc_out$", path):
        return _fit(("data", None, None), leaf_shape, mesh)
    # xlstm states: (B, H, ...) batch on data
    return _fit(("data",) + (None,) * (len(leaf_shape) - 1), leaf_shape, mesh)


def _map(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def cache_tree_specs(mesh, cache):
    """Specs of a port decode cache (``Model.init_cache``), leaf for leaf."""
    return _map(cache, lambda path, t: cache_spec(cache_path(path), t.shape, mesh))


def placements(mesh, spec: tuple) -> list:
    """DTensor placements of a spec on a ``DeviceMesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that axis,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == axis or (isinstance(ax, tuple) and axis in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def make_param_sharding(mesh, params, *, strategy: str = "2d", stacked=None) -> dict:
    """{port parameter name: placements} on a ``DeviceMesh`` (``param_specs``)."""
    return {n: placements(mesh, s)
            for n, s in param_specs(mesh, params, strategy=strategy, stacked=stacked).items()}


def make_batch_sharding(mesh, batch, *, include_model: bool = False):
    """Placements tree of a {"tokens", "labels", ("extras")} batch tree:
    each leaf's ``batch_leaf_spec``."""
    return _map(batch, lambda _, t: placements(
        mesh, batch_leaf_spec(mesh, t.shape, include_model=include_model)))


def make_cache_sharding(mesh, cache):
    """Placements tree of a decode cache (``cache_tree_specs``)."""
    return _map(cache, lambda path, t: placements(
        mesh, cache_spec(cache_path(path), t.shape, mesh)))


def distribute(mesh, tensors: dict, shardings: dict) -> dict:
    """{name: DTensor}: each tensor placed on ``mesh`` by its placements
    (``distribute_tensor``)."""
    from torch.distributed.tensor import distribute_tensor

    return {n: distribute_tensor(t.detach(), mesh, shardings[n]) for n, t in tensors.items()}
