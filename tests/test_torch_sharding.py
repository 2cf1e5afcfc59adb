"""The port's sharding rules and meshes against the reference's.

``param_spec`` for every parameter leaf of all ten configs at full width
(the port's shapes from a ``meta`` model, the reference's from
``jax.eval_shape(Model.init_params)``) on four meshes; ``batch_specs``
over batch sizes; ``cache_spec`` on each family's decode-cache leaves.
A mesh is a stand-in with a ``.shape`` mapping, all ``_fit`` reads. Then
the local mesh on gloo (world 1) and ``distribute_tensor`` round trips.
Specs compare as tuples: exact.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.mesh import (
    MeshShape,
    destroy_local_mesh,
    make_local_mesh,
    make_production_mesh,
)
from repro_torch.models.model import Model, jax_path
from repro_torch.sharding import rules

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 1}, {"data": 8, "model": 1}]


class _Mesh:
    """The reference's ``_fit`` reads ``mesh.shape[axis]`` only."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _ref_param_specs(arch: str, mesh) -> dict:
    from repro.configs import get_arch as ref_get_arch
    from repro.models.model import Model as RefModel
    from repro.sharding import rules as ref_rules

    tree = jax.eval_shape(RefModel(ref_get_arch(arch)).init_params, jax.random.PRNGKey(0))
    out = {}

    def one(path, leaf):
        depth = 1 if ref_rules._is_stacked(path) else 0
        out[ref_rules._path_str(path)] = tuple(
            ref_rules.param_spec(path, leaf.shape, mesh, stacked_depth=depth))

    jax.tree_util.tree_map_with_path(one, tree)
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_spec_matches_reference_for_every_leaf(arch):
    model = Model(get_arch(arch), device="meta")
    for shape in MESHES:
        want = _ref_param_specs(arch, _Mesh(shape))
        got = rules.param_specs(MeshShape(shape), model)
        assert {jax_path(n): s for n, s in got.items()} == want, shape
        # an optimizer moment's dict gets the same specs from its names
        moment = {n: p for n, p in model.named_parameters()}
        assert rules.param_specs(MeshShape(shape), moment) == got
    replicated = rules.param_specs(MeshShape(MESHES[0]), model, strategy="replicated")
    assert all(set(s) == {None} for s in replicated.values())


def test_batch_specs_match_reference():
    from repro.sharding import rules as ref_rules

    for shape in MESHES:
        for b in (1, 2, 3, 8, 16, 32, 48, 128, 256, 512, 1024):
            for include_model in (False, True):
                want = ref_rules.batch_specs(_Mesh(shape), b, include_model=include_model)
                got = rules.batch_specs(MeshShape(shape), b, include_model=include_model)
                assert got == tuple(want), (shape, b, include_model)


def _ref_cache(arch: str, b: int, s: int):
    from repro.configs import get_arch as ref_get_arch
    from repro.models.model import Model as RefModel

    model = RefModel(ref_get_arch(arch))
    cfg = model.config
    if cfg.family == "audio":
        enc = jax.ShapeDtypeStruct((b, cfg.encoder_seq, cfg.d_model), cfg.cdtype)
        return jax.eval_shape(lambda e: model.init_cache(b, s, {"enc_out": e}), enc)
    return jax.eval_shape(lambda: model.init_cache(b, s))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-3-2b", "h2o-danube-3-4b",
                                  "zamba2-1.2b", "xlstm-125m", "whisper-tiny"])
def test_cache_spec_matches_reference_on_each_family(arch):
    from repro.sharding import rules as ref_rules

    b, s = 128, 32_768
    cfg = get_arch(arch)
    model = Model(cfg, device="meta")
    extras = None
    if cfg.family == "audio":
        extras = {"enc_out": torch.empty((b, cfg.encoder_seq, cfg.d_model), device="meta")}
    cache = model.init_cache(b, s, extras)
    want = {}

    def one(path, leaf):
        for shape in MESHES:
            want[(ref_rules._path_str(path), tuple(shape.items()))] = (
                tuple(leaf.shape), tuple(ref_rules.cache_spec(path, leaf.shape, _Mesh(shape))))

    jax.tree_util.tree_map_with_path(one, _ref_cache(arch, b, s))
    got = {}
    for shape in MESHES:
        specs = rules.cache_tree_specs(MeshShape(shape), cache)

        def walk(tree, spec, prefix=""):
            if isinstance(tree, dict):
                for k in tree:
                    walk(tree[k], spec[k], f"{prefix}/{k}" if prefix else k)
            elif isinstance(tree, list):
                for i, (t, sp) in enumerate(zip(tree, spec)):
                    walk(t, sp, f"{prefix}/{i}")
            else:
                got[(rules.cache_path(prefix), tuple(shape.items()))] = (
                    tuple(tree.shape), spec)

        walk(cache, specs)
    assert got == want


def test_production_and_local_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    mesh = make_local_mesh(device="cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert torch.distributed.get_backend() == "gloo"
        model = Model(get_arch("qwen3-0.6b").reduced(), device="cpu")
        params = dict(model.named_parameters())
        shardings = rules.make_param_sharding(mesh, model)
        from torch.distributed.tensor import Shard

        assert shardings["wq"] == [Shard(1), Shard(2)]  # (L, D, H hd): data, model
        dist = rules.distribute(mesh, params, shardings)
        for name, t in dist.items():
            assert torch.equal(t.to_local(), params[name]), name
            assert torch.equal(t.full_tensor(), params[name]), name
        batch = {"tokens": torch.arange(32, dtype=torch.int32).reshape(4, 8)}
        placed = rules.make_batch_sharding(mesh, batch)
        assert placed["tokens"] == [Shard(0), rules.placements(mesh, (None, None))[1]]
        cache = model.init_cache(4, 16)
        cache_sh = rules.make_cache_sharding(mesh, cache)
        flat = {k: v for k, v in cache.items()}
        dist = rules.distribute(mesh, flat, cache_sh)
        for name, t in dist.items():
            assert torch.equal(t.to_local(), flat[name]), name
    finally:
        destroy_local_mesh()
    assert not torch.distributed.is_initialized()


def test_placements_follow_specs():
    mesh = make_local_mesh(device="cpu")
    try:
        from torch.distributed.tensor import Replicate, Shard

        assert rules.placements(mesh, (("pod", "data"), None)) == [Shard(0), Replicate()]
        assert rules.placements(mesh, (None, "model", "data")) == [Shard(2), Shard(1)]
        assert rules.placements(mesh, (None,)) == [Replicate(), Replicate()]
    finally:
        destroy_local_mesh()


def test_spec_helpers():
    mesh = MeshShape({"data": 16, "model": 16})
    assert rules.is_stacked("blocks/attn/wq") and not rules.is_stacked("blocks/3/cell/wq")
    assert not rules.is_stacked("shared_attn/attn/wq") and rules.is_stacked("encoder/mlp/w_up")
    assert rules.cache_path("k") == "kv/k" and rules.cache_path("xlstm/0/c") == "xlstm/0/c"
    assert rules.batch_leaf_spec(mesh, (32, 4096)) == ("data", None)
    assert rules.batch_specs(MeshShape({"pod": 2, "data": 16}), 64) == (("pod", "data"), None)
    np.testing.assert_equal(rules.mesh_axes(mesh), {"data": 16, "model": 16})
