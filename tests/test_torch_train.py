"""Port parity, coded training on reduced qwen3-0.6b (float32, CPU).

Same seeded numpy inputs and the reference's parameters (carried across
with ``params_from_jax``) into both packages:

* training attention, the materialized cross entropy and ``lm_logits``;
* ``Model.loss_fn`` (through the fused CE's plain version on the CPU):
  loss, accuracy and every gradient leaf against ``jax.grad`` of the
  reference's ``loss_fn``;
* ``grad_coding`` plans (loads 1e-9, integers exact), decode vectors on
  an erasure grid, ``SyntheticLMData`` batches (exact), AdamW;
* one coded step with the reference's B and an injected worker mask
  against the reference's jitted coded step with the same mask (rtol
  2e-4, atol 2e-5, the reference test's), the skip step (bit-unchanged),
  a 3-step ``Trainer.run``, checkpoints restored across packages, and
  the CLI.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import ShapeConfig as RefShape
from repro.core import gradient_coding as ref_gc
from repro.core.planner import deploy as ref_deploy
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.data import SyntheticLMData as RefData
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.model import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine
from repro.runtime.train_loop import TrainConfig as RefTrainConfig
from repro.runtime.train_loop import Trainer as RefTrainer
from repro.runtime.train_loop import heterogeneous_batch_split as ref_split
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import gradient_coding as gc
from repro_torch.core.planner import deploy
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import make_scheme
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, layers
from repro_torch.models.model import JAX_NAMES, Model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime import train_loop
from repro_torch.runtime.train_loop import (
    TrainConfig,
    Trainer,
    aggregate_with_erasures,
    heterogeneous_batch_split,
    make_coded_train_step_fn,
    state_tree,
)

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
FLEET = ([2, 2], [4.0, 1.0])
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
#: AdamW eps of the whole-step comparisons. Adam's first update is
#: lr g / (|g| + eps): at the default 1e-8 an element whose gradient is
#: summation noise (|g| ~ 4e-8, the two packages a few 1e-9 apart) moves
#: by 1e-5 between the packages. At 1e-6 the update is Lipschitz in g at
#: that scale; the aggregated gradients themselves are held at the
#: default config.
ADAM_EPS = 1e-6


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def pair():
    ref = RefModel(REF_ARCHS["qwen3-0.6b"].reduced())
    params = ref.init_params(KEY)
    tree = jax.tree.map(np.asarray, params)
    return ref, params, tree


def _port_model(tree):
    return Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu").params_from_jax(tree)


def _ref_batch(seq=32, batch=4, seed=1, steps=1):
    data = RefData(REF_ARCHS["qwen3-0.6b"].reduced(), RefShape("t", seq, batch, "train"),
                   seed=seed)
    for _ in range(steps):
        b = data.next_batch()
    return {k: np.array(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("s,block", [(32, 32), (40, 16), (24, 8)])
def test_training_attention_matches_reference(pair, s, block):
    """Causal GQA with rope and qk-norm, padded when blocks do not divide S."""
    _, _, tree = pair
    c = ARCHS["qwen3-0.6b"].reduced()
    p = {n: np.array(tree["blocks"]["attn"][n][1]) for n in ("wq", "wk", "wv", "wo", "q_norm",
                                                   "k_norm")}
    x = np.random.default_rng(s).standard_normal((2, s, c.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    kw = dict(num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
              head_dim=c.resolved_head_dim, rope_theta=c.rope_theta,
              q_block=block, kv_block=block)
    got = attention.attention({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), torch.from_numpy(pos), **kw)
    want = ref_attn.attention(p, jnp.asarray(x), jnp.asarray(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cross_entropy_loss_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) > 0.3
    for m in (None, mask):
        got = layers.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                        None if m is None else torch.from_numpy(m))
        want = ref_layers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                             None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_lm_logits_match_reference(pair):
    ref, params, tree = pair
    ours = _port_model(tree)
    toks = _ref_batch()["tokens"]
    with torch.no_grad():
        got = ours.lm_logits(torch.from_numpy(toks))
    want = ref.lm_logits(params, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert ours.param_count() == ref.param_count()


# ------------------------------------------------------------------- loss
def test_loss_fn_and_gradients_match_reference(pair):
    """Loss, accuracy and every gradient leaf, masked labels included."""
    ref, params, tree = pair
    ours = _port_model(tree)
    b = _ref_batch()
    b["labels"][0, :5] = -1
    (want, wm), wg = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    loss, metrics = ours.loss_fn(_torch_batch(b))
    named = dict(ours.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(wm["accuracy"]), atol=1e-7)
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), _leaf(wg, JAX_NAMES[name]),
                                   rtol=2e-4, atol=2e-6, err_msg=name)


def test_remat_does_not_change_the_gradients(pair):
    _, _, tree = pair
    b = _torch_batch(_ref_batch(seq=16, batch=2))
    out = []
    for remat in (True, False):
        m = _port_model(tree)
        m.config = m.config.__class__(**{**m.config.__dict__, "remat": remat})
        loss, _ = m.loss_fn(b)
        out.append(torch.autograd.grad(loss, [m.wq, m.embed]))
    for a, c in zip(*out):
        assert torch.equal(a, c)


# ---------------------------------------------------------------- planning
@pytest.mark.parametrize("k", [4, 16, 64])
@pytest.mark.parametrize("clus", [([6, 6], [8.0, 0.7], 1.0),
                                  ([3, 4, 5], [2.0, 1.0, 0.5], [1.0, 1.5, 0.5]),
                                  ([10], [1.0], 1.0), ([2, 2], [4.0, 0.8], 1.0)])
@pytest.mark.parametrize("name", ["grad_coding", "grad_coding_per_row"])
def test_grad_coding_plans_match_reference(name, clus, k):
    plan = deploy(make_scheme(name), ClusterSpec.make(*clus), k)
    want = ref_deploy(ref_make_scheme(name), RefCluster.make(*clus), k)
    a, b = plan.allocation, want.allocation
    np.testing.assert_allclose(a.loads, np.asarray(b.loads), rtol=1e-9)
    np.testing.assert_allclose(a.n, b.n, rtol=1e-9)
    np.testing.assert_allclose(a.t_star, b.t_star, rtol=1e-9)
    np.testing.assert_array_equal(a.loads_int, b.loads_int)
    assert a.n_int == b.n_int and plan.n == want.n and a.scheme == b.scheme == name
    np.testing.assert_array_equal(plan.loads_per_worker, want.loads_per_worker)


def test_batch_split_matches_reference():
    for nw, mus in (([6, 6], [8.0, 0.7]), ([3, 4, 5], [2.0, 1.0, 0.5])):
        for gb in (16, 37):
            np.testing.assert_array_equal(
                heterogeneous_batch_split(ClusterSpec.make(nw, mus), gb),
                ref_split(RefCluster.make(nw, mus), gb))


def test_decode_vector_erasure_grid_matches_oracle():
    """Exactly-k and fewer-than-k survivors included; the reference's B."""
    n, k = 9, 5
    b = np.asarray(ref_gc.assignment_matrix(n, k, key=KEY), np.float32)
    bt = gc.assignment_matrix(n, k, b=b, device="cpu")
    for erased in itertools.chain.from_iterable(
            itertools.combinations(range(n), e) for e in range(0, n - k + 2)):
        mask = np.ones(n, bool)
        mask[list(erased)] = False
        a_np, ok_np = gc.decode_vector(b, mask)
        a_ref, ok_ref = ref_gc.decode_vector(b, mask)
        a_t, ok_t = gc.decode_vector_torch(bt, torch.from_numpy(mask))
        assert ok_np == ok_ref == bool(ok_t) == (mask.sum() >= k)
        np.testing.assert_allclose(a_np, a_ref, rtol=1e-12)
        if ok_np:
            np.testing.assert_allclose(gc.partition_weights(b, a_np), np.ones(k), atol=1e-9)
            np.testing.assert_allclose(a_t.numpy() @ b, np.ones(k), atol=1e-4)
            assert np.all(a_t.numpy()[~mask] == 0)
        else:
            assert np.all(a_np == 0) and np.all(a_t.numpy() == 0)
    a, ok = gc.decode_vector_torch(bt, torch.ones(n, dtype=torch.bool))
    np.testing.assert_array_equal(a.numpy(), [1.0] * k + [0.0] * (n - k))


def test_encode_aggregate_roundtrip_is_the_partition_weighting():
    n, k = 6, 3
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    grads = {"w": torch.randn(k, 4, 2), "b": torch.randn(k, 5)}
    mask = np.array([True, False, True, True, False, True])
    a, ok = gc.decode_vector(b.numpy(), mask)
    agg = gc.aggregate_coded(gc.encode_gradients(grads, b), torch.from_numpy(a))
    w = torch.from_numpy(gc.partition_weights(b.numpy(), a))
    for name, g in grads.items():
        np.testing.assert_allclose(agg[name].numpy(),
                                   torch.tensordot(w.float(), g, dims=1).numpy(),
                                   rtol=1e-4, atol=1e-4)


# -------------------------------------------------------- data, optimizer
@pytest.mark.parametrize("learnable,start", [(True, 0), (True, 5), (False, 2)])
def test_synthetic_batches_equal_reference(learnable, start):
    c = ARCHS["qwen3-0.6b"].reduced()
    ours = SyntheticLMData(c, ShapeConfig("t", 24, 3, "train"), seed=7, start_step=start,
                           learnable=learnable, device="cpu")
    ref = RefData(REF_ARCHS["qwen3-0.6b"].reduced(), RefShape("t", 24, 3, "train"), seed=7,
                  start_step=start, learnable=learnable)
    for _ in range(3):
        got, want = ours.next_batch(), ref.next_batch()
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert ours.state() == ref.state()


def test_adamw_matches_reference():
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 6), "stack": (3, 5), "bias": (7,)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    rcfg = RefAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    # copies: the port's update writes the parameters in place, and
    # jnp.asarray may share the numpy buffer on the CPU
    p = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    rp = {n: jnp.asarray(v) for n, v in params.items()}
    st, rst = adamw_init(cfg, p), ref_adamw_init(rcfg, rp)
    for step in range(5):
        g = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
        p, st, m = adamw_update(cfg, {n: torch.from_numpy(v) for n, v in g.items()}, st, p)
        rp, rst, rm = ref_adamw_update(rcfg, {n: jnp.asarray(v) for n, v in g.items()},
                                       rst, rp)
        for n in shapes:
            np.testing.assert_allclose(p[n].numpy(), np.asarray(rp[n]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(st["v"][n].numpy(), np.asarray(rst["v"][n]),
                                       rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-6)
        assert int(st["count"]) == int(rst["count"]) == step + 1
    for s in (0, 1, 2, 4, 9):
        np.testing.assert_allclose(float(cosine_schedule(cfg, torch.tensor(s))),
                                   float(ref_cosine(rcfg, s)), rtol=1e-6)


def test_aggregate_with_erasures_degrades_when_all_miss():
    g1, g2 = {"w": torch.ones(3)}, {"w": 2 * torch.ones(3)}
    tel = Telemetry()
    out = aggregate_with_erasures([g1, g2], [5, 5], [False, False], telemetry=tel)
    assert torch.equal(out["w"], torch.zeros(3))
    assert tel.events[0]["event"] == "all_workers_missed_deadline"
    prev = {"w": 7 * torch.ones(3)}
    assert aggregate_with_erasures([g1, g2], [5, 5], [False, False],
                                   prev_grads=prev)["w"] is prev["w"]
    out = aggregate_with_erasures([g1, g2], [1, 3], [True, True])
    np.testing.assert_allclose(out["w"].numpy(), 1.75 * np.ones(3))


# --------------------------------------------------------- the coded step
def _trainers(tree, cluster_fleet=FLEET, steps=4, seed=1, eps=ADAM_EPS, **cfg_kw):
    """A reference trainer (its _mk of test_coded_train.py) and the port's twin."""
    rc = REF_ARCHS["qwen3-0.6b"].reduced()
    ref = RefTrainer(RefModel(rc), RefData(rc, RefShape("t", 32, 4, "train"), seed=seed),
                     RefAdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10, eps=eps),
                     RefTrainConfig(steps=steps, log_every=1,
                                    cluster=RefCluster.make(*cluster_fleet), **cfg_kw))
    c = ARCHS["qwen3-0.6b"].reduced()
    ours = Trainer(_port_model(tree),
                   SyntheticLMData(c, ShapeConfig("t", 32, 4, "train"), seed=seed,
                                   device="cpu"),
                   AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10, eps=eps),
                   TrainConfig(steps=steps, log_every=1,
                               cluster=ClusterSpec.make(*cluster_fleet), **cfg_kw))
    return ref, ours


def _inject_b(trainer, b):
    trainer.b_matrix = gc.assignment_matrix(*b.shape, b=b, device="cpu")
    trainer.coded_step_fn = make_coded_train_step_fn(
        trainer.model, trainer.opt_cfg, trainer.executor, trainer.b_matrix,
        trainer.partitions)


def _erased_worker_zero(ref, ours):
    wmask = np.ones(ref.executor.num_workers, bool)
    wmask[0] = False
    np.testing.assert_array_equal(ours.executor.slot_owner.numpy(),
                                  np.asarray(ref.executor.slot_owner))
    _inject_b(ours, np.asarray(ref.b_matrix, np.float32))
    return wmask


def test_coded_gradient_with_injected_mask_matches_reference(pair):
    """One worker erased: the port's single weighted backward == the
    reference's per-partition gradients contracted with a^T B / k
    (its own oracle in test_coded_train.py), default AdamW config."""
    ref_model, params, tree = pair
    ref, ours = _trainers(tree, eps=1e-8)
    wmask = _erased_worker_zero(ref, ours)
    k = ours.partitions
    rows = wmask[np.asarray(ref.executor.slot_owner)]
    a, ok = ref_gc.decode_vector(ref.b_matrix, rows)
    assert ok and not rows.all()
    w_ref = a @ np.asarray(ref.b_matrix)
    batch = {key: np.array(v) for key, v in ref.data.next_batch().items()}
    agg = None
    part_grad = jax.jit(jax.value_and_grad(ref_model.loss_fn, has_aux=True))
    for j in range(k):
        _, g = part_grad(
            params, {key: jnp.asarray(v.reshape(k, 1, -1)[j]) for key, v in batch.items()})
        term = jax.tree.map(lambda x: (w_ref[j] / k) * x.astype(jnp.float32), g)
        agg = term if agg is None else jax.tree.map(jnp.add, agg, term)

    a_t, ok_t = gc.decode_vector_torch(ours.b_matrix,
                                       ours.executor.slot_mask(torch.from_numpy(wmask)))
    w = (a_t @ ours.b_matrix) / k
    np.testing.assert_allclose(w.numpy() * k, w_ref, atol=1e-4)
    grads, loss_p, _ = train_loop.weighted_gradient(ours.model, _torch_batch(batch), w, k)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _leaf(agg, JAX_NAMES[name]), **STEP_TOL,
                                   err_msg=name)


def test_coded_step_with_injected_mask_matches_reference(pair):
    """The whole step (decode, gradient, AdamW) against the reference's
    jitted coded step with its finish mask patched to the same mask."""
    _, params, tree = pair
    ref, ours = _trainers(tree)
    wmask = _erased_worker_zero(ref, ours)
    ref.executor.finish_mask_jit = lambda key, deadline: jnp.asarray(wmask)
    ref._build_coded_step()
    batch = ref.data.next_batch()
    rp, _, rm = ref.coded_step_fn(jax.tree.map(jnp.asarray, tree),
                                  ref_adamw_init(ref.opt_cfg, params), batch, KEY,
                                  jnp.float32(ref.executor.deadline))
    _, st, _ = ours.init_or_restore()
    st, m = ours.coded_step_fn(st, _torch_batch({k: np.array(v) for k, v in batch.items()}),
                               torch.from_numpy(wmask))
    assert float(m["skipped"]) == float(rm["skipped"]) == 0.0
    for key in ("loss", "accuracy", "grad_norm", "lr", "survivors", "coded_rows_alive"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=2e-4, err_msg=key)
    for name, p in ours.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(rp, JAX_NAMES[name]),
                                   **STEP_TOL, err_msg=name)


def test_skip_step_is_bit_unchanged(pair):
    _, _, tree = pair
    c = ARCHS["qwen3-0.6b"].reduced()
    t = Trainer(_port_model(tree),
                SyntheticLMData(c, ShapeConfig("t", 32, 4, "train"), seed=1, device="cpu"),
                AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10),
                TrainConfig(steps=1, cluster=ClusterSpec.make(*FLEET)))
    _, st, _ = t.init_or_restore()
    st, _ = t.coded_step_fn(st, t.data.next_batch(),
                            t.executor.finish_mask(t.generator))  # a real step first
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    opt_before = {"m": {n: v.clone() for n, v in st["m"].items()},
                  "v": {n: v.clone() for n, v in st["v"].items()},
                  "count": st["count"].clone()}
    wmask = t.executor.finish_mask(t.generator, deadline=0.0)
    st2, m = t.coded_step_fn(st, t.data.next_batch(), wmask)
    assert float(m["skipped"]) == 1.0 and float(m["survivors"]) == 0.0
    assert float(m["grad_norm"]) == 0.0
    for n, p in t.model.named_parameters():
        assert torch.equal(p, before[n]), n
        assert torch.equal(st2["m"][n], opt_before["m"][n])
        assert torch.equal(st2["v"][n], opt_before["v"][n])
    assert torch.equal(st2["count"], opt_before["count"])


def test_three_step_run_matches_reference(pair):
    """Every worker meets the deadline: the same parameters and losses."""
    _, _, tree = pair
    ref, ours = _trainers(tree, steps=3)
    ref.executor.deadline = 1e9
    ours.executor.deadline = 1e9
    rp, _, rhist = ref.run()
    _, _, hist = ours.run()
    assert len(hist) == len(rhist) == 3
    for h, rh in zip(hist, rhist):
        np.testing.assert_allclose(h["loss"], rh["loss"], rtol=1e-5)
        assert h["skipped"] == rh["skipped"] == 0.0 and h["survivors"] == 4.0
    for name, p in ours.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(rp, JAX_NAMES[name]),
                                   **STEP_TOL, err_msg=name)
    assert len(ours.step_seconds) == 3


def test_trainer_rejects_bad_partitions(pair):
    _, _, tree = pair
    c = ARCHS["qwen3-0.6b"].reduced()
    with pytest.raises(ValueError, match="divide"):
        Trainer(_port_model(tree),
                SyntheticLMData(c, ShapeConfig("t", 8, 4, "train"), device="cpu"),
                AdamWConfig(), TrainConfig(cluster=ClusterSpec.make([2], [1.0]),
                                           partitions=3))


# ------------------------------------------------------------- checkpoints
def test_checkpoints_restore_across_packages(pair, tmp_path):
    _, params, tree = pair
    model = _port_model(tree)
    cfg = AdamWConfig()
    st = adamw_init(cfg, dict(model.named_parameters()))
    st["count"] = st["count"] + 3
    st["m"]["wq"] += 0.5
    like = {"params": params, "opt": ref_adamw_init(RefAdamWConfig(), params)}

    save_checkpoint(str(tmp_path / "ours"), 3, state_tree(model, st), {"data_step": 3})
    got, meta = ref_restore(str(tmp_path / "ours"), 3, like)
    assert meta["data_step"] == 3 and int(got["opt"]["count"]) == 3
    np.testing.assert_array_equal(_leaf(got, "params/embed/table"), tree["embed"]["table"])
    np.testing.assert_array_equal(_leaf(got, "opt/m/blocks/attn/wq"),
                                  st["m"]["wq"].numpy())

    ref_tree = jax.tree.map(np.asarray, like)
    ref_tree["opt"]["v"]["final_norm"]["scale"] = np.full_like(
        ref_tree["opt"]["v"]["final_norm"]["scale"], 2.5)
    ref_save(str(tmp_path / "ref"), 7, ref_tree, {"data_step": 9})
    assert latest_step(str(tmp_path / "ref")) == 7
    state, meta = restore_checkpoint(str(tmp_path / "ref"), 7,
                                     state_tree(Model(model.config, device="cpu"), st))
    assert meta["data_step"] == 9
    np.testing.assert_array_equal(state["params/blocks/mlp/w_up"].numpy(),
                                  tree["blocks"]["mlp"]["w_up"])
    assert bool((state["opt/v/final_norm/scale"] == 2.5).all())
    assert state["opt/count"].dtype == torch.int32 and int(state["opt/count"]) == 0


def test_trainer_resumes_from_its_checkpoint(pair, tmp_path):
    """Checkpoint at step 2 of 3, then a fresh trainer resumes the last step."""
    _, _, tree = pair
    c = ARCHS["qwen3-0.6b"].reduced()

    def trainer(steps):
        return Trainer(_port_model(tree),
                       SyntheticLMData(c, ShapeConfig("t", 16, 2, "train"), device="cpu"),
                       AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10),
                       TrainConfig(steps=steps, log_every=1, checkpoint_every=2,
                                   checkpoint_dir=str(tmp_path)))

    full = trainer(3)
    full.run()
    resumed = trainer(3)
    _, st, start = resumed.init_or_restore()
    assert start == 2 and int(st["count"]) == 2 and resumed.data.state()["step"] == 2
    _, _, hist = resumed.run()
    assert [h["step"] for h in hist] == [3]
    for (n, a), b in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n


# -------------------------------------------------------------------- CLI
def test_launch_train_reduced_on_cpu(capsys):
    model = train_cli.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                            "--steps", "2", "--seq-len", "16", "--batch", "4",
                            "--hetero-groups", "2:4.0,2:1.0"])
    out = capsys.readouterr().out
    assert "coded training: scheme=grad_coding k=4" in out and "loss" in out
    assert model.device.type == "cpu"
    with pytest.raises(SystemExit, match="hetero-groups"):
        train_cli.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                        "--partitions", "2"])


@pytest.mark.parametrize("entry", ["data", "cli"])
def test_training_entry_points_default_to_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = ARCHS["qwen3-0.6b"].reduced()
    call = {
        "data": lambda: SyntheticLMData(c, ShapeConfig("t", 8, 2, "train")),
        "cli": lambda: train_cli.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1"]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
