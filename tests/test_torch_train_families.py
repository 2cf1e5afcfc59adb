"""Port parity, training every family: vlm (paligemma-3b), audio
(whisper-tiny), hybrid (zamba2-1.2b), ssm (xlstm-125m, ``slstm_every=2``)
and the coded MoE step (moonshot-v1-16b-a3b), reduced, float32, the
reference's ``Model.init_params`` tree carried across with
``params_from_jax``.

* ``loss_fn``: the loss and every gradient leaf against ``jax.grad`` of
  the reference's (batch 2 x 32, some labels masked, seeded extras),
  rtol 2e-4, atol 2e-6 or 2e-5 of the leaf's largest gradient.
* One plain ``Trainer`` step against the reference's jitted
  ``make_train_step_fn`` (AdamW eps 1e-6, as ``test_torch_train.py``).
* The coded step of zamba, xlstm and moonshot against the reference's
  jitted coded step, its B injected and one worker erased; moonshot at
  the default ``capacity_factor``, where each partition's routing pool
  decides which entries are dropped (its aggregated gradient is held
  against the reference's per-partition gradients too).
* Checkpoints of an xLSTM (12 layers: list indices past 9): the saved
  paths, in order, are the reference's; a port checkpoint restores in the
  reference and a trainer resumes from its own.
* A coded trainer on a batch with extras raises the reference's message
  at ``run``; the training CLI trains every registered config; the zero
  image stub overflows an 18-layer vlm's gradient in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint.store import _flatten as ref_flatten
from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import ShapeConfig as RefShape
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.data import SyntheticLMData as RefData
from repro.models.model import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime.train_loop import TrainConfig as RefTrainConfig
from repro.runtime.train_loop import Trainer as RefTrainer
from repro.runtime.train_loop import make_train_step_fn as ref_train_step_fn
from repro_torch.checkpoint import save_checkpoint
from repro_torch.checkpoint.store import tree_order
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import gradient_coding as gc
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as train_cli
from repro_torch.models.model import Model, jax_path
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import train_loop
from repro_torch.runtime.train_loop import (
    TrainConfig,
    Trainer,
    make_coded_train_step_fn,
    state_tree,
)

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
FLEET = ([2, 2], [4.0, 1.0])
#: gradients: rtol 2e-4 and atol 2e-6, or 2e-5 of the leaf's largest |g|
#: where that is more: float32 sums carry about 1e-5 of a leaf's scale
#: (xlstm's embedding gradient reaches 1.0, where 2e-6 is 2 ulp-scale sums)
GRAD_RTOL, GRAD_ATOL, GRAD_SCALE = 2e-4, 2e-6, 2e-5
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
#: AdamW eps of the plain whole-step comparisons (``test_torch_train.py``'s)
ADAM_EPS = 1e-6
#: and of the coded ones. Adam's first update is lr g / (|g| + eps): a
#: coded step's gradient is a weighted sum of k partitions' and carries
#: float32 noise of about 1e-5 of a leaf's largest |g| (0.65 for zamba's
#: embedding), so an entry whose gradient is that small moves by a large
#: share of lr on noise at 1e-6. At 1e-4 the update is Lipschitz in g at
#: that scale; the MoE's aggregated gradient itself is held below.
CODED_EPS = 1e-4
VLM = ("paligemma-3b", {})
AUDIO = ("whisper-tiny", {})
HYBRID = ("zamba2-1.2b", {})
XLSTM = ("xlstm-125m", {"slstm_every": 2})  # layers 2 and 4 are sLSTM
MOE = ("moonshot-v1-16b-a3b", {})
FAMILIES = [VLM, AUDIO, HYBRID, XLSTM]
IDS = ["paligemma", "whisper", "zamba2", "xlstm"]


@pytest.fixture(scope="module")
def pairs():
    """Memoised (reference model, params, port config) per (arch, changes)."""
    memo = {}

    def get(name, changes):
        key = (name, tuple(sorted(changes.items())))
        if key not in memo:
            ref = RefModel(dataclasses.replace(REF_ARCHS[name].reduced(), **changes))
            params = jax.block_until_ready(jax.jit(ref.init_params)(KEY))
            memo[key] = ref, params, dataclasses.replace(ARCHS[name].reduced(), **changes)
        return memo[key]

    return get


def _port(cfg, params) -> Model:
    return Model(cfg, device="cpu").params_from_jax(jax.tree.map(np.asarray, params))


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[int(key) if isinstance(tree, (list, tuple)) else key]
    return np.asarray(tree, np.float32)


def _batch(cfg, batch=2, seq=32, seed=1):
    """Seeded tokens and labels (a few masked) and, for vlm and audio,
    seeded random extras: (port batch, reference batch)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    b["labels"][0, :5] = -1
    ours = {k: torch.from_numpy(v) for k, v in b.items()}
    ref = {k: jnp.asarray(v) for k, v in b.items()}
    key, length = {"vlm": ("image_embeds", cfg.num_image_tokens),
                   "audio": ("frames", cfg.encoder_seq)}.get(cfg.family, (None, 0))
    if key is not None:
        x = rng.standard_normal((batch, length, cfg.d_model)).astype(np.float32)
        ours["extras"] = {key: torch.from_numpy(x)}
        ref["extras"] = {key: jnp.asarray(x)}
    return ours, ref


def _opt(eps=ADAM_EPS):
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, eps=eps)
    return AdamWConfig(**kw), RefAdamWConfig(**kw)


@pytest.fixture(scope="module")
def ref_steps(pairs):
    """Memoised per arch, on ``_batch``'s batch: the reference's
    ``value_and_grad(loss_fn)`` and its ``make_train_step_fn`` step from
    fresh AdamW state, in one jitted program."""
    memo = {}

    def get(arch):
        if arch[0] not in memo:
            ref, params, cfg = pairs(*arch)
            _, ref_opt = _opt()
            step = ref_train_step_fn(ref, ref_opt)

            def both(p, b):
                return (jax.value_and_grad(ref.loss_fn, has_aux=True)(p, b),
                        step(p, ref_adamw_init(ref_opt, p), b))

            memo[arch[0]] = jax.jit(both)(params, _batch(cfg)[1])
        return memo[arch[0]]

    return get


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("arch", FAMILIES, ids=IDS)
def test_loss_fn_gradients_match_reference(pairs, ref_steps, arch):
    """Loss, accuracy and every gradient leaf, masked labels and seeded
    extras included: the recurrences' and the encoder's backward."""
    _, params, cfg = pairs(*arch)
    ours = _port(cfg, params)
    b, _ = _batch(cfg)
    ((want, wm), wg), _ = ref_steps(arch)
    loss, metrics = ours.loss_fn(b)
    named = dict(ours.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(wm["accuracy"]), atol=1e-7)
    for name, g in zip(named, grads):
        assert bool(torch.isfinite(g).all()), name
        want = _leaf(wg, jax_path(name))
        atol = max(GRAD_ATOL, GRAD_SCALE * float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_RTOL, atol=atol, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES, ids=IDS)
def test_plain_trainer_step_matches_reference(pairs, ref_steps, arch):
    """``Trainer``'s plain step (gradient, AdamW, parameters in place)
    against the reference's ``make_train_step_fn`` on the same batch."""
    _, params, cfg = pairs(*arch)
    opt, _ = _opt()
    b, _ = _batch(cfg)
    _, (rp, _, rm) = ref_steps(arch)
    data = SyntheticLMData(cfg, ShapeConfig("t", 32, 2, "train"), device="cpu")
    trainer = Trainer(_port(cfg, params), data, opt, TrainConfig(steps=1))
    _, st, _ = trainer.init_or_restore()
    st, m = trainer.step_fn(st, b)
    assert int(st["count"]) == 1
    for key in ("loss", "accuracy", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key].detach()), float(rm[key]), rtol=2e-4,
                                   err_msg=key)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(rp, jax_path(name)),
                                   **STEP_TOL, err_msg=name)


# ------------------------------------------------------------ coded step
def _coded_pair(pairs, arch, batch, k, eps=CODED_EPS):
    """The reference's coded trainer (its finish mask patched to worker 0
    erased, rebuilt) and the port's with the reference's B injected."""
    ref_model, params, cfg = pairs(*arch)
    opt, ref_opt = _opt(eps)
    rc = ref_model.config
    ref = RefTrainer(ref_model, RefData(rc, RefShape("t", 32, batch, "train"), seed=1), ref_opt,
                     RefTrainConfig(steps=1, cluster=RefCluster.make(*FLEET), partitions=k))
    ours = Trainer(_port(cfg, params),
                   SyntheticLMData(cfg, ShapeConfig("t", 32, batch, "train"), device="cpu"),
                   opt, TrainConfig(steps=1, cluster=ClusterSpec.make(*FLEET), partitions=k))
    wmask = np.ones(ref.executor.num_workers, bool)
    wmask[0] = False
    np.testing.assert_array_equal(ours.executor.slot_owner.numpy(),
                                  np.asarray(ref.executor.slot_owner))
    ours.b_matrix = gc.assignment_matrix(*ref.b_matrix.shape,
                                         b=np.asarray(ref.b_matrix, np.float32), device="cpu")
    ours.coded_step_fn = make_coded_train_step_fn(ours.model, ours.opt_cfg, ours.executor,
                                                  ours.b_matrix, k)
    ref.executor.finish_mask_jit = lambda key, deadline: jnp.asarray(wmask)
    ref._build_coded_step()
    return ref, ours, params, wmask


@pytest.mark.parametrize("arch,batch,k", [(HYBRID, 4, 4), (XLSTM, 4, 4), (MOE, 8, 4)],
                         ids=["zamba2", "xlstm", "moonshot"])
def test_coded_step_with_one_worker_erased_matches_reference(pairs, arch, batch, k):
    """The whole coded step (decode, the weighted backward, AdamW) against
    the reference's jitted coded step with the same mask and B. For the
    MoE at ``capacity_factor`` 1.25 this holds only when each partition
    is routed as its own pool, as the reference's vmap routes it."""
    ref, ours, params, wmask = _coded_pair(pairs, arch, batch, k)
    b, rb = _batch(ours.model.config, batch=batch, seed=3)
    # the reference's coded step donates its parameters: give it a copy
    rp, _, rm = ref.coded_step_fn(jax.tree.map(jnp.copy, params),
                                  ref_adamw_init(ref.opt_cfg, params), rb, KEY,
                                  jnp.float32(ref.executor.deadline))
    _, st, _ = ours.init_or_restore()
    st, m = ours.coded_step_fn(st, b, torch.from_numpy(wmask))
    assert float(m["skipped"]) == float(rm["skipped"]) == 0.0
    assert float(m["coded_rows_alive"]) < ref.b_matrix.shape[0]
    for key in ("loss", "accuracy", "grad_norm", "lr", "survivors", "coded_rows_alive"):
        np.testing.assert_allclose(float(m[key].detach()), float(rm[key]), rtol=2e-4,
                                   err_msg=key)
    for name, p in ours.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(rp, jax_path(name)),
                                   **STEP_TOL, err_msg=name)


def test_coded_moe_gradient_routes_each_partition_as_its_own_pool(pairs):
    """The aggregated coded gradient of the MoE model at the default
    ``capacity_factor`` against the reference's per-partition gradients
    contracted with a^T B / k (its own oracle), every leaf; and the
    grouped routing itself: each pool's capacity, kept mask and slots
    equal one ``route`` call of that pool, offset by its rows."""
    from repro_torch.core.gradient_coding import decode_vector_torch
    from repro_torch.models import moe

    ref, ours, params, wmask = _coded_pair(pairs, MOE, 8, 4, eps=1e-8)
    k = ours.partitions
    b, rb = _batch(ours.model.config, batch=8, seed=3)
    rows = wmask[np.asarray(ref.executor.slot_owner)]
    a, ok = decode_vector_torch(ours.b_matrix, torch.from_numpy(rows))
    w = (a @ ours.b_matrix) / k
    grads, _, _ = train_loop.weighted_gradient(ours.model, b, w, k)
    part_grad = jax.jit(jax.value_and_grad(ref.model.loss_fn, has_aux=True))
    agg = None
    for j in range(k):
        _, g = part_grad(params, {key: v.reshape(k, -1, v.shape[-1])[j]
                                  for key, v in rb.items()})
        term = jax.tree.map(lambda x: (float(w[j]) * x).astype(jnp.float32), g)
        agg = term if agg is None else jax.tree.map(jnp.add, agg, term)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _leaf(agg, jax_path(name)), **STEP_TOL,
                                   err_msg=name)

    c = ours.model.config
    xf = torch.from_numpy(np.random.default_rng(5).standard_normal((4 * 24, c.d_model))
                          .astype(np.float32))
    kw = dict(num_experts=c.num_experts, top_k=c.top_k)
    r = moe.route(ours.model.w_router[0].detach(), xf, groups=4, **kw)
    slot_of = torch.empty_like(r.slot)
    slot_of[r.order] = r.slot  # by (token, slot) entry
    trash, dropped = c.num_experts * r.rows, 0
    for g in range(4):
        one = moe.route(ours.model.w_router[0].detach(), xf[24 * g: 24 * (g + 1)], **kw)
        assert one.cap == r.cap
        mine = slot_of[24 * c.top_k * g: 24 * c.top_k * (g + 1)]
        theirs = torch.empty_like(one.slot)
        theirs[one.order] = one.slot
        kept = theirs < c.num_experts * one.cap
        dropped += int((~kept).sum())
        want = (theirs // one.cap * 4 + g) * one.cap + theirs % one.cap
        assert torch.equal(mine, torch.where(kept, want, torch.full_like(want, trash)))
    assert dropped > 0  # the pools drop entries at cf 1.25


# ---------------------------------------------------------- checkpoints
def test_xlstm_checkpoint_paths_and_round_trip(pairs, tmp_path):
    """A 12-layer xLSTM (sLSTM at 6 and 12): ``state_tree``'s paths in
    checkpoint order are the reference checkpoint's names (list indices
    in index order: ``blocks/10`` after ``blocks/9``); a port checkpoint
    restores in the reference; a trainer saves and resumes its own."""
    ref, params, cfg = pairs("xlstm-125m", {"num_layers": 12, "slstm_every": 6})
    ours = _port(cfg, params)
    opt, ref_opt = _opt()
    st = adamw_init(opt, dict(ours.named_parameters()))
    st["m"]["cells.10.b_f"] += 0.5
    state = state_tree(ours, st)
    like = {"params": params, "opt": ref_adamw_init(ref_opt, params)}
    names, _, _, _ = ref_flatten(like)
    assert tree_order(state) == names

    save_checkpoint(str(tmp_path / "ours"), 2, state, {"data_step": 2})
    got, meta = ref_restore(str(tmp_path / "ours"), 2, like)
    assert meta["data_step"] == 2
    np.testing.assert_array_equal(_leaf(got, "params/blocks/10/cell/wq"),
                                  ours.cells[10]["wq"].detach().numpy())
    np.testing.assert_array_equal(_leaf(got, "opt/m/blocks/10/cell/b_f"),
                                  st["m"]["cells.10.b_f"].numpy())

    def trainer(steps):
        data = SyntheticLMData(cfg, ShapeConfig("t", 8, 2, "train"), device="cpu")
        return Trainer(_port(cfg, params), data, opt,
                       TrainConfig(steps=steps, log_every=1, checkpoint_every=1,
                                   checkpoint_dir=str(tmp_path / "run")))

    first = trainer(1)
    _, st1, _ = first.run()
    resumed = trainer(2)
    _, st2, start = resumed.init_or_restore()
    assert start == 1 and int(st2["count"]) == 1 and resumed.data.state()["step"] == 1
    for (n, a), b in zip(first.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n
    for n in st1["m"]:
        assert torch.equal(st1["m"][n], st2["m"][n]) and torch.equal(st1["v"][n], st2["v"][n])
    _, _, hist = resumed.run()
    assert [h["step"] for h in hist] == [2]


def test_zero_image_stub_overflows_the_gradient_in_both_packages():
    """``make_extras``' zero image embeddings stay exactly zero through
    every layer, and each RMSNorm of a zero row scales its gradient by
    1 / sqrt(eps): at paligemma-3b's 18 layers the gradient overflows
    float32 in the reference and in the port alike (the 4-layer reduced
    config stays finite), which is why the card trains the vlm on random
    embeddings."""
    from repro.data.pipeline import make_extras as ref_make_extras

    rc = dataclasses.replace(REF_ARCHS["paligemma-3b"].reduced(), num_layers=18)
    ref = RefModel(rc)
    params = jax.jit(ref.init_params)(KEY)
    cfg = dataclasses.replace(ARCHS["paligemma-3b"].reduced(), num_layers=18)
    b, rb = _batch(cfg)
    rb["extras"] = ref_make_extras(rc, 2)
    b["extras"] = {"image_embeds": torch.zeros(tuple(rb["extras"]["image_embeds"].shape))}
    _, wg = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(params, rb)
    ours = _port(cfg, params)
    loss, _ = ours.loss_fn(b)
    grads = torch.autograd.grad(loss, list(ours.parameters()))
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(wg))
    assert not all(bool(torch.isfinite(g).all()) for g in grads)
    b["extras"] = {"image_embeds": torch.randn(b["extras"]["image_embeds"].shape,
                                               generator=torch.Generator().manual_seed(0))}
    loss, _ = ours.loss_fn(b)
    assert all(bool(torch.isfinite(g).all())
               for g in torch.autograd.grad(loss, list(ours.parameters())))


# ------------------------------------------------------- extras, the CLI
@pytest.mark.parametrize("arch", [VLM, AUDIO], ids=["paligemma", "whisper"])
def test_coded_training_with_extras_raises_at_the_step(pairs, arch):
    """Both packages build a coded vlm / audio trainer and raise the same
    ``NotImplementedError`` from ``run``, at the first step."""
    ref_model, params, cfg = pairs(*arch)
    opt, ref_opt = _opt()
    ref = RefTrainer(ref_model, RefData(ref_model.config, RefShape("t", 8, 2, "train")), ref_opt,
                     RefTrainConfig(steps=1, cluster=RefCluster.make(*FLEET), partitions=2))
    ours = Trainer(_port(cfg, params),
                   SyntheticLMData(cfg, ShapeConfig("t", 8, 2, "train"), device="cpu"), opt,
                   TrainConfig(steps=1, cluster=ClusterSpec.make(*FLEET), partitions=2))
    with pytest.raises(NotImplementedError) as want:
        ref.run()
    with pytest.raises(NotImplementedError) as got:
        ours.run()
    assert str(got.value) == str(want.value)
    assert ours.step_seconds == []


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cli_trains_every_registered_config(name, capsys):
    """``launch/train.py --reduced --device cpu``: every registered config
    trains a plain step and a coded one; coded vlm and audio exit
    non-zero with the reference's extras message."""
    cfg = ARCHS[name].reduced()
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--steps", "1",
            "--seq-len", "16", "--batch", "2"]
    model = train_cli.main(argv)
    out = capsys.readouterr().out
    assert f"training {cfg.name}:" in out and "loss " in out
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    coded = argv + ["--hetero-groups", "1:4.0,1:1.0"]
    if cfg.family in ("vlm", "audio"):
        with pytest.raises(SystemExit,
                           match="^coded training does not partition family extras yet$"):
            train_cli.main(coded)
        return
    train_cli.main(coded)
    out = capsys.readouterr().out
    assert "coded training: scheme=grad_coding k=2" in out and "skipped steps" in out
