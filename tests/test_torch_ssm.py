"""Port parity, the recurrent families: hybrid (zamba2-1.2b: Mamba2 and a
shared attention block) and ssm (xlstm-125m: mLSTM and sLSTM), reduced,
float32, the reference's ``Model.init_params`` tree carried across with
``params_from_jax``.

* ``models/ssm.py`` on the same seeded inputs: the causal conv with and
  without its history, ``mamba2`` chunked (S 48 at chunk 16, so the
  recurrence over chunk states runs) and stepped (output and both
  states), to 1e-5 relative to max|y|; the chunked form's gradient is
  finite (the upper triangle of ``_segsum`` is masked before its exp).
* ``models/xlstm.py``: ``mlstm`` and ``slstm`` over a sequence and
  stepped with their states, to 1e-5.
* ``Model`` for both configs (the xLSTM with ``slstm_every=2``: its
  reduced variant's four layers hold no sLSTM at the config's 6):
  ``lm_logits``, ``loss_fn`` and ``decode_step`` (logits 2e-4, states
  1e-5), ``Server.generate`` through the coded head (the sequential
  prefill; the reference's tokens exactly), and the port's own
  invariant: ``lm_logits`` equals the stepped ``decode_step``.
* Every registered config builds reduced, with the reference's parameter
  count; the slot and paged paths refuse hybrid and ssm with the
  reference's message, and ``Trainer`` refuses both by name.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
from repro.models.model import Model as RefModel
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import ssm, xlstm
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.serve_loop import ServeConfig, Server
from repro_torch.runtime.train_loop import TrainConfig, Trainer
from test_torch_families import _slot_and_paged_calls

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
FLEET = ([2, 2], [4.0, 0.8])
HYBRID = ("zamba2-1.2b", {})
XLSTM = ("xlstm-125m", {"slstm_every": 2})  # layers 2 and 4 are sLSTM


@pytest.fixture(scope="module")
def pairs():
    """Memoised (reference model, params, port model, jitted reference
    ``decode_step``) per (arch, changes)."""
    memo = {}

    def get(name, changes):
        key = (name, tuple(sorted(changes.items())))
        if key not in memo:
            ref = RefModel(dataclasses.replace(REF_ARCHS[name].reduced(), **changes))
            params = jax.block_until_ready(jax.jit(ref.init_params)(KEY))
            ours = Model(dataclasses.replace(ARCHS[name].reduced(), **changes), device="cpu")
            ours.params_from_jax(jax.tree.map(np.asarray, params))
            memo[key] = ref, params, ours, jax.jit(ref.decode_step)
        return memo[key]

    return get


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return {n: torch.from_numpy(np.array(v)) for n, v in tree.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _rel(got, want, rel=1e-5):
    """Within ``rel`` of max|want|, elementwise."""
    want = np.asarray(want, np.float32)
    _close(got, want, dict(rtol=0, atol=rel * float(np.abs(want).max())))


def _tokens(batch, s, seed):
    return np.random.default_rng(seed).integers(0, 512, (batch, s)).astype(np.int32)


# ---------------------------------------------------------------- mamba2
D, N, EXPAND, HD = 64, 16, 2, 32
MAMBA_KW = dict(d_state=N, expand=EXPAND, head_dim=HD)


def _mamba_params():
    p = ref_ssm.init_mamba2(jax.random.PRNGKey(3), D, N, jnp.float32, expand=EXPAND,
                            head_dim=HD)
    # a non-zero conv bias and spread decays, so every term is exercised
    rng = np.random.default_rng(4)
    p = dict(_np(p), conv_b=rng.standard_normal(p["conv_b"].shape).astype(np.float32) / 4,
             d_skip=(1 + rng.standard_normal(p["d_skip"].shape) / 2).astype(np.float32))
    return p


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((ssm.CONV_K, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    want, _ = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got, none = ssm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert none is None
    _close(got, want, STATE_TOL)
    hist = rng.standard_normal((2, ssm.CONV_K - 1, 24)).astype(np.float32)
    want, wstate = ref_ssm._causal_conv(jnp.asarray(x[:, :1]), jnp.asarray(w),
                                        jnp.asarray(b), jnp.asarray(hist))
    got, state = ssm._causal_conv(*map(torch.from_numpy, (x[:, :1], w, b, hist)))
    _close(got, want, STATE_TOL)
    _close(state, wstate, STATE_TOL)


@pytest.mark.parametrize("s", [48, 16])  # three chunks of 16, and one
def test_mamba2_chunked_matches_reference(s):
    p = _mamba_params()
    x = np.random.default_rng(s).standard_normal((2, s, D)).astype(np.float32)
    want = jax.jit(lambda p_, x_: ref_ssm.mamba2(p_, x_, chunk=16, **MAMBA_KW))(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    got = ssm.mamba2(_t(p), torch.from_numpy(x), chunk=16, **MAMBA_KW)
    _rel(got, want)


def test_mamba2_stepped_matches_reference_and_the_chunked_form():
    """Twelve one-token steps from the zero state: each output, then the ssm
    and conv states, against the reference's; and the outputs against the
    chunked form over the same twelve tokens (at chunk 4)."""
    p = _mamba_params()
    rp, tp = {n: jnp.asarray(v) for n, v in p.items()}, _t(p)
    x = np.random.default_rng(6).standard_normal((2, 12, D)).astype(np.float32)
    rstate = ref_ssm.init_mamba2_state(2, D, N, jnp.float32, expand=EXPAND, head_dim=HD)
    state = ssm.init_mamba2_state(2, D, N, torch.float32, expand=EXPAND, head_dim=HD)
    step = jax.jit(lambda st, xt: ref_ssm.mamba2(rp, xt, state=st, **MAMBA_KW))
    ys = []
    for t in range(12):
        want, rstate = step(rstate, jnp.asarray(x[:, t:t + 1]))
        got, state = ssm.mamba2(tp, torch.from_numpy(x[:, t:t + 1]), state=state, **MAMBA_KW)
        _rel(got, want)
        ys.append(got)
    _rel(state["ssm"], rstate["ssm"])
    _close(state["conv"], rstate["conv"], STATE_TOL)
    assert state["ssm"].dtype == torch.float32
    _rel(torch.cat(ys, 1), ssm.mamba2(tp, torch.from_numpy(x), chunk=4, **MAMBA_KW).numpy())


def test_mamba2_chunked_gradient_is_finite():
    """The masked upper triangle of ``_segsum`` (-inf before the exp) leaves
    no NaN in the value or in any gradient."""
    tp = {n: v.requires_grad_() for n, v in _t(_mamba_params()).items()}
    x = torch.randn((2, 32, D), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = ssm.mamba2(tp, x, chunk=16, **MAMBA_KW)
    y.square().sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(x.grad).all()
    assert all(torch.isfinite(v.grad).all() for v in tp.values())
    seg = ssm._segsum(torch.randn(3, 5))
    assert torch.isinf(seg.triu(1)[seg.triu(1) != 0]).all() and torch.isfinite(seg.tril()).all()


# ----------------------------------------------------------------- xLSTM
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_xlstm_cells_match_reference(cell):
    """A 10-token sequence, then the same tokens stepped with the state:
    outputs and the final state to 1e-5."""
    d, h = 64, 4
    key = jax.random.PRNGKey(7)
    if cell == "mlstm":
        p = _np(ref_xlstm.init_mlstm(key, d, h, jnp.float32, 2.0))
        p["b_i"] = np.linspace(-1.0, 1.0, h).astype(np.float32)  # non-zero input gates
        rfn, fn = ref_xlstm.mlstm, xlstm.mlstm
        kw = dict(num_heads=h, proj_factor=2.0)
        rstate = ref_xlstm.init_mlstm_state(2, d, h, 2.0)
        state = xlstm.init_mlstm_state(2, d, h, 2.0)
    else:
        p = _np(ref_xlstm.init_slstm(key, d, h, jnp.float32))
        rfn, fn = ref_xlstm.slstm, xlstm.slstm
        kw = dict(num_heads=h)
        rstate = ref_xlstm.init_slstm_state(2, d, h)
        state = xlstm.init_slstm_state(2, d, h)
    rp, tp = {n: jnp.asarray(v) for n, v in p.items()}, _t(p)
    x = np.random.default_rng(8).standard_normal((2, 10, d)).astype(np.float32)
    _close(fn(tp, torch.from_numpy(x), **kw),
           jax.jit(lambda x_: rfn(rp, x_, **kw))(jnp.asarray(x)), STATE_TOL)
    step = jax.jit(lambda st, xt: rfn(rp, xt, state=st, **kw))
    for t in range(10):
        want, rstate = step(rstate, jnp.asarray(x[:, t:t + 1]))
        got, state = fn(tp, torch.from_numpy(x[:, t:t + 1]), state=state, **kw)
        _close(got, want, STATE_TOL)
    assert set(state) == set(rstate)
    for n in state:
        _close(state[n], rstate[n], STATE_TOL)


# ----------------------------------------------------------------- Model
def _ref_cache_leaves(cache):
    """The reference decode cache as the port lays it out."""
    if "xlstm" in cache:
        return {f"xlstm/{i}/{n}": v for i, st in enumerate(cache["xlstm"])
                for n, v in st.items()}
    return {**{n: v for n, v in cache["kv"].items()}, "ssm": cache["ssm"],
            "conv": cache["conv"]}


def _cache_leaves(cache):
    if "xlstm" in cache:
        return {f"xlstm/{i}/{n}": v for i, st in enumerate(cache["xlstm"])
                for n, v in st.items()}
    return cache


@pytest.mark.parametrize("arch", [HYBRID, XLSTM], ids=["zamba2", "xlstm"])
def test_lm_logits_loss_and_decode_step_match_reference(pairs, arch):
    """48 tokens (three mamba chunks of 16) of logits and the loss, then
    eight decode steps: logits, and every state of the cache after them."""
    ref, params, ours, step = pairs(*arch)
    toks = _tokens(2, 48, 1)
    with torch.no_grad():
        _close(ours.lm_logits(torch.from_numpy(toks)),
               jax.jit(ref.lm_logits)(params, jnp.asarray(toks)), LOGITS_TOL)
        labels = np.roll(toks, -1, 1)
        labels[0, :5] = -1
        got, _ = ours.loss_fn({"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    want, _ = jax.jit(ref.loss_fn)(params, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    rcache, cache = ref.init_cache(2, 16), ours.init_cache(2, 16)
    for t in range(8):
        want, rcache = step(params, rcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        got, cache = ours.decode_step(cache, torch.from_numpy(toks[:, t]), t)
        _close(got, want, LOGITS_TOL)
    rleaves, leaves = _ref_cache_leaves(rcache), _cache_leaves(cache)
    assert set(leaves) == set(rleaves)
    for n, v in leaves.items():
        assert tuple(v.shape) == np.shape(rleaves[n]), n
        if n == "pos":
            np.testing.assert_array_equal(v.numpy(), np.asarray(rleaves[n]))
        else:
            _close(v, rleaves[n], STATE_TOL)
    if ours.config.family == "hybrid":
        assert ours.n_shared_attn_calls() == ref.n_shared_attn_calls() == 2
        assert cache["k"].shape[0] == 2 and cache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("arch", [HYBRID, XLSTM], ids=["zamba2", "xlstm"])
def test_generate_matches_reference(pairs, arch):
    """Coded generate through the sequential prefill (no batched prefill for
    these families, in either package): the reference's tokens exactly,
    every round decoded with no erasure."""
    ref, params, ours, _ = pairs(*arch)
    refsrv = RefServer(ref, params, RefCluster.make(*FLEET),
                       RefServeConfig(block_rows=64, deadline_safety=50.0))
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    server.coded_head.refresh(np.asarray(refsrv.coded_head.generator))
    refsrv.coded_head.deadline = server.coded_head.deadline = 1e9
    assert not server._can_batch_prefill() and not refsrv._can_batch_prefill()
    prompts = _tokens(2, 6, 2)
    want = refsrv.generate(jnp.asarray(prompts), 4)
    rounds = []
    got = server.generate(prompts, 4, observe=lambda step, lg, sel, ok, mask:
                          rounds.append(bool(ok) and bool(mask.all())))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == [True] * 4


@pytest.mark.parametrize("arch", [HYBRID, XLSTM], ids=["zamba2", "xlstm"])
def test_decode_matches_prefill(pairs, arch):
    """The reference's ``test_decode_matches_prefill`` on the port: 16
    stepped ``decode_step`` logits equal ``lm_logits`` over the sequence."""
    _, _, ours, _ = pairs(*arch)
    toks = torch.from_numpy(_tokens(2, 16, 3))
    with torch.no_grad():
        full = ours.lm_logits(toks)
    cache = ours.init_cache(2, 16)
    stepped = torch.stack([ours.decode_step(cache, toks[:, t], t)[0] for t in range(16)], 1)
    _close(stepped, full.numpy(), LOGITS_TOL)


# ------------------------------------------------- configs and refusals
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_registered_config_builds_with_the_reference_count(name):
    ours = Model(ARCHS[name].reduced(), device="cpu")
    assert ours.param_count() == RefModel(REF_ARCHS[name].reduced()).param_count()


@pytest.mark.parametrize("arch", [HYBRID, XLSTM], ids=["zamba2", "xlstm"])
def test_slot_paged_and_training_refusals(pairs, arch):
    """Every slot and paged entry point refuses with the reference's message
    (``Server.serve`` with it); ``Trainer`` trains the family now, plain
    and coded, one finite step each."""
    ref, _, ours, _ = pairs(*arch)
    with pytest.raises(NotImplementedError) as want:
        ref.init_slot_cache(2, 8)
    assert repr(ours.config.family) in str(want.value)
    for name, call in _slot_and_paged_calls(ours).items():
        with pytest.raises(NotImplementedError) as got:
            call()
        assert str(got.value) == str(want.value), name
    for cluster in (None, ClusterSpec.make(*FLEET)):
        data = SyntheticLMData(ours.config, ShapeConfig("t", 16, 2, "train"), device="cpu")
        _, _, hist = Trainer(ours, data, AdamWConfig(),
                             TrainConfig(steps=1, cluster=cluster, partitions=2)).run()
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
