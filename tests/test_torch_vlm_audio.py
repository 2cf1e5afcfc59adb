"""Port parity, the GELU MLP (C1), vlm (paligemma-3b) and audio
(whisper-tiny), reduced, float32, the reference's ``Model.init_params``
tree carried across with ``params_from_jax``.

* Layers on the same seeded inputs: the plain GELU MLP (tanh
  approximation, as ``jax.nn.gelu``) and ``layernorm`` to 1e-6; cross
  attention (K/V from ``xkv`` at ``kv_positions``, padded keys masked) and
  attention / ``decode_attention`` without rope to 1e-5.
* C1: a dense config with ``activation="gelu"`` builds ``w_up`` /
  ``w_down`` only and matches the reference's logits and a decode step
  (2e-4); ``params_from_jax`` raises on a leaf missing or left over,
  naming its path.
* vlm with seeded random image embeddings: ``lm_logits``, ``loss_fn``
  (2e-4) and ``decode_step`` (text only); the image prefix changes the
  logits; ``Server.generate`` and the paged and dense ``serve`` against
  the reference's (injected G, a deadline no worker misses): tokens and
  streams exact.
* audio with seeded random frames: ``encode`` (1e-5), ``lm_logits``,
  ``loss_fn``, ``decode_step`` from ``init_cache(extras={"enc_out"})``
  (2e-4), ``generate`` (tokens exact), and the port's own invariant:
  ``lm_logits`` equals the stepped ``decode_step``.
* ``make_extras`` is the reference's stub; the slot and paged paths
  refuse audio with the reference's message, and ``Trainer`` refuses
  both families' batches with extras.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.data.pipeline import make_extras as ref_make_extras
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.model import Model as RefModel
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
import repro.serve.workload as ref_wl
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.data.pipeline import SyntheticLMData, make_extras
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.serve_loop import ServeConfig, Server
from repro_torch.runtime.train_loop import TrainConfig, Trainer
import repro_torch.serve.workload as wl
from test_torch_families import _ref_streams

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
FLEET = ([2, 2], [4.0, 0.8])
VLM, AUDIO = "paligemma-3b", "whisper-tiny"
GELU_DENSE = ("qwen3-0.6b", {"activation": "gelu"})


@pytest.fixture(scope="module")
def pairs():
    """Memoised (reference model, params, port model) per (arch, changes)."""
    memo = {}

    def get(name, **changes):
        key = (name, tuple(sorted(changes.items())))
        if key not in memo:
            ref = RefModel(dataclasses.replace(REF_ARCHS[name].reduced(), **changes))
            params = jax.block_until_ready(jax.jit(ref.init_params)(KEY))
            ours = Model(dataclasses.replace(ARCHS[name].reduced(), **changes), device="cpu")
            ours.params_from_jax(jax.tree.map(np.asarray, params))
            memo[key] = ref, params, ours
        return memo[key]

    return get


@pytest.fixture(scope="module")
def steps():
    """One jitted reference ``decode_step`` per reference model."""
    memo = {}

    def get(ref):
        if id(ref) not in memo:
            memo[id(ref)] = jax.jit(ref.decode_step)
        return memo[id(ref)]

    return get


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _extras(cfg, batch, seed):
    """Seeded random extras (not zeros): the port's and the reference's."""
    key, length = {"vlm": ("image_embeds", cfg.num_image_tokens),
                   "audio": ("frames", cfg.encoder_seq)}[cfg.family]
    x = np.random.default_rng(seed).standard_normal((batch, length, cfg.d_model))
    x = x.astype(np.float32)
    return {key: torch.from_numpy(x)}, {key: jnp.asarray(x)}


def _tokens(batch, s, seed):
    return np.random.default_rng(seed).integers(0, 512, (batch, s)).astype(np.int32)


# --------------------------------------------------------------- layers
def test_gelu_mlp_and_layernorm_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w_up = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    w_down = (rng.standard_normal((96, 64)) / 10).astype(np.float32)
    want = ref_layers.mlp({"w_up": jnp.asarray(w_up), "w_down": jnp.asarray(w_down)},
                          jnp.asarray(x))
    got = L.mlp(None, torch.from_numpy(w_up), torch.from_numpy(w_down), torch.from_numpy(x))
    _close(got, want, dict(rtol=1e-6, atol=1e-6))
    scale = (1 + rng.standard_normal(64) / 4).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    x = 3 + 2 * x  # a mean and a spread the norm must remove
    want = ref_layers.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                jnp.asarray(x))
    got = L.layernorm(torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(x))
    _close(got, want, dict(rtol=1e-6, atol=1e-6))


def _attn_params(rng, d, h, kv, hd):
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("s,skv,qb,kb", [(8, 8, 8, 8), (5, 13, 4, 8), (1, 32, 1, 32)])
def test_cross_attention_matches_reference(s, skv, qb, kb):
    """Q from x, K/V from xkv at their own positions, non-causal, no rope;
    the padded queries and keys (S, Skv not multiples of the blocks) masked."""
    rng = np.random.default_rng(s + skv)
    p = _attn_params(rng, 32, 4, 2, 8)
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    xkv = rng.standard_normal((2, skv, 32)).astype(np.float32)
    pos, kv_pos = np.arange(s, dtype=np.int32) + 3, np.arange(skv, dtype=np.int32)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=8, causal=False, use_rope=False,
              q_block=qb, kv_block=kb)
    want = ref_attn.attention({n: jnp.asarray(t) for n, t in p.items()}, jnp.asarray(x),
                              jnp.asarray(pos), xkv=jnp.asarray(xkv),
                              kv_positions=jnp.asarray(kv_pos), **kw)
    got = attn.attention({n: torch.from_numpy(t) for n, t in p.items()}, torch.from_numpy(x),
                         torch.from_numpy(pos), xkv=torch.from_numpy(xkv),
                         kv_positions=torch.from_numpy(kv_pos), **kw)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


def test_no_rope_attention_and_decode_attention_match_reference():
    """Causal self attention without rope over a sequence, then decode steps
    without rope into a dense cache: outputs and the cache to 1e-5."""
    rng = np.random.default_rng(3)
    p = _attn_params(rng, 32, 4, 2, 8)
    rp = {n: jnp.asarray(t) for n, t in p.items()}
    tp = {n: torch.from_numpy(t) for n, t in p.items()}
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=8, use_rope=False)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    want = ref_attn.attention(rp, jnp.asarray(x), jnp.asarray(pos), q_block=4, kv_block=8,
                              **kw)
    got = attn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos), q_block=4,
                         kv_block=8, **kw)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
    rcache = ref_attn.init_attn_cache(2, 6, 2, 8, jnp.float32)
    cache = attn.init_attn_cache(2, 6, 2, 8, torch.float32, "cpu")
    step = jax.jit(lambda c, xt, t: ref_attn.decode_attention(rp, xt, c, t, **kw))
    for t in range(6):
        want, rcache = step(rcache, jnp.asarray(x[:, t:t + 1]), jnp.int32(t))
        got = attn.decode_attention(tp, torch.from_numpy(x[:, t:t + 1]), cache, t, **kw)
        _close(got, want, dict(rtol=1e-5, atol=1e-5))
    for n in ("k", "v"):
        _close(cache[n], rcache[n], dict(rtol=1e-5, atol=1e-5))


# ------------------------------------------------------------------- C1
def test_gelu_dense_config_matches_reference(pairs, steps):
    """C1: ``activation="gelu"`` on a dense config builds the plain GELU
    MLP (no ``w_gate``) and computes it: logits and a decode step."""
    ref, params, ours = pairs(GELU_DENSE[0], **GELU_DENSE[1])
    names = dict(ours.named_parameters())
    assert "w_up" in names and "w_down" in names and "w_gate" not in names
    assert "w_gate" not in params["blocks"]["mlp"]
    toks = _tokens(2, 24, 1)
    with torch.no_grad():
        _close(ours.lm_logits(torch.from_numpy(toks)),
               jax.jit(ref.lm_logits)(params, jnp.asarray(toks)), LOGITS_TOL)
    want, _ = steps(ref)(params, ref.init_cache(2, 8), jnp.asarray(toks[:, 0]), jnp.int32(0))
    got, _ = ours.decode_step(ours.init_cache(2, 8), torch.from_numpy(toks[:, 0]), 0)
    _close(got, want, LOGITS_TOL)
    swiglu = Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu")
    assert "w_gate" in dict(swiglu.named_parameters())


def test_params_from_jax_fails_on_a_leaf_missing_or_left_over(pairs):
    _, params, ours = pairs(GELU_DENSE[0], **GELU_DENSE[1])
    tree = jax.tree.map(np.asarray, params)
    blocks = tree["blocks"]
    extra = dict(tree, blocks=dict(blocks, mlp=dict(blocks["mlp"],
                                                    w_gate=blocks["mlp"]["w_up"])))
    with pytest.raises(ValueError, match="left over.*blocks/mlp/w_gate"):
        Model(ours.config, device="cpu").params_from_jax(extra)
    missing = dict(tree, blocks=dict(blocks, mlp={"w_down": blocks["mlp"]["w_down"]}))
    with pytest.raises(ValueError, match="blocks/mlp/w_up: missing"):
        Model(ours.config, device="cpu").params_from_jax(missing)


# ------------------------------------------------------------------- vlm
def test_vlm_lm_logits_loss_and_decode_match_reference(pairs, steps):
    ref, params, ours = pairs(VLM)
    toks = _tokens(2, 20, 2)
    ex, rex = _extras(ours.config, 2, 5)
    with torch.no_grad():
        _close(ours.lm_logits(torch.from_numpy(toks), ex),
               jax.jit(ref.lm_logits)(params, jnp.asarray(toks), rex), LOGITS_TOL)
    labels = np.roll(toks, -1, 1)
    labels[:, -2:] = -1
    want, _ = jax.jit(ref.loss_fn)(params, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels), "extras": rex})
    with torch.no_grad():
        got, _ = ours.loss_fn({"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels), "extras": ex})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    # serving is text-only: decode_step is the dense one
    rcache, cache = ref.init_cache(2, 8, rex), ours.init_cache(2, 8, ex)
    for t in range(4):
        want, rcache = steps(ref)(params, rcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        got, cache = ours.decode_step(cache, torch.from_numpy(toks[:, t]), t)
        _close(got, want, LOGITS_TOL)


def test_vlm_image_prefix_changes_logits(pairs):
    """The reference's ``test_vlm_image_prefix_changes_logits`` on the port:
    zero and seeded image embeddings give different text logits; the
    image rows are dropped from the output."""
    _, _, ours = pairs(VLM)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    ex, _ = _extras(ours.config, 1, 6)
    zeros = {"image_embeds": torch.zeros_like(ex["image_embeds"])}
    with torch.no_grad():
        l0, l1 = ours.lm_logits(toks, zeros), ours.lm_logits(toks, ex)
    assert l0.shape == l1.shape == (1, 8, 512)
    assert not np.allclose(l0.numpy(), l1.numpy())


def _servers(pairs, name, *, paged_rows=64):
    """(reference server, port server): coded heads on one fleet with the
    reference's generator injected and a deadline no worker misses."""
    ref, params, ours = pairs(name)
    refsrv = RefServer(ref, params, RefCluster.make(*FLEET),
                       RefServeConfig(block_rows=paged_rows, deadline_safety=50.0))
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=paged_rows, deadline_safety=50.0))
    server.coded_head.refresh(np.asarray(refsrv.coded_head.generator))
    refsrv.coded_head.deadline = server.coded_head.deadline = 1e9
    return refsrv, server


@pytest.mark.parametrize("paged", [True, False])
def test_vlm_serve_matches_reference(pairs, paged, monkeypatch):
    """The paged and the dense serve of a reduced paligemma (text only, the
    reference's envelope): streams and counts exact."""
    trace_kw = dict(num_requests=3, prompt_len=(4, 12), out_len=(2, 4), vocab=512)
    serve_kw = dict(slots=2, decode_block=2, paged=paged)
    if paged:
        serve_kw["prefill_chunk"] = 8
    refsrv, server = _servers(pairs, VLM)
    ref_rep, ref_streams = _ref_streams(
        refsrv, ref_wl.make_workload("poisson", **trace_kw).trace(seed=0), monkeypatch,
        **serve_kw)
    rep = server.serve(wl.make_workload("poisson", **trace_kw).trace(seed=0), **serve_kw)
    assert rep.streams == ref_streams
    for f in ("tokens", "rounds", "decode_rounds", "prefill_rounds", "admitted", "shed"):
        assert getattr(rep, f) == getattr(ref_rep, f), f
    assert rep.decode_ok == rep.decode_rounds and rep.erased_rounds == 0


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_generate_matches_reference(pairs, name):
    """``Server.generate`` through the coded head: vlm with its batched
    prefill (text only), audio through the sequential prefill from
    ``init_cache(extras={"enc_out"})``; the reference's tokens exactly."""
    refsrv, server = _servers(pairs, name)
    ref, params, ours = pairs(name)
    prompts = _tokens(2, 6, 7)
    ex, rex = _extras(ours.config, 2, 8)
    if name == AUDIO:
        with torch.no_grad():
            ex = {"enc_out": ours.encode(ex["frames"])}
        rex = {"enc_out": ref.encode(params, rex["frames"])}
    assert server._can_batch_prefill() == refsrv._can_batch_prefill() == (name == VLM)
    want = refsrv.generate(jnp.asarray(prompts), 4, extras=rex)
    got = server.generate(prompts, 4, extras=ex)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- audio
def test_audio_encode_lm_logits_loss_and_decode_match_reference(pairs, steps):
    ref, params, ours = pairs(AUDIO)
    toks = _tokens(2, 16, 9)
    ex, rex = _extras(ours.config, 2, 10)
    enc = jax.jit(ref.encode)(params, rex["frames"])
    with torch.no_grad():
        got_enc = ours.encode(ex["frames"])
        _close(got_enc, enc, dict(rtol=1e-5, atol=1e-5))
        _close(ours.lm_logits(torch.from_numpy(toks), ex),
               jax.jit(ref.lm_logits)(params, jnp.asarray(toks), rex), LOGITS_TOL)
    labels = np.roll(toks, -1, 1)
    want, _ = jax.jit(ref.loss_fn)(params, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels), "extras": rex})
    with torch.no_grad():
        got, _ = ours.loss_fn({"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels), "extras": ex})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    rcache = ref.init_cache(2, 16, {"enc_out": enc})
    cache = ours.init_cache(2, 16, {"enc_out": got_enc})
    for t in range(6):
        want, rcache = steps(ref)(params, rcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        got, cache = ours.decode_step(cache, torch.from_numpy(toks[:, t]), t)
        _close(got, want, LOGITS_TOL)
    for n in ("k", "v"):
        _close(cache[n], rcache["kv"][n], dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(rcache["kv"]["pos"]))


def test_audio_decode_matches_prefill(pairs):
    """The reference's ``test_decode_matches_prefill`` on the port: the
    stepped ``decode_step`` from the encoder output equals ``lm_logits``."""
    _, _, ours = pairs(AUDIO)
    toks = torch.from_numpy(_tokens(2, 12, 11))
    ex, _ = _extras(ours.config, 2, 12)
    with torch.no_grad():
        full = ours.lm_logits(toks, ex)
        cache = ours.init_cache(2, 12, {"enc_out": ours.encode(ex["frames"])})
    stepped = torch.stack([ours.decode_step(cache, toks[:, t], t)[0] for t in range(12)], 1)
    _close(stepped, full.numpy(), LOGITS_TOL)


# --------------------------------------------------- extras and refusals
@pytest.mark.parametrize("name", [VLM, AUDIO, "qwen3-0.6b"])
def test_make_extras_is_the_reference_stub(name):
    cfg = ARCHS[name].reduced()
    want = ref_make_extras(REF_ARCHS[name].reduced(), 3)
    got = make_extras(cfg, 3, device="cpu")
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and not got[k].any()
        assert got[k].dtype == cfg.cdtype
    batch = SyntheticLMData(cfg, ShapeConfig("t", 8, 3, "train"), device="cpu").next_batch()
    assert set(batch["extras"]) == set(want)


def test_audio_refuses_the_slot_and_paged_paths_and_training(pairs):
    """The reference's slot-support message on every slot and paged entry
    point of whisper; ``init_cache`` without ``enc_out`` refused; a vlm or
    audio ``Trainer`` builds plain or coded, the plain one trains, and the
    coded one's ``run`` raises the reference's extras message at its step
    (the batches carry extras that the coded step does not partition)."""
    from test_torch_families import _slot_and_paged_calls

    ref, _, ours = pairs(AUDIO)
    with pytest.raises(NotImplementedError) as want:
        ref.init_paged_cache(4, 4)
    for name, call in _slot_and_paged_calls(ours).items():
        with pytest.raises(NotImplementedError) as got:
            call()
        assert str(got.value) == str(want.value), name
    with pytest.raises(ValueError, match="encoder output"):
        ours.init_cache(2, 8)
    for name in (VLM, AUDIO):
        cfg = pairs(name)[2].config
        data = SyntheticLMData(cfg, ShapeConfig("t", 8, 2, "train"), device="cpu")
        for cluster in (None, ClusterSpec.make(*FLEET)):
            trainer = Trainer(pairs(name)[2], data, AdamWConfig(),
                              TrainConfig(steps=1, cluster=cluster, partitions=2))
            if cluster is None:
                _, _, hist = trainer.run()
                assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
                continue
            with pytest.raises(NotImplementedError,
                               match="coded training does not partition family extras yet"):
                trainer.run()
