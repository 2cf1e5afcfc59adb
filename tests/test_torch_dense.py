"""Port parity, dense serving: the dense-cache model paths and
``Server.generate`` on reduced qwen3-0.6b.

* ``Model.prefill`` (last logits and every layer's post-rope K/V),
  ``decode_step`` (one position for the batch) and ``decode_step_slots``
  (a position per row) against the reference on the same weights and
  tokens: logits within 2e-4, caches within 1e-5 (float32 compute; the
  two packages sum in different orders), position maps exactly;
* ``generate`` without a coded head: the reference's tokens exactly;
* ``generate`` with a coded head whose deadline nobody misses (the
  reference's ``tests/test_runtime.py`` case): the reference's tokens;
* in the port alone, with erasures (``deadline_safety`` 1.2): the coded
  tokens equal the uncoded ones (a decoded round equals the plain logits
  to float32 rounding; a failed one falls back to them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.models.model import Model as RefModel
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
from repro_torch.configs import ARCHS
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import make_scheme
from repro_torch.models.model import Model
from repro_torch.runtime.serve_loop import ServeConfig, Server

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
LOGITS_TOL = 2e-4
CACHE_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    ref = RefModel(REF_ARCHS["qwen3-0.6b"].reduced())
    params = ref.init_params(KEY)
    ours = Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu")
    ours.params_from_jax(jax.tree.map(np.asarray, params))
    return ref, params, ours


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_prefill_matches_reference(models):
    ref, params, ours = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (3, 40)).astype(np.int32)  # 40: off the 32-blocks
    lens = np.array([40, 23, 1], np.int32)
    lg, ks, vs = ref.prefill(params, jnp.asarray(toks), jnp.asarray(lens))
    got_lg, got_k, got_v = ours.prefill(torch.from_numpy(toks), torch.from_numpy(lens))
    _close(got_lg, lg, LOGITS_TOL)
    _close(got_k, ks, CACHE_TOL)
    _close(got_v, vs, CACHE_TOL)


def test_decode_step_matches_reference(models):
    """Eight steps into a 6-entry cache: positions 6 and 7 wrap onto the
    first entries (``pos % S``), as the reference's rolling write."""
    ref, params, ours = models
    rng = np.random.default_rng(1)
    b, cache_len = 2, 6
    cache, ours_cache = ref.init_cache(b, cache_len), ours.init_cache(b, cache_len)
    for t in range(8):
        tok = rng.integers(0, 512, (b,)).astype(np.int32)
        lg, cache = ref.decode_step(params, cache, jnp.asarray(tok), jnp.int32(t))
        got, ours_cache = ours.decode_step(ours_cache, torch.from_numpy(tok), t)
        _close(got, lg, LOGITS_TOL)
    _close(ours_cache["k"], cache["kv"]["k"], CACHE_TOL)
    _close(ours_cache["v"], cache["kv"]["v"], CACHE_TOL)
    np.testing.assert_array_equal(ours_cache["pos"].numpy(), np.asarray(cache["kv"]["pos"]))


def test_decode_step_slots_matches_reference(models):
    """Rows at their own positions, one row frozen (rewriting its entry)."""
    ref, params, ours = models
    rng = np.random.default_rng(2)
    b, cache_len = 3, 12
    cache, ours_cache = ref.init_slot_cache(b, cache_len), ours.init_slot_cache(b, cache_len)
    pos = np.array([0, 4, 9], np.int32)
    for _ in range(5):
        tok = rng.integers(0, 512, (b,)).astype(np.int32)
        lg, cache = ref.decode_step_slots(params, cache, jnp.asarray(tok), jnp.asarray(pos))
        got, ours_cache = ours.decode_step_slots(ours_cache, torch.from_numpy(tok),
                                                 torch.from_numpy(pos))
        _close(got, lg, LOGITS_TOL)
        pos = pos + np.array([1, 1, 0], np.int32)
    _close(ours_cache["k"], cache["kv"]["k"], CACHE_TOL)
    _close(ours_cache["v"], cache["kv"]["v"], CACHE_TOL)
    np.testing.assert_array_equal(ours_cache["pos"].numpy(), np.asarray(cache["kv"]["pos"]))


def _prompts():
    return np.asarray(jax.random.randint(KEY, (2, 4), 0, 512), np.int32)


def test_generate_uncoded_matches_reference(models):
    ref, params, ours = models
    want = RefServer(ref, params, None, RefServeConfig(max_decode_steps=6)).generate(
        jnp.asarray(_prompts()), 6)
    got = Server(ours, None, ServeConfig(max_decode_steps=6)).generate(_prompts())
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_coded_without_misses_matches_reference(models):
    """Fast workers and a deadline nobody misses: coded == the reference's
    coded tokens (and its plain ones)."""
    ref, params, ours = models
    refsrv = RefServer(ref, params, RefCluster.make([8], [5.0]),
                       RefServeConfig(max_decode_steps=6))
    refsrv.coded_head.deadline = 1e9
    want = refsrv.generate(jnp.asarray(_prompts()), 6)
    server = Server(ours, ClusterSpec.make([8], [5.0]), ServeConfig(max_decode_steps=6))
    server.coded_head.deadline = 1e9
    rounds = []
    got = server.generate(_prompts(), observe=lambda step, lg, sel, ok, mask:
                          rounds.append((step, bool(ok), bool(mask.all()))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every sampled token went through the coded head, the first included
    assert rounds == [(t, True, True) for t in range(6)]


@pytest.mark.parametrize("scheme,params", [("optimal", {}), ("reisizadeh", {}),
                                           ("uniform_r", {"r": 3})])
def test_generate_coded_emits_uncoded_tokens_through_erasures(models, scheme, params):
    _, _, ours = models
    prompts = np.random.default_rng(3).integers(0, 512, (3, 7)).astype(np.int32)
    cfg = ServeConfig(block_rows=64, deadline_safety=1.2,
                      scheme=make_scheme(scheme, **params))
    coded = Server(ours, ClusterSpec.make([2, 2], [4.0, 0.8]), cfg)
    stats = []
    got = coded.generate(prompts, 8, seed=5,
                         observe=lambda step, lg, sel, ok, mask: stats.append(
                             (bool(ok), bool(mask.all()))))
    want = Server(ours).generate(prompts, 8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert len(stats) == 8
    assert any(not erased_free for _, erased_free in stats)  # workers were erased
    assert any(ok and not all_in for ok, all_in in stats)  # ... and still decoded


def test_generate_zero_new_returns_prompts(models):
    _, _, ours = models
    out = Server(ours).generate(_prompts(), 0)
    np.testing.assert_array_equal(out.numpy(), _prompts())


def test_decode_attention_layer_matches_reference(models):
    """One layer's ``decode_attention`` over an ``init_attn_cache`` cache,
    against the reference's, for six positions into a 4-entry cache (the
    write rolls over): outputs within 2e-4, the cache within 1e-5."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention as attn

    ref, params, ours = models
    c = ours.config
    kw = dict(num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
              head_dim=c.resolved_head_dim, rope_theta=c.rope_theta)
    p_ref = jax.tree.map(lambda t: t[0], params["blocks"]["attn"])
    p_ours = ours._layer(0)
    cache = ref_attn.init_attn_cache(2, 4, c.num_kv_heads, c.resolved_head_dim, jnp.float32)
    ours_cache = attn.init_attn_cache(2, 4, c.num_kv_heads, c.resolved_head_dim,
                                      torch.float32, "cpu")
    rng = np.random.default_rng(4)
    for pos in range(6):
        x = rng.standard_normal((2, 1, c.d_model)).astype(np.float32)
        want, cache = ref_attn.decode_attention(p_ref, jnp.asarray(x), cache, jnp.int32(pos),
                                                **kw)
        with torch.no_grad():
            got = attn.decode_attention(p_ours, torch.from_numpy(x), ours_cache, pos, **kw)
        _close(got, want, LOGITS_TOL)
    _close(ours_cache["k"], cache["k"], CACHE_TOL)
    _close(ours_cache["v"], cache["v"], CACHE_TOL)
    np.testing.assert_array_equal(ours_cache["pos"].numpy(), np.asarray(cache["pos"]))
