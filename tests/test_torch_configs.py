"""Port parity, configs and the attention envelope of the new families.

* the registry: all ten of the reference's configs, every field of the
  full and the reduced config equal to the reference's (dtypes by name);
* ``chunked_attention`` and ``attention`` with a sliding window and with
  ``causal_skip`` against the reference's, to 1e-5, and the skip against
  no skip in the port, to 1e-6; the skip decision's block table against
  the reference's rule;
* ``decode_attention``'s int8 cache: values and scales equal to the
  reference's exactly, outputs to 1e-5; the rolling cache of a window
  shorter than the context, to 1e-5, past its wrap.

Float32 on both sides; the same seeded numpy inputs go into both.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import attention as ref_attn
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import attention as attn

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(num_heads=4, num_kv_heads=2, head_dim=32)


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_registry_matches_reference_field_for_field(name):
    ref, ours = REF_ARCHS[name], get_arch(name)
    for full in (True, False):
        r = ref if full else ref.reduced()
        o = ours if full else ours.reduced()
        for f in dataclasses.fields(r):
            assert getattr(o, f.name) == getattr(r, f.name), (name, full, f.name)
        for prop in ("resolved_head_dim", "sub_quadratic"):
            assert getattr(o, prop) == getattr(r, prop), (name, full, prop)
        for prop in ("pdtype", "cdtype"):  # dtypes by name
            assert str(getattr(o, prop)).split(".")[-1] == np.dtype(getattr(r, prop)).name


def test_registry_holds_exactly_the_reference_archs():
    assert set(ARCHS) == set(REF_ARCHS)
    with pytest.raises(KeyError):
        get_arch("nope")


def _qkv(rng, b, s, skv):
    q = rng.standard_normal((b, s, 4, 32)).astype(np.float32)
    k = rng.standard_normal((b, skv, 2, 32)).astype(np.float32)
    v = rng.standard_normal((b, skv, 2, 32)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window,skip", [(None, True), (20, False), (20, True), (7, True)])
def test_chunked_attention_window_and_skip_match_reference(window, skip):
    """64 queries against 64 keys in 16-blocks (the last 5 keys padded with
    position -1): a window and the block skip, as the reference."""
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 64, 64)
    qp = np.arange(64, dtype=np.int32) + 3
    kp = np.where(np.arange(64) < 59, np.arange(64) + 3, -1).astype(np.int32)
    kw = dict(KW, window=window, q_block=16, kv_block=16)
    want = ref_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(qp), jnp.asarray(kp), causal_skip=skip,
                                      **kw)
    args = [torch.from_numpy(a) for a in (q, k, v, qp, kp)]
    got = attn.chunked_attention(*args, causal_skip=skip, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the host copies of the positions give the device read's decision
    host = attn.chunked_attention(*args, causal_skip=skip, host_pos=(qp, kp), **kw)
    assert torch.equal(host, got)
    plain = attn.chunked_attention(*args, causal_skip=False, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)


def test_needed_blocks_follow_the_reference_rule():
    """Causal: key blocks wholly above the diagonal go; with a window of 20,
    key blocks wholly before ``q_min - 19`` go too."""
    qp = np.arange(64).reshape(4, 16)
    need = attn.needed_blocks(qp, qp, causal=True, window=None)
    assert need == [[j <= i for j in range(4)] for i in range(4)]
    need = attn.needed_blocks(qp, qp, causal=True, window=20)
    assert need == [[i - 2 <= j <= i for j in range(4)] for i in range(4)]
    assert attn.needed_blocks(qp, qp, causal=False, window=None) == [[True] * 4] * 4


@pytest.fixture(scope="module")
def layer():
    """One attention layer of reduced h2o-danube-3-4b, in both packages."""
    cfg = REF_ARCHS["h2o-danube-3-4b"].reduced()
    rng = np.random.default_rng(5)
    d, h, kv = cfg.d_model, 4 * 32, 2 * 32
    p = {"wq": rng.standard_normal((d, h)) / np.sqrt(d),
         "wk": rng.standard_normal((d, kv)) / np.sqrt(d),
         "wv": rng.standard_normal((d, kv)) / np.sqrt(d),
         "wo": rng.standard_normal((h, d)) / np.sqrt(h)}
    p = {n: t.astype(np.float32) for n, t in p.items()}
    return ({n: jnp.asarray(t) for n, t in p.items()},
            {n: torch.from_numpy(t) for n, t in p.items()}, d)


@pytest.mark.parametrize("s,window,skip", [(80, 64, True), (80, 64, False), (45, None, True)])
def test_attention_layer_window_and_skip_match_reference(layer, s, window, skip):
    """The whole layer (projections, rope, padding of a ragged length to
    the 32-blocks, the windowed chunked softmax, the output projection)."""
    p_ref, p_ours, d = layer
    x = np.random.default_rng(s).standard_normal((2, s, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    kw = dict(KW, window=window, q_block=32, kv_block=32, causal_skip=skip)
    want = ref_attn.attention(p_ref, jnp.asarray(x), jnp.asarray(pos), **kw)
    with torch.no_grad():
        got = attn.attention(p_ours, torch.from_numpy(x), torch.from_numpy(pos), **kw)
        host = attn.attention(p_ours, torch.from_numpy(x), torch.from_numpy(pos),
                              host_positions=pos, **kw)
        plain = attn.attention(p_ours, torch.from_numpy(x), torch.from_numpy(pos),
                               **dict(kw, causal_skip=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(host, got)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)


def _decode_run(layer, *, steps, cache_len, window, quantized):
    p_ref, p_ours, d = layer
    kw = dict(KW, window=window)
    ref_cache = ref_attn.init_attn_cache(2, cache_len, 2, 32, jnp.float32,
                                         quantized=quantized)
    cache = attn.init_attn_cache(2, cache_len, 2, 32, torch.float32, "cpu",
                                 quantized=quantized)
    rng = np.random.default_rng(7)
    for pos in range(steps):
        x = rng.standard_normal((2, 1, d)).astype(np.float32)
        want, ref_cache = ref_attn.decode_attention(p_ref, jnp.asarray(x), ref_cache,
                                                    jnp.int32(pos), **kw)
        with torch.no_grad():
            got = attn.decode_attention(p_ours, torch.from_numpy(x), cache, pos, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return ref_cache, cache


def test_int8_decode_cache_equals_reference_exactly(layer):
    """Twelve steps into a 16-entry int8 cache: the int8 values and the
    float16 scales equal the reference's bit for bit."""
    ref_cache, cache = _decode_run(layer, steps=12, cache_len=16, window=None,
                                   quantized=True)
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float16
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(ref_cache[name]),
                                      err_msg=name)
    assert int(np.abs(cache["k"].numpy()).max()) == 127  # each row's amax hits 127


@pytest.mark.parametrize("quantized", [False, True])
def test_rolling_cache_past_the_window_matches_reference(layer, quantized):
    """A window of 6 over a 6-entry rolling cache, 15 steps: the write wraps
    twice and the window masks what it overwrote."""
    ref_cache, cache = _decode_run(layer, steps=15, cache_len=6, window=6,
                                   quantized=quantized)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    assert sorted(cache["pos"].tolist()) == list(range(9, 15))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(ref_cache[name], np.float32), **TOL)
