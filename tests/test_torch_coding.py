"""Port parity, MDS coding: generator, encode and the erasure decode.

``decode_systematic`` (the port's torch twin of ``decode_systematic_jit``)
is held against both reference decoders over the erasure grid of
``tests/test_decode_pipeline.py``: none, some, exactly k survivors, and
fewer than k (``ok`` false, zeroed output). The generator comes from the
reference and is injected as numpy. Tolerance 1e-4: a float32 LU solve
with one refinement step on a well-conditioned systematic system, the
reference test's own bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coding import decode_systematic as ref_decode_np
from repro.core.coding import decode_systematic_jit as ref_decode_jit
from repro.core.coding import encode as ref_encode
from repro.core.coding import make_generator as ref_make_generator
from repro_torch.core.coding import (
    decode_systematic,
    encode,
    make_generator,
)

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


def _ref_g(n, k):
    return np.array(ref_make_generator(n, k, KEY), np.float32)


@pytest.mark.parametrize("erasures", [0, 3, 8, 16])  # 16 = exactly threshold
@pytest.mark.parametrize("cols", [None, 5])
def test_decode_matches_reference_across_erasure_grid(erasures, cols):
    k, n = 32, 48
    g = _ref_g(n, k)
    shape = (k,) if cols is None else (k, cols)
    x = np.random.default_rng(100 + erasures).standard_normal(shape).astype(np.float32)
    y = np.array(ref_encode(jnp.asarray(g), jnp.asarray(x)), np.float32)
    mask = np.ones(n, bool)
    mask[np.random.default_rng(erasures).choice(n, size=erasures, replace=False)] = False
    z, ok = decode_systematic(torch.from_numpy(g), torch.from_numpy(y),
                              torch.from_numpy(mask))
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    z_np, ok_np = ref_decode_np(g, y, mask, k)
    assert bool(ok) and bool(ok_jit) and ok_np
    assert z.dtype == torch.float32 and tuple(z.shape) == shape
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jit), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), z_np, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("survivors", [0, 15])
def test_decode_insufficient_survivors_zeroed(survivors):
    """< k survivors: ok False and zeros (not garbage), like the reference."""
    k, n = 16, 24
    g = _ref_g(n, k)
    y = g @ np.ones((k,), np.float32)
    mask = np.zeros(n, bool)
    mask[:survivors] = True
    z, ok = decode_systematic(torch.from_numpy(g), torch.from_numpy(y),
                              torch.from_numpy(mask))
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    assert not bool(ok) and not bool(ok_jit) and not ref_decode_np(g, y, mask, k)[1]
    np.testing.assert_array_equal(z.numpy(), np.zeros(k, np.float32))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_jit))


def test_make_generator_injected_and_seeded():
    n, k = 12, 8
    g = _ref_g(n, k)
    np.testing.assert_array_equal(make_generator(n, k, g=g, device="cpu").numpy(), g)
    own = make_generator(n, k, seed=3, device="cpu")
    np.testing.assert_array_equal(own[:k].numpy(), np.eye(k, dtype=np.float32))
    assert own.dtype == torch.float32 and tuple(own.shape) == (n, k)
    again = make_generator(n, k, seed=3, device="cpu")
    np.testing.assert_array_equal(own.numpy(), again.numpy())
    assert not torch.equal(own, make_generator(n, k, seed=4, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        make_generator(n, k, g=g[:, :-1], device="cpu")
    with pytest.raises(ValueError, match="n >= k"):
        make_generator(4, 8, device="cpu")


def test_encode_matches_reference():
    """A~ = G A through the port's mds_encode (plain on CPU): f32 sums of
    k terms, held to 1e-5."""
    n, k, d = 20, 16, 300
    g = _ref_g(n, k)
    a = np.random.default_rng(1).standard_normal((k, d)).astype(np.float32)
    got = encode(torch.from_numpy(g), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_encode(jnp.asarray(g), jnp.asarray(a))),
                               rtol=1e-5, atol=1e-5)


def test_port_generator_decodes_its_own_code():
    """The port's seeded generator is MDS: any k of n rows decode."""
    k, n = 64, 80
    g = make_generator(n, k, seed=5, device="cpu")
    x = torch.randn((k, 3), generator=torch.Generator().manual_seed(0))
    y = encode(g, x)
    mask = torch.ones(n, dtype=torch.bool)
    mask[:16] = False  # every erasure a systematic row: exactly k survive
    z, ok = decode_systematic(g, y, mask)
    assert bool(ok)
    torch.testing.assert_close(z, x, rtol=1e-4, atol=1e-4)

