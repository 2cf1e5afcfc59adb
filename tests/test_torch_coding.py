"""Port parity, MDS coding: generator, encode and the erasure decode.

``decode_systematic`` (the port's torch twin of ``decode_systematic_jit``)
is held against both reference decoders over the erasure grid of
``tests/test_decode_pipeline.py``: none, some, exactly k survivors, and
fewer than k (``ok`` false, zeroed output), the erasures drawn from every
row, from the systematic rows alone or from the parity rows alone. Each
case runs on both paths: the general (k, k) solve, and the reduced solve
of the erased systematic unknowns that a systematic generator allows
(``systematic=True``). The generator comes from the reference and is
injected as numpy; the reference's ``chebyshev_vandermonde`` generator,
not systematic, is refused the reduced path by ``is_systematic`` and
decodes on the general one. Tolerance 1e-4: a float32 LU solve with one
refinement step on a well-conditioned systematic system, the reference
test's own bound.
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
    is_systematic,
    make_generator,
)
from repro_torch.obs.metrics import REGISTRY

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
PATHS = dict(argnames="systematic", argvalues=[False, True], ids=["general", "reduced"])


def _ref_g(n, k, kind="systematic_gaussian"):
    return np.array(ref_make_generator(n, k, KEY, kind=kind), np.float32)


def _erase(n, k, erasures, where):
    """An (n,) mask with ``erasures`` rows erased, drawn from every row
    (``mixed``), from the k systematic rows or from the parity rows."""
    rng = np.random.default_rng(erasures)
    pool = {"mixed": n, "systematic": np.arange(k), "parity": np.arange(k, n)}[where]
    mask = np.ones(n, bool)
    mask[rng.choice(pool, size=erasures, replace=False)] = False
    return mask


def _decodes(path):
    return REGISTRY.counter("erasure_decodes", path=path).value


@pytest.mark.parametrize("erasures", [0, 3, 8, 16])  # 16 = exactly threshold
@pytest.mark.parametrize("cols", [None, 5])
@pytest.mark.parametrize("where", ["mixed", "systematic", "parity"])
@pytest.mark.parametrize(**PATHS)
def test_decode_matches_reference_across_erasure_grid(erasures, cols, where, systematic):
    k, n = 32, 48
    g = _ref_g(n, k)
    shape = (k,) if cols is None else (k, cols)
    x = np.random.default_rng(100 + erasures).standard_normal(shape).astype(np.float32)
    y = np.array(ref_encode(jnp.asarray(g), jnp.asarray(x)), np.float32)
    mask = _erase(n, k, erasures, where)
    z, ok = decode_systematic(torch.from_numpy(g), torch.from_numpy(y),
                              torch.from_numpy(mask), systematic=systematic)
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    z_np, ok_np = ref_decode_np(g, y, mask, k)
    assert bool(ok) and bool(ok_jit) and ok_np
    assert z.dtype == torch.float32 and tuple(z.shape) == shape
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jit), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), z_np, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("survivors", [0, 15])
@pytest.mark.parametrize(**PATHS)
def test_decode_insufficient_survivors_zeroed(survivors, systematic):
    """< k survivors: ok False and zeros (not garbage), like the reference;
    on the reduced path also with more erased systematic rows (16 or 1 of
    16) than its 8 unknowns, and with NaN in every erased row."""
    k, n = 16, 24
    g = _ref_g(n, k)
    y = g @ np.ones((k,), np.float32)
    mask = np.zeros(n, bool)
    mask[:survivors] = True
    garbage = np.where(mask, y, np.nan).astype(np.float32)
    z, ok = decode_systematic(torch.from_numpy(g), torch.from_numpy(garbage),
                              torch.from_numpy(mask), systematic=systematic)
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    assert not bool(ok) and not bool(ok_jit) and not ref_decode_np(g, y, mask, k)[1]
    np.testing.assert_array_equal(z.numpy(), np.zeros(k, np.float32))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_jit))


@pytest.mark.parametrize("cols", [None, 3])
def test_a_non_systematic_generator_takes_the_general_path(cols):
    """The reference's ``chebyshev_vandermonde`` G (top rows not I_k):
    ``is_systematic`` says so, and its decode, counted on the general
    path, matches the reference's jitted decode and A x."""
    k, n = 8, 12
    g = _ref_g(n, k, "chebyshev_vandermonde")
    assert not is_systematic(torch.from_numpy(g))
    assert is_systematic(torch.from_numpy(_ref_g(n, k)))
    shape = (k,) if cols is None else (k, cols)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    y = np.array(ref_encode(jnp.asarray(g), jnp.asarray(x)), np.float32)
    mask = np.ones(n, bool)
    mask[[0, 3, 5, 10]] = False  # exactly k survive
    before = _decodes("general"), _decodes("reduced")
    z, ok = decode_systematic(torch.from_numpy(g), torch.from_numpy(y),
                              torch.from_numpy(mask),
                              systematic=is_systematic(torch.from_numpy(g)))
    assert (_decodes("general"), _decodes("reduced")) == (before[0] + 1, before[1])
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    assert bool(ok) and bool(ok_jit)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jit), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(**PATHS)
def test_the_path_counter_counts_each_decode_once(systematic):
    """``erasure_decodes`` in ``obs.metrics.REGISTRY``: one count a call,
    on the path it took; a systematic G with n == k has nothing to
    eliminate and counts as general."""
    n, k = 24, 16
    g = torch.from_numpy(_ref_g(n, k))
    y = torch.ones(n)
    path, other = ("reduced", "general") if systematic else ("general", "reduced")
    before = _decodes(path), _decodes(other)
    for _ in range(3):
        decode_systematic(g, y, torch.ones(n, dtype=torch.bool), systematic=systematic)
    assert (_decodes(path), _decodes(other)) == (before[0] + 3, before[1])
    square = torch.eye(k)
    before = _decodes("general"), _decodes("reduced")
    z, ok = decode_systematic(square, torch.arange(k, dtype=torch.float32),
                              torch.ones(k, dtype=torch.bool), systematic=True)
    assert (_decodes("general"), _decodes("reduced")) == (before[0] + 1, before[1])
    assert bool(ok) and torch.equal(z, torch.arange(k, dtype=torch.float32))


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
    assert is_systematic(g)
    for systematic in (False, True):
        z, ok = decode_systematic(g, y, mask, systematic=systematic)
        assert bool(ok)
        torch.testing.assert_close(z, x, rtol=1e-4, atol=1e-4)

