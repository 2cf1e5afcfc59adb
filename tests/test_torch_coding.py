"""Port parity, MDS coding: generator, encode and the erasure decode.

``ErasureDecoder`` (behind ``decode_systematic``, the port's torch twin
of ``decode_systematic_jit``) is held against both reference decoders over
the erasure grid of ``tests/test_decode_pipeline.py``: none, some, exactly
k survivors, and fewer than k (``ok`` false, zeroed output), the erasures
drawn from every row, from the systematic rows alone or from the parity
rows alone. Each case runs on the decoder's three solves of the same
systematic G: the general (k, k) one, and the reduced solve of the erased
systematic unknowns, static (what ``decode_systematic`` binds) and sized
by the query's e. The generator comes from the reference and is injected
as numpy; the reference's ``chebyshev_vandermonde`` generator, not
systematic, binds the general solve, and binding reads G once
(``is_systematic``), a decode never. Tolerance 1e-4: a float32 LU solve
with one refinement step on a well-conditioned systematic system, the
reference test's own bound.

The sized solve (Path M's) is held against both reference decoders and the
static one on a code whose c = n - k = 260 is no multiple of
``SIZE_STEP``: no erasure (no solve), e at the rounding edge 128 / 129, e
= c with exactly k survivors (384 capped at c), and fewer than k survivors
(no solve, zeros); with its count ``erasure_solve_rows`` by size, looked
up once a size, and the ``erased`` and ``size`` attributes of
``decode.gather`` in a profiled query.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import profile

from repro.core.coding import decode_systematic as ref_decode_np
from repro.core.coding import decode_systematic_jit as ref_decode_jit
from repro.core.coding import encode as ref_encode
from repro.core.coding import make_generator as ref_make_generator
from repro_torch.core import coding
from repro_torch.core.coding import (
    SIZE_STEP,
    ErasureDecoder,
    decode_systematic,
    encode,
    is_systematic,
    make_generator,
)
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
#: the decoder's three solves on the same systematic G (``reduced``: the
#: static solve, which ``decode_systematic`` binds)
SOLVES = dict(argnames="solve", argvalues=["general", "static", "sized"],
              ids=["general", "reduced", "sized"])


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


def _decoder(g, solve, **kw) -> ErasureDecoder:
    """An ``ErasureDecoder`` of g bound to ``solve``; the general one of a
    systematic g through the private route of a bind that reads g as not
    systematic (no option selects it)."""
    g = torch.as_tensor(g)
    if solve == "general":
        with mock.patch.object(coding, "is_systematic", lambda _: False):
            return ErasureDecoder(g, **kw)
    return ErasureDecoder(g, sized=solve == "sized", **kw)


def _decodes(path):
    return REGISTRY.counter("erasure_decodes", path=path).value


def _sizes():
    """``erasure_solve_rows`` by size, as the registry holds it now."""
    return {r["labels"]["size"]: r["value"] for r in REGISTRY.snapshot()
            if r["name"] == "erasure_solve_rows"}


#: a code whose c = n - k = 260 is no multiple of ``SIZE_STEP``
BIG_K, BIG_N = 400, 660
#: (erased systematic rows, erased parity rows) -> the sized system's rows:
#: none erased; one; the rounding edge at 128 and 129; e = c with exactly
#: k survivors (384 capped at c); fewer than k survivors
SIZED = {(0, 0): 0, (1, 5): 128, (128, 40): 128, (129, 0): 256,
         (260, 0): 260, (100, 200): 0}
SIZED_IDS = [f"e{e}-p{p}" for e, p in SIZED]


def _big_case(erased, cols):
    """(g, x, y, mask, decodable) on the big code, ``erased`` = (systematic,
    parity) rows erased, drawn from the seed."""
    e, lost = erased
    g = _ref_g(BIG_N, BIG_K)
    rng = np.random.default_rng(100 + e)
    x = rng.standard_normal((BIG_K,) if cols is None else (BIG_K, cols)).astype(np.float32)
    y = np.array(ref_encode(jnp.asarray(g), jnp.asarray(x)), np.float32)
    mask = np.ones(BIG_N, bool)
    mask[rng.choice(BIG_K, size=e, replace=False)] = False
    mask[BIG_K + rng.choice(BIG_N - BIG_K, size=lost, replace=False)] = False
    return g, x, y, mask, int(mask.sum()) >= BIG_K


@pytest.mark.parametrize("erasures", [0, 3, 8, 16])  # 16 = exactly threshold
@pytest.mark.parametrize("cols", [None, 5])
@pytest.mark.parametrize("where", ["mixed", "systematic", "parity"])
@pytest.mark.parametrize(**SOLVES)
def test_decode_matches_reference_across_erasure_grid(erasures, cols, where, solve):
    k, n = 32, 48
    g = _ref_g(n, k)
    shape = (k,) if cols is None else (k, cols)
    x = np.random.default_rng(100 + erasures).standard_normal(shape).astype(np.float32)
    y = np.array(ref_encode(jnp.asarray(g), jnp.asarray(x)), np.float32)
    mask = _erase(n, k, erasures, where)
    z, ok = _decoder(g, solve)(torch.from_numpy(y), torch.from_numpy(mask))
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    z_np, ok_np = ref_decode_np(g, y, mask, k)
    assert bool(ok) and bool(ok_jit) and ok_np
    assert z.dtype == torch.float32 and tuple(z.shape) == shape
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jit), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), z_np, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("survivors", [0, 15])
@pytest.mark.parametrize(**SOLVES)
def test_decode_insufficient_survivors_zeroed(survivors, solve):
    """< k survivors: ok False and zeros (not garbage), like the reference;
    on the reduced solves also with more erased systematic rows (16 or 1 of
    16) than the static solve's 8 unknowns, and with NaN in every erased
    row."""
    k, n = 16, 24
    g = _ref_g(n, k)
    y = g @ np.ones((k,), np.float32)
    mask = np.zeros(n, bool)
    mask[:survivors] = True
    garbage = np.where(mask, y, np.nan).astype(np.float32)
    z, ok = _decoder(g, solve)(torch.from_numpy(garbage), torch.from_numpy(mask))
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    assert not bool(ok) and not bool(ok_jit) and not ref_decode_np(g, y, mask, k)[1]
    np.testing.assert_array_equal(z.numpy(), np.zeros(k, np.float32))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_jit))


@pytest.mark.parametrize("cols", [None, 3])
def test_a_non_systematic_generator_takes_the_general_path(cols):
    """The reference's ``chebyshev_vandermonde`` G (top rows not I_k):
    ``is_systematic`` says so, a decoder binds the general solve, and its
    decode, counted on the general path, matches the reference's jitted
    decode and A x."""
    k, n = 8, 12
    g = _ref_g(n, k, "chebyshev_vandermonde")
    assert not is_systematic(torch.from_numpy(g))
    assert is_systematic(torch.from_numpy(_ref_g(n, k)))
    shape = (k,) if cols is None else (k, cols)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    y = np.array(ref_encode(jnp.asarray(g), jnp.asarray(x)), np.float32)
    mask = np.ones(n, bool)
    mask[[0, 3, 5, 10]] = False  # exactly k survive
    assert ErasureDecoder(torch.from_numpy(g), sized=True).path == "general"
    before = _decodes("general"), _decodes("reduced")
    z, ok = decode_systematic(torch.from_numpy(g), torch.from_numpy(y),
                              torch.from_numpy(mask))
    assert (_decodes("general"), _decodes("reduced")) == (before[0] + 1, before[1])
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    assert bool(ok) and bool(ok_jit)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jit), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(**SOLVES)
def test_the_path_counter_counts_each_decode_once(solve):
    """``erasure_decodes`` in ``obs.metrics.REGISTRY``: one count a call,
    on the path the decoder bound; a systematic G with n == k has nothing
    to eliminate and binds the general solve."""
    n, k = 24, 16
    decoder = _decoder(_ref_g(n, k), solve)
    y = torch.ones(n)
    path, other = ("general", "reduced") if solve == "general" else ("reduced", "general")
    assert decoder.path == path
    before = _decodes(path), _decodes(other)
    for _ in range(3):
        decoder(y, torch.ones(n, dtype=torch.bool))
    assert (_decodes(path), _decodes(other)) == (before[0] + 3, before[1])
    square = ErasureDecoder(torch.eye(k), sized=solve == "sized")
    assert square.path == "general"
    before = _decodes("general"), _decodes("reduced")
    z, ok = square(torch.arange(k, dtype=torch.float32), torch.ones(k, dtype=torch.bool))
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
    for solve in SOLVES["argvalues"]:
        z, ok = _decoder(g, solve)(y, mask)
        assert bool(ok)
        torch.testing.assert_close(z, x, rtol=1e-4, atol=1e-4)



@pytest.mark.parametrize("cols", [None, 5])
@pytest.mark.parametrize("erased", list(SIZED), ids=SIZED_IDS)
def test_the_sized_solve_matches_reference_across_erasure_grid(erased, cols):
    """The reduced solve sized by e, against both reference decoders and A
    x; fewer than k survivors: ok False and zeros, no solve. Each decode
    counts once in ``erasure_solve_rows`` at its size."""
    g, x, y, mask, decodable = _big_case(erased, cols)
    before = _sizes()
    z, ok = _decoder(g, "sized")(torch.from_numpy(y), torch.from_numpy(mask))
    size = SIZED[erased]
    after = _sizes()
    assert {s: v - before.get(s, 0) for s, v in after.items() if v != before.get(s, 0)} \
        == {size: 1}
    assert size == (0 if erased[0] == 0 or not decodable
                    else min(-(-erased[0] // SIZE_STEP) * SIZE_STEP, BIG_N - BIG_K))
    z_jit, ok_jit = ref_decode_jit(g, jnp.asarray(y), jnp.asarray(mask))
    z_np, ok_np = ref_decode_np(g, y, mask, BIG_K)
    assert bool(ok) == bool(ok_jit) == ok_np == decodable
    assert z.dtype == torch.float32 and tuple(z.shape) == x.shape
    if not decodable:
        np.testing.assert_array_equal(z.numpy(), np.zeros(x.shape, np.float32))
        np.testing.assert_array_equal(z.numpy(), np.asarray(z_jit))
        return
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jit), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), z_np, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-4, atol=1e-4)
    if erased[0] == 0:  # no solve: the systematic rows as they came
        np.testing.assert_array_equal(z.numpy(), y[:BIG_K])


@pytest.mark.parametrize("cols", [None, 5])
@pytest.mark.parametrize("erased", list(SIZED), ids=SIZED_IDS)
def test_the_sized_and_static_reduced_solves_agree(erased, cols):
    """The same system, its live block solved at e rounded up to 128 and
    at the static c: ok equal, z within the decode's tolerance, and equal
    where neither solves anything (no erasure) or both zero (too few)."""
    g, _, y, mask, decodable = _big_case(erased, cols)
    args = torch.from_numpy(y), torch.from_numpy(mask)
    z, ok = _decoder(g, "sized")(*args)
    z_c, ok_c = _decoder(g, "static")(*args)
    assert bool(ok) == bool(ok_c) == decodable
    if SIZED[erased] == 0:
        assert torch.equal(z, z_c)
    np.testing.assert_allclose(z.numpy(), z_c.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sized", [True, False], ids=["sized", "static"])
@pytest.mark.parametrize("erased", [(0, 0), (129, 0), (100, 200)], ids=["e0", "e129", "too-few"])
def test_a_profiled_solve_carries_erased_and_size(erased, sized):
    """Inside an open ``pathm.query`` under the profiler, ``decode.gather``
    carries e as ``erased`` and the system's rows as ``size`` (the static
    solve: c), and every one of the three stages opens, empty or not; the
    static solve counts nothing in ``erasure_solve_rows``."""
    g, _, y, mask, decodable = _big_case(erased, None)
    before = _sizes()
    with profile():
        n0 = len(trace.STAGES.spans)
        with trace.stage("pathm.query", torch.device("cpu"), root=True):
            ErasureDecoder(torch.from_numpy(g), sized=sized)(torch.from_numpy(y),
                                                             torch.from_numpy(mask))
    spans = list(trace.STAGES.spans)[n0:]
    assert [s.name for s in spans] == ["decode.gather", "decode.lu", "decode.trisolve",
                                       "pathm.query"]
    size = SIZED[erased] if sized else BIG_N - BIG_K
    assert spans[0].host_attrs == {"erased": erased[0], "size": size}
    assert (_sizes() == before) != sized


@pytest.mark.parametrize("sized", [False, True], ids=["static", "sized"])
def test_binding_reads_the_generator_once_and_a_decode_never(monkeypatch, sized):
    """``is_systematic`` (the decoder's one host read at bind) runs once a
    bind and never in a decode; on the reference's ``chebyshev_vandermonde``
    G the bind chooses the general solve, whatever ``sized`` says."""
    calls = []

    def counted(g):
        calls.append(g)
        return is_systematic(g)

    monkeypatch.setattr(coding, "is_systematic", counted)
    g, x, y, mask, _ = _big_case((129, 0), None)
    decoder = ErasureDecoder(torch.from_numpy(g), sized=sized)
    assert len(calls) == 1 and decoder.path == "reduced"
    for _ in range(3):
        z, ok = decoder(torch.from_numpy(y), torch.from_numpy(mask))
    assert len(calls) == 1 and bool(ok)
    np.testing.assert_allclose(z.numpy(), x, rtol=1e-4, atol=1e-4)
    k, n = 8, 12
    cheb = _ref_g(n, k, "chebyshev_vandermonde")
    general = ErasureDecoder(torch.from_numpy(cheb), sized=sized)
    assert len(calls) == 2 and general.path == "general"
    xc = np.random.default_rng(7).standard_normal(k).astype(np.float32)
    mask_c = np.ones(n, bool)
    mask_c[[0, 3, 5, 10]] = False
    zc, okc = general(torch.from_numpy(cheb @ xc), torch.from_numpy(mask_c))
    assert len(calls) == 2 and bool(okc)
    np.testing.assert_allclose(zc.numpy(), xc, rtol=1e-4, atol=1e-4)


def test_a_sized_query_looks_up_its_counter_once_a_size(monkeypatch):
    """The sized solve keeps its ``erasure_solve_rows`` counter per size:
    a second query at a size it has met looks nothing up in the registry,
    and still counts once."""
    g, _, y, mask, _ = _big_case((129, 0), None)
    decoder = ErasureDecoder(torch.from_numpy(g), sized=True)
    args = torch.from_numpy(y), torch.from_numpy(mask)
    decoder(*args)
    before = _sizes()

    def refused(*a, **kw):
        raise AssertionError("a registry lookup inside a query")

    monkeypatch.setattr(coding._METRICS, "counter", refused)
    z, ok = decoder(*args)
    monkeypatch.undo()
    assert bool(ok) and _sizes() == {**before, 256: before[256] + 1}
