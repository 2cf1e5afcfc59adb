"""Port parity, the paper's coded matvec (``repro_torch.core.coded_matvec``).

The same seeded numpy inputs go through the reference
(``repro/core/coded_matvec.py`` on a one-device ``workers`` mesh) and the
port (workers as a batch dimension):

* ``pack_coded_matrix``: ``row_of`` exactly; ``packed`` exactly with an
  injected integer generator (every product and sum exact in float32),
  and to 1e-5 with the reference's Gaussian one (sums of k terms);
* ``blocked_matvec_batch`` against the reference's Pallas kernel in
  interpret mode (1e-5);
* ``masked_decode`` and ``DecodePipeline`` on the erasure grid of
  ``tests/test_decode_pipeline.py`` (0, 3, 8 and 16 of 48 rows erased, 16
  exactly the threshold), with and without columns; fewer than k
  survivors (``ok`` False, zeros exact); garbage in pad and dead slots
  never reaches the solve; each on the decoder's three solves of the
  reference's systematic generator with ``row_of``: the sized reduced one
  that ``masked_decode`` and ``DecodePipeline`` bind, the general (k, k)
  one and the static reduced one. Tolerance 1e-4: a float32 LU solve with
  one refinement step on a well-conditioned systematic system;
* ``masked_decode``'s reduced solve sized by the query's e, on a code
  whose c = n - k = 260 is no multiple of 128, one coded row a worker
  (and a pad): no erasure, e at the rounding edge 128 / 129, e = c with
  exactly k survivors (384 capped at c), and fewer than k;
* ``decode_coded_result`` (host least squares) and
  ``end_to_end_coded_matvec`` with the reference's generator injected;
* ``masked_decode`` and ``decode_systematic`` take the reference's
  parameters, no more.
"""
import inspect
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core.coded_matvec import DecodePipeline as RefPipeline
from repro.core.coded_matvec import decode_coded_result as ref_decode_result
from repro.core.coded_matvec import end_to_end_coded_matvec as ref_end_to_end
from repro.core.coded_matvec import masked_decode as ref_masked_decode
from repro.core.coded_matvec import pack_coded_matrix as ref_pack
from repro.core.coding import decode_systematic_jit as ref_decode_jit
from repro.core.coding import make_generator as ref_make_generator
from repro.core.planner import plan_deployment as ref_plan_deployment
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.kernels.coded_matvec import ops as ref_cmv
from repro_torch.core.coded_matvec import (
    DecodePipeline,
    coded_matvec,
    decode_coded_result,
    end_to_end_coded_matvec,
    masked_decode,
    pack_coded_matrix,
)
from repro_torch.core import coding
from repro_torch.core.coding import ErasureDecoder, decode_systematic, encode, slot_map
from repro_torch.core.planner import plan_deployment
from repro_torch.obs.metrics import REGISTRY
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.kernels.coded_matvec.ops import blocked_matvec_batch

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)
#: the decoder's three solves with ``row_of`` on the reference's systematic
#: G (``reduced``: the sized solve, which ``masked_decode`` binds)
SOLVES = dict(argnames="solve", argvalues=["general", "sized", "static"],
              ids=["general", "reduced", "static"])
#: (workers, mus, alphas): the reference pipeline test's fleet, and a
#: three-group one whose loads differ (pads in every short block)
FLEETS = [([4, 4], [4.0, 1.0], 1.0), ([3, 5, 4], [4.0, 1.0, 0.4], 1.0)]


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1), ("workers",))


def _plans(fi, k):
    return (plan_deployment(ClusterSpec.make(*FLEETS[fi]), k),
            ref_plan_deployment(RefCluster.make(*FLEETS[fi]), k))


def _ref_g(n, k):
    return np.array(ref_make_generator(n, k, KEY), np.float32)


def _masked_decode(g, row_of, partials, fin, solve):
    """(z, ok) of the packed products by ``solve``: the sized one through
    ``masked_decode``, the static one by its decoder, and the general one
    of the systematic g through the private route of a bind that reads g
    as not systematic (no option selects it)."""
    g, row_of = torch.from_numpy(g), torch.from_numpy(row_of)
    args = torch.from_numpy(partials), torch.from_numpy(fin)
    if solve == "sized":
        return masked_decode(g, row_of, *args)
    if solve == "general":
        with mock.patch.object(coding, "is_systematic", lambda _: False):
            return ErasureDecoder(g, row_of=row_of, sized=True)(*args)
    return ErasureDecoder(g, row_of=row_of)(*args)


@pytest.mark.parametrize("fi,k,d", [(0, 64, 32), (1, 40, 17)])
def test_pack_coded_matrix_matches_reference(fi, k, d):
    plan, ref_plan = _plans(fi, k)
    assert plan.row_ranges == ref_plan.row_ranges and plan.max_load == ref_plan.max_load
    rng = np.random.default_rng(k)
    a = rng.standard_normal((k, d)).astype(np.float32)
    # an integer generator: every product and partial sum is exact in f32
    g_int = rng.integers(-3, 4, size=(plan.n, k)).astype(np.float32)
    a_int = rng.integers(-8, 9, size=(k, d)).astype(np.float32)
    packed, row_of = pack_coded_matrix(torch.from_numpy(g_int), torch.from_numpy(a_int),
                                       plan)
    want, want_rows = ref_pack(jnp.asarray(g_int), jnp.asarray(a_int), ref_plan)
    assert packed.dtype == torch.float32 and row_of.dtype == torch.int32
    np.testing.assert_array_equal(row_of.numpy(), want_rows)
    np.testing.assert_array_equal(slot_map(plan.row_ranges, plan.max_load), want_rows)
    np.testing.assert_array_equal(packed.numpy(), want)
    assert (row_of.numpy() < 0).any()  # this fleet's blocks carry pads
    # the reference's Gaussian generator: f32 sums of k terms
    g = _ref_g(plan.n, k)
    packed, row_of = pack_coded_matrix(torch.from_numpy(g), torch.from_numpy(a), plan)
    want, want_rows = ref_pack(jnp.asarray(g), jnp.asarray(a), ref_plan)
    np.testing.assert_array_equal(row_of.numpy(), want_rows)
    np.testing.assert_allclose(packed.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not packed.numpy()[row_of.numpy() < 0].any()  # pads are zero


@pytest.mark.parametrize("w,l,d", [(3, 7, 40), (8, 203, 300), (2, 256, 1024)])
def test_blocked_matvec_batch_matches_pallas_interpret(w, l, d):
    rng = np.random.default_rng(w * l + d)
    a = rng.standard_normal((w, l, d)).astype(np.float32)
    x = rng.standard_normal(d).astype(np.float32)
    got = blocked_matvec_batch(torch.from_numpy(a), torch.from_numpy(x))
    want = ref_cmv.blocked_matvec_batch(jnp.asarray(a), jnp.asarray(x), interpret=True)
    assert tuple(got.shape) == (w, l)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(coded_matvec(torch.from_numpy(a), torch.from_numpy(x)).numpy(),
                               got.numpy(), rtol=0, atol=0)


#: ten workers over n = 48 coded rows, max_load 8: pads in all but two
#: blocks. Erasing workers {}, {0}, {0, 1}, {2, 3} erases exactly 0, 3, 8
#: and 16 rows (16 = n - k, the threshold); {1, 2, 3} erases 21.
LOADS = [3, 5, 8, 8, 4, 4, 4, 4, 4, 4]
ERASED = {0: [], 3: [0], 8: [0, 1], 16: [2, 3], 21: [1, 2, 3]}
K, N, ML = 32, 48, 8


def _grid(erasures, cols, seed=0):
    """(g, row_of, packed, partials, fin, x): the grid deployment with
    garbage in every pad slot and in every slot of an erased worker."""
    g = _ref_g(N, K)
    rng = np.random.default_rng(100 + erasures + seed)
    shape = (K,) if cols is None else (K, cols)
    x = rng.standard_normal(shape).astype(np.float32)
    row_of = np.full((len(LOADS), ML), -1, np.int32)
    start = 0
    for w, load in enumerate(LOADS):
        row_of[w, :load] = np.arange(start, start + load)
        start += load
    coded = g @ x  # (N,) or (N, cols)
    partials = np.full((len(LOADS), ML) + shape[1:], 1e30, np.float32)
    partials[row_of >= 0] = coded[row_of[row_of >= 0]]
    fin = np.ones(len(LOADS), bool)
    fin[ERASED[erasures]] = False
    partials[~fin] = np.nan  # a dead worker's slots hold anything
    return g, row_of, partials, fin, x


@pytest.mark.parametrize("erasures", [0, 3, 8, 16])  # 16 = exactly threshold
@pytest.mark.parametrize("cols", [None, 5])
@pytest.mark.parametrize(**SOLVES)
def test_masked_decode_matches_reference_across_erasure_grid(erasures, cols, solve):
    g, row_of, partials, fin, x = _grid(erasures, cols)
    z, ok = _masked_decode(g, row_of, partials, fin, solve)
    assert bool(ok) and tuple(z.shape) == x.shape and z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), x, **TOL)
    if cols is None:
        want, want_ok = ref_masked_decode(jnp.asarray(g), jnp.asarray(row_of),
                                          jnp.asarray(partials), jnp.asarray(fin))
    else:  # the reference scatters one column; decode its scattered rows
        alive = np.zeros(N, bool)
        alive[row_of[(row_of >= 0) & fin[:, None]]] = True
        y = np.zeros((N, cols), np.float32)
        y[alive] = (g @ x)[alive]
        want, want_ok = ref_decode_jit(jnp.asarray(g), jnp.asarray(y), jnp.asarray(alive))
        assert int(alive.sum()) == N - erasures
    assert bool(want_ok)
    np.testing.assert_allclose(z.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("erasures", [0, 3, 8, 16])
def test_decode_pipeline_matches_reference_across_erasure_grid(erasures):
    """Products, mask and decode in one master step, against the
    reference's ``DecodePipeline`` (one-device mesh, einsum route)."""
    g, row_of, _, fin, _ = _grid(erasures, None)
    d = 24
    rng = np.random.default_rng(erasures)
    a = rng.standard_normal((K, d)).astype(np.float32)
    v = rng.standard_normal(d).astype(np.float32)
    coded = g @ a
    packed = np.zeros((len(LOADS), ML, d), np.float32)
    packed[row_of >= 0] = coded[row_of[row_of >= 0]]
    z, ok = DecodePipeline(torch.from_numpy(g), torch.from_numpy(row_of))(
        torch.from_numpy(packed), torch.from_numpy(v), torch.from_numpy(fin))
    want, want_ok = RefPipeline(_mesh(), g, row_of)(jnp.asarray(packed), jnp.asarray(v),
                                                    jnp.asarray(fin))
    assert bool(ok) and bool(want_ok)
    np.testing.assert_allclose(z.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(z.numpy(), a @ v, **TOL)


@pytest.mark.parametrize("cols", [None, 5])
@pytest.mark.parametrize(**SOLVES)
def test_masked_decode_insufficient_survivors_zeroed(cols, solve):
    """21 rows erased (> n - k): ok False and an exactly zero output."""
    g, row_of, partials, fin, x = _grid(21, cols)
    z, ok = _masked_decode(g, row_of, partials, fin, solve)
    assert not bool(ok)
    np.testing.assert_array_equal(z.numpy(), np.zeros(x.shape, np.float32))
    if cols is None:
        want, want_ok = ref_masked_decode(g, row_of, partials, fin)
        assert not bool(want_ok)
        np.testing.assert_array_equal(z.numpy(), np.asarray(want))


@pytest.mark.parametrize(**SOLVES)
def test_masked_decode_drops_pad_and_dead_slots(solve):
    """Garbage (1e30 in pads, NaN in a dead worker's slots) must not reach
    the solve: the result equals the one from clean partials."""
    g, row_of, partials, fin, x = _grid(8, None, seed=1)
    clean = np.where(np.isfinite(partials) & (np.abs(partials) < 1e29), partials, 0.0)
    got, ok = _masked_decode(g, row_of, partials, fin, solve)
    base, ok2 = _masked_decode(g, row_of, clean.astype(np.float32), fin, solve)
    assert bool(ok) and bool(ok2) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), base.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), x, **TOL)


#: one coded row a worker and a pad slot each, on a code whose c = n - k =
#: 260 is no multiple of 128; (erased systematic rows, erased parity rows)
#: -> the sized system's rows, as in ``tests/test_torch_coding.py``
BIG_K, BIG_N = 400, 660
SIZED = {(0, 0): 0, (1, 5): 128, (128, 40): 128, (129, 0): 256,
         (260, 0): 260, (100, 200): 0}


@pytest.mark.parametrize("cols", [None, 5])
@pytest.mark.parametrize("erased", list(SIZED), ids=[f"e{e}-p{p}" for e, p in SIZED])
def test_masked_decode_sizes_the_solve_across_erasure_grid(erased, cols):
    """``masked_decode`` solves at e rounded up to 128 (at most c), none
    where e is 0 or fewer than k rows survive, against the reference and
    A x; each query counts once in ``erasure_solve_rows`` at its size."""
    e, lost = erased
    g = _ref_g(BIG_N, BIG_K)
    rng = np.random.default_rng(100 + e)
    shape = (BIG_K,) if cols is None else (BIG_K, cols)
    x = rng.standard_normal(shape).astype(np.float32)
    row_of = np.stack([np.arange(BIG_N, dtype=np.int32), np.full(BIG_N, -1, np.int32)], 1)
    partials = np.full((BIG_N, 2) + shape[1:], 1e30, np.float32)
    partials[:, 0] = g @ x
    fin = np.ones(BIG_N, bool)
    fin[rng.choice(BIG_K, size=e, replace=False)] = False
    fin[BIG_K + rng.choice(BIG_N - BIG_K, size=lost, replace=False)] = False
    partials[~fin] = np.nan
    decodable = int(fin.sum()) >= BIG_K
    rows = lambda: {r["labels"]["size"]: r["value"] for r in REGISTRY.snapshot()  # noqa: E731
                    if r["name"] == "erasure_solve_rows"}
    before = rows()
    z, ok = masked_decode(torch.from_numpy(g), torch.from_numpy(row_of),
                          torch.from_numpy(partials), torch.from_numpy(fin))
    after = rows()
    assert {s: v - before.get(s, 0) for s, v in after.items() if v != before.get(s, 0)} \
        == {SIZED[erased]: 1}
    assert bool(ok) == decodable and tuple(z.shape) == x.shape
    if cols is None:
        want, want_ok = ref_masked_decode(jnp.asarray(g), jnp.asarray(row_of),
                                          jnp.asarray(partials), jnp.asarray(fin))
    else:  # the reference scatters one column; decode its scattered rows
        y = np.where(fin[:, None], g @ x, 0).astype(np.float32)
        want, want_ok = ref_decode_jit(jnp.asarray(g), jnp.asarray(y), jnp.asarray(fin))
    assert bool(want_ok) == decodable
    if not decodable:
        np.testing.assert_array_equal(z.numpy(), np.zeros(x.shape, np.float32))
        return
    np.testing.assert_allclose(z.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(z.numpy(), x, **TOL)


@pytest.mark.parametrize("erased", [[], [7], [0, 6]])
def test_decode_coded_result_matches_reference(erased):
    """The host least-squares oracle on a real deployment's packed products."""
    plan, ref_plan = _plans(1, 40)
    g = _ref_g(plan.n, plan.k)
    rng = np.random.default_rng(len(erased))
    a = rng.standard_normal((plan.k, 12)).astype(np.float32)
    v = rng.standard_normal(12).astype(np.float32)
    packed, row_of = pack_coded_matrix(torch.from_numpy(g), torch.from_numpy(a), plan)
    partials = coded_matvec(packed, torch.from_numpy(v))
    fin = np.ones(plan.num_workers, bool)
    fin[erased] = False
    z, ok = decode_coded_result(torch.from_numpy(g), row_of, partials, fin, plan.k)
    want, want_ok = ref_decode_result(g, row_of.numpy(), partials.numpy(), fin, plan.k)
    assert ok and want_ok and isinstance(z, np.ndarray)
    np.testing.assert_allclose(z, want, **TOL)
    np.testing.assert_allclose(z, a @ v, **TOL)
    fin[:] = False
    z, ok = decode_coded_result(g, row_of, partials, fin, plan.k)
    assert not ok and not ref_decode_result(g, row_of.numpy(), partials.numpy(), fin,
                                            plan.k)[1]
    np.testing.assert_array_equal(z, np.zeros(plan.k, np.float32))


@pytest.mark.parametrize("host_decode", [False, True])
@pytest.mark.parametrize("fi", [0, 1])
def test_end_to_end_matches_reference(fi, host_decode):
    """Encode -> pack -> products -> decode, one straggler erased, with the
    reference's generator injected; also held against A x itself."""
    k, d = 64, 32
    plan, ref_plan = _plans(fi, k)
    a = np.asarray(jax.random.normal(KEY, (k, d)), np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (d,)), np.float32)
    fin = np.ones(plan.num_workers, bool)
    fin[plan.num_workers - 1] = False
    g = _ref_g(plan.n, k)
    z, ok = end_to_end_coded_matvec(a, x, plan, fin, g=g, host_decode=host_decode,
                                    device="cpu")
    want, want_ok = ref_end_to_end(_mesh(), jnp.asarray(a), jnp.asarray(x), ref_plan,
                                   finished_workers=fin, key=KEY,
                                   jit_decode=not host_decode)
    assert bool(ok) and bool(want_ok)
    z = z.numpy() if torch.is_tensor(z) else z
    np.testing.assert_allclose(z, np.asarray(want), **TOL)
    np.testing.assert_allclose(z, a @ x, **TOL)


def test_end_to_end_seeded_generator_and_refusals():
    """The port's own seeded code decodes too; A must have the plan's k rows."""
    plan, _ = _plans(0, 64)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 20)).astype(np.float32)
    x = rng.standard_normal(20).astype(np.float32)
    z, ok = end_to_end_coded_matvec(a, x, plan, seed=5, device="cpu")
    assert bool(ok)
    np.testing.assert_allclose(z.numpy(), a @ x, **TOL)
    z, ok = end_to_end_coded_matvec(a, x, plan, np.zeros(plan.num_workers, bool),
                                    device="cpu")
    assert not bool(ok) and not z.numpy().any()
    with pytest.raises(ValueError, match="rows"):
        end_to_end_coded_matvec(a[:-1], x, plan, device="cpu")


def test_encode_feeds_pack_through_the_kernel_wrapper():
    """``pack_coded_matrix`` encodes with ``coding.encode`` (B3 on the
    card): its live slots equal ``encode``'s rows bit for bit."""
    plan, _ = _plans(1, 40)
    g = torch.from_numpy(_ref_g(plan.n, plan.k))
    a = torch.from_numpy(np.random.default_rng(9).standard_normal((40, 7)).astype(np.float32))
    packed, row_of = pack_coded_matrix(g, a, plan)
    live = row_of >= 0
    assert torch.equal(packed[live], encode(g, a)[row_of[live].long()])


@pytest.mark.parametrize("ours,ref", [(masked_decode, ref_masked_decode),
                                      (decode_systematic, ref_decode_jit)],
                         ids=["masked_decode", "decode_systematic"])
def test_the_decode_entry_points_take_the_references_parameters(ours, ref):
    """The reference's names keep its signatures: the solve is the bound
    decoder's choice, so neither takes an option of its own."""
    want = list(inspect.signature(getattr(ref, "__wrapped__", ref)).parameters)
    assert list(inspect.signature(ours).parameters) == want
