"""Port parity, kernel families on the CPU: each wrapper's plain path.

On a CPU tensor every wrapper runs its plain PyTorch version; these
tests hold that version against the reference's ``ops`` function with
the Pallas kernel run as the reference's own tests run it
(``interpret=True``) and against each family's ``ref.py`` oracle. All
float32: the tolerance is the reference kernel tests' 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_pa
from repro.kernels.coded_matvec import ops as ref_cmv
from repro.kernels.coded_matvec.ref import matvec_ref
from repro.kernels.mds_encode import ops as ref_mds
from repro.kernels.mds_encode.ref import encode_ref
import repro_torch.kernels as kernels
from repro_torch.kernels.coded_matvec.ops import blocked_matvec
from repro_torch.kernels.fused_ce.ops import fused_ce
from repro_torch.kernels.mds_encode.ops import mds_encode
from repro_torch.kernels.paged_attention import ops as pa

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
t = torch.from_numpy


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------- B1 coded matvec
@pytest.mark.parametrize("r,d", [(256, 1024), (300, 1500), (7, 33)])
def test_blocked_matvec_matches_pallas_interpret(r, d):
    rng = _rng(r)
    a = (rng.standard_normal((r, d)) / np.sqrt(d)).astype(np.float32)  # O(1) outputs
    x = rng.standard_normal(d).astype(np.float32)
    got = blocked_matvec(t(a), t(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_cmv.blocked_matvec(a, x, interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(matvec_ref(a, x)), **TOL)


def test_blocked_matvec_column_batch_matches_vmapped_reference():
    """The serve loop's block mix: G (nb, kb) times X (kb, B*R) in one call
    equals the reference's vmap of one Pallas matvec per column."""
    rng = _rng(5)
    g = rng.standard_normal((14, 8)).astype(np.float32)
    x = rng.standard_normal((8, 2 * 64)).astype(np.float32)
    want = jax.vmap(lambda col: ref_cmv.blocked_matvec(g, col, interpret=True),
                    in_axes=1, out_axes=1)(jnp.asarray(x))
    np.testing.assert_allclose(blocked_matvec(t(g), t(x)).numpy(),
                               np.asarray(want), **TOL)


# -------------------------------------------------------- B3 MDS encode
@pytest.mark.parametrize("n,k,d", [(20, 16, 300), (256, 256, 256), (9, 5, 130)])
def test_mds_encode_matches_pallas_interpret(n, k, d):
    rng = _rng(n + d)
    g = rng.standard_normal((n, k)).astype(np.float32)
    a = rng.standard_normal((k, d)).astype(np.float32)
    got = mds_encode(t(g), t(a)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_mds.mds_encode(g, a, interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(encode_ref(g, a)), **TOL)


# -------------------------------------------------- B2 paged decode attend
def _rand_paged(seed, *, s=3, nb=6, bl=4, kv=2, g=2, hd=8):
    """Random pool + a scattered (non-contiguous) block layout (the
    reference's ``tests/test_paged_kv.py`` fixture)."""
    rng = _rng(seed)
    k_pool = rng.standard_normal((nb + 1, bl, kv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((nb + 1, bl, kv, hd)).astype(np.float32)
    q = rng.standard_normal((s, kv, g, hd)).astype(np.float32)
    table = np.full((s, nb), -1, np.int32)
    table[0, :2] = [3, 0]
    table[1, :3] = [1, 4, 2]
    table[2, :1] = [5]
    pos = np.array([5, 9, 2], np.int32)
    return q, k_pool, v_pool, table, pos


def test_paged_decode_attend_matches_ref_ops_and_pallas_interpret():
    args = _rand_paged(1)
    got = pa.paged_decode_attend(*map(t, args)).numpy()
    np.testing.assert_allclose(got, ref_pa.paged_decode_attend_ref(*args), **TOL)
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got, np.asarray(ref_pa.paged_decode_attend(*jargs)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref_pa.paged_decode_attend_kernel(*jargs, interpret=True)), **TOL)


def test_paged_decode_attend_skips_unallocated_and_sink():
    """A hole in a slot's table and NaN in the sink never reach any slot;
    a slot with no valid entry returns zeros (its row is discarded by the
    serve loop; the kernel and the plain version both return zeros)."""
    q, k_pool, v_pool, table, pos = _rand_paged(2)
    table = np.concatenate([table, np.full((1, table.shape[1]), -1, np.int32)])
    pos = np.append(pos, 3).astype(np.int32)
    q = np.concatenate([q, q[:1]])
    want = ref_pa.paged_decode_attend_ref(q[:3], k_pool, v_pool, table[:3], pos[:3])
    k_pool[-1] = np.nan
    v_pool[-1] = np.nan
    got = pa.paged_decode_attend(t(q), t(k_pool), t(v_pool), t(table), t(pos)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:3], want, **TOL)
    np.testing.assert_array_equal(got[3], np.zeros_like(got[3]))


def test_paged_chunk_attend_matches_ref():
    rng = _rng(2)
    _, k_pool, v_pool, table, _ = _rand_paged(2)
    s, c = table.shape[0], 3
    q = rng.standard_normal((s, c, 2, 2, 8)).astype(np.float32)
    start = np.array([2, 6, 0], np.int32)
    q_pos = start[:, None] + np.arange(c, dtype=np.int32)[None, :]
    got = pa.paged_chunk_attend(t(q), t(k_pool), t(v_pool), t(table), t(q_pos))
    np.testing.assert_allclose(
        got.numpy(), ref_pa.paged_chunk_attend_ref(q, k_pool, v_pool, table, q_pos), **TOL)


def test_gather_and_valid_mask_match_reference():
    _, k_pool, _, table, pos = _rand_paged(3)
    np.testing.assert_array_equal(pa.gather_kv(t(k_pool), t(table)).numpy(),
                                  np.asarray(ref_pa.gather_kv(k_pool, table)))
    np.testing.assert_array_equal(pa.valid_mask(t(table), 4, t(pos)).numpy(),
                                  np.asarray(ref_pa.valid_mask(table, 4, pos)))


def test_scatter_decode_matches_reference_and_routes_to_sink():
    rng = _rng(4)
    nb, bl, kv, hd = 4, 2, 1, 3
    k_pool = rng.standard_normal((nb + 1, bl, kv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((nb + 1, bl, kv, hd)).astype(np.float32)
    table = np.array([[0, 1], [2, 3], [-1, -1]], np.int32)
    k_new = rng.standard_normal((3, kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((3, kv, hd)).astype(np.float32)
    pos = np.array([1, 3, 0], np.int32)
    active = np.array([True, False, True])
    want_k, want_v = ref_pa.scatter_decode(*map(jnp.asarray, (
        k_pool, v_pool, k_new, v_new, table, pos, active)))
    got_k, got_v = t(k_pool.copy()), t(v_pool.copy())
    pa.scatter_decode(got_k, got_v, t(k_new), t(v_new), t(table), t(pos), t(active))
    # inactive slot 1 and unallocated slot 2 both landed in the sink: the
    # winner of that duplicate write is unspecified, so compare real blocks
    np.testing.assert_array_equal(got_k[:nb].numpy(), np.asarray(want_k)[:nb])
    np.testing.assert_array_equal(got_v[:nb].numpy(), np.asarray(want_v)[:nb])
    np.testing.assert_array_equal(got_k[0, 1].numpy(), k_new[0])
    np.testing.assert_array_equal(got_k[1:nb].numpy(), k_pool[1:nb])


def test_scatter_chunk_matches_reference():
    rng = _rng(6)
    nb, bl, kv, hd, c = 6, 4, 2, 8, 5
    k_pool = np.zeros((nb + 1, bl, kv, hd), np.float32)
    v_pool = np.zeros((nb + 1, bl, kv, hd), np.float32)
    table = np.array([[3, 0, -1, -1, -1, -1], [1, 4, 2, -1, -1, -1]], np.int32)
    k_new = rng.standard_normal((2, c, kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((2, c, kv, hd)).astype(np.float32)
    start = np.array([2, 6], np.int32)
    lens = np.array([5, 3], np.int32)
    want_k, want_v = ref_pa.scatter_chunk(*map(jnp.asarray, (
        k_pool, v_pool, k_new, v_new, table, start, lens)))
    got_k, got_v = t(k_pool.copy()), t(v_pool.copy())
    pa.scatter_chunk(got_k, got_v, t(k_new), t(v_new), t(table), t(start), t(lens))
    np.testing.assert_array_equal(got_k[:nb].numpy(), np.asarray(want_k)[:nb])
    np.testing.assert_array_equal(got_v[:nb].numpy(), np.asarray(want_v)[:nb])


# ------------------------------------------------------------- dispatch
def test_wrappers_run_plain_on_cpu_and_refuse_other_devices():
    """No fallback: a CPU tensor takes the plain path without launching; a
    ``meta`` tensor returns the kernel's empty output without launching
    (the dry-run's shapes-only path); a tensor on any other non-CUDA
    device raises."""
    kernels.reset_launch_counts()
    a = torch.ones((4, 3))
    blocked_matvec(a, torch.ones(3))
    mds_encode(a, torch.ones((3, 2)))
    lse, _, _ = fused_ce(a, torch.ones((5, 3)), torch.zeros(4, dtype=torch.long))
    assert lse.shape == (4,)
    meta = torch.empty((4, 4), device="meta")
    assert blocked_matvec(meta, torch.empty(4, device="meta")).shape == (4,)
    assert mds_encode(meta, torch.empty((4, 2), device="meta")).shape == (4, 2)
    q = torch.empty((1, 1, 1, 32), device="meta")
    pool = torch.empty((2, 16, 1, 32), device="meta")
    ints = torch.empty((1, 1), dtype=torch.int32, device="meta")
    assert pa.paged_decode_attend(q, pool, pool, ints, ints[0]).shape == q.shape
    assert fused_ce(meta, meta, torch.empty(4, dtype=torch.long, device="meta"))[0].shape == (4,)
    assert kernels.launch_counts() == {
        "coded_matvec": 0, "paged_decode": 0, "mds_encode": 0,
        "fused_ce_fwd": 0, "fused_ce_bwd_dh": 0, "fused_ce_bwd_de": 0}

    class Elsewhere:
        """A tensor's stand-in on a device the wrappers do not serve."""
        device = torch.device("xla")
        shape = (1, 1, 1, 32)
        dtype = torch.float32

        def dim(self):
            return len(self.shape)

        def element_size(self):
            return 4

    other = Elsewhere()
    with pytest.raises(ValueError, match="unsupported device"):
        blocked_matvec(other, other)
    with pytest.raises(ValueError, match="unsupported device"):
        mds_encode(other, other)
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_decode_attend(other, other, other, ints, ints[0])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ce(other, other, other)


def test_kernel_sources_are_where_the_wrappers_say():
    for k in kernels.KERNELS:
        assert k.source.is_file() and k.source.suffix == ".cu"
        text = k.source.read_text()
        assert "Replaces: src/repro/kernels/" in text
        assert all(fn in text for fn in k.functions)
