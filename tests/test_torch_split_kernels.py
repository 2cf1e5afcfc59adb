"""Port parity on the CPU for the Python around the split kernels B1 and B2.

The CUDA kernels run only on the card; what surrounds them is reachable
here: B1's launch plan (the split of K per shape) and B2's split grid
(one split per table entry, from the table's width). Each kernel's
partition and fixed-order combine is mirrored in plain torch below (used
by these tests only) and held on seeded numpy inputs against the JAX
reference: its Pallas kernel run with ``interpret=True`` as the
reference's own tests run it, its ``ref.py`` oracle, and the port's plain
version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_pa
from repro.kernels.coded_matvec import ops as ref_cmv
from repro_torch.kernels.coded_matvec import ops as cmv
from repro_torch.kernels.paged_attention import ops as pa

torch.set_num_threads(1)

U32 = 2.0**-24
H100_SMS = 132
NEG_INF = -1e30


# ------------------------------------------------------------ B1 plan
def test_gemm_plan_fills_the_card_at_the_main_shape():
    """(738, 594) x (594, 1024): at least one block per SM, against 24
    tiles of 128 x 256 at one split."""
    plan = cmv.gemm_plan(738, 1024, 594, H100_SMS)
    tiles = -(-738 // cmv.TILE[0]) * -(-1024 // cmv.TILE[1])
    assert tiles == 24
    assert plan.blocks == tiles * plan.splits >= H100_SMS
    assert (plan.per_split, plan.splits) == (7, 6)


@pytest.mark.parametrize("m,n", [(1, 1), (738, 1024), (188_928, 4), (65, 7)])
@pytest.mark.parametrize("k", [1, 9, 16])
def test_gemm_plan_tiny_k_is_one_split(m, n, k):
    assert cmv.gemm_plan(m, n, k, H100_SMS).splits == 1
    assert cmv.gemm_plan(m, n, k, 10_000).splits == 1


@pytest.mark.parametrize("m,n,k", [(738, 1024, 594), (738, 1030, 594), (188_928, 4, 1024),
                                   (130, 4100, 17), (7, 5, 33), (129, 131, 130),
                                   (1, 1, 100_000), (738, 256, 594)])
@pytest.mark.parametrize("sms", [1, 16, H100_SMS, 10_000])
def test_gemm_plan_covers_k_with_no_empty_split(m, n, k, sms):
    """Every K slice lies in exactly one split and no split is empty (the
    kernel would leave an empty split's partial unwritten); the splits
    stop at one a slice, and a card the tiles fill already takes one."""
    plan = cmv.gemm_plan(m, n, k, sms)
    slices = max(1, -(-k // cmv.BK))
    tiles = -(-m // cmv.TILE[0]) * -(-n // cmv.TILE[1])
    assert 1 <= plan.splits <= min(slices, max(1, -(-sms // tiles)))
    assert plan.per_split * plan.splits >= slices
    assert plan.per_split * (plan.splits - 1) < slices
    assert plan.blocks == tiles * plan.splits
    if tiles >= sms:
        assert plan.splits == 1


def test_partial_stride_keeps_partials_16_byte_aligned():
    for m, n in [(738, 1024), (7, 5), (1, 1), (3, 3)]:
        stride = cmv.partial_stride(m, n)
        assert stride % 4 == 0 and m * n <= stride < m * n + 4


# ---------------------------------------------------------- B1 mirror
def split_k_mirror(a: torch.Tensor, x: torch.Tensor, plan: cmv.GemmPlan) -> torch.Tensor:
    """The kernel's partition in plain torch: each split's f32 partial over
    its K slices, then the partials summed in split order."""
    k = a.shape[1]
    span = plan.per_split * cmv.BK
    out = None
    for z in range(plan.splits):
        k0, k1 = z * span, min((z + 1) * span, k)
        part = torch.matmul(a[:, k0:k1].float(), x[k0:k1].float())
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("m,k,n,sms", [(738, 594, 8, H100_SMS), (738, 594, 8, 3),
                                       (300, 1500, 5, 7), (7, 33, 3, 64), (40, 9, 2, H100_SMS)])
def test_split_k_mirror_matches_pallas_interpret(m, k, n, sms):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    x = rng.standard_normal((k, n)).astype(np.float32)
    plan = cmv.gemm_plan(m, n, k, sms)
    got = split_k_mirror(torch.from_numpy(a), torch.from_numpy(x), plan).numpy()
    want = np.asarray(jax.vmap(lambda col: ref_cmv.blocked_matvec(a, col, interpret=True),
                               in_axes=1, out_axes=1)(jnp.asarray(x)))
    tol = 2 * k * U32 * float((np.abs(a) @ np.abs(x)).max())
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - cmv.blocked_matvec(torch.from_numpy(a), torch.from_numpy(x))
                  .numpy()).max() <= tol


# ------------------------------------------------------------ B2 grid
@pytest.mark.parametrize("mb,want", [(72, 72), (1, 1), (24, 24), (13, 13), (7, 7),
                                     (100, 100), (0, 1)])
def test_decode_splits_from_table_width(mb, want):
    """One split per table entry, the grid sized from MB alone; an empty
    table still has one split, which finds no valid entry."""
    assert pa.decode_splits(mb) == want


def test_decode_scratch_at_the_serve_shape():
    nsplit = pa.decode_splits(72)
    assert pa.decode_scratch_floats(4, 8, 2, 128, nsplit) == 4 * 8 * 2 * 72 * 130


# ---------------------------------------------------------- B2 mirror
def split_decode_mirror(q, k_pool, v_pool, table, pos):
    """The split kernel and its combine in plain float32 torch.

    Split i is table entry i: logical tokens [i BL, (i + 1) BL); a split
    that starts past pos is not run. Each run split keeps (m, l, acc) with
    m starting at -1e30 over its valid tokens (allocated, in the pool, <=
    pos); masked tokens are never read. The combine folds the run splits
    in order: m = max m_i, l = sum l_i e^(m_i - m), acc likewise, and
    returns acc / max(l, 1e-30).
    """
    s, kv, g, hd = q.shape
    nbp, bl = k_pool.shape[:2]
    mb = table.shape[1]
    span = bl
    nsplit = pa.decode_splits(mb)
    scale = 1.0 / np.sqrt(hd)
    out = torch.zeros((s, kv, g, hd), dtype=torch.float32)
    for si in range(s):
        p = int(pos[si])
        parts = []
        for i in range(nsplit):
            t0 = i * span
            if t0 > p:
                break
            m = torch.full((kv, g), NEG_INF)
            sc, vs = [], []
            for t in range(t0, min(t0 + span, p + 1, mb * bl)):
                phys = int(table[si, t // bl])
                if phys < 0 or phys >= nbp:
                    continue
                sc.append(torch.einsum("kgh,kh->kg", q[si].float(),
                                       k_pool[phys, t % bl].float()) * scale)
                vs.append(v_pool[phys, t % bl].float())
            if sc:
                sc_t = torch.stack(sc, -1)  # (KV, G, T)
                m = torch.maximum(m, sc_t.amax(-1))
                pr = torch.exp(sc_t - m[..., None])
                l_i = pr.sum(-1)
                acc = torch.einsum("kgt,tkh->kgh", pr, torch.stack(vs))
            else:
                l_i, acc = torch.zeros((kv, g)), torch.zeros((kv, g, hd))
            parts.append((m, l_i, acc))
        if not parts:
            continue
        m = torch.stack([pm for pm, _, _ in parts]).amax(0).clamp_min(NEG_INF)
        l_tot = torch.zeros((kv, g))
        acc_tot = torch.zeros((kv, g, hd))
        for pm, pl, pacc in parts:
            w = torch.exp(pm - m)
            l_tot = l_tot + pl * w
            acc_tot = acc_tot + pacc * w[..., None]
        out[si] = acc_tot / l_tot.clamp_min(1e-30)[..., None]
    return out


def _split_case(seed, *, g=2, hd=8, bl=4, kv=2, mb=30):
    """Slots that reach the split edges (a split is one table block): a
    long history with a split of holes after the first and two more in a
    row; pos at the last token of a split, the first token of the next,
    mid-block; pos = -1; a slot whose table has no entry. NaN in the sink
    block."""
    rng = np.random.default_rng(seed)
    nblk = mb + 12
    k_pool = rng.standard_normal((nblk + 1, bl, kv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((nblk + 1, bl, kv, hd)).astype(np.float32)
    q = rng.standard_normal((6, kv, g, hd)).astype(np.float32)
    perm = rng.permutation(nblk).astype(np.int32)
    table = np.full((6, mb), -1, np.int32)
    table[0] = perm[:mb]
    table[0, 1] = -1      # split 1: a hole
    table[0, 3:5] = -1    # splits 3 and 4: holes
    for si in (1, 2, 3):  # fully allocated: pos alone bounds the history
        table[si] = np.roll(perm, 7 * si)[:mb]
    pos = np.array([mb * bl - 1, bl - 1, bl, 2 * bl + bl // 2, -1, 3], np.int32)
    return q, k_pool, v_pool, table, pos


@pytest.mark.parametrize("g", [2, 8])
@pytest.mark.parametrize("bl", [1, 4, 5])
def test_split_decode_mirror_matches_reference_and_plain(g, bl):
    q, k_pool, v_pool, table, pos = _split_case(g * 10 + bl, g=g, bl=bl)
    sink_free = (q, k_pool, v_pool, table, pos)
    want_ref = ref_pa.paged_decode_attend_ref(*sink_free)
    jargs = [jnp.asarray(a) for a in sink_free]
    want_pallas = np.asarray(ref_pa.paged_decode_attend_kernel(*jargs, interpret=True))
    k_nan, v_nan = k_pool.copy(), v_pool.copy()
    k_nan[-1] = np.nan
    v_nan[-1] = np.nan
    t = torch.from_numpy
    got = split_decode_mirror(t(q), t(k_nan), t(v_nan), t(table), t(pos)).numpy()
    plain = pa.paged_decode_attend_plain(t(q), t(k_nan), t(v_nan), t(table), t(pos)).numpy()
    assert np.isfinite(got).all()
    # slots 4 (pos = -1) and 5 (no table entry) have no valid entry: zeros
    # in the port; the reference returns the mean of the gathered sink
    np.testing.assert_array_equal(got[4:], np.zeros_like(got[4:]))
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:4], want_ref[:4], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:4], want_pallas[:4], rtol=1e-5, atol=1e-5)


def test_split_decode_mirror_one_split_is_the_plain_attend():
    """A table of one entry is one split: the partition is the plain
    online softmax and the combine a division."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((4, 2, 2, 8)).astype(np.float32))
    k_pool = torch.from_numpy(rng.standard_normal((4, 16, 2, 8)).astype(np.float32))
    v_pool = torch.from_numpy(rng.standard_normal((4, 16, 2, 8)).astype(np.float32))
    table = torch.tensor([[2], [0], [-1], [1]], dtype=torch.int32)
    pos = torch.tensor([15, 0, 9, 40], dtype=torch.int32)
    got = split_decode_mirror(q, k_pool, v_pool, table, pos)
    np.testing.assert_allclose(
        got.numpy(), pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos).numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [-1, 0, 20])
def test_split_decode_mirror_empty_table_is_zeros(p):
    """MB = 0: the grid still has its one split, which finds no entry;
    every slot returns zeros, as the plain version does."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 2, 2, 8)).astype(np.float32))
    pool = torch.from_numpy(rng.standard_normal((3, 4, 2, 8)).astype(np.float32))
    table = torch.zeros((2, 0), dtype=torch.int32)
    pos = torch.tensor([p, 3], dtype=torch.int32)
    got = split_decode_mirror(q, pool, pool, table, pos)
    assert pa.decode_splits(0) == 1
    np.testing.assert_array_equal(got.numpy(), np.zeros((2, 2, 2, 8), np.float32))
    np.testing.assert_array_equal(
        pa.paged_decode_attend_plain(q, pool, pool, table, pos).numpy(), got.numpy())
