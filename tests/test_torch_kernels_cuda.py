"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip on a
machine without CUDA. Run them on the card with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the port does not need.)

Shapes are ragged on purpose (tile and split-K edges of the GEMMs; GQA
group sizes, head dims, block lengths and split edges of the decode
attend; vocab tails and token counts off the fused cross-entropy's
tiles).
"""
import pytest
import torch

import repro_torch.kernels as kernels
from repro_torch.kernels.coded_matvec import ops as cmv
from repro_torch.kernels.fused_ce import ops as ce
from repro_torch.kernels.mds_encode import ops as mds
from repro_torch.kernels.paged_attention import ops as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gemm_tol(a, b):
    """Worst-case float32 dot-product error of either side: 2 K u max(|A||B|)."""
    return 2 * a.shape[1] * 2.0**-24 * float((a.abs() @ b.abs()).max())


# the last three reach the edges of mds_encode's pipeline: K below one
# 16-deep slice, N % 4 != 0 at the main path's M = 738 and K = 594, and K
# one past a slice
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (7, 33, 5), (129, 130, 131),
                                   (738, 594, 1024), (65, 600, 1),
                                   (33, 9, 260), (738, 594, 1030), (130, 17, 4100)])
@pytest.mark.parametrize("op", ["coded_matvec", "mds_encode"])
def test_gemm_kernels_match_plain(dev, op, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    fn, plain = ((cmv.blocked_matvec, cmv.blocked_matvec_plain) if op == "coded_matvec"
                 else (mds.mds_encode, mds.mds_encode_plain))
    before = kernels.launch_counts()[op]
    got = fn(a, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[op] == before + 1
    assert (got - plain(a, b)).abs().max().item() <= _gemm_tol(a, b)


def test_coded_matvec_worker_products_shape(dev):
    """CodedLMHead.worker_products: the coded table (nb R, D) times h^T
    (D, B) at full width, B = 4."""
    gen = torch.Generator(device=dev).manual_seed(4)
    a = torch.randn((188_928, 1024), generator=gen, device=dev) * 0.02
    h = torch.randn((1024, 4), generator=gen, device=dev)
    got = cmv.blocked_matvec(a, h)
    assert (got - cmv.blocked_matvec_plain(a, h)).abs().max().item() <= _gemm_tol(a, h)


def _launch_split(a, x, per_split, splits):
    """B1's kernel on a forced split of K (the wrapper picks its own)."""
    (m, k), n = a.shape, x.shape[1]
    y = torch.empty((m, n), device=a.device)
    stride = cmv.partial_stride(m, n)
    scratch = torch.empty(splits * stride, device=a.device)
    cmv.KERNEL.launch("repro_coded_matvec_f32", a.device, a.data_ptr(), x.data_ptr(),
                      y.data_ptr(), scratch.data_ptr(), m, n, k, per_split, splits, stride)
    return y


# 4 splits: 320 = 4 splits x 5 slices exactly; 319 ends inside the last
# slice; 321 needs a 21st slice (6 a split, the last one 3); 193 leaves
# the fourth split one slice of one k
@pytest.mark.parametrize("k,per,splits", [(319, 5, 4), (320, 5, 4), (321, 6, 4),
                                          (193, 4, 4)])
def test_coded_matvec_split_boundaries(dev, k, per, splits):
    m, n = 738, 1024
    gen = torch.Generator(device=dev).manual_seed(k)
    a = torch.randn((m, k), generator=gen, device=dev)
    x = torch.randn((k, n), generator=gen, device=dev)
    before = kernels.launch_counts()["coded_matvec"]
    got = _launch_split(a, x, per, splits)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["coded_matvec"] == before + 1
    assert (got - cmv.blocked_matvec_plain(a, x)).abs().max().item() <= _gemm_tol(a, x)


def test_coded_matvec_more_splits_than_slices(dev):
    """(200, 40) x (40, 300) is 4 tiles: the card would take 33 splits, K
    has 3 slices, so the plan stops at one split a slice. A forced split
    count that leaves a split empty is refused."""
    gen = torch.Generator(device=dev).manual_seed(40)
    a = torch.randn((200, 40), generator=gen, device=dev)
    x = torch.randn((40, 300), generator=gen, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cmv.gemm_plan(200, 300, 40, sms).splits == 3
    got = cmv.blocked_matvec(a, x)
    assert (got - cmv.blocked_matvec_plain(a, x)).abs().max().item() <= _gemm_tol(a, x)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch_split(a, x, 1, 5)


def test_coded_matvec_relaunch_is_bit_identical(dev):
    """The serve shape (738, 594) x (594, 1024), split K: the partials are
    summed in split order, so two launches give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(594)
    a = torch.randn((738, 594), generator=gen, device=dev)
    x = torch.randn((594, 1024), generator=gen, device=dev)
    assert cmv.gemm_plan(738, 1024, 594, torch.cuda.get_device_properties(dev)
                         .multi_processor_count).splits > 1
    first = cmv.blocked_matvec(a, x)
    assert torch.equal(first, cmv.blocked_matvec(a, x))
    assert (first - cmv.blocked_matvec_plain(a, x)).abs().max().item() <= _gemm_tol(a, x)


def test_coded_matvec_unaligned_operand(dev):
    """X not 16-byte aligned (4-byte copies) and N % 4 != 0, both split."""
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn((300, 500), generator=gen, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (516, 258):
        x = torch.randn(500 * n + 1, generator=gen, device=dev)[1:].view(500, n)
        assert x.is_contiguous() and x.data_ptr() % 16
        assert cmv.gemm_plan(300, n, 500, sms).splits > 1
        got = cmv.blocked_matvec(a, x)
        assert (got - cmv.blocked_matvec_plain(a, x)).abs().max().item() <= _gemm_tol(a, x)


def test_mds_encode_unaligned_operand(dev):
    """N % 4 == 0 but A not 16-byte aligned: the kernel's 4-byte copies."""
    m, k, n = 70, 40, 516
    g = torch.randn((m, k), device=dev)
    a = torch.randn(k * n + 1, device=dev)[1:].view(k, n)
    assert a.is_contiguous() and a.data_ptr() % 16
    got = mds.mds_encode(g, a)
    assert (got - mds.mds_encode_plain(g, a)).abs().max().item() <= _gemm_tol(g, a)


def test_matvec_vector_and_refusals(dev):
    a = torch.randn((40, 70), device=dev)
    x = torch.randn(70, device=dev)
    y = cmv.blocked_matvec(a, x)
    assert y.shape == (40,)
    assert (y - a @ x).abs().max().item() <= _gemm_tol(a, x[:, None])
    with pytest.raises(TypeError):
        cmv.blocked_matvec(a.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        cmv.blocked_matvec(a.T.contiguous().T, x)
    with pytest.raises(TypeError):
        mds.mds_encode(a.half(), torch.randn((70, 3), device=dev).half())


# the narrow (matvec) branch, N <= 8: K % 4 == 0 (16-byte loads) and not,
# one K tile and several (N K floats past 8,192), rows off a warp's pair
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("m,k", [(1, 1), (37, 4096), (203, 4099), (1001, 9000),
                                 (64, 2052)])
def test_coded_matvec_narrow_matches_plain(dev, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m * 10 + k + n)
    a = torch.randn((m, k), generator=gen, device=dev)
    x = torch.randn((k, n), generator=gen, device=dev)
    before = kernels.launch_counts()["coded_matvec"]
    got = cmv.blocked_matvec(a, x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["coded_matvec"] == before + 1
    assert got.shape == (m, n)
    assert (got - cmv.blocked_matvec_plain(a, x)).abs().max().item() <= _gemm_tol(a, x)


def test_coded_matvec_narrow_unaligned_operands(dev):
    """A and x off 16-byte alignment (A's 4-byte loads; x is staged with
    4-byte loads either way), K % 4 == 0 and not."""
    gen = torch.Generator(device=dev).manual_seed(11)
    for m, k in ((300, 512), (300, 513)):
        a = torch.randn(m * k + 1, generator=gen, device=dev)[1:].view(m, k)
        x = torch.randn(k + 1, generator=gen, device=dev)[1:]
        assert a.is_contiguous() and a.data_ptr() % 16 and x.data_ptr() % 16
        got = cmv.blocked_matvec(a, x)
        assert got.shape == (m,)
        assert (got - cmv.blocked_matvec_plain(a, x)).abs().max().item() <= _gemm_tol(
            a, x[:, None])


def test_coded_matvec_narrow_path_m_shape_and_relaunch(dev):
    """The paper's matvec at full width: the quickstart fleet's 200 workers
    x 203 packed rows, D = 4,096, through ``blocked_matvec_batch`` (one
    launch), held against the plain version; a relaunch is bit-identical."""
    w, l, d = 200, 203, 4096
    gen = torch.Generator(device=dev).manual_seed(17)
    a = torch.randn((w, l, d), generator=gen, device=dev)
    x = torch.randn(d, generator=gen, device=dev)
    before = kernels.launch_counts()["coded_matvec"]
    got = cmv.blocked_matvec_batch(a, x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["coded_matvec"] == before + 1
    assert got.shape == (w, l)
    flat = a.reshape(w * l, d)
    want = cmv.blocked_matvec_plain(flat, x).reshape(w, l)
    assert (got - want).abs().max().item() <= _gemm_tol(flat, x[:, None])
    assert torch.equal(cmv.blocked_matvec_batch(a, x), got)


def test_coded_matvec_batch_refusals(dev):
    with pytest.raises(ValueError, match="shapes"):
        cmv.blocked_matvec_batch(torch.randn((3, 4), device=dev), torch.randn(4, device=dev))
    with pytest.raises(TypeError):
        cmv.blocked_matvec_batch(torch.randn((2, 3, 4), device=dev).double(),
                                 torch.randn(4, device=dev).double())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,hd,bl", [(1, 32, 4), (2, 128, 16), (4, 64, 8), (8, 128, 16),
                                     (3, 96, 5), (8, 1024, 16), (2, 256, 64)])
def test_paged_decode_matches_plain(dev, dtype, g, hd, bl):
    gen = torch.Generator(device=dev).manual_seed(g * hd + bl)
    s, kv, nblk = 4, 2, 24
    k_pool = torch.randn((nblk + 1, bl, kv, hd), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((nblk + 1, bl, kv, hd), generator=gen, device=dev).to(dtype)
    k_pool[nblk] = float("nan")  # the sink: must never be read
    v_pool[nblk] = float("nan")
    q = torch.randn((s, kv, g, hd), generator=gen, device=dev).to(dtype)
    table = torch.full((s, nblk), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(nblk, generator=gen, device=dev).to(torch.int32)
    table[0, :6], table[1, :3], table[2, :1] = perm[:6], perm[6:9], perm[9:10]
    table[0, 2] = -1
    pos = torch.tensor([6 * bl - 1, 2 * bl + 1, 0, 5], dtype=torch.int32, device=dev)
    got = pa.paged_decode_attend(q, k_pool, v_pool, table, pos)
    want = pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert bool((got[3] == 0).all())  # slot 3 has no valid entry
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        # per element: at most one bf16 rounding step apart
        assert bool((diff <= 2.0**-7 * want.float().abs() + 1e-6).all())
    else:
        assert diff.max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def _decode_close(got, want, dtype):
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        # per element: at most one bf16 rounding step apart
        return bool((diff <= 2.0**-7 * want.float().abs() + 1e-6).all())
    return diff.max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [2, 8])
def test_paged_decode_split_edges(dev, dtype, g):
    """The serve loop's widths (hd = 128, 16-token blocks, a table as wide
    as the pool, MB = 72: 72 splits of one block) with slots that reach
    the split edges: a history over every split with split 2 a hole and
    splits 4 and 5 holes; pos at the last token of a split, at the first
    of the next, mid-block; pos = -1; no table entry at all. NaN in the
    sink; a second launch bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(72 * g)
    s, kv, hd, bl, mb = 7, 2, 128, 16, 72
    assert pa.decode_splits(mb) == 72
    k_pool = torch.randn((mb + 1, bl, kv, hd), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((mb + 1, bl, kv, hd), generator=gen, device=dev).to(dtype)
    k_pool[mb] = float("nan")
    v_pool[mb] = float("nan")
    q = torch.randn((s, kv, g, hd), generator=gen, device=dev).to(dtype)
    table = torch.stack([torch.randperm(mb, generator=gen, device=dev)
                         for _ in range(s)]).to(torch.int32)
    table[0, 2] = -1         # split 2: a hole
    table[0, 4:6] = -1       # splits 4 and 5: holes
    table[6] = -1            # no entry at all
    pos = torch.tensor([mb * bl - 1, 15, 16, 40, 1000, -1, 20], dtype=torch.int32,
                       device=dev)
    got = pa.paged_decode_attend(q, k_pool, v_pool, table, pos)
    want = pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos)
    assert bool(torch.isfinite(got).all())
    assert bool((got[5:] == 0).all())
    assert _decode_close(got, want, dtype)
    assert torch.equal(got, pa.paged_decode_attend(q, k_pool, v_pool, table, pos))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_empty_table(dev, dtype):
    """MB = 0: one split that finds no entry; zeros, as the plain version."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((3, 2, 2, 64), generator=gen, device=dev).to(dtype)
    pool = torch.randn((2, 16, 2, 64), generator=gen, device=dev).to(dtype)
    table = torch.zeros((3, 0), dtype=torch.int32, device=dev)
    pos = torch.tensor([-1, 0, 30], dtype=torch.int32, device=dev)
    got = pa.paged_decode_attend(q, pool, pool, table, pos)
    assert bool((got == 0).all())
    assert torch.equal(got, pa.paged_decode_attend_plain(q, pool, pool, table, pos))


def test_paged_decode_unaligned_pool(dev):
    """A pool view that starts off a 16-byte boundary (the kernel reads
    16-byte rows; the wrapper copies such a view)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    s, kv, g, hd, bl, nblk = 2, 2, 2, 64, 8, 6
    shape = (nblk + 1, bl, kv, hd)
    n = (nblk + 1) * bl * kv * hd
    k_pool = torch.randn(n + 1, generator=gen, device=dev).to(torch.bfloat16)[1:].view(shape)
    v_pool = torch.randn(n + 1, generator=gen, device=dev).to(torch.bfloat16)[1:].view(shape)
    assert k_pool.is_contiguous() and k_pool.data_ptr() % 16
    q = torch.randn((s, kv, g, hd), generator=gen, device=dev).to(torch.bfloat16)
    table = torch.tensor([[0, 1, 2, -1, -1, -1], [3, 4, -1, -1, -1, -1]], dtype=torch.int32,
                         device=dev)
    pos = torch.tensor([20, 9], dtype=torch.int32, device=dev)
    got = pa.paged_decode_attend(q, k_pool, v_pool, table, pos)
    want = pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos)
    assert _decode_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [120, 72])
def test_paged_decode_head_dims_off_32(dev, dtype, hd):
    """head_dim 120 (h2o-danube-3-4b: KV 8, G 4) and 72: whole 16-byte
    vectors that do not fill a power-of-two team, so the tail lanes idle.
    Serve-like widths: 16-token blocks, a hole, a slot with no entry, NaN
    in the sink; a second launch bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(hd)
    s, kv, g, bl, nblk = 4, 8, 4, 16, 20
    k_pool = torch.randn((nblk + 1, bl, kv, hd), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((nblk + 1, bl, kv, hd), generator=gen, device=dev).to(dtype)
    k_pool[nblk] = float("nan")
    v_pool[nblk] = float("nan")
    q = torch.randn((s, kv, g, hd), generator=gen, device=dev).to(dtype)
    table = torch.full((s, nblk), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(nblk, generator=gen, device=dev).to(torch.int32)
    table[0, :8], table[1, :3], table[2, :1] = perm[:8], perm[8:11], perm[11:12]
    table[0, 3] = -1
    pos = torch.tensor([8 * bl - 1, 2 * bl + 5, 0, 7], dtype=torch.int32, device=dev)
    got = pa.paged_decode_attend(q, k_pool, v_pool, table, pos)
    want = pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos)
    assert bool(torch.isfinite(got).all())
    assert bool((got[3] == 0).all())
    assert _decode_close(got, want, dtype)
    assert torch.equal(got, pa.paged_decode_attend(q, k_pool, v_pool, table, pos))


#: (KV, G, hd) of the paged serves of granite-3-2b, yi-9b (G = MAX_G),
#: moonshot-v1-16b-a3b (G 1) and paligemma-3b (MQA: G = MAX_G at hd 256)
_SERVE_ATTN = {"granite-3-2b": (8, 4, 64), "yi-9b": (4, 8, 128),
               "moonshot-v1-16b-a3b": (16, 1, 128), "paligemma-3b": (1, 8, 256)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", sorted(_SERVE_ATTN))
def test_paged_decode_at_the_new_serve_shapes(dev, dtype, arch):
    """B2 at each new paged config's serve shape: 4 slots over a 72-block
    table of 16-token blocks (the serve trace's pool), a hole, a slot with
    no entry, NaN in the sink; a second launch bit-identical."""
    kv, g, hd = _SERVE_ATTN[arch]
    gen = torch.Generator(device=dev).manual_seed(kv * g + hd)
    s, bl, nblk = 4, 16, 72
    k_pool = torch.randn((nblk + 1, bl, kv, hd), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((nblk + 1, bl, kv, hd), generator=gen, device=dev).to(dtype)
    k_pool[nblk] = float("nan")
    v_pool[nblk] = float("nan")
    q = torch.randn((s, kv, g, hd), generator=gen, device=dev).to(dtype)
    table = torch.full((s, nblk), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(nblk, generator=gen, device=dev).to(torch.int32)
    table[0, :16], table[1, :7], table[2, :2] = perm[:16], perm[16:23], perm[23:25]
    table[0, 5] = -1
    pos = torch.tensor([255, 100, 16, 40], dtype=torch.int32, device=dev)
    got = pa.paged_decode_attend(q, k_pool, v_pool, table, pos)
    want = pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos)
    assert bool(torch.isfinite(got).all()) and bool((got[3] == 0).all())
    assert _decode_close(got, want, dtype)
    assert torch.equal(got, pa.paged_decode_attend(q, k_pool, v_pool, table, pos))


@pytest.mark.parametrize("arch", ["granite-3-2b", "yi-9b", "h2o-danube-3-4b",
                                  "moonshot-v1-16b-a3b", "paligemma-3b", "whisper-tiny",
                                  "zamba2-1.2b", "xlstm-125m"])
def test_gemm_kernels_at_the_new_heads(dev, arch):
    """B1 and B3 at each new config's coded head on the serve fleet: the
    block mix (nb, kb) x (kb, 4 x 256) and the encode (nb, kb) x (kb, 256 D),
    kb = ceil(padded vocab / 256) from 125 to 1005."""
    from repro_torch.configs import get_arch
    from repro_torch.core.coding import make_generator
    from repro_torch.core.planner import deploy
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.core.schemes import make_scheme
    from repro_torch.models.model import padded_vocab

    cfg = get_arch(arch)
    kb = -(-padded_vocab(cfg.vocab_size) // 256)
    nb = deploy(make_scheme("optimal"), ClusterSpec.make([6, 6], [8.0, 0.7]), kb).n
    g = make_generator(nb, kb, device=dev)
    gen = torch.Generator(device=dev).manual_seed(kb)
    x = torch.randn((kb, 4 * 256), generator=gen, device=dev)
    assert (cmv.blocked_matvec(g, x) - cmv.blocked_matvec_plain(g, x)).abs().max().item() \
        <= _gemm_tol(g, x)
    a = torch.randn((kb, 256 * cfg.d_model), generator=gen, device=dev) * 0.02
    assert (mds.mds_encode(g, a) - mds.mds_encode_plain(g, a)).abs().max().item() \
        <= _gemm_tol(g, a)


def test_paged_decode_refusals(dev):
    q = torch.randn((1, 1, 9, 32), device=dev)  # G = 9 > MAX_G
    pool = torch.randn((2, 4, 1, 32), device=dev)
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        pa.paged_decode_attend(q, pool, pool, table, pos)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode_attend(q[:, :, :2], pool, pool, table.long(), pos)
    # head_dim not a whole number of 16-byte vectors: 12 bf16 (24 bytes)
    qb = torch.randn((1, 1, 2, 12), device=dev).to(torch.bfloat16)
    pb = torch.randn((2, 4, 1, 12), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_decode_attend(qb, pb, pb, table, pos)


def _ce_case(dev, dtype, t, v, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((t, d), generator=gen, device=dev).to(dtype)
    e = (torch.randn((v, d), generator=gen, device=dev) * 0.05).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device=dev)
    labels[::3] = -1  # masked tokens
    return h, e, labels


def _ce_tolerances(h, e):
    """Derived bounds: a logit's f32 dot product is within 2 D u max|h||e|
    (Cauchy-Schwarz on the rows); lse adds the online sum over V/64 tiles."""
    u = 2.0**-24
    mag = float(h.float().norm(dim=1).max() * e.float().norm(dim=1).max())
    tol_logit = 2 * h.shape[1] * u * mag
    return tol_logit, tol_logit + (e.shape[0] / 64 + 64) * u


_CE_CASES = [
    (dtype, t, v, d, None)
    for dtype in (torch.float32, torch.bfloat16)
    for t, v, d in ((100, 300, 64), (37, 1000, 32), (256, 5000, 1024))
] + [
    (torch.float32, 16, 64, 4, None),  # bf16 refuses D % 8 != 0 (test_fused_ce_refusals)
    # bf16 over several vocab chunks with a ragged last one; T off the
    # 128-row tile, V off the 256-row tile, D at the model widths
    (torch.bfloat16, 200, 1000, 1024, 256),
    (torch.bfloat16, 200, 1000, 128, 256),
    (torch.bfloat16, 300, 5000, 128, 1024),
    # bf16 above the f32 kernels' 1024: granite-3-2b, h2o-danube-3-4b and
    # yi-9b widths (the tensor-core K loop and the f32 (T, D) dH sum across
    # several vocab chunks; a ragged last vocab tile)
    (torch.bfloat16, 300, 1000, 2048, 256),
    (torch.bfloat16, 256, 3000, 3840, None),
    (torch.bfloat16, 257, 2000, 4096, 512),
] + [
    # the training configs' full (V, D), T off the 128-row tile: whisper-tiny,
    # xlstm-125m, zamba2-1.2b, granite-3-2b, moonshot-v1-16b-a3b and
    # paligemma-3b (49,155, 51,865 and 257,216 end in a ragged vocab tile)
    (torch.bfloat16, 300, v, d, None)
    for v, d in ((51_865, 384), (50_304, 768), (32_000, 2048), (49_155, 2048),
                 (163_840, 2048), (257_216, 2048))
]


@pytest.mark.parametrize("dtype,t,v,d,chunk", _CE_CASES)
def test_fused_ce_matches_plain(dev, dtype, t, v, d, chunk):
    """Forward (lse, ll, argmax) and backward (dH, dE) against the plain
    version: vocab tails (V not a multiple of 64), T not a multiple of 16,
    masked labels, f32 and bf16 operands, bf16 over several vocab chunks."""
    h, e, labels = _ce_case(dev, dtype, t, v, d, t + v + d)
    tol_logit, tol_lse = _ce_tolerances(h, e)
    hk = h.clone().requires_grad_()
    ek = e.clone().requires_grad_()
    before = kernels.launch_counts()
    lse, ll, am = ce.fused_ce(hk, ek, labels, chunk=chunk)
    hp = h.clone().requires_grad_()
    ep = e.clone().requires_grad_()
    lse_p, ll_p, am_p = ce.fused_ce_plain(hp, ep, labels)
    mask = (labels >= 0).float()
    g_lse = mask * (1 + 2e-4 * lse_p.detach()) / mask.sum()
    g_ll = -mask / mask.sum()
    dh, de = torch.autograd.grad((lse, ll), (hk, ek), (g_lse, g_ll))
    dh_p, de_p = torch.autograd.grad((lse_p, ll_p), (hp, ep), (g_lse, g_ll))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_de"):
        assert after[name] == before[name] + 1, name
    assert (lse - lse_p).abs().max().item() <= tol_lse + 2.0**-23 * lse_p.abs().max().item()
    assert (ll - ll_p).abs().max().item() <= tol_logit
    assert bool((ll[labels < 0] == 0).all())
    logits = h.float() @ e.float().T
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol_logit
    assert bool((am == am_p)[clear].all())
    # dlogits error relative to |dl|: 2 tol_lse from exp(logit - lse), plus
    # the f32 sum over V (dH) or T (dE), plus (bf16) the rounding of the
    # dlogits to bf16 before the product; then one rounding step of the output
    rel = 2 * tol_lse + (2.0**-8 if dtype == torch.bfloat16 else 0.0)
    dl = torch.softmax(logits, 1) * g_lse[:, None]
    dl[torch.arange(t, device=dev)[labels >= 0], labels[labels >= 0]] += g_ll[labels >= 0]
    half_ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-22
    for got, want, bound in ((dh, dh_p, dl.abs() @ e.float().abs()),
                             (de, de_p, dl.abs().T @ h.float().abs())):
        k = v if got.shape == h.shape else t
        lim = (rel + k * 2.0**-24) * bound + half_ulp * want.float().abs() + 1e-30
        assert bool(((got.float() - want.float()).abs() <= lim).all())


@pytest.mark.parametrize("t,v,d,chunk", [(200, 1000, 128, 256), (256, 5000, 1024, None)])
def test_fused_ce_backward_is_bit_deterministic(dev, t, v, d, chunk):
    """Two launches of each bf16 backward kernel give the same bits."""
    h, e, labels = _ce_case(dev, torch.bfloat16, t, v, d, 7)
    labels32 = labels.to(torch.int32)
    lse, _, _ = ce.fused_ce_forward(h, e, labels32)
    gen = torch.Generator(device=dev).manual_seed(3)
    g_lse = torch.rand(t, generator=gen, device=dev)
    g_ll = -torch.rand(t, generator=gen, device=dev)
    for kern in (ce.BWD_DH, ce.BWD_DE):
        first = ce.fused_ce_backward(kern, h, e, labels32, lse, g_lse, g_ll, chunk=chunk)
        second = ce.fused_ce_backward(kern, h, e, labels32, lse, g_lse, g_ll, chunk=chunk)
        assert bool(torch.isfinite(first).all())
        assert torch.equal(first, second), kern.name


@pytest.mark.parametrize("t,v,d", [(200, 1000, 128), (256, 5000, 1024)])
def test_fused_ce_forward_is_bit_deterministic(dev, t, v, d):
    """Two launches of the bf16 forward give the same bits."""
    h, e, labels = _ce_case(dev, torch.bfloat16, t, v, d, 5)
    labels32 = labels.to(torch.int32)
    first = ce.fused_ce_forward(h, e, labels32)
    second = ce.fused_ce_forward(h, e, labels32)
    assert bool(torch.isfinite(first[0]).all())
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,want", [("equal", 0), ("tie", 300), ("tail", 999)])
def test_fused_ce_bf16_argmax_across_vocab_tiles(dev, case, want):
    """bf16 forward over four 256-column tiles (V = 1000): every logit
    equal (argmax 0); the max tied between tiles 1 and 2 (rows 300 and
    700: the first wins); the max in the ragged last tile (row 999)."""
    t, v, d = 20, 1000, 32
    h = torch.rand((t, d), device=dev).add_(0.5).to(torch.bfloat16)
    if case == "equal":
        e = torch.ones((v, d), device=dev, dtype=torch.bfloat16)
    else:
        e = torch.zeros((v, d), device=dev, dtype=torch.bfloat16)
        e[[300, 700] if case == "tie" else [999]] = 1
    labels = torch.arange(t, device=dev) * 50
    labels[::4] = -1
    lse, ll, am = ce.fused_ce(h, e, labels)
    lse_p, ll_p, _ = ce.fused_ce_plain(h, e, labels)
    tol_logit, tol_lse = _ce_tolerances(h, e)
    assert bool((am == want).all())
    assert (lse - lse_p).abs().max().item() <= tol_lse + 2.0**-23 * lse_p.abs().max().item()
    assert (ll - ll_p).abs().max().item() <= tol_logit
    assert bool((ll[labels < 0] == 0).all())


def test_fused_ce_argmax_first_index_on_ties(dev):
    h = torch.randn((20, 32), device=dev)
    e = torch.ones((200, 32), device=dev)  # every logit of a token is equal
    labels = torch.arange(20, device=dev)
    _, ll, am = ce.fused_ce(h, e, labels)
    assert bool((am == 0).all())
    assert bool(torch.allclose(ll, h.sum(1), rtol=1e-5, atol=1e-5))


def test_fused_ce_f32_refuses_widths_past_its_limit(dev):
    """f32 (the parity dtype) keeps the SIMT kernels' limit, D <= 1024, and
    says so; bf16 runs just past it (D = 1032, a multiple of 8)."""
    h, e, labels = _ce_case(dev, torch.float32, 16, 64, 1028, 0)
    with pytest.raises(ValueError, match="at most 1024"):
        ce.fused_ce(h, e, labels)
    hb, eb, lb = _ce_case(dev, torch.bfloat16, 16, 64, 1032, 0)
    lse, ll, _ = ce.fused_ce(hb, eb, lb)
    lse_p, ll_p, _ = ce.fused_ce_plain(hb, eb, lb)
    tol_logit, tol_lse = _ce_tolerances(hb, eb)
    assert (lse - lse_p).abs().max().item() <= tol_lse + 2.0**-23 * lse_p.abs().max().item()
    assert (ll - ll_p).abs().max().item() <= tol_logit


def test_fused_ce_refusals(dev):
    h = torch.randn((8, 30), device=dev)  # D not a multiple of 4
    labels = torch.zeros(8, dtype=torch.long, device=dev)
    with pytest.raises(ValueError, match="width"):
        ce.fused_ce(h, torch.randn((10, 30), device=dev), labels)
    with pytest.raises(TypeError):
        ce.fused_ce(h[:, :28].contiguous().half(), torch.randn((10, 28), device=dev).half(),
                    labels)
    with pytest.raises(ValueError, match="contiguous"):
        ce.fused_ce(torch.randn((32, 8), device=dev).T, torch.randn((10, 32), device=dev),
                    labels)
    # bf16 goes through TMA: rows of a multiple of 8 elements (16 bytes)
    hb, eb, lb = _ce_case(dev, torch.bfloat16, 16, 64, 4, 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        ce.fused_ce(hb, eb, lb)
    with pytest.raises(ValueError, match="chunk"):
        ce.fused_ce(*_ce_case(dev, torch.bfloat16, 16, 64, 8, 0), chunk=100)


def test_moe_grouped_routing_matches_one_pool_calls(dev):
    """The coded step's MoE routing on the card: ``route(groups=4)`` of 4
    pools of 24 tokens places each pool's entries as one ``route`` call of
    that pool does (the same capacity, kept mask and rank), in that pool's
    rows of each expert's buffer; and ``moe_ffn(groups=4)`` equals the
    four one-pool calls, row for row."""
    from repro_torch.models import moe

    gen = torch.Generator(device=dev).manual_seed(9)
    e, k, d, f, t = 8, 2, 64, 96, 24
    p = {n: t_[0] for n, t_ in moe.init_moe(1, d, f, e, torch.float32, generator=gen,
                                            device=dev).items()}
    x = torch.randn((4, t, d), generator=gen, device=dev)
    kw = dict(num_experts=e, top_k=k)
    r = moe.route(p["w_router"], x.reshape(-1, d), groups=4, **kw)
    slot_of = torch.empty_like(r.slot)
    slot_of[r.order] = r.slot
    dropped = 0
    for g in range(4):
        one = moe.route(p["w_router"], x[g], **kw)
        assert one.cap == r.cap
        theirs = torch.empty_like(one.slot)
        theirs[one.order] = one.slot
        kept = theirs < e * one.cap
        dropped += int((~kept).sum())
        want = torch.where(kept, (theirs // one.cap * 4 + g) * one.cap + theirs % one.cap,
                           torch.full_like(theirs, e * r.rows))
        assert torch.equal(slot_of[t * k * g: t * k * (g + 1)], want)
    assert dropped > 0  # capacity_factor 1.25 drops entries in some pool
    got = moe.moe_ffn(p, x, groups=4, **kw)
    want = torch.cat([moe.moe_ffn(p, x[g: g + 1], **kw) for g in range(4)])
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_bucketed_coded_head_decode_matches_plain(dev):
    """A bucketed head at full width (qwen3-0.6b's vocab and d_model, coded
    at n_cap) on the card: the block mix through B1 and the decode through
    the active bucket's alive mask (padding rows dead), against the same
    round with B1's plain version."""
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.runtime.plan_bucket import BucketConfig
    from repro_torch.runtime.serve_loop import CodedLMHead

    gen = torch.Generator(device=dev).manual_seed(8)
    table = torch.randn((151_936, 1024), generator=gen, device=dev) * 0.02
    head = CodedLMHead(table, ClusterSpec.make([6, 6], [8.0, 0.7]), deadline_safety=1.2,
                       bucket_config=BucketConfig(quantum=4))
    exe = head.executor
    head.replan(ClusterSpec.make([6, 6], [8.0, 0.9]))
    assert head.nb == exe.buckets.n_cap > exe.n and not exe.last_replan_structural
    logits = torch.randn((4, 151_936), generator=gen, device=dev)
    mask = torch.ones(exe.num_workers, dtype=torch.bool, device=dev)
    mask[-2:] = False
    alive = exe.slot_mask(mask)
    assert not bool(alive[exe.n:].any())
    before = kernels.launch_counts()["coded_matvec"]
    prod = head.encode_logits(logits)
    got, ok = head.decode_logits(prod, mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["coded_matvec"] == before + 1 and bool(ok)
    b, r = logits.shape[0], head.block_rows
    lf = torch.nn.functional.pad(logits, (0, head.kb * r - logits.shape[1]))
    cols = lf.reshape(b, head.kb, r).permute(1, 0, 2).reshape(head.kb, b * r)
    plain = cmv.blocked_matvec_plain(head.generator, cols).reshape(head.nb, b, r)
    assert (prod - plain).abs().max().item() <= _gemm_tol(head.generator, cols)
    want, want_ok = head.decode_logits(plain, mask)
    assert bool(want_ok)
    scale = float(logits.abs().max())
    order = torch.argsort((~alive).to(torch.int8), stable=True)[: head.kb]
    cond = float(torch.linalg.cond(head.generator[order].double()))
    assert (got[:, :151_936] - logits).abs().max().item() <= cond * 2.0**-22 * scale
    assert (got - want).abs().max().item() <= cond * 2.0**-22 * scale


def _meta_like(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("n", [1, 1024])
def test_meta_branches_match_the_launches(dev, n):
    """Each wrapper's ``meta`` branch returns the shapes and dtypes its CUDA
    launch returns (B1 both branches, B3, B2, B4 forward and backward), and
    every call reports the cost function's FLOPs to an active tally."""
    from repro_torch.launch.dryrun import Counter

    gen = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn((738, 594), generator=gen, device=dev)
    x = torch.randn((594, n), generator=gen, device=dev)
    q = torch.randn((4, 8, 2, 128), generator=gen, device=dev).to(torch.bfloat16)
    pool = torch.randn((73, 16, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
    table = torch.arange(4 * 18, dtype=torch.int32, device=dev).reshape(4, 18)
    pos = torch.tensor([255, 100, 16, 40], dtype=torch.int32, device=dev)
    h = (torch.randn((300, 1024), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    e = (torch.randn((5000, 1024), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    labels = torch.randint(0, 5000, (300,), generator=gen, device=dev)
    calls = {
        "coded_matvec": (cmv.blocked_matvec, (a, x)),
        "mds_encode": (mds.mds_encode, (a, x)),
        "paged_decode": (pa.paged_decode_attend, (q, pool, pool, table, pos)),
    }
    for name, (fn, args) in calls.items():
        with Counter() as cnt:
            got = fn(*args)
        want = fn(*(_meta_like(t) for t in args))
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        assert cnt.result().kernels[name][0] == 1, name
    assert cnt.result().kernels["paged_decode"][1] == pa.paged_decode_cost(
        4, 8, 2, 128, 18, 16, 2)[0]
    outs = {}
    for where in ("card", "meta"):
        hh, ee = (h, e) if where == "card" else (_meta_like(h), _meta_like(e))
        hh, ee = hh.clone().requires_grad_(), ee.clone().requires_grad_()
        lab = labels if where == "card" else _meta_like(labels)
        with Counter() as cnt:
            lse, ll, am = ce.fused_ce(hh, ee, lab)
            dh, de = torch.autograd.grad((lse + ll).sum(), (hh, ee))
        outs[where] = [(t.shape, t.dtype) for t in (lse, ll, am, dh, de)]
        assert {k: v[:2] for k, v in cnt.result().kernels.items()} == {
            "fused_ce_fwd": [1, 2.0 * 300 * 5000 * 1024],
            "fused_ce_bwd_dh": [1, 4.0 * 300 * 5000 * 1024],
            "fused_ce_bwd_de": [1, 4.0 * 300 * 5000 * 1024]}
    assert outs["card"] == outs["meta"]


def test_local_mesh_on_nccl(dev):
    """``make_local_mesh()``: a one-rank NCCL group and a (1, 1) mesh; a
    parameter distributed by the rules comes back bit-identical; the
    group is destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_local_mesh, make_local_mesh
    from repro_torch.sharding import rules

    mesh = make_local_mesh()
    try:
        assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
        t = torch.randn((2, 64, 32), device=dev)
        placed = rules.distribute(mesh, {"wq": t}, {"wq": rules.placements(
            mesh, (None, "data", "model"))})["wq"]
        assert torch.equal(placed.to_local(), t) and torch.equal(placed.full_tensor(), t)
        s = torch.ones(4, device=dev)
        dist.all_reduce(s)
        assert torch.equal(s, torch.ones(4, device=dev))
    finally:
        destroy_local_mesh()
    assert not dist.is_initialized()
