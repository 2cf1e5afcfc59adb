"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip on a
machine without CUDA. Run them on the card with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the port does not need.)

Shapes are ragged on purpose (tile edges of the GEMMs; GQA group sizes,
head dims and block lengths of the decode attend).
"""
import pytest
import torch

import repro_torch.kernels as kernels
from repro_torch.kernels.coded_matvec import ops as cmv
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


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (7, 33, 5), (129, 130, 131),
                                   (738, 594, 1024), (65, 600, 1)])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,hd,bl", [(1, 32, 4), (2, 128, 16), (4, 64, 8), (8, 128, 16)])
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


def test_paged_decode_refusals(dev):
    q = torch.randn((1, 1, 9, 32), device=dev)  # G = 9 > MAX_G
    pool = torch.randn((2, 4, 1, 32), device=dev)
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        pa.paged_decode_attend(q, pool, pool, table, pos)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode_attend(q[:, :, :2], pool, pool, table.long(), pos)
