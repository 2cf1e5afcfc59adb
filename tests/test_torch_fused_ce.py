"""Port parity, B4 fused linear cross-entropy on the CPU (its plain version).

The port's ``fused_ce`` (per-token lse, label logit, argmax) against the
reference's Pallas ``fused_ce_kernel`` run with ``interpret=True``, and
its mean loss and (dH, dE) gradients against the reference's custom-VJP
``fused_linear_ce`` and the jnp oracle ``linear_ce_ref``, on the
reference test's shapes (vocab tails of 300 and 1000 rows included).
Tolerances are the reference test's: 1e-5 relative for values, 1e-4
relative / 1e-6 absolute for gradients. Plain renderings of the bf16
kernels' algorithms (the forward's per-tile partials and fixed-order
combine, the backward's vocab chunks) are held to the plain version
within the error model of the card's checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_ce.kernel import fused_ce_kernel
from repro.kernels.fused_ce.ops import fused_linear_ce
from repro.kernels.fused_ce.ref import linear_ce_ref
from repro_torch.kernels.fused_ce import ops as ce

torch.set_num_threads(1)

# (t, v, d) and Pallas tiles (bt, bv) that divide them
SHAPES = [(256, 512, 128, 256, 512), (100, 300, 64, 20, 60), (8, 1000, 32, 8, 200)]


def _inputs(t, v, d, seed, scale=0.5, mask_first=0):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((t, d)) * scale).astype(np.float32)
    e = (rng.standard_normal((v, d)) * scale).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    labels[:mask_first] = -1
    return h, e, labels


def _mean_ce(h, e, labels):
    lse, ll, _ = ce.fused_ce(h, e, labels)
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)


@pytest.mark.parametrize("t,v,d,bt,bv", SHAPES)
def test_per_token_values_match_pallas_kernel(t, v, d, bt, bv):
    h, e, labels = _inputs(t, v, d, t + v)
    lse, ll, am = ce.fused_ce(torch.from_numpy(h), torch.from_numpy(e),
                              torch.from_numpy(labels))
    want_lse, want_ll = fused_ce_kernel(jnp.asarray(h), jnp.asarray(e), jnp.asarray(labels),
                                        bt=bt, bv=bv, interpret=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5)
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), rtol=1e-5, atol=1e-6)
    logits = h.astype(np.float64) @ e.astype(np.float64).T
    np.testing.assert_array_equal(am.numpy(), logits.argmax(1))
    assert lse.dtype == ll.dtype == torch.float32 and am.dtype == torch.int64


@pytest.mark.parametrize("t,v,d,bt,bv", SHAPES)
def test_loss_matches_reference_and_oracle(t, v, d, bt, bv):
    h, e, labels = _inputs(t, v, d, t + v)
    got = float(_mean_ce(torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(labels)))
    args = (jnp.asarray(h), jnp.asarray(e), jnp.asarray(labels))
    np.testing.assert_allclose(got, float(fused_linear_ce(*args)), rtol=1e-5)
    np.testing.assert_allclose(got, float(linear_ce_ref(*args)), rtol=1e-5)


def test_masked_labels_match_reference():
    """Masked tokens contribute nothing: ll 0, no one-hot term, no weight."""
    h, e, labels = _inputs(64, 256, 32, 3, scale=1.0, mask_first=32)
    th, te, tl = map(torch.from_numpy, (h, e, labels))
    got = float(_mean_ce(th, te, tl))
    want = fused_linear_ce(jnp.asarray(h), jnp.asarray(e), jnp.asarray(labels))
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(
        got, float(linear_ce_ref(jnp.asarray(h[32:]), jnp.asarray(e),
                                 jnp.asarray(labels[32:]))), rtol=1e-5)
    _, ll, _ = ce.fused_ce(th, te, tl)
    assert bool((ll[:32] == 0).all())


@pytest.mark.parametrize("t,v,d,mask_first", [(64, 384, 48, 0), (100, 300, 64, 10),
                                              (8, 1000, 32, 3)])
def test_gradients_match_reference(t, v, d, mask_first):
    h, e, labels = _inputs(t, v, d, t * d, scale=0.3, mask_first=mask_first)
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    gh, ge = torch.autograd.grad(_mean_ce(th, te, torch.from_numpy(labels)), (th, te))
    rh, re_ = jax.grad(fused_linear_ce, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(e), jnp.asarray(labels))
    np.testing.assert_allclose(gh.numpy(), np.asarray(rh), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ge.numpy(), np.asarray(re_), rtol=1e-4, atol=1e-6)


def test_plain_backward_is_the_dlogits_formula():
    """dH = dl E and dE = dl^T H with dl = g_lse softmax + g_ll onehot: the
    rule the backward kernels implement, checked on the plain version."""
    h, e, labels = _inputs(12, 70, 16, 5, mask_first=2)
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    tl = torch.from_numpy(labels)
    rng = np.random.default_rng(9)
    g_lse = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    g_ll = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    lse, ll, _ = ce.fused_ce_plain(th, te, tl)
    gh, ge = torch.autograd.grad((lse, ll), (th, te), (g_lse, g_ll))
    logits = th.detach().double() @ te.detach().double().T
    dl = torch.softmax(logits, 1) * g_lse.double()[:, None]
    hit = tl >= 0
    dl[torch.arange(12)[hit], tl[hit].long()] += g_ll.double()[hit]
    np.testing.assert_allclose(gh.numpy(), (dl @ te.detach().double()).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ge.numpy(), (dl.T @ th.detach().double()).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_argmax_takes_first_index_on_ties():
    h = torch.randn(5, 8)
    e = torch.ones(40, 8)
    _, _, am = ce.fused_ce(h, e, torch.zeros(5, dtype=torch.long))
    assert bool((am == 0).all())


@pytest.mark.parametrize("bad,exc,match", [
    (lambda h, e, l: (h[:, :7].contiguous(), e[:, :7].contiguous(), l), ValueError, "width"),
    (lambda h, e, l: (h, e[:, :4].contiguous(), l), ValueError, "shapes"),
    (lambda h, e, l: (h, e, l[:3]), ValueError, "labels"),
    (lambda h, e, l: (h.double(), e.double(), l), TypeError, "bf16 or f32"),
    (lambda h, e, l: (h, e.bfloat16(), l), TypeError, "one dtype"),
    (lambda h, e, l: (h.T.contiguous().T, e, l), ValueError, "contiguous"),
])
def test_kernel_wrapper_refuses_what_the_kernels_do_not_take(bad, exc, match):
    """The checks the wrapper runs before a launch on the card."""
    h, e, l = torch.randn(6, 8), torch.randn(10, 8), torch.zeros(6, dtype=torch.int32)
    with pytest.raises(exc, match=match):
        ce._check(*bad(h, e, l))


def test_vocab_chunk_and_scratch_arithmetic():
    """The bf16 backward's chunk: a multiple of the 256-row tile, the
    (T, Vc) bf16 dlogits scratch within 64 MiB, never wider than V needs."""
    t, v, d = 8192, 151_936, 1024
    vc = ce.vocab_chunk(t, v)
    assert vc == 4096 and -(-v // vc) == 38
    assert ce.scratch_bytes(ce.BWD_DE, t, v, d) == 2 * t * vc == ce.SCRATCH_BYTES
    assert ce.scratch_bytes(ce.BWD_DH, t, v, d) == 2 * t * vc + 4 * t * d
    assert ce.vocab_chunk(100, 300) == 512  # one chunk: V rounded up to a tile
    assert "sum" not in ce.backward_scratch(ce.BWD_DH, 100, 300, 64)
    assert ce.vocab_chunk(10**6, v) == ce.TILE_V  # at least one tile
    assert ce.vocab_chunk(200, 1000, chunk=256) == 256
    assert ce.backward_scratch(ce.BWD_DH, 200, 1000, 128, chunk=256) == {
        "dlogits": ((200, 256), torch.bfloat16), "sum": ((200, 128), torch.float32)}
    assert ce.backward_scratch(ce.BWD_DE, 200, 1000, 128, chunk=256) == {
        "dlogits": ((200, 256), torch.bfloat16)}
    for bad in (0, -256, 100):
        with pytest.raises(ValueError, match="chunk"):
            ce.vocab_chunk(200, 1000, chunk=bad)


def test_forward_scratch_arithmetic():
    """The bf16 forward's partials: (max f32, sum f32, argmax int32) per
    (token, 256-row vocab tile), 12 bytes each."""
    t, v, d = 8192, 151_936, 1024
    assert ce.forward_scratch(t, v) == {
        "max": ((t, 594), torch.float32), "sum": ((t, 594), torch.float32),
        "argmax": ((t, 594), torch.int32)}
    assert ce.scratch_bytes(ce.FWD, t, v, d) == 12 * t * 594 == 58_392_576
    assert ce.forward_scratch(100, 300)["max"][0] == (100, 2)
    assert ce.scratch_bytes(ce.FWD, 3, 256, 8) == 3 * 12


def _fold(a, b):
    """Combine two (max, sum, argmax) partials as the combine kernel does:
    the same bits either way round; equal maxima keep the smaller index."""
    (m, s, i), (om, os_, oi) = a, b
    mx = torch.maximum(m, om)
    base = torch.where(mx == -torch.inf, torch.zeros_like(mx), mx)  # both empty
    s = s * torch.exp(m - base) + os_ * torch.exp(om - base)
    take = (om > m) | ((om == m) & (oi < i))
    return mx, s, torch.where(take, oi, i)


def _tiled_forward(h, e, labels):
    """Plain rendering of the bf16 forward kernels' algorithm. The GEMM's
    epilogue: per 256-column vocab tile of S = H E^T (f32), columns past V
    masked to -inf, the tile's max and its first index and its sum of
    exp2((S - max) log2 e); the label logit where its column falls. The
    combine: lane l of a token's warp folds tiles l, l + 32, ... in order,
    then the 32 lanes fold in an xor tree (16, 8, 4, 2, 1)."""
    t, v = h.shape[0], e.shape[0]
    nt = -(-v // ce.TILE_V)
    logits = h.float() @ e.float().T
    tiles = torch.nn.functional.pad(logits, (0, nt * ce.TILE_V - v),
                                    value=-torch.inf).view(t, nt, ce.TILE_V)
    m, first = tiles.max(dim=2)  # first index of the max
    s = torch.exp2((tiles - m[..., None]) * 1.4426950408889634).sum(2)
    arg = first + ce.TILE_V * torch.arange(nt)
    lanes = -(-nt // 32) * 32  # lanes without a tile hold an empty partial
    m = torch.nn.functional.pad(m, (0, lanes - nt), value=-torch.inf).view(t, -1, 32)
    s = torch.nn.functional.pad(s, (0, lanes - nt)).view(t, -1, 32)
    arg = torch.nn.functional.pad(arg, (0, lanes - nt), value=2**31 - 1).view(t, -1, 32)
    acc = (m[:, 0], s[:, 0], arg[:, 0])
    for j in range(1, m.shape[1]):
        acc = _fold(acc, (m[:, j], s[:, j], arg[:, j]))
    for off in (16, 8, 4, 2, 1):
        partner = torch.arange(32) ^ off
        acc = _fold(acc, tuple(x[:, partner] for x in acc))
    m, s, arg = (x[:, 0] for x in acc)
    hit = labels >= 0
    ll = torch.where(hit, logits.gather(1, labels.clamp_min(0)[:, None])[:, 0], 0.0)
    return m + torch.log(s), ll, arg


def _bf16_case(t, v, d, seed):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).bfloat16()
    e = torch.from_numpy((rng.standard_normal((v, d)) * 0.3).astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, v, t))
    labels[::3] = -1
    return h, e, labels


def _assert_forward_within_card_tolerance(h, e, labels):
    """The card check's bounds: ll within 2 D u max|h| max|e|, lse within
    that + (V/64 + 64) u + 2 u max|lse|, argmax equal where the top two
    logits are more than 2 tol apart."""
    lse, ll, am = _tiled_forward(h, e, labels)
    lse_p, ll_p, am_p = ce.fused_ce_plain(h, e, labels)
    d, v, u = h.shape[1], e.shape[0], 2.0**-24
    tol_logit = 2 * d * u * float(h.float().norm(dim=1).max() * e.float().norm(dim=1).max())
    tol_lse = tol_logit + (v / 64 + 64) * u + 2 * u * float(lse_p.abs().max())
    assert float((lse - lse_p).abs().max()) <= tol_lse
    assert float((ll - ll_p).abs().max()) <= tol_logit
    assert bool((ll[labels < 0] == 0).all())
    top2 = (h.float() @ e.float().T).topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol_logit
    assert bool((am == am_p)[clear].all())
    return am


@pytest.mark.parametrize("t,v,d", [(40, 300, 16), (24, 700, 32), (70, 1000, 8), (8, 256, 8)])
def test_tiled_forward_within_error_model(t, v, d):
    """Tile partials and the fixed-order combine against the plain version,
    vocab off the 256 tile (and one exact tile), masked labels."""
    _assert_forward_within_card_tolerance(*_bf16_case(t, v, d, t + v))


@pytest.mark.parametrize("case,want", [("equal", 0), ("tie", 300), ("tail", 999)])
def test_tiled_forward_argmax_across_tiles(case, want):
    """Every logit equal: argmax 0 across tiles; the max tied between tiles
    1 and 2 (rows 300 and 700): the first wins; the max in the ragged last
    tile (row 999 of V = 1000)."""
    t, v, d = 20, 1000, 32
    h = (torch.rand((t, d), generator=torch.Generator().manual_seed(1)) + 0.5).bfloat16()
    if case == "equal":
        e = torch.ones((v, d), dtype=torch.bfloat16)
    else:
        e = torch.zeros((v, d), dtype=torch.bfloat16)
        e[[300, 700] if case == "tie" else [999]] = 1
    labels = torch.arange(t) * 50
    labels[::4] = -1
    am = _assert_forward_within_card_tolerance(h, e, labels)
    assert bool((am == want).all())


def _chunked_backward(h, e, labels, lse, g_lse, g_ll, chunk):
    """Plain rendering of the bf16 backward kernels' algorithm: per vocab
    chunk, S = H E_c^T in f32, P = g_lse exp(S - lse) + g_ll [v == label]
    rounded to bf16, then dH += P E_c (f32 running sum) and dE[c] = P^T H;
    both outputs rounded to bf16 at the end."""
    t, v = h.shape[0], e.shape[0]
    vc = ce.vocab_chunk(t, v, chunk)
    hf, ef = h.float(), e.float()
    dh = torch.zeros_like(hf)
    de = torch.empty_like(ef)
    for v0 in range(0, v, vc):
        ec = ef[v0:v0 + vc]
        p = g_lse[:, None] * torch.exp(hf @ ec.T - lse[:, None])
        hit = (labels[:, None] == torch.arange(v0, v0 + ec.shape[0])[None, :])
        p = p + hit * g_ll[:, None]
        p = p.to(torch.bfloat16).float()
        dh += p @ ec
        de[v0:v0 + vc] = p.T @ hf
    return dh.to(torch.bfloat16), de.to(torch.bfloat16)


@pytest.mark.parametrize("t,v,d,chunk", [(64, 1000, 32, 256), (40, 700, 16, 512),
                                         (24, 300, 8, None)])
def test_chunked_bf16_backward_within_error_model(t, v, d, chunk):
    """The chunked algorithm with dlogits rounded to bf16, against the plain
    version's autograd, within the error model the card's check uses:
    (2 tol_lse + n u + 2^-8) (|dl| |X|) + 2^-7 |want| per element."""
    rng = np.random.default_rng(t + v)
    h = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).bfloat16()
    e = torch.from_numpy((rng.standard_normal((v, d)) * 0.3).astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, v, t))
    labels[::3] = -1
    hp, ep = h.clone().requires_grad_(), e.clone().requires_grad_()
    lse, ll, _ = ce.fused_ce_plain(hp, ep, labels)
    mask = (labels >= 0).float()
    g_lse = mask * (1 + 2e-4 * lse.detach()) / mask.sum()
    g_ll = -mask / mask.sum()
    dh_p, de_p = torch.autograd.grad((lse, ll), (hp, ep), (g_lse, g_ll))
    dh, de = _chunked_backward(h, e, labels, lse.detach(), g_lse, g_ll, chunk)
    u = 2.0**-24
    logits = h.float() @ e.float().T
    tol_logit = 2 * d * u * float(h.float().norm(dim=1).max() * e.float().norm(dim=1).max())
    tol_lse = tol_logit + (v / 64 + 64) * u
    dl = torch.softmax(logits, 1) * g_lse[:, None]
    hit = labels >= 0
    dl[torch.arange(t)[hit], labels[hit]] += g_ll[hit]
    for got, want, bound, n in ((dh, dh_p, dl.abs() @ e.float().abs(), v),
                                (de, de_p, dl.abs().T @ h.float().abs(), t)):
        lim = (2 * tol_lse + n * u + 2.0**-8) * bound + 2.0**-7 * want.float().abs()
        assert bool(((got.float() - want.float()).abs() <= lim + 1e-30).all())
