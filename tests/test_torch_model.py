"""Port parity, dense model on a paged KV pool (reduced qwen3-0.6b).

The reference's ``Model.init_params`` tree is carried across with
``params_from_jax``; chunked prefill and paged decode logits are held to
the reference's own chunked-prefill tolerance, 2e-4
(``tests/test_paged_kv.py``). Layer functions are held at float32 to
1e-6, and the bf16 tied unembed to the reference's f32-accumulated
contraction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import layers as ref_layers
from repro.models.model import Model as RefModel
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import layers
from repro_torch.models.model import Model, padded_vocab

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    ref_cfg = REF_ARCHS["qwen3-0.6b"].reduced()
    ref = RefModel(ref_cfg)
    params = ref.init_params(KEY)
    tree = jax.tree.map(np.asarray, params)
    ours = Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu").params_from_jax(tree)
    return ref, params, tree, ours


def test_reduced_config_matches_reference():
    ref, ours = REF_ARCHS["qwen3-0.6b"], get_arch("qwen3-0.6b")
    for full in (False, True):
        r = ref if full else ref.reduced()
        o = ours if full else ours.reduced()
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "resolved_head_dim", "qk_norm", "rope_theta",
                  "param_dtype", "compute_dtype", "logits_dtype"):
            assert getattr(o, f) == getattr(r, f), f
    with pytest.raises(KeyError):
        get_arch("nope")


def test_params_from_jax_copies_every_leaf(pair):
    _, _, tree, ours = pair
    def leaf(name):  # parameters are trainable: detach before numpy
        return getattr(ours, name).detach().numpy()

    np.testing.assert_array_equal(leaf("embed"), tree["embed"]["table"])
    np.testing.assert_array_equal(leaf("final_norm"), tree["final_norm"]["scale"])
    blocks = tree["blocks"]
    for name in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
        np.testing.assert_array_equal(leaf(name), blocks["attn"][name])
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(leaf(name), blocks["mlp"][name])
    np.testing.assert_array_equal(leaf("ln1"), blocks["ln1"]["scale"])
    np.testing.assert_array_equal(leaf("ln2"), blocks["ln2"]["scale"])
    assert ours.embed.shape[0] == padded_vocab(ours.config.vocab_size)
    bad = dict(tree, final_norm={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        Model(ours.config, device="cpu").params_from_jax(bad)


def test_own_seeded_init_is_deterministic():
    cfg = get_arch("qwen3-0.6b").reduced()
    a, b = Model(cfg, device="cpu", seed=1), Model(cfg, device="cpu", seed=1)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.wq, Model(cfg, device="cpu", seed=2).wq)
    np.testing.assert_allclose(float(a.embed.std()), 0.02, rtol=0.05)


def test_cuda_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_arch("qwen3-0.6b").reduced())


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    posn = np.arange(5, dtype=np.int32)[None, :].repeat(2, 0) + 7
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(x), torch.from_numpy(posn), 1e6).numpy(),
        np.asarray(ref_layers.rope(jnp.asarray(x), jnp.asarray(posn), 1e6)),
        rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(h)).numpy(),
        np.asarray(ref_layers.rmsnorm({"scale": scale}, jnp.asarray(h))),
        rtol=1e-6, atol=1e-6)


def test_bf16_unembed_accumulates_in_f32():
    """bf16 hidden x bf16-rounded table, summed in f32: within f32 rounding
    of the reference's ``preferred_element_type=f32`` contraction, and
    far closer than a bf16-output matmul would be."""
    rng = np.random.default_rng(1)
    table = (rng.standard_normal((512, 128)) * 0.02).astype(np.float32)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.unembed(torch.from_numpy(table), xb)
    want = np.asarray(ref_layers.unembed({"table": jnp.asarray(table)},
                                         jnp.asarray(x, jnp.bfloat16)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    lossy = (xb @ torch.from_numpy(table).to(torch.bfloat16).T).float().numpy()
    assert np.abs(lossy - want).max() > 10 * np.abs(got.numpy() - want).max()


def _tables(slots, nb, mb):
    """A scattered (non-contiguous, interleaved) block layout."""
    table = np.full((slots, nb), -1, np.int32)
    perm = np.random.default_rng(7).permutation(nb)
    for s in range(slots):
        table[s, :mb] = perm[s * mb:(s + 1) * mb]
    return table


def test_chunked_prefill_and_paged_decode_match_reference(pair):
    """Prompts of 7 and 5 tokens prefilled in 3-token chunks, then four
    paged decode steps (slot 1 frozen for one of them): logits at every
    step within 2e-4, and the K/V pools too."""
    ref, params, _, ours = pair
    c = ours.config
    slots, chunk, bl, steps = 2, 3, 4, 4
    plens = [7, 5]
    mb = -(-(max(plens) + steps + 1) // bl)
    nb = slots * mb + 2
    table = _tables(slots, nb, mb)
    tokens = np.random.default_rng(3).integers(0, c.vocab_size, (slots, max(plens)))
    rcache = ref.init_paged_cache(nb, bl)
    cache = ours.init_paged_cache(nb, bl)
    prefilled = [0, 0]
    final = {}
    while any(prefilled[s] < plens[s] for s in range(slots)):
        takes = [min(chunk, plens[s] - prefilled[s]) for s in range(slots)]
        chunk_tok = np.zeros((slots, chunk), np.int32)
        for s in range(slots):
            chunk_tok[s, :takes[s]] = tokens[s, prefilled[s]:prefilled[s] + takes[s]]
        start = np.asarray(prefilled, np.int32)
        lens = np.asarray(takes, np.int32)
        want, rcache = ref.prefill_paged(params, rcache, jnp.asarray(chunk_tok),
                                         jnp.asarray(start), jnp.asarray(lens),
                                         jnp.asarray(table))
        got, cache = ours.prefill_paged(cache, torch.from_numpy(chunk_tok),
                                        torch.from_numpy(start),
                                        torch.from_numpy(lens), torch.from_numpy(table))
        for s in range(slots):
            if takes[s]:
                np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]), **TOL)
            prefilled[s] += takes[s]
            if takes[s] and prefilled[s] >= plens[s]:
                final[s] = got[s]
    pos = np.asarray(plens, np.int32)
    tok = np.asarray([int(torch.argmax(final[s])) for s in range(slots)], np.int32)
    for step in range(steps):
        active = np.array([True, step != 2])
        want, rcache = ref.decode_step_paged(
            params, rcache, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(table),
            jnp.asarray(active))
        got, cache = ours.decode_step_paged(
            cache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(table), torch.from_numpy(active))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert got.shape == (slots, padded_vocab(c.vocab_size))
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
        pos = np.where(active, pos + 1, pos).astype(np.int32)
    for name in ("k", "v"):  # the sink (last block) holds unspecified writes
        np.testing.assert_allclose(cache[name][:, :-1].numpy(),
                                   np.asarray(rcache["kv"][name])[:, :-1], **TOL)
