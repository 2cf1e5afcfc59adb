"""Port parity, the model envelope beyond qwen3-0.6b (reduced configs):
granite-3-2b (dense GQA), h2o-danube-3-4b (sliding window, plain and
``kv_quant``) and moonshot-v1-16b-a3b (MoE), float32, the reference's
``Model.init_params`` tree carried across with ``params_from_jax``.

* ``moe_ffn`` against the reference's: outputs to 1e-5 relative and
  1e-5 max|out| absolute (the reference's expert init, normal over
  sqrt(E), makes outputs of order 100, where one float32 rounding of an
  element is already 1.5e-5; the two packages sum the experts' products
  in different orders); the chosen
  experts, the stable expert order, the kept mask and the buffer slots
  exactly (against a transcription of the reference's routing steps), at
  a capacity that drops entries and at one that drops none; the least
  top-k margin of the inputs is printed. The MoE model's loss and every
  gradient leaf against ``jax.grad`` (2e-4 relative).
* Each model path the reference has: ``lm_logits``, ``decode_step``
  (the rolling window past its wrap; the int8 cache), ``prefill`` with
  ``decode_step_slots``, ``prefill_paged`` and ``decode_step_paged``:
  logits to 2e-4, caches to 1e-5; int8 caches and scales exactly in the
  first layer and within one rounding step after it.
* ``Server.serve`` paged and dense (granite, moonshot) and
  ``Server.generate`` (danube, plain and int8: the sequential prefill)
  against the reference's, the reference's generator injected and a
  deadline no worker misses: streams and tokens exact.
* The port's paged and dense moonshot serves emit the same streams when
  the config is drop-free (``capacity_factor = num_experts``): capacity
  dropping depends on the routed pool (S x C rows in a paged prefill
  round, S x P in a dense admit), as in the reference's own
  ``tests/test_models_smoke.py``.
* The refusals: the slot and paged paths refuse ``kv_quant`` and sliding
  windows with the reference's messages (``init_cache`` takes them, for
  ``generate``), ``serve`` of danube too, and ``Trainer`` refuses the
  families whose training the port does not implement yet.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.models import moe as ref_moe
from repro.models.model import Model as RefModel
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
import repro.serve.scheduler as ref_sched_mod
import repro.serve.workload as ref_wl
from repro_torch.configs import ARCHS
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.models import moe
from repro_torch.models.model import JAX_NAMES, Model
from repro_torch.runtime.serve_loop import ServeConfig, Server
import repro_torch.serve.workload as wl

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
FLEET = ([2, 2], [4.0, 0.8])
MOE = "moonshot-v1-16b-a3b"
_PAIRS = {}


def _pair(name, **changes):
    """(reference model, params, port model) of a reduced config, memoised.
    ``changes`` leave the parameter shapes alone: one init per arch and
    parameter dtype (``param_dtype``)."""
    key = (name, tuple(sorted(changes.items())))
    if key not in _PAIRS:
        ref = RefModel(dataclasses.replace(REF_ARCHS[name].reduced(), **changes))
        dtype = {k: v for k, v in changes.items() if k == "param_dtype"}
        params = (_pair(name, **dtype)[1] if changes != dtype
                  else jax.block_until_ready(jax.jit(ref.init_params)(KEY)))
        ours = Model(dataclasses.replace(ARCHS[name].reduced(), **changes), device="cpu")
        ours.params_from_jax(jax.tree.map(np.asarray, params))
        _PAIRS[key] = ref, params, ours
    return _PAIRS[key]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree, np.float32)


# ------------------------------------------------------------------ moe
def _ref_routing(p, xf, e, k, cf):
    """The reference ``moe_ffn``'s routing steps (``repro/models/moe.py``)."""
    t = xf.shape[0]
    logits = xf.astype(jnp.float32) @ p["w_router"]
    _, idx = jax.lax.top_k(logits, k)
    cap = int(np.ceil(t * k / e * cf))
    e_flat = idx.reshape(-1)
    order = jnp.argsort(e_flat)
    e_sorted = e_flat[order]
    start_of = jnp.searchsorted(e_sorted, jnp.arange(e), side="left")
    rank = jnp.arange(t * k, dtype=jnp.int32) - start_of[e_sorted]
    keep = rank < cap
    slot = jnp.where(keep, e_sorted * cap + rank, e * cap)
    return {n: np.asarray(a) for n, a in
            dict(idx=idx, order=order, keep=keep, slot=slot, logits=logits).items()}, cap


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])  # drops, the config's, drop-free
def test_moe_ffn_matches_reference(cf):
    ref, params, ours = _pair(MOE)
    c = ours.config
    p_ref = jax.tree.map(lambda t: t[1], params["blocks"]["moe"])
    p = {n: torch.from_numpy(np.array(t)) for n, t in p_ref.items()}
    x = np.random.default_rng(int(cf * 4)).standard_normal((3, 10, c.d_model))
    x = x.astype(np.float32)
    kw = dict(num_experts=c.num_experts, top_k=c.top_k, capacity_factor=cf)
    want = np.asarray(jax.jit(lambda p_, x_: ref_moe.moe_ffn(p_, x_, **kw))(
        p_ref, jnp.asarray(x)))
    got = moe.moe_ffn(p, torch.from_numpy(x), **kw)
    _close(got, want, dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max())))

    xf = x.reshape(-1, c.d_model)
    r = moe.route(p["w_router"], torch.from_numpy(xf), **kw)
    oracle, cap = _ref_routing(p_ref, jnp.asarray(xf), c.num_experts, c.top_k, cf)
    top = np.sort(oracle["logits"], -1)[:, ::-1]
    print(f"cf {cf}: least top-{c.top_k} margin "
          f"{float(np.diff(-top[:, : c.top_k + 1], axis=-1).min()):.3e}, cap {cap}, "
          f"dropped {int((~oracle['keep']).sum())}/{oracle['keep'].size}")
    assert r.cap == cap
    np.testing.assert_array_equal(r.experts.numpy(), oracle["idx"])
    np.testing.assert_array_equal(r.order.numpy(), oracle["order"])
    np.testing.assert_array_equal(r.keep.numpy(), oracle["keep"])
    np.testing.assert_array_equal(r.slot.numpy(), oracle["slot"])
    assert bool(r.keep.all()) == (cf == 8.0)
    np.testing.assert_allclose(
        float(moe.aux_load_balance_loss(p, torch.from_numpy(x), num_experts=c.num_experts,
                                        top_k=c.top_k)),
        float(ref_moe.aux_load_balance_loss(p_ref, jnp.asarray(x),
                                            num_experts=c.num_experts, top_k=c.top_k)),
        rtol=1e-6)


def test_moe_loss_and_gradients_match_reference():
    """``loss_fn`` of the MoE model (routing, dispatch, the experts, the
    combine) and every gradient leaf, the router's included."""
    ref, params, ours = _pair(MOE)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, :3] = -1
    (want, _), wg = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, _ = ours.loss_fn({"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)})
    named = dict(ours.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert "w_router" in named and "w_gate" not in named
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), _leaf(wg, JAX_NAMES[name]),
                                   rtol=2e-4, atol=2e-6, err_msg=name)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count() < ours.param_count()


# ---------------------------------------------------------- model paths
@pytest.mark.parametrize("name,changes,steps", [
    ("granite-3-2b", {}, 12), ("h2o-danube-3-4b", {}, 70),
    ("h2o-danube-3-4b", {"kv_quant": True}, 70), (MOE, {}, 12),
    ("granite-3-2b", {"causal_block_skip": True}, 0),  # the skip is not on decode's path
])
def test_lm_logits_and_decode_step_match_reference(name, changes, steps):
    """80 tokens of full-sequence logits (danube: past its 64 window), then
    ``steps`` decode steps into an 80-long cache (danube: 70, so the
    64-entry rolling cache wraps)."""
    ref, params, ours = _pair(name, **changes)
    toks = np.random.default_rng(1).integers(0, 512, (2, 80)).astype(np.int32)
    with torch.no_grad():
        _close(ours.lm_logits(torch.from_numpy(toks)),
               jax.jit(ref.lm_logits)(params, jnp.asarray(toks)), LOGITS_TOL)
    if not steps:
        return
    cache, ref_cache = ours.init_cache(2, 80), ref.init_cache(2, 80)
    step = jax.jit(ref.decode_step)
    for t in range(steps):
        want, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, t]), jnp.int32(t))
        got, cache = ours.decode_step(cache, torch.from_numpy(toks[:, t]), t)
        _close(got, want, LOGITS_TOL)
    kv = ref_cache["kv"]
    assert set(cache) == set(kv)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(kv["pos"]))
    if ours.config.kv_quant:
        # layer 0 quantizes the same inputs: bit-equal. Deeper layers
        # quantize inputs that differ by float32 rounding, so a value whose
        # quotient sits that close to a half-integer may round one step
        # the other way (one float16 step for a scale)
        for n in ("k", "v", "k_scale", "v_scale"):
            got_n, want_n = cache[n].numpy(), np.asarray(kv[n])
            np.testing.assert_array_equal(got_n[0], want_n[0], err_msg=n)
            diff = np.abs(got_n.astype(np.float64) - want_n.astype(np.float64))
            step = 1.0 if n in ("k", "v") else 2.0**-10 * np.abs(want_n.astype(np.float64))
            assert (diff <= step).all() and (diff > 0).mean() < 1e-2, n
    else:
        _close(cache["k"], kv["k"], CACHE_TOL)
        _close(cache["v"], kv["v"], CACHE_TOL)
    if ours.config.sliding_window is not None:
        assert cache["pos"].shape[1] == 64 and int(cache["pos"].max()) == 69


@pytest.mark.parametrize("name", ["granite-3-2b", MOE])
def test_prefill_and_decode_step_slots_match_reference(name, **changes):
    ref, params, ours = _pair(name, **changes)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (3, 40)).astype(np.int32)
    lens = np.array([40, 23, 1], np.int32)
    lg, ks, vs = jax.jit(ref.prefill)(params, jnp.asarray(toks), jnp.asarray(lens))
    got_lg, got_k, got_v = ours.prefill(torch.from_numpy(toks), torch.from_numpy(lens))
    _close(got_lg, lg, LOGITS_TOL)
    _close(got_k, ks, CACHE_TOL)
    _close(got_v, vs, CACHE_TOL)
    cache, ours_cache = ref.init_slot_cache(3, 12), ours.init_slot_cache(3, 12)
    pos = np.array([0, 4, 9], np.int32)
    step = jax.jit(ref.decode_step_slots)
    for _ in range(5):
        tok = rng.integers(0, 512, (3,)).astype(np.int32)
        lg, cache = step(params, cache, jnp.asarray(tok), jnp.asarray(pos))
        got, ours_cache = ours.decode_step_slots(ours_cache, torch.from_numpy(tok),
                                                 torch.from_numpy(pos))
        _close(got, lg, LOGITS_TOL)
        pos = pos + np.array([1, 1, 0], np.int32)
    _close(ours_cache["k"], cache["kv"]["k"], CACHE_TOL)
    _close(ours_cache["v"], cache["kv"]["v"], CACHE_TOL)
    np.testing.assert_array_equal(ours_cache["pos"].numpy(), np.asarray(cache["kv"]["pos"]))


@pytest.mark.parametrize("name", ["granite-3-2b", MOE])
def test_chunked_prefill_and_paged_decode_match_reference(name, **changes):
    """Prompts of 7 and 5 tokens in 3-token chunks (the padded rows of the
    chunk fed to both packages alike: an MoE layer routes them), then four
    paged decode steps, slot 1 frozen for one."""
    ref, params, ours = _pair(name, **changes)
    slots, chunk, bl, steps, plens = 2, 3, 4, 4, [7, 5]
    mb = -(-(max(plens) + steps + 1) // bl)
    nb = slots * mb + 2
    table = np.full((slots, nb), -1, np.int32)
    perm = np.random.default_rng(7).permutation(nb)
    for s in range(slots):
        table[s, :mb] = perm[s * mb:(s + 1) * mb]
    tokens = np.random.default_rng(3).integers(0, 512, (slots, max(plens)))
    rcache, cache = ref.init_paged_cache(nb, bl), ours.init_paged_cache(nb, bl)
    ref_prefill, ref_decode = jax.jit(ref.prefill_paged), jax.jit(ref.decode_step_paged)
    done, final = [0, 0], {}
    while any(done[s] < plens[s] for s in range(slots)):
        takes = [min(chunk, plens[s] - done[s]) for s in range(slots)]
        chunk_tok = np.zeros((slots, chunk), np.int32)
        for s in range(slots):
            chunk_tok[s, :takes[s]] = tokens[s, done[s]:done[s] + takes[s]]
        start, lens = np.asarray(done, np.int32), np.asarray(takes, np.int32)
        want, rcache = ref_prefill(params, rcache, *map(jnp.asarray, (
            chunk_tok, start, lens, table)))
        got, cache = ours.prefill_paged(cache, *map(torch.from_numpy, (
            chunk_tok, start, lens, table)))
        for s in range(slots):
            if takes[s]:
                _close(got[s], want[s], LOGITS_TOL)
                done[s] += takes[s]
                if done[s] >= plens[s]:
                    final[s] = np.asarray(want[s])
    pos = np.asarray(plens, np.int32)
    tok = np.asarray([int(np.argmax(final[s])) for s in range(slots)], np.int32)
    for step in range(steps):
        active = np.array([True, step != 2])
        want, rcache = ref_decode(params, rcache, *map(jnp.asarray, (
            tok, pos, table, active)))
        got, cache = ours.decode_step_paged(cache, *map(torch.from_numpy, (
            tok, pos, table, active)))
        _close(got, want, LOGITS_TOL)
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
        pos = np.where(active, pos + 1, pos).astype(np.int32)
    for n in ("k", "v"):  # the sink (last block) holds unspecified writes
        _close(cache[n][:, :-1], np.asarray(rcache["kv"][n])[:, :-1], CACHE_TOL)


# --------------------------------------------------------------- server
def _servers(name, **changes):
    """(reference server, port server): coded heads on one fleet with the
    reference's generator injected and a deadline no worker misses."""
    ref, params, ours = _pair(name, **changes)
    refsrv = RefServer(ref, params, RefCluster.make(*FLEET),
                       RefServeConfig(block_rows=64, deadline_safety=50.0))
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    server.coded_head.refresh(np.asarray(refsrv.coded_head.generator))
    return refsrv, server


def _ref_streams(refsrv, trace, monkeypatch, **kw):
    """Reference serve, recording every dispatch's tokens and the slot ->
    request map at each advance (the reference report drops tokens)."""
    toks, owners = [], []
    attr = "_serve_step_paged_fn" if kw["paged"] else "_serve_step_fn"
    step_fn = getattr(refsrv, attr)

    def recording_step(*args, steps):
        out = step_fn(*args, steps=steps)
        if steps:
            toks.append(np.asarray(out[3]))
        return out

    class RecordingScheduler(ref_sched_mod.SlotScheduler):
        def advance(self, emitted=1, now=None):
            owners.append({i: s.request.rid for i, s in enumerate(self.slots)
                           if s.busy and not s.prefilling and not s.done})
            super().advance(emitted, now)

    monkeypatch.setattr(ref_sched_mod, "SlotScheduler", RecordingScheduler)
    setattr(refsrv, attr, recording_step)
    rep = refsrv.serve(trace, key=KEY, **kw)
    streams = {}
    for arr, own in zip(toks, owners, strict=True):
        for si, rid in own.items():
            streams.setdefault(rid, []).extend(int(t) for t in arr[:, si])
    return rep, {r: tuple(v) for r, v in streams.items()}


@pytest.mark.parametrize("name,paged", [("granite-3-2b", True), ("granite-3-2b", False),
                                        (MOE, True), (MOE, False)])
def test_serve_matches_reference(name, paged, monkeypatch, **changes):
    trace_kw = dict(num_requests=4, prompt_len=(4, 20), out_len=(2, 5), vocab=512)
    serve_kw = dict(slots=2, decode_block=2, paged=paged)
    if paged:
        serve_kw["prefill_chunk"] = 8
    refsrv, server = _servers(name, **changes)
    ref_rep, ref_streams = _ref_streams(
        refsrv, ref_wl.make_workload("poisson", **trace_kw).trace(seed=0), monkeypatch,
        **serve_kw)
    rep = server.serve(wl.make_workload("poisson", **trace_kw).trace(seed=0), **serve_kw)
    assert rep.streams == ref_streams
    for f in ("tokens", "rounds", "decode_rounds", "prefill_rounds", "admitted", "shed"):
        assert getattr(rep, f) == getattr(ref_rep, f), f
    assert rep.decode_ok == rep.decode_rounds and rep.erased_rounds == 0


@pytest.mark.parametrize("changes", [{}, {"kv_quant": True}])
def test_generate_sequential_prefill_matches_reference(changes):
    """danube generates through ``decode_step`` over the prompt (its window
    and int8 cache have no batched prefill): 70-token prompts and 6 new
    tokens wrap the 64-entry rolling cache; every token through the coded
    head, the reference's tokens exactly."""
    refsrv, server = _servers("h2o-danube-3-4b", **changes)
    assert not server._can_batch_prefill() and not refsrv._can_batch_prefill()
    refsrv.coded_head.deadline = server.coded_head.deadline = 1e9
    prompts = np.asarray(jax.random.randint(KEY, (2, 70), 0, 512), np.int32)
    want = refsrv.generate(jnp.asarray(prompts), 6)
    rounds = []
    got = server.generate(prompts, 6, observe=lambda step, lg, sel, ok, mask:
                          rounds.append(bool(ok) and bool(mask.all())))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == [True] * 6


def test_moe_paged_and_dense_serves_give_equal_streams_when_drop_free():
    """Routing is per token once no entry is dropped, so the paged pool
    (S x C rows a prefill round) and the dense splice (S x P rows) agree;
    at the config's capacity they route different pools and may not."""
    _, _, ours = _pair(MOE, capacity_factor=8.0)
    trace = wl.make_workload("poisson", num_requests=5, prompt_len=(4, 20),
                             out_len=(2, 6), vocab=512).trace(seed=4)
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=1.2))
    kw = dict(slots=2, decode_block=3, seed=2)
    dense = server.serve(trace, paged=False, **kw)
    paged = server.serve(trace, paged=True, **kw)
    assert dense.streams == paged.streams
    assert dense.tokens == paged.tokens == sum(r.out_len for r in trace)
    assert dense.erased_rounds > 0


# ------------------------------------------------------------- refusals
def _slot_and_paged_calls(model):
    """Each slot or paged entry point, called with small valid arguments."""
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    table = i32(0, 1)[None, :].repeat(2, 1)
    return {
        "init_slot_cache": lambda: model.init_slot_cache(2, 8),
        "prefill": lambda: model.prefill(i32(1, 2, 3)[None].repeat(2, 1), i32(3, 3)),
        "decode_step_slots": lambda: model.decode_step_slots(
            {"k": None, "v": None, "pos": torch.full((2, 8), -1)}, i32(1, 2), i32(0, 0)),
        "init_paged_cache": lambda: model.init_paged_cache(4, 4),
        "decode_step_paged": lambda: model.decode_step_paged(
            {"k": None, "v": None}, i32(1, 2), i32(0, 0), table,
            torch.ones(2, dtype=torch.bool)),
        "prefill_paged": lambda: model.prefill_paged(
            {"k": None, "v": None}, i32(1, 2)[None].repeat(2, 1), i32(0, 0), i32(2, 2),
            table),
    }


@pytest.mark.parametrize("field,value", [("kv_quant", True), ("sliding_window", 64)])
def test_slot_and_paged_paths_refuse_what_the_reference_refuses(field, value):
    ref = RefModel(dataclasses.replace(REF_ARCHS["qwen3-0.6b"].reduced(), **{field: value}))
    with pytest.raises(NotImplementedError) as want:
        ref.init_paged_cache(4, 4)
    model = Model(dataclasses.replace(ARCHS["qwen3-0.6b"].reduced(), **{field: value}),
                  device="cpu")
    cache = model.init_cache(2, 80)  # generate's cache takes the config
    if field == "kv_quant":
        assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float16
    else:
        assert cache["k"].shape[2] == cache["pos"].shape[1] == 64  # min(80, window)
    for name, call in _slot_and_paged_calls(model).items():
        with pytest.raises(NotImplementedError) as got:
            call()
        assert str(got.value) == str(want.value), name
    # the unmodified config passes the check on every path
    plain = Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu")
    plain.init_paged_cache(4, 4)
    plain.init_slot_cache(2, 8)
    assert np.isfinite(plain.prefill(torch.ones((1, 3), dtype=torch.int32),
                                     torch.tensor([3]))[0].numpy()).all()


@pytest.mark.parametrize("paged", [True, False])
def test_serve_refuses_a_sliding_window_model(paged):
    ref, params, ours = _pair("h2o-danube-3-4b")
    trace = wl.make_workload("poisson", num_requests=2, prompt_len=8, vocab=512).trace(seed=0)
    with pytest.raises(NotImplementedError) as want:
        RefServer(ref, params, None).serve(
            ref_wl.make_workload("poisson", num_requests=2, prompt_len=8,
                                 vocab=512).trace(seed=0), paged=paged)
    with pytest.raises(NotImplementedError) as got:
        Server(ours).serve(trace, paged=paged)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["zamba2-1.2b", "xlstm-125m", "whisper-tiny",
                                  "paligemma-3b"])
def test_model_refuses_the_families_not_ported_yet(name):
    """``Model`` builds every family, and the training CLI trains each one
    now: uncoded for all four, coded for hybrid and ssm; coded vlm and
    audio exit non-zero at the first step with the reference's extras
    message (the only refusal left)."""
    from repro_torch.launch import train as train_cli

    cfg = ARCHS[name].reduced()
    assert Model(cfg, device="cpu").param_count() > 0
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--steps", "1",
            "--seq-len", "8", "--batch", "2"]
    model = train_cli.main(argv)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    coded = argv + ["--hetero-groups", "1:4.0,1:1.0"]
    if cfg.family in ("vlm", "audio"):
        with pytest.raises(SystemExit,
                           match="coded training does not partition family extras yet"):
            train_cli.main(coded)
    else:
        assert train_cli.main(coded).config.family == cfg.family
