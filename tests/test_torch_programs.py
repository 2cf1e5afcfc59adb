"""Dispatch programs (``runtime/graphs.py``) on the CPU, where they run
uncaptured and their build counters still count.

Twins of the reference's program tests, on reduced qwen3-0.6b and the
reduced moonshot-v1-16b-a3b (seeded weights, numpy prompts, the same
finish-mask seed on both sides of each comparison):

* ``jit_pipeline=True`` and ``False`` (the program and the per-token
  host loop) give identical tokens, logits, ok flags and masks
  (``tests/test_decode_pipeline.py::test_jit_pipeline_matches_legacy_hostloop``);
* two ``generate`` calls of one shape build one program
  (``test_generate_is_single_compiled_program``);
* an 8x prompt spread and a second trace build no serve program
  (``tests/test_paged_kv.py::test_paged_serve_one_trace_across_8x_prompt_spread``);
  the port keys a paged program by (prefilling, steps), where the
  reference's one program per steps gates its prefill with ``lax.cond``;
* a replayed trace reproduces the schedule and builds nothing
  (``tests/test_serve_frontend.py::test_serve_slot_swaps_never_retrace_and_replay_is_deterministic``).

And: the port's serve programs against the reference's, dispatch by
dispatch (tokens and rounds exact, pending logits 2e-4; injected weights,
a deadline no worker misses); the fixed-shape dense splice against the
sliced splice it replaced (exact); a structural replan builds again and a
bucket switch builds nothing; a server keeps the programs of one serve
shape; numpy extras reach both ``generate`` modes; the private capture
switch refuses a late change; the true fleet's arrays and the deadline
rewritten in place; ``--legacy-decode``'s refusals against the
reference CLI's messages.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.launch import serve as ref_launch_serve
from repro.models.model import Model as RefModel
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
from repro_torch.configs import ARCHS
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model
from repro_torch.runtime.graphs import ProgramSet
from repro_torch.runtime.serve_loop import ServeConfig, Server
from repro_torch.serve.workload import Request, make_workload

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
FLEET = ([2, 2], [4.0, 0.8])
ARCH_NAMES = ("qwen3-0.6b", "moonshot-v1-16b-a3b")
CLI_BASE = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2", "--prompt-len", "5",
            "--max-new", "3"]


@pytest.fixture(scope="module", params=ARCH_NAMES)
def model(request):
    return Model(ARCHS[request.param].reduced(), device="cpu", seed=0)


@pytest.fixture(scope="module")
def ported():
    ref = RefModel(REF_ARCHS["qwen3-0.6b"].reduced())
    params = ref.init_params(KEY)
    ours = Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu")
    ours.params_from_jax(jax.tree.map(np.asarray, params))
    return ref, params, ours


def _coded(model, **cfg):
    return Server(model, ClusterSpec.make(*FLEET),
                  ServeConfig(block_rows=64, deadline_safety=1.2, **cfg))


def _req(rid, arrival, out_len, plen):
    return Request(rid=rid, arrival=arrival, prompt=tuple(range(1, plen + 1)),
                   out_len=out_len)


def _done(rep):
    return {f.request.rid: (f.finish_round, f.tokens) for f in rep.finished
            if f.outcome == "done"}


# ------------------------------------------------------- the program set
def test_program_set_builds_once_per_key_and_clears():
    progs = ProgramSet(torch.device("cpu"))
    assert not progs.capture  # the CPU never captures
    calls = []

    def fn(inp):
        calls.append(1)
        return inp["x"] * 2

    for value in (1, 2):
        out = progs.run("a", (3,), fn, {"x": np.full(3, value, np.int32)})
        assert out.tolist() == [2 * value] * 3
    progs.run("a", (4,), fn, {"x": np.zeros(4, np.int32)})
    progs.run("b", (3,), fn, {"x": np.zeros(3, np.int32)})
    assert progs.builds == {"a": 2, "b": 1} and len(calls) == 4
    assert sorted(progs.keys("a")) == [(3,), (4,)]
    progs.clear()
    assert progs.keys() == []
    progs.run("a", (3,), fn, {"x": np.zeros(3, np.int32)})
    assert progs.builds == {"a": 3, "b": 1}


def test_program_set_drops_the_keys_of_one_prefix():
    progs = ProgramSet(torch.device("cpu"))
    x = {"x": np.zeros(2, np.int32)}
    for kind, key in (("a", (1, 0)), ("a", (1, 1)), ("a", (2, 0)), ("b", (1, 0))):
        progs.run(kind, key, lambda inp: inp["x"], x)
    progs.drop("a", (1,))
    assert progs.keys("a") == [(2, 0)] and progs.keys("b") == [(1, 0)]
    progs.run("a", (1, 0), lambda inp: inp["x"], x)  # dropped: built again
    assert progs.builds == {"a": 4, "b": 1}


# ------------------------------------------------------------- generate
def test_jit_pipeline_matches_legacy_hostloop(model):
    """The program and the per-token host loop: the same tokens and, per
    token, the same logits, selected logits, ok flag and finish mask,
    through erasures (deadline safety 1.2, one seed)."""
    prompts = np.random.default_rng(0).integers(0, model.config.vocab_size, (2, 4))
    runs = []
    for jit in (True, False):
        server = _coded(model, max_decode_steps=6, jit_pipeline=jit)
        seen = []
        out = server.generate(prompts, 6, seed=7, observe=lambda t, lg, sel, ok, mask:
                              seen.append((t, lg.clone(), sel.clone(), bool(ok),
                                           mask.tolist())))
        runs.append((out, seen, server.traces))
    (out_p, seen_p, traces_p), (out_h, seen_h, traces_h) = runs
    assert torch.equal(out_p, out_h) and (traces_p, traces_h) == (1, 0)
    assert [s[0] for s in seen_p] == list(range(6))
    for a, b in zip(seen_p, seen_h, strict=True):
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]) and a[3:] == b[3:]
    assert any(not all(s[4]) for s in seen_p)  # workers were erased


def test_generate_modes_see_the_same_numpy_extras():
    """A numpy extra (whisper's encoder output) reaches the program as it
    reaches the host loop: the same tokens in both modes."""
    model = Model(ARCHS["whisper-tiny"].reduced(), device="cpu", seed=0)
    cfg = model.config
    frames = np.random.default_rng(4).standard_normal((2, cfg.encoder_seq, cfg.d_model))
    with torch.no_grad():
        enc_out = model.encode(torch.from_numpy(frames.astype(np.float32))).numpy()
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 3))
    outs = [_coded(model, jit_pipeline=jit).generate(prompts, 3, extras={"enc_out": enc_out})
            for jit in (True, False)]
    assert torch.equal(outs[0], outs[1])


def test_generate_is_single_compiled_program(model):
    """Two calls of one shape build one program; another max_new another."""
    server = _coded(model, max_decode_steps=5)
    prompts = np.random.default_rng(1).integers(0, model.config.vocab_size, (2, 4))
    first = server.generate(prompts, 5)
    assert server.traces == 1
    again = server.generate(prompts, 5, seed=9)
    assert server.traces == 1  # same shapes: zero programs built between calls
    assert torch.equal(server.generate(prompts, 5), first)  # seed 0 again
    assert again.shape == first.shape
    server.generate(prompts, 3)
    assert server.traces == 2 and server.serve_traces == 0


def test_true_cluster_and_deadline_rewrite_their_tensors_in_place(model):
    """What a captured program reads keeps its address: the true fleet's
    arrays across ``set_true_cluster`` calls, and the head's deadline;
    the programs built with a true fleet are not rebuilt when it moves."""
    server = _coded(model)
    head = server.coded_head
    prompts = np.random.default_rng(2).integers(0, model.config.vocab_size, (2, 3))
    server.set_true_cluster(ClusterSpec.make([2, 2], [4.0, 0.8]))
    bufs = [t.data_ptr() for t in server._true_params]
    server.generate(prompts, 2)
    server.set_true_cluster(ClusterSpec.make([2, 1], [3.0, 0.5]))
    assert [t.data_ptr() for t in server._true_params] == bufs
    assert float(server._true_params[2][-1]) == float("inf")  # a leaver
    server.generate(prompts, 2)
    assert server.traces == 1
    server.set_true_cluster(None)  # draws from the plan's own fleet: another key
    server.generate(prompts, 2)
    assert server.traces == 2
    ptr = head.deadline_t.data_ptr()
    head.deadline = 1e9
    assert head.deadline_t.data_ptr() == ptr and float(head.deadline_t) == 1e9


def test_capture_switch_is_set_before_the_programs(model):
    server = _coded(model)
    server._capture = False
    assert not server.programs.capture
    with pytest.raises(RuntimeError, match="before the programs"):
        server._capture = True


# ---------------------------------------------------------------- serve
def test_paged_serve_one_trace_across_8x_prompt_spread(model):
    """Prompt lengths spread 8x within and across traces: the programs of
    the first trace (decode_block=1: the keys (prefilling, 0),
    (prefilling, 1) and (decoding, 1)) serve the second, which builds
    none. Shapes depend only on (num_blocks, block_len, S, chunk)."""
    server = _coded(model)
    plens = [4, 32, 8, 16, 32, 4]
    trace = [_req(i, 2.0 * i, 3, p) for i, p in enumerate(plens)]
    bl, nb = 4, 2 * -(-(32 + 3 + 1) // 4)
    kw = dict(slots=2, decode_block=1, paged=True, block_len=bl, num_blocks=nb)
    rep = server.serve(trace, **kw)
    keys = {key[5:7] for key in server.programs.keys("serve")}
    assert server.serve_traces == len(keys) and keys <= {(True, 0), (True, 1), (False, 1)}
    assert len(_done(rep)) == len(plens)
    trace2 = [_req(i, 1.5 * i, 3, p) for i, p in enumerate([32, 4, 24, 6])]
    rep2 = server.serve(trace2, prompt_cap=32, **kw)
    assert server.serve_traces == len(keys)
    assert len(_done(rep2)) == 4


@pytest.mark.parametrize("paged", [True, False])
def test_serve_keeps_the_programs_of_one_shape(model, paged):
    """A run of another shape drops the old shape's programs and builds
    its own; the first shape again builds once more. Nothing is captured
    on the CPU, so no serve state outlives its run."""
    server = _coded(model)
    trace = [_req(i, 1.0 * i, 3, p) for i, p in enumerate([4, 8, 6])]
    kw = dict(slots=2, decode_block=2, paged=paged)
    sizes = [{"num_blocks": 8}, {"num_blocks": 12}] if paged else [{"max_out": 3},
                                                                   {"max_out": 5}]
    built = []
    for size in (*sizes, sizes[0]):
        rep = server.serve(trace, **kw, **size)
        assert len(_done(rep)) == 3
        shape = server._serve_shape
        assert all(key[:len(shape)] == shape for key in server.programs.keys("serve"))
        assert server._serve_st is None
        built.append(server.serve_traces)
    keys = len(server.programs.keys("serve"))
    assert built[1] > built[0] and built[2] == built[1] + keys


@pytest.mark.parametrize("paged", [True, False])
def test_serve_slot_swaps_never_retrace_and_replay_is_deterministic(model, paged):
    """Admits and evictions across a trace reuse the programs (at most one
    per (prefill or admit, steps) key); an identical replay builds
    nothing and reproduces the schedule, the streams and the erasures."""
    server = _coded(model)
    trace = make_workload("poisson", num_requests=8, prompt_len=(4, 8), out_len=(2, 6),
                          vocab=model.config.vocab_size).trace(seed=5)
    decode_block = 2
    rep1 = server.serve(trace, slots=2, decode_block=decode_block, paged=paged)
    built = server.serve_traces
    assert 1 <= built <= 2 * (decode_block + 1)
    rep2 = server.serve(trace, slots=2, decode_block=decode_block, paged=paged)
    assert server.serve_traces == built, (
        "slot admits/evicts must be buffer updates, not new programs")
    assert len(_done(rep1)) == 8 and rep1.shed == 0
    assert _done(rep2) == _done(rep1)
    assert rep2.streams == rep1.streams
    assert (rep2.decode_ok, rep2.erased_rounds) == (rep1.decode_ok, rep1.erased_rounds)
    assert rep1.erased_rounds > 0


def _reference_dispatches(ref, params, trace, paged, **kw):
    """The reference's serve, every dispatch's pending logits and tokens."""
    server = RefServer(ref, params, RefCluster.make(*FLEET),
                       RefServeConfig(block_rows=64, deadline_safety=50.0))
    attr = "_serve_step_paged_fn" if paged else "_serve_step_fn"
    step_fn = getattr(server, attr)
    seen = []

    def recording(*args, steps):
        out = step_fn(*args, steps=steps)
        seen.append((np.asarray(out[1]), np.asarray(out[3]) if steps else None))
        return out

    setattr(server, attr, recording)
    return server.serve(trace, key=KEY, paged=paged, **kw), seen


@pytest.mark.parametrize("paged", [True, False])
def test_programs_match_reference_dispatch_by_dispatch(ported, paged):
    ref, params, ours = ported
    trace_kw = dict(num_requests=5, prompt_len=(4, 20), out_len=(2, 5), vocab=512)
    kw = dict(slots=2, decode_block=2, **({"prefill_chunk": 8} if paged else {}))
    ref_rep, ref_seen = _reference_dispatches(
        ref, params, make_workload("poisson", **trace_kw).trace(seed=0), paged, **kw)
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    seen = []
    run = server._run

    def recording(kind, key, fn, inputs):
        toks = run(kind, key, fn, inputs)
        seen.append((fn.args[0]["logits"].clone().numpy(),
                     None if toks is None else toks.numpy()))
        return toks

    server._run = recording
    rep = server.serve(make_workload("poisson", **trace_kw).trace(seed=0), paged=paged, **kw)
    for f in ("tokens", "rounds", "decode_rounds", "prefill_rounds", "admitted", "shed"):
        assert getattr(rep, f) == getattr(ref_rep, f), f
    assert len(seen) == len(ref_seen)
    for (logits, toks), (ref_logits, ref_toks) in zip(seen, ref_seen):
        np.testing.assert_allclose(logits, ref_logits, rtol=2e-4, atol=2e-4)
        if ref_toks is None or ref_toks.size == 0:
            assert toks is None
        else:
            np.testing.assert_array_equal(toks, ref_toks)
    assert server.serve_traces == len(server.programs.keys("serve")) >= 2


def _sliced_splice(cache, logits, pos, plog, ks, vs, prompts, lengths, slot_idx):
    """The dense admit splice the fixed-shape one replaced: the first A
    rows of the prefill batch sliced out and written to their slots."""
    a = slot_idx.shape[0]
    plog, ks, vs, prompts, lengths = plog[:a], ks[:, :a], vs[:, :a], prompts[:a], lengths[:a]
    p = prompts.shape[1]
    cache["k"][:, slot_idx] = 0
    cache["v"][:, slot_idx] = 0
    cache["k"][:, slot_idx, :p] = ks
    cache["v"][:, slot_idx, :p] = vs
    seq = torch.arange(p, dtype=torch.int32)
    cache["pos"][slot_idx] = -1
    cache["pos"][slot_idx, :p] = torch.where(seq[None, :] < lengths[:, None], seq[None, :], -1)
    logits[slot_idx] = plog.float()
    pos[slot_idx] = lengths


@pytest.mark.parametrize("placed", [[2], [2, 0], [3, 1, 0], [1, 3, 0, 2]])
def test_fixed_shape_dense_splice_equals_the_sliced_splice(placed):
    rng = np.random.default_rng(len(placed))
    layers, slots, cache_len, kv, hd, p, vp = 2, 4, 11, 2, 4, 6, 16
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    cache = {"k": t(layers, slots, cache_len, kv, hd), "v": t(layers, slots, cache_len, kv, hd),
             "pos": torch.from_numpy(rng.integers(-1, 9, (slots, cache_len)).astype(np.int32))}
    logits, pos = t(slots, vp), torch.from_numpy(rng.integers(0, 9, slots).astype(np.int32))
    plog, ks, vs = t(slots, vp).bfloat16(), t(layers, slots, p, kv, hd), t(layers, slots, p, kv, hd)
    prompts = torch.zeros((slots, p), dtype=torch.int32)
    lengths = torch.zeros((slots,), dtype=torch.int32)
    rows = torch.full((slots,), -1, dtype=torch.int32)
    for r, si in enumerate(placed):
        lengths[r] = int(rng.integers(1, p + 1))
        prompts[r, : lengths[r]] = 1
        rows[si] = r
    want = {n: v.clone() for n, v in cache.items()}
    want_logits, want_pos = logits.clone(), pos.clone()
    _sliced_splice(want, want_logits, want_pos, plog, ks, vs, prompts, lengths,
                   torch.tensor(placed))
    got_logits, got_pos = Server._dense_splice(cache, logits, pos, plog, ks, vs, lengths, rows)
    for n in want:
        assert torch.equal(cache[n], want[n]), n
    assert torch.equal(got_logits, want_logits) and torch.equal(got_pos, want_pos)


def test_structural_replan_builds_again_and_bucket_switch_keeps_programs(model):
    """A bucketed head: a bucket switch (no re-encode) keeps every program;
    a membership change re-encodes the head and each key used after it is
    built once more."""
    server = Server(model, ClusterSpec.make([6, 6], [8.0, 0.7]),
                    ServeConfig(block_rows=16, deadline_safety=1.2, bucket_quantum=2))
    exe = server.coded_head.executor
    prompts = np.random.default_rng(3).integers(0, model.config.vocab_size, (2, 4))
    trace = make_workload("poisson", num_requests=4, prompt_len=(4, 8), out_len=(2, 4),
                          vocab=model.config.vocab_size).trace(seed=1)
    serve = functools.partial(server.serve, trace, slots=2, decode_block=2)
    server.generate(prompts, 3)
    serve()
    gen_builds, serve_builds = server.traces, server.serve_traces
    keys = set(server.programs.keys())
    exe.replan(ClusterSpec.make([6, 6], [8.0, 0.2]))
    assert not exe.last_replan_structural
    server.refresh_coded_head()
    server.generate(prompts, 3)
    serve()
    assert (server.traces, server.serve_traces) == (gen_builds, serve_builds)
    exe.replan(ClusterSpec.make([6, 3], [8.0, 0.7]))
    assert exe.last_replan_structural
    server.refresh_coded_head()
    server.generate(prompts, 3)
    serve()
    assert server.traces == 2 * gen_builds
    assert server.serve_traces == serve_builds + len(server.programs.keys("serve"))
    assert set(server.programs.keys()) == keys  # the same keys, built anew


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("flags", [
    ["--trace", "poisson", "--legacy-decode"],
    ["--coded", "--measure-times", "--legacy-decode"],
    ["--coded", "--trace", "poisson", "--measure-times", "--legacy-decode"],
])
def test_cli_legacy_decode_refusals_match_reference(flags):
    with pytest.raises(SystemExit) as ours:
        launch_serve.main(CLI_BASE + ["--device", "cpu"] + flags)
    with pytest.raises(SystemExit) as ref:
        ref_launch_serve.main(CLI_BASE + flags)
    assert str(ours.value) == str(ref.value) and "--legacy-decode" in str(ours.value)


def test_cli_legacy_decode_generates_the_program_tokens(capsys):
    base = CLI_BASE + ["--device", "cpu", "--coded", "--scheme", "uniform_r",
                       "--scheme-r", "10"]
    program = launch_serve.main(base)
    legacy = launch_serve.main(base + ["--legacy-decode"])
    assert torch.equal(program, legacy) and program.shape == (2, 8)
    assert capsys.readouterr().out.count("coded LM head [uniform_r_group_code]") == 2
