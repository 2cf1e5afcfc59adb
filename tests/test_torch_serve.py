"""Port parity, serving: the coded LM head, the slot scheduler and
``Server.serve`` (paged and dense) on reduced qwen3-0.6b.

* the head, with the reference's generator and finish masks injected as
  numpy, against ``CodedLMHead`` of the reference (float32 block mix and
  erasure solve: 1e-4);
* the host scheduler's telemetry event sequence, exactly;
* whole serves at ``deadline_safety=50`` (every worker meets the
  deadline): the same token streams and the same event sequence as the
  reference;
* in the port alone, with erasures: the coded serve emits the tokens of
  the uncoded serve;
* the port's dense and paged serves of one trace: the same streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.models.model import Model as RefModel
from repro.runtime.serve_loop import CodedLMHead as RefHead
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
import repro.serve.scheduler as ref_sched_mod
import repro.serve.workload as ref_wl
from repro_torch.configs import ARCHS
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.models.model import Model
from repro_torch.runtime.serve_loop import CodedLMHead, ServeConfig, Server
import repro_torch.serve.scheduler as sched_mod
import repro_torch.serve.workload as wl

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
FLEET = ([2, 2], [4.0, 0.8])
#: scheduler / pool events (the spans are compared in tests/test_torch_obs.py)
EVENTS = {"request_admitted", "request_evicted", "request_done", "blocks_in_use",
          "blocks_freed", "kv_bytes", "metrics_snapshot"}


class _Sink:
    def __init__(self):
        self.events = []

    def event(self, name, **fields):
        self.events.append((name, fields))
        return fields

    def only(self, names=EVENTS):
        return [(n, f) for n, f in self.events if n in names]


@pytest.fixture(scope="module")
def models():
    ref = RefModel(REF_ARCHS["qwen3-0.6b"].reduced())
    params = ref.init_params(KEY)
    ours = Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu")
    ours.params_from_jax(jax.tree.map(np.asarray, params))
    return ref, params, ours


# ------------------------------------------------------------ coded head
@pytest.mark.parametrize("block_rows", [64, 48])  # 48: the vocab pads
def test_coded_head_matches_reference(models, block_rows):
    _, params, ours = models
    table = np.asarray(params["embed"]["table"])
    ref = RefHead(jnp.asarray(table), RefCluster.make(*FLEET),
                  block_rows=block_rows, deadline_safety=3.0)
    head = CodedLMHead(ours.embed, ClusterSpec.make(*FLEET), block_rows=block_rows,
                       deadline_safety=3.0, g=np.asarray(ref.generator))
    assert (head.kb, head.nb) == (ref.kb, ref.nb)
    np.testing.assert_array_equal(head.block_owner.numpy(), np.asarray(ref.block_owner))
    np.testing.assert_allclose(head.coded.numpy(), np.asarray(ref.coded), rtol=1e-5, atol=1e-5)
    # kb <= 11 inflates integer loads past 5%: Monte-Carlo deadlines
    assert abs(head.deadline - ref.deadline) / ref.deadline < 0.05

    rng = np.random.default_rng(block_rows)
    logits = rng.standard_normal((3, table.shape[0])).astype(np.float32)
    prod = head.encode_logits(torch.from_numpy(logits))
    want = ref.encode_logits(jnp.asarray(logits))
    np.testing.assert_allclose(prod.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((3, table.shape[1])).astype(np.float32)
    np.testing.assert_allclose(head.worker_products(torch.from_numpy(h)).numpy(),
                               np.asarray(ref.worker_products(jnp.asarray(h))),
                               rtol=1e-5, atol=1e-5)
    w = head.plan.num_workers
    masks = [np.ones(w, bool), np.eye(w, dtype=bool)[0] ^ True,
             np.array([True, False, True, False]), np.zeros(w, bool)]
    for mask in masks:
        got, ok = head.decode_logits(prod, torch.from_numpy(mask))
        want_l, want_ok = ref.decode_logits_jit(want, jnp.asarray(mask))
        assert bool(ok) == bool(want_ok)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_l), rtol=1e-4, atol=1e-4)
        if bool(ok):
            np.testing.assert_allclose(got[:, : logits.shape[1]].numpy(), logits,
                                       rtol=1e-4, atol=1e-4)


def test_coded_select_masks_pad_and_falls_back():
    """Pad-vocab columns leave the coded round at -1e30; a round with
    too few survivors returns the plain logits unchanged."""
    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"].reduced(), vocab_size=500)
    model = Model(cfg, device="cpu")  # vocab padded to 512
    server = Server(model, ClusterSpec.make(*FLEET), ServeConfig(block_rows=64))
    logits = torch.randn((2, 512), generator=torch.Generator().manual_seed(0))
    logits[:, 500:] = -1e30  # as Model._mask_pad_logits leaves them
    sel, ok, mask = server.coded_select(logits, torch.Generator().manual_seed(1),
                                        deadline=1e9)
    assert bool(ok) and bool(mask.all())
    torch.testing.assert_close(sel[:, :500], logits[:, :500], rtol=1e-4, atol=1e-4)
    assert bool((sel[:, 500:] == -1e30).all())
    sel, ok, mask = server.coded_select(logits, torch.Generator().manual_seed(1),
                                        deadline=-1.0)
    assert not bool(ok) and not bool(mask.any())
    assert torch.equal(sel, logits)


# ------------------------------------------------------------- scheduler
def _drive(wl_mod, sched_mod_, seed):
    """The paged serve loop's host side, with no model: same offers,
    placements, prefill notes, advances and retirements."""
    trace = wl_mod.make_workload("overload", num_requests=14, prompt_len=(4, 30),
                                 out_len=(2, 9)).trace(seed=seed)
    sink = _Sink()
    pool = sched_mod_.BlockPool(9, 4, bytes_per_block=64, telemetry=sink)
    sched = sched_mod_.SlotScheduler(3, queue_cap=4, pool=pool, chunk=8, telemetry=sink)
    now, i = 0.0, 0
    while i < len(trace) or not sched.idle:
        while i < len(trace) and trace[i].arrival <= now + 1e-9:
            sched.offer(trace[i], now)
            i += 1
        sched.fill_slots(now)
        notes = [(si, min(8, s.request.prompt_len - s.prefilled))
                 for si, s in enumerate(sched.slots) if s.prefilling]
        fin = {si for si, take in notes
               if sched.slots[si].prefilled + take >= sched.slots[si].request.prompt_len}
        active = [si for si, s in enumerate(sched.slots)
                  if s.busy and not s.done and (not s.prefilling or si in fin)]
        steps = min([2] + [sched.slots[si].request.out_len - sched.slots[si].generated
                           for si in active]) if active else 0
        if notes or steps:
            for si, take in notes:
                sched.note_prefill(si, take)
            now += 1.0 if notes else 0.0
            if steps:
                now += steps
                sched.advance(steps)
            sched.retire_done(now)
        elif i < len(trace):
            now = max(now, trace[i].arrival)
        else:
            break
    fins = [(f.request.rid, f.outcome, f.reason, f.finish_round, f.tokens)
            for f in sched.finished]
    return [(r.rid, r.arrival, r.prompt, r.out_len, r.deadline_class) for r in trace], \
        sink.events, fins


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_event_sequence_matches_reference(seed):
    trace, events, fins = _drive(wl, sched_mod, seed)
    ref_trace, ref_events, ref_fins = _drive(ref_wl, ref_sched_mod, seed)
    assert trace == ref_trace
    assert events == ref_events
    assert fins == ref_fins
    reasons = {f[2] for f in fins}
    assert "finished" in reasons and len(reasons) > 1  # something was shed


# ------------------------------------------------------------- serve
def _ref_serve(ref, params, trace, monkeypatch, **kw):
    """Reference serve, recording every dispatch's tokens and the slot ->
    request map at each advance (the reference report drops tokens)."""
    server = RefServer(ref, params, RefCluster.make(*FLEET),
                       RefServeConfig(block_rows=64, deadline_safety=50.0))
    toks, owners = [], []
    attr = "_serve_step_paged_fn" if kw["paged"] else "_serve_step_fn"
    step_fn = getattr(server, attr)

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
    setattr(server, attr, recording_step)
    sink = _Sink()
    rep = server.serve(trace, telemetry=sink, key=KEY, **kw)
    streams = {}
    for arr, own in zip(toks, owners, strict=True):
        for si, rid in own.items():
            streams.setdefault(rid, []).extend(int(t) for t in arr[:, si])
    return rep, {r: tuple(v) for r, v in streams.items()}, sink


def test_serve_matches_reference_when_every_worker_finishes(models, monkeypatch):
    """The paged serve (chunked prefill)."""
    _check_serve_against_reference(models, monkeypatch, paged=True)


def test_dense_serve_matches_reference_when_every_worker_finishes(models, monkeypatch):
    """The dense serve (admit splice into per-slot caches)."""
    _check_serve_against_reference(models, monkeypatch, paged=False)


def _check_serve_against_reference(models, monkeypatch, *, paged):
    ref, params, ours = models
    trace_kw = dict(num_requests=5, prompt_len=(4, 20), out_len=(2, 5), vocab=512)
    serve_kw = dict(slots=2, decode_block=2)
    if paged:
        serve_kw["prefill_chunk"] = 8
    ref_rep, ref_streams, ref_sink = _ref_serve(
        ref, params, ref_wl.make_workload("poisson", **trace_kw).trace(seed=0),
        monkeypatch, paged=paged, **serve_kw)
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    sink = _Sink()
    rep = server.serve(wl.make_workload("poisson", **trace_kw).trace(seed=0),
                       telemetry=sink, paged=paged, **serve_kw)
    assert rep.streams == ref_streams
    for f in ("tokens", "rounds", "decode_rounds", "prefill_rounds", "admitted", "shed"):
        assert getattr(rep, f) == getattr(ref_rep, f), f
    assert [(f.request.rid, f.finish_round, f.tokens) for f in rep.finished] == [
        (f.request.rid, f.finish_round, f.tokens) for f in ref_rep.finished]
    assert sink.only() == ref_sink.only()
    assert rep.decode_ok == rep.decode_rounds and rep.erased_rounds == 0


def test_coded_serve_emits_uncoded_tokens_through_erasures(models):
    """deadline_safety=1.2 erases workers in most rounds; wherever the
    erasure decode succeeds the coded logits equal the plain ones to f32
    rounding, and the fallback takes the plain logits, so the streams of
    the coded and the uncoded server are identical."""
    _, _, ours = models
    trace = wl.make_workload("poisson", num_requests=6, prompt_len=(4, 20),
                             out_len=(2, 6), vocab=512).trace(seed=3)
    kw = dict(slots=2, decode_block=3, prefill_chunk=8, seed=5)
    coded = Server(ours, ClusterSpec.make(*FLEET),
                   ServeConfig(block_rows=64, deadline_safety=1.2)).serve(trace, **kw)
    plain = Server(ours).serve(trace, **kw)
    assert coded.streams == plain.streams
    assert coded.tokens == plain.tokens == sum(r.out_len for r in trace)
    assert plain.decode_ok == plain.erased_rounds == 0
    # some rounds lost workers and still decoded
    assert coded.erased_rounds > coded.decode_rounds - coded.decode_ok
    assert coded.kv_bytes == plain.kv_bytes > 0


def test_serve_rejects_what_the_port_does_not_serve(models):
    """A dense slot cache cannot hold a prompt past ``prompt_cap`` (the
    paged pool prefills it in chunks instead); an empty trace; a family
    the slot and paged paths do not take (hybrid: ``generate`` only)."""
    _, _, ours = models
    server = Server(ours)
    trace = wl.make_workload("poisson", num_requests=2, prompt_len=12,
                             vocab=512).trace(seed=0)
    with pytest.raises(ValueError, match="prompt_cap"):
        server.serve(trace, paged=False, prompt_cap=8)
    assert server.serve(trace, paged=True, prompt_cap=8, slots=1).tokens == sum(
        r.out_len for r in trace)
    with pytest.raises(ValueError, match="non-empty"):
        server.serve([])
    hybrid = Model(ARCHS["zamba2-1.2b"].reduced(), device="cpu")
    for paged in (True, False):
        with pytest.raises(NotImplementedError, match="hybrid"):
            Server(hybrid).serve(trace, paged=paged)


def test_dense_and_paged_serves_give_equal_streams(models):
    """One trace, erasures included (the same finish-mask seed): the dense
    slot cache and the paged pool emit the same streams and rounds."""
    _, _, ours = models
    trace = wl.make_workload("poisson", num_requests=6, prompt_len=(4, 20),
                             out_len=(2, 6), vocab=512).trace(seed=4)
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=1.2))
    kw = dict(slots=2, decode_block=3, seed=2)
    dense = server.serve(trace, paged=False, **kw)
    paged = server.serve(trace, paged=True, **kw)
    assert dense.streams == paged.streams
    for f in ("tokens", "rounds", "decode_rounds", "prefill_rounds", "decode_ok",
              "erased_rounds"):
        assert getattr(dense, f) == getattr(paged, f), f
    assert dense.tokens == sum(r.out_len for r in trace)
    assert dense.erased_rounds > 0
