"""Port parity, observability: the event-schema registry, the profile
summary, the serve loop's spans, the ops report and bf16 compression.

* ``repro_torch.obs.schema``: the reference's events, name for name and
  field for field (required and optional), the same verdicts on the
  reference test's contract cases, and README.md's generated table in
  sync (``--check``);
* ``repro_torch.obs.profile``: on the reference test's fixture (the XLA
  layout, no device events) ``summarize`` equals the reference's
  exactly, and a missing capture
  raises the same ``FileNotFoundError``; on a written-out torch-format
  trace, device events are filed by their launch (a kernel whose own
  midpoint lies outside its phase, a memcpy, a driver launch; one with
  no launch event is filed nowhere) and the ``gpu_user_annotation`` copy of a
  phase neither doubles its wall nor counts as an op; a real CPU
  ``torch.profiler`` capture of a reduced-qwen3 serve through ``capture``
  summarizes with every phase present;
* the serve loop's spans on reduced qwen3-0.6b, paged and dense: the
  sequence of (name, depth, parent, attrs) equal to the reference's on
  the same trace (``deadline_safety=50``: every worker finishes), every
  emitted record valid in the port's registry; ``generate``'s one
  ``dispatch`` span; a controller's ``adapt_update`` nested in the chunk
  that fed it;
* ``launch.obsreport``: the reference's markdown on one record list
  (apart from the profile section's heading), ``-o`` / ``--html`` and
  ``--require-spans``;
* ``optim.compression``: bit-equal to the reference over three
  error-feedback rounds.
"""
import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.obsreport as ref_obsreport
import repro.obs.profile as ref_profile
import repro.obs.schema as ref_schema
import repro.optim.compression as ref_compression
from repro.configs import ARCHS as REF_ARCHS
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.models.model import Model as RefModel
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
import repro.serve.workload as ref_wl
from repro_torch.configs import ARCHS
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.launch import obsreport
from repro_torch.models.model import Model
from repro_torch.obs import profile, schema
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SpanTracer
from repro_torch.optim import compress_bf16_ef, decompress_bf16_ef, init_error_feedback
from repro_torch.runtime.control import AdaptConfig, AdaptiveController
from repro_torch.runtime.serve_loop import ServeConfig, Server
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.timing import RoundClock
import repro_torch.serve.workload as wl

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
FLEET = ([2, 2], [4.0, 0.8])
README = os.path.join(os.path.dirname(__file__), "..", "README.md")


class _Sink:
    """A telemetry double: records (name, fields), as the serve parity
    tests' sink does."""

    def __init__(self):
        self.events = []

    def event(self, name, **fields):
        self.events.append((name, fields))
        return fields

    def spans(self):
        return [(f["span"], f["depth"], f["parent"], f["attrs"])
                for n, f in self.events if n == "span"]


@pytest.fixture(scope="module")
def models():
    ref = RefModel(REF_ARCHS["qwen3-0.6b"].reduced())
    params = ref.init_params(KEY)
    ours = Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu")
    ours.params_from_jax(jax.tree.map(np.asarray, params))
    return ref, params, ours


# ------------------------------------------------------------ event schema
def test_event_schemas_match_reference():
    assert list(schema.EVENT_SCHEMAS) == list(ref_schema.EVENT_SCHEMAS)
    assert schema.COMMON_FIELDS == ref_schema.COMMON_FIELDS
    for name, ours in schema.EVENT_SCHEMAS.items():
        ref = ref_schema.EVENT_SCHEMAS[name]
        assert ours.name == name
        assert list(ours.fields) == list(ref.fields), name
        assert list(ours.optional) == list(ref.optional), name
    assert schema.BEGIN_MARK != ref_schema.BEGIN_MARK  # the port's own markers
    assert schema.BEGIN_MARK.endswith("(repro_torch.obs.schema) -->")


_GOOD = {"event": "replan", "t": 0, "wall_s": 1.0, "workers": 4, "n": 12, "deadline": 1.5}
_SNAP = {"event": "metrics_snapshot", "metrics": [], "size": 0}


@pytest.mark.parametrize("rec,error", [
    (_GOOD, None),
    ({"event": "replan", "workers": 4}, "missing required"),
    ({**_GOOD, "oops": 1}, "undeclared fields"),
    ({"event": "not_a_thing"}, "unknown event"),
    ({"t": 0}, "no 'event' field"),
    (_SNAP, None),
    ({**_SNAP, "phase": "serve", "rounds": 3.0}, None),
    ({"event": "round_timing", "round": 0, "dispatch_s": 0.1, "pad_wall_s": 0.0,
      "scale": None, "unit_s": None, "workers": 2, "fed": False, "skipped": "warmup",
      "t_max": 0.1, "t_mean": 0.1}, "missing required"),  # an explicit wall_s is required
])
def test_validate_event_verdicts_match_reference(rec, error):
    if error is None:
        assert schema.validate_event(rec).name == ref_schema.validate_event(rec).name
        assert schema.validate_events([rec, rec]) == 2
        return
    with pytest.raises(ValueError, match=error):
        ref_schema.validate_event(rec)
    with pytest.raises(ValueError, match=error):
        schema.validate_event(rec)


def test_readme_event_table_is_generated_and_in_sync(capsys):
    with open(README) as f:
        block = schema.extract_generated_block(f.read())
    assert block == schema.render_markdown(), (
        "README.md's event table is stale: regenerate it with "
        "python -m repro_torch.obs.schema")
    for name in schema.EVENT_SCHEMAS:
        assert f"| `{name}` |" in block
    schema.main(["--check", README])
    assert "event-schema table is in sync (16 events)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no generated-schema markers"):
        schema.extract_generated_block("no table here")


# ----------------------------------------------------- profile attribution
def _write_xla_trace(profile_dir, sub, events):
    d = os.path.join(profile_dir, sub, "plugins", "profile", "run")
    os.makedirs(d)
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)


def _x(name, ts, dur, cat=None, **args):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": 0}
    if cat is not None:
        e["cat"] = cat
    if args:
        e["args"] = {k.replace("_", " "): v for k, v in args.items()}
    return e


def test_profile_summary_matches_reference_fixture(tmp_path):
    """The reference test's fixture: two capture sessions with unrelated
    time bases, one phase each."""
    _write_xla_trace(tmp_path, "generate", [
        _x("jit_generate#meta#", 1000, 100),
        _x("matmul", 1010, 40), _x("matmul", 1060, 20),
        _x("outside_window", 5000, 50),
    ])
    _write_xla_trace(tmp_path, "prefill", [
        _x("prefill", 40, 10), _x("splice", 42, 6),
    ])
    phases = ("jit_generate", "prefill")
    summ = profile.summarize(str(tmp_path), phases)
    assert summ == ref_profile.summarize(str(tmp_path), phases)
    assert summ["jit_generate"]["ops"][0] == {"name": "matmul", "total_us": 60.0, "count": 2}
    assert profile.summarize(str(tmp_path), phases, top_k=1) == ref_profile.summarize(
        str(tmp_path), phases, top_k=1)
    assert profile.find_trace_file(str(tmp_path)) == ref_profile.find_trace_file(str(tmp_path))
    kept = profile.summarize(str(tmp_path), phases, events=True)
    assert kept["prefill"].pop("events") == [_x("splice", 42, 6)]
    assert kept["jit_generate"].pop("events") == [_x("matmul", 1010, 40), _x("matmul", 1060, 20)]
    assert kept == summ


def test_profile_summarize_raises_without_captures(tmp_path):
    for mod in (ref_profile, profile):
        with pytest.raises(FileNotFoundError, match="no profiler capture"):
            mod.summarize(str(tmp_path), ("jit_generate",))
    assert profile.find_trace_file(str(tmp_path)) is None


def _torch_trace():
    """A torch.profiler-shaped trace: phase ``serve`` on [1000, 1100] and
    ``generate`` on [3000, 3050] (host ``user_annotation``), each with a
    longer ``gpu_user_annotation`` copy on the device timeline."""
    return [
        _x("PyTorch Profiler (0)", 0, 10_000, "Trace"),
        _x("ProfilerStep#1", 900, 3000, "user_annotation"),
        _x("serve", 1000, 100, "user_annotation", External_id=1),
        _x("serve", 1020, 300, "gpu_user_annotation"),
        _x("aten::mm", 1005, 30, "cpu_op", External_id=2),
        # launched inside the window, run after it (own midpoint 1190)
        _x("cudaLaunchKernel", 1010, 4, "cuda_runtime", correlation=11),
        _x("void psg::pipe_sgemm_kernel<...>", 1150, 80, "kernel", correlation=11),
        _x("cudaMemcpyAsync", 1050, 4, "cuda_runtime", correlation=12),
        _x("Memcpy HtoD (Pageable -> Device)", 1060, 10, "gpu_memcpy", correlation=12),
        # launched after the window closed, run inside it: not the phase's
        _x("cudaLaunchKernel", 2000, 4, "cuda_runtime", correlation=13),
        _x("elementwise_kernel", 1050, 5, "kernel", correlation=13),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 1010, "id": 11},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 1150, "id": 11},
        _x("generate", 3000, 50, "user_annotation", External_id=3),
        _x("generate", 3000, 400, "gpu_user_annotation"),
        _x("cuLaunchKernel", 3010, 2, "cuda_driver", correlation=14),
        _x("narrow::matvec_kernel", 3100, 20, "kernel", correlation=14),
        _x("aten::zero_", 3025, 10, "cpu_op"),
        _x("cudaMemsetAsync", 3030, 2, "cuda_runtime", correlation=15),
        _x("Memset (Device)", 3300, 3, "gpu_memset", correlation=15),
        # no launch event recorded: filed under no phase
        _x("Memset (Device)", 3010, 3, "gpu_memset", correlation=99),
    ]


def test_profile_files_device_events_by_their_launch(tmp_path):
    d = tmp_path / "serve"
    d.mkdir()
    (d / "host.pt.trace.json").write_text(json.dumps({"traceEvents": _torch_trace()}))
    summ = profile.summarize(str(tmp_path), ("serve", "generate", "absent"))
    assert summ == {
        "serve": {"wall_us": 100.0, "op_total_us": 90.0, "n_ops": 2, "ops": [
            {"name": "void psg::pipe_sgemm_kernel<...>", "total_us": 80.0, "count": 1},
            {"name": "Memcpy HtoD (Pageable -> Device)", "total_us": 10.0, "count": 1}]},
        "generate": {"wall_us": 50.0, "op_total_us": 23.0, "n_ops": 2, "ops": [
            {"name": "narrow::matvec_kernel", "total_us": 20.0, "count": 1},
            {"name": "Memset (Device)", "total_us": 3.0, "count": 1}]},
    }
    kept = profile.summarize(str(tmp_path), ("serve", "generate"), events=True)
    assert [e["args"]["correlation"] for e in kept["serve"]["events"]] == [11, 12]
    assert [e["args"]["correlation"] for e in kept["generate"]["events"]] == [14, 15]


def test_profile_host_rule_skips_annotations(tmp_path):
    """No device events: host ops by midpoint; annotations, the profiler's
    own span and ProfilerStep are not ops."""
    events = [e for e in _torch_trace()
              if e.get("cat") in ("Trace", "user_annotation", "gpu_user_annotation", "cpu_op")]
    events.append(_x("inner_range", 1010, 20, "user_annotation"))
    with gzip.open(tmp_path / "cpu.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    summ = profile.summarize(str(tmp_path), ("serve", "generate"))
    assert summ == {
        "serve": {"wall_us": 100.0, "op_total_us": 30.0, "n_ops": 1,
                  "ops": [{"name": "aten::mm", "total_us": 30.0, "count": 1}]},
        "generate": {"wall_us": 50.0, "op_total_us": 10.0, "n_ops": 1,
                     "ops": [{"name": "aten::zero_", "total_us": 10.0, "count": 1}]},
    }


def test_profile_capture_of_a_cpu_serve(models, tmp_path):
    """Three phases, each its own ``capture`` session on the CPU: a paged
    serve, a dense serve and a coded generate of reduced qwen3-0.6b."""
    _, _, ours = models
    server = Server(ours, ClusterSpec.make(*FLEET), ServeConfig(block_rows=64))
    trace = wl.make_workload("poisson", num_requests=3, prompt_len=(4, 10), out_len=(2, 3),
                             vocab=512).trace(seed=0)
    phases = ("serve_paged", "serve_dense", "generate")
    with profile.capture(str(tmp_path), "serve_paged") as prof:
        paged = server.serve(trace, slots=2, decode_block=2, paged=True)
    assert prof is not None
    with profile.capture(str(tmp_path), "serve_dense"):
        dense = server.serve(trace, slots=2, decode_block=2, paged=False)
    with profile.capture(str(tmp_path), "generate"):
        server.generate(np.ones((2, 4), np.int32), 3)
    assert paged.streams == dense.streams
    files = profile.find_trace_files(str(tmp_path))
    assert sorted(os.path.basename(f) for f in files) == [
        f"{p}.pt.trace.json" for p in sorted(phases)]
    summ = profile.summarize(str(tmp_path), phases, top_k=3)
    assert set(summ) == set(phases)
    for p in phases:
        s = summ[p]
        assert s["wall_us"] > 0 and s["n_ops"] > 0 and s["op_total_us"] > 0, p
        assert len(s["ops"]) == 3 and all(o["count"] >= 1 for o in s["ops"]), p
    kept = profile.summarize(str(tmp_path), phases, top_k=3, events=True)
    assert {p: len(kept[p].pop("events")) for p in phases} == {
        p: summ[p]["n_ops"] for p in phases}
    assert kept == summ
    md = obsreport.render_report([], profile_summary=summ)
    assert "## Torch profile summary (per phase)" in md and "`serve_paged`" in md


# ------------------------------------------------------------ serve spans
def _trace_kw(paged):
    serve_kw = dict(slots=2, decode_block=2)
    if paged:
        serve_kw["prefill_chunk"] = 8
    return dict(num_requests=5, prompt_len=(4, 20), out_len=(2, 5), vocab=512), serve_kw


@pytest.mark.parametrize("paged", [True, False])
def test_serve_spans_match_reference(models, paged):
    """The same trace, every worker finishing: the reference's and the
    port's span sequences agree in name, depth, parent and attributes."""
    ref, params, ours = models
    trace_kw, serve_kw = _trace_kw(paged)
    ref_server = RefServer(ref, params, RefCluster.make(*FLEET),
                           RefServeConfig(block_rows=64, deadline_safety=50.0))
    ref_sink = _Sink()
    ref_server.serve(ref_wl.make_workload("poisson", **trace_kw).trace(seed=0),
                     telemetry=ref_sink, key=KEY, paged=paged, **serve_kw)
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    sink = _Sink()
    rep = server.serve(wl.make_workload("poisson", **trace_kw).trace(seed=0),
                       telemetry=sink, paged=paged, **serve_kw)
    spans = sink.spans()
    assert spans == ref_sink.spans()
    names = {s[0] for s in spans}
    assert names == ({"admit", "prefill_chunk", "decode_chunk", "dispatch"} if paged
                     else {"admit", "decode_chunk", "dispatch"})
    chunks = sum(s[0] in ("prefill_chunk", "decode_chunk") for s in spans)
    assert chunks == sum(s[0] == "dispatch" for s in spans) > 0
    assert sum(s[0] == "admit" for s in spans) >= rep.prefill_rounds
    for name, fields in sink.events:
        schema.validate_event({"event": name, **fields}, source=" (port serve)")
    # the sink implied a tracer; the server and its executor hold it
    assert server.tracer.telemetry is sink
    assert server.coded_head.executor.tracer is server.tracer


def test_serve_emits_only_declared_events_and_spans(models):
    """The counterpart of the reference's end-to-end schema test: a traced
    paged serve's whole event stream satisfies the port's registry; a
    measured serve with a controller adds ``round_timing`` and
    ``adapt_decision``, and each ``adapt_update`` nests in the chunk that
    fed it."""
    _, _, ours = models
    server = Server(ours, ClusterSpec.make([2, 2], [4.0, 0.8]), ServeConfig(block_rows=64))
    trace = wl.make_workload("poisson", num_requests=6, prompt_len=(4, 8), out_len=(2, 4),
                             vocab=512).trace(seed=3)
    tel = Telemetry(None)
    rep = server.serve(trace, slots=2, decode_block=2, telemetry=tel)
    assert rep.admitted > 0
    n = schema.validate_events(tel.events, source="paged serve run")
    names = {e["event"] for e in tel.events}
    assert {"span", "metrics_snapshot", "request_admitted", "blocks_in_use"} <= names
    spans = {e["span"] for e in tel.events if e["event"] == "span"}
    assert {"admit", "prefill_chunk", "dispatch"} <= spans
    assert n == len(tel.events) > 0

    tel = Telemetry(None)
    tracer = SpanTracer(tel)
    ctl = AdaptiveController(server.coded_head.executor, AdaptConfig(every=2),
                             telemetry=tel, on_replan=server.refresh_coded_head)
    clock = RoundClock(server.coded_head.executor, telemetry=tel)
    server.serve(trace, slots=2, decode_block=2, clock=clock, controller=ctl, tracer=tracer,
                 paged=False)
    assert server.tracer is tracer and tracer.telemetry is tel
    schema.validate_events(tel.events, source="measured dense serve run")
    names = {e["event"] for e in tel.events}
    assert {"span", "round_timing", "adapt_decision"} <= names
    updates = [s for s in tracer.spans if s.name == "adapt_update"]
    assert len(updates) == len(ctl.decisions) > 0
    assert all(s.parent == "decode_chunk" and s.depth == 1 for s in updates)
    assert all(s.parent == "adapt_update" for s in tracer.spans if s.name == "replan")


def test_generate_is_one_dispatch_span(models):
    _, _, ours = models
    server = Server(ours, ClusterSpec.make(*FLEET), ServeConfig(block_rows=64))
    server.generate(np.ones((2, 3), np.int32), 2)  # untraced: NULL_TRACER
    server.tracer = SpanTracer()
    server.generate(np.ones((2, 3), np.int32), 2)
    server.generate(np.ones((2, 3), np.int32), 0)  # nothing to dispatch
    (span,) = server.tracer.spans
    assert (span.name, span.depth, span.parent) == ("dispatch", 0, None)
    assert span.attrs == {"kind": "generate", "max_new": 2, "batch": 2}


# --------------------------------------------------------------- obsreport
def _report_records():
    """The reference test's record list, made once by the port's sinks."""
    tel = Telemetry(None)
    tr = SpanTracer(tel)
    with tr.span("decode_chunk", steps=2):
        with tr.span("dispatch"):
            pass
    tel.event("request_admitted", request_id=0, slot=0, queue_wait=1.0,
              deadline_class="standard", round=1.0)
    tel.event("request_done", request_id=0, slot=0, tokens=4, latency=9.0,
              deadline_class="standard", round=10.0)
    tel.event("request_evicted", request_id=1, reason="queue_full",
              deadline_class="strict", round=2.0, queue_depth=3)
    tel.event("adapt_decision", round=4, replanned=True, reason="improvement",
              current=2.0, candidate=1.5, gain=0.25, deadline=1.9, workers=4)
    tel.event("plan_bucket_miss", structural=True, bucket=0, buckets=1, n=12, n_cap=16,
              workers=4)
    tel.event("round_timing", round=0, wall_s=0.5, dispatch_s=0.4, pad_wall_s=0.0,
              scale=1.1, unit_s=0.01, workers=4, fed=True, skipped=None, t_max=0.2,
              t_mean=0.1)
    tel.event("round_timing", round=1, wall_s=0.6, dispatch_s=0.5, pad_wall_s=0.0,
              scale=None, unit_s=0.01, workers=4, fed=False, skipped="outlier",
              t_max=0.2, t_mean=0.1)
    tel.event("blocks_in_use", in_use=3, free=1, capacity=4, request_id=0, round=1.0)
    tel.event("blocks_freed", blocks=3, total_freed=3, request_id=0, round=9.0)
    tel.event("kv_bytes", bytes_in_use=384, bytes_total=512, utilization=0.75,
              request_id=0, round=1.0)
    reg = MetricsRegistry()
    reg.counter("tokens_emitted").inc(4)
    reg.histogram("request_latency", deadline_class="standard").observe(9.0)
    reg.emit(tel, phase="serve", rounds=10.0)
    schema.validate_events(tel.events)
    return list(tel.events) + [{"step": 0, "loss": 2.5}]


def test_render_report_matches_reference():
    records = _report_records()
    summary = {"serve_paged": {"wall_us": 2500.0, "op_total_us": 900.0, "n_ops": 7,
                               "ops": [{"name": "paged_decode_split_kernel",
                                        "total_us": 600.0, "count": 4}]},
               "generate": {"wall_us": 1500.0, "op_total_us": 0.0, "n_ops": 0, "ops": []}}
    md = obsreport.render_report(records, source="unit.jsonl", profile_summary=summary)
    want = ref_obsreport.render_report(records, source="unit.jsonl", profile_summary=summary)
    assert md == want.replace("## XLA profile summary", "## Torch profile summary")
    for heading in ("# Ops report", "## Overview", "## Span waterfall",
                    "## Request latency", "## Replan / decision timeline",
                    "## Straggler-estimate drift", "## KV block pool",
                    "## Metrics snapshot", "## Torch profile summary (per phase)"):
        assert heading in md, f"missing section {heading!r}"
    assert "UNDECLARED" not in md
    assert obsreport.render_report(records[:1]) == ref_obsreport.render_report(records[:1])


def test_obsreport_cli_writes_files_and_requires_spans(tmp_path, capsys):
    src = tmp_path / "run.jsonl"
    with open(src, "w") as f:
        for rec in _report_records():
            f.write(json.dumps(rec) + "\n")
    summary = tmp_path / "summary.json"
    summary.write_text(json.dumps({"profile_summary": {"serve_paged": {
        "wall_us": 10.0, "op_total_us": 5.0, "n_ops": 1,
        "ops": [{"name": "k", "total_us": 5.0, "count": 1}]}}}))
    out, html = tmp_path / "r.md", tmp_path / "r.html"
    obsreport.main([str(src), "-o", str(out), "--html", str(html), "--require-spans",
                    "--profile-summary", str(summary)])
    text = out.read_text()
    assert "## Span waterfall" in text and "## Torch profile summary" in text
    assert html.read_text().startswith("<!doctype html>")
    assert "span coverage: 2 spans" in capsys.readouterr().out
    assert obsreport.load_records(str(src)) == ref_obsreport.load_records(str(src))

    bare = tmp_path / "untraced.jsonl"
    with open(bare, "w") as f:
        f.write(json.dumps({"event": "replan", "t": 0, "wall_s": 0.0,
                            "workers": 2, "n": 4, "deadline": 1.0}) + "\n")
    obsreport.main([str(bare)])  # fine without the flag
    assert "_No `span` events" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no span events"):
        obsreport.main([str(bare), "--require-spans"])


# -------------------------------------------------------------- compression
def test_compression_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    shapes = {"embed": (33, 8), "norm": (8,), "w": (5, 7, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    ef = init_error_feedback({k: torch.from_numpy(v) for k, v in params.items()})
    ref_ef = ref_compression.init_error_feedback({k: jnp.asarray(v) for k, v in params.items()})
    for k in shapes:
        assert ef[k].dtype == torch.float32 and not ef[k].any()
    for _ in range(3):
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 3)).astype(np.float32)
                 for k, s in shapes.items()}
        comp, ef = compress_bf16_ef({k: torch.from_numpy(v) for k, v in grads.items()}, ef)
        ref_comp, ref_ef = ref_compression.compress_bf16_ef(
            {k: jnp.asarray(v) for k, v in grads.items()}, ref_ef)
        dec = decompress_bf16_ef(comp)
        ref_dec = ref_compression.decompress_bf16_ef(ref_comp)
        for k in shapes:
            assert comp[k].dtype == torch.bfloat16
            # bit patterns: bf16 widened exactly to f32, and the f32 residuals
            np.testing.assert_array_equal(dec[k].numpy().view(np.uint32),
                                          np.asarray(ref_dec[k]).view(np.uint32))
            np.testing.assert_array_equal(ef[k].numpy().view(np.uint32),
                                          np.asarray(ref_ef[k]).view(np.uint32))
        assert any(bool(ef[k].any()) for k in shapes)  # the residual carries
