"""Serve cells: a dense model served paged by ``Server.serve``, with the
coded LM head or the plain one, on successive seeded traces.

Set-up builds the kernels (into the checkout's build cache), the model
with the benchmark's own seeded weights in the dtype it serves, and the
server (the coded head's generator and its B3 encode), then serves one
warm-up trace that reaches every dispatch key of the cell's shape twice,
so every program is built and captured before the window opens. The
window serves whole traces back to back until ``--seconds`` have passed;
every call ends synchronised. A traced run serves one more trace after
the window with the program's span tracer and telemetry on, and profiles
a few of its steady dispatches.

The check: once the window has closed and the program is freed, a
sample of the requests it finished (drawn from the seed, the longest
always in it) is run through the float32 reference over prompt and
served tokens, and the widest gap by which a served token's logit lies
below the reference's best is compared with the cell's limit.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench import gen, profiling, weights
from perfbench.reference import llama


@dataclasses.dataclass
class Call:
    """One ``Server.serve`` call of the window (or the profiled one)."""

    trace: list
    wall: float
    offered: int
    done: int
    shed: int
    tokens: int  # output tokens of the requests that finished
    decoded: int  # tokens emitted to any stream
    decode_rounds: int
    prefill_rounds: int
    decode_ok: int
    erased_rounds: int
    streams: dict  # rid -> served tokens, finished requests
    spans: list | None = None
    admitted: dict | None = None


def program_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file's sizes."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], head_dim=cfg.get("head_dim"),
        rope_theta=float(cfg["rope_theta"]), param_dtype=cfg["param_dtype"],
        compute_dtype=cfg["compute_dtype"], tie_embeddings=True)


#: the pool's block length and the admission queue's capacity
BLOCK_LEN, QUEUE_CAP = 16, 64


def pool_blocks(cfg: dict, mix: dict) -> int:
    """KV blocks in the memory the configuration gives the cache
    (``kv_cache_gib``), as a deployment sizes its pool from what the
    weights leave free; refused when that cannot hold every slot's
    longest request."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim", d // heads)
    itemsize = torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8
    block = (cfg["num_hidden_layers"] * 2 * BLOCK_LEN * cfg["num_key_value_heads"] * hd
             * itemsize)
    blocks = int(float(cfg["kv_cache_gib"]) * 2**30 // block)
    longest = int(mix["prompt_len"][1]) + max(r[1] for r, _ in mix["out_len_mix"]) + 1
    need = int(mix["slots"]) * -(-longest // BLOCK_LEN)
    if blocks < need:
        raise ValueError(f"kv_cache_gib {cfg['kv_cache_gib']} holds {blocks} blocks of "
                         f"{BLOCK_LEN}; the mix's slots need {need}")
    return blocks


def serve_kwargs(mix: dict, cfg: dict) -> dict:
    """``Server.serve``'s shape and admission arguments for a mix."""
    return dict(slots=int(mix["slots"]), decode_block=int(mix["decode_block"]),
                prefill_chunk=int(mix["prefill_chunk"]), block_len=BLOCK_LEN,
                num_blocks=pool_blocks(cfg, mix), queue_cap=QUEUE_CAP)


def make_model(cx, seed: int):
    """The served model on the cell's device with the seed's weights (the
    kernels built first on the card)."""
    from repro_torch.models.model import Model
    import repro_torch.kernels as kernels

    cx.mark("imports")
    if cx.device.type == "cuda":
        kernels.build_all()
    cx.mark("kernels")
    model = Model(program_config(cx.config), device=cx.device, seed=0)
    weights.fill(dict(model.named_parameters()), cx.config, seed)
    cx.mark("weights")
    return model


def make_server(cx, model):
    """The server of the mix's head over ``model`` (the coded head's
    generator and B3 encode happen here)."""
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.runtime.serve_loop import ServeConfig, Server

    head = cx.config["coded_head"]
    cluster = (ClusterSpec.make(head["workers"], head["mu"], head["alpha"])
               if cx.mix["head"] == "coded" else None)
    scfg = ServeConfig(block_rows=int(head["block_rows"]),
                       deadline_safety=float(head["deadline_safety"]),
                       scheme=head["scheme"], block_len=BLOCK_LEN)
    srv = Server(model, cluster, scfg)
    if srv.coded_head is not None:
        cx.head_shape = (srv.coded_head.nb, srv.coded_head.kb, srv.coded_head.block_rows)
    cx.mark("server")
    return srv


def to_requests(trace: list) -> list:
    from repro_torch.serve.workload import Request

    return [Request(rid=r.rid, arrival=r.arrival, prompt=r.prompt, out_len=r.out_len,
                    deadline_class=r.deadline_class) for r in trace]


def serve_call(srv, trace: list, kw: dict, seed: int, *, tracer=None, telemetry=None) -> Call:
    """One whole ``serve`` call, timed by the host's clock (the call ends
    synchronised with the card)."""
    t0 = time.perf_counter()
    rep = srv.serve(to_requests(trace), seed=seed, tracer=tracer, telemetry=telemetry, **kw)
    wall = time.perf_counter() - t0
    done = [f.request.rid for f in rep.finished if f.outcome == "done"]
    return Call(trace=trace, wall=wall, offered=len(trace), done=len(done), shed=rep.shed,
                tokens=rep.tokens, decoded=sum(len(s) for s in rep.streams.values()),
                decode_rounds=rep.decode_rounds, prefill_rounds=rep.prefill_rounds,
                decode_ok=rep.decode_ok, erased_rounds=rep.erased_rounds,
                streams={rid: rep.streams.get(rid, ()) for rid in done})


def warmup(cx, srv, kw: dict) -> None:
    """Serve the warm-up trace; on the card, every key of the shape is then
    captured (a prefill round with no decode exists only when a prompt
    can outrun one chunk)."""
    serve_call(srv, gen.warmup_trace(cx.mix, cx.config["vocab_size"], cx.seed), kw,
               gen.sub_seed(cx.seed, 2**31))
    if cx.device.type == "cuda":
        db = kw["decode_block"]
        want = 2 * db + (kw["prefill_chunk"] < int(cx.mix["prompt_len"][1]))
        got = len(srv.programs.keys("serve", captured=True))
        if got != want:
            raise RuntimeError(f"warm-up captured {got} serve programs, the shape has {want}")
    cx.mark("warmup")


class ProfilingTracer:
    """The program's span tracer, with a profiler window opened at dispatch
    ``first`` and closed after ``count`` dispatches, and every span also a
    host annotation of the trace while the window is open."""

    def __init__(self, inner, window: profiling.Window, first: int, count: int):
        self.inner, self.window, self.first, self.count = inner, window, first, count
        self.dispatches = 0
        self.profiled: list[int] = []

    def span(self, name: str, **attrs):
        return _Span(self, name, attrs)


class _Span:
    def __init__(self, tracer: ProfilingTracer, name: str, attrs: dict):
        self.t, self.name, self.attrs = tracer, name, attrs
        self.index = None

    def __enter__(self):
        t = self.t
        if self.name == "dispatch":
            self.index = t.dispatches
            t.dispatches += 1
            if self.index == t.first:
                t.window.start()
        self.span = t.inner.span(self.name, **self.attrs)
        self.span.__enter__()
        self.note = profiling.annotate(self.name) if t.window.open else None
        if self.note is not None:
            self.note.__enter__()
        return self

    def set(self, **attrs) -> None:
        self.span.set(**attrs)

    def __exit__(self, *exc):
        if self.note is not None:
            self.note.__exit__(*exc)
        self.span.__exit__(*exc)
        t = self.t
        if self.index is not None and t.window.open:
            t.profiled.append(self.index)
            if self.index == t.first + t.count - 1:
                t.window.stop()
        return False


def profiled_call(cx, srv, kw: dict, index: int) -> tuple[Call, ProfilingTracer]:
    """Trace ``index`` served with spans and telemetry, dispatches
    ``profile_from`` .. + ``profile_dispatches`` under the profiler."""
    from repro_torch.obs.trace import SpanTracer
    from repro_torch.runtime.telemetry import Telemetry

    tel = Telemetry()
    win = profiling.Window()
    tracer = ProfilingTracer(SpanTracer(), win, int(cx.mix["profile_from"]),
                             int(cx.mix["profile_dispatches"]))
    call = serve_call(srv, gen.serve_trace(cx.mix, cx.config["vocab_size"], cx.seed, index),
                      kw, gen.sub_seed(cx.seed, index, 7), tracer=tracer, telemetry=tel)
    if win.open:
        win.stop()
    call.spans = list(tracer.inner.spans)
    call.admitted = {e["request_id"]: float(e["round"]) for e in tel.events
                     if e["event"] == "request_admitted"}
    cx.profile = win.trace
    return call, tracer


def window(cx, srv, kw: dict) -> list[Call]:
    """Whole traces back to back until ``cx.seconds`` have passed; with
    tracing, each call keeps the program's spans."""
    from repro_torch.obs.trace import SpanTracer

    builds, captures = srv.programs.builds.get("serve", 0), srv.programs.captures
    calls, t0, i = [], time.perf_counter(), 0
    while True:
        tracer = SpanTracer() if cx.trace else None
        trace = gen.serve_trace(cx.mix, cx.config["vocab_size"], cx.seed, i)
        call = serve_call(srv, trace, kw, gen.sub_seed(cx.seed, i, 7), tracer=tracer)
        if tracer is not None:
            call.spans = list(tracer.spans)
        calls.append(call)
        i += 1
        if time.perf_counter() - t0 >= cx.seconds:
            break
    if (srv.programs.builds.get("serve", 0), srv.programs.captures) != (builds, captures):
        raise RuntimeError("a serve program was built or captured inside the window")
    return calls


def sample(cx, calls: list[Call]) -> list[tuple[list, list]]:
    """(prompt, served tokens) of the finished requests the check runs: the
    longest of the window, then others in an order drawn from the seed
    until ``check.tokens`` served tokens or ``check.requests`` requests."""
    done = [(c.trace[rid].prompt, list(s)) for c in calls for rid, s in c.streams.items()]
    if not done:
        return []
    rng = np.random.RandomState(gen.sub_seed(cx.seed, 3))
    longest = max(range(len(done)), key=lambda j: len(done[j][0]) + len(done[j][1]))
    order = [longest] + [int(j) for j in rng.permutation(len(done)) if j != longest]
    picked, served = [], 0
    for j in order:
        if served >= cx.mix["check"]["tokens"] or len(picked) >= cx.mix["check"]["requests"]:
            break
        picked.append(done[j])
        served += len(done[j][1])
    return picked


def readings(cx, picked, seed: int, *, control: bool = False) -> dict:
    """The reference's judgement of the served tokens: the widest gap of a
    served token below the reference's best; with ``control``, the same
    gap of the tokens the float8 control puts first at each position."""
    cfg = cx.config
    w = weights.make(cfg, seed, cx.device, getattr(torch, cfg["param_dtype"]))
    seqs = [torch.tensor(list(p) + s[:-1], device=cx.device) for p, s in picked]
    spans = [(len(p) - 1, len(p) - 1 + len(s)) for p, s in picked]
    ref = llama.logits(w, cfg, seqs, spans)
    out = {"max_gap": max(float((r.max(-1).values
                                 - r.gather(-1, torch.tensor(s, device=r.device)[:, None])[:, 0]
                                 ).max()) for r, (_, s) in zip(ref, picked)),
           "served": sum(len(s) for _, s in picked)}
    if control:
        ctl = llama.logits(w, cfg, seqs, spans, weight_cast=llama.fp8_round_trip)
        out["control_gap"] = max(float((r.max(-1).values
                                        - r.gather(-1, c.argmax(-1)[:, None])[:, 0]).max())
                                 for r, c in zip(ref, ctl))
    return out


def run(cx) -> None:
    kw = serve_kwargs(cx.mix, cx.config)
    model = make_model(cx, cx.seed)
    srv = make_server(cx, model)
    warmup(cx, srv, kw)
    calls = window(cx, srv, kw)
    cx.window = calls
    if cx.trace:
        cx.profiled, cx.profiler = profiled_call(cx, srv, kw, len(calls))
    if cx.device.type == "cuda":
        torch.cuda.synchronize()
        cx.memory_peak_bytes = torch.cuda.max_memory_allocated(cx.device)
    cx.attempted = sum(c.offered for c in calls)
    cx.failed = sum(c.offered - c.done for c in calls)
    short = sum(len(s) != c.trace[rid].out_len for c in calls for rid, s in c.streams.items())
    srv = model = None
    gc.collect()
    if cx.device.type == "cuda":
        torch.cuda.empty_cache()
    r = readings(cx, sample(cx, calls), cx.seed)
    cx.checks = {"max_gap": (r["max_gap"], cx.limit("max_gap")),
                 "short_streams": (float(short), 0.0)}
    cx.correct = all(v <= lim for v, lim in cx.checks.values())
