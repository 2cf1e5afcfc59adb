"""Serving entry point: ``python -m repro_torch.launch.serve --arch qwen3-0.6b --coded``

Counterpart of ``repro/launch/serve.py``: batched greedy generation on
the port's model (seeded random weights), on the card unless
``--device cpu``. With ``--coded`` the LM head's matvec is MDS-coded over
a simulated heterogeneous fleet (``--groups``) under any registered
allocation scheme (``--scheme``); workers that miss the deadline are
erasures and the logits are decoded from the survivors. ``--trace``
replays a seeded request workload through the continuous-batching
server instead, on the paged KV pool or, with ``--dense-kv``, on dense
per-slot caches. ``--scenario`` serves ``--rounds`` rounds of one
generate each against a drifting true fleet (a registered cluster
scenario); with ``--adapt-every`` an ``AdaptiveController`` observes
every round and replans the coded head (re-encoded through B3) when its
hysteresis rule fires. ``--measure-times`` runs each dispatch (a
``generate`` round, or a serve chunk of ``--trace``) under a
``RoundClock`` and, with a controller, replans from the measured times;
it prints ``measured: F/R rounds fed``. ``--bucket-quantum`` quantizes
the head's loads so that a replan within the bucket capacity keeps the
coded head (no B3 re-encode).

Observability: ``--telemetry PATH`` is the JSONL sink of ``--trace`` and
``--scenario`` runs (the scheduler's and pool's events, the serve loop's
spans, the clock's ``round_timing`` and the controller's decisions; feed
it to ``python -m repro_torch.launch.obsreport``), and ``--chrome-trace
PATH`` exports the run's spans as Chrome ``trace_event`` JSON (it prints
``chrome trace: PATH (N spans)``). ``--slots auto`` asks an
``AdaptiveController`` on the coded fleet for the ``--trace`` width.

``--arch`` takes every registered config. A vlm config generates text
(its stub image embeddings go to ``generate``, which serves text only,
as the reference's), an audio one from the encoder output of stub frames
(``Model.encode``). ``--trace`` on a hybrid, ssm, audio, sliding-window
or ``kv_quant`` config exits non-zero with the reference's refusal (those
configs only ``generate``).

``--legacy-decode`` runs ``generate`` as the eager per-token host loop
(``ServeConfig(jit_pipeline=False)``) instead of its captured program,
the A/B baseline; it refuses ``--trace`` and ``--measure-times`` with the
reference's messages. Not ported (argparse refuses it): ``--use-kernel``
(on the card the head always runs its kernel).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import make_scheme, scheme_names
from repro_torch.data.pipeline import make_extras
from repro_torch.models.model import Model
from repro_torch.obs.trace import SpanTracer
from repro_torch.runtime.control import AdaptConfig, AdaptiveController
from repro_torch.runtime.compile_cache import enable_persistent_cache
from repro_torch.runtime.serve_loop import ServeConfig, Server
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.timing import RoundClock
from repro_torch.serve.workload import make_workload, workload_names
from repro_torch.sim import make_scenario, scenario_names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-sized smoke variant of the arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--coded", action="store_true",
                    help="serve logits through the coded LM head")
    ap.add_argument("--groups", default="6:2.0,6:0.5",
                    help="heterogeneous fleet as N:mu or N:mu:bandwidth groups "
                         "(bandwidth feeds the comm-delay schemes)")
    ap.add_argument("--bandwidth", type=float, default=None,
                    help="link bandwidth for groups without their own "
                         "(default: infinite = comm-free)")
    ap.add_argument("--scheme", default="optimal", choices=scheme_names(),
                    help="registered allocation scheme for the coded head")
    ap.add_argument("--scheme-n", type=float, default=None,
                    help="code size n for --scheme uniform_n / comm_uniform")
    ap.add_argument("--scheme-r", type=int, default=None,
                    help="completion count r for --scheme uniform_r")
    ap.add_argument("--comm-upload", type=float, default=None,
                    help="fixed per-round transfer cost for --scheme comm_aware / "
                         "comm_uniform (divided by bandwidth)")
    ap.add_argument("--comm-download", type=float, default=None,
                    help="per-row transfer cost for --scheme comm_aware / "
                         "comm_uniform (divided by bandwidth)")
    ap.add_argument("--legacy-decode", action="store_true",
                    help="per-token host loop (the eager path the captured "
                         "generate program replaces; for A/B timing)")
    ap.add_argument("--scenario", default=None, choices=scenario_names(),
                    help="cluster-dynamics scenario: serve rounds against a "
                         "drifting true fleet (requires --coded)")
    ap.add_argument("--adapt-every", type=int, default=None,
                    help="closed loop: fold straggler estimates and maybe replan "
                         "the coded head every R rounds (requires --scenario)")
    ap.add_argument("--adapt-threshold", type=float, default=None,
                    help="hysteresis: replan only when the estimated latency "
                         "improves by this fraction (default 0.05)")
    ap.add_argument("--bucket-quantum", type=int, default=None,
                    help="quantize the coded head's integer loads to this multiple: "
                         "replans within the admitted bucket capacity keep the coded "
                         "head (no B3 re-encode)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds to serve under --scenario (default 24)")
    ap.add_argument("--trace", default=None, choices=workload_names(),
                    help="continuous-batching mode: replay this seeded request "
                         "workload through Server.serve instead of one generate")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="requests per decode round for --trace workloads that "
                         "accept it (poisson, chat)")
    ap.add_argument("--num-requests", type=int, default=None,
                    help="trace length for --trace (default: the preset)")
    ap.add_argument("--slots", default="4",
                    help="in-flight stream slots for --trace; 'auto' asks the "
                         "AdaptiveController for a width from the coded fleet's "
                         "round latency (requires --coded)")
    ap.add_argument("--dense-kv", action="store_true",
                    help="serve --trace from dense per-slot KV caches instead "
                         "of the paged block pool")
    ap.add_argument("--block-len", type=int, default=None,
                    help="tokens per physical KV block for paged --trace (default 16)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV block pool size for paged --trace (default: sized "
                         "so the trace never exhausts it)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admission chunk width for paged --trace")
    ap.add_argument("--admission-threshold", type=float, default=1.0,
                    help="admission-control strictness for --trace (higher "
                         "sheds earlier)")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="workload trace seed for --trace")
    ap.add_argument("--measure-times", action="store_true",
                    help="time each dispatch with a RoundClock and adapt from the "
                         "measured wall times instead of simulated ones (requires "
                         "--coded)")
    ap.add_argument("--telemetry", default=None,
                    help="JSONL telemetry sink (request, pool, span, round_timing "
                         "and adapt_decision events; feed it to "
                         "repro_torch.launch.obsreport for the ops report)")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="export the run's spans as Chrome trace_event JSON (open "
                         "in Perfetto / chrome://tracing)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain paths)")
    args = ap.parse_args(argv)
    if args.trace is not None and args.scenario is not None:
        raise SystemExit("--trace and --scenario are separate serving modes; pick one")
    if args.trace is not None and args.legacy_decode:
        raise SystemExit("--trace requires the jit pipeline (continuous batching splices "
                         "into compiled programs); drop --legacy-decode")
    if args.scenario is not None and not args.coded:
        raise SystemExit("--scenario requires --coded (a fleet to perturb)")
    if args.adapt_every is not None and args.scenario is None:
        raise SystemExit("--adapt-every requires --scenario (closed-loop serving is "
                         "driven by a scenario trace)")
    if args.measure_times and not args.coded:
        raise SystemExit("--measure-times requires --coded (round times are decomposed "
                         "over the coded fleet)")
    if args.measure_times and args.legacy_decode:
        raise SystemExit("--measure-times times compiled dispatches; drop --legacy-decode")
    if args.slots == "auto":
        if not args.coded:
            raise SystemExit("--slots auto derives the width from the coded "
                             "fleet's round latency; requires --coded")
    else:
        try:
            args.slots = int(args.slots)
        except ValueError:
            raise SystemExit(f"--slots must be an int or 'auto', "
                             f"got {args.slots!r}") from None

    # a kernel built once is loaded by every later process (build cache)
    enable_persistent_cache()

    config = get_arch(args.arch)
    if args.reduced:
        config = config.reduced()
    model = Model(config, device=args.device, seed=0)
    scheme = make_scheme(args.scheme, n=args.scheme_n, r=args.scheme_r,
                         upload=args.comm_upload, download=args.comm_download)
    cluster = ClusterSpec.parse(args.groups, args.bandwidth) if args.coded else None
    server = Server(model, cluster,
                    ServeConfig(max_decode_steps=args.max_new, scheme=scheme,
                                jit_pipeline=not args.legacy_decode,
                                bucket_quantum=args.bucket_quantum))
    if server.coded_head is not None:
        h = server.coded_head
        print(f"coded LM head [{h.plan.scheme}]: "
              f"kb={h.kb} blocks x {h.block_rows} rows, "
              f"(n,k)=({h.nb},{h.kb}) rate={h.kb / h.nb:.3f}, "
              f"loads/worker={h.plan.loads_per_worker.tolist()}, "
              f"deadline={h.deadline:.4f}")
    if args.trace is not None:
        return _serve_trace(server, args, config)
    prompts = torch.randint(0, config.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    extras = make_extras(config, args.batch, device=model.device)
    if config.family == "audio":
        with torch.no_grad():
            extras = {"enc_out": model.encode(extras["frames"])}
    sync = (lambda: torch.cuda.synchronize(model.device)) \
        if model.device.type == "cuda" else (lambda: None)
    if args.scenario is not None:
        return _serve_scenario(server, prompts, extras, args, cluster, sync)
    tracer = _attach_tracer(server, args)
    sync()
    t0 = time.perf_counter()
    out = server.generate(prompts, args.max_new, extras=extras)
    sync()
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s)")
    print("sample:", out[0, -args.max_new:].tolist())
    _export_chrome(tracer, args)
    return out


def _attach_tracer(server: Server, args, telemetry=None):
    """A ``SpanTracer`` on the server (and its coded executor) when
    ``--chrome-trace`` asks for one; it mirrors spans to ``telemetry``
    when the run has a JSONL sink too."""
    if args.chrome_trace is None:
        return None
    tracer = SpanTracer(telemetry)
    server.tracer = tracer
    if server.coded_head is not None:
        server.coded_head.executor.tracer = tracer
    return tracer


def _export_chrome(tracer, args) -> None:
    if tracer is not None:
        path = tracer.export_chrome(args.chrome_trace)
        print(f"chrome trace: {path} ({len(tracer.spans)} spans)")


def _serve_trace(server: Server, args, config):
    """Continuous-batching mode: replay a seeded workload end to end.

    Latency is reported in rounds (1 decode step = 1 round, 1 batched
    prefill = 1 round), throughput in wall-clock tokens/s.
    """
    wl = make_workload(args.trace, arrival_rate=args.arrival_rate,
                       num_requests=args.num_requests, vocab=config.vocab_size)
    trace = wl.trace(seed=args.trace_seed)
    slots = args.slots
    if slots == "auto":
        # the controller's coverage-latency view of the fleet (the planned
        # latency before any measured round) scales a base of 4 slots
        controller = AdaptiveController(server.coded_head.executor)
        slots = controller.recommend_slots(base=4)
        print(f"slots auto -> {slots} "
              f"(coverage latency {controller.coverage_latency():.4f})")
    with Telemetry(args.telemetry) as tel:
        tracer = _attach_tracer(server, args, telemetry=tel)
        clock = RoundClock(server.coded_head.executor, telemetry=tel) \
            if args.measure_times else None
        try:
            rep = server.serve(trace, slots=slots,
                               admission_threshold=args.admission_threshold,
                               telemetry=tel, clock=clock, tracer=tracer,
                               paged=not args.dense_kv, block_len=args.block_len,
                               num_blocks=args.num_blocks,
                               prefill_chunk=args.prefill_chunk)
        except NotImplementedError as err:  # sliding window or int8 KV: generate only
            raise SystemExit(str(err)) from None
    _export_chrome(tracer, args)
    if clock is not None:
        _print_measured(clock)
    lat = rep.latencies()
    print(f"workload {wl.name!r}: {len(trace)} requests "
          f"(rate={wl.arrival_rate}/round, seed={args.trace_seed})")
    print(f"served {rep.admitted} ({rep.shed} shed), {rep.tokens} tokens "
          f"in {rep.rounds:.0f} rounds "
          f"({rep.prefill_rounds} prefill + {rep.decode_rounds} decode) "
          f"/ {rep.wall_s:.2f}s = {rep.tokens_per_s:.1f} tok/s")
    if len(lat):
        print(f"latency rounds: p50={np.percentile(lat, 50):.1f} "
              f"p99={np.percentile(lat, 99):.1f}")
    return rep


def _print_measured(clock) -> None:
    unit = "-" if clock.unit_s is None else f"{clock.unit_s:.3e}"
    print(f"measured: {clock.fed}/{clock.rounds} rounds fed, unit_s={unit}")


def _serve_scenario(server: Server, prompts, extras, args, cluster, sync):
    """Serve rounds against a drifting true fleet, optionally closed-loop.

    Each round sets the scenario's cluster of that round as the truth the
    finish masks draw from, runs one ``generate`` (seed = the round), and
    with ``--adapt-every`` lets the ``AdaptiveController`` observe one
    round of true times (its own generator, seed 7) and maybe replan.
    With ``--measure-times`` each round runs under a ``RoundClock`` that
    decomposes its measured wall with that generator, and the controller
    observes the timing instead. Returns the controller (None without
    ``--adapt-every``).
    """
    # the scenario is built at the round budget, so its events land inside it
    rounds = args.rounds if args.rounds is not None else 24
    spec = make_scenario(args.scenario, horizon=max(rounds, 1))
    trace = spec.trace(cluster, seed=0)
    head = server.coded_head
    tel = Telemetry(args.telemetry)
    tracer = _attach_tracer(server, args, telemetry=tel)
    controller = None
    if args.adapt_every is not None:
        controller = AdaptiveController(
            head.executor,
            AdaptConfig(every=args.adapt_every,
                        threshold=0.05 if args.adapt_threshold is None
                        else args.adapt_threshold),
            telemetry=tel,
            on_replan=server.refresh_coded_head,
        )
    clock = RoundClock(head.executor, telemetry=tel) if args.measure_times else None
    observe = torch.Generator().manual_seed(7)
    sync()
    t0 = time.perf_counter()
    toks = 0
    for t in range(rounds):
        truth = trace.at(t)
        server.set_true_cluster(truth)
        d = None
        if clock is not None:
            timing = clock.measure(lambda: server.generate(prompts, args.max_new, seed=t,
                                                           extras=extras),
                                   generator=observe, true_cluster=truth)
            out = timing.result
            if controller is not None:
                d = controller.observe_timing(timing)
        else:
            out = server.generate(prompts, args.max_new, seed=t, extras=extras)
            if controller is not None:
                d = controller.observe_truth(observe, truth)
        toks += out.shape[0] * args.max_new
        if d is not None and d.replanned:
            if clock is not None and head.executor.last_replan_structural:
                clock.discard_next()  # the next round pays the B3 re-encode
            print(f"[round {t}] replanned ({d.reason}): "
                  f"deadline -> {head.deadline:.4f}, "
                  f"loads {head.plan.loads_per_worker.tolist()}")
    sync()
    dt = time.perf_counter() - t0
    print(f"scenario {spec.name!r}: {rounds} rounds, {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s)")
    if clock is not None:
        _print_measured(clock)
    if controller is not None:
        replans = [d for d in controller.decisions if d.replanned]
        print(f"controller: {len(controller.decisions)} decisions, "
              f"{len(replans)} replans at rounds {[d.round for d in replans]}")
    _export_chrome(tracer, args)
    tel.close()
    return controller


if __name__ == "__main__":
    main()
