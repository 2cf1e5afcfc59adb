"""Port parity, closed-loop replanning: scenarios, the adaptive
controller, and the serving hooks it drives.

* every registered scenario over three seeds: ``ClusterTrace.at(t)`` and
  ``change_rounds`` exactly equal (both packages are numpy with the same
  seeded ``default_rng``), and the same parameter refusals;
* ``coverage_latency`` (1e-12 relative: the same float64 bisection) and
  ``replan_decision`` (membership, an exact threshold crossing, the
  replan-cost gate; gains 1e-9);
* ``AdaptiveController`` fed identical time arrays round by round:
  identical decision sequences (gain, current, candidate 1e-9) and
  plans; its ``adapt_decision`` and ``alloc_cache_hit`` events validate
  against the port's ``repro_torch.obs.schema`` registry and the
  reference's; the executor's ``replan`` span nests in ``adapt_update``;
* the serving hooks on reduced qwen3-0.6b: ``CodedLMHead`` after a replan
  with the reference's generator injected (1e-5 coded blocks, 1e-4
  decode), ``generate`` under ``set_true_cluster`` (leavers never
  finish), ``refresh_coded_head`` (B3 re-encode), and ``serve`` admission
  under ``round_latency`` shedding exactly as the reference's;
* measured and bucketed serving: ``serve(clock=)`` paged and dense gives
  the unmeasured streams (and raises without a coded head); a bucketed
  ``CodedLMHead`` runs B3 (its plain version here) only on structural
  replans, and decodes within 1e-4 of the uncoded logits;
* the new entry points default to CUDA and raise without it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.models.model import Model as RefModel
from repro.obs.schema import validate_event as ref_validate_event
from repro.runtime.control import AdaptConfig as RefAdaptConfig
from repro.runtime.control import AdaptiveController as RefController
from repro.runtime.control import coverage_latency as ref_coverage_latency
from repro.runtime.control import replan_decision as ref_replan_decision
from repro.runtime.executor import CodedRoundExecutor as RefExecutor
from repro.runtime.serve_loop import CodedLMHead as RefHead
from repro.runtime.serve_loop import ServeConfig as RefServeConfig
from repro.runtime.serve_loop import Server as RefServer
import repro.serve.workload as ref_wl
from repro.sim import make_scenario as ref_make_scenario
from repro.sim import scenario_kinds as ref_scenario_kinds
from repro.sim import scenario_names as ref_scenario_names
from repro_torch.configs import ARCHS
from repro_torch.core.coded_matvec import end_to_end_coded_matvec
from repro_torch.core.planner import plan_deployment
from repro_torch.core.runtime_model import ClusterSpec, LatencyModel
from repro_torch.core.schemes import make_scheme
import repro_torch.kernels as kernels
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model
from repro_torch.obs.schema import validate_event
from repro_torch.obs.trace import SpanTracer
from repro_torch.runtime.control import (
    AdaptConfig,
    AdaptiveController,
    coverage_latency,
    replan_decision,
)
from repro_torch.runtime import serve_loop
from repro_torch.runtime.executor import CodedRoundExecutor
from repro_torch.runtime.serve_loop import CodedLMHead, ServeConfig, Server
from repro_torch.runtime.timing import RoundClock
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.serve import workload as wl
from repro_torch.sim import (
    BadRack,
    MuRandomWalk,
    MuStep,
    WorkerChurn,
    make_scenario,
    scenario_kinds,
    scenario_names,
)

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
K = 1_000
#: tests/test_adaptive.py's fleet: three groups behind finite links
BASE = ([8, 16, 8], [4.0, 1.0, 0.25], 1.0, [16.0, 8.0, 4.0])
#: PERF.md's serve fleet, the reduced serve tests' fleet
SERVE_FLEET = ([6, 6], [8.0, 0.7])
FLEET = ([2, 2], [4.0, 0.8])


def _pair(args):
    return ClusterSpec.make(*args), RefCluster.make(*args)


def _groups(cluster):
    return [dataclasses.astuple(g) for g in cluster.groups]


# --------------------------------------------------------------- scenarios
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ref_scenario_names())
def test_scenario_traces_equal_reference(name, seed):
    ours, ref = _pair(BASE)
    for horizon in (None, 12):
        tr = make_scenario(name, horizon=horizon).trace(ours, seed=seed)
        want = ref_make_scenario(name, horizon=horizon).trace(ref, seed=seed)
        assert tr.scenario == want.scenario and tr.horizon == want.horizon
        for t in range(-1, tr.horizon + 2):  # the ends clamp
            assert _groups(tr.at(t)) == _groups(want.at(t)), (name, seed, t)
            assert tr.membership(t) == want.membership(t)
        assert tr.change_rounds() == want.change_rounds()


def test_scenario_registry_matches_reference():
    assert scenario_names() == ref_scenario_names()
    assert scenario_kinds() == ref_scenario_kinds()
    for name in scenario_names():
        ours, want = make_scenario(name), ref_make_scenario(name)
        assert (ours.kind, ours.scheme, ours.horizon, ours.description) == \
            (want.kind, want.scheme, want.horizon, want.description)
    for call in (lambda m: m("nope"), lambda m: m("static", sigma=0.1),
                 lambda m: m("churn", frac=1.5), lambda m: m("static", horizon=-3)):
        with pytest.raises(ValueError):
            call(make_scenario)
        with pytest.raises(ValueError):
            call(ref_make_scenario)


def test_event_primitives_validate():
    for bad in (lambda: MuRandomWalk(sigma=-1), lambda: MuStep(at=-1, group=0, factor=1),
                lambda: MuStep(at=0, group=0, factor=0), lambda: WorkerChurn(0, 0, 0.0),
                lambda: BadRack(start=3, end=3), lambda: BadRack(mu_factor=0, end=2)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError, match="out of range"):
        make_scenario("churn", horizon=4).trace(ClusterSpec.make([2], [1.0]))


# ----------------------------------------------------- decision metric
@pytest.mark.parametrize("name", ["optimal", "comm_aware", "uniform_r"])
def test_coverage_latency_matches_reference(name):
    ours, ref = _pair(BASE)
    params = {"comm_aware": {"upload": 1.0, "download": 0.5}, "uniform_r": {"r": 4}}
    p = params.get(name, {})
    sch, rsch = make_scheme(name, **p), ref_make_scheme(name, **p)
    loads = sch.allocate(ours, K).loads
    kw = dict(model=sch.latency_model, upload=p.get("upload", 0.0),
              download=p.get("download", 0.0))
    ref_kw = dict(kw, model=rsch.latency_model)
    got = coverage_latency(ours, loads, K, **kw)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref_coverage_latency(ref, loads, K, **ref_kw),
                               rtol=1e-12)
    assert np.isinf(coverage_latency(ours, [1.0, 1.0, 1.0], K))
    with pytest.raises(ValueError, match="groups"):
        coverage_latency(ours, [1.0, 1.0], K)
    if name == "optimal":
        t_star = sch.allocate(ours, K).t_star
        np.testing.assert_allclose(got, t_star, rtol=1e-5)


def _drifted(cluster, factor=0.05):
    groups = list(cluster.groups)
    groups[0] = dataclasses.replace(groups[0], mu=groups[0].mu * factor)
    return type(cluster)(tuple(groups))


def test_replan_decision_matches_reference():
    """Membership always replans; a gain exactly at the threshold replans,
    one ulp above holds; a replan cost above the amortized saving holds."""
    ours, ref = _pair(BASE)
    ex = CodedRoundExecutor(ours, K, "optimal", device="cpu")
    rx = RefExecutor(ref, K, "optimal")
    sch, rsch = make_scheme("optimal"), ref_make_scheme("optimal")
    shrunk, ref_shrunk = _pair(([8, 10, 8],) + BASE[1:])
    d = replan_decision(sch, ex.plan, shrunk, threshold=1e9)
    assert d.replanned and d.reason == "membership" and np.isnan(d.gain)
    drifted, ref_drifted = _drifted(ours), _drifted(ref)
    probe = replan_decision(sch, ex.plan, drifted, threshold=0.0)
    ref_probe = ref_replan_decision(rsch, rx.plan, ref_drifted, threshold=0.0)
    assert probe.gain > 0
    for f in ("gain", "current", "candidate"):
        np.testing.assert_allclose(getattr(probe, f), getattr(ref_probe, f), rtol=1e-9)
    at = replan_decision(sch, ex.plan, drifted, threshold=probe.gain)
    assert at.replanned and at.reason == "improvement"
    above = replan_decision(sch, ex.plan, drifted, threshold=np.nextafter(probe.gain, 2.0))
    assert not above.replanned and above.reason == "hold"
    saving = (probe.current - probe.candidate) * 10
    for cost, want in ((0.0, True), (saving * 1.01, False)):
        got = replan_decision(sch, ex.plan, drifted, threshold=0.05, replan_cost=cost,
                              horizon=10)
        ref_got = ref_replan_decision(rsch, rx.plan, ref_drifted, threshold=0.05,
                                      replan_cost=cost, horizon=10)
        assert got.replanned == ref_got.replanned == want


# ------------------------------------------------------------- controller
def _replay(name, scheme="optimal", params=None, *, every=2, horizon=12, seed=0,
            telemetry=None, tracer=None):
    """Both controllers fed the same times each round: numpy draws of the
    shifted-exponential model under the round's true fleet, mapped onto
    the current plan's workers by each executor."""
    params = params or {}
    ours, ref = _pair(SERVE_FLEET if name != "bad_rack" else BASE)
    k = 594 if name != "bad_rack" else K
    ex = CodedRoundExecutor(ours, k, make_scheme(scheme, **params), device="cpu",
                            tracer=tracer)
    rx = RefExecutor(ref, k, ref_make_scheme(scheme, **params))
    ctl = AdaptiveController(ex, AdaptConfig(every=every, threshold=0.05),
                             telemetry=telemetry)
    rctl = RefController(rx, RefAdaptConfig(every=every, threshold=0.05))
    trace = make_scenario(name, horizon=horizon).trace(ours, seed=seed)
    ref_trace = ref_make_scenario(name, horizon=horizon).trace(ref, seed=seed)
    rng = np.random.default_rng(seed)
    comm = ex.scheme.latency_model is LatencyModel.COMM_DELAY
    for t in range(horizon):
        mus, alphas, shifts = (a.double().numpy() for a in ex.worker_param_arrays(trace.at(t)))
        rmus, ralphas, rshifts = (np.asarray(a, np.float64)
                                  for a in rx.worker_param_arrays(ref_trace.at(t)))
        np.testing.assert_array_equal(shifts.astype(np.float32), rshifts.astype(np.float32))
        loads = ex.plan.loads_per_worker.astype(float)
        e = rng.exponential(1.0, size=loads.shape)
        times = alphas * loads / k + loads / (k * mus) * e + shifts
        membership = trace.membership(t)
        kw = dict(membership=membership,
                  transfer_times=shifts if comm else None,
                  payload=float(params.get("upload", 1.0)) if comm else 1.0)
        d = ctl.observe_round(times, **kw)
        rd = rctl.observe_round(times, **kw)
        assert (d is None) == (rd is None)
    return ctl, rctl


@pytest.mark.parametrize("name,scheme,params", [
    ("mu_step", "optimal", {}),
    ("churn", "optimal", {}),
    ("mu_drift", "optimal", {}),
    ("bad_rack", "comm_aware", {"upload": 1.0, "download": 0.5}),
])
def test_controller_decisions_equal_reference_on_identical_times(name, scheme, params):
    ctl, rctl = _replay(name, scheme, params)
    assert len(ctl.decisions) == len(rctl.decisions) == 6
    for d, rd in zip(ctl.decisions, rctl.decisions):
        assert (d.round, d.replanned, d.reason) == (rd.round, rd.replanned, rd.reason)
        for f in ("gain", "current", "candidate"):
            a, b = getattr(d, f), getattr(rd, f)
            assert (np.isnan(a) and np.isnan(b)) or np.isclose(a, b, rtol=1e-9, atol=0)
    assert ctl.replans == rctl.replans
    np.testing.assert_array_equal(ctl.plan.loads_per_worker, rctl.plan.loads_per_worker)
    # the analytic deadline where the scheme has one (1e-9), else each
    # package's own Monte Carlo on the integer loads (5%)
    exe = ctl.executor
    alloc = exe.plan.allocation
    live = alloc.loads > 0
    if np.max(alloc.loads_int[live] / alloc.loads[live]) <= exe.INTEGERIZATION_SLACK:
        np.testing.assert_allclose(exe.deadline, rctl.executor.deadline, rtol=1e-9)
    else:
        assert abs(exe.deadline - rctl.executor.deadline) / exe.deadline < 0.05
    np.testing.assert_allclose(ctl.coverage_latency(), rctl.coverage_latency(), rtol=1e-9)
    assert ctl.recommend_slots(base=4) == rctl.recommend_slots(base=4)
    if name == "churn":  # membership replans exactly where the trace changes it
        replans = [(d.round, d.reason) for d in ctl.decisions if d.replanned
                   and d.reason == "membership"]
        assert replans == [(4, "membership"), (10, "membership")]
        assert ctl.plan.num_workers == 12


def test_controller_events_validate_and_spans_nest():
    """Decisions land as ``adapt_decision`` events (and memo hits as
    ``alloc_cache_hit``) that the port's schema and the reference's accept; each
    executor replan is a ``replan`` span inside an ``adapt_update`` span."""
    tracer = SpanTracer()
    with Telemetry() as tel:
        ctl, _ = _replay("churn", telemetry=tel, tracer=tracer)
    names = [e["event"] for e in tel.events]
    assert names.count("adapt_decision") == len(ctl.decisions) == 6
    assert "alloc_cache_hit" in names
    for rec in tel.events:
        validate_event(rec, source=" (port)")
        ref_validate_event(rec, source=" (port)")
    spans = list(tracer.spans)
    replans = [s for s in spans if s.name == "replan"]
    assert len(replans) == ctl.replans > 0
    assert all(s.parent == "adapt_update" and s.depth == 1 for s in replans)
    assert sum(s.name == "adapt_update" for s in spans) == 6


def test_span_tracer_chrome_export_matches_reference(tmp_path):
    """The port's copy of the tracer: nesting, summary and the Chrome
    ``trace_event`` file equal the reference's rendering of the same spans."""
    import json

    from repro.obs.trace import spans_to_chrome as ref_spans_to_chrome

    tracer = SpanTracer()
    with tracer.span("adapt_update", round=2):
        with tracer.span("replan") as sp:
            sp.set(workers=9)
    assert [(s.name, s.depth, s.parent) for s in tracer.spans] == [
        ("replan", 1, "adapt_update"), ("adapt_update", 0, None)]
    assert tracer.spans[0].attrs == {"workers": 9}
    assert {k: v["count"] for k, v in tracer.summary().items()} == {"replan": 1,
                                                                  "adapt_update": 1}
    got = json.loads(open(tracer.export_chrome(str(tmp_path / "ours.json"))).read())
    recs = [{"span": s.name, "t0_s": s.t0_s, "dur_s": s.dur_s, "depth": s.depth,
             "parent": s.parent, "attrs": s.attrs} for s in tracer.spans]
    want = json.loads(open(ref_spans_to_chrome(recs, str(tmp_path / "ref.json"))).read())
    assert got == want and len(got["traceEvents"]) == 2


def test_controller_observe_truth_membership_replans_and_on_replan():
    """``observe_truth`` under ``churn``: membership replans exactly at
    the trace's change rounds (seed-independent), ``on_replan`` after each."""
    ours, _ = _pair(SERVE_FLEET)
    trace = make_scenario("churn", horizon=12).trace(ours, seed=0)
    assert trace.change_rounds() == (3, 8)
    for seed in (0, 1):
        ex = CodedRoundExecutor(ours, 594, "optimal", device="cpu")
        calls = []
        ctl = AdaptiveController(ex, AdaptConfig(every=2, threshold=0.05),
                                 on_replan=lambda: calls.append(ex.n))
        gen = torch.Generator().manual_seed(seed)
        rounds = []
        for t in range(12):
            d = ctl.observe_truth(gen, trace.at(t))
            if d is not None and d.replanned and d.reason == "membership":
                rounds.append((t, ex.num_workers))
        assert rounds == [(3, 9), (9, 12)]
        assert len(calls) == ctl.replans


# ------------------------------------------------------ serving hooks
@pytest.fixture(scope="module")
def models():
    ref = RefModel(REF_ARCHS["qwen3-0.6b"].reduced())
    params = ref.init_params(KEY)
    ours = Model(ARCHS["qwen3-0.6b"].reduced(), device="cpu")
    ours.params_from_jax(jax.tree.map(np.asarray, params))
    return ref, params, ours


def test_coded_head_after_replan_matches_reference(models):
    """Replan both heads onto a shrunk fleet; the port re-encodes with the
    reference's new generator injected: same nb, scatter map, coded blocks
    (1e-5) and decoded logits (1e-4)."""
    _, params, ours = models
    table = np.asarray(params["embed"]["table"])
    big = ([3, 3], [4.0, 0.8])
    ref = RefHead(jnp.asarray(table), RefCluster.make(*big), block_rows=48,
                  deadline_safety=3.0)
    head = CodedLMHead(ours.embed, ClusterSpec.make(*big), block_rows=48,
                       deadline_safety=3.0, g=np.asarray(ref.generator))
    before = kernels.launch_counts()["mds_encode"]
    ref.replan(RefCluster.make([3, 2], [4.0, 0.8]))
    head.replan(ClusterSpec.make([3, 2], [4.0, 0.8]), g=np.asarray(ref.generator))
    assert head.executor.replans == 1 and (head.kb, head.nb) == (ref.kb, ref.nb)
    assert kernels.launch_counts()["mds_encode"] == before  # CPU: the plain version
    np.testing.assert_array_equal(head.block_owner.numpy(), np.asarray(ref.block_owner))
    np.testing.assert_allclose(head.coded.numpy(), np.asarray(ref.coded), rtol=1e-5,
                               atol=1e-5)
    logits = np.random.default_rng(0).standard_normal((2, table.shape[0])).astype(np.float32)
    prod = head.encode_logits(torch.from_numpy(logits))
    want = ref.encode_logits(jnp.asarray(logits))
    mask = np.ones(head.plan.num_workers, bool)
    mask[-1] = False
    got, ok = head.decode_logits(prod, torch.from_numpy(mask))
    want_l, want_ok = ref.decode_logits_jit(want, jnp.asarray(mask))
    assert bool(ok) and bool(want_ok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_l), rtol=1e-4, atol=1e-4)
    # without an injected generator a replan takes the seeded one of the new size
    head.replan(ClusterSpec.make([3, 3], [4.0, 0.8]))
    assert tuple(head.generator.shape) == (head.nb, head.kb)
    with pytest.raises(ValueError, match="shape"):  # one of the wrong size is refused
        head.refresh(g=np.asarray(ref.generator))


def test_generate_under_true_cluster_never_finishes_leavers(models):
    _, _, ours = models
    server = Server(ours, ClusterSpec.make(*SERVE_FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    truth = ClusterSpec.make([6, 3], [8.0, 0.7])
    server.set_true_cluster(truth)
    masks = []
    prompts = np.random.default_rng(0).integers(0, 512, (2, 5))
    server.generate(prompts, 3, observe=lambda step, lg, sel, ok, mask: masks.append(mask))
    assert len(masks) == 3
    for m in masks:
        assert not m[9:].any() and m[:9].all()  # the slow group's last 3 left
    server.set_true_cluster(None)
    masks.clear()
    server.generate(prompts, 2, observe=lambda step, lg, sel, ok, mask: masks.append(mask))
    assert all(bool(m.all()) for m in masks)
    with pytest.raises(ValueError, match="coded head"):
        Server(ours).set_true_cluster(truth)


def test_scenario_loop_replans_and_refreshes_the_head(models):
    """The serving closed loop: ``churn`` truth per round, controller
    observing, ``refresh_coded_head`` on each replan re-encoding the head
    for the new nb; coded tokens equal uncoded ones while rounds decode."""
    _, _, ours = models
    fleet = ClusterSpec.make(*SERVE_FLEET)
    server = Server(ours, fleet, ServeConfig(block_rows=64, deadline_safety=50.0))
    head = server.coded_head
    ctl = AdaptiveController(head.executor, AdaptConfig(every=2, threshold=0.05),
                             on_replan=server.refresh_coded_head)
    trace = make_scenario("churn", horizon=8).trace(fleet, seed=0)
    prompts = np.random.default_rng(1).integers(0, 512, (2, 4))
    plain = Server(ours).generate(prompts, 2)
    gen = torch.Generator().manual_seed(0)
    nbs = []
    for t in range(8):
        server.set_true_cluster(trace.at(t))
        out = server.generate(prompts, 2, seed=t)
        assert torch.equal(out, plain)
        d = ctl.observe_truth(gen, trace.at(t))
        if d is not None and d.replanned:
            assert server._true_params is None  # cleared: the old plan's shape
            nbs.append((head.nb, head.executor.num_workers, tuple(head.coded.shape)))
    assert [w for _, w, _ in nbs if w != 12][:1] == [9]
    assert all(shape[0] == nb for nb, _, shape in nbs)
    with pytest.raises(ValueError, match="coded head"):
        Server(ours).refresh_coded_head()


class _Rising:
    """A round-latency feed that rises with every call (the same in both
    packages when their schedulers call it in the same order)."""

    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return 1.0 + 0.25 * self.calls


@pytest.mark.parametrize("paged", [False, True])
def test_serve_admission_under_round_latency_matches_reference(models, paged):
    ref, params, ours = models
    kw = dict(num_requests=10, prompt_len=(4, 12), out_len=(2, 4), vocab=512)
    serve_kw = dict(slots=2, decode_block=2, queue_cap=4, paged=paged)
    ref_feed, feed = _Rising(), _Rising()
    ref_rep = RefServer(ref, params, RefCluster.make(*FLEET),
                        RefServeConfig(block_rows=64, deadline_safety=50.0)).serve(
        ref_wl.make_workload("overload", **kw).trace(seed=0), key=KEY,
        round_latency=ref_feed, **serve_kw)
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    rep = server.serve(wl.make_workload("overload", **kw).trace(seed=0),
                       round_latency=feed, **serve_kw)
    assert feed.calls == ref_feed.calls > 1
    assert rep.shed == ref_rep.shed > 0 and rep.admitted == ref_rep.admitted
    assert [(f.request.rid, f.outcome, f.reason, f.finish_round) for f in rep.finished] \
        == [(f.request.rid, f.outcome, f.reason, f.finish_round) for f in ref_rep.finished]
    # without the feed the same trace sheds less
    assert server.serve(wl.make_workload("overload", **kw).trace(seed=0),
                        **serve_kw).shed < rep.shed


def test_serve_takes_the_controllers_coverage_latency(models):
    _, _, ours = models
    server = Server(ours, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    ctl = AdaptiveController(server.coded_head.executor)
    calls = []

    def spy():
        calls.append(1)
        return AdaptiveController.coverage_latency(ctl)

    ctl.coverage_latency = spy
    trace = wl.make_workload("poisson", num_requests=3, prompt_len=(4, 8), out_len=(2, 3),
                             vocab=512).trace(seed=0)
    rep = server.serve(trace, controller=ctl, slots=2)
    assert calls and rep.tokens == sum(r.out_len for r in trace)


# --------------------------------------------- measured and bucketed serving
@pytest.mark.parametrize("paged", [True, False])
def test_serve_under_a_clock_gives_the_unmeasured_streams(models, paged):
    """The clock clones the finish-mask generator and never advances it,
    so a measured serve with no controller emits the unmeasured streams;
    every dispatch is measured and all but the warmup one fed."""
    _, _, ours = models
    trace = wl.make_workload("poisson", num_requests=4, prompt_len=(4, 12), out_len=(2, 5),
                             vocab=512).trace(seed=1)
    cfg = ServeConfig(block_rows=64, deadline_safety=1.2)
    kw = dict(slots=2, decode_block=2, paged=paged, prefill_chunk=4)
    plain = Server(ours, ClusterSpec.make(*SERVE_FLEET), cfg).serve(trace, **kw)
    server = Server(ours, ClusterSpec.make(*SERVE_FLEET), cfg)
    tel = Telemetry(None)
    clock = RoundClock(server.coded_head.executor, telemetry=tel)
    rep = server.serve(trace, clock=clock, **kw)
    assert rep.streams == plain.streams and rep.erased_rounds == plain.erased_rounds > 0
    assert clock.rounds >= plain.decode_rounds // 2 and clock.fed == clock.rounds - 1
    assert len([e for e in tel.events if e["event"] == "round_timing"]) == clock.rounds
    with pytest.raises(ValueError, match="coded head"):
        Server(ours).serve(trace, clock=clock, **kw)


def test_bucketed_head_reencodes_only_on_structural_replans(models, monkeypatch):
    """A bucketed head is coded once at n_cap; a bucket switch and a bucket
    hit rebind host views only (no B3), a membership change re-encodes;
    decoded logits stay within 1e-4 of the uncoded ones throughout."""
    _, _, ours = models
    encodes = []
    real = serve_loop.encode
    monkeypatch.setattr(serve_loop, "encode",
                        lambda g, a: encodes.append(tuple(g.shape)) or real(g, a))
    server = Server(ours, ClusterSpec.make(*SERVE_FLEET),
                    ServeConfig(block_rows=16, deadline_safety=1.2, bucket_quantum=2))
    head, exe = server.coded_head, server.coded_head.executor
    assert encodes == [(exe.buckets.n_cap, head.kb)] and head.nb == exe.buckets.n_cap > exe.n
    vocab = ours.config.vocab_size
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, head.table.shape[0])).astype(np.float32))
    logits[:, vocab:] = serve_loop.NEG_INF
    gen = torch.Generator().manual_seed(4)

    def held():
        erased = 0
        for _ in range(24):
            sel, ok, mask = server.coded_select(logits, gen)
            if bool(ok):
                np.testing.assert_allclose(sel[:, :vocab].numpy(), logits[:, :vocab].numpy(),
                                           rtol=1e-4, atol=1e-4)
                erased += int((~mask).sum()) > 0
        return erased

    assert held() > 0
    steps = [([6, 6], [8.0, 0.2]), ([6, 6], [8.0, 0.7]), ([6, 6], [8.0, 0.2])]
    hits = []
    for args in steps:
        exe.replan(ClusterSpec.make(*args))
        server.refresh_coded_head()
        assert not exe.last_replan_structural and len(encodes) == 1
        hits.append(exe.last_bucket_hit)
        assert head.plan is exe.plan and head.deadline == exe.deadline
        held()
    assert hits == [False, True, True]
    exe.replan(ClusterSpec.make([6, 5], [8.0, 0.2]))  # a worker leaves: structural
    server.refresh_coded_head()
    assert exe.last_replan_structural and len(encodes) == 2
    assert head.nb == exe.buckets.n_cap and tuple(head.coded.shape[:1]) == (head.nb,)
    held()


def test_bucketed_head_decode_matches_reference(models):
    """The bucketed head against the reference's with its generator
    injected: the coded blocks and the decode through the bucket's alive
    mask (padding rows dead), 1e-5 and 1e-4."""
    from repro.runtime.plan_bucket import BucketConfig as RefBucketConfig
    from repro.runtime.plan_bucket import select_bucket as ref_select_bucket
    from repro_torch.runtime.plan_bucket import BucketConfig

    _, params, ours = models
    table = np.asarray(params["embed"]["table"])
    ref = RefHead(jnp.asarray(table), RefCluster.make(*SERVE_FLEET), block_rows=48,
                  deadline_safety=3.0, bucket_config=RefBucketConfig(quantum=4))
    head = CodedLMHead(ours.embed, ClusterSpec.make(*SERVE_FLEET), block_rows=48,
                       deadline_safety=3.0, bucket_config=BucketConfig(quantum=4),
                       g=np.asarray(ref.generator))
    assert (head.nb, head.kb) == (ref.nb, ref.kb)
    np.testing.assert_allclose(head.coded.numpy(), np.asarray(ref.coded), rtol=1e-5,
                               atol=1e-5)
    logits = np.random.default_rng(0).standard_normal((2, table.shape[0])).astype(np.float32)
    prod = head.encode_logits(torch.from_numpy(logits))
    mask = np.ones(head.plan.num_workers, bool)
    mask[-1] = False
    alive = head.executor.slot_mask(torch.from_numpy(mask))
    state, index = ref.executor.bucket_args()
    ref_alive = ref.executor.slot_mask_bucket_jit(jnp.asarray(mask),
                                                  ref_select_bucket(state, index))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(ref_alive))
    got, ok = head.decode_logits(prod, torch.from_numpy(mask))
    want, want_ok = ref.decode_logits_bucket_jit(ref.encode_logits(jnp.asarray(logits)),
                                                 ref_alive)
    assert bool(ok) and bool(want_ok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("entry", ["end_to_end", "controller_executor", "cli_scenario"])
def test_new_entry_points_default_to_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ours = ClusterSpec.make(*FLEET)
    plan = plan_deployment(ours, 16)
    call = {
        "end_to_end": lambda: end_to_end_coded_matvec(np.ones((16, 4), np.float32),
                                                      np.ones(4, np.float32), plan),
        "controller_executor": lambda: AdaptiveController(
            CodedRoundExecutor(ours, 16, "optimal")),
        "cli_scenario": lambda: launch_serve.main(
            ["--arch", "qwen3-0.6b", "--reduced", "--coded", "--scenario", "churn",
             "--adapt-every", "2", "--rounds", "2", "--max-new", "1"]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
