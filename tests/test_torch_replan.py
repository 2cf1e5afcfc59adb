"""Port parity, replanning: planner, engine, executor and the fault-
tolerance layer after the same membership change or the same observations.

Planning math is float64 on both sides (the reference under
``jax_enable_x64``): plans, t_star and analytic deadlines agree to 1e-9
relative, integers and slot maps exactly. A deadline with no analytic
form is each package's own Monte Carlo (different random numbers): held
within 5%, as ``tests/test_torch_plan.py`` holds it. The tracker and the
elastic controller are host numpy on both sides, fed the same times:
estimates to 1e-12 relative, failures and decisions exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.engine import CodedComputeEngine as RefEngine
from repro.core.planner import estimate_mu_online as ref_estimate_mu_online
from repro.core.planner import plan_deployment as ref_plan_deployment
from repro.core.planner import replan_on_membership_change as ref_replan
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core.schemes import allocate_cache_clear as ref_cache_clear
from repro.core.schemes import allocate_cache_info as ref_cache_info
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.runtime.executor import CodedRoundExecutor as RefExecutor
from repro.runtime.fault_tolerance import ElasticController as RefElastic
from repro.runtime.fault_tolerance import StragglerTracker as RefTracker
from repro.runtime.fault_tolerance import deadline_for as ref_deadline_for
from repro_torch.core.engine import CodedComputeEngine
from repro_torch.core.planner import (
    estimate_mu_online,
    plan_deployment,
    replan_on_membership_change,
)
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import (
    allocate_cache_clear,
    allocate_cache_info,
    make_scheme,
    scheme_names,
)
from repro_torch.obs.trace import SpanTracer
from repro_torch.runtime.executor import CodedRoundExecutor
from repro_torch.runtime.fault_tolerance import (
    ElasticController,
    StragglerTracker,
    deadline_for,
)

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(11)
K = 1_000
#: tests/test_adaptive.py's fleet: three groups behind finite links
BASE = ([8, 16, 8], [4.0, 1.0, 0.25], 1.0, [16.0, 8.0, 4.0])
#: the same fleet after a leave burst (group 1: 16 -> 10) and a join burst
CHANGES = {"leave": ([8, 10, 8],) + BASE[1:], "join": ([8, 24, 8],) + BASE[1:]}
SCHEMES = [
    ("optimal", {}),
    ("optimal_per_row", {}),
    ("uniform_n", {"n": 1.4 * K}),
    ("uniform_r", {"r": 4}),
    ("uniform_r_group_code", {"r": 2}),
    ("reisizadeh", {}),
    ("uncoded", {}),
    ("grad_coding", {}),
    ("grad_coding_per_row", {}),
    ("comm_aware", {"upload": 1.0, "download": 0.5}),
    ("comm_uniform", {"upload": 0.5, "download": 1.0}),
]


def _pair(args):
    return ClusterSpec.make(*args), RefCluster.make(*args)


def _same_plan(plan, want):
    np.testing.assert_array_equal(plan.loads_per_worker, want.loads_per_worker)
    np.testing.assert_array_equal(plan.group_of_worker, want.group_of_worker)
    assert plan.row_ranges == want.row_ranges and plan.n == want.n
    assert plan.scheme == want.scheme and plan.k == want.k
    np.testing.assert_allclose(plan.allocation.loads, np.asarray(want.allocation.loads),
                               rtol=1e-9)
    if np.isnan(want.t_star):
        assert np.isnan(plan.t_star)
    else:
        np.testing.assert_allclose(plan.t_star, want.t_star, rtol=1e-9)


def _analytic(ex) -> bool:
    alloc = ex.plan.allocation
    live = alloc.loads > 0
    infl = float(np.max(alloc.loads_int[live] / alloc.loads[live], initial=1.0))
    return np.isfinite(ex.plan.t_star) and ex.plan.t_star > 0 \
        and infl <= ex.INTEGERIZATION_SLACK


def test_scheme_list_covers_the_registry():
    assert {name for name, _ in SCHEMES} == set(scheme_names())


@pytest.mark.parametrize("change", ["leave", "join"])
@pytest.mark.parametrize("name,params", SCHEMES)
def test_planner_replan_matches_reference(name, params, change):
    """``replan_on_membership_change``: the plan's scheme, parameters
    included, on the new membership; equal to the reference's."""
    ours, ref = _pair(BASE)
    new, ref_new = _pair(CHANGES[change])
    plan = plan_deployment(ours, K, scheme=make_scheme(name, **params))
    want = ref_plan_deployment(ref, K, scheme=ref_make_scheme(name, **params))
    _same_plan(plan, want)
    replanned = replan_on_membership_change(plan, new)
    _same_plan(replanned, ref_replan(want, ref_new))
    assert replanned.scheme_obj == make_scheme(name, **params)
    assert replanned.num_workers == new.total_workers


@pytest.mark.parametrize("name,params", SCHEMES)
def test_engine_and_executor_replan_match_reference(name, params):
    """Engine and executor replans: scheme objects unchanged, plan, slot
    map and per-worker shifts equal, deadline 1e-9 where analytic."""
    ours, ref = _pair(BASE)
    new, ref_new = _pair(CHANGES["leave"])
    scheme = make_scheme(name, **params)
    eng = CodedComputeEngine(ours, K, scheme)
    ref_eng = RefEngine(ref, K, ref_make_scheme(name, **params))
    assert eng.replans == 0
    _same_plan(eng.replan(new), ref_eng.replan(ref_new))
    assert eng.replans == ref_eng.replans == 1 and eng.scheme == scheme
    assert eng.cluster == new

    ex = CodedRoundExecutor(ours, K, scheme, deadline_safety=1.2, device="cpu")
    rx = RefExecutor(ref, K, ref_make_scheme(name, **params), deadline_safety=1.2)
    ex.replan(new)
    rx.replan(ref_new)
    assert ex.replans == rx.replans == 1 and ex.last_replan_structural
    assert ex.scheme == scheme and ex.plan.scheme_obj == scheme and ex.cluster == new
    _same_plan(ex.plan, rx.plan)
    np.testing.assert_array_equal(ex.slot_owner.numpy(), np.asarray(rx.slot_owner))
    np.testing.assert_array_equal(ex.worker_params[2].numpy(),
                                  np.asarray(rx.worker_params[2]))
    if _analytic(ex):
        np.testing.assert_allclose(ex.deadline, rx.deadline, rtol=1e-9)
    else:
        assert abs(ex.deadline - rx.deadline) / rx.deadline < 0.05


def test_engine_deadline_and_monte_carlo_latency_match_reference():
    """``deadline`` is the analytic 1.5 T* (1e-9); ``simulate`` and
    ``expected_latency`` draw their own numbers: means within 4 standard
    errors of the reference's, before and after a replan."""
    ours, ref = _pair(BASE)
    eng, ref_eng = CodedComputeEngine(ours, K), RefEngine(ref, K)
    for step in range(2):
        np.testing.assert_allclose(eng.deadline(1.5), ref_eng.deadline(1.5), rtol=1e-9)
        got = eng.simulate(torch.Generator().manual_seed(step), 4000).double().numpy()
        want = np.asarray(ref_eng.simulate(jax.random.fold_in(KEY, step), 4000), np.float64)
        se = np.hypot(got.std(), want.std()) / np.sqrt(4000)
        assert abs(got.mean() - want.mean()) <= 4 * se
        mean = eng.expected_latency(torch.Generator().manual_seed(9), 4000)
        assert abs(mean - want.mean()) <= 4 * se
        new, ref_new = _pair(CHANGES["join"])
        eng.replan(new)
        ref_eng.replan(ref_new)


def test_executor_replan_span_and_estimates_update():
    """The replan runs inside a ``replan`` span; ``on_estimates_update``
    replans onto the tracker's estimated cluster."""
    ours, _ = _pair(BASE)
    tracer = SpanTracer()
    ex = CodedRoundExecutor(ours, K, "optimal", device="cpu", tracer=tracer)
    tracker = StragglerTracker(ours)
    tracker._missed[:4] = tracker.fail_after  # four group-0 workers failed
    ex.on_estimates_update(tracker)
    assert ex.replans == 1 and ex.num_workers == ours.total_workers - 4
    assert [s.name for s in tracer.spans] == ["replan"]
    assert tracer.spans[0].attrs == {"structural": True, "workers": ex.num_workers}


@pytest.mark.parametrize("name", ["optimal", "comm_aware"])
@pytest.mark.parametrize("change", ["leave", "join"])
def test_worker_param_arrays_under_churn_match_reference(name, change):
    """The current plan mapped onto a churned true fleet: leavers get an
    infinite shift at the same workers, joiners stay invisible."""
    params = dict(SCHEMES)[name]
    ours, ref = _pair(BASE)
    truth, ref_truth = _pair(CHANGES[change])
    ex = CodedRoundExecutor(ours, K, make_scheme(name, **params), device="cpu")
    rx = RefExecutor(ref, K, ref_make_scheme(name, **params))
    got = ex.worker_param_arrays(truth)
    want = rx.worker_param_arrays(ref_truth)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    dead = np.isinf(got[2].numpy())
    assert got[0].shape == (ours.total_workers,)
    assert dead.sum() == (6 if change == "leave" else 0)
    times, shifts = ex.round_observation(torch.Generator().manual_seed(0), truth)
    ref_times, ref_shifts = rx.round_observation(KEY, ref_truth)
    np.testing.assert_array_equal(np.isinf(times), np.isinf(np.asarray(ref_times)))
    np.testing.assert_array_equal(np.isinf(times), dead)
    np.testing.assert_array_equal(shifts, np.asarray(ref_shifts))
    assert ex.sample_round_times(torch.Generator().manual_seed(0), truth).shape == times.shape


def test_finish_mask_under_true_parameters_never_finishes_leavers():
    ours, _ = _pair(BASE)
    truth, _ = _pair(CHANGES["leave"])
    ex = CodedRoundExecutor(ours, K, "optimal", device="cpu")
    mus, alphas, shifts = ex.worker_param_arrays(truth)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        mask = ex.finish_mask(gen, 1e9, mus=mus, alphas=alphas, shifts=shifts)
        assert not mask[torch.isinf(shifts)].any() and mask[~torch.isinf(shifts)].all()


def _times(seed, w=32, spread=3):
    rng = np.random.default_rng(seed)
    return [rng.exponential(1.0, size=w) + 0.5 for _ in range(spread)]


def test_estimate_mu_online_matches_reference():
    samples = _times(0)
    loads = [80.0, 43.0, 12.0]
    got = estimate_mu_online(samples, 594, loads)
    want = ref_estimate_mu_online(samples, 594, loads)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12)


def test_straggler_tracker_matches_reference_on_the_same_times():
    """Rounds of the same times (a group silent one round, leavers
    timing out thrice) into both trackers: estimates, bandwidths,
    failures and the estimated cluster agree; ``rebind`` resizes both."""
    ours, ref = _pair(BASE)
    tr, rt = StragglerTracker(ours, forget=0.7), RefTracker(ref, forget=0.7)
    loads = CodedRoundExecutor(ours, K, "optimal", device="cpu").plan.loads_per_worker
    rng = np.random.default_rng(3)
    for r in range(6):
        t = rng.exponential(0.05, size=ours.total_workers) + 0.1
        t[-3:] = np.inf  # three workers of the slow group never answer
        if r == 2:
            t[:8] = np.inf  # group 0 silent for one round
        deadline = 0.3 if r % 2 else None
        np.testing.assert_array_equal(tr.observe_round(t, loads, K, deadline),
                                      rt.observe_round(t, loads, K, deadline))
        tt = rng.exponential(0.2, size=ours.total_workers)
        tt[::5] = np.nan
        np.testing.assert_allclose(tr.observe_transfers(tt, 2.0),
                                   rt.observe_transfers(tt, 2.0), rtol=1e-12)
        np.testing.assert_allclose(tr.mu_estimates, rt.mu_estimates, rtol=1e-12)
        np.testing.assert_allclose(tr.alpha_estimates, rt.alpha_estimates, rtol=1e-12)
    np.testing.assert_array_equal(tr.failed_workers, rt.failed_workers)
    assert len(tr.failed_workers) == 3
    est, ref_est = tr.estimated_cluster(), rt.estimated_cluster()
    assert [g.num_workers for g in est.groups] == [g.num_workers for g in ref_est.groups]
    for a, b in zip(est.groups, ref_est.groups):
        np.testing.assert_allclose([a.mu, a.alpha, a.bandwidth],
                                   [b.mu, b.alpha, b.bandwidth], rtol=1e-12)
    tr.rebind(est)
    rt.rebind(ref_est)
    assert tr._missed.shape == rt._missed.shape == (est.total_workers,)
    np.testing.assert_allclose(tr.mu_estimates, rt.mu_estimates, rtol=1e-12)


@pytest.mark.parametrize("threshold", [None, 0.05])
def test_elastic_controller_matches_reference(threshold):
    """Identical tracker feeds into both elastic controllers: the same
    replans, plans and hysteresis decisions (gain 1e-9)."""
    ours, ref = _pair(BASE)
    ec = ElasticController(ours, K, threshold=threshold)
    rc = RefElastic(ref, K, threshold=threshold)
    tr, rt = StragglerTracker(ours, forget=0.5), RefTracker(ref, forget=0.5)
    rng = np.random.default_rng(5)
    loads = ec.plan.loads_per_worker
    for r in range(5):
        scale = np.where(ec.plan.group_of_worker == 0, 1.0 + 4 * r, 1.0)
        t = (rng.exponential(0.05, size=ours.total_workers) + 0.05) * scale
        tr.observe_round(t, loads, K)
        rt.observe_round(t, loads, K)
        _same_plan(ec.on_estimates_update(tr), rc.on_estimates_update(rt))
        assert ec.replans == rc.replans
        if threshold is not None:
            a, b = ec.last_decision, rc.last_decision
            assert (a.replanned, a.reason) == (b.replanned, b.reason)
            np.testing.assert_allclose(a.gain, b.gain, rtol=1e-9)
    assert ec.replans > 0
    new, ref_new = _pair(CHANGES["join"])
    _same_plan(ec.on_membership_change(new), rc.on_membership_change(ref_new))


def test_deadline_for_matches_reference():
    ours, ref = _pair(BASE)
    plan = plan_deployment(ours, K)
    want = ref_plan_deployment(ref, K)
    np.testing.assert_allclose(deadline_for(plan, 1.5), ref_deadline_for(want, 1.5),
                               rtol=1e-9)
    plan = plan_deployment(ours, K, scheme="uniform_n", n=1.4 * K)
    want = ref_plan_deployment(ref, K, scheme="uniform_n", n=1.4 * K)
    got = deadline_for(plan, 1.5, generator=torch.Generator().manual_seed(2))
    assert abs(got - ref_deadline_for(want, 1.5)) / got < 0.05


def test_allocate_cache_counts_hits_and_misses_as_the_reference():
    """The same sequence of allocations: the same hits, misses and size."""
    ours, ref = _pair(BASE)
    new, ref_new = _pair(CHANGES["leave"])
    allocate_cache_clear()
    ref_cache_clear()
    for cluster, ref_cluster in ((ours, ref), (ours, ref), (new, ref_new), (ours, ref)):
        make_scheme("optimal").allocate(cluster, K)
        ref_make_scheme("optimal").allocate(ref_cluster, K)
    got, want = allocate_cache_info(), ref_cache_info()
    assert (got["hits"], got["misses"], got["size"]) == (2, 2, 2)
    assert {k: got[k] for k in ("hits", "misses", "size", "cap")} == \
        {k: want[k] for k in ("hits", "misses", "size", "cap")}


def test_with_bandwidths_matches_reference():
    ours, ref = _pair(BASE)
    for bw in ([1.0, 2.0, 3.0], 5.0):
        a, b = ours.with_bandwidths(bw), ref.with_bandwidths(bw)
        assert [dataclasses.astuple(g) for g in a.groups] == \
            [dataclasses.astuple(g) for g in b.groups]
    with pytest.raises(ValueError):
        ours.with_bandwidths([1.0])
