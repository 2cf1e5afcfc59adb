"""Port parity, planner layer: Lambert W, allocation, schemes, planner,
engine and the round executor's deadline and finish masks.

Planning math is float64 on both sides (the reference under
``jax_enable_x64``), so real loads, ``t_star`` and analytic deadlines
agree to 1e-9 relative and every integer quantity exactly. Monte-Carlo
quantities draw different random numbers in the two packages and are
held statistically instead.
"""
import dataclasses

import jax
import numpy as np
import pytest
import scipy.special
import torch

from repro.core import lambertw as ref_lw
from repro.core.planner import deploy as ref_deploy
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core import simulator as ref_sim
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.core.schemes import scheme_names as ref_scheme_names
from repro.runtime.executor import CodedRoundExecutor as RefExecutor
from repro_torch.core import lambertw, simulator
from repro_torch.core.coding import make_generator
from repro_torch.core.engine import CodedComputeEngine
from repro_torch.core.planner import deploy
from repro_torch.core.runtime_model import ClusterSpec, LatencyModel
from repro_torch.core.schemes import (
    SCHEME_PARAM_DOC,
    make_scheme,
    register_scheme,
    scheme_for_plan,
    scheme_names,
)
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime.executor import CodedRoundExecutor

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

# (num_workers, mus, alphas[, bandwidths]): the serve fleet, a 3-group mix,
# one group, the reduced serve tests' fleet, and tests/test_comm_aware.py's
# finite-bandwidth fleet (fast compute behind slow links)
CLUSTERS = [
    ([6, 6], [8.0, 0.7], 1.0),
    ([3, 4, 5], [2.0, 1.0, 0.5], [1.0, 1.5, 0.5]),
    ([10], [1.0], 1.0),
    ([2, 2], [4.0, 0.8], 1.0),
    ([40, 80, 40], [4.0, 1.0, 0.5], 1.0, [1.0, 4.0, 16.0]),
]
COMM = 4  # the finite-bandwidth cluster
#: every registered scheme with its parameters for a cluster of N workers
#: and k rows (the code size of uniform_n scales with k)
SCHEMES = [
    ("optimal", lambda nw, k: {}),
    ("optimal_per_row", lambda nw, k: {}),
    ("uniform_n", lambda nw, k: {"n": 1.4 * k}),
    ("uniform_r", lambda nw, k: {"r": nw - 1}),
    ("uniform_r_group_code", lambda nw, k: {"r": max(1, nw // 2)}),
    ("reisizadeh", lambda nw, k: {}),
    ("uncoded", lambda nw, k: {}),
    ("grad_coding", lambda nw, k: {}),
    ("grad_coding_per_row", lambda nw, k: {}),
    ("comm_aware", lambda nw, k: {"upload": 1.0, "download": 0.5}),
    ("comm_uniform", lambda nw, k: {"upload": 0.5, "download": 1.0}),
]
SCHEME_PARAMS = dict(SCHEMES)


def _clusters(i):
    return ClusterSpec.make(*CLUSTERS[i]), RefCluster.make(*CLUSTERS[i])


def test_lambertw_matches_scipy_and_reference():
    z = -np.exp(-np.linspace(1.0001, 60.0, 200))  # the allocation domain
    want = scipy.special.lambertw(z, -1).real
    np.testing.assert_allclose(lambertw.lambertwm1(z), want, rtol=1e-12)
    np.testing.assert_allclose(lambertw.lambertwm1(z),
                               np.asarray(ref_lw.lambertwm1(z)), rtol=1e-13)
    c = np.linspace(1.01, 2000.0, 300)  # alpha * mu + 1 > 1
    np.testing.assert_allclose(lambertw.lambertwm1_neg_exp(c),
                               np.asarray(ref_lw.lambertwm1_neg_exp(c)), rtol=1e-13)
    z0 = np.linspace(-np.exp(-1.0) + 1e-6, 20.0, 200)
    np.testing.assert_allclose(lambertw.lambertw0(z0),
                               scipy.special.lambertw(z0, 0).real, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(lambertw.lambertwm1(-np.exp(-1.0)), -1.0, atol=1e-6)
    assert np.isnan(lambertw.lambertwm1(0.5)) and np.isnan(lambertw.lambertw0(-1.0))


@pytest.mark.parametrize("k", [8, 64, 594])
@pytest.mark.parametrize("ci", range(len(CLUSTERS)))
@pytest.mark.parametrize("name,params", [
    pytest.param(name, fn, id=f"{name}-params{i}") for i, (name, fn) in enumerate(SCHEMES)])
def test_plans_match_reference(name, params, ci, k):
    """Every registered scheme on every cluster: real loads, r, n and
    t_star to 1e-9 relative; integer loads, n, row ranges and tags exact."""
    ours, ref = _clusters(ci)
    params = params(ours.total_workers, k)
    plan = deploy(make_scheme(name, **params), ours, k)
    want = ref_deploy(ref_make_scheme(name, **params), ref, k)
    a, b = plan.allocation, want.allocation
    np.testing.assert_allclose(a.loads, np.asarray(b.loads), rtol=1e-9)
    np.testing.assert_allclose(a.r, np.asarray(b.r), rtol=1e-9)
    np.testing.assert_allclose(a.n, b.n, rtol=1e-9)
    if np.isnan(b.t_star):
        assert np.isnan(a.t_star)
    else:
        np.testing.assert_allclose(a.t_star, b.t_star, rtol=1e-9)
    np.testing.assert_array_equal(a.loads_int, b.loads_int)
    assert a.n_int == b.n_int and plan.n == want.n and a.scheme == b.scheme
    np.testing.assert_array_equal(plan.loads_per_worker, want.loads_per_worker)
    np.testing.assert_array_equal(plan.group_of_worker, want.group_of_worker)
    assert plan.row_ranges == want.row_ranges


@pytest.mark.parametrize("ci,k", [(0, 594), (0, 4096), (1, 594), (2, 1000)])
def test_executor_analytic_deadline_and_slot_owner(ci, k):
    """Where integerization is benign the deadline is analytic: 1e-9."""
    ours, ref = _clusters(ci)
    ex = CodedRoundExecutor(ours, k, "optimal", deadline_safety=1.2, device="cpu")
    rx = RefExecutor(ref, k, "optimal", deadline_safety=1.2)
    alloc = ex.plan.allocation
    assert np.max(alloc.loads_int / alloc.loads) <= ex.INTEGERIZATION_SLACK
    np.testing.assert_allclose(ex.deadline, rx.deadline, rtol=1e-9)
    np.testing.assert_array_equal(ex.slot_owner.numpy(), np.asarray(rx.slot_owner))
    (mus, alphas, shifts), (rmus, ralphas, rshifts) = ex.worker_params, rx.worker_params
    np.testing.assert_allclose(mus.numpy(), np.asarray(rmus), rtol=1e-6)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ralphas), rtol=1e-6)
    np.testing.assert_array_equal(shifts.numpy(), np.asarray(rshifts))
    assert not shifts.numpy().any()  # no transfer terms on these free links


def test_full_width_serve_plan():
    """kb = 594 on the serve fleet: nb = 738, deadline 1.2 T* (analytic)."""
    ex = CodedRoundExecutor(*_clusters(0)[:1], 594, "optimal", deadline_safety=1.2,
                            device="cpu")
    assert ex.n == 738 and ex.num_workers == 12
    np.testing.assert_allclose(ex.deadline, 1.2 * ex.plan.t_star, rtol=1e-12)


def test_monte_carlo_deadline_within_standard_error():
    """kb = 8 inflates loads 1.48x: both sides Monte-Carlo the integer
    loads (2048 trials, different random numbers). Held to 4 standard
    errors of the difference of two independent means."""
    ours, ref = _clusters(3)
    k, safety = 8, 1.0
    ex = CodedRoundExecutor(ours, k, "optimal", deadline_safety=safety,
                            device="cpu")
    rx = RefExecutor(ref, k, "optimal", deadline_safety=safety)
    alloc = ex.plan.allocation
    assert np.max(alloc.loads_int / alloc.loads) > ex.INTEGERIZATION_SLACK
    samples = ex.scheme.simulate(torch.Generator().manual_seed(7), ours, alloc,
                                 2048, use_integer_loads=True)
    se = float(samples.std()) / np.sqrt(2048)
    assert abs(ex.deadline - rx.deadline) <= 4 * np.sqrt(2) * se * safety
    assert abs(ex.deadline - rx.deadline) / rx.deadline < 0.05


def test_finish_mask_survival_matches_analytic_cdf():
    """Per-worker P(T <= deadline) over 4000 draws vs the shifted-exp
    CDF F_j(d) = 1 - exp(-(k mu / l)(d - alpha l / k)), within 4 sigma."""
    ours, _ = _clusters(0)
    k, draws = 594, 4000
    ex = CodedRoundExecutor(ours, k, "optimal", deadline_safety=1.2, device="cpu")
    gen = torch.Generator().manual_seed(3)
    hits = sum(ex.finish_mask(gen).to(torch.int64) for _ in range(draws)).numpy()
    rate = hits / draws
    l = ex.plan.loads_per_worker.astype(float)
    mu = np.asarray([ours.groups[j].mu for j in ex.plan.group_of_worker])
    al = np.asarray([ours.groups[j].alpha for j in ex.plan.group_of_worker])
    d = ex.deadline
    p = np.where(d > al * l / k, 1 - np.exp(-(k * mu / l) * (d - al * l / k)), 0.0)
    sigma = np.sqrt(p * (1 - p) / draws)
    assert np.all(np.abs(rate - p) <= 4 * sigma + 1e-12), (rate, p)
    assert np.any(p < 0.99)  # the deadline does erase workers here
    mask = ex.finish_mask(gen)
    np.testing.assert_array_equal(ex.slot_mask(mask).numpy(),
                                  mask.numpy()[ex.slot_owner.numpy()])


def test_scheme_registry_rejects_unknown_params():
    assert set(scheme_names()) == set(ref_scheme_names()) == set(SCHEME_PARAMS)
    with pytest.raises(ValueError, match="does not accept"):
        make_scheme("optimal", r=3)
    with pytest.raises(ValueError, match="does not accept"):
        make_scheme("uniform_n", n=10.0, strength=2)
    with pytest.raises(ValueError, match="requires the code size"):
        make_scheme("uniform_n")
    with pytest.raises(ValueError, match="unknown scheme"):
        make_scheme("nope")
    with pytest.raises(ValueError, match="fixed to MODEL_30"):
        make_scheme("optimal_per_row", model=LatencyModel.MODEL_1)
    with pytest.raises(ValueError, match="already registered"):
        register_scheme("optimal", lambda: None)
    assert make_scheme("optimal", per_row=None).model is LatencyModel.MODEL_1


def test_scheme_for_plan_and_memo_copies():
    ours, _ = _clusters(1)
    plan = deploy(make_scheme("uniform_n", n=100), ours, 64)
    assert scheme_for_plan(plan) == make_scheme("uniform_n", n=100)
    a = make_scheme("optimal").allocate(ours, 64)
    a.loads[:] = -1  # a caller mutating its copy must not corrupt the memo
    b = make_scheme("optimal").allocate(ours, 64)
    assert np.all(b.loads > 0)


def test_cluster_parse_matches_reference():
    for spec in ("6:8.0,6:0.7", "3:2.0:8.0,4:1.0", "1:0.5"):
        ours, ref = ClusterSpec.parse(spec), RefCluster.parse(spec)
        assert [(g.num_workers, g.mu, g.alpha, g.bandwidth) for g in ours.groups] == [
            (g.num_workers, g.mu, g.alpha, g.bandwidth) for g in ref.groups
        ]
    for bad in ("6", "x:1.0", "0:1.0", "2:-1", "2:1.0:0"):
        with pytest.raises(ValueError):
            ClusterSpec.parse(bad)


def test_deadline_for_scheme_without_analytic_t_star():
    """uniform_n has NaN T*: the deadline falls back to Monte Carlo."""
    ours, ref = _clusters(0)
    ex = CodedRoundExecutor(ours, 594, "uniform_n", scheme_params={"n": 738},
                            device="cpu")
    rx = RefExecutor(ref, 594, "uniform_n", scheme_params={"n": 738})
    assert np.isfinite(ex.deadline)
    assert abs(ex.deadline - rx.deadline) / rx.deadline < 0.05


@pytest.mark.parametrize("entry", ["executor", "engine_generator", "make_generator",
                                   "launch_serve"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, monkeypatch):
    """No device argument means CUDA; with no card that raises, never the CPU."""
    ours, _ = _clusters(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "executor": lambda: CodedRoundExecutor(ours, 64, "optimal"),
        "engine_generator": lambda: CodedComputeEngine(ours, 64).generator(),
        "make_generator": lambda: make_generator(12, 8),
        "launch_serve": lambda: launch_serve.main(
            ["--arch", "qwen3-0.6b", "--reduced", "--coded", "--max-new", "1"]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_scheme_param_doc_matches_reference():
    from repro.core.schemes import SCHEME_PARAM_DOC as REF_DOC

    assert dict(SCHEME_PARAM_DOC) == dict(REF_DOC)
    assert set(SCHEME_PARAM_DOC) <= set(scheme_names())


@pytest.mark.parametrize("name,params", [
    ("uniform_r", {"r": 7}),
    ("comm_uniform", {"n": 900.0, "upload": 0.5, "download": 1.0}),
])
def test_scheme_for_plan_rebuilds_from_plan_fields(name, params):
    """A plan that lost its scheme object is rebuilt from its tag and
    fields: r = k / load for the group code, n for comm_uniform (whose
    transfer costs are not on the plan and take their defaults)."""
    ours, _ = _clusters(1)
    alloc = make_scheme(name, **params).allocate(ours, 594)
    bare = dataclasses.replace(alloc, scheme_obj=None)
    want = {"uniform_r": make_scheme("uniform_r", r=7),
            "comm_uniform": make_scheme("comm_uniform", n=900.0)}[name]
    assert scheme_for_plan(bare) == want


def _mean_se(samples) -> tuple[float, float]:
    x = np.asarray(samples, np.float64)
    return float(x.mean()), float(x.std() / np.sqrt(x.size))


def _close_in_se(ours, ref) -> None:
    """Two independent Monte-Carlo means within 4 standard errors of their
    difference (the packages draw different random numbers)."""
    (m1, s1), (m2, s2) = _mean_se(ours), _mean_se(ref)
    assert abs(m1 - m2) <= 4 * np.hypot(s1, s2), (m1, m2, s1, s2)


TRIALS = 4000


@pytest.mark.parametrize("ci,r", [(0, 10), (1, 6), (3, 3)])
def test_simulate_group_code_matches_reference(ci, r):
    ours, ref = _clusters(ci)
    k = 594
    plan = make_scheme("uniform_r", r=r).allocate(ours, k)
    got = simulator.simulate_group_code(torch.Generator().manual_seed(ci), ours,
                                        float(plan.loads[0]), plan.r, k, TRIALS)
    want = ref_sim.simulate_group_code(jax.random.PRNGKey(ci), ref, float(plan.loads[0]),
                                       plan.r, k, TRIALS)
    _close_in_se(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ci", [0, COMM])
def test_simulate_comm_threshold_matches_reference(ci):
    ours, ref = _clusters(ci)
    k, up, down = 594, 1.0, 0.5
    plan = make_scheme("comm_aware", upload=up, download=down).allocate(ours, k)
    got = simulator.simulate_comm_threshold(torch.Generator().manual_seed(1), ours,
                                            plan.loads, k, TRIALS, upload=up,
                                            download=down)
    want = ref_sim.simulate_comm_threshold(jax.random.PRNGKey(1), ref, plan.loads, k,
                                           TRIALS, upload=up, download=down)
    _close_in_se(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("name", ["reisizadeh", "uncoded", "uniform_r", "comm_uniform"])
def test_expected_latency_matches_reference(name):
    """``expected_latency`` dispatches on the plan's scheme (the group
    code's order statistics, the comm shifts, the per-row model)."""
    ci = COMM if name.startswith("comm") else 1
    ours, ref = _clusters(ci)
    k = 594
    params = SCHEME_PARAMS[name](ours.total_workers, k)
    plan = make_scheme(name, **params).allocate(ours, k)
    rplan = ref_make_scheme(name, **params).allocate(ref, k)
    got = simulator.expected_latency(torch.Generator().manual_seed(2), ours, plan, TRIALS)
    want = ref_sim.expected_latency(jax.random.PRNGKey(2), ref, rplan, TRIALS)
    samples = plan.scheme_obj.simulate(torch.Generator().manual_seed(3), ours, plan,
                                       TRIALS).numpy()
    se = float(samples.std() / np.sqrt(TRIALS))
    assert abs(got - want) <= 4 * np.sqrt(2) * se, (got, want, se)


@pytest.mark.parametrize("name", ["comm_aware", "comm_uniform"])
def test_comm_executor_deadline_and_shifts_match_reference(name):
    """The comm schemes' per-worker transfer shifts exactly, their alphas
    to f32; comm_aware's deadline is analytic (1e-9), comm_uniform's is
    the scheme's Monte Carlo (4 standard errors)."""
    ours, ref = _clusters(COMM)
    k, safety, kw = 594, 1.2, {"upload": 1.0, "download": 0.5}
    ex = CodedRoundExecutor(ours, k, name, scheme_params=kw, deadline_safety=safety,
                            device="cpu")
    rx = RefExecutor(ref, k, name, scheme_params=kw, deadline_safety=safety)
    (mus, alphas, shifts), (rmus, ralphas, rshifts) = ex.worker_params, rx.worker_params
    np.testing.assert_array_equal(shifts.numpy(), np.asarray(rshifts))
    assert shifts.numpy().any()
    np.testing.assert_allclose(mus.numpy(), np.asarray(rmus), rtol=1e-6)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ralphas), rtol=1e-6)
    np.testing.assert_array_equal(ex.slot_owner.numpy(), np.asarray(rx.slot_owner))
    if name == "comm_aware":
        np.testing.assert_allclose(ex.deadline, rx.deadline, rtol=1e-9)
        return
    samples = ex.scheme.simulate(torch.Generator().manual_seed(0), ours,
                                 ex.plan.allocation, 2048)
    se = float(samples.std()) / np.sqrt(2048)
    assert abs(ex.deadline - rx.deadline) <= 4 * np.sqrt(2) * se * safety


def test_comm_finish_mask_survival_matches_shifted_cdf():
    """Per-worker P(T <= d) over 4000 draws against the comm-shifted CDF
    F(d) = 1 - exp(-(k mu / l)(d - c - alpha' l / k)), alpha' = alpha +
    download / b, c = upload / b, within 4 sigma; a zero-load worker
    finishes at its shift."""
    ours, _ = _clusters(COMM)
    k, draws = 594, 4000
    ex = CodedRoundExecutor(ours, k, "comm_aware", deadline_safety=1.2, device="cpu",
                            scheme_params={"upload": 1.0, "download": 0.5})
    gen = torch.Generator().manual_seed(4)
    hits = sum(ex.finish_mask(gen).to(torch.int64) for _ in range(draws)).numpy()
    rate = hits / draws
    mus, alphas, shifts = (t.double().numpy() for t in ex.worker_params)
    l = ex.plan.loads_per_worker.astype(float)
    d = ex.deadline
    start = shifts + alphas * l / k
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(l > 0, 1 - np.exp(-(k * mus / l) * np.maximum(d - start, 0.0)),
                     (shifts <= d).astype(float))
    sigma = np.sqrt(p * (1 - p) / draws)
    assert np.all(np.abs(rate - p) <= 4 * sigma + 1e-12), (rate, p)
    assert np.any((p > 0.01) & (p < 0.99))  # the deadline does erase workers
