"""Port parity, planner layer: Lambert W, allocation, schemes, planner,
engine and the round executor's deadline and finish masks.

Planning math is float64 on both sides (the reference under
``jax_enable_x64``), so real loads, ``t_star`` and analytic deadlines
agree to 1e-9 relative and every integer quantity exactly. Monte-Carlo
quantities draw different random numbers in the two packages and are
held statistically instead.
"""
import numpy as np
import pytest
import scipy.special
import torch

from repro.core import lambertw as ref_lw
from repro.core.planner import deploy as ref_deploy
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.runtime.executor import CodedRoundExecutor as RefExecutor
from repro_torch.core import lambertw
from repro_torch.core.coding import make_generator
from repro_torch.core.engine import CodedComputeEngine
from repro_torch.core.planner import deploy
from repro_torch.core.runtime_model import ClusterSpec, LatencyModel
from repro_torch.core.schemes import (
    make_scheme,
    register_scheme,
    scheme_for_plan,
    scheme_names,
)
from repro_torch.runtime.executor import CodedRoundExecutor

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

# (num_workers, mus, alphas): the serve fleet, a 3-group mix, one group,
# and the reduced serve tests' fleet
CLUSTERS = [
    ([6, 6], [8.0, 0.7], 1.0),
    ([3, 4, 5], [2.0, 1.0, 0.5], [1.0, 1.5, 0.5]),
    ([10], [1.0], 1.0),
    ([2, 2], [4.0, 0.8], 1.0),
]
SCHEMES = [("optimal", {}), ("optimal_per_row", {}), ("uniform_n", {"n": 1.4})]


def _clusters(i):
    nw, mus, al = CLUSTERS[i]
    return ClusterSpec.make(nw, mus, al), RefCluster.make(nw, mus, al)


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
@pytest.mark.parametrize("name,params", SCHEMES)
def test_plans_match_reference(name, params, ci, k):
    """Real loads / t_star to 1e-9; integer loads, n, row ranges exact."""
    ours, ref = _clusters(ci)
    params = {key: v * k for key, v in params.items()}  # n scales with k
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
    (mus, alphas), (rmus, ralphas, rshifts) = ex.worker_params, rx.worker_params
    np.testing.assert_allclose(mus.numpy(), np.asarray(rmus), rtol=1e-6)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ralphas), rtol=1e-6)
    assert not np.asarray(rshifts).any()  # no transfer terms in these schemes


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
    assert {"optimal", "optimal_per_row", "uniform_n"} <= set(scheme_names())
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


@pytest.mark.parametrize("entry", ["executor", "engine_generator", "make_generator"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, monkeypatch):
    """No device argument means CUDA; with no card that raises, never the CPU."""
    ours, _ = _clusters(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "executor": lambda: CodedRoundExecutor(ours, 64, "optimal"),
        "engine_generator": lambda: CodedComputeEngine(ours, 64).generator(),
        "make_generator": lambda: make_generator(12, 8),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
