"""Port parity, the reference's last public names: ``AllocationScheme``'s
``lower_bound`` and ``replan``, ``ClusterSpec.scale_mu``,
``coding.split_loads``, the metrics' ``merge``, ``ModelConfig.has_decode``,
and the paper's Section IV Monte Carlo at a small Fig. 4 setting.

Twins of the reference's own tests (``tests/test_coding.py``'s
``split_loads``, ``tests/test_obs.py``'s merges,
``tests/test_scheme_invariants.py``'s ``expected_latency >= lower_bound``)
run on the port, and each name is held against the reference on the same
inputs: planning math to 1e-9 relative (NaN where the reference gives
NaN), Monte-Carlo means within 4 standard errors of their difference (the
packages draw different random numbers). Last, the two packages' public
names are compared: what the port lacks is exactly ``LEFT_OUT``, each
with the counterpart or the reason.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.coding import split_loads as ref_split_loads
from repro.core.engine import CodedComputeEngine as RefEngine
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core.schemes import Optimal as RefOptimal
from repro.core.schemes import Uncoded as RefUncoded
from repro.core.schemes import UniformN as RefUniformN
from repro.core.schemes import UniformR as RefUniformR
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.obs import metrics as ref_metrics
from repro_torch.configs import ARCHS
from repro_torch.core.coding import split_loads
from repro_torch.core.engine import CodedComputeEngine
from repro_torch.core.planner import plan_deployment
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import Optimal, Uncoded, UniformN, UniformR, make_scheme
from repro_torch.obs import metrics as port_metrics
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from test_torch_plan import CLUSTERS, SCHEMES, _clusters

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
K = 512
#: tests/test_scheme_invariants.py's cluster behind finite links
COMM_FLEET = ([6, 10, 8], [4.0, 1.0, 0.4], 1.0, [8.0, 2.0, 0.5])


def _rel_or_nan(got: float, want: float) -> None:
    if np.isnan(want):
        assert np.isnan(got), (got, want)
    else:
        assert got == pytest.approx(want, rel=1e-9, abs=0), (got, want)


@pytest.mark.parametrize("ci", range(len(CLUSTERS)))
@pytest.mark.parametrize("name,params", SCHEMES, ids=[s[0] for s in SCHEMES])
def test_lower_bound_matches_reference(name, params, ci):
    ours, ref = _clusters(ci)
    nw = ours.total_workers
    for k in (64, K):
        p = params(nw, k)
        got = make_scheme(name, **p).lower_bound(ours, k)
        want = ref_make_scheme(name, **p).lower_bound(ref, k)
        _rel_or_nan(got, want)
        assert isinstance(got, float)


@pytest.mark.parametrize("name,params", SCHEMES, ids=[s[0] for s in SCHEMES])
def test_expected_latency_dominates_lower_bound(name, params):
    """MC mean >= the scheme's analytic bound (3% MC slack), as the
    reference's invariant; a scheme with no bound (NaN) has none in the
    reference either."""
    cluster = ClusterSpec.make(*COMM_FLEET)
    scheme = make_scheme(name, **params(cluster.total_workers, K))
    bound = scheme.lower_bound(cluster, K)
    ref_bound = ref_make_scheme(name, **params(cluster.total_workers, K)).lower_bound(
        RefCluster.make(*COMM_FLEET), K)
    _rel_or_nan(bound, ref_bound)
    lat = scheme.expected_latency(torch.Generator().manual_seed(7), cluster,
                                  scheme.allocate(cluster, K), num_trials=4000)
    assert np.isfinite(lat)
    if np.isfinite(bound):
        assert lat >= bound * (1 - 0.03), (name, lat, bound)


@pytest.mark.parametrize("q", [0.01, 0.5, 1.0, 3.0, 100.0])
@pytest.mark.parametrize("ci", range(len(CLUSTERS)))
def test_scale_mu_matches_reference(ci, q):
    ours, ref = _clusters(ci)
    got, want = ours.scale_mu(q), ref.scale_mu(q)
    assert isinstance(got, ClusterSpec) and got.num_groups == want.num_groups
    for g, w, orig in zip(got.groups, want.groups, ours.groups):
        assert (g.num_workers, g.alpha, g.bandwidth) == (w.num_workers, w.alpha, w.bandwidth)
        assert (g.num_workers, g.alpha, g.bandwidth) == (orig.num_workers, orig.alpha,
                                                         orig.bandwidth)
        assert g.mu == w.mu == orig.mu * q
    _rel_or_nan(Optimal().lower_bound(got, K), RefOptimal().lower_bound(want, K))


def test_fig2_n_times_t_star_through_scale_mu():
    """benchmarks/fig2.py on the port: N T* decreasing in q, the frozen
    value at q 1 (tests/test_fig_golden.py), invariant over N scales."""
    base = ClusterSpec.make([1000, 2000, 3000], [2.0, 1.0, 0.5], 1.0)
    qs = np.logspace(-2, 2, 17)
    vals = [base.total_workers * Optimal().lower_bound(base.scale_mu(float(q)), 10_000)
            for q in qs]
    assert all(a > b for a, b in zip(vals, vals[1:]))
    assert vals[8] == pytest.approx(3.4968381270239273, rel=1e-9)
    scales = [ClusterSpec.make([1000 * s, 2000 * s, 3000 * s], [2.0, 1.0, 0.5], 1.0)
              for s in (1, 2, 4)]
    inv = [c.total_workers * Optimal().lower_bound(c, 10_000) for c in scales]
    np.testing.assert_allclose(inv, inv[0], rtol=1e-9)


@pytest.mark.parametrize("name,params", SCHEMES, ids=[s[0] for s in SCHEMES])
def test_replan_matches_reference_and_keeps_params(name, params):
    """``replan`` on a new membership is ``allocate`` there, the scheme
    object and its parameters kept; its plan is the reference's."""
    old, new = ClusterSpec.make([4, 8], [4.0, 1.0], 1.0), ClusterSpec.make([4, 4], [4.0, 1.0])
    ref_new = RefCluster.make([4, 4], [4.0, 1.0])
    p = params(new.total_workers, K)  # valid on both fleets
    scheme = make_scheme(name, **p)
    scheme.allocate(old, K)
    plan = scheme.replan(new, K)
    assert plan.scheme_obj is scheme and plan.scheme == scheme.tag
    assert dataclasses.asdict(plan.scheme_obj) == dataclasses.asdict(scheme)
    want = ref_make_scheme(name, **p).replan(ref_new, K)
    np.testing.assert_allclose(plan.loads, np.asarray(want.loads), rtol=1e-9)
    np.testing.assert_array_equal(plan.loads_int, np.asarray(want.loads_int))
    assert plan.n_int == want.n_int
    _rel_or_nan(float(plan.t_star), float(want.t_star))


def test_split_loads():
    assert split_loads([3, 2, 4]) == [(0, 3), (3, 5), (5, 9)]


@pytest.mark.parametrize("ci", range(len(CLUSTERS)))
def test_split_loads_matches_reference_and_the_planner(ci):
    plan = plan_deployment(ClusterSpec.make(*CLUSTERS[ci]), K)
    got = split_loads(plan.loads_per_worker)
    assert got == ref_split_loads(plan.loads_per_worker) == list(plan.row_ranges)
    assert all(type(v) is int for pair in got for v in pair)


def test_counter_is_monotonic_and_merges():
    c = Counter()
    assert c.inc() == 1 and c.inc(4) == 5
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)
    other = Counter()
    other.inc(2)
    c.merge(other)
    assert c.value == 7
    c.reset()
    assert c.value == 0


def test_gauge_last_writer_wins():
    g = Gauge()
    g.set(3)
    other = Gauge()
    other.set(9.5)
    g.merge(other)
    assert g.value == 9.5


def test_histogram_merge_requires_equal_bounds():
    a, b = Histogram(bounds=(1.0, 2.0)), Histogram(bounds=(1.0, 2.0))
    a.observe(0.5)
    b.observe(3.0)
    a.merge(b)
    assert a.count == 2 and a.min == 0.5 and a.max == 3.0
    with pytest.raises(ValueError, match="different bounds"):
        a.merge(Histogram(bounds=(1.0, 3.0)))
    with pytest.raises(ValueError, match="ascending"):
        Histogram(bounds=(2.0, 1.0))


def test_registry_merge_folds_counts():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("tokens_emitted").inc(1)
    b.counter("tokens_emitted").inc(2)
    b.counter("requests_admitted").inc(5)
    a.merge(b)
    assert a.counter("tokens_emitted").value == 3
    assert a.counter("requests_admitted").value == 5


def _fill(mod, seed: int):
    """A registry of the module ``mod`` with every metric type, seeded."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    reg.counter("tokens_emitted").inc(int(rng.integers(1, 50)))
    reg.counter("requests_shed", reason="queue_full").inc(int(rng.integers(0, 5)))
    reg.gauge("queue_depth").set(float(rng.integers(0, 9)))
    h = reg.histogram("request_latency", deadline_class="strict")
    for v in rng.exponential(8.0, size=int(rng.integers(0, 40))):
        h.observe(float(v))
    reg.histogram("other_latency", bounds=(1.0, 10.0)).observe(float(rng.uniform(0, 20)))
    return reg


def test_merged_registries_snapshot_as_the_reference():
    """Three per-host registries folded into one: the same snapshot in both
    packages, and a merge of unequal histogram bounds refused with the
    reference's message."""
    ours, ref = _fill(port_metrics, 0), _fill(ref_metrics, 0)
    for seed in (1, 2):
        ours.merge(_fill(port_metrics, seed))
        ref.merge(_fill(ref_metrics, seed))
    assert ours.snapshot() == ref.snapshot()
    bad_ours, bad_ref = MetricsRegistry(), ref_metrics.MetricsRegistry()
    bad_ours.histogram("other_latency", bounds=(2.0, 10.0))
    bad_ref.histogram("other_latency", bounds=(2.0, 10.0))
    with pytest.raises(ValueError) as got:
        ours.merge(bad_ours)
    with pytest.raises(ValueError) as want:
        ref.merge(bad_ref)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_has_decode_matches_reference(arch):
    assert ARCHS[arch].has_decode is REF_ARCHS[arch].has_decode is True
    assert ARCHS[arch].reduced().has_decode is REF_ARCHS[arch].reduced().has_decode


def test_every_config_has_decode():
    assert sorted(ARCHS) == sorted(REF_ARCHS) and len(ARCHS) == 10


FIG4_K, FIG4_TRIALS = 2_000, 4_000


def _fig4(n_total: int, cls):
    parts = [p * n_total // 25 for p in (3, 4, 5, 6, 7)]
    return cls.make(parts, [16.0, 12.0, 8.0, 4.0, 1.0], 1.0)


@pytest.mark.parametrize("n_total", [50, 100])
@pytest.mark.parametrize("scheme", ["proposed", "uniform_n*", "uniform_2k", "uncoded",
                                    "group_r10"])
def test_fig4_monte_carlo_matches_reference(n_total, scheme):
    """benchmarks/fig4.py at a small setting (k 2,000, r 10, 4,000 trials):
    each scheme's samples through the engine, port against reference
    within 4 standard errors; T* to 1e-9."""
    ours, ref = _fig4(n_total, ClusterSpec), _fig4(n_total, RefCluster)
    opt, ref_opt = CodedComputeEngine(ours, FIG4_K, Optimal()), RefEngine(ref, FIG4_K,
                                                                           RefOptimal())
    assert opt.t_star == pytest.approx(ref_opt.t_star, rel=1e-9)
    n_star = opt.allocation.n
    pick = {"proposed": (Optimal(), RefOptimal()),
            "uniform_n*": (UniformN(n=n_star), RefUniformN(n=n_star)),
            "uniform_2k": (UniformN(n=2.0 * FIG4_K), RefUniformN(n=2.0 * FIG4_K)),
            "uncoded": (Uncoded(), RefUncoded()),
            "group_r10": (UniformR(r=10), RefUniformR(r=10))}[scheme]
    got = CodedComputeEngine(ours, FIG4_K, pick[0]).simulate(
        torch.Generator().manual_seed(n_total), FIG4_TRIALS).numpy()
    want = np.asarray(RefEngine(ref, FIG4_K, pick[1]).simulate(
        jax.random.PRNGKey(n_total), FIG4_TRIALS))
    (m1, s1), (m2, s2) = ((x.mean(), x.std() / np.sqrt(x.size)) for x in (got, want))
    assert abs(m1 - m2) <= 4 * np.hypot(s1, s2), (m1, m2, s1, s2)
    if scheme == "proposed":
        assert m1 >= 0.95 * opt.t_star


#: the reference's public names the port has no twin of, each with its
#: counterpart in the port or the reason it has none
LEFT_OUT = {
    # the fused allocation fast path: measured slower than the numpy solvers
    "core/alloc_fastpath.py": {"comm_core", "group_split_core", "optimal_core",
                               "reisizadeh_core"},
    "core/allocation.py": {"eager_oracle", "fastpath_enabled", "set_fastpath"},
    # jit entry points: the port's functions of the same name without _jit
    "core/coding.py": {"decode_systematic_jit"},
    "core/gradient_coding.py": {"decode_vector_jit"},
    "runtime/executor.py": {
        "CodedRoundExecutor.finish_mask_bucket_jit", "CodedRoundExecutor.finish_mask_jit",
        "CodedRoundExecutor.round_times_bucket_jit", "CodedRoundExecutor.round_times_jit",
        "CodedRoundExecutor.sample_finish_mask", "CodedRoundExecutor.slot_mask_bucket_jit",
        "CodedRoundExecutor.slot_mask_jit"},
    "runtime/serve_loop.py": {
        "CodedLMHead.decode_logits_bucket_jit", "CodedLMHead.decode_logits_jit",
        "CodedLMHead.finish_mask_jit", "CodedLMHead.sample_finish_mask"},
    # Pallas kernels and their references: csrc/ and the plain paths
    "kernels/coded_matvec/kernel.py": {"matvec_kernel"},
    "kernels/coded_matvec/ref.py": {"matvec_batch_ref", "matvec_ref"},
    "kernels/fused_ce/kernel.py": {"fused_ce_kernel"},
    "kernels/fused_ce/ops.py": {"fused_linear_ce"},
    "kernels/fused_ce/ref.py": {"linear_ce_ref"},
    "kernels/mds_encode/kernel.py": {"encode_kernel"},
    "kernels/mds_encode/ref.py": {"encode_ref"},
    "kernels/paged_attention/kernel.py": {"paged_decode_kernel"},
    "kernels/paged_attention/ref.py": {"gather_ref", "paged_chunk_attend_ref",
                                       "paged_decode_attend_ref", "valid_ref"},
    # XLA HLO text parsing
    "launch/dryrun.py": {"collective_bytes"},
    # the free-function model API: the nn.Module holds the parameters
    "models/attention.py": {"init_attention"},
    "models/layers.py": {"init_embedding", "init_layernorm", "init_linear", "init_mlp",
                         "init_rmsnorm", "linear"},
    "models/model.py": {"Model.init_params", "decode_step", "init_cache", "init_params",
                        "lm_logits", "loss_fn"},
    # a jitted step builder: Trainer builds its step
    "runtime/train_loop.py": {"make_train_step"},
    # golden-summary diffs: nothing in the port read them; the benchmark
    # compares runs and the stage spans attribute device time
    "obs/profile.py": {"diff_summaries", "format_diff"},
}


def _public_names(root: Path) -> dict:
    """{module path: its public top-level functions, classes and methods}."""
    out = {}
    for f in root.rglob("*.py"):
        names = set()
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name[0] != "_":
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= {f"{node.name}.{m.name}" for m in node.body
                              if isinstance(m, ast.FunctionDef) and m.name[0] != "_"}
        out[str(f.relative_to(root))] = names
    return out


def test_the_port_lacks_only_the_names_left_out():
    ref, ours = _public_names(ROOT / "src/repro"), _public_names(ROOT / "src/repro_torch")
    missing = {mod: names - ours.get(mod, set()) for mod, names in ref.items()}
    assert {mod: names for mod, names in missing.items() if names} == LEFT_OUT
