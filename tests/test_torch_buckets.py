"""Port parity, plan buckets: allocation against the reference's fast
path, ``plan_bucket`` and the executor's bucket mode.

* every registered scheme's ``allocate`` (the port's numpy solvers)
  against the reference's default fused path, on the clusters of
  ``tests/test_alloc_fastpath.py`` (heterogeneous G = 6, comm-shifted
  links with a zero-load group, near-deterministic workers): real loads,
  r, n and t* to 1e-9, integer loads and n exactly;
* each solver against the reference's jitted core on the same inputs,
  1e-12 relative (1e-9 where a bisection decides); the memo's counters
  in the process-global metrics registry;
* ``quantize_loads_int``, ``bucket_signature`` and ``BucketConfig``'s
  refusals exactly as the reference's; ``PlanBucketSet`` admission and
  LRU eviction over one plan sequence, row for row;
* the executor's hit / miss / structural sequence over one cluster
  sequence (drift within capacity, growth past ``n_cap``, a membership
  change): events, ``bucket_probe`` answers, plans and deadlines;
* bucket finish masks against the analytic ``F_j(deadline)`` at 4 sigma
  over 4,000 draws; capacity padding rows dead in every slot mask;
  ``select_bucket`` reads nothing back to the host;
* the controller charges ``replan_cost`` only on a bucket miss, as the
  reference's does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alloc_fastpath as ref_fast
from repro.core import allocation as ref_alloc
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core.planner import deploy as ref_deploy
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.core.schemes import scheme_params
from repro.runtime.control import AdaptConfig as RefAdaptConfig
from repro.runtime.control import AdaptiveController as RefController
from repro.runtime.executor import CodedRoundExecutor as RefExecutor
from repro.runtime import plan_bucket as ref_pb
from repro.runtime.telemetry import Telemetry as RefTelemetry
from repro_torch.core import allocation
from repro_torch.core.planner import deploy
from repro_torch.core.runtime_model import ClusterSpec, LatencyModel
from repro_torch.core.schemes import (
    allocate_cache_clear,
    allocate_cache_info,
    make_scheme,
    scheme_names,
)
from repro_torch.obs.metrics import REGISTRY
from repro_torch.runtime import plan_bucket as pb
from repro_torch.runtime.control import AdaptConfig, AdaptiveController
from repro_torch.runtime.executor import CodedRoundExecutor
from repro_torch.runtime.telemetry import Telemetry

torch.set_num_threads(1)

K = 512
#: the clusters of tests/test_alloc_fastpath.py
CLUSTERS = {
    "base_g3": ([8, 16, 8], [4.0, 1.0, 0.25], 1.0, [16.0, 8.0, 4.0]),
    "hetero_g6": ([8, 16, 8, 4, 6, 10], [4.0, 1.0, 0.25, 2.0, 0.5, 8.0], 1.0,
                  [16.0, 8.0, 4.0, 2.0, 8.0, 32.0]),
    "comm_shifted": ([6, 10, 8], [4.0, 1.0, 0.4], 1.0, [8.0, 2.0, 0.5]),
    "near_deterministic": ([8, 8], [50.0, 1.0], [20.0, 1.0], [16.0, 8.0]),
}
PARAM_FALLBACKS = {
    "n": lambda cluster, k: 1.5 * k,
    "r": lambda cluster, k: max(1, cluster.total_workers // 2),
}


def _instantiate(name, cluster, k):
    try:
        return make_scheme(name)
    except ValueError:
        return make_scheme(name, **{p: fb(cluster, k) for p, fb in PARAM_FALLBACKS.items()
                                    if p in scheme_params(name)})


# --------------------------------------------- allocation vs fast path
def _instantiate_ref(name, cluster, k):
    try:
        return ref_make_scheme(name)
    except ValueError:
        return ref_make_scheme(name, **{p: fb(cluster, k) for p, fb in PARAM_FALLBACKS.items()
                                        if p in scheme_params(name)})


@pytest.mark.parametrize("cluster_kind", sorted(CLUSTERS))
@pytest.mark.parametrize("name", scheme_names())
def test_allocate_matches_reference_fast_path(name, cluster_kind):
    """The port's numpy solvers against the reference's default (fused,
    jitted) allocation path, at the bounds the reference holds its own
    fast path to its eager oracle: 1e-9, integer loads and n exact."""
    cluster = ClusterSpec.make(*CLUSTERS[cluster_kind])
    rcluster = RefCluster.make(*CLUSTERS[cluster_kind])
    assert ref_alloc.fastpath_enabled()
    allocate_cache_clear()
    got = _instantiate(name, cluster, K).allocate(cluster, K)
    want = _instantiate_ref(name, rcluster, K).allocate(rcluster, K)
    np.testing.assert_allclose(got.loads, want.loads, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.r, want.r, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.n, want.n, rtol=1e-9)
    if np.isnan(want.t_star):
        assert np.isnan(got.t_star)
    else:
        np.testing.assert_allclose(got.t_star, want.t_star, rtol=1e-9)
    assert got.loads_int.tolist() == want.loads_int.tolist()
    assert got.n_int == want.n_int


def _core_inputs(kind):
    args = CLUSTERS[kind]
    ours, ref = ClusterSpec.make(*args), RefCluster.make(*args)
    return ours, ref, tuple(np.asarray(a, np.float64) for a in ref.arrays())


@pytest.mark.parametrize("cluster_kind", sorted(CLUSTERS))
@pytest.mark.parametrize("core", ["optimal", "reisizadeh", "comm", "group_split"])
def test_solvers_match_reference_cores(core, cluster_kind):
    """Each port solver against the reference's jitted core on the same
    inputs: 1e-12 relative where the solve is closed form, 1e-9 where
    a bisection decides (the eager bisection stops at a 1e-12 residual,
    the core's at a 1e-15 bracket)."""
    from repro.core.runtime_model import comm_terms as ref_comm_terms

    ours, ref, (n_w, mu, al) = _core_inputs(cluster_kind)
    j = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    rtol = 1e-12
    if core == "optimal":
        plan = allocation.optimal_allocation(ours, K, model=LatencyModel.MODEL_1)
        got = (plan.loads, plan.r, plan.n, plan.t_star)
        want = ref_fast.optimal_core(j(n_w), j(mu), j(al), float(K))
    elif core == "reisizadeh":
        plan = allocation.reisizadeh_allocation(ours, K)
        got = (plan.loads, plan.r, plan.n)
        want = ref_fast.reisizadeh_core(j(n_w), j(mu), j(al), float(K))
    elif core == "comm":
        c, dal = ref_comm_terms(ref, 1.0, 1.0)
        plan = allocation.comm_aware_allocation(ours, K, upload=1.0, download=1.0)
        got = (plan.loads, plan.r, plan.n, plan.t_star)
        want = ref_fast.comm_core(j(n_w), j(mu), j(al + dal), j(c), float(K))
        rtol = 1e-9
    else:
        r = ours.total_workers // 2
        got = (allocation.group_code_split(ours, r),)
        want = (ref_fast.group_split_core(j(n_w), j(mu), float(r)),)
        rtol = 1e-9
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w), rtol=rtol,
                                   atol=1e-300)


def test_bisection_meets_the_residual_bound():
    cluster = ClusterSpec.make(*CLUSTERS["comm_shifted"])
    r = cluster.total_workers // 2
    split = allocation.group_code_split(cluster, r)
    assert abs(float(np.sum(split)) - r) < 1e-9 * r
    t = allocation.comm_t_star(cluster, 1.0, 1.0)
    c, g, _ = allocation.comm_deadline_terms(cluster, 1.0, 1.0)
    assert abs(float(np.sum(g * np.maximum(t - c, 0.0))) - 1.0) < 1e-9
    assert allocation.BISECT_RESIDUAL_BOUND <= 1e-9


def test_allocate_memo_counts_live_in_the_registry():
    """The memo's hits and misses are the process-global registry's
    ``alloc_cache_*`` counters, as in the reference; a clear zeroes them."""
    allocate_cache_clear()
    cluster = ClusterSpec.make(*CLUSTERS["base_g3"])
    scheme = make_scheme("optimal")
    scheme.allocate(cluster, K)
    scheme.allocate(cluster, K)
    info = allocate_cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (1, 1, 1)
    assert (REGISTRY.counter("alloc_cache_hits").value,
            REGISTRY.counter("alloc_cache_misses").value) == (1, 1)
    allocate_cache_clear()
    info = allocate_cache_info()
    assert (info["size"], info["hits"], info["misses"]) == (0, 0, 0)
    assert REGISTRY.counter("alloc_cache_misses").value == 0


def test_registry_snapshot_reports_the_alloc_counters():
    """``REGISTRY.emit`` (the trainer's end-of-run event) carries the
    memo counters under the reference's names."""
    allocate_cache_clear()
    make_scheme("optimal").allocate(ClusterSpec.make(*CLUSTERS["hetero_g6"]), K)
    tel = Telemetry(None)
    ev = REGISTRY.emit(tel, phase="train", rounds=3.0)
    rows = {r["name"]: r for r in ev["metrics"]}
    assert rows["alloc_cache_misses"] == {"name": "alloc_cache_misses", "labels": {},
                                          "type": "counter", "value": 1}
    assert rows["alloc_cache_hits"]["value"] == 0
    assert ev["event"] == "metrics_snapshot" and ev["phase"] == "train"
    allocate_cache_clear()


# ---------------------------------------------------------- plan buckets
def test_quantize_and_signature_match_reference():
    for loads, q in (([0, 1, 7, 8, 9], 4), ([0, 3], 1), ([5, 16, 17], 16)):
        assert pb.quantize_loads_int(loads, q).tolist() == \
            ref_pb.quantize_loads_int(loads, q).tolist()
    assert pb.quantize_loads_int([0, 1, 7, 8, 9], 4).tolist() == [0, 4, 8, 8, 12]
    c, rc = ClusterSpec.make(*CLUSTERS["base_g3"]), RefCluster.make(*CLUSTERS["base_g3"])
    for loads, k in (([8, 8, 4], K), ([8, 8, 8], K), ([8, 8, 4], K + 1)):
        assert pb.bucket_signature(c, loads, k) == ref_pb.bucket_signature(rc, loads, k)
    assert pb.bucket_signature(c, [8, 8, 4], K) == pb.bucket_signature(c, np.asarray([8, 8, 4]), K)
    assert pb.bucket_signature(c, [8, 8, 4], K) != pb.bucket_signature(c, [8, 8, 8], K)


@pytest.mark.parametrize("kw", [dict(quantum=0), dict(capacity=0), dict(n_headroom=0.5)])
def test_bucket_config_refusals_match_reference(kw):
    with pytest.raises(ValueError) as want:
        ref_pb.BucketConfig(**kw)
    with pytest.raises(ValueError) as got:
        pb.BucketConfig(**kw)
    assert str(got.value) == str(want.value)


def _drifts(base):
    """A plan sequence: base, two mu drifts, base again, then more drifts
    than the set holds."""
    out = [base]
    for f in (3.0, 0.5, None, 6.0, 2.0, 0.3):
        if f is None:
            out.append(base)
            continue
        groups = list(base)
        out.append((groups[0], [groups[1][0], f, groups[1][2]], groups[2], groups[3]))
    return out


def test_plan_bucket_set_admission_and_lru_match_reference():
    """Capacity 3 over seven quantized plans: the same (row, hit) per admit,
    the same LRU order and the same stacked rows."""
    base = CLUSTERS["base_g3"]
    ours = pb.PlanBucketSet(32, 2000, 3)
    ref = ref_pb.PlanBucketSet(32, 2000, 3)
    for args in _drifts(base):
        args = (args[0], args[1], args[2], args[3])
        plan = pb.quantize_plan(deploy(make_scheme("optimal"), ClusterSpec.make(*args), K), 16)
        rplan = ref_pb.quantize_plan(
            ref_deploy(ref_make_scheme("optimal"), RefCluster.make(*args), K), 16)
        assert plan.n == rplan.n and plan.row_ranges == rplan.row_ranges
        sig = pb.bucket_signature(plan.cluster, plan.allocation.loads_int, K)
        rsig = ref_pb.bucket_signature(rplan.cluster, rplan.allocation.loads_int, K)
        assert sig == rsig
        w = np.arange(32, dtype=np.float64)
        got = ours.admit(sig, plan, 1.5, w + 1, w + 2, w * 0)
        want = ref.admit(rsig, rplan, 1.5, w + 1, w + 2, w * 0)
        assert got == want
        assert ours.signatures == ref.signatures and len(ours) == len(ref)
    state, rstate = ours.device_state(), ref.device_state()
    for k in ("owner", "alive", "loads", "deadline", "mus", "alphas", "shifts"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(rstate[k]), rtol=1e-7,
                                   err_msg=k)
    with pytest.raises(ValueError, match="structural"):
        ours.admit(("x",), dataclasses.replace(plan, n=2001), 1.0, w, w, w)


def test_select_bucket_reads_nothing_back_to_the_host(monkeypatch):
    base = ClusterSpec.make(*CLUSTERS["base_g3"])
    exe = CodedRoundExecutor(base, K, "optimal", device="cpu",
                             bucket_config=pb.BucketConfig(quantum=16))
    exe.replan(ClusterSpec.make(*_drifts(CLUSTERS["base_g3"])[1]))
    state, index = exe.bucket_args()
    assert index.dim() == 0 and index.device == exe.device and int(index) == 1

    def refuse(*_a, **_k):
        raise AssertionError("host read")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    sel = pb.select_bucket(state, index)
    monkeypatch.undo()
    for k, v in state.items():
        assert torch.equal(sel[k], v[1]), k


def _executor_pair(telemetry=True):
    base = CLUSTERS["base_g3"]
    rtel, tel = RefTelemetry(None), Telemetry(None)
    ref = RefExecutor(RefCluster.make(*base), K, "optimal",
                      bucket_config=ref_pb.BucketConfig(quantum=16, capacity=2),
                      telemetry=rtel)
    ours = CodedRoundExecutor(ClusterSpec.make(*base), K, "optimal", device="cpu",
                              bucket_config=pb.BucketConfig(quantum=16, capacity=2),
                              telemetry=tel)
    return ref, ours, rtel, tel


def _bucket_events(tel):
    return [{k: v for k, v in e.items() if k not in ("wall_s", "t")}
            for e in tel.events if e["event"].startswith("plan_bucket")]


def test_executor_bucket_sequence_matches_reference():
    """Drift within capacity (misses, then a hit, then an LRU eviction),
    growth past n_cap, a membership change: the same structural flags,
    hits, active rows, probe answers, plans, deadlines and events."""
    ref, ours, rtel, tel = _executor_pair()
    base = CLUSTERS["base_g3"]
    seq = _drifts(base)[:5]
    # slow every group: n grows past n_cap (structural)
    seq.append((base[0], [0.4, 0.1, 0.025], base[2], base[3]))
    # a worker leaves: the worker count changes (structural)
    seq.append(([7, 16, 8], base[1], base[2], base[3]))
    flags = []
    for args in seq:
        rc, c = RefCluster.make(*args), ClusterSpec.make(*args)
        assert ours.bucket_probe(c) == ref.bucket_probe(rc)
        sigs = ours.buckets.signatures
        ours.bucket_probe(c)
        assert ours.buckets.signatures == sigs  # probing admits nothing
        ref.replan(rc)
        ours.replan(c)
        flags.append((ours.last_replan_structural, ours.last_bucket_hit))
        assert (ours.last_replan_structural, ours.last_bucket_hit, ours.active_bucket) == \
            (ref.last_replan_structural, ref.last_bucket_hit, ref.active_bucket)
        assert ours.n == ref.n and ours.buckets.n_cap == ref.buckets.n_cap
        assert ours.plan.row_ranges == ref.plan.row_ranges
        # analytic deadlines to 1e-9; a quantization that inflates a load
        # past INTEGERIZATION_SLACK takes each package's own Monte Carlo
        alloc = ours.plan.allocation
        live = alloc.loads > 0
        analytic = np.max(alloc.loads_int[live] / alloc.loads[live]) <= \
            ours.INTEGERIZATION_SLACK
        assert ours.deadline == pytest.approx(ref.deadline, rel=1e-9 if analytic else 0.05)
        np.testing.assert_array_equal(ours.slot_owner.numpy(), np.asarray(ref.slot_owner))
    assert (False, True) in flags and (False, False) in flags
    assert flags[-2:] == [(True, False), (True, False)]
    assert _bucket_events(tel) == _bucket_events(rtel)
    assert ours.bucket_probe(ClusterSpec.make([7, 16, 8], [4.0, 1.0, 0.25])) is not None
    off = CodedRoundExecutor(ClusterSpec.make(*base), K, "optimal", device="cpu")
    assert off.bucket_probe(ClusterSpec.make(*base)) is None
    with pytest.raises(RuntimeError, match="bucket_config"):
        off.bucket_args()


def test_bucket_finish_masks_match_the_analytic_cdf():
    """Per-worker P(T <= deadline) of the bucket sampler over 4,000 draws
    vs F_j(d) = 1 - exp(-(k mu / l)(d - alpha l / k)), within 4 sigma,
    after a bucket switch (the active row is not row 0)."""
    base = ClusterSpec.make([6, 6], [8.0, 0.7])
    k, draws = 594, 4000
    exe = CodedRoundExecutor(base, k, "optimal", deadline_safety=1.2, device="cpu",
                             bucket_config=pb.BucketConfig(quantum=4))
    drifted = ClusterSpec.make([6, 6], [8.0, 0.9])
    exe.replan(drifted)
    assert not exe.last_replan_structural and exe.active_bucket == 1
    assert exe.n_slots == exe.buckets.n_cap > exe.n
    gen = torch.Generator().manual_seed(3)
    hits = torch.zeros(exe.num_workers, dtype=torch.int64)
    for _ in range(draws):
        mask = exe.finish_mask(gen)
        hits += mask.to(torch.int64)
        alive = exe.slot_mask(mask)
        assert not bool(alive[exe.n:].any())  # padding rows never alive
    rate = hits.numpy() / draws
    l = exe.plan.loads_per_worker.astype(float)
    mu = np.asarray([drifted.groups[j].mu for j in exe.plan.group_of_worker])
    al = np.asarray([drifted.groups[j].alpha for j in exe.plan.group_of_worker])
    d = float(pb.select_bucket(*exe.bucket_args())["deadline"])
    assert d == pytest.approx(exe.deadline, rel=1e-6)
    p = np.where(d > al * l / k, 1 - np.exp(-(k * mu / l) * (d - al * l / k)), 0.0)
    sigma = np.sqrt(p * (1 - p) / draws)
    assert np.all(np.abs(rate - p) <= 4 * sigma + 1e-12), (rate, p)
    assert np.any(p < 0.99)


def test_padding_rows_are_dead_in_every_slot_mask():
    exe = CodedRoundExecutor(ClusterSpec.make(*CLUSTERS["base_g3"]), K, "optimal",
                             device="cpu", bucket_config=pb.BucketConfig(quantum=16))
    for args in _drifts(CLUSTERS["base_g3"])[:4]:
        exe.replan(ClusterSpec.make(*args))
        state, index = exe.bucket_args()
        sel = pb.select_bucket(state, index)
        every = exe.slot_mask(torch.ones(exe.num_workers, dtype=torch.bool))
        assert every.shape == (exe.buckets.n_cap,)
        assert bool(every[: exe.n].all()) and not bool(every[exe.n:].any())
        np.testing.assert_array_equal(sel["owner"][: exe.n].numpy(), exe.slot_owner.numpy())
        for w in range(exe.num_workers):  # one worker missing kills exactly its rows
            mask = torch.ones(exe.num_workers, dtype=torch.bool)
            mask[w] = False
            alive = exe.slot_mask(mask)
            assert not bool(alive[exe.n:].any())
            assert int((~alive[: exe.n]).sum()) == int(exe.plan.loads_per_worker[w])


def test_controller_charges_replan_cost_only_on_a_bucket_miss():
    """A prohibitive ``replan_cost``: once the drifted fleet's bucket is
    admitted, the improvement replan onto it is free (``bucket_probe``
    True) and happens, in both packages on identical times; the same
    executor without bucket mode holds, paying the cost."""
    base = CLUSTERS["base_g3"]
    drifted_args = _drifts(base)[1]
    ref_exe = RefExecutor(RefCluster.make(*base), K, "optimal",
                          bucket_config=ref_pb.BucketConfig(quantum=16))
    exe = CodedRoundExecutor(ClusterSpec.make(*base), K, "optimal", device="cpu",
                             bucket_config=pb.BucketConfig(quantum=16))
    for args in (drifted_args, base):  # admit the drifted bucket, come back
        ref_exe.replan(RefCluster.make(*args))
        exe.replan(ClusterSpec.make(*args))
    cfg = dict(every=4, threshold=0.05, replan_cost=1e6, horizon=10)
    ref_ctl = RefController(ref_exe, RefAdaptConfig(**cfg))
    ctl = AdaptiveController(exe, AdaptConfig(**cfg))
    plain = AdaptiveController(
        CodedRoundExecutor(ClusterSpec.make(*base), K, "optimal", device="cpu"),
        AdaptConfig(**cfg))
    drifted = RefCluster.make(*drifted_args)
    for r in range(16):
        times = np.asarray(ref_exe.sample_round_times(jax.random.PRNGKey(r), drifted))
        want = ref_ctl.observe_round(times)
        got = ctl.observe_round(times)
        plain.observe_round(times)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.replanned, got.reason) == (want.replanned, want.reason)
            np.testing.assert_allclose(got.gain, want.gain, rtol=1e-9)
    replanned = [d.replanned for d in ctl.decisions]
    assert replanned == [d.replanned for d in ref_ctl.decisions] and sum(replanned) == 1
    assert exe.last_bucket_hit and not exe.last_replan_structural
    assert plain.replans == 0 and plain.decisions[0].gain > 0.05
