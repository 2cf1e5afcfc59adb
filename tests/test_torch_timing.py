"""Port parity, the measured loop: ``RoundClock`` and ``observe_timing``.

Every clock here runs on a scripted clock: ``time`` inside both packages'
timing modules is replaced by ``ScriptedTime``, whose ``perf_counter``
only moves when a dispatch (or a pad's ``sleep``) advances it by a
scripted amount. No assertion reads the machine's clock, so nothing here
depends on the load of the machine running the suite.

* both packages' clocks, fed the same scripted durations and stub
  executors that return the same numpy ``round_observation``: every
  ``RoundTiming`` field (1e-12 relative), ``unit_s``, ``rounds``, ``fed``
  and the ``round_timing`` events (``wall_s`` stamps left out) over
  warmup, calibration, common scales, ``discard_next``, the outlier
  guard, pad attribution, leavers and comm transfer shares;
* the knobs' refusals, the CUDA synchronisation of the executor's device;
* ``observe_timing``: skipped rounds are no-ops, and both controllers
  make the same decisions on the same timings;
* the two acceptance replays on a real port executor: a stationary fleet
  never replans in 40 fed rounds; a sleep-padded group replans within two
  cadences and sheds load;
* the generator-clone invariant: ``times / scale <= deadline`` is the
  round's finish mask, exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.runtime.timing as ref_timing
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.runtime.control import AdaptConfig as RefAdaptConfig
from repro.runtime.control import AdaptiveController as RefController
from repro.runtime.executor import CodedRoundExecutor as RefExecutor
from repro.runtime.telemetry import Telemetry as RefTelemetry
import repro_torch.runtime.timing as timing
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import make_scheme
from repro_torch.runtime.control import AdaptConfig, AdaptiveController
from repro_torch.runtime.executor import CodedRoundExecutor
from repro_torch.runtime.plan_bucket import BucketConfig, select_bucket
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.timing import RoundClock, RoundTiming

torch.set_num_threads(1)

BASE = ([8, 16, 8], [4.0, 1.0, 0.25], 1.0, [16.0, 8.0, 4.0])
K = 1_000
FIELDS = ("round", "dispatch_s", "pad_wall_s", "scale", "times", "transfer_times",
          "payload", "membership", "skipped")


class ScriptedTime:
    """Stand-in for the ``time`` module: ``perf_counter`` returns a clock
    that only ``advance`` and ``sleep`` move."""

    def __init__(self, start: float = 1000.0):
        self.now = start
        self.slept = []

    def perf_counter(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds

    def sleep(self, seconds: float) -> None:
        self.slept.append(seconds)
        self.now += seconds


@pytest.fixture
def clocks(monkeypatch):
    """(reference's scripted time, port's scripted time)."""
    ref_t, port_t = ScriptedTime(), ScriptedTime()
    monkeypatch.setattr(ref_timing, "time", ref_t)
    monkeypatch.setattr(timing, "time", port_t)
    return ref_t, port_t


class StubExecutor:
    """Returns the scripted observations in order, whatever the key or
    generator; ``scheme`` is the package's own typed scheme object."""

    def __init__(self, scheme, observations, num_workers, device="cpu"):
        self.scheme = scheme
        self.num_workers = num_workers
        self.device = torch.device(device)
        self._obs = list(observations)

    def round_observation(self, _draw, cluster=None):
        v, shifts = self._obs.pop(0)
        return v.copy(), shifts.copy()


def _observations(rounds, w=6, seed=0, leave_at=None, comm=False):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        v = rng.exponential(1.0, w) + 0.5
        shifts = np.where(np.arange(w) < w // 2, 0.1, 0.4) if comm else np.zeros(w)
        if leave_at is not None and r in leave_at:
            v[leave_at[r]] = np.inf
            shifts = shifts.copy()
            shifts[leave_at[r]] = np.inf
        out.append((v, shifts))
    return out


def _dispatch(t, seconds):
    def run():
        t.advance(seconds)
        return seconds
    return run


def _assert_timing_equal(got: RoundTiming, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f)
        elif isinstance(b, float) and np.isnan(b):
            assert np.isnan(a), f
        elif isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-12), f
        else:
            assert a == b, f
    assert got.wall_s == pytest.approx(want.wall_s, rel=1e-12)


def _events(tel):
    return [{k: v for k, v in e.items() if k not in ("wall_s", "t")}
            for e in tel.events if e["event"] == "round_timing"]


def _assert_events_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-12), k
            else:
                assert g[k] == v, k


# one scripted run per case: (dispatch seconds per round, pads per round,
# discard_next before round, leavers per round, comm, clock kwargs)
CASES = {
    # round 0 warms up; round 1 calibrates (scale 1.0); later rounds share
    # one common scale each
    "warmup_calibration_scale": dict(durations=[0.5, 0.02, 0.03, 0.025, 0.04]),
    # a flagged rebuild and a stall past outlier_factor x the smoothed round
    "discard_and_outlier": dict(durations=[0.5, 0.02, 0.021, 0.022, 0.02, 0.9, 0.02],
                                discard_before=(4,), kw=dict(outlier_factor=5.0)),
    # pads on the last two workers from round 2, then cleared
    "pad": dict(durations=[0.3, 0.02, 0.02, 0.025, 0.02],
                pads={2: [0, 0, 0, 0, 0.01, 0.02], 3: [0, 0, 0, 0, 0.01, 0.01]}),
    # leavers decompose to inf; a round where everyone left feeds all-inf
    "leavers": dict(durations=[0.02, 0.02, 0.03, 0.02], kw=dict(warmup=0),
                    leave_at={1: [4, 5], 2: [0, 1, 2, 3, 4, 5]}, truth=True),
    # comm-delay scheme: upload shifts become transfer shares
    "comm": dict(durations=[0.2, 0.02, 0.03], comm=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_clock_matches_reference_on_scripted_clock(clocks, case):
    spec = CASES[case]
    ref_t, port_t = clocks
    durations = spec["durations"]
    obs = _observations(len(durations), leave_at=spec.get("leave_at"),
                        comm=spec.get("comm", False))
    if spec.get("comm"):
        ref_sch = ref_make_scheme("comm_aware", upload=2.0, download=1.0)
        sch = make_scheme("comm_aware", upload=2.0, download=1.0)
    else:
        ref_sch, sch = ref_make_scheme("optimal"), make_scheme("optimal")
    ref_tel, tel = RefTelemetry(None), Telemetry(None)
    kw = spec.get("kw", {})
    ref_clock = ref_timing.RoundClock(StubExecutor(ref_sch, obs, 6), telemetry=ref_tel, **kw)
    clock = RoundClock(StubExecutor(sch, obs, 6), telemetry=tel, **kw)
    truth = (ClusterSpec.make([4, 1], [2.0, 1.0]), RefCluster.make([4, 1], [2.0, 1.0])) \
        if spec.get("truth") else (None, None)
    gen = torch.Generator()
    for r, d in enumerate(durations):
        pad = spec.get("pads", {}).get(r)
        ref_clock.pad_s = clock.pad_s = pad
        if r in spec.get("discard_before", ()):
            ref_clock.discard_next("recompile")
            clock.discard_next("recompile")
        want = ref_clock.measure(_dispatch(ref_t, d), key=None, true_cluster=truth[1])
        got = clock.measure(_dispatch(port_t, d), generator=gen, true_cluster=truth[0])
        _assert_timing_equal(got, want)
        assert got.result == want.result == d
    assert (clock.rounds, clock.fed) == (ref_clock.rounds, ref_clock.fed)
    assert clock.unit_s == pytest.approx(ref_clock.unit_s, rel=1e-12)
    assert port_t.slept == ref_t.slept
    _assert_events_equal(_events(tel), _events(ref_tel))


def test_scripted_cases_cover_every_guard_rail(clocks):
    """What the parity cases above walk through, on the port alone."""
    _, t = clocks
    obs = _observations(7)
    clock = RoundClock(StubExecutor(make_scheme("optimal"), obs, 6), outlier_factor=5.0)
    gen = torch.Generator()
    seen = []
    for r, d in enumerate([0.5, 0.02, 0.03, 0.02, 0.02, 0.9, 0.02]):
        if r == 4:
            clock.discard_next("recompile")
        seen.append(clock.measure(_dispatch(t, d), generator=gen))
    assert [s.skipped for s in seen] == ["warmup", None, None, None, "recompile",
                                        "outlier", None]
    # only fed rounds draw: round 1 decomposes the first observation
    assert seen[1].scale == pytest.approx(1.0)  # the calibration identity
    np.testing.assert_allclose(seen[1].times, obs[0][0], rtol=1e-12)
    # a later round is the draw times ONE factor, the wall ratio
    np.testing.assert_allclose(seen[2].times, obs[1][0] * seen[2].scale, rtol=1e-12)
    assert seen[2].scale == pytest.approx(
        (0.03 / obs[1][0].max()) / (0.02 / obs[0][0].max()), rel=1e-12)
    assert clock.unit_s == pytest.approx(0.02 / obs[0][0].max(), rel=1e-12)
    assert clock.fed == 4 and clock.rounds == 7


def test_pad_is_slept_and_attributed_per_worker(clocks):
    _, t = clocks
    obs = _observations(3)
    clock = RoundClock(StubExecutor(make_scheme("optimal"), obs, 6))
    gen = torch.Generator()
    for d in (0.1, 0.02):
        clock.measure(_dispatch(t, d), generator=gen)
    pad = np.array([0, 0, 0, 0, 0.01, 0.02])
    clock.pad_s = pad
    got = clock.measure(_dispatch(t, 0.02), generator=gen)
    assert t.slept == [0.02] and got.pad_wall_s == pytest.approx(0.02)
    assert got.wall_s == pytest.approx(got.dispatch_s + got.pad_wall_s)
    v = obs[1][0]  # the warmup round drew nothing
    want = v * got.scale + pad / pad.max() * got.pad_wall_s / clock.unit_s
    np.testing.assert_allclose(got.times, want, rtol=1e-12)
    np.testing.assert_allclose(got.times[:4], v[:4] * got.scale, rtol=1e-12)


def test_leavers_of_a_real_executor_decompose_to_inf(clocks):
    _, t = clocks
    exe = CodedRoundExecutor(ClusterSpec.make(*BASE), K, "optimal", device="cpu")
    groups = list(exe.cluster.groups)
    groups[1] = dataclasses.replace(groups[1], num_workers=14)
    clock = RoundClock(exe, warmup=0)
    got = clock.measure(_dispatch(t, 0.02), generator=torch.Generator().manual_seed(9),
                        true_cluster=ClusterSpec(tuple(groups)))
    assert int(np.isinf(got.times).sum()) == 2 and got.membership == (8, 14, 8)


def test_comm_transfer_shares_are_scaled_shifts(clocks):
    _, t = clocks
    exe = CodedRoundExecutor(ClusterSpec.make(*BASE), K,
                             make_scheme("comm_aware", upload=2.0, download=1.0),
                             device="cpu")
    clock = RoundClock(exe, warmup=0)
    gen = torch.Generator().manual_seed(3)
    draw = torch.Generator()
    draw.set_state(gen.get_state())
    v, shifts = exe.round_observation(draw)
    got = clock.measure(_dispatch(t, 0.02), generator=gen)
    assert got.payload == 2.0
    np.testing.assert_allclose(got.transfer_times, shifts * got.scale, rtol=1e-12)
    np.testing.assert_allclose(got.times, v * got.scale, rtol=1e-12)


def test_clock_validates_knobs_as_the_reference():
    exe = StubExecutor(make_scheme("optimal"), [], 6)
    for kw, name in ((dict(warmup=-1), "warmup"), (dict(outlier_factor=1.0), "outlier_factor"),
                     (dict(smooth=1.0), "smooth")):
        with pytest.raises(ValueError) as want:
            ref_timing.RoundClock(exe, **kw)
        with pytest.raises(ValueError, match=name) as got:
            RoundClock(exe, **kw)
        assert str(got.value) == str(want.value)


def test_clock_synchronises_the_executors_cuda_device(clocks, monkeypatch):
    """A CUDA executor: the clock waits for its device before the second
    read (``dispatch_s`` runs until the device is done); a CPU one: no
    synchronisation."""
    _, t = clocks
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append((device, t.now)))
    obs = _observations(2)
    for device, want in (("cpu", 0), ("cuda:0", 1)):
        exe = StubExecutor(make_scheme("optimal"), obs[:1], 6, device=device)
        RoundClock(exe).measure(_dispatch(t, 0.02), generator=torch.Generator())
        assert len(synced) == want
    assert synced[0][0] == torch.device("cuda:0") and synced[0][1] == t.now


# ------------------------------------------------------------ the controller
def test_observe_timing_skipped_rounds_are_noops():
    exe = CodedRoundExecutor(ClusterSpec.make(*BASE), K, "optimal", device="cpu")
    ctl = AdaptiveController(exe, AdaptConfig(every=1))
    skipped = RoundTiming(round=1, result=None, wall_s=0.1, dispatch_s=0.1,
                          pad_wall_s=0.0, scale=float("nan"), times=None,
                          transfer_times=None, payload=1.0, membership=None,
                          skipped="warmup")
    assert ctl.observe_timing(skipped) is None
    assert ctl.observe_timing(None) is None
    assert ctl.round == 0 and ctl.decisions == []


def test_controller_decisions_match_reference_on_the_same_timings(clocks):
    """Both packages' clocks and controllers over one scripted run: the
    fleet's slow group is padded from fed round 6, and group 0 leaves two
    workers at round 12. Same timings, same decisions, same plans."""
    ref_t, port_t = clocks
    ref_exe = RefExecutor(RefCluster.make(*BASE), K, "optimal")
    exe = CodedRoundExecutor(ClusterSpec.make(*BASE), K, "optimal", device="cpu")
    ref_ctl = RefController(ref_exe, RefAdaptConfig(every=4, threshold=0.05))
    ctl = AdaptiveController(exe, AdaptConfig(every=4, threshold=0.05))
    rng = np.random.default_rng(5)
    ref_clock = ref_timing.RoundClock(ref_exe)
    clock = RoundClock(exe)

    for r in range(24):
        truth = (RefCluster.make([6, 16, 8], [4.0, 1.0, 0.25], 1.0, [16.0, 8.0, 4.0]),
                 ClusterSpec.make([6, 16, 8], [4.0, 1.0, 0.25], 1.0, [16.0, 8.0, 4.0])) \
            if r >= 12 else (None, None)
        w = ref_exe.num_workers
        assert exe.num_workers == w
        v = rng.exponential(1.0, w) + 1.0
        if truth[0] is not None and w == 32:
            v[6:8] = np.inf  # group 0's two leavers, until a replan drops them
        obs = (v, np.zeros(w))
        ref_exe.round_observation = lambda _k, _c=None, o=obs: (o[0].copy(), o[1].copy())
        exe.round_observation = lambda _g, _c=None, o=obs: (o[0].copy(), o[1].copy())
        if clock.fed >= 6:
            pad = np.zeros(w)
            pad[-8:] = 2.0 * clock.unit_s * float(exe.deadline)
            ref_clock.pad_s = clock.pad_s = pad
        d = 0.02 * (1.0 + 0.05 * np.sin(r))
        want = ref_ctl.observe_timing(ref_clock.measure(_dispatch(ref_t, d), key=None,
                                                        true_cluster=truth[0]))
        got = ctl.observe_timing(clock.measure(_dispatch(port_t, d),
                                               generator=torch.Generator(),
                                               true_cluster=truth[1]))
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.replanned, got.reason, got.round) == \
                (want.replanned, want.reason, want.round)
            np.testing.assert_allclose(got.gain, want.gain, rtol=1e-9, atol=1e-12)
        ref_exe.__dict__.pop("round_observation")
        exe.__dict__.pop("round_observation")
    assert ctl.replans == ref_ctl.replans >= 2
    assert {d.reason for d in ctl.decisions if d.replanned} == {"improvement", "membership"}
    assert exe.plan.loads_per_worker.tolist() == ref_exe.plan.loads_per_worker.tolist()


# ------------------------------------------------------ acceptance replays
def _replay(t, rounds, *, every=5, pad_at=None, pad_units=4.0, seed=100):
    """A real port executor on the BASE fleet under a scripted clock: a
    warmup round of 0.5 s, then rounds of 20 ms with a 1% deterministic
    wobble; from fed round ``pad_at`` the fast group is padded by
    ``pad_units`` x unit_s x deadline."""
    exe = CodedRoundExecutor(ClusterSpec.make(*BASE), K, "optimal", device="cpu")
    old = np.asarray(exe.plan.allocation.loads).copy()
    ctl = AdaptiveController(exe, AdaptConfig(every=every, threshold=0.05))
    clock = RoundClock(exe, warmup=1)
    gen = torch.Generator().manual_seed(seed)
    for r in range(rounds):
        if pad_at is not None and clock.fed == pad_at and clock.pad_s is None:
            pad = np.zeros(exe.num_workers)
            pad[:8] = pad_units * clock.unit_s * float(exe.deadline)
            clock.pad_s = pad
        d = 0.5 if r == 0 else 0.02 * (1.0 + 0.01 * np.sin(r))
        ctl.observe_timing(clock.measure(_dispatch(t, d), generator=gen))
    return exe, ctl, clock, old


def test_measured_stationary_fleet_zero_spurious_replans(clocks):
    _, t = clocks
    _, ctl, clock, _ = _replay(t, 41)
    assert clock.fed == 40 and ctl.round == 40
    assert ctl.replans == 0, [d for d in ctl.decisions if d.replanned]
    assert len(ctl.decisions) == 8 and all(d.reason == "hold" for d in ctl.decisions)


@pytest.mark.parametrize("pad_units", [0.25, 1.0, 4.0])
def test_measured_sleep_padded_group_replans_within_two_cadences(clocks, pad_units):
    """A padded group (its worker's share of a really slept pad) replans
    within two cadences of the injection at fed round 10, and the new
    plan gives the padded group fewer rows (the trainer's own replay on
    the chip's fleet is in ``tests/test_torch_train_adapt.py``)."""
    _, t = clocks
    _, ctl, clock, old = _replay(t, 31, pad_at=10, pad_units=pad_units)
    replans = [d for d in ctl.decisions if d.replanned]
    assert replans and 10 < replans[0].round <= 10 + 2 * 5
    assert np.asarray(ctl.plan.allocation.loads)[0] < old[0]
    assert t.slept and all(s > 0 for s in t.slept)


# ------------------------------------------------- the generator invariant
@pytest.mark.parametrize("bucket", [False, True])
def test_times_over_scale_reproduce_the_finish_mask(clocks, bucket):
    """A clone of the generator taken just before the mask is drawn: the
    clock's ``times / scale`` is the mask's draw, so at the deadline it
    gives the mask exactly, round after round, drifting truth included."""
    _, t = clocks
    exe = CodedRoundExecutor(ClusterSpec.make(*BASE), K, "optimal", device="cpu",
                             deadline_safety=1.0,
                             bucket_config=BucketConfig(quantum=4) if bucket else None)
    clock = RoundClock(exe, warmup=0)
    gen = torch.Generator().manual_seed(11)
    truth = ClusterSpec.make([8, 12, 8], [4.0, 0.6, 0.25], 1.0, [16.0, 8.0, 4.0])
    checked = 0
    for r in range(12):
        true = truth if r % 2 else None
        mus, alphas, shifts = exe.worker_param_arrays(true) if true else (None,) * 3
        draw = torch.Generator()
        draw.set_state(gen.get_state())
        mask = exe.finish_mask(gen, mus=mus, alphas=alphas, shifts=shifts)
        deadline = (select_bucket(*exe.bucket_args())["deadline"].numpy() if bucket
                    else np.float32(exe.deadline))
        got = clock.measure(_dispatch(t, 0.02 + 0.001 * r), generator=draw,
                            true_cluster=true)
        v = (got.times / got.scale).astype(np.float32)
        np.testing.assert_array_equal(v <= deadline, mask.numpy())
        checked += int((~mask).sum()) > 0
    assert checked > 0  # some rounds did erase workers
