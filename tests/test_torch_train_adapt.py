"""Port parity, training's adaptive path on reduced qwen3-0.6b (CPU).

* ``Trainer``'s refusals, with the reference's messages;
* the measured static fleet on a scripted clock (``time`` inside
  ``repro_torch.runtime.timing`` replaced, each step advancing it): 10
  steps, 9 fed, 0 replans, 1 step build, 10 ``round_timing`` events;
* ``churn``: the membership replans land at the reference trainer's
  steps (membership comes from the trace, which both ``sim`` packages
  draw identically), and each adds one step build;
* the chip's ``[train-adapt]`` runs, fixed here: (a) ``churn``
  measured and bucketed, its decisions and counts unmoved by the wall
  times; (b) a static fleet padded by a really slept pad from fed round
  4, replanning within two cadences with fewer rows on the padded group;
* ``Trainer.replan`` (a worker joins) against the reference's: n and
  loads exact, the deadline 1e-9; then one coded step with the
  reference's B and an injected mask against the reference's jitted step;
* a bucket-hit replan keeps the step (no build), and the step after it,
  with B at ``n_cap`` and the mask injected, matches the reference's
  bucket step;
* ``launch/train.py``'s new flags and refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import ShapeConfig as RefShape
from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.data import SyntheticLMData as RefData
from repro.models.model import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime.plan_bucket import select_bucket as ref_select_bucket
from repro.runtime.train_loop import TrainConfig as RefTrainConfig
from repro.runtime.train_loop import Trainer as RefTrainer
import repro_torch.runtime.timing as timing
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import gradient_coding as gc
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as train_cli
from repro_torch.models.model import JAX_NAMES, Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import TrainConfig, Trainer, make_coded_train_step_fn

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
#: the AdamW eps of test_torch_train.py's whole-step comparisons
ADAM_EPS = 1e-6
#: the chip's [train-adapt] fleet and partitions
CHIP_FLEET = ([6, 6], [8.0, 0.7])
#: a fleet whose grad_coding deadline stays analytic at k = 64 before and
#: after a worker leaves (every ceil(l)/l within 1.05)
REPLAN_FLEET = ([2, 2], [4.0, 1.0])


class ScriptedTime:
    """Stand-in for ``time`` in the timing module: a clock that only steps
    (``advance``) and pads (``sleep``) move."""

    def __init__(self):
        self.now = 1000.0
        self.slept = []

    def perf_counter(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds

    def sleep(self, seconds: float) -> None:
        self.slept.append(seconds)
        self.now += seconds


@pytest.fixture
def scripted(monkeypatch):
    t = ScriptedTime()
    monkeypatch.setattr(timing, "time", t)
    return t


@pytest.fixture(scope="module")
def pair():
    ref = RefModel(REF_ARCHS["qwen3-0.6b"].reduced())
    params = ref.init_params(KEY)
    return ref, params, jax.tree.map(np.asarray, params)


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree, np.float32)


def _trainer(cfg_kw, *, seq=16, batch=4, steps=10, tree=None, eps=1e-8, lr=1e-3):
    c = ARCHS["qwen3-0.6b"].reduced()
    model = Model(c, device="cpu")
    if tree is not None:
        model.params_from_jax(tree)
    return Trainer(model,
                   SyntheticLMData(c, ShapeConfig("t", seq, batch, "train"), seed=1,
                                   device="cpu"),
                   AdamWConfig(lr=lr, warmup_steps=0, total_steps=steps, eps=eps),
                   TrainConfig(steps=steps, **cfg_kw))


def _ref_trainer(cfg_kw, *, seq=16, batch=4, steps=10, eps=1e-8, lr=1e-3):
    rc = REF_ARCHS["qwen3-0.6b"].reduced()
    return RefTrainer(RefModel(rc), RefData(rc, RefShape("t", seq, batch, "train"), seed=1),
                      RefAdamWConfig(lr=lr, warmup_steps=0, total_steps=steps, eps=eps),
                      RefTrainConfig(steps=steps, **cfg_kw))


def _timed(trainer, t, seconds):
    """Make every coded dispatch of ``trainer`` advance the scripted clock
    by ``seconds(step)``."""
    inner = trainer._coded_dispatch
    calls = [0]

    def dispatch(*args):
        t.advance(seconds(calls[0]))
        calls[0] += 1
        return inner(*args)

    trainer._coded_dispatch = dispatch


# ------------------------------------------------------------ refusals
class _NoShape:
    """A data pipeline without ``.shape``."""

    def next_batch(self):
        raise AssertionError("not reached")


REFUSALS = {
    "scenario_without_cluster": dict(scenario="mu_step"),
    "adapt_without_cluster": dict(adapt_every=2),
    "measure_without_cluster": dict(measure_times=True),
    "adapt_every_zero": dict(cluster=REPLAN_FLEET, adapt_every=0),
    "partitions_not_dividing": dict(cluster=REPLAN_FLEET, partitions=3),
    "no_shape_no_partitions": dict(cluster=REPLAN_FLEET, no_shape=True),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_trainer_refusals_match_reference(case):
    kw = dict(REFUSALS[case])
    no_shape = kw.pop("no_shape", False)
    fleet = kw.pop("cluster", None)
    c, rc = ARCHS["qwen3-0.6b"].reduced(), REF_ARCHS["qwen3-0.6b"].reduced()
    data = _NoShape() if no_shape else SyntheticLMData(
        c, ShapeConfig("t", 16, 4, "train"), seed=1, device="cpu")
    rdata = _NoShape() if no_shape else RefData(rc, RefShape("t", 16, 4, "train"), seed=1)
    with pytest.raises(ValueError) as want:
        RefTrainer(RefModel(rc), rdata, RefAdamWConfig(),
                   RefTrainConfig(steps=5, cluster=fleet and RefCluster.make(*fleet), **kw))
    with pytest.raises(ValueError) as got:
        Trainer(Model(c, device="cpu"), data, AdamWConfig(),
                TrainConfig(steps=5, cluster=fleet and ClusterSpec.make(*fleet), **kw))
    assert str(got.value) == str(want.value)


# -------------------------------------------------------- measured loop
def test_measured_static_fleet_holds(scripted):
    t = _trainer(dict(log_every=5, cluster=ClusterSpec.make([8, 8], [4.0, 0.5]),
                      scheme="grad_coding", adapt_every=2, adapt_threshold=0.1,
                      measure_times=True))
    _timed(t, scripted, lambda i: 0.5 if i == 0 else 0.05 * (1 + 0.02 * np.sin(i)))
    _, _, history = t.run()
    assert all(np.isfinite(h["loss"]) for h in history)
    assert t.clock.rounds == 10 and t.clock.fed == 9
    assert t.controller.round == 9 and t.controller.replans == 0
    assert all(d.reason == "hold" for d in t.controller.decisions)
    assert t.step_builds == 1
    recs = [e for e in t.telemetry.events if e["event"] == "round_timing"]
    assert len(recs) == 10 and sum(r["fed"] for r in recs) == 9
    spans = [e for e in t.telemetry.events if e["event"] == "span"
             and e["span"] == "dispatch"]
    assert len(spans) == 10
    snap = [e for e in t.telemetry.events if e["event"] == "metrics_snapshot"]
    assert len(snap) == 1 and snap[0]["phase"] == "train" and snap[0]["rounds"] == 10.0


def _membership(ctl):
    return [d.round for d in ctl.decisions if d.reason == "membership"]


def test_churn_membership_replans_at_the_reference_steps():
    """The simulated closed loop: the controller observes the draw of each
    step's mask, so a decision comes every second step and the membership
    replans land where the reference trainer's do."""
    cfg = dict(log_every=4, scheme="grad_coding", scenario="churn", adapt_every=2)
    ref = _ref_trainer(dict(cluster=RefCluster.make(*CHIP_FLEET), **cfg), steps=12)
    ours = _trainer(dict(cluster=ClusterSpec.make(*CHIP_FLEET), **cfg), steps=12)
    assert ours.trace.change_rounds() == ref.trace.change_rounds()
    ref.run()
    ours.run()
    assert _membership(ours.controller) == _membership(ref.controller) == [4, 10]
    assert len(ours.controller.decisions) == len(ref.controller.decisions) == 6
    structural = sum(d.replanned for d in ours.controller.decisions)
    assert ours.step_builds == 1 + structural
    assert ours.executor.num_workers == ref.executor.num_workers


#: the chip's [train-adapt] (a): steps, cadence, quantum
CHIP_STEPS, CHIP_EVERY, CHIP_QUANTUM, CHIP_K = 12, 2, 4, 16
#: (a)'s membership replans, as (step, workers after)
CHIP_A_MEMBERSHIP = [(4, 9), (9, 12)]


def _chip_a(scripted, wobble):
    t = _trainer(dict(log_every=1, cluster=ClusterSpec.make(*CHIP_FLEET),
                      scheme="grad_coding", partitions=CHIP_K, scenario="churn",
                      adapt_every=CHIP_EVERY, measure_times=True,
                      bucket_quantum=CHIP_QUANTUM), batch=CHIP_K, steps=CHIP_STEPS)
    _timed(t, scripted, lambda i: 0.5 if i == 0 else 0.05 * (1 + wobble * np.sin(3 * i)))
    steps = []
    inner = t.controller.observe_timing

    def observe(timing):
        d = inner(timing)
        if d is not None and d.replanned:
            steps.append((timing.round - 1, d.reason, t.executor.num_workers,
                          t.executor.last_replan_structural))
        return d

    t.controller.observe_timing = observe
    _, _, hist = t.run()
    return t, steps, hist


@pytest.mark.parametrize("wobble", [0.0, 0.05, 0.3])
def test_chip_train_adapt_a_churn_measured_bucketed(scripted, wobble):
    """(a) on the reduced model: the membership replans at the steps the
    chip checks, whatever the wall times; the rounds and fed counts; one
    step build per structural replan."""
    t, replans, hist = _chip_a(scripted, wobble)
    membership = [(s, w) for s, reason, w, _ in replans if reason == "membership"]
    assert membership == CHIP_A_MEMBERSHIP
    structural = sum(st for *_, st in replans)
    assert t.step_builds == 1 + structural
    assert t.clock.rounds == CHIP_STEPS
    assert t.clock.fed == CHIP_STEPS - t.clock.warmup - structural
    assert len(hist) == CHIP_STEPS
    events = [e["event"] for e in t.telemetry.events if e["event"].startswith("plan_bucket")]
    assert len(events) == len(replans)


#: the chip's [train-adapt] (b): the pad, as a multiple of unit_s x the
#: deadline, on the fast group from fed round 4: the smallest multiple that
#: replans within two cadences below (0.25 holds at gains of 0.04 against
#: the 0.05 threshold on this fleet)
CHIP_B_PADS, CHIP_B_AT, CHIP_B_STEPS = (0.5, 1.0, 2.0), 4, 10


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pad_units", CHIP_B_PADS)
def test_chip_train_adapt_b_padded_group_replans(scripted, pad_units, seed):
    t = _trainer(dict(log_every=1, seed=seed, cluster=ClusterSpec.make(*CHIP_FLEET),
                      scheme="grad_coding", partitions=CHIP_K, adapt_every=CHIP_EVERY,
                      measure_times=True), batch=CHIP_K, steps=CHIP_B_STEPS)
    old = np.asarray(t.executor.plan.allocation.loads).copy()
    clock = t.clock
    _timed(t, scripted, lambda i: 0.5 if i == 0 else 0.05 * (1 + 0.05 * np.sin(7 * i)))
    inner = t.controller.observe_timing

    def observe(timing):
        d = inner(timing)
        if clock.fed == CHIP_B_AT and clock.pad_s is None:  # pad from the next round
            pad = np.zeros(t.executor.num_workers)
            pad[: CHIP_FLEET[0][0]] = pad_units * clock.unit_s * float(t.executor.deadline)
            clock.pad_s = pad
        return d

    t.controller.observe_timing = observe
    t.run()
    replans = [d for d in t.controller.decisions if d.replanned]
    assert replans and CHIP_B_AT < replans[0].round <= CHIP_B_AT + 2 * CHIP_EVERY
    assert np.asarray(t.executor.plan.allocation.loads)[0] < old[0]
    assert scripted.slept


# ------------------------------------------------------------- replans
def _inject_b(trainer, b):
    trainer.b_matrix = gc.assignment_matrix(*b.shape, b=b, device="cpu")
    trainer.coded_step_fn = make_coded_train_step_fn(
        trainer.model, trainer.opt_cfg, trainer.executor, trainer.b_matrix,
        trainer.partitions)


def _compare_step(ours, ref, rp, rm, m):
    assert float(m["skipped"]) == float(rm["skipped"]) == 0.0
    for key in ("loss", "accuracy", "grad_norm", "lr", "survivors", "coded_rows_alive"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=2e-4, err_msg=key)
    for name, p in ours.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(rp, JAX_NAMES[name]),
                                   **STEP_TOL, err_msg=name)


def test_trainer_replan_matches_reference_then_steps(pair):
    _, params, tree = pair
    cfg = dict(cluster=None, log_every=1, scheme="grad_coding", partitions=64)
    ref = _ref_trainer({**cfg, "cluster": RefCluster.make(*REPLAN_FLEET)}, seq=8, batch=64,
                       eps=ADAM_EPS)
    ours = _trainer({**cfg, "cluster": ClusterSpec.make(*REPLAN_FLEET)}, seq=8, batch=64,
                    tree=tree, eps=ADAM_EPS)
    joined = ([3, 2], [4.0, 1.0])
    ref_plan = ref.replan(RefCluster.make(*joined))
    plan = ours.replan(ClusterSpec.make(*joined))
    assert plan.n == ref_plan.n and plan.num_workers == ref_plan.num_workers == 5
    assert plan.loads_per_worker.tolist() == np.asarray(ref_plan.loads_per_worker).tolist()
    assert ours.executor.deadline == pytest.approx(ref.executor.deadline, rel=1e-9)
    assert ours.step_builds == 2 and ours.b_matrix.shape == (plan.n, 64)
    rec = [e for e in ours.telemetry.events if e["event"] == "replan"][-1]
    want = [e for e in ref.telemetry.events if e["event"] == "replan"][-1]
    assert (rec["workers"], rec["n"]) == (want["workers"], want["n"])
    assert rec["deadline"] == pytest.approx(want["deadline"], rel=1e-9)

    wmask = np.ones(5, bool)
    wmask[4] = False  # a slow worker misses; the rest still decode
    np.testing.assert_array_equal(ours.executor.slot_owner.numpy(),
                                  np.asarray(ref.executor.slot_owner))
    _inject_b(ours, np.asarray(ref.b_matrix, np.float32))
    ref.executor.finish_mask_jit = lambda key, deadline: jnp.asarray(wmask)
    ref._build_coded_step()
    batch = ref.data.next_batch()
    rp, _, rm = ref.coded_step_fn(jax.tree.map(jnp.asarray, tree),
                                  ref_adamw_init(ref.opt_cfg, params), batch, KEY,
                                  jnp.float32(ref.executor.deadline))
    _, st, _ = ours.init_or_restore()
    st, m = ours.coded_step_fn(st, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                               torch.from_numpy(wmask))
    _compare_step(ours, ref, rp, rm, m)


def test_bucket_hit_replan_keeps_the_step_and_matches_reference(pair):
    _, params, tree = pair
    cfg = dict(log_every=1, scheme="grad_coding", partitions=64, bucket_quantum=4)
    ref = _ref_trainer({**cfg, "cluster": RefCluster.make(*REPLAN_FLEET)}, seq=8, batch=64,
                       eps=ADAM_EPS)
    ours = _trainer({**cfg, "cluster": ClusterSpec.make(*REPLAN_FLEET)}, seq=8, batch=64,
                    tree=tree, eps=ADAM_EPS)
    n_cap = ours.executor.buckets.n_cap
    assert n_cap == ref.executor.buckets.n_cap and ours.b_matrix.shape == (n_cap, 64)
    drifted = ([2, 2], [4.0, 1.3])
    ref.replan(RefCluster.make(*drifted))
    ours.replan(ClusterSpec.make(*drifted))
    for exe in (ours.executor, ref.executor):
        assert not exe.last_replan_structural
    assert ours.executor.active_bucket == ref.executor.active_bucket == 1
    assert ours.step_builds == 1  # the bucket switch kept the step
    assert ours.executor.plan.loads_per_worker.tolist() == \
        np.asarray(ref.executor.plan.loads_per_worker).tolist()
    events = [e["event"] for e in ours.telemetry.events if e["event"].startswith("plan_bucket")]
    assert events == ["plan_bucket_miss"]
    ours.replan(ClusterSpec.make(*REPLAN_FLEET))  # back: a hit, still no build
    ref.replan(RefCluster.make(*REPLAN_FLEET))
    assert ours.executor.last_bucket_hit and ours.step_builds == 1
    ours.replan(ClusterSpec.make(*drifted))
    ref.replan(RefCluster.make(*drifted))
    assert ours.executor.last_bucket_hit and ours.step_builds == 1

    wmask = np.ones(4, bool)
    wmask[3] = False
    _inject_b(ours, np.asarray(ref.b_matrix, np.float32))
    ref.executor.finish_mask_bucket_jit = (
        lambda key, state, index, **kw: (jnp.asarray(wmask), ref_select_bucket(state, index)))
    ref._build_coded_step()
    batch = ref.data.next_batch()
    rp, _, rm = ref.coded_step_fn(jax.tree.map(jnp.asarray, tree),
                                  ref_adamw_init(ref.opt_cfg, params), batch, KEY,
                                  jnp.float32(ref.executor.deadline), None,
                                  ref.executor.bucket_args())
    _, st, _ = ours.init_or_restore()
    st, m = ours.coded_step_fn(st, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                               torch.from_numpy(wmask))
    assert float(m["coded_rows_alive"]) == ours.executor.n - ours.executor.plan.loads_per_worker[3]
    _compare_step(ours, ref, rp, rm, m)


# ------------------------------------------------------------------ CLI
BASE = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "6",
        "--seq-len", "16", "--batch", "4"]


def test_launch_train_adaptive_measured_bucketed(capsys):
    train_cli.main(BASE + ["--hetero-groups", "2:2.0,2:0.5", "--scenario", "churn",
                           "--adapt-every", "2", "--measure-times", "--bucket-quantum", "4"])
    out = capsys.readouterr().out
    assert "adaptive control: every 2 steps, threshold 5%, scenario=churn" in out, out
    assert "measured: 4/6 rounds fed, unit_s=" in out, out
    assert "controller: 2 decisions" in out, out


@pytest.mark.parametrize("flags", [["--scenario", "churn"], ["--adapt-every", "2"],
                                   ["--adapt-threshold", "0.1"], ["--bucket-quantum", "4"],
                                   ["--measure-times"]])
def test_launch_train_refuses_adaptive_flags_without_a_fleet(flags):
    with pytest.raises(SystemExit, match=flags[0]):
        train_cli.main(BASE + flags)


def test_launch_train_refuses_unknown_scenario():
    with pytest.raises(SystemExit):
        train_cli.main(BASE + ["--hetero-groups", "2:2.0,2:0.5", "--scenario", "nope"])
