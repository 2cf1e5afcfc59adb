"""The port's serving CLI (``repro_torch.launch.serve``) on the CPU.

Reduced qwen3-0.6b with ``--device cpu``: the coded generate under three
schemes prints the reference's coded-head line (scheme tag, (n, k),
loads, deadline) and the ``generated ... tok/s`` line, and returns
(batch, prompt + max_new) tokens below the vocab; ``--trace`` serves a
workload on the paged pool and on dense caches; ``--measure-times``
times each dispatch with a ``RoundClock`` (the ``measured:`` line) in
trace and scenario modes, and ``--bucket-quantum`` buckets the head.
``--slots auto`` picks the reference CLI's width on the same fleet,
``--telemetry`` and ``--chrome-trace`` write a JSONL that validates
against ``repro_torch.obs.schema`` (and feeds the ops report) and a
Chrome trace that loads, and the ``--slots`` refusals print the
reference's messages.
The other configs: reduced granite-3-2b, h2o-danube-3-4b,
moonshot-v1-16b-a3b, paligemma-3b and whisper-tiny generate coded (and
the MoE, sliding-window and ssm ones train), and ``--trace`` on
zamba2-1.2b and on danube exits with the reference's refusal.
Without ``--device`` the CLI runs on CUDA, and raises where there is none
(``tests/test_torch_plan.py``).
"""
import json
import re

import pytest
import torch

from repro.core.runtime_model import ClusterSpec as RefCluster
from repro.core.schemes import make_scheme as ref_make_scheme
from repro.launch import serve as ref_launch_serve
from repro.runtime.control import AdaptiveController as RefController
from repro.runtime.executor import CodedRoundExecutor as RefExecutor
from repro_torch.launch import obsreport
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import padded_vocab
from repro_torch.obs.schema import validate_events

# one intra-op thread: the suite runs test files in parallel worker
# processes, beside the reference's wall-clock tests
torch.set_num_threads(1)

BASE = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "2",
        "--prompt-len", "5", "--max-new", "3"]
HEAD = re.compile(r"coded LM head \[(\w+)\]: kb=(\d+) blocks x 256 rows, "
                  r"\(n,k\)=\((\d+),(\d+)\) rate=[\d.]+, loads/worker=\[[\d, ]+\], "
                  r"deadline=[\d.]+")


@pytest.mark.parametrize("flags,tag", [
    ([], "optimal"),
    (["--scheme", "uniform_r", "--scheme-r", "5"], "uniform_r_group_code"),
    (["--scheme", "comm_aware", "--groups", "6:2.0:4.0,6:0.5:1.0",
      "--comm-upload", "0.01", "--comm-download", "0.001"], "comm_aware"),
])
def test_cli_coded_generate_prints_the_coded_head(capsys, flags, tag):
    out = launch_serve.main(BASE + ["--coded"] + flags)
    text = capsys.readouterr().out
    head = HEAD.search(text)
    assert head is not None and head[1] == tag, text
    assert int(head[3]) >= int(head[4]) == 2  # kb = 512 / 256; n >= k
    assert re.search(r"generated \(2, 8\) in [\d.]+s \([\d.]+ tok/s\)", text), text
    assert out.shape == (2, 8) and int(out.max()) < 512


@pytest.mark.parametrize("dense", [False, True])
def test_cli_trace_serves_every_request(capsys, dense):
    rep = launch_serve.main(BASE + ["--coded", "--trace", "poisson", "--num-requests",
                                    "3", "--slots", "2"] + (["--dense-kv"] if dense else []))
    text = capsys.readouterr().out
    assert "served 3 (0 shed)" in text, text
    assert rep.tokens == sum(len(s) for s in rep.streams.values()) > 0


def test_cli_refuses_flags_of_modules_not_ported(capsys):
    for flag in (["--scenario", "churn"], ["--use-kernel"],
                 ["--slots", "auto"], ["--measure-times"],
                 ["--legacy-decode", "--trace", "poisson"]):
        with pytest.raises(SystemExit):
            launch_serve.main(BASE + flag)
    with pytest.raises(SystemExit):  # not a registered scheme
        launch_serve.main(BASE + ["--scheme", "nope"])


def test_cli_scenario_closed_loop(capsys):
    """``--scenario churn --adapt-every 2``: membership replans at rounds 3
    and 9 of 12 (printed with the new deadline and loads), and the
    controller's summary line."""
    ctl = launch_serve.main(BASE + ["--coded", "--scenario", "churn", "--adapt-every", "2",
                                    "--rounds", "12", "--max-new", "2"])
    text = capsys.readouterr().out
    assert re.search(r"\[round 3\] replanned \(membership\): deadline -> [\d.]+, "
                     r"loads \[(1, ){8}1\]", text), text
    assert "[round 9] replanned (membership)" in text, text
    assert re.search(r"scenario 'churn': 12 rounds, 48 tokens in [\d.]+s", text), text
    line = re.search(r"controller: 6 decisions, (\d+) replans at rounds \[([\d, ]+)\]",
                     text)
    assert line is not None, text
    assert int(line[1]) == ctl.replans and {4, 10} <= {int(r) for r in line[2].split(",")}


def test_cli_scenario_rounds_default_and_open_loop(capsys):
    """Without ``--adapt-every`` the fleet drifts and nothing replans; the
    round count is the reduced budget given."""
    assert launch_serve.main(BASE + ["--coded", "--scenario", "mu_step", "--rounds",
                                     "3"]) is None
    text = capsys.readouterr().out
    assert "scenario 'mu_step': 3 rounds, 18 tokens" in text and "controller" not in text


@pytest.mark.parametrize("flags", [
    ["--scenario", "churn"],                                    # needs --coded
    ["--coded", "--adapt-every", "2"],                          # needs --scenario
    ["--coded", "--scenario", "churn", "--trace", "poisson"],   # two modes
    ["--coded", "--scenario", "nope"],                          # not registered
])
def test_cli_scenario_refusals(flags):
    with pytest.raises(SystemExit):
        launch_serve.main(BASE + flags)


MEASURED = re.compile(r"measured: (\d+)/(\d+) rounds fed, unit_s=[\d.e+-]+")


@pytest.mark.parametrize("dense", [False, True])
def test_cli_trace_measure_times(capsys, dense):
    """Every dispatch of the served trace under the clock; with no
    controller only the warmup round goes unfed, and the streams are the
    unmeasured run's."""
    flags = BASE + ["--coded", "--trace", "poisson", "--num-requests", "3", "--slots", "2"] \
        + (["--dense-kv"] if dense else [])
    plain = launch_serve.main(flags)
    capsys.readouterr()
    rep = launch_serve.main(flags + ["--measure-times", "--bucket-quantum", "4"])
    text = capsys.readouterr().out
    line = MEASURED.search(text)
    assert line is not None and int(line[1]) == int(line[2]) - 1 > 0, text
    assert "served 3 (0 shed)" in text, text
    assert rep.tokens == plain.tokens and set(rep.streams) == set(plain.streams)


def test_cli_scenario_measure_times_bucketed(capsys):
    """``churn`` measured: the membership replans (rebuilds, so their next
    round is not fed) and the ``measured:`` and controller lines."""
    ctl = launch_serve.main(BASE + ["--coded", "--scenario", "churn", "--adapt-every", "2",
                                    "--rounds", "12", "--max-new", "2", "--measure-times",
                                    "--bucket-quantum", "4"])
    text = capsys.readouterr().out
    line = MEASURED.search(text)
    assert line is not None and int(line[2]) == 12, text
    structural = sum(1 for d in ctl.decisions if d.reason == "membership")
    assert structural == 2 and int(line[1]) <= 12 - 1 - structural, text
    assert "replanned (membership)" in text and "controller: " in text, text


@pytest.mark.parametrize("flags", [
    ["--measure-times"],                                        # needs --coded
    ["--measure-times", "--trace", "poisson"],                  # needs --coded
    ["--coded", "--measure-times", "--legacy-decode"],          # times programs
])
def test_cli_measure_times_refusals(flags):
    with pytest.raises(SystemExit):
        launch_serve.main(BASE + flags)


# ------------------------------------------------------------ observability
SLOTS_AUTO = re.compile(r"slots auto -> (\d+) \(coverage latency ([\d.]+)\)")
CHROME = re.compile(r"chrome trace: (\S+) \((\d+) spans\)")


def test_cli_slots_auto_picks_the_reference_width(capsys):
    """The reference CLI asks an ``AdaptiveController`` on its coded head's
    executor (the default fleet, kb blocks of 256 vocab rows); the port's
    CLI prints the same width and coverage latency, and serves at it."""
    rep = launch_serve.main(BASE + ["--coded", "--trace", "poisson", "--num-requests", "3",
                                    "--slots", "auto"])
    text = capsys.readouterr().out
    line = SLOTS_AUTO.search(text)
    assert line is not None, text
    kb = -(-padded_vocab(512) // 256)
    ref = RefController(RefExecutor(RefCluster.parse("6:2.0,6:0.5"), kb,
                                    ref_make_scheme("optimal")))
    assert int(line[1]) == ref.recommend_slots(base=4)
    assert line[2] == f"{ref.coverage_latency():.4f}"
    assert "served 3 (0 shed)" in text and rep.admitted == 3


def _chrome(text):
    line = CHROME.search(text)
    assert line is not None, text
    with open(line[1]) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) == int(line[2]) > 0
    assert all(e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0 for e in events)
    return events


@pytest.mark.parametrize("dense", [False, True])
def test_cli_trace_telemetry_and_chrome_trace(capsys, tmp_path, dense):
    """``--trace`` with both sinks: every JSONL record validates, the spans
    in it are those of the Chrome trace, and the ops report reads it."""
    jsonl, chrome = tmp_path / "t.jsonl", tmp_path / "t.trace.json"
    launch_serve.main(BASE + ["--coded", "--trace", "poisson", "--num-requests", "3",
                              "--slots", "auto", "--telemetry", str(jsonl),
                              "--chrome-trace", str(chrome)]
                      + (["--dense-kv"] if dense else []))
    events = _chrome(capsys.readouterr().out)
    records = obsreport.load_records(str(jsonl))
    assert validate_events(records, source=str(jsonl)) == len(records)
    spans = [r for r in records if r["event"] == "span"]
    assert [r["span"] for r in spans] == [e["name"] for e in events]
    assert {r["span"] for r in spans} == {"admit", "decode_chunk", "dispatch"} | (
        set() if dense else {"prefill_chunk"})
    assert {"request_admitted", "request_done", "metrics_snapshot"} <= {
        r["event"] for r in records}
    obsreport.main([str(jsonl), "--require-spans"])
    assert f"span coverage: {len(spans)} spans" in capsys.readouterr().out


def test_cli_scenario_telemetry_and_chrome_trace(capsys, tmp_path):
    """``--scenario`` measured and closed-loop: the clock's ``round_timing``,
    the controller's decisions and the spans (a ``dispatch`` per generate,
    ``adapt_update`` with the executor's ``replan`` inside) in one JSONL."""
    jsonl, chrome = tmp_path / "s.jsonl", tmp_path / "s.trace.json"
    ctl = launch_serve.main(BASE + ["--coded", "--scenario", "churn", "--adapt-every", "2",
                                    "--rounds", "6", "--max-new", "2", "--measure-times",
                                    "--telemetry", str(jsonl), "--chrome-trace", str(chrome)])
    events = _chrome(capsys.readouterr().out)
    records = obsreport.load_records(str(jsonl))
    validate_events(records, source=str(jsonl))
    names = [r["event"] for r in records]
    assert names.count("round_timing") == 6
    assert names.count("adapt_decision") == len(ctl.decisions) > 0
    spans = [r for r in records if r["event"] == "span"]
    assert len(spans) == len(events)
    assert sum(r["span"] == "dispatch" and r["attrs"]["kind"] == "generate"
               for r in spans) == 6
    assert all(r["parent"] == "adapt_update" for r in spans if r["span"] == "replan")
    assert any(r["span"] == "replan" for r in spans)  # churn's membership replan


def test_cli_generate_chrome_trace(capsys, tmp_path):
    """A plain coded generate traces one ``dispatch`` span."""
    launch_serve.main(BASE + ["--coded", "--chrome-trace", str(tmp_path / "g.json")])
    (event,) = _chrome(capsys.readouterr().out)
    assert event["name"] == "dispatch" and event["args"]["kind"] == "generate"


@pytest.mark.parametrize("flags", [
    ["--slots", "auto"],             # needs --coded
    ["--coded", "--slots", "two"],   # not an int
    ["--slots", "2.5"],
])
def test_cli_slots_refusals_match_reference(flags):
    with pytest.raises(SystemExit) as ref:
        ref_launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--trace", "poisson"]
                              + flags)
    with pytest.raises(SystemExit) as ours:
        launch_serve.main(BASE + ["--trace", "poisson"] + flags)
    assert str(ours.value) == str(ref.value) and "--slots" in str(ours.value)


# ------------------------------------------------------ the other configs
@pytest.mark.parametrize("arch,kb", [("granite-3-2b", 2), ("h2o-danube-3-4b", 2),
                                     ("moonshot-v1-16b-a3b", 2), ("paligemma-3b", 2),
                                     ("whisper-tiny", 2), ("zamba2-1.2b", 2),
                                     ("xlstm-125m", 2)])
def test_cli_coded_generate_on_the_other_configs(capsys, arch, kb):
    """Each new config's reduced variant (vocab 512: kb 2) prints the
    coded-head line and generates; danube, whisper (from the encoder
    output of stub frames), zamba and xlstm through the sequential
    prefill, paligemma text-only."""
    out = launch_serve.main(["--arch", arch] + BASE[2:] + ["--coded"])
    text = capsys.readouterr().out
    head = HEAD.search(text)
    assert head is not None and head[1] == "optimal" and int(head[4]) == kb, text
    assert re.search(r"generated \(2, 8\) in [\d.]+s \([\d.]+ tok/s\)", text), text
    assert out.shape == (2, 8) and int(out.max()) < 512


def test_cli_refuses_a_family_not_ported_and_a_trace_on_danube():
    """``--trace poisson --arch zamba2-1.2b`` (a family the slot and paged
    paths do not take) exits non-zero with the reference's slot-support
    message; ``--trace`` on danube (sliding window) exits with the
    reference's refusal."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.models.model import Model as RefModel

    with pytest.raises(NotImplementedError) as ref:
        RefModel(REF_ARCHS["zamba2-1.2b"].reduced()).init_paged_cache(4, 4)
    with pytest.raises(SystemExit) as err:
        launch_serve.main(["--arch", "zamba2-1.2b"] + BASE[2:]
                          + ["--trace", "poisson", "--num-requests", "2"])
    assert str(err.value) == str(ref.value) and "'hybrid'" in str(err.value)
    with pytest.raises(NotImplementedError) as ref:
        RefModel(REF_ARCHS["h2o-danube-3-4b"].reduced()).init_slot_cache(2, 8)
    for flags in ([], ["--dense-kv"]):
        with pytest.raises(SystemExit) as err:
            launch_serve.main(["--arch", "h2o-danube-3-4b"] + BASE[2:]
                              + ["--trace", "poisson", "--num-requests", "2"] + flags)
        assert str(err.value) == str(ref.value)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "h2o-danube-3-4b"])
def test_cli_trains_the_other_configs(capsys, arch):
    """The training CLI on a reduced MoE and a sliding-window config; the
    ssm family, which it refused before it trained every family, trains
    too."""
    from repro_torch.launch import train as train_cli

    model = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                            "--seq-len", "16", "--batch", "4"])
    out = capsys.readouterr().out
    assert f"training {arch}-smoke" in out and "loss" in out
    assert model.config.name == f"{arch}-smoke" and model.device.type == "cpu"
    model = train_cli.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
                            "--steps", "1", "--seq-len", "8", "--batch", "2"])
    assert "training xlstm-125m-smoke" in capsys.readouterr().out
    assert model.config.family == "ssm"
