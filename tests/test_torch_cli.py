"""The port's serving CLI (``repro_torch.launch.serve``) on the CPU.

Reduced qwen3-0.6b with ``--device cpu``: the coded generate under three
schemes prints the reference's coded-head line (scheme tag, (n, k),
loads, deadline) and the ``generated ... tok/s`` line, and returns
(batch, prompt + max_new) tokens below the vocab; ``--trace`` serves a
workload on the paged pool and on dense caches; ``--measure-times``
times each dispatch with a ``RoundClock`` (the ``measured:`` line) in
trace and scenario modes, and ``--bucket-quantum`` buckets the head.
Without ``--device`` the CLI runs on CUDA, and raises where there is none
(``tests/test_torch_plan.py``).
"""
import re

import pytest
import torch

from repro_torch.launch import serve as launch_serve

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
                 ["--slots", "auto"], ["--measure-times"], ["--telemetry", "x.jsonl"],
                 ["--chrome-trace", "x.json"], ["--legacy-decode"]):
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
    ["--coded", "--measure-times", "--legacy-decode"],          # not ported
])
def test_cli_measure_times_refusals(flags):
    with pytest.raises(SystemExit):
        launch_serve.main(BASE + flags)
