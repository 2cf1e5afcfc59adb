"""The harness end to end on reduced cells, on the CPU: the result line,
the refusals, and cells, mixes, configurations and metrics added as
files of their own."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.tests import tinybench

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinybench.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["tiny-chat-coded", "tiny-chat-plain", "tiny-stragglers"])
def test_one_command_prints_the_contract_line(root, cell, trace):
    rc, line = tinybench.run_cell(root, cell, seed=2**33 + 7, trace=trace)
    assert rc == 0
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        # on the CPU no device metric is written; the counter and span ones are
        assert "busy_s" in line["device"] and "breakdown" in line
        allowed = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
        assert set(line["metrics"]) <= allowed
        if cell != "tiny-stragglers":
            assert "sched.slot_fill" in set(line["metrics"])
    else:
        want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]


def test_profiled_dispatches_are_reconstructed(root):
    """The traced serve call's profiled dispatches are worked out from the
    program's spans and events, and agree with what it emitted."""
    import torch

    from perfbench import run, schedule, served

    cx = run.Cell(root, "tiny-chat-coded", 777, 0.3, True)
    cx.device = torch.device("cpu")
    drv = run.load_module(cx.dir / "drivers" / "serve.py")
    kw = drv.serve_kwargs(cx.mix, cx.config)
    srv = drv.make_server(cx, drv.make_model(cx, 777))
    drv.warmup(cx, srv, kw)
    cx.profiled, cx.profiler = drv.profiled_call(cx, srv, kw, 0)
    call = cx.profiled
    assert cx.profiler.profiled == [2, 3, 4, 5]
    reqs = {r.rid: (r.prompt_len, r.out_len) for r in call.trace}
    every = schedule.reconstruct(served.chunks(call), call.admitted, reqs,
                                 kw["prefill_chunk"], kw["decode_block"])
    assert sum(d.steps * len(d.decode) for d in every) == call.decoded
    assert served.work(cx) == [every[i] for i in cx.profiler.profiled]


def test_no_card_no_result(root, capsys):
    import torch

    from perfbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    rc = run.main(["--workload", "tiny-stragglers", "--seed", "1", "--seconds", "1"],
                  root=root)
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the files under paths has
    no program to run: non-zero, and no result line."""
    bare = tmp_path / "bare"
    full = tinybench.make_root(tmp_path)
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((full / "BENCHMARK.json").read_text())
    shutil.copytree(full / "perfbench", bare / "perfbench")
    code = ("import sys; sys.path.insert(0, '.'); from perfbench import run; "
            "sys.exit(run.main(['--workload', 'tiny-stragglers', '--seed', '1', "
            "'--seconds', '0.2'], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=bare, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "repro_torch" in p.stderr


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("what", ["mix", "config", "metric"])
def test_a_cell_mix_config_or_metric_is_added_as_files(tmp_path, what):
    """A new cell on a new mix, a new configuration, or a new per-layer
    metric is files and entries added: no file that was there changes."""
    root = tinybench.make_root(tmp_path)
    bench_path = root / "BENCHMARK.json"
    before = {p: d for p, d in _digests(root).items() if p != bench_path}
    bench = json.loads(bench_path.read_text())
    pb = root / "perfbench"
    cell = {"name": "tiny-new", "config": "tiny-dense", "traffic": "tiny-chat", "chips": 1,
            "why": "added"}
    if what == "mix":
        mix = {**tinybench.TINY_CHAT, "name": "tiny-burst", "slots": 2, "requests": 4}
        (pb / "traffic" / "tiny-burst.json").write_text(json.dumps(mix))
        cell["traffic"] = "tiny-burst"
    elif what == "config":
        cfg = {**tinybench.TINY_DENSE, "name": "tiny-deep", "num_hidden_layers": 3}
        (pb / "configs" / "tiny-deep.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": "tiny-deep", "source": "test",
                                 "file": "perfbench/configs/tiny-deep.json", "reduced": [],
                                 "why": "added"})
        cell["config"] = "tiny-deep"
    else:
        (pb / "metrics" / "sched.requests_per_call.py").write_text(
            "def read(cx):\n    return sum(c.offered for c in cx.window) / len(cx.window)\n")
        bench["per_layer"].append({"name": "sched.requests_per_call", "unit": "requests",
                                   "better": "higher", "source": "program_counter",
                                   "layer": "scheduler (serve/scheduler.py)",
                                   "moves": "tokens_per_s", "workloads": ["tiny-new"]})
    bench["workloads"].append(cell)
    for m in bench["end_to_end"]:
        if m["name"] == "tokens_per_s":
            m["workloads"].append("tiny-new")
    (pb / "limits" / "tiny-new.json").write_text(json.dumps(tinybench.LIMITS["tiny-chat-coded"]))
    bench_path.write_text(json.dumps(bench))
    rc, line = tinybench.run_cell(root, "tiny-new", trace=int(what == "metric"))
    assert rc == 0 and line["correct"] is True
    if what == "metric":
        assert line["metrics"]["sched.requests_per_call"]["value"] == 6
    else:
        assert "tokens_per_s" in line["metrics"]
    after = _digests(root)
    assert {p: after[p] for p in before} == before
