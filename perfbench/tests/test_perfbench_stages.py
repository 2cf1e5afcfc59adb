"""The readers of Path M's stage spans (``perfbench/stages.py``, the
``pathm.*`` metrics): on the CPU, a traced run carries the span metrics,
each run of a process reads only its own profiled queries, a traced serve
run's solves record no stage, and a program without stage spans
reads as nothing; on the card (``-m cuda``, skipped elsewhere), all six
metrics, the solve's stages inside the decode:

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/tests/test_perfbench_stages.py

On the CPU ``pathm.stage_idle_ms`` is left out, as every device-trace
reader is: a CPU trace holds no device operation.
"""
from __future__ import annotations

import types

import pytest
import torch

from perfbench import stages
from perfbench.tests import tinybench

SPAN_METRICS = {"pathm.products_ms": "pathm.products", "pathm.decode_ms": "pathm.decode",
                "pathm.gather_ms": "decode.gather", "pathm.lu_ms": "decode.lu",
                "pathm.trisolve_ms": "decode.trisolve"}
PROFILED = tinybench.TINY_STRAGGLERS["profile_queries"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinybench.make_root(tmp_path_factory.mktemp("bench"))


def _own_queries() -> dict:
    """Each span metric over the last ``PROFILED`` queries in ``STAGES``,
    worked out here from the spans, and the roots' ids."""
    from repro_torch.obs.trace import STAGES

    spans = list(STAGES.spans)
    roots = [s for s in spans if s.name == "pathm.query"][-PROFILED:]
    ids = {r.id for r in roots}
    mids = {s.id for s in spans if s.parent_id in ids}
    want = {}
    for metric, name in SPAN_METRICS.items():
        mine = [s for s in spans if s.name == name and (s.parent_id in ids | mids)]
        assert len(mine) == PROFILED
        want[metric] = sum(s.device_s for s in mine) * 1e3 / PROFILED
    return want, ids


def test_each_run_reads_its_own_profiled_queries(root):
    from repro_torch.obs.trace import STAGES

    rc, first = tinybench.run_cell(root, "tiny-stragglers", seed=2**33 + 11, trace=1)
    assert rc == 0 and first["correct"] is True
    want_first, ids_first = _own_queries()
    # a traced serve run's solves run outside any pathm.query
    n = len(STAGES.spans)
    rc, _ = tinybench.run_cell(root, "tiny-chat-coded", seed=5, trace=1)
    assert rc == 0
    assert len(STAGES.spans) == n
    rc, second = tinybench.run_cell(root, "tiny-stragglers", seed=17, trace=1)
    assert rc == 0 and second["correct"] is True
    want_second, ids_second = _own_queries()
    assert not ids_first & ids_second
    for line, want in ((first, want_first), (second, want_second)):
        got = {k: v["value"] for k, v in line["metrics"].items() if k.startswith("pathm.")}
        assert got == pytest.approx(want, rel=1e-12, abs=0)
        solve = got["pathm.gather_ms"] + got["pathm.lu_ms"] + got["pathm.trisolve_ms"]
        assert 0 < solve <= got["pathm.decode_ms"]


def test_a_program_without_stage_spans_reads_nothing(monkeypatch):
    from repro_torch.obs import trace

    cx = types.SimpleNamespace(profile=object(), profiled_queries=PROFILED)
    monkeypatch.delattr(trace, "STAGES")
    assert stages.profiled(cx) is None and stages.device_ms(cx, "pathm.decode") is None
    assert stages.device_ms(types.SimpleNamespace(profile=None), "pathm.decode") is None


@pytest.mark.cuda
def test_stage_metrics_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import io
    import json

    from perfbench import run

    out = io.StringIO()
    rc = run.main(["--workload", "tiny-stragglers", "--seed", "2025", "--seconds", "1",
                   "--trace", "1"], root=root, out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(SPAN_METRICS) | {"pathm.stage_idle_ms"} <= set(got)
    solve = got["pathm.gather_ms"] + got["pathm.lu_ms"] + got["pathm.trisolve_ms"]
    assert 0 < solve <= got["pathm.decode_ms"] * 1.0001
    assert got["pathm.stage_idle_ms"] >= 0
