"""The harness on the card at reduced sizes (``-m cuda``; each test skips
where there is no card):

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/tests/test_perfbench_cuda.py
"""
from __future__ import annotations

import pytest
import torch

from perfbench.tests import tinybench

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinybench.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace):
    import io
    import json

    from perfbench import run

    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", "2024", "--seconds", "1",
                   "--trace", str(trace)], root=root, out=out)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny-chat-coded", "tiny-chat-plain", "tiny-stragglers"])
def test_cells_on_the_card(card, root, cell):
    rc, line = _run(root, cell, 0)
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    rc, line = _run(root, cell, 1)
    assert rc == 0 and line["correct"] is True
    dev = line["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105, name
    if cell == "tiny-stragglers":
        assert {"b1.roofline.matvec", "decode.solve_ms.matvec", "matvec.mfu"} <= set(line["metrics"])
    else:
        assert {"b2.roofline", "model.device_ms_per_step", "serve.mfu"} <= set(line["metrics"])
