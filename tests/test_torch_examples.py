"""The four ``examples/torch_*.py`` on the CPU at small sizes: each runs to
its end and its own check holds (the coded matvec recovers A x, coded
tokens equal uncoded ones, both replans happen, the loss falls)."""
import importlib.util
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
RUNS = [
    ("torch_quickstart", ["--trials", "500", "--k", "2000"],
     ["optimal (n*, k) MDS code", "coded matvec with 2 erasures: recovered=True"]),
    ("torch_coded_serving", ["--max-new", "6", "--trials", "50"],
     ["coded LM head: V=512", "coded == uncoded greedy outputs: True"]),
    ("torch_elastic_fleet", ["--trials", "500"],
     ["replans=1", "replans=2", "achieved latency"]),
    ("torch_train_lm", ["--reduced", "--steps", "20", "--seq", "8", "--min-drop", "0.2"],
     ["loss trajectory", "final loss"]),
]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,args,lines", RUNS, ids=[r[0] for r in RUNS])
def test_example_runs_on_cpu(name, args, lines, capsys):
    assert _load(name).main(["--device", "cpu", *args]) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, line


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only refusal")
@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_example_defaults_to_the_card(name):
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        _load(name).main([])
