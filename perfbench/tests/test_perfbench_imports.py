"""What the benchmark's files import: nothing of JAX or the JAX package
anywhere (top-level names compared whole: ``repro_torch`` is not
``repro``), and nothing of the program in the references and in the
yardstick's own arithmetic."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: files that judge or count: the program's modules are not theirs to import
INDEPENDENT = ["reference/llama.py", "reference/matvec.py", "weights.py", "gen.py",
               "roofline.py", "profiling.py", "schedule.py"]


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def benchmark_imports(path: Path) -> set[str]:
    """The benchmark's own modules a file imports (``perfbench.x``, or
    ``from perfbench import x``), as paths relative to ``perfbench/``."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            parts = node.module.split(".")
            if parts[0] != "perfbench":
                continue
            if len(parts) > 1:
                out.add("/".join(parts[1:]) + ".py")
            else:
                out |= {f"{a.name}.py" for a in node.names}
    return out


@pytest.mark.parametrize("rel", INDEPENDENT)
def test_references_import_nothing_of_the_program(rel):
    assert "repro_torch" not in top_level_imports(PB / rel)
    # nor a file of the benchmark that could
    assert benchmark_imports(PB / rel) <= set(INDEPENDENT)


def test_a_run_loads_no_jax(tmp_path):
    from perfbench import run
    from perfbench.tests import tinybench

    root = tinybench.make_root(tmp_path)
    rc, _ = tinybench.run_cell(root, "tiny-chat-coded")
    assert rc == 0 and run.forbidden_modules() == []
