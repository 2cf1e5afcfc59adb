"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json`` at the checkout's root, its configuration in the file
that names, its traffic mix in ``perfbench/traffic/<traffic>.json``, the
driver of the mix's ``kind`` in ``perfbench/drivers/<kind>.py``, the
correctness limits in ``perfbench/limits/<cell>.json`` and each metric's
reader in ``perfbench/metrics/<metric>.py``. With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
ones. The last lines of standard error, and the line's last key,
``checks``, give every number the correctness check compared with its
limit.

Exit codes: 0 a result was printed; 2 no card, or fewer cards than the
cell asks for; 3 JAX or the JAX package was loaded; 1 anything else.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def load_module(path: Path):
    """A file of the benchmark as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One run of one cell: what it is made of, and what the mix's driver
    module left for the metric readers (``window``, ``profile``, ``spans`` ...)."""

    def __init__(self, root: Path, name: str, seed: int, seconds: float, trace: bool):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
        self.name, self.cell = name, cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = json.loads((self.root / configs[self.cell["config"]]["file"]).read_text())
        self.dir = self.root / "perfbench"
        self.mix = json.loads((self.dir / "traffic" / f"{self.cell['traffic']}.json").read_text())
        limits = self.dir / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = None
        self.t_start = time.perf_counter()
        self._last_mark = None
        self.setup_phases: dict[str, float] = {}
        self.attempted = self.failed = 0
        self.checks: dict[str, tuple[float, float]] = {}
        self.correct = False
        self.memory_peak_bytes = 0
        self.profile = None

    def mark(self, phase: str) -> None:
        """The seconds since the last mark (or the cell's making) as set-up
        phase ``phase``; printed to standard error with the result."""
        now = time.perf_counter()
        since = self.t_start if self._last_mark is None else self._last_mark
        self.setup_phases[phase] = now - since
        self._last_mark = now

    def limit(self, name: str) -> float:
        """The limit of a compared number (``limits/<cell>.json``); a number
        with no limit set fails."""
        entry = self.limits.get(name)
        return float("-inf") if entry is None else float(entry["limit"])

    def metrics(self) -> list[dict]:
        """The cell's metrics of this run's kind: end-to-end with tracing
        off, per-layer with it on. A metric with ``workloads`` belongs to
        those cells; without, an end-to-end one to every cell and a
        per-layer one to every cell that reports the metric it moves."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not self.trace:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in mine)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def prepare(root: Path) -> None:
    """The program's kernel builds and any Triton cache go to fixed paths in
    the checkout, so that only a checkout's first run builds; the program
    and the benchmark import from the checkout."""
    os.environ.setdefault("REPRO_COMPILE_CACHE_DIR", str(root / "build" / "kernels"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    for path in (str(root / "src"), str(root)):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None, *, root: Path | None = None, device: str | None = None,
         out=None) -> int:
    """One run. ``device`` skips the look for a card (tests pass "cpu")."""
    out = out or sys.stdout
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root or ROOT)
    cx = Cell(root, args.workload, args.seed, args.seconds, args.trace)

    import torch

    cx.mark("torch")
    if device is None:
        want = int(cx.cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: the cell needs {want} CUDA device(s), found {have}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        torch.cuda.synchronize()  # the card's context, made in the check
    cx.device = torch.device(device)
    cx.mark("card")
    prepare(root)

    driver = load_module(cx.dir / "drivers" / f"{cx.mix['kind']}.py")
    driver.run(cx)

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3

    metrics = {}
    for m in cx.metrics():
        value = load_module(cx.dir / "metrics" / f"{m['name']}.py").read(cx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cx.device.type == "cuda" else cx.device.type,
           "kind": (torch.cuda.get_device_name(cx.device) if cx.device.type == "cuda"
                    else cx.device.type),
           "count": 1, "memory_peak_bytes": int(cx.memory_peak_bytes)}
    line = {"correct": bool(cx.correct), "attempted": int(cx.attempted),
            "failed": int(cx.failed), "metrics": metrics, "device": dev}
    if cx.trace and cx.profile is not None:
        dev["busy_s"] = cx.profile.busy_s
        dev["window_s"] = cx.profile.window_s
        line["breakdown"] = {"device_ops": cx.profile.top_ops(10),
                             "idle_gaps": cx.profile.idle_gaps(10)}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in cx.checks.items()}
    for phase, secs in cx.setup_phases.items():
        print(f"setup {phase} {secs!r}", file=sys.stderr)
    for k, (v, lim) in cx.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
