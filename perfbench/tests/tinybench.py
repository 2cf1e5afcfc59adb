"""A checkout of the benchmark at sizes the CPU tests can hold.

``make_root(tmp)`` copies ``perfbench/`` and links ``src/`` into ``tmp``,
adds reduced configurations, mixes and limits beside the real ones, and
writes a ``BENCHMARK.json`` whose cells use them. Its metrics are the
real file's, each moved to the reduced cells that stand for its own,
and the serve metrics (``SERVE_METRICS``), which the real file lists
once it has a serve cell.
"""
from __future__ import annotations

import io
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "perfbench"

TINY_DENSE = {
    "name": "tiny-dense", "source": "reduced yi-9b for CPU tests",
    "hidden_act": "silu", "hidden_size": 128, "intermediate_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
    "vocab_size": 512, "max_position_embeddings": 256, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "tie_word_embeddings": True,
    "param_dtype": "bfloat16", "compute_dtype": "bfloat16", "kv_cache_gib": 0.0002,
    "coded_head": {"scheme": "optimal", "workers": [6, 6], "mu": [8.0, 0.7],
                   "alpha": 1.0, "block_rows": 32, "deadline_safety": 3.0},
}
TINY_PATHM = {
    "name": "tiny-pathm", "source": "reduced Path M for CPU tests", "k": 96, "d": 64,
    "dtype": "float32", "workers": [4, 4], "mu": [4.0, 1.0], "alpha": 1.0,
    "scheme": "optimal", "deadline_safety": 3.0,
}
TINY_CHAT = {
    "name": "tiny-chat", "kind": "serve", "head": "coded", "slots": 4, "decode_block": 4,
    "prefill_chunk": 16, "requests": 6, "prompt_len": [8, 40],
    "out_len_mix": [[[2, 6], 0.6667], [[10, 16], 0.3333]], "rate_factor": 1.2,
    "profile_from": 2, "profile_dispatches": 4,
    "check": {"tokens": 1000, "requests": 12},
}
TINY_STRAGGLERS = {"name": "tiny-stragglers", "kind": "matvec", "warmup_queries": 2,
                   "profile_queries": 2, "check": {"queries": 8}}
#: real cell -> the reduced cell that stands for it
CELLS = {
    "pathm-stragglers": ("tiny-stragglers", "tiny-pathm", "tiny-stragglers"),
}
#: the serve cells, which no real cell stands for yet: (cell, config, mix)
SERVE_CELLS = [("tiny-chat-coded", "tiny-dense", "tiny-chat"),
               ("tiny-chat-plain", "tiny-dense", "tiny-chat-plain")]
_CHAT = ["tiny-chat-coded", "tiny-chat-plain"]
_CODED = ["tiny-chat-coded"]


def _layer(name, unit, better, source, layer, cells):
    return {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
            "moves": "tokens_per_s", "workloads": list(cells)}


#: the serve cells' metrics, with each reader in ``perfbench/metrics/``
SERVE_METRICS = {
    "end_to_end": [{"name": "tokens_per_s", "unit": "tokens/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": list(_CHAT)}],
    "per_layer": [
        _layer("sched.slot_fill", "%", "higher", "program_counter",
               "scheduler (serve/scheduler.py)", _CHAT),
        _layer("model.device_ms_per_step", "ms", "lower", "device_trace",
               "model step (models/model.py, models/attention.py, models/layers.py)", _CHAT),
        _layer("b2.roofline", "%", "higher", "device_trace",
               "kernel B2 (kernels/paged_attention)", _CHAT),
        _layer("b1.roofline.serve", "%", "higher", "device_trace",
               "kernel B1 (kernels/coded_matvec)", _CODED),
        _layer("head.solve_ms.serve", "ms", "lower", "device_trace",
               "coded head (runtime/serve_loop.CodedLMHead, core/coding.decode_systematic)",
               _CODED),
        _layer("device.idle_share.serve", "%", "lower", "device_trace", "device", _CHAT),
        _layer("serve.mfu", "%", "higher", "device_trace", "whole step", _CHAT),
    ],
}
#: the reduced cells' limits, from CPU readings of seeds 1, 2, 3 (program
#: gap 0.0007 to 0.0018, float8 control 0.042 to 0.078; program error over
#: the plain float32 coded matvec's 1.0, the TF32 control's 4,123 to 4,447)
LIMITS = {"tiny-chat-coded": {"max_gap": {"limit": 0.012}},
          "tiny-chat-plain": {"max_gap": {"limit": 0.012}},
          "tiny-stragglers": {"err_ratio": {"limit": 20.0}}}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(PB, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(REPO / "src")
    pb = root / "perfbench"
    _write(pb / "configs" / "tiny-dense.json", TINY_DENSE)
    _write(pb / "configs" / "tiny-pathm.json", TINY_PATHM)
    _write(pb / "traffic" / "tiny-chat.json", TINY_CHAT)
    _write(pb / "traffic" / "tiny-chat-plain.json", {**TINY_CHAT, "name": "tiny-chat-plain",
                                                      "head": "plain"})
    _write(pb / "traffic" / "tiny-stragglers.json", TINY_STRAGGLERS)
    for cell, limits in LIMITS.items():
        _write(pb / "limits" / f"{cell}.json", limits)
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = {**real,
             "configs": [{"name": n, "source": c["source"], "file": f"perfbench/configs/{n}.json",
                          "reduced": [], "why": "CPU test"}
                         for n, c in (("tiny-dense", TINY_DENSE), ("tiny-pathm", TINY_PATHM))],
             "workloads": [{"name": cell, "config": cfg, "traffic": traffic, "chips": 1,
                            "why": "CPU test"}
                           for cell, cfg, traffic in [*CELLS.values(), *SERVE_CELLS]]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[w][0] for w in m["workloads"] if w in CELLS]
    for kind, metrics in SERVE_METRICS.items():
        bench[kind] += [dict(m, workloads=list(m["workloads"])) for m in metrics]
    _write(root / "BENCHMARK.json", bench)
    return root


def run_cell(root: Path, cell: str, seed: int = 12345, seconds: float = 0.5,
             trace: int = 0) -> tuple[int, dict | None]:
    """``run.main`` on the CPU; (exit code, the printed last line)."""
    from perfbench import run

    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], root=root, device="cpu", out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
