"""Per-phase attribution of ``torch.profiler`` captures.

Counterpart of ``repro/obs/profile.py``, with the same API and the same
summary shape. ``capture(dir, name)`` runs one ``torch.profiler`` session
(CPU and, where a card is present, CUDA activities) around a block that
is itself a ``record_function(name)`` range, and writes the session's
Chrome ``trace_event`` JSON to ``<dir>/<name>.pt.trace.json``. One
session per phase, as the reference keeps one ``jax.profiler`` session
per phase: a long session's event volume is what breaks first.

``summarize`` turns the captures under a directory into attribution:

* a phase window is a host ``ph == "X"`` event named after the phase
  (the ``user_annotation`` of its ``record_function``); the device copy
  of that range (``gpu_user_annotation``) is neither a window nor an op;
* when a trace holds device events (``cat`` ``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), those are its ops, and each belongs to the phase whose
  window holds the midpoint of the host event that LAUNCHED it: the
  ``cuda_runtime`` / ``cuda_driver`` event with the same
  ``args["correlation"]`` (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
  ...); one with no such event is filed nowhere. A kernel runs when the
  stream reaches it, often after the host has left the range that
  launched it, so its own time stamps do not say which phase it served.
  ``op_total_us`` and ``ops`` then count device time;
* a trace with no device events (a CPU capture, or the reference's XLA
  layout) keeps the reference's rule: every other ``X`` event is an op,
  filed under the window that holds its midpoint. Annotations
  (``user_annotation``, the profiler's own ``Trace`` span,
  ``ProfilerStep#...``) and flow events are never ops.

Reads the torch layout (``*.pt.trace.json[.gz]`` from ``capture``,
``export_chrome_trace`` or ``tensorboard_trace_handler``) and the
reference's ``plugins/profile/*/*.trace.json.gz``. Stdlib-only parsing;
torch is imported only by ``capture``.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os

__all__ = ["capture", "find_trace_file", "find_trace_files", "load_trace_events",
           "summarize", "TOP_K"]

#: ops kept per phase in summaries
TOP_K = 5

#: device-timeline categories: the ops of a trace that holds any of them
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: host categories of the calls that launch device work
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
#: annotation categories: never ops (only a host one is a phase window)
ANNOTATION_CATS = frozenset({"user_annotation", "gpu_user_annotation", "Trace"})


@contextlib.contextmanager
def capture(profile_dir: str, name: str):
    """``with capture(dir, "serve_paged"): ...`` — one profiler session whose
    block is the phase window ``name``; yields the ``torch.profiler.profile``.

    The card (when there is one) is synchronized before the window opens
    and before it closes, so the window holds all the device work the
    block launched and none from before it. Writes
    ``<profile_dir>/<name>.pt.trace.json`` when the block returns.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        sync()
        with record_function(name):
            yield prof
            sync()
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.pt.trace.json"))


def find_trace_files(profile_dir: str) -> list[str]:
    """Every ``*.trace.json[.gz]`` under a profile dir, sorted by mtime.

    Each phase is captured in its own session (``capture``), so summaries
    merge all captures under the dir.
    """
    hits = set()
    for pattern in ("*.trace.json", "*.trace.json.gz"):
        hits.update(glob.glob(os.path.join(profile_dir, "**", pattern), recursive=True))
    return sorted(hits, key=lambda p: (os.path.getmtime(p), p))


def find_trace_file(profile_dir: str) -> str | None:
    """Newest ``*.trace.json[.gz]`` under a profile dir."""
    hits = find_trace_files(profile_dir)
    return hits[-1] if hits else None


def load_trace_events(trace_path: str) -> list[dict]:
    """The ``traceEvents`` list of a (gzipped) Chrome trace JSON."""
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        doc = json.load(f)
    return doc.get("traceEvents", [])


def _is_phase(name: str, phase: str) -> bool:
    # annotation names may carry a '#metadata#' suffix in XLA traces
    return name == phase or name.startswith(phase + "#")


def _mid(e: dict) -> float:
    return e["ts"] + e["dur"] / 2.0


def _attribute(events: list[dict], phases):
    """One trace's phase windows and its ops, each op with the time stamp
    that files it: ``({phase: [(lo, hi)]}, [(op event, t)])``.

    Time stamps are only compared WITHIN a trace (windows against
    launch points or midpoints), so merging captures with different
    time bases is sound.
    """
    windows: dict[str, list[tuple[float, float]]] = {p: [] for p in phases}
    host, device = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("dur") is None:
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(e)
            continue
        if cat == "gpu_user_annotation":
            continue
        name = e.get("name", "")
        for p in phases:
            if _is_phase(name, p):
                windows[p].append((e["ts"], e["ts"] + e["dur"]))
                break
        else:
            host.append(e)
    if device:
        launches = {e["args"]["correlation"]: e for e in host
                    if e.get("cat") in LAUNCH_CATS and "correlation" in (e.get("args") or {})}
        ops = []
        for d in device:
            launch = launches.get((d.get("args") or {}).get("correlation"))
            if launch is not None:
                ops.append((d, _mid(launch)))
        return windows, ops
    ops = [(e, _mid(e)) for e in host
           if e.get("cat") not in ANNOTATION_CATS
           and not e.get("name", "").startswith("ProfilerStep#")]
    return windows, ops


def summarize(profile_dir: str, phases, *, top_k: int = TOP_K,
              events: bool = False) -> dict:
    """Per-phase wall time + top-K op totals from profiler captures.

    Returns ``{phase: {"wall_us", "op_total_us", "n_ops", "ops":
    [{"name", "total_us", "count"}, ...]}}`` for every phase whose
    window appears in ANY trace under ``profile_dir``. Ops are filed as
    the module docstring says: device events by their launch, otherwise
    host events by their midpoint. Host events nest, so in a trace with
    no device events the totals are an attribution signal consistent
    between captures, not an exclusive decomposition;
    device events on one stream do not overlap. ``events=True`` also
    keeps each phase's filed op events, raw (``args`` included, e.g. a
    kernel's ``grid``), under ``"events"``.
    """
    out: dict[str, dict] = {}
    trace_paths = find_trace_files(profile_dir)
    if not trace_paths:
        raise FileNotFoundError(
            f"no profiler capture (*.trace.json[.gz]) under {profile_dir}"
        )
    for trace_path in trace_paths:
        windows, ops = _attribute(load_trace_events(trace_path), phases)
        for p, wins in windows.items():
            if not wins:
                continue
            summ = out.setdefault(p, {
                "wall_us": 0.0, "op_total_us": 0.0, "n_ops": 0, "ops": {},
                **({"events": []} if events else {}),
            })
            summ["wall_us"] += sum(hi - lo for lo, hi in wins)
        for e, t in ops:
            for p, wins in windows.items():
                if wins and any(lo <= t <= hi for lo, hi in wins):
                    summ = out[p]
                    summ["op_total_us"] += e["dur"]
                    summ["n_ops"] += 1
                    agg = summ["ops"].setdefault(
                        e["name"], {"total_us": 0.0, "count": 0}
                    )
                    agg["total_us"] += e["dur"]
                    agg["count"] += 1
                    if events:
                        summ["events"].append(e)
    for summ in out.values():
        summ["ops"] = [
            {"name": n, **v}
            for n, v in sorted(
                summ["ops"].items(),
                key=lambda kv: kv[1]["total_us"],
                reverse=True,
            )[:top_k]
        ]
    return out
