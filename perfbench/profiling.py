"""Device traces of a few steady rounds or queries, and what they reduce to.

``Window`` is one ``torch.profiler`` session opened and closed by the
harness around a few dispatches of the timed path: the card is
synchronised before it closes, the window itself is a host annotation
(``pb.window``), and the harness's own annotations name what the host
was doing. ``DeviceTrace`` reads the session's Chrome trace back: the
device operations (kernels, copies, sets) inside the window, their
union (the seconds the card was busy), and the gaps between them, each
named by the innermost host annotation open at its middle.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

#: device-timeline categories of a torch (kineto) Chrome trace
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
WINDOW = "pb.window"


class Window:
    """A profiler session the caller opens and closes (``start``/``stop``),
    possibly from inside callbacks of the timed path."""

    def __init__(self):
        self._prof = None
        self._range = None
        self.trace: DeviceTrace | None = None

    @property
    def open(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + ([ProfilerActivity.CUDA] if cuda else []))
        self._prof.start()
        self._range = record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = self._range = None
        self.trace = DeviceTrace(events)


def annotate(name: str):
    """A host annotation for the trace (a no-op context outside a session
    costs one profiler check)."""
    from torch.profiler import record_function

    return record_function(name)


@dataclasses.dataclass
class DeviceTrace:
    """Device operations and host annotations inside the window."""

    ops: list  # (name, start_us, dur_us), device operations in the window
    notes: list  # (name, start_us, end_us), host annotations in the window
    t0: float
    t1: float

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and e.get("dur") is not None]
        win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("profiler trace holds no window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.ops = sorted(((e["name"], float(e["ts"]), float(e["dur"])) for e in xs
                           if e.get("cat") in DEVICE_CATS
                           and self.t0 <= float(e["ts"]) <= self.t1), key=lambda o: o[1])
        self.notes = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in xs if e.get("cat") == "user_annotation"
                      and e.get("name") != WINDOW and self.t0 <= float(e["ts"]) <= self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self) -> list[tuple[float, float]]:
        spans = []
        for _, ts, dur in self.ops:
            lo, hi = max(ts, self.t0), min(ts + dur, self.t1)
            if hi <= lo:
                continue
            if spans and lo <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], hi)
            else:
                spans.append([lo, hi])
        return [(lo, hi) for lo, hi in spans]

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self._busy()) * 1e-6

    def seconds(self, pattern: str | None = None, *, exclude: str | None = None) -> float:
        """Summed device seconds of the operations whose name matches
        ``pattern`` (all when None) and not ``exclude``."""
        inc = re.compile(pattern) if pattern else None
        exc = re.compile(exclude) if exclude else None
        return sum(dur for name, _, dur in self.ops
                   if (inc is None or inc.search(name))
                   and (exc is None or not exc.search(name))) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        """The ``n`` device operations (by name) that took most time."""
        total: dict[str, float] = {}
        for name, _, dur in self.ops:
            total[name] = total.get(name, 0.0) + dur * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time by what the host was doing: each gap between
        busy spans (and at the window's ends) is named by the innermost
        harness annotation open at its middle ("host" when none), summed
        by name; the ``n`` largest."""
        busy = self._busy()
        edges = [self.t0] + [x for span in busy for x in span] + [self.t1]
        total: dict[str, float] = {}
        for lo, hi in zip(edges[0::2], edges[1::2]):
            if hi <= lo:
                continue
            mid = (lo + hi) / 2
            open_ = [(s, name) for name, s, e in self.notes if s <= mid <= e]
            name = max(open_)[1] if open_ else "host"
            total[name] = total.get(name, 0.0) + (hi - lo) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
