"""Step-level telemetry: timing EMAs, tokens/s, events, JSONL sink.

The port's own copy of ``repro/runtime/telemetry.py`` (same records, same
JSONL). ``Telemetry`` is a context manager so file handles close
deterministically::

    with Telemetry(path) as tel:
        tel.tick(); tel.log(step, metrics)
        tel.event("all_workers_missed_deadline", step=step)

Every event record carries a monotonic ``t`` sequence number per sink
and a ``wall_s`` ``perf_counter`` stamp. ``max_events`` bounds the
in-memory event window (a ring buffer); the JSONL sink stays complete.
"""
from __future__ import annotations

import json
import time
from collections import deque


class Telemetry:
    def __init__(self, path: str | None = None, ema: float = 0.9,
                 max_events: int | None = None):
        if max_events is not None and max_events <= 0:
            raise ValueError(f"max_events must be > 0, got {max_events}")
        self.path = path
        self.ema = ema
        self.step_time: float | None = None
        self._last: float | None = None
        self.events = deque(maxlen=max_events) if max_events is not None else []
        self._event_t = 0
        self._fh = open(path, "a") if path else None

    def tick(self) -> float | None:
        """Call once per step; returns the smoothed step time."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = (
                dt if self.step_time is None
                else self.ema * self.step_time + (1 - self.ema) * dt
            )
        self._last = now
        return self.step_time

    def log(self, step: int, metrics: dict, tokens_per_step: int | None = None):
        """One metric record; values that are not float-able are kept as str."""
        rec = {"step": step}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self.step_time is not None and tokens_per_step is not None:
            rec["tokens_per_s"] = (
                tokens_per_step / self.step_time if self.step_time > 0 else float("inf")
            )
        self._write(rec)
        return rec

    def event(self, name: str, **fields) -> dict:
        """Record a discrete runtime event (degraded step, replan, ...)."""
        rec = {"event": name, "t": self._event_t, "wall_s": time.perf_counter(), **fields}
        self._event_t += 1
        self.events.append(rec)
        self._write(rec)
        return rec

    def _write(self, rec: dict) -> None:
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
