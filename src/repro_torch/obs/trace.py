"""Span tracing: nested, low-overhead wall-clock spans.

The port's own copy of ``repro/obs/trace.py``. ``SpanTracer`` records
host-side phases: the round executor wraps each ``replan`` and the
adaptive controller each ``adapt_update`` decision, so a replan nests
inside the decision that caused it when both share one tracer. Every
span is

* kept **in memory** (``tracer.spans``, a bounded ring),
* mirrored to a ``Telemetry`` JSONL stream (when the tracer owns one)
  as a ``span`` event with ``perf_counter`` stamps (``t0_s`` start,
  ``dur_s`` duration), and
* exportable to **Chrome ``trace_event`` JSON** (``export_chrome``),
  loadable in Perfetto or ``chrome://tracing``.

A span costs two ``perf_counter`` calls and one append (plus one JSONL
line with telemetry). Code that may run untraced holds ``NULL_TRACER``,
whose ``span()`` returns one shared no-op context manager. Each span has
an ``id`` unique in its tracer and its enclosing span's ``parent_id``.

``stage(name, device)`` opens a span of the process-wide ``STAGES``
tracer around a stage of Path M's master step: the root ``pathm.query``
(``root=True``), and under it the products, the decode and the solve's
gather, LU and triangular solves. A stage span is live only while a
``torch.profiler`` session records (``obs.profile.capture`` or the
profiler itself), the current stream is not capturing a CUDA graph and,
unless it is a root, a root is open, so the serve head's solve records
nothing; otherwise ``stage`` returns the shared no-op after one profiler
check. A live one is a ``StageSpan``: a ``record_function`` range of its
name, so it sits on the profiler's clock beside the kernels, and on a
CUDA device a pair of timing events on the current stream, whose
``device_s`` waits for the end event when first read. On the CPU, where
ops run synchronously, a stage's device time is its host duration. A
stage's ``set`` attaches attributes, device tensors among them (the
solve's count of erased rows); ``host_attrs`` reads them on first read.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import time
from collections import deque

import torch

__all__ = ["Span", "StageSpan", "SpanTracer", "NullTracer", "NULL_TRACER", "STAGES",
           "stage", "spans_to_chrome"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span: name + wall stamps + nesting + attributes."""

    name: str
    t0_s: float  # perf_counter at entry
    dur_s: float
    depth: int  # 0 = top-level
    parent: str | None  # enclosing span's name (None at depth 0)
    attrs: dict
    id: int = 0  # unique in its tracer
    parent_id: int | None = None  # enclosing span's id (None at depth 0)


@dataclasses.dataclass(frozen=True)
class StageSpan(Span):
    """A finished stage span with its CUDA timing events (None on the CPU)."""

    events: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @functools.cached_property
    def host_attrs(self) -> dict:
        """``attrs`` with each tensor read to a Python number (from the
        card, on first read)."""
        return {k: v.item() if torch.is_tensor(v) else v for k, v in self.attrs.items()}

    @functools.cached_property
    def device_s(self) -> float:
        """Seconds on the card between the events, waiting for the end one
        when first read; on the CPU the host duration."""
        if self.events is None:
            return self.dur_s
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end) * 1e-3


class _NullSpan:
    """Shared no-op context manager: the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        """Attribute setter, ignored (parity with ``_ActiveSpan.set``)."""


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing disabled: every ``span()`` is the same shared no-op."""

    enabled = False
    spans: tuple = ()

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN


NULL_TRACER = NullTracer()


class _ActiveSpan:
    """Context manager recording one span into its tracer on exit."""

    __slots__ = ("_tracer", "name", "attrs", "id", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. placed count)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_ActiveSpan":
        self.id = next(self._tracer._ids)
        self._tracer._stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        tracer = self._tracer
        stack = tracer._stack
        stack.pop()
        span = Span(
            name=self.name,
            t0_s=self._t0,
            dur_s=t1 - self._t0,
            depth=len(stack),
            parent=stack[-1].name if stack else None,
            attrs=self.attrs,
            id=self.id,
            parent_id=stack[-1].id if stack else None,
        )
        tracer.spans.append(span)
        tel = tracer.telemetry
        if tel is not None:
            tel.event(
                "span",
                span=span.name,
                t0_s=span.t0_s,
                dur_s=span.dur_s,
                depth=span.depth,
                parent=span.parent,
                attrs=span.attrs,
            )
        return False  # never swallow exceptions

    # exceptions propagate; the span still records its wall time, so a
    # crashing dispatch leaves a trace of where the run died


class SpanTracer:
    """Nested wall-clock spans over an optional ``Telemetry`` sink.

    One tracer per control loop (serve run, trainer); sharing it with
    the loop's executor/controller puts their replan/decision spans on
    the same nesting stack. Not thread-safe — the loops it instruments
    are single-threaded host code.
    """

    enabled = True

    def __init__(self, telemetry=None, *, max_spans: int = 100_000):
        if max_spans <= 0:
            raise ValueError(f"max_spans must be > 0, got {max_spans}")
        self.telemetry = telemetry
        #: finished spans, oldest dropped past ``max_spans`` (the JSONL
        #: sink, when present, keeps every span regardless)
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self._stack: list[_ActiveSpan] = []
        self._ids = itertools.count(1)

    def span(self, name: str, **attrs) -> _ActiveSpan:
        """``with tracer.span("decode_chunk", steps=4): ...``"""
        return _ActiveSpan(self, name, attrs)

    # ------------------------------------------------------------- export
    def summary(self) -> dict:
        """Per-name aggregate: count, total/mean/max seconds."""
        agg: dict[str, dict] = {}
        for s in self.spans:
            a = agg.setdefault(
                s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            a["count"] += 1
            a["total_s"] += s.dur_s
            a["max_s"] = max(a["max_s"], s.dur_s)
        for a in agg.values():
            a["mean_s"] = a["total_s"] / a["count"]
        return agg

    def export_chrome(self, path: str) -> str:
        """Write the recorded spans as Chrome ``trace_event`` JSON."""
        recs = [
            {"span": s.name, "t0_s": s.t0_s, "dur_s": s.dur_s,
             "depth": s.depth, "parent": s.parent, "attrs": s.attrs}
            for s in self.spans
        ]
        return spans_to_chrome(recs, path)


#: Path M's stage spans in this process (kept while a profiler records)
STAGES = SpanTracer(max_spans=4096)
_profiling = torch._C._autograd._profiler_enabled


class _StageSpan:
    """A live stage span of ``STAGES``: a ``record_function`` range and,
    on a CUDA device, a timing event on the current stream at each end,
    recorded outside the range."""

    __slots__ = ("name", "id", "attrs", "_device", "_range", "_start", "_t0")

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.attrs = {}
        self._device = device

    def set(self, **attrs) -> None:
        """Attach attributes, device tensors left unread until the span is."""
        self.attrs.update(attrs)

    def _event(self):
        if self._device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    def __enter__(self) -> "_StageSpan":
        # the events outermost, so that sibling stages tile their parent
        # on the card but for the span's own bookkeeping
        self._start = self._event()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.id = next(STAGES._ids)
        STAGES._stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._range.__exit__(*exc)
        end = self._event()
        stack = STAGES._stack
        stack.pop()
        up = stack[-1] if stack else None
        STAGES.spans.append(StageSpan(
            name=self.name, t0_s=self._t0, dur_s=t1 - self._t0, depth=len(stack),
            parent=up and up.name, attrs=self.attrs, id=self.id, parent_id=up and up.id,
            events=None if end is None else (self._start, end)))
        return False


def stage(name: str, device: torch.device, *, root: bool = False):
    """``with stage("decode.lu", g.device): ...`` — a span of ``STAGES``
    while a ``torch.profiler`` session records, a root is open (or this
    is one, ``root=True``) and, on a CUDA ``device``, the current stream
    is not capturing a CUDA graph (an event recorded there would belong
    to the graph); else the shared no-op."""
    if (not _profiling() or not (root or STAGES._stack)
            or (device.type == "cuda" and torch.cuda.is_current_stream_capturing())):
        return _NULL_SPAN
    return _StageSpan(name, device)


def spans_to_chrome(span_records, path: str) -> str:
    """Render ``span`` records (tracer spans OR telemetry JSONL rows)
    into a Perfetto-loadable Chrome ``trace_event`` JSON file.

    Timestamps are microseconds relative to the earliest span, all on
    one pid/tid — nesting renders from the containment of the complete
    (``ph == "X"``) events.
    """
    recs = [r for r in span_records if "t0_s" in r and "dur_s" in r]
    t0 = min((r["t0_s"] for r in recs), default=0.0)
    events = [
        {
            "name": r.get("span", r.get("name", "span")),
            "cat": "repro",
            "ph": "X",
            "ts": (r["t0_s"] - t0) * 1e6,
            "dur": r["dur_s"] * 1e6,
            "pid": 0,
            "tid": 0,
            "args": {
                **(r.get("attrs") or {}),
                "depth": r.get("depth"),
                "parent": r.get("parent"),
            },
        }
        for r in recs
    ]
    with open(path, "w") as f:
        json.dump(
            {"traceEvents": events, "displayTimeUnit": "ms"}, f
        )
    return path
