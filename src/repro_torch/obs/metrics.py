"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

Host-only copy of ``repro/obs/metrics.py``. Metrics are keyed ``(name,
sorted labels)``; ``counter``/``gauge``/``histogram`` are get-or-create;
each metric and the registry ``merge`` another (a fleet view of per-host
registries). ``snapshot()`` renders everything JSON-safe and ``emit()``
writes one ``metrics_snapshot`` telemetry event. ``REGISTRY`` is the
process-global one: the allocation memo's hit and miss counters live
there, and the trainer emits it at the end of a run.
"""
from __future__ import annotations

import bisect

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "LATENCY_BUCKETS",
           "REGISTRY"]

#: default latency buckets (virtual rounds / seconds): geometric, wide
#: enough for both sub-round erasure solves and hundred-round tails
LATENCY_BUCKETS = (
    0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
)


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n
        return self.value

    def reset(self) -> None:
        self.value = 0

    def merge(self, other: "Counter") -> None:
        self.value += other.value


class Gauge:
    """Last-observed value (occupancy, depth, utilization)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value

    def merge(self, other: "Gauge") -> None:
        self.value = other.value  # last writer wins


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``bounds`` are upper bucket edges; observations past the last edge
    land in an overflow bucket. Mergeable: two histograms with equal
    bounds add counts (per-host registries fold into one fleet view).
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds=LATENCY_BUCKETS):
        b = tuple(float(x) for x in bounds)
        if not b or list(b) != sorted(set(b)):
            raise ValueError(
                f"bucket bounds must be distinct and ascending, got {bounds}"
            )
        self.bounds = b
        self.counts = [0] * (len(b) + 1)  # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]): linear interpolation
        inside the owning bucket, clamped to the observed min/max so
        sparse histograms do not report impossible values."""
        if not 0 <= q <= 1:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(self.min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - seen) / c
                est = lo + (hi - lo) * max(0.0, min(frac, 1.0))
                return max(self.min, min(est, self.max))
            seen += c
        return self.max

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}"
            )
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)


class MetricsRegistry:
    """Get-or-create home for named, labeled metrics."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = self._key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls(**kwargs)
            self._metrics[key] = m
        elif type(m) is not cls:
            raise TypeError(
                f"metric {name!r} {labels} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}"
            )
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, bounds=LATENCY_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def __len__(self) -> int:
        return len(self._metrics)

    # ----------------------------------------------------------- export
    def snapshot(self) -> list[dict]:
        """JSON-safe dump of every metric, sorted by (name, labels)."""
        out = []
        for (name, labels), m in sorted(self._metrics.items()):
            row = {"name": name, "labels": dict(labels)}
            if isinstance(m, Counter):
                row.update(type="counter", value=m.value)
            elif isinstance(m, Gauge):
                row.update(type="gauge", value=m.value)
            else:
                row.update(
                    type="histogram",
                    count=m.count,
                    sum=m.sum,
                    p50=m.percentile(0.50),
                    p95=m.percentile(0.95),
                    p99=m.percentile(0.99),
                    max=m.max if m.count else None,
                )
            out.append(row)
        return out

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in (same-keyed metrics must agree in
        type and, for histograms, bounds)."""
        for key, om in other._metrics.items():
            m = self._metrics.get(key)
            if m is None:
                self._metrics[key] = om
            else:
                m.merge(om)

    def emit(self, telemetry, **fields) -> dict | None:
        """Write the snapshot as ONE ``metrics_snapshot`` event."""
        if telemetry is None:
            return None
        snap = self.snapshot()
        # NaN (empty histograms) is not strict JSON -> null
        for row in snap:
            for k, v in row.items():
                if isinstance(v, float) and v != v:
                    row[k] = None
        return telemetry.event(
            "metrics_snapshot", metrics=snap, size=len(snap), **fields
        )


#: process-global registry for module-level emitters; per-run loops
#: construct their own for isolation
REGISTRY = MetricsRegistry()
