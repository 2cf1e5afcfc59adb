"""The port's telemetry event-schema registry.

Counterpart of ``repro/obs/schema.py``, with the same events and fields.
Every ``Telemetry.event`` emitter of ``repro_torch`` declares its event
here ONCE: name, emitter, and per-field documentation, split into
required and optional fields. Three consumers keep the declaration
honest:

* ``validate_event`` / ``validate_events`` — the tests drive the serve
  and train paths and validate every emitted record: missing required
  fields, unknown events and undeclared fields all fail;
* ``render_markdown`` — generates the event table in ``README.md``
  between the port's own ``GENERATED`` markers, so the docs cannot drift
  from the code (``python -m repro_torch.obs.schema`` prints the table,
  ``python -m repro_torch.obs.schema --check README.md`` verifies it);
* ``launch/obsreport.py`` — renders reports from the same field names.

Every event record also carries the sink-stamped common fields
(``COMMON_FIELDS``): the monotonic per-sink sequence number ``t`` and a
``perf_counter`` stamp ``wall_s`` (caller-overridable — ``round_timing``
reuses ``wall_s`` for its measured window).
"""
from __future__ import annotations

import dataclasses
from types import MappingProxyType

__all__ = ["EventSchema", "EVENT_SCHEMAS", "COMMON_FIELDS",
           "validate_event", "validate_events", "render_markdown",
           "BEGIN_MARK", "END_MARK"]

#: stamped by ``Telemetry.event`` itself (absent only in test doubles)
COMMON_FIELDS = ("t", "wall_s")


@dataclasses.dataclass(frozen=True)
class EventSchema:
    """One event's contract: who emits it and what its fields mean."""

    name: str
    emitter: str
    fields: MappingProxyType  # required field -> one-line doc
    optional: MappingProxyType  # optional field -> one-line doc

    def validate(self, rec: dict) -> None:
        # common stamps are implicit — unless the schema declares one
        # explicitly (e.g. round_timing's overriding wall_s), in which
        # case it counts toward the contract like any other field
        implicit = set(COMMON_FIELDS) - set(self.fields)
        present = set(rec) - {"event"} - implicit
        missing = set(self.fields) - present
        if missing:
            raise ValueError(
                f"event {self.name!r} missing required fields "
                f"{sorted(missing)}: {rec}"
            )
        unknown = present - set(self.fields) - set(self.optional)
        if unknown:
            raise ValueError(
                f"event {self.name!r} has undeclared fields "
                f"{sorted(unknown)} (declare them in repro_torch.obs.schema): "
                f"{rec}"
            )


def _schema(name, emitter, fields, optional=()):
    return EventSchema(
        name=name,
        emitter=emitter,
        fields=MappingProxyType(dict(fields)),
        optional=MappingProxyType(dict(optional)),
    )


_SCHEMAS = (
    _schema(
        "adapt_decision",
        "`AdaptiveController.update` — every cadence decision, held or not",
        [
            ("round", "executed-round counter"),
            ("replanned", "bool"),
            ("reason", "`membership` \\| `improvement` \\| `hold`"),
            ("current", "estimated latency of the incumbent plan on the "
                        "estimated cluster; NaN on membership replans"),
            ("candidate", "estimated latency of a fresh plan on the same "
                          "estimates"),
            ("gain", "relative improvement"),
            ("deadline", "post-decision round deadline"),
            ("workers", "post-decision fleet size"),
        ],
    ),
    _schema(
        "replan",
        "`Trainer.replan` — caller-initiated replans (controller replans "
        "emit `adapt_decision` instead)",
        [
            ("workers", "post-replan fleet size"),
            ("n", "coded slots"),
            ("deadline", "post-replan round deadline"),
        ],
    ),
    _schema(
        "all_workers_missed_deadline",
        "`aggregate_with_erasures` — degraded step (previous gradient "
        "reused / zero)",
        [("workers", "fleet size at the degraded step")],
    ),
    _schema(
        "request_admitted",
        "`SlotScheduler.fill_slots` — a queued request entered a stream "
        "slot",
        [
            ("request_id", "workload request id"),
            ("slot", "stream slot index"),
            ("queue_wait", "rounds between arrival and admission"),
            ("deadline_class", "`strict` \\| `standard` \\| `batch`"),
            ("round", "virtual round of the admission"),
        ],
    ),
    _schema(
        "request_evicted",
        "`SlotScheduler.offer` — a request was shed at enqueue time",
        [
            ("request_id", "workload request id"),
            ("reason", "`queue_full` \\| `deadline_risk` \\| "
                       "`pool_exhausted`"),
            ("deadline_class", "the shed request's class"),
            ("round", "virtual round of the shed"),
            ("queue_depth", "queue length at the shed"),
        ],
    ),
    _schema(
        "request_done",
        "`SlotScheduler.retire_done` — a stream finished and freed its "
        "slot",
        [
            ("request_id", "workload request id"),
            ("slot", "stream slot index"),
            ("tokens", "tokens emitted"),
            ("latency", "arrival→last-token rounds"),
            ("deadline_class", "the finished request's class"),
            ("round", "virtual round of the retirement"),
        ],
    ),
    _schema(
        "blocks_freed",
        "`BlockPool.free` — a retired/evicted request returned its "
        "KV blocks to the pool",
        [
            ("blocks", "blocks returned this call"),
            ("total_freed", "cumulative frees"),
            ("request_id", "owning request (may be null)"),
            ("round", "virtual round"),
        ],
    ),
    _schema(
        "blocks_in_use",
        "`BlockPool.alloc` / `BlockPool.free` — pool occupancy "
        "after every allocation or release",
        [
            ("in_use", "blocks allocated"),
            ("free", "blocks on the free list"),
            ("capacity", "pool size in blocks"),
            ("request_id", "request that moved the occupancy"),
            ("round", "virtual round"),
        ],
    ),
    _schema(
        "kv_bytes",
        "`BlockPool.alloc` / `BlockPool.free` — the same "
        "transition in bytes (`bytes_per_block` × blocks)",
        [
            ("bytes_in_use", "bytes allocated"),
            ("bytes_total", "pool size in bytes"),
            ("utilization", "`in_use / capacity`"),
            ("request_id", "request that moved the occupancy"),
            ("round", "virtual round"),
        ],
    ),
    _schema(
        "plan_bucket_hit",
        "`CodedRoundExecutor.replan` (bucket mode) — the new plan's "
        "quantized signature was already admitted: in-place switch, "
        "no rebuild",
        [
            ("structural", "always `false` on a hit"),
            ("bucket", "active bucket slot"),
            ("buckets", "admitted bucket count"),
            ("n", "quantized coded slots"),
            ("n_cap", "padded slot capacity"),
            ("workers", "fleet size"),
        ],
    ),
    _schema(
        "plan_bucket_miss",
        "`CodedRoundExecutor.replan` (bucket mode) — a new bucket was "
        "admitted (`structural=false`, values-only for consumers already "
        "padded to `n_cap`) or the plan escaped the bucket set entirely "
        "(`structural=true`: membership change or `n > n_cap` — the only "
        "replans that re-encode the coded head or rebuild the step)",
        [
            ("structural", "did the replan change the coded shapes"),
            ("bucket", "active bucket slot"),
            ("buckets", "admitted bucket count"),
            ("n", "quantized coded slots"),
            ("n_cap", "padded slot capacity"),
            ("workers", "fleet size"),
        ],
    ),
    _schema(
        "alloc_cache_hit",
        "`AdaptiveController.update` — the decision's allocation solves "
        "were served from the `allocate` memo cache",
        [
            ("round", "executed-round counter"),
            ("new_hits", "hits since the last decision"),
            ("hits", "cumulative cache hits (`allocate_cache_info()`)"),
            ("misses", "cumulative cache misses"),
            ("size", "entries currently cached"),
        ],
    ),
    _schema(
        "round_timing",
        "`RoundClock.measure` — one record per measured dispatch, "
        "fed to the controller or not",
        [
            ("round", "clock-local counter"),
            ("wall_s", "full measure window (overrides the common "
                       "`wall_s` stamp)"),
            ("dispatch_s", "dispatch until the device is done, "
                           "minus injected pad"),
            ("pad_wall_s", "measured injected-pad wall time"),
            ("scale", "this round's seconds-per-unit ÷ the frozen "
                      "calibration `unit_s`; `null` on skipped rounds"),
            ("unit_s", "frozen after the first fed round"),
            ("workers", "fleet size"),
            ("fed", "bool: decomposed times reached the controller"),
            ("skipped", "`null` when fed \\| `warmup` \\| `outlier` \\| "
                        "the `discard_next` reason, e.g. `recompile`"),
            ("t_max", "max decomposed per-worker seconds (finite "
                      "workers only)"),
            ("t_mean", "mean decomposed per-worker seconds"),
        ],
    ),
    _schema(
        "perf_gate",
        "the reference's `benchmarks/perf_gate.py` — one record per gated "
        "metric (declared for parity; the port has no perf gate yet)",
        [
            ("metric", "gated metric name"),
            ("measured", "fresh measurement"),
            ("golden", "committed golden value"),
            ("bound", "one-sided tolerance edge"),
            ("tolerance", "allowed relative regression"),
            ("passed", "bool"),
            ("enforced", "bool: ratio metrics always, absolutes only "
                         "under `--absolute`"),
        ],
    ),
    _schema(
        "span",
        "`repro_torch.obs.trace.SpanTracer` — one finished wall-clock "
        "span from the serve/train/executor/controller loops",
        [
            ("span", "span name (`admit` \\| `prefill_chunk` \\| "
                     "`decode_chunk` \\| `dispatch` \\| `erasure_solve` "
                     "\\| `replan` \\| `bucket_switch` \\| "
                     "`adapt_update`)"),
            ("t0_s", "`perf_counter` at span entry"),
            ("dur_s", "span wall duration, seconds"),
            ("depth", "nesting depth (0 = top-level)"),
            ("parent", "enclosing span's name (`null` at depth 0)"),
            ("attrs", "span attributes (free-form dict: steps, placed, "
                      "structural, ...)"),
        ],
    ),
    _schema(
        "metrics_snapshot",
        "`repro_torch.obs.metrics.MetricsRegistry.emit` — end-of-run "
        "dump of a loop's counters/gauges/histograms",
        [
            ("metrics", "list of metric rows (name, labels, type, "
                        "value or count/sum/p50/p95/p99/max)"),
            ("size", "number of metric rows"),
        ],
        optional=[
            ("phase", "which loop emitted (`serve` \\| `train`)"),
            ("rounds", "virtual rounds covered by the snapshot"),
        ],
    ),
)

EVENT_SCHEMAS: dict[str, EventSchema] = {s.name: s for s in _SCHEMAS}


def validate_event(rec: dict, *, source: str = "") -> EventSchema:
    """Validate one event record (a ``Telemetry.events`` row, a parsed
    JSONL line, or a test double's ``(name, fields)`` fields dict with
    the name merged in). Raises ``ValueError`` on any violation."""
    name = rec.get("event")
    if name is None:
        raise ValueError(f"record has no 'event' field{source}: {rec}")
    schema = EVENT_SCHEMAS.get(name)
    if schema is None:
        raise ValueError(
            f"unknown event {name!r}{source} — declare it in "
            f"repro_torch.obs.schema: {rec}"
        )
    schema.validate(rec)
    return schema


def validate_events(events, *, source: str = "") -> int:
    """Validate an iterable of event records; returns the count."""
    n = 0
    src = f" (from {source})" if source else ""
    for rec in events:
        validate_event(rec, source=src)
        n += 1
    return n


# ---------------------------------------------------------------- docs
BEGIN_MARK = "<!-- BEGIN GENERATED EVENT SCHEMA (repro_torch.obs.schema) -->"
END_MARK = "<!-- END GENERATED EVENT SCHEMA (repro_torch.obs.schema) -->"


def render_markdown() -> str:
    """The README event table, generated from the registry."""
    lines = [
        "| `event` | emitted by | fields |",
        "|---------|------------|--------|",
    ]
    for s in _SCHEMAS:
        fields = ", ".join(
            f"`{f}` ({doc})" for f, doc in s.fields.items()
        )
        if s.optional:
            fields += "; optional: " + ", ".join(
                f"`{f}` ({doc})" for f, doc in s.optional.items()
            )
        lines.append(f"| `{s.name}` | {s.emitter} | {fields} |")
    return "\n".join(lines)


def extract_generated_block(text: str) -> str:
    """The table between the generated-schema markers (raises if absent)."""
    try:
        after = text.split(BEGIN_MARK, 1)[1]
        return after.split(END_MARK, 1)[0].strip()
    except IndexError:
        raise ValueError(
            f"no generated-schema markers ({BEGIN_MARK!r}) found"
        ) from None


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", metavar="MARKDOWN", default=None,
                    help="verify the file's generated block matches the "
                         "registry instead of printing the table")
    args = ap.parse_args(argv)
    table = render_markdown()
    if args.check is None:
        print(table)
        return
    with open(args.check) as f:
        block = extract_generated_block(f.read())
    if block != table:
        raise SystemExit(
            f"{args.check} event-schema table is stale — regenerate it "
            f"with: python -m repro_torch.obs.schema"
        )
    print(f"{args.check} event-schema table is in sync "
          f"({len(EVENT_SCHEMAS)} events)")


if __name__ == "__main__":
    main()
