"""Ops report: render a telemetry JSONL stream into markdown.

``python -m repro_torch.launch.obsreport run.jsonl``

Counterpart of ``repro/launch/obsreport.py``. The serving and training
loops write their behaviour to a telemetry JSONL (events declared in
``repro_torch.obs.schema``; ``launch.serve --telemetry PATH`` writes one);
this module turns one run's stream into the page an operator reads:

* **overview** — event counts by type, log-line count, span coverage;
* **span waterfall** — per-span-name wall-time totals from the
  ``SpanTracer`` records (`admit`/`prefill_chunk`/`decode_chunk`/
  `dispatch`/`replan`/...), unicode share bars;
* **request latency** — p50/p95/p99 per deadline class from
  ``request_done``, shed counts by reason from ``request_evicted``;
* **replan timeline** — every ``adapt_decision`` / ``replan`` /
  ``plan_bucket_*`` in round order, so a replan storm is legible;
* **straggler drift** — the ``round_timing`` ``scale`` series (measured
  seconds-per-unit vs the frozen calibration) as a sparkline: "is the
  fleet the one we planned for";
* **KV pool** — peak/final occupancy and frees from the block-pool
  events;
* **metrics** — the final ``metrics_snapshot`` (counters, gauges,
  histogram percentiles);
* optionally a per-phase torch profile summary
  (``--profile-summary``: a ``repro_torch.obs.profile.summarize`` result,
  bare or under a record's ``profile_summary`` key).

``--require-spans`` makes the exit status assert observability itself:
a stream with no ``span`` events means the loop ran untraced (or the
tracer was wired out), and CI should notice that, not just a human.

Stdlib-only; ``--html`` wraps the same markdown in a minimal page.
"""
from __future__ import annotations

import argparse
import html as _html
import json
import os
from collections import Counter, defaultdict

from repro_torch.obs.schema import EVENT_SCHEMAS

__all__ = ["load_records", "render_report", "main"]

#: sparkline glyphs, low to high
_SPARKS = "▁▂▃▄▅▆▇█"
_BAR_WIDTH = 24


def load_records(path: str) -> list[dict]:
    """Parse a telemetry JSONL file (event records AND bare ``log()``
    metric lines) into dicts; blank lines are skipped."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _pct(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, round(q / 100.0 * (len(vs) - 1))))
    return vs[idx]


def _spark(values) -> str:
    vals = [v for v in values if v is not None]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    out = []
    for v in values:
        if v is None:
            out.append("·")
        else:
            out.append(_SPARKS[int((v - lo) / span * (len(_SPARKS) - 1))])
    return "".join(out)


def _bar(frac: float) -> str:
    n = int(round(max(0.0, min(frac, 1.0)) * _BAR_WIDTH))
    return "█" * n + "░" * (_BAR_WIDTH - n)


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _table(rows, cols) -> list[str]:
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(_fmt(r.get(c)) for c in cols) + " |")
    return lines


# ------------------------------------------------------------ sections
def _overview(events, logs) -> list[str]:
    counts = Counter(e["event"] for e in events)
    rows = []
    for name, n in counts.most_common():
        known = "yes" if name in EVENT_SCHEMAS else "**UNDECLARED**"
        rows.append({"event": f"`{name}`", "count": n, "declared": known})
    lines = ["## Overview", ""]
    lines.append(f"{len(events)} events across {len(counts)} types, "
                 f"{len(logs)} scalar log lines.")
    lines.append("")
    lines += _table(rows, ["event", "count", "declared"])
    return lines


def _span_waterfall(events) -> list[str]:
    spans = [e for e in events if e["event"] == "span"]
    if not spans:
        return ["## Span waterfall", "",
                "_No `span` events — the run was not traced "
                "(pass `--telemetry` so the loop builds a SpanTracer)._"]
    agg = defaultdict(lambda: {"n": 0, "total": 0.0, "max": 0.0,
                               "depth": 0, "parents": Counter()})
    for s in spans:
        a = agg[s["span"]]
        a["n"] += 1
        a["total"] += s["dur_s"]
        a["max"] = max(a["max"], s["dur_s"])
        a["depth"] = max(a["depth"], s.get("depth", 0))
        if s.get("parent"):
            a["parents"][s["parent"]] += 1
    # wall share against top-level span time only: nested spans (e.g.
    # dispatch inside decode_chunk) double-count wall time by design
    top_total = sum(s["dur_s"] for s in spans if s.get("depth", 0) == 0)
    rows = []
    for name, a in sorted(agg.items(), key=lambda kv: -kv[1]["total"]):
        parent = a["parents"].most_common(1)
        rows.append({
            "span": "  " * min(a["depth"], 4) + f"`{name}`",
            "count": a["n"],
            "total_s": a["total"],
            "mean_ms": a["total"] / a["n"] * 1e3,
            "max_ms": a["max"] * 1e3,
            "share": _bar(a["total"] / top_total if top_total else 0.0),
            "under": parent[0][0] if parent else "-",
        })
    lines = ["## Span waterfall", "",
             f"{len(spans)} spans, {top_total:.3f}s of top-level traced "
             f"wall time (share bars are vs that; nested spans overlap "
             f"their parents).", ""]
    lines += _table(rows, ["span", "count", "total_s", "mean_ms",
                           "max_ms", "share", "under"])
    return lines


def _latency(events) -> list[str]:
    done = [e for e in events if e["event"] == "request_done"]
    shed = [e for e in events if e["event"] == "request_evicted"]
    admitted = [e for e in events if e["event"] == "request_admitted"]
    if not (done or shed or admitted):
        return []
    lines = ["## Request latency (rounds) and shedding", ""]
    by_cls = defaultdict(list)
    for e in done:
        by_cls[e["deadline_class"]].append(e["latency"])
    rows = []
    for cls in sorted(by_cls):
        lat = by_cls[cls]
        rows.append({
            "class": f"`{cls}`", "done": len(lat),
            "p50": _pct(lat, 50), "p95": _pct(lat, 95),
            "p99": _pct(lat, 99), "max": max(lat),
        })
    if rows:
        lines += _table(rows, ["class", "done", "p50", "p95", "p99",
                               "max"])
        lines.append("")
    total = len(done) + len(shed)
    shed_by = Counter((e["reason"], e["deadline_class"]) for e in shed)
    lines.append(f"admitted {len(admitted)}, finished {len(done)}, "
                 f"shed {len(shed)}"
                 + (f" ({len(shed) / total:.0%} of outcomes)" if total
                    else "") + ".")
    if shed_by:
        lines.append("")
        lines += _table(
            [{"reason": f"`{r}`", "class": f"`{c}`", "shed": n}
             for (r, c), n in shed_by.most_common()],
            ["reason", "class", "shed"],
        )
    return lines


def _replan_timeline(events) -> list[str]:
    names = ("adapt_decision", "replan", "plan_bucket_hit",
             "plan_bucket_miss")
    recs = [e for e in events if e["event"] in names]
    if not recs:
        return []
    rows = []
    for e in recs:
        if e["event"] == "adapt_decision":
            what = ("replanned" if e["replanned"] else "held")
            detail = (f"reason={e['reason']} gain={_fmt(e.get('gain'))} "
                      f"deadline={_fmt(e.get('deadline'))}")
            rnd = e.get("round")
        elif e["event"] == "replan":
            what, rnd = "replanned (caller)", None
            detail = (f"workers={e['workers']} n={e['n']} "
                      f"deadline={_fmt(e['deadline'])}")
        else:
            hit = e["event"] == "plan_bucket_hit"
            what = "bucket hit" if hit else (
                "bucket admit" if not e["structural"] else
                "structural miss")
            rnd = None
            detail = (f"bucket={e['bucket']}/{e['buckets']} "
                      f"n={e['n']}/{e['n_cap']}")
        rows.append({"t": e.get("t"), "round": rnd,
                     "event": f"`{e['event']}`", "what": what,
                     "detail": detail})
    replans = sum(1 for r in rows if "replanned" in r["what"])
    lines = ["## Replan / decision timeline", "",
             f"{len(rows)} control events, {replans} replans.", ""]
    lines += _table(rows, ["t", "round", "event", "what", "detail"])
    return lines


def _straggler_drift(events) -> list[str]:
    timing = [e for e in events if e["event"] == "round_timing"]
    if not timing:
        return []
    timing.sort(key=lambda e: e["round"])
    scales = [e.get("scale") for e in timing]
    fed = sum(1 for e in timing if e.get("fed"))
    skipped = Counter(e["skipped"] for e in timing
                      if e.get("skipped") is not None)
    walls = [e["wall_s"] for e in timing]
    lines = ["## Straggler-estimate drift (`round_timing`)", ""]
    lines.append(f"{len(timing)} measured rounds, {fed} fed to the "
                 f"controller"
                 + (f", skipped: "
                    + ", ".join(f"{k}={n}" for k, n in skipped.items())
                    if skipped else "") + ".")
    lines.append("")
    real = [s for s in scales if s is not None]
    if real:
        lines.append(f"`scale` (measured round time / calibration unit; "
                     f"1.0 = the fleet we planned for):")
        lines.append("")
        lines.append(f"    {_spark(scales)}   "
                     f"min {min(real):.3g}  mean "
                     f"{sum(real) / len(real):.3g}  max {max(real):.3g}")
        lines.append("")
    lines.append(f"round wall time: min {min(walls):.4g}s, "
                 f"mean {sum(walls) / len(walls):.4g}s, "
                 f"max {max(walls):.4g}s.")
    return lines


def _kv_pool(events) -> list[str]:
    occ = [e for e in events if e["event"] == "blocks_in_use"]
    byt = [e for e in events if e["event"] == "kv_bytes"]
    freed = [e for e in events if e["event"] == "blocks_freed"]
    if not (occ or byt):
        return []
    lines = ["## KV block pool", ""]
    if occ:
        cap = occ[-1]["capacity"]
        peak = max(e["in_use"] for e in occ)
        lines.append(f"capacity {cap} blocks; peak in use {peak} "
                     f"({peak / cap:.0%}), final {occ[-1]['in_use']}; "
                     f"{freed[-1]['total_freed'] if freed else 0} blocks "
                     f"freed over {len(freed)} releases.")
        lines.append("")
        lines.append("    occupancy  " + _spark([e["in_use"] for e in occ]))
    if byt:
        peak_b = max(e["bytes_in_use"] for e in byt)
        lines.append("")
        lines.append(f"KV bytes: peak {peak_b / 2**20:.2f} MiB of "
                     f"{byt[-1]['bytes_total'] / 2**20:.2f} MiB "
                     f"(peak utilization "
                     f"{max(e['utilization'] for e in byt):.0%}).")
    return lines


def _metrics(events) -> list[str]:
    snaps = [e for e in events if e["event"] == "metrics_snapshot"]
    if not snaps:
        return []
    snap = snaps[-1]
    rows = []
    for m in snap["metrics"]:
        labels = ",".join(f"{k}={v}" for k, v in
                          sorted(m.get("labels", {}).items()))
        name = f"`{m['name']}" + (f"{{{labels}}}" if labels else "") + "`"
        if m["type"] == "histogram":
            rows.append({"metric": name, "type": m["type"],
                         "value": m["count"], "p50": m.get("p50"),
                         "p95": m.get("p95"), "p99": m.get("p99"),
                         "max": m.get("max")})
        else:
            rows.append({"metric": name, "type": m["type"],
                         "value": m["value"]})
    lines = ["## Metrics snapshot", ""]
    phase = snap.get("phase")
    lines.append(f"final registry dump"
                 + (f" (phase `{phase}`" +
                    (f", {snap['rounds']:.0f} rounds)" if
                     snap.get("rounds") is not None else ")")
                    if phase else "")
                 + f": {snap['size']} metrics.")
    lines.append("")
    lines += _table(rows, ["metric", "type", "value", "p50", "p95",
                           "p99", "max"])
    return lines


def _profile(summary: dict) -> list[str]:
    lines = ["## Torch profile summary (per phase)", ""]
    rows = [{"phase": f"`{p}`", "wall_ms": s["wall_us"] / 1e3,
             "ops": s["n_ops"],
             "top op": (f"`{s['ops'][0]['name'][:40]}` "
                        f"({s['ops'][0]['total_us'] / 1e3:.2f} ms)"
                        if s.get("ops") else "-")}
            for p, s in sorted(summary.items(),
                               key=lambda kv: -kv[1]["wall_us"])]
    lines += _table(rows, ["phase", "wall_ms", "ops", "top op"])
    return lines


# -------------------------------------------------------------- report
def render_report(records: list[dict], *, source: str = "",
                  profile_summary: dict | None = None) -> str:
    """The full markdown report for one telemetry stream."""
    events = [r for r in records if "event" in r]
    logs = [r for r in records if "event" not in r]
    parts = [f"# Ops report — `{source or 'telemetry'}`", ""]
    sections = [
        _overview(events, logs),
        _span_waterfall(events),
        _latency(events),
        _replan_timeline(events),
        _straggler_drift(events),
        _kv_pool(events),
        _metrics(events),
    ]
    if profile_summary:
        sections.append(_profile(profile_summary))
    for sec in sections:
        if sec:
            parts += sec + [""]
    return "\n".join(parts).rstrip() + "\n"


def _to_html(markdown: str, title: str) -> str:
    """Minimal self-contained HTML wrapper (stdlib only — the markdown
    is readable as-is in monospace; no renderer dependency)."""
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_html.escape(title)}</title>"
        "<style>body{background:#111;color:#ddd;font:14px/1.5 monospace;"
        "max-width:110ch;margin:2em auto;padding:0 1em}</style>"
        "</head><body><pre>"
        + _html.escape(markdown)
        + "</pre></body></html>"
    )


def _load_profile_summary(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    # accept a bare summary dict or a bench record carrying one
    return doc.get("profile_summary", doc) or {}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("telemetry", help="telemetry JSONL to report on")
    ap.add_argument("-o", "--out", default=None,
                    help="write the markdown here instead of stdout")
    ap.add_argument("--html", default=None, metavar="PATH",
                    help="also write a self-contained HTML page")
    ap.add_argument("--profile-summary", default=None, metavar="JSON",
                    help="profile summary JSON (repro_torch.obs.profile."
                         "summarize, bare or under a record's "
                         "profile_summary key) to append")
    ap.add_argument("--require-spans", action="store_true",
                    help="exit non-zero when the stream has no span "
                         "events (the run was not traced)")
    args = ap.parse_args(argv)

    records = load_records(args.telemetry)
    summary = (_load_profile_summary(args.profile_summary)
               if args.profile_summary else None)
    report = render_report(records, source=os.path.basename(args.telemetry),
                           profile_summary=summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)
        print(f"wrote {args.out}")
    else:
        print(report, end="")
    if args.html:
        with open(args.html, "w") as f:
            f.write(_to_html(report, title=args.telemetry))
        print(f"wrote {args.html}")
    if args.require_spans:
        n = sum(1 for r in records if r.get("event") == "span")
        if n == 0:
            raise SystemExit(
                f"{args.telemetry}: no span events — the loop ran "
                f"untraced (--require-spans)"
            )
        print(f"span coverage: {n} spans")


if __name__ == "__main__":
    main()
