"""Path M's stage spans in the profiled queries: the program's own spans
(``repro_torch.obs.trace.STAGES``), kept while the harness's profiler
records.

The profiled queries are the last ``cx.profiled_queries`` ``pathm.query``
spans; a stage counts when it descends from one of them (by
``parent_id``), so the queries of an earlier run in the same process are
never read. A program without stage spans reads as nothing.
"""
from __future__ import annotations

ROOT = "pathm.query"
#: the stages' name prefixes, as the program names them
PREFIXES = ("pathm.", "decode.")


def profiled(cx) -> list | None:
    """The spans of the profiled queries, roots included (None when
    nothing was profiled or the program records no such spans)."""
    if getattr(cx, "profile", None) is None:
        return None
    from repro_torch.obs import trace

    stages = getattr(trace, "STAGES", None)
    if stages is None:
        return None
    n = int(cx.profiled_queries)
    spans = list(stages.spans)
    roots = [s for s in spans if s.name == ROOT][-n:]
    if n <= 0 or len(roots) < n:
        return None
    keep = {s.id for s in roots}
    # spans are kept in the order they end, so a parent follows its children
    out = []
    for s in reversed(spans):
        if s.id in keep or s.parent_id in keep:
            keep.add(s.id)
            out.append(s)
    return out


def device_ms(cx, name: str) -> float | None:
    """Device ms a profiled query of the stage ``name``."""
    spans = profiled(cx)
    if spans is None:
        return None
    return sum(s.device_s for s in spans if s.name == name) * 1e3 / cx.profiled_queries
