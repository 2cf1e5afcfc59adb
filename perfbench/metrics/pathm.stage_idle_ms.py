"""pathm.stage_idle_ms: idle device ms a profiled query in the gaps that
the trace's ``DeviceTrace.idle_gaps`` names by one of the program's Path M
stage spans (``pathm.*``, ``decode.*``): each gap goes to the innermost
host range open at its middle, so this is the idle that falls while the
host is inside a stage. The host runs ahead of the card (in the LU by
~40 ms), so idle the card spends in a stage the host has already left is
named by the harness's ``query`` and not counted here; a host that
launches faster lowers this reading with the card's idle unchanged.
"""
from perfbench import stages


def read(cx):
    p = getattr(cx, "profile", None)
    if p is None or not p.busy_s > 0:
        return None
    if not any(name.startswith(stages.PREFIXES) for name, _, _ in p.notes):
        return None
    gaps = p.idle_gaps(len(p.notes) + 1)
    named = sum(s for name, s in gaps if name.startswith(stages.PREFIXES))
    return named * 1e3 / cx.profiled_queries
