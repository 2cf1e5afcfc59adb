"""What the serve metric readers share: the profiled dispatches of a traced
run's extra ``serve`` call, and the work each of them computed."""
from __future__ import annotations

from perfbench import schedule


def chunks(call) -> list[tuple[str, float, int]]:
    """(span name, round, steps) of each dispatch of a call, in order."""
    spans = sorted((s for s in call.spans or []
                    if s.name in ("prefill_chunk", "decode_chunk")), key=lambda s: s.t0_s)
    return [(s.name, float(s.attrs["round"]), int(s.attrs["steps"])) for s in spans]


def profiled(cx) -> list[tuple[str, float, int]] | None:
    """The profiled dispatches' (span name, round, steps), or None when the
    run profiled none."""
    if getattr(cx, "profile", None) is None or not getattr(cx, "profiler", None):
        return None
    every = chunks(cx.profiled)
    idx = cx.profiler.profiled
    if not idx or max(idx) >= len(every):
        return None
    return [every[i] for i in idx]


def steps(cx) -> int:
    """Decode steps in the profiled dispatches (coded rounds, with a coded
    head)."""
    return sum(s for _, _, s in profiled(cx) or ())


def work(cx) -> list[schedule.Dispatch] | None:
    """The profiled dispatches' work, reconstructed and checked
    (``schedule.reconstruct``, which raises on a record that disagrees),
    or None when the run profiled none."""
    if profiled(cx) is None:
        return None
    call = cx.profiled
    requests = {r.rid: (r.prompt_len, r.out_len) for r in call.trace}
    done = schedule.reconstruct(chunks(call), call.admitted or {}, requests,
                                int(cx.mix["prefill_chunk"]), int(cx.mix["decode_block"]))
    return [done[i] for i in cx.profiler.profiled]
