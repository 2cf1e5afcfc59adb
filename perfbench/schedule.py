"""What each dispatch of a paged serve call computed, worked out from the
program's own record of the call.

The serve loop's ``prefill_chunk`` / ``decode_chunk`` spans give each
dispatch's round and decode steps, and the scheduler's
``request_admitted`` events the round each request entered a slot. From
those and the requests themselves the work follows: in a dispatch every
slot still mid-prompt takes its next ``min(chunk, left)`` prompt tokens,
a slot that finishes its prompt decodes in the same dispatch, and each
decode step writes one token per decoding slot at the slot's next
position. The reconstruction is checked against the record (the steps
of every dispatch, and every request's output length): a record that
disagrees means the program's scheduling policy changed, and raises
``ScheduleMismatch``, so that a traced run fails rather than leave the
metrics built on it out of its line.
"""
from __future__ import annotations

import dataclasses


class ScheduleMismatch(RuntimeError):
    """The program's record of a serve call disagrees with the policy
    this module follows."""


@dataclasses.dataclass
class Dispatch:
    """One dispatch's work: ``prefill`` (start position, tokens) per
    prefilling slot, ``decode`` (position of the first step) per decoding
    slot, and its ``steps``."""

    round: float
    steps: int
    prefill: list
    decode: list


def reconstruct(chunks: list[tuple[str, float, int]], admitted: dict[int, float],
                requests: dict, chunk: int, decode_block: int) -> list[Dispatch]:
    """``chunks``: (span name, round, steps) of each dispatch in order;
    ``admitted``: request id -> admission round; ``requests``: id ->
    (prompt_len, out_len)."""
    waiting = sorted(admitted.items(), key=lambda kv: kv[1])
    live: dict[int, list] = {}  # rid -> [prefilled, generated, pos]
    out = []
    for name, rnd, steps in chunks:
        while waiting and waiting[0][1] <= rnd + 1e-6 * max(1.0, abs(rnd)):
            live[waiting.pop(0)[0]] = [0, 0, 0]
        prefill, eligible = [], []
        for rid, st in live.items():
            plen, olen = requests[rid]
            if st[0] < plen:
                take = min(chunk, plen - st[0])
                prefill.append((st[0], take))
                st[0] += take
                if st[0] >= plen:
                    st[2] = plen
                    eligible.append(rid)
            elif st[1] < olen:
                eligible.append(rid)
        if (name == "prefill_chunk") != bool(prefill):
            raise ScheduleMismatch(f"dispatch at round {rnd}: a {name} with "
                                   f"{len(prefill)} slots prefilling")
        want = min([decode_block] + [requests[r][1] - live[r][1] for r in eligible]) \
            if eligible else 0
        if want != steps or not (prefill or steps):
            raise ScheduleMismatch(f"dispatch at round {rnd}: {steps} decode steps, "
                                   f"the policy gives {want}")
        decode = []
        for rid in eligible:
            st = live[rid]
            decode.append(st[2])
            st[1] += steps
            st[2] += steps
        out.append(Dispatch(rnd, steps, prefill, decode))
        for rid in [r for r, st in live.items() if st[0] >= requests[r][0]
                    and st[1] >= requests[r][1]]:
            del live[rid]
    if waiting or live:
        raise ScheduleMismatch(f"{len(waiting)} requests never admitted, {len(live)} "
                               "unfinished after the last dispatch")
    return out
