"""Traffic: the frozen request generator and the seeding the cells use.

``WorkloadSpec`` and ``Request`` are a frozen copy of the port's
``repro_torch/serve/workload.py`` generator (numpy ``RandomState``; the
trace of a spec and a seed is the same in both, held by a test), kept
here so that a change to the program cannot move the yardstick. Times
are in decode rounds, the serve loop's virtual clock.

``serve_trace`` is the one generator every serve mix goes through: a
mix file gives the parameters, and trace ``index`` of a run with seed
``seed`` is ``WorkloadSpec.trace`` of a seed drawn from the two, so each
seed and each trace of a window draws its own sizes, classes, arrivals
and prompt tokens, as the program's generator does.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: admission-control deadline classes: completion budget multiplier over
#: a request's own work (prefill + out_len rounds)
DEADLINE_SLACK: dict[str, float] = {
    "strict": 4.0,
    "standard": 10.0,
    "batch": float("inf"),
}


@dataclasses.dataclass(frozen=True)
class Request:
    """One independent generation request."""

    rid: int
    arrival: float  # rounds (virtual clock)
    prompt: tuple[int, ...]  # token ids
    out_len: int  # tokens to generate
    deadline_class: str = "standard"

    def __post_init__(self):
        if self.out_len <= 0:
            raise ValueError(f"request {self.rid}: out_len must be > 0")
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.deadline_class not in DEADLINE_SLACK:
            raise ValueError(f"request {self.rid}: unknown deadline class "
                             f"{self.deadline_class!r}")

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Parameters of a Poisson request stream (frozen, hashable)."""

    name: str
    arrival_rate: float  # mean requests per decode round
    num_requests: int
    prompt_len: tuple[int, int]  # inclusive [lo, hi]
    out_len: tuple[int, int]
    vocab: int = 512
    class_mix: tuple[tuple[str, float], ...] = (
        ("strict", 0.25), ("standard", 0.65), ("batch", 0.10),
    )
    out_len_mix: tuple[tuple[tuple[int, int], float], ...] | None = None

    def __post_init__(self):
        if not self.arrival_rate > 0:
            raise ValueError(f"arrival_rate must be > 0, got {self.arrival_rate!r}")
        if self.num_requests <= 0:
            raise ValueError(f"num_requests must be > 0, got {self.num_requests}")
        for lo, hi in (self.prompt_len, self.out_len):
            if not 0 < lo <= hi:
                raise ValueError(f"length ranges must satisfy 0 < lo <= hi, got ({lo}, {hi})")
        for cls, w in self.class_mix:
            if cls not in DEADLINE_SLACK or w < 0:
                raise ValueError(f"bad class mix entry ({cls!r}, {w})")
        for (lo, hi), w in self.out_len_mix or ():
            if not 0 < lo <= hi or w < 0:
                raise ValueError(f"bad out_len_mix entry (({lo}, {hi}), {w})")

    def trace(self, seed: int = 0) -> list[Request]:
        """The seeded request trace (sorted by arrival)."""
        rng = np.random.RandomState(seed)
        t = 0.0
        classes = [c for c, _ in self.class_mix]
        weights = np.asarray([w for _, w in self.class_mix], float)
        weights = weights / weights.sum()
        reqs = []
        mix = self.out_len_mix
        if mix:
            mix_w = np.asarray([w for _, w in mix], float)
            mix_w = mix_w / mix_w.sum()
        for rid in range(self.num_requests):
            t += float(rng.exponential(1.0 / self.arrival_rate))
            p_lo, p_hi = self.prompt_len
            if mix:
                o_lo, o_hi = mix[int(rng.choice(len(mix), p=mix_w))][0]
            else:
                o_lo, o_hi = self.out_len
            plen = int(rng.randint(p_lo, p_hi + 1))
            olen = int(rng.randint(o_lo, o_hi + 1))
            prompt = tuple(int(x) for x in rng.randint(0, self.vocab, size=plen))
            cls = classes[int(rng.choice(len(classes), p=weights))]
            reqs.append(Request(rid=rid, arrival=t, prompt=prompt, out_len=olen,
                                deadline_class=cls))
        return reqs


def sub_seed(*parts: int) -> int:
    """A 32-bit seed from any whole numbers (a run's seed may pass 2**32)."""
    return int(np.random.SeedSequence([int(p) % 2**63 for p in parts]).generate_state(1)[0])


def mean_out_len(mix: dict) -> float:
    """Mean output length of a serve mix's output ranges (uniform within)."""
    ranges = mix["out_len_mix"]
    total = sum(w for _, w in ranges)
    return sum((lo + hi) / 2 * w for (lo, hi), w in ranges) / total


def spec_of(mix: dict, vocab: int) -> WorkloadSpec:
    """The ``WorkloadSpec`` a serve mix file describes, with the default
    class mix. The arrival rate is ``rate_factor * slots / (1 + mean
    output length)`` requests a round."""
    ranges = tuple((tuple(r), float(w)) for r, w in mix["out_len_mix"])
    rate = float(mix["rate_factor"]) * int(mix["slots"]) / (1.0 + mean_out_len(mix))
    return WorkloadSpec(
        name=mix["name"], arrival_rate=rate, num_requests=int(mix["requests"]),
        prompt_len=tuple(mix["prompt_len"]),
        out_len=(min(r[0] for r, _ in ranges), max(r[1] for r, _ in ranges)),
        vocab=int(vocab), out_len_mix=ranges)


def serve_trace(mix: dict, vocab: int, seed: int, index: int) -> list[Request]:
    """Trace ``index`` of a run with ``seed``."""
    return spec_of(mix, vocab).trace(sub_seed(seed, index))


def warmup_trace(mix: dict, vocab: int, seed: int) -> list[Request]:
    """Requests that reach every dispatch key of a serve mix's shape twice,
    with as few prefill dispatches as that takes: each arrives alone (far
    apart); outputs 1 .. decode_block - 1 end in the dispatch that
    prefills them, and outputs decode_block + 1 .. 2 decode_block prefill
    with a full decode chunk and end in a decode chunk of every shorter
    length. The two longest also have a prompt one token past the prefill
    chunk, for the chunk round that decodes nothing (when the mix's
    prompts can outrun a chunk)."""
    db, chunk = int(mix["decode_block"]), int(mix["prefill_chunk"])
    long_prompt = min(chunk + 1, int(mix["prompt_len"][1]))
    outs = [o for o in range(1, 2 * db + 1) if o != db] * 2
    rng = np.random.RandomState(sub_seed(seed, 2**31))
    gap = 4.0 * (2 + 2 * db)
    reqs = []
    for rid, out in enumerate(sorted(outs)):
        plen = long_prompt if out == 2 * db else min(8, long_prompt)
        reqs.append(Request(rid=rid, arrival=gap * rid,
                            prompt=tuple(int(x) for x in rng.randint(0, vocab, size=plen)),
                            out_len=out, deadline_class="batch"))
    return reqs
