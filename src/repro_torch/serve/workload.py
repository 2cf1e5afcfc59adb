"""Seeded request workloads for the continuous-batching serve front-end.

Host-only copy of ``repro/serve/workload.py`` (numpy ``RandomState``),
so a trace is identical in the port and the reference. A workload is a
deterministic trace of independent requests — arrival time, prompt,
output budget and deadline class — measured in DECODE ROUNDS (the serve
loop's virtual clock: one decode step = one round, one batched prefill
pass = one round). Factories are registered by name, every factory's
named keyword params are its accepted overrides, and
``make_workload(name, ...)`` is deterministic in (name, params, seed).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import numpy as np

#: admission-control deadline classes: completion budget multiplier over
#: a request's own work (prefill + out_len rounds). ``batch`` requests
#: are never shed for deadline risk (only a full queue rejects them).
DEADLINE_SLACK: dict[str, float] = {
    "strict": 4.0,
    "standard": 10.0,
    "batch": float("inf"),
}

#: queue pick order when a slot frees (lower = sooner)
CLASS_PRIORITY: dict[str, int] = {"strict": 0, "standard": 1, "batch": 2}


@dataclasses.dataclass(frozen=True)
class Request:
    """One independent generation request."""

    rid: int
    arrival: float  # rounds (virtual clock)
    prompt: tuple[int, ...]  # token ids
    out_len: int  # tokens to generate (completion = out_len emitted)
    deadline_class: str = "standard"

    def __post_init__(self):
        if self.out_len <= 0:
            raise ValueError(f"request {self.rid}: out_len must be > 0")
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.deadline_class not in DEADLINE_SLACK:
            raise ValueError(
                f"request {self.rid}: unknown deadline class "
                f"{self.deadline_class!r}; known: {sorted(DEADLINE_SLACK)}"
            )

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def work(self) -> int:
        """Slot-rounds this request occupies (1 prefill pass + decode)."""
        return 1 + self.out_len


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Parameters of a Poisson request stream (frozen, hashable)."""

    name: str
    arrival_rate: float  # mean requests per decode round
    num_requests: int
    prompt_len: tuple[int, int]  # inclusive [lo, hi]; lo == hi -> fixed
    out_len: tuple[int, int]
    vocab: int = 512
    #: (class, weight) mix the per-request deadline class is drawn from
    class_mix: tuple[tuple[str, float], ...] = (
        ("strict", 0.25), ("standard", 0.65), ("batch", 0.10),
    )
    #: optional bimodal/multimodal output lengths: ((lo, hi), weight)
    #: ranges the per-request draw picks from; overrides ``out_len``
    out_len_mix: tuple[tuple[tuple[int, int], float], ...] | None = None

    def __post_init__(self):
        if not self.arrival_rate > 0:
            raise ValueError(
                f"arrival_rate must be > 0, got {self.arrival_rate!r}"
            )
        if self.num_requests <= 0:
            raise ValueError(f"num_requests must be > 0, got {self.num_requests}")
        for lo, hi in (self.prompt_len, self.out_len):
            if not 0 < lo <= hi:
                raise ValueError(
                    f"length ranges must satisfy 0 < lo <= hi, got ({lo}, {hi})"
                )
        for cls, w in self.class_mix:
            if cls not in DEADLINE_SLACK:
                raise ValueError(f"unknown deadline class {cls!r}")
            if w < 0:
                raise ValueError(f"class weight must be >= 0, got {w}")
        for (lo, hi), w in self.out_len_mix or ():
            if not 0 < lo <= hi or w < 0:
                raise ValueError(
                    f"out_len_mix entries need 0 < lo <= hi and weight >= 0, "
                    f"got (({lo}, {hi}), {w})"
                )

    def trace(self, seed: int = 0) -> list[Request]:
        """Materialize the seeded request trace (sorted by arrival)."""
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
            prompt = tuple(
                int(x) for x in rng.randint(0, self.vocab, size=plen)
            )
            cls = classes[int(rng.choice(len(classes), p=weights))]
            reqs.append(
                Request(rid=rid, arrival=t, prompt=prompt, out_len=olen,
                        deadline_class=cls)
            )
        return reqs


# ------------------------------------------------------------- registry
WorkloadFactory = Callable[..., WorkloadSpec]

_REGISTRY: dict[str, WorkloadFactory] = {}
_PARAMS: dict[str, frozenset] = {}


def register_workload(name: str, factory: WorkloadFactory) -> None:
    if name in _REGISTRY:
        raise ValueError(f"workload {name!r} already registered")
    sig = inspect.signature(factory)
    _PARAMS[name] = frozenset(
        p.name for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    )
    _REGISTRY[name] = factory


def workload_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_workload(name: str, **params) -> WorkloadSpec:
    """Named workload -> spec; None params mean "use the preset default"."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown workload {name!r}; registered: "
            f"{', '.join(workload_names())}"
        )
    params = {k: v for k, v in params.items() if v is not None}
    unknown = sorted(set(params) - _PARAMS[name])
    if unknown:
        raise ValueError(
            f"workload {name!r} does not accept parameter(s) "
            f"{', '.join(unknown)}; accepted: "
            f"{', '.join(sorted(_PARAMS[name])) or '(none)'}"
        )
    return _REGISTRY[name](**params)


def _poisson(*, arrival_rate=0.15, num_requests=24, prompt_len=16,
             out_len=(8, 24), vocab=512):
    pl = (prompt_len, prompt_len) if isinstance(prompt_len, int) else tuple(prompt_len)
    ol = (out_len, out_len) if isinstance(out_len, int) else tuple(out_len)
    return WorkloadSpec(
        name="poisson", arrival_rate=float(arrival_rate),
        num_requests=int(num_requests), prompt_len=pl, out_len=ol,
        vocab=int(vocab),
    )


def _trickle(*, num_requests=12, prompt_len=16, out_len=(8, 24), vocab=512):
    """Well under any fleet's capacity: admission control must not shed."""
    w = _poisson(arrival_rate=0.02, num_requests=num_requests,
                 prompt_len=prompt_len, out_len=out_len, vocab=vocab)
    return dataclasses.replace(w, name="trickle")


def _overload(*, num_requests=24, prompt_len=16, out_len=(8, 24), vocab=512):
    """Arrivals far beyond slot capacity: the queue MUST shed load."""
    w = _poisson(arrival_rate=2.0, num_requests=num_requests,
                 prompt_len=prompt_len, out_len=out_len, vocab=vocab)
    return dataclasses.replace(w, name="overload")


def _chat(*, arrival_rate=0.6, num_requests=24, prompt_len=(8, 16),
          vocab=512):
    """Bimodal interactive traffic: mostly short replies, a long tail.

    The shape that makes fixed full-batch serving pay the most for
    padding everyone to the longest output — and where continuous
    batching's slot recycling wins.
    """
    w = _poisson(arrival_rate=arrival_rate, num_requests=num_requests,
                 prompt_len=prompt_len, out_len=(2, 28), vocab=vocab)
    return dataclasses.replace(
        w, name="chat",
        out_len_mix=(((2, 10), 2.0 / 3.0), ((20, 28), 1.0 / 3.0)),
    )


register_workload("poisson", _poisson)
register_workload("trickle", _trickle)
register_workload("overload", _overload)
register_workload("chat", _chat)
