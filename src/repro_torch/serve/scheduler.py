"""Slot-based in-flight batching scheduler with admission control.

Host-only copy of ``repro/serve/scheduler.py``: the same decisions and
the same telemetry events for the same call sequence.

``SlotScheduler`` owns the HOST side of continuous batching: which
request occupies which of the ``S`` padded stream slots, the FIFO
admission queue, and the load-shedding rule. It never touches device
buffers — the serve loop (``runtime/serve_loop.py``) asks it *what* to
do each round (which requests to splice into which slots, which finished
slots to retire) and performs the actual buffer updates inside the
compiled programs. That split keeps every scheduling decision
deterministic, replayable from the seeded trace alone, and testable
without a model.

Admission control (DESIGN.md §10): a request is shed at enqueue time
when its projected completion — queue backlog drained at ``slots``
requests at a time, scaled by the fleet's current mean-field round
latency relative to a reference — exceeds its deadline class's slack
budget. ``round_latency`` is wired to
``AdaptiveController.coverage_latency`` by the server, so the fleet
sheds load *before* deadlines collapse when the tracker sees rounds
slowing down. ``batch``-class requests are never shed for deadline risk;
a full queue rejects any class.

Paged serving (DESIGN.md §13) adds the physical-memory dimension: a
``BlockPool`` free list of fixed KV blocks. Admission then requires the
request's full block reservation (prompt + out_len + 1 tokens, rounded
up to blocks) to be allocatable: a request that can NEVER fit the pool
is shed at enqueue time with reason ``pool_exhausted`` (admission
control on memory, not queue depth alone), while transient pressure
just holds the queue head until blocks free. Blocks are freed on
retirement/eviction and reused LIFO.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.workload import CLASS_PRIORITY, DEADLINE_SLACK, Request


class BlockPool:
    """Free list over a fixed pool of physical KV blocks.

    The device side never sees this object — it only receives the block
    tables the scheduler builds from these allocations. LIFO reuse keeps
    recently-freed (cache-warm) blocks hot and makes reuse assertable in
    tests. Telemetry (``kv_bytes`` / ``blocks_in_use`` /
    ``blocks_freed`` events, DESIGN.md §8) makes pool pressure
    observable alongside ``round_timing``; occupancy tallies live in a
    ``MetricsRegistry`` (§14) so a run's final ``metrics_snapshot``
    carries the pool view without replaying the event stream.
    """

    def __init__(self, num_blocks: int, block_len: int, *,
                 bytes_per_block: int = 0, telemetry=None, metrics=None):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be > 0, got {num_blocks}")
        if block_len <= 0:
            raise ValueError(f"block_len must be > 0, got {block_len}")
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        self.bytes_per_block = int(bytes_per_block)
        self.telemetry = telemetry
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._freed = self.metrics.counter("kv_blocks_freed")
        self._in_use_gauge = self.metrics.gauge("kv_blocks_in_use")
        self._util_gauge = self.metrics.gauge("kv_pool_utilization")
        # stack: first allocations get blocks 0, 1, ...; frees push back
        # on top so the most recently freed blocks are reused first
        self._free = list(range(num_blocks - 1, -1, -1))

    @property
    def blocks_freed(self) -> int:
        """Cumulative blocks returned to the pool."""
        return self._freed.value

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` KV entries."""
        return -(-int(tokens) // self.block_len)

    def alloc(self, n: int, *, rid=None, now: float = 0.0) -> list[int] | None:
        """Take ``n`` blocks off the free list; None if unavailable."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._emit(rid, now, freed=0)
        return got

    def free(self, blocks, *, rid=None, now: float = 0.0) -> None:
        self._free.extend(blocks)
        if blocks:
            self._freed.inc(len(blocks))
            self._emit(rid, now, freed=len(blocks))

    def _emit(self, rid, now: float, *, freed: int) -> None:
        self._in_use_gauge.set(self.blocks_in_use)
        self._util_gauge.set(self.blocks_in_use / self.num_blocks)
        if self.telemetry is None:
            return
        common = dict(request_id=rid, round=float(now))
        if freed:
            self.telemetry.event(
                "blocks_freed", blocks=freed,
                total_freed=self.blocks_freed, **common,
            )
        self.telemetry.event(
            "blocks_in_use", in_use=self.blocks_in_use,
            free=self.free_blocks, capacity=self.num_blocks, **common,
        )
        self.telemetry.event(
            "kv_bytes",
            bytes_in_use=self.blocks_in_use * self.bytes_per_block,
            bytes_total=self.num_blocks * self.bytes_per_block,
            utilization=self.blocks_in_use / self.num_blocks, **common,
        )


@dataclasses.dataclass
class SlotState:
    """One padded stream slot of the running decode scan."""

    request: Request | None = None
    admitted_at: float = 0.0  # round the request entered the slot
    generated: int = 0  # tokens emitted so far (first token lands at admit)
    prefilled: int = 0  # prompt tokens prefilled so far (chunked prefill)
    blocks: tuple[int, ...] = ()  # physical KV blocks reserved (paged)

    @property
    def busy(self) -> bool:
        return self.request is not None

    @property
    def prefilling(self) -> bool:
        """Still consuming prompt chunks (not yet decode-eligible)."""
        return self.busy and self.prefilled < self.request.prompt_len

    @property
    def done(self) -> bool:
        return (
            self.busy and not self.prefilling
            and self.generated >= self.request.out_len
        )


@dataclasses.dataclass(frozen=True)
class FinishedRequest:
    """Terminal record of one request (done or shed)."""

    request: Request
    outcome: str  # "done" | "shed"
    reason: str  # "finished" | "queue_full" | "deadline_risk"
    queue_wait: float  # rounds between arrival and admission (0 if shed)
    finish_round: float
    tokens: int

    @property
    def latency(self) -> float:
        """Arrival-to-last-token latency in rounds (shed => inf)."""
        if self.outcome != "done":
            return float("inf")
        return self.finish_round - self.request.arrival


class SlotScheduler:
    """Admission queue + slot assignment for ``S`` in-flight streams.

    Drive it with the serve loop's virtual clock: ``offer(req, now)``
    when a request arrives, ``fill_slots(now)`` whenever slots may be
    free, ``advance(emitted, now)`` after each decode round,
    ``retire_done(now)`` to evict finished streams. All decisions are
    pure functions of the call sequence — replaying the same trace
    reproduces the same schedule exactly.
    """

    def __init__(
        self,
        slots: int,
        *,
        queue_cap: int = 64,
        admission_threshold: float = 1.0,
        round_latency: Callable[[], float] | None = None,
        reference_latency: float = 1.0,
        telemetry=None,
        pool: BlockPool | None = None,
        chunk: int | None = None,
        metrics: MetricsRegistry | None = None,
    ):
        if slots <= 0:
            raise ValueError(f"slots must be > 0, got {slots}")
        if queue_cap < 0:
            raise ValueError(f"queue_cap must be >= 0, got {queue_cap}")
        if not admission_threshold > 0:
            raise ValueError(
                f"admission_threshold must be > 0, got {admission_threshold}"
            )
        self.slots = [SlotState() for _ in range(slots)]
        self.queue: list[tuple[Request, float]] = []  # (request, arrival)
        self.queue_cap = queue_cap
        self.admission_threshold = admission_threshold
        self.round_latency = round_latency
        self.reference_latency = float(reference_latency)
        self.telemetry = telemetry
        self.pool = pool
        self.chunk = chunk
        # shed/admitted tallies and per-deadline-class latency
        # percentiles live in the registry (§14); the serve loop shares
        # one registry between scheduler and pool so a run snapshots as
        # a unit
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._admitted = self.metrics.counter("requests_admitted")
        self._shed_total = self.metrics.counter("requests_shed_total")
        self._queue_gauge = self.metrics.gauge("queue_depth")
        self.finished: list[FinishedRequest] = []

    @property
    def shed(self) -> int:
        """Requests shed at enqueue time (all reasons)."""
        return self._shed_total.value

    @property
    def admitted(self) -> int:
        """Requests that entered a stream slot."""
        return self._admitted.value

    # ------------------------------------------------------------- views
    @property
    def num_slots(self) -> int:
        return len(self.slots)

    @property
    def busy_slots(self) -> int:
        return sum(s.busy for s in self.slots)

    @property
    def idle(self) -> bool:
        return not self.queue and all(not s.busy for s in self.slots)

    def _work(self, req: Request) -> float:
        """Rounds of compute a request costs; chunked prefill counts
        one round per prompt chunk instead of one flat admit round."""
        if self.chunk is None:
            return float(req.work)
        return float(-(-req.prompt_len // self.chunk) + req.out_len)

    def blocks_needed(self, req: Request) -> int:
        """Full KV reservation: prompt + generated tokens + next write."""
        assert self.pool is not None
        return self.pool.blocks_for(req.prompt_len + req.out_len + 1)

    def _latency_factor(self) -> float:
        """Current round latency relative to the reference (>= 0)."""
        if self.round_latency is None:
            return 1.0
        t = float(self.round_latency())
        if t != t or t == float("inf"):  # NaN/inf: fleet cannot cover k
            return float("inf")
        return max(t, 0.0) / self.reference_latency

    # --------------------------------------------------------- admission
    def offer(self, req: Request, now: float) -> bool:
        """Enqueue a newly arrived request, or shed it. True = accepted."""
        if len(self.queue) >= self.queue_cap:
            self._shed(req, now, "queue_full")
            return False
        if self.pool is not None and self.blocks_needed(req) > self.pool.num_blocks:
            # memory admission control: the reservation can NEVER be
            # satisfied, even by an empty pool — shed now rather than
            # deadlocking at the queue head (transient pressure from
            # in-flight requests just waits for frees instead).
            self._shed(req, now, "pool_exhausted")
            return False
        slack = DEADLINE_SLACK[req.deadline_class]
        if slack != float("inf"):
            # projected completion: the backlog ahead of this request
            # drains ``slots`` streams at a time, then the request runs
            # its own prefill + decode — all scaled by how slow the
            # fleet's rounds currently are vs the reference.
            work = self._work(req)
            backlog = sum(self._work(r) for r, _ in self.queue) + sum(
                self._work(s.request) - s.generated
                for s in self.slots if s.busy and s.request is not None
            )
            est = (backlog / self.num_slots + work) * self._latency_factor()
            budget = slack * work / self.admission_threshold
            if est > budget:
                self._shed(req, now, "deadline_risk")
                return False
        self.queue.append((req, now))
        self._queue_gauge.set(len(self.queue))
        return True

    def _shed(self, req: Request, now: float, reason: str) -> None:
        self._shed_total.inc()
        self.metrics.counter("requests_shed", reason=reason).inc()
        self.finished.append(
            FinishedRequest(
                request=req, outcome="shed", reason=reason,
                queue_wait=0.0, finish_round=now, tokens=0,
            )
        )
        if self.telemetry is not None:
            self.telemetry.event(
                "request_evicted",
                request_id=req.rid, reason=reason,
                deadline_class=req.deadline_class, round=float(now),
                queue_depth=len(self.queue),
            )

    # ------------------------------------------------------ slot control
    def fill_slots(self, now: float) -> list[tuple[int, Request]]:
        """Admit queued requests into free slots; deadline class first.

        Within a class the queue stays FIFO (stable sort on priority).
        Returns the (slot index, request) assignments made this call —
        the serve loop splices each one's prefilled cache into that slot.
        """
        free = [i for i, s in enumerate(self.slots) if not s.busy]
        if not free or not self.queue:
            return []
        self.queue.sort(key=lambda e: CLASS_PRIORITY[e[0].deadline_class])
        placed = []
        for slot_idx in free:
            if not self.queue:
                break
            blocks: tuple[int, ...] = ()
            if self.pool is not None:
                # full reservation up front: admission is the only point
                # that can fail on memory, so a slotted request always
                # runs to completion. Head-of-line waits (FIFO, no
                # deadlock: its reservation fits an empty pool or offer
                # would have shed it).
                req_head = self.queue[0][0]
                got = self.pool.alloc(
                    self.blocks_needed(req_head), rid=req_head.rid, now=now
                )
                if got is None:
                    break
                blocks = tuple(got)
            req, arrived = self.queue.pop(0)
            # without chunked prefill the whole prompt is spliced in at
            # admission; with it, the serve loop reports progress via
            # note_prefill() as chunks land across admit rounds.
            done_prefill = req.prompt_len if self.chunk is None else 0
            self.slots[slot_idx] = SlotState(
                request=req, admitted_at=now, generated=0,
                prefilled=done_prefill, blocks=blocks,
            )
            self._admitted.inc()
            self._queue_gauge.set(len(self.queue))
            placed.append((slot_idx, req))
            if self.telemetry is not None:
                self.telemetry.event(
                    "request_admitted",
                    request_id=req.rid, slot=slot_idx,
                    queue_wait=float(now - arrived),
                    deadline_class=req.deadline_class, round=float(now),
                )
        return placed

    def advance(self, emitted: int = 1, now: float | None = None) -> None:
        """Account ``emitted`` new tokens on every busy, unfinished slot.

        Slots still prefilling (chunked prefill in flight) are not
        decoding yet and accrue nothing.
        """
        for s in self.slots:
            if s.busy and not s.prefilling and not s.done:
                s.generated = min(
                    s.generated + emitted, s.request.out_len
                )

    def note_prefill(self, slot_idx: int, tokens: int) -> None:
        """Record ``tokens`` prompt tokens prefilled into a slot."""
        s = self.slots[slot_idx]
        if s.busy:
            s.prefilled = min(s.prefilled + tokens, s.request.prompt_len)

    def retire_done(self, now: float) -> list[tuple[int, FinishedRequest]]:
        """Evict finished streams; their slots become admissible again."""
        out = []
        for i, s in enumerate(self.slots):
            if not s.done:
                continue
            req = s.request
            fin = FinishedRequest(
                request=req, outcome="done", reason="finished",
                queue_wait=0.0, finish_round=now, tokens=s.generated,
            )
            self.finished.append(fin)
            out.append((i, fin))
            self.metrics.histogram(
                "request_latency", deadline_class=req.deadline_class
            ).observe(fin.latency)
            self.metrics.counter("tokens_emitted").inc(s.generated)
            if self.pool is not None and s.blocks:
                self.pool.free(s.blocks, rid=req.rid, now=now)
            self.slots[i] = SlotState()
            if self.telemetry is not None:
                self.telemetry.event(
                    "request_done",
                    request_id=req.rid, slot=i, tokens=s.generated,
                    latency=float(now - req.arrival),
                    deadline_class=req.deadline_class, round=float(now),
                )
        return out
