"""Path M cells: the paper's coded matvec, query after query, through
``DecodePipeline`` over an A~ packed at set-up.

Set-up plans the fleet with the program's executor (integer loads and a
deadline of ``deadline_safety`` x the plan's expected latency), makes A
(k, d) and the systematic generator G = [I_k; P] (P ~ N(0, 1/k)) on the
card from the seed, and has the program encode and pack A~ = G A (B3).
Each query's x and finish mask are drawn before its clock starts: the
mask from the fleet's shifted-exponential model (1) at the plan's
deadline, t_w = alpha l_w / k + l_w / (k mu_w) Exp(1). A query's wall runs
from x on the card to z and ok ready after a synchronise. The window
keeps each wall as a host float and the outputs of the check's sample
alone (``Window``); garbage is collected once, just before it opens.

The check: every ok flag against whether the mask left k coded rows
(exact), counted as each query finishes; and, once the window has closed
and the program's state is freed, on a sample of the queries that
decoded, drawn from the seed as they come, z's error
against A x in float64 over the error of the plain float32 coded matvec
on the same mask (``reference.matvec.coded``), the widest such ratio.
The erasure solve amplifies float32's error by the condition of G_S,
which the mask sets and which has a long tail, so a raw error swings
with the mask where the ratio to the reference's does not.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from perfbench import gen, profiling
from perfbench.reference import matvec as ref


def plan(cx):
    """The program's executor for the configuration's fleet."""
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.runtime.executor import CodedRoundExecutor

    c = cx.config
    fleet = ClusterSpec.make(c["workers"], c["mu"], c["alpha"])
    return CodedRoundExecutor(fleet, int(c["k"]), c["scheme"],
                              deadline_safety=float(c["deadline_safety"]), device=cx.device)


def inputs(cx, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A (k, d) ~ N(0, 1) and G = [I_k; P], P ~ N(0, 1/k), on the card."""
    c = cx.config
    k, d = int(c["k"]), int(c["d"])
    n = cx.plan.n
    g = torch.Generator(device=cx.device).manual_seed(gen.sub_seed(seed, 11))
    a = torch.randn((k, d), generator=g, device=cx.device)
    big = torch.empty((n, k), device=cx.device)
    big[:k] = torch.eye(k, device=cx.device)
    big[k:].normal_(0.0, 1.0 / math.sqrt(k), generator=g)
    return a, big


class Queries:
    """Each query's x and finish mask, drawn from the seed on the card."""

    def __init__(self, cx, exe, seed: int):
        c = cx.config
        self.d, self.k = int(c["d"]), int(c["k"])
        self.g = torch.Generator(device=cx.device).manual_seed(gen.sub_seed(seed, 12))
        group = torch.as_tensor(exe.plan.group_of_worker, device=cx.device)
        mus = torch.as_tensor(c["mu"], dtype=torch.float32, device=cx.device)[group]
        alpha = c["alpha"]
        alphas = (torch.as_tensor(alpha, dtype=torch.float32, device=cx.device)[group]
                  if isinstance(alpha, list) else torch.full_like(mus, float(alpha)))
        self.loads = torch.as_tensor(exe.plan.loads_per_worker, dtype=torch.float32,
                                     device=cx.device)
        self.shift = alphas * self.loads / self.k
        self.scale = self.loads / (self.k * mus)
        self.deadline = float(exe.deadline)
        self.device = cx.device

    def next(self) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.randn(self.d, generator=self.g, device=self.device)
        e = torch.empty_like(self.loads).exponential_(generator=self.g)
        return x, (self.shift + self.scale * e) <= self.deadline

    def decodable(self, mask: torch.Tensor) -> bool:
        """The mask leaves at least k coded rows."""
        return bool(self.loads[mask].sum() >= self.k)

    def rows(self, plan, mask: torch.Tensor) -> torch.Tensor:
        """The first k coded rows, in row order, of the workers that finished
        (each worker holds the rows ``plan.row_ranges`` gives it)."""
        done = mask.cpu().tolist()
        rows = [r for w, (lo, hi) in enumerate(plan.row_ranges) if done[w]
                for r in range(lo, hi)]
        return torch.tensor(sorted(rows)[: self.k], device=mask.device)


class Window:
    """What the harness keeps of a run of queries: each query's wall as a
    host float, ``failed`` (ok False) and ``wrong_ok`` (ok against whether
    the mask left k coded rows) counted as each query finishes, and x, the
    mask and z of the check's sample alone. The sample is drawn from the
    seed as the queries come (Algorithm R): at most ``keep`` of the queries
    that decoded, each equally likely; a replaced entry is dropped."""

    def __init__(self, qs: Queries, keep: int, seed: int):
        self.qs, self.keep = qs, int(keep)
        self.walls: list[float] = []
        self.failed = self.wrong_ok = self.decoded = 0
        self.picked: dict[int, tuple] = {}  # reservoir slot -> (query index, x, mask, z)
        self.g = torch.Generator().manual_seed(seed)

    @property
    def attempted(self) -> int:
        return len(self.walls)

    def add(self, x, mask, z, ok, wall: float) -> None:
        index = len(self.walls)
        self.walls.append(wall)
        ok = bool(ok)
        self.failed += not ok
        self.wrong_ok += ok != self.qs.decodable(mask)
        if not ok:
            return
        seen, self.decoded = self.decoded, self.decoded + 1
        slot = seen if seen < self.keep else int(torch.randint(seen + 1, (1,), generator=self.g))
        if slot < self.keep:
            self.picked[slot] = (index, x, mask, z)

    def sample(self) -> list[tuple]:
        """The sampled queries, (x, mask, z) each, in the window's order."""
        return [q[1:] for q in sorted(self.picked.values(), key=lambda q: q[0])]


def run_queries(pipe, packed, win: Window, n: int, *, seconds: float | None = None) -> Window:
    """Queries until ``win`` holds ``n`` or ``seconds`` have passed."""
    qs, t0 = win.qs, time.perf_counter()
    sync = torch.cuda.synchronize if packed.device.type == "cuda" else (lambda: None)
    while win.attempted < n and (seconds is None or time.perf_counter() - t0 < seconds):
        x, mask = qs.next()
        sync()
        t = time.perf_counter()
        z, ok = pipe(packed, x, mask)
        sync()
        wall = time.perf_counter() - t
        win.add(x, mask, z, ok, wall)
    return win


def sync(cx) -> None:
    if cx.device.type == "cuda":
        torch.cuda.synchronize()


def build(cx, seed: int):
    """(queries, pipeline, packed A~, A, G): the program's encode and pack."""
    from repro_torch.core.coded_matvec import DecodePipeline, pack_coded_matrix
    import repro_torch.kernels as kernels

    cx.mark("imports")
    if cx.device.type == "cuda":
        kernels.build_all()
    cx.mark("kernels")
    exe = plan(cx)
    cx.plan = exe.plan
    cx.mark("plan")
    a, g = inputs(cx, seed)
    sync(cx)
    cx.mark("inputs")
    packed, row_of = pack_coded_matrix(g, a, exe.plan)
    sync(cx)
    cx.mark("encode")
    return Queries(cx, exe, seed), DecodePipeline(g, row_of), packed, a, g


def window(cx, qs: Queries) -> Window:
    """An empty window whose sample is the check's: ``check.queries`` of the
    queries that decoded, drawn from the seed."""
    return Window(qs, int(cx.mix["check"]["queries"]), gen.sub_seed(cx.seed, 13))


def judge(cx, win: Window, a: torch.Tensor, g: torch.Tensor, *, control: bool = False) -> dict:
    """``wrong_ok``: ok flags that disagree with the mask, over every query;
    ``err_ratio``: the widest ratio of z's error to the plain float32
    reference's on the sampled queries (with ``control``, also the
    control's ratio, and both raw errors)."""
    picked = win.sample()
    out = {"wrong_ok": win.wrong_ok, "err_ratio": float("inf") if not picked else 0.0}
    raw, ctl, ctl_raw = [], [], []
    for x, mask, z in picked:
        want = ref.exact(a, x[:, None])[:, 0]
        rows = win.qs.rows(cx.plan, mask)
        base = (ref.coded(g, a, x, rows) - want).norm()
        err = (z.double() - want).norm()
        out["err_ratio"] = max(out["err_ratio"], float(err / base))
        raw.append(float(err / want.norm()))
        if control:
            e = (ref.coded(g, a, x, rows, tf32=True) - want).norm()
            ctl.append(float(e / base))
            ctl_raw.append(float(e / want.norm()))
    out["max_rel_err"] = max(raw, default=float("nan"))
    if control:
        out["control_err_ratio"] = max(ctl, default=float("nan"))
        out["control_max_rel_err"] = max(ctl_raw, default=float("nan"))
    return out


def run(cx) -> None:
    qs, pipe, packed, a, g = build(cx, cx.seed)
    run_queries(pipe, packed, window(cx, qs), int(cx.mix["warmup_queries"]))
    gc.collect()
    cx.mark("warmup")
    win = run_queries(pipe, packed, window(cx, qs), 10**9, seconds=cx.seconds)
    cx.window = win
    if cx.trace:
        # a few more queries under the profiler, their inputs drawn first
        # so that the window holds the queries' work alone
        drawn = [qs.next() for _ in range(int(cx.mix["profile_queries"]))]
        prof = profiling.Window()
        prof.start()
        for x, mask in drawn:
            with profiling.annotate("query"):
                pipe(packed, x, mask)
                if cx.device.type == "cuda":
                    torch.cuda.synchronize()
        prof.stop()
        cx.profile = prof.trace
        cx.profiled_queries = len(drawn)
    if cx.device.type == "cuda":
        torch.cuda.synchronize()
        cx.memory_peak_bytes = torch.cuda.max_memory_allocated(cx.device)
    cx.attempted, cx.failed = win.attempted, win.failed
    pipe = packed = None
    gc.collect()
    if cx.device.type == "cuda":
        torch.cuda.empty_cache()
    r = judge(cx, win, a, g)
    cx.checks = {"err_ratio": (r["err_ratio"], cx.limit("err_ratio")),
                 "wrong_ok": (float(r["wrong_ok"]), 0.0)}
    cx.correct = all(v <= lim for v, lim in cx.checks.values())
