#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100: build, check and time its kernels,
run the paper's coded matvec at full width (in one process, then split over
the ranks of its workers mesh), run the paper's Monte-Carlo evaluation on
the card, serve full-width qwen3-0.6b
through the coded server (paged and dense), generate with it under every
baseline allocation scheme, profile those serving paths phase by phase with
their spans on a telemetry stream, generate under a drifting fleet with
closed-loop replanning (simulated, then measured by a round clock with plan
buckets), hold the dispatch programs captured as CUDA graphs (every serve
and generate replays them by default) against the same programs run
eagerly, run the serving CLI and its ops report, serve the other configs of
the port's envelope at full width (granite-3-2b, yi-9b, moonshot-v1-16b-a3b
and paligemma-3b paged; h2o-danube-3-4b, plain and int8 KV, whisper-tiny,
zamba2-1.2b and xlstm-125m through the sequential prefill), serve
moonshot-v1-16b-a3b at full depth with bf16 parameters, then train
qwen3-0.6b with gradient coding, plain and then adaptive under measured
round times, train a config of every other family (whisper-tiny,
xlstm-125m, zamba2-1.2b, paligemma-3b, granite-3-2b, moonshot-v1-16b-a3b),
then check the deployment layer: the dry-run's count against the card's,
the local mesh and the sharding rules, and the four examples.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``--train-family ARCH [--seq N]`` builds the kernels and runs only that
[train-families] config, its steps at N positions.)

Phases (any failure raises, and the script exits non-zero):

1. set-up   — build the CUDA kernels from ``src/repro_torch`` (one
   ``nvcc`` per source, all at once, into ``build/kernels/``);
2. kernels  — each kernel against its plain PyTorch version on the card
   at its main path's full-width shapes (serve for B1-B3, train for the
   fused cross-entropy B4; its forward and backward kernels also launched
   twice and held bit-identical, and each split by the profiler into its
   stages), with the tolerance stated, timed beside the plain version and
   one PyTorch library call. B1 and B2 (a few microseconds each, so a
   mean of back-to-back calls measures the host's pace) are also timed by
   device time: the profiler's summed kernel time per call, for them and
   for their library calls; both are launched twice and held
   bit-identical, their launch plans, registers and blocks in flight are
   printed, B2 is held once more at head_dim 120 (h2o-danube-3-4b's), and
   timed over 28 pools in turn with the L2 flushed before each call;
3. matvec   — Path M, the paper's coded matvec: counters reset, then
   ``end_to_end_coded_matvec`` of a seeded A (20,000 x 4,096) and x on the
   quickstart's 200-worker fleet (B3 encode, B1's narrow branch over the
   workers as a batch, the erasure decode), the finish mask at the plan's
   deadline with two slowest-group workers forced out; counters read
   after; the result held against A x in float64 within its error model,
   an insufficient mask flagged; B1's narrow branch and B3 at these shapes
   held against their plain versions and timed (B1 beside ``torch.mv``);
   matvec-mesh — Path M on the paper's workers mesh: worlds of 1 (NCCL,
   ``make_workers_mesh()``), 2 and 4 ranks (gloo: the ranks share the one
   card), each rank a process of its own, one world at a time; counters
   and the peak allocated reset before ``end_to_end_coded_matvec(...,
   mesh=)`` (A passed on the master only) and read after: the master
   draws G, runs B3 once and packs, then scatters each rank its block of
   W / R workers (B3 0 on every other rank, whose peak stays within its
   block + 64 MiB); one B1 launch a rank on its block; z and the gathered
   products on every rank bit-identical to [matvec]'s, ok True, the
   insufficient mask False and zeros, no JAX imported; each world's wall
   split into the master's encode, the scatter, products and gather, and
   decode, each rank's peak, and B1's device time on a block of each
   world's shape;
   paper — the paper's Section IV Monte Carlo on the card: Fig. 4's
   setting (five groups, k 100,000, N 250 to 8,000, 10,000 trials) through
   ``CodedComputeEngine`` with a CUDA ``torch.Generator`` for the proposed
   scheme, uniform at n* and at 2k, uncoded and the group code at r 100,
   beside T* (``lower_bound``): proposed >= 0.95 T*, proposed / T* within
   1e-3 of 1 at N 8,000, uniform_n* above proposed, the group code >= 10x
   at N 8,000, the card's N 1,000 mean within 4 standard errors of the
   CPU's; Fig. 2's N T* on the host through ``scale_mu`` and
   ``lower_bound``, invariant to 1e-9 over scales 1, 2 and 4;
4. serve    — launch counters reset, then ``Server`` + ``serve`` of a
   seeded 8-request trace on full-width qwen3-0.6b (random seeded
   weights) with the coded LM head on a 12-worker cluster; counters read
   right after; then a few coded rounds on real logits held against the
   uncoded logits;
5. serve-dense — the same trace through ``serve(paged=False)`` (dense
   per-slot caches, no B2), counters reset before and read after; the
   first-round logits of the dense and the paged prefill held together;
6. generate — ``Server.generate`` of 4 x 128-token prompts: uncoded (8
   new tokens), coded under ``optimal`` (8), then under ``uniform_r``,
   ``uniform_r_group_code``, ``reisizadeh``, ``uncoded``, ``comm_aware``
   and ``comm_uniform`` (4 each; the comm pair behind finite links),
   counters reset before each and read after; every coded run's tokens
   held against the uncoded run's where the margin is clear;
   obs      — the serving paths with the observability layer on, each in
   its own ``obs.profile.capture`` session (a ``torch.profiler`` phase),
   on a short trace (``obs_trace``: 1 request) served twice first without
   the profiler on the same server (built, then captured: the profile
   sees replays): the paged serve with a ``Telemetry`` JSONL (its spans ride on
   it), the dense serve measured by a ``RoundClock`` with a controller that
   holds, and generate's first 2 tokens; streams and tokens equal the
   unprofiled ones, every JSONL record validates against
   ``repro_torch.obs.schema``, the chunk spans equal the dispatches; per
   phase the wall, the device-op time (each kernel filed under the phase
   that launched it) and the top five ops, B1, B2 and B3's device launches
   in the profile equal to their counters times the launches per call,
   device time <= wall; the ops report (``launch.obsreport``) with every
   section;
7. adapt    — Path R, closed-loop replanning: for ``mu_step`` and
   ``churn`` (12 rounds, trace seed 0), counters reset, then one coded
   ``generate`` a round (4 x 16-token prompts, 4 new) under the
   scenario's true fleet with an ``AdaptiveController`` replanning the
   head (every 2 rounds, threshold 0.05); counters read after; each
   replan's B3 re-encode held against its plain version, tokens against
   the uncoded ones, ``churn``'s membership replans at rounds 3 and 9;
8. adapt-measured — (c) ``mu_step`` as in ``adapt`` but each round timed
   by a ``RoundClock`` (until the device is done) and fed to the
   controller through ``observe_timing``, the head bucketed (quantum 4):
   B3 == 1 + structural replans, the tokens held as in ``adapt``; (d)
   the serve phase's trace through ``serve(clock=)`` with no controller:
   the streams equal the serve phase's, fed == dispatches - 1; and one
   replan's allocation timed on the fused torch cores and on the numpy
   eager oracle; counters reset before (c) and (d) and read after;
   programs — the dispatch programs captured as CUDA graphs against the
   same program functions uncaptured (``Server._capture = False``): the
   paged and the dense serve of [serve]'s trace (eager once; captured
   twice, the second run all replays, then a second trace with another
   prompt mix that must build and capture nothing) and ``generate`` of
   [generate]'s prompts for two seeds; streams, tokens, decode ok and
   erased rounds identical, B1-B3 launches equal; per mode the walls,
   builds, captures and capture seconds, and the card's busy share from
   a profile of a few steady dispatches;
9. cli      — five subprocesses started together: ``python -m
   repro_torch.launch.serve --coded`` with ``--scheme uniform_r`` (exit 0,
   its coded-head line), ``--scenario churn --adapt-every 2 --rounds 12``
   (exit 0, its replan lines and the controller line) and ``--trace
   poisson --num-requests 8 --slots auto --telemetry ... --chrome-trace
   ...`` (exit 0, its width, Chrome trace and serve lines); ``python -m
   repro_torch.launch.train --hetero-groups 6:8.0,6:0.7`` (2 steps of 8 x
   32) on xlstm-125m (exit 0, its ``coded training:`` line) and on
   whisper-tiny (a non-zero exit with the reference's extras message);
   then ``python -m repro_torch.launch.obsreport`` on the serve JSONL with
   ``--require-spans`` (exit 0, ``span coverage:``);
   families — the model envelope at full width, one model on the card at a
   time (its own seeded init; freed, and the allocator checked, before the
   next): per config B1 and B3 at its coded head's shapes and B2 at its
   serve shape held against their plain versions and timed beside the
   library call, then granite-3-2b (20 of 40 layers) and yi-9b (24 of 48)
   through the serve phase's trace paged (yi also dense, with the
   serve-dense phase's checks), moonshot-v1-16b-a3b (MoE, 64 experts
   top-6) at 12 of its 48 layers (27.7 B parameters do not fit in 80 GB
   in float32) paged, each
   with the serve phase's coded-round check; paligemma-3b (vlm: 18 layers,
   MQA, hd 256, GELU) paged as well (B2 at KV 1, G 8, hd 256), and its
   ``lm_logits`` with random image embeddings against zero ones (the
   logits must differ); h2o-danube-3-4b (8 of 24 layers, window 4,096)
   ``generate`` of [generate]'s prompts through the sequential prefill,
   with its cache and with the int8 one, and whisper-tiny (from the
   encoder output of random frames), zamba2-1.2b (13 of 38 Mamba2 layers,
   the shared block at 0, 6 and 12) and xlstm-125m (sLSTM at layers 6 and
   12) alike,
   each held against its uncoded run; counters reset before each path and
   read after; then the reduced danube (window 64) generates past its
   window on the card and on the CPU, the same weights, the logits held
   together, and the reduced paligemma, whisper, zamba and xlstm (sLSTM
   every 2nd layer) likewise: ``lm_logits`` within 2e-4 + 2e-4 |want| and
   a 24 + 8 generate with equal tokens; then the reduced qwen3-0.6b and
   moonshot-v1-16b-a3b with bf16 parameters alike;
   moonshot-bf16 — moonshot-v1-16b-a3b at full depth and width (48
   layers, 27.7 B parameters) with bf16 parameters and bf16 compute,
   built with nothing large resident: the init's peak at most the memory
   before + the parameters + the embedding's float32 draw + 1 GiB; the
   serve phase's trace paged with the ``optimal`` coded head through the
   default captured programs, counters reset before and read after (B1
   once a decode step, B2 48 a decode step, B3 once), the serve phase's
   coded-round checks, the serve's peak under 62 GiB; one replayed
   one-request serve profiled (device time by group, top ops); the trace
   again through an uncaptured server that records every coded round:
   each within cond(G_S) 2^-22 max|logits| of its uncoded logits, each
   coded token equal to the uncoded argmax wherever the top-2 margin
   allows; the model's memory freed after;
10. train   — launch counters reset, then ``Trainer.run`` of 4 gradient-
   coded steps of full-width qwen3-0.6b (seeded init, batch 16 x 512) on
   the same fleet; counters read right after; then one more steady step
   under ``torch.profiler`` (device time by kernel); then a decodable round
   with two workers erased held against the plain full-batch gradient,
   and a round at deadline 0 that must leave every parameter and the
   optimizer state bit-unchanged;
11. train-adapt — the same model size, batch and fleet with a
   ``RoundClock`` feeding an ``AdaptiveController`` every 2 steps: (a)
   12 steps of ``churn`` with plan buckets (quantum 4): each decision,
   bucket hit or miss and structural flag, the round after each replan
   beside the smoothed round, the clock's counts and the step builds;
   the membership replans at steps 4 and 9 (to 9, then 12 workers); (b)
   10 steps on the static fleet with a real sleep of 0.5 x unit_s x the
   deadline on the fast group from fed round 5: a replan within two
   cadences that gives that group fewer rows. B4 launches == steps
   (forward) and steps not skipped (each backward), counted per run;
12. train-families — one model on the card at a time (seeded, float32
   parameters, bf16 compute; freed, and the allocator checked, before the
   next), each first with B4 at its (T, V, D) held against its plain
   version and timed beside the library call: 3 steps on the serve fleet,
   counters reset before and read after (one finite history record a
   step, B4's forward once a step, each backward once a step not
   skipped, the peak allocated) of whisper-tiny (4 + 4 layers, 8 x 448)
   and paligemma-3b (18 layers, 8 x 512) plain, each after a coded
   ``Trainer.run`` that must raise the reference's extras message, both on
   seeded random extras (``make_extras``' zero stubs checked on the card
   and their gradient reported), and of xlstm-125m (8 x 64: its time
   loops), zamba2-1.2b, granite-3-2b (8 x 512 each) and
   moonshot-v1-16b-a3b (4 of 48 layers) coded, ``grad_coding`` k 8: a
   round with two workers erased against the full-batch gradient in f32
   (xlstm at full width; the others, whose D 2048 B4's f32 kernels refuse,
   on the reduced config's f32 model; the MoE against the mean of the
   partitions' own gradients, each partition its own routing pool) and
   a deadline-0 round that must change nothing; zamba's and xlstm's
   steady step profiled (B4's share, the card's busy share); then the
   reduced paligemma, whisper, zamba and xlstm (sLSTM every 2nd layer):
   one plain step's loss and every gradient leaf card against CPU within
   2e-4 |want| + max(2e-6, 2e-5 max|want|);
13. dryrun, mesh and examples, overlapped for the run's time —
   dryrun: ``python -m repro_torch.launch.dryrun`` in processes of its
   own, counted on ``meta`` on the host's cores: qwen3-0.6b at every
   shape on both production meshes, whisper-tiny prefill_32k and
   moonshot-v1-16b-a3b decode_32k with the coded head (each record: 256
   or 512 chips, FLOPs > 0, a bottleneck of the three terms), and the
   one-card sizing of ``SIZING_CELLS`` (``a4_sizing``); meanwhile a
   real qwen3-0.6b train step on the card at train_4k cut to batch 8 and
   4 of 28 layers, counted by ``FlopCounterMode`` plus B4's cost
   functions, must equal the dry-run's meta count of that cell exactly,
   with B4 launched once forward and once backward; one more step timed
   by CUDA events beside max(t_compute, t_memory), its peak allocated
   beside the reckoned argument and temp bytes;
   mesh (once the card's timed step is done): ``make_local_mesh()`` (one
   NCCL rank): qwen3-0.6b's
   parameters placed by ``make_param_sharding``, each local shard equal to
   its parameter bit for bit, ``lm_logits`` of a model loaded from the
   local shards equal to the original's exactly; the group destroyed;
   examples (after mesh): the four ``examples/torch_*.py``, each loaded
   and its ``main`` called on the card (train_lm 30 steps of 8 x 8 at one
   layer), launch counters reset before each; return code 0, each one's
   own check (the coded matvec recovers A x,
   coded tokens equal uncoded ones, both replans, the loss falls by more
   than 1 nat), B1 and B3 launched in the first two and B4 in train_lm.

The last three stdout lines are the card (``nvidia-smi``), the kernels
JSON (each kernel's launches on every path beside its main path's, B1 and
B3 also at Path M's shapes, B1-B3 at each [families] config's shapes and
B4 at each [train-families] config's) and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: NVIDIA H100 SXM data-sheet peaks (dense): float32 SIMT and bf16 tensor
#: FLOP/s, HBM3 bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

CLUSTER = ([6, 6], [8.0, 0.7])  # the serve benchmark's fleet
SLOTS, BLOCK_LEN, CHUNK, DECODE_BLOCK, SAFETY = 4, 16, 64, 4, 1.2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, PARTITIONS = 16, 512, 4, 16
U32 = 2.0**-24  # float32 unit roundoff


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """Least time for the work: max(bytes / HBM rate, ops / peak), in ms."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls between two
    CUDA events. For a kernel of a few microseconds this is paced by the
    host issuing the calls (``device_ms`` reads the kernels' own time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def setup():
    import repro_torch.kernels as kernels

    t = time.perf_counter()
    kernels.build_all()
    print(f"[setup] built {len(kernels.KERNELS)} kernels in "
          f"{time.perf_counter() - t:.1f} s")
    for log in dict.fromkeys(k.log for k in kernels.KERNELS):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[setup] {log.stem}: {line.strip()}")


def device_us(ev) -> float:
    """Self device time (us) of a ``torch.profiler`` averaged event."""
    return float(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)) or 0.0)


def profiled(fn, calls: int = 1) -> list | None:
    """(name, device us) of each kernel that ``calls`` calls of ``fn`` launch,
    under ``torch.profiler``. The profiler loses the first kernels of a
    capture now and then (late in a long process, 1 to 50 calls' worth;
    none in a fresh process), so the capture makes the same calls twice
    with a marker kernel (``torch.cuda._sleep``'s spin kernel) between,
    and keeps the kernels that started after the marker. None when the
    marker itself was lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.start for e in kernels if "spin_kernel" in e.name]
    if not marks:
        return None
    return [(e.name, e.time_range.elapsed_us()) for e in kernels
            if e.time_range.start > marks[0] and "spin_kernel" not in e.name]


def device_split(fn, stages: dict) -> dict | None:
    """Device ms and launches of each stage of one call of ``fn`` under
    ``torch.profiler``: ``stages`` maps a stage name to a test on the
    kernel's name (the first that holds takes it). None when the profiler
    recorded no device time."""
    out = {name: [0.0, 0] for name in stages}
    for kernel, us in profiled(fn) or []:
        for name, test in stages.items():
            if test(kernel):
                out[name][0] += us / 1e3
                out[name][1] += 1
                break
    return out if sum(ms for ms, _ in out.values()) > 0 else None


def device_ms(fn, calls: int = 50, warmup: int = 3, match: str = "",
              attempts: int = 6) -> float | None:
    """Device time of one call of ``fn``: the summed device time of the
    kernels that ``calls`` calls launch under ``torch.profiler`` (those
    whose name holds ``match``; ``profiled``), over ``calls``. A capture in
    which some kernel did not come back a whole number of times per call
    is taken again, up to ``attempts`` times; then None."""
    import collections

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        counts, total = collections.Counter(), 0.0
        for name, us in profiled(fn, calls) or []:
            if match in name and us > 0:
                counts[name] += 1
                total += us
        if counts and all(n % calls == 0 for n in counts.values()):
            return total / 1e3 / calls
        print(f"[profiler] capture {attempt}/{attempts}: kernel counts "
              f"{sorted(counts.values())} for {calls} calls")
    return None


def ptxas_facts(log: Path, *parts: str) -> str:
    """Registers and spills that ``-Xptxas -v`` printed for the first kernel
    whose mangled name holds every one of ``parts``."""
    lines = log.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and all(x in line for x in parts):
            facts = []
            for nxt in lines[i + 1:i + 6]:
                if "Compiling entry function" in nxt:
                    break
                if "registers" in nxt or "spill" in nxt:
                    facts.append(nxt.split("ptxas info    :")[-1].strip())
            return "; ".join(facts)
    return "not found in the build log"


def blocks_by_registers(facts: str, threads: int) -> int | None:
    """Blocks of ``threads`` threads whose registers (``ptxas_facts``) fit
    in one SM's 65,536 (allocated 8 a thread at a time)."""
    found = re.search(r"Used (\d+) registers", facts)
    return None if found is None else 65536 // (-(-int(found[1]) // 8) * 8 * threads)


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def gemm_tolerance(a, b) -> float:
    """Worst-case float32 dot-product error of either side: 2 K u max(|A||B|)."""
    import torch

    return 2 * a.shape[1] * 2.0**-24 * float(torch.matmul(a.abs(), b.abs()).max())


def matvec_row(g, x, err: float) -> dict:
    """B1's times at (nb, kb) x (kb, N): host-paced and device, its plain
    version and ``torch.matmul``; the bound."""
    import torch

    from repro_torch.kernels.coded_matvec import ops as cmv

    m, k, n = g.shape[0], g.shape[1], x.shape[1]
    return dict(
        err=err, ms=cuda_ms(lambda: cmv.blocked_matvec(g, x), 200),
        plain_ms=cuda_ms(lambda: cmv.blocked_matvec_plain(g, x), 200),
        library_ms=cuda_ms(lambda: torch.matmul(g, x), 200),
        device_ms=device_ms(lambda: cmv.blocked_matvec(g, x)),
        library_device_ms=device_ms(lambda: torch.matmul(g, x)),
        bound=bound_ms(4 * (m * k + k * n + m * n), 2 * m * n * k, "float32"),
    )


def encode_row(g, a, err: float) -> dict:
    """B3's times at (nb, kb) x (kb, R D), its plain version and
    ``torch.matmul``; the bound."""
    import torch

    from repro_torch.kernels.mds_encode import ops as mds

    m, k, n = g.shape[0], g.shape[1], a.shape[1]
    return dict(
        err=err, ms=cuda_ms(lambda: mds.mds_encode(g, a), 5),
        plain_ms=cuda_ms(lambda: mds.mds_encode_plain(g, a), 5),
        library_ms=cuda_ms(lambda: torch.matmul(g, a), 5),
        bound=bound_ms(4 * (m * k + k * n + m * n), 2 * m * n * k, "float32"),
    )


#: B2's table width: the serve loop's pool for the serve trace (72 blocks)
PAGED_TABLE = 72


def paged_inputs(gen, kv: int, grp: int, hd: int):
    """B2's bf16 (q, k_pool, v_pool) at one shape: S slots, a pool of
    PAGED_TABLE + 1 blocks of BLOCK_LEN with NaN in the sink block (a kernel
    that reads it poisons every slot)."""
    import torch

    shape = (PAGED_TABLE + 1, BLOCK_LEN, kv, hd)
    k_pool = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v_pool = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    k_pool[PAGED_TABLE] = float("nan")
    v_pool[PAGED_TABLE] = float("nan")
    q = torch.randn((SLOTS, kv, grp, hd), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k_pool, v_pool


def paged_table(gen):
    """Scattered block tables with a hole, and one slot with no valid entry."""
    import torch

    pos = torch.tensor([255, 100, 16, 40], dtype=torch.int32, device="cuda")
    table = torch.full((SLOTS, PAGED_TABLE), -1, dtype=torch.int32, device="cuda")
    perm = torch.randperm(PAGED_TABLE, generator=gen, device="cuda").to(torch.int32)
    table[0, :16], table[1, :7], table[2, :2] = perm[:16], perm[16:23], perm[23:25]
    table[0, 5] = -1  # an unallocated hole inside slot 0's history
    return table, pos


def paged_hold(tag: str, q, k_pool, v_pool, table, pos):
    """B2 against its plain version: finite, zeros for the empty slot, and
    per element at most one bf16 rounding step apart. Returns (the
    kernel's output, max_abs_err)."""
    import torch

    from repro_torch.kernels.paged_attention import ops as pa

    got = pa.paged_decode_attend(q, k_pool, v_pool, table, pos)
    want = pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    # per element: at most one bf16 rounding step apart, |d| <= 2^-7 |want| + 1e-6
    worst = float((diff / (2.0**-7 * want.float().abs() + 1e-6)).max())
    _, kv, grp, hd = q.shape
    print(f"[{tag}] paged_decode S={SLOTS} KV={kv} G={grp} hd={hd} MB={table.shape[1]}: "
          f"max_abs_err {err:.3e}; max |d| / (2^-7 |want| + 1e-6) {worst:.3e} <= 1 (one "
          f"bf16 rounding step per element); finite {bool(torch.isfinite(got).all())}, "
          f"empty slot zeros {bool((got[3] == 0).all())}")
    check(bool(torch.isfinite(got).all()), f"paged_decode KV={kv} G={grp} hd={hd}: not finite")
    check(bool((got[3] == 0).all()), "paged_decode: empty slot must return zeros")
    check(worst <= 1.0, f"paged_decode KV={kv} G={grp} hd={hd} disagrees with its plain "
                        f"version")
    return got, err


def paged_row(q, k_pool, v_pool, table, pos, err: float) -> dict:
    """B2's times at one shape (host-paced and device), its plain version and
    SDPA over the gathered KV of the valid positions; the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops as pa

    _, kv, grp, hd = q.shape
    valid = pa.valid_mask(table, BLOCK_LEN, pos)  # (S, L)
    n_tok = int(valid.sum())
    kg = pa.gather_kv(k_pool, table).permute(0, 2, 1, 3).repeat_interleave(grp, 1)
    vg = pa.gather_kv(v_pool, table).permute(0, 2, 1, 3).repeat_interleave(grp, 1)
    qs = q.reshape(SLOTS, kv * grp, 1, hd)
    mask = valid[:, None, None, :]
    nbytes = 2 * (q.numel() * 2 + 2 * n_tok * kv * hd) + 4 * (table.numel() + SLOTS)

    def sdpa():
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)

    return dict(
        err=err,
        ms=cuda_ms(lambda: pa.paged_decode_attend(q, k_pool, v_pool, table, pos), 200),
        plain_ms=cuda_ms(
            lambda: pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos), 50),
        library_ms=cuda_ms(sdpa, 200),
        device_ms=device_ms(lambda: pa.paged_decode_attend(q, k_pool, v_pool, table, pos)),
        library_device_ms=device_ms(sdpa),
        bound=bound_ms(nbytes, 4 * n_tok * kv * grp * hd, "bfloat16"),
    )


def kernel_phase(nb: int, kb: int) -> dict:
    """Each kernel vs its plain version at the serving shapes; times."""
    import torch

    from repro_torch.core.coding import make_generator
    from repro_torch.kernels.coded_matvec import ops as cmv
    from repro_torch.kernels.mds_encode import ops as mds
    from repro_torch.kernels.paged_attention import ops as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    g = make_generator(nb, kb, device=dev)
    rows = {}

    # B1: the per-step block mix, (nb, kb) x (kb, S*R)
    x = torch.randn((kb, SLOTS * 256), generator=gen, device=dev)
    got, want = cmv.blocked_matvec(g, x), cmv.blocked_matvec_plain(g, x)
    err, tol = float((got - want).abs().max()), gemm_tolerance(g, x)
    print(f"[kernels] coded_matvec ({nb},{kb})x({kb},{SLOTS * 256}): "
          f"max_abs_err {err:.3e} <= tol {tol:.3e} (2 K u max|G||X|)")
    check(err <= tol, "coded_matvec disagrees with its plain version")
    same = torch.equal(cmv.blocked_matvec(g, x), got)
    m, k, n = nb, kb, x.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cmv.gemm_plan(m, n, k, sms)
    bm, bn = cmv.TILE
    facts = ptxas_facts(cmv.KERNEL.log, 'pipe_sgemm_kernel', f'Li{bm}ELi{bn}E', 'Lb1E')
    per_sm = blocks_by_registers(facts, 256)
    in_flight = "not known" if per_sm is None else min(plan.blocks, per_sm * sms)
    print(f"[kernels] coded_matvec plan: {bm} x {bn} tiles, {plan.splits} splits of "
          f"{plan.per_split} K slices, {plan.blocks} GEMM blocks; {per_sm} blocks an SM "
          f"by registers x {sms} SMs: {in_flight} in flight; ptxas: {facts}; "
          f"a second launch bit-identical: {same}")
    check(same, "coded_matvec is not deterministic")
    rows["coded_matvec"] = r = matvec_row(g, x, err)
    ratio = (None if r["device_ms"] is None or r["library_device_ms"] is None
             else r["device_ms"] / r["library_device_ms"])
    print(f"[kernels] coded_matvec device time {fmt_ms(r['device_ms'])} per call (2 launches "
          f"when split), cuBLAS SGEMM device time {fmt_ms(r['library_device_ms'])}"
          + ("" if ratio is None else f": {ratio:.2f}x cuBLAS, "
             f"{2 * m * n * k / r['device_ms'] / 1e9:.1f} TFLOP/s, "
             f"{r['device_ms'] / r['bound'][0]:.2f}x bound")
          + f"; host-paced means: kernel {r['ms']:.4f} ms, cuBLAS {r['library_ms']:.4f} ms")

    # B3: the once-per-plan encode, (nb, kb) x (kb, R*D)
    a = torch.randn((kb, 256 * 1024), generator=gen, device=dev) * 0.02
    got, want = mds.mds_encode(g, a), mds.mds_encode_plain(g, a)
    err, tol = float((got - want).abs().max()), gemm_tolerance(g, a)
    del got, want
    print(f"[kernels] mds_encode ({nb},{kb})x({kb},{a.shape[1]}): "
          f"max_abs_err {err:.3e} <= tol {tol:.3e} (2 K u max|G||A|)")
    check(err <= tol, "mds_encode disagrees with its plain version")
    m, k, n = nb, kb, a.shape[1]
    rows["mds_encode"] = r = encode_row(g, a, err)
    print(f"[kernels] mds_encode: {r['ms']:.3f} ms ({2 * m * n * k / r['ms'] / 1e9:.1f} "
          f"TFLOP/s, {r['ms'] / r['bound'][0]:.2f}x bound, {r['ms'] / r['library_ms']:.2f}x "
          f"cuBLAS), plain {r['plain_ms']:.3f} ms, cuBLAS SGEMM {r['library_ms']:.3f} ms "
          f"({2 * m * n * k / r['library_ms'] / 1e9:.1f} TFLOP/s)")
    del a
    torch.cuda.empty_cache()

    # B2: decode attend, S=4 slots over a pool as wide as the serve loop's;
    # scattered tables with a hole, one slot with no valid entry, and NaN
    # in the sink block (a kernel that reads it poisons every slot)
    kv, grp, hd, nblk = 8, 2, 128, PAGED_TABLE
    q, k_pool, v_pool = paged_inputs(gen, kv, grp, hd)
    table, pos = paged_table(gen)
    got, err = paged_hold("kernels", q, k_pool, v_pool, table, pos)
    same = torch.equal(pa.paged_decode_attend(q, k_pool, v_pool, table, pos), got)
    nsplit = pa.decode_splits(nblk)
    active = kv * sum(max(0, min(int(p) // BLOCK_LEN + 1, nsplit)) for p in pos.tolist())
    facts = ptxas_facts(pa.KERNEL.log, 'paged_decode_split_kernel', '13__nv_bfloat16',
                        'Li128E')
    per_sm = blocks_by_registers(facts, 128)
    blocks = SLOTS * kv * nsplit
    in_flight = "not known" if per_sm is None else min(blocks, per_sm * sms)
    print(f"[kernels] paged_decode: {nsplit} splits of one table block, grid "
          f"{SLOTS * kv} x {nsplit} = {blocks} blocks, {active} below pos (run), {per_sm} "
          f"blocks an SM by registers x {sms} SMs: {in_flight} in flight; ptxas: {facts}; "
          f"a second launch bit-identical: {same}")
    check(same, "paged_decode is not deterministic")
    rows["paged_decode"] = r = paged_row(q, k_pool, v_pool, table, pos, err)
    print(f"[kernels] paged_decode device time {fmt_ms(r['device_ms'])} per call (split and "
          f"combine launches), SDPA device time {fmt_ms(r['library_device_ms'])}; host-paced "
          f"means: kernel {r['ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms; bound "
          f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")

    # B2 at h2o-danube-3-4b's head_dim: 120 (15 vectors of 16 bytes in bf16,
    # a team of 16 lanes with one idle), KV 8, G 4, the same table and pos
    dq, dk, dv = paged_inputs(gen, 8, 4, 120)
    paged_hold("kernels", dq, dk, dv, table, pos)
    del dk, dv, dq

    # as the serve path sees it: one pool per layer, taken in turn, and
    # the L2 flushed before each call (between two calls on one layer the
    # serve path streams the other 27 layers' weights and pools through it)
    layers = 28
    pools = [torch.randn((layers, nblk + 1, BLOCK_LEN, kv, hd), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2)]
    for pool in pools:
        pool[:, nblk] = float("nan")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # 5x the 50 MB L2
    turn = iter(range(1 << 30))

    def cold():
        i = next(turn) % layers
        flush.zero_()
        return pa.paged_decode_attend(q, pools[0][i], pools[1][i], table, pos)

    cold_dev = device_ms(cold, calls=2 * layers, match="paged_decode")
    print(f"[kernels] paged_decode over {layers} pools in turn "
          f"({2 * pools[0].numel() * 2 / 1e6:.1f} MB), a {flush.numel() >> 20} MiB write "
          f"between calls to evict the L2: device time {fmt_ms(cold_dev)} per call (cold "
          f"L2; the decode's kernels only) against {fmt_ms(r['device_ms'])} on one pool "
          f"(warm)")
    del pools, flush
    return rows


def fused_ce_phase(t: int = TRAIN_BATCH * TRAIN_SEQ, v: int = 151_936,
                   d: int = 1024, tag: str = "kernels", stages: bool = True) -> dict:
    """B4 forward and both backward kernels vs ``fused_ce_plain`` at a
    training path's full-width shapes (bf16 operands, some labels masked),
    timed beside the plain version and the library call; ``stages``: each
    launch also split by the profiler into its stages. Returns the rows,
    each with its shape."""
    import torch

    from repro_torch.kernels.fused_ce import ops as ce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    h = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
    e = (torch.randn((v, d), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, v, (t,), generator=gen, device=dev)
    labels[::7] = -1
    labels32 = labels.to(torch.int32)
    mask = (labels >= 0).float()

    # a logit is an f32 dot product of length d: within 2 d u max|h||e|
    # (Cauchy-Schwarz on the rows); lse adds the online sum over v/64 tiles
    mag = float(h.float().norm(dim=1).max() * e.float().norm(dim=1).max())
    tol_logit = 2 * d * U32 * mag
    hk, ek = h.clone().requires_grad_(), e.clone().requires_grad_()
    lse, ll, am = ce.fused_ce(hk, ek, labels)
    hp, ep = h.clone().requires_grad_(), e.clone().requires_grad_()
    lse_p, ll_p, am_p = ce.fused_ce_plain(hp, ep, labels)
    tol_lse = tol_logit + (v / 64 + 64) * U32 + 2 * U32 * float(lse_p.detach().abs().max())
    err_lse = float((lse - lse_p).detach().abs().max())
    err_ll = float((ll - ll_p).detach().abs().max())
    print(f"[{tag}] fused_ce_fwd T={t} V={v} D={d} bf16: lse max_abs_err "
          f"{err_lse:.3e} <= tol {tol_lse:.3e}; ll {err_ll:.3e} <= tol "
          f"{tol_logit:.3e} (2 D u max|h| max|e| + (V/64 + 64) u + 2 u max|lse|)")
    check(err_lse <= tol_lse and err_ll <= tol_logit, "fused_ce_fwd disagrees")
    check(bool((ll[labels < 0] == 0).all()), "fused_ce_fwd: masked ll must be 0")
    with torch.no_grad():
        logits = h.float() @ e.float().T  # (T, V): the check's own oracle
        top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol_logit
    n_bad = int(((am != am_p) & clear).sum())
    print(f"[{tag}] fused_ce_fwd argmax: {int(clear.sum())}/{t} tokens with a "
          f"top-two gap > 2 tol, {n_bad} disagree")
    check(n_bad == 0, "fused_ce_fwd argmax disagrees")
    again = ce.fused_ce_forward(h, e, labels32)
    same = all(torch.equal(x, y.detach()) for x, y in zip(again, (lse, ll, am)))
    print(f"[{tag}] fused_ce_fwd: {-(-v // ce.TILE_V)} vocab tiles, partial scratch "
          f"{ce.scratch_bytes(ce.FWD, t, v, d)} bytes; a second launch bit-identical: {same}")
    check(same, "fused_ce_fwd is not deterministic")
    del again

    # the training loss's upstream gradients (mean over masked tokens, z-loss)
    g_lse = mask * (1 + 2e-4 * lse_p.detach()) / mask.sum()
    g_ll = -mask / mask.sum()
    dh, de = torch.autograd.grad((lse, ll), (hk, ek), (g_lse, g_ll))
    dh_p, de_p = torch.autograd.grad((lse_p, ll_p), (hp, ep), (g_lse, g_ll),
                                     retain_graph=True)
    with torch.no_grad():
        dl = torch.softmax(logits, dim=1).mul_(g_lse[:, None])
        hit = torch.nonzero(labels >= 0)[:, 0]
        dl[hit, labels[hit]] += g_ll[hit]
        dl.abs_()
        bound_h = dl @ e.float().abs()
        bound_e = dl.T @ h.float().abs()
    del logits, dl
    # dlogits relative error 2 tol_lse (exp of the logit and lse errors),
    # the f32 sum over V or T, the rounding of the dlogits to bf16 before
    # the product (2^-8), then one bf16 rounding step of the output
    errs = {}
    for name, got, want, bound, n in (("dh", dh, dh_p, bound_h, v),
                                      ("de", de, de_p, bound_e, t)):
        diff = (got.float() - want.float()).abs()
        lim = (2 * tol_lse + n * U32) * bound + 2.0**-8 * bound + 2.0**-7 * want.float().abs()
        worst = float((diff / lim.clamp_min(1e-30)).max())
        errs[name] = float(diff.max())
        print(f"[{tag}] fused_ce_bwd_{name}: max_abs_err {errs[name]:.3e}; max "
              f"|d| / ((2 tol_lse + {n} u) (|dl||X|) + 2^-8 (|dl||X|) + 2^-7 |want|) "
              f"{worst:.3e} <= 1")
        check(worst <= 1.0, f"fused_ce_bwd_{name} disagrees with its plain version")
    del bound_h, bound_e
    torch.cuda.empty_cache()

    lse_d = lse.detach()
    lab0 = labels.clamp_min(0)[:, None]
    vc = ce.vocab_chunk(t, v)
    for name, kern, got in (("dh", ce.BWD_DH, dh), ("de", ce.BWD_DE, de)):
        again = ce.fused_ce_backward(kern, h, e, labels32, lse_d, g_lse, g_ll)
        same = torch.equal(again, got)
        print(f"[{tag}] fused_ce_bwd_{name}: {-(-v // vc)} vocab chunks of {vc} rows, "
              f"scratch {ce.scratch_bytes(kern, t, v, d)} bytes; a second launch "
              f"bit-identical: {same}")
        check(same, f"fused_ce_bwd_{name} is not deterministic")
    del again, dh, de, dh_p, de_p

    # yardstick: cuBLAS bf16 GEMM with f32 output, logsumexp and a gather;
    # its backward composed the same way (mm's out_dtype form has no autograd)
    def library():
        lg = torch.mm(h, e.T, out_dtype=torch.float32)
        return torch.logsumexp(lg, dim=1), lg.gather(1, lab0)[:, 0]

    # the backward's yardstick recomputes the logits, as the kernels do
    def library_bwd(wrt):
        def run():
            lg = torch.mm(h, e.T, out_dtype=torch.float32)
            dlog = torch.softmax(lg, dim=1).mul_(g_lse[:, None])
            del lg
            dlog.scatter_add_(1, lab0, (g_ll * mask)[:, None])
            dlog = dlog.to(torch.bfloat16)
            if wrt == "dh":
                return torch.mm(dlog, e, out_dtype=torch.float32).to(torch.bfloat16)
            return torch.mm(dlog.T, h, out_dtype=torch.float32).to(torch.bfloat16)
        return run

    def plain_bwd(wrt):
        return lambda: torch.autograd.grad((lse_p, ll_p), (wrt,), (g_lse, g_ll),
                                           retain_graph=True)

    io_bytes = 2 * (t * d + v * d) + 4 * t  # h, e, labels
    fwd_bytes = io_bytes + t * (4 + 4 + 8)
    bwd_bytes = io_bytes + 12 * t
    flops = 2.0 * t * v * d
    rows = {
        "fused_ce_fwd": dict(
            err=max(err_lse, err_ll),
            ms=cuda_ms(lambda: ce.fused_ce_forward(h, e, labels32), 20),
            plain_ms=cuda_ms(lambda: ce.fused_ce_plain(h, e, labels), 3, 1),
            library_ms=cuda_ms(library, 3, 1),
            bound=bound_ms(fwd_bytes, flops, "bfloat16"),
            flops=flops,
        ),
    }
    for name, kern, wrt_p, out_rows in (("dh", ce.BWD_DH, hp, t), ("de", ce.BWD_DE, ep, v)):
        rows[f"fused_ce_bwd_{name}"] = dict(
            err=errs[name],
            ms=cuda_ms(lambda k=kern: ce.fused_ce_backward(k, h, e, labels32, lse_d,
                                                           g_lse, g_ll), 10),
            plain_ms=cuda_ms(plain_bwd(wrt_p), 5),
            library_ms=cuda_ms(library_bwd(name), 5),
            bound=bound_ms(bwd_bytes + 2 * out_rows * d, 2 * flops, "bfloat16"),
            flops=2 * flops,
        )
    for name, r in rows.items():
        print(f"[{tag}] {name}: {r['ms']:.3f} ms ({r['flops'] / r['ms'] / 1e9:.1f} "
              f"TFLOP/s, {r['ms'] / r['bound'][0]:.2f}x bound, "
              f"{r['ms'] / r['library_ms']:.2f}x library), plain {r['plain_ms']:.3f} ms, "
              f"library {r['library_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
              f"({r['bound'][1]})")

    for r in rows.values():
        r["shape"] = [[t, d], [v, d]]
    if not stages:
        return rows
    # each launch's stages by the profiler: the forward's GEMM and combine,
    # a backward's dlogits and product GEMMs
    calls = {
        "fwd": (lambda: ce.fused_ce_forward(h, e, labels32),
                {"gemm": lambda k: "FwdEpi" in k, "combine": lambda k: "combine" in k}),
        **{f"bwd_{name}": (
            lambda k=kern: ce.fused_ce_backward(k, h, e, labels32, lse_d, g_lse, g_ll),
            {"dlogits": lambda k: "DlogitsEpi" in k, "product": lambda k: "gemm_kernel" in k})
           for name, kern in (("dh", ce.BWD_DH), ("de", ce.BWD_DE))},
    }
    for name, (fn, tests) in calls.items():
        split = device_split(fn, tests)
        if split is None:
            print(f"[{tag}] fused_ce_{name} stages: not measured (no device time)")
            continue
        print(f"[{tag}] fused_ce_{name} stages: " + ", ".join(
            f"{st} {ms:.3f} ms in {n} launches"
            + (f" ({flops / ms / 1e9:.1f} TFLOP/s)" if st != "combine" and ms > 0 else "")
            for st, (ms, n) in split.items()))
    return rows


#: Path M: the quickstart's fleet and k (examples/quickstart.py:26-29), at
#: the widest dense config's width (yi-9b, d 4096)
MATVEC_FLEET, MATVEC_K, MATVEC_D = ([40, 60, 100], [8.0, 2.0, 0.5]), 20_000, 4_096


def power_norm2(m, iters: int = 30) -> float:
    """||M||_2 of a float64 matrix by power iteration on M^T M."""
    import torch

    v = torch.ones(m.shape[1], dtype=m.dtype, device=m.device)
    v /= v.norm()
    for _ in range(iters):
        w = m.T @ (m @ v)
        v = w / w.norm()
    return float((m @ v).norm())


def matvec_inputs(dev):
    """Path M's executor, seeded A (k, d) and x (d,) on ``dev``, and the
    finish mask at the plan's deadline with the two slowest-group workers
    forced out: the same in every process."""
    import torch

    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.runtime.executor import CodedRoundExecutor

    exe = CodedRoundExecutor(ClusterSpec.make(*MATVEC_FLEET, 1.0), MATVEC_K, "optimal",
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    a = torch.randn((MATVEC_K, MATVEC_D), generator=gen, device=dev)
    x = torch.randn(MATVEC_D, generator=gen, device=dev)
    mask = exe.finish_mask(torch.Generator(device=dev).manual_seed(5))
    mask[-2:] = False  # two slowest-group workers miss the deadline
    return exe, a, x, mask


def matvec_phase(device: str = "cuda") -> dict:
    """The paper's coded matvec at full width: ``end_to_end_coded_matvec``
    of A (20,000 x 4,096) and x on the quickstart's 200-worker fleet, the
    finish mask drawn at the plan's deadline with two slowest-group workers
    forced out; counters reset before and read after. The decode is held
    against A x in float64 within the error model, an insufficient mask
    must flag; then B1's narrow branch and B3 at this path's shapes are
    checked against their plain versions and timed. Returns the path's
    launch counts, the two kernels' rows, and z and the products on the
    host (for [matvec-mesh])."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.coded_matvec import (
        DecodePipeline,
        coded_matvec,
        end_to_end_coded_matvec,
        pack_coded_matrix,
    )
    from repro_torch.core.coding import make_generator
    from repro_torch.kernels.coded_matvec import ops as cmv
    from repro_torch.kernels.mds_encode import ops as mds

    dev, k, d = torch.device(device), MATVEC_K, MATVEC_D
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    exe, a, x, mask = matvec_inputs(dev)
    plan = exe.plan
    w, ml = plan.num_workers, plan.max_load
    print(f"[matvec] plan: k {k}, n {plan.n}, {w} workers, loads "
          f"{sorted(set(plan.loads_per_worker.tolist()), reverse=True)}, max_load {ml}, "
          f"deadline {exe.deadline:.6f} (3 T*); A {k} x {d} f32")
    check((plan.n, w, ml) == (26_980, 200, 203), "the quickstart plan: n 26,980, 200 workers")

    kernels.reset_launch_counts()
    sync()
    t = time.perf_counter()
    z, ok = end_to_end_coded_matvec(a, x, plan, mask, seed=0, device=dev)
    sync()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    alive = exe.slot_mask(mask)
    print(f"[matvec] end_to_end_coded_matvec: wall {wall:.3f} s (generator, B3 encode, "
          f"pack, B1 products, decode); {int((~mask).sum())} workers erased, "
          f"{int((~alive).sum())} coded rows, {int((~alive[:k]).sum())} systematic; "
          f"ok {bool(ok)}; launches {counts}")
    check(bool(ok) and tuple(z.shape) == (k,) and bool(torch.isfinite(z).all()),
          "the coded matvec decodes a finite (k,) result")
    check(counts["mds_encode"] == 1 and counts["coded_matvec"] == 1
          and counts["paged_decode"] == 0, "Path M: one B3 and one B1 launch")

    # error model (written down before the first run): the float32 products
    # and LU solve, against A x in float64, in the 2-norm:
    #   ||z - A x||_2 <= cond_2(G_S) u sqrt(k) ||A x||_2
    # cond_2 from the float64 G_S and its float64 inverse (power iteration),
    # u = 2^-24, sqrt(k) the random-walk growth of a k-term float32 sum
    g = make_generator(plan.n, k, seed=0, device=dev)
    order = torch.argsort((~alive).to(torch.int8), stable=True)[:k]
    g_s = g[order].double()
    inv = torch.linalg.inv(g_s)
    cond2 = power_norm2(g_s) * power_norm2(inv)
    cond_inf = float(g_s.abs().sum(1).max() * inv.abs().sum(1).max())
    del g_s, inv
    want = a.double() @ x.double()
    err2, err_inf = float((z.double() - want).norm()), float((z.double() - want).abs().max())
    tol = cond2 * U32 * math.sqrt(k) * float(want.norm())
    print(f"[matvec] ||z - A x||_2 {err2:.3e} <= tol {tol:.3e} (cond_2(G_S) u sqrt(k) "
          f"||A x||_2; cond_2 {cond2:.3e}, tol / ||A x||_2 {tol / float(want.norm()):.2e}); "
          f"max|z - A x| {err_inf:.3e} of max|A x| {float(want.abs().max()):.3e}; "
          f"cond_inf(G_S) {cond_inf:.3e}")
    check(err2 <= tol, "the decoded A x within its error model")

    # the pieces: pack once more (B3), the insufficient case, and the kernels' times
    packed, row_of = pack_coded_matrix(g, a, plan)
    # only the slow group finishes: 9,800 rows < k
    bad = torch.from_numpy(plan.group_of_worker == 2).to(dev)
    zb, okb = DecodePipeline(g, row_of)(packed, x, bad)
    print(f"[matvec] insufficient mask ({int(bad.sum())} workers, "
          f"{int(exe.slot_mask(bad).sum())} rows < k): ok {bool(okb)}, "
          f"all zeros {bool((zb == 0).all())}")
    check(not bool(okb) and bool((zb == 0).all()), "fewer than k rows must flag and zero")
    partials = coded_matvec(packed, x)
    out = {"z": z.cpu(), "partials": partials.cpu()}

    flat = packed.reshape(w * ml, d)
    got, plain = cmv.blocked_matvec_batch(packed, x), cmv.blocked_matvec_plain(flat, x)
    err, btol = float((got.reshape(-1) - plain).abs().max()), gemm_tolerance(flat, x[:, None])
    same = torch.equal(cmv.blocked_matvec_batch(packed, x), got)
    print(f"[matvec] coded_matvec narrow ({w * ml},{d})x({d},): max_abs_err {err:.3e} <= tol "
          f"{btol:.3e} (2 K u max|A||x|); a second launch bit-identical: {same}; ptxas: "
          f"{ptxas_facts(cmv.KERNEL.log, 'narrow_matvec_kernel', 'ILi1ELb1E')}")
    check(err <= btol and same, "coded_matvec's narrow branch disagrees or is not deterministic")
    narrow = dict(
        shape=[w * ml, d, 1], err=err,
        ms=cuda_ms(lambda: cmv.blocked_matvec_batch(packed, x), 50),
        plain_ms=cuda_ms(lambda: cmv.blocked_matvec_plain(flat, x), 50),
        library_ms=cuda_ms(lambda: torch.mv(flat, x), 50),
        device_ms=device_ms(lambda: cmv.blocked_matvec_batch(packed, x), calls=20,
                            match="narrow"),
        library_device_ms=device_ms(lambda: torch.mv(flat, x), calls=20),
        bound=bound_ms(4 * (w * ml * d + d + w * ml), 2 * w * ml * d, "float32"),
    )
    r = narrow
    dm = r["device_ms"]
    print(f"[matvec] coded_matvec narrow device time {fmt_ms(dm)}, torch.mv (cuBLAS GEMV) "
          f"{fmt_ms(r['library_device_ms'])}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})"
          + ("" if dm is None else f": {r['bound'][0] / dm:.2f} of the bound, "
             f"{4 * w * ml * d / dm / 1e6:.0f} GB/s")
          + f"; host-paced means: kernel {r['ms']:.4f} ms, torch.mv {r['library_ms']:.4f} "
          f"ms, plain {r['plain_ms']:.4f} ms")
    del flat, got, plain, packed, partials

    got, plain = mds.mds_encode(g, a), mds.mds_encode_plain(g, a)
    err, etol = float((got - plain).abs().max()), gemm_tolerance(g, a)
    del got, plain
    print(f"[matvec] mds_encode ({plan.n},{k})x({k},{d}): max_abs_err {err:.3e} <= tol "
          f"{etol:.3e} (2 K u max|G||A|)")
    check(err <= etol, "mds_encode disagrees with its plain version at Path M's shape")
    m, kk, n = plan.n, k, d
    encode = dict(
        shape=[m, kk, n], err=err, ms=cuda_ms(lambda: mds.mds_encode(g, a), 3, 1),
        plain_ms=cuda_ms(lambda: mds.mds_encode_plain(g, a), 3, 1),
        library_ms=cuda_ms(lambda: torch.matmul(g, a), 3, 1),
        bound=bound_ms(4 * (m * kk + kk * n + m * n), 2 * m * n * kk, "float32"),
    )
    r = encode
    print(f"[matvec] mds_encode: {r['ms']:.3f} ms ({2 * m * n * kk / r['ms'] / 1e9:.1f} "
          f"TFLOP/s, {r['ms'] / r['bound'][0]:.2f}x bound, {r['ms'] / r['library_ms']:.2f}x "
          f"cuBLAS), plain {r['plain_ms']:.3f} ms, cuBLAS SGEMM {r['library_ms']:.3f} ms, "
          f"bound {r['bound'][0]:.3f} ms ({r['bound'][1]})")
    del g, a
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return counts, {"narrow": narrow, "encode": encode}, out


#: [matvec-mesh]'s worlds: R = 1 on NCCL (``make_workers_mesh()``'s own
#: group), then R gloo ranks sharing the one card (NCCL takes one card a rank)
MESH_WORLDS = (1, 2, 4)
MESH_RANK_CMD = "import chip_smoke; chip_smoke.matvec_mesh_rank()"


def matvec_mesh_rank() -> None:
    """One rank of [matvec-mesh], started by ``matvec_mesh_phase`` as
    ``python -c MESH_RANK_CMD world rank store go out device``: waits for
    the file ``go``, joins its world (R = 1: ``make_workers_mesh``'s own
    group; else gloo over the ``FileStore`` ``store``), runs Path M's
    ``end_to_end_coded_matvec`` on the workers mesh with A on the master
    only (counters reset and the peak allocated reset just before, read
    just after), then its pieces timed from a barrier each (the master's
    encode: generator, B3 and pack; the scatter of the blocks; products
    and gather; the master's decode and broadcast) and the insufficient
    mask. Saves z and the products to ``out`` and prints one JSON line."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    import repro_torch.kernels as kernels
    from repro_torch.core.coded_matvec import (
        DecodePipeline,
        coded_matvec_block,
        end_to_end_coded_matvec,
        pack_coded_matrix,
        shard_packed,
    )
    from repro_torch.core.coding import make_generator
    from repro_torch.launch.mesh import destroy_local_mesh, make_workers_mesh
    from repro_torch.runtime.serve_loop import set_full_fp32

    world, rank = int(sys.argv[1]), int(sys.argv[2])
    store, go, out, device = sys.argv[3:7]
    give_up = time.monotonic() + 600
    while not os.path.exists(go):
        check(time.monotonic() < give_up, f"rank {rank} of {world}: no go file")
        time.sleep(0.05)
    t_go = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    set_full_fp32()
    if cuda:
        torch.cuda.set_device(0)
    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = make_workers_mesh(device=dev.type)

    def together() -> float:
        if cuda:
            torch.cuda.synchronize()
        if world > 1:
            dist.barrier()
        return time.perf_counter()

    t_mesh = together()
    exe, a, x, mask = matvec_inputs(dev)
    plan = exe.plan
    master = rank == 0
    if not master:  # only the master reads A
        del a
        a = None
    kernels.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    t = together()
    z, ok = end_to_end_coded_matvec(a, x, plan, mask, seed=0, device=dev, mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    counts = kernels.launch_counts()

    t0 = together()
    g = packed = row_of = None
    if master:
        g = make_generator(plan.n, MATVEC_K, seed=0, device=dev)
        packed, row_of = pack_coded_matrix(g, a, plan)
    t1 = together()
    block = shard_packed(packed, plan, mesh)
    t2 = together()
    partials = coded_matvec_block(block, x, mesh)
    t3 = together()
    pipe = DecodePipeline(g, row_of, mesh=mesh, k=plan.k)
    z2, ok2 = pipe.decode(partials, mask)
    t4 = together()
    bad = torch.from_numpy(plan.group_of_worker == 2).to(dev)  # fewer than k rows
    zb, okb = pipe.on_block(block, x, bad)
    t_end = together()
    torch.save({"z": z.cpu(), "partials": partials.cpu()}, out)
    rec = dict(world=world, rank=rank, backend=dist.get_backend(),
               mesh=[list(mesh.mesh_dim_names), mesh.size()], ok=bool(ok),
               ok_type=[str(ok.dtype), list(ok.shape)], counts=counts, wall=wall,
               peak=peak, block_bytes=block.numel() * block.element_size(),
               block_shape=list(block.shape), encode=t1 - t0, scatter=t2 - t1,
               products=t3 - t2, decode=t4 - t3,
               pieces_equal=torch.equal(z2, z) and bool(ok2) == bool(ok),
               insufficient=[bool(okb), bool((zb == 0).all())],
               stages=dict(mesh=t_mesh - t_go, inputs=t - t_mesh, runs=t_end - t))
    del g, packed, a, block
    if world > 1:
        dist.destroy_process_group()
    else:
        destroy_local_mesh()
    rec["jax"] = any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
    print(json.dumps(rec))


#: a non-master rank's peak allocated during ``end_to_end_coded_matvec``
#: may exceed its block by this much (x, the products, z, the mask)
MESH_PEAK_SLACK = 64 * 2**20


def matvec_mesh_phase(card: str, want: dict, device: str = "cuda") -> dict:
    """[matvec-mesh]: Path M on the paper's workers mesh, R ranks of
    ``MESH_WORLDS`` in turn, each rank a process of its own
    (``matvec_mesh_rank``; all started at once, each world let go when the
    one before it has exited). Every rank: ok, one B1 launch on its block;
    B3 once on the master and never elsewhere (the master draws G, encodes
    and packs, then scatters the blocks); a non-master's peak allocated
    during the call at most its block + ``MESH_PEAK_SLACK``; z and the
    gathered products bit-identical to [matvec]'s one-process run
    (``want``: the narrow branch sums each row in the same order whatever
    the block, and the master's decode sees the same products), the
    insufficient mask False and zeros, no JAX. Prints each world's wall
    split into the master's encode, the scatter, products and gather, and
    decode, each rank's peak against its block, and B1's device time on a
    block of each world's shape (in this process, after the worlds: each
    rank's first profiler session would start CUPTI anew, seconds a
    world). Returns each world's launches summed over its ranks."""
    import torch

    from repro_torch.kernels.coded_matvec.ops import blocked_matvec_batch

    t0 = time.perf_counter()
    paths, blocks = {}, {}
    with tempfile.TemporaryDirectory(prefix="matvec-mesh-") as tmp:
        tmp = Path(tmp)
        procs = {R: start_procs([["-c", MESH_RANK_CMD, str(R), str(r), str(tmp / f"store{R}"),
                                  str(tmp / f"go{R}"), str(tmp / f"r{R}-{r}.pt"), device]
                                 for r in range(R)]) for R in MESH_WORLDS}
        try:
            for R in MESH_WORLDS:
                (tmp / f"go{R}").touch()
                results = finish_procs(procs[R], "matvec-mesh", timeout=300)
                check(all(code == 0 for code, _ in results), f"every rank of world {R} exits 0")
                recs = [json.loads(stdout.strip().splitlines()[-1]) for _, stdout in results]
                outs = [torch.load(tmp / f"r{R}-{r}.pt") for r in range(R)]
                backend = "nccl" if R == 1 and device == "cuda" else "gloo"
                same_z = all(torch.equal(o["z"], want["z"]) for o in outs)
                same_p = all(torch.equal(o["partials"], want["partials"]) for o in outs)
                blocks[R] = recs[0]["block_shape"]
                print(f"[matvec-mesh] world {R} ({recs[0]['backend']}, {card}): wall "
                      f"{max(rec['wall'] for rec in recs):.3f} s (end_to_end_coded_matvec, "
                      f"slowest rank); pieces from a barrier each: the master's encode "
                      f"(generator, B3, pack) {recs[0]['encode']:.3f} s, products and gather "
                      f"{recs[0]['products'] * 1e3:.2f} ms, decode and broadcast "
                      f"{recs[0]['decode'] * 1e3:.2f} ms")
                print(f"[matvec-mesh] world {R}: scatter of the {recs[0]['block_shape']} "
                      f"blocks ({recs[0]['block_bytes'] / 1e6:.1f} MB a rank) "
                      f"{recs[0]['scatter'] * 1e3:.2f} ms")
                if device == "cuda":
                    print(f"[matvec-mesh] world {R}: peak allocated during the call over "
                          f"what was resident, by rank: " + ", ".join(
                              f"{rec['peak'] / 1e6:.1f} MB" for rec in recs)
                          + f" (a block {recs[0]['block_bytes'] / 1e6:.1f} MB)")
                print(f"[matvec-mesh] world {R}: z on every rank bit-identical to [matvec]'s: "
                      f"{same_z}; the gathered products: {same_p}; launches "
                      f"{[rec['counts'] for rec in recs]}")
                for rec in recs:
                    tag = f"world {R} rank {rec['rank']}"
                    check(rec["backend"] == backend and rec["mesh"] == [["workers"], R],
                          f"{tag}: a {backend} ('workers',) mesh of {R}")
                    check(rec["ok"] and rec["ok_type"] == ["torch.bool", []],
                          f"{tag}: ok, a 0-d bool")
                    b3 = int(rec["rank"] == 0)
                    check(rec["counts"]["coded_matvec"] == 1 and rec["counts"]["mds_encode"] == b3
                          and rec["counts"]["paged_decode"] == 0,
                          f"{tag}: one B1 launch, B3 {b3}")
                    if rec["rank"] and device == "cuda":
                        check(rec["peak"] <= rec["block_bytes"] + MESH_PEAK_SLACK,
                              f"{tag}: peak {rec['peak']} bytes over its block "
                              f"{rec['block_bytes']} + {MESH_PEAK_SLACK}")
                    check(rec["pieces_equal"], f"{tag}: the timed pieces give the same z")
                    check(rec["insufficient"] == [False, True],
                          f"{tag}: fewer than k rows must flag and zero")
                    check(not rec["jax"], f"{tag}: no jax or repro imported")
                check(same_z and same_p, f"world {R}: z and the products bit-identical to "
                                         "[matvec]'s on every rank")
                paths[f"matvec_mesh_{R}"] = {
                    k: sum(rec["counts"][k] for rec in recs) for k in recs[0]["counts"]}
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
    if device == "cuda":  # a rank's B1 launch by device time, here (CUPTI is up)
        gen = torch.Generator(device=device).manual_seed(6)
        for R, shape in blocks.items():
            block = torch.randn(shape, generator=gen, device=device)
            x = torch.randn(shape[2], generator=gen, device=device)
            ms = device_ms(lambda: blocked_matvec_batch(block, x), calls=20, match="narrow")
            print(f"[matvec-mesh] world {R}: B1 on a rank's block {shape} ({shape[0] * shape[1]} "
                  f"rows), device time {fmt_ms(ms)}")
            del block
    print(f"[matvec-mesh] {time.perf_counter() - t0:.1f} s")
    return paths


#: [paper]: the paper's Fig. 4 setting (benchmarks/fig4.py): groups (3, 4,
#: 5, 6, 7) N / 25 with mu (16, 12, 8, 4, 1), alpha 1, k 100,000, the group
#: code of [33] at r 100, 10,000 Monte-Carlo trials a point (the paper's)
PAPER_NS = (250, 500, 1_000, 2_000, 4_000, 8_000)
PAPER_MUS = (16.0, 12.0, 8.0, 4.0, 1.0)
PAPER_K, PAPER_TRIALS, PAPER_R = 100_000, 10_000, 100
#: Fig. 2's cluster (benchmarks/fig2.py) and the reference's frozen N T* at
#: q = 1 (tests/test_fig_golden.py)
FIG2_FLEET, FIG2_NT_Q1 = ([1000, 2000, 3000], [2.0, 1.0, 0.5]), 3.4968381270239273


def paper_cluster(n_total: int):
    from repro_torch.core.runtime_model import ClusterSpec

    return ClusterSpec.make([p * n_total // 25 for p in (3, 4, 5, 6, 7)], PAPER_MUS, 1.0)


def paper_point(c, device, seed: int, schemes: dict) -> dict:
    """Each scheme's Monte-Carlo mean and standard error on ``c`` through
    ``CodedComputeEngine``, every sample drawn on ``device`` from one
    generator; the mean also through ``expected_latency`` from the same
    generator state, which must give the same number."""
    import torch

    from repro_torch.core.engine import CodedComputeEngine

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, scheme in schemes.items():
        eng = CodedComputeEngine(c, PAPER_K, scheme)
        state = gen.get_state()
        samples = eng.simulate(gen, PAPER_TRIALS)
        check(samples.device.type == torch.device(device).type
              and tuple(samples.shape) == (PAPER_TRIALS,),
              f"{name}: {PAPER_TRIALS} samples on {device}")
        check(bool(torch.isfinite(samples).all()), f"{name}: finite samples")
        mean = float(samples.mean())
        gen.set_state(state)
        check(eng.expected_latency(gen, PAPER_TRIALS) == mean,
              f"{name}: expected_latency is the samples' mean")
        out[name] = (mean, float(samples.std()) / math.sqrt(PAPER_TRIALS))
    return out


def paper_phase(card: str, device: str = "cuda") -> dict:
    """[paper]: the paper's Section IV Monte Carlo on the card. Fig. 4's
    setting at every N of ``PAPER_NS`` through ``CodedComputeEngine`` with
    a ``torch.Generator`` on ``device``: the proposed scheme (``Optimal``),
    ``UniformN`` at its n* and at 2k, ``Uncoded`` and the group code
    (``UniformR`` at r 100), each the mean of ``PAPER_TRIALS`` samples
    beside T* (``lower_bound``). Held: proposed >= 0.95 T* at every N
    (the reference's golden relation), |proposed / T* - 1| <= 1e-3 at the
    largest N, uniform_n* above proposed at every N, the group code >= 10x
    proposed at the largest N; at N 1,000 the card's proposed mean within
    4 combined standard errors of the same run on the CPU. Then Fig. 2 on
    the host through ``scale_mu`` and ``lower_bound``: N T* over q
    decreasing, at q 1 the reference's frozen value to 1e-9, and equal to
    1e-9 at scales 1, 2 and 4 of the cluster. Returns the launch counts
    (the simulation launches none of the port's kernels)."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.core.schemes import Optimal, Uncoded, UniformN, UniformR

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    kernels.reset_launch_counts()
    rows = []
    for i, n_total in enumerate(PAPER_NS):
        c = paper_cluster(n_total)
        opt = Optimal()
        t_star = opt.lower_bound(c, PAPER_K)
        schemes = {"proposed": opt,
                   "uniform_n*": UniformN(n=opt.allocate(c, PAPER_K).n),
                   "uniform_2k": UniformN(n=2.0 * PAPER_K), "uncoded": Uncoded(),
                   f"group_r{PAPER_R}": UniformR(r=PAPER_R)}
        sync()
        t = time.perf_counter()
        point = paper_point(c, device, 2019 + i, schemes)
        sync()
        row = {"N": c.total_workers, "T*": t_star, "s": time.perf_counter() - t, **point}
        rows.append(row)
        print(f"[paper] N {row['N']}: T* {t_star:.6e}; " + ", ".join(
            f"{name} {m:.6e} (se {se:.1e})" for name, (m, se) in point.items())
            + f"; proposed / T* {point['proposed'][0] / t_star:.5f}; {row['s']:.3f} s")
    counts = kernels.launch_counts()
    for row in rows:
        prop = row["proposed"][0]
        check(prop >= 0.95 * row["T*"], f"N {row['N']}: proposed >= 0.95 T*")
        check(row["uniform_n*"][0] > prop, f"N {row['N']}: uniform_n* above proposed")
    last = rows[-1]
    ratio = last["proposed"][0] / last["T*"]
    gain = last[f"group_r{PAPER_R}"][0] / last["proposed"][0]
    gain_n = 1 - last["proposed"][0] / last["uniform_n*"][0]
    print(f"[paper] N {last['N']} ({card}): {PAPER_TRIALS} trials of five schemes in "
          f"{last['s']:.3f} s on {device}; proposed / T* {ratio:.6f}; the group code at r "
          f"{PAPER_R} {gain:.1f}x proposed (paper: >= 10x); proposed {100 * gain_n:.1f}% "
          f"below uniform_n* (paper: ~18%)")
    check(abs(ratio - 1) <= 1e-3, f"N {last['N']}: |proposed / T* - 1| <= 1e-3")
    check(gain >= 10, f"N {last['N']}: the group code >= 10x proposed")

    n_cpu = 1_000
    i = PAPER_NS.index(n_cpu)
    card_mean, card_se = rows[i]["proposed"]
    t = time.perf_counter()
    cpu_mean, cpu_se = paper_point(paper_cluster(n_cpu), "cpu", 2019 + i,
                                   {"proposed": Optimal()})["proposed"]
    z = abs(card_mean - cpu_mean) / math.hypot(card_se, cpu_se)
    print(f"[paper] N {n_cpu}: proposed on {device} {card_mean:.6e}, on the CPU "
          f"{cpu_mean:.6e} ({time.perf_counter() - t:.2f} s): {z:.2f} combined standard "
          f"errors apart")
    check(z <= 4, f"N {n_cpu}: the card's proposed mean within 4 standard errors of the CPU's")

    base = ClusterSpec.make(*FIG2_FLEET, 1.0)
    qs = [10 ** (e / 4) for e in range(-8, 9)]
    nt = [base.total_workers * Optimal().lower_bound(base.scale_mu(q), 10_000) for q in qs]
    q1 = qs.index(1.0)
    scales = [ClusterSpec.make([n * s for n in FIG2_FLEET[0]], FIG2_FLEET[1], 1.0)
              for s in (1, 2, 4)]
    inv = [c.total_workers * Optimal().lower_bound(c, 10_000) for c in scales]
    spread = max(abs(v / inv[0] - 1) for v in inv)
    print(f"[paper] Fig. 2 (host): N T* over q 1e-2..1e2 from {nt[0]:.4f} to {nt[-1]:.6f}, "
          f"at q 1 {nt[q1]!r}; at scales 1, 2, 4: {inv} (spread {spread:.1e})")
    check(all(a > b for a, b in zip(nt, nt[1:])), "Fig. 2: N T* decreasing in q")
    check(abs(nt[q1] / FIG2_NT_Q1 - 1) <= 1e-9, "Fig. 2: N T* at q 1 the reference's")
    check(spread <= 1e-9, "Fig. 2: N T* invariant to 1e-9 over scales 1, 2, 4")
    check(all(v == 0 for v in counts.values()), "[paper] launches none of the port's kernels")
    print(f"[paper] {time.perf_counter() - t0:.1f} s")
    return counts


def make_model(cfg, device: str = "cuda", tag: str = "serve"):
    """The seeded model every serving phase shares."""
    import torch

    from repro_torch.models.model import Model

    t = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, params "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"(init {time.perf_counter() - t:.1f} s)")
    return model


def serve_trace(cfg):
    """The serve phases' seeded 8-request trace."""
    from repro_torch.serve.workload import make_workload

    return make_workload("poisson", num_requests=8, prompt_len=(64, 256),
                         out_len=(8, 16), vocab=cfg.vocab_size).trace(seed=0)


def serve_phase(model, tag: str = "serve", keep: dict | None = None):
    """Coded paged serve on ``model``; returns the launch counts of the run
    and its report. ``tag`` heads the printed lines; ``keep`` (a dict), if
    given, keeps the server under ``tag`` for [programs]."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.runtime.serve_loop import ServeConfig, Server

    cfg, device = model.config, model.device
    trace = serve_trace(cfg)

    kernels.reset_launch_counts()
    server = Server(model, ClusterSpec.make(*CLUSTER),
                    ServeConfig(block_rows=256, deadline_safety=SAFETY,
                                scheme="optimal"))
    rep = server.serve(trace, slots=SLOTS, block_len=BLOCK_LEN,
                       prefill_chunk=CHUNK, decode_block=DECODE_BLOCK, seed=0)
    counts = kernels.launch_counts()

    head = server.coded_head
    print(f"[{tag}] coded head: kb {head.kb}, nb {head.nb}, deadline "
          f"{head.deadline:.6f}, loads {head.plan.loads_per_worker.tolist()}")
    done = [f for f in rep.finished if f.outcome == "done"]
    print(f"[{tag}] {len(done)}/{len(trace)} done, shed {rep.shed}, tokens "
          f"{rep.tokens}, decode rounds {rep.decode_rounds}, prefill rounds "
          f"{rep.prefill_rounds}")
    print(f"[{tag}] wall {rep.wall_s:.3f} s, {rep.tokens_per_s:.2f} tokens/s, "
          f"decode ok rate {rep.decode_ok}/{rep.decode_rounds}, erased rounds "
          f"{rep.erased_rounds}, KV pool bytes {rep.kv_bytes}")
    print(f"[{tag}] launches {counts}")
    check(len(done) == len(trace) and rep.shed == 0, "every request done, none shed")
    check(rep.tokens == sum(r.out_len for r in trace), "tokens == sum(out_len)")
    check(all(len(rep.streams[r.rid]) == r.out_len for r in trace),
          "every stream has out_len tokens")
    check(counts["paged_decode"] == cfg.num_layers * rep.decode_rounds,
          "paged_decode launches == layers x decode steps")
    check(counts["coded_matvec"] == rep.decode_rounds,
          "coded_matvec launches == decode steps")
    check(counts["mds_encode"] >= 1, "mds_encode launched")

    # coded rounds on real full-width logits, held against the uncoded ones
    reqs = trace[:SLOTS]
    cache = model.init_paged_cache(SLOTS * 4, BLOCK_LEN)
    table = torch.full((SLOTS, SLOTS * 4), -1, dtype=torch.int32, device=device)
    for s in range(SLOTS):
        table[s, :4] = torch.arange(4 * s, 4 * s + 4, dtype=torch.int32)
    toks = torch.tensor([r.prompt[:CHUNK] for r in reqs], dtype=torch.int32,
                        device=device)
    zeros = torch.zeros(SLOTS, dtype=torch.int32, device=device)
    logits, _ = model.prefill_paged(cache, toks, zeros, zeros + CHUNK, table)
    check(bool(torch.isfinite(logits[:, : cfg.vocab_size]).all()), "finite logits")
    gen = torch.Generator(device=device).manual_seed(1)
    want = logits[:, : cfg.vocab_size].float()
    scale = float(want.abs().max())
    checked = 0
    for _ in range(64):
        sel, ok, wmask = server.coded_select(logits, gen)
        check(bool(torch.isfinite(sel[:, : cfg.vocab_size]).all()), "finite coded logits")
        if not bool(ok) or bool(wmask.all()):
            continue
        alive = head.executor.slot_mask(wmask)
        order = torch.argsort((~alive).to(torch.int8), stable=True)[: head.kb]
        cond = float(torch.linalg.cond(head.generator[order].double()))
        err = float((sel[:, : cfg.vocab_size] - want).abs().max())
        tol = cond * 2.0**-22 * scale
        print(f"[{tag}] coded round, {int((~wmask).sum())} workers erased: "
              f"max |decoded - uncoded| {err:.3e} <= tol {tol:.3e} "
              f"(cond(G_S) 2^-22 max|logits|, cond {cond:.3e})")
        check(err <= tol, "decoded logits disagree with the uncoded logits")
        checked += 1
        if checked == 4:
            break
    check(checked >= 1, "no coded round decoded through erasures")
    if keep is not None:
        keep[tag] = server
    return counts, rep


def with_config(model, **changes):
    """``model`` under a changed config, its parameters shared (no copy):
    the float32-compute twin of a bf16 model, or its int8-KV twin."""
    import copy
    import dataclasses

    view = copy.copy(model)
    view.config = dataclasses.replace(model.config, **changes)
    return view


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def first_round_logits(model, reqs, chunk):
    """(dense, paged) logits of the requests' last prompt positions: one
    ``Model.prefill`` of the right-padded prompts, and ``prefill_paged``
    over chunks of ``chunk`` tokens (None: the whole prompt at once)."""
    import torch

    device, v = model.device, model.config.vocab_size
    n = len(reqs)
    cap = max(r.prompt_len for r in reqs)
    chunk = chunk or cap
    prompts = torch.zeros((n, cap), dtype=torch.int32, device=device)
    for i, r in enumerate(reqs):
        prompts[i, : r.prompt_len] = torch.tensor(r.prompt, dtype=torch.int32)
    lens = torch.tensor([r.prompt_len for r in reqs], dtype=torch.int32, device=device)
    dense, _, _ = model.prefill(prompts, lens)
    per = -(-(cap + 1) // BLOCK_LEN)
    cache = model.init_paged_cache(n * per, BLOCK_LEN)
    table = torch.arange(n * per, dtype=torch.int32, device=device).reshape(n, per)
    paged = torch.zeros_like(dense)
    for start in range(0, cap, chunk):
        take = torch.clamp(lens - start, 0, chunk)
        toks = torch.zeros((n, chunk), dtype=torch.int32, device=device)
        width = min(chunk, cap - start)
        toks[:, :width] = prompts[:, start:start + width]
        plog, cache = model.prefill_paged(cache, toks, torch.full_like(lens, start), take,
                                          table)
        paged = torch.where(((take > 0) & (start + take >= lens))[:, None], plog, paged)
    return dense[:, :v].float(), paged[:, :v].float()


def serve_dense_phase(model, paged_rep, tag: str = "serve-dense",
                      keep: dict | None = None) -> dict:
    """The serve phase's trace through ``serve(paged=False)`` (dense per-slot
    caches), same slots, decode chunks and seed; the first-round logits of
    the two paths held against each other. Returns the launch counts and
    the report. ``tag`` heads the printed lines; ``keep`` as
    ``serve_phase``'s."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.runtime.serve_loop import ServeConfig, Server

    cfg = model.config
    trace = serve_trace(cfg)
    kernels.reset_launch_counts()
    server = Server(model, ClusterSpec.make(*CLUSTER),
                    ServeConfig(block_rows=256, deadline_safety=SAFETY, scheme="optimal"))
    rep = server.serve(trace, slots=SLOTS, decode_block=DECODE_BLOCK, seed=0, paged=False)
    counts = kernels.launch_counts()
    done = [f for f in rep.finished if f.outcome == "done"]
    same = sum(rep.streams.get(r.rid) == paged_rep.streams.get(r.rid) for r in trace)
    print(f"[{tag}] {len(done)}/{len(trace)} done, shed {rep.shed}, tokens "
          f"{rep.tokens}, decode rounds {rep.decode_rounds}, prefill rounds "
          f"{rep.prefill_rounds}, KV cache bytes {rep.kv_bytes} (paged pool "
          f"{paged_rep.kv_bytes})")
    print(f"[{tag}] wall {rep.wall_s:.3f} s, {rep.tokens_per_s:.2f} tokens/s "
          f"(paged {paged_rep.wall_s:.3f} s, {paged_rep.tokens_per_s:.2f} tokens/s), decode "
          f"ok rate {rep.decode_ok}/{rep.decode_rounds}, erased rounds {rep.erased_rounds}")
    print(f"[{tag}] launches {counts}; {same}/{len(trace)} streams equal the paged "
          f"serve's")
    check(len(done) == len(trace) and rep.shed == 0, "dense: every request done, none shed")
    check(rep.tokens == sum(r.out_len for r in trace), "dense: tokens == sum(out_len)")
    check(counts["coded_matvec"] == rep.decode_rounds,
          "dense: coded_matvec launches == decode steps")
    check(counts["paged_decode"] == 0, "dense: paged_decode never launched")

    # the logits each path samples a request's first token from: one dense
    # prefill of the whole prompt, and the paged prefill in chunks of CHUNK
    # tokens. The float32-compute twin (the same weights) must compute the
    # same logits both ways; in bf16 the paths round differently (the dense
    # attend rounds the scaled scores and the unnormalised P V to bf16, the
    # paged one the scores and the normalised weights), and layers of random
    # weights amplify that, so each bf16 path is held against float32 and
    # the dense one may be no noisier than the paged one.
    reqs = trace[:SLOTS]
    dense32, paged32 = first_round_logits(with_config(model, compute_dtype="float32"),
                                          reqs, CHUNK)
    err32, tol32 = max_err(dense32, paged32), 2.0**-14 * float(paged32.abs().max())
    print(f"[{tag}] first-round logits (f32 compute, same weights): dense prefill "
          f"vs paged chunks of {CHUNK}: max_abs_err {err32:.3e} <= tol {tol32:.3e} "
          f"(2^-14 max|logits|)")
    check(err32 <= tol32, "dense and paged first-round logits disagree in float32")
    dense, paged = first_round_logits(model, reqs, CHUNK)
    scale = float(paged32.abs().max())
    err, e_dense, e_paged = max_err(dense, paged), max_err(dense, dense32), max_err(paged, paged32)
    print(f"[{tag}] first-round logits (bf16): dense vs paged max_abs_err {err:.3e} "
          f"({err / (2.0**-6 * scale):.2f} x 2^-6 max|logits|); against float32: dense "
          f"{e_dense:.3e}, paged {e_paged:.3e} (dense <= 2 paged + 2^-8 max|logits| = "
          f"{2 * e_paged + 2.0**-8 * scale:.3e}); argmax equal "
          f"{int((dense.argmax(1) == paged.argmax(1)).sum())}/{SLOTS}")
    check(bool(torch.isfinite(dense).all()) and e_dense <= 2 * e_paged + 2.0**-8 * scale,
          "the dense path's bf16 logits are noisier than the paged path's")
    if keep is not None:
        keep[tag] = server
    return counts, rep


#: [obs]: the profiled copies, each in its own profiler session and phase,
#: and their depth (``obs_trace``; generate's first OBS_GEN_NEW tokens)
OBS_PHASES = ("serve_paged", "serve_dense", "generate")
OBS_REQUESTS, OBS_PROMPT, OBS_OUT, OBS_GEN_NEW = 1, (32, 64), (4, 8), 2
#: the serving kernels by a piece of their compiled names. B1's split-K
#: GEMM and B3 are one kernel, ``psg::pipe_sgemm_kernel``
#: (kernels/csrc/pipe_sgemm.cuh): B1 at the serve shapes runs several
#: splits (grid y > 1), B3 one (grid y 1)
OBS_NAMES = (("split_sum_kernel", "coded_matvec"), ("narrow_matvec_kernel", "coded_matvec"),
             ("paged_decode_split_kernel", "paged_decode"),
             ("paged_decode_combine_kernel", "paged_decode"))
#: pieces of name that only the repo's own kernels carry
OBS_REPO_MARKS = ("pipe_sgemm", "split_sum", "narrow_matvec", "paged_decode", "fused_ce",
                  "Epi")
OBS_HEADINGS = ("# Ops report", "## Overview", "## Span waterfall", "## Request latency",
                "## Replan / decision timeline", "## Straggler-estimate drift",
                "## KV block pool", "## Metrics snapshot",
                "## Torch profile summary (per phase)")


def repo_kernel(event: dict) -> str | None:
    """The ``KERNELS`` entry a profiled device event belongs to (None: not
    one of the serving kernels; ``repo_unmapped`` tells the repo's own
    kernels apart from PyTorch's)."""
    name = event.get("name", "")
    if "pipe_sgemm_kernel" in name:
        grid = (event.get("args") or {}).get("grid")
        if not grid or len(grid) < 2:
            return None
        return "coded_matvec" if grid[1] > 1 else "mds_encode"
    return next((k for part, k in OBS_NAMES if part in name), None)


def count_calls(obj, name: str) -> list[int]:
    """Wrap the bound method ``obj.name`` so that each call adds one to the
    returned one-element counter. The wrapper holds ``obj`` (a reference
    cycle): ``del obj.name`` takes it off, so that ``obj`` and its CUDA
    graphs are freed when the last name goes, not by a later collection
    (one inside a profiler session could destroy a graph there)."""
    calls, real = [0], getattr(obj, name)

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    setattr(obj, name, counted)
    return calls


def obs_trace(cfg):
    """[obs]'s short trace. A profiled serve of [serve]'s 8 requests writes
    hundreds of MB of trace JSON, and the profiler's stop, the export and
    the analysis take over a minute on the H100. So the profiled copies
    serve OBS_REQUESTS request of OBS_PROMPT tokens (one prefill chunk)
    with OBS_OUT new tokens: two dispatches."""
    from repro_torch.serve.workload import make_workload

    return make_workload("poisson", num_requests=OBS_REQUESTS, prompt_len=OBS_PROMPT,
                         out_len=OBS_OUT, vocab=cfg.vocab_size).trace(seed=0)


def obs_phase(model, gen_out) -> dict:
    """The serving paths once more with the observability layer on, each
    under its own ``obs.profile.capture`` session and phase, on a short
    trace (``obs_trace``) served twice first without the profiler, by
    the same server (built, then captured: the profile sees replays of
    captured graphs), for the streams to hold to: (1) the paged serve
    with a ``Telemetry`` JSONL,
    so its spans ride on it; (2) the dense serve, measured by a
    ``RoundClock`` and observed by an ``AdaptiveController`` that holds
    (threshold 1.0: no gain can reach it) with admission at a fixed
    latency, on the same JSONL; (3) the first OBS_GEN_NEW tokens of
    [generate]'s coded optimal run with a ``dispatch`` span. Streams and
    tokens equal the unprofiled runs'; every JSONL record validates; the
    chunk spans equal the dispatches; per phase, B1, B2 and B3's device
    launches that the profile files under it equal its launch counters
    times the device launches per call; device-op time <= the phase's
    wall; the ops report has every section. Returns the counts by path."""
    import os
    import tempfile

    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.kernels.coded_matvec import ops as cmv
    from repro_torch.launch.obsreport import load_records, render_report
    from repro_torch.obs import profile
    from repro_torch.obs.schema import validate_events
    from repro_torch.obs.trace import SpanTracer
    from repro_torch.runtime.control import AdaptConfig, AdaptiveController
    from repro_torch.runtime.serve_loop import ServeConfig, Server
    from repro_torch.runtime.telemetry import Telemetry
    from repro_torch.runtime.timing import RoundClock

    cfg, device = model.config, model.device
    fleet = ClusterSpec.make(*CLUSTER)
    conf = ServeConfig(block_rows=256, deadline_safety=SAFETY, scheme="optimal")
    trace = obs_trace(cfg)
    kw = dict(slots=SLOTS, decode_block=DECODE_BLOCK, seed=0)
    paged_kw = dict(kw, block_len=BLOCK_LEN, prefill_chunk=CHUNK)
    # each profiled copy runs on a server that served it twice unprofiled
    # (built, then captured): the profile sees replays of captured graphs
    servers = {p: Server(model, fleet, conf) for p in OBS_PHASES}
    plain = {"serve_paged": servers["serve_paged"].serve(trace, **paged_kw),
             "serve_dense": servers["serve_dense"].serve(trace, paged=False, **kw)}
    servers["serve_paged"].serve(trace, **paged_kw)
    servers["serve_dense"].serve(trace, paged=False, **kw)
    print(f"[obs] profiled copies: a trace of {len(trace)} (prompt lengths "
          f"{[r.prompt_len for r in trace]}, out {[r.out_len for r in trace]}) served "
          f"unprofiled first, paged {plain['serve_paged'].wall_s:.3f} s and dense "
          f"{plain['serve_dense'].wall_s:.3f} s; generate's first {OBS_GEN_NEW} tokens")
    counts, spans, calls, walls = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "obs.jsonl")
        tel = Telemetry(jsonl)

        kernels.reset_launch_counts()
        t = time.perf_counter()
        server = servers["serve_paged"]
        calls["serve_paged"] = count_calls(server, "_run")
        with profile.capture(tmp, "serve_paged"):
            rep = server.serve(trace, telemetry=tel, **paged_kw)
        walls["serve_paged"] = time.perf_counter() - t
        counts["serve_paged"] = kernels.launch_counts()
        spans["serve_paged"] = list(server.tracer.spans)
        nb = server.coded_head.nb
        base = plain["serve_paged"].wall_s
        print(f"[obs] serve_paged: serve wall {rep.wall_s:.3f} s under the profiler, "
              f"{base:.3f} s without ({rep.wall_s / base:.2f}x); launches "
              f"{counts['serve_paged']}")
        check(rep.streams == plain["serve_paged"].streams,
              "tracing changed the paged serve's streams")

        kernels.reset_launch_counts()
        t = time.perf_counter()
        server = servers["serve_dense"]
        exe = server.coded_head.executor
        calls["serve_dense"] = count_calls(server, "_run")
        with profile.capture(tmp, "serve_dense"):
            ctl = AdaptiveController(exe, AdaptConfig(every=1, threshold=1.0), telemetry=tel)
            clock = RoundClock(exe, telemetry=tel)
            rep = server.serve(trace, paged=False, telemetry=tel, clock=clock, controller=ctl,
                               round_latency=lambda: 1.0, tracer=SpanTracer(tel), **kw)
        walls["serve_dense"] = time.perf_counter() - t
        counts["serve_dense"] = kernels.launch_counts()
        spans["serve_dense"] = list(server.tracer.spans)
        print(f"[obs] serve_dense (measured, a holding controller): serve wall "
              f"{rep.wall_s:.3f} s ({plain['serve_dense'].wall_s:.3f} s unmeasured and "
              f"unprofiled); {clock.rounds} dispatches timed, {clock.fed} fed, "
              f"{len(ctl.decisions)} decisions ({ctl.replans} replans); launches "
              f"{counts['serve_dense']}")
        check(ctl.replans == 0 and len(ctl.decisions) > 0,
              "the holding controller decided and never replanned")
        check(rep.streams == plain["serve_dense"].streams,
              "tracing changed the dense serve's streams")

        prompts = gen_prompts(cfg.vocab_size)
        server = servers["generate"]
        for _ in range(2):
            server.generate(prompts, OBS_GEN_NEW, seed=1, cache_len=GEN_PROMPT + GEN_NEW)
        server.tracer = SpanTracer(tel)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        with profile.capture(tmp, "generate"):
            out = server.generate(prompts, OBS_GEN_NEW, seed=1,
                                  cache_len=GEN_PROMPT + GEN_NEW)
        walls["generate"] = time.perf_counter() - t
        counts["generate"] = kernels.launch_counts()
        spans["generate"] = list(server.tracer.spans)
        check(torch.equal(out, gen_out[:, :GEN_PROMPT + OBS_GEN_NEW]),
              "tracing changed generate's tokens")
        tel.close()
        replayed = {p: (servers[p].programs.captures, servers[p].programs.replays)
                    for p in OBS_PHASES}
        print("[obs] profiled copies replay captured graphs: " + ", ".join(
            f"{p} {c} captures, {r} replays" for p, (c, r) in replayed.items()))
        check(all(c > 0 and r > 0 for c, r in replayed.values()) or device.type != "cuda",
              "every profiled copy replayed captured graphs")
        for srv in servers.values():
            srv.__dict__.pop("_run", None)
        del server, exe, ctl, servers
        sizes = {p: os.path.getsize(os.path.join(tmp, f"{p}.pt.trace.json")) / 1e6
                 for p in walls}
        print("[obs] captures (run, profiler stop and trace export): " + ", ".join(
            f"{p} {w:.1f} s ({sizes[p]:.1f} MB)" for p, w in walls.items()))

        records = load_records(jsonl)
        n = validate_events(records, source="[obs] JSONL")
        check(n == len(records), "every JSONL record is an event")
        for phase in ("serve_paged", "serve_dense"):
            names = [s.name for s in spans[phase]]
            chunks = names.count("prefill_chunk") + names.count("decode_chunk")
            by_name = ", ".join(f"{x} {names.count(x)}" for x in dict.fromkeys(names))
            print(f"[obs] {phase} spans: {len(names)} ({by_name}); "
                  f"{calls[phase][0]} dispatches")
            check(chunks == calls[phase][0] == names.count("dispatch"),
                  f"{phase}: prefill_chunk + decode_chunk spans == dispatches")
        check([(s.name, s.attrs) for s in spans["generate"]]
              == [("dispatch", {"kind": "generate", "max_new": OBS_GEN_NEW,
                                "batch": GEN_BATCH})],
              "generate: one dispatch span")
        check(all(s.parent == "decode_chunk" for s in spans["serve_dense"]
                  if s.name == "adapt_update"), "adapt_update nests in its chunk")

        t = time.perf_counter()
        summ = profile.summarize(tmp, OBS_PHASES, events=True)
        plan = cmv.gemm_plan(nb, SLOTS * 256, -(-cfg.vocab_size // 256),
                             cmv.sm_count(device.index or 0)) if device.type == "cuda" else None
        per_call = {"coded_matvec": 1 + (plan is not None and plan.splits > 1),
                    "paged_decode": 2, "mds_encode": 1}
        if plan is not None:
            check(plan.splits > 1, "B1 splits at the serve shapes (its grid tells it from B3)")
        for phase in OBS_PHASES:
            s = summ[phase]
            wall, dev = s["wall_us"] / 1e3, s["op_total_us"] / 1e3
            print(f"[obs] {phase}: wall {wall:.1f} ms, device ops {dev:.1f} ms "
                  f"({dev / wall:.3f} of the wall; the host's share {1 - dev / wall:.3f}), "
                  f"{s['n_ops']} device ops; the top {len(s['ops'])} by device time:")
            for o in s["ops"]:
                print(f"[obs]   {o['total_us'] / 1e3:9.3f} ms x{o['count']:<6d} "
                      f"{o['name'][:100]}")
            mine = {k: [0, 0.0] for k in per_call}
            unmapped = {}
            for e in s.pop("events"):
                k = repo_kernel(e)
                if k in mine:
                    mine[k][0] += 1
                    mine[k][1] += e["dur"] / 1e3
                elif any(m in e.get("name", "") for m in OBS_REPO_MARKS):
                    unmapped[e["name"]] = unmapped.get(e["name"], 0) + 1
            print("[obs]   repo kernels: " + ", ".join(
                f"{k} {c} device launches ({counts[phase][k]} calls x {per_call[k]}) "
                f"{ms:.3f} ms" for k, (c, ms) in mine.items())
                  + (f"; not mapped: {unmapped}" if unmapped else "; every one mapped"))
            for k, (c, _) in mine.items():
                check(c == counts[phase][k] * per_call[k],
                      f"{phase}: the profile files {c} {k} launches, the counter says "
                      f"{counts[phase][k]} x {per_call[k]}")
            check(s["op_total_us"] <= s["wall_us"], f"{phase}: device-op time <= wall")
        check(counts["serve_dense"]["paged_decode"] == 0
              and counts["generate"]["paged_decode"] == 0,
              "B2 launches only in the paged serve")
        md = render_report(records, source="obs.jsonl", profile_summary=summ)
        missing = [h for h in OBS_HEADINGS if h not in md]
        print(f"[obs] ops report: {len(md.splitlines())} lines, {len(records)} records, "
              f"sections missing: {missing or 'none'}; profile analysis "
              f"{time.perf_counter() - t:.1f} s")
        lines = md.splitlines()
        at = lines.index("## Span waterfall")
        for line in lines[at + 2:at + 12]:
            if line:
                print(f"[obs]   {line}")
        check(not missing, "the ops report has every section")
    return {f"obs_{p}": c for p, c in counts.items()}

def round_cond(head, ok, mask) -> float:
    """cond(G_S) of the generator rows a coded round decoded from; 0 for a
    failed round (it returns the plain logits)."""
    import torch

    if not bool(ok):
        return 0.0
    alive = head.executor.slot_mask(mask)
    order = torch.argsort((~alive).to(torch.int8), stable=True)[: head.kb]
    return float(torch.linalg.cond(head.generator[order].double()))


def held_tokens(name, new, plain_new, margins, scales, conds) -> tuple[int, int]:
    """Coded tokens (B, T) against the uncoded ones, row by row up to the
    first difference: a difference where the uncoded top-2 margin exceeds
    2 cond(G_S) 2^-22 max|logits| (each of two logits may move by that)
    fails. Returns (tokens equal before any difference, those checked)."""
    covered = equal = 0
    for r in range(new.shape[0]):
        for t in range(new.shape[1]):
            tol = conds[t] * 2.0**-22 * scales[t]
            clear = float(margins[t][r]) > 2 * tol
            if int(new[r, t]) != int(plain_new[r, t]):
                check(not clear, f"{name}: token {t} of row {r} differs from the "
                                 f"uncoded one with a clear margin")
                break  # the contexts differ from here on
            equal += 1
            covered += clear
    return equal, covered


def uncoded_reference(model, prompts, max_new, extras=None):
    """The uncoded generate's tokens (after the prompt, on the host) and,
    per step, each row's top-2 margin and max|logits|."""
    from repro_torch.runtime.serve_loop import Server

    v = model.config.vocab_size
    logits = []
    out = Server(model).generate(prompts, max_new, extras=extras,
                                 observe=lambda step, lg, sel, ok, mask:
                                 logits.append(lg[:, :v].float()))
    tops = [lg.topk(2, dim=1).values for lg in logits]
    margins = [(m[:, 0] - m[:, 1]).cpu() for m in tops]
    scales = [float(lg.abs().max()) for lg in logits]
    return out, out[:, prompts.shape[1]:].cpu(), margins, scales


#: the comm-delay schemes' fleet: the serve fleet behind finite links
COMM_BANDWIDTHS, COMM_COSTS = [4.0, 1.0], {"upload": 0.05, "download": 0.05}
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_NEW_SCHEMES = 4, 128, 8, 4


def gen_prompts(vocab: int):
    """[generate]'s seeded (GEN_BATCH, GEN_PROMPT) prompts, on the host."""
    import torch

    return torch.randint(0, vocab, (GEN_BATCH, GEN_PROMPT), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))


def generate_phase(model, card: str) -> dict:
    """``Server.generate`` at full width: uncoded, then coded under every
    scheme of the registry's baselines on the serve fleet, each held against
    the uncoded tokens. Returns the coded optimal run's launch counts and
    its output."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.core.schemes import make_scheme
    from repro_torch.runtime.serve_loop import ServeConfig, Server

    cfg, device = model.config, model.device
    v = cfg.vocab_size
    prompts = gen_prompts(v)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def run(server, max_new, seed, observe):
        sync()
        t = time.perf_counter()
        out = server.generate(prompts, max_new, seed=seed, observe=observe)
        sync()
        return out, time.perf_counter() - t

    kernels.reset_launch_counts()
    sync()
    t = time.perf_counter()
    plain, plain_new, margins, scales = uncoded_reference(model, prompts, GEN_NEW)
    sync()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    print(f"[generate] uncoded: batch {GEN_BATCH} x prompt {GEN_PROMPT}, {GEN_NEW} new: "
          f"wall {wall:.3f} s, {GEN_BATCH * GEN_NEW / wall:.1f} tokens/s ({card}); "
          f"launches {counts}")
    check(tuple(plain.shape) == (GEN_BATCH, GEN_PROMPT + GEN_NEW), "uncoded output shape")
    check(int(plain.max()) < v and int(plain.min()) >= 0, "uncoded tokens < vocab_size")
    check(counts["coded_matvec"] == 0 and counts["paged_decode"] == 0,
          "uncoded generate launches no head or paged kernel")
    check(torch.equal(plain[:, :GEN_PROMPT].cpu(), prompts), "the prompt heads the output")

    fleet = ClusterSpec.make(*CLUSTER)
    comm_fleet = ClusterSpec.make(*CLUSTER, 1.0, COMM_BANDWIDTHS)
    runs = [("optimal", {}, GEN_NEW, fleet),
            ("uniform_r", {"r": 10}, GEN_NEW_SCHEMES, fleet),
            ("uniform_r_group_code", {"r": 8}, GEN_NEW_SCHEMES, fleet),
            ("reisizadeh", {}, GEN_NEW_SCHEMES, fleet),
            ("uncoded", {}, GEN_NEW_SCHEMES, fleet),
            ("comm_aware", COMM_COSTS, GEN_NEW_SCHEMES, comm_fleet),
            ("comm_uniform", COMM_COSTS, GEN_NEW_SCHEMES, comm_fleet)]
    optimal_counts = optimal_out = None
    for seed, (name, params, max_new, cluster) in enumerate(runs, start=1):
        kernels.reset_launch_counts()
        server = Server(model, cluster, ServeConfig(
            block_rows=256, deadline_safety=SAFETY, scheme=make_scheme(name, **params)))
        rounds = []
        out, wall = run(server, max_new, seed,
                        lambda step, lg, sel, ok, mask: rounds.append((ok, mask)))
        counts = kernels.launch_counts()
        head = server.coded_head
        ok_n = sum(int(ok) for ok, _ in rounds)
        erased = sum(int(not bool(mask.all())) for _, mask in rounds)
        # per round: cond of the generator rows the decode used
        conds = [round_cond(head, ok, mask) for ok, mask in rounds]
        equal, covered = held_tokens(name, out[:, GEN_PROMPT:].cpu(), plain_new, margins,
                                     scales, conds)
        print(f"[generate] {name} [{head.plan.scheme}]: kb {head.kb}, nb {head.nb}, loads "
              f"{head.plan.loads_per_worker.tolist()}, deadline {head.deadline:.6f}")
        print(f"[generate] {name}: {max_new} new, wall {wall:.3f} s, "
              f"{GEN_BATCH * max_new / wall:.1f} tokens/s ({card}); decode ok "
              f"{ok_n}/{max_new}, erased rounds {erased}; launches {counts}; "
              f"{equal}/{GEN_BATCH * max_new} tokens equal the uncoded run's before any "
              f"difference, {covered} of them checked (top-2 margin > 2 cond(G_S) 2^-22 "
              f"max|logits|, cond up to {max(conds):.3e})")
        check(tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + max_new), f"{name}: output shape")
        check(int(out.max()) < v and int(out.min()) >= 0, f"{name}: tokens < vocab_size")
        check(counts["coded_matvec"] == max_new, f"{name}: coded_matvec launches == max_new")
        check(counts["mds_encode"] == 1, f"{name}: mds_encode launches == 1 for the head")
        check(counts["paged_decode"] == 0, f"{name}: paged_decode never launched")
        check(len(rounds) == max_new, f"{name}: every token through the coded head")
        if name == "optimal":
            optimal_counts, optimal_out = counts, out
        del server, head, rounds
    return optimal_counts, optimal_out


#: Path R: the serve fleet under a drifting truth, the CLI's round
ADAPT_SCENARIOS, ADAPT_ROUNDS, ADAPT_PROMPT, ADAPT_NEW = ("mu_step", "churn"), 12, 16, 4


def adapt_phase(model, card: str) -> dict:
    """Closed-loop replanning at full width: per scenario, ``Server.generate``
    rounds (4 x 16-token prompts, 4 new, the CLI's defaults) with the coded
    head under the scenario's true fleet, an ``AdaptiveController`` (every
    2, threshold 0.05) observing each round and replanning; each replan
    re-encodes the head through B3, held against ``mds_encode_plain``.
    Counters reset before each scenario and read after. Returns the launch
    counts by scenario."""
    import torch
    import torch.nn.functional as F

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.kernels.mds_encode import ops as mds
    from repro_torch.obs.trace import SpanTracer
    from repro_torch.runtime.control import AdaptConfig, AdaptiveController
    from repro_torch.runtime.serve_loop import ServeConfig, Server
    from repro_torch.sim import make_scenario

    v = model.config.vocab_size
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    prompts = torch.randint(0, v, (4, ADAPT_PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    _, plain_new, margins, scales = uncoded_reference(model, prompts, ADAPT_NEW)
    fleet = ClusterSpec.make(*CLUSTER)
    out_counts = {}
    for name in ADAPT_SCENARIOS:
        trace = make_scenario(name, horizon=ADAPT_ROUNDS).trace(fleet, seed=0)
        kernels.reset_launch_counts()
        server = Server(model, fleet, ServeConfig(block_rows=256, scheme="optimal"))
        head = server.coded_head
        tracer = SpanTracer()
        head.executor.tracer = tracer
        replans = []

        def on_replan():
            sync()
            t = time.perf_counter()
            server.refresh_coded_head()
            sync()
            encode_s = time.perf_counter() - t
            vp, dm = head.table.shape
            blocks = F.pad(head.table, (0, 0, 0, head.kb * head.block_rows - vp))
            blocks = blocks.reshape(head.kb, head.block_rows * dm)
            got = head.coded.reshape(head.nb, -1)
            err = float((got - mds.mds_encode_plain(head.generator, blocks)).abs().max())
            replans.append(dict(encode_s=encode_s, err=err,
                                tol=gemm_tolerance(head.generator, blocks),
                                alloc_s=tracer.spans[-1].dur_s))

        ctl = AdaptiveController(head.executor, AdaptConfig(every=2, threshold=0.05),
                                 on_replan=on_replan)
        observe = torch.Generator().manual_seed(7)
        walls, oks, held, membership, replanned_at = [], 0, [0, 0], [], []
        print(f"[adapt] {name}: kb {head.kb}, nb {head.nb}, deadline {head.deadline:.6f}, "
              f"trace changes at rounds {list(trace.change_rounds())}")
        for t in range(ADAPT_ROUNDS):
            truth = trace.at(t)
            server.set_true_cluster(truth)
            rounds = []
            sync()
            t0 = time.perf_counter()
            out = server.generate(prompts, ADAPT_NEW, seed=t, observe=lambda step, lg, sel, ok,
                                  mask: rounds.append((ok, mask)))
            sync()
            walls.append(time.perf_counter() - t0)
            oks += sum(int(ok) for ok, _ in rounds)
            conds = [round_cond(head, ok, mask) for ok, mask in rounds]
            eq, cov = held_tokens(f"{name} round {t}", out[:, ADAPT_PROMPT:].cpu(), plain_new,
                                  margins, scales, conds)
            held[0] += eq
            held[1] += cov
            d = ctl.observe_truth(observe, truth)
            if d is None:
                continue
            line = (f"[adapt] {name} round {t}: decision {d.reason}, gain {d.gain:.4f}, "
                    f"truth {[g.num_workers for g in truth.groups]} workers")
            if d.replanned:
                replanned_at.append(t)
                rp = replans[-1]
                line += (f"; replanned: n {head.nb}, workers {head.executor.num_workers}, "
                         f"loads {head.plan.loads_per_worker.tolist()}, deadline "
                         f"{head.deadline:.6f}; allocation {1e3 * rp['alloc_s']:.2f} ms, B3 "
                         f"re-encode {1e3 * rp['encode_s']:.2f} ms, max_abs_err vs plain "
                         f"{rp['err']:.3e} <= tol {rp['tol']:.3e}")
                check(rp["err"] <= rp["tol"], f"{name}: a B3 re-encode disagrees with plain")
                if d.reason == "membership":
                    membership.append((t, head.executor.num_workers))
            print(line)
        counts = kernels.launch_counts()
        out_counts[name] = counts
        n_rep = len(replanned_at)
        print(f"[adapt] {name}: {ADAPT_ROUNDS} rounds, walls {min(walls):.3f}-{max(walls):.3f} "
              f"s (mean {sum(walls) / len(walls):.3f} s, {ADAPT_NEW} tokens a round, {card}); "
              f"decode ok {oks}/{ADAPT_ROUNDS * ADAPT_NEW}; {n_rep} replans, after rounds "
              f"{replanned_at}; {held[0]} tokens equal "
              f"the uncoded run's before any difference, {held[1]} checked; launches {counts}")
        program_counts(name, server, replanned_at)
        check(counts["mds_encode"] == 1 + n_rep, f"{name}: mds_encode == 1 + replans")
        check(counts["coded_matvec"] == ADAPT_ROUNDS * ADAPT_NEW,
              f"{name}: coded_matvec == rounds x tokens")
        check(counts["paged_decode"] == 0, f"{name}: paged_decode never launched")
        check(len(replans) == n_rep, f"{name}: every replan re-encoded the head")
        if name == "churn":
            check(membership == [(3, 9), (9, 12)],
                  f"churn: membership replans at rounds 3 (9 workers) and 9 (12), got "
                  f"{membership}")
        del server, head, ctl
    return out_counts


def program_counts(tag: str, server, rebuilt_after: list[int]) -> None:
    """Print and hold a round loop's programs: one ``generate`` key, built
    again after each structural replan that a round follows (rounds after
    a bucket switch reuse it), and captured at the second round of each
    build on the card."""
    bounds = [0, *sorted(t + 1 for t in rebuilt_after if t < ADAPT_ROUNDS - 1), ADAPT_ROUNDS]
    segments = [b - a for a, b in zip(bounds, bounds[1:])]
    p = server.programs
    print(f"[adapt] {tag} programs: {server.traces} builds, {p.captures} captures "
          f"({p.capture_s:.3f} s), {p.replays} replays; builds after rounds "
          f"{bounds[1:-1]}")
    check(server.traces == len(segments), f"{tag}: a build per structural replan only")
    if server.device.type == "cuda":
        check(p.captures == sum(n >= 2 for n in segments),
              f"{tag}: a capture per build used twice")


#: [adapt] (c): the bucket quantum of the measured mu_step pass
ADAPT_QUANTUM = 4


def allocation_ms(fleet, k: int, calls: int = 20) -> float:
    """Median ms of one replan's allocation (``optimal`` onto a drifted
    fleet, the memo cleared before each call) on this machine's host."""
    import statistics

    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.core.schemes import allocate_cache_clear, make_scheme

    scheme = make_scheme("optimal")
    drifted = ClusterSpec.make([g.num_workers for g in fleet.groups],
                               [g.mu * 0.9 for g in fleet.groups])

    out = []
    for _ in range(calls):
        allocate_cache_clear()
        t = time.perf_counter()
        scheme.allocate(drifted, k)
        out.append(1e3 * (time.perf_counter() - t))
    allocate_cache_clear()
    return statistics.median(out)


def adapt_measured_phase(model, card: str, paged_rep) -> dict:
    """The measured and bucketed serving paths at full width: (c) ``mu_step``
    rounds of ``generate`` under a ``RoundClock`` with the head bucketed
    (quantum 4), driven as the serving CLI's ``--measure-times`` drives
    them; (d) ``[serve]``'s trace through ``serve(clock=)`` with no
    controller, whose streams must equal ``[serve]``'s; and one replan's
    allocation time. Counters reset before (c) and (d) and read after. In
    (c) the head's encode at ``n_cap`` is held against B3's plain version,
    and after the count is read one round's block mix at ``n_cap`` against
    B1's; B3 and B1 are timed at ``n_cap`` and at the unbucketed ``n`` to
    net the re-encodes that buckets avoid against what the wider code
    costs. Returns the counts by path."""
    import torch
    import torch.nn.functional as F

    import repro_torch.kernels as kernels
    from repro_torch.core.coding import make_generator
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.kernels.coded_matvec import ops as cmv
    from repro_torch.kernels.mds_encode import ops as mds
    from repro_torch.runtime.executor import CodedRoundExecutor
    from repro_torch.runtime.control import AdaptConfig, AdaptiveController
    from repro_torch.runtime.serve_loop import ServeConfig, Server
    from repro_torch.runtime.timing import RoundClock
    from repro_torch.sim import make_scenario

    v = model.config.vocab_size
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    prompts = torch.randint(0, v, (4, ADAPT_PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    _, plain_new, margins, scales = uncoded_reference(model, prompts, ADAPT_NEW)
    fleet = ClusterSpec.make(*CLUSTER)
    out = {}

    # (c) mu_step, measured, bucketed
    trace = make_scenario("mu_step", horizon=ADAPT_ROUNDS).trace(fleet, seed=0)
    kernels.reset_launch_counts()
    server = Server(model, fleet, ServeConfig(block_rows=256, scheme="optimal",
                                              bucket_quantum=ADAPT_QUANTUM))
    head = server.coded_head
    exe = head.executor
    vp, dm = head.table.shape
    blocks = F.pad(head.table, (0, 0, 0, head.kb * head.block_rows - vp))
    blocks = blocks.reshape(head.kb, head.block_rows * dm)
    err = float((head.coded.reshape(head.nb, -1)
                 - mds.mds_encode_plain(head.generator, blocks)).abs().max())
    tol = gemm_tolerance(head.generator, blocks)
    encodes = []

    def on_replan():
        sync()
        t = time.perf_counter()
        server.refresh_coded_head()
        sync()
        encodes.append(time.perf_counter() - t)

    ctl = AdaptiveController(exe, AdaptConfig(every=2, threshold=0.05), on_replan=on_replan)
    clock = RoundClock(exe)
    observe = torch.Generator().manual_seed(7)
    print(f"[adapt] mu_step measured, bucket quantum {ADAPT_QUANTUM}: kb {head.kb}, nb "
          f"{head.nb} (n_cap), n {exe.n}, deadline {head.deadline:.6f}")
    print(f"[adapt] mu_step measured: head encode at n_cap ({head.nb},{head.kb})x"
          f"({head.kb},{blocks.shape[1]}) max_abs_err vs plain {err:.3e} <= tol {tol:.3e}")
    check(err <= tol, "mu_step measured: the n_cap encode disagrees with B3's plain version")
    held, oks, replans, first_logits = [0, 0], 0, [], []

    def observe_round(step, lg, sel, ok, mask):
        rounds.append((ok, mask))
        if not first_logits:
            first_logits.append(lg.float().clone())

    for t in range(ADAPT_ROUNDS):
        truth = trace.at(t)
        server.set_true_cluster(truth)
        rounds = []
        timing = clock.measure(
            lambda: server.generate(prompts, ADAPT_NEW, seed=t, observe=observe_round),
            generator=observe, true_cluster=truth)
        oks += sum(int(ok) for ok, _ in rounds)
        conds = [round_cond(head, ok, mask) for ok, mask in rounds]
        eq, cov = held_tokens(f"mu_step measured round {t}", timing.result[:, ADAPT_PROMPT:].cpu(),
                              plain_new, margins, scales, conds)
        held[0] += eq
        held[1] += cov
        d = ctl.observe_timing(timing)
        line = (f"[adapt] mu_step measured round {t}: dispatch {timing.dispatch_s:.4f} s, "
                f"{'fed' if timing.skipped is None else 'skipped (' + timing.skipped + ')'}")
        if d is not None:
            line += f"; decision {d.reason}, gain {d.gain:.4f}"
            if d.replanned:
                structural = exe.last_replan_structural
                replans.append((t, structural, exe.last_bucket_hit))
                line += (f"; replanned: bucket {'hit' if exe.last_bucket_hit else 'miss'}, "
                         f"structural {structural}, n {exe.n}, active bucket "
                         f"{exe.active_bucket} of {len(exe.buckets)}, head rebind "
                         f"{1e3 * encodes[-1]:.2f} ms")
                if structural:
                    clock.discard_next()
        print(line)
    counts = kernels.launch_counts()
    structural = sum(st for _, st, _ in replans)
    print(f"[adapt] mu_step measured: clock {clock.fed}/{clock.rounds} rounds fed, unit_s "
          f"{clock.unit_s:.4e}; {len(replans)} replans ({structural} structural, "
          f"{sum(h for *_, h in replans)} bucket hits), B3 re-encodes avoided "
          f"{len(replans) - structural}; decode ok {oks}/{ADAPT_ROUNDS * ADAPT_NEW}; "
          f"{held[0]} tokens equal the uncoded run's, {held[1]} checked; launches {counts}")
    program_counts(f"mu_step measured ({len(replans) - structural} bucket switches, "
                   f"{structural} structural)", server, [t for t, st, _ in replans if st])
    check(counts["mds_encode"] == 1 + structural,
          "mu_step measured: mds_encode == 1 + structural replans")
    check(counts["coded_matvec"] == ADAPT_ROUNDS * ADAPT_NEW,
          "mu_step measured: coded_matvec == rounds x tokens")
    check(clock.rounds == ADAPT_ROUNDS and clock.fed == ADAPT_ROUNDS - 1 - structural,
          "mu_step measured: every round timed, all but warmup and rebuilds fed")
    out["adapt_mu_step_measured"] = counts

    # B1 held against plain on round 0's logits at n_cap (after the count),
    # then B3 and B1 timed at n_cap and at the unbucketed plan's n
    lg = first_logits[0]
    b, r = lg.shape[0], head.block_rows
    keep = torch.arange(lg.shape[1], device=lg.device)[None, :] < v
    lf = F.pad(torch.where(keep, lg, 0.0), (0, head.kb * r - lg.shape[1]))
    cols = lf.reshape(b, head.kb, r).permute(1, 0, 2).reshape(head.kb, b * r).contiguous()
    got = head.encode_logits(torch.where(keep, lg, 0.0)).reshape(head.nb, b * r)
    err = float((got - cmv.blocked_matvec_plain(head.generator, cols)).abs().max())
    tol = gemm_tolerance(head.generator, cols)
    print(f"[adapt] mu_step measured: round 0's block mix at n_cap ({head.nb},{head.kb})x"
          f"({head.kb},{b * r}) max_abs_err vs plain {err:.3e} <= tol {tol:.3e}")
    check(err <= tol, "mu_step measured: B1 at n_cap disagrees with its plain version")
    n0 = CodedRoundExecutor(fleet, head.kb, "optimal", device=model.device).n
    g0 = make_generator(n0, head.kb, device=model.device)
    cuda = model.device.type == "cuda"  # a CPU rehearsal times nothing
    # B3 runs milliseconds: CUDA events time it as the kernels line does
    enc = {nb: cuda_ms(lambda: mds.mds_encode(g, blocks), 5) if cuda else None
           for nb, g in ((head.nb, head.generator), (n0, g0))}
    mix = {nb: device_ms(lambda: cmv.blocked_matvec(g, cols)) if cuda else None
           for nb, g in ((head.nb, head.generator), (n0, g0))}
    tokens = ADAPT_ROUNDS * ADAPT_NEW
    avoided = len(replans) - structural
    line = (f"[adapt] bucket cost and saving (B3 event-timed, B1 device time): B3 encode "
            f"at n_cap {head.nb} "
            f"{fmt_ms(enc[head.nb])}, at unbucketed n {n0} {fmt_ms(enc[n0])}; B1 block mix "
            f"at {head.nb} rows {fmt_ms(mix[head.nb])}, at {n0} {fmt_ms(mix[n0])}")
    if None not in (*enc.values(), *mix.values()):
        saved = avoided * enc[n0]
        extra = (enc[head.nb] - enc[n0]) + tokens * (mix[head.nb] - mix[n0])
        line += (f"; this run: {avoided} re-encodes avoided x {enc[n0]:.4f} ms = "
                 f"{saved:.4f} ms saved, wider code costs {enc[head.nb] - enc[n0]:.4f} ms "
                 f"(encode) + {tokens} tokens x {mix[head.nb] - mix[n0]:.4f} ms (B1) = "
                 f"{extra:.4f} ms: net {saved - extra:.4f} ms")
    print(line + f" ({card})")
    del server, head, exe, ctl, blocks, g0
    if cuda:
        torch.cuda.empty_cache()

    # (d) [serve]'s trace under a clock, no controller
    kernels.reset_launch_counts()
    server = Server(model, fleet, ServeConfig(block_rows=256, deadline_safety=SAFETY,
                                              scheme="optimal"))
    clock = RoundClock(server.coded_head.executor)
    rep = server.serve(serve_trace(model.config), slots=SLOTS, block_len=BLOCK_LEN,
                       prefill_chunk=CHUNK, decode_block=DECODE_BLOCK, seed=0, clock=clock)
    counts = kernels.launch_counts()
    same = sum(rep.streams[rid] == paged_rep.streams[rid] for rid in paged_rep.streams)
    print(f"[adapt] measured serve of [serve]'s trace: {clock.rounds} dispatches timed, "
          f"{clock.fed} fed, unit_s {clock.unit_s:.4e}, smoothed dispatch "
          f"{clock.smoothed_s:.4f} s; wall {rep.wall_s:.3f} s ([serve]: "
          f"{paged_rep.wall_s:.3f} s); {same}/{len(paged_rep.streams)} streams equal "
          f"[serve]'s; launches {counts}")
    check(rep.streams == paged_rep.streams, "a measured serve changed the streams")
    check(clock.fed == clock.rounds - 1, "measured serve: fed == dispatches - 1")
    check(counts["coded_matvec"] == rep.decode_rounds
          and counts["paged_decode"] == model.config.num_layers * rep.decode_rounds,
          "measured serve: B1 == decode steps, B2 == layers x decode steps")
    out["serve_measured"] = counts
    del server

    print(f"[adapt] one replan's allocation (optimal, kb {-(-v // 256)}, 12 workers, median "
          f"of 20, memo cleared): {allocation_ms(fleet, -(-v // 256)):.3f} ms ({card} host)")
    return out


#: [programs]: the second trace's prompts are drawn with this seed
PROGRAM_SEED = 5
#: [programs]' generate seeds
PROGRAM_GEN_SEEDS = (1, 2)


def programs_trace2(trace, vocab: int):
    """[serve]'s trace with another prompt mix: each request keeps its
    arrival and output length, and its prompt is redrawn (tokens and a
    length within the same count of CHUNK-token chunks, at most the
    trace's longest prompt). The paged schedule, and so every program key,
    is the first trace's."""
    import dataclasses
    import random

    rng = random.Random(PROGRAM_SEED)
    longest = max(r.prompt_len for r in trace)
    out = []
    for r in trace:
        chunks = -(-r.prompt_len // CHUNK)
        n = rng.randint((chunks - 1) * CHUNK + 1, min(chunks * CHUNK, longest))
        out.append(dataclasses.replace(r, prompt=tuple(rng.randrange(vocab)
                                                       for _ in range(n))))
    return out


def busy_share(tmp: str, name: str, fn) -> tuple[float, float]:
    """(device-op time / wall, wall ms) of ``fn()`` in one profiler session
    (``obs.profile.capture``; device ops filed by their launch)."""
    import gc
    import os

    from repro_torch.obs import profile

    where = os.path.join(tmp, name)
    gc.collect()  # nothing unreachable is collected inside the session
    with profile.capture(where, name):
        fn()
    s = profile.summarize(where, [name])[name]
    return s["op_total_us"] / s["wall_us"], s["wall_us"] / 1e3


def programs_phase(model, card: str, served: dict, paged_rep, dense_rep) -> dict:
    """The dispatch programs captured as CUDA graphs against the same
    program functions uncaptured (``Server._capture = False``), at full
    width. For the paged and the dense serve of [serve]'s trace: [serve]'s
    and [serve-dense]'s servers (``served``) ran the captured first run
    (each key built, the keys dispatched twice captured); each serves the
    trace again (all replays) and then the trace with another prompt mix
    (``programs_trace2``), which must build and capture nothing; an eager
    server serves the trace once. For ``generate`` ([generate]'s prompts,
    8 new, the coded optimal head): the eager server for each of
    PROGRAM_GEN_SEEDS, the captured one for the first seed twice (built,
    then captured and replayed) and then each seed replayed. Streams,
    tokens, decode ok and erased rounds are held identical, and B1-B3
    launches (counters reset before each run) equal. Per mode the walls,
    the builds, captures and capture seconds, and the card's busy share
    from a profile of [obs]' one-request trace (two dispatches, replays:
    served twice before by [serve]'s or [serve-dense]'s server, and at
    least one of its graphs captured there, before [obs]'s profiler
    sessions) and of one generate call. Returns the counts by path: each mode's steady run."""
    import tempfile

    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.runtime.serve_loop import ServeConfig, Server

    cfg, device = model.config, model.device
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    fleet = ClusterSpec.make(*CLUSTER)
    conf = ServeConfig(block_rows=256, deadline_safety=SAFETY, scheme="optimal")
    trace = serve_trace(cfg)
    trace2 = programs_trace2(trace, cfg.vocab_size)
    short = obs_trace(cfg)
    paths = {}

    def timed(fn):
        """(result, wall s, launch counts) of ``fn()``, counters reset first."""
        kernels.reset_launch_counts()
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t, kernels.launch_counts()

    def eager_server() -> Server:
        server = Server(model, fleet, conf)
        server._capture = False
        return server

    def progs(server) -> str:
        p = server.programs
        return (f"{sum(p.builds.values())} builds, {p.captures} captures "
                f"({p.capture_s:.3f} s), {p.replays} replays")

    b123 = ("coded_matvec", "paged_decode", "mds_encode")
    with tempfile.TemporaryDirectory() as tmp:
        for tag, first, phase in (("paged", paged_rep, "serve"),
                                  ("dense", dense_rep, "serve-dense")):
            paged = tag == "paged"
            kw = dict(slots=SLOTS, decode_block=DECODE_BLOCK, seed=0, paged=paged)
            if paged:
                kw.update(block_len=BLOCK_LEN, prefill_chunk=CHUNK)
            cap, c_counts = served[phase], served[phase, "counts"]
            after_first = progs(cap)
            old_keys = set(cap.programs.keys(captured=True))  # captured in [phase]
            # the first trace's shapes (the pool; the dense caps), which the
            # second trace and the profiled one fit in
            shape = (dict(num_blocks=SLOTS * max(-(-(r.prompt_len + r.out_len + 1)
                                                   // BLOCK_LEN) for r in trace))
                     if paged else dict(prompt_cap=max(r.prompt_len for r in trace),
                                        max_out=max(r.out_len for r in trace)))
            kw.update(shape)
            made = []  # the eager server, made inside the count (its B3 counted)
            eager, _, e_counts = timed(lambda: made.append(eager_server())
                                       or made[0].serve(trace, **kw))
            eager_srv = made.pop()
            steady, _, s_counts = timed(lambda: cap.serve(trace, **kw))
            keys = len(cap.programs.keys())
            built, captures = cap.serve_traces, cap.programs.captures
            other = cap.serve(trace2, **kw)
            e_wall, s_wall, o_wall = eager.wall_s, steady.wall_s, other.wall_s
            print(f"[programs] {tag} serve, [serve]'s trace ({card}): eager wall "
                  f"{e_wall:.3f} s; captured: first run ([{phase}]) {first.wall_s:.3f} s "
                  f"({after_first}), steady {s_wall:.3f} s ({progs(cap)}; {keys} keys), "
                  f"another prompt mix {o_wall:.3f} s ({cap.serve_traces - built} builds, "
                  f"{cap.programs.captures - captures} captures added); eager "
                  f"{e_wall / s_wall:.2f}x the steady wall")
            print(f"[programs] {tag}: decode ok / erased rounds: eager "
                  f"{eager.decode_ok}/{eager.decode_rounds}, {eager.erased_rounds}; captured "
                  f"first {first.decode_ok}, {first.erased_rounds}; steady "
                  f"{steady.decode_ok}, {steady.erased_rounds}; streams equal eager's: first "
                  f"{first.streams == eager.streams}, steady "
                  f"{steady.streams == eager.streams}; another mix {len(other.streams)} "
                  f"streams, {other.tokens} tokens; serve_traces eager "
                  f"{eager_srv.serve_traces}, captured {cap.serve_traces}")
            print(f"[programs] {tag} launches (B1, B2, B3): eager "
                  f"{[e_counts[k] for k in b123]}, captured first "
                  f"{[c_counts[k] for k in b123]}, steady {[s_counts[k] for k in b123]}")
            for rep in (first, steady):
                check(rep.streams == eager.streams, f"{tag}: captured streams differ")
                check((rep.decode_ok, rep.erased_rounds)
                      == (eager.decode_ok, eager.erased_rounds),
                      f"{tag}: captured decode ok or erased rounds differ")
            check(other.tokens == sum(r.out_len for r in trace2) and other.shed == 0,
                  f"{tag}: the second trace served every request")
            check(c_counts == e_counts, f"{tag}: captured launches differ from eager")
            check(all(s_counts[k] == e_counts[k] for k in b123[:2])
                  and s_counts["mds_encode"] == 0,
                  f"{tag}: the steady run's B1, B2 launches differ from eager")
            check(e_counts["coded_matvec"] == eager.decode_rounds
                  and e_counts["paged_decode"] == (cfg.num_layers * eager.decode_rounds
                                                   if paged else 0)
                  and e_counts["mds_encode"] == 1,
                  f"{tag}: B1 == decode steps, B2 == layers x steps (paged), B3 == 1")
            check(cap.serve_traces == built and cap.programs.captures == captures,
                  f"{tag}: another prompt mix built or captured a program")
            check(built == eager_srv.serve_traces, f"{tag}: both modes built the same keys")
            if cuda:
                check(captures == keys,
                      f"{tag}: every key captured once, in the first two runs")
            paths[f"programs_serve_{tag}"] = s_counts
            # the profile replays graphs that [serve] captured, before the
            # profiler sessions of [obs] (those once crashed a replay:
            # PERF.md section 7); [obs]' trace served twice first, so its
            # keys are captured, and the keys it dispatches recorded
            used = set()
            run = cap._run
            cap._run = lambda kind, key, *a: used.add(key) or run(kind, key, *a)
            for _ in range(2):
                cap.serve(short, **kw)
            del cap._run, run  # the wrapper refers to the server
            replayed = sum((*key, False) in old_keys for key in used)
            shares = {"eager": busy_share(tmp, f"programs_{tag}_eager",
                                          lambda: eager_srv.serve(short, **kw)),
                      "captured": busy_share(tmp, f"programs_{tag}_captured",
                                             lambda: cap.serve(short, **kw))}
            print(f"[programs] {tag} busy share ([obs]' trace of {len(short)} request, "
                  f"profiled; {replayed} of its {len(used)} keys captured in [{phase}]; "
                  f"{card}): eager {shares['eager'][0]:.3f} of "
                  f"{shares['eager'][1]:.1f} ms, captured {shares['captured'][0]:.3f} of "
                  f"{shares['captured'][1]:.1f} ms")
            if cuda:
                check(replayed > 0, f"{tag}: the profile replays a graph captured in [{phase}]")
            del served[phase], cap, eager_srv

        prompts = gen_prompts(cfg.vocab_size)

        def gen(server, seed, max_new=GEN_NEW):
            rounds = []
            out = server.generate(prompts, max_new, seed=seed,
                                  observe=lambda step, lg, sel, ok, mask: rounds.append(
                                      (int(ok), int(not bool(mask.all())))))
            return out, sum(r[0] for r in rounds), sum(r[1] for r in rounds)

        servers = {"eager": eager_server(), "captured": Server(model, fleet, conf)}
        runs = {}
        for seed in PROGRAM_GEN_SEEDS:
            runs["eager", seed] = timed(lambda: gen(servers["eager"], seed))
        order = (PROGRAM_GEN_SEEDS[0], *PROGRAM_GEN_SEEDS)
        for i, seed in enumerate(order):
            runs["captured", i] = timed(lambda: gen(servers["captured"], seed))
        cap = servers["captured"]
        for i, seed in enumerate(order):
            (out, ok, erased), _, counts = runs["captured", i]
            (e_out, e_ok, e_erased), _, e_counts = runs["eager", seed]
            check(torch.equal(out, e_out), f"generate seed {seed}: captured tokens differ")
            check((ok, erased) == (e_ok, e_erased),
                  f"generate seed {seed}: decode ok or erased rounds differ")
            check(counts == e_counts and counts["coded_matvec"] == GEN_NEW,
                  f"generate seed {seed}: launches differ (B1 == {GEN_NEW})")
        check(cap.traces == servers["eager"].traces == 1
              and cap.programs.captures == int(cuda), "generate: one program, captured once")
        walls = [runs["captured", i][1] for i in range(len(order))]
        print(f"[programs] generate ({GEN_BATCH} x {GEN_PROMPT}, {GEN_NEW} new, seeds "
              f"{list(PROGRAM_GEN_SEEDS)}; {card}): eager walls "
              + ", ".join(f"{runs['eager', s][1]:.3f}" for s in PROGRAM_GEN_SEEDS)
              + f" s; captured: built {walls[0]:.3f} s, captured and replayed "
              f"{walls[1]:.3f} s, replays {', '.join(f'{w:.3f}' for w in walls[2:])} s "
              f"({progs(cap)}); traces eager {servers['eager'].traces}, captured "
              f"{cap.traces}; tokens, decode ok and erased rounds equal: " + ", ".join(
                  f"seed {s} ok {runs['eager', s][0][1]}/{GEN_NEW}, erased "
                  f"{runs['eager', s][0][2]}" for s in PROGRAM_GEN_SEEDS)
              + f"; launches {runs['captured', len(order) - 1][2]}")
        shares = {mode: busy_share(tmp, f"programs_generate_{mode}",
                                   lambda: gen(servers[mode], PROGRAM_GEN_SEEDS[0]))
                  for mode in ("eager", "captured")}
        print(f"[programs] generate busy share (one call profiled; {card}): eager "
              f"{shares['eager'][0]:.3f} of {shares['eager'][1]:.1f} ms, captured "
              f"{shares['captured'][0]:.3f} of {shares['captured'][1]:.1f} ms")
        paths["programs_generate"] = runs["captured", len(order) - 1][2]
    return paths


#: [train-adapt]: (a) churn, measured, bucketed; (b) a static fleet padded
#: from fed round 4 by TA_PAD x unit_s x the deadline on the fast group.
#: The membership replans of (a) and the pad of (b) are fixed by
#: tests/test_torch_train_adapt.py
TA_STEPS, TA_EVERY, TA_QUANTUM = 12, 2, 4
TA_MEMBERSHIP = [(4, 9), (9, 12)]  # (step, workers after)
TA_PAD_STEPS, TA_PAD_AT, TA_PAD = 10, 4, 0.5


def train_adapt_phase(cfg, device: str = "cuda") -> dict:
    """Training's adaptive path at full width, measured by a ``RoundClock``:
    (a) ``churn`` with buckets, (b) a static fleet with a really slept pad
    on the fast group. Counters reset before each run and read after.
    Returns the counts by path."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    shape = ShapeConfig("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    print(f"[train-adapt] {cfg.name}: batch {TRAIN_BATCH} x {TRAIN_SEQ}, grad_coding k "
          f"{PARTITIONS}, fleet {CLUSTER}, every {TA_EVERY}, measured (init "
          f"{time.perf_counter() - t0:.1f} s)")

    def trainer(steps, **kw):
        return Trainer(model, SyntheticLMData(cfg, shape, seed=0, device=device),
                       AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps),
                       TrainConfig(steps=steps, log_every=1, cluster=ClusterSpec.make(*CLUSTER),
                                   scheme="grad_coding", partitions=PARTITIONS,
                                   deadline_safety=3.0, adapt_every=TA_EVERY,
                                   measure_times=True, **kw))

    def instrument(t, after=None):
        """Log each round's timing, the smoothed round after it, and the
        decision it fed."""
        log = []
        inner = t.controller.observe_timing

        def observe(timing):
            d = inner(timing)
            exe = t.executor
            rep = d is not None and d.replanned
            log.append(dict(step=timing.round - 1, dispatch_s=timing.dispatch_s,
                            pad_s=timing.pad_wall_s, skipped=timing.skipped,
                            smoothed_s=t.clock.smoothed_s, decision=d,
                            structural=rep and exe.last_replan_structural,
                            hit=rep and exe.last_bucket_hit, workers=exe.num_workers,
                            n=exe.n))
            if after is not None:
                after(t)
            return d

        t.controller.observe_timing = observe
        return log

    def report(name, t, log, hist, counts):
        for e in log:
            d = e["decision"]
            line = (f"[train-adapt] {name} step {e['step']}: dispatch {e['dispatch_s']:.4f} s"
                    + (f" + pad {e['pad_s']:.4f} s" if e["pad_s"] else "")
                    + (f" (not fed: {e['skipped']})" if e["skipped"] else ""))
            if d is not None:
                line += f"; decision {d.reason}, gain {d.gain:.4f}"
                if d.replanned:
                    line += (f"; replanned: {'bucket hit' if e['hit'] else 'bucket miss'}"
                             f"{'' if t.executor.buckets is not None else ' (no buckets)'}, "
                             f"structural {e['structural']}, workers {e['workers']}, n {e['n']}")
            print(line)
        for i, e in enumerate(log[:-1]):
            if e["decision"] is not None and e["decision"].replanned:
                nxt = log[i + 1]
                print(f"[train-adapt] {name}: the round after the replan at step {e['step']} "
                      f"took {nxt['dispatch_s']:.4f} s against a smoothed round of "
                      f"{e['smoothed_s']:.4f} s ({nxt['dispatch_s'] / e['smoothed_s']:.3f}x; "
                      f"{'not fed' if nxt['skipped'] else 'fed'})")
        skipped = int(sum(h["skipped"] for h in hist))
        print(f"[train-adapt] {name}: clock {t.clock.fed}/{t.clock.rounds} rounds fed, unit_s "
              f"{t.clock.unit_s:.4e}, step builds {t.step_builds}, skipped steps {skipped}, "
              f"step walls {min(t.step_seconds):.3f}-{max(t.step_seconds):.3f} s; "
              f"launches {counts}")
        check(counts["fused_ce_fwd"] == len(hist), f"{name}: fused_ce_fwd == steps")
        for k in ("fused_ce_bwd_dh", "fused_ce_bwd_de"):
            check(counts[k] == len(hist) - skipped, f"{name}: {k} == steps not skipped")
        check(all(math.isfinite(h["loss"]) for h in hist), f"{name}: finite losses")

    # (a) churn, measured, bucketed
    t = trainer(TA_STEPS, scenario="churn", bucket_quantum=TA_QUANTUM)
    log = instrument(t)
    kernels.reset_launch_counts()
    _, _, hist = t.run()
    counts_a = kernels.launch_counts()
    report("churn", t, log, hist, counts_a)
    replans = [e for e in log if e["decision"] is not None and e["decision"].replanned]
    structural = sum(bool(e["structural"]) for e in replans)
    membership = [(e["step"], e["workers"]) for e in replans
                  if e["decision"].reason == "membership"]
    print(f"[train-adapt] churn: membership replans (step, workers) {membership}; "
          f"{len(replans)} replans, {structural} structural, "
          f"{sum(bool(e['hit']) for e in replans)} bucket hits")
    check(membership == TA_MEMBERSHIP, f"churn: membership replans at {TA_MEMBERSHIP}")
    check(t.clock.rounds == TA_STEPS and t.clock.fed == TA_STEPS - 1 - structural,
          "churn: every step timed, all but warmup and rebuilds fed")
    check(t.step_builds == 1 + structural, "churn: one step build per structural replan")
    del t

    # (b) a static fleet, the fast group padded by a slept pad from fed round 4
    t = trainer(TA_PAD_STEPS)
    old = [float(x) for x in t.executor.plan.allocation.loads]

    def pad_fast_group(tr):
        if tr.clock.fed == TA_PAD_AT and tr.clock.pad_s is None:
            pad = [0.0] * tr.executor.num_workers
            pad[: CLUSTER[0][0]] = [TA_PAD * tr.clock.unit_s * float(tr.executor.deadline)] \
                * CLUSTER[0][0]
            tr.clock.pad_s = pad
            print(f"[train-adapt] pad: {pad[0]:.4f} s on the fast group's "
                  f"{CLUSTER[0][0]} workers from fed round {TA_PAD_AT + 1} ({TA_PAD} x "
                  f"unit_s {tr.clock.unit_s:.4e} x deadline {tr.executor.deadline:.6f})")

    log = instrument(t, pad_fast_group)
    kernels.reset_launch_counts()
    _, _, hist = t.run()
    counts_b = kernels.launch_counts()
    report("pad", t, log, hist, counts_b)
    decisions = [e["decision"] for e in log if e["decision"] is not None]
    first = next((d.round for d in decisions if d.replanned), None)
    new = [float(x) for x in t.executor.plan.allocation.loads]
    print(f"[train-adapt] pad: first replan at fed round {first} (the pad from fed round "
          f"{TA_PAD_AT + 1}, cadence {TA_EVERY}); loads per group {old} -> {new}")
    check(first is not None and TA_PAD_AT < first <= TA_PAD_AT + 2 * TA_EVERY,
          "pad: a replan within two cadences of the pad")
    check(new[0] < old[0], "pad: the padded group gets fewer rows")
    del t, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"train_adapt_churn": counts_a, "train_adapt_pad": counts_b}


def cli_phase(runs: list[tuple[list[str], list[str], bool]]) -> None:
    """The CLIs as a user runs them, each run ``(argv, expect, ok)`` (``argv``
    after ``python -m``) in a process of its own, all started together
    (most of a run is the process's start): with ``ok``, exit 0 and a
    stdout line starting with each of ``expect``; else a non-zero exit
    whose stderr holds each of ``expect``."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t = time.perf_counter()
    procs = []
    for argv, expect, ok in runs:
        cmd = [sys.executable, "-m", *argv]
        procs.append((cmd, expect, ok, subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                                        stdout=subprocess.PIPE,
                                                        stderr=subprocess.PIPE)))
    for cmd, expect, ok, proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for *_, p in procs:
                p.kill()
            raise
        lines = out.strip().splitlines()
        print(f"[cli] {' '.join(cmd[2:])}: exit {proc.returncode}, done "
              f"{time.perf_counter() - t:.1f} s after the {len(runs)} runs started")
        for line in lines:
            print(f"[cli]   {line}")
        if not ok:
            print(f"[cli]   stderr, last line: {(err.strip().splitlines() or [''])[-1]}")
            check(proc.returncode != 0, f"{' '.join(cmd[2:5])} must exit non-zero")
            for text in expect:
                check(text in err, f"the CLI's stderr holds {text!r}")
            continue
        if proc.returncode != 0:
            print(err[-4000:], file=sys.stderr)
        check(proc.returncode == 0, f"{' '.join(cmd[2:5])} exits 0")
        for head in expect:
            check(any(line.startswith(head) for line in lines), f"the CLI prints {head!r}")


def obsreport_cli(jsonl: str) -> None:
    """``python -m repro_torch.launch.obsreport JSONL --require-spans`` as a
    user runs it on a served run's telemetry: exit 0 and its span count."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.obsreport", jsonl, "--require-spans"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, text=True, capture_output=True,
                          timeout=120)
    lines = proc.stdout.strip().splitlines()
    print(f"[cli] repro_torch.launch.obsreport --require-spans: exit {proc.returncode}, "
          f"{len(lines)} lines of report; last: {lines[-1] if lines else ''}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, "the ops report CLI exits 0")
    check(any(line.startswith("span coverage:") for line in lines),
          "the ops report CLI prints its span coverage")


#: [families]: each config, the depth kept (None: the config's own) and its
#: serving paths ("image": the vlm's image prefix through ``lm_logits``;
#: "generate": [generate]'s prompts through the sequential prefill, "int8"
#: also with an int8 KV cache). moonshot-v1-16b-a3b's 48 layers are 27.7 B
#: parameters, 111 GB in float32, past the card's 80 GB. The run's time
#: budget (the serves and generates are host-paced, layer by layer) keeps
#: 20 of granite-3-2b's 40 layers, 24 of yi-9b's 48, 12 of moonshot's, 8 of
#: h2o-danube-3-4b's 24 and 13 of zamba2-1.2b's 38 (the shared block at 0,
#: 6 and 12); paligemma-3b, whisper-tiny and xlstm-125m keep theirs.
FAMILY_RUNS = (("granite-3-2b", 20, ("paged",)),
               ("yi-9b", 24, ("paged", "dense")),
               ("moonshot-v1-16b-a3b", 12, ("paged",)),
               ("h2o-danube-3-4b", 8, ("generate", "int8")),
               ("paligemma-3b", None, ("paged", "image")),
               ("whisper-tiny", None, ("generate",)),
               ("zamba2-1.2b", 13, ("generate",)),
               ("xlstm-125m", None, ("generate",)))
#: the reduced h2o-danube-3-4b generates past its 64-token window
WRAP_PROMPT, WRAP_NEW = 70, 8
#: the reduced vlm, audio, hybrid and ssm configs held card against CPU:
#: lm_logits over REDUCED_SEQ tokens (a multiple of the reduced mamba
#: chunk, 16), then a generate of REDUCED_PROMPT + REDUCED_NEW positions;
#: the xLSTM at slstm_every 2 (its reduced four layers hold no sLSTM at 6).
#: [families] holds BF16_REDUCED_RUNS card against CPU alike: qwen3-0.6b and moonshot
#: with bf16 parameters (float32 compute; [train-families] does not train
#: them)
REDUCED_RUNS = (("paligemma-3b", {}), ("whisper-tiny", {}), ("zamba2-1.2b", {}),
                ("xlstm-125m", {"slstm_every": 2}))
BF16_REDUCED_RUNS = (("qwen3-0.6b", {"param_dtype": "bfloat16"}),
                     ("moonshot-v1-16b-a3b", {"param_dtype": "bfloat16"}))
REDUCED_SEQ, REDUCED_PROMPT, REDUCED_NEW = 32, 24, 8


def family_kernels(tag: str, nb: int, kb: int, d: int, attn) -> dict:
    """B1 and B3 at one config's coded head, (nb, kb) x (kb, S R) and (nb,
    kb) x (kb, R D), and B2 at its serve shape (``attn`` = (KV, G, hd); None
    for a config that is not served paged), each held against its plain
    version and timed beside its library call. Returns the rows with their
    shapes."""
    import torch

    from repro_torch.core.coding import make_generator
    from repro_torch.kernels.coded_matvec import ops as cmv
    from repro_torch.kernels.mds_encode import ops as mds

    gen = torch.Generator(device="cuda").manual_seed(2)
    g = make_generator(nb, kb, device="cuda")
    rows = {}
    x = torch.randn((kb, SLOTS * 256), generator=gen, device="cuda")
    err = max_err(cmv.blocked_matvec(g, x), cmv.blocked_matvec_plain(g, x))
    tol = gemm_tolerance(g, x)
    print(f"[{tag}] coded_matvec ({nb},{kb})x({kb},{x.shape[1]}): max_abs_err {err:.3e} "
          f"<= tol {tol:.3e} (2 K u max|G||X|)")
    check(err <= tol, f"{tag}: coded_matvec disagrees with its plain version")
    rows["coded_matvec"] = dict(shape=[[nb, kb], [kb, x.shape[1]]], **matvec_row(g, x, err))
    del x
    a = torch.randn((kb, 256 * d), generator=gen, device="cuda").mul_(0.02)
    err = max_err(mds.mds_encode(g, a), mds.mds_encode_plain(g, a))
    tol = gemm_tolerance(g, a)
    print(f"[{tag}] mds_encode ({nb},{kb})x({kb},{a.shape[1]}): max_abs_err {err:.3e} "
          f"<= tol {tol:.3e} (2 K u max|G||A|)")
    check(err <= tol, f"{tag}: mds_encode disagrees with its plain version")
    rows["mds_encode"] = dict(shape=[[nb, kb], [kb, a.shape[1]]], **encode_row(g, a, err))
    del a
    torch.cuda.empty_cache()
    if attn is not None:
        kv, grp, hd = attn
        q, k_pool, v_pool = paged_inputs(gen, kv, grp, hd)
        table, pos = paged_table(gen)
        _, err = paged_hold(tag, q, k_pool, v_pool, table, pos)
        rows["paged_decode"] = dict(shape=[SLOTS, kv, grp, hd, PAGED_TABLE],
                                    **paged_row(q, k_pool, v_pool, table, pos, err))
        del q, k_pool, v_pool
    for name, r in rows.items():
        print(f"[{tag}] {name} {r['shape']}: device {fmt_ms(r.get('device_ms'))}, "
              f"host-paced {r['ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; library "
              f"{fmt_ms(r.get('library_device_ms'))} device, {r['library_ms']:.4f} ms "
              f"host-paced; bound {r['bound'][0]:.6f} ms ({r['bound'][1]})")
    return rows


def family_extras(model, batch: int, seed: int = 5):
    """Seeded random extras on the model's device: a vlm's image embeddings
    {"image_embeds"}, an audio model's encoder output {"enc_out"} of
    random frames (``Model.encode``); None for the other families."""
    import torch

    c = model.config
    length = {"vlm": c.num_image_tokens, "audio": c.encoder_seq}.get(c.family)
    if length is None:
        return None
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, length, c.d_model), generator=gen).to(model.device, c.cdtype)
    if c.family == "vlm":
        return {"image_embeds": x}
    with torch.no_grad():
        return {"enc_out": model.encode(x)}


def family_generate(model, tag: str, card: str, quants=(False,)):
    """``Server.generate`` of [generate]'s prompts (GEN_BATCH x GEN_PROMPT,
    GEN_NEW new) with the coded head through the sequential prefill (an
    audio model from its encoder output, ``family_extras``), with the
    model's cache and, where ``quants`` holds True, the int8 one: each
    coded run held against its uncoded run (tokens as [generate]; each
    decoded round's logits within cond(G_S) 2^-22 max|logits| of the
    uncoded ones); an int8 run's tokens reported against the plain ones.
    Returns the plain coded run's launch counts and (wall, tokens/s,
    decode ok)."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.runtime.serve_loop import ServeConfig, Server

    v = model.config.vocab_size
    prompts = gen_prompts(v)
    extras = family_extras(model, GEN_BATCH)
    outs, result = {}, None
    for quant in quants:
        m = with_config(model, kv_quant=True) if quant else model
        label = "int8 KV" if quant else f"{str(model.config.cdtype)[6:]} compute"
        _, plain_new, margins, scales = uncoded_reference(m, prompts, GEN_NEW, extras)
        kernels.reset_launch_counts()
        server = Server(m, ClusterSpec.make(*CLUSTER),
                        ServeConfig(block_rows=256, deadline_safety=SAFETY, scheme="optimal"))
        rounds = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = server.generate(prompts, GEN_NEW, seed=1, extras=extras,
                              observe=lambda step, lg, sel, ok, mask:
                              rounds.append((lg, sel, ok, mask)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = kernels.launch_counts()
        head = server.coded_head
        conds = [round_cond(head, ok, mask) for _, _, ok, mask in rounds]
        worst = 0.0
        for (lg, sel, ok, _), cond in zip(rounds, conds):
            if bool(ok):
                want = lg[:, :v].float()
                err = max_err(sel[:, :v].float(), want)
                worst = max(worst, err / (cond * 2.0**-22 * float(want.abs().max())))
        equal, covered = held_tokens(f"{tag} {label}", out[:, GEN_PROMPT:].cpu(), plain_new,
                                     margins, scales, conds)
        ok_n = sum(int(ok) for _, _, ok, _ in rounds)
        print(f"[{tag}] {label}: generate {GEN_BATCH} x {GEN_PROMPT} + {GEN_NEW} (sequential "
              f"prefill): wall {wall:.3f} s, {GEN_BATCH * GEN_NEW / wall:.1f} tokens/s "
              f"({card}); decode ok {ok_n}/{GEN_NEW}; decoded rounds within "
              f"{worst:.3f} x cond(G_S) 2^-22 max|logits| of the uncoded logits; "
              f"{equal}/{GEN_BATCH * GEN_NEW} tokens equal the uncoded run's before any "
              f"difference, {covered} checked; launches {counts}")
        check(tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + GEN_NEW), f"{tag}: output shape")
        check(int(out.max()) < v and int(out.min()) >= 0, f"{tag}: tokens < vocab_size")
        check(worst <= 1.0, f"{tag} {label}: decoded logits disagree with the uncoded ones")
        check(counts["coded_matvec"] == GEN_NEW and counts["mds_encode"] == 1
              and counts["paged_decode"] == 0, f"{tag} {label}: launches")
        outs[quant] = out[:, GEN_PROMPT:].cpu()
        if not quant:
            result = counts, (wall, GEN_BATCH * GEN_NEW / wall, f"{ok_n}/{GEN_NEW}")
        del server, head, rounds, m
    if True in outs:
        same = int((outs[True] == outs[False]).sum())
        print(f"[{tag}] int8 KV against bf16 KV: {same}/{outs[True].numel()} generated "
              f"tokens equal (reported, not required)")
    return result


def family_wrap(card: str) -> None:
    """The rolling cache past its wrap: the reduced h2o-danube-3-4b (window
    64, float32) generates WRAP_NEW tokens after WRAP_PROMPT-token prompts on
    the card and on the CPU, the same weights in both; every step's logits
    within the decode tolerance (2e-4 + 2e-4 |want|) and the tokens equal.
    The int8 cache's run is reported alike, not required."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import Server

    cfg = get_arch("h2o-danube-3-4b").reduced()
    cpu = Model(cfg, device="cpu", seed=0)
    card_model = Model(cfg, device="cuda", seed=0)
    card_model.load_state_dict(cpu.state_dict())
    prompts = torch.randint(0, cfg.vocab_size, (GEN_BATCH, WRAP_PROMPT), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(4))
    check(cpu.init_cache(1, WRAP_PROMPT + WRAP_NEW)["k"].shape[2] == cfg.sliding_window
          < WRAP_PROMPT + WRAP_NEW, "the reduced danube's cache rolls")
    for quant in (False, True):
        runs = []
        for m in (card_model, cpu):
            view = with_config(m, kv_quant=True) if quant else m
            logits = []
            out = Server(view).generate(prompts, WRAP_NEW, observe=lambda step, lg, *_:
                                        logits.append(lg.float().cpu()))
            runs.append((out.cpu(), torch.stack(logits)))
        (out, got), (want_out, want) = runs
        diff = (got - want).abs()
        worst = float((diff / (2e-4 + 2e-4 * want.abs())).max())
        same = int((out == want_out).sum())
        label = "int8 KV" if quant else "float32 KV"
        print(f"[families] reduced h2o-danube-3-4b, {label}, window {cfg.sliding_window}: "
              f"{WRAP_PROMPT} + {WRAP_NEW} positions, card against CPU: max_abs_err "
              f"{float(diff.max()):.3e}, max |d| / (2e-4 + 2e-4 |want|) {worst:.3f}; "
              f"{same}/{out.numel()} tokens equal ({card})")
        if not quant:
            check(worst <= 1.0 and torch.equal(out, want_out),
                  "the rolling cache on the card disagrees with the CPU run")


def family_image(model, tag: str) -> None:
    """The reference's ``test_vlm_image_prefix_changes_logits`` at full width:
    ``lm_logits`` of seeded tokens with seeded random image embeddings
    (GEN_BATCH, num_image_tokens, D) against zero embeddings: finite, and
    the text logits differ."""
    import torch

    c = model.config
    toks = torch.randint(0, c.vocab_size, (GEN_BATCH, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(6)).to(model.device)
    img = family_extras(model, GEN_BATCH)
    with torch.no_grad():
        l1 = model.lm_logits(toks, img)[..., : c.vocab_size]
        l0 = model.lm_logits(toks, {"image_embeds": torch.zeros_like(img["image_embeds"])})
        l0 = l0[..., : c.vocab_size]
    diff = float((l1 - l0).abs().max())
    print(f"[{tag}] lm_logits {tuple(l1.shape)} with random image embeddings "
          f"{tuple(img['image_embeds'].shape)} against zero ones: max |d| {diff:.3e} "
          f"(max |logits| {float(l1.abs().max()):.3e})")
    check(bool(torch.isfinite(l1).all() and torch.isfinite(l0).all()),
          f"{tag}: image-prefix logits not finite")
    check(diff > 0, f"{tag}: the image prefix does not change the logits")


def family_reduced(card: str) -> None:
    """Each reduced config of REDUCED_RUNS and BF16_REDUCED_RUNS (float32
    compute; the vlm, audio, hybrid and ssm ones, then the bf16-parameter
    pair) with the same
    weights on the card and on the CPU: ``lm_logits`` of
    REDUCED_SEQ tokens (with seeded extras) within 2e-4 + 2e-4 |want|, and
    a ``generate`` of REDUCED_PROMPT + REDUCED_NEW positions with equal
    tokens. The only place the scans of ``models/ssm.py`` (chunked) and
    ``models/xlstm.py`` (sLSTM included) run on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import Server

    for name, changes in REDUCED_RUNS + BF16_REDUCED_RUNS:
        cfg = dataclasses.replace(get_arch(name).reduced(), **changes)
        cpu = Model(cfg, device="cpu", seed=0)
        card_model = Model(cfg, device="cuda", seed=0)
        card_model.load_state_dict(cpu.state_dict())
        gen = torch.Generator().manual_seed(7)
        toks = torch.randint(0, cfg.vocab_size, (GEN_BATCH, REDUCED_SEQ), dtype=torch.int32,
                             generator=gen)
        prompts = toks[:, :REDUCED_PROMPT]
        frames = torch.randn((GEN_BATCH, cfg.encoder_seq or cfg.num_image_tokens,
                              cfg.d_model), generator=gen)
        runs = []
        for m in (card_model, cpu):
            key = {"vlm": "image_embeds", "audio": "frames"}.get(cfg.family)
            extras = None if key is None else {key: frames.to(m.device)}
            with torch.no_grad():
                logits = m.lm_logits(toks.to(m.device), extras).float().cpu()
                gen_extras = ({"enc_out": m.encode(extras["frames"])}
                              if cfg.family == "audio" else None)
            out = Server(m).generate(prompts, REDUCED_NEW, extras=gen_extras)
            runs.append((logits, out.cpu()))
        (got, out), (want, want_out) = runs
        diff = (got - want).abs()
        worst = float((diff / (2e-4 + 2e-4 * want.abs())).max())
        same = int((out == want_out).sum())
        note = f", {changes}" if changes else ""
        print(f"[families] reduced {cfg.name} ({cfg.family}{note}): lm_logits "
              f"{tuple(got.shape)} card against CPU: max_abs_err {float(diff.max()):.3e}, "
              f"max |d| / (2e-4 + 2e-4 |want|) {worst:.3f}; generate "
              f"{REDUCED_PROMPT} + {REDUCED_NEW}: {same}/{out.numel()} tokens equal ({card})")
        check(worst <= 1.0, f"reduced {name}: lm_logits on the card disagree with the CPU")
        check(torch.equal(out, want_out), f"reduced {name}: generated tokens differ")
        del cpu, card_model


def families_phase(card: str):
    """[families]: per config of FAMILY_RUNS, B1-B3 at its shapes, then the
    model (its own seeded init) through its paths with the coded head,
    counters reset before each and read after; each model freed before the
    next is built. Then the reduced danube's rolling cache and the reduced
    vlm, audio, hybrid and ssm configs, card against CPU. Returns the
    paths' launch counts and the kernel rows by config."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.planner import deploy
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.core.schemes import make_scheme
    from repro_torch.models.model import padded_vocab

    paths, rows = {}, {}
    for name, depth, runs in FAMILY_RUNS:
        cfg = get_arch(name)
        tag = f"families {name}"
        if depth is not None:
            print(f"[{tag}] depth cut {cfg.num_layers} -> {depth} layers (full width)")
            cfg = dataclasses.replace(cfg, num_layers=depth)
        kb = -(-padded_vocab(cfg.vocab_size) // 256)
        nb = deploy(make_scheme("optimal"), ClusterSpec.make(*CLUSTER), kb).n
        attn = None
        if "paged" in runs:
            attn = (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim)
        rows[name] = r = family_kernels(tag, nb, kb, cfg.d_model, attn)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = make_model(cfg, tag=tag)
        n_params = model.param_count()
        if "paged" in runs:
            counts, rep = serve_phase(model, tag)
            summary = (rep.wall_s, rep.tokens_per_s, f"{rep.decode_ok}/{rep.decode_rounds}")
            paths[f"families_{name}"] = counts
        if "dense" in runs:
            paths[f"families_{name}_dense"], _ = serve_dense_phase(model, rep, f"{tag} dense")
        if "image" in runs:
            family_image(model, tag)
        if "generate" in runs:
            counts, summary = family_generate(model, tag, card,
                                              (False, True) if "int8" in runs else (False,))
            paths[f"families_{name}"] = counts
        peak = torch.cuda.max_memory_allocated()
        del model
        gc.collect()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated()
        times = "; ".join(
            f"{k} device {fmt_ms(x.get('device_ms'))} ({fmt_ms(x.get('library_device_ms'))} "
            f"library), host-paced {x['ms']:.4f} ms ({x['library_ms']:.4f} library)"
            for k, x in r.items())
        print(f"[{tag}] {n_params / 1e9:.2f} B params, {cfg.num_layers} layers; peak "
              f"{peak / 2**30:.1f} GiB allocated; launches {paths[f'families_{name}']}; "
              f"{times}; wall {summary[0]:.3f} s, {summary[1]:.2f} tokens/s, decode ok "
              f"{summary[2]}; {card}")
        check(after <= before + (64 << 20), f"{tag}: the model's memory was not freed "
                                            f"({before} -> {after} bytes)")
    family_wrap(card)
    family_reduced(card)
    return paths, rows


#: [moonshot-bf16]: the config served at full depth in bf16 parameters
#: (27.7 B parameters: 111 GB in float32, 55.46 GB in bf16), and the bounds
#: on what it allocates: the init at most the memory before it + the
#: parameters + its largest float32 draw (the embedding) + 1 GiB, the
#: serve's peak under 62 GiB
BF16_ARCH, BF16_INIT_SLACK, BF16_SERVE_PEAK = "moonshot-v1-16b-a3b", 1 << 30, 62 << 30
#: the profiled copy's device ops by a piece of their names (the rest:
#: elementwise and other ops)
BF16_GROUPS = (("copies and casts", ("copy",)), ("GEMMs", ("gemm", "Gemm", "nvjet", "xmma")),
               ("index and scatter", ("index", "scatter", "gather")),
               ("LU", ("getrf", "getrs", "trsm", "lu_")))


def recording_server(model, cluster, conf):
    """A coded server that runs its program functions uncaptured
    (``Server._capture = False``, so Python runs every dispatch) and
    records each coded round in ``server.rounds``: the logits the round
    was given (cloned: the serve state reuses them), the decoded logits,
    ok and the (W,) finish mask."""
    from repro_torch.runtime.serve_loop import Server

    class Recording(Server):
        def coded_select(self, logits, generator, deadline=None):
            sel, ok, mask = super().coded_select(logits, generator, deadline)
            self.rounds.append((logits.float().clone(), sel, ok, mask))
            return sel, ok, mask

    server = Recording(model, cluster, conf)
    server._capture = False
    server.rounds = []
    return server


def bf16_rounds(tag: str, server, vocab: int) -> tuple[int, int, float]:
    """Every recorded coded round: the decoded logits within cond(G_S)
    2^-22 max|logits| of the plain ones (a failed round returns them), and
    each slot's coded token (argmax) equal to the plain one wherever the
    plain top-2 margin exceeds twice that. Returns (tokens equal, of them
    with a clear margin, the worst error over its tolerance)."""
    import torch

    head = server.coded_head
    equal = covered = 0
    worst = 0.0
    for lg, sel, ok, mask in server.rounds:
        want, got = lg[:, :vocab], sel[:, :vocab].float()
        tol = round_cond(head, ok, mask) * 2.0**-22 * float(want.abs().max())
        err = max_err(got, want)
        check(err <= tol, f"{tag}: a round's decoded logits disagree with the uncoded ones "
                          f"({err:.3e} > {tol:.3e})")
        worst = max(worst, err / tol if tol > 0 else 0.0)
        top = want.topk(2, dim=1).values
        clear = (top[:, 0] - top[:, 1]) > 2 * tol
        same = got.argmax(1) == want.argmax(1)
        check(bool((same | ~clear).all()), f"{tag}: a coded token differs from the uncoded "
                                           f"one with a clear margin")
        equal += int(same.sum())
        covered += int((same & clear).sum())
    return equal, covered, worst


def bf16_profile(tag: str, server) -> None:
    """One profiled replayed one-request serve (``obs_trace``: two
    dispatches, a prefill chunk and a decode chunk) on ``server``, served
    twice unprofiled first (built, then captured): its wall, device-op
    time and busy share, the device time by group (BF16_GROUPS, B1-B3)
    and the top ten ops. Its stream against the unprofiled ones is
    reported, not held: ``moe_ffn``'s ``index_add_`` combine adds a
    token's experts in no fixed order on the card (ROADMAP C), and in bf16
    that moves a sum by an ulp, which 48 layers can carry to a token."""
    import tempfile

    from repro_torch.obs import profile

    trace = obs_trace(server.model.config)
    kw = dict(slots=SLOTS, block_len=BLOCK_LEN, prefill_chunk=CHUNK,
              decode_block=DECODE_BLOCK, seed=0)
    first = [server.serve(trace, **kw) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        with profile.capture(tmp, "moonshot_bf16"):
            rep = server.serve(trace, **kw)
        s = profile.summarize(tmp, ["moonshot_bf16"], top_k=10, events=True)["moonshot_bf16"]
    same = [rep.streams == f.streams for f in first]
    wall, dev = s["wall_us"] / 1e3, s["op_total_us"] / 1e3
    groups = {g: [0, 0.0] for g, _ in BF16_GROUPS}
    mine, rest, long_copies = {}, [0, 0.0], [0, 0.0]
    for e in s.pop("events"):
        k = repo_kernel(e)
        g = next((g for g, parts in BF16_GROUPS if any(x in e["name"] for x in parts)), None)
        slot = (mine.setdefault(k, [0, 0.0]) if k is not None
                else groups[g] if g is not None else rest)
        slot[0] += 1
        slot[1] += e["dur"] / 1e3
        if g == BF16_GROUPS[0][0] and e["dur"] >= 100:
            long_copies[0] += 1
            long_copies[1] += e["dur"] / 1e3
    print(f"[{tag}] profiled replay of a {len(trace)}-request serve ({rep.decode_rounds} "
          f"decode steps, {rep.prefill_rounds} prefill round; {server.programs.replays} "
          f"replays in all; its stream equal to the two unprofiled runs': {same}, "
          f"reported: the MoE's combine adds in no fixed order): wall {wall:.1f} ms, "
          f"device ops {dev:.1f} ms ({dev / wall:.3f} "
          f"of the wall), {s['n_ops']} device ops; by group: " + ", ".join(
              f"{g} {ms:.2f} ms (x{n})" for g, (n, ms) in
              [*groups.items(), *mine.items(), ("other", rest)])
          + f"; of the copies and casts, {long_copies[0]} took >= 0.1 ms each, "
            f"{long_copies[1]:.2f} ms together")
    for o in s["ops"]:
        print(f"[{tag}]   {o['total_us'] / 1e3:9.3f} ms x{o['count']:<6d} {o['name'][:100]}")


def moe_repeats(tag: str, model, calls: int = 8) -> None:
    """Layer 0's FFN (``moe_ffn``) on one seeded (SLOTS, CHUNK) input in the
    compute dtype (a prefill round's rows), ``calls`` times: how many
    results differ from the first, bit for bit (reported: the combine's
    ``index_add_`` adds a token's experts in no fixed order on the card)."""
    import torch

    c = model.config
    gen = torch.Generator(device=model.device).manual_seed(8)
    x = torch.randn((SLOTS, CHUNK, c.d_model), generator=gen, device=model.device)
    x = x.to(c.cdtype)
    p = model._layer(0)
    with torch.no_grad():
        outs = [model._ffn(p, x) for _ in range(calls)]
    differ = sum(not torch.equal(o, outs[0]) for o in outs[1:])
    worst = max(max_err(o.float(), outs[0].float()) for o in outs[1:])
    print(f"[{tag}] moe_ffn of layer 0 on one {str(c.cdtype)[6:]} input ({SLOTS} x {CHUNK} "
          f"rows), {calls} calls: {differ}/{calls - 1} differ from the first bit for bit, "
          f"max |d| {worst:.3e} (max |out| {float(outs[0].abs().max()):.3e}; reported)")


def moonshot_bf16_phase(card: str) -> dict:
    """[moonshot-bf16]: BF16_ARCH at full depth and width with bf16
    parameters and bf16 compute, built with nothing large resident (the
    allocator checked first), then served through the default captured
    programs: the serve phase's trace paged with the ``optimal`` coded
    head on CLUSTER (``serve_phase``: its launch and coded-round checks),
    B3 once; the init's and the serve's peaks held to BF16_INIT_SLACK and
    BF16_SERVE_PEAK; the trace served again, all replays (the steady
    wall); one replayed dispatch profiled (``bf16_profile``); layer 0's
    FFN called repeatedly on one input (``moe_repeats``); the same
    trace again through an uncaptured recording server, every
    coded round and token held (``bf16_rounds``); the model's memory
    freed after. Returns the main serve's launch counts."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import ServeConfig

    tag = "moonshot-bf16"
    cfg = dataclasses.replace(get_arch(BF16_ARCH), param_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    print(f"[{tag}] allocated before the build: {before / 2**20:.1f} MiB")
    check(before <= 2 << 30, f"{tag}: nothing large resident before the build")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated()
    n_params = model.param_count()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    draw = model.embed.numel() * 4  # the largest float32 draw: the embedding
    f32 = sorted(n for n, p in model.named_parameters() if p.dtype == torch.float32)
    bound = before + n_bytes + draw + BF16_INIT_SLACK
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_experts} "
          f"experts top-{cfg.top_k}, {n_params / 1e9:.3f} B parameters in {n_bytes / 1e9:.2f} "
          f"GB (bf16; float32: {f32}), compute {str(cfg.cdtype)[6:]}; init {init_s:.2f} s, "
          f"its peak {init_peak / 1e9:.2f} GB <= {bound / 1e9:.2f} GB (before + parameters + "
          f"the embedding's float32 draw {draw / 1e9:.2f} GB + 1 GiB)")
    check(cfg.num_layers == 48 and f32 == ["w_router"],
          f"{tag}: 48 layers, bf16 leaves but the float32 router")
    check(init_peak <= bound, f"{tag}: the init's peak exceeds its bound")

    torch.cuda.reset_peak_memory_stats()
    kept = {}
    counts, rep = serve_phase(model, tag, keep=kept)
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    server = kept.pop(tag)
    print(f"[{tag}] serve peak {serve_peak / 2**30:.2f} GiB allocated (< "
          f"{BF16_SERVE_PEAK / 2**30:.0f} GiB); captured programs: "
          f"{server.programs.builds.get('serve', 0)} built, {server.programs.captures} "
          f"captured, {server.programs.replays} replays; launches B1 {counts['coded_matvec']}, "
          f"B2 {counts['paged_decode']} ({cfg.num_layers} x {rep.decode_rounds} decode "
          f"steps), B3 {counts['mds_encode']}; {card}")
    check(counts["mds_encode"] == 1, f"{tag}: mds_encode launches == 1")
    check(serve_peak < BF16_SERVE_PEAK, f"{tag}: the serve's peak exceeds 62 GiB")
    steady = server.serve(serve_trace(cfg), slots=SLOTS, block_len=BLOCK_LEN,
                          prefill_chunk=CHUNK, decode_block=DECODE_BLOCK, seed=0)
    print(f"[{tag}] the trace again, every dispatch a replay (steady): wall "
          f"{steady.wall_s:.3f} s, {steady.tokens_per_s:.2f} tokens/s, decode ok "
          f"{steady.decode_ok}/{steady.decode_rounds} (the first run {rep.wall_s:.3f} s, "
          f"{rep.tokens_per_s:.2f} tokens/s); {server.programs.builds.get('serve', 0)} "
          f"built, {server.programs.captures} captured; "
          f"{sum(steady.streams[r] == rep.streams[r] for r in rep.streams)}/"
          f"{len(rep.streams)} streams equal the first run's (reported)")
    check(steady.tokens == rep.tokens and steady.decode_rounds == rep.decode_rounds,
          f"{tag}: the steady run's tokens and decode steps")
    bf16_profile(tag, server)
    moe_repeats(tag, model)
    del server
    gc.collect()
    torch.cuda.empty_cache()

    rec = recording_server(model, ClusterSpec.make(*CLUSTER),
                           ServeConfig(block_rows=256, deadline_safety=SAFETY, scheme="optimal"))
    again = rec.serve(serve_trace(cfg), slots=SLOTS, block_len=BLOCK_LEN, prefill_chunk=CHUNK,
                      decode_block=DECODE_BLOCK, seed=0)
    equal, covered, worst = bf16_rounds(tag, rec, cfg.vocab_size)
    tokens = sum(lg.shape[0] for lg, *_ in rec.rounds)
    same = sum(again.streams[r] == rep.streams[r] for r in rep.streams)
    print(f"[{tag}] uncaptured recording serve: {len(rec.rounds)} coded rounds (decode ok "
          f"{again.decode_ok}/{again.decode_rounds}, erased {again.erased_rounds}), each "
          f"within {worst:.3f} x cond(G_S) 2^-22 max|logits| of its uncoded logits; "
          f"{equal}/{tokens} slot tokens equal the uncoded argmax, {covered} with a clear "
          f"margin; {same}/{len(rep.streams)} streams equal the captured serve's (reported: "
          f"the MoE's index_add_ combine sums in no fixed order)")
    check(len(rec.rounds) == again.decode_rounds == rep.decode_rounds,
          f"{tag}: one recorded coded round a decode step")
    del rec, model, kept
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    print(f"[{tag}] allocated after: {after / 2**20:.1f} MiB")
    check(after <= before + (64 << 20), f"{tag}: the model's memory was not freed "
                                        f"({before} -> {after} bytes)")
    return counts


def profile_step(trainer, opt_state, steady_s: float, top: int = 16, tag: str = "train"):
    """One more steady step (coded: every worker finishing) under
    ``torch.profiler``'s device activity, outside the timed steps: the
    kernels that take the most device time in it, B4's share of the
    device time, and the card's busy share: the summed kernel time over
    ``steady_s`` (the unprofiled steady step's wall) and over the wall
    under the profiler. The kernels are read from the profiler's raw
    events (a step of the xLSTM launches hundreds of thousands). Returns
    the step's optimizer state."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.data.next_batch()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if trainer.executor is None:
            opt_state, _ = trainer.step_fn(opt_state, batch)
        else:
            wmask = torch.ones(trainer.executor.num_workers, dtype=torch.bool,
                               device=trainer.model.device)
            opt_state, _ = trainer.coded_step_fn(opt_state, batch, wmask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    us, count = collections.Counter(), collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            us[ev.name()] += ev.duration_ns() / 1e3
            count[ev.name()] += 1
    total = sum(us.values()) / 1e3
    if total <= 0:
        print(f"[{tag}] profiled step: device time by kernel not measured "
              f"(the profiler recorded no device time)")
        return opt_state
    print(f"[{tag}] profiled step: device time {total:.1f} ms summed over "
          f"{sum(count.values())} device events: the card busy {total / 1e3 / steady_s:.3f} "
          f"of the unprofiled steady step ({steady_s:.3f} s), {total / 1e3 / wall:.3f} of "
          f"the step under the profiler ({wall:.3f} s; stopped and read in "
          f"{time.perf_counter() - t - wall:.1f} s); top {top} by device time:")
    for name, x in us.most_common(top):
        ms = x / 1e3
        print(f"[{tag}]   {ms:9.2f} ms {100 * ms / total:5.1f}%  x{count[name]:<7d} {name[:110]}")

    def b4_ms(test) -> float:
        return sum(x for name, x in us.items() if test(name)) / 1e3

    fwd = b4_ms(lambda k: "FwdEpi" in k or "combine" in k or "fused_ce_fwd" in k)
    b4 = b4_ms(lambda k: "fused_ce" in k or "gemm_kernel" in k)
    print(f"[{tag}] profiled step: fused_ce_fwd (GEMM and combine) {fwd:.1f} ms, "
          f"B4 (forward and backward) {b4:.1f} ms = {100 * b4 / total:.1f}% of "
          f"device time, the rest {total - b4:.1f} ms")
    return opt_state


def run_steps(trainer, tag: str, steps: int, tokens: int) -> tuple[dict, dict, list]:
    """``trainer.run()`` with the launch counters reset just before and read
    just after: each step's line, the throughput, the peak allocated, the
    launches; one finite history record a step, B4's forward once a step
    and each backward once a step not skipped. Returns (counts, opt state,
    history)."""
    import torch

    import repro_torch.kernels as kernels

    exe = trainer.executor
    cuda = trainer.model.device.type == "cuda"
    kernels.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _, opt_state, hist = trainer.run()
    counts = kernels.launch_counts()
    for h, sec in zip(hist, trainer.step_seconds):
        coded = ("" if exe is None else f" survivors {int(h['survivors'])}/"
                 f"{exe.num_workers} skipped {int(h['skipped'])}")
        print(f"[{tag}] step {int(h['step'])}: loss {h['loss']:.6f} accuracy "
              f"{h['accuracy']:.6f} grad_norm {h['grad_norm']:.6f}{coded} wall {sec:.3f} s")
    wall = sum(trainer.step_seconds)
    steady = trainer.step_seconds[1:]
    print(f"[{tag}] {steps} steps in {wall:.3f} s, {tokens * steps / wall:.1f} "
          f"tokens/s ({tokens * len(steady) / sum(steady):.1f} after the first step)")
    if cuda:
        print(f"[{tag}] max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[{tag}] launches {counts}")
    skipped = int(sum(h.get("skipped", 0.0) for h in hist))
    check(len(hist) == steps, f"{tag}: one history record per step")
    check(all(math.isfinite(h["loss"]) for h in hist), f"{tag}: finite losses")
    check(counts["fused_ce_fwd"] == steps, f"{tag}: fused_ce_fwd launches == steps")
    for name in ("fused_ce_bwd_dh", "fused_ce_bwd_de"):
        check(counts[name] == steps - skipped, f"{tag}: {name} launches == backward runs")
    return counts, opt_state, hist


def erased_round_check(tag: str, model, batch, exe, b_matrix, k: int,
                       per_partition: bool = False, note: str = "") -> None:
    """A decodable round with two workers erased (``model`` in float32
    compute, so bf16 rounding flips can neither hide nor fake an error of
    the decode): ``weighted_gradient`` with the decoded weights against
    the full-batch gradient, or with ``per_partition`` against the mean of
    the k partitions' own gradients (an MoE routes each partition as its
    own pool, as the reference's vmap does), every leaf within (cond(B_S)
    + 64) 2^-22 max|g|."""
    import torch

    from repro_torch.core.gradient_coding import decode_vector_torch
    from repro_torch.runtime.train_loop import weighted_gradient

    wmask = torch.ones(exe.num_workers, dtype=torch.bool, device=model.device)
    wmask[:2] = False
    rows = exe.slot_mask(wmask)
    a, ok = decode_vector_torch(b_matrix, rows)
    check(bool(ok), f"{tag}: two erased workers must stay decodable")
    order = torch.argsort((~rows).to(torch.int8), stable=True)[:k]
    cond = float(torch.linalg.cond(b_matrix[order].double()))
    g_coded, _, _ = weighted_gradient(model, batch, (a @ b_matrix) / k, k)
    params = dict(model.named_parameters())
    if per_partition:
        g_plain = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        for part in zip(*(batch[key].chunk(k) for key in ("tokens", "labels"))):
            loss, _ = model.loss_fn(dict(zip(("tokens", "labels"), part)))
            for n, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
                g_plain[n] += g.float() / k
        against = f"the mean of the {k} partitions' own gradients"
    else:
        loss, _ = model.loss_fn(batch)
        g_plain = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        against = "the full-batch gradient"
    worst = 0.0
    for name, gp in g_plain.items():
        scale = float(gp.abs().max())
        err = float((g_coded[name] - gp).abs().max())
        worst = max(worst, err / ((cond + 64) * 2.0**-22 * scale))
    print(f"[{tag}] coded round, 2 workers erased ({int((~rows).sum())} rows), against "
          f"{against}{note}: max over leaves of |g_coded - g_plain| / ((cond(B_S) + 64) "
          f"2^-22 max|g_plain|) {worst:.3e} <= 1 (cond {cond:.3e}, f32 compute)")
    check(worst <= 1.0, f"{tag}: coded gradient disagrees with {against}")


def skip_round_check(tag: str, trainer, opt_state) -> None:
    """A coded round at deadline 0: nobody finishes, and the parameters, m,
    v and count must stay bit-unchanged."""
    import torch

    model, exe = trainer.model, trainer.executor
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m_before = {n: x.clone() for n, x in opt_state["m"].items()}
    v_before = {n: x.clone() for n, x in opt_state["v"].items()}
    count = opt_state["count"].clone()
    new_state, metrics = trainer.coded_step_fn(
        opt_state, trainer.data.next_batch(), exe.finish_mask(trainer.generator, 0.0))
    check(float(metrics["skipped"]) == 1.0, f"{tag}: deadline 0 must skip the step")
    same = all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    same &= all(torch.equal(new_state["m"][n], m_before[n]) for n in m_before)
    same &= all(torch.equal(new_state["v"][n], v_before[n]) for n in v_before)
    same &= bool(torch.equal(new_state["count"], count))
    print(f"[{tag}] deadline-0 round: skipped, params/m/v/count bit-unchanged: {same}")
    check(same, f"{tag}: a skipped step changed the parameters or the optimizer state")


def train_phase(cfg, device: str = "cuda") -> dict:
    """Gradient-coded ``Trainer.run`` of full-width ``cfg``; returns its launch counts."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    shape = ShapeConfig("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    t = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    trainer = Trainer(
        model, SyntheticLMData(cfg, shape, seed=0, device=device),
        AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS),
        TrainConfig(steps=TRAIN_STEPS, log_every=1, cluster=ClusterSpec.make(*CLUSTER),
                    scheme="grad_coding", partitions=PARTITIONS, deadline_safety=3.0),
    )
    exe = trainer.executor
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sync()
    print(f"[train] {cfg.name}: {model.param_count() / 1e6:.1f} M params, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}; grad_coding k {PARTITIONS}, n {exe.n}, "
          f"loads {exe.plan.loads_per_worker.tolist()}, deadline {exe.deadline:.6f} "
          f"(set-up {time.perf_counter() - t:.1f} s)")
    counts, opt_state, _ = run_steps(trainer, "train", TRAIN_STEPS, TRAIN_BATCH * TRAIN_SEQ)
    if model.device.type == "cuda":
        steady = trainer.step_seconds[1:]
        opt_state = profile_step(trainer, opt_state, sum(steady) / len(steady))

    m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"), device=device, seed=0)
    batch = SyntheticLMData(cfg, shape, seed=0, device=device).next_batch()
    erased_round_check("train", m32, batch, exe, trainer.b_matrix, PARTITIONS)
    del m32, batch
    if model.device.type == "cuda":
        torch.cuda.empty_cache()
    skip_round_check("train", trainer, opt_state)
    return counts


#: [train-families]: each config, the depth kept (None: the config's own),
#: its batch x seq (B4 is held at batch x seq tokens) and whether it
#: trains coded (vlm and audio batches carry extras, which the coded step
#: refuses: they train plain). whisper's decoder context is 448; zamba2's
#: 512 is two SSD chunks of 256. The MoE's 48 layers would need 443 GB of
#: training state: 4 are kept.
TRAIN_FAMILY_RUNS = (("whisper-tiny", None, 8, 448, False),
                     ("xlstm-125m", None, 8, 512, True),
                     ("zamba2-1.2b", None, 8, 512, True),
                     ("paligemma-3b", None, 8, 512, False),
                     ("granite-3-2b", None, 8, 512, True),
                     ("moonshot-v1-16b-a3b", 4, 8, 512, True))
#: the sequence the steps run at where it is cut: an xlstm-125m step is the
#: Python time loops of its 12 cells, about 0.03 s of host time a position
#: with the cells checkpointed (8 x 512: 19-23 s a step), so its steps run
#: 8 x 64 at full width and depth
TF_SEQ_CUT = {"xlstm-125m": 64}
TF_STEPS, TF_PARTITIONS = 3, 8
#: the configs whose steady step is also profiled
TF_PROFILED = ("zamba2-1.2b", "xlstm-125m")
#: the reduced erased-round check's batch x seq (a multiple of the reduced
#: mamba chunk, 16; one row a partition)
TF_REDUCED_SEQ = 32
EXTRAS_REFUSAL = "coded training does not partition family extras yet"


def extras_data(cfg, shape):
    """``SyntheticLMData`` whose vlm or audio batches carry seeded random
    extras in place of ``make_extras``' zero stubs: zero image embeddings
    stay exactly zero through every layer, and each RMSNorm of a zero row
    scales its gradient by 1 / sqrt(eps) = 1,000, so paligemma-3b's 18
    layers overflow float32 (the reference's stub does the same)."""
    import torch

    from repro_torch.data import SyntheticLMData

    gen = torch.Generator(device="cuda").manual_seed(5)

    class Data(SyntheticLMData):
        def next_batch(self):
            batch = super().next_batch()
            if "extras" in batch:
                batch["extras"] = {k: torch.randn(v.shape, generator=gen, device=v.device)
                                   .to(v.dtype) for k, v in batch["extras"].items()}
            return batch

    return Data(cfg, shape, seed=0, device="cuda")


def zero_stub_report(tag: str, model, batch) -> None:
    """``make_extras``' stubs on the card (zeros of the compute dtype, on the
    model's device, the batch's rows) and one plain gradient of a batch
    carrying them: its non-finite leaves are reported, not required."""
    import torch

    from repro_torch.data.pipeline import make_extras

    c = model.config
    stub = make_extras(c, batch["tokens"].shape[0], device=model.device)
    shapes = {k: tuple(v.shape) for k, v in stub.items()}
    ok = all(v.dtype == c.cdtype and v.device.type == model.device.type
             and not bool(v.any()) for v in stub.values())
    check(ok, f"{tag}: make_extras gives zeros of the compute dtype on the card")
    loss, _ = model.loss_fn({**batch, "extras": stub})
    params = dict(model.named_parameters())
    bad = [n for n, g in zip(params, torch.autograd.grad(loss, list(params.values())))
           if not bool(torch.isfinite(g).all())]
    print(f"[{tag}] make_extras on the card: {shapes}, zeros, {c.cdtype}; a plain gradient "
          f"with these stubs: loss {float(loss.detach()):.6f}, {len(bad)}/{len(params)} "
          f"leaves not finite {bad[:4]} (reported, not required)")


def train_family(name: str, depth, batch: int, seq: int, coded: bool, card: str):
    """One [train-families] config: B4 at its (batch x seq, V, D) against
    plain and timed; the model (seeded, f32 parameters, bf16 compute)
    trained TF_STEPS steps on the serve fleet (coded: ``grad_coding`` k
    TF_PARTITIONS; at TF_SEQ_CUT's sequence where it is cut; vlm and
    audio on seeded random extras, after ``zero_stub_report`` and a coded
    trainer's refusal), counters reset before and read after; the profiled
    steady step (TF_PROFILED); for a coded config the erased round (at
    full width where B4's f32 kernels take D, else on the reduced config's
    f32 model) and the deadline-0 round. Returns (launch counts, B4 rows,
    (wall, peak GiB))."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.fused_ce.ops import MAX_D
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cfg = get_arch(name)
    tag = f"train-families {name}"
    if depth is not None:
        print(f"[{tag}] depth cut {cfg.num_layers} -> {depth} layers (full width)")
        cfg = dataclasses.replace(cfg, num_layers=depth)
    rows = fused_ce_phase(batch * seq, cfg.vocab_size, cfg.d_model, tag=tag, stages=False)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = make_model(cfg, tag=tag)
    if name in TF_SEQ_CUT:
        print(f"[{tag}] sequence cut {seq} -> {TF_SEQ_CUT[name]} for the steps (full width "
              f"and depth; B4 held above at {batch * seq} tokens)")
        seq = TF_SEQ_CUT[name]
    data = extras_data(cfg, ShapeConfig("smoke", seq, batch, "train"))
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TF_STEPS)

    def trainer(coded_run: bool):
        return Trainer(model, data, opt, TrainConfig(
            steps=TF_STEPS, log_every=1, scheme="grad_coding", deadline_safety=3.0,
            cluster=ClusterSpec.make(*CLUSTER) if coded_run else None,
            partitions=TF_PARTITIONS if coded_run else None))

    if cfg.family in ("vlm", "audio"):
        zero_stub_report(tag, model, data.next_batch())
        message = None
        try:
            trainer(True).run()
        except NotImplementedError as err:
            message = str(err)
        print(f"[{tag}] coded Trainer.run(): NotImplementedError({message!r})")
        check(message == EXTRAS_REFUSAL, f"{tag}: coded training must refuse the extras")
    tr = trainer(coded)
    mode = (f"grad_coding k {TF_PARTITIONS}, n {tr.executor.n}, loads "
            f"{tr.executor.plan.loads_per_worker.tolist()}" if coded else "plain")
    print(f"[{tag}] {model.param_count() / 1e9:.3f} B params, {cfg.family}, batch "
          f"{batch} x {seq}, {mode}; B4 at (T {batch * seq}, V {cfg.vocab_size}, "
          f"D {cfg.d_model})")
    counts, opt_state, _ = run_steps(tr, tag, TF_STEPS, batch * seq)
    result = (sum(tr.step_seconds), torch.cuda.max_memory_allocated() / 2**30)
    if name in TF_PROFILED:
        steady = tr.step_seconds[1:]
        opt_state = profile_step(tr, opt_state, sum(steady) / len(steady), tag=tag)
    if coded:
        k = TF_PARTITIONS
        moe = cfg.family == "moe"
        if cfg.d_model <= MAX_D:
            erased_round_check(tag, with_config(model, compute_dtype="float32"),
                               data.next_batch(), tr.executor, tr.b_matrix, k, moe,
                               " (full width)")
        else:
            small = Model(cfg.reduced(), device="cuda", seed=0)
            sbatch = SyntheticLMData(cfg.reduced(), ShapeConfig("smoke", TF_REDUCED_SEQ, batch,
                                                                 "train"),
                                     seed=0, device="cuda").next_batch()
            erased_round_check(tag, small, sbatch, tr.executor, tr.b_matrix, k, moe,
                               f" (the reduced config, {TF_REDUCED_SEQ} tokens a row: "
                               f"B4's f32 kernels refuse D {cfg.d_model} > {MAX_D})")
            del small, sbatch
        skip_round_check(tag, tr, opt_state)
    del model, data, tr, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    print(f"[{tag}] wall of the {TF_STEPS} steps {result[0]:.3f} s, peak {result[1]:.2f} GiB "
          f"allocated; {card}")
    check(after <= before + (64 << 20), f"{tag}: the model's memory was not freed "
                                        f"({before} -> {after} bytes)")
    return counts, rows, result


def train_family_reduced(card: str) -> None:
    """Each reduced vlm, audio, hybrid and ssm config (REDUCED_RUNS, float32)
    with the same weights on the card and on the CPU: one plain step's loss
    and every gradient leaf of ``loss_fn`` (seeded tokens, some labels
    masked, seeded extras) within 2e-4 |want| + max(2e-6, 2e-5
    max|want|) (the CPU parity tests' tolerance). The only run of the
    SSD's and the xLSTM's backward at a shape the CPU can check."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model

    for name, changes in REDUCED_RUNS:
        cfg = dataclasses.replace(get_arch(name).reduced(), **changes)
        cpu = Model(cfg, device="cpu", seed=0)
        card_model = Model(cfg, device="cuda", seed=0)
        card_model.load_state_dict(cpu.state_dict())
        gen = torch.Generator().manual_seed(8)
        toks = torch.randint(0, cfg.vocab_size, (2, REDUCED_SEQ + 1), dtype=torch.int32,
                             generator=gen)
        labels = toks[:, 1:].clone()
        labels[0, :5] = -1
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": labels}
        key = {"vlm": "image_embeds", "audio": "frames"}.get(cfg.family)
        if key is not None:
            length = cfg.num_image_tokens if key == "image_embeds" else cfg.encoder_seq
            batch["extras"] = {key: torch.randn((2, length, cfg.d_model), generator=gen)}
        runs = []
        for m in (card_model, cpu):
            on = {k: ({n: x.to(m.device) for n, x in v.items()} if k == "extras"
                      else v.to(m.device)) for k, v in batch.items()}
            loss, _ = m.loss_fn(on)
            params = dict(m.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()))
            runs.append((float(loss.detach()), {n: g.cpu() for n, g in zip(params, grads)}))
        (loss, got), (want_loss, want) = runs
        worst, leaf = 0.0, ""
        for n, w in want.items():
            lim = 2e-4 * w.abs() + max(2e-6, 2e-5 * float(w.abs().max()))
            ratio = float(((got[n] - w).abs() / lim).max())
            if ratio > worst:
                worst, leaf = ratio, n
        finite = all(bool(torch.isfinite(g).all()) for g in got.values())
        note = f", {changes}" if changes else ""
        print(f"[train-families] reduced {cfg.name} ({cfg.family}{note}): loss card "
              f"{loss:.7f} CPU {want_loss:.7f}; {len(want)} gradient leaves card against "
              f"CPU, worst |d| / (2e-4 |want| + max(2e-6, 2e-5 max|want|)) {worst:.3f} "
              f"({leaf}); finite {finite} ({card})")
        check(finite, f"reduced {name}: non-finite gradients on the card")
        check(abs(loss - want_loss) <= 2e-4 * abs(want_loss) + 2e-6,
              f"reduced {name}: the loss on the card disagrees with the CPU")
        check(worst <= 1.0, f"reduced {name}: the card's gradients disagree with the CPU's")
        del cpu, card_model


def train_families_phase(card: str):
    """[train-families]: every TRAIN_FAMILY_RUNS config (``train_family``),
    one model on the card at a time, then the reduced vlm, audio, hybrid
    and ssm configs' gradients card against CPU. Returns the paths' launch
    counts and B4's rows by config."""
    paths, rows = {}, {}
    for name, depth, batch, seq, coded in TRAIN_FAMILY_RUNS:
        counts, rows[name], _ = train_family(name, depth, batch, seq, coded, card)
        paths[f"train_families_{name}"] = counts
    train_family_reduced(card)
    return paths, rows


#: [dryrun]: the CLI runs (argv after ``python -m``, the records they must
#: write), all started together (each counts on one core); the card's count at qwen3-0.6b train_4k
#: with the global batch cut from 256 to DRYRUN_BATCH rows and the depth
#: from 28 to DRYRUN_LAYERS (the phase's time: a counted step dispatches
#: about 1,800 operations a layer through Python, each counted twice)
DRYRUN_RUNS = (
    (["--arch", "qwen3-0.6b", "--mesh", "both"],
     [f"qwen3-0.6b_{s}_{m}" for s in ("train_4k", "prefill_32k", "decode_32k")
      for m in ("single", "multi")]),
    (["--arch", "whisper-tiny", "--shape", "prefill_32k", "--mesh", "single"],
     ["whisper-tiny_prefill_32k_single"]),
    (["--arch", "moonshot-v1-16b-a3b", "--shape", "decode_32k", "--mesh", "both",
      "--coded-groups", "6:8.0,6:0.7"],
     ["moonshot-v1-16b-a3b_decode_32k_single", "moonshot-v1-16b-a3b_decode_32k_multi"]),
)
DRYRUN_BATCH, DRYRUN_LAYERS = 8, 4
#: [dryrun]'s one-card sizing (``a4_sizing``): (arch, shape, parameter
#: dtype or None for the config's own)
SIZING_CELLS = (("moonshot-v1-16b-a3b", "decode_32k", "bfloat16"),
                ("yi-9b", "train_4k", None), ("h2o-danube-3-4b", "train_4k", None),
                ("grok-1-314b", "decode_32k", "bfloat16"))
SIZING_CMD = ["-c", "import chip_smoke; chip_smoke.a4_sizing()"]


def a4_sizing() -> None:
    """Print each ``SIZING_CELLS`` cell's memory on one card: the dry-run's
    record on a 1 x 1 mesh (``roofline_cell(..., mesh=)``, counted on
    ``meta``, so no card is needed): argument bytes by kind, the output
    and temp bytes (the meta run's peak live bytes, an estimate) and
    ``fits``. ``python3 -c 'import chip_smoke; chip_smoke.a4_sizing()'``
    prints the same anywhere."""
    import dataclasses

    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import MeshShape

    for arch, shape, dtype in SIZING_CELLS:
        cfg = get_arch(arch)
        cfg = dataclasses.replace(cfg, param_dtype=dtype) if dtype else cfg
        rec = D.roofline_cell(cfg, SHAPES_BY_NAME[shape],
                              mesh=MeshShape({"data": 1, "model": 1}), verbose=False)
        mem = rec["memory_analysis"]
        args = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in mem["arguments"].items())
        print(f"{arch} {shape} ({cfg.param_dtype} parameters) on one card: arguments "
              f"{args} GB; output and temp {mem['output_and_temp_bytes'] / 1e9:.1f} GB; "
              f"{rec['memory_per_device_bytes'] / 1e9:.1f} GB, fits {rec['fits']}")


def start_procs(cmds: list[list[str]]) -> list:
    """Start each command (argv after the interpreter) from the repository
    root, all at once; returns the Popen objects."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return [subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for cmd in cmds]


def finish_procs(procs: list, tag: str, timeout: float = 600) -> list[tuple[int, str]]:
    """Wait for every process (killing all of them if one overruns); print
    each one's stdout; returns (exit code, stdout) per process."""
    out = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        print(f"[{tag}] {' '.join(proc.args[1:])}: exit {proc.returncode}")
        for line in stdout.strip().splitlines():
            print(f"[{tag}]   {line}")
        if proc.returncode != 0:
            print(stderr[-4000:], file=sys.stderr)
        out.append((proc.returncode, stdout))
    return out


def deployment_phases(card: str) -> tuple[dict, dict]:
    """[dryrun], [mesh] and [examples], overlapped for the run's time: the
    dry-run CLI on the cells of ``DRYRUN_RUNS`` and ``a4_sizing`` in
    processes of their own (counted on ``meta``, on the host's cores)
    while the card counts a
    real qwen3-0.6b train step (``dryrun_card_count``), then
    ``mesh_phase`` and ``examples_phase``; then the CLI runs' checks.
    Returns the counted step's launch counts and the examples' launches."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        procs = start_procs([["-m", "repro_torch.launch.dryrun", *argv, "--out", tmp]
                             for argv, _ in DRYRUN_RUNS] + [SIZING_CMD])
        try:
            counts = dryrun_card_count(card)
            mesh_phase()
            examples = examples_phase()
        finally:
            results = finish_procs(procs, "dryrun")
            print(f"[dryrun] the CLI runs done {time.perf_counter() - t:.1f} s after they "
                  f"started")
        check(results[-1][0] == 0, "the one-card sizing (a4_sizing) exits 0")
        for (code, _), (argv, names) in zip(results, DRYRUN_RUNS):
            check(code == 0, f"the dry-run CLI {' '.join(argv)} exits 0")
            for name in names:
                dryrun_record(json.loads((Path(tmp) / f"{name}.json").read_text()), name,
                              coded="--coded-groups" in argv)
    return counts, examples


def dryrun_record(r: dict, name: str, coded: bool) -> None:
    """Check and print one record of the dry-run CLI (``coded``: the run
    attached the coded head)."""
    check(r["chips"] in (256, 512), f"{name}: chips {r['chips']}")
    check(r["hlo_flops_per_device"] > 0, f"{name}: FLOPs > 0")
    check(r["bottleneck"] in ("t_compute", "t_memory", "t_collective"), f"{name}: bottleneck")
    head = r.get("coded_lm_head")
    check((head is not None) == coded, f"{name}: the coded head attached")
    print(f"[dryrun] {name}: {r['method']}, {r['hlo_flops_per_device']:.4e} FLOPs "
          f"and {r['hlo_bytes_per_device']:.4e} bytes a device, collectives "
          f"{r['collective_bytes_per_device']['total']:.4e}, memory "
          f"{r['memory_per_device_bytes'] / 1e9:.2f} GB (fits {r['fits']}), "
          f"t_compute {r['t_compute'] * 1e3:.3f} ms, t_memory {r['t_memory'] * 1e3:.3f} ms, "
          f"t_collective {r['t_collective'] * 1e3:.3f} ms: {r['bottleneck']}"
          + (f"; coded head kb {head['kb']} nb {head['nb']}, B1 "
             f"{head['kernels']['coded_matvec']['flops']:.3e} FLOPs a step" if head else ""))


def dryrun_card_count(card: str) -> dict:
    """[dryrun]'s count on the card (``deployment_phases``); returns the counted
    step's launch counts."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.kernels as kernels
    from repro_torch.configs import SHAPES_BY_NAME, get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), num_layers=DRYRUN_LAYERS)
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], global_batch=DRYRUN_BATCH)
    t = time.perf_counter()
    local = MeshShape({"data": 1, "model": 1})
    rec = D.roofline_cell(cfg, shape, mesh=local, verbose=False)
    print(f"[dryrun] meta count of {cfg.name} train_4k at batch {DRYRUN_BATCH} (cut from "
          f"256), {DRYRUN_LAYERS} of 28 layers, on the local mesh: "
          f"{rec['flops_global']:.6e} FLOPs, "
          f"{rec['bytes_global_unfused']:.6e} bytes unfused, method {rec['method']}, "
          f"{rec['compile_seconds']} s; t_compute {rec['t_compute'] * 1e3:.1f} ms, "
          f"t_memory {rec['t_memory'] * 1e3:.1f} ms")
    model = Model(cfg, device="cuda", seed=0)
    inputs = D.step_inputs(model, shape)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t_count = time.perf_counter()
    with FlopCounterMode(display=False) as fc, D.Counter() as cnt:
        D.run_step(model, shape, inputs)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    counted = cnt.result()
    ops_flops = fc.get_total_flops()
    kernel_flops = sum(v[1] for v in counted.kernels.values())
    print(f"[dryrun] card count ({time.perf_counter() - t_count:.1f} s): "
          f"FlopCounterMode {ops_flops:.6e} + B4's cost functions {kernel_flops:.6e} = "
          f"{ops_flops + kernel_flops:.6e} FLOPs (the counter's {counted.total_flops():.6e}); "
          f"bytes unfused {counted.total_bytes():.6e} (meta "
          f"{rec['bytes_global_unfused']:.6e}); "
          f"B4 launches {counts['fused_ce_fwd']} / {counts['fused_ce_bwd_dh']} / "
          f"{counts['fused_ce_bwd_de']}")
    check(ops_flops + kernel_flops == rec["flops_global"] == counted.total_flops(),
          "the card's count equals the dry-run's meta count")
    check((counts["fused_ce_fwd"], counts["fused_ce_bwd_dh"], counts["fused_ce_bwd_de"])
          == (1, 1, 1), "B4 launches once forward and once backward in the counted step")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    D.run_step(model, shape, inputs)
    end.record()
    torch.cuda.synchronize()
    step_s = start.elapsed_time(end) / 1e3
    bound = max(rec["t_compute"], rec["t_memory"])
    mem = rec["memory_analysis"]
    print(f"[dryrun] {card}: the step {step_s * 1e3:.1f} ms (CUDA events); "
          f"max(t_compute, t_memory) {bound * 1e3:.1f} ms = {bound / step_s:.3f} of it "
          f"(t_compute alone {rec['t_compute'] / step_s:.3f})")
    print(f"[dryrun] peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(the step's own {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above "
          f"the {base / 1e9:.2f} GB resident); reckoned: arguments "
          f"{mem['argument_bytes'] / 1e9:.2f} GB + output and temp "
          f"{mem['output_and_temp_bytes'] / 1e9:.2f} GB")
    del model, inputs
    torch.cuda.empty_cache()
    print(f"[dryrun] the card's count and timed step {time.perf_counter() - t:.1f} s")
    return counts


def mesh_phase() -> None:
    """[mesh]: ``make_local_mesh()`` (one NCCL rank), qwen3-0.6b's
    parameters placed by ``make_param_sharding``: each local shard equals
    its parameter bit for bit, and ``lm_logits`` of a model loaded from
    the local shards equals the original's exactly; the group destroyed."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import destroy_local_mesh, make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding import distribute, make_param_sharding

    t = time.perf_counter()
    mesh = make_local_mesh()
    try:
        cfg = get_arch("qwen3-0.6b")
        model = Model(cfg, device="cuda", seed=3)
        params = dict(model.named_parameters())
        shardings = make_param_sharding(mesh, model)
        placed = distribute(mesh, params, shardings)
        same = sum(torch.equal(placed[n].to_local(), p) for n, p in params.items())
        print(f"[mesh] {dist.get_backend()} mesh {mesh.mesh_dim_names} "
              f"{tuple(mesh.shape)}: {same}/{len(params)} local shards bit-identical; "
              f"wq placed {shardings['wq']}, embed {shardings['embed']}")
        check(same == len(params), "every local shard equals its parameter")
        twin = Model(cfg, device="meta").to_empty(device=model.device)
        twin.device = model.device
        with torch.no_grad():
            for n, p in twin.named_parameters():
                p.copy_(placed[n].to_local())
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=model.device,
                               generator=torch.Generator(device=model.device).manual_seed(0))
        with torch.no_grad():
            want, got = model.lm_logits(tokens), twin.lm_logits(tokens)
        print(f"[mesh] lm_logits from the local shards equal the original's: "
              f"{torch.equal(got, want)} ({tuple(got.shape)})")
        check(torch.equal(got, want), "lm_logits from the local shards")
        del model, twin, placed, params
    finally:
        destroy_local_mesh()
    check(not dist.is_initialized(), "the local mesh's group is destroyed")
    torch.cuda.empty_cache()
    print(f"[mesh] {time.perf_counter() - t:.1f} s")


#: [examples]: each example's argv and the lines its stdout must hold
EXAMPLE_RUNS = (
    (["examples/torch_quickstart.py"], ["coded matvec with 2 erasures: recovered=True"]),
    (["examples/torch_coded_serving.py"], ["coded == uncoded greedy outputs: True"]),
    (["examples/torch_elastic_fleet.py"], ["t=91 +20 fast workers", "replans=2"]),
    (["examples/torch_train_lm.py", "--steps", "30", "--seq", "8", "--layers", "1"],
     ["loss trajectory", "final loss"]),
)


def examples_phase() -> dict:
    """[examples]: each ``examples/torch_*.py`` loaded from its file and its
    ``main`` called on the card with ``EXAMPLE_RUNS``' arguments (in this
    process: no start-up of its own), its launch counters reset just
    before and read just after: return code 0 (each example's own check:
    train_lm returns 1 unless the loss falls 1 nat) and its lines. B1 and
    B3 must launch in the quickstart and the coded serving, B4 in
    train_lm. Returns the summed launches."""
    import contextlib
    import importlib.util
    import io

    import repro_torch.kernels as kernels

    t = time.perf_counter()
    total: dict = {}
    for argv, lines in EXAMPLE_RUNS:
        path = ROOT / argv[0]
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        t_ex = time.perf_counter()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            code = mod.main(argv[1:])
        counts = kernels.launch_counts()
        print(f"[examples] {' '.join(argv)}: returned {code} in "
              f"{time.perf_counter() - t_ex:.1f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        for line in out.getvalue().strip().splitlines():
            print(f"[examples]   {line}")
        check(code == 0, f"{argv[0]} returns 0")
        for line in lines:
            check(line in out.getvalue(), f"{argv[0]} prints {line!r}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if path.stem in ("torch_quickstart", "torch_coded_serving"):
            check(counts["coded_matvec"] > 0 and counts["mds_encode"] > 0,
                  f"B1 and B3 launch in {path.name}")
    check(min(total[k] for k in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_de")) > 0,
          "B4 launches in train_lm")
    print(f"[examples] {time.perf_counter() - t:.1f} s")
    return total


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one H100 (no arguments: "
                                             "every phase).")
    ap.add_argument("--train-family", metavar="ARCH",
                    choices=[run[0] for run in TRAIN_FAMILY_RUNS],
                    help="build the kernels and run only this [train-families] config")
    ap.add_argument("--seq", type=int, default=None,
                    help="with --train-family: the steps' sequence (default: the phase's)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.core.planner import deploy
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.core.schemes import make_scheme
    from repro_torch.runtime.serve_loop import set_full_fp32

    set_full_fp32()
    card = card_line()
    print(f"[setup] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_setup = time.perf_counter()
    setup()
    if args.train_family:
        name, depth, batch, seq, coded = next(run for run in TRAIN_FAMILY_RUNS
                                              if run[0] == args.train_family)
        if args.seq is not None:
            TF_SEQ_CUT.pop(name, None)
            if args.seq != seq:
                TF_SEQ_CUT[name] = args.seq
        train_family(name, depth, batch, seq, coded, card)
        print(card)
        return 0
    kb = -(-151_936 // 256)
    plan = deploy(make_scheme("optimal"), ClusterSpec.make(*CLUSTER), kb)
    rows = kernel_phase(plan.n, kb)
    rows.update(fused_ce_phase())
    torch.cuda.empty_cache()
    paths = {}  # path -> launch counts, each reset just before it and read after
    clock = [t_setup]

    def lap(name: str) -> None:
        now = time.perf_counter()
        print(f"[time] {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    lap("set-up and kernels")
    paths["matvec"], path_m, matvec_out = matvec_phase()
    lap("matvec")
    paths.update(matvec_mesh_phase(card, matvec_out))
    del matvec_out
    lap("matvec-mesh")
    paths["paper"] = paper_phase(card)
    lap("paper")
    model = make_model(get_arch("qwen3-0.6b"))
    served = {}  # [serve]'s and [serve-dense]'s servers, for [programs]
    paths["serve"], paged_rep = serve_phase(model, keep=served)
    served["serve", "counts"] = paths["serve"]
    lap("serve")
    paths["serve_dense"], dense_rep = serve_dense_phase(model, paged_rep, keep=served)
    served["serve-dense", "counts"] = paths["serve_dense"]
    lap("serve-dense")
    paths["generate"], gen_out = generate_phase(model, card)
    lap("generate")
    paths.update(obs_phase(model, gen_out))
    lap("obs")
    for name, c in adapt_phase(model, card).items():
        paths[f"adapt_{name}"] = c
    lap("adapt")
    paths.update(adapt_measured_phase(model, card, paged_rep))
    lap("adapt-measured")
    paths.update(programs_phase(model, card, served, paged_rep, dense_rep))
    del served
    lap("programs")
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = str(Path(tmp) / "cli.jsonl")
        serve = ["repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--coded"]
        # 2 steps of 8 x 32 (an xlstm-125m position is ~0.03 s of host time)
        train = ["repro_torch.launch.train", "--steps", "2", "--seq-len", "32", "--batch",
                 "8", "--hetero-groups", "6:8.0,6:0.7", "--arch"]
        cli_phase([
            (serve + ["--scheme", "uniform_r", "--scheme-r", "10", "--max-new", "4"],
             ["coded LM head [uniform_r_group_code]: kb=594", "generated (4, 20)"], True),
            (serve + ["--scenario", "churn", "--adapt-every", "2", "--rounds", "12",
                      "--max-new", "4"],
             ["coded LM head [optimal]: kb=594", "[round 3] replanned (membership)",
              "[round 9] replanned (membership)", "scenario 'churn': 12 rounds",
              "controller: 6 decisions"], True),
            (serve + ["--trace", "poisson", "--num-requests", "8", "--slots", "auto",
                      "--telemetry", jsonl, "--chrome-trace",
                      str(Path(tmp) / "cli.trace.json"), "--max-new", "4"],
             ["slots auto -> ", "chrome trace: ", "served 8 (0 shed)"], True),
            (train + ["xlstm-125m"],
             ["training xlstm-125m: ", "coded training: scheme=grad_coding k=8", "loss "],
             True),
            (train + ["whisper-tiny"], [EXTRAS_REFUSAL], False),
        ])
        obsreport_cli(jsonl)
    lap("cli")
    fam_paths, fam_rows = families_phase(card)
    paths.update(fam_paths)
    lap("families")
    paths["moonshot_bf16"] = moonshot_bf16_phase(card)
    lap("moonshot-bf16")
    paths["train"] = train_phase(get_arch("qwen3-0.6b"))
    torch.cuda.empty_cache()
    lap("train")
    paths.update(train_adapt_phase(get_arch("qwen3-0.6b")))
    lap("train-adapt")
    tf_paths, tf_rows = train_families_phase(card)
    paths.update(tf_paths)
    for name, r in tf_rows.items():
        fam_rows.setdefault(name, {}).update(r)
    lap("train-families")
    paths["dryrun_card_step"], paths["examples"] = deployment_phases(card)
    lap("dryrun, mesh and examples (overlapped)")

    import repro_torch.kernels as kernels

    replaces = {
        "coded_matvec": "src/repro/kernels/coded_matvec/kernel.py:48",
        "paged_decode": "src/repro/kernels/paged_attention/kernel.py:66",
        "mds_encode": "src/repro/kernels/mds_encode/kernel.py:48",
        **dict.fromkeys(("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_de"),
                        "src/repro/kernels/fused_ce/kernel.py:77"),
    }

    def timing(r: dict) -> dict:
        return {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"], "device_ms": r.get("device_ms"),
                "library_device_ms": r.get("library_device_ms")}

    # each kernel's main-path launches: serving (B1-B3) or training (B4);
    # every path's beside them; B1 and B3 also at Path M's shapes; by
    # config, B1-B3 at [families]' shapes and B4 at [train-families]' shapes
    line = {"kernels": []}
    for k in kernels.KERNELS:
        main_path = "train" if k.name.startswith("fused_ce") else "serve"
        entry = {"name": k.name, "route": "cuda", "source": str(k.source.relative_to(ROOT)),
                 "replaces": replaces[k.name], "launches": paths[main_path][k.name],
                 **timing(rows[k.name]),
                 "launches_by_path": {p: c.get(k.name, 0) for p, c in paths.items()}}
        extra = {"coded_matvec": "narrow", "mds_encode": "encode"}.get(k.name)
        if extra is not None:
            entry["path_m"] = {"shape": path_m[extra]["shape"], **timing(path_m[extra])}
        by_config = {name: {"shape": r[k.name]["shape"], **timing(r[k.name])}
                     for name, r in fam_rows.items() if k.name in r}
        if by_config:
            entry["families"] = by_config
        line["kernels"].append(entry)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
