#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100: build, check and time its kernels,
then serve full-width qwen3-0.6b through the coded paged server.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. set-up   — build the three CUDA kernels from ``src/repro_torch`` (one
   ``nvcc`` per source, all at once, into ``build/kernels/``);
2. kernels  — each kernel against its plain PyTorch version on the card
   at the serving path's full-width shapes, with the tolerance stated,
   timed beside the plain version and one PyTorch library call;
3. serve    — launch counters reset, then ``Server`` + ``serve`` of a
   seeded 8-request trace on full-width qwen3-0.6b (random seeded
   weights) with the coded LM head on a 12-worker cluster; counters read
   right after; then a few coded rounds on real logits held against the
   uncoded logits.

The last three stdout lines are the card (``nvidia-smi``), the kernels
JSON and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """Least time for the work: max(bytes / HBM rate, ops / peak), in ms."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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
    for k in kernels.KERNELS:
        for line in k.log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[setup] {k.name}: {line.strip()}")


def gemm_tolerance(a, b) -> float:
    """Worst-case float32 dot-product error of either side: 2 K u max(|A||B|)."""
    import torch

    return 2 * a.shape[1] * 2.0**-24 * float(torch.matmul(a.abs(), b.abs()).max())


def kernel_phase(nb: int, kb: int) -> dict:
    """Each kernel vs its plain version at the serving shapes; times."""
    import torch
    import torch.nn.functional as F

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
    m, k, n = nb, kb, x.shape[1]
    rows["coded_matvec"] = dict(
        err=err, ms=cuda_ms(lambda: cmv.blocked_matvec(g, x), 200),
        plain_ms=cuda_ms(lambda: cmv.blocked_matvec_plain(g, x), 200),
        library_ms=cuda_ms(lambda: torch.matmul(g, x), 200),
        bound=bound_ms(4 * (m * k + k * n + m * n), 2 * m * n * k, "float32"),
    )

    # B3: the once-per-plan encode, (nb, kb) x (kb, R*D)
    a = torch.randn((kb, 256 * 1024), generator=gen, device=dev) * 0.02
    got, want = mds.mds_encode(g, a), mds.mds_encode_plain(g, a)
    err, tol = float((got - want).abs().max()), gemm_tolerance(g, a)
    del got, want
    print(f"[kernels] mds_encode ({nb},{kb})x({kb},{a.shape[1]}): "
          f"max_abs_err {err:.3e} <= tol {tol:.3e} (2 K u max|G||A|)")
    check(err <= tol, "mds_encode disagrees with its plain version")
    m, k, n = nb, kb, a.shape[1]
    rows["mds_encode"] = dict(
        err=err, ms=cuda_ms(lambda: mds.mds_encode(g, a), 5),
        plain_ms=cuda_ms(lambda: mds.mds_encode_plain(g, a), 5),
        library_ms=cuda_ms(lambda: torch.matmul(g, a), 5),
        bound=bound_ms(4 * (m * k + k * n + m * n), 2 * m * n * k, "float32"),
    )
    del a
    torch.cuda.empty_cache()

    # B2: decode attend, S=4 slots over a pool as wide as the serve loop's;
    # scattered tables with a hole, one slot with no valid entry, and NaN
    # in the sink block (a kernel that reads it poisons every slot)
    kv, grp, hd, nblk = 8, 2, 128, 72
    k_pool = torch.randn((nblk + 1, BLOCK_LEN, kv, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
    v_pool = torch.randn((nblk + 1, BLOCK_LEN, kv, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
    k_pool[nblk] = float("nan")
    v_pool[nblk] = float("nan")
    q = torch.randn((SLOTS, kv, grp, hd), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor([255, 100, 16, 40], dtype=torch.int32, device=dev)
    table = torch.full((SLOTS, nblk), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(nblk, generator=gen, device=dev).to(torch.int32)
    table[0, :16], table[1, :7], table[2, :2] = perm[:16], perm[16:23], perm[23:25]
    table[0, 5] = -1  # an unallocated hole inside slot 0's history
    got = pa.paged_decode_attend(q, k_pool, v_pool, table, pos)
    want = pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos)
    check(bool(torch.isfinite(got).all()), "paged_decode output not finite")
    check(bool((got[3] == 0).all()), "paged_decode: empty slot must return zeros")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    # per element: at most one bf16 rounding step apart, |d| <= 2^-7 |want| + 1e-6
    worst = float((diff / (2.0**-7 * want.float().abs() + 1e-6)).max())
    print(f"[kernels] paged_decode S={SLOTS} KV={kv} G={grp} hd={hd} "
          f"MB={nblk}: max_abs_err {err:.3e}; max |d| / (2^-7 |want| + 1e-6) "
          f"{worst:.3e} <= 1 (one bf16 rounding step per element)")
    check(worst <= 1.0, "paged_decode disagrees with its plain version")
    valid = pa.valid_mask(table, BLOCK_LEN, pos)  # (S, L)
    n_tok = int(valid.sum())
    # yardstick: SDPA over the gathered KV of the valid positions
    kg = pa.gather_kv(k_pool, table).permute(0, 2, 1, 3).repeat_interleave(grp, 1)
    vg = pa.gather_kv(v_pool, table).permute(0, 2, 1, 3).repeat_interleave(grp, 1)
    qs = q.reshape(SLOTS, kv * grp, 1, hd)
    mask = valid[:, None, None, :]
    nbytes = 2 * (q.numel() * 2 + 2 * n_tok * kv * hd) + 4 * (table.numel() + SLOTS)
    rows["paged_decode"] = dict(
        err=err,
        ms=cuda_ms(lambda: pa.paged_decode_attend(q, k_pool, v_pool, table, pos), 200),
        plain_ms=cuda_ms(
            lambda: pa.paged_decode_attend_plain(q, k_pool, v_pool, table, pos), 50),
        library_ms=cuda_ms(
            lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask), 200),
        bound=bound_ms(nbytes, 4 * n_tok * kv * grp * hd, "bfloat16"),
    )
    return rows


def serve_phase(cfg, device: str = "cuda") -> dict:
    """Coded paged serve of ``cfg``; returns the launch counts of the run."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import ServeConfig, Server
    from repro_torch.serve.workload import make_workload

    t = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, params "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"(init {time.perf_counter() - t:.1f} s)")
    trace = make_workload("poisson", num_requests=8, prompt_len=(64, 256),
                          out_len=(8, 16), vocab=cfg.vocab_size).trace(seed=0)

    kernels.reset_launch_counts()
    server = Server(model, ClusterSpec.make(*CLUSTER),
                    ServeConfig(block_rows=256, deadline_safety=SAFETY,
                                scheme="optimal"))
    rep = server.serve(trace, slots=SLOTS, block_len=BLOCK_LEN,
                       prefill_chunk=CHUNK, decode_block=DECODE_BLOCK, seed=0)
    counts = kernels.launch_counts()

    head = server.coded_head
    print(f"[serve] coded head: kb {head.kb}, nb {head.nb}, deadline "
          f"{head.deadline:.6f}, loads {head.plan.loads_per_worker.tolist()}")
    done = [f for f in rep.finished if f.outcome == "done"]
    print(f"[serve] {len(done)}/{len(trace)} done, shed {rep.shed}, tokens "
          f"{rep.tokens}, decode rounds {rep.decode_rounds}, prefill rounds "
          f"{rep.prefill_rounds}")
    print(f"[serve] wall {rep.wall_s:.3f} s, {rep.tokens_per_s:.2f} tokens/s, "
          f"decode ok rate {rep.decode_ok}/{rep.decode_rounds}, erased rounds "
          f"{rep.erased_rounds}, KV pool bytes {rep.kv_bytes}")
    print(f"[serve] launches {counts}")
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
        print(f"[serve] coded round, {int((~wmask).sum())} workers erased: "
              f"max |decoded - uncoded| {err:.3e} <= tol {tol:.3e} "
              f"(cond(G_S) 2^-22 max|logits|, cond {cond:.3e})")
        check(err <= tol, "decoded logits disagree with the uncoded logits")
        checked += 1
        if checked == 4:
            break
    check(checked >= 1, "no coded round decoded through erasures")
    return counts


def main() -> int:
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
    setup()
    kb = -(-151_936 // 256)
    plan = deploy(make_scheme("optimal"), ClusterSpec.make(*CLUSTER), kb)
    rows = kernel_phase(plan.n, kb)
    counts = serve_phase(get_arch("qwen3-0.6b"))

    import repro_torch.kernels as kernels

    replaces = {
        "coded_matvec": "src/repro/kernels/coded_matvec/kernel.py:48",
        "paged_decode": "src/repro/kernels/paged_attention/kernel.py:66",
        "mds_encode": "src/repro/kernels/mds_encode/kernel.py:48",
    }
    line = {"kernels": [
        {
            "name": k.name, "route": "cuda",
            "source": str(k.source.relative_to(ROOT)),
            "replaces": replaces[k.name],
            "launches": counts[k.name],
            "max_abs_err": rows[k.name]["err"],
            "ms": rows[k.name]["ms"],
            "plain_ms": rows[k.name]["plain_ms"],
            "bound_ms": rows[k.name]["bound"][0],
            "bound_by": rows[k.name]["bound"][1],
            "library_ms": rows[k.name]["library_ms"],
        }
        for k in kernels.KERNELS
    ]}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
