"""The readings a cell's correctness limits are set from, on the card at the
cell's own size: the program's number on each seed, and the control's.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 8 [--control]

One process reads every seed: a serve cell keeps its model and, per seed,
writes the seed's weights into it, builds a new server, warms it up,
serves ``--seconds`` of the cell's traffic and judges a sample as a run
does; a Path M cell builds A, G and A~ per seed and runs ``--seconds`` of
queries. ``--control`` also reads the control on the same inputs: the
reference with float8 weights (serve; the gap of the token it puts first
at each position), or the plain coded matvec with products from TF32
operands (Path M). One JSON
line per seed. Not part of a run: a run compares with the limits these
readings set (``perfbench/limits/<cell>.json``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from perfbench import run  # noqa: E402


def serve_readings(cx, drv, seeds, control: bool):
    import torch

    kw = drv.serve_kwargs(cx.mix, cx.config)
    model = drv.make_model(cx, seeds[0])
    for seed in seeds:
        cx.seed = seed
        drv.weights.fill(dict(model.named_parameters()), cx.config, seed)
        srv = drv.make_server(cx, model)
        drv.warmup(cx, srv, kw)
        calls = drv.window(cx, srv, kw)
        srv = None
        gc.collect()
        if cx.device.type == "cuda":
            torch.cuda.empty_cache()
        r = drv.readings(cx, drv.sample(cx, calls), seed, control=control)
        short = sum(len(s) != c.trace[rid].out_len for c in calls for rid, s in c.streams.items())
        yield {"seed": seed, "requests": sum(c.offered for c in calls),
               "program": {"max_gap": r["max_gap"], "short_streams": short},
               "served": r["served"],
               **({"control": {"max_gap": r["control_gap"]}} if control else {})}


def matvec_readings(cx, drv, seeds, control: bool):
    import torch

    for seed in seeds:
        cx.seed = seed
        qs, pipe, packed, a, g = drv.build(cx, seed)
        drv.run_queries(pipe, packed, drv.window(cx, qs), int(cx.mix["warmup_queries"]))
        gc.collect()
        win = drv.run_queries(pipe, packed, drv.window(cx, qs), 10**9, seconds=cx.seconds)
        pipe = packed = None
        gc.collect()
        if cx.device.type == "cuda":
            torch.cuda.empty_cache()
        r = drv.judge(cx, win, a, g, control=control)
        out = {"seed": seed, "queries": win.attempted,
               "program": {"err_ratio": r["err_ratio"], "wrong_ok": r["wrong_ok"],
                           "max_rel_err": r["max_rel_err"]}}
        if control:
            out["control"] = {"err_ratio": r["control_err_ratio"],
                              "max_rel_err": r["control_max_rel_err"]}
        yield out


def main(argv=None, *, root: Path | None = None, device: str = "cuda", out=None) -> int:
    import torch

    out = out or sys.stdout
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    root = Path(root or HERE.parent)
    seeds = [int(s) for s in args.seeds.split(",")]
    cx = run.Cell(root, args.workload, seeds[0], args.seconds, False)
    cx.device = torch.device(device)
    run.prepare(root)
    drv = run.load_module(cx.dir / "drivers" / f"{cx.mix['kind']}.py")
    each = serve_readings if cx.mix["kind"] == "serve" else matvec_readings
    for line in each(cx, drv, seeds, args.control):
        print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
