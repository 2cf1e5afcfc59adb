"""End-to-end training through the PyTorch port: a ~100M-parameter LM.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 60] [--seq 32] [--device cpu]

Uses the xlstm-125m architecture at full width but trimmed depth, with
the whole substrate engaged: synthetic data pipeline, AdamW + cosine
schedule + clipping, async checkpointing, telemetry, the heterogeneity-
aware batch split from the paper's Theorem 2, and on the card the B4
fused cross-entropy kernels (forward and both backward kernels every
step). The xLSTM's time scans are a Python loop over positions, so a
step's host time grows with ``--seq``; the reference's 300 steps would
be minutes on the card.

The synthetic stream has conditional entropy ~= ln(17) ~= 2.83 nats, so
the loss falls from ~ln(50304) ~= 10.8 toward 2.83. Exits non-zero
unless the last loss is at least ``--min-drop`` below the first.

The counterpart of ``examples/train_lm.py``; on the card unless
``--device cpu``.
"""
import argparse
import json
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.kernels as kernels  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core.runtime_model import ClusterSpec  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    TrainConfig,
    Trainer,
    heterogeneous_batch_split,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32, help="positions a sequence")
    ap.add_argument("--layers", type=int, default=4, help="xLSTM layers (of 12)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's CPU-sized variant (d 128, vocab 512; an sLSTM "
                         "every 2nd layer) instead of the full width")
    ap.add_argument("--min-drop", type=float, default=1.0,
                    help="nats the loss must fall from the first step to the last")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # full-width xlstm-125m, trimmed depth
    config = get_arch("xlstm-125m")
    if args.reduced:
        config = dataclasses.replace(config.reduced(), slstm_every=2)
    config = dataclasses.replace(config, num_layers=args.layers, compute_dtype="float32")
    model = Model(config, device=dev)
    print(f"model: {config.name} ({model.param_count() / 1e6:.1f}M params)")

    # the paper's allocation applied to the data-parallel batch split
    fleet = ClusterSpec.make([2, 2], [4.0, 1.0])
    split = heterogeneous_batch_split(fleet, args.batch)
    print(f"heterogeneous fleet {[(g.num_workers, g.mu) for g in fleet.groups]}"
          f" -> per-group batch shares {split.tolist()} (Theorem 2)")

    shape = ShapeConfig("train_lm", args.seq, args.batch, "train")
    data = SyntheticLMData(config, shape, seed=0, device=dev)
    opt = AdamWConfig(lr=1e-3, warmup_steps=min(20, args.steps // 3), total_steps=args.steps)
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(steps=args.steps, checkpoint_dir=ckpt,
                          checkpoint_every=max(args.steps // 2, 1),
                          log_every=max(args.steps // 10, 1))
        _, _, history = Trainer(model, data, opt, cfg).run()
    losses = [h["loss"] for h in history]
    print("loss trajectory:", np.round(losses, 3).tolist())
    print(f"final loss {losses[-1]:.3f} (entropy floor ~2.83)")
    print("kernel launches:", json.dumps(kernels.launch_counts()))
    if not losses[-1] < losses[0] - args.min_drop:
        print(f"train_lm: the loss fell {losses[0] - losses[-1]:.3f} nats, less than "
              f"{args.min_drop}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
