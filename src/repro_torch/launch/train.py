"""Training entry point: ``python -m repro_torch.launch.train --arch qwen3-0.6b ...``

Counterpart of ``repro/launch/train.py``: trains the port's model (any
registered config, every family; vlm and audio batches carry extras, so
their coded training exits non-zero with the reference's message at the
first step) on the synthetic pipeline, on the card unless ``--device
cpu``. Supports checkpoint/restart (``--resume`` picks up the latest
step) and coded execution: ``--hetero-groups`` plans
a straggler fleet and runs gradient-coded training (``--scheme``, any
registered allocation scheme, ``grad_coding`` by default). ``--scenario``
drifts the true fleet over the run, ``--adapt-every`` replans against it
with an ``AdaptiveController`` (``--adapt-threshold`` its hysteresis),
``--measure-times`` feeds the controller the steps' measured wall times
through a ``RoundClock``, and ``--bucket-quantum`` quantizes the loads
so that a replan within the bucket capacity keeps the coded step.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import scheme_names
from repro_torch.data import SyntheticLMData
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.compile_cache import enable_persistent_cache
from repro_torch.runtime.train_loop import TrainConfig, Trainer, heterogeneous_batch_split
from repro_torch.sim import scenario_names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-sized smoke variant of the arch")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --checkpoint-dir")
    ap.add_argument("--telemetry", default=None)
    ap.add_argument("--hetero-groups", default=None,
                    help="straggler fleet as N:mu[:bandwidth] groups, e.g. "
                         "'4:2.0,4:0.5': turns on coded training against it")
    ap.add_argument("--scheme", default=None, choices=scheme_names(),
                    help="allocation scheme for coded training "
                         "(default: grad_coding; requires --hetero-groups)")
    ap.add_argument("--partitions", type=int, default=None,
                    help="gradient partitions k (must divide --batch; "
                         "default: one per batch row)")
    ap.add_argument("--deadline-safety", type=float, default=None,
                    help="per-round deadline = expected latency x this (default 3.0)")
    ap.add_argument("--scenario", default=None, choices=scenario_names(),
                    help="cluster-dynamics scenario perturbing the TRUE fleet over the "
                         "run (requires --hetero-groups); pair with --adapt-every to "
                         "close the loop")
    ap.add_argument("--adapt-every", type=int, default=None,
                    help="closed-loop control cadence: fold straggler estimates and "
                         "maybe replan every R steps (requires --hetero-groups)")
    ap.add_argument("--adapt-threshold", type=float, default=None,
                    help="hysteresis: replan only when the estimated latency improves "
                         "by this fraction (default 0.05)")
    ap.add_argument("--bucket-quantum", type=int, default=None,
                    help="quantize integer partition loads to this multiple: replans "
                         "within the admitted bucket capacity keep the coded step")
    ap.add_argument("--measure-times", action="store_true",
                    help="time each coded step with a RoundClock and adapt from the "
                         "measured wall times instead of simulated ones (requires "
                         "--hetero-groups)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain paths)")
    args = ap.parse_args(argv)
    if args.hetero_groups is None:
        coded_flags = [
            name for name, v in (("--scheme", args.scheme),
                                 ("--partitions", args.partitions),
                                 ("--deadline-safety", args.deadline_safety),
                                 ("--scenario", args.scenario),
                                 ("--adapt-every", args.adapt_every),
                                 ("--adapt-threshold", args.adapt_threshold),
                                 ("--bucket-quantum", args.bucket_quantum),
                                 ("--measure-times", args.measure_times or None))
            if v is not None
        ]
        if coded_flags:
            raise SystemExit(f"{', '.join(coded_flags)} require --hetero-groups "
                             f"(coded training needs a fleet to plan against)")

    # a kernel built once is loaded by every later process (build cache)
    enable_persistent_cache()

    config = get_arch(args.arch)
    if args.reduced:
        config = config.reduced()
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    cluster = None
    if args.hetero_groups:
        cluster = ClusterSpec.parse(args.hetero_groups)
        split = heterogeneous_batch_split(cluster, args.batch)
        print(f"heterogeneity-aware batch split (Theorem 2): {split.tolist()} "
              f"over groups {[(g.num_workers, g.mu) for g in cluster.groups]}")
    if args.checkpoint_dir and not args.resume:
        from repro_torch.checkpoint import latest_step

        last = latest_step(args.checkpoint_dir)
        if last is not None:
            raise SystemExit(f"{args.checkpoint_dir} already has step_{last}; "
                             f"pass --resume to continue it")

    model = Model(config, device=args.device)
    data = SyntheticLMData(config, shape, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1))
    cfg = TrainConfig(
        steps=args.steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        telemetry_path=args.telemetry,
        cluster=cluster,
        scheme=args.scheme or "grad_coding",
        partitions=args.partitions,
        deadline_safety=3.0 if args.deadline_safety is None else args.deadline_safety,
        scenario=args.scenario,
        adapt_every=args.adapt_every,
        adapt_threshold=0.05 if args.adapt_threshold is None else args.adapt_threshold,
        bucket_quantum=args.bucket_quantum,
        measure_times=args.measure_times,
    )
    trainer = Trainer(model, data, opt_cfg, cfg)
    print(f"training {config.name}: {model.param_count():,} params on {model.device}")
    if trainer.executor is not None:
        plan = trainer.executor.plan
        print(f"coded training: scheme={trainer.executor.scheme.name} "
              f"k={trainer.partitions} n={plan.n} "
              f"loads={plan.loads_per_worker.tolist()} "
              f"deadline={trainer.executor.deadline:.4f}")
    if trainer.controller is not None:
        print(f"adaptive control: every {cfg.adapt_every} steps, "
              f"threshold {cfg.adapt_threshold:.0%}"
              + (f", scenario={args.scenario}" if args.scenario else ""))
    try:
        _, _, history = trainer.run()
    except NotImplementedError as err:  # coded training of a batch with extras
        raise SystemExit(str(err)) from None
    if history:
        first, last = history[0], history[-1]
        print(f"loss {first['loss']:.4f} -> {last['loss']:.4f} ({cfg.steps} steps)")
        if trainer.executor is not None:
            skipped = sum(h.get("skipped", 0.0) for h in history)
            print(f"coded rounds logged: {len(history)}, skipped steps "
                  f"among them: {int(skipped)}")
    if trainer.clock is not None:
        ck = trainer.clock
        unit = "-" if ck.unit_s is None else f"{ck.unit_s:.3e}"
        print(f"measured: {ck.fed}/{ck.rounds} rounds fed, unit_s={unit}")
    if trainer.controller is not None:
        ctl = trainer.controller
        replanned = [d for d in ctl.decisions if d.replanned]
        print(f"controller: {len(ctl.decisions)} decisions, {len(replanned)} replans "
              f"(rounds {[d.round for d in replanned]}), "
              f"final deadline {trainer.executor.deadline:.4f}")
    return model


if __name__ == "__main__":
    main()
