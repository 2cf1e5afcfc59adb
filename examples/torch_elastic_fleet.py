"""Fleet elasticity + straggler drift through the PyTorch port: the
closed-form re-planning loop.

    PYTHONPATH=src python examples/torch_elastic_fleet.py [--device cpu]

Simulates a long-running coded-computation service where
  * worker speeds DRIFT (mu drops mid-run for one group),
  * a new fast group JOINS,
and shows the tracker's online (mu, alpha) estimates feeding Theorem 2
re-plans — each re-plan is O(G) closed-form, no iterative optimizer —
with the achieved latency tracking the moving optimum T*. The round
times are drawn on the device. Exits non-zero unless both replans
happen and the join lowers T*.

The counterpart of ``examples/elastic_fleet.py``; on the card unless
``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.allocation import optimal_allocation  # noqa: E402
from repro_torch.core.runtime_model import (  # noqa: E402
    ClusterSpec,
    GroupSpec,
    sample_worker_times,
)
from repro_torch.core.simulator import expected_latency  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    ElasticController,
    StragglerTracker,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trials", type=int, default=4_000, help="Monte-Carlo trials")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 50_000

    cluster = ClusterSpec.make([30, 50], [6.0, 1.5])
    ctl = ElasticController(cluster, k)
    tracker = StragglerTracker(cluster, forget=0.8, fail_after=3)
    print(f"t=0  plan loads={np.unique(ctl.plan.loads_per_worker).tolist()} "
          f"n={ctl.plan.n} T*={ctl.plan.t_star:.5f}")

    def one_round(true_cluster, plan):
        loads = torch.as_tensor(np.asarray(plan.loads_per_worker, float), device=dev)
        mus = torch.as_tensor(np.concatenate(
            [np.full(g.num_workers, g.mu) for g in true_cluster.groups]), device=dev)
        alphas = torch.as_tensor(np.concatenate(
            [np.full(g.num_workers, g.alpha) for g in true_cluster.groups]), device=dev)
        t = sample_worker_times(gen, loads, mus, alphas, k, 1)[0]
        tracker.observe_round(t.cpu().numpy(), np.asarray(plan.loads_per_worker), k)

    # phase 1: steady state, estimates converge to the truth
    for _ in range(30):
        one_round(cluster, ctl.plan)
    est = tracker.estimated_cluster()
    print(f"t=30 estimated mu: {[round(g.mu, 2) for g in est.groups]} (truth: [6.0, 1.5])")

    # phase 2: group 2 degrades (mu 1.5 -> 0.6) -> tracker notices -> replan
    degraded = ClusterSpec.make([30, 50], [6.0, 0.6])
    for _ in range(60):
        one_round(degraded, ctl.plan)
    plan2 = ctl.on_estimates_update(tracker)
    print(f"t=90 after drift: estimated mu = "
          f"{[round(g.mu, 2) for g in tracker.estimated_cluster().groups]}, "
          f"replanned T* = {plan2.t_star:.5f} (replans={ctl.replans})")

    # phase 3: a fast group of 20 joins; instant O(G) replan
    grown = ClusterSpec(tracker.estimated_cluster().groups + (GroupSpec(20, 10.0),))
    plan3 = ctl.on_membership_change(grown)
    print(f"t=91 +20 fast workers: T* {plan2.t_star:.5f} -> {plan3.t_star:.5f} "
          f"({plan2.t_star / plan3.t_star:.2f}x faster, replans={ctl.replans})")

    # sanity: achieved latency under the final plan ~ its lower bound
    ach = expected_latency(gen, grown, optimal_allocation(grown, k), num_trials=args.trials)
    print(f"achieved latency: {ach:.5f} vs bound {plan3.t_star:.5f} "
          f"({ach / plan3.t_star:.3f}x)")
    if ctl.replans != 2 or not plan3.t_star < plan2.t_star:
        print("elastic_fleet: expected two replans and a lower T* after the join",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
