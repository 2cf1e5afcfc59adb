"""Quickstart through the PyTorch port: the paper's optimal load allocation.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Define a heterogeneous cluster (groups of workers with different
   straggling parameters mu and shifts alpha).
2. Compute the paper's optimal allocation (Theorem 2) and the optimal
   (n*, k) MDS code.
3. Monte-Carlo the actual latency and compare with the lower bound T*
   and with the uniform baseline.
4. Run one real coded matvec end to end on the workers mesh of this
   process's world: encode (the B3 kernel) -> distribute -> compute (B1's
   matvec over each rank's workers) -> straggler erasure -> decode at the
   master. Exits non-zero unless the decode recovers A x.

The counterpart of ``examples/quickstart.py``; on the card unless
``--device cpu``. Started alone it is a world of one rank; started by
``torchrun`` (which sets ``WORLD_SIZE``) the 8 workers of step 4 split
over its ranks, which join over gloo (ranks may share one card):

    PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_quickstart.py
"""
import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.kernels as kernels  # noqa: E402
from repro_torch.core.allocation import optimal_allocation, uniform_given_n  # noqa: E402
from repro_torch.core.coded_matvec import end_to_end_coded_matvec  # noqa: E402
from repro_torch.core.planner import plan_deployment  # noqa: E402
from repro_torch.core.runtime_model import ClusterSpec  # noqa: E402
from repro_torch.core.simulator import expected_latency  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import destroy_local_mesh, make_workers_mesh  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k", type=int, default=20_000, help="rows of A for the allocation")
    ap.add_argument("--trials", type=int, default=8_000, help="Monte-Carlo trials")
    ap.add_argument("--matvec-k", type=int, default=96, help="rows of the coded matvec")
    ap.add_argument("--matvec-d", type=int, default=128, help="columns of the coded matvec")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ------------------------------------------------------------ step 1
    # Three groups: 40 fast, 60 medium, 100 slow workers.
    cluster = ClusterSpec.make(num_workers=[40, 60, 100], mus=[8.0, 2.0, 0.5], alphas=1.0)

    # ------------------------------------------------------------ step 2
    plan = optimal_allocation(cluster, args.k)
    print("optimal per-group loads l*_j:", np.round(plan.loads, 1).tolist())
    print(f"optimal (n*, k) MDS code: n* = {plan.n:.0f}, rate = {plan.rate:.3f}")
    print(f"lower-bound expected latency T* = {plan.t_star:.5f}")

    # ------------------------------------------------------------ step 3
    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    mc = expected_latency(gen(), cluster, plan, num_trials=args.trials)
    uni = expected_latency(gen(), cluster, uniform_given_n(cluster, args.k, plan.n),
                           num_trials=args.trials)
    print(f"Monte-Carlo latency (proposed): {mc:.5f}  ({mc / plan.t_star:.3f} x T*)")
    print(f"Monte-Carlo latency (uniform, same code): {uni:.5f} "
          f"({100 * (1 - mc / uni):.1f}% slower than proposed)")

    # ------------------------------------------------------------ step 4
    k, d = args.matvec_k, args.matvec_d
    small = ClusterSpec.make([4, 4], [4.0, 1.0])
    dep = plan_deployment(small, k=k)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((k, d)).astype(np.float32)
    x = rng.standard_normal(d).astype(np.float32)
    finished = np.ones(dep.num_workers, dtype=bool)
    finished[-2:] = False  # two slow-group stragglers miss the deadline
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if launched:
        dist.init_process_group("gloo")  # the launcher's rendezvous (env://)
    mesh = make_workers_mesh(device=dev.type)
    try:
        y, ok = end_to_end_coded_matvec(a, x, dep, finished, device=dev, mesh=mesh)
    finally:
        if launched:
            dist.destroy_process_group()
        destroy_local_mesh()
    want = a.astype(np.float64) @ x.astype(np.float64)
    err = float(np.max(np.abs(y.cpu().numpy().astype(np.float64) - want)))
    scale = float(np.max(np.abs(want)))
    ok = bool(ok)
    print(f"workers mesh: {dep.num_workers} workers over {mesh.size()} rank(s)")
    print(f"coded matvec with 2 erasures: recovered={ok}, max|err|={err:.2e} "
          f"(max|A x| {scale:.2e})")
    print("kernel launches:", json.dumps(kernels.launch_counts()))
    if not (ok and err <= 1e-3 * scale):
        print("quickstart: the coded matvec did not recover A x", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
