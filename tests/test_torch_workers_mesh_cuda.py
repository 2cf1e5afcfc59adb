"""The workers mesh on the card: two gloo ranks sharing one card against
one process, bit for bit.

Marked ``cuda``: it skips on a machine without CUDA. Run it on the card
with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_workers_mesh_cuda.py

The quickstart's 8-worker plan (``[4, 4]`` / ``[4.0, 1.0]``), k 2,000,
d 1,024, seeded numpy A and x, workers 6 and 7 erased. Each rank is a
``python -c`` process (gloo over a ``FileStore``: NCCL takes one card a
rank). Rank 0, the master, alone reads A, draws G, encodes (B3) and packs,
then scatters rank 1 its 4 workers' block; rank 1 passes ``a=None`` and
allocates only that block. Each rank runs B1's narrow branch on its block
and all-gathers the products; rank 0 decodes and broadcasts. The narrow
branch sums each row in one order whatever the block, and the master's
solve sees the same products as one process's, so the gathered products
and z equal the one-process run's bit for bit, on both ranks, with one B1
launch a rank and B3 once, on the master. Rank 1's peak allocated during
the call stays within its block + 64 MiB.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels as kernels
from repro_torch.core.coded_matvec import (
    coded_matvec,
    end_to_end_coded_matvec,
    pack_coded_matrix,
)
from repro_torch.core.coding import make_generator
from repro_torch.core.planner import plan_deployment
from repro_torch.core.runtime_model import ClusterSpec

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
K, D, RANKS, TIMEOUT = 2_000, 1_024, 2, 300

RANK = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
import repro_torch.kernels as kernels
from repro_torch.core.coded_matvec import (coded_matvec, end_to_end_coded_matvec,
                                           pack_coded_matrix)
from repro_torch.core.coding import make_generator
from repro_torch.core.planner import plan_deployment
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.launch.mesh import make_workers_mesh

world, rank, store, inputs, out_path = sys.argv[1:6]
world, rank = int(world), int(rank)
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
mesh = make_workers_mesh()
ref = np.load(inputs)
plan = plan_deployment(ClusterSpec.make([4, 4], [4.0, 1.0]), int(ref["k"]))
kernels.reset_launch_counts()
torch.cuda.reset_peak_memory_stats()
base = torch.cuda.memory_allocated()
z, ok = end_to_end_coded_matvec(ref["a"] if rank == 0 else None, ref["x"], plan, ref["fin"],
                                seed=0, mesh=mesh)
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated() - base
counts = kernels.launch_counts()
g = make_generator(plan.n, plan.k, seed=0)
packed, _ = pack_coded_matrix(g, torch.from_numpy(ref["a"]).cuda(), plan)
partials = coded_matvec(packed, torch.from_numpy(ref["x"]).cuda(), mesh=mesh)
backend = dist.get_backend()
dist.destroy_process_group()
np.savez(out_path, z=z.cpu().numpy(), ok=bool(ok), partials=partials.cpu().numpy(),
         counts=json.dumps(counts), backend=backend, peak=peak,
         block_bytes=plan.num_workers // world * plan.max_load * ref["a"].shape[1] * 4)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's z, ok, products; each rank's results)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()  # once here, not once a rank
    tmp = tmp_path_factory.mktemp("workers")
    rng = np.random.default_rng(11)
    plan = plan_deployment(ClusterSpec.make([4, 4], [4.0, 1.0]), K)
    fin = np.ones(plan.num_workers, bool)
    fin[[6, 7]] = False
    a = rng.standard_normal((K, D)).astype(np.float32)
    x = rng.standard_normal(D).astype(np.float32)
    np.savez(tmp / "in.npz", a=a, x=x, fin=fin, k=K)
    z, ok = end_to_end_coded_matvec(a, x, plan, fin, seed=0)
    packed, _ = pack_coded_matrix(make_generator(plan.n, K, seed=0), torch.from_numpy(a).cuda(),
                                  plan)
    one = dict(z=z.cpu().numpy(), ok=bool(ok),
               partials=coded_matvec(packed, torch.from_numpy(x).cuda()).cpu().numpy())
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(RANKS), str(r),
                               str(tmp / "store"), str(tmp / "in.npz"), str(tmp / f"{r}.npz")],
                              cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(RANKS)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return one, [dict(np.load(tmp / f"{r}.npz")) for r in range(RANKS)]


def test_two_gloo_ranks_bit_identical_to_one_process(runs):
    one, ranks = runs
    assert one["ok"]
    for got in ranks:
        assert bool(got["ok"]) and str(got["backend"]) == "gloo"
        np.testing.assert_array_equal(got["partials"], one["partials"])
        np.testing.assert_array_equal(got["z"], one["z"])


def test_one_b1_and_one_b3_launch_a_rank(runs):
    """One B1 launch a rank; B3 once in the world, on the master."""
    for rank, got in enumerate(runs[1]):
        counts = json.loads(str(got["counts"]))
        assert (counts["coded_matvec"], counts["mds_encode"]) == (1, int(rank == 0))


def test_non_master_peak_within_its_block(runs):
    """Rank 1 never holds G, A or the whole A~: its peak allocated during
    the call is its (4, max_load, 1,024) float32 block + at most 64 MiB."""
    got = runs[1][1]
    assert int(got["block_bytes"]) <= int(got["peak"]) <= int(got["block_bytes"]) + 64 * 2**20


def test_one_process_decode_recovers_a_x(runs):
    """The baseline itself decodes: z within the f32 solve's error of A x."""
    one, _ = runs
    rng = np.random.default_rng(11)
    a = rng.standard_normal((K, D)).astype(np.float32)
    x = rng.standard_normal(D).astype(np.float32)
    want = a.astype(np.float64) @ x.astype(np.float64)
    assert np.abs(one["z"] - want).max() <= 1e-3 * np.abs(want).max()
