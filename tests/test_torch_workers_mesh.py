"""Port parity, the paper's ``workers`` mesh (``make_workers_mesh``;
``mesh=`` on ``coded_matvec``, ``DecodePipeline`` and
``end_to_end_coded_matvec``).

The reference runs its 8-device ``shard_map`` coded matvec once, in a
process of its own (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
as ``tests/test_coding.py`` does), on the 8-worker fleet ``[4, 4]`` /
``[4.0, 1.0]``, k 128, d 64: its A, x, generator and gathered products,
and (z, ok) for three masks (every worker, workers 6 and 7 erased, the
fast group erased: fewer than k rows) with the decode on the device and
on the host. The port's gloo worlds of 1, 2 and 4 ranks then start at
once, each rank a ``python -c`` process with a ``FileStore`` under the
test's directory, and run every case on those numpy inputs with the
reference's generator injected:

* z within 1e-4 of the reference's (``test_end_to_end_matches_reference``'s
  tolerance), ok exact, zeros exact where fewer than k rows survive;
* z and ok identical on every rank of a world (the master decodes and
  broadcasts);
* the gathered products of worlds 2 and 4 against world 1 within 1e-6 of
  max|products|, not bit for bit: on the CPU the plain matvec is one BLAS
  gemv, whose row sums change with the number of rows it is given (a
  rank's block of 100 or 50 rows against 200); on the card B1's narrow
  branch sums each row in one order whatever the block, and
  ``test_torch_workers_mesh_cuda.py`` holds it bit for bit;
* the refusals: W not divisible by R, a device other than the mesh's;
* no rank imports JAX or the reference;
* A~ sharded as the reference shards it: ``shard_packed``'s block on rank
  r is the whole array's slice of workers [r W/R, (r+1) W/R), exactly;
  with ``a=None`` off the master the same z and ok, both decodes; inside
  the coded matvec only the master calls ``make_generator`` and
  ``encode`` (counted in each rank process).

Every process has a timeout; a rank that overruns fails the fixture and
every rank is killed.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.coded_matvec import (
    DecodePipeline,
    coded_matvec,
    coded_matvec_block,
    end_to_end_coded_matvec,
    pack_coded_matrix,
    shard_packed,
)
from repro_torch.core.coding import make_generator
from repro_torch.core.planner import plan_deployment
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.launch.mesh import destroy_local_mesh, make_workers_mesh

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin",
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
       **{k: os.environ[k] for k in ("HOME", "TMPDIR") if k in os.environ}}
FLEET, K, D = ([4, 4], [4.0, 1.0], 1.0), 128, 64
#: erased workers per case; "insufficient" leaves 4 x 17 = 68 < k rows
ERASED = {"all": [], "stragglers": [6, 7], "insufficient": [0, 1, 2, 3]}
WORLDS = (1, 2, 4)
TIMEOUT = 300
TOL = dict(rtol=1e-4, atol=1e-4)

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import ClusterSpec, plan_deployment
from repro.core.coded_matvec import coded_matvec, end_to_end_coded_matvec, pack_coded_matrix
from repro.core.coding import make_generator

out_path, erased = sys.argv[1], json.loads(sys.argv[2])
plan = plan_deployment(ClusterSpec.make([4, 4], [4.0, 1.0], 1.0), k=128, scheme="optimal")
mesh = Mesh(np.array(jax.devices()).reshape(8), ("workers",))
a = jax.random.normal(jax.random.PRNGKey(0), (128, 64))
x = jax.random.normal(jax.random.PRNGKey(1), (64,))
g = make_generator(plan.n, 128)
packed, _ = pack_coded_matrix(g, a, plan)
out = {"a": a, "x": x, "g": g, "partials": coded_matvec(mesh, jnp.asarray(packed), x)}
for case, workers in erased.items():
    fin = np.ones(8, bool)
    fin[workers] = False
    for host in (0, 1):
        z, ok = end_to_end_coded_matvec(mesh, a, x, plan, finished_workers=fin,
                                        jit_decode=not host)
        out[f"z_{case}_{host}"], out[f"ok_{case}_{host}"] = z, ok
np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
"""

RANK = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
import repro_torch.core.coded_matvec as cm
from repro_torch.core.coded_matvec import (coded_matvec, coded_matvec_block,
                                           end_to_end_coded_matvec, pack_coded_matrix,
                                           shard_packed)
from repro_torch.core.planner import plan_deployment
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.launch.mesh import make_workers_mesh

world, rank, store, inputs, out_path = sys.argv[1:6]
world, rank, erased = int(world), int(rank), json.loads(sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
mesh = make_workers_mesh(device="cpu")
ref = np.load(inputs)
a, x, g = ref["a"], ref["x"], ref["g"]
plan = plan_deployment(ClusterSpec.make([4, 4], [4.0, 1.0], 1.0), 128)
packed, _ = pack_coded_matrix(torch.from_numpy(g), torch.from_numpy(a), plan)
out = {"partials": coded_matvec(packed, torch.from_numpy(x), mesh=mesh).numpy(),
       "mesh": json.dumps([mesh.mesh_dim_names, mesh.size()])}
per = 8 // world
block = shard_packed(packed if rank == 0 else None, plan, mesh)
out["block"] = block.numpy()
out["block_is_slice"] = torch.equal(block, packed[rank * per:(rank + 1) * per])
out["block_partials"] = coded_matvec_block(block, torch.from_numpy(x), mesh).numpy()
calls = {"make_generator": 0, "encode": 0}  # from here on, inside the coded matvec


def counted(name, fn):
    def call(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    return call


cm.make_generator = counted("make_generator", cm.make_generator)
cm.encode = counted("encode", cm.encode)
for case, workers in erased.items():
    fin = np.ones(8, bool)
    fin[workers] = False
    for host in (0, 1):
        z, ok = end_to_end_coded_matvec(a, x, plan, fin, g=g, host_decode=bool(host),
                                        device="cpu", mesh=mesh)
        if not host:
            out[f"oktype_{case}"] = json.dumps([str(ok.dtype), list(ok.shape)])
            z = z.numpy()
        out[f"z_{case}_{host}"], out[f"ok_{case}_{host}"] = z, bool(ok)
        # A on the master only
        z, ok = end_to_end_coded_matvec(a if rank == 0 else None, x, plan, fin, g=g,
                                        host_decode=bool(host), device="cpu", mesh=mesh)
        out[f"zmaster_{case}_{host}"] = z if host else z.numpy()
        out[f"okmaster_{case}_{host}"] = bool(ok)
out["calls"] = json.dumps(calls)
errors = {}
try:
    coded_matvec(packed[:world + 1], torch.from_numpy(x), mesh=mesh)
except ValueError as e:
    errors["split"] = str(e)
try:
    end_to_end_coded_matvec(a, x, plan, device="cuda", mesh=mesh)
except ValueError as e:
    errors["device"] = str(e)
five = plan_deployment(ClusterSpec.make([2, 3], [4.0, 1.0], 1.0), 128)  # W 5
try:  # every rank refuses before any collective: W % R, or the master without A~
    shard_packed(None, five, mesh)
except ValueError as e:
    errors["shard"] = str(e)
out["errors"] = json.dumps(errors)
dist.destroy_process_group()
out["jax"] = any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
np.savez(out_path, **out)
"""


def _wait_all(procs, what: str) -> None:
    """Wait for every process; on a timeout or a failure kill them all."""
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"{what}: {' '.join(p.args[-4:])}\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(path), json.dumps(ERASED)],
                            cwd=ROOT, env=ENV, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    _wait_all([proc], "the reference's 8-device run")
    return path, dict(np.load(path))


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """{(R, rank): that rank's results}: worlds 1, 2 and 4, started at once."""
    tmp = tmp_path_factory.mktemp("worlds")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r_), str(rank), str(tmp / f"store{r_}"),
         str(reference[0]), str(tmp / f"{r_}-{rank}.npz"), json.dumps(ERASED)],
        cwd=ROOT, env=ENV, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r_ in WORLDS for rank in range(r_)]
    _wait_all(procs, "a port rank")
    return {(r_, rank): dict(np.load(tmp / f"{r_}-{rank}.npz"))
            for r_ in WORLDS for rank in range(r_)}


CASES = [(case, host) for case in ERASED for host in (0, 1)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,host", CASES)
def test_z_matches_reference_8_device_run(worlds, reference, world, case, host):
    want = reference[1]
    got = worlds[world, 0]
    assert got[f"ok_{case}_{host}"] == want[f"ok_{case}_{host}"] == (case != "insufficient")
    np.testing.assert_allclose(got[f"z_{case}_{host}"], want[f"z_{case}_{host}"], **TOL)
    if case == "insufficient":
        np.testing.assert_array_equal(got[f"z_{case}_{host}"], np.zeros(K, np.float32))
    else:
        a, x = want["a"], want["x"]
        np.testing.assert_allclose(got[f"z_{case}_{host}"], a @ x, **TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case,host", CASES)
def test_z_and_ok_identical_on_every_rank(worlds, world, case, host):
    first = worlds[world, 0]
    for rank in range(1, world):
        got = worlds[world, rank]
        assert got[f"ok_{case}_{host}"] == first[f"ok_{case}_{host}"]
        np.testing.assert_array_equal(got[f"z_{case}_{host}"], first[f"z_{case}_{host}"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("host", [0, 1])
def test_insufficient_survivors_zeroed_on_every_rank(worlds, world, host):
    for rank in range(world):
        got = worlds[world, rank]
        assert not got[f"ok_insufficient_{host}"]
        np.testing.assert_array_equal(got[f"z_insufficient_{host}"], np.zeros(K, np.float32))


@pytest.mark.parametrize("world", WORLDS)
def test_gathered_products_match_world_one_and_reference(worlds, reference, world):
    """Every rank holds the global (W, max_load) products, in worker order."""
    one = worlds[1, 0]["partials"]
    np.testing.assert_allclose(one, reference[1]["partials"], rtol=1e-5, atol=1e-5)
    for rank in range(world):
        got = worlds[world, rank]["partials"]
        assert got.shape == one.shape == (8, 25)
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-6 * np.abs(one).max())
        np.testing.assert_array_equal(got, worlds[world, 0]["partials"])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_meshes_and_imports_no_jax(worlds, world):
    for rank in range(world):
        got = worlds[world, rank]
        assert json.loads(str(got["mesh"])) == [["workers"], world]
        assert not bool(got["jax"])
        for case in ERASED:  # the device decode's ok: a 0-d bool, as with no mesh
            assert json.loads(str(got[f"oktype_{case}"])) == ["torch.bool", []]


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_on_every_rank(worlds, world):
    """W % R != 0 names both; a device other than the mesh's is refused."""
    for rank in range(world):
        errors = json.loads(str(worlds[world, rank]["errors"]))
        assert "cpu mesh" in errors["device"] and "cuda" in errors["device"]
        if world == 1:
            assert "split" not in errors
        else:
            assert errors["split"].startswith(f"{world + 1} workers do not split over "
                                              f"{world} ranks")


@pytest.mark.parametrize("world", WORLDS)
def test_shard_packed_block_is_the_whole_arrays_slice(worlds, world):
    """The master scatters; rank r's block equals workers [r W/R, (r+1) W/R)
    of the whole packed A~, exactly, and its products all-gather into the
    whole array's."""
    whole = np.concatenate([worlds[world, rank]["block"] for rank in range(world)])
    for rank in range(world):
        got = worlds[world, rank]
        assert got["block"].shape == (8 // world, 25, D)
        assert bool(got["block_is_slice"])
        np.testing.assert_array_equal(got["block_partials"], got["partials"])
    np.testing.assert_array_equal(whole, worlds[1, 0]["block"])


@pytest.mark.parametrize("world", WORLDS)
def test_only_the_master_draws_the_generator_and_encodes(worlds, world):
    """Inside the coded matvec of 12 end-to-end calls a rank (6 of them with
    A on the master only): the master draws G and runs B3's encode once a
    call, every other rank never."""
    for rank in range(world):
        calls = json.loads(str(worlds[world, rank]["calls"]))
        n = 12 if rank == 0 else 0
        assert calls == {"make_generator": n, "encode": n}, (world, rank)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,host", CASES)
def test_a_on_the_master_only(worlds, reference, world, case, host):
    """Non-masters pass ``a=None``: the same z and ok as with A on every
    rank (the device decode bit for bit; the host decode's least squares
    within the reference tolerance), on every rank, the host decode
    included."""
    want = reference[1]
    for rank in range(world):
        got = worlds[world, rank]
        assert got[f"okmaster_{case}_{host}"] == want[f"ok_{case}_{host}"]
        np.testing.assert_allclose(got[f"zmaster_{case}_{host}"], want[f"z_{case}_{host}"],
                                   **TOL)
        if not host:
            np.testing.assert_array_equal(got[f"zmaster_{case}_{host}"],
                                          got[f"z_{case}_{host}"])
        np.testing.assert_array_equal(got[f"zmaster_{case}_{host}"],
                                      worlds[world, 0][f"zmaster_{case}_{host}"])


@pytest.mark.parametrize("world", WORLDS)
def test_shard_packed_refusals_on_every_rank(worlds, world):
    for rank in range(world):
        error = json.loads(str(worlds[world, rank]["errors"]))["shard"]
        if world == 1:
            assert error.startswith("the master (rank 0 of the axis) passes the packed A~")
        else:
            assert error.startswith(f"5 workers do not split over {world} ranks")


def test_block_path_on_a_world_of_one():
    """In this process: on a world of one the master's block is the whole
    packed array, its products are ``coded_matvec``'s, and the refusals."""
    plan = plan_deployment(ClusterSpec.make(*FLEET), 64)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    gen = make_generator(plan.n, 64, seed=0, device="cpu")
    packed, row_of = pack_coded_matrix(gen, a, plan)
    fin = torch.ones(plan.num_workers, dtype=torch.bool)
    mesh = make_workers_mesh(device="cpu")
    try:
        block = shard_packed(packed, plan, mesh)
        assert block is packed
        assert torch.equal(coded_matvec_block(block, x, mesh), coded_matvec(packed, x))
        z, ok = DecodePipeline(gen, row_of, mesh=mesh).on_block(block, x, fin)
        want, want_ok = DecodePipeline(gen, row_of)(packed, x, fin)
        assert bool(ok) and bool(want_ok) and torch.equal(z, want)
        with pytest.raises(ValueError, match="the master .* passes the packed A~"):
            shard_packed(None, plan, mesh)
        with pytest.raises(ValueError, match=r"the plan packs \(8, 13, d\)"):
            shard_packed(packed[:, :5], plan, mesh)
        with pytest.raises(ValueError, match="in torch.float64"):
            shard_packed(packed.double(), plan, mesh)
        with pytest.raises(ValueError, match="the master .* decodes"):
            DecodePipeline(None, None, mesh=mesh, k=64).on_block(block, x, fin)
        with pytest.raises(ValueError, match="give a mesh and k"):
            DecodePipeline(None, None)
    finally:
        destroy_local_mesh()


def test_workers_mesh_on_a_world_of_one():
    """In this process: a gloo world of one rank, started and ended by the
    mesh module; with it the products and the decode are the no-mesh ones."""
    plan = plan_deployment(ClusterSpec.make(*FLEET), 64)
    rng = np.random.default_rng(7)
    a = rng.standard_normal((64, 16)).astype(np.float32)
    x = rng.standard_normal(16).astype(np.float32)
    fin = np.ones(plan.num_workers, bool)
    fin[-1] = False
    mesh = make_workers_mesh(device="cpu")
    try:
        assert mesh.mesh_dim_names == ("workers",) and mesh.size() == 1
        assert tuple(mesh.shape) == (1,) and mesh.device_type == "cpu"
        assert torch.distributed.get_backend() == "gloo"
        z, ok = end_to_end_coded_matvec(a, x, plan, fin, device="cpu", mesh=mesh)
        want, want_ok = end_to_end_coded_matvec(a, x, plan, fin, device="cpu")
        assert bool(ok) and bool(want_ok) and ok.dtype == torch.bool and ok.dim() == 0
        assert torch.equal(z, want)
        packed = torch.from_numpy(rng.standard_normal((6, 5, 16)).astype(np.float32))
        assert torch.equal(coded_matvec(packed, torch.from_numpy(x), mesh=mesh),
                           coded_matvec(packed, torch.from_numpy(x)))
        with pytest.raises(ValueError, match="cpu mesh"):
            end_to_end_coded_matvec(a, x, plan, fin, device="cuda", mesh=mesh)
        with pytest.raises(ValueError, match="the mesh on cpu"):
            coded_matvec(packed.to("meta"), torch.empty(16, device="meta"), mesh=mesh)
    finally:
        destroy_local_mesh()
    assert not torch.distributed.is_initialized()
