"""The port's dry-run against the reference's closed forms, and its counter.

Shape cells, ``model_flops``, ``analytic_inner_costs`` and
``coded_head_record`` of ``repro_torch.launch.dryrun`` against
``repro.launch.dryrun``; the per-device split on one card and on the production mesh; the CLI in
a subprocess (the counter itself: ``test_torch_dryrun_count.py``).

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 placeholder
devices: the fixture initialises JAX's backend first (so the flag does
nothing in this process) and restores the variable after, so that no
later subprocess of this worker inherits it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import make_scheme, scheme_names
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MeshShape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMES = [
    ("optimal", {}),
    ("optimal_per_row", {}),
    ("uniform_n", {"n": 1.4 * 594}),
    ("uniform_r", {"r": 4}),
    ("uniform_r_group_code", {"r": 2}),
    ("reisizadeh", {}),
    ("uncoded", {}),
    ("grad_coding", {}),
    ("grad_coding_per_row", {}),
    ("comm_aware", {"upload": 1.0, "download": 0.5}),
    ("comm_uniform", {"upload": 0.5, "download": 1.0}),
]
GROUPS = "6:8.0:16.0,6:0.7:4.0"


@pytest.fixture(scope="module")
def ref():
    import jax

    jax.devices()  # the backend exists before the import sets the flag
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro import configs as rcfg
        from repro.launch import dryrun as rdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return rcfg, rdry


def test_shape_cells_match_reference(ref):
    rcfg, _ = ref
    assert [dataclasses.asdict(s) for s in tcfg.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in rcfg.ALL_SHAPES]
    assert {n: dataclasses.asdict(s) for n, s in tcfg.SHAPES_BY_NAME.items()} == \
        {n: dataclasses.asdict(s) for n, s in rcfg.SHAPES_BY_NAME.items()}
    for name in ARCHS:
        assert [s.name for s in tcfg.shapes_for(get_arch(name))] == \
            [s.name for s in rcfg.shapes_for(rcfg.get_arch(name))], name
    assert [(c.name, s.name) for c, s in tcfg.all_cells()] == \
        [(c.name, s.name) for c, s in rcfg.all_cells()]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_and_inner_costs_match_reference(ref, arch):
    """1e-12 relative, every shape cell of the arch."""
    rcfg, rdry = ref
    for shape in tcfg.shapes_for(get_arch(arch)):
        rshape = rcfg.SHAPES_BY_NAME[shape.name]
        want = rdry.model_flops(rcfg.get_arch(arch), rshape)
        np.testing.assert_allclose(D.model_flops(get_arch(arch), shape), want, rtol=1e-12)
        got = D.analytic_inner_costs(get_arch(arch), shape)
        want = rdry.analytic_inner_costs(rcfg.get_arch(arch), rshape)
        for key in ("flops", "bytes"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


def test_scheme_list_covers_the_registry():
    assert {name for name, _ in SCHEMES} == set(scheme_names())


@pytest.mark.parametrize("name,params", SCHEMES)
def test_coded_head_record_matches_reference(ref, name, params):
    """Integers exact, t_star 1e-9; the deadline 1e-9 where T* is analytic,
    else each package's Monte-Carlo estimate within 5% (the executor rows
    of the parity table)."""
    rcfg, rdry = ref
    from repro.core.schemes import make_scheme as ref_make_scheme

    for arch in ("qwen3-0.6b", "whisper-tiny"):
        got = D.coded_head_record(get_arch(arch), ClusterSpec.parse(GROUPS),
                                  scheme=make_scheme(name, **params))
        want = rdry.coded_head_record(rcfg.get_arch(arch), rdry._parse_cluster(GROUPS),
                                      scheme=ref_make_scheme(name, **params))
        assert set(got) == set(want)
        for key in ("scheme", "block_rows", "kb", "nb", "workers", "max_blocks_per_worker"):
            assert got[key] == want[key], key
        np.testing.assert_allclose(got["rate"], want["rate"], rtol=1e-12)
        if np.isnan(want["t_star"]):
            assert np.isnan(got["t_star"])
        else:
            np.testing.assert_allclose(got["t_star"], want["t_star"], rtol=1e-9)
        if np.isfinite(want["t_star"]) and want["t_star"] > 0:
            np.testing.assert_allclose(got["deadline"], want["deadline"], rtol=1e-9)
        else:
            assert abs(got["deadline"] - want["deadline"]) / want["deadline"] < 0.05


def test_per_device_equals_global_on_one_card():
    """On a 1 x 1 mesh nothing is split: per-device FLOPs and bytes are the
    global count's."""
    c = get_arch("qwen3-0.6b").reduced()
    shape = tcfg.ShapeConfig("t", 64, 4, "train")
    mesh = MeshShape({"data": 1, "model": 1})
    rec = D.roofline_cell(c, shape, mesh=mesh, verbose=False)
    assert rec["chips"] == 1
    assert rec["hlo_flops_per_device"] == rec["flops_global"]
    assert rec["hlo_bytes_per_device"] == rec["bytes_global_unfused"]
    assert rec["collective_bytes_per_device"]["total"] == 0


def test_split_rules_on_the_production_mesh():
    """qwen3-0.6b train_4k on 16 x 16: every product is split 256 ways
    (the batch 16, ``model`` 16: all its weights divide), so the FLOPs per
    device are the global count's / 256; on 2 x 16 x 16, / 512."""
    c, shape = get_arch("qwen3-0.6b"), tcfg.SHAPES_BY_NAME["train_4k"]
    single, multi = D.roofline_cells(c, shape, verbose=False)
    assert single["chips"] == 256 and multi["chips"] == 512
    np.testing.assert_allclose(single["hlo_flops_per_device"],
                               single["flops_global"] / 256, rtol=1e-12)
    np.testing.assert_allclose(multi["hlo_flops_per_device"],
                               multi["flops_global"] / 512, rtol=1e-12)
    # the issue's sizing: projections, attention and B4 ~ 9.3e15 globally
    assert 8.5e15 < single["flops_global"] < 9.5e15
    assert single["kernels"]["fused_ce_fwd"]["flops"] == 2.0 * 256 * 4096 * 151_936 * 1024
    assert single["fits"] and single["bottleneck"] in ("t_compute", "t_memory",
                                                       "t_collective")


def test_cli_whisper_prefill_record_has_reference_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
         "--shape", "prefill_32k", "--mesh", "single", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads((tmp_path / "whisper-tiny_prefill_32k_single.json").read_text())
    assert rec["chips"] == 256
    assert rec["hlo_flops_per_device"] > 0
    assert rec["t_compute"] > 0 and rec["t_memory"] > 0
    assert rec["bottleneck"] in ("t_compute", "t_memory", "t_collective")
    # the reference's record keys (dryrun_cell's and roofline_cell's)
    assert {"arch", "shape", "kind", "scan_layers", "mesh", "chips", "compile_seconds",
            "hlo_flops_per_device", "hlo_bytes_per_device", "inner_scan_correction",
            "flops_per_device_corrected", "bytes_per_device_corrected",
            "collective_bytes_per_device", "memory_analysis", "model_flops", "t_compute",
            "t_memory", "t_collective", "useful_flops_ratio", "bottleneck",
            "roofline_fraction", "method"} <= set(rec)
    assert set(rec["collective_bytes_per_device"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
        "count", "total"}


def test_cli_refuses_scan_layers_and_attaches_the_coded_head(tmp_path):
    with pytest.raises(SystemExit):
        D.main(["--scan-layers"])
    D.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(tmp_path), "--coded-groups", "6:2.0,6:0.5"])
    rec = json.loads((tmp_path / "whisper-tiny_decode_32k_single.json").read_text())
    head = rec["coded_lm_head"]
    assert head["kernels"]["coded_matvec"]["flops"] == \
        2.0 * head["nb"] * head["kb"] * 128 * head["block_rows"]
    assert rec["method"] == "full"
