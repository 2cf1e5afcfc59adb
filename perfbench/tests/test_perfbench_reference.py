"""The references against the port at reduced sizes, and the controls the
comparison must reject: the reference in float8 (serve) or from TF32
operands (Path M), and a port whose weights lost precision."""
from __future__ import annotations

import dataclasses
import io
import json

import pytest
import torch

from perfbench import readings, run, weights
from perfbench.reference import llama
from perfbench.reference import matvec as ref_matvec
from perfbench.tests import tinybench


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinybench.make_root(tmp_path_factory.mktemp("bench"))


def test_reference_logits_equal_the_ports_in_float32():
    from repro_torch.models.model import Model

    drv = run.load_module(run.HERE / "drivers" / "serve.py")
    cfg = {**tinybench.TINY_DENSE, "param_dtype": "float32", "compute_dtype": "float32"}
    model = Model(drv.program_config(cfg), device="cpu")
    weights.fill(dict(model.named_parameters()), cfg, 31)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 37), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port = model.lm_logits(tokens)[0, :, :cfg["vocab_size"]]
    want = llama.logits(weights.make(cfg, 31, "cpu", torch.float32), cfg, [tokens[0]],
                        [(0, 37)])[0]
    assert float((port - want).abs().max()) <= 2e-5 * float(want.abs().max())


def test_weights_are_the_same_on_both_sides():
    cfg = tinybench.TINY_DENSE
    a = weights.make(cfg, 2**35 + 1, "cpu", torch.bfloat16)
    b = weights.make(cfg, 2**35 + 1, "cpu", torch.bfloat16)
    c = weights.make(cfg, 2**35 + 2, "cpu", torch.bfloat16)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["wq"], c["wq"])


def _readings(root, cell):
    out = io.StringIO()
    readings.main(["--workload", cell, "--seeds", "1,2,3", "--seconds", "0.3", "--control"],
                  root=root, device="cpu", out=out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.mark.parametrize("cell,number", [("tiny-chat-coded", "max_gap"),
                                         ("tiny-stragglers", "err_ratio")])
def test_control_fails_where_the_program_passes(root, cell, number):
    limit = tinybench.LIMITS[cell][number]["limit"]
    for r in _readings(root, cell):
        assert r["program"][number] <= limit < r["control"][number]


def test_a_port_with_float8_weights_is_rejected(root):
    """The served model's weights rounded to float8 (what a lower-precision
    port would serve): the check fails it."""
    cx = run.Cell(root, "tiny-chat-coded", 5, 0.3, False)
    cx.device = torch.device("cpu")
    drv = run.load_module(cx.dir / "drivers" / "serve.py")
    kw = drv.serve_kwargs(cx.mix, cx.config)
    model = drv.make_model(cx, 5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.copy_(llama.fp8_round_trip(p.float()))
    srv = drv.make_server(cx, model)
    drv.warmup(cx, srv, kw)
    calls = drv.window(cx, srv, kw)
    r = drv.readings(cx, drv.sample(cx, calls), 5)
    assert r["max_gap"] > tinybench.LIMITS["tiny-chat-coded"]["max_gap"]["limit"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0], dtype=torch.float32)
    assert ref_matvec.to_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]


def test_plain_coded_matvec_recovers_a_x():
    """The reference decode of k parity-heavy rows gives A x to float32's
    error times the code's condition; from TF32 products, far worse."""
    gen = torch.Generator().manual_seed(0)
    k, d = 48, 32
    g = torch.cat([torch.eye(k), torch.randn(20, k, generator=gen) / k ** 0.5])
    a, x = torch.randn(k, d, generator=gen), torch.randn(d, generator=gen)
    rows = torch.cat([torch.arange(10, k), torch.arange(k, k + 10)])
    want = ref_matvec.exact(a, x[:, None])[:, 0]
    err = float((ref_matvec.coded(g, a, x, rows) - want).norm() / want.norm())
    ctl = float((ref_matvec.coded(g, a, x, rows, tf32=True) - want).norm() / want.norm())
    assert err < 1e-4 and ctl > 30 * err


def test_program_config_is_the_files():
    drv = run.load_module(run.HERE / "drivers" / "serve.py")
    cfg = json.loads((run.HERE / "configs" / "yi-9b.json").read_text())
    from repro_torch.configs import get_arch

    mine = drv.program_config(cfg)
    theirs = dataclasses.replace(get_arch("yi-9b"), param_dtype="bfloat16")
    assert dataclasses.replace(mine, name=theirs.name) == theirs
