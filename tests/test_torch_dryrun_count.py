"""The dry-run's counter (``repro_torch.launch.dryrun.Counter``) on ``meta``
tensors: its FLOPs against ``torch.utils.flop_counter.FlopCounterMode`` and
4 B H S^2 hd, the kernels' cost functions in a train step, and the layer
and length extrapolations against full counts at reduced sizes, bucket
for bucket, exactly (train cells of the four kinds of loop: dense,
windowed with the causal block skip, hybrid, xLSTM; prefill of every
family).
"""
import dataclasses
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tcfg
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.attention import chunked_attention


def test_chunked_attention_counts_4_b_h_s2_hd():
    """One ``chunked_attention`` call, no causal skip: exactly 4 B H S^2 hd
    counted (scores and the weighted sum), by the counter and by
    ``FlopCounterMode``."""
    b, s, h, kv, hd = 2, 256, 8, 2, 64
    q = torch.empty((b, s, h, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s, kv, hd), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((s,), dtype=torch.int32, device="meta")
    kw = dict(num_heads=h, num_kv_heads=kv, head_dim=hd, q_block=64, kv_block=128)
    with D.Counter() as cnt:
        chunked_attention(q, k, k, pos, pos, **kw)
    with FlopCounterMode(display=False) as fc:
        chunked_attention(q, k, k, pos, pos, **kw)
    assert cnt.result().total_flops() == fc.get_total_flops() == 4 * b * h * s * s * hd


def _tiny(name: str) -> tcfg.ModelConfig:
    c = get_arch(name).reduced()
    return dataclasses.replace(c, slstm_every=2) if c.family == "ssm" else c


@pytest.mark.parametrize("arch,kind", [("qwen3-0.6b", "train"), ("moonshot-v1-16b-a3b", "train"),
                                       ("whisper-tiny", "prefill")])
def test_counter_matches_flop_counter_mode(arch, kind):
    """The counter's operation FLOPs are ``FlopCounterMode``'s on the same
    meta step; the kernels (B4) add their cost functions' FLOPs."""
    c = _tiny(arch)
    shape = tcfg.ShapeConfig("t", 64, 4, kind)
    model = D.Model(c, device="meta")
    inputs = D.step_inputs(model, shape)
    with FlopCounterMode(display=False) as fc, D.Counter() as cnt:
        D.run_step(model, shape, inputs)
    res = cnt.result()
    kernel_flops = sum(v[1] for v in res.kernels.values())
    assert res.total_flops() == fc.get_total_flops() + kernel_flops
    if kind == "train":
        t, v, d = 4 * 64, c.vocab_size, c.d_model
        assert {n: v_[:2] for n, v_ in res.kernels.items()} == {
            "fused_ce_fwd": [1, 2.0 * t * v * d], "fused_ce_bwd_dh": [1, 4.0 * t * v * d],
            "fused_ce_bwd_de": [1, 4.0 * t * v * d]}


def _same(got: D.Count, want: D.Count):
    assert got.flops == want.flops and got.nbytes == want.nbytes
    assert {n: v for n, v in got.kernels.items()} == want.kernels


EXTRAPOLATED = [(a, "prefill") for a in ("qwen3-0.6b", "h2o-danube-3-4b", "moonshot-v1-16b-a3b",
                                        "paligemma-3b", "zamba2-1.2b", "whisper-tiny",
                                        "xlstm-125m")] + \
    [(a, "train") for a in ("qwen3-0.6b", "h2o-danube-3-4b", "zamba2-1.2b", "xlstm-125m")]


@pytest.mark.parametrize("arch,kind", EXTRAPOLATED)
def test_extrapolation_equals_full_count(arch, kind):
    """The layer and length extrapolation of a reduced config at a length
    past its samples equals the full count, bucket for bucket, exactly."""
    c = _tiny(arch)
    c = dataclasses.replace(c, num_layers=2 if c.family == "ssm" else 3)
    if c.family == "hybrid":
        c = dataclasses.replace(c, attn_every=2)
    unit = 8 if c.family == "ssm" else math.lcm(c.attn_q_block, c.attn_kv_block,
                                                c.mamba_chunk if c.family == "hybrid" else 1)
    start = max(unit, -(-(c.sliding_window or 0) // unit) * unit)
    shape = tcfg.ShapeConfig("t", start + 4 * unit, 1, kind)
    mesh = make_production_mesh()
    splits = [(16, 16)]
    got, method = D.extrapolated_count(c, shape, mesh, splits)
    assert "length_delta" in method and (c.family == "ssm") == ("layer" not in method)
    _same(got, D.count_step(c, shape, mesh, splits))
