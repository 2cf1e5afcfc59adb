"""The port on the ``meta`` device: every config builds with no memory and
no values, every family's forward, loss, backward and decode run there,
each kernel wrapper returns its kernel's output shapes and dtypes, and
the kernels' cost functions give the FLOPs of PERF.md's bound column.
Then the cost tally: a counted step is the same on the CPU and on meta.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.pipeline import make_batch_specs, make_extras
from repro_torch.device import resolve_device
from repro_torch.kernels.coded_matvec import ops as cmv
from repro_torch.kernels.fused_ce import ops as ce
from repro_torch.kernels.mds_encode import ops as mds
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.launch import dryrun as D
from repro_torch.models.model import Model


def test_resolve_device_takes_meta_and_never_turns_cuda_into_cpu():
    assert resolve_device("meta").type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            resolve_device("cuda")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_config_builds_on_meta_with_the_reference_count(arch):
    from repro.configs import get_arch as ref_get_arch
    from repro.models.model import Model as RefModel

    model = Model(get_arch(arch), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    tree = jax.eval_shape(RefModel(ref_get_arch(arch)).init_params, jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))
    assert model.param_count() == want


def _tiny(name):
    c = get_arch(name).reduced()
    return dataclasses.replace(c, slstm_every=2) if c.family == "ssm" else c


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "moonshot-v1-16b-a3b", "paligemma-3b",
                                  "whisper-tiny", "zamba2-1.2b", "xlstm-125m",
                                  "h2o-danube-3-4b"])
def test_every_family_runs_on_meta_with_the_cpu_shapes(arch):
    c = _tiny(arch)
    out = {}
    for dev in ("cpu", "meta"):
        m = Model(c, device=dev)
        tok = torch.zeros((2, 32), dtype=torch.int32, device=dev)
        ex = make_extras(c, 2, device=dev)
        batch = {"tokens": tok, "labels": tok, **({"extras": ex} if ex else {})}
        loss, _ = m.loss_fn(batch)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        logits = m.lm_logits(tok, ex)
        enc = {"enc_out": m.encode(ex["frames"])} if c.family == "audio" else None
        step, _ = m.decode_step(m.init_cache(2, 32, enc), tok[:, 0], 3)
        out[dev] = [(tuple(t.shape), t.dtype) for t in (loss, logits, step, *grads)]
    assert out["meta"] == out["cpu"]


def test_make_batch_specs_are_meta_stand_ins():
    from repro_torch.configs import SHAPES_BY_NAME

    shape = SHAPES_BY_NAME["train_4k"]
    for arch in ("qwen3-0.6b", "paligemma-3b", "whisper-tiny"):
        c = get_arch(arch)
        batch = make_batch_specs(c, shape)
        assert batch["tokens"].shape == batch["labels"].shape == (256, 4096)
        assert batch["tokens"].device.type == "meta" and batch["tokens"].dtype == torch.int32
        if c.family in ("vlm", "audio"):
            (extra,) = batch["extras"].values()
            n = c.num_image_tokens if c.family == "vlm" else c.encoder_seq
            assert extra.shape == (256, n, c.d_model) and extra.dtype == c.cdtype
        else:
            assert "extras" not in batch


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_wrappers_on_meta_return_the_kernel_outputs():
    y = cmv.blocked_matvec(_meta(738, 594), _meta(594, 1024))
    assert (y.shape, y.dtype, y.device.type) == ((738, 1024), torch.float32, "meta")
    assert cmv.blocked_matvec(_meta(40, 16), _meta(16)).shape == (40,)
    assert cmv.blocked_matvec_batch(_meta(3, 5, 16), _meta(16)).shape == (3, 5)
    out = mds.mds_encode(_meta(738, 594), _meta(594, 2048))
    assert (out.shape, out.dtype) == ((738, 2048), torch.float32)
    q = _meta(4, 8, 2, 128, dtype=torch.bfloat16)
    pool = _meta(73, 16, 8, 128, dtype=torch.bfloat16)
    table = _meta(4, 72, dtype=torch.int32)
    att = pa.paged_decode_attend(q, pool, pool, table, _meta(4, dtype=torch.int32))
    assert (att.shape, att.dtype) == (q.shape, torch.bfloat16)
    h = _meta(300, 1024, dtype=torch.bfloat16).requires_grad_()
    e = _meta(5000, 1024, dtype=torch.bfloat16).requires_grad_()
    lse, ll, am = ce.fused_ce(h, e, _meta(300, dtype=torch.int64))
    assert [(t.shape, t.dtype) for t in (lse, ll, am)] == [
        ((300,), torch.float32), ((300,), torch.float32), ((300,), torch.int64)]
    dh, de = torch.autograd.grad((lse + ll).sum(), (h, e))
    assert (dh.shape, dh.dtype, de.shape, de.dtype) == (
        h.shape, torch.bfloat16, e.shape, torch.bfloat16)
    # the kernels' own refusals hold on meta too
    with pytest.raises(TypeError):
        mds.mds_encode(_meta(4, 4, dtype=torch.bfloat16), _meta(4, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="hidden width"):
        ce.fused_ce(_meta(8, 12, dtype=torch.bfloat16), _meta(16, 12, dtype=torch.bfloat16),
                    _meta(8, dtype=torch.int64))


def test_cost_functions_give_the_bound_columns_flops():
    """PERF.md section 6: bound = max(bytes / 3.35 TB/s, FLOPs / peak) at the
    main-path shapes (f32 67, bf16 989 TFLOP/s)."""
    def ms(cost, peak):
        return max(cost[1] / 3.35e12, cost[0] / peak) * 1e3

    assert cmv.blocked_matvec_cost(738, 594, 1024) == (2.0 * 738 * 594 * 1024,
                                                       4.0 * (738 * 594 + 594 * 1024
                                                              + 738 * 1024))
    assert round(ms(cmv.blocked_matvec_cost(738, 594, 1024), 67e12), 4) == 0.0134
    assert round(ms(mds.mds_encode_cost(738, 594, 262_144), 67e12), 2) == 3.43
    t, v, d = 8192, 151_936, 1024
    fwd = ce.fused_ce_cost(ce.FWD, t, v, d, 2)
    assert fwd[0] == 2.0 * t * v * d and round(ms(fwd, 989e12), 2) == 2.58
    for k in (ce.BWD_DH, ce.BWD_DE):
        assert ce.fused_ce_cost(k, t, v, d, 2)[0] == 4.0 * t * v * d
        assert round(ms(ce.fused_ce_cost(k, t, v, d, 2), 989e12), 2) == 5.15
    # B2 at the serve shape: the bound counts the valid entries of the table
    flops, nbytes = pa.paged_decode_cost(4, 8, 2, 128, 72, 16, 2, tokens=256 + 101 + 17 + 41)
    assert flops == 4.0 * 415 * 8 * 2 * 128
    assert pa.paged_decode_cost(4, 8, 2, 128, 72, 16, 2)[0] == 4.0 * 4 * 72 * 16 * 8 * 2 * 128


def test_a_counted_step_is_the_same_on_cpu_and_on_meta():
    """The kernels report their cost functions on every device and the CPU's
    plain versions are hidden, so a train step counts the same FLOPs and
    bytes on the CPU as on meta; the CPU's B4 runs through the autograd
    function, its backward giving the plain oracle's autograd gradients."""
    c = _tiny("qwen3-0.6b")
    shape = D.ShapeConfig("t", 32, 2, "train")
    counts = {}
    for dev in ("cpu", "meta"):
        model = Model(c, device=dev)
        inputs = D.step_inputs(model, shape)
        with D.Counter() as cnt:
            D.run_step(model, shape, inputs)
        counts[dev] = cnt.result()
    assert counts["cpu"].flops == counts["meta"].flops
    assert counts["cpu"].nbytes == counts["meta"].nbytes
    assert counts["cpu"].kernels == counts["meta"].kernels
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((24, 32), generator=gen, requires_grad=True)
    e = torch.randn((50, 32), generator=gen, requires_grad=True)
    labels = torch.randint(-1, 50, (24,), generator=gen)
    want = torch.autograd.grad(sum(x.sum() for x in ce.fused_ce_plain(h, e, labels)[:2]),
                               (h, e))
    with D.Counter():
        got = torch.autograd.grad(sum(x.sum() for x in ce.fused_ce(h, e, labels)[:2]), (h, e))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
