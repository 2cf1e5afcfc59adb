"""The yardstick's arithmetic against hand-worked shapes: least times,
kernel work, model FLOPs (against the port's dry-run counter), the
schedule a serve call's record implies, and a device trace's reduction."""
from __future__ import annotations

import pytest

from perfbench import profiling, roofline, schedule

YI = {"num_hidden_layers": 48, "hidden_size": 4096, "num_attention_heads": 32,
      "num_key_value_heads": 4, "intermediate_size": 11008, "vocab_size": 64000}


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert roofline.bound_ms(3.35e9, 1.0, "float32") == pytest.approx((1.0, "bytes"))
    assert roofline.bound_ms(1.0, 989e9, "bfloat16") == pytest.approx((1.0, "operations"))
    assert roofline.bound_ms(0.0, 67e9, "float32") == pytest.approx((1.0, "operations"))


def test_path_m_products_work():
    # 200 workers x 203 rows x 4096 f32: 665,190,400 bytes of A~, x, 40,600 products
    flops, nbytes = roofline.packed_matvec_work(200, 203, 4096)
    assert nbytes == 4 * (40_600 * 4096 + 4096 + 40_600) == 665_369_184
    assert flops == 2 * 40_600 * 4096
    ms, by = roofline.bound_ms(nbytes, flops, "float32")
    assert by == "bytes" and ms == pytest.approx(0.198618, rel=1e-5)


def test_head_mix_work():
    # yi-9b's head: (312, 250) generator times (250, 32 x 256) logit blocks
    flops, nbytes = roofline.head_mix_work(312, 250, 32, 256)
    assert flops == 2 * 312 * 250 * 8192
    assert nbytes == 4 * (312 * 250 + 250 * 8192 + 312 * 8192)
    assert roofline.bound_ms(nbytes, flops, "float32")[1] == "operations"


def test_paged_decode_work_counts_valid_entries():
    # two slots at positions 9 and 99: 10 + 100 entries, KV 4, G 8, hd 128, bf16
    flops, nbytes = roofline.paged_decode_work(110, 2, 4, 8, 128, 2)
    assert flops == 4 * 110 * 4 * 8 * 128
    assert nbytes == 2 * (2 * 2 * 32 * 128 + 2 * 110 * 4 * 128) + 8


def test_layer_params_and_token_flops_by_hand():
    assert roofline.dense_layer_params(4096, 32, 4, 128, 11008) == \
        4096 * (4096 + 1024) + 4096 * 4096 + 3 * 4096 * 11008
    p = roofline.dense_layer_params(4096, 32, 4, 128, 11008)
    assert roofline.token_flops(YI, 1000, decoded=False) == 48 * (2 * p + 4 * 1000 * 4096)
    assert roofline.token_flops(YI, 1000, decoded=True) - \
        roofline.token_flops(YI, 1000, decoded=False) == 2 * 64000 * 4096


def test_token_flops_match_the_dryrun_counter():
    """A full forward of T tokens on ``meta``, counted by the port's dry-run
    counter, is T tokens at context T (one attention block, so every score
    is computed) with the head on each."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.dryrun import Counter
    from repro_torch.models.model import Model

    cfg = {"num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 4,
           "num_key_value_heads": 2, "intermediate_size": 256, "vocab_size": 512}
    model = Model(ModelConfig(name="t", family="dense", num_layers=2, d_model=128,
                              num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
                              compute_dtype="float32"), device="meta")
    t = 64
    with torch.no_grad(), Counter() as c:
        model.lm_logits(torch.zeros((1, t), dtype=torch.int32, device="meta"))
    assert c.result().total_flops() == t * roofline.token_flops(cfg, t, decoded=True)


def test_schedule_follows_chunks_and_steps():
    # request 0: prompt 20, 6 out; request 1: prompt 5, 2 out, admitted at round 2
    reqs = {0: (20, 6), 1: (5, 2)}
    chunks = [("prefill_chunk", 0.0, 0), ("prefill_chunk", 1.0, 4),
              ("prefill_chunk", 6.0, 2)]
    # a dispatch with nothing to do is no dispatch of the program's
    with pytest.raises(schedule.ScheduleMismatch):
        schedule.reconstruct(chunks + [("decode_chunk", 9.0, 0)], {0: 0.0, 1: 6.0},
                             reqs, 16, 4)
    got = schedule.reconstruct(chunks, {0: 0.0, 1: 6.0}, reqs, 16, 4)
    assert got is not None
    assert got[0].prefill == [(0, 16)] and got[0].decode == []
    assert got[1].prefill == [(16, 4)] and got[1].decode == [20]
    assert got[2].prefill == [(0, 5)] and got[2].decode == [24, 5]
    # a record that disagrees (three steps where two are due) raises
    bad = chunks[:2] + [("prefill_chunk", 6.0, 3)]
    with pytest.raises(schedule.ScheduleMismatch, match="3 decode steps"):
        schedule.reconstruct(bad, {0: 0.0, 1: 6.0}, reqs, 16, 4)
    # so does a request the record never finishes
    with pytest.raises(schedule.ScheduleMismatch, match="unfinished"):
        schedule.reconstruct(chunks[:2], {0: 0.0, 1: 6.0}, reqs, 16, 4)


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_device_trace_busy_share_and_gaps():
    events = [_x(profiling.WINDOW, 100, 100, "user_annotation"),
              _x("dispatch", 110, 30, "user_annotation"),
              _x("admit", 150, 20, "user_annotation"),
              _x("k1", 110, 20, "kernel"), _x("k2", 120, 20, "kernel"),
              _x("k1", 180, 10, "kernel"), _x("memcpy", 190, 5, "gpu_memcpy"),
              _x("outside", 300, 5, "kernel")]
    tr = profiling.DeviceTrace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(45e-6)  # [110, 140] and [180, 195]
    assert tr.seconds("k1") == pytest.approx(30e-6)
    assert tr.seconds(exclude="k") == pytest.approx(5e-6)
    assert tr.top_ops(2) == [["k1", pytest.approx(30e-6)], ["k2", pytest.approx(20e-6)]]
    gaps = dict(tr.idle_gaps())
    # [100, 110] host, [140, 180] mid 160 in admit, [195, 200] host
    assert gaps == {"admit": pytest.approx(40e-6), "host": pytest.approx(15e-6)}


@pytest.mark.parametrize("name,solve", [
    ("void getrf_pivot<getrf_params_<float, 512, 2, 512, 64, 16> >(int, int)", True),
    ("void kernel_trsm_l_mul32<float, 8, false, false, false, true>(int)", True),
    ("void ipiv_lower_diag<float, 512>(int, void*, int, int*, int)", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous "
     "namespace)::silu_kernel(at::TensorIteratorBase&)", False),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float>", False),
    ("nvjet_tst_128x8_64x12_4x1_v_bz_NNT", False),
])
def test_the_solves_kernel_names(name, solve):
    """The coded head's solve is found by cuSOLVER's kernel names, and no
    model kernel (the MLP's SiLU above all) passes for it."""
    import re

    from perfbench import run

    head = run.load_module(run.HERE / "metrics" / "head.solve_ms.serve.py")
    model = run.load_module(run.HERE / "metrics" / "model.device_ms_per_step.py")
    assert bool(re.search(head.KERNELS, name)) == solve
    assert bool(re.search(model.OTHERS, name)) == solve
