"""The traffic generator: the frozen copy against the program's, the
seeding, and the warm-up trace."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from perfbench import gen

MIXES = [p for p in sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))
         if json.loads(p.read_text())["kind"] == "serve"]


@pytest.mark.parametrize("spec", [
    dict(name="a", arrival_rate=0.5, num_requests=12, prompt_len=(4, 40), out_len=(2, 9),
         vocab=64000),
    dict(name="b", arrival_rate=0.05, num_requests=7, prompt_len=(256, 2048),
         out_len=(32, 512), vocab=64000,
         out_len_mix=(((32, 128), 2 / 3), ((256, 512), 1 / 3))),
    dict(name="c", arrival_rate=1.5, num_requests=9, prompt_len=(3, 3), out_len=(1, 1),
         vocab=17, class_mix=(("batch", 1.0),)),
])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_frozen_generator_equals_the_programs(spec, seed):
    from repro_torch.serve import workload

    mine = gen.WorkloadSpec(**spec).trace(seed)
    theirs = workload.WorkloadSpec(**spec).trace(seed)
    assert [(r.rid, r.arrival, r.prompt, r.out_len, r.deadline_class) for r in mine] == \
        [(r.rid, r.arrival, r.prompt, r.out_len, r.deadline_class) for r in theirs]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_each_seed_and_trace_draws_its_own_sizes(path):
    """Trace i of a run with seed s is the program's generator on a seed
    drawn from (s, i): sizes, arrivals and tokens differ by seed and trace."""
    from repro_torch.serve import workload

    mix = json.loads(path.read_text())

    def sizes(trace):
        return [(r.arrival, r.prompt_len, r.out_len, r.deadline_class) for r in trace]

    a = gen.serve_trace(mix, 64000, 2**40 + 3, 1)
    b = gen.serve_trace(mix, 64000, 99, 1)
    c = gen.serve_trace(mix, 64000, 99, 2)
    assert len(a) == mix["requests"]
    assert len({tuple(sizes(t)) for t in (a, b, c)}) == 3
    spec = gen.spec_of(mix, 64000)
    theirs = workload.WorkloadSpec(**{f: getattr(spec, f) for f in (
        "name", "arrival_rate", "num_requests", "prompt_len", "out_len", "vocab",
        "out_len_mix")}).trace(gen.sub_seed(99, 2))
    assert [(r.rid, r.arrival, r.prompt, r.out_len, r.deadline_class) for r in c] == \
        [(r.rid, r.arrival, r.prompt, r.out_len, r.deadline_class) for r in theirs]
    lo, hi = mix["prompt_len"]
    assert all(lo <= r.prompt_len <= hi for t in (a, b, c) for r in t)


def test_sub_seed_takes_any_whole_number():
    seeds = {gen.sub_seed(s, 1) for s in (0, 1, 2**31 + 5, 2**63 + 9, -4)}
    assert len(seeds) == 5 and all(0 <= s < 2**32 for s in seeds)


@pytest.mark.parametrize("chunk,prompt_hi,keys", [(16, 40, 9), (64, 40, 8)])
def test_warmup_trace_builds_every_dispatch_key(chunk, prompt_hi, keys):
    import torch

    from perfbench import run
    from perfbench.tests import tinybench

    drv = run.load_module(run.HERE / "drivers" / "serve.py")
    mix = {**tinybench.TINY_CHAT, "prefill_chunk": chunk, "prompt_len": [8, prompt_hi]}

    class Cx:
        config, device, seed = tinybench.TINY_DENSE, torch.device("cpu"), 5

        @staticmethod
        def mark(phase):
            pass

    Cx.mix = mix
    kw = drv.serve_kwargs(mix, Cx.config)
    srv = drv.make_server(Cx, drv.make_model(Cx, 5))
    drv.serve_call(srv, gen.warmup_trace(mix, 512, 5), kw, 1)
    assert len(srv.programs.keys("serve")) == keys


def test_pool_is_the_memory_the_configuration_gives_the_cache():
    """The KV pool fills the configuration's ``kv_cache_gib`` (blocks of 16
    tokens: 48 layers x K and V x 4 heads x 128 x 2 bytes for yi-9b), and a
    memory that cannot hold every slot's longest request is refused."""
    from perfbench import run

    drv = run.load_module(run.HERE / "drivers" / "serve.py")
    cfg = json.loads((run.HERE / "configs" / "yi-9b.json").read_text())
    mix = json.loads((run.HERE / "traffic" / "chat-coded.json").read_text())
    assert drv.serve_kwargs(mix, cfg)["num_blocks"] == 48 * 2**30 // (48 * 2 * 16 * 4 * 128 * 2)
    with pytest.raises(ValueError, match="slots need 5152"):
        drv.serve_kwargs(mix, {**cfg, "kv_cache_gib": 1})
