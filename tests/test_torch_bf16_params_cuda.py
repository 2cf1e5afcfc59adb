"""bfloat16 parameters on the card (``param_dtype="bfloat16"``).

Marked ``cuda``: they skip on a machine without CUDA. Run them on the
card with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_bf16_params_cuda.py

* The reduced qwen3-0.6b and moonshot-v1-16b-a3b with bf16 parameters
  and float32 compute, the same weights on the card and on the CPU:
  ``lm_logits`` within 2e-4 + 2e-4 |want|, the tokens of a ``generate``
  and the streams of a paged ``serve`` equal.
* The init's peak on the card: moonshot-v1-16b-a3b at full width with 8
  of its 48 layers in bf16 allocates at most the memory before it, plus
  its parameters' bytes, plus its largest float32 draw (the embedding,
  163,840 x 2,048 x 4 B = 1.34 GB), plus 256 MiB; what stays allocated is
  the parameters.
"""
import dataclasses
import gc

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.models.model import Model
from repro_torch.runtime.serve_loop import Server
from repro_torch.serve.workload import make_workload

pytestmark = pytest.mark.cuda

MOE = "moonshot-v1-16b-a3b"
BF16 = {"param_dtype": "bfloat16"}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(name):
    """(CPU model, card model) of the reduced config with bf16 parameters,
    the same weights in both."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), **BF16)
    cpu = Model(cfg, device="cpu", seed=0)
    card_model = Model(cfg, device="cuda", seed=0)
    card_model.load_state_dict(cpu.state_dict())
    assert card_model.wq.dtype == torch.bfloat16 and cfg.cdtype == torch.float32
    return cpu, card_model


@pytest.mark.parametrize("name", ["qwen3-0.6b", MOE])
def test_reduced_bf16_parameters_card_against_cpu(card, name):
    runs = []
    toks = torch.randint(0, 512, (4, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(7))
    trace = make_workload("poisson", num_requests=6, prompt_len=(8, 40), out_len=(3, 9),
                          vocab=512).trace(seed=0)
    for m in _pair(name):
        with torch.no_grad():
            logits = m.lm_logits(toks.to(m.device)).float().cpu()
        out = Server(m).generate(toks[:, :24], 8).cpu()
        rep = Server(m).serve(trace, slots=4, decode_block=4, prefill_chunk=16)
        runs.append((logits, out, rep.streams))
    (got, out, streams), (want, want_out, want_streams) = runs
    worst = float(((got - want).abs() / (2e-4 + 2e-4 * want.abs())).max())
    assert worst <= 1.0, worst
    assert torch.equal(out, want_out)
    assert streams == want_streams


def test_bf16_init_peak_at_moonshot_width(card):
    cfg = dataclasses.replace(ARCHS[MOE], num_layers=8, **BF16)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated() - before
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    draw = model.embed.numel() * 4  # the largest float32 draw
    assert draw == 163_840 * 2048 * 4
    assert model.expert_gate.dtype == torch.bfloat16 and model.w_router.dtype == torch.float32
    assert params <= held <= params + (1 << 20), (held, params)
    assert peak <= before + params + draw + (256 << 20), (peak - before, params, draw)
    assert bool(torch.isfinite(model.expert_down[-1].float()).all())
    del model
    gc.collect()
    torch.cuda.empty_cache()
