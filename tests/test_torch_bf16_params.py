"""Port parity with bfloat16 parameters (``param_dtype="bfloat16"``, the
reference's ``configs/base.py`` field), on reduced configs on the CPU.

* Leaf dtypes and shapes: every registered config, reduced and at full
  width (the port on ``meta``, the reference through ``jax.eval_shape``):
  each port leaf has the dtype and shape of the reference's
  ``init_params`` leaf at the same path (bf16, but the router, the Mamba2
  scalars and the xLSTM gates, which stay float32 in both).
* ``params_from_jax`` carries the reference's bf16 (and float32) leaves
  across bit for bit.
* The model paths of qwen3-0.6b and moonshot-v1-16b-a3b with bf16
  parameters and float32 compute (bf16 noise flips an MoE's top-k
  routes, so parity holds the compute in float32): ``lm_logits`` and
  ``decode_step``, ``prefill`` with ``decode_step_slots``,
  ``prefill_paged`` and ``decode_step_paged``, logits within 2e-4 and
  caches within 1e-5 (``test_torch_families``' tests at this dtype);
  ``Server.serve`` paged and dense and ``Server.generate``, streams,
  tokens and counts exactly.
* qwen3-0.6b in bf16 compute: ``lm_logits``, the paged prefill and six
  paged decode steps within 2^-5 max|logits| of the reference (bf16
  rounding at 4 layers; about 1.9e-2 measured).
* Init: a seed's bf16 init is its float32 init cast to bf16, bit for bit,
  for every reduced config.
* No serving step copies a stacked parameter whole: under a dispatch
  mode, no op that reads a whole (L, ...) leaf writes a tensor of its
  size elsewhere (a cast, a ``where``, a clone) in the paged and the
  dense serve and in ``generate``, in float32 and bf16 compute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as REF_ARCHS
from repro.models.model import Model as RefModel
from repro_torch.configs import ARCHS
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.models.model import Model, _flatten, jax_path
from repro_torch.runtime.serve_loop import ServeConfig, Server
import repro_torch.serve.workload as wl
import test_torch_families as fam

BF16 = {"param_dtype": "bfloat16"}
SERVED = ("qwen3-0.6b", fam.MOE)
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the reduced xLSTM holds no sLSTM at slstm_every 6: every other layer is one
CHANGES = {"xlstm-125m": {"slstm_every": 2}}


def _config(table, name, width, **changes):
    cfg = table[name].reduced() if width == "reduced" else table[name]
    extra = CHANGES.get(name, {}) if width == "reduced" else {}
    return dataclasses.replace(cfg, **extra, **changes)


def _bits(t) -> np.ndarray:
    """The raw bits of a float32 or bf16 tensor / array, as unsigned ints."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()
    return t.view(np.int16 if t.dtype.itemsize == 2 else np.int32)


# ------------------------------------------------------------ the leaves
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_leaf_dtypes_and_shapes_match_reference(name, width):
    ref = RefModel(_config(REF_ARCHS, name, width, **BF16))
    want = _flatten(jax.eval_shape(ref.init_params, fam.KEY))
    ours = Model(_config(ARCHS, name, width, **BF16), device="meta")
    got = {jax_path(n): p for n, p in ours.named_parameters()}
    assert set(got) == set(want)
    for path, p in got.items():
        assert p.dtype == TORCH_DTYPES[str(want[path].dtype)], path
        assert tuple(p.shape) == tuple(want[path].shape), path
    kept = sorted(path for path, p in got.items() if p.dtype == torch.float32)
    assert all(path.rsplit("/", 1)[-1] in ("w_router", "a_log", "dt_bias", "d_skip", "w_if",
                                           "b_i", "b_f", "b") for path in kept), kept


@pytest.mark.parametrize("name", SERVED + ("zamba2-1.2b", "xlstm-125m"))
def test_params_from_jax_takes_bf16_leaves_exactly(name):
    _, params, ours = fam._pair(name, **BF16)
    leaves = _flatten(jax.tree.map(np.asarray, params))
    dtypes = set()
    for n, p in ours.named_parameters():
        want = leaves[jax_path(n)]
        assert p.dtype == TORCH_DTYPES[str(want.dtype)], n
        np.testing.assert_array_equal(_bits(p), _bits(want), err_msg=n)
        dtypes.add(p.dtype)
    assert torch.bfloat16 in dtypes


# ------------------------------------------------- model paths and serves
@pytest.mark.parametrize("path", ["lm_logits_and_decode_step", "prefill_and_slots",
                                  "chunked_prefill_and_paged_decode"])
@pytest.mark.parametrize("name", SERVED)
def test_model_paths_match_reference_f32_compute(name, path):
    if path == "lm_logits_and_decode_step":
        fam.test_lm_logits_and_decode_step_match_reference(name, BF16, 12)
    elif path == "prefill_and_slots":
        fam.test_prefill_and_decode_step_slots_match_reference(name, **BF16)
    else:
        fam.test_chunked_prefill_and_paged_decode_match_reference(name, **BF16)
    assert fam._pair(name, **BF16)[2].wq.dtype == torch.bfloat16


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("name", SERVED)
def test_serve_matches_reference_f32_compute(name, paged, monkeypatch):
    fam.test_serve_matches_reference(name, paged, monkeypatch, **BF16)


@pytest.mark.parametrize("name", SERVED)
def test_generate_matches_reference_f32_compute(name):
    """The batched prefill and 6 tokens, every one through the coded head."""
    refsrv, server = fam._servers(name, **BF16)
    refsrv.coded_head.deadline = server.coded_head.deadline = 1e9
    prompts = np.asarray(jax.random.randint(fam.KEY, (3, 14), 0, 512), np.int32)
    want = refsrv.generate(jnp.asarray(prompts), 6)
    rounds = []
    got = server.generate(prompts, 6, observe=lambda step, lg, sel, ok, mask:
                          rounds.append(bool(ok) and bool(mask.all())))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == [True] * 6


def test_qwen3_bf16_compute_within_bf16_rounding_of_reference():
    """lm_logits, a paged prefill of two prompts (12 and 9 tokens) and six
    paged decode steps, each within 2^-5 max|logits| of the reference."""
    ref, params, ours = fam._pair("qwen3-0.6b", compute_dtype="bfloat16", **BF16)
    assert ours.config.cdtype == torch.bfloat16 and ours.wq.dtype == torch.bfloat16

    def close(got, want):
        want = np.asarray(want, np.float32)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= 2.0**-5 * float(np.abs(want).max()), err
        return want

    toks = np.random.default_rng(1).integers(0, 512, (2, 80)).astype(np.int32)
    with torch.no_grad():
        close(ours.lm_logits(torch.from_numpy(toks)),
              jax.jit(ref.lm_logits)(params, jnp.asarray(toks)))
    table = np.full((2, 12), -1, np.int32)
    table[:, :6] = np.arange(12, dtype=np.int32).reshape(2, 6)
    lens, start = np.array([12, 9], np.int32), np.zeros(2, np.int32)
    rcache, cache = ref.init_paged_cache(12, 4), ours.init_paged_cache(12, 4)
    want, rcache = jax.jit(ref.prefill_paged)(params, rcache, *map(jnp.asarray, (
        toks[:, :12], start, lens, table)))
    got, cache = ours.prefill_paged(cache, *map(torch.from_numpy, (
        np.ascontiguousarray(toks[:, :12]), start, lens, table)))
    want = close(got, want)
    pos, tok, active = lens, np.argmax(want, -1).astype(np.int32), np.ones(2, bool)
    step = jax.jit(ref.decode_step_paged)
    for _ in range(6):
        want, rcache = step(params, rcache, *map(jnp.asarray, (tok, pos, table, active)))
        got, cache = ours.decode_step_paged(cache, *map(torch.from_numpy, (
            tok, pos, table, active)))
        tok, pos = np.argmax(close(got, want), -1).astype(np.int32), pos + 1


# ------------------------------------------------------------------- init
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_bf16_init_is_the_f32_init_cast(name):
    f32 = Model(_config(ARCHS, name, "reduced"), device="cpu", seed=3)
    bf16 = dict(Model(_config(ARCHS, name, "reduced", **BF16), device="cpu",
                      seed=3).named_parameters())
    assert any(p.dtype == torch.bfloat16 for p in bf16.values())
    for n, p in f32.named_parameters():
        assert p.dtype == torch.float32, n
        np.testing.assert_array_equal(_bits(p.detach().to(bf16[n].dtype)), _bits(bf16[n]),
                                      err_msg=n)


# ---------------------------------------------------- no whole-stack copies
class _StackCopies(TorchDispatchMode):
    """Records each op that reads a whole stacked parameter and writes a
    tensor of the parameter's size to other memory (a cast, a clone, a
    ``where``): views of it (a layer, ``unbind``) share its storage."""

    def __init__(self, stacked):
        super().__init__()
        self.stacked = {p.untyped_storage().data_ptr(): (n, p.numel()) for n, p in stacked}
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs)):
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            hit = self.stacked.get(t.untyped_storage().data_ptr())
            if hit is None or t.numel() != hit[1]:
                continue
            for o in tree_leaves(out):
                if (isinstance(o, torch.Tensor) and o.numel() == hit[1]
                        and o.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()):
                    self.copies.append((hit[0], str(func)))
        return out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SERVED)
def test_serving_copies_no_stacked_parameter(name, compute):
    """The paged and the dense serve and ``generate`` with bf16 parameters
    (float32 compute casts one layer's leaf at a use, never a stack)."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), compute_dtype=compute, **BF16)
    model = Model(cfg, device="cpu", seed=0)
    stacked = [(n, getattr(model, n)) for n in model._groups["blocks"]]
    assert any(p.dtype == torch.bfloat16 for _, p in stacked)
    server = Server(model, ClusterSpec.make(*fam.FLEET),
                    ServeConfig(block_rows=64, deadline_safety=50.0))
    trace = wl.make_workload("poisson", num_requests=3, prompt_len=(4, 20), out_len=(2, 5),
                             vocab=512).trace(seed=0)
    mode = _StackCopies(stacked)
    with mode:
        paged = server.serve(trace, slots=2, decode_block=2, prefill_chunk=8)
        dense = server.serve(trace, slots=2, decode_block=2, paged=False)
        out = server.generate(np.zeros((2, 6), np.int32), 3)
    assert mode.copies == []
    for rep in (paged, dense):
        assert rep.tokens == sum(r.out_len for r in trace) and rep.shed == 0
    assert tuple(out.shape) == (2, 9)
