"""Dry-run: count every (arch x shape x mesh) cell on ``meta`` tensors.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 256 / 512 placeholder TPU devices and reads XLA's cost and
memory analyses. The port has no compiler to ask. It runs one step of
the cell on a ``meta`` model (shapes only: no memory, no values, every
config up to grok-1-314b) under ``Counter``, a dispatch mode that sees
each operation the step dispatches:

* train: ``loss_fn``, the backward under the per-layer checkpoint, then
  AdamW (bf16 moments above 5e10 parameters, the reference's rule);
* prefill: ``lm_logits``; decode: ``decode_step`` on the dense cache.

FLOPs are ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
registry: the matrix products) plus each kernel's cost function
(``kernels/*/ops.py``, reported through ``kernels._cuda.record_cost``:
B4's forward 2 T V D, each backward 4 T V D). Bytes are the operand and
result bytes of each dispatched operation (views move none): an unfused
upper bound. XLA's bytes are post-fusion, so the two packages' bytes are
not comparable. The attention block loops, the SSD chunk loop and the
xLSTM time loops are Python loops here, so the count sees every
iteration; ``analytic_inner_costs`` (the reference's correction for its
while loops, counted once by XLA) is kept and reported beside the count,
never added to it.

Counting costs host time per dispatched operation (tens of microseconds
on ``meta``), so a cell is counted at reduced depth and length and
extrapolated (``roofline_cell``). Depth: dense, moe and vlm at 1 and 2
layers; hybrid at (1 layer, 1 shared call), (2, 1) and (2, 2); audio at
(1, 1), (2, 1) and (1, 2) decoder and encoder layers; ssm at full depth
(its layers are not alike). Length, for train and prefill cells: four
lengths, whole multiples of the attention blocks, through which the
count is a polynomial of degree 3 in S (``length_samples``: the block
loop runs S^2 / (q_block kv_block) times, and its backward's slice
gradients are each a whole sequence long; an xLSTM step at S 32,768,
one position at a time, would be hours of dispatch). Decode cells are
counted in full. The count is deterministic and exactly affine in the
layers and cubic in S there, so the extrapolation is exact (the tests
hold it against full counts at reduced sizes). The peak live bytes are
an estimate: affine in the layers, and linear in S through the two
longest samples.

Per device, on the mesh's rules (``sharding.rules``): ``Counter`` tags
each tensor as batch-partitioned (it derives from the batch, the cache
or a gradient) and model-partitioned (it derives from a parameter the
rules shard on ``model``, through a column-parallel product, or from
such an activation; a row-parallel product's output is reduced and
not). An operation's FLOPs and bytes are divided by the batch shard
count and the model extent where its operands carry those tags: a
weight that a rule leaves replicated on ``model`` is computed in full on
every model shard. Memory: argument bytes (parameters, moments, batch,
cache) from each leaf's local shard under its spec; output and temp
bytes from the peak live bytes of the meta run, each tensor split by its
tags. Collective bytes are an analytic partition of the same rules, not
a partitioned program (``collective_estimate``: FSDP all-gathers at each
use, the remat recompute included, gradient reduce-scatters and
all-reduces, tensor-parallel all-reduces at row-parallel outputs, the
MoE's all-to-all). The reference's HLO parse (``_COLLECTIVE_RE``,
``collective_bytes``) has no counterpart.

Roofline constants are the card's: NVIDIA H100 80GB HBM3 (SXM5), 700 W.
``--scan-layers`` has no meaning (nothing is scanned) and argparse
refuses it. One card is sized in Python: ``roofline_cell(config, shape,
mesh=MeshShape({"data": 1, "model": 1}))``, on a config with any
``param_dtype`` (``dataclasses.replace``).

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import fractions
import functools
import json
import math
import os
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_arch, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.engine import CodedComputeEngine
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import make_scheme, scheme_names
from repro_torch.data.pipeline import make_batch_specs, make_extras
from repro_torch.kernels import _cuda
from repro_torch.kernels.coded_matvec.ops import blocked_matvec_cost
from repro_torch.kernels.mds_encode.ops import mds_encode_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model, jax_path, padded_vocab
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.train_loop import make_train_step_fn
from repro_torch.sharding import rules

# NVIDIA H100 80GB HBM3 (SXM5), 700 W: data-sheet roofline constants
PEAK_FLOPS = 989e12  # bf16 dense tensor FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 450e9  # bytes/s per card, one direction
HBM_BYTES = 80e9  # device memory per card

_MATMULS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
            torch.ops.aten.baddbmm}
_ADD_MM = (torch.ops.aten.addmm, torch.ops.aten.baddbmm)
_TRANSPOSES = (torch.ops.aten.t, torch.ops.aten.transpose, torch.ops.aten.permute)
_EMPTY = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.new_empty,
          torch.ops.aten.empty_strided, torch.ops.aten.new_empty_strided}
_COPIES = {torch.ops.aten._to_copy, torch.ops.aten.clone, torch.ops.aten.detach,
           torch.ops.aten.alias, torch.ops.aten.lift_fresh}
#: tag of a tensor: (batch-partitioned, model-partitioned, parameter model dim)
#: the dim is None for an activation, "rep" for a parameter that ``model``
#: does not split, -1 / -2 for the last / second-last dim, "lead" for another
_ACT = (False, False, None)
BUCKETS = ((False, False), (False, True), (True, False), (True, True))


def _tag(t) -> tuple:
    return getattr(t, "_dryrun_tag", _ACT)


def _tensors(items) -> list:
    """The tensors among ``items``, one level of lists and tuples down."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _swap(pd):
    return {-1: -2, -2: -1}.get(pd, pd)


@dataclasses.dataclass
class Count:
    """One counted step. ``flops`` / ``nbytes``: by (batch, model) tag
    bucket (``BUCKETS``), global; ``peak``: peak live bytes per device,
    by split (batch shards, model extent); ``kernels``: name -> [calls,
    FLOPs, bytes], global."""

    flops: dict
    nbytes: dict
    peak: dict
    kernels: dict
    ops: int = 0

    def total_flops(self) -> float:
        return sum(self.flops.values())

    def total_bytes(self) -> float:
        return sum(self.nbytes.values())

    def per_device(self, split: tuple) -> tuple[float, float]:
        """(FLOPs, bytes) per device at (batch shards, model extent)."""
        b, m = split
        f = {(bt, mt): (b if bt else 1) * (m if mt else 1) for bt, mt in BUCKETS}
        return (sum(v / f[k] for k, v in self.flops.items()),
                sum(v / f[k] for k, v in self.nbytes.items()))

    @staticmethod
    def combine(terms: list) -> "Count":
        """sum(coef * count) over (coef, peak coef, count) terms, field by
        field; the peak takes its own coefficients."""
        def lin(get, i=0):
            keys = get(terms[0][2]).keys()
            return {k: sum(t[i] * get(t[2])[k] for t in terms) for k in keys}

        names = set().union(*(t[2].kernels for t in terms))
        kernels = {n: [sum(c * x.kernels.get(n, [0, 0, 0])[i] for c, _, x in terms)
                       for i in range(3)] for n in names}
        return Count(lin(lambda x: x.flops), lin(lambda x: x.nbytes),
                     lin(lambda x: x.peak, 1), kernels, sum(t[2].ops for t in terms))


class Counter(TorchDispatchMode):
    """Counts FLOPs, bytes and live memory of every operation it sees.

    ``splits``: the (batch shards, model extent) pairs to track peak live
    bytes for. Tensors made outside the mode carry no tag unless
    ``tag`` marks them (parameters, moments, batch, cache). Kernels
    report through ``kernels._cuda.record_cost`` while the counter is
    active, and the plain versions they run on the CPU are hidden
    (``paused``).
    """

    def __init__(self, splits=((1, 1),)):
        super().__init__()
        self.splits = tuple(splits)
        self.paused = 0
        self.ops = 0
        self.flops = dict.fromkeys(BUCKETS, 0.0)
        self.nbytes = dict.fromkeys(BUCKETS, 0.0)
        self.kernels: dict = {}
        self.live = [0.0] * len(self.splits)
        self.peak = [0.0] * len(self.splits)
        self._sizes: dict = {}  # id(storage) -> (weak reference, live bytes per split)

    @staticmethod
    def tag(t: torch.Tensor, *, batch: bool = False, model: bool = False, param=None):
        """Mark a tensor made outside the mode (``param``: its model dim,
        ``_tag``'s third entry)."""
        t._dryrun_tag = (batch, model, param)

    def __enter__(self):
        _cuda.TALLIES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _cuda.TALLIES.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ memory
    def _alloc(self, t: torch.Tensor, tag: tuple) -> None:
        """Count a new storage live until its last tensor, view or saved
        alias dies (a weak reference to the storage)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        sizes = [n / ((b if tag[0] else 1) * (m if tag[1] else 1)) for b, m in self.splits]
        self._sizes[key] = (weakref.ref(st, lambda _, k=key: self._free(k)), sizes)
        for i, s in enumerate(sizes):
            self.live[i] += s
            if self.live[i] > self.peak[i]:
                self.peak[i] = self.live[i]

    def _free(self, key) -> None:
        entry = self._sizes.pop(key, None)
        if entry is not None:
            for i, s in enumerate(entry[1]):
                self.live[i] -= s

    def _retag(self, t: torch.Tensor, tag: tuple) -> None:
        t._dryrun_tag = tag
        key = id(t.untyped_storage())
        if key in self._sizes:
            self._free(key)
            self._alloc(t, tag)

    # ------------------------------------------------------------ counting
    def kernel(self, name, flops, nbytes, inputs, outputs) -> None:
        """One kernel call (``_cuda.record_cost``): its work in the bucket of
        its inputs' tags; each output batch-partitioned as the inputs, and
        model-partitioned when a model-partitioned input has its shape."""
        tags = [_tag(t) for t in inputs]
        bt = any(t[0] for t in tags)
        mt = any(t[1] for t in tags)
        self.flops[(bt, mt)] += flops
        self.nbytes[(bt, mt)] += nbytes
        rec = self.kernels.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        shapes = [tuple(t.shape) for t, g in zip(inputs, tags) if g[1]]
        for out in outputs:
            self._retag(out, (bt, tuple(out.shape) in shapes, None))

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _kind(func) -> tuple:
        """(packet, is_view, kind) of an operation: kind is "mm" (a product
        with a FLOP formula), "copy", "empty" or ""."""
        packet = func._overloadpacket
        kind = ("mm" if packet in _MATMULS else "copy" if packet in _COPIES
                else "empty" if packet in _EMPTY else "")
        return packet, func.is_view, kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        self.ops += 1
        packet, is_view, kind = self._kind(func)
        ins = _tensors(args) + (_tensors(kwargs.values()) if kwargs else [])
        outs = _tensors((out,))
        tags = [_tag(t) for t in ins]
        bt = any(t[0] for t in tags)
        flops = 0
        if kind == "mm":
            a, b = args[1:3] if packet in _ADD_MM else args[:2]
            ta, tb = _tag(a), _tag(b)
            mt_op = any(t[1] for t in tags)
            if tb[2] in (-1, -2):  # parameter on the right: contracts its dim -2
                mt_out = tb[2] == -1
            elif ta[2] in (-1, -2):  # parameter on the left: contracts its dim -1
                mt_out = ta[2] == -2
            elif "lead" in (ta[2], tb[2]):
                mt_out = True
            else:
                mt_out = any(t[1] for t in tags if t[2] is None)
            tag_out = (bt, mt_out, None)
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        else:
            mt_op = any(t[1] for t in tags if t[2] is None)
            params = [t for t in tags if t[2] is not None]
            if (is_view or kind == "copy") and len(ins) == 1 and params:
                pd = params[0][2]
                if packet in _TRANSPOSES and self._swaps_last(func, args):
                    pd = _swap(pd)
                elif (pd in (-1, -2) and packet is not torch.ops.aten.slice
                      and tuple(outs[0].shape[-2:]) != tuple(ins[0].shape[-2:])):
                    pd = "lead" if params[0][1] else "rep"
                tag_out = (params[0][0], params[0][1], pd)
                mt_op = params[0][1]
            else:
                tag_out = (bt, mt_op, None)
        nbytes = 0
        if not is_view and kind != "empty":
            nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        bucket = (bt, mt_op)
        self.flops[bucket] += flops
        self.nbytes[bucket] += nbytes
        inplace = bool(ins) and bool(outs) and outs[0] is ins[0]
        for t in outs:
            if inplace and t is ins[0]:
                if tags[0][2] is None:  # an activation written in place
                    t._dryrun_tag = (tags[0][0] or bt, tags[0][1] or mt_op, None)
                continue
            t._dryrun_tag = tag_out
            if not is_view:
                self._alloc(t, tag_out)
        return out

    @staticmethod
    def _swaps_last(func, args) -> bool:
        """Whether a t / transpose / permute swaps the last two dims."""
        nd = args[0].dim()
        if func._overloadpacket is torch.ops.aten.t:
            return nd == 2
        if func._overloadpacket is torch.ops.aten.transpose:
            return {args[1] % nd, args[2] % nd} == {nd - 1, nd - 2}
        perm = [p % nd for p in args[1]]
        return nd >= 2 and perm[-1] == nd - 2 and perm[-2] == nd - 1

    def result(self) -> Count:
        return Count(dict(self.flops), dict(self.nbytes),
                     dict(zip(self.splits, self.peak)),
                     {n: list(v) for n, v in self.kernels.items()}, self.ops)


# ------------------------------------------------------------------ closed forms
def analytic_inner_costs(config: ModelConfig, shape: ShapeConfig) -> dict:
    """The reference's analytic FLOPs/bytes of its INNER scanned loops.

    XLA counts a while-loop body once, so the reference adds the flash
    attention block scans, the Mamba2 chunk scan and the xLSTM time scan
    analytically. The port's counter sees every iteration of its Python
    loops, so this stays beside the count as the reference's term and is
    never added to it.

    * attention:  4*B*H*Sq*Skv*hd fwd (scores + AV, both sides of the
      softmax); x3 for train (backward ~2x fwd) + x1 remat recompute.
      Baseline computes masked causal blocks, so Skv is NOT halved.
      bytes: flash streams K,V once per q block: nq * Skv * KV * hd * 2.
    * mamba2: 2*B*S*(Q*d_inner + Q*N + 2*N*d_inner) fwd per layer.
    * xlstm: mLSTM 4*B*S*d_in*hd + sLSTM 8*B*S*d*hd fwd per layer.

    Decode cells have no inner scans -> zero correction.
    """
    c = config
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    train_mult = 4.0 if shape.kind == "train" else 1.0  # fwd+remat+~2x bwd
    bytes_dt = 2  # bf16 compute
    flops = 0.0
    byts = 0.0
    hd = c.resolved_head_dim
    if c.family in ("dense", "vlm", "moe", "audio"):
        n_attn_layers = c.num_layers + (
            c.num_encoder_layers if c.family == "audio" else 0
        )
        sq = s + (c.num_image_tokens if c.family == "vlm" else 0)
        skv_eff = min(c.sliding_window or sq, sq)
        if c.causal_block_skip:  # lower-triangular iteration: ~half
            skv_eff = skv_eff / 2.0 + min(c.attn_kv_block, sq) / 2.0
        nq = max(sq // min(c.attn_q_block, sq), 1)
        flops += n_attn_layers * 4.0 * b * c.num_heads * sq * skv_eff * hd
        byts += (n_attn_layers * nq * skv_eff * c.num_kv_heads * hd
                 * 2 * bytes_dt * b)
        if c.family == "audio":  # cross-attention to encoder frames
            flops += c.num_layers * 4.0 * b * c.num_heads * s * c.encoder_seq * hd
    if c.family == "hybrid":
        d_inner = c.mamba_expand * c.d_model
        q = c.mamba_chunk
        flops += c.num_layers * 2.0 * b * s * (
            q * d_inner + q * c.ssm_state + 2 * c.ssm_state * d_inner
        )
        n_inv = -(-c.num_layers // max(c.attn_every, 1))
        flops += n_inv * 4.0 * b * c.num_heads * s * s * hd
        byts += n_inv * (s // min(c.attn_q_block, s)) * s * c.num_kv_heads * hd \
            * 2 * bytes_dt * b
    if c.family == "ssm":  # xLSTM time scans
        d_in = int(c.d_model * c.proj_factor)
        hd_x = d_in // c.num_heads
        n_s = sum(
            1 for i in range(c.num_layers)
            if c.slstm_every and (i + 1) % c.slstm_every == 0
        )
        n_m = c.num_layers - n_s
        flops += n_m * 4.0 * b * s * d_in * hd_x
        flops += n_s * 8.0 * b * s * c.d_model * (c.d_model // c.num_heads)
    return {"flops": flops * train_mult, "bytes": byts * train_mult}


def coded_head_record(config: ModelConfig, cluster: ClusterSpec, *,
                      scheme="optimal", block_rows: int = 256) -> dict:
    """Closed-form coded-LM-head deployment stats for one arch (no count).

    The same ``CodedComputeEngine`` path the serving loop deploys: kb
    vocab blocks of ``block_rows`` rows (ceil, matching CodedLMHead),
    MDS-coded over the cluster under the requested registered scheme
    (name or AllocationScheme object).
    """
    kb = -(-padded_vocab(config.vocab_size) // block_rows)
    eng = CodedComputeEngine(cluster, kb, scheme)
    return {
        "scheme": eng.plan.scheme,
        "block_rows": block_rows,
        "kb": kb,
        "nb": eng.plan.n,
        "rate": eng.plan.rate,
        "workers": eng.plan.num_workers,
        "max_blocks_per_worker": eng.plan.max_load,
        "t_star": eng.t_star,
        "deadline": eng.deadline(),
    }


def coded_head_kernels(config: ModelConfig, head: dict, batch: int) -> dict:
    """The coded head's kernel work for a decode step of ``batch`` rows, by
    the kernels' cost functions: B1 mixes the (kb, batch x block_rows)
    logit blocks once a step, B3 encodes the (kb, block_rows x D) table
    once a plan."""
    nb, kb, r = head["nb"], head["kb"], head["block_rows"]
    b1 = blocked_matvec_cost(nb, kb, batch * r)
    b3 = mds_encode_cost(nb, kb, r * config.d_model)
    return {"coded_matvec": {"flops": b1[0], "bytes": b1[1], "per": "decode step"},
            "mds_encode": {"flops": b3[0], "bytes": b3[1], "per": "plan"}}


def _parse_cluster(groups: str, bandwidth: float | None = None) -> ClusterSpec:
    """'6:2.0,6:0.5[:bw]' -> ClusterSpec (same syntax as launch/serve.py)."""
    return ClusterSpec.parse(groups, bandwidth)


def model_flops(config: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N_active per token (decode)."""
    m = Model(config, device="meta")
    n_active = m.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


# ------------------------------------------------------------------ one step
def opt_config(model: Model) -> AdamWConfig:
    """The reference's dry-run optimizer: bf16 moments above 5e10 parameters."""
    return AdamWConfig(moment_dtype="bfloat16" if model.param_count() > 5e10 else "float32")


def step_inputs(model: Model, shape: ShapeConfig) -> dict:
    """The step's arguments on the model's device: the train batch and
    AdamW state, the prefill tokens (and extras), or the decode cache
    (the dense ``init_cache``; audio with a stand-in encoder output),
    tokens and position."""
    c, dev = model.config, model.device
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = (make_batch_specs(c, shape) if dev.type == "meta" else
                 {"tokens": torch.zeros((b, s), dtype=torch.int32, device=dev),
                  "labels": torch.zeros((b, s), dtype=torch.int32, device=dev),
                  **({"extras": make_extras(c, b, device=dev)}
                     if c.family in ("vlm", "audio") else {})})
        return {"batch": batch,
                "opt_state": adamw_init(opt_config(model), dict(model.named_parameters()))}
    if shape.kind == "prefill":
        return {"tokens": torch.zeros((b, s), dtype=torch.int32, device=dev),
                "extras": make_extras(c, b, device=dev)}
    extras = None
    if c.family == "audio":
        extras = {"enc_out": torch.zeros((b, c.encoder_seq, c.d_model), dtype=c.cdtype,
                                         device=dev)}
    return {"cache": model.init_cache(b, s, extras),
            "tokens": torch.zeros((b,), dtype=torch.int32, device=dev), "pos": s - 1}


def run_step(model: Model, shape: ShapeConfig, inputs: dict):
    """One step of the cell (what the counter counts)."""
    if shape.kind == "train":
        step = make_train_step_fn(model, opt_config(model))
        return step(inputs["opt_state"], inputs["batch"])
    if shape.kind == "prefill":
        with torch.no_grad():
            return model.lm_logits(inputs["tokens"], inputs["extras"])
    return model.decode_step(inputs["cache"], inputs["tokens"], inputs["pos"])


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _model_dim(spec: tuple):
    """``_tag``'s parameter model dim of a spec (the last two dims are a
    product's operand dims, for a stacked or an expert weight too)."""
    if "model" not in spec:
        return "rep"
    d = spec.index("model") - len(spec)
    return d if d in (-1, -2) else "lead"


def tag_inputs(model: Model, inputs: dict, mesh) -> dict:
    """Tag the parameters, moments, batch and cache for ``Counter`` by the
    mesh's rules; returns the parameters' specs."""
    specs = rules.param_specs(mesh, model)
    for name, p in model.named_parameters():
        spec = specs[name]
        Counter.tag(p, model="model" in spec, param=_model_dim(spec))
    for moment in ("m", "v"):
        for name, t in inputs.get("opt_state", {}).get(moment, {}).items():
            Counter.tag(t, model="model" in specs[name], param=_model_dim(specs[name]))
    for key in ("batch", "tokens", "extras"):
        for _, t in _leaves(inputs.get(key)):
            Counter.tag(t, batch=True)
    for path, t in _leaves(inputs.get("cache")):
        spec = rules.cache_spec(rules.cache_path(path), t.shape, mesh)
        Counter.tag(t, batch=True, model="model" in spec)
    return specs


def untag(model: Model, inputs: dict) -> None:
    for t in [*model.parameters(), *(t for _, t in _leaves(inputs))]:
        t.__dict__.pop("_dryrun_tag", None)


def count_step(config: ModelConfig, shape: ShapeConfig, mesh, splits) -> Count:
    """Count one step of ``config`` at ``shape`` on a meta model."""
    model = Model(config, device="meta")
    inputs = step_inputs(model, shape)
    tag_inputs(model, inputs, mesh)
    try:
        with Counter(splits) as counter:
            out = run_step(model, shape, inputs)
            del out
        return counter.result()
    finally:
        untag(model, inputs)


def _interpolation(xs: list, x: int) -> list:
    """Lagrange coefficients of the values at ``xs`` for the polynomial
    through them at ``x`` (integers here: exact in float64)."""
    out = []
    for i, xi in enumerate(xs):
        c = fractions.Fraction(1)
        for j, xj in enumerate(xs):
            if j != i:
                c *= fractions.Fraction(x - xj, xi - xj)
        out.append(float(c))
    return out


def length_samples(config: ModelConfig, shape: ShapeConfig) -> list | None:
    """The four sequence lengths a train or prefill cell is counted at, or
    None when the cell is counted at its own length.

    A count is a polynomial of degree at most 3 in S over whole multiples
    of the attention blocks (``lcm(q_block, kv_block)``; and the Mamba2
    chunk): the block loop runs (S / q_block) (S / kv_block) times (its
    FLOPs are quadratic), and in a backward each iteration's slice of the
    queries and keys gets a gradient of the whole sequence's size (its
    bytes are cubic); the rest is linear. With a sliding window and the
    causal block skip the loop is linear once S reaches the window, so
    the samples start there. The xLSTM has no blocks: 8 ... 32 positions.
    """
    c = config
    if shape.kind == "decode":
        return None
    if c.family == "ssm":
        unit, start = 8, 8
    else:
        unit = math.lcm(c.attn_q_block, c.attn_kv_block,
                        c.mamba_chunk if c.family == "hybrid" else 1)
        start = unit
        if c.sliding_window is not None:
            start = max(unit, -(-c.sliding_window // unit) * unit)
    xs = [start + i * unit for i in range(4)]
    return xs if shape.seq_len > xs[-1] else None


def layer_terms(config: ModelConfig) -> tuple[list, str]:
    """(coefficient, config) terms whose counts sum to the full depth's
    (the count is affine in the layers), and the method's name."""
    c = config
    rep = dataclasses.replace
    if c.family == "ssm" or (c.family not in ("hybrid", "audio") and c.num_layers <= 2):
        return [(1.0, c)], "full"
    if c.family == "hybrid":
        no_attn = 10 ** 6
        ld, n_inv = c.num_layers - 1, -(-c.num_layers // max(c.attn_every, 1))
        return [(1 - ld, rep(c, num_layers=1, attn_every=no_attn)),
                (ld - (n_inv - 1), rep(c, num_layers=2, attn_every=no_attn)),
                (n_inv - 1, rep(c, num_layers=2, attn_every=1))], "layer_delta"
    if c.family == "audio":
        ld, le = c.num_layers - 1, c.num_encoder_layers - 1
        return [(1 - ld - le, rep(c, num_layers=1, num_encoder_layers=1)),
                (ld, rep(c, num_layers=2, num_encoder_layers=1)),
                (le, rep(c, num_layers=1, num_encoder_layers=2))], "layer_delta"
    return [(2 - c.num_layers, rep(c, num_layers=1)),
            (c.num_layers - 1, rep(c, num_layers=2))], "layer_delta"


def extrapolated_count(config: ModelConfig, shape: ShapeConfig, mesh, splits
                       ) -> tuple[Count, str]:
    """The cell's count by the cheapest exact route (module docstring):
    the layer terms (``layer_terms``) times the length terms
    (``length_samples``); returns (count, method)."""
    layers, method = (layer_terms(config) if shape.kind != "decode"
                      else ([(1.0, config)], "full"))
    xs = length_samples(config, shape)
    lengths = [(1.0, 1.0, shape)]
    if xs is not None:
        # the peak is linear in S past the blocks (activations, logits):
        # extrapolated from the two longest samples
        lin = [0.0, 0.0, *_interpolation(xs[2:], shape.seq_len)]
        lengths = [(k, p, dataclasses.replace(shape, seq_len=x))
                   for k, p, x in zip(_interpolation(xs, shape.seq_len), lin, xs)]
        method = "length_delta" if method == "full" else method + "+length_delta"
    terms = [(a * b, a * p, count_step(cfg, shp, mesh, splits))
             for a, cfg in layers for b, p, shp in lengths]
    return (terms[0][2] if len(terms) == 1 else Count.combine(terms)), method


# ------------------------------------------------------------------ per device
def _shards(spec: tuple, extent: dict) -> int:
    n = 1
    for ax in spec:
        for a in ((ax,) if isinstance(ax, str) else ax or ()):
            n *= extent[a]
    return n


def splits_of(mesh, shape: ShapeConfig) -> tuple[int, int]:
    """(batch shards, model extent) of a cell on a mesh."""
    extent = rules.mesh_axes(mesh)
    spec = rules.batch_specs(mesh, shape.global_batch)
    return _shards(spec[:1], extent), extent.get("model", 1)


def argument_bytes(model: Model, shape: ShapeConfig, mesh, inputs: dict) -> dict:
    """Per-device bytes of the step's arguments, each leaf's local shard."""
    extent = rules.mesh_axes(mesh)
    specs = rules.param_specs(mesh, model)

    def local(t, spec):
        return t.numel() * t.element_size() / _shards(spec, extent)

    out = {"params": sum(local(p, specs[n]) for n, p in model.named_parameters())}
    if "opt_state" in inputs:
        out["moments"] = sum(local(t, specs[n]) for m in ("m", "v")
                             for n, t in inputs["opt_state"][m].items())
    for key in ("batch", "tokens", "extras"):
        for _, t in _leaves(inputs.get(key)):
            out["batch"] = out.get("batch", 0.0) + local(
                t, rules.batch_leaf_spec(mesh, t.shape))
    for path, t in _leaves(inputs.get("cache")):
        out["cache"] = out.get("cache", 0.0) + local(
            t, rules.cache_spec(rules.cache_path(path), t.shape, mesh))
    return out


def collective_estimate(model: Model, shape: ShapeConfig, mesh) -> dict:
    """Per-device collective bytes of one step, reckoned from the rules.

    An analytic partition, not a partitioned program; each term counts a
    collective's result bytes on one device, as the reference's parse
    does:

    * all-gather: every parameter the rules shard on ``data`` is
      gathered at each use (FSDP): once a pass, three times in a train
      step with remat (forward, the recompute, the backward), twice
      without; the hybrid's shared block once per call;
    * reduce-scatter: the gradient of each ``data``-sharded parameter;
      all-reduce: the gradient of each parameter the batch axes hold
      whole;
    * all-reduce: the (local tokens, D) output of each row-parallel
      product (``model`` on its input dim: wo, w_down, w_out, the
      vocab-parallel embedding lookup), once a pass, and in a train
      step for the column-parallel input gradients of the backward;
    * all-to-all: dispatch and combine of each MoE layer whose experts
      ``model`` shards, 2 x (local tokens x top_k x D) a pass.
    """
    c = model.config
    extent = rules.mesh_axes(mesh)
    specs = rules.param_specs(mesh, model)
    stacked = rules._stacked_names(model)
    b_shards, m = splits_of(mesh, shape)
    item = c.cdtype.itemsize
    seq = 1 if shape.kind == "decode" else shape.seq_len + (
        c.num_image_tokens if c.family == "vlm" else 0)
    tokens = shape.global_batch * seq / b_shards
    train = shape.kind == "train"
    passes = (3 if c.remat else 2) if train else 1
    calls = {n: model.n_shared_attn_calls() for n in model._groups["shared"]}
    out = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute"), 0.0)
    count = 0
    data = extent.get("data", 1) > 1
    for name, p in model.named_parameters():
        spec = specs[name]
        nbytes = p.numel() * p.element_size()
        uses = calls.get(name, 1)
        if "data" in spec and data:
            out["all-gather"] += passes * uses * nbytes / _shards(
                tuple(a if a == "model" else None for a in spec), extent)
            count += passes * uses
            if train:
                out["reduce-scatter"] += nbytes / _shards(spec, extent)
                count += 1
        elif train and b_shards > 1:
            out["all-reduce"] += nbytes / _shards(spec, extent)
            count += 1
        if m == 1:
            continue
        path = jax_path(name)
        layers = p.shape[0] if name in stacked else 1
        rows = shape.global_batch * (c.encoder_seq if path.startswith("encoder") else seq
                                     ) / b_shards
        core = spec[int(name in stacked):]
        if len(core) == 2 and core[0] == "model" and name != "embed":
            d_out = p.shape[-1]
            out["all-reduce"] += passes * uses * layers * rows * d_out * item
            count += passes * uses * layers
        if name == "embed" and "model" in spec:
            out["all-reduce"] += passes * tokens * c.d_model * item
            count += passes
        if name == "expert_up" and spec[1] == "model":
            out["all-to-all"] += passes * layers * 2 * tokens * c.top_k * c.d_model * item
            count += passes * layers * 2
    out["count"] = count
    out["total"] = sum(v for k, v in out.items() if k not in ("count", "total"))
    return out


# ------------------------------------------------------------------ records
def _record(config: ModelConfig, shape: ShapeConfig, mesh, name: str, cnt: Count,
            method: str, count_s: float) -> dict:
    model = Model(config, device="meta")
    inputs = step_inputs(model, shape)
    split = splits_of(mesh, shape)
    chips = math.prod(rules.mesh_axes(mesh).values())
    flops_dev, bytes_dev = cnt.per_device(split)
    args = argument_bytes(model, shape, mesh, inputs)
    coll = collective_estimate(model, shape, mesh)
    mflops = model_flops(config, shape)
    inner = analytic_inner_costs(config, shape)
    arg_b = sum(args.values())
    temp_b = cnt.peak[split]
    record = {
        "arch": config.name,
        "shape": shape.name,
        "kind": shape.kind,
        "scan_layers": False,
        "mesh": name,
        "chips": chips,
        "method": method,
        # the reference's compile time: here the count's host seconds
        "compile_seconds": round(count_s, 1),
        "counted_ops": cnt.ops,
        "flops_global": cnt.total_flops(),
        "bytes_global_unfused": cnt.total_bytes(),
        "kernels": {n: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                    for n, v in cnt.kernels.items()},
        # the reference's HLO cost keys hold the count (bytes unfused)
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        # nothing is added: the count sees every loop iteration
        "inner_scan_correction": {"flops": 0.0, "bytes": 0.0},
        "reference_inner_scan_term": inner,
        "flops_per_device_corrected": flops_dev,
        "bytes_per_device_corrected": bytes_dev,
        "collective_bytes_per_device": coll,
        "memory_analysis": {"argument_bytes": arg_b, "arguments": args,
                            "output_and_temp_bytes": temp_b, "output_bytes": None,
                            "temp_bytes": None, "generated_code_bytes": None},
        "memory_per_device_bytes": arg_b + temp_b,
        "fits": arg_b + temp_b <= HBM_BYTES,
        "model_flops": mflops,
        "t_compute": flops_dev / PEAK_FLOPS,
        "t_memory": bytes_dev / HBM_BW,
        "t_collective": coll["total"] / NVLINK_BW,
        "useful_flops_ratio": mflops / max(flops_dev * chips, 1.0),
        "constants": {"card": "NVIDIA H100 80GB HBM3 (SXM5), 700 W",
                      "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW, "hbm_bytes": HBM_BYTES},
    }
    terms = {k: record[k] for k in ("t_compute", "t_memory", "t_collective")}
    record["bottleneck"] = max(terms, key=terms.get)
    record["roofline_fraction"] = record["t_compute"] / max(max(terms.values()), 1e-30)
    return record


def mesh_name(multi_pod: bool) -> str:
    return "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"


def roofline_cell(config: ModelConfig, shape: ShapeConfig, *, multi_pod: bool = False,
                  verbose: bool = True, mesh=None) -> dict:
    """The roofline record of one cell, counted by ``extrapolated_count``
    (``mesh``: any mesh, else the production mesh of ``multi_pod``)."""
    return roofline_cells(config, shape, (multi_pod,), verbose=verbose, mesh=mesh)[0]


def roofline_cells(config: ModelConfig, shape: ShapeConfig, multi_pods=(False, True), *,
                   verbose: bool = True, mesh=None) -> list[dict]:
    """One record per mesh, from one count: the tags do not depend on
    the mesh when the meshes' parameter specs agree (the production
    meshes both have a 16-wide ``model`` axis), only the splits do."""
    meshes = ([(mesh, "local")] if mesh is not None else
              [(make_production_mesh(multi_pod=mp), mesh_name(mp)) for mp in multi_pods])
    proto = Model(config, device="meta")
    groups: dict = {}
    for m, name in meshes:
        key = tuple(sorted(rules.param_specs(m, proto).items()))
        groups.setdefault(key, []).append((m, name))
    records = {}
    for group in groups.values():
        t0 = time.perf_counter()
        cnt, method = extrapolated_count(config, shape, group[0][0],
                                         [splits_of(m, shape) for m, _ in group])
        count_s = time.perf_counter() - t0
        for m, name in group:
            records[name] = _record(config, shape, m, name, cnt, method, count_s)
    out = [records[name] for _, name in meshes]
    if verbose:
        for r in out:
            print(f"[dryrun] {r['arch']:24s} {r['shape']:12s} {r['mesh']:20s} "
                  f"method={r['method']:12s} count={r['compile_seconds']:6.1f}s "
                  f"flops/dev={r['hlo_flops_per_device']:.3e} "
                  f"bytes/dev={r['hlo_bytes_per_device']:.3e} "
                  f"coll/dev={r['collective_bytes_per_device']['total']:.3e} "
                  f"mem/dev={r['memory_per_device_bytes']:.3e} "
                  f"fits={r['fits']} bottleneck={r['bottleneck']}")
    return out


def dryrun_cell(config: ModelConfig, shape: ShapeConfig, *, multi_pod: bool,
                verbose: bool = True) -> dict:
    """Count one cell; return its roofline record (``roofline_cell``)."""
    return roofline_cell(config, shape, multi_pod=multi_pod, verbose=verbose)


class _Refuse(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported: the port scans no layers "
                     f"(every count sees each layer)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--scan-layers", nargs=0, action=_Refuse, help=argparse.SUPPRESS)
    ap.add_argument("--roofline", action="store_true",
                    help="accepted for the reference's CLI: every cell is counted by "
                         "the exact layer / length extrapolation (roofline_cell)")
    ap.add_argument("--coded-groups", default=None,
                    help="N:mu worker groups; attaches the coded-LM-head "
                         "deployment record (CodedComputeEngine) and its kernels' "
                         "cost to every decode cell")
    ap.add_argument("--coded-scheme", default="optimal", choices=scheme_names(),
                    help="registered allocation scheme for --coded-groups")
    ap.add_argument("--coded-n", type=float, default=None,
                    help="code size n for --coded-scheme uniform_n")
    ap.add_argument("--coded-r", type=int, default=None,
                    help="completion count r for --coded-scheme uniform_r")
    ap.add_argument("--coded-bandwidth", type=float, default=None,
                    help="link bandwidth for --coded-groups entries without "
                         "an explicit N:mu:bw value (default: infinite)")
    ap.add_argument("--coded-upload", type=float, default=None,
                    help="fixed transfer cost for --coded-scheme comm_aware "
                         "/ comm_uniform")
    ap.add_argument("--coded-download", type=float, default=None,
                    help="per-row transfer cost for --coded-scheme "
                         "comm_aware / comm_uniform")
    args = ap.parse_args(argv)
    # resolve cluster + scheme up front so bad params fail before any count
    coded_cluster = (_parse_cluster(args.coded_groups, args.coded_bandwidth)
                     if args.coded_groups else None)
    coded_scheme = (make_scheme(args.coded_scheme, n=args.coded_n, r=args.coded_r,
                                upload=args.coded_upload, download=args.coded_download)
                    if coded_cluster is not None else None)

    os.makedirs(args.out, exist_ok=True)
    archs = [get_arch(args.arch)] if args.arch else list(ARCHS.values())
    meshes = {"single": (False,), "multi": (True,), "both": (False, True)}[args.mesh]

    failures = []
    t_all = time.perf_counter()
    for cfg in archs:
        shapes = shapes_for(cfg)
        if args.shape:
            shapes = [s for s in shapes if s.name == args.shape]
            if not shapes and args.shape in SHAPES_BY_NAME:
                print(f"[dryrun] {cfg.name}: shape {args.shape} SKIPPED (not applicable)")
        for shape in shapes:
            tags = [f"{cfg.name}_{shape.name}_{'multi' if mp else 'single'}" for mp in meshes]
            try:
                recs = roofline_cells(cfg, shape, meshes)
                for tag, rec in zip(tags, recs):
                    if coded_cluster is not None and shape.kind == "decode":
                        head = coded_head_record(cfg, coded_cluster, scheme=coded_scheme)
                        head["kernels"] = coded_head_kernels(cfg, head, shape.global_batch)
                        rec["coded_lm_head"] = head
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=1)
            except Exception as e:  # a cell that fails is reported, the rest still run
                failures += [(tag, repr(e)) for tag in tags]
                print(f"[dryrun] FAIL {tags}: {e!r}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print(f"\nAll dry-run cells counted in {time.perf_counter() - t_all:.1f} s.")


if __name__ == "__main__":
    main()
