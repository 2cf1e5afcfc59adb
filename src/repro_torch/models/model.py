"""Every model family of the reference (counterpart of ``repro/models/model.py``).

``Model`` is one ``nn.Module`` with the reference's family branches:

* ``dense`` and ``vlm``: llama-style pre-norm GQA blocks, the MLP the
  config's ``activation`` names (SwiGLU for ``silu``, else a plain GELU
  MLP); vlm (paligemma) prepends ``extras["image_embeds"]`` (B, T_img, D)
  to the text in ``lm_logits`` / ``loss_fn`` (causal over image and text
  at positions ``arange(T_img + S)``, the image rows dropped after) and
  serves text-only on the dense paths;
* ``moe``: the same attention; the FFN is top-k routed experts
  (``models/moe.py``);
* ``hybrid`` (zamba2): stacked Mamba2 blocks (``models/ssm.py``) and ONE
  shared dense block applied before layer ``i`` whenever ``i %
  attn_every == 0``, each call with its own KV slot in decode;
* ``ssm`` (xLSTM): heterogeneous mLSTM / sLSTM blocks (``models/xlstm.py``)
  in an ``nn.ModuleList`` of ``ParameterDict``s, layer ``i`` an sLSTM when
  ``(i + 1) % slstm_every == 0``;
* ``audio`` (whisper): a non-causal LayerNorm/GELU encoder over
  ``extras["frames"]`` with sinusoidal positions (``encode``), and a
  decoder of causal self attention, cross attention to the encoder
  output and a GELU MLP, no positional signal at all, a LayerNorm final
  norm; decode takes ``init_cache(..., extras={"enc_out"})`` and
  recomputes the cross K/V every step, as the reference.

Parameters are the reference's pytree with layers stacked on axis 0
(``scan_layers``; the xLSTM's per layer), one port name per reference
path (``JAX_NAMES``, ``jax_path``); a Python loop over layers takes
the place of ``lax.scan``. ``params_from_jax`` carries the reference's
``Model.init_params`` tree across and fails on a leaf missing or left
over; otherwise the module draws its own seeded init on its device at
any width, each leaf allocated in its final dtype (``param_dtype``; the
router, the Mamba2 scalars and the xLSTM gate weights float32, as the
reference's) and a stacked one filled a layer at a time from a float32
draw (``layers.normal_init``): a seed gives the same weights in every
parameter dtype up to the cast, and the init's peak is the parameters
plus one float32 draw (at most the embedding's).

The paged KV cache is ``{"k", "v"}`` of shape (L, NB+1, BL, KV, hd);
both paged entry points update it in place and return it (under
``torch.no_grad``). The dense caches are ``{"k", "v"}`` of shape
(L, B, S, KV, hd) plus ``pos``: (L, S) for ``decode_step`` (one position
for the whole batch, ``init_cache``: a rolling cache of ``min(S,
window)`` entries for a sliding-window model, int8 with per-(token,
head) float16 ``k_scale`` / ``v_scale`` for ``kv_quant``; hybrid: KV for
each shared call plus the ``ssm`` (L, B, H, N, P) float32 and ``conv``
(L, B, CONV_K - 1, conv_dim) states; ssm: ``{"xlstm": [state per
layer]}``; audio: plus ``enc_out``), (B, S) for ``decode_step_slots`` (a
position per row, ``init_slot_cache``); ``prefill`` is one batched
forward that returns every layer's post-rope prompt K/V for a splice.
They too are updated in place. The slot and paged paths take the
attention-cache families (dense, vlm, moe) and refuse ``kv_quant`` and
sliding windows, as the reference's. The parameters are trainable:
``hidden`` runs the training forward (causal chunked attention,
windowed and block-skipped as the config says, each layer under
``torch.utils.checkpoint`` when ``config.remat``, as the reference's
``jax.checkpoint``; the xLSTM's cells too, which the reference leaves
out: an mLSTM scan saves each step's (B, H, hd, hd) memory for its
backward, at least 19 GB a layer at xlstm-125m's 8 x 512), and
``loss_fn`` takes the cross entropy through the B4 fused kernel on the
card, so no (T, V) logits are materialized.
``lm_logits`` is the materialized oracle.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import xlstm
from repro_torch.kernels.fused_ce.ops import fused_ce
from repro_torch.models.attention import (
    attention,
    decode_attention,
    decode_attention_paged,
    decode_attention_slots,
    prefill_attention_paged,
)
from repro_torch.models.moe import init_moe, moe_ffn

NEG_INF = -1e30
#: the families ``Model`` implements: every family of the reference
FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")
_ATTN = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_MLP = ("w_gate", "w_up", "w_down")
_KV = ("k", "v", "pos", "k_scale", "v_scale")


def _path_table() -> dict:
    """Reference pytree path -> port parameter name, every family's
    stacked and unstacked leaves (the xLSTM's per-layer cells: ``jax_path``)."""
    t = {("embed", "table"): "embed", ("enc_norm", "scale"): "enc_norm",
         ("enc_norm", "bias"): "enc_norm_bias", ("blocks", "ln", "scale"): "ln"}
    for norm in ("final_norm", "blocks/ln1", "blocks/ln2", "blocks/ln_x",
                 "encoder/ln1", "encoder/ln2", "shared_attn/ln1", "shared_attn/ln2"):
        path = tuple(norm.split("/"))
        name = {"blocks": "", "encoder": "enc_", "shared_attn": "shared_"}.get(
            path[0], "") + path[-1]
        t[path + ("scale",)] = name
        t[path + ("bias",)] = f"{name}_bias"  # LayerNorm (audio)
    for n in _ATTN:
        t[("blocks", "attn", n)] = n
        t[("blocks", "self_attn", n)] = f"self_{n}"
        t[("blocks", "cross_attn", n)] = f"cross_{n}"
        t[("encoder", "attn", n)] = f"enc_{n}"
        t[("shared_attn", "attn", n)] = f"shared_{n}"
    for n in _MLP:
        t[("blocks", "mlp", n)] = n
        t[("encoder", "mlp", n)] = f"enc_{n}"
        t[("shared_attn", "mlp", n)] = f"shared_{n}"
        t[("blocks", "moe", n)] = f"expert_{n[2:]}"
    t[("blocks", "moe", "w_router")] = "w_router"
    for n in ssm.MAMBA_PARAMS:
        t[("blocks", "mamba", n)] = f"mamba_{n}"
    return t


#: port parameter name -> reference tree path ("blocks/attn/wq", ...)
JAX_NAMES = {name: "/".join(path) for path, name in _path_table().items()}


def jax_path(name: str) -> str:
    """The reference tree path of a port parameter: ``JAX_NAMES``, or for an
    xLSTM cell ``cells.<i>.<n>`` -> ``blocks/<i>/cell/<n>`` (``ln``:
    ``blocks/<i>/ln/scale``)."""
    if name in JAX_NAMES:
        return JAX_NAMES[name]
    _, i, n = name.split(".")
    return f"blocks/{i}/ln/scale" if n == "ln" else f"blocks/{i}/cell/{n}"


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict / list pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, sub in items:
        out.update(_flatten(sub, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _sub(p: dict, prefix: str) -> dict:
    """The entries of ``p`` named ``prefix*``, the prefix stripped."""
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _sinusoidal(seq: int, d: int) -> np.ndarray:
    """Whisper's encoder positions, (seq, d) float32: [sin | cos]."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10_000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def padded_vocab(v: int, multiple: int = 256) -> int:
    """Vocab padded to a multiple of 256 rows."""
    return int(-(-v // multiple) * multiple)


class Model(nn.Module):
    """Every family of the reference; paged decode and chunked paged
    prefill for the attention-cache ones."""

    def __init__(self, config: ModelConfig, *, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        if config.family not in FAMILIES:
            raise ValueError(f"unknown family {config.family!r} ({config.name})")
        self.config = c = config
        self.device = dev = resolve_device(device)
        # a meta model holds shapes only: nothing is drawn
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        nl, d, f, hd = c.num_layers, c.d_model, c.d_ff, c.resolved_head_dim
        fam = c.family
        #: parameter names by group: stacked per decoder layer, per encoder
        #: layer, and the hybrid's one shared block
        self._groups = {"blocks": [], "encoder": [], "shared": []}

        def add(group, name, t):  # t in its final dtype
            setattr(self, name, nn.Parameter(t))
            if group is not None:
                self._groups[group].append(name)

        def normal(lead, shape, scale):  # a stacked leaf (lead: (L,)) a layer at a time
            return L.normal_init((*lead, *shape), scale, c.pdtype, generator=gen,
                                 device=dev, stacked=bool(lead))

        def ones(*shape):
            return torch.ones(shape, dtype=c.pdtype, device=dev)

        def norm(group, name, lead, bias=False):
            add(group, name, ones(*lead, d))
            if bias:
                add(group, f"{name}_bias", torch.zeros((*lead, d), dtype=c.pdtype, device=dev))

        def attn(group, prefix, lead, qk_norm=False):
            h, kv = c.num_heads * hd, c.num_kv_heads * hd
            for n, shape in (("wq", (d, h)), ("wk", (d, kv)), ("wv", (d, kv)),
                             ("wo", (h, d))):
                add(group, prefix + n, normal(lead, shape, 1 / math.sqrt(shape[0])))
            if qk_norm:
                add(group, prefix + "q_norm", ones(*lead, hd))
                add(group, prefix + "k_norm", ones(*lead, hd))

        def mlp(group, prefix, lead, gated):
            shapes = ((("w_gate", (d, f)),) if gated else ()) + (("w_up", (d, f)),
                                                                 ("w_down", (f, d)))
            for n, shape in shapes:
                add(group, prefix + n, normal(lead, shape, 1 / math.sqrt(shape[0])))

        self.embed = nn.Parameter(normal((), (padded_vocab(c.vocab_size), d), 0.02))
        norm(None, "final_norm", (), bias=fam == "audio")
        gated = c.activation == "silu"
        if fam in ("dense", "vlm", "moe"):
            norm("blocks", "ln1", (nl,))
            norm("blocks", "ln2", (nl,))
            attn("blocks", "", (nl,), c.qk_norm)
            if fam == "moe":
                moe = init_moe(nl, d, f, c.num_experts, c.pdtype, generator=gen, device=dev)
                add("blocks", "w_router", moe.pop("w_router"))  # float32
                for n, t in moe.items():
                    add("blocks", f"expert_{n[2:]}", t)
            else:
                mlp("blocks", "", (nl,), gated)
        elif fam == "hybrid":
            norm("blocks", "ln", (nl,))
            for n, t in ssm.init_mamba2(nl, d, c.ssm_state, c.pdtype, expand=c.mamba_expand,
                                        head_dim=c.mamba_head_dim, generator=gen,
                                        device=dev).items():
                add("blocks", f"mamba_{n}", t)  # a_log, dt_bias, d_skip float32
            norm("shared", "shared_ln1", ())
            attn("shared", "shared_", (), c.qk_norm)
            norm("shared", "shared_ln2", ())
            mlp("shared", "shared_", (), gated)
        elif fam == "ssm":
            self.cells = nn.ModuleList()
            for i in range(nl):
                cell = (xlstm.init_slstm(d, c.num_heads, c.pdtype, generator=gen, device=dev)
                        if self._is_slstm(i) else
                        xlstm.init_mlstm(d, c.num_heads, c.pdtype, c.proj_factor,
                                         generator=gen, device=dev))
                self.cells.append(nn.ParameterDict(
                    {"ln": nn.Parameter(ones(d)),
                     **{n: nn.Parameter(t) for n, t in cell.items()}}))
        else:  # audio: the encoder and the decoder, LayerNorm and GELU throughout
            ne = (c.num_encoder_layers,)
            norm("encoder", "enc_ln1", ne, bias=True)
            attn("encoder", "enc_", ne)
            norm("encoder", "enc_ln2", ne, bias=True)
            mlp("encoder", "enc_", ne, gated=False)
            for ln in ("ln1", "ln_x", "ln2"):
                norm("blocks", ln, (nl,), bias=True)
            attn("blocks", "self_", (nl,))
            attn("blocks", "cross_", (nl,))
            mlp("blocks", "", (nl,), gated=False)
            norm(None, "enc_norm", (), bias=True)

    # ------------------------------------------------------------ params
    @torch.no_grad()
    def params_from_jax(self, tree) -> "Model":
        """Copy the reference's ``Model.init_params`` pytree (numpy leaves) in.

        Every parameter takes the leaf at its reference path, and every
        leaf is taken: a leaf missing, one left over or a shape that
        differs raises ``ValueError`` naming the path.
        """
        leaves = _flatten(tree)
        for name, dst in self.named_parameters():
            path = jax_path(name)
            if path not in leaves:
                raise ValueError(f"{path}: missing from the reference tree "
                                 f"(port parameter {name})")
            src = torch.from_numpy(np.array(leaves.pop(path), np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)
        if leaves:
            raise ValueError(f"reference leaves left over: {sorted(leaves)}")
        return self

    def _layer(self, i: int) -> dict:
        """Decoder layer ``i``'s stacked parameters by name (views)."""
        return {n: getattr(self, n)[i] for n in self._groups["blocks"]}

    def _per_layer(self, group: str) -> list[dict]:
        """Each layer's parameters of a stacked group, unbound once per call
        (so a backward stacks each one's layer gradients in a single op)."""
        names = self._groups[group]
        return [dict(zip(names, views))
                for views in zip(*(getattr(self, n).unbind(0) for n in names))]

    def _shared(self) -> dict:
        """The hybrid's shared block, by its dense names."""
        return {n[len("shared_"):]: getattr(self, n) for n in self._groups["shared"]}

    def _is_slstm(self, i: int) -> bool:
        c = self.config
        return bool(c.slstm_every) and (i + 1) % c.slstm_every == 0

    def n_shared_attn_calls(self) -> int:
        """The hybrid's shared-block calls per forward (its KV slots)."""
        c = self.config
        return -(-c.num_layers // max(c.attn_every, 1))

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Padded vocab slots never win argmax."""
        v = self.config.vocab_size
        if logits.shape[-1] == v:
            return logits
        ids = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(ids < v, logits, torch.full_like(logits, NEG_INF))

    @staticmethod
    def _ln(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return L.layernorm(p[name], p[f"{name}_bias"], x)

    @staticmethod
    def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
        return L.mlp(p.get("w_gate"), p["w_up"], p["w_down"], x)

    def _ffn(self, p: dict, h: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """The FFN sublayer of layer params ``p`` on h: the MLP, or routed
        experts (in ``groups`` routing pools of the batch's rows)."""
        c = self.config
        x = L.rmsnorm(p["ln2"], h)
        if c.family == "moe":
            return moe_ffn({"w_router": p["w_router"], "w_gate": p["expert_gate"],
                            "w_up": p["expert_up"], "w_down": p["expert_down"]}, x,
                           num_experts=c.num_experts, top_k=c.top_k,
                           capacity_factor=c.capacity_factor, groups=groups)
        return self._mlp(p, x)

    def _mamba(self, p: dict, x: torch.Tensor, state: dict | None = None):
        """The mamba2 sublayer of hybrid layer params ``p`` (pre-norm, no residual)."""
        c = self.config
        return ssm.mamba2(_sub(p, "mamba_"), L.rmsnorm(p["ln"], x), d_state=c.ssm_state,
                          expand=c.mamba_expand, head_dim=c.mamba_head_dim,
                          chunk=c.mamba_chunk, state=state)

    def _cell(self, i: int, x: torch.Tensor, state: dict | None = None):
        """xLSTM layer ``i``'s cell on the pre-normed x (no residual)."""
        c = self.config
        cell = self.cells[i]
        h = L.rmsnorm(cell["ln"], x)
        if self._is_slstm(i):
            return xlstm.slstm(cell, h, num_heads=c.num_heads, state=state)
        return xlstm.mlstm(cell, h, num_heads=c.num_heads, proj_factor=c.proj_factor,
                           state=state)

    def _attn_kw(self) -> dict:
        c = self.config
        return dict(num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
                    head_dim=c.resolved_head_dim, rope_theta=c.rope_theta)

    def _final_norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.family == "audio":
            return L.layernorm(self.final_norm, self.final_norm_bias, x)
        return L.rmsnorm(self.final_norm, x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """(S, 1, D) final hidden -> (S, V_padded) masked logits."""
        x = self._final_norm(x)
        return self._mask_pad_logits(L.unembed(self.embed, x, self.config.ldtype)[:, 0])

    def _extra(self, extras: dict | None, key: str) -> torch.Tensor:
        if not extras or key not in extras:
            raise ValueError(f"the {self.config.family} family needs extras[{key!r}]")
        return extras[key]

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts FFNs)."""
        total = self.param_count()
        c = self.config
        if c.family != "moe" or not c.num_experts:
            return total
        expert_p = 3 * c.d_model * c.d_ff * c.num_experts * c.num_layers
        return int(total - expert_p + expert_p * c.top_k / c.num_experts)

    # ----------------------------------------------------------- training
    def _remat(self, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint`` when the config
        asks for remat and a backward may follow."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _full_attention(self, p: dict, x: torch.Tensor, positions: torch.Tensor,
                        host_positions: np.ndarray, **kw):
        """Causal attention over a whole sequence (windowed, block-skipped
        as the config says); ``kw`` goes to ``attention``."""
        c = self.config
        return attention(p, L.rmsnorm(p["ln1"], x), positions, **self._attn_kw(),
                         window=c.sliding_window, q_block=c.attn_q_block,
                         kv_block=c.attn_kv_block, causal_skip=c.causal_block_skip,
                         host_positions=host_positions, **kw)

    def _block(self, p: dict, x: torch.Tensor, positions: torch.Tensor,
               host_positions: np.ndarray, groups: int = 1) -> torch.Tensor:
        h = x + self._full_attention(p, x, positions, host_positions)
        return h + self._ffn(p, h, groups)

    def _hybrid_layer(self, p: dict, shared: dict | None, x: torch.Tensor,
                      positions: torch.Tensor, host_positions: np.ndarray) -> torch.Tensor:
        if shared is not None:
            x = self._block(shared, x, positions, host_positions)
        return x + self._mamba(p, x)

    def _enc_block(self, p: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        c = self.config
        h = x + attention(p, self._ln(p, "ln1", x), positions, **self._attn_kw(),
                          causal=False, use_rope=False, q_block=c.attn_q_block,
                          kv_block=c.attn_kv_block)
        return h + self._mlp(p, self._ln(p, "ln2", h))

    def _dec_block(self, p: dict, x: torch.Tensor, positions: torch.Tensor,
                   enc_out: torch.Tensor, enc_pos: torch.Tensor) -> torch.Tensor:
        c = self.config
        kw = dict(self._attn_kw(), use_rope=False, q_block=c.attn_q_block,
                  kv_block=c.attn_kv_block)
        h = x + attention(_sub(p, "self_"), self._ln(p, "ln1", x), positions, **kw)
        h = h + attention(_sub(p, "cross_"), self._ln(p, "ln_x", h), positions,
                          causal=False, xkv=enc_out, kv_positions=enc_pos, **kw)
        return h + self._mlp(p, self._ln(p, "ln2", h))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Audio: the encoder over (B, enc_S, D) frame embeddings (the
        reference's stub frontend), once per request batch."""
        c = self.config
        s = frames.shape[1]
        pe = torch.from_numpy(_sinusoidal(s, c.d_model)).to(frames.device, c.cdtype)
        x = frames.to(c.cdtype) + pe
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        for p in self._per_layer("encoder"):
            x = self._remat(self._enc_block, _sub(p, "enc_"), x, positions)
        return L.layernorm(self.enc_norm, self.enc_norm_bias, x)

    def hidden(self, tokens: torch.Tensor, extras: dict | None = None,
               groups: int = 1) -> torch.Tensor:
        """(B, S) tokens -> (B, S, D) final-normed hidden states, compute dtype.

        ``extras``: vlm ``{"image_embeds": (B, T_img, D)}`` (prepended,
        causal over image and text, its rows dropped after); audio
        ``{"frames": (B, enc_S, D)}`` (run through ``encode``). ``groups``:
        an MoE layer routes each of ``groups`` blocks of B / groups rows
        as its own pool (every other layer is row-wise already).
        """
        c = self.config
        x = L.embed(self.embed, tokens, c.cdtype)
        if c.family == "audio":
            enc_out = self.encode(self._extra(extras, "frames"))
            s = tokens.shape[1]
            positions = torch.arange(s, dtype=torch.int32, device=x.device)
            enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=x.device)
            for p in self._per_layer("blocks"):
                x = self._remat(self._dec_block, p, x, positions, enc_out, enc_pos)
            return self._final_norm(x)
        t_img = 0
        if c.family == "vlm":
            img = self._extra(extras, "image_embeds").to(c.cdtype)
            t_img = img.shape[1]
            x = torch.cat([img, x], dim=1)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        host = np.arange(s)
        if c.family == "ssm":
            for i in range(c.num_layers):
                x = x + self._remat(self._cell, i, x)
        elif c.family == "hybrid":
            shared, every = self._shared(), max(c.attn_every, 1)
            for i, p in enumerate(self._per_layer("blocks")):
                x = self._remat(self._hybrid_layer, p, shared if i % every == 0 else None,
                                x, positions, host)
        else:
            for p in self._per_layer("blocks"):
                x = self._remat(self._block, p, x, positions, host, groups)
        return self._final_norm(x[:, t_img:])

    def lm_logits(self, tokens: torch.Tensor, extras: dict | None = None) -> torch.Tensor:
        """(B, S, V_padded) masked logits, materialized (the oracle path)."""
        x = self.hidden(tokens, extras)
        return self._mask_pad_logits(L.unembed(self.embed, x, self.config.ldtype))

    def token_ce(self, tokens: torch.Tensor, labels: torch.Tensor,
                 extras: dict | None = None, groups: int = 1):
        """Per-token (lse, ll, argmax) of the tied head, flattened to (B*S,).

        Through ``fused_ce`` (B4 on the card): the first ``vocab_size``
        rows of the table, rounded to the compute dtype as ``unembed``
        rounds them; the padded rows would contribute exactly nothing.
        ``groups``: the MoE routing pools (``hidden``).
        """
        x = self.hidden(tokens, extras, groups)
        h = x.reshape(-1, x.shape[-1])
        table = self.embed[: self.config.vocab_size].to(h.dtype)
        return fused_ce(h.contiguous(), table.contiguous(), labels.reshape(-1))

    def loss_fn(self, batch: dict):
        """(loss, {"loss", "accuracy"}) of {"tokens", "labels"} (B, S)
        batches (and the family's ``extras``).

        Labels < 0 are masked; the loss carries the 1e-4 lse^2 z-loss.
        """
        labels = batch["labels"].reshape(-1)
        lse, ll, am = self.token_ce(batch["tokens"], labels, batch.get("extras"))
        mask = labels >= 0
        loss = L.ce_from_lse(lse, ll, mask)
        acc = ((am == labels) & mask).sum() / mask.sum().clamp_min(1)
        return loss, {"loss": loss, "accuracy": acc}

    # ------------------------------------------------------- dense cache
    def _check_slot_support(self) -> None:
        """The slot and paged paths allocate full-context, full-precision
        attention caches: refuse every family but dense, vlm and moe, then
        ``kv_quant`` and sliding windows, with the reference's messages."""
        c = self.config
        if c.family not in ("dense", "vlm", "moe"):
            raise NotImplementedError(
                f"slot-resident decode supports the attention-cache "
                f"families (dense/vlm/moe), not {c.family!r}"
            )
        if c.kv_quant:
            raise NotImplementedError(
                "slot-resident decode does not support int8 KV caches yet"
            )
        if c.sliding_window is not None:
            raise NotImplementedError(
                "slot-resident decode allocates full-context caches; "
                "sliding-window models are not supported yet"
            )

    def _dense_kv(self, layers: int, batch: int, cache_len: int,
                  dtype: torch.dtype | None = None) -> dict:
        c = self.config
        shape = (layers, batch, cache_len, c.num_kv_heads, c.resolved_head_dim)
        dtype = c.cdtype if dtype is None else dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def _kv_cache(self, layers: int, batch: int, cache_len: int) -> dict:
        """``layers`` dense KV caches with a (layers, S) position map; int8
        with (layers, B, S, KV) float16 ``k_scale`` / ``v_scale`` for
        ``kv_quant``."""
        c = self.config
        pos = torch.full((layers, cache_len), -1, dtype=torch.int32, device=self.device)
        if not c.kv_quant:
            return {**self._dense_kv(layers, batch, cache_len), "pos": pos}
        scale = (layers, batch, cache_len, c.num_kv_heads)
        return {**self._dense_kv(layers, batch, cache_len, torch.int8),
                "k_scale": torch.zeros(scale, dtype=torch.float16, device=self.device),
                "v_scale": torch.zeros(scale, dtype=torch.float16, device=self.device),
                "pos": pos}

    def init_cache(self, batch: int, cache_len: int, extras: dict | None = None) -> dict:
        """Decode state of ``decode_step``: K/V and a (L, S) position map.

        A sliding-window model gets the rolling cache of ``min(cache_len,
        window)`` entries; ``kv_quant`` stores int8 K/V with (L, B, S, KV)
        float16 ``k_scale`` / ``v_scale``. hybrid: KV for each shared call,
        the ``ssm`` (float32) and ``conv`` (compute dtype) states per layer;
        ssm: ``{"xlstm": [each layer's state]}``; audio: the layers' KV and
        ``extras["enc_out"]`` (``encode``'s output for the batch).
        """
        c = self.config
        if c.sliding_window is not None:
            cache_len = min(cache_len, c.sliding_window)
        if c.family == "hybrid":
            d_inner, n_heads, conv_dim = ssm.dims(c.d_model, c.ssm_state, c.mamba_expand,
                                                  c.mamba_head_dim)
            return {**self._kv_cache(self.n_shared_attn_calls(), batch, cache_len),
                    "ssm": torch.zeros((c.num_layers, batch, n_heads, c.ssm_state,
                                        c.mamba_head_dim), dtype=torch.float32,
                                       device=self.device),
                    "conv": torch.zeros((c.num_layers, batch, ssm.CONV_K - 1, conv_dim),
                                        dtype=c.cdtype, device=self.device)}
        if c.family == "ssm":
            return {"xlstm": [
                xlstm.init_slstm_state(batch, c.d_model, c.num_heads, device=self.device)
                if self._is_slstm(i) else
                xlstm.init_mlstm_state(batch, c.d_model, c.num_heads, c.proj_factor,
                                       device=self.device)
                for i in range(c.num_layers)]}
        cache = self._kv_cache(c.num_layers, batch, cache_len)
        if c.family == "audio":
            if not extras or "enc_out" not in extras:
                raise ValueError("whisper decode cache needs the encoder output "
                                 "(run model.encode(frames) once per request batch)")
            cache["enc_out"] = extras["enc_out"]
        return cache

    def init_slot_cache(self, batch: int, cache_len: int) -> dict:
        """Decode state of ``decode_step_slots``: K/V and a (B, S) position
        map, shared by every layer (each layer writes the same positions)."""
        self._check_slot_support()
        return {**self._dense_kv(self.config.num_layers, batch, cache_len),
                "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                                  device=self.device)}

    @staticmethod
    def _kv(cache: dict, i: int) -> dict:
        """Views of KV cache slot ``i`` (a layer, or a hybrid's shared call)."""
        return {n: cache[n][i] for n in _KV if n in cache}

    def _decode_block(self, p: dict, x, kv: dict, pos: int, window=None):
        h = x + decode_attention(p, L.rmsnorm(p["ln1"], x), kv, pos, window=window,
                                 **self._attn_kw())
        return h + self._ffn(p, h)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos: int):
        """One new token for every row at one position (``init_cache``).

        tokens: (B,) int; pos: int. Returns (logits (B, V_padded), cache),
        the cache updated in place.
        """
        c = self.config
        x = L.embed(self.embed, tokens[:, None], c.cdtype)
        if c.family == "ssm":
            states = cache["xlstm"]
            for i in range(c.num_layers):
                y, states[i] = self._cell(i, x, states[i])
                x = x + y
        elif c.family == "hybrid":
            shared, every = self._shared(), max(c.attn_every, 1)
            for i in range(c.num_layers):
                if i % every == 0:  # the shared block, its own KV slot
                    x = self._decode_block(shared, x, self._kv(cache, i // every), pos)
                y, state = self._mamba(self._layer(i), x,
                                       {"ssm": cache["ssm"][i], "conv": cache["conv"][i]})
                cache["ssm"][i] = state["ssm"]
                cache["conv"][i] = state["conv"]
                x = x + y
        elif c.family == "audio":
            # the cross-attention K/V of enc_out are recomputed every step
            enc_out = cache["enc_out"]
            enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=x.device)
            q_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
            kw = self._attn_kw()
            for i in range(c.num_layers):
                p = self._layer(i)
                h = x + decode_attention(_sub(p, "self_"), self._ln(p, "ln1", x),
                                         self._kv(cache, i), pos, use_rope=False, **kw)
                h = h + attention(_sub(p, "cross_"), self._ln(p, "ln_x", h), q_pos, **kw,
                                  causal=False, use_rope=False, xkv=enc_out,
                                  kv_positions=enc_pos, q_block=1,
                                  kv_block=min(c.attn_kv_block, enc_out.shape[1]))
                x = h + self._mlp(p, self._ln(p, "ln2", h))
        else:
            for i in range(c.num_layers):
                x = self._decode_block(self._layer(i), x, self._kv(cache, i), pos,
                                       window=c.sliding_window)
        return self._logits(x), cache

    @torch.no_grad()
    def prefill(self, tokens, length):
        """Batched prefill: one forward -> (last logits, per-layer K/V).

        tokens: (B, S0) int, right-padded; length: (B,) prompt lengths.
        Returns the logits at each row's last real position (B, V_padded)
        and the post-rope K/V, (L, B, S0, KV, hd) each. Padded positions
        produce K/V that sit causally after every real query; the splice
        masks them with position -1.
        """
        self._check_slot_support()
        c = self.config
        b, s = tokens.shape
        x = L.embed(self.embed, tokens, c.cdtype)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        host = np.arange(s)
        ks, vs = [], []
        for i in range(c.num_layers):
            p = self._layer(i)
            y, k, v = self._full_attention(p, x, positions, host, return_kv=True)
            h = x + y
            x = h + self._ffn(p, h)
            ks.append(k)
            vs.append(v)
        last = torch.clamp(torch.as_tensor(length, device=x.device).long() - 1, 0, s - 1)
        x_last = x[torch.arange(b, device=x.device), last][:, None]
        return self._logits(x_last), torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_step_slots(self, cache: dict, tokens, pos):
        """One token per row, each at its own position (``init_slot_cache``).

        tokens: (B,) int; pos: (B,) int32 write positions (a frozen row
        rewrites its entry, which is idempotent). Returns (logits, cache).
        """
        self._check_slot_support()
        c = self.config
        x = L.embed(self.embed, tokens[:, None], c.cdtype)
        b, cache_len = cache["pos"].shape
        pos = pos.to(torch.int32)
        slot = (pos % cache_len).long()
        cache["pos"][torch.arange(b, device=x.device), slot] = pos
        for i in range(c.num_layers):
            p = self._layer(i)
            layer = {"k": cache["k"][i], "v": cache["v"][i]}
            h = x + decode_attention_slots(p, L.rmsnorm(p["ln1"], x), layer,
                                           cache["pos"], pos, slot, **self._attn_kw())
            x = h + self._ffn(p, h)
        return self._logits(x), cache

    # ------------------------------------------------------- paged cache
    def init_paged_cache(self, num_blocks: int, block_len: int) -> dict:
        """KV block pool: ``num_blocks + 1`` blocks per layer (last = sink)."""
        self._check_slot_support()
        c = self.config
        shape = (c.num_layers, num_blocks + 1, block_len, c.num_kv_heads,
                 c.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=c.cdtype, device=self.device),
                "v": torch.zeros(shape, dtype=c.cdtype, device=self.device)}

    # ------------------------------------------------------ paged passes
    @torch.no_grad()
    def decode_step_paged(self, cache: dict, tokens, pos, table, active):
        """One token per slot against the shared block pool.

        tokens: (S,) int; pos: (S,) int32 write positions; table: (S, MB)
        int32; active: (S,) bool (inactive rows write the sink). Returns
        (logits (S, V_padded), cache).
        """
        self._check_slot_support()
        c = self.config
        x = L.embed(self.embed, tokens[:, None], c.cdtype)
        for i in range(c.num_layers):
            p = self._layer(i)
            h = x + decode_attention_paged(
                p, L.rmsnorm(p["ln1"], x), cache["k"][i], cache["v"][i], table, pos,
                active, **self._attn_kw(),
            )
            x = h + self._ffn(p, h)
        return self._logits(x), cache

    @torch.no_grad()
    def prefill_paged(self, cache: dict, tokens, start, chunk_len, table):
        """One chunked-prefill admit round: C prompt tokens per slot.

        tokens: (S, C) int, row s holding prompt positions ``[start[s],
        start[s] + chunk_len[s])`` right-padded (``chunk_len == 0``: slot
        not prefilling). Returns the logits at each row's last real chunk
        position, (S, V_padded), and the cache. An MoE layer routes all
        S x C rows, the padded ones included, as the reference does.
        """
        self._check_slot_support()
        c = self.config
        b, cc = tokens.shape
        x = L.embed(self.embed, tokens, c.cdtype)
        for i in range(c.num_layers):
            p = self._layer(i)
            h = x + prefill_attention_paged(
                p, L.rmsnorm(p["ln1"], x), cache["k"][i], cache["v"][i], table, start,
                chunk_len, **self._attn_kw(),
            )
            x = h + self._ffn(p, h)
        last = torch.clamp(chunk_len.long() - 1, 0, cc - 1)
        x_last = x[torch.arange(b, device=x.device), last][:, None]
        return self._logits(x_last), cache
