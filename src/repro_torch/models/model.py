"""Decoder model on a paged KV pool (counterpart of ``repro/models/model.py``).

``Model`` is an ``nn.Module`` for the attention-cache families the port
implements: ``dense`` (llama-style pre-norm GQA + SwiGLU, tied
embedding) and ``moe`` (the same attention; the FFN is top-k routed
experts, ``models/moe.py``). Every other family is refused by name. Its
parameters are the reference's pytree with layers stacked on axis 0
(``scan_layers``): ``embed`` (Vp, D), ``final_norm`` (D,), and per layer
``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, ``q_norm``, ``k_norm``,
then ``w_gate``, ``w_up``, ``w_down`` (dense) or ``w_router``,
``expert_gate``, ``expert_up``, ``expert_down`` (moe: the reference's
``blocks/moe/*``). A Python loop over layers takes the place of
``lax.scan``; ``_ffn`` is the one FFN dispatch every path takes.
``params_from_jax`` carries the reference's ``Model.init_params`` tree
across; otherwise the module draws its own seeded init on its device at
any width.

The paged KV cache is ``{"k", "v"}`` of shape (L, NB+1, BL, KV, hd);
both paged entry points update it in place and return it (under
``torch.no_grad``). The dense caches are ``{"k", "v"}`` of shape
(L, B, S, KV, hd) plus ``pos``: (L, S) for ``decode_step`` (one position
for the whole batch, ``init_cache``: a rolling cache of ``min(S,
window)`` entries for a sliding-window model, int8 with per-(token,
head) float16 ``k_scale`` / ``v_scale`` for ``kv_quant``), (B, S) for
``decode_step_slots`` (a position per row, ``init_slot_cache``);
``prefill`` is one batched forward that returns every layer's post-rope
prompt K/V for a splice. They too are updated in place. The slot and
paged paths refuse ``kv_quant`` and sliding windows, as the reference's.
The parameters are trainable: ``hidden`` runs the training forward
(causal chunked attention, windowed and block-skipped as the config
says, each layer under ``torch.utils.checkpoint`` when ``config.remat``,
as the reference's ``jax.checkpoint``), and ``loss_fn`` takes the cross
entropy through the B4 fused kernel on the card, so no (T, V) logits are
materialized. ``lm_logits`` is the materialized oracle.
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

#: reference pytree path -> port parameter name
_JAX_PATHS = {
    ("embed", "table"): "embed",
    ("final_norm", "scale"): "final_norm",
    ("blocks", "ln1", "scale"): "ln1",
    ("blocks", "ln2", "scale"): "ln2",
    ("blocks", "attn", "wq"): "wq",
    ("blocks", "attn", "wk"): "wk",
    ("blocks", "attn", "wv"): "wv",
    ("blocks", "attn", "wo"): "wo",
    ("blocks", "attn", "q_norm"): "q_norm",
    ("blocks", "attn", "k_norm"): "k_norm",
    ("blocks", "mlp", "w_gate"): "w_gate",
    ("blocks", "mlp", "w_up"): "w_up",
    ("blocks", "mlp", "w_down"): "w_down",
    ("blocks", "moe", "w_router"): "w_router",
    ("blocks", "moe", "w_gate"): "expert_gate",
    ("blocks", "moe", "w_up"): "expert_up",
    ("blocks", "moe", "w_down"): "expert_down",
}
#: port parameter name -> reference tree path ("blocks/attn/wq", ...)
JAX_NAMES = {name: "/".join(path) for path, name in _JAX_PATHS.items()}
_BLOCK_PARAMS = ("wq", "wk", "wv", "wo", "q_norm", "k_norm", "ln1", "ln2", "w_gate",
                 "w_up", "w_down", "w_router", "expert_gate", "expert_up", "expert_down")
#: the families ``Model`` implements
FAMILIES = ("dense", "moe")


def padded_vocab(v: int, multiple: int = 256) -> int:
    """Vocab padded to a multiple of 256 rows."""
    return int(-(-v // multiple) * multiple)


class Model(nn.Module):
    """Dense or MoE decoder with paged decode and chunked paged prefill."""

    def __init__(self, config: ModelConfig, *, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        if config.family not in FAMILIES:
            raise NotImplementedError(
                f"the {config.family!r} family ({config.name}) is not ported yet; "
                f"the port implements {'/'.join(FAMILIES)}"
            )
        self.config = c = config
        self.device = dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        nl, d, f, hd = c.num_layers, c.d_model, c.d_ff, c.resolved_head_dim
        h, kv = c.num_heads * hd, c.num_kv_heads * hd

        def param(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(c.pdtype))

        def normal(shape, scale):  # scaled in place: one full-size tensor at a time
            return param(torch.randn(shape, generator=gen, device=dev).mul_(scale))

        def ones(*shape):
            return param(torch.ones(shape, device=dev))

        self.embed = normal((padded_vocab(c.vocab_size), d), 0.02)
        self.final_norm = ones(d)
        self.ln1, self.ln2 = ones(nl, d), ones(nl, d)
        self.wq = normal((nl, d, h), 1 / math.sqrt(d))
        self.wk = normal((nl, d, kv), 1 / math.sqrt(d))
        self.wv = normal((nl, d, kv), 1 / math.sqrt(d))
        self.wo = normal((nl, h, d), 1 / math.sqrt(h))
        if c.qk_norm:
            self.q_norm, self.k_norm = ones(nl, hd), ones(nl, hd)
        if c.family == "moe":
            moe = init_moe(nl, d, f, c.num_experts, c.pdtype, generator=gen, device=dev)
            self.w_router = nn.Parameter(moe["w_router"])  # float32, as the reference
            self.expert_gate = nn.Parameter(moe["w_gate"])
            self.expert_up = nn.Parameter(moe["w_up"])
            self.expert_down = nn.Parameter(moe["w_down"])
        else:
            self.w_gate = normal((nl, d, f), 1 / math.sqrt(d))
            self.w_up = normal((nl, d, f), 1 / math.sqrt(d))
            self.w_down = normal((nl, f, d), 1 / math.sqrt(f))

    # ------------------------------------------------------------ params
    @torch.no_grad()
    def params_from_jax(self, tree) -> "Model":
        """Copy the reference's ``Model.init_params`` pytree (numpy leaves) in."""
        for path, name in _JAX_PATHS.items():
            if not hasattr(self, name):  # q_norm/k_norm without qk_norm; the other FFN
                continue
            node = tree
            for key in path:
                node = node[key]
            dst = getattr(self, name)
            src = torch.from_numpy(np.array(node, np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{'.'.join(path)}: shape {tuple(src.shape)} != {tuple(dst.shape)}"
                )
            dst.copy_(src)
        return self

    def _layer(self, i: int) -> dict:
        """Layer ``i``'s parameters by name (views)."""
        return {n: getattr(self, n)[i] for n in _BLOCK_PARAMS if hasattr(self, n)}

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Padded vocab slots never win argmax."""
        v = self.config.vocab_size
        if logits.shape[-1] == v:
            return logits
        ids = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(ids < v, logits, torch.full_like(logits, NEG_INF))

    def _ffn(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        """The FFN sublayer of layer params ``p`` on h: SwiGLU, or routed experts."""
        c = self.config
        x = L.rmsnorm(p["ln2"], h)
        if c.family == "moe":
            return moe_ffn({"w_router": p["w_router"], "w_gate": p["expert_gate"],
                            "w_up": p["expert_up"], "w_down": p["expert_down"]}, x,
                           num_experts=c.num_experts, top_k=c.top_k,
                           capacity_factor=c.capacity_factor)
        return L.mlp(p["w_gate"], p["w_up"], p["w_down"], x)

    def _attn_kw(self) -> dict:
        c = self.config
        return dict(num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
                    head_dim=c.resolved_head_dim, rope_theta=c.rope_theta)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """(S, 1, D) final hidden -> (S, V_padded) masked logits."""
        x = L.rmsnorm(self.final_norm, x)
        return self._mask_pad_logits(L.unembed(self.embed, x, self.config.ldtype)[:, 0])

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
               host_positions: np.ndarray) -> torch.Tensor:
        h = x + self._full_attention(p, x, positions, host_positions)
        return h + self._ffn(p, h)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> (B, S, D) final-normed hidden states, compute dtype.

        The stacked parameters are unbound once per call, so the backward
        stacks each one's layer gradients in a single op.
        """
        c = self.config
        x = L.embed(self.embed, tokens, c.cdtype)
        s = tokens.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        host = np.arange(s)
        names = [n for n in _BLOCK_PARAMS if hasattr(self, n)]
        per_layer = zip(*(getattr(self, n).unbind(0) for n in names))
        remat = c.remat and torch.is_grad_enabled()
        for views in per_layer:
            p = dict(zip(names, views))
            if remat:
                x = checkpoint(self._block, p, x, positions, host, use_reentrant=False)
            else:
                x = self._block(p, x, positions, host)
        return L.rmsnorm(self.final_norm, x)

    def lm_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S, V_padded) masked logits, materialized (the oracle path)."""
        x = self.hidden(tokens)
        return self._mask_pad_logits(L.unembed(self.embed, x, self.config.ldtype))

    def token_ce(self, tokens: torch.Tensor, labels: torch.Tensor):
        """Per-token (lse, ll, argmax) of the tied head, flattened to (B*S,).

        Through ``fused_ce`` (B4 on the card): the first ``vocab_size``
        rows of the table, rounded to the compute dtype as ``unembed``
        rounds them; the padded rows would contribute exactly nothing.
        """
        x = self.hidden(tokens)
        h = x.reshape(-1, x.shape[-1])
        table = self.embed[: self.config.vocab_size].to(h.dtype)
        return fused_ce(h.contiguous(), table.contiguous(), labels.reshape(-1))

    def loss_fn(self, batch: dict):
        """(loss, {"loss", "accuracy"}) of {"tokens", "labels"} (B, S) batches.

        Labels < 0 are masked; the loss carries the 1e-4 lse^2 z-loss.
        """
        labels = batch["labels"].reshape(-1)
        lse, ll, am = self.token_ce(batch["tokens"], labels)
        mask = labels >= 0
        loss = L.ce_from_lse(lse, ll, mask)
        acc = ((am == labels) & mask).sum() / mask.sum().clamp_min(1)
        return loss, {"loss": loss, "accuracy": acc}

    # ------------------------------------------------------- dense cache
    def _check_slot_support(self) -> None:
        """The slot and paged paths allocate full-context, full-precision
        caches: refuse ``kv_quant`` and sliding windows with the
        reference's messages (``__init__`` already refuses any family but
        dense and moe)."""
        c = self.config
        if c.kv_quant:
            raise NotImplementedError(
                "slot-resident decode does not support int8 KV caches yet"
            )
        if c.sliding_window is not None:
            raise NotImplementedError(
                "slot-resident decode allocates full-context caches; "
                "sliding-window models are not supported yet"
            )

    def _dense_kv(self, batch: int, cache_len: int) -> dict:
        c = self.config
        shape = (c.num_layers, batch, cache_len, c.num_kv_heads, c.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=c.cdtype, device=self.device),
                "v": torch.zeros(shape, dtype=c.cdtype, device=self.device)}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Decode state of ``decode_step``: K/V and a (L, S) position map.

        A sliding-window model gets the rolling cache of ``min(cache_len,
        window)`` entries; ``kv_quant`` stores int8 K/V with (L, B, S, KV)
        float16 ``k_scale`` / ``v_scale``.
        """
        c = self.config
        if c.sliding_window is not None:
            cache_len = min(cache_len, c.sliding_window)
        pos = torch.full((c.num_layers, cache_len), -1, dtype=torch.int32,
                         device=self.device)
        if c.kv_quant:
            shape = (c.num_layers, batch, cache_len, c.num_kv_heads, c.resolved_head_dim)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=self.device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=self.device),
                    "k_scale": torch.zeros(shape[:4], dtype=torch.float16,
                                           device=self.device),
                    "v_scale": torch.zeros(shape[:4], dtype=torch.float16,
                                           device=self.device),
                    "pos": pos}
        return {**self._dense_kv(batch, cache_len), "pos": pos}

    def init_slot_cache(self, batch: int, cache_len: int) -> dict:
        """Decode state of ``decode_step_slots``: K/V and a (B, S) position
        map, shared by every layer (each layer writes the same positions)."""
        self._check_slot_support()
        return {**self._dense_kv(batch, cache_len),
                "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                                  device=self.device)}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos: int):
        """One new token for every row at one position (``init_cache``).

        tokens: (B,) int; pos: int. Returns (logits (B, V_padded), cache).
        """
        c = self.config
        x = L.embed(self.embed, tokens[:, None], c.cdtype)
        for i in range(c.num_layers):
            p = self._layer(i)
            layer = {name: t[i] for name, t in cache.items()}
            h = x + decode_attention(p, L.rmsnorm(p["ln1"], x), layer, pos,
                                     window=c.sliding_window, **self._attn_kw())
            x = h + self._ffn(p, h)
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
