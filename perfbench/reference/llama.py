"""Plain float32 forward of a llama-style dense decoder: the reference the
served model's tokens are judged by.

Pre-norm blocks: RMSNorm, grouped-query attention with rotary position
embeddings (half-split, ``theta ** (-i / half)``), causal softmax, the
SwiGLU MLP, a final RMSNorm and the tied unembedding. Everything runs in
float32 with TF32 off, a layer at a time over every sequence, so only one
layer's float32 weights live at once. ``weight_cast`` maps each weight
matrix before use: the control passes a lower-precision round trip.
Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, heads, hd) at positions 0 .. T-1."""
    t, _, hd = x.shape
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, groups: int) -> torch.Tensor:
    """Causal attention; q (T, H, hd), k and v (T, KV, hd) -> (T, H * hd)."""
    t, h, hd = q.shape
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v).reshape(t, h * hd)


@torch.no_grad()
def logits(w: dict, cfg: dict, seqs: list[torch.Tensor], spans: list[tuple[int, int]],
           weight_cast=None) -> list[torch.Tensor]:
    """Float32 logits of each sequence at positions ``[lo, hi)`` of its span.

    ``w``: the weights by leaf (``perfbench.weights`` names, any dtype;
    stacked leaves indexed by layer); ``seqs``: 1-D int token tensors.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cast = weight_cast or (lambda m: m)
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim", d // heads)
    kvh = cfg["num_key_value_heads"]
    eps, theta, vocab = cfg["rms_norm_eps"], cfg["rope_theta"], cfg["vocab_size"]
    table = cast(w["embed"][:vocab].float())
    xs = [table[s.long()] for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        p = {n: w[n][i].float() for n in ("ln1", "ln2")}
        p.update({n: cast(w[n][i].float())
                  for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")})
        for j, x in enumerate(xs):
            t = x.shape[0]
            h = rmsnorm(x, p["ln1"], eps)
            q = rope((h @ p["wq"]).reshape(t, heads, hd), theta)
            k = rope((h @ p["wk"]).reshape(t, kvh, hd), theta)
            v = (h @ p["wv"]).reshape(t, kvh, hd)
            x = x + attention(q, k, v, heads // kvh) @ p["wo"]
            h = rmsnorm(x, p["ln2"], eps)
            xs[j] = x + (torch.nn.functional.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]
        del p
    final = w["final_norm"].float()
    return [rmsnorm(x[lo:hi], final, eps) @ table.T for x, (lo, hi) in zip(xs, spans)]


def fp8_round_trip(m: torch.Tensor) -> torch.Tensor:
    """A weight matrix through float8 e4m3 with one scale per output column
    and back to float32: the control's weights."""
    scale = m.abs().amax(0, keepdim=True).clamp_min(1e-12) / 448.0
    return (m / scale).to(torch.float8_e4m3fn).float() * scale
