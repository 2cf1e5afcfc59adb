"""Seeded weights of a llama-style dense model, made on the device.

The benchmark makes the weights; the program and the reference each get
them from here. ``fill`` writes them into tensors the caller holds (the
served model's parameters); ``make`` allocates and fills a fresh set for
the reference. Each leaf is one ``normal_`` call of its own
``torch.Generator`` (seeded from the run's seed and the leaf), in the
dtype it is served in, so the same seed gives the same values on both
sides, bit for bit. Matrices are N(0, 1 / fan_in), the embedding
N(0, 0.02^2), norm scales N(1, 0.1^2). Imports nothing of the program.
"""
from __future__ import annotations

import torch

from perfbench.gen import sub_seed

#: the stacked per-layer leaves, in the order their seeds are derived
LAYER_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def padded_rows(vocab: int, multiple: int = 256) -> int:
    """Rows of the embedding table as the served model lays it out."""
    return -(-vocab // multiple) * multiple


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Each leaf's shape for a config file's sizes."""
    n, d, f = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    hd = cfg.get("head_dim", d // cfg["num_attention_heads"])
    h, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    return {
        "embed": (padded_rows(cfg["vocab_size"]), d),
        "final_norm": (d,),
        "ln1": (n, d), "ln2": (n, d),
        "wq": (n, d, h), "wk": (n, d, kv), "wv": (n, d, kv), "wo": (n, h, d),
        "w_gate": (n, d, f), "w_up": (n, d, f), "w_down": (n, f, d),
    }


@torch.no_grad()
def fill_leaf(name: str, t: torch.Tensor, seed: int) -> None:
    """Leaf ``name``'s values for ``seed``, written into ``t`` in place."""
    order = ("embed", "final_norm") + LAYER_LEAVES
    g = torch.Generator(device=t.device).manual_seed(sub_seed(seed, order.index(name)))
    if name == "embed":
        t.normal_(0.0, 0.02, generator=g)
    elif name in ("final_norm", "ln1", "ln2"):
        t.normal_(1.0, 0.1, generator=g)
    else:
        t.normal_(0.0, t.shape[-2] ** -0.5, generator=g)


def fill(tensors: dict[str, torch.Tensor], cfg: dict, seed: int) -> None:
    """Every leaf into ``tensors`` (name -> tensor of the leaf's shape)."""
    for name, shape in shapes(cfg).items():
        t = tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the config gives {shape}")
        fill_leaf(name, t, seed)


def make(cfg: dict, seed: int, device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A fresh set of every leaf in ``dtype`` on ``device``."""
    out = {name: torch.empty(shape, dtype=dtype, device=device)
           for name, shape in shapes(cfg).items()}
    fill(out, cfg, seed)
    return out
