"""Deterministic synthetic LM data (counterpart of ``repro/data/pipeline.py``).

Tokens are the reference's counter-mode hash of (step, batch row,
position), computed with the same numpy arithmetic, so a batch here is
identical to the reference's for the same (config, shape, seed, step).
A Markov-ish structure gives the loss a learnable signal. The pipeline
is seekable: ``state()`` returns {"step", "seed"} and ``start_step``
resumes exactly. Batches land on ``device`` (CUDA by default) as int32,
with the family's ``extras`` (``make_extras``) where it has them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


def _hash2d(step: int, b: int, s: int, seed: int) -> np.ndarray:
    """uint32 counter hash (splitmix-style), vectorized over (b, s)."""
    bi = np.arange(b, dtype=np.uint64)[:, None]
    si = np.arange(s, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):  # uint64 wraparound is the hash
        x = (np.uint64(step) * np.uint64(0x9E3779B97F4A7C15)
             + bi * np.uint64(0xBF58476D1CE4E5B9)
             + si * np.uint64(0x94D049BB133111EB)
             + np.uint64(seed))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


class SyntheticLMData:
    """Iterator of {"tokens": (B, S) int32, "labels": (B, S) int32} batches."""

    def __init__(self, config: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 start_step: int = 0, learnable: bool = True, *,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.shape = shape
        self.seed = seed
        self.learnable = learnable
        self.device = resolve_device(device)
        self._step = start_step

    def state(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def _raw(self, step: int) -> np.ndarray:
        b, s = self.shape.global_batch, self.shape.seq_len
        h = _hash2d(step, b, s + 1, self.seed)
        v = self.config.vocab_size
        if not self.learnable:
            return (h % np.uint32(v)).astype(np.int32)
        base = (h % np.uint32(17)).astype(np.int64)
        return (np.cumsum(base, axis=1) % v).astype(np.int32)

    def next_batch(self) -> dict:
        seq = torch.from_numpy(self._raw(self._step)).to(self.device)  # (B, S+1)
        self._step += 1
        batch = {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous()}
        extras = make_extras(self.config, self.shape.global_batch, device=self.device)
        if extras:
            batch["extras"] = extras
        return batch


def make_extras(config: ModelConfig, batch: int, *, device: str | torch.device = "cuda"
                ) -> dict | None:
    """The reference's modality-frontend stubs: zero image embeddings (B,
    num_image_tokens, D) for vlm, zero frame embeddings (B, encoder_seq, D)
    for audio, in the compute dtype; None for the other families."""
    key, length = {"vlm": ("image_embeds", config.num_image_tokens),
                   "audio": ("frames", config.encoder_seq)}.get(config.family, (None, 0))
    if key is None:
        return None
    return {key: torch.zeros((batch, length, config.d_model), dtype=config.cdtype,
                             device=resolve_device(device))}


def make_batch_specs(config: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for one training batch (the dry-run's input):
    tokens and labels (B, S) int32, and the vlm / audio extras (B,
    num_image_tokens or encoder_seq, D) in the compute dtype. No memory,
    no values."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
             "labels": torch.empty((b, s), dtype=torch.int32, device="meta")}
    extras = make_extras(config, b, device="meta")
    if extras:
        batch["extras"] = extras
    return batch
