"""A run with the timed path broken underneath comes out not correct:
the whole run on a reduced cell, on the CPU, with one fault planted in
the program for the run's length."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests import tinybench


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinybench.make_root(tmp_path_factory.mktemp("bench"))


def _token_altered(monkeypatch):
    """A served token altered where the decode chunk produces it."""
    from repro_torch.runtime.serve_loop import Server

    real = Server._decode_chunk

    def chunk(self, *args, **kw):
        logits, pos, toks = real(self, *args, **kw)
        if toks is not None:
            toks = toks.clone()
            toks[0] = (toks[0] + 1) % self.model.config.vocab_size
        return logits, pos, toks

    monkeypatch.setattr(Server, "_decode_chunk", chunk)


def _half_the_batch_left_out(monkeypatch):
    """A decode step that computes only the first half of the slots."""
    from repro_torch.models.model import Model

    real = Model.decode_step_paged

    def step(self, cache, tokens, pos, table, active):
        logits, cache = real(self, cache, tokens, pos, table, active)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], torch.zeros_like(logits[half:])]), cache

    monkeypatch.setattr(Model, "decode_step_paged", step)


def _kv_state_unchanged(monkeypatch):
    """A decode step that leaves the KV pool as it was (no token written)."""
    from repro_torch.kernels.paged_attention import ops

    monkeypatch.setattr(ops, "scatter_decode", lambda k, v, *a: (k, v))


def _answer_altered(monkeypatch):
    """A Path M answer altered where the decode produces it."""
    from repro_torch.core import coded_matvec

    real = coded_matvec.DecodePipeline.__call__

    def call(self, packed, x, mask):
        z, ok = real(self, packed, x, mask)
        return z + torch.where(torch.arange(z.shape[0]) == 3, 1.0, 0.0), ok

    monkeypatch.setattr(coded_matvec.DecodePipeline, "__call__", call)


def _products_half_lost(monkeypatch):
    """Half of the workers' products lost before the decode."""
    from repro_torch.core import coded_matvec

    real = coded_matvec.coded_matvec

    def products(packed, x, **kw):
        out = real(packed, x, **kw)
        out[: out.shape[0] // 2] = 0.0
        return out

    monkeypatch.setattr(coded_matvec, "coded_matvec", products)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-chat-coded", _token_altered),
    ("tiny-chat-plain", _token_altered),
    ("tiny-chat-coded", _half_the_batch_left_out),
    ("tiny-chat-coded", _kv_state_unchanged),
    ("tiny-stragglers", _answer_altered),
    ("tiny-stragglers", _products_half_lost),
], ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line = tinybench.run_cell(root, cell, seed=4242)
    assert rc == 0 and line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
