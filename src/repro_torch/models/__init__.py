"""Every model family: layers, attention (paged, windowed, int8 KV,
cross), routed experts, Mamba2, xLSTM cells, the Model module.

The reference's free functions take a config and a parameter tree; the
port's parameters live in the module, so each is a ``Model`` method
(README lists the mapping): ``init_params(config, key)`` is
``Model(config, seed=...)``, and ``loss_fn``, ``lm_logits``,
``init_cache`` and ``decode_step`` are the methods of those names.
"""
from repro_torch.models.model import Model, padded_vocab

__all__ = ["Model", "padded_vocab"]
