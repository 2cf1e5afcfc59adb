"""Atomic, async checkpointing in the reference's on-disk layout.

Counterpart of ``repro/checkpoint/store.py``: ``<dir>/step_<N>/`` holds
``shard_0.npz`` (``arr_0``, ``arr_1``, ... ) and ``meta.json`` (``step``,
``names``, ``dtypes`` and the caller's extra fields). Writes go to
``step_<N>.tmp/`` and are renamed after an fsync, so ``latest_step`` only
believes complete checkpoints.

The port's state is a flat ``{path: tensor}`` dict whose paths are the
reference tree's ("params/blocks/attn/wq", "opt/m/embed/table",
"opt/count", ...). Leaves are written in the order the reference's
``jax.tree_util`` flattens its tree (dict keys sorted at every level,
list entries in index order), so a checkpoint written by either package
restores in the other.
bfloat16 leaves are stored as a uint16 view, as the reference stores them.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch


def tree_order(names) -> list[str]:
    """Paths in the reference's flatten order, component by component: a
    dict's keys sorted, a list's entries (the xLSTM's ``blocks/<i>``) in
    index order, so ``blocks/10`` follows ``blocks/9``."""
    return sorted(names, key=lambda n: tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                                             for c in n.split("/")))


def _to_numpy(t) -> tuple[np.ndarray, str]:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        t = t.numpy()
    arr = np.asarray(t)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_str: str, like: torch.Tensor) -> torch.Tensor:
    if dtype_str == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)


def save_checkpoint(directory: str, step: int, state: dict,
                    extra_meta: dict | None = None) -> str:
    """Atomic synchronous save of a flat ``{path: tensor or array}`` state."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = tree_order(state)
    leaves, dtypes = zip(*(_to_numpy(state[n]) for n in names)) if names else ((), ())
    np.savez(os.path.join(tmp, "shard_0.npz"),
             **{f"arr_{i}": a for i, a in enumerate(leaves)})
    meta = {"step": step, "names": names, "dtypes": list(dtypes), **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: dict) -> tuple[dict, dict]:
    """Restore into the paths, shapes, dtypes and devices of ``like``."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    names = tree_order(like)
    if meta["names"] != names:
        raise ValueError(f"checkpoint leaves {meta['names']} != expected {names}")
    data = np.load(os.path.join(path, "shard_0.npz"))
    state = {
        n: _to_tensor(data[f"arr_{i}"], meta["dtypes"][i], like[n])
        for i, n in enumerate(names)
    }
    return state, meta


class AsyncCheckpointer:
    """Background writer: ``save`` copies to host, a thread writes. ``wait()`` before exit."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: dict, extra_meta: dict | None = None):
        self.wait()
        host = {n: t.detach().cpu().clone() if isinstance(t, torch.Tensor) else t
                for n, t in state.items()}

        def work():
            try:
                save_checkpoint(self.directory, step, host, extra_meta)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
