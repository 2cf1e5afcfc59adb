"""Dispatch programs: a dispatch's device work, captured once per static
key as a CUDA graph and replayed.

The port's counterpart of the reference's ``jax.jit`` programs with
donated buffers (``repro/runtime/serve_loop.py``: ``_gen_program``,
``_serve_step_program``, ``_serve_step_paged_program``). A program is a
Python function of two kinds of tensors that live as long as it does:

* **static inputs** — one device buffer per input, allocated at the
  program's build. Every dispatch copies its values in: host arrays go
  through a ring of pinned buffers (``PINNED_DEPTH`` deep, each slot
  reused only after the card has read it), device tensors are copied on
  the card;
* **state** — tensors the function reads and updates in place (a KV
  pool, the pending logits, positions, counters, a ``torch.Generator``).
  The caller owns them and keeps them at fixed addresses across
  dispatches, as donation does in the reference.

On the card the first dispatch of a key runs the function uncaptured: its
result is the dispatch's result, and it warms every library handle and
kernel module the function touches. The second dispatch of the key
captures the function once into a ``torch.cuda.CUDAGraph`` and replays
it, and every later one copies its inputs in and replays; the outputs,
which the graph rewrites on its next replay, are cloned. A key
dispatched once (a one-off ``generate``) is never captured. All graphs
of one ``ProgramSet`` share one memory pool, and replay in one stream,
one at a time. The generators a program draws from are registered with
its graph, so a replay draws from the generator's state at replay time,
as an uncaptured call does. A capture error raises; nothing falls back to the uncaptured
path. With ``capture=False`` (the CPU, or a caller that asks for the
uncaptured path) every dispatch calls the function.

``builds`` counts each (kind, key) a set builds, captured or not: the
reference's trace counters (``Server.traces``, ``Server.serve_traces``).
``clear`` drops every program (a structural replan: the next dispatch of
each key builds it again, and counts), ``drop`` the programs of one kind
whose keys start with a prefix (a serve shape the server no longer
holds state for).

A graph that outlives a ``torch.profiler`` session whose end tore CUPTI
down can crash the process when a later session replays it (the failure
``torch.profiler`` works around for compiled CUDA graphs by keeping
CUPTI up). So importing ``repro_torch`` sets ``TEARDOWN_CUPTI=0`` unless
the environment sets it: a profile may then replay any graph.

Kernel launch counts (``CudaKernel.launches``) count Python calls, and a
replay makes none. So the launches made while capturing are taken back
and recorded per program, and every replay adds them: each path's counts
are the same captured and uncaptured.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import KERNELS

#: pinned host buffers per input: a slot is rewritten only after the
#: copies of ``PINNED_DEPTH`` dispatches ago have left it
PINNED_DEPTH = 4


class _Staging:
    """Host-to-card copies of one program's inputs through pinned buffers."""

    def __init__(self, static: dict[str, torch.Tensor]):
        self.slots = [({name: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for name, t in static.items()}, torch.cuda.Event())
                      for _ in range(PINNED_DEPTH)]
        self.next = 0

    def copy(self, static: dict[str, torch.Tensor], host: dict[str, np.ndarray]) -> None:
        buffers, done = self.slots[self.next]
        self.next = (self.next + 1) % PINNED_DEPTH
        done.synchronize()  # the card has read this slot's last values
        for name, value in host.items():
            buffers[name].numpy()[...] = value
            static[name].copy_(buffers[name], non_blocking=True)
        done.record()


@dataclasses.dataclass
class Program:
    """One built program: its static inputs and, once captured, its graph,
    the outputs the graph writes and the launches a replay makes. It keeps
    no reference to its function (the caller passes it with every
    dispatch), so a server and its programs hold no reference cycle."""

    inputs: dict[str, torch.Tensor]
    staging: _Staging | None = None
    graph: Any = None
    outputs: Any = None
    launches: dict = dataclasses.field(default_factory=dict)


def _clone(tree):
    """Clones of the tensors in a tensor, or a tuple of them (None kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        return tuple(_clone(t) for t in tree)
    return tree


class ProgramSet:
    """The programs of one server, by (kind, key), on ``device``.

    ``capture`` is honoured on a CUDA device only. ``run`` is the one
    entry: it builds the program of a new key and dispatches it.
    """

    def __init__(self, device: torch.device, *, capture: bool = True):
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self._programs: dict[tuple, Program] = {}
        self._pool = None
        self._stream = None
        #: builds per kind, cumulative across ``clear``
        self.builds: dict[str, int] = {}
        #: captures made, and the seconds they took (host wall clock,
        #: the card synchronised before and after each)
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def keys(self, kind: str | None = None, *, captured: bool = False) -> list[tuple]:
        """The keys of the programs built since the last ``clear`` (with
        ``captured``: those whose graph is captured)."""
        return [key for (k, key), prog in self._programs.items()
                if (kind is None or k == kind) and (prog.graph is not None or not captured)]

    def clear(self) -> None:
        """Drop every program (their graphs and buffers with them). The
        memory pool goes with the last graph: later captures share a new
        one."""
        self._programs.clear()
        self._pool = None

    def drop(self, kind: str, prefix: tuple) -> None:
        """Drop the programs of ``kind`` whose keys start with ``prefix``;
        ``clear`` once none is left."""
        n = len(prefix)
        for k, key in list(self._programs):
            if k == kind and key[:n] == prefix:
                del self._programs[k, key]
        if not self._programs:
            self.clear()

    def run(self, kind: str, key: tuple, fn: Callable[[dict], Any], inputs: dict, *,
            generators=()) -> Any:
        """Dispatch program ``(kind, key)`` on ``inputs`` (name -> host array
        or tensor; their shapes and dtypes are the key's). ``fn(static)``
        computes the dispatch from the static input buffers and the state
        it closes over, the same for every dispatch of the key;
        ``generators`` are the ``torch.Generator``s it draws from. Returns ``fn``'s result: on a replay, clones of the
        outputs the graph wrote. The first dispatch of a key calls ``fn``;
        on the card the second captures it and replays."""
        prog = self._programs.get((kind, key))
        if prog is None:
            prog = self._build(kind, key, inputs)
            self._stage(prog, inputs)
            return fn(prog.inputs)
        self._stage(prog, inputs)
        if self.capture and prog.graph is None:
            self._capture(prog, fn, generators)
        if prog.graph is None:
            return fn(prog.inputs)
        prog.graph.replay()
        for kernel, n in prog.launches.items():
            kernel.launches += n
        self.replays += 1
        return _clone(prog.outputs)

    def _build(self, kind, key, inputs) -> Program:
        static = {}
        for name, value in inputs.items():
            like = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
            static[name] = torch.empty(like.shape, dtype=like.dtype, device=self.device)
        prog = Program(static)
        if self.device.type == "cuda" and any(not isinstance(v, torch.Tensor)
                                              for v in inputs.values()):
            prog.staging = _Staging({n: static[n] for n, v in inputs.items()
                                     if not isinstance(v, torch.Tensor)})
        self._programs[(kind, key)] = prog
        self.builds[kind] = self.builds.get(kind, 0) + 1
        return prog

    def _stage(self, prog: Program, inputs: dict) -> None:
        host = {}
        for name, value in inputs.items():
            if isinstance(value, torch.Tensor):
                prog.inputs[name].copy_(value)
            elif prog.staging is None:
                prog.inputs[name].copy_(torch.from_numpy(np.ascontiguousarray(value)))
            else:
                host[name] = value
        if host:
            prog.staging.copy(prog.inputs, host)

    def _capture(self, prog: Program, fn, generators) -> None:
        """Capture ``fn`` into ``prog``'s graph on a side stream, in the
        shared pool, with its generators registered and the garbage
        collector held off; its launch counts taken back. Raises if the
        capture fails."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = {k: k.launches for k in KERNELS}
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        # a collection inside the capture could destroy an unreachable
        # graph, a call that invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool)
                try:
                    outputs = fn(prog.inputs)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        prog.launches = {k: k.launches - before[k] for k in KERNELS
                         if k.launches != before[k]}
        for k in KERNELS:
            k.launches = before[k]
        prog.graph, prog.outputs = graph, outputs
        self.captures += 1
