"""Serving with the paper's coded matvec as LM head: batched greedy
generation and continuous batching over a paged or a dense KV cache.

Counterpart of ``repro/runtime/serve_loop.py``.
Decode-time logits are the paper's workload: ``logits = E h`` with the
tied embedding ``E`` padded into ``kb`` row-blocks of ``R`` rows. An
``(nb, kb)`` MDS code over the blocks gives coded blocks
``E~_i = sum_j G[i, j] E_j``; worker w holds ``l_w`` of them (the
paper's load allocation in block units), and any ``kb`` coded
block-products reconstruct all logits. Workers missing the deadline
(T* x safety) are erasures.

Per decode step the coded round runs on the device with no host sync:
the block mix ``G X`` (B1 ``coded_matvec`` kernel), a finish mask drawn
from a ``torch.Generator``, the fixed-shape erasure decode, and the
argmax. The coded blocks are built once per plan by the B3
``mds_encode`` kernel, and the paged decode attend is the B2 kernel.

Three entry points: ``Server.generate`` (one batched prefill into a
dense cache, or, for a hybrid, ssm or audio model and a sliding-window
or ``kv_quant`` one, a sequential prefill of ``decode_step`` over the
prompt positions; then a
greedy decode in which every sampled token, the first included, goes
through the coded head), and ``Server.serve`` with ``paged=True`` (the
block pool with chunked prefill) or ``paged=False`` (a dense per-slot
cache with a batched admit splice); ``serve`` refuses what
``Model._check_slot_support`` refuses.

Dispatch programs (``runtime/graphs.py``), the reference's compiled
programs: a ``generate`` call, a paged serve dispatch (its prefill chunk
and decode chunk) and a dense one (its admit splice and decode chunk)
are each one program function over static inputs and state kept at
fixed addresses (the server's finish-mask generator, the serve run's KV
cache, pending logits, positions and (ok, erased) counters, the head's
deadline, the true fleet's arrays). On the
card a key's first dispatch runs eagerly, its second captures a CUDA
graph and every later one replays it (``ServeConfig.jit_pipeline``,
default True); ``Server.traces`` and
``Server.serve_traces`` count the programs built, as the reference
counts its traces. A paged key is (prefilling, steps) within the
shapes (S, num_blocks, block_len, C), a dense one (admitting, steps)
within (S, prompt_cap, cache length), a ``generate`` one (B, S0,
max_new, cache length, the extras' shapes); a finish mask drawn from
the true fleet or not, and an ``observe`` callback or not, are parts of
the key. ``jit_pipeline=False`` keeps the eager paths: ``generate`` runs
the per-token host loop (``_generate_hostloop``), and the serve
programs run uncaptured. A structural replan (``CodedLMHead.refresh``:
new shapes or a B3 re-encode) drops the programs; a bucket switch
(``rebind_soft``) keeps every one. A server keeps the serve state of one
shape: a run of another shape drops the old state and the old shape's
programs (and builds its own), and with nothing captured the state
lives for one run.

Closed loop: ``set_true_cluster`` makes the finish masks draw from a
scenario's true fleet while the head keeps the plan the controller last
chose; ``refresh_coded_head`` (an ``AdaptiveController``'s ``on_replan``)
re-encodes the head for the executor's new plan through B3; and
``serve(controller=...)`` scales admission control by the controller's
``coverage_latency``. ``serve(clock=...)`` runs every dispatch under a
``RoundClock`` and, with a controller, replans from the measured times.

Bucket mode (``ServeConfig.bucket_quantum``): the head is coded once at
the bucket slot capacity ``n_cap`` (the first ``n`` rows of a systematic
``(n_cap, kb)`` code are a valid ``(n, kb)`` code), the finish mask and
the block-erasure mask come from the active bucket's row, and a replan
that lands in the capacity only rebinds host views: B3 runs again only
on a structural replan.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.coding import ErasureDecoder, encode
from repro_torch.core.planner import DeploymentPlan
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import AllocationScheme
from repro_torch.kernels.coded_matvec.ops import blocked_matvec
from repro_torch.models.model import Model, padded_vocab
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, SpanTracer
from repro_torch.runtime.executor import CodedRoundExecutor
from repro_torch.runtime.graphs import ProgramSet
from repro_torch.runtime.plan_bucket import BucketConfig
from repro_torch.serve.scheduler import BlockPool, SlotScheduler

NEG_INF = -1e30  # pad-vocab sentinel (matches Model._mask_pad_logits)


def set_full_fp32() -> None:
    """Float32 matmuls and convolutions in full precision, never TF32.

    The coded head's erasure solve amplifies input error by the condition
    number of the surviving generator rows (DESIGN.md section 4).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class ServeConfig:
    block_rows: int = 256  # R: vocab rows per MDS block
    deadline_safety: float = 3.0
    max_decode_steps: int = 32  # generate's default max_new
    scheme: str | AllocationScheme = "optimal"  # registry name or object
    # dispatch programs captured as CUDA graphs on the card; False: the
    # eager paths (``generate``'s per-token host loop) as the A/B baseline
    jit_pipeline: bool = True
    # ``serve`` runs on the paged block pool with chunked prefill;
    # ``paged=False`` keeps the dense per-slot cache
    paged: bool = True
    block_len: int = 16  # tokens per physical KV block
    num_blocks: int | None = None  # pool size; None = dense-equivalent auto
    prefill_chunk: int | None = None  # admission chunk; None = prompt_cap
    # plan bucketing: quantize integer loads onto bucket shapes; a replan
    # within the bucket capacity then keeps the coded head
    bucket_quantum: int | None = None
    bucket_capacity: int = 8
    bucket_headroom: float = 1.5

    def bucket_config(self) -> BucketConfig | None:
        if self.bucket_quantum is None:
            return None
        return BucketConfig(quantum=self.bucket_quantum, capacity=self.bucket_capacity,
                            n_headroom=self.bucket_headroom)


class CodedLMHead:
    """MDS-coded unembedding for straggler-tolerant decode.

    Plan, deadline, finish-mask sampling and the worker -> block scatter
    map come from a ``CodedRoundExecutor`` on the table's device; the
    head adds the coded vocab blocks and the logits encode/decode.
    ``g`` injects a numpy (nb, kb) generator in place of the seeded one.
    With ``bucket_config`` the head is coded at the bucket slot capacity.

    ``deadline`` is also a 0-d float32 tensor on the table's device
    (``deadline_t``, rewritten in place whenever ``deadline`` is set), so
    a captured program reads each new deadline. ``version`` counts
    refreshes (each binds a new generator and coded table): a server
    drops its programs when it moves.
    """

    def __init__(self, embed_table: torch.Tensor, cluster: ClusterSpec, *,
                 block_rows: int = 256, scheme: str | AllocationScheme = "optimal",
                 deadline_safety: float = 3.0, g: np.ndarray | None = None,
                 bucket_config: BucketConfig | None = None, telemetry=None):
        self.table = embed_table.detach().float()  # (Vp, D)
        self.block_rows = block_rows
        self.kb = -(-self.table.shape[0] // block_rows)
        self.executor = CodedRoundExecutor(
            cluster, self.kb, scheme, deadline_safety=deadline_safety,
            device=self.table.device, bucket_config=bucket_config, telemetry=telemetry,
        )
        self.deadline_t = torch.zeros((), dtype=torch.float32, device=self.table.device)
        self.version = 0
        self.refresh(g)

    @property
    def deadline(self) -> float:
        """The finish masks' deadline (the planned one unless a caller set it)."""
        return self._deadline

    @deadline.setter
    def deadline(self, value: float) -> None:
        self._deadline = float(value)
        self.deadline_t.fill_(self._deadline)

    def refresh(self, g: np.ndarray | None = None) -> None:
        """(Re)bind the plan-derived state: nb, G (the seeded one, or the
        injected (nb, kb) ``g``) and its decoder, coded blocks (one B3
        launch), deadline.

        In bucket mode nb is the slot capacity ``n_cap``: one generator
        and one coded table serve every admitted bucket (capacity rows
        are never alive), rebuilt only on a structural replan.
        """
        self.plan: DeploymentPlan = self.executor.plan
        self.nb = self.executor.n_slots
        self.generator = self.executor.generator(g=g)
        self.decoder = ErasureDecoder(self.generator)
        vp, d = self.table.shape
        blocks = F.pad(self.table, (0, 0, 0, self.kb * self.block_rows - vp))
        self.coded = encode(
            self.generator, blocks.reshape(self.kb, self.block_rows * d)
        ).reshape(self.nb, self.block_rows, d)
        self.version += 1
        self.deadline = self.executor.deadline
        #: (nb,) worker holding each coded block
        self.block_owner = self.executor.slot_owner

    def rebind_soft(self) -> None:
        """Rebind after a bucket switch (not structural): generator and
        coded blocks stay; the plan, deadline and scatter map views move,
        and the executor's masks read the new bucket on the device."""
        self.plan = self.executor.plan
        self.deadline = self.executor.deadline
        self.block_owner = self.executor.slot_owner

    def replan(self, new_cluster: ClusterSpec, *, g: np.ndarray | None = None
               ) -> DeploymentPlan:
        """Elastic replan (scheme params kept), then ``refresh(g)``, or
        ``rebind_soft`` after a bucket switch."""
        plan = self.executor.replan(new_cluster)
        if self.executor.last_replan_structural:
            self.refresh(g)
        else:
            self.rebind_soft()
        return plan

    def finish_mask(self, generator: torch.Generator, deadline=None, *,
                    true_params=None) -> torch.Tensor:
        """(W,) bool straggler mask at ``deadline`` (default: the head's
        ``deadline``, the planned one unless a caller moved it).
        ``true_params`` (mus, alphas, shifts) per worker replace the
        plan's (``executor.worker_param_arrays(true_cluster)``)."""
        mus, alphas, shifts = (None, None, None) if true_params is None else true_params
        return self.executor.finish_mask(
            generator, self.deadline_t if deadline is None else deadline,
            mus=mus, alphas=alphas, shifts=shifts)

    def encode_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Mix plain logit BLOCKS with G: (B, V) -> (nb, B, R) products.

        Coded products are linear in the hidden state, so mixing logit
        blocks with G equals each worker computing ``E~_i h``. The B*R
        columns are one dimension of a single B1 kernel launch.
        """
        b, v = logits.shape
        r = self.block_rows
        lf = F.pad(logits.float(), (0, self.kb * r - v))
        cols = lf.reshape(b, self.kb, r).permute(1, 0, 2).reshape(self.kb, b * r)
        return blocked_matvec(self.generator, cols.contiguous()).reshape(self.nb, b, r)

    def decode_logits(self, products: torch.Tensor, finished_workers: torch.Tensor):
        """(nb, B, R) + (W,) mask -> ((B, kb*R) logits, 0-d bool ok).

        The torch twin of the reference's ``decode_logits_jit`` (and, in
        bucket mode, ``decode_logits_bucket_jit``): the worker mask
        gathers through the executor's ``slot_mask`` to an (nb,)
        block-erasure mask (capacity padding rows dead) and the head's
        ``decoder`` (bound at ``refresh``) solves for the logit blocks. For
        the seeded systematic generator that is the static reduced solve:
        the surviving systematic blocks are taken as they are and the
        erased ones solved for in a static (nb - kb)-square system of the
        surviving parity blocks (in bucket mode nb is the capacity, its
        padding rows always dead); for an injected non-systematic ``g``,
        the static (kb, kb) system.
        """
        nb, b, r = products.shape
        z, ok = self.decoder(products.reshape(nb, b * r),
                             self.executor.slot_mask(finished_workers))
        return z.reshape(self.kb, b, r).permute(1, 0, 2).reshape(b, -1), ok

    def worker_products(self, h: torch.Tensor) -> torch.Tensor:
        """All coded block-products for hiddens h (B, D): (nb, B, R).

        One B1 launch: the coded table as (nb*R, D) times h^T (D, B).
        """
        nb, r, d = self.coded.shape
        y = blocked_matvec(self.coded.reshape(nb * r, d), h.float().T.contiguous())
        return y.reshape(nb, r, -1).permute(0, 2, 1)


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """Result of one ``Server.serve`` run over a request trace.

    Latencies and the clock are in ROUNDS (one slot-decode step = one
    round, one batched prefill pass = one round); ``wall_s`` is measured.
    Beyond the reference's fields: ``streams`` (request id -> emitted
    tokens), ``decode_ok`` (coded rounds whose erasure decode succeeded),
    ``erased_rounds`` (coded rounds where at least one worker missed the
    deadline) and ``kv_bytes`` (bytes of the KV block pool).
    """

    finished: tuple
    tokens: int
    rounds: float
    decode_rounds: int
    prefill_rounds: int
    admitted: int
    shed: int
    wall_s: float
    streams: dict
    decode_ok: int
    erased_rounds: int
    kv_bytes: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else float("inf")

    def latencies(self) -> np.ndarray:
        """Arrival-to-last-token latencies (rounds) of DONE requests."""
        return np.asarray(
            [f.latency for f in self.finished if f.outcome == "done"], float
        )

    def latency_percentile(self, q: float) -> float:
        lat = self.latencies()
        return float(np.percentile(lat, q)) if lat.size else float("nan")


class Server:
    """Greedy generation and continuous batching (paged or dense KV) with an
    optional coded LM head (``cluster=None``: the plain head).

    Every ``generate`` and every serve dispatch runs one dispatch program
    (module docstring): captured and replayed on the card, called on the
    CPU. ``traces`` counts the ``generate`` programs built, and
    ``serve_traces`` the serve programs (paged and dense), across
    structural replans; ``programs`` is the ``ProgramSet``.
    """

    def __init__(self, model: Model, cluster: ClusterSpec | None = None,
                 cfg: ServeConfig | None = None):
        self.model = model
        self.cfg = cfg or ServeConfig()
        self.device = model.device
        self.coded_head = (
            CodedLMHead(model.embed, cluster, block_rows=self.cfg.block_rows,
                        scheme=self.cfg.scheme,
                        deadline_safety=self.cfg.deadline_safety,
                        bucket_config=self.cfg.bucket_config())
            if cluster is not None else None
        )
        #: the true fleet's per-worker (mus, alphas, shifts) the finish
        #: masks draw from (``set_true_cluster``; tensors rewritten in
        #: place); None: the plan's own
        self._true_params = None
        self._true_bufs = None
        #: the ClusterSpec behind ``_true_params`` (a ``RoundClock``
        #: decomposes against the spec)
        self._true_cluster = None
        #: span tracer; ``serve(tracer=...)`` rebinds it, and ``generate``
        #: records a ``dispatch`` span on whichever tracer is bound
        self.tracer = NULL_TRACER
        #: the finish masks' generator, re-seeded by every serve and generate
        self._generator = torch.Generator(device=self.device)
        #: the serve state's shape and, while captured programs read it, the
        #: state: KV cache, pending logits, pos, stats
        self._serve_shape = None
        self._serve_st = None
        self._programs: ProgramSet | None = None
        self._capture_on = True
        self._head_version = None if self.coded_head is None else self.coded_head.version

    # ----------------------------------------------------------- programs
    @property
    def _capture(self) -> bool:
        """Private: False runs the same program functions uncaptured on the
        card, the eager side of the parity runs. Set before the first
        dispatch; a later change raises."""
        return self._capture_on

    @_capture.setter
    def _capture(self, on: bool) -> None:
        if self._programs is not None:
            raise RuntimeError("Server._capture is set before the programs are built")
        self._capture_on = bool(on)

    @property
    def programs(self) -> ProgramSet:
        """The server's programs, captured on the card unless
        ``jit_pipeline`` is False or the private ``_capture`` switch is off."""
        if self._programs is None:
            self._programs = ProgramSet(self.device,
                                        capture=self.cfg.jit_pipeline and self._capture_on)
        return self._programs

    @property
    def traces(self) -> int:
        """``generate`` programs built (the reference's retrace count)."""
        return self.programs.builds.get("generate", 0)

    @property
    def serve_traces(self) -> int:
        """Serve programs built, paged and dense: one per (prefilling or
        admitting, steps) key within a run's shapes."""
        return self.programs.builds.get("serve", 0)

    def _run(self, kind: str, key: tuple, fn, inputs: dict):
        """Dispatch program ``(kind, key)``; the programs go first when the
        head was refreshed (a structural replan) since the last dispatch."""
        head = self.coded_head
        if head is not None and head.version != self._head_version:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.programs.clear()
            self._head_version = head.version
        return self.programs.run(kind, (*key, self._true_params is not None), fn, inputs,
                                 generators=(self._generator,))

    def _seeded(self, seed: int) -> torch.Generator:
        self._generator.manual_seed(int(seed))
        return self._generator

    # --------------------------------------------------------- adaptivity
    def set_true_cluster(self, cluster: ClusterSpec | None) -> None:
        """Draw the finish masks from ``cluster`` (a scenario's truth):
        the head keeps planning against what the controller believes, but
        leavers never respond and drift shows up as missed deadlines.
        ``None`` draws from the plan's own cluster again."""
        if self.coded_head is None:
            raise ValueError("set_true_cluster requires a coded head")
        self._true_cluster = cluster
        if cluster is None:
            self._true_params = None
            return
        arrays = self.coded_head.executor.worker_param_arrays(cluster)
        if self._true_bufs is None or self._true_bufs[0].shape != arrays[0].shape:
            self._true_bufs = arrays
        else:
            for buf, new in zip(self._true_bufs, arrays):
                buf.copy_(new)
        self._true_params = self._true_bufs

    def refresh_coded_head(self) -> None:
        """Rebind the head to its executor's current plan: the new (nb, kb)
        code is re-encoded through B3 (and the programs go), or, after a
        bucket switch, only the host views move (``rebind_soft``, no B3,
        every program kept). The ``on_replan`` hook of an
        ``AdaptiveController``; the true fleet is cleared (its per-worker
        arrays may have had the old plan's shape), so set it again."""
        if self.coded_head is None:
            raise ValueError("refresh_coded_head requires a coded head")
        if self.coded_head.executor.last_replan_structural:
            self.coded_head.refresh()
        else:
            self.coded_head.rebind_soft()
        self._true_params = None
        self._true_cluster = None

    def coded_select(self, logits: torch.Tensor, generator: torch.Generator,
                     deadline=None):
        """One coded round on a (B, V) logits batch, on the device.

        Pad-vocab sentinels are zeroed before the block mix (they would
        dominate the float32 solve) and re-masked after decode; when
        fewer than kb blocks survive, the round falls back to the plain
        logits with ``torch.where`` (no host branch). In bucket mode the
        executor draws with the active bucket's loads and masks with its
        owner map. Returns (logits, ok, (W,) worker finish mask).
        """
        head = self.coded_head
        vocab = self.model.config.vocab_size
        lf = logits.float()
        keep = torch.arange(lf.shape[-1], device=lf.device)[None, :] < vocab
        products = head.encode_logits(torch.where(keep, lf, 0.0))
        mask = head.finish_mask(generator, deadline, true_params=self._true_params)
        dec, ok = head.decode_logits(products, mask)
        dec = torch.where(keep, dec[:, : lf.shape[-1]], NEG_INF)
        return torch.where(ok, dec, lf), ok, mask

    # ------------------------------------------------------------ generate
    def _can_batch_prefill(self) -> bool:
        """True when ``Model.prefill`` covers this model (the slot and paged
        paths' envelope: an attention-cache family, no int8 cache, no
        sliding window)."""
        c = self.model.config
        return (c.family in ("dense", "vlm", "moe") and not c.kv_quant
                and c.sliding_window is None)

    def _prefill_into_cache(self, cache: dict, prompts: torch.Tensor):
        """One batched ``Model.prefill`` spliced into an ``init_cache`` state:
        the prompt K/V land in positions [0, S0). Returns (logits, cache)."""
        b, s0 = prompts.shape
        lengths = torch.full((b,), s0, dtype=torch.int32, device=prompts.device)
        logits, ks, vs = self.model.prefill(prompts, lengths)
        cache["k"][:, :, :s0] = ks
        cache["v"][:, :, :s0] = vs
        cache["pos"][:, :s0] = torch.arange(s0, dtype=torch.int32, device=prompts.device)
        return logits, cache

    def _generate_steps(self, prompts, max_new: int, cache: dict, sample):
        """The prefill (batched, or ``decode_step`` over the prompt
        positions) and ``max_new - 1`` decode steps; ``sample(step,
        logits)`` picks each token. Returns the (B, S0 + max_new) tokens."""
        s0 = prompts.shape[1]
        if self._can_batch_prefill():
            logits, cache = self._prefill_into_cache(cache, prompts)
        else:
            for t in range(s0):
                logits, cache = self.model.decode_step(cache, prompts[:, t], t)
        tok = sample(0, logits)
        out = [prompts, tok[:, None]]
        for t in range(max_new - 1):
            logits, cache = self.model.decode_step(cache, tok, s0 + t)
            tok = sample(t + 1, logits)
            out.append(tok[:, None])
        return torch.cat(out, dim=1)

    def _coded_sample(self, logits: torch.Tensor):
        """(token, (logits, selected, ok, mask)) of one sampled token."""
        sel, ok, mask = logits, None, None
        if self.coded_head is not None:
            sel, ok, mask = self.coded_select(logits, self._generator)
        return torch.argmax(sel, -1).to(torch.int32), (logits, sel, ok, mask)

    def _gen_program(self, inp: dict, *, max_new: int, cache_len: int, observing: bool):
        """The ``generate`` program: its own cache (made and filled inside
        the program, so a replay resets it), the prefill and every token's
        coded round. Returns (tokens, per-step (logits, selected, ok,
        mask) stacked, or None without ``observing``)."""
        prompts = inp["prompts"]
        extras = {n[len("extras."):]: t for n, t in inp.items()
                  if n.startswith("extras.")} or None
        cache = self.model.init_cache(prompts.shape[0], cache_len, extras)
        seen = []

        def sample(_step, logits):
            tok, rec = self._coded_sample(logits)
            seen.append(rec)
            return tok

        tokens = self._generate_steps(prompts, max_new, cache, sample)
        if not observing:
            return tokens, None
        return tokens, tuple(None if seen[0][i] is None
                             else torch.stack([rec[i] for rec in seen]) for i in range(4))

    def _generate_hostloop(self, prompts: torch.Tensor, max_new: int, cache_len: int,
                           extras, observe) -> torch.Tensor:
        """The eager per-token loop (``jit_pipeline=False``): the same
        operations as the ``generate`` program, issued one by one from the
        host, ``observe`` called as each token is sampled. The A/B
        baseline of the captured program."""
        cache = self.model.init_cache(prompts.shape[0], cache_len, extras)

        def sample(step, logits):
            tok, rec = self._coded_sample(logits)
            if observe is not None:
                observe(step, *rec)
            return tok

        return self._generate_steps(prompts, max_new, cache, sample)

    @torch.no_grad()
    def generate(self, prompts, max_new: int | None = None, *, seed: int = 0,
                 cache_len: int | None = None, observe=None,
                 extras: dict | None = None) -> torch.Tensor:
        """Greedy decode. prompts: (B, S0) int (a tensor or numpy); returns
        (B, S0 + max_new) int32 on the server's device.

        ``extras`` goes to ``Model.init_cache`` as tensors on the server's
        device (audio: ``{"enc_out"}``; vlm serves text only, as the
        reference). One batched prefill fills
        a dense cache (a hybrid, ssm or audio model, a sliding-window or
        int8 cache: ``decode_step`` over the prompt positions in turn, as
        the reference's fallback), then ``max_new - 1`` decode steps. With a
        coded head every sampled token goes through it, the first
        post-prefill one included; finish masks draw from the server's
        ``torch.Generator`` seeded with ``seed``. ``observe``, if given, is
        called once per sampled token as ``observe(step, logits, selected,
        ok, mask)``: the model's logits, those the token was taken from,
        and the round's decode-ok flag and (W,) finish mask (None without
        a coded head), all on the device; the program records them and
        the calls follow it. The call is one ``dispatch`` span
        (``kind="generate"``) on ``self.tracer``: one program, or the host
        loop with ``jit_pipeline=False``.
        """
        set_full_fp32()
        dev = self.device
        max_new = int(self.cfg.max_decode_steps if max_new is None else max_new)
        prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
        if max_new == 0:
            return prompts
        b, s0 = prompts.shape
        cache_len = int(cache_len or s0 + max_new)
        extras = {n: torch.as_tensor(t, device=dev) for n, t in (extras or {}).items()} or None
        self._seeded(seed)
        with self.tracer.span("dispatch", kind="generate", max_new=max_new, batch=b):
            if not self.cfg.jit_pipeline:
                return self._generate_hostloop(prompts, max_new, cache_len, extras, observe)
            inputs = {"prompts": prompts, **{f"extras.{n}": t for n, t in (extras or {}).items()}}
            observing = observe is not None
            key = (b, s0, max_new, cache_len, observing,
                   *((n, tuple(t.shape), t.dtype) for n, t in inputs.items()))
            tokens, seen = self._run(
                "generate", key, functools.partial(self._gen_program, max_new=max_new,
                                                   cache_len=cache_len, observing=observing),
                inputs)
            if observing:
                for t in range(max_new):
                    observe(t, *(None if x is None else x[t] for x in seen))
            return tokens

    # -------------------------------------------------- continuous batching
    def _decode_chunk(self, step_fn, cache, logits, pos, active, stats, steps: int):
        """``steps`` decode rounds: each samples every slot's next token
        from its pending logits (one coded round across the batch) and
        advances the model with ``step_fn(cache, tokens, pos)``; inactive
        slots keep their logits and pos. Returns (logits, pos, (steps, S)
        tokens or None)."""
        toks = []
        for _ in range(steps):
            sel = logits
            if self.coded_head is not None:
                sel, ok, mask = self.coded_select(logits, self._generator)
                stats[0] += ok.to(torch.int64)
                stats[1] += (~mask.all()).to(torch.int64)
            tok = torch.argmax(sel, -1).to(torch.int32)
            nlog, cache = step_fn(cache, tok, pos)
            logits = torch.where(active[:, None], nlog.float(), logits)
            pos = torch.where(active, pos + 1, pos)
            toks.append(tok)
        return logits, pos, (torch.stack(toks) if toks else None)

    @staticmethod
    def _dense_splice(cache: dict, logits, pos, plog, ks, vs, lengths, rows):
        """The dense admit splice at a fixed shape: ``rows`` (S,) gives each
        slot its admission row of the prefill batch, or -1 to keep its
        stream. An admitted slot's cache row becomes its prompt's K/V in
        positions [0, P) and zeros after, its position map the prompt's
        positions (-1 past its length and after P); its pending logits
        become the prefill's and ``pos`` its prompt length. In place on
        the cache; returns (logits, pos)."""
        fresh = rows >= 0
        row = rows.clamp(min=0).long()
        p = ks.shape[2]
        fkv = fresh[None, :, None, None, None]
        for name, new in (("k", ks), ("v", vs)):
            head = cache[name][:, :, :p]
            head.copy_(torch.where(fkv, new[:, row], head))
            cache[name][:, :, p:].masked_fill_(fkv, 0)
        plen = lengths[row]
        seq = torch.arange(p, dtype=torch.int32, device=rows.device)
        head = cache["pos"][:, :p]
        head.copy_(torch.where(fresh[:, None],
                               torch.where(seq[None, :] < plen[:, None], seq[None, :], -1),
                               head))
        cache["pos"][:, p:].masked_fill_(fresh[:, None], -1)
        return (torch.where(fresh[:, None], plog[row].float(), logits),
                torch.where(fresh, plen, pos))

    def _dense_program(self, st: dict, inp: dict, *, admitting: bool, steps: int):
        """One dense serve dispatch: the admit splice, then ``steps`` decodes.

        ``admitting``: ``inp`` holds ``prompts`` (S, P) (this round's A
        admissions in the first A rows, right-padded to the prompt
        capacity P; rows past A all zeros, length 0, as the reference
        pads them: an MoE layer routes every row), ``lengths`` (S,) and
        ``rows`` (S,), each slot's admission row or -1. One
        ``Model.prefill`` pass over the batch and ``_dense_splice``. No
        token is sampled at admission: the decode chunk samples from the
        pending logits. Updates ``st`` in place; returns the (steps, S)
        tokens.
        """
        cache, logits, pos = st["cache"], st["logits"], st["pos"]
        if admitting:
            plog, ks, vs = self.model.prefill(inp["prompts"], inp["lengths"])
            logits, pos = self._dense_splice(cache, logits, pos, plog, ks, vs,
                                             inp["lengths"], inp["rows"])
        logits, pos, toks = self._decode_chunk(self.model.decode_step_slots, cache, logits,
                                               pos, inp["active"], st["stats"], steps)
        st["logits"].copy_(logits)
        st["pos"].copy_(pos)
        return toks

    def _paged_program(self, st: dict, inp: dict, *, prefilling: bool, steps: int):
        """One paged serve dispatch: the prefill chunk, then ``steps`` decodes.

        ``prefilling``: ``inp`` holds ``tokens`` (S, C), ``start``,
        ``lens`` and ``finishing`` (S,); the slots finishing their prompt
        this round take the chunk's logits as pending logits and jump
        ``pos`` to the prompt length. Each decode step samples every
        slot's next token from its pending logits (one coded round across
        the batch) and advances the model; inactive slots write the sink
        and keep logits and pos. ``table`` (S, num_blocks) and ``active``
        (S,) in every dispatch. Updates ``st`` in place; returns the
        (steps, S) tokens, None for steps 0.
        """
        cache, logits, pos = st["cache"], st["logits"], st["pos"]
        table, active = inp["table"], inp["active"]
        if prefilling:
            plog, cache = self.model.prefill_paged(cache, inp["tokens"], inp["start"],
                                                   inp["lens"], table)
            fin = inp["finishing"]
            logits = torch.where(fin[:, None], plog.float(), logits)
            pos = torch.where(fin, inp["start"] + inp["lens"], pos)
        logits, pos, toks = self._decode_chunk(
            lambda c, tok, p: self.model.decode_step_paged(c, tok, p, table, active),
            cache, logits, pos, active, st["stats"], steps)
        st["logits"].copy_(logits)
        st["pos"].copy_(pos)
        return toks

    def serve(self, trace, *, slots: int = 4, prompt_cap: int | None = None,
              max_out: int | None = None, decode_block: int = 4, queue_cap: int = 64,
              admission_threshold: float = 1.0, controller=None, round_latency=None,
              telemetry=None, clock=None, seed: int = 0, paged: bool | None = None,
              block_len: int | None = None, num_blocks: int | None = None,
              prefill_chunk: int | None = None, tracer=None) -> ServeReport:
        """Continuous batching: serve a request trace through S slots.

        The scheduler (host) decides placements; each round runs the
        round's prefill work and then a decode chunk of
        ``min(decode_block, min remaining)`` steps, so a slot frees the
        round its stream completes. Each round is one dispatch program;
        admits and evictions only change its inputs. Finish masks draw
        from the server's ``torch.Generator`` seeded with ``seed``.

        ``paged`` (default ``ServeConfig.paged``): the KV cache is a
        shared ``BlockPool`` (full reservation at admission, freed at
        retirement) and prompts prefill in ``prefill_chunk``-token pieces
        across rounds; ``num_blocks=None`` sizes the pool so the trace
        never exhausts it. ``paged=False``: every slot owns a dense cache
        row of ``prompt_cap + max_out + 1`` positions and a whole prompt
        is spliced in at admission, so a prompt longer than ``prompt_cap``
        is refused. The cache, pending logits and counters of a run are
        kept by the server per shape and reset at the start of each run.

        Admission control scales each request's projected completion by
        ``round_latency() / reference`` (a callable in round units; by
        default ``controller.coverage_latency`` of an
        ``AdaptiveController``), the reference sampled once at the start,
        so the scheduler sheds when rounds are estimated to run slow.

        ``clock`` (a ``runtime.timing.RoundClock``) times every dispatch
        (the prefill chunk and decode chunk of a round) until the device is
        done, decomposed with the generator cloned at the chunk's start (the
        draw that gated its first step); with ``controller`` the timings
        feed ``observe_timing``, so replans follow the measured rounds. The
        clock changes no result. Requires a coded head.

        Spans (``tracer``, a ``SpanTracer``): each round's ``admit``, then
        its ``prefill_chunk`` (a round that splices prompt chunks) or
        ``decode_chunk`` with the ``dispatch`` inside; a controller's
        ``adapt_update`` and the executor's ``replan`` nest in the chunk
        that fed it. A ``telemetry`` sink implies a tracer on it, an
        explicit tracer wins, neither means ``NULL_TRACER``. The tracer
        is bound to the server and the head's executor. Spans are host
        wall clock; they change no result.
        """
        if clock is not None and self.coded_head is None:
            raise ValueError("clock (measured serving) requires a coded head")
        if tracer is None:
            tracer = SpanTracer(telemetry) if telemetry is not None else NULL_TRACER
        self.tracer = tracer
        if self.coded_head is not None:
            self.coded_head.executor.tracer = tracer
        set_full_fp32()
        paged = self.cfg.paged if paged is None else paged
        trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
        if not trace:
            raise ValueError("serve needs a non-empty request trace")
        prompt_cap = int(prompt_cap if prompt_cap is not None
                         else max(r.prompt_len for r in trace))
        if round_latency is None and controller is not None:
            round_latency = controller.coverage_latency
        reference = 1.0
        if round_latency is not None:
            reference = float(round_latency())
            if not np.isfinite(reference) or reference <= 0:
                reference = 1.0
        admission = dict(queue_cap=queue_cap, admission_threshold=admission_threshold,
                         round_latency=round_latency, reference_latency=reference)
        measure = dict(clock=clock, controller=controller)
        if paged:
            return self._serve_paged(
                trace, slots=slots, prompt_cap=prompt_cap, decode_block=decode_block,
                admission=admission, telemetry=telemetry, seed=seed,
                block_len=block_len, num_blocks=num_blocks, prefill_chunk=prefill_chunk,
                **measure)
        too_long = [r.rid for r in trace if r.prompt_len > prompt_cap]
        if too_long:
            raise ValueError(f"requests {too_long} exceed prompt_cap={prompt_cap}")
        max_out = int(max_out if max_out is not None else max(r.out_len for r in trace))
        return self._serve_dense(
            trace, slots=slots, prompt_cap=prompt_cap, max_out=max_out,
            decode_block=decode_block, admission=admission, telemetry=telemetry, seed=seed,
            **measure)

    def _dispatch(self, run, generator: torch.Generator, clock, controller):
        """One serve dispatch in a ``dispatch`` span: ``run()``, or ``run()``
        under ``clock``, decomposed with ``generator`` cloned before the
        run; a controller then observes the timing, outside the span (the
        next dispatch after a structural replan is not fed). Returns
        ``run()``'s result."""
        if clock is None:
            with self.tracer.span("dispatch"):
                return run()
        draw = torch.Generator(device=generator.device)
        draw.set_state(generator.get_state())
        with self.tracer.span("dispatch"):
            timing = clock.measure(run, generator=draw, true_cluster=self._true_cluster)
        if controller is not None:
            d = controller.observe_timing(timing)
            if (d is not None and d.replanned
                    and self.coded_head.executor.last_replan_structural):
                clock.discard_next()
        return timing.result

    def _serve_state(self, shape: tuple, make_cache, slots: int) -> dict:
        """A serve run's state of ``shape``, reset as a new run's: the KV
        cache (``make_cache()``'s; a reset zeroes it, ``pos`` maps to -1),
        the pending logits, positions and the (ok, erased) counters. The
        server keeps one shape's: a new shape drops the old state and the
        programs that read it. Only captured programs need the state at
        fixed addresses; with nothing captured it lives for the run."""
        if shape != self._serve_shape:
            if self._serve_shape is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.programs.drop("serve", self._serve_shape)
            self._serve_shape, self._serve_st = shape, None
        st = self._serve_st
        if st is None:
            vp = padded_vocab(self.model.config.vocab_size)
            st = {"cache": make_cache(),
                  "logits": torch.zeros((slots, vp), dtype=torch.float32, device=self.device),
                  "pos": torch.zeros((slots,), dtype=torch.int32, device=self.device),
                  "stats": torch.zeros((2,), dtype=torch.int64, device=self.device)}
            if self.programs.capture:
                self._serve_st = st
            return st
        for name, t in st["cache"].items():
            if name == "pos":
                t.fill_(-1)
            else:
                t.zero_()
        for name in ("logits", "pos", "stats"):
            st[name].zero_()
        return st

    def _report(self, sched, metrics, telemetry, emitted, stats, *, now, t0,
                decode_rounds, prefill_rounds, kv_bytes) -> ServeReport:
        """Synchronise, then the run's ``ServeReport``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        streams: dict[int, list[int]] = {}
        for toks, owners in emitted:
            arr = toks.cpu().numpy()  # (steps, S)
            for si, rid in owners:
                streams.setdefault(rid, []).extend(int(t) for t in arr[:, si])
        ok, erased = (int(v) for v in stats.cpu())
        metrics.emit(telemetry, phase="serve", rounds=float(now))
        return ServeReport(
            finished=tuple(sched.finished),
            tokens=sum(f.tokens for f in sched.finished if f.outcome == "done"),
            rounds=now,
            decode_rounds=decode_rounds,
            prefill_rounds=prefill_rounds,
            admitted=sched.admitted,
            shed=sched.shed,
            wall_s=wall,
            streams={rid: tuple(v) for rid, v in streams.items()},
            decode_ok=ok,
            erased_rounds=erased,
            kv_bytes=kv_bytes,
        )

    def _serve_dense(self, trace, *, slots, prompt_cap, max_out, decode_block,
                     admission, telemetry, seed, clock, controller) -> ServeReport:
        """The dense slot-cache loop behind ``serve(paged=False)``.

        A round with admissions runs one batched prefill of the admitted
        prompts (the admit splice, one round) and then the decode chunk
        over every busy slot, as the reference's dense program does.
        """
        # +1: a finished slot would rewrite the entry one past its last token
        cache_len = prompt_cap + max_out + 1
        shape = ("dense", slots, prompt_cap, cache_len)
        st = self._serve_state(shape, lambda: self.model.init_slot_cache(slots, cache_len),
                               slots)
        kv_bytes = sum(st["cache"][n].numel() * st["cache"][n].element_size()
                       for n in ("k", "v"))
        metrics = MetricsRegistry()
        sched = SlotScheduler(slots, telemetry=telemetry, metrics=metrics, **admission)
        generator = self._seeded(seed)
        emitted = []

        tracer = self.tracer
        now, i = 0.0, 0
        prefill_rounds = decode_rounds = 0
        t0 = time.perf_counter()
        while i < len(trace) or not sched.idle:
            with tracer.span("admit", round=now) as asp:
                while i < len(trace) and trace[i].arrival <= now + 1e-9:
                    sched.offer(trace[i], now)
                    i += 1
                placed = sched.fill_slots(now)
                asp.set(placed=len(placed))
                admit = {}
                if placed:
                    prompts_np = np.zeros((slots, prompt_cap), np.int32)
                    lengths_np = np.zeros((slots,), np.int32)
                    rows_np = np.full((slots,), -1, np.int32)
                    for r, (si, req) in enumerate(placed):
                        prompts_np[r, : req.prompt_len] = req.prompt
                        lengths_np[r] = req.prompt_len
                        rows_np[si] = r
                    admit = {"prompts": prompts_np, "lengths": lengths_np, "rows": rows_np}
            active = [s.busy and not s.done for s in sched.slots]
            if any(active):
                steps = min(decode_block, min(
                    s.request.out_len - s.generated
                    for si, s in enumerate(sched.slots) if active[si]))
                owners = [(si, s.request.rid) for si, s in enumerate(sched.slots)
                          if active[si]]
                inputs = {"active": np.asarray(active), **admit}
                fn = functools.partial(self._dense_program, st, admitting=bool(placed),
                                       steps=steps)
                with tracer.span("decode_chunk", steps=steps, round=now,
                                 placed=len(placed)):
                    toks = self._dispatch(
                        lambda: self._run("serve", (*shape, bool(placed), steps), fn,
                                          inputs),
                        generator, clock, controller)
                emitted.append((toks, owners))
                if placed:  # the admit splice costs its own round
                    now += 1.0
                    prefill_rounds += 1
                now += float(steps)
                decode_rounds += steps
                sched.advance(steps)
                sched.retire_done(now)
            elif i < len(trace):
                now = max(now, trace[i].arrival)  # idle: jump to next arrival
            else:
                break
        return self._report(sched, metrics, telemetry, emitted, st["stats"], now=now, t0=t0,
                            decode_rounds=decode_rounds, prefill_rounds=prefill_rounds,
                            kv_bytes=kv_bytes)

    def _serve_paged(self, trace, *, slots, prompt_cap, decode_block, admission,
                     telemetry, seed, block_len, num_blocks, prefill_chunk, clock,
                     controller) -> ServeReport:
        """The paged-KV loop behind ``serve(paged=True)``.

        Each round runs one prefill chunk for every slot still mid-prompt
        and then the decode chunk; physical KV lives in a shared
        ``BlockPool``, reserved in full at admission.
        """
        cfg = self.cfg
        chunk = int(prefill_chunk if prefill_chunk is not None
                    else cfg.prefill_chunk if cfg.prefill_chunk is not None
                    else prompt_cap)
        bl = int(block_len if block_len is not None else cfg.block_len)
        nb = num_blocks if num_blocks is not None else cfg.num_blocks
        if nb is None:
            # dense-equivalent capacity: every slot can hold the largest request
            nb = slots * max(-(-(r.prompt_len + r.out_len + 1) // bl) for r in trace)
        nb = int(nb)
        shape = ("paged", slots, nb, bl, chunk)
        st = self._serve_state(shape, lambda: self.model.init_paged_cache(nb, bl), slots)
        kv_bytes = sum(t.numel() * t.element_size() for t in st["cache"].values())
        metrics = MetricsRegistry()
        pool = BlockPool(nb, bl, bytes_per_block=kv_bytes // (nb + 1),
                         telemetry=telemetry, metrics=metrics)
        sched = SlotScheduler(slots, telemetry=telemetry, pool=pool, chunk=chunk,
                              metrics=metrics, **admission)
        generator = self._seeded(seed)
        # host mirror of the block tables, width = pool size
        table_np = np.full((slots, nb), -1, np.int32)
        emitted = []  # ((steps, S) tokens, [(slot, rid)]) per dispatch

        tracer = self.tracer
        now, i = 0.0, 0
        prefill_rounds = decode_rounds = 0
        t0 = time.perf_counter()
        while i < len(trace) or not sched.idle:
            with tracer.span("admit", round=now) as asp:
                while i < len(trace) and trace[i].arrival <= now + 1e-9:
                    sched.offer(trace[i], now)
                    i += 1
                placed = sched.fill_slots(now)
                asp.set(placed=len(placed))
                for si, _req in placed:
                    blocks = sched.slots[si].blocks
                    table_np[si, :] = -1
                    table_np[si, : len(blocks)] = blocks
            # this round's prefill chunk: the next `chunk` prompt tokens of
            # every slot still mid-prompt, in one batched pass
            chunk_np = None
            notes = []
            for si, s in enumerate(sched.slots):
                if not s.prefilling:
                    continue
                if chunk_np is None:
                    chunk_np = np.zeros((slots, chunk), np.int32)
                    start_np = np.zeros((slots,), np.int32)
                    lens_np = np.zeros((slots,), np.int32)
                    fin_np = np.zeros((slots,), bool)
                take = min(chunk, s.request.prompt_len - s.prefilled)
                chunk_np[si, :take] = s.request.prompt[s.prefilled: s.prefilled + take]
                start_np[si] = s.prefilled
                lens_np[si] = take
                fin_np[si] = s.prefilled + take >= s.request.prompt_len
                notes.append((si, take))
            prefilling = chunk_np is not None
            # decode-eligible after the splice: done prefilling already, or
            # finishing it in this very dispatch
            active = [
                s.busy and not s.done
                and (not s.prefilling or (prefilling and fin_np[si]))
                for si, s in enumerate(sched.slots)
            ]
            steps = 0
            if any(active):
                steps = min(decode_block, min(
                    s.request.out_len - s.generated
                    for si, s in enumerate(sched.slots) if active[si]
                ))
            if prefilling or steps > 0:
                inputs = {"table": table_np, "active": np.asarray(active)}
                if prefilling:
                    inputs.update(tokens=chunk_np, start=start_np, lens=lens_np,
                                  finishing=fin_np)
                owners = [(si, s.request.rid) for si, s in enumerate(sched.slots)
                          if active[si]]
                fn = functools.partial(self._paged_program, st, prefilling=prefilling,
                                       steps=steps)
                # a round that splices prompt chunks is a prefill round even
                # when finishing slots decode in the same dispatch
                with tracer.span("prefill_chunk" if prefilling else "decode_chunk",
                                 steps=steps, round=now, placed=len(placed)):
                    toks = self._dispatch(
                        lambda: self._run("serve", (*shape, prefilling, steps), fn, inputs),
                        generator, clock, controller)
                if toks is not None:
                    emitted.append((toks, owners))
                for si, take in notes:
                    sched.note_prefill(si, take)
                if prefilling:  # the batched chunk pass costs one round
                    now += 1.0
                    prefill_rounds += 1
                if steps > 0:
                    now += float(steps)
                    decode_rounds += steps
                    sched.advance(steps)
                for si, _fin in sched.retire_done(now):
                    table_np[si, :] = -1
            elif i < len(trace):
                now = max(now, trace[i].arrival)  # idle: jump to next arrival
            else:
                break
        return self._report(sched, metrics, telemetry, emitted, st["stats"], now=now, t0=t0,
                            decode_rounds=decode_rounds, prefill_rounds=prefill_rounds,
                            kv_bytes=kv_bytes)
