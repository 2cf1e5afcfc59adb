"""Paged continuous-batching server with the paper's coded matvec as LM head.

Counterpart of ``repro/runtime/serve_loop.py`` (paged serving only).
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
``mds_encode`` kernel, and the model's decode attend is the B2 paged
kernel. The reference's one compiled program per chunk size becomes an
eager Python step here (no retrace counter is needed: nothing traces).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.coding import decode_systematic, encode
from repro_torch.core.planner import DeploymentPlan
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import AllocationScheme
from repro_torch.kernels.coded_matvec.ops import blocked_matvec
from repro_torch.models.model import Model, padded_vocab
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.executor import CodedRoundExecutor
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
    scheme: str | AllocationScheme = "optimal"  # registry name or object
    block_len: int = 16  # tokens per physical KV block
    num_blocks: int | None = None  # pool size; None = dense-equivalent auto
    prefill_chunk: int | None = None  # admission chunk; None = prompt_cap


class CodedLMHead:
    """MDS-coded unembedding for straggler-tolerant decode.

    Plan, deadline, finish-mask sampling and the worker -> block scatter
    map come from a ``CodedRoundExecutor`` on the table's device; the
    head adds the coded vocab blocks and the logits encode/decode.
    ``g`` injects a numpy (nb, kb) generator in place of the seeded one.
    """

    def __init__(self, embed_table: torch.Tensor, cluster: ClusterSpec, *,
                 block_rows: int = 256, scheme: str | AllocationScheme = "optimal",
                 deadline_safety: float = 3.0, g: np.ndarray | None = None):
        self.table = embed_table.detach().float()  # (Vp, D)
        self.block_rows = block_rows
        self.kb = -(-self.table.shape[0] // block_rows)
        self.executor = CodedRoundExecutor(
            cluster, self.kb, scheme, deadline_safety=deadline_safety,
            device=self.table.device,
        )
        self._g = g
        self.refresh()

    def refresh(self) -> None:
        """(Re)bind the plan-derived state: nb, G, coded blocks, deadline."""
        self.plan: DeploymentPlan = self.executor.plan
        self.nb = self.plan.n
        self.generator = self.executor.generator(g=self._g)
        vp, d = self.table.shape
        blocks = F.pad(self.table, (0, 0, 0, self.kb * self.block_rows - vp))
        self.coded = encode(
            self.generator, blocks.reshape(self.kb, self.block_rows * d)
        ).reshape(self.nb, self.block_rows, d)
        self.deadline = self.executor.deadline
        #: (nb,) worker holding each coded block
        self.block_owner = self.executor.slot_owner

    def finish_mask(self, generator: torch.Generator, deadline=None
                    ) -> torch.Tensor:
        """(W,) bool straggler mask at ``deadline`` (default planned)."""
        return self.executor.finish_mask(generator, deadline)

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

        The torch twin of the reference's ``decode_logits_jit``: the worker
        mask gathers through the scatter map to a block-erasure mask and
        ``decode_systematic`` solves the static (kb, kb) system.
        """
        alive = finished_workers.to(torch.bool)[self.block_owner]
        nb, b, r = products.shape
        z, ok = decode_systematic(self.generator, products.reshape(nb, b * r), alive)
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
    """Paged continuous batching with an optional coded LM head."""

    def __init__(self, model: Model, cluster: ClusterSpec | None = None,
                 cfg: ServeConfig | None = None):
        self.model = model
        self.cfg = cfg or ServeConfig()
        self.device = model.device
        self.coded_head = (
            CodedLMHead(model.embed, cluster, block_rows=self.cfg.block_rows,
                        scheme=self.cfg.scheme,
                        deadline_safety=self.cfg.deadline_safety)
            if cluster is not None else None
        )

    def coded_select(self, logits: torch.Tensor, generator: torch.Generator,
                     deadline=None):
        """One coded round on a (B, V) logits batch, on the device.

        Pad-vocab sentinels are zeroed before the block mix (they would
        dominate the float32 solve) and re-masked after decode; when
        fewer than kb blocks survive, the round falls back to the plain
        logits with ``torch.where`` (no host branch). Returns
        (logits, ok, (W,) worker finish mask).
        """
        head = self.coded_head
        vocab = self.model.config.vocab_size
        lf = logits.float()
        keep = torch.arange(lf.shape[-1], device=lf.device)[None, :] < vocab
        products = head.encode_logits(torch.where(keep, lf, 0.0))
        mask = head.finish_mask(generator, deadline)
        dec, ok = head.decode_logits(products, mask)
        dec = torch.where(keep, dec[:, : lf.shape[-1]], NEG_INF)
        return torch.where(ok, dec, lf), ok, mask

    def _serve_step(self, cache, logits, pos, chunk, table, active, generator,
                    stats, *, steps):
        """One paged serve iteration: prefill chunk, then ``steps`` decodes.

        ``chunk`` is None or (tokens (S, C), start, lens, finishing): the
        slots finishing their prompt this round take the chunk's logits
        as pending logits and jump ``pos`` to the prompt length. Each
        decode step samples every slot's next token from its pending
        logits (one coded round across the batch) and advances the model;
        inactive slots write the sink and keep logits and pos.
        """
        if chunk is not None:
            tokens, start, lens, finishing = chunk
            plog, cache = self.model.prefill_paged(cache, tokens, start, lens, table)
            logits = torch.where(finishing[:, None], plog.float(), logits)
            pos = torch.where(finishing, start + lens, pos)
        toks = []
        for _ in range(steps):
            sel = logits
            if self.coded_head is not None:
                sel, ok, mask = self.coded_select(logits, generator)
                stats[0] += ok.to(torch.int64)
                stats[1] += (~mask.all()).to(torch.int64)
            tok = torch.argmax(sel, -1).to(torch.int32)
            nlog, cache = self.model.decode_step_paged(cache, tok, pos, table, active)
            logits = torch.where(active[:, None], nlog.float(), logits)
            pos = torch.where(active, pos + 1, pos)
            toks.append(tok)
        return cache, logits, pos, toks

    def serve(self, trace, *, slots: int = 4, prompt_cap: int | None = None,
              decode_block: int = 4, queue_cap: int = 64,
              admission_threshold: float = 1.0, telemetry=None, seed: int = 0,
              block_len: int | None = None,
              num_blocks: int | None = None,
              prefill_chunk: int | None = None) -> ServeReport:
        """Continuous batching: serve a request trace through S slots.

        The scheduler (host) decides placements; each round runs one
        prefill chunk for every slot still mid-prompt and a decode chunk
        of ``min(decode_block, min remaining)`` steps, so a slot frees
        the round its stream completes. Physical KV lives in a shared
        ``BlockPool``: full reservation at admission, freed at retirement.
        ``num_blocks=None`` sizes the pool so the trace never exhausts it.
        Finish masks draw from a ``torch.Generator`` seeded with ``seed``.
        Only paged serving is ported: there is no dense option yet.
        """
        set_full_fp32()
        trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
        if not trace:
            raise ValueError("serve needs a non-empty request trace")
        prompt_cap = int(prompt_cap if prompt_cap is not None
                         else max(r.prompt_len for r in trace))
        cfg, dev = self.cfg, self.device
        chunk = int(prefill_chunk if prefill_chunk is not None
                    else cfg.prefill_chunk if cfg.prefill_chunk is not None
                    else prompt_cap)
        bl = int(block_len if block_len is not None else cfg.block_len)
        nb = num_blocks if num_blocks is not None else cfg.num_blocks
        if nb is None:
            # dense-equivalent capacity: every slot can hold the largest request
            nb = slots * max(-(-(r.prompt_len + r.out_len + 1) // bl) for r in trace)
        nb = int(nb)
        cache = self.model.init_paged_cache(nb, bl)
        kv_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        metrics = MetricsRegistry()
        pool = BlockPool(nb, bl, bytes_per_block=kv_bytes // (nb + 1),
                         telemetry=telemetry, metrics=metrics)
        sched = SlotScheduler(
            slots, queue_cap=queue_cap, admission_threshold=admission_threshold,
            telemetry=telemetry, pool=pool, chunk=chunk, metrics=metrics,
        )
        generator = torch.Generator(device=dev).manual_seed(seed)
        vp = padded_vocab(self.model.config.vocab_size)
        logits = torch.zeros((slots, vp), dtype=torch.float32, device=dev)
        pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        stats = torch.zeros((2,), dtype=torch.int64, device=dev)  # ok, erased
        # host mirror of the block tables, width = pool size
        table_np = np.full((slots, nb), -1, np.int32)
        emitted = []  # (per-step token tensors, [(slot, rid)]) per dispatch

        now, i = 0.0, 0
        prefill_rounds = decode_rounds = 0
        t0 = time.perf_counter()
        while i < len(trace) or not sched.idle:
            while i < len(trace) and trace[i].arrival <= now + 1e-9:
                sched.offer(trace[i], now)
                i += 1
            for si, _req in sched.fill_slots(now):
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
                to_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
                step_chunk = (
                    (to_dev(chunk_np), to_dev(start_np), to_dev(lens_np), to_dev(fin_np))
                    if prefilling else None
                )
                owners = [(si, s.request.rid) for si, s in enumerate(sched.slots)
                          if active[si]]
                cache, logits, pos, toks = self._serve_step(
                    cache, logits, pos, step_chunk, to_dev(table_np),
                    to_dev(np.asarray(active)), generator, stats, steps=steps,
                )
                if toks:
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
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        streams: dict[int, list[int]] = {}
        for toks, owners in emitted:
            arr = torch.stack(toks).cpu().numpy()  # (steps, S)
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
