"""RoundClock: wall-clock round timing for the measured loop.

Counterpart of ``repro/runtime/timing.py``. ``observe_truth`` feeds the
``AdaptiveController`` simulated round times; ``RoundClock`` feeds it
what the device did:

* **measure** — each dispatch (a coded train step, a serve chunk, a
  ``generate``) runs between two ``perf_counter`` reads, the second after
  ``torch.cuda.synchronize`` of the executor's device when that is a CUDA
  device. ``dispatch_s`` is thus the wall time from the dispatch call
  until the device is done: host-paced gaps between launches included,
  which a pair of CUDA events would miss;
* **decompose** — one wall time cannot feed a per-group MLE, so the
  clock splits it with the executor's own draw of per-worker times
  (``CodedRoundExecutor.round_observation``): worker ``w`` gets
  ``v_w * dispatch_s / max(v)``. ``generator`` must be in the state the
  round's finish mask was drawn from (clone it just before that draw),
  so the split is the draw that gated the round. The round total (and
  any pad, below) is measured; the per-worker split is derived;
* **calibrate** — the first fed round pins ``unit_s`` (wall seconds per
  virtual-time unit) and every observation is reported in those units
  (``scale = (dispatch_s / max(v)) / unit_s``): a fixed change of units,
  so plans, deadlines and scenario truth stay commensurate and a 2x
  slower round is a 2x observation;
* **guard rails** — the first ``warmup`` rounds are timed but not fed
  (kernel builds and allocator growth), ``discard_next`` flags a known
  rebuild (after a structural replan), and a dispatch slower than
  ``outlier_factor`` times the smoothed round is dropped; every round,
  fed or not, is a ``round_timing`` telemetry event;
* **pad injection** — ``pad_s`` (per-worker seconds) really sleeps
  ``max(pad_s)`` inside the measured window and gives each worker its
  share of the measured sleep: the single-process stand-in for
  per-worker timestamps, and the fault injector of the measured
  adaptation checks.

For CommDelay schemes the per-worker upload shifts are scaled by the
same factor and handed on as measured transfer shares. Feed the result
to ``AdaptiveController.observe_timing`` (or read ``.times``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.runtime_model import ClusterSpec, LatencyModel


@dataclasses.dataclass
class RoundTiming:
    """One measured round: wall-clock facts and the derived split.

    ``times`` is None when the round was measured but not fed (warmup,
    outlier, flagged rebuild: see ``skipped``); ``observe_timing`` treats
    that as a no-op, so callers may feed every timing.
    """

    round: int
    result: Any  # the dispatch's own return value (the device is done with it)
    wall_s: float  # measured: dispatch + injected pad
    dispatch_s: float  # measured: dispatch until the device is done
    pad_wall_s: float  # measured: the injected sleep actually slept
    scale: float  # this round's common factor, in calibrated units
    times: np.ndarray | None  # (W,) derived per-worker round times
    transfer_times: np.ndarray | None  # (W,) derived upload shares (comm)
    payload: float  # bandwidth-MLE payload matching transfer_times
    membership: tuple[int, ...] | None  # registration counts (truth feed)
    skipped: str | None  # None = fed; "warmup" | "outlier" | custom


class RoundClock:
    """Measured round times for one executor's dispatches.

    One clock per control loop: it owns the unit calibration and the
    outlier state. ``pad_s`` may be set (or reset) between rounds.
    """

    def __init__(self, executor, *, telemetry=None,
                 pad_s: Sequence[float] | np.ndarray | None = None, warmup: int = 1,
                 outlier_factor: float = 50.0, smooth: float = 0.7):
        if warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {warmup}")
        if outlier_factor <= 1:
            raise ValueError(f"outlier_factor must be > 1, got {outlier_factor}")
        if not 0 <= smooth < 1:
            raise ValueError(f"smooth must be in [0, 1), got {smooth}")
        self.executor = executor
        self.telemetry = telemetry
        self.pad_s = pad_s
        self.warmup = int(warmup)
        self.outlier_factor = float(outlier_factor)
        self.smooth = float(smooth)
        #: wall seconds per virtual-time unit, pinned on the first fed round
        self.unit_s: float | None = None
        self.rounds = 0  # measured rounds (fed or not)
        self.fed = 0  # rounds that produced an observation
        self._smoothed: float | None = None  # EMA of non-outlier dispatches
        self._discard: str | None = None

    @property
    def smoothed_s(self) -> float | None:
        """The smoothed dispatch seconds of the rounds fed so far (the
        outlier guard's yardstick)."""
        return self._smoothed

    def discard_next(self, reason: str = "recompile") -> None:
        """Flag the next dispatch as not an observation (after a structural
        replan its wall includes rebuilding, not only the round)."""
        self._discard = reason

    def _sync(self) -> None:
        """Wait for the executor's device when it is a CUDA device."""
        device = torch.device(self.executor.device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def measure(self, dispatch: Callable[[], Any], *, generator: torch.Generator,
                true_cluster: ClusterSpec | None = None) -> RoundTiming:
        """Run one dispatch under the clock and decompose it.

        ``generator`` is in the state the round's finish mask was drawn
        from; ``true_cluster`` is the scenario's truth when one is
        injected (leavers decompose to ``inf``).
        """
        pad = None if self.pad_s is None else np.asarray(self.pad_s, float)
        t0 = time.perf_counter()
        result = dispatch()
        self._sync()
        t1 = time.perf_counter()
        dispatch_s = t1 - t0
        pad_wall = 0.0
        pad_share = None
        if pad is not None and float(pad.max()) > 0:
            # padded workers run concurrently: the slowest pad gates the
            # round, each worker gets its share of the sleep measured
            time.sleep(float(pad.max()))
            pad_wall = time.perf_counter() - t1
            pad_share = pad / float(pad.max()) * pad_wall
        wall = time.perf_counter() - t0
        self.rounds += 1

        skipped = None
        if self._discard is not None:
            skipped, self._discard = self._discard, None
        elif self.rounds <= self.warmup:
            skipped = "warmup"
        elif self._smoothed is not None and dispatch_s > self.outlier_factor * self._smoothed:
            skipped = "outlier"
        if skipped is None:
            self._smoothed = (dispatch_s if self._smoothed is None
                              else self.smooth * self._smoothed
                              + (1 - self.smooth) * dispatch_s)

        times = transfer = None
        scale = float("nan")
        payload = 1.0
        membership = (tuple(g.num_workers for g in true_cluster.groups)
                      if true_cluster is not None else None)
        if skipped is None:
            times, transfer, payload, scale = self._decompose(
                generator, true_cluster, dispatch_s, pad_share)
            self.fed += 1
        timing = RoundTiming(round=self.rounds, result=result, wall_s=wall,
                             dispatch_s=dispatch_s, pad_wall_s=pad_wall, scale=scale,
                             times=times, transfer_times=transfer, payload=payload,
                             membership=membership, skipped=skipped)
        self._emit(timing)
        return timing

    def _decompose(self, generator, true_cluster, dispatch_s, pad_share):
        """(W,) per-worker observation of one measured dispatch."""
        v, shifts = self.executor.round_observation(generator, true_cluster)
        v = np.asarray(v, np.float64)
        finite = np.isfinite(v)
        if not finite.any():
            # every planned worker has left: an all-miss observation (the
            # tracker's failure detection needs the infs), no new scale
            return np.full(v.shape, np.inf), None, 1.0, float("nan")
        sec_per_v = dispatch_s / float(v[finite].max())
        if self.unit_s is None:
            self.unit_s = sec_per_v  # calibration: this round reads 1.0
        scale = sec_per_v / self.unit_s
        times = np.where(finite, v * scale, np.inf)
        if pad_share is not None:
            times = np.where(finite, times + pad_share / self.unit_s, times)
        transfer, payload = None, 1.0
        sch = self.executor.scheme
        if sch.latency_model is LatencyModel.COMM_DELAY and getattr(sch, "upload", 0.0) > 0:
            shifts = np.asarray(shifts, np.float64)
            transfer = np.where(np.isfinite(shifts), shifts * scale, np.inf)
            payload = float(sch.upload)
        return times, transfer, payload, scale

    def _emit(self, t: RoundTiming) -> None:
        if self.telemetry is None:
            return
        finite = t.times[np.isfinite(t.times)] if t.times is not None else None
        self.telemetry.event(
            "round_timing",
            round=t.round,
            wall_s=float(t.wall_s),
            dispatch_s=float(t.dispatch_s),
            pad_wall_s=float(t.pad_wall_s),
            # NaN (skipped rounds) is not valid strict JSON -> null
            scale=float(t.scale) if np.isfinite(t.scale) else None,
            unit_s=float(self.unit_s) if self.unit_s is not None else None,
            workers=int(self.executor.num_workers),
            fed=t.skipped is None,
            skipped=t.skipped,
            t_max=float(finite.max()) if finite is not None and finite.size else None,
            t_mean=float(finite.mean()) if finite is not None and finite.size else None,
        )
