"""Runtime-distribution model of the paper (Section II-B).

Counterpart of ``repro/core/runtime_model.py``. A group-*j* worker
assigned ``l_j`` coded rows has round-trip time

    T = alpha_j * l_j / k + (l_j / (k * mu_j)) * Exp(1)        [model (1)]
    T = alpha_j * l_j     + (l_j / mu_j)       * Exp(1)        [model (30)]

plus, under ``COMM_DELAY``, per-worker transfer terms from the group's
link bandwidth (``comm_terms``). Planning math is float64 numpy; the
only torch code is ``sample_worker_times``, which draws the exponentials
from an explicit ``torch.Generator`` on that generator's device.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np
import scipy.special
import torch


class LatencyModel(enum.Enum):
    """Which shifted-exponential runtime model the math runs under."""

    MODEL_1 = "model_1"
    MODEL_30 = "model_30"
    COMM_DELAY = "comm_delay"

    @property
    def per_row(self) -> bool:
        """True iff this is the per-row model (30)."""
        return self is LatencyModel.MODEL_30

    @classmethod
    def from_per_row(cls, per_row: bool) -> "LatencyModel":
        return cls.MODEL_30 if per_row else cls.MODEL_1


def resolve_latency_model(
    model: "LatencyModel | str | None",
    per_row: bool | None = None,
    default: "LatencyModel | None" = LatencyModel.MODEL_1,
) -> "LatencyModel | None":
    """Collapse (model, legacy per_row flag) into one LatencyModel."""
    if model is not None:
        return model if isinstance(model, LatencyModel) else LatencyModel(model)
    if per_row is not None:
        return LatencyModel.from_per_row(per_row)
    return default


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One heterogeneous worker group."""

    num_workers: int  # N_j
    mu: float  # straggling (rate) parameter mu_(j)
    alpha: float = 1.0  # shift parameter alpha_(j)
    #: link bandwidth b_(j) for the CommDelay model; inf = free transfer
    bandwidth: float = float("inf")

    def __post_init__(self):
        if not self.bandwidth > 0:
            raise ValueError(
                f"GroupSpec bandwidth must be > 0, got {self.bandwidth!r}"
            )


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A heterogeneous cluster = a list of groups (paper Section II-A)."""

    groups: tuple[GroupSpec, ...]

    @classmethod
    def make(
        cls,
        num_workers: Sequence[int],
        mus: Sequence[float],
        alphas: Sequence[float] | float = 1.0,
        bandwidths: Sequence[float] | float = float("inf"),
    ) -> "ClusterSpec":
        if not hasattr(alphas, "__len__"):
            alphas = [float(alphas)] * len(num_workers)
        if not hasattr(bandwidths, "__len__"):
            bandwidths = [float(bandwidths)] * len(num_workers)
        if not len(num_workers) == len(mus) == len(alphas) == len(bandwidths):
            raise ValueError("per-group sequences must have equal lengths")
        return cls(
            tuple(
                GroupSpec(int(n), float(m), float(a), float(b))
                for n, m, a, b in zip(num_workers, mus, alphas, bandwidths)
            )
        )

    @classmethod
    def parse(
        cls, groups: str, default_bandwidth: float | None = None
    ) -> "ClusterSpec":
        """Group syntax: ``'6:2.0,6:0.5'`` or ``'6:2.0:8.0,6:0.5:1.0'``.

        Each comma-separated entry is ``N:mu`` or ``N:mu:bandwidth``;
        groups without a bandwidth get ``default_bandwidth`` (infinite
        when None).
        """
        fallback = float("inf") if default_bandwidth is None else float(
            default_bandwidth
        )
        if not fallback > 0:
            raise ValueError(
                f"default bandwidth must be > 0, got {default_bandwidth!r}"
            )
        ns, mus, bws = [], [], []
        for part in groups.split(","):
            fields = part.split(":")
            if len(fields) not in (2, 3):
                raise ValueError(
                    f"bad group {part!r}: expected N:mu or N:mu:bandwidth"
                )
            try:
                n = int(fields[0])
            except ValueError:
                raise ValueError(
                    f"bad group {part!r}: worker count {fields[0]!r} is not "
                    f"an integer"
                ) from None
            if n <= 0:
                raise ValueError(
                    f"bad group {part!r}: worker count must be a positive "
                    f"integer, got {n}"
                )
            try:
                mu = float(fields[1])
            except ValueError:
                raise ValueError(
                    f"bad group {part!r}: straggling parameter mu "
                    f"{fields[1]!r} is not a number"
                ) from None
            if not mu > 0:
                raise ValueError(
                    f"bad group {part!r}: straggling parameter mu must be "
                    f"> 0, got {mu}"
                )
            if len(fields) == 3:
                try:
                    bw = float(fields[2])
                except ValueError:
                    raise ValueError(
                        f"bad group {part!r}: bandwidth {fields[2]!r} is "
                        f"not a number"
                    ) from None
                if not bw > 0:
                    raise ValueError(
                        f"bad group {part!r}: bandwidth must be > 0, got "
                        f"{bw} (use inf or omit it for a free link)"
                    )
            else:
                bw = fallback
            ns.append(n)
            mus.append(mu)
            bws.append(bw)
        return cls.make(ns, mus, 1.0, bws)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def total_workers(self) -> int:
        return sum(g.num_workers for g in self.groups)

    def arrays(self):
        """(N_j, mu_j, alpha_j) as float64 numpy arrays."""
        n = np.asarray([g.num_workers for g in self.groups], np.float64)
        mu = np.asarray([g.mu for g in self.groups], np.float64)
        al = np.asarray([g.alpha for g in self.groups], np.float64)
        return n, mu, al

    def scale_mu(self, q: float) -> "ClusterSpec":
        """Scale every group's straggling parameter by q (the paper's Fig 2/5)."""
        return ClusterSpec(tuple(
            GroupSpec(g.num_workers, g.mu * q, g.alpha, g.bandwidth) for g in self.groups
        ))

    def with_bandwidths(self, bandwidths: Sequence[float] | float) -> "ClusterSpec":
        """Same cluster with per-group (or one shared) link bandwidths."""
        if not hasattr(bandwidths, "__len__"):
            bandwidths = [float(bandwidths)] * self.num_groups
        if len(bandwidths) != self.num_groups:
            raise ValueError(f"{len(bandwidths)} bandwidths for {self.num_groups} groups")
        return ClusterSpec(tuple(
            GroupSpec(g.num_workers, g.mu, g.alpha, float(b))
            for g, b in zip(self.groups, bandwidths)
        ))

    @property
    def bandwidths(self) -> np.ndarray:
        """Per-group link bandwidths b_(j) (inf = free)."""
        return np.asarray([g.bandwidth for g in self.groups], np.float64)


def harmonic(n):
    """H_n for real n >= 0 via digamma (exact for integer n)."""
    n = np.asarray(n, np.float64)
    return scipy.special.digamma(n + 1.0) + np.euler_gamma


def xi(r, n_workers, mu, alpha):
    """xi(r_j, N_j, mu_j) = alpha + log(N/(N-r))/mu  (paper eq. (9))."""
    return alpha + np.log(n_workers / (n_workers - r)) / mu


def expected_order_stat(
    load, r, n_workers, mu, alpha, k, *,
    per_row: bool | None = None,
    model: LatencyModel | None = None,
    exact_harmonic: bool = False,
):
    """lambda^{l}_{r:N} — expected r-th order statistic (paper eq. (6))."""
    model = resolve_latency_model(model, per_row)
    if exact_harmonic:
        tail = (harmonic(n_workers) - harmonic(n_workers - r)) / mu
    else:
        tail = np.log(n_workers / (n_workers - r)) / mu
    scale = load if model.per_row else load / k
    return scale * (alpha + tail)


def sample_worker_times(
    generator: torch.Generator,
    loads_per_worker,
    mus_per_worker,
    alphas_per_worker,
    k,
    num_trials: int,
    *,
    per_row: bool | None = None,
    model: LatencyModel | None = None,
    shift_per_worker=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sample (num_trials, N) round-trip times under model (1), (30) or comm.

    The exponentials come from ``generator`` on the generator's device;
    per-worker arrays may be numpy or tensors. ``shift_per_worker`` is
    the CommDelay fixed transfer shift (the caller folds the download
    term into the alphas, see ``comm_terms``).
    """
    model = resolve_latency_model(model, per_row)
    dev = generator.device
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    l, mu, al = as_t(loads_per_worker), as_t(mus_per_worker), as_t(alphas_per_worker)
    e = torch.empty((num_trials, l.shape[0]), dtype=dtype, device=dev)
    e.exponential_(generator=generator)
    if model.per_row:
        t = al * l + (l / mu) * e
    else:
        t = al * l / k + (l / (k * mu)) * e
    if shift_per_worker is not None:
        t = t + as_t(shift_per_worker)
    return t


def comm_terms(cluster: ClusterSpec, upload: float, download: float):
    """Per-group CommDelay transfer terms ``(c_j, dalpha_j)``.

    ``c_j = upload / b_j`` is the fixed input-broadcast shift;
    ``dalpha_j = download / b_j`` adds to the compute shift alpha_j.
    Infinite bandwidths contribute exactly zero.
    """
    if upload < 0 or download < 0:
        raise ValueError(
            f"comm costs must be >= 0, got upload={upload}, download={download}"
        )
    b = cluster.bandwidths
    inv_b = np.where(np.isinf(b), 0.0, 1.0 / b)
    return upload * inv_b, download * inv_b


def expand_groups(cluster: ClusterSpec, per_group_values: Sequence[float]):
    """Repeat per-group values to per-worker float64 arrays (length N)."""
    return np.concatenate([
        np.full((g.num_workers,), float(v))
        for g, v in zip(cluster.groups, per_group_values)
    ])
