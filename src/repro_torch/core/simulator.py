"""Monte-Carlo latency simulator (paper Section IV).

Counterpart of ``repro/core/simulator.py``. The master sends x to all N
workers; worker i finishes its ``l_i``-row subtask at a random
shifted-exponential time, and the master completes at the first instant
the finished workers jointly cover ``k`` coded rows: sample a (trials, N)
time matrix, sort each row, cumulative-sum the loads in finish order,
take the time of the first crossing of ``k`` (``simulate_threshold``;
``simulate_comm_threshold`` adds the CommDelay transfer terms). The group
code of [33] has its own semantics (``simulate_group_code``: the max over
groups of the r_j-th order statistic). ``expected_latency`` dispatches
through the plan's scheme object. Every sample draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.runtime_model import (
    ClusterSpec,
    LatencyModel,
    comm_terms,
    expand_groups,
    resolve_latency_model,
    sample_worker_times,
)


def _threshold_latency(times: torch.Tensor, loads_w, k: int) -> torch.Tensor:
    """First time the finished workers cover k rows, per trial (inf if never)."""
    sorted_times, order = torch.sort(times, dim=1)
    loads_t = torch.as_tensor(loads_w, dtype=times.dtype, device=times.device)
    covered = torch.cumsum(loads_t[order], dim=1)
    done = covered >= k - 1e-6
    idx = torch.argmax(done.to(torch.int8), dim=1)
    lat = torch.gather(sorted_times, 1, idx[:, None])[:, 0]
    return torch.where(done.any(dim=1), lat, torch.full_like(lat, float("inf")))


def simulate_threshold(
    generator: torch.Generator,
    cluster: ClusterSpec,
    loads_per_group,
    k: int,
    num_trials: int = 10_000,
    *,
    per_row: bool | None = None,
    model: LatencyModel | None = None,
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """(num_trials,) latency samples for 'collect until k coded rows'.

    Infeasible plans (total coded rows < k) give ``inf``.
    """
    model = resolve_latency_model(model, per_row)
    loads_w = expand_groups(cluster, loads_per_group)
    times = sample_worker_times(
        generator,
        loads_w,
        expand_groups(cluster, [g.mu for g in cluster.groups]),
        expand_groups(cluster, [g.alpha for g in cluster.groups]),
        k,
        num_trials,
        model=model,
        dtype=dtype,
    )
    return _threshold_latency(times, loads_w, k)


def simulate_comm_threshold(
    generator: torch.Generator,
    cluster: ClusterSpec,
    loads_per_group,
    k: int,
    num_trials: int = 10_000,
    *,
    upload: float = 1.0,
    download: float = 1.0,
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """(num_trials,) latency samples under the CommDelay model.

    Completion time = compute + transfer: the shift ``upload/b_j`` is
    added per worker and ``download/b_j`` is folded into ``alpha_j``
    (``comm_terms``); the master still collects until k coded rows.
    Zero-load workers finish at their shift and cover nothing.
    """
    shift_g, dalpha_g = comm_terms(cluster, upload, download)
    loads_w = expand_groups(cluster, loads_per_group)
    times = sample_worker_times(
        generator,
        loads_w,
        expand_groups(cluster, [g.mu for g in cluster.groups]),
        expand_groups(cluster, [g.alpha + d for g, d in zip(cluster.groups, dalpha_g)]),
        k,
        num_trials,
        model=LatencyModel.COMM_DELAY,
        shift_per_worker=expand_groups(cluster, shift_g),
        dtype=dtype,
    )
    return _threshold_latency(times, loads_w, k)


def simulate_group_code(
    generator: torch.Generator,
    cluster: ClusterSpec,
    load: float,
    r_split,
    k: int,
    num_trials: int = 10_000,
    *,
    per_row: bool | None = None,
    model: LatencyModel | None = None,
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """(num_trials,) latency samples of the group code of [33].

    Group j runs an (N_j, r_j) MDS code over uniform loads; the master
    decodes every group, so the latency is the max over groups of the
    r_j-th order statistic (r_j = ceil of the split, clamped to [1, N_j]).
    Groups are padded to the widest with +inf times, which sort last.
    """
    model = resolve_latency_model(model, per_row)
    nmax = max(g.num_workers for g in cluster.groups)
    dev = generator.device
    valid = torch.zeros((cluster.num_groups, nmax), dtype=torch.bool, device=dev)
    r_idx = torch.zeros((cluster.num_groups,), dtype=torch.int64, device=dev)
    for j, g in enumerate(cluster.groups):
        valid[j, : g.num_workers] = True
        r_j = int(np.ceil(r_split[j] - 1e-9))
        r_idx[j] = max(1, min(r_j, g.num_workers)) - 1
    mus = torch.tensor([g.mu for g in cluster.groups], dtype=dtype, device=dev)[:, None]
    alphas = torch.tensor([g.alpha for g in cluster.groups], dtype=dtype, device=dev)[:, None]
    e = torch.empty((num_trials, cluster.num_groups, nmax), dtype=dtype, device=dev)
    e.exponential_(generator=generator)
    scale = load if model.per_row else load / k
    t = scale * (alphas + e / mus)
    t = torch.where(valid, t, torch.full_like(t, float("inf")))
    t = torch.sort(t, dim=2).values
    idx = r_idx[None, :, None].expand(num_trials, -1, 1)
    return torch.gather(t, 2, idx)[:, :, 0].amax(dim=1)


def expected_latency(
    generator: torch.Generator,
    cluster: ClusterSpec,
    plan,
    num_trials: int = 10_000,
    *,
    per_row: bool | None = None,
    model: LatencyModel | None = None,
    use_integer_loads: bool = False,
) -> float:
    """Mean Monte-Carlo latency of an ``AllocationPlan`` under ``cluster``.

    The semantics come from the plan's scheme object (threshold decoding
    by default; the group code's order statistics for ``uniform_r``); the
    latency model is the scheme's own unless ``model``/``per_row`` say
    otherwise.
    """
    from repro_torch.core.schemes import scheme_for_plan  # schemes imports us

    lat = scheme_for_plan(plan).simulate(
        generator, cluster, plan, num_trials,
        model=resolve_latency_model(model, per_row, default=None),
        use_integer_loads=use_integer_loads,
    )
    return float(torch.mean(lat))
