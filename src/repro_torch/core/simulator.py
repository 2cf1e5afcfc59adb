"""Monte-Carlo latency simulator (paper Section IV), threshold semantics.

Counterpart of ``repro/core/simulator.py:simulate_threshold``. The master
sends x to all N workers; worker i finishes its ``l_i``-row subtask at a
random shifted-exponential time, and the master completes at the first
instant the finished workers jointly cover ``k`` coded rows: sample a
(trials, N) time matrix, sort each row, cumulative-sum the loads in
finish order, take the time of the first crossing of ``k``.
"""
from __future__ import annotations

import torch

from repro_torch.core.runtime_model import (
    ClusterSpec,
    LatencyModel,
    expand_groups,
    resolve_latency_model,
    sample_worker_times,
)


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
    sorted_times, order = torch.sort(times, dim=1)
    loads_t = torch.as_tensor(loads_w, dtype=dtype, device=times.device)
    covered = torch.cumsum(loads_t[order], dim=1)
    done = covered >= k - 1e-6
    idx = torch.argmax(done.to(torch.int8), dim=1)
    lat = torch.gather(sorted_times, 1, idx[:, None])[:, 0]
    return torch.where(done.any(dim=1), lat, torch.full_like(lat, float("inf")))
