"""CodedComputeEngine: cluster -> scheme -> deployment plan -> generator.

Counterpart of ``repro/core/engine.py``. The per-round deadline policy
``plan_deadline`` is shared with the round executor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import planner
from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.coding import make_generator
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.core.schemes import AllocationScheme, make_scheme, scheme_for_plan


def plan_deadline(
    plan: planner.DeploymentPlan,
    safety: float = 3.0,
    *,
    generator: torch.Generator | None = None,
    num_trials: int = 2_048,
) -> float:
    """Per-round cutoff: expected latency x safety, always finite.

    The analytic T* when the scheme has one, else the scheme's own
    Monte-Carlo estimate drawn from ``generator`` (CPU, seed 0 default).
    """
    t = float(plan.t_star)
    if not np.isfinite(t) or t <= 0:
        scheme = scheme_for_plan(plan)
        alloc = plan.allocation
        if alloc is None:
            alloc = scheme.allocate(plan.cluster, plan.k)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        t = scheme.expected_latency(generator, plan.cluster, alloc, num_trials)
    return t * safety


class CodedComputeEngine:
    """One coded workload: its scheme, deployed plan and generator."""

    def __init__(
        self,
        cluster: ClusterSpec,
        k: int,
        scheme: str | AllocationScheme = "optimal",
        *,
        scheme_params: dict | None = None,
    ):
        if not isinstance(scheme, AllocationScheme):
            scheme = make_scheme(scheme, **(scheme_params or {}))
        elif scheme_params:
            raise ValueError("scheme_params only apply to string scheme names")
        self.scheme = scheme
        self.k = int(k)
        self.cluster = cluster
        self.plan: planner.DeploymentPlan = planner.deploy(scheme, cluster, self.k)

    @property
    def allocation(self) -> AllocationPlan:
        """The underlying real-valued per-group allocation."""
        return self.plan.allocation

    @property
    def t_star(self) -> float:
        return float(self.plan.t_star)

    def generator(self, *, g: np.ndarray | None = None,
                  device: str | torch.device = "cuda") -> torch.Tensor:
        """(n, k) MDS generator sized to the deployed plan (seed 0, or ``g``)."""
        return make_generator(self.plan.n, self.k, g=g, device=device)
