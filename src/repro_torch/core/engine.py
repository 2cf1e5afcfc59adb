"""CodedComputeEngine: cluster -> scheme -> deployment plan -> generator.

Counterpart of ``repro/core/engine.py``: the deployed plan, its
generator, Monte-Carlo latency under the scheme's own semantics, the
per-round deadline and the elastic ``replan`` (scheme parameters ride on
the typed scheme object). ``plan_deadline`` is shared with the round
executor and the fault-tolerance layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import planner
from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.coding import make_generator
from repro_torch.core.runtime_model import ClusterSpec, LatencyModel
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
        self.replans = 0
        self._plan_for(cluster)

    def _plan_for(self, cluster: ClusterSpec) -> None:
        self.cluster = cluster
        self.plan: planner.DeploymentPlan = planner.deploy(self.scheme, cluster, self.k)

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

    def simulate(self, generator: torch.Generator, num_trials: int = 10_000, *,
                 model: LatencyModel | None = None,
                 use_integer_loads: bool = False) -> torch.Tensor:
        """Monte-Carlo latency samples under the scheme's own semantics."""
        return self.scheme.simulate(generator, self.cluster, self.allocation, num_trials,
                                    model=model, use_integer_loads=use_integer_loads)

    def expected_latency(self, generator: torch.Generator, num_trials: int = 10_000,
                         **kwargs) -> float:
        return float(torch.mean(self.simulate(generator, num_trials, **kwargs)))

    def deadline(self, safety: float = 3.0, *, generator: torch.Generator | None = None,
                 num_trials: int = 2_048) -> float:
        """Per-round cutoff: expected latency x safety (``plan_deadline``)."""
        return plan_deadline(self.plan, safety, generator=generator,
                             num_trials=num_trials)

    def replan(self, new_cluster: ClusterSpec) -> planner.DeploymentPlan:
        """Re-plan on a membership or estimate change; scheme params preserved."""
        self._plan_for(new_cluster)
        self.replans += 1
        return self.plan
