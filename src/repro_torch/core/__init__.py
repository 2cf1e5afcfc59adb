"""Core: optimal load allocation for coded distributed computation in
heterogeneous clusters (counterpart of ``repro/core``; the same names).

* ``runtime_model`` — the shifted-exponential runtime models
  (``LatencyModel``), ``ClusterSpec`` and order-statistic closed forms;
* ``allocation`` — the paper's allocation math as pure functions
  returning ``AllocationPlan``;
* ``schemes`` — every allocation policy as a registered
  ``AllocationScheme``;
* ``planner`` — an ``AllocationPlan`` integerized into a per-worker
  ``DeploymentPlan``;
* ``engine`` — ``CodedComputeEngine``: cluster -> plan -> generator ->
  simulate / deadline -> replan;
* ``simulator``, ``coding``, ``coded_matvec``, ``lambertw`` — Monte-Carlo
  latency, real-valued MDS codes, the end-to-end coded matvec and the
  Lambert-W branch used by Theorem 2.
"""
from repro_torch.core.allocation import (
    AllocationPlan,
    comm_aware_allocation,
    comm_t_star,
    comm_uniform_allocation,
    gradient_coding_allocation,
    optimal_allocation,
    optimal_r,
    reisizadeh_allocation,
    t_star,
    uncoded,
    uniform_given_n,
    uniform_given_r,
    xi_star,
)
from repro_torch.core.engine import CodedComputeEngine
from repro_torch.core.lambertw import lambertw0, lambertwm1
from repro_torch.core.planner import (
    DeploymentPlan,
    deploy,
    plan_deployment,
    replan_on_membership_change,
)
from repro_torch.core.runtime_model import (
    ClusterSpec,
    GroupSpec,
    LatencyModel,
    expected_order_stat,
    xi,
)
from repro_torch.core.schemes import (
    AllocationScheme,
    CommAware,
    CommUniform,
    GradCoding,
    Optimal,
    Reisizadeh,
    Uncoded,
    UniformN,
    UniformR,
    make_scheme,
    register_scheme,
    scheme_for_plan,
    scheme_names,
    scheme_params,
)

__all__ = [
    "AllocationPlan",
    "AllocationScheme",
    "ClusterSpec",
    "CodedComputeEngine",
    "CommAware",
    "CommUniform",
    "DeploymentPlan",
    "GradCoding",
    "GroupSpec",
    "LatencyModel",
    "Optimal",
    "Reisizadeh",
    "Uncoded",
    "UniformN",
    "UniformR",
    "comm_aware_allocation",
    "comm_t_star",
    "comm_uniform_allocation",
    "deploy",
    "expected_order_stat",
    "gradient_coding_allocation",
    "lambertw0",
    "lambertwm1",
    "make_scheme",
    "optimal_allocation",
    "optimal_r",
    "plan_deployment",
    "register_scheme",
    "reisizadeh_allocation",
    "replan_on_membership_change",
    "scheme_for_plan",
    "scheme_names",
    "scheme_params",
    "t_star",
    "uncoded",
    "uniform_given_n",
    "uniform_given_r",
    "xi",
    "xi_star",
]
