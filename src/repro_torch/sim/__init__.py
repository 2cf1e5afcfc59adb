"""Cluster-dynamics scenario subsystem: the port's copy of ``repro/sim``.

Pure numpy, as in the reference, so one seed gives the same trace in
both packages. Generates the non-stationary conditions — straggler drift, worker churn,
bandwidth collapse, correlated rack incidents — that the closed-loop
adaptive controller (``repro_torch.runtime.control``) must survive. Scenarios
are seeded and deterministic; the registry mirrors the allocation-scheme
registry.
"""
from repro_torch.sim.events import (
    BadRack,
    BandwidthFade,
    Event,
    MuRandomWalk,
    MuStep,
    TraceState,
    WorkerChurn,
)
from repro_torch.sim.scenario import (
    ClusterTrace,
    ScenarioSpec,
    make_scenario,
    register_scenario,
    scenario_kinds,
    scenario_names,
)

__all__ = [
    "BadRack",
    "BandwidthFade",
    "ClusterTrace",
    "Event",
    "MuRandomWalk",
    "MuStep",
    "ScenarioSpec",
    "TraceState",
    "WorkerChurn",
    "make_scenario",
    "register_scenario",
    "scenario_kinds",
    "scenario_names",
]
