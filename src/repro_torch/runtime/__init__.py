"""Coded round executor, the serving and training loops, the controllers
(counterpart of ``repro/runtime``; the same names). ``make_train_step``,
the reference's jitted step, is ``train_loop.make_train_step_fn``: nothing
is compiled here."""
from repro_torch.runtime.control import (
    AdaptConfig,
    AdaptiveController,
    Decision,
    coverage_latency,
    replan_decision,
)
from repro_torch.runtime.executor import CodedRoundExecutor
from repro_torch.runtime.fault_tolerance import ElasticController, StragglerTracker
from repro_torch.runtime.serve_loop import CodedLMHead, ServeConfig, Server
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.timing import RoundClock, RoundTiming
from repro_torch.runtime.train_loop import (
    TrainConfig,
    Trainer,
    make_coded_train_step_fn,
    make_train_step_fn as make_train_step,
)

__all__ = [
    "AdaptConfig",
    "AdaptiveController",
    "CodedLMHead",
    "CodedRoundExecutor",
    "Decision",
    "ElasticController",
    "RoundClock",
    "RoundTiming",
    "ServeConfig",
    "Server",
    "StragglerTracker",
    "Telemetry",
    "TrainConfig",
    "Trainer",
    "coverage_latency",
    "make_coded_train_step_fn",
    "make_train_step",
    "replan_decision",
]
