"""Continuous-batching front-end: request workloads and the slot scheduler
(counterpart of ``repro/serve``; the same names)."""
from repro_torch.serve.workload import (  # noqa: F401
    CLASS_PRIORITY,
    DEADLINE_SLACK,
    Request,
    WorkloadSpec,
    make_workload,
    register_workload,
    workload_names,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    BlockPool,
    FinishedRequest,
    SlotScheduler,
    SlotState,
)
