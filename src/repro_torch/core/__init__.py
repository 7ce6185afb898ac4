"""The EdgeAI-Hub core of the port (PyTorch port of ``repro.core``): the
performance model, network, trust zones, device registry, placement,
scheduler, orchestrator, split computing, early exit, shared context and
the hub facade."""
from repro_torch.core import (
    context,
    earlyexit,
    network,
    orchestrator,
    perf_model,
    placement,
    resource,
    scheduler,
    split,
    trustzones,
)
from repro_torch.core.hub import EdgeAIHub, default_home
from repro_torch.core.orchestrator import Orchestrator, TaskSpec
from repro_torch.core.scheduler import AITask, EdgeScheduler

__all__ = [
    "AITask", "EdgeAIHub", "EdgeScheduler", "Orchestrator", "TaskSpec",
    "context", "default_home", "earlyexit", "network", "orchestrator",
    "perf_model", "placement", "resource", "scheduler", "split",
    "trustzones",
]
