"""Host consensus engine: event loop, leader info, runtime state.

The port of the reference's ``rabia_tpu/engine`` on its Python paths (the
Python tick and the asyncio orchestration); its per-replica weak-MVC step
is :class:`rabia_tpu_torch.kernel.host_driver.HostNodeKernel`.
"""

from rabia_tpu_torch.engine.engine import RabiaEngine
from rabia_tpu_torch.engine.leader import LeaderSelector, LeadershipInfo, slot_proposer
from rabia_tpu_torch.engine.state import (
    EngineRuntime,
    EngineStatistics,
    PendingSubmission,
    ShardRuntime,
    SlotRecord,
)

__all__ = [
    "RabiaEngine",
    "LeaderSelector",
    "LeadershipInfo",
    "slot_proposer",
    "EngineRuntime",
    "EngineStatistics",
    "PendingSubmission",
    "ShardRuntime",
    "SlotRecord",
]
