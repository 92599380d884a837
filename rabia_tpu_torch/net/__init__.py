"""Transports: the in-memory hub and the fault-injecting simulator, both
behind :class:`rabia_tpu_torch.core.network.NetworkTransport`. The
reference's TCP transport (``rabia_tpu/net/tcp.py``) is not ported yet
(ROADMAP Queue 1 item 7.3).
"""

from rabia_tpu_torch.net.in_memory import HubStats, InMemoryHub, InMemoryNetwork
from rabia_tpu_torch.net.simulator import (
    NetworkConditions,
    NetworkSimulator,
    NetworkStats,
    SimulatedNetwork,
)

__all__ = [
    "HubStats",
    "InMemoryHub",
    "InMemoryNetwork",
    "NetworkConditions",
    "NetworkSimulator",
    "NetworkStats",
    "SimulatedNetwork",
]
