"""Transports: the in-memory hub, the fault-injecting simulator and the
TCP transport over the C++ data plane (:mod:`rabia_tpu_torch.net.tcp`),
all behind :class:`rabia_tpu_torch.core.network.NetworkTransport`.
"""

from rabia_tpu_torch.net.in_memory import HubStats, InMemoryHub, InMemoryNetwork
from rabia_tpu_torch.net.simulator import (
    NetworkConditions,
    NetworkSimulator,
    NetworkStats,
    SimulatedNetwork,
)
from rabia_tpu_torch.net.tcp import TcpNetwork

__all__ = [
    "HubStats",
    "InMemoryHub",
    "InMemoryNetwork",
    "NetworkConditions",
    "NetworkSimulator",
    "NetworkStats",
    "SimulatedNetwork",
    "TcpNetwork",
]
