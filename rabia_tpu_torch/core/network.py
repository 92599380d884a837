"""Cluster view, transport trait and connectivity monitoring.

Reference parity: rabia-core/src/network.rs — ``ClusterConfig`` with
majority quorum (:6-34, quorum formula :15), the ``NetworkTransport`` trait
(:36-51), ``NetworkEventHandler`` (:53-64), ``NetworkMonitor`` diffing node
sets into events (:66-129) and ``NetworkEvent`` (:131-138).

This ABC is the seam between the consensus engine and both communication
planes (SURVEY.md §5.8): in-process transports (tests/simulation), the C++
TCP data plane (production host networking), and — for replicas mapped onto
a TPU mesh axis — the collective plane, where "broadcast votes" degenerates
to an ``all_gather`` and no transport object is involved at all.
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass, field
from typing import Optional

from rabia_tpu_torch.core.types import NodeId, quorum_size, sorted_nodes


@dataclass(frozen=True)
class ClusterConfig:
    """Static cluster membership view (network.rs:6-34)."""

    node_id: NodeId
    all_nodes: tuple[NodeId, ...]

    @staticmethod
    def new(node_id: NodeId, nodes) -> "ClusterConfig":
        ns = tuple(sorted_nodes(set(nodes) | {node_id}))
        return ClusterConfig(node_id=node_id, all_nodes=ns)

    @property
    def total_nodes(self) -> int:
        return len(self.all_nodes)

    @property
    def quorum_size(self) -> int:
        return quorum_size(self.total_nodes)

    def other_nodes(self) -> tuple[NodeId, ...]:
        return tuple(n for n in self.all_nodes if n != self.node_id)

    def has_quorum(self, active: set[NodeId]) -> bool:
        return len(active & set(self.all_nodes)) >= self.quorum_size

    def replica_index(self, node: NodeId) -> int:
        """Stable row index of ``node`` in device vote matrices."""
        return self.all_nodes.index(node)


class NetworkTransport(abc.ABC):
    """Message plane trait (network.rs:36-51). All methods are async."""

    @abc.abstractmethod
    async def send_to(self, target: NodeId, data: bytes) -> None:
        ...

    @abc.abstractmethod
    async def broadcast(self, data: bytes) -> None:
        """Deliver to every connected peer (excluding self)."""

    def send_to_nowait(self, target: NodeId, data: bytes) -> bool:
        """Optional synchronous non-blocking send. Returns True when the
        transport completed (or best-effort dropped) the send inline;
        False when it has no sync path — the caller awaits ``send_to``.
        Transports whose sends complete without suspending (the in-memory
        hub, the native TCP library's lock-free enqueue) override this so
        the engine's hot loop avoids one task spawn per outbound frame."""
        return False

    def broadcast_nowait(self, data: bytes) -> bool:
        """Synchronous twin of ``broadcast`` (see ``send_to_nowait``)."""
        return False

    @abc.abstractmethod
    async def receive(self, timeout: Optional[float] = None) -> tuple[NodeId, bytes]:
        """Next inbound (sender, payload); raises TimeoutError_ on timeout."""

    @abc.abstractmethod
    async def get_connected_nodes(self) -> set[NodeId]:
        ...

    async def is_connected(self, node: NodeId) -> bool:
        return node in await self.get_connected_nodes()

    @abc.abstractmethod
    async def disconnect(self, node: NodeId) -> None:
        ...

    @abc.abstractmethod
    async def reconnect(self) -> None:
        """Re-establish connectivity to all configured peers."""

    async def close(self) -> None:
        """Tear down the transport (default no-op)."""

    def set_receive_notify(self, callback) -> bool:
        """Register a zero-arg callback invoked on the event-loop thread
        whenever inbound data becomes available, enabling wake-on-inbox
        engine loops instead of fixed-tick polling (the reference's
        select!-style loop, engine.rs:193-235). Returns True if the
        transport supports push notification; False (the default) means
        the caller must poll ``receive_nowait``/``receive``."""
        return False


class NetworkEvent(enum.Enum):
    """Connectivity transitions (network.rs:131-138)."""

    NodeConnected = "node_connected"
    NodeDisconnected = "node_disconnected"
    PartitionDetected = "partition_detected"
    QuorumLost = "quorum_lost"
    QuorumRestored = "quorum_restored"


class NetworkEventHandler(abc.ABC):
    """Receiver of connectivity events (network.rs:53-64)."""

    async def on_node_connected(self, node: NodeId) -> None: ...

    async def on_node_disconnected(self, node: NodeId) -> None: ...

    async def on_partition_detected(self, reachable: set[NodeId]) -> None: ...

    async def on_quorum_lost(self) -> None: ...

    async def on_quorum_restored(self) -> None: ...


@dataclass
class NetworkMonitor:
    """Diffs successive connectivity views into events (network.rs:66-129)."""

    cluster: ClusterConfig
    handler: Optional[NetworkEventHandler] = None
    _last_connected: set[NodeId] = field(default_factory=set)
    _had_quorum: Optional[bool] = None

    async def observe(self, connected: set[NodeId]) -> list[tuple[NetworkEvent, object]]:
        """Feed the current connected-peer set; fires handler callbacks and
        returns the event list (for callers without a handler)."""
        events: list[tuple[NetworkEvent, object]] = []
        connected = set(connected)
        appeared = connected - self._last_connected
        vanished = self._last_connected - connected

        for n in sorted_nodes(appeared):
            events.append((NetworkEvent.NodeConnected, n))
            if self.handler:
                await self.handler.on_node_connected(n)
        for n in sorted_nodes(vanished):
            events.append((NetworkEvent.NodeDisconnected, n))
            if self.handler:
                await self.handler.on_node_disconnected(n)

        # quorum accounting counts self as active
        active = connected | {self.cluster.node_id}
        has_q = self.cluster.has_quorum(active)
        if vanished and not has_q:
            events.append((NetworkEvent.PartitionDetected, active))
            if self.handler:
                await self.handler.on_partition_detected(active)
        if self._had_quorum is None:
            self._had_quorum = has_q
        elif has_q != self._had_quorum:
            self._had_quorum = has_q
            if has_q:
                events.append((NetworkEvent.QuorumRestored, None))
                if self.handler:
                    await self.handler.on_quorum_restored()
            else:
                events.append((NetworkEvent.QuorumLost, None))
                if self.handler:
                    await self.handler.on_quorum_lost()

        self._last_connected = connected
        return events
