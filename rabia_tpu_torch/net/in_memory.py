"""In-process transports: the hub-routed `InMemoryNetwork`.

Reference parity: rabia-testing/src/network/in_memory.rs:9-141 — a central
`InMemoryNetworkSimulator` router plus per-node `InMemoryNetwork` adapters
implementing the transport trait. Here the router is :class:`InMemoryHub`
(asyncio queues instead of tokio channels); the per-node adapter is
:class:`InMemoryNetwork`. Unlike the reference's ``receive()`` — which
errors with "No messages available" after a hard-coded 10ms
(in_memory.rs:73-82) — receive takes an explicit timeout and raises
:class:`~rabia_tpu_torch.core.errors.TimeoutError_` only when it expires.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

from rabia_tpu_torch.core.errors import NetworkError, TimeoutError_
from rabia_tpu_torch.core.network import NetworkTransport
from rabia_tpu_torch.core.types import NodeId


@dataclass
class HubStats:
    """Delivery counters for the whole hub."""

    sent: int = 0
    delivered: int = 0
    dropped: int = 0
    total_bytes: int = 0


class InMemoryHub:
    """Central router: one unbounded queue per registered node.

    Reference: the `InMemoryNetworkSimulator` bus (in_memory.rs:106-141).
    Supports administrative disconnection (drops traffic to/from a node) so
    harnesses can crash nodes without tearing down objects.
    """

    def __init__(self) -> None:
        self._queues: dict[NodeId, asyncio.Queue[tuple[NodeId, bytes]]] = {}
        self._disconnected: set[NodeId] = set()
        self._notify: dict[NodeId, object] = {}  # node -> zero-arg callable
        # membership epoch: bumped on register/connect/notify changes so
        # per-sender broadcast fan-out caches can invalidate
        self._epoch = 0
        self.stats = HubStats()

    def register(self, node: NodeId) -> "InMemoryNetwork":
        if node in self._queues:
            raise NetworkError(f"node {node} already registered")
        self._queues[node] = asyncio.Queue()
        self._epoch += 1
        return InMemoryNetwork(node, self)

    def nodes(self) -> set[NodeId]:
        return set(self._queues) - self._disconnected

    def set_connected(self, node: NodeId, connected: bool) -> None:
        if connected:
            self._disconnected.discard(node)
        else:
            self._disconnected.add(node)
        self._epoch += 1

    def is_connected(self, node: NodeId) -> bool:
        return node in self._queues and node not in self._disconnected

    def route(self, sender: NodeId, target: NodeId, data: bytes) -> None:
        self.stats.sent += 1
        if sender in self._disconnected or target in self._disconnected:
            self.stats.dropped += 1
            return
        q = self._queues.get(target)
        if q is None:
            self.stats.dropped += 1
            return
        q.put_nowait((sender, data))
        self.stats.delivered += 1
        self.stats.total_bytes += len(data)
        cb = self._notify.get(target)
        if cb is not None:
            cb()

    def set_notify(self, node: NodeId, callback) -> None:
        """Wake-on-inbox hook: `callback` runs (on the loop thread, from
        route()) whenever a message lands in `node`'s queue."""
        self._notify[node] = callback
        self._epoch += 1

    def queue_of(self, node: NodeId) -> asyncio.Queue:
        return self._queues[node]


class InMemoryNetwork(NetworkTransport):
    """Per-node transport adapter over an :class:`InMemoryHub`."""

    def __init__(self, node_id: NodeId, hub: InMemoryHub) -> None:
        self.node_id = node_id
        self.hub = hub
        self._bcast_epoch = -1
        self._bcast_targets: list = []  # [(queue, notify-or-None)]

    async def send_to(self, target: NodeId, data: bytes) -> None:
        self.send_to_nowait(target, data)

    async def broadcast(self, data: bytes) -> None:
        self.broadcast_nowait(data)

    def send_to_nowait(self, target: NodeId, data: bytes) -> bool:
        self.hub.route(self.node_id, target, data)
        return True

    def broadcast_nowait(self, data: bytes) -> bool:
        hub = self.hub
        if hub._epoch != self._bcast_epoch:
            # rebuild the fan-out on membership/notify change: rebuilding
            # the recipient set per broadcast (NodeId set algebra + dict
            # walks) measurably taxed the serial engine shape
            self._bcast_epoch = hub._epoch
            self._bcast_targets = (
                []
                if self.node_id in hub._disconnected
                else [
                    (hub._queues[n], hub._notify.get(n))
                    for n in hub._queues
                    if n != self.node_id and n not in hub._disconnected
                ]
            )
        if not self._bcast_targets:
            if self.node_id in hub._disconnected:
                # stat parity with the uncached path: route() counted one
                # attempted+dropped send per LIVE peer for a disconnected
                # sender
                n_live = sum(
                    1
                    for n in hub._queues
                    if n != self.node_id and n not in hub._disconnected
                )
                hub.stats.sent += n_live
                hub.stats.dropped += n_live
            return True
        me = self.node_id
        stats = hub.stats
        nbytes = len(data)
        for q, cb in self._bcast_targets:
            stats.sent += 1
            q.put_nowait((me, data))
            stats.delivered += 1
            stats.total_bytes += nbytes
            if cb is not None:
                cb()
        return True

    async def receive(self, timeout: Optional[float] = None) -> tuple[NodeId, bytes]:
        q = self.hub.queue_of(self.node_id)
        if timeout is None:
            return await q.get()
        try:
            return await asyncio.wait_for(q.get(), timeout)
        except asyncio.TimeoutError:
            raise TimeoutError_("receive", timeout) from None

    def receive_nowait(self) -> Optional[tuple[NodeId, bytes]]:
        """Non-blocking drain helper for the engine's round loop."""
        q = self.hub.queue_of(self.node_id)
        try:
            return q.get_nowait()
        except asyncio.QueueEmpty:
            return None

    def set_receive_notify(self, callback) -> bool:
        self.hub.set_notify(self.node_id, callback)
        return True

    async def get_connected_nodes(self) -> set[NodeId]:
        if not self.hub.is_connected(self.node_id):
            return set()
        return self.hub.nodes() - {self.node_id}

    async def disconnect(self, node: NodeId) -> None:
        self.hub.set_connected(node, False)

    async def reconnect(self) -> None:
        self.hub.set_connected(self.node_id, True)
