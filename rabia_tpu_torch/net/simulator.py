"""Network simulator: latency, loss, partitions, bandwidth — in-process.

Reference parity: rabia-testing/src/network_sim.rs — `NetworkConditions`
(:13-32), `NetworkStats` (:60-85), the simulator with timed partitions and a
delayed-delivery queue (:50-333; `send_message` :138-186 applies loss and
partition checks, `run_simulation` :248-272 is the 1ms delivery tick,
`deliver_message` :274-301), and the per-node `SimulatedNetwork` transport
adapter (:335-406).

Implementation notes (asyncio instead of tokio): instead of a 1ms polling
tick, delivery uses a heap of (due_time, message) serviced by a single
driver task that sleeps exactly until the next due message — same observable
behavior, no busy loop. Partitions use the reference's one-sided membership
semantics (network_sim.rs:188-204): traffic is blocked iff exactly one
endpoint is inside the partitioned group.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import random
import time
from dataclasses import dataclass, field
from typing import Optional

from rabia_tpu_torch.core.errors import NetworkError, TimeoutError_
from rabia_tpu_torch.core.network import NetworkTransport
from rabia_tpu_torch.core.types import NodeId


@dataclass
class NetworkConditions:
    """Tunable impairments (network_sim.rs:13-32)."""

    latency_min: float = 0.0  # seconds
    latency_max: float = 0.0
    packet_loss_rate: float = 0.0  # [0,1]
    partition_probability: float = 0.0  # spontaneous partition chance per send
    bandwidth_limit: Optional[int] = None  # bytes/sec; None = unlimited

    @staticmethod
    def perfect() -> "NetworkConditions":
        return NetworkConditions()

    @staticmethod
    def lossy(rate: float) -> "NetworkConditions":
        return NetworkConditions(packet_loss_rate=rate)

    @staticmethod
    def wan(latency_ms: float = 50.0, jitter_ms: float = 20.0) -> "NetworkConditions":
        base = latency_ms / 1000.0
        return NetworkConditions(
            latency_min=max(0.0, base - jitter_ms / 2000.0),
            latency_max=base + jitter_ms / 2000.0,
        )


@dataclass
class NetworkStats:
    """Aggregate delivery counters (network_sim.rs:60-85)."""

    messages_sent: int = 0
    messages_delivered: int = 0
    messages_dropped: int = 0
    total_latency: float = 0.0
    total_bytes: int = 0

    @property
    def average_latency(self) -> float:
        if self.messages_delivered == 0:
            return 0.0
        return self.total_latency / self.messages_delivered

    @property
    def delivery_rate(self) -> float:
        if self.messages_sent == 0:
            return 1.0
        return self.messages_delivered / self.messages_sent

    def throughput_mbps(self, elapsed: float) -> float:
        if elapsed <= 0:
            return 0.0
        return self.total_bytes * 8 / elapsed / 1e6


@dataclass(order=True)
class _Pending:
    due: float
    seq: int
    sender: NodeId = field(compare=False)
    target: NodeId = field(compare=False)
    data: bytes = field(compare=False)
    sent_at: float = field(compare=False, default=0.0)


class NetworkSimulator:
    """Central simulated fabric all `SimulatedNetwork` adapters share.

    Crash/partition model:
      - `crash(node)` / `recover(node)`: node neither sends nor receives.
      - `partition(group, duration)`: one-sided membership test — a message
        is blocked iff exactly one endpoint is in `group`
        (network_sim.rs:188-204).
    """

    def __init__(
        self,
        conditions: Optional[NetworkConditions] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.conditions = conditions or NetworkConditions.perfect()
        self.stats = NetworkStats()
        self._rng = random.Random(seed)
        self._queues: dict[NodeId, asyncio.Queue[tuple[NodeId, bytes]]] = {}
        self._notify: dict[NodeId, object] = {}  # node -> zero-arg callable
        self._crashed: set[NodeId] = set()
        self._node_delay: dict[NodeId, float] = {}  # SlowNode fault support
        self._partition: set[NodeId] = set()
        self._partition_until: float = 0.0
        # chaos plane: per-DIRECTED-link impairments (asymmetric loss /
        # extra one-way delay) and a scheduled flapping partition
        self._link_loss: dict[tuple[NodeId, NodeId], float] = {}
        self._link_delay: dict[tuple[NodeId, NodeId], float] = {}
        self._flap_group: set[NodeId] = set()
        self._flap_period: float = 1.0
        self._flap_duty: float = 0.5
        self._flap_t0: float = 0.0
        self._flap_until: float = 0.0
        self._heap: list[_Pending] = []
        self._seq = itertools.count()
        self._wakeup: Optional[asyncio.Event] = None
        self._driver: Optional[asyncio.Task] = None
        self._closed = False
        # token-bucket state for bandwidth_limit
        self._bucket_tokens: float = 0.0
        self._bucket_at: float = time.monotonic()

    # -- registration -------------------------------------------------------

    def register(self, node: NodeId) -> "SimulatedNetwork":
        if node in self._queues:
            raise NetworkError(f"node {node} already registered")
        self._queues[node] = asyncio.Queue()
        return SimulatedNetwork(node, self)

    def nodes(self) -> set[NodeId]:
        return set(self._queues)

    # -- fault injection ----------------------------------------------------

    def crash(self, node: NodeId) -> None:
        self._crashed.add(node)

    def recover(self, node: NodeId) -> None:
        self._crashed.discard(node)

    def is_crashed(self, node: NodeId) -> bool:
        return node in self._crashed

    def set_node_delay(self, node: NodeId, delay: float) -> None:
        """SlowNode fault: extra delay on all of `node`'s traffic (the
        reference stubs this — fault_injection.rs:267-288)."""
        if delay <= 0:
            self._node_delay.pop(node, None)
        else:
            self._node_delay[node] = delay

    def set_link_loss(self, src: NodeId, dst: NodeId, rate: float) -> None:
        """ASYMMETRIC loss: drop `rate` of messages on the DIRECTED link
        src->dst only (the reverse direction is untouched — the
        sustained-asymmetric-loss chaos profile; wireless-BFT's lossy
        uplink shape). rate <= 0 clears the link."""
        if rate <= 0:
            self._link_loss.pop((src, dst), None)
        else:
            self._link_loss[(src, dst)] = min(1.0, float(rate))

    def set_link_delay(self, src: NodeId, dst: NodeId, delay: float) -> None:
        """Extra one-way delay on the DIRECTED link src->dst (seconds);
        composes with global conditions and node delays. <= 0 clears."""
        if delay <= 0:
            self._link_delay.pop((src, dst), None)
        else:
            self._link_delay[(src, dst)] = float(delay)

    def clear_link_faults(self) -> None:
        self._link_loss.clear()
        self._link_delay.clear()

    def set_flap(
        self,
        group: set[NodeId],
        period: float,
        duty: float = 0.5,
        duration: Optional[float] = None,
    ) -> None:
        """Scheduled flapping partition: `group` is isolated (one-sided
        membership semantics, like :meth:`partition`) for the first
        ``duty`` fraction of every ``period`` seconds, healed for the
        rest — evaluated lazily at send/delivery time, so the schedule
        is exact with no timer tasks. ``duration`` bounds the whole
        flapping episode (None = until :meth:`clear_flap`)."""
        if period <= 0:
            raise ValueError("flap period must be positive")
        self._flap_group = set(group)
        self._flap_period = float(period)
        self._flap_duty = min(1.0, max(0.0, float(duty)))
        self._flap_t0 = time.monotonic()
        self._flap_until = (
            self._flap_t0 + duration if duration is not None else float("inf")
        )

    def clear_flap(self) -> None:
        self._flap_group = set()
        self._flap_until = 0.0

    def _flap_active(self) -> bool:
        if not self._flap_group:
            return False
        now = time.monotonic()
        if now >= self._flap_until:
            self._flap_group = set()
            return False
        phase = ((now - self._flap_t0) % self._flap_period) / self._flap_period
        return phase < self._flap_duty

    def partition(self, group: set[NodeId], duration: Optional[float] = None) -> None:
        """Isolate `group` from the rest for `duration` seconds (None = until
        healed explicitly)."""
        self._partition = set(group)
        self._partition_until = (
            time.monotonic() + duration if duration is not None else float("inf")
        )

    def heal_partition(self) -> None:
        self._partition = set()
        self._partition_until = 0.0

    def _partition_active(self) -> bool:
        if not self._partition:
            return False
        if time.monotonic() >= self._partition_until:
            self._partition = set()
            return False
        return True

    def _blocked_by_partition(self, a: NodeId, b: NodeId) -> bool:
        if self._partition_active() and (
            (a in self._partition) != (b in self._partition)
        ):
            return True
        if self._flap_active() and (
            (a in self._flap_group) != (b in self._flap_group)
        ):
            return True
        return False

    # -- the send path (network_sim.rs:138-186) -----------------------------

    def send(self, sender: NodeId, target: NodeId, data: bytes) -> None:
        self.stats.messages_sent += 1
        c = self.conditions
        if sender in self._crashed or target in self._crashed:
            self.stats.messages_dropped += 1
            return
        if target not in self._queues:
            self.stats.messages_dropped += 1
            return
        if self._blocked_by_partition(sender, target):
            self.stats.messages_dropped += 1
            return
        if c.packet_loss_rate > 0 and self._rng.random() < c.packet_loss_rate:
            self.stats.messages_dropped += 1
            return
        link_loss = self._link_loss.get((sender, target))
        if link_loss and self._rng.random() < link_loss:
            self.stats.messages_dropped += 1
            return
        if c.partition_probability > 0 and self._rng.random() < c.partition_probability:
            self.stats.messages_dropped += 1
            return

        delay = 0.0
        if c.latency_max > 0:
            delay = self._rng.uniform(c.latency_min, c.latency_max)
        delay += self._node_delay.get(sender, 0.0) + self._node_delay.get(target, 0.0)
        delay += self._link_delay.get((sender, target), 0.0)
        if c.bandwidth_limit:
            delay += self._bandwidth_delay(len(data), c.bandwidth_limit)

        if delay <= 0:
            self._deliver(sender, target, data, 0.0)
            return
        now = time.monotonic()
        heapq.heappush(
            self._heap,
            _Pending(now + delay, next(self._seq), sender, target, data, now),
        )
        self._ensure_driver()
        if self._wakeup is not None:
            self._wakeup.set()

    def _bandwidth_delay(self, nbytes: int, limit: int) -> float:
        """Token-bucket serialization delay for a message of nbytes."""
        now = time.monotonic()
        self._bucket_tokens = min(
            float(limit), self._bucket_tokens + (now - self._bucket_at) * limit
        )
        self._bucket_at = now
        self._bucket_tokens -= nbytes
        if self._bucket_tokens >= 0:
            return 0.0
        return -self._bucket_tokens / limit

    def _deliver(self, sender: NodeId, target: NodeId, data: bytes, latency: float) -> None:
        if target in self._crashed or target not in self._queues:
            self.stats.messages_dropped += 1
            return
        if self._blocked_by_partition(sender, target):
            self.stats.messages_dropped += 1
            return
        self._queues[target].put_nowait((sender, data))
        self.stats.messages_delivered += 1
        self.stats.total_latency += latency
        self.stats.total_bytes += len(data)
        cb = self._notify.get(target)
        if cb is not None:
            cb()

    # -- delayed-delivery driver (replaces the 1ms tick loop) ---------------

    def _ensure_driver(self) -> None:
        if self._driver is None or self._driver.done():
            self._wakeup = asyncio.Event()
            self._driver = asyncio.get_event_loop().create_task(self._drive())

    async def _drive(self) -> None:
        while not self._closed:
            now = time.monotonic()
            while self._heap and self._heap[0].due <= now:
                p = heapq.heappop(self._heap)
                self._deliver(p.sender, p.target, p.data, now - p.sent_at)
            if self._heap:
                try:
                    await asyncio.wait_for(
                        self._wakeup.wait(), self._heap[0].due - now
                    )
                except asyncio.TimeoutError:
                    pass
                self._wakeup.clear()
            else:
                try:
                    await asyncio.wait_for(self._wakeup.wait(), 0.25)
                except asyncio.TimeoutError:
                    # a send() may have raced the timeout and pushed onto the
                    # heap while we were suspended (it saw the driver not
                    # done, so it won't restart us) — only exit truly idle
                    if self._heap:
                        continue
                    self._driver = None
                    return
                self._wakeup.clear()

    async def close(self) -> None:
        self._closed = True
        if self._wakeup is not None:
            self._wakeup.set()
        if self._driver is not None:
            try:
                await self._driver
            except asyncio.CancelledError:
                pass

    def set_notify(self, node: NodeId, callback) -> None:
        """Wake-on-inbox hook: `callback` runs at actual delivery time
        (after simulated latency), on the loop thread."""
        self._notify[node] = callback

    def queue_of(self, node: NodeId) -> asyncio.Queue:
        return self._queues[node]


class SimulatedNetwork(NetworkTransport):
    """Per-node transport over a shared :class:`NetworkSimulator`
    (network_sim.rs:335-406)."""

    def __init__(self, node_id: NodeId, sim: NetworkSimulator) -> None:
        self.node_id = node_id
        self.sim = sim

    async def send_to(self, target: NodeId, data: bytes) -> None:
        self.sim.send(self.node_id, target, data)

    async def broadcast(self, data: bytes) -> None:
        for n in self.sim.nodes():
            if n != self.node_id:
                self.sim.send(self.node_id, n, data)

    async def receive(self, timeout: Optional[float] = None) -> tuple[NodeId, bytes]:
        q = self.sim.queue_of(self.node_id)
        if timeout is None:
            return await q.get()
        try:
            return await asyncio.wait_for(q.get(), timeout)
        except asyncio.TimeoutError:
            raise TimeoutError_("receive", timeout) from None

    def receive_nowait(self) -> Optional[tuple[NodeId, bytes]]:
        try:
            return self.sim.queue_of(self.node_id).get_nowait()
        except asyncio.QueueEmpty:
            return None

    def set_receive_notify(self, callback) -> bool:
        self.sim.set_notify(self.node_id, callback)
        return True

    async def get_connected_nodes(self) -> set[NodeId]:
        if self.sim.is_crashed(self.node_id):
            return set()
        out = set()
        for n in self.sim.nodes():
            if n == self.node_id or self.sim.is_crashed(n):
                continue
            if self.sim._blocked_by_partition(self.node_id, n):
                continue
            out.add(n)
        return out

    async def disconnect(self, node: NodeId) -> None:
        self.sim.crash(node)

    async def reconnect(self) -> None:
        self.sim.recover(self.node_id)
