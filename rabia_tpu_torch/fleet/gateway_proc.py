"""FleetGateway: a standalone session-holding gateway behind the ring.

The routed fleet decouples the session/dedup tier from the replica
count: many of these processes (not one per replica) each own a slice
of the shard space (:mod:`rabia_tpu_torch.fleet.ring`), hold the client
sessions homed there, and proxy fresh Submits to the replica cluster's
gateways over the session-mux transport lane — forwarding UNDER THE
CLIENT'S OWN 16-byte session id, so the replica gateway's session table
keeps the end-to-end ``(client_id, seq)`` exactly-once key. A fleet
gateway for a shard it does not own answers ``ResultStatus.MOVED`` with
the owner's address and the client re-sends the same seq there.

Why double session tables are safe: the fleet table is a *cache tier*
(answers replays without a replica round-trip, sheds per-session window
overflow at the edge); the replica-tier table remains authoritative.
Any seq the fleet tier forwards twice (lost ledger record, expired
waiter, crashed fleet gateway) dedups upstream — and even past a
replica session lease, the engine's deterministic batch ids
(``batch_id_for(client_id, seq)``) block a double apply. Nothing in
this tier is a correctness dependency; it is all fast-path.

Upstream routing concentrates a shard on ONE replica gateway
(``shard % len(upstreams)``) so the round-15 cross-session coalescing
tier sees the same arrival density it was scored at.

Failover story (scored by the ``routed_gateway_failover`` chaos
scenario): completed results replicate as ledger records to the shard's
ring successors (:mod:`rabia_tpu_torch.fleet.ledger`) — the exact gateways
that inherit the shard when this process dies — and planned rebalance
ships full sessions ahead of the MOVED wave (:mod:`fleet.handoff`).

Run standalone via the testing/recovery.py child protocol:
``python -m rabia_tpu_torch.fleet.gateway_proc --child <idx> <json
fleet_ports> <json upstream_addrs> <n_shards> [extras]`` — emits one
``{"event": "ready", ...}`` JSON line on stdout once listening.

The port's copy of the reference's ``rabia_tpu/fleet/gateway_proc.py``,
its imports retargeted to ``rabia_tpu_torch``; a child gateway exits
when its parent dies.
"""

from __future__ import annotations

import asyncio
import json
import logging
import struct
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from rabia_tpu_torch.core.config import TcpNetworkConfig
from rabia_tpu_torch.core.errors import RabiaError, TimeoutError_
from rabia_tpu_torch.core.messages import (
    AdminKind,
    AdminRequest,
    AdminResponse,
    ClientHello,
    ProtocolMessage,
    ReadIndex,
    ReadIndexMode,
    Result,
    ResultStatus,
    Submit,
)
from rabia_tpu_torch.core.serialization import Serializer
from rabia_tpu_torch.core.types import NodeId
from rabia_tpu_torch.fleet.handoff import (
    decode_handoff,
    encode_handoff,
    export_sessions,
    import_sessions,
)
from rabia_tpu_torch.fleet.ledger import (
    LedgerRecord,
    apply_record,
    decode_records,
    encode_records,
)
from rabia_tpu_torch.fleet.ring import HashRing, RingMember, moved_shards
from rabia_tpu_torch.gateway.session import (
    SUBMIT_DUP_CACHED,
    SUBMIT_DUP_INFLIGHT,
    SUBMIT_FRESH,
    SUBMIT_SHED_WINDOW,
    SessionTable,
)
from rabia_tpu_torch.obs.flight import (
    FRE_FLEET_FWD,
    FRE_FLEET_LEDGER_APPLY,
    FRE_FLEET_LEDGER_SEND,
    FRE_FLEET_MOVED,
    FRE_FLEET_RECV,
    FRE_FLEET_RESULT,
    FlightRecorder,
    batch_id_for,
    build_fleet_trace_slice,
    fr_hash,
)
from rabia_tpu_torch.obs.journal import AnomalyJournal
from rabia_tpu_torch.obs.registry import MetricsRegistry
from rabia_tpu_torch.obs.telemetry import TelemetrySampler

logger = logging.getLogger("rabia_tpu_torch.fleet")


@dataclass
class FleetGatewayConfig:
    name: str = "gw0"
    bind_host: str = "127.0.0.1"
    bind_port: int = 0  # ephemeral
    # replica-cluster gateway endpoints the fleet proxies Submits to;
    # a shard's traffic always rides upstreams[shard % len(upstreams)]
    # so the replica-side coalescing tier sees concentrated arrivals
    upstreams: tuple[tuple[str, int], ...] = ()
    n_shards: int = 4
    # ledger replication factor: completed results copy to the shard's
    # first rf ring successors (successor[0] is this gateway itself)
    replication_factor: int = 2
    default_window: int = 64
    session_ttl: float = 600.0
    result_cache_cap: int = 4096
    session_lease: Optional[float] = None
    gc_interval: float = 1.0
    # a forwarded Submit unanswered this long is aborted locally and
    # shed RETRY — the client's resubmit dedups upstream
    forward_timeout: float = 30.0
    # a DUP_INFLIGHT waiter (imported handoff reservation) unresolved
    # this long is aborted + shed RETRY; the retry re-forwards
    waiter_timeout: float = 10.0
    handoff_timeout: float = 10.0
    # per-second telemetry ring (obs/telemetry.TelemetrySampler), served
    # as AdminKind.TIMELINE like the replica gateways. 0 disables it.
    telemetry_interval: float = 1.0
    telemetry_cap: int = 900
    # shard-group scale-out (fleet/groups.py): when non-empty, each
    # inner tuple is ONE consensus group's replica-gateway endpoints
    # (index = group id) and a Submit routes GroupMap.group_of(shard)
    # -> that lane — within the lane the same shard % len spread as the
    # flat tier. `groups` is the GroupMap doc; None = the deterministic
    # even partition over len(upstream_groups) groups. Empty
    # upstream_groups = the flat (ungrouped) tier, `upstreams` above.
    upstream_groups: tuple[tuple[tuple[str, int], ...], ...] = ()
    groups: Optional[dict] = None


@dataclass
class FleetStats:
    submits: int = 0
    forwarded: int = 0
    cached_replays: int = 0
    moved: int = 0
    shed: int = 0
    forward_timeouts: int = 0
    ledger_sent: int = 0
    ledger_applied: int = 0
    handoff_out_sessions: int = 0
    handoff_in_sessions: int = 0


class _UpstreamLink:
    """One session-mux connection to a replica gateway (MUX_MAGIC lane,
    the same wire contract as testing/loadsession.MuxConn). Frames sent
    pre-connect are buffered and flushed once the handshake completes;
    a dropped link reconnects on the next send. Inbound frames demux by
    their 16-byte session prefix back into the owning FleetGateway."""

    def __init__(self, owner: "FleetGateway", host: str, port: int) -> None:
        self.owner = owner
        self.host = host
        self.port = port
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._backlog: list[bytes] = []
        self._connecting: Optional[asyncio.Task] = None
        self._read_task: Optional[asyncio.Task] = None

    def send(self, session_id: bytes, data: bytes) -> None:
        frame = struct.pack("<I", 16 + len(data)) + session_id + data
        if self.writer is not None:
            try:
                self.writer.write(frame)
                return
            except Exception:
                self._drop()
        self._backlog.append(frame)
        if self._connecting is None or self._connecting.done():
            self._connecting = asyncio.ensure_future(self._connect())

    def _drop(self) -> None:
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
        self.reader = None
        self.writer = None

    async def _connect(self) -> None:
        from rabia_tpu_torch.net.tcp import MUX_MAGIC

        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), 10.0
            )
            writer.write(MUX_MAGIC)
            await asyncio.wait_for(reader.readexactly(16), 10.0)
        except Exception as e:
            logger.warning(
                "fleet %s: upstream %s:%d connect failed: %s",
                self.owner.config.name, self.host, self.port, e,
            )
            # backlog stays; the forward-timeout sweep sheds the pending
            # submits RETRY and the clients' resubmits retry the dial
            return
        self.reader, self.writer = reader, writer
        if self._read_task is not None:
            self._read_task.cancel()
        self._read_task = asyncio.ensure_future(self._read_loop())
        backlog, self._backlog = self._backlog, []
        for frame in backlog:
            writer.write(frame)

    async def _read_loop(self) -> None:
        try:
            while self.reader is not None:
                hdr = await self.reader.readexactly(4)
                (ln,) = struct.unpack("<I", hdr)
                data = await self.reader.readexactly(ln)
                if ln < 16:
                    continue
                self.owner._on_upstream(data[:16], data[16:])
        except (asyncio.IncompleteReadError, asyncio.CancelledError,
                ConnectionError, OSError):
            self._drop()

    async def close(self) -> None:
        for t in (self._connecting, self._read_task):
            if t is not None:
                t.cancel()
        if self.writer is not None:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:
                pass
        self.reader = None
        self.writer = None


class FleetGateway:
    """One routed-fleet gateway process (see module doc)."""

    def __init__(
        self,
        config: Optional[FleetGatewayConfig] = None,
        node_id: Optional[NodeId] = None,
    ) -> None:
        self.config = config or FleetGatewayConfig()
        self.node_id = node_id or NodeId(uuid.uuid4())
        self.serializer = Serializer()
        self.sessions = SessionTable(
            default_window=self.config.default_window,
            session_ttl=self.config.session_ttl,
            result_cache_cap=self.config.result_cache_cap,
            lease_ttl=self.config.session_lease,
        )
        self.ring = HashRing()
        self.stats = FleetStats()
        self._net = None
        self._running = False
        self._run_task: Optional[asyncio.Task] = None
        self._tasks: set = set()
        # seqs forwarded upstream and not yet answered:
        # (client_id, seq) -> (shard, deadline)
        self._pending: dict[tuple[uuid.UUID, int], tuple[int, float]] = {}
        # DUP_INFLIGHT reservations with no local forward (imported by
        # handoff; outcome arrives as a ledger record or times out)
        self._waiting: dict[tuple[uuid.UUID, int], float] = {}
        # client -> shard of its last fresh Submit (the handoff work
        # list: sessions homed to a moved shard transfer with it)
        self._session_shard: dict[uuid.UUID, int] = {}
        self._upstreams: list[_UpstreamLink] = []
        # shard-group routing state (fleet/groups.py): None = flat tier
        self.groups = None
        self._group_links: dict[int, list[_UpstreamLink]] = {}
        self._admin_nonce = 0
        self._admin_futs: dict[int, asyncio.Future] = {}
        # local monotonic completion counter: the frontier_mark domain
        # for this table (session GC runs against it, not an engine
        # state version — the fleet tier has no engine)
        self._frontier = 0
        # fleet-side observability plane: a flight ring for the routing
        # hops (FRE_FLEET_* kinds, batch-hash keyed so a (client_id, seq)
        # trace joins with the replica tier), an anomaly journal, and a
        # telemetry ring started in start(). The row index parses from
        # the gateway name ("gw3" -> 3) — it only disambiguates fleet
        # slices among themselves, never against replica rows (slices
        # carry tier="fleet").
        self.flight = FlightRecorder()
        self.journal = AnomalyJournal()
        self._telemetry: Optional[TelemetrySampler] = None
        digits = "".join(
            c for c in self.config.name if c.isdigit()
        )
        self._row = int(digits) if digits else 0
        self.metrics = MetricsRegistry(namespace="rabia")
        self._register_metrics()

    # -- metrics ------------------------------------------------------------

    def _register_metrics(self) -> None:
        m, s = self.metrics, self.stats
        tag = {"fleet_gw": self.config.name}
        m.counter("fleet_submits_total", "Submits received", tag,
                  fn=lambda: s.submits)
        m.counter("fleet_forwarded_total", "Submits proxied upstream", tag,
                  fn=lambda: s.forwarded)
        m.counter("fleet_cached_replays_total",
                  "replays answered from the fleet session cache", tag,
                  fn=lambda: s.cached_replays)
        m.counter("fleet_moved_total", "MOVED redirects answered", tag,
                  fn=lambda: s.moved)
        m.counter("fleet_shed_total", "RETRY sheds (window/timeout)", tag,
                  fn=lambda: s.shed)
        m.counter("fleet_ledger_sent_total",
                  "ledger records replicated out", tag,
                  fn=lambda: s.ledger_sent)
        m.counter("fleet_ledger_applied_total",
                  "replicated ledger records imported", tag,
                  fn=lambda: s.ledger_applied)
        m.counter("fleet_handoff_sessions_out_total",
                  "sessions exported on rebalance", tag,
                  fn=lambda: s.handoff_out_sessions)
        m.counter("fleet_handoff_sessions_in_total",
                  "sessions imported on rebalance", tag,
                  fn=lambda: s.handoff_in_sessions)
        m.gauge("fleet_sessions", "live client sessions", tag,
                fn=lambda: len(self.sessions))
        m.gauge("fleet_pending_forwards", "submits in flight upstream",
                tag, fn=lambda: len(self._pending))
        m.gauge("fleet_ring_version", "adopted ring membership version",
                tag, fn=lambda: self.ring.version)
        m.gauge("fleet_group_map_version",
                "adopted shard-group map version (-1 = flat tier)", tag,
                fn=lambda: (
                    self.groups.version if self.groups is not None else -1
                ))

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        from rabia_tpu_torch.net.tcp import TcpNetwork

        self._net = TcpNetwork(
            self.node_id,
            TcpNetworkConfig(
                bind_host=self.config.bind_host,
                bind_port=self.config.bind_port,
            ),
        )
        if self.config.upstream_groups:
            from rabia_tpu_torch.fleet.groups import GroupMap

            self.groups = (
                GroupMap.from_doc(self.config.groups)
                if self.config.groups is not None
                else GroupMap.initial(
                    self.config.n_shards,
                    len(self.config.upstream_groups),
                )
            )
            self._group_links = {
                g: [_UpstreamLink(self, h, p) for h, p in addrs]
                for g, addrs in enumerate(self.config.upstream_groups)
            }
            self._upstreams = [
                link
                for links in self._group_links.values()
                for link in links
            ]
        else:
            self._upstreams = [
                _UpstreamLink(self, host, port)
                for host, port in self.config.upstreams
            ]
        if self.config.telemetry_interval > 0 and self._telemetry is None:
            self._telemetry = TelemetrySampler(
                self.metrics,
                node=self.config.name,
                interval=self.config.telemetry_interval,
                cap=self.config.telemetry_cap,
            ).start()
        self._running = True
        self._run_task = asyncio.ensure_future(self._run())

    @property
    def port(self) -> int:
        return self._net.port if self._net is not None else 0

    def member(self) -> RingMember:
        """This gateway's own ring address card."""
        return RingMember(
            name=self.config.name,
            host=self.config.bind_host,
            port=self.port,
            node=self.node_id,
        )

    async def close(self) -> None:
        self._running = False
        if self._telemetry is not None:
            # final flush so the ring covers the run's last instant
            self._telemetry.sample()
            self._telemetry.close()
            self._telemetry = None
        for t in (self._run_task, *self._tasks):
            if t is not None:
                t.cancel()
        await asyncio.gather(
            *(t for t in (self._run_task, *self._tasks) if t),
            return_exceptions=True,
        )
        self._tasks.clear()
        for up in self._upstreams:
            await up.close()
        if self._net is not None:
            await self._net.close()
            self._net = None

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # -- ring ---------------------------------------------------------------

    def adopt_ring(self, ring: HashRing) -> None:
        """Install a membership view WITHOUT handoff (bootstrap path —
        every member adopts the same initial doc before serving)."""
        self.ring = ring
        self._register_ring_peers(ring)

    def _register_ring_peers(self, ring: HashRing) -> None:
        for mem in ring.members.values():
            if mem.name != self.config.name:
                self._net.add_peer(mem.node, mem.host, mem.port)

    def _owns(self, shard: int) -> bool:
        owner = self.ring.owner(shard)
        return owner is None or owner.name == self.config.name

    # -- shard groups -------------------------------------------------------

    def adopt_groups(self, new_map) -> bool:
        """Install a strictly newer GroupMap (the routing flip of the
        safe rebalance order — the new owner's replica gateways widened
        their accepted ranges BEFORE this runs). Sessions stay put: the
        fleet session cache answers replays that cross the flip, so the
        re-routed group never sees an already-committed seq."""
        if self.groups is None:
            raise RuntimeError(
                f"fleet {self.config.name}: not configured with "
                "upstream_groups; cannot adopt a group map"
            )
        if new_map.version <= self.groups.version:
            return False
        if new_map.n_shards != self.groups.n_shards:
            raise ValueError("group map covers a different shard space")
        if any(
            g not in self._group_links for g in new_map.groups()
        ):
            raise ValueError(
                "group map names a group with no upstream lane"
            )
        self.groups = new_map
        return True

    async def _rebalance(self, new_ring: HashRing) -> None:
        """Adopt a new membership view: hand sessions on departing
        shards to their new owners FIRST, then start answering MOVED.
        A redirected client's replay therefore always finds its dedup
        state already imported at the destination."""
        self._register_ring_peers(new_ring)
        moved = moved_shards(self.ring, new_ring, self.config.n_shards)
        losing = {
            s: owner for s, owner in moved.items()
            if (m := self.ring.owner(s)) is not None
            and m.name == self.config.name
        }
        by_target: dict[str, list[uuid.UUID]] = {}
        for cid, shard in self._session_shard.items():
            target = losing.get(shard)
            if target is not None:
                by_target.setdefault(target, []).append(cid)
        for target_name, cids in by_target.items():
            target = new_ring.members.get(target_name)
            if target is None:
                continue
            exports = export_sessions(self.sessions, cids)
            if not exports:
                continue
            self.stats.handoff_out_sessions += len(exports)
            try:
                await self._admin_call(
                    target.node,
                    AdminKind.HANDOFF,
                    encode_handoff(exports),
                    timeout=self.config.handoff_timeout,
                )
            except Exception as e:
                # the new owner still recovers via replicated ledger
                # records + upstream dedup; log and move on
                logger.warning(
                    "fleet %s: handoff of %d sessions to %s failed: %s",
                    self.config.name, len(exports), target_name, e,
                )
        self.ring = new_ring

    # -- receive loop -------------------------------------------------------

    async def _run(self) -> None:
        last_gc = time.time()
        while self._running:
            try:
                sender, data = await self._net.receive(
                    timeout=self.config.gc_interval
                )
            except TimeoutError_:
                sender = None
            except asyncio.CancelledError:
                return
            if sender is not None:
                try:
                    msg = self.serializer.deserialize(data)
                except RabiaError as e:
                    logger.warning(
                        "fleet %s: dropping bad frame from %s: %s",
                        self.config.name, sender, e,
                    )
                else:
                    self._handle(sender, msg)
            now = time.time()
            if now - last_gc >= self.config.gc_interval:
                last_gc = now
                self._sweep(now)
                self.sessions.gc(self._frontier, now)

    def _sweep(self, now: float) -> None:
        """Shed forwarded submits and imported-reservation waiters whose
        deadline passed: abort the local reservation and answer RETRY —
        the client's resubmit re-forwards and dedups upstream."""
        for key, (shard, deadline) in list(self._pending.items()):
            if now >= deadline:
                del self._pending[key]
                cid, seq = key
                self.sessions.abort(cid, seq)
                self.stats.forward_timeouts += 1
                self.stats.shed += 1
                self._send_result(
                    cid, seq, ResultStatus.RETRY, (b"fleet-forward-timeout",)
                )
        for key, deadline in list(self._waiting.items()):
            if now >= deadline:
                del self._waiting[key]
                cid, seq = key
                self.sessions.abort(cid, seq)
                self.stats.shed += 1
                self._send_result(
                    cid, seq, ResultStatus.RETRY, (b"fleet-waiter-timeout",)
                )

    def _handle(self, sender: NodeId, msg: ProtocolMessage) -> None:
        p = msg.payload
        if isinstance(p, (ClientHello, Submit)) or (
            isinstance(p, ReadIndex) and p.mode == ReadIndexMode.READ
        ):
            # same invariant as the replica gateway: a client's transport
            # identity IS its session id
            if sender.value != p.client_id:
                logger.warning(
                    "fleet %s: client frame session/transport mismatch "
                    "(%s via %s)",
                    self.config.name, p.client_id, sender,
                )
                return
        if isinstance(p, ClientHello):
            window, last_seq = self.sessions.hello(p.client_id, p.max_inflight)
            self._send(
                ClientHello(
                    client_id=p.client_id, ack=True,
                    last_seq=last_seq, max_inflight=window,
                ),
                sender,
            )
        elif isinstance(p, Submit):
            self._on_submit(p)
        elif isinstance(p, ReadIndex) and p.mode == ReadIndexMode.READ:
            # reads carry no session window state: straight pass-through
            # under the client's session id; the Result demuxes back by
            # its (client_id, seq) falling outside the pending map
            self._forward(p.client_id, p)
        elif isinstance(p, AdminRequest):
            self._on_admin(sender, p)
        elif isinstance(p, AdminResponse):
            fut = self._admin_futs.pop(p.nonce, None)
            if fut is not None and not fut.done():
                fut.set_result(p)
        # anything else on the fleet port is noise; ignore

    # -- submit path --------------------------------------------------------

    def _on_submit(self, p: Submit) -> None:
        self.stats.submits += 1
        # the fleet hop of the cross-tier trace: every Submit records
        # its arrival under the SAME deterministic batch hash the
        # replica tier keys its lifecycle events with
        bhash = fr_hash(batch_id_for(p.client_id, p.seq))
        self.flight.record(FRE_FLEET_RECV, shard=p.shard, batch=bhash)
        decision, cstatus, cpayload = self.sessions.submit_check(
            p.client_id, p.seq, p.ack_upto
        )
        if decision == SUBMIT_DUP_CACHED:
            # the raw cached status is the ORIGINAL outcome; a replayed
            # OK answers CACHED on the wire (byte-identical payload)
            self.stats.cached_replays += 1
            wire = (
                ResultStatus.CACHED
                if cstatus == ResultStatus.OK
                else cstatus
            )
            self._send_result(p.client_id, p.seq, wire, cpayload)
            return
        if decision == SUBMIT_DUP_INFLIGHT:
            key = (p.client_id, p.seq)
            if key not in self._pending and key not in self._waiting:
                # an imported handoff reservation: the outcome arrives
                # as a replicated ledger record, or the waiter times out
                self._waiting[key] = (
                    time.time() + self.config.waiter_timeout
                )
            return  # the completion answers (net routes by session id)
        if decision == SUBMIT_SHED_WINDOW:
            self.stats.shed += 1
            self._send_result(
                p.client_id, p.seq, ResultStatus.RETRY,
                (b"session-window-full",)
            )
            return
        # SUBMIT_FRESH — the seq is reserved; route it
        if not self._owns(p.shard):
            owner = self.ring.owner(p.shard)
            self.sessions.abort(p.client_id, p.seq)
            self.stats.moved += 1
            self.flight.record(
                FRE_FLEET_MOVED, shard=p.shard, batch=bhash,
            )
            self._send_result(
                p.client_id, p.seq, ResultStatus.MOVED,
                (
                    f"{owner.host}:{owner.port}".encode(),
                    owner.node.value.bytes,
                ),
            )
            return
        self._session_shard[p.client_id] = p.shard
        self._pending[(p.client_id, p.seq)] = (
            p.shard, time.time() + self.config.forward_timeout
        )
        self.stats.forwarded += 1
        self.flight.record(FRE_FLEET_FWD, shard=p.shard, batch=bhash)
        self._forward(p.client_id, p)

    def _forward(self, client_id: uuid.UUID, payload) -> None:
        """Proxy a client frame upstream under the client's own session
        id — the replica gateway sees the client itself."""
        if not self._upstreams:
            if isinstance(payload, Submit):
                self._pending.pop((client_id, payload.seq), None)
                self.sessions.abort(client_id, payload.seq)
                self.stats.shed += 1
                self._send_result(
                    client_id, payload.seq, ResultStatus.RETRY,
                    (b"no-upstream",)
                )
            return
        shard = getattr(payload, "shard", 0)
        if self.groups is not None and 0 <= shard < self.groups.n_shards:
            # group-routed lane: the owning group's upstreams, spread
            # shard % len within the lane (coalescing concentration)
            links = self._group_links[self.groups.group_of(shard)]
            up = links[shard % len(links)]
        else:
            up = self._upstreams[shard % len(self._upstreams)]
        data = self.serializer.serialize(
            ProtocolMessage.new(NodeId(client_id), payload, None)
        )
        up.send(client_id.bytes, data)

    def _on_upstream(self, session_id: bytes, data: bytes) -> None:
        """A frame from a replica gateway for one proxied session."""
        try:
            msg = self.serializer.deserialize(data)
        except RabiaError:
            return
        p = msg.payload
        if not isinstance(p, Result):
            return  # hellos etc. are never proxied; ignore
        key = (p.client_id, p.seq)
        entry = self._pending.pop(key, None)
        if entry is None:
            # a read result or a late/duplicate answer: pass through
            self._send(p, NodeId(p.client_id))
            return
        shard, _deadline = entry
        self.flight.record(
            FRE_FLEET_RESULT, shard=shard, arg=int(p.status),
            batch=fr_hash(batch_id_for(p.client_id, p.seq)),
        )
        if p.status == ResultStatus.RETRY:
            # upstream shed it: nothing committed, nothing to cache
            self.sessions.abort(p.client_id, p.seq)
        else:
            # CACHED upstream means the original outcome was OK — store
            # the RAW status so this table's own replay answers CACHED
            # with the identical payload
            raw = (
                ResultStatus.OK
                if p.status == ResultStatus.CACHED
                else p.status
            )
            self._complete(p.client_id, p.seq, shard, int(raw), p.payload)
        self._send(p, NodeId(p.client_id))

    def _complete(
        self,
        client_id: uuid.UUID,
        seq: int,
        shard: int,
        raw_status: int,
        payload: tuple[bytes, ...],
    ) -> None:
        self._frontier += 1
        self.sessions.complete_op(
            client_id, seq, raw_status, payload, self._frontier
        )
        self._replicate(client_id, seq, shard, raw_status, payload)

    # -- ledger replication -------------------------------------------------

    def _replicate(
        self,
        client_id: uuid.UUID,
        seq: int,
        shard: int,
        status: int,
        payload: tuple[bytes, ...],
    ) -> None:
        """Fire-and-forget the completed record to the shard's other
        ring successors — exactly the members that inherit the shard if
        this gateway dies. A record lost in flight is NOT a correctness
        hole (upstream dedup + deterministic batch ids), it just costs
        the replay one upstream round-trip."""
        rf = self.config.replication_factor
        if rf <= 1 or len(self.ring) <= 1:
            return
        blob = encode_records([
            LedgerRecord(
                client_id=client_id, seq=seq, shard=shard,
                status=status, payload=tuple(payload),
            )
        ])
        bhash = fr_hash(batch_id_for(client_id, seq))
        for mem in self.ring.successors(shard, rf):
            if mem.name == self.config.name:
                continue
            self.stats.ledger_sent += 1
            digits = "".join(c for c in mem.name if c.isdigit())
            self.flight.record(
                FRE_FLEET_LEDGER_SEND, shard=shard,
                peer=int(digits) if digits else 0, batch=bhash,
            )
            self._admin_nonce += 1
            self._send(
                AdminRequest(
                    kind=int(AdminKind.LEDGER),
                    nonce=self._admin_nonce,
                    query=blob,
                ),
                mem.node,
            )

    def _apply_ledger(self, blob: bytes) -> int:
        applied = 0
        for rec in decode_records(blob):
            self._frontier += 1
            decision = apply_record(
                self.sessions, rec.client_id, rec.seq, rec.status,
                rec.payload, self._frontier,
            )
            if decision in (SUBMIT_FRESH, SUBMIT_DUP_INFLIGHT):
                applied += 1
                self.stats.ledger_applied += 1
                self.flight.record(
                    FRE_FLEET_LEDGER_APPLY, shard=rec.shard,
                    arg=int(rec.status) & 0xFF,
                    batch=fr_hash(batch_id_for(rec.client_id, rec.seq)),
                )
                self._session_shard.setdefault(rec.client_id, rec.shard)
                self._answer_if_waiting(rec.client_id, rec.seq)
        return applied

    def _answer_if_waiting(self, client_id: uuid.UUID, seq: int) -> None:
        """A completion landed for a seq a client is parked on (imported
        inflight reservation): answer it now."""
        if self._waiting.pop((client_id, seq), None) is None:
            return
        cached = self.sessions.cached_result(client_id, seq)
        if cached is None:
            return
        wire = (
            ResultStatus.CACHED
            if cached.status == ResultStatus.OK
            else cached.status
        )
        self._send_result(client_id, seq, wire, cached.payload)

    # -- admin plane --------------------------------------------------------

    def _on_admin(self, sender: NodeId, p: AdminRequest) -> None:
        try:
            status, body = self._admin_body(p)
        except Exception as e:  # never let an admin probe kill the loop
            status, body = 1, str(e).encode()
        self._send(
            AdminResponse(nonce=p.nonce, status=status, body=body), sender
        )

    def _admin_body(self, p: AdminRequest) -> tuple[int, bytes]:
        kind = p.kind
        if kind == AdminKind.METRICS:
            return 0, self.metrics.render_prometheus().encode()
        if kind == AdminKind.HEALTH:
            return 0, json.dumps(self.health()).encode()
        if kind == AdminKind.RING:
            query = json.loads(p.query.decode() or '{"op": "get"}')
            if query.get("op") == "set":
                new_ring = HashRing.from_doc(query["ring"])
                self._spawn(self._rebalance(new_ring))
                return 0, json.dumps(
                    {"adopting": new_ring.version}
                ).encode()
            if query.get("op") == "set_groups":
                from rabia_tpu_torch.fleet.groups import GroupMap

                adopted = self.adopt_groups(
                    GroupMap.from_doc(query["groups"])
                )
                return 0, json.dumps({
                    "adopted": adopted,
                    "version": self.groups.version,
                }).encode()
            return 0, json.dumps(self._ring_doc()).encode()
        if kind == AdminKind.HANDOFF:
            exports = decode_handoff(bytes(p.query))
            self._frontier += 1
            summary = import_sessions(
                self.sessions, exports, self._frontier
            )
            self.stats.handoff_in_sessions += summary.sessions
            for e in exports:
                for seq, _status, _parts in e.results:
                    self._answer_if_waiting(e.client_id, seq)
            return 0, json.dumps({
                "sessions": summary.sessions,
                "results": summary.results,
                "inflight": summary.inflight,
                "skipped": summary.skipped,
            }).encode()
        if kind == AdminKind.LEDGER:
            applied = self._apply_ledger(bytes(p.query))
            return 0, json.dumps({"applied": applied}).encode()
        if kind == AdminKind.JOURNAL:
            jkind, last = None, 64
            if p.query:
                try:
                    q = json.loads(p.query)
                    jkind = q.get("kind")
                    last = max(0, int(q.get("last", 64)))
                except (ValueError, TypeError, AttributeError):
                    return 1, b"malformed journal query"
            return 0, json.dumps(
                {"anomalies": self.journal.snapshot(limit=last, kind=jkind)}
            ).encode()
        if kind == AdminKind.TRACE:
            # the fleet hop of a cross-tier trace: same TraceSlice
            # schema the replica gateways serve, selected by the same
            # deterministic batch hash, marked tier="fleet" so the
            # merged timeline renders the hop under the gateway's name
            try:
                q = json.loads(p.query) if p.query else {}
                if "batch" in q:
                    bid = uuid.UUID(hex=q["batch"])
                else:
                    bid = batch_id_for(
                        uuid.UUID(hex=q["client"]), int(q["seq"])
                    )
            except (ValueError, TypeError, KeyError):
                return 1, b"malformed trace query"
            doc = build_fleet_trace_slice(
                self.flight, self.config.name, self._row, fr_hash(bid)
            )
            doc["batch_id"] = bid.hex
            return 0, json.dumps(doc).encode()
        if kind == AdminKind.TIMELINE:
            if self._telemetry is None:
                return 1, b"telemetry sampler disabled"
            last = None
            if p.query:
                try:
                    last = json.loads(p.query).get("last")
                    if last is not None:
                        last = int(last)
                except (ValueError, TypeError, AttributeError):
                    return 1, b"malformed timeline query"
            return 0, json.dumps(self._telemetry.document(last)).encode()
        return 1, b"unsupported admin kind for fleet gateway"

    def _ring_doc(self) -> dict:
        cfg = self.config
        return {
            "self": cfg.name,
            "node": self.node_id.value.hex,
            "ring": self.ring.to_doc(),
            "n_shards": cfg.n_shards,
            "owned_shards": self.ring.owned_shards(cfg.name, cfg.n_shards),
            "sessions": len(self.sessions),
            "groups": (
                self.groups.to_doc() if self.groups is not None else None
            ),
        }

    def health(self) -> dict:
        s = self.stats
        return {
            "role": "fleet-gateway",
            "name": self.config.name,
            "node": self.node_id.value.hex,
            "ring_version": self.ring.version,
            "ring_members": sorted(self.ring.members),
            "owned_shards": self.ring.owned_shards(
                self.config.name, self.config.n_shards
            ),
            # the replica-cluster endpoints this gateway proxies to —
            # the fleet aggregator walks these to scrape the replica
            # tier without out-of-band configuration
            "upstreams": [[h, p] for h, p in self.config.upstreams],
            "upstream_groups": [
                [[h, p] for h, p in grp]
                for grp in self.config.upstream_groups
            ],
            "groups": (
                self.groups.to_doc() if self.groups is not None else None
            ),
            "sessions": len(self.sessions),
            "pending_forwards": len(self._pending),
            "waiting": len(self._waiting),
            "anomalies": self.journal.counts(),
            "stats": {
                "submits": s.submits,
                "forwarded": s.forwarded,
                "cached_replays": s.cached_replays,
                "moved": s.moved,
                "shed": s.shed,
                "forward_timeouts": s.forward_timeouts,
                "ledger_sent": s.ledger_sent,
                "ledger_applied": s.ledger_applied,
                "handoff_out_sessions": s.handoff_out_sessions,
                "handoff_in_sessions": s.handoff_in_sessions,
            },
        }

    async def _admin_call(
        self,
        peer: NodeId,
        kind: AdminKind,
        query: bytes,
        timeout: float,
    ) -> AdminResponse:
        self._admin_nonce += 1
        nonce = self._admin_nonce
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._admin_futs[nonce] = fut
        try:
            self._send(
                AdminRequest(kind=int(kind), nonce=nonce, query=query),
                peer,
            )
            resp = await asyncio.wait_for(fut, timeout)
            if resp.status != 0:
                raise RuntimeError(
                    f"admin {kind.name} to {peer.short()}: "
                    f"status={resp.status} {resp.body[:120]!r}"
                )
            return resp
        finally:
            self._admin_futs.pop(nonce, None)

    # -- send helpers -------------------------------------------------------

    def _send(self, payload, recipient: NodeId) -> None:
        msg = ProtocolMessage.new(self.node_id, payload, recipient)
        data = self.serializer.serialize(msg)
        try:
            self._net.send_to_nowait(recipient, data)
        except RabiaError:
            logger.warning(
                "fleet %s: send of %s to %s failed",
                self.config.name,
                type(payload).__name__,
                recipient.short(),
            )

    def _send_result(
        self,
        client_id: uuid.UUID,
        seq: int,
        status: int,
        payload: tuple[bytes, ...],
    ) -> None:
        # a client's transport identity IS NodeId(client_id); the net
        # routes to its newest connection (mux rebind on reconnect)
        self._send(
            Result(
                client_id=client_id, seq=seq, status=int(status),
                payload=tuple(payload),
            ),
            NodeId(client_id),
        )


# ---------------------------------------------------------------------------
# child protocol (testing/recovery.py shape): one fleet gateway per
# OS process, ready line on stdout, runs until SIGTERM
# ---------------------------------------------------------------------------


def _child_main(argv: list[str]) -> int:
    idx = int(argv[0])
    fleet_ports = json.loads(argv[1])  # one bind port per fleet member
    upstream_addrs = json.loads(argv[2])  # [[host, port], ...]
    n_shards = int(argv[3])
    extras = json.loads(argv[4]) if len(argv) > 4 else {}

    import os
    import threading

    parent = os.getppid()

    def orphan_watch() -> None:
        # a fleet gateway never outlives its harness: when the parent
        # dies without stop() (killed, or cut off at a time limit), exit
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(0)

    threading.Thread(target=orphan_watch, daemon=True).start()

    async def run() -> int:
        gw = FleetGateway(
            FleetGatewayConfig(
                name=f"gw{idx}",
                bind_port=int(fleet_ports[idx]),
                upstreams=tuple(
                    (str(h), int(p)) for h, p in upstream_addrs
                ),
                n_shards=n_shards,
                replication_factor=int(extras.get("rf", 2)),
                forward_timeout=float(extras.get("forward_timeout", 30.0)),
                # shard-group routing (fleet/groups.py): extras carry
                # the per-group upstream lanes + the GroupMap doc
                upstream_groups=tuple(
                    tuple((str(h), int(p)) for h, p in grp)
                    for grp in extras.get("upstream_groups", [])
                ),
                groups=extras.get("groups"),
            ),
            # deterministic ids so parents build the ring and MOVED
            # targets without a handshake (recovery.py's 1000+i idiom,
            # offset to keep the id spaces disjoint)
            node_id=NodeId.from_int(2000 + idx),
        )
        await gw.start()
        ring = HashRing()
        for j, port in enumerate(fleet_ports):
            ring.add(RingMember(
                name=f"gw{j}", host="127.0.0.1", port=int(port),
                node=NodeId.from_int(2000 + j),
            ))
        gw.adopt_ring(ring)
        print(
            json.dumps({
                "event": "ready",
                "pid": os.getpid(),
                "name": gw.config.name,
                "port": gw.port,
                "owned_shards": ring.owned_shards(gw.config.name, n_shards),
            }),
            flush=True,
        )
        await asyncio.Event().wait()  # until SIGTERM/SIGKILL
        return 0

    return asyncio.run(run())


if __name__ == "__main__":
    import sys

    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        sys.exit(_child_main(sys.argv[2:]))
    print(
        "usage: python -m rabia_tpu_torch.fleet.gateway_proc --child ... "
        "(spawned by fleet/harness.py FleetProcHarness)",
        file=sys.stderr,
    )
    sys.exit(2)
