"""RabiaClient: asyncio client library for the gateway protocol.

Talks to a :class:`~rabia_tpu_torch.gateway.server.GatewayServer` over the
native transport. The client's transport node id IS ``NodeId(client_id)``
— the gateway authenticates every frame's session against the
transport-level sender, and replies route back on the same identity
across reconnects.

Reliability model:

- every command gets a session-unique monotonically increasing ``seq``;
- unanswered frames are re-sent every ``retry_interval`` (the gateway's
  session table dedups, so re-sending is always safe);
- a lost connection is redialed transparently (rotating through the
  configured endpoints) and every pending seq is replayed after the
  hello handshake — committed commands come back from the session cache
  (``CACHED``) instead of re-applying;
- ``RETRY`` results (admission control) surface as
  :class:`BackpressureError` — a retryable ``StoreError`` — or are
  retried internally with backoff when ``retry_backpressure`` is on.

The port's copy of the reference's ``rabia_tpu/gateway/client.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import uuid
from typing import Iterable, Optional, Sequence

from rabia_tpu_torch.apps.kvstore import StoreError, StoreErrorKind
from rabia_tpu_torch.core.config import TcpNetworkConfig
from rabia_tpu_torch.core.errors import NetworkError, RabiaError, TimeoutError_
from rabia_tpu_torch.core.messages import (
    ClientHello,
    ProtocolMessage,
    ReadIndex,
    ReadIndexMode,
    Result,
    ResultStatus,
    Submit,
)
from rabia_tpu_torch.core.serialization import Serializer
from rabia_tpu_torch.core.types import NodeId, fast_uuid4
from rabia_tpu_torch.gateway.server import GatewayEndpoint

logger = logging.getLogger("rabia_tpu_torch.gateway.client")


class BackpressureError(StoreError):
    """The gateway shed this request (admission control). Retryable —
    back off and resubmit (same seq is safe; the session dedups)."""

    retryable = True

    def __init__(self, message: str = "") -> None:
        super().__init__(
            StoreErrorKind.StoreFull, message or "gateway backpressure"
        )


class GatewayError(RabiaError):
    """Terminal (non-retryable under the same seq) gateway-reported
    failure; retry semantically with a fresh command if appropriate."""


class _MuxLink:
    """Client side of the C transport's session-multiplex lane
    (net/tcp.MUX_MAGIC): one plain TCP connection handshaken with the
    mux magic id, every frame ``[u32 LE 16+len][16B session id]
    [payload]`` both ways. Duck-types the slice of the TcpNetwork
    surface RabiaClient uses (add_peer / send_to_nowait / receive /
    get_connected_nodes / close), so the client's retry/redial machinery
    is transport-agnostic. The session id IS the client's node id — the
    gateway authenticates every frame against it, and the transport
    rebinds the session to the NEWEST connection carrying it (latest
    binding wins), which is exactly what makes redial rebinding work:
    a reconnected client's first frame reroutes all replies here.

    The wire contract (MUX_MAGIC handshake + per-frame session-id
    prefix) is owned by transport.cpp; the OTHER client-side speaker is
    :class:`rabia_tpu_torch.testing.loadsession.MuxConn` (a shared-connection
    pool for thousands of loadgen sessions — a different shape from this
    single-session link, hence two speakers of one 3-line framing)."""

    def __init__(self, node_id: NodeId) -> None:
        self.node_id = node_id
        self._sid = node_id.value.bytes
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._gateway: Optional[NodeId] = None
        self._q: asyncio.Queue = asyncio.Queue()
        self._dial_task: Optional[asyncio.Task] = None
        self._read_task: Optional[asyncio.Task] = None
        self._target: Optional[tuple[str, int]] = None
        self._dead = False

    def add_peer(self, peer: NodeId, host: str, port: int) -> None:
        # `peer` is advisory (the endpoint's configured id): the live
        # identity comes back in the handshake
        self._target = (host, port)
        self._dial_task = asyncio.ensure_future(self._dial())

    async def _dial(self) -> None:
        from rabia_tpu_torch.net.tcp import MUX_MAGIC

        try:
            host, port = self._target  # type: ignore[misc]
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(MUX_MAGIC)
            gw = await reader.readexactly(16)
            self._gateway = NodeId(uuid.UUID(bytes=gw))
            self.reader, self.writer = reader, writer
            self._read_task = asyncio.ensure_future(self._read_loop())
        except Exception:
            self._dead = True

    async def _read_loop(self) -> None:
        try:
            while True:
                hdr = await self.reader.readexactly(4)
                (ln,) = struct.unpack("<I", hdr)
                data = await self.reader.readexactly(ln)
                if ln < 16 or data[:16] != self._sid:
                    continue  # another session's frame (never ours to see)
                self._q.put_nowait((self._gateway, data[16:]))
        except (asyncio.IncompleteReadError, asyncio.CancelledError,
                ConnectionError, OSError):
            self._dead = True

    def send_to_nowait(self, recipient: NodeId, data: bytes) -> bool:
        w = self.writer
        if w is None or self._dead:
            return False  # the hello/retry loops re-send after connect
        try:
            w.write(struct.pack("<I", 16 + len(data)) + self._sid + data)
        except Exception:
            self._dead = True
            return False
        return True

    async def receive(self, timeout: Optional[float] = None):
        if timeout is None:
            return await self._q.get()
        try:
            return await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            raise TimeoutError_("mux receive", timeout) from None

    async def get_connected_nodes(self) -> set[NodeId]:
        if self._dead or self._gateway is None or self.writer is None:
            return set()
        if self.writer.is_closing():
            return set()
        return {self._gateway}

    async def close(self) -> None:
        for t in (self._dial_task, self._read_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        if self.writer is not None:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:
                pass
        self.writer = None


class RabiaClient:
    """Exactly-once client over the gateway protocol (see module doc)."""

    def __init__(
        self,
        endpoints: Sequence[GatewayEndpoint],
        client_id: Optional[uuid.UUID] = None,
        max_inflight: int = 0,
        call_timeout: float = 15.0,
        retry_interval: float = 0.5,
        retry_backpressure: bool = True,
        backpressure_base_delay: float = 0.02,
        max_backpressure_retries: int = 200,
        mux: bool = False,
    ) -> None:
        if not endpoints:
            raise ValueError("at least one gateway endpoint required")
        self.endpoints = list(endpoints)
        # opt-in session-mux lane: ride the C transport's multiplexed
        # connection class (one plain socket + the MUX_MAGIC handshake)
        # instead of a private native transport instance per client —
        # the 10^4-clients-per-host deployment shape. Exactly-once
        # semantics are unchanged: the session id stays the client id,
        # redials rebind the session to the newest connection.
        self.mux = bool(mux)
        self.client_id = client_id or fast_uuid4()
        self.node_id = NodeId(self.client_id)
        self.call_timeout = call_timeout
        self.retry_interval = retry_interval
        self.retry_backpressure = retry_backpressure
        self.backpressure_base_delay = backpressure_base_delay
        self.max_backpressure_retries = max_backpressure_retries
        self.max_inflight = max_inflight
        self.serializer = Serializer()
        self._net = None
        self._recv_task = None
        self._endpoint_idx = 0
        self._gateway: Optional[GatewayEndpoint] = None
        self._seq = 0
        self._ack_upto = 0  # highest contiguously acknowledged seq
        self._acked: set[int] = set()
        self._pending: dict[int, tuple[asyncio.Future, object]] = {}
        self._hello_fut: Optional[asyncio.Future] = None
        self.server_window = 0
        self.server_last_seq = 0
        self.reconnects = 0
        self.cached_replies = 0  # results answered from the session cache
        self.moved_redirects = 0  # fleet MOVED redirects followed
        self._conn_lock = asyncio.Lock()

    # -- connection management ---------------------------------------------

    async def connect(self, timeout: float = 5.0) -> None:
        """Dial a gateway and complete the session handshake, rotating
        through the configured endpoints until one answers. A no-op when
        the current link is already live (so N concurrent calls that all
        noticed the same dead link trigger ONE redial, not N)."""
        async with self._conn_lock:
            if await self._link_alive():
                return
            await self._connect_locked(timeout)

    async def _connect_locked(self, timeout: float) -> None:
        from rabia_tpu_torch.net.tcp import TcpNetwork

        last_err: Optional[Exception] = None
        for _ in range(len(self.endpoints)):
            ep = self.endpoints[self._endpoint_idx % len(self.endpoints)]
            self._endpoint_idx += 1
            await self._teardown_net()
            try:
                if self.mux:
                    self._net = _MuxLink(self.node_id)
                else:
                    self._net = TcpNetwork(
                        self.node_id, TcpNetworkConfig(bind_port=0)
                    )
                self._net.add_peer(ep.node_id, ep.host, ep.port)
                self._recv_task = asyncio.ensure_future(self._recv_loop())
                self._hello_fut = asyncio.get_event_loop().create_future()
                deadline = asyncio.get_event_loop().time() + timeout
                # re-send the hello until the ack lands (the dial itself
                # is async inside the native transport)
                while True:
                    self._send(
                        ClientHello(
                            client_id=self.client_id,
                            max_inflight=self.max_inflight,
                        ),
                        ep.node_id,
                    )
                    left = deadline - asyncio.get_event_loop().time()
                    if left <= 0:
                        raise TimeoutError_("gateway hello", timeout)
                    try:
                        await asyncio.wait_for(
                            asyncio.shield(self._hello_fut),
                            min(left, 0.25),
                        )
                        break
                    except asyncio.TimeoutError:
                        continue
                self._gateway = ep
                # replay everything unanswered, in seq order — the
                # gateway session dedups anything that already committed
                for seq in sorted(self._pending):
                    self._send_pending(seq)
                return
            except (RabiaError, OSError) as e:
                last_err = e
                continue
        await self._teardown_net()
        raise NetworkError(f"no gateway reachable: {last_err}")

    async def _teardown_net(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
            self._recv_task = None
        if self._net is not None:
            try:
                await self._net.close()
            except Exception:
                pass
            self._net = None

    async def close(self) -> None:
        async with self._conn_lock:
            await self._teardown_net()
            for fut, _ in self._pending.values():
                if not fut.done():
                    fut.cancel()
            self._pending.clear()

    async def _reconnect(self) -> None:
        self.reconnects += 1
        await self.connect()

    def _connected(self) -> bool:
        return self._net is not None and self._gateway is not None

    # -- wire ---------------------------------------------------------------

    def _send(self, payload, recipient: NodeId) -> None:
        if self._net is None:
            return
        msg = ProtocolMessage.new(self.node_id, payload, recipient)
        try:
            self._net.send_to_nowait(
                recipient, self.serializer.serialize(msg)
            )
        except RabiaError:
            pass  # best-effort; the retry loop re-sends

    def _send_pending(self, seq: int) -> None:
        entry = self._pending.get(seq)
        if entry is not None and self._gateway is not None:
            self._send(entry[1], self._gateway.node_id)

    async def _recv_loop(self) -> None:
        net = self._net
        while True:
            try:
                sender, data = await net.receive()
            except asyncio.CancelledError:
                return
            except RabiaError:
                return  # transport closed under us; reconnect handles it
            try:
                msg = self.serializer.deserialize(data)
            except RabiaError:
                continue
            p = msg.payload
            if isinstance(p, ClientHello) and p.ack:
                self.server_window = p.max_inflight
                self.server_last_seq = p.last_seq
                if self._hello_fut is not None and not self._hello_fut.done():
                    self._hello_fut.set_result(p)
            elif isinstance(p, Result):
                if p.status == ResultStatus.CACHED:
                    self.cached_replies += 1
                entry = self._pending.get(p.seq)
                if entry is not None and not entry[0].done():
                    entry[0].set_result(p)

    # -- request machinery --------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _ack(self, seq: int) -> None:
        """Advance the contiguous ack frontier (the gateway GC hint)."""
        self._acked.add(seq)
        while (self._ack_upto + 1) in self._acked:
            self._ack_upto += 1
            self._acked.discard(self._ack_upto)

    async def _call(self, seq: int, frame) -> Result:
        """Send, await the Result, re-send on silence, reconnect on a
        dead link — until the call timeout."""
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending[seq] = (fut, frame)
        deadline = loop.time() + self.call_timeout
        try:
            self._send_pending(seq)
            while True:
                left = deadline - loop.time()
                if left <= 0:
                    raise TimeoutError_(f"gateway call seq={seq}",
                                        self.call_timeout)
                try:
                    return await asyncio.wait_for(
                        asyncio.shield(fut), min(left, self.retry_interval)
                    )
                except asyncio.TimeoutError:
                    if fut.done():
                        return fut.result()
                    # silence: maybe a lost frame, maybe a dead link
                    if not await self._link_alive():
                        try:
                            await self._reconnect()  # replays all pending
                        except NetworkError:
                            continue  # next cycle tries again
                    else:
                        self._send_pending(seq)
        finally:
            self._pending.pop(seq, None)

    async def _redirect(self, res: Result) -> None:
        """Follow a fleet-tier ``MOVED`` redirect: the payload names the
        shard's owning gateway (``b"host:port"``, 16-byte node id). The
        owner moves to the front of the endpoint rotation and the link
        redials it; the caller then re-sends the SAME seq there —
        exactly-once holds because the redirecting gateway reserved and
        proposed nothing (docs/FLEET.md)."""
        host, _, port = res.payload[0].decode().rpartition(":")
        node = (
            NodeId(uuid.UUID(bytes=bytes(res.payload[1])))
            if len(res.payload) > 1 and len(res.payload[1]) == 16
            else NodeId(fast_uuid4())  # transport learns the real id
        )
        ep = GatewayEndpoint(node_id=node, host=host, port=int(port))
        self.moved_redirects += 1
        async with self._conn_lock:
            self.endpoints = [ep] + [
                e for e in self.endpoints
                if (e.host, e.port) != (ep.host, ep.port)
            ]
            self._endpoint_idx = 0
            self._gateway = None
            await self._teardown_net()
            await self._connect_locked(5.0)

    async def _link_alive(self) -> bool:
        if self._net is None or self._gateway is None:
            return False
        try:
            connected = await self._net.get_connected_nodes()
        except Exception:
            return False
        return self._gateway.node_id in connected

    # -- public API ---------------------------------------------------------

    async def submit(
        self, shard: int, commands: Iterable[bytes]
    ) -> list[bytes]:
        """Propose a command batch on ``shard`` with exactly-once
        semantics; returns the committed per-command responses."""
        seq = self._next_seq()
        cmds = tuple(
            c if isinstance(c, bytes) else bytes(c) for c in commands
        )
        attempts = 0
        redirects = 0
        while True:
            frame = Submit(
                client_id=self.client_id,
                seq=seq,
                shard=shard,
                commands=cmds,
                ack_upto=self._ack_upto,
            )
            res = await self._call(seq, frame)
            if res.status in (ResultStatus.OK, ResultStatus.CACHED):
                self._ack(seq)
                return list(res.payload)
            if res.status == ResultStatus.MOVED:
                redirects += 1
                if redirects > 8:
                    raise GatewayError(
                        f"shard {shard}: MOVED redirect loop"
                    )
                await self._redirect(res)
                continue  # same seq to the named owner
            if res.status == ResultStatus.RETRY:
                attempts += 1
                if (
                    not self.retry_backpressure
                    or attempts > self.max_backpressure_retries
                ):
                    raise BackpressureError(
                        res.payload[0].decode() if res.payload else ""
                    )
                await asyncio.sleep(
                    min(1.0, self.backpressure_base_delay * attempts)
                )
                continue
            self._ack(seq)
            raise GatewayError(
                res.payload[0].decode() if res.payload else "gateway error"
            )

    async def get(self, shard: int, key: bytes | str) -> bytes:
        """Linearizable read: the gateway serves it via read-index against
        the decided frontier — no consensus slot is consumed. Returns the
        store's encoded result frame (see
        :func:`rabia_tpu_torch.apps.kvstore.decode_result_bin`)."""
        seq = self._next_seq()
        kb = key.encode() if isinstance(key, str) else bytes(key)
        attempts = 0
        redirects = 0
        while True:
            frame = ReadIndex(
                mode=int(ReadIndexMode.READ),
                client_id=self.client_id,
                seq=seq,
                shard=shard,
                key=kb,
            )
            res = await self._call(seq, frame)
            if res.status in (ResultStatus.OK, ResultStatus.CACHED):
                # reads are not cached gateway-side, but their seqs share
                # the session counter: ack them too or the contiguous ack
                # frontier (the gateway's GC hint) stalls at the first
                # read forever
                self._ack(seq)
                return res.payload[0] if res.payload else b""
            if res.status == ResultStatus.MOVED:
                redirects += 1
                if redirects > 8:
                    raise GatewayError(
                        f"shard {shard}: MOVED redirect loop"
                    )
                await self._redirect(res)
                continue  # same seq to the named owner
            if res.status == ResultStatus.RETRY:
                attempts += 1
                if (
                    not self.retry_backpressure
                    or attempts > self.max_backpressure_retries
                ):
                    raise BackpressureError(
                        res.payload[0].decode() if res.payload else ""
                    )
                await asyncio.sleep(
                    min(1.0, self.backpressure_base_delay * attempts)
                )
                continue
            self._ack(seq)
            raise GatewayError(
                res.payload[0].decode() if res.payload else "gateway error"
            )


# ---------------------------------------------------------------------------
# Ops tooling: framed admin fetch (the ops CLI's `stats` path)
# ---------------------------------------------------------------------------


async def admin_fetch_timed(
    host: str,
    port: int,
    kind: int = 0,
    timeout: float = 10.0,
    query: bytes = b"",
) -> tuple[bytes, float, float]:
    """Fetch one admin document (metrics / health / journal / trace —
    see :class:`~rabia_tpu_torch.core.messages.AdminKind`) from a gateway's
    native transport, knowing only ``host:port``. Returns
    ``(body, send_wall, recv_wall)`` where the wall times bracket the
    answered request round trip on THIS process's clock — the trace
    collector's clock-alignment input (offset = RTT midpoint, error
    bound ±RTT/2; see obs/flight.align_slice).

    The framed transport normally needs the peer's node id up front; ops
    tooling has only an address. The trick: dial under a PLACEHOLDER peer
    id — the handshake exchanges real 16-byte ids regardless, so the
    established connection comes up keyed by the gateway's actual id,
    which ``get_connected_nodes`` then reveals. The placeholder peer
    entry is removed right after (stopping its redial scan) and the
    request rides the discovered identity.
    """
    import time as _time

    from rabia_tpu_torch.core.messages import AdminRequest, AdminResponse
    from rabia_tpu_torch.net.tcp import TcpNetwork

    net = TcpNetwork(NodeId(fast_uuid4()), TcpNetworkConfig(bind_port=0))
    try:
        placeholder = NodeId(fast_uuid4())
        net.add_peer(placeholder, host, port)
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        gw: Optional[NodeId] = None
        while loop.time() < deadline:
            conn = await net.get_connected_nodes()
            if conn:
                gw = next(iter(conn))
                break
            await asyncio.sleep(0.02)
        if gw is None:
            raise TimeoutError_("admin fetch: gateway handshake", timeout)
        net.remove_peer(placeholder)  # our live conn is keyed by gw's id
        ser = Serializer()
        nonce = 1
        req = ser.serialize(
            ProtocolMessage.new(
                net.node_id,
                AdminRequest(kind=int(kind), nonce=nonce, query=query),
                gw,
            )
        )
        last_send = 0.0
        send_wall = 0.0
        while True:
            now = loop.time()
            if now >= deadline:
                raise TimeoutError_("admin fetch: response", timeout)
            if now - last_send >= 1.0:  # re-send over a racing establish
                if not send_wall:
                    # bracket from the FIRST send: a late response to an
                    # earlier send must widen err_s (conservative), never
                    # tighten it around the wrong serve time
                    send_wall = _time.time()
                net.send_to_nowait(gw, req)
                last_send = now
            try:
                sender, data = await net.receive(
                    timeout=min(0.25, deadline - now)
                )
            except (TimeoutError_, NetworkError):
                continue
            try:
                msg = ser.deserialize(data)
            except RabiaError:
                continue
            p = msg.payload
            if isinstance(p, AdminResponse) and p.nonce == nonce:
                if p.status != 0:
                    raise GatewayError(
                        p.body.decode(errors="replace") or "admin error"
                    )
                return p.body, send_wall, _time.time()
    finally:
        await net.close()


async def admin_fetch(
    host: str,
    port: int,
    kind: int = 0,
    timeout: float = 10.0,
    query: bytes = b"",
) -> bytes:
    """:func:`admin_fetch_timed` without the RTT bracket (the
    the ops CLI's `stats` path)."""
    body, _, _ = await admin_fetch_timed(
        host, port, kind, timeout=timeout, query=query
    )
    return body
