"""Protocol-faithful simulated client sessions over plain asyncio sockets.

One process can hold thousands of concurrent gateway sessions honestly
only if a session costs a dict entry, not a native transport instance —
these classes implement the gateway wire protocol (16-byte node-id
handshake or the MUX_MAGIC session-mux lane, then ``[u32 LE length]
[payload]`` frames) directly on ``asyncio.open_connection``. Used by
the gateway tests (tests/test_torch_gateway.py), the chaos plane's
real-TCP fabrics (rabia_tpu_torch/chaos/runner.py) and the fleet tier's
sessions (rabia_tpu_torch/fleet/harness.py).

The mux wire contract (one socket, frames prefixed with a 16-byte
session id both ways) is defined by the C transport —
``rabia_tpu_torch/net/tcp.py`` ``MUX_MAGIC`` and transport.cpp's mux path;
:class:`MuxConn` here and ``gateway/client._MuxLink`` are the two
client-side speakers of that contract.

The port's copy of the reference's ``rabia_tpu/testing/loadsession.py``,
its imports retargeted to ``rabia_tpu_torch``. Unlike the reference's, a
connection that closes (its gateway died, or the pool dropped it) fails
every request waiting on it and refuses new ones with
:class:`ConnectionError`, so a caller fails over at once instead of
waiting out its call timeout on a dead socket.
"""

from __future__ import annotations

import asyncio
import struct
import uuid
from typing import Optional, Sequence

from rabia_tpu_torch.core.messages import (
    ClientHello,
    ProtocolMessage,
    ReadIndex,
    ReadIndexMode,
    Result,
    Submit,
)
from rabia_tpu_torch.core.serialization import Serializer
from rabia_tpu_torch.core.types import NodeId

__all__ = ["LoadSession", "MuxConn"]


class LoadSession:
    """One protocol-faithful simulated RabiaClient session.

    Speaks the native transport wire protocol directly: 16-byte node-id
    handshake (the session's client_id IS its transport identity — the
    gateway authenticates every frame against it), then
    ``[u32 LE length][payload]`` frames. No retransmit machinery: the
    link is TCP and the gateway answers every Submit (sheds answer
    immediately), so a missing Result inside the call timeout is scored
    as ``timeout`` — exactly the client-observed SLO violation an
    open-loop run is supposed to surface.

    Two transports: a DIRECT connection per session (the pre-mux shape:
    one socket + one reader task each), or a shared :class:`MuxConn`
    (the C transport's session-multiplex lane: thousands of sessions
    over a handful of sockets — the 10^4+ scale lane, since one process
    cannot hold 10^4 sockets + reader tasks honestly)."""

    __slots__ = (
        "client_id", "node_id", "ser", "reader", "writer", "gateway",
        "_seq", "pending", "_read_task", "_hello", "_mux",
    )

    def __init__(
        self, ser: Serializer, client_id: Optional[uuid.UUID] = None
    ) -> None:
        # an explicit client_id re-speaks an EXISTING session identity
        # over a new connection — the fleet tier's MOVED-following
        # client redials a different gateway mid-session with it
        self.client_id = client_id or uuid.uuid4()
        self.node_id = NodeId(self.client_id)
        self.ser = ser
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.gateway: Optional[NodeId] = None
        self._seq = 0
        self.pending: dict[int, asyncio.Future] = {}
        self._read_task: Optional[asyncio.Task] = None
        self._hello: Optional[asyncio.Future] = None
        self._mux: Optional["MuxConn"] = None

    async def connect(self, host: str, port: int, timeout: float = 10.0):
        self.reader, self.writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout
        )
        self.writer.write(self.client_id.bytes)
        peer = await asyncio.wait_for(self.reader.readexactly(16), timeout)
        self.gateway = NodeId(uuid.UUID(bytes=peer))
        self._read_task = asyncio.ensure_future(self._read_loop())
        await self._hello_handshake(timeout, f"{host}:{port}")
        return self

    async def connect_mux(self, mux: "MuxConn", timeout: float = 10.0):
        """Attach to an already-connected mux conn and run the session
        hello handshake over it."""
        self._mux = mux
        self.gateway = mux.gateway
        mux.sessions[self.client_id.bytes] = self
        await self._hello_handshake(timeout, mux.where)
        return self

    async def _hello_handshake(self, timeout: float, where: str) -> None:
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while True:
            self._hello = loop.create_future()
            self._send(ClientHello(client_id=self.client_id))
            try:
                await asyncio.wait_for(
                    self._hello, min(0.5, max(0.05, deadline - loop.time()))
                )
                return
            except asyncio.TimeoutError:
                if loop.time() >= deadline:
                    raise TimeoutError(
                        f"session hello to {where} timed out"
                    ) from None

    @property
    def alive(self) -> bool:
        """Whether the connection can still carry a request."""
        if self._mux is not None:
            return not self._mux.closed
        return (
            self.writer is not None
            and not self.writer.is_closing()
            and self._read_task is not None
            and not self._read_task.done()
        )

    def _send(self, payload) -> None:
        if not self.alive:
            raise ConnectionError("session connection closed")
        data = self.ser.serialize(
            ProtocolMessage.new(self.node_id, payload, self.gateway)
        )
        if self._mux is not None:
            self._mux.send(self.client_id.bytes, data)
        else:
            self.writer.write(struct.pack("<I", len(data)) + data)

    def _fail_pending(self, exc: BaseException) -> None:
        """The connection is gone: every waiting request (and a hello in
        flight) fails now rather than at its timeout."""
        waiting = list(self.pending.values())
        if self._hello is not None:
            waiting.append(self._hello)
        for fut in waiting:
            if not fut.done():
                fut.set_exception(exc)
                # a waiter that gave up already is not told: no
                # "exception was never retrieved" for it
                fut.exception()

    def _on_payload(self, p) -> None:
        if isinstance(p, ClientHello) and p.ack:
            if self._hello is not None and not self._hello.done():
                self._hello.set_result(p)
        elif isinstance(p, Result):
            fut = self.pending.get(p.seq)
            if fut is not None and not fut.done():
                fut.set_result(p)

    async def _read_loop(self) -> None:
        try:
            while True:
                hdr = await self.reader.readexactly(4)
                (ln,) = struct.unpack("<I", hdr)
                data = await self.reader.readexactly(ln)
                try:
                    msg = self.ser.deserialize(data)
                except Exception:
                    continue
                self._on_payload(msg.payload)
        except (asyncio.IncompleteReadError, asyncio.CancelledError,
                ConnectionError, OSError):
            return
        finally:
            self._fail_pending(ConnectionError("session connection closed"))

    async def submit(
        self, shard: int, commands: Sequence[bytes], timeout: float
    ) -> Result:
        self._seq += 1
        return await self.submit_seq(self._seq, shard, commands, timeout)

    async def submit_seq(
        self, seq: int, shard: int, commands: Sequence[bytes],
        timeout: float,
    ) -> Result:
        """Submit under an EXPLICIT seq — the replay/redirect lane: a
        MOVED-following or failover-retrying client re-sends the SAME
        seq on a different connection and the session tables dedup it."""
        if seq > self._seq:
            self._seq = seq
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self.pending[seq] = fut
        try:
            self._send(
                Submit(
                    client_id=self.client_id, seq=seq, shard=shard,
                    commands=tuple(commands), ack_upto=max(0, seq - 64),
                )
            )
            return await asyncio.wait_for(fut, timeout)
        finally:
            self.pending.pop(seq, None)

    async def read(self, shard: int, key: bytes, timeout: float) -> Result:
        """Linearizable GET through the gateway's read-index lane
        (``ReadIndexMode.READ``): served from a shared frontier probe
        round — ZERO consensus slots consumed — with the result framed
        byte-identically to a committed GET. A RETRY status (probe
        timeout, quorum loss) is the caller's signal to fall back to a
        consensus-slot GET submit."""
        self._seq += 1
        seq = self._seq
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self.pending[seq] = fut
        try:
            self._send(
                ReadIndex(
                    mode=int(ReadIndexMode.READ),
                    client_id=self.client_id, seq=seq,
                    shard=shard, key=key,
                )
            )
            return await asyncio.wait_for(fut, timeout)
        finally:
            self.pending.pop(seq, None)

    async def close(self) -> None:
        if self._mux is not None:
            self._mux.sessions.pop(self.client_id.bytes, None)
            self._mux = None
            return  # the pool closes the shared conn
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except (asyncio.CancelledError, Exception):
                pass
        if self.writer is not None:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:
                pass


class MuxConn:
    """One session-multiplexed connection to a gateway (the C
    transport's mux lane, net/tcp.MUX_MAGIC): handshakes with the mux
    magic id, then every frame is ``[u32 LE 16+len][16B session id]
    [payload]`` in both directions. One reader task serves every session
    bound here — the loadgen cost of a session drops from (socket +
    reader task) to a dict entry."""

    def __init__(self, ser: Serializer) -> None:
        self.ser = ser
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.gateway: Optional[NodeId] = None
        self.sessions: dict[bytes, LoadSession] = {}
        self.where = "?"
        self._read_task: Optional[asyncio.Task] = None
        self.closed = False

    async def connect(self, host: str, port: int, timeout: float = 10.0):
        from rabia_tpu_torch.net.tcp import MUX_MAGIC

        self.where = f"{host}:{port}(mux)"
        self.reader, self.writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout
        )
        self.writer.write(MUX_MAGIC)
        peer = await asyncio.wait_for(self.reader.readexactly(16), timeout)
        self.gateway = NodeId(uuid.UUID(bytes=peer))
        self._read_task = asyncio.ensure_future(self._read_loop())
        return self

    def send(self, session_id: bytes, data: bytes) -> None:
        if self.closed or self.writer.is_closing():
            self._mark_closed()
            raise ConnectionError(f"mux connection {self.where} closed")
        self.writer.write(
            struct.pack("<I", 16 + len(data)) + session_id + data
        )

    async def _read_loop(self) -> None:
        try:
            while True:
                hdr = await self.reader.readexactly(4)
                (ln,) = struct.unpack("<I", hdr)
                data = await self.reader.readexactly(ln)
                if ln < 16:
                    continue
                sess = self.sessions.get(data[:16])
                if sess is None:
                    continue
                try:
                    msg = self.ser.deserialize(data[16:])
                except Exception:
                    continue
                sess._on_payload(msg.payload)
        except (asyncio.IncompleteReadError, asyncio.CancelledError,
                ConnectionError, OSError):
            return
        finally:
            self._mark_closed()

    def _mark_closed(self) -> None:
        """The shared socket is gone: every bound session's waiting
        requests fail now, and later sends raise."""
        if self.closed:
            return
        self.closed = True
        exc = ConnectionError(f"mux connection {self.where} closed")
        for sess in list(self.sessions.values()):
            sess._fail_pending(exc)

    async def close(self) -> None:
        self._mark_closed()
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except (asyncio.CancelledError, Exception):
                pass
        if self.writer is not None:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:
                pass


