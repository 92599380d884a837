"""TcpNetwork: the production transport over the C++ epoll data plane.

The port's copy of the reference's ``rabia_tpu/net/tcp.py``, over the
port's own build of ``transport.cpp`` (:mod:`rabia_tpu_torch.native`).

Reference parity: rabia-engine/src/network/tcp.rs (C17) — but the
framing/handshake/reconnect machinery lives in native code
(rabia_tpu_torch/native/transport.cpp) with zero Python in the io path; this
module is the asyncio bridge implementing
:class:`~rabia_tpu_torch.core.network.NetworkTransport`:

- a reader thread blocks in the native `rt_recv` and pushes frames into a
  plain deque (the engine's hot drain is ``receive_nowait``); the asyncio
  loop is woken via ``call_soon_threadsafe`` at most ONCE per pending
  batch, not once per frame — per-frame wakeups write the loop's self-pipe
  and measurably dominate a 16384-shard profile;
- sends/broadcasts frame once into the native outbound staging queue —
  the returned awaitables complete immediately (the reference's unbounded
  outbound queues, tcp.rs:559-643, behave the same way) and never contend
  with the io thread's syscalls.
"""

from __future__ import annotations

import asyncio
import collections
import ctypes
import os
import threading
from typing import Optional

import numpy as np

from rabia_tpu_torch.core.config import TcpNetworkConfig
from rabia_tpu_torch.core.errors import NetworkError, TimeoutError_
from rabia_tpu_torch.core.network import NetworkTransport
from rabia_tpu_torch.core.types import NodeId
from rabia_tpu_torch.native import load_library

_RECV_BUF_CAP = 16 * 1024 * 1024  # matches the native 16MiB frame cap

# Session-multiplex handshake id (transport.cpp kMuxMagic): a connection
# that handshakes with this 16-byte id carries MANY sessions — every
# frame is prefixed with a 16-byte session id inside the payload
# (inbound: the prefix becomes the sender; outbound: rt_send to a bound
# session id wraps the frame with it). Client-side speakers (the loadgen
# mux lane) dial plain TCP, send MUX_MAGIC, then frame as
# [u32 LE 16+len][session id][payload].
MUX_MAGIC = bytes([0xF5]) + b"RABIA-MUX" + bytes([0xF5] * 6)
assert len(MUX_MAGIC) == 16

# Names of the native transport's observability counter block, in RTC_*
# index order (transport.cpp). Versioned append-only: a newer library may
# expose more (ignored here), an older one fewer (read as 0).
RT_COUNTER_NAMES = (
    "frames_in",
    "bytes_in",
    "frames_out",
    "bytes_out",
    "inbox_dropped",
    "out_pool_hits",
    "out_pool_misses",
    "in_pool_hits",
    "in_pool_misses",
    "arena_borrows",
    "dials",
    "conns_established",
    "conns_closed",
    # chaos shaping layer (RTC v2)
    "shape_dropped",
    "shape_delayed",
    # thread-per-shard-group inbox routing (RTC v3)
    "group_frames",
    "group_copies",
)


def _id_bytes(node: NodeId) -> bytes:
    return node.value.bytes


class _BorrowedFrame:
    """Zero-copy view over an inbound frame still owned by the native
    transport's buffer arena (SURVEY §7.4.7 handoff, step 0: no memcpy
    between the io thread's landing buffer and the codec
    consumer). ``view`` aliases C memory — it is only valid until
    ``release()``, which returns the buffer to the arena (idempotent;
    also safe after transport close, where it is a no-op)."""

    __slots__ = ("_owner", "_token", "addr", "view")

    def __init__(self, owner: "TcpNetwork", token: int, addr: int, n: int):
        self._owner = owner
        self._token = token
        self.addr = addr  # the arena address the C side reported
        self.view = memoryview(
            (ctypes.c_uint8 * n).from_address(addr)
        ).cast("B") if n else memoryview(b"")

    def release(self) -> None:
        tok, self._token = self._token, 0
        if tok:
            self.view = memoryview(b"")  # drop the alias before the free
            self._owner._release_token(tok)

    def to_bytes(self) -> bytes:
        data = bytes(self.view)
        self.release()
        return data

    def __del__(self):  # leak guard: a dropped frame must not pin its arena
        try:
            self.release()
        except Exception:
            pass


class TcpNetwork(NetworkTransport):
    """Async transport facade over the native epoll loop."""

    def __init__(
        self,
        node_id: NodeId,
        config: Optional[TcpNetworkConfig] = None,
    ) -> None:
        self.node_id = node_id
        self.config = config or TcpNetworkConfig()
        self._lib = load_library()
        actual = ctypes.c_uint16(0)
        self_id = (ctypes.c_uint8 * 16).from_buffer_copy(_id_bytes(node_id))
        self._handle = self._lib.rt_create(
            self_id,
            self.config.bind_host.encode(),
            self.config.bind_port,
            ctypes.byref(actual),
        )
        if not self._handle:
            raise NetworkError(
                f"cannot bind {self.config.bind_host}:{self.config.bind_port}"
            )
        self.port: int = actual.value
        # frame handoff: deque appends are GIL-atomic, so the engine's
        # receive_nowait drain never crosses the asyncio machinery at all;
        # _data_ready only serves the blocking receive() path
        self._pending: collections.deque[tuple[NodeId, bytes]] = (
            collections.deque()
        )
        self._data_ready = asyncio.Event()
        self._wake_scheduled = False
        self._recv_notify = None  # wake-on-inbox hook (set_receive_notify)
        # must be the RUNNING loop: the reader thread posts into it with
        # call_soon_threadsafe; a get_event_loop()-created orphan loop would
        # swallow frames forever. Constructing outside async context is an
        # error (RuntimeError), not a silent hang.
        self._loop = asyncio.get_running_loop()
        self._closed = False
        # counter state frozen at close (late scrapes read these instead
        # of the freed native Transport)
        self._final_ctrs: dict[str, int] = {}
        self._final_out_pool: tuple[int, int] = (0, 0)
        from rabia_tpu_torch.obs.flight import TF_DTYPE

        self._final_flight = np.zeros(0, TF_DTYPE)
        self._recv_buf = (ctypes.c_uint8 * _RECV_BUF_CAP)()
        self._sender_buf = (ctypes.c_uint8 * 16)()
        # zero-copy recv (the borrow API) unless explicitly disabled
        self._zero_copy = not os.environ.get("RABIA_NO_ZERO_COPY_RECV")
        self._reader_detached = False
        self._reader = threading.Thread(target=self._reader_loop, daemon=True)
        self._reader.start()

    # -- peers --------------------------------------------------------------

    def add_peer(self, peer: NodeId, host: str, port: int) -> None:
        pid = (ctypes.c_uint8 * 16).from_buffer_copy(_id_bytes(peer))
        self._lib.rt_add_peer(self._handle, pid, host.encode(), port)

    def remove_peer(self, peer: NodeId) -> None:
        pid = (ctypes.c_uint8 * 16).from_buffer_copy(_id_bytes(peer))
        self._lib.rt_remove_peer(self._handle, pid)

    # -- chaos shaping (adverse-network scenario engine) --------------------

    def set_peer_shaping(
        self,
        peer: NodeId,
        delay_ms: float = 0.0,
        jitter_ms: float = 0.0,
        drop_rate: float = 0.0,
        seed: int = 0,
    ) -> None:
        """Inject outbound delay (+/- jitter) and drop probability on
        THIS transport's link to ``peer``, applied inside the native io
        loop — the real epoll/TCP path carries the shaped traffic, so
        chaos profiles exercise the production C runtime. Asymmetric by
        construction: shape one endpoint to impair one direction. All
        zeros clears the peer's shaping."""
        h = self._handle
        if not h:
            return
        pid = (ctypes.c_uint8 * 16).from_buffer_copy(_id_bytes(peer))
        self._lib.rt_set_shaping(
            h, pid,
            int(max(0.0, delay_ms) * 1000),
            int(max(0.0, jitter_ms) * 1000),
            float(drop_rate),
            seed & 0xFFFFFFFFFFFFFFFF,
        )

    def clear_shaping(self) -> None:
        """Remove every per-peer shaping entry (already-delayed frames
        still deliver at their due times)."""
        h = self._handle
        if h:
            self._lib.rt_clear_shaping(h)

    # -- reader bridge ------------------------------------------------------

    def detach_reader(self) -> None:
        """Hand exclusive inbox ownership to a native consumer (the
        engine's GIL-free runtime thread, engine/runtime_bridge.py):
        stop the Python reader thread so the two never steal each
        other's frames. Frames it already pulled into the pending queue
        stay drainable through the receive_* surface; the caller drains
        them before the native consumer starts."""
        self._reader_detached = True
        if self._handle:
            self._lib.rt_inbox_kick(self._handle)
        if self._reader.is_alive():
            self._reader.join(timeout=2.0)
            if self._reader.is_alive():
                # a reader that outlives the join would keep pulling
                # frames into the pending queue nothing drains once the
                # native consumer starts — silently losing votes. The
                # caller treats runtime start failure as fatal; failing
                # here is strictly better than racing the inbox.
                self._reader_detached = False
                raise RuntimeError(
                    "transport reader thread did not stop within 2s; "
                    "refusing to hand the inbox to a native consumer"
                )

    def _reader_loop(self) -> None:
        import uuid

        ptr = ctypes.c_void_p()
        ln = ctypes.c_uint32()
        while not self._closed and not self._reader_detached:
            if self._zero_copy:
                tok = self._lib.rt_recv_borrow(
                    self._handle,
                    self._sender_buf,
                    ctypes.byref(ptr),
                    ctypes.byref(ln),
                    100,
                )
                if tok == -3:
                    continue  # timeout tick
                if tok < 0:
                    return  # transport closing
                sender = NodeId(uuid.UUID(bytes=bytes(self._sender_buf)))
                data = _BorrowedFrame(self, tok, ptr.value or 0, ln.value)
            else:
                n = self._lib.rt_recv(
                    self._handle,
                    self._sender_buf,
                    self._recv_buf,
                    _RECV_BUF_CAP,
                    100,
                )
                if n == -3:
                    continue  # timeout tick; 0 is a valid empty frame
                if n < 0:
                    return  # transport closing
                sender = NodeId(uuid.UUID(bytes=bytes(self._sender_buf)))
                # one C-level memcpy; slicing the ctypes array instead
                # would build n Python ints and burn the GIL the sender
                # needs
                data = ctypes.string_at(self._recv_buf, n)
            self._pending.append((sender, data))
            if not self._wake_scheduled:
                # one loop wakeup per pending BATCH: further appends ride
                # the already-scheduled callback. (A spurious extra wake
                # after a drain is harmless; a missed one is impossible —
                # the flag only resets inside the loop-thread callback.)
                self._wake_scheduled = True
                try:
                    self._loop.call_soon_threadsafe(self._on_frames)
                except RuntimeError:
                    return  # loop closed

    # -- NetworkTransport ---------------------------------------------------

    async def send_to(self, target: NodeId, data: bytes) -> None:
        self.send_to_nowait(target, data)

    async def broadcast(self, data: bytes) -> None:
        self.broadcast_nowait(data)

    def send_to_nowait(self, target: NodeId, data: bytes) -> bool:
        h = self._handle  # read ONCE: close() swaps it to None
        if not h:
            return False  # closed: dropped, as a send to a gone peer is
        pid = (ctypes.c_uint8 * 16).from_buffer_copy(_id_bytes(target))
        rc = self._lib.rt_send(h, pid, data, len(data))
        if rc == -2:
            raise NetworkError("frame exceeds 16MiB cap")
        # rc == -1 (not connected) is a silent drop, like the reference's
        # best-effort sends to disconnected peers
        return True

    def broadcast_nowait(self, data: bytes) -> bool:
        h = self._handle  # read ONCE: close() swaps it to None
        if not h:
            return False  # closed: rt_broadcast would dereference NULL
        rc = self._lib.rt_broadcast(h, data, len(data))
        if rc == -2:
            raise NetworkError("frame exceeds 16MiB cap")
        return True

    def _on_frames(self) -> None:
        self._wake_scheduled = False
        self._data_ready.set()
        if self._recv_notify is not None:
            self._recv_notify()

    def _release_token(self, token: int) -> None:
        # close() nulls the handle only after the reader joined and the
        # pending queue was drained — a late release then no-ops here
        h = self._handle
        if h:
            self._lib.rt_recv_release(h, token)

    @staticmethod
    def _as_bytes(data) -> bytes:
        return data.to_bytes() if isinstance(data, _BorrowedFrame) else data

    async def receive(self, timeout: Optional[float] = None) -> tuple[NodeId, bytes]:
        deadline = (
            None
            if timeout is None
            else asyncio.get_running_loop().time() + timeout
        )
        while True:
            try:
                sender, data = self._pending.popleft()
                return sender, self._as_bytes(data)
            except IndexError:
                pass
            self._data_ready.clear()
            if self._pending:  # appended between popleft and clear
                continue
            if deadline is None:
                await self._data_ready.wait()
                continue
            left = deadline - asyncio.get_running_loop().time()
            if left <= 0:
                raise TimeoutError_("receive", timeout) from None
            try:
                await asyncio.wait_for(self._data_ready.wait(), left)
            except asyncio.TimeoutError:
                raise TimeoutError_("receive", timeout) from None

    def receive_nowait(self) -> Optional[tuple[NodeId, bytes]]:
        try:
            sender, data = self._pending.popleft()
        except IndexError:
            return None
        return sender, self._as_bytes(data)

    def receive_borrowed_nowait(self):
        """Zero-copy drain: ``(sender, buffer, release)`` where ``buffer``
        aliases the native frame arena (a memoryview) until ``release()``
        is called — the engine decodes straight out of the io thread's
        landing buffer (SURVEY §7.4.7). Falls back to a plain bytes
        frame (with a no-op release) when zero-copy recv is off."""
        try:
            sender, data = self._pending.popleft()
        except IndexError:
            return None
        if isinstance(data, _BorrowedFrame):
            return sender, data.view, data.release
        return sender, data, lambda: None

    def receive_raw_nowait(self):
        """Address-level drain for the engine's native tick ingest:
        ``(sender, data, addr, length, release)``. For frames still owned
        by the native arena, ``addr`` is the raw frame address (``data``
        is None) — the C ingest reads it with zero Python buffer
        wrapping; otherwise ``data`` is a bytes object and ``addr`` is 0.
        ``release`` is None for bytes frames."""
        try:
            sender, data = self._pending.popleft()
        except IndexError:
            return None
        if isinstance(data, _BorrowedFrame):
            return sender, None, data.addr, len(data.view), data.release
        return sender, data, 0, len(data), None

    def set_receive_notify(self, callback) -> bool:
        # invoked from _on_frames, which already runs on the loop thread
        # (the reader thread posts it via call_soon_threadsafe)
        self._recv_notify = callback
        return True

    async def get_connected_nodes(self) -> set[NodeId]:
        import uuid

        if not self._handle:  # closed (or close in progress): no peers
            return set()
        cap = 1024
        buf = (ctypes.c_uint8 * (16 * cap))()
        n = self._lib.rt_connected(self._handle, buf, cap)
        out = set()
        for i in range(n):
            out.add(NodeId(uuid.UUID(bytes=bytes(buf[16 * i : 16 * (i + 1)]))))
        return out

    @property
    def dropped_frames(self) -> int:
        """Inbound frames dropped by the native bounded inbox (oldest-first
        beyond 64Ki queued frames)."""
        if not self._handle:
            return 0
        return int(self._lib.rt_dropped(self._handle))

    @property
    def pool_stats(self) -> tuple[int, int]:
        """(hits, misses) of the native buffer arena (C10 PoolStats).

        Merged view: inbound landing buffers + the outbound frame arena.
        Use :attr:`out_pool_stats` for the outbound arena alone."""
        if not self._handle:
            return (0, 0)
        hits = ctypes.c_uint64()
        misses = ctypes.c_uint64()
        self._lib.rt_pool_stats(
            self._handle, ctypes.byref(hits), ctypes.byref(misses)
        )
        return int(hits.value), int(misses.value)

    @property
    def out_pool_stats(self) -> tuple[int, int]:
        """(hits, misses) of the OUTBOUND frame arena alone — the
        rt_send/rt_broadcast staging buffers transport.cpp recycles
        (previously collected natively but unreadable from Python).
        After close, reports the values frozen at teardown."""
        h = self._handle  # read ONCE: close() swaps it to None
        if not h:
            return self._final_out_pool
        hits = ctypes.c_uint64()
        misses = ctypes.c_uint64()
        self._lib.rt_out_pool_stats(
            h, ctypes.byref(hits), ctypes.byref(misses)
        )
        return int(hits.value), int(misses.value)

    def flight_snapshot(self, max_records: int = 4096) -> np.ndarray:
        """Chronological copy of the native frame in/out flight ring
        (transport.cpp TfEvent records — :data:`rabia_tpu_torch.obs.flight.
        TF_DTYPE`), taken consistently under the io mutex. After close,
        reports the ring frozen at teardown."""
        from rabia_tpu_torch.obs.flight import TF_DTYPE

        h = self._handle  # read ONCE: close() swaps it to None
        if not h:
            return self._final_flight
        buf = np.zeros(max_records, TF_DTYPE)
        n = int(self._lib.rt_flight_copy(h, buf.ctypes.data, max_records))
        return buf[:n]

    def transport_counters(self) -> dict[str, int]:
        """The native observability counter block as ``{name: value}``
        (RT_COUNTER_NAMES order; see docs/OBSERVABILITY.md). Values are
        relaxed-atomic reads — monotonic, not a consistent snapshot.
        After close, reports the block frozen at teardown. A scrape
        thread must not race ``close()`` itself (the gateway closes its
        HTTP shim before its transport for exactly that reason)."""
        h = self._handle  # read ONCE: close() swaps it to None
        if not h:
            return dict(self._final_ctrs)
        n = int(self._lib.rt_counters_count())
        addr = self._lib.rt_counters(h)
        if not addr:
            return {}
        cells = (ctypes.c_uint64 * n).from_address(addr)
        return {
            name: int(cells[i])
            for i, name in enumerate(RT_COUNTER_NAMES)
            if i < n
        }

    async def disconnect(self, node: NodeId) -> None:
        self.remove_peer(node)

    async def reconnect(self) -> None:
        # dialing is continuous in the native loop; nothing to kick
        return

    async def close(self) -> None:
        if self._closed:
            return
        # order matters: stop the reader FIRST (it polls _closed every
        # <=100ms inside rt_recv), and only then destroy the native handle —
        # rt_close deletes the Transport, so a reader still inside rt_recv
        # would be a use-after-free
        self._closed = True
        # freeze the final counter state while the native handle is still
        # valid — post-close scrapes read these copies
        self._final_ctrs = self.transport_counters()
        self._final_out_pool = self.out_pool_stats
        self._final_flight = self.flight_snapshot()
        loop = asyncio.get_running_loop()
        # stop the native io loop first: this makes any in-flight rt_recv
        # return immediately (-1), so the reader exits promptly
        if self._handle:
            self._lib.rt_stop(self._handle)
        if self._reader.is_alive():
            await loop.run_in_executor(None, self._reader.join, 2.0)
        if self._reader.is_alive():
            # the join timed out: the reader may still be inside rt_recv, so
            # rt_close (which deletes the Transport) would be a use-after-
            # free. The io loop is already stopped (no accepts/redials), so
            # leak the inert handle — process teardown reclaims it — and
            # say so.
            import logging

            logging.getLogger("rabia_tpu_torch.net").warning(
                "tcp close: reader thread still alive after join timeout; "
                "leaking stopped native transport handle"
            )
            self._handle = None
            return
        # materialize any zero-copy frames still pending: their buffers
        # live in the native arena rt_close is about to free (to_bytes
        # releases each token while the handle is still valid)
        for i, (sender, data) in enumerate(self._pending):
            if isinstance(data, _BorrowedFrame):
                self._pending[i] = (sender, data.to_bytes())
        handle, self._handle = self._handle, None
        if handle:
            await loop.run_in_executor(None, self._lib.rt_close, handle)
