"""NativeSessionTable: ctypes bridge to the C gateway session plane.

Wraps native/sessionkernel.cpp behind the SAME op-level API as the
Python :class:`~rabia_tpu_torch.gateway.session.SessionTable` (the semantics
owner; ``RABIA_PY_GATEWAY=1`` forces it), so
:class:`~rabia_tpu_torch.gateway.server.GatewayServer` is table-agnostic:

- the submit hot path (ensure + ack advance + dedup classify + window
  check + reservation) is ONE C call; cached dedup payloads come back
  as borrowed views unpacked into the exact ``tuple[bytes, ...]`` the
  Python table would return (byte parity is the conformance contract);
- the per-second GC sweep over every session runs in C — at 10^5
  sessions the Python loop's sweep alone cost tens of ms of asyncio
  loop stall per interval;
- the GWC_* counter block is exposed zero-copy for the metrics
  registry (``rabia_gateway_plane_*`` families).

Payload blob ABI (shared with the kernel):
``[u32 nparts][u32 len_i]*nparts [concatenated part bytes]``.

The port's copy of the reference's ``rabia_tpu/gateway/native_session.py``, its imports
retargeted to ``rabia_tpu_torch`` and its library the port's build of
``native/sessionkernel.cpp`` (``native/build.load_sessionkernel``, which
raises when the build fails).
"""

from __future__ import annotations

import ctypes
import struct
import time
import uuid
from typing import Optional

from rabia_tpu_torch.gateway.session import (
    SUBMIT_DUP_CACHED,
    CachedResult,
    SessionStats,
)

# GWC_* counter names in index order (sessionkernel.cpp); versioned
# append-only like RKC_*/SKC_*
GWC_COUNTER_NAMES = (
    "hellos",
    "submits",
    "dedup_cached",
    "dedup_inflight",
    "shed_window",
    "fresh",
    "completes",
    "aborts",
    "gc_runs",
    "sessions_opened",
    "sessions_expired",
    "leases_expired",
    "results_cached",
    "results_evicted",
    "result_bytes",
    "rehashes",
)

GWS_COUNTERS_VERSION = 1


def pack_payload(payload) -> bytes:
    """Pack a result payload (sequence of bytes-likes) into the kernel's
    blob ABI. Accepts memoryviews — the lazy result views the native
    apply plane stages — without materializing intermediate objects
    beyond this one blob."""
    parts = [bytes(p) for p in payload]
    head = struct.pack("<I", len(parts)) + b"".join(
        struct.pack("<I", len(p)) for p in parts
    )
    return head + b"".join(parts)


def unpack_payload(blob: bytes) -> tuple[bytes, ...]:
    n = struct.unpack_from("<I", blob, 0)[0]
    lens = struct.unpack_from(f"<{n}I", blob, 4)
    off = 4 + 4 * n
    out = []
    for ln in lens:
        out.append(blob[off:off + ln])
        off += ln
    return tuple(out)


class _NativeResultsView:
    """Dict-ish view of one session's cached results (test surface:
    ``seq in sess.results``, ``len``, ``get``)."""

    def __init__(self, table: "NativeSessionTable", cid: uuid.UUID) -> None:
        self._t = table
        self._cid = cid

    def __contains__(self, seq: int) -> bool:
        return self._t.cached_result(self._cid, seq) is not None

    def get(self, seq: int) -> Optional[CachedResult]:
        return self._t.cached_result(self._cid, seq)

    def __len__(self) -> int:
        info = self._t._info(self._cid)
        return 0 if info is None else info[4]

    def keys(self) -> list[int]:
        return self._t.result_seqs(self._cid)


class _NativeSessionView:
    """Read-only session facade matching the GatewaySession attributes
    tests and repair paths consult."""

    __slots__ = ("_t", "client_id")

    def __init__(self, table: "NativeSessionTable", cid: uuid.UUID) -> None:
        self._t = table
        self.client_id = cid

    @property
    def results(self) -> _NativeResultsView:
        return _NativeResultsView(self._t, self.client_id)

    def _field(self, idx: int):
        info = self._t._info(self.client_id)
        return None if info is None else info[idx]

    @property
    def window(self):
        return self._field(0)

    @property
    def ack_upto(self):
        return self._field(1)

    @property
    def highest_completed(self):
        return self._field(2)

    @property
    def inflight(self) -> dict:
        return {q: None for q in self._t.inflight_seqs(self.client_id)}


class _NativeSessionsFacade:
    """The ``table.sessions`` mapping surface (tests wipe it to simulate
    session-state loss; health counts it)."""

    def __init__(self, table: "NativeSessionTable") -> None:
        self._t = table

    def clear(self) -> None:
        self._t.clear()

    def __contains__(self, cid: uuid.UUID) -> bool:
        return self._t._info(cid) is not None

    def __len__(self) -> int:
        return len(self._t)

    def keys(self) -> list[uuid.UUID]:
        return self._t.session_ids()


class NativeSessionTable:
    """C-resident session/dedup table (see module doc)."""

    is_native = True

    def __init__(
        self,
        lib,
        default_window: int = 64,
        session_ttl: float = 600.0,
        result_cache_cap: int = 4096,
        lease_ttl: Optional[float] = None,
    ) -> None:
        self._lib = lib
        self.default_window = max(1, default_window)
        self.session_ttl = session_ttl
        self.result_cache_cap = max(1, result_cache_cap)
        self.lease_ttl = (
            lease_ttl if lease_ttl is not None else 4.0 * session_ttl
        )
        self._h = lib.gws_create(
            self.default_window,
            float(session_ttl),
            self.result_cache_cap,
            float(self.lease_ttl),
        )
        if not self._h:
            raise MemoryError("sessionkernel plane allocation failed")
        n = lib.gws_counters_count()
        addr = lib.gws_counters(self._h)
        self._ctr = (ctypes.c_uint64 * n).from_address(addr)
        self.sessions = _NativeSessionsFacade(self)

    def close(self) -> None:
        h = self._h
        if h:
            # freeze a final counter copy for late scrapes. Publish the
            # frozen copy and null the handle BEFORE freeing: /metrics
            # renders on the HTTP shim's handler threads, and a scrape
            # racing close() must land on the frozen copy (counters) or
            # the nulled handle (gws_len/gws_stats), never freed heap.
            n = len(self._ctr)
            frozen = (ctypes.c_uint64 * n)(*self._ctr)
            self._ctr = frozen
            self._h = None
            self._lib.gws_destroy(h)

    # -- op-level API (mirrors SessionTable) --------------------------------

    def hello(
        self,
        client_id: uuid.UUID,
        requested_window: int = 0,
        now: Optional[float] = None,
    ) -> tuple[int, int]:
        last = ctypes.c_uint64()
        window = self._lib.gws_hello(
            self._h, client_id.bytes, int(requested_window),
            time.time() if now is None else now, ctypes.byref(last),
        )
        return int(window), int(last.value)

    def submit_check(
        self,
        client_id: uuid.UUID,
        seq: int,
        ack_upto: int = 0,
        now: Optional[float] = None,
    ) -> tuple[int, int, tuple[bytes, ...]]:
        status = ctypes.c_int32()
        blob_p = ctypes.c_void_p()
        blob_len = ctypes.c_int64()
        dec = self._lib.gws_submit(
            self._h, client_id.bytes, seq, int(ack_upto),
            time.time() if now is None else now,
            ctypes.byref(status), ctypes.byref(blob_p),
            ctypes.byref(blob_len),
        )
        if dec == SUBMIT_DUP_CACHED:
            blob = ctypes.string_at(blob_p.value, blob_len.value)
            return int(dec), int(status.value), unpack_payload(blob)
        return int(dec), 0, ()

    def complete_op(
        self,
        client_id: uuid.UUID,
        seq: int,
        status: int,
        payload,
        frontier_mark: int,
        now: Optional[float] = None,
    ) -> bool:
        blob = pack_payload(payload)
        return bool(
            self._lib.gws_complete(
                self._h, client_id.bytes, seq, int(status),
                int(frontier_mark), blob, len(blob),
                time.time() if now is None else now,
            )
        )

    def abort(self, client_id: uuid.UUID, seq: int) -> None:
        self._lib.gws_abort(self._h, client_id.bytes, seq)

    def cached_result(
        self, client_id: uuid.UUID, seq: int
    ) -> Optional[CachedResult]:
        status = ctypes.c_int32()
        frontier = ctypes.c_uint64()
        blob_p = ctypes.c_void_p()
        blob_len = ctypes.c_int64()
        ok = self._lib.gws_get_result(
            self._h, client_id.bytes, seq, ctypes.byref(status),
            ctypes.byref(frontier), ctypes.byref(blob_p),
            ctypes.byref(blob_len),
        )
        if not ok:
            return None
        blob = ctypes.string_at(blob_p.value, blob_len.value)
        return CachedResult(
            status=int(status.value),
            payload=unpack_payload(blob),
            frontier_mark=int(frontier.value),
        )

    def gc(self, state_version: int, now: Optional[float] = None) -> int:
        return int(
            self._lib.gws_gc(
                self._h, int(state_version),
                time.time() if now is None else now,
            )
        )

    # -- facades / introspection --------------------------------------------

    def ensure(
        self,
        client_id: uuid.UUID,
        requested_window: int = 0,
        now: Optional[float] = None,
    ) -> _NativeSessionView:
        self.hello(client_id, requested_window, now=now)
        return _NativeSessionView(self, client_id)

    def get(self, client_id: uuid.UUID) -> Optional[_NativeSessionView]:
        if self._info(client_id) is None:
            return None
        return _NativeSessionView(self, client_id)

    def clear(self) -> None:
        self._lib.gws_clear(self._h)

    def _info(self, client_id: uuid.UUID):
        window = ctypes.c_int64()
        ack = ctypes.c_uint64()
        highest = ctypes.c_uint64()
        n_inflight = ctypes.c_int64()
        n_results = ctypes.c_int64()
        ok = self._lib.gws_session_info(
            self._h, client_id.bytes, ctypes.byref(window),
            ctypes.byref(ack), ctypes.byref(highest),
            ctypes.byref(n_inflight), ctypes.byref(n_results),
        )
        if not ok:
            return None
        return (
            int(window.value), int(ack.value), int(highest.value),
            int(n_inflight.value), int(n_results.value),
        )

    def session_ids(self) -> list[uuid.UUID]:
        cap = max(16, len(self) + 8)
        buf = (ctypes.c_uint8 * (16 * cap))()
        n = self._lib.gws_session_ids(self._h, buf, cap)
        raw = bytes(buf)
        return [
            uuid.UUID(bytes=raw[16 * i:16 * i + 16]) for i in range(n)
        ]

    def result_seqs(self, client_id: uuid.UUID) -> list[int]:
        info = self._info(client_id)
        if info is None:
            return []
        cap = max(1, info[4])
        out = (ctypes.c_uint64 * cap)()
        n = self._lib.gws_result_seqs(self._h, client_id.bytes, out, cap)
        return [int(out[i]) for i in range(max(0, n))]

    def inflight_seqs(self, client_id: uuid.UUID) -> list[int]:
        info = self._info(client_id)
        if info is None:
            return []
        cap = max(1, info[3])
        out = (ctypes.c_uint64 * cap)()
        n = self._lib.gws_inflight_seqs(self._h, client_id.bytes, out, cap)
        return [int(out[i]) for i in range(max(0, n))]

    def counters_dict(self) -> dict[str, int]:
        return {
            name: int(self._ctr[i]) if i < len(self._ctr) else 0
            for i, name in enumerate(GWC_COUNTER_NAMES)
        }

    @property
    def stats(self) -> SessionStats:
        """SessionStats parity view (computed from the counter block)."""
        out = (ctypes.c_uint64 * 6)()
        h = self._h  # local: close() nulls the handle before freeing
        if h:
            self._lib.gws_stats(h, out)
            vals = [int(v) for v in out]
        else:
            c = self.counters_dict()
            vals = [
                c["sessions_opened"],
                c["dedup_cached"] + c["dedup_inflight"],
                c["results_cached"],
                c["results_evicted"],
                c["sessions_expired"],
                c["leases_expired"],
            ]
        return SessionStats(
            sessions_opened=vals[0],
            duplicate_submits=vals[1],
            results_cached=vals[2],
            results_evicted=vals[3],
            sessions_expired=vals[4],
            leases_expired=vals[5],
        )

    def __len__(self) -> int:
        h = self._h  # local: close() nulls the handle before freeing
        return int(self._lib.gws_len(h)) if h else 0


def make_session_table(
    default_window: int = 64,
    session_ttl: float = 600.0,
    result_cache_cap: int = 4096,
    lease_ttl: Optional[float] = None,
):
    """The gateway's table factory: the native plane when the kernel
    builds and ``RABIA_PY_GATEWAY`` does not force Python, else the
    Python semantics owner."""
    from rabia_tpu_torch.gateway.session import SessionTable
    from rabia_tpu_torch.native.build import load_sessionkernel

    lib = load_sessionkernel()
    if lib is not None:
        return NativeSessionTable(
            lib,
            default_window=default_window,
            session_ttl=session_ttl,
            result_cache_cap=result_cache_cap,
            lease_ttl=lease_ttl,
        )
    return SessionTable(
        default_window=default_window,
        session_ttl=session_ttl,
        result_cache_cap=result_cache_cap,
        lease_ttl=lease_ttl,
    )
