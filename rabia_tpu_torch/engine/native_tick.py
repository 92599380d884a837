"""ctypes bridge to the native per-tick fast path (hostkernel.cpp).

The port's copy of the reference's ``rabia_tpu/engine/native_tick.py``,
over the port's own build of ``hostkernel.cpp``.

The engine's hot loop — decode vote/decision frames, ingest side effects,
ledger scatter, chained node_step rounds, outbound vote framing — runs in
one C call per tick when this bridge is active; Python is touched only for
events (decisions ready to record/apply, sync, membership, timeouts).

The bridge registers raw pointers to the engine's columnar runtime arrays
and the kernel's persistent state arrays ONCE at construction; from then
on the C side mutates them in place. The engine guarantees those arrays
are never reallocated while the bridge is alive (in native-tick mode the
kernel state is stepped in place, not functionally copied).

Semantics owner: the Python paths in engine/engine.py. The env toggle
``RABIA_PY_TICK=1`` forces them (mirroring ``RABIA_PY_DEVPACK``); the
seeded fuzz schedules and tests/test_torch_native_tick.py pin identical
decision sequences, ledgers and wire behavior between the two.
"""

from __future__ import annotations

import ctypes
import logging
import time

import numpy as np

logger = logging.getLogger("rabia_tpu_torch.engine.native_tick")

_STALE_CAP = 1024

# Names of the rk tick context's counter block, in RKC_* index order
# (hostkernel.cpp). The block is versioned append-only: a newer library
# may expose MORE counters than this list names (ignored), an older one
# fewer (read as 0). These feed the same metric names the Python tick
# path feeds from its event counters — docs/OBSERVABILITY.md taxonomy.
RK_COUNTER_NAMES = (
    "ticks",
    "stages",
    "frames_vote1",
    "frames_vote2",
    "frames_decision",
    "frames_noop",
    "drop_spoof",
    "drop_skew",
    "drop_malformed",
    "stale_votes",
    "taint_hits",
    "carries",
    "ledger_scatters",
    "out_frames",
    "decided",
    "opened",
    # consensus-health telemetry (RKC v2, chaos plane)
    "coin_v0",
    "coin_v1",
    "phase_sum",
)


class NativeTick:
    """One engine's native tick context (see module doc)."""

    def __init__(self, engine, lib) -> None:
        self.lib = lib
        e = engine
        kst = e.kstate
        rt = e.rt
        kernel = e.kernel
        dims = np.asarray(
            [
                e.S,
                e.n_shards,
                e.R,
                e.me,
                kernel.quorum,
                kernel.f1,
                kernel.seed & 0xFFFFFFFF,
                kernel._coin_threshold,
                rt.DEC_RING,
                1 if e.config.decision_broadcast else 0,
            ],
            np.int64,
        )
        self.newly = np.zeros(e.S, np.uint8)
        # pointer registration order is the rk_ctx_create contract
        arrays = [
            rt.next_slot,
            rt.applied_upto,
            rt.in_flight,
            rt.votes_seen_slot,
            rt.tainted_upto,
            rt.taint_traffic,
            rt.last_progress,
            rt.dec_ring_slot,
            rt.dec_ring_val,
            kst.slot,
            kst.phase,
            kst.stage,
            kst.my_r1,
            kst.my_r2,
            kst.led1,
            kst.led2,
            kst.decided,
            kst.done,
            kst.active,
            e._dec_plane,
            self.newly,
        ]
        for a in arrays:
            if not a.flags.c_contiguous:
                raise ValueError("native tick requires contiguous arrays")
        # strong refs: the C side holds raw pointers into these
        self._arrays = arrays
        ptrs = np.asarray([a.ctypes.data for a in arrays], np.int64)
        uuid_tbl = np.frombuffer(
            b"".join(n.value.bytes for n in e.cluster.all_nodes), np.uint8
        ).copy()
        fparams = np.asarray(
            [e.config.validation.max_future_skew, e.config.validation.max_age],
            np.float64,
        )
        self.ctx = lib.rk_ctx_create(
            dims.ctypes.data,
            ptrs.ctypes.data,
            uuid_tbl.ctypes.data,
            fparams.ctypes.data,
        )
        if not self.ctx:
            raise RuntimeError("rk_ctx_create failed")
        # outbound frame buffer: the open-broadcast VoteRound1 frame plus
        # 4 chained iterations x (R1 + R2 + Decision) frames, each
        # bounded by n entries
        n = e.n_shards
        self._out_cap = (72 + 13 * n) + 4 * (3 * 72 + (13 + 13 + 14) * n) + 4096
        self._out = np.empty(self._out_cap, np.uint8)
        self._res = np.zeros(8, np.int64)
        self._st_rows = np.zeros(_STALE_CAP, np.int64)
        self._st_shards = np.zeros(_STALE_CAP, np.int64)
        self._st_slots = np.zeros(_STALE_CAP, np.int64)
        # cached raw pointers (per-call ndarray.ctypes marshalling costs
        # more than the C work at small shard counts)
        self._out_ptr = self._out.ctypes.data
        self._res_ptr = self._res.ctypes.data
        self._st_ptrs = (
            self._st_rows.ctypes.data,
            self._st_shards.ctypes.data,
            self._st_slots.ctypes.data,
        )
        self._kst_ptrs = tuple(a.ctypes.data for a in kst)
        self._geom = (e.S, e.R, e.me)
        # observability: zero-copy ndarray view over the context's C
        # counter block — the registry reads cells at scrape time, the
        # hot path never crosses into Python for them
        n_ctr = int(lib.rk_counters_count())
        self.counters_version = int(lib.rk_counters_version())
        cbuf = (ctypes.c_uint64 * n_ctr).from_address(
            lib.rk_counters(self.ctx)
        )
        self.counters = np.frombuffer(cbuf, np.uint64)
        # phases-to-decide histogram: zero-copy view over the context's
        # C bins (bin p = local decisions that took p weak-MVC phases).
        # Shared with the GIL-free runtime thread (same rk ctx), so a
        # scrape may see a torn in-flight bin — metrics-grade.
        n_ph = int(lib.rk_phase_hist_len())
        pbuf = (ctypes.c_uint64 * n_ph).from_address(
            lib.rk_phase_hist(self.ctx)
        )
        self.phase_hist = np.frombuffer(pbuf, np.uint64)
        # per-phase consensus dwell histograms: zero-copy (phases, stride)
        # view over the context's C block (RK_DWELL ABI — RTH-style rows
        # of buckets + count + sum_ns). Geometry tuple lets the exporter
        # verify the block matches the registry's SLO buckets before
        # decoding. Same torn-read caveat as phase_hist: metrics-grade.
        n_dp = int(lib.rk_dwell_phases())
        n_db = int(lib.rk_dwell_buckets())
        self.dwell_version = int(lib.rk_dwell_version())
        self.dwell_geometry = (
            n_db,
            int(lib.rk_dwell_sub_bits()),
            int(lib.rk_dwell_min_exp()),
        )
        dbuf = (ctypes.c_uint64 * (n_dp * (n_db + 2))).from_address(
            lib.rk_dwell(self.ctx)
        )
        self.dwell = np.frombuffer(dbuf, np.uint64).reshape(n_dp, n_db + 2)
        # flight recorder: zero-copy structured view over the context's C
        # event ring (hostkernel.cpp FrEvent ABI — obs/flight.FR_DTYPE)
        from rabia_tpu_torch.obs.flight import FR_DTYPE

        self._fr_frozen = None
        if int(lib.rk_flight_record_size()) != FR_DTYPE.itemsize:
            raise RuntimeError(
                "flight record ABI mismatch: C "
                f"{int(lib.rk_flight_record_size())}B vs Python "
                f"{FR_DTYPE.itemsize}B"
            )
        cap = int(lib.rk_flight_cap())
        self.flight_version = int(lib.rk_flight_version())
        fbuf = (ctypes.c_uint8 * (cap * FR_DTYPE.itemsize)).from_address(
            lib.rk_flight(self.ctx)
        )
        self._fr_view = np.frombuffer(fbuf, FR_DTYPE)
        # sibling worker contexts (thread-per-shard-group runtime): the
        # bridge creates one extra NativeTick per additional worker and
        # registers them here so counter()/phase-hist scrapes cover the
        # whole shard space (each sibling only ever ticks its own range)
        self.siblings: list["NativeTick"] = []

    def counter(self, name: str) -> int:
        """One named counter from the block, summed over this context and
        any sibling worker contexts (0 for unknown/short blocks)."""
        try:
            i = RK_COUNTER_NAMES.index(name)
        except ValueError:
            return 0
        total = int(self.counters[i]) if i < len(self.counters) else 0
        for sib in self.siblings:
            if i < len(sib.counters):
                total += int(sib.counters[i])
        return total

    def counters_dict(self) -> dict[str, int]:
        return {n: self.counter(n) for n in RK_COUNTER_NAMES}

    def set_range(self, lo: int, hi: int, salt: int = 0) -> None:
        """Restrict this context to shard-group range [lo, hi) with a
        message-id salt (thread-per-shard-group runtime). Call only
        while no thread is inside the context."""
        if self.ctx is not None:
            self.lib.rk_set_range(self.ctx, lo, hi, salt)

    def flight_head(self) -> int:
        """Total flight records ever written by the C ring."""
        if self.ctx is None:
            return 0
        return int(self.lib.rk_flight_head(self.ctx))

    def flight_snapshot(self) -> np.ndarray:
        """Chronological copy of the live ring window (FR_DTYPE records,
        oldest first). Single-writer (the engine loop); a foreign-thread
        scrape may see one torn in-flight record — metrics-grade."""
        if self._fr_frozen is not None:
            return self._fr_frozen
        if self.ctx is None or len(self._fr_view) == 0:
            from rabia_tpu_torch.obs.flight import FR_DTYPE

            return np.zeros(0, FR_DTYPE)
        head = self.flight_head()
        cap = len(self._fr_view)
        if head <= cap:
            return self._fr_view[:head].copy()
        i = head % cap
        return np.concatenate([self._fr_view[i:], self._fr_view[:i]])

    def close(self) -> None:
        if self.ctx:
            # freeze the last counter values and the flight ring BEFORE
            # destroying the context: both live in its memory, but late
            # scrapes/dumps (post-shutdown stats, crash dumps) must read
            # the final state, not freed memory
            self.counters = self.counters.copy()
            self.phase_hist = self.phase_hist.copy()
            self.dwell = self.dwell.copy()
            self._fr_frozen = self.flight_snapshot()
            ctx, self.ctx = self.ctx, None
            self.lib.rk_ctx_destroy(ctx)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- ingest --------------------------------------------------------------

    def ingest(self, data, row: int, now: float) -> int:
        """Offer one wire frame (bytes / memoryview over the transport
        arena) to the native ingest. Returns 1 handled, 0 not-a-fast-path
        frame (caller deserializes), -1 dropped (malformed/spoofed/
        validation-failed)."""
        if type(data) is bytes:
            # ctypes passes the bytes buffer as void* directly (no copy)
            return self.lib.rk_ingest(self.ctx, data, len(data), row, now)
        buf = np.frombuffer(data, np.uint8)
        return self.lib.rk_ingest(
            self.ctx, buf.ctypes.data, len(buf), row, now
        )

    def ingest_addr(self, addr: int, length: int, row: int, now: float) -> int:
        """Same, but straight from a native arena address (zero Python
        buffer wrapping — the borrowed-frame TCP drain)."""
        return self.lib.rk_ingest(self.ctx, addr, length, row, now)

    def finish_drain(self, engine) -> None:
        """Post-drain event work: mark senders active, run the rate-limited
        stale-vote repair for any stale reports the C ingest buffered."""
        lib = self.lib
        mask = lib.rk_rows_seen(self.ctx)
        while mask:
            row = (mask & -mask).bit_length() - 1
            mask &= mask - 1
            node = engine._row_to_node.get(row)
            if node is not None and node != engine.node_id:
                engine.rt.active_nodes.add(node)
        k = int(
            lib.rk_drain_stale(self.ctx, *self._st_ptrs, _STALE_CAP)
        )
        if k:
            rows = self._st_rows[:k]
            if k <= 4:  # the steady-state case: a couple of late votes
                seen = set()
                for i in range(k):
                    row = int(rows[i])
                    if row in seen:
                        continue
                    seen.add(row)
                    sel = rows == row
                    engine._repair_stale_sender(
                        row, self._st_shards[:k][sel], self._st_slots[:k][sel]
                    )
            else:
                for row in np.unique(rows):
                    sel = rows == row
                    engine._repair_stale_sender(
                        int(row),
                        self._st_shards[:k][sel],
                        self._st_slots[:k][sel],
                    )

    # -- slot lifecycle / the chained tick ------------------------------------

    def start_slots(self, mask, slots_full, init_full) -> None:
        """In-place rk_start_slots on the persistent kernel arrays (the
        functional HostNodeKernel.start_slots would reallocate state and
        orphan the registered pointers)."""
        S, R, me = self._geom
        m = np.ascontiguousarray(mask).view(np.uint8)
        sl = np.ascontiguousarray(slots_full, np.int32)
        iv = np.ascontiguousarray(init_full, np.int8)
        self.lib.rk_start_slots(
            S, R, me,
            m.ctypes.data, sl.ctypes.data, iv.ctypes.data,
            *self._kst_ptrs,
        )

    def tick(
        self,
        now: float | None = None,
        open_mask=None,
        open_slots=None,
        open_init=None,
    ) -> np.ndarray:
        """Chained route -> node_step -> outbox rounds (up to 4), framing
        outbound votes/decisions into the internal buffer. When the open
        arrays are given, the covered shards are armed in place and their
        VoteRound1 open broadcast is framed first. Returns the result
        vector [out_bytes, done_any, restep, frames, overflow]."""
        if open_mask is not None:
            m = np.ascontiguousarray(open_mask).view(np.uint8)
            sl = np.ascontiguousarray(open_slots, np.int32)
            iv = np.ascontiguousarray(open_init, np.int8)
            args = (m.ctypes.data, sl.ctypes.data, iv.ctypes.data)
        else:
            args = (0, 0, 0)
        self.lib.rk_tick(
            self.ctx,
            time.time() if now is None else now,
            self._out_ptr,
            self._out_cap,
            4,
            *args,
            self._res_ptr,
        )
        return self._res

    def broadcast_out(self, engine, nbytes: int) -> None:
        """Hand the tick's outbound frames to the transport: one native
        batch call for the C++ TCP plane, per-frame broadcast_nowait for
        Python transports (spawned broadcasts for transports without a
        sync path, exactly like engine._send)."""
        transport = engine.transport
        handle = getattr(transport, "_handle", None)
        tlib = getattr(transport, "_lib", None)
        if handle and tlib is not None:
            rc = tlib.rt_broadcast_frames(handle, self._out_ptr, nbytes)
            if rc >= 0:
                return
            logger.warning("rt_broadcast_frames rejected batch (rc=%s)", rc)
        mv = memoryview(self._out)
        pos = 0
        bcast = transport.broadcast_nowait
        while pos + 4 <= nbytes:
            ln = int.from_bytes(mv[pos : pos + 4], "little")
            frame = bytes(mv[pos + 4 : pos + 4 + ln])
            if not bcast(frame):
                engine._spawn(transport.broadcast(frame))
            pos += 4 + ln

    # -- introspection (tests / stats) ----------------------------------------

    @property
    def dropped_frames(self) -> int:
        return int(self.lib.rk_dropped(self.ctx))

    @property
    def carry_count(self) -> int:
        return int(self.lib.rk_carry_count(self.ctx))
