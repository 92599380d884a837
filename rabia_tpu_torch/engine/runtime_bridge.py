"""Control-plane bridge to the native engine runtime (native/runtime.cpp).

The port's copy of the reference's ``rabia_tpu/engine/runtime_bridge.py``,
over the port's own build of ``runtime.cpp``, with these repairs: the
split into shard groups (:func:`shard_groups`) leaves no group empty; the
scalar pump holds back a queue head that a decided slot may already hold,
including a slot the runtime decided whose record is still in the mailbox
(``RabiaEngine._decided_unapplied(unseen_holds=True)``); a block entry
that decides above an earlier slot still waiting for its payload waits
for it (``ShardState.block_waiters``) instead of failing its client as
overtaken by a sync; and the payloads of a peer's block announce that the
C binder could not bind (``EV_REPAIR``: its slot decided here first, or
the shard's binding busy) reach the scalar ledger, so the slot applies
without a snapshot sync.

When active, a dedicated GIL-free C thread owns the commit path —
transport ingest -> rk_tick consensus -> statekernel apply -> staged
result/vote frames — and this module is everything Python still does:

- **submission pump**: scalar queue heads become ``CMD_OPEN_SCALAR``
  commands (with the pre-serialized Propose broadcast); block-lane
  bindings (own submits and escalated peer announces) become
  ``CMD_OPEN_WAVE`` commands carrying the op blob the C side applies;
- **event mailbox drain**: decisions for listeners/futures, natively
  applied waves (with staged per-op result frames), escalated wire
  frames (Propose/NewBatch/Sync/HeartBeat/...), rejects and stalls —
  processed on the asyncio loop, in per-shard slot order;
- **ownership hand-offs**: ``pause()``/``resume()`` quiesce the runtime
  thread so sync serving/adoption and persistence snapshots can touch
  the consensus columns and the native store plane safely.

The asyncio orchestration in engine.py stays the semantics owner:
``RABIA_PY_RUNTIME=1`` forces it, and
``testing.conformance.run_schedule_on_runtime_paths`` pins identical
decision/apply sequences and counter parity between the two.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import struct
import time
from typing import Optional

import numpy as np

from rabia_tpu_torch.core.messages import ProposeBlock, Propose, ProtocolMessage
from rabia_tpu_torch.core.types import StateValue, V0, V1
from rabia_tpu_torch.engine.state import SlotRecord
from rabia_tpu_torch.kernel.phase_driver import pack_phase
from rabia_tpu_torch.obs.flight import FRE_APPLY, FRE_DECIDE, FRE_PROPOSE, fr_hash

logger = logging.getLogger("rabia_tpu_torch.engine.runtime_bridge")

# event / command record types — ABI of native/runtime.cpp
EV_FRAME = 1
EV_DECIDE = 2
EV_WAVE = 3
EV_REJECT = 4
EV_STALL = 5
EV_LEDGER = 6
EV_REPAIR = 7

CMD_OPEN_SCALAR = 1
CMD_OPEN_WAVE = 2
CMD_ADVANCE = 3
CMD_DECIDE = 4
CMD_STOP = 5

RTM_RUNNING = 0
RTM_PAUSED = 2
RTM_STOPPED = 3

# RTM_* counter names in index order (runtime.cpp); versioned append-only
RTM_COUNTER_NAMES = (
    "loops",
    "wakes_frame",
    "wakes_idle",
    "frames_native",
    "frames_block",
    "frames_escalated",
    "frames_dropped",
    "cmds",
    "opens_scalar",
    "opens_block",
    "ticks",
    "decided_scalar",
    "waves_native",
    "waves_py",
    "slots_applied",
    "result_bytes",
    "ev_records",
    "ev_stalls",
    "retransmits",
    "stale_repairs",
    "pauses",
    "gil_handoffs",
    "ev_dropped",
)

# RTS_* stage names in index order (runtime.cpp stage profiler block);
# must match obs.registry.RUNTIME_STAGES — the shared
# rabia_runtime_stage_seconds{stage=...} label set
RTM_STAGE_NAMES = (
    "recv_wait",
    "ingest",
    "tick",
    "apply",
    "result_staging",
    "broadcast",
    "cmd",
    "timers",
    "idle",
    "other",
)

# RTH_* histogram stage names in index order (runtime.cpp SLO block)
RTM_HIST_STAGES = ("decide_apply", "broadcast")

_FN_ORDER = (
    "rt_recv_borrow",
    "rt_recv_release",
    "rt_broadcast_frames",
    "rt_send",
    "rk_ingest",
    "rk_tick",
    "rk_retransmit",
    "rk_drain_stale",
    "sk_apply_wave",
    "sk_out_buf",
    "sk_out_offs",
    "sk_plane_lock",
    "sk_plane_unlock",
    "wal_append",
    "wal_barrier_covered",
    "wal_durable",
    # thread-per-shard-group additions (null with a single worker)
    "rt_recv_borrow_group",
    "sk_apply_wave_lane",
    "sk_out_buf_lane",
    "sk_out_offs_lane",
)


def resolve_runtime_workers(engine) -> int:
    """Worker (= shard group) count for the thread-per-shard-group
    runtime. ``RABIA_RT_WORKERS`` overrides
    ``RabiaConfig.runtime_workers``; auto (unset/None) is
    ``min(shards, max(1, cores - 1))`` — one core stays with the Python
    control plane, and hosts with <= 2 cores run the historical
    single-thread runtime. Capped at 64 groups (the classifier's
    bitmask width) and at the shard count."""
    env = os.environ.get("RABIA_RT_WORKERS")
    w = None
    if env:
        try:
            w = int(env)
        except ValueError:
            w = None
    if w is None:
        w = getattr(engine.config, "runtime_workers", None)
    if w is None:
        w = max(1, (os.cpu_count() or 1) - 1)
    return shard_groups(engine.n_shards, w)[0]


def shard_groups(n: int, w: int) -> tuple[int, int]:
    """(workers, chunk) of the split of ``n`` shards into at most ``w``
    contiguous groups of ``chunk = ceil(n / w)`` shards: group g holds
    ``[g * chunk, min((g + 1) * chunk, n))``. The group count is then
    ``ceil(n / chunk)``, so every group is non-empty. The reference keeps
    ``w`` groups, and ``w`` groups of ``ceil(n / w)`` can start past ``n``
    (8 shards, w = 7: chunk 2, groups 4..6 empty, with ``lo > hi``), which
    the native runtime's open collection turns into a negative-length
    memset. ``runtime.cpp``'s ``rtm_create`` computes the same split."""
    w = max(1, min(int(w), 64, n))
    if n <= 0:
        return 1, 0
    chunk = (n + w - 1) // w
    return (n + chunk - 1) // chunk, chunk


def runtime_available(engine) -> bool:
    """Preconditions for the native runtime: host kernel + native tick
    context + the C TCP transport, and the env toggle not forcing the
    asyncio orchestration."""
    if os.environ.get("RABIA_PY_RUNTIME") == "1":
        return False
    if engine._rk is None:
        return False
    if engine.persistence is not None:
        # a durable cluster runs the GIL-free commit path only on the
        # durability plane (persistence/native_wal.py with the C
        # walkernel writer): decided waves stage from the C apply stage
        # and the vote-barrier write-ahead gates opens on the
        # group-commit watermark. Blob persistence — and the
        # RABIA_PY_WAL Python twin, which the C thread cannot call —
        # stay on the asyncio orchestration.
        wal = getattr(engine, "_wal", None)
        if wal is None or not getattr(wal, "native", False):
            return False
    t = engine.transport
    if not getattr(t, "_handle", None) or getattr(t, "_lib", None) is None:
        return False
    if getattr(engine.sm, "_native_plane", None) is None:
        # no native apply plane: every decided wave would bounce back
        # through Python anyway (a GIL handoff per wave), and measured
        # end-to-end the mailbox round trips cost MORE than the asyncio
        # loop's in-process orchestration at wide shard counts — the
        # runtime only owns the commit path where it can finish it
        # (engine_sweep_r08 config-5 analysis in benchmarks/results.json)
        return False
    return True


class RuntimeBridge:
    """One engine's native-runtime control plane (see module doc)."""

    def __init__(self, engine, lib) -> None:
        self.engine = engine
        self.lib = lib
        e = engine
        rt = e.rt
        rk = e._rk
        t = e.transport
        sk_plane = getattr(e.sm, "_native_plane", None)
        self.native_apply = sk_plane is not None
        self._sk_plane = sk_plane

        # thread-per-shard-group geometry: W worker threads, each owning
        # a contiguous chunk of the shard space end-to-end. W=1 is the
        # historical single-thread runtime, byte for byte.
        self.workers, self._chunk = shard_groups(
            e.n_shards, resolve_runtime_workers(e)
        )
        self._extra_rks: list = []
        if self.workers > 1:
            from rabia_tpu_torch.engine.native_tick import NativeTick

            for _g in range(1, self.workers):
                self._extra_rks.append(NativeTick(e, e._hk_lib))
            rk.set_range(0, min(self._chunk, e.n_shards), 0)
            for g, xrk in enumerate(self._extra_rks, start=1):
                lo = g * self._chunk
                hi = (
                    e.n_shards
                    if g == self.workers - 1
                    else min((g + 1) * self._chunk, e.n_shards)
                )
                xrk.set_range(lo, hi, g)
            # scrapes of the primary context sum the whole shard space
            rk.siblings = self._extra_rks

        # function-pointer table: transport + hostkernel (+ statekernel)
        fn_libs = {
            "rt_recv_borrow": t._lib,
            "rt_recv_release": t._lib,
            "rt_broadcast_frames": t._lib,
            "rt_send": t._lib,
            "rk_ingest": e._hk_lib,
            "rk_tick": e._hk_lib,
            "rk_retransmit": e._hk_lib,
            "rk_drain_stale": e._hk_lib,
        }
        if self.workers > 1:
            fn_libs["rt_recv_borrow_group"] = t._lib
        if self.native_apply:
            fn_libs.update(
                sk_apply_wave=sk_plane.lib,
                sk_out_buf=sk_plane.lib,
                sk_out_offs=sk_plane.lib,
                sk_plane_lock=sk_plane.lib,
                sk_plane_unlock=sk_plane.lib,
            )
            if self.workers > 1:
                fn_libs.update(
                    sk_apply_wave_lane=sk_plane.lib,
                    sk_out_buf_lane=sk_plane.lib,
                    sk_out_offs_lane=sk_plane.lib,
                )
        # durability plane: the C writer's append/barrier/watermark entry
        # points, so the io/tick thread stages decided waves and gates
        # opens on the vote barrier without ever touching Python
        self._wal = getattr(e, "_wal", None)
        wal_handle = 0
        if self._wal is not None and getattr(self._wal, "native", False):
            wlib = self._wal._writer.lib
            wal_handle = int(self._wal._writer.handle)
            fn_libs.update(
                wal_append=wlib,
                wal_barrier_covered=wlib,
                wal_durable=wlib,
            )
        fns = np.zeros(len(_FN_ORDER), np.int64)
        for i, name in enumerate(_FN_ORDER):
            flib = fn_libs.get(name)
            if flib is None:
                continue
            fns[i] = ctypes.cast(getattr(flib, name), ctypes.c_void_p).value

        v = e.config.validation
        dims = np.asarray(
            [
                e.S,
                e.n_shards,
                e.R,
                e.me,
                rt.DEC_RING,
                1 if self.native_apply else 0,
                int(os.environ.get("RABIA_RTM_CMD_RING", 8 << 20)),
                int(os.environ.get("RABIA_RTM_EV_RING", 20 << 20)),
                v.max_commands_per_batch,
                v.max_command_size,
                self.workers,
            ],
            np.int64,
        )
        kst = e.kstate
        ptrs = np.asarray(
            [
                rk.ctx,
                t._handle,
                sk_plane.handle if self.native_apply else 0,
                rt.next_slot.ctypes.data,
                rt.applied_upto.ctypes.data,
                rt.in_flight.ctypes.data,
                rt.votes_seen_slot.ctypes.data,
                rt.tainted_upto.ctypes.data,
                rt.last_progress.ctypes.data,
                rt.opened_at.ctypes.data,
                rt.dec_ring_slot.ctypes.data,
                rt.dec_ring_val.ctypes.data,
                kst.slot.ctypes.data,
                kst.decided.ctypes.data,
                kst.done.ctypes.data,
                rk.newly.ctypes.data,
                wal_handle,
            ]
            # per-worker rk tick contexts (workers 1..W-1; worker 0 is
            # the engine's primary context at ptrs[0])
            + [int(xrk.ctx) for xrk in self._extra_rks],
            np.int64,
        )
        uuid_tbl = np.frombuffer(
            b"".join(n.value.bytes for n in e.cluster.all_nodes), np.uint8
        ).copy()
        grace = min(max(e.config.phase_timeout / 10.0, 0.02), 1.0)
        fparams = np.asarray(
            [
                v.max_future_skew,
                v.max_age,
                e.config.phase_timeout,
                grace,
            ],
            np.float64,
        )
        self.ctx = lib.rtm_create(
            dims.ctypes.data,
            ptrs.ctypes.data,
            fns.ctypes.data,
            uuid_tbl.ctypes.data,
            fparams.ctypes.data,
        )
        if not self.ctx:
            raise RuntimeError("rtm_create failed")
        self.workers = int(lib.rtm_workers(self.ctx))  # C-side clamp
        if self.workers > 1 and self.native_apply:
            # per-worker statekernel apply lanes + group store locking
            sk_plane.lib.sk_set_groups(sk_plane.handle, self.workers)
        self._started = False
        self._stopped = False
        self._grace = grace
        self._pause_depth = 0

        # mailbox drain buffer covers the whole event ring: any record
        # the runtime pushed must drain (a smaller buffer would wedge the
        # mailbox behind the first oversized record)
        self._ev_buf = np.empty(
            int(os.environ.get("RABIA_RTM_EV_RING", 20 << 20)), np.uint8
        )
        self._ev_ptr = self._ev_buf.ctypes.data
        self._cmd_cap = int(os.environ.get("RABIA_RTM_CMD_RING", 8 << 20))

        # Python-side bookkeeping
        # applied frontier mirror (event-ordered; the C array is advisory)
        self._applied = rt.applied_upto[: e.n_shards].copy()
        # scalar command in flight per shard: slot or -1
        self._cmd_slot = np.full(e.n_shards, -1, np.int64)
        # block-token registry: token -> ref, with a ref -> tokens
        # reverse index (a group-split wave holds one token per shard
        # group; retirement drops them all in O(tokens-per-ref))
        self._tokens: dict[int, int] = {}
        self._ref_tokens: dict[int, list[int]] = {}
        self._next_token = 1
        # votes-waiting grace clocks (the _open_slots V0 path's shadow)
        self._votes_wait: dict[int, float] = {}
        # commands that hit a full ring: retried at the head of every
        # pump pass (CMD_ADVANCE/CMD_DECIDE must never drop — a silently
        # lost advance leaves this replica's applied frontier behind and
        # draws spurious lag syncs)
        self._cmd_backlog: list[bytes] = []
        self._kick_pending = False
        self._event_fd = int(lib.rtm_event_fd(self.ctx))

        # observability: zero-copy per-worker counter/stage/hist/flight
        # views (RTM_*/RTS_*/RTH_* geometry per worker; scrapes sum, the
        # profile CLI renders per worker). Worker 0's blocks stay exposed
        # under the historical attribute names.
        from rabia_tpu_torch.obs.flight import FR_DTYPE

        n_ctr = int(lib.rtm_counters_count())
        self.counters_version = int(lib.rtm_counters_version())
        n_stg = int(lib.rtm_stages_count())
        self.stages_version = int(lib.rtm_stages_version())
        self.hist_version = int(lib.rtm_hist_version())
        self._hist_buckets = int(lib.rtm_hist_buckets())
        self._hist_sub_bits = int(lib.rtm_hist_sub_bits())
        self._hist_min_exp = int(lib.rtm_hist_min_exp())
        n_hs = int(lib.rtm_hist_stages())
        cap = int(lib.rtm_flight_cap())

        def _u64_view(addr, count):
            buf = (ctypes.c_uint64 * count).from_address(addr)
            return np.frombuffer(buf, np.uint64)

        self._w_counters: list[np.ndarray] = []
        self._w_stages: list[np.ndarray] = []
        self._w_hists: list[np.ndarray] = []
        self._w_fr_views: list[np.ndarray] = []
        for g in range(self.workers):
            if g == 0:
                c_addr = lib.rtm_counters(self.ctx)
                s_addr = lib.rtm_stages(self.ctx)
                h_addr = lib.rtm_hist(self.ctx)
                f_addr = lib.rtm_flight(self.ctx)
            else:
                c_addr = lib.rtm_counters_w(self.ctx, g)
                s_addr = lib.rtm_stages_w(self.ctx, g)
                h_addr = lib.rtm_hist_w(self.ctx, g)
                f_addr = lib.rtm_flight_w(self.ctx, g)
            self._w_counters.append(_u64_view(c_addr, n_ctr))
            self._w_stages.append(_u64_view(s_addr, n_stg))
            self._w_hists.append(
                _u64_view(h_addr, n_hs * (self._hist_buckets + 2)).reshape(
                    n_hs, self._hist_buckets + 2
                )
            )
            fbuf = (
                ctypes.c_uint8 * (cap * FR_DTYPE.itemsize)
            ).from_address(f_addr)
            self._w_fr_views.append(np.frombuffer(fbuf, FR_DTYPE))
        self.counters = self._w_counters[0]
        self.stages = self._w_stages[0]
        self.hist = self._w_hists[0]
        self._fr_view = self._w_fr_views[0]
        self._fr_frozen: Optional[np.ndarray] = None

    # -- lifecycle -----------------------------------------------------------

    def adopt_restored_frontiers(self) -> None:
        """Re-mirror the event-ordered applied frontier after a WAL
        recovery rewrote the runtime columns (the bridge snapshotted them
        at construction, BEFORE ``initialize`` restored state). Must run
        before :meth:`start` — afterwards the runtime thread is the
        single writer and the mirror only moves on events."""
        e = self.engine
        self._applied[:] = e.rt.applied_upto[: e.n_shards]

    def start(self) -> None:
        """Detach the transport's Python reader (the runtime thread owns
        the inbox now), wire the eventfd into the asyncio loop, start the
        thread."""
        e = self.engine
        e.transport.detach_reader()
        if self.workers > 1:
            # install per-group frame routing BEFORE draining leftovers:
            # the legacy inbox stops growing (new frames land in group
            # inboxes for the workers), so the drain below sees a finite
            # backlog and nothing arrives worker-invisible in between
            t = e.transport
            classify = ctypes.cast(
                self.lib.rtm_frame_group_mask, ctypes.c_void_p
            ).value
            t._lib.rt_set_groups(t._handle, self.workers, classify, self.ctx)
        # leftovers the Python reader pulled before detaching go through
        # the native ingest while the arrays are still Python-owned; the
        # runtime's first iteration ticks unconditionally to pick them up
        all_rks = [e._rk, *self._extra_rks]
        item = e.transport.receive_raw_nowait()
        while item is not None:
            sender, data, addr, ln, release = item
            row = e._node_to_row.get(sender)
            try:
                if row is not None:
                    # every worker context ingests (each range-filters);
                    # the frame escalates to Python when ANY declines
                    rcs = [
                        (
                            xrk.ingest_addr(addr, ln, row, time.time())
                            if addr
                            else xrk.ingest(data, row, time.time())
                        )
                        for xrk in all_rks
                    ]
                    rc = 0 if any(r == 0 for r in rcs) else rcs[0]
                    if rc == 0:
                        if data is None:
                            data = ctypes.string_at(addr, ln)
                        msg = e.serializer.deserialize(data)
                        e.validator.validate_message(msg)
                        e._handle_message(sender, msg)
            except Exception:
                logger.exception("pre-start frame drain failed")
            finally:
                if release is not None:
                    release()
            item = e.transport.receive_raw_nowait()
        loop = asyncio.get_running_loop()
        loop.add_reader(self._event_fd, self._on_eventfd)
        self.lib.rtm_start(self.ctx)
        self._started = True

    def _on_eventfd(self) -> None:
        try:
            os.read(self._event_fd, 8)
        except BlockingIOError:
            pass
        self.engine._wake.set()

    def kick(self) -> None:
        """Nudge the runtime thread (e.g. after staging a command)."""
        t = self.engine.transport
        if t._handle:
            t._lib.rt_inbox_kick(t._handle)

    async def stop(self) -> None:
        """Shutdown ordering: runtime thread drain -> event mailbox drain
        -> (caller then flushes the apply plane and closes transport).
        The C side finishes its current iteration — decided waves already
        ingested complete apply + event staging before the join."""
        if self._stopped:
            return
        self._stopped = True
        try:
            asyncio.get_running_loop().remove_reader(self._event_fd)
        except Exception:
            pass
        self.kick()
        await asyncio.get_running_loop().run_in_executor(
            None, self.lib.rtm_stop, self.ctx
        )
        # drain every event the workers staged before exiting (mid-wave
        # shutdown must not lose staged result frames)
        while self.drain_events():
            pass
        if self.workers > 1:
            # clear per-group routing (undelivered group frames merge
            # back into the legacy inbox) and restore the primary rk
            # context to the full shard range for any post-stop use
            try:
                t = self.engine.transport
                if t._handle:
                    t._lib.rt_set_groups(t._handle, 0, None, None)
            except Exception:
                logger.exception("rt_set_groups clear failed")
            self.engine._rk.set_range(0, self.engine.n_shards, 0)

    def close(self) -> None:
        if self.ctx:
            if self.workers > 1:
                # the transport's classifier holds self.ctx — clear the
                # routing before rtm_destroy even when stop() was skipped
                # (exception teardown), or the io thread reads freed
                # memory on the next inbound frame
                try:
                    t = self.engine.transport
                    if getattr(t, "_handle", None):
                        t._lib.rt_set_groups(t._handle, 0, None, None)
                except Exception:
                    logger.exception("rt_set_groups clear failed")
            self._w_counters = [a.copy() for a in self._w_counters]
            self._w_stages = [a.copy() for a in self._w_stages]
            self._w_hists = [a.copy() for a in self._w_hists]
            self.counters = self._w_counters[0]
            self.stages = self._w_stages[0]
            self.hist = self._w_hists[0]
            self._fr_frozen = self.flight_snapshot()
            ctx, self.ctx = self.ctx, None
            self.lib.rtm_destroy(ctx)
        for xrk in self._extra_rks:
            xrk.close()

    # -- pause / resume (ownership hand-off) ---------------------------------

    def pause(self, timeout: float = 2.0) -> bool:
        """Quiesce the runtime thread; returns True when parked. While
        paused the caller owns the consensus columns and the store plane
        (sync adoption, persistence snapshots).

        Pause/resume are DEPTH-COUNTED: the drain_events() call in the
        wait loop below can dispatch an escalated frame (e.g. a peer's
        SyncRequest) whose handler enters a nested paused() context —
        without the counter, the nested exit's resume() would clear the
        C-side pause request while the outer section still relies on
        it, letting the runtime thread restart mid-adoption."""
        if not self._started or self._stopped:
            return True
        if self._pause_depth > 0:
            self._pause_depth += 1
            return True
        self.lib.rtm_pause(self.ctx)
        self.kick()
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = int(self.lib.rtm_state(self.ctx))
            if st in (RTM_PAUSED, RTM_STOPPED):
                self._pause_depth = 1
                return True
            # keep the mailbox moving: a runtime blocked in ev_push
            # (full ring) can only reach its pause point once Python
            # drains — and drain_events is reentrancy-safe (each pass
            # iterates a private copy of the drained bytes)
            self.drain_events()
            time.sleep(0.0002)
        # withdraw the request: a pause nobody owns would park the
        # thread later with no matching resume
        self.lib.rtm_resume(self.ctx)
        return False

    def resume(self) -> None:
        if self._pause_depth > 0:
            self._pause_depth -= 1
            if self._pause_depth == 0 and self.ctx:
                self.lib.rtm_resume(self.ctx)

    class _Paused:
        def __init__(self, bridge):
            self.bridge = bridge
            self.ok = False

        def __enter__(self):
            self.ok = self.bridge.pause()
            if not self.ok:
                logger.warning(
                    "runtime pause timed out; skipping the quiesced section"
                )
            return self

        def __exit__(self, *exc):
            if self.ok:
                self.bridge.resume()
            return False

    def paused(self) -> "RuntimeBridge._Paused":
        return RuntimeBridge._Paused(self)

    # -- command staging -----------------------------------------------------

    def _push(self, rec: bytes, kick: bool = True) -> bool:
        rc = int(self.lib.rtm_cmd_push(self.ctx, rec, len(rec)))
        if rc == 0:
            if kick:
                self.kick()
            else:
                self._kick_pending = True
            return True
        return False

    def _push_reliable(self, rec: bytes) -> None:
        """Push or queue for retry — for commands whose loss would
        corrupt bookkeeping (frontier advances, decision adopts)."""
        if self._cmd_backlog or not self._push(rec, kick=False):
            self._cmd_backlog.append(rec)

    def _retry_backlog(self) -> None:
        while self._cmd_backlog:
            rec = self._cmd_backlog[0]
            if not self._push(rec):
                return
            self._cmd_backlog.pop(0)

    def open_scalar(self, shard: int, slot: int, init: int, frame: bytes) -> bool:
        rec = struct.pack("<BIQBI", CMD_OPEN_SCALAR, shard, slot, init, len(frame))
        return self._push(rec + frame)

    def _group_of(self, shard: int) -> int:
        """Contiguous shard→group map (the runtime.cpp twin)."""
        if self.workers <= 1:
            return 0
        return min(int(shard) // self._chunk, self.workers - 1)

    def advance(self, items) -> None:
        """items: iterable of (shard, new_applied). With multiple
        workers the entries split into one group-pure CMD_ADVANCE per
        owning worker (the C router dispatches a record whole)."""
        items = list(items)
        if self.workers > 1:
            by_group: dict[int, list] = {}
            for s, upto in items:
                by_group.setdefault(self._group_of(s), []).append((s, upto))
            parts = list(by_group.values())
        else:
            parts = [items]
        for part in parts:
            rec = struct.pack("<BI", CMD_ADVANCE, len(part)) + b"".join(
                struct.pack("<IQ", s, upto) for s, upto in part
            )
            self._push_reliable(rec)

    def decide(self, shard: int, slot: int, value: int) -> None:
        self._push_reliable(
            struct.pack("<BIQB", CMD_DECIDE, shard, slot, value)
        )

    # CMD_OPEN_WAVE entry record layout (runtime.cpp): packed 20 bytes
    _CMD_ENT_DT = np.dtype(
        [("shard", "<u4"), ("slot", "<u8"), ("bidx", "<u4"), ("nops", "<u4")]
    )

    def open_wave(
        self, token: int, want: bool, ent: np.ndarray, op_lens,
        announce: bytes, blob: bytes,
    ) -> bool:
        """``ent``: a _CMD_ENT_DT structured array."""
        ops = np.ascontiguousarray(op_lens, np.uint32).tobytes()
        head = struct.pack(
            "<BQBIII",
            CMD_OPEN_WAVE,
            token,
            1 if want else 0,
            len(ent),
            len(announce),
            len(blob),
        ) + struct.pack("<I", len(ops) // 4)
        return self._push(head + ent.tobytes() + ops + announce + blob)

    # -- the submission pump (Python -> commands) ----------------------------

    def pump(self) -> None:
        """One control-plane pass: queued scalar submissions, ready
        Python-side block bindings, buffered adoptable decisions."""
        e = self.engine
        self._retry_backlog()
        self._pump_scalar()
        self._pump_bindings()
        self._pump_blocks()
        self._pump_buffered_decisions()
        e._forward_submissions()
        if self._kick_pending:
            self._kick_pending = False
            self.kick()

    def _head(self, s: int) -> int:
        rt = self.engine.rt
        return int(max(rt.next_slot[s], rt.applied_upto[s]))

    def _pump_scalar(self) -> None:
        e = self.engine
        rt = e.rt
        n = e.n_shards
        queued = np.nonzero(rt.queue_len[:n] > 0)[0]
        if len(queued) == 0:
            return
        from rabia_tpu_torch.engine.leader import slot_proposer

        now = time.time()
        for s in queued:
            s = int(s)
            sh = rt.shards[s]
            if rt.in_flight[s]:
                continue
            head = self._head(s)
            if self._cmd_slot[s] >= head:
                continue  # a command for this head is already staged
            if head < int(rt.tainted_upto[s]):
                continue  # taint release stays with the asyncio logic
            while sh.queue and sh.queue[0].batch.id in sh.applied_ids:
                done_sub = sh.queue.popleft()
                e._settle_from_ledger(sh, done_sub)
            if not sh.queue:
                continue
            if e._decided_unapplied(
                sh, sh.queue[0].batch.id, unseen_holds=True
            ):
                # committed in an earlier slot that has not applied yet:
                # it settles when it applies (the asyncio owner's
                # _open_slots guard); proposing it again commits it twice
                continue
            proposer_row = slot_proposer(s, head, e.R)
            if proposer_row != e.me:
                # forwarded proposer unresponsive: force the null slot
                # that rotates the proposer (_open_slots give-up parity)
                sub = sh.queue[0]
                alive = (
                    e._row_to_node[proposer_row] in e.rt.active_nodes
                )
                give_up = (
                    e.config.phase_timeout
                    if alive
                    else max(self._grace, e.config.phase_timeout / 4)
                )
                if (
                    sub.first_forwarded_at
                    and now - sub.first_forwarded_at > give_up
                    and sh.buf_propose.get(head) is None
                ):
                    if self.open_scalar(s, head, V0, b""):
                        self._cmd_slot[s] = head
                continue  # _forward_submissions routes it
            bp = sh.buf_propose.get(head)
            if bp is not None:
                # existing binding wins the slot — open without rebinding
                if self.open_scalar(s, head, V1, b""):
                    self._cmd_slot[s] = head
                continue
            sub = sh.queue[0]
            msg = ProtocolMessage.new(
                e.node_id,
                Propose(
                    shard=s,
                    phase=pack_phase(head, 0),
                    batch_id=sub.batch.id,
                    value=StateValue.V1,
                    batch=sub.batch,
                ),
            )
            try:
                frame = e.serializer.serialize(msg)
            except Exception:
                logger.exception("propose serialize failed (shard %d)", s)
                continue
            # bind only AFTER the command lands in the ring: a binding
            # left behind by a failed push would make the next pump pass
            # take the bp-reuse branch above and open with an EMPTY
            # frame — the Propose would never reach the wire and the
            # slot decides V0 / stalls until retransmit
            if self.open_scalar(s, head, V1, frame):
                self._cmd_slot[s] = head
                e._h_stage["submit_propose"].observe(now - sub.submitted_at)
                e.flight.record(
                    FRE_PROPOSE, shard=s, slot=head,
                    batch=fr_hash(sub.batch.id),
                )
                sh.payloads[sub.batch.id] = sub.batch
                sh.buf_propose[head] = (sub.batch.id, sub.batch)

    def _pump_bindings(self) -> None:
        """Follower-side scalar opens: a Propose binding for the head
        slot opens V1 (the _open_slots ``slot in sh.buf_propose`` branch
        — without this, contested slots fall to the V0 grace path and
        the decision sequence diverges from the asyncio owner)."""
        e = self.engine
        rt = e.rt
        n = e.n_shards
        flagged = np.nonzero(rt.prop_flag[:n])[0]
        for s in flagged:
            s = int(s)
            if rt.in_flight[s]:
                continue
            head = self._head(s)
            if self._cmd_slot[s] >= head:
                continue
            if head < int(rt.tainted_upto[s]):
                continue
            sh = rt.shards[s]
            if sh.buf_propose.get(head) is None:
                continue
            if self.open_scalar(s, head, V1, b""):
                self._cmd_slot[s] = head
                self._votes_wait.pop(s, None)

    def _binary_eligible(self, block, bidx) -> bool:
        """The apply_block_wave wave-routing rule — single-sourced in
        apps.native_store.binary_wave_eligible (consensus-critical:
        proposer and followers must route the wave the same way)."""
        from rabia_tpu_torch.apps.native_store import binary_wave_eligible

        return binary_wave_eligible(
            block.data, block.cmd_offsets, block.shard_starts,
            len(block.shards), bidx,
        )

    def _pump_blocks(self) -> None:
        """Python-side block bindings (own submits; escalated peer
        announces) whose slot reached the head become CMD_OPEN_WAVE."""
        e = self.engine
        rt = e.rt
        n = e.n_shards
        pend = e._blk_pending_slot[:n]
        live = np.nonzero(pend >= 0)[0]
        if len(live) == 0:
            return
        head = np.maximum(rt.next_slot[:n], rt.applied_upto[:n])
        # stale bindings the head overtook: void through the normal path
        for s in live[pend[live] < head[live]]:
            e._void_pending_block(int(s))
        ready = live[
            (pend[live] == head[live])
            & ~rt.in_flight[live]
            & (rt.tainted_upto[live] <= head[live])
        ]
        if len(ready) == 0:
            return
        refs = e._blk_pending_ref[ready]
        for ref in np.unique(refs):
            rec = e._blk_registry.get(int(ref))
            sel_all = ready[refs == ref]
            bidx_all = e._blk_pending_idx[sel_all].astype(np.int64)
            if rec is not None and len(sel_all):
                # bound one command record well under the ring cap: the
                # record carries entries + op lens + announce + blob, so
                # chunk by entries when the blob estimate gets large
                blob_est = int(
                    rec.block.cmd_offsets[-1] if len(rec.block.data) else 0
                )
                per_entry = 20 + 8 + max(
                    1, blob_est * 2 // max(1, len(rec.block))
                )
                # floor of 1, NOT a bigger round number: forcing e.g. 64
                # entries per chunk when per_entry is huge builds a
                # record larger than the command ring — it can never be
                # pushed and the binding would retry-wedge forever
                max_entries = max(
                    1, (self._cmd_cap // 4) // per_entry
                )
            else:
                max_entries = len(sel_all) or 1
            if rec is None:
                e._blk_pending_ref[sel_all] = -1
                e._blk_pending_slot[sel_all] = -1
                continue
            if self.workers > 1:
                # one CMD_OPEN_WAVE per shard group: each worker owns a
                # contiguous range, and the C router dispatches a record
                # whole — a cross-group wave becomes group-pure records
                # (each with its own token; the registry refcount spans
                # them, and _on_wave settles per entry as ever)
                gsel = np.minimum(
                    sel_all // self._chunk, self.workers - 1
                )
                group_parts = [
                    (sel_all[gsel == g], bidx_all[gsel == g])
                    for g in np.unique(gsel)
                ]
            else:
                group_parts = [(sel_all, bidx_all)]
            for sel_part, bidx_part in group_parts:
              for chunk in range(0, len(sel_part), max_entries):
                sel = sel_part[chunk : chunk + max_entries]
                bidx = bidx_part[chunk : chunk + max_entries]
                # transfer ownership pend -> token BEFORE staging (a
                # reject event re-routes through the registry)
                e._blk_pending_ref[sel] = -1
                e._blk_pending_slot[sel] = -1
                block = rec.block
                slots = head[sel]
                own = rec.out is not None
                if own:
                    block.slots[bidx] = slots
                token = self._next_token
                self._next_token += 1
                self._tokens[token] = int(ref)
                self._ref_tokens.setdefault(int(ref), []).append(token)
                counts = block.counts[bidx].astype(np.int64)
                ent = np.empty(len(sel), self._CMD_ENT_DT)
                ent["shard"] = sel
                ent["slot"] = slots
                ent["bidx"] = bidx
                ent["nops"] = counts
                announce = b""
                if own:
                    sub = (
                        block
                        if len(bidx) == len(block)
                        else block.subset(bidx)
                    )
                    try:
                        announce = e.serializer.serialize(
                            ProtocolMessage.new(
                                e.node_id, ProposeBlock(block=sub)
                            )
                        )
                    except Exception:
                        logger.exception("block announce serialize failed")
                blob = b""
                op_lens: np.ndarray | list = []
                if self.native_apply and self._binary_eligible(block, bidx):
                    offs = block.cmd_offsets
                    starts = block.shard_starts
                    if len(bidx) == len(block):
                        blob = block.data
                        op_lens = (offs[1:] - offs[:-1]).astype(np.int64)
                    else:
                        parts = []
                        lens = []
                        mv = memoryview(block.data)
                        for i in bidx:
                            lo, hi = int(starts[i]), int(starts[i + 1])
                            parts.append(mv[int(offs[lo]) : int(offs[hi])])
                            lens.extend(
                                int(offs[j + 1] - offs[j])
                                for j in range(lo, hi)
                            )
                        blob = b"".join(parts)
                        op_lens = lens
                else:
                    # Python applies this wave (non-binary commands or
                    # no native plane): the C side runs consensus only
                    ent["nops"] = 0
                    op_lens = []
                if not self.open_wave(
                    token, own, ent, op_lens, announce, blob
                ):
                    # command ring full: put the binding back and retry
                    # on the next pass
                    del self._tokens[token]
                    toks = self._ref_tokens.get(int(ref))
                    if toks is not None:
                        toks.remove(token)
                        if not toks:
                            del self._ref_tokens[int(ref)]
                    e._blk_pending_ref[sel] = int(ref)
                    e._blk_pending_idx[sel] = bidx
                    e._blk_pending_slot[sel] = slots
                    break

    def _pump_buffered_decisions(self) -> None:
        """Adoptable peer decisions Python buffered (gap decisions that
        escalated): adopt them at the head through CMD_DECIDE, mirroring
        the _open_slots adoption branch."""
        e = self.engine
        rt = e.rt
        n = e.n_shards
        dec = np.nonzero(rt.dec_flag[:n])[0]
        for s in dec:
            s = int(s)
            sh = rt.shards[s]
            if rt.in_flight[s]:
                continue
            head = self._head(s)
            bd = sh.buf_decision.get(head)
            if bd is None:
                if not sh.buf_decision or max(sh.buf_decision) < head:
                    rt.dec_flag[s] = False
                continue
            if bd[0] not in (V0, V1):
                continue
            if self._cmd_slot[s] >= head:
                continue  # an adopt/open for this head is already staged
            self.decide(s, head, int(bd[0]))
            # C confirms an accepted adopt with EV_DECIDE (a rejected
            # one is decided by the in-flight consensus instead) — the
            # record happens there, never here
            self._cmd_slot[s] = head

    # -- event mailbox drain -------------------------------------------------

    def drain_events(self) -> int:
        """Drain and process mailbox events; returns records processed."""
        e = self.engine
        lib = self.lib
        total = 0
        while True:
            got = int(
                lib.rtm_ev_drain(
                    self.ctx, self._ev_ptr, len(self._ev_buf)
                )
            )
            if got <= 0:
                break
            buf = self._ev_buf[:got].tobytes()
            at = 0
            while at + 4 <= got:
                (ln,) = struct.unpack_from("<I", buf, at)
                rec = buf[at + 4 : at + 4 + ln]
                at += 4 + ln
                total += 1
                try:
                    self._on_event(rec)
                except Exception:
                    logger.exception(
                        "runtime event processing failed (type %s)",
                        rec[0] if rec else None,
                    )
        if total:
            e._frontier_dirty = True
        if self._kick_pending:
            self._kick_pending = False
            self.kick()
        return total

    def _on_event(self, rec: bytes) -> None:
        t = rec[0]
        if t == EV_DECIDE:
            s, slot = struct.unpack_from("<IQ", rec, 1)
            value = rec[13]
            (opened,) = struct.unpack_from("<d", rec, 14)
            self._on_decide(int(s), int(slot), int(value), opened)
        elif t == EV_WAVE:
            self._on_wave(rec)
        elif t == EV_FRAME:
            row = rec[1] | (rec[2] << 8)
            self._on_escalated_frame(int(row), rec[3:])
        elif t == EV_REJECT:
            token, bidx, s, slot = struct.unpack_from("<QIIQ", rec, 1)
            why = rec[25] if len(rec) > 25 else 0
            self._on_reject(int(token), int(bidx), int(s), int(slot),
                            int(why))
        elif t == EV_STALL:
            kind = rec[1]
            s, arg = struct.unpack_from("<IQ", rec, 2)
            self._on_stall(int(kind), int(s), int(arg))
        elif t == EV_LEDGER:
            self._on_ledger(rec)
        elif t == EV_REPAIR:
            (n,) = struct.unpack_from("<I", rec, 3)
            idxs = np.frombuffer(rec, "<u4", n, 7).astype(np.int64)
            self._on_repair_frame(idxs, rec[7 + 4 * n :])

    # -- decision / apply handlers ------------------------------------------

    def _record(
        self, s: int, slot: int, value: int, opened: float,
        count: bool = True,
    ) -> SlotRecord:
        """The Python half of _record_decision: ledger dicts, flight,
        counters, clocks — never the consensus columns (C owns them)."""
        e = self.engine
        sh = e.rt.shards[s]
        rec = sh.decisions.get(slot)
        if rec is None:
            bid = None
            bp = sh.buf_propose.get(slot)
            if bp is not None and value == V1:
                bid = bp[0]
            elif value == V1 and e._blk_pending_slot[s] == slot:
                # a received block binding we never opened: use it as
                # the payload source (asyncio _process_decided parity)
                ref = int(e._blk_pending_ref[s])
                rec_blk = e._blk_registry.get(ref)
                if rec_blk is not None and rec_blk.out is None:
                    bi = int(e._blk_pending_idx[s])
                    bid = rec_blk.block.batch_id_for(bi)
                    sh.payloads[bid] = rec_blk.block.materialize_batch(bi)
                    e._unref_block(ref, 1)
                    e._blk_pending_ref[s] = -1
                    e._blk_pending_slot[s] = -1
            rec = SlotRecord(value=StateValue(value), batch_id=bid)
            sh.decisions[slot] = rec
            e.flight.record(
                FRE_DECIDE, shard=s, slot=slot, arg=value,
                batch=fr_hash(bid) if bid is not None else 0,
            )
            if count:
                # wave entries arrive pre-counted by _on_wave — its
                # _record calls pass count=False so the conformance
                # gate's counter parity holds on sync-overtaken runs
                if value == V1:
                    e.rt.decided_v1 += 1
                else:
                    e.rt.decided_v0 += 1
        if opened > 0.0:
            e._h_stage["propose_decide"].observe(time.time() - opened)
        if self._cmd_slot[s] <= slot:
            self._cmd_slot[s] = -1
        # the consensus columns (next_slot, opened_at, dec ring) were
        # already advanced by the runtime thread — only Python-owned
        # bookkeeping here
        e.rt.head_fwd_at[s] = 0.0
        for sub in sh.queue:
            sub.forwarded_at = 0.0
            sub.first_forwarded_at = 0.0
        return rec

    def _on_decide(self, s: int, slot: int, value: int, opened: float) -> None:
        self._votes_wait.pop(s, None)
        self._record(s, slot, value, opened)
        self._try_apply(s)

    def _try_apply(self, s: int) -> None:
        """Apply decided scalar slots in order from the event-ordered
        mirror frontier; advances the C column through CMD_ADVANCE (the
        runtime thread stays the single writer)."""
        e = self.engine
        sh = e.rt.shards[s]
        applied = int(self._applied[s])
        advanced = False
        while True:
            wal_batch = None  # set iff this slot actually applies a batch
            rec = sh.decisions.get(applied)
            if rec is None:
                break
            if rec.applied:
                applied += 1
                advanced = True
                continue
            if rec.value == StateValue.V1:
                batch = (
                    sh.payloads.get(rec.batch_id)
                    if rec.batch_id is not None
                    else None
                )
                if rec.batch_id is None:
                    bp = sh.buf_propose.get(applied)
                    if bp is not None:
                        rec.batch_id = bp[0]
                        batch = sh.payloads.get(bp[0])
                if rec.batch_id is not None and rec.batch_id in sh.applied_ids:
                    for i, sub in enumerate(list(sh.queue)):
                        if sub.batch.id == rec.batch_id:
                            del sh.queue[i]
                            e._settle_from_ledger(sh, sub)
                            break
                    e._settle_block_waiter_from_ledger(sh, rec.batch_id)
                elif batch is None:
                    # payload not here yet: wait for the Propose / sync
                    # (one wait at a time — per-slot spawns under a wide
                    # adopted backlog measurably tax the loop)
                    e._sync_for_missing_payload(s, applied)
                    break
                else:
                    try:
                        responses = e.sm.apply_batch(batch)
                    except Exception as exc:
                        logger.warning(
                            "apply failed for batch %s on shard %d: %s",
                            rec.batch_id, s, exc,
                        )
                        responses = None
                    sh.applied_ids[rec.batch_id] = None
                    sh.applied_results[rec.batch_id] = responses
                    # demoted/forwarded coalesced entry: per-client
                    # alias ids keep their exactly-once bookkeeping
                    e.register_applied_aliases(
                        s, applied,
                        e._batch_aliases(sh, rec.batch_id, batch),
                        responses, have_responses=True,
                    )
                    wal_batch = batch
                    e.rt.state_version += 1
                    e.rt.v1_applied[s] += 1
                    if responses is not None:
                        e._resolve_local(sh, batch, responses)
                    else:
                        from rabia_tpu_torch.core.errors import RabiaError

                        e._fail_local(
                            sh, batch.id, RabiaError("apply failed")
                        )
            else:
                e._requeue_null_slot(sh, applied, rec)
            rec.applied = True
            if e._wal is not None:
                # durability plane: the scalar lane applies in Python on
                # the runtime path, so it stages here (the C thread
                # stages only the waves it applies itself)
                e._wal_stage(s, applied, int(rec.value), batch=wal_batch)
            e.flight.record(
                FRE_APPLY, shard=s, slot=applied, arg=int(rec.value),
                batch=(
                    fr_hash(rec.batch_id)
                    if rec.batch_id is not None
                    else 0
                ),
            )
            e._h_stage["decide_apply"].observe(time.time() - rec.decided_at)
            applied += 1
            advanced = True
            sh.gc_upto(applied)
        if advanced:
            self._applied[s] = applied
            self.advance([(s, applied)])
            e.rt.last_apply_time = time.time()
            e._frontier_dirty = True
            if e.persistence is not None:
                e._dirty = True

    # EV_WAVE entry record layout (runtime.cpp): packed 17-byte records
    _WAVE_ENT_DT = np.dtype(
        [("shard", "<u4"), ("slot", "<u8"), ("bidx", "<u4"), ("flags", "u1")]
    )

    def _drop_tokens_for(self, ref: int) -> None:
        """Retire every token of a block ref (all shard groups' records)
        once its registry entry is gone."""
        for t in self._ref_tokens.pop(ref, ()):
            self._tokens.pop(t, None)

    def _on_wave(self, rec: bytes) -> None:
        """A decided block wave. The common case — a natively applied
        peer wave — reduces to a handful of vectorized ops: the per-slot
        work already happened on the runtime thread, and Python only
        mirrors counters/frontiers (plus future settles on the
        proposer). The per-entry Python loop survives only for the
        slow lanes (own-block settles, V0 demotes, Python applies)."""
        e = self.engine
        rt = e.rt
        (token,) = struct.unpack_from("<Q", rec, 1)
        applied_flag = rec[9]
        has_results = rec[10]
        (count,) = struct.unpack_from("<I", rec, 11)
        ents = np.frombuffer(rec, self._WAVE_ENT_DT, count, 15)
        at = 15 + 17 * count
        shards = ents["shard"].astype(np.int64)
        slots = ents["slot"].astype(np.int64)
        values = (ents["flags"] & 3).astype(np.int64)
        in_order = (ents["flags"] & 4) == 0
        res_offs = res_blob = None
        if has_results:
            rlens = np.frombuffer(rec, "<u4", count, at).astype(np.int64)
            at += 4 * count
            res_offs = np.concatenate(([0], np.cumsum(rlens)))
            res_blob = rec[at:]
        ref = self._tokens.get(token) if token else None
        breg = e._blk_registry.get(ref) if ref is not None else None
        out = breg.out if breg is not None else None

        v1 = values == V1
        n_v1 = int(v1.sum())
        rt.decided_v1 += n_v1
        rt.decided_v0 += count - n_v1
        # a wave decide supersedes any staged scalar command marker
        self._cmd_slot[shards] = -1
        for j in range(min(count, 8)):
            # own-block waves know their batch ids; stamping them makes
            # the (shard, slot) discoverable by TRACE slicing, so a
            # cross-tier trace shows the wave decide/apply on the
            # proposer (peer waves have no registry entry — hash 0)
            bh = (
                fr_hash(breg.block.batch_id_for(int(ents["bidx"][j])))
                if breg is not None
                else 0
            )
            e.flight.record(
                FRE_DECIDE, shard=int(shards[j]), slot=int(slots[j]),
                arg=int(values[j]), batch=bh,
            )
            if applied_flag:
                e.flight.record(
                    FRE_APPLY, shard=int(shards[j]), slot=int(slots[j]),
                    arg=int(values[j]), batch=bh,
                )
        if applied_flag:
            done = in_order
            np.maximum.at(self._applied, shards[done], slots[done] + 1)
            applied_v1 = done & v1
            n_av1 = int(applied_v1.sum())
            rt.state_version += n_av1
            np.add.at(rt.v1_applied, shards[applied_v1], 1)
            if e._wal is not None and breg is not None and n_av1:
                # durability plane: the C thread staged these waves with
                # a zero batch-id field (it cannot derive deterministic
                # ids); backfill (shard, slot) -> bid with K_LEDGER
                # records OFF the commit path so recovery repopulates
                # the dedup ledger
                wal = e._wal
                for j in np.nonzero(applied_v1)[0]:
                    ebid = breg.block.batch_id_for(int(ents["bidx"][j]))
                    # live ledger entry next to the K_LEDGER backfill
                    # (failover replays dedup at the gateway pre-drive
                    # check; durable clusters only by this guard) —
                    # inserted even when staging fails: the live dedup
                    # must cover every applied entry
                    rt.shards[int(shards[j])].applied_ids[ebid] = None
                    if wal is None:
                        continue
                    try:
                        wal.stage_ledger(
                            int(shards[j]), int(slots[j]),
                            ebid.value.bytes,
                        )
                    except Exception:
                        logger.exception("wal ledger stage failed")
                        wal = None  # one failure wedges the log
            if breg is not None and breg.block.aliases and n_av1:
                # coalescing lane: every covered client's deterministic
                # batch id enters the dedup ledger (+ K_LEDGER records
                # on durable clusters), with its slice of the entry's
                # responses — the wave blob parses lazily, once per
                # entry, only on coalesced waves
                for j in np.nonzero(applied_v1)[0]:
                    bi = int(ents["bidx"][j])
                    al = breg.block.alias_ids_for(bi)
                    if not al:
                        continue
                    if res_blob is not None:
                        base = _LazyResults(
                            res_blob, int(res_offs[j]),
                            int(res_offs[j + 1]),
                            int(breg.block.counts[bi]),
                        )
                        e.register_applied_aliases(
                            int(shards[j]), int(slots[j]), al,
                            base, have_responses=True,
                        )
                    else:
                        e.register_applied_aliases(
                            int(shards[j]), int(slots[j]), al,
                        )
            if breg is not None:
                # own block: settle the V1 futures, demote the V0 entries
                if out is not None:
                    sel = np.nonzero(applied_v1)[0]
                    bis = ents["bidx"][sel].tolist()
                    if res_blob is not None:
                        nops = breg.block.counts[bis].astype(np.int64)
                        los = res_offs[sel].tolist()
                        his = res_offs[sel + 1].tolist()
                        out.settle_many(
                            bis,
                            [
                                _LazyResults(
                                    res_blob, lo_, hi_, int(n_)
                                )
                                for lo_, hi_, n_ in zip(
                                    los, his, nops
                                )
                            ],
                        )
                    else:
                        from rabia_tpu_torch.core.errors import (
                            ResponsesUnavailableError,
                        )

                        err = ResponsesUnavailableError(
                            "results not staged"
                        )
                        out.settle_many(bis, [err] * len(bis))
                    for j in np.nonzero(done & ~v1)[0]:
                        # V0: only the proposer requeues (scalar retry);
                        # the demote unrefs its own entry
                        e._demote_block_entry(ref, int(ents["bidx"][j]))
                    e._unref_block(ref, n_av1)
                else:
                    e._unref_block(ref, int(done.sum()))
            py_sel = np.nonzero(~in_order)[0]
        else:
            py_sel = np.arange(count)
        if len(py_sel):
            self._apply_wave_py(
                ref,
                breg,
                [
                    (
                        int(shards[j]),
                        int(slots[j]),
                        int(ents["bidx"][j]),
                        int(values[j]),
                    )
                    for j in py_sel
                ],
            )
        rt.last_apply_time = time.time()
        if e.persistence is not None:
            e._dirty = True
        # token bookkeeping: when the block has no live entries left the
        # registry entry is gone — drop EVERY token mapping for the ref
        # (a group-split wave holds one token per shard group; only the
        # last one's event observes the empty registry)
        if ref is not None and ref not in e._blk_registry:
            self._drop_tokens_for(int(ref))

    def _on_ledger(self, rec: bytes) -> None:
        """EV_LEDGER: receiver-side batch-id ledger completeness (ROADMAP
        3c). A natively parsed PEER block's waves were C-staged with zero
        batch-id fields (token 0 — no Python block registry entry, so
        `_on_wave`'s proposer-path backfill never sees them). The record
        carries the wire block id + the in-order V1 (shard, slot)
        entries; batch ids derive deterministically from
        ``block_batch_id(block_id, shard)`` — the SAME ids the proposer
        and the scalar lane commit under — so a follower's recovery
        replay repopulates its ``applied_ids`` dedup ledger in parity
        with the proposer's."""
        e = self.engine
        if e._wal is None:
            return
        import uuid as _uuid

        from rabia_tpu_torch.core.blocks import block_batch_id

        block_id = _uuid.UUID(bytes=rec[1:17])
        (count,) = struct.unpack_from("<I", rec, 17)
        at = 21
        wal = e._wal
        for _ in range(count):
            s, slot = struct.unpack_from("<IQ", rec, at)
            at += 12
            bid = block_batch_id(block_id, int(s))
            # LIVE dedup too (round 15): a client that fails over to
            # THIS replica's gateway and replays a wave-lane seq must
            # hit the ledger here, not re-propose — the gateway's
            # pre-drive applied_ids check is only as good as this set
            # (durable clusters only; the gate keeps the persistence-
            # free bulk lanes free of per-entry Python dict work).
            # Inserted even when staging fails: the live dedup must
            # cover every applied entry
            e.rt.shards[int(s)].applied_ids[bid] = None
            if wal is None:
                continue
            try:
                wal.stage_ledger(int(s), int(slot), bid.value.bytes)
            except Exception:
                logger.exception("receiver wal ledger stage failed")
                wal = None  # one failure wedges the log

    def _apply_wave_py(self, ref, breg, entries) -> None:
        """Decided wave whose apply stays in Python (no native plane,
        non-binary commands, or sync-overtaken out-of-order entries)."""
        e = self.engine
        adv: list[tuple[int, int]] = []
        v1 = [(s, slot, bidx) for s, slot, bidx, val in entries if val == V1]
        v0 = [(s, slot, bidx) for s, slot, bidx, val in entries if val != V1]
        for s, slot, bidx in v0:
            if breg is not None:
                if breg.out is not None:
                    e._demote_block_entry(ref, bidx)
                else:
                    e._unref_block(ref, 1)
            if int(self._applied[s]) == slot:
                if e._wal is not None:
                    e._wal_stage(s, slot, 0)
                self._applied[s] = slot + 1
                adv.append((s, slot + 1))
        if v1:
            if breg is None:
                # payload gone: route through the scalar ledger so sync
                # repairs the slot (asyncio "lost" parity)
                for s, slot, bidx in v1:
                    self._record(s, slot, V1, 0.0, count=False)
                for s, _slot, _bidx in v1:
                    self._try_apply(s)
            else:
                block = breg.block
                want = breg.out is not None
                in_order, stale = [], []
                for t in v1:
                    (in_order
                     if int(self._applied[t[0]]) == t[1]
                     else stale).append(t)
                for s, slot, bidx in stale:
                    sh = e.rt.shards[s]
                    bid = block.batch_id_for(int(bidx))
                    sh.payloads[bid] = block.materialize_batch(int(bidx))
                    sh.buf_propose.setdefault(slot, (bid, None))
                    if breg.out is not None:
                        if int(self._applied[s]) < slot:
                            # not overtaken: an earlier slot of the shard
                            # waits for its payload. _try_apply applies this
                            # entry after it and settles the outcome
                            sh.block_waiters[bid] = (slot, breg.out, int(bidx))
                        else:
                            from rabia_tpu_torch.core.errors import (
                                ResponsesUnavailableError,
                            )

                            breg.out.settle(
                                int(bidx),
                                ResponsesUnavailableError(
                                    "block shard overtaken by sync"
                                ),
                            )
                    if int(self._applied[s]) > slot:
                        # snapshot already covered the slot — the scalar
                        # lane will never apply the demoted batch, so
                        # register the coalescing-lane aliases ids-only
                        # (covered clients' replays dedup instead of
                        # re-proposing a double apply)
                        e.register_applied_aliases(
                            s, slot, block.alias_ids_for(int(bidx)),
                            stage=False,
                        )
                    e._unref_block(ref, 1)
                    self._record(s, slot, V1, 0.0, count=False)
                    self._try_apply(s)
                if in_order:
                    bsel = np.asarray(
                        [b for _s, _sl, b in in_order], np.int64
                    )
                    try:
                        if e._is_vector_sm:
                            responses = e.sm.apply_block(
                                block, bsel, want_responses=want
                            )
                        else:
                            responses = [
                                e.sm.apply_batch(
                                    block.materialize_batch(int(bi))
                                )
                                for bi in bsel
                            ]
                    except Exception as exc:
                        logger.warning(
                            "block apply failed (ref %s): %s", ref, exc
                        )
                        responses = None
                        if want:
                            from rabia_tpu_torch.core.errors import RabiaError

                            err = RabiaError(f"apply failed: {exc}")
                            for _s, _sl, bi in in_order:
                                breg.out.settle(int(bi), err)
                    if want and responses is not None:
                        for (s_, sl_, bi), resp in zip(in_order, responses):
                            breg.out.settle(int(bi), resp)
                    if block.aliases:
                        # coalescing lane: per-client alias ids into the
                        # dedup ledger (own blocks only carry aliases)
                        for k, (s_, sl_, bi) in enumerate(in_order):
                            e.register_applied_aliases(
                                s_, sl_, block.alias_ids_for(int(bi)),
                                None if responses is None
                                else responses[k],
                                have_responses=want,
                            )
                    if e._wal is not None:
                        boffs = block.cmd_offsets
                        bstarts = block.shard_starts
                        bdata = block.data
                        for s, slot, bi in in_order:
                            lo = int(bstarts[bi])
                            hi = int(bstarts[bi + 1])
                            e._wal_stage(
                                s, slot, 1,
                                bid_bytes=block.batch_id_for(
                                    int(bi)
                                ).value.bytes,
                                ops=[
                                    bytes(bdata[boffs[k] : boffs[k + 1]])
                                    for k in range(lo, hi)
                                ],
                            )
                    for s, slot, _bi in in_order:
                        e.rt.state_version += 1
                        e.rt.v1_applied[s] += 1
                        self._applied[s] = slot + 1
                        adv.append((s, slot + 1))
                    e._unref_block(ref, len(in_order))
        if adv:
            self.advance(adv)

    def on_peer_decisions(self, p) -> None:
        """Escalated Decision frames (the RK_PY ones: gap slots, bid-
        bearing recovery entries). Mirrors _on_decision_one's cases
        WITHOUT touching the dec plane or the consensus columns: current
        or future slots buffer (the pump adopts them at the head via
        CMD_DECIDE); gap slots record+apply dict-side immediately."""
        e = self.engine
        bids = p.bids
        for i in range(len(p)):
            s = int(p.shards[i])
            if not (0 <= s < e.n_shards):
                continue
            slot = int(p.phases[i]) >> 16
            value = int(p.vals[i])
            if value not in (V0, V1):
                continue
            bid = p.bid_at(i) if bids is not None else None
            sh = e.rt.shards[s]
            if slot < int(e.rt.applied_upto[s]) and slot not in sh.decisions:
                continue  # stale: decided+applied (or bulk-consumed)
            rec = sh.decisions.get(slot)
            if rec is not None:
                if rec.batch_id is None and bid is not None:
                    rec.batch_id = bid  # late binding repair
                    if not rec.applied:
                        self._try_apply(s)
                continue
            if bid is not None and slot not in sh.buf_propose:
                sh.buf_propose[slot] = (bid, None)
            head = self._head(s)
            if slot < head and slot < int(self._applied[s]):
                continue  # consumed by a wave (no SlotRecord by design)
            if slot < head:
                # gap below the head: adopt immediately — it can never
                # "become current" again (asyncio gap-adopt parity)
                self._record(s, slot, value, 0.0)
                self._try_apply(s)
            else:
                sh.buf_decision[slot] = (value, bid)

    # -- escalated frames / rejects / stalls ---------------------------------

    def _on_escalated_frame(self, row: int, frame: bytes) -> None:
        e = self.engine
        sender = e._row_to_node.get(row)
        if sender is None:
            return
        try:
            msg = e.serializer.deserialize(frame)
            e.validator.validate_message(msg)
        except Exception as exc:
            e._py_drops["malformed"] += 1
            logger.warning("dropping bad escalated frame from %s: %s",
                           sender, exc)
            return
        e._handle_message(sender, msg)
        # a Propose that bound the head slot can unwedge apply or open
        p = msg.payload
        if isinstance(p, Propose) and 0 <= p.shard < e.n_shards:
            self._try_apply(int(p.shard))
        elif isinstance(p, ProposeBlock):
            self._repair_from_block(p.block)

    def _on_repair_frame(self, idxs: np.ndarray, frame: bytes) -> None:
        """EV_REPAIR: a ProposeBlock whose entries ``idxs`` the C binder
        could not bind (decided here before it arrived, or the shard's
        binding busy). Only those entries' payloads are used (the binder
        bound the others)."""
        e = self.engine
        try:
            msg = e.serializer.deserialize(frame)
        except Exception as exc:
            e._py_drops["malformed"] += 1
            logger.warning("dropping bad repair frame: %s", exc)
            return
        if isinstance(msg.payload, ProposeBlock):
            block = msg.payload.block
            idxs = idxs[idxs < len(block)]
            for s in e._repair_from_block(block, idxs):
                self._try_apply(s)

    def _repair_from_block(self, block) -> None:
        """Late ProposeBlock vs an already-decided slot: a shard that
        V0-grace-opened and then adopted the peers' V1 decision holds a
        payload-less record the binding acceptance rejected (slot <
        head). Use the announce as the payload source directly — the
        block-lane twin of the scalar lane's late-Propose repair —
        instead of riding a snapshot sync for bytes already on hand."""
        for s in self.engine._repair_from_block(block, stash=False):
            self._try_apply(s)

    def _on_reject(
        self, token: int, bidx: int, s: int, slot: int, why: int = 1
    ) -> None:
        e = self.engine
        if token == 0:
            # why=1: our scalar open was rejected — release the staged
            # marker so the pump retries. why=2: a voided PEER binding
            # (no Python owner) — an unrelated scalar command may still
            # be staged for this shard; leave its marker alone.
            if why == 1:
                self._cmd_slot[s] = -1
            return
        ref = self._tokens.get(token)
        breg = e._blk_registry.get(ref) if ref is not None else None
        if breg is None:
            if ref is not None:
                self._drop_tokens_for(int(ref))
            else:
                self._tokens.pop(token, None)
            return
        if breg.out is not None:
            e._demote_block_entry(ref, bidx)
        else:
            e._unref_block(ref, 1)
        # mirror _on_wave's lazy token cleanup: a wave whose entries are
        # ALL rejected never produces an EV_WAVE, so the mappings must
        # drop here once the registry entry is gone (every group's token)
        if ref not in e._blk_registry:
            self._drop_tokens_for(int(ref))

    def _on_stall(self, kind: int, s: int, arg: int) -> None:
        e = self.engine
        sh = e.rt.shards[s]
        if kind == 0:
            # proposer-payload retransmit: Propose for the stalled slot
            from rabia_tpu_torch.engine.leader import slot_proposer

            bp = sh.buf_propose.get(arg)
            if bp is not None and slot_proposer(s, arg, e.R) == e.me:
                e._send(
                    Propose(
                        shard=s,
                        phase=pack_phase(arg, 0),
                        batch_id=bp[0],
                        value=StateValue.V1,
                        batch=bp[1],
                    )
                )
        elif kind == 1:
            ref = self._tokens.get(arg)
            breg = e._blk_registry.get(ref) if ref is not None else None
            if breg is not None and breg.out is not None:
                now = time.time()
                if (
                    now - e._last_blk_retransmit.get(ref, 0.0)
                    >= e.config.phase_timeout
                ):
                    e._last_blk_retransmit[ref] = now
                    assigned = breg.block.slots >= 0
                    if assigned.all():
                        e._send(ProposeBlock(block=breg.block))
                    elif assigned.any():
                        e._send(
                            ProposeBlock(
                                block=breg.block.subset(
                                    np.nonzero(assigned)[0]
                                )
                            )
                        )
        elif kind == 2:
            # peer votes waiting with no binding: the V0 grace path —
            # but a binding that arrived meanwhile wins the slot as V1
            # (the pump opens it; never V0 over a binding). C already
            # held the full grace window before escalating; Python adds
            # one more pass so a binding in this drain batch can land.
            if (
                sh.buf_propose.get(arg) is not None
                or e._blk_pending_slot[s] == arg
            ):
                self._votes_wait.pop(s, None)
                return
            if self._votes_wait.pop(s, None) is None:
                self._votes_wait[s] = time.time()
                return
            if self.open_scalar(s, arg, V0, b""):
                self._cmd_slot[s] = arg

    # -- observability -------------------------------------------------------

    def counter(self, name: str) -> int:
        """One named RTM counter summed across every worker's block."""
        try:
            i = RTM_COUNTER_NAMES.index(name)
        except ValueError:
            return 0
        return sum(
            int(blk[i]) for blk in self._w_counters if i < len(blk)
        )

    def counters_dict(self) -> dict[str, int]:
        return {n: self.counter(n) for n in RTM_COUNTER_NAMES}

    def counters_dict_worker(self, g: int) -> dict[str, int]:
        """One worker's RTM counter block as a dict."""
        blk = self._w_counters[g]
        return {
            n: int(blk[i]) if i < len(blk) else 0
            for i, n in enumerate(RTM_COUNTER_NAMES)
        }

    def stage_ns(self, name: str) -> int:
        """Cumulative ns the runtime workers spent in one loop stage,
        summed across workers (RTS_* blocks; advisory read — torn values
        are metrics noise). With W workers the stage SUM tracks W×wall."""
        try:
            i = RTM_STAGE_NAMES.index(name)
        except ValueError:
            return 0
        return sum(int(blk[i]) for blk in self._w_stages if i < len(blk))

    def stage_ns_worker(self, g: int, name: str) -> int:
        """One worker's cumulative ns for one loop stage."""
        try:
            i = RTM_STAGE_NAMES.index(name)
        except ValueError:
            return 0
        blk = self._w_stages[g]
        return int(blk[i]) if i < len(blk) else 0

    def stages_dict(self) -> dict[str, int]:
        return {n: self.stage_ns(n) for n in RTM_STAGE_NAMES}

    def stages_dict_worker(self, g: int) -> dict[str, int]:
        blk = self._w_stages[g]
        return {
            n: int(blk[i]) if i < len(blk) else 0
            for i, n in enumerate(RTM_STAGE_NAMES)
        }

    def hist_stage(self, name: str):
        """One SLO histogram row as ``(bucket_counts, count, sum_s)`` —
        the :class:`~rabia_tpu_torch.obs.registry.Histogram` source shape —
        or None when the stage is unknown or the block's bucket geometry
        does not match this build's Python twin (ABI version guard)."""
        from rabia_tpu_torch.obs.registry import (
            SLO_BUCKETS,
            SLO_MIN_EXP,
            SLO_SUB_BITS,
        )

        try:
            i = RTM_HIST_STAGES.index(name)
        except ValueError:
            return None
        if (
            self._hist_buckets != len(SLO_BUCKETS)
            or self._hist_sub_bits != SLO_SUB_BITS
            or self._hist_min_exp != SLO_MIN_EXP
            or i >= len(self.hist)
        ):
            return None
        # sum the stage row across every worker's block (identical
        # geometry: bucket counts, total count, and sum_ns all add)
        row = self._w_hists[0][i].astype(np.uint64).copy()
        for blk in self._w_hists[1:]:
            if i < len(blk):
                row += blk[i]
        return (
            row[: self._hist_buckets],
            int(row[self._hist_buckets]),
            float(row[self._hist_buckets + 1]) * 1e-9,
        )

    def flight_head(self) -> int:
        if not self.ctx:
            return 0
        return int(self.lib.rtm_flight_head(self.ctx))

    def _one_flight(self, g: int) -> np.ndarray:
        from rabia_tpu_torch.obs.flight import FR_DTYPE

        view = self._w_fr_views[g]
        if not self.ctx or len(view) == 0:
            return np.zeros(0, FR_DTYPE)
        if g == 0:
            head = int(self.lib.rtm_flight_head(self.ctx))
        else:
            head = int(self.lib.rtm_flight_head_w(self.ctx, g))
        cap = len(view)
        if head <= cap:
            return view[:head].copy()
        i = head % cap
        return np.concatenate([view[i:], view[:i]])

    def flight_snapshot(self) -> np.ndarray:
        from rabia_tpu_torch.obs.flight import FR_DTYPE

        if self._fr_frozen is not None:
            return self._fr_frozen
        if not self.ctx:
            return np.zeros(0, FR_DTYPE)
        parts = [self._one_flight(g) for g in range(self.workers)]
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.zeros(0, FR_DTYPE)
        merged = np.concatenate(parts)
        # the engine's flight merger sorts globally on t_ns; keep each
        # worker's window intact and pre-order across workers here
        return merged[np.argsort(merged["t_ns"], kind="stable")]


class _LazyResults:
    """Per-entry result view over the runtime's staged [u32 len][payload]
    records: length is known up front (the entry's op count), payload
    bytes slice out of the shared wave blob on first access — settling
    thousands of proposer-side futures per wave costs no per-op work
    until a caller actually reads the responses."""

    __slots__ = ("_raw", "_lo", "_hi", "_n", "_parsed")

    def __init__(self, raw: bytes, lo: int, hi: int, n: int) -> None:
        self._raw = raw
        self._lo = lo
        self._hi = hi
        self._n = n
        self._parsed: Optional[list[bytes]] = None

    def _materialize(self) -> list[bytes]:
        if self._parsed is None:
            out = _parse_result_records(self._raw[self._lo : self._hi])
            self._parsed = out if out is not None else []
        return self._parsed

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __eq__(self, other) -> bool:
        return list(self._materialize()) == list(other)

    def __repr__(self) -> str:
        return f"_LazyResults(n={self._n})"


def _parse_result_records(raw: bytes) -> Optional[list[bytes]]:
    """[u32 len][payload]... records -> list of payload bytes."""
    if not raw:
        return []
    out = []
    at = 0
    n = len(raw)
    while at + 4 <= n:
        (ln,) = struct.unpack_from("<I", raw, at)
        if at + 4 + ln > n:
            return None
        out.append(raw[at + 4 : at + 4 + ln])
        at += 4 + ln
    return out
