"""RabiaEngine: the host event loop around the vectorized consensus kernel.

The port of the reference's ``rabia_tpu/engine/engine.py``. The engine drives
propose → vote-R1 → vote-R2 → decide → apply. The consensus *math* of
those handlers (vote rules, tallies, coin, decision) lives in the node
kernel — :class:`rabia_tpu_torch.kernel.host_driver.HostNodeKernel`
(numpy, the host hot loop) or, with ``KernelConfig.backend="jax"``,
:class:`rabia_tpu_torch.kernel.phase_driver.NodeKernel` on a card (one
``node_cycle`` launch of ``csrc/node_kernel.cu`` and one fetch a tick;
the configuration value keeps the reference's spelling) — and runs for
all S shards in one call per round; this module is everything around
it: message routing, slot lifecycle, batch payloads, state-machine
application, persistence, heartbeats, sync and stats.

The native host plane runs under it as in the reference: the C columnar
helpers and tick context (``native/hostkernel.cpp``, ``_hk_lib`` and
``_rk``; ``RABIA_PY_TICK=1`` forces the Python tick), the C codec (the
serializer's ``_binary._native``) and, on a TCP cluster with a native store and no
persistence, the GIL-free runtime (``_rtm``; ``RABIA_PY_RUNTIME=1`` forces
the asyncio orchestration). The Python paths stay the semantics owners;
``health()["planes"]`` says which paths run. With a WAL persistence layer
(``persistence/native_wal.WalPersistence``) decided waves stage into the
log, recovery runs at ``initialize()``, and the runtime engages when the
WAL's writer is native. The device backend runs none of the native tick
and runtime (as in the reference: ``health()["planes"]`` reports both
as ``python``). On a card its inbox, decision and open planes are views
of the node kernel's pinned plane buffer, which the tick's one launch
reads in place over the link, and its results come back in the kernel's
pinned host image: a tick copies nothing, whatever ``zero_copy_inbox``
says. On the CPU the planes are copied a tick, or, with
``zero_copy_inbox``, adopted in place by dlpack.

Hot-path design (SURVEY.md §7.4.4): everything per-round is **columnar** —
vote vectors arrive as numpy arrays (:class:`~rabia_tpu_torch.core.messages.
_VoteVector`), are routed to the kernel ledger with bulk scatters, and the
kernel outbox is turned back into broadcast vote vectors with bulk gathers.
Per-shard Python runs only on *events* (slot open, decision record, batch
apply), never in per-round scans.

Protocol notes (deliberate divergences from the reference implementation,
both fixing documented deviations — SURVEY.md §3.1):

1. Round-1 AND round-2 votes are **broadcast** to all replicas (the spec's
   reliable-broadcast model, docs/weak_mvc.ivy:133-186), not unicast to the
   proposer.
2. The round-2 tie-break is a **common coin** shared by construction
   (same seed + (shard, slot, phase) on every replica), not per-node RNG.

Slot model: each shard carries an ordered log of decision slots. The
proposer of (shard, slot) rotates deterministically
(:func:`rabia_tpu_torch.engine.leader.slot_proposer`); non-proposers forward
their submissions to the upcoming proposer (NewBatch). A crashed proposer's
slot times out on peers, who open it with vote V0 — weak MVC then decides
V0 (a null slot) and the rotation moves on: leaderless liveness without
elections.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import time
import uuid
from typing import Optional, Sequence

import numpy as np
import torch

from rabia_tpu_torch.core.blocks import PayloadBlock
from rabia_tpu_torch.core.config import RabiaConfig
from rabia_tpu_torch.core.errors import (
    PersistenceError,
    QuorumNotAvailableError,
    RabiaError,
    ResponsesUnavailableError,
    ValidationError,
)
from rabia_tpu_torch.core.messages import (
    Decision,
    DecisionEntry,
    HeartBeat,
    MessageType,
    NewBatch,
    ProposeBlock,
    ProtocolMessage,
    Propose,
    QuorumNotification,
    SyncRequest,
    SyncResponse,
    VoteEntry,
    VoteRound1,
    VoteRound2,
)
from rabia_tpu_torch.core.network import (
    ClusterConfig,
    NetworkEventHandler,
    NetworkMonitor,
    NetworkTransport,
)
from rabia_tpu_torch.core.persistence import PersistedEngineState, PersistenceLayer
from rabia_tpu_torch.core.serialization import Serializer
from rabia_tpu_torch.core.state_machine import StateMachine, VectorStateMachine
from rabia_tpu_torch.core.tracing import span
from rabia_tpu_torch.obs.flight import (
    FRE_ADVANCE,
    FRE_APPLY,
    FRE_CARRY,
    FRE_CAST_R2,
    FRE_DECIDE,
    FRE_DROP,
    FRE_FRAME_IN,
    FRE_FRAME_OUT,
    FRE_OPEN,
    FRE_PROPOSE,
    FRE_ROUTE1,
    FRE_ROUTE2,
    FRE_STALE,
    FRE_STEP_DECIDE,
    FRE_SUBMIT,
    FRE_WAL,
    fr_hash,
)
from rabia_tpu_torch.core.types import (
    ABSENT,
    V0,
    V1,
    BatchId,
    CommandBatch,
    NodeId,
    StateValue,
    sorted_nodes,
)
from rabia_tpu_torch.core.validation import MessageValidator
from rabia_tpu_torch.engine.leader import LeaderSelector, slot_proposer, slot_proposer_vec
from rabia_tpu_torch.engine.state import (
    EngineRuntime,
    EngineStatistics,
    PendingSubmission,
    SlotRecord,
)
from rabia_tpu_torch.kernel.host_driver import HostNodeKernel
from rabia_tpu_torch.kernel.phase_driver import (
    R1_WAIT,
    R2_WAIT,
    NodeKernel,
    pack_phase,
    unpack_phase,
)

logger = logging.getLogger("rabia_tpu_torch.engine")

_MAX_SUBMIT_ATTEMPTS = 3
_MVC_MASK = (1 << 16) - 1


def _aligned_i8(shape, fill: int, align: int = 64) -> np.ndarray:
    """An i8 array on a 64-byte-aligned base, as the reference keeps the
    device backend's planes (its XLA CPU client adopted only aligned
    buffers zero-copy). ``torch.from_dlpack`` shares the memory of any
    plane; the alignment keeps the planes' layout the reference's."""
    n = int(np.prod(shape))
    raw = np.full(n + align, np.int8(fill), np.int8)
    off = (-raw.ctypes.data) % align
    return raw[off : off + n].reshape(shape)


class _OutBlock:
    """Proposer-side pending block: aggregates per-shard outcomes into one
    client future (one response list — or Exception — per covered shard)."""

    __slots__ = ("block", "future", "responses", "remaining", "created_at")

    def __init__(self, block: PayloadBlock, future: asyncio.Future):
        self.block = block
        self.future = future
        self.responses: list = [None] * len(block)
        self.remaining = len(block)
        self.created_at = time.time()

    def settle(self, i: int, outcome) -> None:
        if self.responses[i] is None:
            self.responses[i] = outcome
            self.remaining -= 1
            if self.remaining == 0 and self.future is not None and not self.future.done():
                self.future.set_result(self.responses)

    def settle_many(self, idxs, outcomes) -> None:
        """Bulk settle (the native runtime's wave events): one pass, one
        future check — per-entry settle() calls measurably tax the
        proposer side at thousands of entries per wave."""
        responses = self.responses
        hit = 0
        for i, o in zip(idxs, outcomes):
            if responses[i] is None:
                responses[i] = o
                hit += 1
        if hit:
            self.remaining -= hit
            if (
                self.remaining == 0
                and self.future is not None
                and not self.future.done()
            ):
                self.future.set_result(responses)


class _BlockRef:
    """Registry record for a live block (incoming or our own)."""

    __slots__ = ("block", "out", "src_row", "remaining", "registered_at")

    def __init__(self, block: PayloadBlock, out, src_row: int):
        self.block = block
        self.out = out
        self.src_row = src_row
        self.remaining = len(block)
        self.registered_at = time.time()


class _Wake:
    """Single-waiter wake signal: ``asyncio.Event`` semantics without the
    inner Task that ``wait_for(event.wait(), t)`` spawns. A transport
    notify resumes the run loop in ONE ready-queue generation instead of
    three (set → inner-task wakeup → outer-task wakeup), which was worth
    ~1 ms of the serial commit path under a busy loop (VERDICT r05 weak
    #1: config-1 p50 regression)."""

    __slots__ = ("_flag", "_fut")

    def __init__(self) -> None:
        self._flag = False
        self._fut: Optional[asyncio.Future] = None

    def set(self) -> None:
        self._flag = True
        f = self._fut
        if f is not None and not f.done():
            f.set_result(None)

    def clear(self) -> None:
        self._flag = False

    def is_set(self) -> bool:
        return self._flag

    async def wait(self, timeout: float) -> None:
        """Wait until set() or `timeout` elapses (no exception either way)."""
        if self._flag:
            return
        loop = asyncio.get_running_loop()
        f = loop.create_future()
        self._fut = f
        h = loop.call_later(timeout, self._timeout, f)
        try:
            await f
        finally:
            h.cancel()
            self._fut = None

    @staticmethod
    def _timeout(f: asyncio.Future) -> None:
        if not f.done():
            f.set_result(None)


class _EngineNetHandler(NetworkEventHandler):
    """Connectivity events → engine pause/resume (engine.rs:983-997).

    Losing quorum pauses consensus (no new slots, no kernel rounds, no
    retransmission — inbound traffic still drains so Decisions/sync adopt
    passively); restoration resumes it. Both transitions are announced with
    a QuorumNotification broadcast (messages.rs:132-136 parity)."""

    def __init__(self, engine: "RabiaEngine") -> None:
        self.engine = engine

    async def on_node_connected(self, node: NodeId) -> None:
        logger.info(
            "%s: peer %s connected", self.engine.node_id.short(), node.short()
        )

    async def on_node_disconnected(self, node: NodeId) -> None:
        logger.warning(
            "%s: peer %s disconnected", self.engine.node_id.short(), node.short()
        )

    async def on_partition_detected(self, reachable) -> None:
        logger.warning(
            "%s: partition detected — reachable %d/%d",
            self.engine.node_id.short(),
            len(reachable),
            self.engine.cluster.total_nodes,
        )

    async def on_quorum_lost(self) -> None:
        e = self.engine
        e._paused = True
        e.rt.is_active = False
        e.journal.record(
            e.journal.QUORUM_LOST, active=len(e.rt.active_nodes)
        )
        logger.warning("%s: quorum LOST — consensus paused", e.node_id.short())
        e._send(
            QuorumNotification(
                has_quorum=False,
                active_nodes=tuple(sorted_nodes(e.rt.active_nodes)),
            )
        )

    async def on_quorum_restored(self) -> None:
        e = self.engine
        e._paused = False
        e.rt.is_active = True
        e.journal.record(
            e.journal.QUORUM_RESTORED, active=len(e.rt.active_nodes)
        )
        logger.info(
            "%s: quorum RESTORED — consensus resumed", e.node_id.short()
        )
        e._send(
            QuorumNotification(
                has_quorum=True,
                active_nodes=tuple(sorted_nodes(e.rt.active_nodes)),
            )
        )


class RabiaEngine:
    """One replica's consensus engine (engine.rs:25-42 analog).

    Generic over the three core seams: ``state_machine`` (bytes interface),
    ``transport`` and optional ``persistence`` — construct with any
    implementations of those ABCs (the reference's `RabiaEngine<SM, NT, PL>`
    type parameters).
    """

    def __init__(
        self,
        cluster: ClusterConfig,
        state_machine: StateMachine,
        transport: NetworkTransport,
        persistence: Optional[PersistenceLayer] = None,
        config: Optional[RabiaConfig] = None,
        device=None,
    ) -> None:
        """``device`` is where the device backend (``KernelConfig.backend
        = "jax"``) runs its node kernel: a card unless the caller names
        another (``"cpu"`` runs the plain versions); with no card and no
        device it raises. The host backend does not read it."""
        self.cluster = cluster
        self.node_id = cluster.node_id
        self.sm = state_machine
        self.transport = transport
        self.persistence = persistence
        self.config = config or RabiaConfig()

        self.R = cluster.total_nodes
        self.me = cluster.replica_index(self.node_id)
        kc = self.config.kernel
        self.S = kc.padded_shards
        self.n_shards = max(1, kc.num_shards)
        # The coin seed must be identical cluster-wide (it IS the common
        # coin); randomization_seed defaults to 0 for all nodes.
        seed = self.config.randomization_seed or 0
        self._host_kernel = kc.backend != "jax"
        self._substeps = max(1, int(kc.device_substeps))
        # the host backend ignores the flag (there is no device boundary)
        self._zc_inbox = bool(kc.zero_copy_inbox) and not self._host_kernel
        if self._host_kernel:
            self.kernel = HostNodeKernel(
                self.S, self.R, self.me, coin_p1=kc.coin_p1, seed=seed
            )
        else:
            # the node kernel on the device: one launch and one fetch a
            # tick, so the tick pays the device's round trip. The
            # reference fenced this backend off for tunneled hardware;
            # a card attached to the host pays far less.
            logger.warning(
                "KernelConfig.backend='jax' selected: the node kernel runs "
                "on the device, one launch and one fetch a tick; intended "
                "for directly-attached accelerators only"
            )
            self.kernel = NodeKernel(
                self.S, self.R, self.me, coin_p1=kc.coin_p1, seed=seed,
                device=device,
            )
        self.kstate = self.kernel.init_state()
        # the device backend's per-tick figures: ticks, bytes up and
        # down, and (with device_tick_timing on a card) the upload,
        # launch and fetch spans by CUDA events. Each span holds the host
        # code that enqueues its work as well as the device's time, so
        # it is no device time.
        self.device_tick_timing = False
        # h2d_bytes and d2h_bytes: what the ticks copied to and from a
        # card (nothing: the launch reads the planes and writes the image
        # in place); mapped_bytes: what the launches moved over the link
        self.device_tick_stats = {
            "ticks": 0, "h2d_bytes": 0, "d2h_bytes": 0, "mapped_bytes": 0, "timed_ticks": 0,
            "upload_span_ms": 0.0, "launch_span_ms": 0.0, "fetch_span_ms": 0.0,
        }
        self.rt = EngineRuntime(self.S)
        self.serializer = Serializer(self.config.serialization)
        self.validator = MessageValidator(self.config.validation)
        self.leader = LeaderSelector(cluster.all_nodes)
        self._paused = False
        self.monitor = NetworkMonitor(cluster, handler=_EngineNetHandler(self))

        # host mirrors of kernel arrays (aliases in host-kernel mode,
        # fetched copies on the device backend)
        self._refresh_mirrors()

        # vote stash: arrays appended at ingest, routed to the kernel in
        # bulk once per tick ([(row, shards, slots, mvcs, vals)] per round)
        self._restep = False
        self._stash1: list[tuple] = []
        self._stash2: list[tuple] = []
        # carry: future-(slot, phase) votes kept across ticks (same tuple
        # shape); bounded in _route_votes
        self._carry1: list[tuple] = []
        self._carry2: list[tuple] = []
        # adopted-decision plane consumed by the next node_step
        # (64-byte-aligned as the reference's — see _aligned_i8)
        # On a card the inbox and decision planes are views of the node
        # kernel's pinned plane buffer (64-byte aligned too)
        self._dec_plane = _aligned_i8(self.S, ABSENT)
        if not self._host_kernel:
            if self.kernel.planes is not None:
                kp = self.kernel.planes
                self._inbox1, self._inbox2, self._dec_plane = (
                    kp.inbox_r1, kp.inbox_r2, kp.decision_in)
            else:
                self._inbox1 = _aligned_i8((self.S, self.R), ABSENT)
                self._inbox2 = _aligned_i8((self.S, self.R), ABSENT)
        self._shard_ids = np.arange(self.S, dtype=np.int64)
        # reused open planes: (mask, slots_full, init_full) — consumers
        # only read masked positions (start_slots/node_cycle are
        # mask-gated), so stale unmasked values are never observed
        self._open_planes = (
            np.zeros(self.S, bool),
            np.zeros(self.S, np.int64),
            np.full(self.S, V0, np.int8),
        )
        self._apply_dirty: set[int] = set()
        # pipelined apply stage (engine/apply_plane.py): inline up to a
        # budget, backlog drains off-tick so consensus keeps rounding
        from rabia_tpu_torch.engine.apply_plane import ApplyPlane

        self._apply_plane = ApplyPlane(self)
        # native columnar helpers (native/hostkernel.cpp); None (only with
        # RABIA_PY_HOSTKERNEL=1) -> numpy paths. A failed build raises.
        from rabia_tpu_torch.native.build import load_hostkernel

        self._hk_lib = load_hostkernel()
        self._open_bufs = (
            np.zeros(self.n_shards, np.int64),
            np.zeros(self.n_shards, np.uint8),
        )
        # raw-pointer tuples cached once: per-tick ndarray.ctypes
        # marshalling costs more than the C scans themselves at small S
        if self._hk_lib is not None:
            rt = self.rt
            self._open_scan_args = (
                self.n_shards,
                rt.next_slot.ctypes.data, rt.applied_upto.ctypes.data,
                rt.in_flight.ctypes.data, rt.queue_len.ctypes.data,
                rt.prop_flag.ctypes.data, rt.dec_flag.ctypes.data,
                rt.votes_seen_slot.ctypes.data,
                rt.tainted_upto.ctypes.data,
                self._open_bufs[0].ctypes.data,
                self._open_bufs[1].ctypes.data,
            )
            self._stall_scan_args = (
                self.n_shards,
                rt.in_flight.ctypes.data,
                rt.last_progress.ctypes.data,
            )
        else:
            self._open_scan_args = None
            self._stall_scan_args = None

        # block lane (bulk proposals — rabia_tpu_torch.core.blocks):
        # registry of live blocks by small int handle; columnar bindings
        self._blk_registry: dict[int, _BlockRef] = {}
        self._blk_next_ref = 1
        self._blk_pending_ref = np.full(self.S, -1, np.int64)
        self._blk_pending_idx = np.zeros(self.S, np.int64)
        self._blk_pending_slot = np.full(self.S, -1, np.int64)
        self._cur_blk_ref = np.full(self.S, -1, np.int64)
        self._cur_blk_idx = np.zeros(self.S, np.int64)
        self._pending_block_announces: list[ProposeBlock] = []
        self._last_blk_retransmit: dict[int, float] = {}
        self._is_vector_sm = isinstance(state_machine, VectorStateMachine)

        # write-ahead vote barrier: _barrier[s] is persisted BEFORE this
        # replica's first vote in any slot >= the previous barrier, so a
        # restart knows exactly which slots may hold its pre-crash votes
        self._barrier = np.zeros(self.S, np.int64)
        # read-index floor: the RESTORED barrier. decided_frontier() must
        # never under-report a slot this replica voted round 2 in, and a
        # pre-crash vote can sit above the restored next_slot (cast after
        # the last checkpoint) — the barrier bounds all of them
        self._frontier_floor = np.zeros(self.S, np.int64)
        self._restored_at = 0.0
        self._pending_proposes: list[Propose] = []

        self._row_to_node = {i: n for i, n in enumerate(cluster.all_nodes)}
        self._node_to_row = {n: i for i, n in enumerate(cluster.all_nodes)}
        # native per-tick fast path (ingest→route→tally→outbox in one C
        # call; Python only on events). RABIA_PY_TICK=1 forces the Python
        # paths, which stay the semantics owner (pinned by
        # tests/test_torch_native_tick.py and the conformance gates).
        self._rk = None
        if (
            self._host_kernel
            and self._hk_lib is not None
            and os.environ.get("RABIA_PY_TICK") != "1"
            and self.R <= 64
        ):
            from rabia_tpu_torch.engine.native_tick import NativeTick

            self._rk = NativeTick(self, self._hk_lib)
        # native engine runtime (native/runtime.cpp): a GIL-free io/tick
        # thread runs ingest→route→tally→decide→apply→result end to end
        # for TCP clusters with a native store and no persistence or a
        # native WAL; Python is the control plane
        # (engine/runtime_bridge.py). RABIA_PY_RUNTIME=1 forces the
        # asyncio orchestration, which stays the semantics owner
        # (testing.conformance.run_schedule_on_runtime_paths).
        # durability plane (persistence/native_wal.py): when the
        # persistence layer is a WAL, decided waves stage into it from
        # the apply paths and the vote barrier rides its group-commit
        # lane — which is what lets the native runtime engage on a
        # durable cluster
        self._wal = (
            persistence
            if getattr(persistence, "supports_wal", False)
            else None
        )
        self._rtm = None
        if self._rk is not None and (
            persistence is None
            or (self._wal is not None and getattr(self._wal, "native", False))
        ):
            from rabia_tpu_torch.engine.runtime_bridge import (
                RuntimeBridge,
                runtime_available,
            )
            from rabia_tpu_torch.native.build import load_runtime

            if runtime_available(self):
                self._rtm = RuntimeBridge(self, load_runtime())
        self._seen_batches: set = set()  # dedup of forwarded batch ids
        self._seen_order: list = []  # insertion order for bounded eviction
        # decided-frontier hook (rabia_tpu_torch/gateway): callbacks fired once
        # per tick when the applied frontier advanced (scalar or block
        # lane) — the gateway's read-index waiters ride this instead of
        # polling the runtime arrays
        self._frontier_listeners: list = []
        self._frontier_dirty = False
        # cached per-transport drain accessors (resolved once, not per tick)
        self._recv_borrow = getattr(
            transport, "receive_borrowed_nowait", None
        )
        self._recv_nowait = getattr(transport, "receive_nowait", None)
        # address-level drain for the native tick (net/tcp.py): the C
        # ingest reads vote frames straight from the arena address
        self._recv_raw = getattr(transport, "receive_raw_nowait", None)
        # messages a tick drains: at least one per shard. A wave brings
        # per-shard messages (NewBatch, Propose) to every replica, and the
        # forward timeout of _open_slots runs in wall time: with the
        # reference's fixed 256 an engine of thousands of shards read a
        # wave over many ticks and forced null slots on proposers whose
        # Propose sat unread in its own inbox. Still a finite bound
        # against a flood, proportional to the configured width.
        self._drain_cap = max(256, self.n_shards)
        self._bg_tasks: set = set()  # strong refs: loop holds tasks weakly
        self._running = False
        self._stopped = asyncio.Event()
        self._stopped.set()  # not running yet: shutdown() must not hang
        self._wake = _Wake()  # wake-on-inbox / wake-on-submit
        self._notify_wired = False
        self._dirty = False  # committed something since last save
        self._last_heartbeat = 0.0
        self._last_cleanup = 0.0
        self._last_monitor = 0.0
        self._last_repair: dict[int, float] = {}  # sender row -> last repair
        self._peer_progress: dict[NodeId, tuple[int, float]] = {}
        self._peer_quorum_views: dict[NodeId, tuple[bool, float]] = {}

        if self.n_shards > self.S:
            raise ValidationError("num_shards exceeds padded kernel width")

        self._init_obs()

    # ------------------------------------------------------------------
    # Observability (rabia_tpu_torch/obs — docs/OBSERVABILITY.md taxonomy)
    # ------------------------------------------------------------------

    def _init_obs(self) -> None:
        """Register this replica's metrics + anomaly journal.

        Pull-based: gauges/source-backed counters read runtime state (and
        the native C counter blocks, zero-copy) at scrape time; the only
        hot-path costs are plain int increments on EVENT paths. The
        native tick and ``RABIA_PY_TICK=1`` feed the SAME metric names —
        native counts ride the rk counter block, Python-path counts ride
        the ``_py_*`` event tallies, and the exported value is their sum
        (each path leaves the other's source at zero), so the
        conformance gate can assert counter parity across tick paths."""
        from rabia_tpu_torch.core.tracing import tracer
        from rabia_tpu_torch.obs import AnomalyJournal, MetricsRegistry
        from rabia_tpu_torch.obs.flight import FlightRecorder

        m = self.metrics = MetricsRegistry()
        m.attach_tracer(tracer)
        self.journal = AnomalyJournal()
        # flight recorder (docs/OBSERVABILITY.md "Flight recorder"): the
        # Python event ring. On the native tick path the per-frame kinds
        # live in the C ring (rk_flight); RABIA_PY_TICK=1 feeds the same
        # kinds here; engine lifecycle events (submit/propose/decide/
        # apply) land here on BOTH paths. flight_events() merges.
        self.flight = FlightRecorder()
        self._last_flight_dump = 0.0
        # severe anomalies auto-dump the merged rings to RABIA_FLIGHT_DIR
        # (a no-op when the env var is unset)
        self.journal.on_severe = self._flight_autodump
        self._tick_count = 0
        self._slow_ticks = 0
        # Python-path event tallies (the RABIA_PY_TICK twin of the rk
        # counter block; also counts frames the native ingest declined)
        self._py_frames = {"vote1": 0, "vote2": 0, "decision": 0}
        self._py_drops = {"spoof": 0, "skew": 0, "malformed": 0}
        self._py_stale = 0
        self._last_dials = 0
        # a tick slower than half the phase timeout (floored for test
        # configs with tiny timeouts) is an anomaly worth journaling
        self._slow_tick_s = max(0.25, self.config.phase_timeout / 2)

        rt = self.rt
        n = self.n_shards

        def rk_ctr(name):
            rk = self._rk
            return rk.counter(name) if rk is not None else 0

        # -- engine progress (deterministic across tick paths: the
        #    conformance parity set) ------------------------------------
        m.counter(
            "engine_decided_total",
            "Slots decided by this replica, by decided value",
            {"value": "v1"},
            fn=lambda: rt.decided_v1,
        )
        m.counter(
            "engine_decided_total", "", {"value": "v0"},
            fn=lambda: rt.decided_v0,
        )
        m.counter(
            "engine_applied_slots_total",
            "Contiguously applied slots across shards",
            fn=lambda: int(rt.applied_upto[:n].sum()),
        )
        m.counter(
            "engine_state_version",
            "V1 batches applied (the replicated-state version)",
            fn=lambda: rt.state_version,
        )
        # -- liveness / load --------------------------------------------
        m.gauge(
            "engine_has_quorum", "1 while this replica sees a quorum",
            fn=lambda: 1 if rt.has_quorum else 0,
        )
        m.gauge(
            "engine_active_nodes", "Peers considered active",
            fn=lambda: len(rt.active_nodes),
        )
        m.gauge(
            "engine_pending_batches", "Locally queued submissions",
            fn=lambda: int(rt.queue_len[:n].sum()),
        )
        m.gauge(
            "engine_in_flight_shards", "Shards with an open consensus slot",
            fn=lambda: int(rt.in_flight[:n].sum()),
        )
        m.gauge(
            "engine_native_tick",
            "1 when the native rk tick context is active",
            fn=lambda: 1 if self._rk is not None else 0,
        )
        # -- native engine runtime (runtime.cpp RTM counter block) -------
        m.gauge(
            "engine_native_runtime",
            "1 when the GIL-free runtime thread owns the commit path",
            fn=lambda: 1 if self._rtm is not None else 0,
        )

        def rtm_ctr(name):
            rtm = self._rtm
            return rtm.counter(name) if rtm is not None else 0

        for name in (
            "loops", "wakes_frame", "wakes_idle", "frames_native",
            "frames_block", "frames_escalated", "cmds", "opens_scalar",
            "opens_block", "ticks", "decided_scalar", "waves_native",
            "waves_py", "slots_applied", "ev_records", "ev_stalls",
            "retransmits", "stale_repairs", "pauses",
        ):
            m.counter(
                f"runtime_{name}_total",
                "Native runtime counter (runtime.cpp RTM block)",
                fn=lambda r=name: rtm_ctr(r),
            )
        # the acceptance counter: commit-path transitions that required
        # the GIL. Zero growth while waves_native grows = the steady-state
        # commit path never re-enters Python.
        m.counter(
            "runtime_gil_handoffs_total",
            "Decided waves whose decide->apply->result needed Python",
            fn=lambda: rtm_ctr("gil_handoffs"),
        )
        # -- consensus-health telemetry (chaos plane: the paper's
        #    randomized-termination curve). Three sources feed ONE metric
        #    identity, mirroring the tick-path convention above: the rk
        #    tick context's C bins, HostNodeKernel's host bins, and the
        #    engine's device-backend bins — each path leaves the others'
        #    sources at zero.
        self._dev_phase_hist = np.zeros(32, np.int64)
        self._dev_phase_sum = 0
        phase_bounds = tuple(float(b) for b in range(1, 33))

        def phase_curve():
            hist = np.zeros(32, np.int64)
            ssum = 0
            rk = self._rk
            if rk is not None:
                h = np.asarray(rk.phase_hist, np.int64)
                hist[: len(h)] += h
                for sib in getattr(rk, "siblings", ()):
                    sh = np.asarray(sib.phase_hist, np.int64)
                    hist[: len(sh)] += sh
                ssum += rk.counter("phase_sum")  # sums siblings itself
            kern = getattr(self, "kernel", None)
            kh = getattr(kern, "phase_hist", None)
            if kh is not None:
                hist[: len(kh)] += np.asarray(kh, np.int64)
                ssum += int(kern.phase_sum)
            hist += self._dev_phase_hist
            ssum += self._dev_phase_sum
            # bin p (decisions taking p phases) lands in bucket bound p,
            # i.e. index p-1. The sources' top bin (31) is a CLAMP —
            # "exactly 31 OR more" — so it rides the TOP bound (32,
            # claiming <= 32: true for 31, best-effort for the
            # astronomically rare beyond) instead of mislabeling the
            # extreme tail as <= 31. Bin 0 (impossible: deciding
            # requires an advance) joins it defensively.
            counts = [int(hist[j + 1]) for j in range(30)]
            counts.append(0)  # bound 31: absorbed into the clamp bucket
            counts.append(int(hist[31]) + int(hist[0]))
            return counts, int(hist.sum()), float(ssum)

        m.histogram(
            "phases_to_decide",
            "Weak-MVC phases each locally tally-decided slot took "
            "(1 = decided in its first phase); the randomized-"
            "termination evidence curve",
            buckets=phase_bounds,
            fn=phase_curve,
        )

        # -- per-phase consensus dwell (the critical-path decomposer's
        #    consensus segments, obs/critpath.py): how long each phase
        #    ordinal took in wall time, not just how many phases ran.
        #    Native source: the rk ctx's RK_DWELL histogram block
        #    (hostkernel.cpp — the GIL-free runtime shares the ctx, so
        #    both native planes land there); Python twin: _py_dwell, fed
        #    by the engine's open/outbox processing on the Python tick
        #    path. Identical geometry (the
        #    SLO buckets), same metric name either way — the critpath
        #    name-parity test pins this.
        from rabia_tpu_torch.obs.registry import (
            SLO_BUCKETS as _SLO_B,
            SLO_MIN_EXP,
            SLO_SUB_BITS,
        )

        n_slo = len(_SLO_B)
        self._py_dwell = np.zeros((8, n_slo + 2), np.uint64)
        self._dwell_t0 = np.zeros(self.S, np.int64)
        self._dwell_t0_slot = np.full(self.S, -1, np.int64)

        def dwell_row(row):
            agg = np.zeros(n_slo + 2, np.int64)
            rk = self._rk
            if rk is not None and rk.dwell_geometry == (
                n_slo, SLO_SUB_BITS, SLO_MIN_EXP
            ):
                for src in (rk, *getattr(rk, "siblings", ())):
                    if row < len(src.dwell):
                        agg += src.dwell[row].astype(np.int64)
            agg += self._py_dwell[row].astype(np.int64)
            return (
                [int(v) for v in agg[:n_slo]],
                int(agg[n_slo]),
                float(agg[n_slo + 1]) * 1e-9,
            )

        for pi in range(8):
            m.histogram(
                "consensus_phase_dwell_seconds",
                "Wall time each weak-MVC phase ordinal dwelt before its "
                "advance (top row clamps 8+; native RK_DWELL block + "
                "Python tick twin, SLO bucket geometry)",
                {"phase": str(pi + 1) if pi < 7 else "8+"},
                buckets=_SLO_B,
                fn=lambda r=pi: dwell_row(r),
            )

        def coin_ctr(i):
            kern = getattr(self, "kernel", None)
            cf = getattr(kern, "coin_flips", None)
            v = int(cf[i]) if cf is not None else 0
            rk = self._rk
            if rk is not None:
                v += rk.counter("coin_v1" if i else "coin_v0")
            return v

        m.counter(
            "coin_flips_total",
            "Common-coin flips by outcome (round-2 all-? tie-breaks). "
            "Covers the host/native decide paths; the jitted device "
            "kernel flips inside XLA and is not tallied here",
            {"outcome": "v0"},
            fn=lambda: coin_ctr(0),
        )
        m.counter(
            "coin_flips_total", "", {"outcome": "v1"},
            fn=lambda: coin_ctr(1),
        )
        m.counter(
            "engine_ticks_total", "Engine loop ticks",
            fn=lambda: self._tick_count,
        )
        m.counter(
            "engine_slow_ticks_total",
            "Ticks exceeding the slow-tick threshold (journaled)",
            fn=lambda: self._slow_ticks,
        )
        self._syncs = 0
        self._payload_wait: Optional[tuple[int, int]] = None
        m.counter(
            "engine_syncs_total", "Snapshot syncs initiated",
            fn=lambda: self._syncs,
        )
        # -- pipelined apply stage (engine/apply_plane.py) ---------------
        m.gauge(
            "apply_backlog_shards",
            "Shards with decided slots queued to the apply-plane drain",
            fn=lambda: self._apply_plane.backlog,
        )
        m.counter(
            "apply_deferred_slots_total",
            "Slots applied by the apply-plane drain task (off-tick)",
            fn=lambda: self._apply_plane.deferred_slots,
        )
        m.counter(
            "apply_drains_total",
            "Apply-plane drain task activations",
            fn=lambda: self._apply_plane.drains,
        )
        # -- native apply plane (statekernel SKC counter block), when the
        #    state machine exposes one ---------------------------------
        sk_plane = getattr(self.sm, "_native_plane", None)
        if sk_plane is not None:
            for name in ("waves", "ops", "errors", "cas_misses"):
                m.counter(
                    f"apply_native_{name}_total",
                    "Native apply plane counter (statekernel SKC block)",
                    fn=lambda r=name, pl=sk_plane: pl.counter(r),
                )
            m.gauge(
                "apply_native_plane",
                "1 when the statekernel apply plane is active",
                fn=lambda: 1,
            )
        m.counter(
            "engine_flight_records_total",
            "Flight-recorder records written (native ring + Python ring)",
            fn=lambda: self.flight.head
            + (self._rk.flight_head() if self._rk is not None else 0),
        )
        # -- the per-tick pipeline (native rk counter block + Python
        #    event tallies feeding the same names) ----------------------
        for kind, rk_name in (
            ("vote1", "frames_vote1"),
            ("vote2", "frames_vote2"),
            ("decision", "frames_decision"),
        ):
            m.counter(
                "tick_frames_total",
                "Consensus frames ingested, by kind (native + Python paths)",
                {"kind": kind},
                fn=lambda k=kind, r=rk_name: rk_ctr(r) + self._py_frames[k],
            )
        for reason in ("spoof", "skew", "malformed"):
            m.counter(
                "tick_drops_total",
                "Frames dropped at ingest, by reason",
                {"reason": reason},
                fn=lambda r=reason: rk_ctr("drop_" + r) + self._py_drops[r],
            )
        m.counter(
            "tick_stale_votes_total",
            "Below-applied vote entries (answered by the targeted repair)",
            fn=lambda: rk_ctr("stale_votes") + self._py_stale,
        )
        m.gauge(
            "tick_carry_pending",
            "Future-(slot,phase) votes currently carried",
            fn=lambda: (
                self._rk.carry_count
                if self._rk is not None
                else sum(
                    1 if type(t[1]) is int else len(t[1])
                    for t in (self._carry1 + self._carry2)
                )
            ),
        )
        for name in (
            "carries", "ledger_scatters", "stages", "out_frames",
            "taint_hits", "opened", "frames_noop",
        ):
            m.counter(
                f"tick_native_{name}_total",
                "rk tick context counter (native path only)",
                fn=lambda r=name: rk_ctr(r),
            )
        # -- commit pipeline latency breakdown (event-path observes; all
        #    stages survive the native tick because record/apply stay
        #    Python events on both paths) -------------------------------
        self._h_stage = {
            stage: m.histogram(
                "commit_stage_seconds",
                "Commit pipeline latency by stage "
                "(submit→propose→decide→apply)",
                {"stage": stage},
            )
            for stage in (
                "submit_propose",
                "propose_decide",
                "decide_apply",
                "submit_apply",
            )
        }
        # -- SLO evidence plane (docs/OBSERVABILITY.md, "SLO histograms"
        #    + "Runtime stage profiler"). Both families are registered on
        #    EVERY runtime path with the same names and label sets —
        #    native contributions ride the runtime's RTH_*/RTS_* blocks
        #    (zero-copy at scrape time), Python-path contributions ride
        #    local observes/tallies, and each path leaves the other's
        #    source at zero, so the conformance story stays counter-parity
        #    shaped. rabia_slo_seconds{stage=submit_result} is fed by the
        #    gateway (Python on both paths). -------------------------------
        from rabia_tpu_torch.obs.registry import (
            RUNTIME_STAGES,
            SLO_BUCKETS,
            SLO_STAGES,
        )

        def rtm_hist(stage):
            rtm = self._rtm
            return rtm.hist_stage(stage) if rtm is not None else None

        self._h_slo = {
            stage: m.histogram(
                "slo_seconds",
                "SLO latency histograms by pipeline stage "
                "(log-bucketed; native RTH block + Python observes)",
                {"stage": stage},
                buckets=SLO_BUCKETS,
                fn=(
                    (lambda s=stage: rtm_hist(s))
                    if stage in ("decide_apply", "broadcast")
                    else None
                ),
            )
            for stage in SLO_STAGES
        }
        # runtime stage profiler: cumulative seconds per commit-path-owner
        # loop stage. While the native runtime owns the commit path its
        # RTS block is the source; on the asyncio orchestration the run
        # loop accounts the same stage names (self._stage_ns) — summed per
        # scrape, the breakdown covers the owner thread's wall time.
        self._stage_ns = {s: 0 for s in RUNTIME_STAGES}
        self._stage_acc = 0
        self._loop_mark = 0
        self._bcast_carve = 0
        for sname in RUNTIME_STAGES:
            m.counter(
                "runtime_stage_seconds",
                "Commit-path owner loop time by stage (native RTS block "
                "or asyncio-loop accounting; `rabia_tpu_torch profile` renders)",
                {"stage": sname},
                fn=lambda s=sname: self.stage_second(s),
            )
        # thread-per-shard-group runtime: per-worker stage series with a
        # `worker` label next to the aggregate above (single-worker and
        # asyncio runs keep the historical label set untouched)
        rtm0 = self._rtm
        if rtm0 is not None and getattr(rtm0, "workers", 1) > 1:
            for g in range(rtm0.workers):
                for sname in RUNTIME_STAGES:
                    m.counter(
                        "runtime_stage_seconds",
                        "Per-worker commit-path loop time by stage "
                        "(thread-per-shard-group runtime)",
                        {"stage": sname, "worker": str(g)},
                        fn=lambda s=sname, gg=g: (
                            self._rtm.stage_ns_worker(gg, s) * 1e-9
                            if self._rtm is not None
                            and gg < getattr(self._rtm, "workers", 1)
                            else 0.0
                        ),
                    )
        # -- durability plane (walkernel WLC counter block / Python twin
        #    tallies — persistence/native_wal.py), when the persistence
        #    layer is a WAL --------------------------------------------
        wal = self._wal
        if wal is not None:
            from rabia_tpu_torch.persistence.native_wal import WAL_COUNTER_NAMES

            m.gauge(
                "wal_native",
                "1 when walkernel.cpp owns the WAL writer (0 = the "
                "RABIA_PY_WAL Python twin)",
                fn=lambda: 1 if wal.native else 0,
            )
            for name in WAL_COUNTER_NAMES:
                if name == "fsync_ns":
                    continue  # exported as wal_fsync_seconds_total below
                m.counter(
                    f"wal_{name}_total",
                    "Durability-plane counter (walkernel WLC block)",
                    fn=lambda r=name: wal.counters_dict().get(r, 0),
                )
            m.counter(
                "wal_fsync_seconds_total",
                "Cumulative seconds spent in WAL fsync (flush thread)",
                fn=lambda: wal.counters_dict().get("fsync_ns", 0) / 1e9,
            )
            m.gauge(
                "wal_staged_lsn", "Last staged WAL record LSN",
                fn=wal.staged_lsn,
            )
            m.gauge(
                "wal_durable_lsn",
                "Durability watermark: last fsynced WAL record LSN",
                fn=wal.durable_lsn,
            )
            m.counter(
                "wal_checkpoints_total",
                "Incremental snapshot checkpoints written",
                fn=lambda: wal.checkpoints,
            )
            m.counter(
                "wal_barrier_waits_total",
                "Durability-barrier watermark waits entered",
                fn=lambda: getattr(wal, "barrier_waits", 0),
            )
            m.counter(
                "wal_barrier_covered_total",
                "Client Results released by durability-barrier waits "
                "(covered/waits = the cross-session batching factor)",
                fn=lambda: getattr(wal, "barrier_covered", 0),
            )
            m.counter(
                "wal_gc_segments_total",
                "WAL segments garbage-collected below the snapshot frontier",
                fn=lambda: wal.gc_segments,
            )

            def wal_hist():
                h = wal.fsync_hist()
                if h is None:
                    return None
                counts, count, sum_ns = h
                return counts, count, sum_ns / 1e9

            m.histogram(
                "wal_fsync_seconds",
                "WAL fsync latency (group-commit flush thread; native "
                "WLH block, SLO bucket geometry)",
                buckets=SLO_BUCKETS,
                fn=wal_hist,
            )
        # -- transport (native counter block, when the transport has one)
        tc = getattr(self.transport, "transport_counters", None)
        if callable(tc):
            from rabia_tpu_torch.net.tcp import RT_COUNTER_NAMES

            for name in RT_COUNTER_NAMES:
                m.counter(
                    f"transport_{name}_total",
                    "Native transport counter (transport.cpp RTC block)",
                    fn=lambda r=name: tc().get(r, 0),
                )

    def health(self) -> dict:
        """The /healthz document (served by the gateway admin surface and
        the HTTP shim): frontier positions, quorum view, anomaly tallies."""
        return {
            "status": "ok" if self.rt.has_quorum else "degraded",
            "node": str(self.node_id.value),
            "has_quorum": bool(self.rt.has_quorum),
            "active_nodes": len(self.rt.active_nodes),
            "native_tick": self._rk is not None,
            "native_runtime": self._rtm is not None,
            # active planes (runtime|tick|apply: native|python) — the
            # same ground truth the bench sweep lines record, so a
            # scrape can tell which path a replica is ACTUALLY on
            # (an env toggle or a silent native-build failure both
            # read as "python" here)
            "planes": {
                "runtime": "native" if self._rtm is not None else "python",
                "tick": "native" if self._rk is not None else "python",
                # the message codec: the C extension for the hot frames,
                # or the Python codec alone (RABIA_PY_CODEC)
                "codec": (
                    "native"
                    if self.serializer._binary._native is not None
                    else "python"
                ),
                "apply": (
                    "native"
                    if getattr(self.sm, "_native_plane", None) is not None
                    else "python"
                ),
                # thread-per-shard-group worker count (1 = the
                # single-thread runtime or the asyncio orchestration)
                "runtime_workers": (
                    getattr(self._rtm, "workers", 1)
                    if self._rtm is not None
                    else 1
                ),
                # durability plane: which WAL writer owns the byte
                # format on this replica ("none" = not a durable
                # cluster) — the loadgen durable smoke cell pins
                # wal=native with --require-plane
                "wal": (
                    ("native" if getattr(self._wal, "native", False)
                     else "python")
                    if self._wal is not None
                    else "none"
                ),
            },
            "decided_frontier": self.decided_frontier().tolist(),
            "applied_frontier": self.applied_frontier().tolist(),
            "pending_batches": self.pending_queue_depth(),
            "state_version": int(self.rt.state_version),
            "anomalies": self.journal.counts(),
        }

    # -- flight recorder (obs/flight.py; docs/OBSERVABILITY.md) ------------

    def flight_events(self) -> list[dict]:
        """Merged flight timeline: the native tick ring (C fast path),
        the Python event ring, and the transport's frame in/out ring,
        sorted by monotonic ns (all three share CLOCK_MONOTONIC). Plain
        dicts with plain ints — JSON-serializable as-is."""
        from rabia_tpu_torch.obs.flight import (
            native_ring_events,
            transport_ring_events,
        )

        evs = self.flight.snapshot()
        if self._rk is not None:
            evs.extend(native_ring_events(self._rk.flight_snapshot()))
            # sibling worker contexts (thread-per-shard-group runtime)
            for sib in getattr(self._rk, "siblings", ()):
                evs.extend(native_ring_events(sib.flight_snapshot()))
        # native runtime ring: thread wakeups + mailbox handoffs
        # (FRE_RT_WAKE / FRE_RT_HANDOFF), so timelines stay complete when
        # the asyncio loop is off the commit path
        if self._rtm is not None:
            evs.extend(native_ring_events(self._rtm.flight_snapshot()))
        # native apply plane (statekernel): one apply record per wave on
        # the C path, merged alongside the per-slot Python APPLY events
        sk_plane = getattr(self.sm, "_native_plane", None)
        if sk_plane is not None:
            try:
                evs.extend(
                    native_ring_events(sk_plane.flight_snapshot())
                )
            except Exception:  # a closed plane must not kill a dump
                pass
        tf = getattr(self.transport, "flight_snapshot", None)
        if callable(tf):
            try:
                evs.extend(transport_ring_events(tf()))
            except Exception:  # a closed transport must not kill a dump
                pass
        evs.sort(key=lambda e: e["t_ns"])
        return evs

    def flight_ring_state(self) -> list[dict]:
        """Head/wrap state for the rings :meth:`flight_events` merges
        (minus the transport frame ring, which keeps no total-written
        counter): the trace wrap-honesty stamps. A ring whose ``head``
        exceeds its retained window has evicted records, and any trace
        sliced from it may be silently partial — build_trace_slice
        compares ``oldest_t_ns`` against the batch's earliest event
        (obs/flight.slice_truncated) and marks the slice ``truncated``."""
        rings = [dict(self.flight.state(), ring="python")]

        def native_state(obj, name: str) -> None:
            try:
                head = int(obj.flight_head())
                snap = obj.flight_snapshot()
            except Exception:  # a closed plane must not kill a trace
                return
            retained = len(snap)
            rings.append(
                {
                    "ring": name,
                    "head": head,
                    "cap": retained,  # the retained-window size
                    "wrapped": head > retained,
                    "oldest_t_ns": (
                        int(snap[0]["t_ns"]) if retained else None
                    ),
                }
            )

        if self._rk is not None:
            native_state(self._rk, "rk")
            for i, sib in enumerate(getattr(self._rk, "siblings", ())):
                native_state(sib, f"rk_w{i + 1}")
        if self._rtm is not None:
            native_state(self._rtm, "rtm")
        sk_plane = getattr(self.sm, "_native_plane", None)
        if sk_plane is not None:
            native_state(sk_plane, "statekernel")
        return rings

    def dump_flight(
        self, path: Optional[str] = None, reason: str = "manual"
    ) -> Optional[str]:
        """Write the merged flight timeline to disk; returns the path.

        With no explicit ``path``, dumps into ``$RABIA_FLIGHT_DIR``
        (created if missing) or returns None when the env var is unset —
        the auto-dump hooks (severe anomalies, unclean shutdown) are
        opt-in so test runs don't litter."""
        from rabia_tpu_torch.obs.flight import dump_events

        if path is None:
            d = os.environ.get("RABIA_FLIGHT_DIR")
            if not d:
                return None
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d,
                f"flight_{self.node_id.short()}_"
                f"{int(time.time() * 1000)}_{reason}.json",
            )
        return dump_events(
            path,
            self.flight_events(),
            meta={
                "node": str(self.node_id.value),
                "row": int(self.me),
                "reason": reason,
                "native_tick": self._rk is not None,
                "anomalies": self.journal.counts(),
            },
        )

    def _flight_autodump(self, kind: str) -> None:
        """Journal severe-kind hook: dump the rings while the evidence is
        still in the window (rate-limited; no-op without the env var)."""
        now = time.time()
        if now - self._last_flight_dump < 5.0:
            return
        self._last_flight_dump = now
        try:
            p = self.dump_flight(reason=kind)
            if p:
                logger.warning("flight recorder dumped to %s (%s)", p, kind)
        except Exception:
            logger.exception("flight auto-dump failed")

    # ------------------------------------------------------------------
    # Public API (the reference's EngineCommand surface, state.rs:300-307)
    # ------------------------------------------------------------------

    async def submit_batch(
        self, batch: CommandBatch, shard: Optional[int] = None
    ) -> asyncio.Future:
        """Accept a client batch for consensus on `shard`; returns a future
        resolving to the list of per-command responses once the batch
        commits (engine.rs:288-310 ProcessBatch path). Rejects without a
        quorum (engine.rs:289-297)."""
        if not self.rt.has_quorum:
            raise QuorumNotAvailableError(
                f"no quorum ({len(self.rt.active_nodes)}/{self.cluster.quorum_size})"
            )
        if batch.is_empty():
            raise ValidationError("empty batch")
        if len(batch.commands) > self.config.max_batch_size:
            raise ValidationError("batch exceeds max_batch_size")
        s = int(shard) if shard is not None else int(batch.shard)
        if not (0 <= s < self.n_shards):
            raise ValidationError(f"shard {s} out of range")
        self.flight.record(FRE_SUBMIT, shard=s, batch=fr_hash(batch.id))
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self.rt.shards[s].queue.append(PendingSubmission(batch=batch, future=fut))
        self._wake.set()  # wake the run loop: new work to propose
        return fut

    def proposer_eligible_shards(self) -> np.ndarray:
        """Shard indices this replica could open a block entry for RIGHT
        NOW (rotation proposer at the head slot, idle, nothing queued or
        bound). The block lane's eligibility mask, exposed for load
        drivers/ops tooling so they don't re-derive it from runtime
        internals."""
        n = self.n_shards
        rt = self.rt
        shards = self._shard_ids[:n]
        head = np.maximum(rt.next_slot[:n], rt.applied_upto[:n])
        elig = (
            (slot_proposer_vec(shards, head, self.R) == self.me)
            & ~rt.in_flight[:n]
            & (rt.queue_len[:n] == 0)
            & ~rt.prop_flag[:n]
            & (self._blk_pending_ref[:n] == -1)
            & (self._cur_blk_ref[:n] == -1)
            & (head >= rt.tainted_upto[:n])
        )
        return shards[elig]

    async def submit_block(self, block: PayloadBlock) -> asyncio.Future:
        """Accept a columnar block of batches (one per covered shard) for
        consensus — the bulk lane. Returns ONE future resolving to a list
        with one entry per covered shard: the response list, or an
        Exception instance for shards whose batch failed.

        Shards where this replica is the upcoming proposer ride the block
        fast path (one ProposeBlock broadcast, vectorized open/decide/
        apply); the rest demote to the scalar queue and are forwarded to
        their proposers as usual."""
        if not self.rt.has_quorum:
            raise QuorumNotAvailableError(
                f"no quorum ({len(self.rt.active_nodes)}/{self.cluster.quorum_size})"
            )
        if len(block) == 0:
            raise ValidationError("empty block")
        if int(block.shards.max()) >= self.n_shards:
            raise ValidationError("block shard out of range")
        # fail fast with the same limits receivers enforce on the announce
        # (and the scalar lane enforces on demoted batches) — otherwise an
        # oversized batch livelocks retrying instead of erroring here
        if int(block.counts.max()) > min(
            self.config.max_batch_size, self.config.validation.max_commands_per_batch
        ):
            raise ValidationError("block shard batch exceeds max batch size")
        if block.total_commands and (
            int(block.cmd_sizes.max()) > self.config.validation.max_command_size
        ):
            raise ValidationError("block command exceeds max command size")
        for i in range(len(block)):
            self.flight.record(
                FRE_SUBMIT, shard=int(block.shards[i]),
                batch=fr_hash(block.batch_id_for(i)),
            )
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        out = _OutBlock(block, fut)
        ref = self._register_block(block, out, self.me)
        shards = block.shards
        head = np.maximum(
            self.rt.next_slot[shards], self.rt.applied_upto[shards]
        )
        elig = (
            (slot_proposer_vec(shards, head, self.R) == self.me)
            & ~self.rt.in_flight[shards]
            & (self.rt.queue_len[shards] == 0)
            & ~self.rt.prop_flag[shards]
            & (self._blk_pending_ref[shards] == -1)
            & (self._cur_blk_ref[shards] == -1)
            & (head >= self.rt.tainted_upto[shards])
        )
        idxe = np.nonzero(elig)[0]
        if len(idxe):
            sh_e = shards[idxe]
            block.slots[idxe] = head[idxe]
            self._blk_pending_ref[sh_e] = ref
            self._blk_pending_idx[sh_e] = idxe
            self._blk_pending_slot[sh_e] = head[idxe]
        for i in np.nonzero(~elig)[0]:
            self._demote_block_entry(ref, int(i))
        self._wake.set()  # wake the run loop: new work to propose
        return fut

    def _register_block(self, block: PayloadBlock, out, src_row: int) -> int:
        ref = self._blk_next_ref
        self._blk_next_ref += 1
        self._blk_registry[ref] = _BlockRef(block, out, src_row)
        return ref

    def _unref_block(self, ref: int, count: int) -> None:
        rec = self._blk_registry.get(ref)
        if rec is None:
            return
        rec.remaining -= count
        if rec.remaining <= 0:
            del self._blk_registry[ref]
            self._last_blk_retransmit.pop(ref, None)

    def _demote_block_entry(self, ref: int, i: int) -> None:
        """Route one covered shard of a block through the scalar lane
        (ineligible at submit, V0 retry, or out-of-order decide)."""
        rec = self._blk_registry.get(ref)
        if rec is None:
            return
        block = rec.block
        s = int(block.shards[i])
        batch = block.materialize_batch(i)
        if getattr(batch, "aliases", ()):
            # coalescing lane: the scalar apply may bind a WIRE copy of
            # this batch (forwarded proposal) that cannot carry the
            # aliases — stash them on the shard for _batch_aliases
            self.rt.shards[s].alias_subs[batch.id] = batch.aliases
        subfut: asyncio.Future = asyncio.get_event_loop().create_future()
        out = rec.out

        if out is not None:

            def _settle(f: asyncio.Future, i=i, out=out):
                out.settle(i, f.exception() if f.exception() else f.result())

            subfut.add_done_callback(_settle)
        self.rt.shards[s].queue.append(
            PendingSubmission(batch=batch, future=subfut)
        )
        self._unref_block(ref, 1)

    async def get_statistics(self) -> EngineStatistics:
        return self.rt.stats(self.node_id)

    # -- decided-frontier surface (client gateway subsystem) ----------------

    def decided_frontier(self) -> np.ndarray:
        """Per-shard POTENTIAL decided frontier: slot index past every
        slot this replica has decided, plus the slot it is currently
        voting in (in flight counts as potentially decided elsewhere).

        The gateway's linearizable read-index rests on the quorum
        intersection this bound gives: a write committed at slot k
        required round-2 votes from a quorum, and each of those voters
        reports a frontier > k here (it was in flight at k when it
        voted, and the value only grows). Probing any quorum and taking
        the per-shard max therefore covers every write committed before
        the probe. Over-reporting merely delays a read; never report a
        frontier below a slot this replica has voted round 2 in — which
        is why the restored vote barrier floors the result: a pre-crash
        vote can sit above the restored ``next_slot`` (cast after the
        last checkpoint), but never at-or-above the persisted barrier."""
        n = self.n_shards
        return np.maximum(self._own_frontier(), self._frontier_floor[:n])

    def _own_frontier(self) -> np.ndarray:
        """:meth:`decided_frontier` without the restored barrier's floor."""
        n = self.n_shards
        rt = self.rt
        return (
            np.maximum(rt.next_slot[:n], rt.applied_upto[:n])
            + rt.in_flight[:n].astype(np.int64)
        )

    def frontier_floored(self) -> bool:
        """True while the restored vote barrier lifts this replica's
        reported frontier above what it knows on some shard (a restarted
        replica, until its slots pass the barrier). Its own gateway then
        takes a read index from a quorum of OTHER replicas
        (``GatewayServer._run_probe_round``): a write committed by a
        quorum has at least a quorum less one voters besides this replica,
        and any quorum of the other replicas meets them, so the index
        covers it without the floor. With the floor, a shard that saw
        fewer than the barrier stride's slots since the crash would hold
        every read of it until traffic passed the barrier."""
        n = self.n_shards
        return bool((self._frontier_floor[:n] > self._own_frontier()).any())

    def applied_frontier(self) -> np.ndarray:
        """Per-shard count of contiguously applied slots (a copy)."""
        return self.rt.applied_upto[: self.n_shards].copy()

    def pending_queue_depth(self) -> int:
        """Total locally queued submissions across shards — the gateway's
        admission-control signal (shed before the engine inbox saturates)."""
        return int(self.rt.queue_len[: self.n_shards].sum())

    def add_frontier_listener(self, cb) -> None:
        """Register a zero-arg callback fired (on the engine's loop, at
        most once per tick) whenever the applied frontier advances."""
        self._frontier_listeners.append(cb)

    def remove_frontier_listener(self, cb) -> None:
        try:
            self._frontier_listeners.remove(cb)
        except ValueError:
            pass

    async def trigger_sync(self) -> None:
        await self._initiate_sync()

    async def update_nodes(self, nodes: Sequence[NodeId]) -> None:
        """Membership change: recompute quorum + leader (engine.rs:142-153)."""
        self.rt.active_nodes = set(nodes) & set(self.cluster.all_nodes)
        self.rt.has_quorum = self.cluster.has_quorum(
            self.rt.active_nodes | {self.node_id}
        )
        self.leader.update_nodes(self.rt.active_nodes | {self.node_id})

    async def shutdown(self) -> None:
        self._running = False
        await self._stopped.wait()

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def initialize(self) -> None:
        """Restore persisted state then join the cluster (engine.rs:238-269)."""
        if self._wal is not None:
            # durability plane: snapshot-chain restore + WAL replay
            # through the same apply path as live traffic
            # (docs/DURABILITY.md recovery walkthrough)
            report = self._wal.recover_engine(self)
            self.flight.record(
                FRE_WAL, shard=0, slot=report["waves_replayed"], arg=1,
            )
            if self._rtm is not None:
                # mirror the restored frontiers into the bridge before
                # the runtime thread starts (it owns the columns after)
                self._rtm.adopt_restored_frontiers()
        elif self.persistence is not None:
            persisted = await self.persistence.load_engine_state()
            if persisted is not None:
                if persisted.snapshot is not None:
                    self.sm.restore_snapshot(persisted.snapshot)
                opened = np.asarray(persisted.per_shard_phase[: self.S], np.int64)
                applied = np.asarray(
                    persisted.per_shard_committed[: self.S], np.int64
                )
                self.rt.next_slot[: len(opened)] = opened
                self.rt.applied_upto[: len(applied)] = applied
                self.rt.state_version = persisted.state_version
                vers = np.asarray(persisted.per_shard_version[: self.S], np.int64)
                self.rt.v1_applied[: len(vers)] = vers
                logger.info(
                    "%s restored: %d slots applied",
                    self.node_id.short(),
                    int(self.rt.applied_upto.sum()),
                )
        # unconditionally: a replica that voted but crashed before its first
        # checkpoint has no main blob yet the barrier aux blob exists — that
        # early-life window is the most likely crash window
        await self._restore_vote_barrier()
        connected = await self.transport.get_connected_nodes()
        await self.update_nodes(connected | {self.node_id})

    async def _restore_vote_barrier(self) -> None:
        """Taint slots this replica may have voted in before the crash.

        Re-running consensus in such a slot could cast a DIFFERENT vote in
        the same (slot, phase) — equivocation that can violate agreement
        when f other replicas are simultaneously down. Tainted slots rejoin
        only via adopted peer Decisions or snapshot sync; if no vote traffic
        for them is observed within the release window, nobody holds our
        pre-crash votes and the taint lifts (see _open_slots).
        """
        self._restored_at = time.time()
        if self.persistence is None or self.R <= 1:
            return  # single replica: no peer can hold a conflicting view
        raw = await self.persistence.load_aux("vote_barrier")
        if raw is None:
            return
        barrier = np.frombuffer(raw, np.int64)[: self.n_shards]
        self._barrier[: len(barrier)] = barrier
        self._frontier_floor[: len(barrier)] = barrier
        n = len(barrier)
        taint = barrier > self.rt.applied_upto[:n]
        self.rt.tainted_upto[:n][taint] = barrier[taint]

    @property
    def _taint_release(self) -> float:
        # may be inf (asynchronous-safe mode): see config.taint_release_factor
        return self.config.taint_release_factor * self.config.phase_timeout

    def _tainted_blocked(self) -> bool:
        # applied_upto, not next_slot: a slot decided-but-unapplied before
        # the crash leaves applied_upto under the barrier while next_slot
        # is already past it — recovery still needs the sync
        n = self.n_shards
        return bool(
            (self.rt.applied_upto[:n] < self.rt.tainted_upto[:n]).any()
        )

    async def run(self) -> None:
        """Main loop: drain inbound, advance the kernel one round,
        transmit the outbox, apply decisions, periodic chores.

        Event-driven (the reference's select!-style loop,
        engine.rs:193-235): when the transport supports push
        notification the loop sleeps on a wake event — set by inbound
        delivery and by local submissions — and wakes only for work or
        for the next timer check, instead of pacing every round with a
        fixed sleep (round 3's p50 was dominated by exactly that tick
        alignment). Transports without notification fall back to
        polling at ``round_interval``."""
        self._running = True
        self._stopped.clear()
        await self.initialize()
        self._notify_wired = bool(
            self.transport.set_receive_notify(self._wake.set)
        )
        if self._rtm is not None:
            try:
                self._rtm.start()
            except Exception:
                # the reader thread may already be detached: the asyncio
                # fallback would silently drop inbound frames, so a
                # runtime start failure is fatal for this replica
                logger.exception("native runtime start failed")
                raise
        try:
            while self._running:
                # clear BEFORE draining: anything that lands after this
                # point either gets drained by this tick (a harmless
                # spurious wake later) or sets the event and cuts the
                # idle wait short — a wake can never be lost
                self._wake.clear()
                # stage profiler (asyncio-owner half): while the native
                # runtime owns the commit path its RTS block is the
                # source and this loop is control plane — account only
                # when the asyncio orchestration IS the owner, so the
                # exported breakdown never double-counts two threads.
                # The remainder between consecutive loop tops (yields,
                # journal writes, listener dispatch) lands in "other",
                # so the stage sum tracks the loop's wall time — the
                # same contract as the native RTS block.
                py_owner = self._rtm is None
                now0 = time.perf_counter_ns()
                if py_owner:
                    if self._loop_mark:
                        rem = now0 - self._loop_mark - self._stage_acc
                        if rem > 0:
                            self._stage_ns["other"] += rem
                    self._loop_mark = now0
                    self._stage_acc = 0
                    # a broadcast issued from a spawned task BETWEEN
                    # brackets (e.g. a sync request) credits "broadcast"
                    # and excludes itself from "other" via _stage_acc,
                    # but has no enclosing bracket to carve from — drop
                    # the pending carve so it can't dock the next
                    # iteration's first bracketed stage
                    self._bcast_carve = 0
                t_tick = time.perf_counter()
                if self._rtm is not None:
                    progressed = self._runtime_tick()
                else:
                    progressed = await self._tick()
                dt_tick = time.perf_counter() - t_tick
                if dt_tick > self._slow_tick_s:
                    self._slow_ticks += 1
                    self.journal.record(
                        self.journal.SLOW_TICK, dt_ms=round(dt_tick * 1e3, 2)
                    )
                t_per = time.perf_counter_ns()
                await self._periodic()
                if py_owner:
                    self._stg("timers", time.perf_counter_ns() - t_per)
                if progressed or self._restep:
                    # busy: yield to peers/transport, then loop again
                    await asyncio.sleep(0)
                    continue
                # returns on wake OR timeout (timer check: heartbeats,
                # phase timeouts) — no exception either way
                t_idle = time.perf_counter_ns()
                await self._wake.wait(self._idle_wait())
                if py_owner:
                    self._stg("idle", time.perf_counter_ns() - t_idle)
        except Exception:
            # unclean shutdown: the run loop died on an exception — dump
            # the flight rings while the evidence is still in the window
            # (no-op unless RABIA_FLIGHT_DIR is set), then re-raise
            try:
                p = self.dump_flight(reason="unclean-shutdown")
                if p:
                    logger.error("flight recorder dumped to %s", p)
            except Exception:
                logger.exception("flight dump on unclean shutdown failed")
            raise
        finally:
            # shutdown ordering: runtime thread drain (mid-wave applies
            # complete, the event mailbox empties into Python) → apply
            # plane flush → persistence checkpoint; the caller closes the
            # transport only after shutdown() returns
            if self._rtm is not None:
                try:
                    await self._rtm.stop()
                except Exception:
                    logger.exception("native runtime stop failed")
                finally:
                    # freeze counters + flight ring for late scrapes and
                    # dumps, then free the native context
                    self._rtm.close()
            # settle any deferred apply backlog before externalizing
            # state (persistence checkpoint, late stats readers)
            try:
                self._apply_plane.flush_sync()
            except Exception:
                logger.exception("apply-plane flush on shutdown failed")
            if self._dirty:
                await self._save_state()
            self.rt.is_active = False
            self._stopped.set()

    def stage_second(self, name: str) -> float:
        """Cumulative seconds the commit-path owner spent in one loop
        stage (native RTS block + asyncio-loop accounting — each path
        leaves the other's source at zero)."""
        ns = self._stage_ns.get(name, 0)
        rtm = self._rtm
        if rtm is not None:
            ns += rtm.stage_ns(name)
        return ns * 1e-9

    def stage_seconds(self) -> dict[str, float]:
        """The full ``rabia_runtime_stage_seconds`` breakdown as a dict
        (the serial-latency budget gate prints this on failure so an
        ambient-load flake carries its own diagnosis)."""
        from rabia_tpu_torch.obs.registry import RUNTIME_STAGES

        return {s: self.stage_second(s) for s in RUNTIME_STAGES}

    def _stg(self, name: str, ns: int) -> None:
        """Asyncio-owner stage accounting: one named section's duration
        (kept with a per-iteration accumulator so the run loop can
        attribute the remainder to ``other`` — the stage sum tracks the
        owner loop's wall time, same contract as the native RTS block)."""
        if self._bcast_carve:
            # wire-staging time already credited to "broadcast" by
            # _stg_bcast happened inside this bracket — carve it out so
            # the enclosing stage doesn't count it twice
            ns = max(0, ns - self._bcast_carve)
            self._bcast_carve = 0
        self._stage_ns[name] += ns
        self._stage_acc += ns

    def _stg_ext(self, name: str, ns: int) -> None:
        """Stage accounting for control-plane components sharing this
        loop (the gateway's "gateway"/"serialization" brackets): credit
        the named stage and exclude the ns from the run loop's `other`
        remainder via the per-iteration accumulator. No carve handling —
        external brackets manage their own nesting."""
        self._stage_ns[name] = self._stage_ns.get(name, 0) + ns
        self._stage_acc += ns

    def _stg_bcast(self, ns: int) -> None:
        """Broadcast staging observed inside another stage's bracket
        (kernel outbox under "tick", heartbeats under "timers"): credit
        the broadcast stage directly and leave the same ns pending for
        _stg to subtract from the enclosing bracket — without this the
        asyncio profile prints broadcast=0 while "tick" silently absorbs
        the wire-staging time the native RTS block reports separately."""
        self._stage_ns["broadcast"] += ns
        self._stage_acc += ns
        self._bcast_carve += ns

    def _runtime_tick(self) -> bool:
        """One control-plane pass while the native runtime owns the
        commit path: drain the event mailbox (decisions, applied waves,
        escalated frames), then pump staged work (scalar opens, block
        waves, forwards) back down as commands."""
        self._tick_count += 1
        rtm = self._rtm
        n_ev = rtm.drain_events()
        rtm.pump()
        if self._frontier_dirty:
            self._frontier_dirty = False
            for cb in self._frontier_listeners:
                try:
                    cb()
                except Exception:  # a listener must never kill the loop
                    logger.exception("frontier listener failed")
        return bool(n_ev)

    def _idle_wait(self) -> float:
        """How long an idle loop may sleep before re-checking timers.

        With wake-on-inbox wired, the sleep only bounds timer
        granularity (heartbeats, phase-timeout retransmits, the
        monitor) — capped well under the smallest configured interval.
        Without it, the sleep IS the inbound poll period, so the old
        ``round_interval`` pacing is kept."""
        c = self.config
        if not self._notify_wired:
            return c.round_interval
        # capped by the smallest configured timer interval (a max()
        # floor above these would delay heartbeats/retransmits past
        # their configured periods); 0.5ms floor avoids busy-waking
        # when a test configures a microscopic phase_timeout
        return max(
            0.0005,
            min(0.05, c.heartbeat_interval / 4, c.phase_timeout / 8),
        )

    # ------------------------------------------------------------------
    # The round tick
    # ------------------------------------------------------------------

    async def _tick(self) -> bool:
        self._tick_count += 1
        pcns = time.perf_counter_ns
        t0 = pcns()
        with span("engine.tick.drain"):
            got_msgs = await self._drain_messages(self._drain_cap)
        self._stg("ingest", pcns() - t0)
        if self._paused:
            # quorum lost: consensus paused (engine.rs:983-997). Inbound
            # traffic above still adopts Decisions / answers sync, so a
            # healed minority catches up passively before resuming.
            return False
        t0 = pcns()
        with span("engine.tick.open"):
            self._forward_submissions()
            bulk = self._open_block_slots()
            opened = self._open_slots()
        stepped = False
        # step the kernel on NEW input (opens or arrivals) or when the last
        # step left ledger-resident progress pending (_restep): the kernel
        # advances one stage per step, so a stage transition (R1→R2 cast,
        # phase advance) can make votes ALREADY in the ledger/carry
        # decisive without any further peer traffic — most acutely for
        # R==1, where no peer traffic ever arrives. Otherwise idle steps
        # are pure dispatch waste; loss recovery is timeout-driven
        # (_check_timeouts), not step-driven.
        if opened or bulk is not None or got_msgs or self._restep:
            self._restep = False
            with span("engine.tick.kernel"):
                await self._kernel_round(opened, bulk)
            stepped = True
        self._stg("tick", pcns() - t0)  # open collection + kernel round
        t0 = pcns()
        with span("engine.tick.apply"):
            applied = self._apply_ready()
        self._stg("apply", pcns() - t0)
        t0 = pcns()
        with span("engine.tick.timeouts"):
            self._check_timeouts()
        self._stg("timers", pcns() - t0)
        if applied and self.persistence is not None:
            self._dirty = True
        if applied:
            self._frontier_dirty = True
        if self._frontier_dirty:
            self._frontier_dirty = False
            for cb in self._frontier_listeners:
                try:
                    cb()
                except Exception:  # a listener must never kill the loop
                    logger.exception("frontier listener failed")
        return bool(got_msgs or opened or bulk is not None or applied) and stepped

    def _anything_in_flight(self) -> bool:
        return bool(self.rt.in_flight[: self.n_shards].any())

    # -- inbound ------------------------------------------------------------

    async def _drain_messages(self, cap: int = 256) -> int:
        """Drain up to `cap` inbound messages (engine.rs:923-947).

        When the transport offers borrowed (zero-copy) frames, the codec
        decodes straight out of the native arena — no bytes-object copy
        per frame (SURVEY §7.4.7); the buffer is released immediately
        after decode, before the message is handled."""
        n = 0
        recv_borrow = self._recv_borrow
        recv_nowait = self._recv_nowait
        rk = self._rk
        rk_now = time.time() if rk is not None else 0.0
        rk_handled = 0
        node_to_row = self._node_to_row
        if rk is not None and self._recv_raw is not None:
            # address-level fast drain: arena frames feed the C ingest
            # with zero Python buffer wrapping; only frames the fast
            # path declines are materialized for the Python codec.
            # `seen` bounds the loop by frames CONSUMED (including
            # no-effect/dropped ones) so a stale or hostile flood cannot
            # hold the event loop for an unbounded drain.
            recv_raw = self._recv_raw
            seen = 0
            while seen < cap:
                item = recv_raw()
                if item is None:
                    break
                seen += 1
                sender, data, addr, ln, release = item
                if data is None and not addr:
                    # zero-length arena frame (the pool hands out a null
                    # base for 0-byte buffers): not ingestable — let the
                    # codec below reject and log it like any bad frame
                    data = b""
                row = node_to_row.get(sender)
                if row is not None:
                    if addr:
                        rc = rk.ingest_addr(addr, ln, row, rk_now)
                    else:
                        rc = rk.ingest(data, row, rk_now)
                    if rc != 0:
                        if release is not None:
                            release()
                        if rc > 0:
                            rk_handled += 1
                            if rc == 1:
                                n += 1
                        continue
                try:
                    try:
                        if data is None:
                            data = ctypes.string_at(addr, ln)
                        msg = self.serializer.deserialize(data)
                    finally:
                        if release is not None:
                            release()
                    self.validator.validate_message(msg)
                    self._handle_message(sender, msg)
                    n += 1
                except RabiaError as e:
                    self._py_drops["malformed"] += 1
                    srow = node_to_row.get(sender)
                    self.flight.record(
                        FRE_DROP,
                        peer=srow if srow is not None else 0xFFFF,
                        arg=3,
                    )
                    logger.warning(
                        "dropping bad message from %s: %s", sender, e
                    )
            if rk_handled:
                rk.finish_drain(self)
            return n
        seen = 0
        while seen < cap:
            seen += 1
            release = None
            if recv_borrow is not None:
                item = recv_borrow()
                if item is None:
                    break
                sender, data, release = item
            elif recv_nowait is not None:
                item = recv_nowait()
                if item is None:
                    break
                sender, data = item
            else:
                try:
                    sender, data = await self.transport.receive(
                        timeout=0.0005
                    )
                except RabiaError:
                    break
            if rk is not None:
                # native fast path: vote/decision frames are decoded,
                # validated and scattered straight out of the frame buffer
                # (the transport arena under zero-copy recv) — no Python
                # message objects. rc 0 = not a fast-path frame.
                row = node_to_row.get(sender)
                if row is not None:
                    rc = rk.ingest(data, row, rk_now)
                    if rc != 0:
                        if release is not None:
                            release()
                        if rc > 0:
                            rk_handled += 1
                            if rc == 1:
                                # rc 2 = consumed with no effects (all
                                # entries stale): don't charge a kernel
                                # round for it
                                n += 1
                        continue
            try:
                try:
                    msg = self.serializer.deserialize(data)
                finally:
                    if release is not None:
                        release()
                self.validator.validate_message(msg)
                self._handle_message(sender, msg)
                n += 1
            except RabiaError as e:
                self._py_drops["malformed"] += 1
                srow = node_to_row.get(sender)
                self.flight.record(
                    FRE_DROP,
                    peer=srow if srow is not None else 0xFFFF,
                    arg=3,
                )
                logger.warning("dropping bad message from %s: %s", sender, e)
        if rk_handled:
            rk.finish_drain(self)
        return n

    def _handle_message(self, sender: NodeId, msg: ProtocolMessage) -> None:
        """Route one validated message into host buffers (engine.rs:349-379)."""
        if sender != msg.sender:
            # envelope sender must match the transport-authenticated peer:
            # otherwise one faulty peer could forge votes as every other
            # replica row and fabricate a quorum single-handedly
            self._py_drops["spoof"] += 1
            srow = self._node_to_row.get(sender)
            self.flight.record(
                FRE_DROP, peer=srow if srow is not None else 0xFFFF, arg=1
            )
            logger.warning(
                "dropping spoofed message: envelope %s via transport %s",
                msg.sender,
                sender,
            )
            return
        row = self._node_to_row.get(msg.sender)
        if row is None:
            logger.warning("message from unknown node %s", msg.sender)
            return
        self.rt.active_nodes.add(msg.sender)
        p = msg.payload
        # flight: per-frame ingest records. Never double-recorded on the
        # native path — frames the C ingest consumed (RK_HANDLED/RK_NOOP,
        # where it wrote its own FrEvent) never reach this handler; the
        # ones that DO arrive here are exactly those rk_ingest declined
        # (RK_PY) before any ring write, so they must be recorded here or
        # the trace shows votes materializing with no frame_in
        if isinstance(p, VoteRound1):
            self._py_frames["vote1"] += 1
            if len(p):
                self.flight.record(
                    FRE_FRAME_IN,
                    shard=int(p.shards[0]),
                    slot=int(p.phases[0]) >> 16,
                    peer=row,
                    arg=int(MessageType.VoteRound1),
                )
            self._ingest_vote_arrays(row, p.shards, p.phases, p.vals, 1)
        elif isinstance(p, VoteRound2):
            self._py_frames["vote2"] += 1
            if len(p):
                self.flight.record(
                    FRE_FRAME_IN,
                    shard=int(p.shards[0]),
                    slot=int(p.phases[0]) >> 16,
                    peer=row,
                    arg=int(MessageType.VoteRound2),
                )
            self._ingest_vote_arrays(row, p.shards, p.phases, p.vals, 2)
        elif isinstance(p, Decision):
            self._py_frames["decision"] += 1
            if len(p):
                self.flight.record(
                    FRE_FRAME_IN,
                    shard=int(p.shards[0]),
                    slot=int(p.phases[0]) >> 16,
                    peer=row,
                    arg=int(MessageType.Decision),
                )
            self._on_decision(p)
        elif isinstance(p, ProposeBlock):
            self._on_propose_block(row, p)
        elif isinstance(p, Propose):
            self._on_propose(row, p)
        elif isinstance(p, NewBatch):
            self._on_new_batch(p)
        elif isinstance(p, SyncRequest):
            self._on_sync_request(msg.sender, p)
        elif isinstance(p, SyncResponse):
            self._on_sync_response(msg.sender, p)
        elif isinstance(p, HeartBeat):
            self._peer_progress[msg.sender] = (p.committed_phase, time.time())
        elif isinstance(p, QuorumNotification):
            # informational: a peer's view of cluster health — logged and
            # kept for operators/stats (messages.rs:132-136)
            self._peer_quorum_views[msg.sender] = (
                p.has_quorum,
                time.time(),
            )
            if not p.has_quorum:
                logger.warning(
                    "%s: peer %s reports quorum lost (sees %d nodes)",
                    self.node_id.short(),
                    msg.sender.short(),
                    len(p.active_nodes),
                )

    def _on_propose(self, row: int, p: Propose) -> None:
        if not (0 <= p.shard < self.n_shards):
            return
        sh = self.rt.shards[p.shard]
        slot, _ = unpack_phase(p.phase)
        if slot < sh.applied_upto:
            return  # stale
        if slot_proposer(p.shard, slot, self.R) != row:
            # only the slot's rotation proposer may bind a batch to it;
            # otherwise any replica's (e.g. a confused restarted peer's)
            # Propose could bind divergent batch_ids to the same V1-decided
            # slot across the cluster
            logger.warning(
                "dropping Propose for shard %d slot %d from non-proposer row %d",
                p.shard,
                slot,
                row,
            )
            return
        rec = sh.decisions.get(slot)
        if rec is not None:
            if rec.batch_id is None:
                # slot decided V1 off peers' votes before the Propose got
                # here: repair the binding so apply doesn't need a snapshot
                # sync for a payload that just arrived
                rec.batch_id = p.batch_id
            elif rec.batch_id != p.batch_id:
                return  # slot already decided about a different batch
        # first proposal wins the slot binding; payloads are id-keyed so a
        # conflicting late proposal can't swap the bytes a decision applies
        sh.buf_propose.setdefault(slot, (p.batch_id, p.batch))
        if p.batch is not None:
            sh.payloads[p.batch_id] = p.batch
        if rec is not None and not rec.applied:
            # a late payload/binding may have just unwedged apply — the
            # apply scan is dirty-set driven, so re-mark the shard
            self._apply_dirty.add(p.shard)

    def _on_propose_block(self, row: int, p: ProposeBlock) -> None:
        """Receiver side of the bulk lane: bind the block's (shard, slot)
        proposals columnar; shards whose slot is current open V1 on the
        next tick's bulk open pass."""
        b = p.block
        n = self.n_shards
        # bounds-filter BEFORE any fancy indexing: wire shard indices are
        # attacker-controlled and an out-of-range index would raise out of
        # the drain loop
        inb = (b.shards >= 0) & (b.shards < n)
        if not inb.all():
            if not inb.any():
                return
            b = b.subset(np.nonzero(inb)[0])
        shards, slots = b.shards, b.slots
        ok = (slot_proposer_vec(shards, slots, self.R) == row) & (
            slots >= self.rt.applied_upto[shards]
        )
        # first binding wins: never displace an existing block or scalar
        # binding for the shard's window. Duplicate/partial-wave announces
        # of the same block id each register their own handle — bindings
        # index into the exact announced subset, and already-bound shards
        # are skipped here
        # only bind at-or-ahead of our head; behind-head slots are decided
        # or being decided without the payload (repaired below)
        head = np.maximum(
            self.rt.next_slot[shards], self.rt.applied_upto[shards]
        )
        # one pending binding a shard; behind a current binding only for
        # a later slot (the next slot's announce can arrive while this
        # replica still decides the current one: dropping it would leave
        # that slot to decide here without its payload)
        free = (
            (self._blk_pending_ref[shards] == -1)
            & ((self._cur_blk_ref[shards] == -1) | (slots > head))
            & ~self.rt.prop_flag[shards]
        )
        accept = ok & free & (slots >= head)
        unbound = ok & ~accept
        if unbound.any():
            # decided here before this announce arrived (a peer's
            # Decision overtook it), or the shard's binding is busy: keep
            # the payloads for those slots' decisions
            self._apply_dirty.update(
                self._repair_from_block(b, np.nonzero(unbound)[0])
            )
        idxs = np.nonzero(accept)[0]
        if len(idxs) == 0:
            return
        ref = self._register_block(b, None, row)
        sh_a = shards[idxs]
        self._blk_pending_ref[sh_a] = ref
        self._blk_pending_idx[sh_a] = idxs
        self._blk_pending_slot[sh_a] = slots[idxs]

    def _repair_from_block(self, block, idxs=None, stash: bool = True) -> list[int]:
        """Bind the payloads of ``block`` (its entries ``idxs``, default
        all) to slots this replica decided V1 without them, and return
        the shards repaired. The block-lane twin of ``_on_propose``'s
        late-Propose repair, in place of a snapshot sync for bytes already
        on hand (which would also overtake this replica's own pending
        outcomes). With ``stash``, an entry whose slot has no decision
        yet keeps its payload in ``payloads`` and ``buf_propose`` for the
        decision to come (the shard's binding was busy when it arrived)."""
        n = self.n_shards
        repaired = []
        for i in range(len(block)) if idxs is None else idxs.tolist():
            s = int(block.shards[i])
            slot = int(block.slots[i])
            if not (0 <= s < n) or slot < 0:
                continue
            sh = self.rt.shards[s]
            rec = sh.decisions.get(slot)
            if rec is None:
                if stash and slot >= sh.applied_upto and slot not in sh.buf_propose:
                    bid = block.batch_id_for(i)
                    sh.payloads[bid] = block.materialize_batch(i)
                    sh.buf_propose[slot] = (bid, None)
                continue
            if (
                not rec.applied
                and rec.value == StateValue.V1
                and (
                    rec.batch_id is None
                    or (
                        rec.batch_id not in sh.payloads
                        and rec.batch_id not in sh.applied_ids
                    )
                )
            ):
                bid = block.batch_id_for(i)
                sh.payloads[bid] = block.materialize_batch(i)
                rec.batch_id = bid
                repaired.append(s)
        return repaired

    def _open_block_slots(self):
        """Vectorized bulk open: every shard whose pending block binding
        matches its head slot starts consensus with vote V1 now.

        Returns (idx, slots) arrays or None."""
        n = self.n_shards
        rt = self.rt
        pend = self._blk_pending_slot[:n]
        if not (pend >= 0).any():
            return None
        head = np.maximum(rt.next_slot[:n], rt.applied_upto[:n])
        ready = (
            (pend == head)
            & ~rt.in_flight[:n]
            & (rt.tainted_upto[:n] <= head)
        )
        if not ready.any():
            return None
        idx = np.nonzero(ready)[0]
        self._cur_blk_ref[idx] = self._blk_pending_ref[idx]
        self._cur_blk_idx[idx] = self._blk_pending_idx[idx]
        self._blk_pending_ref[idx] = -1
        self._blk_pending_slot[idx] = -1
        now = time.time()
        rt.in_flight[idx] = True
        np.maximum.at(rt.next_slot, idx, head[idx])
        rt.opened_at[idx] = now
        rt.last_progress[idx] = now
        # proposer side: announce blocks whose shards just opened (after
        # the vote barrier — _kernel_round flushes the announces)
        own = self._cur_blk_ref[idx]
        own_refs = np.unique(own)
        for ref in own_refs:
            rec = self._blk_registry.get(int(ref))
            if rec is None or rec.out is None:
                continue
            sel = idx[own == ref]
            bidx = self._cur_blk_idx[sel]
            if len(bidx) == len(rec.block):
                announce = rec.block
            else:
                announce = rec.block.subset(bidx)
            self._pending_block_announces.append(ProposeBlock(block=announce))
        return idx, head[idx]

    def _finish_block_slots(self, idx: np.ndarray) -> None:
        """Vectorized decide+apply for block-bound shards: record
        bookkeeping with array ops, group by block, bulk-apply V1 waves."""
        rt = self.rt
        slots = np.asarray(self._cur_slot)[idx].astype(np.int64)
        vals = np.asarray(self._decided)[idx]
        refs = self._cur_blk_ref[idx]
        bidxs = self._cur_blk_idx[idx]

        in_order = rt.applied_upto[idx] == slots
        if not in_order.all():
            # a sync overtook these shards mid-flight: route per shard
            # through the scalar ledger (rare)
            for j in np.nonzero(~in_order)[0]:
                s = int(idx[j])
                ref, bi = int(refs[j]), int(bidxs[j])
                rec = self._blk_registry.get(ref)
                if rec is not None:
                    sh = rt.shards[s]
                    bid = rec.block.batch_id_for(bi)
                    sh.payloads[bid] = rec.block.materialize_batch(bi)
                    sh.buf_propose.setdefault(int(slots[j]), (bid, None))
                    if rec.out is not None:
                        if (
                            int(vals[j]) == V1
                            and rt.applied_upto[s] < int(slots[j])
                        ):
                            # not overtaken: an earlier slot of the shard
                            # waits for its payload. The scalar lane applies
                            # this entry after it and settles the outcome
                            sh.block_waiters[bid] = (int(slots[j]), rec.out, bi)
                        else:
                            rec.out.settle(
                                bi,
                                ResponsesUnavailableError(
                                    "block shard overtaken by sync"
                                ),
                            )
                    if rt.applied_upto[s] > int(slots[j]):
                        # the snapshot already covered this slot: the
                        # scalar lane will never apply the demoted batch
                        # here, so its coalescing-lane aliases would be
                        # lost — register them ids-only (no responses)
                        # so a covered client's session-loss replay
                        # dedups into the repair/unavailable path
                        # instead of re-proposing a double apply
                        self.register_applied_aliases(
                            s, int(slots[j]),
                            rec.block.alias_ids_for(bi), stage=False,
                        )
                    self._unref_block(ref, 1)
                self._cur_blk_ref[s] = -1
                self._record_decision(s, int(slots[j]), int(vals[j]), None)
            keep = in_order
            idx, slots, vals, refs, bidxs = (
                idx[keep],
                slots[keep],
                vals[keep],
                refs[keep],
                bidxs[keep],
            )
            if len(idx) == 0:
                return

        v1 = vals == V1
        # V0 (null) slots: nothing applies. Only the PROPOSER requeues the
        # batch (scalar lane, next rotation); receivers just drop their
        # binding — every binder requeueing would commit the batch once per
        # replica under fresh ids, defeating dedup
        if (~v1).any():
            for j in np.nonzero(~v1)[0]:
                ref = int(refs[j])
                rec = self._blk_registry.get(ref)
                if rec is None:
                    continue
                if rec.out is not None:
                    self._demote_block_entry(ref, int(bidxs[j]))
                else:
                    self._unref_block(ref, 1)
        # V1 waves: group by block, apply in bulk
        lost: list[int] = []  # positions whose block is gone — scalar path
        if v1.any():
            v1_idx = np.nonzero(v1)[0]
            wave_refs = refs[v1_idx]
            for ref in np.unique(wave_refs):
                rec = self._blk_registry.get(int(ref))
                sel = v1_idx[wave_refs == ref]
                if rec is None:
                    # registry entry gone (GC raced a very old stall):
                    # NEVER silently skip the apply — route through the
                    # scalar ledger so the payload-missing slot stalls
                    # apply and sync repairs it
                    lost.extend(sel.tolist())
                    continue
                bsel = bidxs[sel].astype(np.int64)
                want = rec.out is not None
                try:
                    with span("sm.apply"):
                        if self._is_vector_sm:
                            responses = self.sm.apply_block(
                                rec.block, bsel, want_responses=want
                            )
                        else:
                            responses = [
                                self.sm.apply_batch(
                                    rec.block.materialize_batch(int(bi))
                                )
                                for bi in bsel
                            ]
                except Exception as e:
                    # deterministic apply failure (same on every replica):
                    # consume the slots, fail the submitter's entries
                    logger.warning("block apply failed (ref %s): %s", ref, e)
                    responses = None
                    if want:
                        err = RabiaError(f"apply failed: {e}")
                        for bi in bsel:
                            rec.out.settle(int(bi), err)
                if want and responses is not None:
                    for bi, resp in zip(bsel, responses):
                        rec.out.settle(int(bi), resp)
                if rec.block.aliases:
                    # coalescing lane: per-client alias ids into the
                    # dedup ledger (aliases exist only on own blocks)
                    for k, (j, bi) in enumerate(zip(sel, bsel)):
                        self.register_applied_aliases(
                            int(idx[j]), int(slots[j]),
                            rec.block.alias_ids_for(int(bi)),
                            None if responses is None else responses[k],
                            have_responses=want,
                        )
                if self._wal is not None:
                    # durability plane: stage each applied entry with its
                    # ops (slices of the block payload) under the SAME
                    # deterministic batch id the scalar lane would use,
                    # so recovery repopulates the dedup ledger correctly
                    # — and enter it into the LIVE ledger too (round 15:
                    # a failover replay at THIS replica's gateway must
                    # dedup; durable clusters only, so the persistence-
                    # free bulk lanes stay free of per-entry dict work)
                    blk = rec.block
                    boffs = blk.cmd_offsets
                    bstarts = blk.shard_starts
                    bdata = blk.data
                    for j, bi in zip(sel, bsel):
                        lo, hi = int(bstarts[bi]), int(bstarts[bi + 1])
                        ebid = blk.batch_id_for(int(bi))
                        rt.shards[int(idx[j])].applied_ids[ebid] = None
                        self._wal_stage(
                            int(idx[j]), int(slots[j]), 1,
                            bid_bytes=ebid.value.bytes,
                            ops=[
                                bytes(bdata[boffs[k] : boffs[k + 1]])
                                for k in range(lo, hi)
                            ],
                        )
                self._unref_block(int(ref), len(bsel))
            rt.state_version += int(v1.sum()) - len(lost)
            good = (
                np.setdiff1d(v1_idx, np.asarray(lost, np.int64))
                if lost
                else v1_idx
            )
            np.add.at(rt.v1_applied, idx[good], 1)
            self.rt.last_apply_time = time.time()
        if lost:
            keep = np.ones(len(idx), bool)
            for j in lost:
                s = int(idx[j])
                self._cur_blk_ref[s] = -1
                self._record_decision(s, int(slots[j]), int(vals[j]), None)
                keep[j] = False
            idx, slots, vals = idx[keep], slots[keep], vals[keep]
            v1 = vals == V1
            if len(idx) == 0:
                return

        if self._wal is not None and (~v1).any():
            # V0 slots stage payload-less frontier records (replay
            # advances past them without applying anything)
            for j in np.nonzero(~v1)[0]:
                self._wal_stage(int(idx[j]), int(slots[j]), 0)
        # columnar bookkeeping for the whole wave. Flight records are
        # BOUNDED per wave: this is the vectorized bulk lane (tens of
        # thousands of decisions/s), where per-slot Python records would
        # tax exactly the path the lane exists to keep columnar — and a
        # full wave would churn straight through the 4096-cap ring
        # anyway. (No batch hash either: block entries are traced by
        # (shard, slot), not session coordinates.)
        for j in range(min(len(idx), 64)):
            self.flight.record(
                FRE_DECIDE, shard=int(idx[j]), slot=int(slots[j]),
                arg=int(vals[j]),
            )
            self.flight.record(
                FRE_APPLY, shard=int(idx[j]), slot=int(slots[j]),
                arg=int(vals[j]),
            )
        rt.applied_upto[idx] = slots + 1
        rt.next_slot[idx] = slots + 1
        self._frontier_dirty = True
        rt.in_flight[idx] = False
        rt.opened_at[idx] = 0.0
        rt.head_fwd_at[idx] = 0.0
        self._cur_blk_ref[idx] = -1
        # decided-value ring: the stale-vote repair's answer source for
        # bulk slots (which never materialize SlotRecords)
        ring = slots & (rt.DEC_RING - 1)
        rt.dec_ring_val[idx, ring] = vals
        rt.dec_ring_slot[idx, ring] = slots
        n_v1 = int(v1.sum())
        rt.decided_v1 += n_v1
        rt.decided_v0 += len(idx) - n_v1
        if self.persistence is not None and len(idx):
            self._dirty = True

    # -- vote ingest (columnar) ---------------------------------------------

    def _ingest_vote_arrays(
        self,
        row: int,
        shards: np.ndarray,
        phases: np.ndarray,
        vals: np.ndarray,
        round_no: int,
    ) -> None:
        """Stash one sender's vote vector for this tick's bulk route.

        Cheap per-message side effects happen eagerly (vectorized): stale
        drop, taint-traffic marking, votes-seen tracking for slot opening.
        """
        n = self.n_shards
        if shards.shape[0] == 1:
            # scalar fast path: the serial/low-shard deployment shape
            # sends one-entry vote vectors, where every fancy-indexing
            # step below costs more than the whole scalar transcription
            rt = self.rt
            s = shards[0].item()
            if s < 0 or s >= n:
                return
            ph = phases[0].item()
            slot = ph >> 16
            if slot < rt.applied_upto[s]:
                self._py_stale += 1
                self.flight.record(
                    FRE_STALE, shard=s, slot=slot, peer=row, arg=round_no
                )
                self._repair_stale_sender(
                    row, shards, np.asarray([slot], np.int64)
                )
                return
            if slot < rt.tainted_upto[s]:
                rt.taint_traffic[s] = time.time()
            if slot > rt.votes_seen_slot[s]:
                rt.votes_seen_slot[s] = slot
            stash = self._stash1 if round_no == 1 else self._stash2
            # fully scalar entry — _route_votes dispatches on type(shards)
            stash.append(
                (row, s, slot, ph & _MVC_MASK, vals[0].item())
            )
            return
        # full bounds check here (the wire validator no longer scans vote
        # vectors element-wise): negative or oversized indices would
        # wrap/raise in every fancy-indexing step below
        ok = (shards >= 0) & (shards < n)
        if not ok.all():
            shards, phases, vals = shards[ok], phases[ok], vals[ok]
        if len(shards) == 0:
            return
        slots = phases >> 16
        live = slots >= self.rt.applied_upto[shards]
        if not live.all():
            # the sender is voting in slots we already decided: it missed
            # the Decision (loss / heal) — answer with a targeted repair
            # instead of letting it stall into the sync path
            self._py_stale += int((~live).sum())
            for s_st, sl_st in zip(shards[~live][:64], slots[~live][:64]):
                self.flight.record(
                    FRE_STALE, shard=int(s_st), slot=int(sl_st), peer=row,
                    arg=round_no,
                )
            self._repair_stale_sender(row, shards[~live], slots[~live])
            shards, phases, vals, slots = (
                shards[live],
                phases[live],
                vals[live],
                slots[live],
            )
        if len(shards) == 0:
            return
        tainted = slots < self.rt.tainted_upto[shards]
        if tainted.any():
            # peers are deciding tainted slots: hold the taint (sliding
            # quiet-window — the column stores the last-seen time)
            self.rt.taint_traffic[shards[tainted]] = time.time()
        np.maximum.at(self.rt.votes_seen_slot, shards, slots)
        mvcs = phases & _MVC_MASK
        stash = self._stash1 if round_no == 1 else self._stash2
        stash.append((row, shards, slots, mvcs, vals))

    def _buffer_votes(
        self, row: int, votes: tuple[VoteEntry, ...], round_no: int
    ) -> None:
        """Compat shim: ingest a tuple-of-VoteEntry vote vector."""
        vv = VoteRound1(votes=votes)
        self._ingest_vote_arrays(row, vv.shards, vv.phases, vv.vals, round_no)

    def _repair_stale_sender(
        self, row: int, shards: np.ndarray, slots: np.ndarray
    ) -> None:
        """Unicast Decisions (with bindings) for decided slots a lagging
        sender is still voting in. Rate-limited per sender; slots already
        GC'd from the ledger fall back to the sync path on the sender."""
        now = time.time()
        if len(shards) > 64:
            # a storm of stale votes from one sender: a peer is far
            # behind (or replaying) — journaled for triage alongside the
            # rate-limited repair below
            self.journal.record(
                self.journal.STALE_STORM, row=row, entries=int(len(shards))
            )
        last = self._last_repair.get(row, 0.0)
        if now - last < max(0.05, self.config.phase_timeout / 4):
            return
        entries: list[DecisionEntry] = []
        rt = self.rt
        for s, slot in zip(shards[:256], slots[:256]):
            s, slot = int(s), int(slot)
            rec = rt.shards[s].decisions.get(slot)
            if rec is not None:
                entries.append(
                    DecisionEntry(
                        shard=s,
                        phase=pack_phase(slot, 0),
                        decision=rec.value,
                        batch_id=rec.batch_id,
                    )
                )
                continue
            # bulk-lane slots have no SlotRecord: the decided-value ring
            # still answers for the last DEC_RING slots per shard
            ring = slot & (rt.DEC_RING - 1)
            if rt.dec_ring_slot[s, ring] == slot:
                entries.append(
                    DecisionEntry(
                        shard=s,
                        phase=pack_phase(slot, 0),
                        decision=StateValue(int(rt.dec_ring_val[s, ring])),
                        batch_id=None,
                    )
                )
        if entries:
            self._last_repair[row] = now
            self._send(
                Decision(decisions=tuple(entries)),
                recipient=self._row_to_node[row],
            )

    def _route_votes(self) -> None:
        """Offer every stashed/carried vote matching a shard's current
        (slot, phase) to the kernel ledger; keep future votes for later
        ticks; drop stale ones. One vectorized pass per sender batch."""
        for round_no, stash, carry in (
            (1, self._stash1, self._carry1),
            (2, self._stash2, self._carry2),
        ):
            if not stash and not carry:
                continue
            items = carry + stash
            stash.clear()
            carry.clear()
            for row, shards, slots, mvcs, vals in items:
                if type(shards) is int:
                    # scalar entry (one-vote vector, see ingest fast path)
                    s = shards
                    if slots < self.rt.applied_upto[s]:
                        continue  # stale: decided+applied while stashed
                    if (
                        self.rt.in_flight[s]
                        and slots == self._cur_slot[s]
                        and mvcs == self._cur_phase[s]
                    ):
                        if self._host_kernel:
                            led = (
                                self.kstate.led1
                                if round_no == 1
                                else self.kstate.led2
                            )
                            if led[row, s] == ABSENT:
                                led[row, s] = vals
                                self.flight.record(
                                    FRE_ROUTE1 if round_no == 1
                                    else FRE_ROUTE2,
                                    shard=s, slot=slots, peer=row,
                                    arg=int(vals),
                                )
                        else:
                            plane = (
                                self._inbox1
                                if round_no == 1
                                else self._inbox2
                            )
                            if plane[s, row] == ABSENT:
                                plane[s, row] = vals
                                self.flight.record(
                                    FRE_ROUTE1 if round_no == 1
                                    else FRE_ROUTE2,
                                    shard=s, slot=slots, peer=row,
                                    arg=int(vals),
                                )
                    else:
                        self.flight.record(
                            FRE_CARRY, shard=s, slot=slots, peer=row,
                            arg=round_no,
                        )
                        carry.append((row, s, slots, mvcs, vals))
                    continue
                live = slots >= self.rt.applied_upto[shards]
                if not live.all():
                    shards, slots, mvcs, vals = (
                        shards[live],
                        slots[live],
                        mvcs[live],
                        vals[live],
                    )
                if len(shards) == 0:
                    continue
                cur = (
                    self.rt.in_flight[shards]
                    & (slots == self._cur_slot[shards])
                    & (mvcs == self._cur_phase[shards])
                )
                if cur.any():
                    sh_c = shards[cur]
                    v_c = vals[cur]
                    sl_c = slots[cur]
                    for j in range(len(sh_c)):
                        self.flight.record(
                            FRE_ROUTE1 if round_no == 1 else FRE_ROUTE2,
                            shard=int(sh_c[j]), slot=int(sl_c[j]),
                            peer=row, arg=int(v_c[j]),
                        )
                    if self._host_kernel:
                        self.kernel.offer_votes(
                            self.kstate, round_no, row, sh_c, v_c
                        )
                    else:
                        plane = self._inbox1 if round_no == 1 else self._inbox2
                        cell = plane[sh_c, row]
                        w = cell == ABSENT
                        plane[sh_c[w], row] = v_c[w]
                    if cur.all():
                        continue
                    keep = ~cur
                    shards, slots, mvcs, vals = (
                        shards[keep],
                        slots[keep],
                        mvcs[keep],
                        vals[keep],
                    )
                carry.append((row, shards, slots, mvcs, vals))
        # bound the carry: genuinely unreachable future votes must not
        # accumulate without limit (validation bounds phase jumps, but a
        # malicious/buggy peer could still flood)
        for carry in (self._carry1, self._carry2):
            total = sum(
                1 if type(t[1]) is int else len(t[1]) for t in carry
            )
            cap = 8 * self.S * self.R
            while carry and total > cap:
                t = carry.pop(0)[1]
                total -= 1 if type(t) is int else len(t)

    def _on_decision(self, p: Decision) -> None:
        """Vectorized decision ingest: current-slot decisions go straight to
        the adoption plane; gap/future/bid-bearing entries fall back to the
        per-entry path (rare outside crash recovery)."""
        if self._rtm is not None:
            # runtime mode: escalated Decision frames (gaps, bid-bearing
            # recovery) must not touch the adopted-decision plane or the
            # consensus columns — the runtime thread owns both. The
            # bridge records/buffers them dict-side and adopts at the
            # head through CMD_DECIDE.
            return self._rtm.on_peer_decisions(p)
        n = self.n_shards
        shards, phases, vals = p.shards, p.phases, p.vals
        ok = shards < n
        if not ok.all():
            if p.bids is not None:
                self._on_decision_entries(p)
                return
            shards, phases, vals = shards[ok], phases[ok], vals[ok]
        if len(shards) == 0:
            return
        slots = phases >> 16
        stale = slots < self.rt.applied_upto[shards]
        cur = (
            ~stale
            & self.rt.in_flight[shards]
            & (slots == self._cur_slot[shards])
        )
        if p.bids is None and bool(cur.all()):
            self._dec_plane[shards] = vals
            return
        if p.bids is None:
            sh_c = shards[cur]
            self._dec_plane[sh_c] = vals[cur]
            rest = ~cur & ~stale
            if not rest.any():
                return
            idxs = np.nonzero(rest)[0]
            for i in idxs:
                self._on_decision_one(
                    int(shards[i]), int(slots[i]), int(vals[i]), None
                )
        else:
            self._on_decision_entries(p)

    def _on_decision_entries(self, p: Decision) -> None:
        for i, (s, ph, v) in enumerate(zip(p.shards, p.phases, p.vals)):
            s = int(s)
            if not (0 <= s < self.n_shards):
                continue
            slot = int(ph) >> 16
            if slot < self.rt.applied_upto[s]:
                continue
            self._on_decision_one(s, slot, int(v), p.bid_at(i))

    def _on_decision_one(self, s: int, slot: int, value: int, bid) -> None:
        sh = self.rt.shards[s]
        rec = sh.decisions.get(slot)
        if rec is not None:
            if rec.batch_id is None and bid is not None:
                rec.batch_id = bid  # late binding repair
                if not rec.applied:
                    self._apply_dirty.add(s)
            return
        if sh.in_flight and slot == int(self._cur_slot[s]):
            self._dec_plane[s] = value
            if bid is not None and slot not in sh.buf_propose:
                sh.buf_propose[slot] = (bid, None)
            return
        if slot < max(sh.next_slot, sh.applied_upto):
            # gap slot (below the head, e.g. decided-but-lost across a
            # crash): it will never "become current" again, so adopt the
            # peer decision immediately — buffering it would wedge apply
            # at the gap forever
            self._record_decision(s, slot, value, bid)
            if bid is not None and slot not in sh.buf_propose:
                sh.buf_propose[slot] = (bid, None)
            return
        # buffered only: recorded when the slot becomes current, either
        # via kernel adoption (in flight) or in _open_slots — keeps slot
        # recording contiguous so apply order never skips a slot
        sh.buf_decision[slot] = (value, bid)
        if bid is not None and slot not in sh.buf_propose:
            sh.buf_propose[slot] = (bid, None)

    def _on_new_batch(self, p: NewBatch) -> None:
        """A peer forwards a submission for us to propose (see module doc)."""
        if not (0 <= p.shard < self.n_shards):
            return
        if p.batch.id in self._seen_batches:
            return
        self._seen_batches.add(p.batch.id)
        self._seen_order.append(p.batch.id)
        self.rt.shards[p.shard].queue.append(PendingSubmission(batch=p.batch))

    # -- submission forwarding / slot opening --------------------------------

    def _forward_submissions(self) -> None:
        """Send queued batches to the upcoming slot's proposer when that's
        not us. The submission stays queued locally (with its future) so the
        submitter can still answer its client; the proposer's copy drives
        consensus. Re-forwarded on timeout by `_check_timeouts`."""
        n = self.n_shards
        rt = self.rt
        queued = rt.queue_len[:n] > 0
        if not queued.any():
            return
        if not (queued & ~rt.in_flight[:n]).any():
            # everything queued rides a slot already in flight: nothing to
            # forward (the common state for the whole consensus window —
            # skip the proposer/clock chain below)
            return
        now = time.time()
        head = np.maximum(rt.next_slot[:n], rt.applied_upto[:n])
        proposer = slot_proposer_vec(self._shard_ids[:n], head, self.R)
        # a restarted replica never proposes in its tainted slots. Where
        # the head slot is its own, the batch goes to the next slot's
        # proposer: that peer's forward back here times out and nulls
        # the head slot, and it proposes the batch in its own. (The
        # reference forwards nothing there, so the submission waits for
        # the taint release, taint_release_factor * phase_timeout of no
        # tainted-slot traffic.)
        mine_tainted = (proposer == self.me) & (head < rt.tainted_upto[:n])
        for k in range(1, self.R if mine_tainted.any() else 1):
            nxt = slot_proposer_vec(self._shard_ids[:n], head + k, self.R)
            proposer = np.where(
                mine_tainted & (proposer == self.me), nxt, proposer
            )
        need = (
            queued
            & ~rt.in_flight[:n]
            & (proposer != self.me)
            & (
                (rt.head_fwd_at[:n] == 0.0)
                | (now - rt.head_fwd_at[:n] >= self.config.phase_timeout)
            )
        )
        if not need.any():
            return
        for s in np.nonzero(need)[0]:
            s = int(s)
            sh = rt.shards[s]
            # settle what already applied first: a tainted head never
            # reaches the settling in _open_slots / the runtime's pump,
            # and forwarding an applied batch only makes peers drop it
            while sh.queue and sh.queue[0].batch.id in sh.applied_ids:
                self._settle_from_ledger(sh, sh.queue.popleft())
            if not sh.queue:
                continue
            sub = sh.queue[0]
            if sub.forwarded_at and now - sub.forwarded_at < self.config.phase_timeout:
                rt.head_fwd_at[s] = sub.forwarded_at
                continue
            if self._decided_unapplied(
                sh, sub.batch.id, unseen_holds=self._rtm is not None
            ):
                continue  # committed already: settles when it applies
            sub.forwarded_at = now
            rt.head_fwd_at[s] = now
            if not sub.first_forwarded_at:
                sub.first_forwarded_at = now
            target = self._row_to_node[int(proposer[s])]
            self._send(
                NewBatch(shard=s, batch=sub.batch), recipient=target
            )

    @staticmethod
    def _decided_unapplied(sh, batch_id, unseen_holds: bool = False) -> bool:
        """True when a slot of ``sh`` decided V1 but not applied yet may
        hold ``batch_id``: its batch is ``batch_id``, or not known yet (the
        decision landed before its Propose, as on the native runtime,
        where votes decide in C while the Propose escalates to Python).
        With ``unseen_holds`` (the native runtime) a decided slot whose
        record has not reached Python yet counts too: the runtime thread
        moves ``next_slot`` at the decision, and the record follows
        through its mailbox, so in that window the head's proposer is
        already the next slot's and a forward or a proposal of the head
        commits it a second time.
        The dedup ledger (``applied_ids``) learns of a batch only at apply
        (and the apply plane defers slots past its inline budget to its
        drain), so without this a submission still at its queue's head in
        that window is forwarded and proposed again, and commits in a
        second slot. The reference engine has no such check (its planes
        gate then fails once a wave passes the apply plane's inline budget
        and first drain chunk, and its runtime gate needs a retry)."""
        for slot in range(sh.applied_upto, sh.next_slot):
            rec = sh.decisions.get(slot)
            if rec is None:
                if unseen_holds:
                    return True
                continue
            if rec.applied or int(rec.value) != V1:
                continue
            bid = rec.batch_id
            if bid is None:
                bp = sh.buf_propose.get(slot)
                bid = bp[0] if bp is not None else None
            if bid is None or bid == batch_id:
                return True
        return False

    def _open_slots(self) -> list[tuple[int, int, int]]:
        """Decide which shards open a new decision slot this round.

        Returns [(shard, slot, initial_vote)]. Cases:
          - we are the proposer and have a queued batch → open V1 + Propose;
          - a Propose arrived for the slot → open V1;
          - peers are already voting on the slot (or a timeout expired on a
            forwarded submission) → open V0 after a grace period.

        Candidate shards are selected with one columnar scan; the per-shard
        decision logic below runs only for shards that can actually act.
        """
        n = self.n_shards
        rt = self.rt
        lib = self._hk_lib
        if lib is not None:
            # one C pass over the columns; an idle tick costs one int
            head, cand = self._open_bufs
            if not lib.rk_open_scan(*self._open_scan_args):
                return []
        else:
            head = np.maximum(rt.next_slot[:n], rt.applied_upto[:n])
            cand = ~rt.in_flight[:n] & (
                (rt.queue_len[:n] > 0)
                | rt.prop_flag[:n]
                | rt.dec_flag[:n]
                | (rt.votes_seen_slot[:n] >= head)
                | (rt.tainted_upto[:n] > 0)
            )
            if not cand.any():
                return []
        now = time.time()
        grace = min(max(self.config.phase_timeout / 10.0, 0.02), 1.0)
        opened: list[tuple[int, int, int]] = []
        propose_entries: list[Propose] = []
        alive_set = self.rt.active_nodes | {self.node_id}  # hoisted: hot loop
        for s in np.nonzero(cand)[0]:
            s = int(s)
            sh = rt.shards[s]
            slot = int(head[s])
            if slot in sh.decisions:  # decided while we weren't looking
                sh.next_slot = slot + 1
                continue
            bd = sh.buf_decision.get(slot)
            if bd is not None and bd[0] in (V0, V1):
                # a peer already broadcast this slot's decision: adopt it
                # without running consensus locally
                self._record_decision(s, slot, bd[0], bd[1])
                continue
            if slot < sh.tainted_upto:
                # restart-equivocation guard: this replica may have voted in
                # this slot before crashing — never cast fresh votes. The
                # slot resolves via an adopted peer Decision (above), via
                # snapshot sync, or — when a full release window passes
                # with NO tainted-slot vote traffic — the taint lifts:
                # in-flight peers retransmit every phase_timeout, so a
                # quiet window several times that proves nobody live holds
                # our pre-crash votes. (A sliding window, not a latch —
                # traffic that stopped long ago must not wedge a shard
                # whose rotation parks on this replica.)
                quiet_since = max(
                    self._restored_at, float(rt.taint_traffic[s])
                )
                # the quiet window only proves anything about CONNECTED
                # peers: an absent (partitioned/paused) peer is exactly
                # the one that could still hold our pre-crash votes. With
                # the full membership in view, release after one window;
                # with peers missing, hold out 4x longer — a dead peer
                # must not wedge the shard forever, but a partitioned one
                # gets ample time to heal and retransmit (which refreshes
                # taint_traffic, restarting the window).
                full_view = len(alive_set) >= len(self.cluster.all_nodes)
                release = self._taint_release * (1.0 if full_view else 4.0)
                if now - quiet_since > release:
                    sh.tainted_upto = 0
                continue
            proposer_row = slot_proposer(s, slot, self.R)
            # never propose a batch that already committed in another slot
            # (duplicate-forwarding race): settle it from the dedup ledger
            while sh.queue and sh.queue[0].batch.id in sh.applied_ids:
                done_sub = sh.queue.popleft()
                self._settle_from_ledger(sh, done_sub)
            if slot in sh.buf_propose:
                # an existing binding wins the slot — never rebind, even as
                # the proposer: re-proposing a different batch for a slot
                # that already carries one could bind divergent batch_ids
                # across replicas (retransmits go through _check_timeouts)
                opened.append((s, slot, V1))
            elif proposer_row == self.me and sh.queue:
                sub = sh.queue[0]
                if self._decided_unapplied(sh, sub.batch.id):
                    # committed in an earlier slot whose apply the apply
                    # plane deferred: the ledger guard above settles it
                    # once it applies — proposing it again would commit
                    # the batch in a second slot
                    continue
                self._h_stage["submit_propose"].observe(
                    now - sub.submitted_at
                )
                self.flight.record(
                    FRE_PROPOSE, shard=s, slot=slot,
                    batch=fr_hash(sub.batch.id),
                )
                sh.payloads[sub.batch.id] = sub.batch
                sh.buf_propose[slot] = (sub.batch.id, sub.batch)
                propose_entries.append(
                    Propose(
                        shard=s,
                        phase=pack_phase(slot, 0),
                        batch_id=sub.batch.id,
                        value=StateValue.V1,
                        batch=sub.batch,
                    )
                )
                opened.append((s, slot, V1))
            else:
                votes_seen = rt.votes_seen_slot[s] >= slot
                if votes_seen:
                    if sh.opened_at == 0.0:
                        sh.opened_at = now  # start the grace clock
                    elif now - sh.opened_at > grace:
                        opened.append((s, slot, V0))
                elif sh.queue and sh.queue[0].first_forwarded_at and (
                    now - sh.queue[0].first_forwarded_at
                    > (
                        self.config.phase_timeout
                        if self._row_to_node[proposer_row] in alive_set
                        # known-dead proposer: short-circuit after one grace
                        # period instead of a transient-heartbeat-gap
                        # instant null slot
                        else max(grace, self.config.phase_timeout / 4)
                    )
                ):
                    # forwarded proposer unresponsive: force a null slot to
                    # rotate the proposer (leaderless liveness).
                    # first_forwarded_at, not forwarded_at — the periodic
                    # re-forward refreshes the latter, which must not reset
                    # the give-up clock.
                    opened.append((s, slot, V0))
        if opened:
            idx = np.fromiter((o[0] for o in opened), np.int64, len(opened))
            slots_arr = np.fromiter((o[1] for o in opened), np.int64, len(opened))
            rt.in_flight[idx] = True
            np.maximum.at(rt.next_slot, idx, slots_arr)
            rt.opened_at[idx] = now
            rt.last_progress[idx] = now
        # Proposes are NOT sent here: the vote barrier must be durable
        # before any proposal for a newly opened slot reaches the wire —
        # otherwise a crash-restart could rebind a different batch to a slot
        # some peer already bound. _kernel_round flushes these right after
        # the barrier save.
        self._pending_proposes.extend(propose_entries)
        return opened

    # -- the kernel round ----------------------------------------------------

    def _dwell_observe(self, idx, new_ph) -> None:
        """Python-twin per-phase dwell observe (host/device tick paths;
        the native path's twin lives in rk_tick). ``new_ph`` holds each
        shard's post-advance phase = the 1-based ordinal of the phase
        that just completed. The slot guard skips shards whose stamp
        belongs to an earlier slot (armed outside _flight_open)."""
        from rabia_tpu_torch.obs.registry import slo_bucket_index

        now = time.monotonic_ns()
        cur = np.asarray(self._cur_slot)
        for j in range(len(idx)):
            s = int(idx[j])
            if int(self._dwell_t0_slot[s]) != int(cur[s]):
                continue
            p = int(new_ph[j])
            if p >= 1:
                h = self._py_dwell[min(p, 8) - 1]
                ns = now - int(self._dwell_t0[s])
                h[slo_bucket_index(ns)] += 1
                h[-2] += 1
                h[-1] += ns
            self._dwell_t0[s] = now

    def _flight_open(self, idx, slots_arr, init_arr) -> None:
        """Flight OPEN records for slots armed outside the native tick's
        own open path (host-kernel rounds, and the native round's
        Python-vote pre-arm, where rk_start_slots runs standalone and the
        C ring therefore records nothing)."""
        if len(idx):
            # phase-dwell stamp: the armed slots' phase 1 starts now
            t = time.monotonic_ns()
            ii = np.asarray(idx, np.int64)
            self._dwell_t0[ii] = t
            self._dwell_t0_slot[ii] = np.asarray(slots_arr, np.int64)
        for j in range(len(idx)):
            self.flight.record(
                FRE_OPEN, shard=int(idx[j]), slot=int(slots_arr[j]),
                arg=int(init_arr[j]),
            )
        if len(idx):
            self.flight.record(
                FRE_FRAME_OUT, shard=int(idx[0]), slot=int(slots_arr[0]),
                arg=int(MessageType.VoteRound1),
            )

    async def _kernel_round(
        self,
        opened: list[tuple[int, int, int]],
        bulk: Optional[tuple[np.ndarray, np.ndarray]] = None,
    ) -> None:
        if opened or bulk is not None:
            await self._advance_vote_barrier(opened, bulk)
        if self._pending_proposes:
            for pe in self._pending_proposes:
                self._send(pe)
            self._pending_proposes.clear()
        if self._pending_block_announces:
            for pb in self._pending_block_announces:
                self._send(pb)
            self._pending_block_announces.clear()
        have_opens = bool(opened) or bulk is not None
        idx = slots_arr = init_arr = None
        mask = slots_full = init_full = None
        if have_opens:
            if opened:
                k = len(opened)
                idx = np.fromiter((o[0] for o in opened), np.int64, k)
                slots_arr = np.fromiter((o[1] for o in opened), np.int64, k)
                init_arr = np.fromiter((o[2] for o in opened), np.int8, k)
            else:
                idx = np.zeros(0, np.int64)
                slots_arr = np.zeros(0, np.int64)
                init_arr = np.zeros(0, np.int8)
            if bulk is not None:
                b_idx, b_slots = bulk
                idx = np.concatenate([idx, b_idx])
                slots_arr = np.concatenate([slots_arr, b_slots])
                init_arr = np.concatenate(
                    [init_arr, np.full(len(b_idx), V1, np.int8)]
                )
            if self._host_kernel:
                # reused full-width planes (freshly allocating three
                # S-wide arrays per open tick measurably taxes the serial
                # shape); consumers only read masked positions
                mask, slots_full, init_full = self._open_planes
                mask[:] = False
            elif self.kernel.planes is not None:
                # device backend on a card: straight into the node
                # kernel's pinned plane buffer, which the launch reads
                kp = self.kernel.planes
                mask, slots_full, init_full = kp.shard_mask, kp.slot_index, kp.initial_votes
                mask[:] = False
            else:
                # device backend on the CPU: the dlpack adoption shares
                # these buffers with the launch — fresh arrays per tick,
                # as the reference's
                mask = np.zeros(self.S, bool)
                slots_full = np.zeros(self.S, np.int64)
                init_full = np.full(self.S, V0, np.int8)
            mask[idx] = True
            slots_full[idx] = slots_arr
            init_full[idx] = init_arr

        if not self._host_kernel:
            return self._device_round(idx, slots_arr, init_arr, mask,
                                      slots_full, init_full)

        if self._rk is not None:
            return self._native_round(
                idx, slots_arr, init_arr, mask, slots_full, init_full
            )

        if have_opens:
            with span("engine.kernel.start"):
                self.kstate = self.kernel.start_slots(
                    self.kstate, mask, slots_full.astype(np.int32), init_full
                )
            self._refresh_mirrors()
            self._flight_open(idx, slots_arr, init_arr)
            self._send(
                VoteRound1(
                    shards=idx,
                    phases=(slots_arr << 16),
                    vals=init_arr,
                )
            )

        # Step to quiescence WITHIN the tick: the kernel advances one
        # stage per step, and a transition (R1→R2 cast, phase advance)
        # can make votes already ledger-resident decisive with no
        # further peer traffic. Looping route→step→outbox here collapses
        # those into one engine activation — e.g. a replica whose drain
        # delivered a full R1+R2 quorum proposes, advances and decides
        # in a single tick instead of three wake-ups. Bounded: a slot
        # crosses at most a few stages per delivery, so 4 covers the
        # deepest chain; anything left re-arms ``_restep`` for the next
        # tick exactly as before.
        for _ in range(4):
            with span("engine.kernel.route"):
                self._route_votes()
            prev_phase = self._cur_phase
            with span("engine.kernel.step"):
                self.kstate, outbox = self.kernel.node_step(
                    self.kstate, None, None, self._dec_plane
                )
            self._dec_plane.fill(ABSENT)
            self._refresh_mirrors()
            with span("engine.kernel.outbox"):
                self._process_outbox(outbox, prev_phase)
            if not self._restep:
                break
            self._restep = False

    def _tick_planes(self, mask, slots_full, init_full) -> list:
        """The tick's six planes (mask, slots, initial votes, inbox_r1,
        inbox_r2, decision_in) as ``node_cycle`` takes them. On a card
        they are the node kernel's pinned plane views (the open planes
        written there by ``_kernel_round``; None when no slot opens),
        which the launch reads in place over the link: nothing is copied,
        whatever zero_copy_inbox says. On the CPU, without zero_copy_inbox
        they are copied (``to_device_all``: the planes may change at
        once); with it ``torch.from_dlpack`` adopts them in place. Either
        way the host must not touch them until the tick's fetch has
        completed."""
        from rabia_tpu_torch.core.device import to_device_all

        inboxes = (self._inbox1, self._inbox2, self._dec_plane)
        if self.kernel.planes is not None:
            return [mask, slots_full, init_full, *inboxes]
        if mask is None:
            mask = np.zeros(self.S, bool)
            slots_full = np.zeros(self.S, np.int32)
            init_full = np.full(self.S, V0, np.int8)
        planes = (mask, slots_full.astype(np.int32), init_full, *inboxes)
        if self._zc_inbox:
            return [torch.from_dlpack(a) for a in planes]
        return to_device_all(planes, self.kernel.device)

    def _device_round(
        self,
        idx: Optional[np.ndarray],
        slots_arr: Optional[np.ndarray],
        init_arr: Optional[np.ndarray],
        mask: Optional[np.ndarray],
        slots_full: Optional[np.ndarray],
        init_full: Optional[np.ndarray],
    ) -> None:
        """One engine tick on the device backend: ONE node_cycle launch
        (start + ``device_substeps`` chained node_steps) and ONE fetch of
        its mirrored state and outbox (on a card: one event, then views of
        the node kernel's host image, which the launch wrote in place)."""
        if idx is not None:
            # host-side mirror update (the device applies the same open
            # inside node_cycle): routing below must see the new slots
            self._cur_slot[idx] = slots_arr
            self._cur_phase[idx] = 0
            self._stage[idx] = R1_WAIT
            self._my_r1[idx] = init_arr
            self._my_r2[idx] = ABSENT
            self._decided[idx] = ABSENT
            self._done[idx] = False
            self._active[idx] = True
            self._flight_open(idx, slots_arr, init_arr)
            self._send(
                VoteRound1(
                    shards=idx,
                    phases=(slots_arr << 16),
                    vals=init_arr,
                )
            )
        with span("engine.kernel.route"):
            self._route_votes()
        prev_phase = self._cur_phase.copy()
        events = self._tick_events()
        fetched, mapped = self.kernel.fetch_bytes, self.kernel.mapped_bytes
        with span("engine.kernel.step"):
            self._tick_event(events)
            planes = self._tick_planes(mask, slots_full, init_full)
            self._tick_event(events)
            self.kstate, outboxes = self.kernel.node_cycle(
                self.kstate, *planes, self._substeps, donate=True
            )
            self._tick_event(events)
        with span("engine.kernel.fetch"):
            pending = self.kernel.fetch_start(self.kstate, outboxes)
            self._tick_event(events)
            st_np, ob_np = pending.result()
        # the fetch completed, so node_cycle consumed the planes: only now
        # may the host change them for the next tick
        del planes
        adopted = self._dec_plane != ABSENT
        self._inbox1.fill(ABSENT)
        self._inbox2.fill(ABSENT)
        self._dec_plane.fill(ABSENT)
        self._set_mirrors(st_np)
        self._tick_account(events, self.kernel.fetch_bytes - fetched,
                           self.kernel.mapped_bytes - mapped)
        with span("engine.kernel.outbox"):
            self._process_outbox_window(ob_np, prev_phase, adopted)

    def _tick_events(self):
        """A list to collect the tick's CUDA events in, or None when the
        device ticks are not timed (``device_tick_timing`` off, or a CPU
        kernel)."""
        if self.device_tick_timing and self.kernel.device.type == "cuda":
            return []
        return None

    @staticmethod
    def _tick_event(events) -> None:
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    def _tick_account(self, events, d2h: int, mapped: int) -> None:
        st = self.device_tick_stats
        st["ticks"] += 1
        st["d2h_bytes"] += d2h
        st["mapped_bytes"] += mapped
        if events:
            events[-1].synchronize()
            st["timed_ticks"] += 1
            st["upload_span_ms"] += events[0].elapsed_time(events[1])
            st["launch_span_ms"] += events[1].elapsed_time(events[2])
            st["fetch_span_ms"] += events[2].elapsed_time(events[3])

    def _native_round(
        self,
        idx: Optional[np.ndarray],
        slots_arr: Optional[np.ndarray],
        init_arr: Optional[np.ndarray],
        mask: Optional[np.ndarray],
        slots_full: Optional[np.ndarray],
        init_full: Optional[np.ndarray],
    ) -> None:
        """One engine tick on the native fast path: slot arming in place,
        then ONE C call chaining route→node_step→outbox rounds and framing
        outbound votes/decisions (hostkernel.cpp rk_tick). Python resumes
        only for events: decided slots to record/apply."""
        rk = self._rk
        py_votes = bool(
            self._stash1 or self._stash2 or self._carry1 or self._carry2
        )
        if py_votes and mask is not None:
            # votes injected through the Python ingest APIs (tests, compat
            # shims) must route AFTER slot arming, like the Python path —
            # arm separately, then route, then chain without opens
            with span("engine.kernel.start"):
                rk.start_slots(mask, slots_full, init_full)
            self._flight_open(idx, slots_arr, init_arr)
            self._send(
                VoteRound1(
                    shards=idx, phases=(slots_arr << 16), vals=init_arr
                )
            )
            mask = None
        if py_votes:
            # the Python scatter writes the same persistent ledger arrays
            # the C tick reads
            self._route_votes()
        # span name matches the host path's step (the chained C call IS
        # the route→step→outbox sequence)
        with span("engine.kernel.step"):
            if mask is not None:
                res = rk.tick(
                    open_mask=mask,
                    open_slots=slots_full,
                    open_init=init_full,
                )
            else:
                res = rk.tick()
        nbytes = int(res[0])
        if nbytes:
            t_bc = time.perf_counter_ns()
            rk.broadcast_out(self, nbytes)
            dt_bc = time.perf_counter_ns() - t_bc
            self._h_slo["broadcast"].observe(dt_bc * 1e-9)
            if self._rtm is None:
                self._stg_bcast(dt_bc)
        if res[4]:
            logger.warning(
                "native tick outbound buffer overflow; dropped frames "
                "recover via retransmit"
            )
        if res[2]:
            self._restep = True
        if res[1]:
            n = self.n_shards
            act = self.rt.in_flight[:n]
            done = self.kstate.done[:n] & act
            newly = rk.newly[:n].astype(bool) & act
            rk.newly[:n] = 0
            with span("engine.kernel.outbox"):
                # decision frames for newly decided slots were already
                # framed by rk_tick — record/apply only
                self._process_decided(done, newly, broadcast=False)

    async def _advance_vote_barrier(
        self,
        opened: list[tuple[int, int, int]],
        bulk: Optional[tuple[np.ndarray, np.ndarray]] = None,
    ) -> None:
        """Persist the vote barrier BEFORE the first vote of any newly
        opened slot leaves this replica (write-ahead), so a post-crash
        restore can taint every slot that may hold our votes.

        The barrier is advanced ``barrier_stride`` slots AHEAD of the
        opened slot, so one atomic-write+fsync amortizes over the next K
        opens per shard instead of landing on every consensus round's
        critical path. Cost: a restart may taint up to K-1 never-voted
        slots, which the taint-release window already resolves (restore
        path is deliberately conservative)."""
        if self.persistence is None:
            return
        stride = max(1, self.config.barrier_stride)
        changed = False
        for s, slot, _v in opened:
            if slot >= self._barrier[s]:
                self._barrier[s] = slot + stride
                changed = True
        if bulk is not None:
            b_idx, b_slots = bulk
            due = b_slots >= self._barrier[b_idx]
            if due.any():
                np.maximum.at(
                    self._barrier, b_idx[due], b_slots[due] + stride
                )
                changed = True
        if changed:
            await self.persistence.save_aux(
                "vote_barrier", self._barrier[: self.n_shards].tobytes()
            )

    def _refresh_mirrors(self) -> None:
        st = self.kstate
        if self._host_kernel:
            # host arrays: mirrors alias the kernel state (no copies)
            self._cur_slot = st.slot
            self._cur_phase = st.phase
            self._stage = st.stage
            self._my_r1 = st.my_r1
            self._my_r2 = st.my_r2
            self._done = st.done
            self._decided = st.decided
            self._active = st.active
        else:
            self._set_mirrors(self.kernel.fetch(st)[0])

    def _set_mirrors(self, st) -> None:
        """Adopt host mirrors from a (fetched) kernel state. Mirrors must
        be WRITABLE copies: the device round updates them in place for
        opened slots before the launch."""
        self._cur_slot = np.array(st.slot, np.int64)
        self._cur_phase = np.array(st.phase, np.int64)
        self._stage = np.array(st.stage, np.int8)
        self._my_r1 = np.array(st.my_r1, np.int8)
        self._my_r2 = np.array(st.my_r2, np.int8)
        self._done = np.array(st.done, bool)
        self._decided = np.array(st.decided, np.int8)
        self._active = np.array(st.active, bool)

    def _process_outbox(self, outbox, prev_phase: np.ndarray) -> None:
        """Turn kernel outbox flags into broadcast messages + decisions —
        columnar gathers; per-shard Python only for newly decided slots."""
        n = self.n_shards
        rt = self.rt
        act = rt.in_flight[:n]
        # nonzero-once (then branch on idx.size): at small S the repeated
        # tiny-array .any() dispatches dominate the outbox cost
        cast_idx = np.nonzero(np.asarray(outbox.cast_r2)[:n] & act)[0]
        done = np.asarray(self._done)[:n] & act
        adv_all_idx = np.nonzero(np.asarray(outbox.advanced)[:n] & act)[0]
        adv_idx = adv_all_idx[~done[adv_all_idx]]
        done_idx = np.nonzero(done)[0]
        if not (cast_idx.size or adv_all_idx.size or done_idx.size):
            return
        now = time.time()
        # a stage transition may have made ledger-resident (or carried)
        # votes decisive — schedule one follow-up step (see _tick)
        if cast_idx.size or adv_all_idx.size:
            self._restep = True
        if adv_all_idx.size:
            # per-phase dwell closes on EVERY advance — deciding shards
            # (masked out of adv_idx below) still finish their final phase
            self._dwell_observe(
                adv_all_idx, np.asarray(outbox.new_phase)[adv_all_idx]
            )

        if cast_idx.size:
            idx = cast_idx
            slots = np.asarray(self._cur_slot)[idx].astype(np.int64)
            phases = (slots << 16) | np.asarray(prev_phase)[idx].astype(np.int64)
            r2v = np.asarray(outbox.r2_vals)[idx]
            for j in range(len(idx)):
                self.flight.record(
                    FRE_CAST_R2, shard=int(idx[j]), slot=int(slots[j]),
                    arg=int(r2v[j]),
                )
            self.flight.record(
                FRE_FRAME_OUT, shard=int(idx[0]), slot=int(slots[0]),
                arg=int(MessageType.VoteRound2),
            )
            self._send(
                VoteRound2(
                    shards=idx,
                    phases=phases,
                    vals=r2v,
                )
            )
            rt.last_progress[idx] = now

        if adv_idx.size:
            idx = adv_idx
            slots = np.asarray(self._cur_slot)[idx].astype(np.int64)
            new_ph = np.asarray(outbox.new_phase)[idx].astype(np.int64)
            phases = (slots << 16) | new_ph
            for j in range(len(idx)):
                self.flight.record(
                    FRE_ADVANCE, shard=int(idx[j]), slot=int(slots[j]),
                    arg=int(new_ph[j]) & 0xFF,
                )
            self.flight.record(
                FRE_FRAME_OUT, shard=int(idx[0]), slot=int(slots[0]),
                arg=int(MessageType.VoteRound1),
            )
            self._send(
                VoteRound1(
                    shards=idx,
                    phases=phases,
                    vals=np.asarray(outbox.new_r1)[idx],
                )
            )
            rt.last_progress[idx] = now

        if done_idx.size:
            newly = np.asarray(outbox.newly_decided)[:n] & act
            dec_vals = np.asarray(self._decided)
            cur = np.asarray(self._cur_slot)
            for s_new in np.nonzero(newly)[0]:
                self.flight.record(
                    FRE_STEP_DECIDE, shard=int(s_new),
                    slot=int(cur[s_new]), arg=int(dec_vals[s_new]),
                )
            self._process_decided(done, newly)

    def _process_outbox_window(
        self, ob, prev_phase: np.ndarray, adopted: Optional[np.ndarray] = None
    ) -> None:
        """Windowed twin of :meth:`_process_outbox`: one stacked outbox
        per chained substep (the device backend's node_cycle). Vote transitions
        are emitted per substep — a shard can legitimately cast R2 in one
        substep and advance (or decide) in a later one within the same
        dispatch, each with its own phase tag. ``adopted`` marks shards
        whose decision_in plane carried a value (they go done at substep
        0, like the host path's adopt)."""
        n = self.n_shards
        rt = self.rt
        act = rt.in_flight[:n]
        if not act.any():
            return
        now = time.time()
        K = len(ob.cast_r2)
        done_final = np.asarray(self._done)[:n] & act
        cur_slot = np.asarray(self._cur_slot)
        prev = np.asarray(prev_phase).astype(np.int64)
        newly_any = np.zeros(n, bool)
        # running done view, matching the host path's per-step `advanced &
        # ~done`: a phase-advance R1 is suppressed only if the shard is
        # done BY THAT SUBSTEP — using the final state would drop votes a
        # pivotal peer still needs (it decides later in the window)
        cum_done = (
            (adopted[:n] & act) if adopted is not None else np.zeros(n, bool)
        )
        for k in range(K):
            cast = ob.cast_r2[k][:n] & act
            if cast.any():
                i = np.nonzero(cast)[0]
                slots = cur_slot[i].astype(np.int64)
                for j in range(len(i)):
                    self.flight.record(
                        FRE_CAST_R2, shard=int(i[j]), slot=int(slots[j]),
                        arg=int(ob.r2_vals[k][i[j]]),
                    )
                self._send(
                    VoteRound2(
                        shards=i,
                        phases=(slots << 16) | prev[i],
                        vals=ob.r2_vals[k][i],
                    )
                )
                rt.last_progress[i] = now
            newly_k = ob.newly_decided[k][:n] & act
            if newly_k.any():
                # phases-to-decide telemetry for the device-kernel path
                # (the host paths account inside HostNodeKernel / the rk
                # tick context): post-advance phase == phases used
                i_new = np.nonzero(newly_k)[0]
                ph_new = np.asarray(ob.new_phase[k])[i_new].astype(np.int64)
                self._dev_phase_sum += int(ph_new.sum())
                np.add.at(
                    self._dev_phase_hist,
                    np.minimum(ph_new, len(self._dev_phase_hist) - 1),
                    1,
                )
            for s_new in np.nonzero(newly_k)[0]:
                self.flight.record(
                    FRE_STEP_DECIDE, shard=int(s_new),
                    slot=int(cur_slot[s_new]),
                    arg=int(np.asarray(self._decided)[s_new]),
                )
            newly_any |= newly_k
            cum_done |= newly_k
            adv_all_k = ob.advanced[k][:n] & act
            if adv_all_k.any():
                i_adv = np.nonzero(adv_all_k)[0]
                self._dwell_observe(
                    i_adv, np.asarray(ob.new_phase[k])[i_adv]
                )
            adv = ob.advanced[k][:n] & act & ~cum_done
            if adv.any():
                i = np.nonzero(adv)[0]
                slots = cur_slot[i].astype(np.int64)
                for j in range(len(i)):
                    self.flight.record(
                        FRE_ADVANCE, shard=int(i[j]), slot=int(slots[j]),
                        arg=int(ob.new_phase[k][i[j]]) & 0xFF,
                    )
                self._send(
                    VoteRound1(
                        shards=i,
                        phases=(slots << 16)
                        | ob.new_phase[k][i].astype(np.int64),
                        vals=ob.new_r1[k][i],
                    )
                )
                rt.last_progress[i] = now
            prev = np.where(
                np.asarray(ob.advanced[k], bool),
                np.asarray(ob.new_phase[k], np.int64),
                prev,
            )
        # ANY substep's transition schedules a follow-up tick: a phase
        # advance can make host-side CARRIED votes routable, which later
        # substeps cannot see (they only cascade on the device ledger) —
        # the next tick's _route_votes must get a chance to offer them
        any_trans = False
        for k in range(K):
            if (ob.cast_r2[k][:n] & act).any() or (
                ob.advanced[k][:n] & act
            ).any():
                any_trans = True
                break
        if any_trans:
            self._restep = True
        if done_final.any():
            self._process_decided(done_final, newly_any)

    def _process_decided(
        self, done: np.ndarray, newly: np.ndarray, broadcast: bool = True
    ) -> None:
        """Record decisions for every done in-flight shard; broadcast the
        newly decided ones (shared by both outbox processors; the native
        tick frames its own Decision broadcasts and passes False)."""
        rt = self.rt
        dec_idx = np.nonzero(done)[0]
        decided_vals = np.asarray(self._decided)
        cur_slot = np.asarray(self._cur_slot)
        blk = self._cur_blk_ref[dec_idx] != -1
        if blk.any():
            self._finish_block_slots(dec_idx[blk])
        for s in dec_idx[~blk]:
            s = int(s)
            sh = rt.shards[s]
            slot = int(cur_slot[s])
            bid = None
            bp = sh.buf_propose.get(slot)
            if bp is not None:
                bid = bp[0]
            elif self._blk_pending_slot[s] == slot:
                ref = int(self._blk_pending_ref[s])
                rec_blk = self._blk_registry.get(ref)
                if rec_blk is not None and rec_blk.out is None:
                    # a received block binding we never opened (e.g. we
                    # voted V0 after grace before its ProposeBlock
                    # arrived): use it as the payload source for the
                    # decided slot
                    bi = int(self._blk_pending_idx[s])
                    bid = rec_blk.block.batch_id_for(bi)
                    sh.payloads[bid] = rec_blk.block.materialize_batch(bi)
                    self._unref_block(ref, 1)
                    self._blk_pending_ref[s] = -1
                    self._blk_pending_slot[s] = -1
                # our own never-announced pending entries stay put:
                # _record_decision voids them into the scalar retry lane
            self._record_decision(s, slot, int(decided_vals[s]), bid)
        if broadcast and newly.any() and self.config.decision_broadcast:
            # steady-state Decisions are bid-free (fully columnar both
            # ways); a peer that never saw the Propose recovers the
            # binding from the late/retransmitted Propose or via sync
            idx = np.nonzero(newly)[0]
            slots = cur_slot[idx].astype(np.int64)
            self.flight.record(
                FRE_FRAME_OUT, shard=int(idx[0]), slot=int(slots[0]),
                arg=int(MessageType.Decision),
            )
            self._send(
                Decision(
                    shards=idx,
                    phases=(slots << 16),
                    vals=decided_vals[idx],
                )
            )

    def _void_pending_block(self, s: int) -> None:
        """A slot a pending block binding targeted resolved without it:
        release the binding. Our own never-announced entries retry through
        the scalar lane (no peer ever saw them, so no duplicate risk);
        received-block bindings are just dropped."""
        ref = int(self._blk_pending_ref[s])
        bi = int(self._blk_pending_idx[s])
        self._blk_pending_ref[s] = -1
        self._blk_pending_slot[s] = -1
        rec = self._blk_registry.get(ref)
        if rec is None:
            return
        if rec.out is not None:
            self._demote_block_entry(ref, bi)
        else:
            self._unref_block(ref, 1)

    def _record_decision(self, s: int, slot: int, value: int, batch_id) -> None:
        sh = self.rt.shards[s]
        if batch_id is None and value == V1:
            # bid-free Decision (the steady-state broadcast) adopted for a
            # slot whose Propose we HAVE: bind it here, or apply stalls
            # into a snapshot sync for a payload already on hand. Common
            # when a fast peer decides before this replica opened the slot
            # (the chained native tick makes one-tick decides routine).
            bp = sh.buf_propose.get(slot)
            if bp is not None:
                batch_id = bp[0]
        if self._blk_pending_slot[s] != -1 and self._blk_pending_slot[s] <= slot:
            self._void_pending_block(s)
        if slot in sh.decisions:
            rec = sh.decisions[slot]
        else:
            rec = SlotRecord(value=StateValue(value), batch_id=batch_id)
            sh.decisions[slot] = rec
            # one DECIDE record per slot, on BOTH tick paths (recording
            # stays a Python event even under the native tick)
            self.flight.record(
                FRE_DECIDE, shard=s, slot=slot, arg=value,
                batch=fr_hash(batch_id) if batch_id is not None else 0,
            )
            if value == V1:
                self.rt.decided_v1 += 1
            else:
                self.rt.decided_v0 += 1
        if sh.in_flight and int(self._cur_slot[s]) == slot:
            opened = float(self.rt.opened_at[s])
            if opened > 0.0:
                # open→decide for the slot this replica ran consensus on
                # (adopted decisions for never-opened slots carry no
                # local open time) — works on both tick paths: recording
                # is a Python event even under the native tick
                self._h_stage["propose_decide"].observe(
                    time.time() - opened
                )
            sh.in_flight = False
        sh.next_slot = max(sh.next_slot, slot + 1)
        sh.opened_at = 0.0
        ring = slot & (self.rt.DEC_RING - 1)
        self.rt.dec_ring_val[s, ring] = value
        self.rt.dec_ring_slot[s, ring] = slot
        # the next slot has a new proposer: restart the forward/give-up
        # clocks for whatever is still queued here
        self.rt.head_fwd_at[s] = 0.0
        for sub in sh.queue:
            sub.forwarded_at = 0.0
            sub.first_forwarded_at = 0.0
        self._apply_dirty.add(s)
        sh.gc_upto(sh.applied_upto)

    # -- decision application ------------------------------------------------

    def _wal_stage(
        self, s: int, slot: int, value: int, batch=None, bid_bytes=None,
        ops=None,
    ) -> None:
        """Stage one decided (shard, slot) into the durability plane's
        group-commit lane (no fsync here — the WAL's flush thread owns
        that; the gateway's result barrier waits on the watermark). A
        wedged log is journaled, never allowed to kill the apply path —
        results stop leaving (the barrier fails) which is the correct
        failure mode for lost durability."""
        p = self._wal
        if p is None:
            return
        if batch is not None:
            bid_bytes = batch.id.value.bytes
            ops = [c.data for c in batch.commands]
        try:
            p.stage_wave(int(s), int(slot), int(value), bid_bytes, ops)
        except PersistenceError:
            logger.exception("wal stage failed (shard %d slot %d)", s, slot)
            self.journal.record(
                self.journal.WAL_WEDGED, shard=int(s), slot=int(slot)
            )

    def _apply_ready(self) -> int:
        """Apply decided slots in order per shard, through the pipelined
        apply stage (engine/apply_plane.py): up to the inline budget
        applies synchronously (the serial commit path never waits for a
        scheduler hop); a deeper backlog queues to the drain task so the
        NEXT consensus round progresses while the state machine catches
        up. Returns slots applied inline."""
        if not self._apply_dirty:
            return 0
        dirty = self._apply_dirty
        self._apply_dirty = set()
        return self._apply_plane.apply_ready(dirty)

    def _apply_shard_ready(self, s: int, budget: int) -> tuple[int, bool]:
        """Apply up to ``budget`` ready slots of shard ``s`` in slot
        order (engine.rs:684-746). Returns (applied, more_ready) —
        ``more_ready`` means the next slot is decided and applicable
        right now (the apply plane keeps draining it)."""
        applied = 0
        sh = self.rt.shards[s]
        while True:
            if applied >= budget:
                return applied, True
            slot = sh.applied_upto
            wal_batch = None  # set iff this slot actually applies a batch
            rec = sh.decisions.get(slot)
            if rec is None or rec.applied:
                if rec is None:
                    break
                sh.applied_upto += 1
                continue
            if rec.value == StateValue.V1:
                batch = (
                    sh.payloads.get(rec.batch_id)
                    if rec.batch_id is not None
                    else None
                )
                if rec.batch_id is not None and rec.batch_id in sh.applied_ids:
                    # duplicate commit (same batch decided in an earlier
                    # slot): never apply twice; just settle the future
                    logger.debug(
                        "row %d shard %d slot %d: dedup-skip batch %s",
                        self.me, s, slot, rec.batch_id,
                    )
                    for i, sub in enumerate(list(sh.queue)):
                        if sub.batch.id == rec.batch_id:
                            del sh.queue[i]
                            self._settle_from_ledger(sh, sub)
                            break
                    self._settle_block_waiter_from_ledger(sh, rec.batch_id)
                elif batch is None:
                    # decided V1 but never saw the payload: snapshot sync
                    # is the recovery path (engine.rs:748-844, §3.3),
                    # after the payload's grace
                    self._sync_for_missing_payload(s, slot)
                    break
                else:
                    try:
                        with span("sm.apply"):
                            responses = self.sm.apply_batch(batch)
                    except Exception as e:
                        # a committed batch the state machine rejects
                        # (undecodable command, app-level panic) fails
                        # DETERMINISTICALLY on every replica: consume
                        # the slot, fail the submitter — never let one
                        # bad command kill the consensus loop
                        logger.warning(
                            "apply failed for batch %s on shard %d: %s",
                            rec.batch_id,
                            s,
                            e,
                        )
                        responses = None
                    sh.applied_ids[rec.batch_id] = None
                    sh.applied_results[rec.batch_id] = responses
                    # demoted/forwarded coalesced entry: per-client alias
                    # ids keep their scalar-lane exactly-once bookkeeping
                    self.register_applied_aliases(
                        s, slot,
                        self._batch_aliases(sh, rec.batch_id, batch),
                        responses, have_responses=True,
                    )
                    wal_batch = batch
                    self.rt.state_version += 1
                    self.rt.v1_applied[s] += 1
                    if responses is not None:
                        self._resolve_local(sh, batch, responses)
                    else:
                        self._fail_local(sh, batch.id, RabiaError("apply failed"))
            else:
                self._requeue_null_slot(sh, slot, rec)
            rec.applied = True
            if self._wal is not None:
                # durability plane: stage the decided wave exactly as
                # applied (ops for a V1 apply; V0 / dedup-skip slots
                # stage payload-less frontier records)
                self._wal_stage(s, slot, int(rec.value), batch=wal_batch)
            self.flight.record(
                FRE_APPLY, shard=s, slot=slot, arg=int(rec.value),
                batch=(
                    fr_hash(rec.batch_id)
                    if rec.batch_id is not None
                    else 0
                ),
            )
            dt_da = time.time() - rec.decided_at
            self._h_stage["decide_apply"].observe(dt_da)
            self._h_slo["decide_apply"].observe(dt_da)
            sh.applied_upto += 1
            sh.gc_upto(sh.applied_upto)
            applied += 1
        return applied, False

    @staticmethod
    def _batch_aliases(sh, bid, batch) -> tuple:
        """Coalescing-lane aliases of an applied scalar batch: from the
        applied payload object itself, or — when the binding adopted a
        WIRE copy (a forwarded/demoted coalesced entry; the codec never
        carries local-only attrs) — from the shard's ``alias_subs``
        stash written at demote time. O(1): ordinary batches carry no
        aliases and the stash is empty outside the coalescing lane."""
        al = getattr(batch, "aliases", ())
        if al:
            if sh.alias_subs and bid is not None:
                sh.alias_subs.pop(bid, None)  # local copy won the bind
            return al
        if bid is None or not sh.alias_subs:
            return ()
        return sh.alias_subs.pop(bid, ())

    def register_applied_aliases(
        self, s: int, slot: int, aliases, responses=None,
        have_responses: bool = False, stage: bool = True,
    ) -> None:
        """Coalescing-lane exactly-once bookkeeping (docs/PERFORMANCE.md
        "Coalescing tier"): a multi-client entry commits ON THE WIRE
        under its lead client's deterministic ``(client_id, seq)``-derived
        id, and EVERY covered client's id (lead included) arrives here as
        an alias ``(bid_bytes16, op_lo, op_hi)`` with op indices relative
        to the entry. Each alias enters the PROPOSER-LOCAL
        ``alias_ledger`` (NOT ``applied_ids``: aliases never ride the
        wire, so only this replica would hold them — and the apply path
        dedup-skips on ``applied_ids`` membership, so an asymmetric
        entry would make THIS replica skip a re-proposed duplicate its
        peers apply, diverging replica state permanently; see the
        ``ShardRuntime.alias_ledger`` comment) with the client's slice
        of the entry's responses in ``applied_results``, and stages a
        K_LEDGER record on durable clusters — so a replayed Submit after
        session-state loss dedups at this gateway's pre-drive check
        (and settles from the ledger, with ONLY that client's responses)
        exactly like a scalar-lane commit, regardless of which lane the
        original rode. ``responses`` is the ENTRY's full response list
        (or None for a deterministic apply failure) when
        ``have_responses``; absent responses leave ``applied_results``
        untouched — and so does an id that already HAS a recorded
        result: the scalar lane writes the FULL entry response list
        under the entry's (== lead's) id before this runs, and
        ``_settle_from_ledger``/entry-level peer repair depend on that
        full list staying intact (the lead's replay path truncates to
        its own op count instead; its ops are the entry's prefix by
        construction). A replay whose responses were never recorded
        gets the honest terminal "committed but responses unavailable"
        after peer repair — per-client slices are NOT recoverable
        post-crash (K_LEDGER records carry ids, not op ranges).
        ``stage=False`` skips the K_LEDGER staging: used by the
        sync-overtake settle sites, where the covered slot has no local
        WAVE record to pair with (the live ``alias_ledger`` entry is
        the point there; crash durability of adopt-overtaken aliases is
        best-effort by design)."""
        if not aliases:
            return
        sh = self.rt.shards[s]
        wal = self._wal if stage else None
        for bid_bytes, lo, hi in aliases:
            bid_bytes = bytes(bid_bytes)
            bid = BatchId(uuid.UUID(bytes=bid_bytes))
            # the value is the client's op COUNT: the ledger-replay
            # serve path truncates a full-entry response list to the
            # RECORDED count, never trusting the replayed Submit's
            # arity (None after crash recovery — K_LEDGER has no ranges)
            sh.alias_ledger[bid] = int(hi) - int(lo)
            if have_responses and bid not in sh.applied_results:
                sh.applied_results[bid] = (
                    None if responses is None
                    else list(responses[int(lo):int(hi)])
                )
            if wal is not None:
                try:
                    wal.stage_ledger(s, slot, bid_bytes)
                except Exception:
                    logger.exception("alias ledger stage failed")
                    wal = None  # one failure wedges the log; stop here

    def _settle_from_ledger(self, sh, sub) -> None:
        """Settle a submitter future for a batch the ledger says is applied.

        Responses are None when the apply happened under a snapshot sync on
        another node — the commit is real but the per-command responses
        never existed here, so the future must FAIL with a distinct error
        rather than resolve with an empty list (callers index responses
        per command)."""
        sh.alias_subs.pop(sub.batch.id, None)  # demote stash: settled
        if sub.future is None or sub.future.done():
            return
        responses = sh.applied_results.get(sub.batch.id)
        if responses is None:
            from rabia_tpu_torch.core.errors import ResponsesUnavailableError

            self.journal.record(
                self.journal.SYNC_OVERTAKE,
                shard=int(sh.shard),
                batch=str(sub.batch.id.value),
            )
            sub.future.set_exception(
                ResponsesUnavailableError(
                    "batch committed but responses unavailable (applied "
                    "via snapshot sync, or the state machine rejected it)"
                )
            )
        else:
            sub.future.set_result(responses)

    @staticmethod
    def _settle_block_waiter(sh, batch_id, result) -> None:
        """Settle the block outcome entry waiting on ``batch_id`` (see
        ``ShardState.block_waiters``), if any."""
        if sh.block_waiters:
            w = sh.block_waiters.pop(batch_id, None)
            if w is not None:
                w[1].settle(w[2], result)

    def _settle_block_waiter_from_ledger(self, sh, batch_id) -> None:
        """A waiting block entry whose batch the dedup ledger says is
        applied: its cached responses, or responses unavailable."""
        if sh.block_waiters and batch_id in sh.block_waiters:
            responses = sh.applied_results.get(batch_id)
            if responses is None:
                responses = ResponsesUnavailableError(
                    "batch committed but responses unavailable"
                )
            self._settle_block_waiter(sh, batch_id, responses)

    def _resolve_local(self, sh, batch: CommandBatch, responses: list[bytes]) -> None:
        """Resolve the submitter future if this batch was queued locally."""
        self._settle_block_waiter(sh, batch.id, responses)
        for i, sub in enumerate(list(sh.queue)):
            if sub.batch.id == batch.id:
                self._h_stage["submit_apply"].observe(
                    time.time() - sub.submitted_at
                )
                if sub.future is not None and not sub.future.done():
                    sub.future.set_result(responses)
                del sh.queue[i]
                break

    def _fail_local(self, sh, batch_id, err: Exception) -> None:
        self._settle_block_waiter(sh, batch_id, err)
        for i, sub in enumerate(list(sh.queue)):
            if sub.batch.id == batch_id:
                if sub.future is not None and not sub.future.done():
                    sub.future.set_exception(err)
                del sh.queue[i]
                break

    def _requeue_null_slot(self, sh, slot: int, rec: SlotRecord) -> None:
        """A V0 (null) decision: the proposed batch (if it was ours) retries
        in a later slot, up to _MAX_SUBMIT_ATTEMPTS."""
        if rec.batch_id is None:
            return
        for i, sub in enumerate(list(sh.queue)):
            if sub.batch.id == rec.batch_id:
                sub.attempts += 1
                if sub.attempts >= _MAX_SUBMIT_ATTEMPTS:
                    if sub.future is not None and not sub.future.done():
                        sub.future.set_exception(
                            RabiaError(f"batch rejected after {sub.attempts} attempts")
                        )
                    del sh.queue[i]
                else:
                    sub.forwarded_at = 0.0
                    sub.first_forwarded_at = 0.0
                break

    # -- timeouts ------------------------------------------------------------

    def _check_timeouts(self) -> None:
        """Retransmit current votes (and proposal) for stalled shards —
        liveness under message loss (host policy per SURVEY.md §7.4.1)."""
        n = self.n_shards
        rt = self.rt
        now = time.time()
        timeout = self.config.phase_timeout
        if self._stall_scan_args is not None:
            # C pre-scan: a healthy tick exits on one int
            if not self._hk_lib.rk_stall_scan(
                *self._stall_scan_args, now, timeout
            ):
                return
        stalled = rt.in_flight[:n] & (now - rt.last_progress[:n] >= timeout)
        if not stalled.any():
            return
        idxs = np.nonzero(stalled)[0]
        r1_mask = np.asarray(self._my_r1)[idxs] != ABSENT
        r2_mask = (np.asarray(self._stage)[idxs] == R2_WAIT) & (
            np.asarray(self._my_r2)[idxs] != ABSENT
        )
        slots = np.asarray(self._cur_slot)[idxs].astype(np.int64)
        phases = (slots << 16) | np.asarray(self._cur_phase)[idxs].astype(np.int64)
        if r1_mask.any():
            # retransmits go through the Python send path on BOTH tick
            # paths — record them unconditionally (the C ring only sees
            # frames rk_tick itself emits)
            self.flight.record(
                FRE_FRAME_OUT, shard=int(idxs[r1_mask][0]),
                slot=int(slots[r1_mask][0]),
                arg=int(MessageType.VoteRound1),
            )
            self._send(
                VoteRound1(
                    shards=idxs[r1_mask],
                    phases=phases[r1_mask],
                    vals=np.asarray(self._my_r1)[idxs[r1_mask]],
                )
            )
        if r2_mask.any():
            self.flight.record(
                FRE_FRAME_OUT, shard=int(idxs[r2_mask][0]),
                slot=int(slots[r2_mask][0]),
                arg=int(MessageType.VoteRound2),
            )
            self._send(
                VoteRound2(
                    shards=idxs[r2_mask],
                    phases=phases[r2_mask],
                    vals=np.asarray(self._my_r2)[idxs[r2_mask]],
                )
            )
        for i, s in enumerate(idxs):
            s = int(s)
            sh = rt.shards[s]
            slot = int(slots[i])
            bp = sh.buf_propose.get(slot)
            if bp is not None and slot_proposer(s, slot, self.R) == self.me:
                self._send(
                    Propose(
                        shard=s,
                        phase=pack_phase(slot, 0),
                        batch_id=bp[0],
                        value=StateValue.V1,
                        batch=bp[1],
                    )
                )
        # stalled block-bound shards we proposed: rebroadcast the block
        # (rate-limited per block) so peers that lost the ProposeBlock can
        # bind and vote V1
        stalled_refs = np.unique(self._cur_blk_ref[idxs])
        for ref in stalled_refs:
            ref = int(ref)
            if ref == -1:
                continue
            rec = self._blk_registry.get(ref)
            if rec is None or rec.out is None:
                continue
            if now - self._last_blk_retransmit.get(ref, 0.0) < timeout:
                continue
            self._last_blk_retransmit[ref] = now
            # retransmit only the slot-assigned entries: demoted shards
            # keep slot -1, which receivers' validators rightly reject
            assigned = rec.block.slots >= 0
            if assigned.all():
                self._send(ProposeBlock(block=rec.block))
            elif assigned.any():
                self._send(
                    ProposeBlock(block=rec.block.subset(np.nonzero(assigned)[0]))
                )
        rt.last_progress[idxs] = now

    # -- sync protocol (engine.rs:748-844) -----------------------------------

    def _sync_for_missing_payload(self, s: int, slot: int) -> None:
        """Slot ``slot`` of shard ``s`` decided V1 and its payload is not
        here. Its Propose or block announce is usually still in flight
        (a peer's Decision can overtake it on a loaded host), and a
        snapshot sync now would overtake this replica's own pending
        outcomes with "responses unavailable". So sync only if the slot
        still waits after a grace of ``min(0.5, phase_timeout / 4)``;
        one wait at a time, as one sync runs at a time."""
        if self._payload_wait is not None or self.rt.sync_started_at is not None:
            return
        self._payload_wait = (s, slot)
        grace = min(0.5, self.config.phase_timeout / 4)

        async def later() -> None:
            try:
                await asyncio.sleep(grace)
                if not self._running:
                    # shut down inside the grace: the caller may have
                    # closed the transport, so nothing is sent
                    return
                rec = self.rt.shards[s].decisions.get(slot)
                if rec is not None and not rec.applied:
                    await self._initiate_sync()
            finally:
                self._payload_wait = None

        self._spawn(later())

    async def _initiate_sync(self) -> None:
        # retry window: a lost SyncRequest/Response must not gate recovery
        # on the full sync_timeout — lossy networks are exactly when sync
        # is needed most
        retry_after = min(self.config.sync_timeout, 4 * self.config.phase_timeout)
        if self.rt.sync_started_at is not None and (
            time.time() - self.rt.sync_started_at < retry_after
        ):
            return
        self.rt.sync_started_at = time.time()
        self.rt.sync_responses.clear()
        self._syncs += 1
        total_applied = int(self.rt.applied_upto.sum())
        self._send(
            SyncRequest(
                current_phase=total_applied, state_version=self.rt.state_version
            )
        )

    def _on_sync_request(self, sender: NodeId, p: SyncRequest) -> None:
        if self._rtm is not None:
            # quiesce the runtime thread: the snapshot and the per-shard
            # frontiers must be a consistent cut of the native plane. If
            # the pause times out, serving a torn cut is worse than
            # staying silent — the requester simply retries.
            with self._rtm.paused() as pz:
                if pz.ok:
                    return self._serve_sync(sender, p)
            return None
        return self._serve_sync(sender, p)

    def _serve_sync(self, sender: NodeId, p: SyncRequest) -> None:
        # settle any deferred apply backlog first: the snapshot (and the
        # ahead/behind comparison below) must reflect the decided
        # ledger, not the drain task's progress — a lagging peer's
        # recovery must not wait on our apply pipelining
        self._apply_plane.flush_sync()
        total_applied = int(self.rt.applied_upto.sum())
        if total_applied <= p.current_phase:
            return  # not ahead; stay silent (engine.rs:763-779)
        snap = self.sm.create_snapshot()
        snap_bytes = snap.to_bytes()
        # ship the FULL in-memory dedup horizon (64x max_pending per shard)
        # whenever it fits the transport frame: a synced replica with a
        # truncated ledger double-applies any batch whose late duplicate
        # commit lands beyond the shipped horizon. The id budget is what
        # remains of the frame after the snapshot and the per-shard u64
        # sections (plus header slack) — a response that overflows the
        # frame cap is dropped by the transport and sync never completes.
        budget = self.config.tcp.buffers.max_frame_size - len(snap_bytes)
        budget -= 2 * 8 * self.S + 65536  # per-shard u64 sections + slack
        id_cap = min(
            64 * self.config.max_pending_batches,
            max(0, budget) // (24 * max(1, self.n_shards)),
        )
        applied_ids = (
            tuple(
                (s, bid)
                for s, sh in enumerate(self.rt.shards[: self.n_shards])
                for bid in list(sh.applied_ids)[-id_cap:]
            )
            if id_cap > 0  # [-0:] would ship the ENTIRE horizon
            else ()
        )
        self._send(
            SyncResponse(
                responder_phase=total_applied,
                state_version=self.rt.state_version,
                snapshot=snap_bytes,
                per_shard_phase=tuple(self.rt.applied_upto.tolist()),
                applied_ids=applied_ids,
                per_shard_version=tuple(self.rt.v1_applied.tolist()),
            ),
            recipient=sender,
        )

    def _on_sync_response(self, sender: NodeId, p: SyncResponse) -> None:
        self.rt.sync_responses[sender] = (
            p.responder_phase,
            p.state_version,
            p.snapshot,
            p.per_shard_phase,
            p.applied_ids,
            p.per_shard_version,
        )
        # only strictly-ahead peers respond at all, so any usable response
        # resolves immediately — waiting for a quorum of responders can
        # stall forever when just one peer is ahead
        total_applied = int(self.rt.applied_upto.sum())
        if p.responder_phase > total_applied or (
            len(self.rt.sync_responses) + 1 >= self.cluster.quorum_size
        ):
            self._resolve_sync()

    def _resolve_sync(self) -> None:
        if self._rtm is not None:
            # adoption mutates the consensus columns and the store plane:
            # the runtime thread must be parked for the duration, and the
            # bridge's apply mirror re-anchors afterwards. A timed-out
            # pause means the thread is still the single writer — adopt
            # nothing (the sync retry window re-requests) rather than
            # race it.
            with self._rtm.paused() as pz:
                if not pz.ok:
                    return
                self._adopt_sync()
                self._rtm._applied = np.maximum(
                    self._rtm._applied,
                    self.rt.applied_upto[: self.n_shards],
                )
                self._rtm._cmd_slot[:] = -1
            return
        return self._adopt_sync()

    def _adopt_sync(self) -> None:
        """Adopt the most advanced responder's snapshot (engine.rs:806-844).

        Adoption is PER SHARD: state and counters are taken only for
        shards where the responder is ahead. Restoring the whole snapshot
        while we are ahead on some shards would regress those shards'
        state beneath our unchanged counters — a state/counter divergence
        that then poisons every snapshot we later serve. State machines
        expose ``restore_shards`` for this; a monolithic SM (no per-shard
        restore) only adopts from a responder that is ahead-or-equal on
        EVERY shard (a superset view — always true for single-shard
        configs), otherwise it waits for per-shard repair/decisions or a
        superset responder.
        """
        if not self.rt.sync_responses:
            return
        best = max(self.rt.sync_responses.values(), key=lambda r: r[0])
        total_applied = int(self.rt.applied_upto.sum())
        self.rt.sync_started_at = None
        if best[0] <= total_applied or best[2] is None:
            return
        from rabia_tpu_torch.core.state_machine import Snapshot

        snap = Snapshot.from_bytes(best[2])
        resp_applied = np.asarray(best[3][: self.S], np.int64)
        ours = self.rt.applied_upto[: len(resp_applied)]
        ahead = np.nonzero(resp_applied > ours)[0]
        if len(ahead) == 0:
            return
        restore_shards = getattr(self.sm, "restore_shards", None)
        if restore_shards is not None:
            restore_shards(snap, ahead.tolist())
        else:
            if bool((resp_applied < ours).any()):
                logger.warning(
                    "%s sync: responder not a superset and state machine "
                    "has no per-shard restore — waiting for repair/decisions",
                    self.node_id.short(),
                )
                return
            self.sm.restore_snapshot(snap)
        # advance the version by the responder's V1-APPLY surplus on the
        # adopted shards only — adopting the responder's GLOBAL version
        # under mixed per-shard progress would over-advertise local state,
        # and counting adopted SLOTS would count null (V0) slots that no
        # other increment site counts, drifting versions apart
        resp_v1 = np.asarray(best[5][: self.S], np.int64)
        if len(resp_v1) == len(self.rt.v1_applied):
            surplus = resp_v1[ahead] - self.rt.v1_applied[ahead]
            self.rt.state_version += int(np.maximum(surplus, 0).sum())
            self.rt.v1_applied[ahead] = np.maximum(
                resp_v1[ahead], self.rt.v1_applied[ahead]
            )
        else:  # responder on an incompatible shard layout: slot-count bound
            self.rt.state_version += int((resp_applied[ahead] - ours[ahead]).sum())
        logger.debug(
            "row %d sync adopt: shards %s ours %s -> resp %s",
            self.me, ahead.tolist(),
            ours[ahead].tolist(), resp_applied[ahead].tolist(),
        )
        for s in ahead.tolist():
            s = int(s)
            applied = int(resp_applied[s])
            sh = self.rt.shards[s]
            if applied > sh.applied_upto:
                # mark skipped slots as applied-elsewhere
                for slot in range(sh.applied_upto, applied):
                    sh.decisions.setdefault(
                        slot, SlotRecord(value=StateValue.V0)
                    ).applied = True
                sh.applied_upto = applied
                sh.next_slot = max(sh.next_slot, applied)
                sh.in_flight = False
                # overtaken block bindings are void (the registry ages out)
                if self._cur_blk_ref[s] != -1:
                    rec = self._blk_registry.get(int(self._cur_blk_ref[s]))
                    if rec is not None and rec.out is not None:
                        rec.out.settle(
                            int(self._cur_blk_idx[s]),
                            ResponsesUnavailableError("block shard overtaken by sync"),
                        )
                    if rec is not None:
                        # voided binding: the wave committed inside the
                        # adopted snapshot — its proposer-local aliases
                        # would be lost with it; keep the ids so covered
                        # clients' replays dedup instead of re-applying
                        self.register_applied_aliases(
                            s, max(0, applied - 1),
                            rec.block.alias_ids_for(
                                int(self._cur_blk_idx[s])
                            ),
                            stage=False,
                        )
                    self._cur_blk_ref[s] = -1
                if self._blk_pending_slot[s] != -1 and self._blk_pending_slot[s] < applied:
                    self._void_pending_block(s)
                for bid, (w_slot, _o, _i) in list(sh.block_waiters.items()):
                    if w_slot < applied:
                        self._settle_block_waiter(
                            sh, bid,
                            ResponsesUnavailableError(
                                "block shard overtaken by sync"
                            ),
                        )
                self._apply_dirty.add(s)
                sh.gc_upto(applied)
        # inherit the responder's dedup ledger: batches already applied via
        # the snapshot must never re-apply here if they commit again later.
        # (applied_results stays empty for them: "responses unavailable" in
        # _settle_from_ledger.)
        for s, bid in best[4]:
            if 0 <= s < self.n_shards:
                self.rt.shards[s].applied_ids.setdefault(bid, None)
        self.rt.sync_responses.clear()
        self._frontier_dirty = True
        if self._wal is not None:
            # the adopted slots never staged WAL records here: until a
            # checkpoint captures the adopted state, a crash would
            # recover a pre-adoption chain with a slot gap (replay stops
            # at the gap and re-syncs — correct but slow). Pull the next
            # checkpoint forward.
            self._dirty = True
            self._wal.request_checkpoint()
        logger.info("%s sync: jumped to %d applied", self.node_id.short(), best[0])

    # -- periodic chores -----------------------------------------------------

    async def _periodic(self) -> None:
        now = time.time()
        if now - self._last_heartbeat >= self.config.heartbeat_interval:
            self._last_heartbeat = now
            total_applied = int(self.rt.applied_upto.sum())
            self._send(
                HeartBeat(
                    current_phase=int(self.rt.next_slot.max(initial=0)),
                    committed_phase=total_applied,
                )
            )
            # lag detection: a peer ahead while we make NO local progress
            # triggers a snapshot sync — a straggler that missed Decisions
            # (loss, healed partition) has no other path back
            # (engine.rs:889-907 analog). The local-idle condition prevents
            # snapshot storms under healthy multi-shard load, where
            # aggregate committed counts skew by a few slots at any instant.
            if self._peer_progress:
                best_peer = max(v[0] for v in self._peer_progress.values())
                # "idle" = no APPLY and no consensus TRANSITION (cast /
                # advance / retransmit refresh last_progress): an engine
                # mid-decision on a slow tick path (e.g. a loaded host
                # running a wide tick) must not be
                # declared a straggler and sync-overtaken — that settles
                # its own submitters' futures as responses-unavailable.
                # A genuinely wedged in-flight shard still recovers: its
                # retransmits draw the targeted stale-vote repair, and
                # the severe-lag branch below syncs regardless.
                last_activity = max(
                    self.rt.last_apply_time,
                    float(
                        self.rt.last_progress[: self.n_shards].max(
                            initial=0.0
                        )
                    ),
                )
                locally_idle = (
                    time.time() - last_activity
                    > 2 * self.config.phase_timeout
                )
                # mild lag only matters when we're stuck (aggregate counts
                # skew by a few slots under healthy multi-shard load);
                # severe lag — sync_lag_slots scaled by the shard count —
                # warrants a sync even while some shards still progress
                mild = best_peer > total_applied and locally_idle
                severe = best_peer >= total_applied + (
                    self.config.sync_lag_slots * max(4, self.n_shards)
                )
                if mild or severe:
                    await self._initiate_sync()
            if self._tainted_blocked():
                # tainted slots can only resolve via peer Decisions or
                # snapshot sync — keep asking (self-rate-limited by the
                # retry window; heartbeat cadence is ample for a path that
                # waits on the taint-release window anyway, and the scan
                # is per-tick numpy otherwise)
                await self._initiate_sync()
        if now - self._last_monitor >= max(self.config.heartbeat_interval, 0.2):
            self._last_monitor = now
            tc = getattr(self.transport, "transport_counters", None)
            if callable(tc):
                # redial churn: steady-state has ~zero dials; a burst
                # inside one monitor window means peers are flapping
                dials = tc().get("dials", 0)
                delta = dials - self._last_dials
                self._last_dials = dials
                if delta >= 8:
                    self.journal.record(
                        self.journal.REDIAL_CHURN, dials=int(delta)
                    )
            connected = await self.transport.get_connected_nodes()
            # refresh membership BEFORE the monitor fires its handlers:
            # QuorumNotification broadcasts read rt.active_nodes and must
            # describe the NEW view, not the stale one
            await self.update_nodes(connected | {self.node_id})
            await self.monitor.observe(connected)
        if now - self._last_cleanup >= self.config.cleanup_interval:
            self._last_cleanup = now
            self._gc()
            # block registry GC: entries whose shards all resolved through
            # other paths (sync overtake, V0 without binding) never hit
            # remaining==0 — age them out
            horizon = max(60.0, 4 * self.config.sync_timeout)
            # never evict a block an in-flight or pending binding still
            # references — dropping one would skip its apply on decide
            live_refs = set(
                np.unique(
                    np.concatenate(
                        [self._cur_blk_ref, self._blk_pending_ref]
                    )
                ).tolist()
            )
            for ref in [
                r
                for r, rec in self._blk_registry.items()
                if now - rec.registered_at > horizon and r not in live_refs
            ]:
                self._blk_registry.pop(ref)
                self._last_blk_retransmit.pop(ref, None)
        if self._dirty:
            # durability plane: decided waves are ALREADY durable in the
            # log — checkpoints only bound recovery time and enable GC,
            # so they run on the WalPersistence pacing (bytes appended /
            # elapsed time), not once per dirty tick like the blob path
            if self._wal is None or self._wal.checkpoint_due():
                self._dirty = False
                await self._save_state()

    def _gc(self) -> None:
        """Bound memory: drop old buffers + seen-batch ids (state.rs:191-243)."""
        for sh in self.rt.shards[: self.n_shards]:
            sh.gc_upto(sh.applied_upto)
            if len(sh.decisions) > self.config.max_phase_history:
                cut = sh.applied_upto - self.config.max_phase_history
                for k in [k for k in sh.decisions if k < cut]:
                    del sh.decisions[k]
            # drop payloads nothing references anymore (e.g. batches whose
            # slots kept deciding V0 and were abandoned) — without this a
            # long-running replica leaks every rejected batch's bytes
            live = {sub.batch.id for sub in sh.queue}
            live.update(bid for bid, _ in sh.buf_propose.values())
            live.update(
                rec.batch_id
                for slot, rec in sh.decisions.items()
                if rec.batch_id is not None and not rec.applied
            )
            for bid in [b for b in sh.payloads if b not in live]:
                del sh.payloads[bid]
            if len(sh.applied_results) > 2 * self.config.max_pending_batches:
                # response CACHE only — evicting here can no longer
                # re-enable a duplicate apply (dedup lives in applied_ids)
                for bid in list(sh.applied_results)[
                    : len(sh.applied_results) - self.config.max_pending_batches
                ]:
                    del sh.applied_results[bid]
            if len(sh.alias_subs) > self.config.max_pending_batches:
                # demote-stash safety cap (normally popped at apply or
                # ledger settle; a wedged demoted entry must not pin it)
                for bid in list(sh.alias_subs)[
                    : len(sh.alias_subs) - self.config.max_pending_batches
                ]:
                    del sh.alias_subs[bid]
            # the dedup ledger is id-only (16B entries): keep a far deeper
            # horizon, evicted FIFO only to bound truly long runs
            id_cap = 64 * self.config.max_pending_batches
            if len(sh.applied_ids) > id_cap:
                for bid in list(sh.applied_ids)[: len(sh.applied_ids) - id_cap]:
                    del sh.applied_ids[bid]
            if len(sh.alias_ledger) > id_cap:
                # same id-only horizon for the coalescing lane's
                # proposer-local per-client dedup ids
                for bid in list(sh.alias_ledger)[
                    : len(sh.alias_ledger) - id_cap
                ]:
                    del sh.alias_ledger[bid]
        # evict oldest seen-batch ids, never the whole dedup set at once
        cap = 10 * self.config.max_pending_batches
        while len(self._seen_order) > cap:
            self._seen_batches.discard(self._seen_order.pop(0))

    async def _save_state(self) -> None:
        if self.persistence is None:
            return
        if self._wal is not None:
            # durability plane: incremental checkpoint (statekernel delta
            # frames when the native plane exists, a full snapshot blob
            # otherwise) + frontier record + WAL-prefix GC. Decided waves
            # are already durable in the log — the checkpoint only bounds
            # recovery time and enables GC, so it runs on the
            # WalPersistence pacing, not per dirty tick.
            def _meta() -> dict:
                n = self.n_shards
                return {
                    "next_slot": self.rt.next_slot[:n].tolist(),
                    "applied_upto": self.rt.applied_upto[:n].tolist(),
                    "state_version": int(self.rt.state_version),
                    "v1_applied": self.rt.v1_applied[:n].tolist(),
                    "sm_version": int(getattr(self.sm, "_version", 0)),
                }

            # the runtime thread owns the statekernel while running: the
            # capture (meta read + delta export + mark + frontier read)
            # happens atomically under pause; file write + GC run unpaused
            if self._rtm is not None:
                with self._rtm.paused():
                    cap = self._wal.capture_checkpoint(_meta(), self.sm)
            else:
                cap = self._wal.capture_checkpoint(_meta(), self.sm)
            try:
                await self._wal.commit_checkpoint(cap)
            except PersistenceError:
                logger.exception("wal checkpoint commit failed")
                self.journal.record(self.journal.WAL_WEDGED, stage="ckpt")
                return
            self.flight.record(
                FRE_WAL, shard=0, slot=self._wal.checkpoints, arg=2,
            )
            return
        snap = self.sm.create_snapshot()
        state = PersistedEngineState(
            current_phase=int(self.rt.next_slot.max(initial=0)),
            last_committed_phase=int(self.rt.applied_upto.sum()),
            state_version=self.rt.state_version,
            snapshot=snap,
            per_shard_phase=self.rt.next_slot.tolist(),
            per_shard_committed=self.rt.applied_upto.tolist(),
            per_shard_version=self.rt.v1_applied.tolist(),
        )
        await self.persistence.save_engine_state(state)

    # -- outbound ------------------------------------------------------------

    def _spawn(self, coro) -> None:
        """Fire-and-forget with a strong reference (the event loop only
        holds tasks weakly; unreferenced tasks can be GC'd before running)."""
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def _send(self, payload, recipient: Optional[NodeId] = None) -> None:
        msg = ProtocolMessage.new(self.node_id, payload, recipient)
        try:
            data = self.serializer.serialize(msg)
        except Exception:
            # a codec failure on one outbound message must never kill the
            # run loop — peers recover the dropped message via the normal
            # retransmit/repair/sync paths
            logger.exception(
                "dropping unserializable %s to %s",
                type(payload).__name__,
                recipient or "broadcast",
            )
            return
        try:
            if recipient is None:
                if self._rtm is None:
                    # the asyncio loop owns the commit path: its
                    # broadcast staging IS the SLO broadcast stage.
                    # While the native runtime owns it, the RTH block
                    # is the sole source — counting control-plane
                    # broadcasts (heartbeats, sync) here would
                    # mis-attribute them to the consensus stage.
                    t_bc = time.perf_counter_ns()
                    staged = self.transport.broadcast_nowait(data)
                    dt_bc = time.perf_counter_ns() - t_bc
                    self._h_slo["broadcast"].observe(dt_bc * 1e-9)
                    self._stg_bcast(dt_bc)
                else:
                    staged = self.transport.broadcast_nowait(data)
                if staged:
                    return
                self._spawn(self.transport.broadcast(data))
            else:
                if self.transport.send_to_nowait(recipient, data):
                    return
                self._spawn(self.transport.send_to(recipient, data))
        except Exception:
            # same containment as the codec guard above: one bad send
            # must not kill the run loop (peers recover via retransmit)
            logger.exception(
                "dropping failed send of %s to %s",
                type(payload).__name__,
                recipient or "broadcast",
            )
