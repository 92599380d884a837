"""MeshEngine: state machine replication with consensus on the device.

The port of the reference's ``rabia_tpu/parallel/mesh_engine.py`` on one
device. All R replicas of the cluster run in one process: client work
queues per shard, one :meth:`MeshPhaseKernel.slot_window` call decides a
window of slots for every shard on the device, and the decided batches
apply on every replica's state machine in slot order.

Slot semantics: a slot decides V1 (the batch applies, its future
settles) or V0 (a null slot: the batch retries in the next window). An
undecided slot (a quorum of replicas crashed) parks the shard; the
window re-runs deterministically after heal.

Three lanes:

- the per-shard queue lane (``submit``, and blocks that do not cover
  every shard): decide, then apply batch by batch, or one
  ``apply_block`` per wave when every replica is a
  :class:`~rabia_tpu_torch.core.state_machine.VectorStateMachine`;
- the full-width block lane (``submit_block`` of a block covering every
  shard with nothing queued): one window decides up to ``window``
  blocks, the next window is dispatched before this one's readback, and
  a vector state machine applies the whole window in one call;
- the device-resident KV lane (``device_store=True`` over
  ``VectorShardedKV`` replicas): the KV table lives on the device
  (:class:`~rabia_tpu_torch.apps.device_kv.DeviceKVTable`) and each
  window is decided and applied there, in one kernel launch on a card
  (the window's decision is folded into the kv-window kernel, so this
  lane makes no ``slot_window`` call). Windows pipeline
  ``device_store_inflight`` deep: window k+1 dispatches on window k's
  unresolved output table while k's 12-byte flags travel to pinned host
  memory, and futures settle when a window resolves. Work outside the
  lane's envelope, a table overflow or a fault demotes the lane: the
  table syncs into the host replicas, which own the semantics, and the
  lane re-promotes after ``device_store_repromote`` clean cycles. Each
  window's ops travel in the dictionary form where it pays (at window 16
  always), else as rows.

With ``device_read_lane=True`` the device lane also serves full-width
GET blocks off consensus: they skim out of the stream at submit, wait
behind a write barrier (every block staged before them has dispatched),
and are served by ``lookup_only`` probe windows that take no votes and
no slot, chained on the newest in-flight table and settled in FIFO order
with the writes they saw.

With ``latency_target_ms`` a governor replaces the fixed ``window``: the
wall time of each cycle that consumed a window walks ``window`` along a
power-of-two ladder within ``[min_window, max_window]`` to keep the p99
window latency under the target (:meth:`MeshEngine._govern`), and the
device lane's pipe is one window deep unless the caller asks otherwise.
``metrics`` is the engine's :class:`~rabia_tpu_torch.obs.MetricsRegistry`
(window settle latency, window size and resizes, decided slots, the
device and read lanes).

:meth:`MeshEngine.checkpoint` / :meth:`MeshEngine.restore` take and adopt
the transport engine's ``PersistedEngineState``; :meth:`MeshEngine.save_to`
/ :meth:`MeshEngine.load_from` carry it through a
:class:`~rabia_tpu_torch.core.persistence.PersistenceLayer`.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: multi-device meshes.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import replace
from typing import Callable, Optional, Sequence, Union

import numpy as np

from rabia_tpu_torch.core.device import DeviceLike, HostFetch, to_device
from rabia_tpu_torch.core.errors import RabiaError, ValidationError
from rabia_tpu_torch.core.persistence import PersistedEngineState
from rabia_tpu_torch.core.state_machine import StateMachine
from rabia_tpu_torch.core.tracing import device_annotation
from rabia_tpu_torch.core.types import ABSENT, V0, V1, CommandBatch, ShardId, quorum_size
from rabia_tpu_torch.obs import MetricsRegistry
from rabia_tpu_torch.parallel.mesh import MeshPhaseKernel

__all__ = ["MeshBlockFuture", "MeshEngine", "MeshFuture"]

logger = logging.getLogger(__name__)


class _RowSeg:
    """Value segment of a pure-SET window: version v at shard s was
    assigned by wave ``t = v - start[s] - 1``.

    ``provisional`` marks a segment whose window is in flight behind a
    data-dependent version bump (a DEL-bearing window earlier in the
    pipe): its ``start``/``end`` are placeholders until settlement
    patches them, so it is never evicted and never matches a lookup."""

    __slots__ = ("start", "end", "vlen", "vwin8", "nbytes", "provisional")

    def __init__(self, start, end, vlen, vwin) -> None:
        self.start = start
        self.end = end
        self.vlen = vlen
        self.vwin8 = vwin.view(np.uint8)
        self.nbytes = vlen.nbytes + self.vwin8.nbytes
        self.provisional = False

    def value(self, s: int, ver: int) -> Optional[bytes]:
        t = ver - int(self.start[s]) - 1
        return self.vwin8[t, s, : int(self.vlen[t, s])].tobytes()


class _DictSeg:
    """Value segment of a dictionary-form SET window: the op's value is
    the dictionary row its wave's rank names."""

    __slots__ = ("start", "end", "idx", "dvl", "dv8", "nbytes", "provisional")

    def __init__(self, start, end, idx, dvl, dv) -> None:
        self.start = start
        self.end = end
        self.idx = idx  # u8[W, S] within-shard dictionary rank
        self.dvl = dvl  # i16[S, D]
        self.dv8 = dv.view(np.uint8)  # u8[S, D, vu]
        self.nbytes = idx.nbytes + dvl.nbytes + self.dv8.nbytes
        self.provisional = False

    def value(self, s: int, ver: int) -> Optional[bytes]:
        t = ver - int(self.start[s]) - 1
        j = int(self.idx[t, s])
        return self.dv8[s, j, : int(self.dvl[s, j])].tobytes()


class _MixedSeg:
    """Value segment of a mixed window: per-(wave, shard) derived
    versions locate the SET wave by binary search (``svers`` columns are
    nondecreasing; the first wave reaching v is the SET that assigned
    it)."""

    __slots__ = ("start", "end", "vlen", "vwin8", "svers", "kind", "nbytes", "provisional")

    def __init__(self, start, end, vlen, vwin, svers, kind) -> None:
        self.start = start
        self.end = end
        self.vlen = vlen
        self.vwin8 = vwin.view(np.uint8)
        self.svers = svers
        self.kind = kind
        self.nbytes = vlen.nbytes + self.vwin8.nbytes + svers.nbytes
        self.provisional = False

    def value(self, s: int, ver: int) -> Optional[bytes]:
        col = self.svers[:, s]
        t = int(np.searchsorted(col, ver))
        if t >= len(col) or col[t] != ver or self.kind[t, s] != 1:
            return None
        return self.vwin8[t, s, : int(self.vlen[t, s])].tobytes()


class _SegResolver:
    """Snapshot (shard, version) -> value-bytes resolver for settled GET
    views: it pins the segments and seed live at settle time, so later
    evictions or re-promotions cannot change a settled response, and it
    holds no reference back to the engine."""

    __slots__ = ("segs", "seed")

    def __init__(self, segs: tuple, seed: dict) -> None:
        self.segs = segs
        self.seed = seed

    def __call__(self, s: int, ver: int) -> bytes:
        v = self.seed.get((s, ver))
        if v is not None:
            return v
        for seg in reversed(self.segs):
            if not (seg.start[s] < ver <= seg.end[s]):
                continue
            v = seg.value(s, ver)
            if v is not None:
                return v
        raise KeyError((s, ver))


def _block_op_kind(block) -> Optional[int]:
    """The uniform opcode of a one-op-per-shard block (1=SET, 2=GET,
    ...), or None when ops are mixed/absent: the device lane dispatches
    by kind; the packers re-validate everything else."""
    if len(block.cmd_sizes) == 0 or not bool((block.counts == 1).all()):
        return None
    raw = np.frombuffer(block.data, np.uint8)
    off = block.cmd_offsets[:-1]
    if len(raw) == 0 or int(off.max(initial=0)) >= len(raw):
        return None
    codes = raw[off]
    first = int(codes[0])
    return first if bool((codes == first).all()) else None


class MeshFuture:
    """Synchronously settled result holder for one submitted batch.
    ``result()`` raises if called before the batch's slot decided."""

    __slots__ = ("_value", "_done")

    def __init__(self) -> None:
        self._value = None
        self._done = False

    def _settle(self, value) -> None:
        self._value = value
        self._done = True

    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            raise RabiaError("batch not yet decided (run flush()/run_cycle())")
        if isinstance(self._value, Exception):
            raise self._value
        return self._value


class MeshBlockFuture:
    """Result holder for one submitted payload block: one entry per
    covered shard (response list, or an Exception)."""

    __slots__ = ("_results", "_pending")

    def __init__(self, k: int) -> None:
        self._results: list = [None] * k
        self._pending = k

    def _settle(self, i: int, value) -> None:
        if self._pending == 0:
            # already bulk-settled (results may be a lazy view)
            logger.debug("ignoring post-bulk settle of entry %d (%r)", i, value)
            return
        if self._results[i] is None:
            self._pending -= 1
        self._results[i] = value

    def _settle_bulk(self, results) -> None:
        """Settle every entry at once. A lazy response view (e.g.
        ``FrameGroups``) is stored as the result: per-shard response
        lists materialize when the client reads them."""
        self._results = list(results) if isinstance(results, list) else results
        self._pending = 0

    def done(self) -> bool:
        return self._pending == 0

    def result(self) -> list:
        if self._pending:
            raise RabiaError(
                f"{self._pending} block entries not yet decided (run flush()/run_cycle())"
            )
        return list(self._results)


class _Pending:
    """One queued consensus unit: a scalar batch OR one covered-shard
    slice of a submitted block (``block``/``bidx``/``bfut`` set)."""

    __slots__ = ("batch", "future", "block", "bidx", "bfut")

    def __init__(
        self,
        batch: Optional[CommandBatch],
        future: Optional[MeshFuture],
        block=None,
        bidx: int = -1,
        bfut: Optional[MeshBlockFuture] = None,
    ) -> None:
        self.batch = batch
        self.future = future
        self.block = block
        self.bidx = bidx
        self.bfut = bfut

    def materialize(self) -> CommandBatch:
        if self.batch is None:
            self.batch = self.block.materialize_batch(self.bidx)
        return self.batch

    def settle(self, value) -> None:
        if self.future is not None:
            self.future._settle(value)
        else:
            self.bfut._settle(self.bidx, value)


class MeshEngine:
    """R-replica state machine replication with consensus on the device.

    Parameters
    ----------
    sm_factory:
        Zero-arg callable producing one replica's state machine; called R
        times (replica-state equality IS the replication test).
    n_shards, n_replicas:
        Consensus geometry.
    mesh:
        Only ``None`` (one device) is supported in this port.
    device:
        Where consensus (and the device KV table) runs: CUDA unless the
        caller passes another.
    window:
        Slots decided per shard per device dispatch.
    latency_target_ms:
        When set, a governor replaces the manual window knob: measured
        per-window wall time walks ``window`` along a power-of-two
        ladder within [min_window, max_window] to keep the p99 window
        latency under the target (see :meth:`run_cycle`).
    device_store:
        Keep the KV table on the device (needs ``VectorShardedKV``
        replicas, the demotion target); ``device_store_kw`` goes to
        :class:`DeviceKVTable`.
    device_store_repromote:
        Full-width cycles between re-promotion attempts after a demotion
        (0 stays on the host path).
    device_store_inflight:
        Dispatched-but-unresolved device windows (pipe depth; default 3,
        or 1 under a latency target: each extra window delays a future's
        settlement by one more window).
    device_read_lane:
        Serve full-width GET blocks of the device lane off consensus, in
        ``lookup_only`` probe windows (zero slots). A probe read may see
        writes submitted after it that dispatched first (they are still
        unsettled, so both orders are linearizable); with a flush between
        operations its responses equal the consensus GET window's.
    """

    def __init__(
        self,
        sm_factory: Callable[[], StateMachine],
        n_shards: int,
        n_replicas: int,
        mesh=None,
        *,
        device: DeviceLike = None,
        window: int = 16,
        max_phases: int = 4,
        coin_p1: float = 0.5,
        seed: int = 0,
        max_decision_history: int = 4096,
        device_store: bool = False,
        device_store_kw: Optional[dict] = None,
        device_store_repromote: int = 64,
        device_store_inflight: Optional[int] = None,
        device_read_lane: bool = False,
        latency_target_ms: Optional[float] = None,
        min_window: int = 1,
        max_window: int = 256,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet (ROADMAP Queue 1, item 5)"
            )
        if n_shards < 1 or n_replicas < 1:
            raise ValidationError("need at least 1 shard and 1 replica")
        self.n_shards = int(n_shards)
        self.S = self.n_shards  # one device: no padding to a mesh axis
        self.R = int(n_replicas)
        self.window = int(window)
        self.max_phases = int(max_phases)
        self.kernel = MeshPhaseKernel(self.S, self.R, coin_p1=coin_p1, seed=seed, device=device)
        self.device = self.kernel.device
        self.sms: list[StateMachine] = [sm_factory() for _ in range(self.R)]
        self._vector = all(callable(getattr(sm, "apply_block", None)) for sm in self.sms)
        self.queues: list[deque[_Pending]] = [deque() for _ in range(self.n_shards)]
        self._queued_entries = 0  # total entries across self.queues
        # staged full-width blocks (the vectorized lane): only used while
        # NO per-shard entries are pending, else demoted in order
        self._full_blocks: deque = deque()
        # range-compressed decision log of full-width waves:
        # (start_slots i64[n], wave_offset, block, shard->bidx inv)
        self._bulk_log: deque = deque()
        self.next_slot = np.zeros(self.n_shards, np.int64)
        self.alive = np.ones((self.S, self.R), bool)
        # per-shard decision log: slot -> (value, batch or None); bounded
        # (insertion order is slot order, so trimming drops the oldest)
        self.max_decision_history = int(max_decision_history)
        self.decisions: list[dict[int, tuple[int, Optional[CommandBatch]]]] = [
            {} for _ in range(self.n_shards)
        ]
        self.decided_v1 = 0
        self.decided_v0 = 0
        self.divergences = 0  # replicas disagreeing on an apply outcome
        self.cycles = 0
        # latency governor (see run_cycle/_govern): auto-tunes `window`
        # against a p99 wall-time target instead of the manual knob
        if latency_target_ms is not None and latency_target_ms <= 0:
            raise ValidationError("latency_target_ms must be positive")
        self.latency_target_ms = (
            float(latency_target_ms) if latency_target_ms is not None else None
        )
        self.min_window = max(1, int(min_window))
        self.max_window = max(self.min_window, int(max_window))
        if self.latency_target_ms is not None:
            # the governor walks W within [min_window, max_window]; the
            # starting size must already be on that ladder
            self.window = min(self.max_window, max(self.min_window, self.window))
        self.window_resizes = 0
        self._lat_samples: deque[float] = deque(maxlen=64)
        # dispatch->settle wall time of resolved device windows (ms): the
        # latency a client observes through the pipelined commit (at pipe
        # depth d a window settles ~d cycles after dispatch, which
        # per-cycle samples cannot see). Collected in device mode whether
        # or not a target is set; reported via governor_stats
        self._lat_settle: deque[float] = deque(maxlen=64)
        # observability: the mesh plane's slice of the commit-pipeline
        # breakdown, a window dispatch->settle histogram plus pull gauges
        m = self.metrics = MetricsRegistry()
        self._h_window_settle = m.histogram(
            "commit_stage_seconds",
            "Device window dispatch→settle latency (the mesh plane's "
            "propose→apply span)",
            {"stage": "window_settle"},
        )
        m.gauge("mesh_window", "Current window size", fn=lambda: self.window)
        m.counter(
            "mesh_window_resizes_total", "Governor window resizes",
            fn=lambda: self.window_resizes,
        )
        m.counter(
            "engine_decided_total", "Slots decided (bulk device lane)",
            {"value": "v1"}, fn=lambda: self.decided_v1,
        )
        m.gauge(
            "mesh_device_lane_active",
            "1 while the device-resident KV lane is serving windows",
            fn=lambda: 1 if self._dev_active else 0,
        )
        self._lat_saturated = False
        # set by _govern when the target is below the measured floor at
        # min_window (no window size can meet it); see governor_stats()
        self.latency_target_unachievable = False
        self._lat_floor_ms: Optional[float] = None
        # anti-oscillation: last window size that overshot the target
        # (upsizing will not re-enter it until the ceiling ages out)
        self._lat_ceiling: Optional[int] = None
        self._lat_ceiling_age = 0
        # cycles to leave untimed: the first cycle at any window size. In
        # the reference it pays that size's jit compile; the port builds
        # nothing per size, but keeps the rule so that a governed run
        # takes the same samples (a library built or loaded on first use
        # voids its cycle through _lat_invalidate instead)
        self._lat_skip = 1
        # set by lane demotions DURING a timed cycle: that sample is void
        self._lat_invalidate = False
        self._lat_timing = False  # a governed cycle is being timed now
        # speculative next-window dispatch (full-width lane): (key, host
        # fetch) dispatched before the current window's readback, used only
        # when the engine state it assumed (depth, base slots, alive mask)
        # still holds
        self._spec: Optional[tuple[tuple, HostFetch]] = None
        self._dev = None
        self._dev_active = False
        if device_store:
            from rabia_tpu_torch.apps.device_kv import DeviceKVTable

            if not all(
                hasattr(sm, "store") and callable(getattr(sm, "apply_block", None))
                for sm in self.sms
            ):
                raise ValidationError(
                    "device_store requires VectorShardedKV replica SMs (the demotion target)"
                )
            self._dev = DeviceKVTable(self.n_shards, self.kernel, **(device_store_kw or {}))
            if any(self._dev.K > sm.store.K for sm in self.sms):
                raise ValidationError("device_store keys are wider than the replica stores' keys")
            self._dev_active = True
            # host mirror of the device shard version counters: SET
            # response versions derive from it (no per-op readback)
            self._dev_sver = np.zeros(self.S, np.int64)
            # dispatched-but-unresolved windows (flags not yet read)
            self._dev_pipe: list = []
            # in-flight windows whose version derivation is deferred to
            # settlement (a DEL bumps the shard version only when its key
            # is found; every window dispatched behind one defers too)
            self._dev_defer = 0
            # host-side value segments: every committed window's (vlen,
            # value bytes) by version range, plus a (shard, version) ->
            # bytes seed filled at re-promotion; together they resolve
            # any version a device GET returns, so GET windows download
            # found bits and versions only
            self._dev_vseg: deque = deque()
            self._dev_vseg_bytes = 0
            self._dev_vseg_cap = 64 << 20  # evictions raise _dev_floor
            self._dev_seed: dict = {}
            self._dev_seed_keys = np.empty(0, np.int64)
            # versions <= floor[s] resolve only through the seed
            self._dev_floor = np.zeros(self.S, np.int64)
        # the read lane: skimmed GET blocks wait in _read_pending as (block,
        # future, barrier), barrier being _dev_wseq at submit; a read is
        # eligible once _dev_wdisp reaches it (every write staged before
        # it has dispatched, so the chained table holds those writes)
        self._dev_read_lane = bool(device_read_lane)
        self._read_pending: deque = deque()
        self._dev_wseq = 0  # full-width blocks staged
        self._dev_wdisp = 0  # full-width blocks dispatched on the device lane
        # GET ops served off consensus (probe), GET ops that consumed slots
        # (slot), value-plane downloads (fallback; overlaps the other
        # two), probe windows dispatched
        self._read_stats = {"probe": 0, "slot": 0, "fallback": 0, "probe_windows": 0}
        for _path in ("probe", "slot", "fallback"):
            m.counter(
                "devkv_read_total",
                "Device-lane GET ops by serving path: probe = "
                "off-consensus lookup_only windows (zero slots), slot = "
                "consensus-window GETs, fallback = value-plane download "
                "events (eviction edge; overlaps the other two)",
                {"path": _path},
                fn=(lambda p=_path: self._read_stats[p]),
            )
        m.counter(
            "devkv_read_probe_windows_total",
            "Consensus-free lookup_only probe windows dispatched",
            fn=lambda: self._read_stats["probe_windows"],
        )
        self._h_read_batch = m.histogram(
            "devkv_read_batch_ops",
            "GET blocks coalesced per probe window (batching factor of "
            "the read-index lane)",
            buckets=tuple(float(1 << i) for i in range(11)),
        )
        # randomized-termination evidence: the colocated lockstep mesh
        # decides every counted slot unanimously in its first phase (a
        # theorem of the model, not a measurement), so the curve is a
        # spike at 1 sourced from the decision counter
        _phase_bounds = tuple(float(b) for b in range(1, 33))

        def _mesh_phase_curve():
            d = int(self.decided_v1)
            return [d] + [0] * 31, d, float(d)

        m.histogram(
            "phases_to_decide",
            "Weak-MVC phases per decided slot (colocated lockstep: "
            "every decided slot is unanimous, phase 1 by construction)",
            buckets=_phase_bounds,
            fn=_mesh_phase_curve,
        )
        self._dev_repromote = max(0, int(device_store_repromote))
        self._dev_cooldown = 0
        if device_store_inflight is None:
            device_store_inflight = 1 if self.latency_target_ms is not None else 3
        self._dev_inflight = max(1, int(device_store_inflight))

    # -- client surface ------------------------------------------------------

    def submit(
        self,
        commands: Union[CommandBatch, Sequence[Union[str, bytes]]],
        shard: int = 0,
    ) -> MeshFuture:
        """Queue a batch for consensus on ``shard``; settled by run_cycle."""
        if not (0 <= shard < self.n_shards):
            raise ValidationError(f"shard {shard} out of range")
        if isinstance(commands, CommandBatch):
            batch = commands
            if int(batch.shard) != shard:
                # the shard argument wins; rebind WITHOUT changing the
                # batch identity
                batch = replace(batch, shard=ShardId(shard))
        else:
            batch = CommandBatch.new(list(commands), shard=ShardId(shard))
        if self._full_blocks:
            self._demote_full_blocks()  # preserve submission order
        fut = MeshFuture()
        self.queues[shard].append(_Pending(batch, fut))
        self._queued_entries += 1
        return fut

    def submit_many(
        self, per_shard: dict[int, Sequence[Union[str, bytes]]]
    ) -> dict[int, MeshFuture]:
        """Bulk submission: one batch per shard in a single call."""
        return {s: self.submit(cmds, s) for s, cmds in per_shard.items()}

    def submit_block(self, block) -> MeshBlockFuture:
        """Block lane: one consensus slot per covered shard of a columnar
        :class:`~rabia_tpu_torch.core.blocks.PayloadBlock`. Decided
        entries apply with zero repacking: the submitted block IS the
        apply input."""
        shards = np.asarray(block.shards, np.int64)
        if len(shards) == 0:
            raise ValidationError("empty block")
        if int(shards.min()) < 0 or int(shards.max()) >= self.n_shards:
            raise ValidationError("block shard out of range")
        if len(np.unique(shards)) != len(shards):
            # a duplicate shard would corrupt slot accounting
            raise ValidationError("block shards must be unique")
        bfut = MeshBlockFuture(len(shards))
        if len(shards) == self.n_shards and self._queued_entries == 0:
            if self._dev_read_lane and self._dev_active and _block_op_kind(block) == 2:
                # the read lane: the GET never enters the consensus
                # stream; it waits behind every block staged so far
                self._read_pending.append((block, bfut, self._dev_wseq))
                return bfut
            # full-width block with nothing queued: the vectorized lane
            inv = np.empty(self.n_shards, np.int64)
            inv[shards] = np.arange(len(shards))
            self._full_blocks.append((block, bfut, inv))
            self._dev_wseq += 1
            return bfut
        if self._full_blocks:
            self._demote_full_blocks()
        for i, s in enumerate(shards.tolist()):
            self.queues[s].append(_Pending(None, None, block=block, bidx=i, bfut=bfut))
            self._queued_entries += 1
        return bfut

    # -- fault injection -----------------------------------------------------

    def crash_replica(self, r: int) -> None:
        """Mask replica ``r`` out of every shard's tally (fail-stop)."""
        self.alive[:, r] = False
        self._spec = None  # speculated under the old mask

    def heal_replica(self, r: int) -> None:
        self.alive[:, r] = True
        self._spec = None

    @property
    def has_quorum(self) -> bool:
        return int(self.alive[0].sum()) >= quorum_size(self.R)

    # -- the cycle -----------------------------------------------------------

    def run_cycle(self) -> int:
        """Decide up to ``window`` queued slots per shard in ONE device
        dispatch, then apply + settle. Returns batches applied (on the
        device lane: batches of the windows that resolved). With the read
        lane, the eligible skimmed GETs are served first, in one probe
        window.

        With ``latency_target_ms`` set, each working cycle's wall time
        feeds the window governor (see :meth:`_govern`), which walks
        ``window`` up and down a power-of-two ladder to keep the p99
        window latency under the target."""
        if self.latency_target_ms is None:
            return self._run_cycle_inner()
        self._lat_saturated = False
        self._lat_invalidate = False
        self._lat_timing = True
        cycles_before = self.cycles
        t0 = time.perf_counter()
        try:
            applied = self._run_cycle_inner()
        finally:
            self._lat_timing = False
        if self.cycles > cycles_before:
            # time only cycles that consumed a window (an idle probe
            # costs ~µs and would drown the window samples). A lane
            # demotion mid-cycle (device -> host, block -> scalar) runs
            # a second dispatch inside this one sample: one-off
            # machinery, not steady-state latency
            invalid = self._lat_invalidate
            self._lat_invalidate = False
            if self._lat_skip:
                self._lat_skip -= 1  # the first cycle at this size
            elif not invalid:
                dt_ms = (time.perf_counter() - t0) * 1e3
                self._lat_samples.append(dt_ms)
                self._govern(dt_ms)
        return applied

    def _p99(self) -> float:
        """Interpolated empirical p99 over the current samples (numpy
        linear interpolation): with n samples it sits between the two
        top order statistics, weighted toward the max only as n grows
        past ~100, so one outlier among 30 quiet samples reads as "p99
        near the second-worst", which is what a latency SLO tracks."""
        return float(np.percentile(np.asarray(self._lat_samples), 99))

    def _p99_decision(self) -> float:
        """The p99 estimate the governor acts on: one-outlier-trimmed.

        With the <=64 samples a resize decision sees, any interpolated
        p99 is dominated by the top order statistic, so one glitch would
        pin it above any target until it left the deque. At n>=8 the
        decision estimate drops the single worst sample: a lone glitch
        reads as "p99 near the second-worst", while genuine overload
        (the second-worst is also over target) still trips it one sample
        later. Reporting (:meth:`governor_stats`, :meth:`_p99`) stays
        untrimmed: the SLO view must not hide outliers."""
        a = np.asarray(self._lat_samples)
        if a.size >= 8:
            a = np.sort(a)[:-1]
        return float(np.percentile(a, 99))

    def _govern(self, dt_ms: float) -> None:
        """Latency-target window control (multiplicative ladder), rule
        for rule the reference's.

        Downsize: two >2x overshoots among the last 8 samples, or the
        trimmed p99 decision estimate (:meth:`_p99_decision`) over the
        target after 8 samples (so the one-outlier trim is engaged). A
        downsize drops one rung when the breach is shallow, and
        fast-descends straight to ``min_window`` when the trimmed p99 is
        itself >2x the target (with >=4 samples). A lone overshoot does
        not downsize: genuine overload produces a second one within a
        sample or two, a glitch does not.

        Upsize: with the trimmed p99 <= 0.7x target AND demand saturating
        the current window (a deeper window would amortize more), W
        doubles after 8 samples. Samples clear on every resize, so each
        decision is measured at the current W.

        Anti-oscillation: a downsize records the size that failed as a
        CEILING, and upsizing never re-enters a size at or above a live
        ceiling. The ceiling ages out after 256 governed samples, and is
        PROBED early when the current size shows sustained deep headroom
        (trimmed p99 <= 0.5x target over >=16 samples): the ceiling
        clears and W re-enters the evicted size; if that size cannot
        hold the target, the downsize path sets the ceiling again within
        a few samples.

        Unachievability: when W is already ``min_window`` and the
        trimmed p99 still exceeds the target, no window size can meet it
        (the floor is the dispatch, not the window's depth).
        ``latency_target_unachievable`` flips True, a warning logs once
        with the measured floor, and :meth:`governor_stats` reports it.
        It clears when the p99 at min_window comes back under target."""
        s = self._lat_samples
        t = self.latency_target_ms
        p99d = self._p99_decision()
        if self._lat_ceiling is not None:
            self._lat_ceiling_age += 1
            if self._lat_ceiling_age > 256:
                self._lat_ceiling = None
        if self.window == self.min_window and len(s) >= 8:
            if p99d > t:
                self._lat_floor_ms = p99d
                if not self.latency_target_unachievable:
                    self.latency_target_unachievable = True
                    logger.warning(
                        "latency target %.3gms is unachievable: p99 at "
                        "min_window=%d is %.3gms (dispatch floor); "
                        "governor parked",
                        t,
                        self.min_window,
                        p99d,
                    )
            elif self.latency_target_unachievable:
                self.latency_target_unachievable = False
                self._lat_floor_ms = None
        # corroboration is RECENT: two >2x overshoots among the last 8
        # samples, so a stale glitch cannot corroborate a fresh one in
        # the n<8 regime where the p99 path is still off (at n<8 an
        # untrimmed estimate IS the glitch). Two glitches within one
        # >=8-sample window do trip the p99 path: 2 of 64 samples over
        # 2x target is a >1% exceedance, a genuine p99 breach
        spikes = sum(1 for x in list(s)[-8:] if x > 2.0 * t)
        if (
            (len(s) >= 2 and spikes >= 2)
            or (len(s) >= 8 and p99d > t)
        ) and self.window > self.min_window:
            self._lat_ceiling = self.window  # this size failed
            self._lat_ceiling_age = 0
            if p99d > 2.0 * t and len(s) >= 4:
                # fast descent: overshooting by 2x even on the trimmed
                # estimate means the target is at or below the dispatch
                # floor: jump there; if the target is achievable there,
                # the upsize path climbs back with evidence
                self.window = self.min_window
            else:
                self.window = max(self.min_window, self.window // 2)
            s.clear()
            self._lat_skip = 1
            self.window_resizes += 1
        elif (
            len(s) >= 8
            and p99d <= 0.7 * t
            and self._lat_saturated
            and self.window < self.max_window
        ):
            blocked = (
                self._lat_ceiling is not None
                and self.window * 2 >= self._lat_ceiling
            )
            if blocked and len(s) >= 16 and p99d <= 0.5 * t:
                self._lat_ceiling = None  # probe the evicted size
                blocked = False
            if not blocked:
                self.window = min(self.max_window, self.window * 2)
                s.clear()
                self._lat_skip = 1
                self.window_resizes += 1

    def governor_stats(self) -> dict:
        """Observable governor state: current window, resize count, the
        p99 estimate over recent samples, and whether the configured
        target is below the measured hardware floor."""
        return {
            "window": self.window,
            "resizes": self.window_resizes,
            "samples": len(self._lat_samples),
            "p99_ms": (
                round(self._p99(), 3) if self._lat_samples else None
            ),
            # what the control loop acts on (one-outlier-trimmed; see
            # _p99_decision) — diverges from p99_ms when a lone glitch
            # is in the sample window
            "p99_decision_ms": (
                round(self._p99_decision(), 3)
                if self._lat_samples
                else None
            ),
            "target_ms": self.latency_target_ms,
            "unachievable": self.latency_target_unachievable,
            "floor_ms": (
                round(self._lat_floor_ms, 3)
                if self._lat_floor_ms is not None
                else None
            ),
            "ceiling_window": self._lat_ceiling,
            # client-observed dispatch->settle latency through the
            # pipelined commit (~inflight x window time when
            # saturated — the p99 a settle-latency SLO would see).
            # Both report None while the device lane is inactive: no
            # pipelined commit exists then, and frozen device-era
            # samples must not read as live latency
            "inflight": (
                self._dev_inflight
                if self._dev is not None and self._dev_active
                else None
            ),
            "settle_p99_ms": (
                round(
                    float(
                        np.percentile(np.asarray(self._lat_settle), 99)
                    ),
                    3,
                )
                if self._lat_settle
                and self._dev is not None
                and self._dev_active
                else None
            ),
        }

    def _run_cycle_inner(self) -> int:
        served = 0
        if (
            self._dev_active
            and self._read_pending
            and self._read_pending[0][2] <= self._dev_wdisp
        ):
            # a probe window outside the read envelope demotes in this
            # call; the flushed blocks then take the host path below
            served = self._dev_serve_reads()
        return served + self._run_cycle_body()

    def _run_cycle_body(self) -> int:
        if self._dev_active and self._dev_pipe and not self._full_blocks:
            # no new device work: resolve one in-flight window so flush
            # converges (its applied count is this cycle's progress)
            return self._dev_resolve_one()
        if self._full_blocks:
            if self._vector and self._queued_entries == 0:
                if not self._dev_active and self._dev is not None and self._dev_repromote > 0:
                    # demoted device lane: periodically try to climb back
                    # (the host stores are quiescent between cycles, so
                    # the upload captures an exact snapshot)
                    if self._dev_cooldown > 0:
                        self._dev_cooldown -= 1
                    else:
                        self._try_repromote_device_store()
                if self._dev_active:
                    return self._run_cycle_fullwidth_device()
                return self._run_cycle_fullwidth()
            self._demote_full_blocks()  # non-vector SMs materialize per batch
        if self._dev_active and self._queued_entries:
            # per-shard / scalar work is outside the device lane: hand the
            # table back to the host replicas before applying anything
            # there (an IDLE cycle must NOT demote)
            self._demote_device_store()
        W = self.window
        lens = [len(q) for q in self.queues]
        depth = np.minimum(lens, W).astype(np.int64)
        self._lat_saturated |= max(lens) >= W  # a deeper window had demand
        if not depth.any():
            return 0
        # initial votes: every live replica votes V1 for a slot whose
        # payload exists; filler entries beyond a shard's queue depth vote
        # V0 unanimously — they decide V0 in phase 0, are never recorded,
        # and their slot numbers are reused by the next cycle
        votes = np.zeros((W, self.S, self.R), np.int8)
        for s in np.nonzero(depth)[0]:
            votes[: depth[s], s, :] = V1
        decided = self._decide_window(votes, W)
        applied = 0
        # collect (pop + record) first, apply after in window-position
        # order: per-shard apply order is slot order; across shards the
        # order is wave-major, deterministic and replica-consistent, and
        # the vector path packs each wave's commits into one block
        waves: list[list[tuple[int, int, _Pending]]] = [[] for _ in range(W)]
        for s in np.nonzero(depth)[0]:
            s = int(s)
            q = self.queues[s]
            for t in range(int(depth[s])):
                v = int(decided[t, s])
                if v == ABSENT:
                    # quorum lost mid-window: park the shard; the window
                    # re-runs (deterministically) after heal
                    break
                slot = int(self.next_slot[s])
                if v == V1:
                    pend = q.popleft()
                    self._queued_entries -= 1
                    waves[t].append((s, slot, pend))
                    # block-lane entries log a lazy (block, bidx) ref;
                    # decisions_for materializes on access
                    self._record(
                        s, slot, V1,
                        pend.batch if pend.batch is not None else (pend.block, pend.bidx),
                    )
                    applied += 1
                else:
                    # null slot: batch not committed here; retries next
                    # window at a fresh slot number
                    self._record(s, slot, V0, None)
                self.next_slot[s] = slot + 1
        if self._vector:
            self._apply_waves_bulk(waves)
        else:
            self._apply_waves_scalar(waves)
        return applied

    # -- the device-resident KV lane ---------------------------------------

    def _run_cycle_fullwidth_device(self) -> int:
        """Full-width lane with the device-resident KV table: consensus
        window + every decided SET in one device dispatch; the host does
        bookkeeping only. Anything outside the lane's envelope demotes
        to the host path; the table is adopted only from a clean all-V1
        window, so demotion always re-runs from a consistent table."""
        from rabia_tpu_torch.apps.device_kv import DeviceDictOps

        W = self.window
        n = self.n_shards
        self._lat_saturated |= len(self._full_blocks) >= W
        # uniform SET runs take the lean SET program, uniform GET runs the
        # read-only lookup; a kind boundary inside the window, a block
        # mixing kinds, or DEL/EXISTS runs take the mixed program over the
        # whole window
        kinds = [
            _block_op_kind(self._full_blocks[i][0])
            for i in range(min(len(self._full_blocks), W))
        ]
        head_kind = kinds[0] if kinds else None
        depth = 0
        for k in kinds:
            if k != head_kind:
                break
            depth += 1
        if head_kind is None or depth < len(kinds) or head_kind in (3, 4):
            return self._run_cycle_fullwidth_device_mixed(len(kinds))
        if head_kind == 2:
            return self._run_cycle_fullwidth_device_get(depth)
        entries = [self._full_blocks[i] for i in range(depth)]  # peek
        ops = self._dev.pack_window_auto([e[0] for e in entries])
        if ops is None:
            # drain BEFORE demoting so in-flight windows' applied counts
            # reach the caller
            applied = self._dev_drain_pipe()
            self._demote_device_store()
            return applied + self._run_cycle_inner()
        base = np.zeros(self.S, np.int32)
        base[:n] = self.next_slot
        # PIPELINED COMMIT: dispatch window k chained on the UNRESOLVED
        # previous window's output table, advance the bookkeeping
        # optimistically, and read window k-1's flags only later; a dirty
        # flag rolls back every optimistic window and demotes
        state_base = self._dev_chain_base()
        with device_annotation("rabia.devkv.decide_apply", self.device):
            new_state, flags_dev = self._dev.decide_apply(
                self.alive, base, depth, ops, W=W,
                max_phases=self.max_phases, state=state_base,
            )
        # a library built or loaded inside this dispatch: one-off
        # machinery, not window latency
        self._lat_invalidate |= self._dev.compiled_on_last_call and self._lat_timing
        self.cycles += 1
        # version responses are DERIVED, not transferred: a clean all-V1
        # full-width SET window advances every shard's version by exactly
        # one per wave. While a DEL-bearing window is in flight the
        # mirror base is unknown: derivation defers to settlement
        deferred = self._dev_defer > 0
        if deferred:
            vers = None
            sver_delta = None
            seg_start = np.zeros_like(self._dev_sver)
            seg_end = np.zeros_like(self._dev_sver)
        else:
            vers = self._dev_sver[None, : self.S] + np.arange(1, W + 1, dtype=np.int64)[:, None]
            # retain this window's value bytes host-side: (shard,
            # version) identifies content, so GETs answer without
            # downloading values
            seg_start = self._dev_sver.copy()
            seg_end = seg_start.copy()
            seg_end[:n] += depth
        if isinstance(ops, DeviceDictOps):
            seg = _DictSeg(seg_start, seg_end, ops.idx, ops.dvl, ops.dv)
        else:
            seg = _RowSeg(seg_start, seg_end, ops.vlen, ops.vwin)
        if deferred:
            seg.provisional = True
            self._dev_defer += 1
        self._dev_push_segment(seg)
        if not deferred:
            self._dev_sver[:n] += depth
            sver_delta = np.zeros_like(self._dev_sver)
            sver_delta[:n] = depth
        self._dev_commit_window(entries, depth)
        return self._dev_push_window(
            {
                "kind": "set",
                "flags": HostFetch(flags_dev),
                "new_state": new_state,
                "entries": entries,
                "depth": depth,
                "n": n,
                "vers": vers,
                "seg": seg,
                "sver_delta": sver_delta,
                "deferred": deferred,
            }
        )

    def _dev_commit_window(self, entries, depth: int) -> None:
        """Commit bookkeeping of a full-width window, shared by every
        device window kind and the host block lane: pop the consumed
        blocks, advance the slot counters, append to the bulk decision
        log (trimmed to the retention budget)."""
        n = self.n_shards
        for _ in range(depth):
            self._full_blocks.popleft()
        self._dev_wdisp += depth  # the read lane's write barrier advances
        start = self.next_slot.copy()
        self.next_slot[:n] += depth
        self.decided_v1 += depth * n
        for t, (block, _bfut, inv) in enumerate(entries):
            self._bulk_log.append((start, t, block, inv))
        while len(self._bulk_log) > max(1, self.max_decision_history // max(1, self.window)):
            self._bulk_log.popleft()

    def _dev_chain_base(self):
        """Table a new device window dispatches against: the newest
        in-flight window's (unresolved) output, else the settled table."""
        return self._dev_pipe[-1]["new_state"] if self._dev_pipe else self._dev.state

    def _dev_push_window(self, rec) -> int:
        """Append an in-flight window record and enforce the pipe depth:
        beyond ``device_store_inflight`` windows, resolve the oldest."""
        rec["t0"] = time.perf_counter()
        self._dev_pipe.append(rec)
        if self._dev.compiled_on_last_call:
            # a library was built or loaded inside this dispatch: that
            # one-off time sat between every in-flight window's dispatch
            # and its resolve, so their settle samples are void
            for r in self._dev_pipe:
                r["lat_taint"] = True
        applied = 0
        while len(self._dev_pipe) > self._dev_inflight:
            applied += self._dev_resolve_one()
            if not self._dev_active:
                break  # a dirty window rolled the pipe back and demoted
        return applied

    def close(self) -> None:
        """Settle in-flight device windows. Idempotent; the engine stays
        usable."""
        if self._dev is not None and self._dev_active:
            self._dev_drain_pipe()

    def _dev_resolve_one(self) -> int:
        """Resolve the OLDEST in-flight device window: wait for its flags,
        then settle (clean) or roll back the whole pipe and demote
        (dirty). Returns batches applied by the resolved window."""
        rec = self._dev_pipe[0]
        if rec["kind"] == "read":
            # a probe window decided nothing and cannot be dirty; FIFO
            # resolution settled every write it chained on first
            dirty = False
        else:
            flags = rec["flags"].result()  # <= 12 bytes: the readback
            if rec["kind"] == "get":
                dirty = not int(flags)  # lookup returns the all_v1 scalar
            else:
                dirty = not flags[0] or flags[1] or flags[2]
        if dirty:
            # roll back EVERY optimistic window, newest first: the device
            # table was never adopted, so restoring the host bookkeeping
            # re-creates the pre-window world exactly; the host path then
            # re-decides the same blocks
            while self._dev_pipe:
                r = self._dev_pipe.pop()
                d, rn = r["depth"], r["n"]
                if r["kind"] == "read":
                    # a probe consumed no slot and no log entry: re-front
                    # its reads, which the demotion below flushes to the
                    # host path behind the rolled-back writes (all still
                    # unsettled, so the order is linearizable); they end
                    # up host-served, so they leave the probe count
                    self._read_stats["probe"] -= d * rn
                    self._read_stats["probe_windows"] -= 1
                    for e in reversed(r["entries"]):
                        self._read_pending.appendleft(e)
                    continue
                for _ in range(d):
                    if self._bulk_log:
                        self._bulk_log.pop()
                for e in reversed(r["entries"]):
                    self._full_blocks.appendleft(e)
                self._dev_wdisp -= d
                self.next_slot[:rn] -= d
                if r["sver_delta"] is not None:
                    self._dev_sver -= r["sver_delta"]
                if r.get("deferred"):
                    # deferred windows never advanced the mirror
                    self._dev_defer -= 1
                self.decided_v1 -= d * rn
                if r["seg"] is not None and self._dev_vseg and self._dev_vseg[-1] is r["seg"]:
                    self._dev_vseg.pop()
                    self._dev_vseg_bytes -= r["seg"].nbytes
                # (an already-evicted segment only over-raised the floor:
                # safe, the GET path falls back to downloads)
            if self._queued_entries:
                # per-batch submissions arrived while the windows were in
                # flight (submit() found _full_blocks empty). The
                # rolled-back blocks predate everything in the queues:
                # push them to the FRONT, or the host path would apply
                # out of submission order
                self._lat_invalidate |= self._lat_timing
                self._spec = None
                while self._full_blocks:
                    block, bfut, _inv = self._full_blocks.pop()
                    for i in reversed(range(len(block))):
                        s = int(block.shards[i])
                        self.queues[s].appendleft(
                            _Pending(None, None, block=block, bidx=i, bfut=bfut)
                        )
                        self._queued_entries += 1
            self._demote_device_store()
            return 0
        self._dev_pipe.pop(0)
        # dispatch->settle latency: what a client waits at the current
        # pipe depth (depth multiplies it, which is why a latency target
        # defaults to depth 1); surfaced via governor_stats
        if not rec.get("lat_taint"):
            dt = time.perf_counter() - rec["t0"]
            self._lat_settle.append(dt * 1e3)
            self._h_window_settle.observe(dt)
        # "get" windows are read-only: new_state is the table they
        # chained on, so adopting is a no-op by value
        self._dev.adopt(rec["new_state"])
        if rec["kind"] == "set":
            self._dev_settle_set(rec)
        elif rec["kind"] == "mixed":
            self._dev_settle_mixed(rec)
        else:
            self._dev_settle_get(rec)
        return rec["depth"] * rec["n"]

    def _dev_settle_set(self, rec) -> None:
        """Settle a clean pure-SET window's futures from the derived
        version responses. A deferred window (dispatched behind a
        DEL-bearing one) derives here, where the mirror is exact again,
        and patches its provisional segment."""
        from rabia_tpu_torch.apps.vector_kv import FrameGroups, VectorShardedKV

        vers = rec["vers"]
        if rec.get("deferred"):
            depth, n = rec["depth"], rec["n"]
            vers = self._dev_sver[None, : self.S] + np.arange(1, depth + 1, dtype=np.int64)[:, None]
            seg = rec["seg"]
            seg.start = self._dev_sver.copy()
            seg.end = seg.start.copy()
            seg.end[:n] += depth
            seg.provisional = False
            self._dev_evict_segments()
            self._dev_sver[:n] += depth
            self._dev_defer -= 1
        for t, (block, bfut, _inv) in enumerate(rec["entries"]):
            row = vers[t, np.asarray(block.shards, np.int64)]
            frames = VectorShardedKV._vers_frames(row)
            bounds = np.arange(len(block) + 1, dtype=np.int64)
            bfut._settle_bulk(FrameGroups(frames, bounds))

    def _dev_settle_get(self, rec) -> None:
        """Settle a clean GET window: found bits and versions came back
        with the flags; value bytes resolve from the host-side segments
        unless an eviction forces the value-plane download."""
        from rabia_tpu_torch.apps.device_kv import GetFrameGroups, ResolvedGetFrameGroups

        depth = rec["depth"]
        found, ver = rec["meta"].result()
        resolved = not self._dev_unresolvable(found[:depth], ver[:depth])
        if resolved:
            rsv = self._dev_make_resolver()
        else:
            # eviction edge: this window pays the value-plane download
            self._read_stats["fallback"] += depth * rec["n"]
            vlen, valw = HostFetch(*rec["val_dev"]).result()
        for t, (block, bfut, _inv) in enumerate(rec["entries"]):
            sh = np.asarray(block.shards, np.int64)
            if resolved:
                bfut._settle_bulk(ResolvedGetFrameGroups(sh, found[t], ver[t], rsv))
            else:
                bfut._settle_bulk(GetFrameGroups(sh, found[t], ver[t], vlen[t], valw[t]))

    def _dev_settle_mixed(self, rec) -> None:
        """Settle a clean mixed window: SET versions derive from the
        recorded per-wave cumulative counters; GET meta came back with
        the flags; GET values resolve host-side with the value planes as
        the eviction fallback.

        A DEFERRED window (DEL-bearing, or dispatched behind one) derives
        its versions here: FIFO settlement makes the mirror exact again,
        and the DEL found bits arrived with the meta plane, so the
        per-shard bump vector (SET always, DEL on found, as the host
        store does) patches the provisional segment and advances the
        mirror before any frame derives from it."""
        from rabia_tpu_torch.apps.device_kv import (
            GetFrameGroups,
            MixedFrameGroups,
            ResolvedGetFrameGroups,
        )
        from rabia_tpu_torch.apps.vector_kv import FrameGroups, VectorShardedKV

        kind = rec["kind_rows"]
        get_waves = rec["get_waves"]
        gpos = {int(t): j for j, t in enumerate(get_waves)}
        gfound_h = gver_h = gvlen_h = None
        if len(get_waves):
            meta_h = rec["meta"].result()
            gver_h = meta_h[0]
            gvlen_h = meta_h[1] >> 1
            gfound_h = (meta_h[1] & 1).astype(bool)
        if rec.get("deferred"):
            bump = (kind == 1).astype(np.int64)
            for j, t in enumerate(get_waves):
                t = int(t)
                bump[t] += ((kind[t] == 3) & gfound_h[j]).astype(np.int64)
            cum = np.cumsum(bump, axis=0)
            svers = self._dev_sver[None, : self.S] + cum
            seg = rec["seg"]
            seg.start = self._dev_sver.copy()
            seg.end = seg.start + cum[-1]
            seg.svers = svers
            seg.provisional = False
            self._dev_evict_segments()
            self._dev_sver[: self.S] += cum[-1]
            self._dev_defer -= 1
        else:
            svers = rec["svers"]
        resolved = True
        if len(get_waves):
            # resolvability concerns GET values only: EXISTS rows carry
            # found bits with version 0 (meta planes are padded: compare
            # the real rows)
            g = len(get_waves)
            is_get_rows = kind[get_waves] == 2
            resolved = not self._dev_unresolvable(gfound_h[:g] & is_get_rows, gver_h[:g])
            if resolved:
                rsv = self._dev_make_resolver()
            else:
                gval_h = HostFetch(rec["gval_dev"]).result()
        for t, (block, bfut, _inv) in enumerate(rec["entries"]):
            sh = np.asarray(block.shards, np.int64)
            row_kind = kind[t]
            gf = None
            if t in gpos:
                j = gpos[t]
                if resolved:
                    gf = ResolvedGetFrameGroups(sh, gfound_h[j], gver_h[j], rsv)
                else:
                    gf = GetFrameGroups(sh, gfound_h[j], gver_h[j], gvlen_h[j], gval_h[j])
            if gf is None:
                # pure-SET wave inside a mixed window: the lean framing
                frames = VectorShardedKV._vers_frames(svers[t, sh])
                bounds = np.arange(len(block) + 1, dtype=np.int64)
                bfut._settle_bulk(FrameGroups(frames, bounds))
            elif not bool(((row_kind == 1) | (row_kind >= 3)).any()):
                bfut._settle_bulk(gf)  # pure-GET wave (GET framing only)
            else:
                bfut._settle_bulk(MixedFrameGroups(sh, row_kind, svers[t], gf))

    def _dev_drain_pipe(self) -> int:
        """Resolve every in-flight device window."""
        applied = 0
        while self._dev_pipe and self._dev_active:
            applied += self._dev_resolve_one()
        return applied

    def _dev_serve_reads(self) -> int:
        """Serve every eligible skimmed GET (its write barrier has
        dispatched), up to a window of them, in one consensus-free
        ``lookup_only`` probe window: no votes, no slot, found bits and
        versions back, values from the host-side segments.

        The probe chains on the newest in-flight table, so a read sees
        every write dispatched before it (its barrier puts every earlier
        submission among them) and possibly writes submitted after it
        that dispatched while it waited: those are unsettled, concurrent
        invocations. The probe joins the FIFO pipe, so it settles only
        after every write it saw settled cleanly; a dirty write rolls it
        back unserved (:meth:`_dev_resolve_one`). Returns batches applied
        by windows the pipe resolved to keep its depth."""
        W = self.window
        batch = []
        while (
            self._read_pending
            and len(batch) < W
            and self._read_pending[0][2] <= self._dev_wdisp
        ):
            batch.append(self._read_pending.popleft())
        if not batch:
            return 0
        packed = self._dev.pack_get_window_auto([e[0] for e in batch])
        if packed is None:
            # outside the read envelope: put the batch back and demote;
            # the demotion hands every parked read to the host path
            for e in reversed(batch):
                self._read_pending.appendleft(e)
            applied = self._dev_drain_pipe()
            self._demote_device_store()
            return applied
        state_base = self._dev_chain_base()
        with device_annotation("rabia.devkv.read_probe", self.device):
            found_d, ver_d, vlen_d, valw_d = self._dev.lookup_only(packed, W=W, state=state_base)
        self._lat_invalidate |= self._dev.compiled_on_last_call and self._lat_timing
        self.cycles += 1
        depth = len(batch)
        n = self.n_shards
        self._read_stats["probe"] += depth * n
        self._read_stats["probe_windows"] += 1
        self._h_read_batch.observe(float(depth))
        return self._dev_push_window(
            {
                "kind": "read",
                "meta": HostFetch(found_d, ver_d),
                "val_dev": (vlen_d, valw_d),
                "new_state": state_base,  # read-only: the chained table
                "entries": batch,
                "depth": depth,
                "n": n,
                "seg": None,
                "sver_delta": None,
            }
        )

    def _run_cycle_fullwidth_device_get(self, depth: int) -> int:
        """GET-only full-width windows through the table's read-only
        lookup: consensus decides the slots and the match gathers
        (found, version, value) per op in one dispatch; no mutation, no
        version advance. Only found bits and versions come back in the
        steady state: values resolve from the host-side segments (every
        version a GET can see was packed here at SET time or seeded at
        re-promotion). Pipelined like the SET lane: the lookup chains on
        the newest in-flight window's output table."""
        W = self.window
        n = self.n_shards
        entries = [self._full_blocks[i] for i in range(depth)]
        packed = self._dev.pack_get_window_auto([e[0] for e in entries])
        if packed is None:
            applied = self._dev_drain_pipe()
            self._demote_device_store()
            return applied + self._run_cycle_inner()
        base = np.zeros(self.S, np.int32)
        base[:n] = self.next_slot
        state_base = self._dev_chain_base()
        with device_annotation("rabia.devkv.lookup_window", self.device):
            all_v1_d, found_d, ver_d, vlen_d, valw_d = self._dev.lookup_window(
                self.alive, base, depth, packed, W=W,
                max_phases=self.max_phases, state=state_base,
            )
        self._lat_invalidate |= self._dev.compiled_on_last_call and self._lat_timing
        self.cycles += 1
        self._read_stats["slot"] += depth * n  # GETs that consumed slots
        self._dev_commit_window(entries, depth)
        return self._dev_push_window(
            {
                "kind": "get",
                "flags": HostFetch(all_v1_d),
                "meta": HostFetch(found_d, ver_d),
                "val_dev": (vlen_d, valw_d),
                "new_state": state_base,  # read-only: the chained table
                "entries": entries,
                "depth": depth,
                "n": n,
                "seg": None,
                "sver_delta": None,
            }
        )

    def _run_cycle_fullwidth_device_mixed(self, count: int) -> int:
        """Full-width window mixing SET, GET, DEL and EXISTS ops (per op)
        through the kind-masked program: SETs and DELs mutate the table,
        reads see the wave-entry table, one dispatch for the window. SET
        versions derive from the host mirror + the per-shard cumulative
        SET count; GETs come back as meta only, values resolving from
        the segments (this window's SETs included). Pipelined like the
        SET lane."""
        W = self.window
        n = self.n_shards
        entries = [self._full_blocks[i] for i in range(count)]
        packed = self._dev.pack_mixed_window_auto([e[0] for e in entries])
        if packed is None:
            applied = self._dev_drain_pipe()
            self._demote_device_store()
            return applied + self._run_cycle_inner()
        # the value planes in the row form whatever form the ops travel in:
        # the segments answer GETs from them
        kind, ops, vlen_plane, vwin_plane = packed
        # a DEL bumps the shard version only when its key is FOUND: the
        # mirror cannot derive that until the meta readback (DEL waves
        # ride it). Such windows, and every window dispatched while one is
        # in flight, defer derivation to settlement, where FIFO order
        # makes the mirror exact again. EXISTS is read-only.
        deferred = bool((kind == 3).any()) or self._dev_defer > 0
        get_waves = np.nonzero((kind >= 2).any(axis=1))[0].astype(np.int32)
        base = np.zeros(self.S, np.int32)
        base[:n] = self.next_slot
        state_base = self._dev_chain_base()
        with device_annotation("rabia.devkv.mixed_apply", self.device):
            new_state, flags_dev, meta_dev, gval_dev = self._dev.mixed_apply(
                self.alive, base, count, kind, get_waves, ops, W=W,
                max_phases=self.max_phases, state=state_base,
            )
        self._lat_invalidate |= self._dev.compiled_on_last_call and self._lat_timing
        self.cycles += 1
        self._read_stats["slot"] += int((kind == 2).sum())  # GETs that consumed slots
        # derived SET versions: host mirror + inclusive per-shard SET
        # count. Deferred windows push a PROVISIONAL segment (empty range,
        # exempt from eviction) and leave the mirror untouched
        set_cum = np.cumsum(kind == 1, axis=0, dtype=np.int64)
        if deferred:
            svers = None
            sver_delta = None
            seg = _MixedSeg(
                np.zeros_like(self._dev_sver), np.zeros_like(self._dev_sver),
                vlen_plane, vwin_plane, set_cum, kind,
            )
            seg.provisional = True
            self._dev_push_segment(seg)
            self._dev_defer += 1
        else:
            svers = self._dev_sver[None, : self.S] + set_cum
            seg_start = self._dev_sver.copy()
            seg = _MixedSeg(seg_start, seg_start + set_cum[-1], vlen_plane, vwin_plane, svers,
                            kind)
            self._dev_push_segment(seg)
            sver_delta = np.zeros_like(self._dev_sver)
            sver_delta[: self.S] = set_cum[-1]
            self._dev_sver += sver_delta
        self._dev_commit_window(entries, count)
        return self._dev_push_window(
            {
                "kind": "mixed",
                "flags": HostFetch(flags_dev),
                # meta travels with the flags (a dirty window wastes one
                # small transfer); value planes stay on the device unless
                # an eviction forces the fallback at settle time
                "meta": HostFetch(meta_dev) if len(get_waves) else None,
                "gval_dev": gval_dev if len(get_waves) else None,
                "new_state": new_state,
                "entries": entries,
                "depth": count,
                "n": n,
                "kind_rows": kind,
                "svers": svers,
                "get_waves": get_waves,
                "seg": seg,
                "sver_delta": sver_delta,
                "deferred": deferred,
            }
        )

    def _dev_push_segment(self, seg) -> None:
        """Retain one committed window's value bytes. ``seg.start`` /
        ``seg.end`` bound the shard versions the window assigned
        (start[s] < v <= end[s]); eviction (byte cap) raises
        ``_dev_floor``, and the GET path downloads values for versions at
        or below it instead of mis-answering."""
        self._dev_vseg.append(seg)
        self._dev_vseg_bytes += seg.nbytes
        self._dev_evict_segments()

    def _dev_evict_segments(self) -> None:
        """Enforce the segment byte cap, oldest first. Provisional
        segments (in-flight deferred windows, contiguous at the newest
        end) are exempt; settlement re-runs this loop."""
        while (
            self._dev_vseg_bytes > self._dev_vseg_cap
            and len(self._dev_vseg) > 1
            and not self._dev_vseg[0].provisional
        ):
            old = self._dev_vseg.popleft()
            self._dev_vseg_bytes -= old.nbytes
            np.maximum(self._dev_floor, old.end, out=self._dev_floor)

    def _dev_make_resolver(self) -> _SegResolver:
        """Snapshot resolver over the current segments + seed, one per
        settled window; built only after the resolvability check."""
        return _SegResolver(tuple(self._dev_vseg), self._dev_seed)

    def _dev_resolve(self, s: int, ver: int) -> bytes:
        """Value bytes for (shard, version) against the live engine
        state (test/debug convenience; settled views carry snapshots)."""
        return self._dev_make_resolver()(s, ver)

    def _dev_unresolvable(self, found: np.ndarray, ver: np.ndarray) -> bool:
        """True when ANY found (wave, shard) op's version cannot be
        resolved host-side: the caller then downloads the value planes.
        Only versions at or below the floor consult the seed index."""
        cand = found & (ver <= self._dev_floor[None, : ver.shape[1]])
        if not bool(cand.any()):
            return False
        if len(self._dev_seed_keys) == 0:
            return True
        t_idx, s_idx = np.nonzero(cand)
        keys = (s_idx.astype(np.int64) << 32) | ver[t_idx, s_idx].astype(np.int64)
        pos = np.searchsorted(self._dev_seed_keys, keys)
        pos = np.minimum(pos, len(self._dev_seed_keys) - 1)
        return not bool(np.all(self._dev_seed_keys[pos] == keys))

    def _dev_reindex_seed(self) -> None:
        self._dev_seed_keys = np.sort(
            np.fromiter(((s << 32) | v for (s, v) in self._dev_seed), np.int64, len(self._dev_seed))
        )

    @property
    def device_lane_active(self) -> bool:
        """True while the device-resident KV lane is serving windows."""
        return self._dev_active

    def sync_to_host(self) -> None:
        """Materialize the device table into every replica's host store
        (resolving the in-flight windows first). It is a lane demotion:
        the engine re-promotes after ``device_store_repromote`` clean
        full-width cycles. A no-op on the host lane."""
        self._demote_device_store()

    def _demote_device_store(self) -> None:
        """Leave device-store mode: the device table becomes the host
        replica stores' content (rebuilt from scratch: in device mode the
        host replicas saw none of the applies)."""
        if not self._dev_active:
            return
        if self._dev_pipe:
            # the sync below must see the SETTLED table (a dirty window
            # rolls the pipe back and re-enters this method)
            self._dev_drain_pipe()
            if not self._dev_active:
                return
        # a lane switch DURING a timed cycle voids that cycle's latency
        # sample; from outside a cycle there is no sample to void
        self._lat_invalidate |= self._lat_timing
        self._dev_active = False
        # device-era settle samples must not read as live latency from
        # the host path (re-promotion starts a fresh population)
        self._lat_settle.clear()
        self._dev_cooldown = self._dev_repromote  # earn the way back
        # parked reads leave with the lane: they re-enter as full-width
        # blocks at the back of the staged stream (behind any rolled-back
        # writes; all unsettled, so the order is linearizable)
        while self._read_pending:
            block, bfut, _barrier = self._read_pending.popleft()
            inv = np.empty(self.n_shards, np.int64)
            inv[np.asarray(block.shards, np.int64)] = np.arange(len(block))
            self._full_blocks.append((block, bfut, inv))
        d = self._dev.dump()  # ONE table download for all replicas
        # the store is built once and each replica gets its own copy: the
        # reference rebuilds it a replica (one bulk insert of every entry
        # each; 0.8 s a replica at 4096 shards x 240 keys)
        store = self._dev.host_store(d)
        for i, sm in enumerate(self.sms):
            sm.store = store if i == 0 else store.clone()
        logger.info("device KV lane demoted to host stores (%d entries)", len(d["shard"]))

    def _try_repromote_device_store(self) -> None:
        """Climb back onto the device lane: rebuild the device table from
        replica 0's store and re-arm. Declines (long keys, wide values,
        per-shard overflow) re-arm the cool-down and retry later."""
        # pre-screen the WORKLOAD before paying the upload: if the next
        # window would demote again, re-promoting would thrash
        head = [self._full_blocks[0][0]] if self._full_blocks else []
        if head and self._dev.pack_mixed_window(head) is None:
            self._dev_cooldown = self._dev_repromote
            return
        seed_epoch: dict = {}
        if self._dev.upload_from(self.sms[0], seed_cache=seed_epoch):
            self._dev_seed = seed_epoch
            self._dev_sver[:] = 0
            sv = self.sms[0].store.shard_version[: self.n_shards]
            self._dev_sver[: self.n_shards] = sv
            # versions at or below the promotion snapshot resolve via the
            # seed; versions the host assigned and overwrote while demoted
            # are unreachable
            np.maximum(
                self._dev_floor[: self.n_shards], sv.astype(np.int64),
                out=self._dev_floor[: self.n_shards],
            )
            self._dev_reindex_seed()
            self._dev_active = True
            # re-arm the read lane's barrier: the staged blocks are the only
            # writes a fresh read must wait behind
            self._dev_wseq = len(self._full_blocks)
            self._dev_wdisp = 0
            self._lat_invalidate |= self._lat_timing  # upload, not latency
            logger.info("device KV lane re-promoted from host stores")
        else:
            self._dev_cooldown = self._dev_repromote

    # -- the full-width block lane (host apply) ---------------------------

    def _run_cycle_fullwidth(self) -> int:
        """The pending work is a FIFO of full-width blocks (every shard
        covered once per block) and no per-shard entries. One dispatch
        decides ``depth`` uniform waves; fault-free (all V1) the
        bookkeeping is pure numpy: slot counters advance by array add,
        the decision log records one RANGE entry per wave, and each
        block's future settles in one call. Any non-V1 outcome demotes
        the blocks to the per-shard queues."""
        W = self.window
        n = self.n_shards
        depth = min(len(self._full_blocks), W)
        self._lat_saturated |= len(self._full_blocks) >= W
        base = np.zeros(self.S, np.int32)
        base[:n] = self.next_slot
        key = (depth, base.tobytes(), self.alive.tobytes())
        if self._spec is not None and self._spec[0] == key:
            fetch = self._spec[1]  # the previous cycle already dispatched us
        else:
            fetch = self._dispatch_window(self._fullwidth_votes(depth), base, W)
        self._spec = None
        self.cycles += 1  # one CONSUMED window (discarded specs don't count)
        # dispatch the NEXT window before this one's readback: it assumes
        # this window decides all-V1, so device compute overlaps the
        # readback and the host apply below; a fault outcome discards it
        if len(self._full_blocks) > depth:
            sdepth = min(len(self._full_blocks) - depth, W)
            sbase = base.copy()
            sbase[:n] += depth
            skey = (sdepth, sbase.tobytes(), self.alive.tobytes())
            self._spec = (skey, self._dispatch_window(self._fullwidth_votes(sdepth), sbase, W))
        return self._finish_cycle_fullwidth(fetch.result(), depth)

    def _finish_cycle_fullwidth(self, decided: np.ndarray, depth: int) -> int:
        """Bookkeeping + apply for a decided full-width window."""
        n = self.n_shards
        if not bool((decided[:depth, :n] == V1).all()):
            # faults interrupted the uniform wave: re-run through the
            # general path with the SAME (deterministically re-decided)
            # votes; demotion preserves per-shard FIFO order
            self._demote_full_blocks()
            return self._run_cycle_inner()  # second dispatch; cycles counts both
        entries = [self._full_blocks[i] for i in range(depth)]
        self._dev_commit_window(entries, depth)
        if len(entries) == 1 or not self._apply_entries_multi(entries):
            for block, bfut, _inv in entries:
                self._apply_block_group(block, np.arange(len(block)), None, bulk_future=bfut)
        return depth * n

    def _fullwidth_votes(self, depth: int) -> np.ndarray:
        """Initial votes for ``depth`` uniform full-width waves."""
        votes = np.zeros((self.window, self.S, self.R), np.int8)
        votes[:depth, : self.n_shards, :] = V1
        return votes

    def _demote_full_blocks(self) -> None:
        """Move staged full-width blocks onto the per-shard queues (the
        general path's representation), preserving submission order."""
        self._lat_invalidate |= self._lat_timing  # void only mid-cycle
        self._spec = None  # speculated on the full-width lane's slots
        while self._full_blocks:
            block, bfut, _inv = self._full_blocks.popleft()
            for i, s in enumerate(block.shards.tolist()):
                self.queues[s].append(_Pending(None, None, block=block, bidx=i, bfut=bfut))
                self._queued_entries += 1

    def _decide_window(self, votes: np.ndarray, W: int) -> np.ndarray:
        """One consumed consensus window; returns decided i8[W, S]."""
        base = np.zeros(self.S, np.int32)
        base[: self.n_shards] = self.next_slot
        decided = self._dispatch_window(votes, base, W).result()
        self.cycles += 1
        return decided

    def _dispatch_window(self, votes: np.ndarray, base: np.ndarray, W: int) -> HostFetch:
        """Enqueue one slot_window dispatch and the copy of its decided
        plane to the host; returns the fetch (waited on by ``result()``),
        so a caller can dispatch the next window before reading this one.
        The caller accounts ``cycles`` when a window is CONSUMED."""
        with device_annotation("rabia.mesh.slot_window", self.device):
            decided = self.kernel.slot_window(
                to_device(votes, self.device), to_device(self.alive, self.device),
                to_device(base, self.device), n_slots=W, max_phases=self.max_phases,
            )
        return HostFetch(decided)

    def _record(self, s: int, slot: int, value: int, batch) -> None:
        d = self.decisions[s]
        d[slot] = (value, batch)
        if value == V1:
            self.decided_v1 += 1
        else:
            self.decided_v0 += 1
        while len(d) > self.max_decision_history:
            del d[next(iter(d))]  # insertion order is slot order: O(1) trim

    # -- apply ------------------------------------------------------------

    def _apply_waves_scalar(self, waves: list[list[tuple[int, int, _Pending]]]) -> None:
        for wave in waves:
            for s, slot, pend in wave:
                batch = pend.materialize()
                responses = None
                err: Optional[Exception] = None
                for i, sm in enumerate(self.sms):
                    try:
                        r = sm.apply_batch(batch)
                    except Exception as e:  # deterministic app failure
                        if i == 0:
                            err = RabiaError(f"apply failed: {e}")
                        r = None
                    if i == 0:
                        responses = r
                    elif r != responses:
                        # a committed batch MUST apply identically on every
                        # replica — a differing outcome means the state
                        # machines have diverged
                        self.divergences += 1
                        logger.error(
                            "replica %d diverged applying batch %s on shard %d slot %d: %r != %r",
                            i, batch.id.short(), s, slot, r, responses,
                        )
                pend.settle(err if err is not None else responses)

    def _apply_waves_bulk(self, waves: list[list[tuple[int, int, _Pending]]]) -> None:
        """One apply_block call per (source block, window position) per
        replica: submitted blocks apply with zero repacking; scalar
        batches are packed into a synthesized block per wave."""
        from rabia_tpu_torch.core.blocks import build_block

        for wave in waves:
            if not wave:
                continue
            # group block-sourced entries by their source block
            by_block: dict[int, list[_Pending]] = {}
            loose: list[tuple[int, int, _Pending]] = []
            for e in wave:
                p = e[2]
                if p.block is not None:
                    by_block.setdefault(id(p.block), []).append(p)
                else:
                    loose.append(e)
            for group in by_block.values():
                block = group[0].block
                idxs = np.fromiter((p.bidx for p in group), np.int64, len(group))
                self._apply_block_group(block, idxs, [p.settle for p in group])
            if not loose:
                continue
            # blocks carry >=1 command per covered shard; empty batches
            # (legal no-op commits) go through the scalar path
            bulk = [e for e in loose if len(e[2].batch.commands)]
            if len(bulk) != len(loose):
                self._apply_waves_scalar([[e for e in loose if not len(e[2].batch.commands)]])
            if not bulk:
                continue
            shards = [s for s, _slot, _p in bulk]
            cmds = [[c.data for c in p.batch.commands] for _s, _slot, p in bulk]
            try:
                block = build_block(shards, cmds)
            except Exception:
                # a batch the block codec rejects must not poison the
                # whole wave: apply it (and the rest) per batch instead
                logger.exception("bulk wave fell back to scalar apply")
                self._apply_waves_scalar([bulk])
                continue
            self._apply_block_group(
                block, np.arange(len(bulk)), [p.settle for _s, _slot, p in bulk]
            )

    def _apply_entries_multi(self, entries: list) -> bool:
        """Apply a whole full-width cycle's decided blocks with ONE
        state-machine call per replica (``apply_block_multi``). Returns
        False when the SMs lack the interface."""
        if not all(callable(getattr(sm, "apply_block_multi", None)) for sm in self.sms):
            return False
        blocks = [e[0] for e in entries]
        idxs_list = [np.arange(len(b)) for b in blocks]
        results: list = []  # per replica: result list, or the raised error
        for i, sm in enumerate(self.sms):
            try:
                results.append(sm.apply_block_multi(blocks, idxs_list, want_responses=(i == 0)))
            except Exception as e:  # deterministic app failure
                results.append(e)
        lead = results[0]
        # divergence: a follower disagreeing with replica 0 on group
        # failure, or (where per-wave outcomes exist) on any wave's
        for i, r in enumerate(results[1:], 1):
            if isinstance(r, Exception) != isinstance(lead, Exception):
                self.divergences += 1
                logger.error(
                    "replica %d %s a wave group replica 0 %s", i,
                    "rejected" if isinstance(r, Exception) else "applied",
                    "applied" if isinstance(r, Exception) else "rejected",
                )
            elif isinstance(r, list) and isinstance(lead, list):
                for j in range(len(entries)):
                    if isinstance(r[j], Exception) != isinstance(lead[j], Exception):
                        self.divergences += 1
                        logger.error("replica %d diverged on wave %d of a group", i, j)
        # settlement follows replica 0's outcomes, per wave where they exist
        for j, (block, bfut, _inv) in enumerate(entries):
            if isinstance(lead, Exception) or lead is None:
                bfut._settle_bulk([RabiaError(f"apply failed: {lead}")] * len(block))
            elif isinstance(lead[j], Exception):
                bfut._settle_bulk([RabiaError(f"apply failed: {lead[j]}")] * len(block))
            else:
                bfut._settle_bulk(lead[j])
        return True

    def _apply_block_group(
        self, block, idxs, settles, bulk_future: Optional[MeshBlockFuture] = None
    ) -> None:
        responses = None
        err: Optional[Exception] = None
        for i, sm in enumerate(self.sms):
            failed = False
            try:
                r = sm.apply_block(block, idxs, want_responses=(i == 0))
            except Exception as e:  # deterministic app failure
                failed = True
                if i == 0:
                    err = RabiaError(f"apply failed: {e}")
                elif err is None:
                    # replica 0 succeeded but a follower failed: divergence
                    self.divergences += 1
                    logger.error("replica %d failed bulk apply of block %s: %s", i, block.id, e)
                r = None
            if i == 0:
                responses = r
            elif not failed and err is not None:
                # a follower applied a wave replica 0 rejected
                self.divergences += 1
                logger.error("replica %d applied block %s that replica 0 rejected", i, block.id)
        if err is not None or responses is None:
            fail = err if err is not None else RabiaError("apply failed")
            if bulk_future is not None:
                bulk_future._settle_bulk([fail] * len(idxs))
            else:
                for settle in settles:
                    settle(fail)
        elif bulk_future is not None:
            bulk_future._settle_bulk(responses)
        else:
            for j, settle in enumerate(settles):
                settle(responses[j])

    def flush(self, max_cycles: int = 1000) -> int:
        """Run cycles until every queue drains (or quorum stalls progress).

        Returns total batches applied. Raises if ``max_cycles`` elapse with
        work still queued (quorum loss — heal a replica and call again).
        """
        total = 0
        for _ in range(max_cycles):
            if not self._has_pending():
                return total
            got = self.run_cycle()
            total += got
            if got == 0 and not self.has_quorum:
                raise RabiaError("quorum lost: flush stalled")
        if self._has_pending():
            raise RabiaError(f"flush incomplete after {max_cycles} cycles")
        return total

    def _has_pending(self) -> bool:
        return bool(
            self._queued_entries
            or self._full_blocks
            or self._read_pending
            or (self._dev is not None and self._dev_pipe)
        )

    def read_lane_stats(self) -> dict:
        """The read lane's counters as a dict: GET ops served off
        consensus (``probe``), GET ops that consumed slots (``slot``),
        value-plane downloads (``fallback``), probe windows dispatched
        (``probe_windows``)."""
        return dict(self._read_stats)

    # -- checkpoint / restore ------------------------------------------------

    def checkpoint(self) -> PersistedEngineState:
        """Durable snapshot of the committed log position + state."""
        if self._dev_active:
            self._dev_drain_pipe()  # snapshot the SETTLED table
        if self._dev_active:
            # the device table is authoritative in device mode: reflect it
            # into the host replicas so the snapshot below sees it (device
            # mode stays active; the host copies are snapshots)
            d = self._dev.dump()
            for sm in self.sms:
                self._dev.sync_into(sm, dump=d)
        return PersistedEngineState(
            current_phase=int(self.next_slot.max(initial=0)),
            last_committed_phase=int(self.next_slot.sum()),
            state_version=self.decided_v1,
            snapshot=self.sms[0].create_snapshot(),
            per_shard_phase=self.next_slot.tolist(),
            per_shard_committed=self.next_slot.tolist(),
            per_shard_version=[],
        )

    def restore(self, state: PersistedEngineState) -> None:
        """Adopt a checkpoint into a FRESH engine (empty queues): every
        replica state machine restores the snapshot; slot counters resume
        where the checkpoint left off. A device-store engine continues on
        the host path and re-promotes after the usual cool-down."""
        if self._has_pending():
            raise RabiaError("restore requires an idle engine")
        self._spec = None  # speculated on pre-restore slot counters
        # the restored snapshot supersedes the device lane, and its settle
        # samples die with it (a re-promotion starts a fresh population)
        self._dev_active = False
        self._lat_settle.clear()
        self._dev_cooldown = self._dev_repromote
        committed = np.asarray(state.per_shard_committed[: self.n_shards], np.int64)
        self.next_slot[: len(committed)] = committed
        if state.snapshot is not None:
            for sm in self.sms:
                sm.restore_snapshot(state.snapshot)
        self.decided_v1 = int(state.state_version)
        # drop any pre-restore decision history: rewound slot numbers will
        # be re-decided, and stale entries would contradict the new log
        self._bulk_log.clear()
        for d in self.decisions:
            d.clear()

    async def save_to(self, persistence) -> None:
        """Save :meth:`checkpoint` through a persistence layer
        (:mod:`rabia_tpu_torch.persistence`)."""
        await persistence.save_engine_state(self.checkpoint())

    async def load_from(self, persistence) -> bool:
        """:meth:`restore` the state a persistence layer holds; False when
        it holds none."""
        state = await persistence.load_engine_state()
        if state is None:
            return False
        self.restore(state)
        return True

    # -- introspection -------------------------------------------------------

    def decisions_for(self, shard: int) -> dict[int, tuple[int, Optional[CommandBatch]]]:
        """Committed decision log: slot -> (value, batch). ``batch`` is
        None only for V0 null slots; block-lane commits materialize their
        batch from the (log-retained) source block on access, and
        full-width waves expand from the range-compressed bulk log."""
        out: dict[int, tuple[int, Optional[CommandBatch]]] = {}
        for start, t, block, inv in self._bulk_log:
            out[int(start[shard]) + t] = (V1, block.materialize_batch(int(inv[shard])))
        for slot, (v, b) in self.decisions[shard].items():
            if isinstance(b, tuple):
                b = b[0].materialize_batch(b[1])
            out[slot] = (v, b)
        return dict(sorted(out.items()))  # iteration order = slot order

    def throughput(self, batches_per_shard: int = 4, commands_per_batch: int = 1) -> dict:
        """Measure end-to-end decisions/s (consensus + apply + futures)."""
        payload = [b"x" * 16] * commands_per_batch
        for _ in range(batches_per_shard):
            for s in range(self.n_shards):
                self.submit(payload, s)
        t0 = time.perf_counter()
        applied = self.flush()
        dt = time.perf_counter() - t0
        return {
            "applied": applied,
            "elapsed_s": dt,
            "decisions_per_sec": applied / dt if dt > 0 else float("inf"),
        }
