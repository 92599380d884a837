"""Host-side engine runtime state: buffers, slot ledger, statistics.

Reference parity: rabia-engine/src/state.rs — the shared `EngineState` with
atomic phase counters (:14-29), CAS-monotonic `commit_phase` (:65-103),
pending-batch map (:144-150), phase GC (:191-243) and `EngineStatistics`
(:268-292). The reference guards this state with atomics/DashMaps because N
tokio tasks mutate it; here the engine is a single asyncio task per node, so
plain Python structures suffice.

Layout: the per-shard *scalar* fields (slot counters, in-flight flags,
progress clocks, queue lengths, taint horizons) live in **columnar numpy
arrays** on :class:`EngineRuntime` — the engine's round loop scans them
with bulk array ops instead of per-shard Python iteration, which is what
lets one host process drive thousands of concurrent consensus shards
(SURVEY.md §7.4.4). :class:`ShardRuntime` exposes the same fields as
attribute views into the arrays, so event-path code (and tests) read/write
them per shard exactly as before. Irregular per-slot state (batch payloads,
decision records, response futures) stays in per-shard dicts — touched only
on events, never in round scans.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from rabia_tpu_torch.core.types import BatchId, CommandBatch, NodeId, StateValue


@dataclass
class EngineStatistics:
    """Pull-based stats snapshot (state.rs:268-292)."""

    node_id: NodeId
    current_slot_max: int = 0  # highest slot any shard has opened
    committed_slots: int = 0  # total applied slots across shards
    decided_v1: int = 0
    decided_v0: int = 0
    pending_batches: int = 0
    active_nodes: int = 0
    has_quorum: bool = False
    state_version: int = 0
    is_active: bool = True
    decisions_total: int = 0

    @property
    def last_committed_phase(self) -> int:
        return self.committed_slots


@dataclass
class SlotRecord:
    """Decision ledger entry for one (shard, slot)."""

    value: StateValue
    batch_id: Optional[BatchId] = None
    decided_at: float = field(default_factory=time.time)
    applied: bool = False


@dataclass
class PendingSubmission:
    """An accepted client batch waiting to be proposed/committed."""

    batch: CommandBatch
    future: Optional[asyncio.Future] = None
    attempts: int = 0
    submitted_at: float = field(default_factory=time.time)
    forwarded_at: float = 0.0  # last NewBatch forward to a remote proposer
    first_forwarded_at: float = 0.0  # first forward for the CURRENT slot


class _TrackedQueue(deque):
    """Per-shard submission queue that mirrors its length into the
    runtime's columnar ``queue_len`` array (and resets the head-forward
    clock cache when the head changes), so round scans never touch the
    deques."""

    __slots__ = ("_rt", "_s")

    def __init__(self, rt: "EngineRuntime", shard: int):
        super().__init__()
        self._rt = rt
        self._s = shard

    def _sync(self) -> None:
        self._rt.queue_len[self._s] = len(self)
        self._rt.head_fwd_at[self._s] = 0.0

    def append(self, item) -> None:
        super().append(item)
        self._sync()

    def appendleft(self, item) -> None:
        super().appendleft(item)
        self._sync()

    def popleft(self):
        item = super().popleft()
        self._sync()
        return item

    def pop(self):
        item = super().pop()
        self._sync()
        return item

    def __delitem__(self, i) -> None:
        super().__delitem__(i)
        self._sync()

    def remove(self, item) -> None:
        super().remove(item)
        self._sync()

    def clear(self) -> None:
        super().clear()
        self._sync()


class _FlagDict(dict):
    """Dict that mirrors its non-emptiness into a columnar bool array, so
    round scans can ask "any shard with a buffered X?" in one array op."""

    __slots__ = ("_flags", "_s")

    def __init__(self, flags: np.ndarray, shard: int):
        super().__init__()
        self._flags = flags
        self._s = shard

    def _sync(self) -> None:
        self._flags[self._s] = bool(self)

    def __setitem__(self, k, v) -> None:
        super().__setitem__(k, v)
        self._flags[self._s] = True

    def setdefault(self, k, default=None):
        r = super().setdefault(k, default)
        self._flags[self._s] = True
        return r

    def __delitem__(self, k) -> None:
        super().__delitem__(k)
        self._sync()

    def pop(self, *a):
        r = super().pop(*a)
        self._sync()
        return r

    def clear(self) -> None:
        super().clear()
        self._sync()

    def update(self, *a, **kw) -> None:
        super().update(*a, **kw)
        self._sync()


def _col_property(name: str):
    """An attribute view into EngineRuntime's columnar array ``name``."""

    def fget(self):
        return self._rt_arrays[name][self.shard].item()

    def fset(self, value):
        self._rt_arrays[name][self.shard] = value

    return property(fget, fset)


class ShardRuntime:
    """Per-shard host bookkeeping around the device arrays.

    Scalar fields are views into :class:`EngineRuntime`'s columnar arrays
    (see module doc); dict fields hold irregular per-slot state.
    """

    __slots__ = (
        "shard",
        "_rt_arrays",
        "queue",
        "payloads",
        "applied_ids",
        "applied_results",
        "alias_subs",
        "alias_ledger",
        "block_waiters",
        "decisions",
        "buf_decision",
        "buf_propose",
    )

    def __init__(self, shard: int, rt: "EngineRuntime") -> None:
        self.shard = shard
        self._rt_arrays = rt.columns
        self.queue: _TrackedQueue = _TrackedQueue(rt, shard)
        # payloads keyed by batch id (immutable content per id), so a late
        # re-Propose can never swap the bytes a decided slot will apply
        self.payloads: dict[BatchId, CommandBatch] = {}
        # dedup ledger: EVERY batch id ever applied on this shard (ordered
        # set; evicted only beyond a deep horizon in engine._gc) — consulted
        # by the apply path so one batch can never execute twice even if it
        # commits in two slots (duplicate forwarding race)
        self.applied_ids: dict[BatchId, None] = {}
        # bounded response cache for applied batches (None = applied via
        # snapshot sync, responses unavailable); separate from the dedup
        # ledger so evicting a cached response can never re-enable a
        # duplicate apply
        self.applied_results: dict[BatchId, Optional[list[bytes]]] = {}
        # coalescing lane: alias triples of demoted multi-client entries
        # queued on the scalar lane, keyed by the entry's lead batch id
        # (the apply path pops them here instead of scanning the queue
        # when the payload binding adopted a wire copy; bounded by the
        # applied_results eviction in engine._gc)
        self.alias_subs: dict[BatchId, tuple] = {}
        # coalescing lane: PROPOSER-LOCAL dedup ids of covered clients
        # (alias batch ids), valued with the client's op COUNT when
        # registered live (None after crash recovery — K_LEDGER records
        # carry no op ranges). Consulted ONLY by the gateway's pre-drive
        # replay check — NEVER by the apply-path dedup: applied_ids
        # must stay symmetric across replicas (every replica inserts
        # the same ids from the same wire-visible facts), because an
        # apply-time dedup-skip on one replica that its peers don't
        # take would diverge replica state permanently.
        self.alias_ledger: dict[BatchId, Optional[int]] = {}
        # block entries decided V1 above an earlier slot still waiting to
        # apply (its payload not here yet): batch id -> (slot, outcome,
        # entry index). The scalar lane applies them in order and settles
        # the proposer's outcome with their responses
        # (RabiaEngine._settle_block_waiter)
        self.block_waiters: dict[BatchId, tuple] = {}
        self.decisions: dict[int, SlotRecord] = {}
        # decision notices not yet consumed: slot -> (value_code, batch_id)
        self.buf_decision: _FlagDict = _FlagDict(rt.dec_flag, shard)
        # proposals seen for slots not yet opened: slot -> (batch_id, batch)
        self.buf_propose: _FlagDict = _FlagDict(rt.prop_flag, shard)

    # columnar scalar views (same names/semantics as the round-1 fields)
    next_slot = _col_property("next_slot")
    applied_upto = _col_property("applied_upto")
    in_flight = _col_property("in_flight")
    opened_at = _col_property("opened_at")
    last_progress = _col_property("last_progress")
    tainted_upto = _col_property("tainted_upto")

    @property
    def taint_traffic(self) -> bool:
        """Whether tainted-slot vote traffic has ever been observed (the
        column stores the LAST-seen timestamp; release logic windows it)."""
        return bool(self._rt_arrays["taint_traffic"][self.shard] > 0)

    @taint_traffic.setter
    def taint_traffic(self, value) -> None:
        self._rt_arrays["taint_traffic"][self.shard] = (
            time.time() if value else 0.0
        )

    def gc_upto(self, slot: int) -> None:
        """Drop buffered state for every slot < `slot` (state.rs:191-243
        phase-GC analog; payloads/decisions for applied slots are kept only
        until applied)."""
        for d2 in (self.buf_decision, self.buf_propose):
            stale = [k for k in d2 if k < slot]
            for k in stale:
                del d2[k]
        # payloads for already-applied batches are no longer needed
        for bid in [b for b in self.payloads if b in self.applied_ids]:
            del self.payloads[bid]

    def pending_count(self) -> int:
        return len(self.queue)


class EngineRuntime:
    """All shards' host state plus cluster-level counters.

    The columnar arrays are the authoritative store for per-shard scalars;
    ``shards[s]`` exposes them as attributes.
    """

    DEC_RING = 64  # decided-value ring depth (power of two)

    def __init__(self, n_shards: int) -> None:
        S = n_shards
        self.n = S
        self.next_slot = np.zeros(S, np.int64)
        self.applied_upto = np.zeros(S, np.int64)
        self.in_flight = np.zeros(S, bool)
        self.opened_at = np.zeros(S, np.float64)
        self.last_progress = np.zeros(S, np.float64)
        self.tainted_upto = np.zeros(S, np.int64)
        # LAST time vote traffic for a tainted slot was observed (0 =
        # never). The taint-release check uses a sliding quiet WINDOW, not
        # a latch: in-flight peers retransmit every phase_timeout, so a
        # full release window with no traffic proves nobody live holds our
        # pre-crash votes — a sticky flag would deadlock a shard whose
        # rotation parks on the restored (taint-blocked) proposer
        self.taint_traffic = np.zeros(S, np.float64)
        # V1 batches APPLIED per shard (null/V0 slots excluded): the unit
        # of state_version, kept per shard so partial sync adoption can
        # advance the version by exactly the responder's surplus
        self.v1_applied = np.zeros(S, np.int64)
        self.queue_len = np.zeros(S, np.int64)
        # scan caches (not authoritative): highest slot with foreign vote
        # traffic per shard; head-of-queue last-forward clock
        self.votes_seen_slot = np.full(S, -1, np.int64)
        self.head_fwd_at = np.zeros(S, np.float64)
        # buffered propose/decision non-emptiness flags (_FlagDict mirrors)
        self.prop_flag = np.zeros(S, bool)
        self.dec_flag = np.zeros(S, bool)
        # compact decided-value ring (last DEC_RING slots per shard): the
        # targeted stale-vote repair answers from here even for bulk-lane
        # slots that never materialize SlotRecords
        self.dec_ring_val = np.zeros((S, self.DEC_RING), np.int8)
        self.dec_ring_slot = np.full((S, self.DEC_RING), -1, np.int64)
        self.columns = {
            "next_slot": self.next_slot,
            "applied_upto": self.applied_upto,
            "in_flight": self.in_flight,
            "opened_at": self.opened_at,
            "last_progress": self.last_progress,
            "tainted_upto": self.tainted_upto,
            "taint_traffic": self.taint_traffic,
            "v1_applied": self.v1_applied,
        }
        self.shards = [ShardRuntime(s, self) for s in range(S)]
        self.active_nodes: set[NodeId] = set()
        self.has_quorum: bool = False
        self.is_active: bool = True
        self.state_version: int = 0
        self.decided_v1: int = 0
        self.decided_v0: int = 0
        # in-flight sync: responses collected by sender
        self.sync_responses: dict[NodeId, tuple] = {}
        self.sync_started_at: Optional[float] = None
        self.last_apply_time: float = time.time()  # any shard's last apply

    def stats(self, node_id: NodeId) -> EngineStatistics:
        return EngineStatistics(
            node_id=node_id,
            current_slot_max=int(self.next_slot.max(initial=0)),
            committed_slots=int(self.applied_upto.sum()),
            decided_v1=self.decided_v1,
            decided_v0=self.decided_v0,
            pending_batches=int(self.queue_len.sum()),
            active_nodes=len(self.active_nodes),
            has_quorum=self.has_quorum,
            state_version=self.state_version,
            is_active=self.is_active,
            decisions_total=self.decided_v0 + self.decided_v1,
        )
