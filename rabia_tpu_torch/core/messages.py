"""Protocol message schema and the per-phase vote ledger.

Reference parity: rabia-core/src/messages.rs — the ``ProtocolMessage``
envelope (:6-56), the 9-variant message enum (:58-69), payloads (:71-136),
``PhaseData`` with its majority tally (:138-223) and ``PendingBatch``
(:225-257).

TPU-native twist: vote messages carry **vectors of votes over the shard
axis** (``shards: array of shard indices``, ``votes: int8 per shard``), not
one scalar vote — a replica exchanges its whole per-phase vote vector with a
peer in a single message. The scalar case is a length-1 vector. ``PhaseData``
remains the host-side ledger for shards handled off-device; the batched tally
lives in :mod:`rabia_tpu_torch.kernel.phase_driver`.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from rabia_tpu_torch.core.blocks import PayloadBlock
from rabia_tpu_torch.core.types import (
    BatchId,
    CommandBatch,
    NodeId,
    PhaseId,
    StateValue,
    fast_uuid4,
    quorum_size,
)


class MessageType(enum.IntEnum):
    """Wire discriminants (order stable — used by the binary codec)."""

    Propose = 1
    VoteRound1 = 2
    VoteRound2 = 3
    Decision = 4
    SyncRequest = 5
    SyncResponse = 6
    NewBatch = 7
    HeartBeat = 8
    QuorumNotification = 9
    ProposeBlock = 10
    # client gateway protocol (rabia_tpu_torch/gateway): the client-facing
    # frame kinds ride the same envelope + transport framing as the
    # replica-to-replica traffic but never enter the consensus engine —
    # the gateway runs its own transport instance
    ClientHello = 11
    Submit = 12
    Result = 13
    ReadIndex = 14
    # observability admin frames (rabia_tpu_torch/obs): served by the gateway
    # on its native transport — /metrics, /healthz and the anomaly
    # journal as framed request/response, for ops tooling that already
    # speaks the transport (`python -m rabia_tpu_torch stats <addr>`). HTTP
    # scrapers use the stdlib shim instead (obs/http.py).
    AdminRequest = 15
    AdminResponse = 16


# ---------------------------------------------------------------------------
# Payloads (one dataclass per MessageType)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VoteEntry:
    """One (shard, phase, vote) triple inside a vote vector."""

    shard: int
    phase: int
    vote: StateValue


@dataclass(frozen=True)
class Propose:
    """Proposer announces a batch for a shard's next phase.

    Reference: messages.rs:71-82 ProposeMessage{phase_id, batch_id, value,
    batch}; here additionally scoped to a shard.
    """

    shard: int
    phase: int
    batch_id: BatchId
    value: StateValue
    batch: Optional[CommandBatch] = None


class _VoteVector:
    """Array-backed vote vector over the shard axis.

    The TPU-native hot-path representation: three parallel numpy arrays
    (``shards`` i64, ``phases`` i64 packed (slot<<16)|mvc, ``vals`` i8),
    ingested and emitted by the engine with bulk array ops — no per-entry
    Python objects on the wire path. ``votes`` (tuple of
    :class:`VoteEntry`) remains as the convenience/compat view and
    constructor; the wire format is unchanged either way.
    """

    __slots__ = ("shards", "phases", "vals")

    def __init__(
        self,
        votes: Optional[Sequence[VoteEntry]] = None,
        *,
        shards=None,
        phases=None,
        vals=None,
    ) -> None:
        if votes is not None:
            n = len(votes)
            self.shards = np.fromiter((e.shard for e in votes), np.int64, count=n)
            self.phases = np.fromiter(
                (int(e.phase) for e in votes), np.int64, count=n
            )
            self.vals = np.fromiter((int(e.vote) for e in votes), np.int8, count=n)
        else:
            self.shards = np.asarray(shards, np.int64)
            self.phases = np.asarray(phases, np.int64)
            self.vals = np.asarray(vals, np.int8)
        if not (len(self.shards) == len(self.phases) == len(self.vals)):
            raise ValueError("vote vector arrays must have equal length")

    def __len__(self) -> int:
        return len(self.shards)

    @property
    def votes(self) -> tuple[VoteEntry, ...]:
        return tuple(
            VoteEntry(int(s), int(p), StateValue(int(v)))
            for s, p, v in zip(self.shards, self.phases, self.vals)
        )

    def __eq__(self, other) -> bool:
        return (
            type(other) is type(self)
            and np.array_equal(self.shards, other.shards)
            and np.array_equal(self.phases, other.phases)
            and np.array_equal(self.vals, other.vals)
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}(n={len(self)})"


class VoteRound1(_VoteVector):
    """Round-1 vote vector. Unlike the reference (which unicasts R1 votes to
    the proposer only — engine.rs:418-419, a documented protocol deviation,
    SURVEY.md §3.1), round-1 votes are **broadcast** per the Ivy spec."""


class VoteRound2(_VoteVector):
    """Round-2 vote vector (broadcast)."""


@dataclass(frozen=True)
class DecisionEntry:
    shard: int
    phase: int
    decision: StateValue
    batch_id: Optional[BatchId] = None


class Decision:
    """Decision notifications (messages.rs:100-106), vectorized per shard.

    Array-backed like :class:`_VoteVector`; ``bids`` is a parallel list of
    ``Optional[BatchId]`` (or None for "no entry carries a batch id" — the
    common follower case).
    """

    __slots__ = ("shards", "phases", "vals", "bids")

    def __init__(
        self,
        decisions: Optional[Sequence[DecisionEntry]] = None,
        *,
        shards=None,
        phases=None,
        vals=None,
        bids: Optional[list] = None,
    ) -> None:
        if decisions is not None:
            n = len(decisions)
            self.shards = np.fromiter((e.shard for e in decisions), np.int64, count=n)
            self.phases = np.fromiter(
                (int(e.phase) for e in decisions), np.int64, count=n
            )
            self.vals = np.fromiter(
                (int(e.decision) for e in decisions), np.int8, count=n
            )
            bid_list = [e.batch_id for e in decisions]
            self.bids = bid_list if any(b is not None for b in bid_list) else None
        else:
            self.shards = np.asarray(shards, np.int64)
            self.phases = np.asarray(phases, np.int64)
            self.vals = np.asarray(vals, np.int8)
            self.bids = bids
        if self.bids is not None:
            if len(self.bids) != len(self.shards):
                raise ValueError("bids must parallel the decision arrays")
            if not any(b is not None for b in self.bids):
                self.bids = None

    def __len__(self) -> int:
        return len(self.shards)

    def bid_at(self, i: int) -> Optional[BatchId]:
        return self.bids[i] if self.bids is not None else None

    @property
    def decisions(self) -> tuple[DecisionEntry, ...]:
        return tuple(
            DecisionEntry(
                int(s), int(p), StateValue(int(v)), self.bid_at(i)
            )
            for i, (s, p, v) in enumerate(
                zip(self.shards, self.phases, self.vals)
            )
        )

    def __eq__(self, other) -> bool:
        return (
            type(other) is type(self)
            and np.array_equal(self.shards, other.shards)
            and np.array_equal(self.phases, other.phases)
            and np.array_equal(self.vals, other.vals)
            and self.bids == other.bids
        )

    def __repr__(self) -> str:
        return f"Decision(n={len(self)})"


@dataclass(frozen=True, eq=False)
class ProposeBlock:
    """One proposer's whole cycle of proposals, columnar (bulk lane).

    ``block`` covers k shards with assigned slots; the proposer of every
    (shard, slot) in it must be the sender (receivers verify with
    ``slot_proposer_vec``). See :mod:`rabia_tpu_torch.core.blocks`.
    """

    block: PayloadBlock

    def __eq__(self, other) -> bool:
        if type(other) is not ProposeBlock:
            return False
        a, b = self.block, other.block
        return (
            a.id == b.id
            and np.array_equal(a.shards, b.shards)
            and np.array_equal(a.slots, b.slots)
            and np.array_equal(a.counts, b.counts)
            and np.array_equal(a.cmd_sizes, b.cmd_sizes)
            and a.data == b.data
        )


@dataclass(frozen=True)
class SyncRequest:
    """Lagging node asks peers for state (messages.rs:108-112)."""

    current_phase: int
    state_version: int


@dataclass(frozen=True)
class SyncResponse:
    """Peer replies with snapshot if ahead (messages.rs:114-121).

    ``applied_ids`` carries recently applied (shard, batch_id) pairs so a
    syncing node inherits the duplicate-commit dedup ledger along with the
    snapshot — without it, a batch that commits in two slots (duplicate
    forwarding race) could be applied once pre-sync via the snapshot and
    again post-sync by the restored node.
    """

    responder_phase: int
    state_version: int
    snapshot: Optional[bytes] = None
    per_shard_phase: tuple[int, ...] = ()
    applied_ids: tuple[tuple[int, BatchId], ...] = ()
    # per-shard count of V1-APPLIED batches (the unit of state_version):
    # partial per-shard adoption advances the adopter's version by exactly
    # the responder's surplus on the adopted shards — adopting the global
    # version (or counting null slots) would make versions incomparable
    per_shard_version: tuple[int, ...] = ()


@dataclass(frozen=True)
class NewBatch:
    """Batch payload dissemination ahead of/alongside a proposal."""

    shard: int
    batch: CommandBatch


@dataclass(frozen=True)
class HeartBeat:
    """Liveness + progress beacon (messages.rs:125-130)."""

    current_phase: int
    committed_phase: int


@dataclass(frozen=True)
class QuorumNotification:
    """Quorum lost/restored announcement (messages.rs:132-136)."""

    has_quorum: bool
    active_nodes: tuple[NodeId, ...]


# ---------------------------------------------------------------------------
# Client gateway protocol (rabia_tpu_torch/gateway)
# ---------------------------------------------------------------------------
#
# Clients talk to a per-replica gateway over the native transport with
# these four frame kinds. Every command carries a (client_id, seq) pair:
# the session table dedups retries so a command applies exactly once no
# matter how many times the client (re)submits it.


class ResultStatus(enum.IntEnum):
    """Outcome discriminant of a :class:`Result` frame."""

    OK = 0  # committed; payload = per-command responses
    ERROR = 1  # terminal failure; payload = (message,)
    RETRY = 2  # admission control shed the request; safe to resubmit
    CACHED = 3  # duplicate (client_id, seq): answered from session cache
    # routed-fleet redirect (docs/FLEET.md): this gateway does not own
    # the shard — payload = (b"host:port", 16-byte owner node id). The
    # client re-sends the SAME seq to the named owner; exactly-once is
    # preserved because nothing was proposed or reserved here.
    MOVED = 4


class ReadIndexMode(enum.IntEnum):
    """Role discriminant of a :class:`ReadIndex` frame."""

    READ = 0  # client -> gateway: linearizable GET
    PROBE = 1  # gateway -> gateway: decided-frontier probe
    REPLY = 2  # gateway -> gateway: probe reply with frontier vector
    # gateway -> gateway: fetch a committed batch's applied responses
    # (result repair after a snapshot sync skipped the local apply;
    # ``key`` carries the 16-byte batch id, ``shard`` the shard)
    FETCH_RESULT = 3


@dataclass(frozen=True)
class ClientHello:
    """Session open/resume (client -> gateway) and its ack (``ack=True``,
    gateway -> client).

    ``last_seq``: from the client, the highest seq it already holds a
    result for; from the gateway, the session's highest completed seq
    (the client replays everything above it). ``max_inflight``: the
    client's requested window, and the gateway's granted one in the ack.
    """

    client_id: uuid.UUID
    ack: bool = False
    last_seq: int = 0
    max_inflight: int = 0


@dataclass(frozen=True)
class Submit:
    """One client command batch, exactly-once keyed by (client_id, seq).

    ``ack_upto``: the client has durably received results for every seq
    <= this value — the gateway's session GC hint (results at or below
    it become evictable once the decided frontier moves past them).
    """

    client_id: uuid.UUID
    seq: int
    shard: int
    commands: tuple[bytes, ...]
    ack_upto: int = 0


@dataclass(frozen=True)
class Result:
    """Gateway -> client outcome for a Submit or ReadIndex seq."""

    client_id: uuid.UUID
    seq: int
    status: int
    payload: tuple[bytes, ...] = ()


@dataclass(frozen=True)
class ReadIndex:
    """Linearizable read traffic (see :class:`ReadIndexMode`).

    READ: ``(shard, key)`` names the lookup; ``seq`` routes the Result.
    PROBE: ``seq`` is the probe nonce (client_id = the asking gateway).
    REPLY: ``frontier`` is the responder's per-shard potential decided
    frontier — for every slot that could have committed anywhere at
    probe time, at least one member of any probed quorum reports a
    frontier above it (it voted round-2 in that slot or decided it).
    """

    mode: int
    client_id: uuid.UUID
    seq: int
    shard: int = 0
    key: bytes = b""
    frontier: tuple[int, ...] = ()


class AdminKind(enum.IntEnum):
    """What an :class:`AdminRequest` asks for."""

    METRICS = 0  # Prometheus text exposition
    HEALTH = 1  # JSON health document
    JOURNAL = 2  # JSON anomaly journal; query filters {"kind","last"}
    # flight-recorder TraceQuery -> TraceSlice: query names a batch via
    # its session coordinates ({"client": hex, "seq": N} — batch ids
    # derive deterministically from them, so no new wire fields) or
    # directly ({"batch": hex}); the response body is the replica's
    # flight-ring slice for that batch (obs/flight.build_trace_slice)
    TRACE = 3
    # per-second telemetry ring (obs/telemetry.TelemetrySampler): query
    # {"last": N} bounds the reply; the body carries timestamped registry
    # snapshots plus the serve-time (wall, mono_ns) pair the collector
    # clock-aligns with (`python -m rabia_tpu_torch timeline`)
    TIMELINE = 4
    # routed gateway fleet (docs/FLEET.md). RING: query {"op": "get"}
    # returns the gateway's live hash-ring view + session counts;
    # {"op": "set", "ring": doc} installs a new membership view and
    # triggers session handoff for shards that moved away. HANDOFF:
    # query = binary session-transfer blob (fleet/handoff.py); the new
    # owner imports the sessions and acks with the imported count.
    # LEDGER: query = binary completed-result records (fleet/ledger.py)
    # replicated to the shard's gateway group so a gateway failover
    # preserves exactly-once replay without waiting out session leases.
    RING = 5
    HANDOFF = 6
    LEDGER = 7
    # tail-exemplar slowlog (obs/critpath.py): the replica gateway's
    # reservoir of the slowest fresh-Submit completions per rotation
    # window (batch id + wall time + outcome), so p99 capture needs no
    # operator foreknowledge of batch ids. Query {"last": N} bounds the
    # reply; the body carries the exemplar documents plus serve-time
    # (wall, mono_ns) for clock alignment (`python -m rabia_tpu_torch slowlog`)
    SLOWLOG = 8


@dataclass(frozen=True)
class AdminRequest:
    """Ops tooling -> gateway: fetch one admin document (read-only).

    ``query`` is a kind-specific parameter blob (JSON by convention;
    empty = no filters). Added for JOURNAL filters and the TRACE
    exchange; decoders accept its absence for wire compatibility with
    pre-trace frames.
    """

    kind: int
    nonce: int = 0
    query: bytes = b""


@dataclass(frozen=True)
class AdminResponse:
    """Gateway -> ops tooling: the requested document.

    ``status`` 0 = ok, nonzero = error (``body`` carries a diagnostic).
    ``body`` is Prometheus text for METRICS, JSON bytes otherwise.
    """

    nonce: int
    status: int
    body: bytes = b""


Payload = (
    Propose
    | VoteRound1
    | VoteRound2
    | Decision
    | SyncRequest
    | SyncResponse
    | NewBatch
    | HeartBeat
    | QuorumNotification
    | ProposeBlock
    | ClientHello
    | Submit
    | Result
    | ReadIndex
    | AdminRequest
    | AdminResponse
)

_PAYLOAD_TYPE = {
    Propose: MessageType.Propose,
    VoteRound1: MessageType.VoteRound1,
    VoteRound2: MessageType.VoteRound2,
    Decision: MessageType.Decision,
    SyncRequest: MessageType.SyncRequest,
    SyncResponse: MessageType.SyncResponse,
    NewBatch: MessageType.NewBatch,
    HeartBeat: MessageType.HeartBeat,
    QuorumNotification: MessageType.QuorumNotification,
    ProposeBlock: MessageType.ProposeBlock,
    ClientHello: MessageType.ClientHello,
    Submit: MessageType.Submit,
    Result: MessageType.Result,
    ReadIndex: MessageType.ReadIndex,
    AdminRequest: MessageType.AdminRequest,
    AdminResponse: MessageType.AdminResponse,
}


@dataclass(frozen=True)
class ProtocolMessage:
    """Envelope: id, from, optional to (None = broadcast), timestamp, payload.

    Reference: messages.rs:6-56.
    """

    id: uuid.UUID
    sender: NodeId
    recipient: Optional[NodeId]  # None = broadcast
    timestamp: float
    payload: Payload

    @staticmethod
    def new(
        sender: NodeId, payload: Payload, recipient: Optional[NodeId] = None
    ) -> "ProtocolMessage":
        return ProtocolMessage(
            id=fast_uuid4(),
            sender=sender,
            recipient=recipient,
            timestamp=time.time(),
            payload=payload,
        )

    @property
    def message_type(self) -> MessageType:
        return _PAYLOAD_TYPE[type(self.payload)]

    def is_broadcast(self) -> bool:
        return self.recipient is None


# ---------------------------------------------------------------------------
# Host-side vote ledger (for the scalar/oracle path and engine bookkeeping)
# ---------------------------------------------------------------------------


@dataclass
class PhaseData:
    """Vote ledger for one (shard, phase) consensus step.

    Reference: messages.rs:138-223 — holds per-node R1/R2 votes, the batch
    binding, and the majority tally (``count_votes`` :185-211, ``set_decision``
    :217-222). The kernel's batched tally is the vectorized form of this.
    """

    phase: PhaseId
    batch_id: Optional[BatchId] = None
    proposed_value: Optional[StateValue] = None
    round1_votes: dict[NodeId, StateValue] = field(default_factory=dict)
    round2_votes: dict[NodeId, StateValue] = field(default_factory=dict)
    decision: Optional[StateValue] = None

    def add_round1_vote(self, node: NodeId, vote: StateValue) -> None:
        self.round1_votes.setdefault(node, vote)

    def add_round2_vote(self, node: NodeId, vote: StateValue) -> None:
        self.round2_votes.setdefault(node, vote)

    @staticmethod
    def count_votes(
        votes: dict[NodeId, StateValue],
    ) -> tuple[int, int, int]:
        """(v0_count, v1_count, vq_count)."""
        v0 = v1 = vq = 0
        for v in votes.values():
            if v == StateValue.V0:
                v0 += 1
            elif v == StateValue.V1:
                v1 += 1
            elif v == StateValue.VQuestion:
                vq += 1
        return v0, v1, vq

    def _majority_of(
        self, votes: dict[NodeId, StateValue], n_nodes: int
    ) -> Optional[StateValue]:
        q = quorum_size(n_nodes)
        v0, v1, _ = self.count_votes(votes)
        if v0 >= q:
            return StateValue.V0
        if v1 >= q:
            return StateValue.V1
        return None

    def round1_majority(self, n_nodes: int) -> Optional[StateValue]:
        return self._majority_of(self.round1_votes, n_nodes)

    def round2_majority(self, n_nodes: int) -> Optional[StateValue]:
        return self._majority_of(self.round2_votes, n_nodes)

    def has_round1_quorum(self, n_nodes: int) -> bool:
        return len(self.round1_votes) >= quorum_size(n_nodes)

    def has_round2_quorum(self, n_nodes: int) -> bool:
        return len(self.round2_votes) >= quorum_size(n_nodes)

    def set_decision(self, value: StateValue) -> None:
        """Record the decision; commit only concrete values (messages.rs:217-222)."""
        if value == StateValue.VQuestion:
            return
        if self.decision is None:
            self.decision = value

    def is_decided(self) -> bool:
        return self.decision is not None


@dataclass
class PendingBatch:
    """A submitted batch awaiting consensus (messages.rs:225-257)."""

    batch: CommandBatch
    proposer: NodeId
    submitted_at: float = field(default_factory=time.time)
    phase: Optional[PhaseId] = None
    attempts: int = 0

    def age(self) -> float:
        return time.time() - self.submitted_at


def vote_vector(
    entries: Sequence[tuple[int, int, StateValue]],
) -> tuple[VoteEntry, ...]:
    """Convenience: build a vote vector from (shard, phase, vote) triples."""
    return tuple(VoteEntry(s, p, v) for s, p, v in entries)
