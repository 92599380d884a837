"""Core identifiers and protocol values.

A copy of the reference package's ``rabia_tpu/core/types.py``: the int8
vote codes and ``StateValue``, the identifiers, commands and batches, and
the quorum helpers. The codes are the device representation: vote
tensors hold them as ``torch.int8``.
"""

from __future__ import annotations

import enum
import os
import random
import time
import uuid
import zlib
from dataclasses import dataclass, field
from typing import Iterable, Sequence

# ---------------------------------------------------------------------------
# StateValue — the weak-MVC binary-consensus value lattice
# ---------------------------------------------------------------------------

# Device-side int8 codes. Order matters: one_hot tallies index by code.
V0: int = 0  # "forfeit / reject the batch"
V1: int = 1  # "commit the batch"
VQUESTION: int = 2  # "undecided / question mark"
ABSENT: int = 3  # inbox slot with no vote received (device-only padding code)

_STATE_VALUE_NAMES = {V0: "V0", V1: "V1", VQUESTION: "V?", ABSENT: "ABSENT"}


class StateValue(enum.IntEnum):
    """Weak-MVC state value (rabia-core/src/types.rs:286-304).

    ``IntEnum`` over the device codes, so ``int(sv)`` is the kernel code and
    ``StateValue(code)`` recovers the host view of a device array element.
    """

    V0 = V0
    V1 = V1
    VQuestion = VQUESTION
    Absent = ABSENT  # not a protocol value; wire/device padding only

    def is_decided_value(self) -> bool:
        """True for the two concrete binary values (V0/V1)."""
        return self in (StateValue.V0, StateValue.V1)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return _STATE_VALUE_NAMES[int(self)]


# ---------------------------------------------------------------------------
# Identifiers
# ---------------------------------------------------------------------------

_DETERMINISTIC_NODE_NS = uuid.UUID("00000000-0000-0000-0000-000000000000")

# Identity ids need UNIQUENESS, not cryptographic strength (the reference
# likewise uses random uuid v4, rabia-core/src/types.rs:23-40). uuid.uuid4
# reads os.urandom per call — ~0.6ms per id in sandboxed environments
# (profiled on the batch hot path) — so ids come from a process-local PRNG
# seeded once from urandom, reseeded in forked children.
_id_rng = random.Random(int.from_bytes(os.urandom(16), "little"))
if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(
        after_in_child=lambda: _id_rng.seed(
            int.from_bytes(os.urandom(16), "little")
        )
    )


def fast_uuid4() -> uuid.UUID:
    """uuid4-format id (version/variant bits set) off the fast PRNG."""
    return uuid.UUID(int=_id_rng.getrandbits(128), version=4)


@dataclass(frozen=True, order=True)
class NodeId:
    """Cluster-unique node identifier.

    Like the reference (rabia-core/src/types.rs:23-40) a NodeId is a UUID:
    random for production (``NodeId.new()``) and deterministic from small
    integers for tests (types.rs:48-119's ``From<u32/u64/i32>``). Ordering is
    total (UUID byte order) — the leader selector relies on ``min()``.
    """

    value: uuid.UUID

    @staticmethod
    def new() -> "NodeId":
        return NodeId(fast_uuid4())

    @staticmethod
    def from_int(n: int) -> "NodeId":
        """Deterministic id for tests; NodeId.from_int(n) is stable forever."""
        if n < 0:
            n &= (1 << 64) - 1
        return NodeId(uuid.UUID(int=n))

    @property
    def as_int(self) -> int:
        return self.value.int

    def short(self) -> str:
        """8-char prefix for logs."""
        return str(self.value)[:8]

    def __str__(self) -> str:
        return str(self.value)


@dataclass(frozen=True, order=True)
class PhaseId:
    """Monotonic consensus phase counter (rabia-core/src/types.rs:163-213).

    Phases are per-shard in this framework; the device holds them as
    ``int64[S]`` and the host wraps individual elements in ``PhaseId``.
    """

    value: int = 0

    def next(self) -> "PhaseId":
        return PhaseId(self.value + 1)

    def prev(self) -> "PhaseId":
        return PhaseId(max(0, self.value - 1))

    def is_initial(self) -> bool:
        return self.value == 0

    def __int__(self) -> int:
        return self.value

    def __str__(self) -> str:
        return f"phase:{self.value}"


ZERO_PHASE = PhaseId(0)


@dataclass(frozen=True, order=True)
class BatchId:
    """Unique id for a command batch (rabia-core/src/types.rs:235-252)."""

    value: uuid.UUID

    @staticmethod
    def new() -> "BatchId":
        return BatchId(fast_uuid4())

    @staticmethod
    def from_int(n: int) -> "BatchId":
        return BatchId(uuid.UUID(int=n))

    def short(self) -> str:
        return str(self.value)[:8]

    def __str__(self) -> str:
        return str(self.value)


@dataclass(frozen=True, order=True)
class ShardId:
    """Index of one consensus instance (one kvstore key-range shard).

    No reference analog — the reference runs exactly one consensus instance;
    the shard axis is the new framework's TPU scale axis (SURVEY.md §5.7).
    """

    value: int = 0

    def __int__(self) -> int:
        return self.value

    def __str__(self) -> str:
        return f"shard:{self.value}"


# ---------------------------------------------------------------------------
# Commands and batches
# ---------------------------------------------------------------------------


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


@dataclass(frozen=True)
class Command:
    """A single opaque state-machine command (rabia-core/src/types.rs:320-351).

    ``data`` is untyped bytes; typed apps encode/decode via the SMR layer.
    """

    id: uuid.UUID
    data: bytes

    @staticmethod
    def new(data: bytes | str) -> "Command":
        if isinstance(data, str):
            data = data.encode("utf-8")
        return Command(id=fast_uuid4(), data=bytes(data))

    def size(self) -> int:
        return len(self.data)

    def data_str(self) -> str:
        return self.data.decode("utf-8", errors="replace")


@dataclass(frozen=True)
class CommandBatch:
    """An ordered group of commands agreed on as one consensus unit.

    Reference: rabia-core/src/types.rs:370-430; the checksum there is crc32
    over a serialized view (:426-429). Here the checksum covers the raw
    command payloads in order (stable and serialization-independent).
    """

    id: BatchId
    commands: tuple[Command, ...]
    timestamp: float = field(default_factory=time.time)
    shard: ShardId = ShardId(0)
    # proposer-LOCAL alias batch ids (never serialized): the coalescing
    # lane's non-lead (client_id, seq)-derived ids as
    # (bid_bytes16, op_lo, op_hi) triples — the apply path registers
    # them in the dedup ledger next to ``id`` (core/blocks.py doc).
    # Equality/hash of a batch stays its ``id``-based dataclass identity;
    # aliases ride along only so a demoted coalesced entry keeps its
    # per-client exactly-once bookkeeping on the scalar lane. Excluded
    # from compare AND repr: the native codec materializes wire-decoded
    # batches without running __init__, so this attribute may be absent
    # — consumers read it with getattr(batch, "aliases", ()).
    aliases: tuple = field(default=(), compare=False, repr=False)

    @staticmethod
    def new(
        commands: Iterable[Command | bytes | str], shard: ShardId = ShardId(0)
    ) -> "CommandBatch":
        cmds = tuple(
            c if isinstance(c, Command) else Command.new(c) for c in commands
        )
        return CommandBatch(id=BatchId.new(), commands=cmds, shard=shard)

    def __len__(self) -> int:
        return len(self.commands)

    def is_empty(self) -> bool:
        return not self.commands

    def total_size(self) -> int:
        return sum(c.size() for c in self.commands)

    def checksum(self) -> int:
        crc = 0
        for c in self.commands:
            crc = zlib.crc32(c.id.bytes, crc)
            crc = zlib.crc32(c.data, crc)
        return crc & 0xFFFFFFFF

    def verify(self, expected_checksum: int) -> bool:
        return self.checksum() == expected_checksum


# ---------------------------------------------------------------------------
# Consensus status view
# ---------------------------------------------------------------------------


class ConsensusPhaseState(enum.IntEnum):
    """Per-shard lifecycle stage (rabia-core/src/types.rs:131-146 analog).

    These are also the device ``stage`` codes in the kernel state.
    """

    Idle = 0  # no active proposal for this shard
    Round1 = 1  # proposal broadcast; waiting on round-1 votes
    Round2 = 2  # round-2 vote cast; waiting on round-2 votes
    Decided = 3  # decision reached this phase (terminal until next propose)


def quorum_size(n_nodes: int) -> int:
    """Majority quorum: floor(n/2)+1 (rabia-core/src/network.rs:15)."""
    if n_nodes <= 0:
        raise ValueError("cluster must have at least one node")
    return n_nodes // 2 + 1


def f_plus_1(n_nodes: int) -> int:
    """Decision threshold f+1 where f = max tolerated crashes = ceil(n/2)-1.

    From the Ivy spec's ``set_f_plus_1`` (docs/weak_mvc.ivy:18-31): any
    majority and any (f+1)-set intersect. With n = 2f+1, f+1 = quorum(n) - ...
    for odd n this equals (n+1)//2; we use f = (n-1)//2 so f+1 = (n+1)//2.
    """
    return (n_nodes - 1) // 2 + 1


def sorted_nodes(nodes: Iterable[NodeId]) -> list[NodeId]:
    return sorted(nodes)


def node_index_map(nodes: Sequence[NodeId]) -> dict[NodeId, int]:
    """Stable node→replica-row mapping used to index device vote matrices."""
    return {n: i for i, n in enumerate(sorted_nodes(nodes))}
