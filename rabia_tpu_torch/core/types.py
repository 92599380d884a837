"""Core identifiers and protocol values.

The port's own copy of the names it needs from the reference package's
``rabia_tpu/core/types.py``: the int8 vote codes, the quorum helpers,
and the command/batch/identifier dataclasses. The codes are the device
representation: vote tensors hold them as ``torch.int8``.
"""

from __future__ import annotations

import os
import random
import time
import uuid
import zlib
from dataclasses import dataclass, field
from typing import Iterable

# Device-side int8 codes. Order matters: tallies index by code.
V0: int = 0  # "forfeit / reject the batch"
V1: int = 1  # "commit the batch"
VQUESTION: int = 2  # "undecided / question mark"
ABSENT: int = 3  # inbox slot with no vote received (device-only padding code)

# Identity ids need uniqueness, not cryptographic strength: uuid.uuid4
# reads os.urandom per call, so ids come from a process-local PRNG seeded
# once from urandom and reseeded in forked children.
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
    """Cluster-unique node identifier (a UUID; deterministic from small
    integers for tests)."""

    value: uuid.UUID

    @staticmethod
    def new() -> "NodeId":
        return NodeId(fast_uuid4())

    @staticmethod
    def from_int(n: int) -> "NodeId":
        if n < 0:
            n &= (1 << 64) - 1
        return NodeId(uuid.UUID(int=n))

    @property
    def as_int(self) -> int:
        return self.value.int

    def short(self) -> str:
        return str(self.value)[:8]

    def __str__(self) -> str:
        return str(self.value)


@dataclass(frozen=True, order=True)
class BatchId:
    """Unique id for a command batch."""

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
    """Index of one consensus instance (one key-range shard)."""

    value: int = 0

    def __int__(self) -> int:
        return self.value

    def __str__(self) -> str:
        return f"shard:{self.value}"


@dataclass(frozen=True)
class Command:
    """A single opaque state-machine command."""

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
    """An ordered group of commands agreed on as one consensus unit. The
    checksum covers the command ids and payloads in order."""

    id: BatchId
    commands: tuple[Command, ...]
    timestamp: float = field(default_factory=time.time)
    shard: ShardId = ShardId(0)
    # per-client (bid_bytes16, op_lo, op_hi) ids that ride a coalesced
    # block entry (core/blocks.py); not part of equality or repr
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


def quorum_size(n_nodes: int) -> int:
    """Majority quorum: floor(n/2)+1."""
    if n_nodes <= 0:
        raise ValueError("cluster must have at least one node")
    return n_nodes // 2 + 1


def f_plus_1(n_nodes: int) -> int:
    """Decision threshold f+1 with f = (n-1)//2 tolerated crashes."""
    return (n_nodes - 1) // 2 + 1
