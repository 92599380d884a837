"""Engine-facing state machine boundary (untyped bytes).

A copy of the reference package's ``Snapshot``, ``StateMachine`` and
``InMemoryStateMachine``. The snapshot encoding is byte-identical to the
reference's, so a snapshot taken by either package restores in the
other (tests/test_torch_mesh_engine.py checks it).
"""

from __future__ import annotations

import abc
import json
import zlib
from dataclasses import dataclass
from typing import Sequence

from rabia_tpu_torch.core.errors import ChecksumMismatchError, StateMachineError
from rabia_tpu_torch.core.types import Command, CommandBatch


@dataclass(frozen=True)
class Snapshot:
    """Versioned state blob with a crc32 integrity check."""

    version: int
    data: bytes
    checksum: int

    @staticmethod
    def create(version: int, data: bytes) -> "Snapshot":
        return Snapshot(version=version, data=data, checksum=zlib.crc32(data) & 0xFFFFFFFF)

    def verify(self) -> None:
        actual = zlib.crc32(self.data) & 0xFFFFFFFF
        if actual != self.checksum:
            raise ChecksumMismatchError(self.checksum, actual)

    def to_bytes(self) -> bytes:
        head = self.version.to_bytes(8, "little") + self.checksum.to_bytes(4, "little")
        return head + self.data

    @staticmethod
    def from_bytes(raw: bytes) -> "Snapshot":
        if len(raw) < 12:
            raise StateMachineError("snapshot blob too short")
        version = int.from_bytes(raw[:8], "little")
        checksum = int.from_bytes(raw[8:12], "little")
        snap = Snapshot(version=version, data=raw[12:], checksum=checksum)
        snap.verify()
        return snap


class StateMachine(abc.ABC):
    """The deterministic replicated state machine the engine drives:
    identical command sequences on every replica must produce identical
    states and responses."""

    @abc.abstractmethod
    def apply_command(self, command: Command) -> bytes:
        """Apply one command; return the (replicated-deterministic) response."""

    def apply_commands(self, commands: Sequence[Command]) -> list[bytes]:
        return [self.apply_command(c) for c in commands]

    def apply_batch(self, batch: CommandBatch) -> list[bytes]:
        return self.apply_commands(batch.commands)

    @abc.abstractmethod
    def create_snapshot(self) -> Snapshot:
        """Serialize full state into a versioned snapshot."""

    @abc.abstractmethod
    def restore_snapshot(self, snapshot: Snapshot) -> None:
        """Replace state from a snapshot."""

    @abc.abstractmethod
    def get_state_summary(self) -> str:
        """Cheap human-readable state digest (for logs/tests)."""


class VectorStateMachine(abc.ABC):
    """Optional bulk-apply capability for the engine's block lane: a
    :class:`StateMachine` that also implements this receives a whole
    decided :class:`~rabia_tpu_torch.core.blocks.PayloadBlock` wave in one
    call. Responses must stay a pure function of the applied commands."""

    @abc.abstractmethod
    def apply_block(self, block, idxs, want_responses: bool = True):
        """Apply covered-shard indices ``idxs`` (numpy int array) of
        ``block`` in order; return one response list per index, or None
        when ``want_responses`` is False (follower replicas discard
        responses — implementations may skip building them)."""


class InMemoryStateMachine(StateMachine):
    """Dict state machine parsing SET/GET/DEL text commands:
      ``SET <key> <value>`` -> "OK"
      ``GET <key>``         -> value or "NOT_FOUND"
      ``DEL <key>``         -> "DELETED" or "NOT_FOUND"
    Unknown commands return "ERROR: ..." (still deterministic).
    """

    def __init__(self) -> None:
        self._data: dict[str, str] = {}
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def apply_command(self, command: Command) -> bytes:
        self._version += 1
        text = command.data_str().strip()
        parts = text.split(" ", 2)
        op = parts[0].upper() if parts else ""
        if op == "SET" and len(parts) == 3:
            self._data[parts[1]] = parts[2]
            return b"OK"
        if op == "GET" and len(parts) >= 2:
            val = self._data.get(parts[1])
            return val.encode("utf-8") if val is not None else b"NOT_FOUND"
        if op == "DEL" and len(parts) >= 2:
            if parts[1] in self._data:
                del self._data[parts[1]]
                return b"DELETED"
            return b"NOT_FOUND"
        return f"ERROR: unknown command {text[:64]!r}".encode("utf-8")

    def create_snapshot(self) -> Snapshot:
        data = json.dumps(
            {"version": self._version, "data": self._data}, sort_keys=True
        ).encode("utf-8")
        return Snapshot.create(self._version, data)

    def restore_snapshot(self, snapshot: Snapshot) -> None:
        snapshot.verify()
        doc = json.loads(snapshot.data.decode("utf-8"))
        self._data = dict(doc["data"])
        self._version = int(doc["version"])

    def get_state_summary(self) -> str:
        return f"{len(self._data)} keys @ v{self._version}"

    def get(self, key: str) -> str | None:
        return self._data.get(key)

    def __len__(self) -> int:
        return len(self._data)
