"""Typed app-facing State Machine Replication API.

Reference parity: rabia-core/src/smr.rs:88-176 — the generic trait with
associated ``Command``/``Response``/``State`` types, typed apply, state
get/set, state (de)serialization, a default batched apply, and the
``is_deterministic`` marker. Here it's a generic ABC; a bridge adapter turns
any typed SMR into the engine-facing bytes :class:`~rabia_tpu_torch.core.
state_machine.StateMachine`.
"""

from __future__ import annotations

import abc
from typing import Generic, Sequence, TypeVar

from rabia_tpu_torch.core.errors import StateMachineError
from rabia_tpu_torch.core.state_machine import Snapshot, StateMachine
from rabia_tpu_torch.core.types import Command as RawCommand

C = TypeVar("C")  # typed command
R = TypeVar("R")  # typed response
S = TypeVar("S")  # typed state


class TypedStateMachine(abc.ABC, Generic[C, R, S]):
    """App-developer SMR interface (smr.rs:88-176).

    Implementations must be deterministic: ``apply_command`` on equal states
    with equal commands yields equal responses and next states on every
    replica.
    """

    # -- typed core --------------------------------------------------------

    @abc.abstractmethod
    def apply_command(self, command: C) -> R:
        ...

    def apply_commands(self, commands: Sequence[C]) -> list[R]:
        return [self.apply_command(c) for c in commands]

    @abc.abstractmethod
    def get_state(self) -> S:
        ...

    @abc.abstractmethod
    def set_state(self, state: S) -> None:
        ...

    # -- codecs ------------------------------------------------------------

    @abc.abstractmethod
    def encode_command(self, command: C) -> bytes:
        ...

    @abc.abstractmethod
    def decode_command(self, data: bytes) -> C:
        ...

    @abc.abstractmethod
    def encode_response(self, response: R) -> bytes:
        ...

    @abc.abstractmethod
    def decode_response(self, data: bytes) -> R:
        ...

    @abc.abstractmethod
    def serialize_state(self) -> bytes:
        ...

    @abc.abstractmethod
    def deserialize_state(self, data: bytes) -> None:
        ...

    # -- raw fast path ------------------------------------------------------

    def apply_raw(self, data: bytes) -> bytes:
        """Apply one ENCODED command; encoded response — the block/apply
        lane's per-op path. The default is decode→apply→encode without
        the bridge round trip (no :class:`Command` object, no uuid per
        op); apps with a binary format override it (KVStoreSMR)."""
        self._bump_version()
        return self.encode_response(
            self.apply_command(self.decode_command(data))
        )

    def apply_raw_many(self, ops: Sequence[bytes], now=None) -> list[bytes]:
        """Bulk :meth:`apply_raw` (one decided wave of a shard)."""
        return [self.apply_raw(b) for b in ops]

    # -- markers -----------------------------------------------------------

    def is_deterministic(self) -> bool:
        """Apps may override to declare nondeterminism (smr.rs marker)."""
        return True

    def state_version(self) -> int:
        """Monotone version counter; default counts applied commands."""
        return getattr(self, "_smr_version", 0)

    def _bump_version(self) -> None:
        setattr(self, "_smr_version", getattr(self, "_smr_version", 0) + 1)


class SMRBridge(StateMachine):
    """Adapts a :class:`TypedStateMachine` to the engine's bytes interface.

    Reference analog: examples/kvstore_smr/src/smr_impl.rs:22-100 (each app
    hand-writes this adapter there; here it is generic).
    """

    def __init__(self, typed: TypedStateMachine) -> None:
        self.typed = typed
        self._version = 0

    def apply_command(self, command: RawCommand) -> bytes:
        try:
            typed_cmd = self.typed.decode_command(command.data)
        except Exception as e:
            raise StateMachineError(f"undecodable command: {e}") from e
        response = self.typed.apply_command(typed_cmd)
        self._version += 1
        return self.typed.encode_response(response)

    def create_snapshot(self) -> Snapshot:
        return Snapshot.create(self._version, self.typed.serialize_state())

    def restore_snapshot(self, snapshot: Snapshot) -> None:
        snapshot.verify()
        self.typed.deserialize_state(snapshot.data)
        self._version = snapshot.version

    def get_state_summary(self) -> str:
        return f"{type(self.typed).__name__} @ v{self._version}"
