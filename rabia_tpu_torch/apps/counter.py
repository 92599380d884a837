"""Counter SMR app: the minimal typed replicated state machine.

Reference parity: examples/counter_smr/src/lib.rs — commands
Increment/Decrement/Set/Get/Reset (:35-47), overflow/underflow-checked
apply logic and an operation counter (:128-207). This is BASELINE config #1's
app and the first end-to-end milestone (SURVEY.md §7.3).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass
from typing import Optional

from rabia_tpu_torch.core.errors import StateMachineError
from rabia_tpu_torch.core.smr import TypedStateMachine

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


class CounterOp(enum.Enum):
    Increment = "increment"
    Decrement = "decrement"
    Set = "set"
    Get = "get"
    Reset = "reset"


@dataclass(frozen=True)
class CounterCommand:
    """One typed command (counter_smr lib.rs:35-47)."""

    op: CounterOp
    amount: int = 1

    @staticmethod
    def increment(amount: int = 1) -> "CounterCommand":
        return CounterCommand(CounterOp.Increment, amount)

    @staticmethod
    def decrement(amount: int = 1) -> "CounterCommand":
        return CounterCommand(CounterOp.Decrement, amount)

    @staticmethod
    def set(value: int) -> "CounterCommand":
        return CounterCommand(CounterOp.Set, value)

    @staticmethod
    def get() -> "CounterCommand":
        return CounterCommand(CounterOp.Get, 0)

    @staticmethod
    def reset() -> "CounterCommand":
        return CounterCommand(CounterOp.Reset, 0)


@dataclass(frozen=True)
class CounterResponse:
    """Deterministic response: the post-command value (or error text)."""

    value: int
    ok: bool = True
    error: Optional[str] = None


@dataclass
class CounterState:
    value: int = 0
    operations: int = 0


class CounterSMR(TypedStateMachine[CounterCommand, CounterResponse, CounterState]):
    """Overflow-checked counter (counter_smr lib.rs:128-207).

    Saturating errors are *responses*, not exceptions: a rejected overflow
    still advances the op counter deterministically on every replica.
    """

    def __init__(self) -> None:
        self._state = CounterState()

    # -- apply --------------------------------------------------------------

    def apply_command(self, command: CounterCommand) -> CounterResponse:
        st = self._state
        st.operations += 1
        self._bump_version()
        if command.op == CounterOp.Increment:
            nv = st.value + command.amount
            if nv > _I64_MAX or command.amount < 0:
                return CounterResponse(st.value, ok=False, error="overflow")
            st.value = nv
        elif command.op == CounterOp.Decrement:
            nv = st.value - command.amount
            if nv < _I64_MIN or command.amount < 0:
                return CounterResponse(st.value, ok=False, error="underflow")
            st.value = nv
        elif command.op == CounterOp.Set:
            if not (_I64_MIN <= command.amount <= _I64_MAX):
                return CounterResponse(st.value, ok=False, error="out of range")
            st.value = command.amount
        elif command.op == CounterOp.Reset:
            st.value = 0
        elif command.op == CounterOp.Get:
            pass
        else:  # pragma: no cover - enum is closed
            return CounterResponse(st.value, ok=False, error="unknown op")
        return CounterResponse(st.value)

    # -- state --------------------------------------------------------------

    def get_state(self) -> CounterState:
        return CounterState(self._state.value, self._state.operations)

    def set_state(self, state: CounterState) -> None:
        self._state = CounterState(state.value, state.operations)

    @property
    def value(self) -> int:
        return self._state.value

    @property
    def operations(self) -> int:
        return self._state.operations

    # -- codecs (JSON: compact, deterministic, debuggable) -------------------

    def encode_command(self, command: CounterCommand) -> bytes:
        return json.dumps(
            {"op": command.op.value, "amount": command.amount},
            separators=(",", ":"),
        ).encode()

    def decode_command(self, data: bytes) -> CounterCommand:
        try:
            doc = json.loads(data)
            return CounterCommand(CounterOp(doc["op"]), int(doc.get("amount", 0)))
        except (ValueError, KeyError) as e:
            raise StateMachineError(f"bad counter command: {e}") from None

    def encode_response(self, response: CounterResponse) -> bytes:
        return json.dumps(
            {"value": response.value, "ok": response.ok, "error": response.error},
            separators=(",", ":"),
        ).encode()

    def decode_response(self, data: bytes) -> CounterResponse:
        doc = json.loads(data)
        return CounterResponse(int(doc["value"]), bool(doc["ok"]), doc.get("error"))

    def serialize_state(self) -> bytes:
        return json.dumps(
            {"value": self._state.value, "operations": self._state.operations},
            separators=(",", ":"),
        ).encode()

    def deserialize_state(self, data: bytes) -> None:
        doc = json.loads(data)
        self._state = CounterState(int(doc["value"]), int(doc["operations"]))
