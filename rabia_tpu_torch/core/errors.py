"""Error taxonomy: a copy of the reference package's
``rabia_tpu/core/errors.py``. ``is_retryable`` is true for the transient
network-ish classes (Network, Timeout, QuorumNotAvailable).
"""

from __future__ import annotations


class RabiaError(Exception):
    """Base class for all framework errors."""

    retryable: bool = False

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message

    def is_retryable(self) -> bool:
        return self.retryable

    def __str__(self) -> str:
        return f"{type(self).__name__}: {self.message}"


class NetworkError(RabiaError):
    retryable = True


class PersistenceError(RabiaError):
    pass


class StateMachineError(RabiaError):
    pass


class ConsensusError(RabiaError):
    pass


class NodeNotFoundError(RabiaError):
    def __init__(self, node_id) -> None:
        super().__init__(f"node not found: {node_id}")
        self.node_id = node_id


class PhaseNotFoundError(RabiaError):
    def __init__(self, phase) -> None:
        super().__init__(f"phase not found: {phase}")
        self.phase = phase


class BatchNotFoundError(RabiaError):
    def __init__(self, batch_id) -> None:
        super().__init__(f"batch not found: {batch_id}")
        self.batch_id = batch_id


class InvalidStateTransitionError(RabiaError):
    def __init__(self, from_state: str, to_state: str) -> None:
        super().__init__(f"invalid state transition: {from_state} -> {to_state}")
        self.from_state = from_state
        self.to_state = to_state


class QuorumNotAvailableError(RabiaError):
    retryable = True


class ChecksumMismatchError(RabiaError):
    def __init__(self, expected: int, actual: int) -> None:
        super().__init__(f"checksum mismatch: expected {expected:#x}, got {actual:#x}")
        self.expected = expected
        self.actual = actual


class StateCorruptionError(RabiaError):
    pass


class PartialWriteError(RabiaError):
    def __init__(self, written: int, expected: int) -> None:
        super().__init__(f"partial write: {written}/{expected} bytes")
        self.written = written
        self.expected = expected


class TimeoutError_(RabiaError):  # trailing underscore: don't shadow builtin
    retryable = True

    def __init__(self, op: str = "operation", timeout=None) -> None:
        # every transport raises TimeoutError_("receive", timeout); a
        # bare RabiaError.__init__ made that raise itself TypeError
        msg = (
            f"{op} timed out"
            if timeout is None
            else f"{op} timed out after {timeout}s"
        )
        super().__init__(msg)
        self.op = op
        self.timeout = timeout


class ResponsesUnavailableError(RabiaError):
    """The batch COMMITTED, but per-command responses never materialized
    on this replica (it adopted the slots via snapshot sync). The command
    must not be re-proposed — peers that applied normally still hold the
    responses (the gateway's result-repair path fetches them)."""


class SerializationError(RabiaError):
    pass


class IoError(RabiaError):
    pass


class InternalError(RabiaError):
    pass


class ValidationError(RabiaError):
    """Message/batch failed structural validation (rejected on ingest)."""


class ConfigurationError(RabiaError):
    pass
