"""The KV store's typed operations and their binary codec.

The port's copy of what the block lane needs from the reference
package's ``rabia_tpu/apps/kvstore.py``: the operation and result types
and the binary op/result framing. The records are the bytes that ride
the blocks and the response frames the vector store and the device lane
return, byte for byte the reference's. ``KVStore``, ``KVStoreSMR`` and
the notification bus come with the host stack (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass
from typing import Optional

from rabia_tpu_torch.core.errors import StateMachineError


class KVOpType(enum.Enum):
    Set = "set"
    Get = "get"
    Delete = "delete"
    Exists = "exists"
    Clear = "clear"
    Cas = "cas"


_WRITE_OPS = {KVOpType.Set, KVOpType.Delete, KVOpType.Clear, KVOpType.Cas}


@dataclass(frozen=True)
class KVOperation:
    """One typed store operation. ``expected_version`` is meaningful for
    :attr:`KVOpType.Cas` only: the entry version the write is conditioned
    on (0 = create-if-absent)."""

    op: KVOpType
    key: str = ""
    value: Optional[str] = None
    expected_version: int = 0

    @property
    def is_write(self) -> bool:
        return self.op in _WRITE_OPS

    @property
    def is_read(self) -> bool:
        return not self.is_write

    @staticmethod
    def set(key: str, value: str) -> "KVOperation":
        return KVOperation(KVOpType.Set, key, value)

    @staticmethod
    def get(key: str) -> "KVOperation":
        return KVOperation(KVOpType.Get, key)

    @staticmethod
    def delete(key: str) -> "KVOperation":
        return KVOperation(KVOpType.Delete, key)

    @staticmethod
    def exists(key: str) -> "KVOperation":
        return KVOperation(KVOpType.Exists, key)

    @staticmethod
    def cas(key: str, value: str, expected_version: int) -> "KVOperation":
        return KVOperation(KVOpType.Cas, key, value, expected_version)


class KVResultKind(enum.Enum):
    Success = "success"
    NotFound = "not_found"
    Error = "error"


@dataclass(frozen=True)
class KVResult:
    """Operation outcome."""

    kind: KVResultKind
    value: Optional[str] = None
    version: Optional[int] = None
    error: Optional[str] = None

    @staticmethod
    def success(value: Optional[str] = None, version: Optional[int] = None) -> "KVResult":
        return KVResult(KVResultKind.Success, value=value, version=version)

    @staticmethod
    def not_found() -> "KVResult":
        return KVResult(KVResultKind.NotFound)

    @staticmethod
    def err(message: str) -> "KVResult":
        return KVResult(KVResultKind.Error, error=message)

    @property
    def ok(self) -> bool:
        return self.kind == KVResultKind.Success


# Binary op records: u8 opcode | u16 LE key length | key | payload, where
# the payload is the value (SET), u64 LE expected version + value (CAS),
# or nothing.
_OP_SET, _OP_GET, _OP_DEL, _OP_EXISTS, _OP_CLEAR, _OP_CAS = 1, 2, 3, 4, 5, 6

_OP_CODE = {
    KVOpType.Set: _OP_SET,
    KVOpType.Get: _OP_GET,
    KVOpType.Delete: _OP_DEL,
    KVOpType.Exists: _OP_EXISTS,
    KVOpType.Clear: _OP_CLEAR,
    KVOpType.Cas: _OP_CAS,
}
_CODE_OP = {v: k for k, v in _OP_CODE.items()}


def encode_op_bin(op: KVOperation) -> bytes:
    kb = op.key.encode()
    head = bytes((_OP_CODE[op.op],)) + len(kb).to_bytes(2, "little") + kb
    if op.op == KVOpType.Set:
        return head + (op.value or "").encode()
    if op.op == KVOpType.Cas:
        return (
            head
            + int(op.expected_version).to_bytes(8, "little")
            + (op.value or "").encode()
        )
    return head


def encode_cas_bin(key: str, value: str, expected_version: int) -> bytes:
    kb = key.encode()
    return (
        b"\x06"
        + len(kb).to_bytes(2, "little")
        + kb
        + int(expected_version).to_bytes(8, "little")
        + value.encode()
    )


def encode_set_bin(key: str, value: str) -> bytes:
    kb = key.encode()
    return b"\x01" + len(kb).to_bytes(2, "little") + kb + value.encode()


def _result_bin(kind: int, version: int, value: Optional[str] = None) -> bytes:
    # kind u8 | version u32 LE | has_value u8 | value utf8 — the presence
    # byte keeps "empty string value" distinct from "no value"
    head = bytes((kind,)) + (version & 0xFFFFFFFF).to_bytes(4, "little")
    if value is None:
        return head + b"\x00"
    return head + b"\x01" + value.encode()


def decode_op_bin(data: bytes) -> KVOperation:
    try:
        op = _CODE_OP[data[0]]
        klen = int.from_bytes(data[1:3], "little")
        if 3 + klen > len(data):
            raise KeyError(f"key length {klen} exceeds payload")
        key = data[3 : 3 + klen].decode()
        if op == KVOpType.Set:
            return KVOperation(op, key, data[3 + klen :].decode())
        if op == KVOpType.Cas:
            if 3 + klen + 8 > len(data):
                raise KeyError("cas payload shorter than its version field")
            expected = int.from_bytes(data[3 + klen : 3 + klen + 8], "little")
            return KVOperation(op, key, data[3 + klen + 8 :].decode(), expected)
        return KVOperation(op, key, None)
    except (KeyError, IndexError, UnicodeDecodeError) as e:
        raise StateMachineError(f"bad binary kv command: {e}") from None


def decode_kv_response(data: bytes) -> KVResult:
    """Decode a committed response frame in either framing: the scalar
    lane's JSON or the compact binary result (block lane)."""
    if data[:1] == b"{":
        doc = json.loads(data)
        return KVResult(
            KVResultKind(doc["kind"]),
            value=doc.get("value"),
            version=doc.get("version"),
            error=doc.get("error"),
        )
    return decode_result_bin(data)


def decode_result_bin(data: bytes) -> KVResult:
    kind = data[0]
    version = int.from_bytes(data[1:5], "little")
    value = data[6:].decode() if len(data) > 5 and data[5] else None
    if kind == 0:
        return KVResult.success(value=value, version=version or None)
    if kind == 1:
        return KVResult.not_found()
    # error results carry the entry's current version when known
    return KVResult(
        KVResultKind.Error, error=value or "error", version=version or None
    )
