"""KV store with change notifications, key-range sharding and the binary
op codec.

The port's copy of the reference package's ``rabia_tpu/apps/kvstore.py``:
the operation and result types and the binary op/result framing (the
records that ride the blocks and the response frames the vector store and
the device lane return, byte for byte the reference's), the operation
batches, the error taxonomy, the change-notification bus, the versioned
:class:`KVStore` with its snapshots and content checksum, the bulk binary
apply (:func:`apply_ops_bin`, :func:`apply_op_bin`) and :class:`KVStoreSMR`.
Its ``is_native`` branches hand a native store
(:class:`~rabia_tpu_torch.apps.native_store.NativeKVStore`) to the
statekernel, as the reference does.

The store is sharded by key range (stable hash -> shard index): each shard
is an independent consensus instance, the ``S`` axis the device kernels
batch over.
"""

from __future__ import annotations

import enum
import hashlib
import json
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

from rabia_tpu_torch.core.config import KVStoreConfig
from rabia_tpu_torch.core.errors import StateMachineError, ValidationError
from rabia_tpu_torch.core.smr import TypedStateMachine


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


@dataclass(frozen=True)
class OperationBatch:
    """A group of typed operations executed as one unit
    (operations.rs:169-212)."""

    operations: tuple[KVOperation, ...]
    batch_id: str = ""
    created_at: float = field(default_factory=time.time)

    @staticmethod
    def new(operations: Iterable[KVOperation]) -> "OperationBatch":
        from rabia_tpu_torch.core.types import fast_uuid4

        return OperationBatch(tuple(operations), batch_id=str(fast_uuid4()))

    def size(self) -> int:
        return len(self.operations)

    def has_write_operations(self) -> bool:
        return any(op.is_write for op in self.operations)

    def is_read_only(self) -> bool:
        return not self.has_write_operations()

    def affected_keys(self) -> list[str]:
        return [op.key for op in self.operations]


@dataclass(frozen=True)
class BatchResult:
    """Outcome of one :class:`OperationBatch` (operations.rs:214-262)."""

    batch_id: str
    results: tuple[KVResult, ...]
    success_count: int
    failure_count: int
    execution_time_ms: float

    @staticmethod
    def new(
        batch_id: str,
        results: Iterable[KVResult],
        execution_time_ms: float,
    ) -> "BatchResult":
        rs = tuple(results)
        ok = sum(1 for r in rs if r.ok)
        return BatchResult(batch_id, rs, ok, len(rs) - ok, execution_time_ms)

    def all_succeeded(self) -> bool:
        return self.failure_count == 0

    def has_failures(self) -> bool:
        return self.failure_count > 0

    def success_rate(self) -> float:
        """Percentage of successful operations (0.0 for an empty batch)."""
        if not self.results:
            return 0.0
        return 100.0 * self.success_count / len(self.results)


class StoreErrorKind(enum.Enum):
    """Error taxonomy (operations.rs:96-167)."""

    KeyTooLong = "key_too_long"
    KeyEmpty = "key_empty"
    ValueTooLarge = "value_too_large"
    StoreFull = "store_full"
    KeyNotFound = "key_not_found"
    InvalidOperation = "invalid_operation"
    SnapshotCorrupt = "snapshot_corrupt"
    ChecksumMismatch = "checksum_mismatch"
    VersionConflict = "version_conflict"
    Internal = "internal"

    @property
    def recoverable(self) -> bool:
        return self in (
            StoreErrorKind.KeyNotFound,
            StoreErrorKind.VersionConflict,
            StoreErrorKind.StoreFull,
        )

    @property
    def is_client_error(self) -> bool:
        return self in (
            StoreErrorKind.KeyTooLong,
            StoreErrorKind.KeyEmpty,
            StoreErrorKind.ValueTooLarge,
            StoreErrorKind.InvalidOperation,
            StoreErrorKind.KeyNotFound,
        )


class StoreError(ValidationError):
    def __init__(self, kind: StoreErrorKind, message: str = "") -> None:
        super().__init__(f"{kind.value}: {message}" if message else kind.value)
        self.kind = kind


# ---------------------------------------------------------------------------
# Change notifications (notifications.rs)
# ---------------------------------------------------------------------------


class ChangeType(enum.Enum):
    Created = "created"
    Updated = "updated"
    Deleted = "deleted"
    Cleared = "cleared"


@dataclass(frozen=True)
class ChangeNotification:
    """One change event (notifications.rs:14-42)."""

    key: str
    change: ChangeType
    old_value: Optional[str]
    new_value: Optional[str]
    version: int
    timestamp: float = field(default_factory=time.time)


class NotificationFilter:
    """Filter algebra (notifications.rs:60-89): All / Key / KeyPrefix /
    ChangeType / And / Or, composed as predicate trees."""

    def __init__(self, pred: Callable[[ChangeNotification], bool]) -> None:
        self._pred = pred

    def matches(self, n: ChangeNotification) -> bool:
        return self._pred(n)

    @staticmethod
    def all() -> "NotificationFilter":
        return NotificationFilter(lambda n: True)

    @staticmethod
    def key(key: str) -> "NotificationFilter":
        return NotificationFilter(lambda n: n.key == key)

    @staticmethod
    def key_prefix(prefix: str) -> "NotificationFilter":
        return NotificationFilter(lambda n: n.key.startswith(prefix))

    @staticmethod
    def change_type(ct: ChangeType) -> "NotificationFilter":
        return NotificationFilter(lambda n: n.change == ct)

    def and_(self, other: "NotificationFilter") -> "NotificationFilter":
        return NotificationFilter(lambda n: self.matches(n) and other.matches(n))

    def or_(self, other: "NotificationFilter") -> "NotificationFilter":
        return NotificationFilter(lambda n: self.matches(n) or other.matches(n))


@dataclass
class NotificationStats:
    """Bus counters (notifications.rs:99-104)."""

    published: int = 0
    delivered: int = 0
    dropped: int = 0
    active_subscribers: int = 0


class _Subscription:
    """One subscriber's unbounded queue + filter (notifications.rs:279-314
    NotificationListener analog). Iterate with ``async for`` or ``get()``."""

    _CLOSED = object()  # sentinel: wakes consumers blocked in queue.get()

    def __init__(self, bus: "NotificationBus", flt: NotificationFilter, maxsize: int) -> None:
        import asyncio

        self.bus = bus
        self.filter = flt
        self.queue: "asyncio.Queue" = asyncio.Queue(maxsize)
        self.closed = False

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        item = (
            await self.queue.get()
            if timeout is None
            else await asyncio.wait_for(self.queue.get(), timeout)
        )
        if item is self._CLOSED:
            self.queue.put_nowait(self._CLOSED)  # re-arm for other waiters
            raise StopAsyncIteration
        return item

    def get_nowait(self) -> Optional[ChangeNotification]:
        import asyncio

        try:
            item = self.queue.get_nowait()
        except asyncio.QueueEmpty:
            return None
        if item is self._CLOSED:
            self.queue.put_nowait(self._CLOSED)
            return None
        return item

    def close(self) -> None:
        """Mark closed and wake any consumer parked in get()/async-for."""
        import asyncio

        self.closed = True
        try:
            self.queue.put_nowait(self._CLOSED)
        except asyncio.QueueFull:
            # full queue: the consumer has items to drain and will see the
            # sentinel after them; make room for it deterministically
            try:
                self.queue.get_nowait()
            except asyncio.QueueEmpty:  # pragma: no cover - racy edge
                pass
            self.queue.put_nowait(self._CLOSED)

    def __aiter__(self):
        return self

    async def __anext__(self) -> ChangeNotification:
        if self.closed and self.queue.empty():
            raise StopAsyncIteration
        return await self.get()


class NotificationBus:
    """Filtered pub/sub for store changes (notifications.rs:106-271).

    Synchronous publish into per-subscriber bounded queues (cap mirrors the
    reference's 1000-slot broadcast channel); full queues count drops, and
    closed subscribers are GC'd on the next publish (:237-246 analog).
    """

    def __init__(self, queue_capacity: int = 1000) -> None:
        self._subs: list[_Subscription] = []
        self._capacity = queue_capacity
        self.stats = NotificationStats()

    def subscribe(
        self, flt: Optional[NotificationFilter] = None
    ) -> _Subscription:
        sub = _Subscription(self, flt or NotificationFilter.all(), self._capacity)
        self._subs.append(sub)
        self.stats.active_subscribers = len(self._subs)
        return sub

    def publish(self, n: ChangeNotification) -> int:
        """Deliver to matching subscribers; returns delivery count
        (notifications.rs:198-235)."""
        import asyncio

        self.stats.published += 1
        delivered = 0
        live: list[_Subscription] = []
        for sub in self._subs:
            if sub.closed:
                continue
            live.append(sub)
            if not sub.filter.matches(n):
                continue
            try:
                sub.queue.put_nowait(n)
                delivered += 1
            except asyncio.QueueFull:
                self.stats.dropped += 1
        self._subs = live
        self.stats.active_subscribers = len(live)
        self.stats.delivered += delivered
        return delivered


# ---------------------------------------------------------------------------
# The store (store.rs)
# ---------------------------------------------------------------------------


@dataclass
class ValueEntry:
    """Stored value + metadata (store.rs:44-80)."""

    value: str
    version: int
    created_at: float
    updated_at: float

    @property
    def size(self) -> int:
        return len(self.value.encode())


@dataclass
class StoreStats:
    """Store counters (store.rs:82-90)."""

    total_operations: int = 0
    reads: int = 0
    writes: int = 0
    keys: int = 0
    total_size: int = 0


def shard_for_key(key: str, num_shards: int) -> int:
    """Stable key→shard map (blake2 for cross-process determinism)."""
    if num_shards <= 1:
        return 0
    h = hashlib.blake2s(key.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % num_shards


class KVStore:
    """Versioned in-memory KV store with validation, notifications,
    snapshots, and key-range sharding (store.rs:101-486).

    In the SMR deployment every mutation arrives through consensus (one
    consensus instance per shard); direct calls are for local/testing use.
    """

    def __init__(self, config: Optional[KVStoreConfig] = None) -> None:
        self.config = config or KVStoreConfig()
        self._data: dict[str, ValueEntry] = {}
        self._version = 0
        self.stats = StoreStats()
        # bytes->str key intern for the binary fast path: consensus reuses
        # hot keys every slot, and the UTF-8 decode is ~20% of a fused SET
        self._key_cache: dict[bytes, str] = {}
        self.notifications = (
            NotificationBus() if self.config.notifications_enabled else None
        )

    # -- validation (store.rs:436-451) --------------------------------------

    def _validate_key(self, key: str) -> None:
        if not key:
            raise StoreError(StoreErrorKind.KeyEmpty)
        if len(key) > self.config.max_key_length:
            raise StoreError(
                StoreErrorKind.KeyTooLong, f"{len(key)} > {self.config.max_key_length}"
            )

    def _validate_value(self, value: str) -> None:
        if len(value.encode()) > self.config.max_value_size:
            raise StoreError(StoreErrorKind.ValueTooLarge)

    # -- CRUD ---------------------------------------------------------------

    def apply_set_bin_fast(self, b: bytes, now: float) -> Optional[bytes]:
        """Fused fast path for one binary SET (the block lane's per-slot
        common case): same semantics as :meth:`set` minus intermediate
        objects. Returns None when the slow path must run (subscribers
        present, limit checks fail, store full)."""
        bus = self.notifications
        if bus is not None and bus._subs:
            return None
        if len(b) < 3:
            return None
        klen = b[1] | (b[2] << 8)
        vlen = len(b) - 3 - klen
        cfg = self.config
        if not (0 < klen <= cfg.max_key_length) or vlen < 0 or vlen > cfg.max_value_size:
            return None
        cache = self._key_cache
        kb = b[3 : 3 + klen]
        key = cache.get(kb)
        try:
            if key is None:
                key = kb.decode()
                if len(cache) > 65536:  # bound against key-spraying load
                    cache.clear()
                cache[kb] = key
            value = b[3 + klen :].decode()
        except UnicodeDecodeError:
            return None  # slow path reports the malformed op
        data = self._data
        e = data.get(key)
        v = self._version + 1
        if e is None:
            if len(data) >= cfg.max_keys:
                return None
            data[key] = ValueEntry(value, v, now, now)
        else:
            e.value = value
            e.version = v
            e.updated_at = now
        self._version = v
        st = self.stats
        st.total_operations += 1
        st.writes += 1
        return b"\x00" + v.to_bytes(4, "little") + b"\x00"

    def set(self, key: str, value: str) -> KVResult:
        """Insert or update (store.rs:144-188)."""
        self._validate_key(key)
        self._validate_value(value)
        now = time.time()
        self.stats.total_operations += 1
        self.stats.writes += 1
        entry = self._data.get(key)
        if entry is None:
            if len(self._data) >= self.config.max_keys:
                raise StoreError(StoreErrorKind.StoreFull)
            self._version += 1
            self._data[key] = ValueEntry(value, self._version, now, now)
            self._notify(key, ChangeType.Created, None, value)
        else:
            old = entry.value
            self._version += 1
            entry.value = value
            entry.version = self._version
            entry.updated_at = now
            self._notify(key, ChangeType.Updated, old, value)
        return KVResult.success(version=self._version)

    def cas(self, key: str, value: str, expected_version: int) -> KVResult:
        """Compare-and-set: write only when the entry's version equals
        ``expected_version`` (0 = create-if-absent). Deterministic outcomes
        (the replicated-write contract): NotFound for a conditioned write
        on an absent key, ``version_conflict`` (with the CURRENT version in
        the result) on a mismatch — so optimistic-concurrency clients can
        retry off the committed result alone."""
        self._validate_key(key)
        self._validate_value(value)
        now = time.time()
        self.stats.total_operations += 1
        self.stats.writes += 1
        entry = self._data.get(key)
        if entry is None:
            if expected_version != 0:
                return KVResult.not_found()
            if len(self._data) >= self.config.max_keys:
                raise StoreError(StoreErrorKind.StoreFull)
            self._version += 1
            self._data[key] = ValueEntry(value, self._version, now, now)
            self._notify(key, ChangeType.Created, None, value)
            return KVResult.success(version=self._version)
        if entry.version != expected_version:
            return KVResult(
                KVResultKind.Error,
                version=entry.version,
                error="version_conflict",
            )
        old = entry.value
        self._version += 1
        entry.value = value
        entry.version = self._version
        entry.updated_at = now
        self._notify(key, ChangeType.Updated, old, value)
        return KVResult.success(version=self._version)

    def get(self, key: str) -> KVResult:
        self.stats.total_operations += 1
        self.stats.reads += 1
        entry = self._data.get(key)
        if entry is None:
            return KVResult.not_found()
        return KVResult.success(value=entry.value, version=entry.version)

    def get_with_metadata(self, key: str) -> Optional[ValueEntry]:
        entry = self._data.get(key)
        if entry is None:
            return None
        return ValueEntry(entry.value, entry.version, entry.created_at, entry.updated_at)

    def delete(self, key: str) -> KVResult:
        self.stats.total_operations += 1
        self.stats.writes += 1
        entry = self._data.pop(key, None)
        if entry is None:
            return KVResult.not_found()
        self._version += 1
        self._notify(key, ChangeType.Deleted, entry.value, None)
        return KVResult.success(value=entry.value, version=self._version)

    def exists(self, key: str) -> KVResult:
        self.stats.total_operations += 1
        self.stats.reads += 1
        return KVResult.success(value="true" if key in self._data else "false")

    def keys(self, prefix: str = "") -> list[str]:
        """Sorted key listing, optionally prefix-filtered (store.rs keys())."""
        if prefix:
            return sorted(k for k in self._data if k.startswith(prefix))
        return sorted(self._data)

    def clear(self) -> int:
        n = len(self._data)
        self.stats.total_operations += 1
        self.stats.writes += 1
        self._data.clear()
        self._version += 1
        self._notify("", ChangeType.Cleared, None, None)
        return n

    def size(self) -> int:
        return len(self._data)

    def __len__(self) -> int:
        return len(self._data)

    @property
    def version(self) -> int:
        return self._version

    def _notify(
        self, key: str, change: ChangeType, old: Optional[str], new: Optional[str]
    ) -> None:
        if self.notifications is not None:
            self.notifications.publish(
                ChangeNotification(key, change, old, new, self._version)
            )

    # -- batches (store.rs:313-348) ------------------------------------------

    def apply_operations(self, ops: Sequence[KVOperation]) -> list[KVResult]:
        out: list[KVResult] = []
        for op in ops:
            try:
                if op.op == KVOpType.Set:
                    out.append(self.set(op.key, op.value or ""))
                elif op.op == KVOpType.Get:
                    out.append(self.get(op.key))
                elif op.op == KVOpType.Delete:
                    out.append(self.delete(op.key))
                elif op.op == KVOpType.Exists:
                    out.append(self.exists(op.key))
                elif op.op == KVOpType.Cas:
                    out.append(
                        self.cas(op.key, op.value or "", op.expected_version)
                    )
                elif op.op == KVOpType.Clear:
                    self.clear()
                    out.append(KVResult.success())
                else:
                    out.append(KVResult.err("invalid operation"))
            except StoreError as e:
                out.append(KVResult.err(str(e)))
        return out

    def execute_batch(self, batch: OperationBatch) -> BatchResult:
        """Apply a typed :class:`OperationBatch` and report per-op results
        with success counts and execution time (operations.rs:214-262)."""
        t0 = time.perf_counter()
        results = self.apply_operations(batch.operations)
        return BatchResult.new(
            batch.batch_id, results, (time.perf_counter() - t0) * 1000.0
        )

    # -- snapshots (store.rs:350-412) ----------------------------------------

    def snapshot_bytes(self) -> bytes:
        doc = {
            "version": self._version,
            "data": {
                k: [e.value, e.version, e.created_at, e.updated_at]
                for k, e in sorted(self._data.items())
            },
        }
        payload = json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()
        checksum = zlib.crc32(payload) & 0xFFFFFFFF
        return checksum.to_bytes(4, "little") + payload

    def restore_bytes(self, raw: bytes) -> None:
        if len(raw) < 4:
            raise StoreError(StoreErrorKind.SnapshotCorrupt, "too short")
        checksum = int.from_bytes(raw[:4], "little")
        payload = raw[4:]
        if zlib.crc32(payload) & 0xFFFFFFFF != checksum:
            raise StoreError(StoreErrorKind.ChecksumMismatch)
        try:
            doc = json.loads(payload)
            self._data = {
                k: ValueEntry(v[0], int(v[1]), float(v[2]), float(v[3]))
                for k, v in doc["data"].items()
            }
            self._version = int(doc["version"])
        except (ValueError, KeyError, IndexError) as e:
            raise StoreError(StoreErrorKind.SnapshotCorrupt, str(e)) from None

    def checksum(self) -> int:
        """Content hash over sorted (key, value, version) (store.rs:464-475)."""
        h = hashlib.blake2s(digest_size=8)
        for k in sorted(self._data):
            e = self._data[k]
            h.update(k.encode())
            h.update(e.value.encode())
            h.update(e.version.to_bytes(8, "little"))
        return int.from_bytes(h.digest(), "little")


# ---------------------------------------------------------------------------
# Bulk binary apply (the block lane's apply plane)
# ---------------------------------------------------------------------------


def apply_ops_bin(store: "KVStore", ops, now: Optional[float] = None) -> list[bytes]:
    """Bulk binary apply: semantics identical to the per-op CRUD calls
    (validation, versioning, stats, notifications when subscribed) with the
    per-op overhead amortized — one clock read per wave, notification
    publish skipped when nobody subscribes, no intermediate KVResult
    objects on the SET fast path. Non-SET / limit-violating ops fall back
    to :func:`apply_op_bin` per op.

    Native stores (:class:`~rabia_tpu_torch.apps.native_store.
    NativeKVStore`) take the statekernel wave path — same records in, byte-identical
    result frames out."""
    if getattr(store, "is_native", False):
        return store.apply_bin_many(ops, now)
    if now is None:
        now = time.time()
    data = store._data
    out: list[bytes] = []
    v = store._version
    bus = store.notifications
    notify = bus is not None and bool(bus._subs)
    cfg = store.config
    max_klen = cfg.max_key_length
    max_val = cfg.max_value_size
    max_keys = cfg.max_keys
    fast_writes = 0
    for b in ops:
        if b[:1] == b"\x01" and len(b) >= 3:
            klen = b[1] | (b[2] << 8)
            vlen = len(b) - 3 - klen
            if 0 < klen <= max_klen and 0 <= vlen <= max_val:
                try:
                    key = b[3 : 3 + klen].decode()
                    value = b[3 + klen :].decode()
                except UnicodeDecodeError:
                    store._version = v
                    out.append(apply_op_bin(store, b))
                    v = store._version
                    continue
                e = data.get(key)
                if e is None:
                    if len(data) >= max_keys:
                        store._version = v
                        out.append(apply_op_bin(store, b))
                        v = store._version
                        continue
                    v += 1
                    data[key] = ValueEntry(value, v, now, now)
                    if notify:
                        store._version = v
                        store._notify(key, ChangeType.Created, None, value)
                else:
                    old = e.value
                    v += 1
                    e.value = value
                    e.version = v
                    e.updated_at = now
                    if notify:
                        store._version = v
                        store._notify(key, ChangeType.Updated, old, value)
                fast_writes += 1
                out.append(b"\x00" + v.to_bytes(4, "little") + b"\x00")
                continue
        store._version = v
        out.append(apply_op_bin(store, b))
        v = store._version
    store._version = v
    store.stats.total_operations += fast_writes
    store.stats.writes += fast_writes
    return out


def apply_op_bin(store: "KVStore", data: bytes) -> bytes:
    """Apply one binary-encoded op against a store; binary result."""
    if getattr(store, "is_native", False):
        return store.apply_bin(data)
    try:
        opcode = data[0]
        klen = int.from_bytes(data[1:3], "little")
        if 3 + klen > len(data):
            return _result_bin(2, 0, f"malformed op: key length {klen} exceeds payload")
        key = data[3 : 3 + klen].decode()
        if opcode == _OP_SET:
            res = store.set(key, data[3 + klen :].decode())
            return _result_bin(0, res.version or 0)
        if opcode == _OP_GET:
            res = store.get(key)
            if res.kind == KVResultKind.NotFound:
                return _result_bin(1, 0)
            return _result_bin(0, res.version or 0, res.value)
        if opcode == _OP_DEL:
            res = store.delete(key)
            if res.kind == KVResultKind.NotFound:
                return _result_bin(1, 0)
            return _result_bin(0, res.version or 0, res.value)
        if opcode == _OP_EXISTS:
            res = store.exists(key)
            return _result_bin(0, 0, res.value or "false")
        if opcode == _OP_CLEAR:
            return _result_bin(0, 0, str(store.clear()))
        if opcode == _OP_CAS:
            if 3 + klen + 8 > len(data):
                return _result_bin(
                    2, 0, "malformed op: cas payload shorter than its "
                    "version field"
                )
            expected = int.from_bytes(
                data[3 + klen : 3 + klen + 8], "little"
            )
            res = store.cas(key, data[3 + klen + 8 :].decode(), expected)
            if res.kind == KVResultKind.NotFound:
                return _result_bin(1, 0)
            if res.kind == KVResultKind.Error:
                return _result_bin(2, res.version or 0, res.error)
            return _result_bin(0, res.version or 0)
        return _result_bin(2, 0, f"unknown opcode {opcode}")
    except StoreError as e:
        return _result_bin(2, 0, str(e))
    except UnicodeDecodeError:
        # canonical text (no codec positions): the native statekernel's
        # validator must produce byte-identical error frames
        return _result_bin(2, 0, "malformed op: invalid utf-8")
    except IndexError as e:
        return _result_bin(2, 0, f"malformed op: {e}")


# ---------------------------------------------------------------------------
# SMR bridge (smr_impl.rs:22-100)
# ---------------------------------------------------------------------------


class KVStoreSMR(TypedStateMachine[KVOperation, KVResult, dict]):
    """Adapts :class:`KVStore` to the typed SMR interface.

    One instance serves ONE shard's consensus log; a sharded deployment runs
    `num_shards` of these behind :class:`ShardedKVService`.

    ``store`` may be a :class:`KVStore` (default) or a native store view
    (:class:`~rabia_tpu_torch.apps.native_store.NativeKVStore`) — the
    typed surface and the binary apply path work identically over either.
    """

    def __init__(
        self, config: Optional[KVStoreConfig] = None, store=None
    ) -> None:
        self.store = store if store is not None else KVStore(config)

    def apply_command(self, command: KVOperation) -> KVResult:
        self._bump_version()
        # apply_operations already folds StoreError into KVResult.err
        return self.store.apply_operations([command])[0]

    def get_state(self) -> dict:
        if getattr(self.store, "is_native", False):
            return self.store.get_state_dict()
        return {k: e.value for k, e in self.store._data.items()}

    def set_state(self, state: dict) -> None:
        if getattr(self.store, "is_native", False):
            self.store.set_state_dict(state)
            return
        self.store._data = {
            k: ValueEntry(v, 0, time.time(), time.time()) for k, v in state.items()
        }

    def encode_command(self, command: KVOperation) -> bytes:
        doc = {
            "op": command.op.value,
            "key": command.key,
            "value": command.value,
        }
        if command.op == KVOpType.Cas:
            doc["expected_version"] = command.expected_version
        return json.dumps(doc, separators=(",", ":")).encode()

    def decode_command(self, data: bytes) -> KVOperation:
        if data[:1] != b"{":
            return decode_op_bin(data)
        try:
            doc = json.loads(data)
            return KVOperation(
                KVOpType(doc["op"]),
                doc.get("key", ""),
                doc.get("value"),
                int(doc.get("expected_version", 0)),
            )
        except (ValueError, KeyError) as e:
            raise StateMachineError(f"bad kv command: {e}") from None

    def encode_response(self, response: KVResult) -> bytes:
        return json.dumps(
            {
                "kind": response.kind.value,
                "value": response.value,
                "version": response.version,
                "error": response.error,
            },
            separators=(",", ":"),
        ).encode()

    def decode_response(self, data: bytes) -> KVResult:
        return decode_kv_response(data)

    def apply_raw(self, data: bytes) -> bytes:
        """Apply one encoded command without the JSON round-trip when it is
        in the compact binary form (the block lane's format); JSON commands
        take the typed path. Response is binary iff the command was."""
        if data[:1] == b"{":
            op = self.decode_command(data)
            return self.encode_response(self.apply_command(op))
        self._bump_version()
        return apply_op_bin(self.store, data)

    def apply_raw_many(self, ops, now: Optional[float] = None) -> list[bytes]:
        """Bulk :meth:`apply_raw` (the block lane's per-shard wave)."""
        if any(b[:1] == b"{" for b in ops):
            return [self.apply_raw(b) for b in ops]
        setattr(
            self,
            "_smr_version",
            getattr(self, "_smr_version", 0) + len(ops),
        )
        return apply_ops_bin(self.store, ops, now)

    def serialize_state(self) -> bytes:
        return self.store.snapshot_bytes()

    def deserialize_state(self, data: bytes) -> None:
        self.store.restore_bytes(data)
