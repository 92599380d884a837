"""ctypes bridge to the native apply plane (native/statekernel.cpp).

The port's copy of the reference's ``rabia_tpu/apps/native_store.py``,
over the port's own build of ``statekernel.cpp``.

The statekernel is an open-addressing byte-key/byte-value KV state
machine in C that consumes decided batches as the SAME binary op records
the wire already carries (apps/kvstore.py encoding: SET/GET/DEL/EXISTS/
CLEAR/CAS) and stages result frames as ``[u32 LE len][payload]`` records
— the ``rt_broadcast_frames`` format — so a whole decided wave applies
in ONE C call with zero per-op Python object materialization.

Two classes:

- :class:`NativeStorePlane` — one replica's plane: owns the C handle for
  ALL shard stores, the SKC_* counter block (zero-copy ndarray view,
  RKC_* conventions) and the FrEvent flight ring (one FRE_APPLY record
  per wave on the C path).
- :class:`NativeKVStore` — the per-shard view implementing the
  :class:`~rabia_tpu_torch.apps.kvstore.KVStore` surface (CRUD, snapshots,
  checksum, stats, notifications) over one store index of a plane.

Semantics owner: the Python binary-op apply in apps/kvstore.py
(``apply_op_bin``/``apply_ops_bin``). ``RABIA_PY_APPLY=1`` forces it;
the conformance gate (testing/conformance.run_ops_on_both_apply_paths +
``fuzz_conformance.py --apply``) pins byte-identical per-op results and
state hashes between the two paths.

Notification semantics: when a store has live subscribers the wave fast
path demotes to a per-op path that fetches the old value before each
mutation and publishes the same :class:`ChangeNotification` stream the
Python store does — correctness over speed on the (rare) subscribed
store; unsubscribed stores never cross into Python per op.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import time
import zlib
from typing import Optional, Sequence

import numpy as np

from rabia_tpu_torch.core.config import KVStoreConfig
from rabia_tpu_torch.apps.kvstore import (
    ChangeNotification,
    ChangeType,
    KVOperation,
    KVOpType,
    KVResult,
    NotificationBus,
    StoreError,
    StoreErrorKind,
    StoreStats,
    ValueEntry,
    decode_result_bin,
    encode_op_bin,
)

# SKC_* counter block names, in index order (statekernel.cpp). Versioned
# append-only like RK_COUNTER_NAMES: newer libraries may expose more
# (ignored), older fewer (read as 0).
SK_COUNTER_NAMES = (
    "waves",
    "ops",
    "sets",
    "gets",
    "dels",
    "exists",
    "clears",
    "cas_hits",
    "cas_misses",
    "errors",
    "bytes_in",
    "bytes_out",
    "rehashes",
    "delta_snapshots",
    "delta_entries",
)

class NativeResultGroup(Sequence):  # type: ignore[type-arg]
    """One batch's per-op result frames as a LAZY view over a wave's
    copied staging buffer (variable-width records; ``offs`` holds record
    starts, payloads skip the 4-byte length prefix). Result bytes
    materialize only when a client actually reads them — the settle path
    stores the view (the FrameSeq idiom of apps/vector_kv.py)."""

    __slots__ = ("raw", "offs", "lo", "n")

    def __init__(self, raw: bytes, offs: list, lo: int, n: int) -> None:
        self.raw = raw
        self.offs = offs
        self.lo = lo
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.n))]
        if i < 0:
            i += self.n
        if not (0 <= i < self.n):
            raise IndexError(i)
        j = self.lo + i
        return self.raw[self.offs[j] + 4 : self.offs[j + 1]]

    def __eq__(self, other) -> bool:
        if not isinstance(other, (list, tuple, Sequence)):
            return NotImplemented
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other)
        )

    def __repr__(self) -> str:
        return f"NativeResultGroup(n={self.n})"


def binary_wave_eligible(
    data, cmd_offsets, shard_starts, n_entries: int, idxs
) -> bool:
    """First-byte binary-op eligibility (opcodes 1..6) over the COVERED
    commands of a wave — the ONE source of the routing rule shared by
    ``NativeStorePlane.apply_block_wave`` and the runtime bridge's wave
    pump (the C runtime mirrors it natively for announces it binds).
    Consensus-critical: proposer and followers must route the same wave
    the same way, so any change here changes the wire-visible behavior.

    A JSON command on a NON-covered index must not demote the wave, and
    zero-length commands are native-eligible (the C kernel emits the
    same "malformed op" frame the Python owner does) — a trailing empty
    command's offset equals ``len(data)``, so they are excluded from the
    first-byte gather."""
    if not len(data):
        return True
    offs = cmd_offsets
    if len(idxs) == n_entries:
        cov = np.arange(len(offs) - 1)
    else:
        cov = np.concatenate(
            [np.arange(shard_starts[i], shard_starts[i + 1]) for i in idxs]
        )
    lens = offs[cov + 1] - offs[cov]
    nonempty = cov[lens > 0]
    first = np.frombuffer(data, np.uint8)[offs[nonempty]]
    return bool(((first >= 1) & (first <= 6)).all())


def native_apply_available() -> bool:
    """True when the statekernel library is loadable and not disabled
    (``RABIA_PY_APPLY=1`` forces the Python apply path)."""
    from rabia_tpu_torch.native.build import load_statekernel

    return load_statekernel() is not None


class NativeStorePlane:
    """One replica's native apply plane: N shard stores behind one C
    handle, applied to with one call per decided wave."""

    def __init__(
        self, n_stores: int, config: Optional[KVStoreConfig] = None
    ) -> None:
        from rabia_tpu_torch.native.build import load_statekernel

        lib = load_statekernel()
        if lib is None:
            raise StoreError(
                StoreErrorKind.Internal, "statekernel unavailable"
            )
        self.lib = lib
        self.config = config or KVStoreConfig()
        self.n_stores = int(n_stores)
        self.handle = lib.sk_plane_create(
            self.n_stores,
            self.config.max_keys,
            self.config.max_key_length,
            self.config.max_value_size,
        )
        if not self.handle:
            raise StoreError(StoreErrorKind.Internal, "sk_plane_create failed")
        # observability: zero-copy view over the C counter block
        n_ctr = int(lib.sk_counters_count())
        self.counters_version = int(lib.sk_counters_version())
        cbuf = (ctypes.c_uint64 * n_ctr).from_address(
            lib.sk_counters(self.handle)
        )
        self.counters = np.frombuffer(cbuf, np.uint64)
        self._stats_buf = np.zeros(3, np.uint64)
        self._stats_ptr = self._stats_buf.ctypes.data
        # flight ring: FrEvent ABI view (obs/flight.FR_DTYPE)
        from rabia_tpu_torch.obs.flight import FR_DTYPE

        self._fr_frozen: Optional[np.ndarray] = None
        if int(lib.sk_flight_record_size()) != FR_DTYPE.itemsize:
            raise StoreError(
                StoreErrorKind.Internal,
                "statekernel flight record ABI mismatch",
            )
        cap = int(lib.sk_flight_cap())
        self.flight_version = int(lib.sk_flight_version())
        fbuf = (ctypes.c_uint8 * (cap * FR_DTYPE.itemsize)).from_address(
            lib.sk_flight(self.handle)
        )
        self._fr_view = np.frombuffer(fbuf, FR_DTYPE)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self.handle:
            self.counters = self.counters.copy()
            self._fr_frozen = self.flight_snapshot()
            h, self.handle = self.handle, None
            self.lib.sk_plane_destroy(h)

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    # -- observability -------------------------------------------------------

    def counter(self, name: str) -> int:
        try:
            i = SK_COUNTER_NAMES.index(name)
        except ValueError:
            return 0
        return int(self.counters[i]) if i < len(self.counters) else 0

    def counters_dict(self) -> dict[str, int]:
        return {
            n: int(self.counters[i]) if i < len(self.counters) else 0
            for i, n in enumerate(SK_COUNTER_NAMES)
        }

    def flight_head(self) -> int:
        if not self.handle:
            return 0
        return int(self.lib.sk_flight_head(self.handle))

    def flight_snapshot(self) -> np.ndarray:
        """Chronological copy of the live ring window (oldest first)."""
        from rabia_tpu_torch.obs.flight import FR_DTYPE

        if self._fr_frozen is not None:
            return self._fr_frozen
        if not self.handle:
            return np.zeros(0, FR_DTYPE)
        head = self.flight_head()
        cap = len(self._fr_view)
        if head <= cap:
            return self._fr_view[:head].copy()
        i = head % cap
        return np.concatenate([self._fr_view[i:], self._fr_view[:i]])

    # -- the wave apply ------------------------------------------------------

    def _slice_results(
        self, group_bounds: Sequence[tuple[int, int]]
    ) -> list[NativeResultGroup]:
        """Staged result frames as lazy per-group views over ONE copy of
        the staging buffer, grouped by (op_lo, op_hi) process-order
        ranges — per-op bytes materialize only on read."""
        lib = self.lib
        total = int(lib.sk_out_count(self.handle))
        # one copy of the staged buffer + plain-int offsets: per-record
        # numpy scalar indexing costs more than the whole C apply
        offs = np.frombuffer(
            (ctypes.c_int64 * total).from_address(
                lib.sk_out_offs(self.handle)
            ),
            np.int64,
        ).tolist()
        raw = (
            ctypes.string_at(lib.sk_out_buf(self.handle), offs[-1])
            if offs[-1]
            else b""
        )
        return [
            NativeResultGroup(raw, offs, lo, hi - lo)
            for lo, hi in group_bounds
        ]

    def staged_results(self) -> tuple[int, int]:
        """(buffer address, byte length) of the last wave's staged result
        records — ``[u32 LE len][payload]`` framing, directly consumable
        by ``rt_broadcast_frames``-style staging. Valid until the next
        apply call — the borrowed pointer is only sound when no native
        runtime thread shares this plane (it applies concurrently);
        bracket with ``sk_plane_lock``/``sk_plane_unlock`` otherwise."""
        lib = self.lib
        total = int(lib.sk_out_count(self.handle))
        if total == 0:
            return 0, 0
        offs = (ctypes.c_int64 * total).from_address(
            lib.sk_out_offs(self.handle)
        )
        return int(lib.sk_out_buf(self.handle)), int(offs[total - 1])

    def apply_block_wave(self, block, idxs, now: float, want_responses: bool):
        """Apply selected covered-indices of a decided PayloadBlock in one
        C call. Returns grouped responses (or None when not wanted), or
        ``NotImplemented`` when the wave has non-binary commands or a
        subscribed store (caller falls back to the Python path)."""
        data = block.data
        offs = np.ascontiguousarray(block.cmd_offsets, np.int64)
        idxs = np.ascontiguousarray(np.asarray(idxs, np.int64))
        shards = np.ascontiguousarray(block.shards, np.int64)
        starts = np.ascontiguousarray(block.shard_starts, np.int64)
        if len(idxs) == 0:
            return [] if want_responses else None
        if not binary_wave_eligible(data, offs, starts, len(shards), idxs):
            return NotImplemented
        # hold the plane lock across the apply AND the result read-out:
        # with the native runtime active, its io/tick thread applies
        # decided waves on this same plane and clears/regrows out_buf —
        # an unlocked window between our apply returning and the slice
        # copy-out would hand back another wave's (or freed) bytes. The
        # plane mutex is recursive, so bracketing the sk call is safe.
        self.lib.sk_plane_lock(self.handle)
        try:
            rc = self.lib.sk_apply_wave(
                self.handle,
                data,
                offs.ctypes.data,
                shards.ctypes.data,
                starts.ctypes.data,
                idxs.ctypes.data,
                len(idxs),
                now,
                1 if want_responses else 0,
            )
            if rc < 0:
                raise StoreError(
                    StoreErrorKind.Internal, f"sk_apply_wave rc={rc}"
                )
            if not want_responses:
                return None
            bounds = []
            pos = 0
            st = starts
            for i in idxs:
                n = int(st[i + 1] - st[i])
                bounds.append((pos, pos + n))
                pos += n
            return self._slice_results(bounds)
        finally:
            self.lib.sk_plane_unlock(self.handle)

    def apply_ops(
        self, store_idx: int, ops: Sequence[bytes], now: float,
        want_responses: bool = True,
    ) -> Optional[list[bytes]]:
        """Apply a list of binary op records against one store (the
        scalar lane / direct-call path); per-op result frames."""
        n = len(ops)
        if n == 0:
            return [] if want_responses else None
        if n == 1:
            data = ops[0]
            offs = np.asarray([0, len(data)], np.int64)
        else:
            data = b"".join(ops)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum([len(o) for o in ops], out=offs[1:])
        # apply + read-out under one plane-lock bracket (see
        # apply_block_wave: the runtime thread shares out_buf)
        self.lib.sk_plane_lock(self.handle)
        try:
            rc = self.lib.sk_apply_ops(
                self.handle,
                store_idx,
                data,
                offs.ctypes.data,
                n,
                now,
                1 if want_responses else 0,
            )
            if rc < 0:
                raise StoreError(
                    StoreErrorKind.Internal, f"sk_apply_ops rc={rc}"
                )
            if not want_responses:
                return None
            return self._slice_results([(0, n)])[0]
        finally:
            self.lib.sk_plane_unlock(self.handle)

    # -- per-store accessors -------------------------------------------------

    def store_size(self, idx: int) -> int:
        return int(self.lib.sk_store_size(self.handle, idx))

    def store_version(self, idx: int) -> int:
        return int(self.lib.sk_store_version(self.handle, idx))

    def set_store_version(self, idx: int, v: int) -> None:
        self.lib.sk_set_version(self.handle, idx, v)

    def store_stats(self, idx: int) -> tuple[int, int, int]:
        self.lib.sk_store_stats(self.handle, idx, self._stats_ptr)
        b = self._stats_buf
        return int(b[0]), int(b[1]), int(b[2])

    def get(self, idx: int, key: bytes):
        """(value bytes, version) or None.

        Bracketed by the plane lock: ``sk_get`` hands out a BORROWED
        value pointer, and under the native engine runtime a GIL-free
        thread may be applying a wave concurrently — the lock keeps the
        bytes alive across the copy-out (uncontended cost is
        nanoseconds)."""
        val = ctypes.c_void_p()
        ver = ctypes.c_uint64()
        self.lib.sk_plane_lock(self.handle)
        try:
            vlen = self.lib.sk_get(
                self.handle, idx, key, len(key),
                ctypes.byref(val), ctypes.byref(ver),
            )
            if vlen < 0:
                return None
            return (
                ctypes.string_at(val.value, vlen) if vlen else b"",
                int(ver.value),
            )
        finally:
            self.lib.sk_plane_unlock(self.handle)

    def export_entries(self, idx: int) -> list[tuple[bytes, bytes, int, float, float]]:
        """All (key, value, version, created, updated) entries of one
        store (arbitrary order; callers sort)."""
        self.lib.sk_plane_lock(self.handle)
        try:
            need = int(self.lib.sk_export_size(self.handle, idx))
            if need <= 0:
                return []
            buf = np.empty(need, np.uint8)
            got = int(
                self.lib.sk_export(self.handle, idx, buf.ctypes.data, need)
            )
        finally:
            self.lib.sk_plane_unlock(self.handle)
        if got < 0:
            raise StoreError(StoreErrorKind.Internal, "sk_export failed")
        raw = buf.tobytes()
        out = []
        pos = 0
        while pos < got:
            klen = int.from_bytes(raw[pos : pos + 4], "little")
            vlen = int.from_bytes(raw[pos + 4 : pos + 8], "little")
            version = int.from_bytes(raw[pos + 8 : pos + 16], "little")
            created = np.frombuffer(raw, np.float64, 1, pos + 16)[0]
            updated = np.frombuffer(raw, np.float64, 1, pos + 24)[0]
            key = raw[pos + 32 : pos + 32 + klen]
            val = raw[pos + 32 + klen : pos + 32 + klen + vlen]
            out.append((key, val, version, float(created), float(updated)))
            pos += 32 + klen + vlen
        return out

    def snapshot_delta(self, idx: int) -> Optional[bytes]:
        """The store's incremental-snapshot frame: entries mutated since
        the last :meth:`snapshot_mark`, plus the deletion log and clear
        flag (statekernel.cpp delta format). Returns None when only a
        FULL snapshot is faithful (deletion-log overflow) — the caller
        falls back to :meth:`export_entries`. Does NOT advance the mark;
        call :meth:`snapshot_mark` once the frame is durable."""
        self.lib.sk_plane_lock(self.handle)
        try:
            need = int(self.lib.sk_snapshot_delta_size(self.handle, idx))
            if need == -3:
                return None
            if need < 0:
                raise StoreError(
                    StoreErrorKind.Internal, "sk_snapshot_delta_size failed"
                )
            buf = np.empty(max(need, 1), np.uint8)
            got = int(
                self.lib.sk_snapshot_delta(
                    self.handle, idx, buf.ctypes.data, need
                )
            )
        finally:
            self.lib.sk_plane_unlock(self.handle)
        if got == -3:
            return None
        if got < 0:
            raise StoreError(StoreErrorKind.Internal, "sk_snapshot_delta failed")
        return buf[:got].tobytes()

    def snapshot_mark(self, idx: int) -> None:
        self.lib.sk_snapshot_mark(self.handle, idx)

    def clear_store(self, idx: int) -> None:
        self.lib.sk_clear_store(self.handle, idx)

    def delete_raw(self, idx: int, key: bytes) -> bool:
        """Restore-path delete: no stats, no version bump, no deletion
        log (the frame being restored already records it)."""
        return self.lib.sk_delete_raw(self.handle, idx, key, len(key)) == 1

    def insert_raw(
        self, idx: int, key: bytes, val: bytes, version: int,
        created: float, updated: float,
    ) -> None:
        rc = self.lib.sk_insert_raw(
            self.handle, idx, key, len(key), val, len(val),
            version, created, updated,
        )
        if rc != 0:
            raise StoreError(
                StoreErrorKind.Internal, f"sk_insert_raw rc={rc}"
            )

    def add_stats(self, idx: int, ops: int, reads: int, writes: int) -> None:
        self.lib.sk_add_stats(self.handle, idx, ops, reads, writes)


class NativeKVStore:
    """Per-shard view of a :class:`NativeStorePlane` implementing the
    :class:`~rabia_tpu_torch.apps.kvstore.KVStore` surface.

    Construct standalone (owns a 1-store plane) or as a shard view
    (``NativeKVStore(config, plane=plane, idx=s)`` — how
    :func:`~rabia_tpu_torch.apps.sharded.make_sharded_kv` builds them).
    """

    is_native = True

    def __init__(
        self,
        config: Optional[KVStoreConfig] = None,
        plane: Optional[NativeStorePlane] = None,
        idx: int = 0,
    ) -> None:
        self.config = config or KVStoreConfig()
        self.plane = plane or NativeStorePlane(1, self.config)
        self.idx = int(idx)
        self.notifications = (
            NotificationBus() if self.config.notifications_enabled else None
        )

    # -- apply plane ---------------------------------------------------------

    def _subscribed(self) -> bool:
        bus = self.notifications
        return bus is not None and bool(bus._subs)

    def apply_bin_many(
        self, ops: Sequence[bytes], now: Optional[float] = None
    ) -> list[bytes]:
        """Apply binary op records in order; binary result frames —
        byte-identical to :func:`~rabia_tpu_torch.apps.kvstore.apply_ops_bin`
        on the Python store (the conformance-pinned contract)."""
        if now is None:
            now = time.time()
        if not self._subscribed():
            return self.plane.apply_ops(self.idx, list(ops), now)
        # subscribed store: per-op so old values can be captured for the
        # notification stream (the Python store's semantics)
        return [self._apply_one_notify(b, now) for b in ops]

    def apply_bin(self, op: bytes, now: Optional[float] = None) -> bytes:
        return self.apply_bin_many([op], now)[0]

    def apply_set_bin_fast(self, b: bytes, now: float) -> Optional[bytes]:
        """KVStore fast-path API parity: one binary SET. Returns None
        only when the op must take a slow path the caller owns (never
        for the native store — the C kernel IS the fast path)."""
        return self.apply_bin(b, now)

    def _apply_one_notify(self, op: bytes, now: float) -> bytes:
        """One op with notification publication (subscribed stores)."""
        bus = self.notifications
        kind = op[0] if op else 0
        key = b""
        old = None
        if kind in (1, 3, 6) and len(op) >= 3:
            klen = op[1] | (op[2] << 8)
            if 3 + klen <= len(op):
                key = op[3 : 3 + klen]
                got = self.plane.get(self.idx, key)
                old = got[0] if got is not None else None
        prev_size = self.plane.store_size(self.idx)
        res = self.plane.apply_ops(self.idx, [op], now)[0]
        if bus is None or res[:1] != b"\x00":
            return res
        version = self.plane.store_version(self.idx)
        try:
            key_s = key.decode()
            old_s = old.decode() if old is not None else None
        except UnicodeDecodeError:  # pragma: no cover - validated upstream
            return res
        if kind in (1, 6):  # SET / CAS applied
            newv = self.plane.get(self.idx, key)
            new_s = newv[0].decode() if newv else None
            bus.publish(
                ChangeNotification(
                    key_s,
                    ChangeType.Updated if old is not None else ChangeType.Created,
                    old_s,
                    new_s,
                    version,
                )
            )
        elif kind == 3 and old is not None:  # DEL hit
            bus.publish(
                ChangeNotification(
                    key_s, ChangeType.Deleted, old_s, None, version
                )
            )
        elif kind == 5 and prev_size >= 0:  # CLEAR
            bus.publish(
                ChangeNotification("", ChangeType.Cleared, None, None, version)
            )
        return res

    # -- CRUD (KVStore API parity; direct/local use) -------------------------

    def _roundtrip(self, op: KVOperation) -> KVResult:
        res = decode_result_bin(self.apply_bin(encode_op_bin(op)))
        if res.kind.value == "error" and res.error:
            # method-call parity: KVStore raises StoreError for
            # validation failures; map the canonical texts back
            # ("StoreError: <kind>[: detail]" — the apply_op_bin str(e)
            # framing)
            text = res.error
            if text.startswith("StoreError: "):
                text = text[len("StoreError: "):]
            head = text.split(":", 1)[0]
            try:
                kind = StoreErrorKind(head)
            except ValueError:
                return res
            if kind in (
                StoreErrorKind.KeyEmpty,
                StoreErrorKind.KeyTooLong,
                StoreErrorKind.ValueTooLarge,
                StoreErrorKind.StoreFull,
            ):
                raise StoreError(
                    kind, text.split(": ", 1)[1] if ": " in text else ""
                )
        return res

    def set(self, key: str, value: str) -> KVResult:
        return self._roundtrip(KVOperation.set(key, value))

    def cas(self, key: str, value: str, expected_version: int) -> KVResult:
        return self._roundtrip(KVOperation.cas(key, value, expected_version))

    def get(self, key: str) -> KVResult:
        return self._roundtrip(KVOperation.get(key))

    def delete(self, key: str) -> KVResult:
        return self._roundtrip(KVOperation.delete(key))

    def exists(self, key: str) -> KVResult:
        return self._roundtrip(KVOperation.exists(key))

    def clear(self) -> int:
        res = self._roundtrip(KVOperation(KVOpType.Clear))
        return int(res.value or 0)

    def get_with_metadata(self, key: str) -> Optional[ValueEntry]:
        kb = key.encode()
        for k, v, ver, created, updated in self.plane.export_entries(self.idx):
            if k == kb:
                return ValueEntry(v.decode(), ver, created, updated)
        return None

    def keys(self, prefix: str = "") -> list[str]:
        ks = sorted(
            k.decode() for k, *_ in self.plane.export_entries(self.idx)
        )
        if prefix:
            return [k for k in ks if k.startswith(prefix)]
        return ks

    def apply_operations(self, ops: Sequence[KVOperation]) -> list[KVResult]:
        out = []
        for op in ops:
            try:
                out.append(self._roundtrip(op))
            except StoreError as e:
                out.append(KVResult.err(str(e)))
        return out

    def size(self) -> int:
        return self.plane.store_size(self.idx)

    def __len__(self) -> int:
        return self.size()

    @property
    def version(self) -> int:
        return self.plane.store_version(self.idx)

    @property
    def stats(self) -> StoreStats:
        ops, reads, writes = self.plane.store_stats(self.idx)
        return StoreStats(
            total_operations=ops, reads=reads, writes=writes,
            keys=self.size(),
        )

    # -- snapshots / integrity (KVStore wire-format parity) ------------------

    def _sorted_entries(self):
        return sorted(
            self.plane.export_entries(self.idx), key=lambda e: e[0].decode()
        )

    def snapshot_bytes(self) -> bytes:
        doc = {
            "version": self.version,
            "data": {
                k.decode(): [v.decode(), ver, created, updated]
                for k, v, ver, created, updated in self._sorted_entries()
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
            items = [
                (k, v[0], int(v[1]), float(v[2]), float(v[3]))
                for k, v in doc["data"].items()
            ]
            version = int(doc["version"])
        except (ValueError, KeyError, IndexError) as e:
            raise StoreError(StoreErrorKind.SnapshotCorrupt, str(e)) from None
        self.plane.clear_store(self.idx)
        for k, v, ver, created, updated in items:
            self.plane.insert_raw(
                self.idx, k.encode(), v.encode(), ver, created, updated
            )
        self.plane.set_store_version(self.idx, version)

    def checksum(self) -> int:
        """Content hash over sorted (key, value, version) — identical to
        :meth:`KVStore.checksum` for identical logical state (the
        conformance gate's state-hash leg)."""
        h = hashlib.blake2s(digest_size=8)
        for k, v, ver, *_ in self._sorted_entries():
            h.update(k)
            h.update(v)
            h.update(ver.to_bytes(8, "little"))
        return int.from_bytes(h.digest(), "little")

    # -- state dict (KVStoreSMR get_state/set_state parity) ------------------

    def get_state_dict(self) -> dict:
        return {
            k.decode(): v.decode()
            for k, v, *_ in self.plane.export_entries(self.idx)
        }

    def set_state_dict(self, state: dict) -> None:
        self.plane.clear_store(self.idx)
        now = time.time()
        for k, v in state.items():
            self.plane.insert_raw(self.idx, k.encode(), v.encode(), 0, now, now)
