"""Columnar vector KV store: the S-axis-native state machine.

A classic dict store applies one Python
operation per command — fine for scalar traffic, but the block lane decides
*thousands* of shards per wave and per-op Python becomes the throughput
wall (SURVEY.md §7.4.4 applies to the apply plane exactly as it does to the
vote plane). This module keeps the whole partitioned store in **columnar
numpy arrays** — one open-addressing hash table over ``(shard, key)`` —
so a decided wave applies as a handful of array ops:

- keys hash with a vectorized splitmix64 fold over fixed-width key lanes;
- probing resolves all wave entries together (per-iteration "unique
  winner" insertion makes concurrent same-slot inserts deterministic and
  preserves wave order for duplicate keys);
- versions are per-shard monotonic counters, assigned columnar;
- responses are built as one structured array and split with ``tolist``.

Semantics match the classic store where they overlap: versioned entries,
per-shard version counters, created/updated timestamps, key/value size
limits. Values are ``bytes`` (the wire-native type); keys up to
``max_key_lanes*8`` bytes live in the table, longer keys fall back to a
dict side-store. No notification bus — the vector store trades the pub/sub
plane for wave throughput (use the classic store when you need
subscriptions).

No reference analog: the reference applies commands one at a time
(rabia-core/src/state_machine.rs:29-52); this is the TPU-first redesign of
that apply plane.

The port's copy of the reference package's ``rabia_tpu/apps/vector_kv.py``,
unchanged but for its imports: responses and snapshot bytes are the
reference's byte for byte (tests/test_torch_blocks_vector_kv.py). It is
the host store the device-resident lane demotes to.
"""

from __future__ import annotations

import copy
import json
import struct
import time
from typing import Optional, Sequence

import numpy as np

from rabia_tpu_torch.apps.kvstore import _result_bin
from rabia_tpu_torch.core.errors import StateMachineError
from rabia_tpu_torch.core.state_machine import Snapshot, StateMachine, VectorStateMachine
from rabia_tpu_torch.core.types import Command, CommandBatch

U64 = np.uint64
_EMPTY, _USED = np.uint8(0), np.uint8(1)

_C1 = U64(0xBF58476D1CE4E5B9)
_C2 = U64(0x94D049BB133111EB)
_GOLD64 = U64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> U64(30))
    x = x * _C1
    x = x ^ (x >> U64(27))
    x = x * _C2
    x = x ^ (x >> U64(31))
    return x


class FrameSeq(Sequence):
    """Flat per-op responses as a lazy view over one fixed-width frame
    buffer — a decided wave's response bytes materialize only when a
    client actually reads them (the settle path stores the view)."""

    __slots__ = ("raw", "width", "n")

    def __init__(self, raw: bytes, width: int, n: int) -> None:
        self.raw = raw
        self.width = width
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
        return self.raw[i * self.width : (i + 1) * self.width]

    def __eq__(self, other) -> bool:
        if not isinstance(other, (list, tuple, Sequence)):
            return NotImplemented
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other)
        )

    def __repr__(self) -> str:
        return f"FrameSeq(n={self.n}, width={self.width})"


class FrameGroups(Sequence):
    """Per-shard response lists over a :class:`FrameSeq`, grouped by
    cumulative op counts — the lazy form of ``_regroup``."""

    __slots__ = ("frames", "bounds")

    def __init__(self, frames: FrameSeq, bounds: np.ndarray) -> None:
        self.frames = frames
        self.bounds = bounds  # i64[k+1] cumulative

    def __len__(self) -> int:
        return len(self.bounds) - 1

    def __getitem__(self, j):
        if isinstance(j, slice):
            return [self[i] for i in range(*j.indices(len(self)))]
        if j < 0:
            j += len(self)
        if not (0 <= j < len(self)):
            raise IndexError(j)
        a, b = int(self.bounds[j]), int(self.bounds[j + 1])
        return [self.frames[i] for i in range(a, b)]

    def __iter__(self):
        # explicit: the Sequence ABC fallback probes __getitem__ through
        # a generic wrapper per element (measurably slow on the ack path)
        frames = self.frames
        bl = self.bounds.tolist()  # one conversion, not 2 numpy reads/group
        for a, b in zip(bl, bl[1:]):
            yield [frames[i] for i in range(a, b)]

    def group_counts(self) -> np.ndarray:
        """i64[k] responses per group WITHOUT materializing any frame —
        the cheap ack count for clients that only need sizes."""
        return np.diff(self.bounds)

    def __eq__(self, other) -> bool:
        if not isinstance(other, (list, tuple, Sequence)):
            return NotImplemented
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other)
        )

    def __repr__(self) -> str:
        return f"FrameGroups(k={len(self)})"


class VectorKVStore:
    """Partitioned columnar KV store (see module doc).

    ``capacity`` is rounded up to a power of two and grows 2x when the
    table passes 70% load. ``max_key_lanes`` 8-byte lanes bound the inline
    key width (default 32 bytes); longer keys use the dict side-store.
    """

    def __init__(
        self,
        num_shards: int,
        capacity: int = 1 << 16,
        max_key_lanes: int = 4,
        max_key_length: int = 256,
        max_value_size: int = 1024 * 1024,
    ) -> None:
        self.num_shards = int(num_shards)
        self.L = int(max_key_lanes)
        self.K = self.L * 8
        self.max_key_length = int(max_key_length)
        self.max_value_size = int(max_value_size)
        C = 1
        while C < capacity:
            C <<= 1
        self._alloc(C)
        self.shard_version = np.zeros(self.num_shards, np.int64)
        self.count = 0
        self._overflow: dict[tuple[int, bytes], list] = {}
        self.total_operations = 0
        self.writes = 0
        self.reads = 0

    def clone(self) -> "VectorKVStore":
        """An independent copy: every column copied (values stay shared
        by reference, as bytes are immutable), the side-store's entries
        copied."""
        out = copy.copy(self)
        for k, v in vars(self).items():
            if isinstance(v, np.ndarray):
                setattr(out, k, v.copy())
        out._overflow = {k: list(v) for k, v in self._overflow.items()}
        return out

    def _alloc(self, C: int) -> None:
        self.C = C
        self._mask = U64(C - 1)
        self.state = np.zeros(C, np.uint8)
        self.key_hash = np.zeros(C, U64)
        self.key_len = np.zeros(C, np.uint16)
        self.key_lanes = np.zeros((C, self.L), U64)
        self.shard_col = np.zeros(C, np.int64)
        # values are stored BY REFERENCE into their arrival buffer
        # (val_buf[s][val_off[s] : val_off[s]+val_len[s]]): a decided block
        # wave stores one shared bytes object + offset/length columns, with
        # zero per-value slicing on the apply path
        self.val_buf = np.empty(C, object)
        self.val_off = np.zeros(C, np.int64)
        self.val_len = np.zeros(C, np.int64)
        self.version = np.zeros(C, np.int64)
        self.created = np.zeros(C, np.float64)
        self.updated = np.zeros(C, np.float64)

    # -- hashing --------------------------------------------------------------

    def _hash(
        self, lanes: np.ndarray, klens: np.ndarray, shards: np.ndarray
    ) -> np.ndarray:
        h = np.full(len(klens), _GOLD64, U64)
        for i in range(self.L):
            h = _mix64(h ^ lanes[:, i])
        h = _mix64(h ^ klens.astype(U64) ^ (shards.astype(U64) << U64(17)))
        return np.where(h == 0, U64(1), h)

    def _lanes_from_keys(self, keys: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """Pack variable-length key bytes into zero-padded uint64 lanes."""
        n = len(keys)
        mat = np.zeros((n, self.K), np.uint8)
        klens = np.zeros(n, np.int64)
        for i, k in enumerate(keys):
            klens[i] = len(k)
            mat[i, : len(k)] = np.frombuffer(k, np.uint8)
        return mat.view(U64).reshape(n, self.L), klens

    # -- bulk write path ------------------------------------------------------

    def bulk_set(
        self,
        shards: np.ndarray,
        lanes: np.ndarray,  # u64[n, L] zero-padded key lanes
        klens: np.ndarray,  # i64[n]
        values,  # list[bytes] in wave order, OR (buffer, voffs, vlens)
        now: Optional[float] = None,
        ranks: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Insert/update n entries in wave order; returns versions i64[n].

        Deterministic across replicas: resolution depends only on table
        state and wave content. Duplicate keys within one wave land in wave
        order (the later op updates the earlier one's slot). ``values`` as
        a ``(buffer, voffs, vlens)`` triple stores by reference with no
        per-value slicing (the block lane's path); ``buffer`` is one
        shared bytes object or an object array of per-op buffers.
        ``ranks`` overrides the
        per-op occurrence index used for version assignment (count of
        PRIOR ops on the same shard within this call) — required when
        equal shards are NOT contiguous runs, e.g. several concatenated
        waves (``apply_block_multi``); the default derivation assumes
        shard-major wave order.
        """
        if now is None:
            now = time.time()
        n = len(klens)
        if n == 0:
            return np.zeros(0, np.int64)
        if isinstance(values, tuple) and len(values[2]):
            if int(np.max(values[2])) > self.max_value_size:
                raise StateMachineError("value exceeds max_value_size")
        elif not isinstance(values, tuple):
            if any(len(v) > self.max_value_size for v in values):
                raise StateMachineError("value exceeds max_value_size")
        if (self.count + n) * 10 > self.C * 7:
            # size the growth to DEMAND: a single wave can exceed one
            # doubling, and an exhausted probe loop would leave half-
            # inserted ghost slots behind
            needed = self.count + n
            self._grow(
                max(self.C * 2, 1 << max(10, (needed * 2 - 1).bit_length()))
            )
        h = self._hash(lanes, klens, shards)
        slot = self._probe_or_insert(h, shards, lanes, klens, now)
        # versions: per-shard counters advance one per op, wave order
        # (shard-major waves make ranks the run offsets)
        base = self.shard_version[shards]
        rank = ranks if ranks is not None else self._run_ranks(shards)
        vers = base + rank + 1
        np.add.at(self.shard_version, shards, 1)
        # scatter payload columns (duplicate slots: numpy fancy assignment
        # applies in array order == wave order, so the last write wins)
        if isinstance(values, tuple):
            buffer, voffs, vlens = values
            self.val_buf[slot] = buffer
            self.val_off[slot] = voffs
            self.val_len[slot] = vlens
        else:
            vals_obj = np.empty(n, object)
            vals_obj[:] = values
            self.val_buf[slot] = vals_obj
            self.val_off[slot] = 0
            self.val_len[slot] = np.fromiter(
                (len(v) for v in values), np.int64, n
            )
        self.version[slot] = vers
        self.updated[slot] = now
        self.total_operations += n
        self.writes += n
        return vers

    def _value_at(self, s: int) -> bytes:
        buf = self.val_buf[s]
        a = int(self.val_off[s])
        b = a + int(self.val_len[s])
        if a == 0 and b == len(buf):
            return buf
        return buf[a:b]

    @staticmethod
    def _run_ranks(shards: np.ndarray) -> np.ndarray:
        n = len(shards)
        if n == 1:
            return np.zeros(1, np.int64)
        idx = np.arange(n)
        run_start = np.empty(n, bool)
        run_start[0] = True
        np.not_equal(shards[1:], shards[:-1], out=run_start[1:])
        return idx - np.maximum.accumulate(np.where(run_start, idx, 0))

    def _probe_or_insert(
        self,
        h: np.ndarray,
        shards: np.ndarray,
        lanes: np.ndarray,
        klens: np.ndarray,
        now: float,
    ) -> np.ndarray:
        """Resolve every wave entry to a table slot, inserting fresh keys.

        Linear probing; per iteration, unresolved entries targeting empty
        slots insert with a deterministic "first occurrence wins" rule and
        losers re-check the (now used) slot next iteration.
        """
        n = len(h)
        idx = (h & self._mask).astype(np.int64)
        slot_out = np.full(n, -1, np.int64)
        live = np.arange(n)
        for _ in range(self.C):
            st = self.state[idx]
            used = st == _USED
            match = used & (self.key_hash[idx] == h[live])
            if match.any():
                m = np.nonzero(match)[0]
                keep = (
                    (self.shard_col[idx[m]] == shards[live[m]])
                    & (self.key_len[idx[m]] == klens[live[m]])
                    & (self.key_lanes[idx[m]] == lanes[live[m]]).all(axis=1)
                )
                match[m[~keep]] = False
            empty = ~used
            if empty.any():
                cand = np.nonzero(empty)[0]
                # first occurrence per target slot wins the insert
                _, first = np.unique(idx[cand], return_index=True)
                w = cand[np.sort(first)]
                tgt = idx[w]
                self.state[tgt] = _USED
                self.key_hash[tgt] = h[live[w]]
                self.key_len[tgt] = klens[live[w]]
                self.key_lanes[tgt] = lanes[live[w]]
                self.shard_col[tgt] = shards[live[w]]
                self.version[tgt] = 0
                self.created[tgt] = now
                self.count += len(w)
                match[w] = True  # resolved as (fresh) slots
            resolved = match
            slot_out[live[resolved]] = idx[resolved]
            if resolved.all():
                return slot_out
            keep = ~resolved
            live = live[keep]
            # losers whose target just got used by the SAME key re-check the
            # slot next iteration (duplicate keys within one wave resolve as
            # updates, wave order); everything else advances. The re-check
            # must be a FULL key compare — a mere hash match would loop
            # forever on hash-colliding distinct keys.
            idx = idx[keep]
            again = self.state[idx] == _USED
            still_mine = (
                again
                & (self.key_hash[idx] == h[live])
                & (self.shard_col[idx] == shards[live])
                & (self.key_len[idx] == klens[live])
                & (self.key_lanes[idx] == lanes[live]).all(axis=1)
            )
            advance = ~still_mine
            idx = np.where(
                advance,
                ((idx.astype(U64) + U64(1)) & self._mask).astype(np.int64),
                idx,
            )
        raise StateMachineError("vector store probe loop exhausted (table full)")

    # -- bulk read/delete -----------------------------------------------------

    def _lookup(
        self, shards: np.ndarray, lanes: np.ndarray, klens: np.ndarray
    ) -> np.ndarray:
        """Slot per entry, -1 where absent (no mutation)."""
        n = len(klens)
        h = self._hash(lanes, klens, shards)
        idx = (h & self._mask).astype(np.int64)
        out = np.full(n, -1, np.int64)
        live = np.arange(n)
        for _ in range(self.C):
            st = self.state[idx]
            used = st == _USED
            miss = ~used
            match = used & (self.key_hash[idx] == h[live])
            if match.any():
                m = np.nonzero(match)[0]
                keep = (
                    (self.shard_col[idx[m]] == shards[live[m]])
                    & (self.key_len[idx[m]] == klens[live[m]])
                    & (self.key_lanes[idx[m]] == lanes[live[m]]).all(axis=1)
                )
                match[m[~keep]] = False
            out[live[match]] = idx[match]
            resolved = match | miss
            if resolved.all():
                return out
            keep = ~resolved
            live, idx = live[keep], idx[keep]
            idx = ((idx.astype(U64) + U64(1)) & self._mask).astype(np.int64)
        return out

    def bulk_get(
        self, shards: np.ndarray, lanes: np.ndarray, klens: np.ndarray
    ) -> tuple[np.ndarray, list]:
        """(versions i64[n] with -1 for missing, values list)."""
        slot = self._lookup(shards, lanes, klens)
        found = slot >= 0
        vers = np.where(found, self.version[np.maximum(slot, 0)], -1)
        vals = [
            self._value_at(s) if s >= 0 else None for s in slot.tolist()
        ]
        self.total_operations += len(klens)
        self.reads += len(klens)
        return vers, vals

    # -- grow -----------------------------------------------------------------

    def _grow(self, new_capacity: int) -> None:
        old_state = self.state
        old = (
            self.key_hash,
            self.key_len,
            self.key_lanes,
            self.shard_col,
            self.val_buf,
            self.val_off,
            self.val_len,
            self.version,
            self.created,
            self.updated,
        )
        used = np.nonzero(old_state == _USED)[0]
        self._alloc(new_capacity)
        self.count = 0
        if len(used) == 0:
            return
        kh = old[0][used]
        kl = old[1][used]
        lanes = old[2][used]
        shards = old[3][used]
        slot = self._probe_or_insert(
            kh, shards, lanes, kl.astype(np.int64), 0.0
        )
        self.val_buf[slot] = old[4][used]
        self.val_off[slot] = old[5][used]
        self.val_len[slot] = old[6][used]
        self.version[slot] = old[7][used]
        self.created[slot] = old[8][used]
        self.updated[slot] = old[9][used]

    # -- scalar conveniences (tests / service reads) --------------------------

    def set(self, shard: int, key: bytes, value: bytes) -> int:
        if len(key) > self.K:
            return self._overflow_set(shard, key, value)
        lanes, klens = self._lanes_from_keys([key])
        return int(
            self.bulk_set(np.array([shard], np.int64), lanes, klens, [value])[0]
        )

    def get(self, shard: int, key: bytes) -> Optional[tuple[bytes, int]]:
        if len(key) > self.K:
            ent = self._overflow.get((shard, key))
            return (ent[0], ent[1]) if ent else None
        lanes, klens = self._lanes_from_keys([key])
        vers, vals = self.bulk_get(np.array([shard], np.int64), lanes, klens)
        if vers[0] < 0:
            return None
        return vals[0], int(vers[0])

    def delete(self, shard: int, key: bytes) -> bool:
        """Tombstone-free delete: relocate the trailing cluster (classic
        open-addressing backward shift) — scalar path, deletes are rare."""
        if len(key) > self.K:
            if self._overflow.pop((shard, key), None) is None:
                return False
            self.shard_version[shard] += 1
            self.total_operations += 1
            self.writes += 1
            return True
        lanes, klens = self._lanes_from_keys([key])
        slot = self._lookup(np.array([shard], np.int64), lanes, klens)
        s = int(slot[0])
        if s < 0:
            return False
        self.total_operations += 1
        self.writes += 1
        self.shard_version[shard] += 1
        self.count -= 1
        # backward-shift deletion keeps probe chains intact
        i = s
        while True:
            self.state[i] = _EMPTY
            j = i
            while True:
                j = (j + 1) & int(self._mask)
                if self.state[j] != _USED:
                    return True
                home = int(self.key_hash[j] & self._mask)
                # can entry j move into the hole at i?
                if (i <= j and (home <= i or home > j)) or (
                    i > j and (home <= i and home > j)
                ):
                    self._move_entry(j, i)
                    i = j
                    break

    def _move_entry(self, src: int, dst: int) -> None:
        self.state[dst] = self.state[src]
        self.key_hash[dst] = self.key_hash[src]
        self.key_len[dst] = self.key_len[src]
        self.key_lanes[dst] = self.key_lanes[src]
        self.shard_col[dst] = self.shard_col[src]
        self.val_buf[dst] = self.val_buf[src]
        self.val_off[dst] = self.val_off[src]
        self.val_len[dst] = self.val_len[src]
        self.version[dst] = self.version[src]
        self.created[dst] = self.created[src]
        self.updated[dst] = self.updated[src]

    def _overflow_set(self, shard: int, key: bytes, value: bytes) -> int:
        if len(key) > self.max_key_length:
            raise StateMachineError("key too long")
        if len(value) > self.max_value_size:
            raise StateMachineError("value exceeds max_value_size")
        self.shard_version[shard] += 1
        v = int(self.shard_version[shard])
        now = time.time()
        ent = self._overflow.get((shard, key))
        if ent is None:
            self._overflow[(shard, key)] = [value, v, now, now]
        else:
            ent[0], ent[1], ent[3] = value, v, now
        self.total_operations += 1
        self.writes += 1
        return v

    def __len__(self) -> int:
        return self.count + len(self._overflow)

    # -- snapshot -------------------------------------------------------------

    def snapshot_bytes(self) -> bytes:
        used = np.nonzero(self.state == _USED)[0]
        # deterministic order: sort by (shard, key)
        if len(used):
            order = np.lexsort(
                (self.key_hash[used], self.shard_col[used])
            )
            used = used[order]
        parts = [struct.pack("<QI", len(used), self.num_shards)]
        parts.append(self.shard_version.tobytes())
        for s in used.tolist():
            klen = int(self.key_len[s])
            key = self.key_lanes[s].tobytes()[:klen]
            val = self._value_at(s)
            parts.append(
                struct.pack("<iHIqdd", int(self.shard_col[s]), klen, len(val),
                            int(self.version[s]), float(self.created[s]),
                            float(self.updated[s]))
            )
            parts.append(key)
            parts.append(val)
        over = [
            {
                "shard": sh,
                "key": key.hex(),
                "value": ent[0].hex(),
                "version": ent[1],
                "created": ent[2],
                "updated": ent[3],
            }
            for (sh, key), ent in sorted(self._overflow.items())
        ]
        parts.append(json.dumps(over).encode())
        return b"".join(parts)

    @staticmethod
    def _parse_snapshot(raw: bytes):
        """(shard_versions i64[N], rows, overflow_docs) where rows =
        (shards, keys, vals, vers, created, updated) parallel lists."""
        n, num_shards = struct.unpack_from("<QI", raw, 0)
        off = 12
        shard_versions = np.frombuffer(raw, np.int64, num_shards, offset=off).copy()
        off += 8 * num_shards
        shards, keys, vals, vers, created, updated = [], [], [], [], [], []
        head = struct.calcsize("<iHIqdd")
        for _ in range(n):
            sh, klen, vlen, ver, cr, up = struct.unpack_from("<iHIqdd", raw, off)
            off += head
            keys.append(raw[off : off + klen])
            off += klen
            vals.append(raw[off : off + vlen])
            off += vlen
            shards.append(sh)
            vers.append(ver)
            created.append(cr)
            updated.append(up)
        over = json.loads(raw[off:].decode()) if off < len(raw) else []
        return shard_versions, (shards, keys, vals, vers, created, updated), over

    def _bulk_load(self, rows) -> None:
        """Insert parsed rows into the (fresh) table."""
        shards, keys, vals, vers, created, updated = rows
        n = len(keys)
        if not n:
            return
        lanes, klens = self._lanes_from_keys(keys)
        sh_arr = np.asarray(shards, np.int64)
        if (self.count + n) * 10 > self.C * 7:
            self._grow(1 << max(10, ((self.count + n) * 2 - 1).bit_length()))
        h = self._hash(lanes, klens, sh_arr)
        slot = self._probe_or_insert(h, sh_arr, lanes, klens, 0.0)
        vo = np.empty(n, object)
        vo[:] = vals
        self.val_buf[slot] = vo
        self.val_off[slot] = 0
        self.val_len[slot] = np.fromiter((len(v) for v in vals), np.int64, n)
        self.version[slot] = np.asarray(vers, np.int64)
        self.created[slot] = np.asarray(created)
        self.updated[slot] = np.asarray(updated)

    def _absorb_overflow_docs(self, over, adopt=None) -> None:
        """Decode overflow entries into the side-store (optionally only
        the shards in ``adopt``) — one place owns the doc format."""
        for doc in over:
            if adopt is not None and doc["shard"] not in adopt:
                continue
            self._overflow[(doc["shard"], bytes.fromhex(doc["key"]))] = [
                bytes.fromhex(doc["value"]),
                doc["version"],
                doc["created"],
                doc["updated"],
            ]

    def restore_bytes(self, raw: bytes) -> None:
        shard_versions, rows, over = self._parse_snapshot(raw)
        self.num_shards = len(shard_versions)
        self.shard_version = shard_versions
        self._alloc(max(self.C, 1 << 10))
        self.count = 0
        self._overflow = {}
        self._bulk_load(rows)
        self._absorb_overflow_docs(over)

    def restore_shards_bytes(self, raw: bytes, shard_ids) -> None:
        """Replace ONLY the given shards' entries/counters from the
        snapshot, keeping every other shard's current state (sync adoption
        under mixed per-shard progress).

        Kept rows re-insert VECTORIZED from their stored hashes/lanes (the
        ``_grow`` pattern) — a per-row Python loop over a large store
        would stall the engine's event loop mid-sync."""
        adopt = set(int(s) for s in shard_ids)
        shard_versions, rows, over = self._parse_snapshot(raw)
        used = np.nonzero(self.state == _USED)[0]
        keep = used[
            ~np.isin(self.shard_col[used], np.asarray(sorted(adopt), np.int64))
        ]
        kept = (
            self.key_hash[keep].copy(),
            self.key_len[keep].copy(),
            self.key_lanes[keep].copy(),
            self.shard_col[keep].copy(),
            self.val_buf[keep].copy(),
            self.val_off[keep].copy(),
            self.val_len[keep].copy(),
            self.version[keep].copy(),
            self.created[keep].copy(),
            self.updated[keep].copy(),
        )
        kept_overflow = {
            k: v for k, v in self._overflow.items() if k[0] not in adopt
        }
        self._alloc(max(self.C, 1 << 10))
        self.count = 0
        self._overflow = kept_overflow
        if len(keep):
            needed = len(keep)
            if needed * 10 > self.C * 7:
                self._grow(1 << max(10, (needed * 2 - 1).bit_length()))
            slot = self._probe_or_insert(
                kept[0], kept[3], kept[2], kept[1].astype(np.int64), 0.0
            )
            self.val_buf[slot] = kept[4]
            self.val_off[slot] = kept[5]
            self.val_len[slot] = kept[6]
            self.version[slot] = kept[7]
            self.created[slot] = kept[8]
            self.updated[slot] = kept[9]
        # adopted shards come from the snapshot rows
        adopted_rows = tuple(
            [rows[j][i] for i in range(len(rows[0])) if int(rows[0][i]) in adopt]
            for j in range(6)
        )
        self._bulk_load(adopted_rows)
        self._absorb_overflow_docs(over, adopt)
        for s in adopt:
            if s < len(shard_versions) and s < len(self.shard_version):
                self.shard_version[s] = shard_versions[s]


# ---------------------------------------------------------------------------
# State machine adapter
# ---------------------------------------------------------------------------

_RESP_DT = np.dtype([("kind", "u1"), ("version", "<u4"), ("has", "u1")])


class VectorShardedKV(StateMachine, VectorStateMachine):
    """Engine-facing SM over :class:`VectorKVStore`.

    Block waves of binary SET ops apply fully vectorized (key windows
    gathered from the block's command buffer, one hash/probe/scatter pass,
    responses via one structured array). Non-SET ops and scalar batches
    take a per-op path with identical semantics. Command format is the
    binary kv op codec (rabia_tpu_torch.apps.kvstore).
    """

    def __init__(self, num_shards: int, capacity: int = 1 << 16) -> None:
        self.store = VectorKVStore(num_shards, capacity=capacity)
        self.num_shards = int(num_shards)
        self._version = 0

    # -- block lane -----------------------------------------------------------

    def _decode_cols(
        self, block, idxs: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Flat (counts, op_shards, op_off, op_len) for the selected
        shard entries, wave order; offsets index the block's own data."""
        counts = block.counts[idxs]
        cmd_idx = (
            np.repeat(block.shard_starts[idxs], counts)
            + _concat_ranges(counts)
        )
        op_shards = np.repeat(block.shards[idxs], counts)
        op_off = block.cmd_offsets[cmd_idx]
        op_len = block.cmd_sizes[cmd_idx]
        return counts, op_shards, op_off, op_len

    def _pad_buf(self, raw: bytes) -> np.ndarray:
        data = np.frombuffer(raw, np.uint8)
        pad = np.zeros(self.store.K + 3, np.uint8)
        return np.concatenate([data, pad])

    def _set_mask(
        self,
        dbuf: np.ndarray,
        op_off: np.ndarray,
        op_len: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(klen i64[n], well-formed-SET mask bool[n])."""
        opcode = dbuf[op_off]
        klen = dbuf[op_off + 1].astype(np.int64) | (
            dbuf[op_off + 2].astype(np.int64) << 8
        )
        is_set = (
            (opcode == 1)
            & (op_len >= 3)
            & (klen > 0)
            & (klen <= self.store.K)
            & (3 + klen <= op_len)
            & (op_len - 3 - klen <= self.store.max_value_size)
        )
        return klen, is_set

    @staticmethod
    def _regroup(resp, counts: np.ndarray):
        """Regroup flat per-op responses per covered shard (lazily when
        the flat responses are a frame view)."""
        if isinstance(resp, FrameSeq):
            bounds = np.zeros(len(counts) + 1, np.int64)
            np.cumsum(counts, out=bounds[1:])
            return FrameGroups(resp, bounds)
        if bool((counts == 1).all()):
            return [[r] for r in resp]
        out: list[list[bytes]] = []
        pos = 0
        for c in counts.tolist():
            out.append(resp[pos : pos + c])
            pos += c
        return out

    def apply_block(
        self, block, idxs, want_responses: bool = True
    ) -> Optional[list[list[bytes]]]:
        idxs = np.asarray(idxs, np.int64)
        counts, op_shards, op_off, op_len = self._decode_cols(block, idxs)
        dbuf = self._pad_buf(block.data)
        klen, is_set = self._set_mask(dbuf, op_off, op_len)
        self._version += len(idxs)
        if bool(is_set.all()):
            resp = self._apply_sets(
                op_shards, dbuf, op_off, op_len, klen, block.data,
                want_responses,
            )
        else:
            resp = self._apply_mixed(
                op_shards, is_set, dbuf, op_off, op_len, klen, block.data
            )
        if resp is None:
            return None
        return self._regroup(resp, counts)

    def apply_block_multi(
        self, blocks, idxs_list, want_responses: bool = True
    ) -> Optional[list[Optional[list[list[bytes]]]]]:
        """Apply several decided waves (wave order = list order) in ONE
        vectorized pass when every op is a well-formed SET — the
        full-width block lane's bulk-write shape. Anything else falls
        back to sequential :meth:`apply_block` calls, preserving each
        wave's op-ordering semantics; on that path a wave that fails
        deterministically yields an ``Exception`` as ITS list entry
        (waves already applied keep their responses — per-wave failure
        granularity, matching sequential apply).

        Precondition (the block-lane invariant ``submit_block`` enforces):
        a block's covered shards are unique within that block — the
        cross-wave version ranks are derived from it.
        """
        if len(blocks) == 1:
            return [self.apply_block(blocks[0], idxs_list[0], want_responses)]
        per: list[tuple] = []
        ranks_parts: list[np.ndarray] = []
        prior = np.zeros(self.num_shards, np.int64)
        set_only = True
        for block, idxs in zip(blocks, idxs_list):
            idxs = np.asarray(idxs, np.int64)
            counts, op_shards, op_off, op_len = self._decode_cols(block, idxs)
            dbuf_j = self._pad_buf(block.data)
            klen_j, is_set_j = self._set_mask(dbuf_j, op_off, op_len)
            if not bool(is_set_j.all()):
                set_only = False
                break  # fallback path re-decodes per block anyway
            # occurrence rank = ops on the same shard in PRIOR waves +
            # the within-wave run offset (runs are contiguous per block)
            ranks_parts.append(
                prior[op_shards] + VectorKVStore._run_ranks(op_shards)
            )
            prior[block.shards[idxs]] += counts
            per.append(
                (idxs, counts, op_shards, op_off, op_len, klen_j, dbuf_j,
                 block.data)
            )
        if not set_only:
            # mixed waves: sequential applies keep cross-wave read/write
            # ordering exact (no mutation has happened yet). A wave that
            # fails deterministically becomes ITS entry's exception —
            # earlier waves' commits stay settled with real responses.
            out_seq: list = []
            for b, i in zip(blocks, idxs_list):
                try:
                    out_seq.append(self.apply_block(b, i, want_responses))
                except Exception as e:  # deterministic app failure
                    out_seq.append(e)
            return out_seq
        # ONE bulk_set over the concatenated columns. Keys gather from
        # each block's own padded buffer (already built for the SET
        # check); values reference each op's OWN block buffer through an
        # object column — retention per block, exactly like sequential
        # apply (no multi-wave buffer pinning, no payload concatenation).
        op_shards = np.concatenate([p[2] for p in per])
        klen = np.concatenate([p[5] for p in per])
        lanes = np.concatenate(
            [self._lanes_of(p[6], p[3], p[5]) for p in per]
        )
        voffs = np.concatenate([p[3] + 3 + p[5] for p in per])
        vlens = np.concatenate([p[4] - 3 - p[5] for p in per])
        n_total = len(op_shards)
        vbufs = np.empty(n_total, object)
        pos = 0
        for p in per:
            k = len(p[2])
            vbufs[pos : pos + k] = p[7]  # object scalar: one ref per op
            pos += k
        self._version += sum(len(p[0]) for p in per)
        vers = self.store.bulk_set(
            op_shards, lanes, klen, (vbufs, voffs, vlens),
            ranks=np.concatenate(ranks_parts),
        )
        if not want_responses:
            return None
        resp = self._vers_frames(vers)
        # per-block groups index the ONE flat frame view with absolute
        # bounds — no per-block slicing or copying
        out: list = []
        pos = 0
        for _idxs, counts, *_rest in per:
            tot = int(counts.sum())
            bounds = np.full(len(counts) + 1, pos, np.int64)
            bounds[1:] += np.cumsum(counts)
            out.append(FrameGroups(resp, bounds))
            pos += tot
        return out

    def _lanes_of(
        self, dbuf: np.ndarray, op_off: np.ndarray, klen: np.ndarray
    ) -> np.ndarray:
        """Zero-padded u64 key lanes [n, L] gathered from ``dbuf``; the
        gather only spans the widest ACTUAL key (Ku), zero-filling the
        rest — keys are usually far shorter than the table's max width."""
        n = len(op_off)
        K = self.store.K
        Ku = int(klen.max()) if n else 0
        if Ku < K:
            small = dbuf[(op_off + 3)[:, None] + np.arange(Ku)[None, :]]
            small = np.where(np.arange(Ku)[None, :] < klen[:, None], small, 0)
            win = np.zeros((n, K), np.uint8)
            win[:, :Ku] = small
        else:
            win = dbuf[(op_off + 3)[:, None] + np.arange(K)[None, :]]
            win = np.where(np.arange(K)[None, :] < klen[:, None], win, 0)
        return np.ascontiguousarray(win).view(U64).reshape(n, self.store.L)

    @staticmethod
    def _vers_frames(vers: np.ndarray) -> FrameSeq:
        """Version responses as n fixed 6-byte frames behind a lazy view
        (tobytes once; per-frame bytes slice on client read)."""
        arr = np.zeros(len(vers), _RESP_DT)
        arr["version"] = vers.astype(np.uint32)
        return FrameSeq(arr.tobytes(), 6, len(vers))

    def _apply_sets(
        self, op_shards, dbuf, op_off, op_len, klen, raw: bytes,
        want_responses: bool = True,
    ) -> Optional[list[bytes]]:
        lanes = self._lanes_of(dbuf, op_off, klen)
        vers = self.store.bulk_set(
            op_shards, lanes, klen,
            (raw, op_off + 3 + klen, op_len - 3 - klen),
        )
        if not want_responses:
            return None
        return self._vers_frames(vers)

    def _apply_mixed(
        self, op_shards, is_set, dbuf, op_off, op_len, klen, raw: bytes
    ) -> list[bytes]:
        resp: list[Optional[bytes]] = [None] * len(op_off)
        set_idx = np.nonzero(is_set)[0]
        if len(set_idx):
            sub = self._apply_sets(
                op_shards[set_idx],
                dbuf,
                op_off[set_idx],
                op_len[set_idx],
                klen[set_idx],
                raw,
            )
            for i, r in zip(set_idx.tolist(), sub):
                resp[i] = r
        rest = np.nonzero(~is_set)[0]
        if len(rest):
            kl = klen[rest]
            is_get = (
                (dbuf[op_off[rest]] == 2)
                & (3 + kl <= op_len[rest])
                & (kl <= self.store.K)
            )
            if bool(is_get.all()):
                # every other op is a well-formed GET of a table-width
                # key: one vectorized lookup answers them all, each as
                # _apply_one answers it (a GET wave on the host lane)
                for i, r in zip(
                    rest.tolist(),
                    self._apply_gets(op_shards[rest], dbuf, op_off[rest], kl),
                ):
                    resp[i] = r
                return resp  # type: ignore[return-value]
        for i in rest.tolist():
            a, b = int(op_off[i]), int(op_off[i] + op_len[i])
            resp[i] = self._apply_one(int(op_shards[i]), raw[a:b])
        return resp  # type: ignore[return-value]

    def _apply_gets(
        self, op_shards, dbuf, op_off, klen
    ) -> list[bytes]:
        """Well-formed GETs of keys at most the table's key width, in one
        ``bulk_get``: the responses (and read counters) of one
        :meth:`_apply_one` a GET. The port's addition: the reference's
        host lane answers a GET wave op by op."""
        lanes = self._lanes_of(dbuf, op_off, klen)
        vers, vals = self.store.bulk_get(op_shards, lanes, klen)
        out: list[bytes] = []
        for ver, val in zip(vers.tolist(), vals):
            if ver < 0:
                out.append(_result_bin(1, 0))
                continue
            try:
                text = val.decode("utf-8")
            except UnicodeDecodeError:
                out.append(_result_bin(2, ver, "value is not utf-8 text"))
                continue
            out.append(_result_bin(0, ver, text))
        return out

    def _apply_one(self, shard: int, op: bytes) -> bytes:
        try:
            code = op[0]
            klen = int.from_bytes(op[1:3], "little")
            if 3 + klen > len(op):
                return _result_bin(
                    2, 0, f"malformed op: key length {klen} exceeds payload"
                )
            key = op[3 : 3 + klen]
            if code == 1:  # SET
                if len(key) > self.store.K:
                    v = self.store._overflow_set(shard, key, op[3 + klen :])
                else:
                    v = self.store.set(shard, key, op[3 + klen :])
                return _result_bin(0, v)
            if code == 2:  # GET
                got = self.store.get(shard, key)
                if got is None:
                    return _result_bin(1, 0)
                val, ver = got
                try:
                    text = val.decode("utf-8")
                except UnicodeDecodeError:
                    # the store holds raw bytes; the text-result wire form
                    # must not silently mangle them
                    return _result_bin(2, ver, "value is not utf-8 text")
                return _result_bin(0, ver, text)
            if code == 3:  # DEL
                ok = self.store.delete(shard, key)
                return _result_bin(0 if ok else 1, 0)
            if code == 4:  # EXISTS
                found = self.store.get(shard, key) is not None
                return _result_bin(0, 0, "true" if found else "false")
            return _result_bin(2, 0, f"unknown opcode {code}")
        except (IndexError, StateMachineError) as e:
            return _result_bin(2, 0, str(e))

    # -- scalar lane ----------------------------------------------------------

    def apply_command(self, command: Command) -> bytes:
        self._version += 1
        batch_shard = 0
        return self._apply_one(batch_shard, command.data)

    def apply_batch(self, batch: CommandBatch) -> list[bytes]:
        self._version += 1
        s = int(batch.shard) % self.num_shards
        return [self._apply_one(s, c.data) for c in batch.commands]

    # -- snapshot -------------------------------------------------------------

    def create_snapshot(self) -> Snapshot:
        return Snapshot.create(self._version, self.store.snapshot_bytes())

    def restore_snapshot(self, snapshot: Snapshot) -> None:
        snapshot.verify()
        self.store.restore_bytes(snapshot.data)
        self._version = snapshot.version

    def restore_shards(self, snapshot: Snapshot, shard_ids) -> None:
        """Per-shard sync adoption (see ShardedStateMachine.restore_shards)."""
        snapshot.verify()
        self.store.restore_shards_bytes(snapshot.data, shard_ids)
        self._version = max(self._version, snapshot.version)

    def get_state_summary(self) -> str:
        return f"{len(self.store)} keys / {self.num_shards} shards (vector)"


def _concat_ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for the per-shard command offsets."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out
