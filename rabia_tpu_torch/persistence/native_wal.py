"""Native durability plane: WAL of decided waves + incremental snapshots.

The write-ahead log records every decided wave (shard, slot, value, batch
id, binary op records) as CRC-framed records in rotated segment files,
appended from the apply paths — runtime.cpp's decide→apply stage on the
native engine runtime, the asyncio apply plane otherwise — with
group-commit batching: one fsync on a dedicated flush thread covers every
record staged while the previous fsync ran, so neither the GIL-free
io/tick thread nor the asyncio loop ever blocks on disk. The vote-barrier
write-ahead (core/persistence.py aux blob) rides the same lane as kind-2
records, which is what lets the native runtime engage on a durable
cluster at all.

Checkpoints are *incremental*: the statekernel tracks per-entry mutation
epochs (statekernel.cpp dirty tracking), so ``sk_snapshot_delta`` emits
only the entries touched since the last checkpoint, written as compact
snapshot frames into a ``snap-XXXXXXXX.dat`` chain; the WAL prefix up to
the snapshot frontier is then garbage-collected. Recovery is
snapshot-chain restore + WAL replay through the same apply path
(``sm.apply_batch`` → ``sk_apply_wave`` on native stores), so the
recovered state is byte-identical to the pre-crash state by construction.

Two writer backends share the byte format:

- :class:`_CWalWriter` — walkernel.cpp via ctypes (the production path);
- :class:`_PyWalWriter` — pure Python, the SEMANTICS OWNER of the format,
  forced by ``RABIA_PY_WAL=1``.

Given the same record sequence and segment limit both produce
byte-identical segment files; ``testing.conformance.
run_waves_on_both_wal_paths`` pins that and ``scripts/fuzz_conformance.py
--wal`` fuzzes it in CI. Recovery (scan, torn-tail truncation, replay)
lives here ONLY — both backends recover through literally the same code.

On-disk format: docs/DURABILITY.md.

The port of the reference's ``rabia_tpu/persistence/native_wal.py``, over
the port's own build of ``walkernel.cpp`` (``native/build.load_walkernel``,
which raises when the build fails). The bytes on disk are the
reference's: a WAL directory written by either package recovers in the
other.
"""

from __future__ import annotations

import asyncio
import ctypes
import heapq
import itertools
import json
import logging
import os
import struct
import threading
import time
import uuid
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from rabia_tpu_torch.core.errors import PersistenceError
from rabia_tpu_torch.core.persistence import PersistenceLayer

logger = logging.getLogger("rabia_tpu_torch.persistence.native_wal")

# ---------------------------------------------------------------------------
# byte format (the Python twin here is the semantics owner; walkernel.cpp
# and runtime.cpp mirror it — keep the three in lockstep)
# ---------------------------------------------------------------------------

SEG_MAGIC = b"RTWL"
SNAP_MAGIC = b"RTSN"
WAL_VERSION = 1
SNAP_VERSION = 1
SEG_HEADER = 24  # magic | u32 version | u64 segment_index | u64 base_lsn

# record kinds (payload byte 0)
K_WAVE = 1      # decided wave: the unit of replay
K_BARRIER = 2   # vote-barrier vector (write-ahead of first votes)
K_FRONTIER = 3  # snapshot frontier mark (GC bookkeeping, wal-dump)
K_LEDGER = 4    # (shard, slot) -> batch id backfill for C-staged waves

KIND_NAMES = {
    K_WAVE: "wave",
    K_BARRIER: "barrier",
    K_FRONTIER: "frontier",
    K_LEDGER: "ledger",
}

_NULL_BID = b"\x00" * 16

# WLC_* counter block names, in index order (walkernel.cpp). Versioned
# append-only; the Python writer mirrors the same names.
WAL_COUNTER_NAMES = (
    "appends",
    "append_bytes",
    "waves",
    "barriers",
    "frontiers",
    "ledgers",
    "flushes",
    "flush_bytes",
    "fsyncs",
    "fsync_ns",
    "group_records",
    "rotations",
    "barrier_waits",
    "io_errors",
)


def seg_name(index: int) -> str:
    return f"wal-{index:08d}.seg"


def snap_name(index: int) -> str:
    return f"snap-{index:08d}.dat"


def encode_segment_header(index: int, base_lsn: int) -> bytes:
    return SEG_MAGIC + struct.pack("<IQQ", WAL_VERSION, index, base_lsn)


def frame_record(payload: bytes) -> bytes:
    return (
        struct.pack("<II", len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        + payload
    )


def encode_wave(
    shard: int,
    slot: int,
    value: int,
    bid: Optional[bytes],
    ops: Optional[list[bytes]],
) -> bytes:
    """Kind-1 record: one decided (shard, slot). ``ops`` are the batch's
    raw command payloads (the binary op records the wire carries); None
    for V0 / payload-less decisions. ``bid`` is the 16-byte batch id —
    zeros when staged from C (runtime.cpp), backfilled by a K_LEDGER
    record."""
    has_batch = ops is not None
    head = struct.pack(
        "<BIQBB", K_WAVE, shard, slot, value & 0xFF, 1 if has_batch else 0
    )
    if not has_batch:
        return head
    parts = [head, bid if bid is not None else _NULL_BID]
    parts.append(struct.pack("<I", len(ops)))
    for op in ops:
        parts.append(struct.pack("<I", len(op)))
        parts.append(op)
    return b"".join(parts)


def encode_barrier(vec: bytes) -> bytes:
    """Kind-2 record: the full int64[n_shards] barrier vector (the same
    bytes the aux-blob path persists)."""
    n = len(vec) // 8
    return struct.pack("<BI", K_BARRIER, n) + vec


def encode_frontier(
    snap_index: int, state_version: int, applied: list[int]
) -> bytes:
    return (
        struct.pack(
            "<BQQI", K_FRONTIER, snap_index, state_version, len(applied)
        )
        + struct.pack(f"<{len(applied)}q", *applied)
    )


def encode_ledger(shard: int, slot: int, bid: bytes) -> bytes:
    return struct.pack("<BIQ", K_LEDGER, shard, slot) + bid


def decode_record(payload: bytes) -> dict:
    """Decode one record payload into a dict (tolerant: unknown kinds
    come back as {"kind": n, "raw": ...})."""
    kind = payload[0]
    if kind == K_WAVE:
        shard, slot, value, has_batch = struct.unpack_from("<IQBB", payload, 1)
        rec = {
            "kind": K_WAVE,
            "shard": int(shard),
            "slot": int(slot),
            "value": int(value),
            "bid": None,
            "ops": None,
        }
        if has_batch:
            at = 15
            rec["bid"] = payload[at : at + 16]
            at += 16
            (nops,) = struct.unpack_from("<I", payload, at)
            at += 4
            ops = []
            for _ in range(nops):
                (ln,) = struct.unpack_from("<I", payload, at)
                at += 4
                ops.append(payload[at : at + ln])
                at += ln
            rec["ops"] = ops
        return rec
    if kind == K_BARRIER:
        (n,) = struct.unpack_from("<I", payload, 1)
        return {
            "kind": K_BARRIER,
            "barrier": list(struct.unpack_from(f"<{n}q", payload, 5)),
        }
    if kind == K_FRONTIER:
        snap_index, state_version, n = struct.unpack_from("<QQI", payload, 1)
        return {
            "kind": K_FRONTIER,
            "snap_index": int(snap_index),
            "state_version": int(state_version),
            "applied": list(struct.unpack_from(f"<{n}q", payload, 21)),
        }
    if kind == K_LEDGER:
        shard, slot = struct.unpack_from("<IQ", payload, 1)
        return {
            "kind": K_LEDGER,
            "shard": int(shard),
            "slot": int(slot),
            "bid": payload[13:29],
        }
    return {"kind": int(kind), "raw": payload}


# ---------------------------------------------------------------------------
# the scan (recovery + wal-dump; shared by both writer backends)
# ---------------------------------------------------------------------------


@dataclass
class WalScan:
    """One pass over a WAL directory: every whole CRC-valid record, plus
    where (and why) the log tears if it does."""

    records: list[tuple[int, int, int, bytes]] = field(default_factory=list)
    # (lsn, segment_index, file_offset, payload)
    segments: list[dict] = field(default_factory=list)
    torn: Optional[dict] = None  # {"segment", "offset", "reason"}
    last_lsn: int = 0
    last_segment: int = -1
    total_bytes: int = 0


def scan_wal(directory: Path | str) -> WalScan:
    """Scan segments in index order, stopping at the first tear (short
    frame, CRC mismatch, bad header, LSN discontinuity). Records BEFORE
    the tear are exactly the durable prefix — the torn tail is what an
    in-flight group commit looks like after a crash, never an error."""
    d = Path(directory)
    out = WalScan()
    paths = sorted(d.glob("wal-*.seg"))
    lsn: Optional[int] = None
    for path in paths:
        try:
            idx = int(path.stem.split("-", 1)[1])
        except (IndexError, ValueError):
            continue
        try:
            raw = path.read_bytes()
        except OSError as e:
            out.torn = {"segment": idx, "offset": 0, "reason": f"unreadable: {e}"}
            break
        out.total_bytes += len(raw)
        seg = {"index": idx, "path": str(path), "bytes": len(raw), "records": 0}
        if len(raw) < SEG_HEADER or raw[:4] != SEG_MAGIC:
            out.torn = {"segment": idx, "offset": 0, "reason": "bad header"}
            out.segments.append(seg)
            break
        version, hidx, base_lsn = struct.unpack_from("<IQQ", raw, 4)
        seg["base_lsn"] = int(base_lsn)
        if version != WAL_VERSION or hidx != idx:
            out.torn = {
                "segment": idx, "offset": 0,
                "reason": f"header mismatch (version={version} index={hidx})",
            }
            out.segments.append(seg)
            break
        if lsn is None:
            lsn = int(base_lsn) - 1
        elif int(base_lsn) != lsn + 1:
            out.torn = {
                "segment": idx, "offset": 0,
                "reason": f"lsn discontinuity (base {base_lsn}, expected {lsn + 1})",
            }
            out.segments.append(seg)
            break
        pos = SEG_HEADER
        while pos < len(raw):
            if pos + 8 > len(raw):
                out.torn = {"segment": idx, "offset": pos, "reason": "short frame"}
                break
            plen, crc = struct.unpack_from("<II", raw, pos)
            if plen == 0 or pos + 8 + plen > len(raw):
                out.torn = {
                    "segment": idx, "offset": pos,
                    "reason": f"short payload ({plen} bytes framed)",
                }
                break
            payload = raw[pos + 8 : pos + 8 + plen]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                out.torn = {"segment": idx, "offset": pos, "reason": "crc mismatch"}
                break
            lsn += 1
            out.records.append((lsn, idx, pos, payload))
            seg["records"] += 1
            pos += 8 + plen
        out.segments.append(seg)
        out.last_segment = idx
        if out.torn is not None:
            break
    out.last_lsn = lsn if lsn is not None else 0
    return out


def truncate_torn_tail(directory: Path | str, scan: WalScan) -> int:
    """Make the on-disk log equal to the scanned durable prefix: truncate
    the torn segment at the tear and unlink anything after it. Returns
    bytes dropped. A tear strictly inside the log (not the tail) only
    happens under real corruption; everything past it is unreachable
    either way, so the conservative cut is the correct one."""
    if scan.torn is None:
        return 0
    d = Path(directory)
    dropped = 0
    tseg = scan.torn["segment"]
    toff = scan.torn["offset"]
    for path in sorted(d.glob("wal-*.seg")):
        try:
            idx = int(path.stem.split("-", 1)[1])
        except (IndexError, ValueError):
            continue
        try:
            if idx == tseg and toff >= SEG_HEADER:
                size = path.stat().st_size
                if size > toff:
                    with open(path, "rb+") as f:
                        f.truncate(toff)
                        f.flush()
                        os.fsync(f.fileno())
                    dropped += size - toff
            elif idx > tseg or (idx == tseg and toff < SEG_HEADER):
                dropped += path.stat().st_size
                path.unlink()
        except OSError as e:  # pragma: no cover - fs races
            raise PersistenceError(f"torn-tail truncation failed: {e}") from None
    return dropped


# ---------------------------------------------------------------------------
# writer backends
# ---------------------------------------------------------------------------


class _CWalWriter:
    """walkernel.cpp via ctypes: mutex-append staging, dedicated flush
    thread, eventfd durability notification."""

    native = True

    def __init__(
        self, lib, directory: Path, seg_limit: int, n_shards: int,
        stride: int, start_lsn: int, start_segment: int,
    ) -> None:
        self.lib = lib
        self.handle = lib.wal_create(
            os.fspath(directory).encode(), seg_limit, n_shards, stride,
            start_lsn, start_segment,
        )
        if not self.handle:
            raise PersistenceError("wal_create failed")
        lib.wal_start(self.handle)
        n_ctr = int(lib.wal_counters_count())
        self.counters_version = int(lib.wal_counters_version())
        import numpy as np

        cbuf = (ctypes.c_uint64 * n_ctr).from_address(
            lib.wal_counters(self.handle)
        )
        self.counters = np.frombuffer(cbuf, np.uint64)
        hb = int(lib.wal_hist_buckets())
        hbuf = (ctypes.c_uint64 * (hb + 2)).from_address(
            lib.wal_hist(self.handle)
        )
        self.hist = np.frombuffer(hbuf, np.uint64)
        self.hist_buckets = hb
        self.event_fd: Optional[int] = int(lib.wal_event_fd(self.handle))
        self.on_durable: Optional[Callable[[], None]] = None

    def append(self, payload: bytes) -> int:
        lsn = int(self.lib.wal_append(self.handle, payload, len(payload)))
        if lsn < 0:
            raise PersistenceError("wal append failed (log wedged)")
        return lsn

    def durable(self) -> int:
        return int(self.lib.wal_durable(self.handle))

    def staged(self) -> int:
        return int(self.lib.wal_staged(self.handle))

    def io_error(self) -> bool:
        return bool(self.lib.wal_io_error(self.handle))

    def sync(self, timeout: float = 10.0) -> None:
        if int(self.lib.wal_sync(self.handle, timeout)) != 0:
            raise PersistenceError("wal sync failed (timeout or wedged log)")

    def barrier_covered(self, shard: int, slot: int) -> int:
        return int(self.lib.wal_barrier_covered(self.handle, shard, slot))

    def set_barrier(self, vec) -> None:
        import numpy as np

        arr = np.ascontiguousarray(vec, np.int64)
        self.lib.wal_set_barrier(self.handle, arr.ctypes.data, len(arr))

    def get_barrier(self, n: int) -> list[int]:
        import numpy as np

        out = np.zeros(n, np.int64)
        self.lib.wal_get_barrier(self.handle, out.ctypes.data, n)
        return out.tolist()

    def segment_index(self) -> int:
        return int(self.lib.wal_segment_index(self.handle))

    def counters_dict(self) -> dict[str, int]:
        return {
            n: int(self.counters[i]) if i < len(self.counters) else 0
            for i, n in enumerate(WAL_COUNTER_NAMES)
        }

    def close(self) -> None:
        if self.handle:
            self.counters = self.counters.copy()
            self.hist = self.hist.copy()
            h, self.handle = self.handle, None
            self.lib.wal_stop(h)
            self.lib.wal_destroy(h)


class _PyWalWriter:
    """Pure-Python twin — the byte-format semantics owner. Same staging/
    flush-thread/group-commit design, same deterministic record-boundary
    rotation, so segment files are byte-identical to the C writer's for
    the same record sequence."""

    native = False

    def __init__(
        self, directory: Path, seg_limit: int, n_shards: int, stride: int,
        start_lsn: int, start_segment: int,
    ) -> None:
        self.dir = Path(directory)
        self.seg_limit = max(seg_limit, SEG_HEADER + 64)
        self.stride = max(1, stride)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._done = threading.Condition(self._mu)
        self._stage: list[bytes] = []  # framed records
        self._staged_lsn = start_lsn
        self._flushed_lsn = start_lsn
        self._durable_lsn = start_lsn
        self._io_error = False
        self._stop = False
        self._barrier = [0] * max(1, n_shards)
        self.ctrs = {n: 0 for n in WAL_COUNTER_NAMES}
        self.counters_version = 1
        self.hist = None
        self.hist_buckets = 0
        self.event_fd: Optional[int] = None
        self.on_durable: Optional[Callable[[], None]] = None

        self._seg_index = start_segment
        self._seg_bytes = 0
        self._fd = -1
        self._dir_fd = os.open(os.fspath(self.dir), os.O_RDONLY)
        self._open_segment(start_segment, start_lsn + 1)
        self._th = threading.Thread(
            target=self._loop, name="rabia-pywal-flush", daemon=True
        )
        self._th.start()

    # -- segment management (flush thread only, after the constructor) ---

    def _open_segment(self, index: int, base_lsn: int) -> None:
        path = self.dir / seg_name(index)
        fd = os.open(
            os.fspath(path), os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o644
        )
        os.write(fd, encode_segment_header(index, base_lsn))
        os.fsync(fd)
        os.fsync(self._dir_fd)
        if self._fd >= 0:
            os.close(self._fd)
        self._fd = fd
        self._seg_index = index
        self._seg_bytes = SEG_HEADER

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stage and not self._stop:
                    self._cv.wait()
                if not self._stage and self._stop:
                    return
                frames = self._stage
                self._stage = []
                first = self._flushed_lsn + 1
                target = self._staged_lsn
                self._flushed_lsn = target
            self.ctrs["flushes"] += 1
            ok = not self._io_error
            if ok:
                try:
                    lsn = first
                    run: list[bytes] = []
                    run_bytes = 0
                    for fr in frames:
                        if (
                            self._seg_bytes + run_bytes + len(fr)
                            > self.seg_limit
                            and self._seg_bytes + run_bytes > SEG_HEADER
                        ):
                            if run:
                                blob = b"".join(run)
                                os.write(self._fd, blob)
                                self._seg_bytes += run_bytes
                                self.ctrs["flush_bytes"] += run_bytes
                                run, run_bytes = [], 0
                            os.fsync(self._fd)
                            self._open_segment(self._seg_index + 1, lsn)
                            self.ctrs["rotations"] += 1
                        run.append(fr)
                        run_bytes += len(fr)
                        lsn += 1
                    if run:
                        blob = b"".join(run)
                        os.write(self._fd, blob)
                        self._seg_bytes += run_bytes
                        self.ctrs["flush_bytes"] += run_bytes
                    t0 = time.perf_counter_ns()
                    os.fsync(self._fd)
                    dt = time.perf_counter_ns() - t0
                    self.ctrs["fsyncs"] += 1
                    self.ctrs["fsync_ns"] += dt
                    self.ctrs["group_records"] += target - first + 1
                except OSError:
                    logger.exception("py-wal flush failed; log wedged")
                    ok = False
            with self._cv:
                if ok:
                    self._durable_lsn = target
                else:
                    self._io_error = True
                    self.ctrs["io_errors"] += 1
                self._done.notify_all()
            cb = self.on_durable
            if cb is not None:
                try:
                    cb()
                except Exception:  # pragma: no cover - callback bugs
                    logger.exception("wal durability callback failed")

    # -- the append lane -------------------------------------------------

    def append(self, payload: bytes) -> int:
        fr = frame_record(payload)
        with self._cv:
            if self._io_error:
                raise PersistenceError("wal append failed (log wedged)")
            self._stage.append(fr)
            self._staged_lsn += 1
            lsn = self._staged_lsn
            self.ctrs["appends"] += 1
            self.ctrs["append_bytes"] += len(fr)
            kind = payload[0]
            name = KIND_NAMES.get(kind)
            if name is not None:
                self.ctrs[name + "s"] += 1
            self._cv.notify()
        return lsn

    def durable(self) -> int:
        with self._mu:
            return self._durable_lsn

    def staged(self) -> int:
        with self._mu:
            return self._staged_lsn

    def io_error(self) -> bool:
        with self._mu:
            return self._io_error

    def sync(self, timeout: float = 10.0) -> None:
        with self._cv:
            target = self._staged_lsn
            self._cv.notify()
            deadline = time.monotonic() + timeout
            while self._durable_lsn < target and not self._io_error:
                left = deadline - time.monotonic()
                if left <= 0 or not self._done.wait(left):
                    raise PersistenceError("wal sync timeout")
            if self._io_error:
                raise PersistenceError("wal sync failed (wedged log)")

    def barrier_covered(self, shard: int, slot: int) -> int:
        with self._mu:
            if shard < 0 or shard >= len(self._barrier):
                return 0
            if slot < self._barrier[shard]:
                return 0
            self._barrier[shard] = slot + self.stride
            vec = struct.pack(
                f"<{len(self._barrier)}q", *self._barrier
            )
            self.ctrs["barrier_waits"] += 1
        return self.append(encode_barrier(vec))

    def set_barrier(self, vec) -> None:
        with self._mu:
            for i, v in enumerate(vec):
                if i < len(self._barrier):
                    self._barrier[i] = int(v)

    def get_barrier(self, n: int) -> list[int]:
        with self._mu:
            return (self._barrier + [0] * n)[:n]

    def segment_index(self) -> int:
        with self._mu:
            return self._seg_index

    def counters_dict(self) -> dict[str, int]:
        return dict(self.ctrs)

    def close(self) -> None:
        with self._cv:
            if self._stop:
                return
            self._stop = True
            self._cv.notify_all()
        self._th.join(timeout=10.0)
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
        if self._dir_fd >= 0:
            os.close(self._dir_fd)
            self._dir_fd = -1


# ---------------------------------------------------------------------------
# snapshot chain files
# ---------------------------------------------------------------------------

SNAP_KIND_BLOB = 0  # generic state machines: a full Snapshot.to_bytes blob
SNAP_KIND_KV = 1    # statekernel delta frames (one per store)


def write_snap_file(
    directory: Path, snap_index: int, frontier_lsn: int, kind: int,
    is_full: bool, meta: dict, body: bytes,
) -> Path:
    """Atomic tmp+fsync+rename+dirfsync (the FileSystemPersistence
    discipline): a crash mid-checkpoint leaves the chain unchanged."""
    meta_b = json.dumps(meta, separators=(",", ":")).encode()
    blob = (
        SNAP_MAGIC
        + struct.pack(
            "<IQQBBI", SNAP_VERSION, snap_index, frontier_lsn, kind,
            1 if is_full else 0, len(meta_b),
        )
        + meta_b
        + struct.pack("<I", len(body))
        + body
    )
    blob += struct.pack("<I", zlib.crc32(blob) & 0xFFFFFFFF)
    path = directory / snap_name(snap_index)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(os.fspath(directory), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError as e:
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        raise PersistenceError(f"snapshot write failed: {e}") from None
    return path


def read_snap_file(path: Path) -> Optional[dict]:
    """Parse + CRC-verify one chain file; None when corrupt (the chain
    scan stops at the first corrupt file — conservative)."""
    try:
        raw = path.read_bytes()
    except OSError:
        return None
    if len(raw) < 28 or raw[:4] != SNAP_MAGIC:
        return None
    (crc,) = struct.unpack_from("<I", raw, len(raw) - 4)
    if zlib.crc32(raw[:-4]) & 0xFFFFFFFF != crc:
        return None
    version, snap_index, frontier_lsn, kind, is_full, meta_len = (
        struct.unpack_from("<IQQBBI", raw, 4)
    )
    if version != SNAP_VERSION:
        return None
    at = 4 + 26
    try:
        meta = json.loads(raw[at : at + meta_len])
    except ValueError:
        return None
    at += meta_len
    (body_len,) = struct.unpack_from("<I", raw, at)
    at += 4
    return {
        "path": path,
        "snap_index": int(snap_index),
        "frontier_lsn": int(frontier_lsn),
        "kind": int(kind),
        "is_full": bool(is_full),
        "meta": meta,
        "body": raw[at : at + body_len],
    }


def encode_kv_delta_body(frames: dict[int, bytes]) -> bytes:
    """KV body: u32 n_stores | per store (u32 idx | u32 len | frame)."""
    parts = [struct.pack("<I", len(frames))]
    for idx in sorted(frames):
        fr = frames[idx]
        parts.append(struct.pack("<II", idx, len(fr)))
        parts.append(fr)
    return b"".join(parts)


def decode_kv_delta_body(body: bytes) -> dict[int, bytes]:
    (n,) = struct.unpack_from("<I", body, 0)
    at = 4
    out = {}
    for _ in range(n):
        idx, ln = struct.unpack_from("<II", body, at)
        at += 8
        out[int(idx)] = body[at : at + ln]
        at += ln
    return out


def decode_store_delta(frame: bytes):
    """statekernel.cpp delta-frame decode:
    (cleared, [(key, ...), ...dels], [(key, val, version, created,
    updated), ...entries])."""
    cleared = bool(frame[0])
    (n_del,) = struct.unpack_from("<I", frame, 1)
    at = 5
    dels = []
    for _ in range(n_del):
        (kl,) = struct.unpack_from("<H", frame, at)
        at += 2
        dels.append(frame[at : at + kl])
        at += kl
    (n_ent,) = struct.unpack_from("<I", frame, at)
    at += 4
    entries = []
    for _ in range(n_ent):
        klen, vlen = struct.unpack_from("<II", frame, at)
        (version,) = struct.unpack_from("<Q", frame, at + 8)
        created, updated = struct.unpack_from("<dd", frame, at + 16)
        key = frame[at + 32 : at + 32 + klen]
        val = frame[at + 32 + klen : at + 32 + klen + vlen]
        entries.append((key, val, int(version), float(created), float(updated)))
        at += 32 + klen + vlen
    return cleared, dels, entries


def encode_store_full(entries) -> bytes:
    """A FULL store frame in the delta format: cleared=1, no dels, every
    live entry — restore clears then reinserts, so one decode path serves
    both full and incremental frames."""
    parts = [b"\x01", struct.pack("<I", 0)]
    parts.append(struct.pack("<I", len(entries)))
    for key, val, version, created, updated in entries:
        parts.append(
            struct.pack("<IIQdd", len(key), len(val), version, created, updated)
        )
        parts.append(key)
        parts.append(val)
    return b"".join(parts)


# ---------------------------------------------------------------------------
# the persistence layer
# ---------------------------------------------------------------------------


@dataclass
class RecoveredLog:
    """What the startup scan found: the replay inputs."""

    chain: list[dict] = field(default_factory=list)
    waves: list[tuple[int, dict]] = field(default_factory=list)  # (lsn, rec)
    ledger: dict = field(default_factory=dict)  # (shard, slot) -> [bid bytes]
    barrier: Optional[bytes] = None
    frontier_lsn: int = 0
    torn: Optional[dict] = None
    truncated_bytes: int = 0
    records: int = 0


class WalPersistence(PersistenceLayer):
    """Per-replica write-ahead log + incremental snapshot chain (module
    doc). Construct pointing at a per-replica directory; the constructor
    runs the recovery scan (truncating any torn tail) and starts the
    writer on a fresh segment continuing the scanned LSN sequence.

    ``RABIA_PY_WAL=1`` forces the pure-Python writer (the byte-format
    semantics owner); otherwise walkernel.cpp is used when it builds.
    """

    supports_wal = True

    def __init__(
        self,
        directory: str | os.PathLike,
        *,
        segment_bytes: int = 4 << 20,
        barrier_stride: int = 16,
        n_shards: int = 64,
        rebase_every: int = 8,
        checkpoint_bytes: int = 1 << 20,
        checkpoint_interval: float = 30.0,
        force_python: Optional[bool] = None,
    ) -> None:
        self.dir = Path(directory)
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise PersistenceError(f"cannot create wal dir: {e}") from None
        self.segment_bytes = segment_bytes
        self.barrier_stride = barrier_stride
        self.n_shards = n_shards
        self.rebase_every = max(1, rebase_every)
        self.checkpoint_bytes = checkpoint_bytes
        self.checkpoint_interval = checkpoint_interval
        # aux blobs other than the vote barrier keep the file discipline
        self._aux_seq = itertools.count()

        # ---- recovery scan (before the writer exists) -----------------
        scan = scan_wal(self.dir)
        self.recovered = RecoveredLog(torn=scan.torn, records=len(scan.records))
        if scan.torn is not None:
            self.recovered.truncated_bytes = truncate_torn_tail(self.dir, scan)
            logger.warning(
                "wal torn tail truncated: segment %s offset %s (%s), %d bytes",
                scan.torn["segment"], scan.torn["offset"],
                scan.torn["reason"], self.recovered.truncated_bytes,
            )
        self._load_chain()
        self._index_records(scan)
        self._merge_chain_barrier()

        # ---- writer ---------------------------------------------------
        start_lsn = scan.last_lsn
        start_segment = scan.last_segment + 1
        self._writer = None
        use_py = (
            force_python
            if force_python is not None
            else os.environ.get("RABIA_PY_WAL") == "1"
        )
        if not use_py:
            from rabia_tpu_torch.native.build import load_walkernel

            lib = load_walkernel()
            if lib is not None:
                try:
                    self._writer = _CWalWriter(
                        lib, self.dir, segment_bytes, n_shards,
                        barrier_stride, start_lsn, start_segment,
                    )
                except PersistenceError:
                    logger.exception("walkernel writer unavailable")
        if self._writer is None:
            self._writer = _PyWalWriter(
                self.dir, segment_bytes, n_shards, barrier_stride,
                start_lsn, start_segment,
            )
        if self.recovered.barrier is not None:
            import numpy as np

            self._writer.set_barrier(
                np.frombuffer(self.recovered.barrier, np.int64)
            )

        # checkpoint pacing + stats
        self._snap_index = (
            self.recovered.chain[-1]["snap_index"] + 1
            if self.recovered.chain
            else 0
        )
        self._last_full_index = next(
            (
                c["snap_index"]
                for c in reversed(self.recovered.chain)
                if c["is_full"]
            ),
            -1,
        )
        self._last_ckpt_lsn = scan.last_lsn
        self._last_ckpt_bytes = 0
        self._last_ckpt_at = time.monotonic()
        self._force_full = False
        self._checkpoint_asap = False
        self.checkpoints = 0
        # cross-session durability-barrier batching (the covered-release
        # lane): one watermark wait may release MANY client Results.
        # barrier_waits counts actual waits entered, barrier_covered the
        # Results those waits released — covered/waits is the
        # amortization factor next to WLC fsyncs/group_records.
        self.barrier_waits = 0
        self.barrier_covered = 0
        self.gc_segments = 0
        self.saves = 0  # PersistenceLayer blob-path compatibility counters
        self.loads = 0
        self.aux_saves = 0

        # durability waiters (lsn-ordered min-heap) + loop watcher
        self._waiters: list = []
        self._wait_seq = itertools.count()
        self._watch_loop: Optional[asyncio.AbstractEventLoop] = None

    # -- startup scan helpers -------------------------------------------

    def _load_chain(self) -> None:
        """Chain = the suffix of valid snap files starting at the last
        full one. A corrupt file cuts the chain before it."""
        parsed: list[dict] = []
        for path in sorted(self.dir.glob("snap-*.dat")):
            info = read_snap_file(path)
            if info is None:
                logger.warning("corrupt snapshot file ignored: %s", path)
                break
            parsed.append(info)
        last_full = None
        for i, info in enumerate(parsed):
            if info["is_full"]:
                last_full = i
        if last_full is None:
            self.recovered.chain = []
        else:
            self.recovered.chain = parsed[last_full:]
        if self.recovered.chain:
            self.recovered.frontier_lsn = self.recovered.chain[-1]["frontier_lsn"]

    def _index_records(self, scan: WalScan) -> None:
        """Split the scanned records into replay inputs. Only records
        past the chain frontier replay; barrier records always win
        last-writer (the restore path wants the latest vector)."""
        frontier = self.recovered.frontier_lsn
        for lsn, _seg, _off, payload in scan.records:
            kind = payload[0]
            if kind == K_BARRIER:
                rec = decode_record(payload)
                self.recovered.barrier = struct.pack(
                    f"<{len(rec['barrier'])}q", *rec["barrier"]
                )
                continue
            if lsn <= frontier:
                continue
            if kind == K_WAVE:
                self.recovered.waves.append((lsn, decode_record(payload)))
            elif kind == K_LEDGER:
                rec = decode_record(payload)
                # a slot holds a LIST of ids: the wave's own id first,
                # then the coalescing lane's per-client aliases — every
                # one of them re-enters applied_ids at replay (dedup
                # stays exactly-once PER CLIENT, not per wave)
                self.recovered.ledger.setdefault(
                    (rec["shard"], rec["slot"]), []
                ).append(rec["bid"])

    def _merge_chain_barrier(self) -> None:
        """The recovered barrier = elementwise max of the last chain
        meta's vector and any surviving K_BARRIER records (barrier
        vectors are monotone per shard, so max is always safe). Without
        the chain copy, WAL-prefix GC could unlink every segment holding
        a barrier record and a restart would lose the anti-equivocation
        taint entirely."""
        chain_vec = None
        if self.recovered.chain:
            cv = self.recovered.chain[-1]["meta"].get("vote_barrier")
            if cv:
                chain_vec = [int(x) for x in cv]
        if chain_vec is None:
            return
        if self.recovered.barrier is None:
            rec_vec = [0] * len(chain_vec)
        else:
            rec_vec = list(
                struct.unpack(
                    f"<{len(self.recovered.barrier) // 8}q",
                    self.recovered.barrier,
                )
            )
        n = max(len(chain_vec), len(rec_vec))
        chain_vec += [0] * (n - len(chain_vec))
        rec_vec += [0] * (n - len(rec_vec))
        merged = [max(a, b) for a, b in zip(chain_vec, rec_vec)]
        self.recovered.barrier = struct.pack(f"<{n}q", *merged)

    # -- writer surface --------------------------------------------------

    @property
    def native(self) -> bool:
        return self._writer.native

    def stage_wave(
        self,
        shard: int,
        slot: int,
        value: int,
        bid: Optional[bytes],
        ops: Optional[list[bytes]],
    ) -> int:
        return self._writer.append(encode_wave(shard, slot, value, bid, ops))

    def stage_ledger(self, shard: int, slot: int, bid: bytes) -> int:
        return self._writer.append(encode_ledger(shard, slot, bid))

    def staged_lsn(self) -> int:
        return self._writer.staged()

    def durable_lsn(self) -> int:
        return self._writer.durable()

    def wal_bytes_since_checkpoint(self) -> int:
        return self._writer.counters_dict()["append_bytes"] - self._last_ckpt_bytes

    def checkpoint_due(self) -> bool:
        return (
            self._checkpoint_asap
            or self.wal_bytes_since_checkpoint() >= self.checkpoint_bytes
            or time.monotonic() - self._last_ckpt_at >= self.checkpoint_interval
        )

    def request_checkpoint(self) -> None:
        """Make the next pacing check fire immediately. The engine calls
        this after a sync adoption: the adopted slots never staged WAL
        records here, so until a checkpoint captures the adopted state a
        crash would recover a pre-adoption chain with a slot gap (replay
        stops at the gap and leans on sync — correct but slow)."""
        self._checkpoint_asap = True

    def flush_sync(self, timeout: float = 10.0) -> None:
        self._writer.sync(timeout)

    def counters_dict(self) -> dict[str, int]:
        return self._writer.counters_dict()

    def fsync_hist(self):
        """(bucket_counts, count, sum_ns) — native writer only (the
        Python twin's fsyncs ride the executor-thread timings)."""
        h = getattr(self._writer, "hist", None)
        if h is None:
            return None
        nb = self._writer.hist_buckets
        return h[:nb], int(h[nb]), int(h[nb + 1])

    def close(self) -> None:
        w, self._writer = self._writer, None
        if w is not None:
            # unregister the durability eventfd from the watching loop
            # BEFORE the writer closes the fd: the OS may hand the same
            # fd NUMBER to a later WAL instance in this process, and a
            # stale selector registration for the dead fd poisons the
            # new one (epoll drops a closed fd silently; the selector's
            # fd->key map does not) — every durability barrier on the
            # successor then times out. Surfaced by the chaos plane's
            # sequential-cluster scenario matrix.
            loop, self._watch_loop = self._watch_loop, None
            if loop is not None and w.event_fd is not None:
                try:
                    loop.remove_reader(w.event_fd)
                except Exception:
                    pass
            try:
                w.sync(5.0)
            except PersistenceError:
                logger.warning("wal close: final sync failed")
            w.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            if self._writer is not None:
                self._writer.close()
        except Exception:
            pass

    # -- durability waits ------------------------------------------------

    def _drain_waiters(self) -> None:
        durable = self._writer.durable() if self._writer else 1 << 62
        wedged = self._writer.io_error() if self._writer else True
        while self._waiters and (self._waiters[0][0] <= durable or wedged):
            _lsn, _seq, fut = heapq.heappop(self._waiters)
            if fut.done():
                continue
            if wedged:
                fut.set_exception(PersistenceError("wal wedged (io error)"))
            else:
                fut.set_result(None)

    def _on_event_fd(self) -> None:
        try:
            os.read(self._writer.event_fd, 8)
        except (OSError, AttributeError):
            pass
        self._drain_waiters()

    def _ensure_watcher(self, loop: asyncio.AbstractEventLoop) -> None:
        if self._watch_loop is loop:
            return
        old = self._watch_loop
        if old is not None and self._writer.event_fd is not None:
            try:
                old.remove_reader(self._writer.event_fd)
            except Exception:
                pass
        self._watch_loop = loop
        if self._writer.event_fd is not None:
            loop.add_reader(self._writer.event_fd, self._on_event_fd)
        else:
            self._writer.on_durable = lambda: loop.call_soon_threadsafe(
                self._drain_waiters
            )

    async def wait_durable(self, lsn: int, timeout: float = 10.0) -> None:
        """Return once every record up to ``lsn`` survived an fsync (the
        group-commit durability barrier). Raises on a wedged or closed
        log — a durability primitive that cannot prove durability must
        never ack."""
        w = self._writer
        if w is None:
            raise PersistenceError("wal closed")
        if w.durable() >= lsn:
            return
        if w.io_error():
            raise PersistenceError("wal wedged (io error)")
        loop = asyncio.get_running_loop()
        self._ensure_watcher(loop)
        fut: asyncio.Future = loop.create_future()
        heapq.heappush(self._waiters, (lsn, next(self._wait_seq), fut))
        await asyncio.wait_for(fut, timeout)

    async def durability_barrier(
        self, timeout: float = 10.0, covered: int = 1
    ) -> None:
        """Barrier over everything staged so far — the gateway's
        before-the-result-frame-leaves fence. ``covered`` is how many
        client Results this ONE watermark wait releases (the coalescing
        lane's cross-session barrier batching passes its wave's client
        count; the scalar lane leaves the default 1)."""
        self.barrier_waits += 1
        self.barrier_covered += int(covered)
        await self.wait_durable(self.staged_lsn(), timeout)

    # -- PersistenceLayer ABC -------------------------------------------

    async def save_state(self, data: bytes) -> None:
        """Engine-meta blob fallback (the non-WAL code path). The WAL
        engine path checkpoints through :meth:`checkpoint` instead."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._atomic_write, self.dir / "state.dat", data)
        self.saves += 1

    async def load_state(self) -> Optional[bytes]:
        self.loads += 1
        try:
            return (self.dir / "state.dat").read_bytes()
        except FileNotFoundError:
            return None
        except OSError as e:
            raise PersistenceError(f"load failed: {e}") from None

    def _atomic_write(self, path: Path, data: bytes) -> None:
        tmp = path.with_suffix(f".tmp{os.getpid()}.{next(self._aux_seq)}")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            dfd = os.open(os.fspath(self.dir), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError as e:
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            raise PersistenceError(f"save failed: {e}") from None

    async def save_aux(self, key: str, data: bytes) -> None:
        """The vote barrier rides the WAL's group-commit lane (kind-2
        record + durability wait — write-ahead without a dedicated
        fsync); other aux keys keep the atomic-file discipline."""
        self.aux_saves += 1
        if key == "vote_barrier":
            import numpy as np

            lsn = self._writer.append(encode_barrier(bytes(data)))
            self._writer.set_barrier(np.frombuffer(data, np.int64))
            await self.wait_durable(lsn)
            return
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in key)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            None, self._atomic_write, self.dir / f"aux_{safe}.dat", bytes(data)
        )

    async def load_aux(self, key: str) -> Optional[bytes]:
        if key == "vote_barrier":
            return self.recovered.barrier
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in key)
        try:
            return (self.dir / f"aux_{safe}.dat").read_bytes()
        except FileNotFoundError:
            return None
        except OSError as e:
            raise PersistenceError(f"aux load failed: {e}") from None

    # -- checkpoints -----------------------------------------------------

    def capture_checkpoint(self, meta: dict, sm) -> dict:
        """Phase 1 (synchronous, fast, memory-only): capture the state
        delta + engine meta ATOMICALLY with respect to applies — the
        caller brackets this under the runtime pause (native runtime) or
        simply on the loop thread (asyncio path, which owns applies).
        Marks the stores clean at capture (the mark and the captured
        frame describe the same instant); a later commit failure forces
        the NEXT checkpoint full so no dirty state is ever lost."""
        frontier_lsn = self.staged_lsn()
        snap_index = self._snap_index
        meta = dict(meta)
        # the vote barrier rides the chain meta too: WAL-prefix GC may
        # later unlink every segment holding a K_BARRIER record, and a
        # recovery that loses the barrier loses the anti-equivocation
        # taint (recovery takes the elementwise max of chain + records)
        meta["vote_barrier"] = self._writer.get_barrier(self.n_shards)
        plane = getattr(sm, "_native_plane", None)
        force_full = (
            self._force_full
            or self._last_full_index < 0
            or snap_index - self._last_full_index >= self.rebase_every
        )
        if plane is not None:
            frames: dict[int, bytes] = {}
            full = True
            for idx in range(plane.n_stores):
                fr = None if force_full else plane.snapshot_delta(idx)
                if fr is None:
                    fr = encode_store_full(plane.export_entries(idx))
                else:
                    full = False
                frames[idx] = fr
            meta["store_versions"] = [
                plane.store_version(i) for i in range(plane.n_stores)
            ]
            meta["store_stats"] = [
                list(plane.store_stats(i)) for i in range(plane.n_stores)
            ]
            body = encode_kv_delta_body(frames)
            kind = SNAP_KIND_KV
            is_full = full or force_full
            for idx in range(plane.n_stores):
                plane.snapshot_mark(idx)
        else:
            snap = sm.create_snapshot()
            body = snap.to_bytes()
            kind = SNAP_KIND_BLOB
            is_full = True
        return {
            "snap_index": snap_index,
            "frontier_lsn": frontier_lsn,
            "kind": kind,
            "is_full": is_full,
            "meta": meta,
            "body": body,
        }

    async def commit_checkpoint(self, cap: dict) -> None:
        """Phase 2 (async, off the hot path): write the chain file
        atomically, append the frontier record, GC the WAL prefix and
        superseded chain files."""
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(
                None, write_snap_file, self.dir, cap["snap_index"],
                cap["frontier_lsn"], cap["kind"], cap["is_full"],
                cap["meta"], cap["body"],
            )
        except PersistenceError:
            # the capture already marked the stores clean: without this
            # file their delta is unrecoverable from dirty bits alone —
            # the next checkpoint must export everything
            self._force_full = True
            raise
        self._force_full = False
        meta = cap["meta"]
        self._writer.append(
            encode_frontier(
                cap["snap_index"], int(meta.get("state_version", 0)),
                [int(x) for x in meta.get("applied_upto", [])],
            )
        )
        self._snap_index = cap["snap_index"] + 1
        self._checkpoint_asap = False
        if cap["is_full"]:
            self._last_full_index = cap["snap_index"]
        self._last_ckpt_lsn = cap["frontier_lsn"]
        self._last_ckpt_bytes = self.counters_dict()["append_bytes"]
        self._last_ckpt_at = time.monotonic()
        self.checkpoints += 1
        await loop.run_in_executor(
            None, self._gc, cap["frontier_lsn"], cap["is_full"],
            cap["snap_index"],
        )

    async def checkpoint(self, meta: dict, sm) -> None:
        """Capture + commit in one call (tests, shutdown, asyncio path)."""
        await self.commit_checkpoint(self.capture_checkpoint(meta, sm))

    def _gc(self, frontier_lsn: int, rebased: bool, snap_index: int) -> None:
        """Drop WAL segments wholly below the frontier and, after a full
        rebase, chain files older than the new base. The open segment
        never drops."""
        current = self._writer.segment_index()
        segs = []
        for path in sorted(self.dir.glob("wal-*.seg")):
            try:
                idx = int(path.stem.split("-", 1)[1])
            except (IndexError, ValueError):
                continue
            try:
                with open(path, "rb") as f:
                    head = f.read(SEG_HEADER)
            except OSError:
                continue
            if len(head) < SEG_HEADER or head[:4] != SEG_MAGIC:
                continue
            (base_lsn,) = struct.unpack_from("<Q", head, 16)
            segs.append((idx, path, base_lsn))
        for i, (idx, path, _base) in enumerate(segs):
            if idx >= current:
                continue
            # a segment's records all precede the NEXT segment's base lsn
            nxt = segs[i + 1][2] if i + 1 < len(segs) else None
            if nxt is None or nxt - 1 > frontier_lsn:
                continue
            try:
                path.unlink()
                self.gc_segments += 1
            except OSError:
                pass
        if rebased:
            for path in sorted(self.dir.glob("snap-*.dat")):
                try:
                    idx = int(path.stem.split("-", 1)[1])
                except (IndexError, ValueError):
                    continue
                if idx < snap_index:
                    try:
                        path.unlink()
                    except OSError:
                        pass

    # -- recovery --------------------------------------------------------

    def restore_chain_into(self, sm) -> Optional[dict]:
        """Restore the snapshot chain into the state machine; returns the
        last chain file's meta (engine counters) or None when the chain
        is empty."""
        from rabia_tpu_torch.core.state_machine import Snapshot

        plane = getattr(sm, "_native_plane", None)
        meta = None
        blob = None
        for info in self.recovered.chain:
            if info["kind"] == SNAP_KIND_BLOB:
                blob = info  # only the last full blob matters
            elif info["kind"] == SNAP_KIND_KV:
                if plane is None:
                    raise PersistenceError(
                        "kv-delta snapshot chain needs the native store "
                        "plane (was this cluster built with "
                        "RABIA_PY_APPLY=1 after checkpointing natively?)"
                    )
                for idx, frame in decode_kv_delta_body(info["body"]).items():
                    cleared, dels, entries = decode_store_delta(frame)
                    if cleared:
                        plane.clear_store(idx)
                    for key in dels:
                        plane.delete_raw(idx, key)
                    for key, val, version, created, updated in entries:
                        plane.insert_raw(idx, key, val, version, created, updated)
                    # restored entries are already durable in the chain:
                    # mark them clean so the first post-recovery delta
                    # exports only post-recovery mutations, not the
                    # whole restored state (insert_raw stamps the dirty
                    # epoch). WAL replay runs AFTER this, so replayed
                    # waves stay dirty — correct, they are not in the
                    # chain.
                    plane.snapshot_mark(idx)
            meta = info["meta"]
        if blob is not None:
            sm.restore_snapshot(Snapshot.from_bytes(blob["body"]))
            meta = blob["meta"]
        if meta is not None and plane is not None:
            for idx, v in enumerate(meta.get("store_versions", [])):
                plane.set_store_version(idx, int(v))
            for idx, st in enumerate(meta.get("store_stats", [])):
                cur = plane.store_stats(idx)
                plane.add_stats(
                    idx,
                    (int(st[0]) - cur[0]) & 0xFFFFFFFFFFFFFFFF,
                    (int(st[1]) - cur[1]) & 0xFFFFFFFFFFFFFFFF,
                    (int(st[2]) - cur[2]) & 0xFFFFFFFFFFFFFFFF,
                )
            if "sm_version" in meta and hasattr(sm, "_version"):
                sm._version = int(meta["sm_version"])
        return meta

    def replay_waves(self, engine) -> int:
        """Replay post-frontier WAL waves through the engine's apply path
        (``sm.apply_batch`` — the statekernel on native stores), advancing
        the runtime frontiers exactly like a live apply. Returns slots
        replayed."""
        from rabia_tpu_torch.core.types import BatchId, Command, CommandBatch, ShardId

        rt = engine.rt
        n = engine.n_shards
        replayed = 0
        null_cmd_id = uuid.UUID(int=0)
        gapped: set[int] = set()
        for _lsn, rec in self.recovered.waves:
            s = rec["shard"]
            if s >= n:
                continue
            slot = rec["slot"]
            if slot < int(rt.applied_upto[s]):
                continue
            if slot > int(rt.applied_upto[s]) or s in gapped:
                # slot gap: a sync adoption advanced the frontier past
                # slots that never staged here, and the crash landed
                # before the post-adoption checkpoint. Applying past the
                # gap would recover DIVERGENT state (the gap's mutations
                # are missing) — stop this shard's replay at the gap;
                # the replica re-fetches the tail via the normal lag
                # sync once it rejoins.
                if s not in gapped:
                    logger.warning(
                        "wal replay: slot gap on shard %d (have %d, "
                        "record %d) — shard replays up to the gap and "
                        "recovers the tail via sync", s,
                        int(rt.applied_upto[s]), slot,
                    )
                    gapped.add(s)
                continue
            sh = rt.shards[s]
            ledger_bids = self.recovered.ledger.get((s, slot), ())
            bid_bytes = rec["bid"]
            if bid_bytes is None or bid_bytes == _NULL_BID:
                bid_bytes = ledger_bids[0] if ledger_bids else None
            if rec["value"] == 1 and rec["ops"] is not None:
                bid = (
                    BatchId(uuid.UUID(bytes=bytes(bid_bytes)))
                    if bid_bytes
                    else BatchId.new()
                )
                batch = CommandBatch(
                    id=bid,
                    commands=tuple(
                        Command(id=null_cmd_id, data=bytes(op))
                        for op in rec["ops"]
                    ),
                    shard=ShardId(s),
                )
                try:
                    engine.sm.apply_batch(batch)
                except Exception:
                    # a batch that failed deterministically pre-crash
                    # fails identically here; the slot still consumed
                    logger.warning(
                        "wal replay: apply failed shard=%d slot=%d", s, slot
                    )
                rt.state_version += 1
                rt.v1_applied[s] += 1
                if bid_bytes:
                    sh.applied_ids[bid] = None
                for ab in ledger_bids:
                    # coalescing-lane aliases staged against this slot:
                    # every covered client's id re-enters the PROPOSER-
                    # LOCAL alias ledger with the wave it rode. NOT
                    # applied_ids: only this replica's WAL carries its
                    # aliases, and an asymmetric applied_ids entry would
                    # let the apply-path dedup-skip diverge replica
                    # state (ShardRuntime.alias_ledger comment). The
                    # slot's own (wire-symmetric) id stayed above.
                    ab = bytes(ab)
                    if bid_bytes is not None and ab == bytes(bid_bytes):
                        continue
                    sh.alias_ledger[
                        BatchId(uuid.UUID(bytes=ab))
                    ] = None
            rt.applied_upto[s] = slot + 1  # sh.applied_upto views this
            if slot + 1 > rt.next_slot[s]:
                rt.next_slot[s] = slot + 1
            replayed += 1
        return replayed

    def recover_engine(self, engine) -> dict:
        """Snapshot-chain restore + WAL replay into a freshly constructed
        engine (called from ``RabiaEngine.initialize``). Returns a small
        report dict (wal-dump and the recovery harness read it)."""
        import numpy as np

        t0 = time.perf_counter()
        meta = self.restore_chain_into(engine.sm)
        t_snap = time.perf_counter() - t0
        if meta is not None:
            S = engine.S
            opened = np.asarray(meta.get("next_slot", [])[:S], np.int64)
            applied = np.asarray(meta.get("applied_upto", [])[:S], np.int64)
            engine.rt.next_slot[: len(opened)] = opened
            engine.rt.applied_upto[: len(applied)] = applied
            engine.rt.state_version = int(meta.get("state_version", 0))
            vers = np.asarray(meta.get("v1_applied", [])[:S], np.int64)
            engine.rt.v1_applied[: len(vers)] = vers
        t1 = time.perf_counter()
        replayed = self.replay_waves(engine)
        t_replay = time.perf_counter() - t1
        report = {
            "chain_files": len(self.recovered.chain),
            "snapshot_restore_s": t_snap,
            "wal_records": self.recovered.records,
            "waves_replayed": replayed,
            "wal_replay_s": t_replay,
            "torn": self.recovered.torn,
            "truncated_bytes": self.recovered.truncated_bytes,
        }
        if replayed or self.recovered.chain:
            logger.info(
                "%s recovered: %d chain files (%.3fs), %d waves replayed "
                "(%.3fs)%s",
                engine.node_id.short(), len(self.recovered.chain), t_snap,
                replayed, t_replay,
                " [torn tail truncated]" if self.recovered.torn else "",
            )
        self.last_recovery = report
        return report
