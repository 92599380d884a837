"""Wire codecs for protocol messages.

Reference parity: rabia-core/src/serialization.rs — ``MessageSerializer``
trait (:9-19), ``JsonSerializer`` (:22-63), ``BinarySerializer`` (bincode,
:66-98), enum dispatcher defaulting to binary (:100-114), pooled zero-copy
path and size estimator (:152-209).

The binary codec here is hand-rolled little-endian (not bincode — no Rust):
fixed-width header + per-payload-type body, with zlib compression above
``SerializationConfig.compression_threshold`` for the scalar payload-
bearing types only (Propose/NewBatch/SyncResponse — consensus-round
vectors decode via ``numpy.frombuffer`` and stay uncompressed). The C++
data plane (``rabia_tpu_torch/native``) frames and transports these bytes
opaquely (u32-LE length prefix); the C codec (``native/codec.cpp``)
encodes and decodes the hot frame types byte for byte as the Python paths
below do, which stay the owners of the wire format.

The port of the reference's ``rabia_tpu/core/serialization.py``, byte for
byte (tests/test_torch_serialization.py holds both packages' bytes equal).

Binary layout (version 3):
  u8  version | u8 msg_type | u8 flags (bit0 compressed, bit1 has_recipient)
  16B msg id | 16B sender | [16B recipient] | f64 timestamp
  u32 body_len | body (possibly zlib-compressed payload body)
"""

from __future__ import annotations

import base64
import json
import os
import struct
import uuid
import zlib
from dataclasses import dataclass
from typing import Optional, Protocol

import numpy as np

from rabia_tpu_torch.core.blocks import PayloadBlock
from rabia_tpu_torch.core.config import SerializationConfig
from rabia_tpu_torch.core.errors import SerializationError
from rabia_tpu_torch.core.messages import (
    AdminRequest,
    AdminResponse,
    ClientHello,
    Decision,
    HeartBeat,
    MessageType,
    NewBatch,
    ProposeBlock,
    ProtocolMessage,
    Propose,
    QuorumNotification,
    ReadIndex,
    Result,
    SyncRequest,
    Submit,
    SyncResponse,
    VoteRound1,
    VoteRound2,
)
from rabia_tpu_torch.core.types import (
    BatchId,
    Command,
    CommandBatch,
    NodeId,
    ShardId,
    StateValue,
)

# version 2: Decision body moved its optional batch-id UUIDs from
# inline-per-entry to a trailing section (fixed entries decode as one
# frombuffer); v1 peers cleanly reject rather than mis-parse.
# version 3: SyncResponse gained the trailing per_shard_version section.
_VERSION = 3
_FLAG_COMPRESSED = 0x01
_FLAG_HAS_RECIPIENT = 0x02


class MessageSerializer(Protocol):
    """Serializer trait (serialization.rs:9-19)."""

    def serialize(self, msg: ProtocolMessage) -> bytes: ...

    def deserialize(self, data: bytes) -> ProtocolMessage: ...


# ---------------------------------------------------------------------------
# Binary codec
# ---------------------------------------------------------------------------


class _Writer:
    """Cursor-based byte builder over a persistent preallocated arena.

    Borrow via :func:`_borrow_writer` / return via :func:`_return_writer`
    — the pooled-buffer path of rabia-core/src/serialization.rs:152-169 /
    memory_pool.rs (C10). ``reset`` only rewinds the cursor (CPython
    ``del buf[:]`` would FREE the allocation), so a pooled writer's grown
    arena genuinely persists across messages.
    """

    __slots__ = ("buf", "pos")

    def __init__(self, capacity: int = 4096) -> None:
        self.buf = bytearray(capacity)
        self.pos = 0

    def reset(self) -> None:
        self.pos = 0

    def _ensure(self, n: int) -> None:
        need = self.pos + n
        if need > len(self.buf):
            self.buf.extend(bytes(max(n, len(self.buf))))

    def raw(self, b) -> None:
        n = len(b)
        self._ensure(n)
        self.buf[self.pos : self.pos + n] = b
        self.pos += n

    def u8(self, v: int) -> None:
        if not 0 <= v <= 255:
            raise SerializationError(f"u8 out of range: {v}")
        self._ensure(1)
        self.buf[self.pos] = v
        self.pos += 1

    def u32(self, v: int) -> None:
        self.raw(struct.pack("<I", v))

    def u64(self, v: int) -> None:
        self.raw(struct.pack("<Q", v))

    def f64(self, v: float) -> None:
        self.raw(struct.pack("<d", v))

    def uuid(self, u: uuid.UUID) -> None:
        self.raw(u.bytes)

    def blob(self, b: bytes) -> None:
        self.u32(len(b))
        self.raw(b)

    def string(self, s: str) -> None:
        self.blob(s.encode("utf-8"))

    def getvalue(self) -> bytes:
        return bytes(self.buf[:self.pos])


@dataclass
class PoolStats:
    """Writer-arena reuse counters (memory_pool.rs:172-177 analog)."""

    hits: int = 0
    misses: int = 0
    returned: int = 0


_WRITER_POOL: list[_Writer] = []
_WRITER_POOL_CAP = 32
writer_pool_stats = PoolStats()


def _borrow_writer() -> _Writer:
    if _WRITER_POOL:
        writer_pool_stats.hits += 1
        w = _WRITER_POOL.pop()
        w.reset()
        return w
    writer_pool_stats.misses += 1
    return _Writer()


def _return_writer(w: _Writer) -> None:
    # don't park snapshot-sized arenas (a SyncResponse can be many MB)
    if len(_WRITER_POOL) < _WRITER_POOL_CAP and len(w.buf) <= (1 << 20):
        writer_pool_stats.returned += 1
        _WRITER_POOL.append(w)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise SerializationError(
                f"truncated message: need {n} bytes at offset {self.pos}, "
                f"have {len(self.data) - self.pos}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def uuid(self) -> uuid.UUID:
        return uuid.UUID(bytes=self._take(16))

    def blob(self) -> bytes:
        return self._take(self.u32())

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def done(self) -> bool:
        return self.pos >= len(self.data)


# packed little-endian entry layouts (numpy structured dtypes are unpadded
# by default, so tobytes()/frombuffer() match the per-field wire layout)
# NodeId intern table: a cluster has a handful of peers but every decoded
# message names one — skip re-hatching UUID/NodeId objects per message
_NODE_INTERN: dict[bytes, NodeId] = {}


def _intern_node(raw: bytes) -> NodeId:
    n = _NODE_INTERN.get(raw)
    if n is None:
        if len(_NODE_INTERN) > 4096:  # bound against id-spraying peers
            _NODE_INTERN.clear()
        n = NodeId(uuid.UUID(bytes=raw))
        _NODE_INTERN[bytes(raw)] = n
    return n


_VOTE_DT = np.dtype([("shard", "<u4"), ("phase", "<u8"), ("vote", "u1")])
_DEC_DT = np.dtype(
    [("shard", "<u4"), ("phase", "<u8"), ("decision", "u1"), ("has_bid", "u1")]
)


def _write_votes(w: _Writer, vv) -> None:
    """Vectorized vote-vector body: u32 count + packed (u32,u64,u8) entries
    — byte-identical to writing each entry field-by-field."""
    n = len(vv)
    w.u32(n)
    arr = np.empty(n, _VOTE_DT)
    arr["shard"] = vv.shards
    arr["phase"] = vv.phases.astype(np.uint64)
    arr["vote"] = vv.vals.astype(np.uint8)
    w.raw(arr.tobytes())


def _read_vote_arrays(r: _Reader):
    n = r.u32()
    raw = r._take(_VOTE_DT.itemsize * n)
    arr = np.frombuffer(raw, _VOTE_DT, count=n)
    if n and (int(arr["vote"].max()) > 3):
        raise SerializationError("vote code out of range")
    return (
        arr["shard"].astype(np.int64),
        arr["phase"].astype(np.int64),
        arr["vote"].astype(np.int8),
    )


def _write_batch(w: _Writer, batch: CommandBatch) -> None:
    w.uuid(batch.id.value)
    w.f64(batch.timestamp)
    w.u32(int(batch.shard))
    w.u32(batch.checksum())
    w.u32(len(batch.commands))
    for c in batch.commands:
        w.uuid(c.id)
        w.blob(c.data)


def _read_batch(r: _Reader) -> CommandBatch:
    bid = BatchId(r.uuid())
    ts = r.f64()
    shard = ShardId(r.u32())
    checksum = r.u32()
    n = r.u32()
    cmds = tuple(Command(id=r.uuid(), data=r.blob()) for _ in range(n))
    batch = CommandBatch(id=bid, commands=cmds, timestamp=ts, shard=shard)
    if batch.checksum() != checksum:
        raise SerializationError(
            f"batch {bid.short()} checksum mismatch on decode"
        )
    return batch


def _write_optional_batch(w: _Writer, batch: Optional[CommandBatch]) -> None:
    if batch is None:
        w.u8(0)
    else:
        w.u8(1)
        _write_batch(w, batch)


def _read_optional_batch(r: _Reader) -> Optional[CommandBatch]:
    return _read_batch(r) if r.u8() else None


def _encode_payload(w: _Writer, payload) -> None:
    if isinstance(payload, Propose):
        w.u32(payload.shard)
        w.u64(payload.phase)
        w.uuid(payload.batch_id.value)
        w.u8(int(payload.value))
        _write_optional_batch(w, payload.batch)
    elif isinstance(payload, (VoteRound1, VoteRound2)):
        _write_votes(w, payload)
    elif isinstance(payload, Decision):
        # fixed packed entries first, then the bound batch ids (16B each)
        # for entries with has_bid=1 in order — keeps the hot decode a
        # single frombuffer over the fixed section
        n = len(payload)
        w.u32(n)
        arr = np.empty(n, _DEC_DT)
        arr["shard"] = payload.shards
        arr["phase"] = payload.phases.astype(np.uint64)
        arr["decision"] = payload.vals.astype(np.uint8)
        if payload.bids is None:
            arr["has_bid"] = 0
            w.raw(arr.tobytes())
        else:
            has = np.fromiter(
                (b is not None for b in payload.bids), bool, count=n
            )
            arr["has_bid"] = has.view(np.uint8)
            w.raw(arr.tobytes())
            for b in payload.bids:
                if b is not None:
                    w.uuid(b.value)
    elif isinstance(payload, SyncRequest):
        w.u64(payload.current_phase)
        w.u64(payload.state_version)
    elif isinstance(payload, SyncResponse):
        w.u64(payload.responder_phase)
        w.u64(payload.state_version)
        if payload.snapshot is None:
            w.u8(0)
        else:
            w.u8(1)
            w.blob(payload.snapshot)
        w.u32(len(payload.per_shard_phase))
        for p in payload.per_shard_phase:
            w.u64(p)
        w.u32(len(payload.applied_ids))
        for shard, bid in payload.applied_ids:
            w.u32(shard)
            w.uuid(bid.value)
        w.u32(len(payload.per_shard_version))
        for v in payload.per_shard_version:
            w.u64(v)
    elif isinstance(payload, ProposeBlock):
        b = payload.block
        k = len(b)
        w.uuid(b.id)
        w.u32(k)
        w.raw(b.shards.astype("<u4").tobytes())
        w.raw(b.slots.astype("<u8").tobytes())
        w.raw(b.counts.astype("<u4").tobytes())
        w.u32(b.total_commands)
        w.raw(b.cmd_sizes.astype("<u4").tobytes())
        w.blob(b.data)
        w.u32(b.checksum())
    elif isinstance(payload, NewBatch):
        w.u32(payload.shard)
        _write_batch(w, payload.batch)
    elif isinstance(payload, HeartBeat):
        w.u64(payload.current_phase)
        w.u64(payload.committed_phase)
    elif isinstance(payload, QuorumNotification):
        w.u8(1 if payload.has_quorum else 0)
        w.u32(len(payload.active_nodes))
        for n in payload.active_nodes:
            w.uuid(n.value)
    elif isinstance(payload, ClientHello):
        w.u8(1 if payload.ack else 0)
        w.uuid(payload.client_id)
        w.u64(payload.last_seq)
        w.u32(payload.max_inflight)
    elif isinstance(payload, Submit):
        w.uuid(payload.client_id)
        w.u64(payload.seq)
        w.u32(payload.shard)
        w.u64(payload.ack_upto)
        w.u32(len(payload.commands))
        for c in payload.commands:
            w.blob(c)
    elif isinstance(payload, Result):
        w.uuid(payload.client_id)
        w.u64(payload.seq)
        w.u8(int(payload.status))
        w.u32(len(payload.payload))
        for c in payload.payload:
            w.blob(c)
    elif isinstance(payload, ReadIndex):
        w.u8(int(payload.mode))
        w.uuid(payload.client_id)
        w.u64(payload.seq)
        w.u32(payload.shard)
        w.blob(payload.key)
        w.u32(len(payload.frontier))
        for f in payload.frontier:
            w.u64(f)
    elif isinstance(payload, AdminRequest):
        w.u8(int(payload.kind))
        w.u64(payload.nonce)
        w.blob(payload.query)
    elif isinstance(payload, AdminResponse):
        w.u64(payload.nonce)
        w.u8(int(payload.status))
        w.blob(payload.body)
    else:  # pragma: no cover - exhaustive over Payload union
        raise SerializationError(f"unknown payload type {type(payload).__name__}")


def _decode_payload(msg_type: MessageType, r: _Reader):
    if msg_type == MessageType.Propose:
        return Propose(
            shard=r.u32(),
            phase=r.u64(),
            batch_id=BatchId(r.uuid()),
            value=StateValue(r.u8()),
            batch=_read_optional_batch(r),
        )
    if msg_type == MessageType.VoteRound1:
        sh, ph, vv = _read_vote_arrays(r)
        return VoteRound1(shards=sh, phases=ph, vals=vv)
    if msg_type == MessageType.VoteRound2:
        sh, ph, vv = _read_vote_arrays(r)
        return VoteRound2(shards=sh, phases=ph, vals=vv)
    if msg_type == MessageType.Decision:
        n = r.u32()
        raw = r._take(_DEC_DT.itemsize * n)
        arr = np.frombuffer(raw, _DEC_DT, count=n)
        if n and int(arr["decision"].max()) > 3:
            raise SerializationError("decision code out of range")
        bids = None
        if n and arr["has_bid"].any():
            bids = [
                BatchId(r.uuid()) if h else None for h in arr["has_bid"]
            ]
        return Decision(
            shards=arr["shard"].astype(np.int64),
            phases=arr["phase"].astype(np.int64),
            vals=arr["decision"].astype(np.int8),
            bids=bids,
        )
    if msg_type == MessageType.SyncRequest:
        return SyncRequest(current_phase=r.u64(), state_version=r.u64())
    if msg_type == MessageType.SyncResponse:
        phase = r.u64()
        ver = r.u64()
        snap = r.blob() if r.u8() else None
        n = r.u32()
        per_shard = tuple(r.u64() for _ in range(n))
        n_ids = r.u32()
        applied = tuple((r.u32(), BatchId(r.uuid())) for _ in range(n_ids))
        n_v = r.u32()
        per_ver = tuple(r.u64() for _ in range(n_v))
        return SyncResponse(phase, ver, snap, per_shard, applied, per_ver)
    if msg_type == MessageType.ProposeBlock:
        bid = r.uuid()
        k = r.u32()
        shards = np.frombuffer(r._take(4 * k), "<u4").astype(np.int64)
        slots = np.frombuffer(r._take(8 * k), "<u8").astype(np.int64)
        counts = np.frombuffer(r._take(4 * k), "<u4").astype(np.int64)
        total = r.u32()
        sizes = np.frombuffer(r._take(4 * total), "<u4").astype(np.int64)
        data = r.blob()
        checksum = r.u32()
        if (zlib.crc32(data) & 0xFFFFFFFF) != checksum:
            raise SerializationError("block data checksum mismatch")
        try:
            block = PayloadBlock(bid, shards, slots, counts, sizes, data)
        except Exception as e:
            raise SerializationError(f"malformed block: {e}") from None
        return ProposeBlock(block=block)
    if msg_type == MessageType.NewBatch:
        return NewBatch(shard=r.u32(), batch=_read_batch(r))
    if msg_type == MessageType.HeartBeat:
        return HeartBeat(current_phase=r.u64(), committed_phase=r.u64())
    if msg_type == MessageType.QuorumNotification:
        has_q = bool(r.u8())
        n = r.u32()
        return QuorumNotification(
            has_quorum=has_q,
            active_nodes=tuple(NodeId(r.uuid()) for _ in range(n)),
        )
    if msg_type == MessageType.ClientHello:
        ack = bool(r.u8())
        return ClientHello(
            client_id=r.uuid(),
            ack=ack,
            last_seq=r.u64(),
            max_inflight=r.u32(),
        )
    if msg_type == MessageType.Submit:
        cid = r.uuid()
        seq = r.u64()
        shard = r.u32()
        ack_upto = r.u64()
        n = r.u32()
        return Submit(
            client_id=cid,
            seq=seq,
            shard=shard,
            commands=tuple(r.blob() for _ in range(n)),
            ack_upto=ack_upto,
        )
    if msg_type == MessageType.Result:
        cid = r.uuid()
        seq = r.u64()
        status = r.u8()
        n = r.u32()
        return Result(
            client_id=cid,
            seq=seq,
            status=status,
            payload=tuple(r.blob() for _ in range(n)),
        )
    if msg_type == MessageType.ReadIndex:
        mode = r.u8()
        cid = r.uuid()
        seq = r.u64()
        shard = r.u32()
        key = r.blob()
        n = r.u32()
        return ReadIndex(
            mode=mode,
            client_id=cid,
            seq=seq,
            shard=shard,
            key=key,
            frontier=tuple(r.u64() for _ in range(n)),
        )
    if msg_type == MessageType.AdminRequest:
        kind = r.u8()
        nonce = r.u64()
        # trailing query blob appended for JOURNAL filters/TRACE; absent
        # on pre-trace frames (decode stays wire-compatible both ways)
        query = r.blob() if not r.done() else b""
        return AdminRequest(kind=kind, nonce=nonce, query=query)
    if msg_type == MessageType.AdminResponse:
        return AdminResponse(nonce=r.u64(), status=r.u8(), body=r.blob())
    raise SerializationError(f"unknown message type {msg_type}")


_NATIVE_CODEC = None
_NATIVE_TRIED = False


def _native_codec():
    """The C-extension codec for hot frames (rabia_tpu_torch/native/codec.cpp),
    bound to this module's classes on first use; None when
    ``RABIA_PY_CODEC`` is set. A failed build raises.
    Byte-for-byte compatible with the Python codec below (pinned by
    tests/test_torch_native_codec.py); the Python codec remains the semantics
    owner and handles the remaining message types."""
    global _NATIVE_CODEC, _NATIVE_TRIED
    if os.environ.get("RABIA_PY_CODEC"):
        return None  # checked per serializer: the switch holds mid-process
    if not _NATIVE_TRIED:
        from rabia_tpu_torch.native.build import load_codec

        mod = load_codec()  # raises when the build fails: tried again
        _NATIVE_TRIED = True
        if mod is not None:
            mod.bind(
                ProtocolMessage=ProtocolMessage,
                VoteRound1=VoteRound1,
                VoteRound2=VoteRound2,
                Decision=Decision,
                HeartBeat=HeartBeat,
                SyncRequest=SyncRequest,
                ProposeBlock=ProposeBlock,
                PayloadBlock=PayloadBlock,
                NodeId=NodeId,
                BatchId=BatchId,
                UUID=uuid.UUID,
                safe_unknown=uuid.SafeUUID.unknown,
                SerializationError=SerializationError,
                crc32=zlib.crc32,
                Propose=Propose,
                NewBatch=NewBatch,
                CommandBatch=CommandBatch,
                Command=Command,
                ShardId=ShardId,
                StateValue=StateValue,
                SyncResponse=SyncResponse,
                ClientHello=ClientHello,
                Submit=Submit,
                Result=Result,
                ReadIndex=ReadIndex,
            )
            _NATIVE_CODEC = mod
    return _NATIVE_CODEC


class BinarySerializer:
    """Compact binary codec (serialization.rs:66-98 analog; custom layout).

    Hot frame types (vote vectors, Decision, Propose/NewBatch command
    batches, ProposeBlock, HeartBeat, SyncRequest) encode/decode through
    the native C extension unless ``RABIA_PY_CODEC`` is set; everything
    else — and every byte of wire format — stays owned by the Python
    paths below."""

    def __init__(self, config: SerializationConfig | None = None):
        self.config = config or SerializationConfig()
        self._native = _native_codec()

    def serialize(self, msg: ProtocolMessage) -> bytes:
        if self._native is not None:
            # the threshold makes the native codec decline batch bodies
            # the Python path might compress (parity stays byte-for-byte)
            out = self._native.encode(
                msg, self.config.compression_threshold or 0
            )
            if out is not None:
                return out
        return self._serialize_py(msg)

    def _serialize_py(self, msg: ProtocolMessage) -> bytes:
        body_w = _borrow_writer()
        _encode_payload(body_w, msg.payload)
        body = body_w.getvalue()
        _return_writer(body_w)

        flags = 0
        # compress only scalar payload-bearing bodies: snapshots and batch
        # carriers. Consensus-round traffic (vote/decision vectors, blocks)
        # is latency-critical and decodes via frombuffer — zlib on every
        # round would dominate the hot path
        compressible = isinstance(
            msg.payload, (Propose, NewBatch, SyncResponse)
        )
        if (
            compressible
            and self.config.compression_threshold
            and len(body) > self.config.compression_threshold
        ):
            compressed = zlib.compress(body, level=1)
            if len(compressed) < len(body):
                body = compressed
                flags |= _FLAG_COMPRESSED
        if msg.recipient is not None:
            flags |= _FLAG_HAS_RECIPIENT

        w = _borrow_writer()
        w.u8(_VERSION)
        w.u8(int(msg.message_type))
        w.u8(flags)
        w.uuid(msg.id)
        w.uuid(msg.sender.value)
        if msg.recipient is not None:
            w.uuid(msg.recipient.value)
        w.f64(msg.timestamp)
        w.blob(body)
        out = w.getvalue()
        _return_writer(w)
        return out

    def deserialize(self, data: bytes) -> ProtocolMessage:
        if self._native is not None:
            msg = self._native.decode(data)  # any buffer: bytes/memoryview
            if msg is not None:
                return msg
        # the Python reader slices, hashes and frombuffers — it needs a
        # real bytes object (zero-copy borrowed frames arrive as
        # memoryviews over the transport arena)
        if not isinstance(data, bytes):
            data = bytes(data)
        return self._deserialize_py(data)

    def _deserialize_py(self, data: bytes) -> ProtocolMessage:
        r = _Reader(data)
        version = r.u8()
        if version != _VERSION:
            raise SerializationError(f"unsupported wire version {version}")
        try:
            msg_type = MessageType(r.u8())
        except ValueError as e:
            raise SerializationError(str(e)) from None
        flags = r.u8()
        msg_id = r.uuid()
        sender = _intern_node(r._take(16))
        recipient = (
            _intern_node(r._take(16)) if flags & _FLAG_HAS_RECIPIENT else None
        )
        ts = r.f64()
        body = r.blob()
        if flags & _FLAG_COMPRESSED:
            try:
                body = zlib.decompress(body)
            except zlib.error as e:
                raise SerializationError(f"decompression failed: {e}") from None
        payload = _decode_payload(msg_type, _Reader(body))
        return ProtocolMessage(
            id=msg_id,
            sender=sender,
            recipient=recipient,
            timestamp=ts,
            payload=payload,
        )


# ---------------------------------------------------------------------------
# JSON codec (debug / interop)
# ---------------------------------------------------------------------------


def _jsonify(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, PayloadBlock):
        return {
            "block_id": str(obj.id),
            "covered_shards": len(obj),
            "total_commands": obj.total_commands,
            "data_bytes": len(obj.data),
        }
    if isinstance(obj, (VoteRound1, VoteRound2)):
        return {"votes": _jsonify(obj.votes)}
    if isinstance(obj, Decision):
        return {"decisions": _jsonify(obj.decisions)}
    if isinstance(obj, bytes):
        return {"__bytes__": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, uuid.UUID):
        return str(obj)
    if isinstance(obj, StateValue):
        return int(obj)
    if isinstance(obj, (NodeId, BatchId)):
        return str(obj.value)
    if isinstance(obj, ShardId):
        return int(obj)
    if isinstance(obj, (list, tuple)):
        return [_jsonify(x) for x in obj]
    if hasattr(obj, "__dataclass_fields__"):
        return {
            k: _jsonify(getattr(obj, k)) for k in obj.__dataclass_fields__
        }
    return obj


class JsonSerializer:
    """Human-readable codec (serialization.rs:22-63 analog).

    Round-trips via the binary codec's payload body for decode simplicity:
    JSON carries the envelope plus a hex of the binary body. Full-JSON bodies
    are emitted for debugging via :meth:`to_debug_json`.
    """

    def __init__(self, config: SerializationConfig | None = None):
        self.config = config or SerializationConfig()

    def serialize(self, msg: ProtocolMessage) -> bytes:
        body_w = _Writer()
        _encode_payload(body_w, msg.payload)
        doc = {
            "version": _VERSION,
            "type": int(msg.message_type),
            "type_name": msg.message_type.name,
            "id": str(msg.id),
            "sender": str(msg.sender.value),
            "recipient": str(msg.recipient.value) if msg.recipient else None,
            "timestamp": msg.timestamp,
            "body_hex": body_w.getvalue().hex(),
            "debug": _jsonify(msg.payload),
        }
        return json.dumps(doc, separators=(",", ":")).encode("utf-8")

    def deserialize(self, data: bytes) -> ProtocolMessage:
        try:
            doc = json.loads(data)
        except json.JSONDecodeError as e:
            raise SerializationError(f"bad JSON: {e}") from None
        try:
            msg_type = MessageType(doc["type"])
            payload = _decode_payload(msg_type, _Reader(bytes.fromhex(doc["body_hex"])))
            return ProtocolMessage(
                id=uuid.UUID(doc["id"]),
                sender=NodeId(uuid.UUID(doc["sender"])),
                recipient=(
                    NodeId(uuid.UUID(doc["recipient"])) if doc["recipient"] else None
                ),
                timestamp=doc["timestamp"],
                payload=payload,
            )
        except (KeyError, ValueError) as e:
            raise SerializationError(f"malformed JSON message: {e}") from None

    @staticmethod
    def to_debug_json(msg: ProtocolMessage) -> str:
        return json.dumps(
            {
                "type": msg.message_type.name,
                "sender": msg.sender.short(),
                "recipient": msg.recipient.short() if msg.recipient else None,
                "payload": _jsonify(msg.payload),
            },
            indent=2,
        )


class Serializer:
    """Dispatcher defaulting to binary (serialization.rs:100-114)."""

    def __init__(self, config: SerializationConfig | None = None):
        self.config = config or SerializationConfig()
        self._binary = BinarySerializer(self.config)
        self._json = JsonSerializer(self.config)

    def serialize(self, msg: ProtocolMessage) -> bytes:
        if self.config.use_binary:
            return self._binary.serialize(msg)
        return self._json.serialize(msg)

    def deserialize(self, data: bytes) -> ProtocolMessage:
        """Auto-detect: JSON messages start with '{'.

        Any parse failure — including corrupt enum codes or truncated
        buffers raising ValueError/struct.error deep in a codec — surfaces
        as SerializationError so ingest paths can drop the message instead
        of crashing (the engine catches RabiaError only).
        """
        try:
            if data[:1] == b"{":
                # json.loads rejects memoryviews (zero-copy recv frames)
                return self._json.deserialize(
                    data if isinstance(data, bytes) else bytes(data)
                )
            return self._binary.deserialize(data)
        except SerializationError:
            raise
        except Exception as e:
            raise SerializationError(f"malformed message: {e}") from e


def estimate_serialized_size(msg: ProtocolMessage) -> int:
    """Rough pre-allocation hint (serialization.rs:172-209 analog)."""
    base = 3 + 16 + 16 + 16 + 8 + 4
    p = msg.payload
    if isinstance(p, (VoteRound1, VoteRound2)):
        return base + 4 + 13 * len(p)
    if isinstance(p, Decision):
        return base + 4 + 30 * len(p)
    if isinstance(p, Propose):
        b = p.batch.total_size() + 40 * len(p.batch) if p.batch else 0
        return base + 29 + b
    if isinstance(p, ProposeBlock):
        return base + 28 + 16 * len(p.block) + 4 * p.block.total_commands + len(
            p.block.data
        )
    if isinstance(p, NewBatch):
        return base + 4 + p.batch.total_size() + 40 * len(p.batch)
    if isinstance(p, SyncResponse):
        return base + 21 + (len(p.snapshot) if p.snapshot else 0)
    if isinstance(p, Submit):
        return base + 40 + sum(4 + len(c) for c in p.commands)
    if isinstance(p, Result):
        return base + 29 + sum(4 + len(c) for c in p.payload)
    if isinstance(p, ReadIndex):
        return base + 37 + len(p.key) + 8 * len(p.frontier)
    if isinstance(p, AdminResponse):
        return base + 13 + len(p.body)
    return base + 64
