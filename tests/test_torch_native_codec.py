"""Native codec <-> Python codec byte-for-byte compatibility.

The port's copy of the reference's tests/test_native_codec.py, retargeted to
rabia_tpu_torch (the port's native libraries, built from its own sources).

The C extension (rabia_tpu_torch/native/codec.cpp) fast-paths the hot frame
types; the Python codec in core/serialization.py remains the semantics
owner. Every assertion here crosses the two implementations in both
directions so neither can drift: native bytes == python bytes, and each
side decodes the other's output to equal objects.
"""

from __future__ import annotations

import uuid

import numpy as np
import pytest

from rabia_tpu_torch.core.blocks import PayloadBlock
from rabia_tpu_torch.core.messages import (
    Decision,
    HeartBeat,
    ProposeBlock,
    ProtocolMessage,
    SyncRequest,
    SyncResponse,
    VoteRound1,
    VoteRound2,
)
from rabia_tpu_torch.core.serialization import BinarySerializer, _native_codec
from rabia_tpu_torch.core.types import BatchId, NodeId
from rabia_tpu_torch.core.errors import SerializationError

native = _native_codec()
pytestmark = pytest.mark.skipif(
    native is None, reason="native codec unavailable (no toolchain)"
)


def _roundtrip_both(msg: ProtocolMessage) -> None:
    ser = BinarySerializer()
    n_bytes = native.encode(msg)
    p_bytes = ser._serialize_py(msg)
    assert n_bytes == p_bytes, type(msg.payload).__name__
    # cross-decode: each codec reads the other's output; both must equal
    # what the Python codec (the semantics owner) decodes — which may be
    # a canonicalized form of the input (e.g. int shard -> ShardId)
    canonical = ser._deserialize_py(p_bytes)
    from_py = native.decode(p_bytes)
    from_native = ser._deserialize_py(n_bytes)
    for out in (from_py, from_native):
        assert out.id == msg.id
        assert out.sender == msg.sender
        assert out.recipient == msg.recipient
        assert out.timestamp == msg.timestamp
        assert type(out.payload) is type(msg.payload)
        assert _payload_eq(out.payload, canonical.payload)


def _payload_eq(a, b) -> bool:
    if isinstance(a, (VoteRound1, VoteRound2, Decision)):
        return a == b  # array-backed __eq__
    if isinstance(a, ProposeBlock):
        return (
            a.block.id == b.block.id
            and np.array_equal(a.block.shards, b.block.shards)
            and np.array_equal(a.block.slots, b.block.slots)
            and np.array_equal(a.block.counts, b.block.counts)
            and np.array_equal(a.block.cmd_sizes, b.block.cmd_sizes)
            and a.block.data == b.block.data
        )
    return a == b  # frozen dataclasses


def _vote_vec(rng, n, cls):
    return cls(
        shards=rng.integers(0, 1 << 20, n).astype(np.int64),
        phases=((rng.integers(0, 1 << 40, n) << 16) | rng.integers(0, 9, n)).astype(np.int64),
        vals=rng.integers(0, 4, n).astype(np.int8),
    )


class TestNativeCodecParity:
    def test_vote_vectors(self):
        rng = np.random.default_rng(1)
        nid = NodeId.from_int(3)
        for n in (0, 1, 7, 256):
            for cls in (VoteRound1, VoteRound2):
                _roundtrip_both(ProtocolMessage.new(nid, _vote_vec(rng, n, cls)))

    def test_vote_with_recipient(self):
        rng = np.random.default_rng(2)
        msg = ProtocolMessage.new(
            NodeId.from_int(1),
            _vote_vec(rng, 3, VoteRound1),
            recipient=NodeId.from_int(2),
        )
        _roundtrip_both(msg)

    def test_decision_without_bids(self):
        rng = np.random.default_rng(3)
        d = Decision(
            shards=rng.integers(0, 100, 5).astype(np.int64),
            phases=rng.integers(0, 1 << 30, 5).astype(np.int64),
            vals=rng.integers(0, 4, 5).astype(np.int8),
        )
        _roundtrip_both(ProtocolMessage.new(NodeId.from_int(4), d))

    def test_decision_with_bids(self):
        rng = np.random.default_rng(4)
        n = 6
        bids = [
            BatchId(uuid.UUID(int=int(rng.integers(1, 1 << 60))))
            if i % 2
            else None
            for i in range(n)
        ]
        d = Decision(
            shards=np.arange(n, dtype=np.int64),
            phases=np.arange(n, dtype=np.int64) << 16,
            vals=np.ones(n, np.int8),
            bids=bids,
        )
        _roundtrip_both(ProtocolMessage.new(NodeId.from_int(5), d))

    def test_decision_tuple_bids_falls_back(self):
        # Decision.__init__ accepts any sized iterable for bids; the
        # native encoder only fast-paths lists and must DECLINE a tuple
        # (not reinterpret it as a PyListObject)
        n = 2
        d = Decision(
            shards=np.arange(n, dtype=np.int64),
            phases=np.arange(n, dtype=np.int64),
            vals=np.ones(n, np.int8),
            bids=[BatchId(uuid.UUID(int=7)), None],
        )
        d.bids = tuple(d.bids)  # __slots__ class: plain attribute write
        msg = ProtocolMessage.new(NodeId.from_int(3), d)
        assert native.encode(msg) is None
        ser = BinarySerializer()
        out = ser._deserialize_py(ser._serialize_py(msg))
        assert out.payload.bids == list(d.bids) or tuple(out.payload.bids) == d.bids

    def test_heartbeat_syncrequest(self):
        nid = NodeId.from_int(6)
        _roundtrip_both(
            ProtocolMessage.new(nid, HeartBeat(current_phase=9, committed_phase=7))
        )
        _roundtrip_both(
            ProtocolMessage.new(nid, SyncRequest(current_phase=2, state_version=11))
        )

    def test_propose_block(self):
        from rabia_tpu_torch.core.blocks import build_block

        block = build_block(
            [3, 7],
            [[b"SET a 1"], [b"SET bb 22", b"SET ccc 333"]],
            block_id=uuid.UUID(int=99),
        )
        block.slots[:] = [10, 11]
        _roundtrip_both(ProtocolMessage.new(NodeId.from_int(7), ProposeBlock(block=block)))

    def test_syncresponse(self):
        for payload in (
            SyncResponse(0, 0),
            SyncResponse(
                responder_phase=7,
                state_version=42,
                snapshot=b"\x00\x01snapshot bytes" * 9,
                per_shard_phase=(3, 1, 4, 1, 5),
                applied_ids=(
                    (0, BatchId(uuid.UUID(int=11))),
                    (4, BatchId(uuid.UUID(int=12))),
                ),
                per_shard_version=(2, 7, 1, 8, 2),
            ),
            SyncResponse(2**63, 2**64 - 1, None, (), (), tuple(range(64))),
        ):
            _roundtrip_both(ProtocolMessage.new(NodeId.from_int(3), payload))

    def test_syncresponse_compressed_parity(self):
        # above the compression threshold the Python codec zlib-level-1
        # compresses the body; the native codec must emit the IDENTICAL
        # bytes (same libz in-process) and decode them back
        from rabia_tpu_torch.core.serialization import SerializationConfig

        snap = bytes(range(256)) * 300  # ~77KB, compressible
        payload = SyncResponse(
            9, 17, snap, tuple(range(32)), (), tuple(range(32))
        )
        msg = ProtocolMessage.new(NodeId.from_int(2), payload)
        ser = BinarySerializer(SerializationConfig(compression_threshold=512))
        p_bytes = ser._serialize_py(msg)
        n_bytes = native.encode(msg, 512)
        assert n_bytes == p_bytes
        assert len(p_bytes) < len(snap) // 4  # compression engaged
        for decode in (native.decode, ser._deserialize_py):
            out = decode(p_bytes)
            assert out is not None
            assert out.payload == payload

    def test_syncresponse_odd_shapes_fall_back(self):
        # non-bytes snapshot and out-of-range ints: the Python codec owns
        # these frames (and raises its historical errors); the native
        # codec must decline, never mis-encode
        for payload in (
            SyncResponse(1, 2, bytearray(b"xyz")),
            SyncResponse(1, 2, None, (2**64,)),
            SyncResponse(1, 2, None, (), ((2**32, BatchId.new()),)),
            SyncResponse(-1, 2),
        ):
            msg = ProtocolMessage.new(NodeId.from_int(1), payload)
            assert native.encode(msg) is None

    def test_unsupported_types_fall_through(self):
        # QuorumNotification is not fast-pathed: the native codec must
        # decline, not mis-encode
        from rabia_tpu_torch.core.messages import QuorumNotification

        msg = ProtocolMessage.new(
            NodeId.from_int(8),
            QuorumNotification(
                has_quorum=True, active_nodes=(NodeId.from_int(1),)
            ),
        )
        assert native.encode(msg) is None
        ser = BinarySerializer()
        data = ser.serialize(msg)  # python path
        assert native.decode(data) is None
        assert ser.deserialize(data).payload == msg.payload

    def test_propose_and_newbatch(self):
        from rabia_tpu_torch.core.messages import NewBatch, Propose
        from rabia_tpu_torch.core.types import (
            Command,
            CommandBatch,
            ShardId,
            StateValue,
        )

        rng = np.random.default_rng(17)
        for trial in range(20):
            cmds = tuple(
                Command(
                    id=uuid.UUID(int=int(rng.integers(1, 2**63))),
                    data=bytes(
                        rng.integers(0, 256, int(rng.integers(0, 48))).astype(
                            np.uint8
                        )
                    ),
                )
                for _ in range(int(rng.integers(0, 5)))
            )
            batch = CommandBatch(
                id=BatchId(uuid.UUID(int=trial + 1)),
                commands=cmds,
                timestamp=float(rng.random() * 1e9),
                # the engine passes both ShardId and plain-int shards;
                # int(batch.shard) accepts either and so must the codec
                shard=(
                    ShardId(int(rng.integers(0, 2**31)))
                    if trial % 2
                    else int(rng.integers(0, 2**31))
                ),
            )
            _roundtrip_both(
                ProtocolMessage.new(
                    NodeId.from_int(3),
                    Propose(
                        shard=int(rng.integers(0, 2**31)),
                        phase=int(rng.integers(0, 2**62)),
                        batch_id=BatchId.new(),
                        value=StateValue(int(rng.choice([0, 1, 2]))),
                        batch=batch if trial % 3 else None,
                    ),
                )
            )
            _roundtrip_both(
                ProtocolMessage.new(
                    NodeId.from_int(4),
                    NewBatch(shard=int(rng.integers(0, 2**31)), batch=batch),
                )
            )

    def test_large_batch_declined_above_compression_threshold(self):
        # bodies the Python codec might compress must NOT be fast-pathed:
        # the serializer passes its threshold and the codec declines, so
        # the two paths stay byte-for-byte identical on every frame
        from rabia_tpu_torch.core.messages import Propose
        from rabia_tpu_torch.core.types import (
            Command,
            CommandBatch,
            ShardId,
            StateValue,
        )

        batch = CommandBatch(
            id=BatchId(uuid.UUID(int=9)),
            commands=(Command(id=uuid.UUID(int=1), data=b"x" * 8192),),
            timestamp=1.0,
            shard=ShardId(0),
        )
        msg = ProtocolMessage.new(
            NodeId.from_int(2),
            Propose(
                shard=0,
                phase=1,
                batch_id=BatchId(uuid.UUID(int=5)),
                value=StateValue.V1,
                batch=batch,
            ),
        )
        assert native.encode(msg, 4096) is None  # declines: may compress
        assert native.encode(msg) is not None  # no threshold: encodes
        ser = BinarySerializer()
        data = ser.serialize(msg)  # python path (compressed)
        assert ser.deserialize(data).payload.batch == batch

    def test_oversized_shard_declined(self):
        # a shard that does not fit u32 must NOT be silently truncated:
        # the native codec declines and the Python path raises, exactly
        # as it did before the fast path existed
        from rabia_tpu_torch.core.messages import Propose
        from rabia_tpu_torch.core.types import StateValue

        msg = ProtocolMessage.new(
            NodeId.from_int(1),
            Propose(
                shard=2**32,
                phase=1,
                batch_id=BatchId(uuid.UUID(int=5)),
                value=StateValue.V1,
            ),
        )
        assert native.encode(msg) is None
        ser = BinarySerializer()
        with pytest.raises(Exception):
            ser.serialize(msg)  # python path: struct.pack('<I') rejects

    def test_hostile_command_count(self):
        # a short frame claiming 2^32-1 commands must raise, not attempt
        # a multi-GB tuple allocation in the receive path
        from rabia_tpu_torch.core.messages import NewBatch
        from rabia_tpu_torch.core.types import CommandBatch, ShardId

        ser = BinarySerializer()
        msg = ProtocolMessage.new(
            NodeId.from_int(1),
            NewBatch(
                shard=1, batch=CommandBatch.new(["SET a b"], shard=ShardId(0))
            ),
        )
        data = bytearray(ser._serialize_py(msg))
        # command count u32 sits at envelope(47) + shard(4) + id(16)
        # + ts(8) + shard(4) + crc(4) = offset 83 (no recipient)
        assert int.from_bytes(data[83:87], "little") == 1
        data[83:87] = b"\xff\xff\xff\xff"
        with pytest.raises(SerializationError):
            native.decode(bytes(data))
        with pytest.raises(SerializationError):
            ser._deserialize_py(bytes(data))

    def test_batch_checksum_mismatch(self):
        from rabia_tpu_torch.core.messages import NewBatch
        from rabia_tpu_torch.core.types import CommandBatch, ShardId

        ser = BinarySerializer()
        msg = ProtocolMessage.new(
            NodeId.from_int(1),
            NewBatch(
                shard=1, batch=CommandBatch.new(["SET a b"], shard=ShardId(0))
            ),
        )
        good = ser._serialize_py(msg)
        bad = bytearray(good)
        bad[-3] ^= 0xFF  # flip a payload byte inside the last command
        with pytest.raises(SerializationError):
            native.decode(bytes(bad))
        with pytest.raises(SerializationError):
            ser._deserialize_py(bytes(bad))

    def test_full_serializer_uses_native_transparently(self):
        rng = np.random.default_rng(5)
        ser = BinarySerializer()
        msg = ProtocolMessage.new(NodeId.from_int(9), _vote_vec(rng, 4, VoteRound2))
        out = ser.deserialize(ser.serialize(msg))
        assert out.payload == msg.payload


class TestNativeCodecErrors:
    def test_bad_vote_code(self):
        rng = np.random.default_rng(6)
        ser = BinarySerializer()
        msg = ProtocolMessage.new(NodeId.from_int(1), _vote_vec(rng, 2, VoteRound1))
        data = bytearray(ser.serialize(msg))
        data[-1] = 9  # last byte is the final vote code
        with pytest.raises(SerializationError, match="vote code"):
            native.decode(bytes(data))
        with pytest.raises(SerializationError, match="vote code"):
            ser._deserialize_py(bytes(data))

    def test_truncation(self):
        rng = np.random.default_rng(7)
        ser = BinarySerializer()
        msg = ProtocolMessage.new(NodeId.from_int(1), _vote_vec(rng, 2, VoteRound1))
        data = ser.serialize(msg)
        with pytest.raises(SerializationError, match="truncated"):
            native.decode(data[:-3])

    def test_wrong_version(self):
        rng = np.random.default_rng(8)
        ser = BinarySerializer()
        data = bytearray(ser.serialize(
            ProtocolMessage.new(NodeId.from_int(1), _vote_vec(rng, 1, VoteRound1))
        ))
        data[0] = 99
        with pytest.raises(SerializationError, match="version"):
            native.decode(bytes(data))

    def test_syncresponse_corrupt_compressed_body(self):
        from rabia_tpu_torch.core.serialization import SerializationConfig

        ser = BinarySerializer(SerializationConfig(compression_threshold=64))
        msg = ProtocolMessage.new(
            NodeId.from_int(1),
            SyncResponse(1, 2, bytes(range(256)) * 16, (1,) * 32),
        )
        data = bytearray(ser.serialize(msg))
        assert data[2] & 0x01  # FLAG_COMPRESSED set
        data[-8] ^= 0xFF  # corrupt the deflate stream
        for decode in (native.decode, ser._deserialize_py):
            with pytest.raises(SerializationError):
                decode(bytes(data))

    def test_block_checksum_mismatch(self):
        from rabia_tpu_torch.core.blocks import build_block

        block = build_block([0], [[b"SET k v"]], block_id=uuid.UUID(int=1))
        block.slots[:] = [0]
        ser = BinarySerializer()
        data = bytearray(ser.serialize(
            ProtocolMessage.new(NodeId.from_int(1), ProposeBlock(block=block))
        ))
        data[-10] ^= 0xFF  # corrupt block data near the tail
        with pytest.raises(SerializationError):
            native.decode(bytes(data))


class TestDecodeRobustness:
    """The codecs parse NETWORK bytes: any input must either decode or
    raise a clean error — never crash the process (the C extension) or
    leak into wrong-typed objects. Mutations of valid frames exercise
    checksum/bounds/code paths; pure garbage exercises the envelope."""

    def _mk_frames(self) -> list[bytes]:
        from rabia_tpu_torch.core.messages import NewBatch, Propose
        from rabia_tpu_torch.core.types import CommandBatch, ShardId, StateValue

        ser = BinarySerializer()
        batch = CommandBatch.new(["SET a b", "SET c d"], shard=ShardId(1))
        frames = []
        for payload in (
            VoteRound1(
                shards=np.arange(4, dtype=np.int64),
                phases=np.arange(4, dtype=np.int64) << 16,
                vals=np.ones(4, np.int8),
            ),
            Decision(
                shards=np.arange(3, dtype=np.int64),
                phases=np.arange(3, dtype=np.int64) << 16,
                vals=np.ones(3, np.int8),
            ),
            Propose(
                shard=1, phase=2, batch_id=BatchId(uuid.UUID(int=7)),
                value=StateValue.V1, batch=batch,
            ),
            NewBatch(shard=2, batch=batch),
            HeartBeat(current_phase=5, committed_phase=4),
            SyncRequest(current_phase=9, state_version=3),
            SyncResponse(
                3, 9, b"snap" * 40, (1, 2), ((0, BatchId(uuid.UUID(int=9))),),
                (4, 4),
            ),
        ):
            frames.append(
                ser._serialize_py(
                    ProtocolMessage.new(NodeId.from_int(1), payload)
                )
            )
        return frames

    def test_mutation_fuzz_never_crashes(self):
        rng = np.random.default_rng(23)
        ser = BinarySerializer()
        frames = self._mk_frames()
        decoded = bad = 0
        for trial in range(3000):
            base = bytearray(frames[trial % len(frames)])
            k = int(rng.integers(1, 4))
            for _ in range(k):
                op = rng.integers(0, 3)
                if op == 0 and base:  # flip a byte
                    base[int(rng.integers(0, len(base)))] ^= int(
                        rng.integers(1, 256)
                    )
                elif op == 1 and len(base) > 4:  # truncate
                    del base[int(rng.integers(1, len(base))):]
                else:  # append garbage
                    base.extend(
                        rng.integers(0, 256, int(rng.integers(1, 16))).astype(
                            np.uint8
                        ).tobytes()
                    )
            for decode in (native.decode, ser._deserialize_py):
                try:
                    out = decode(bytes(base))
                    if out is not None:
                        assert isinstance(out, ProtocolMessage)
                        decoded += 1
                except Exception:
                    bad += 1  # clean rejection — any Python exception
        assert bad > 0  # mutations are actually detected
        assert decoded > 0  # and the baseline frames actually decode

    def test_pure_garbage_never_crashes(self):
        rng = np.random.default_rng(5)
        ser = BinarySerializer()
        for trial in range(1500):
            blob = rng.integers(
                0, 256, int(rng.integers(0, 200))
            ).astype(np.uint8).tobytes()
            for decode in (native.decode, ser._deserialize_py):
                try:
                    out = decode(blob)
                    if out is not None:
                        assert isinstance(out, ProtocolMessage)
                except Exception:
                    pass  # clean rejection


class TestGatewayFrameParity:
    """Client gateway frame kinds (ClientHello/Submit/Result/ReadIndex)
    through the same native<->python byte-parity gauntlet."""

    def test_client_hello(self):
        from rabia_tpu_torch.core.messages import ClientHello

        cid = uuid.uuid4()
        for ack, last, win in ((False, 0, 0), (True, 1 << 40, 1 << 20)):
            _roundtrip_both(
                ProtocolMessage.new(
                    NodeId.from_int(3),
                    ClientHello(
                        client_id=cid, ack=ack, last_seq=last,
                        max_inflight=win,
                    ),
                    recipient=NodeId.from_int(4),
                )
            )

    def test_submit(self):
        from rabia_tpu_torch.core.messages import Submit

        cid = uuid.uuid4()
        _roundtrip_both(
            ProtocolMessage.new(
                NodeId.from_int(3),
                Submit(
                    client_id=cid, seq=77, shard=3,
                    commands=(b"\x01\x02\x00kkvv", b"", b"\xff" * 300),
                    ack_upto=76,
                ),
            )
        )

    def test_result(self):
        from rabia_tpu_torch.core.messages import Result, ResultStatus

        cid = uuid.uuid4()
        for status in ResultStatus:
            _roundtrip_both(
                ProtocolMessage.new(
                    NodeId.from_int(3),
                    Result(
                        client_id=cid, seq=9, status=int(status),
                        payload=(b"resp-a", b"resp-b"),
                    ),
                )
            )

    def test_read_index_all_modes(self):
        from rabia_tpu_torch.core.messages import ReadIndex, ReadIndexMode

        cid = uuid.uuid4()
        frames = [
            ReadIndex(mode=int(ReadIndexMode.READ), client_id=cid,
                      seq=5, shard=2, key=b"some-key"),
            ReadIndex(mode=int(ReadIndexMode.PROBE), client_id=cid,
                      seq=42),
            ReadIndex(mode=int(ReadIndexMode.REPLY), client_id=cid,
                      seq=42, frontier=(0, 1 << 50, 7)),
            ReadIndex(mode=int(ReadIndexMode.FETCH_RESULT),
                      client_id=cid, seq=3, shard=1,
                      key=uuid.uuid4().bytes),
        ]
        for p in frames:
            _roundtrip_both(ProtocolMessage.new(NodeId.from_int(2), p))

    def test_odd_shapes_decline_to_python(self):
        """Non-bytes blobs and out-of-range u32 fields route to the
        Python codec (native declines, never truncates)."""
        from rabia_tpu_torch.core.messages import ReadIndex, ReadIndexMode, Submit

        cid = uuid.uuid4()
        ser = BinarySerializer()
        odd = [
            Submit(client_id=cid, seq=1, shard=1,
                   commands=(bytearray(b"xx"),)),  # not exactly bytes
            Submit(client_id=cid, seq=1, shard=1 << 33,  # shard > u32
                   commands=(b"x",)),
            ReadIndex(mode=int(ReadIndexMode.READ), client_id=cid,
                      seq=1, shard=0, key=bytearray(b"k")),
        ]
        for p in odd:
            msg = ProtocolMessage.new(NodeId.from_int(1), p)
            assert native.encode(msg) is None, type(p).__name__
            # and the python path's behavior (bytes-like ok, range error)
            try:
                data = ser._serialize_py(msg)
            except SerializationError:
                continue  # python rejects too (e.g. oversized shard)
            except Exception:
                continue  # struct.error wrapped upstream by Serializer
            out = ser._deserialize_py(data)
            assert type(out.payload) is type(p)
