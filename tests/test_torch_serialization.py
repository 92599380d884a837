"""The port's wire codec against the reference's, byte for byte.

Seeded instances of every message kind (every ``MessageType``, with and
without a recipient, compressed and not) are built in both packages from
the same values and serialized with both packages' ``Serializer``: the
bytes must be equal, and each package must decode the other's bytes into
a message that serializes back to the same bytes. The reference encodes
its hot frame types with its C codec where that loads; the ``python``
case holds its Python codec too. The JSON codec is held the same way."""

from __future__ import annotations

import importlib
import uuid

import numpy as np
import pytest

import rabia_tpu_torch.core.messages as port_messages

KINDS = [t.name for t in port_messages.MessageType]


class _Pkg:
    """One package's message, type and codec modules."""

    def __init__(self, name: str) -> None:
        self.m = importlib.import_module(f"{name}.core.messages")
        self.t = importlib.import_module(f"{name}.core.types")
        self.b = importlib.import_module(f"{name}.core.blocks")
        self.ser = importlib.import_module(f"{name}.core.serialization")
        self.cfg = importlib.import_module(f"{name}.core.config")


REF, PORT = _Pkg("rabia_tpu"), _Pkg("rabia_tpu_torch")


def _uuid(rng) -> uuid.UUID:
    return uuid.UUID(int=int(rng.integers(0, 2**63)) << 64 | int(rng.integers(0, 2**63)))


def _bytes(rng, size: int) -> bytes:
    """Random bytes; large bodies draw from 4 values so zlib shrinks them
    (the codec compresses only when that pays)."""
    return bytes(rng.integers(0, 256 if size < 1000 else 4, size, dtype=np.uint8))


def _batch(p: _Pkg, rng, n_cmds: int, size: int):
    cmds = tuple(p.t.Command(id=_uuid(rng), data=_bytes(rng, size)) for _ in range(n_cmds))
    return p.t.CommandBatch(
        id=p.t.BatchId(_uuid(rng)), commands=cmds, timestamp=float(rng.random()) * 1e9,
        shard=p.t.ShardId(int(rng.integers(0, 64))),
    )


def _payload(p: _Pkg, kind: str, seed: int, big: bool):
    """The payload of one kind, from ``seed`` alone (both packages get
    the same values)."""
    rng = np.random.default_rng(seed)
    M, T = p.m, p.t
    n = int(rng.integers(1, 40))
    shards = rng.integers(0, 4096, n)
    phases = (rng.integers(0, 2**20, n) << 16) | rng.integers(0, 2**16, n)
    vals = rng.integers(0, 3, n).astype(np.int8)
    size = 6000 if big else 12
    if kind == "Propose":
        return M.Propose(
            shard=int(shards[0]), phase=int(phases[0]), batch_id=T.BatchId(_uuid(rng)),
            value=T.StateValue(int(vals[0]) % 2), batch=_batch(p, rng, 3, size),
        )
    if kind in ("VoteRound1", "VoteRound2"):
        return getattr(M, kind)(shards=shards, phases=phases, vals=vals)
    if kind == "Decision":
        bids = [T.BatchId(_uuid(rng)) if rng.random() < 0.5 else None for _ in range(n)]
        return M.Decision(shards=shards, phases=phases, vals=vals % 2, bids=bids)
    if kind == "SyncRequest":
        return M.SyncRequest(current_phase=int(phases[0]), state_version=n)
    if kind == "SyncResponse":
        return M.SyncResponse(
            responder_phase=int(phases[0]), state_version=n,
            snapshot=_bytes(rng, size),
            per_shard_phase=tuple(int(x) for x in shards),
            applied_ids=tuple((int(s), T.BatchId(_uuid(rng))) for s in shards[:5]),
            per_shard_version=tuple(int(x) for x in vals),
        )
    if kind == "NewBatch":
        return M.NewBatch(shard=int(shards[0]), batch=_batch(p, rng, 4, size))
    if kind == "HeartBeat":
        return M.HeartBeat(current_phase=int(phases[0]), committed_phase=int(phases[-1]))
    if kind == "QuorumNotification":
        return M.QuorumNotification(
            has_quorum=bool(rng.random() < 0.5),
            active_nodes=tuple(T.NodeId.from_int(int(i)) for i in shards[:5]),
        )
    if kind == "ProposeBlock":
        sh = np.unique(shards)
        cmds = [
            [bytes(rng.integers(0, 256, int(rng.integers(1, 30)), dtype=np.uint8))
             for _ in range(int(rng.integers(1, 4)))]
            for _ in sh
        ]
        block = p.b.build_block(sh, cmds, block_id=_uuid(rng))
        block.slots[:] = rng.integers(0, 1000, len(sh))
        return M.ProposeBlock(block=block)
    if kind == "ClientHello":
        return M.ClientHello(
            client_id=_uuid(rng), ack=bool(rng.random() < 0.5), last_seq=n, max_inflight=7
        )
    if kind == "Submit":
        return M.Submit(
            client_id=_uuid(rng), seq=n, shard=int(shards[0]),
            commands=tuple(bytes(rng.integers(0, 256, 9, dtype=np.uint8)) for _ in range(3)),
            ack_upto=n // 2,
        )
    if kind == "Result":
        return M.Result(
            client_id=_uuid(rng), seq=n, status=int(rng.integers(0, 4)),
            payload=(b"OK", bytes(rng.integers(0, 256, 5, dtype=np.uint8))),
        )
    if kind == "ReadIndex":
        return M.ReadIndex(
            mode=1, client_id=_uuid(rng), seq=n, shard=int(shards[0]), key=b"key",
            frontier=tuple(int(x) for x in phases[:6]),
        )
    if kind == "AdminRequest":
        return M.AdminRequest(kind=2, nonce=n, query=b'{"q": 1}')
    if kind == "AdminResponse":
        return M.AdminResponse(nonce=n, status=0, body=b"body" * n)
    raise AssertionError(f"no builder for message kind {kind}")


def _message(p: _Pkg, kind: str, seed: int, big: bool, to: bool):
    rng = np.random.default_rng(seed + 10_000)
    return p.m.ProtocolMessage(
        id=_uuid(rng),
        sender=p.t.NodeId.from_int(int(rng.integers(1, 9))),
        recipient=p.t.NodeId.from_int(int(rng.integers(1, 9))) if to else None,
        timestamp=float(rng.random()) * 2e9,
        payload=_payload(p, kind, seed, big),
    )


def _serializers(binary: bool, ref_codec: str):
    ref = REF.ser.Serializer(REF.cfg.SerializationConfig(use_binary=binary))
    port = PORT.ser.Serializer(PORT.cfg.SerializationConfig(use_binary=binary))
    if ref_codec == "python":
        ref._binary._native = None  # the reference's Python codec
    return ref, port


def test_every_message_kind_is_covered():
    assert [t.name for t in REF.m.MessageType] == KINDS
    assert int(PORT.m.MessageType.AdminResponse) == int(REF.m.MessageType.AdminResponse)


@pytest.mark.parametrize("ref_codec", ["default", "python"])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "json"])
@pytest.mark.parametrize("kind", KINDS)
def test_bytes_equal_and_cross_decode(kind, binary, ref_codec):
    ref_ser, port_ser = _serializers(binary, ref_codec)
    cases = [(seed, big, to) for seed in (1, 2, 3) for big in (False, True) for to in (False, True)]
    for seed, big, to in cases:
        where = f"{kind} seed={seed} big={big} to={to}"
        ref_msg = _message(REF, kind, seed, big, to)
        port_msg = _message(PORT, kind, seed, big, to)
        ref_bytes = ref_ser.serialize(ref_msg)
        port_bytes = port_ser.serialize(port_msg)
        assert port_bytes == ref_bytes, where
        # each package decodes the other's bytes...
        port_from_ref = port_ser.deserialize(ref_bytes)
        ref_from_port = ref_ser.deserialize(port_bytes)
        assert type(port_from_ref.payload).__name__ == kind, where
        assert port_from_ref.id == port_msg.id and port_from_ref.sender == port_msg.sender
        assert port_from_ref.payload == port_msg.payload, where
        # ...into a message that serializes back to the same bytes
        assert port_ser.serialize(port_from_ref) == ref_bytes, where
        assert ref_ser.serialize(ref_from_port) == ref_bytes, where


def test_compression_engages_on_large_bodies():
    _ref, port_ser = _serializers(True, "default")
    small = port_ser.serialize(_message(PORT, "NewBatch", 5, False, False))
    big = port_ser.serialize(_message(PORT, "NewBatch", 5, True, False))
    assert small[2] & 1 == 0 and big[2] & 1 == 1  # flags byte, bit0 = zlib
