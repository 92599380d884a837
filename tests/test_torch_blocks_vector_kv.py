"""The port's payload blocks, binary KV codec and columnar vector store
against the reference package's: block fields and ids, op and result
frames, and ``VectorShardedKV`` responses and snapshot bytes on random
SET/GET/DEL/EXISTS blocks (long keys that overflow the inline table,
values that are not UTF-8). The wall clock is pinned so snapshot bytes,
which carry timestamps, compare whole. Tolerance: exact equality (every
output is bytes or an integer)."""

from __future__ import annotations

import time
import uuid

import numpy as np
import pytest

from rabia_tpu.apps import kvstore as ref_kv
from rabia_tpu.apps import vector_kv as ref_vkv
from rabia_tpu.core import blocks as ref_blocks
from rabia_tpu_torch.apps import kvstore as kv
from rabia_tpu_torch.apps import vector_kv as vkv
from rabia_tpu_torch.core import blocks
from rabia_tpu_torch.core.errors import ValidationError


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)


def _raw_op(code: int, key: bytes, payload: bytes = b"") -> bytes:
    return bytes((code,)) + len(key).to_bytes(2, "little") + key + payload


def _random_blocks(rng, n_shards: int, waves: int, *, set_only=False, multi=False):
    """Random blocks: every shard or a subset, 1 or more ops per shard,
    keys from a small space (hits, misses, updates), some keys past the
    32-byte inline width, some values not UTF-8."""
    out = []
    for w in range(waves):
        k = n_shards if rng.random() < 0.6 else int(rng.integers(1, n_shards + 1))
        shards = sorted(rng.choice(n_shards, size=k, replace=False).tolist())
        cmds = []
        for s in shards:
            ops = []
            for _ in range(int(rng.integers(1, 4)) if multi else 1):
                j = int(rng.integers(0, 6))
                key = (b"key%d" % j) if j < 5 else b"L" * 40 + b"%d" % s
                x = 0.0 if set_only else rng.random()
                if x < 0.45:
                    val = bytes(rng.integers(0, 256, int(rng.integers(0, 12))).astype(np.uint8))
                    if rng.random() < 0.5:
                        val = b"v%d.%d" % (w, s)
                    ops.append(_raw_op(1, key, val))
                elif x < 0.7:
                    ops.append(_raw_op(2, key))
                elif x < 0.85:
                    ops.append(_raw_op(3, key))
                elif x < 0.95:
                    ops.append(_raw_op(4, key))
                else:
                    ops.append(_raw_op(9, key))  # unknown opcode
            cmds.append(ops)
        out.append((shards, cmds))
    return out


def _frames(resp):
    return None if resp is None else [[bytes(f) for f in g] for g in resp]


def test_block_fields_and_ids_match_reference():
    bid = uuid.UUID(int=0x1234_5678_9ABC_DEF0_1111_2222_3333_4444)
    shards = [3, 0, 7, 5]
    cmds = [[b"a", b"bc"], [b""], [b"x" * 10, b"y", b"z"], [b"q"]]
    b = blocks.build_block(shards, cmds, block_id=bid)
    r = ref_blocks.build_block(shards, cmds, block_id=bid)
    for name in ("shards", "slots", "counts", "cmd_sizes", "cmd_offsets", "shard_starts"):
        np.testing.assert_array_equal(getattr(b, name), getattr(r, name), err_msg=name)
    assert b.data == r.data and len(b) == len(r) and b.total_commands == r.total_commands
    assert b.checksum() == r.checksum()
    for i in range(len(shards)):
        assert b.commands_for(i) == r.commands_for(i)
        assert b.batch_id_for(i).value == r.batch_id_for(i).value
        mb, mr = b.materialize_batch(i), r.materialize_batch(i)
        assert mb.id.value == mr.id.value and int(mb.shard) == int(mr.shard)
        assert [c.data for c in mb.commands] == [c.data for c in mr.commands]
        assert blocks.block_id_for_batch(mb.id, shards[i]) == bid
        assert ref_blocks.block_id_for_batch(mr.id, shards[i]) == bid
    sub_b, sub_r = b.subset(np.array([2, 0])), r.subset(np.array([2, 0]))
    assert sub_b.data == sub_r.data and sub_b.id == sub_r.id
    np.testing.assert_array_equal(sub_b.counts, sub_r.counts)
    with pytest.raises(ValidationError):
        blocks.build_block([1, 1], [[b"a"], [b"b"]])
    with pytest.raises(ValidationError):
        blocks.build_block([1], [[]])


def test_kv_codec_matches_reference():
    ops = [
        ("Set", "k", "v"), ("Get", "key", None), ("Delete", "ä", None),
        ("Exists", "e", None), ("Clear", "", None), ("Cas", "c", "w"),
    ]
    for name, key, val in ops:
        op = kv.KVOperation(kv.KVOpType[name], key, val, 7)
        ref_op = ref_kv.KVOperation(ref_kv.KVOpType[name], key, val, 7)
        raw = kv.encode_op_bin(op)
        assert raw == ref_kv.encode_op_bin(ref_op)
        back, ref_back = kv.decode_op_bin(raw), ref_kv.decode_op_bin(raw)
        assert (back.op.value, back.key, back.value, back.expected_version) == (
            ref_back.op.value, ref_back.key, ref_back.value, ref_back.expected_version)
    assert kv.encode_set_bin("k", "v") == ref_kv.encode_set_bin("k", "v")
    assert kv.encode_cas_bin("k", "v", 9) == ref_kv.encode_cas_bin("k", "v", 9)
    for args in ((0, 5, "x"), (1, 0), (2, 3, "err"), (0, 0, ""), (0, 2**32 + 3)):
        frame = kv._result_bin(*args)
        assert frame == ref_kv._result_bin(*args)
        a, b = kv.decode_kv_response(frame), ref_kv.decode_kv_response(frame)
        assert (a.kind.value, a.value, a.version, a.error) == (b.kind.value, b.value, b.version, b.error)
        assert kv.decode_result_bin(frame).ok == ref_kv.decode_result_bin(frame).ok
    doc = b'{"kind": "success", "value": "x", "version": 3}'
    assert kv.decode_kv_response(doc).version == ref_kv.decode_kv_response(doc).version == 3
    for bad in (b"", b"\x09\x00\x00", b"\x01\x05\x00ab"):
        with pytest.raises(Exception) as e_port:
            kv.decode_op_bin(bad)
        with pytest.raises(Exception) as e_ref:
            ref_kv.decode_op_bin(bad)
        assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("path", ["apply_block", "apply_block_multi", "apply_batch"])
def test_vector_store_matches_reference(fixed_clock, seed, path):
    n = 6
    rng = np.random.default_rng(seed)
    stream = _random_blocks(rng, n, 10, multi=(path != "apply_block_multi"))
    port = [vkv.VectorShardedKV(n, capacity=16) for _ in range(2)]
    ref = [ref_vkv.VectorShardedKV(n, capacity=16) for _ in range(2)]
    for i in range(0, len(stream), 3):
        group = stream[i : i + 3]
        bid = uuid.UUID(int=1000 + i)
        pb = [blocks.build_block(s, c, block_id=bid) for s, c in group]
        rb = [ref_blocks.build_block(s, c, block_id=bid) for s, c in group]
        for j, (sm, rsm) in enumerate(zip(port, ref)):
            want = j == 0  # a follower skips its responses, as the engine asks
            if path == "apply_block":
                for b, r in zip(pb, rb):
                    idx = np.arange(len(b))
                    assert _frames(sm.apply_block(b, idx, want)) == _frames(rsm.apply_block(r, idx, want))
            elif path == "apply_block_multi":
                got = sm.apply_block_multi(pb, [np.arange(len(b)) for b in pb], want)
                exp = rsm.apply_block_multi(rb, [np.arange(len(b)) for b in rb], want)
                if got is None or exp is None:
                    assert got is None and exp is None
                else:
                    assert [_frames(g) for g in got] == [_frames(e) for e in exp]
            else:
                for b, r in zip(pb, rb):
                    for k in range(len(b)):
                        assert sm.apply_batch(b.materialize_batch(k)) == rsm.apply_batch(
                            r.materialize_batch(k))
    for sm, rsm in zip(port, ref):
        assert sm.store.snapshot_bytes() == rsm.store.snapshot_bytes()
        assert sm.create_snapshot().data == rsm.create_snapshot().data
        assert len(sm.store) == len(rsm.store)
        assert sm.get_state_summary() == rsm.get_state_summary()


def test_set_only_multi_wave_bulk_path_matches_reference(fixed_clock):
    # full-width SET waves take apply_block_multi's one-pass bulk_set
    n = 8
    rng = np.random.default_rng(5)
    stream = [(list(range(n)), [[_raw_op(1, b"k%d" % int(rng.integers(0, 3)), b"v%d" % w)]
                                for _ in range(n)]) for w in range(5)]
    pb = [blocks.build_block(s, c, block_id=uuid.UUID(int=7)) for s, c in stream]
    rb = [ref_blocks.build_block(s, c, block_id=uuid.UUID(int=7)) for s, c in stream]
    sm, rsm = vkv.VectorShardedKV(n), ref_vkv.VectorShardedKV(n)
    got = sm.apply_block_multi(pb, [np.arange(n)] * 5)
    exp = rsm.apply_block_multi(rb, [np.arange(n)] * 5)
    assert isinstance(got[0], vkv.FrameGroups)
    assert [_frames(g) for g in got] == [_frames(e) for e in exp]
    assert list(got[0].group_counts()) == [1] * n
    assert sm.store.snapshot_bytes() == rsm.store.snapshot_bytes()


def test_snapshot_restore_round_trips_across_packages(fixed_clock):
    n = 4
    rng = np.random.default_rng(9)
    sm, rsm = vkv.VectorShardedKV(n), ref_vkv.VectorShardedKV(n)
    for shards, cmds in _random_blocks(rng, n, 8, multi=True):
        b = blocks.build_block(shards, cmds)
        r = ref_blocks.build_block(shards, cmds)
        sm.apply_block(b, np.arange(len(b)))
        rsm.apply_block(r, np.arange(len(r)))
    raw = rsm.store.snapshot_bytes()
    assert sm.store.snapshot_bytes() == raw
    fresh = vkv.VectorShardedKV(n)
    fresh.store.restore_bytes(raw)  # a reference snapshot restores into the port
    assert fresh.store.snapshot_bytes() == raw
    part = vkv.VectorShardedKV(n)
    part.store.restore_shards_bytes(raw, [1, 3])
    ref_part = ref_vkv.VectorShardedKV(n)
    ref_part.store.restore_shards_bytes(raw, [1, 3])
    assert part.store.snapshot_bytes() == ref_part.store.snapshot_bytes()
