"""The generator: the same seed gives the same inputs, another seed other
inputs of the same sizes; blocks decode as the mix says."""

import json

import numpy as np
import torch

from pbench import spec
from pbench import traffic as tr

CFG = dict(json.loads((spec.HERE / "configs" / "kv-r5-s4096.json").read_text()), shards=32)


def _mix(name: str, **over) -> dict:
    return dict(json.loads((spec.HERE / "traffic" / f"{name}.json").read_text()), **over)


def _flat(blocks) -> list:
    return [(b.shards.tobytes(), b.cmd_sizes.tobytes(), b.data, b.n_set, b.n_get) for b in blocks]


def test_same_seed_same_blocks():
    mix = _mix("ycsbA", pool_blocks=8)
    seed = 2**40 + 7  # past 32 bits, as the driver's seeds are
    load, pool = tr.kv_streams(CFG, mix, seed)
    again = tr.kv_streams(CFG, mix, seed)
    assert _flat(load) == _flat(again[0]) and _flat(pool) == _flat(again[1])
    other = tr.kv_streams(CFG, mix, seed + 1)[1]
    assert _flat(other) != _flat(pool)
    assert [len(b.shards) for b in other] == [CFG["shards"]] * 8
    assert sum(b.n_set for b in other) == sum(b.n_set for b in pool)  # the same work


def test_blocks_decode_as_the_mix_says():
    mix = _mix("ycsbC", pool_blocks=4)
    keys = tr.key_table(CFG["shards"], CFG["keys_per_shard"], CFG["key_bytes"])
    distinct = {k.tobytes() for k in keys.reshape(-1, CFG["key_bytes"])}
    assert len(distinct) == keys.shape[0] * keys.shape[1]
    load, pool = tr.kv_streams(CFG, mix, 5)
    K, V = CFG["key_bytes"], CFG["value_bytes"]
    for b in pool:
        raw = np.frombuffer(b.data, np.uint8)
        off = np.concatenate([[0], np.cumsum(b.cmd_sizes)[:-1]])
        assert (raw[off] == tr.GET).all() and b.n_set == 0
        assert (b.cmd_sizes == tr.HEADER + K).all()
        assert {bytes(raw[o + tr.HEADER:o + tr.HEADER + K]) for o in off} <= distinct
    assert len(load) == CFG["keys_per_shard"]
    values = set()
    for j, b in enumerate(load):
        raw = np.frombuffer(b.data, np.uint8)
        assert b.n_set == CFG["shards"] and (b.cmd_sizes == tr.HEADER + K + V).all()
        for s, o in enumerate(np.arange(CFG["shards"]) * (tr.HEADER + K + V)):
            assert raw[o] == tr.SET and int(raw[o + 1]) + 256 * int(raw[o + 2]) == K
            assert bytes(raw[o + tr.HEADER:o + tr.HEADER + K]) == keys[s, j].tobytes()
            value = raw[o + tr.HEADER + K:o + tr.HEADER + K + V]
            assert ((value >= 33) & (value < 127)).all()  # printable, as YCSB's fields
            values.add(value.tobytes())
    assert len(values) > 0.99 * len(load) * CFG["shards"]


def test_ycsbA_mixes_reads_and_updates():
    blocks = tr.kv_streams(CFG, _mix("ycsbA", pool_blocks=64), 11)[1]
    sets = sum(b.n_set for b in blocks)
    assert sets == 32 * CFG["shards"]  # every shard: half its ops updates


def test_vote_planes_same_seed_same_votes():
    mix = _mix("decide-bulk", slots_per_window=16)
    cfg = dict(CFG, shards=24)
    a = tr.vote_planes(cfg, mix, 99, torch.device("cpu"))
    b = tr.vote_planes(cfg, mix, 99, torch.device("cpu"))
    assert len(a) == mix["buffers"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (cfg["replicas"], 16, 24) and a[0].dtype == torch.int8
    assert not torch.equal(a[0], tr.vote_planes(cfg, mix, 100, torch.device("cpu"))[0])
