"""Block-lane schedules through the reference MeshEngine and the port's,
with ``device_store`` off (the host block lane over ``VectorShardedKV``)
and on (the device-resident KV lane), compared after every flush: the
flush outcome, every block and batch response, ``device_lane_active``;
and at the end ``next_slot``, ``decided_v1``, every shard's decision log
and every replica's store. The schedules mirror tests/test_device_kv.py:
versions and state, mixed and intra-block mixed windows, faults,
overflow, rollback order, idle cycles, checkpoints, re-promotion, the
deferred-DEL pipeline and its dirty rollback, a deeper pipe and evicted
value segments. The wall clock is pinned so store snapshots, which carry
timestamps, compare whole. n_shards = 8 fills the reference's 8-device
CPU mesh (no padding). The device lane runs each schedule on three
layouts, each against the reference on the same shape: the port on one
device (against the reference's ``make_mesh()``, 8x1), the port on the
logical mesh ``make_mesh(["cpu"] * 8)`` (8 shard blocks of one shard,
against the same) and on ``make_mesh(["cpu"] * 8, 2, 4)`` (2 shard blocks
x 4 replica blocks, R = 4, against ``make_mesh(shard_axis_size=2,
replica_axis_size=4)``): over a mesh the port's device table is cut in
shard blocks and every window launches once a block. Tolerance: exact
equality."""

from __future__ import annotations

import time
import uuid

import numpy as np
import pytest
import torch

from rabia_tpu.apps.vector_kv import VectorShardedKV as RefVKV
from rabia_tpu.core.blocks import build_block as ref_build_block
from rabia_tpu.core.errors import RabiaError as RefRabiaError
from rabia_tpu.parallel import MeshEngine as RefEngine
from rabia_tpu.parallel import make_mesh
from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.core.errors import RabiaError
from rabia_tpu_torch.parallel import MeshEngine
from rabia_tpu_torch.parallel import make_mesh as port_make_mesh

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

N, R = 8, 3

# layout: (the port's mesh or None for one device, the reference's mesh, R)
LAYOUTS = {
    "one": (lambda: None, lambda: make_mesh(), R),
    "8x1": (lambda: port_make_mesh(["cpu"] * 8), lambda: make_mesh(), R),
    "2x4": (lambda: port_make_mesh(["cpu"] * 8, 2, 4),
            lambda: make_mesh(shard_axis_size=2, replica_axis_size=4), 4),
    "4x2": (lambda: port_make_mesh(["cpu"] * 8, 4, 2),
            lambda: make_mesh(shard_axis_size=4, replica_axis_size=2), 4),
}


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.75)


def _op(code: int, key: str, val: str = "") -> bytes:
    kb = key.encode()
    return bytes((code,)) + len(kb).to_bytes(2, "little") + kb + val.encode()


def _set(k, v):
    return _op(1, k, v)


def _frames(res):
    if isinstance(res, Exception):
        return str(res)
    return [bytes(f) for f in res] if isinstance(res, list) and res and isinstance(res[0], bytes) \
        else [[bytes(f) for f in g] if not isinstance(g, Exception) else str(g) for g in res]


class Pair:
    """A reference engine and a port engine fed the same work."""

    def __init__(self, device_store: bool, window: int = 4, layout: str = "one", n: int = N,
                 **kw):
        port_mesh, ref_mesh, r = LAYOUTS[layout]
        mesh = port_mesh()
        where = {"device": "cpu"} if mesh is None else {"mesh": mesh}
        self.n = n
        self.ref = RefEngine(lambda: RefVKV(n, capacity=1 << 12), n, r, mesh=ref_mesh(),
                             window=window, device_store=device_store, **kw)
        self.port = MeshEngine(lambda: VectorShardedKV(n, capacity=1 << 12), n, r,
                               window=window, device_store=device_store, **where, **kw)
        if device_store and mesh is not None:
            assert self.port._dev.mesh is mesh  # the table is cut in shard blocks
        self.device_store = device_store
        self.futs: list = []
        self._ids = 0

    def blocks(self, stream):
        """Submit full- or partial-width blocks ((shards, cmds) pairs)."""
        for shards, cmds in stream:
            self._ids += 1
            bid = uuid.UUID(int=self._ids)
            self.futs.append((
                self.ref.submit_block(ref_build_block(shards, cmds, block_id=bid)),
                self.port.submit_block(build_block(shards, cmds, block_id=bid)),
            ))

    def wave(self, op_of_shard):
        self.blocks([(list(range(self.n)), [[op_of_shard(s)] for s in range(self.n)])])

    def submit(self, cmds, shard):
        self.futs.append((self.ref.submit(cmds, shard), self.port.submit(cmds, shard)))

    def both(self, fn):
        out = []
        for eng in (self.ref, self.port):
            try:
                out.append(fn(eng))
            except (RabiaError, RefRabiaError) as e:
                out.append(f"raised {e}")
        assert out[0] == out[1]
        return out[1]

    def flush(self, **kw):
        got = self.both(lambda e: e.flush(**kw))
        assert self.port.device_lane_active == self.ref.device_lane_active
        return got

    def active(self) -> bool:
        return self.port.device_lane_active

    def check(self):
        for i, (fr, fp) in enumerate(self.futs):
            assert fp.done() == fr.done(), i
            if fr.done():
                assert _frames(self._result(fp)) == _frames(self._result(fr)), i
        assert self.port.next_slot.tolist() == self.ref.next_slot.tolist()
        assert self.port.decided_v1 == self.ref.decided_v1
        assert self.port.decided_v0 == self.ref.decided_v0
        for s in range(self.n):
            logs = [{slot: (v, None if b is None else [c.data for c in b.commands])
                     for slot, (v, b) in eng.decisions_for(s).items()}
                    for eng in (self.ref, self.port)]
            assert logs[0] == logs[1], s

    @staticmethod
    def _result(f):
        try:
            return f.result()
        except (RabiaError, RefRabiaError) as e:
            return e

    def final(self):
        """Compare everything, sync the device tables down and compare
        every replica's store."""
        self.check()
        for eng in (self.ref, self.port):
            eng.sync_to_host()
        want = self.ref.sms[0].store.snapshot_bytes()
        for eng in (self.ref, self.port):
            for sm in eng.sms:
                assert sm.store.snapshot_bytes() == want


# the host lane on one device, the device lane on every layout
DEVICE_STORE = pytest.mark.parametrize(
    "device_store,layout", [(False, "one"), (True, "one"), (True, "8x1"), (True, "2x4")],
    ids=["host", "device", "device-8x1", "device-2x4"])


def _random_sets(rng, waves, keyspace=3):
    return [(list(range(N)), [[_set(f"k{s}_{int(rng.integers(0, keyspace))}",
                                    "v" * int(rng.integers(0, 24)) + f"{w}")] for s in range(N)])
            for w in range(waves)]


def _kind_fuzz(rng, waves):
    out = []
    for w in range(waves):
        cmds = []
        for s in range(N):
            k = f"k{s}_{int(rng.integers(0, 2))}"
            x = rng.random()
            code = 1 if x < 0.45 else 2 if x < 0.75 else 3 if x < 0.9 else 4
            cmds.append([_set(k, f"v{w}_{s}") if code == 1 else _op(code, k)])
        out.append((list(range(N)), cmds))
    return out


@DEVICE_STORE
@pytest.mark.parametrize("seed", [0, 1])
def test_versions_and_state_match(device_store, layout, seed):
    p = Pair(device_store, layout=layout)
    p.blocks(_random_sets(np.random.default_rng(seed), 6))
    assert p.flush() == 6 * N
    assert p.active() == device_store  # clean SET windows: no demotion
    p.final()


@DEVICE_STORE
def test_mixed_fifo_and_intra_block_mixed_stay_in_lane(device_store, layout):
    p = Pair(device_store, layout=layout)
    rng = np.random.default_rng(5)
    p.blocks(_random_sets(rng, 3))
    for w in range(2):  # GET run, including never-set keys
        p.wave(lambda s, w=w: _op(2, f"k{s}_{w}"))
    p.wave(lambda s: _set(f"k{s}_0", "after"))
    p.wave(lambda s: _op(2, f"k{s}_0"))
    p.wave(lambda s: _op(2, "missing"))
    for w in range(3):  # one block interleaving SET and GET across shards
        p.wave(lambda s, w=w: _set(f"k{s}_1", f"w{w}") if s % 2 == w % 2 else _op(2, f"k{s}_1"))
    p.flush()
    assert p.active() == device_store
    p.blocks(_kind_fuzz(np.random.default_rng(11), 9))
    p.flush()
    assert p.active() == device_store
    p.final()


@DEVICE_STORE
def test_faults_demote_without_corruption(device_store, layout):
    p = Pair(device_store, layout=layout)
    p.blocks(_random_sets(np.random.default_rng(3), 2))
    p.flush()
    p.both(lambda e: e.crash_replica(2))  # minority: the lane keeps going
    p.blocks(_random_sets(np.random.default_rng(4), 2))
    p.flush()
    assert p.active() == device_store
    p.both(lambda e: e.crash_replica(1))  # majority: the flush stalls
    p.wave(lambda s: _set(f"k{s}_0", "parked"))
    assert "quorum lost" in p.flush(max_cycles=3)
    assert not p.futs[-1][1].done()
    for r in (1, 2):
        p.both(lambda e, r=r: e.heal_replica(r))
    p.flush()
    assert not p.active()  # the dirty window demoted the lane
    p.final()


@DEVICE_STORE
def test_overflow_demotes(device_store, layout):
    p = Pair(device_store, layout=layout, device_store_kw={"per_shard_capacity": 4})
    for w in range(6):  # 6 distinct keys per shard overflow the 4-slot table
        p.wave(lambda s, w=w: _set(f"key{w}", "x"))
    assert p.flush() == 6 * N
    assert not p.active()
    p.final()


@DEVICE_STORE
def test_rollback_respects_submission_order_vs_queued_batches(device_store, layout):
    p = Pair(device_store, layout=layout, window=8, device_store_kw={"per_shard_capacity": 4})
    for w in range(6):
        p.wave(lambda s, w=w: _set(f"key{w}", "x"))
    p.wave(lambda s: _set("k", "A"))
    p.both(lambda e: e.run_cycle())  # the window is in flight on the device lane
    assert bool(p.port._dev is not None and p.port._dev_pipe) == device_store
    p.submit([_set("k", "B")], 0)  # a newer write of the same key meanwhile
    p.flush()
    assert not p.active()
    p.final()
    assert p.port.sms[0].store.get(0, b"k")[0] == b"B"


@DEVICE_STORE
def test_idle_cycle_and_checkpoint(device_store, layout):
    p = Pair(device_store, layout=layout)
    assert p.both(lambda e: e.run_cycle()) == 0  # nothing queued: not work
    assert p.active() == device_store
    p.blocks(_random_sets(np.random.default_rng(9), 3))
    p.flush()
    cps = [e.checkpoint() for e in (p.ref, p.port)]
    assert p.active() == device_store  # a checkpoint does not leave device mode
    assert cps[0].to_bytes() == cps[1].to_bytes()
    r = p.port.R
    fresh = [RefEngine(lambda: RefVKV(N), N, r, mesh=make_mesh(), window=4),
             MeshEngine(lambda: VectorShardedKV(N), N, r, window=4, device="cpu")]
    for eng, cp in zip(fresh, cps):
        eng.restore(cp)
    assert fresh[1].sms[0].store.snapshot_bytes() == fresh[0].sms[0].store.snapshot_bytes()
    p.final()


@DEVICE_STORE
def test_demote_then_repromote(device_store, layout):
    p = Pair(device_store, layout=layout, device_store_repromote=4)
    rng = np.random.default_rng(11)
    p.blocks(_random_sets(rng, 3))
    p.flush()
    p.wave(lambda s: _set(f"k{s}_0", "y" * 100))  # wider than the table's values
    p.flush()
    assert not p.active()
    p.wave(lambda s: _set(f"k{s}_0", "ok"))  # back inside the envelope
    p.flush()
    for _ in range(3):
        p.blocks(_random_sets(rng, 3))
        p.flush()
    assert p.active() == device_store, "device lane did not re-promote"
    p.wave(lambda s: _op(2, f"k{s}_0"))  # values from before the promotion
    p.blocks(_random_sets(rng, 4))
    p.flush()
    assert p.active() == device_store
    p.final()


@DEVICE_STORE
def test_deferred_del_pipeline_and_deeper_pipe(device_store, layout):
    p = Pair(device_store, layout=layout, window=2, device_store_inflight=3)
    for op in (_set("a", "v0"), _set("b", "v1"), _op(3, "a"), _op(3, "missing"),
               _set("a", "v2"), _set("c", "v3"), _op(2, "a"), _op(4, "b"),
               _set("b", "v4"), _op(3, "c"), _op(2, "b"), _op(2, "c")):
        p.wave(lambda s, op=op: op)
    p.flush()
    assert p.active() == device_store
    if device_store:
        assert p.port._dev_defer == 0 and not p.port._dev_pipe
    p.final()


@DEVICE_STORE
def test_deferred_del_window_dirty_rollback(device_store, layout):
    p = Pair(device_store, layout=layout, window=4, device_store_kw={"per_shard_capacity": 4})
    for w in range(3):
        p.wave(lambda s, w=w: _set(f"k{w}", "x"))
    p.flush()
    # a DEL-bearing (deferred) window that overflows, and a deferred SET
    # window dispatched behind it
    for op in (_op(3, "k0"), _set("k3", "x"), _set("k4", "x"), _set("k5", "x")):
        p.wave(lambda s, op=op: op)
    for w in range(4):
        p.wave(lambda s, w=w: _set(f"m{w}", "y"))
    p.both(lambda e: e.run_cycle())
    if device_store:
        assert p.port._dev_pipe and p.port._dev_defer == 1
    p.both(lambda e: e.close())  # resolves the in-flight windows: dirty, demotes
    assert not p.active()
    p.flush()
    assert not p.active()
    if device_store:
        assert p.port._dev_defer == 0 and not p.port._dev_pipe
    p.final()


def test_evicted_segment_falls_back_to_value_download():
    _evicted_segment_falls_back(Pair(True))


@pytest.mark.parametrize("layout", ["8x1", "2x4"])
def test_evicted_segment_falls_back_on_meshes(layout):
    _evicted_segment_falls_back(Pair(True, layout=layout))


def _evicted_segment_falls_back(p):
    for eng in (p.ref, p.port):
        eng._dev_vseg_cap = 1  # evict every settled segment at once
    for w in range(3):
        p.wave(lambda s, w=w: _set(f"k{s}", f"w{w}"))
        p.flush()  # one window (one segment) per block
    p.wave(lambda s: _op(2, f"k{s}"))
    p.flush()
    assert p.active()
    assert bool((p.port._dev_floor[:N] > 0).any())  # evictions happened
    p.final()


@DEVICE_STORE
def test_partial_blocks_and_scalar_batches(device_store, layout):
    # blocks that do not cover every shard and scalar batches take the
    # per-shard queue lane with bulk apply (and demote a device lane)
    p = Pair(device_store, layout=layout)
    p.blocks(_random_sets(np.random.default_rng(2), 2))
    p.blocks([([1, 5, 6], [[_set("p", "1")], [_op(2, "k5_0"), _set("q", "2")], [_op(3, "p")]])])
    p.submit([_set("z", "9"), _op(2, "z")], 3)
    p.submit([], 4)  # an empty batch commits as a no-op
    p.flush()
    assert not p.active()
    p.final()


def test_padded_shards_on_a_4x2_mesh():
    """6 shards on a 4 x 2 mesh pad to 8 in both engines (the last shard
    block holds padded shards only): SET, GET and mixed windows, a
    minority crash, an overflow's demotion and the re-promotion equal the
    reference's, and the padded shards never hold an entry."""
    p = Pair(True, layout="4x2", n=6, device_store_kw={"per_shard_capacity": 8},
             device_store_repromote=2)
    assert p.port.S == p.ref.S == 8
    rng = np.random.default_rng(13)
    for w in range(3):
        p.wave(lambda s, w=w: _set(f"k{s}_{w}", f"v{w}"))
    p.wave(lambda s: _op(2, f"k{s}_1"))
    p.wave(lambda s: (_op(3, f"k{s}_0"), _op(4, f"k{s}_2"), _op(2, "none"))[s % 3])
    p.flush()
    assert p.active()
    p.both(lambda e: e.crash_replica(3))
    for w in range(6):  # 3 keys and 6 more overflow the 8-slot table
        p.wave(lambda s, w=w: _set(f"o{w}", f"x{int(rng.integers(0, 9))}"))
    p.flush()
    assert not p.active()
    p.both(lambda e: e.heal_replica(3))
    p.wave(lambda s: _op(3, "o5"))
    for w in range(4):
        p.wave(lambda s, w=w: _set("o0", f"y{w}"))
        p.flush()
    assert p.active()  # re-promoted onto a table that holds every key
    used = p.port._dev.state.used.numpy()
    assert not used[6:].any()
    p.final()
