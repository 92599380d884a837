"""The device lane's consensus-free read lane (``device_read_lane=True``)
against the reference engine's, and against the port's own lane with the
read lane off.

Ports the cases of the reference's tests/test_read_lane.py: a flushed
stream frames byte-identically (lane on and off, against the host
store), probe reads consume zero slots, a GET racing an in-flight SET
window sees that SET or a later one, versions never go backwards, an
evicted value segment falls back to the value download and is counted, a
demotion with reads parked flushes them to the host path and the lane
re-engages, and reads survive a minority crash. The reference's claim
that a probe exchanges nothing across replicas is a jaxpr census, which
the port cannot reuse; here it is three facts: a probe reaches neither
the decision nor ``slot_window`` (spies on the plain path), it consumes
no slot (``next_slot`` and the decision log do not move), and it serves
with a majority of replicas crashed. Over a mesh the census claim is
stated in the port's terms: with the mesh's collectives and the replica
exchange patched to raise, a probe on a 2 x 4 mesh table still serves,
one read scan a shard block. Every case runs the reference engine beside
the port's, and compares responses and read-lane counters; the
conformance and edge cases run again with the port on the logical meshes
``make_mesh(["cpu"] * 8)`` (8x1) and ``make_mesh(["cpu"] * 8, 2, 4)``
(R = 4), each against the reference on the same shape. Tolerance: exact
equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rabia_tpu.apps.kvstore import decode_result_bin as ref_decode
from rabia_tpu.apps.vector_kv import VectorShardedKV as RefVKV
from rabia_tpu.core.blocks import build_block as ref_build_block
from rabia_tpu.parallel import MeshEngine as RefEngine
from rabia_tpu.parallel import make_mesh
from rabia_tpu_torch.apps.kvstore import decode_result_bin
from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.kernel import kv_window, mesh_window
from rabia_tpu_torch.parallel import MeshEngine
from rabia_tpu_torch.parallel import make_mesh as port_make_mesh

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

N_SHARDS = 8

# layout: (the port's mesh or None for one device, the reference's mesh, R)
LAYOUTS = {
    "one": (lambda: None, lambda: make_mesh(), 3),
    "8x1": (lambda: port_make_mesh(["cpu"] * 8), lambda: make_mesh(), 3),
    "2x4": (lambda: port_make_mesh(["cpu"] * 8, 2, 4),
            lambda: make_mesh(shard_axis_size=2, replica_axis_size=4), 4),
}


def _op(code: int, key: str, val: str = "") -> bytes:
    kb = key.encode()
    return bytes((code,)) + len(kb).to_bytes(2, "little") + kb + val.encode()


def set_ops(tag: str, val: str) -> list:
    return [[_op(1, f"{tag}-{s}", val)] for s in range(N_SHARDS)]


def get_ops(tag: str) -> list:
    return [[_op(2, f"{tag}-{s}")] for s in range(N_SHARDS)]


class Lanes:
    """The reference engine and the port's, fed the same blocks."""

    def __init__(self, read_lane: bool, layout: str = "one", **kw):
        port_mesh, ref_mesh, r = LAYOUTS[layout]
        mesh = port_mesh()
        common = dict(window=4, device_store=True, device_read_lane=read_lane, **kw)
        self.ref = RefEngine(lambda: RefVKV(N_SHARDS, capacity=1 << 12), N_SHARDS, r,
                             mesh=ref_mesh(), **common)
        self.port = MeshEngine(lambda: VectorShardedKV(N_SHARDS, capacity=1 << 12), N_SHARDS, r,
                               **({"device": "cpu"} if mesh is None else {"mesh": mesh}), **common)

    def submit(self, cmds):
        """Returns (reference future, port future)."""
        shards = list(range(N_SHARDS))
        return (self.ref.submit_block(ref_build_block(shards, cmds)),
                self.port.submit_block(build_block(shards, cmds)))

    def flush(self, **kw):
        got = [e.flush(**kw) for e in (self.ref, self.port)]
        assert got[0] == got[1]
        assert self.port.device_lane_active == self.ref.device_lane_active

    def both(self, fn):
        return [fn(e) for e in (self.ref, self.port)]

    def stats(self) -> dict:
        ref, port = self.both(lambda e: e.read_lane_stats())
        assert ref == port
        return port

    def close(self):
        for e in (self.ref, self.port):
            e.close()


def frames(pair) -> list[bytes]:
    """Per-shard first-response frames of the port's future, after
    checking them against the reference's."""
    ref = [bytes(r[0]) for r in pair[0].result()]
    port = [bytes(r[0]) for r in pair[1].result()]
    assert port == ref
    return port


@pytest.fixture
def layout():
    """The port's layout (a class over meshes overrides it)."""
    return "one"


@pytest.fixture
def lanes_factory(layout):
    made = []

    def make(read_lane: bool, **kw) -> Lanes:
        made.append(Lanes(read_lane, layout, **kw))
        return made[-1]

    yield make
    for lanes in made:
        lanes.close()


@pytest.mark.parametrize("read_lane", [False, True])
class TestReadLaneConformance:
    def test_flushed_stream_byte_identical(self, lanes_factory, read_lane):
        """With a flush between operations the probe frames equal the
        consensus GET window's and the host store's."""
        lanes = lanes_factory(read_lane)
        off = lanes_factory(False).port  # the port's own lane, read lane off
        off.submit_block(build_block(list(range(N_SHARDS)), set_ops("a", "v1")))
        off.flush()
        lanes.submit(set_ops("a", "v1"))
        lanes.flush()
        hit = lanes.submit(get_ops("a"))
        miss = lanes.submit(get_ops("nope"))
        lanes.flush()
        off_hit = off.submit_block(build_block(list(range(N_SHARDS)), get_ops("a")))
        off.flush()
        assert frames(hit) == [bytes(r[0]) for r in off_hit.result()]
        lanes.both(lambda e: e.sync_to_host())
        for s, frame in enumerate(frames(hit)):
            res = decode_result_bin(frame)
            assert res.value == "v1", (s, frame)
            assert res.version == lanes.port.sms[0].store.get(s, f"a-{s}".encode())[1]
            assert ref_decode(frame).version == res.version
        for frame in frames(miss):
            assert decode_result_bin(frame).value is None

    def test_zero_slots_for_probe_reads(self, lanes_factory, read_lane):
        """Lane on: GET blocks consume no slot; lane off: one a shard."""
        lanes = lanes_factory(read_lane)
        lanes.submit(set_ops("z", "v"))
        lanes.flush()
        before = lanes.port.decided_v1
        futs = [lanes.submit(get_ops("z")) for _ in range(3)]
        lanes.flush()
        for f in futs:
            assert [decode_result_bin(x).value for x in frames(f)] == ["v"] * N_SHARDS
        slots = lanes.port.decided_v1 - before
        assert lanes.both(lambda e: e.decided_v1) == [lanes.port.decided_v1] * 2
        rl = lanes.stats()
        if read_lane:
            assert slots == 0
            assert rl["probe"] == 3 * N_SHARDS and rl["probe_windows"] >= 1
            assert rl["slot"] == 0
        else:
            assert slots == 3 * N_SHARDS
            assert rl["probe"] == 0 and rl["slot"] == 3 * N_SHARDS

    def test_get_racing_inflight_set_window(self, lanes_factory, read_lane):
        """GETs submitted after a SET block, no flush between: each sees
        that SET or a later one, never the value before it."""
        lanes = lanes_factory(read_lane)
        lanes.submit(set_ops("r", "old"))
        lanes.flush()
        futs = []
        for gen in range(4):
            lanes.submit(set_ops("r", f"new{gen}"))
            futs.append((gen, lanes.submit(get_ops("r"))))
        lanes.flush(max_cycles=400)
        for gen, fut in futs:
            for frame in frames(fut):
                assert decode_result_bin(frame).value in {f"new{g}" for g in range(gen, 4)}

    def test_interleaved_versions_monotone(self, lanes_factory, read_lane):
        """Versions a GET stream interleaved with SETs observes never go
        backwards, and each is at most the final one."""
        lanes = lanes_factory(read_lane)
        futs = []
        for gen in range(6):
            lanes.submit(set_ops("m", f"g{gen}"))
            futs.append(lanes.submit(get_ops("m")))
        lanes.flush(max_cycles=400)
        lanes.both(lambda e: e.sync_to_host())
        final = [lanes.port.sms[0].store.get(s, f"m-{s}".encode())[1] for s in range(N_SHARDS)]
        last = [0] * N_SHARDS
        for gen, fut in enumerate(futs):
            for s, frame in enumerate(frames(fut)):
                res = decode_result_bin(frame)
                assert res.value is not None, (gen, s)
                assert last[s] <= res.version <= final[s], (gen, s, res.version)
                last[s] = res.version


class TestReadLaneEdges:
    def test_eviction_fallback_counts_and_serves(self, lanes_factory):
        """A probe-found version whose segment was evicted resolves
        through the value download, and the fallback is counted."""
        lanes = lanes_factory(True)
        lanes.submit(set_ops("e", "keepme"))
        lanes.flush()
        for eng in (lanes.ref, lanes.port):
            while eng._dev_vseg:
                old = eng._dev_vseg.popleft()
                eng._dev_vseg_bytes -= old.nbytes
                np.maximum(eng._dev_floor, old.end, out=eng._dev_floor)
            eng._dev_seed_keys = eng._dev_seed_keys[:0]
        fut = lanes.submit(get_ops("e"))
        lanes.flush()
        assert [decode_result_bin(x).value for x in frames(fut)] == ["keepme"] * N_SHARDS
        rl = lanes.stats()
        assert rl["fallback"] >= N_SHARDS and rl["probe"] == N_SHARDS

    def test_demotion_mid_probe_flushes_parked_reads(self, lanes_factory):
        """Reads parked behind a staged write survive a demotion: the host
        path serves them after that write, and the lane re-engages."""
        lanes = lanes_factory(True, device_store_repromote=4)
        lanes.submit(set_ops("d", "v0"))
        lanes.flush()
        lanes.submit(set_ops("d", "v1"))
        parked = lanes.submit(get_ops("d"))
        assert len(lanes.port._read_pending) == 1
        lanes.both(lambda e: e._demote_device_store())
        assert not lanes.port.device_lane_active and not lanes.port._read_pending
        lanes.flush()
        assert [decode_result_bin(x).value for x in frames(parked)] == ["v1"] * N_SHARDS
        assert lanes.stats()["probe"] == 0
        for i in range(8):
            lanes.submit(set_ops("d", f"v{i + 2}"))
            lanes.flush()
        assert lanes.port.device_lane_active
        fut = lanes.submit(get_ops("d"))
        lanes.flush()
        assert [decode_result_bin(x).value for x in frames(fut)] == ["v9"] * N_SHARDS
        assert lanes.stats()["probe"] == N_SHARDS

    def test_probe_reads_survive_replica_crash(self, lanes_factory):
        """A minority crash neither wedges nor corrupts the probe path."""
        lanes = lanes_factory(True)
        lanes.submit(set_ops("c", "alive"))
        lanes.flush()
        lanes.both(lambda e: e.crash_replica(2))
        lanes.submit(set_ops("c", "alive2"))
        fut = lanes.submit(get_ops("c"))
        lanes.flush(max_cycles=400)
        assert [decode_result_bin(x).value for x in frames(fut)] == ["alive2"] * N_SHARDS
        assert lanes.stats()["probe"] == N_SHARDS

    def test_probe_serves_with_a_majority_crashed(self, lanes_factory):
        """No quorum is needed to read: with two of three replicas down a
        probe still answers, while a write parks."""
        lanes = lanes_factory(True)
        lanes.submit(set_ops("q", "before"))
        lanes.flush()
        lanes.both(lambda e: (e.crash_replica(1), e.crash_replica(2)))
        fut = lanes.submit(get_ops("q"))
        lanes.flush()
        assert [decode_result_bin(x).value for x in frames(fut)] == ["before"] * N_SHARDS
        assert lanes.stats()["probe"] == N_SHARDS
        assert lanes.port.device_lane_active


class TestReadLaneConformanceOnMeshes(TestReadLaneConformance):
    """The conformance cases with the port on a logical mesh."""

    @pytest.fixture(params=["8x1", "2x4"])
    def layout(self, request):
        return request.param


class TestReadLaneEdgesOnMeshes(TestReadLaneEdges):
    """The edge cases with the port on a logical mesh."""

    @pytest.fixture(params=["8x1", "2x4"])
    def layout(self, request):
        return request.param


def test_probe_on_a_mesh_table_exchanges_nothing(monkeypatch):
    """The reference's census claim (a probe window crosses no collective)
    in the port's terms: on a 2 x 4 mesh table, with the mesh's
    collectives and the decide plane's replica exchange patched to raise,
    the read lane's probe still serves, as one read scan a shard block
    and no decision; the table is cut in two shard blocks."""
    mesh = port_make_mesh(["cpu"] * 8, 2, 4)
    eng = MeshEngine(lambda: VectorShardedKV(N_SHARDS, capacity=1 << 12), N_SHARDS, 4,
                     mesh=mesh, window=4, device_store=True, device_read_lane=True)
    assert eng._dev.mesh is mesh and len(eng._dev.state.used.blocks) == 2
    shards = list(range(N_SHARDS))
    eng.submit_block(build_block(shards, set_ops("x", "v")))
    eng.flush()

    def refuse(*a, **k):
        raise AssertionError("a probe reached a collective")

    for name in ("_all_gather", "gather_replicas", "gather_shards"):
        monkeypatch.setattr(mesh, name, refuse)
    for name in ("exchange_window", "_decide_mesh", "decide_slots_plain"):
        monkeypatch.setattr(eng.kernel, name, refuse)
    scans = []
    real_scan = kv_window.kv_window_plain
    monkeypatch.setattr(kv_window, "kv_window_plain",
                        lambda *a, **k: scans.append(a[0].used.shape[0]) or real_scan(*a, **k))
    before = eng.next_slot.copy()
    futs = [eng.submit_block(build_block(shards, get_ops(tag))) for tag in ("x", "none")]
    eng.flush()
    assert [decode_result_bin(bytes(r[0])).value for r in futs[0].result()] == ["v"] * N_SHARDS
    assert [decode_result_bin(bytes(r[0])).value for r in futs[1].result()] == [None] * N_SHARDS
    assert scans == [N_SHARDS // 2] * 2  # one probe window: one scan a shard block
    assert eng.next_slot.tolist() == before.tolist()
    assert eng.read_lane_stats()["probe"] == 2 * N_SHARDS and eng.device_lane_active


def test_probe_takes_no_decision_and_no_slot(monkeypatch):
    """A probe window reaches neither the window's decision
    (``decide_window``/``decide_window_plain``, the plain mesh window) nor
    ``slot_window``, and launches no kernel on the CPU; ``next_slot``, the
    decision log and the decided counters do not move."""
    eng = MeshEngine(lambda: VectorShardedKV(N_SHARDS, capacity=1 << 12), N_SHARDS, 3,
                     device="cpu", window=4, device_store=True, device_read_lane=True)
    shards = list(range(N_SHARDS))
    eng.submit_block(build_block(shards, set_ops("n", "v")))
    eng.flush()
    calls = []
    for name in ("decide_window", "decide_window_plain"):
        real = getattr(kv_window, name)
        monkeypatch.setattr(kv_window, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    for name in ("slot_window", "decide_slots_plain"):
        real = getattr(eng.kernel, name)
        monkeypatch.setattr(eng.kernel, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    scans = []
    real_scan = kv_window.kv_window_plain
    monkeypatch.setattr(kv_window, "kv_window_plain",
                        lambda *a, **k: scans.append(k.get("idx") is not None) or real_scan(*a, **k))
    def log():
        return [{slot: (v, [c.data for c in b.commands]) for slot, (v, b) in
                 eng.decisions_for(s).items()} for s in range(N_SHARDS)]

    before = (eng.next_slot.copy(), eng.decided_v1, eng.decided_v0, log(), eng.cycles)
    launches = kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches
    futs = [eng.submit_block(build_block(shards, get_ops("n"))) for _ in range(3)]
    eng.flush()
    for f in futs:
        assert [decode_result_bin(bytes(r[0])).value for r in f.result()] == ["v"] * N_SHARDS
    assert calls == []
    assert scans == [True]  # one probe window, in the dictionary form
    assert eng.next_slot.tolist() == before[0].tolist()
    assert (eng.decided_v1, eng.decided_v0) == before[1:3]
    assert log() == before[3]
    assert eng.read_lane_stats()["probe_windows"] == 1 and eng.cycles == before[4] + 1
    assert (kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches) == launches
