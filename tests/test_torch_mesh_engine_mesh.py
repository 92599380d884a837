"""The reference's ``MeshEngine`` cases that run on its 2 x 4 test mesh
(``tests/test_mesh_engine.py``, every case that takes ``_mesh()``), each
driven through the reference on its 8 virtual CPU devices and through the
port on ``make_mesh(["cpu"] * 8, 2, 4)``: a logical mesh of 2 shard blocks
x 4 replica blocks, so every window exchanges its votes over the replica
axis and launches once a shard block. A case returns what it observed
(client responses, every shard's decision log, the engine's counters and
the replicas' state); the port's must equal the reference's exactly. The
shard axis of 2 pads n_shards = 1 to 2 shards in both, and the padded
shard decides in every window. The cases' own checks are the
reference's."""

from __future__ import annotations

import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rabia_tpu.apps.kvstore as ref_kvstore
import rabia_tpu.apps.vector_kv as ref_vector_kv
import rabia_tpu.core.blocks as ref_blocks
import rabia_tpu.core.errors as ref_errors
import rabia_tpu.core.state_machine as ref_sm
import rabia_tpu.parallel as ref_parallel
import rabia_tpu_torch.apps.kvstore as port_kvstore
import rabia_tpu_torch.apps.vector_kv as port_vector_kv
import rabia_tpu_torch.core.blocks as port_blocks
import rabia_tpu_torch.core.errors as port_errors
import rabia_tpu_torch.core.state_machine as port_sm
import rabia_tpu_torch.parallel as port_parallel

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

V1 = 1


def _pkg(parallel, sm, vkv, kvstore, blocks, errors, mesh):
    return SimpleNamespace(
        MeshEngine=parallel.MeshEngine, mesh=mesh, SM=sm.InMemoryStateMachine,
        Snapshot=sm.Snapshot, VKV=vkv.VectorShardedKV, set_bin=kvstore.encode_set_bin,
        build_block=blocks.build_block, PayloadBlock=blocks.PayloadBlock,
        RabiaError=errors.RabiaError, ValidationError=errors.ValidationError,
    )


REF = _pkg(ref_parallel, ref_sm, ref_vector_kv, ref_kvstore, ref_blocks, ref_errors,
           lambda: ref_parallel.make_mesh(shard_axis_size=2, replica_axis_size=4))
PORT = _pkg(port_parallel, port_sm, port_vector_kv, port_kvstore, port_blocks, port_errors,
            lambda: port_parallel.make_mesh(["cpu"] * 8, shard_axis_size=2,
                                            replica_axis_size=4))


def _res(fut):
    """A future's outcome: its result, or the error's type name and text
    (per entry for a block future's list)."""
    try:
        out = fut.result()
    except Exception as e:  # noqa: BLE001 - the outcome under comparison
        return ("error", type(e).__name__, str(e))
    if isinstance(out, list):
        return [("error", type(e).__name__, str(e)) if isinstance(e, Exception) else e
                for e in out]
    return out


def _log(eng):
    return [
        {slot: (v, None if b is None else [c.data for c in b.commands])
         for slot, (v, b) in eng.decisions_for(s).items()}
        for s in range(eng.n_shards)
    ]


def _counters(eng):
    return {"next_slot": [int(x) for x in eng.next_slot], "v1": eng.decided_v1,
            "v0": eng.decided_v0, "divergences": eng.divergences, "S": eng.S,
            "cycles": eng.cycles}


def _snaps(eng):
    return [sm.create_snapshot().data for sm in eng.sms]


def _kv(eng, keys):
    """Every replica's (value, version) of each (shard, key)."""
    return [[sm.store.get(s, k.encode()) for s, k in keys] for sm in eng.sms]


def _expect_error(P, fn, kind):
    try:
        fn()
    except kind as e:
        return str(e)
    raise AssertionError(f"no {kind.__name__}")


# ---- the cases of TestMeshEngineBasics -------------------------------------


def commit_settle_replicate(P):
    eng = P.MeshEngine(P.SM, n_shards=4, n_replicas=4, mesh=P.mesh(), window=4)
    futs = [eng.submit([f"SET k{i} v{i}"], shard=i % 4) for i in range(10)]
    assert eng.flush() == 10
    snaps = _snaps(eng)
    assert all(s == snaps[0] for s in snaps) and eng.sms[0].get("k7") == "v7"
    assert eng.decided_v1 == 10
    return [_res(f) for f in futs], _log(eng), _counters(eng), snaps


def decision_log_values(P):
    eng = P.MeshEngine(P.SM, n_shards=2, n_replicas=4, mesh=P.mesh(), window=2)
    eng.submit(["SET a 1"], 0)
    eng.submit(["SET b 2"], 0)
    eng.submit(["SET c 3"], 1)
    eng.flush()
    d0 = eng.decisions_for(0)
    assert sorted(d0) == [0, 1] and all(v == V1 for v, _ in d0.values())
    return _log(eng), _counters(eng), _snaps(eng)


def minority_crash_commits_majority_crash_stalls(P):
    eng = P.MeshEngine(P.SM, n_shards=2, n_replicas=4, mesh=P.mesh(), window=2)
    eng.crash_replica(3)
    f = eng.submit(["SET x 1"], 0)
    eng.flush()
    eng.crash_replica(2)
    assert not eng.has_quorum
    g = eng.submit(["SET y 2"], 1)
    stall = _expect_error(P, lambda: eng.flush(max_cycles=3), P.RabiaError)
    assert not g.done()
    eng.heal_replica(2)
    eng.flush()
    return _res(f), stall, _res(g), _log(eng), _counters(eng), _snaps(eng)


def apply_failure_fails_future_not_engine(P):
    class Exploding(P.SM):
        def apply_command(self, command):
            if b"BOOM" in command.data:
                raise RuntimeError("boom")
            return super().apply_command(command)

    eng = P.MeshEngine(Exploding, n_shards=1, n_replicas=4, mesh=P.mesh(), window=2)
    bad = eng.submit(["BOOM"], 0)
    good = eng.submit(["SET a 1"], 0)
    eng.flush()
    assert good.result() == [b"OK"]
    return _res(bad), _log(eng), _counters(eng), _snaps(eng)


def vector_bulk_apply_matches_scalar_path(P):
    keys = [(i % 4, f"k{i}") for i in range(12)]

    def run(force_scalar):
        eng = P.MeshEngine(lambda: P.VKV(4, capacity=1 << 10), n_shards=4, n_replicas=4,
                           mesh=P.mesh(), window=4)
        assert eng._vector
        if force_scalar:
            eng._vector = False
        futs = [eng.submit([P.set_bin(f"k{i}", f"v{i}")], shard=i % 4) for i in range(12)]
        eng.flush()
        return [_res(f) for f in futs], _kv(eng, keys), _log(eng), _counters(eng)

    bulk, scalar = run(False), run(True)
    assert bulk[0] == scalar[0] and bulk[1] == scalar[1]
    return bulk, scalar


def block_lane_commits_with_zero_repacking(P):
    S = 4
    eng = P.MeshEngine(lambda: P.VKV(S, capacity=1 << 10), n_shards=S, n_replicas=4,
                       mesh=P.mesh(), window=2)
    blk1 = P.build_block(list(range(S)), [[P.set_bin(f"a{s}", f"x{s}")] for s in range(S)])
    blk2 = P.build_block([0, 2], [[P.set_bin("b0", "y0"), P.set_bin("b0b", "y0b")],
                                  [P.set_bin("b2", "y2")]])
    f1, f2 = eng.submit_block(blk1), eng.submit_block(blk2)
    assert eng.flush() == S + 2
    g = eng.submit([P.set_bin("c", "z")], shard=1)
    f3 = eng.submit_block(P.build_block([0], [[P.set_bin("d", "w")]]))
    eng.flush()
    keys = [(s, f"a{s}") for s in range(S)] + [(0, "b0b"), (2, "b2"), (1, "c"), (0, "d")]
    return ([_res(f) for f in (f1, f2, g, f3)], _kv(eng, keys), _log(eng), _counters(eng))


def block_lane_decision_log_materializes(P):
    eng = P.MeshEngine(lambda: P.VKV(2, capacity=1 << 10), n_shards=2, n_replicas=4,
                       mesh=P.mesh(), window=2)
    op = P.set_bin("k", "v")
    eng.submit_block(P.build_block([0, 1], [[op], [op]]))
    eng.flush()
    v, batch = eng.decisions_for(0)[0]
    assert v == V1 and [c.data for c in batch.commands] == [op]
    return _log(eng), _counters(eng)


def deterministic_apply_failure_is_not_divergence(P):
    class Rejecting(P.SM):
        def apply_command(self, command):
            raise RuntimeError("nope")

        def apply_block(self, block, idxs, want_responses=True):
            raise RuntimeError("nope")

    out = []
    for vector in (False, True):
        eng = P.MeshEngine(Rejecting, n_shards=1, n_replicas=4, mesh=P.mesh(), window=2)
        eng._vector = vector
        f = eng.submit(["X"], 0)
        eng.flush()
        assert eng.divergences == 0
        out.append((_res(f), _log(eng), _counters(eng)))
    return out


def fullwidth_fast_lane_survives_quorum_loss(P):
    S = 2
    eng = P.MeshEngine(lambda: P.VKV(S, capacity=1 << 10), n_shards=S, n_replicas=4,
                       mesh=P.mesh(), window=4)

    def mk(i):
        return P.build_block([0, 1], [[P.set_bin(f"a{i}", f"x{i}")],
                                      [P.set_bin(f"b{i}", f"y{i}")]])

    eng.crash_replica(3)
    f0 = eng.submit_block(mk(0))
    assert eng.flush() == S and f0.done()
    eng.crash_replica(2)
    futs = [eng.submit_block(mk(i)) for i in range(1, 4)]
    stall = _expect_error(P, lambda: eng.flush(max_cycles=3), P.RabiaError)
    assert not any(f.done() for f in futs)
    eng.heal_replica(2)
    eng.flush()
    assert sorted(eng.decisions_for(0)) == [0, 1, 2, 3]
    keys = [(0, f"a{i}") for i in range(4)] + [(1, f"b{i}") for i in range(4)]
    return ([_res(f) for f in [f0, *futs]], stall, _kv(eng, keys), _log(eng),
            _counters(eng))


def replica0_only_failure_counts_divergence_on_bulk_path(P):
    made = []

    def factory():
        class MaybeReject(P.VKV):
            def apply_block(self, block, idxs, want_responses=True):
                if made and self is made[0]:
                    raise RuntimeError("replica 0 only")
                return super().apply_block(block, idxs, want_responses)

        sm = MaybeReject(2, capacity=1 << 10)
        made.append(sm)
        return sm

    eng = P.MeshEngine(factory, n_shards=2, n_replicas=4, mesh=P.mesh(), window=2)
    op = P.set_bin("k", "v")
    f = eng.submit_block(P.build_block([0, 1], [[op], [op]]))
    eng.flush()
    assert eng.divergences == 3
    return _res(f), _log(eng), _counters(eng)


def duplicate_shard_block_rejected(P):
    eng = P.MeshEngine(P.SM, n_shards=2, n_replicas=4, mesh=P.mesh(), window=2)
    blk = P.PayloadBlock(uuid.uuid4(), np.array([0, 0]), np.array([-1, -1]), np.array([1, 1]),
                         np.array([1, 1]), b"XY")
    msg = _expect_error(P, lambda: eng.submit_block(blk), P.ValidationError)
    assert "unique" in msg
    return msg, _counters(eng)


def block_lane_scalar_sm_materializes(P):
    eng = P.MeshEngine(P.SM, n_shards=2, n_replicas=4, mesh=P.mesh(), window=2)
    f = eng.submit_block(P.build_block([0, 1], [[b"SET m 1"], [b"SET n 2"]]))
    eng.flush()
    assert all(sm.get("m") == "1" and sm.get("n") == "2" for sm in eng.sms)
    return _res(f), _log(eng), _counters(eng), _snaps(eng)


def empty_batch_on_vector_path_does_not_poison_wave(P):
    eng = P.MeshEngine(lambda: P.VKV(2, capacity=1 << 10), n_shards=2, n_replicas=4,
                       mesh=P.mesh(), window=2)
    empty = eng.submit([], shard=0)
    full = eng.submit([P.set_bin("k", "v")], shard=1)
    eng.flush()
    assert eng.divergences == 0
    return _res(empty), _res(full), _kv(eng, [(1, "k")]), _log(eng), _counters(eng)


def checkpoint_restore_resumes_slots(P):
    eng = P.MeshEngine(P.SM, n_shards=2, n_replicas=4, mesh=P.mesh(), window=2)
    for i in range(4):
        eng.submit([f"SET a{i} v{i}"], shard=i % 2)
    eng.flush()
    ckpt = eng.checkpoint()
    fresh = P.MeshEngine(P.SM, n_shards=2, n_replicas=4, mesh=P.mesh(), window=2)
    fresh.restore(ckpt)
    assert list(fresh.next_slot) == list(eng.next_slot)
    f = fresh.submit(["SET after restore"], 0)
    fresh.flush()
    assert 2 in fresh.decisions_for(0)
    return ckpt.to_bytes(), _res(f), _log(fresh), _counters(fresh), _snaps(fresh)


def decision_log_trims_to_history_cap(P):
    eng = P.MeshEngine(P.SM, n_shards=1, n_replicas=4, mesh=P.mesh(), window=2,
                       max_decision_history=3)
    for i in range(9):
        eng.submit([f"SET k{i} v"], 0)
    eng.flush()
    assert sorted(eng.decisions_for(0)) == [6, 7, 8]
    return _log(eng), _counters(eng), _snaps(eng)


def replica_divergence_detected(P):
    made = []

    def factory():
        class Tagged(P.SM):
            def apply_command(self, command):
                if len(made) > 1 and self is made[1]:
                    return b"DIVERGED"
                return super().apply_command(command)

        sm = Tagged()
        made.append(sm)
        return sm

    eng = P.MeshEngine(factory, n_shards=1, n_replicas=4, mesh=P.mesh(), window=2)
    f = eng.submit(["SET a 1"], 0)
    eng.flush()
    assert eng.divergences == 1
    return _res(f), _log(eng), _counters(eng)


# ---- the cases of TestMultiApplyFailureGranularity -------------------------


def _stub_sm(P):
    class StubVectorSM:
        def apply_batch(self, batch):
            return [b"OK"] * len(batch.commands)

        def apply_block(self, block, idxs, want_responses=True):
            if block.commands_for(0)[0].startswith(b"POISON"):
                raise RuntimeError("boom")
            if not want_responses:
                return None
            return [[b"OK"] for _ in np.asarray(idxs)]

        def apply_block_multi(self, blocks, idxs_list, want_responses=True):
            out = []
            for b, i in zip(blocks, idxs_list):
                try:
                    out.append(self.apply_block(b, i, want_responses))
                except Exception as e:  # noqa: BLE001 - per-wave failure
                    out.append(e)
            return out

        def create_snapshot(self):
            return P.Snapshot.create(0, b"")

        def restore_snapshot(self, snapshot):
            pass

    return StubVectorSM


def poison_wave_fails_alone(P):
    eng = P.MeshEngine(_stub_sm(P), n_shards=4, n_replicas=4, mesh=P.mesh(), window=8)
    sub = [0, 1, 2]
    futs = [eng.submit_block(P.build_block(sub, [[c]] * len(sub)))
            for c in (b"SET a 1", b"POISON", b"SET b 2")]
    assert not eng._full_blocks
    eng.flush()
    return [_res(f) for f in futs], _log(eng), _counters(eng)


def poison_wave_fails_alone_fullwidth_lane(P):
    S = 8
    eng = P.MeshEngine(_stub_sm(P), n_shards=S, n_replicas=4, mesh=P.mesh(), window=4)
    futs = [eng.submit_block(P.build_block(
        list(range(S)), [[b"POISON" if w == 1 else b"SET x 1"]] * S)) for w in range(3)]
    eng.flush()
    return [_res(f) for f in futs], _log(eng), _counters(eng)


CASES = [
    commit_settle_replicate, decision_log_values, minority_crash_commits_majority_crash_stalls,
    apply_failure_fails_future_not_engine, vector_bulk_apply_matches_scalar_path,
    block_lane_commits_with_zero_repacking, block_lane_decision_log_materializes,
    deterministic_apply_failure_is_not_divergence, fullwidth_fast_lane_survives_quorum_loss,
    replica0_only_failure_counts_divergence_on_bulk_path, duplicate_shard_block_rejected,
    block_lane_scalar_sm_materializes, empty_batch_on_vector_path_does_not_poison_wave,
    checkpoint_restore_resumes_slots, decision_log_trims_to_history_cap,
    replica_divergence_detected, poison_wave_fails_alone, poison_wave_fails_alone_fullwidth_lane,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_matches_reference_on_the_2x4_mesh(case):
    assert case(PORT) == case(REF)


def test_padded_shard_decides_in_every_window():
    """n_shards = 1 on a shard axis of 2: both engines pad to 2 shards,
    and the padded shard's V0 decisions show in the window's plane while
    its log stays empty."""
    seen = {}
    for name, P in (("ref", REF), ("port", PORT)):
        eng = P.MeshEngine(P.SM, n_shards=1, n_replicas=4, mesh=P.mesh(), window=2)
        planes = []
        decide = eng._decide_window
        eng._decide_window = lambda votes, W, d=decide: planes.append(d(votes, W)) or planes[-1]
        eng.submit(["SET a 1"], 0)
        eng.submit(["SET b 2"], 0)
        eng.submit(["SET c 3"], 0)
        eng.flush()
        assert eng.S == 2 and eng.n_shards == 1
        seen[name] = ([np.asarray(p).tolist() for p in planes], _log(eng), _counters(eng))
    assert seen["port"] == seen["ref"]
    planes = seen["port"][0]
    assert planes and all(row[1] == 0 for p in planes for row in p)  # the pad decides V0
