"""Native apply plane (native/statekernel.cpp + apps/native_store.py).

The port's copy of the reference's tests/test_native_apply.py, retargeted to
rabia_tpu_torch (the port's native libraries, built from its own sources).

Gates:
- fixed-schedule native-vs-Python apply conformance through the shared
  gate (testing/conformance.run_ops_on_both_apply_paths), with
  the edge ops pinned explicitly: empty batch, oversized value, CAS
  miss, DEL of an absent key, invalid UTF-8, unknown opcodes;
- KVStore-surface parity of NativeKVStore (CRUD results, StoreError
  raising, stats, snapshot/checksum round trips BOTH directions);
- the engine-level differential: one submission schedule through a
  native-store cluster and a ``RABIA_PY_APPLY=1`` cluster must commit
  identical results and land on identical store hashes;
- the pipelined apply stage (engine/apply_plane.py): a deep decided
  backlog drains off-tick without reordering a shard's log;
- observability: SKC counter block, the statekernel flight ring, and
  the rt_broadcast_frames-compatible staged result records.
"""

import asyncio
import os

import numpy as np
import pytest

from rabia_tpu_torch.apps.kvstore import (
    KVStore,
    KVOperation,
    KVOpType,
    apply_ops_bin,
    decode_result_bin,
    encode_cas_bin,
    encode_op_bin,
    encode_set_bin,
)
from rabia_tpu_torch.apps.native_store import (
    NativeKVStore,
    native_apply_available,
)
from rabia_tpu_torch.apps.sharded import make_sharded_kv
from rabia_tpu_torch.core.config import KVStoreConfig

pytestmark = pytest.mark.skipif(
    not native_apply_available(),
    reason="statekernel library unavailable",
)


class TestApplyPathConformance:
    def test_fixed_edge_schedule(self):
        """The satellite's edge-op list, through the shared gate: empty
        batch is exercised at the store level below (build_block rejects
        zero-command batches by design); here: oversized value, CAS miss
        (absent key AND version mismatch), DEL of an absent key,
        invalid UTF-8, unknown opcode, replayed wave."""
        from rabia_tpu_torch.testing.conformance import (
            run_ops_on_both_apply_paths,
        )

        wave = {
            0: [
                encode_set_bin("a", "1"),
                encode_cas_bin("a", "2", 99),  # CAS version miss
                encode_cas_bin("a", "2", 1),  # CAS hit
                encode_cas_bin("ghost", "x", 7),  # CAS miss: absent key
                encode_op_bin(KVOperation.delete("nope")),  # DEL absent
                encode_set_bin("big", "v" * 4096),  # oversized value
                b"\x01\x02\x00\xff\xfev",  # invalid utf-8 key
                b"\x2a\x01\x00k",  # unknown opcode 42
                encode_op_bin(KVOperation.get("a")),
            ],
            1: [
                encode_op_bin(KVOperation.exists("a")),
                encode_cas_bin("fresh", "init", 0),  # CAS create
                encode_op_bin(KVOperation(KVOpType.Clear)),
                encode_op_bin(KVOperation.get("fresh")),
            ],
        }
        schedule = [wave, {0: [encode_set_bin("r", "1")]}, wave, wave]
        run_ops_on_both_apply_paths(schedule, n_shards=2, tag="fixed-edge")

    def test_empty_batch_and_single_op(self):
        cfg = KVStoreConfig()
        py, nat = KVStore(cfg), NativeKVStore(cfg)
        assert apply_ops_bin(py, []) == list(apply_ops_bin(nat, []))
        ops = [encode_set_bin("k", "v")]
        assert apply_ops_bin(py, ops) == list(apply_ops_bin(nat, ops))
        assert py.checksum() == nat.checksum()


class TestNativeKVStoreSurface:
    def test_crud_matches_python_store(self):
        cfg = KVStoreConfig(max_keys=4, max_key_length=8, max_value_size=16)
        py, nat = KVStore(cfg), NativeKVStore(cfg)
        for st in (py, nat):
            assert st.set("k", "v").ok
            assert st.get("k").value == "v"
            assert st.get("k").version == 1
            assert st.exists("k").value == "true"
            assert st.cas("k", "v2", 1).ok
            r = st.cas("k", "v3", 1)
            assert not r.ok and r.error == "version_conflict"
            assert r.version == 2  # current version rides the conflict
            assert st.cas("new", "x", 0).ok  # create-if-absent
            assert st.cas("ghost", "x", 5).kind.value == "not_found"
            assert st.delete("k").value == "v2"
            assert st.delete("k").kind.value == "not_found"
            assert st.keys() == ["new"]
        assert py.checksum() == nat.checksum()
        assert py.version == nat.version
        s_py, s_nat = py.stats, nat.stats
        assert (s_py.total_operations, s_py.reads, s_py.writes) == (
            s_nat.total_operations, s_nat.reads, s_nat.writes
        )

    def test_validation_raises_like_kvstore(self):
        from rabia_tpu_torch.apps.kvstore import StoreError

        cfg = KVStoreConfig(max_keys=1, max_key_length=4, max_value_size=4)
        nat = NativeKVStore(cfg)
        for fn in (
            lambda: nat.set("", "v"),
            lambda: nat.set("toolong", "v"),
            lambda: nat.set("k", "toolarge"),
        ):
            with pytest.raises(StoreError):
                fn()
        assert nat.set("a", "1").ok
        with pytest.raises(StoreError):  # store full
            nat.set("b", "2")

    def test_snapshot_round_trips_both_directions(self):
        cfg = KVStoreConfig()
        py, nat = KVStore(cfg), NativeKVStore(cfg)
        for st in (py, nat):
            st.set("x", "1")
            st.set("y", "2")
            st.delete("x")
            st.set("z", "ζ")
        # native -> python
        py2 = KVStore(cfg)
        py2.restore_bytes(nat.snapshot_bytes())
        assert py2.checksum() == py.checksum()
        # python -> native
        nat2 = NativeKVStore(cfg)
        nat2.restore_bytes(py.snapshot_bytes())
        assert nat2.checksum() == py.checksum()
        assert nat2.version == py.version
        assert nat2.get_with_metadata("z").value == "ζ"

    def test_notifications_on_subscribed_store(self):
        from rabia_tpu_torch.apps.kvstore import ChangeType

        nat = NativeKVStore(KVStoreConfig())
        sub = nat.notifications.subscribe()
        nat.set("k", "v1")
        nat.set("k", "v2")
        nat.delete("k")
        kinds = []
        while True:
            n = sub.get_nowait()
            if n is None:
                break
            kinds.append((n.change, n.key, n.old_value, n.new_value))
        assert kinds == [
            (ChangeType.Created, "k", None, "v1"),
            (ChangeType.Updated, "k", "v1", "v2"),
            (ChangeType.Deleted, "k", "v2", None),
        ]

    def test_py_apply_env_forces_python_store(self, monkeypatch):
        monkeypatch.setenv("RABIA_PY_APPLY", "1")
        sm, machines = make_sharded_kv(2)
        assert sm._native_plane is None
        assert not getattr(machines[0].store, "is_native", False)


class TestWaveApply:
    def test_block_wave_parity_and_lazy_results(self):
        from rabia_tpu_torch.core.blocks import build_block

        S = 32
        sm_nat, m_nat = make_sharded_kv(S, native=True)
        sm_py, m_py = make_sharded_kv(S, native=False)
        shards = np.arange(S)
        cmds = [
            [encode_set_bin(f"k{s}", "v"), encode_cas_bin(f"k{s}", "w", 1)]
            for s in range(S)
        ]
        blk = build_block(shards, cmds)
        idxs = np.arange(S)
        r_nat = sm_nat.apply_block(blk, idxs, want_responses=True)
        r_py = sm_py.apply_block(blk, idxs, want_responses=True)
        for a, b in zip(r_nat, r_py):
            assert list(a) == list(b)
            assert len(a) == 2  # lazy len without materializing
        # follower path: no responses materialized, same state
        sm_f, m_f = make_sharded_kv(S, native=True)
        assert sm_f.apply_block(blk, idxs, want_responses=False) is None
        for s in range(S):
            assert m_f[s].store.checksum() == m_py[s].store.checksum()

    def test_zero_length_trailing_command_matches_python(self):
        """A block whose LAST command is empty (offset == len(data))
        must not crash the native precheck and must produce the same
        per-op 'malformed op' frame the Python owner does."""
        from rabia_tpu_torch.core.blocks import build_block

        sm_nat, m_nat = make_sharded_kv(2, native=True)
        sm_py, m_py = make_sharded_kv(2, native=False)
        blk = build_block(
            np.asarray([0, 1]),
            [[encode_set_bin("a", "1"), b""], [b"", encode_set_bin("b", "2")]],
        )
        idxs = np.arange(2)
        r_nat = sm_nat.apply_block(blk, idxs, want_responses=True)
        r_py = sm_py.apply_block(blk, idxs, want_responses=True)
        for a, b in zip(r_nat, r_py):
            assert list(a) == list(b)
        for s in range(2):
            assert m_nat[s].store.checksum() == m_py[s].store.checksum()
        # the valid SETs applied despite the empty siblings
        assert m_nat[0].store.get("a").value == "1"

    def test_partial_coverage_ignores_uncovered_json_command(self):
        """A '{'-prefixed command on a NON-covered index must not demote
        a covered all-binary wave off the native path."""
        from rabia_tpu_torch.core.blocks import build_block

        sm_nat, m_nat = make_sharded_kv(2, native=True)
        blk = build_block(
            np.asarray([0, 1]),
            [[encode_set_bin("a", "1")], [b'{"op":"set","key":"b"}']],
        )
        waves_before = sm_nat._native_plane.counter("waves")
        res = sm_nat.apply_block(
            blk, np.asarray([0]), want_responses=True
        )
        assert sm_nat._native_plane.counter("waves") == waves_before + 1, (
            "covered binary wave was demoted off the native path"
        )
        assert decode_result_bin(res[0][0]).ok
        assert m_nat[0].store.get("a").value == "1"
        assert m_nat[1].store.size() == 0  # uncovered shard untouched

    def test_staged_results_are_broadcast_frame_records(self):
        """The staged wave results use the exact [u32 LE len][payload]
        record framing rt_broadcast_frames consumes (transport staging
        without re-framing)."""
        import ctypes

        nat = NativeKVStore(KVStoreConfig())
        ops = [encode_set_bin("a", "1"), encode_op_bin(KVOperation.get("a"))]
        results = nat.apply_bin_many(ops)
        addr, nbytes = nat.plane.staged_results()
        raw = ctypes.string_at(addr, nbytes)
        pos, decoded = 0, []
        while pos + 4 <= len(raw):
            ln = int.from_bytes(raw[pos : pos + 4], "little")
            decoded.append(raw[pos + 4 : pos + 4 + ln])
            pos += 4 + ln
        assert pos == len(raw)
        assert decoded == list(results)
        assert decode_result_bin(decoded[1]).value == "1"

    def test_skc_counters_and_flight_ring(self):
        nat = NativeKVStore(KVStoreConfig())
        plane = nat.plane
        nat.apply_bin_many(
            [
                encode_set_bin("a", "1"),
                encode_op_bin(KVOperation.get("a")),
                encode_op_bin(KVOperation.delete("zz")),
                encode_cas_bin("a", "2", 9),
            ]
        )
        c = plane.counters_dict()
        assert c["waves"] == 1 and c["ops"] == 4
        assert c["sets"] == 1 and c["gets"] == 1 and c["dels"] == 1
        assert c["cas_misses"] == 1 and c["errors"] == 1
        assert plane.flight_head() == 1
        ev = plane.flight_snapshot()
        from rabia_tpu_torch.obs.flight import FRE_APPLY

        assert int(ev[0]["kind"]) == FRE_APPLY
        assert int(ev[0]["batch"]) == 4  # ops in the wave


class TestEngineNativeApply:
    async def _run_cluster_schedule(self):
        """One fixed submission schedule through an in-memory 3-replica
        cluster; returns (responses, per-shard checksums)."""
        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.network import ClusterConfig
        from rabia_tpu_torch.core.types import Command, CommandBatch, NodeId
        from rabia_tpu_torch.engine import RabiaEngine
        from rabia_tpu_torch.net import InMemoryHub

        S = 2
        cfg = RabiaConfig(
            phase_timeout=2.0, heartbeat_interval=0.05,
            round_interval=0.001,
        ).with_kernel(num_shards=S, shard_pad_multiple=S)
        hub = InMemoryHub()
        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        engines, stores = [], []
        for n in nodes:
            sm, machines = make_sharded_kv(S)
            engines.append(
                RabiaEngine(
                    ClusterConfig.new(n, nodes), sm, hub.register(n),
                    config=cfg,
                )
            )
            stores.append([m.store for m in machines])
        tasks = [asyncio.ensure_future(e.run()) for e in engines]
        try:
            for _ in range(300):
                await asyncio.sleep(0.01)
                if all(
                    [(await e.get_statistics()).has_quorum for e in engines]
                ):
                    break
            schedule = [
                (0, [encode_set_bin("a", "1")]),
                (1, [encode_cas_bin("b", "init", 0)]),
                (0, [
                    encode_cas_bin("a", "2", 1),
                    encode_op_bin(KVOperation.get("a")),
                    encode_op_bin(KVOperation.delete("ghost")),
                ]),
            ]
            out = []
            for shard, ops in schedule:
                fut = await engines[0].submit_batch(
                    CommandBatch.new(
                        [Command.new(b) for b in ops]
                    ),
                    shard=shard,
                )
                res = await asyncio.wait_for(fut, 15.0)
                out.append([bytes(r) for r in res])
            # wait for follower convergence
            want = [
                [stores[0][s].checksum() for s in range(S)]
            ]
            for _ in range(300):
                sums = [
                    [st[s].checksum() for s in range(S)] for st in stores
                ]
                if all(x == sums[0] for x in sums):
                    break
                await asyncio.sleep(0.01)
            assert all(
                [st[s].checksum() for s in range(S)] == sums[0]
                for st in stores
            ), "replicas diverged"
            return out, sums[0], engines[0]
        finally:
            for e in engines:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    @pytest.mark.asyncio
    async def test_cluster_native_vs_python_apply(self, monkeypatch):
        monkeypatch.delenv("RABIA_PY_APPLY", raising=False)
        res_nat, sums_nat, e_nat = await self._run_cluster_schedule()
        assert getattr(e_nat.sm, "_native_plane", None) is not None, (
            "native plane inactive — differential would be vacuous"
        )
        monkeypatch.setenv("RABIA_PY_APPLY", "1")
        res_py, sums_py, e_py = await self._run_cluster_schedule()
        assert e_py.sm._native_plane is None
        assert res_nat == res_py, "commit results diverge across apply paths"
        assert sums_nat == sums_py, "state hashes diverge across apply paths"

    @pytest.mark.asyncio
    async def test_apply_plane_drains_deep_backlog_in_order(self, monkeypatch):
        """RABIA_APPLY_INLINE=0 defers EVERY slot to the drain task: a
        burst of scalar commits must still apply in slot order, settle
        every future, and advance the applied frontier to the decided
        frontier."""
        monkeypatch.setenv("RABIA_APPLY_INLINE", "0")
        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.network import ClusterConfig
        from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
        from rabia_tpu_torch.core.types import Command, CommandBatch, NodeId
        from rabia_tpu_torch.engine import RabiaEngine
        from rabia_tpu_torch.net import InMemoryHub

        cfg = RabiaConfig(
            phase_timeout=2.0, heartbeat_interval=0.05,
            round_interval=0.001,
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        hub = InMemoryHub()
        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        engines = [
            RabiaEngine(
                ClusterConfig.new(n, nodes), InMemoryStateMachine(),
                hub.register(n), config=cfg,
            )
            for n in nodes
        ]
        tasks = [asyncio.ensure_future(e.run()) for e in engines]
        try:
            for _ in range(300):
                await asyncio.sleep(0.01)
                if all(
                    [(await e.get_statistics()).has_quorum for e in engines]
                ):
                    break
            futs = []
            for i in range(40):
                futs.append(
                    await engines[0].submit_batch(
                        CommandBatch.new([Command.new(f"SET k{i} {i}")])
                    )
                )
            res = await asyncio.wait_for(
                asyncio.gather(*futs), 30.0
            )
            assert all(r == [b"OK"] for r in res)
            e0 = engines[0]
            assert e0._apply_plane.deferred_slots >= 40, (
                "drain task never applied (inline budget 0 was ignored)"
            )
            assert int(e0.applied_frontier()[0]) >= 40
        finally:
            for e in engines:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    async def test_shutdown_flushes_deferred_backlog(self, monkeypatch):
        """Shutdown ordering, apply-plane half: a deferred backlog still
        pending when shutdown() is called must flush synchronously
        (apply_plane.flush_sync in the run loop's finally) BEFORE state
        is externalized — the applied frontier reaches the decided
        frontier on the stopped engine, with every decided V1 slot
        applied to the state machine."""
        monkeypatch.setenv("RABIA_APPLY_INLINE", "0")
        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.network import ClusterConfig
        from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
        from rabia_tpu_torch.core.types import Command, CommandBatch, NodeId
        from rabia_tpu_torch.engine import RabiaEngine
        from rabia_tpu_torch.net import InMemoryHub

        cfg = RabiaConfig(
            phase_timeout=2.0, heartbeat_interval=0.05,
            round_interval=0.001,
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        hub = InMemoryHub()
        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        sms = [InMemoryStateMachine() for _ in nodes]
        engines = [
            RabiaEngine(
                ClusterConfig.new(n, nodes), sms[i], hub.register(n),
                config=cfg,
            )
            for i, n in enumerate(nodes)
        ]
        tasks = [asyncio.ensure_future(e.run()) for e in engines]
        try:
            for _ in range(300):
                await asyncio.sleep(0.01)
                if all(
                    [(await e.get_statistics()).has_quorum for e in engines]
                ):
                    break
            futs = [
                await engines[0].submit_batch(
                    CommandBatch.new([Command.new(f"SET fk{i} {i}")])
                )
                for i in range(24)
            ]
            await asyncio.wait_for(asyncio.gather(*futs), 30.0)
            e0 = engines[0]
            # force a fresh backlog entry, then shut down IMMEDIATELY so
            # the drain task cannot win the race: flush_sync must cover it
            e0._apply_plane._pending.add(0)
            await e0.shutdown()
            assert e0._apply_plane.backlog == 0, (
                "shutdown returned with an unflushed apply backlog"
            )
            decided = max(
                (s for s in e0.rt.shards[0].decisions), default=-1
            )
            assert int(e0.applied_frontier()[0]) >= decided + 1 or all(
                rec.applied
                for rec in e0.rt.shards[0].decisions.values()
            ), "decided slots left unapplied after shutdown flush"
        finally:
            for e in engines:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
