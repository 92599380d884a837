"""The port's persistence: backends, the transport engine's
checkpoint/resume, and MeshEngine.save_to / load_from.

The scenarios of tests/test_persistence.py, driven through
``rabia_tpu_torch`` (backend round-trips, aux blobs, the write-ahead vote
barrier and restart taint, an engine restart from disk), then the
cross-package checkpoint gate: a ``MeshEngine`` checkpoint saved by
either package, through either package's backend, loads and restores in
either package's ``MeshEngine``; the state files are byte-identical, and
the restored engine decides a further wave exactly as the engine that
saved it (decision logs and replica stores equal).
"""

import asyncio

import numpy as np
import pytest

from rabia_tpu_torch.core.persistence import PersistedEngineState
from rabia_tpu_torch.core.state_machine import Snapshot
from rabia_tpu_torch.persistence import FileSystemPersistence, InMemoryPersistence


class TestInMemory:
    @pytest.mark.asyncio
    async def test_roundtrip(self):
        p = InMemoryPersistence()
        assert await p.load_state() is None
        await p.save_state(b"hello")
        assert await p.load_state() == b"hello"

    @pytest.mark.asyncio
    async def test_overwrite(self):
        p = InMemoryPersistence()
        await p.save_state(b"a")
        await p.save_state(b"b")
        assert await p.load_state() == b"b"


class TestFileSystem:
    @pytest.mark.asyncio
    async def test_roundtrip(self, tmp_path):
        p = FileSystemPersistence(tmp_path / "node1")
        assert await p.load_state() is None
        await p.save_state(b"durable")
        assert await p.load_state() == b"durable"
        # fresh instance reads the same file
        p2 = FileSystemPersistence(tmp_path / "node1")
        assert await p2.load_state() == b"durable"

    @pytest.mark.asyncio
    async def test_atomic_no_tmp_left_behind(self, tmp_path):
        p = FileSystemPersistence(tmp_path)
        await p.save_state(b"x" * 100_000)
        leftovers = [f for f in tmp_path.iterdir() if f.suffix == ".tmp"]
        assert leftovers == []

    def test_sync_wrappers(self, tmp_path):
        p = FileSystemPersistence(tmp_path)
        p.save_state_sync(b"sync")
        assert p.load_state_sync() == b"sync"


class TestPersistedEngineState:
    def test_roundtrip_with_snapshot(self):
        snap = Snapshot.create(7, b"app-state")
        st = PersistedEngineState(
            current_phase=10,
            last_committed_phase=9,
            state_version=7,
            snapshot=snap,
            per_shard_phase=[3, 4, 3],
            per_shard_committed=[3, 3, 3],
        )
        back = PersistedEngineState.from_bytes(st.to_bytes())
        assert back.current_phase == 10
        assert back.snapshot.data == b"app-state"
        assert back.per_shard_phase == [3, 4, 3]

    def test_corrupt_rejected(self):
        import pytest as _pytest

        from rabia_tpu_torch.core.errors import PersistenceError

        with _pytest.raises(PersistenceError):
            PersistedEngineState.from_bytes(b"not json")


class TestAuxBlobs:
    @pytest.mark.asyncio
    async def test_in_memory_aux_roundtrip(self):
        p = InMemoryPersistence()
        assert await p.load_aux("vote_barrier") is None
        await p.save_aux("vote_barrier", b"\x01\x02")
        assert await p.load_aux("vote_barrier") == b"\x01\x02"
        assert await p.load_aux("other") is None

    @pytest.mark.asyncio
    async def test_file_aux_roundtrip(self, tmp_path):
        p = FileSystemPersistence(tmp_path)
        assert await p.load_aux("vote_barrier") is None
        await p.save_aux("vote_barrier", b"\x09" * 24)
        assert await p.load_aux("vote_barrier") == b"\x09" * 24
        # separate channel: main blob untouched
        assert await p.load_state() is None
        # fresh instance reads the same aux file
        p2 = FileSystemPersistence(tmp_path)
        assert await p2.load_aux("vote_barrier") == b"\x09" * 24

    @pytest.mark.asyncio
    async def test_base_class_default_is_noop(self):
        from rabia_tpu_torch.core.persistence import PersistenceLayer

        class Minimal(PersistenceLayer):
            async def save_state(self, data):
                pass

            async def load_state(self):
                return None

        m = Minimal()
        await m.save_aux("k", b"v")  # must not raise
        assert await m.load_aux("k") is None


def _mk_restart_engine(nodes, persistence, config):
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.net import InMemoryHub

    hub = InMemoryHub()
    return RabiaEngine(
        ClusterConfig.new(nodes[0], nodes),
        InMemoryStateMachine(),
        hub.register(nodes[0]),
        persistence=persistence,
        config=config,
    )


class TestRestoreTaint:
    """Restart-equivocation guard: slots the pre-crash process may have
    voted in are not re-voted after restore; they rejoin via adopted peer
    Decisions / sync, or the taint lifts after a quiet release window."""

    @pytest.mark.asyncio
    async def test_vote_barrier_written_ahead_of_votes(self):
        """A node that opens a slot persists the barrier in the same tick,
        before any vote leaves (write-ahead)."""
        import numpy as np

        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.types import NodeId

        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        config = RabiaConfig(
            phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        p = InMemoryPersistence()
        eng = _mk_restart_engine(nodes, p, config)
        await eng._advance_vote_barrier([(0, 0, 1)])
        raw = await p.load_aux("vote_barrier")
        assert raw is not None
        # write-ahead: the barrier covers the opened slot (it is persisted
        # barrier_stride ahead, amortizing one fsync over K opens)
        assert np.frombuffer(raw, np.int64)[0] > 0
        assert p.aux_saves == 1
        # re-opening any slot under the stride does not re-persist
        await eng._advance_vote_barrier([(0, 0, 1)])
        await eng._advance_vote_barrier([(0, 1, 1)])
        assert p.aux_saves == 1

    @pytest.mark.asyncio
    async def test_tainted_slot_not_reopened(self):
        import time as _time

        import numpy as np

        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.persistence import PersistedEngineState
        from rabia_tpu_torch.core.types import CommandBatch, NodeId

        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        config = RabiaConfig(
            phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        p = InMemoryPersistence()
        # pre-crash: applied 0 slots, but barrier says "may have voted in
        # slots < 1" (slot 0 was opened)
        await p.save_engine_state(
            PersistedEngineState(per_shard_phase=[0], per_shard_committed=[0])
        )
        await p.save_aux("vote_barrier", np.asarray([1], np.int64).tobytes())
        eng = _mk_restart_engine(nodes, p, config)
        await eng.initialize()
        assert eng.rt.shards[0].tainted_upto == 1
        # we are slot 0's proposer ((0+0)%3 == 0) with a queued batch, yet
        # the tainted slot must not open
        eng.rt.has_quorum = True
        await eng.submit_batch(CommandBatch.new(["SET a 1"]), shard=0)
        assert eng._open_slots() == []
        assert eng.rt.shards[0].in_flight is False
        # a peer's Decision for the slot is adopted without voting
        eng.rt.shards[0].buf_decision[0] = (1, None)  # V1... no batch known
        eng.rt.shards[0].buf_propose[0] = (CommandBatch.new(["SET x 9"]).id, None)
        opened = eng._open_slots()
        assert opened == []  # adopted, not opened
        assert 0 in eng.rt.shards[0].decisions
        _ = _time  # silence linters

    @pytest.mark.asyncio
    async def test_taint_lifts_after_quiet_window(self):
        import time as _time

        import numpy as np

        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.persistence import PersistedEngineState
        from rabia_tpu_torch.core.types import CommandBatch, NodeId

        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        config = RabiaConfig(
            phase_timeout=0.05, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        p = InMemoryPersistence()
        await p.save_engine_state(
            PersistedEngineState(per_shard_phase=[0], per_shard_committed=[0])
        )
        await p.save_aux("vote_barrier", np.asarray([1], np.int64).tobytes())
        eng = _mk_restart_engine(nodes, p, config)
        await eng.initialize()
        assert eng.rt.shards[0].tainted_upto == 1
        eng.rt.has_quorum = True
        await eng.submit_batch(CommandBatch.new(["SET a 1"]), shard=0)
        # nothing observed for the tainted slot AND the full membership in
        # view: after one release window the shard resumes (first call
        # clears the taint, next call opens)
        eng.rt.active_nodes = set(nodes)
        eng._restored_at = _time.time() - (eng._taint_release + 1.0)
        eng._open_slots()
        assert eng.rt.shards[0].tainted_upto == 0
        opened = eng._open_slots()
        assert [(s, slot) for s, slot, _v in opened] == [(0, 0)]

    @pytest.mark.asyncio
    async def test_taint_held_longer_with_absent_peers(self):
        # an absent peer is the one that could still hold pre-crash votes:
        # with a partial view the release window stretches 4x
        import time as _time

        import numpy as np

        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.persistence import PersistedEngineState
        from rabia_tpu_torch.core.types import CommandBatch, NodeId

        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        config = RabiaConfig(
            phase_timeout=0.05, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        p = InMemoryPersistence()
        await p.save_engine_state(
            PersistedEngineState(per_shard_phase=[0], per_shard_committed=[0])
        )
        await p.save_aux("vote_barrier", np.asarray([1], np.int64).tobytes())
        eng = _mk_restart_engine(nodes, p, config)
        await eng.initialize()
        eng.rt.has_quorum = True
        await eng.submit_batch(CommandBatch.new(["SET a 1"]), shard=0)
        eng.rt.active_nodes = set(nodes[:2])  # one member out of view
        eng._restored_at = _time.time() - (eng._taint_release + 1.0)
        eng._open_slots()
        assert eng.rt.shards[0].tainted_upto == 1  # still held
        eng._restored_at = _time.time() - (4 * eng._taint_release + 1.0)
        eng._open_slots()
        assert eng.rt.shards[0].tainted_upto == 0

    @pytest.mark.asyncio
    async def test_taint_held_while_traffic_observed(self):
        import time as _time

        import numpy as np

        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.messages import VoteEntry
        from rabia_tpu_torch.core.persistence import PersistedEngineState
        from rabia_tpu_torch.core.types import NodeId, StateValue
        from rabia_tpu_torch.kernel.phase_driver import pack_phase

        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        config = RabiaConfig(
            phase_timeout=0.05, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        p = InMemoryPersistence()
        await p.save_engine_state(
            PersistedEngineState(per_shard_phase=[0], per_shard_committed=[0])
        )
        await p.save_aux("vote_barrier", np.asarray([1], np.int64).tobytes())
        eng = _mk_restart_engine(nodes, p, config)
        await eng.initialize()
        # a peer's vote for the tainted slot arrives: peers are deciding it
        eng._buffer_votes(
            1, (VoteEntry(0, pack_phase(0, 0), StateValue.V1),), round_no=1
        )
        assert eng.rt.shards[0].taint_traffic is True
        eng._restored_at = _time.time() - (eng._taint_release + 1.0)
        eng._open_slots()
        assert eng.rt.shards[0].tainted_upto == 1  # still held

    @pytest.mark.asyncio
    async def test_single_replica_never_taints(self):
        import numpy as np

        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.persistence import PersistedEngineState
        from rabia_tpu_torch.core.types import NodeId

        nodes = [NodeId.from_int(1)]
        config = RabiaConfig(
            phase_timeout=0.05, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        p = InMemoryPersistence()
        await p.save_engine_state(
            PersistedEngineState(per_shard_phase=[2], per_shard_committed=[2])
        )
        await p.save_aux("vote_barrier", np.asarray([3], np.int64).tobytes())
        eng = _mk_restart_engine(nodes, p, config)
        await eng.initialize()
        assert eng.rt.shards[0].tainted_upto == 0


class TestEngineCheckpointResume:
    @pytest.mark.asyncio
    async def test_restart_restores_state(self, tmp_path):
        """Commit on a 3-node cluster with durable persistence; restart one
        node's engine object and check it resumes from the saved state
        instead of slot 0 (engine.rs:238-261)."""
        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.network import ClusterConfig
        from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
        from rabia_tpu_torch.core.types import CommandBatch, NodeId
        from rabia_tpu_torch.engine import RabiaEngine
        from rabia_tpu_torch.net import InMemoryHub

        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        hub = InMemoryHub()
        config = RabiaConfig(
            phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        persists = [FileSystemPersistence(tmp_path / str(i)) for i in range(3)]
        engines, sms, tasks = [], [], []
        for i, n in enumerate(nodes):
            sm = InMemoryStateMachine()
            engines.append(
                RabiaEngine(
                    ClusterConfig.new(n, nodes),
                    sm,
                    hub.register(n),
                    persistence=persists[i],
                    config=config,
                )
            )
            sms.append(sm)
            tasks.append(asyncio.ensure_future(engines[-1].run()))
        try:
            for _ in range(200):
                await asyncio.sleep(0.01)
                sts = [await e.get_statistics() for e in engines]
                if all(s.has_quorum for s in sts):
                    break
            fut = await engines[0].submit_batch(CommandBatch.new(["SET k v"]))
            await asyncio.wait_for(fut, 15.0)

            # wait for node 0's post-commit save to land on disk
            async def saved():
                while True:
                    blob = await persists[0].load_state()
                    if blob is not None:
                        st = PersistedEngineState.from_bytes(blob)
                        if st.last_committed_phase >= 1:
                            return
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(saved(), 10.0)
        finally:
            for e in engines:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        # "restart": fresh engine + SM over the same persistence dir
        sm2 = InMemoryStateMachine()
        hub2 = InMemoryHub()
        eng2 = RabiaEngine(
            ClusterConfig.new(nodes[0], nodes),
            sm2,
            hub2.register(nodes[0]),
            persistence=persists[0],
            config=config,
        )
        await eng2.initialize()
        assert eng2.rt.shards[0].applied_upto >= 1
        assert sm2.get("k") == "v"


class TestEngineRestartCommitsAgain:
    @pytest.mark.asyncio
    async def test_restarted_engine_rejoins_and_commits(self, tmp_path):
        """A replica is shut down, restarted from its persistence layer and
        rejoins its running peers: a further wave commits on every replica."""
        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.network import ClusterConfig
        from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
        from rabia_tpu_torch.core.types import CommandBatch, NodeId
        from rabia_tpu_torch.engine import RabiaEngine
        from rabia_tpu_torch.net import InMemoryHub

        S = 4
        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        hub = InMemoryHub()
        config = RabiaConfig(
            phase_timeout=3.0, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=S, shard_pad_multiple=2)
        persists = [FileSystemPersistence(tmp_path / str(i)) for i in range(3)]
        sms = [InMemoryStateMachine() for _ in nodes]
        transports = [hub.register(n) for n in nodes]

        def start(i):
            return RabiaEngine(
                ClusterConfig.new(nodes[i], nodes), sms[i], transports[i],
                persistence=persists[i], config=config,
            )

        async def quorum(engs):
            for _ in range(300):
                await asyncio.sleep(0.01)
                if all([(await e.get_statistics()).has_quorum for e in engs]):
                    return
            raise AssertionError("no quorum")

        async def wave(eng, tag):
            futs = [
                await eng.submit_batch(CommandBatch.new([f"SET {tag}{s} v{s}"]), shard=s)
                for s in range(S)
            ]
            for f in futs:
                assert await asyncio.wait_for(f, 15.0) == [b"OK"]

        async def converged(keys):
            for _ in range(500):
                if all(sm.get(k) == v for sm in sms for k, v in keys.items()):
                    return
                await asyncio.sleep(0.01)
            raise AssertionError("replicas did not converge")

        engines = [start(i) for i in range(3)]
        tasks = [asyncio.ensure_future(e.run()) for e in engines]
        try:
            await quorum(engines)
            await wave(engines[0], "a")
            await converged({f"a{s}": f"v{s}" for s in range(S)})
            # replica 2 stops (a clean shutdown saves its state) ...
            await engines[2].shutdown()
            tasks[2].cancel()
            await asyncio.gather(tasks[2], return_exceptions=True)
            hub.set_connected(nodes[2], False)
            st = PersistedEngineState.from_bytes(await persists[2].load_state())
            assert sum(st.per_shard_committed) == S
            # ... and restarts from its persistence layer with a fresh state
            # machine, which the saved snapshot restores
            sms[2] = InMemoryStateMachine()
            hub.set_connected(nodes[2], True)
            engines[2] = start(2)
            tasks[2] = asyncio.ensure_future(engines[2].run())
            await quorum(engines)
            assert sms[2].get("a0") == "v0"
            assert int(engines[2].rt.applied_upto[:S].sum()) == S
            # the restored replica holds back from slots it may have voted
            # in before the restart (the vote barrier's taint); a live
            # peer's wave commits and the restored replica adopts it
            assert int(engines[2].rt.tainted_upto[:S].min()) > 0
            await wave(engines[0], "b")
            await converged({f"b{s}": f"v{s}" for s in range(S)})
        finally:
            for e in engines:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)


# -- MeshEngine checkpoints across packages ----------------------------------

_MESH_S, _MESH_R = 5, 3


def _mesh_engine(pkg: str):
    if pkg == "port":
        from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
        from rabia_tpu_torch.parallel import MeshEngine

        return MeshEngine(InMemoryStateMachine, _MESH_S, _MESH_R, window=2, device="cpu")
    from rabia_tpu.core.state_machine import InMemoryStateMachine as RefSM
    from rabia_tpu.parallel import MeshEngine as RefEngine

    return RefEngine(RefSM, _MESH_S, _MESH_R, window=2)


def _backend(pkg: str, path):
    if pkg == "port":
        return FileSystemPersistence(path)
    from rabia_tpu.persistence import FileSystemPersistence as RefFS

    return RefFS(path)


def _drive(eng, tag: str, waves: int) -> None:
    for w in range(waves):
        futs = [
            eng.submit([f"SET {tag}{w}_{s} v{s}".encode()], s)
            for s in range(_MESH_S)
            if (s + w) % 4  # leave a shard idle each wave: ragged slot counters
        ]
        eng.flush()
        assert all(f.result() == [b"OK"] for f in futs)


def _log(eng) -> dict:
    return {
        s: {slot: (v, tuple(c.data for c in b.commands) if b is not None else None)
            for slot, (v, b) in eng.decisions_for(s).items()}
        for s in range(_MESH_S)
    }


def _stores(eng) -> list[bytes]:
    return [sm.create_snapshot().data for sm in eng.sms]


@pytest.mark.parametrize("loader", ["ref", "port"])
@pytest.mark.parametrize("backend", ["ref", "port"])
@pytest.mark.parametrize("saver", ["ref", "port"])
def test_mesh_checkpoint_crosses_packages(tmp_path, saver, backend, loader):
    src = _mesh_engine(saver)
    _drive(src, "a", 3)
    asyncio.run(src.save_to(_backend(backend, tmp_path / "ckpt")))
    # the state file is the same bytes whichever package wrote it
    twin = _mesh_engine("port" if saver == "ref" else "ref")
    _drive(twin, "a", 3)
    asyncio.run(twin.save_to(_backend(backend, tmp_path / "twin")))
    assert (tmp_path / "ckpt" / "state.dat").read_bytes() == (
        tmp_path / "twin" / "state.dat"
    ).read_bytes()

    dst = _mesh_engine(loader)
    assert asyncio.run(dst.load_from(_backend(loader, tmp_path / "ckpt"))) is True
    assert np.array_equal(
        np.asarray(dst.next_slot)[:_MESH_S], np.asarray(src.next_slot)[:_MESH_S]
    )
    assert _stores(dst) == _stores(src)
    assert dst.decided_v1 == src.decided_v1
    # restore drops the decision history; a further wave decides the same
    # slots with the same batches on both engines
    src_before = _log(src)
    _drive(src, "b", 2)
    _drive(dst, "b", 2)
    new_src = {s: {k: v for k, v in d.items() if k not in src_before[s]} for s, d in _log(src).items()}
    assert _log(dst) == new_src
    assert _stores(dst) == _stores(src)


def test_mesh_load_from_empty_backend_is_false(tmp_path):
    eng = _mesh_engine("port")
    assert asyncio.run(eng.load_from(FileSystemPersistence(tmp_path / "empty"))) is False
    assert asyncio.run(eng.load_from(InMemoryPersistence())) is False
