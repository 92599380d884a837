"""The apps over the engine, both packages, on the CPU.

The reference's cluster cases of tests/test_apps.py (config 1's counter,
config 2's sharded KV) and its sharded-KV block-lane cases of
tests/test_blocks.py (end to end, demotion on the wrong proposer,
adaptive batching, a replica crash mid bulk load, recovery without
decision broadcasts, get_many, restart with persistence) run over both
packages' ``RabiaEngine`` with ``make_sharded_kv`` stores (the
reference's Python stores: the port has no native store). Then the slice
as a whole: one schedule of KV operations, scalar batches and blocks,
through an 8-shard x 3-replica cluster of each package's ``RabiaEngine``
and through each package's ``MeshEngine`` (the reference's under JAX on
the CPU, the port's with ``device="cpu"``), with ``make_sharded_kv``
replicas: every response and every replica's shard checksums equal across
all four. Last, chip_smoke.py's phase 11 (BASELINE.json configs 1-4) at a
small size on the CPU. Tolerance: exact equality.
"""

from __future__ import annotations

import asyncio
import functools
import importlib
import time
import types

import numpy as np
import pytest
import torch

from netwait import wait_until

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

PACKAGES = ("rabia_tpu", "rabia_tpu_torch")


def _pkg(name: str) -> types.SimpleNamespace:
    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    apps, kv = m("apps"), m("apps.kvstore")
    ns = types.SimpleNamespace(
        name=name,
        RabiaConfig=m("core.config").RabiaConfig,
        BatchConfig=m("core.config").BatchConfig,
        ClusterConfig=m("core.network").ClusterConfig,
        NodeId=m("core.types").NodeId,
        Command=m("core.types").Command,
        CommandBatch=m("core.types").CommandBatch,
        ShardId=m("core.types").ShardId,
        SMRBridge=m("core.smr").SMRBridge,
        RabiaError=m("core.errors").RabiaError,
        build_block=m("core.blocks").build_block,
        RabiaEngine=m("engine").RabiaEngine,
        slot_proposer_vec=m("engine.leader").slot_proposer_vec,
        InMemoryHub=m("net").InMemoryHub,
        FileSystemPersistence=m("persistence").FileSystemPersistence,
        CounterSMR=apps.CounterSMR,
        CounterCommand=apps.CounterCommand,
        ShardedKVService=apps.ShardedKVService,
        shard_for_key=apps.shard_for_key,
        KVOperation=kv.KVOperation,
        encode_set_bin=kv.encode_set_bin,
        encode_op_bin=kv.encode_op_bin,
        decode_kv_response=kv.decode_kv_response,
        MeshEngine=m("parallel").MeshEngine,
    )
    # the Python stores: the reference's semantics owner, and the port's only
    ns.make_sharded_kv = functools.partial(apps.make_sharded_kv, native=False)
    return ns


@pytest.fixture(params=PACKAGES)
def P(request):
    return _pkg(request.param)


async def _quorum(engines, rounds: int = 300) -> None:
    for _ in range(rounds):
        await asyncio.sleep(0.01)
        sts = [await e.get_statistics() for e in engines]
        if all(s.has_quorum for s in sts):
            return


async def _stop(engines, tasks) -> None:
    for e in engines:
        await e.shutdown()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


# -- tests/test_apps.py's cluster cases -------------------------------------


class TestCounterClusterEndToEnd:
    """BASELINE config #1: counter SMR, 3 replicas, in-memory transport."""

    @pytest.mark.asyncio
    async def test_counter_cluster(self, P):
        nodes = [P.NodeId.from_int(i + 1) for i in range(3)]
        hub = P.InMemoryHub()
        config = P.RabiaConfig(
            phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=1, shard_pad_multiple=1)
        engines, counters, tasks = [], [], []
        for n in nodes:
            counter = P.CounterSMR()
            engines.append(P.RabiaEngine(P.ClusterConfig.new(n, nodes), P.SMRBridge(counter),
                                         hub.register(n), config=config))
            counters.append(counter)
            tasks.append(asyncio.ensure_future(engines[-1].run()))
        try:
            await _quorum(engines, 200)
            codec = counters[0]
            batch = P.CommandBatch.new(
                [P.Command.new(codec.encode_command(P.CounterCommand.increment(5)))])
            fut = await engines[0].submit_batch(batch, shard=0)
            responses = await asyncio.wait_for(fut, 15.0)
            assert codec.decode_response(responses[0]).value == 5

            async def converged():
                while not all(c.value == 5 for c in counters):
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(converged(), 10.0)
        finally:
            await _stop(engines, tasks)


class TestShardedKVCluster:
    """BASELINE config #2 shape: sharded kvstore over a 3-replica cluster."""

    @pytest.mark.asyncio
    async def test_sharded_kv_cluster(self, P):
        n_shards = 4
        nodes = [P.NodeId.from_int(i + 1) for i in range(3)]
        hub = P.InMemoryHub()
        config = P.RabiaConfig(
            phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(num_shards=n_shards, shard_pad_multiple=4)
        engines, all_machines, tasks = [], [], []
        for n in nodes:
            sm, machines = P.make_sharded_kv(n_shards)
            engines.append(P.RabiaEngine(P.ClusterConfig.new(n, nodes), sm, hub.register(n),
                                         config=config))
            all_machines.append(machines)
            tasks.append(asyncio.ensure_future(engines[-1].run()))
        try:
            await _quorum(engines, 200)
            svc = P.ShardedKVService(n_shards, engines[0].submit_batch, all_machines[0])
            keys = [f"key{i}" for i in range(8)]
            results = await asyncio.gather(
                *[asyncio.wait_for(svc.set(k, f"v-{k}"), 20.0) for k in keys])
            assert all(r.ok for r in results)

            async def converged():
                while True:
                    if all(machines[P.shard_for_key(k, n_shards)].store.get(k).value == f"v-{k}"
                           for machines in all_machines for k in keys):
                        return
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(converged(), 20.0)
        finally:
            await _stop(engines, tasks)


# -- tests/test_blocks.py's sharded-KV cases --------------------------------


def _mk_cluster(P, S, R=3):
    nodes = [P.NodeId.from_int(i + 1) for i in range(R)]
    hub = P.InMemoryHub()
    cfg = P.RabiaConfig(
        phase_timeout=1.0, heartbeat_interval=0.2, round_interval=0.0005
    ).with_kernel(num_shards=S, shard_pad_multiple=S)
    engines, stores = [], []
    for n in nodes:
        sm, machines = P.make_sharded_kv(S)
        stores.append(machines)
        engines.append(P.RabiaEngine(P.ClusterConfig.new(n, nodes), sm, hub.register(n),
                                     config=cfg))
    return engines, stores, hub


async def _start(engines):
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    await _quorum(engines)
    return tasks


def _mine(P, e, S, R):
    """The shards this engine proposes next, idle and with nothing queued."""
    shard_ids = np.arange(S)
    head = np.maximum(e.rt.next_slot[:S], e.rt.applied_upto[:S])
    return shard_ids[
        (P.slot_proposer_vec(shard_ids, head, R) == e.me)
        & ~e.rt.in_flight[:S]
        & (e.rt.queue_len[:S] == 0)
    ]


async def _wave(P, live, S, R, key, tag, tolerate=False):
    futs = []
    for e in live:
        mine = _mine(P, e, S, R)
        if len(mine):
            try:
                futs.append(await e.submit_block(P.build_block(
                    mine, [[P.encode_set_bin(f"{key}{int(s)}", tag)] for s in mine])))
            except Exception:
                if not tolerate:
                    raise
    if futs:
        await asyncio.wait_for(asyncio.gather(*futs, return_exceptions=True), 20.0)


class TestBlockLaneEndToEnd:
    @pytest.mark.asyncio
    async def test_submit_block_commits_and_converges(self, P):
        S = 16
        engines, stores, _ = _mk_cluster(P, S)
        tasks = await _start(engines)
        try:
            svc = P.ShardedKVService(S, engines[0].submit_batch, stores[0],
                                     submit_block=engines[0].submit_block)
            res = await asyncio.wait_for(
                svc.set_many([(f"key{i}", f"val{i}") for i in range(64)]), 30.0)
            assert all(r.ok for r in res)

            def applied():
                return all(
                    (e := stores[r][svc.shard_of("key3")].store.get("key3")) is not None
                    and e.value == "val3"
                    for r in range(3)
                )

            await wait_until(applied, budget=20.0, desc="replica apply")
        finally:
            await _stop(engines, tasks)

    @pytest.mark.asyncio
    async def test_block_demotion_on_wrong_proposer(self, P):
        """A block covering shards this replica does not propose demotes
        them to the scalar lane (forwarded), and still commits."""
        S = 6
        engines, stores, _ = _mk_cluster(P, S)
        tasks = await _start(engines)
        try:
            svc = P.ShardedKVService(S, engines[2].submit_batch, stores[2],
                                     submit_block=engines[2].submit_block)
            res = await asyncio.wait_for(svc.set_many([(f"kk{i}", "z") for i in range(24)]), 30.0)
            assert all(r.ok for r in res), [str(r) for r in res if not r.ok][:3]
        finally:
            await _stop(engines, tasks)

    @pytest.mark.asyncio
    async def test_adaptive_batching_amortizes_slots(self, P):
        S = 4
        engines, stores, _ = _mk_cluster(P, S)
        tasks = await _start(engines)
        try:
            svc = P.ShardedKVService(S, engines[0].submit_batch, stores[0],
                                     batching=P.BatchConfig(max_batch_size=8, max_batch_delay=0.01))
            results = await asyncio.wait_for(
                asyncio.gather(*[svc.set(f"b{i}", "x") for i in range(48)]), 30.0)
            assert all(r.ok for r in results)
            batches = sum(s.batches_created for s in svc.batch_stats)
            cmds = sum(s.commands_batched for s in svc.batch_stats)
            assert cmds == 48
            assert batches < 48  # multiple commands rode one consensus slot
            flusher = svc._flusher
            await svc.close()
            assert svc._flusher is None and flusher.done()  # the flush loop is not leaked
        finally:
            await _stop(engines, tasks)


class TestBlockLaneFaults:
    @pytest.mark.asyncio
    async def test_replica_crash_mid_bulk_load(self, P):
        """Crash a replica while the block lane is pumping: survivors keep
        committing (dead-proposer shards rotate via null slots) and stay
        convergent."""
        S, R = 12, 3
        nodes = [P.NodeId.from_int(i + 1) for i in range(R)]
        hub = P.InMemoryHub()
        cfg = P.RabiaConfig(
            phase_timeout=0.3, heartbeat_interval=0.1, round_interval=0.0005
        ).with_kernel(num_shards=S, shard_pad_multiple=S)
        engines, stores, tasks = [], [], []
        for n in nodes:
            sm, machines = P.make_sharded_kv(S)
            stores.append(machines)
            engines.append(P.RabiaEngine(P.ClusterConfig.new(n, nodes), sm, hub.register(n),
                                         config=cfg))
            tasks.append(asyncio.ensure_future(engines[-1].run()))
        try:
            await _quorum(engines)
            shard_ids = np.arange(S)
            await _wave(P, engines, S, R, "w", "x")  # healthy wave
            tasks[0].cancel()
            hub.set_connected(nodes[0], False)
            pre = (await engines[1].get_statistics()).committed_slots
            deadline = asyncio.get_event_loop().time() + 20.0
            while asyncio.get_event_loop().time() < deadline:
                await _wave(P, engines[1:], S, R, "w", "x")
                e = engines[1]
                head = np.maximum(e.rt.next_slot[:S], e.rt.applied_upto[:S])
                stuck = shard_ids[(P.slot_proposer_vec(shard_ids, head, R) == 0)
                                  & (e.rt.queue_len[:S] < 1)]
                for s in stuck:
                    try:
                        await e.submit_batch(P.CommandBatch.new(
                            [P.Command.new(P.encode_set_bin(f"w{int(s)}", "x"))], shard=int(s)),
                            shard=int(s))
                    except Exception:
                        pass
                await asyncio.sleep(0.05)
                post = (await engines[1].get_statistics()).committed_slots
                if post - pre >= 2 * S:
                    break
            post = (await engines[1].get_statistics()).committed_slots
            assert post - pre >= S, f"survivors stalled: {post - pre} commits"

            def survivors_agree():
                a = stores[1][3].store.get("w3")
                b = stores[2][3].store.get("w3")
                return a is not None and b is not None and a.value == b.value

            await wait_until(survivors_agree, budget=20.0, desc="survivor convergence")
        finally:
            for e in engines[1:]:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)


class TestNoDecisionBroadcast:
    @pytest.mark.asyncio
    async def test_straggler_recovers_without_decision_broadcasts(self, P):
        """decision_broadcast=False: a partitioned replica that missed a
        stretch of commits catches back up through the targeted stale-vote
        repair and/or snapshot sync."""
        S, R = 8, 3
        nodes = [P.NodeId.from_int(i + 1) for i in range(R)]
        hub = P.InMemoryHub()
        cfg = P.RabiaConfig(
            phase_timeout=0.2, heartbeat_interval=0.05, round_interval=0.0005,
            sync_timeout=1.0, decision_broadcast=False,
        ).with_kernel(num_shards=S, shard_pad_multiple=S)
        engines, tasks = [], []
        for n in nodes:
            sm, _machines = P.make_sharded_kv(S)
            engines.append(P.RabiaEngine(P.ClusterConfig.new(n, nodes), sm, hub.register(n),
                                         config=cfg))
            tasks.append(asyncio.ensure_future(engines[-1].run()))
        try:
            await _quorum(engines)
            await _wave(P, engines, S, R, "s", "pre", tolerate=True)
            hub.set_connected(nodes[2], False)
            await asyncio.sleep(0.3)
            for i in range(4):
                await _wave(P, engines[:2], S, R, "s", f"gap{i}", tolerate=True)
            mid = (await engines[2].get_statistics()).committed_slots
            lead = (await engines[0].get_statistics()).committed_slots
            assert lead > mid, "quorum pair did not outrun the straggler"
            hub.set_connected(nodes[2], True)
            a = c = 0
            for _ in range(600):
                await asyncio.sleep(0.01)
                await _wave(P, engines, S, R, "s", "post", tolerate=True)
                a = (await engines[0].get_statistics()).committed_slots
                c = (await engines[2].get_statistics()).committed_slots
                if c >= a - S and c > mid:
                    break
            assert c > mid, "straggler made no progress after heal"
            assert c >= a - S, f"straggler stuck at {c} vs leader {a}"
        finally:
            await _stop(engines, tasks)


class TestGetMany:
    @pytest.mark.asyncio
    async def test_bulk_reads_through_consensus(self, P):
        S = 8
        engines, stores, _ = _mk_cluster(P, S)
        tasks = await _start(engines)
        try:
            svc = P.ShardedKVService(S, engines[0].submit_batch, stores[0],
                                     submit_block=engines[0].submit_block)
            pairs = [(f"gk{i}", f"gv{i}") for i in range(20)]
            res = await asyncio.wait_for(svc.set_many(pairs), 30.0)
            assert all(r.ok for r in res)
            got = await asyncio.wait_for(svc.get_many([k for k, _ in pairs] + ["absent-key"]), 30.0)
            for (k, v), r in zip(pairs, got):
                assert r.ok and r.value == v, (k, r)
            assert not got[-1].ok or got[-1].value is None  # NotFound
        finally:
            await _stop(engines, tasks)


class TestBlockLanePersistence:
    @pytest.mark.asyncio
    async def test_restart_rejoins_after_bulk_waves(self, P, tmp_path):
        """Block-lane commits and durable persistence: restart one
        replica's engine object; it restores its counters and snapshot and
        keeps committing with the cluster."""
        S, R = 6, 3
        nodes = [P.NodeId.from_int(i + 1) for i in range(R)]
        hub = P.InMemoryHub()
        # barrier_stride=1: taint only truly opened slots so the restored
        # replica rejoins at once
        cfg = P.RabiaConfig(
            phase_timeout=0.3, heartbeat_interval=0.05, round_interval=0.0005, barrier_stride=1,
        ).with_kernel(num_shards=S, shard_pad_multiple=S)
        persist = [P.FileSystemPersistence(str(tmp_path / f"n{i}")) for i in range(R)]
        nets = [hub.register(n) for n in nodes]

        def mk_engine(i, holder):
            sm, machines = P.make_sharded_kv(S)
            holder.append(machines)
            return P.RabiaEngine(P.ClusterConfig.new(nodes[i], nodes), sm, nets[i],
                                 persistence=persist[i], config=cfg)

        stores: list = []
        engines = [mk_engine(i, stores) for i in range(R)]
        tasks = [asyncio.ensure_future(e.run()) for e in engines]
        try:
            await _quorum(engines, 1000)
            for i in range(3):
                await _wave(P, engines, S, R, "p", f"w{i}", tolerate=True)
            await engines[0]._save_state()
            await engines[0].shutdown()
            tasks[0].cancel()
            await asyncio.gather(tasks[0], return_exceptions=True)
            committed_before = (await engines[1].get_statistics()).committed_slots
            restored: list = []
            e0 = mk_engine(0, restored)
            tasks[0] = asyncio.ensure_future(e0.run())
            engines[0] = e0
            for _ in range(1000):
                await asyncio.sleep(0.01)
                st = await e0.get_statistics()
                if st.has_quorum and st.committed_slots > 0:
                    break
            assert (await e0.get_statistics()).committed_slots > 0, (
                "restored replica lost its applied counters")

            def heads(e):
                return np.maximum(e.rt.next_slot[:S], e.rt.applied_upto[:S])

            await wait_until(lambda: np.all(heads(e0) >= heads(engines[1])), budget=20.0,
                             desc="restored replica head catch-up")
            deadline = time.monotonic() + 30.0
            i = 0
            after = committed_before
            got = None
            while time.monotonic() < deadline:
                await _wave(P, engines, S, R, "p", f"r{i}", tolerate=True)
                i += 1
                await asyncio.sleep(0.05)
                after = (await engines[1].get_statistics()).committed_slots
                got = restored[0][2].store.get("p2")
                if after > committed_before and got is not None and got.value.startswith("r"):
                    break
            assert after > committed_before
            assert got is not None and got.value.startswith("r")
        finally:
            for e in engines:
                try:
                    await asyncio.wait_for(e.shutdown(), 5.0)
                except Exception:
                    pass
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)


# -- the slice as a whole: four planes, one schedule -------------------------

N_SHARDS, N_REPLICAS = 8, 3


def _schedule(seed: int = 31, waves: int = 8) -> list:
    """Per wave, per shard: binary KV ops (SET, GET, DEL, EXISTS, CAS over
    4 keys a shard). Even waves go as one scalar batch a shard, odd waves
    as one block over every shard."""
    rng = np.random.default_rng(seed)
    port = _pkg("rabia_tpu_torch")
    keys = [[] for _ in range(N_SHARDS)]
    i = 0
    while min(len(k) for k in keys) < 4:
        k = f"sk{i}"
        i += 1
        s = port.shard_for_key(k, N_SHARDS)
        if len(keys[s]) < 4:
            keys[s].append(k)
    out = []
    Op = port.KVOperation
    for w in range(waves):
        wave = {}
        for s in range(N_SHARDS):
            ops = []
            for _ in range(int(rng.integers(1, 4))):
                k = keys[s][int(rng.integers(0, 4))]
                kind = int(rng.choice(5, p=[0.4, 0.2, 0.1, 0.1, 0.2]))
                op = [Op.set(k, f"v{w}.{int(rng.integers(0, 1000))}"), Op.get(k), Op.delete(k),
                      Op.exists(k), Op.cas(k, f"c{w}", int(rng.integers(0, 4)))][kind]
                ops.append(port.encode_op_bin(op))
            wave[s] = ops
        out.append(wave)
    return out


async def _transport_plane(P, schedule) -> tuple:
    nodes = [P.NodeId.from_int(i + 1) for i in range(N_REPLICAS)]
    hub = P.InMemoryHub()
    cfg = P.RabiaConfig(phase_timeout=3.0, heartbeat_interval=0.05, round_interval=0.002
                        ).with_kernel(num_shards=N_SHARDS, shard_pad_multiple=2)
    engines, stores = [], []
    for n in nodes:
        sm, machines = P.make_sharded_kv(N_SHARDS)
        stores.append(machines)
        engines.append(P.RabiaEngine(P.ClusterConfig.new(n, nodes), sm, hub.register(n),
                                     config=cfg))
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    try:
        await _quorum(engines)
        out = []
        for w, wave in enumerate(schedule):
            shards = sorted(wave)
            if w % 2 == 0:
                futs = [await engines[w % N_REPLICAS].submit_batch(
                    P.CommandBatch.new([P.Command.new(op) for op in wave[s]], shard=s), shard=s)
                    for s in shards]
                got = [await asyncio.wait_for(f, 30.0) for f in futs]
            else:
                f = await engines[w % N_REPLICAS].submit_block(
                    P.build_block(shards, [wave[s] for s in shards]))
                got = await asyncio.wait_for(f, 30.0)
            out.append([[bytes(r) for r in g] for g in got])

        def sums(ms):
            return [m.store.checksum() for m in ms]

        await wait_until(lambda: all(sums(ms) == sums(stores[0]) for ms in stores), budget=20.0,
                         desc="transport replicas converge")
        return out, [sums(ms) for ms in stores]
    finally:
        await _stop(engines, tasks)


def _mesh_plane(P, schedule) -> tuple:
    if P.name == "rabia_tpu":
        from rabia_tpu.parallel import make_mesh

        kw = {"mesh": make_mesh()}
    else:
        kw = {"device": "cpu"}
    eng = P.MeshEngine(lambda: P.make_sharded_kv(N_SHARDS)[0], N_SHARDS, N_REPLICAS, window=2,
                       **kw)
    out = []
    for w, wave in enumerate(schedule):
        shards = sorted(wave)
        if w % 2 == 0:
            futs = [eng.submit(list(wave[s]), s) for s in shards]
            eng.flush()
            got = [f.result() for f in futs]
        else:
            f = eng.submit_block(P.build_block(shards, [wave[s] for s in shards]))
            eng.flush()
            got = f.result()
        out.append([[bytes(r) for r in g] for g in got])
    return out, [[m.store.checksum() for m in sm.machines] for sm in eng.sms]


class TestSliceFourPlanes:
    def test_one_schedule_through_both_packages_engines(self):
        schedule = _schedule()
        runs = {}
        for name in PACKAGES:
            P = _pkg(name)
            runs[(name, "transport")] = asyncio.run(_transport_plane(P, schedule))
            runs[(name, "mesh")] = _mesh_plane(P, schedule)
        resp0, sums0 = runs[("rabia_tpu", "transport")]
        for key, (resp, sums) in runs.items():
            assert resp == resp0, key
            assert sums == [sums0[0]] * N_REPLICAS, key
        assert len(set(sums0[0])) > 1  # the shards hold different content
        frames = [f for w in resp0 for g in w for f in g]
        port = _pkg("rabia_tpu_torch")
        kinds = {port.decode_kv_response(f).kind.value for f in frames}
        assert kinds == {"success", "not_found", "error"}  # CAS conflicts among them


# -- chip_smoke.py's phase 11 at a small size ---------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    import chip_smoke as cs

    return cs


class TestPhase11Small:
    def test_config1_counter(self, chip_smoke):
        st = chip_smoke.counter_config1("cpu", n=12)
        assert st["decided_slots"] >= 12 and st["commands"] == 12

    def test_config2_sharded_kv(self, chip_smoke):
        st = chip_smoke.kv_config2("cpu", S=8, R=3, waves=3)
        assert st["ok_responses"] > 0 and st["settle_p99_s"] >= st["settle_p50_s"]

    def test_config3_batched_kv_beside_device_lane(self, chip_smoke):
        st = chip_smoke.kv_config3("cpu", S=16, R=5, waves=2, per=4, P=16)
        assert st["device_table_entries"] == 16 * 2 * 4
        assert st["batch_stats"]["commands_batched"] == 16 * 2 * 4

    def test_config4_banking_minority_crash(self, chip_smoke):
        st = chip_smoke.bank_config4("cpu", S=16, R=7, post=2)
        assert st["commits_after_crash"] >= 16 * 2
