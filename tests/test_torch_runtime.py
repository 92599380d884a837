"""Native engine runtime (native/runtime.cpp + engine/runtime_bridge.py).

The port's copy of the reference's tests/test_runtime.py, retargeted to
rabia_tpu_torch (the port's native libraries, built from its own sources).

Covers: activation preconditions, scalar + block commits through the
GIL-free io/tick thread, the zero-GIL-per-wave acceptance counter (and
its /metrics exposure), runtime-vs-asyncio conformance on fixed
schedules, shutdown ordering (runtime drain -> apply flush -> transport
close) including a mid-wave shutdown that must not lose staged result
frames, and the runtime flight-recorder kinds.

The asyncio orchestration stays the semantics owner: RABIA_PY_RUNTIME=1
forces it. Beyond the reference: the split into shard groups
(TestShardGroupSplit), the planes by store and transport (TestPlanes)
and the reference's runtime stage and histogram check (from
tests/test_slo.py).
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest

from rabia_tpu_torch.apps import make_sharded_kv
from rabia_tpu_torch.apps.kvstore import encode_set_bin
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.core.config import RabiaConfig, TcpNetworkConfig
from rabia_tpu_torch.core.errors import ResponsesUnavailableError
from rabia_tpu_torch.core.network import ClusterConfig
from rabia_tpu_torch.core.types import Command, CommandBatch, NodeId
from rabia_tpu_torch.engine import RabiaEngine
from rabia_tpu_torch.engine.leader import slot_proposer_vec
from rabia_tpu_torch.net.tcp import TcpNetwork


def _runtime_lib():
    from rabia_tpu_torch.native.build import load_runtime

    return load_runtime()


pytestmark = pytest.mark.skipif(
    _runtime_lib() is None, reason="native runtime library unavailable"
)


async def _mk_cluster(S: int, R: int, **cfg_kw):
    ids = [NodeId.from_int(i + 1) for i in range(R)]
    nets = [TcpNetwork(i, TcpNetworkConfig(bind_port=0)) for i in ids]
    for i in range(R):
        for j in range(R):
            if i != j:
                nets[i].add_peer(ids[j], "127.0.0.1", nets[j].port)
    cfg = RabiaConfig(
        phase_timeout=cfg_kw.pop("phase_timeout", 2.0),
        heartbeat_interval=0.05,
        round_interval=0.002,
    ).with_kernel(num_shards=S, shard_pad_multiple=max(1, S))
    engines, machines, tasks = [], [], []
    for i, n in enumerate(ids):
        sm, ms = make_sharded_kv(S)
        machines.append(ms)
        e = RabiaEngine(ClusterConfig.new(n, ids), sm, nets[i], config=cfg)
        engines.append(e)
        tasks.append(asyncio.ensure_future(e.run()))
    for _ in range(600):
        await asyncio.sleep(0.01)
        if all([(await e.get_statistics()).has_quorum for e in engines]):
            break
    else:
        raise AssertionError("cluster never formed quorum")
    return ids, nets, engines, machines, tasks


async def _teardown(engines, tasks, nets):
    for e in engines:
        await e.shutdown()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    for n in nets:
        await n.close()


async def _steady(engines, S: int) -> None:
    """Wait until every replica has applied every slot decided anywhere.
    The futures of a wave settle on its proposers first; a replica still
    deciding the last wave when the next one's announce lands is a loaded
    host's race (the decision can overtake the announce and take the
    scalar lane), not the steady state the GIL-handoff tests measure."""
    for _ in range(1000):
        top = np.max([e.rt.next_slot[:S] for e in engines], 0)
        if all((e.rt.applied_upto[:S] >= top).all() for e in engines):
            return
        await asyncio.sleep(0.01)


def _own_shards(e, S: int) -> np.ndarray:
    shard_ids = np.arange(S)
    head = np.maximum(e.rt.next_slot[:S], e.rt.applied_upto[:S])
    return shard_ids[
        (slot_proposer_vec(shard_ids, head, e.R) == e.me)
        & (e.rt.queue_len[:S] == 0)
        & ~e.rt.in_flight[:S]
    ]


class TestRuntimeActivation:
    def test_active_on_tcp_inactive_on_env(self, monkeypatch):
        async def run():
            _, nets, engines, _, tasks = await _mk_cluster(4, 3)
            try:
                assert all(e._rtm is not None for e in engines)
                assert all(e.health()["native_runtime"] for e in engines)
                # the transport's Python reader is detached: the runtime
                # thread owns the inbox
                assert all(n._reader_detached for n in nets)
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(run())

        async def run_forced():
            _, nets, engines, _, tasks = await _mk_cluster(4, 3)
            try:
                assert all(e._rtm is None for e in engines)
            finally:
                await _teardown(engines, tasks, nets)

        monkeypatch.setenv("RABIA_PY_RUNTIME", "1")
        asyncio.run(run_forced())

    def test_inactive_on_inmemory_hub(self):
        async def run():
            from rabia_tpu_torch.net import InMemoryHub

            hub = InMemoryHub()
            ids = [NodeId.from_int(i + 1) for i in range(3)]
            engines = [
                RabiaEngine(
                    ClusterConfig.new(n, ids),
                    make_sharded_kv(2)[0],
                    hub.register(n),
                    config=RabiaConfig().with_kernel(
                        num_shards=2, shard_pad_multiple=2
                    ),
                )
                for n in ids
            ]
            assert all(e._rtm is None for e in engines)

        asyncio.run(run())


class TestRuntimeCommit:
    def test_scalar_and_block_commit_and_gil_counter(self):
        async def run():
            S, R = 8, 3
            _, nets, engines, machines, tasks = await _mk_cluster(S, R)
            try:
                e0 = engines[0]
                # scalar commit
                fut = await e0.submit_batch(
                    CommandBatch.new(
                        [Command.new(encode_set_bin("k", "v"))], shard=1
                    ),
                    shard=1,
                )
                res = await asyncio.wait_for(fut, 10.0)
                assert len(res) == 1 and res[0][0] == 0  # ok result frame
                # steady state starts once the scalar slot has applied on
                # every replica: the submitter's future settles first, and
                # a peer's block for shard 1 that reaches a replica still
                # applying slot 0 escalates to Python (a scalar decide)
                for _ in range(1000):
                    if all(int(e.rt.applied_upto[1]) >= 1 for e in engines):
                        break
                    await asyncio.sleep(0.01)
                gil_before = e0._rtm.counter("gil_handoffs")
                waves_before = e0._rtm.counter("waves_native")
                # block-only waves on each engine's own shards: the
                # decide->apply->result path must never take the GIL
                for _ in range(5):
                    futs = []
                    for e in engines:
                        mine = _own_shards(e, S)
                        if len(mine) == 0:
                            continue
                        futs.append(
                            await e.submit_block(
                                build_block(
                                    mine,
                                    [
                                        [encode_set_bin(f"k{int(s)}", "v")]
                                        for s in mine
                                    ],
                                )
                            )
                        )
                    results = await asyncio.wait_for(
                        asyncio.gather(*futs), 20.0
                    )
                    for r in results:
                        for entry in r:
                            assert not isinstance(entry, Exception)
                    await _steady(engines, S)
                assert e0._rtm.counter("waves_native") > waves_before
                assert e0._rtm.counter("gil_handoffs") == gil_before, (
                    "steady-state native waves took a GIL handoff"
                )
                # /metrics exposure of the acceptance counter
                snap = e0.metrics.snapshot()
                assert snap.get("rabia_engine_native_runtime") == 1
                assert snap.get("rabia_runtime_waves_native_total", 0) > 0
                assert "rabia_runtime_gil_handoffs_total" in snap
                # replica state converges
                await asyncio.sleep(0.3)
                for _ in range(200):
                    # re-read: replica 0 may still be applying
                    want = [m.store.checksum() for m in machines[0]]
                    if all(
                        [m.store.checksum() for m in ms] == want
                        for ms in machines
                    ):
                        break
                    await asyncio.sleep(0.01)
                assert all(
                    [m.store.checksum() for m in ms] == want
                    for ms in machines
                )
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(run())

    def test_flight_runtime_kinds_present(self):
        async def run():
            S, R = 4, 3
            _, nets, engines, _, tasks = await _mk_cluster(S, R)
            try:
                e0 = engines[0]
                fut = await e0.submit_batch(
                    CommandBatch.new(
                        [Command.new(encode_set_bin("fk", "fv"))], shard=0
                    ),
                    shard=0,
                )
                await asyncio.wait_for(fut, 10.0)
                kinds = {ev["kind"] for ev in e0.flight_events()}
                assert "rt_wake" in kinds, kinds
                assert "rt_handoff" in kinds, kinds
                # lifecycle records still present alongside
                assert {"submit", "propose", "decide", "apply"} <= kinds
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(run())


class TestRuntimeConformance:
    def test_fixed_schedules_match_asyncio_owner(self):
        from rabia_tpu_torch.testing.conformance import (
            run_schedule_on_runtime_paths,
        )

        schedule = [
            {0: [("a", "1")], 1: [("b", "2"), ("c", "3")]},
            {0: [("a", "4")], 2: [("d", "5")]},
            {1: [("b", "6")], 2: [("e", "7")], 0: [("f", "8")]},
            {0: [("a", "9")], 1: [("g", "10")]},
        ]
        asyncio.run(
            run_schedule_on_runtime_paths(
                schedule, n_shards=3, n_replicas=3, tag="fixed-runtime"
            )
        )


class TestNoDeduplicatedSlot:
    """A decided slot whose record has not reached Python yet holds the
    queue head back (``RabiaEngine._decided_unapplied(unseen_holds=True)``
    on the runtime path): the runtime thread moves ``next_slot`` at the
    decision, so a head forwarded or proposed in that window commits a
    second time (the deduplicated slot of ROADMAP Queue 3)."""

    def test_unseen_decided_slot_holds_the_head(self):
        from rabia_tpu_torch.core.types import BatchId
        from rabia_tpu_torch.engine.state import EngineRuntime

        rt = EngineRuntime(2)
        sh = rt.shards[0]
        sh.applied_upto = 3
        sh.next_slot = 4  # slot 3 decided, its record still in the mailbox
        bid = BatchId.new()
        assert RabiaEngine._decided_unapplied(sh, bid, unseen_holds=True)
        assert not RabiaEngine._decided_unapplied(sh, bid)
        sh.applied_upto = 4
        assert not RabiaEngine._decided_unapplied(sh, bid, unseen_holds=True)

    @pytest.mark.parametrize("rep", range(3))
    def test_runtime_leg_decides_each_batch_once(self, rep, monkeypatch):
        """The runtime gate's 9 × 3 schedule on 7 workers: no slot
        commits a batch an earlier slot of its shard committed."""
        from rabia_tpu_torch.testing.conformance import _run_runtime_schedule

        monkeypatch.setenv("RABIA_RT_WORKERS", "7")
        monkeypatch.delenv("RABIA_PY_RUNTIME", raising=False)
        n = 9
        rng = np.random.default_rng(100 + rep)
        schedule = [
            {
                int(s): [(f"k{int(s)}-{w}", f"v{w}")]
                for s in rng.choice(n, size=n // 2, replace=False)
            }
            for w in range(4)
        ]
        leg = asyncio.run(_run_runtime_schedule(schedule, n, 3, tag="once"))
        assert leg[3], "runtime inactive"
        assert leg[4]["left_out"]["dedup_slots"] == []


class TestRuntimeShutdown:
    def test_shutdown_ordering_clean(self):
        """Runtime drain -> apply flush -> transport close: state and
        counters survive shutdown; the transport closes last."""

        async def run():
            S, R = 4, 3
            _, nets, engines, machines, tasks = await _mk_cluster(S, R)
            e0 = engines[0]
            fut = await e0.submit_batch(
                CommandBatch.new(
                    [Command.new(encode_set_bin("sk", "sv"))], shard=0
                ),
                shard=0,
            )
            await asyncio.wait_for(fut, 10.0)
            await _teardown(engines, tasks, nets)
            # post-shutdown: frozen counters and flight stay readable
            assert e0._rtm.counter("frames_native") > 0
            assert len(e0.flight_events()) > 0
            assert machines[0][0].store.get("sk").value == "sv"

        asyncio.run(run())

    def test_mid_wave_shutdown_keeps_staged_results(self):
        """A decided wave whose result frames are staged in the event
        mailbox when shutdown starts must still settle the submitter's
        future: stop() finishes the runtime iteration and drains the
        mailbox BEFORE the transport closes."""

        async def run():
            S, R = 8, 3
            _, nets, engines, machines, tasks = await _mk_cluster(S, R)
            e0 = engines[0]
            mine = _own_shards(e0, S)
            assert len(mine) > 0
            fut = await e0.submit_block(
                build_block(
                    mine,
                    [[encode_set_bin(f"m{int(s)}", "w")] for s in mine],
                )
            )
            # push the wave command down WITHOUT letting the event loop
            # drain the mailbox, then block the loop synchronously while
            # the C threads decide and apply the wave — the staged
            # results sit in the event ring when shutdown begins
            e0._rtm.pump()
            deadline = time.time() + 5.0
            while (
                e0._rtm.counter("slots_applied") < len(mine)
                and time.time() < deadline
            ):
                time.sleep(0.01)  # deliberately sync: no drain can run
            assert e0._rtm.counter("slots_applied") >= len(mine), (
                "wave never applied natively"
            )
            assert not fut.done(), "future settled without a drain?"
            await e0.shutdown()  # runtime drain happens in here
            assert fut.done(), "mid-wave shutdown lost staged results"
            res = fut.result()
            assert len(res) == len(mine)
            for entry in res:
                assert not isinstance(entry, Exception)
                assert len(entry) == 1 and bytes(entry[0])[0] == 0
            for e in engines[1:]:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for n in nets:
                await n.close()

        asyncio.run(run())


class TestShardGroupRuntime:
    """Thread-per-shard-group runtime (round 14): N C worker threads,
    each owning a contiguous shard group end-to-end. workers=1 stays the
    byte-for-byte historical runtime; these tests pin the multi-worker
    geometry, routing, per-worker observability and conformance."""

    def test_multi_worker_activation_and_commits(self, monkeypatch):
        monkeypatch.setenv("RABIA_RT_WORKERS", "2")

        async def run():
            S, R = 8, 3
            _, nets, engines, machines, tasks = await _mk_cluster(S, R)
            try:
                e0 = engines[0]
                rtm = e0._rtm
                assert rtm is not None and rtm.workers == 2
                assert rtm._chunk == 4  # contiguous groups [0,4) [4,8)
                assert rtm._group_of(0) == 0 and rtm._group_of(7) == 1
                # submit on shards of BOTH groups; every commit must land
                for s in (0, 2, 4, 7):
                    fut = await e0.submit_batch(
                        CommandBatch.new(
                            [Command.new(encode_set_bin(f"g{s}", "v"))],
                            shard=s,
                        ),
                        shard=s,
                    )
                    res = await asyncio.wait_for(fut, 10.0)
                    assert len(res) == 1 and res[0][0] == 0
                # both workers ran their loops and committed slots
                pw = [
                    rtm.counters_dict_worker(g) for g in range(rtm.workers)
                ]
                assert all(d["loops"] > 0 for d in pw)
                committed = [
                    d["decided_scalar"] + d["waves_native"] for d in pw
                ]
                assert all(cnt > 0 for cnt in committed), committed
                # aggregate counters = per-worker sums
                assert rtm.counter("decided_scalar") == sum(
                    d["decided_scalar"] for d in pw
                )
                # per-worker stage series carry the worker label on
                # /metrics next to the unlabeled aggregate
                text = e0.metrics.render_prometheus()
                assert 'rabia_runtime_stage_seconds{stage="tick"}' in text
                assert (
                    'worker="0"' in text and 'worker="1"' in text
                ), "per-worker stage series missing"
                # replica state converges across workers
                await asyncio.sleep(0.2)
                for _ in range(200):
                    # re-read: replica 0 may still be applying
                    want = [m.store.checksum() for m in machines[0]]
                    if all(
                        [m.store.checksum() for m in ms] == want
                        for ms in machines
                    ):
                        break
                    await asyncio.sleep(0.01)
                assert all(
                    [m.store.checksum() for m in ms] == want
                    for ms in machines
                )
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(run())

    def test_block_wave_across_groups_no_gil(self, monkeypatch):
        """A block wave spanning BOTH shard groups commits natively on
        every worker with zero GIL handoffs (the bridge splits it into
        group-pure CMD_OPEN_WAVE records; each worker applies through
        its own statekernel lane)."""
        monkeypatch.setenv("RABIA_RT_WORKERS", "2")

        async def run():
            S, R = 8, 3
            _, nets, engines, machines, tasks = await _mk_cluster(S, R)
            try:
                e0 = engines[0]
                rtm = e0._rtm
                gil_before = rtm.counter("gil_handoffs")
                waves_before = rtm.counter("waves_native")
                settled = 0
                for _ in range(4):
                    futs, owners = [], []
                    for e in engines:
                        mine = _own_shards(e, S)
                        if len(mine) == 0:
                            continue
                        owners.append(e)
                        futs.append(
                            await e.submit_block(
                                build_block(
                                    mine,
                                    [
                                        [encode_set_bin(f"x{int(s)}", "y")]
                                        for s in mine
                                    ],
                                )
                            )
                        )
                    results = await asyncio.wait_for(
                        asyncio.gather(*futs), 20.0
                    )
                    for e, r in zip(owners, results):
                        for entry in r:
                            if isinstance(entry, ResponsesUnavailableError):
                                # on a loaded host a snapshot sync may
                                # overtake a proposer's shard: its entry
                                # settles unavailable by design
                                assert e._syncs > 0, entry
                                continue
                            assert not isinstance(entry, Exception)
                            settled += 1
                    await _steady(engines, S)
                assert settled > 0
                assert rtm.counter("waves_native") > waves_before
                assert rtm.counter("gil_handoffs") == gil_before, (
                    "multi-worker native waves took a GIL handoff"
                )
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(run())

    def test_workers_conformance_vs_asyncio_and_single(self):
        """workers=2 and workers=1 each pin identical decision ledgers,
        byte-identical client responses and state checksums against the
        asyncio owner — transitively, workers=2 == workers=1.

        Under ambient load a retransmit can race a decide into one extra
        deduplicated slot on either leg: the gate names it and leaves it
        out of the ledger and the counter parity."""
        from rabia_tpu_torch.testing.conformance import (
            run_schedule_on_runtime_paths,
        )

        schedule = [
            {0: [("a", "1")], 3: [("b", "2"), ("c", "3")]},
            {1: [("d", "4")], 2: [("e", "5")]},
            {0: [("f", "6")], 1: [("g", "7")], 3: [("h", "8")]},
            {2: [("e", "9")], 0: [("a", "10")]},
        ]
        for w in (2, 1):
            asyncio.run(
                run_schedule_on_runtime_paths(
                    schedule, n_shards=4, n_replicas=3,
                    tag=f"fixed-runtime-w{w}", workers=w,
                )
            )

    def test_workers_clamp_and_single_worker_identity(self, monkeypatch):
        """workers never exceed the shard count, and workers=1 keeps the
        historical single-ring geometry (no sibling rk contexts)."""
        monkeypatch.setenv("RABIA_RT_WORKERS", "8")

        async def run():
            S, R = 2, 3
            _, nets, engines, _, tasks = await _mk_cluster(S, R)
            try:
                rtm = engines[0]._rtm
                assert rtm is not None
                assert rtm.workers == 2  # clamped to n_shards
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(run())

        monkeypatch.setenv("RABIA_RT_WORKERS", "1")

        async def run_single():
            S, R = 4, 3
            _, nets, engines, _, tasks = await _mk_cluster(S, R)
            try:
                rtm = engines[0]._rtm
                assert rtm is not None and rtm.workers == 1
                assert rtm._extra_rks == []
                assert engines[0]._rk.siblings == []
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(run_single())


class TestRuntimeStageProfiler:
    """The port's copy of the reference's runtime stage and histogram
    check (tests/test_slo.py), on the port's runtime."""

    def test_native_runtime_stage_and_hist_blocks_populate(self):
        from rabia_tpu_torch.obs.registry import (
            RUNTIME_STAGES,
            parse_prometheus_text,
        )

        async def run():
            S = 8
            _, nets, engines, _, tasks = await _mk_cluster(S, 3)
            try:
                assert all(e._rtm is not None for e in engines)
                e0 = engines[0]
                for r in range(4):
                    futs = []
                    for e in engines:
                        mine = _own_shards(e, S)
                        if len(mine) == 0:
                            continue
                        futs.append(
                            await e.submit_block(
                                build_block(
                                    mine,
                                    [
                                        [encode_set_bin(f"k{r}-{int(s)}", "v")]
                                        for s in mine
                                    ],
                                )
                            )
                        )
                    await asyncio.wait_for(asyncio.gather(*futs), 20.0)
                await asyncio.sleep(0.2)
                # the RTS block populated and exposed through the registry
                st = e0._rtm.stages_dict()
                assert sum(st.values()) > 0
                assert st["idle"] > 0
                # decided block waves applied natively -> RTH decide_apply
                da = e0._rtm.hist_stage("decide_apply")
                bc = e0._rtm.hist_stage("broadcast")
                assert da is not None and da[1] > 0
                assert bc is not None and bc[1] > 0
                m = parse_prometheus_text(e0.metrics.render_prometheus())
                assert m['rabia_slo_seconds_count{stage="decide_apply"}'] == da[1]
                assert m['rabia_runtime_stage_seconds{stage="idle"}'] > 0
                # stage deltas over a window cover >= 95% of its wall time
                t0 = time.monotonic()
                s0 = {s: e0.stage_second(s) for s in RUNTIME_STAGES}
                await asyncio.sleep(1.0)
                elapsed = time.monotonic() - t0
                s1 = {s: e0.stage_second(s) for s in RUNTIME_STAGES}
                cov = sum(s1[s] - s0[s] for s in RUNTIME_STAGES) / elapsed
                assert cov >= 0.95, (cov, s0, s1)
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(run())


def _groups(n: int, w: int) -> list[tuple[int, int]]:
    """The [lo, hi) ranges the bridge gives its tick contexts (and
    runtime.cpp its workers) for n shards at a requested w."""
    from rabia_tpu_torch.engine.runtime_bridge import shard_groups

    workers, chunk = shard_groups(n, w)
    return [
        (g * chunk, n if g == workers - 1 else min((g + 1) * chunk, n))
        for g in range(workers)
    ]


class TestShardGroupSplit:
    """The split into shard groups leaves no group empty. The reference
    keeps W = min(shards, cores - 1) groups of ceil(n / W) shards, so at 8
    shards and W = 7 groups 4..6 start at or past shard 8 (lo > hi), and
    its runtime's open collection memsets a negative length."""

    def test_every_shard_in_exactly_one_nonempty_group(self):
        for n in range(1, 65):
            for w in range(1, 65):
                groups = _groups(n, w)
                assert 1 <= len(groups) <= min(n, w), (n, w)
                assert all(lo < hi for lo, hi in groups), (n, w, groups)
                owners = np.zeros(n, np.int64)
                for lo, hi in groups:
                    owners[lo:hi] += 1
                assert (owners == 1).all(), (n, w, groups)
                # runtime.cpp's classifier: group of s = min(s // chunk, W - 1)
                chunk = groups[0][1] - groups[0][0]
                for g, (lo, hi) in enumerate(groups):
                    assert all(
                        min(s // chunk, len(groups) - 1) == g
                        for s in range(lo, hi)
                    ), (n, w, g)

    @pytest.mark.parametrize("n_shards", [8, 9, 15])
    def test_seven_workers_commit_as_asyncio_owner(self, n_shards, monkeypatch):
        from rabia_tpu_torch.testing.conformance import (
            run_schedule_on_runtime_paths,
        )

        monkeypatch.setenv("RABIA_RT_WORKERS", "7")

        async def geometry():
            _, nets, engines, _, tasks = await _mk_cluster(n_shards, 3)
            try:
                want = len(_groups(n_shards, 7))
                for e in engines:
                    rtm = e._rtm
                    assert rtm is not None and rtm.workers == want
                    assert int(rtm.lib.rtm_workers(rtm.ctx)) == want
                    chunk = int(rtm.lib.rtm_group_chunk(rtm.ctx))
                    assert chunk == _groups(n_shards, 7)[0][1]
            finally:
                await _teardown(engines, tasks, nets)

        asyncio.run(geometry())
        rng = np.random.default_rng(n_shards)
        schedule = [
            {
                int(s): [(f"k{int(s)}-{w}", f"v{w}")]
                for s in rng.choice(n_shards, size=n_shards // 2, replace=False)
            }
            for w in range(4)
        ]
        asyncio.run(
            run_schedule_on_runtime_paths(
                schedule, n_shards=n_shards, n_replicas=3,
                tag=f"split-{n_shards}-w7", workers=7,
            )
        )


class TestPlanes:
    """Which planes run, by cluster: the reference's rules."""

    def test_planes_by_store_and_transport(self):
        from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
        from rabia_tpu_torch.net import InMemoryHub

        async def tcp(make_sm):
            ids = [NodeId.from_int(i + 1) for i in range(3)]
            nets = [TcpNetwork(i, TcpNetworkConfig(bind_port=0)) for i in ids]
            cfg = RabiaConfig().with_kernel(num_shards=8, shard_pad_multiple=8)
            engines = [
                RabiaEngine(ClusterConfig.new(n, ids), make_sm(), nets[i], config=cfg)
                for i, n in enumerate(ids)
            ]
            planes = [e.health()["planes"] for e in engines]
            for e in engines:
                if e._rtm is not None:
                    e._rtm.close()
            for n in nets:
                await n.close()
            return planes

        for p in asyncio.run(tcp(lambda: VectorShardedKV(8))):
            assert (p["tick"], p["codec"], p["apply"], p["runtime"]) == (
                "native", "native", "python", "python"
            )
        for p in asyncio.run(tcp(lambda: make_sharded_kv(8)[0])):
            assert (p["tick"], p["codec"], p["apply"], p["runtime"]) == (
                "native", "native", "native", "native"
            )
        hub = InMemoryHub()
        ids = [NodeId.from_int(i + 1) for i in range(3)]
        e = RabiaEngine(
            ClusterConfig.new(ids[0], ids), make_sharded_kv(8)[0],
            hub.register(ids[0]),
            config=RabiaConfig().with_kernel(num_shards=8, shard_pad_multiple=8),
        )
        p = e.health()["planes"]
        assert (p["tick"], p["apply"], p["runtime"]) == ("native", "native", "python")
