"""Partitioned consensus groups (rabia_tpu_torch.fleet.groups): GroupMap
determinism and bounded-movement rebalance, group-routed Submits across
real OS-process groups, the group-locality fence (admission shed +
coalesce assertion), replay-after-reroute exactly-once, and the
groups=2 vs groups=1 conformance leg.

The invariants under test are docs/FLEET.md's group-map section:
routing is a pure function of the versioned GroupMap doc (every router
computes the same bootstrap map), a ``move_range`` moves ONLY the
shards in the moved range, nothing ever crosses a group boundary (a
coalesced PayloadBlock spanning groups is an assertion failure, an
out-of-range Submit a retryable shed), and partitioning the shard
space changes WHERE an op commits but never WHAT any client observes.
"""

from __future__ import annotations

import asyncio
import uuid

import pytest

from rabia_tpu_torch.apps.kvstore import (
    KVOperation,
    decode_result_bin,
    encode_op_bin,
    encode_set_bin,
)
from rabia_tpu_torch.core.messages import AdminKind, ResultStatus
from rabia_tpu_torch.core.serialization import Serializer
from rabia_tpu_torch.fleet.groups import (
    GroupMap,
    GroupProcHarness,
    GroupRouter,
    GroupedFleetHarness,
    moved_group_shards,
)
from rabia_tpu_torch.gateway.client import admin_fetch
from rabia_tpu_torch.obs.registry import parse_prometheus_text
from rabia_tpu_torch.testing.loadsession import LoadSession

N_SHARDS = 4


# ---------------------------------------------------------------------------
# GroupMap: determinism, bounded movement, doc roundtrip
# ---------------------------------------------------------------------------


class TestGroupMap:
    def test_initial_partition_is_deterministic(self):
        """Every router must compute the SAME bootstrap map from
        (n_shards, n_groups) alone — no coordination round."""
        a = GroupMap.initial(8, 2)
        b = GroupMap.initial(8, 2)
        assert a == b
        assert a.to_doc() == b.to_doc()
        assert a.ranges() == [(0, 4, 0), (4, 8, 1)]
        # remainder spreads over the LOW groups, still contiguous
        assert GroupMap.initial(7, 2).ranges() == [(0, 4, 0), (4, 7, 1)]
        assert GroupMap.initial(5, 3).ranges() == [
            (0, 2, 0), (2, 4, 1), (4, 5, 2),
        ]
        gm = GroupMap.initial(8, 3)
        for s in range(8):
            lo, hi = {0: (0, 3), 1: (3, 6), 2: (6, 8)}[gm.group_of(s)]
            assert lo <= s < hi

    def test_initial_bounds(self):
        with pytest.raises(ValueError):
            GroupMap.initial(4, 0)
        with pytest.raises(ValueError):
            GroupMap.initial(4, 5)

    def test_move_range_bounded_movement(self):
        """move_range(lo, hi, g) must move EXACTLY the shards in
        [lo, hi) — the contiguous-range twin of the hash ring's
        bounded-movement guarantee."""
        gm = GroupMap.initial(8, 2)
        old = gm.copy()
        gm.move_range(4, 6, 0)
        assert moved_group_shards(old, gm) == {4: 0, 5: 0}
        assert gm.version == old.version + 1
        # canonical merge: the widened owner reads as ONE range
        assert gm.ranges() == [(0, 6, 0), (6, 8, 1)]
        # moving back restores the partition (and keeps bumping)
        gm.move_range(4, 6, 1)
        assert gm.ranges() == old.ranges()
        assert gm.version == old.version + 2

    def test_doc_roundtrip_and_validation(self):
        gm = GroupMap.initial(8, 3)
        gm.move_range(2, 4, 2)
        rt = GroupMap.from_doc(gm.to_doc())
        assert rt == gm and rt.version == gm.version
        # gap / overlap / short cover all rejected
        with pytest.raises(ValueError):
            GroupMap(4, [(0, 2, 0), (3, 4, 1)])
        with pytest.raises(ValueError):
            GroupMap(4, [(0, 3, 0), (2, 4, 1)])
        with pytest.raises(ValueError):
            GroupMap(4, [(0, 3, 0)])


class TestGroupRouter:
    def test_routing_spread_and_failover_order(self):
        gm = GroupMap.initial(4, 2)
        router = GroupRouter(gm, {
            0: [("h", 1), ("h", 2)],
            1: [("h", 3)],
        })
        # within a group: the deterministic shard % len spread
        assert router.upstream_for(0) == ("h", 1)
        assert router.upstream_for(1) == ("h", 2)
        assert router.upstream_for(2) == ("h", 3)
        assert router.candidates(1) == [("h", 2), ("h", 1)]
        with pytest.raises(ValueError):
            GroupRouter(gm, {0: [("h", 1)]})  # group 1 unaddressable

    def test_adopt_is_version_gated(self):
        gm = GroupMap.initial(4, 2)
        router = GroupRouter(gm.copy(), {
            0: [("h", 1)], 1: [("h", 2)],
        })
        newer = gm.copy()
        newer.move_range(1, 2, 1)
        stale = gm.copy()  # version 0, same as installed
        assert router.adopt(stale) is False
        assert router.adopt(newer) is True
        assert router.group_of(1) == 1
        # a replayed older push can never roll routing back
        assert router.adopt(stale) is False
        assert router.group_of(1) == 1


# ---------------------------------------------------------------------------
# Group-locality fence: admission shed + the coalesce assertion
# ---------------------------------------------------------------------------


class TestGroupFence:
    @pytest.mark.asyncio
    async def test_out_of_range_submit_sheds_retryable(self):
        """A grouped replica gateway sheds Submits outside its owned
        ranges as RETRY (reason ``group_range``) — retryable because a
        mid-rebalance stale router can land one in-flight submit here —
        and serves in-range traffic normally."""
        from rabia_tpu_torch.gateway import GatewayConfig
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        cluster = GatewayCluster(
            n_replicas=3,
            n_shards=N_SHARDS,
            gateway_config=GatewayConfig(
                group_id=0, group_shards=((0, 2),)
            ),
        )
        await cluster.start()
        ser = Serializer()
        s = LoadSession(ser)
        try:
            g0 = cluster.gateways[0]
            await s.connect("127.0.0.1", g0.port)
            ok = await s.submit(
                1, [encode_set_bin("in-range", "v")], 10.0
            )
            assert ok.status == ResultStatus.OK
            shed = await s.submit(
                3, [encode_set_bin("out-of-range", "v")], 10.0
            )
            assert shed.status == ResultStatus.RETRY
            assert g0.shed_reasons["group_range"] >= 1
            # the fence runs at admission: the fenced shard never even
            # opened a coalesce window on this gateway
            assert 3 not in g0._coal
        finally:
            await s.close()
            await cluster.stop()

    @pytest.mark.asyncio
    async def test_coalesce_flush_asserts_group_locality(self):
        """A coalesced PayloadBlock must never span groups: windows key
        per shard (structural — one window, one shard, one group) and
        the flush path ASSERTS the flushed shard is group-owned, so a
        routing bug surfaces as a crash, not silent cross-group bytes."""
        from rabia_tpu_torch.gateway import GatewayConfig
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        cluster = GatewayCluster(
            n_replicas=3,
            n_shards=N_SHARDS,
            gateway_config=GatewayConfig(
                group_id=0, group_shards=((0, 2),), coalesce=True
            ),
        )
        await cluster.start()
        try:
            from rabia_tpu_torch.gateway.server import _CoalesceWindow

            g0 = cluster.gateways[0]
            # an owned shard flushes fine (vacuously, no window open)
            g0._coal_flush(1)
            # inject a window for an UNOWNED shard: the flush must trip
            # the group-locality assertion instead of packing it
            g0._coal.setdefault(3, _CoalesceWindow())
            with pytest.raises(AssertionError, match="outside group"):
                g0._coal_flush(3)
            g0._coal.pop(3, None)
        finally:
            await cluster.stop()


# ---------------------------------------------------------------------------
# Process groups end to end
# ---------------------------------------------------------------------------


def _cid(i: int) -> uuid.UUID:
    return uuid.UUID(int=0xC0FFEE00 + i)


class TestProcessGroups:
    @pytest.mark.slow
    @pytest.mark.asyncio
    async def test_group_routed_submit_e2e_two_process_groups(self):
        """2 groups x 3 durable replica processes: Submits routed by the
        GroupRouter land OK on every shard, the wrong group's gateway
        fences them retryable, and a replayed (client_id, seq) answers
        byte-identical from the proposing gateway (session dedup) and
        never consumes a slot at ANY replica of the owning group."""
        gm = GroupMap.initial(N_SHARDS, 2)
        harness = GroupProcHarness(gm, n_replicas=3)
        ser = Serializer()
        loop = asyncio.get_event_loop()
        try:
            await loop.run_in_executor(None, harness.start)
            router = harness.router()
            acked: dict[int, tuple] = {}
            for shard in range(N_SHARDS):
                s = LoadSession(ser, client_id=_cid(shard))
                try:
                    await s.connect(*router.upstream_for(shard))
                    res = await s.submit(
                        shard,
                        [encode_set_bin(f"e2e-{shard}", "v")],
                        15.0,
                    )
                    assert res.status == ResultStatus.OK, (shard, res)
                    acked[shard] = (
                        s._seq, tuple(bytes(p) for p in res.payload)
                    )
                finally:
                    await s.close()

            # cross-group isolation: group 1's replicas fence shard 0
            s = LoadSession(ser)
            try:
                wrong = harness.upstream_addrs()[1][0]
                await s.connect(*wrong)
                res = await s.submit(
                    0, [encode_set_bin("cross", "v")], 15.0
                )
                assert res.status == ResultStatus.RETRY
            finally:
                await s.close()

            # replay on the SAME gateway over a FRESH connection: the
            # session table keys by client_id, so the dedup answers
            # CACHED byte-identical without re-driving the engine
            for shard in (0, 3):
                seq, want = acked[shard]
                g = gm.group_of(shard)
                same = harness.upstream_addrs()[g][shard % 3]
                s = LoadSession(ser, client_id=_cid(shard))
                try:
                    await s.connect(*same)
                    res = await s.submit_seq(
                        seq, shard,
                        [encode_set_bin(f"e2e-{shard}", "v")],
                        15.0,
                    )
                    assert res.status in (
                        ResultStatus.OK, ResultStatus.CACHED
                    )
                    assert tuple(bytes(p) for p in res.payload) == want
                finally:
                    await s.close()

            # replay at a DIFFERENT replica of the owning group: the
            # engine-ledger dedup must either answer byte-identical or
            # return the HONEST responses-unavailable terminal (native
            # block-lane entries record dedup ids on every replica but
            # responses only at the proposer) — and must NEVER consume
            # a new consensus slot (the double-apply gate below)
            async def applied(g: int) -> list[int]:
                out = []
                for port in harness.harnesses[g].gw_ports:
                    body = await admin_fetch(
                        "127.0.0.1", port,
                        kind=int(AdminKind.METRICS), timeout=10.0,
                    )
                    m = parse_prometheus_text(body.decode())
                    out.append(
                        int(m.get("rabia_engine_applied_slots_total", 0))
                    )
                return out

            await asyncio.sleep(0.5)  # let in-flight applies settle
            for shard in (0, 3):
                seq, want = acked[shard]
                g = gm.group_of(shard)
                other = harness.upstream_addrs()[g][(shard + 1) % 3]
                before = await applied(g)
                s = LoadSession(ser, client_id=_cid(shard))
                try:
                    await s.connect(*other)
                    res = await s.submit_seq(
                        seq, shard,
                        [encode_set_bin(f"e2e-{shard}", "v")],
                        15.0,
                    )
                    got = tuple(bytes(p) for p in res.payload)
                    if res.status in (
                        ResultStatus.OK, ResultStatus.CACHED
                    ):
                        assert got == want
                    else:
                        assert res.status == ResultStatus.ERROR
                        assert (
                            b"committed but responses unavailable"
                            in got[0]
                        ), got
                finally:
                    await s.close()
                await asyncio.sleep(0.3)
                assert await applied(g) == before, (
                    "cross-replica replay consumed consensus slots"
                )
        finally:
            harness.stop()

    @pytest.mark.slow
    @pytest.mark.asyncio
    async def test_rebalance_and_replay_after_reroute(self):
        """Mid-run rebalance through the routed-fleet front door: after
        ``[1, 2)`` moves group 0 -> 1, new Submits for shard 1 commit in
        the NEW owner, and a REPLAY of a pre-move seq still answers
        byte-identical (the routing tier's session dedup) — the
        exactly-once story across the flip."""
        gm = GroupMap.initial(N_SHARDS, 2)
        harness = GroupProcHarness(gm, n_replicas=3)
        fleet = None
        ser = Serializer()
        loop = asyncio.get_event_loop()
        try:
            await loop.run_in_executor(None, harness.start)
            fleet = GroupedFleetHarness(
                gm.copy(), harness.upstream_addrs(), n_gateways=1
            )
            await fleet.start()
            port = fleet.gateways[0].port
            s = LoadSession(ser, client_id=_cid(77))
            try:
                await s.connect("127.0.0.1", port)
                pre = await s.submit(
                    1, [encode_set_bin("pre-move", "a")], 20.0
                )
                assert pre.status == ResultStatus.OK
                pre_seq = s._seq
                want = tuple(bytes(p) for p in pre.payload)

                # the safe order: widen replicas first, then flip routing
                new_map = await harness.rebalance(1, 2, 1)
                assert moved_group_shards(gm, new_map) == {1: 1}
                fleet.adopt_groups(new_map)

                post = await s.submit(
                    1, [encode_set_bin("post-move", "b")], 20.0
                )
                assert post.status == ResultStatus.OK
            finally:
                await s.close()

            # replay across the flip on a FRESH connection (the
            # transport keys by client_id, so the dropped client
            # reconnects first — the realistic replay story): the
            # routing tier's session dedup answers byte-identical
            s2 = LoadSession(ser, client_id=_cid(77))
            try:
                await s2.connect("127.0.0.1", port)
                res = await s2.submit_seq(
                    pre_seq, 1,
                    [encode_set_bin("pre-move", "a")], 20.0,
                )
                assert res.status in (
                    ResultStatus.OK, ResultStatus.CACHED
                )
                assert tuple(bytes(p) for p in res.payload) == want
            finally:
                await s2.close()
        finally:
            if fleet is not None:
                await fleet.stop()
            harness.stop()

    @pytest.mark.slow
    @pytest.mark.asyncio
    async def test_conformance_groups2_matches_groups1(self):
        """Partitioning must change WHERE ops commit, never WHAT clients
        observe: the same deterministic workload against groups=1 and
        groups=2 yields byte-identical per-client responses (SET
        responses carry per-key versions, so this pins apply counts and
        order per key) and identical per-shard mutation counts."""

        async def drive(n_groups: int):
            gm = GroupMap.initial(N_SHARDS, n_groups)
            harness = GroupProcHarness(gm, n_replicas=3)
            ser = Serializer()
            loop = asyncio.get_event_loop()
            responses: dict[int, list[tuple]] = {}
            mutations: dict[int, int] = {}
            try:
                await loop.run_in_executor(None, harness.start)
                router = harness.router()
                for ci in range(4):
                    shard = ci % N_SHARDS
                    s = LoadSession(ser, client_id=_cid(100 + ci))
                    rows = []
                    try:
                        await s.connect(*router.upstream_for(shard))
                        for j in range(4):
                            res = await s.submit(
                                shard,
                                [
                                    encode_set_bin(
                                        f"cf-{ci}-{j}-{k}", f"v{j}.{k}"
                                    )
                                    for k in range(2)
                                ],
                                20.0,
                            )
                            assert res.status == ResultStatus.OK
                            rows.append(
                                tuple(bytes(p) for p in res.payload)
                            )
                        # per-shard mutation counts: sum of per-key
                        # versions read back through the owning group
                        # (consensus-slot GETs: the recovery children
                        # have no peer-gateway wiring, so the zero-slot
                        # read-index quorum probe is unavailable here)
                        total = 0
                        for j in range(4):
                            for k in range(2):
                                r = await s.submit(
                                    shard,
                                    [encode_op_bin(KVOperation.get(
                                        f"cf-{ci}-{j}-{k}"
                                    ))],
                                    20.0,
                                )
                                assert r.status == ResultStatus.OK
                                kv = decode_result_bin(
                                    bytes(r.payload[0])
                                )
                                total += int(kv.version or 0)
                        mutations[shard] = total
                    finally:
                        await s.close()
                    responses[ci] = rows
            finally:
                harness.stop()
            return responses, mutations

        r1, m1 = await drive(1)
        r2, m2 = await drive(2)
        assert r1 == r2, "per-client responses diverge across grouping"
        assert m1 == m2, "per-shard mutation counts diverge"
        # versions are the store's per-shard mutation counter: the 8
        # SETs on a shard stamp versions 1..8, so the sum (36) pins the
        # exact mutation COUNT per shard in both groupings
        assert all(v == 36 for v in m1.values()), m1
