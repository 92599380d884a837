"""Fleet tier tests: hash ring, ledger/handoff codecs and semantics,
routed MOVED-following clients, cross-gateway exactly-once.

The in-process tests drive a real-TCP replica cluster
(:class:`~rabia_tpu_torch.testing.gateway_cluster.GatewayCluster`) behind
in-process :class:`~rabia_tpu_torch.fleet.gateway_proc.FleetGateway`\\ s
(:class:`~rabia_tpu_torch.fleet.harness.FleetHarness`); the subprocess test
spawns each fleet gateway as its own OS process via the
testing/recovery child protocol, so a SIGKILL is a real crash. The
invariants under test are docs/FLEET.md's failure matrix: MOVED never
loses a seq, handoff lands dedup state before redirects start, and a
killed gateway's acked results replay byte-identical from the
replicated ledger on its ring successor.
"""

from __future__ import annotations

import asyncio
import json
import struct
import uuid

import pytest

from rabia_tpu_torch.apps.kvstore import encode_set_bin
from rabia_tpu_torch.core.messages import ResultStatus
from rabia_tpu_torch.core.serialization import Serializer
from rabia_tpu_torch.core.types import NodeId
from rabia_tpu_torch.fleet import HashRing, RingMember, moved_shards
from rabia_tpu_torch.fleet.handoff import (
    decode_handoff,
    encode_handoff,
    export_sessions,
    import_sessions,
)
from rabia_tpu_torch.fleet.harness import (
    FleetConnPool,
    FleetHarness,
    FleetResolver,
    FleetSession,
)
from rabia_tpu_torch.fleet.ledger import (
    LedgerRecord,
    apply_record,
    decode_records,
    encode_records,
)
from rabia_tpu_torch.gateway.session import (
    SUBMIT_DUP_CACHED,
    SUBMIT_DUP_INFLIGHT,
    SUBMIT_FRESH,
    SessionTable,
)

N_SHARDS = 64


def _members(n: int, port0: int = 9000) -> list[RingMember]:
    return [
        RingMember(
            name=f"gw{i}", host="127.0.0.1", port=port0 + i,
            node=NodeId.from_int(2000 + i),
        )
        for i in range(n)
    ]


class TestHashRing:
    def test_ownership_total_and_deterministic(self):
        a, b = HashRing(), HashRing()
        for m in _members(4):
            a.add(m)
        for m in reversed(_members(4)):
            b.add(m)  # insertion order must not matter
        owners_a = {s: a.owner(s).name for s in range(N_SHARDS)}
        owners_b = {s: b.owner(s).name for s in range(N_SHARDS)}
        assert owners_a == owners_b
        assert set(owners_a.values()) == {"gw0", "gw1", "gw2", "gw3"}

    def test_bounded_movement_on_removal(self):
        """Removing one member moves exactly its own shards — every
        other shard keeps its owner (the consistent-hash contract)."""
        old = HashRing()
        for m in _members(4):
            old.add(m)
        new = old.copy()
        new.remove("gw2")
        moved = moved_shards(old, new, N_SHARDS)
        assert moved, "gw2 owned no shards at 64 — degenerate layout"
        for s in range(N_SHARDS):
            if old.owner(s).name == "gw2":
                assert s in moved and moved[s] != "gw2"
            else:
                assert s not in moved
                assert new.owner(s).name == old.owner(s).name

    def test_bounded_movement_on_add(self):
        old = HashRing()
        for m in _members(3):
            old.add(m)
        new = old.copy()
        new.add(_members(4)[3])
        moved = moved_shards(old, new, N_SHARDS)
        # every moved shard moved TO the new member, none between
        # incumbents
        assert moved
        assert set(moved.values()) == {"gw3"}

    def test_successors_distinct_start_with_owner(self):
        ring = HashRing()
        for m in _members(4):
            ring.add(m)
        for s in range(N_SHARDS):
            succ = ring.successors(s, 3)
            assert len(succ) == 3
            assert len({m.name for m in succ}) == 3
            assert succ[0].name == ring.owner(s).name
        # k beyond membership clamps to distinct members
        assert len(ring.successors(0, 10)) == 4

    def test_doc_round_trip_and_version(self):
        ring = HashRing(vnodes=8)
        v0 = ring.version
        for m in _members(3):
            ring.add(m)
        assert ring.version == v0 + 3
        clone = HashRing.from_doc(ring.to_doc())
        assert len(clone) == 3
        assert clone.vnodes == 8
        for s in range(N_SHARDS):
            assert clone.owner(s).name == ring.owner(s).name
        m = clone.members["gw1"]
        assert (m.host, m.port, m.node) == (
            "127.0.0.1", 9001, NodeId.from_int(2001),
        )
        ring.remove("gw0")
        assert ring.version == v0 + 4


class TestLedgerCodec:
    def test_round_trip(self):
        recs = [
            LedgerRecord(
                client_id=uuid.UUID(int=7), seq=3, shard=1, status=0,
                payload=(b"ok", b"", b"\x00" * 300),
            ),
            LedgerRecord(
                client_id=uuid.UUID(int=8), seq=2**40, shard=0,
                status=1, payload=(),
            ),
        ]
        assert decode_records(encode_records(recs)) == recs

    def test_apply_fresh_then_replay_is_cached(self):
        t = SessionTable(default_window=4)
        cid = uuid.UUID(int=9)
        d = apply_record(t, cid, 1, 0, (b"r1",), 5, now=0.0)
        assert d == SUBMIT_FRESH
        dec, st, pl = t.submit_check(cid, 1, 0, now=0.1)
        assert dec == SUBMIT_DUP_CACHED
        assert (st, pl) == (0, (b"r1",))

    def test_apply_onto_existing_reservation_completes_it(self):
        t = SessionTable(default_window=4)
        cid = uuid.UUID(int=10)
        assert t.submit_check(cid, 1, 0, now=0.0)[0] == SUBMIT_FRESH
        d = apply_record(t, cid, 1, 0, (b"done",), 6, now=0.1)
        assert d == SUBMIT_DUP_INFLIGHT
        dec, st, pl = t.submit_check(cid, 1, 0, now=0.2)
        assert dec == SUBMIT_DUP_CACHED and pl == (b"done",)

    def test_apply_never_overwrites_cached(self):
        """First completion wins: a late ledger record for an
        already-cached seq is a no-op (the byte-identical-replay
        invariant would break otherwise)."""
        t = SessionTable(default_window=4)
        cid = uuid.UUID(int=11)
        apply_record(t, cid, 1, 0, (b"first",), 1, now=0.0)
        d = apply_record(t, cid, 1, 1, (b"second",), 2, now=0.1)
        assert d == SUBMIT_DUP_CACHED
        assert t.cached_result(cid, 1).payload == (b"first",)


class TestHandoff:
    def _table_with_state(self):
        t = SessionTable(default_window=8)
        c1, c2 = uuid.UUID(int=21), uuid.UUID(int=22)
        for seq in (1, 2, 3):
            assert t.submit_check(c1, seq, 0, now=0.0)[0] == SUBMIT_FRESH
        t.complete_op(c1, 1, 0, (b"a1", b""), 1, now=0.0)
        t.complete_op(c1, 2, 1, (b"err",), 2, now=0.0)
        # seq 3 stays inflight
        assert t.submit_check(c2, 1, 0, now=0.0)[0] == SUBMIT_FRESH
        t.complete_op(c2, 1, 0, (b"b1",), 3, now=0.0)
        return t, c1, c2

    def test_codec_round_trip(self):
        t, c1, c2 = self._table_with_state()
        exports = export_sessions(t, [c1, c2, uuid.UUID(int=99)])
        assert len(exports) == 2  # unknown cid skipped
        assert decode_handoff(encode_handoff(exports)) == exports

    def test_import_lands_replayable_state(self):
        t, c1, c2 = self._table_with_state()
        dst = SessionTable(default_window=8)
        summary = import_sessions(
            dst, export_sessions(t, [c1, c2]), frontier_mark=10, now=1.0
        )
        assert summary.sessions == 2
        assert summary.results == 3
        assert summary.inflight == 1
        assert summary.skipped == 0
        # replays answer byte-identically on the new owner
        dec, st, pl = dst.submit_check(c1, 2, 0, now=1.1)
        assert dec == SUBMIT_DUP_CACHED and (st, pl) == (1, (b"err",))
        dec, st, pl = dst.submit_check(c1, 1, 0, now=1.1)
        assert dec == SUBMIT_DUP_CACHED and (st, pl) == (0, (b"a1", b""))
        # the inflight seq imported as a live reservation, not a result
        assert dst.submit_check(c1, 3, 0, now=1.1)[0] == SUBMIT_DUP_INFLIGHT
        # the window grant survived the move
        assert dst.sessions[c1].window == 8

    def test_import_never_overwrites_resident_state(self):
        """A replay (or ledger record) racing the handoff means the
        destination already holds the seq — the import must count it
        skipped, not clobber it."""
        t, c1, _c2 = self._table_with_state()
        dst = SessionTable(default_window=8)
        apply_record(dst, c1, 1, 0, (b"resident",), 1, now=0.5)
        summary = import_sessions(
            dst, export_sessions(t, [c1]), frontier_mark=10, now=1.0
        )
        assert summary.skipped == 1
        assert dst.cached_result(c1, 1).payload == (b"resident",)


def _gw_index(harness: FleetHarness, member) -> int:
    return int(member.name.removeprefix("gw"))


async def _owner_and_successor(harness: FleetHarness, shard: int):
    ring = harness.gateways[harness.live_indices()[0]].ring
    owner, succ = ring.successors(shard, 2)
    return _gw_index(harness, owner), _gw_index(harness, succ)


class TestFleetRouting:
    @pytest.mark.asyncio
    async def test_moved_redirect_reaches_owner(self):
        """A client whose ring view is wrong gets MOVED to the real
        owner and the SAME seq commits there — no lost or doubled
        submits, and the resolver remembers the correction."""
        h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
        await h.start()
        try:
            shard = 0
            owner_i, succ_i = await _owner_and_successor(h, shard)
            resolver = h.resolver()
            # poison the view: point the shard at the non-owner
            wrong = h.gateways[succ_i].member()
            resolver.note_moved(shard, (wrong.host, wrong.port))
            sess = FleetSession(h.ser, resolver)
            res = await sess.submit(shard, [encode_set_bin("mv", "1")])
            assert res.status == ResultStatus.OK
            assert sess.redirects >= 1
            assert resolver.addr_for(shard) == (
                h.gateways[owner_i].member().host,
                h.gateways[owner_i].member().port,
            )
            # second submit goes straight through (no new redirect)
            before = sess.redirects
            res = await sess.submit(shard, [encode_set_bin("mv", "2")])
            assert res.status == ResultStatus.OK
            assert sess.redirects == before
            assert h.gateways[succ_i].stats.moved >= 1
            await sess.close()
        finally:
            await h.stop()

    @pytest.mark.asyncio
    async def test_ledger_replication_answers_replay_on_successor(self):
        """A completed result's ledger record lands on the shard's ring
        successor; a replay of the SAME seq routed there answers CACHED
        with byte-identical payload — without the successor ever
        forwarding upstream."""
        h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
        await h.start()
        try:
            shard = 1
            owner_i, succ_i = await _owner_and_successor(h, shard)
            sess = FleetSession(h.ser, h.resolver())
            res = await sess.submit(shard, [encode_set_bin("led", "v")])
            assert res.status == ResultStatus.OK
            want = tuple(bytes(p) for p in res.payload)
            # replication is fire-and-forget: wait for the record
            succ = h.gateways[succ_i]
            for _ in range(100):
                if succ.sessions.cached_result(sess.client_id, 1):
                    break
                await asyncio.sleep(0.02)
            rec = succ.sessions.cached_result(sess.client_id, 1)
            assert rec is not None, "ledger record never replicated"
            # route the replay AT the successor
            sess.resolver.note_moved(
                shard, (succ.member().host, succ.member().port)
            )
            replay = await sess.submit_seq(
                1, shard, [encode_set_bin("led", "v")]
            )
            assert replay.status == ResultStatus.CACHED
            assert tuple(bytes(p) for p in replay.payload) == want
            assert succ.stats.ledger_applied >= 1
            assert h.gateways[owner_i].stats.ledger_sent >= 1
            await sess.close()
        finally:
            await h.stop()

    @pytest.mark.asyncio
    async def test_rebalance_hands_sessions_off_before_moved(self):
        """A planned drain: the departing gateway exports its sessions
        to the new owners BEFORE answering MOVED, so a redirected
        client's replay finds its dedup state resident — CACHED,
        byte-identical — and fresh traffic keeps flowing."""
        h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
        await h.start()
        try:
            stale = h.resolver()  # pre-drain view: will be MOVED
            sessions = [FleetSession(h.ser, stale) for _ in range(4)]
            want: dict[int, tuple] = {}
            for i, s in enumerate(sessions):
                shard = i % 4
                res = await s.submit(
                    shard, [encode_set_bin(f"hk{i}", f"v{i}")]
                )
                assert res.status == ResultStatus.OK
                want[i] = tuple(bytes(p) for p in res.payload)
            # drain gw0: every shard moves to gw1, sessions ride along
            await h.rebalance([1])
            imported = h.gateways[1].stats.handoff_in_sessions
            assert imported >= 1, "no sessions handed off"
            for i, s in enumerate(sessions):
                shard = i % 4
                replay = await s.submit_seq(
                    1, shard, [encode_set_bin(f"hk{i}", f"v{i}")]
                )
                assert replay.status == ResultStatus.CACHED, (
                    f"session {i} replay was {replay.status} not CACHED"
                )
                assert tuple(bytes(p) for p in replay.payload) == want[i]
                fresh = await s.submit(
                    shard, [encode_set_bin(f"hk{i}-b", "w")]
                )
                assert fresh.status == ResultStatus.OK
            for s in sessions:
                await s.close()
        finally:
            await h.stop()

    @pytest.mark.asyncio
    async def test_gateway_kill_failover_exactly_once(self):
        """Abrupt gateway death (no handoff): the client fails over to
        the ring successor, the acked pre-kill result replays CACHED
        byte-identical from the replicated ledger, replays mutate
        nothing (store.version parity), and fresh submits keep
        flowing."""
        h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
        await h.start()
        try:
            shard = 2
            owner_i, succ_i = await _owner_and_successor(h, shard)
            sess = FleetSession(h.ser, h.resolver())
            res = await sess.submit(shard, [encode_set_bin("fk", "v")])
            assert res.status == ResultStatus.OK
            want = tuple(bytes(p) for p in res.payload)
            # wait for the replicated record before the kill — the
            # fire-and-forget window is the cost of async replication;
            # bounding it is the chaos scenario's job, not this test's
            succ = h.gateways[succ_i]
            for _ in range(100):
                if succ.sessions.cached_result(sess.client_id, 1):
                    break
                await asyncio.sleep(0.02)
            assert succ.sessions.cached_result(sess.client_id, 1)
            # the baseline waits for every replica to apply the acked
            # write: a follower may apply it after the ack, and read
            # early that would pass for a double apply
            for _ in range(250):
                vers = [
                    h.cluster.store(r, shard).version for r in range(3)
                ]
                if len(set(vers)) == 1:
                    break
                await asyncio.sleep(0.02)
            assert len(set(vers)) == 1, vers
            await h.kill_gateway(owner_i)
            replay = await sess.submit_seq(
                1, shard, [encode_set_bin("fk", "X")], timeout=20.0
            )
            assert sess.failovers >= 1
            assert replay.status == ResultStatus.CACHED
            assert tuple(bytes(p) for p in replay.payload) == want
            await asyncio.sleep(0.3)
            assert [
                h.cluster.store(r, shard).version for r in range(3)
            ] == vers, "failover replay re-applied (double apply)"
            fresh = await sess.submit(
                shard, [encode_set_bin("fk2", "w")], timeout=20.0
            )
            assert fresh.status == ResultStatus.OK
            await sess.close()
        finally:
            await h.stop()

    @pytest.mark.asyncio
    async def test_mux_pool_sessions_share_sockets(self):
        """The 10^5-session lane: many FleetSessions over one
        FleetConnPool — one mux socket per gateway serves them all."""
        h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
        await h.start()
        try:
            pool = FleetConnPool(h.ser)
            resolver = h.resolver()
            sessions = [
                FleetSession(h.ser, resolver, pool=pool)
                for _ in range(16)
            ]
            res = await asyncio.gather(*(
                s.submit(i % 4, [encode_set_bin(f"mx{i}", "1")])
                for i, s in enumerate(sessions)
            ))
            assert all(r.status == ResultStatus.OK for r in res)
            assert len(pool.muxes) <= 2
            for s in sessions:
                await s.close()
            await pool.close()
        finally:
            await h.stop()


class TestRabiaClientMoved:
    @pytest.mark.asyncio
    async def test_client_follows_moved_to_owner(self):
        """The library client (RabiaClient) pointed at the wrong fleet
        gateway follows MOVED — the redirected seq commits exactly once
        and later submits reuse the corrected endpoint ordering."""
        from rabia_tpu_torch.gateway.client import RabiaClient
        from rabia_tpu_torch.gateway.server import GatewayEndpoint

        h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
        await h.start()
        cli = None
        try:
            ring = h.gateways[0].ring
            target = next(
                s for s in range(4) if ring.owner(s).name != "gw0"
            )
            gw0 = h.gateways[0].member()
            cli = RabiaClient(
                [GatewayEndpoint(
                    node_id=gw0.node, host=gw0.host, port=gw0.port
                )]
            )
            await cli.connect()
            out = await cli.submit(target, [encode_set_bin("cm", "1")])
            assert len(out) == 1
            assert cli.moved_redirects == 1
            before = cli.moved_redirects
            await cli.submit(target, [encode_set_bin("cm", "2")])
            assert cli.moved_redirects == before
        finally:
            if cli is not None:
                await cli.close()
            await h.stop()


class TestFleetAdmin:
    @pytest.mark.asyncio
    async def test_ring_admin_frame_reports_ownership(self):
        from rabia_tpu_torch.core.messages import AdminKind
        from rabia_tpu_torch.gateway.client import admin_fetch

        h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
        await h.start()
        try:
            m = h.gateways[0].member()
            body = await admin_fetch(
                m.host, m.port, kind=int(AdminKind.RING), timeout=5.0
            )
            doc = json.loads(body.decode())
            assert doc["self"] == "gw0"
            assert doc["n_shards"] == 4
            ring = HashRing.from_doc(doc["ring"])
            assert {m.name for m in ring.members.values()} == {
                "gw0", "gw1",
            }
            assert sorted(doc["owned_shards"]) == sorted(
                s for s in range(4) if ring.owner(s).name == "gw0"
            )
        finally:
            await h.stop()


@pytest.mark.slow
class TestFleetProc:
    @pytest.mark.asyncio
    async def test_child_protocol_and_kill9_failover(self):
        """Fleet gateways as real OS processes: ready events carry the
        ring layout, a submit routes end-to-end, and a SIGKILL'd
        gateway's shards fail over to the survivor."""
        from rabia_tpu_torch.fleet.harness import FleetProcHarness
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        cluster = GatewayCluster(
            n_replicas=3, n_shards=4, persistence=False
        )
        await cluster.start()
        fleet = None
        try:
            fleet = FleetProcHarness(
                [(ep.host, ep.port) for ep in cluster.endpoints()],
                n_gateways=2, n_shards=4,
                extras={"rf": 2},
            )
            ready = await asyncio.get_event_loop().run_in_executor(
                None, fleet.start
            )
            assert {r["name"] for r in ready} == {"gw0", "gw1"}
            owned = sorted(
                s for r in ready for s in r["owned_shards"]
            )
            assert owned == [0, 1, 2, 3]
            resolver = FleetResolver(fleet.ring())
            ser = Serializer()
            sess = FleetSession(ser, resolver, call_timeout=10.0)
            res = await sess.submit(
                0, [encode_set_bin("pr", "1")], timeout=30.0
            )
            assert res.status == ResultStatus.OK
            # SIGKILL the owner of shard 0; the survivor owns the world
            owner_name = fleet.ring().owner(0).name
            victim = int(owner_name.removeprefix("gw"))
            fleet.kill9(victim)
            # the operator move: push the shrunken membership to the
            # survivor so its MOVED answers stop naming the corpse
            await fleet.push_ring([1 - victim])
            res2 = await sess.submit(
                0, [encode_set_bin("pr", "2")], timeout=30.0
            )
            assert res2.status == ResultStatus.OK
            assert sess.failovers >= 1
            await sess.close()
        finally:
            if fleet is not None:
                fleet.stop()
            await cluster.stop()


# ---------------------------------------------------------------------------
# The port's repair: a dead connection fails fast (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


async def _one_request_gateway(mux: bool):
    """A stand-in gateway that acks the session hello, reads one more
    frame (the request) and then drops the connection, as a gateway
    killed mid-request does. Returns (server, port, got_request)."""
    from rabia_tpu_torch.core.messages import ClientHello, ProtocolMessage
    from rabia_tpu_torch.net.tcp import MUX_MAGIC

    ser = Serializer()
    gw_id = NodeId.from_int(4242)
    got_request = asyncio.Event()

    async def frame(reader):
        (ln,) = struct.unpack("<I", await reader.readexactly(4))
        data = await reader.readexactly(ln)
        return (data[:16], data[16:]) if mux else (b"", data)

    async def serve(reader, writer):
        hello = await reader.readexactly(16)
        assert (hello == MUX_MAGIC) == mux
        writer.write(gw_id.value.bytes)
        sid, data = await frame(reader)
        cid = ser.deserialize(data).payload.client_id
        ack = ser.serialize(ProtocolMessage.new(
            gw_id, ClientHello(client_id=cid, ack=True, max_inflight=64),
            NodeId(cid),
        ))
        writer.write(struct.pack("<I", len(sid) + len(ack)) + sid + ack)
        await frame(reader)
        got_request.set()
        writer.close()

    server = await asyncio.start_server(serve, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], got_request


class TestDeadConnectionsFailFast:
    """A connection whose gateway went away fails every request waiting
    on it, and refuses new ones, at once: the port's repair of the
    reference's testing/loadsession, where such a request waited out its
    whole call timeout (5 s a submit in the routed-failover chaos
    profile, whose tail then timed out under load)."""

    @pytest.mark.parametrize("mux", [True, False])
    @pytest.mark.asyncio
    async def test_peer_close_fails_waiting_request(self, mux):
        from rabia_tpu_torch.testing.loadsession import LoadSession, MuxConn

        server, port, got_request = await _one_request_gateway(mux)
        ser = Serializer()
        conn = None
        try:
            ls = LoadSession(ser)
            if mux:
                conn = await MuxConn(ser).connect("127.0.0.1", port)
                await ls.connect_mux(conn)
            else:
                await ls.connect("127.0.0.1", port)
            assert ls.alive
            sub = asyncio.ensure_future(
                ls.submit(0, [encode_set_bin("dead", "v")], 60.0)
            )
            await got_request.wait()
            # the peer closed: the waiting submit fails now, not at 60 s
            with pytest.raises(ConnectionError):
                await asyncio.wait_for(sub, 10.0)
            assert not ls.alive
            with pytest.raises(ConnectionError):
                await ls.submit(0, [encode_set_bin("dead", "w")], 60.0)
        finally:
            await ls.close()
            if conn is not None:
                await conn.close()
            server.close()
            await server.wait_closed()

    @pytest.mark.asyncio
    async def test_killed_gateway_fails_over_within_one_call(self):
        """Sessions on a pooled mux to a gateway that is then killed:
        the next submit fails over to the ring successor at once. With
        a call timeout longer than the whole deadline, a session that
        waited on the dead socket would time out instead."""
        h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
        await h.start()
        pool = FleetConnPool(h.ser)
        try:
            shard = 3
            owner_i, succ_i = await _owner_and_successor(h, shard)
            resolver = h.resolver()
            sessions = [
                FleetSession(h.ser, resolver, pool=pool, call_timeout=60.0)
                for _ in range(4)
            ]
            for i, s in enumerate(sessions):
                res = await s.submit(shard, [encode_set_bin(f"fo{i}", "a")])
                assert res.status == ResultStatus.OK
            dead = (h.gateways[owner_i].member().host,
                    h.gateways[owner_i].member().port)
            assert all(dead in s.conns for s in sessions)
            await h.kill_gateway(owner_i)
            got = await asyncio.gather(*(
                s.submit(shard, [encode_set_bin(f"fo{i}", "b")], timeout=20.0)
                for i, s in enumerate(sessions)
            ))
            assert [r.status for r in got] == [ResultStatus.OK] * 4
            assert all(s.failovers >= 1 for s in sessions)
            for s in sessions:
                await s.close()
        finally:
            await pool.close()
            await h.stop()


# ---------------------------------------------------------------------------
# Across packages: the port against the reference
# ---------------------------------------------------------------------------


def _fleet_pkg(name: str):
    """One package's fleet surface: ``port`` or ``reference``."""
    import importlib
    import types

    root = "rabia_tpu_torch" if name == "port" else "rabia_tpu"
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name,
        ring=mod("fleet.ring"),
        ledger=mod("fleet.ledger"),
        gateway_proc=mod("fleet.gateway_proc"),
        harness=mod("fleet.harness"),
        session=mod("gateway.session"),
        native_session=mod("gateway.native_session"),
        build=mod("native.build"),
        kvstore=mod("apps.kvstore"),
        messages=mod("core.messages"),
        serialization=mod("core.serialization"),
        types=mod("core.types"),
        cluster=mod("testing.gateway_cluster"),
    )


def _ring_of(pkg, names, vnodes: int = 16):
    ring = pkg.ring.HashRing(vnodes=vnodes)
    for i in names:
        ring.add(pkg.ring.RingMember(
            name=f"gw{i}", host="127.0.0.1", port=9000 + i,
            node=pkg.types.NodeId.from_int(2000 + i),
        ))
    return ring


class TestAcrossPackages:
    @pytest.mark.parametrize("vnodes", [1, 16, 64])
    def test_ring_documents_and_moved_shards_agree(self, vnodes):
        """The same members give the same membership document, owners,
        successors and moved shards in both packages, and each package
        reads the other's document."""
        port, ref = _fleet_pkg("port"), _fleet_pkg("reference")
        n = 4096
        for before, after in (([0, 1, 2], [0, 1]), ([0, 1], [0, 1, 2, 3]),
                              ([0, 1, 2, 3, 4], [1, 3, 4])):
            rings = {}
            for pkg in (port, ref):
                old, new = _ring_of(pkg, before, vnodes), _ring_of(pkg, after, vnodes)
                rings[pkg.name] = (
                    old.to_doc(), new.to_doc(),
                    pkg.ring.moved_shards(old, new, n),
                    [old.owner(s).name for s in range(n)],
                    [[m.name for m in old.successors(s, 3)] for s in range(0, n, 7)],
                )
            assert rings["port"] == rings["reference"]
            for src, dst in ((port, ref), (ref, port)):
                doc = _ring_of(src, before, vnodes).to_doc()
                back = dst.ring.HashRing.from_doc(doc)
                assert back.to_doc() == doc
                assert back.owned_shards("gw0", n) == (
                    _ring_of(src, before, vnodes).owned_shards("gw0", n)
                )

    @pytest.mark.parametrize("seed", [3, 20260816])
    def test_ledger_records_cross_apply(self, seed):
        """Ledger records encoded by one package decode in the other to
        the same bytes, and each package's ``apply_record`` lands them
        with the same ``submit_check`` decision, on the Python and the
        native session tables of both packages."""
        import random

        port, ref = _fleet_pkg("port"), _fleet_pkg("reference")
        rng = random.Random(seed)
        cids = [uuid.UUID(int=rng.getrandbits(128)) for _ in range(5)]
        recs = [
            (rng.choice(cids), rng.randrange(1, 40), rng.randrange(64),
             rng.choice([0, 0, 0, 1, 3]),
             tuple(rng.randbytes(rng.randrange(0, 24))
                   for _ in range(rng.randrange(0, 3))))
            for _ in range(300)
        ]
        # reservations and completions interleaved with the records
        pre = [(rng.choice(cids), rng.randrange(1, 40)) for _ in range(60)]
        for src, dst in ((port, ref), (ref, port)):
            blob = src.ledger.encode_records([
                src.ledger.LedgerRecord(
                    client_id=c, seq=q, shard=s, status=st, payload=p)
                for c, q, s, st, p in recs
            ])
            got = dst.ledger.decode_records(blob)
            assert dst.ledger.encode_records(got) == blob
            assert [(r.client_id, r.seq, r.shard, r.status, tuple(r.payload))
                    for r in got] == [(c, q, s, st, tuple(p))
                                      for c, q, s, st, p in recs]
        kw = dict(default_window=8, session_ttl=30.0, lease_ttl=120.0,
                  result_cache_cap=16)
        legs = {}
        for table_pkg in (port, ref):
            for apply_pkg in (port, ref):
                for native in (False, True):
                    if native:
                        table = table_pkg.native_session.NativeSessionTable(
                            table_pkg.build.load_sessionkernel(), **kw)
                    else:
                        table = table_pkg.session.SessionTable(**kw)
                    out = []
                    try:
                        for c, q in pre[:30]:
                            out.append(table.submit_check(c, q, 0, now=0.0)[0])
                        for i, (c, q, s, st, p) in enumerate(recs):
                            out.append(apply_pkg.ledger.apply_record(
                                table, c, q, st, p, i + 1, now=0.1))
                            if i % 10 == 0:
                                c2, q2 = pre[30 + i // 10]
                                out.append(table.submit_check(c2, q2, 0, now=0.2)[0])
                        out.append(sorted(
                            (str(c), q, tuple(table.cached_result(c, q).payload))
                            for c, q, *_ in recs
                            if table.cached_result(c, q) is not None
                        ))
                    finally:
                        if native:
                            table.close()
                    legs[(table_pkg.name, apply_pkg.name, native)] = out
        want = legs[("reference", "reference", False)]
        for leg, got in legs.items():
            assert got == want, leg

    @pytest.mark.parametrize("fleet_name,cluster_name",
                             [("port", "reference"), ("reference", "port")])
    @pytest.mark.asyncio
    async def test_fleet_gateway_over_other_package_cluster(
        self, fleet_name, cluster_name
    ):
        """A fleet gateway tier of one package in front of the other
        package's replica cluster: a submit with a wrong ring view is
        answered MOVED and commits on the owner, its replay answers
        CACHED with the same bytes, and no replica applies it twice."""
        fp, cp = _fleet_pkg(fleet_name), _fleet_pkg(cluster_name)
        cluster = cp.cluster.GatewayCluster(n_replicas=3, n_shards=4,
                                            persistence=False)
        await cluster.start()
        gws = []
        sess = None
        try:
            ups = tuple((ep.host, ep.port) for ep in cluster.endpoints())
            gws = [
                fp.gateway_proc.FleetGateway(
                    fp.gateway_proc.FleetGatewayConfig(
                        name=f"gw{i}", upstreams=ups, n_shards=4),
                    node_id=fp.types.NodeId.from_int(2000 + i),
                )
                for i in range(2)
            ]
            for g in gws:
                await g.start()
            ring = fp.ring.HashRing()
            for g in gws:
                ring.add(g.member())
            for g in gws:
                g.adopt_ring(ring.copy())
            shard = 1
            owner = ring.owner(shard).name
            wrong = next(g for g in gws if g.config.name != owner)
            resolver = fp.harness.FleetResolver(ring.copy())
            resolver.note_moved(shard, ("127.0.0.1", wrong.port))
            ser = fp.serialization.Serializer()
            sess = fp.harness.FleetSession(ser, resolver, call_timeout=10.0)
            cmd = fp.kvstore.encode_set_bin("xpkg", "v1")
            res = await sess.submit(shard, [cmd])
            RS = fp.messages.ResultStatus
            assert res.status == RS.OK
            assert sess.redirects == 1 and wrong.stats.moved == 1
            assert fp.kvstore.decode_kv_response(res.payload[0]).ok
            await cluster.wait_converged(10)
            vers = [cluster.store(r, shard).version for r in range(3)]
            assert vers == [1, 1, 1]
            replay = await sess.submit_seq(res.seq, shard, [cmd])
            assert replay.status == RS.CACHED
            assert tuple(bytes(p) for p in replay.payload) == tuple(
                bytes(p) for p in res.payload)
            await asyncio.sleep(0.3)
            assert [cluster.store(r, shard).version for r in range(3)] == vers
            v = cluster.store(0, shard).get("xpkg")
            assert getattr(v, "value", v) == "v1"
        finally:
            if sess is not None:
                await sess.close()
            for g in gws:
                await g.close()
            await cluster.stop()


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


class TestPhase14Small:
    """chip_smoke.py's phase 14 on the CPU at 3 fleet gateways over 3
    replicas x 32 shards: 8 FleetSessions through one connection pool,
    waves of one SET a shard, the ring dropping a member (between two
    waves, or a third of the way into one) and gateway 0 killed (in the
    last wave); every (client, seq) replayed CACHED with no new slot;
    every key read by ReadIndex through the fleet from a gateway over a
    CPU ``MeshEngine`` device table, equal to a replica's store and to
    the last acknowledged write."""

    @pytest.mark.parametrize("waves", [1, 2])
    @pytest.mark.asyncio
    async def test_routed_fleet_small(self, waves):
        chip_smoke = _chip_smoke()
        st = await chip_smoke.fleet_run("cpu", S=32, R=3, waves=waves, sessions=8,
                                        n_gateways=3)
        mesh = st.pop("_mesh")
        assert mesh.device.type == "cpu" and mesh.device_lane_active
        assert st["acked_writes"] == waves * 32
        assert st["replayed_from_cache"] == waves * 32
        assert st["reads_equal"] == 32
        assert st["moved_redirects"] > 0 and st["failovers"] > 0
        assert st["fleet_stats"]["ledger_sent"] > 0
        assert st["fleet_stats"]["handoff_out_sessions"] > 0
        assert st["probe_rounds"] > 0 and st["reads_batched"] > 0
        assert st["critpath"]["decomposed"] > 0
        table = st["fleet_table"]
        assert "gw1" in table and "stale members: gw0" in table


class TestPhase15LaneCycleSmall:
    """chip_smoke.py's phase 15 lane cycle on the CPU at 3 replicas x 16
    shards: the mesh fabric's forced demotion, arrivals until the lane
    re-promotes, probe reads after it, and the verify sweep."""

    @pytest.mark.asyncio
    async def test_mesh_lane_cycle_small(self):
        chip_smoke = _chip_smoke()
        st = await chip_smoke._mesh_lane_cycle("cpu", 16, 3)
        assert st["forced_demotions"] == 1 and st["lane_promotions"] >= 1
        assert st["demoted_arrivals"] >= 1 and st["divergences"] == 0
        assert st["read_lane"]["probe"] > 0 and st["device"] == "cpu"
