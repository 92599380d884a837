"""The port's client gateway (``rabia_tpu_torch/gateway/`` over the port's
``native/sessionkernel.cpp``).

The port's copy of the reference's tests/test_gateway.py: exactly-once
sessions, linearizable read-index reads, admission control, reconnect
replay, and a chaos run with a replica restart — all over real TCP
sockets via the native transport. Then the cross-package checks
(``TestAcrossPackages``): the port's native and Python session tables
and the reference's on ``random_gateway_ops(seed)``, op for op; the
reference's ``RabiaClient`` against the port's ``GatewayServer`` and the
reverse (one wire codec); ``devkv_read_handler`` over a CPU
``MeshEngine(device_store=True)`` against ``kv_read_handler``, byte for
byte, and over a 2 x 4 logical mesh engine against one device's; and
chip_smoke.py's phase 13 (a) at 3 replicas × 8 shards.
"""

from __future__ import annotations

import asyncio
import uuid

import pytest

from rabia_tpu_torch.apps.kvstore import (
    KVResultKind,
    decode_kv_response,
    encode_set_bin,
    shard_for_key,
)
from rabia_tpu_torch.core.messages import (
    ClientHello,
    ReadIndex,
    ReadIndexMode,
    Result,
    ResultStatus,
    Submit,
)
from rabia_tpu_torch.gateway import (
    BackpressureError,
    GatewayConfig,
    RabiaClient,
    SessionTable,
)
from rabia_tpu_torch.gateway.session import CachedResult
from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

SHARDS = 4


def _shard(key: str) -> int:
    return shard_for_key(key, SHARDS)


def _decided_total(cluster) -> int:
    return sum(
        e.rt.decided_v0 + e.rt.decided_v1 for e in cluster.engines
    )


def _decided_v1_total(cluster) -> int:
    """Committed (V1) slots only — the signal for "did anything new get
    proposed and applied": background forwarding-timeout noise can open
    null (V0) slots at any time, which carry no writes."""
    return sum(e.rt.decided_v1 for e in cluster.engines)


async def _settled_v1_total(cluster) -> int:
    """:func:`_decided_v1_total` once every replica has recorded the same
    V1 decisions: a submitter's future settles on its replica first, and
    a peer recording the decision later is no second proposal."""
    for _ in range(1000):
        if len({e.rt.decided_v1 for e in cluster.engines}) == 1:
            break
        await asyncio.sleep(0.01)
    return _decided_v1_total(cluster)


async def _spin_up(**kw) -> GatewayCluster:
    cluster = GatewayCluster(n_replicas=3, n_shards=SHARDS, **kw)
    await cluster.start()
    return cluster


class TestSessionTable:
    def test_gc_requires_ack_and_frontier_advance(self):
        t = SessionTable(session_ttl=1e9)
        cid = uuid.uuid4()
        sess = t.ensure(cid)
        sess.complete(1, CachedResult(0, (b"r",), frontier_mark=10))
        sess.complete(2, CachedResult(0, (b"r2",), frontier_mark=11))
        # unacked: nothing evicts however far the frontier moves
        assert t.gc(state_version=100) == 0
        sess.ack_upto = 1
        # acked but frontier NOT past the mark: stays
        assert t.gc(state_version=10) == 0
        # acked AND frontier advanced: evicted
        assert t.gc(state_version=11) == 1
        assert 1 not in sess.results and 2 in sess.results

    def test_window_grant_capped_by_gateway(self):
        t = SessionTable(default_window=8)
        assert t.ensure(uuid.uuid4(), 0).window == 8
        assert t.ensure(uuid.uuid4(), 4).window == 4
        assert t.ensure(uuid.uuid4(), 99).window == 8
        # renegotiable on resume (downward only)
        cid = uuid.uuid4()
        assert t.ensure(cid, 0).window == 8
        assert t.ensure(cid, 2).window == 2
        assert t.ensure(cid, 99).window == 8

    def test_deterministic_batch_ids(self):
        """A replayed Submit yields a byte-identical batch with the SAME
        id — the engine's dedup ledger then blocks double-applies even
        when the gateway's session state was lost."""
        from rabia_tpu_torch.gateway.server import GatewayServer

        cid = uuid.uuid4()
        mk = lambda seq: Submit(  # noqa: E731
            client_id=cid, seq=seq, shard=1, commands=(b"a", b"bb")
        )
        b1 = GatewayServer._deterministic_batch(mk(3))
        b2 = GatewayServer._deterministic_batch(mk(3))
        b3 = GatewayServer._deterministic_batch(mk(4))
        assert b1.id == b2.id
        assert b1.checksum() == b2.checksum()  # command ids match too
        assert b3.id != b1.id

    def test_idle_session_expiry_spares_inflight_until_lease(self):
        t = SessionTable(session_ttl=10.0, lease_ttl=100.0)
        busy = t.ensure(uuid.uuid4())
        busy.inflight[1] = object()
        idle = t.ensure(uuid.uuid4())
        idle.last_active = busy.last_active = 0.0
        # past the idle ttl but inside the lease: inflight spares it
        t.gc(state_version=0, now=50.0)
        assert busy.client_id in t.sessions
        assert idle.client_id not in t.sessions
        # past the HARD lease: dropped even with inflight seqs — a
        # stalled frontier / wedged engine cannot pin dead sessions
        t.gc(state_version=0, now=200.0)
        assert busy.client_id not in t.sessions
        assert t.stats.leases_expired == 1
        assert t.stats.sessions_expired == 2


class TestGatewayEndToEnd:
    @pytest.mark.asyncio
    async def test_concurrent_clients_exactly_once_and_linearizable(self):
        """The acceptance run: 8 concurrent clients over real TCP against
        a 3-replica cluster — every write exactly-once in the applied
        state machines, reads linearizable against the host-store oracle,
        and the read phase consuming zero consensus slots."""
        cluster = await _spin_up()
        clients = []
        try:
            clients = [
                RabiaClient(
                    [cluster.endpoint(i % 3)], call_timeout=30.0
                )
                for i in range(8)
            ]
            for c in clients:
                await c.connect()

            async def writer(ci: int, c: RabiaClient):
                for k in range(6):
                    key = f"c{ci}-k{k}"
                    resp = await c.submit(
                        _shard(key), [encode_set_bin(key, f"v{ci}.{k}")]
                    )
                    r = decode_kv_response(resp[0])
                    assert r.ok, r

            await asyncio.gather(
                *(writer(i, c) for i, c in enumerate(clients))
            )

            # exactly-once: every key present exactly as written, on
            # every replica, and replicas converge
            await cluster.wait_converged()
            for ci in range(8):
                for k in range(6):
                    key = f"c{ci}-k{k}"
                    for r in range(3):
                        res = cluster.store(r, _shard(key)).get(key)
                        assert res.value == f"v{ci}.{k}"

            # read phase: linearizable reads, zero consensus slots (let
            # the write phase's in-flight slots fully settle first)
            await asyncio.sleep(0.3)
            decided_before = _decided_total(cluster)
            for ci, c in enumerate(clients):
                key = f"c{ci}-k0"
                raw = await c.get(_shard(key), key)
                r = decode_kv_response(raw)
                assert r.ok and r.value == f"v{ci}.0"
            # oracle: the read value matches the host store directly
            assert _decided_total(cluster) == decided_before, (
                "reads consumed consensus slots"
            )
        finally:
            for c in clients:
                await c.close()
            await cluster.stop()

    @pytest.mark.asyncio
    async def test_linearizable_reads_see_acked_writes(self):
        """A reader on gateway B must observe every write a writer on
        gateway A has already been acked for (quorum-probed read index)."""
        cluster = await _spin_up()
        writer = reader = None
        try:
            writer = RabiaClient([cluster.endpoint(0)], call_timeout=30.0)
            reader = RabiaClient([cluster.endpoint(1)], call_timeout=30.0)
            await writer.connect()
            await reader.connect()
            key = "lin-key"
            shard = _shard(key)
            acked = 0
            for v in range(1, 16):
                await writer.submit(
                    shard, [encode_set_bin(key, str(v))]
                )
                acked = v  # write v is acked BEFORE the read below issues
                floor = acked
                raw = await reader.get(shard, key)
                r = decode_kv_response(raw)
                assert r.ok
                assert int(r.value) >= floor, (
                    f"read saw {r.value}, but {floor} was already acked"
                )
        finally:
            for c in (writer, reader):
                if c is not None:
                    await c.close()
            await cluster.stop()


class TestGatewayFailurePaths:
    @pytest.mark.asyncio
    async def test_duplicate_submit_returns_cached_no_second_proposal(self):
        cluster = await _spin_up()
        cli = None
        try:
            cli = RabiaClient([cluster.endpoint(0)], call_timeout=30.0)
            await cli.connect()
            key = "dup-key"
            shard = _shard(key)
            resp = await cli.submit(shard, [encode_set_bin(key, "once")])
            assert decode_kv_response(resp[0]).ok
            store = cluster.store(0, shard)
            version_after_first = store.version
            gw = cluster.gateways[0]
            decided_before = await _settled_v1_total(cluster)

            # replay the SAME (client_id, seq) — a client retry after a
            # lost Result
            dup = Submit(
                client_id=cli.client_id,
                seq=cli._seq,
                shard=shard,
                commands=(encode_set_bin(key, "once"),),
                ack_upto=0,
            )
            res = await cli._call(cli._seq, dup)
            assert res.status == ResultStatus.CACHED
            assert res.payload == tuple(resp)
            assert gw.stats.submits_deduped == 1
            # no second apply, no new committed slot for the dup
            assert store.version == version_after_first
            await asyncio.sleep(0.2)
            assert _decided_v1_total(cluster) == decided_before
        finally:
            if cli is not None:
                await cli.close()
            await cluster.stop()

    @pytest.mark.asyncio
    async def test_reconnect_mid_command_replays_seq_without_double_apply(
        self,
    ):
        """Drop the first Result on the floor (lost on the wire) and kill
        the client's link: the client reconnects, replays the seq, and
        the session cache answers — one apply, one version bump."""
        cluster = await _spin_up()
        cli = None
        try:
            cli = RabiaClient(
                [cluster.endpoint(0)],
                call_timeout=30.0,
                retry_interval=0.3,
            )
            await cli.connect()
            gw = cluster.gateways[0]
            key = "replay-key"
            shard = _shard(key)

            # swallow the FIRST result the gateway sends for seq 1, and
            # sever the client's link at the same moment
            orig = gw._send_result
            dropped = []

            def dropping(recipient, client_id, seq, status, payload):
                if seq == 1 and not dropped:
                    dropped.append(seq)
                    return  # lost on the wire
                orig(recipient, client_id, seq, status, payload)

            gw._send_result = dropping
            submit_task = asyncio.ensure_future(
                cli.submit(shard, [encode_set_bin(key, "exactly-once")])
            )
            # wait until the command actually committed gateway-side
            sess = None
            for _ in range(400):
                await asyncio.sleep(0.01)
                sess = gw.sessions.get(cli.client_id)
                if sess is not None and 1 in sess.results:
                    break
            assert sess is not None and 1 in sess.results
            store = cluster.store(0, shard)
            version_after_commit = store.version

            # sever the link mid-command (the Result was "lost"): the
            # client's retry cycle reconnects and replays seq 1
            await cli._net.close()
            resp = await asyncio.wait_for(submit_task, 30.0)
            assert decode_kv_response(resp[0]).ok
            assert cli.reconnects >= 1
            assert cli.cached_replies >= 1  # answered from session cache
            assert gw.stats.submits_deduped >= 1
            assert store.version == version_after_commit  # single apply
        finally:
            if cli is not None:
                await cli.close()
            await cluster.stop()

    @pytest.mark.asyncio
    async def test_replay_after_session_loss_does_not_double_apply(self):
        """Even when the gateway's session state is wiped (restart /
        cache eviction), a replayed (client_id, seq) re-proposes under
        the SAME deterministic batch id and the ENGINE's dedup ledger
        blocks the second apply."""
        cluster = await _spin_up()
        cli = None
        try:
            cli = RabiaClient([cluster.endpoint(0)], call_timeout=30.0)
            await cli.connect()
            key = "wipe-key"
            shard = _shard(key)
            resp = await cli.submit(shard, [encode_set_bin(key, "once")])
            assert decode_kv_response(resp[0]).ok
            store = cluster.store(0, shard)
            version_after_first = store.version

            # simulate total session-state loss at the gateway
            cluster.gateways[0].sessions.sessions.clear()
            dup = Submit(
                client_id=cli.client_id,
                seq=cli._seq,
                shard=shard,
                commands=(encode_set_bin(key, "once"),),
            )
            res = await cli._call(cli._seq, dup)
            # the replay re-proposes (no cache) but the engine dedups the
            # apply and answers from its response cache
            assert res.status in (ResultStatus.OK, ResultStatus.CACHED)
            assert store.version == version_after_first  # single apply
        finally:
            if cli is not None:
                await cli.close()
            await cluster.stop()

    @pytest.mark.asyncio
    async def test_backpressure_rejection_is_retryable(self):
        cluster = await _spin_up(
            gateway_config=GatewayConfig(max_queue_depth=0)
        )
        cli = None
        try:
            cli = RabiaClient(
                [cluster.endpoint(0)],
                call_timeout=10.0,
                retry_backpressure=False,
            )
            await cli.connect()
            with pytest.raises(BackpressureError) as ei:
                await cli.submit(0, [encode_set_bin("k", "v")])
            # the contract: a retryable StoreError, shed BEFORE consensus
            assert ei.value.is_retryable()
            assert ei.value.kind.recoverable
            assert cluster.gateways[0].stats.submits_shed >= 1
            # nothing was proposed
            assert cluster.store(0, 0).version == 0
        finally:
            if cli is not None:
                await cli.close()
            await cluster.stop()

    @pytest.mark.asyncio
    async def test_session_window_sheds_excess_inflight(self):
        cluster = await _spin_up(
            gateway_config=GatewayConfig(max_inflight_per_session=1)
        )
        cli = None
        try:
            cli = RabiaClient(
                [cluster.endpoint(0)],
                call_timeout=10.0,
                retry_backpressure=True,
            )
            await cli.connect()
            assert cli.server_window == 1
            # a burst over the window: all eventually commit via client
            # backoff, and at least one got shed on the way
            keys = [f"w{i}" for i in range(6)]
            await asyncio.gather(
                *(
                    cli.submit(_shard(k), [encode_set_bin(k, "x")])
                    for k in keys
                )
            )
            assert cluster.gateways[0].stats.submits_shed >= 1
            for k in keys:
                assert cluster.store(0, _shard(k)).get(k).value == "x"
        finally:
            if cli is not None:
                await cli.close()
            await cluster.stop()


class TestGatewayChaos:
    @pytest.mark.asyncio
    async def test_replica_restart_with_live_clients(self):
        """One replica restarts (recovering from its persistence layer)
        while clients stay connected to the other two gateways and keep
        writing; every write lands exactly once and the restarted replica
        converges back to full agreement."""
        cluster = await _spin_up()
        clients = []
        try:
            clients = [
                RabiaClient([cluster.endpoint(1 + (i % 2))],
                            call_timeout=45.0)
                for i in range(4)
            ]
            for c in clients:
                await c.connect()
            written: list[str] = []
            stop = asyncio.Event()

            async def writer(ci: int, c: RabiaClient):
                k = 0
                while not stop.is_set():
                    key = f"chaos-c{ci}-{k}"
                    resp = await c.submit(
                        _shard(key), [encode_set_bin(key, f"v{k}")]
                    )
                    r = decode_kv_response(resp[0])
                    assert r.ok, r
                    written.append((key, r.version))
                    k += 1
                    await asyncio.sleep(0.01)

            writers = [
                asyncio.ensure_future(writer(i, c))
                for i, c in enumerate(clients)
            ]
            await asyncio.sleep(0.5)
            await cluster.restart_replica(0)
            await asyncio.sleep(1.0)
            stop.set()
            await asyncio.gather(*writers)
            assert len(written) > 0
            # the restarted replica syncs back to full agreement...
            await cluster.wait_converged(timeout=60.0)
            # ...and every acked write is present (on every replica, by
            # convergence — spot-check a survivor)
            for key, ver in written:
                res = cluster.store(1, _shard(key)).get(key)
                assert res.kind == KVResultKind.Success, (
                    key,
                    ver,
                    [
                        (r, cluster.store(r, _shard(key)).get(key))
                        for r in range(3)
                    ],
                    [
                        (g.stats.results_repaired, g.stats.submits_deduped)
                        for g in cluster.gateways
                    ],
                )
        finally:
            for c in clients:
                await c.close()
            await cluster.stop()


class TestGatewayObservability:
    @pytest.mark.asyncio
    async def test_metrics_and_healthz_from_live_tcp_cluster(self):
        """Acceptance gate of the observability plane: a 3-replica TCP
        cluster serves Prometheus-text /metrics (with nonzero native-tick
        counters when the native path is live) and /healthz reflecting
        decided/applied frontiers — over BOTH surfaces: framed admin
        requests on the gateway's native transport and the stdlib HTTP
        shim."""
        import json
        import urllib.request

        from rabia_tpu_torch.core.messages import AdminKind
        from rabia_tpu_torch.gateway import admin_fetch

        cluster = await _spin_up(
            gateway_config=GatewayConfig(http_port=0)
        )
        try:
            client = RabiaClient(cluster.endpoints())
            await client.connect()
            writes = 6
            for i in range(writes):
                key = f"obs{i}"
                await client.submit(
                    _shard(key), [encode_set_bin(key, f"v{i}")]
                )
            # read once so the read-index counters move too
            await client.get(_shard("obs0"), "obs0")
            await client.close()

            # -- framed admin surface (native transport) ----------------
            ep = cluster.endpoint(0)
            text = (
                await admin_fetch(ep.host, ep.port, int(AdminKind.METRICS))
            ).decode()
            assert text.endswith("\n")
            lines = [
                ln for ln in text.splitlines()
                if ln and not ln.startswith("#")
            ]
            # well-formed exposition: every sample line is "name value"
            for ln in lines:
                name, _, value = ln.rpartition(" ")
                assert name and float(value) is not None, ln
            sample = {
                ln.rpartition(" ")[0]: float(ln.rpartition(" ")[2])
                for ln in lines
            }
            assert sample['rabia_engine_decided_total{value="v1"}'] >= writes
            assert sample["rabia_gateway_submits_total"] >= writes
            assert sample["rabia_gateway_reads_total"] >= 1
            assert sample["rabia_engine_has_quorum"] == 1
            if cluster.engines[0]._rk is not None:
                # native tick live: the rk counter block must be nonzero
                # through the shared tick metric names
                frames = sum(
                    sample[f'rabia_tick_frames_total{{kind="{k}"}}']
                    for k in ("vote1", "vote2", "decision")
                )
                assert frames > 0
                assert sample["rabia_tick_native_out_frames_total"] > 0
            health = json.loads(
                await admin_fetch(ep.host, ep.port, int(AdminKind.HEALTH))
            )
            assert health["status"] == "ok" and health["has_quorum"]
            assert sum(health["applied_frontier"]) >= writes
            assert (
                sum(health["decided_frontier"])
                >= sum(health["applied_frontier"])
            )
            journal = json.loads(
                await admin_fetch(ep.host, ep.port, int(AdminKind.JOURNAL))
            )
            assert isinstance(journal["anomalies"], list)

            # -- HTTP shim ----------------------------------------------
            port = cluster.gateways[0].http_port
            assert port > 0
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5
            ) as r:
                http_text = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
            assert 'rabia_engine_decided_total{value="v1"}' in http_text
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5
            ) as r:
                assert json.loads(r.read())["status"] == "ok"
        finally:
            await cluster.stop()


class TestGatewayProtocolFrames:
    def test_frame_roundtrips(self):
        """Envelope round-trip of all four client frame kinds through the
        default serializer (native codec when available, Python always)."""
        from rabia_tpu_torch.core.serialization import BinarySerializer
        from rabia_tpu_torch.core.messages import ProtocolMessage
        from rabia_tpu_torch.core.types import NodeId

        from rabia_tpu_torch.core.messages import AdminRequest, AdminResponse

        cid = uuid.uuid4()
        frames = [
            ClientHello(client_id=cid, ack=True, last_seq=7,
                        max_inflight=32),
            Submit(client_id=cid, seq=9, shard=2,
                   commands=(b"\x01\x01\x00kv", b""), ack_upto=4),
            Result(client_id=cid, seq=9, status=int(ResultStatus.CACHED),
                   payload=(b"resp",)),
            ReadIndex(mode=int(ReadIndexMode.REPLY), client_id=cid,
                      seq=3, frontier=(5, 0, 12)),
            AdminRequest(kind=1, nonce=42),
            AdminRequest(kind=3, nonce=43,
                         query=b'{"client": "00ff", "seq": 2}'),
            AdminResponse(nonce=42, status=0, body=b"# TYPE x counter\n"),
        ]
        s = BinarySerializer()
        for p in frames:
            msg = ProtocolMessage.new(NodeId.from_int(1), p)
            wire = s.serialize(msg)
            # python and native agree byte-for-byte and on decode
            assert wire == s._serialize_py(msg)
            assert s._deserialize_py(wire).payload == p
            assert s.deserialize(wire).payload == p

        # pre-trace AdminRequest bodies (no trailing query blob) still
        # decode — the query field is a wire-compatible append
        import struct

        from rabia_tpu_torch.core.messages import MessageType
        from rabia_tpu_torch.core.serialization import _decode_payload, _Reader

        legacy_body = bytes([1]) + struct.pack("<Q", 42)
        decoded = _decode_payload(MessageType.AdminRequest, _Reader(legacy_body))
        assert decoded == AdminRequest(kind=1, nonce=42, query=b"")


# ---------------------------------------------------------------------------
# native gateway session plane (sessionkernel.cpp)
# ---------------------------------------------------------------------------


def _session_tables():
    """Both tables under test, same knobs; [] when the kernel is
    unavailable (the native id then simply doesn't parametrize)."""
    from rabia_tpu_torch.gateway.native_session import NativeSessionTable
    from rabia_tpu_torch.gateway.session import SessionTable
    from rabia_tpu_torch.native.build import load_sessionkernel

    kw = dict(
        default_window=4, session_ttl=10.0, lease_ttl=60.0,
        result_cache_cap=3,
    )
    out = [("python", lambda: SessionTable(**kw))]
    lib = load_sessionkernel()
    if lib is not None:
        out.append(("native", lambda: NativeSessionTable(lib, **kw)))
    return out


class TestNativeSessionPlane:
    def test_kernel_available(self):
        """The container bakes a toolchain: a silent sessionkernel build
        failure must fail HERE, not demote every gateway to Python."""
        import os

        from rabia_tpu_torch.native.build import load_sessionkernel

        if os.environ.get("RABIA_PY_GATEWAY") == "1":
            pytest.skip("RABIA_PY_GATEWAY=1 forces the Python table")
        lib = load_sessionkernel()
        assert lib is not None
        assert lib.gws_counters_version() == 1
        from rabia_tpu_torch.gateway.native_session import GWC_COUNTER_NAMES

        assert lib.gws_counters_count() == len(GWC_COUNTER_NAMES)

    @pytest.mark.parametrize(
        "name,mk", _session_tables(), ids=[n for n, _ in _session_tables()]
    )
    def test_gc_under_frontier_stall(self, name, mk):
        """Regression (the lease satellite): a STALLED frontier — no
        quorum, state_version pinned — must not pin dead sessions. The
        idle ttl reaps sessions without inflight; the hard lease reaps
        even sessions wedged with inflight seqs; the cached results go
        with them."""
        t = mk()
        wedged, idle = uuid.uuid4(), uuid.uuid4()
        assert t.submit_check(wedged, 1, 0, now=0.0)[0] == 0
        t.complete_op(wedged, 1, 0, (b"r1",), 5, now=0.0)
        assert t.submit_check(wedged, 2, 0, now=0.0)[0] == 0  # stays wedged
        t.hello(idle, 0, now=0.0)
        # frontier NEVER advances (state_version 0 throughout)
        assert t.gc(0, now=1.0) == 0
        assert len(t) == 2
        # past the idle ttl: the inflight-free session goes, the wedged
        # one survives (its seq may still complete)
        t.gc(0, now=11.0)
        assert t.get(idle) is None and t.get(wedged) is not None
        # past the hard lease: the wedged session goes too, cached
        # results and all — nothing is pinned by the stalled frontier
        evicted = t.gc(0, now=61.1)
        assert evicted >= 1
        assert len(t) == 0
        assert t.stats.leases_expired == 1
        assert t.stats.sessions_expired == 2

    @pytest.mark.parametrize(
        "name,mk", _session_tables(), ids=[n for n, _ in _session_tables()]
    )
    def test_cache_cap_evicts_lowest_seqs(self, name, mk):
        t = mk()
        cid = uuid.uuid4()
        for seq in range(1, 6):
            assert t.submit_check(cid, seq, 0, now=0.0)[0] == 0
            t.complete_op(cid, seq, 0, (b"p%d" % seq,), 1, now=0.0)
        assert t.gc(0, now=0.1) == 2  # cap 3: seqs 1-2 evicted
        assert t.cached_result(cid, 1) is None
        assert t.cached_result(cid, 3).payload == (b"p3",)
        assert t.cached_result(cid, 5).payload == (b"p5",)

    def test_fixed_conformance_schedule(self):
        """Deterministic branch-cover schedule through the shared gate
        (same code path as fuzz --gateway, so the checks cannot
        drift)."""
        from rabia_tpu_torch.testing.conformance import (
            run_gateway_ops_on_both_tables,
        )

        cid1, cid2 = uuid.UUID(int=1), uuid.UUID(int=2)
        ops = [
            {"op": "hello", "t": 0.0, "cid": cid1, "window": 99},
            {"op": "hello", "t": 0.0, "cid": cid2, "window": 2},
            {"op": "submit", "t": 0.1, "cid": cid1, "seq": 1},
            {"op": "submit", "t": 0.1, "cid": cid1, "seq": 1},  # inflight dup
            {"op": "complete", "t": 0.2, "cid": cid1, "seq": 1,
             "status": 0, "payload": (b"ok", b""), "frontier": 1},
            {"op": "submit", "t": 0.3, "cid": cid1, "seq": 1},  # cached dup
            {"op": "submit", "t": 0.3, "cid": cid2, "seq": 1},
            {"op": "submit", "t": 0.3, "cid": cid2, "seq": 2},
            {"op": "submit", "t": 0.3, "cid": cid2, "seq": 3},  # window shed
            {"op": "abort", "t": 0.4, "cid": cid2, "seq": 2},
            {"op": "complete", "t": 0.5, "cid": cid2, "seq": 9,
             "status": 2, "payload": (), "frontier": 2},  # error, empty
            {"op": "submit", "t": 0.6, "cid": cid1, "seq": 2, "ack": 1},
            # fleet ledger records (reserve+complete in one step): a
            # fresh landing, a landing onto the existing reservation
            # (cid1 seq 2 is inflight), and a no-op onto a cached seq
            {"op": "ledger", "t": 0.65, "cid": cid2, "seq": 4,
             "status": 0, "payload": (b"led",), "frontier": 3},
            {"op": "ledger", "t": 0.65, "cid": cid1, "seq": 2,
             "status": 0, "payload": (b"r2",), "frontier": 3},
            {"op": "ledger", "t": 0.66, "cid": cid1, "seq": 2,
             "status": 1, "payload": (b"loser",), "frontier": 4},
            {"op": "submit", "t": 0.67, "cid": cid1, "seq": 2},  # cached
            {"op": "gc", "t": 0.7, "sv": 5},   # evicts cid1 seq 1
            {"op": "gc", "t": 20.0, "sv": 5},  # idle expiry (ttl 30 no)
            {"op": "gc", "t": 200.0, "sv": 5},  # lease: everything goes
        ]
        run_gateway_ops_on_both_tables(ops, tag="fixed-schedule")

    def test_random_conformance_schedules(self):
        from rabia_tpu_torch.testing.conformance import (
            random_gateway_ops,
            run_gateway_ops_on_both_tables,
        )

        for seed in range(6):
            run_gateway_ops_on_both_tables(
                random_gateway_ops(seed), tag=f"seed={seed}"
            )

    def test_payload_blob_roundtrip(self):
        from rabia_tpu_torch.gateway.native_session import (
            pack_payload,
            unpack_payload,
        )

        for payload in ((), (b"",), (b"a", b"", b"\x00" * 300), (b"x",) * 9):
            assert unpack_payload(pack_payload(payload)) == payload
        # memoryviews pack like bytes (the apply plane's lazy views)
        assert unpack_payload(
            pack_payload((memoryview(b"abc"), b"d"))
        ) == (b"abc", b"d")


class TestGatewayMux:
    @pytest.mark.asyncio
    async def test_sessions_multiplexed_over_one_connection(self):
        """The C transport's session-mux lane end-to-end: several
        protocol-faithful sessions over ONE socket against a live
        gateway — submits commit, replies demultiplex to the right
        session, and the dedup cache answers a replay with CACHED."""
        # the port's load sessions (the reference's benchmarks/loadgen.py
        # re-exports the reference's copy of this module)
        from rabia_tpu_torch.core.serialization import Serializer
        from rabia_tpu_torch.testing import loadsession as lg

        cluster = await _spin_up()
        conn = None
        try:
            ser = Serializer()
            conn = await lg.MuxConn(ser).connect(
                "127.0.0.1", cluster.gateways[0].port
            )
            sessions = [
                await lg.LoadSession(ser).connect_mux(conn)
                for _ in range(5)
            ]
            assert len(conn.sessions) == 5
            for i, s in enumerate(sessions):
                key = f"mux-{i}"
                res = await s.submit(
                    _shard(key), [encode_set_bin(key, f"v{i}")], 10.0
                )
                assert res.status == ResultStatus.OK
                assert res.client_id == s.client_id
            # replay the last seq on session 0: answered from the
            # session cache, routed back over the same muxed socket
            s0 = sessions[0]
            s0._seq -= 1
            res = await s0.submit(
                _shard("mux-0"), [encode_set_bin("mux-0", "v0")], 10.0
            )
            assert res.status == ResultStatus.CACHED
            for i in range(5):
                assert (
                    cluster.store(0, _shard(f"mux-{i}")).get(f"mux-{i}").value
                    == f"v{i}"
                )
            for s in sessions:
                await s.close()
        finally:
            if conn is not None:
                await conn.close()
            await cluster.stop()

    @pytest.mark.asyncio
    async def test_rabia_client_mux_lane_with_redial_rebinding(self):
        """RabiaClient's opt-in mux lane (``mux=True``): the full client
        library — exactly-once seqs, retry machinery, reconnect replay —
        over one multiplexed socket instead of a private native
        transport. A killed connection must redial transparently, the
        session REBINDS to the new socket (transport latest-binding-wins)
        and a replayed seq answers from the dedup cache without a second
        apply."""
        cluster = await _spin_up()
        cli = None
        try:
            cli = RabiaClient(
                [cluster.endpoint(0)], mux=True, call_timeout=20.0
            )
            await cli.connect()
            assert isinstance(cli._net.writer, asyncio.StreamWriter)
            for k in range(6):
                key = f"cmux-{k}"
                resp = await cli.submit(
                    _shard(key), [encode_set_bin(key, f"v{k}")]
                )
                assert decode_kv_response(resp[0]).ok
            v1_before = _decided_v1_total(cluster)
            # kill the muxed socket under the client: the next call must
            # redial, rebind the session, and still be exactly-once
            cli._net.writer.close()
            resp = await cli.submit(
                _shard("cmux-re"), [encode_set_bin("cmux-re", "after")]
            )
            assert decode_kv_response(resp[0]).ok
            assert cli.reconnects >= 1
            # duplicate of an already-committed seq: served CACHED over
            # the REBOUND connection, no new proposal
            v1_mid = await _settled_v1_total(cluster)
            seq_replay = cli._seq
            fut = asyncio.get_event_loop().create_future()
            frame = Submit(
                client_id=cli.client_id,
                seq=seq_replay,
                shard=_shard("cmux-re"),
                commands=(encode_set_bin("cmux-re", "after"),),
                ack_upto=0,
            )
            cli._pending[seq_replay] = (fut, frame)
            cli._send_pending(seq_replay)
            res = await asyncio.wait_for(fut, 10.0)
            cli._pending.pop(seq_replay, None)
            assert res.status == ResultStatus.CACHED
            await asyncio.sleep(0.2)
            assert _decided_v1_total(cluster) == v1_mid, (
                "replayed seq over the rebound mux connection proposed "
                "a second time"
            )
            assert v1_mid >= v1_before
            assert (
                cluster.store(0, _shard("cmux-re")).get("cmux-re").value
                == "after"
            )
        finally:
            if cli is not None:
                await cli.close()
            await cluster.stop()


class TestRuntimeGatewayPlane:
    @pytest.mark.asyncio
    async def test_gil_handoffs_flat_across_submit_result(self):
        """Acceptance: on the native runtime + native gateway plane, a
        client submit -> committed result round trip leaves the
        runtime's gil_handoffs counter FLAT while waves_native grows —
        the commit path never re-enters Python, and the gateway's
        session bookkeeping rides the C table."""
        import os
        import sys

        sys.path.insert(0, os.path.dirname(__file__))
        from rabia_tpu_torch.native.build import load_runtime, load_sessionkernel

        if load_runtime() is None:
            pytest.skip("native runtime library unavailable")
        if load_sessionkernel() is None:
            pytest.skip("native sessionkernel library unavailable")
        from test_runtime import _mk_cluster, _teardown  # noqa: E402

        from rabia_tpu_torch.gateway.server import GatewayServer

        ids, nets, engines, machines, tasks = await _mk_cluster(2, 3)
        gw = None
        cli = None
        try:
            e0 = engines[0]
            if e0._rtm is None:
                pytest.skip("native runtime did not engage")
            gw = GatewayServer(e0, config=GatewayConfig())
            await gw.start()
            assert gw.sessions.is_native
            assert gw.health()["planes"]["gateway"] == "native"
            cli = RabiaClient([gw.endpoint], call_timeout=30.0)
            await cli.connect()
            # settle, then bracket ONE submit->result round trip
            await asyncio.sleep(0.3)
            before = e0._rtm.counters_dict()
            resp = await cli.submit(0, [encode_set_bin("gilk", "v")])
            assert decode_kv_response(resp[0]).ok
            after = e0._rtm.counters_dict()
            assert after["waves_native"] > before["waves_native"]
            assert after["gil_handoffs"] == before["gil_handoffs"], (
                "submit->result round trip required a GIL handoff: "
                f"{before} -> {after}"
            )
        finally:
            if cli is not None:
                await cli.close()
            if gw is not None:
                await gw.close()
            await _teardown(engines, tasks, nets)


def _gw_pkg(name: str):
    """One package's gateway surface: ``port`` or ``reference``."""
    import importlib
    import types

    root = "rabia_tpu_torch" if name == "port" else "rabia_tpu"
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name,
        gateway=mod("gateway"),
        session=mod("gateway.session"),
        native_session=mod("gateway.native_session"),
        build=mod("native.build"),
        kvstore=mod("apps.kvstore"),
        types=mod("core.types"),
        cluster=mod("testing.gateway_cluster"),
        conformance=mod("testing.conformance"),
        ledger=mod("fleet.ledger"),
    )


def _drive_table(table, ops, apply_record) -> list:
    """Every op of a ``random_gateway_ops`` schedule through ``table``'s
    op surface; the list of what each op returned."""
    out = []
    for op in ops:
        kind, t = op["op"], op["t"]
        if kind == "hello":
            r = table.hello(op["cid"], op.get("window", 0), now=t)
        elif kind == "submit":
            r = table.submit_check(op["cid"], op["seq"], op.get("ack", 0), now=t)
        elif kind == "complete":
            r = table.complete_op(
                op["cid"], op["seq"], op["status"], op["payload"],
                op["frontier"], now=t,
            )
        elif kind == "abort":
            r = table.abort(op["cid"], op["seq"])
        elif kind == "gc":
            r = table.gc(op["sv"], now=t)
        else:
            assert kind == "ledger", kind
            r = apply_record(
                table, op["cid"], op["seq"], op["status"], op["payload"],
                op["frontier"], now=t,
            )
        out.append(r)
    return out


def _py_table_state(table) -> dict:
    return {
        cid: (
            s.window, s.ack_upto, s.highest_completed, sorted(s.inflight),
            sorted(
                (seq, r.status, r.payload, r.frontier_mark)
                for seq, r in s.results.items()
            ),
        )
        for cid, s in table.sessions.items()
    }


class TestAcrossPackages:
    @pytest.mark.parametrize("seed", [2, 5, 20260810])
    def test_session_tables_agree_op_for_op(self, seed):
        """The port's ``SessionTable``, the port's ``NativeSessionTable``
        and the reference's two tables, on one ``random_gateway_ops``
        schedule (both packages' generators draw the same ops): every
        op returns the same value, and the Python tables end in the same
        sessions, results and stats."""
        port, ref = _gw_pkg("port"), _gw_pkg("reference")
        ops = port.conformance.random_gateway_ops(seed, 600)
        assert ops == ref.conformance.random_gateway_ops(seed, 600)
        kw = dict(
            default_window=4, session_ttl=30.0, lease_ttl=120.0,
            result_cache_cap=4,
        )
        port_py = port.session.SessionTable(**kw)
        ref_py = ref.session.SessionTable(**kw)
        port_nat = port.native_session.NativeSessionTable(
            port.build.load_sessionkernel(), **kw
        )
        ref_nat = ref.native_session.NativeSessionTable(
            ref.build.load_sessionkernel(), **kw
        )
        try:
            legs = {
                "port python": _drive_table(
                    port_py, ops, port.ledger.apply_record
                ),
                "port native": _drive_table(
                    port_nat, ops, port.ledger.apply_record
                ),
                "reference python": _drive_table(
                    ref_py, ops, ref.ledger.apply_record
                ),
                "reference native": _drive_table(
                    ref_nat, ops, ref.ledger.apply_record
                ),
            }
            want = legs["reference python"]
            for leg, got in legs.items():
                for i, (a, b) in enumerate(zip(got, want)):
                    assert a == b, f"{leg}: op {i} {ops[i]['op']}: {a!r} != {b!r}"
            assert _py_table_state(port_py) == _py_table_state(ref_py)
            assert vars(port_py.stats) == vars(ref_py.stats)
            assert set(port_nat.session_ids()) == set(ref_py.sessions)
        finally:
            port_nat.close()
            ref_nat.close()

    @pytest.mark.parametrize(
        "server,client", [("port", "reference"), ("reference", "port")]
    )
    @pytest.mark.asyncio
    async def test_client_and_gateway_across_packages(self, server, client):
        """One package's ``RabiaClient`` against the other package's
        ``GatewayServer`` cluster (one wire codec): exactly-once writes,
        a replayed seq answered CACHED from the session table with the
        same bytes, and linearizable reads of what was written."""
        srv, cli_pkg = _gw_pkg(server), _gw_pkg(client)
        enc, dec = cli_pkg.kvstore.encode_set_bin, cli_pkg.kvstore.decode_kv_response
        cluster = srv.cluster.GatewayCluster(3, 4, persistence=False)
        await cluster.start()
        cli = None
        try:
            eps = [
                cli_pkg.gateway.GatewayEndpoint(
                    node_id=cli_pkg.types.NodeId(ep.node_id.value),
                    host=ep.host, port=ep.port,
                )
                for ep in cluster.endpoints()
            ]
            cli = cli_pkg.gateway.RabiaClient(eps, call_timeout=30.0)
            await cli.connect()
            sent = {}
            for k in range(12):
                key, val = f"x{k}", f"v{k}"
                resp = await cli.submit(k % 4, [enc(key, val)])
                assert dec(resp[0]).ok
                sent[cli._seq] = (k % 4, key, resp)
            for seq, (shard, key, resp) in sent.items():
                frame = cli_pkg.gateway.client.Submit(
                    client_id=cli.client_id, seq=seq, shard=shard,
                    commands=(enc(key, f"v{int(key[1:])}"),),
                    ack_upto=cli._ack_upto,
                )
                res = await cli._call(seq, frame)
                assert res.status == cli_pkg.gateway.client.ResultStatus.CACHED
                assert list(res.payload) == resp
            for _seq, (shard, key, _resp) in sent.items():
                got = await cli.get(shard, key)
                r = cli_pkg.kvstore.decode_result_bin(got)
                assert r.value == f"v{int(key[1:])}", r
        finally:
            if cli is not None:
                await cli.close()
            await cluster.stop()

    def test_devkv_read_handler_matches_kv_read_handler(self):
        """``devkv_read_handler`` over a CPU ``MeshEngine(device_store=
        True)`` and ``kv_read_handler`` over a native sharded store fed
        the same SETs answer every read byte for byte, one at a time and
        through ``read_many`` (present keys, overwritten keys, absent
        keys, and a shard read twice in one batch)."""
        from rabia_tpu_torch.apps.sharded import make_sharded_kv
        from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
        from rabia_tpu_torch.core.blocks import build_block
        from rabia_tpu_torch.gateway import devkv_read_handler, kv_read_handler
        from rabia_tpu_torch.parallel.mesh_engine import MeshEngine

        import numpy as np

        S, R = 8, 3
        sm, _machines = make_sharded_kv(S)
        eng = MeshEngine(
            lambda: VectorShardedKV(S), S, R, window=16, device="cpu",
            device_store=True, device_store_kw={"per_shard_capacity": 64},
        )
        for w in range(5):
            col = [
                [encode_set_bin(f"key-{s}-{w % 3}".ljust(32, "k"),
                                f"w{w}s{s}".ljust(64, "v"))]
                for s in range(S)
            ]
            for s in range(S):
                sm._native_plane.apply_ops(s, col[s], 1.0)
            eng.submit_block(build_block(np.arange(S), col))
        eng.flush()
        assert eng.device_lane_active
        host, dev = kv_read_handler(sm), devkv_read_handler(eng)
        items = [
            (s, f"key-{s}-{j}".ljust(32, "k").encode())
            for s in range(S) for j in range(4)
        ]
        want = [host(s, k) for s, k in items]
        assert dev.read_many(items) == want
        assert [dev(s, k) for s, k in items] == want
        assert sum(decode_kv_response(w).ok for w in want) == 3 * S

    def test_devkv_read_handler_over_a_mesh_engine(self, monkeypatch):
        """``read_many`` over a ``MeshEngine(device_store=True)`` on a
        2 x 4 logical mesh (its table in two shard blocks) answers every
        read as over one device's engine fed the same SETs: one probe a
        batch, one read scan a shard block, no slot."""
        from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
        from rabia_tpu_torch.core.blocks import build_block
        from rabia_tpu_torch.gateway import devkv_read_handler
        from rabia_tpu_torch.kernel import kv_window
        from rabia_tpu_torch.parallel import make_mesh
        from rabia_tpu_torch.parallel.mesh_engine import MeshEngine

        import numpy as np

        S, R = 8, 4
        engines = [
            MeshEngine(lambda: VectorShardedKV(S), S, R, window=16, **where,
                       device_store=True, device_store_kw={"per_shard_capacity": 64})
            for where in ({"device": "cpu"}, {"mesh": make_mesh(["cpu"] * 8, 2, 4)})
        ]
        for w in range(5):
            col = [[encode_set_bin(f"key-{s}-{w % 3}", f"w{w}s{s}")] for s in range(S)]
            for eng in engines:
                eng.submit_block(build_block(np.arange(S), col))
        for eng in engines:
            eng.flush()
            assert eng.device_lane_active
        assert len(engines[1]._dev.state.used.blocks) == 2
        items = [(s, f"key-{s}-{j}".encode()) for s in range(S) for j in range(4)]
        items += [(3, b"key-3-0"), (9, b"out of range"), (2, b"k" * 40)]
        one, mesh = (devkv_read_handler(e) for e in engines)
        want = one.read_many(items)
        scans = []
        real = kv_window.kv_window_plain
        monkeypatch.setattr(kv_window, "kv_window_plain",
                            lambda *a, **k: scans.append(a[0].used.shape[0]) or real(*a, **k))
        slots = engines[1].next_slot.copy()
        assert mesh.read_many(items) == want
        assert scans == [S // 2] * 2  # one probe: one scan a shard block
        assert engines[1].next_slot.tolist() == slots.tolist()
        assert [mesh(s, k) for s, k in items] == want
        assert sum(decode_kv_response(w).ok for w in want) == 3 * S + 1


class TestPhase13Small:
    """chip_smoke.py's phase 13 (a) at 3 replicas × 8 shards on the CPU:
    a durable gateway cluster (every plane native), 8 client sessions,
    4 waves of one SET a shard, the replay of every (client, seq) from
    the session cache with no new proposal, and every key read by
    ReadIndex through a gateway over the device table and through one
    over a replica's store, both equal to the last acknowledged write."""

    @pytest.mark.asyncio
    async def test_durable_gateway_small(self):
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        import chip_smoke

        st = await chip_smoke.durable_gateway_run(
            "cpu", S=8, R=3, waves=4, sessions=8
        )
        assert st["acked_writes"] == 4 * 8
        assert st["replayed_from_cache"] == 4 * 8
        assert st["reads_equal"] == 8
        assert st["wal_fsyncs"] > 0 and st["durable_lsn"] > 0
        # the slow Submits decomposed while the writes ran, beside the
        # runtime's stage clocks over the same span
        cp = st["critpath"]
        assert cp["decomposed"] > 0 and cp["segments_mean_ms"]
        assert sum(cp["segments_share"].values()) == pytest.approx(1.0, abs=1e-3)
        assert sum(st["rts_stages"]["seconds"].values()) > 0


class TestSubmitsAfterRestart:
    """A restarted replica never proposes in the slots its restored vote
    barrier taints. A submission through its gateway on a shard whose
    head slot is its own to propose is now handed to the next slot's
    proposer, which nulls the head slot and commits the batch in its own;
    the reference forwarded nothing there, and the submission waited
    for the taint release (``taint_release_factor * phase_timeout`` with
    no tainted-slot traffic; 6.4 s at the gateway cluster's settings,
    400 s here)."""

    @pytest.mark.asyncio
    async def test_submit_on_a_tainted_own_slot_commits(self):
        from dataclasses import replace

        from rabia_tpu_torch.engine.leader import slot_proposer
        from rabia_tpu_torch.testing.gateway_cluster import (
            default_gateway_test_config,
        )

        cfg = replace(default_gateway_test_config(4), taint_release_factor=1000.0)
        c = GatewayCluster(3, 4, config=cfg, persistence="wal")
        await c.start()
        cli = None
        try:
            cli = RabiaClient([c.endpoint(1)], call_timeout=10.0)
            await cli.connect()
            for k in range(3):
                for s in range(4):
                    resp = await cli.submit(s, [encode_set_bin(f"t{s}", f"v{k}")])
                    assert decode_kv_response(resp[0]).ok
            await cli.close()
            cli = None
            await c.restart_replica(0, settle=0.3)
            await c.wait_converged(20)
            e = c.engines[0]
            rt = e.rt
            heads = [max(int(rt.next_slot[s]), int(rt.applied_upto[s])) for s in range(4)]
            own = [s for s in range(4)
                   if heads[s] < int(rt.tainted_upto[s])
                   and slot_proposer(s, heads[s], e.R) == e.me]
            assert own, (heads, rt.tainted_upto[:4].tolist())
            cli = RabiaClient([c.endpoint(0)], call_timeout=60.0)
            await cli.connect()
            for s in own:
                resp = await asyncio.wait_for(
                    cli.submit(s, [encode_set_bin(f"t{s}", "after")]), 30.0)
                assert decode_kv_response(resp[0]).ok
            await c.wait_converged(20)
            for s in own:
                v = c.store(2, s).get(f"t{s}")
                assert getattr(v, "value", v) == "after"
        finally:
            if cli is not None:
                await cli.close()
            await c.stop()


class TestReadsAfterRestart:
    """A restarted replica's frontier is floored at its restored vote
    barrier (up to a barrier stride above what it knows), so a ReadIndex
    quorum that counted it held every read of a shard with fewer slots
    since the crash until traffic passed the barrier. Its gateway now
    takes the read index from a quorum of the other replicas and
    abstains from their probes while floored; reads through every
    gateway serve at once."""

    @pytest.mark.asyncio
    async def test_reads_through_every_gateway_after_a_restart(self):
        from rabia_tpu_torch.apps.kvstore import decode_result_bin

        c = GatewayCluster(3, 4, persistence="wal")
        await c.start()
        try:
            cli = RabiaClient([c.endpoint(0)], call_timeout=10.0)
            await cli.connect()
            for s in range(4):
                resp = await cli.submit(s, [encode_set_bin(f"r{s}", f"v{s}")])
                assert decode_kv_response(resp[0]).ok
            await cli.close()
            await c.restart_replica(1, settle=0.3)
            await c.wait_converged(20)
            assert c.engines[1].frontier_floored()
            for gi in range(3):
                rc = RabiaClient([c.endpoint(gi)], call_timeout=5.0)
                await rc.connect()
                try:
                    for s in range(4):
                        got = await asyncio.wait_for(rc.get(s, f"r{s}"), 8.0)
                        assert decode_result_bin(got).value == f"v{s}"
                finally:
                    await rc.close()
        finally:
            await c.stop()
