"""The port's cross-session submit coalescing lane: many clients'
Submits packed into one multi-client PayloadBlock entry, per-client alias
ids in the dedup ledger, and one durability-barrier wait releasing every
covered Result.

The port's copy of the reference's tests/test_coalesce.py, with
``TestFleetLedgerFailover`` over the port's fleet tier.

Exactly-once gates (the round-15 acceptance):
- a replayed Submit whose original rode a coalesced wave answers from
  the dedup cache with ONLY that client's response slice;
- a gateway torn down mid-window (staged but un-proposed ops) sheds the
  parked submits retryable and a client retry applies exactly once;
- alias batch ids survive WAL crash recovery (K_LEDGER lists).

Parametrized over the native sessionkernel table and the Python
semantics owner (``RABIA_PY_GATEWAY=1``).
"""

from __future__ import annotations

import asyncio
import uuid

import pytest

from rabia_tpu_torch.apps.kvstore import (
    decode_kv_response,
    encode_set_bin,
)
from rabia_tpu_torch.core.messages import ResultStatus, Submit
from rabia_tpu_torch.core.types import BatchId
from rabia_tpu_torch.gateway import GatewayConfig, RabiaClient
from rabia_tpu_torch.obs.flight import batch_id_for
from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

SHARDS = 4

# both gateway session tables (the conformance pair): the native
# sessionkernel plane and the Python semantics owner
TABLES = ["native", "python"]


def _table_env(monkeypatch, table: str) -> None:
    if table == "python":
        monkeypatch.setenv("RABIA_PY_GATEWAY", "1")
    else:
        monkeypatch.delenv("RABIA_PY_GATEWAY", raising=False)


async def _spin_up(**kw) -> GatewayCluster:
    gw_cfg = kw.pop(
        "gateway_config",
        GatewayConfig(coalesce=True, coalesce_window=0.01),
    )
    cluster = GatewayCluster(
        n_replicas=3, n_shards=SHARDS, gateway_config=gw_cfg, **kw
    )
    await cluster.start()
    return cluster


async def _connect_clients(cluster, n: int, gw: int = 0):
    clients = []
    for _ in range(n):
        c = RabiaClient([cluster.endpoint(gw)], call_timeout=30.0)
        await c.connect()
        clients.append(c)
    return clients


def _wipe_sessions(gw) -> None:
    """Total session-state loss at the gateway: the python table clears
    its dict; the native table is rebuilt empty."""
    if hasattr(gw.sessions, "sessions"):
        gw.sessions.sessions.clear()
    else:
        from rabia_tpu_torch.gateway.native_session import make_session_table

        gw.sessions.close()
        gw.sessions = make_session_table(
            default_window=gw.config.max_inflight_per_session,
            session_ttl=gw.config.session_ttl,
            result_cache_cap=gw.config.result_cache_cap,
            lease_ttl=gw.config.session_lease,
        )


class TestCoalescedWave:
    @pytest.mark.asyncio
    @pytest.mark.parametrize("table", TABLES)
    async def test_multi_client_wave_exactly_once(self, table, monkeypatch):
        """8 concurrent clients' submits to one shard ride ONE wave:
        per-client response slices, one coalesce wave proposed, every
        covered client's alias id registered in the dedup ledger, and
        the state identical on every replica."""
        _table_env(monkeypatch, table)
        cluster = await _spin_up(persistence="wal")
        clients = []
        try:
            gw = cluster.gateways[0]
            assert gw.sessions.is_native == (table == "native")
            clients = await _connect_clients(cluster, 8)
            shard = 1
            res = await asyncio.gather(
                *(
                    c.submit(shard, [encode_set_bin(f"mc{i}", f"v{i}")])
                    for i, c in enumerate(clients)
                )
            )
            for i, r in enumerate(res):
                assert len(r) == 1, "per-client slice, not the wave"
                assert decode_kv_response(r[0]).ok
            assert gw.stats.coalesce_waves >= 1
            assert gw.stats.submits_coalesced >= 2
            # ONE durability barrier covered many results
            wal = cluster.engines[0]._wal
            assert wal.barrier_covered >= wal.barrier_waits
            assert wal.barrier_covered >= 8
            # every covered client's deterministic id is in the ledger
            # (the wire-symmetric entry id in applied_ids, proposer-
            # local aliases in alias_ledger). A NON-lead id holds ONLY
            # its response slice; an ENTRY (== lead) id keeps the FULL
            # entry list intact (_settle_from_ledger and entry-level
            # peer repair depend on it — the lead's replay truncates to
            # its own prefix at SERVE time instead, asserted below)
            sh = cluster.engines[0].rt.shards[shard]
            lead = None
            for i, c in enumerate(clients):
                bid = BatchId(batch_id_for(c.client_id, 1))
                assert bid in sh.applied_ids or bid in sh.alias_ledger, (
                    f"client {i} alias missing"
                )
                cached = sh.applied_results.get(bid)
                assert cached is not None, f"client {i} responses missing"
                got = len(list(cached))
                if bid in sh.applied_ids and got > 1:
                    lead = c  # entry id: full entry response list
                else:
                    assert got == 1, f"client {i}: {got} responses"
            # the LEAD's session-loss replay serves ONLY its own prefix
            # (the ledger holds the full entry list under its id; the
            # serve path truncates to the replayed op count)
            if lead is not None:
                _wipe_sessions(gw)
                res = await lead._call(1, Submit(
                    client_id=lead.client_id, seq=1, shard=shard,
                    commands=(encode_set_bin("lead-replay", "X"),),
                ))
                assert res.status in (
                    ResultStatus.OK, ResultStatus.CACHED,
                ), (res.status, res.payload)
                assert len(res.payload) == 1, (
                    "lead replay leaked the full entry response list"
                )
                assert decode_kv_response(res.payload[0]).ok
            # state converged everywhere
            await cluster.wait_converged()
            for r in range(3):
                for i in range(8):
                    got = cluster.store(r, shard).get(f"mc{i}")
                    assert got.value == f"v{i}"
        finally:
            for c in clients:
                await c.close()
            await cluster.stop()

    @pytest.mark.asyncio
    @pytest.mark.parametrize("table", TABLES)
    async def test_replay_of_coalesced_submit_hits_dedup_cache(
        self, table, monkeypatch
    ):
        """A replayed (client_id, seq) whose ORIGINAL rode a coalesced
        wave answers CACHED from the session table — with only that
        client's payload — and proposes nothing new."""
        _table_env(monkeypatch, table)
        cluster = await _spin_up()
        clients = []
        try:
            clients = await _connect_clients(cluster, 4)
            shard = 2
            await asyncio.gather(
                *(
                    c.submit(shard, [encode_set_bin(f"rp{i}", f"v{i}")])
                    for i, c in enumerate(clients)
                )
            )
            gw = cluster.gateways[0]
            assert gw.stats.submits_coalesced >= 2
            v1_before = sum(e.rt.decided_v1 for e in cluster.engines)
            c2 = clients[2]
            dup = Submit(
                client_id=c2.client_id, seq=1, shard=shard,
                commands=(encode_set_bin("rp2", "DIFFERENT"),),
            )
            res = await c2._call(1, dup)
            assert res.status == ResultStatus.CACHED
            assert len(res.payload) == 1
            assert decode_kv_response(res.payload[0]).ok
            await asyncio.sleep(0.2)
            assert (
                sum(e.rt.decided_v1 for e in cluster.engines) == v1_before
            ), "replay re-proposed"
            # the original value survived
            assert cluster.store(0, shard).get("rp2").value == "v2"
        finally:
            for c in clients:
                await c.close()
            await cluster.stop()

    @pytest.mark.asyncio
    @pytest.mark.parametrize("table", TABLES)
    async def test_session_loss_replay_dedups_via_alias_ledger(
        self, table, monkeypatch
    ):
        """Session state wiped AFTER a coalesced commit: a replay of a
        NON-LEAD covered client re-proposes under its deterministic id,
        and the alias ledger blocks the double apply (the scalar lane's
        round-8 guarantee, extended to multi-client waves)."""
        _table_env(monkeypatch, table)
        cluster = await _spin_up()
        clients = []
        try:
            clients = await _connect_clients(cluster, 4)
            shard = 1
            await asyncio.gather(
                *(
                    c.submit(shard, [encode_set_bin(f"sl{i}", f"v{i}")])
                    for i, c in enumerate(clients)
                )
            )
            gw = cluster.gateways[0]
            assert gw.stats.submits_coalesced >= 2
            store = cluster.store(0, shard)
            ver = store.version
            _wipe_sessions(gw)
            # replay client 3 (a non-lead window member, order-agnostic:
            # ANY covered client must dedup)
            c3 = clients[3]
            dup = Submit(
                client_id=c3.client_id, seq=1, shard=shard,
                commands=(encode_set_bin("sl3", "v3"),),
            )
            res = await c3._call(1, dup)
            assert res.status in (ResultStatus.OK, ResultStatus.CACHED), (
                res.status, res.payload,
            )
            await asyncio.sleep(0.2)
            assert store.version == ver, "double apply after session loss"
        finally:
            for c in clients:
                await c.close()
            await cluster.stop()


class TestCrossGatewayReplay:
    @pytest.mark.asyncio
    async def test_failover_replay_of_lead_dedups_on_peer_gateway(
        self, monkeypatch
    ):
        """Durable cluster: a wave's wire-derivable (lead) batch id
        enters EVERY replica's live applied ledger, so a client that
        fails over to a DIFFERENT replica's gateway and replays its seq
        dedups there (the responses repair from the peer that holds
        them) instead of re-proposing. Non-lead coalesced aliases stay
        proposer-local by design (PROTOCOL_GUIDE §4e; dedup-table
        replication is ROADMAP item 2)."""
        monkeypatch.delenv("RABIA_PY_GATEWAY", raising=False)
        cluster = await _spin_up(persistence="wal")
        clients = []
        try:
            clients = await _connect_clients(cluster, 4)
            shard = 1
            await asyncio.gather(
                *(
                    c.submit(shard, [encode_set_bin(f"fo{i}", f"v{i}")])
                    for i, c in enumerate(clients)
                )
            )
            assert cluster.gateways[0].stats.submits_coalesced >= 2
            await cluster.wait_converged()
            await asyncio.sleep(0.3)  # EV_LEDGER drain on followers
            # the lead (first-parked) client: find one whose id is in a
            # FOLLOWER's live ledger (the wire-derivable entry id)
            lead = None
            sh1 = cluster.engines[1].rt.shards[shard]
            for c in clients:
                if BatchId(batch_id_for(c.client_id, 1)) in sh1.applied_ids:
                    lead = c
                    break
            assert lead is not None, (
                "no covered client's id reached the follower ledger"
            )
            store = cluster.store(1, shard)
            ver = store.version
            # fail over: same client identity, DIFFERENT gateway
            fo = RabiaClient(
                [cluster.endpoint(1)], call_timeout=30.0,
                client_id=lead.client_id,
            )
            await fo.connect()
            dup = Submit(
                client_id=lead.client_id, seq=1, shard=shard,
                commands=(encode_set_bin("fo-replay", "X"),),
            )
            res = await fo._call(1, dup)
            assert res.status in (
                ResultStatus.OK, ResultStatus.CACHED, ResultStatus.ERROR,
            )
            await asyncio.sleep(0.3)
            assert store.version == ver, (
                "failover replay re-applied on the peer gateway"
            )
            # the replayed commands were NOT applied either
            assert store.get("fo-replay").value is None
            await fo.close()
        finally:
            for c in clients:
                await c.close()
            await cluster.stop()


class TestWindowTeardown:
    @pytest.mark.asyncio
    @pytest.mark.parametrize("table", TABLES)
    async def test_close_mid_window_sheds_retryable_never_applies(
        self, table, monkeypatch
    ):
        """Gateway torn down with a FULL window parked (staged but
        un-proposed): every parked submit is shed RETRYABLE, nothing
        reaches consensus, and a client retry against a surviving
        gateway applies exactly once."""
        _table_env(monkeypatch, table)
        # a huge window (min pinned too — the adaptive sizing would
        # otherwise shrink it) so parked ops cannot flush on their own
        cluster = await _spin_up(
            gateway_config=GatewayConfig(
                coalesce=True, coalesce_window=30.0,
                coalesce_window_min=30.0,
            ),
        )
        clients = []
        try:
            clients = await _connect_clients(cluster, 4)
            gw = cluster.gateways[0]
            shard = 1
            # fire the submits and give the frames time to land in the
            # window (but not to flush: the window is 30s)
            tasks = [
                asyncio.ensure_future(
                    c.submit(shard, [encode_set_bin(f"tw{i}", f"v{i}")])
                )
                for i, c in enumerate(clients)
            ]
            for _ in range(200):
                await asyncio.sleep(0.01)
                if sum(
                    len(w.entries) for w in gw._coal.values()
                ) >= 2:
                    break
            assert gw._coal, "window never opened"
            parked = sum(len(w.entries) for w in gw._coal.values())
            assert parked >= 2
            # the first arrival may have driven through the sparse gate;
            # only the PARKED ones are the subject here
            parked_keys = {
                (p.client_id, p.seq)
                for w in gw._coal.values()
                for _s, p, _t in w.entries
            }
            # tear the gateway down mid-window: parked ops are shed
            # retryable (and were never proposed). The client library
            # would keep retrying against its (now dead) endpoint, so
            # cancel the in-flight calls rather than riding out their
            # timeouts — the assertion below is about the CLUSTER.
            parked_idx = [
                i for i, c in enumerate(clients)
                if (c.client_id, 1) in parked_keys
            ]
            assert len(parked_idx) >= 2
            await gw.close()
            await asyncio.sleep(0.3)
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            # parked (staged but un-proposed) ops NEVER reached
            # consensus — no replica applied them
            for i in parked_idx:
                for r in range(3):
                    got = cluster.store(r, shard).get(f"tw{i}")
                    assert got.value is None, (
                        f"un-proposed parked op tw{i} applied on {r}"
                    )
            # a fresh retry of a parked op against a surviving gateway
            # applies exactly once
            key = f"tw{parked_idx[0]}"
            retry = RabiaClient([cluster.endpoint(1)], call_timeout=30.0)
            await retry.connect()
            resp = await retry.submit(shard, [encode_set_bin(key, "retry")])
            assert decode_kv_response(resp[0]).ok
            await asyncio.sleep(0.2)
            assert cluster.store(1, shard).get(key).value == "retry"
            await retry.close()
        finally:
            for c in clients:
                await c.close()
            await cluster.stop()


class TestFleetLedgerFailover:
    @pytest.mark.asyncio
    async def test_replay_on_other_fleet_gateway_is_byte_identical(self):
        """The round-16 dedup-replication gate: a coalesced submit's
        completed result replicates to the shard's fleet gateway group,
        so a replay landing on a DIFFERENT fleet gateway (failover,
        re-route) answers byte-identically from the replicated ledger —
        with ZERO store mutation on any replica (the race-free
        double-apply detector) and without waiting out session
        leases."""
        from rabia_tpu_torch.fleet.harness import FleetHarness, FleetSession

        h = FleetHarness(
            n_gateways=2,
            n_shards=SHARDS,
            persistence=False,
            gateway_config=GatewayConfig(
                coalesce=True, coalesce_window=0.01
            ),
        )
        await h.start()
        try:
            shard = 0
            ring = h.gateways[0].ring
            owner, succ = ring.successors(shard, 2)
            owner_i = int(owner.name.removeprefix("gw"))
            succ_i = int(succ.name.removeprefix("gw"))
            # several sessions on the same shard so the upstream
            # coalescing window actually packs multi-client waves
            sessions = [FleetSession(h.ser, h.resolver()) for _ in range(4)]
            results = await asyncio.gather(*(
                s.submit(shard, [encode_set_bin(f"fl{i}", f"v{i}")])
                for i, s in enumerate(sessions)
            ))
            assert all(r.status == ResultStatus.OK for r in results)
            want = [tuple(bytes(p) for p in r.payload) for r in results]
            # wait for every fire-and-forget ledger record to land on
            # the successor
            succ_gw = h.gateways[succ_i]
            for _ in range(200):
                if all(
                    succ_gw.sessions.cached_result(s.client_id, 1)
                    for s in sessions
                ):
                    break
                await asyncio.sleep(0.02)
            await h.cluster.wait_converged()
            vers = [
                [h.cluster.store(r, s).version for s in range(SHARDS)]
                for r in range(3)
            ]
            # re-route every session to the OTHER gateway and replay
            m = succ_gw.member()
            for s in sessions:
                s.resolver.note_moved(shard, (m.host, m.port))
            for i, s in enumerate(sessions):
                replay = await s.submit_seq(
                    1, shard, [encode_set_bin(f"fl{i}", "X")]
                )
                assert replay.status == ResultStatus.CACHED, (
                    f"session {i}: {replay.status}"
                )
                assert tuple(bytes(p) for p in replay.payload) == want[i]
            await asyncio.sleep(0.3)
            assert [
                [h.cluster.store(r, s).version for s in range(SHARDS)]
                for r in range(3)
            ] == vers, "cross-gateway replay mutated state (double apply)"
            assert h.gateways[owner_i].stats.ledger_sent >= 4
            assert succ_gw.stats.ledger_applied >= 4
            for s in sessions:
                await s.close()
        finally:
            await h.stop()


class TestAliasRecovery:
    def test_alias_ledger_records_survive_recovery(self, tmp_path):
        """K_LEDGER lists: a wave staged with several per-client alias
        records recovers the wave's own id into applied_ids and every
        alias into the proposer-local alias_ledger (the coalescing
        lane's crash-recovery dedup — aliases stay OUT of applied_ids
        so the apply-path dedup-skip stays symmetric across replicas)."""
        import numpy as np

        from rabia_tpu_torch.persistence.native_wal import WalPersistence

        wal = WalPersistence(tmp_path / "w", n_shards=SHARDS)
        ops = [encode_set_bin("k", "v"), encode_set_bin("k2", "v2")]
        wal.stage_wave(0, 0, 1, bid=b"\x11" * 16, ops=ops)
        alias_a, alias_b = b"\xaa" * 16, b"\xbb" * 16
        wal.stage_ledger(0, 0, alias_a)
        wal.stage_ledger(0, 0, alias_b)
        wal.close()

        class _Shard:
            def __init__(self):
                self.applied_ids = {}
                self.applied_results = {}
                self.alias_ledger = {}

        class _RT:
            pass

        class _Eng:
            pass

        wal2 = WalPersistence(tmp_path / "w", n_shards=SHARDS)
        ledger = wal2.recovered.ledger
        assert ledger[(0, 0)] == [alias_a, alias_b]
        eng = _Eng()
        eng.n_shards = SHARDS
        rt = _RT()
        rt.applied_upto = np.zeros(SHARDS, np.int64)
        rt.next_slot = np.zeros(SHARDS, np.int64)
        rt.state_version = 0
        rt.v1_applied = np.zeros(SHARDS, np.int64)
        rt.shards = [_Shard() for _ in range(SHARDS)]
        eng.rt = rt

        class _SM:
            def apply_batch(self, batch):
                return [b"" for _ in batch.commands]

        eng.sm = _SM()
        replayed = wal2.replay_waves(eng)
        assert replayed == 1
        ids = {b.value.bytes for b in rt.shards[0].applied_ids}
        assert b"\x11" * 16 in ids, "wave's own id missing from applied_ids"
        aliases = {b.value.bytes for b in rt.shards[0].alias_ledger}
        assert {alias_a, alias_b} <= aliases, (
            "alias ids missing from alias_ledger"
        )
        assert not ({alias_a, alias_b} & ids), (
            "proposer-local aliases leaked into applied_ids — the "
            "apply-path dedup-skip would diverge replica state"
        )
        wal2.close()


class TestCoalesceGate:
    """The coalescing gate (``testing.conformance.
    run_submits_on_coalesce_paths``, the reference's fuzz gate): one
    multi-client schedule through a coalescing cluster and a per-submit
    one, over each session table."""

    @pytest.mark.parametrize("table", TABLES)
    @pytest.mark.parametrize("seed", [1, 7])
    @pytest.mark.asyncio
    async def test_schedule_on_both_lanes(self, monkeypatch, table, seed):
        from rabia_tpu_torch.testing.conformance import (
            random_coalesce_schedule,
            run_submits_on_coalesce_paths,
        )

        _table_env(monkeypatch, table)
        rounds, n_clients, n_shards = random_coalesce_schedule(seed + 2113)
        await run_submits_on_coalesce_paths(
            rounds, n_clients, n_shards, tag=f"seed={seed} {table}"
        )
