"""Fleet observability plane tests (obs/fleet_obs.py, round 18).

Four tiers: pure derived-metric math against hand-computed counter
deltas; the SLO burn-rate watchdog's fire/quiet/edge-trigger semantics;
the aggregator + cross-tier trace against a live in-process fleet
(ring discovery, scrape alignment, trace-hop ordering across a MOVED
redirect); and the fleet-top series / chaos-profile plumbing.

The port's copy of the reference's tests/test_fleet_obs.py.
"""

from __future__ import annotations

import asyncio
import json
import shutil

import pytest

from rabia_tpu_torch.obs.fleet_obs import (
    BurnRateWatchdog,
    FleetAggregator,
    SLOPolicy,
    collect_fleet_trace,
    derive_fleet_sample,
    derive_gateway_figures,
    render_fleet_table,
    shard_coalesce_figures,
)
from rabia_tpu_torch.obs.journal import AnomalyJournal


def _shard_metrics(per_shard: dict) -> dict:
    """Hand-build a parsed-metrics dict from {shard: {field: value}}."""
    out = {}
    for shard, fields in per_shard.items():
        for fld, v in fields.items():
            out[
                f'rabia_coalesce_shard_total{{field="{fld}",'
                f'shard="{shard}"}}'
            ] = float(v)
    return out


class TestDerivedFigures:
    def test_shard_figures_sum_only_named_shards(self):
        m = _shard_metrics({
            0: {"waves": 4, "covered": 12, "results_ok": 16},
            1: {"waves": 2, "covered": 2, "results_ok": 2},
            2: {"waves": 100, "covered": 900, "results_ok": 1000},
        })
        fig = shard_coalesce_figures(m, [0, 1])
        assert fig["waves"] == 6.0
        assert fig["covered"] == 14.0
        assert fig["results_ok"] == 18.0
        assert fig["solo"] == 0.0  # absent key reads as zero

    def test_gateway_figures_match_hand_math(self):
        m = _shard_metrics({
            0: {"waves": 10, "covered": 30, "scalar": 2,
                "results_ok": 32},
        })
        fig = derive_gateway_figures([0], [m])
        assert fig["coalesce_density"] == 3.0  # 30 / 10
        assert fig["slots_per_op"] == round(12 / 32, 6)

    def test_gateway_figures_delta_against_prev(self):
        prev = _shard_metrics({0: {"waves": 10, "covered": 30}})
        cur = _shard_metrics({0: {"waves": 15, "covered": 50}})
        fig = derive_gateway_figures([0], [cur], [prev])
        assert fig["waves"] == 5.0
        assert fig["covered"] == 20.0
        assert fig["coalesce_density"] == 4.0

    def test_zero_denominators_derive_none_not_perfection(self):
        fig = derive_gateway_figures([0], [_shard_metrics({})])
        assert fig["coalesce_density"] is None
        assert fig["slots_per_op"] is None

    def test_figures_sum_across_replicas(self):
        a = _shard_metrics({0: {"waves": 3, "covered": 6}})
        b = _shard_metrics({0: {"waves": 1, "covered": 6}})
        fig = derive_gateway_figures([0], [a, b])
        assert fig["waves"] == 4.0
        assert fig["coalesce_density"] == 3.0


def _ring_doc(names):
    from rabia_tpu_torch.core.types import NodeId
    from rabia_tpu_torch.fleet import HashRing, RingMember

    ring = HashRing(vnodes=8)
    for i, name in enumerate(names):
        ring.add(RingMember(
            name=name, host="127.0.0.1", port=50000 + i,
            node=NodeId.from_int(2000 + i),
        ))
    return ring.to_doc(), ring


def _scrape(t, metrics=None, stats=None, sessions=0):
    return {
        "metrics": metrics or {},
        "health": {"sessions": sessions, "stats": stats or {}},
        "t": t,
        "err_s": 0.001,
    }


class TestDeriveFleetSample:
    def test_rates_and_aggregate_from_hand_built_scrapes(self):
        doc, ring = _ring_doc(["gw0", "gw1"])
        rep0 = {
            **_shard_metrics({s: {"waves": 0, "covered": 0,
                                  "results_ok": 0} for s in range(4)}),
            "rabia_wal_fsyncs_total": 10.0,
            "rabia_gateway_reads_total": 100.0,
            "rabia_engine_reads_probe_total": 100.0,
        }
        prev = derive_fleet_sample(
            doc, 4,
            {"gw0": _scrape(100.0, stats={"submits": 0}),
             "gw1": _scrape(100.0, stats={"submits": 0})},
            [_scrape(100.0, metrics=rep0)],
        )
        rep1 = {
            **_shard_metrics({s: {"waves": 2, "covered": 8,
                                  "results_ok": 10} for s in range(4)}),
            "rabia_wal_fsyncs_total": 14.0,
            "rabia_gateway_reads_total": 140.0,
            "rabia_engine_reads_probe_total": 130.0,
        }
        cur = derive_fleet_sample(
            doc, 4,
            {"gw0": _scrape(110.0, stats={"submits": 200}),
             "gw1": _scrape(110.0, stats={"submits": 100})},
            [_scrape(110.0, metrics=rep1)],
            prev=prev,
        )
        assert cur["interval_s"] == pytest.approx(10.0)
        # every shard moved identically, so density is 4.0 regardless
        # of which shards each gateway owns
        for name in ("gw0", "gw1"):
            g = cur["gateways"][name]
            assert g["owned_shards"] == ring.owned_shards(name, 4)
            if g["waves"] > 0:
                assert g["coalesce_density"] == 4.0
        assert cur["gateways"]["gw0"]["submits_per_s"] == 20.0
        agg = cur["aggregate"]
        assert agg["waves"] == 8.0
        assert agg["fsyncs_per_result"] == pytest.approx(4 / 40)
        assert agg["offcons_fraction"] == pytest.approx(30 / 40)

    def test_unreachable_member_marked_stale(self):
        doc, _ = _ring_doc(["gw0", "gw1"])
        cur = derive_fleet_sample(
            doc, 4,
            {"gw0": _scrape(5.0), "gw1": None},
            [_scrape(5.0)],
        )
        assert cur["stale_members"] == ["gw1"]
        assert cur["gateways"]["gw1"] == {"stale": True}
        # and the table renders the corpse instead of hiding it
        table = render_fleet_table(cur)
        assert "UNREACHABLE" in table
        assert "gw0" in table

    def test_first_sample_has_no_rates(self):
        doc, _ = _ring_doc(["gw0"])
        cur = derive_fleet_sample(doc, 4, {"gw0": _scrape(5.0)}, [])
        assert cur["interval_s"] is None
        assert "submits_per_s" not in cur["gateways"]["gw0"]
        assert "first sample" in render_fleet_table(cur)


class TestBurnRateWatchdog:
    POLICY = SLOPolicy(fast_window_s=2.0, slow_window_s=8.0)

    def _feed(self, wd, rows):
        fired = []
        for t, sample in rows:
            fired.extend(wd.observe(t, sample))
        return fired

    def test_quiet_on_healthy_run(self):
        wd = BurnRateWatchdog(self.POLICY)
        fired = self._feed(wd, [
            (float(t), {"ok": 100.0 * t, "errors": 0.0,
                        "members_alive": 3, "members_total": 3})
            for t in range(12)
        ])
        assert fired == []
        v = wd.verdict()
        assert v["quiet"] is True
        assert v["samples"] == 12

    def test_slo_burn_fires_once_per_episode_and_rearms(self):
        wd = BurnRateWatchdog(self.POLICY)
        rows = []
        ok = errors = 0.0
        for t in range(10):  # healthy preamble spans both windows
            ok += 100.0
            rows.append((float(t), {"ok": ok, "errors": errors}))
        for t in range(10, 20):  # 50% error rate >> 1% budget
            ok += 50.0
            errors += 50.0
            rows.append((float(t), {"ok": ok, "errors": errors}))
        fired = self._feed(wd, rows)
        assert fired == [AnomalyJournal.SLO_BURN]  # edge, not level
        # recovery clears the episode...
        for t in range(20, 40):
            ok += 100.0
            rows = [(float(t), {"ok": ok, "errors": errors})]
            assert self._feed(wd, rows) == []
        assert wd.verdict()["active"] == []
        # ...and a second incident is a second episode
        for t in range(40, 50):
            ok += 50.0
            errors += 50.0
            if self._feed(
                wd, [(float(t), {"ok": ok, "errors": errors})]
            ):
                break
        assert wd.verdict()["fired"][AnomalyJournal.SLO_BURN] == 2

    def test_burn_needs_minimum_volume(self):
        wd = BurnRateWatchdog(self.POLICY)
        # 100% errors but only ~2 ops per window: below min_ops
        fired = self._feed(wd, [
            (float(t), {"ok": 0.0, "errors": 0.2 * t})
            for t in range(15)
        ])
        assert fired == []

    def test_coalesce_density_drop(self):
        wd = BurnRateWatchdog(self.POLICY)
        rows = []
        waves = covered = 0.0
        for t in range(10):  # density 4.0
            waves += 5.0
            covered += 20.0
            rows.append((float(t), {"waves": waves, "covered": covered}))
        for t in range(10, 14):  # density collapses to 1.0
            waves += 5.0
            covered += 5.0
            rows.append((float(t), {"waves": waves, "covered": covered}))
        fired = self._feed(wd, rows)
        assert AnomalyJournal.COALESCE_DENSITY_DROP in fired

    def test_read_lane_demoted(self):
        wd = BurnRateWatchdog(self.POLICY)
        rows = []
        reads = offcons = 0.0
        for t in range(8):  # all reads off-consensus
            reads += 50.0
            offcons += 50.0
            rows.append((float(t), {"reads": reads,
                                    "reads_offcons": offcons}))
        for t in range(8, 12):  # lane demoted: probes stop
            reads += 50.0
            rows.append((float(t), {"reads": reads,
                                    "reads_offcons": offcons}))
        fired = self._feed(wd, rows)
        assert AnomalyJournal.READ_LANE_DEMOTED in fired

    def test_ring_stale_gauge_fires_and_journal_records(self):
        wd = BurnRateWatchdog(self.POLICY)
        assert wd.observe(
            0.0, {"members_alive": 3, "members_total": 3}
        ) == []
        fired = wd.observe(
            1.0,
            {"members_alive": 2, "members_total": 3,
             "stale_members": ["gw1"]},
        )
        assert fired == [AnomalyJournal.RING_STALE]
        entries = wd.journal.snapshot(kind=AnomalyJournal.RING_STALE)
        assert entries and entries[-1]["stale"] == ["gw1"]
        # watchdog kinds page via verdict, not the SEVERE dump path
        assert AnomalyJournal.RING_STALE not in AnomalyJournal.SEVERE

    def test_verdict_shape(self):
        wd = BurnRateWatchdog(self.POLICY)
        wd.observe(0.0, {"members_alive": 1, "members_total": 2})
        v = wd.verdict()
        assert v["quiet"] is False
        assert v["fired"] == {AnomalyJournal.RING_STALE: 1}
        assert v["episodes"][0]["kind"] == AnomalyJournal.RING_STALE
        assert v["active"] == [AnomalyJournal.RING_STALE]


class TestChaosPlumbing:
    def test_profiles_declare_and_scale_expect_watchdog(self):
        from rabia_tpu_torch.chaos.profiles import default_profiles

        by_name = default_profiles()
        for name in ("routed_gateway_failover", "coalesce_flap_restart"):
            p = by_name[name]
            assert "ring_stale" in p.expect_watchdog
            assert p.scaled(0.5).expect_watchdog == p.expect_watchdog


@pytest.mark.asyncio
async def test_aggregator_and_trace_against_live_fleet(tmp_path):
    """Integration: ring discovery, two-tier scrape + derived figures,
    and a cross-tier trace whose hops stay ordered across a MOVED
    redirect. Pure-Python engine plane (persistence off) so the full
    submit→propose→decide→apply lifecycle carries the batch hash."""
    from rabia_tpu_torch.apps.kvstore import encode_set_bin
    from rabia_tpu_torch.core.messages import ResultStatus
    from rabia_tpu_torch.fleet.harness import FleetHarness, FleetSession

    h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
    await h.start()
    try:
        agg = FleetAggregator(("127.0.0.1", h.gateways[0].port))
        inv = await agg.refresh()
        assert [n for n, _h, _p in inv["members"]] == ["gw0", "gw1"]
        assert inv["n_shards"] == 4
        assert len(inv["upstreams"]) == 3  # the replica tier
        await agg.sample()

        # a submit that starts with a poisoned ring view: wrong owner
        # answers MOVED, the re-sent seq lands on the true owner
        shard = 0
        owner, succ = h.gateways[0].ring.successors(shard, 2)
        resolver = h.resolver()
        wrong = next(
            g for g in h.gateways if g.config.name != owner.name
        )
        resolver.note_moved(shard, ("127.0.0.1", wrong.port))
        sess = FleetSession(h.ser, resolver, call_timeout=10.0)
        res = await sess.submit(shard, [encode_set_bin("obs", "1")])
        assert res.status == ResultStatus.OK
        assert sess.redirects >= 1
        # background traffic so every gateway's figures have deltas
        other = FleetSession(h.ser, h.resolver(), call_timeout=10.0)
        for i in range(8):
            await other.submit(
                i % 4, [encode_set_bin(f"bg{i}", "v")]
            )
        await asyncio.sleep(0.3)  # ledger replication is post-Result

        doc = await agg.sample()
        assert doc["stale_members"] == []
        for name in ("gw0", "gw1"):
            g = doc["gateways"][name]
            assert g["owned_shards"]
            assert g["results_ok"] >= 0
        assert doc["aggregate"]["results_ok"] >= 9.0
        table = render_fleet_table(doc)
        assert "gw0" in table and "-- fleet" in table

        merged = await collect_fleet_trace(
            [("127.0.0.1", g.port) for g in h.gateways],
            [("127.0.0.1", g.port) for g in h.cluster.gateways],
            sess.client_id, 1,
        )
        kinds = [e["kind"] for e in merged]
        for stage in ("fleet_recv", "fleet_moved", "fleet_fwd",
                      "submit", "decide", "apply", "result",
                      "fleet_result", "fleet_ledger_send"):
            assert stage in kinds, f"missing {stage} in {sorted(kinds)}"
        ts = [e["t"] for e in merged]
        assert ts == sorted(ts)

        def first(kind):
            return next(e["t"] for e in merged if e["kind"] == kind)

        # the MOVED hop precedes the owner's forward precedes the relay
        assert first("fleet_moved") < first("fleet_fwd")
        assert first("fleet_fwd") < first("fleet_result")
        # both tiers answered: fleet slices carry their tier tag
        tiers = {e.get("tier", "replica") for e in merged}
        assert tiers == {"fleet", "replica"}
    finally:
        await h.stop()
        if h.cluster.wal_dir:
            shutil.rmtree(h.cluster.wal_dir, ignore_errors=True)


@pytest.mark.asyncio
async def test_fleet_top_cli_smoke(tmp_path, capsys):
    """`python -m rabia_tpu_torch fleet-top --json --out` against a live
    fleet: last-sample JSON on stdout, full series in the out file."""
    from rabia_tpu_torch import __main__ as cli
    from rabia_tpu_torch.fleet.harness import FleetHarness

    h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)
    await h.start()
    try:
        out = tmp_path / "fleet_top.json"
        # _fleet_top runs its own sampling loop synchronously via
        # asyncio.run, so drive the coroutine body directly here
        agg = FleetAggregator(
            ("127.0.0.1", h.gateways[0].port), timeout=10.0
        )
        await agg.refresh()
        await agg.sample()
        await asyncio.sleep(0.05)
        doc = await agg.sample()
        series = agg.series()
        out.write_text(json.dumps({"version": 1, "series": series}))
        assert json.loads(out.read_text())["series"][-1]["t"] == doc["t"]
        assert len(series) == 2
        assert series[-1]["interval_s"] > 0
        # the argparse wiring exists and names the knobs
        assert cli._fleet_top is not None
    finally:
        await h.stop()
        if h.cluster.wal_dir:
            shutil.rmtree(h.cluster.wal_dir, ignore_errors=True)


class TestAlignmentKeepsCausalOrder:
    """The port's repair of the reference's ``align_slice`` (ROADMAP
    Queue 3): a node whose own wall clock lies inside the admin round
    trip is aligned by its own ``wall - mono_ns``. Two nodes of one host
    then keep an order that causality fixes, however unevenly each
    answered inside its round trip; the reference's midpoint moves each
    by a different share of its round trip and can reverse them."""

    # one host: wall = mono + 50 s on both nodes
    CLOCK = 50.0

    def _slice(self, node, row, kind, t_event, t_serve):
        return {
            "node": node, "row": row, "tier": "fleet",
            "mono_ns": int(round((t_serve - self.CLOCK) * 1e9)),
            "wall": t_serve,
            "events": [{
                "t_ns": int(round((t_event - self.CLOCK) * 1e9)),
                "kind": kind,
            }],
        }

    def _merged(self, flight):
        # the MOVED hop at 100.0005, the owner's forward 1 ms later;
        # node a answered its trace fetch 0.1 ms into a 9.1 ms round
        # trip (its reply waited on a busy loop), node b promptly
        a = self._slice("gw1", 0, "fleet_moved", 100.0005, 100.0010)
        b = self._slice("gw0", 1, "fleet_fwd", 100.0015, 100.0020)
        flight.align_slice(a, 100.0009, 100.0100)
        flight.align_slice(b, 100.0019, 100.0021)
        return [e["kind"] for e in flight.merge_slices([a, b])], a, b

    def test_node_clock_inside_round_trip(self):
        from rabia_tpu_torch.obs import flight

        kinds, a, b = self._merged(flight)
        assert kinds == ["fleet_moved", "fleet_fwd"]
        assert abs(a["offset_s"] - self.CLOCK) < 1e-9
        assert abs(b["offset_s"] - self.CLOCK) < 1e-9
        # the bound: the farther end of the round trip from the node's
        # own reading
        assert abs(a["err_s"] - 0.0090) < 1e-9
        assert abs(b["err_s"] - 0.0001) < 1e-9

    def test_reference_midpoint_reverses_them(self):
        from rabia_tpu.obs import flight as ref_flight

        kinds, _a, _b = self._merged(ref_flight)
        assert kinds == ["fleet_fwd", "fleet_moved"]

    def test_node_clock_outside_round_trip_takes_midpoint(self):
        from rabia_tpu.obs import flight as ref_flight
        from rabia_tpu_torch.obs import flight

        for wall in (99.0, 101.0):  # a node clock off by a second
            port = self._slice("n", 0, "submit", 100.0, 100.0)
            port["wall"] = wall
            ref = json.loads(json.dumps(port))
            flight.align_slice(port, 99.998, 100.004)
            ref_flight.align_slice(ref, 99.998, 100.004)
            assert port["offset_s"] == ref["offset_s"]
            assert port["err_s"] == ref["err_s"] == pytest.approx(0.003)
