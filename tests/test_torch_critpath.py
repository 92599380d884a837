"""Critical-path decomposition gates (rabia_tpu_torch/obs/critpath).

- segment math against hand-built flight captures: exact tiling of the
  full fleet->gateway->consensus->durability pipeline, MOVED redirect
  hops, overlapping-ring advance dedup + contiguous-chain cutoff,
  missing-mark honesty (unattributed, never a neighbouring segment),
  cross-node clock reorder clamping;
- slowlog reservoir mechanics: bounded slowest-first windows, floor
  fast path, rotation retention, exemplar age stamps;
- dwell-histogram geometry: the native RK_DWELL block's exported
  geometry must equal the registry's SLO bucket constants (the
  decomposer's consensus segments sit next to those rows);
- the acceptance end-to-end: a live 3-replica TCP gateway cluster's
  slowlog exemplars decompose in-process with bounded unattributed
  time, and the dwell metric family exposes identical label sets on the
  native and ``RABIA_PY_TICK=1`` planes.

The port's copy of the reference's tests/test_critpath.py, the slowlog
command line (``python -m rabia_tpu_torch slowlog``) included.
"""

from __future__ import annotations

import asyncio
import time

import pytest

from rabia_tpu_torch.obs.critpath import (
    PHASE_CLAMP,
    SEGMENT_ORDER,
    CritpathAggregator,
    decompose,
    decompose_exemplars,
    dominant_segment,
    inprocess_exemplar_timeline,
    render_slowlog,
    render_waterfall,
    segment_names,
)

MS = 1e-3


def ev(kind, t, row=0, shard=0, slot=5, arg=0, truncated=False,
       err_s=0.0):
    """One merged-timeline entry, the shape ``merge_slices`` emits."""
    return {
        "kind": kind, "t": t, "t_ns": int(t * 1e9), "row": row,
        "shard": shard, "slot": slot, "arg": arg,
        "truncated": truncated, "err_s": err_s, "node": f"n{row}",
    }


def full_pipeline_timeline():
    """A hand-built capture of the whole path: fleet tier with one
    MOVED redirect (two forward hops), coalesced gateway drive, a
    3-phase decide, WAL barrier, fleet relay and ledger replication.
    Segment values are chosen so the tiling is exact and distinct."""
    return [
        ev("fleet_recv", 0.000),
        ev("fleet_moved", 0.001),
        ev("fleet_fwd", 0.002),
        ev("fleet_fwd", 0.004),        # last hop ends fleet_routing
        ev("gw_recv", 0.006, arg=1),   # arg=1: coalesced drive
        ev("submit", 0.010),
        ev("propose", 0.0105),         # binds proposer row 0, slot 5
        ev("open", 0.011),
        ev("advance", 0.013, arg=1),
        ev("advance", 0.014, arg=2),
        ev("step_decide", 0.016),
        ev("apply", 0.018),
        ev("barrier", 0.022),
        ev("result", 0.024),
        ev("fleet_result", 0.026),
        ev("fleet_ledger_send", 0.030),
    ]


class TestSegmentMath:
    def test_full_pipeline_tiles_exactly(self):
        d = decompose(full_pipeline_timeline(), wall_s=0.031)
        assert d["ok"] and not d["truncated"]
        s = d["segments"]
        assert s["fleet_routing"] == pytest.approx(4 * MS)
        assert s["gateway_queue"] == pytest.approx(2 * MS)
        assert s["coalesce_park"] == pytest.approx(4 * MS)
        assert s["propose_to_open"] == pytest.approx(1 * MS)
        assert s["consensus_phase_1"] == pytest.approx(2 * MS)
        assert s["consensus_phase_2"] == pytest.approx(1 * MS)
        # step_decide closes the FINAL phase: 2 advances + 1
        assert s["consensus_phase_3"] == pytest.approx(2 * MS)
        assert d["phases_to_decide"] == 3
        assert s["decide_to_apply"] == pytest.approx(2 * MS)
        assert s["fsync_barrier"] == pytest.approx(4 * MS)
        # barrier -> result plus the result -> fleet relay
        assert s["result_fanout"] == pytest.approx(4 * MS)
        assert s["ledger_replication"] == pytest.approx(4 * MS)
        assert d["total_s"] == pytest.approx(30 * MS)
        assert d["unattributed_s"] == pytest.approx(0.0)
        assert d["moved_hops"] == 1
        assert d["coalesced"] is True
        assert d["proposer_row"] == 0 and d["slot"] == [0, 5]
        assert sum(s.values()) == pytest.approx(d["total_s"])

    def test_uncoalesced_no_fleet_no_barrier(self):
        """Single-gateway, WAL off: recv->submit counts as queue (not
        park), fanout anchors on apply, fleet segments absent."""
        tl = [
            ev("gw_recv", 0.000, arg=0),
            ev("submit", 0.003),
            ev("propose", 0.0035),
            ev("open", 0.004),
            ev("step_decide", 0.006),   # 1-phase decide, no advance
            ev("apply", 0.007),
            ev("result", 0.009),
        ]
        d = decompose(tl)
        s = d["segments"]
        assert s["gateway_queue"] == pytest.approx(3 * MS)
        assert "coalesce_park" not in s
        assert s["consensus_phase_1"] == pytest.approx(2 * MS)
        assert d["phases_to_decide"] == 1
        assert "fsync_barrier" not in s
        assert s["result_fanout"] == pytest.approx(2 * MS)
        for absent in ("fleet_routing", "ledger_replication"):
            assert absent not in s
        assert d["unattributed_s"] == pytest.approx(0.0)

    def test_missing_mark_goes_unattributed(self):
        """Dropping the open mark must not fold the spanned time into a
        neighbouring segment — it becomes explicit unattributed."""
        tl = [e for e in full_pipeline_timeline()
              if e["kind"] not in ("open", "advance")]
        d = decompose(tl)
        s = d["segments"]
        assert "propose_to_open" not in s
        assert not any(k.startswith("consensus_phase") for k in s)
        # submit(10ms) -> step_decide(16ms) is now unaccounted
        assert d["unattributed_s"] == pytest.approx(6 * MS)
        assert d["total_s"] == pytest.approx(30 * MS)
        assert sum(s.values()) + d["unattributed_s"] == pytest.approx(
            d["total_s"]
        )

    def test_clock_reorder_clamps_never_negative(self):
        """A cross-node mark aligned EARLIER than its causal
        predecessor collapses that segment to zero; the tiling stays
        exact (no negative time, no double counting)."""
        tl = full_pipeline_timeline()
        for e in tl:
            if e["kind"] == "barrier":
                e["t"] = 0.017  # before apply (0.018): skewed clock
                e["err_s"] = 0.002
        d = decompose(tl)
        s = d["segments"]
        assert s["fsync_barrier"] == pytest.approx(0.0)
        assert all(v >= 0.0 for v in s.values())
        assert d["err_s"] == pytest.approx(0.002)
        assert sum(s.values()) + d["unattributed_s"] == pytest.approx(
            d["total_s"]
        )

    def test_overlapping_rings_dedup_and_contiguity(self):
        """Overlapping rings can retain the same logical advance twice
        (dedup keeps the first) and can DROP a boundary (the chain cuts
        at the gap — an orphaned tail would mis-label dwell)."""
        tl = full_pipeline_timeline()
        tl.insert(9, ev("advance", 0.0135, arg=1))  # duplicate ordinal
        d = decompose(tl)
        assert d["segments"]["consensus_phase_1"] == pytest.approx(
            2 * MS
        )
        assert d["phases_to_decide"] == 3
        # now a gap: advances 1 and 3 observed, 2 lost to a wrap
        tl2 = [e for e in full_pipeline_timeline()
               if not (e["kind"] == "advance" and e["arg"] == 2)]
        tl2.insert(9, ev("advance", 0.015, arg=3))
        d2 = decompose(tl2)
        segs = [k for k in d2["segments"]
                if k.startswith("consensus_phase")]
        # only the contiguous prefix (phase 1) plus the closing phase
        assert "consensus_phase_1" in segs
        assert "consensus_phase_3" not in segs
        assert d2["phases_to_decide"] == 2

    def test_foreign_row_marks_ignored(self):
        """Consensus marks from non-proposer rows (every replica runs
        the slot) must not contaminate the proposer's chain."""
        tl = full_pipeline_timeline()
        tl.append(ev("advance", 0.0132, row=1, arg=1))
        tl.append(ev("step_decide", 0.0155, row=2))
        d = decompose(tl)
        assert d["segments"]["consensus_phase_1"] == pytest.approx(
            2 * MS
        )
        assert d["segments"]["consensus_phase_3"] == pytest.approx(
            2 * MS
        )

    def test_truncated_ring_display_not_aggregate(self):
        tl = full_pipeline_timeline()
        tl[0]["truncated"] = True
        d = decompose(tl)
        assert d["ok"] and d["truncated"]
        agg = CritpathAggregator()
        assert agg.add(d) is False
        assert agg.truncated_total == 1
        assert agg.summary()["segments"] == {}
        d2 = decompose(full_pipeline_timeline())
        assert agg.add(d2) is True
        assert agg.summary()["segments"][
            "consensus_phase_1"
        ] == pytest.approx(2 * MS)
        # the waterfall still renders truncated exemplars, with the
        # warning attached
        assert "ring wrapped" in render_waterfall(d)

    def test_empty_timeline_not_ok(self):
        d = decompose([])
        assert d["ok"] is False
        assert dominant_segment(d) is None
        agg = CritpathAggregator()
        assert agg.add(d) is False
        assert agg.unanchored_total == 1

    def test_segment_name_universe(self):
        names = segment_names()
        assert names[-1] == "unattributed"
        for base in SEGMENT_ORDER:
            if base == "consensus":
                continue
            assert base in names
        for p in range(1, PHASE_CLAMP):
            assert f"consensus_phase_{p}" in names
        assert f"consensus_phase_{PHASE_CLAMP}+" in names
        assert f"consensus_phase_{PHASE_CLAMP}" not in names

    def test_dominant_includes_unattributed(self):
        tl = [e for e in full_pipeline_timeline()
              if e["kind"] not in ("open", "advance", "step_decide",
                                   "apply", "barrier")]
        d = decompose(tl)
        assert dominant_segment(d) == "unattributed"


class TestSlowlogReservoir:
    def _mk(self, cap=4, window=100.0):
        from rabia_tpu_torch.gateway.server import _SlowlogReservoir

        return _SlowlogReservoir(cap, window)

    def test_keeps_slowest_bounded(self):
        r = self._mk(cap=4)
        for i in range(20):
            r.observe((i + 1) * MS, {"batch": f"b{i}"})
        doc = r.document()
        walls = [e["wall_s"] for e in doc["exemplars"]]
        assert walls == [20 * MS, 19 * MS, 18 * MS, 17 * MS]
        assert doc["observed"] == 20
        assert doc["cap"] == 4
        # the floor fast path: a fast completion never evicts
        r.observe(0.5 * MS, {"batch": "fast"})
        assert len(r.document()["exemplars"]) == 4
        assert all(
            e["batch"] != "fast" for e in r.document()["exemplars"]
        )

    def test_rotation_retains_previous_window(self):
        r = self._mk(cap=4, window=0.05)
        r.observe(9 * MS, {"batch": "old"})
        time.sleep(0.06)
        r.observe(3 * MS, {"batch": "new"})
        doc = r.document()
        assert r.rotations >= 1
        batches = {e["batch"] for e in doc["exemplars"]}
        assert batches == {"old", "new"}  # cur + one previous window

    def test_exemplar_age_stamps(self):
        r = self._mk()
        r.observe(5 * MS, {"batch": "a"})
        time.sleep(0.02)
        doc = r.document()
        age = doc["exemplars"][0]["age_s"]
        assert 0.0 <= age < 5.0
        assert age >= 0.02 - 1e-9

    def test_last_limit_and_disable(self):
        r = self._mk(cap=4)
        for i in range(4):
            r.observe((i + 1) * MS, {"batch": f"b{i}"})
        assert len(r.document(2)["exemplars"]) == 2
        off = self._mk(cap=0)
        off.observe(1.0, {"batch": "x"})
        assert off.document()["exemplars"] == []


class TestDwellGeometry:
    def test_native_block_matches_registry_slo_buckets(self):
        """The decomposer's consensus segments are cross-checked against
        consensus_phase_dwell_seconds — which merges the native RK_DWELL
        block 1:1 only if the exported geometry equals the registry's
        SLO constants."""
        from rabia_tpu_torch.native.build import load_hostkernel
        from rabia_tpu_torch.obs.registry import (
            SLO_MIN_EXP,
            SLO_OCTAVES,
            SLO_SUB_BITS,
        )

        lib = load_hostkernel()
        if lib is None or not hasattr(lib, "rk_dwell"):
            pytest.skip("native hostkernel dwell block unavailable")
        assert int(lib.rk_dwell_sub_bits()) == SLO_SUB_BITS
        assert int(lib.rk_dwell_min_exp()) == SLO_MIN_EXP
        assert int(lib.rk_dwell_buckets()) == (
            SLO_OCTAVES << SLO_SUB_BITS
        )
        assert int(lib.rk_dwell_phases()) == PHASE_CLAMP
        assert int(lib.rk_dwell_version()) >= 1


async def _run_slowlog_cluster(via_cli: bool = False):
    """Drive a 3-replica TCP gateway cluster, then decompose its
    slowlog exemplars in-process. Returns (decomps, dwell label keys)
    so plane-parity tests can compare metric universes."""
    from rabia_tpu_torch.apps.kvstore import encode_set_bin
    from rabia_tpu_torch.gateway.client import RabiaClient
    from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

    cluster = GatewayCluster(n_replicas=3, n_shards=2)
    await cluster.start()
    client = None
    try:
        client = RabiaClient(cluster.endpoints())
        await client.connect()
        for i in range(8):
            resp = await client.submit(
                i % 2, [encode_set_bin(f"cp{i}", "v")]
            )
            assert resp
        exemplars = []
        for g in cluster.gateways:
            exemplars.extend(
                g.slowlog.document().get("exemplars", [])
            )
        assert exemplars, "no slowlog exemplars captured"
        if via_cli:
            from rabia_tpu_torch.__main__ import main as cli_main

            addrs = [f"127.0.0.1:{g.port}" for g in cluster.gateways]
            rc = await asyncio.to_thread(
                cli_main,
                ["slowlog", addrs[0],
                 *[a for ad in addrs for a in ("--replicas", ad)],
                 "--last", "4"],
            )
            assert rc == 0
            return [], set()
        engines = list(cluster.engines)
        agg = CritpathAggregator()
        decomps = decompose_exemplars(
            exemplars,
            lambda ex: inprocess_exemplar_timeline(engines, ex),
            aggregator=agg,
        )
        good = [
            d for d in decomps if d["ok"] and not d["truncated"]
        ]
        assert good, "no exemplar decomposed cleanly"
        worst = max(good, key=lambda d: d["total_s"])
        assert worst["unattributed_frac"] < 0.5
        assert dominant_segment(worst) is not None
        assert agg.summary()["exemplars"] == len(decomps)
        out = render_slowlog(
            {"node": "gw0", "observed": 8, "window_s": 10.0},
            sorted(decomps,
                   key=lambda d: -(d.get("wall_s") or 0.0)),
        )
        assert "worst exemplar" in out
        dwell_keys = set()
        for eng in engines:
            for key in eng.metrics.snapshot():
                if "consensus_phase_dwell_seconds" in key:
                    dwell_keys.add(key.split("_bucket")[0])
        return decomps, dwell_keys
    finally:
        if client is not None:
            await client.close()
        await cluster.stop()


@pytest.mark.asyncio
class TestCritpathLive:
    async def test_exemplars_decompose_in_process(self):
        await _run_slowlog_cluster()

    async def test_slowlog_cli_end_to_end(self):
        await _run_slowlog_cluster(via_cli=True)

    async def test_dwell_names_parity_python_planes(self, monkeypatch):
        """The native tick and the RABIA_PY_TICK=1 / RABIA_PY_GATEWAY=1
        twins must expose the SAME consensus_phase_dwell_seconds label
        universe — segment attribution that only exists on one plane
        would make waterfalls non-comparable across deployments."""
        _, native_keys = await _run_slowlog_cluster()
        monkeypatch.setenv("RABIA_PY_TICK", "1")
        monkeypatch.setenv("RABIA_PY_GATEWAY", "1")
        decomps, py_keys = await _run_slowlog_cluster()
        assert native_keys == py_keys
        assert any(d["ok"] for d in decomps)


# ---------------------------------------------------------------------------
# Across packages: the port's decomposition against the reference's
# ---------------------------------------------------------------------------

US = 1e-6  # the tolerance: segments agree to the microsecond


def _same_decomposition(a: dict, b: dict) -> None:
    assert a["ok"] == b["ok"] and a["truncated"] == b["truncated"]
    assert set(a["segments"]) == set(b["segments"])
    for k, v in a["segments"].items():
        assert abs(v - b["segments"][k]) <= US, k
    for k in ("total_s", "unattributed_s", "err_s"):
        if k in a or k in b:
            assert abs(a[k] - b[k]) <= US, k
    for k in ("phases_to_decide", "moved_hops", "coalesced",
              "proposer_row", "slot"):
        assert a.get(k) == b.get(k), k


class TestAcrossPackages:
    def test_hand_built_timelines_decompose_alike(self):
        """The hand-built captures of this file, and variants with marks
        dropped, reordered or truncated, through both packages'
        ``decompose`` and ``CritpathAggregator``."""
        from rabia_tpu.obs import critpath as ref

        cases = [full_pipeline_timeline()]
        cases.append([e for e in full_pipeline_timeline()
                      if e["kind"] not in ("open", "advance")])
        skew = full_pipeline_timeline()
        skew[12]["t"], skew[12]["err_s"] = 0.017, 0.002
        cases.append(skew)
        trunc = full_pipeline_timeline()
        trunc[0]["truncated"] = True
        cases.append(trunc)
        cases.append(full_pipeline_timeline() + [
            ev("advance", 0.0132, row=1, arg=1),
            ev("step_decide", 0.0155, row=2),
        ])
        cases.append([])
        agg, ref_agg = CritpathAggregator(), ref.CritpathAggregator()
        for tl in cases:
            for wall in (None, 0.031):
                got = decompose(tl, wall_s=wall)
                want = ref.decompose(tl, wall_s=wall)
                _same_decomposition(got, want)
                assert dominant_segment(got) == ref.dominant_segment(want)
                assert agg.add(got) == ref_agg.add(want)
        assert segment_names() == ref.segment_names()
        s, r = agg.summary(), ref_agg.summary()
        assert {k: v for k, v in s.items() if k != "segments"} == {
            k: v for k, v in r.items() if k != "segments"}
        assert set(s["segments"]) == set(r["segments"])
        for k, v in s["segments"].items():
            assert abs(v - r["segments"][k]) <= US, k

    @pytest.mark.asyncio
    async def test_live_exemplars_and_slices_decompose_alike(self):
        """One live cluster's slowlog exemplars and flight slices (the
        port's), merged and decomposed by each package: equal segments
        to the microsecond."""
        from rabia_tpu.obs import critpath as ref
        from rabia_tpu.obs import flight as ref_flight
        from rabia_tpu_torch.apps.kvstore import encode_set_bin
        from rabia_tpu_torch.gateway.client import RabiaClient
        from rabia_tpu_torch.obs import flight
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster
        import copy
        import uuid

        cluster = GatewayCluster(n_replicas=3, n_shards=2)
        await cluster.start()
        client = None
        try:
            client = RabiaClient(cluster.endpoints())
            await client.connect()
            for i in range(12):
                assert await client.submit(i % 2, [encode_set_bin(f"x{i}", "v")])
            exemplars = [
                ex for g in cluster.gateways
                for ex in g.slowlog.document().get("exemplars", [])
            ]
            assert exemplars
            compared = 0
            for ex in exemplars:
                slices = []
                for h in ("batch", "wave"):
                    if not ex.get(h):
                        continue
                    bh = flight.fr_hash(uuid.UUID(hex=ex[h]))
                    for eng in cluster.engines:
                        sl = flight.build_trace_slice(eng, bh)
                        sl["offset_s"] = sl["wall"] - sl["mono_ns"] * 1e-9
                        sl["err_s"] = 0.0
                        slices.append(sl)
                got_tl = flight.merge_slices(copy.deepcopy(slices))
                want_tl = ref_flight.merge_slices(copy.deepcopy(slices))
                assert got_tl == want_tl
                kw = dict(coalesced=ex.get("coalesced"), wall_s=ex.get("wall_s"))
                got, want = decompose(got_tl, **kw), ref.decompose(want_tl, **kw)
                _same_decomposition(got, want)
                compared += got["ok"]
            assert compared, "no exemplar decomposed"
            engines = list(cluster.engines)
            # each exemplar's timeline is built once and both packages
            # decompose copies of it: a timeline built anew samples the
            # wall and monotonic clocks anew, and a thread preempted
            # between the two reads shifts that node's offset by more
            # than the tolerance
            timelines = {
                id(e): inprocess_exemplar_timeline(engines, e) for e in exemplars
            }
            agg, ref_agg = CritpathAggregator(), ref.CritpathAggregator()
            got = decompose_exemplars(
                exemplars, lambda e: copy.deepcopy(timelines[id(e)]), agg)
            want = ref.decompose_exemplars(
                exemplars, lambda e: copy.deepcopy(timelines[id(e)]), ref_agg)
            for a, b in zip(got, want):
                _same_decomposition(a, b)
            s, r = agg.summary(), ref_agg.summary()
            assert s["exemplars"] == r["exemplars"] == len(exemplars)
            assert set(s["segments"]) == set(r["segments"])
            for k, v in s["segments"].items():
                assert abs(v - r["segments"][k]) <= US, k
        finally:
            if client is not None:
                await client.close()
            await cluster.stop()

    @pytest.mark.parametrize("seed", [0, 1])
    def test_ring_event_conversion_matches_reference(self, seed):
        """The port's column-wise conversion of the native and transport
        flight rings gives the reference's per-record dicts, value for
        value and type for type (unknown kinds, extreme values)."""
        import numpy as np

        from rabia_tpu.obs import flight as ref_flight
        from rabia_tpu_torch.obs import flight

        rng = np.random.default_rng(seed)
        for dtype, fn in ((flight.FR_DTYPE, "native_ring_events"),
                          (flight.TF_DTYPE, "transport_ring_events")):
            rec = np.zeros(777, dtype)
            for name in dtype.names:
                info = np.iinfo(dtype[name])
                rec[name] = rng.integers(info.min, info.max, 777, dtype=np.int64,
                                         endpoint=True) if info.bits < 64 else (
                    rng.integers(0, 2**62, 777, dtype=np.int64))
            got = getattr(flight, fn)(rec)
            want = getattr(ref_flight, fn)(rec)
            assert got == want
            assert [[type(v) for v in e.values()] for e in got] == [
                [type(v) for v in e.values()] for e in want]
