#!/usr/bin/env python
"""Fleet-observability CI smoke on the PyTorch/CUDA port: aggregator
cross-check + one end-to-end cross-tier trace.

The counterpart of ``scripts/fleet_obs_smoke.py`` over ``rabia_tpu_torch``:
the same run, cross-check, trace stages, artifacts and exit codes.
Host-only: it reads no device. It records nothing into the repo: the
report goes with the artifacts into ``--out-dir`` (under ``build/`` by
default), and ``--no-record`` is accepted for the reference's interface.

Spins a routed fleet (2 fleet gateways fronting a 3-replica real-TCP
cluster on the WAL durability plane, coalescing window pinned), then:

1. drives a short multi-session run in which ONE session starts with a
   poisoned ring view (``resolver.note_moved``) so its first Submit is
   guaranteed to cross a MOVED redirect, and is parked FIRST into a
   pinned coalescing window that three more sessions then join — the
   Submit under trace is the lead of a genuine multi-client wave;
2. samples a ring-discovered :class:`~rabia_tpu_torch.obs.fleet_obs.
   FleetAggregator` around the run and CROSS-CHECKS its per-gateway
   coalesce-density and slots/op figures (derived from scraped
   ``rabia_coalesce_shard_total`` deltas over admin frames) against the
   loadgen-side computation (:func:`fleet_coalesce_columns`, the
   load generator's recipe, over the in-process counters) — two
   independent paths, one math, tolerance enforced;
3. collects the cross-tier trace for the MOVED Submit's
   ``(client_id, seq)`` from BOTH tiers and fails unless every expected
   stage is present (fleet recv, MOVED redirect, fleet forward, replica
   submit/propose/decide/apply/result, fleet result, ledger
   replication) and the aligned timeline is monotonically ordered;
4. writes the fleet-top series, the rendered trace and the report as
   artifacts.

Usage: python scripts/torch_fleet_obs_smoke.py [--out-dir DIR] [--no-record]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rabia_tpu_torch.core.messages import ResultStatus  # noqa: E402

# stages the rendered end-to-end trace must contain (flight kind
# names). No "propose" on the WAL plane: the native runtime binds the
# wave to its slots on the C thread and the propose shows as the wire
# frame (tf_out) rather than a batch-keyed event; "result" is only
# relayed after the durability barrier, so its presence IS the barrier
# crossing.
REQUIRED_STAGES = (
    "fleet_recv", "fleet_moved", "fleet_fwd",  # routing tier
    "submit", "decide", "apply", "result",  # consensus tier
    "fleet_result", "fleet_ledger_send",  # relay + dedup replication
)

# |scraped - in-process| tolerance for the derived figures: absolute
# 0.05 or 10% relative, whichever is looser (the scrape brackets are a
# few ms wider than the in-process snapshots)
ABS_TOL = 0.05
REL_TOL = 0.10


_COAL_FIELDS = ("waves", "covered", "solo", "scalar", "results_ok")


def fleet_coalesce_columns(
    gateways: list, coal_before: dict, coal_after: dict
) -> dict:
    """Per-fleet-gateway coalesce figures from the REPLICA tier's
    per-shard counter deltas, grouped by ring ownership (the load
    generator's recipe, ``benchmarks/loadgen.py``'s function of this
    name, kept here so the port imports nothing of the JAX package).

    ``gateways``: ``[{"name", "owned_shards_list"}, ...]``;
    ``coal_before``/``coal_after``: ``{shard: {field: cumulative}}``
    sampled around the run. Returns ``{name: {waves, covered, solo,
    scalar, results_ok, coalesce_density, slots_per_op}}`` — the SAME
    recipes the fleet aggregator derives from scraped
    ``rabia_coalesce_shard_total`` deltas
    (obs/fleet_obs.derive_gateway_figures), computed from the in-process
    counters so the two independent paths cross-check."""
    out: dict[str, dict] = {}
    for g in gateways:
        fig = {f: 0 for f in _COAL_FIELDS}
        for s in g.get("owned_shards_list", []):
            a = coal_after.get(s, {})
            b = coal_before.get(s, {})
            for f in _COAL_FIELDS:
                fig[f] += int(a.get(f, 0)) - int(b.get(f, 0))
        slots = fig["waves"] + fig["scalar"]
        out[g["name"]] = {
            **fig,
            "coalesce_density": (
                round(fig["covered"] / fig["waves"], 4)
                if fig["waves"] > 0 else None
            ),
            "slots_per_op": (
                round(slots / fig["results_ok"], 4)
                if fig["results_ok"] > 0 else None
            ),
        }
    return out


def _close(a, b) -> bool:
    if a is None or b is None:
        return a == b
    return abs(a - b) <= max(ABS_TOL, REL_TOL * max(abs(a), abs(b)))


async def _run(out_dir: Path) -> dict:
    from rabia_tpu_torch.apps.kvstore import encode_set_bin
    from rabia_tpu_torch.fleet.harness import FleetHarness, FleetSession
    from rabia_tpu_torch.gateway import GatewayConfig
    from rabia_tpu_torch.obs.fleet_obs import FleetAggregator, collect_fleet_trace
    from rabia_tpu_torch.obs.flight import render_timeline

    problems: list[str] = []
    h = FleetHarness(
        n_gateways=2,
        n_replicas=3,
        n_shards=4,
        persistence="wal",
        # long pinned window: the smoke COMPOSES a wave by hand (lead
        # parked first, three joiners inside the same window), so the
        # window must outlast the MOVED round trip plus the joiner burst
        gateway_config=GatewayConfig(
            coalesce=True, coalesce_window=0.25, coalesce_window_min=0.25
        ),
    )
    await h.start()
    try:
        seed = ("127.0.0.1", h.gateways[0].port)
        agg = FleetAggregator(seed, timeout=10.0)
        inv = await agg.refresh()
        if len(inv["members"]) != 2 or not inv["upstreams"]:
            problems.append(
                f"discovery: expected 2 ring members + upstreams, got {inv}"
            )
        await agg.sample()  # baseline (prev for the delta window)

        def coal_now() -> dict:
            out: dict[int, dict] = {}
            for g in h.cluster.gateways:
                if g is None:
                    continue
                for shard, cs in g.coal_shard_stats.items():
                    dst = out.setdefault(shard, {})
                    for k, v in cs.items():
                        dst[k] = dst.get(k, 0) + int(v)
            return out

        coal_before = coal_now()

        # -- the traced Submit: MOVED hop, then lead of a real wave ----
        ring = h.gateways[h.live_indices()[0]].ring
        shard = 0
        owner, succ = ring.successors(shard, 2)
        resolver = h.resolver()
        resolver.note_moved(shard, (succ.host, succ.port))  # poison
        moved_sess = FleetSession(h.ser, resolver, call_timeout=10.0)
        joiners = [
            FleetSession(h.ser, h.resolver(), call_timeout=10.0)
            for _ in range(3)
        ]
        lead_fut = asyncio.ensure_future(
            moved_sess.submit(shard, [encode_set_bin("obs-lead", "1")])
        )
        # the lead needs the MOVED round trip before it parks; give it
        # that, then land the joiners well inside the 250ms window
        await asyncio.sleep(0.08)
        join_res = await asyncio.gather(
            *(
                s.submit(shard, [encode_set_bin(f"obs-j{i}", "1")])
                for i, s in enumerate(joiners)
            )
        )
        lead_res = await lead_fut
        trace_client, trace_seq = moved_sess.client_id, 1
        if lead_res.status != ResultStatus.OK:
            problems.append(f"traced submit failed: {lead_res.status}")
        if moved_sess.redirects < 1:
            problems.append("traced submit never crossed a MOVED redirect")
        if any(r.status != ResultStatus.OK for r in join_res):
            problems.append("wave joiner submit failed")

        # -- background load across every shard (both gateways' shards
        # see traffic, so every per-gateway figure has a denominator) --
        load = [
            FleetSession(h.ser, h.resolver(), call_timeout=10.0)
            for _ in range(8)
        ]
        for rnd in range(6):
            await asyncio.gather(
                *(
                    s.submit(
                        i % 4, [encode_set_bin(f"bg{rnd}-{i}", "v")]
                    )
                    for i, s in enumerate(load)
                )
            )
        # ledger replication to ring successors is post-Result async
        await asyncio.sleep(0.4)

        coal_after = coal_now()
        sample = await agg.sample()  # the delta window over the run

        # -- cross-check: scraped-and-derived vs in-process ------------
        gws_doc = []
        for name, g in sorted(sample["gateways"].items()):
            if g.get("stale"):
                problems.append(f"aggregator marked {name} stale")
        fleet_health = [
            {
                "name": gw.config.name,
                "owned_shards_list": list(
                    gw.ring.owned_shards(gw.config.name, 4)
                ),
            }
            for gw in h.gateways
            if gw is not None
        ]
        local = fleet_coalesce_columns(fleet_health, coal_before, coal_after)
        for name, fig in sorted(local.items()):
            scraped = sample["gateways"].get(name, {})
            row = {
                "gateway": name,
                "loadgen_density": fig["coalesce_density"],
                "scraped_density": scraped.get("coalesce_density"),
                "loadgen_slots_per_op": fig["slots_per_op"],
                "scraped_slots_per_op": scraped.get("slots_per_op"),
            }
            gws_doc.append(row)
            for a, b, what in (
                (fig["coalesce_density"], scraped.get("coalesce_density"),
                 "coalesce_density"),
                (fig["slots_per_op"], scraped.get("slots_per_op"),
                 "slots_per_op"),
            ):
                if not _close(a, b):
                    problems.append(
                        f"crosscheck {name} {what}: loadgen-side {a} vs "
                        f"aggregator {b} (tol {ABS_TOL}/{REL_TOL:.0%})"
                    )
        wave_fig = local.get(
            next(
                (n for n, f in local.items() if (f["covered"] or 0) >= 4),
                "",
            )
        )
        if wave_fig is None:
            problems.append(
                "no gateway shows the composed 4-client wave "
                f"(columns: {local})"
            )

        # -- cross-tier trace ------------------------------------------
        fleet_addrs = [
            ("127.0.0.1", gw.port) for gw in h.gateways if gw is not None
        ]
        replica_addrs = [
            ("127.0.0.1", g.port)
            for g in h.cluster.gateways
            if g is not None
        ]
        merged = await collect_fleet_trace(
            fleet_addrs, replica_addrs, trace_client, trace_seq
        )
        stages = {e["kind"] for e in merged}
        missing = [s for s in REQUIRED_STAGES if s not in stages]
        if missing:
            problems.append(
                f"trace missing stages {missing} (has {sorted(stages)})"
            )
        ts = [e["t"] for e in merged]
        if ts != sorted(ts):
            problems.append("trace not monotonically ordered after align")

        def first_t(kind: str) -> float | None:
            return next(
                (e["t"] for e in merged if e["kind"] == kind), None
            )

        order = [
            first_t(k)
            for k in ("fleet_moved", "fleet_fwd", "result", "fleet_result")
        ]
        if None not in order and order != sorted(order):
            problems.append(
                f"trace stage order violated: moved/fwd/result/"
                f"fleet_result at {order}"
            )
        rendered = render_timeline(merged)
        if not rendered.strip() or "fleet" not in rendered:
            problems.append("rendered trace empty or missing fleet tier")

        # -- artifacts --------------------------------------------------
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "fleet_top.json").write_text(
            json.dumps({"version": 1, "series": agg.series()}, indent=1)
        )
        (out_dir / "fleet_trace.json").write_text(
            json.dumps(
                {
                    "client": trace_client.hex,
                    "seq": trace_seq,
                    "events": merged,
                },
                indent=1,
            )
        )
        (out_dir / "fleet_trace.txt").write_text(rendered + "\n")
        print(rendered)

        return {
            "version": 1,
            "benchmark": "fleet_obs",
            "ts": time.time(),
            "config": {
                "fleet_gateways": 2,
                "replicas": 3,
                "shards": 4,
                "persistence": "wal",
                "coalesce_window_s": 0.25,
            },
            "crosscheck": {
                "tolerance": {"abs": ABS_TOL, "rel": REL_TOL},
                "gateways": gws_doc,
            },
            "trace": {
                "client": trace_client.hex,
                "seq": trace_seq,
                "events": len(merged),
                "stages": sorted(stages),
                "moved_redirects": moved_sess.redirects,
                "wave_covered": (wave_fig or {}).get("covered"),
            },
            "watchdog_quiet": True,  # no faults injected in this cell
            "pass": not problems,
            "problems": problems,
        }
    finally:
        await h.stop()
        if h.cluster.wal_dir:
            import shutil

            shutil.rmtree(h.cluster.wal_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=(__doc__ or "").split("\n")[0])
    ap.add_argument(
        "--out-dir", default="build/fleet_obs_artifacts",
        help="artifact directory (fleet_top.json, fleet_trace.{json,txt}, "
        "report.json)",
    )
    ap.add_argument(
        "--no-record", action="store_true",
        help="accepted for the reference's interface; the port records "
        "nothing into the repo either way",
    )
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    report = asyncio.run(_run(out_dir))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    print(
        f"fleet obs smoke: trace_events={report['trace']['events']} "
        f"stages={len(report['trace']['stages'])} "
        f"moved={report['trace']['moved_redirects']} "
        f"{'PASS' if report['pass'] else 'FAIL'}"
    )
    for p in report["problems"]:
        print(f"  - {p}", file=sys.stderr)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
