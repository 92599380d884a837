"""Fleet observability plane: one pane over many gateways and replicas.

Three surfaces (docs/OBSERVABILITY.md, "Fleet plane"):

1. **Ring-discovered aggregation.** :class:`FleetAggregator` bootstraps
   from ONE fleet-gateway address: the RING admin frame names every
   fleet member, each member's HEALTH document names the replica-cluster
   gateways it proxies to (``upstreams``), and every node of both tiers
   is then scraped over the existing admin frames (METRICS + HEALTH) —
   no out-of-band inventory. Each scrape round produces one fleet-level
   sample with **derived per-gateway series**: coalesce density (covered
   submits per multi-client wave), slots/op, MOVED-redirect and handoff
   rates — attributed to a fleet gateway by grouping the replica tier's
   per-shard coalescing counters (``rabia_coalesce_shard_total``) by the
   ring's shard ownership. Routing concentration is WHY slots/op drops;
   this is the surface that proves it per gateway (ROADMAP item 1).

2. **Cross-tier traces.** :func:`collect_fleet_trace` extends the
   round-11 trace collector across tiers: the same ``(client_id, seq)``
   TRACE query goes to fleet gateways AND replica gateways (both derive
   the same deterministic batch hash), the slices clock-align with the
   RTT-midpoint method from :mod:`rabia_tpu_torch.obs.flight`, and the merged
   timeline shows the full path — fleet receive, MOVED hop, upstream
   forward, coalesce park/flush, wave decide/apply, durability barrier,
   ledger replication — in one aligned ordering.

3. **SLO burn-rate watchdog.** :class:`BurnRateWatchdog` evaluates a
   fast/slow dual-window burn rate (the classic multiwindow alerting
   shape: a fast window for detection latency, a slow window so a blip
   cannot page) over cumulative counter samples, plus structural checks
   (coalesce-density collapse, read-lane demotion, stale members), and
   records edge-triggered :class:`~rabia_tpu_torch.obs.journal.AnomalyJournal`
   entries (``slo_burn``, ``coalesce_density_drop``,
   ``read_lane_demoted``, ``ring_stale``). Its machine-readable
   :meth:`~BurnRateWatchdog.verdict` is consumed by the chaos runner
   (profiles declare ``expect_watchdog`` kinds) and the CI smoke cell.

Derived-metric recipes (all from counter DELTAS between two samples, so
they are rates over the sampling interval, not life-of-process
averages):

- ``coalesce_density``  = Δcovered / Δwaves       (submits per wave)
- ``slots_per_op``      = (Δwaves + Δscalar) / Δresults_ok
- ``fsyncs_per_result`` = Δwal_fsyncs / Δresults_ok        (fleet-level:
  the WAL is a replica-tier resource shared by every gateway's traffic,
  so per-gateway attribution would be an invention)
- ``offcons_fraction``  = Δprobe_reads / Δreads            (fleet-level,
  same sharing argument)
- ``moved_rate`` / ``handoff_rate`` = per-gateway stat deltas / interval

The port's copy of the reference's ``rabia_tpu/obs/fleet_obs.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence
import uuid

from rabia_tpu_torch.obs.journal import AnomalyJournal

# ---------------------------------------------------------------------------
# Discovery + scraping (admin frames only — the running system's truth)
# ---------------------------------------------------------------------------


async def discover_fleet(
    host: str, port: int, timeout: float = 10.0
) -> dict:
    """Bootstrap the fleet inventory from one fleet-gateway address.

    Returns ``{"ring": <ring doc>, "n_shards": N, "members":
    [(name, host, port), ...], "upstreams": [(host, port), ...]}``. The
    member list comes from the RING admin frame; the replica-tier
    ``upstreams`` from the seed member's HEALTH document."""
    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway.client import admin_fetch

    ring_body = await admin_fetch(
        host, port, int(AdminKind.RING), timeout=timeout
    )
    ring_doc = json.loads(ring_body)
    health_body = await admin_fetch(
        host, port, int(AdminKind.HEALTH), timeout=timeout
    )
    health = json.loads(health_body)
    members = [
        (str(m["name"]), str(m["host"]), int(m["port"]))
        for m in ring_doc["ring"].get("members", [])
    ]
    return {
        "ring": ring_doc["ring"],
        "n_shards": int(ring_doc["n_shards"]),
        "members": sorted(members),
        "upstreams": [
            (str(h), int(p)) for h, p in health.get("upstreams", [])
        ],
        # shard-group scale-out (fleet/groups.py): the adopted GroupMap
        # doc (None on a flat fleet) — per-group attribution joins on it
        "groups": ring_doc.get("groups"),
    }


async def _scrape_one(
    host: str, port: int, timeout: float
) -> dict:
    """One node's scrape: METRICS (parsed to the snapshot key shape) +
    HEALTH, RTT-bracketed for clock alignment (the midpoint annotates
    the sample's fleet-clock estimate)."""
    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway.client import admin_fetch, admin_fetch_timed
    from rabia_tpu_torch.obs.registry import parse_prometheus_text

    body, send_wall, recv_wall = await admin_fetch_timed(
        host, port, int(AdminKind.METRICS), timeout=timeout
    )
    health = json.loads(
        await admin_fetch(host, port, int(AdminKind.HEALTH), timeout=timeout)
    )
    return {
        "metrics": parse_prometheus_text(body.decode()),
        "health": health,
        # the RTT-midpoint estimate of WHEN these counters were read,
        # on the collector's clock (err bound ±RTT/2) — the same
        # alignment model obs/flight uses for traces
        "t": (send_wall + recv_wall) / 2.0,
        "err_s": max(0.0, recv_wall - send_wall) / 2.0,
    }


# ---------------------------------------------------------------------------
# Derived per-gateway figures (pure math over counter deltas — testable
# against hand-computed deltas, and the loadgen cross-check's other half)
# ---------------------------------------------------------------------------


def _shard_key(field_name: str, shard: int) -> str:
    # MetricsRegistry sorts label keys: field before shard
    return (
        f'rabia_coalesce_shard_total{{field="{field_name}",'
        f'shard="{shard}"}}'
    )


def shard_coalesce_figures(
    metrics: dict, shards: Iterable[int]
) -> dict:
    """Sum the per-shard coalescing counters of ONE replica metrics
    snapshot (``MetricsRegistry.snapshot`` / parsed Prometheus key
    shape) over ``shards``."""
    out = {"waves": 0.0, "covered": 0.0, "solo": 0.0, "scalar": 0.0,
           "results_ok": 0.0}
    for s in shards:
        for fld in out:
            out[fld] += float(metrics.get(_shard_key(fld, s), 0.0))
    return out


def derive_gateway_figures(
    owned_shards: Sequence[int],
    replica_metrics: Sequence[dict],
    prev_replica_metrics: Optional[Sequence[dict]] = None,
) -> dict:
    """One fleet gateway's derived coalesce figures: the per-shard
    counters of every replica, summed over the gateway's owned shards,
    as deltas against the previous scrape when given (else
    life-of-process totals). Returns the counter sums plus
    ``coalesce_density`` (covered/waves) and ``slots_per_op``
    ((waves+scalar)/results_ok); a zero denominator derives None —
    "no traffic" must never render as a perfect score."""
    cur = {"waves": 0.0, "covered": 0.0, "solo": 0.0, "scalar": 0.0,
           "results_ok": 0.0}
    for m in replica_metrics:
        fig = shard_coalesce_figures(m, owned_shards)
        for k in cur:
            cur[k] += fig[k]
    if prev_replica_metrics is not None:
        for m in prev_replica_metrics:
            fig = shard_coalesce_figures(m, owned_shards)
            for k in cur:
                cur[k] -= fig[k]
    # per-shard counters are per-REPLICA views of the same consensus
    # entries: every replica's proposer lane counts its own proposals,
    # so summing across replicas counts each wave once (only the
    # proposing replica's gateway drives it)
    waves, covered = cur["waves"], cur["covered"]
    slots = cur["waves"] + cur["scalar"]
    ok = cur["results_ok"]
    return {
        **{k: round(v, 6) for k, v in cur.items()},
        "coalesce_density": (
            round(covered / waves, 6) if waves > 0 else None
        ),
        "slots_per_op": round(slots / ok, 6) if ok > 0 else None,
    }


def _metric_sum(metrics_list: Sequence[dict], needle: str) -> float:
    return float(
        sum(
            v
            for m in metrics_list
            for k, v in m.items()
            if needle in k and "_p50" not in k and "_p99" not in k
        )
    )


def _replica_group(health: Optional[dict]) -> Optional[int]:
    """The consensus-group id a replica's HEALTH document declares
    (``gateway.group.id``, set on grouped deployments), else None."""
    g = (health or {}).get("gateway", {}).get("group")
    if isinstance(g, dict) and "id" in g and g["id"] is not None:
        return int(g["id"])
    return None


def derive_fleet_sample(
    ring_doc: dict,
    n_shards: int,
    gateway_scrapes: dict,
    replica_scrapes: Sequence[dict],
    prev: Optional[dict] = None,
    groups_doc: Optional[dict] = None,
) -> dict:
    """One fleet-level sample from a scrape round.

    ``gateway_scrapes`` maps fleet-gateway name -> :func:`_scrape_one`
    result (or None when unreachable); ``replica_scrapes`` lists the
    replica-tier results. ``prev`` is the previous sample (for counter
    deltas and rates). Pure given its inputs — the unit tests feed it
    hand-built counter dicts."""
    from rabia_tpu_torch.fleet.ring import HashRing

    ring = HashRing.from_doc(ring_doc)
    scrape_ts = [
        sc["t"] for sc in gateway_scrapes.values() if sc is not None
    ] + [sc["t"] for sc in replica_scrapes]
    # wall-clock fallback ONLY when every node was unreachable — scrape
    # midpoints already sit on the collector's clock, and mixing in
    # time.time() would break the purity the unit tests rely on
    now = max(scrape_ts) if scrape_ts else time.time()
    prev_t = prev.get("t") if prev else None
    dt = (now - prev_t) if prev_t else None
    replica_metrics = [sc["metrics"] for sc in replica_scrapes]
    prev_replicas = (
        [sc["metrics"] for sc in prev["replica_scrapes"]]
        if prev and prev.get("replica_scrapes")
        else None
    )
    gateways: dict[str, dict] = {}
    stale: list[str] = []
    for name in sorted(ring.members):
        sc = gateway_scrapes.get(name)
        if sc is None:
            stale.append(name)
            gateways[name] = {"stale": True}
            continue
        owned = ring.owned_shards(name, n_shards)
        fig = derive_gateway_figures(owned, replica_metrics, prev_replicas)
        stats = sc["health"].get("stats", {})
        prev_stats = {}
        if prev:
            prev_gw = prev.get("gateways", {}).get(name, {})
            prev_stats = prev_gw.get("stats", {})
        rates = {}
        if dt and dt > 0:
            for k in ("submits", "forwarded", "moved",
                      "handoff_in_sessions", "handoff_out_sessions",
                      "shed"):
                rates[f"{k}_per_s"] = round(
                    (stats.get(k, 0) - prev_stats.get(k, 0)) / dt, 3
                )
        gateways[name] = {
            "stale": False,
            "owned_shards": owned,
            "sessions": sc["health"].get("sessions", 0),
            "stats": stats,
            "err_s": sc["err_s"],
            **fig,
            **rates,
        }
    # fleet-level figures over resources the gateways share (WAL, read
    # lane) — per-gateway attribution of these would be an invention
    def _delta(needle: str) -> float:
        cur = _metric_sum(replica_metrics, needle)
        if prev_replicas is not None:
            cur -= _metric_sum(prev_replicas, needle)
        return cur

    d_fsync = _delta("wal_fsyncs_total")
    d_ok = _delta('coalesce_shard_total{field="results_ok"')
    d_reads = _delta("gateway_reads_total")
    d_probe = _delta("engine_reads_probe_total")
    aggregate = derive_gateway_figures(
        range(n_shards), replica_metrics, prev_replicas
    )
    aggregate["fsyncs_per_result"] = (
        round(d_fsync / d_ok, 6) if d_ok > 0 else None
    )
    aggregate["offcons_fraction"] = (
        round(d_probe / d_reads, 6) if d_reads > 0 else None
    )
    # -- per-group attribution (fleet/groups.py): partition the replica
    # tier by each replica's group card (HEALTH gateway.group.id; the
    # stored "group" key on prev-sample scrapes), derive each group's
    # own coalesce/slots figures over ITS shard ranges, and per-group
    # fsyncs/Result — each group owns its own WAL lane, so the sharing
    # argument that keeps fsyncs fleet-level does NOT apply here. A
    # group expected by the map but answering no scrape renders
    # stale=True (UNREACHABLE), never absent.
    group_ranges: dict[int, list[tuple[int, int]]] = {}
    if groups_doc:
        for lo, hi, gid in groups_doc.get("ranges", []):
            group_ranges.setdefault(int(gid), []).append(
                (int(lo), int(hi))
            )
    by_group: dict[int, list[dict]] = {}
    scrape_groups: list[Optional[int]] = []
    for sc in replica_scrapes:
        gid = sc.get("group")
        if gid is None:
            gid = _replica_group(sc.get("health"))
        scrape_groups.append(gid)
        if gid is not None:
            by_group.setdefault(int(gid), []).append(sc["metrics"])
    prev_by_group: dict[int, list[dict]] = {}
    if prev and prev.get("replica_scrapes"):
        for sc in prev["replica_scrapes"]:
            if sc.get("group") is not None:
                prev_by_group.setdefault(int(sc["group"]), []).append(
                    sc["metrics"]
                )
    groups_out: dict[str, dict] = {}
    stale_groups: list[int] = []
    for gid in sorted(set(group_ranges) | set(by_group)):
        ranges = group_ranges.get(gid)
        mets = by_group.get(gid)
        if not mets:
            stale_groups.append(gid)
            groups_out[str(gid)] = {
                "stale": True,
                "shard_ranges": [
                    [lo, hi] for lo, hi in (ranges or [])
                ],
            }
            continue
        shards: Iterable[int] = (
            [s for lo, hi in ranges for s in range(lo, hi)]
            if ranges
            else range(n_shards)
        )
        pmets = prev_by_group.get(gid)
        fig = derive_gateway_figures(shards, mets, pmets)
        d_fsync_g = _metric_sum(mets, "wal_fsyncs_total")
        if pmets:
            d_fsync_g -= _metric_sum(pmets, "wal_fsyncs_total")
        fig["fsyncs_per_result"] = (
            round(d_fsync_g / fig["results_ok"], 6)
            if fig["results_ok"] > 0
            else None
        )
        groups_out[str(gid)] = {
            "stale": False,
            "replicas": len(mets),
            "shard_ranges": (
                [[lo, hi] for lo, hi in ranges] if ranges else None
            ),
            **fig,
        }
    return {
        "t": now,
        "wall": time.time(),
        "ring_version": ring.version,
        "n_shards": n_shards,
        "interval_s": round(dt, 6) if dt else None,
        "gateways": gateways,
        "aggregate": aggregate,
        "stale_members": stale,
        "groups": groups_out or None,
        "group_map_version": (
            int(groups_doc.get("version", 0)) if groups_doc else None
        ),
        "stale_groups": stale_groups,
        "replica_scrapes": [
            {"metrics": sc["metrics"], "t": sc["t"], "group": gid}
            for sc, gid in zip(replica_scrapes, scrape_groups)
        ],
    }


class FleetAggregator:
    """Ring-discovered scrape loop over both tiers (see module doc).

    One instance per operator pane / CI cell: :meth:`refresh` runs a
    discovery round (RING + HEALTH from the seed), :meth:`sample` one
    scrape+derive round appended to the bounded ``history`` ring. The
    fleet-level time series is ``history``; each element's
    ``gateways[name]`` carries that gateway's derived series point."""

    def __init__(
        self,
        seed: tuple[str, int],
        replicas: Sequence[tuple[str, int]] = (),
        timeout: float = 10.0,
        cap: int = 900,
        watchdog: Optional["BurnRateWatchdog"] = None,
    ) -> None:
        self.seed = seed
        self.extra_replicas = [(str(h), int(p)) for h, p in replicas]
        self.timeout = timeout
        self.history: deque = deque(maxlen=cap)
        self.watchdog = watchdog
        self.inventory: Optional[dict] = None

    async def refresh(self) -> dict:
        self.inventory = await discover_fleet(
            self.seed[0], self.seed[1], timeout=self.timeout
        )
        return self.inventory

    async def sample(self) -> dict:
        """One scrape round across every discovered node: fleet members
        that fail to answer are marked stale (and fed to the watchdog),
        never fatal — a pane over a degraded fleet is the point."""
        if self.inventory is None:
            await self.refresh()
        inv = self.inventory
        assert inv is not None
        replica_addrs = list(
            dict.fromkeys(
                [tuple(a) for a in inv["upstreams"]]
                + [tuple(a) for a in self.extra_replicas]
            )
        )
        gw_results, rep_results = await asyncio.gather(
            asyncio.gather(
                *(
                    _scrape_one(h, p, self.timeout)
                    for _n, h, p in inv["members"]
                ),
                return_exceptions=True,
            ),
            asyncio.gather(
                *(
                    _scrape_one(h, p, self.timeout)
                    for h, p in replica_addrs
                ),
                return_exceptions=True,
            ),
        )
        gateway_scrapes = {
            name: (None if isinstance(res, BaseException) else res)
            for (name, _h, _p), res in zip(inv["members"], gw_results)
        }
        replica_scrapes = [
            res for res in rep_results
            if not isinstance(res, BaseException)
        ]
        prev = self.history[-1] if self.history else None
        doc = derive_fleet_sample(
            inv["ring"], inv["n_shards"], gateway_scrapes,
            replica_scrapes, prev, groups_doc=inv.get("groups"),
        )
        self.history.append(doc)
        if self.watchdog is not None:
            self.watchdog.observe_fleet_sample(doc)
        return doc

    def series(self) -> list[dict]:
        """The fleet-level time series (history, oldest first) without
        the raw per-replica scrape payloads."""
        return [
            {k: v for k, v in doc.items() if k != "replica_scrapes"}
            for doc in self.history
        ]


def render_fleet_table(doc: dict) -> str:
    """One fleet sample as the ``fleet-top`` text pane: a row per
    gateway (derived figures + routing rates) and the fleet aggregate
    line with the shared-resource figures."""

    def fmt(v, width, prec=3):
        if v is None:
            return f"{'-':>{width}}"
        if isinstance(v, float):
            return f"{v:>{width}.{prec}f}"
        return f"{v:>{width}}"

    head = (
        f"{'gateway':<12} {'shards':>6} {'sess':>5} {'density':>8} "
        f"{'slots/op':>9} {'subm/s':>8} {'moved/s':>8} {'hand/s':>7} "
        f"{'shed/s':>7}"
    )
    lines = [
        f"fleet sample t={doc['t']:.3f} ring v{doc['ring_version']} "
        f"({doc['n_shards']} shards"
        + (
            f", interval {doc['interval_s']:.2f}s"
            if doc.get("interval_s")
            else ", first sample — rates need a second one"
        )
        + ")",
        head,
        "-" * len(head),
    ]
    for name in sorted(doc["gateways"]):
        g = doc["gateways"][name]
        if g.get("stale"):
            lines.append(f"{name:<12} {'UNREACHABLE':>6}")
            continue
        hand = None
        if "handoff_in_sessions_per_s" in g:
            hand = (
                g["handoff_in_sessions_per_s"]
                + g["handoff_out_sessions_per_s"]
            )
        lines.append(
            f"{name:<12} {len(g['owned_shards']):>6} "
            f"{g['sessions']:>5} {fmt(g['coalesce_density'], 8)} "
            f"{fmt(g['slots_per_op'], 9)} "
            f"{fmt(g.get('submits_per_s'), 8, 1)} "
            f"{fmt(g.get('moved_per_s'), 8, 1)} {fmt(hand, 7, 1)} "
            f"{fmt(g.get('shed_per_s'), 7, 1)}"
        )
    agg = doc["aggregate"]
    lines.append(
        f"{'-- fleet':<12} {doc['n_shards']:>6} {'':>5} "
        f"{fmt(agg['coalesce_density'], 8)} {fmt(agg['slots_per_op'], 9)}"
        f"  fsyncs/result={agg['fsyncs_per_result']}"
        f" offcons={agg['offcons_fraction']}"
    )
    if doc["stale_members"]:
        lines.append(f"stale members: {', '.join(doc['stale_members'])}")
    # shard-group section (fleet/groups.py): one row per consensus
    # group with ITS derived figures; a dead group renders UNREACHABLE
    # + stale (it stays in the table — absence would hide the outage)
    if doc.get("groups"):
        gv = doc.get("group_map_version")
        ghead = (
            f"{'group':<7} {'shards':<16} {'repl':>5} {'density':>8} "
            f"{'slots/op':>9} {'fsync/res':>10}"
        )
        lines.append(
            "groups"
            + (f" (map v{gv})" if gv is not None else "")
            + ":"
        )
        lines.append(ghead)
        lines.append("-" * len(ghead))
        for gid in sorted(doc["groups"], key=int):
            g = doc["groups"][gid]
            rng = ",".join(
                f"[{lo},{hi})" for lo, hi in (g.get("shard_ranges") or [])
            ) or "?"
            if g.get("stale"):
                lines.append(
                    f"{'g' + gid:<7} {rng:<16} UNREACHABLE (stale)"
                )
                continue
            lines.append(
                f"{'g' + gid:<7} {rng:<16} {g['replicas']:>5} "
                f"{fmt(g['coalesce_density'], 8)} "
                f"{fmt(g['slots_per_op'], 9)} "
                f"{fmt(g['fsyncs_per_result'], 10)}"
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Cross-tier trace collection
# ---------------------------------------------------------------------------


async def collect_fleet_trace(
    fleet_addrs: Iterable[tuple[str, int]],
    replica_addrs: Iterable[tuple[str, int]],
    client_id: uuid.UUID,
    seq: int,
    timeout: float = 10.0,
) -> list[dict]:
    """Fetch + align + merge TraceSlices for ``(client_id, seq)`` from
    BOTH tiers: every fleet gateway (its slices carry ``tier="fleet"``
    and the routing-hop FRE_FLEET_* events) and every replica gateway
    (the consensus lifecycle). Both tiers derive the same deterministic
    batch hash from the session coordinates, so one query joins the
    timeline end-to-end — fleet receive, MOVED hop(s), upstream forward,
    coalesce/wave lifecycle, result. Unreachable nodes are skipped;
    raises only when NO node answered."""
    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway.client import admin_fetch_timed
    from rabia_tpu_torch.obs.flight import align_slice, merge_slices

    query = json.dumps({"client": client_id.hex, "seq": int(seq)}).encode()
    addrs = list(fleet_addrs) + list(replica_addrs)
    slices = []
    errors = []
    # sequential on purpose: the alignment offset comes from the RTT
    # midpoint of each fetch, and concurrent fetches queue behind each
    # other's serve work (worst on in-process harnesses where every
    # server shares one loop), inflating RTTs and skewing every offset.
    # Trace collection is offline tooling — accuracy beats latency.
    for host, port in addrs:
        try:
            body, send_wall, recv_wall = await admin_fetch_timed(
                host, port, int(AdminKind.TRACE), query=query,
                timeout=timeout,
            )
        except Exception as exc:
            errors.append(f"{host}:{port}: {type(exc).__name__}: {exc}")
            continue
        slices.append(align_slice(json.loads(body), send_wall, recv_wall))
    if not slices:
        raise RuntimeError(
            "fleet trace: no node answered (" + "; ".join(errors) + ")"
        )
    return merge_slices(slices)


# ---------------------------------------------------------------------------
# SLO burn-rate watchdog
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SLOPolicy:
    """Burn-rate windows + structural floors.

    The error budget is ``error_budget`` (fraction of operations allowed
    to fail/shed); a *burn rate* of B means errors are consuming budget
    B times faster than the SLO allows. The watchdog pages only when the
    FAST window (detection latency) and the SLOW window (flap
    suppression) are BOTH over their burn thresholds — the standard
    multiwindow shape. Structural checks gate on minimum volume so an
    idle system can never fire."""

    error_budget: float = 0.01
    fast_window_s: float = 5.0
    slow_window_s: float = 30.0
    fast_burn: float = 10.0
    slow_burn: float = 2.0
    # coalesce-density collapse: the fast-window density fell below
    # `density_floor * slow-window density` while waves kept flowing
    density_floor: float = 0.5
    min_waves: float = 3.0
    # read-lane demotion: the off-consensus read fraction fell below
    # this while reads kept flowing (the device lane demoted to host)
    offcons_floor: float = 0.5
    min_reads: float = 20.0
    # minimum ops in the fast window before burn math is meaningful
    min_ops: float = 10.0


# the cumulative-counter keys a watchdog sample may carry (all optional;
# a missing key skips the checks that need it)
WATCHDOG_COUNTERS = (
    "ok", "errors", "waves", "covered", "reads", "reads_offcons",
)


class BurnRateWatchdog:
    """Dual-window burn-rate + structural evaluator over cumulative
    counter samples (see :class:`SLOPolicy`).

    Feed :meth:`observe` monotonically timestamped samples —
    ``{"ok": N, "errors": N, "waves": N, "covered": N, "reads": N,
    "reads_offcons": N, "members_alive": N, "members_total": N}`` (all
    cumulative except the member gauges). Conditions are EDGE-triggered:
    each journal kind records once per episode and re-arms when the
    condition clears, so a long incident is one journal entry, not one
    per sample. :meth:`verdict` returns the machine-readable summary the
    chaos runner and CI consume."""

    def __init__(
        self,
        policy: Optional[SLOPolicy] = None,
        journal: Optional[AnomalyJournal] = None,
        cap: int = 4096,
    ) -> None:
        self.policy = policy or SLOPolicy()
        self.journal = journal if journal is not None else AnomalyJournal()
        self._rows: deque = deque(maxlen=cap)
        self._active: set[str] = set()
        self._episodes: list[dict] = []

    # -- sampling -----------------------------------------------------------

    def observe(self, t: float, sample: dict) -> list[str]:
        """Ingest one sample; returns the kinds that FIRED on this
        observation (newly entered episodes)."""
        self._rows.append({"t": float(t), **sample})
        return self._evaluate()

    def observe_fleet_sample(self, doc: dict) -> list[str]:
        """Adapter from a :class:`FleetAggregator` sample document."""
        agg = doc.get("aggregate", {})
        total = len(doc.get("gateways", {}))
        stale = doc.get("stale_members", [])
        return self.observe(
            doc["t"],
            {
                "ok": agg.get("results_ok", 0.0),
                "errors": sum(
                    g.get("stats", {}).get("shed", 0)
                    for g in doc.get("gateways", {}).values()
                ),
                "waves": agg.get("waves", 0.0),
                "covered": agg.get("covered", 0.0),
                "members_alive": total - len(stale),
                "members_total": total,
                "stale_members": list(stale),
            },
        )

    # -- evaluation ---------------------------------------------------------

    def _window(self, now: float, width: float) -> Optional[dict]:
        """Counter deltas over the trailing ``width`` seconds: newest row
        minus the newest row at least ``width`` old (None until the ring
        spans the window)."""
        newest = self._rows[-1]
        base = None
        for row in self._rows:
            if now - row["t"] >= width:
                base = row
            else:
                break
        if base is None:
            return None
        out = {}
        for k in WATCHDOG_COUNTERS:
            if k in newest and k in base:
                out[k] = float(newest[k]) - float(base[k])
        out["span_s"] = newest["t"] - base["t"]
        return out

    def _burn(self, win: Optional[dict]) -> Optional[float]:
        if win is None:
            return None
        ok = win.get("ok", 0.0)
        errors = win.get("errors", 0.0)
        ops = ok + errors
        if ops < self.policy.min_ops:
            return None
        return (errors / ops) / self.policy.error_budget

    def _fire(self, kind: str, now: float, **detail) -> Optional[str]:
        if kind in self._active:
            return None
        self._active.add(kind)
        self._episodes.append({"kind": kind, "t": now, **detail})
        self.journal.record(kind, **detail)
        return kind

    def _clear(self, kind: str) -> None:
        self._active.discard(kind)

    def _evaluate(self) -> list[str]:
        p = self.policy
        newest = self._rows[-1]
        now = newest["t"]
        fired: list[str] = []

        fast = self._window(now, p.fast_window_s)
        slow = self._window(now, p.slow_window_s)

        # 1) SLO burn: both windows over threshold
        bf, bs = self._burn(fast), self._burn(slow)
        if bf is not None and bs is not None:
            if bf >= p.fast_burn and bs >= p.slow_burn:
                f = self._fire(
                    AnomalyJournal.SLO_BURN, now,
                    fast_burn=round(bf, 3), slow_burn=round(bs, 3),
                )
                if f:
                    fired.append(f)
            elif bf < p.fast_burn:
                self._clear(AnomalyJournal.SLO_BURN)

        # 2) coalesce-density collapse: fast-window density fell under
        # density_floor x the slow-window density while waves still flow
        if (
            fast is not None and slow is not None
            and fast.get("waves", 0.0) >= p.min_waves
            and slow.get("waves", 0.0) >= p.min_waves
        ):
            df = fast["covered"] / fast["waves"]
            ds = slow["covered"] / slow["waves"]
            if ds > 0 and df < p.density_floor * ds:
                f = self._fire(
                    AnomalyJournal.COALESCE_DENSITY_DROP, now,
                    fast_density=round(df, 3), slow_density=round(ds, 3),
                )
                if f:
                    fired.append(f)
            else:
                self._clear(AnomalyJournal.COALESCE_DENSITY_DROP)

        # 3) read-lane demotion: the off-consensus fraction sank while
        # reads kept flowing
        if fast is not None and fast.get("reads", 0.0) >= p.min_reads:
            frac = fast.get("reads_offcons", 0.0) / fast["reads"]
            if frac < p.offcons_floor:
                f = self._fire(
                    AnomalyJournal.READ_LANE_DEMOTED, now,
                    offcons_fraction=round(frac, 3),
                )
                if f:
                    fired.append(f)
            else:
                self._clear(AnomalyJournal.READ_LANE_DEMOTED)

        # 4) stale members: gauge check, no window needed
        alive = newest.get("members_alive")
        total = newest.get("members_total")
        if alive is not None and total:
            if alive < total:
                f = self._fire(
                    AnomalyJournal.RING_STALE, now,
                    alive=int(alive), total=int(total),
                    stale=list(newest.get("stale_members", [])),
                )
                if f:
                    fired.append(f)
            else:
                self._clear(AnomalyJournal.RING_STALE)
        return fired

    # -- verdict ------------------------------------------------------------

    def verdict(self) -> dict:
        """Machine-readable summary: per-kind episode counts, episode
        list (kind + first-fire time + detail), and ``quiet`` (nothing
        ever fired) — the shape chaos ``verify()`` and CI assert on."""
        counts: dict[str, int] = {}
        for ep in self._episodes:
            counts[ep["kind"]] = counts.get(ep["kind"], 0) + 1
        return {
            "quiet": not self._episodes,
            "fired": counts,
            "episodes": list(self._episodes),
            "active": sorted(self._active),
            "samples": len(self._rows),
        }
