"""Critical-path decomposition of slow Submit exemplars.

The gateway's slowlog reservoir (``AdminKind.SLOWLOG``) keeps the
slowest fresh-Submit completions per window as exemplars — batch id,
wall time, outcome.  This module turns an exemplar into an *accounted*
latency breakdown: it fetches the batch's cross-tier flight trace (the
same TraceSlice documents ``collect_trace`` / ``collect_fleet_trace``
merge) and attributes the wall time to named, non-overlapping segments:

    fleet_routing       first fleet recv -> last upstream forward
                        (spans MOVED redirect hops)
    gateway_queue       fleet forward -> gateway recv, plus
                        recv -> engine submit when NOT coalesced
    coalesce_park       gateway recv -> engine submit for coalesced
                        waves (the deliberate batching stall)
    propose_to_open     engine submit -> consensus slot open
    consensus_phase_N   per weak-MVC phase dwell on the proposing
                        replica (open -> advance ... -> kernel decide);
                        phases past 7 clamp into ``consensus_phase_8+``
    decide_to_apply     kernel decide -> state-machine apply
    fsync_barrier       apply -> durability-barrier return (0 when the
                        WAL is off: no barrier mark is recorded)
    result_fanout       barrier/apply -> gateway result send, plus the
                        upstream->fleet relay when a fleet tier served
    ledger_replication  fleet result -> last dedup-ledger replication
                        to a ring successor

plus an explicit ``unattributed`` remainder so the decomposition is
falsifiable: time the marks cannot account for (missing events, clock
re-orderings clamped away, gaps between tiers) is reported, never
silently folded into a neighbouring segment.

Honesty rules:

* Marks are clamped monotone in canonical order before differencing, so
  cross-node alignment error (bounded by ``err_s``) can shrink a
  segment to zero but never produce negative time or double-counting.
* Consensus-phase segments come from ONE replica's ring (the proposer),
  where aligned-time deltas are exact — the per-slice offset is a
  constant, so same-ring differences carry no alignment error.
* A segment is emitted only when BOTH of its boundary marks were
  observed; a missing mark routes the spanned time to ``unattributed``.
* Exemplars whose trace is ``truncated`` (a flight ring wrapped past
  the batch's early life) are decomposed for display but excluded from
  segment aggregates — a half-seen exemplar would systematically
  under-report early segments.

The port's copy of the reference's ``rabia_tpu/obs/critpath.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Callable, Iterable, Optional, Sequence

from rabia_tpu_torch.obs.flight import (
    align_slice,
    build_fleet_trace_slice,
    build_trace_slice,
    fr_hash,
    merge_slices,
)

# Canonical segment order — rendering, docs and the loadgen column all
# iterate this, so the waterfall reads top-to-bottom in causal order.
# Consensus phases are expanded in place of the "consensus" placeholder.
SEGMENT_ORDER: tuple[str, ...] = (
    "fleet_routing",
    "gateway_queue",
    "coalesce_park",
    "propose_to_open",
    "consensus",
    "decide_to_apply",
    "fsync_barrier",
    "result_fanout",
    "ledger_replication",
)

# Phase-segment clamp, matching the dwell-histogram row layout (rows
# phase 1..7 + "8+"): an adversarial 40-phase decide folds into one
# labelled bucket instead of spawning unbounded label values.
PHASE_CLAMP = 8


def _phase_segment(phase: int) -> str:
    if phase >= PHASE_CLAMP:
        return f"consensus_phase_{PHASE_CLAMP}+"
    return f"consensus_phase_{phase}"


def segment_names(max_phase: int = PHASE_CLAMP) -> list[str]:
    """The full flat segment-name list (consensus placeholder expanded),
    in canonical order — the label universe of
    ``rabia_critpath_seconds{segment=...}``."""
    out: list[str] = []
    for name in SEGMENT_ORDER:
        if name == "consensus":
            out.extend(
                _phase_segment(p) for p in range(1, max_phase + 1)
            )
        else:
            out.append(name)
    out.append("unattributed")
    return out


# ---------------------------------------------------------------------------
# Mark extraction
# ---------------------------------------------------------------------------


def _first(events: list[dict]) -> Optional[dict]:
    return events[0] if events else None


def _extract_marks(
    merged: Sequence[dict],
) -> tuple[list[tuple[str, float]], dict]:
    """Pull the canonical boundary marks out of a merged timeline.

    Returns ``(marks, info)`` where ``marks`` is an ordered list of
    ``(name, aligned_t)`` in canonical causal order (present marks
    only, NOT yet clamped) and ``info`` carries the proposer row,
    slot coordinates, advance chain and MOVED-hop count."""
    by_kind: dict[str, list[dict]] = {}
    for e in merged:
        by_kind.setdefault(e["kind"], []).append(e)

    info: dict = {"moved_hops": len(by_kind.get("fleet_moved", []))}

    # Proposer identification: the row that bound the batch to a slot.
    # Fall back to the submit row (single-gateway traces may predate the
    # propose record reaching the ring).
    anchor = _first(by_kind.get("propose", [])) or _first(
        by_kind.get("submit", [])
    )
    prow = anchor["row"] if anchor is not None else None
    slot_key = None
    if anchor is not None and anchor["kind"] == "propose":
        slot_key = (anchor["shard"], anchor["slot"])
    else:
        d = _first(by_kind.get("decide", []))
        if d is not None:
            slot_key = (d["shard"], d["slot"])
    info["proposer_row"] = prow
    info["slot"] = slot_key

    def on_proposer(kind: str) -> list[dict]:
        return [
            e
            for e in by_kind.get(kind, [])
            if e["row"] == prow
            and (
                slot_key is None
                or (e["shard"], e["slot"]) == slot_key
            )
        ]

    marks: list[tuple[str, float]] = []

    fleet_recv = _first(by_kind.get("fleet_recv", []))
    fleet_fwd = by_kind.get("fleet_fwd", [])
    if fleet_recv is not None:
        marks.append(("fleet_recv", fleet_recv["t"]))
    if fleet_fwd:
        marks.append(("fleet_fwd", fleet_fwd[-1]["t"]))

    gw_recv = _first(by_kind.get("gw_recv", []))
    if gw_recv is not None:
        marks.append(("gw_recv", gw_recv["t"]))
        info["coalesced_mark"] = bool(gw_recv.get("arg"))

    submit = _first(by_kind.get("submit", []))
    if submit is not None:
        marks.append(("submit", submit["t"]))

    opens = on_proposer("open")
    if opens:
        marks.append(("open", opens[0]["t"]))

    # Advance chain on the proposer's ring: arg = post-advance phase =
    # 1-based ordinal of the phase just completed.  Dedup by ordinal
    # (keep-first) in case overlapping rings retained the same logical
    # advance; require a contiguous 1..k chain — a gap means the ring
    # dropped a boundary, and the orphaned tail would mis-label dwell.
    advances = sorted(on_proposer("advance"), key=lambda e: e["t_ns"])
    chain: list[tuple[int, float]] = []
    seen: set[int] = set()
    for e in advances:
        ph = int(e["arg"])
        if ph < 1 or ph in seen:
            continue
        seen.add(ph)
        chain.append((ph, e["t"]))
    chain.sort()
    contiguous: list[tuple[int, float]] = []
    for i, (ph, t) in enumerate(chain):
        if ph != i + 1:
            break
        contiguous.append((ph, t))
    for ph, t in contiguous:
        marks.append((_phase_segment(ph), t))
    info["phases_observed"] = len(contiguous)

    sd = on_proposer("step_decide") or on_proposer("decide")
    if sd:
        # step_decide closes the FINAL phase (decided slots record no
        # trailing advance): ordinal = observed advances + 1
        info["phases_to_decide"] = len(contiguous) + 1
        marks.append(("step_decide", sd[0]["t"]))

    applies = on_proposer("apply")
    if applies:
        marks.append(("apply", applies[0]["t"]))

    barrier = _first(by_kind.get("barrier", []))
    if barrier is not None:
        marks.append(("barrier", barrier["t"]))

    result = _first(by_kind.get("result", []))
    if result is not None:
        marks.append(("result", result["t"]))

    fleet_result = _first(by_kind.get("fleet_result", []))
    if fleet_result is not None:
        marks.append(("fleet_result", fleet_result["t"]))

    ledger = by_kind.get("fleet_ledger_send", [])
    if ledger:
        marks.append(("ledger_send", ledger[-1]["t"]))

    return marks, info


# ---------------------------------------------------------------------------
# Decomposition
# ---------------------------------------------------------------------------


def decompose(
    merged: Sequence[dict],
    coalesced: Optional[bool] = None,
    wall_s: Optional[float] = None,
) -> dict:
    """Attribute a merged flight timeline's wall time to named segments.

    ``coalesced`` overrides the gw_recv arg (the slowlog exemplar knows
    which drive path completed it); ``wall_s`` is the gateway-measured
    completion time, reported alongside the trace-derived total as a
    cross-check (they bracket the same interval from different clocks).
    Returns a decomposition document; ``ok`` is False when the timeline
    is too sparse to anchor (no marks at all)."""
    truncated = any(e.get("truncated") for e in merged)
    err_s = max((e.get("err_s", 0.0) for e in merged), default=0.0)
    marks, info = _extract_marks(merged)
    if coalesced is None:
        coalesced = bool(info.get("coalesced_mark", False))
    doc: dict = {
        "ok": bool(marks),
        "truncated": truncated,
        "coalesced": bool(coalesced),
        "err_s": err_s,
        "wall_s": wall_s,
        "moved_hops": info["moved_hops"],
        "proposer_row": info.get("proposer_row"),
        "slot": list(info["slot"]) if info.get("slot") else None,
        "phases_to_decide": info.get("phases_to_decide"),
        "segments": {},
        "marks": [],
        "total_s": 0.0,
        "unattributed_s": 0.0,
        "unattributed_frac": 0.0,
    }
    if not marks:
        return doc

    # Monotone clamp in canonical order: alignment error may locally
    # reorder cross-node marks; clamping tiles the window exactly (no
    # negative segments, no double-counting).
    clamped: dict[str, float] = {}
    order: list[str] = []
    prev = marks[0][1]
    for name, t in marks:
        t = max(prev, t)
        clamped[name] = t
        order.append(name)
        prev = t
    doc["marks"] = [(n, clamped[n]) for n in order]

    segs: dict[str, float] = {}

    def emit(name: str, a: str, b: str) -> None:
        if a in clamped and b in clamped:
            segs[name] = segs.get(name, 0.0) + (
                clamped[b] - clamped[a]
            )

    emit("fleet_routing", "fleet_recv", "fleet_fwd")
    emit("gateway_queue", "fleet_fwd", "gw_recv")
    if coalesced:
        emit("coalesce_park", "gw_recv", "submit")
    else:
        emit("gateway_queue", "gw_recv", "submit")
    emit("propose_to_open", "submit", "open")

    # consensus chain: open -> phase_1 -> ... -> step_decide
    n_adv = info.get("phases_observed", 0)
    prev_mark = "open"
    for ph in range(1, n_adv + 1):
        m = _phase_segment(ph)
        emit(m, prev_mark, m)
        prev_mark = m
    if "step_decide" in clamped and "open" in clamped:
        final_ph = n_adv + 1
        emit(_phase_segment(final_ph), prev_mark, "step_decide")

    emit("decide_to_apply", "step_decide", "apply")
    emit("fsync_barrier", "apply", "barrier")
    if "barrier" in clamped:
        emit("result_fanout", "barrier", "result")
    else:
        emit("result_fanout", "apply", "result")
    emit("result_fanout", "result", "fleet_result")
    emit("ledger_replication", "fleet_result", "ledger_send")

    total = clamped[order[-1]] - clamped[order[0]]
    attributed = sum(segs.values())
    unattributed = max(0.0, total - attributed)
    doc["segments"] = segs
    doc["total_s"] = total
    doc["unattributed_s"] = unattributed
    doc["unattributed_frac"] = (
        unattributed / total if total > 0 else 0.0
    )
    return doc


def dominant_segment(decomp: dict) -> Optional[str]:
    """The largest named segment of a decomposition (``unattributed``
    included so an unaccounted stall is never hidden); None when the
    decomposition is empty."""
    segs = dict(decomp.get("segments", {}))
    if decomp.get("unattributed_s", 0.0) > 0:
        segs["unattributed"] = decomp["unattributed_s"]
    if not segs:
        return None
    return max(segs.items(), key=lambda kv: kv[1])[0]


# ---------------------------------------------------------------------------
# Aggregation -> rabia_critpath_seconds{segment=...}
# ---------------------------------------------------------------------------


class CritpathAggregator:
    """Folds exemplar decompositions into per-segment latency
    histograms on a :class:`~rabia_tpu_torch.obs.registry.MetricsRegistry`
    (``rabia_critpath_seconds{segment=...}``, SLO bucket geometry — the
    same resolution as the dwell and stage families it sits next to).

    Truncated exemplars are counted but NOT aggregated: a ring that
    wrapped past the batch's early life systematically under-reports
    early segments, and a biased histogram is worse than a smaller one.
    """

    def __init__(self, registry=None) -> None:
        from rabia_tpu_torch.obs.registry import (
            SLO_BUCKETS,
            MetricsRegistry,
        )

        self.registry = (
            registry if registry is not None else MetricsRegistry()
        )
        self._buckets = SLO_BUCKETS
        self._hists: dict[str, object] = {}
        self.exemplars_total = 0
        self.truncated_total = 0
        self.unanchored_total = 0

    def _hist(self, segment: str):
        h = self._hists.get(segment)
        if h is None:
            h = self.registry.histogram(
                "critpath_seconds",
                "slow-exemplar wall time attributed to this "
                "critical-path segment",
                {"segment": segment},
                buckets=self._buckets,
            )
            self._hists[segment] = h
        return h

    def add(self, decomp: dict) -> bool:
        """Observe one decomposition. Returns True when it entered the
        aggregates (False: truncated or unanchored)."""
        self.exemplars_total += 1
        if not decomp.get("ok"):
            self.unanchored_total += 1
            return False
        if decomp.get("truncated"):
            self.truncated_total += 1
            return False
        for seg, v in decomp["segments"].items():
            self._hist(seg).observe(v)
        self._hist("unattributed").observe(decomp["unattributed_s"])
        return True

    def summary(self) -> dict:
        """Mean seconds per segment across aggregated exemplars (the
        loadgen ``critpath`` column shape)."""
        out: dict = {
            "exemplars": self.exemplars_total,
            "truncated": self.truncated_total,
            "unanchored": self.unanchored_total,
            "segments": {},
        }
        for seg, h in sorted(self._hists.items()):
            s = h.snapshot()
            if s["count"]:
                out["segments"][seg] = s["sum_s"] / s["count"]
        return out


# ---------------------------------------------------------------------------
# Collection (remote: admin frames; in-process: loadgen/chaos)
# ---------------------------------------------------------------------------


async def collect_slowlog(
    host: str,
    port: int,
    last: Optional[int] = None,
    timeout: float = 10.0,
) -> dict:
    """Fetch a gateway's slowlog reservoir document
    (``AdminKind.SLOWLOG``)."""
    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway.client import admin_fetch

    query = (
        json.dumps({"last": int(last)}).encode()
        if last is not None
        else b""
    )
    body = await admin_fetch(
        host, port, int(AdminKind.SLOWLOG), timeout=timeout,
        query=query,
    )
    return json.loads(body)


def _exemplar_hashes(exemplar: dict) -> list[str]:
    """The batch-id hexes whose traces jointly cover an exemplar: its
    own deterministic id plus — for coalesced completions — the lead
    wave id the consensus records carry (submit/propose/decide/apply
    for a covered entry happen under the WAVE's hash)."""
    out: list[str] = []
    for key in ("batch", "wave"):
        h = exemplar.get(key)
        if h and h not in out:
            out.append(h)
    return out


async def collect_exemplar_trace(
    replica_addrs: Iterable[tuple[str, int]],
    exemplar: dict,
    fleet_addrs: Iterable[tuple[str, int]] = (),
    timeout: float = 10.0,
) -> list[dict]:
    """Fetch + align + merge the cross-tier trace for one slowlog
    exemplar (both its own batch hash and — when coalesced — its wave's,
    so the consensus chain joins the gateway-side records).

    Fetches SEQUENTIALLY on purpose, like ``collect_fleet_trace``:
    concurrent admin round trips inflate each other's RTTs on
    in-process harnesses, and the RTT bounds every aligned timestamp.
    Unreachable nodes are skipped; raises only if nothing answered."""
    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway.client import admin_fetch_timed

    hashes = _exemplar_hashes(exemplar)
    slices: list[dict] = []
    errors: list[str] = []
    targets = [(a, False) for a in replica_addrs] + [
        (a, True) for a in fleet_addrs
    ]
    for (host, port), _is_fleet in targets:
        for hx in hashes:
            query = json.dumps({"batch": hx}).encode()
            try:
                body, send_wall, recv_wall = await admin_fetch_timed(
                    host, port, int(AdminKind.TRACE), query=query,
                    timeout=timeout,
                )
            except Exception as exc:  # noqa: BLE001 — skip, note, go on
                errors.append(
                    f"{host}:{port}: {type(exc).__name__}: {exc}"
                )
                break  # node unreachable: don't retry its other hash
            slices.append(
                align_slice(json.loads(body), send_wall, recv_wall)
            )
    if not slices:
        raise RuntimeError(
            "critpath: no node answered ("
            + "; ".join(errors)
            + ")"
        )
    return merge_slices(slices)


def _self_align(sl: dict) -> dict:
    """Zero-error alignment for a slice built in the collector's own
    process: wall and mono_ns were sampled on the same clock pair, so
    the offset is exact (the loadgen `_in_process_timeline` trick)."""
    sl["offset_s"] = sl["wall"] - sl["mono_ns"] * 1e-9
    sl["err_s"] = 0.0
    return sl


def inprocess_exemplar_timeline(
    engines: Iterable,
    exemplar: dict,
    fleet_recorders: Iterable[tuple] = (),
    events: Optional[Sequence[list]] = None,
) -> list[dict]:
    """Build an exemplar's merged timeline directly from in-process
    engines (loadgen / chaos path — no sockets, no alignment error).

    ``fleet_recorders``: optional ``(recorder, node_name, row)`` triples
    for in-process fleet gateways. ``events``: each engine's
    ``flight_events()`` already read, in ``engines`` order (the port's
    addition: a caller decomposing many exemplars at one instant reads
    each engine's rings once, not once a slice). Without it each engine's
    rings are read once for this exemplar."""
    slices: list[dict] = []
    hashes = [
        fr_hash(uuid.UUID(hex=hx)) for hx in _exemplar_hashes(exemplar)
    ]
    engines = list(engines)
    if events is None:
        events = [eng.flight_events() for eng in engines] if hashes else []
    for eng, evs in zip(engines, events):
        for bh in hashes:
            slices.append(
                _self_align(build_trace_slice(eng, bh, events=evs))
            )
    for rec, node, row in fleet_recorders:
        for bh in hashes:
            slices.append(
                _self_align(
                    build_fleet_trace_slice(rec, node, row, bh)
                )
            )
    return merge_slices(slices)


def decompose_exemplars(
    exemplars: Iterable[dict],
    timeline_for: Callable[[dict], Sequence[dict]],
    aggregator: Optional[CritpathAggregator] = None,
) -> list[dict]:
    """Decompose each exemplar via ``timeline_for`` (a collector
    closure), tagging each decomposition with its exemplar and feeding
    ``aggregator`` when given. Exemplars whose trace fetch fails are
    returned with ``ok: False`` instead of aborting the batch."""
    out: list[dict] = []
    for ex in exemplars:
        try:
            merged = timeline_for(ex)
        except Exception as exc:  # noqa: BLE001 — per-exemplar fault
            d = {
                "ok": False,
                "error": f"{type(exc).__name__}: {exc}",
                "truncated": False,
                "segments": {},
                "total_s": 0.0,
                "unattributed_s": 0.0,
                "unattributed_frac": 0.0,
            }
        else:
            d = decompose(
                merged,
                coalesced=ex.get("coalesced"),
                wall_s=ex.get("wall_s"),
            )
        d["exemplar"] = dict(ex)
        if aggregator is not None:
            aggregator.add(d)
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# Rendering (the `python -m rabia_tpu_torch slowlog` output)
# ---------------------------------------------------------------------------


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:.3f}"


def render_waterfall(decomp: dict, width: int = 44) -> str:
    """ASCII waterfall of one decomposition: per-segment offset bars on
    the exemplar's own time axis, causal order, like
    ``render_timeline`` but aggregated to segments."""
    if not decomp.get("ok"):
        return "(exemplar not decomposable: " + str(
            decomp.get("error", "no anchoring marks")
        ) + ")"
    total = decomp["total_s"]
    rows: list[tuple[str, float]] = []
    for name in segment_names():
        v = (
            decomp["unattributed_s"]
            if name == "unattributed"
            else decomp["segments"].get(name)
        )
        if v is not None and (v > 0 or name in decomp["segments"]):
            rows.append((name, v))
    lines = [
        f"total {_fmt_ms(total)} ms"
        + (
            f"  (gateway-measured {_fmt_ms(decomp['wall_s'])} ms)"
            if decomp.get("wall_s") is not None
            else ""
        )
        + (
            f"  ±{_fmt_ms(decomp['err_s'])} ms alignment"
            if decomp.get("err_s")
            else ""
        )
    ]
    if decomp.get("truncated"):
        lines.append(
            "WARNING: flight ring wrapped past this batch — "
            "breakdown may be missing early segments"
        )
    offset = 0.0
    name_w = max((len(n) for n, _ in rows), default=12)
    for name, v in rows:
        frac_off = offset / total if total > 0 else 0.0
        frac_len = v / total if total > 0 else 0.0
        pad = int(round(frac_off * width))
        bar = max(1, int(round(frac_len * width))) if v > 0 else 0
        lines.append(
            f"  {name:<{name_w}}  {_fmt_ms(v):>9} ms  "
            f"{' ' * pad}{'#' * bar}"
        )
        if name != "unattributed":
            offset += v
    return "\n".join(lines)


def render_slowlog(doc: dict, decomps: Sequence[dict]) -> str:
    """The `slowlog` CLI table: reservoir header, one row per exemplar
    (slowest first), worst exemplar's waterfall underneath."""
    n_trunc = sum(1 for d in decomps if d.get("truncated"))
    lines = [
        f"slowlog @ {doc.get('node', '?')}: "
        f"{len(decomps)} exemplar(s) of {doc.get('observed', 0)} "
        f"observed completions, window {doc.get('window_s', 0):g}s, "
        f"{doc.get('rotations', 0)} rotation(s)"
        + (f", {n_trunc} truncated" if n_trunc else "")
    ]
    if not decomps:
        lines.append("  (reservoir empty)")
        return "\n".join(lines)
    hdr = (
        f"  {'wall ms':>10}  {'batch':<12} {'co':<3} {'ph':>3} "
        f"{'dominant segment':<22} {'unattr%':>8}"
    )
    lines.append(hdr)
    for d in decomps:
        ex = d.get("exemplar", {})
        dom = dominant_segment(d) or "-"
        ph = d.get("phases_to_decide")
        flags = []
        if d.get("truncated"):
            flags.append("TRUNC")
        if not d.get("ok"):
            flags.append("NOTRACE")
        lines.append(
            f"  {ex.get('wall_s', 0) * 1e3:>10.3f}  "
            f"{str(ex.get('batch', ''))[:12]:<12} "
            f"{'y' if ex.get('coalesced') else 'n':<3} "
            f"{ph if ph is not None else '-':>3} "
            f"{dom:<22} "
            f"{d.get('unattributed_frac', 0) * 100:>7.1f}%"
            + ("  [" + ",".join(flags) + "]" if flags else "")
        )
    worst = decomps[0]
    lines.append("")
    lines.append("worst exemplar:")
    for ln in render_waterfall(worst).splitlines():
        lines.append("  " + ln)
    return "\n".join(lines)
