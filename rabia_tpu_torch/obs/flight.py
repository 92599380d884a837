"""Flight recorder + cross-replica commit traces.

The port of the reference's ``rabia_tpu/obs/flight.py``, with its
cross-node fetch over the gateway's admin frames (:func:`collect_trace`).
The native rings of the tick context, the state kernel and the runtime
merge with the Python ring as in the reference.

Two halves (docs/OBSERVABILITY.md, "Flight recorder"):

1. **Event rings.** The native tick context keeps a fixed-size binary
   event ring written on the C fast path (hostkernel.cpp ``FrEvent``, 32
   bytes/record, versioned ABI mirrored here as :data:`FR_DTYPE`); the
   native transport keeps a per-frame in/out ring (transport.cpp
   ``TfEvent``). :class:`FlightRecorder` is the Python twin — the
   ``RABIA_PY_TICK=1`` tick path feeds it the same event kinds, and the
   engine/gateway event paths (submit/propose/decide/apply/result) feed
   it on BOTH tick paths. ``RabiaEngine.flight_events()`` merges all
   rings into one monotonic-ns-ordered list.

2. **Trace collection.** Batch ids derive deterministically from
   ``(client_id, seq)`` (:func:`batch_id_for`), so consensus frames need
   no new wire fields: a ``TraceQuery`` (AdminKind.TRACE on the existing
   admin frames) asks each replica for its flight-ring slice filtered by
   batch (:func:`build_trace_slice`), and :func:`merge_slices` aligns the
   per-replica monotonic clocks via RTT-midpoint offset estimation and
   renders a single commit timeline.

Clock alignment: each replica reports ``(wall, mono_ns)`` sampled at
serve time; the collector timestamps the request send/receive on its own
wall clock and maps the replica's monotonic domain onto collector wall
time via the RTT midpoint — ``offset = (send+recv)/2 - mono_ns`` — or,
when the replica's ``wall`` lies inside the round trip, via its own
``wall - mono_ns`` (:func:`align_slice`). The error bound is reported as
``err_s`` on each slice; events on the SAME replica keep their exact
monotonic order regardless.
"""

from __future__ import annotations

import hashlib
import json
import time
import uuid
from collections import deque
from typing import Iterable, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Event kind codes — ABI shared with hostkernel.cpp (FRE_*). 1-11 are the
# native-ring kinds (the Python tick path emits the same codes); 12-16 are
# engine/gateway event kinds (both tick paths); 17/18 are the transport
# frame ring's kinds. Codes append, never renumber.
# ---------------------------------------------------------------------------

FRE_FRAME_IN = 1  # consensus frame consumed (arg = wire msg_type)
FRE_ROUTE1 = 2  # R1 vote scattered into the ledger (arg = vote)
FRE_ROUTE2 = 3  # R2 vote scattered into the ledger (arg = vote)
FRE_CARRY = 4  # future-(slot,phase) vote carried (arg = round)
FRE_STALE = 5  # below-applied vote entry (repair path)
FRE_DROP = 6  # frame dropped (arg: 1 spoof, 2 skew, 3 malformed)
FRE_OPEN = 7  # slot armed (arg = initial vote)
FRE_CAST_R2 = 8  # R1 quorum -> R2 cast (arg = cast vote)
FRE_ADVANCE = 9  # weak-MVC phase advance (arg = new phase & 0xFF)
FRE_STEP_DECIDE = 10  # kernel step decided (arg = decided value)
FRE_FRAME_OUT = 11  # outbound frame emitted (arg = wire msg_type)
FRE_SUBMIT = 12  # batch accepted for consensus (batch hash set)
FRE_PROPOSE = 13  # proposer bound the batch to (shard, slot)
FRE_DECIDE = 14  # decision recorded (arg = value)
FRE_APPLY = 15  # slot applied (arg = value)
FRE_RESULT = 16  # gateway result sent (arg = ResultStatus)
FRE_TF_IN = 17  # transport frame in (arg = wire msg_type)
FRE_TF_OUT = 18  # transport frame out (arg = wire msg_type)
FRE_RT_WAKE = 19  # native runtime thread wakeup (arg: 1 frames, 2 idle)
FRE_RT_HANDOFF = 20  # runtime -> Python mailbox handoff (arg = ev type)
FRE_WAL = 21  # durability-plane lifecycle (arg: 1 recovery, 2 checkpoint,
#               3 wal GC; slot carries the event's record/segment count)

# Fleet-tier kinds (Python-only — the fleet gateway has no native ring;
# abi_lint treats FRE_ additions without a C mirror as legal). They carry
# the same batch hash as the replica-tier lifecycle kinds, so one
# (client_id, seq) trace joins across tiers with no new wire fields.
FRE_FLEET_RECV = 22  # fleet gateway accepted a Submit (shard = routed shard)
FRE_FLEET_MOVED = 23  # ownership miss -> MOVED redirect (arg: 1 shard-map,
#                       2 draining; peer = owning gateway index if known)
FRE_FLEET_FWD = 24  # Submit proxied upstream to a replica gateway
FRE_FLEET_RESULT = 25  # upstream Result relayed to the client (arg = status)
FRE_FLEET_LEDGER_SEND = 26  # dedup-ledger entry replicated to a ring
#                             successor (peer = successor gateway index)
FRE_FLEET_LEDGER_APPLY = 27  # replicated ledger entry applied locally

# Critical-path kinds (Python-only, like the fleet tier). FRE_GW_RECV
# stamps the instant a replica gateway accepted a FRESH Submit — before
# the coalesce-park/drive branch — so the slowlog decomposer can split
# gateway queueing from coalesce parking. FRE_BARRIER stamps the return
# from the durability barrier so fsync wait is a measured segment, not
# the gap left over between apply and result.
FRE_GW_RECV = 28  # gateway accepted a fresh Submit (arg: 1 coalesced)
FRE_BARRIER = 29  # durability barrier crossed for the batch's wave

FR_KIND_NAMES = {
    FRE_FRAME_IN: "frame_in",
    FRE_ROUTE1: "route1",
    FRE_ROUTE2: "route2",
    FRE_CARRY: "carry",
    FRE_STALE: "stale",
    FRE_DROP: "drop",
    FRE_OPEN: "open",
    FRE_CAST_R2: "cast_r2",
    FRE_ADVANCE: "advance",
    FRE_STEP_DECIDE: "step_decide",
    FRE_FRAME_OUT: "frame_out",
    FRE_SUBMIT: "submit",
    FRE_PROPOSE: "propose",
    FRE_DECIDE: "decide",
    FRE_APPLY: "apply",
    FRE_RESULT: "result",
    FRE_TF_IN: "tf_in",
    FRE_TF_OUT: "tf_out",
    FRE_RT_WAKE: "rt_wake",
    FRE_RT_HANDOFF: "rt_handoff",
    FRE_WAL: "wal",
    FRE_FLEET_RECV: "fleet_recv",
    FRE_FLEET_MOVED: "fleet_moved",
    FRE_FLEET_FWD: "fleet_fwd",
    FRE_FLEET_RESULT: "fleet_result",
    FRE_FLEET_LEDGER_SEND: "fleet_ledger_send",
    FRE_FLEET_LEDGER_APPLY: "fleet_ledger_apply",
    FRE_GW_RECV: "gw_recv",
    FRE_BARRIER: "barrier",
}

NO_PEER = 0xFFFF

# the native ring's 32-byte record layout (hostkernel.cpp FrEvent), field
# for field; numpy structured dtypes are unpadded so itemsize is exactly
# rk_flight_record_size()
FR_DTYPE = np.dtype(
    [
        ("t_ns", "<u8"),
        ("slot", "<u8"),
        ("batch", "<u8"),
        ("shard", "<u4"),
        ("peer", "<u2"),
        ("kind", "u1"),
        ("arg", "u1"),
    ]
)
assert FR_DTYPE.itemsize == 32

# the transport ring's 24-byte record (transport.cpp TfEvent)
TF_DTYPE = np.dtype(
    [
        ("t_ns", "<u8"),
        ("peer", "<u8"),
        ("len", "<u4"),
        ("dir", "u1"),
        ("msg_type", "u1"),
        ("pad", "<u2"),
    ]
)
assert TF_DTYPE.itemsize == 24


def batch_id_for(client_id: uuid.UUID, seq: int) -> uuid.UUID:
    """The deterministic batch id a gateway derives for ``(client_id,
    seq)`` (gateway/server._deterministic_batch uses this) — the reason
    the trace protocol needs no new wire fields: any replica can name a
    client command's batch from the session coordinates alone."""
    seed = client_id.bytes + int(seq).to_bytes(8, "little")
    return uuid.UUID(bytes=hashlib.blake2s(seed, digest_size=16).digest())


def fr_hash(batch_id) -> int:
    """64-bit flight-record hash of a batch id (``BatchId`` or ``UUID``).
    Collision odds over a 4096-record ring are negligible; the hash keys
    ring records only, never dedup/commit decisions."""
    raw = getattr(batch_id, "value", batch_id).bytes
    return int.from_bytes(
        hashlib.blake2s(raw, digest_size=8).digest(), "little"
    )


class FlightRecorder:
    """Python-side flight ring (the C ring's twin).

    Bounded deque of plain tuples; ``record`` is the hot call — one
    ``monotonic_ns`` read and one append, no allocation beyond the
    tuple. Fed by the ``RABIA_PY_TICK=1`` tick paths (same kinds as the
    C ring) and by the engine/gateway event paths on both tick paths.
    """

    __slots__ = ("cap", "_ring", "head")

    def __init__(self, cap: int = 4096) -> None:
        self.cap = cap
        self._ring: deque = deque(maxlen=cap)
        self.head = 0  # total records ever written (like rk_flight_head)

    def record(
        self,
        kind: int,
        shard: int = 0,
        slot: int = 0,
        peer: int = NO_PEER,
        arg: int = 0,
        batch: int = 0,
    ) -> None:
        self.head += 1
        self._ring.append(
            (time.monotonic_ns(), kind, shard, slot, peer, arg, batch)
        )

    def __len__(self) -> int:
        return len(self._ring)

    def state(self) -> dict:
        """Ring head/wrap document for trace wrap-honesty stamps: once
        ``head`` exceeds ``cap`` the ring has evicted records, and any
        trace sliced from it may be silently partial — ``oldest_t_ns``
        bounds how far back the retained window reaches."""
        return {
            "head": self.head,
            "cap": self.cap,
            "wrapped": self.head > self.cap,
            "oldest_t_ns": self._ring[0][0] if self._ring else None,
        }

    def snapshot(self) -> list[dict]:
        """Oldest-first event dicts (the merged-view element shape)."""
        return [
            {
                "t_ns": t,
                "kind": FR_KIND_NAMES.get(k, str(k)),
                "shard": s,
                "slot": sl,
                "peer": p,
                "arg": a,
                "batch": b,
            }
            for t, k, s, sl, p, a, b in self._ring
        ]


def native_ring_events(records: np.ndarray) -> list[dict]:
    """Convert a native FR_DTYPE snapshot into merged-view dicts (the
    columns go to Python ints in one ``tolist`` each: the reference's
    per-record conversion, a few times faster)."""
    names = FR_KIND_NAMES
    return [
        {
            "t_ns": t,
            "kind": names.get(k, str(k)),
            "shard": sh,
            "slot": sl,
            "peer": pe,
            "arg": a,
            "batch": b,
        }
        for t, k, sh, sl, pe, a, b in zip(
            records["t_ns"].tolist(), records["kind"].tolist(),
            records["shard"].tolist(), records["slot"].tolist(),
            records["peer"].tolist(), records["arg"].tolist(),
            records["batch"].tolist(),
        )
    ]


def transport_ring_events(records: np.ndarray) -> list[dict]:
    """Convert a TF_DTYPE snapshot into merged-view dicts. ``peer`` here
    is the id-tail (last 8 bytes of the peer node id as u64), a different
    domain than the consensus rows — kept under ``peer_tail``."""
    return [
        {
            "t_ns": t,
            "kind": "tf_in" if d == 0 else "tf_out",
            "shard": 0,
            "slot": 0,
            "peer": NO_PEER,
            "peer_tail": pe,
            "arg": m,
            "batch": 0,
            "len": ln,
        }
        for t, d, pe, m, ln in zip(
            records["t_ns"].tolist(), records["dir"].tolist(),
            records["peer"].tolist(), records["msg_type"].tolist(),
            records["len"].tolist(),
        )
    ]


# ---------------------------------------------------------------------------
# Trace slicing (replica side — served via AdminKind.TRACE)
# ---------------------------------------------------------------------------

def slice_truncated(
    ring_state: Sequence[dict], t_hits: Sequence[int]
) -> bool:
    """Whether a trace sliced from ``ring_state`` rings may be missing
    events for a batch first seen at ``min(t_hits)``.

    All rings on one node share CLOCK_MONOTONIC, so the test is direct:
    a ring that has wrapped AND whose oldest retained record is newer
    than the batch's earliest observed event may have evicted events
    from the batch's early life (typically a different ring than the
    one that produced the earliest hit — e.g. the native tick ring
    wrapping past a long-parked submit that the Python ring kept)."""
    if not t_hits:
        return False
    tmin = min(t_hits)
    for r in ring_state:
        if not r.get("wrapped"):
            continue
        oldest = r.get("oldest_t_ns")
        if oldest is not None and oldest > tmin:
            return True
    return False


# kinds whose (shard, slot) join identifies a batch's consensus slot
_SLOT_BEARING = frozenset(
    {"propose", "decide", "apply"}
)
# kinds included by (shard, slot) match (everything slot-scoped except the
# batch-keyed lifecycle kinds, which match by hash anyway)
_SLOT_SCOPED = frozenset(
    {
        "frame_in", "route1", "route2", "carry", "stale", "open",
        "cast_r2", "advance", "step_decide", "frame_out", "decide",
        "apply", "propose",
    }
)
_TF_KINDS = frozenset({"tf_in", "tf_out"})


def build_trace_slice(
    engine,
    batch_hash: int,
    window_ns: int = 50_000_000,
    events: Optional[list] = None,
) -> dict:
    """One replica's flight-ring slice for a batch.

    Selection: every event carrying ``batch_hash``; every slot-scoped
    event on a ``(shard, slot)`` the batch's lifecycle events name; and
    transport frame events within ``window_ns`` of the batch's event
    span (a transport stall near the commit is exactly what the trace is
    for). Returns the TraceSlice document (JSON-serializable).

    ``events``: the engine's ``flight_events()`` already read (the port's
    addition), so slicing many batches at one instant reads its rings
    once."""
    if events is None:
        events = engine.flight_events()
    hits = [e for e in events if batch_hash and e.get("batch") == batch_hash]
    slots = {
        (e["shard"], e["slot"]) for e in hits if e["kind"] in _SLOT_BEARING
    }
    t_hits = [e["t_ns"] for e in hits]
    tmin = min(t_hits) - window_ns if t_hits else None
    tmax = max(t_hits) + window_ns if t_hits else None
    sel = []
    for e in events:
        if batch_hash and e.get("batch") == batch_hash:
            sel.append(e)
        elif e["kind"] in _SLOT_SCOPED and (e["shard"], e["slot"]) in slots:
            sel.append(e)
        elif (
            e["kind"] in _TF_KINDS
            and tmin is not None
            and tmin <= e["t_ns"] <= tmax
        ):
            sel.append(e)
    ring_getter = getattr(engine, "flight_ring_state", None)
    ring_state = list(ring_getter()) if ring_getter is not None else []
    return {
        "version": 1,
        "node": str(engine.node_id.value),
        "row": int(engine.me),
        "rows": {
            str(r): str(n.value) for r, n in engine._row_to_node.items()
        },
        "wall": time.time(),
        "mono_ns": time.monotonic_ns(),
        "batch_hash": int(batch_hash),
        "ring": ring_state,
        "truncated": slice_truncated(ring_state, t_hits),
        "events": sel,
    }


def build_fleet_trace_slice(
    recorder: "FlightRecorder",
    node: str,
    row: int,
    batch_hash: int,
) -> dict:
    """A fleet gateway's TraceSlice for a batch — same document schema as
    :func:`build_trace_slice` (so :func:`align_slice` / :func:`merge_slices`
    work unchanged) with ``tier: "fleet"`` marking the routing hop. The
    fleet tier has no consensus slots, so selection is batch-hash only;
    ``row`` is the fleet gateway's index in its own tier (rendered as the
    gateway name, never confused with replica rows)."""
    events = [
        e for e in recorder.snapshot()
        if batch_hash and e.get("batch") == batch_hash
    ]
    ring_state = [recorder.state()]
    return {
        "version": 1,
        "tier": "fleet",
        "node": node,
        "row": int(row),
        "rows": {},
        "wall": time.time(),
        "mono_ns": time.monotonic_ns(),
        "batch_hash": int(batch_hash),
        "ring": ring_state,
        "truncated": slice_truncated(
            ring_state, [e["t_ns"] for e in events]
        ),
        "events": events,
    }


# ---------------------------------------------------------------------------
# Clock alignment + merging (collector side)
# ---------------------------------------------------------------------------


def align_slice(slice_doc: dict, send_wall: float, recv_wall: float) -> dict:
    """Annotate a TraceSlice with its monotonic→collector-wall offset.

    ``send_wall``/``recv_wall`` bracket the admin round trip on the
    collector's clock; the replica's ``mono_ns`` was sampled in between.
    When the replica's own ``wall``, read together with ``mono_ns``,
    falls inside the bracket, its clock agrees with the collector's to
    within the measurement and its own pairing places the sample (exact
    when both share a clock, as every node of one host does); the error
    bound is then the larger distance from ``wall`` to either end.
    Otherwise the sample is estimated at the midpoint, error bound
    ±(recv-send)/2.

    The reference always takes the midpoint. A loaded host answers
    unevenly inside the bracket, so two nodes' midpoint offsets can
    differ by milliseconds and reorder events that causality orders
    (a MOVED hop and the owner's forward, a few ms apart)."""
    rtt = max(0.0, recv_wall - send_wall)
    mono = slice_doc["mono_ns"] * 1e-9
    wall = slice_doc.get("wall")
    if wall is not None and send_wall <= wall <= recv_wall:
        slice_doc["offset_s"] = wall - mono
        slice_doc["err_s"] = max(wall - send_wall, recv_wall - wall)
    else:
        slice_doc["offset_s"] = (send_wall + recv_wall) / 2.0 - mono
        slice_doc["err_s"] = rtt / 2.0
    return slice_doc


def merge_slices(slices: Sequence[dict]) -> list[dict]:
    """Merge aligned TraceSlices into one timeline, sorted by aligned
    collector wall time. Each entry gains ``t`` (aligned seconds),
    ``node``/``row`` and ``err_s``; per-replica event order is preserved
    exactly (one offset per replica shifts, never reorders)."""
    merged: list[dict] = []
    for sl in slices:
        off = sl.get("offset_s")
        if off is None:
            raise ValueError("slice not aligned (call align_slice first)")
        for e in sl["events"]:
            entry = dict(e)
            entry["t"] = off + e["t_ns"] * 1e-9
            entry["node"] = sl["node"]
            entry["row"] = sl["row"]
            entry["err_s"] = sl["err_s"]
            entry["tier"] = sl.get("tier", "replica")
            entry["truncated"] = bool(sl.get("truncated", False))
            merged.append(entry)
    merged.sort(key=lambda e: (e["t"], e["row"], e["t_ns"]))
    return merged


async def collect_trace(
    addrs: Iterable[tuple[str, int]],
    client_id: uuid.UUID,
    seq: int,
    timeout: float = 10.0,
) -> list[dict]:
    """Fetch + align + merge TraceSlices from every gateway in ``addrs``
    for the command ``(client_id, seq)``. Replicas that cannot be
    reached are skipped (a trace from the surviving quorum is still a
    trace); raises only if NO replica answered."""
    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway.client import admin_fetch_timed

    import asyncio

    query = json.dumps({"client": client_id.hex, "seq": int(seq)}).encode()
    addrs = list(addrs)
    results = await asyncio.gather(
        *(
            admin_fetch_timed(
                host, port, int(AdminKind.TRACE), query=query,
                timeout=timeout,
            )
            for host, port in addrs
        ),
        return_exceptions=True,
    )
    slices = []
    errors = []
    for (host, port), res in zip(addrs, results):
        if isinstance(res, BaseException):
            errors.append(f"{host}:{port}: {type(res).__name__}: {res}")
            continue
        body, send_wall, recv_wall = res
        slices.append(align_slice(json.loads(body), send_wall, recv_wall))
    if not slices:
        raise RuntimeError(
            "trace: no replica answered (" + "; ".join(errors) + ")"
        )
    return merge_slices(slices)


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

_STAGE_LABELS = {
    "submit": "submit",
    "propose": "propose",
    "open": "open slot",
    "frame_in": "frame in",
    "route1": "R1 vote",
    "route2": "R2 vote",
    "carry": "vote carried",
    "stale": "stale vote",
    "cast_r2": "cast R2",
    "advance": "phase advance",
    "step_decide": "kernel decide",
    "decide": "decide",
    "apply": "apply",
    "result": "result",
    "frame_out": "frame out",
    "tf_in": "wire in",
    "tf_out": "wire out",
    "drop": "DROP",
    "fleet_recv": "fleet recv",
    "fleet_moved": "MOVED redirect",
    "fleet_fwd": "fleet forward",
    "fleet_result": "fleet result",
    "fleet_ledger_send": "ledger send",
    "fleet_ledger_apply": "ledger apply",
    "gw_recv": "gateway recv",
    "barrier": "durability barrier",
}

_FLEET_KINDS = frozenset(
    {
        "fleet_recv", "fleet_moved", "fleet_fwd", "fleet_result",
        "fleet_ledger_send", "fleet_ledger_apply",
    }
)

_WIRE_KIND = {2: "R1", 3: "R2", 4: "Decision"}


def _describe(e: dict) -> str:
    kind = e["kind"]
    label = _STAGE_LABELS.get(kind, kind)
    bits = [label]
    if kind in ("frame_in", "frame_out", "tf_in", "tf_out"):
        bits.append(_WIRE_KIND.get(e["arg"], f"type{e['arg']}"))
    elif kind in ("route1", "route2", "open", "cast_r2", "decide", "apply"):
        bits.append(f"v={e['arg']}")
    if kind in _SLOT_SCOPED:
        bits.append(f"shard {e['shard']} slot {e['slot']}")
    elif kind in _FLEET_KINDS:
        bits.append(f"shard {e['shard']}")
    if e.get("peer", NO_PEER) != NO_PEER:
        if kind in _FLEET_KINDS:
            bits.append(f"peer gw {e['peer']}")
        else:
            bits.append(f"from row {e['peer']}")
    if e.get("len"):
        bits.append(f"{e['len']}B")
    return " ".join(bits)


def render_timeline(merged: Sequence[dict]) -> str:
    """Human-readable commit timeline, one line per event, times relative
    to the first event (aligned collector wall clock)."""
    if not merged:
        return "(no events)"
    t0 = merged[0]["t"]
    lines = [
        f"{len(merged)} events across "
        f"{len({e['node'] for e in merged})} nodes; "
        f"clock-alignment error bound ±"
        f"{max(e['err_s'] for e in merged) * 1e3:.2f} ms"
    ]
    cut = {e["node"] for e in merged if e.get("truncated")}
    if cut:
        lines.append(
            f"  WARNING: flight ring wrapped past this batch on "
            f"{len(cut)} node(s) ({', '.join(sorted(cut))}) — "
            "timeline may be missing early events"
        )
    for e in merged:
        who = (
            f"gw {e['node']}" if e.get("tier") == "fleet"
            else f"row{e['row']}"
        )
        lines.append(
            f"  +{(e['t'] - t0) * 1e3:9.3f} ms  {who}  "
            f"{_describe(e)}"
        )
    return "\n".join(lines)


def timeline_stages(merged: Sequence[dict]) -> dict[str, list[dict]]:
    """Index a merged timeline by kind (test/assert convenience)."""
    out: dict[str, list[dict]] = {}
    for e in merged:
        out.setdefault(e["kind"], []).append(e)
    return out


def dump_events(
    path: str,
    events: list[dict],
    meta: Optional[dict] = None,
) -> str:
    """Write a flight dump (JSON: meta + events) to ``path``."""
    doc = dict(meta or {})
    doc["wall"] = time.time()
    doc["mono_ns"] = time.monotonic_ns()
    doc["events"] = events
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
