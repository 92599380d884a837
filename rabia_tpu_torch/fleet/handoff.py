"""Session handoff: transfer live sessions between fleet gateways.

When the ring reassigns shards (member added/removed, planned drain),
the departing gateway exports every session homed to a moved shard —
window grant, ack frontier, cached results, inflight reservations — and
ships the blob to the new owner inside an ``AdminKind.HANDOFF`` admin
frame. Only after the import is acked does the departing gateway start
answering ``MOVED`` for those shards, so a redirected client's replay
always finds its dedup state already resident at the new owner.

Export reads the Python :class:`~rabia_tpu_torch.gateway.session.SessionTable`
directly (the fleet gateway's table; the semantics owner). Import goes
through the op-level conformance surface only (``hello`` →
``submit_check`` → ``complete_op``), so it lands identically on the
native C table — the same property :mod:`rabia_tpu_torch.fleet.ledger` leans
on. Two invariants make the replay lossless:

- results GC'd before export had ``seq <= ack_upto`` — the client
  acknowledged receipt and will never replay them;
- inflight seqs import as bare reservations (``SUBMIT_FRESH``, left
  open). The authoritative outcome arrives later as a replicated
  ledger record (``DUP_INFLIGHT`` → ``complete_op``) or the client's
  own replay re-drives it under the same deterministic batch id.

Wire format (little-endian): ``u32 nsessions`` then per session
``[16B client id][u32 window][u64 ack_upto][u32 nresults x (u64 seq,
u8 status, u32 nparts, parts)][u32 ninflight x u64 seq]``.

The port's copy of the reference's ``rabia_tpu/fleet/handoff.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import struct
import uuid
from dataclasses import dataclass, field
from typing import Iterable, Optional

from rabia_tpu_torch.gateway.session import (
    SUBMIT_FRESH,
    SessionTable,
)


@dataclass(frozen=True)
class SessionExport:
    """One session's transferable state."""

    client_id: uuid.UUID
    window: int
    ack_upto: int
    # (seq, status, payload-parts) — the replayable result cache
    results: tuple[tuple[int, int, tuple[bytes, ...]], ...]
    inflight: tuple[int, ...]  # reserved-but-unfinished seqs


@dataclass
class HandoffSummary:
    """What an import actually landed (surfaced in logs/metrics)."""

    sessions: int = 0
    results: int = 0
    inflight: int = 0
    skipped: int = 0  # non-FRESH collisions (already present/shed here)
    clients: list = field(default_factory=list)


def export_sessions(
    table: SessionTable, client_ids: Iterable[uuid.UUID]
) -> list[SessionExport]:
    out: list[SessionExport] = []
    for cid in client_ids:
        sess = table.sessions.get(cid)
        if sess is None:
            continue
        out.append(
            SessionExport(
                client_id=cid,
                window=sess.window,
                ack_upto=sess.ack_upto,
                results=tuple(
                    (seq, r.status, r.payload)
                    for seq, r in sorted(sess.results.items())
                ),
                inflight=tuple(sorted(sess.inflight)),
            )
        )
    return out


def encode_handoff(exports: list[SessionExport]) -> bytes:
    out = [struct.pack("<I", len(exports))]
    for e in exports:
        out.append(e.client_id.bytes)
        out.append(struct.pack("<IQ", e.window, e.ack_upto))
        out.append(struct.pack("<I", len(e.results)))
        for seq, status, parts in e.results:
            out.append(struct.pack("<QBI", seq, status, len(parts)))
            for part in parts:
                out.append(struct.pack("<I", len(part)))
                out.append(part)
        out.append(struct.pack("<I", len(e.inflight)))
        for seq in e.inflight:
            out.append(struct.pack("<Q", seq))
    return b"".join(out)


def decode_handoff(data: bytes) -> list[SessionExport]:
    pos = 4
    (count,) = struct.unpack_from("<I", data, 0)
    exports: list[SessionExport] = []
    for _ in range(count):
        cid = uuid.UUID(bytes=data[pos : pos + 16])
        pos += 16
        window, ack_upto = struct.unpack_from("<IQ", data, pos)
        pos += 12
        (nres,) = struct.unpack_from("<I", data, pos)
        pos += 4
        results = []
        for _ in range(nres):
            seq, status, nparts = struct.unpack_from("<QBI", data, pos)
            pos += 13
            parts = []
            for _ in range(nparts):
                (ln,) = struct.unpack_from("<I", data, pos)
                pos += 4
                parts.append(bytes(data[pos : pos + ln]))
                pos += ln
            results.append((int(seq), int(status), tuple(parts)))
        (ninf,) = struct.unpack_from("<I", data, pos)
        pos += 4
        inflight = struct.unpack_from("<%dQ" % ninf, data, pos)
        pos += 8 * ninf
        exports.append(
            SessionExport(
                client_id=cid,
                window=int(window),
                ack_upto=int(ack_upto),
                results=tuple(results),
                inflight=tuple(int(s) for s in inflight),
            )
        )
    return exports


def import_sessions(
    table,
    exports: list[SessionExport],
    frontier_mark: int,
    now: Optional[float] = None,
) -> HandoffSummary:
    """Land exported sessions on the new owner's table via the op API.

    Per session: ``hello`` re-opens it with the granted window, then
    every cached result replays as ``submit_check`` (carrying the
    exported ack frontier — ``submit_check`` is the op-level way to
    advance it) followed by ``complete_op``, and every inflight seq
    reserves via ``submit_check`` and is deliberately left open. A
    non-FRESH decision means this table already knows the seq (replay
    raced the handoff, or a ledger record landed first) — counted as
    ``skipped``, never overwritten: first completion wins everywhere.
    """
    summary = HandoffSummary()
    for e in exports:
        table.hello(e.client_id, e.window, now=now)
        summary.sessions += 1
        summary.clients.append(e.client_id)
        for seq, status, parts in e.results:
            decision, _st, _pl = table.submit_check(
                e.client_id, seq, e.ack_upto, now=now
            )
            if decision == SUBMIT_FRESH:
                table.complete_op(
                    e.client_id, seq, status, parts, frontier_mark, now=now
                )
                summary.results += 1
            else:
                summary.skipped += 1
        for seq in e.inflight:
            decision, _st, _pl = table.submit_check(
                e.client_id, seq, e.ack_upto, now=now
            )
            if decision == SUBMIT_FRESH:
                summary.inflight += 1  # left reserved on purpose
            else:
                summary.skipped += 1
    return summary
