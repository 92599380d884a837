"""Replicated dedup ledger: completed-result records for gateway failover.

Round 13 left non-lead coalesced aliases proposer-local: a replay that
lands on a DIFFERENT gateway than the one that drove the original Submit
could not be answered from any cache until the session lease timed out.
The fleet tier closes that hole above the replica layer: when a fleet
gateway completes a Submit (OK or terminal ERROR), it encodes the
``(client_id, seq) -> (status, payload)`` record and replicates it to
the shard's gateway group — the shard's ring successors
(:meth:`~rabia_tpu_torch.fleet.ring.HashRing.successors`), which by
bounded-movement consistent hashing are exactly the gateways that take
the shard over on failover. A replay arriving at the new owner is then
answered **byte-identical** from the imported record instead of being
re-forwarded (and the engine's deterministic-batch-id ledger backstops
the replication race: a record lost in flight re-proposes under the
SAME batch id and still cannot double-apply).

:func:`apply_record` imports a record through the session table's
op-level conformance surface (hello-free ``submit_check`` +
``complete_op``), so it behaves identically on the Python semantics
owner and the native C table — pinned by the gateway-ops conformance
gate's ``ledger`` op (testing/conformance.py).

Wire format (the ``AdminKind.LEDGER`` query body; little-endian):
``u32 count`` then per record ``[16B client id][u64 seq][u32 shard]
[u8 status][u32 nparts][nparts x (u32 len + bytes)]``.

The port's copy of the reference's ``rabia_tpu/fleet/ledger.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import struct
import uuid
from dataclasses import dataclass

from rabia_tpu_torch.gateway.session import (
    SUBMIT_DUP_CACHED,
    SUBMIT_DUP_INFLIGHT,
    SUBMIT_FRESH,
)


@dataclass(frozen=True)
class LedgerRecord:
    """One completed ``(client_id, seq)`` outcome, replication-ready."""

    client_id: uuid.UUID
    seq: int
    shard: int
    status: int
    payload: tuple[bytes, ...]


def encode_records(records: list[LedgerRecord]) -> bytes:
    out = [struct.pack("<I", len(records))]
    for r in records:
        out.append(r.client_id.bytes)
        out.append(struct.pack("<QIB", r.seq, r.shard, r.status))
        out.append(struct.pack("<I", len(r.payload)))
        for part in r.payload:
            out.append(struct.pack("<I", len(part)))
            out.append(part)
    return b"".join(out)


def decode_records(data: bytes) -> list[LedgerRecord]:
    pos = 4
    (count,) = struct.unpack_from("<I", data, 0)
    records: list[LedgerRecord] = []
    for _ in range(count):
        cid = uuid.UUID(bytes=data[pos : pos + 16])
        pos += 16
        seq, shard, status = struct.unpack_from("<QIB", data, pos)
        pos += 13
        (nparts,) = struct.unpack_from("<I", data, pos)
        pos += 4
        parts = []
        for _ in range(nparts):
            (ln,) = struct.unpack_from("<I", data, pos)
            pos += 4
            parts.append(bytes(data[pos : pos + ln]))
            pos += ln
        records.append(
            LedgerRecord(
                client_id=cid, seq=int(seq), shard=int(shard),
                status=int(status), payload=tuple(parts),
            )
        )
    return records


def apply_record(
    table,
    client_id: uuid.UUID,
    seq: int,
    status: int,
    payload: tuple[bytes, ...],
    frontier_mark: int,
    now=None,
) -> int:
    """Import one replicated completed-result record into a session
    table (Python or native — identical semantics, conformance-pinned).

    The record lands through the normal op surface: ``submit_check``
    classifies the seq, then

    - ``FRESH``: the reservation just taken is completed with the
      record — the replay-answering cache entry;
    - ``DUP_INFLIGHT``: a reservation already existed (an imported
      handoff reservation, or a replay raced ahead of the record) —
      completing it resolves the pending seq with the authoritative
      outcome;
    - ``DUP_CACHED``: already answered here; the record is a no-op;
    - ``SHED_WINDOW``: the session's inflight window is full of real
      reservations — the record is dropped and a later replay
      re-forwards (the engine's deterministic-id ledger still blocks a
      double apply).

    Returns the ``submit_check`` decision so callers (and the
    conformance gate) can observe which path the import took."""
    decision, _st, _pl = table.submit_check(client_id, seq, 0, now=now)
    if decision in (SUBMIT_FRESH, SUBMIT_DUP_INFLIGHT):
        table.complete_op(
            client_id, seq, status, payload, frontier_mark, now=now
        )
    elif decision == SUBMIT_DUP_CACHED:
        pass  # already answered here, byte-identity guaranteed upstream
    return decision
