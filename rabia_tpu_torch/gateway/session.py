"""Per-replica client session table: exactly-once command semantics.

Velos (arXiv:2106.08676) carves the client-facing path — session state,
retry dedup, read leases — out of the consensus core as its own
subsystem; this module is that state. Every client command carries a
``(client_id, seq)`` pair; a session keeps the results of completed
seqs so a duplicate submission (client retry, reconnect replay) is
answered from cache instead of re-proposed, and tracks in-flight seqs
so concurrent duplicates attach to the original proposal.

GC is tied to the engine's decided frontier: a cached result becomes
evictable only once (a) the client acknowledged receiving it
(``ack_upto``) AND (b) the engine's state version moved past the
version recorded at completion — the decided frontier has provably
advanced beyond the command's slot, so no in-flight consensus path can
re-surface it. Idle sessions age out whole after ``session_ttl``; a
hard ``lease_ttl`` (default 4x the idle ttl) drops a session even with
in-flight seqs, so a stalled frontier (no quorum, wedged engine) cannot
pin dead sessions forever — a replay of a lease-dropped seq re-proposes
under the SAME deterministic batch id and the engine's ``applied_ids``
ledger still blocks the double apply.

This table is the SEMANTICS OWNER of the gateway session plane: the C
twin (native/sessionkernel.cpp via gateway/native_session.py) mirrors
every decision and cached byte here, ``RABIA_PY_GATEWAY=1`` forces this
table, and ``testing.conformance.run_gateway_ops_on_both_tables`` pins
the two byte-identical. The op-level API (:meth:`hello`,
:meth:`submit_check`, :meth:`complete_op`, :meth:`abort`, :meth:`gc`)
is the conformance surface — the gateway server calls only these.

The port's copy of the reference's ``rabia_tpu/gateway/session.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

# submit_check decisions (shared with the native kernel's gws_submit)
SUBMIT_FRESH = 0  # reserved in the inflight window; caller drives it
SUBMIT_DUP_CACHED = 1  # completed seq: answer from cache
SUBMIT_DUP_INFLIGHT = 2  # in-flight duplicate: the original answers
SUBMIT_SHED_WINDOW = 3  # session inflight window full: shed retryable


@dataclass(frozen=True)
class CachedResult:
    """One completed seq's outcome, replayable to duplicate submits."""

    status: int
    payload: tuple[bytes, ...]
    frontier_mark: int  # engine state_version when the result completed


@dataclass
class SessionStats:
    sessions_opened: int = 0
    duplicate_submits: int = 0
    results_cached: int = 0
    results_evicted: int = 0
    sessions_expired: int = 0
    leases_expired: int = 0  # hard-lease drops (inflight notwithstanding)


@dataclass
class GatewaySession:
    """One client's gateway-side state."""

    client_id: uuid.UUID
    window: int
    inflight: dict = field(default_factory=dict)  # seq -> opaque
    results: dict = field(default_factory=dict)  # seq -> CachedResult
    ack_upto: int = 0
    highest_completed: int = 0
    last_active: float = field(default_factory=time.time)

    def touch(self, now: Optional[float] = None) -> None:
        self.last_active = time.time() if now is None else now

    def complete(self, seq: int, result: CachedResult) -> None:
        self.results[seq] = result
        if seq > self.highest_completed:
            self.highest_completed = seq


class SessionTable:
    """client_id -> :class:`GatewaySession`, with frontier-tied GC."""

    is_native = False

    def __init__(
        self,
        default_window: int = 64,
        session_ttl: float = 600.0,
        result_cache_cap: int = 4096,
        lease_ttl: Optional[float] = None,
    ) -> None:
        self.default_window = max(1, default_window)
        self.session_ttl = session_ttl
        self.result_cache_cap = max(1, result_cache_cap)
        # the hard lease: even a session with in-flight seqs is dropped
        # once it has been silent this long (see module doc)
        self.lease_ttl = (
            lease_ttl if lease_ttl is not None else 4.0 * session_ttl
        )
        self.sessions: dict[uuid.UUID, GatewaySession] = {}
        self.stats = SessionStats()

    # -- op-level API (the conformance surface; server.py calls these) ------

    def hello(
        self,
        client_id: uuid.UUID,
        requested_window: int = 0,
        now: Optional[float] = None,
    ) -> tuple[int, int]:
        """Open or resume the session; returns ``(window, last_seq)``
        for the hello ack."""
        sess = self.ensure(client_id, requested_window, now=now)
        return sess.window, sess.highest_completed

    def submit_check(
        self,
        client_id: uuid.UUID,
        seq: int,
        ack_upto: int = 0,
        now: Optional[float] = None,
    ) -> tuple[int, int, tuple[bytes, ...]]:
        """The submit hot path in ONE table operation: ensure/touch the
        session, advance its ack frontier, and classify the seq.
        Returns ``(decision, status, payload)`` — status/payload are
        meaningful only for ``SUBMIT_DUP_CACHED`` (the RAW cached
        status; the server maps OK to CACHED on the wire). A ``FRESH``
        decision RESERVES the seq in the inflight window; the caller
        must end it with :meth:`complete_op` or :meth:`abort`."""
        sess = self.ensure(client_id, now=now)
        if ack_upto > sess.ack_upto:
            sess.ack_upto = ack_upto
        cached = sess.results.get(seq)
        if cached is not None:
            self.stats.duplicate_submits += 1
            return SUBMIT_DUP_CACHED, cached.status, cached.payload
        if seq in sess.inflight:
            self.stats.duplicate_submits += 1
            return SUBMIT_DUP_INFLIGHT, 0, ()
        if len(sess.inflight) >= sess.window:
            return SUBMIT_SHED_WINDOW, 0, ()
        sess.inflight[seq] = None  # reserved synchronously (dedup window)
        return SUBMIT_FRESH, 0, ()

    def complete_op(
        self,
        client_id: uuid.UUID,
        seq: int,
        status: int,
        payload: tuple[bytes, ...],
        frontier_mark: int,
        now: Optional[float] = None,
    ) -> bool:
        """Finish a FRESH seq: drop the inflight reservation and cache
        the result. Returns False (a no-op) when the session is gone —
        lease-expired mid-flight; the client's replay re-opens it."""
        sess = self.sessions.get(client_id)
        if sess is None:
            return False
        sess.inflight.pop(seq, None)
        sess.complete(
            seq,
            CachedResult(
                status=int(status),
                payload=tuple(bytes(p) for p in payload),
                frontier_mark=int(frontier_mark),
            ),
        )
        self.stats.results_cached += 1
        sess.touch(now)
        return True

    def abort(self, client_id: uuid.UUID, seq: int) -> None:
        """Release a FRESH reservation without caching anything (the
        submit was shed/rejected before any proposal committed)."""
        sess = self.sessions.get(client_id)
        if sess is not None:
            sess.inflight.pop(seq, None)

    def cached_result(
        self, client_id: uuid.UUID, seq: int
    ) -> Optional[CachedResult]:
        sess = self.sessions.get(client_id)
        if sess is None:
            return None
        return sess.results.get(seq)

    # -- session objects (tests, repair paths) ------------------------------

    def ensure(
        self,
        client_id: uuid.UUID,
        requested_window: int = 0,
        now: Optional[float] = None,
    ) -> GatewaySession:
        """Open or resume the client's session. The granted window is the
        gateway's default capped further by the client's request (a
        client may shrink its window, never grow past the gateway's)."""
        sess = self.sessions.get(client_id)
        if sess is None:
            sess = GatewaySession(
                client_id=client_id, window=self.default_window
            )
            self.sessions[client_id] = sess
            self.stats.sessions_opened += 1
        if requested_window > 0:
            # renegotiable on resume too — a reconnecting client may ask
            # for a stricter window than its previous session had
            sess.window = min(self.default_window, requested_window)
        sess.touch(now)
        return sess

    def get(self, client_id: uuid.UUID) -> Optional[GatewaySession]:
        return self.sessions.get(client_id)

    def gc(self, state_version: int, now: Optional[float] = None) -> int:
        """Evict acknowledged results the decided frontier has moved past,
        cap runaway per-session caches, expire idle sessions, and sweep
        hard-expired leases (a stalled frontier must not pin dead
        sessions — the lease sweep is frontier-INDEPENDENT by design).
        Returns the number of evicted results."""
        now = time.time() if now is None else now
        evicted = 0
        dead: list[uuid.UUID] = []
        for cid, sess in self.sessions.items():
            if sess.results:
                gone = [
                    seq
                    for seq, r in sess.results.items()
                    if seq <= sess.ack_upto and r.frontier_mark < state_version
                ]
                for seq in gone:
                    del sess.results[seq]
                evicted += len(gone)
                # hard cap against a client that never acks: evict oldest
                # seqs first. A replay of an evicted seq re-proposes, but
                # under the SAME deterministic batch id (server.
                # _deterministic_batch), so the engine's applied_ids
                # ledger still blocks a double apply — this cache only
                # saves the round trip and the burned slot
                if len(sess.results) > self.result_cache_cap:
                    for seq in sorted(sess.results)[
                        : len(sess.results) - self.result_cache_cap
                    ]:
                        del sess.results[seq]
                        evicted += 1
            idle = now - sess.last_active
            if idle > self.lease_ttl:
                # hard lease: expired regardless of inflight seqs — a
                # wedged engine keeping futures pending forever must not
                # make the session immortal (GC-under-frontier-stall)
                dead.append(cid)
                self.stats.leases_expired += 1
            elif not sess.inflight and idle > self.session_ttl:
                dead.append(cid)
        for cid in dead:
            sess = self.sessions.pop(cid)
            evicted += len(sess.results)
            self.stats.sessions_expired += 1
        self.stats.results_evicted += evicted
        return evicted

    def __len__(self) -> int:
        return len(self.sessions)
