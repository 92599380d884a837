"""Bounded structured anomaly journal.

Operational anomalies — events an operator wants the last N of, with
context, not just a counter: sync overtakes, slow ticks, stale-vote
storms, redial churn, quorum transitions. Appended by the engine's event
paths (never the per-tick hot loop), queried through the gateway admin
endpoint (``/journal``) and folded into ``/healthz`` as per-kind counts.
"""

from __future__ import annotations

import logging
import time
from collections import Counter as _TallyCounter
from collections import deque
from typing import Callable, Optional

logger = logging.getLogger("rabia_tpu_torch.obs.journal")


class AnomalyJournal:
    """Ring of the last ``cap`` anomalies + total per-kind tallies.

    Entries are stamped with a ``(ts, mono_ns)`` pair — wall clock for
    humans, ``time.monotonic_ns()`` for correlation with the
    flight-recorder rings across NTP steps (both use CLOCK_MONOTONIC on
    Linux). ``on_severe`` (if set) fires after recording any kind in
    :data:`SEVERE` — the engine hooks its flight auto-dump there.
    """

    # canonical kinds (free-form kinds are allowed; these are the ones the
    # engine emits — see docs/OBSERVABILITY.md for the schema)
    SYNC_OVERTAKE = "sync_overtake"
    SLOW_TICK = "slow_tick"
    STALE_STORM = "stale_storm"
    REDIAL_CHURN = "redial_churn"
    QUORUM_LOST = "quorum_lost"
    QUORUM_RESTORED = "quorum_restored"
    WAL_WEDGED = "wal_wedged"  # durability-plane append/fsync failure
    # fleet-plane watchdog kinds (obs/fleet_obs.py BurnRateWatchdog) —
    # deliberately NOT in SEVERE: they describe budget pressure, not a
    # condition whose cause is sliding out of the flight rings
    SLO_BURN = "slo_burn"  # fast+slow burn-rate windows both over budget
    COALESCE_DENSITY_DROP = "coalesce_density_drop"  # results/wave collapsed
    READ_LANE_DEMOTED = "read_lane_demoted"  # off-consensus read fraction sank
    RING_STALE = "ring_stale"  # a ring member stopped answering scrapes

    # kinds severe enough to trigger a flight-recorder dump: each names a
    # condition whose cause is already sliding out of the event rings by
    # the time an operator looks
    SEVERE = frozenset({SYNC_OVERTAKE, STALE_STORM, QUORUM_LOST, WAL_WEDGED})

    def __init__(self, cap: int = 256) -> None:
        self.cap = cap
        self._ring: deque[dict] = deque(maxlen=cap)
        self.tallies: _TallyCounter = _TallyCounter()
        self.on_severe: Optional[Callable[[str], None]] = None

    def record(self, kind: str, **detail) -> None:
        self.tallies[kind] += 1
        self._ring.append(
            {
                "ts": time.time(),
                "mono_ns": time.monotonic_ns(),
                "kind": kind,
                **detail,
            }
        )
        if kind in self.SEVERE and self.on_severe is not None:
            try:
                self.on_severe(kind)
            except Exception:  # a dump hook must never break recording
                logger.exception("journal on_severe hook failed")

    def snapshot(
        self, limit: int = 64, kind: Optional[str] = None
    ) -> list[dict]:
        """Most-recent-last list of journal entries (filtered by kind)."""
        if limit <= 0:
            return []  # items[-0:] would be the WHOLE ring
        items = [
            e for e in self._ring if kind is None or e["kind"] == kind
        ]
        return items[-limit:]

    def counts(self) -> dict[str, int]:
        return dict(self.tallies)

    def __len__(self) -> int:
        return len(self._ring)
