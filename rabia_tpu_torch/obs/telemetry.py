"""Per-second telemetry rings: continuous curves, not end-of-run sums.

A soak run or a chaos test that only reports end-of-run aggregates hides
exactly the part that matters — the dip during the partition, the shed
burst when the queue saturated. :class:`TelemetrySampler` keeps a bounded
ring of timestamped :meth:`~rabia_tpu_torch.obs.registry.MetricsRegistry.
snapshot` documents per replica (1 Hz by default, ~15 min of history at
the default cap), sampled from a daemon thread — registry reads are
snapshot-style and safe from a foreign thread, same contract as the HTTP
shim.

The ring is served two ways (both read-only):

- ``AdminKind.TIMELINE`` on the gateway's framed admin surface
  (query ``{"last": N}`` bounds the reply);
- ``GET /timeline?last=N`` on the observability HTTP shim.

Each sample carries ``(wall, mono_ns)`` in the replica's own clock
domain; :func:`collect_timeline` fetches the rings from every replica,
estimates each replica's monotonic→collector-wall offset at the admin
round trip's midpoint (the obs.flight clock-alignment model, error bound
±RTT/2), and merges everything into ONE clock-aligned multi-replica time
series — the ops CLI's ``timeline`` renders it, the loadgen and CI
dump it as an artifact.

The port's copy of the reference's ``rabia_tpu/obs/telemetry.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Iterable, Optional, Sequence

TIMELINE_VERSION = 1


class TelemetrySampler:
    """Bounded 1 Hz ring of registry snapshots for one replica."""

    def __init__(
        self,
        registry,
        node: str = "",
        interval: float = 1.0,
        cap: int = 900,
    ) -> None:
        self.registry = registry
        self.node = node
        self.interval = max(0.05, float(interval))
        self.cap = int(cap)
        self._ring: deque = deque(maxlen=self.cap)
        # appends come from the sampler daemon thread while document()
        # materializes the ring from HTTP-shim/executor threads; an
        # unlocked list(deque) during a concurrent append raises
        # RuntimeError("deque mutated during iteration")
        self._ring_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "TelemetrySampler":
        if self._thread is None:
            # a restarted sampler (close() then start()) must not inherit
            # the stop flag, or the new thread exits on its first check
            # and the ring silently freezes
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="rabia-telemetry"
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        # phase-locked to the interval grid (monotonic): a slow scrape
        # skips ahead instead of drifting, so samples stay ~1/s apart
        next_at = time.monotonic()
        while not self._stop.is_set():
            self.sample()
            next_at += self.interval
            delay = next_at - time.monotonic()
            if delay <= 0:
                next_at = time.monotonic() + self.interval
                delay = self.interval
            self._stop.wait(delay)

    # -- sampling / serving -------------------------------------------------

    def sample(self) -> dict:
        """Take one snapshot now (also called by tests and the loadgen's
        final flush so the ring always covers the run's last instant)."""
        s = {
            "wall": time.time(),
            "mono_ns": time.monotonic_ns(),
            "metrics": self.registry.snapshot(),
        }
        with self._ring_lock:
            self._ring.append(s)
        return s

    def __len__(self) -> int:
        return len(self._ring)

    def document(self, last: Optional[int] = None) -> dict:
        """The TIMELINE reply body: ring samples (oldest first) plus the
        serve-time ``(wall, mono_ns)`` pair the collector aligns with."""
        with self._ring_lock:
            samples = list(self._ring)
        if last is not None and last >= 0:
            samples = samples[-last:] if last else []
        return {
            "version": TIMELINE_VERSION,
            "node": self.node,
            "interval_s": self.interval,
            "cap": self.cap,
            "wall": time.time(),
            "mono_ns": time.monotonic_ns(),
            "samples": samples,
        }


# ---------------------------------------------------------------------------
# Collector side: fetch + clock-align + merge (the obs.flight model)
# ---------------------------------------------------------------------------


def align_timeline(doc: dict, send_wall: float, recv_wall: float) -> dict:
    """Annotate a TIMELINE document with its monotonic→collector-wall
    offset (RTT-midpoint estimate over the sampler's serve-time
    ``mono_ns``) — :func:`rabia_tpu_torch.obs.flight.align_slice` applied to
    the timeline document shape, so both surfaces share one clock
    model."""
    from rabia_tpu_torch.obs.flight import align_slice

    return align_slice(doc, send_wall, recv_wall)


def merge_timelines(docs: Sequence[dict]) -> list[dict]:
    """Merge aligned TIMELINE documents into one time series sorted by
    aligned collector wall time. Each row: ``t`` (aligned seconds),
    ``node``, ``err_s`` and the sample's ``metrics`` dict; per-replica
    sample order is preserved exactly (one offset per replica)."""
    rows: list[dict] = []
    for doc in docs:
        off = doc.get("offset_s")
        if off is None:
            raise ValueError("timeline not aligned (call align_timeline)")
        for s in doc["samples"]:
            rows.append(
                {
                    "t": off + s["mono_ns"] * 1e-9,
                    "node": doc.get("node", ""),
                    "err_s": doc["err_s"],
                    "metrics": s["metrics"],
                }
            )
    rows.sort(key=lambda r: (r["t"], r["node"]))
    return rows


async def collect_timeline(
    addrs: Iterable[tuple[str, int]],
    last: Optional[int] = None,
    timeout: float = 10.0,
) -> list[dict]:
    """Fetch + align + merge the telemetry rings of every gateway in
    ``addrs``. Unreachable replicas are skipped (a timeline from the
    surviving quorum is still a timeline); raises only when NO replica
    answered."""
    import asyncio

    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway.client import admin_fetch_timed

    query = b""
    if last is not None:
        query = json.dumps({"last": int(last)}).encode()
    addrs = list(addrs)
    results = await asyncio.gather(
        *(
            admin_fetch_timed(
                host, port, int(AdminKind.TIMELINE), query=query,
                timeout=timeout,
            )
            for host, port in addrs
        ),
        return_exceptions=True,
    )
    docs = []
    errors = []
    for (host, port), res in zip(addrs, results):
        if isinstance(res, BaseException):
            errors.append(f"{host}:{port}: {type(res).__name__}: {res}")
            continue
        body, send_wall, recv_wall = res
        docs.append(align_timeline(json.loads(body), send_wall, recv_wall))
    if not docs:
        raise RuntimeError(
            "timeline: no replica answered (" + "; ".join(errors) + ")"
        )
    return merge_timelines(docs)


# ---------------------------------------------------------------------------
# Rendering (the ops CLI's `timeline` output)
# ---------------------------------------------------------------------------

# default columns: substring-matched against snapshot keys (labels
# included), matching values summed per sample — a headline view of
# load, progress and shed behavior
DEFAULT_TIMELINE_METRICS = (
    "engine_decided_total",
    "engine_pending_batches",
    "gateway_submits_total",
    "gateway_shed_total",
)


def _select(metrics: dict, pattern: str) -> float:
    v = metrics.get(pattern)
    if v is not None:
        return float(v)
    return float(
        sum(val for key, val in metrics.items() if pattern in key)
    )


def render_timeline_table(
    rows: Sequence[dict],
    metrics: Optional[Sequence[str]] = None,
    rates: bool = True,
) -> str:
    """One line per (sample, replica), times relative to the first
    sample. With ``rates`` (default), counter-looking columns
    (``*_total``) additionally print the per-second delta against the
    same replica's previous sample — the curve, not the integral."""
    if not rows:
        return "(no samples)"
    cols = list(metrics or DEFAULT_TIMELINE_METRICS)
    t0 = rows[0]["t"]
    nodes = sorted({r["node"] for r in rows})
    # last 8 hex chars, not the first: deterministic node ids
    # (NodeId.from_int) differ only in the suffix, and a random UUID's
    # suffix is as unique as its prefix
    short = {
        n: (n.replace("-", "")[-8:] if n else f"r{i}")
        for i, n in enumerate(nodes)
    }
    if len(set(short.values())) != len(nodes):
        short = {n: f"r{i}" for i, n in enumerate(nodes)}
    head = f"{'t(s)':>8}  {'node':<8}" + "".join(
        f"  {c.split('{')[0][-24:]:>24}" for c in cols
    )
    lines = [
        f"{len(rows)} samples across {len(nodes)} replicas; "
        f"clock-alignment error bound ±"
        f"{max(r['err_s'] for r in rows) * 1e3:.2f} ms",
        head,
    ]
    prev: dict[str, dict] = {}
    for r in rows:
        cells = []
        for c in cols:
            v = _select(r["metrics"], c)
            if rates and c.rstrip("}").endswith("_total"):
                p = prev.get(r["node"])
                if p is not None and r["t"] > p["t"]:
                    rate = (v - _select(p["metrics"], c)) / (r["t"] - p["t"])
                    cells.append(f"{v:>14.0f} ({rate:>6.1f}/s)")
                else:
                    cells.append(f"{v:>14.0f} {'':>9}")
            else:
                cells.append(f"{v:>24.1f}")
        lines.append(
            f"{r['t'] - t0:>8.1f}  {short[r['node']]:<8}  "
            + "  ".join(cells)
        )
        prev[r["node"]] = r
    return "\n".join(lines)
