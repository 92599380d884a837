"""Process-local metrics registry with a Prometheus-text exporter.

The port of the reference's ``rabia_tpu/obs/registry.py`` (stdlib only;
the same names, exposition text and bucket geometry). Pull-based: the
engine mutates cheap in-memory cells, or registers a *source* (a zero-arg
callable read at collect time) for a value it already keeps, and a
scrape walks the registry once.

Three instrument kinds:

- :class:`Counter` — monotone float/int. Either incremented in Python
  (``inc``) or *source-backed*: constructed with ``fn`` returning the
  current value. A counter may have BOTH, in which case the exported
  value is ``fn() + local``.
- :class:`Gauge` — point-in-time value, set or source-backed.
- :class:`Histogram` — fixed upper-bound buckets (cumulative, Prometheus
  ``le`` semantics) + sum + count, with a quantile estimator for reports.

Metric identity is ``(name, sorted label items)``; registering the same
identity twice returns the existing instrument, so wiring code can be
idempotent across restarts of a component inside one process.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Callable, Iterable, Optional

# Default latency buckets (seconds): 100us .. 10s, the commit-pipeline
# span. Chosen so the serial p50 budget (~2-4ms) lands mid-range with
# resolution on both sides.
LATENCY_BUCKETS: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# ---------------------------------------------------------------------------
# The reference's SLO evidence plane conventions, kept so that the port's
# exposition matches its text: 2^SLO_SUB_BITS log sub-buckets per
# power-of-two octave of nanoseconds, floor 2^SLO_MIN_EXP ns (the
# geometry of the reference's native histogram blocks, which the port has
# not ported yet).
# ---------------------------------------------------------------------------

SLO_SUB_BITS = 2
SLO_MIN_EXP = 10
SLO_OCTAVES = 25

# the rabia_slo_seconds{stage=...} label set (both runtime paths)
SLO_STAGES: tuple[str, ...] = ("submit_result", "decide_apply", "broadcast")

# the rabia_runtime_stage_seconds{stage=...} label set, in the
# reference's order (its native runtime's stage index, then the stages
# only its asyncio commit path feeds)
RUNTIME_STAGES: tuple[str, ...] = (
    "recv_wait", "ingest", "tick", "apply", "result_staging",
    "broadcast", "cmd", "timers", "idle", "other",
    "gateway", "serialization", "read_probe",
)


def _slo_buckets() -> tuple[float, ...]:
    sub = 1 << SLO_SUB_BITS
    out = []
    for octave in range(SLO_OCTAVES):
        base = 1 << (SLO_MIN_EXP + octave)
        for s in range(sub):
            out.append(base * (sub + s + 1) / sub * 1e-9)
    return tuple(out)


SLO_BUCKETS: tuple[float, ...] = _slo_buckets()


def slo_bucket_index(ns: int) -> int:
    """Bucket index of a nanosecond duration under the SLO geometry (the
    reference's native bucketing, bit for bit)."""
    if ns < (1 << SLO_MIN_EXP):
        return 0
    exp = int(ns).bit_length() - 1
    sub = (ns >> (exp - SLO_SUB_BITS)) & ((1 << SLO_SUB_BITS) - 1)
    idx = ((exp - SLO_MIN_EXP) << SLO_SUB_BITS) + sub
    top = (SLO_OCTAVES << SLO_SUB_BITS) - 1
    return idx if idx < top else top


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Parse a Prometheus 0.0.4 text exposition back into the
    :meth:`MetricsRegistry.snapshot` key shape (``name{labels} ->
    value``). Scrape-side inverse of :meth:`render_prometheus` for the
    profile/timeline CLIs and tests; ignores comments and anything that
    does not look like a sample line."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        if not key:
            continue
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2**63 else repr(f)


class Counter:
    """Monotone counter; optionally source-backed (see module doc)."""

    __slots__ = ("name", "help", "labels", "_local", "fn")
    kind = "counter"

    def __init__(
        self,
        name: str,
        help_: str,
        labels: tuple[tuple[str, str], ...],
        fn: Optional[Callable[[], float]] = None,
    ) -> None:
        self.name = name
        self.help = help_
        self.labels = labels
        self._local = 0
        self.fn = fn

    def inc(self, n: float = 1) -> None:
        self._local += n

    def value(self) -> float:
        base = self._local
        if self.fn is not None:
            try:
                base += self.fn()
            except Exception:
                pass  # a dead source (closed transport) reads as its local part
        return base


class Gauge:
    """Point-in-time value; set directly or source-backed."""

    __slots__ = ("name", "help", "labels", "_v", "fn")
    kind = "gauge"

    def __init__(
        self,
        name: str,
        help_: str,
        labels: tuple[tuple[str, str], ...],
        fn: Optional[Callable[[], float]] = None,
    ) -> None:
        self.name = name
        self.help = help_
        self.labels = labels
        self._v = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._v = v

    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return self._v
        return self._v


class Histogram:
    """Fixed-bucket histogram: cumulative ``le`` buckets + sum + count.

    ``observe`` is the hot call: linear scan over small bucket sets
    (~16 bounds), bisect past ~32 (the 100-bound :data:`SLO_BUCKETS`
    histograms sit on every broadcast/submit path) — no allocation
    either way.

    Like :class:`Counter`, a histogram may be *source-backed*: ``fn``
    returns ``(bucket_counts, count, sum_seconds)`` over the same bounds,
    or ``None`` when the source is not active. The exported
    buckets/count/sum are ``fn() + local``, so two sources can feed ONE
    metric identity.
    """

    __slots__ = (
        "name", "help", "labels", "bounds", "counts", "sum", "count", "fn",
    )
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        labels: tuple[tuple[str, str], ...],
        buckets: Iterable[float] = LATENCY_BUCKETS,
        fn: Optional[Callable[[], Optional[tuple]]] = None,
    ) -> None:
        self.name = name
        self.help = help_
        self.labels = labels
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self.counts = [0] * len(bounds)  # per-bucket (NON-cumulative) counts
        self.sum = 0.0
        self.count = 0
        self.fn = fn

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        bounds = self.bounds
        if len(bounds) > 32:
            i = bisect_left(bounds, v)
            if i < len(bounds):
                self.counts[i] += 1
            # else above the top bound: only in +Inf (count - sum(buckets))
            return
        for i, b in enumerate(bounds):
            if v <= b:
                self.counts[i] += 1
                return
        # above the top bound: counted only in +Inf (count - sum(buckets))

    def merged(self) -> tuple[list, int, float]:
        """``(bucket_counts, count, sum_s)`` with the source (if any)
        folded in. A dead or shape-mismatched source reads as the
        local part alone — metrics, not ledgers."""
        if self.fn is None:
            return self.counts, self.count, self.sum
        try:
            extra = self.fn()
        except Exception:
            extra = None
        if extra is None:
            return self.counts, self.count, self.sum
        ec, en, es = extra
        if len(ec) != len(self.counts):
            return self.counts, self.count, self.sum
        counts = [a + int(b) for a, b in zip(self.counts, ec)]
        return counts, self.count + int(en), self.sum + float(es)

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) by linear interpolation inside
        the containing bucket; values above the top bound report the top
        bound (the estimator never extrapolates past what it measured)."""
        counts, count, _ = self.merged()
        return self._quantile_from(counts, count, q)

    def _quantile_from(
        self, counts: list, count: int, q: float
    ) -> float:
        if count == 0:
            return 0.0
        target = q * count
        cum = 0
        lo = 0.0
        for b, c in zip(self.bounds, counts):
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                return lo + (b - lo) * min(max(frac, 0.0), 1.0)
            cum += c
            lo = b
        return self.bounds[-1]

    def snapshot(self) -> dict:
        # one merged() pass feeds count/sum and both quantiles: separate
        # reads of a source could see different states of it
        counts, count, sum_s = self.merged()
        return {
            "count": count,
            "sum_s": round(sum_s, 6),
            "p50_s": round(self._quantile_from(counts, count, 0.5), 6),
            "p99_s": round(self._quantile_from(counts, count, 0.99), 6),
        }


class MetricsRegistry:
    """A replica component's instrument set + Prometheus-text exporter.

    Thread-safe for registration (a scrape thread can race component
    construction); instrument mutation itself is single-writer by design
    (each counter/histogram is owned by one event loop) and reads are
    tolerant of torn in-between states — metrics, not ledgers.
    """

    def __init__(self, namespace: str = "rabia") -> None:
        self.namespace = namespace
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._tracer = None

    # -- registration -------------------------------------------------------

    def _key(self, name: str, labels: Optional[dict]) -> tuple:
        lab = tuple(sorted((labels or {}).items()))
        return (name, lab)

    def _register(self, cls, name, help_, labels, **kw):
        if not name.startswith(self.namespace + "_"):
            name = f"{self.namespace}_{name}"
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help_, key[1], **kw)
                self._metrics[key] = m
            elif kw.get("fn") is not None and hasattr(m, "fn"):
                # re-registration with a fresh source REBINDS it: a
                # component restarted on the same registry (gateway over
                # a surviving engine) must not leave the exported value
                # reading — and pinning — its dead predecessor
                m.fn = kw["fn"]
            return m

    def counter(
        self,
        name: str,
        help_: str = "",
        labels: Optional[dict] = None,
        fn: Optional[Callable[[], float]] = None,
    ) -> Counter:
        return self._register(Counter, name, help_, labels, fn=fn)

    def gauge(
        self,
        name: str,
        help_: str = "",
        labels: Optional[dict] = None,
        fn: Optional[Callable[[], float]] = None,
    ) -> Gauge:
        return self._register(Gauge, name, help_, labels, fn=fn)

    def histogram(
        self,
        name: str,
        help_: str = "",
        labels: Optional[dict] = None,
        buckets: Iterable[float] = LATENCY_BUCKETS,
        fn: Optional[Callable[[], Optional[tuple]]] = None,
    ) -> Histogram:
        return self._register(
            Histogram, name, help_, labels, buckets=buckets, fn=fn
        )

    def attach_tracer(self, tracer) -> None:
        """Fold a :class:`~rabia_tpu_torch.core.tracing.Tracer`'s span
        aggregates into this registry's exposition (one ``report()``
        shape: scrape the registry, get the spans too)."""
        self._tracer = tracer

    # -- collection ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat ``{name{labels}: value}`` dict (histograms expand to
        ``_count``/``_sum``/``_p50``/``_p99``). The BENCH/conformance
        counter-context shape."""
        out: dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            tag = m.name + _fmt_labels(m.labels)
            if m.kind == "histogram":
                s = m.snapshot()
                out[tag + "_count"] = s["count"]
                out[tag + "_sum"] = s["sum_s"]
                out[tag + "_p50"] = s["p50_s"]
                out[tag + "_p99"] = s["p99_s"]
            else:
                out[tag] = m.value()
        if self._tracer is not None and self._tracer.enabled:
            for span_name, row in self._tracer.report().items():
                base = (
                    f'{self.namespace}_span_seconds'
                    f'{{span="{_escape(span_name)}"}}'
                )
                out[base + "_count"] = row["count"]
                out[base + "_sum"] = row["total_s"]
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
        by_name: dict[str, list] = {}
        for m in metrics:
            by_name.setdefault(m.name, []).append(m)
        lines: list[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            first = group[0]
            if first.help:
                lines.append(f"# HELP {name} {first.help}")
            lines.append(f"# TYPE {name} {first.kind}")
            for m in sorted(group, key=lambda m: m.labels):
                if m.kind == "histogram":
                    counts, count, sum_s = m.merged()
                    cum = 0
                    for b, c in zip(m.bounds, counts):
                        cum += c
                        lab = m.labels + (("le", _fmt_value(b)),)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(lab)} {cum}"
                        )
                    lab = m.labels + (("le", "+Inf"),)
                    lines.append(f"{name}_bucket{_fmt_labels(lab)} {count}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(m.labels)} "
                        f"{_fmt_value(sum_s)}"
                    )
                    lines.append(
                        f"{name}_count{_fmt_labels(m.labels)} {count}"
                    )
                else:
                    lines.append(
                        f"{name}{_fmt_labels(m.labels)} "
                        f"{_fmt_value(m.value())}"
                    )
        if self._tracer is not None and self._tracer.enabled:
            sname = f"{self.namespace}_span_seconds"
            report = self._tracer.report()
            if report:
                lines.append(
                    f"# HELP {sname} Aggregated tracer spans "
                    "(core.tracing, RABIA_TRACE=1)"
                )
                lines.append(f"# TYPE {sname} summary")
                for span_name, row in report.items():
                    lab = _fmt_labels((("span", span_name),))
                    lines.append(f"{sname}_sum{lab} {row['total_s']}")
                    lines.append(f"{sname}_count{lab} {row['count']}")
        return "\n".join(lines) + "\n"
