"""Span tracing + device profiling hooks.

The port of the reference's ``rabia_tpu/core/tracing.py``:

- :class:`Tracer` — a process-local span aggregator: per-span count /
  total / max wall time, read via :meth:`Tracer.report`. Disabled by
  default; when disabled a span costs one attribute check. Set
  ``RABIA_TRACE=1`` in the environment to enable it process-wide (or
  flip ``tracer.enabled`` at runtime). A
  :class:`~rabia_tpu_torch.obs.MetricsRegistry` with this tracer
  attached carries ``rabia_span_seconds{span=...}`` summaries in its
  exposition, so there is one ``report()`` shape, not two.
- :func:`span` — ``with span("engine.tick.drain"): ...`` context manager
  against the module singleton.
- :func:`device_annotation` — names a region in device traces: a
  ``torch.profiler.record_function`` (seen by :func:`device_trace` and
  any ``torch.profiler`` session) and, on a CUDA device, an NVTX range;
  a no-op when neither is available.
- :func:`device_trace` — ``with device_trace(logdir):`` captures a
  ``torch.profiler`` trace of the host and, where there is one, the
  card around a workload, written to ``logdir`` as a Chrome trace.

Span naming taxonomy (dotted, coarse→fine):
  engine.tick.{drain,open,kernel,apply,timeouts}
  engine.kernel.{start,route,step,outbox}
  wire.{serialize,deserialize}
  sm.apply
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Iterator

logger = logging.getLogger("rabia_tpu_torch.tracing")


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt


@dataclass
class Tracer:
    """Process-local span aggregator (enable with ``tracer.enabled = True``)."""

    enabled: bool = False
    spans: dict = field(default_factory=dict)

    def record(self, name: str, dt: float) -> None:
        st = self.spans.get(name)
        if st is None:
            st = self.spans[name] = SpanStats()
        st.add(dt)

    def report(self) -> dict:
        """{span: {count, total_s, avg_us, max_us}} sorted by total time."""
        out = {}
        for name, st in sorted(
            self.spans.items(), key=lambda kv: -kv[1].total_s
        ):
            out[name] = {
                "count": st.count,
                "total_s": round(st.total_s, 4),
                "avg_us": round(st.total_s / st.count * 1e6, 1) if st.count else 0,
                "max_us": round(st.max_s * 1e6, 1),
            }
        return out

    def reset(self) -> None:
        self.spans.clear()

    def log_report(self, level: int = logging.INFO) -> None:
        for name, row in self.report().items():
            logger.log(
                level,
                "span %-28s n=%-8d total=%8.3fs avg=%8.1fus max=%8.1fus",
                name,
                row["count"],
                row["total_s"],
                row["avg_us"],
                row["max_us"],
            )


tracer = Tracer()
# the documented enable path: RABIA_TRACE=1 turns span aggregation on for
# the whole process (tests/benches may still flip tracer.enabled directly)
if os.environ.get("RABIA_TRACE") == "1":
    tracer.enabled = True


class _NoopSpan:
    """Shared no-op context: a disabled span costs one attribute check,
    one call and no allocation."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        tracer.record(self.name, time.perf_counter() - self.t0)
        return False


def span(name: str):
    """``with span("engine.tick.drain"): ...`` — aggregated when the
    tracer is enabled, near-free otherwise."""
    if not tracer.enabled:
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def device_annotation(name: str, device=None) -> Iterator[None]:
    """Name a region in device traces: a ``torch.profiler`` range, and
    an NVTX range when ``device`` is a CUDA device (no-op when neither
    is available).

    The ranges are opened OUTSIDE the yield so a body exception
    propagates unharmed (a bare ``except: yield`` around a yield would
    destroy it with 'generator didn't stop after throw()')."""
    try:
        import torch

        ann = torch.profiler.record_function(name)
        nvtx = torch.cuda.nvtx if torch.device(device or "cpu").type == "cuda" else None
    except Exception:
        ann = nvtx = None
    if ann is None:
        yield
        return
    if nvtx is not None:
        nvtx.range_push(name)
    try:
        with ann:
            yield
    finally:
        if nvtx is not None:
            nvtx.range_pop()


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host ops, and the card's
    kernels and copies where CUDA is available) around a block, written
    to ``<logdir>/trace.json`` in the Chrome trace format."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
