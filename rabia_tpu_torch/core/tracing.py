"""Spans, the port's one tracing system, and the profiler capture.

The port of the reference's ``rabia_tpu/core/tracing.py``:

- :func:`span` — ``with span("devkv.pack"): ...`` names a region of the
  program. A span is in one of three states, checked on each call:

  - off (the tracer disabled, no ``torch.profiler`` session running):
    the shared no-op, after two flag checks; nothing is recorded or
    allocated;
  - a profiler session running: a ``torch.profiler.record_function``
    range, so the span lands in the session's trace on the clock of the
    device's kernels and copies (:func:`device_trace`, and any
    ``torch.profiler.profile``);
  - the tracer enabled (``RABIA_TRACE=1`` in the environment, or
    ``tracer.enabled = True`` at run time): the span's wall time adds
    to :class:`Tracer`'s per-name count / total / max, read by
    :meth:`Tracer.report`; in a process that has started CUDA it also
    opens an NVTX range of the same name, for Nsight. A
    :class:`~rabia_tpu_torch.obs.MetricsRegistry` with this tracer
    attached carries ``rabia_span_seconds{span=...}`` summaries in its
    exposition.

- :func:`device_trace` — ``with device_trace(logdir):`` captures a
  ``torch.profiler`` trace of the host and, where there is one, the
  card around a workload, written to ``logdir`` as a Chrome trace.

Span naming taxonomy (dotted, coarse to fine):

  engine.tick.{drain,open,kernel,apply,timeouts}
  engine.kernel.{start,route,step,fetch,outbox}
  sm.apply
  mesh.cycle            MeshEngine.run_cycle, the whole call
  mesh.slot_window      the host lane's consensus window
  devkv.pack            a device KV window's host pack
  devkv.pack.gather       validate, bucket, fixed-width gather
  devkv.pack.dict         the dictionary form: hash, sort, rank, compare
  devkv.dispatch        a device KV window from its pack to its place in
                        the pipe: host planes, upload, launch, fetches
  devkv.upload            the window's host arrays to the device
  devkv.settle          a resolved window's versions, frames, futures
  device.wait           the host blocked on a device fetch's completion
  fw.window             the decision core's host side and launch

In a device KV cycle the spans tile ``mesh.cycle``: its seconds are
``devkv.pack`` + ``devkv.dispatch`` + ``device.wait`` + the self time of
``devkv.settle`` + the self time of ``mesh.cycle``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

# is a torch.profiler session recording this process (a C flag read)
_profiling = torch._C._autograd._profiler_enabled


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


tracer = Tracer()
# the documented enable path: RABIA_TRACE=1 turns span aggregation on for
# the whole process (tests/benches may still flip tracer.enabled directly)
if os.environ.get("RABIA_TRACE") == "1":
    tracer.enabled = True


class _NoopSpan:
    """Shared no-op context: a span that is off costs two flag checks,
    one call and no allocation."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """An enabled tracer's span: its wall time into :data:`tracer`, an
    NVTX range where CUDA has started, and a profiler range while a
    session records."""

    __slots__ = ("name", "t0", "nvtx", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.nvtx = torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.rf = torch.profiler.record_function(self.name) if _profiling() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        tracer.record(self.name, time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        return False


def span(name: str):
    """``with span("devkv.pack"): ...`` — aggregated (and an NVTX range
    on a card) when the tracer is enabled, a profiler range while a
    ``torch.profiler`` session records, the shared no-op otherwise."""
    if tracer.enabled:
        return _Span(name)
    if _profiling():
        return torch.profiler.record_function(name)
    return _NOOP


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host ops, and the card's
    kernels and copies where CUDA is available) around a block, written
    to ``<logdir>/trace.json`` in the Chrome trace format."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
