"""The program's spans in a traced window, on the profiler's clock.

The port names its steps with ``rabia_tpu_torch.core.tracing.span``: while
a profiler session records, each span is a host user annotation whose
name does not start with ``pb.`` (``mesh.cycle``, ``devkv.pack``,
``devkv.dispatch``, ``device.wait``, ``devkv.settle``, ``fw.window``, ...).
This module reduces them:

- :func:`span_table`: ``{name: [count, seconds, self seconds]}`` of the
  spans that start in the window; a span's self seconds are its seconds
  less those of the spans nested in it on its thread;
- :func:`figures`: the per-window readings of the device KV lane
  (``devkv.dispatch``'s count is its windows) and the decision core;
- :func:`idle_gaps` and :func:`label_gaps`: the window's spans with no
  device record running, each named by the innermost span, harness or
  program, that covers its middle.

:class:`SpanTrace` is ``trace.DeviceTrace`` with these readings added to
the summary's ``breakdown`` (``spans``, ``span_figures``,
``span_idle_gaps``); what ``trace.summarize`` returns is left as it is.
"""

from __future__ import annotations

from pbench.trace import WINDOW_SPAN, DeviceTrace, _events, summarize

HARNESS = "pb."


def host_spans(prof) -> list:
    """(name, start_ns, end_ns, thread) of every host annotation a
    finished ``torch.profiler.profile`` recorded."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and not str(e.device_type()).endswith("CUDA"):
            a = e.start_ns()
            out.append((e.name(), a, a + e.duration_ns(), e.start_thread_id()))
    return out


def span_table(spans: list, w0: int, w1: int) -> dict:
    """``{name: [count, seconds, self seconds]}`` of the program's spans
    that start in ``[w0, w1)``. Spans on one thread nest (a profiler range
    closes before the range it opened in), so a span's nested time is the
    sum of its direct children's, harness spans included."""
    nested: dict = {}
    by_thread: dict = {}
    for i, s in enumerate(spans):
        by_thread.setdefault(s[3], []).append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (spans[i][1], -spans[i][2]))
        stack: list = []
        for i in idx:
            _, a, b, _ = spans[i]
            while stack and spans[stack[-1]][2] <= a:
                stack.pop()
            if stack:
                p = stack[-1]
                nested[p] = nested.get(p, 0) + min(b, spans[p][2]) - a
            stack.append(i)
    out: dict = {}
    for i, (name, a, b, _) in enumerate(spans):
        if name.startswith(HARNESS) or not w0 <= a < w1:
            continue
        row = out.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (b - a) * 1e-9
        row[2] += (b - a - nested.get(i, 0)) * 1e-9
    return out


def figures(table: dict) -> dict:
    """The readings of a :func:`span_table` per window, each None without
    its spans: ``pack_ms``, ``dispatch_ms``, ``wait_ms``, ``settle_ms``
    (``devkv.settle``'s self seconds) per ``devkv.dispatch``,
    ``cycle_self_pct`` (``mesh.cycle``'s self share), ``tiling`` (the five
    over ``mesh.cycle``'s seconds: 1 unless a ``device.wait`` nests under
    ``devkv.pack`` or ``devkv.dispatch``, or a span nests elsewhere under
    a cycle) and ``dispatch_us`` (``fw.window`` per call)."""

    def get(name: str) -> list:
        return table.get(name, [0, 0.0, 0.0])

    n = get("devkv.dispatch")[0]
    cycle = get("mesh.cycle")
    out = dict.fromkeys(("pack_ms", "dispatch_ms", "wait_ms", "settle_ms", "cycle_self_pct",
                         "tiling", "dispatch_us"))
    if n and cycle[1] > 0:
        parts = (get("devkv.pack")[1], get("devkv.dispatch")[1], get("device.wait")[1],
                 get("devkv.settle")[2])
        out.update(pack_ms=parts[0] / n * 1e3, dispatch_ms=parts[1] / n * 1e3,
                   wait_ms=parts[2] / n * 1e3, settle_ms=parts[3] / n * 1e3,
                   cycle_self_pct=100.0 * cycle[2] / cycle[1],
                   tiling=(sum(parts) + cycle[2]) / cycle[1])
    fw = get("fw.window")
    if fw[0]:
        out["dispatch_us"] = fw[1] / fw[0] * 1e6
    return out


def idle_gaps(events: list, w0: int, w1: int) -> list:
    """The gaps ``(start_ns, end_ns)`` of ``[w0, w1)`` in which no device
    record ran, longest first; ``events`` as ``trace._events`` gives
    them."""
    gaps, t = [], w0
    for a, b in sorted((a, min(b, w1)) for _, dev, a, b, _ in events if dev and w0 <= a < w1):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def label_gaps(gaps: list, spans: list) -> list:
    """``[label, seconds]`` of each gap ``(start_ns, end_ns)``: the span
    that covers the gap's middle and starts last (the innermost), else
    ``host``."""
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        best = None
        for s in spans:
            if s[0] != WINDOW_SPAN and s[1] <= mid < s[2] and (best is None or s[1] > best[1]):
                best = s
        out.append([best[0] if best else "host", (b - a) * 1e-9])
    return out


class SpanTrace(DeviceTrace):
    """A :class:`~pbench.trace.DeviceTrace` whose summary's ``breakdown``
    also holds the program's spans, their figures and the idle gaps named
    by the innermost span."""

    def summary(self, top: int = 10) -> dict:
        events = _events(self._prof)
        out = summarize(events, top)
        spans = host_spans(self._prof)
        windows = [s for s in spans if s[0] == WINDOW_SPAN]
        if not out or not windows:
            return out
        w0, w1 = windows[-1][1], windows[-1][2]
        table = span_table(spans, w0, w1)
        out["breakdown"].update(spans=table, span_figures=figures(table),
                                span_idle_gaps=label_gaps(idle_gaps(events, w0, w1)[:top], spans))
        return out
