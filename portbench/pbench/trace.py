"""The harness's spans and the profiler's device trace.

Spans are the harness's own, around its calls into each layer of the
program (``pb.submit``, ``pb.run_cycle``, ``pb.settle``, ``pb.dispatch``,
``pb.wait``, and ``pb.window`` around the measured window); in a traced run
they are profiler annotations, so they share the device records' clock,
and in an untraced run they cost nothing. ``DeviceTrace`` runs
``torch.profiler`` (host and CUDA activity) over the window and reduces
it to: the seconds in which any device record ran (the union of kernels,
copies and sets), the window's length, each device record's count and
seconds by name, and the longest idle gaps named by the harness span the
host was in.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

WINDOW_SPAN = "pb.window"


class Spans:
    """``spans("pb.submit")`` is a context: a profiler annotation in a
    traced run, nothing otherwise."""

    def __init__(self, on: bool) -> None:
        self.on = on
        if on:
            from torch.profiler import record_function

            self._record = record_function

    def __call__(self, name: str):
        return self._record(name) if self.on else contextlib.nullcontext()


class DeviceTrace:
    """The profiler over the measured window. ``start`` in set-up (the
    profiler's own start-up is not the program's time), ``stop`` once the
    window has closed, then ``summary()``."""

    def __init__(self, device) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def summary(self, top: int = 10) -> dict:
        return summarize(_events(self._prof), top)


def _events(prof) -> list:
    """(name, on_device, start_ns, end_ns, is_harness_span) of every record.
    A device record is a kernel, copy or set: the profiler's copies of the
    host's annotations onto the device's timeline are left out (they carry
    the annotations' names)."""
    raw = prof.profiler.kineto_results.events()
    on_dev = [str(e.device_type()).endswith("CUDA") for e in raw]
    annotations = {e.name() for e, d in zip(raw, on_dev) if not d and e.is_user_annotation()}
    out = []
    for e, d in zip(raw, on_dev):
        name, start = e.name(), e.start_ns()
        dev = d and not e.is_user_annotation() and name not in annotations
        out.append((name, dev, start, start + e.duration_ns(),
                    not d and e.is_user_annotation() and name.startswith("pb.")))
    return out


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, top: int = 10) -> dict:
    """Reduce trace records to the window's device time. ``events`` as
    :func:`_events` gives them. Returns ``window_s`` (the ``pb.window``
    span), ``busy_s`` (the union of device records inside it), ``kernels``
    ({name: [count, seconds]} of device records starting inside it) and
    ``breakdown`` (the ``top`` device records by seconds, and the ``top``
    longest idle gaps, each named by the harness span that covers its
    middle, or ``host`` where none does)."""
    windows = [(a, b) for name, dev, a, b, ann in events if ann and name == WINDOW_SPAN]
    if not windows:
        return {}
    w0, w1 = windows[-1]
    busy_iv, kernels = [], defaultdict(lambda: [0, 0.0])
    spans = []
    for name, dev, a, b, ann in events:
        if dev and w0 <= a < w1:
            busy_iv.append((a, min(b, w1)))
            k = kernels[name]
            k[0] += 1
            k[1] += (b - a) * 1e-9
        elif ann and name != WINDOW_SPAN and a < w1 and b > w0:
            spans.append((a, b, name))
    busy = _union(busy_iv)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    # the harness's spans inside the window are siblings: the one that
    # covers a point is the last to start before it
    spans.sort()
    starts = [s[0] for s in spans]

    def label(a: int, b: int) -> str:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        return spans[i][2] if i >= 0 and spans[i][1] > mid else "host"

    gaps.sort(key=lambda g: g[0] - g[1])
    device_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "breakdown": {
            "device_ops": [[name, v[1]] for name, v in device_ops],
            "idle_gaps": [[label(a, b), (b - a) * 1e-9] for a, b in gaps[:top]],
        },
    }


def kernel_seconds(trace: dict, fragment: str) -> tuple[int, float]:
    """(records, seconds) of the device records whose name holds
    ``fragment``."""
    n, s = 0, 0.0
    for name, (count, secs) in trace.get("kernels", {}).items():
        if fragment in name:
            n += count
            s += secs
    return n, s


def idle_pct(run: dict):
    """The share of the run's traced window in which no device record
    (kernel, copy or set) ran, in %: the reader of every
    ``device_idle_pct.*`` metric."""
    trace = run.get("trace")
    if not trace or trace.get("window_s", 0) <= 0 or trace.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
