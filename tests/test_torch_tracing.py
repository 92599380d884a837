"""The port's one span system (``rabia_tpu_torch.core.tracing.span``) and
the spans on the device KV lane and the decision core, on the CPU.

- Off (tracer disabled, no profiler recording), ``span`` is the shared
  no-op: no ``record_function``, no NVTX range, no object made.
- Under ``torch.profiler.profile``, spans are user annotations that nest
  as the code does; with the tracer enabled they also add up in
  ``tracer.report()`` and fold into a registry that has the tracer.
- A ``MeshEngine(device_store=True)`` at 64 shards x 5 replicas, W=4,
  under the profiler, running mixed blocks and then GET blocks on the
  read lane: one ``devkv.dispatch`` and one ``devkv.pack`` for each
  window it launched, every ``devkv.pack.*`` and ``devkv.upload`` inside
  its parent, and ``devkv.pack`` + ``devkv.dispatch`` + ``device.wait`` +
  the self time of ``devkv.settle`` + the self time of ``mesh.cycle``
  equal to ``mesh.cycle``'s seconds within 1%.
- ``fw.window`` once for each ``window_rmajor`` call, ``device.wait``
  once for each ``HostFetch.result``, ``mesh.slot_window`` once for each
  window of the host lane, inside its ``mesh.cycle``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rabia_tpu_torch.core.tracing as tracing
from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.core.device import HostFetch
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel
from rabia_tpu_torch.obs import MetricsRegistry
from rabia_tpu_torch.parallel import MeshEngine

def _profiled(fn):
    """Run ``fn`` under a CPU ``torch.profiler`` session; returns
    ``(name, start_ns, end_ns, thread)`` of each host annotation."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            a = e.start_ns()
            out.append((e.name(), a, a + e.duration_ns(), e.start_thread_id()))
    return out


def _self_seconds(spans) -> dict:
    """{name: seconds less those of the spans nested in it on its thread},
    summed over the spans of each name."""
    out: dict = {}
    for thread in {s[3] for s in spans}:
        stack: list = []
        for s in sorted((s for s in spans if s[3] == thread), key=lambda s: (s[1], -s[2])):
            while stack and stack[-1][2] <= s[1]:
                stack.pop()
            if stack:
                p = stack[-1]
                out[p[0]] = out.get(p[0], 0.0) - (min(s[2], p[2]) - s[1]) * 1e-9
            out[s[0]] = out.get(s[0], 0.0) + (s[2] - s[1]) * 1e-9
            stack.append(s)
    return out


def _inside(inner, outer) -> bool:
    return inner[3] == outer[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def fresh_tracer(monkeypatch):
    """The module's tracer with no totals, restored after the test."""
    monkeypatch.setattr(tracing.tracer, "spans", {})
    return tracing.tracer


# -- the span ------------------------------------------------------------------


def test_span_off_is_the_shared_noop_and_calls_nothing(monkeypatch, fresh_tracer):
    def refuse(*a, **k):
        raise AssertionError("a span that is off called the profiler or NVTX")

    monkeypatch.setattr(fresh_tracer, "enabled", False)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    monkeypatch.setattr(tracing, "_Span", refuse)
    a, b = tracing.span("devkv.pack"), tracing.span("mesh.cycle")
    assert a is tracing._NOOP and b is tracing._NOOP
    with a:
        with b:
            pass
    assert fresh_tracer.spans == {}


def test_profiled_spans_are_user_annotations_that_nest(fresh_tracer):
    assert not fresh_tracer.enabled

    def body():
        with tracing.span("t.outer"):
            with tracing.span("t.outer.inner"):
                with tracing.span("t.outer.inner.leaf"):
                    torch.ones(4).sum()
            with tracing.span("t.outer.inner"):
                pass

    spans = _profiled(body)
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert [len(by[n]) for n in ("t.outer", "t.outer.inner", "t.outer.inner.leaf")] == [1, 2, 1]
    assert all(_inside(s, by["t.outer"][0]) for s in by["t.outer.inner"])
    assert _inside(by["t.outer.inner.leaf"][0], by["t.outer.inner"][0])
    assert fresh_tracer.spans == {}  # the profiler's range alone


def test_enabled_spans_aggregate_under_the_profiler_and_fold_into_a_registry(
        monkeypatch, fresh_tracer):
    monkeypatch.setattr(fresh_tracer, "enabled", True)

    def body():
        for _ in range(3):
            with tracing.span("t.outer"):
                with tracing.span("t.outer.inner"):
                    torch.ones(4).sum()

    spans = _profiled(body)
    names = [s[0] for s in spans]
    assert names.count("t.outer") == 3 and names.count("t.outer.inner") == 3
    inner = [s for s in spans if s[0] == "t.outer.inner"]
    assert all(any(_inside(i, o) for o in spans if o[0] == "t.outer") for i in inner)
    report = fresh_tracer.report()
    assert report["t.outer"]["count"] == 3 and report["t.outer.inner"]["count"] == 3
    with pytest.raises(ValueError):
        with tracing.span("t.raises"):
            raise ValueError("passes through")
    assert fresh_tracer.report()["t.raises"]["count"] == 1
    m = MetricsRegistry()
    m.attach_tracer(fresh_tracer)
    text = m.render_prometheus()
    assert 'rabia_span_seconds_count{span="t.outer"} 3' in text
    assert m.snapshot()['rabia_span_seconds{span="t.outer.inner"}_count'] == 3


# -- the spans of the device KV lane -------------------------------------------

N_SHARDS, R, W = 64, 5, 4


def _op(code: int, key: str, val: str = "") -> bytes:
    kb = key.encode()
    return bytes((code,)) + len(kb).to_bytes(2, "little") + kb + val.encode()


def _block(ops) -> object:
    return build_block(list(range(N_SHARDS)), [[o] for o in ops])


def test_device_kv_cycle_spans_count_windows_nest_and_tile_the_cycle():
    eng = MeshEngine(lambda: VectorShardedKV(N_SHARDS, capacity=1 << 12), N_SHARDS, R,
                     device="cpu", window=W, device_store=True, device_read_lane=True)
    rng = np.random.default_rng(2**33 + 7)
    for t in range(W):
        eng.submit_block(_block([_op(1, f"k{s}-{t}", f"v{t}") for s in range(N_SHARDS)]))
    eng.flush()
    assert eng.device_lane_active
    dev = eng._dev
    mixed = [_block([_op(1, f"k{s}-{t % W}", f"w{t}") if rng.random() < 0.5
                     else _op(2, f"k{s}-{t % W}") for s in range(N_SHARDS)])
             for t in range(3 * W)]
    gets = [_block([_op(2, f"k{s}-{t % W}") for s in range(N_SHARDS)]) for t in range(3 * W)]
    uploads0, cycles0, probes0 = dev.uploads, eng.cycles, eng.read_lane_stats()["probe_windows"]

    def body():
        futs = [eng.submit_block(b) for b in mixed]
        eng.flush()
        futs += [eng.submit_block(b) for b in gets]
        eng.flush()
        assert all(f.done() for f in futs)

    spans = _profiled(body)
    assert eng.device_lane_active
    launched = dev.uploads - uploads0
    assert launched == eng.cycles - cycles0 > 0
    assert eng.read_lane_stats()["probe_windows"] > probes0  # the read lane served some
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert len(by["devkv.dispatch"]) == len(by["devkv.pack"]) == launched
    assert len(by["devkv.upload"]) == launched
    assert len(by["devkv.settle"]) == launched  # the pipe drained: every window settled
    for child, parent in (("devkv.pack.gather", "devkv.pack"), ("devkv.pack.dict", "devkv.pack"),
                          ("devkv.upload", "devkv.dispatch"), ("devkv.pack", "mesh.cycle"),
                          ("devkv.dispatch", "mesh.cycle"), ("devkv.settle", "mesh.cycle"),
                          ("device.wait", "mesh.cycle")):
        for c in by[child]:
            assert any(_inside(c, p) for p in by[parent]), (child, parent)
    def secs(name):
        return sum(s[2] - s[1] for s in by[name]) * 1e-9

    own = _self_seconds(spans)
    five = (secs("devkv.pack") + secs("devkv.dispatch") + secs("device.wait")
            + own["devkv.settle"] + own["mesh.cycle"])
    assert five == pytest.approx(secs("mesh.cycle"), rel=0.01)
    assert 0 < own["mesh.cycle"] < secs("mesh.cycle") and own["devkv.settle"] > 0
    eng.close()


def test_fw_window_span_once_per_window_rmajor_call():
    k = ClusterKernel(16, 5, device="cpu")
    votes = torch.ones((5, 8, 16), dtype=torch.int8)
    alive = torch.ones((5, 16), dtype=torch.bool)

    def body():
        for _ in range(3):
            k.slot_pipeline_fused_rmajor(votes, alive, 8, want_phase=False)

    spans = _profiled(body)
    assert [s[0] for s in spans].count("fw.window") == 3


def test_device_wait_spans_each_host_fetch_result():
    fetches = [HostFetch(torch.arange(4)), HostFetch(torch.ones(2), torch.zeros(3))]

    def body():
        with tracing.span("t.caller"):
            for f in fetches:
                f.result()

    spans = _profiled(body)
    waits = [s for s in spans if s[0] == "device.wait"]
    caller = [s for s in spans if s[0] == "t.caller"]
    assert len(waits) == 2 and all(_inside(w, caller[0]) for w in waits)


def test_host_lane_windows_are_slot_window_spans_inside_the_cycle():
    eng = MeshEngine(lambda: VectorShardedKV(N_SHARDS, capacity=1 << 12), N_SHARDS, R,
                     device="cpu", window=W)
    blocks = [_block([_op(1, f"h{s}-{t}", f"v{t}") for s in range(N_SHARDS)])
              for t in range(2 * W)]
    cycles0 = eng.cycles

    def body():
        futs = [eng.submit_block(b) for b in blocks]
        eng.flush()
        assert all(f.done() for f in futs)

    spans = _profiled(body)
    assert not eng.device_lane_active
    windows = [s for s in spans if s[0] == "mesh.slot_window"]
    cycles = [s for s in spans if s[0] == "mesh.cycle"]
    assert 0 < len(windows) <= len(cycles) and eng.cycles > cycles0
    assert all(any(_inside(w, c) for c in cycles) for w in windows)
    assert not [s for s in spans if s[0].startswith("devkv.")]
    eng.close()


def test_enabled_span_without_a_profiler_aggregates_and_records_no_range(
        monkeypatch, fresh_tracer):
    def refuse(*a, **k):
        raise AssertionError("no profiler records, yet a range was opened")

    monkeypatch.setattr(fresh_tracer, "enabled", True)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for _ in range(2):
        with tracing.span("t.counted"):
            pass
    got = fresh_tracer.report()["t.counted"]
    assert got["count"] == 2 and got["total_s"] >= 0
