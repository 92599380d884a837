"""The program's spans in a traced window (``pbench.spans``), on synthetic
profiler records: the span table's counts, seconds and self seconds, the
per-window figures, the innermost span naming an idle gap, the summary
that ``SpanTrace`` widens without changing what ``summarize`` gives, and
``scripts/torch_span_report.py`` as ``run.main`` with that summary."""

import importlib.util
from pathlib import Path

import pytest

from pbench import spans as pspans
from pbench import trace
from pbench.trace import _events, summarize

MS = 1_000_000


class _Rec:
    """One record as ``kineto_results.events()`` gives it."""

    def __init__(self, name, on_device, start_ms, end_ms, annotation=True, thread=1):
        self._n, self._d, self._a, self._t = name, on_device, annotation, thread
        self._s, self._e = int(start_ms * MS), int(end_ms * MS)

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def start_thread_id(self):
        return self._t


class _Prof:
    def __init__(self, records):
        results = type("R", (), {"events": lambda self: records})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_span_table_counts_seconds_and_self_seconds_of_nested_spans():
    spans = [
        ("pb.window", 0, 100 * MS, 1),
        ("pb.run_cycle", 10 * MS, 60 * MS, 1),
        ("mesh.cycle", 11 * MS, 59 * MS, 1),
        ("devkv.pack", 12 * MS, 30 * MS, 1),
        ("devkv.pack.gather", 12 * MS, 20 * MS, 1),
        ("devkv.pack.dict", 20 * MS, 29 * MS, 1),
        ("devkv.dispatch", 30 * MS, 40 * MS, 1),
        ("device.wait", 41 * MS, 45 * MS, 1),
        ("devkv.settle", 45 * MS, 55 * MS, 1),
        ("device.wait", 46 * MS, 50 * MS, 1),
        ("devkv.pack", 20 * MS, 25 * MS, 2),  # another thread: not nested in the first
        ("mesh.cycle", 200 * MS, 210 * MS, 1),  # after the window
    ]
    t = pspans.span_table(spans, 0, 100 * MS)
    assert "pb.run_cycle" not in t and "pb.window" not in t
    assert t["mesh.cycle"] == pytest.approx([1, 0.048, 0.048 - 0.018 - 0.010 - 0.004 - 0.010])
    assert t["devkv.pack"] == pytest.approx([2, 0.023, 0.001 + 0.005])
    assert t["devkv.settle"] == pytest.approx([1, 0.010, 0.006])
    assert t["device.wait"] == pytest.approx([2, 0.008, 0.008])
    fig = pspans.figures(t)
    assert fig["pack_ms"] == pytest.approx(23.0)  # one window dispatched
    assert fig["dispatch_ms"] == pytest.approx(10.0)
    assert fig["wait_ms"] == pytest.approx(8.0)
    assert fig["settle_ms"] == pytest.approx(6.0)
    assert fig["cycle_self_pct"] == pytest.approx(100.0 * 0.006 / 0.048)
    # the second thread's pack is not part of the cycle: the five exceed it by it
    assert fig["tiling"] == pytest.approx((0.048 + 0.005) / 0.048)
    assert fig["dispatch_us"] is None


def test_gaps_take_the_innermost_covering_span():
    spans = [("pb.window", 0, 100, 1), ("pb.run_cycle", 10, 60, 1), ("mesh.cycle", 11, 59, 1),
             ("devkv.pack", 12, 30, 1), ("devkv.pack.dict", 20, 29, 1), ("pb.settle", 60, 70, 1)]
    got = pspans.label_gaps([(20, 28), (40, 50), (55, 65), (80, 90)], spans)
    assert [g[0] for g in got] == ["devkv.pack.dict", "mesh.cycle", "pb.settle", "host"]
    assert got[0][1] == pytest.approx(8e-9)


def test_figures_are_none_without_program_spans():
    fig = pspans.figures({})
    assert set(fig.values()) == {None}
    fig = pspans.figures({"fw.window": [4, 0.002, 0.002]})
    assert fig["dispatch_us"] == pytest.approx(500.0) and fig["pack_ms"] is None


RECORDS = [
    _Rec("pb.window", False, 0, 100),
    _Rec("pb.run_cycle", False, 10, 60),
    _Rec("mesh.cycle", False, 11, 59),
    _Rec("devkv.pack", False, 12, 38),
    _Rec("devkv.pack.dict", False, 20, 37),
    _Rec("devkv.dispatch", False, 38, 46),
    _Rec("devkv.upload", False, 39, 41),
    _Rec("device.wait", False, 47, 49),
    _Rec("devkv.settle", False, 49, 58),
    _Rec("pb.settle", False, 61, 70),
    _Rec("Memcpy HtoD (Pinned -> Device)", True, 40, 42, annotation=False),
    _Rec("kv_dict_kernel", True, 42, 48, annotation=False),
    _Rec("kv_dict_kernel", True, 90, 91.5, annotation=False),
    _Rec("devkv.dispatch", True, 38, 46),  # the profiler's device copy of a span
]


def test_span_trace_widens_the_summary_and_changes_none_of_it():
    prof = _Prof(RECORDS)
    st = object.__new__(pspans.SpanTrace)  # the profiler session is faked
    st._prof = prof
    got = st.summary()
    bare = summarize(_events(prof))
    extra = {"spans", "span_figures", "span_idle_gaps"}
    assert set(got["breakdown"]) == set(bare["breakdown"]) | extra
    assert {k: v for k, v in got.items() if k != "breakdown"} == \
        {k: v for k, v in bare.items() if k != "breakdown"}
    assert all(got["breakdown"][k] == bare["breakdown"][k] for k in bare["breakdown"])
    b = got["breakdown"]
    assert b["spans"]["devkv.pack"] == pytest.approx([1, 0.026, 0.009])
    assert b["spans"]["mesh.cycle"] == pytest.approx([1, 0.048, 0.048 - 0.026 - 0.008 - 0.002
                                                      - 0.009])
    assert b["span_figures"]["tiling"] == pytest.approx(1.0)
    # the longest gap (48-90 ms) starts in the cycle and has its middle in pb.settle
    assert [g[0] for g in b["span_idle_gaps"]] == ["pb.settle", "devkv.pack.dict", "host"]
    assert b["span_idle_gaps"][0][1] == pytest.approx(0.042)
    assert bare["breakdown"]["idle_gaps"][1][0] == "pb.run_cycle"  # the harness's own label


def test_span_report_is_run_main_with_the_span_summary(monkeypatch):
    path = Path(__file__).resolve().parents[2] / "scripts" / "torch_span_report.py"
    spec = importlib.util.spec_from_file_location("_torch_span_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}

    def fake_main(argv):
        seen.update(argv=argv, trace_class=trace.DeviceTrace)
        return 0

    monkeypatch.setattr(trace, "DeviceTrace", trace.DeviceTrace)  # restored after the test
    monkeypatch.setattr(mod.run, "main", fake_main)
    assert mod.main(["--workload", "kv4096-ycsbA", "--seed", "7", "--seconds", "1"]) == 0
    assert seen["trace_class"] is pspans.SpanTrace
    assert seen["argv"][-2:] == ["--trace", "1"]
