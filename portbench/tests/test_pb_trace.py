"""The trace summary that the device-trace metrics read, frozen on synthetic
profiler records: the harness's spans alone give the expected window,
busy time, device records and labeled idle gaps, and the program's own
spans (host annotations not named ``pb.*``, with the copies the profiler
makes of them on the device's timeline) change none of it."""

import pytest

from pbench.trace import _events, idle_pct, kernel_seconds, summarize

MS = 1_000_000


class _Rec:
    """One record as ``kineto_results.events()`` gives it."""

    def __init__(self, name, on_device, start_ms, end_ms, annotation=False):
        self._n, self._d, self._a = name, on_device, annotation
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


class _Prof:
    def __init__(self, records):
        results = type("R", (), {"events": lambda self: records})()
        self.profiler = type("P", (), {"kineto_results": results})()


HARNESS = [
    _Rec("pb.window", False, 0, 100, True),
    _Rec("pb.submit", False, 1, 9, True),
    _Rec("pb.run_cycle", False, 10, 60, True),
    _Rec("pb.settle", False, 61, 70, True),
    _Rec("pb.run_cycle", False, 71, 99, True),
    _Rec("Memcpy HtoD (Pinned -> Device)", True, 40, 42),
    _Rec("kv_dict_kernel", True, 42, 43),
    _Rec("Memcpy DtoH (Device -> Pinned)", True, 43, 45),
    _Rec("kv_dict_kernel", True, 90, 91.5),
    _Rec("pb.run_cycle", True, 10, 60, True),  # the profiler's device copy of a span
]

PROGRAM = [
    _Rec("mesh.cycle", False, 11, 59, True),
    _Rec("devkv.pack", False, 12, 38, True),
    _Rec("devkv.pack.dict", False, 20, 37, True),
    _Rec("devkv.dispatch", False, 38, 46, True),
    _Rec("devkv.upload", False, 39, 41, True),
    _Rec("device.wait", False, 47, 49, True),
    _Rec("devkv.dispatch", True, 38, 46, True),
    _Rec("mesh.cycle", True, 11, 59),  # a device copy the profiler did not flag
]

FROZEN = {
    "window_s": 0.1,
    "busy_s": 0.0065,
    "kernels": {"Memcpy HtoD (Pinned -> Device)": [1, 0.002], "kv_dict_kernel": [2, 0.0025],
                "Memcpy DtoH (Device -> Pinned)": [1, 0.002]},
    "breakdown": {
        "device_ops": [["kv_dict_kernel", 0.0025], ["Memcpy HtoD (Pinned -> Device)", 0.002],
                       ["Memcpy DtoH (Device -> Pinned)", 0.002]],
        "idle_gaps": [["pb.settle", 0.045], ["pb.run_cycle", 0.04], ["pb.run_cycle", 0.0085]],
    },
}


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-12)
    else:
        assert got == want


def test_summary_of_the_harness_spans_is_frozen():
    got = summarize(_events(_Prof(HARNESS)))
    _close(got, FROZEN)  # the gaps longest first
    assert idle_pct({"trace": got}) == pytest.approx(93.5)
    assert kernel_seconds(got, "kv_dict") == (2, pytest.approx(0.0025))


def test_program_spans_change_no_reading_of_the_summary():
    bare = summarize(_events(_Prof(HARNESS)))
    spanned = summarize(_events(_Prof(HARNESS + PROGRAM)))
    _close(spanned, bare)
