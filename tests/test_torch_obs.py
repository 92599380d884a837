"""The port's metrics registry and tracer against the reference's.

``TestHistogram`` and ``TestRegistry`` of tests/test_obs.py run as cases
parametrised over both packages (``rabia_tpu.obs`` and
``rabia_tpu_torch.obs``, with each package's ``Tracer``). Then one fixed
schedule of counters, gauges (set and source-backed), histograms (the
default latency buckets, the SLO buckets, a source-backed one) and
tracer spans renders through both registries, and the Prometheus text,
the snapshots and the parsed scrape are compared. The engine's metric
families (``MeshEngine.metrics``) render the same text as the
reference's on the same schedule. Tolerance: exact (text).
"""

from __future__ import annotations

import re

import numpy as np
import pytest

import rabia_tpu.core.tracing as ref_tracing
import rabia_tpu.obs as ref_obs
import rabia_tpu_torch.core.tracing as port_tracing
import rabia_tpu_torch.obs as port_obs

PACKAGES = {"reference": (ref_obs, ref_tracing), "port": (port_obs, port_tracing)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class TestHistogram:
    def test_bucket_math_cumulative(self, pkg):
        m = pkg[0].MetricsRegistry()
        h = m.histogram("lat_seconds", buckets=(0.001, 0.01, 0.1, 1.0))
        for v in (0.0005, 0.0009, 0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        assert h.count == 6
        assert h.counts == [2, 1, 1, 1]  # per-bucket, non-cumulative
        assert abs(h.sum - 5.5564) < 1e-9
        text = m.render_prometheus()
        assert 'rabia_lat_seconds_bucket{le="0.001"} 2' in text
        assert 'rabia_lat_seconds_bucket{le="0.01"} 3' in text
        assert 'rabia_lat_seconds_bucket{le="0.1"} 4' in text
        assert 'rabia_lat_seconds_bucket{le="1"} 5' in text
        assert 'rabia_lat_seconds_bucket{le="+Inf"} 6' in text
        assert "rabia_lat_seconds_count 6" in text

    def test_quantile_interpolates(self, pkg):
        m = pkg[0].MetricsRegistry()
        h = m.histogram("q_seconds", buckets=(1.0, 2.0, 4.0))
        for _ in range(100):
            h.observe(1.5)  # all in the (1, 2] bucket
        q = h.quantile(0.5)
        assert 1.0 <= q <= 2.0
        # values above the top bound never extrapolate past it
        h2 = m.histogram("q2_seconds", buckets=(1.0,))
        h2.observe(100.0)
        assert h2.quantile(0.99) == 1.0

    def test_empty_quantile_is_zero(self, pkg):
        h = pkg[0].MetricsRegistry().histogram("e_seconds", buckets=(1.0,))
        assert h.quantile(0.5) == 0.0
        assert h.snapshot()["count"] == 0

    def test_overflow_bucket_clamps_not_extrapolates(self, pkg):
        m = pkg[0].MetricsRegistry()
        h = m.histogram("ovf_seconds", buckets=(0.1, 1.0))
        h.observe(50.0)
        h.observe(100.0)
        h.observe(0.05)
        assert h.count == 3
        assert h.counts == [1, 0]  # only the in-range observation bucketed
        for q in (0.5, 0.9, 0.99, 1.0):
            assert h.quantile(q) <= 1.0
        assert h.quantile(0.99) == 1.0
        text = m.render_prometheus()
        assert 'rabia_ovf_seconds_bucket{le="1"} 1' in text
        assert 'rabia_ovf_seconds_bucket{le="+Inf"} 3' in text
        assert "rabia_ovf_seconds_count 3" in text


class TestRegistry:
    def test_registration_identity_idempotent(self, pkg):
        m = pkg[0].MetricsRegistry()
        a = m.counter("c_total", labels={"k": "x"})
        b = m.counter("c_total", labels={"k": "x"})
        c = m.counter("c_total", labels={"k": "y"})
        assert a is b and a is not c
        a.inc(3)
        assert b.value() == 3

    def test_reregistration_rebinds_source(self, pkg):
        m = pkg[0].MetricsRegistry()
        old = m.gauge("comp_state", fn=lambda: 1)
        new = m.gauge("comp_state", fn=lambda: 2)
        assert new is old  # identity-deduped ...
        assert old.value() == 2  # ... but reading the NEW source

    def test_source_backed_counter_sums_fn_and_local(self, pkg):
        m = pkg[0].MetricsRegistry()
        cell = {"v": 10}
        c = m.counter("src_total", fn=lambda: cell["v"])
        c.inc(5)
        assert c.value() == 15
        cell["v"] = 20
        assert c.value() == 25

    def test_gauge_fn_failure_falls_back(self, pkg):
        m = pkg[0].MetricsRegistry()

        def boom():
            raise RuntimeError("dead source")

        g = m.gauge("g", fn=boom)
        g.set(7)  # last explicit value survives a dead source
        assert g.value() == 7

    def test_snapshot_flat_shape(self, pkg):
        m = pkg[0].MetricsRegistry()
        m.counter("a_total").inc(2)
        h = m.histogram("h_seconds", buckets=(1.0,))
        h.observe(0.5)
        snap = m.snapshot()
        assert snap["rabia_a_total"] == 2
        assert snap["rabia_h_seconds_count"] == 1

    def test_tracer_folds_into_exposition(self, pkg):
        t = pkg[1].Tracer(enabled=True)
        t.record("engine.tick.drain", 0.002)
        m = pkg[0].MetricsRegistry()
        m.attach_tracer(t)
        text = m.render_prometheus()
        assert 'rabia_span_seconds_count{span="engine.tick.drain"} 1' in text
        snap = m.snapshot()
        assert snap['rabia_span_seconds{span="engine.tick.drain"}_count'] == 1

    def test_label_escaping(self, pkg):
        m = pkg[0].MetricsRegistry()
        m.counter("esc_total", labels={"k": 'a"b\\c'}).inc()
        text = m.render_prometheus()
        assert 'k="a\\"b\\\\c"' in text

    def test_label_escaping_round_trip(self, pkg):
        raw = 'quote " back\\slash and\nnewline'
        m = pkg[0].MetricsRegistry()
        m.counter("rt_total", labels={"k": raw}).inc(2)
        text = m.render_prometheus()
        line = next(ln for ln in text.split("\n") if ln.startswith("rabia_rt_total{"))
        mlab = re.search(r'k="((?:[^"\\]|\\.)*)"', line)
        assert mlab is not None
        unescaped = (
            mlab.group(1).replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
        )
        assert unescaped == raw
        assert line.endswith(" 2")


def _schedule(obs, tracing, seed: int):
    """One registry driven through a fixed schedule drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    m = obs.MetricsRegistry()
    t = tracing.Tracer(enabled=True)
    m.attach_tracer(t)
    cell = {"n": 0}
    m.counter("src_total", "a source-backed counter", fn=lambda: cell["n"])
    m.gauge("depth", "a source-backed gauge", {"lane": "device"}, fn=lambda: cell["n"] % 7)
    g = m.gauge("level", "a set gauge")
    lat = m.histogram("commit_stage_seconds", "default buckets", {"stage": "window_settle"})
    slo = m.histogram("slo_seconds", "SLO buckets", {"stage": "decide_apply"},
                      buckets=obs.SLO_BUCKETS)
    m.histogram("phases_to_decide", "a source-backed histogram",
                buckets=tuple(float(b) for b in range(1, 33)),
                fn=lambda: ([cell["n"]] + [0] * 31, cell["n"], float(cell["n"])))
    for i in range(200):
        what = int(rng.integers(0, 6))
        if what == 0:
            m.counter("ops_total", "ops by path", {"path": ("probe", "slot")[i % 2]}).inc(
                int(rng.integers(1, 5)))
        elif what == 1:
            g.set(float(rng.normal()))
        elif what == 2:
            lat.observe(float(rng.lognormal(-6, 2)))
        elif what == 3:
            slo.observe(float(rng.lognormal(-9, 3)))
        elif what == 4:
            t.record(("engine.tick.drain", "sm.apply", 'wire."q"')[i % 3], float(rng.random()))
        else:
            cell["n"] += 1
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_renders_the_same_text(seed):
    ref = _schedule(ref_obs, ref_tracing, seed)
    port = _schedule(port_obs, port_tracing, seed)
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert port_obs.parse_prometheus_text(text) == ref_obs.parse_prometheus_text(text)
    assert port_obs.LATENCY_BUCKETS == ref_obs.LATENCY_BUCKETS
    assert port_obs.SLO_BUCKETS == ref_obs.SLO_BUCKETS
    assert port_obs.SLO_STAGES == ref_obs.SLO_STAGES
    assert port_obs.RUNTIME_STAGES == ref_obs.RUNTIME_STAGES
    for ns in (0, 1023, 1024, 1500, 2047, 2048, 10**6, 10**9, 10**12, 2**40):
        assert port_obs.slo_bucket_index(ns) == ref_obs.registry.slo_bucket_index(ns)


def test_engine_metric_families_match_the_reference():
    """Both engines' registries render the same families with the same
    names, labels, help and buckets: every sample line equal after the
    same counter values and histogram observations."""
    from rabia_tpu.core.state_machine import InMemoryStateMachine as RefSM
    from rabia_tpu.parallel import MeshEngine as RefMeshEngine
    from rabia_tpu.parallel import make_mesh
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
    from rabia_tpu_torch.parallel import MeshEngine

    ref = RefMeshEngine(RefSM, 8, 3, mesh=make_mesh(), window=4, latency_target_ms=20.0)
    port = MeshEngine(InMemoryStateMachine, 8, 3, device="cpu", window=4, latency_target_ms=20.0)
    for eng in (ref, port):
        eng.decided_v1 = 37
        eng.window_resizes = 3
        eng._read_stats.update(probe=128, slot=64, fallback=2, probe_windows=9)
        for v in (0.0004, 0.003, 0.2):
            eng._h_window_settle.observe(v)
        for d in (1, 3, 16):
            eng._h_read_batch.observe(float(d))
    assert port.metrics.render_prometheus() == ref.metrics.render_prometheus()


def test_device_annotation_names_the_region_and_device_trace_writes(tmp_path):
    """``span``, which names the program's regions in device traces,
    opens a ``torch.profiler`` range that a ``device_trace`` records and
    passes a body's exception through, inside the trace and outside it;
    the trace lands in ``logdir`` as a Chrome trace."""
    import json

    import torch

    with port_tracing.device_trace(str(tmp_path / "trace")):
        with port_tracing.span("test.region"):
            torch.ones(4).sum()
        with pytest.raises(KeyError):
            with port_tracing.span("test.raises"):
                raise KeyError("passes through")
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"test.region", "test.raises"} <= names
    with pytest.raises(KeyError):
        with port_tracing.span("test.raises"):
            raise KeyError("passes through")
