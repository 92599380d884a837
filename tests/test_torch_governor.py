"""The port's latency governor (``MeshEngine(latency_target_ms=...)``)
against the reference's.

- The reference's ``TestLatencyGovernor`` (tests/test_mesh_engine.py) and
  ``TestGovernedDeviceLane`` (tests/test_device_kv.py), ported to the
  port's engine on ``device="cpu"``.
- One seeded sequence of cycle times, with saturation flags, fed to the
  reference's ``_govern`` and the port's through the sampling rule of
  ``run_cycle`` (the first cycle at each window size untimed): the
  window walks, the ceilings, ``window_resizes`` and ``governor_stats()``
  are equal after every sample.

Tolerance: exact (window sizes, counts, bytes; the p99 estimates are the
same numpy percentile of the same floats).
"""

from __future__ import annotations

import numpy as np
import pytest

from rabia_tpu.core.state_machine import InMemoryStateMachine as RefInMemoryStateMachine
from rabia_tpu.parallel import MeshEngine as RefMeshEngine
from rabia_tpu.parallel import make_mesh
from rabia_tpu_torch.apps import device_kv
from rabia_tpu_torch.apps.kvstore import encode_set_bin
from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
from rabia_tpu_torch.parallel import MeshEngine


def _mk(**kw):
    S = kw.pop("S", 16)
    return MeshEngine(
        lambda: VectorShardedKV(S, capacity=1 << 12),
        n_shards=S,
        n_replicas=3,
        device="cpu",
        **kw,
    )


def _set_wave(shards, w):
    return build_block(shards, [[encode_set_bin(f"k{s}", f"v{w}")] for s in shards])


class TestLatencyGovernor:
    """MeshEngine(latency_target_ms=...) auto-tunes `window` on a
    power-of-two ladder against measured per-window wall time."""

    def test_unreachable_target_shrinks_to_min(self):
        eng = _mk(window=16, latency_target_ms=1e-4, min_window=2)
        op = [encode_set_bin("k", "v")]
        for _ in range(30):
            for _ in range(4):
                for s in range(eng.n_shards):
                    eng.submit(op, s)
            eng.flush()
        assert eng.window == 2
        assert eng.window_resizes >= 3  # 16 -> 8 -> 4 -> 2

    def test_loose_target_grows_under_saturating_demand(self):
        eng = _mk(window=2, latency_target_ms=60_000.0, max_window=16)
        op = [encode_set_bin("k", "v")]
        for _ in range(30):
            for _ in range(16):  # queues deeper than the window
                for s in range(eng.n_shards):
                    eng.submit(op, s)
            eng.flush()
        assert eng.window > 2

    def test_no_growth_without_demand(self):
        eng = _mk(window=4, latency_target_ms=60_000.0, max_window=64)
        op = [encode_set_bin("k", "v")]
        for _ in range(30):  # 1-deep queues: a wider window buys nothing
            for s in range(eng.n_shards):
                eng.submit(op, s)
            eng.flush()
        assert eng.window == 4

    def test_unachievable_target_is_reported(self):
        eng = _mk(window=4, latency_target_ms=1e-4, min_window=1)
        op = [encode_set_bin("k", "v")]
        for _ in range(30):
            for s in range(eng.n_shards):
                eng.submit(op, s)
            eng.flush()
        assert eng.window == 1
        assert eng.latency_target_unachievable
        st = eng.governor_stats()
        assert st["unachievable"] is True
        assert st["floor_ms"] is not None and st["floor_ms"] > 1e-4
        assert st["window"] == 1

    def test_single_spike_does_not_veto_upsize(self):
        eng = _mk(window=4, latency_target_ms=150.0, max_window=64)
        eng._lat_samples.extend([10.0] * 62 + [200.0])
        eng._lat_saturated = True
        eng._govern(10.0)
        assert eng.window == 8
        assert eng.window_resizes == 1

    def test_downsize_sets_ceiling_that_blocks_reclimb(self):
        eng = _mk(window=8, latency_target_ms=100.0, max_window=64, min_window=4)
        eng._lat_samples.extend([50.0, 250.0, 250.0])
        eng._govern(250.0)  # two corroborating 2x overshoots -> down
        assert eng.window == 4
        assert eng._lat_ceiling == 8
        eng._lat_samples.extend([60.0] * 10)
        eng._lat_saturated = True
        eng._govern(60.0)
        assert eng.window == 4  # 4*2 == ceiling: parked (p99 > 0.5*t)
        assert eng.governor_stats()["ceiling_window"] == 8

    def test_single_spike_does_not_downsize(self):
        eng = _mk(window=8, latency_target_ms=100.0, max_window=64)
        eng._lat_samples.extend([50.0] * 10 + [850.0])  # lone glitch
        eng._govern(850.0)
        assert eng.window == 8  # held
        assert eng._lat_ceiling is None
        # a second overshoot while the first is still in the sample
        # window is real overload, and deep: fast descent to the floor
        eng._lat_samples.append(850.0)
        eng._govern(850.0)
        assert eng.window == eng.min_window
        assert eng._lat_ceiling == 8

    def test_post_resize_glitch_does_not_downsize(self):
        eng = _mk(window=8, latency_target_ms=250.0, max_window=64)
        eng._lat_samples.extend([90.0] * 5 + [850.0])  # glitch, n=6
        eng._govern(850.0)
        assert eng.window == 8  # held: 1 spike, p99 path needs n>=8
        assert eng._lat_ceiling is None

    def test_deep_overshoot_jumps_to_floor(self):
        eng = _mk(window=32, latency_target_ms=50.0, max_window=64, min_window=1)
        eng._lat_samples.extend([120.0] * 6)
        eng._govern(120.0)
        assert eng.window == 1  # jumped, not halved
        assert eng._lat_ceiling == 32

    def test_headroom_probe_clears_ceiling(self):
        eng = _mk(window=8, latency_target_ms=100.0, max_window=64, min_window=4)
        eng._lat_samples.extend([50.0, 250.0, 250.0])
        eng._govern(250.0)
        assert eng.window == 4 and eng._lat_ceiling == 8
        eng._lat_samples.extend([20.0] * 16)  # deep headroom at W=4
        eng._lat_saturated = True
        eng._govern(20.0)
        assert eng.window == 8  # probed back into the evicted size
        assert eng._lat_ceiling is None
        # overload at the re-entered size sets the ceiling again
        eng._lat_samples.extend([250.0, 250.0])
        eng._govern(250.0)
        assert eng.window == 4
        assert eng._lat_ceiling == 8

    def test_governor_stats_before_any_sample(self):
        eng = _mk(window=4, latency_target_ms=100.0)
        st = eng.governor_stats()
        assert st["p99_ms"] is None
        assert st["unachievable"] is False
        assert st["window"] == 4
        assert st["settle_p99_ms"] is None

    def test_settle_latency_reported_for_device_lane(self):
        n = 4
        eng = _mk(S=n, window=2, device_store=True)
        shards = list(range(n))
        for w in range(8):
            eng.submit_block(_set_wave(shards, w))
        eng.flush()
        st = eng.governor_stats()
        assert st["inflight"] == 3  # throughput-mode default
        assert st["settle_p99_ms"] is not None and st["settle_p99_ms"] > 0
        assert len(eng._lat_settle) >= 3
        # after demotion there is no pipelined commit: both report None
        eng._demote_device_store()
        st = eng.governor_stats()
        assert st["inflight"] is None
        assert st["settle_p99_ms"] is None

    def test_restore_clears_settle_samples(self):
        n = 4
        eng = _mk(S=n, window=2, device_store=True)
        shards = list(range(n))
        for w in range(8):
            eng.submit_block(_set_wave(shards, w))
        eng.flush()
        assert len(eng._lat_settle) > 0
        eng.restore(eng.checkpoint())
        assert len(eng._lat_settle) == 0
        st = eng.governor_stats()
        assert st["inflight"] is None and st["settle_p99_ms"] is None

    def test_settle_samples_exclude_compile_tainted_windows(self, monkeypatch):
        # a window resolved across a library build or load would count
        # one-off machinery as client latency: dispatches that load one
        # taint every in-flight window, and tainted windows give no
        # settle sample. On the CPU the one library is the host pack's;
        # unbound before the engine exists, the first window loads it
        monkeypatch.setattr(device_kv.HOST_PACK, "_fn", None)
        n = 4
        eng = _mk(S=n, window=2, device_store=True)
        shards = list(range(n))
        eng.submit_block(_set_wave(shards, 0))
        eng.submit_block(_set_wave(shards, 1))
        eng.flush()  # one window; its pack loaded the library -> tainted
        assert eng._dev.compiled_on_last_call
        assert eng._dev_active
        assert len(eng._lat_settle) == 0, "a load-tainted sample leaked"
        for w in range(2, 8):  # nothing loads: samples flow
            eng.submit_block(_set_wave(shards, w))
        eng.flush()
        assert not eng._dev.compiled_on_last_call
        assert len(eng._lat_settle) >= 2

    def test_governed_state_matches_ungoverned(self):
        def run(lat):
            eng = _mk(S=8, window=8, latency_target_ms=lat)
            rng = np.random.default_rng(5)
            keys = set()
            for i in range(150):
                s = int(rng.integers(0, 8))
                keys.add((s, f"k{i % 17}".encode()))
                eng.submit([encode_set_bin(f"k{i % 17}", f"v{i}")], s)
                if i % 13 == 0:
                    eng.flush()
            eng.flush()
            return eng, keys

        gov, keys = run(0.5)  # tight target: the window walks down mid-run
        plain, _ = run(None)
        assert gov.window_resizes > 0
        assert np.array_equal(gov.next_slot, plain.next_slot)
        for s, k in sorted(keys):
            for r in range(3):
                assert gov.sms[r].store.get(s, k) == plain.sms[r].store.get(s, k), (s, k, r)


def _set_blocks(n, waves, rng, keyspace=3):
    """Random full-width SET blocks: repeated keys across waves, varied
    value lengths."""
    return [
        build_block(list(range(n)), [
            [encode_set_bin(f"k{s}_{int(rng.integers(0, keyspace))}",
                            "v" * int(rng.integers(0, 24)) + f"{w}")]
            for s in range(n)
        ])
        for w in range(waves)
    ]


def _store_content(sm, n):
    st = sm.store
    out = {}
    for slot in np.nonzero(st.state == 1)[0].tolist():
        key = st.key_lanes[slot].view(np.uint8)[: int(st.key_len[slot])].tobytes()
        out[(int(st.shard_col[slot]), key)] = (st._value_at(slot), int(st.version[slot]))
    return out


class TestGovernedDeviceLane:
    def test_governor_resizes_with_device_store_conformant(self):
        """latency_target_ms + device_store compose: the governor walks W
        while the device lane stays active, and every response, the slot
        counters and the content equal a fixed-window host engine's."""
        n = 8
        eng = MeshEngine(
            lambda: VectorShardedKV(n, capacity=1 << 12), n_shards=n, n_replicas=3,
            device="cpu", window=2, device_store=True, latency_target_ms=60_000.0,
            max_window=8,
        )
        host = MeshEngine(lambda: VectorShardedKV(n, capacity=1 << 12), n_shards=n,
                          n_replicas=3, device="cpu", window=4)
        assert eng.governor_stats()["inflight"] == 1
        rng, rng_h = np.random.default_rng(2), np.random.default_rng(2)
        walk, futs = [eng.window], []
        for _ in range(25):
            fd = [eng.submit_block(b) for b in _set_blocks(n, waves=8, rng=rng)]  # saturates W
            fh = [host.submit_block(b) for b in _set_blocks(n, waves=8, rng=rng_h)]
            eng.flush()
            host.flush()
            futs += zip(fd, fh)
            walk.append(eng.window)
        assert eng.window_resizes > 0, "governor never resized"
        assert walk[-1] > walk[0]
        assert eng._dev_active
        assert eng._dev.pack_stats["native"] > 0 and eng._dev.pack_stats["numpy"] == 0
        for a, b in futs:
            assert [list(map(bytes, g)) for g in a.result()] == \
                [list(map(bytes, g)) for g in b.result()]
        assert np.array_equal(eng.next_slot, host.next_slot)
        eng._demote_device_store()
        want = _store_content(host.sms[0], n)
        for sm in eng.sms:
            assert _store_content(sm, n) == want


def _cycle_times(seed: int, target: float, n: int):
    """Cycle times (ms) around ``target``: calm stretches, overload
    stretches, lone glitches; a saturation flag per cycle."""
    rng = np.random.default_rng(seed)
    level = np.resize([0.2, 0.2, 1.3, 0.3, 0.45, 3.0, 0.2, 0.25, 0.8, 0.2, 0.2, 1.5, 0.3], n // 40 + 1)
    dt = np.repeat(level, 40)[:n] * target * rng.lognormal(0.0, 0.15, n)
    glitch = rng.random(n) < 0.03
    dt[glitch] *= rng.uniform(3.0, 12.0, int(glitch.sum()))
    return dt.tolist(), (rng.random(n) < 0.8).tolist()


def _state(eng) -> tuple:
    return (eng.window, eng._lat_ceiling, eng._lat_ceiling_age, eng.window_resizes,
            eng._lat_skip, eng.latency_target_unachievable, list(eng._lat_samples),
            eng.governor_stats())


@pytest.mark.parametrize("target,seed,window,lo,hi", [
    (10.0, 0, 16, 1, 256), (50.0, 1, 4, 2, 64), (2.0, 2, 256, 1, 256), (80.0, 3, 1, 1, 32),
])
def test_govern_walks_the_reference_windows(target, seed, window, lo, hi):
    kw = dict(window=window, latency_target_ms=target, min_window=lo, max_window=hi)
    ref = RefMeshEngine(RefInMemoryStateMachine, n_shards=8, n_replicas=3, mesh=make_mesh(), **kw)
    port = MeshEngine(InMemoryStateMachine, n_shards=8, n_replicas=3, device="cpu", **kw)
    assert _state(port) == _state(ref)
    times, saturated = _cycle_times(seed, target, 600)
    walk = set()
    for i, (dt, sat) in enumerate(zip(times, saturated)):
        for eng in (ref, port):
            # run_cycle's sampling rule around _govern
            eng._lat_saturated = sat
            if eng._lat_skip:
                eng._lat_skip -= 1
            else:
                eng._lat_samples.append(dt)
                eng._govern(dt)
        assert _state(port) == _state(ref), f"sample {i}"
        walk.add(port.window)
    assert port.window_resizes > 3 and len(walk) > 2  # the sequence walks the ladder
