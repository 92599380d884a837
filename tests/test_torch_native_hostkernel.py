"""C host-kernel step <-> numpy step bit-identity.

The port's copy of the reference's tests/test_native_hostkernel.py, retargeted to
rabia_tpu_torch (the port's native libraries, built from its own sources).

The C library (rabia_tpu_torch/native/hostkernel.cpp) is the engine's
per-activation fast path; the numpy implementation in
kernel/host_driver.py remains the semantics owner (and is held against
the reference's by tests/test_torch_host_kernel.py, so this file
transitively pins the port's C step to the reference). Random schedules cross every transition: slot starts, in-place
offer_votes ingest, inbox merges, decision adoption, quorum casts, phase
advances, and the portable lowbias32 common coin.
"""

from __future__ import annotations

import numpy as np
import pytest

from rabia_tpu_torch.kernel.host_driver import HostNodeKernel
from rabia_tpu_torch.native.build import load_hostkernel



def _pair(S: int, R: int, me: int, seed: int, p1: float):
    kc = HostNodeKernel(S, R, me=me, seed=seed, coin_p1=p1)
    kn = HostNodeKernel(S, R, me=me, seed=seed, coin_p1=p1)
    kn._native_lib = None  # force the numpy semantics owner
    assert kc._native() is not None
    return kc, kn


def _assert_same(sc, sn, oc, on, ctx) -> None:
    for f in sc._fields:
        assert np.array_equal(getattr(sc, f), getattr(sn, f)), (
            ctx, "state", f,
        )
    for f in oc._fields:
        assert np.array_equal(getattr(oc, f), getattr(on, f)), (
            ctx, "outbox", f,
        )


class TestNativeHostKernelParity:
    def test_differential_fuzz(self):
        rng = np.random.default_rng(11)
        for trial in range(60):
            S = int(rng.integers(1, 33))
            R = int(rng.choice([1, 2, 3, 4, 5, 7]))
            kc, kn = _pair(
                S, R,
                me=int(rng.integers(0, R)),
                seed=int(rng.integers(0, 2**31)),
                p1=float(rng.choice([0.5, 0.3, 1.0, 0.0])),
            )
            sc = kc.init_state()
            sn = kn.init_state()
            for step in range(24):
                if rng.random() < 0.5:
                    m = rng.random(S) < 0.3
                    sl = rng.integers(0, 100, S).astype(np.int32)
                    iv = rng.choice([0, 1], S).astype(np.int8)
                    sc = kc.start_slots(sc, m, sl, iv)
                    sn = kn.start_slots(sn, m, sl, iv)
                if rng.random() < 0.4:  # in-place offer_votes ingest
                    row = int(rng.integers(0, R))
                    rd = int(rng.choice([1, 2]))
                    sh = np.unique(rng.integers(0, S, 4)).astype(np.int64)
                    vo = rng.choice([0, 1, 2], len(sh)).astype(np.int8)
                    kc.offer_votes(sc, rd, row, sh, vo)
                    kn.offer_votes(sn, rd, row, sh, vo)
                ib1 = (
                    rng.choice(
                        [0, 1, 2, 3], (S, R), p=[0.2, 0.2, 0.1, 0.5]
                    ).astype(np.int8)
                    if rng.random() < 0.7
                    else None
                )
                ib2 = (
                    rng.choice(
                        [0, 1, 2, 3], (S, R), p=[0.2, 0.2, 0.1, 0.5]
                    ).astype(np.int8)
                    if rng.random() < 0.7
                    else None
                )
                dec = (
                    rng.choice([0, 1, 3], S, p=[0.05, 0.05, 0.9]).astype(
                        np.int8
                    )
                    if rng.random() < 0.5
                    else None
                )
                sc, oc = kc.node_step(sc, ib1, ib2, dec)
                sn, on = kn.node_step(sn, ib1, ib2, dec)
                _assert_same(sc, sn, oc, on, (trial, step))

    def test_coin_path_exercised(self):
        # all-V? round-2 quorum forces the common-coin branch: both
        # sides must flip identical lowbias32 bits per (shard,slot,phase)
        S, R = 8, 3
        kc, kn = _pair(S, R, me=0, seed=1234, p1=0.5)
        sc = kc.init_state()
        sn = kn.init_state()
        m = np.ones(S, bool)
        sl = np.arange(S, dtype=np.int32)
        iv = np.ones(S, np.int8)
        sc = kc.start_slots(sc, m, sl, iv)
        sn = kn.start_slots(sn, m, sl, iv)
        vq = np.full((S, R), 2, np.int8)
        # R1 quorum of V? -> cast R2=V?; R2 quorum of V? -> coin advance
        for ib1, ib2 in ((vq, None), (None, vq)):
            sc, oc = kc.node_step(sc, ib1, ib2)
            sn, on = kn.node_step(sn, ib1, ib2)
            _assert_same(sc, sn, oc, on, "coin")
        assert (sc.phase == 1).all()  # advanced via the coin
        assert np.isin(sc.my_r1, (0, 1)).all()

    def test_ping_pong_workspace_stability(self):
        # a returned state/outbox must stay intact across ONE further
        # node_step (the documented aliasing window)
        kc, _ = _pair(4, 3, me=1, seed=7, p1=0.5)
        st = kc.start_slots(
            kc.init_state(),
            np.ones(4, bool),
            np.zeros(4, np.int32),
            np.ones(4, np.int8),
        )
        ib = np.ones((4, 3), np.int8)
        st1, ob1 = kc.node_step(st, ib, None)
        snap = {f: getattr(st1, f).copy() for f in st1._fields}
        st2, _ = kc.node_step(st1, None, ib)
        for f in st1._fields:  # st1 untouched by the following step
            assert np.array_equal(getattr(st1, f), snap[f]), f
        assert st2 is not st1

    def test_open_scan_matches_numpy(self):
        lib = load_hostkernel()
        rng = np.random.default_rng(3)
        for _ in range(50):
            n = int(rng.integers(1, 64))
            next_slot = rng.integers(0, 50, n)
            applied = rng.integers(0, 50, n)
            in_flight = rng.random(n) < 0.5
            queue_len = rng.integers(0, 3, n)
            prop = rng.random(n) < 0.2
            dec = rng.random(n) < 0.2
            votes_seen = rng.integers(-1, 50, n)
            tainted = rng.integers(0, 2, n) * rng.integers(0, 20, n)
            head = np.zeros(n, np.int64)
            cand = np.zeros(n, np.uint8)
            cnt = lib.rk_open_scan(
                n,
                next_slot.ctypes.data, applied.ctypes.data,
                in_flight.ctypes.data, queue_len.ctypes.data,
                prop.ctypes.data, dec.ctypes.data,
                votes_seen.ctypes.data, tainted.ctypes.data,
                head.ctypes.data, cand.ctypes.data,
            )
            head_np = np.maximum(next_slot, applied)
            cand_np = ~in_flight & (
                (queue_len > 0)
                | prop
                | dec
                | (votes_seen >= head_np)
                | (tainted > 0)
            )
            assert np.array_equal(head, head_np)
            assert np.array_equal(cand.astype(bool), cand_np)
            assert cnt == int(cand_np.sum())

    def test_forced_python_env(self, monkeypatch):
        # RABIA_PY_HOSTKERNEL=1 must force the numpy step
        import rabia_tpu_torch.native.build as build

        monkeypatch.setenv("RABIA_PY_HOSTKERNEL", "1")
        monkeypatch.setattr(build, "_LOADED", {})
        assert build.load_hostkernel() is None
