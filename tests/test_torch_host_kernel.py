"""The port's HostNodeKernel against the reference's, bit for bit.

The transport engine steps one replica's weak-MVC state per round with
``HostNodeKernel``. Here the port's copy runs its numpy path with its own
numpy coin (its C step is held against that in
test_torch_native_hostkernel.py); the reference's runs its C step where
its native library loads, else its numpy path. Seeded inbox sequences (valid votes, V?,
ABSENT and a garbage code) go through both, and every state field, every
outbox field and the coin/phase telemetry must agree after every
``start_slots`` and every ``node_step``. The numpy coin is held against
the reference's numpy coin and the port's torch coin."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rabia_tpu.kernel import host_driver as ref_hd
from rabia_tpu.kernel import phase_driver as ref_pd
from rabia_tpu_torch.core.types import ABSENT, V0, V1, VQUESTION
from rabia_tpu_torch.kernel import host_driver as port_hd
from rabia_tpu_torch.kernel import phase_driver as port_pd

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other


# -- the coin ---------------------------------------------------------------


@pytest.mark.parametrize("p1", [0.0, 0.5, 1.0, 0.3141592653589793])
def test_numpy_coin_matches_reference_and_torch_coin(p1):
    rng = np.random.default_rng(int(p1 * 1000) + 5)
    n = 4096
    for seed in [0, 1, 0xFFFFFFFF, *rng.integers(0, 2**32, size=4).tolist()]:
        idx = rng.integers(-(2**31), 2**31, size=(3, n)).astype(np.int32)
        idx[:, :4] = [0, 1, -1, 2**31 - 1]  # edges of the range
        got = port_hd.coin_bits_np(int(seed), idx[0], idx[1], idx[2], p1)
        want = ref_pd._coin_bits(int(seed), idx[0], idx[1], idx[2], p1, xp=np)
        torch_bits = port_pd._coin_bits(
            int(seed), *(torch.from_numpy(a) for a in idx), p1
        )
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want, err_msg=f"seed={seed}")
        np.testing.assert_array_equal(got, torch_bits.numpy(), err_msg=f"seed={seed}")


def test_numpy_coin_broadcasts_and_matches_scalar_coin():
    shard = np.arange(16, dtype=np.int32)
    bits = port_hd.coin_bits_np(9, shard, np.int32(5), np.int32(2), 0.5)
    assert bits.shape == (16,)
    for s in range(16):
        assert int(bits[s]) == ref_pd.device_coin(9, s, 5, 2, 0.5)


# -- the kernel -------------------------------------------------------------


def _random_round(rng, S, R, p_absent):
    """Inboxes of valid votes (V? often, so the coin runs), ABSENT and an
    out-of-range code (7) both kernels must ignore; decisions to adopt."""
    choices = np.array([ABSENT, V0, V1, VQUESTION, 7], np.int8)
    rest = 1.0 - p_absent
    probs = [p_absent, rest * 0.25, rest * 0.25, rest * 0.4, rest * 0.1]
    in1 = rng.choice(choices, size=(S, R), p=probs)
    in2 = rng.choice(choices, size=(S, R), p=probs)
    dec = rng.choice(np.array([ABSENT, ABSENT, ABSENT, ABSENT, V0, V1], np.int8), size=(S,))
    return in1, in2, dec


def _assert_same(ref_obj, port_obj, where):
    assert ref_obj._fields == port_obj._fields, where
    for f in ref_obj._fields:
        a, b = np.asarray(getattr(ref_obj, f)), np.asarray(getattr(port_obj, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where}: {f} layout"
        assert np.array_equal(a, b), f"{where}: {f} diverged"


def _assert_telemetry(rk, pk, where):
    assert np.array_equal(rk.coin_flips, pk.coin_flips), f"{where}: coin_flips"
    assert np.array_equal(rk.phase_hist, pk.phase_hist), f"{where}: phase_hist"
    assert int(rk.phase_sum) == int(pk.phase_sum), f"{where}: phase_sum"


def _ref_kernel(S, R, me, seed, ref_path):
    rk = ref_hd.HostNodeKernel(S, R, me, seed=seed, coin_p1=0.5)
    if ref_path == "numpy":
        rk._native_lib = None  # the reference's numpy step, not its C step
    return rk


@pytest.mark.parametrize("ref_path", ["default", "numpy"])
@pytest.mark.parametrize(
    "R,me,seed,p_absent",
    [(1, 0, 0, 0.3), (3, 1, 11, 0.45), (5, 4, 0xFFFFFFFF, 0.3), (7, 2, 123456, 0.55)],
)
def test_node_steps_match_reference_every_field(R, me, seed, p_absent, ref_path):
    S = 48
    rk = _ref_kernel(S, R, me, seed, ref_path)
    pk = port_hd.HostNodeKernel(S, R, me, seed=seed, coin_p1=0.5)
    pk._native_lib = None  # the port's numpy step (its C step: test_torch_native_hostkernel.py)
    rs, ps = rk.init_state(), pk.init_state()
    _assert_same(rs, ps, "init")
    rng = np.random.default_rng(R * 1000 + me)
    slot_counter = np.zeros(S, np.int64)
    for step in range(60):
        if step % 6 == 0:
            mask = rng.random(S) < 0.7
            init = rng.choice(np.array([V0, V1], np.int8), size=S)
            slot_counter[mask] += 1
            slots = slot_counter.astype(np.int32)
            rs = rk.start_slots(rs, mask, slots, init)
            ps = pk.start_slots(ps, mask, slots, init)
            _assert_same(rs, ps, f"start@{step}")
        in1, in2, dec = _random_round(rng, S, R, p_absent)
        rs, rob = rk.node_step(rs, in1, in2, dec if step % 3 else None)
        ps, pob = pk.node_step(ps, in1, in2, dec if step % 3 else None)
        _assert_same(rs, ps, f"step@{step}")
        _assert_same(rob, pob, f"outbox@{step}")
        _assert_telemetry(rk, pk, f"step@{step}")
    if R >= 3:  # one replica always decides its own vote: no coin
        assert int(pk.coin_flips.sum()) > 0  # the coin ran


@pytest.mark.parametrize("ref_path", ["default", "numpy"])
def test_zero_copy_ingest_matches_reference(ref_path):
    """The engine's ingest: votes scattered into the ledgers with
    offer_votes (first write wins), then node_step with no inboxes."""
    S, R = 32, 5
    rk = _ref_kernel(S, R, 2, 7, ref_path)
    pk = port_hd.HostNodeKernel(S, R, 2, seed=7, coin_p1=0.5)
    pk._native_lib = None  # the port's numpy step (its C step: test_torch_native_hostkernel.py)
    rs, ps = rk.init_state(), pk.init_state()
    rng = np.random.default_rng(17)
    slot_counter = np.zeros(S, np.int64)
    for step in range(40):
        if step % 5 == 0:
            mask = rng.random(S) < 0.8
            init = rng.choice(np.array([V0, V1], np.int8), size=S)
            slot_counter[mask] += 1
            rs = rk.start_slots(rs, mask, slot_counter.astype(np.int32), init)
            ps = pk.start_slots(ps, mask, slot_counter.astype(np.int32), init)
        for _ in range(3):
            rnd = int(rng.integers(1, 3))
            row = int(rng.integers(0, R))
            shards = np.unique(rng.integers(0, S, 12)).astype(np.int64)
            votes = rng.choice(np.array([V0, V1, VQUESTION], np.int8), size=len(shards))
            rk.offer_votes(rs, rnd, row, shards, votes)
            pk.offer_votes(ps, rnd, row, shards, votes)
        _assert_same(rs, ps, f"offer@{step}")
        rs, rob = rk.node_step(rs)
        ps, pob = pk.node_step(ps)
        _assert_same(rs, ps, f"step@{step}")
        _assert_same(rob, pob, f"outbox@{step}")
    _assert_telemetry(rk, pk, "end")


def test_clean_two_round_decision():
    """All-V1 unanimous inboxes decide V1 in two rounds."""
    S, R = 8, 5
    hk = port_hd.HostNodeKernel(S, R, me=0, seed=0)
    hk._native_lib = None  # the port's numpy step (its C step: test_torch_native_hostkernel.py)
    st = hk.start_slots(
        hk.init_state(), np.ones(S, bool), np.zeros(S, np.int32), np.full(S, V1, np.int8)
    )
    full = np.full((S, R), V1, np.int8)
    absent = np.full((S, R), ABSENT, np.int8)
    no_dec = np.full(S, ABSENT, np.int8)
    st, ob = hk.node_step(st, full, absent, no_dec)
    assert bool(np.all(ob.cast_r2)) and bool(np.all(ob.r2_vals == V1))
    st, ob = hk.node_step(st, absent, full, no_dec)
    assert bool(np.all(ob.newly_decided)) and bool(np.all(st.decided == V1))
