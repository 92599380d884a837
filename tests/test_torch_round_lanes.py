"""The round by receivers (``csrc/cluster_round.cuh``: ``RLane``,
``deliver_lane``, ``step_lane``, ``merge_decision``, ``adopts``,
``round_lanes`` and ``rounds_shard_lanes``, which the round kernel runs one
lane a receiver for R <= 8) against the one-thread ``round()`` it splits
and against the reference's ``ClusterKernel.round_step``.

The header is built for the host with g++; its host build runs a shard's
lanes one after another, with the exchanges across receivers as loops.
Field by field and round by round: R = 1..8, random masks with crashes
and partitions, a quorum-less shard and an inactive one, coin
probabilities 0, 0.5 and 1, slots past 2^31-1; chains of rounds in one
call from a state taken mid-protocol, under a mask stack, one mask for
every round (mask stride 0) and no mask (full delivery), past the round
where every shard settles (the kernel stops there); and states drawn at
random, reachable or not, against ``round()``. Tolerance: exact
equality (every field is an integer)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rabia_tpu.kernel.phase_driver import ClusterKernel as RefKernel
from rabia_tpu_torch.core.types import ABSENT, f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cuda_build
from rabia_tpu_torch.kernel.phase_driver import coin_threshold
from test_torch_cluster_round import FIELDS, _assert_fields, _case, _ref_fields

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

_HOST_SHIM = r"""
#include "cluster_round.cuh"
static cr::Ptrs ptrs(void* const* f) {
    cr::Ptrs p;
    p.slot = (int32_t*)f[0]; p.phase = (int32_t*)f[1]; p.stage = (int8_t*)f[2];
    p.my_r1 = (int8_t*)f[3]; p.my_r2 = (int8_t*)f[4]; p.prev_r1 = (int8_t*)f[5];
    p.prev_r2 = (int8_t*)f[6]; p.led1 = (int8_t*)f[7]; p.led2 = (int8_t*)f[8];
    p.decided = (int8_t*)f[9]; p.dphase = (int32_t*)f[10]; p.done = (uint8_t*)f[11];
    p.active = (uint8_t*)f[12];
    return p;
}
// lanes 1: the round by receivers (rounds_shard_lanes); 0: round() on one
// thread (rounds_shard, 32-bit masks), the oracle it is held against
extern "C" void cr_host(int lanes, void* const* in, void* const* out, const uint8_t* alive,
                        const uint8_t* masks, long long stride, int n, long long S, int R, int q,
                        int f1, unsigned seed, unsigned thr) {
    const cr::Ptrs pi = ptrs(in), po = ptrs(out);
    for (long long s = 0; s < S; ++s) {
        if (lanes) cr::rounds_shard_lanes(pi, po, alive, masks, stride, n, s, R, q, f1, seed, thr);
        else cr::rounds_shard<uint32_t, 8>(pi, po, alive, masks, stride, n, s, R, q, f1, seed, thr);
    }
}
"""


class _Host:
    def __init__(self, lib_path):
        lib = ctypes.CDLL(str(lib_path))
        P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
        lib.cr_host.argtypes = [I, P, P, P, P, LL, I, LL, I, I, I, U, U]
        lib.cr_host.restype = None
        self.lib = lib

    def rounds(self, fields: dict, alive, masks, n: int, seed: int, p1: float,
               lanes: bool = True) -> dict:
        """n rounds of every shard; ``masks`` None, [S,R,R] or [n,S,R,R]."""
        src = {f: np.ascontiguousarray(fields[f]).copy() for f in FIELDS}
        out = {f: np.empty_like(v) for f, v in src.items()}
        S, R = src["phase"].shape
        alive = np.ascontiguousarray(np.broadcast_to(alive, (S, R)), np.uint8)
        stride, mp = 0, None
        if masks is not None:
            masks = np.ascontiguousarray(masks, np.uint8)
            stride = S * R * R if masks.ndim == 4 else 0
            mp = masks.ctypes.data
        ins = (ctypes.c_void_p * 13)(*(src[f].ctypes.data for f in FIELDS))
        outs = (ctypes.c_void_p * 13)(*(out[f].ctypes.data for f in FIELDS))
        self.lib.cr_host(int(lanes), ins, outs, alive.ctypes.data, mp, stride, n, S, R,
                         quorum_size(R), f_plus_1(R), seed & 0xFFFFFFFF, coin_threshold(p1))
        return out


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The header compiled for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("cr_lanes_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libcr_lanes_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    return _Host(lib)


def _start(ref, active, initial, S):
    rs = ref.start_slot(ref.init_state(), jnp.asarray(active), jnp.asarray(initial))
    slots = np.arange(S, dtype=np.int64) * 7 + 2**31 - 20  # some slots past 2^31-1, wrapped
    return rs._replace(slot=jnp.asarray(((slots + 2**31) % 2**32 - 2**31).astype(np.int32)))


@pytest.mark.parametrize("p,p1,crash,partition", [(0.6, 0.5, True, False), (0.3, 1.0, False, True),
                                                  (1.0, 0.0, True, True)])
@pytest.mark.parametrize("R", range(1, 9))
def test_lanes_match_reference_round_step_every_field_every_round(host, R, p, p1, crash,
                                                                  partition):
    """One round a call, field by field after every round, against the
    reference's round_step and the header's one-thread round()."""
    S, T, seed = 6, 20, 100 * R + int(10 * p)
    initial, alive, active, masks = _case(seed, S, R, T, p, crash and R > 1, partition)
    ref = RefKernel(S, R, coin_p1=p1, seed=seed)
    rs = _start(ref, active, initial, S)
    lanes = one = _ref_fields(rs)
    for t in range(T):
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(masks[t]))
        want = _ref_fields(rs)
        lanes = host.rounds(lanes, alive, masks[t], 1, seed, p1)
        one = host.rounds(one, alive, masks[t], 1, seed, p1, lanes=False)
        _assert_fields(one, want, f"round(), round {t}")
        _assert_fields(lanes, want, f"round by receivers, round {t}")


@pytest.mark.parametrize("R", [3, 5, 8])
def test_lanes_chains_strides_and_settled_shards(host, R):
    """Chains of 1, 2, 7 and 30 rounds in one call from a mid-protocol
    reference state, under stacked masks, one mask for every round (mask
    stride 0) and none (full delivery); the full-delivery chain runs far
    past the round where every shard has settled."""
    S, seed, p1 = 8, 7 * R, 0.5
    initial, alive, active, masks = _case(seed, S, R, 60, 0.5, True, True)
    ref = RefKernel(S, R, coin_p1=p1, seed=seed)
    rs = _start(ref, active, initial, S)
    for t in range(4):  # the reference alone, part-way through the protocol
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(masks[t]))
    got, t = _ref_fields(rs), 4
    for n in (1, 2, 7, 30):
        for k in range(n):
            rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(masks[t + k]))
        got = host.rounds(got, alive, masks[t:t + n], n, seed, p1)
        t += n
        _assert_fields(got, _ref_fields(rs), f"after a chain of {n}")
    static = masks[0] | masks[1]
    for _ in range(3):
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(static))
    got = host.rounds(got, alive, static, 3, seed, p1)
    _assert_fields(got, _ref_fields(rs), "one mask for every round")
    full = np.ones((S, R, R), bool)
    for _ in range(25):
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(full))
    got = host.rounds(got, alive, None, 25, seed, p1)
    _assert_fields(got, _ref_fields(rs), "full delivery")
    # shards that settled (decided, every live replica done) ran rounds past it
    settled = active & ((alive & ~got["done"].astype(bool)).sum(1) == 0)
    assert settled.sum() >= 2 and (got["decided"][settled & alive.any(1)] != ABSENT).all()


def _random_state(rng, S: int, R: int) -> dict:
    """Every field at random within its protocol values: codes 0..3,
    stages 0/1, phases within two of each other (so senders are behind,
    level and ahead), ledgers of any codes, shards decided or not."""
    base = rng.integers(-3, 2**31 - 1, S).astype(np.int64)
    phase = ((base[:, None] + rng.integers(0, 3, (S, R)) + 2**31) % 2**32 - 2**31).astype(np.int32)
    code = lambda shape: rng.integers(0, 4, shape).astype(np.int8)  # noqa: E731
    decided = rng.choice([0, 1, ABSENT, ABSENT], S).astype(np.int8)
    return {
        "slot": rng.integers(-(2**31), 2**31 - 1, S).astype(np.int32),
        "phase": phase,
        "stage": rng.integers(0, 2, (S, R)).astype(np.int8),
        "my_r1": code((S, R)), "my_r2": code((S, R)), "prev_r1": code((S, R)),
        "prev_r2": code((S, R)), "led1": code((S, R, R)), "led2": code((S, R, R)),
        "decided": decided,
        "decided_phase": np.where(decided == ABSENT, -1, rng.integers(0, 5, S)).astype(np.int32),
        "done": rng.random((S, R)) < 0.3,
        "active": rng.random(S) < 0.85,
    }


@pytest.mark.parametrize("R", range(1, 9))
def test_lanes_equal_round_on_random_states(host, R):
    """States drawn at random (reachable or not), random masks and alive
    rows: the round by receivers equals round() field by field, one round
    at a time and over chains, at three coin probabilities."""
    rng = np.random.default_rng(500 + R)
    S = 64
    for p1 in (0.0, 0.5, 1.0):
        st = _random_state(rng, S, R)
        alive = rng.random((S, R)) < 0.8
        masks = rng.random((6, S, R, R)) < 0.6
        a = b = st
        for t in range(6):
            a = host.rounds(a, alive, masks[t], 1, R, p1)
            b = host.rounds(b, alive, masks[t], 1, R, p1, lanes=False)
            _assert_fields(a, b, f"random state, p1={p1}, round {t}")
        c = host.rounds(st, alive, masks, 6, R, p1)
        _assert_fields(c, b, f"random state, p1={p1}, a chain of 6")
        d = host.rounds(st, alive, None, 9, R, p1)
        _assert_fields(d, host.rounds(st, alive, None, 9, R, p1, lanes=False),
                       f"random state, p1={p1}, full delivery")
