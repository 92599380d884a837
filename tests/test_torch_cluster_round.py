"""The round kernel's per-shard header against the reference's
``ClusterKernel.round_step`` and ``slot_pipeline``, and the port's
``WeakMVCOracle`` against the reference's.

``csrc/cluster_round.cuh`` is built for the host with g++, in both of
its widths (32-bit masks with the replica loops unrolled, which the
kernel takes for R <= 8, and 64-bit masks), and run on the same inputs
as the reference's XLA programs: ``round_step`` field by field after
every step under the same explicit numpy delivery masks (lossy,
partitioned, with crashes, a quorum-less shard and an inactive shard;
coin probabilities 0, 0.5 and 1), chains of rounds in one call, a
reference state taken mid-protocol, and ``slot_pipeline`` at 1, 2 and 4
rounds a slot with slot numbers that wrap past 2^31-1. The wrapper's
refusals and the CPU dispatch are checked too; the kernels themselves are
held against the plain versions by the cuda-marked tests of
test_torch_slice.py, which import no jax. Tolerance: exact equality
(every field is an integer)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import start_slot_host

from rabia_tpu.core import oracle as ref_oracle
from rabia_tpu.kernel.phase_driver import ClusterKernel as RefKernel
from rabia_tpu_torch import convert
from rabia_tpu_torch.core import oracle
from rabia_tpu_torch.core.types import ABSENT, f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cluster_round, cuda_build
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel, coin_threshold, device_coin

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

FIELDS = [name for name, _, _ in cluster_round.FIELDS]

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
extern "C" void cr_host_rounds(void* const* in, void* const* out, const uint8_t* alive,
                               const uint8_t* masks, long long stride, int n, long long S, int R,
                               int q, int f1, unsigned seed, unsigned thr, int wide) {
    const cr::Ptrs pi = ptrs(in), po = ptrs(out);
    for (long long s = 0; s < S; ++s) {
        if (wide) cr::rounds_shard<uint64_t, 64>(pi, po, alive, masks, stride, n, s, R, q, f1, seed, thr);
        else cr::rounds_shard<uint32_t, 8>(pi, po, alive, masks, stride, n, s, R, q, f1, seed, thr);
    }
}
// slot_pipeline's (slot, shard) entries, by one of four paths: the
// per-receiver rounds (fresh + round, as cr_rounds runs them) in the
// 32-bit (0) or 64-bit (1) build, the full-delivery rule once a (slot,
// shard) (2; the kernel's path for R > 8), or the rule on chunks of 16
// shards, four lanes a word (3; the kernel's path for R <= 8).
template <typename M, int RM>
static void receivers(const int8_t* votes, const uint8_t* alive, int8_t* dec, int32_t* ph,
                      long long T, long long S, int R, int base, int rounds, int q, int f1,
                      unsigned seed, unsigned thr) {
    M din[RM];
    cr::senders_of(din, static_cast<const uint8_t*>(nullptr), R);
    for (long long t = 0; t < T; ++t)
        for (long long s = 0; s < S; ++s) {
            const long long i = t * S + s;
            const int32_t slot = (int32_t)mw::slot_of(base, (int)t);
            cr::Shard<M, RM> x;
            cr::fresh(x, votes + i * R, R, slot);
            const M a = cr::alive_of<M>(alive, s, R);
            const uint32_t prefix = mw::coin_prefix(seed, (uint32_t)s, (uint32_t)slot);
            for (int k = 0; k < rounds; ++k) cr::round(x, R, a, din, q, f1, prefix, thr);
            dec[i] = x.decided;
            ph[i] = x.dphase;
        }
}
template <int R>
static void chunks(const int8_t* votes, const uint8_t* alive, int8_t* dec, int32_t* ph,
                   long long T, long long S, int base, int rounds, int q, unsigned seed,
                   unsigned thr) {
    for (long long t = 0; t < T; ++t)
        for (long long s0 = 0; s0 < S; s0 += 16) {
            const int n = (int)(S - s0 < 16 ? S - s0 : 16);
            const long long i = t * S + s0;
            cr::pipeline_chunk_bytes<R>(votes + i * R, alive + s0 * R, n, (uint32_t)q, rounds, seed,
                                        thr, (uint32_t)s0, mw::slot_of(base, (int)t), dec + i,
                                        ph + i);
        }
}
static void pipeline(int path, const int8_t* votes, const uint8_t* alive, int8_t* dec,
                     int32_t* ph, long long T, long long S, int R, int base, int rounds, int q,
                     int f1, unsigned seed, unsigned thr) {
    if (path == 0) return receivers<uint32_t, 8>(votes, alive, dec, ph, T, S, R, base, rounds, q, f1, seed, thr);
    if (path == 1) return receivers<uint64_t, 64>(votes, alive, dec, ph, T, S, R, base, rounds, q, f1, seed, thr);
    if (path == 2) {
        for (long long i = 0; i < T * S; ++i) {
            const long long t = i / S, s = i % S;
            const uint32_t prefix = mw::coin_prefix(seed, (uint32_t)s, mw::slot_of(base, (int)t));
            const cr::Decision x = cr::full_delivery(votes + i * R, alive + s * R, R, q, rounds, prefix, thr);
            dec[i] = x.decided;
            ph[i] = x.phase;
        }
        return;
    }
    switch (R) {
        case 1: return chunks<1>(votes, alive, dec, ph, T, S, base, rounds, q, seed, thr);
        case 2: return chunks<2>(votes, alive, dec, ph, T, S, base, rounds, q, seed, thr);
        case 3: return chunks<3>(votes, alive, dec, ph, T, S, base, rounds, q, seed, thr);
        case 4: return chunks<4>(votes, alive, dec, ph, T, S, base, rounds, q, seed, thr);
        case 5: return chunks<5>(votes, alive, dec, ph, T, S, base, rounds, q, seed, thr);
        case 6: return chunks<6>(votes, alive, dec, ph, T, S, base, rounds, q, seed, thr);
        case 7: return chunks<7>(votes, alive, dec, ph, T, S, base, rounds, q, seed, thr);
        default: return chunks<8>(votes, alive, dec, ph, T, S, base, rounds, q, seed, thr);
    }
}
// n configurations (rounds, base, threshold) of one case set in one call;
// configuration c writes dec[c*T*S ..) and ph[c*T*S ..).
extern "C" void cr_host_pipeline(int path, const int8_t* votes, const uint8_t* alive, int8_t* dec,
                                 int32_t* ph, long long T, long long S, int R, int n,
                                 const int* rounds, const int* bases, const unsigned* thrs,
                                 int q, int f1, unsigned seed) {
    for (int c = 0; c < n; ++c)
        pipeline(path, votes, alive, dec + c * T * S, ph + c * T * S, T, S, R, bases[c],
                 rounds[c], q, f1, seed, thrs[c]);
}
"""


class _Host:
    """The header's host build: ``rounds`` and ``pipeline`` on numpy."""

    def __init__(self, lib_path):
        lib = ctypes.CDLL(str(lib_path))
        P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
        lib.cr_host_rounds.argtypes = [P, P, P, P, LL, I, LL, I, I, I, U, U, I]
        lib.cr_host_pipeline.argtypes = [I, P, P, P, P, LL, LL, I, I, P, P, P, I, I, U]
        self.lib = lib

    def rounds(self, fields: dict, alive, masks, n: int, seed: int, p1: float, wide: bool) -> dict:
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
        self.lib.cr_host_rounds(ins, outs, alive.ctypes.data, mp, stride, n, S, R,
                                quorum_size(R), f_plus_1(R), seed & 0xFFFFFFFF,
                                coin_threshold(p1), int(wide))
        return out

    def pipeline(self, path: int, votes, alive, configs, seed: int):
        """slot_pipeline's decisions and phases by ``path`` (0, 1: the
        per-receiver rounds in the 32- and 64-bit builds; 2: the
        full-delivery rule; 3: the rule on chunks of 16 shards, R <= 8)
        for each ``(rounds, base, coin_p1)`` of ``configs``, in one call:
        ``(decided i8[C, T, S], phase i32[C, T, S])``."""
        votes = np.ascontiguousarray(votes, np.int8)
        T, S, R = votes.shape
        alive = np.ascontiguousarray(np.broadcast_to(alive, (S, R)), np.uint8)
        rounds, bases, thrs = (np.ascontiguousarray(x) for x in zip(*(
            (np.int32(r), np.int32(b), np.uint32(coin_threshold(p1))) for r, b, p1 in configs)))
        dec = np.empty((len(configs), T, S), np.int8)
        ph = np.empty((len(configs), T, S), np.int32)
        self.lib.cr_host_pipeline(path, votes.ctypes.data, alive.ctypes.data, dec.ctypes.data,
                                  ph.ctypes.data, T, S, R, len(configs), rounds.ctypes.data,
                                  bases.ctypes.data, thrs.ctypes.data, quorum_size(R),
                                  f_plus_1(R), seed & 0xFFFFFFFF)
        return dec, ph


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The kernel's header compiled for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("cr_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libcr_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    return _Host(lib)


def _ref_fields(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_fields(got: dict, want: dict, ctx: str) -> None:
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, (ctx, f)
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{ctx} field {f}")


def _case(seed: int, S: int, R: int, T: int, p: float, crash: bool, partition: bool):
    """Initial votes (V0/V1, a few V? and ABSENT), a crash mask (two dead
    replicas on some shards, shard 1 without a quorum), an active mask
    with the last shard inactive, and T delivery masks."""
    rng = np.random.default_rng(seed)
    initial = rng.integers(0, 2, size=(S, R)).astype(np.int8)
    initial[0, : R // 2] = rng.integers(2, 4, size=R // 2)
    alive = np.ones((S, R), bool)
    if crash:
        alive[:, 0] = False
        alive[::2, R - 1] = False
        alive[1, : quorum_size(R)] = False
    active = np.ones(S, bool)
    active[-1] = False
    masks = rng.random((T, S, R, R)) < p
    if partition:  # {0,1} | {2..R-1} for the first half of the run
        side = np.arange(R) < 2
        masks[: T // 2, :, side[:, None] != side[None, :]] = False
    return initial, alive, active, masks


ROUND_CASES = [
    # R, p, coin_p1, crash, partition
    (1, 1.0, 0.5, False, False),
    (3, 1.0, 0.0, False, False),
    (3, 0.6, 0.5, True, False),
    (4, 0.5, 1.0, True, True),
    (5, 0.6, 0.5, False, True),
    (5, 0.3, 0.0, True, False),
    (7, 0.6, 1.0, True, False),
    (8, 0.3, 0.5, False, True),
    (8, 1.0, 0.5, True, False),
]


@pytest.mark.parametrize("R,p,p1,crash,partition", ROUND_CASES)
def test_header_round_matches_reference_every_field_every_step(host, R, p, p1, crash, partition):
    S, T, seed = 6, 24, 10 * R + int(10 * p)
    initial, alive, active, masks = _case(seed, S, R, T, p, crash, partition)
    ref = RefKernel(S, R, coin_p1=p1, seed=seed)
    rs = ref.start_slot(ref.init_state(), jnp.asarray(active), jnp.asarray(initial))
    slots = np.arange(S, dtype=np.int64) * 7 + 2**31 - 20  # some slots past 2^31-1, wrapped
    rs = rs._replace(slot=jnp.asarray(((slots + 2**31) % 2**32 - 2**31).astype(np.int32)))
    narrow = wide = _ref_fields(rs)
    for t in range(T):
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(masks[t]))
        want = _ref_fields(rs)
        narrow = host.rounds(narrow, alive, masks[t], 1, seed, p1, wide=False)
        wide = host.rounds(wide, alive, masks[t], 1, seed, p1, wide=True)
        _assert_fields(narrow, want, f"32-bit masks, step {t}")
        _assert_fields(wide, want, f"64-bit masks, step {t}")
    assert (want["decided"][:-1] != ABSENT).any() or p < 0.5  # the run got somewhere


@pytest.mark.parametrize("wide", [False, True])
def test_header_chains_of_rounds_and_a_mid_protocol_state(host, wide):
    """Chains of 1, 2, 7 and 14 rounds in one call, stacked masks and one
    static mask, starting from a reference state taken mid-protocol."""
    S, R, seed, p1 = 8, 5, 17, 0.5
    initial, alive, active, masks = _case(seed, S, R, 40, 0.5, True, True)
    ref = RefKernel(S, R, coin_p1=p1, seed=seed)
    rs = ref.start_slot(ref.init_state(), jnp.asarray(active), jnp.asarray(initial))
    rs = rs._replace(slot=jnp.full((S,), 41, jnp.int32))
    for t in range(6):  # reference alone, part-way through the protocol
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(masks[t]))
    got, t = _ref_fields(rs), 6
    for n in (1, 2, 7, 14):
        for k in range(n):
            rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(masks[t + k]))
        got = host.rounds(got, alive, masks[t:t + n], n, seed, p1, wide)
        t += n
        _assert_fields(got, _ref_fields(rs), f"after a chain of {n}")
    static = masks[0] | masks[1]
    for _ in range(3):
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(static))
    got = host.rounds(got, alive, static, 3, seed, p1, wide)
    _assert_fields(got, _ref_fields(rs), "static mask")
    full = np.ones((S, R, R), bool)
    for _ in range(2):
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(full))
    got = host.rounds(got, alive, None, 2, seed, p1, wide)
    _assert_fields(got, _ref_fields(rs), "full delivery")


# the host build's slot_pipeline paths (_Host.pipeline)
RECEIVERS32, RECEIVERS64, RULE, CHUNKS = 0, 1, 2, 3
PATHS = {RECEIVERS32: "rounds, 32-bit", RECEIVERS64: "rounds, 64-bit",
         RULE: "full_delivery", CHUNKS: "decide_chunk"}


def _assert_pipeline(host, path, votes, alive, configs, seed, want_d, want_p, ctx):
    d, ph = host.pipeline(path, votes, alive, configs, seed)
    np.testing.assert_array_equal(d, want_d, err_msg=f"{ctx}: {PATHS[path]} decisions")
    np.testing.assert_array_equal(ph, want_p, err_msg=f"{ctx}: {PATHS[path]} phases")


@pytest.mark.parametrize("rounds", [1, 2, 4])
@pytest.mark.parametrize("R,p1", [(1, 0.5), (3, 0.0), (5, 0.5), (7, 1.0), (8, 0.5)])
def test_header_pipeline_matches_reference_slot_pipeline(host, R, p1, rounds):
    """The full-delivery rule (once a (slot, shard), and on chunks of 16
    shards) and the per-receiver rounds in both widths against the
    reference's slot_pipeline, slots wrapping past 2^31-1."""
    S, T, seed = 9, 8, 3 * R + rounds
    start = 2**31 - 3  # slots 2^31-3 .. 2^31-1, then -2^31 ..: the slot wraps
    rng = np.random.default_rng(seed)
    votes = rng.choice([0, 1, 2, 3], size=(T, S, R), p=[0.4, 0.4, 0.1, 0.1]).astype(np.int8)
    votes[:, 2::3] = rng.integers(0, 2, size=votes[:, 2::3].shape)  # split V0/V1: the coin
    alive = rng.random((S, R)) > 0.25
    alive[0, : quorum_size(R)] = False
    ref = RefKernel(S, R, coin_p1=p1, seed=seed)
    want_d, want_p = (np.asarray(x) for x in ref.slot_pipeline(
        jnp.asarray(votes), jnp.asarray(alive), T, rounds_per_slot=rounds, start_slot_index=start))
    for path in (RULE, CHUNKS, RECEIVERS32, RECEIVERS64):
        _assert_pipeline(host, path, votes, alive, [(rounds, start, p1)], seed, want_d[None],
                         want_p[None], f"R={R} rounds={rounds}")
    # the port's plain loop wraps the slot as the reference does
    port = ClusterKernel(S, R, coin_p1=p1, seed=seed, device="cpu")
    d, ph = port.slot_pipeline(torch.from_numpy(votes), torch.from_numpy(alive), T,
                               rounds_per_slot=rounds, start_slot_index=start)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(ph.numpy(), want_p)


@pytest.mark.parametrize("R", [1, 2, 3, 4, 5])
def test_full_delivery_rule_equals_the_rounds_on_every_case(host, R):
    """Exhaustive: every vote vector in {V0, V1, V?, ABSENT}^R (one a slot)
    under every alive mask (one a shard), rounds 0..6, coin_p1 0, 0.5 and
    1, first slots 0, 7 and 2^31-1; the rule once a (slot, shard) and on
    chunks of 16 shards against fresh + round, the per-receiver rounds
    that cr_rounds runs."""
    T, S, seed = 4**R, 2**R, 11 * R
    codes = (np.arange(T)[:, None] >> (2 * np.arange(R))[None, :]) & 3
    votes = np.broadcast_to(codes[:, None, :], (T, S, R)).astype(np.int8)
    alive = ((np.arange(S)[:, None] >> np.arange(R)[None, :]) & 1).astype(bool)
    configs = [(rounds, base, p1) for rounds in range(7) for p1 in (0.0, 0.5, 1.0)
               for base in (0, 7, 2**31 - 1)]
    want_d, want_p = host.pipeline(RECEIVERS32, votes, alive, configs, seed)
    for path in (RULE, CHUNKS):
        _assert_pipeline(host, path, votes, alive, configs, seed, want_d, want_p,
                         f"exhaustive R={R}")
    outcomes = set(zip(want_d.ravel().tolist(), want_p.ravel().tolist()))
    assert outcomes == {(ABSENT, -1), (0, 0), (1, 0), (0, 1), (1, 1)}  # every branch, both coins


@pytest.mark.parametrize("rounds", range(6))
@pytest.mark.parametrize("R", [1, 3, 5, 7, 8, 13, 64])
def test_full_delivery_rule_matches_reference_slot_pipeline(host, R, rounds):
    """Random votes against the reference's slot_pipeline up to R = 64:
    shards leaning V1, leaning V0, split or mostly ABSENT, crashes and a
    quorum-less shard, S = 21 (a chunk of 16 and a ragged one), and slots
    that wrap past 2^31-1 at odd rounds."""
    S, T, seed = 21, 6, 1000 + 10 * R + rounds
    p1 = (0.0, 0.5, 1.0)[(R + rounds) % 3]
    start = 2**31 - 3 if rounds % 2 else 5
    rng = np.random.default_rng(seed)
    lean = np.array([[0.05, 0.85, 0.05, 0.05], [0.85, 0.05, 0.05, 0.05],
                     [0.4, 0.4, 0.15, 0.05], [0.1, 0.1, 0.1, 0.7]])
    kind = np.arange(S) % len(lean)
    votes = np.stack([rng.choice(4, size=(T, R), p=lean[k]) for k in kind], axis=1).astype(np.int8)
    alive = rng.random((S, R)) > 0.3
    alive[0, : quorum_size(R)] = False
    ref = RefKernel(S, R, coin_p1=p1, seed=seed)
    want_d, want_p = (np.asarray(x) for x in ref.slot_pipeline(
        jnp.asarray(votes), jnp.asarray(alive), T, rounds_per_slot=rounds, start_slot_index=start))
    for path in (RULE, CHUNKS) if R <= 8 else (RULE,):
        _assert_pipeline(host, path, votes, alive, [(rounds, start, p1)], seed, want_d[None],
                         want_p[None], f"R={R} rounds={rounds}")
    if rounds >= 2:
        assert (want_d != ABSENT).any()


def test_header_64_replicas_matches_the_port_plain_round(host):
    """R above 8 takes the 64-bit build only; held against the port's
    plain round (itself held to the reference at R <= 8)."""
    S, R, seed, p1 = 4, 64, 5, 0.5
    initial, alive, active, masks = _case(seed, S, R, 12, 0.6, True, True)
    k = ClusterKernel(S, R, coin_p1=p1, seed=seed, device="cpu")
    st = k.start_slot(k.init_state(), torch.from_numpy(active), torch.from_numpy(initial))
    got = convert.cluster_state_to_numpy(st)
    for t in range(12):
        st = k.round_step(st, torch.from_numpy(alive), torch.from_numpy(masks[t]))
        got = host.rounds(got, alive, masks[t], 1, seed, p1, wide=True)
        _assert_fields(got, convert.cluster_state_to_numpy(st), f"step {t}")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    K = cluster_round.CLUSTER_ROUND
    k = ClusterKernel(4, 65, device="cpu")
    st = k.start_slot(k.init_state(), torch.ones(4, dtype=torch.bool),
                      torch.ones((4, 65), dtype=torch.int8))
    alive = torch.ones((4, 65), dtype=torch.bool)
    args = dict(quorum=k.quorum, f1=k.f1, seed=0, threshold=0)
    with pytest.raises(ValueError, match="1..64 replicas"):
        K.rounds(list(st), alive, None, 1, **args)
    with pytest.raises(ValueError, match="1..64 replicas"):
        K.slot_pipeline(torch.ones((2, 4, 65), dtype=torch.int8), alive, base=0, rounds=2, **args)
    k = ClusterKernel(4, 3, device="cpu")
    st = list(k.start_slot(k.init_state(), torch.ones(4, dtype=torch.bool),
                           torch.ones((4, 3), dtype=torch.int8)))
    alive = torch.ones((4, 3), dtype=torch.bool)
    args = dict(quorum=k.quorum, f1=k.f1, seed=0, threshold=0)
    with pytest.raises(ValueError, match="13 fields"):
        K.rounds(st[:12], alive, None, 1, **args)
    bad = list(st)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="phase"):
        K.rounds(bad, alive, None, 1, **args)
    with pytest.raises(ValueError, match="masks"):
        K.rounds(st, alive, torch.ones((2, 4, 3, 3), dtype=torch.bool), 1, **args)
    with pytest.raises(ValueError, match="CUDA"):
        K.rounds(st, alive, None, 1, **args)
    with pytest.raises(ValueError, match="int32"):
        K.slot_pipeline(torch.ones((2, 4, 3), dtype=torch.int8), alive, base=2**31, rounds=2,
                        **args)
    with pytest.raises(ValueError, match="CUDA"):
        K.slot_pipeline(torch.ones((2, 4, 3), dtype=torch.int8), alive, base=0, rounds=2, **args)


def test_cpu_tensors_take_the_plain_versions():
    S, R, T = 8, 5, 4
    k = ClusterKernel(S, R, seed=2, device="cpu")
    before = dict(cluster_round.CLUSTER_ROUND.counts)
    votes = torch.ones((T, S, R), dtype=torch.int8)
    alive = torch.ones((S, R), dtype=torch.bool)
    d, _ = k.slot_pipeline(votes, alive, T)
    k.slot_pipeline_wide(votes, alive, T, block=2)
    st = k.start_slot(k.init_state(), torch.ones(S, dtype=torch.bool), votes[0])
    st = k.run_rounds(st, alive, 3, torch.Generator().manual_seed(0), p_deliver=0.5)
    st = k.round_step(st, alive, torch.ones((S, R, R), dtype=torch.bool))
    assert cluster_round.CLUSTER_ROUND.counts == before  # no kernel on the CPU
    assert torch.all(d == 1)


# -- the oracle ---------------------------------------------------------------


def _oracle_trace(mod, R, initial, alive, masks, seed, shard, slot):
    """Every node's fields after every step of one shard's trace."""
    coin = lambda ph: device_coin(seed, shard, slot, ph)  # noqa: E731
    o = mod.WeakMVCOracle(R, list(initial), coin, alive=list(alive))
    trace = []
    for m in masks:
        o.step(lambda i, j, m=m: bool(m[i, j]))
        trace.append((o.decided_value, o.decided_phase,
                      [(n.phase, n.stage, n.my_r1, n.my_r2, n.prev_r1, n.prev_r2,
                        dict(n.led1), dict(n.led2), n.decided) for n in o.nodes]))
    return trace


@pytest.mark.parametrize("R,p,seed", [(3, 1.0, 0), (4, 0.5, 4), (5, 0.35, 3), (7, 0.6, 5)])
def test_port_oracle_equals_reference_oracle(R, p, seed):
    rng = np.random.default_rng(seed)
    initial = rng.integers(0, 2, size=R)
    alive = np.ones(R, bool)
    alive[0] = seed % 2 == 0
    masks = rng.random((30, R, R)) < p
    assert _oracle_trace(oracle, R, initial, alive, masks, seed, 2, 9) == _oracle_trace(
        ref_oracle, R, initial, alive, masks, seed, 2, 9)
    o = oracle.WeakMVCOracle(R, [1] * R, oracle.seeded_coin(seed))
    o.run()
    o.check_agreement()
    o.check_validity([1] * R)
    assert o.decided_value == 1


def _compare_to_oracles(st: dict, oracles, alive, ctx):
    """The kernel's state against one oracle a shard (the reference's
    TestOracleConformance._compare): decisions, decided phases, and every
    undecided live replica's phase, stage and votes."""
    for s, o in enumerate(oracles):
        kd = None if st["decided"][s] == ABSENT else int(st["decided"][s])
        assert kd == o.decided_value, f"{ctx} shard {s}"
        kp = None if st["decided_phase"][s] < 0 else int(st["decided_phase"][s])
        assert kp == o.decided_phase, f"{ctx} shard {s}"
        for r, node in enumerate(o.nodes):
            if not alive[s, r]:
                continue
            assert st["done"][s, r] == (node.decided is not None), f"{ctx} shard {s} replica {r}"
            if node.decided is not None:
                continue
            assert (st["phase"][s, r], st["stage"][s, r], st["my_r1"][s, r], st["my_r2"][s, r]) == (
                node.phase, node.stage, node.my_r1, node.my_r2), f"{ctx} shard {s} replica {r}"


@pytest.mark.parametrize(
    "R,p,seed",
    [(3, 1.0, 0), (3, 0.6, 1), (5, 0.6, 2), (5, 0.35, 3), (4, 0.5, 4), (7, 0.6, 5)],
)
def test_plain_round_and_header_conform_to_the_port_oracle(host, R, p, seed):
    """The port of the reference's TestOracleConformance: the port's plain
    round_step and the header's round, step by step, against the port's
    oracle on the same lossy trace."""
    S, T, slot = 4, 30, 0
    rng = np.random.default_rng(seed)
    initial = rng.integers(0, 2, size=(S, R)).astype(np.int8)
    alive = np.ones((S, R), bool)
    if seed % 2:
        alive[:, 0] = False
    k = ClusterKernel(S, R, seed=seed, device="cpu")
    st = k.start_slot(k.init_state(), torch.ones(S, dtype=torch.bool), torch.from_numpy(initial))
    hs = convert.cluster_state_to_numpy(st)
    oracles = [oracle.WeakMVCOracle(R, list(initial[s]),
                                    lambda ph, s=s: device_coin(seed, s, slot, ph),
                                    alive=list(alive[s])) for s in range(S)]
    masks = rng.random((T, S, R, R)) < p
    for t in range(T):
        st = k.round_step(st, torch.from_numpy(alive), torch.from_numpy(masks[t]))
        hs = host.rounds(hs, alive, masks[t], 1, seed, 0.5, wide=False)
        for s in range(S):
            oracles[s].step(lambda i, j, m=masks[t, s]: bool(m[i, j]))
        _compare_to_oracles(convert.cluster_state_to_numpy(st), oracles, alive, f"plain step {t}")
        _compare_to_oracles(hs, oracles, alive, f"header step {t}")


# ---- a block of a mesh's shard axis: the coin keyed by global shards --------

_SHARD0_SHIM = r"""
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
// n rounds of a block of S shards whose first is global shard shard0:
// path 0 rounds_shard (32-bit), 1 rounds_shard (64-bit), 2 rounds_shard_lanes
extern "C" void cr_block_rounds(int path, void* const* in, void* const* out, const uint8_t* alive,
                                const uint8_t* masks, long long stride, int n, long long S, int R,
                                int q, int f1, unsigned seed, unsigned thr, unsigned shard0) {
    const cr::Ptrs pi = ptrs(in), po = ptrs(out);
    for (long long s = 0; s < S; ++s) {
        if (path == 0) cr::rounds_shard<uint32_t, 8>(pi, po, alive, masks, stride, n, s, R, q, f1, seed, thr, shard0);
        else if (path == 1) cr::rounds_shard<uint64_t, 64>(pi, po, alive, masks, stride, n, s, R, q, f1, seed, thr, shard0);
        else cr::rounds_shard_lanes(pi, po, alive, masks, stride, n, s, R, q, f1, seed, thr, shard0);
    }
}
// slot_pipeline of such a block: path 2 the rule once a (slot, shard), path
// 3 the rule on chunks of 16 shards (R = 5), as the kernel keys their coins
extern "C" void cr_block_pipeline(int path, const int8_t* votes, const uint8_t* alive,
                                  int8_t* dec, int32_t* ph, long long T, long long S, int R,
                                  int base, int rounds, int q, unsigned seed, unsigned thr,
                                  unsigned shard0) {
    for (long long t = 0; t < T; ++t) {
        if (path == 2) {
            for (long long s = 0; s < S; ++s) {
                const long long i = t * S + s;
                const uint32_t prefix = mw::coin_prefix(seed, shard0 + (uint32_t)s,
                                                        mw::slot_of(base, (int)t));
                const cr::Decision x = cr::full_delivery(votes + i * R, alive + s * R, R, q,
                                                         rounds, prefix, thr);
                dec[i] = x.decided;
                ph[i] = x.phase;
            }
            continue;
        }
        for (long long s0 = 0; s0 < S; s0 += 16) {
            const int n = (int)(S - s0 < 16 ? S - s0 : 16);
            const long long i = t * S + s0;
            cr::pipeline_chunk_bytes<5>(votes + i * R, alive + s0 * R, n, (uint32_t)q, rounds,
                                        seed, thr, shard0 + (uint32_t)s0,
                                        mw::slot_of(base, (int)t), dec + i, ph + i);
        }
    }
}
"""


@pytest.fixture(scope="module")
def host_blocks(tmp_path_factory):
    """The header's entries for a block of shards (shard0 > 0), built for
    the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("cr_blocks")
    (d / "shim.cpp").write_text(_SHARD0_SHIM)
    lib_path = d / "libcr_blocks.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib_path), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib_path))
    P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    lib.cr_block_rounds.argtypes = [I, P, P, P, P, LL, I, LL, I, I, I, U, U, U]
    lib.cr_block_pipeline.argtypes = [I, P, P, P, P, LL, LL, I, I, I, I, U, U, U]
    return lib


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("path", [0, 1, 2])
def test_header_block_rounds_key_the_coin_by_global_shard(host_blocks, path, blocks):
    """A reference state over S shards, run round by round under lossy
    masks with split votes and crashes (so replicas reach the coin), and
    the header run on each block of S / blocks shards with its global
    base shard0: every field of every block equals the reference's rows.
    Numbering the block's shards from 0 would flip coins."""
    S, R, T, seed, p1 = 16, 5, 30, 7 * blocks + path, 0.5
    initial, alive, active, masks = _case(seed, S, R, T, 0.6, True, False)
    initial[:, :] = np.random.default_rng(seed).integers(0, 2, size=(S, R))  # split: the coin
    active[:] = True
    ref = RefKernel(S, R, coin_p1=p1, seed=seed)
    rs = ref.start_slot(ref.init_state(), jnp.asarray(active), jnp.asarray(initial))
    rs = rs._replace(slot=jnp.full((S,), 2**31 - 2, jnp.int32))
    start = _ref_fields(rs)
    for t in range(T):
        rs = ref.round_step(rs, jnp.asarray(alive), jnp.asarray(masks[t]))
    want = _ref_fields(rs)
    assert (want["phase"] > 1).any()  # some replicas went past a coin
    Sb = S // blocks
    for i in range(blocks):
        rows = slice(i * Sb, (i + 1) * Sb)
        src = {f: np.ascontiguousarray(start[f][rows]) for f in FIELDS}
        out = {f: np.empty_like(v) for f, v in src.items()}
        m = np.ascontiguousarray(masks[:, rows], np.uint8)
        a = np.ascontiguousarray(alive[rows], np.uint8)
        host_blocks.cr_block_rounds(
            path, (ctypes.c_void_p * 13)(*(src[f].ctypes.data for f in FIELDS)),
            (ctypes.c_void_p * 13)(*(out[f].ctypes.data for f in FIELDS)), a.ctypes.data,
            m.ctypes.data, Sb * R * R, T, Sb, R, quorum_size(R), f_plus_1(R), seed,
            coin_threshold(p1), i * Sb)
        _assert_fields(out, {f: want[f][rows] for f in FIELDS}, f"block {i} path {path}")


@pytest.mark.parametrize("path", [2, 3])
@pytest.mark.parametrize("rounds", [2, 4])
def test_header_block_pipeline_keys_the_coin_by_global_shard(host_blocks, path, rounds):
    """slot_pipeline on each of 4 blocks of 32 shards (R = 5, split votes,
    a quorum-less shard, slots wrapping past 2^31-1) with its base
    shard0: the reference's columns of the whole window."""
    S, R, T, seed, p1 = 128, 5, 6, 31 + rounds, 0.5
    start = 2**31 - 3
    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 2, size=(T, S, R)).astype(np.int8)
    votes[:, ::5] = rng.integers(0, 4, size=votes[:, ::5].shape)
    alive = rng.random((S, R)) > 0.2
    alive[40, : quorum_size(R)] = False
    ref = RefKernel(S, R, coin_p1=p1, seed=seed)
    want_d, want_p = (np.asarray(x) for x in ref.slot_pipeline(
        jnp.asarray(votes), jnp.asarray(alive), T, rounds_per_slot=rounds, start_slot_index=start))
    if rounds == 4:
        assert (want_p == 1).any()  # the coin decided some slots
    Sb = S // 4
    for i in range(4):
        cols = slice(i * Sb, (i + 1) * Sb)
        v = np.ascontiguousarray(votes[:, cols])
        a = np.ascontiguousarray(alive[cols], np.uint8)
        d = np.empty((T, Sb), np.int8)
        ph = np.empty((T, Sb), np.int32)
        host_blocks.cr_block_pipeline(path, v.ctypes.data, a.ctypes.data, d.ctypes.data,
                                      ph.ctypes.data, T, Sb, R, start, rounds, quorum_size(R),
                                      seed, coin_threshold(p1), i * Sb)
        np.testing.assert_array_equal(d, want_d[:, cols], err_msg=f"block {i}")
        np.testing.assert_array_equal(ph, want_p[:, cols], err_msg=f"block {i}")
    # and the port's ClusterKernel on each block with shard_base
    for i in range(4):
        cols = slice(i * Sb, (i + 1) * Sb)
        k = ClusterKernel(Sb, R, coin_p1=p1, seed=seed, device="cpu", shard_base=i * Sb)
        d, ph = k.slot_pipeline(torch.from_numpy(np.ascontiguousarray(votes[:, cols])),
                                torch.from_numpy(np.ascontiguousarray(alive[cols])), T,
                                rounds_per_slot=rounds, start_slot_index=start)
        np.testing.assert_array_equal(d.numpy(), want_d[:, cols])
        np.testing.assert_array_equal(ph.numpy(), want_p[:, cols])


# ---- start_slot: the kernel's planes as flat bytes (cr::ss) ----------------


@pytest.fixture(scope="module")
def start_host(tmp_path_factory):
    return start_slot_host.build(tmp_path_factory, "ss_host")


@pytest.fixture(scope="module")
def start_host_cut(tmp_path_factory):
    """A build whose table entries hold at most 2048 bytes a plane: large
    blocks are cut into entries and the entries fill several launches."""
    return start_slot_host.build(tmp_path_factory, "ss_host_cut", max_plane=2048)


def _masks(rng, S: int) -> dict:
    return {"none": np.zeros(S, bool), "all": np.ones(S, bool), "random": rng.random(S) < 0.5}


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view that starts one element (one byte for a
    byte field) into a buffer: every plane then misses 16-byte
    alignment."""
    raw = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = raw[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("R", [1, 2, 5, 8, 9, 33])
@pytest.mark.parametrize("S", [1, 17, 4095, 4097])
def test_start_slot_vectors_match_reference(start_host, S, R):
    """The kernel's threads (16-byte vectors over each plane, the [S]
    fields 16 shards a thread, ragged ends element by element) against
    the reference's ``ClusterKernel.start_slot``, masks none, all and
    random, out of place, in place and on buffers one byte in."""
    from rabia_tpu.kernel.phase_driver import ClusterState as RefState

    rng = np.random.default_rng(100 * S + R)
    fields = start_slot_host.random_state_fields(rng, S, R)
    ref = RefKernel(S, R)
    for name, mask in _masks(rng, S).items():
        votes = rng.integers(0, 4, (S, R)).astype(np.int8)
        want = _ref_fields(ref.start_slot(RefState(**{f: jnp.asarray(v) for f, v in fields.items()}),
                                          jnp.asarray(mask), jnp.asarray(votes)))
        src = [torch.from_numpy(fields[f].copy()) for f in FIELDS]
        m, v = torch.from_numpy(mask), torch.from_numpy(votes)
        for mode in ("out", "in place", "one byte in"):
            ins = [t.clone() for t in src]
            if mode == "one byte in":
                ins, m, v = [_shifted(t) for t in ins], _shifted(m), _shifted(v)
            outs, n = start_host.run([(ins, m, v)], out=[ins] if mode == "in place" else None)
            assert n == 1
            _assert_fields({f: t.numpy() for f, t in zip(FIELDS, outs[0])}, want,
                           f"S={S} R={R} mask {name}, {mode}")


@pytest.mark.parametrize("R", [5, 33])
@pytest.mark.parametrize("nblk", [1, 20])
def test_start_slot_cut_blocks_and_launches_match_reference(start_host_cut, R, nblk):
    """Blocks whose planes pass an entry's byte limit are cut into
    entries of fewer shards, and more entries than a launch's table holds
    (16) take more launches: every block still equals the reference's."""
    from rabia_tpu.kernel.phase_driver import ClusterState as RefState

    S = 300
    ref = RefKernel(S, R)
    rng = np.random.default_rng(R + nblk)
    blocks, wants = [], []
    for _ in range(nblk):
        fields = start_slot_host.random_state_fields(rng, S, R)
        mask = rng.random(S) < 0.5
        votes = rng.integers(0, 4, (S, R)).astype(np.int8)
        wants.append(_ref_fields(ref.start_slot(
            RefState(**{f: jnp.asarray(v) for f, v in fields.items()}), jnp.asarray(mask),
            jnp.asarray(votes))))
        blocks.append(([torch.from_numpy(fields[f].copy()) for f in FIELDS],
                       torch.from_numpy(mask), torch.from_numpy(votes)))
    outs, n = start_host_cut.run(blocks)
    per_entry = max(1, 2048 // max(R * R, 4 * R))
    per_entry -= per_entry % 16 if per_entry >= 16 else 0
    entries = nblk * -(-S // per_entry)
    assert entries > nblk and n == -(-entries // 16)
    for b, (o, w) in enumerate(zip(outs, wants)):
        _assert_fields({f: t.numpy() for f, t in zip(FIELDS, o)}, w, f"R={R} block {b}")
