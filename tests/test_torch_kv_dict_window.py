"""The device KV table's write window on dictionary-form ops: the
per-shard math of ``csrc/kv_dict.cuh`` built with g++ and run shard by
shard on the CPU, held byte for byte against the port's plain version
(``kv_window_plain``, ``decide_window_plain``) and the reference's
``DeviceKVTable.decide_apply`` / ``mixed_apply`` in dictionary form, on
tables and windows made with numpy from a seed: W in {1, 16, 33, 64,
256}, D in {1, 2, 17, 32}, P in {7, 64}; dictionary rows that share a
key with different values, ranks past D (the empty op), the empty key in
the table, stale keys in free slots, full shards that overflow, a DEL
then a SET that reuses its slot, pad waves past ``depth`` and shard
versions at the wrap. Also the wrapper's routing (which kernel a window
goes to, and under which count) and, on a card only, the kernel against
the plain version. Tolerance: exact equality (every output is an integer
or bytes)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rabia_tpu_torch import convert
from rabia_tpu_torch.core.types import f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cuda_build, kv_window
from rabia_tpu_torch.kernel.phase_driver import coin_threshold
from rabia_tpu_torch.parallel.mesh import MeshPhaseKernel

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

N, R, K4, VW4 = 8, 3, 8, 16  # the reference's 8-device CPU mesh; 32 B keys, 64 B values
WS, DS, PS = (1, 16, 33, 64, 256), (1, 2, 17, 32), (7, 64)
TABLE = ("used", "keyw", "klen", "ver", "valw", "vlen", "sver")

_HOST_SHIM = r"""
#include <vector>
#include "kv_dict.cuh"
#include "mesh_window.cuh"
extern "C" void kvd_host(long long S, int W, int depth, int P, int K4, int VW4, int ku4, int vwu4,
                         int D, int kind_all, const uint8_t* used, const int32_t* keyw,
                         const int32_t* klen, const int32_t* ver, const int32_t* valw,
                         const int32_t* vlen, const int32_t* sver, uint8_t* o_used,
                         int32_t* o_keyw, int32_t* o_klen, int32_t* o_ver, int32_t* o_valw,
                         int32_t* o_vlen, int32_t* o_sver, const int8_t* kind, const uint8_t* idx,
                         const int16_t* dkl, const int16_t* dvl, const int32_t* dk,
                         const int32_t* dv, uint8_t* overflow, int32_t* rver, int32_t* rvlen,
                         int32_t* rval, const int32_t* gidx, int G) {
    std::vector<uint64_t> cand(D + 1);
    std::vector<uint16_t> cls(D + 1), scls(P), wrow(P);
    std::vector<int32_t> wver(P);
    std::vector<kvd::Rec> recs(W > 0 ? W : 1);
    const kvd::ReadOut rd{rver, rvlen, rval, gidx, G};
    for (long long s = 0; s < S; ++s)
        kvd::window_shard(s, W, depth, S, P, K4, VW4, ku4, vwu4, D, kind_all, used, keyw, klen,
                          ver, valw, vlen, sver, o_used, o_keyw, o_klen, o_ver, o_valw, o_vlen,
                          o_sver, kind, idx, dkl, dvl, dk, dv, overflow, rd, cand.data(),
                          cls.data(), scls.data(), wrow.data(), wver.data(), recs.data());
}
// The flags that the kernel folds into the launch: every wave below depth
// decided V1 (kvd::all_v1_at_once, else mw::decide_v1_wave wave by wave),
// any overflow, any shard version at the wrap.
extern "C" void kvd_host_flags(long long S, int depth, int R, const uint8_t* alive,
                               const int32_t* base, int quorum, int f1, unsigned seed,
                               unsigned threshold, int max_phases, const uint8_t* overflow,
                               const int32_t* sver, int32_t* flags) {
    int8_t v1_row[mw::MAX_REPLICAS];
    for (int r = 0; r < R; ++r) v1_row[r] = mw::V1;
    uint32_t bits = 0;
    for (long long s = 0; s < S; ++s) {
        int n_alive = 0;
        for (int r = 0; r < R; ++r) n_alive += alive[s * R + r] != 0;
        bool all_v1 = true;
        for (int t = 0; t < depth && !kvd::all_v1_at_once(n_alive, quorum, f1, max_phases); ++t)
            all_v1 = all_v1 && mw::decide_v1_wave(v1_row, alive + s * R, R, base[s], (uint32_t)s,
                                                  t, quorum, f1, seed, threshold,
                                                  max_phases) == mw::V1;
        bits |= kvw::shard_flags(all_v1, overflow[s] != 0, sver[s]);
    }
    kvw::window_flags(bits, flags);
}
// 1 where kvd::all_v1_at_once holds and some wave of the first W slots
// from base does not decide V1 (never, if the shortcut is right).
extern "C" int kvd_host_shortcut_wrong(int R, const uint8_t* alive, int32_t base, int W,
                                       int quorum, int f1, unsigned seed, unsigned threshold,
                                       int max_phases) {
    int8_t v1_row[mw::MAX_REPLICAS];
    int n_alive = 0;
    for (int r = 0; r < R; ++r) {
        v1_row[r] = mw::V1;
        n_alive += alive[r] != 0;
    }
    if (!kvd::all_v1_at_once(n_alive, quorum, f1, max_phases)) return 0;
    for (int t = 0; t < W; ++t)
        if (mw::decide_v1_wave(v1_row, alive, R, base, 0u, t, quorum, f1, seed, threshold,
                               max_phases) != mw::V1)
            return 1;
    return 0;
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``kvd::window_shard`` over every shard, and the folded flags,
    compiled for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("kvd_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libkvd_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{cuda_build.CSRC}", "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib))
    lib.kvd_host.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 25
                             + [ctypes.c_int])
    lib.kvd_host.restype = None
    lib.kvd_host_flags.argtypes = ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                   + [ctypes.c_uint] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3)
    lib.kvd_host_flags.restype = None
    lib.kvd_host_shortcut_wrong.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int32,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_int]
                                            + [ctypes.c_uint] * 2 + [ctypes.c_int])
    lib.kvd_host_shortcut_wrong.restype = ctypes.c_int
    return lib


def _i32(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def run_header(lib, arrays, kind, dops, depth: int, *, kind_all: int = kv_window.KIND_SET,
               reads: bool = True, gidx=None, fold=None):
    """The header's window on numpy arrays (the reference's dtypes).
    Returns (table arrays, overflow, reads or None, flags or None): reads
    are (meta, gval) with gidx, else every wave's (gidx 0..W-1) split as
    the plain version's (found, ver, vlen, val); ``fold`` = (alive, base,
    mesh kernel, max_phases) adds the flags."""
    used, keyw, klen, ver, valw, vlen, sver = (_i32(np.asarray(a)) for a in arrays)
    used = used.astype(np.uint8)
    idx, dkl, dvl, dk, dv = (None if a is None else _i32(a) for a in dops)
    S, P_, K4_ = keyw.shape
    VW4_ = valw.shape[2]
    Wn, D = idx.shape[0], dkl.shape[1]
    out = [np.zeros_like(a) for a in (used, keyw, klen, ver, valw, vlen, sver)]
    over = np.zeros(S, np.uint8)
    g = np.arange(Wn, dtype=np.int32) if gidx is None else np.ascontiguousarray(gidx, np.int32)
    G = len(g)
    rver, rvlen = np.zeros((G, S), np.int32), np.zeros((G, S), np.int32)
    rval = np.zeros((G, S, VW4_), np.int32)
    kind_h = None if kind is None else np.ascontiguousarray(kind, np.int8)
    ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
    lib.kvd_host(S, Wn, depth, P_, K4_, VW4_, dk.shape[2], 0 if dv is None else dv.shape[2], D,
                 kind_all, *map(ptr, (used, keyw, klen, ver, valw, vlen, sver, *out, kind_h, idx,
                                      dkl, dvl, dk, dv, over)),
                 *(ptr(x) if reads else None for x in (rver, rvlen, rval)), ptr(g), G)
    out[0] = out[0].astype(bool)
    rd = None
    if reads:
        rd = ((np.stack([rver, rvlen]), rval) if gidx is not None
              else ((rvlen & 1).astype(bool), rver, rvlen >> 1, rval))
    flags = None
    if fold is not None:
        alive, base, mk, max_phases = fold
        alive = np.ascontiguousarray(alive, np.uint8)
        base = np.ascontiguousarray(base, np.int32)
        flags = np.zeros(3, np.int32)
        lib.kvd_host_flags(S, depth, alive.shape[1], ptr(alive), ptr(base),
                           quorum_size(alive.shape[1]), f_plus_1(alive.shape[1]),
                           mk.seed & 0xFFFFFFFF, coin_threshold(mk.coin_p1), max_phases,
                           ptr(over), ptr(out[6]), ptr(flags))
    return out, over.astype(bool), rd, flags


# -- inputs ------------------------------------------------------------------------


def _key_bytes(rng, ku4: int, empty: bool = False) -> bytes:
    n = 0 if empty else int(rng.integers(1, 4 * ku4 + 1))
    return rng.integers(97, 123, n, dtype=np.uint8).tobytes()


def _words(b: bytes, n: int) -> np.ndarray:
    out = np.zeros(4 * n, np.uint8)
    out[: len(b)] = np.frombuffer(b, np.uint8)
    return out.view(np.uint32)


def dict_case(seed: int, P: int, Wn: int, D: int, *, S: int = N, ku4: int = K4, vwu4: int = VW4,
              kinds=(0, 1, 2, 3, 4)):
    """A table (the reference's seven arrays) and a dictionary window.
    Table: each shard's slots hold distinct keys of a pool of P + 8 (the
    rest miss); shards 0 and 1 are full (a fresh SET overflows); shard 2
    keeps a used slot's key in a free slot (stale); shard 5 holds the
    empty key; shard 3's version is at or just below the wrap flag.
    Window: row r takes an earlier row's key with another value about
    one time in three (rows that share a key), a pool key otherwise;
    about one rank in thirty is past D (the empty op), and so is shard
    S-1's in wave 0; kinds from ``kinds``; ``depth`` below W on even
    seeds (pad waves). Returns (arrays, kind i8[W, S], (idx, dkl, dvl,
    dk, dv), depth)."""
    rng = np.random.default_rng(seed)
    used = rng.random((S, P)) < 0.6
    used[:2] = True
    keyw = np.zeros((S, P, K4), np.uint32)
    klen = np.zeros((S, P), np.int32)
    valw = np.zeros((S, P, VW4), np.uint32)
    vlen = np.zeros((S, P), np.int32)
    sver = rng.integers(P + 1, 1000, S).astype(np.int32)
    sver[3 % S] = 2**31 - 1 - seed % 4  # at or near the wrap flag; past 2^31-1 it wraps
    ver = (sver[:, None] - 1 - np.arange(P)[None, :]).astype(np.int32)
    pools = []
    for s in range(S):
        pool = [_key_bytes(rng, ku4, empty=(s == 5 and j == 0)) for j in range(P + 8)]
        pools.append(pool)
        for p in range(P):
            keyw[s, p] = _words(pool[p], K4)
            klen[s, p] = len(pool[p])
            n = int(rng.integers(0, 4 * VW4 + 1))
            valw[s, p] = _words(rng.integers(0, 256, n, dtype=np.uint8).tobytes(), VW4)
            vlen[s, p] = n
    if S > 2 and P > 1:  # a stale copy of a used slot's key in a free slot
        used[2, 0], used[2, P - 1] = True, False
        keyw[2, P - 1], klen[2, P - 1] = keyw[2, 0], klen[2, 0]
    dkl = np.zeros((S, D), np.int16)
    dvl = np.zeros((S, D), np.int16)
    dk = np.zeros((S, D, ku4), np.uint32)
    dv = np.zeros((S, D, vwu4), np.uint32)
    for s in range(S):
        for r in range(D):
            if r and rng.random() < 0.35:
                q = int(rng.integers(0, r))
                dk[s, r], dkl[s, r] = dk[s, q], dkl[s, q]
            else:
                key = pools[s][int(rng.integers(0, P + 8))]
                dk[s, r], dkl[s, r] = _words(key, ku4), len(key)
            n = int(rng.integers(0, 4 * vwu4 + 1))
            dv[s, r] = _words(rng.integers(0, 256, n, dtype=np.uint8).tobytes(), vwu4)
            dvl[s, r] = n
    idx = rng.integers(0, D, (Wn, S))
    idx = np.where(rng.random((Wn, S)) < 0.03, rng.integers(D, 256, (Wn, S)), idx).astype(np.uint8)
    idx[0, S - 1] = 255  # at least one empty op
    kind = np.asarray(kinds, np.int8)[rng.integers(0, len(kinds), (Wn, S))]
    depth = Wn if seed % 2 else int(rng.integers(0, Wn + 1))
    arrays = [used, keyw, klen, ver, valw, vlen, sver]
    return arrays, kind, (idx, dkl, dvl, dk, dv), depth


def _gidx(kind: np.ndarray) -> np.ndarray:
    """mixed_apply's row index: the waves with a read, padded to a power of
    two with wave 0 (none: one row)."""
    waves = np.nonzero((kind >= 2).any(axis=1))[0]
    Gp = 1 << max(0, len(waves) - 1).bit_length()
    out = np.zeros(Gp, np.int32)
    out[: len(waves)] = waves
    return out


def _torch_dict(dops):
    idx, dkl, dvl, dk, dv = dops
    return (torch.from_numpy(_i32(dkl)), torch.from_numpy(_i32(dvl)), torch.from_numpy(_i32(dk)),
            torch.from_numpy(_i32(dv))), torch.from_numpy(np.ascontiguousarray(idx))


def _eq(got, want, what: str) -> None:
    np.testing.assert_array_equal(np.asarray(got), want.numpy() if isinstance(want, torch.Tensor)
                                  else _i32(np.asarray(want)), err_msg=what)


def _cases():
    return [(P, Wn, D) for P in PS for Wn in WS for D in DS]


# -- the header against the plain version -------------------------------------------


@pytest.mark.parametrize("P_, Wn, D", _cases())
def test_header_matches_plain(host, P_, Wn, D):
    """Every output of ``kvd::window_shard`` equals ``kv_window_plain``'s:
    a mixed window with its read planes, a SET window (no kind plane, no
    reads), and a mixed window with its reads gathered to the GET waves
    (``gidx``), as mixed_apply takes them."""
    arrays, kind, dops, depth = dict_case(P_ * 1000 + Wn * 10 + D, P_, Wn, D, ku4=4 if D == 2 else K4,
                                          vwu4=5 if D == 17 else VW4)
    table = convert.device_table_from_numpy(arrays, "cpu")
    planes, idx = _torch_dict(dops)
    tk = torch.from_numpy(kind)
    gidx = _gidx(kind)
    for name, k, kw, hkw in (
        ("mixed", tk, dict(want_reads=True), dict(kind=kind)),
        ("set", None, {}, dict(kind=None, reads=False)),
        ("gathered", tk, dict(want_reads=True, gidx=torch.from_numpy(gidx)),
         dict(kind=kind, gidx=gidx)),
    ):
        new, over, reads = kv_window.kv_window_plain(table, k, *planes, depth, idx=idx, **kw)
        got, h_over, h_reads, _ = run_header(host, arrays, hkw.pop("kind"), dops, depth, **hkw)
        for field, a, b in zip(TABLE, got, new):
            _eq(a, b, f"{name} {field}")
        _eq(h_over, over, f"{name} overflow")
        if reads is not None:
            for i, (a, b) in enumerate(zip(h_reads, reads)):
                _eq(a, b, f"{name} read plane {i}")


def test_header_reads_the_implied_get_kind(host):
    """Without a kind plane under KIND_GET, every op with a key is a read
    and the empty op reads nothing (``kvw::implied_kind`` per row)."""
    arrays, _, dops, _ = dict_case(5, 7, 33, 17)
    table = convert.device_table_from_numpy(arrays, "cpu")
    planes, idx = _torch_dict(dops)
    new, over, reads = kv_window.kv_window_plain(table, kv_window.KIND_GET, *planes, 33, idx=idx,
                                                 want_reads=True)
    got, h_over, h_reads, _ = run_header(host, arrays, None, dops, 33, kind_all=kv_window.KIND_GET)
    for field, a, b in zip(TABLE, got, new):
        _eq(a, b, field)
    for a, b in zip(h_reads, reads):
        _eq(a, b, "reads")
    assert bool(reads.found.any())


def test_v1_shortcut_matches_the_decision(host):
    """``kvd::all_v1_at_once`` (the kernel's shortcut for a shard whose live
    replicas decide V1 in phase 0) never claims V1 where
    ``mw::decide_v1_wave`` decides otherwise: every alive mask for R =
    1..8, every max_phases in 0..4, coins of probability 0, 0.5 and 1, 64
    slots from a base near the wrap."""
    for R_ in range(1, 9):
        for mask in range(1 << R_):
            alive = np.array([(mask >> r) & 1 for r in range(R_)], np.uint8)
            for max_phases in range(5):
                for p1 in (0.0, 0.5, 1.0):
                    assert host.kvd_host_shortcut_wrong(
                        R_, alive.ctypes.data, 2**31 - 40, 64, quorum_size(R_), f_plus_1(R_),
                        7, coin_threshold(p1), max_phases) == 0


# -- the header against the reference --------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """One reference table per P (its programs are cached per signature),
    imported here so that the card's tests collect without JAX."""
    from rabia_tpu.apps.device_kv import DeviceDictOps, DeviceKVTable
    from rabia_tpu.parallel.mesh import MeshPhaseKernel as RefMeshPhaseKernel
    from rabia_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    tables = {P_: DeviceKVTable(N, RefMeshPhaseKernel(N, R, mesh), per_shard_capacity=P_)
              for P_ in PS}
    return tables, DeviceDictOps


def _ref_run(ref, arrays, P_, program, *args, W):
    import jax.numpy as jnp

    tables, _ = ref
    t = tables[P_]
    t.state = tuple(jnp.asarray(a) for a in arrays)
    return [np.asarray(x) if not isinstance(x, tuple) else [np.asarray(y) for y in x]
            for x in getattr(t, program)(*args, W=W)]


@pytest.mark.parametrize("P_, Wn, D", _cases())
def test_header_matches_reference(host, ref, P_, Wn, D):
    """The reference's dictionary-form ``decide_apply`` and ``mixed_apply``
    (its XLA programs ``_build_fused_dict`` and the ``D`` branch of
    ``_build_mixed``) and the header give the same table, flags, meta and
    gval; so does the port's ``DeviceKVTable`` on the CPU."""
    from rabia_tpu_torch.apps.device_kv import DeviceDictOps, DeviceKVTable

    seed = P_ * 1000 + Wn * 10 + D + 1
    arrays, kind, dops, depth = dict_case(seed, P_, Wn, D)
    # the reference's packers never emit a rank past D; its one-hot reads
    # such a rank as the empty op, which the SET program also applies
    rops = ref[1](*dops)
    rng = np.random.default_rng(seed)
    alive = np.ones((N, R), bool)
    if seed % 3 == 0:
        alive[6, 1:] = False  # shard 6 has no quorum: the window is not all V1
    base = rng.integers(0, 2**31 - 1, N).astype(np.int32)
    mk = MeshPhaseKernel(N, R, device="cpu")
    port = DeviceKVTable(N, mk, per_shard_capacity=P_)
    # the SET window
    want = _ref_run(ref, arrays, P_, "decide_apply", alive, base, depth, rops, W=Wn)
    got, _, _, flags = run_header(host, arrays, None, dops, depth, reads=False,
                                  fold=(alive, base, mk, 4))
    for field, a, b in zip(TABLE, got, want[0]):
        _eq(a, b, f"decide_apply {field}")
    _eq(flags, want[1], "decide_apply flags")
    port.state = convert.device_table_from_numpy(arrays, "cpu")
    pnew, pflags = port.decide_apply(alive, base, depth, DeviceDictOps(*dops), W=Wn)
    for field, a, b in zip(TABLE, convert.device_table_to_numpy(pnew).values(), want[0]):
        _eq(a, b, f"port decide_apply {field}")
    _eq(pflags.numpy(), want[1], "port decide_apply flags")
    # the mixed window, its reads gathered to the GET waves
    get_waves = np.nonzero((kind >= 2).any(axis=1))[0].astype(np.int32)
    want = _ref_run(ref, arrays, P_, "mixed_apply", alive, base, depth, kind, get_waves, rops,
                    W=Wn)
    got, _, (meta, gval), flags = run_header(host, arrays, kind, dops, depth, gidx=_gidx(kind),
                                             fold=(alive, base, mk, 4))
    for field, a, b in zip(TABLE, got, want[0]):
        _eq(a, b, f"mixed_apply {field}")
    _eq(flags, want[1], "mixed_apply flags")
    _eq(meta, want[2], "mixed_apply meta")
    _eq(gval, want[3], "mixed_apply gval")
    pnew, pflags, pmeta, pgval = port.mixed_apply(alive, base, depth, kind, get_waves,
                                                  DeviceDictOps(*dops), W=Wn)
    for field, a, b in zip(TABLE, convert.device_table_to_numpy(pnew).values(), want[0]):
        _eq(a, b, f"port mixed_apply {field}")
    for what, a, b in (("flags", pflags, want[1]), ("meta", pmeta, want[2]),
                       ("gval", pgval, want[3])):
        _eq(a.numpy(), b, f"port mixed_apply {what}")


def _scripted():
    """Shard s: slot 0 holds key A, slot 1 key B (free), the rest free.
    Rows: 0 = (A, ""), 1 = (C, "c"), 2 = (A, "x"), 3 = (C, "y"). Waves:
    DEL A (frees slot 0), SET C (a fresh key: takes slot 0 again), SET A
    with "x" (fresh again: slot 1, whose stale key was B), GET A, SET C
    with "y" (updates slot 0), GET C, DEL C, EXISTS C."""
    P_, D, Wn = 7, 4, 8
    arrays, _, _, _ = dict_case(11, P_, Wn, D)
    used, keyw, klen = arrays[0], arrays[1], arrays[2]
    used[:] = False
    used[:, 0] = True
    A, B, C = b"key-a", b"key-b", b"key-c"
    for s in range(N):
        keyw[s, 0], klen[s, 0] = _words(A, K4), len(A)
        keyw[s, 1], klen[s, 1] = _words(B, K4), len(B)
    dkl = np.tile(np.array([len(A), len(C), len(A), len(C)], np.int16), (N, 1))
    dvl = np.tile(np.array([0, 1, 1, 1], np.int16), (N, 1))
    dk = np.stack([_words(k, K4) for k in (A, C, A, C)])[None].repeat(N, 0)
    dv = np.stack([_words(v, VW4) for v in (b"", b"c", b"x", b"y")])[None].repeat(N, 0)
    idx = np.array([0, 1, 2, 0, 3, 1, 1, 1], np.uint8)[:, None].repeat(N, 1)
    kind = np.array([3, 1, 1, 2, 1, 2, 3, 4], np.int8)[:, None].repeat(N, 1)
    return arrays, kind, (idx, dkl, dvl, dk, dv), Wn


def test_del_then_set_reuses_the_slot(host, ref):
    """A DEL frees a slot, a SET of a fresh key takes it back, a row that
    shares a key with another (different value) lands in a slot whose
    stale key was another's; the reads see each wave's entry state. The
    header, the plain version and the reference agree."""
    arrays, kind, dops, Wn = _scripted()
    gidx = _gidx(kind)
    got, over, (meta, gval), _ = run_header(host, arrays, kind, dops, Wn, gidx=gidx)
    planes, idx = _torch_dict(dops)
    new, p_over, preads = kv_window.kv_window_plain(
        convert.device_table_from_numpy(arrays, "cpu"), torch.from_numpy(kind), *planes, Wn,
        idx=idx, want_reads=True, gidx=torch.from_numpy(gidx))
    for field, a, b in zip(TABLE, got, new):
        _eq(a, b, field)
    _eq(meta, preads.meta, "meta")
    _eq(gval, preads.val, "gval")
    rops = ref[1](*dops)
    alive, base = np.ones((N, R), bool), np.zeros(N, np.int32)
    get_waves = np.nonzero((kind >= 2).any(axis=1))[0].astype(np.int32)
    want = _ref_run(ref, arrays, 7, "mixed_apply", alive, base, Wn, kind, get_waves, rops, W=Wn)
    for field, a, b in zip(TABLE, got, want[0]):
        _eq(a, b, f"reference {field}")
    _eq(meta, want[2], "reference meta")
    used, keyw = got[0], got[1]
    assert used[:, 1].all() and not used[:, [0, *range(2, 7)]].any()  # C was deleted last
    np.testing.assert_array_equal(keyw[:, 0], np.broadcast_to(_words(b"key-c", K4), (N, K4)))
    np.testing.assert_array_equal(keyw[:, 1], np.broadcast_to(_words(b"key-a", K4), (N, K4)))
    # GET A (wave 3) found "x"; GET C (wave 5) found "y"; EXISTS C after DEL C: not found
    rows = {int(t): j for j, t in enumerate(gidx[: len(get_waves)])}
    assert (meta[1, rows[3]] == (1 << 1) | 1).all() and (meta[1, rows[5]] & 1).all()
    assert not (meta[1, rows[7]] & 1).any()
    assert not over.any()


# -- the wrapper's routing -------------------------------------------------------------


def _stand_ins() -> kv_window.KVWindowKernel:
    k = kv_window.KVWindowKernel()
    (k._fn, k._decide_fn, k._dict_fn, k._dict_decide_fn, k._read_fn,
     k._read_decide_fn) = ("kvw", "kvw decide", "kvd", "kvd decide", "kvr", "kvr decide")
    return k


@pytest.mark.parametrize("P_, D, form, entry", [
    (7, 1, "dict", "kvd"), (64, 32, "dict", "kvd"), (65, 2, "dict wide", "kvw"),
    (130, 17, "dict wide", "kvw"), (64, 33, "dict wide", "kvw"),
])
def test_dict_windows_route_by_table_width(P_, D, form, entry):
    """A dictionary window that writes a table of at most 64 slots, with
    at most 32 rows a shard (the packers' max_dict), goes to kv_dict.cu
    and counts under ``dict`` / ``dict+decide``; a wider table or a larger
    dictionary to kv_window.cu under ``dict wide``; rows to kv_window.cu,
    reads to kv_read.cu, whatever the width."""
    k = _stand_ins()
    idx = torch.zeros((2, 3), dtype=torch.uint8)
    assert k._route(idx, P_, D, True, False) == (entry, form)
    assert k._route(idx, P_, D, True, True) == (f"{entry} decide", f"{form}+decide")
    assert k._route(None, P_, 0, True, False) == ("kvw", "rows")
    assert k._route(None, P_, 0, True, True) == ("kvw decide", "rows+decide")
    assert k._route(idx, P_, D, False, False) == ("kvr", "probe dict")
    assert k._route(idx, P_, D, False, True) == ("kvr decide", "lookup dict")
    assert set(k.counts) == set(kv_window.KVWindowKernel.FORMS)


@pytest.mark.parametrize("P_", [7, 130])
def test_cpu_tensor_never_reaches_a_kernel(P_):
    """CPU tensors: the kernel's wrapper refuses them and counts nothing;
    ``window`` and ``decide_window`` take the plain version."""
    arrays, kind, dops, depth = dict_case(3, P_, 4, 2)
    table = convert.device_table_from_numpy(arrays, "cpu")
    planes, idx = _torch_dict(dops)
    tk = torch.from_numpy(kind)
    alive, base = torch.ones((N, R), dtype=torch.bool), torch.zeros(N, dtype=torch.int32)
    before = dict(kv_window.KV_WINDOW.counts), kv_window.KV_WINDOW.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kv_window.KV_WINDOW(table, tk, *planes, depth, idx=idx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kv_window.KV_WINDOW.decide(table, None, *planes, depth, alive, base, seed=0, coin_p1=0.5,
                                   max_phases=4, idx=idx)
    new, _, reads = kv_window.window(table, tk, *planes, depth, idx=idx, want_reads=True,
                                     gidx=torch.zeros(2, dtype=torch.int32))
    assert reads.meta.shape == (2, 2, N) and reads.val.shape == (2, N, VW4)
    mk = MeshPhaseKernel(N, R, device="cpu")
    out = kv_window.decide_window(mk, table, None, *planes, depth, alive, base, 4, idx=idx)
    assert out[3].shape == (3,)
    assert (dict(kv_window.KV_WINDOW.counts), kv_window.KV_WINDOW.launches) == before


def test_gathered_reads_need_a_table_and_reads():
    arrays, kind, dops, depth = dict_case(4, 7, 4, 2)
    table = convert.device_table_from_numpy(arrays, "cpu")
    planes, idx = _torch_dict(dops)
    g = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="gidx"):
        kv_window.KV_WINDOW(table, torch.from_numpy(kind), *planes, depth, idx=idx, gidx=g)
    with pytest.raises(ValueError, match="gidx must be int32"):
        kv_window.KV_WINDOW(table, torch.from_numpy(kind), *planes, depth, idx=idx,
                            want_reads=True, gidx=g.long())


# -- on a card ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P_, Wn, D", _cases())
def test_kernel_matches_plain_on_card(cuda, P_, Wn, D):
    """kv_dict.cu against the plain version on this file's cases: the
    mixed window with its read planes, the SET window with its decision,
    and the mixed window with its reads gathered and its decision; every
    output and the untouched input table."""
    arrays, kind, dops, depth = dict_case(P_ * 1000 + Wn * 10 + D, P_, Wn, D)
    table = convert.device_table_from_numpy(arrays, cuda)
    before = [x.clone() for x in table]
    planes, idx = _torch_dict(dops)
    planes, idx = tuple(x.to(cuda) for x in planes), idx.to(cuda)
    tk = torch.from_numpy(kind).to(cuda)
    gidx = torch.from_numpy(_gidx(kind)).to(cuda)
    alive = torch.ones((N, R), dtype=torch.bool, device=cuda)
    base = torch.zeros(N, dtype=torch.int32, device=cuda)
    mk = MeshPhaseKernel(N, R, device=cuda)
    dk = dict(seed=mk.seed, coin_p1=mk.coin_p1, max_phases=4)
    counts = dict(kv_window.KV_WINDOW.counts)
    pairs = [
        (kv_window.KV_WINDOW(table, tk, *planes, depth, idx=idx, want_reads=True),
         kv_window.kv_window_plain(table, tk, *planes, depth, idx=idx, want_reads=True)),
        (kv_window.KV_WINDOW.decide(table, None, *planes, depth, alive, base, idx=idx, **dk),
         kv_window.decide_window_plain(mk, table, None, *planes, depth, alive, base, 4, idx=idx)),
        (kv_window.KV_WINDOW.decide(table, tk, *planes, depth, alive, base, idx=idx,
                                    want_reads=True, gidx=gidx, **dk),
         kv_window.decide_window_plain(mk, table, tk, *planes, depth, alive, base, 4, idx=idx,
                                       want_reads=True, gidx=gidx)),
    ]
    torch.cuda.synchronize()
    flat = lambda xs: [y for x in xs if x is not None  # noqa: E731
                       for y in (x if isinstance(x, tuple) else (x,))]
    for got, want in pairs:
        for a, b in zip(flat(got), flat(want), strict=True):
            assert torch.equal(a, b)
    for a, b in zip(before, table):
        assert torch.equal(a, b)
    assert kv_window.KV_WINDOW.counts["dict"] == counts["dict"] + 1
    assert kv_window.KV_WINDOW.counts["dict+decide"] == counts["dict+decide"] + 2


@pytest.mark.cuda
def test_dict_windows_on_card_match_plain_and_route(cuda):
    """``chip_smoke.dict_kernel_vs_plain``: both dictionary kernels
    (kv_dict.cu, and kv_window.cu's wide path) against plain at W in {1,
    16, 40, 64, 256}, each launch counted under its form."""
    import chip_smoke

    kv_window.KV_WINDOW.reset_counts()
    assert chip_smoke.dict_kernel_vs_plain(cuda) == 0
    c = kv_window.KV_WINDOW.counts
    assert c["dict"] > 0 and c["dict+decide"] > 0
    assert c["dict wide"] > 0 and c["dict wide+decide"] > 0
