"""The port's device KV table against the reference ``DeviceKVTable``.

The same table (loaded into both through ``convert.device_table_from_numpy``
and ``jnp.asarray``) and the same blocks go through the reference's XLA
programs and the port's row programs on the CPU: the window packers byte
for byte (with their envelope rejections), ``decide_apply``,
``lookup_window`` and ``mixed_apply`` field by field (overflow, the
version-wrap flag, a crashed quorum, DEL of a missing key, a GET after a
DEL in the same window), and ``dump`` / ``upload_from`` / ``sync_into``.
The kernel's per-op header (``csrc/kv_window.cuh``), built with g++, runs
the same cases; with the mesh window's header it also runs the decision
that the kernel folds into the same launch, held against the reference's
flags (quorum-less and all-dead shards, depth 0, max_phases 0, windows
longer than 32 waves, bases near 2^31-1). n_shards = 8 fills the reference's 8-device CPU mesh, so
neither side pads. Tolerance: exact equality (every output is an integer
or bytes)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rabia_tpu.apps import vector_kv as ref_vkv
from rabia_tpu.apps.device_kv import DeviceKVTable as RefTable
from rabia_tpu.core.blocks import build_block as ref_build_block
from rabia_tpu.parallel.mesh import MeshPhaseKernel as RefMeshPhaseKernel
from rabia_tpu.parallel.mesh import make_mesh
from rabia_tpu_torch import convert
from rabia_tpu_torch.apps import vector_kv
from rabia_tpu_torch.apps.device_kv import DeviceKVTable
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.core.types import f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cuda_build, kv_window, mesh_window
from rabia_tpu_torch.kernel.phase_driver import coin_threshold
from rabia_tpu_torch.parallel.mesh import MeshPhaseKernel

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

N, R, W, P = 8, 3, 4, 6
KEYS = [b"a", b"bb", b"key3", b"k-4", b"long-key-number-5", b"x" * 31, b"y" * 32, b"key7"]


def _op(code: int, key: bytes, val: bytes = b"") -> bytes:
    return bytes((code,)) + len(key).to_bytes(2, "little") + key + val


@pytest.fixture(scope="module")
def ref_table():
    """One reference table for the module: its compiled programs are
    cached per (W, widths) signature and reused across the cases."""
    return RefTable(N, RefMeshPhaseKernel(N, R, make_mesh()), per_shard_capacity=P)


@pytest.fixture
def port_table():
    return DeviceKVTable(N, MeshPhaseKernel(N, R, device="cpu"), per_shard_capacity=P)


def _random_table(rng, *, full_shards=(), wrap_shards=()) -> list[np.ndarray]:
    """Seven table arrays in the reference's dtypes: keys unique per shard
    (drawn from KEYS), stale words in free slots, values of 0..64 bytes
    (some not UTF-8), versions below the shard counter."""
    K, VW = 32, 64
    used = rng.random((N, P)) < 0.5
    used[list(full_shards)] = True
    keyb = np.zeros((N, P, K), np.uint8)
    klen = np.zeros((N, P), np.int32)
    valb = np.zeros((N, P, VW), np.uint8)
    vlen = np.zeros((N, P), np.int32)
    ver = np.zeros((N, P), np.int32)
    sver = rng.integers(P + 1, 1000, N).astype(np.int32)
    sver[list(wrap_shards)] = 2**31 - 2 - W  # W SETs reach the wrap test
    for s in range(N):
        for p, j in enumerate(rng.permutation(len(KEYS))[:P]):
            keyb[s, p, : len(KEYS[j])] = np.frombuffer(KEYS[j], np.uint8)
            klen[s, p] = len(KEYS[j])
            n = int(rng.integers(0, VW + 1))
            valb[s, p, :n] = rng.integers(0, 256, n) if rng.random() < 0.2 else ord("v")
            vlen[s, p] = n
            ver[s, p] = int(sver[s]) - 1 - p
    return [used, keyb.view(np.uint32), klen, ver, valb.view(np.uint32), vlen, sver]


def _load(port_table, ref_table, arrays):
    port_table.state = convert.device_table_from_numpy(arrays, "cpu")
    ref_table.state = tuple(jnp.asarray(a) for a in arrays)


def _blocks(rng, waves: int, kinds=(1, 2, 3, 4)) -> list[tuple[list, list]]:
    """Full-width blocks, one op per shard, keys from KEYS plus misses."""
    out = []
    for w in range(waves):
        cmds = []
        for s in range(N):
            key = KEYS[int(rng.integers(0, len(KEYS)))] if rng.random() < 0.8 else b"miss%d" % s
            k = kinds[int(rng.integers(0, len(kinds)))]
            cmds.append([_op(1, key, b"w%d.%d" % (w, s) * int(rng.integers(0, 9))) if k == 1
                         else _op(k, key)])
        out.append((list(range(N)), cmds))
    return out


def _both(stream):
    return ([build_block(s, c) for s, c in stream], [ref_build_block(s, c) for s, c in stream])


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_state(port_state, ref_state):
    got = convert.device_table_to_numpy(port_state)
    for name, ref_arr in zip(got, ref_state):
        np.testing.assert_array_equal(got[name], _np(ref_arr), err_msg=name)


# -- the header, built for the host -------------------------------------------

_HOST_SHIM = r"""
#include "kv_window.cuh"
extern "C" void kvw_host(long long S, int W, int depth, int P, int K4, int VW4, int ku4, int vwu4,
                         uint8_t* used, int32_t* keyw, int32_t* klen, int32_t* ver,
                         int32_t* valw, int32_t* vlen, int32_t* sver,
                         const int8_t* kind, const int16_t* op_klen, const int16_t* op_vlen,
                         const int32_t* op_kw, const int32_t* op_vw, uint8_t* overflow,
                         uint8_t* r_found, int32_t* r_ver, int32_t* r_vlen, int32_t* r_val) {
    int32_t scratch[64];
    for (long long s = 0; s < S; ++s)
        kvw::scan_shard(s, W, depth, S, P, K4, VW4, ku4, vwu4, used, keyw, klen, ver, valw,
                        vlen, sver, kind, op_klen, op_vlen, op_kw, op_vw, overflow, r_found,
                        r_ver, r_vlen, r_val, scratch);
}
"""


@pytest.fixture(scope="module")
def host_scan(tmp_path_factory):
    """The kernel's per-op header compiled for the host with g++: the same
    wave scan, in place on numpy copies. Returns (new arrays, overflow,
    reads)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("kvw_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libkvw_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    fn = ctypes.CDLL(str(lib)).kvw_host
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 17
    fn.restype = None

    def run(arrays, kind, klen, vlen, kwin, vwin, depth):
        used, keyw, kl, ver, valw, vl, sver = (np.array(_np(a), copy=True) for a in arrays)
        used = used.astype(np.uint8)
        S, P_, K4 = keyw.shape
        VW4 = valw.shape[2]
        Wn = kind.shape[0]
        kind, klen, vlen = (np.ascontiguousarray(x) for x in (kind, klen, vlen))
        kwin, vwin = np.ascontiguousarray(_np(kwin)), np.ascontiguousarray(_np(vwin))
        over = np.zeros(S, np.uint8)
        found = np.zeros((Wn, S), np.uint8)
        rver, rvlen = np.zeros((Wn, S), np.int32), np.zeros((Wn, S), np.int32)
        rval = np.zeros((Wn, S, VW4), np.int32)
        ptr = lambda a: a.ctypes.data  # noqa: E731
        fn(S, Wn, depth, P_, K4, VW4, kwin.shape[2], vwin.shape[2],
           *map(ptr, (used, keyw, kl, ver, valw, vl, sver, kind, klen, vlen, kwin, vwin,
                      over, found, rver, rvlen, rval)))
        return [used.astype(bool), keyw, kl, ver, valw, vl, sver], over.astype(bool), (
            found.astype(bool), rver, rvlen, rval)

    return run


_FOLD_SHIM = r"""
#include "kv_window.cuh"
#include "mesh_window.cuh"
extern "C" void fold_host(long long S, int W, int depth, int P, int K4, int VW4, int ku4, int vwu4,
                          uint8_t* used, int32_t* keyw, int32_t* klen, int32_t* ver,
                          int32_t* valw, int32_t* vlen, int32_t* sver,
                          const int8_t* kind, const int16_t* op_klen, const int16_t* op_vlen,
                          const int32_t* op_kw, const int32_t* op_vw, uint8_t* overflow,
                          const uint8_t* alive, const int32_t* base, int R, int quorum, int f1,
                          unsigned seed, unsigned threshold, int max_phases, int32_t* flags) {
    int32_t scratch[64];
    int8_t v1_row[mw::MAX_REPLICAS];
    for (int r = 0; r < R; ++r) v1_row[r] = mw::V1;
    uint32_t bits = 0;
    for (long long s = 0; s < S; ++s) {
        kvw::scan_shard(s, W, depth, S, P, K4, VW4, ku4, vwu4, used, keyw, klen, ver, valw,
                        vlen, sver, kind, op_klen, op_vlen, op_kw, op_vw, overflow, nullptr,
                        nullptr, nullptr, nullptr, scratch);
        bool all_v1 = true;
        for (int t = 0; t < depth; ++t)
            all_v1 = all_v1 && mw::decide_v1_wave(v1_row, alive + s * R, R, base[s], (uint32_t)s,
                                                  t, quorum, f1, seed, threshold,
                                                  max_phases) == mw::V1;
        bits |= kvw::shard_flags(all_v1, overflow[s] != 0, sver[s]);
    }
    kvw::window_flags(bits, flags);
}
"""


@pytest.fixture(scope="module")
def host_fold(tmp_path_factory):
    """The per-shard decide-and-reduce that the kernel folds into its
    launch (``mw::decide_v1_wave`` and the flag bits of kv_window.cuh),
    with the wave scan, compiled for the host with g++. Returns ``(new
    arrays, flags i32[3])`` of one SET window."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("fold_host")
    (d / "shim.cpp").write_text(_FOLD_SHIM)
    lib = d / "libfold_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    fn = ctypes.CDLL(str(lib)).fold_host
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = None

    def run(arrays, ops, Wn, depth, alive, base, max_phases, seed=0, p1=0.5):
        used, keyw, kl, ver, valw, vl, sver = (np.array(_np(a), copy=True) for a in arrays)
        used = used.astype(np.uint8)
        S, P_, K4 = keyw.shape
        VW4 = valw.shape[2]
        kind = np.full((Wn, S), kv_window.KIND_SET, np.int8)
        klen, vlen = _pad(ops.klen, Wn), _pad(ops.vlen, Wn)
        kwin = np.ascontiguousarray(_np(_pad(ops.kwin, Wn)))
        vwin = np.ascontiguousarray(_np(_pad(ops.vwin, Wn)))
        alive = np.ascontiguousarray(alive, np.uint8)
        base = np.ascontiguousarray(base, np.int32)
        R_ = alive.shape[1]
        over = np.zeros(S, np.uint8)
        flags = np.zeros(3, np.int32)
        ptr = lambda a: a.ctypes.data  # noqa: E731
        fn(S, Wn, depth, P_, K4, VW4, kwin.shape[2], vwin.shape[2],
           *map(ptr, (used, keyw, kl, ver, valw, vl, sver, kind, klen, vlen, kwin, vwin, over,
                      alive, base)),
           R_, quorum_size(R_), f_plus_1(R_), seed & 0xFFFFFFFF, coin_threshold(p1), max_phases,
           ptr(flags))
        return [used.astype(bool), keyw, kl, ver, valw, vl, sver], flags

    return run


def _dump_rows(d: dict) -> list:
    """``(shard, key, value, version)`` per entry of a port ``dump()``:
    the reference dump's row form."""
    return [
        (int(s), d["key"][i, : int(d["key_len"][i])].tobytes(),
         d["value"][i, : int(d["value_len"][i])].tobytes(), int(d["version"][i]))
        for i, s in enumerate(d["shard"])
    ]


def _pad(a, Wn):
    return np.concatenate([a, np.zeros((Wn - a.shape[0],) + a.shape[1:], a.dtype)])


# -- packers --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_row_packers_byte_equal(port_table, ref_table, seed, monkeypatch):
    monkeypatch.setenv("RABIA_PY_DEVPACK", "1")  # the reference's numpy gather
    rng = np.random.default_rng(seed)
    pb, rb = _both(_blocks(rng, W, kinds=(1,)))
    for a, b in zip(port_table.pack_window(pb), ref_table.pack_window(rb)):
        np.testing.assert_array_equal(a, b)
    pb, rb = _both(_blocks(rng, W))
    (pk, pops), (rk, rops) = port_table.pack_mixed_window(pb), ref_table.pack_mixed_window(rb)
    np.testing.assert_array_equal(pk, rk)
    for a, b in zip(pops, rops):
        np.testing.assert_array_equal(a, b)
    pb, rb = _both(_blocks(rng, W, kinds=(2,)))
    g = ref_table._gather_window(rb, "get")
    klen, kwin = port_table.pack_get_window(pb)
    np.testing.assert_array_equal(klen, g[1])
    np.testing.assert_array_equal(kwin, np.ascontiguousarray(g[3]).view(np.uint32))
    # a partial-width block lands in its own columns
    part = [([1, 4, 6], [[_op(1, b"k", b"v")], [_op(1, b"kk", b"")], [_op(1, b"a" * 9, b"z" * 20)]])]
    pb, rb = _both(part)
    for a, b in zip(port_table.pack_window(pb), ref_table.pack_window(rb)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["get_in_set", "two_ops", "long_key", "wide_value",
                                  "get_value", "empty_key", "unknown_op", "del_in_set"])
def test_packers_reject_outside_the_envelope(port_table, ref_table, case, monkeypatch):
    monkeypatch.setenv("RABIA_PY_DEVPACK", "1")
    good = [_op(1, b"k%d" % s, b"v") for s in range(N)]
    bad = {
        "get_in_set": _op(2, b"k"), "two_ops": None, "long_key": _op(1, b"K" * 33, b"v"),
        "wide_value": _op(1, b"k", b"v" * 65), "get_value": _op(2, b"k", b"v"),
        "empty_key": _op(1, b"", b"v"), "unknown_op": _op(5, b"k"), "del_in_set": _op(3, b"k"),
    }[case]
    cmds = [[c] for c in good]
    if bad is None:
        cmds[3] = [good[3], good[3]]
    else:
        cmds[3] = [bad]
    pb, rb = _both([(list(range(N)), cmds)])
    for allow in ("set", "mixed"):
        want = ref_table._gather_window(rb, allow) is None
        assert (port_table._gather_window(pb, allow) is None) == want, allow
    assert (port_table.pack_window(pb) is None) == (ref_table.pack_window(rb) is None)
    assert (port_table.pack_mixed_window(pb) is None) == (ref_table.pack_mixed_window(rb) is None)


# -- the three programs ---------------------------------------------------------


def _alive(crash: bool) -> np.ndarray:
    a = np.ones((N, R), bool)
    if crash:
        a[:, 1:] = False  # one of three: no quorum anywhere
    return a


CASES = {
    # name: (seed, table options, block kinds, depth, crash)
    "clean": (3, {}, (1, 2, 3, 4), W, False),
    "overflow": (4, {"full_shards": (0, 5)}, (1,), W, False),
    "version_wrap": (5, {"wrap_shards": (2,)}, (1,), W, False),
    "crashed_quorum": (6, {}, (1, 2, 3, 4), W, True),
    "partial_depth": (7, {"full_shards": (1,)}, (1, 2, 3, 4), 2, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decide_apply_matches_reference(port_table, ref_table, host_scan, name):
    seed, opts, _kinds, depth, crash = CASES[name]
    rng = np.random.default_rng(seed)
    arrays = _random_table(rng, **opts)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_blocks(rng, depth, kinds=(1,)))
    pops, rops = port_table.pack_window(pb), ref_table.pack_window(rb)
    base = rng.integers(0, 50, N).astype(np.int32)
    new, flags = port_table.decide_apply(_alive(crash), base, depth, pops, W=W)
    rnew, rflags = ref_table.decide_apply(_alive(crash), base, depth, rops, W=W)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(rflags))
    _assert_state(new, rnew)
    _assert_state(port_table.state, ref_table.state)  # the input table is untouched
    if name == "overflow":
        assert flags[1] == 1
    if name == "version_wrap":
        assert flags[2] == 1
    if name == "crashed_quorum":
        assert flags[0] == 0
    # the g++ build of the kernel's header on the same window
    kind = np.full((W, N), kv_window.KIND_SET, np.int8)
    got, over, _ = host_scan(arrays, kind, _pad(pops.klen, W), _pad(pops.vlen, W),
                             _pad(pops.kwin, W), _pad(pops.vwin, W), depth)
    for a, b in zip(got, rnew):
        np.testing.assert_array_equal(a, _np(b))
    assert int(over.any()) == int(np.asarray(rflags)[1])


@pytest.mark.parametrize("name", ["clean", "crashed_quorum", "partial_depth"])
def test_lookup_window_matches_reference(port_table, ref_table, host_scan, name):
    seed, opts, _kinds, depth, crash = CASES[name]
    rng = np.random.default_rng(seed + 100)
    arrays = _random_table(rng, **opts)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_blocks(rng, depth, kinds=(2,)))
    ops = port_table.pack_get_window(pb)
    g = ref_table._gather_window(rb, "get")
    rops = (g[1], np.ascontiguousarray(g[3]).view(np.uint32))
    base = rng.integers(0, 50, N).astype(np.int32)
    got = port_table.lookup_window(_alive(crash), base, depth, ops, W=W)
    want = ref_table.lookup_window(_alive(crash), base, depth, rops, W=W)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert bool(got[1].any())  # some GETs hit
    klen_p, kwin_p = _pad(ops[0], W), _pad(ops[1], W)
    kind = np.where(klen_p > 0, kv_window.KIND_GET, 0).astype(np.int8)
    _, _, reads = host_scan(arrays, kind, klen_p, np.zeros_like(klen_p), kwin_p,
                            np.zeros(klen_p.shape + (1,), np.uint32), depth)
    for a, b in zip(reads, want[1:]):
        np.testing.assert_array_equal(a, _np(b))


def _del_get_stream():
    """Per shard: DEL a stored key, GET it (same window: not found), SET
    it again, GET it (found, fresh version); shard 7 DELs a missing key."""
    out = []
    for code, val in ((3, None), (2, None), (1, b"again"), (2, None)):
        cmds = []
        for s in range(N):
            key = b"miss" if s == 7 else KEYS[s % len(KEYS)]
            cmds.append([_op(code, key) if val is None else _op(code, key, val)])
        out.append((list(range(N)), cmds))
    return out


@pytest.mark.parametrize("name", sorted(CASES) + ["del_then_get"])
def test_mixed_apply_matches_reference(port_table, ref_table, host_scan, name):
    seed, opts, kinds, depth, crash = CASES.get(name, (8, {}, None, W, False))
    rng = np.random.default_rng(seed + 200)
    arrays = _random_table(rng, **opts)
    if name == "del_then_get":  # every shard holds KEYS[s % 8] in slot 0
        for s in range(N):
            key = KEYS[s % len(KEYS)]
            keyb = arrays[1].view(np.uint8)
            hit = (arrays[2][s] == len(key)) & (keyb[s, :, : len(key)] == np.frombuffer(key, np.uint8)).all(1)
            arrays[0][s, hit] = False
            keyb[s, 0] = 0
            keyb[s, 0, : len(key)] = np.frombuffer(key, np.uint8)
            arrays[2][s, 0] = len(key)
            arrays[0][s, 0] = True
        stream = _del_get_stream()
    else:
        stream = _blocks(rng, depth, kinds=kinds)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(stream)
    (kind, ops), (rkind, rops) = port_table.pack_mixed_window(pb), ref_table.pack_mixed_window(rb)
    get_waves = np.nonzero((kind >= 2).any(axis=1))[0].astype(np.int32)
    base = rng.integers(0, 50, N).astype(np.int32)
    got = port_table.mixed_apply(_alive(crash), base, len(stream), kind, get_waves, ops, W=W)
    want = ref_table.mixed_apply(_alive(crash), base, len(stream), rkind, get_waves, rops, W=W)
    _assert_state(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    if name == "del_then_get":
        meta = got[2].numpy()
        assert not (meta[1, 1] & 1)[:7].any()  # GET after DEL: not found
        assert (meta[1, 3] & 1)[:7].all()  # GET after the re-SET: found
    kind_p = _pad(kind, W)
    arr, over, reads = host_scan(arrays, kind_p, _pad(ops.klen, W), _pad(ops.vlen, W),
                                 _pad(ops.kwin, W), _pad(ops.vwin, W), len(stream))
    for a, b in zip(arr, want[0]):
        np.testing.assert_array_equal(a, _np(b))
    gp = want[2].shape[1]
    gidx = np.zeros(gp, np.int64)
    gidx[: len(get_waves)] = get_waves
    found, rver, rvlen, rval = reads
    np.testing.assert_array_equal(rver[gidx], _np(want[2])[0])
    np.testing.assert_array_equal((rvlen[gidx] << 1) | found[gidx], _np(want[2])[1])
    np.testing.assert_array_equal(rval[gidx], _np(want[3]))
    assert int(over.any()) == int(np.asarray(want[1])[1])


@pytest.mark.parametrize("get_waves", [[], [2], [1, 2, 3], [0, 1, 2, 3], [3, 0, 2]])
def test_mixed_apply_gathered_rows_match_reference(port_table, ref_table, get_waves):
    """``mixed_apply``'s gathered rows for any list of GET waves: none (Gp
    = 1: the one row is wave 0's), one, three (Gp = 4: the pad row is wave
    0's again), all, and out of order; the rows, meta and gval equal the
    reference's."""
    rng = np.random.default_rng(70 + len(get_waves))
    arrays = _random_table(rng)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_blocks(rng, W))
    (kind, ops), (rkind, rops) = port_table.pack_mixed_window(pb), ref_table.pack_mixed_window(rb)
    gw = np.asarray(get_waves, np.int32)
    base = rng.integers(0, 50, N).astype(np.int32)
    got = port_table.mixed_apply(_alive(False), base, W, kind, gw, ops, W=W)
    want = ref_table.mixed_apply(_alive(False), base, W, rkind, gw, rops, W=W)
    _assert_state(got[0], want[0])
    Gp = 1 << max(0, len(get_waves) - 1).bit_length()
    assert got[2].shape == (2, Gp, N) and got[3].shape == (Gp, N, 16)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_empty_key_reads_match_reference(port_table, ref_table, host_scan):
    """The host store accepts the empty key, so a re-promoted table can
    hold one. The packers never emit a zero-length key, but the programs
    still answer like the reference's for one: a GET/DEL/EXISTS with
    klen 0 finds nothing, though a GET reads the matching slot's version."""
    from rabia_tpu.apps.device_kv import DeviceWindowOps as RefOps

    from rabia_tpu_torch.apps.device_kv import DeviceWindowOps

    rng = np.random.default_rng(21)
    arrays = _random_table(rng)
    arrays[0][:, 0] = True
    arrays[1][:, 0] = 0
    arrays[2][:, 0] = 0  # slot 0 of every shard holds the empty key
    _load(port_table, ref_table, arrays)
    kind = np.tile(np.array([[2], [3], [4], [1]], np.int8), (1, N))
    klen = np.zeros((W, N), np.int16)
    klen[3] = 2
    kwin = np.zeros((W, N, 1), np.uint32)
    kwin[3] = 0x6161  # "aa"
    vwin = np.zeros((W, N, 1), np.uint32)
    vlen = np.zeros((W, N), np.int16)
    get_waves = np.arange(3, dtype=np.int32)
    base = np.zeros(N, np.int32)
    got = port_table.mixed_apply(_alive(False), base, W, kind, get_waves,
                                 DeviceWindowOps(klen, vlen, kwin, vwin), W=W)
    want = ref_table.mixed_apply(_alive(False), base, W, kind, get_waves,
                                 RefOps(klen, vlen, kwin, vwin), W=W)
    _assert_state(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert not (np.asarray(want[2])[1] & 1).any()  # found nothing
    arr, _, reads = host_scan(arrays, kind, klen, vlen, kwin, vwin, W)
    for a, b in zip(arr, want[0]):
        np.testing.assert_array_equal(a, _np(b))
    np.testing.assert_array_equal(reads[1][:3], _np(want[2])[0][:3])
    np.testing.assert_array_equal((reads[2][:3] << 1) | reads[0][:3], _np(want[2])[1][:3])


# -- sync down and up -------------------------------------------------------------


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)


def test_dump_sync_upload_round_trip(port_table, ref_table, fixed_clock):
    rng = np.random.default_rng(11)
    arrays = _random_table(rng, full_shards=(3,))
    _load(port_table, ref_table, arrays)
    d = port_table.dump()
    assert _dump_rows(d) == ref_table.dump()["rows"]
    np.testing.assert_array_equal(d["shard_version"], ref_table.dump()["shard_version"])
    sm, rsm = vector_kv.VectorShardedKV(N), ref_vkv.VectorShardedKV(N)
    port_table.sync_into(sm)
    ref_table.sync_into(rsm)
    assert sm.store.snapshot_bytes() == rsm.store.snapshot_bytes()
    # upload from the synced stores: both tables rebuild alike
    seed, ref_seed = {}, {}
    assert port_table.upload_from(sm, seed_cache=seed)
    assert ref_table.upload_from(rsm, seed_cache=ref_seed)
    assert seed == ref_seed and len(seed) == int(arrays[0].sum())
    _assert_state(port_table.state, ref_table.state)
    assert _dump_rows(port_table.dump()) == ref_table.dump()["rows"]


def test_upload_from_block_applied_stores(port_table, ref_table, fixed_clock):
    """A host store filled by decided SET blocks holds each value inside
    its block's buffer, several entries a buffer: the port's upload
    gathers them from the buffers laid end to end, the reference copies
    them one by one; the tables and the seed caches come out equal
    (empty values, values of the full width, overwrites)."""
    rng = np.random.default_rng(12)
    sm, rsm = vector_kv.VectorShardedKV(N), ref_vkv.VectorShardedKV(N)
    for w in range(9):
        shards = sorted(rng.choice(N, size=int(rng.integers(1, N + 1)), replace=False).tolist())
        cmds = []
        for s in shards:
            key = b"u%d" % int(rng.integers(0, 5))
            val = bytes(rng.integers(0, 256, int(rng.choice([0, 3, 17, 64]))).astype(np.uint8))
            cmds.append([bytes((1,)) + len(key).to_bytes(2, "little") + key + val])
        for m, build in ((sm, build_block), (rsm, ref_build_block)):
            b = build(shards, cmds)
            m.apply_block(b, np.arange(len(b)))
    assert sm.store.snapshot_bytes() == rsm.store.snapshot_bytes()
    seed, ref_seed = {}, {}
    assert port_table.upload_from(sm, seed_cache=seed)
    assert ref_table.upload_from(rsm, seed_cache=ref_seed)
    assert seed == ref_seed and len(seed) == len(sm.store)
    _assert_state(port_table.state, ref_table.state)


@pytest.mark.parametrize("case", ["long_key", "too_many", "wide_value", "near_wrap"])
def test_upload_declines_outside_the_envelope(port_table, ref_table, case):
    sm, rsm = vector_kv.VectorShardedKV(N), ref_vkv.VectorShardedKV(N)
    for store in (sm.store, rsm.store):
        if case == "long_key":
            store.set(2, b"L" * 40, b"v")
        elif case == "too_many":
            for j in range(P + 1):
                store.set(1, b"k%d" % j, b"v")
        elif case == "wide_value":
            store.set(0, b"k", b"v" * 65)
        else:
            store.shard_version[4] = 2**31 - 2
    before = convert.device_table_to_numpy(port_table.state)
    assert not port_table.upload_from(sm)
    assert not ref_table.upload_from(rsm)
    after = convert.device_table_to_numpy(port_table.state)
    assert all(np.array_equal(before[k], after[k]) for k in before)


# -- the CUDA wrapper ---------------------------------------------------------------


class TestWrapperChecks:
    def _args(self, S=4, P_=3, Wn=2):
        table = kv_window.KVTable(
            torch.zeros((S, P_), dtype=torch.bool), torch.zeros((S, P_, 8), dtype=torch.int32),
            *(torch.zeros((S, P_), dtype=torch.int32) for _ in range(2)),
            torch.zeros((S, P_, 16), dtype=torch.int32), torch.zeros((S, P_), dtype=torch.int32),
            torch.zeros(S, dtype=torch.int32),
        )
        ops = (torch.ones((Wn, S), dtype=torch.int8), torch.ones((Wn, S), dtype=torch.int16),
               torch.zeros((Wn, S), dtype=torch.int16), torch.zeros((Wn, S, 2), dtype=torch.int32),
               torch.zeros((Wn, S, 4), dtype=torch.int32))
        return table, ops

    def test_rejects_wrong_dtype(self):
        table, ops = self._args()
        with pytest.raises(ValueError, match="used must be bool"):
            kv_window.KV_WINDOW(table._replace(used=table.used.to(torch.uint8)), *ops, 2)
        with pytest.raises(ValueError, match="kind must be int8"):
            kv_window.KV_WINDOW(table, ops[0].to(torch.int32), *ops[1:], 2)
        with pytest.raises(ValueError, match="klen must be int16"):
            kv_window.KV_WINDOW(table, ops[0], ops[1].to(torch.int32), *ops[2:], 2)

    def test_rejects_wrong_shape(self):
        table, ops = self._args()
        with pytest.raises(ValueError, match="keyw must be int32"):
            kv_window.KV_WINDOW(table._replace(keyw=table.keyw[:2]), *ops, 2)
        with pytest.raises(ValueError, match="kwin must be int32"):
            wide = torch.zeros((2, 4, 9), dtype=torch.int32)  # wider than the table's K4
            kv_window.KV_WINDOW(table, *ops[:3], wide, ops[4], 2)
        with pytest.raises(ValueError, match="depth"):
            kv_window.KV_WINDOW(table, *ops, 3)
        with pytest.raises(ValueError, match="contiguous"):
            kv_window.KV_WINDOW(table._replace(ver=table.ver.t().contiguous().t()), *ops, 2)

    def test_cpu_tensor_never_reaches_the_kernel(self):
        table, ops = self._args()
        before = kv_window.KV_WINDOW.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            kv_window.KV_WINDOW(table, *ops, 2)
        new, over, reads = kv_window.window(table, *ops, 2, want_reads=True)  # plain path
        assert new.used.shape == (4, 3) and reads.val.shape == (2, 4, 16)
        assert kv_window.KV_WINDOW.launches == before


def test_plain_version_matches_header_on_random_cases(host_scan):
    """The plain PyTorch scan and the header agree on random tables and
    ops over all kinds (P = 1, 7, 64; widths below the table's)."""
    import chip_smoke

    gen = torch.Generator().manual_seed(3)
    for P_, Wn, ku4, vwu4 in ((1, 3, 8, 16), (7, 5, 2, 4), (64, 4, 1, 1)):
        table, ops, depth = chip_smoke.random_kv_case(gen, 17, P_, 8, 16, Wn, ku4, vwu4, "cpu")
        new, over, reads = kv_window.kv_window_plain(table, *ops, depth, want_reads=True)
        arrays = [x.numpy() for x in table]
        got, h_over, h_reads = host_scan(arrays, *(x.numpy() for x in ops), depth)
        for a, b in zip(new, got):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(over.numpy(), h_over)
        for a, b in zip(reads, h_reads):
            np.testing.assert_array_equal(a.numpy(), b)


# -- the decision folded into the window --------------------------------------------


def _fold_alive(kind: str) -> np.ndarray:
    a = np.ones((N, R), bool)
    if kind == "quorumless":  # shard 3 keeps one replica of three: no quorum
        a[3, 1:] = False
    elif kind == "all_dead":  # every replica of shard 5 is dead
        a[5] = False
    elif kind == "crash":
        a[:, 1:] = False
    return a


FOLD_CASES = {
    # name: (seed, W, depth, max_phases, alive, bases near the wrap, table options)
    "quorumless": (31, W, W, 4, "quorumless", False, {}),
    "all_dead": (32, W, W, 4, "all_dead", False, {}),
    "depth_0": (33, W, 0, 4, "crash", False, {}),
    "max_phases_0": (34, W, 2, 0, "healthy", False, {}),
    "long_window": (35, 40, 40, 1, "healthy", True, {"full_shards": (0,)}),
    "long_partial": (36, 40, 33, 4, "quorumless", True, {"wrap_shards": (2,)}),
    "base_wrap": (37, W, W, 4, "healthy", True, {"wrap_shards": (4,)}),
}


@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_folded_decision_matches_reference_flags(port_table, ref_table, host_fold, name):
    """One SET window decided and applied: the reference's program, the
    port's plain composition (``decide_window_plain`` behind
    ``decide_apply``) and the g++ build of the per-shard decide-and-reduce
    that the kernel folds in agree on the table and the flags."""
    seed, Wn, depth, max_phases, alive_kind, near_wrap, opts = FOLD_CASES[name]
    rng = np.random.default_rng(seed)
    arrays = _random_table(rng, **opts)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_blocks(rng, max(depth, 1), kinds=(1,)))
    pops, rops = port_table.pack_window(pb), ref_table.pack_window(rb)
    base = rng.integers(0, 50, N).astype(np.int64)
    if near_wrap:  # base + t wraps inside the window on half the shards
        base[::2] = 2**31 - 1 - rng.integers(0, Wn, size=N // 2)
    base = base.astype(np.int32)
    alive = _fold_alive(alive_kind)
    new, flags = port_table.decide_apply(alive, base, depth, pops, W=Wn, max_phases=max_phases)
    rnew, rflags = ref_table.decide_apply(alive, base, depth, rops, W=Wn, max_phases=max_phases)
    rflags = np.asarray(rflags)
    np.testing.assert_array_equal(flags.numpy(), rflags)
    _assert_state(new, rnew)
    got, hflags = host_fold(arrays, pops, Wn, depth, alive, base, max_phases)
    np.testing.assert_array_equal(hflags, rflags)
    for a, b in zip(got, rnew):
        np.testing.assert_array_equal(a, _np(b))
    want_all_v1 = depth == 0 or (alive_kind == "healthy" and max_phases > 0)
    assert rflags[0] == int(want_all_v1)


def test_cpu_tables_take_the_plain_composition(port_table, monkeypatch):
    """On the CPU every program goes through ``decide_window_plain`` once
    and neither kernel is reached (launch counts flat)."""
    rng = np.random.default_rng(41)
    port_table.state = convert.device_table_from_numpy(_random_table(rng), "cpu")
    calls = []
    plain = kv_window.decide_window_plain
    monkeypatch.setattr(kv_window, "decide_window_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    before = kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches
    alive, base = np.ones((N, R), bool), np.zeros(N, np.int32)
    pb, _ = _both(_blocks(rng, W, kinds=(1,)))
    port_table.decide_apply(alive, base, W, port_table.pack_window(pb), W=W)
    pb, _ = _both(_blocks(rng, W, kinds=(2,)))
    port_table.lookup_window(alive, base, W, port_table.pack_get_window(pb), W=W)
    pb, _ = _both(_blocks(rng, W))
    kind, ops = port_table.pack_mixed_window(pb)
    port_table.mixed_apply(alive, base, W, kind, np.arange(W, dtype=np.int32), ops, W=W)
    assert calls == [1, 1, 1]
    assert (kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches) == before


class TestDecideWrapperChecks:
    def _args(self, S=4, R_=5):
        table, ops = TestWrapperChecks()._args(S=S)
        alive = torch.ones((S, R_), dtype=torch.bool)
        base = torch.zeros(S, dtype=torch.int32)
        return table, ops, alive, base

    def _call(self, table, ops, alive, base, **kw):
        args = dict(seed=0, coin_p1=0.5, max_phases=4)
        args.update(kw)
        return kv_window.KV_WINDOW.decide(table, *ops, 2, alive, base, **args)

    def test_rejects_wrong_dtype_and_shape(self):
        table, ops, alive, base = self._args()
        with pytest.raises(ValueError, match="alive must be bool"):
            self._call(table, ops, alive.to(torch.uint8), base)
        with pytest.raises(ValueError, match="alive must be bool"):
            self._call(table, ops, alive[:3], base)
        with pytest.raises(ValueError, match="base must be int32"):
            self._call(table, ops, alive, base.to(torch.int64))
        with pytest.raises(ValueError, match="base must be int32"):
            self._call(table, ops, alive, base[:3])
        with pytest.raises(ValueError, match="kind must be int8"):
            self._call(table, (ops[0].to(torch.int32), *ops[1:]), alive, base)
        with pytest.raises(ValueError, match="max_phases"):
            self._call(table, ops, alive, base, max_phases=-1)
        with pytest.raises(ValueError, match="contiguous"):
            self._call(table, ops, alive.t().contiguous().t(), base)

    def test_rejects_too_many_replicas(self):
        table, ops, alive, base = self._args(R_=65)
        with pytest.raises(ValueError, match="1..64 replicas"):
            self._call(table, ops, alive, base)

    def test_cpu_tensor_never_reaches_the_kernel(self):
        table, ops, alive, base = self._args()
        before = kv_window.KV_WINDOW.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            self._call(table, ops, alive, base)
        mk = MeshPhaseKernel(4, 5, device="cpu")
        new, over, reads, flags = kv_window.decide_window(
            mk, table, None, *ops[1:], 2, alive, base, 4, want_reads=True)  # the plain path
        assert new.used.shape == (4, 3) and reads.val.shape == (2, 4, 16)
        assert flags.tolist() == [1, 0, 0]
        assert kv_window.KV_WINDOW.launches == before
        assert kv_window.KVWindowKernel()._decide_fn is None  # nothing was built
