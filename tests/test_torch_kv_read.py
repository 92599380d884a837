"""The read-only windows' header (``csrc/kv_window.cuh``: the key tag,
``read_match``, ``read_of`` and ``read_shard``, which the read kernel
``csrc/kv_read.cu`` is built from) against the reference ``DeviceKVTable``.

The header is built for the host with g++ and run, wave by wave, on the
same numpy table and op planes as the reference's ``lookup_only``
(``_build_lookup_only``) and ``lookup_window`` (``_build_lookup``), in the
row form and the dictionary form: a random table, a full one, the empty
key stored and read, keys that share a tag but differ in their rows, pad
waves (rank 0 in the dictionary form, empty keys in the row form), and a
table wider than 64 slots. The port's own ``lookup_only`` and
``lookup_window`` on the CPU (the plain version) are held to the same
outputs, and the wrapper's refusal of a window that has no output table
but writes. Tolerance: exact equality (every output is an integer)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rabia_tpu.apps.device_kv import DeviceDictOps as RefDictOps
from rabia_tpu.apps.device_kv import DeviceKVTable as RefTable
from rabia_tpu.parallel.mesh import MeshPhaseKernel as RefMeshPhaseKernel
from rabia_tpu.parallel.mesh import make_mesh
from rabia_tpu_torch import convert
from rabia_tpu_torch.apps.device_kv import DeviceDictOps, DeviceKVTable
from rabia_tpu_torch.kernel import cuda_build, kv_window
from rabia_tpu_torch.parallel.mesh import MeshPhaseKernel

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

N, R, K4, VW4 = 8, 3, 8, 16  # 8 shards fill the reference's CPU mesh; 32 B keys, 64 B values
GOLD = 0x9E3779B1  # kvw::tag_add's multiplier

_HOST_SHIM = r"""
#include "kv_window.cuh"
extern "C" void kvr_host(long long S, int W, int P, int K4, int VW4, int ku4, int D,
                         const uint8_t* used, const int32_t* keyw, const int32_t* klen,
                         const int32_t* ver, const int32_t* valw, const int32_t* vlen,
                         const uint8_t* idx, const int16_t* op_klen, const int32_t* op_kw,
                         uint8_t* found, int32_t* rver, int32_t* rvlen, int32_t* rval) {
    for (long long s = 0; s < S; ++s)
        kvw::read_shard(s, W, S, P, K4, VW4, ku4, D, used, keyw, klen, ver, valw, vlen, idx,
                        op_klen, op_kw, found, rver, rvlen, rval);
}
extern "C" unsigned kvr_tag(int klen, const int32_t* w, int wu, int n) {
    return kvw::key_tag(klen, w, wu, n);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The header's read-only window compiled for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("kvr_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libkvr_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib))
    lib.kvr_host.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 13
    lib.kvr_host.restype = None
    lib.kvr_tag.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.kvr_tag.restype = ctypes.c_uint
    return lib


def _tag(words: np.ndarray, klen: int) -> int:
    """kvw::key_tag in Python (uint32 arithmetic)."""
    h = klen & 0xFFFFFFFF
    for w in words.astype(np.uint32).tolist():
        h = (h * GOLD + w) & 0xFFFFFFFF
    return h


def _host_read(lib, arrays, W, idx, klen, kw):
    """The header's read planes for every (wave, shard)."""
    used, keyw, kl, ver, valw, vl, _ = (np.ascontiguousarray(a) for a in arrays)
    S, P = used.shape
    used = used.astype(np.uint8)
    keyw, valw = keyw.view(np.int32), valw.view(np.int32)
    klen = np.ascontiguousarray(klen, np.int16)
    kw = np.ascontiguousarray(kw).view(np.int32)
    idx_h = None if idx is None else np.ascontiguousarray(idx, np.uint8)
    found = np.zeros((W, S), np.uint8)
    rver, rvlen = np.zeros((W, S), np.int32), np.zeros((W, S), np.int32)
    rval = np.zeros((W, S, valw.shape[2]), np.int32)
    ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
    lib.kvr_host(S, W, P, keyw.shape[2], valw.shape[2], kw.shape[-1],
                 0 if idx is None else klen.shape[1],
                 *map(ptr, (used, keyw, kl, ver, valw, vl, idx_h, klen, kw, found, rver, rvlen,
                            rval)))
    return found.astype(bool), rver, rvlen, rval


def _key_words(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """n distinct keys of 1..32 bytes as (klen, words u32[n, K4]), zero past their length."""
    klen = rng.integers(1, 33, n)
    words = rng.integers(0, 2**32, (n, K4), dtype=np.uint64).astype(np.uint32)
    for i, k in enumerate(klen):
        words[i, (k + 3) // 4:] = 0
    return klen.astype(np.int32), words


def _table(rng, P: int, case: str):
    """Seven table arrays in the reference's dtypes, and each shard's
    keys (klen, words) in slot order (the slots' keys stay unique)."""
    used = rng.random((N, P)) < (1.0 if case == "full" else 0.6)
    klen, words = _key_words(rng, N * P)
    klen, words = klen.reshape(N, P), words.reshape(N, P, K4)
    if case == "empty_key":  # the empty key, stored in slot 1 of every shard
        klen[:, 1], words[:, 1] = 0, 0
        used[:, 1] = True
    if case == "tag_collision":  # slots 2 and 4 hold keys of one tag and length
        klen[:, 2] = klen[:, 4] = 32
        words[:, 4] = words[:, 2]
        words[:, 4, 6] += 1
        words[:, 4, 7] -= np.uint32(GOLD)
        used[:, [2, 4]] = True
    ver = rng.integers(0, 2**31 - 1, (N, P)).astype(np.int32)
    valw = rng.integers(0, 2**32, (N, P, VW4), dtype=np.uint64).astype(np.uint32)
    vlen = rng.integers(0, 4 * VW4 + 1, (N, P)).astype(np.int32)
    sver = rng.integers(P + 1, 1000, N).astype(np.int32)
    return [used, words, klen, ver, valw, vlen, sver], (klen, words)


def _queries(rng, keys, W: int, depth: int, case: str):
    """Row-form GET planes (klen i16[W, S], kwin u32[W, S, K4]): stored
    keys, misses, and the case's own keys; waves from depth on are pads
    (empty keys)."""
    klen, words = keys
    P = klen.shape[1]
    qk = np.zeros((W, N), np.int16)
    qw = np.zeros((W, N, K4), np.uint32)
    miss_len, miss_words = _key_words(rng, depth * N)
    for t in range(depth):
        for s in range(N):
            if rng.random() < 0.7:
                p = int(rng.integers(0, P))
                qk[t, s], qw[t, s] = klen[s, p], words[s, p]
            else:
                qk[t, s], qw[t, s] = miss_len[t * N + s], miss_words[t * N + s]
    if case == "empty_key":
        qk[0], qw[0] = 0, 0
    if case == "tag_collision":  # both colliding keys, and a third of their tag not stored
        qk[:3] = 32
        qw[0], qw[1] = words[:, 2], words[:, 4]
        qw[2] = words[:, 4]
        qw[2, :, 6] += 1
        qw[2, :, 7] -= np.uint32(GOLD)
    return qk, qw


def _dict_of(qk, qw, depth: int):
    """The dictionary form of the first depth waves: each shard's distinct
    keys (D = depth rows, some repeated) and the ranks; rank 0 pads."""
    S = qk.shape[1]
    idx = np.zeros((depth, S), np.uint8)
    dkl = np.zeros((S, depth), np.int16)
    dk = np.zeros((S, depth, K4), np.uint32)
    for s in range(S):
        rows = []
        for t in range(depth):
            row = (int(qk[t, s]), qw[t, s].tobytes())
            if row not in rows:
                rows.append(row)
            idx[t, s] = rows.index(row)
        for d, (k, w) in enumerate(rows):
            dkl[s, d], dk[s, d] = k, np.frombuffer(w, np.uint32)
    empty = (np.zeros((S, depth), np.int16), np.zeros((S, depth, 0), np.uint32))
    return idx, dkl, dk, empty


def _ref(P: int):
    return RefTable(N, RefMeshPhaseKernel(N, R, make_mesh()), per_shard_capacity=P)


@pytest.fixture(scope="module")
def ref_tables():
    """Reference tables of 6 and 70 slots a shard, one each for the
    module (their compiled programs are cached per signature)."""
    return {6: _ref(6), 70: _ref(70)}


CASES = ["random", "full", "empty_key", "tag_collision"]


def _run_case(host, ref_tables, form: str, case: str, P: int, W: int, depth: int, seed: int):
    rng = np.random.default_rng(seed)
    arrays, keys = _table(rng, P, case)
    qk, qw = _queries(rng, keys, W, depth, case)
    ref = ref_tables[P]
    ref.state = tuple(jnp.asarray(a) for a in arrays)
    port = DeviceKVTable(N, MeshPhaseKernel(N, R, device="cpu"), per_shard_capacity=P)
    port.state = convert.device_table_from_numpy(arrays, "cpu")
    if form == "rows":
        ops = ref_ops = (qk[:depth], qw[:depth])
        idx, klen, kw = None, qk, qw
    else:
        idx, dkl, dk, (dvl, dv) = _dict_of(qk, qw, depth)
        ops = DeviceDictOps(idx, dkl, dvl, dk, dv)
        ref_ops = RefDictOps(idx, dkl, dvl, dk, dv)
        idx = np.concatenate([idx, np.zeros((W - depth, N), np.uint8)])  # rank 0 pads
        klen, kw = dkl, dk
    got = _host_read(host, arrays, W, idx, klen, kw)
    want = [np.asarray(x) for x in ref.lookup_only(ref_ops, W=W)]
    plain = [x.numpy() for x in port.lookup_only(ops, W=W)]
    for name, g, w, p in zip(("found", "ver", "vlen", "val"), got, want, plain):
        w = w.view(np.int32) if w.dtype == np.uint32 else w
        np.testing.assert_array_equal(g, w, err_msg=f"lookup_only {name} ({form}, {case})")
        np.testing.assert_array_equal(p, w, err_msg=f"plain lookup_only {name} ({form}, {case})")
    alive = np.ones((N, R), bool)
    alive[0, 1:] = False  # shard 0 has no quorum
    base = rng.integers(0, 50, N).astype(np.int32)
    want_w = [np.asarray(x) for x in ref.lookup_window(alive, base, depth, ref_ops, W=W)]
    plain_w = [x.numpy() for x in port.lookup_window(alive, base, depth, ops, W=W)]
    np.testing.assert_array_equal(plain_w[0], want_w[0])
    for g, w, p in zip(got, want_w[1:], plain_w[1:]):
        w = w.view(np.int32) if w.dtype == np.uint32 else w
        np.testing.assert_array_equal(g, w, err_msg=f"lookup_window ({form}, {case})")
        np.testing.assert_array_equal(p, w, err_msg=f"plain lookup_window ({form}, {case})")
    return got, (qk, qw, idx)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", ["rows", "dict"])
def test_read_header_matches_reference_on_every_wave(host, ref_tables, form, case):
    """Every wave, pads included, of the probe and the GET window."""
    W, depth = 4, 3
    (found, ver, _, _), (qk, qw, idx) = _run_case(host, ref_tables, form, case, 6, W, depth,
                                                  seed=10 + CASES.index(case))
    assert found[:depth].any()
    if form == "rows":  # a row window's pad waves read nothing
        assert not found[depth:].any()
    else:  # a dictionary window's pad waves read row 0's key, as wave t0 with rank 0 does
        first = np.argmax(idx[:depth] == 0, axis=0)
        np.testing.assert_array_equal(found[depth:], np.broadcast_to(
            found[first, np.arange(N)], found[depth:].shape))
    if case == "empty_key":  # the stored empty key is never found
        assert not found[0].any() and not ver[0].any()
    if case == "tag_collision":
        assert found[0].all() and found[1].all() and not found[2].any()


@pytest.mark.parametrize("form", ["rows", "dict"])
def test_read_header_matches_reference_past_64_slots(host, ref_tables, form):
    """A 70-slot table: the match runs over two groups of 64 slots."""
    W = 4
    found, *_ = _run_case(host, ref_tables, form, "full", 70, W, W, seed=31)[0]
    assert found.any()


def test_colliding_keys_share_a_tag(host):
    """The tag_collision case's keys really share a tag in the header's
    kvw::key_tag (and its Python twin), though their rows differ; a key's
    tag reads zero past its op width."""
    rng = np.random.default_rng(5)
    _, (klen, words) = _table(rng, 6, "tag_collision")
    a, b = np.ascontiguousarray(words[0, 2]), np.ascontiguousarray(words[0, 4])
    assert not np.array_equal(a, b)
    ta = host.kvr_tag(32, a.ctypes.data, K4, K4)
    assert ta == host.kvr_tag(32, b.ctypes.data, K4, K4) == _tag(a, 32) == _tag(b, 32)
    short = np.ascontiguousarray(a[:3])
    padded = np.concatenate([short, np.zeros(K4 - 3, np.uint32)])
    assert host.kvr_tag(12, short.ctypes.data, 3, K4) == _tag(padded, 12)


@pytest.mark.parametrize("P_, Wn, D, ku4", [(7, 16, 0, 8), (64, 16, 16, 8), (64, 40, 32, 2),
                                            (130, 16, 17, 8), (130, 40, 0, 3)])
def test_read_header_matches_plain_on_random_cases(host, P_, Wn, D, ku4):
    """``read_shard`` against the plain version's read of every non-empty
    key, on chip_smoke's random tables (stale words in free slots, the
    empty key stored, op widths below the table's) in the row form (D 0)
    and the dictionary form with ranks past D."""
    import chip_smoke

    gen = torch.Generator().manual_seed(P_ + Wn + D)
    if D:
        table, _, dops, idx, _ = chip_smoke.random_dict_case(gen, 17, P_, K4, VW4, Wn, ku4, 4, D,
                                                             "cpu")
        klen, kw = dops[0], dops[2]
    else:
        table, ops, _ = chip_smoke.random_kv_case(gen, 17, P_, K4, VW4, Wn, ku4, 4, "cpu")
        idx, klen, kw = None, ops[1], ops[3]
    _, over, reads = kv_window.kv_window_plain(table, kv_window.KIND_GET, klen, None, kw, None, 0,
                                               idx=idx, want_table=False, want_reads=True)
    arrays = [x.numpy() for x in table]
    got = _host_read(host, arrays, Wn, None if idx is None else idx.numpy(), klen.numpy(),
                     kw.numpy())
    assert not over.any()
    for g, w in zip(got, reads):
        np.testing.assert_array_equal(g, w.numpy())
    assert reads.found.any()


def test_wrapper_refuses_a_window_without_a_table_that_writes():
    """A window with no output table must read every non-empty key: the
    read kernel has no wave chain to apply a write with."""
    S, P = 4, 3
    table = kv_window.KVTable(
        torch.zeros((S, P), dtype=torch.bool), torch.zeros((S, P, K4), dtype=torch.int32),
        *(torch.zeros((S, P), dtype=torch.int32) for _ in range(2)),
        torch.zeros((S, P, VW4), dtype=torch.int32), torch.zeros((S, P), dtype=torch.int32),
        torch.zeros(S, dtype=torch.int32),
    )
    klen = torch.ones((2, S), dtype=torch.int16)
    kw = torch.zeros((2, S, 2), dtype=torch.int32)
    for kind in (None, kv_window.KIND_SET, torch.full((2, S), 2, dtype=torch.int8)):
        with pytest.raises(ValueError, match="without an output table reads"):
            kv_window.KV_WINDOW(table, kind, klen, None, kw, None, 2, want_table=False,
                                want_reads=True)
    before = dict(kv_window.KV_WINDOW.counts)
    with pytest.raises(ValueError, match="CUDA tensors"):  # a read passes the checks
        kv_window.KV_WINDOW(table, kv_window.KIND_GET, klen, None, kw, None, 2,
                            want_table=False, want_reads=True)
    assert kv_window.KV_WINDOW.counts == before
    assert set(before) == {"rows", "dict", "dict wide", "rows+decide", "dict+decide",
                           "dict wide+decide", "probe rows", "probe dict", "lookup rows",
                           "lookup dict"}
