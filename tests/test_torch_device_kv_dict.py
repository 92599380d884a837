"""The dictionary form of the device KV table's windows and the
consensus-free probe, against the reference ``DeviceKVTable``.

The same blocks go through the reference's packers and the port's
(``pack_window_dict``, the ``*_auto`` packers: the D = 1 fast path,
``max_dict`` exceeded, a forced hash collision falling back to rows),
then the same table through the reference's XLA programs and the port's
programs on the CPU in the dictionary form: ``decide_apply``,
``lookup_window``, ``mixed_apply`` and ``lookup_only`` (all W waves,
pad waves included), and against the port's own row form. The kernel's
per-op header (``csrc/kv_window.cuh``), built with g++, runs dictionary
windows through ``kvw::op_row`` and ``kvw::implied_kind`` and is held
against the plain version. The engine tests port the reference's
``test_dict_upload_engages_and_conforms`` and its GET and mixed
counterparts. Tolerance: exact equality (every output is an integer or
bytes)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rabia_tpu.apps import device_kv as ref_dkv
from rabia_tpu.apps.vector_kv import VectorShardedKV as RefVKV
from rabia_tpu.core.blocks import build_block as ref_build_block
from rabia_tpu.parallel import MeshEngine as RefEngine
from rabia_tpu.parallel import make_mesh
from rabia_tpu_torch import convert
from rabia_tpu_torch.apps import device_kv
from rabia_tpu_torch.apps.device_kv import DeviceDictOps, DeviceWindowOps
from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.kernel import cuda_build, kv_window, mesh_window
from rabia_tpu_torch.parallel import MeshEngine
from rabia_tpu_torch.parallel.mesh_engine import _DictSeg
from test_torch_device_kv import (  # noqa: F401  (fixtures)
    CASES, KEYS, N, W, _alive, _assert_state, _both, _load, _np, _op, _random_table, port_table,
    ref_table,
)

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other


def _dict_blocks(rng, waves: int, kinds=(1, 2, 3, 4), n_keys: int = 3) -> list:
    """Full-width blocks whose ops repeat: each shard draws its key from
    a few and its value from two, so a window has few distinct rows."""
    out = []
    for _ in range(waves):
        cmds = []
        for s in range(N):
            key = KEYS[(s + int(rng.integers(0, n_keys))) % len(KEYS)]
            k = kinds[int(rng.integers(0, len(kinds)))]
            cmds.append([_op(1, key, b"val%d" % int(rng.integers(0, 2))) if k == 1 else _op(k, key)])
        out.append((list(range(N)), cmds))
    return out


def _same(a, b) -> None:
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- packers ----------------------------------------------------------------------


@pytest.fixture
def numpy_pack(monkeypatch):
    monkeypatch.setenv("RABIA_PY_DEVPACK", "1")  # the reference's numpy gather


@pytest.mark.parametrize("seed", [0, 1])
def test_dict_packers_equal_reference(port_table, ref_table, numpy_pack, seed):
    rng = np.random.default_rng(seed)
    pb, rb = _both(_dict_blocks(rng, W, kinds=(1,)))
    got, want = port_table.pack_window_dict(pb), ref_table.pack_window_dict(rb)
    assert isinstance(got, DeviceDictOps) and 1 < got.dkl.shape[1] <= W
    _same(got, want)
    _same(port_table.pack_window_auto(pb), ref_table.pack_window_auto(rb))
    pb, rb = _both(_dict_blocks(rng, W))
    got, want = port_table.pack_mixed_window_auto(pb), ref_table.pack_mixed_window_auto(rb)
    assert isinstance(got[1], DeviceDictOps)
    for a, b in zip(got[::2] + got[3:], want[::2] + want[3:]):
        np.testing.assert_array_equal(a, b)
    _same(got[1], want[1])
    pb, rb = _both(_dict_blocks(rng, W, kinds=(2,)))
    got, want = port_table.pack_get_window_auto(pb), ref_table.pack_get_window_auto(rb)
    assert isinstance(got, DeviceDictOps)
    _same(got, want)


def test_dict_packer_one_row_fast_path(port_table, ref_table, numpy_pack):
    """Every wave repeats its shard's one row: D = 1, all ranks 0."""
    stream = [(list(range(N)), [[_op(1, KEYS[s], b"same")] for s in range(N)])] * W
    pb, rb = _both(stream)
    got, want = port_table.pack_window_auto(pb), ref_table.pack_window_auto(rb)
    assert got.dkl.shape == (N, 1) and not got.idx.any()
    _same(got, want)


def test_dict_packer_declines_past_max_dict(port_table, ref_table, numpy_pack):
    """More distinct rows a shard than max_dict: no dictionary, rows."""
    stream = [(list(range(N)), [[_op(1, b"k%d" % w, b"v")] for _ in range(N)]) for w in range(40)]
    pb, rb = _both(stream)
    assert port_table.pack_window_dict(pb) is None and ref_table.pack_window_dict(rb) is None
    got, want = port_table.pack_window_auto(pb), ref_table.pack_window_auto(rb)
    assert isinstance(got, DeviceWindowOps)
    _same(got, want)
    small = pb[:3]
    assert port_table.pack_window_dict(small, max_dict=2) is None
    assert ref_table.pack_window_dict(rb[:3], max_dict=2) is None
    assert port_table.pack_window_dict(small, max_dict=3).dkl.shape[1] == 3


@pytest.mark.parametrize("stream", ["one_row", "sorted"])
def test_dict_packer_hash_collision_falls_back_to_rows(port_table, ref_table, numpy_pack,
                                                       monkeypatch, stream):
    """The hash is never trusted: with the word fold forced to zero,
    distinct rows of equal lengths collide, the byte compare catches it
    and the auto packers fall back to rows (both the D = 1 path and the
    sorted path)."""
    for mod in (device_kv, ref_dkv):
        monkeypatch.setattr(mod, "_fold_words", lambda a: np.zeros(a.shape[:-1], np.uint64))
    if stream == "one_row":  # every hash equal: the D = 1 check runs and fails
        ops = [[[_op(1, b"k%d" % w, b"v")] for _ in range(N)] for w in range(W)]
    else:  # lengths differ across rows, so the sort runs; k0/k1 collide
        ops = [[[_op(1, b"k%d" % (w % 2), b"v" * (w // 2))] for _ in range(N)] for w in range(W)]
    pb, rb = _both([(list(range(N)), c) for c in ops])
    assert port_table.pack_window_dict(pb) is None and ref_table.pack_window_dict(rb) is None
    got, want = port_table.pack_window_auto(pb), ref_table.pack_window_auto(rb)
    assert isinstance(got, DeviceWindowOps)
    _same(got, want)
    gp, gr = _both([(list(range(N)), [[_op(2, b"k%d" % (w % 3))] for _ in range(N)])
                    for w in range(W)])
    got, want = port_table.pack_get_window_auto(gp), ref_table.pack_get_window_auto(gr)
    assert isinstance(got, tuple) and not isinstance(got, DeviceDictOps)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- the programs in the dictionary form -------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_dict_decide_apply_matches_reference_and_rows(port_table, ref_table, numpy_pack, name):
    seed, opts, _kinds, depth, crash = CASES[name]
    rng = np.random.default_rng(seed + 300)
    arrays = _random_table(rng, **opts)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_dict_blocks(rng, depth, kinds=(1,)))
    pops, rops = port_table.pack_window_dict(pb), ref_table.pack_window_dict(rb)
    assert isinstance(pops, DeviceDictOps)
    base = rng.integers(0, 50, N).astype(np.int32)
    new, flags = port_table.decide_apply(_alive(crash), base, depth, pops, W=W)
    rnew, rflags = ref_table.decide_apply(_alive(crash), base, depth, rops, W=W)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(rflags))
    _assert_state(new, rnew)
    _assert_state(port_table.state, ref_table.state)  # the input table is untouched
    # the row form of the same window on the port
    rnew2, rflags2 = port_table.decide_apply(_alive(crash), base, depth,
                                             port_table.pack_window(pb), W=W)
    np.testing.assert_array_equal(flags.numpy(), rflags2.numpy())
    _assert_state(new, [x.numpy() for x in rnew2])


@pytest.mark.parametrize("name", ["clean", "crashed_quorum", "partial_depth"])
def test_dict_lookup_window_matches_reference_and_rows(port_table, ref_table, numpy_pack, name):
    seed, opts, _kinds, depth, crash = CASES[name]
    rng = np.random.default_rng(seed + 400)
    arrays = _random_table(rng, **opts)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_dict_blocks(rng, depth, kinds=(2,), n_keys=4))
    ops, rops = port_table.pack_get_window_auto(pb), ref_table.pack_get_window_auto(rb)
    assert isinstance(ops, DeviceDictOps)
    base = rng.integers(0, 50, N).astype(np.int32)
    got = port_table.lookup_window(_alive(crash), base, depth, ops, W=W)
    want = ref_table.lookup_window(_alive(crash), base, depth, rops, W=W)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert bool(got[1].any())
    rows = port_table.lookup_window(_alive(crash), base, depth, port_table.pack_get_window(pb), W=W)
    for a, b in zip(got, rows):
        np.testing.assert_array_equal(a.numpy()[:depth] if a.dim() else a.numpy(),
                                      b.numpy()[:depth] if b.dim() else b.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_dict_mixed_apply_matches_reference_and_rows(port_table, ref_table, numpy_pack, name):
    seed, opts, kinds, depth, crash = CASES[name]
    rng = np.random.default_rng(seed + 500)
    arrays = _random_table(rng, **opts)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_dict_blocks(rng, depth, kinds=kinds))
    (kind, ops, _, _), (rkind, rops, _, _) = (port_table.pack_mixed_window_auto(pb),
                                              ref_table.pack_mixed_window_auto(rb))
    assert isinstance(ops, DeviceDictOps)
    get_waves = np.nonzero((kind >= 2).any(axis=1))[0].astype(np.int32)
    base = rng.integers(0, 50, N).astype(np.int32)
    got = port_table.mixed_apply(_alive(crash), base, depth, kind, get_waves, ops, W=W)
    want = ref_table.mixed_apply(_alive(crash), base, depth, rkind, get_waves, rops, W=W)
    _assert_state(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    _, rows = port_table.pack_mixed_window(pb)
    got2 = port_table.mixed_apply(_alive(crash), base, depth, kind, get_waves, rows, W=W)
    _assert_state(got[0], [x.numpy() for x in got2[0]])
    for a, b in zip(got[1:], got2[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("get_waves", [[], [1], [0, 2, 3], [0, 1, 2, 3]])
def test_dict_mixed_apply_gathered_rows_match_reference(port_table, ref_table, numpy_pack,
                                                        get_waves):
    """The dictionary form's gathered rows for any list of GET waves: none
    (Gp = 1, wave 0's row), one, three (a pad row: wave 0's), all; equal
    to the reference's and to the row form's."""
    rng = np.random.default_rng(90 + len(get_waves))
    arrays = _random_table(rng)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_dict_blocks(rng, W))
    (kind, ops, _, _), (rkind, rops, _, _) = (port_table.pack_mixed_window_auto(pb),
                                              ref_table.pack_mixed_window_auto(rb))
    assert isinstance(ops, DeviceDictOps)
    gw = np.asarray(get_waves, np.int32)
    base = rng.integers(0, 50, N).astype(np.int32)
    got = port_table.mixed_apply(_alive(False), base, W, kind, gw, ops, W=W)
    want = ref_table.mixed_apply(_alive(False), base, W, rkind, gw, rops, W=W)
    _assert_state(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    _, rows = port_table.pack_mixed_window(pb)
    got2 = port_table.mixed_apply(_alive(False), base, W, kind, gw, rows, W=W)
    for a, b in zip(got[1:], got2[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("form", ["dict", "rows"])
@pytest.mark.parametrize("depth", [W, 2])
def test_lookup_only_matches_reference_on_every_wave(port_table, ref_table, numpy_pack, form,
                                                     depth):
    """The probe against the reference's ``lookup_only`` on all W waves.
    A dictionary window's pad waves carry rank 0 and read row 0's key (the
    reference's behaviour, pinned here); a row window's pad waves have an
    empty key and read nothing."""
    rng = np.random.default_rng(600 + depth)
    arrays = _random_table(rng)
    _load(port_table, ref_table, arrays)
    pb, rb = _both(_dict_blocks(rng, depth, kinds=(2,), n_keys=4))
    if form == "dict":
        ops, rops = port_table.pack_get_window_auto(pb), ref_table.pack_get_window_auto(rb)
        assert isinstance(ops, DeviceDictOps)
    else:
        ops = port_table.pack_get_window(pb)
        g = ref_table._gather_window(rb, "get")
        rops = (g[1], np.ascontiguousarray(g[3]).view(np.uint32))
    got = port_table.lookup_only(ops, W=W)
    want = ref_table.lookup_only(rops, W=W)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    found = got[0].numpy()
    assert found[:depth].any()
    if depth < W:
        if form == "rows":
            assert not found[depth:].any()
        else:  # pad waves repeat the lookup of row 0's key
            np.testing.assert_array_equal(found[depth:], np.broadcast_to(
                found[np.argmax(ops.idx == 0, axis=0), np.arange(N)], found[depth:].shape))
    _assert_state(port_table.state, ref_table.state)  # read-only


def test_probe_takes_no_decision(port_table, monkeypatch):
    """``lookup_only`` reaches neither the decision (the plain mesh window,
    ``decide_window_plain``) nor the mesh kernel: only the plain wave scan."""
    rng = np.random.default_rng(7)
    port_table.state = convert.device_table_from_numpy(_random_table(rng), "cpu")
    calls = []
    for mod, name in ((kv_window, "decide_window_plain"), (kv_window, "decide_window")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
    real_plain = port_table.kernel.decide_slots_plain
    monkeypatch.setattr(port_table.kernel, "decide_slots_plain",
                        lambda *a, **k: calls.append(2) or real_plain(*a, **k))
    scans = []
    real_scan = kv_window.kv_window_plain
    monkeypatch.setattr(kv_window, "kv_window_plain",
                        lambda *a, **k: scans.append(1) or real_scan(*a, **k))
    pb, _ = _both(_dict_blocks(rng, W, kinds=(2,)))
    before = kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches
    port_table.lookup_only(port_table.pack_get_window_auto(pb), W=W)
    port_table.lookup_only(port_table.pack_get_window(pb), W=W)
    assert calls == [] and scans == [1, 1]
    assert (kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches) == before


# -- the header, built for the host -------------------------------------------


_HOST_SHIM = r"""
#include "kv_window.cuh"
extern "C" void kvw_host_ops(long long S, int W, int depth, int P, int K4, int VW4, int ku4,
                             int vwu4, int D, int kind_all, uint8_t* used, int32_t* keyw,
                             int32_t* klen, int32_t* ver, int32_t* valw, int32_t* vlen,
                             int32_t* sver, const int8_t* kind, const uint8_t* idx,
                             const int16_t* op_klen, const int16_t* op_vlen, const int32_t* op_kw,
                             const int32_t* op_vw, uint8_t* overflow, uint8_t* r_found,
                             int32_t* r_ver, int32_t* r_vlen, int32_t* r_val) {
    int32_t scratch[64];
    for (long long s = 0; s < S; ++s)
        kvw::scan_shard_ops(s, W, depth, S, P, K4, VW4, ku4, vwu4, D, kind_all, used, keyw, klen,
                            ver, valw, vlen, sver, kind, idx, op_klen, op_vlen, op_kw, op_vw,
                            overflow, r_found, r_ver, r_vlen, r_val, scratch);
}
extern "C" long long kvw_host_op_row(const uint8_t* idx, int D, int t, long long S, long long s) {
    return kvw::op_row(idx, D, t, S, s);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("kvw_dict_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libkvw_dict_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib))
    lib.kvw_host_ops.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 9
                                 + [ctypes.c_void_p] * 18)
    lib.kvw_host_ops.restype = None
    lib.kvw_host_op_row.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_longlong]
    lib.kvw_host_op_row.restype = ctypes.c_longlong
    return lib


def _host_scan(lib, table, kind, planes, idx, depth, kind_all):
    """The header's scan in place on numpy copies: (table, overflow, reads)."""
    used, keyw, kl, ver, valw, vl, sver = (np.array(x.numpy(), copy=True) for x in table)
    used = used.astype(np.uint8)
    S, P, K4 = keyw.shape
    VW4 = valw.shape[2]
    Wn = idx.shape[0] if idx is not None else planes[0].shape[0]
    klen, vlen, kw, vw = (None if x is None else np.ascontiguousarray(x.numpy()) for x in planes)
    kind_h = None if kind is None else np.ascontiguousarray(kind.numpy())
    idx_h = None if idx is None else np.ascontiguousarray(idx.numpy())
    over = np.zeros(S, np.uint8)
    found = np.zeros((Wn, S), np.uint8)
    rver, rvlen = np.zeros((Wn, S), np.int32), np.zeros((Wn, S), np.int32)
    rval = np.zeros((Wn, S, VW4), np.int32)
    ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
    lib.kvw_host_ops(S, Wn, depth, P, K4, VW4, kw.shape[2], 0 if vw is None else vw.shape[2],
                     0 if idx is None else klen.shape[1], kind_all,
                     *map(ptr, (used, keyw, kl, ver, valw, vl, sver, kind_h, idx_h, klen, vlen, kw,
                                vw, over, found, rver, rvlen, rval)))
    return [used.astype(bool), keyw, kl, ver, valw, vl, sver], over.astype(bool), (
        found.astype(bool), rver, rvlen, rval)


@pytest.mark.parametrize("P_, Wn, D, ku4, vwu4", [(7, 16, 1, 8, 16), (7, 16, 2, 2, 4),
                                                  (64, 16, 17, 8, 16), (64, 40, 32, 1, 1),
                                                  (130, 16, 32, 8, 16)])
def test_header_dict_form_matches_plain(host_lib, P_, Wn, D, ku4, vwu4):
    """``kvw::scan_shard_ops`` on dictionary windows (ranks past D
    included) agrees with the plain version: a kind plane, an implied SET,
    and an implied read without values (the probe)."""
    import chip_smoke

    gen = torch.Generator().manual_seed(P_ + Wn + D)
    table, kind, dops, idx, depth = chip_smoke.random_dict_case(gen, 17, P_, 8, 16, Wn, ku4, vwu4,
                                                                D, "cpu")
    assert bool((idx == D).any())  # some ranks name no row
    keys_only = (dops[0], None, dops[2], None)
    for k, planes, d, kind_all in ((kind, dops, depth, kv_window.KIND_SET),
                                   (None, dops, depth, kv_window.KIND_SET),
                                   (kv_window.KIND_GET, keys_only, 0, kv_window.KIND_GET)):
        new, over, reads = kv_window.kv_window_plain(table, k, *planes, d, idx=idx,
                                                     want_reads=True)
        got, h_over, h_reads = _host_scan(host_lib, table,
                                          k if isinstance(k, torch.Tensor) else None, planes, idx,
                                          d, kind_all)
        for a, b in zip(new, got):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(over.numpy(), h_over)
        for a, b in zip(reads, h_reads):
            np.testing.assert_array_equal(a.numpy(), b)


def test_header_op_row_matches_expand_dict(host_lib):
    """``kvw::op_row`` names the row that ``expand_dict`` reads: s * D +
    idx[t, s], none for a rank at or past D, and t * S + s for rows."""
    rng = np.random.default_rng(4)
    S, Wn, D = 9, 5, 3
    idx = np.ascontiguousarray(rng.integers(0, D + 2, (Wn, S)).astype(np.uint8))
    dkl = torch.arange(1, S * D + 1, dtype=torch.int16).reshape(S, D)
    klen, *_ = kv_window.expand_dict(torch.from_numpy(idx), dkl, None, dkl[..., None].int(), None)
    for t in range(Wn):
        for s in range(S):
            row = host_lib.kvw_host_op_row(idx.ctypes.data, D, t, S, s)
            want = s * D + int(idx[t, s]) if idx[t, s] < D else -1
            assert row == want
            assert int(klen[t, s]) == (0 if row < 0 else row + 1)
            assert host_lib.kvw_host_op_row(None, D, t, S, s) == t * S + s


# -- the wrapper ----------------------------------------------------------------------


class TestDictWrapperChecks:
    def _args(self, S=4, P_=3, Wn=2, D=2):
        table = kv_window.KVTable(
            torch.zeros((S, P_), dtype=torch.bool), torch.zeros((S, P_, 8), dtype=torch.int32),
            *(torch.zeros((S, P_), dtype=torch.int32) for _ in range(2)),
            torch.zeros((S, P_, 16), dtype=torch.int32), torch.zeros((S, P_), dtype=torch.int32),
            torch.zeros(S, dtype=torch.int32),
        )
        dops = (torch.ones((S, D), dtype=torch.int16), torch.zeros((S, D), dtype=torch.int16),
                torch.zeros((S, D, 2), dtype=torch.int32), torch.zeros((S, D, 4), dtype=torch.int32))
        return table, dops, torch.zeros((Wn, S), dtype=torch.uint8)

    def test_rejects_wrong_dict_shapes(self):
        table, dops, idx = self._args()
        with pytest.raises(ValueError, match="idx must be uint8"):
            kv_window.KV_WINDOW(table, None, *dops, 2, idx=idx.to(torch.int8))
        with pytest.raises(ValueError, match="klen must be int16"):
            kv_window.KV_WINDOW(table, None, dops[0][:3], *dops[1:], 2, idx=idx)
        with pytest.raises(ValueError, match="vlen must be int16"):
            kv_window.KV_WINDOW(table, None, dops[0], dops[1][:, :1], *dops[2:], 2, idx=idx)
        with pytest.raises(ValueError, match="kwin must be int32"):
            kv_window.KV_WINDOW(table, None, *dops[:2], torch.zeros((4, 2, 9), dtype=torch.int32),
                                dops[3], 2, idx=idx)
        with pytest.raises(ValueError, match="kind must be"):
            kv_window.KV_WINDOW(table, 5, *dops, 2, idx=idx)
        with pytest.raises(ValueError, match="depth"):
            kv_window.KV_WINDOW(table, None, *dops, 3, idx=idx)

    def test_cpu_tensor_never_reaches_the_kernel(self):
        table, dops, idx = self._args()
        before = dict(kv_window.KV_WINDOW.counts)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kv_window.KV_WINDOW(table, None, *dops, 2, idx=idx)
        new, over, reads = kv_window.window(table, kv_window.KIND_GET, dops[0], None, dops[2],
                                            None, 0, idx=idx, want_table=False, want_reads=True)
        assert new is None and reads.val.shape == (2, 4, 16)
        assert kv_window.KV_WINDOW.counts == before


# -- the engine: the dictionary uploads engage and conform ----------------------------


def _pair(window: int):
    """A port device-lane engine, a port host-lane engine and a reference
    host-lane engine (4 shards pad to the reference's 8-device mesh)."""
    n = 4
    return n, (
        MeshEngine(lambda: VectorShardedKV(n, capacity=1 << 12), n, 3, window=window,
                   device="cpu", device_store=True),
        MeshEngine(lambda: VectorShardedKV(n, capacity=1 << 12), n, 3, window=window,
                   device="cpu"),
        RefEngine(lambda: RefVKV(n, capacity=1 << 12), n, 3, mesh=make_mesh(), window=window),
    )


def _submit(engines, stream):
    """Each (shards, cmds) block into every engine; the futures by engine."""
    out = []
    for e in engines:
        bb = ref_build_block if isinstance(e, RefEngine) else build_block
        out.append([e.submit_block(bb(*blk)) for blk in stream])
    return out


def _frames(futs):
    return [[list(map(bytes, g)) for g in f.result()] for f in futs]


def _contents(sm) -> dict:
    """(shard, key) -> (value, version) of a replica store."""
    st = sm.store
    return {
        (int(st.shard_col[i]), st.key_lanes[i].view(np.uint8)[: int(st.key_len[i])].tobytes()):
        (st._value_at(i), int(st.version[i]))
        for i in np.nonzero(st.state == 1)[0].tolist()
    }


def _get(key: str) -> bytes:
    return _op(2, key.encode())


def _set(key: str, val: str) -> bytes:
    return _op(1, key.encode(), val.encode())


def test_dict_upload_engages_and_conforms():
    """A repetitive SET stream takes the dictionary upload (a _DictSeg
    lands in the value segments); responses and final content equal the
    host lanes'."""
    n, engines = _pair(4)
    dev = engines[0]
    sets = [(list(range(n)), [[_set(f"k{s % 2}", f"v{w % 2}")] for s in range(n)])
            for w in range(3)]
    gets = [(list(range(n)), [[_get("k0")] for _ in range(n)])]
    _submit(engines, sets)
    for e in engines:
        e.flush()
    futs = _submit(engines, gets)
    for e in engines:
        e.flush()
    assert dev.device_lane_active
    assert any(isinstance(sg, _DictSeg) for sg in dev._dev_vseg)
    assert _frames(futs[0]) == _frames(futs[1]) == _frames(futs[2])
    dev.sync_to_host()
    want = _contents(engines[1].sms[0])
    assert want == _contents(engines[2].sms[0])
    for sm in dev.sms:
        assert _contents(sm) == want


def test_get_window_dict_upload_engages_and_conforms():
    """A repetitive GET stream takes the dictionary key upload; responses
    equal the host lanes'."""
    n, engines = _pair(4)
    dev = engines[0]
    _submit(engines, [(list(range(n)), [[_set(f"k{s % 2}", "v")] for s in range(n)])])
    for e in engines:
        e.flush()
    gets = [(list(range(n)), [[_get(f"k{s % 2}")] for s in range(n)]) for _ in range(8)]
    assert isinstance(dev._dev.pack_get_window_auto([build_block(*g) for g in gets[:4]]),
                      DeviceDictOps)
    futs = _submit(engines, gets)
    for e in engines:
        e.flush()
    assert dev.device_lane_active, "a dictionary GET window demoted the lane"
    assert _frames(futs[0]) == _frames(futs[1]) == _frames(futs[2])


def test_mixed_window_dict_upload_engages_and_conforms():
    """A repetitive interleaved SET/GET stream takes the dictionary upload
    through the mixed program (GET ops are (key, empty value) rows);
    responses and final content equal the host lanes'."""
    n, engines = _pair(6)
    dev = engines[0]
    stream = []
    for _ in range(4):
        stream.append((list(range(n)), [[_set(f"k{s % 2}", "v")] for s in range(n)]))
        stream.append((list(range(n)), [[_get(f"k{s % 2}")] for s in range(n)]))
    packed = dev._dev.pack_mixed_window_auto([build_block(*b) for b in stream[:6]])
    assert packed is not None and isinstance(packed[1], DeviceDictOps)
    futs = _submit(engines, stream)
    for e in engines:
        e.flush()
    assert dev.device_lane_active, "a dictionary mixed window demoted the lane"
    assert _frames(futs[0]) == _frames(futs[1]) == _frames(futs[2])
    dev.sync_to_host()
    want = _contents(engines[1].sms[0])
    assert want == _contents(engines[2].sms[0])
    for sm in dev.sms:
        assert _contents(sm) == want
