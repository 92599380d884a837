"""The packers of the packed window and ``ClusterKernel.start_slot``:
their lane math built with g++ against the reference.

- ``csrc/packed_window.cuh``'s ``pack16``, ``pack16_alive`` and
  ``unpack16``, run word by word as the kernels of
  ``csrc/packed_window.cu`` run them (one thread a word, the ragged last
  word of a row padded), against the reference's ``pack_codes``,
  ``pack_alive`` and ``unpack_codes`` and the port's plain versions:
  random codes over all four values, ragged S, rows in several leading
  dims, the top lane's sign bit, an input that starts one byte into a
  buffer;
- ``csrc/cluster_round.cuh``'s ``start_slot`` (``cr::ss``: the kernel's
  threads walked over its grid on the host) against the reference's
  ``ClusterKernel.start_slot`` on states taken mid-protocol (R in 1..8
  and 64, masks, inactive shards, slots at 2^31-1 that wrap), out of
  place and in place;
- the CPU dispatch of the port's entry points, and the wrappers'
  refusals (the kernels themselves are held against the plain versions
  by ``chip_smoke.py`` phase 16 (c)).

Tolerance: exact equality (every value is an integer or a bit pattern).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rabia_tpu.kernel import packed_window as ref_pw
from rabia_tpu.kernel.phase_driver import ClusterKernel as RefCluster
from rabia_tpu_torch.core.types import ABSENT
from rabia_tpu_torch.kernel import cluster_round, cuda_build, packed_window
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel

torch.set_num_threads(1)

FIELDS = [name for name, _, _ in cluster_round.FIELDS]

_HOST_SHIM = r"""
#include "packed_window.cuh"
#include "cluster_round.cuh"
extern "C" void pw_host_pack(const int8_t* x, uint32_t* out, long long rows, long long S,
                             int alive) {
    const long long SW = (S + 15) / 16;
    for (long long row = 0; row < rows; ++row)
        for (long long w = 0; w < SW; ++w) {
            const int8_t* src = x + row * S + w * 16;
            const int n = (int)(S - w * 16 < 16 ? S - w * 16 : 16);
            out[row * SW + w] = alive ? pw::pack16_alive((const uint8_t*)src, n)
                                      : pw::pack16(src, n, 3);
        }
}
extern "C" void pw_host_unpack(const uint32_t* p, int8_t* out, long long rows, long long SW,
                               long long S) {
    for (long long row = 0; row < rows; ++row)
        for (long long w = 0; w < SW && w * 16 < S; ++w)
            pw::unpack16(p[row * SW + w], out + row * S + w * 16,
                         (int)(S - w * 16 < 16 ? S - w * 16 : 16));
}
// ClusterKernel.start_slot as cr_start_slot launches it: every thread of
// every launch's grid (cr::ss::launches plans them), one after another
extern "C" int cr_host_start_slot(void* const* in, void* const* out, const void* mask,
                                  const void* votes, long long S, int R) {
    return cr::ss::launches(1, in, out, &mask, &votes, S, R,
                            [](const cr::ss::Args& a, uint32_t grid_x) {
        for (int b = 0; b < a.nblk; ++b)
            for (uint32_t c = 0; c < grid_x; ++c)
                for (int t = 0; t < cr::ss::THREADS; ++t) cr::ss::thread(a, c, b, t);
    });
}
"""


class _Host:
    def __init__(self, lib_path):
        lib = ctypes.CDLL(str(lib_path))
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.pw_host_pack.argtypes = [P, P, LL, LL, I]
        lib.pw_host_unpack.argtypes = [P, P, LL, LL, LL]
        lib.cr_host_start_slot.argtypes = [P, P, P, P, LL, I]
        lib.cr_host_start_slot.restype = I
        self.lib = lib

    def pack(self, x: np.ndarray, alive: bool) -> np.ndarray:
        S = x.shape[-1]
        rows = x.size // S
        out = np.empty(x.shape[:-1] + (-(-S // 16),), np.uint32)
        self.lib.pw_host_pack(x.ctypes.data, out.ctypes.data, rows, S, int(alive))
        return out

    def unpack(self, p: np.ndarray, S: int) -> np.ndarray:
        SW = p.shape[-1]
        out = np.empty(p.shape[:-1] + (S,), np.int8)
        self.lib.pw_host_unpack(p.ctypes.data, out.ctypes.data, p.size // SW, SW, S)
        return out

    def start_slot(self, fields: dict, mask, votes, in_place: bool) -> dict:
        src = {f: np.ascontiguousarray(fields[f]).copy() for f in FIELDS}
        out = src if in_place else {f: np.empty_like(v) for f, v in src.items()}
        S, R = src["phase"].shape
        ins = (ctypes.c_void_p * 13)(*(src[f].ctypes.data for f in FIELDS))
        outs = (ctypes.c_void_p * 13)(*(out[f].ctypes.data for f in FIELDS))
        m = np.ascontiguousarray(mask, np.uint8)
        v = np.ascontiguousarray(votes, np.int8)
        assert self.lib.cr_host_start_slot(ins, outs, m.ctypes.data, v.ctypes.data, S, R) == 1
        return out


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The packers' and start_slot's headers compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the headers' host build cannot run")
    d = tmp_path_factory.mktemp("pack_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libpack_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    return _Host(lib)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(16,), (17,), (3, 1000), (2, 5, 4096), (4, 33), (1, 1)])
def test_packers_match_reference(host, shape):
    """pack_codes / pack_alive / unpack_codes: the header, the port's
    plain versions and the reference, word for word."""
    rng = np.random.default_rng(sum(shape))
    codes = rng.integers(0, 4, shape).astype(np.int8)
    alive = rng.random(shape) < 0.7
    S = shape[-1]
    want = np.asarray(ref_pw.pack_codes(jnp.asarray(codes)))
    np.testing.assert_array_equal(host.pack(codes, False), want)
    np.testing.assert_array_equal(_u32(packed_window.pack_codes_plain(torch.from_numpy(codes))), want)
    np.testing.assert_array_equal(_u32(packed_window.pack_codes(torch.from_numpy(codes))), want)
    want_a = np.asarray(ref_pw.pack_alive(jnp.asarray(alive)))
    np.testing.assert_array_equal(host.pack(alive.view(np.int8), True), want_a)
    np.testing.assert_array_equal(_u32(packed_window.pack_alive(torch.from_numpy(alive))), want_a)
    back = np.asarray(ref_pw.unpack_codes(jnp.asarray(want), S))
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(host.unpack(want, S), back)
    p = torch.from_numpy(want.copy().view(np.int32))
    np.testing.assert_array_equal(packed_window.unpack_codes(p, S).numpy(), back)
    # a shorter unpack keeps the first lanes, as the reference's slice does
    cut = max(1, S - 5)
    np.testing.assert_array_equal(host.unpack(want, cut), np.asarray(
        ref_pw.unpack_codes(jnp.asarray(want), cut)))


@pytest.mark.parametrize("R,T,S", [(5, 3, 17), (1, 1, 1), (3, 2, 1000), (8, 4, 4095),
                                   (5, 2, 4096)])
def test_pack_inputs_matches_reference(R, T, S):
    """``pack_inputs`` (a window's votes and alive plane, one launch on a
    card) is the reference's ``pack_codes`` and ``pack_alive`` word for
    word, ragged S included; the wrapper takes no CPU tensor and no alive
    plane of another width."""
    rng = np.random.default_rng(R * T + S)
    votes = rng.integers(0, 4, (R, T, S)).astype(np.int8)
    alive = rng.random((R, S)) < 0.7
    codes_w, alive_w = packed_window.pack_inputs(torch.from_numpy(votes), torch.from_numpy(alive))
    np.testing.assert_array_equal(_u32(codes_w), np.asarray(ref_pw.pack_codes(jnp.asarray(votes))))
    np.testing.assert_array_equal(_u32(alive_w), np.asarray(ref_pw.pack_alive(jnp.asarray(alive))))
    with pytest.raises(ValueError, match="CUDA"):
        packed_window.PACKERS.pack_inputs(torch.from_numpy(votes), torch.from_numpy(alive))
    with pytest.raises(ValueError, match="alive"):
        packed_window.PACKERS.pack_inputs(torch.from_numpy(votes),
                                          torch.from_numpy(votes).to(torch.int8))
    assert packed_window.PACKERS.counts["pack_inputs"] == 0


def test_packers_top_lane_and_offset_view(host):
    """Lane 15 holding ABSENT sets the word's sign bit: unpack shifts
    the uint32 pattern logically. An input that starts one byte into its
    buffer packs the same."""
    codes = np.full((2, 32), ABSENT, np.int8)
    codes[0, :16] = 0
    codes[0, 15] = ABSENT
    words = host.pack(codes, False)
    assert words[0, 0] == 0xC0000000 and words[1, 1] == 0xFFFFFFFF
    np.testing.assert_array_equal(host.unpack(words, 32), codes)
    raw = np.zeros(1 + 3 * 50, np.int8)
    view = raw[1:].reshape(3, 50)
    view[:] = np.random.default_rng(2).integers(0, 4, (3, 50))
    np.testing.assert_array_equal(
        host.pack(view, False), np.asarray(ref_pw.pack_codes(jnp.asarray(view.copy()))))


def _mid_state(R: int, S: int, seed: int):
    """A reference ClusterState taken mid-protocol: two slots, some
    rounds under loss, with inactive shards and slots near 2^31-1."""
    k = RefCluster(S, R, seed=seed)
    rng = np.random.default_rng(seed)
    st = k.init_state()
    mask = jnp.asarray(rng.random(S) < 0.7)
    st = k.start_slot(st, mask, jnp.asarray(rng.integers(0, 2, (S, R)).astype(np.int8)))
    st = st._replace(slot=jnp.asarray(
        rng.integers(2**31 - 3, 2**31, S).astype(np.int64).astype(np.int32)))
    alive = jnp.asarray(rng.random((S, R)) < 0.8)
    st = k.run_rounds(st, alive, int(rng.integers(0, 4)), jax.random.key(seed), p_deliver=0.7)
    return k, st


@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 7, 8, 64])
def test_start_slot_header_matches_reference(host, R):
    S = 9 if R == 64 else 37
    rk, st = _mid_state(R, S, R)
    rng = np.random.default_rng(100 + R)
    for _ in range(3):
        mask = rng.random(S) < 0.5
        votes = rng.integers(0, 4, (S, R)).astype(np.int8)
        fields = {f: np.asarray(getattr(st, f)) for f in FIELDS}
        st = rk.start_slot(st, jnp.asarray(mask), jnp.asarray(votes))
        want = {f: np.asarray(getattr(st, f)) for f in FIELDS}
        for in_place in (False, True):
            got = host.start_slot(fields, mask, votes, in_place)
            for f in FIELDS:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f"R={R} {f}")
        # the port's plain version and its CPU dispatch
        pk = ClusterKernel(S, R, seed=R, device="cpu")
        from rabia_tpu_torch import convert

        pst = convert.cluster_state_from_numpy(fields, "cpu")
        for fn in (pk.start_slot, pk.start_slot_plain):
            got = fn(pst, torch.from_numpy(mask), torch.from_numpy(votes))
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(got, f).numpy(), want[f], err_msg=f)


def test_wrappers_refuse_cpu_tensors():
    codes = torch.zeros((2, 17), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        packed_window.PACKERS.pack_codes(codes)
    with pytest.raises(ValueError, match="bool"):
        packed_window.PACKERS.pack_alive(codes)
    with pytest.raises(ValueError, match="contiguous"):
        packed_window.PACKERS.pack_codes(torch.zeros((4, 17), dtype=torch.int8).t())
    k = ClusterKernel(4, 3, device="cpu")
    st = k.init_state()
    with pytest.raises(ValueError, match="CUDA"):
        cluster_round.CLUSTER_ROUND.start_slot(
            list(st), torch.ones(4, dtype=torch.bool), torch.zeros((4, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="votes"):
        cluster_round.CLUSTER_ROUND.start_slot(
            list(st), torch.ones(4, dtype=torch.bool), torch.zeros((4, 2), dtype=torch.int8))
    assert packed_window.PACKERS.launches == 0
    assert cluster_round.CLUSTER_ROUND.counts["start_slot"] == 0


@pytest.mark.cuda
def test_packers_and_start_slot_on_card_match_plain():
    """The kernels against the plain versions on the card (needs a card
    and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the packer kernels run only on a card")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for shape in ((5, 1000), (3, 4096), (17,)):
        codes = torch.from_numpy(rng.integers(0, 4, shape).astype(np.int8)).to(dev)
        alive = torch.from_numpy(rng.random(shape) < 0.6).to(dev)
        p = packed_window.pack_codes(codes)
        assert torch.equal(p, packed_window.pack_codes_plain(codes))
        assert torch.equal(packed_window.pack_alive(alive), packed_window.pack_alive_plain(alive))
        assert torch.equal(packed_window.unpack_codes(p, shape[-1]), codes)
        both = packed_window.pack_inputs(codes, alive)
        assert torch.equal(both[0], p)
        assert torch.equal(both[1], packed_window.pack_alive_plain(alive))
    k = ClusterKernel(100, 5, device=dev)
    st = k.init_state()
    mask = torch.from_numpy(rng.random(100) < 0.5).to(dev)
    votes = torch.from_numpy(rng.integers(0, 4, (100, 5)).astype(np.int8)).to(dev)
    for a, b in zip(k.start_slot(st, mask, votes), k.start_slot_plain(st, mask, votes)):
        assert torch.equal(a, b)
