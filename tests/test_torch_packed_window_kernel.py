"""The packed-window kernel's per-word header against the reference's
``packed_window_rmajor`` and the port's plain version.

``csrc/packed_window.cuh`` is built for the host with g++ (both the
runtime-R path with seven counter planes and the per-R paths the kernel
takes for R <= 8) and run on the same packed words as the reference's
XLA program: R from 1 to 8 and 13, every quorum from below 0 to above
2^bit_length(R) - 1, random codes over all four values, crash masks and
ragged widths whose pad lanes must decide ABSENT. The wrapper's refusals
and the CPU dispatch are checked too; the kernel itself is held against
the plain version by the cuda-marked tests of test_torch_slice.py, which
import no jax. Tolerance: exact equality of the uint32 words."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rabia_tpu.kernel import packed_window as ref_pw
from rabia_tpu_torch.core.types import ABSENT, V0, V1
from rabia_tpu_torch.kernel import cuda_build
from rabia_tpu_torch.kernel import packed_window as pw
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

_HOST_SHIM = r"""
#include "packed_window.cuh"
template <int R>
static uint32_t fixed(const uint32_t* w, long long plane, const uint32_t* a, long long SW, int q) {
    return pw::decide_word<pw::cap_of(R)>(w, plane, a, SW, R, q);
}
extern "C" void pw_host(const uint32_t* votes, const uint32_t* alive, uint32_t* out, int R,
                        long long T, long long SW, int q, int per_r) {
    const long long plane = T * SW;
    for (long long t = 0; t < T; ++t)
        for (long long w = 0; w < SW; ++w) {
            const uint32_t* v = votes + t * SW + w;
            const uint32_t* a = alive + w;
            uint32_t d;
            switch (per_r ? R : 0) {
                case 1: d = fixed<1>(v, plane, a, SW, q); break;
                case 2: d = fixed<2>(v, plane, a, SW, q); break;
                case 3: d = fixed<3>(v, plane, a, SW, q); break;
                case 4: d = fixed<4>(v, plane, a, SW, q); break;
                case 5: d = fixed<5>(v, plane, a, SW, q); break;
                case 6: d = fixed<6>(v, plane, a, SW, q); break;
                case 7: d = fixed<7>(v, plane, a, SW, q); break;
                case 8: d = fixed<8>(v, plane, a, SW, q); break;
                default: d = pw::decide_word<pw::MAX_CAP>(v, plane, a, SW, R, q);
            }
            out[t * SW + w] = d;
        }
}
"""


@pytest.fixture(scope="module")
def host_window(tmp_path_factory):
    """The kernel's header compiled for the host with g++. Returns
    ``run(packed u32[R,T,SW], alive u32[R,SW], q, per_r) -> u32[T,SW]``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("pw_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libpw_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    fn = ctypes.CDLL(str(lib)).pw_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int]
    fn.restype = None

    def run(packed, alive, q, per_r=True):
        packed = np.ascontiguousarray(packed, np.uint32)
        alive = np.ascontiguousarray(alive, np.uint32)
        R, T, SW = packed.shape
        out = np.empty((T, SW), np.uint32)
        fn(packed.ctypes.data, alive.ctypes.data, out.ctypes.data, R, T, SW, q, int(per_r))
        return out

    return run


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _case(seed: int, R: int, T: int, S: int):
    """Codes over all four values (every third shard split V0/V1 only),
    crash masks with a dead replica and random deaths, packed by the
    reference; returns numpy uint32 words and the port's int32 tensors."""
    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 4, size=(R, T, S), dtype=np.int8)
    votes[:, :, 1::3] = rng.integers(0, 2, size=votes[:, :, 1::3].shape, dtype=np.int8)
    alive = rng.random((R, S)) < 0.75
    if R > 2:
        alive[-1] = False
    packed = np.asarray(ref_pw.pack_codes(jnp.asarray(votes)))
    alive_p = np.asarray(ref_pw.pack_alive(jnp.asarray(alive)))
    tp, ta = pw.pack_codes(torch.from_numpy(votes)), pw.pack_alive(torch.from_numpy(alive))
    np.testing.assert_array_equal(_u32(tp), packed)
    np.testing.assert_array_equal(_u32(ta), alive_p)
    return packed, alive_p, tp, ta


@pytest.mark.parametrize("S", [17, 50, 256])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 6, 7, 8])
def test_header_matches_reference_every_quorum(host_window, R, S):
    packed, alive_p, tp, ta = _case(100 * R + S, R, 5, S)
    for q in range(-1, (1 << R.bit_length()) + 1):  # q <= 0, every count, past 2^cap - 1
        want = np.asarray(ref_pw.packed_window_rmajor(jnp.asarray(packed), jnp.asarray(alive_p), q))
        np.testing.assert_array_equal(host_window(packed, alive_p, q), want, err_msg=f"q={q}")
        np.testing.assert_array_equal(host_window(packed, alive_p, q, per_r=False), want,
                                      err_msg=f"runtime R, q={q}")
        np.testing.assert_array_equal(_u32(pw.packed_window_rmajor(tp, ta, q)), want,
                                      err_msg=f"plain, q={q}")


def test_header_runtime_path_above_eight_replicas(host_window):
    R, S = 13, 40
    packed, alive_p, tp, ta = _case(13, R, 4, S)
    for q in (0, 1, 7, 13, 15, 16):
        want = np.asarray(ref_pw.packed_window_rmajor(jnp.asarray(packed), jnp.asarray(alive_p), q))
        np.testing.assert_array_equal(host_window(packed, alive_p, q, per_r=False), want)
        np.testing.assert_array_equal(_u32(pw.packed_window_rmajor(tp, ta, q)), want)


@pytest.mark.parametrize("per_r", [True, False])
def test_header_edges(host_window, per_r):
    """V1 wins where both planes reach the quorum; pad lanes (alive 0)
    decide ABSENT at q >= 1 and V1 at q <= 0, as the reference's do."""
    R, S = 2, 17  # one word and one lane of a second word; 15 pad lanes
    votes = np.full((R, 1, S), V0, np.int8)
    votes[0] = V1
    alive = np.ones((R, S), bool)
    packed = np.asarray(ref_pw.pack_codes(jnp.asarray(votes)))
    alive_p = np.asarray(ref_pw.pack_alive(jnp.asarray(alive)))
    for q in (0, 1, 2, 3, 4):
        got = host_window(packed, alive_p, q, per_r)
        want = np.asarray(ref_pw.packed_window_rmajor(jnp.asarray(packed), jnp.asarray(alive_p), q))
        np.testing.assert_array_equal(got, want)
        codes = pw.unpack_codes(torch.from_numpy(got.view(np.int32)), 32).numpy()
        if q == 0:
            assert (codes == V1).all()  # every lane, pads included
        elif q == 1:
            assert (codes[0, :S] == V1).all() and (codes[0, S:] == ABSENT).all()
        else:
            assert (codes == ABSENT).all()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    K = pw.PACKED_WINDOW
    good = torch.zeros((5, 3, 4), dtype=torch.int32)
    alive = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        K(good.to(torch.int64), alive, 3)
    with pytest.raises(ValueError, match="replicas"):
        K(torch.zeros((128, 3, 4), dtype=torch.int32), torch.zeros((128, 4), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="alive_packed"):
        K(good, torch.zeros((5, 5), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="contiguous"):
        K(good.transpose(1, 2).contiguous().transpose(1, 2), alive, 3)
    with pytest.raises(ValueError, match="CUDA"):
        K(good, alive, 3)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    S, R, T = 100, 5, 6
    k = ClusterKernel(S, R, seed=0, device="cpu")
    votes = torch.from_numpy(rng.integers(0, 4, size=(R, T, S), dtype=np.int8))
    alive = torch.from_numpy(rng.random((R, S)) < 0.8)
    before = pw.PACKED_WINDOW.launches
    got = k.slot_pipeline_fused_packed(pw.pack_codes(votes), pw.pack_alive(alive), T)
    assert pw.PACKED_WINDOW.launches == before  # no kernel on the CPU
    want = k.slot_pipeline_fused_rmajor(votes, alive, T, want_phase=False)
    assert torch.equal(pw.unpack_codes(got, S), want)
