"""The fused fault-free window: the port's plain versions, the per-element
math of both CUDA kernels (replica-major, and [T, S, R] with its
in-register transposition; built for the host with g++), and the kernel
wrappers' argument checks, all against the reference closed form and its
Pallas kernels in interpret mode. Tolerance: exact equality (every output
is an integer code)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rabia_tpu.kernel import fused_window as ref_fw
from rabia_tpu.kernel.phase_driver import ClusterKernel as RefClusterKernel
from rabia_tpu_torch.kernel import cuda_build
from rabia_tpu_torch.kernel import fused_window as fw
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

# (S, R) of tests/test_kernel.py::test_slot_pipeline_fused_bit_identical
CASES = [(8, 1), (16, 3), (24, 4), (128, 5), (32, 7)]


def _case(S, R, T=8, seed=11):
    rng = np.random.default_rng(seed + 31 * S + R)
    votes = rng.choice([0, 1, 2, 3], size=(T, S, R), p=[0.3, 0.4, 0.15, 0.15]).astype(np.int8)
    alive = rng.random((S, R)) > 0.3
    return votes, alive


@pytest.mark.parametrize("S,R", CASES)
def test_plain_versions_match_reference_and_pallas(S, R):
    votes, alive = _case(S, R)
    T = votes.shape[0]
    q = RefClusterKernel(S, R).quorum
    jv, ja = jnp.asarray(votes), jnp.asarray(alive)
    want_d, want_p = (np.asarray(x) for x in ref_fw.closed_form_window(jv, ja, q))
    pal_d, pal_p = (np.asarray(x) for x in ref_fw.pallas_window(jv, ja, q, interpret=True))
    np.testing.assert_array_equal(pal_d, want_d)
    np.testing.assert_array_equal(pal_p, want_p)

    tv, ta = torch.from_numpy(votes), torch.from_numpy(alive)
    d, p = fw.closed_form_window(tv, ta, q)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(p.numpy(), want_p)

    v_rm, a_rm = np.ascontiguousarray(votes.transpose(2, 0, 1)), np.ascontiguousarray(alive.T)
    ref_rm = ref_fw.pallas_window_rmajor(
        jnp.asarray(v_rm), jnp.asarray(a_rm), q, interpret=True, want_phase=False
    )
    np.testing.assert_array_equal(np.asarray(ref_rm), want_d)
    tv_rm, ta_rm = torch.from_numpy(v_rm), torch.from_numpy(a_rm)
    d, p = fw.closed_form_window_rmajor(tv_rm, ta_rm, q)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(p.numpy(), want_p)
    d = fw.closed_form_window_rmajor(tv_rm, ta_rm, q, want_phase=False)
    np.testing.assert_array_equal(d.numpy(), want_d)

    # the ClusterKernel entries take the plain path for CPU tensors
    k = ClusterKernel(S, R, device="cpu")
    d, p = k.slot_pipeline_fused(tv, ta, T)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(p.numpy(), want_p)
    d = k.slot_pipeline_fused_rmajor(tv_rm, ta_rm, T, want_phase=False)
    np.testing.assert_array_equal(d.numpy(), want_d)


_HOST_SHIM = r"""
#include "fused_window.cuh"
extern "C" void rw_window_host(const int8_t* votes, const uint8_t* alive,
                               int8_t* dec, int32_t* ph, int R, long long T,
                               long long S, int q) {
    for (long long t = 0; t < T; ++t)
        for (long long s0 = 0; s0 < S; s0 += rw::LANES) {
            int n = (int)(S - s0 < rw::LANES ? S - s0 : rw::LANES);
            rw::window_chunk_bytes(votes + t * S + s0, T * S, alive + s0, S, R, n,
                                   (uint32_t)q, dec + t * S + s0,
                                   ph ? ph + t * S + s0 : nullptr);
        }
}
"""


@pytest.fixture(scope="module")
def host_window(tmp_path_factory):
    """The kernel's per-element header compiled for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("fw_host")
    src = d / "shim.cpp"
    src.write_text(_HOST_SHIM)
    lib = d / "libfw_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    fn = ctypes.CDLL(str(lib)).rw_window_host
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ]
    fn.restype = None

    def run(votes_rm: np.ndarray, alive_rm: np.ndarray, q: int, want_phase=True):
        R, T, S = votes_rm.shape
        votes_rm = np.ascontiguousarray(votes_rm, np.int8)
        alive_u8 = np.ascontiguousarray(alive_rm, np.uint8)
        dec = np.empty((T, S), np.int8)
        ph = np.empty((T, S), np.int32) if want_phase else None
        fn(votes_rm.ctypes.data, alive_u8.ctypes.data, dec.ctypes.data,
           ph.ctypes.data if ph is not None else None, R, T, S, q)
        return dec, ph

    return run


@pytest.mark.parametrize("S,R", CASES + [(17, 5), (1000, 5), (5, 8), (33, 2)])
def test_kernel_math_host_build_matches_reference(host_window, S, R):
    votes, alive = _case(S, R, T=7)
    v_rm, a_rm = votes.transpose(2, 0, 1), alive.T
    for q in sorted({1, R // 2 + 1, R, R + 1}):
        want_d, want_p = (
            np.asarray(x) for x in ref_fw.closed_form_window(jnp.asarray(votes), jnp.asarray(alive), q)
        )
        dec, ph = host_window(v_rm, a_rm, q)
        np.testing.assert_array_equal(dec, want_d, err_msg=f"q={q}")
        np.testing.assert_array_equal(ph, want_p, err_msg=f"q={q}")
        dec, ph = host_window(v_rm, a_rm, q, want_phase=False)
        assert ph is None
        np.testing.assert_array_equal(dec, want_d, err_msg=f"q={q}")


def test_kernel_math_counts_only_exact_codes(host_window):
    # bytes other than the four codes (e.g. 0x81, 0x01|0x80) must count as
    # neither V0 nor V1: the SWAR byte compare is exact
    R, T, S = 5, 2, 16
    votes = np.full((R, T, S), 0x81 - 256, np.int8)
    votes[:, 1, :] = 1
    alive = np.ones((R, S), bool)
    dec, ph = host_window(votes, alive, 3)
    assert np.all(dec[0] == 3) and np.all(ph[0] == -1)
    assert np.all(dec[1] == 1) and np.all(ph[1] == 0)


_TSR_SHIM = r"""
#include "fused_window.cuh"
template <int R>
void tsr(const int8_t* votes, const uint8_t* alive, int8_t* dec, int32_t* ph, long long T,
         long long S, int q) {
    for (long long t = 0; t < T; ++t)
        for (long long s0 = 0; s0 < S; s0 += rw::LANES) {
            int n = (int)(S - s0 < rw::LANES ? S - s0 : rw::LANES);
            rw::tsr_chunk_bytes<R>(votes + (t * S + s0) * R, alive + s0 * R, n, (uint32_t)q,
                                   dec + t * S + s0, ph ? ph + t * S + s0 : nullptr);
        }
}
extern "C" void rw_tsr_host(const int8_t* votes, const uint8_t* alive, int8_t* dec, int32_t* ph,
                            int R, long long T, long long S, int q) {
    switch (R) {
        case 1: tsr<1>(votes, alive, dec, ph, T, S, q); break;
        case 2: tsr<2>(votes, alive, dec, ph, T, S, q); break;
        case 3: tsr<3>(votes, alive, dec, ph, T, S, q); break;
        case 4: tsr<4>(votes, alive, dec, ph, T, S, q); break;
        case 5: tsr<5>(votes, alive, dec, ph, T, S, q); break;
        case 6: tsr<6>(votes, alive, dec, ph, T, S, q); break;
        case 7: tsr<7>(votes, alive, dec, ph, T, S, q); break;
        default: tsr<8>(votes, alive, dec, ph, T, S, q); break;
    }
}
extern "C" unsigned rw_byte_perm_host(unsigned x, unsigned y, unsigned s) {
    return rw::byte_perm(x, y, s);
}
"""


@pytest.fixture(scope="module")
def host_tsr(tmp_path_factory):
    """The [T, S, R] kernel's transposition and tally (fused_window.cuh)
    compiled for the host with g++: ``run(votes i8[T, S, R], alive bool[S,
    R], q, want_phase, offset) -> (dec, ph)``, the votes placed
    ``offset`` bytes into a buffer."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("tsr_host")
    (d / "shim.cpp").write_text(_TSR_SHIM)
    lib = d / "libtsr_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    so = ctypes.CDLL(str(lib))
    fn = so.rw_tsr_host
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ]
    fn.restype = None
    so.rw_byte_perm_host.argtypes = [ctypes.c_uint] * 3
    so.rw_byte_perm_host.restype = ctypes.c_uint

    def run(votes: np.ndarray, alive: np.ndarray, q: int, want_phase=True, offset=0):
        T, S, R = votes.shape
        buf = np.zeros(votes.nbytes + offset + 16, np.int8)
        v = buf[offset: offset + votes.nbytes]
        v[:] = votes.reshape(-1)
        alive_u8 = np.ascontiguousarray(alive, np.uint8)
        dec = np.empty((T, S), np.int8)
        ph = np.empty((T, S), np.int32) if want_phase else None
        fn(v.ctypes.data, alive_u8.ctypes.data, dec.ctypes.data,
           ph.ctypes.data if ph is not None else None, R, T, S, q)
        return dec, ph

    run.byte_perm = so.rw_byte_perm_host
    return run


def test_byte_perm_host_emulation(host_tsr):
    """The host build's ``byte_perm`` follows ``__byte_perm``: byte n of
    the result is byte (s >> 4n) & 7 of the eight bytes y:x."""
    rng = np.random.default_rng(5)
    for x, y, s in rng.integers(0, 2**32, size=(64, 3), dtype=np.uint64).tolist():
        b = (y << 32 | x).to_bytes(8, "little")
        want = bytes(b[(s >> (4 * n)) & 7] for n in range(4))
        assert host_tsr.byte_perm(x, y, s) == int.from_bytes(want, "little")


@pytest.mark.parametrize("R", range(1, 9))
def test_tsr_math_host_build_matches_reference_and_pallas(host_tsr, R):
    rng = np.random.default_rng(100 + R)
    for S, T in ((17, 5), (1000, 3), (4096, 1)):
        votes = rng.choice([0, 1, 2, 3], size=(T, S, R), p=[0.3, 0.4, 0.15, 0.15]).astype(np.int8)
        votes[rng.random(votes.shape) < 0.02] = -127  # a byte that is no code: counts as neither
        alive = rng.random((S, R)) > 0.3
        jv, ja = jnp.asarray(votes), jnp.asarray(alive)
        for q in sorted({1, R // 2 + 1, R}):
            want_d, want_p = (np.asarray(x) for x in ref_fw.closed_form_window(jv, ja, q))
            if q == R // 2 + 1:  # the interpret-mode Pallas kernel at the majority quorum
                pal_d, pal_p = (np.asarray(x) for x in ref_fw.pallas_window(jv, ja, q, interpret=True))
                np.testing.assert_array_equal(pal_d, want_d)
                np.testing.assert_array_equal(pal_p, want_p)
            for offset in (0, 1):
                dec, ph = host_tsr(votes, alive, q, offset=offset)
                np.testing.assert_array_equal(dec, want_d, err_msg=f"S={S} q={q} offset={offset}")
                np.testing.assert_array_equal(ph, want_p, err_msg=f"S={S} q={q} offset={offset}")
            dec, ph = host_tsr(votes, alive, q, want_phase=False)
            assert ph is None
            np.testing.assert_array_equal(dec, want_d)


class TestWrapperChecks:
    def _args(self, R=5, T=4, S=32):
        return torch.zeros((R, T, S), dtype=torch.int8), torch.ones((R, S), dtype=torch.bool)

    def test_rejects_wrong_dtype(self):
        v, a = self._args()
        with pytest.raises(ValueError, match="int8"):
            fw.FUSED_WINDOW(v.to(torch.int32), a, 3)
        with pytest.raises(ValueError, match="bool"):
            fw.FUSED_WINDOW(v, a.to(torch.uint8), 3)

    def test_rejects_wrong_layout(self):
        v, a = self._args()
        with pytest.raises(ValueError, match="int8\\[R, T, S\\]"):
            fw.FUSED_WINDOW(v[0], a, 3)
        with pytest.raises(ValueError, match="contiguous"):
            fw.FUSED_WINDOW(v.transpose(1, 2).contiguous().transpose(1, 2), a, 3)
        with pytest.raises(ValueError, match="bool\\[5, 32\\]"):
            fw.FUSED_WINDOW(v, a.t(), 3)

    def test_rejects_too_many_replicas_and_bad_quorum(self):
        v, a = self._args(R=9)
        with pytest.raises(ValueError, match="1..8 replicas"):
            fw.FUSED_WINDOW(v, a, 5)
        v, a = self._args()
        with pytest.raises(ValueError, match="quorum"):
            fw.FUSED_WINDOW(v, a, 0)

    def test_cpu_tensor_never_reaches_the_kernel(self):
        v, a = self._args()
        before = fw.FUSED_WINDOW.launches
        with pytest.raises(ValueError, match="CUDA tensor"):
            fw.FUSED_WINDOW(v, a, 3)
        d = fw.window_rmajor(v, a, 3, want_phase=False)  # plain path
        assert d.shape == (4, 32)
        assert fw.FUSED_WINDOW.launches == before


class TestTSRWrapperChecks:
    def _args(self, T=4, S=32, R=5):
        return torch.zeros((T, S, R), dtype=torch.int8), torch.ones((S, R), dtype=torch.bool)

    def test_rejects_wrong_dtype_and_shape(self):
        v, a = self._args()
        with pytest.raises(ValueError, match="int8\\[T, S, R\\]"):
            fw.FUSED_WINDOW_TSR(v.to(torch.int32), a, 3)
        with pytest.raises(ValueError, match="int8\\[T, S, R\\]"):
            fw.FUSED_WINDOW_TSR(v[0], a, 3)
        with pytest.raises(ValueError, match="bool\\[32, 5\\]"):
            fw.FUSED_WINDOW_TSR(v, a.to(torch.uint8), 3)
        with pytest.raises(ValueError, match="bool\\[32, 5\\]"):
            fw.FUSED_WINDOW_TSR(v, a.t(), 3)
        with pytest.raises(ValueError, match="contiguous"):
            fw.FUSED_WINDOW_TSR(v.transpose(0, 1).contiguous().transpose(0, 1), a, 3)

    def test_rejects_too_many_replicas_and_bad_quorum(self):
        v, a = self._args(R=9)
        with pytest.raises(ValueError, match="1..8 replicas"):
            fw.FUSED_WINDOW_TSR(v, a, 5)
        v, a = self._args()
        with pytest.raises(ValueError, match="quorum"):
            fw.FUSED_WINDOW_TSR(v, a, 0)
        with pytest.raises(ValueError, match="quorum"):
            fw.FUSED_WINDOW_TSR(v, a, 129)

    def test_cpu_tensor_never_reaches_the_kernel(self, monkeypatch):
        v, a = self._args()
        before = fw.FUSED_WINDOW_TSR.launches, fw.FUSED_WINDOW.launches
        with pytest.raises(ValueError, match="CUDA tensor"):
            fw.FUSED_WINDOW_TSR(v, a, 3)

        def no_kernel(*args, **kw):
            raise AssertionError("a kernel was called for CPU tensors")

        monkeypatch.setattr(fw, "FUSED_WINDOW_TSR", no_kernel)
        monkeypatch.setattr(fw, "FUSED_WINDOW", no_kernel)
        d, p = fw.window(v, a, 3)  # the plain path
        assert d.shape == (4, 32) and p.shape == (4, 32)
        d, p = ClusterKernel(32, 5, device="cpu").slot_pipeline_fused(v, a[0], 4)  # broadcast alive
        assert d.shape == (4, 32)
        monkeypatch.undo()
        assert (fw.FUSED_WINDOW_TSR.launches, fw.FUSED_WINDOW.launches) == before
        assert fw.FusedWindowTSRKernel()._fn is None  # nothing was built
