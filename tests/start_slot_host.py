"""The g++ build of ``csrc/cluster_round.cuh``'s ``start_slot`` (``cr::ss``)
for the CPU tests: every launch that ``cr_start_slot_blocks`` would make
(``cr::ss::launches`` plans them), each run thread by thread over its
grid on the host, on the pointer table the port's wrapper fills
(``cluster_round.StartSlotTable``)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from rabia_tpu_torch.kernel import cluster_round, cuda_build

SHIM = r"""
#include "cluster_round.cuh"
extern "C" int cr_host_start_slot_blocks(int nblk, void* const* in, void* const* out,
                                         const void* const* masks, const void* const* votes,
                                         long long S, int R) {
    return cr::ss::launches(nblk, in, out, masks, votes, S, R,
                            [](const cr::ss::Args& a, uint32_t grid_x) {
        for (int b = 0; b < a.nblk; ++b)
            for (uint32_t c = 0; c < grid_x; ++c)
                for (int t = 0; t < cr::ss::THREADS; ++t) cr::ss::thread(a, c, b, t);
    });
}
"""


class StartSlotHost:
    def __init__(self, lib_path) -> None:
        lib = ctypes.CDLL(str(lib_path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cr_host_start_slot_blocks.argtypes = [I, P, P, P, P, ctypes.c_longlong, I]
        lib.cr_host_start_slot_blocks.restype = I
        self.lib = lib

    def run(self, blocks, out=None) -> tuple[list, int]:
        """``start_slot`` on ``blocks`` (``(fields, mask, votes)`` CPU
        tensors, as ``ClusterRoundKernel.start_slot_blocks`` takes them):
        each block's 13 fields after it and the launches the card would
        make."""
        table, outs = cluster_round.ClusterRoundKernel().table(blocks, out)
        n = self.lib.cr_host_start_slot_blocks(table.nblk, table.ins, table.outs, table.masks,
                                               table.votes, table.S, table.R)
        assert n >= 0, "the launch plan refused the shape"
        return outs, n


def build(tmp_path_factory, name: str, max_plane: int = 0) -> StartSlotHost:
    """Compile the shim (``max_plane``: a smaller byte limit a plane of a
    table entry, so that large blocks are cut as on the card)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp(name)
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libstart_slot_host.so"
    flags = [f"-DCR_SS_MAX_PLANE={max_plane}u"] if max_plane else []
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", *flags, f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    return StartSlotHost(lib)


def random_state_fields(rng, S: int, R: int) -> dict:
    """A ClusterState's fields (numpy, by name) over every protocol value:
    slots about 2^31-1 (some wrap when bumped), phases, stages, all four
    vote codes, decided phases, done and active flags."""
    u32 = rng.integers(2**31 - 3, 2**31 + 3, S).astype(np.uint32)
    return {
        "slot": u32.view(np.int32), "phase": rng.integers(0, 9, (S, R)).astype(np.int32),
        "stage": rng.integers(0, 2, (S, R)).astype(np.int8),
        **{f: rng.integers(0, 4, (S, R)).astype(np.int8)
           for f in ("my_r1", "my_r2", "prev_r1", "prev_r2")},
        **{f: rng.integers(0, 4, (S, R, R)).astype(np.int8) for f in ("led1", "led2")},
        "decided": rng.integers(0, 4, S).astype(np.int8),
        "decided_phase": rng.integers(-1, 9, S).astype(np.int32),
        "done": rng.random((S, R)) < 0.3, "active": rng.random(S) < 0.7,
    }
