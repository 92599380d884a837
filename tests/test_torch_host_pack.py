"""The port's native pack gather (``csrc/host_pack.cpp``, built here with
g++) against the numpy gather and the reference's ``_native_pack_gather``.

The same full-width blocks, made from a seed with numpy (SET and mixed
SET/GET/DEL/EXISTS windows, keys of 1..32 bytes, values of several width
buckets), go through the port's C gather, the port's numpy gather
(``RABIA_PY_DEVPACK=1``) and the reference's ``DeviceKVTable`` with its
own C gather (``rabia_tpu/native/hostkernel.cpp``'s ``rk_pack_gather``);
every plane is compared byte for byte, and each C gather is asserted to
have served the window. Then the rules around it: a bounds trip re-zeroes
the planes and hands the window to numpy; only ``RABIA_PY_DEVPACK=1``
opts out; a window that is not a grid takes numpy; a library that cannot
be built raises. Tolerance: exact (bytes and counts).
"""

from __future__ import annotations

import numpy as np
import pytest

from rabia_tpu.apps.device_kv import DeviceKVTable as RefTable
from rabia_tpu.core.blocks import build_block as ref_build_block
from rabia_tpu.native.build import load_hostkernel
from rabia_tpu.parallel.mesh import MeshPhaseKernel as RefMeshPhaseKernel
from rabia_tpu.parallel.mesh import make_mesh
from rabia_tpu_torch.apps import device_kv
from rabia_tpu_torch.apps.device_kv import DeviceKVTable
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.kernel import cuda_build
from rabia_tpu_torch.parallel.mesh import MeshPhaseKernel

N, R = 8, 3


def _op(code: int, key: bytes, val: bytes = b"") -> bytes:
    return bytes((code,)) + len(key).to_bytes(2, "little") + key + val


def _window(rng, waves: int, mixed: bool, vmax: int) -> list:
    """``waves`` full-width blocks: keys of 1..32 bytes, SET values of
    0..vmax bytes; in a mixed window a third of the ops read or delete."""
    out = []
    for w in range(waves):
        cmds = []
        for s in range(N):
            key = bytes(rng.integers(97, 123, int(rng.integers(1, 33)), dtype=np.uint8))
            code = int(rng.choice([1, 1, 1, 2, 3, 4])) if mixed else 1
            val = bytes(rng.integers(0, 256, int(rng.integers(0, vmax + 1)), dtype=np.uint8))
            cmds.append([_op(code, key, val if code == 1 else b"")])
        out.append((list(range(N)), cmds))
    return out


@pytest.fixture(scope="module")
def ref_table():
    if load_hostkernel() is None:
        pytest.skip("the reference's native host kernel does not build here")
    return RefTable(N, RefMeshPhaseKernel(N, R, make_mesh()))


@pytest.fixture
def table(monkeypatch):
    monkeypatch.delenv("RABIA_PY_DEVPACK", raising=False)
    return DeviceKVTable(N, MeshPhaseKernel(N, R, device="cpu"))


def _spy(monkeypatch, cls):
    engaged = []
    orig = cls._native_pack_gather

    def spy(self_, *a, **kw):
        r = orig(self_, *a, **kw)
        engaged.append(r)
        return r

    monkeypatch.setattr(cls, "_native_pack_gather", spy)
    return engaged


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("vmax", [0, 3, 17, 64])
def test_native_gather_matches_numpy_and_the_reference(table, ref_table, monkeypatch, seed,
                                                       mixed, vmax):
    rng = np.random.default_rng(seed * 100 + vmax)
    stream = _window(rng, int(rng.integers(1, 7)), mixed, vmax)
    blocks = [build_block(s, c) for s, c in stream]
    ref_blocks = [ref_build_block(s, c) for s, c in stream]
    allow = "mixed" if mixed else "set"
    port_engaged = _spy(monkeypatch, DeviceKVTable)
    ref_engaged = _spy(monkeypatch, RefTable)
    native = table._gather_window(blocks, allow)
    ref_native = ref_table._gather_window(ref_blocks, allow)
    assert port_engaged == [True] and ref_engaged == [True], "a C gather did not serve"
    assert table.pack_stats == {"native": 1, "numpy": 0, "bounds_trip": 0}
    monkeypatch.setenv("RABIA_PY_DEVPACK", "1")
    numpy = table._gather_window(blocks, allow)
    assert port_engaged == [True, False]
    assert table.pack_stats == {"native": 1, "numpy": 1, "bounds_trip": 0}
    assert len(native) == len(numpy) == len(ref_native) == 5
    for a, b, c in zip(native, numpy, ref_native):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape
        assert a.tobytes() == b.tobytes() == c.tobytes()


def test_bounds_trip_rezeroes_and_hands_over_to_numpy(table, monkeypatch):
    rng = np.random.default_rng(7)
    blocks = [build_block(s, c) for s, c in _window(rng, 4, True, 40)]
    monkeypatch.setenv("RABIA_PY_DEVPACK", "1")
    want = table._gather_window(blocks, "mixed")
    monkeypatch.delenv("RABIA_PY_DEVPACK")
    # the C function sees a buffer shorter than it is: the ops before the
    # cut are written, then the check trips on the first op past it
    fn = device_kv.HOST_PACK.load()
    seen = []

    def short(dbuf, dbuf_len, *rest):
        seen.append(dbuf_len)
        return fn(dbuf, dbuf_len // 2, *rest)

    monkeypatch.setattr(device_kv.HOST_PACK, "_fn", short)
    got = table._gather_window(blocks, "mixed")
    assert seen, "the C gather was not called"
    assert table.pack_stats == {"native": 0, "numpy": 2, "bounds_trip": 1}
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    # the trip itself: a False return, the written planes zeroed again
    kwin = np.zeros((4, N, 32), np.uint8)
    vwin = np.zeros((4, N, 64), np.uint8)
    dbuf = np.full(64, 7, np.uint8)
    off = np.zeros(4 * N, np.int64)
    off[-1] = 1000  # the last op lies past the buffer
    klen = np.full(4 * N, 4, np.int64)
    vlen = np.full(4 * N, 2, np.int64)
    monkeypatch.setattr(device_kv.HOST_PACK, "_fn", fn)
    assert not table._native_pack_gather(dbuf, off, klen, vlen, N, kwin, vwin)
    assert not kwin.any() and not vwin.any()
    assert table.pack_stats["bounds_trip"] == 2
    klen[0] = 33  # a key past the plane's width trips too
    off[-1] = 0
    assert not table._native_pack_gather(dbuf, off, klen, vlen, N, kwin, vwin)
    assert not kwin.any()
    klen[0] = 4
    assert table._native_pack_gather(dbuf, off, klen, vlen, N, kwin, vwin)
    assert (kwin[..., :4] == 7).all() and not kwin[..., 4:].any()
    assert (vwin[..., :2] == 7).all() and not vwin[..., 2:].any()


@pytest.mark.parametrize("value,native", [("1", False), ("0", True), ("", True), ("yes", True)])
def test_only_devpack_1_opts_out(table, monkeypatch, value, native):
    rng = np.random.default_rng(3)
    blocks = [build_block(s, c) for s, c in _window(rng, 3, False, 20)]
    monkeypatch.setenv("RABIA_PY_DEVPACK", value)
    loads = []
    real_load = device_kv.HOST_PACK.load
    monkeypatch.setattr(device_kv.HOST_PACK, "load", lambda: loads.append(1) or real_load())
    table.pack_window_auto(blocks)
    assert table.pack_stats["native"] == int(native)
    assert table.pack_stats["numpy"] == int(not native)
    assert bool(loads) == native  # an opted-out window never touches the library


def test_a_partial_block_takes_the_numpy_gather(table):
    blocks = [build_block([1, 4, 6], [[_op(1, b"k", b"v")], [_op(1, b"kk", b"")],
                                      [_op(1, b"a" * 9, b"z" * 20)]])]
    assert table.pack_window(blocks) is not None
    assert table.pack_stats == {"native": 0, "numpy": 1, "bounds_trip": 0}


def test_a_library_that_cannot_build_raises(table, monkeypatch):
    monkeypatch.setattr(cuda_build, "CXX", "/nonexistent/bin/g++")
    monkeypatch.setattr(device_kv.HOST_PACK, "_fn", None)
    assert not cuda_build.host_library_path("host_pack").exists()
    blocks = [build_block(list(range(N)), [[_op(1, b"k%d" % s, b"v")] for s in range(N)])]
    with pytest.raises(RuntimeError, match="host compiler"):
        table.pack_window(blocks)
    assert table.pack_stats == {"native": 0, "numpy": 0, "bounds_trip": 0}
    monkeypatch.setenv("RABIA_PY_DEVPACK", "1")  # the opt-out never builds
    assert table.pack_window(blocks) is not None


def test_the_library_is_built_under_a_digest_of_its_source_and_flags(monkeypatch):
    path = cuda_build.host_library_path("host_pack")
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libhost_pack-")
    monkeypatch.setattr(cuda_build, "CXX_FLAGS", (*cuda_build.CXX_FLAGS, "-g"))
    assert cuda_build.host_library_path("host_pack") != path
    # the CUDA sources' digest covers csrc/*.cu*, not the host source
    assert all(not p.name.endswith(".cpp") for p in cuda_build.CSRC.glob("*.cu*"))
