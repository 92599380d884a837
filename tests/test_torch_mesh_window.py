"""The mesh-window kernel's per-(slot, shard) header against the
reference's ``MeshPhaseKernel.slot_window`` and ``slot_pipeline`` and the
port's plain window.

``csrc/mesh_window.cuh`` is built for the host with g++ and run on the
same inputs as the reference's XLA programs (on its 8-device CPU test
mesh) and the port's plain loop over ``phase_step``: votes split over all
four codes (so the common coin decides), crash masks with a quorum-less
shard, coin probabilities 0, 0.5 and 1, and per-shard bases near 2^31-1
so that ``base + t`` wraps. The wrapper's refusals and the CPU dispatch
are checked too, and the one-device engine's staging ring (a window's
votes, alive rows, bases and decisions in one host buffer, which a card
maps; on the CPU the plain loop runs on views of it): two windows in
flight decide and settle as the reference's engine, and a buffer whose
window is unread is not handed out again. The mapped launch itself is
held against the plain loop on a card (the cuda-marked test). Tolerance:
exact equality (decisions are codes)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rabia_tpu.apps.vector_kv import VectorShardedKV as RefVKV
from rabia_tpu.core.blocks import build_block as ref_build_block
from rabia_tpu.parallel import MeshEngine as RefEngine
from rabia_tpu.parallel import MeshPhaseKernel as RefMesh
from rabia_tpu.parallel import make_mesh
from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.core.types import ABSENT, V1, f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cuda_build, mesh_window
from rabia_tpu_torch.kernel.phase_driver import coin_threshold
from rabia_tpu_torch.parallel import MeshEngine, MeshPhaseKernel

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

S, T = 16, 6  # S fills the reference's 8-device CPU mesh

_HOST_SHIM = r"""
#include "mesh_window.cuh"
extern "C" void mw_host(const int8_t* votes, const uint8_t* alive, const int32_t* base,
                        int8_t* out, long long T, long long S, int R, int quorum, int f1,
                        unsigned seed, unsigned threshold, int max_phases) {
    for (int t = 0; t < T; ++t)
        for (long long s = 0; s < S; ++s)
            out[t * S + s] = mw::decide_entry(votes, alive, base, S, R, t, s, quorum, f1,
                                              seed, threshold, max_phases);
}
"""


@pytest.fixture(scope="module")
def host_window(tmp_path_factory):
    """The kernel's header compiled for the host with g++. Returns
    ``run(votes, alive, base, seed, p1, max_phases) -> decided i8[T, S]``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("mw_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libmw_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    fn = ctypes.CDLL(str(lib)).mw_host
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_int]
    fn.restype = None

    def run(votes, alive, base, seed, p1, max_phases):
        votes = np.ascontiguousarray(votes, np.int8)
        alive = np.ascontiguousarray(alive, np.uint8)
        base = np.ascontiguousarray(base, np.int32)
        Tn, Sn, R = votes.shape
        out = np.empty((Tn, Sn), np.int8)
        fn(votes.ctypes.data, alive.ctypes.data, base.ctypes.data, out.ctypes.data, Tn, Sn, R,
           quorum_size(R), f_plus_1(R), seed & 0xFFFFFFFF, coin_threshold(p1), max_phases)
        return out

    return run


def _inputs(seed: int, R: int, Sn: int = S, Tn: int = T):
    """Votes over all four codes, a crash mask (a dead column, random
    deaths, shard 0 without a quorum) and bases near the int32 wrap on
    half the shards."""
    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 4, size=(Tn, Sn, R)).astype(np.int8)
    votes[:, 1::3] = rng.integers(0, 2, size=votes[:, 1::3].shape)  # split V0/V1: the coin
    alive = rng.random((Sn, R)) >= 0.2
    if R > 2:
        alive[:, -1] = False
    alive[0, : quorum_size(R)] = False  # shard 0 has lost its quorum
    base = rng.integers(0, 1000, size=Sn).astype(np.int64)
    base[::2] = 2**31 - 1 - rng.integers(0, Tn, size=base[::2].shape)
    return votes, alive, base.astype(np.int32)


@pytest.mark.parametrize("p1", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("R", [1, 3, 5, 7, 33])
def test_header_matches_reference_slot_window(host_window, R, p1):
    seed = 10 * R + int(2 * p1)
    votes, alive, base = _inputs(seed, R)
    ref = RefMesh(S, R, make_mesh(), coin_p1=p1, seed=seed)
    want = np.asarray(ref.slot_window(
        jnp.asarray(votes), ref.place(jnp.asarray(alive)), jnp.asarray(base),
        n_slots=T, max_phases=4,
    ))
    got = host_window(votes, alive, base, seed, p1, 4)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] == ABSENT).all()  # the quorum-less shard never decides


@pytest.mark.parametrize("max_phases", [1, 4])
def test_header_matches_reference_slot_pipeline(host_window, max_phases):
    R, seed, start = 5, 40 + max_phases, 2**31 - 3  # slot numbers wrap inside the window
    votes, alive, _ = _inputs(seed, R)
    ref = RefMesh(S, R, make_mesh(), seed=seed)
    want = np.asarray(ref.slot_pipeline(
        jnp.asarray(votes), ref.place(jnp.asarray(alive)), T,
        max_phases=max_phases, start_slot_index=start,
    ))
    got = host_window(votes, alive, np.full(S, start, np.int32), seed, 0.5, max_phases)
    np.testing.assert_array_equal(got, want)
    port = MeshPhaseKernel(S, R, seed=seed, device="cpu").slot_pipeline(
        torch.from_numpy(votes), torch.from_numpy(alive), T,
        max_phases=max_phases, start_slot_index=start,
    )
    np.testing.assert_array_equal(port.numpy(), want)


@pytest.mark.parametrize("p1", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("max_phases", [0, 1, 4])
@pytest.mark.parametrize("R", [1, 3, 4, 5, 7, 33, 64])
def test_header_matches_plain_window(host_window, R, max_phases, p1):
    seed = 7 * R + max_phases
    votes, alive, base = _inputs(seed, R, Sn=37, Tn=5)
    k = MeshPhaseKernel(37, R, coin_p1=p1, seed=seed, device="cpu")
    want = k.decide_slots_plain(
        torch.from_numpy(votes), torch.from_numpy(alive), torch.from_numpy(base), max_phases
    ).numpy()
    np.testing.assert_array_equal(host_window(votes, alive, base, seed, p1, max_phases), want)
    assert (want[:, 0] == ABSENT).all()  # the quorum-less shard never decides
    if max_phases == 0:
        assert (want == ABSENT).all()
    elif max_phases == 4 and p1 == 0.5:
        assert {0, 1} <= set(np.unique(want))  # the coin went both ways


def test_cpu_dispatch_takes_the_plain_loop(monkeypatch):
    R = 5
    votes, alive, base = _inputs(3, R)
    k = MeshPhaseKernel(S, R, seed=3, device="cpu")
    want = k.decide_slots_plain(
        torch.from_numpy(votes), torch.from_numpy(alive), torch.from_numpy(base), 4)
    calls = []
    plain = k.decide_slots_plain
    monkeypatch.setattr(k, "decide_slots_plain", lambda *a: calls.append(1) or plain(*a))

    def no_kernel(*a, **kw):
        raise AssertionError("the kernel was called for CPU tensors")

    monkeypatch.setattr(mesh_window, "MESH_WINDOW", no_kernel)
    got = k.slot_window(torch.from_numpy(votes), torch.from_numpy(alive),
                        torch.from_numpy(base), n_slots=T)
    assert torch.equal(got, want) and calls == [1]
    got = k.slot_pipeline(torch.from_numpy(votes), torch.from_numpy(alive), T)
    assert got.shape == (T, S) and calls == [1, 1]


def test_wrapper_refusals():
    kern = mesh_window.MeshWindowKernel()
    kw = dict(seed=0, coin_p1=0.5, max_phases=4)
    votes = torch.zeros((2, 3, 5), dtype=torch.int8)
    alive = torch.ones((3, 5), dtype=torch.bool)
    base = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="1..64 replicas"):
        kern(torch.zeros((2, 3, 65), dtype=torch.int8), torch.ones((3, 65), dtype=torch.bool),
             base, **kw)
    with pytest.raises(ValueError, match="votes must be int8"):
        kern(votes.to(torch.int32), alive, base, **kw)
    with pytest.raises(ValueError, match="votes must be int8"):
        kern(votes[0], alive, base, **kw)
    with pytest.raises(ValueError, match="alive must be bool"):
        kern(votes, alive.to(torch.int8), base, **kw)
    with pytest.raises(ValueError, match="alive must be bool"):
        kern(votes, alive[:2], base, **kw)
    with pytest.raises(ValueError, match="base_slots must be int32"):
        kern(votes, alive, base.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="max_phases"):
        kern(votes, alive, base, seed=0, coin_p1=0.5, max_phases=-1)
    with pytest.raises(ValueError, match="contiguous"):
        kern(votes.transpose(0, 1).contiguous().transpose(0, 1), alive, base, **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kern(votes, alive, base, **kw)
    assert kern.launches == 0 and kern._fn is None  # nothing was built or launched


# ---- a shard block over a mesh: replica blocks and the global shard base ----

_BLOCKS_SHIM = r"""
#include "mesh_window.cuh"
extern "C" void mw_host_blocks(const int8_t* votes, long long vstride, const uint8_t* alive,
                               long long astride, const int32_t* base, int8_t* out, int B,
                               long long T, long long S, int Rb, unsigned shard0, int quorum,
                               int f1, unsigned seed, unsigned threshold, int max_phases) {
    for (int t = 0; t < T; ++t)
        for (long long s = 0; s < S; ++s)
            out[t * S + s] = mw::decide_entry_blocks(votes, vstride, alive, astride, base, B, S,
                                                     Rb, t, s, shard0, quorum, f1, seed,
                                                     threshold, max_phases);
}
"""


@pytest.fixture(scope="module")
def host_blocks(tmp_path_factory):
    """``decide_entry_blocks`` built for the host with g++: ``run(votes,
    alive, base, shard0, seed, p1, max_phases)`` on a block's votes
    ``[B, T, S, Rb]`` and alive ``[B, S, Rb]`` tensors (views at any
    block stride, as the exchange leaves them)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("mw_blocks")
    (d / "shim.cpp").write_text(_BLOCKS_SHIM)
    lib = d / "libmw_blocks.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    fn = ctypes.CDLL(str(lib)).mw_host_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_int]
    fn.restype = None

    def run(votes, alive, base, shard0, seed, p1, max_phases):
        B, Tn, Sb, Rb, vstride, astride = mesh_window.MeshWindowKernel.blocks_of(votes, alive)
        base = np.ascontiguousarray(base, np.int32)
        out = np.empty((Tn, Sb), np.int8)
        R = B * Rb
        fn(votes.data_ptr(), vstride, alive.view(torch.uint8).data_ptr(), astride,
           base.ctypes.data, out.ctypes.data, B, Tn, Sb, Rb, shard0, quorum_size(R),
           f_plus_1(R), seed & 0xFFFFFFFF, coin_threshold(p1), max_phases)
        return out

    return run


@pytest.mark.parametrize("p1", [0.0, 0.5])
@pytest.mark.parametrize("a,b,R", [(2, 4, 4), (2, 4, 8), (4, 2, 6), (1, 8, 8), (8, 1, 5),
                                   (2, 1, 5)])
def test_header_blocks_match_reference_slot_window_on_the_mesh(host_blocks, a, b, R, p1):
    """Each shard block's window, read by the header straight from the
    layout that the port's exchange over the replica axis leaves (B = b
    replica blocks, each at the buffer's row stride), with its global
    shard base, equals the reference's ``slot_window`` on the same mesh
    shape over that block's columns; the coin is reached (split votes,
    4 phases) and the quorum-less shard never decides."""
    from rabia_tpu_torch.parallel import make_mesh as port_make_mesh

    seed = 100 * a + 10 * b + R + int(2 * p1)
    votes, alive, base = _inputs(seed, R)
    mesh = make_mesh(jax.devices()[: a * b], shard_axis_size=a, replica_axis_size=b)
    ref = RefMesh(S, R, mesh, coin_p1=p1, seed=seed)
    want = np.asarray(ref.slot_window(
        jnp.asarray(votes), ref.place(jnp.asarray(alive)), jnp.asarray(base),
        n_slots=T, max_phases=4,
    ))
    port = MeshPhaseKernel(S, R, port_make_mesh(["cpu"] * (a * b), a, b), coin_p1=p1, seed=seed)
    rows = port.exchange_window(votes, alive)
    Sb = S // a
    for i, (v, al) in rows.items():
        assert tuple(v.shape) == (b, T, Sb, R // b)
        cols = slice(i * Sb, (i + 1) * Sb)
        got = host_blocks(v, al, base[cols], i * Sb, seed, p1, 4)
        np.testing.assert_array_equal(got, want[:, cols], err_msg=f"shard block {i}")
        plain = port._decide_slots(v, al, torch.from_numpy(base[cols]), 4, shard0=i * Sb)
        np.testing.assert_array_equal(plain.numpy(), want[:, cols])
    assert (want[:, 0] == ABSENT).all()
    if p1 == 0.5:
        assert {0, 1} <= set(np.unique(want))


def test_blocked_wrapper_geometry_and_refusals():
    """The wrapper reads B, the block strides and shard0 from the
    exchange's views, and refuses what the kernel cannot take."""
    kern = mesh_window.MeshWindowKernel()
    buf = torch.zeros((4, 3 * 5 * 2 + 5 * 2), dtype=torch.uint8)
    votes = buf[:, :30].view(torch.int8).view(4, 3, 5, 2)
    alive = buf[:, 30:].view(torch.bool).view(4, 5, 2)
    assert kern.blocks_of(votes, alive) == (4, 3, 5, 2, 40, 40)
    assert kern.blocks_of(votes[:1], alive[:1]) == (1, 3, 5, 2, 0, 0)
    kw = dict(seed=0, coin_p1=0.5, max_phases=4)
    base = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="alive must be bool"):
        kern(votes, alive[:3], base, **kw)
    with pytest.raises(ValueError, match="1..64 replicas"):
        kern(torch.zeros((33, 3, 5, 2), dtype=torch.int8),
             torch.ones((33, 5, 2), dtype=torch.bool), base, **kw)
    with pytest.raises(ValueError, match="replica block contiguous"):
        kern(votes.transpose(2, 3), alive.transpose(1, 2), base, **kw)
    with pytest.raises(ValueError, match="shard0"):
        kern(votes, alive, base, shard0=-1, **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kern(votes, alive, base, shard0=5, **kw)
    assert kern.launches == 0 and kern._fn is None


# ---- the one-device engine's staging ring ---------------------------------


def _set_op(key: str, val: str) -> bytes:
    kb = key.encode()
    return bytes((1,)) + len(kb).to_bytes(2, "little") + kb + val.encode()


def _frames(res):
    return [[bytes(f) for f in g] for g in res]


def test_engine_ring_two_windows_in_flight_match_reference(monkeypatch):
    """The full-width lane dispatches the next window before it reads
    this one (two windows in flight on two staging buffers); a minority
    crash changes the alive rows under a dispatched speculative window
    (dropped, its buffer reused once it completes), a per-shard lane's
    windows take the ring's buffers too. Decisions, futures, slot
    counters and every replica's store equal the reference engine's."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    N, Rn, W = 16, 3, 2
    ref = RefEngine(lambda: RefVKV(N, capacity=1 << 10), N, Rn, mesh=make_mesh(), window=W)
    port = MeshEngine(lambda: VectorShardedKV(N, capacity=1 << 10), N, Rn, window=W,
                      device="cpu")
    futs = []

    def blocks(tag, n):
        for b in range(n):
            cmds = [[_set_op(f"k{s}", f"{tag}{b}")] for s in range(N)]
            futs.append((ref.submit_block(ref_build_block(range(N), cmds)),
                         port.submit_block(build_block(range(N), cmds))))

    blocks("a", 7)
    assert ref.flush() == port.flush()
    assert len(port._ring.stages) == 2 and port._ring.windows == port.cycles  # specs consumed
    for eng in (ref, port):
        eng.crash_replica(Rn - 1)
    blocks("b", 5)
    assert ref.flush() == port.flush()
    for eng in (ref, port):
        eng.heal_replica(Rn - 1)
    for s in (0, 5, N - 1):  # the per-shard lane
        futs.append((ref.submit([f"SET q{s} v"], s), port.submit([f"SET q{s} v"], s)))
    assert ref.flush() == port.flush()
    for fr, fp in futs:
        got, want = fp.result(), fr.result()
        assert (_frames(got) if isinstance(got[0], list) else got) == (
            _frames(want) if isinstance(want[0], list) else want)
    assert port.next_slot.tolist() == ref.next_slot.tolist()
    assert (port.decided_v1, port.decided_v0, port.cycles) == (
        ref.decided_v1, ref.decided_v0, ref.cycles)
    for s in range(N):
        logs = [{slot: v for slot, (v, _) in eng.decisions_for(s).items()} for eng in (ref, port)]
        assert logs[0] == logs[1], s
    want = ref.sms[0].store.snapshot_bytes()
    assert all(sm.store.snapshot_bytes() == want for sm in port.sms)
    assert len(port._ring.stages) == 2 and port._ring.mapped_bytes == 0  # nothing mapped here


def test_engine_ring_never_rewrites_an_unread_window():
    """A window held unfetched keeps its buffer: later windows take other
    buffers (the ring grows past its two when the caller holds more), and
    the held window's decisions, read last, are its own; once read (or
    dropped), its buffer goes out again."""
    N, Rn, W = 8, 3, 4
    eng = MeshEngine(lambda: VectorShardedKV(N, capacity=1 << 8), N, Rn, window=W, device="cpu")
    k = eng.kernel
    rng = np.random.default_rng(5)

    def dispatch(votes):
        stage, view = eng._window_votes(W)
        view[...] = votes
        stage.base[...] = (np.arange(N) + 2**31 - 3 + 2**31) % 2**32 - 2**31
        return stage, eng._dispatch_window(stage, stage.base, W)

    def want(votes):
        base = torch.from_numpy(((np.arange(N) + 2**31 - 3 + 2**31) % 2**32 - 2**31).astype(np.int32))
        return k.decide_slots_plain(torch.from_numpy(votes), torch.ones((N, Rn), dtype=torch.bool),
                                    base, eng.max_phases).numpy()

    held = rng.integers(0, 4, (W, N, Rn)).astype(np.int8)
    stage_a, fa = dispatch(held)
    others = [rng.integers(0, 4, (W, N, Rn)).astype(np.int8) for _ in range(3)]
    taken = []
    for v in others:
        st, f = dispatch(v)
        taken.append(st)
        np.testing.assert_array_equal(f.result(), want(v))
    assert all(st is not stage_a for st in taken)
    np.testing.assert_array_equal(fa.result(), want(held))  # not rewritten
    np.testing.assert_array_equal(stage_a.votes[:W], held)
    assert len(eng._ring.stages) == 2
    # read: stage_a goes out again; a held second window grows the ring
    st1, f1 = dispatch(others[0])
    st2, f2 = dispatch(others[1])
    st3, f3 = dispatch(others[2])
    assert len({id(st1), id(st2), id(st3)}) == 3 and len(eng._ring.stages) == 3
    for f, v in ((f3, others[2]), (f1, others[0]), (f2, others[1])):
        np.testing.assert_array_equal(f.result(), want(v))
    del f1, f2, f3
    st4, f4 = dispatch(held)
    del f4  # dropped unread: its buffer is free again
    st5, _ = dispatch(held)
    assert st5 is not None and len(eng._ring.stages) == 3


def test_engine_builds_votes_and_bases_in_the_ring():
    """One device: the full-width lane rewrites a buffer's votes only when
    its depth changes and its alive rows only when they differ; a mesh
    engine keeps plain arrays."""
    N, Rn, W = 8, 3, 4
    eng = MeshEngine(lambda: VectorShardedKV(N, capacity=1 << 8), N, Rn, window=W, device="cpu")
    st = eng._fullwidth_votes(3)
    assert isinstance(st, mesh_window.WindowStage) and st.votes_key == ("full", W, 3)
    assert (st.votes[:3] == V1).all() and (st.votes[3:W] == 0).all()
    st.votes[0, 0, 0] = 2  # a rewrite would restore it
    eng._ring.release(st)
    again = [eng._fullwidth_votes(3) for _ in range(2)]
    assert st in again and st.votes[0, 0, 0] == 2
    eng.crash_replica(1)
    stage, view = eng._window_votes(W)
    eng._dispatch_window(stage, stage.base, W).result()
    np.testing.assert_array_equal(stage.alive, eng.alive)
    mesh_eng = MeshEngine(lambda: VectorShardedKV(N, capacity=1 << 8), N, Rn,
                          mesh=_port_mesh(), window=W)
    assert mesh_eng._ring is None and isinstance(mesh_eng._fullwidth_votes(2), np.ndarray)


def _port_mesh():
    from rabia_tpu_torch.parallel import make_mesh as port_make_mesh

    return port_make_mesh(["cpu"] * 2, 2, 1)


def test_mapped_window_refusals():
    """The mapped launch takes a pinned stage only, and never builds or
    launches for what it refuses."""
    kern = mesh_window.MeshWindowKernel()
    stage = mesh_window.WindowStage(8, 3, 4, pinned=False)
    kw = dict(seed=0, coin_p1=0.5, max_phases=4)
    with pytest.raises(ValueError, match="does not fit"):
        kern.mapped(stage, 5, "cpu", **kw)
    with pytest.raises(ValueError, match="pinned"):
        kern.mapped(stage, 4, "cpu", **kw)
    with pytest.raises(ValueError, match="max_phases"):
        kern.mapped(stage, 4, "cpu", seed=0, coin_p1=0.5, max_phases=-1)
    assert kern.launches == 0 and kern._fn is None


@pytest.mark.cuda
def test_mapped_window_on_card_matches_plain():
    """mw_window on a pinned stage (mapped; decisions written in place)
    against the plain loop at ragged S, every R the kernel takes a sample
    of, bases near 2^31-1 (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the mapped window runs only on a card")
    dev = torch.device("cuda", 0)
    for Sn, Rn, Tn in ((17, 1, 3), (1000, 5, 16), (4096, 5, 16), (300, 64, 2)):
        votes, alive, base = _inputs(Sn + Rn, Rn, Sn, Tn)
        k = MeshPhaseKernel(Sn, Rn, seed=9, device=dev)
        stage = mesh_window.WindowStage(Sn, Rn, Tn, pinned=True)
        stage.votes[...], stage.alive[...], stage.base[...] = votes, alive, base
        n0 = mesh_window.MESH_WINDOW.launches
        k.decide_staged(stage, Tn, 4)
        stage.wait()
        assert mesh_window.MESH_WINDOW.launches == n0 + 1
        want = k.decide_slots_plain(*(torch.from_numpy(a).to(dev) for a in (votes, alive, base)), 4)
        np.testing.assert_array_equal(stage.decided[:Tn], want.cpu().numpy())
