"""The port's NodeKernel against the reference's, and the node kernel's
per-shard header against both.

- the plain versions (``init_state``, ``start_slots_plain``,
  ``node_step_plain``, ``node_cycle_plain``, which the CPU dispatch runs)
  against the reference's ``NodeKernel`` field for field, every state
  field and every outbox plane, and ``node_step`` against the port's
  ``HostNodeKernel``: R in {1, 3, 4, 5, 7, 8}, ragged S, slots near
  2^31-1 (phases that wrap too), several seeds and coin probabilities,
  inboxes over all four codes with partial rows, adopted decisions,
  masks that open some shards and leave others inactive or done, K in
  {1, 2, 3, 5};
- the reference's router test (``TestNodeKernelRouter``: R nodes with a
  host router agree with ``ClusterKernel``) on the port's kernel;
- ``csrc/node_kernel.cuh`` built for the host with g++ and run on the
  same inputs: both ledger forms (bit planes for R <= 64, bytes for any
  R, R = 70 too), out of place and in place, against the reference's
  ``node_cycle`` and ``start_slots``;
- the tick buffer's layout, ``donate`` and ``fetch`` on the CPU and the
  wrapper's refusals; the kernel itself is held against the plain versions by
  ``chip_smoke.py`` phase 16 (b) and the cuda-marked test below.

Tolerance: exact equality (every field is an integer).
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

from rabia_tpu.kernel.phase_driver import ClusterKernel as RefCluster
from rabia_tpu.kernel.phase_driver import NodeKernel as RefNode
from rabia_tpu_torch import convert
from rabia_tpu_torch.core.types import ABSENT, V0, V1, f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cuda_build, node_kernel
from rabia_tpu_torch.kernel.host_driver import HostNodeKernel
from rabia_tpu_torch.kernel.phase_driver import (
    ClusterKernel,
    NodeKernel,
    NodeOutbox,
    NodeState,
    coin_threshold,
)

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

STATE = [name for name, _, _ in node_kernel.STATE_FIELDS]
OUTBOX = [name for name, _ in node_kernel.OUTBOX_FIELDS]


def _np(state) -> dict:
    return {f: np.asarray(getattr(state, f)).copy() for f in state._fields}


def _ref_state(fields: dict):
    from rabia_tpu.kernel.phase_driver import NodeState as RefState

    return RefState(**{f: jnp.asarray(v) for f, v in fields.items()})


def _assert_same(got: dict, want: dict, names, ctx: str) -> None:
    for f in names:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert g.dtype == w.dtype, (ctx, f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx} field {f}")


def _tick_inputs(rng, S: int, R: int, base: int):
    """One tick's inputs: a mask opening about a third of the shards at
    slots near ``base``, initial votes V0/V1, inboxes over all four codes
    with partial rows, and decisions to adopt on a few shards."""
    mask = rng.random(S) < 0.35
    slots = (base + rng.integers(0, 8, S)).astype(np.int64)
    slots = ((slots + 2**31) % 2**32 - 2**31).astype(np.int32)
    init = rng.choice(np.array([V0, V1], np.int8), S)
    codes = np.array([0, 1, 2, 3], np.int8)
    ib1 = np.where(rng.random((S, R)) < 0.6, rng.choice(codes, (S, R)), ABSENT).astype(np.int8)
    ib2 = np.where(rng.random((S, R)) < 0.5, rng.choice(codes, (S, R)), ABSENT).astype(np.int8)
    dec = np.where(rng.random(S) < 0.08, rng.choice(np.array([V0, V1], np.int8), S),
                   ABSENT).astype(np.int8)
    return mask, slots, init, ib1, ib2, dec


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- the plain versions against the reference ---------------------------


@pytest.mark.parametrize("R", [1, 3, 4, 5, 7, 8])
def test_init_state_matches_reference(R):
    S = 13
    got = _np(NodeKernel(S, R, 0, device="cpu").init_state())
    _assert_same(got, _np(RefNode(S, R, 0).init_state()), STATE, f"R={R}")


@pytest.mark.parametrize("R,me,seed,p1", [
    (1, 0, 0, 0.5), (3, 1, 1, 0.5), (4, 3, 2, 0.0), (5, 2, 3, 1.0), (7, 6, 4, 0.5),
    (8, 0, 5, 0.5),
])
def test_node_cycle_matches_reference(R, me, seed, p1):
    """Chains of ticks, K in {1, 2, 3, 5}: every state field and every
    outbox plane after every tick, with slots near 2^31-1."""
    S = 37
    rng = np.random.default_rng(seed)
    ref = RefNode(S, R, me, seed=seed + 11, coin_p1=p1)
    port = NodeKernel(S, R, me, seed=seed + 11, coin_p1=p1, device="cpu")
    fields = _np(ref.init_state())
    pst = port.init_state()
    for t, K in enumerate([1, 2, 3, 5, 3, 2, 1, 3]):
        mask, slots, init, ib1, ib2, dec = _tick_inputs(rng, S, R, 2**31 - 4)
        rst, rob = ref.node_cycle(_ref_state(fields), *map(jnp.asarray, (
            mask, slots, init, ib1, ib2, dec)), K)
        pst, pob = port.node_cycle(pst, *_t(mask, slots, init, ib1, ib2, dec), K)
        fields = _np(rst)
        _assert_same(_np(pst), fields, STATE, f"tick {t} K={K}")
        _assert_same(_np(pob), _np(rob), OUTBOX, f"tick {t} K={K} outbox")
        assert pob.cast_r2.shape == (K, S)


@pytest.mark.parametrize("R,me,seed", [(1, 0, 7), (3, 2, 8), (5, 4, 9), (8, 3, 10)])
def test_start_slots_and_node_step_match_reference_and_host_kernel(R, me, seed):
    """start_slots then node_step, tick by tick: the reference's
    NodeKernel and the port's HostNodeKernel (ledgers [R, S]) agree with
    the port's plain versions field for field."""
    S = 29
    rng = np.random.default_rng(seed)
    ref = RefNode(S, R, me, seed=seed)
    host = HostNodeKernel(S, R, me, seed=seed)
    port = NodeKernel(S, R, me, seed=seed, device="cpu")
    fields = _np(ref.init_state())
    pst = port.init_state()
    hst = host.init_state()
    for t in range(10):
        mask, slots, init, ib1, ib2, dec = _tick_inputs(rng, S, R, 2**31 - 3)
        rst = ref.start_slots(_ref_state(fields), *map(jnp.asarray, (mask, slots, init)))
        pst = port.start_slots(pst, *_t(mask, slots, init))
        hst = host.start_slots(hst, mask, slots, init)
        _assert_same(_np(pst), _np(rst), STATE, f"start {t}")
        rst, rob = ref.node_step(rst, *map(jnp.asarray, (ib1, ib2, dec)))
        pst, pob = port.node_step(pst, *_t(ib1, ib2, dec))
        hst, hob = host.node_step(hst, ib1, ib2, dec)
        fields = _np(rst)
        _assert_same(_np(pst), fields, STATE, f"step {t}")
        _assert_same(_np(pob), _np(rob), OUTBOX, f"step {t} outbox")
        hf = _np(hst)
        hf["led1"], hf["led2"] = hf["led1"].T, hf["led2"].T
        _assert_same(hf, fields, STATE, f"host kernel step {t}")
        _assert_same(_np(hob), _np(rob), OUTBOX, f"host kernel step {t} outbox")


def test_node_cycle_equals_start_then_steps():
    """node_cycle(K) == start_slots and K node_steps, ABSENT inboxes after
    the first (the plain versions)."""
    S, R, K = 40, 5, 4
    rng = np.random.default_rng(3)
    port = NodeKernel(S, R, 1, seed=4, device="cpu")
    a = b = port.init_state()
    for _ in range(6):
        mask, slots, init, ib1, ib2, dec = _t(*_tick_inputs(rng, S, R, 100))
        a, oa = port.node_cycle(a, mask, slots, init, ib1, ib2, dec, K)
        b = port.start_slots(b, mask, slots, init)
        absent = torch.full((S, R), ABSENT, dtype=torch.int8)
        steps = []
        for k in range(K):
            b, ob = port.node_step(b, ib1 if k == 0 else absent, ib2 if k == 0 else absent,
                                   dec if k == 0 else torch.full((S,), ABSENT, dtype=torch.int8))
            steps.append(ob)
        _assert_same(_np(a), _np(b), STATE, "cycle vs steps")
        for f in OUTBOX:
            assert torch.equal(getattr(oa, f), torch.stack([getattr(o, f) for o in steps])), f


def test_node_cycle_with_no_steps_is_start_slots():
    S, R = 9, 3
    rng = np.random.default_rng(5)
    port = NodeKernel(S, R, 0, device="cpu")
    mask, slots, init, ib1, ib2, dec = _t(*_tick_inputs(rng, S, R, 7))
    st, ob = port.node_cycle(port.init_state(), mask, slots, init, ib1, ib2, dec, 0)
    _assert_same(_np(st), _np(port.start_slots(port.init_state(), mask, slots, init)), STATE, "K=0")
    assert ob.cast_r2.shape == (0, S)


@pytest.mark.parametrize("R,seed", [(3, 0), (5, 1)])
def test_router_full_delivery_matches_cluster(R, seed):
    """The reference's TestNodeKernelRouter on the port: R NodeKernels
    with a host router under full delivery decide, agree, and agree with
    the port's ClusterKernel and the reference's."""
    S = 4
    rng = np.random.default_rng(seed)
    initial = rng.integers(0, 2, size=(S, R)).astype(np.int8)
    nodes = [NodeKernel(S, R, me=i, seed=seed, device="cpu") for i in range(R)]
    states = [n.init_state() for n in nodes]
    buffers: dict = {}
    decisions_wire: dict[int, int] = {}

    def buf(s, slot, ph):
        return buffers.setdefault((s, slot, ph), {"r1": {}, "r2": {}})

    mask = torch.ones(S, dtype=torch.bool)
    slot_idx = torch.zeros(S, dtype=torch.int32)
    for i, n in enumerate(nodes):
        states[i] = n.start_slots(states[i], mask, slot_idx, torch.from_numpy(initial[:, i]))
        for s in range(S):
            buf(s, 0, 0)["r1"][i] = int(initial[s, i])
    for _ in range(30):
        if all(bool(st.done.all()) for st in states):
            break
        new_states, outs, old_phases = [], [], []
        for i, n in enumerate(nodes):
            st = states[i]
            phase, slot = st.phase.numpy().copy(), st.slot.numpy().copy()
            old_phases.append(phase)
            in1 = np.full((S, R), ABSENT, np.int8)
            in2 = np.full((S, R), ABSENT, np.int8)
            dec = np.full((S,), ABSENT, np.int8)
            for s in range(S):
                b = buffers.get((s, int(slot[s]), int(phase[s])))
                if b:
                    for snd, v in b["r1"].items():
                        in1[s, snd] = v
                    for snd, v in b["r2"].items():
                        in2[s, snd] = v
                if s in decisions_wire:
                    dec[s] = decisions_wire[s]
            st2, out = n.node_step(st, *_t(in1, in2, dec))
            new_states.append(st2)
            outs.append(out)
        for i, (st2, out) in enumerate(zip(new_states, outs)):
            slot = st2.slot.numpy()
            oph = old_phases[i]
            for s in range(S):
                if out.cast_r2[s]:
                    buf(s, int(slot[s]), int(oph[s]))["r2"][i] = int(out.r2_vals[s])
                if out.advanced[s]:
                    buf(s, int(slot[s]), int(out.new_phase[s]))["r1"][i] = int(out.new_r1[s])
                if out.newly_decided[s]:
                    decisions_wire[s] = int(out.decided_vals[s])
        states = new_states
    for st in states:
        assert bool(st.done.all()), "liveness: all nodes decide"
    vals = np.stack([st.decided.numpy() for st in states])
    assert np.all(vals == vals[0])
    k = ClusterKernel(S, R, seed=seed, device="cpu")
    cs = k.start_slot(k.init_state(), torch.ones(S, dtype=torch.bool), torch.from_numpy(initial))
    cs = k.run_rounds(cs, torch.ones((S, R), dtype=torch.bool), 30, torch.Generator())
    assert np.array_equal(cs.decided.numpy(), vals[0])
    rk = RefCluster(S, R, seed=seed)
    rs = rk.start_slot(rk.init_state(), jnp.ones((S,), bool), jnp.asarray(initial))
    rs = rk.run_rounds(rs, jnp.ones((S, R), bool), 30, jax.random.key(0))
    assert np.array_equal(np.asarray(rs.decided), vals[0])


# ---- the header, built with g++ ------------------------------------------

_HOST_SHIM = r"""
#include <algorithm>
#include <cstring>
#include <vector>
#include "node_kernel.cuh"
static nk::Ptrs ptrs(void* const* f) {
    nk::Ptrs p;
    p.slot = (int32_t*)f[0]; p.phase = (int32_t*)f[1]; p.stage = (int8_t*)f[2];
    p.my_r1 = (int8_t*)f[3]; p.my_r2 = (int8_t*)f[4]; p.led1 = (int8_t*)f[5];
    p.led2 = (int8_t*)f[6]; p.decided = (int8_t*)f[7]; p.done = (uint8_t*)f[8];
    p.active = (uint8_t*)f[9];
    return p;
}
extern "C" void nk_host_cycle(void* const* in, void* const* out, void* const* ob,
                              const uint8_t* mask, const int32_t* slots, const int8_t* init,
                              const int8_t* ib1, const int8_t* ib2, const int8_t* dec,
                              long long S, int R, int K, int me, int q, int f1, unsigned seed,
                              unsigned thr, int bytes) {
    nk::OutPtrs o{};
    if (ob) {
        o.cast_r2 = (uint8_t*)ob[0]; o.r2_vals = (int8_t*)ob[1]; o.advanced = (uint8_t*)ob[2];
        o.new_r1 = (int8_t*)ob[3]; o.new_phase = (int32_t*)ob[4];
        o.newly_decided = (uint8_t*)ob[5]; o.decided_vals = (int8_t*)ob[6];
    }
    nk::Inputs ip{mask, slots, init, ib1, ib2, dec};
    nk::Params p{R, me, q, f1, seed, thr};
    const nk::Ptrs pi = ptrs(in), po = ptrs(out);
    for (long long s = 0; s < S; ++s) {
        if (bytes) nk::cycle_shard<false>(pi, po, o, ip, S, K, s, p);
        else nk::cycle_shard<true>(pi, po, o, ip, S, K, s, p);
    }
}
static nk::OutPtrs outs(uint8_t* base, const long long* off) {
    nk::OutPtrs o{};
    if (base == nullptr) return o;
    o.cast_r2 = base + off[0]; o.r2_vals = (int8_t*)(base + off[1]);
    o.advanced = base + off[2]; o.new_r1 = (int8_t*)(base + off[3]);
    o.new_phase = (int32_t*)(base + off[4]); o.newly_decided = base + off[5];
    o.decided_vals = (int8_t*)(base + off[6]);
    return o;
}
static const uint8_t* at(const uint8_t* base, long long off) {
    return off < 0 ? nullptr : base + off;
}
// node_kernel.cu's launch on the host: every block of T shards as a loop
// over its threads, phase by phase (stage_in, cycle_tile, put_out), with
// the shared memory filled with junk first; the planes from a buffer at
// plane offsets (-1: absent), the results into the device outbox `ob`
// (may be null) and the image at image offsets (8 mirrored fields, 7
// outbox planes).
extern "C" void nk_host_tile_cycle(void* const* in, void* const* out, void* const* ob,
                                   const uint8_t* planes, const long long* poff, uint8_t* image,
                                   const long long* ioff, long long S, int R, int K, int me,
                                   int q, int f1, unsigned seed, unsigned thr, int bytes, int T) {
    nk::Inputs ip{at(planes, poff[0]), (const int32_t*)at(planes, poff[1]),
                  (const int8_t*)at(planes, poff[2]), (const int8_t*)at(planes, poff[3]),
                  (const int8_t*)at(planes, poff[4]), (const int8_t*)at(planes, poff[5])};
    nk::Params p{R, me, q, f1, seed, thr};
    nk::OutPtrs o{};
    if (ob) {
        o.cast_r2 = (uint8_t*)ob[0]; o.r2_vals = (int8_t*)ob[1]; o.advanced = (uint8_t*)ob[2];
        o.new_r1 = (int8_t*)ob[3]; o.new_phase = (int32_t*)ob[4];
        o.newly_decided = (uint8_t*)ob[5]; o.decided_vals = (int8_t*)ob[6];
    }
    nk::Ptrs img{};
    img.slot = (int32_t*)(image + ioff[0]); img.phase = (int32_t*)(image + ioff[1]);
    img.stage = (int8_t*)(image + ioff[2]); img.my_r1 = (int8_t*)(image + ioff[3]);
    img.my_r2 = (int8_t*)(image + ioff[4]); img.decided = (int8_t*)(image + ioff[5]);
    img.done = image + ioff[6]; img.active = image + ioff[7];
    const nk::OutPtrs iob = K > 0 ? outs(image, ioff + 8) : nk::OutPtrs{};
    const nk::Ptrs pi = ptrs(in), po = ptrs(out);
    std::vector<nk::Chunk> smem((nk::tile_bytes(T, R, K) + 15) / 16);
    for (long long s0 = 0; s0 < S; s0 += T) {
        const int n = (int)std::min<long long>(T, S - s0);
        uint8_t* sm = (uint8_t*)smem.data();
        std::memset(sm, 0xA5, smem.size() * 16);
        const nk::Tile tile = nk::carve(sm, T, R, K);
        for (int t = 0; t < T; ++t) nk::stage_in(tile, ip, s0, n, R, t, T);
        const nk::Inputs tin = nk::tile_inputs(tile, ip, s0, R);
        for (int t = 0; t < n; ++t) {
            if (bytes) nk::cycle_tile<false>(pi, po, tile, tin, T, K, s0, t, p);
            else nk::cycle_tile<true>(pi, po, tile, tin, T, K, s0, t, p);
        }
        for (int t = 0; t < T; ++t) nk::put_out(tile, o, img, iob, S, s0, n, T, K, t, T);
    }
}
"""


class _Host:
    """The header's host build: one node_cycle over numpy arrays."""

    def __init__(self, lib_path):
        lib = ctypes.CDLL(str(lib_path))
        P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
        lib.nk_host_cycle.argtypes = [P, P, P, P, P, P, P, P, P, LL, I, I, I, I, I, U, U, I]
        lib.nk_host_tile_cycle.argtypes = [P, P, P, P, P, P, P, LL, I, I, I, I, I, U, U, I, I]
        self.lib = lib

    def cycle(self, fields: dict, inputs, K: int, me: int, seed: int, p1: float,
              bytes_form: bool, in_place: bool = False, opens: bool = True):
        mask, slots, init, ib1, ib2, dec = (np.ascontiguousarray(a) for a in inputs)
        S, R = fields["led1"].shape
        src = {f: np.ascontiguousarray(fields[f]).copy() for f in STATE}
        out = src if in_place else {f: np.empty_like(v) for f, v in src.items()}
        ob = {f: np.empty((K, S), np.dtype(node_kernel._NP[dt]))
              for f, dt in node_kernel.OUTBOX_FIELDS}
        ins = (ctypes.c_void_p * 10)(*(src[f].ctypes.data for f in STATE))
        outs = (ctypes.c_void_p * 10)(*(out[f].ctypes.data for f in STATE))
        obs = (ctypes.c_void_p * 7)(*(ob[f].ctypes.data for f in OUTBOX))
        self.lib.nk_host_cycle(
            ins, outs, obs if K else None, mask.astype(np.uint8).ctypes.data if opens else None,
            slots.ctypes.data, init.ctypes.data, ib1.ctypes.data, ib2.ctypes.data,
            dec.ctypes.data, S, R, K, me, quorum_size(R), f_plus_1(R), seed & 0xFFFFFFFF,
            coin_threshold(p1), int(bytes_form))
        return out, ob


    def tile_cycle(self, fields: dict, inputs, K: int, me: int, seed: int, p1: float,
                   bytes_form: bool, T: int, image_K: int, in_place: bool = False,
                   opens: bool = True, device_outbox: bool = True):
        """node_kernel.cu's launch, block by block: the planes from a
        PlaneLayout buffer, the results into the state (``out``), the
        device outbox and a TickLayout image of ``image_K`` steps."""
        S, R = fields["led1"].shape
        pl = node_kernel.PlaneLayout(S, R)
        planes = _aligned_bytes(pl.nbytes)
        for view, a in zip(pl.views(planes), inputs):
            view[...] = a
        present = [opens] * 3 + [K > 0] * 3
        src = {f: np.ascontiguousarray(fields[f]).copy() for f in STATE}
        out = src if in_place else {f: np.empty_like(v) for f, v in src.items()}
        ob = {f: np.empty((K, S), np.dtype(node_kernel._NP[dt]))
              for f, dt in node_kernel.OUTBOX_FIELDS}
        for a in ob.values():
            a.view(np.uint8)[...] = 0x5A
        layout = node_kernel.TickLayout(S, R, image_K)
        image = _aligned_bytes(layout.nbytes)
        image[:] = 0x77
        mirror = [off for (off, _, _), (_, _, shape) in zip(layout.state, node_kernel.STATE_FIELDS)
                  if shape == "S"]
        ioff = mirror + [off for off, _, _ in layout.outbox]
        poff = [o if p else -1 for o, p in zip(pl.offsets, present)]
        LL = ctypes.c_longlong
        ins = (ctypes.c_void_p * 10)(*(src[f].ctypes.data for f in STATE))
        outs = (ctypes.c_void_p * 10)(*(out[f].ctypes.data for f in STATE))
        obs = (ctypes.c_void_p * 7)(*(ob[f].ctypes.data for f in OUTBOX))
        self.lib.nk_host_tile_cycle(
            ins, outs, obs if K and device_outbox else None, planes.ctypes.data,
            (LL * 6)(*poff), image.ctypes.data, (LL * 15)(*ioff), S, R, K, me, quorum_size(R),
            f_plus_1(R), seed & 0xFFFFFFFF, coin_threshold(p1), int(bytes_form), T)
        return out, ob, layout, image


def _aligned_bytes(n: int) -> np.ndarray:
    """n bytes at a 64-byte boundary (as the pinned buffers lie)."""
    raw = np.empty(n + 64, np.uint8)
    off = (-raw.ctypes.data) % 64
    return raw[off:off + n]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The node kernel's header compiled for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the header's host build cannot run")
    d = tmp_path_factory.mktemp("nk_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libnk_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
         "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    return _Host(lib)


@pytest.mark.parametrize("R,me,seed,p1", [
    (1, 0, 1, 0.5), (3, 2, 2, 0.5), (4, 1, 3, 0.0), (5, 0, 4, 1.0), (7, 3, 5, 0.5),
    (8, 7, 6, 0.5), (64, 9, 7, 0.5), (70, 69, 8, 0.5),
])
def test_header_matches_reference(host, R, me, seed, p1):
    """Both ledger forms (bit planes where R <= 64, bytes always), out of
    place and in place, tick after tick against the reference's
    node_cycle (K in {1, 3, 8}) and start_slots (K = 0)."""
    S = 23 if R > 8 else 41
    rng = np.random.default_rng(seed)
    ref = RefNode(S, R, me, seed=seed, coin_p1=p1)
    forms = [True] if R > 64 else [False, True]
    fields = _np(ref.init_state())
    for t, K in enumerate([0, 1, 3, 8, 1, 3]):
        inputs = _tick_inputs(rng, S, R, 2**31 - 5)
        if R > 8:  # big quorums: fill most rows so shards reach them
            for i in (3, 4):
                inputs[i][rng.random((S, R)) < 0.8] = rng.integers(0, 2)
        jin = list(map(jnp.asarray, inputs))
        if K == 0:
            rst, rob = ref.start_slots(_ref_state(fields), *jin[:3]), None
        else:
            rst, rob = ref.node_cycle(_ref_state(fields), *jin, K)
        want = _np(rst)
        for bytes_form in forms:
            for in_place in (False, True):
                got, ob = host.cycle(fields, inputs, K, me, seed, p1, bytes_form, in_place)
                ctx = f"tick {t} K={K} bytes={bytes_form} in_place={in_place}"
                _assert_same(got, want, STATE, ctx)
                if rob is not None:
                    _assert_same(ob, _np(rob), OUTBOX, ctx + " outbox")
        fields = want


def test_header_step_without_opens_is_node_step(host):
    """No mask (node_step's launch): the reference's node_step."""
    S, R, me = 33, 5, 3
    rng = np.random.default_rng(21)
    ref = RefNode(S, R, me, seed=2)
    fields = _np(ref.init_state())
    for t in range(8):
        inputs = _tick_inputs(rng, S, R, 50)
        jin = list(map(jnp.asarray, inputs))
        rst = ref.start_slots(_ref_state(fields), *jin[:3])
        fields = _np(rst)
        rst, rob = ref.node_step(rst, *jin[3:])
        for bytes_form in (False, True):
            got, ob = host.cycle(fields, inputs, 1, me, 2, 0.5, bytes_form, opens=False)
            _assert_same(got, _np(rst), STATE, f"step {t}")
            _assert_same({f: v[0] for f, v in ob.items()}, _np(rob), OUTBOX, f"step {t}")
        fields = _np(rst)


@pytest.mark.parametrize("R,me,seed,p1,T", [
    (1, 0, 31, 0.5, 16), (3, 2, 32, 0.5, 32), (5, 4, 33, 0.0, 128), (5, 1, 34, 1.0, 16),
    (8, 7, 35, 0.5, 64), (64, 9, 36, 0.5, 32), (70, 69, 37, 0.5, 16),
])
def test_header_tiles_match_reference(host, R, me, seed, p1, T):
    """The kernel's block form (node_kernel.cuh's tile section, a block
    run thread by thread on the host: the planes staged from a PlaneLayout
    buffer as covering 16-byte chunks, the shards run on the tile, the
    outputs put back a warp a run): tick after tick, the state, the
    device outbox and the host image's views (the mirrored fields, the
    outbox rows of an image as deep as the tick or deeper) equal the
    reference's node_cycle and start_slots, on S that leave the last
    block ragged and outbox rows off 16-byte boundaries."""
    S = 23 if R > 8 else 41 if T < 64 else 300
    rng = np.random.default_rng(seed)
    ref = RefNode(S, R, me, seed=seed, coin_p1=p1)
    fields = _np(ref.init_state())
    forms = [True] if R > 64 else [False, True]
    for t, (K, deeper) in enumerate([(0, 1), (1, 0), (3, 2), (8, 0), (1, 3), (3, 0)]):
        inputs = _tick_inputs(rng, S, R, 2**31 - 6)
        if R > 8:  # big quorums: fill most rows so shards reach them
            for i in (3, 4):
                inputs[i][rng.random((S, R)) < 0.8] = rng.integers(0, 2)
        jin = list(map(jnp.asarray, inputs))
        if K == 0:
            rst, rob = ref.start_slots(_ref_state(fields), *jin[:3]), None
        else:
            rst, rob = ref.node_cycle(_ref_state(fields), *jin, K)
        want = _np(rst)
        for bytes_form in forms:
            for in_place in (False, True):
                got, ob, layout, image = host.tile_cycle(fields, inputs, K, me, seed, p1,
                                                         bytes_form, T, K + deeper, in_place)
                ctx = f"tick {t} K={K} T={T} bytes={bytes_form} in_place={in_place}"
                _assert_same(got, want, STATE, ctx)
                mirrored = [name for name, _, shape in node_kernel.STATE_FIELDS if shape == "S"]
                img = dict(zip(STATE, layout.state_views(image)))
                _assert_same(img, want, mirrored, ctx + " image")
                if rob is not None:
                    _assert_same(ob, _np(rob), OUTBOX, ctx + " outbox")
                    img_ob = dict(zip(OUTBOX, layout.outbox_views(image, K)))
                    _assert_same(img_ob, _np(rob), OUTBOX, ctx + " image outbox")
        fields = want


def test_header_tiles_without_opens_or_device_outbox(host):
    """No open planes (a tick that opens no slot reads only the inboxes)
    and no device outbox: the image alone carries the outbox rows."""
    S, R, me = 50, 5, 2
    rng = np.random.default_rng(41)
    ref = RefNode(S, R, me, seed=4)
    fields = _np(ref.start_slots(ref.init_state(), *map(jnp.asarray, _tick_inputs(
        rng, S, R, 9)[:3])))
    for t in range(4):
        inputs = _tick_inputs(rng, S, R, 9)
        rst, rob = ref.node_cycle(_ref_state(fields), jnp.zeros(S, bool),
                                  *map(jnp.asarray, inputs[1:]), 2)
        got, ob, layout, image = host.tile_cycle(fields, inputs, 2, me, 4, 0.5, False, 16, 2,
                                                 opens=False, device_outbox=False)
        _assert_same(got, _np(rst), STATE, f"tick {t}")
        assert (ob["new_phase"].view(np.uint8) == 0x5A).all()  # untouched
        _assert_same(dict(zip(OUTBOX, layout.outbox_views(image))), _np(rob), OUTBOX,
                     f"tick {t} image outbox")
        fields = _np(rst)


# ---- the tick buffer, fetch and the wrapper -------------------------------


def test_tick_layout_views_and_ownership():
    S, R, K = 19, 5, 3
    layout = node_kernel.TickLayout(S, R, K)
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    st = layout.state_views(buf)
    ob = layout.outbox_views(buf)
    assert [tuple(t.shape) for t in st] == [(S,)] * 5 + [(S, R)] * 2 + [(S,)] * 3
    assert all(tuple(p.shape) == (K, S) for p in ob)
    offs = [t.data_ptr() - buf.data_ptr() for t in (*st, *ob)]
    assert all(o % 16 == 0 for o in offs) and offs == sorted(offs)
    assert layout.owns(buf, st) and not layout.owns(buf, [t.clone() for t in st])
    assert all(p.shape == (2, S) and p.is_contiguous() for p in layout.outbox_views(buf, 2))
    host_views = layout.state_views(buf.numpy())
    st[1].fill_(-7)
    assert (host_views[1] == -7).all()


def test_donate_is_functional_on_cpu():
    """The CPU ignores ``donate``: the state given stays as it was."""
    port = NodeKernel(6, 3, 1, device="cpu")
    st = port.init_state()
    kept = [t.clone() for t in st]
    ins = _t(*_tick_inputs(np.random.default_rng(2), 6, 3, 0))
    a, oa = port.node_cycle(st, *ins, 2, donate=True)
    b, ob = port.node_cycle(st, *ins, 2)
    assert all(torch.equal(x, y) for x, y in zip(st, kept))
    assert all(torch.equal(x, y) for x, y in zip((*a, *oa), (*b, *ob)))


def test_fetch_on_cpu_shares_memory():
    port = NodeKernel(6, 3, 0, device="cpu")
    st = port.init_state()
    rng = np.random.default_rng(0)
    st, ob = port.node_cycle(st, *_t(*_tick_inputs(rng, 6, 3, 0)), 2)
    host_st, host_ob = port.fetch(st, ob)
    assert isinstance(host_st, NodeState) and isinstance(host_ob, NodeOutbox)
    assert host_st.led1.ctypes.data == st.led1.data_ptr()
    assert host_ob.new_phase.shape == (2, 6)
    assert port.fetch(st)[1] is None


def test_state_round_trips_through_numpy():
    ref = RefNode(7, 3, 1, seed=3)
    rng = np.random.default_rng(4)
    mask, slots, init, ib1, ib2, dec = _tick_inputs(rng, 7, 3, 2**31 - 2)
    rst, _ = ref.node_cycle(ref.init_state(), *map(jnp.asarray, (
        mask, slots, init, ib1, ib2, dec)), 2)
    fields = _np(rst)
    st = convert.node_state_from_numpy(fields, "cpu")
    assert isinstance(st, NodeState)
    _assert_same(convert.node_state_to_numpy(st), fields, STATE, "round trip")


def test_wrapper_refuses_cpu_tensors_and_bad_shapes():
    port = NodeKernel(8, 3, 0, device="cpu")
    st = port.init_state()
    with pytest.raises(ValueError, match="no card"):
        port._launch("node_step", st, None, None, None, *_t(
            np.full((8, 3), ABSENT, np.int8), np.full((8, 3), ABSENT, np.int8),
            np.full(8, ABSENT, np.int8)), 1, False)
    layout = node_kernel.TickLayout(8, 3, 1)
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    fields = layout.state_views(buf)
    planes = layout.outbox_views(buf)
    plane_layout = node_kernel.PlaneLayout(8, 3)
    plane_buf = torch.zeros(plane_layout.nbytes, dtype=torch.uint8)
    inboxes = [False, False, False, True, True, True]
    kw = dict(me=0, quorum=2, f1=2, seed=0, threshold=0)

    def call(entry, outbox, present):
        node_kernel.NODE_CYCLE(entry, fields, fields, outbox, plane_buf, plane_layout, present,
                               buf, layout, 1, **kw)

    with pytest.raises(ValueError, match="CUDA"):
        call("node_step", planes, inboxes)
    with pytest.raises(ValueError, match="outbox"):
        call("node_step", None, inboxes)
    with pytest.raises(ValueError, match="unknown entry"):
        call("nope", planes, inboxes)
    assert node_kernel.NODE_CYCLE.launches == 0


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NodeKernel(4, 3, 0)


@pytest.mark.cuda
def test_node_kernel_on_card_matches_plain():
    """The CUDA kernel against the plain versions on the card, every
    field, K in {0, 1, 3}, donating the state (in place, the engine's
    case) and not (the state given stays as it was); the kernel reads its
    planes from pinned host memory (host arrays, and its own plane views)
    and the fetch's views of the host image equal the plain state and
    outbox (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the node kernel runs only on a card")
    dev = torch.device("cuda", 0)
    for R in (1, 5, 64, 70):
        S = 1000
        rng = np.random.default_rng(R)
        card = NodeKernel(S, R, R - 1, seed=3, device=dev)
        plain = NodeKernel(S, R, R - 1, seed=3, device=dev)
        a, b = card.init_state(), plain.init_state()
        for K in (0, 1, 3, 3, 1):
            host = _tick_inputs(rng, S, R, 2**31 - 4)
            ins = [t.to(dev) for t in _t(*host)]
            kept = [t.clone() for t in a]
            f, of = card.node_cycle(a, *_t(*host), K)
            assert all(torch.equal(x, y) for x, y in zip(a, kept))
            for view, x in zip(card.planes, host):  # the engine's way: write the views
                view[...] = x
            a, oa = card.node_cycle(a, *card.planes, K, donate=True)
            b, ob = plain.node_cycle_plain(b, *ins, K)
            for x, y, z in zip(a, b, f):
                assert torch.equal(x, y) and torch.equal(z, y)
            for x, y, z in zip(oa, ob, of):
                assert torch.equal(x, y) and torch.equal(z, y)
            hst, hob = card.fetch(a, oa if K else None)
            for name, got in zip(STATE, hst):
                if got is not None:
                    np.testing.assert_array_equal(got, getattr(b, name).cpu().numpy())
            if K:
                for name, got in zip(OUTBOX, hob):
                    np.testing.assert_array_equal(got, getattr(ob, name).cpu().numpy())
        assert card.fetch_bytes == 0 and card.mapped_bytes > 0
