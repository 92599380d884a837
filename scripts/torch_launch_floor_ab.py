"""Time the engine's tick and window on mapped pinned memory beside the
parent's copy sequence, on one GPU.

    python3 scripts/torch_launch_floor_ab.py PARENT_ROOT [--reps 200]

PARENT_ROOT is the root of an earlier tree of this repository whose
node kernel and mesh window copied their inputs to the card and their
results back, unpacked with ``git archive`` into a directory that
.gitignore lists, for example (6822627 is such a commit):

    mkdir -p build/ab_parent
    git archive 6822627 rabia_tpu_torch/csrc rabia_tpu_torch/kernel/node_kernel.py \\
        rabia_tpu_torch/kernel/phase_driver.py | tar -x -C build/ab_parent
    python3 scripts/torch_launch_floor_ab.py build/ab_parent

Its ``node_kernel.cu`` and ``mesh_window.cu`` are built with nvcc (sm_90a)
into their own libraries. The parent's tick runs its own ``NodeKernel``
(its ``phase_driver.py`` and ``node_kernel.py`` bound to its library): the
six planes go up in one copy (``core.device.to_device_all``, as its engine
sent them), its launch converts each plane (its ``_launch``) and its
fetch copies the tick buffer back (``core.device.HostFetch``). The
parent's window runs ``MeshPhaseKernel.slot_window`` on device tensors
(its code, unchanged since) on its library: the votes, alive rows and
bases uploaded (``core.device.to_device``, as its engine sent them), the
wrapper's conversions, a fresh ``decided`` and a ``HostFetch``. This
tree's tick is ``NodeKernel.node_cycle`` on the kernel's pinned plane
views and its fetch of the host image; its window is
``MeshPhaseKernel.decide_staged`` on a pinned ``WindowStage`` and its
event. The mesh's windows, whose blocks lie on devices, keep device
tensors: both trees' ``mw_window`` are also timed on the same device
tensors, at T=16 as one device lays them out (B=1) and as a 1x5 mesh's
gather leaves them (five replica blocks of one replica each).

Every build is first held bit for bit against the plain versions
(``node_cycle_plain`` at S=4096 R=5 K=3 on a random state over all four
codes, partial inboxes, adopted decisions and slots near 2^31-1; the
plain window loop on votes over all four codes with a crash mask and
bases near 2^31-1). Then, in turns (this, parent, parent, this), it
times each round trip (tick: planes in host memory -> state and outbox
readable; window: votes staged -> decided readable) by the host clock
around a chain of calls, each ending in its wait, and each kernel alone
by CUDA graph replay (the parent's on device memory), and both kernels on
device tensors by graph replay (this, parent, parent, this). Prints the
card as nvidia-smi names it and one JSON line. Exits non-zero without a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from rabia_tpu_torch.core.device import HostFetch, to_device, to_device_all  # noqa: E402
from rabia_tpu_torch.kernel import cuda_build, mesh_window, node_kernel  # noqa: E402
from rabia_tpu_torch.kernel.phase_driver import NodeKernel, NodeState  # noqa: E402
from rabia_tpu_torch.parallel import MeshPhaseKernel  # noqa: E402

S, R, K, T = chip_smoke.S_FULL, chip_smoke.R_FULL, 3, 16


def build(src: Path, tag: str) -> ctypes.CDLL:
    """``src`` built with nvcc into a library of its own."""
    out = cuda_build.BUILD_DIR / "ab" / f"lib{src.stem}_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-I{src.parent}", "-o", str(out), str(src)],
        capture_output=True, text=True,
    )
    print(f"{src}:\n{proc.stdout}{proc.stderr}".strip())
    proc.check_returncode()
    return ctypes.CDLL(str(out))


def window_kernel(lib: ctypes.CDLL) -> mesh_window.MeshWindowKernel:
    """A mesh-window wrapper bound to ``lib``."""
    kern = mesh_window.MeshWindowKernel()
    fn = lib.mw_window
    P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    fn.argtypes = [P, P, P, P, LL, LL, I, I, LL, LL, U, I, I, U, U, I, P]
    fn.restype = I
    lib.mw_empty.argtypes = [LL, LL, P]
    lib.mw_empty.restype = I
    kern._lib, kern._fn = lib, fn
    return kern


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_node(parent: Path, dev):
    """The parent's NodeKernel class, its wrapper bound to its library."""
    lib = build(parent / "rabia_tpu_torch" / "csrc" / "node_kernel.cu", "parent")
    pnk = load_module("parent_node_kernel", parent / "rabia_tpu_torch/kernel/node_kernel.py")
    ppd = load_module("parent_phase_driver", parent / "rabia_tpu_torch/kernel/phase_driver.py")
    ppd.node_kernel = pnk
    fn = lib.nk_node_cycle
    P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    fn.argtypes = [P, P, P, P, P, P, P, P, P, LL, I, I, I, I, I, U, U, P]
    fn.restype = I
    pnk.NODE_CYCLE._fn = fn
    return ppd, pnk


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    reps = args.reps
    node_kernel.NODE_CYCLE.load()
    mesh_window.MESH_WINDOW.load()
    ppd, pnk = parent_node(args.parent, dev)
    windows = {"this": mesh_window.MESH_WINDOW,
               "parent": window_kernel(build(args.parent / "rabia_tpu_torch/csrc/mesh_window.cu",
                                             "parent"))}

    # ---- the tick: this tree's and the parent's, both against plain
    gen = torch.Generator().manual_seed(41)
    st0, ins = chip_smoke.random_node_case(gen, S, R, "cpu")
    host = [x.numpy() for x in ins]
    plain = NodeKernel(S, R, 0, seed=41, device=dev)
    want_st, want_ob = plain.node_cycle_plain(NodeState(*(t.to(dev) for t in st0)),
                                              *(x.to(dev) for x in ins), K)
    this = NodeKernel(S, R, 0, seed=41, device=dev)
    for view, x in zip(this.planes, host):
        view[...] = x
    a, oa = this.node_cycle(NodeState(*(t.to(dev) for t in st0)), *this.planes, K)
    got_st, got_ob = this.fetch(a, oa)
    par = ppd.NodeKernel(S, R, 0, seed=41, device=dev)
    planes = to_device_all(host, dev)
    b, ob = par.node_cycle(NodeState(*(t.to(dev) for t in st0)), *planes, K)
    par_st, par_ob = par.fetch(b, ob)
    err = 0
    for name, w in zip(NodeState._fields, want_st):
        for got in (getattr(got_st, name), getattr(par_st, name)):
            if got is not None:
                err = max(err, int((torch.from_numpy(np.asarray(got)).to(dev).to(torch.int64)
                                    - w.to(torch.int64)).abs().max()))
    for w, g, p in zip(want_ob, got_ob, par_ob):
        for got in (g, p):
            err = max(err, int((torch.from_numpy(np.asarray(got)).to(dev).to(torch.int64)
                                - w.to(torch.int64)).abs().max()))
    if err:
        print(f"a tick differs from node_cycle_plain: max_abs_err {err}", file=sys.stderr)
        return 1

    cur = {"this": [a, oa], "parent": [b, ob]}

    def this_tick(i=0):
        c = cur["this"]
        c[0], c[1] = this.node_cycle(c[0], *this.planes, K, donate=True)
        return this.fetch_start(c[0], c[1]).result()

    def parent_tick(i=0):
        c = cur["parent"]
        up = to_device_all(host, dev)
        c[0], c[1] = par.node_cycle(c[0], *up, K, donate=True)
        return par.fetch_start(c[0], c[1]).result()

    kw = dict(me=0, quorum=this.quorum, f1=this.f1, seed=41,
              threshold=chip_smoke.coin_threshold(this.coin_p1))
    image, image_layout, _ = this._image
    this_kernel = lambda i=0: node_kernel.NODE_CYCLE(  # noqa: E731
        "node_cycle", list(a), list(a), list(oa), this._plane_buf, this._plane_layout,
        [True] * 6, image, image_layout, K, **kw)
    parent_kernel = lambda i=0: pnk.NODE_CYCLE(  # noqa: E731
        "node_cycle", list(b), list(b), list(ob), *planes, K, **kw)
    tick = {"this": [], "parent": []}
    tick_kernel = {"this": [], "parent": []}
    for who in ("this", "parent", "parent", "this"):
        fn = this_tick if who == "this" else parent_tick
        tick[who].append(chip_smoke._host_ms(fn, reps))
        kern = this_kernel if who == "this" else parent_kernel
        tick_kernel[who].append(chip_smoke._graph_ms(kern, reps))

    # ---- the window
    gen = torch.Generator().manual_seed(42)
    votes, alive, base = chip_smoke.mesh_case(gen, S, R, T, "cpu")
    mk = MeshPhaseKernel(S, R, seed=42, device=dev)
    want = mk.decide_slots_plain(votes.to(dev), alive.to(dev), base.to(dev), 4).cpu().numpy()
    stage = mesh_window.WindowStage(S, R, T, pinned=True)
    stage.votes[...], stage.alive[...], stage.base[...] = votes.numpy(), alive.numpy(), base.numpy()
    hv, ha, hb = votes.numpy(), alive.numpy(), base.numpy()
    saved = mesh_window.MESH_WINDOW

    def staged(kern):
        def run(i=0):
            mesh_window.MESH_WINDOW = kern
            try:
                mk.decide_staged(stage, T, 4)
            finally:
                mesh_window.MESH_WINDOW = saved
            stage.wait()
            return stage.decided[:T]
        return run

    def copied(kern):
        def run(i=0):
            mesh_window.MESH_WINDOW = kern
            try:
                v, al, bs = (to_device(x, dev) for x in (hv, ha, hb))
                d = mk.slot_window(v, al, bs, n_slots=T, max_phases=4)
            finally:
                mesh_window.MESH_WINDOW = saved
            return HostFetch(d).result()
        return run

    runs = {"this": staged(windows["this"]), "parent": copied(windows["parent"])}
    for name, run in runs.items():
        got = np.asarray(run()).copy()
        if not np.array_equal(got, want):
            print(f"the {name} window differs from the plain loop", file=sys.stderr)
            return 1
    dv, da, db = votes.to(dev), alive.to(dev), base.to(dev)
    alone = {"this": lambda i=0: _mapped_call(windows["this"], mk, stage),
             "parent": lambda i=0: windows["parent"](dv, da, db, seed=mk.seed,  # noqa: E731
                                                     coin_p1=mk.coin_p1, max_phases=4)}
    window_rt = {n: [] for n in alone}
    window_kernel_ms = {n: [] for n in alone}
    for who in ("this", "parent", "parent", "this"):
        window_rt[who].append(chip_smoke._host_ms(runs[who], reps))
        window_kernel_ms[who].append(chip_smoke._graph_ms(alone[who], reps))

    # ---- the mesh's window: both kernels on the same device tensors
    layouts = {"B1": (dv, da),  # [T, S, R], one device's
               # a 1x5 mesh's gathered shard block: five replica blocks
               # [5, T, S, 1] and [5, S, 1], each at its own stride
               "1x5": (dv.permute(2, 0, 1).contiguous().unsqueeze(-1),
                       da.t().contiguous().unsqueeze(-1))}
    device_ms = {}
    for lay, (v, al) in layouts.items():
        calls = {who: (lambda i=0, k=windows[who], v=v, al=al: k(  # noqa: E731
                     v, al, db, seed=mk.seed, coin_p1=mk.coin_p1, max_phases=4))
                 for who in ("this", "parent")}
        for who, call in calls.items():
            if not np.array_equal(call().cpu().numpy(), want):
                print(f"the {who} window on device tensors ({lay}) differs from the plain loop",
                      file=sys.stderr)
                return 1
        device_ms[lay] = {"this": [], "parent": []}
        for who in ("this", "parent", "parent", "this"):
            device_ms[lay][who].append(chip_smoke._graph_ms(calls[who], reps))
    print(smi)
    print(json.dumps({
        "card": smi, "S": S, "R": R, "K": K, "T": T, "reps": reps,
        "tick_round_trip_ms": tick, "tick_kernel_ms": tick_kernel,
        "window_round_trip_ms": window_rt, "window_kernel_ms": window_kernel_ms,
        "window_device_tensor_ms": device_ms,
        "tick_max_abs_err": err, "window_max_abs_err": 0,
    }))
    return 0


def _mapped_call(kern, mk, stage):
    """One mapped window on ``stage`` by ``kern`` (no event: a CUDA graph
    captures it)."""
    a_off, b_off, v_off, d_off = (stage.device_address + o for o in stage.offsets)
    err = kern._fn(v_off, a_off, b_off, d_off, T, S, 1, R, 0, 0, 0, mk.quorum, mk.f1,
                   mk.seed & 0xFFFFFFFF, chip_smoke.coin_threshold(mk.coin_p1), 4,
                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mesh window launch failed: cudaError {err}")


if __name__ == "__main__":
    sys.exit(main())
