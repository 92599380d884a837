"""Multi-controller runs of the device mesh: one OS process a rank.

The port's form of the reference's multi-host recipe
(``scripts/dcn_dryrun.py``): every rank joins a ``torch.distributed``
process group (its address, world size, rank and a timeout given
explicitly), builds the same (shard × replica) mesh over the world with
:func:`~rabia_tpu_torch.parallel.make_mesh`, and runs the same program;
the replica-axis exchanges and the decided plane's gather are the group's
collectives. :func:`spawn_ranks` starts the ranks as new interpreters
(``python -m rabia_tpu_torch.testing.dcn``), waits for them under one
deadline, kills every rank when the deadline passes (a rank that dies
leaves its peers waiting in a collective) and raises on any failure; each
rank prints one ``DCN_RESULT`` JSON line, which it returns.

Workloads:

- ``dryrun``: ``MeshPhaseKernel.phase_step`` with the replica axis across
  the ranks (split votes and a crash mask, so the coin is reached), each
  rank checking its own block; ``slot_window`` over ``1 x n`` and
  ``n x 1`` meshes against the one-device plain loop; and the whole
  ``MeshEngine`` (scalar and block lanes) over both meshes, every rank
  checking decisions, futures and replica state against a one-device
  engine it runs itself, and the ranks' state digests against each other.
- ``engine``: :func:`engine_workload` on ``MeshEngine(mesh=make_mesh())``
  over the world (the shard axis across the ranks) at ``--shards`` x
  ``--replicas``, returning its digest and, on a card, the window's time,
  the exchange's time and ``mw_window`` launches a window.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

from rabia_tpu_torch.testing.multiproc import REPO, free_ports

RESULT = "DCN_RESULT "


# -- the workload shared with chip_smoke.py's phase 17 ------------------------


def engine_workload(eng) -> dict:
    """SET and GET on every shard, a minority crash with SETs under it,
    heal, and GETs of those SETs. Returns what a client and an operator
    see: every future's result, every shard's decision log (value and
    commands a slot), the decided counts, next slots and every replica's
    snapshot."""
    S, R = eng.n_shards, eng.R
    futs = [eng.submit([f"SET k{s} v{s}"], s) for s in range(S)]
    futs += [eng.submit([f"GET k{s}"], s) for s in range(S)]
    eng.flush()
    down = list(range(R - 1, R - 1 - (R - 1) // 2, -1))  # a minority
    for r in down:
        eng.crash_replica(r)
    futs += [eng.submit([f"SET m{s} w{s}"], s) for s in range(S)]
    eng.flush()
    for r in down:
        eng.heal_replica(r)
    futs += [eng.submit([f"GET m{s}"], s) for s in range(S)]
    eng.flush()
    return {
        "futures": [f.result() for f in futs],
        "decisions": [
            [(slot, v, None if b is None else [c.data for c in b.commands])
             for slot, (v, b) in eng.decisions_for(s).items()]
            for s in range(S)
        ],
        "counts": [eng.decided_v1, eng.decided_v0, [int(x) for x in eng.next_slot]],
        "snapshots": [sm.create_snapshot().data for sm in eng.sms],
    }


def digest(obs) -> str:
    """A stable digest of an observation of plain values."""
    return hashlib.sha256(pickle.dumps(obs, protocol=4)).hexdigest()


# -- the parent ------------------------------------------------------------------


def spawn_ranks(world: int, *, backend: str, device: str, workload: str,
                timeout: float = 120.0, args: tuple = ()) -> list[dict]:
    """Run ``world`` ranks of ``workload`` and return each rank's result.
    Raises RuntimeError when a rank fails, prints no result, or the
    ranks outlast ``timeout`` seconds (every rank is then killed)."""
    addr = f"tcp://127.0.0.1:{free_ports(1)[0]}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "rabia_tpu_torch.testing.dcn", "--rank", str(k),
             "--world", str(world), "--addr", addr, "--backend", backend, "--device", device,
             "--workload", workload, *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO), env=env,
        )
        for k in range(world)
    ]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(0.1, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
        raise RuntimeError(f"{workload}: {world} ranks outlasted {timeout} s; every rank killed")
    results = []
    for k, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
        if p.returncode != 0 or len(lines) != 1:
            raise RuntimeError(f"{workload}: rank {k} exited {p.returncode}; stderr:\n{err[-4000:]}")
        results.append(json.loads(lines[0][len(RESULT):]))
    return results


# -- the ranks ------------------------------------------------------------------


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _split_case(seed: int, S: int, R: int, T: int):
    from rabia_tpu_torch.core.types import quorum_size

    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 4, size=(T, S, R)).astype(np.int8)
    votes[:, 1::2] = rng.integers(0, 2, size=votes[:, 1::2].shape)  # split V0/V1: the coin
    alive = rng.random((S, R)) >= 0.15
    alive[0, : quorum_size(R)] = False
    base = rng.integers(0, 1000, size=S).astype(np.int64)
    base[::2] = 2**31 - 1 - rng.integers(0, T, size=base[::2].shape)
    return votes, alive, base.astype(np.int32)


def _dryrun(world: int, devs) -> dict:
    import torch.distributed as dist

    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
    from rabia_tpu_torch.core.blocks import build_block
    from rabia_tpu_torch.parallel import MeshEngine, MeshPhaseKernel, make_mesh

    out = {}
    # 1. phase_step, the replica axis across the ranks
    S, R = 8, 2 * world
    votes, alive, base = _split_case(3, S, R, 1)
    mesh = make_mesh(devs, 1, world)
    k = MeshPhaseKernel(S, R, mesh, seed=3)
    one = MeshPhaseKernel(S, R, seed=3, device="cpu")
    st = k.init_state(votes[0])._replace(slot=k.place(np.broadcast_to(base[:, None], (S, R))))
    st1 = one.init_state(torch.from_numpy(votes[0]))._replace(
        slot=torch.from_numpy(np.ascontiguousarray(np.broadcast_to(base[:, None], (S, R)))))
    for _ in range(6):
        st = k.phase_step(st, k.place(alive), k.shard_index_array())
        st1 = one.phase_step(st1, torch.from_numpy(alive), one.shard_index_array())
    for f, (mine, full) in zip(st._fields, zip(st, st1)):
        ((i, j), blk), = mine.blocks.items()
        want = full[:, j * 2:(j + 1) * 2]
        _check(torch.equal(blk.cpu(), want), f"phase_step field {f} block ({i}, {j})")
    _check(bool((st1.phase > 1).any()), "phase_step never reached the coin")
    out["phase_step_block"] = [i, j]
    # 2. slot_window over 1 x n (the replica exchange across the ranks)
    #    and n x 1 (the decided plane's gather across the ranks)
    for a, b, Rw in ((1, world, 2 * world), (world, 1, 5)):
        S, T = 4 * world, 6
        votes, alive, base = _split_case(10 * a + b, S, Rw, T)
        k = MeshPhaseKernel(S, Rw, make_mesh(devs, a, b), seed=5)
        got = k.slot_window(votes, alive, base, n_slots=T, max_phases=4).cpu()
        want = MeshPhaseKernel(S, Rw, seed=5, device="cpu").decide_slots_plain(
            torch.from_numpy(votes), torch.from_numpy(alive), torch.from_numpy(base), 4)
        _check(torch.equal(got, want), f"slot_window over {a} x {b}")
        _check({0, 1} <= set(want.unique().tolist()), "the window never took the coin")
    # 3. the engine over both meshes, against a one-device engine here
    for a, b in ((world, 1), (1, world)):
        S = 2 * world

        def drive(eng):
            futs = [eng.submit([f"SET k{i} v{i}"], shard=i % S) for i in range(2 * S)]
            _check(eng.flush() == 2 * S, "scalar lane")
            bfut = eng.submit_block(build_block(list(range(S)),
                                                [[f"SET blk{s} w".encode()] for s in range(S)]))
            _check(eng.flush() == S, "block lane")
            obs = engine_workload(eng)
            obs["lanes"] = [f.result() for f in futs] + [bfut.result()]
            return obs

        eng = MeshEngine(InMemoryStateMachine, S, 2 * b, mesh=make_mesh(devs, a, b), window=2)
        _check(eng._multi, "the engine did not see the multi-controller mesh")
        got = drive(eng)
        want = drive(MeshEngine(InMemoryStateMachine, S, 2 * b, device="cpu", window=2))
        _check(got == want, f"engine over {a} x {b} != the one-device engine")
        digests = [None] * world
        dist.all_gather_object(digests, digest(got["snapshots"]))
        _check(len(set(digests)) == 1, "replica state differs across ranks")
        out[f"engine_{a}x{b}"] = digest(got)
    return out


def _engine(world: int, devs, S: int, R: int, window: int) -> dict:
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
    from rabia_tpu_torch.kernel import mesh_window
    from rabia_tpu_torch.parallel import MeshArray, MeshEngine, make_mesh

    mesh = make_mesh(devs)
    eng = MeshEngine(InMemoryStateMachine, S, R, mesh=mesh, window=window)
    _check(eng._multi, "the engine did not see the multi-controller mesh")
    launches = mesh_window.MESH_WINDOW.launches
    cycles = eng.cycles
    obs = engine_workload(eng)
    res = {"digest": digest(obs), "mesh": repr(mesh), "backend": mesh.backend,
           "windows": eng.cycles - cycles,
           "launches": mesh_window.MESH_WINDOW.launches - launches}
    dev = eng.device
    if dev.type == "cuda":
        votes = np.ones((window, eng.S, R), np.int8)
        base = np.zeros(eng.S, np.int32)
        k = eng.kernel
        V = MeshArray.cut(mesh, votes, 1, 2)
        A = MeshArray.cut(mesh, eng.alive, 0, 1)

        def timed(fn, reps):
            fn()
            torch.cuda.synchronize(dev)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(stop) / reps

        before = mesh_window.MESH_WINDOW.launches
        res["window_ms"] = timed(lambda: eng._run_window_multihost(votes, base, window), 10)
        res["launches_per_window"] = (mesh_window.MESH_WINDOW.launches - before) / 11
        res["exchange_ms"] = timed(lambda: k.exchange_window(V, A), 10)
    return res


def worker(rank: int, world: int, addr: str, backend: str, device: str, workload: str,
           extra: list) -> None:
    import torch.distributed as dist

    if device == "cuda":
        # NCCL takes one card a rank; ranks on a gloo group may share one
        torch.cuda.set_device(rank % torch.cuda.device_count() if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=addr, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    devs = None if device == "cuda" else [device] * world
    try:
        if workload == "dryrun":
            res = _dryrun(world, devs)
        elif workload == "engine":
            S, R, window = (int(x) for x in extra)
            res = _engine(world, devs, S, R, window)
        else:
            raise ValueError(f"no workload {workload!r}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    res.update(rank=rank, world=world, backend=backend, device=device)
    print(RESULT + json.dumps(res), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one rank of a multi-controller mesh run")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--addr", required=True)
    ap.add_argument("--backend", required=True, choices=["gloo", "nccl"])
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--workload", required=True, choices=["dryrun", "engine"])
    ap.add_argument("extra", nargs="*")
    a = ap.parse_args(argv)
    worker(a.rank, a.world, a.addr, a.backend, a.device, a.workload, a.extra)


if __name__ == "__main__":
    main()
