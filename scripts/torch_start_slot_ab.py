"""Time ``start_slot`` of two trees of the port on one GPU, in turns, and
this tree's window packers.

    python3 scripts/torch_start_slot_ab.py OTHER_ROOT [--rounds 2]

OTHER_ROOT is the root of another tree of this repository whose
``rabia_tpu_torch`` is unpacked with ``git archive`` into a directory that
.gitignore lists, for example the parent's:

    mkdir -p build/ab_parent
    git archive PARENT rabia_tpu_torch | tar -x -C build/ab_parent
    python3 scripts/torch_start_slot_ab.py build/ab_parent

Each tree runs in a process of its own (both packages are named
``rabia_tpu_torch``; each builds its own ``cluster_round.cu`` into its
root's ``build/``), in the order other, this, this, other, ``--rounds``
times. A process holds its ``ClusterKernel.start_slot`` against
``start_slot_plain`` on a state of protocol values with a random mask
(one device and a 4x1 logical mesh of it), then times at S=4096 R=5 with
every shard masked: one device's call and the 4x1 mesh's
``ShardedClusterKernel.start_slot`` by CUDA events over a chain of calls
(the host's issue included), five times each, alternating; the one-device
call by CUDA graph replay (the kernel alone); and the launches one
sharded call makes. This tree's process also times, by graph replay in
alternating orders, ``start_slot`` beside an empty kernel at its grid and
table and an empty kernel of the mesh window's grid, and at T=32768
``pack_codes`` alone, ``pack_inputs`` and ``pack_codes`` then
``pack_alive`` (two launches), each first held against the plain
versions. Every process prints one JSON line; the card's name and power
limit and the host's CPU model come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events_ms(fn, reps: int = 50) -> float:
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _graph_ms(fn, reps: int = 500) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _turns(runs: dict, rounds: int, reps: int) -> dict:
    """Each of ``runs`` by graph replay, ``rounds`` times, the order
    reversed every other round."""
    out: dict = {name: [] for name in runs}
    for k in range(rounds):
        for name in (list(runs) if k % 2 == 0 else list(reversed(runs))):
            out[name].append(_graph_ms(runs[name], reps))
    return out


def child(root: str, tag: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from rabia_tpu_torch import ClusterKernel
    from rabia_tpu_torch.kernel import cluster_round
    from rabia_tpu_torch.parallel import ShardedClusterKernel, make_mesh

    dev = torch.device("cuda", 0)
    S, R = 4096, 5
    gen = torch.Generator(device=dev).manual_seed(21)
    ck = ClusterKernel(S, R, device=dev)
    sk = ShardedClusterKernel(S, R, make_mesh([dev] * 4, 4, 1))
    # correctness first: a state of protocol values, a random mask
    fields = {
        "slot": torch.randint(2**31 - 4, 2**31, (S,), generator=gen, device=dev).to(torch.int32),
        "phase": torch.randint(0, 9, (S, R), generator=gen, device=dev, dtype=torch.int32),
        "decided_phase": torch.randint(-1, 9, (S,), generator=gen, device=dev,
                                       dtype=torch.int32),
        "done": torch.rand((S, R), generator=gen, device=dev) < 0.3,
        "active": torch.rand((S,), generator=gen, device=dev) < 0.7,
    }
    for name, _, kind in cluster_round.FIELDS:
        if name not in fields:
            shape = {"S": (S,), "SR": (S, R), "SRR": (S, R, R)}[kind]
            fields[name] = torch.randint(0, 2 if name == "stage" else 4, shape, generator=gen,
                                         device=dev, dtype=torch.int8)
    st = type(ck.init_state())(**fields)
    mask = torch.rand((S,), generator=gen, device=dev) < 0.5
    votes = torch.randint(0, 4, (S, R), generator=gen, device=dev, dtype=torch.int8)
    want = ck.start_slot_plain(st, mask, votes)
    for got in (ck.start_slot(st, mask, votes), sk.start_slot(st, mask, votes)):
        for g, w in zip(got, want):
            g = g.full() if hasattr(g, "full") else g
            if not torch.equal(g, w):
                raise AssertionError(f"{tag}: start_slot != start_slot_plain")
    every = torch.ones(S, dtype=torch.bool, device=dev)
    v1 = torch.ones((S, R), dtype=torch.int8, device=dev)
    st = ck.start_slot(ck.init_state(), every, v1)
    sst = sk.start_slot(sk.init_state(), every, v1)
    one = lambda: ck.start_slot(st, every, v1)  # noqa: E731
    sharded = lambda: sk.start_slot(sst, every, v1)  # noqa: E731
    n0 = cluster_round.CLUSTER_ROUND.launches
    sharded()
    out = {"tree": tag, "launches_a_sharded_call": cluster_round.CLUSTER_ROUND.launches - n0,
           "one_ms": [], "sharded_ms": []}
    for _ in range(5):
        out["one_ms"].append(_events_ms(one))
        out["sharded_ms"].append(_events_ms(sharded))
    out["kernel_graph_ms"] = [_graph_ms(one) for _ in range(3)]
    if tag == "this":
        from rabia_tpu_torch.kernel import mesh_window, packed_window

        empty = lambda: cluster_round.CLUSTER_ROUND.start_slot_blocks(  # noqa: E731
            [(list(st), every, v1)], empty=True)
        out["start_slot_turns_ms"] = _turns({
            "kernel": one, "empty at its grid": empty,
            "mesh window's empty": lambda: mesh_window.MESH_WINDOW.empty(1, S, dev)}, 6, 500)
        T = 32768
        codes = torch.randint(0, 4, (R, T, S), generator=gen, device=dev, dtype=torch.int8)
        alive = torch.rand((R, S), generator=gen, device=dev) < 0.8
        both = packed_window.pack_inputs(codes, alive)
        if not (torch.equal(both[0], packed_window.pack_codes_plain(codes))
                and torch.equal(both[1], packed_window.pack_alive_plain(alive))):
            raise AssertionError("pack_inputs != pack_codes_plain, pack_alive_plain")
        out["packers_turns_ms"] = _turns({
            "pack_codes": lambda: packed_window.pack_codes(codes),
            "pack_inputs": lambda: packed_window.pack_inputs(codes, alive),
            "pack_codes then pack_alive": lambda: (packed_window.pack_codes(codes),
                                                   packed_window.pack_alive(alive)),
        }, 4, 50)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="another tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "TAG"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(*args.child)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_start_slot_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.other:
        ap.error("OTHER_ROOT is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cpu = next((line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo")
                if line.startswith("model\t")), "unknown")
    print(f"card: {smi}; host CPU model {cpu}", flush=True)
    for _ in range(args.rounds):
        for root, tag in ((args.other, "other"), (HERE, "this"), (HERE, "this"),
                          (args.other, "other")):
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, tag],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                print(r.stderr[-4000:], file=sys.stderr)
                return r.returncode
            print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
