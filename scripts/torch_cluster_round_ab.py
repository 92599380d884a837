"""Time the port's round kernels beside other builds of them, on one GPU.

    python3 scripts/torch_cluster_round_ab.py OTHER_CLUSTER_ROUND_CU ... [--reps 8] [--rounds 2]

Each OTHER_CLUSTER_ROUND_CU is a ``cluster_round.cu`` with the same C
interface (``cr_slot_pipeline``, ``cr_rounds``), its headers beside it,
for example from an earlier commit unpacked with ``git archive`` into a
directory that .gitignore lists. Every build is made with nvcc (sm_90a)
and checked bit for bit against the plain ``slot_pipeline_wide_plain``
on the scan that ``chip_smoke.py`` times (S=4096, R=5, T=8192 [T, S, R]
votes under a crash mask, 2 rounds a slot) and against the plain loop on
the selftest's fault path (80 rounds at p_deliver 0.6, two replicas
down), and that launch with one mask for every round (mask stride 0)
and with none (full delivery) against the plain round on the same
masks. Then, in turns (this, others..., others reversed, this) each
round, it times the scan at 2 and at 4 rounds a slot (CUDA events around
a chain of launches over two vote buffers) and the fault path's one
launch of 80 rounds under each of the three mask forms (CUDA graph
replay), and, once a round, an empty kernel of as many threads as the
round kernel's 256 blocks of 128 (the floor of a launch). Prints the
card as nvidia-smi names it and one JSON line.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from rabia_tpu_torch.kernel import cluster_round, cuda_build, mesh_window  # noqa: E402


def other_kernel(src: Path, i: int) -> cluster_round.ClusterRoundKernel:
    """A round-kernel wrapper bound to ``src`` built into its own library."""
    out = cuda_build.BUILD_DIR / "ab" / f"libcluster_round_other{i}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-I{src.parent}", "-o", str(out), str(src)],
        capture_output=True, text=True,
    )
    print(f"{src}:\n{proc.stdout}{proc.stderr}".strip())
    proc.check_returncode()
    kern = cluster_round.ClusterRoundKernel()
    kern.load(out)
    return kern


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kernels = {"this": cluster_round.CLUSTER_ROUND}
    kernels["this"].load()
    for i, src in enumerate(args.others):
        kernels[str(src)] = other_kernel(src, i)

    S, R, T = chip_smoke.S_FULL, chip_smoke.R_FULL, chip_smoke.T_SCAN
    sk, bufs, alive, _ = chip_smoke.scan_vs_fused(dev, S, R, T)
    kargs = sk._kernel_args()
    alive = alive.contiguous()
    want = sk.slot_pipeline_wide_plain(bufs[0], alive, T, block=256)
    fk, st0, falive, _ = chip_smoke.fault_path(dev, S)
    fgen = torch.Generator(device=dev).manual_seed(1)
    fmasks = torch.stack([torch.rand((S, R, R), generator=fgen, device=dev) < 0.6
                          for _ in range(80)])
    fields = [t.contiguous() for t in st0]
    falive = falive.contiguous()
    fwant = [t.contiguous() for t in fk.run_rounds_plain(
        st0, falive, 80, torch.Generator(device=dev).manual_seed(1), p_deliver=0.6)]
    masks = {"fault_ms": fmasks, "fault_stride0_ms": fmasks[0].contiguous(),
             "fault_none_ms": None}

    def plain_rounds(m):
        st = st0
        for k in range(80):
            d = torch.ones((S, R, R), dtype=torch.bool, device=dev) if m is None else (
                m if m.dim() == 3 else m[k])
            st = fk.round_step_plain(st, falive, d)
        return [t.contiguous() for t in st]

    fwants = {key: fwant if key == "fault_ms" else plain_rounds(m) for key, m in masks.items()}
    for name, kern in kernels.items():
        got = kern.slot_pipeline(bufs[0], alive, base=0, rounds=2, **kargs)
        torch.cuda.synchronize(dev)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name} differs from slot_pipeline_wide_plain")
        for key, m in masks.items():
            fgot = kern.rounds(fields, falive, m, 80, **fk._kernel_args())
            torch.cuda.synchronize(dev)
            if not all(torch.equal(a, b) for a, b in zip(fgot, fwants[key])):
                raise AssertionError(f"{name} differs from the plain rounds on the fault path "
                                     f"({key})")
    del want, fwant, fwants

    order = list(kernels) + list(kernels)[::-1]
    empty_ms = []
    times = {name: {"scan2_ms": [], "scan4_ms": [], **{key: [] for key in masks}}
             for name in kernels}
    for _ in range(args.rounds):
        empty_ms.append(chip_smoke._graph_ms(
            lambda: mesh_window.MESH_WINDOW.empty(1, S * 8, dev), 200))
        for name in order:
            kern = kernels[name]
            for key, rounds in (("scan2_ms", 2), ("scan4_ms", 4)):
                times[name][key].append(chip_smoke._time_ms(
                    lambda i=0, k=kern, r=rounds: k.slot_pipeline(
                        bufs[i % 2], alive, base=0, rounds=r, **kargs), args.reps))
            for key, m in masks.items():
                times[name][key].append(chip_smoke._graph_ms(
                    lambda k=kern, m=m: k.rounds(fields, falive, m, 80, **fk._kernel_args()), 20))
    rate = chip_smoke._card_rate_bytes_per_s(torch.cuda.get_device_name(0))
    bound = (T * S * (R + 1 + 4) + S * R) / rate * 1e3
    print(smi)
    print(json.dumps({
        "shape": {"S": S, "R": R, "T": T}, "scan_bytes_bound_ms": bound,
        "times": times, "empty_kernel_ms": empty_ms,
        "scan_share_of_bound": {name: {key: [bound / t for t in tt[key]]
                                       for key in ("scan2_ms", "scan4_ms")}
                                for name, tt in times.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
