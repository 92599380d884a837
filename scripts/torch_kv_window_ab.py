"""Time the port's kv-window kernel beside another build of it, on one GPU.

    python3 scripts/torch_kv_window_ab.py OTHER_KV_WINDOW_CU ... [--fold] [--reps 50] [--rounds 2]

Each OTHER_KV_WINDOW_CU is a ``kv_window.cu`` with the same C interface
(``kvw_window``, and with ``--fold`` ``kvw_decide_window``), its headers
beside it, for example from an earlier commit unpacked with ``git
archive`` into a directory that .gitignore lists. Every build is made
with nvcc (sm_90a), checked bit for bit against the plain version, and
timed on the W=16 mixed window over a full S=4096 x P=64 table (32 B
keys, 64 B values) that ``chip_smoke.py`` times (with ``--fold``, the
window with its decision folded in, R=5, every replica alive): device
time per window by CUDA graph replay, in turns (others, this, this,
others reversed) each round. Prints each build's register report, the
card as nvidia-smi names it and one JSON line. Exits non-zero without a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from rabia_tpu_torch.kernel import cuda_build, kv_window  # noqa: E402
from rabia_tpu_torch.parallel import MeshPhaseKernel  # noqa: E402


def other_kernel(src: Path, i: int, fold: bool) -> kv_window.KVWindowKernel:
    """A kv-window wrapper bound to ``src`` built into its own library."""
    out = cuda_build.BUILD_DIR / "ab" / f"libkv_window_other{i}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-I{src.parent}", "-o", str(out), str(src)],
        capture_output=True, text=True,
    )
    print(f"{src}:\n{proc.stdout}{proc.stderr}".strip())
    proc.check_returncode()
    kern = kv_window.KVWindowKernel()
    lib = ctypes.CDLL(str(out))
    vpp = ctypes.POINTER(ctypes.c_void_p)
    llp = ctypes.POINTER(ctypes.c_longlong)
    fn = lib.kvw_window
    fn.argtypes = [vpp, vpp, vpp, vpp, llp, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kern._lib, kern._fn = lib, fn
    if fold:
        kern._decide_fn = lib.kvw_decide_window
        kern._decide_fn.argtypes = [vpp, vpp, vpp, vpp, llp, vpp, llp, ctypes.c_void_p]
        kern._decide_fn.restype = ctypes.c_int
    return kern


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--fold", action="store_true", help="time the window with its decision")
    ap.add_argument("--reps", type=int, default=50)
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
    kernels = {"this": kv_window.KV_WINDOW}
    kernels["this"].load()
    print(cuda_build.library_path("kv_window").with_suffix(".log").read_text().strip())
    for i, src in enumerate(args.others):
        kernels[str(src)] = other_kernel(src, i, args.fold)

    S, P, K4, VW4, W = chip_smoke.S_FULL, chip_smoke.P_FULL, 8, 16, 16
    gen = torch.Generator(device=dev).manual_seed(8)
    table, ops, _ = chip_smoke.random_kv_case(gen, S, P, K4, VW4, W, K4, VW4, dev, p_used=1.0)
    mk = MeshPhaseKernel(S, chip_smoke.R_FULL, device=dev)
    alive = torch.ones((S, mk.R), dtype=torch.bool, device=dev)
    base = torch.zeros(S, dtype=torch.int32, device=dev)

    def call(kern):
        if args.fold:
            return kern.decide(table, *ops, W, alive, base, seed=mk.seed, coin_p1=mk.coin_p1,
                               max_phases=4, want_reads=True)
        return kern(table, *ops, W, want_reads=True)

    want = chip_smoke._flat(
        kv_window.decide_window_plain(mk, table, *ops, W, alive, base, 4, want_reads=True)
        if args.fold else kv_window.kv_window_plain(table, *ops, W, want_reads=True))
    for name, kern in kernels.items():
        got = chip_smoke._flat(call(kern))
        torch.cuda.synchronize(dev)
        if not all(torch.equal(a, b) for a, b in zip(want, got)):
            raise AssertionError(f"{name} differs from the plain version")

    times = {name: [] for name in kernels}
    order = list(kernels)[1:] + ["this", "this"] + list(kernels)[1:][::-1]
    for _ in range(args.rounds):
        for name in order:
            times[name].append(chip_smoke._graph_ms(
                lambda i=0, k=kernels[name]: call(k), args.reps))
    tbl_bytes = sum(x.numel() * x.element_size() for x in table)
    op_bytes = sum(x.numel() * x.element_size() for x in ops)
    read_bytes = W * S * (1 + 4 + 4 + 4 * VW4) + S
    bound_ms = (2 * tbl_bytes + op_bytes + read_bytes) / chip_smoke._card_rate_bytes_per_s(
        torch.cuda.get_device_name(0)) * 1e3
    print(smi)
    print(json.dumps({
        "shape": {"S": S, "P": P, "K4": K4, "VW4": VW4, "W": W, "kinds": "mixed",
                  "fold": args.fold},
        "bound_ms": bound_ms, "times_ms": times,
        "share_of_bound": {name: [bound_ms / t for t in ts] for name, ts in times.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
