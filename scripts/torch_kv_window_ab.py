"""Time the port's kv-window kernel beside another build of it, on one GPU.

    python3 scripts/torch_kv_window_ab.py OTHER_KV_WINDOW_CU [--reps 50] [--rounds 2]

OTHER_KV_WINDOW_CU is a ``kv_window.cu`` with the same C interface
(``kvw_window``), for example from an earlier commit unpacked with
``git archive`` into a directory that .gitignore lists. Both are built
with nvcc (sm_90a), checked bit for bit against the plain version, and
timed on the W=16 mixed window over a full S=4096 x P=64 table (32 B
keys, 64 B values) that ``chip_smoke.py`` times: device time per window
by CUDA graph replay, in turns (other, this, this, other) each round.
Prints the card as nvidia-smi names it and one JSON line. Exits non-zero
without a GPU.
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


def other_kernel(src: Path) -> kv_window.KVWindowKernel:
    """A kv-window wrapper bound to ``src`` built into its own library."""
    out = cuda_build.BUILD_DIR / "ab" / "libkv_window_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-I{src.parent}", "-o", str(out), str(src)],
        check=True, capture_output=True, text=True,
    )
    kern = kv_window.KVWindowKernel()
    fn = ctypes.CDLL(str(out)).kvw_window
    vpp = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [vpp, vpp, vpp, vpp, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kern._fn = fn
    return kern


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
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
    this, other = kv_window.KV_WINDOW, other_kernel(args.other)
    this.load()

    S, P, K4, VW4, W = chip_smoke.S_FULL, chip_smoke.P_FULL, 8, 16, 16
    gen = torch.Generator(device=dev).manual_seed(8)
    table, ops, _ = chip_smoke.random_kv_case(gen, S, P, K4, VW4, W, K4, VW4, dev, p_used=1.0)
    want = kv_window.kv_window_plain(table, *ops, W, want_reads=True)
    for kern in (this, other):
        got = kern(table, *ops, W, want_reads=True)
        torch.cuda.synchronize(dev)
        planes = [*zip(want[0], got[0]), (want[1], got[1]), *zip(want[2], got[2])]
        if not all(torch.equal(a, b) for a, b in planes):
            raise AssertionError("a kv-window kernel differs from the plain version")

    times = {"this": [], "other": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            kern = this if name == "this" else other
            times[name].append(chip_smoke._graph_ms(
                lambda i=0, k=kern: k(table, *ops, W, want_reads=True), args.reps))
    tbl_bytes = sum(x.numel() * x.element_size() for x in table)
    op_bytes = sum(x.numel() * x.element_size() for x in ops)
    read_bytes = W * S * (1 + 4 + 4 + 4 * VW4) + S
    bound_ms = (2 * tbl_bytes + op_bytes + read_bytes) / chip_smoke._card_rate_bytes_per_s(
        torch.cuda.get_device_name(0)) * 1e3
    print(smi)
    print(json.dumps({
        "shape": {"S": S, "P": P, "K4": K4, "VW4": VW4, "W": W, "kinds": "mixed"},
        "other": str(args.other), "bound_ms": bound_ms,
        "this_ms": times["this"], "other_ms": times["other"],
        "this_share_of_bound": [bound_ms / t for t in times["this"]],
        "other_share_of_bound": [bound_ms / t for t in times["other"]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
