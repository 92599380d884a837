"""Time the port's [T, S, R] fused-window kernel beside other builds of it,
on one GPU.

    python3 scripts/torch_fused_window_ab.py OTHER_FUSED_WINDOW_CU ... [--reps 32] [--rounds 2]

Each OTHER_FUSED_WINDOW_CU is a ``fused_window.cu`` with the same C
interface (``rw_fused_window_tsr``), its headers beside it, for example
from an earlier commit unpacked with ``git archive`` into a directory
that .gitignore lists. Every build is made with nvcc (sm_90a), checked
bit for bit against the plain closed form, and timed on the window that
``chip_smoke.py`` times (S=4096, R=5, T=32768 [T, S, R] votes, with and
without the phase plane): CUDA events around a chain of launches over
two vote buffers, in turns (this, others..., others reversed, this) each
round. Prints the card as nvidia-smi names it and one JSON line. Exits
non-zero without a GPU.
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
from rabia_tpu_torch.core.types import quorum_size  # noqa: E402
from rabia_tpu_torch.kernel import cuda_build, fused_window  # noqa: E402


def other_kernel(src: Path, i: int) -> fused_window.FusedWindowTSRKernel:
    """A [T, S, R] wrapper bound to ``src`` built into its own library."""
    out = cuda_build.BUILD_DIR / "ab" / f"libfused_window_other{i}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-I{src.parent}", "-o", str(out), str(src)],
        capture_output=True, text=True,
    )
    print(f"{src}:\n{proc.stdout}{proc.stderr}".strip())
    proc.check_returncode()
    kern = fused_window.FusedWindowTSRKernel()
    lib = ctypes.CDLL(str(out))
    fn = lib.rw_fused_window_tsr
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    kern._lib, kern._fn = lib, fn
    return kern


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=32)
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
    kernels = {"this": fused_window.FUSED_WINDOW_TSR}
    kernels["this"].load()
    for i, src in enumerate(args.others):
        kernels[str(src)] = other_kernel(src, i)

    S, R, T = chip_smoke.S_FULL, chip_smoke.R_FULL, chip_smoke.T_FULL
    q = quorum_size(R)
    gen = torch.Generator(device=dev).manual_seed(5)
    bufs = [chip_smoke._random_votes((T, S, R), gen, dev) for _ in range(2)]
    alive = chip_smoke._alive((S, R), gen, dev, p_dead=0.2)
    want = fused_window.closed_form_window(bufs[0], alive, q)
    for name, kern in kernels.items():
        got = kern(bufs[0], alive, q)
        torch.cuda.synchronize(dev)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name} differs from the plain closed form")
    del want

    order = list(kernels) + list(kernels)[::-1]
    times = {name: {"phase_ms": [], "no_phase_ms": []} for name in kernels}
    for _ in range(args.rounds):
        for name in order:
            kern = kernels[name]
            for key, want_phase in (("phase_ms", True), ("no_phase_ms", False)):
                times[name][key].append(chip_smoke._time_ms(
                    lambda i=0, k=kern, p=want_phase: k(bufs[i % 2], alive, q, want_phase=p),
                    args.reps))
    rate = chip_smoke._card_rate_bytes_per_s(torch.cuda.get_device_name(0))
    nbytes = R * T * S + R * S + T * S
    bound = {"phase_ms": (nbytes + 4 * T * S) / rate * 1e3, "no_phase_ms": nbytes / rate * 1e3}
    print(smi)
    print(json.dumps({
        "shape": {"S": S, "R": R, "T": T}, "bound_ms": bound,
        "times": times,
        "share_of_bound": {name: {key: [bound[key] / t for t in ts] for key, ts in tt.items()}
                           for name, tt in times.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
