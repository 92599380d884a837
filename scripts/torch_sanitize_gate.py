"""Sanitizer stress matrix driver for the PyTorch/CUDA port's native host
plane (the enforced TSan/ASan/UBSan gate).

The counterpart of ``scripts/sanitize_gate.py`` over
``rabia_tpu_torch/native/`` (the same flavors, cells, selfcheck, logs
and exit codes; binaries under ``build/rabia_tpu_torch/stress/``).
Host-only: it reads no device.

Builds the native stress programs (rabia_tpu_torch/native/stress/) under a
sanitizer flavor and runs them with halt_on_error — any data race, leak,
or UB exits nonzero and fails the gate. This is the working replacement
for the retired gcc-10 probe-SKIP path: build.py's
find_sanitizer_toolchain PROVES the toolchain first (a race-free timed-
condvar probe must run clean AND a planted bug must be caught; on gcc
the pthread_cond_clockwait shim makes TSan viable), so a SKIP can only
mean "no viable toolchain on this machine", never "reports are noise".

Usage:
  python scripts/torch_sanitize_gate.py --flavor tsan            # all programs
  python scripts/torch_sanitize_gate.py --flavor asan --programs wal,session
  python scripts/torch_sanitize_gate.py --flavor tsan --selfcheck
  python scripts/torch_sanitize_gate.py --flavor ubsan --log-dir build/sanitizer-logs

--selfcheck builds the deliberately-broken probe and asserts the gate
goes RED on it (proof the matrix fails on a real finding). --log-dir
saves each cell's full output (CI uploads these as failure artifacts).

Exit codes: 0 all cells pass, 1 a cell failed, 3 no viable toolchain
(one SKIP line on stdout; CI treats 3 as failure via --no-skip).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from rabia_tpu_torch.native import build as nb  # noqa: E402


def run_cell(
    name: str, flavor: str, log_dir: Path | None, timeout: float
) -> bool:
    t0 = time.monotonic()
    exe = nb.build_stress(name, flavor)
    build_s = time.monotonic() - t0
    with tempfile.TemporaryDirectory(prefix="sanitize-wal-") as tmp:
        args = [str(exe)]
        if name in ("wal", "runtime_mt"):
            args.append(tmp)  # these stress a real on-disk WAL
        t1 = time.monotonic()
        proc = subprocess.run(
            args, capture_output=True, text=True, timeout=timeout,
            env=nb.stress_env(flavor),
        )
        run_s = time.monotonic() - t1
    ok = proc.returncode == 0
    status = "PASS" if ok else f"FAIL rc={proc.returncode}"
    print(
        f"{flavor}/{name:<12} {status}  "
        f"(build {build_s:.1f}s, run {run_s:.1f}s)"
    )
    if log_dir is not None:
        log_dir.mkdir(parents=True, exist_ok=True)
        (log_dir / f"{flavor}-{name}.log").write_text(
            proc.stdout + "\n--- stderr ---\n" + proc.stderr
        )
    if not ok:
        sys.stderr.write(proc.stdout[-1000:] + proc.stderr[-4000:] + "\n")
    return ok


def run_selfcheck(flavor: str) -> bool:
    """The red-on-failure proof: a planted bug must FAIL the gate."""
    exe = nb.build_selfcheck(flavor)
    caught = False
    for _ in range(5):  # races are probabilistic; five shots
        proc = subprocess.run(
            [str(exe)], capture_output=True, text=True, timeout=120,
            env=nb.stress_env(flavor),
        )
        if proc.returncode != 0:
            caught = True
            break
    print(
        f"{flavor}/selfcheck   "
        + ("PASS (planted bug caught)" if caught
           else "FAIL (planted bug NOT caught — gate is blind)")
    )
    return caught


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--flavor", required=True,
                    choices=sorted(nb.SAN_FLAGS))
    ap.add_argument("--programs", default="",
                    help="comma list (default: all)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="assert the gate catches a planted bug")
    ap.add_argument("--log-dir", default="",
                    help="save per-cell logs here (CI artifacts)")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--no-skip", action="store_true",
                    help="treat a missing toolchain as failure (CI)")
    args = ap.parse_args(argv)

    tc = nb.find_sanitizer_toolchain(args.flavor)
    if tc is None:
        reason = getattr(nb.find_sanitizer_toolchain, "reason", "unknown")
        print(f"SKIP (no viable {args.flavor} toolchain): {reason}")
        return 1 if args.no_skip else 3
    print(f"{args.flavor} toolchain: {tc['cxx']}"
          + (" + clockwait shim" if tc["extra_sources"] else ""))

    ok = True
    if args.selfcheck:
        ok = run_selfcheck(args.flavor) and ok
    names = (
        [n.strip() for n in args.programs.split(",") if n.strip()]
        or sorted(nb.STRESS_PROGRAMS)
    )
    log_dir = Path(args.log_dir) if args.log_dir else None
    for name in names:
        ok = run_cell(name, args.flavor, log_dir, args.timeout) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
