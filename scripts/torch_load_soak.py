"""Load soak: run the port's test suite repeatedly under synthetic CPU load.

The counterpart of ``scripts/load_soak.py`` for ``rabia_tpu_torch``: the
same hogs, runs and JSON report. With no pytest arguments it runs the
port's tests (``tests/test_torch_*.py``); arguments that name no test
file are added to those, and arguments that do name test files (or
directories) replace them.

A timing-sensitive test that drops under a noisy co-tenant shows up
here on demand: the harness spawns duty-cycled CPU hog processes (spin
``duty`` of every 100ms slice, sleep the rest — a noisy co-tenant rather
than total starvation) and runs the tests ``--runs`` times underneath
them::

    python scripts/torch_load_soak.py [--runs 5] [--duty 0.6] [--hogs 1] [-- PYTEST_ARGS]

Exits nonzero if any run fails; prints one JSON line per run and a
summary line at the end.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _hog(duty: float, stop_flag) -> None:
    """Busy-spin ``duty`` of every 100ms slice until the flag is set."""
    slice_s = 0.1
    while not stop_flag.is_set():
        start = time.monotonic()
        budget = start + slice_s * duty
        while time.monotonic() < budget:
            pass  # burn
        rest = start + slice_s - time.monotonic()
        if rest > 0:
            time.sleep(rest)


_FAIL_RE = re.compile(r"^(FAILED|ERROR) (\S+)", re.MULTILINE)


def port_tests() -> list[str]:
    """The port's test files, relative to the repo."""
    return sorted(str(p.relative_to(REPO)) for p in (REPO / "tests").glob("test_torch_*.py"))


def targets(pytest_args: list[str]) -> list[str]:
    """What one run hands pytest: the port's tests plus the arguments,
    or the arguments alone when they name test paths."""
    names_paths = any(
        not a.startswith("-") and (REPO / a.split("::")[0]).exists() for a in pytest_args
    )
    return list(pytest_args) if names_paths else [*port_tests(), *pytest_args]


def run_suite(run_idx: int, pytest_args: list[str]) -> dict:
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", *targets(pytest_args)],
        cwd=REPO,
        capture_output=True,
        text=True,
        env={**os.environ, "RABIA_LOAD_SOAK": "1"},
    )
    elapsed = time.monotonic() - t0
    failures = [m.group(2) for m in _FAIL_RE.finditer(proc.stdout)]
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    return {
        "run": run_idx,
        "ok": proc.returncode == 0,
        "elapsed_s": round(elapsed, 1),
        "failures": failures,
        "tail": tail,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument(
        "--duty",
        type=float,
        default=0.6,
        help="fraction of each 100ms slice the hog burns (0..0.95)",
    )
    ap.add_argument(
        "--hogs",
        type=int,
        default=multiprocessing.cpu_count(),
        help="number of hog processes (default: one per CPU)",
    )
    ap.add_argument(
        "pytest_args",
        nargs="*",
        help="extra args forwarded to pytest (after --)",
    )
    args = ap.parse_args(argv)
    duty = min(max(args.duty, 0.0), 0.95)

    stop = multiprocessing.Event()
    hogs = [
        multiprocessing.Process(target=_hog, args=(duty, stop), daemon=True)
        for _ in range(args.hogs)
    ]
    for h in hogs:
        h.start()

    results = []
    try:
        for i in range(args.runs):
            rec = run_suite(i, args.pytest_args)
            results.append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        stop.set()
        for h in hogs:
            h.join(timeout=2)
            if h.is_alive():
                h.terminate()

    ok_runs = sum(1 for r in results if r["ok"])
    summary = {
        "summary": True,
        "runs": len(results),
        "green": ok_runs,
        "duty": duty,
        "hogs": args.hogs,
        "all_failures": sorted({f for r in results for f in r["failures"]}),
    }
    print(json.dumps(summary), flush=True)
    return 0 if ok_runs == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
