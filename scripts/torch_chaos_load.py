"""Run one chaos smoke profile many times beside load, in the port and in
the reference, and count how often each gate fails.

    python3 scripts/torch_chaos_load.py --profile coalesce_flap_restart --runs 12 \\
        --packages port,ref [--workers 6] [--busy 2]

Each run is a fresh interpreter running ``run_profile(smoke_profiles()[NAME])``
of one package (``port``: ``rabia_tpu_torch`` of this tree; ``port@ROOT``:
the ``rabia_tpu_torch`` of another tree unpacked at ROOT, for example the
parent's by ``git archive``; ``ref``: the reference, ``rabia_tpu``, with
JAX on the CPU). ``--workers`` runs go at once, the packages' runs
interleaved, beside ``--busy`` busy-loop processes: the load of the test
suite on six xdist workers. A run that dies on a signal is a crash. It
prints one JSON line a run (package, pass, problems, availability,
seconds, or the crash and the end of its stderr), then one a package:
runs, passes, crashes and each gate's failures. The profile's gates,
timing and scale are the package's own. Runs on the CPU; needs no card.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import asyncio, json, sys, time
pkg, root, name = sys.argv[1:4]
if root:
    sys.path.insert(0, root)
if pkg == "ref":
    from rabia_tpu.chaos import smoke_profiles
    from rabia_tpu.chaos.runner import run_profile
else:
    from rabia_tpu_torch.chaos import smoke_profiles
    from rabia_tpu_torch.chaos.runner import run_profile
t0 = time.perf_counter()
rep = asyncio.run(run_profile(smoke_profiles()[name], verbose=False))
print(json.dumps({"pass": rep["pass"], "problems": rep["problems"],
                  "availability": rep.get("availability"),
                  "final_quarter": rep.get("final_quarter_availability"),
                  "seconds": time.perf_counter() - t0}))
"""


BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from rabia_tpu_torch.native import build
build.build("transport", "codec", "hostkernel", "statekernel", "runtime", "walkernel",
            "sessionkernel")
"""


def _gate(problem: str) -> str:
    """A problem's gate: a key phrase of its text, else its first 60 characters."""
    for key in ("did not return to the control band", "never burned above the control band",
                "wedged", "availability", "did not converge"):
        if key in problem:
            return key
    return problem[:60]


def run_one(spec: str, name: str) -> dict:
    pkg, _, root = spec.partition("@")
    root = os.path.abspath(root) if root else HERE
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=HERE)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", CHILD, pkg, root, name], capture_output=True,
                       text=True, env=env, timeout=600)
    if r.returncode != 0:
        return {"package": spec, "pass": False, "crash": r.returncode,
                "stderr": r.stderr[-600:], "seconds": time.perf_counter() - t0}
    return {"package": spec, **json.loads(r.stdout.strip().splitlines()[-1])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="coalesce_flap_restart")
    ap.add_argument("--runs", type=int, default=12, help="runs a package")
    ap.add_argument("--packages", default="port,ref")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--busy", type=int, default=2)
    args = ap.parse_args()
    specs = args.packages.split(",")
    jobs = [s for _ in range(args.runs) for s in specs]
    for spec in specs:  # build each port tree's native libraries before the load
        pkg, _, root = spec.partition("@")
        if pkg == "port":
            subprocess.run([sys.executable, "-c", BUILD, os.path.abspath(root) if root else HERE],
                           check=True, timeout=600)
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.busy)]
    results = []
    try:
        with concurrent.futures.ThreadPoolExecutor(args.workers) as pool:
            for res in pool.map(lambda s: run_one(s, args.profile), jobs):
                print(json.dumps(res), flush=True)
                results.append(res)
    finally:
        for p in busy:
            p.kill()
            p.wait()
    for spec in specs:
        rs = [r for r in results if r["package"] == spec]
        gates = collections.Counter(_gate(p) for r in rs for p in r.get("problems", []))
        print(json.dumps({"package": spec, "profile": args.profile, "runs": len(rs),
                          "passes": sum(r["pass"] for r in rs),
                          "crashes": sum("crash" in r for r in rs),
                          "gate_failures": dict(gates), "workers": args.workers,
                          "busy": args.busy, "cores": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
