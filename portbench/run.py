#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds the port (``rabia_tpu_torch``).
The cell's traffic file names its driver; the run sets the driver up
(``setup_s`` runs from the start of this process to the window's start:
the CUDA context, the kernels' build or load, the table's load phase and
the warm-up), measures for ``--seconds``, reads the device's peak memory,
then holds what the window produced to the plain reference. With
``--trace 0`` the result line holds the cell's end-to-end metrics; with
``--trace 1`` the window runs under the profiler and the line holds the
per-layer metrics, ``busy_s``, ``window_s`` and the breakdown.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``checks`` last); the
last lines of standard error are each compared number beside its limit.
Without a CUDA card with as many devices as the cell asks for, or with
the JAX package loaded once the window has closed, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

# module names that no process of the benchmark may hold: JAX and the
# package the port was made from (whole top-level names)
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "rabia_tpu", "benchmarks", "bench"))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc builds go to ``build/rabia_tpu_torch/`` by itself);
    nothing loads JAX through a library that would."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def _power_limit(device) -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return got.stdout.strip() or "unknown"


def _print_host_use(a, b) -> None:
    """The CPU seconds the process (all its threads) took in the window."""
    print(f"window host use: cpu user {b.ru_utime - a.ru_utime:.2f} s, sys "
          f"{b.ru_stime - a.ru_stime:.2f} s", file=sys.stderr)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` on ``device``: the result object, less the
    checks on the platform. ``t_start`` is when set-up began."""
    import torch

    from pbench import spec
    from pbench.trace import DeviceTrace, Spans

    drv = spec.driver(cell.traffic["driver"])
    print(f"set-up: to the driver {time.perf_counter() - t_start:.2f} s", file=sys.stderr)
    st = drv.setup(cell, seed, device)
    prof = None
    if trace:
        prof = DeviceTrace(device)
        prof.start()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    # set-up's objects leave the collector's scans: its pauses in the
    # window are the window's own garbage
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    run = drv.window(st, float(seconds), Spans(trace))
    _print_host_use(use0, resource.getrusage(resource.RUSAGE_SELF))
    if prof is not None:
        prof.stop()
        run["trace"] = prof.summary()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t_check = time.perf_counter()
    try:
        checks = drv.check(st, run)
    except Exception:  # a check that cannot finish is a run that is not correct
        traceback.print_exc()
        checks = {"check_finished": (1, 0)}
    print(f"check: {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    if "demotions" in run:
        print(f"lane demotions in the window: {run['demotions']}", file=sys.stderr)
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        metrics = spec.read_metrics(cell, run)
        t = run.get("trace", {})
        device_info.update(busy_s=t.get("busy_s", 0.0), window_s=t.get("window_s", 0.0))
    else:
        metrics = {}
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else run["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(v <= limit for v, limit in checks.values())
    failed = int(checks.get("unsettled_ops", (0, 0))[0])
    out = {"correct": bool(correct), "attempted": int(run["attempted"]), "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace and run.get("trace"):
        out["breakdown"] = run["trace"]["breakdown"]
    out["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    from pbench import spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell {cell.name} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    print(f"card: {out['device']['kind']}, power limit {_power_limit(device)}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"the process holds modules it must not: {', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps(out))
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
