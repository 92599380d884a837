"""Run the port's chaos profiles, or chip_smoke.py's phases 14-15, alone.

    python3 scripts/torch_chaos_probe.py --profile coalesce_flap_restart --runs 10
    python3 scripts/torch_chaos_probe.py --profile mesh_device_read_lane --shards 4096 --replicas 5 --device cuda
    python3 scripts/torch_chaos_probe.py --profile mesh_device_read_lane --mesh 4,1 --device cpu
    python3 scripts/torch_chaos_probe.py --phases 14,15 --device cuda

The first two forms run one of ``chaos.smoke_profiles()`` ``--runs`` times
through ``run_profile`` (the mesh fabric's engine on ``--device``, over a
logical ``--mesh A,B`` of it, A shard blocks x B replica blocks, where
given; its width from ``--shards`` / ``--replicas``) and print, a run a
line, its
pass, problems, outcomes, availability, settle p50/p99 and seconds, the
critical-path gate's control, fault and recovered milliseconds with the
recovery probes' segments, and the mesh fabric's summary (with how long
each device-lane demotion and re-promotion held the event loop).

The third form builds what chip_smoke.py's phases 14 and 15 need (the
native host libraries, the kv kernels, the host pack) and runs
``chip_smoke.fleet_run`` and ``chaos_run`` on ``--device``, printing their
results as JSON lines. A card is needed for ``--device cuda``.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_profiles(name: str, runs: int, device: str, shards: int, replicas: int,
                 mesh_shape: str = "") -> None:
    import torch

    from rabia_tpu_torch.chaos import run_profile, smoke_profiles
    from rabia_tpu_torch.parallel import make_mesh

    prof = smoke_profiles()[name]
    if prof.fabric == "mesh":
        prof = dataclasses.replace(prof, n_shards=shards or prof.n_shards,
                                   n_replicas=replicas or prof.n_replicas)
    where = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    a, b = (int(x) for x in mesh_shape.split(",")) if mesh_shape else (0, 0)
    for k in range(runs):
        # a fresh mesh a run: a logical mesh of A x B positions of the one device
        mesh = make_mesh([device] * (a * b), a, b) if a else None
        t0 = time.perf_counter()
        rep = asyncio.run(run_profile(prof, verbose=False, device=None if mesh else device,
                                      mesh=mesh))
        cp = rep["critpath"] or {}
        print(json.dumps({
            "profile": name, "run": k, "device": where, "pass": rep["pass"],
            "problems": rep["problems"], "outcomes": rep["outcomes"],
            "availability": rep["availability"],
            "final_quarter_availability": rep["final_quarter_availability"],
            "settle_ms": rep["settle_ms"], "s": time.perf_counter() - t0,
            "critpath": {x: cp.get(x) for x in ("control_ms", "fault_ms", "recovered_ms",
                                                "threshold_ms")},
            "recovery_probes": [
                {x: r.get(x) for x in ("exemplars", "truncated", "worst_ms", "segments_ms")}
                for r in cp.get("rows", []) if "max_age_s" in r
            ],
            "fabric_summary": rep["fabric_summary"],
        }), flush=True)


def build(device: str) -> None:
    """The native host libraries, and on a card the kv and mesh kernels
    and the host pack (one compiler a source, together)."""
    import chip_smoke as cs
    from rabia_tpu_torch.apps.device_kv import HOST_PACK
    from rabia_tpu_torch.kernel import cuda_build, kv_window, mesh_window
    from rabia_tpu_torch.native import build as native_build

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(native_build.build, *cs.NATIVE_LIBS)
        if device == "cuda":
            cuda_build.build(["kv_window", "kv_dict", "kv_read", "mesh_window"])
            cuda_build.build_host("host_pack")
        native.result()
    if device == "cuda":
        HOST_PACK.load()
        kv_window.KV_WINDOW.load()
        mesh_window.MESH_WINDOW.load()


def run_phases(phases: set, device: str) -> None:
    import torch

    import chip_smoke as cs

    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    if "14" in phases:
        cs._reset_counts()
        t0 = time.perf_counter()
        out = asyncio.run(cs.fleet_run(dev))
        mesh = out.pop("_mesh")
        print(out.pop("fleet_table"))
        if dev.type == "cuda":
            out["probe_graph_ms"], out["probe_max_abs_err"] = cs.probe_graph_ms(mesh, cs.S_FULL)
        print(json.dumps({"phase": 14, "s": time.perf_counter() - t0,
                          "launches": cs._kernel_counts(), **out}), flush=True)
    if "15" in phases:
        cs._reset_counts()
        t0 = time.perf_counter()
        out = cs.chaos_run(dev)
        print(json.dumps({"phase": 15, "s": time.perf_counter() - t0,
                          "launches": cs._kernel_counts(), **out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", help="a name of chaos.smoke_profiles()")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--shards", type=int, default=0, help="the mesh profile's width")
    ap.add_argument("--replicas", type=int, default=0)
    ap.add_argument("--mesh", default="", help="the mesh profile's logical mesh of the device: "
                    "A,B (shard blocks, replica blocks)")
    ap.add_argument("--phases", default="", help="chip_smoke phases to run: 14, 15")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    build(a.device)
    if a.phases:
        run_phases(set(a.phases.split(",")), a.device)
    if a.profile:
        run_profiles(a.profile, a.runs, a.device, a.shards, a.replicas, a.mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
