"""Where the host time of chip_smoke.py's phase 11 goes.

    python3 scripts/torch_apps_profile.py --parts c,d --device cuda
    python3 scripts/torch_apps_profile.py --parts c --shards 512 --device cpu

Runs parts of phase 11 (``chip_smoke.counter_config1``, ``kv_config2``,
``kv_config3``, ``bank_config4``: BASELINE.json configs 1-4, a transport
cluster beside a MeshEngine on ``--device``) under cProfile, and prints
for each part its own summary line, the profiled seconds summed by layer
(the client service and batcher, the apps' apply, the wire codec, the
engine, the in-memory hub and simulator, the flight recorder, asyncio
and the event loop's idle wait, json, the device engine and its torch
calls), and the functions with the most time of their own. cProfile
slows Python about twofold and leaves native code as it is, so read the
shares, not the seconds. On a card the kernels are built before the
first profile. ``--shards`` cuts a part's shard count (at its
full replicas and widths); without it each part runs at its full size.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# (layer, path fragments of the functions it owns), first match wins
LAYERS = (
    ("event loop idle (epoll)", ("select.epoll",)),
    ("service + batcher", ("apps/sharded.py", "core/batching.py")),
    ("apps' apply", ("apps/kvstore.py", "apps/counter.py", "apps/banking.py", "core/smr.py")),
    ("wire codec", ("core/serialization.py", "core/messages.py")),
    ("engine", ("rabia_tpu_torch/engine/", "kernel/host_driver.py")),
    ("hub + simulator", ("rabia_tpu_torch/net/",)),
    ("flight recorder + metrics", ("rabia_tpu_torch/obs/",)),
    ("device engine", ("parallel/", "apps/device_kv.py", "apps/vector_kv.py", "kernel/",
                       "torch.", "torch._C")),
    ("asyncio", ("asyncio/",)),
    ("json", ("json/", "_json")),
    ("phase 11 harness", ("chip_smoke.py",)),
)


def _layer(path: str) -> str:
    for name, frags in LAYERS:
        if any(f in path for f in frags):
            return name
    return "other (builtins, numpy, uuid, ...)"


def _run(part: str, device: str, shards) -> dict:
    kw = {} if shards is None else {"S": shards}
    if part == "a":
        return chip_smoke.counter_config1(device)
    if part == "b":
        return chip_smoke.kv_config2(device, **kw)
    if part == "c":
        return chip_smoke.kv_config3(device, **kw)
    return chip_smoke.bank_config4(device, **kw)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="c,d", help="comma list of a, b, c, d")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        # build the kernels and the host pack first, as chip_smoke.py's
        # phase 1 does, so that no part's profile holds a build
        from rabia_tpu_torch.apps.device_kv import HOST_PACK
        from rabia_tpu_torch.kernel import kv_window, mesh_window

        kv_window.KV_WINDOW.load()
        mesh_window.MESH_WINDOW.load()
        HOST_PACK.load()
    for part in args.parts.split(","):
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        stats = _run(part, args.device, args.shards)
        prof.disable()
        wall = time.perf_counter() - t0
        st = pstats.Stats(prof)
        by_layer: dict = {}
        total = 0.0
        for (path, _line, fn), (_cc, _nc, tottime, _ct, _callers) in st.stats.items():
            layer = _layer(f"{path}:{fn}")
            by_layer[layer] = by_layer.get(layer, 0.0) + tottime
            total += tottime
        print(f"part ({part}) under cProfile, {wall:.2f} s wall: "
              + ", ".join(f"{k} {v:.6g}" for k, v in sorted(stats.items())
                          if not isinstance(v, (dict, list))))
        print(f"  profiled seconds by layer (own time, of {total:.3f} s): " + ", ".join(
            f"{k} {v:.3f} ({100 * v / total:.1f}%)"
            for k, v in sorted(by_layer.items(), key=lambda kv: -kv[1])))
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(args.top)
        print(buf.getvalue())


if __name__ == "__main__":
    main()
