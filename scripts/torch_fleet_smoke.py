#!/usr/bin/env python
"""Routed-fleet CI smoke on the PyTorch/CUDA port: ring rebalance mid-run,
exactly-once asserted.

The counterpart of ``scripts/fleet_smoke.py`` over ``rabia_tpu_torch``
(the same profile, gates, report and exit codes). Host-only: it reads
no device.

Drives the chaos plane's fleet fabric (2 fleet gateways fronting a
3-replica real-TCP cluster) under sustained open-loop load while the
hash ring shrinks to one member mid-wave and then grows back — the
handoff path in both directions. The run fails unless:

- goodput is non-zero through both rebalances (availability floor);
- the post-run exactly-once sweep passes: every acked Result replays
  byte-identically on the CURRENT owner, and the replica KV stores'
  mutation counters do not move during the replays (zero dup-applies —
  the same version-parity gate tests/test_torch_fleet.py pins in-process);
- the cluster reconverges.

This is the CI cell for the routed tier's REBALANCE story; the chaos
matrix smoke covers the gateway-KILL story (routed_gateway_failover).
docs/FLEET.md has the failure matrix both cells execute.

Usage: python scripts/torch_fleet_smoke.py [--scale 1.0] [--out report.json]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rabia_tpu_torch.chaos.profiles import ChaosEvent, ChaosProfile  # noqa: E402
from rabia_tpu_torch.chaos.runner import run_profile  # noqa: E402

PROFILE = ChaosProfile(
    name="fleet_rebalance_smoke",
    fabric="fleet",
    description=(
        "shrink the ring to one member mid-wave (sessions hand off, "
        "stale clients follow MOVED), then grow it back"
    ),
    duration=8.0,
    warmup=1.0,
    rate=60.0,
    n_gateways=2,
    events=(
        ChaosEvent(3.0, "rebalance", {"members": [1]}),
        ChaosEvent(5.5, "rebalance", {"members": [0, 1]}),
    ),
    min_availability=0.5,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=(__doc__ or "").split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="time-scale the profile (CI uses < 1 on slow boxes)")
    ap.add_argument("--out", default=None,
                    help="also write the run report JSON here")
    args = ap.parse_args(argv)

    rep = asyncio.run(run_profile(PROFILE.scaled(args.scale), verbose=True))
    if args.out:
        Path(args.out).write_text(json.dumps(rep, indent=1))

    problems = list(rep.get("problems") or [])
    if rep["outcomes"].get("ok", 0) <= 0:
        problems.append("zero goodput through the rebalances")
    print(
        f"fleet smoke: ok={rep['outcomes'].get('ok', 0)} "
        f"avail={rep.get('availability')} converged={rep.get('converged')} "
        f"{'PASS' if rep.get('pass') and not problems else 'FAIL'}"
    )
    if not rep.get("pass") or problems:
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
