#!/usr/bin/env python
"""Partitioned-groups CI smoke on the PyTorch/CUDA port: routed load over
2 durable process groups, a mid-run group rebalance, and an exactly-once
replay sweep.

The counterpart of ``scripts/group_smoke.py`` over ``rabia_tpu_torch``
(the same run, gates, report and exit codes). Host-only: it reads no
device.

Spawns 2 independent consensus groups (3 durable replica processes
each, own WAL subtree — :class:`rabia_tpu_torch.fleet.groups
.GroupProcHarness`) behind a grouped fleet gateway
(:class:`~rabia_tpu_torch.fleet.groups.GroupedFleetHarness`), drives
sustained routed load across the whole shard space, and mid-wave moves
one shard range between groups in the SAFE order (widen the new
owner's replicas, flip the routing tier, shrink the old). The run
fails unless:

- goodput is non-zero through the rebalance and no submit errors
  terminally (a mid-flip stale-route submit may shed retryable; the
  driver retries it through the flipped map);
- the post-run exactly-once sweep passes: every session's last acked
  Result replays byte-identically through the routing tier (session
  dedup across the flip, group ledger past it), and no group's applied
  frontier moves during the sweep (zero dup-applies);
- every group saw committed load (the 2-group claim is evidenced, not
  assumed) and each group's replicas converge to equal frontiers.

This is the CI cell for the GROUP rebalance story; the chaos matrix
smoke covers the group proposer-KILL story (group_proposer_kill).
docs/FLEET.md's group-map section has the failure matrix both execute.

Usage: python scripts/torch_group_smoke.py [--scale 1.0] [--out report.json]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rabia_tpu_torch.apps.kvstore import encode_set_bin  # noqa: E402
from rabia_tpu_torch.core.messages import AdminKind, ResultStatus  # noqa: E402
from rabia_tpu_torch.core.serialization import Serializer  # noqa: E402
from rabia_tpu_torch.fleet.groups import (  # noqa: E402
    GroupMap,
    GroupProcHarness,
    GroupedFleetHarness,
    moved_group_shards,
)
from rabia_tpu_torch.gateway.client import admin_fetch  # noqa: E402
from rabia_tpu_torch.obs.registry import parse_prometheus_text  # noqa: E402
from rabia_tpu_torch.testing.loadsession import LoadSession  # noqa: E402

N_SHARDS = 4
N_GROUPS = 2
N_REPLICAS = 3
N_SESSIONS = 8
BATCH = 4


async def _frontiers(harness: GroupProcHarness) -> dict:
    """``{(group, replica): applied_slots | None}`` scraped from every
    live replica's exposition."""
    out = {}
    for g, rh in harness.harnesses.items():
        for i, port in enumerate(rh.gw_ports):
            rp = rh.procs[i]
            if rp is None or rp.proc.poll() is not None:
                out[(g, i)] = None
                continue
            try:
                body = await admin_fetch(
                    "127.0.0.1", port, kind=int(AdminKind.METRICS),
                    timeout=10.0,
                )
                m = parse_prometheus_text(body.decode())
                out[(g, i)] = int(
                    m.get("rabia_engine_applied_slots_total", 0)
                )
            except Exception:
                out[(g, i)] = None
    return out


async def run(scale: float) -> dict:
    duration = 8.0 * scale
    rebalance_at = 3.0 * scale
    ser = Serializer()
    gm = GroupMap.initial(N_SHARDS, N_GROUPS)
    harness = GroupProcHarness(gm, n_replicas=N_REPLICAS)
    fleet = None
    problems: list[str] = []
    outcomes = {"ok": 0, "shed": 0, "error": 0, "timeout": 0}
    ok_by_group: dict[int, int] = {g: 0 for g in gm.groups()}
    rebalanced = False
    moved: dict[int, int] = {}
    loop = asyncio.get_event_loop()
    print(
        f"# group smoke: {N_GROUPS} groups x {N_REPLICAS} durable "
        f"replicas, {N_SHARDS} shards, {duration:.1f}s",
        file=sys.stderr,
    )
    t_start = time.perf_counter()
    await loop.run_in_executor(None, harness.start)
    print(
        f"# spawned in {time.perf_counter() - t_start:.1f}s",
        file=sys.stderr,
    )
    try:
        fleet = GroupedFleetHarness(
            gm.copy(), harness.upstream_addrs(), n_gateways=1
        )
        await fleet.start()
        port = fleet.gateways[0].port
        sessions = []
        for i in range(N_SESSIONS):
            s = LoadSession(ser)
            await s.connect("127.0.0.1", port)
            sessions.append(s)
        last_acked: dict = {}

        # the current map is what the DRIVER believes: ok-by-group
        # attribution follows the flip like a real router would
        live_map = gm

        async def fire(i: int, k: int) -> None:
            s = sessions[i]
            shard = i % N_SHARDS
            cmds = [
                encode_set_bin(f"gs-{i}-{k}-{j}", "w") for j in range(BATCH)
            ]
            try:
                res = await s.submit(shard, cmds, 15.0)
            except (asyncio.TimeoutError, TimeoutError):
                outcomes["timeout"] += 1
                return
            except Exception:
                outcomes["error"] += 1
                return
            if res.status == ResultStatus.RETRY:
                # mid-flip stale route: retry once through the flipped
                # map (the fleet tier re-resolves on the next submit)
                outcomes["shed"] += 1
                try:
                    res = await s.submit_seq(s._seq, shard, cmds, 15.0)
                except Exception:
                    outcomes["error"] += 1
                    return
            if res.status in (ResultStatus.OK, ResultStatus.CACHED):
                outcomes["ok"] += 1
                ok_by_group[live_map.group_of(shard)] += 1
                last_acked[s.client_id] = (
                    s._seq, shard, tuple(bytes(p) for p in res.payload)
                )
            else:
                outcomes["error"] += 1

        t0 = loop.time()
        k = 0
        pending: set = set()
        while loop.time() - t0 < duration:
            if not rebalanced and loop.time() - t0 >= rebalance_at:
                # SAFE order inside rebalance(): widen -> flip -> shrink
                new_map = await harness.rebalance(1, 2, 1)
                moved = moved_group_shards(gm, new_map)
                fleet.adopt_groups(new_map)
                live_map = new_map
                rebalanced = True
                print(
                    f"# t={loop.time() - t0:.1f}s rebalanced [1,2) -> "
                    f"group 1 (moved {moved})",
                    file=sys.stderr,
                )
            for i in range(N_SESSIONS):
                t = asyncio.ensure_future(fire(i, k))
                pending.add(t)
                t.add_done_callback(pending.discard)
            k += 1
            await asyncio.sleep(0.12)
        if pending:
            await asyncio.wait(pending, timeout=20.0)

        if not rebalanced:
            problems.append("rebalance never fired (run too short?)")
        for g, n in ok_by_group.items():
            if n <= 0:
                problems.append(f"group {g} committed zero ops")
        if outcomes["error"]:
            problems.append(f"{outcomes['error']} terminal errors")
        if outcomes["ok"] <= 0:
            problems.append("zero goodput through the rebalance")

        # exactly-once sweep: re-speak every session's last acked seq
        # through the routing tier on a FRESH connection — the fleet
        # session dedup (or the committing group's ledger) must answer
        # byte-identical, and no group's applied frontier may move.
        # Close the live sessions FIRST: the transport keys connections
        # by client_id, so the replay connection must be the only one.
        for s in sessions:
            await s.close()
        print("# running exactly-once replay sweep", file=sys.stderr)
        before = await _frontiers(harness)
        replay_bad = 0
        replayed = 0
        for cid, (seq, shard, want) in sorted(
            last_acked.items(), key=lambda kv: str(kv[0])
        ):
            s = LoadSession(ser, client_id=cid)
            try:
                await s.connect("127.0.0.1", port)
                res = await s.submit_seq(
                    seq, shard,
                    [encode_set_bin("sweep-replay", "X")] * len(want),
                    15.0,
                )
                replayed += 1
                if tuple(bytes(p) for p in res.payload) != want:
                    replay_bad += 1
            except Exception as e:
                problems.append(f"replay of seq {seq} failed: {e}")
            finally:
                await s.close()
        if replay_bad:
            problems.append(
                f"{replay_bad}/{replayed} replays non-identical — "
                "exactly-once broken"
            )
        await asyncio.sleep(0.5)
        after = await _frontiers(harness)
        moved_frontiers = {
            k_: (before[k_], after[k_])
            for k_ in before
            if before[k_] is not None
            and after[k_] is not None
            and after[k_] != before[k_]
        }
        if moved_frontiers:
            problems.append(
                f"replay sweep moved frontiers {moved_frontiers} — "
                "double apply"
            )

        # per-group convergence: equal frontiers across a group's
        # replicas (frontiers are PER GROUP — groups are independent)
        for g in harness.group_map.groups():
            vals = [
                after[(g, i)] for i in range(N_REPLICAS)
                if after.get((g, i)) is not None
            ]
            if len(set(vals)) > 1:
                problems.append(
                    f"group {g} replicas did not converge: {vals}"
                )
    finally:
        if fleet is not None:
            await fleet.stop()
        harness.stop()

    return {
        "groups": N_GROUPS,
        "replicas": N_REPLICAS,
        "shards": N_SHARDS,
        "duration_s": duration,
        "outcomes": outcomes,
        "ok_by_group": {str(g): n for g, n in ok_by_group.items()},
        "rebalanced": rebalanced,
        "moved_shards": {str(s): g for s, g in moved.items()},
        "replays": {"total": len(last_acked), "non_identical": replay_bad},
        "pass": not problems,
        "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=(__doc__ or "").split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="time-scale the run (CI uses < 1 on slow boxes)")
    ap.add_argument("--out", default=None,
                    help="also write the run report JSON here")
    args = ap.parse_args(argv)

    rep = asyncio.run(run(args.scale))
    if args.out:
        Path(args.out).write_text(json.dumps(rep, indent=1))
    print(
        f"group smoke: ok={rep['outcomes']['ok']} "
        f"by_group={rep['ok_by_group']} rebalanced={rep['rebalanced']} "
        f"{'PASS' if rep['pass'] else 'FAIL'}"
    )
    if not rep["pass"]:
        for p in rep["problems"]:
            print(f"  - {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
