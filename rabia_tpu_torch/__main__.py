"""`python -m rabia_tpu_torch` — environment doctor + end-to-end selftest.

The port of the reference's ``rabia_tpu/__main__.py``, its operations
commands over the port's modules. The report gives the package version,
torch and its CUDA build, the card (or none), whether ``nvcc`` is
present, and whether each native C++ component (codec, host kernel, TCP
transport) loads; ``--selftest`` then drives a miniature end-to-end
stack on the card (``--device cpu``: the plain versions on the CPU):
the slot-pipeline kernel deciding, ``start_slot`` and the fault path's
rounds under loss with two replicas down, and a ``MeshEngine`` commit
with three replicas agreeing.

Usage:
    python -m rabia_tpu_torch                    # environment report
    python -m rabia_tpu_torch --selftest         # + build and run the mini stack
    python -m rabia_tpu_torch --selftest --device cpu
    python -m rabia_tpu_torch stats <host:port>  # scrape a gateway's /metrics
    python -m rabia_tpu_torch stats <host:port> --kind health|journal
    python -m rabia_tpu_torch stats <host:port> --kind journal \\
        --journal-kind slow_tick --last 10
    python -m rabia_tpu_torch trace <host:port> [host:port ...] \\
        --client <uuid> --seq <n>          # cross-replica commit timeline
    python -m rabia_tpu_torch slowlog <host:port> [--replicas h:p ...]
                                           # critical-path decomposition
    python -m rabia_tpu_torch profile <host:port> [--seconds 2]
                                           # runtime stage breakdown
    python -m rabia_tpu_torch timeline <host:port> [host:port ...] \\
        [--last N] [--metric SUBSTR ...]   # per-second telemetry curves
    python -m rabia_tpu_torch fleet-top <host:port> \\
        [--samples N] [--interval S]       # ring-discovered fleet pane
    python -m rabia_tpu_torch ring <host:port>   # a routed fleet's hash ring
    python -m rabia_tpu_torch wal-dump <dir> [--records] [--last N]
"""

from __future__ import annotations

import argparse
import shutil
import sys
import time


def _report() -> int:
    import torch

    import rabia_tpu_torch

    print(f"rabia-tpu {rabia_tpu_torch.__version__} (rabia_tpu_torch)")
    cuda = torch.version.cuda or "none"
    if torch.cuda.is_available():
        card = f"{torch.cuda.get_device_name(0)} ({torch.cuda.device_count()} devices)"
    else:
        card = "none"
    print(f"torch {torch.__version__}; CUDA build: {cuda}; card: {card}")
    from rabia_tpu_torch.kernel import cuda_build

    try:
        nvcc = cuda_build.nvcc()
    except RuntimeError:
        nvcc = None
    print(f"nvcc: {nvcc or 'not found (the CUDA kernels cannot be built here)'}")
    print(f"g++: {shutil.which(cuda_build.CXX) or 'not found'}")
    from rabia_tpu_torch.native import build

    try:
        codec = build.load_codec()
    except Exception as e:  # a failed build raises with the compiler's output
        codec, why = None, type(e).__name__
    else:
        why = "disabled"
    print(f"native codec: {'ok' if codec else f'UNAVAILABLE ({why})'}")
    try:
        hk = build.load_hostkernel()
    except Exception as e:
        hk, why = None, type(e).__name__
    else:
        why = "disabled"
    print(f"native host kernel: {'ok' if hk else f'UNAVAILABLE ({why})'}")
    try:
        build.load_library()
        print("native TCP transport: ok")
    except Exception as e:  # no compiler / unsupported platform
        print(f"native TCP transport: UNAVAILABLE ({type(e).__name__})")
    return 0


def _selftest(device=None) -> int:
    import numpy as np
    import torch

    from rabia_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    from rabia_tpu_torch.kernel import ClusterKernel

    S, R = 64, 5
    k = ClusterKernel(S, R, seed=42, device=dev)
    votes = torch.full((8, S, R), 1, dtype=torch.int8, device=dev)
    decided, _ = k.slot_pipeline(votes, torch.ones((S, R), dtype=torch.bool, device=dev), 8)
    assert bool((decided == 1).all()), "kernel decide failed"
    print(f"kernel: 8x{S} slots decided V1 on {dev} "
          f"({time.perf_counter() - t0:.1f}s incl. build)")

    # kernel vs executable spec on a lossy schedule
    t0 = time.perf_counter()
    from rabia_tpu_torch.core.oracle import WeakMVCOracle
    from rabia_tpu_torch.kernel import device_coin

    st = k.start_slot(
        k.init_state(),
        torch.ones((S,), dtype=torch.bool, device=dev),
        torch.full((S, R), 1, dtype=torch.int8, device=dev),
    )
    alive = torch.from_numpy(
        np.broadcast_to(np.array([False, True, True, False, True]), (S, R)).copy()
    ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    st = k.run_rounds(st, alive, 80, gen, p_deliver=0.6)
    assert bool((st.decided != 3).all()), "minority crash + loss failed to decide"
    del device_coin, WeakMVCOracle  # imports prove the spec surface loads
    print(f"fault path: minority crash + 40% loss decided every shard "
          f"({time.perf_counter() - t0:.1f}s)")

    # the full SMR stack: MeshEngine commit + replica agreement
    t0 = time.perf_counter()
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
    from rabia_tpu_torch.parallel import MeshEngine

    eng = MeshEngine(InMemoryStateMachine, n_shards=8, n_replicas=3, window=2, device=dev)
    futs = [eng.submit([f"SET k{i} v{i}"], shard=i % 8) for i in range(16)]
    applied = eng.flush()
    assert applied == 16 and all(f.result() == [b"OK"] for f in futs)
    snap = eng.sms[0].create_snapshot().data
    assert all(sm.create_snapshot().data == snap for sm in eng.sms), (
        "replica divergence"
    )
    print(f"engine: 16 batches committed, 3 replicas agree "
          f"({time.perf_counter() - t0:.1f}s)")
    print("selftest OK")
    return 0


def _parse_addr(addr: str) -> tuple[str, int] | None:
    host, _, port_s = addr.rpartition(":")
    if not host or not port_s.isdigit():
        return None
    return host, int(port_s)


def _stats(
    addr: str,
    kind: str,
    timeout: float,
    journal_kind: str | None = None,
    last: int | None = None,
) -> int:
    """Fetch one admin document from a live gateway over its native
    transport (the framed AdminRequest path — no HTTP shim required)."""
    import asyncio
    import json

    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway import admin_fetch

    parsed = _parse_addr(addr)
    if parsed is None:
        print(f"stats: bad address {addr!r} (want host:port)", file=sys.stderr)
        return 2
    host, port = parsed
    kind_code = {
        "metrics": AdminKind.METRICS,
        "health": AdminKind.HEALTH,
        "journal": AdminKind.JOURNAL,
    }[kind]
    query = b""
    if kind == "journal" and (journal_kind is not None or last is not None):
        q: dict = {}
        if journal_kind is not None:
            q["kind"] = journal_kind
        if last is not None:
            q["last"] = last
        query = json.dumps(q).encode()
    try:
        body = asyncio.run(
            admin_fetch(
                host, port, int(kind_code), timeout=timeout, query=query
            )
        )
    except Exception as e:
        print(f"stats: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if kind == "metrics":
        sys.stdout.write(body.decode(errors="replace"))
    else:
        print(json.dumps(json.loads(body.decode()), indent=2))
    return 0


def _trace(addrs: list[str], client: str, seq: int, timeout: float) -> int:
    """Follow one batch through the whole cluster: fetch each replica's
    flight-ring TraceSlice (AdminKind.TRACE), align the per-replica
    monotonic clocks off the fetch RTTs, and print one merged commit
    timeline (submit → propose → per-peer R1/R2 votes → decide → apply →
    result). See docs/OBSERVABILITY.md, "Cross-replica commit traces"."""
    import asyncio
    import uuid

    from rabia_tpu_torch.obs.flight import collect_trace, render_timeline

    parsed = []
    for a in addrs:
        p = _parse_addr(a)
        if p is None:
            print(f"trace: bad address {a!r} (want host:port)",
                  file=sys.stderr)
            return 2
        parsed.append(p)
    try:
        cid = uuid.UUID(client)
    except ValueError:
        print(f"trace: bad client id {client!r} (want a UUID)",
              file=sys.stderr)
        return 2
    try:
        merged = asyncio.run(
            collect_trace(parsed, cid, seq, timeout=timeout)
        )
    except Exception as e:
        print(f"trace: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if not merged:
        print(
            f"trace: no flight events for client={cid} seq={seq} "
            "(command too old for the rings, or never submitted here?)",
            file=sys.stderr,
        )
        return 1
    print(render_timeline(merged))
    return 0


def _slowlog(
    addr: str,
    replicas: list[str],
    fleet: list[str],
    last,
    as_json: bool,
    timeout: float,
) -> int:
    """Fetch a gateway's slow-Submit exemplar reservoir
    (AdminKind.SLOWLOG), decompose each exemplar's cross-tier flight
    trace into named critical-path segments, and print the table plus
    the worst exemplar's waterfall. See docs/OBSERVABILITY.md,
    "Critical path"."""
    import asyncio
    import json

    from rabia_tpu_torch.obs.critpath import (
        collect_exemplar_trace,
        collect_slowlog,
        decompose,
        render_slowlog,
    )

    p0 = _parse_addr(addr)
    if p0 is None:
        print(f"slowlog: bad address {addr!r} (want host:port)",
              file=sys.stderr)
        return 2
    rep_addrs = []
    for a in replicas or [addr]:
        p = _parse_addr(a)
        if p is None:
            print(f"slowlog: bad replica address {a!r}", file=sys.stderr)
            return 2
        rep_addrs.append(p)
    fleet_addrs = []
    for a in fleet or []:
        p = _parse_addr(a)
        if p is None:
            print(f"slowlog: bad fleet address {a!r}", file=sys.stderr)
            return 2
        fleet_addrs.append(p)

    async def run():
        doc = await collect_slowlog(
            p0[0], p0[1], last=last, timeout=timeout
        )

        async def timeline_async(ex):
            return await collect_exemplar_trace(
                rep_addrs, ex, fleet_addrs=fleet_addrs, timeout=timeout
            )

        # decompose_exemplars takes a sync collector; each trace fetch
        # is itself sequential, so drive them one by one here
        decomps = []
        for ex in doc.get("exemplars", []):
            try:
                merged = await timeline_async(ex)
            except Exception as exc:  # noqa: BLE001 — keep the table
                decomps.append(
                    {
                        "ok": False,
                        "error": f"{type(exc).__name__}: {exc}",
                        "truncated": False,
                        "segments": {},
                        "total_s": 0.0,
                        "unattributed_s": 0.0,
                        "unattributed_frac": 0.0,
                        "exemplar": dict(ex),
                    }
                )
                continue
            d = decompose(
                merged,
                coalesced=ex.get("coalesced"),
                wall_s=ex.get("wall_s"),
            )
            d["exemplar"] = dict(ex)
            decomps.append(d)
        return doc, decomps

    try:
        doc, decomps = asyncio.run(run())
    except Exception as e:
        print(f"slowlog: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps({"slowlog": doc, "decompositions": decomps},
                         indent=2, default=str))
    else:
        print(render_slowlog(doc, decomps))
    return 0


def _profile(addr: str, seconds: float, timeout: float) -> int:
    """Two /metrics scrapes ``seconds`` apart -> the commit-path owner's
    per-stage time breakdown (rabia_runtime_stage_seconds deltas), with
    a coverage figure against the elapsed wall time between scrapes —
    "where did the wall move" as a scrape, not a guess. Works identically
    on the native runtime thread (RTS block) and the asyncio
    orchestration (loop accounting): same metric family either way."""
    import asyncio
    import time as _time

    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.gateway import admin_fetch
    from rabia_tpu_torch.obs.registry import RUNTIME_STAGES, parse_prometheus_text

    parsed = _parse_addr(addr)
    if parsed is None:
        print(f"profile: bad address {addr!r} (want host:port)",
              file=sys.stderr)
        return 2
    host, port = parsed

    def scrape() -> tuple[dict, float]:
        body = asyncio.run(
            admin_fetch(host, port, int(AdminKind.METRICS), timeout=timeout)
        )
        return parse_prometheus_text(body.decode(errors="replace")), \
            _time.monotonic()

    def stage_of(m: dict, stage: str) -> float:
        return m.get(
            f'rabia_runtime_stage_seconds{{stage="{stage}"}}', 0.0
        )

    try:
        m0, t0 = scrape()
        _time.sleep(max(0.2, seconds))
        m1, t1 = scrape()
    except Exception as e:
        print(f"profile: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if not any(
        k.startswith("rabia_runtime_stage_seconds") for k in m1
    ):
        print("profile: replica exports no rabia_runtime_stage_seconds "
              "(pre-SLO-plane build?)", file=sys.stderr)
        return 1
    elapsed = t1 - t0
    deltas = {s: stage_of(m1, s) - stage_of(m0, s) for s in RUNTIME_STAGES}
    total = sum(deltas.values())
    planes = 1.0 if m1.get("rabia_engine_native_runtime", 0.0) else 0.0
    print(
        f"runtime stage profile over {elapsed:.2f}s "
        f"(commit-path owner: "
        f"{'native runtime thread' if planes else 'asyncio loop'})"
    )
    print(f"{'stage':<16}{'time (s)':>12}{'share':>9}{'cumulative (s)':>17}")
    for s in sorted(RUNTIME_STAGES, key=lambda x: -deltas[x]):
        share = deltas[s] / elapsed * 100 if elapsed > 0 else 0.0
        print(f"{s:<16}{deltas[s]:>12.4f}{share:>8.1f}%"
              f"{stage_of(m1, s):>17.3f}")
    cov = total / elapsed * 100 if elapsed > 0 else 0.0
    print(f"{'-- sum':<16}{total:>12.4f}{cov:>8.1f}%  of wall between scrapes")

    # thread-per-shard-group runtime: per-worker breakdown next to the
    # aggregate (the worker-labeled series exist only with workers > 1)
    import re as _re

    workers = sorted(
        {
            m.group(1)
            for k in m1
            for m in [
                _re.match(
                    r'rabia_runtime_stage_seconds\{stage="[^"]+",'
                    r'worker="(\d+)"\}', k
                )
            ]
            if m
        },
        key=int,
    )
    if workers:
        def wstage(m: dict, g: str, stage: str) -> float:
            return m.get(
                f'rabia_runtime_stage_seconds{{stage="{stage}",'
                f'worker="{g}"}}', 0.0
            )

        print(f"\nper-worker breakdown ({len(workers)} shard groups):")
        hdr = f"{'stage':<16}" + "".join(
            f"{'w' + g + ' (s)':>12}" for g in workers
        )
        print(hdr)
        wtot = {g: 0.0 for g in workers}
        for s in RUNTIME_STAGES:
            row = f"{s:<16}"
            for g in workers:
                d = wstage(m1, g, s) - wstage(m0, g, s)
                wtot[g] += d
                row += f"{d:>12.4f}"
            print(row)
        row = f"{'-- sum':<16}"
        for g in workers:
            row += f"{wtot[g]:>12.4f}"
        print(row)
        row = f"{'-- coverage':<16}"
        for g in workers:
            c = wtot[g] / elapsed * 100 if elapsed > 0 else 0.0
            row += f"{c:>11.1f}%"
        print(row + "  of wall per worker")
    return 0


def _timeline(
    addrs: list[str],
    last: int | None,
    metrics: list[str] | None,
    as_json: bool,
    out: str | None,
    timeout: float,
) -> int:
    """Fetch every replica's per-second telemetry ring, clock-align them
    (RTT-midpoint offsets, the flight-recorder model) and print one
    merged multi-replica time series."""
    import asyncio
    import json

    from rabia_tpu_torch.obs.telemetry import (
        collect_timeline,
        render_timeline_table,
    )

    parsed = []
    for a in addrs:
        p = _parse_addr(a)
        if p is None:
            print(f"timeline: bad address {a!r} (want host:port)",
                  file=sys.stderr)
            return 2
        parsed.append(p)
    try:
        rows = asyncio.run(
            collect_timeline(parsed, last=last, timeout=timeout)
        )
    except Exception as e:
        print(f"timeline: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if out:
        with open(out, "w") as f:
            json.dump({"version": 1, "rows": rows}, f)
        print(f"timeline: {len(rows)} samples -> {out}", file=sys.stderr)
    if as_json:
        print(json.dumps(rows))
    else:
        print(render_timeline_table(rows, metrics=metrics or None))
    return 0


def _wal_dump(directory: str, records: bool, last) -> int:
    """Render a durability-plane directory (persistence/native_wal.py):
    segments with base LSNs and CRC status, the snapshot chain with its
    frontier, the latest vote barrier — and FLAG a torn tail (what a
    crash mid-group-commit looks like) instead of crashing on it."""
    from pathlib import Path

    from rabia_tpu_torch.persistence.native_wal import (
        K_BARRIER,
        K_FRONTIER,
        K_LEDGER,
        K_WAVE,
        KIND_NAMES,
        decode_record,
        read_snap_file,
        scan_wal,
    )

    d = Path(directory)
    if not d.is_dir():
        print(f"not a directory: {directory}", file=sys.stderr)
        return 2
    scan = scan_wal(d)
    print(f"wal directory: {d}")
    if not scan.segments:
        print("  (no segments)")
    for seg in scan.segments:
        torn_here = scan.torn is not None and scan.torn["segment"] == seg["index"]
        status = "TORN" if torn_here else "ok"
        print(
            f"  {Path(seg['path']).name}: base_lsn={seg.get('base_lsn', '?')} "
            f"records={seg['records']} bytes={seg['bytes']} crc={status}"
        )
    if scan.torn is not None:
        t = scan.torn
        print(
            f"  !! torn tail: segment {t['segment']} offset {t['offset']} "
            f"({t['reason']}) — recovery truncates here; records before "
            f"the tear are the durable prefix"
        )
    kinds: dict = {}
    frontier = None
    barrier = None
    for _lsn, _seg, _off, payload in scan.records:
        rec = decode_record(payload)
        kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
        if rec["kind"] == K_FRONTIER:
            frontier = rec
        elif rec["kind"] == K_BARRIER:
            barrier = rec
    summary = ", ".join(
        f"{KIND_NAMES.get(k, k)}={n}" for k, n in sorted(kinds.items())
    )
    print(f"  records: {len(scan.records)} (lsn 1..{scan.last_lsn}) {summary}")
    chain = [read_snap_file(p) for p in sorted(d.glob("snap-*.dat"))]
    for info, p in zip(chain, sorted(d.glob("snap-*.dat"))):
        if info is None:
            print(f"  {p.name}: CORRUPT (crc/header)")
            continue
        meta = info["meta"]
        print(
            f"  {p.name}: {'full' if info['is_full'] else 'delta'} "
            f"kind={'kv' if info['kind'] else 'blob'} "
            f"frontier_lsn={info['frontier_lsn']} "
            f"state_version={meta.get('state_version')} "
            f"applied={sum(meta.get('applied_upto', []))}"
        )
    if frontier is not None:
        print(
            f"  snapshot frontier: snap_index={frontier['snap_index']} "
            f"state_version={frontier['state_version']} "
            f"applied={sum(frontier['applied'])}"
        )
    if barrier is not None:
        bv = barrier["barrier"]
        print(
            f"  vote barrier: max={max(bv) if bv else 0} "
            f"nonzero_shards={sum(1 for x in bv if x)}"
        )
    if records:
        recs = scan.records
        if last is not None:
            recs = recs[-last:]
        for lsn, seg, off, payload in recs:
            rec = decode_record(payload)
            kind = KIND_NAMES.get(rec["kind"], str(rec["kind"]))
            detail = ""
            if rec["kind"] == K_WAVE:
                ops = rec["ops"]
                bid = rec["bid"]
                detail = (
                    f" shard={rec['shard']} slot={rec['slot']} "
                    f"value={rec['value']} ops={len(ops) if ops else 0}"
                    f" bid={'-' if not bid or not any(bid) else bid.hex()[:16]}"
                )
            elif rec["kind"] == K_LEDGER:
                detail = (
                    f" shard={rec['shard']} slot={rec['slot']} "
                    f"bid={rec['bid'].hex()[:16]}"
                )
            elif rec["kind"] == K_FRONTIER:
                detail = f" snap_index={rec['snap_index']}"
            print(f"  lsn={lsn} seg={seg} off={off} {kind}{detail}")
    return 0


def _ring(addr: str, timeout: float, as_json: bool) -> int:
    """Dump a routed fleet's control-plane view from any one member:
    the consistent-hash ring (version, members), the shard -> gateway
    ownership table, and each member's live session count + routing
    counters (HEALTH fetched per member — an unreachable member prints
    as such instead of failing the whole dump). docs/FLEET.md."""
    import asyncio
    import json

    from rabia_tpu_torch.core.messages import AdminKind
    from rabia_tpu_torch.fleet.ring import HashRing
    from rabia_tpu_torch.gateway import admin_fetch

    parsed = _parse_addr(addr)
    if parsed is None:
        print(f"ring: bad address {addr!r} (want host:port)", file=sys.stderr)
        return 2
    host, port = parsed

    async def fetch() -> dict:
        body = await admin_fetch(
            host, port, int(AdminKind.RING), timeout=timeout
        )
        doc = json.loads(body.decode())
        healths: dict = {}
        for m in (doc.get("ring") or {}).get("members", []):
            try:
                hb = await admin_fetch(
                    m["host"], m["port"], int(AdminKind.HEALTH),
                    timeout=timeout,
                )
                healths[m["name"]] = json.loads(hb.decode())
            except Exception as e:
                healths[m["name"]] = {"error": str(e)}
        doc["members_health"] = healths
        # shard-group liveness (fleet/groups.py): probe each group's
        # replica gateways so a dead group renders UNREACHABLE + stale
        # in the ownership table rather than silently absent
        if doc.get("groups"):
            self_health = healths.get(doc.get("self")) or {}
            group_alive: dict = {}
            for gid, addrs in enumerate(
                self_health.get("upstream_groups") or []
            ):
                alive = 0
                for gh, gp in addrs:
                    try:
                        await admin_fetch(
                            gh, gp, int(AdminKind.HEALTH),
                            timeout=min(timeout, 3.0),
                        )
                        alive += 1
                    except Exception:
                        pass
                group_alive[gid] = [alive, len(addrs)]
            doc["group_liveness"] = group_alive
        return doc

    try:
        doc = asyncio.run(fetch())
    except Exception as e:
        print(f"ring: fetch from {addr} failed: {e}", file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps(doc, indent=2))
        return 0
    if doc.get("ring") is None and "group" in doc:
        # a REPLICA gateway answered: its RING document is the group
        # card (group id + owned shard ranges), not a fleet ring
        ranges = ", ".join(
            f"[{lo},{hi})" for lo, hi in (doc.get("shards") or [])
        )
        print(
            f"replica gateway {doc.get('node')}: "
            f"group={doc.get('group')} "
            f"owned shard ranges: {ranges or '(all — ungrouped)'} "
            f"of {doc.get('n_shards')} shards"
        )
        return 0
    ring_doc = doc.get("ring") or {}
    n_shards = int(doc.get("n_shards") or 0)
    print(
        f"ring version {ring_doc.get('version')}: "
        f"{len(ring_doc.get('members', []))} members, {n_shards} shards "
        f"(answered by {doc.get('self')})"
    )
    healths = doc["members_health"]
    for m in ring_doc.get("members", []):
        h = healths.get(m["name"], {})
        if "error" in h:
            print(
                f"  {m['name']:<12} {m['host']}:{m['port']}  "
                f"UNREACHABLE ({h['error']})"
            )
            continue
        st = h.get("stats", {})
        print(
            f"  {m['name']:<12} {m['host']}:{m['port']}  "
            f"sessions={h.get('sessions')} "
            f"shards={len(h.get('owned_shards', []))} "
            f"moved={st.get('moved')} cached={st.get('cached_replays')} "
            f"ledger_in={st.get('ledger_applied')} "
            f"ledger_out={st.get('ledger_sent')}"
        )
    ring = HashRing.from_doc(ring_doc)
    by_owner: dict = {}
    for s in range(n_shards):
        owner = ring.owner(s)
        name = owner.name if owner is not None else "?"
        by_owner.setdefault(name, []).append(s)
    for name in sorted(by_owner):
        shards = ",".join(str(s) for s in by_owner[name])
        print(f"  shards[{name}]: {shards}")
    groups = doc.get("groups")
    if groups:
        live = doc.get("group_liveness") or {}
        print(
            f"  group map v{groups.get('version')} "
            "(shard-range -> consensus group):"
        )
        for lo, hi, gid in groups.get("ranges", []):
            a = live.get(gid, live.get(str(gid)))
            status = ""
            if a is not None:
                alive, total = a
                status = f"  replicas {alive}/{total}"
                if alive == 0:
                    status += "  UNREACHABLE (stale)"
            print(f"    shards [{lo},{hi}) -> group {gid}{status}")
    return 0


def _fleet_top(
    addr: str,
    samples: int,
    interval: float,
    as_json: bool,
    out: str | None,
    timeout: float,
) -> int:
    """Ring-discovered fleet pane: bootstrap the whole two-tier
    inventory from one fleet gateway (RING members + each member's
    ``upstreams``), scrape everything, and print the per-gateway derived
    series — coalesce density, slots/op, routing rates — plus the
    fleet-level shared-resource figures (fsyncs/Result, off-consensus
    read fraction). Derived rates are counter DELTAS, so at least two
    samples are taken. docs/OBSERVABILITY.md, "Fleet plane"."""
    import asyncio
    import json

    from rabia_tpu_torch.obs.fleet_obs import FleetAggregator, render_fleet_table

    parsed = _parse_addr(addr)
    if parsed is None:
        print(f"fleet-top: bad address {addr!r} (want host:port)",
              file=sys.stderr)
        return 2

    async def run() -> list[dict]:
        agg = FleetAggregator(parsed, timeout=timeout)
        await agg.refresh()
        docs = []
        for k in range(max(2, samples)):
            if k:
                await asyncio.sleep(max(0.1, interval))
            doc = await agg.sample()
            docs.append(doc)
            if not as_json:
                print(render_fleet_table(doc))
                print()
        return agg.series()

    try:
        series = asyncio.run(run())
    except Exception as e:
        print(f"fleet-top: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if out:
        with open(out, "w") as f:
            json.dump({"version": 1, "series": series}, f)
        print(f"fleet-top: {len(series)} samples -> {out}", file=sys.stderr)
    if as_json:
        print(json.dumps(series[-1]))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rabia_tpu_torch",
        description=(__doc__ or "").split("\n")[0],
    )
    ap.add_argument("--selftest", action="store_true",
                    help="build the kernels and run the mini end-to-end stack")
    ap.add_argument("--device", default=None,
                    help="the selftest's device (default: the card; 'cpu' runs "
                         "the plain versions)")
    sub = ap.add_subparsers(dest="cmd")
    sp = sub.add_parser(
        "stats",
        help="scrape a gateway's admin surface over the native transport",
    )
    sp.add_argument("addr", help="gateway host:port")
    sp.add_argument(
        "--kind", choices=("metrics", "health", "journal"),
        default="metrics",
    )
    sp.add_argument(
        "--journal-kind", default=None,
        help="journal only: filter entries by anomaly kind",
    )
    sp.add_argument(
        "--last", type=int, default=None,
        help="journal only: return the last N entries (default 64)",
    )
    sp.add_argument("--timeout", type=float, default=10.0)
    tp = sub.add_parser(
        "trace",
        help="reconstruct one command's cross-replica commit timeline "
        "from the flight recorders",
    )
    tp.add_argument(
        "addrs", nargs="+",
        help="gateway host:port (one per replica to include)",
    )
    tp.add_argument(
        "--client", required=True, help="client session id (UUID)"
    )
    tp.add_argument(
        "--seq", type=int, required=True, help="client command seq"
    )
    tp.add_argument("--timeout", type=float, default=10.0)
    sl = sub.add_parser(
        "slowlog",
        help="decompose a gateway's slowest Submit exemplars into "
        "critical-path segments (queue, park, per-phase consensus, "
        "fsync, fanout)",
    )
    sl.add_argument("addr", help="replica gateway host:port (slowlog source)")
    sl.add_argument(
        "--replicas", action="append", default=None,
        help="replica gateway host:port to trace against (repeatable; "
        "default: the slowlog addr only)",
    )
    sl.add_argument(
        "--fleet", action="append", default=None,
        help="fleet gateway host:port to include in traces (repeatable)",
    )
    sl.add_argument(
        "--last", type=int, default=None,
        help="only the N slowest exemplars",
    )
    sl.add_argument(
        "--json", action="store_true",
        help="print the reservoir + decompositions as JSON",
    )
    sl.add_argument("--timeout", type=float, default=10.0)
    pp = sub.add_parser(
        "profile",
        help="two-scrape runtime stage breakdown (where a commit-path "
        "second actually goes)",
    )
    pp.add_argument("addr", help="gateway host:port")
    pp.add_argument(
        "--seconds", type=float, default=2.0,
        help="window between the two /metrics scrapes",
    )
    pp.add_argument("--timeout", type=float, default=10.0)
    tl = sub.add_parser(
        "timeline",
        help="merge per-second telemetry rings from every replica into "
        "one clock-aligned time series",
    )
    tl.add_argument(
        "addrs", nargs="+",
        help="gateway host:port (one per replica to include)",
    )
    tl.add_argument(
        "--last", type=int, default=None,
        help="only the last N samples per replica",
    )
    tl.add_argument(
        "--metric", action="append", default=None,
        help="metric column (substring-matched against snapshot keys, "
        "matches summed; repeatable)",
    )
    tl.add_argument(
        "--json", action="store_true", help="print merged rows as JSON"
    )
    tl.add_argument(
        "--out", default=None, help="also write merged rows to this file"
    )
    tl.add_argument("--timeout", type=float, default=10.0)
    ft = sub.add_parser(
        "fleet-top",
        help="ring-discovered fleet pane: per-gateway coalesce density, "
        "slots/op and routing rates plus fleet-level shared-resource "
        "figures (docs/OBSERVABILITY.md)",
    )
    ft.add_argument("addr", help="any fleet gateway host:port (the seed)")
    ft.add_argument(
        "--samples", type=int, default=2,
        help="scrape rounds (min 2 — derived rates are counter deltas)",
    )
    ft.add_argument(
        "--interval", type=float, default=1.0,
        help="seconds between scrape rounds",
    )
    ft.add_argument(
        "--json", action="store_true",
        help="print the final derived sample as JSON instead of tables",
    )
    ft.add_argument(
        "--out", default=None,
        help="also write the whole derived series to this file",
    )
    ft.add_argument("--timeout", type=float, default=10.0)
    rg = sub.add_parser(
        "ring",
        help="dump a routed fleet's hash ring from any member: "
        "membership, shard ownership, per-gateway session counts "
        "(docs/FLEET.md)",
    )
    rg.add_argument("addr", help="any fleet gateway host:port")
    rg.add_argument(
        "--json", action="store_true",
        help="print the raw ring + per-member health as JSON",
    )
    rg.add_argument("--timeout", type=float, default=10.0)
    wd = sub.add_parser(
        "wal-dump",
        help="inspect a replica's durability-plane directory: segment "
        "headers, wave records, CRC status, snapshot frontier "
        "(docs/DURABILITY.md)",
    )
    wd.add_argument("dir", help="WAL directory (one replica's)")
    wd.add_argument(
        "--records", action="store_true",
        help="also print every record (default: per-segment summaries)",
    )
    wd.add_argument(
        "--last", type=int, default=None,
        help="with --records: only the last N records",
    )
    args = ap.parse_args(argv)
    if args.cmd == "wal-dump":
        return _wal_dump(args.dir, args.records, args.last)
    if args.cmd == "ring":
        return _ring(args.addr, args.timeout, args.json)
    if args.cmd == "fleet-top":
        return _fleet_top(
            args.addr, args.samples, args.interval, args.json, args.out,
            args.timeout,
        )
    if args.cmd == "stats":
        return _stats(
            args.addr, args.kind, args.timeout,
            journal_kind=args.journal_kind, last=args.last,
        )
    if args.cmd == "trace":
        return _trace(args.addrs, args.client, args.seq, args.timeout)
    if args.cmd == "slowlog":
        return _slowlog(
            args.addr, args.replicas, args.fleet, args.last, args.json,
            args.timeout,
        )
    if args.cmd == "profile":
        return _profile(args.addr, args.seconds, args.timeout)
    if args.cmd == "timeline":
        return _timeline(
            args.addrs, args.last, args.metric, args.json, args.out,
            args.timeout,
        )
    rc = _report()
    if rc == 0 and args.selftest:
        rc = _selftest(args.device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
