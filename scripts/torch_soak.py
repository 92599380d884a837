"""Chaos soak on the PyTorch/CUDA port: bulk-lane load under random
crash/heal cycles.

The counterpart of ``scripts/soak.py`` over ``rabia_tpu_torch``: the same
legs, chaos, gates, messages and exit codes. Runs a 5-replica in-memory
cluster at --shards shards for --seconds seconds while a chaos task
randomly disconnects/reconnects up to f replicas; the pump drives block
waves on live proposers and feeds dead-proposer shards through the
scalar give-up lane. Exits nonzero if replicas fail to reconverge after
the final heal. ``--plane mesh`` runs ``MeshEngine`` under crash/heal
cycles (``--device-store``: through the device KV lane's demotions and
re-promotions); ``--transport tcp`` kills and restarts replicas on fresh
ports over native TCP.

The device legs (``--plane mesh``, and ``--backend jax``: the engines'
node kernel) run on the card unless ``--device cpu`` is given; without a
card and without ``--device cpu`` they raise. The host legs read no
device.

Usage: python scripts/torch_soak.py [--seconds 60] [--shards 32] [--seed 42]
    [--backend host|jax] [--plane transport|mesh] [--transport mem|tcp]
    [--device-store] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _probe_values(stores, R: int, S: int):
    """Replica-by-replica values at three probe shards: (converged, vals).
    Convergence = every replica holds the same non-None probe values."""
    probe = (0, min(7, S - 1), min(19, S - 1))
    vals = []
    for r in range(R):
        row = []
        for s in probe:
            res = stores[r][s].store.get(f"s{s}")
            row.append(res.value if res else None)
        vals.append(tuple(row))
    return (len(set(vals)) == 1 and vals[0][0] is not None), vals


async def soak(seconds: float, shards: int, seed: int, backend: str = "host",
               device=None, report: dict | None = None) -> int:
    """The transport soak. ``device`` is where ``backend="jax"`` runs
    the engines' node kernel (the host backend ignores it); ``report``,
    when given, receives the run's counts."""
    import numpy as np

    from rabia_tpu_torch.apps import make_sharded_kv
    from rabia_tpu_torch.apps.kvstore import encode_set_bin
    from rabia_tpu_torch.core.blocks import build_block
    from rabia_tpu_torch.core.config import RabiaConfig
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.types import Command, CommandBatch, NodeId
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.engine.leader import slot_proposer_vec
    from rabia_tpu_torch.net import InMemoryHub

    S, R = shards, 5
    rng = random.Random(seed)
    nodes = [NodeId.from_int(i + 1) for i in range(R)]
    hub = InMemoryHub()
    cfg = RabiaConfig(
        phase_timeout=0.3, heartbeat_interval=0.1, round_interval=0.0005
    ).with_kernel(num_shards=S, shard_pad_multiple=S, backend=backend)
    engines, stores, tasks = [], [], []
    for n in nodes:
        sm, machines = make_sharded_kv(S)
        stores.append(machines)
        engines.append(
            RabiaEngine(ClusterConfig.new(n, nodes), sm, hub.register(n), config=cfg,
                        device=device)
        )
        tasks.append(asyncio.ensure_future(engines[-1].run()))
    for _ in range(300):
        await asyncio.sleep(0.01)
        sts = [await e.get_statistics() for e in engines]
        if all(s.has_quorum for s in sts):
            break
    else:
        print("FAIL: quorum never formed")
        return 1
    shard_ids = np.arange(S)
    down: set = set()
    stop_at = time.perf_counter() + seconds
    waves = 0

    async def chaos():
        while time.perf_counter() < stop_at:
            await asyncio.sleep(rng.uniform(2.0, 5.0))
            if down and rng.random() < 0.6:
                i = down.pop()
                hub.set_connected(nodes[i], True)
                print(f"[chaos] heal replica {i}")
            elif len(down) < (R - 1) // 2:
                cand = rng.choice([i for i in range(R) if i not in down])
                down.add(cand)
                hub.set_connected(nodes[cand], False)
                print(f"[chaos] crash replica {cand}")

    async def pump():
        nonlocal waves
        ctr = 0
        while time.perf_counter() < stop_at:
            futs = []
            for i, e in enumerate(engines):
                if i in down:
                    continue
                mine = e.proposer_eligible_shards()
                if len(mine):
                    try:
                        futs.append(
                            await e.submit_block(
                                build_block(
                                    mine,
                                    [
                                        [encode_set_bin(f"s{int(s)}", f"v{ctr}")]
                                        for s in mine
                                    ],
                                )
                            )
                        )
                    except Exception:
                        pass
            live = [e for i, e in enumerate(engines) if i not in down]
            if live and down:
                e = live[0]
                head = np.maximum(e.rt.next_slot[:S], e.rt.applied_upto[:S])
                prop = slot_proposer_vec(shard_ids, head, R)
                stuck = shard_ids[
                    np.isin(prop, list(down)) & (e.rt.queue_len[:S] < 1)
                ]
                for s in stuck[:64]:
                    try:
                        f = await e.submit_batch(
                            CommandBatch.new(
                                [Command.new(encode_set_bin(f"s{int(s)}", f"v{ctr}"))],
                                shard=int(s),
                            ),
                            shard=int(s),
                        )
                        # give-up-lane rejections are EXPECTED under chaos;
                        # retrieve the exception so asyncio doesn't log
                        # 'Future exception was never retrieved'
                        f.add_done_callback(
                            lambda fu: fu.exception() if not fu.cancelled() else None
                        )
                    except Exception:
                        pass
            if futs:
                try:
                    await asyncio.wait_for(
                        asyncio.gather(*futs, return_exceptions=True), 20.0
                    )
                    waves += 1
                except asyncio.TimeoutError:
                    pass
            ctr += 1
            await asyncio.sleep(0.02)

    ct = asyncio.ensure_future(chaos())
    await pump()
    ct.cancel()
    for i in list(down):
        hub.set_connected(nodes[i], True)
    # poll for convergence: a healed straggler catches up via repair/sync
    # within a second or two, but the exact moment races the heartbeat —
    # a fixed sleep flakes at the boundary
    committed = []
    for _ in range(30):
        await asyncio.sleep(1.0)
        sts = [await e.get_statistics() for e in engines]
        committed = [s.committed_slots for s in sts]
        if max(committed) - min(committed) == 0:
            break
    print(f"waves={waves}, committed per replica: {committed}")
    if report is not None:
        report.update(waves=waves, committed=committed)
    rc = 0
    if max(committed) - min(committed) > 2 * S:
        print("FAIL: replicas too far apart after heal")
        rc = 1
    else:
        ok = False
        for _ in range(600):
            await asyncio.sleep(0.01)
            ok, vals = _probe_values(stores, R, S)
            if ok:
                break
        if ok:
            print("soak OK: all replicas convergent")
        else:
            print(f"FAIL: divergent values {vals}")
            rc = 1
    for e in engines:
        try:
            await asyncio.wait_for(e.shutdown(), 5)
        except Exception:
            pass
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    return rc


def soak_mesh(
    seconds: float, shards: int, seed: int, device_store: bool = False,
    device=None, report: dict | None = None,
) -> int:
    """Device-plane chaos: MeshEngine under random crash/heal cycles.

    Crashes up to f replicas between flushes (sometimes past quorum — the
    engine must park, not corrupt), heals, and requires every submitted
    batch to commit and all replicas to agree at the end. With
    ``device_store`` the same chaos drives the device-resident KV lane:
    quorum-loss windows demote, clean periods re-promote, and GET-only
    block waves run the read lane — every lane transition under fire.
    The engine runs on ``device`` (CUDA unless given); ``report``, when
    given, receives the run's counts."""
    from rabia_tpu_torch.apps.kvstore import (
        KVOperation,
        encode_op_bin,
        encode_set_bin,
    )
    from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
    from rabia_tpu_torch.core.blocks import build_block
    from rabia_tpu_torch.core.errors import RabiaError
    from rabia_tpu_torch.parallel import MeshEngine

    S, R = shards, 5
    rng = random.Random(seed)
    enc_get = lambda k: encode_op_bin(KVOperation.get(k))
    eng = MeshEngine(
        lambda: VectorShardedKV(S, capacity=1 << 14),
        n_shards=S,
        n_replicas=R,
        window=4,
        device_store=device_store,
        device_store_repromote=3 if device_store else 64,
        device=device,
    )
    stop_at = time.perf_counter() + seconds
    futs = []
    get_futs = []
    ctr = 0
    down: set[int] = set()
    repromotions = 0
    was_active = device_store
    while time.perf_counter() < stop_at:
        # chaos step: crash/heal with occasional quorum loss
        roll = rng.random()
        if down and roll < 0.5:
            eng.heal_replica(down.pop())
        elif len(down) < R - 1 and roll > 0.7:
            cand = rng.choice([i for i in range(R) if i not in down])
            down.add(cand)
            eng.crash_replica(cand)
        if ctr % 2 == 0:
            # full-width block lane (the vectorized fast path + its
            # fault-demotion edge under the chaos above)
            futs.append(
                eng.submit_block(
                    build_block(
                        list(range(S)),
                        [[encode_set_bin(f"s{s}", f"v{ctr}")] for s in range(S)],
                    )
                )
            )
        elif device_store and ctr % 5 == 1:
            # GET-only full-width wave: the device read lane (or the
            # host path while demoted — responses must match either way)
            gf = eng.submit_block(
                build_block(
                    list(range(S)),
                    [[enc_get(f"s{s}")] for s in range(S)],
                )
            )
            futs.append(gf)
            if ctr > 2:  # every key has been SET by then (FIFO order)
                get_futs.append(gf)
        elif device_store and ctr % 7 in (3, 5):
            # DEL-bearing full-width waves on a separate key family
            # (the convergence probes read s-keys): SET d-keys at
            # %7==3, DEL them at %7==5 — deferred-version windows
            # (found AND not-found DELs, depending on where the
            # crash/demote cycle interleaved) pipeline under fire
            if ctr % 7 == 3:
                mk_op = lambda s: encode_set_bin(f"d{s}", f"w{ctr}")
            else:
                mk_op = lambda s: encode_op_bin(
                    KVOperation.delete(f"d{s}")
                )
            futs.append(
                eng.submit_block(
                    build_block(
                        list(range(S)),
                        [[mk_op(s)] for s in range(S)],
                    )
                )
            )
        else:
            for s in range(S):
                futs.append(
                    eng.submit([encode_set_bin(f"s{s}", f"v{ctr}")], s)
                )
        ctr += 1
        try:
            eng.flush(max_cycles=8)
        except RabiaError:
            pass  # quorum lost or slow convergence: heal next iteration
        if device_store:
            if eng._dev_active and not was_active:
                repromotions += 1
            was_active = eng._dev_active
    for i in list(down):
        eng.heal_replica(i)
    eng.flush()
    if report is not None:
        report.update(waves=ctr, repromotions=repromotions, commits=eng.decided_v1,
                      dispatches=eng.cycles)
    if not all(f.done() for f in futs):
        print("FAIL: undecided batches after final heal")
        return 1
    if device_store:
        # the host stores are stale while the lane is active: sync the
        # device table down so the convergence check below sees it
        eng._demote_device_store()
        # the read lane must have returned FOUND frames (kind 0), not
        # vacuously settled: decode the last GET wave's responses
        if get_futs:
            for g in get_futs[-1].result():
                frame = bytes(g[0])
                if frame[0] != 0:
                    print(f"FAIL: GET wave returned kind {frame[0]}")
                    return 1
        if repromotions == 0 and ctr > 20:
            print("FAIL: device lane never re-promoted under chaos")
            return 1
    for s in (0, S // 2, S - 1):
        vals = {sm.store.get(s, f"s{s}".encode()) for sm in eng.sms}
        if len(vals) != 1 or None in vals:
            print(f"FAIL: replicas diverge on shard {s}: {vals}")
            return 1
    if eng.divergences:
        print(f"FAIL: {eng.divergences} apply divergences")
        return 1
    lane = ""
    if device_store:
        lane = f", {repromotions} device-lane re-promotions under chaos"
    print(
        f"mesh soak OK: {eng.decided_v1} commits over {eng.cycles} "
        f"dispatches, {ctr} chaos waves, replicas convergent{lane}"
    )
    return 0


async def soak_tcp(seconds: float, shards: int, seed: int,
                   report: dict | None = None) -> int:
    """Chaos soak over REAL sockets with FULL replica restarts.

    The harshest path in the framework: a killed replica's engine task is
    cancelled and its native C++ transport closed outright; after a
    pause it comes back as a NEW engine + transport on a FRESH port,
    resumes from its persistence directory, and the survivors re-peer to
    the new address live (native add_peer/remove_peer — the reference's
    dynamic-topology arm, tcp_networking.rs:20-43, under repetition).
    Exits nonzero if the cluster fails to reconverge after the final
    restart."""
    import tempfile

    from rabia_tpu_torch.apps import make_sharded_kv
    from rabia_tpu_torch.apps.kvstore import encode_set_bin
    from rabia_tpu_torch.core.blocks import build_block
    from rabia_tpu_torch.core.config import RabiaConfig, TcpNetworkConfig
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.types import NodeId
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.net.tcp import TcpNetwork
    from rabia_tpu_torch.persistence import FileSystemPersistence

    S, R = shards, 3
    rng = random.Random(seed)
    ids = [NodeId.from_int(i + 1) for i in range(R)]
    # barrier_stride=1: restart taint covers only truly-opened slots, so
    # a restarted replica rejoins without waiting out wide taint windows
    cfg = RabiaConfig(
        phase_timeout=0.3,
        heartbeat_interval=0.1,
        round_interval=0.0005,
        barrier_stride=1,
    ).with_kernel(num_shards=S, shard_pad_multiple=S)
    tmp = tempfile.TemporaryDirectory()
    persist = [FileSystemPersistence(f"{tmp.name}/n{i}") for i in range(R)]
    stores: list = [None] * R
    nets: list = [None] * R
    engines: list = [None] * R
    tasks: list = [None] * R

    def spawn(i: int) -> None:
        sm, machines = make_sharded_kv(S)
        stores[i] = machines
        nets[i] = TcpNetwork(ids[i], TcpNetworkConfig(bind_port=0))
        for j in range(R):
            if j != i and nets[j] is not None:
                nets[i].add_peer(ids[j], "127.0.0.1", nets[j].port)
                # survivors re-peer to THIS node's fresh port
                try:
                    nets[j].remove_peer(ids[i])
                except Exception:
                    pass
                nets[j].add_peer(ids[i], "127.0.0.1", nets[i].port)
        engines[i] = RabiaEngine(
            ClusterConfig.new(ids[i], ids),
            sm,
            nets[i],
            persistence=persist[i],
            config=cfg,
        )
        tasks[i] = asyncio.ensure_future(engines[i].run())

    for i in range(R):
        spawn(i)
    for _ in range(500):
        await asyncio.sleep(0.01)
        sts = [await e.get_statistics() for e in engines]
        if all(s.has_quorum for s in sts):
            break
    else:
        print("FAIL: quorum never formed over TCP")
        return 1

    down: list = []  # at most one (f=1 of 3)
    stop_at = time.perf_counter() + seconds
    waves = 0
    restarts = 0

    async def chaos() -> None:
        nonlocal restarts
        while time.perf_counter() < stop_at:
            await asyncio.sleep(rng.uniform(2.5, 5.0))
            if down:
                i = down.pop()
                spawn(i)
                restarts += 1
                print(f"[chaos] restart replica {i} on port {nets[i].port}")
            else:
                i = rng.randrange(R)
                down.append(i)
                tasks[i].cancel()
                await asyncio.gather(tasks[i], return_exceptions=True)
                await nets[i].close()
                print(f"[chaos] kill replica {i} (task cancelled, socket closed)")

    async def pump() -> None:
        nonlocal waves
        ctr = 0
        while time.perf_counter() < stop_at:
            futs = []
            for i, e in enumerate(engines):
                if i in down:
                    continue
                try:
                    mine = e.proposer_eligible_shards()
                    if len(mine):
                        futs.append(
                            await e.submit_block(
                                build_block(
                                    mine,
                                    [
                                        [encode_set_bin(f"s{int(s)}", f"v{ctr}")]
                                        for s in mine
                                    ],
                                )
                            )
                        )
                except Exception:
                    pass  # racing a mid-kill engine is expected chaos
            if futs:
                # SHORT per-wave wait: a future submitted to an engine
                # chaos kills mid-wave can never resolve (the restart is
                # a NEW engine object) — blocking on it would freeze the
                # pump and silently gut the load the soak claims to apply
                done, _pending = await asyncio.wait(futs, timeout=1.5)
                if done:
                    for f in done:
                        f.exception()  # retrieve, chaos rejections expected
                    waves += 1
            ctr += 1
            await asyncio.sleep(0.03)

    ct = asyncio.ensure_future(chaos())
    await pump()
    ct.cancel()
    await asyncio.gather(ct, return_exceptions=True)
    if down:
        spawn(down.pop())
        restarts += 1
    # convergence: all replicas settle on equal committed counts + values
    committed = []
    for _ in range(45):
        await asyncio.sleep(1.0)
        sts = [await e.get_statistics() for e in engines]
        committed = [s.committed_slots for s in sts]
        if max(committed) - min(committed) == 0:
            break
    print(
        f"waves={waves}, restarts={restarts}, committed per replica: {committed}"
    )
    if report is not None:
        report.update(waves=waves, restarts=restarts, committed=committed)
    rc = 0
    ok = False
    for _ in range(600):
        await asyncio.sleep(0.01)
        ok, vals = _probe_values(stores, R, S)
        if ok:
            break
    if ok:
        print("tcp soak OK: replicas convergent across restarts")
    else:
        print(f"FAIL: divergent values {vals}")
        rc = 1
    for e in engines:
        try:
            await asyncio.wait_for(e.shutdown(), 5)
        except Exception:
            pass
    for t in tasks:
        if t is not None:
            t.cancel()
    await asyncio.gather(
        *[t for t in tasks if t is not None], return_exceptions=True
    )
    for n in nets:
        if n is not None:
            try:
                await n.close()
            except Exception:
                pass
    tmp.cleanup()
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--shards", type=int, default=32)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument(
        "--backend", choices=("host", "jax"), default="host",
        help="engine kernel implementation under chaos",
    )
    ap.add_argument(
        "--plane", choices=("transport", "mesh"), default="transport",
        help="transport cluster (RabiaEngine) or device plane (MeshEngine)",
    )
    ap.add_argument(
        "--transport", choices=("mem", "tcp"), default="mem",
        help="transport plane's wire: in-memory hub, or native TCP with "
        "full replica restarts (kill + fresh port + live re-peering)",
    )
    ap.add_argument(
        "--device-store", action="store_true",
        help="mesh plane only: chaos through the device-resident KV lane "
        "(SET + GET windows, demote/re-promote cycling under crashes)",
    )
    ap.add_argument(
        "--device", default=None,
        help="where the mesh plane and --backend jax run: CUDA unless "
        "given (e.g. 'cpu'); without a card and without this flag they raise",
    )
    args = ap.parse_args(argv)
    if args.plane == "mesh" and args.transport == "tcp":
        ap.error("--transport tcp applies to the transport plane only")
    if args.device_store and args.plane != "mesh":
        ap.error("--device-store applies to the mesh plane only")
    logging.disable(logging.WARNING)
    device = None
    if args.plane == "mesh" or (args.transport == "mem" and args.backend == "jax"):
        from rabia_tpu_torch.core.device import resolve_device

        device = resolve_device(args.device)  # raises without a card unless --device cpu
    if args.plane == "mesh":
        return soak_mesh(
            args.seconds, args.shards, args.seed,
            device_store=args.device_store, device=device,
        )
    if args.transport == "tcp":
        return asyncio.run(soak_tcp(args.seconds, args.shards, args.seed))
    return asyncio.run(
        soak(args.seconds, args.shards, args.seed, args.backend, device=device)
    )


if __name__ == "__main__":
    sys.exit(main())
