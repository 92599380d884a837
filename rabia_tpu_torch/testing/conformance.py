"""Conformance gates: each drives one schedule through two paths that
must agree.

- :func:`run_schedule_on_both_planes`: the transport cluster and the
  ``MeshEngine`` (below);
- :func:`run_schedule_on_both_tick_paths`: the native tick beside the
  Python tick;
- :func:`run_schedule_on_runtime_paths`: the GIL-free runtime beside the
  asyncio orchestration, over TCP;
- :func:`run_ops_on_both_apply_paths`: the native store beside the Python
  ``KVStore``;
- :func:`run_gateway_ops_on_both_tables`: the native session table beside
  the Python ``SessionTable``;
- :func:`run_waves_on_both_wal_paths`: the C WAL writer beside the Python
  writer (byte-identical segments, equal recovery);
- :func:`run_submits_on_coalesce_paths`: the gateway's coalescing lane on
  and off, over a durable cluster.

The native, gateway, WAL and coalescing gates are the port's copies of
the reference's (``rabia_tpu/testing/conformance.py``). The plane gate is the port of
the reference's ``run_schedule_on_both_planes``: one submission schedule driven
through BOTH deployment planes — a transport-engine cluster over the
in-memory hub, then a :class:`~rabia_tpu_torch.parallel.MeshEngine` —
must produce bit-identical per-shard decisions, successful client
futures, and byte-identical replica state. The ``MeshEngine`` runs over
``mesh=make_mesh(...)`` as the reference's does: a 1 x 1 mesh of
``device`` (CUDA unless the caller passes another).

Beyond the reference, the gate returns what it timed on the transport
plane (wall time, submit-to-settle latencies, decided slots) and the
``MeshEngine`` it drove, so a caller can report the numbers and keep
using the engine.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import re
import time
from typing import Callable, Optional, Sequence


async def run_schedule_on_both_planes(
    schedule: Sequence[dict[int, list[str]]],
    n_shards: int,
    n_replicas: int = 3,
    *,
    tag: str = "",
    device=None,
    kernel: Optional[dict] = None,
    engine_device=None,
    time_device_ticks: bool = False,
    around_transport: Optional[Callable] = None,
) -> dict:
    """Raise AssertionError (prefixed with ``tag``) on any divergence.

    ``schedule``: per wave, {shard: [command strings]} — submitted in
    wave order on both planes. Fault-free only (faults are masked
    differently per plane; they have their own gates). ``device`` is the
    ``MeshEngine``'s. ``kernel`` adds ``KernelConfig`` fields to the
    transport engines' configuration (``{"backend": "jax"}`` runs their
    node kernel on ``engine_device``, which they take as their
    ``device``; ``time_device_ticks`` times their ticks on a card by CUDA
    events). ``around_transport(engines)``, when given, returns a context
    manager that is held around the transport plane's waves (a profiler,
    say). Returns ``transport_wall_s`` (first submit to last
    settle), ``wave_s`` (each wave's), ``settle_s`` (each future's
    submit-to-settle seconds), ``decided_slots`` (slots decided over all
    shards, on the submitting replica), ``device_ticks`` (the transport
    engines' ``device_tick_stats``, summed), ``snapshot`` (the replicas'
    agreed state) and ``mesh_engine``.
    """
    from rabia_tpu_torch.core.config import RabiaConfig
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
    from rabia_tpu_torch.core.types import CommandBatch, NodeId
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.net import InMemoryHub
    from rabia_tpu_torch.core.device import resolve_device
    from rabia_tpu_torch.parallel import MeshEngine, make_mesh

    # -- transport plane ----------------------------------------------------
    # phase_timeout is a retransmit/lag timer only — the lossless hub never
    # needs it for fault-free progress, and a generous value keeps a loaded
    # host from tripping the mild-lag snapshot sync (which fails the
    # submitter future by design: engine._settle_from_ledger)
    config = RabiaConfig(
        phase_timeout=3.0,
        heartbeat_interval=0.05,
        round_interval=0.002,
    ).with_kernel(num_shards=n_shards, shard_pad_multiple=2, **(kernel or {}))
    hub = InMemoryHub()
    nodes = [NodeId.from_int(i + 1) for i in range(n_replicas)]
    engines, sms, tasks = [], [], []
    for node in nodes:
        sm = InMemoryStateMachine()
        eng = RabiaEngine(
            ClusterConfig.new(node, nodes), sm, hub.register(node),
            config=config, device=engine_device,
        )
        eng.device_tick_timing = time_device_ticks
        engines.append(eng)
        sms.append(sm)
        tasks.append(asyncio.ensure_future(eng.run()))
    settle_s: list[float] = []
    wave_s: list[float] = []
    try:
        quorum = False
        for _ in range(300):
            await asyncio.sleep(0.01)
            if all(
                [(await e.get_statistics()).has_quorum for e in engines]
            ):
                quorum = True
                break
        assert quorum, f"{tag}: transport cluster never formed quorum"
        around = (around_transport(engines) if around_transport is not None
                  else contextlib.nullcontext())
        with around:
            t_start = time.perf_counter()
            for w, wave in enumerate(schedule):
                t_wave = time.perf_counter()
                futs = {}
                for s, cmds in wave.items():
                    t0 = time.perf_counter()
                    f = await engines[0].submit_batch(
                        CommandBatch.new(list(cmds)), shard=s
                    )
                    f.add_done_callback(
                        lambda _f, t0=t0: settle_s.append(
                            time.perf_counter() - t0
                        )
                    )
                    futs[s] = f
                for s, f in futs.items():
                    got = await asyncio.wait_for(f, 15.0)
                    want = [b"OK"] * len(wave[s])
                    assert got == want, (
                        f"{tag}: transport wave {w} shard {s}: {got!r}"
                    )
                wave_s.append(time.perf_counter() - t_wave)
            transport_wall_s = time.perf_counter() - t_start
        transport_decisions = {
            s: {
                slot: int(rec.value)
                for slot, rec in engines[0].rt.shards[s].decisions.items()
            }
            for s in range(n_shards)
        }
        # peers apply asynchronously after the submitter settles — poll
        # for replica convergence before snapshotting
        snap = sms[0].create_snapshot().data
        for _ in range(500):
            if all(sm.create_snapshot().data == snap for sm in sms):
                break
            await asyncio.sleep(0.01)
        assert all(sm.create_snapshot().data == snap for sm in sms), (
            f"{tag}: transport replicas diverged"
        )
    finally:
        for e in engines:
            await e.shutdown()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    # -- device plane -------------------------------------------------------
    mesh_eng = MeshEngine(
        InMemoryStateMachine, n_shards=n_shards, n_replicas=n_replicas,
        mesh=make_mesh([resolve_device(device)]), window=2,
    )
    for w, wave in enumerate(schedule):
        futs = {s: mesh_eng.submit(list(cmds), s) for s, cmds in wave.items()}
        mesh_eng.flush()
        for s, f in futs.items():
            got = f.result()
            want = [b"OK"] * len(wave[s])
            assert got == want, f"{tag}: mesh wave {w} shard {s}: {got!r}"
    diverged = []
    for s in range(n_shards):
        mesh_d = {
            slot: v for slot, (v, _b) in mesh_eng.decisions_for(s).items()
        }
        if mesh_d != transport_decisions[s]:
            diverged.append((s, mesh_d, transport_decisions[s]))
    if diverged:
        s, mesh_d, tr_d = diverged[0]
        raise AssertionError(
            f"{tag}: {len(diverged)} shards' decisions diverge across planes; "
            f"the first, shard {s}: mesh={mesh_d}, transport={tr_d}"
        )
    assert all(
        sm.create_snapshot().data == snap for sm in mesh_eng.sms
    ), f"{tag}: replica state diverges across planes"
    device_ticks: dict = {}
    for e in engines:
        for k, v in e.device_tick_stats.items():
            device_ticks[k] = device_ticks.get(k, 0) + v
    return {
        "transport_wall_s": transport_wall_s,
        "wave_s": wave_s,
        "settle_s": settle_s,
        "decided_slots": sum(len(d) for d in transport_decisions.values()),
        "device_ticks": device_ticks,
        "snapshot": snap,
        "mesh_engine": mesh_eng,
    }


async def _run_transport_schedule(
    schedule: Sequence[dict[int, list[str]]],
    n_shards: int,
    n_replicas: int,
    *,
    tag: str,
):
    """One transport-plane cluster through `schedule`; returns
    (decisions{shard: {slot: value}}, state digest bytes, native_active,
    obs) where ``obs`` is {"parity": deterministic counter subset,
    "flight_lifecycle": per-shard propose/decide/apply flight sequences,
    "flight": the full merged flight capture, "context": cheap
    non-deterministic tick counters} — parity and flight_lifecycle are
    what the tick-path gate asserts on; everything lands in the
    divergence message/dumps (which the fuzz prints beside the repro
    seed)."""
    from rabia_tpu_torch.core.config import RabiaConfig
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
    from rabia_tpu_torch.core.types import CommandBatch, NodeId
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.net import InMemoryHub

    config = RabiaConfig(
        phase_timeout=3.0,
        heartbeat_interval=0.05,
        round_interval=0.002,
    ).with_kernel(num_shards=n_shards, shard_pad_multiple=2)
    hub = InMemoryHub()
    nodes = [NodeId.from_int(i + 1) for i in range(n_replicas)]
    engines, sms, tasks = [], [], []
    for node in nodes:
        sm = InMemoryStateMachine()
        eng = RabiaEngine(
            ClusterConfig.new(node, nodes), sm, hub.register(node),
            config=config,
        )
        engines.append(eng)
        sms.append(sm)
        tasks.append(asyncio.ensure_future(eng.run()))
    try:
        quorum = False
        for _ in range(300):
            await asyncio.sleep(0.01)
            if all(
                [(await e.get_statistics()).has_quorum for e in engines]
            ):
                quorum = True
                break
        assert quorum, f"{tag}: cluster never formed quorum"
        for w, wave in enumerate(schedule):
            futs = {
                s: await engines[w % n_replicas].submit_batch(
                    CommandBatch.new(list(cmds)), shard=s
                )
                for s, cmds in wave.items()
            }
            for s, f in futs.items():
                got = await asyncio.wait_for(f, 15.0)
                want = [b"OK"] * len(wave[s])
                assert got == want, f"{tag}: wave {w} shard {s}: {got!r}"
        decisions = {
            s: {
                slot: int(rec.value)
                for slot, rec in engines[0].rt.shards[s].decisions.items()
            }
            for s in range(n_shards)
        }
        snap = sms[0].create_snapshot().data
        for _ in range(500):
            if all(sm.create_snapshot().data == snap for sm in sms):
                break
            await asyncio.sleep(0.01)
        assert all(
            sm.create_snapshot().data == snap for sm in sms
        ), f"{tag}: replicas diverged"
        native = all(e._rk is not None for e in engines)
        # Counter context: BOTH tick paths feed the same metric names
        # (rk counter block on native, _py_* event tallies on Python) —
        # the deterministic subset below must agree across paths on a
        # fixed schedule; the rest (frame/tick counts ride retransmit
        # timing) is carried for triage only.
        e0 = engines[0]
        rk = e0._rk
        # Flight recorder capture (before shutdown frees the native
        # ring). The LIFECYCLE subset — per-shard (kind, slot, value)
        # sequences of propose/decide/apply — is deterministic on a
        # fixed fault-free schedule (it is the decision ledger's event
        # shadow) and is what the tick-path gate asserts; the full event
        # list rides along for the divergence dumps (timing-dependent
        # kinds like ingest/route/carry are excluded from parity exactly
        # like the frame counters are).
        flight = e0.flight_events()
        lifecycle: dict[int, list] = {}
        for ev in flight:
            if ev["kind"] in ("propose", "decide", "apply"):
                lifecycle.setdefault(int(ev["shard"]), []).append(
                    (ev["kind"], int(ev["slot"]), int(ev["arg"]))
                )
        obs = {
            "parity": {
                "decided_v1": int(e0.rt.decided_v1),
                "decided_v0": int(e0.rt.decided_v0),
                "state_version": int(e0.rt.state_version),
            },
            "flight_lifecycle": lifecycle,
            "flight": flight,
            "flight_native_records": (rk.flight_head() if rk else 0),
            "context": {
                "ticks": int(e0._tick_count),
                "stale": e0._py_stale
                + (rk.counter("stale_votes") if rk else 0),
                "frames": {
                    k: e0._py_frames[k]
                    + (rk.counter(f"frames_{k}") if rk else 0)
                    for k in ("vote1", "vote2", "decision")
                },
            },
        }
        return decisions, snap, native, obs
    finally:
        for e in engines:
            await e.shutdown()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def run_schedule_on_both_tick_paths(
    schedule: Sequence[dict[int, list[str]]],
    n_shards: int,
    n_replicas: int = 3,
    *,
    tag: str = "",
    require_native: bool = True,
) -> None:
    """Native-vs-Python tick-path conformance (the fast-path gate).

    The same submission schedule runs through two transport clusters —
    the native per-tick fast path (hostkernel.cpp rk_tick) and the Python
    semantics owner (``RABIA_PY_TICK=1``) — and must produce identical
    per-shard decision ledgers and byte-identical replica state
    (tests/test_torch_native_tick.py, test_torch_native_conformance.py).
    """
    import os

    prev = os.environ.pop("RABIA_PY_TICK", None)
    try:
        dec_native, snap_native, native, obs_native = (
            await _run_transport_schedule(
                schedule, n_shards, n_replicas, tag=f"{tag}[native]"
            )
        )
        if require_native:
            assert native, (
                f"{tag}: native tick path inactive (hostkernel build "
                "failure?) — conformance gate would be vacuous"
            )
        os.environ["RABIA_PY_TICK"] = "1"
        dec_py, snap_py, _, obs_py = await _run_transport_schedule(
            schedule, n_shards, n_replicas, tag=f"{tag}[python]"
        )
    finally:
        if prev is None:
            os.environ.pop("RABIA_PY_TICK", None)
        else:
            os.environ["RABIA_PY_TICK"] = prev
    ctx = (
        f"counters[native]={obs_native['parity']} "
        f"counters[python]={obs_py['parity']} "
        f"context[native]={obs_native['context']} "
        f"context[python]={obs_py['context']}"
    )
    try:
        assert dec_native == dec_py, (
            f"{tag}: decision ledgers diverge across tick paths "
            f"(native={dec_native}, python={dec_py}); {ctx}"
        )
        assert snap_native == snap_py, (
            f"{tag}: replica state diverges across tick paths; {ctx}"
        )
        # counter parity: the deterministic subset of the shared metric
        # namespace must agree across tick paths on an identical schedule
        assert obs_native["parity"] == obs_py["parity"], (
            f"{tag}: counter parity broken across tick paths; {ctx}"
        )
        assert obs_native["parity"]["decided_v1"] > 0, (
            f"{tag}: no decisions recorded — vacuous schedule"
        )
        # flight-recorder parity: both tick paths must emit the same
        # ordered per-shard sequence of lifecycle flight event kinds
        # (propose/decide/apply with slot + decided value; timestamps and
        # timing-dependent kinds — ingest/route/carry ride retransmit
        # timing — excluded, like the frame counters above)
        assert (
            obs_native["flight_lifecycle"] == obs_py["flight_lifecycle"]
        ), (
            f"{tag}: flight lifecycle sequences diverge across tick "
            f"paths (native={obs_native['flight_lifecycle']}, "
            f"python={obs_py['flight_lifecycle']}); {ctx}"
        )
        if require_native:
            # the native ring must actually have recorded the fast path
            # (a silently-empty recorder would make trace collection and
            # the auto-dumps vacuous on the path that matters most)
            assert obs_native["flight_native_records"] > 0, (
                f"{tag}: native flight ring empty after a native-tick run"
            )
    except AssertionError as e:
        paths = _dump_divergence_flight(tag, obs_native, obs_py)
        raise AssertionError(
            f"{e}; flight dumps: {paths}"
        ) from None


# a client response the gate leaves out: the submitting replica adopted
# the slot through a snapshot sync, so its future settles with
# ResponsesUnavailableError by design (peers that applied hold the bytes)
UNAVAILABLE = ("unavailable",)


def runtime_api():
    """The names the runtime gate drives. A cross-package test hands
    :func:`_run_runtime_schedule` another package's namespace of the same
    names, so each package's engine runs through this one runner."""
    from types import SimpleNamespace

    from rabia_tpu_torch.apps.kvstore import encode_set_bin
    from rabia_tpu_torch.apps.sharded import make_sharded_kv
    from rabia_tpu_torch.core.blocks import build_block
    from rabia_tpu_torch.core.config import RabiaConfig, TcpNetworkConfig
    from rabia_tpu_torch.core.errors import ResponsesUnavailableError
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.types import Command, CommandBatch, NodeId
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.engine.leader import slot_proposer
    from rabia_tpu_torch.net.tcp import TcpNetwork

    return SimpleNamespace(**{
        k: v for k, v in locals().items() if k != "SimpleNamespace"
    })


def _ledger_without_dedup_slots(engine, n_shards: int):
    """``engine``'s decided values by shard with every deduplicated slot
    left out, and the slots after it renumbered down, plus the (shard,
    slot) list of what was left out. A deduplicated slot is a V1 slot
    whose batch an earlier slot of the shard already committed: a
    retransmit racing a decide on a loaded host re-proposes a committed
    batch, the replicas decide it again and skip its apply (exactly-once
    holds; the slot only shifts the shard's numbering by one)."""
    ledger: dict[int, dict[int, int]] = {}
    dedup: list[tuple[int, int]] = []
    for s in range(n_shards):
        seen: set = set()
        out: dict[int, int] = {}
        skipped = 0
        for slot in sorted(engine.rt.shards[s].decisions):
            rec = engine.rt.shards[s].decisions[slot]
            value = int(rec.value)
            if value == 1 and rec.batch_id is not None:
                if rec.batch_id in seen:
                    dedup.append((s, slot))
                    skipped += 1
                    continue
                seen.add(rec.batch_id)
            out[slot - skipped] = value
        ledger[s] = out
    return ledger, dedup


async def _run_runtime_schedule(
    schedule: Sequence[dict[int, list[tuple[str, str]]]],
    n_shards: int,
    n_replicas: int,
    *,
    tag: str,
    block_every: int = 2,
    api=None,
):
    """One native-TCP cluster (sharded native-KV stores) through a
    schedule of SET waves: even waves ride the scalar lane, every
    ``block_every``-th the block lane (submit_block), so BOTH the
    runtime's scalar decide escalation and its native wave apply are
    exercised. ``api`` is :func:`runtime_api`'s namespace (the port's by
    default). Returns (decisions, checksums, responses, runtime_active,
    obs).

    Two effects of a loaded host are named and left out of what the
    legs compare, and ``obs["left_out"]`` lists them:

    - a client future that a snapshot sync overtook settles with
      ResponsesUnavailableError; its entry reads :data:`UNAVAILABLE`;
    - the ledger and the counter parity come from the first replica that
      initiated no snapshot sync (a sync adopts slots without their
      per-slot accounting and prunes the ledger below the adopted
      frontier), with its deduplicated slots left out
      (:func:`_ledger_without_dedup_slots`)."""
    import numpy as np

    if api is None:
        api = runtime_api()
    config = api.RabiaConfig(
        phase_timeout=3.0,
        heartbeat_interval=0.05,
        round_interval=0.002,
    ).with_kernel(num_shards=n_shards, shard_pad_multiple=2)
    ids = [api.NodeId.from_int(i + 1) for i in range(n_replicas)]
    nets = [api.TcpNetwork(i, api.TcpNetworkConfig(bind_port=0)) for i in ids]
    for i in range(n_replicas):
        for j in range(n_replicas):
            if i != j:
                nets[i].add_peer(ids[j], "127.0.0.1", nets[j].port)
    engines, machines, tasks = [], [], []
    for i, node in enumerate(ids):
        sm, ms = api.make_sharded_kv(n_shards)
        machines.append(ms)
        eng = api.RabiaEngine(
            api.ClusterConfig.new(node, ids), sm, nets[i], config=config
        )
        engines.append(eng)
        tasks.append(asyncio.ensure_future(eng.run()))

    def entry(r):
        if isinstance(r, api.ResponsesUnavailableError):
            return UNAVAILABLE
        if isinstance(r, Exception):
            return ("error", type(r).__name__)
        return [bytes(x) for x in r]

    try:
        quorum = False
        for _ in range(500):
            await asyncio.sleep(0.01)
            if all(
                [(await e.get_statistics()).has_quorum for e in engines]
            ):
                quorum = True
                break
        assert quorum, f"{tag}: TCP cluster never formed quorum"
        responses: list = []
        for w, wave in enumerate(schedule):
            shards = sorted(wave)
            if block_every and w % block_every == 1:
                # block lane: submit on the engine whose row is the
                # UPCOMING PROPOSER of the first covered shard, so its
                # entry is wave-eligible there (other shards' entries —
                # and near-misses when next_slot advances under us —
                # demote to the scalar lane, which is also a valid,
                # conformant path). A blind round-robin choice can
                # demote EVERY entry at some schedule geometries,
                # leaving the native apply lane unexercised and the
                # require_native guard red on a conformant run.
                s0 = shards[0]
                for cand in engines:
                    # an engine's eligibility is judged against ITS OWN
                    # next_slot view (submit_block checks synchronously
                    # at call entry), so match each candidate's view to
                    # its own row rather than engines[0]'s possibly-
                    # lagging frontier
                    if api.slot_proposer(
                        s0, int(cand.rt.next_slot[s0]), n_replicas
                    ) == cand.me:
                        e = cand
                        break
                else:
                    e = engines[w % n_replicas]
                cmds = [
                    [api.encode_set_bin(k, v) for k, v in wave[s]]
                    for s in shards
                ]
                fut = await e.submit_block(
                    api.build_block(np.asarray(shards, np.int64), cmds)
                )
                res = await asyncio.wait_for(fut, 20.0)
                responses.append([entry(r) for r in res])
            else:
                e = engines[w % n_replicas]
                futs = {}
                for s in shards:
                    batch = api.CommandBatch.new(
                        [
                            api.Command.new(api.encode_set_bin(k, v))
                            for k, v in wave[s]
                        ],
                        shard=s,
                    )
                    futs[s] = await e.submit_batch(batch, shard=s)
                got = []
                for s in shards:
                    try:
                        got.append(entry(await asyncio.wait_for(futs[s], 20.0)))
                    except api.ResponsesUnavailableError as err:
                        got.append(entry(err))
                responses.append(got)

        # replica convergence on state checksums
        def sums(ms):
            return [m.store.checksum() for m in ms]

        # re-read the first replica's sums on every pass: it may itself
        # still be applying the last wave (a value read once before the
        # loop goes stale and reads as a divergence). A replica that
        # decided a slot before its batch reached it recovers the batch
        # by snapshot sync, and a sync that went out too early is retried
        # only after the engine's retry window: the wait covers one.
        deadline = time.monotonic() + 3.0 + min(
            config.sync_timeout, 4 * config.phase_timeout
        )
        while True:
            want = sums(machines[0])
            if all(sums(ms) == want for ms in machines):
                break
            if time.monotonic() > deadline:
                break
            await asyncio.sleep(0.01)
        assert all(
            sums(ms) == want for ms in machines
        ), f"{tag}: replicas diverged"
        unsynced = [i for i, e in enumerate(engines) if e._syncs == 0]
        assert unsynced, f"{tag}: every replica initiated a snapshot sync"
        row = unsynced[0]
        e0 = engines[row]
        # decision records can trail the last client response (escalated
        # decisions and stale-vote repairs land asynchronously): settle
        # the ledger before snapshotting, or the two legs race their own
        # tails and the comparison flakes on a capture gap the counters
        # disprove
        prev = -1
        for _ in range(100):
            cur = sum(
                len(e0.rt.shards[s].decisions) for s in range(n_shards)
            )
            if cur == prev:
                break
            prev = cur
            await asyncio.sleep(0.02)
        decisions, dedup = _ledger_without_dedup_slots(e0, n_shards)
        runtime_active = all(e._rtm is not None for e in engines)
        lifecycle: dict[int, list] = {}
        for ev in e0.flight_events():
            if ev["kind"] in ("propose", "decide", "apply"):
                lifecycle.setdefault(int(ev["shard"]), []).append(
                    (ev["kind"], int(ev["slot"]), int(ev["arg"]))
                )
        obs = {
            "parity": {
                "decided_v1": int(e0.rt.decided_v1) - len(dedup),
                "decided_v0": int(e0.rt.decided_v0),
                "state_version": int(e0.rt.state_version),
            },
            "left_out": {
                "dedup_slots": dedup,
                "synced_replicas": [
                    i for i in range(n_replicas) if i not in unsynced
                ],
                "unavailable_responses": sum(
                    r == UNAVAILABLE for wave in responses for r in wave
                ),
                "ledger_replica": row,
            },
            "flight_lifecycle": lifecycle,
            "flight": e0.flight_events(),
            "runtime": (
                e0._rtm.counters_dict() if e0._rtm is not None else {}
            ),
            "context": {"ticks": int(e0._tick_count)},
        }
        return decisions, want, responses, runtime_active, obs
    finally:
        for e in engines:
            await e.shutdown()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for n in nets:
            await n.close()


def runtime_legs_agree(a, b, tag: str) -> None:
    """Assert that two :func:`_run_runtime_schedule` results agree:
    decided values on the slots both ledgers hold, client responses on
    the entries neither leg left out, replica state checksums and counter
    parity."""
    dec_a, sums_a, resp_a, _, obs_a = a
    dec_b, sums_b, resp_b, _, obs_b = b
    ctx = (
        f"counters={obs_a['parity']} / {obs_b['parity']} "
        f"left_out={obs_a['left_out']} / {obs_b['left_out']}"
    )
    overlap = 0
    for s in set(dec_a) | set(dec_b):
        both = set(dec_a.get(s, ())) & set(dec_b.get(s, ()))
        overlap += len(both)
        for slot in both:
            assert dec_a[s][slot] == dec_b[s][slot], (
                f"{tag}: decision value diverges at shard {s} slot "
                f"{slot} ({dec_a[s][slot]} / {dec_b[s][slot]}); {ctx}"
            )
    assert overlap > 0, (
        f"{tag}: decision ledgers share no slots ({dec_a} / {dec_b}) — "
        f"vacuous compare; {ctx}"
    )
    assert len(resp_a) == len(resp_b), f"{tag}: response waves; {ctx}"
    compared = 0
    for w, (wa, wb) in enumerate(zip(resp_a, resp_b)):
        assert len(wa) == len(wb), f"{tag}: wave {w} entries; {ctx}"
        for i, (ra, rb) in enumerate(zip(wa, wb)):
            if UNAVAILABLE in (ra, rb):
                continue
            compared += 1
            assert ra == rb, (
                f"{tag}: client response diverges at wave {w} entry {i} "
                f"({ra} / {rb}); {ctx}"
            )
    assert compared > 0, f"{tag}: every response left out; {ctx}"
    assert sums_a == sums_b, f"{tag}: replica state diverges; {ctx}"
    assert obs_a["parity"] == obs_b["parity"], (
        f"{tag}: counter parity broken; {ctx}"
    )
    assert obs_a["parity"]["decided_v1"] > 0, (
        f"{tag}: no decisions recorded — vacuous schedule"
    )


async def run_schedule_on_runtime_paths(
    schedule: Sequence[dict[int, list[tuple[str, str]]]],
    n_shards: int,
    n_replicas: int = 3,
    *,
    tag: str = "",
    require_native: bool = True,
    workers: Optional[int] = None,
) -> None:
    """Native-runtime vs asyncio-orchestration conformance (the engine
    runtime gate, extending the tick-path gate family).

    The same schedule of SET waves (scalar + block lanes) runs through
    two native-TCP clusters — the GIL-free runtime thread
    (native/runtime.cpp) and the asyncio semantics owner
    (``RABIA_PY_RUNTIME=1``) — and must produce identical per-shard
    decision ledgers, byte-identical client responses, identical replica
    state checksums and counter parity (:func:`runtime_legs_agree`, less
    what :func:`_run_runtime_schedule` names and leaves out). ``workers``
    pins the runtime leg's thread-per-shard-group worker count (via
    ``RABIA_RT_WORKERS``; None = inherit the environment), so the same
    gate pins workers=N vs asyncio, and a caller comparing two
    ``workers`` values transitively pins workers=N vs workers=1
    (tests/test_torch_runtime.py, test_torch_native_conformance.py).
    Divergence dumps both legs' flight captures to ``$RABIA_FLIGHT_DIR``.
    """
    prev = os.environ.pop("RABIA_PY_RUNTIME", None)
    prev_w = os.environ.get("RABIA_RT_WORKERS")
    try:
        if workers is not None:
            os.environ["RABIA_RT_WORKERS"] = str(workers)
        leg_rt = await _run_runtime_schedule(
            schedule, n_shards, n_replicas, tag=f"{tag}[runtime]"
        )
        if require_native:
            assert leg_rt[3], (
                f"{tag}: native runtime inactive (runtime.cpp build "
                "failure?) — conformance gate would be vacuous"
            )
        os.environ["RABIA_PY_RUNTIME"] = "1"
        leg_py = await _run_runtime_schedule(
            schedule, n_shards, n_replicas, tag=f"{tag}[asyncio]"
        )
    finally:
        if prev is None:
            os.environ.pop("RABIA_PY_RUNTIME", None)
        else:
            os.environ["RABIA_PY_RUNTIME"] = prev
        if workers is not None:
            if prev_w is None:
                os.environ.pop("RABIA_RT_WORKERS", None)
            else:
                os.environ["RABIA_RT_WORKERS"] = prev_w
    obs_rt, obs_py = leg_rt[4], leg_py[4]
    try:
        runtime_legs_agree(leg_rt, leg_py, tag)
        if require_native:
            rtm = obs_rt["runtime"]
            assert rtm.get("waves_native", 0) > 0, (
                f"{tag}: no native waves — block lane never hit the "
                f"runtime apply path; rtm={rtm}"
            )
    except AssertionError as e:
        paths = _dump_divergence_flight(
            tag,
            {**obs_rt, "context": obs_rt.get("context", {})},
            {**obs_py, "context": obs_py.get("context", {})},
        )
        raise AssertionError(f"{e}; flight dumps: {paths}") from None


def run_ops_on_both_apply_paths(
    schedule: Sequence[dict[int, list[bytes]]],
    n_shards: int,
    *,
    tag: str = "",
    require_native: bool = True,
) -> None:
    """Native-vs-Python APPLY-path conformance (the apply-plane gate).

    The same schedule of binary KV op waves drives two
    :class:`~rabia_tpu_torch.apps.sharded.ShardedStateMachine` instances — one
    on the statekernel-backed native stores, one on the Python
    :class:`KVStore` (the semantics owner, what ``RABIA_PY_APPLY=1``
    forces) — through the engine-visible apply surfaces: whole waves ride
    ``apply_block`` (the decided-wave path), with every third wave routed
    per shard through ``apply_batch`` (the scalar lane). Required:
    byte-identical per-op result frames on every wave, and — at the end —
    bit-identical per-shard state hashes, store versions and op-stats,
    plus a native-snapshot → Python-restore round trip landing on the
    same hash (tests/test_torch_native_apply.py,
    test_torch_native_conformance.py). On divergence, both paths' context dumps land in
    ``$RABIA_FLIGHT_DIR`` (default ``flight-dumps/`` — a CI failure
    artifact), like the tick-path gate's flight dumps.
    """
    import numpy as np

    from rabia_tpu_torch.apps.kvstore import KVStore
    from rabia_tpu_torch.apps.native_store import native_apply_available
    from rabia_tpu_torch.apps.sharded import make_sharded_kv
    from rabia_tpu_torch.core.blocks import build_block
    from rabia_tpu_torch.core.config import KVStoreConfig
    from rabia_tpu_torch.core.types import Command, CommandBatch, ShardId

    if not native_apply_available():
        assert not require_native, (
            f"{tag}: native apply plane unavailable (statekernel build "
            "failure?) — conformance gate would be vacuous"
        )
        return
    # small limits so fuzz schedules actually HIT the validation edges
    # (oversized value, key too long, store full — max_keys must sit
    # BELOW the fuzz generator's ~10-key pool or the store_full branch
    # is never differentially exercised)
    cfg = KVStoreConfig(
        max_keys=8, max_key_length=24, max_value_size=128
    )
    sm_nat, m_nat = make_sharded_kv(n_shards, cfg, native=True)
    sm_py, m_py = make_sharded_kv(n_shards, cfg, native=False)
    assert sm_nat._native_plane is not None, (
        f"{tag}: native plane not wired — gate would be vacuous"
    )

    def _ctx(wave_i: int) -> dict:
        return {
            "tag": tag,
            "wave": wave_i,
            "native_counters": sm_nat._native_plane.counters_dict(),
            "checksums_native": [m.store.checksum() for m in m_nat],
            "checksums_python": [m.store.checksum() for m in m_py],
        }

    for w, wave in enumerate(schedule):
        shards = sorted(wave)
        ops_per_shard = [list(wave[s]) for s in shards]
        try:
            if w % 3 == 2:
                # scalar lane: one CommandBatch per covered shard. A
                # batch the state machine REJECTS (e.g. an unknown
                # opcode routed through the typed path) must reject
                # identically on both paths — the engine turns that
                # into a deterministic per-replica apply failure.
                for s, ops in zip(shards, ops_per_shard):
                    batch = CommandBatch.new(
                        [Command.new(b) for b in ops], shard=ShardId(s)
                    )
                    outcomes = []
                    for sm in (sm_nat, sm_py):
                        try:
                            outcomes.append(list(sm.apply_batch(batch)))
                        except Exception as e:  # noqa: BLE001
                            outcomes.append(
                                (type(e).__name__, str(e))
                            )
                    r_nat, r_py = outcomes
                    assert r_nat == r_py, (
                        f"{tag}: wave {w} shard {s} scalar-lane outcomes "
                        f"diverge (native={r_nat!r}, python={r_py!r})"
                    )
            else:
                # block lane. A wave the SM rejects wholesale (e.g. a
                # "{"-prefixed undecodable command in the Python
                # fallback) must reject identically on both paths — the
                # engine turns that into a deterministic apply failure.
                block = build_block(np.asarray(shards), ops_per_shard)
                idxs = np.arange(len(shards))
                outcomes = []
                for sm in (sm_nat, sm_py):
                    try:
                        rs = sm.apply_block(block, idxs, want_responses=True)
                        outcomes.append([list(r) for r in rs])
                    except Exception as e:  # noqa: BLE001
                        outcomes.append((type(e).__name__, str(e)))
                r_nat, r_py = outcomes
                assert r_nat == r_py, (
                    f"{tag}: wave {w} block-lane outcomes diverge "
                    f"(native={r_nat!r}, python={r_py!r})"
                )
        except AssertionError:
            _dump_apply_divergence(tag, _ctx(w))
            raise
    try:
        for s in range(n_shards):
            st_n, st_p = m_nat[s].store, m_py[s].store
            assert st_n.checksum() == st_p.checksum(), (
                f"{tag}: shard {s} state hash diverges across apply paths"
            )
            assert st_n.version == st_p.version, (
                f"{tag}: shard {s} store version diverges "
                f"(native={st_n.version}, python={st_p.version})"
            )
            sn, sp = st_n.stats, st_p.stats
            assert (
                sn.total_operations, sn.reads, sn.writes
            ) == (sp.total_operations, sp.reads, sp.writes), (
                f"{tag}: shard {s} op stats diverge across apply paths"
            )
            # cross-path snapshot adoption (mixed-cluster sync): a Python
            # store restored from the NATIVE snapshot lands on the hash
            restored = KVStore(cfg)
            restored.restore_bytes(st_n.snapshot_bytes())
            assert restored.checksum() == st_p.checksum(), (
                f"{tag}: shard {s} native snapshot does not restore to "
                "the Python state"
            )
    except AssertionError:
        _dump_apply_divergence(tag, _ctx(len(schedule)))
        raise


def _dump_apply_divergence(tag: str, ctx: dict) -> None:
    """Write the apply-path divergence context next to the repro seed
    (``$RABIA_FLIGHT_DIR``, default ``flight-dumps/`` — uploaded as a CI
    failure artifact like the flight dumps)."""
    d = os.environ.get("RABIA_FLIGHT_DIR") or "flight-dumps"
    safe = re.sub(r"[^\w.=-]+", "_", tag) or "apply-divergence"
    try:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"apply_{safe}.json"), "w") as f:
            json.dump(ctx, f)
    except OSError:
        pass  # a read-only CWD must not mask the divergence


def _dump_divergence_flight(tag: str, obs_native: dict, obs_py: dict) -> list:
    """Write BOTH tick paths' flight-recorder captures next to the repro
    seed on divergence (beside the counter snapshots in the assertion
    message). Directory: $RABIA_FLIGHT_DIR, default ``flight-dumps/``
    (CI uploads it as a failure artifact)."""
    d = os.environ.get("RABIA_FLIGHT_DIR") or "flight-dumps"
    safe = re.sub(r"[^\w.=-]+", "_", tag) or "divergence"
    paths = []
    try:
        os.makedirs(d, exist_ok=True)
        for name, obs in (("native", obs_native), ("python", obs_py)):
            p = os.path.join(d, f"flight_{safe}_{name}.json")
            with open(p, "w") as f:
                json.dump(
                    {
                        "tag": tag,
                        "tick_path": name,
                        "parity": obs["parity"],
                        "context": obs["context"],
                        "flight_lifecycle": {
                            str(k): v
                            for k, v in obs["flight_lifecycle"].items()
                        },
                        "events": obs["flight"],
                    },
                    f,
                )
            paths.append(p)
    except OSError as e:  # a read-only CWD must not mask the divergence
        paths.append(f"<dump failed: {e}>")
    return paths


def settle_quantiles(settle_s: Sequence[float], qs=(0.5, 0.99)) -> list[Optional[float]]:
    """Nearest-rank quantiles of a list of latencies (None when empty)."""
    xs = sorted(settle_s)
    if not xs:
        return [None for _ in qs]
    return [xs[min(len(xs) - 1, max(0, int(round(q * len(xs))) - 1))] for q in qs]


def run_gateway_ops_on_both_tables(
    ops: Sequence[dict],
    *,
    default_window: int = 4,
    session_ttl: float = 30.0,
    lease_ttl: float = 120.0,
    result_cache_cap: int = 4,
    tag: str = "",
    require_native: bool = True,
) -> None:
    """Native-vs-Python GATEWAY session-table conformance (the gateway
    plane gate).

    The same op schedule drives the C session/dedup table
    (native/sessionkernel.cpp via
    :class:`~rabia_tpu_torch.gateway.native_session.NativeSessionTable`) and
    the Python :class:`~rabia_tpu_torch.gateway.session.SessionTable` (the
    semantics owner, what ``RABIA_PY_GATEWAY=1`` forces) through the
    op-level API the gateway server calls — hello / submit_check /
    complete_op / abort / gc. Required: identical return values for
    EVERY op (dedup decisions, byte-identical cached reply payloads,
    hello grants, gc eviction counts), and — at the end — identical
    surviving-session sets with identical per-session state (window,
    ack frontier, highest seq, inflight set, cached seqs, and every
    cached result byte-for-byte) plus SessionStats parity. Shared by
    the fixed gate (tests/test_gateway.py) and the randomized fuzz
    (``fuzz_conformance.py --gateway``), so the two checks cannot
    drift.

    Each op is a dict: ``{"op": "hello"|"submit"|"complete"|"abort"|
    "gc"|"ledger", "t": <time>, ...}`` with op-specific fields
    (``cid``, ``seq``, ``window``, ``ack``, ``status``, ``payload``,
    ``frontier``, ``sv``). The ``ledger`` op is the fleet tier's
    replicated completed-result record
    (:func:`rabia_tpu_torch.fleet.apply_record` — reserve-if-absent +
    complete in one step): a gateway-failover replay must find the
    byte-identical cached result on the successor's table whichever
    backend that table runs, so the record's landing decision is part
    of the conformance surface.
    """
    from rabia_tpu_torch.fleet.ledger import apply_record
    from rabia_tpu_torch.gateway.native_session import NativeSessionTable
    from rabia_tpu_torch.gateway.session import SessionTable
    from rabia_tpu_torch.native.build import load_sessionkernel

    lib = load_sessionkernel()
    if lib is None:
        if os.environ.get("RABIA_PY_GATEWAY") == "1":
            # env-forced Python table: the differential is vacuous BY
            # DESIGN here (the RABIA_PY_GATEWAY matrix cell exercises
            # the semantics owner; the main gate runs the differential)
            return
        assert not require_native, (
            f"{tag}: sessionkernel unavailable (build failure?) — "
            "gateway conformance gate would be vacuous"
        )
        return
    kw = dict(
        default_window=default_window,
        session_ttl=session_ttl,
        result_cache_cap=result_cache_cap,
        lease_ttl=lease_ttl,
    )
    nat = NativeSessionTable(lib, **kw)
    py = SessionTable(**kw)
    try:
        for i, op in enumerate(ops):
            kind, t = op["op"], op["t"]
            if kind == "hello":
                a = py.hello(op["cid"], op.get("window", 0), now=t)
                b = nat.hello(op["cid"], op.get("window", 0), now=t)
            elif kind == "submit":
                a = py.submit_check(
                    op["cid"], op["seq"], op.get("ack", 0), now=t
                )
                b = nat.submit_check(
                    op["cid"], op["seq"], op.get("ack", 0), now=t
                )
            elif kind == "complete":
                a = py.complete_op(
                    op["cid"], op["seq"], op["status"], op["payload"],
                    op["frontier"], now=t,
                )
                b = nat.complete_op(
                    op["cid"], op["seq"], op["status"], op["payload"],
                    op["frontier"], now=t,
                )
            elif kind == "abort":
                a = py.abort(op["cid"], op["seq"])
                b = nat.abort(op["cid"], op["seq"])
            elif kind == "gc":
                a = py.gc(op["sv"], now=t)
                b = nat.gc(op["sv"], now=t)
            elif kind == "ledger":
                a = apply_record(
                    py, op["cid"], op["seq"], op["status"],
                    op["payload"], op["frontier"], now=t,
                )
                b = apply_record(
                    nat, op["cid"], op["seq"], op["status"],
                    op["payload"], op["frontier"], now=t,
                )
            else:  # pragma: no cover - schedule generator bug
                raise ValueError(f"unknown gateway op {kind!r}")
            assert a == b, (
                f"{tag}: op {i} ({kind}) diverged: python={a!r} "
                f"native={b!r}"
            )
        # -- end state ------------------------------------------------------
        py_cids = set(py.sessions.keys())
        nat_cids = set(nat.session_ids())
        assert py_cids == nat_cids, (
            f"{tag}: surviving sessions diverge: python-only="
            f"{py_cids - nat_cids} native-only={nat_cids - py_cids}"
        )
        assert len(py) == len(nat)
        for cid in sorted(py_cids, key=lambda c: c.bytes):
            sess = py.sessions[cid]
            info = nat._info(cid)
            assert info is not None, f"{tag}: {cid} missing natively"
            window, ack, highest, n_inflight, n_results = info
            assert (sess.window, sess.ack_upto, sess.highest_completed) == (
                window, ack, highest,
            ), f"{tag}: session {cid} header diverged"
            assert sorted(sess.inflight) == sorted(
                nat.inflight_seqs(cid)
            ), f"{tag}: session {cid} inflight set diverged"
            assert sorted(sess.results) == nat.result_seqs(cid), (
                f"{tag}: session {cid} cached seqs diverged"
            )
            assert len(sess.results) == n_results
            for seq, rec in sess.results.items():
                got = nat.cached_result(cid, seq)
                assert got == rec, (
                    f"{tag}: cached result ({cid}, {seq}) diverged: "
                    f"python={rec!r} native={got!r}"
                )
        assert py.stats == nat.stats, (
            f"{tag}: SessionStats diverged: python={py.stats} "
            f"native={nat.stats}"
        )
    finally:
        nat.close()


def random_gateway_ops(seed: int, n_ops: int = 400) -> list[dict]:
    """Draw one random gateway-table op schedule (the fuzz generator):
    a small client pool, seqs from a narrow range (so dup/cached/
    inflight branches are hit constantly), random completes/aborts that
    need not match reservations (invalid transitions must diverge
    NOWHERE), time advancing with occasional jumps past the idle ttl
    and the hard lease, gc at random frontiers, and fleet ledger
    records (reserve+complete in one step) racing the client's own
    submits over the same narrow seq range."""
    import random
    import uuid as _uuid

    rng = random.Random(seed)
    cids = [
        _uuid.UUID(bytes=rng.getrandbits(128).to_bytes(16, "big"))
        for _ in range(rng.randint(2, 6))
    ]
    t = 1000.0
    sv = 0
    ops: list[dict] = []
    for _ in range(n_ops):
        t += rng.choice([0.0, 0.01, 0.5, 2.0])
        if rng.random() < 0.02:
            t += rng.choice([40.0, 150.0])  # past ttl / past lease
        r = rng.random()
        cid = rng.choice(cids)
        seq = rng.randint(1, 12)
        if r < 0.10:
            ops.append({
                "op": "hello", "t": t, "cid": cid,
                "window": rng.choice([0, 1, 2, 3, 99]),
            })
        elif r < 0.55:
            ops.append({
                "op": "submit", "t": t, "cid": cid, "seq": seq,
                "ack": rng.choice([0, 0, seq - 1, seq]),
            })
        elif r < 0.80:
            nparts = rng.randint(0, 3)
            payload = tuple(
                bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 40)))
                for _ in range(nparts)
            )
            sv += rng.randint(0, 3)
            ops.append({
                "op": "complete", "t": t, "cid": cid, "seq": seq,
                "status": rng.choice([0, 1, 2, 3]),
                "payload": payload, "frontier": sv,
            })
        elif r < 0.88:
            ops.append({"op": "abort", "t": t, "cid": cid, "seq": seq})
        elif r < 0.95:
            nparts = rng.randint(0, 2)
            payload = tuple(
                bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 24)))
                for _ in range(nparts)
            )
            sv += rng.randint(0, 2)
            ops.append({
                "op": "ledger", "t": t, "cid": cid, "seq": seq,
                "status": rng.choice([0, 1]),
                "payload": payload, "frontier": sv,
            })
        else:
            sv += rng.randint(0, 5)
            ops.append({"op": "gc", "t": t, "sv": sv})
    ops.append({"op": "gc", "t": t + 1.0, "sv": sv + 1})
    return ops


# ---------------------------------------------------------------------------
# durability-plane conformance (the WAL gate — docs/DURABILITY.md)
# ---------------------------------------------------------------------------


def random_wal_records(
    seed: int, n_records: int = 300, n_shards: int = 4
) -> list[bytes]:
    """A randomized record sequence for the WAL byte-parity gate:
    encoded payloads in the native_wal record format — decided waves
    (valid binary KV ops, occasional garbage ops, V0 gaps), barrier
    vectors, ledger backfills and frontier marks, with per-shard slots
    advancing in order (the staging invariant both apply paths hold)."""
    import random as _random

    from rabia_tpu_torch.persistence.native_wal import (
        encode_barrier,
        encode_frontier,
        encode_ledger,
        encode_wave,
    )

    rng = _random.Random(seed)
    slots = [0] * n_shards
    keys = [f"k{i}".encode() for i in range(10)]

    def one_op() -> bytes:
        r = rng.random()
        key = rng.choice(keys)
        if r < 0.70:
            val = bytes(
                rng.getrandbits(8) % 26 + 97
                for _ in range(rng.randint(0, 24))
            )
            return bytes([1]) + len(key).to_bytes(2, "little") + key + val
        if r < 0.85:
            return bytes([3]) + len(key).to_bytes(2, "little") + key
        if r < 0.95:
            return bytes([2]) + len(key).to_bytes(2, "little") + key
        # garbage op: must frame/replay identically on both writers
        return bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 12)))

    out: list[bytes] = []
    for _ in range(n_records):
        r = rng.random()
        s = rng.randrange(n_shards)
        if r < 0.78:
            slot = slots[s]
            slots[s] += 1
            if rng.random() < 0.15:
                out.append(encode_wave(s, slot, 0, None, None))
            else:
                bid = bytes(rng.getrandbits(8) for _ in range(16))
                ops = [one_op() for _ in range(rng.randint(1, 4))]
                out.append(
                    encode_wave(
                        s, slot, 1, bid if rng.random() < 0.7 else None, ops
                    )
                )
        elif r < 0.88:
            vec = bytes().join(
                int(slots[i] + rng.randint(0, 32)).to_bytes(
                    8, "little", signed=True
                )
                for i in range(n_shards)
            )
            out.append(encode_barrier(vec))
        elif r < 0.95:
            out.append(
                encode_ledger(
                    s, max(0, slots[s] - 1),
                    bytes(rng.getrandbits(8) for _ in range(16)),
                )
            )
        else:
            out.append(
                encode_frontier(
                    rng.randint(0, 5), sum(slots), list(slots)
                )
            )
    return out


def run_waves_on_both_wal_paths(
    records: Sequence[bytes],
    *,
    tag: str = "",
    segment_bytes: int = 2048,
    n_shards: int = 4,
    require_native: bool = True,
) -> None:
    """Durability-plane conformance: the SAME record sequence staged
    through the C walkernel writer AND the pure-Python twin (the byte
    format's semantics owner, what ``RABIA_PY_WAL=1`` forces) must
    produce BYTE-IDENTICAL segment files; the shared recovery scan must
    read back the exact sequence from both; a torn tail cut at an
    arbitrary byte offset must truncate both recoveries to the same
    whole-record prefix; and replaying the recovered wave records
    through the native statekernel stores and the Python ``KVStore``
    must land on identical state (checksums, versions, op stats) — the
    byte-identical-recovery acceptance pin. Shared by the fixed gate
    (tests/test_wal.py) and ``fuzz_conformance.py --wal``.

    Under ``RABIA_PY_WAL=1`` the native writer is unavailable by DESIGN
    and the gate returns without comparing anything (vacuous, like the
    gateway gate under its env); with ``require_native`` (the default)
    any OTHER build failure of walkernel raises instead of passing
    vacuously.
    """
    import random as _random
    import shutil
    import tempfile
    import uuid as _uuid
    from pathlib import Path

    from rabia_tpu_torch.apps.kvstore import KVStore
    from rabia_tpu_torch.apps.sharded import make_sharded_kv
    from rabia_tpu_torch.core.config import KVStoreConfig
    from rabia_tpu_torch.core.types import BatchId, Command, CommandBatch, ShardId
    from rabia_tpu_torch.native.build import load_walkernel
    from rabia_tpu_torch.persistence.native_wal import (
        K_WAVE,
        WalPersistence,
        decode_record,
        scan_wal,
        truncate_torn_tail,
    )

    if load_walkernel() is None:
        assert not require_native or os.environ.get("RABIA_PY_WAL") == "1", (
            f"{tag}: walkernel unavailable (build failure?) — the WAL "
            "conformance gate would be vacuous"
        )
        return  # vacuous by design under RABIA_PY_WAL=1 / opted-out

    root = Path(tempfile.mkdtemp(prefix="rabia-walgate-"))
    try:
        dirs = {"native": root / "c", "python": root / "py"}
        for which, d in dirs.items():
            d.mkdir()
            p = WalPersistence(
                d, segment_bytes=segment_bytes, n_shards=n_shards,
                force_python=(which == "python"),
            )
            assert p.native == (which == "native"), (
                f"{tag}: {which} writer backend not engaged"
            )
            for payload in records:
                p._writer.append(payload)
            p.flush_sync()
            p.close()

        files_c = sorted(x.name for x in dirs["native"].glob("wal-*.seg"))
        files_p = sorted(x.name for x in dirs["python"].glob("wal-*.seg"))
        assert files_c == files_p, (
            f"{tag}: segment file sets diverge "
            f"(native={files_c}, python={files_p})"
        )
        for name in files_c:
            bc = (dirs["native"] / name).read_bytes()
            bp = (dirs["python"] / name).read_bytes()
            assert bc == bp, (
                f"{tag}: segment {name} bytes diverge "
                f"(native {len(bc)}B vs python {len(bp)}B, first diff at "
                f"{next(i for i in range(min(len(bc), len(bp)) + 1) if i >= min(len(bc), len(bp)) or bc[i] != bp[i])})"
            )

        scan_c = scan_wal(dirs["native"])
        scan_p = scan_wal(dirs["python"])
        assert scan_c.torn is None and scan_p.torn is None, (
            f"{tag}: clean log scanned as torn "
            f"(native={scan_c.torn}, python={scan_p.torn})"
        )
        payloads = [r[3] for r in scan_c.records]
        assert payloads == list(records), (
            f"{tag}: native scan does not round-trip the staged records "
            f"({len(payloads)} of {len(records)})"
        )
        assert [r[3] for r in scan_p.records] == list(records), (
            f"{tag}: python scan does not round-trip the staged records"
        )

        # torn-tail differential: cut the log at a random byte offset in
        # its tail region; both recoveries must land on the SAME
        # whole-record prefix (and flag, not crash)
        rng = _random.Random(len(records))
        total = sum((dirs["native"] / n).stat().st_size for n in files_c)
        cut = rng.randint(1, min(200, max(2, total // 4)))
        torn_recs = {}
        for which, d in dirs.items():
            td = root / f"torn-{which}"
            shutil.copytree(d, td)
            segs = sorted(td.glob("wal-*.seg"))
            left = cut
            for seg in reversed(segs):
                size = seg.stat().st_size
                if size > left:
                    with open(seg, "rb+") as f:
                        f.truncate(size - left)
                    break
                seg.unlink()
                left -= size
            scan_t = scan_wal(td)
            truncate_torn_tail(td, scan_t)
            rescanned = scan_wal(td)
            assert rescanned.torn is None, (
                f"{tag}: {which} torn-tail truncation left a torn log "
                f"({rescanned.torn})"
            )
            torn_recs[which] = [r[3] for r in scan_t.records]
        assert torn_recs["native"] == torn_recs["python"], (
            f"{tag}: torn-tail recovery prefixes diverge "
            f"(native={len(torn_recs['native'])} records, "
            f"python={len(torn_recs['python'])})"
        )
        assert torn_recs["native"] == payloads[: len(torn_recs["native"])], (
            f"{tag}: torn-tail recovery is not a prefix of the full log"
        )

        # replay parity: recovered waves through the native statekernel
        # stores AND the Python KVStore — identical state by construction
        cfg = KVStoreConfig(max_keys=64, max_key_length=24, max_value_size=128)
        sm_nat, m_nat = make_sharded_kv(n_shards, cfg, native=True)
        sm_py, m_py = make_sharded_kv(n_shards, cfg, native=False)
        null_id = _uuid.UUID(int=0)
        applied = [0] * n_shards
        for payload in payloads:
            rec = decode_record(payload)
            if rec["kind"] != K_WAVE:
                continue
            s = rec["shard"]
            if s >= n_shards or rec["slot"] < applied[s]:
                continue
            if rec["value"] == 1 and rec["ops"] is not None:
                bid_b = rec["bid"] or bytes(16)
                batch = CommandBatch(
                    id=BatchId(_uuid.UUID(bytes=bytes(bid_b))),
                    commands=tuple(
                        Command(id=null_id, data=bytes(op))
                        for op in rec["ops"]
                    ),
                    shard=ShardId(s),
                )
                outcomes = []
                for sm in (sm_nat, sm_py):
                    try:
                        outcomes.append(list(sm.apply_batch(batch)))
                    except Exception as e:  # noqa: BLE001
                        outcomes.append((type(e).__name__, str(e)))
                assert outcomes[0] == outcomes[1], (
                    f"{tag}: replay responses diverge at shard {s} slot "
                    f"{rec['slot']} (native={outcomes[0]!r}, "
                    f"python={outcomes[1]!r})"
                )
            applied[s] = rec["slot"] + 1
        for s in range(n_shards):
            st_n, st_p = m_nat[s].store, m_py[s].store
            assert st_n.checksum() == st_p.checksum(), (
                f"{tag}: shard {s} replayed state hash diverges"
            )
            assert st_n.version == st_p.version, (
                f"{tag}: shard {s} replayed store version diverges"
            )
            sn, sp = st_n.stats, st_p.stats
            assert (
                sn.total_operations, sn.reads, sn.writes
            ) == (sp.total_operations, sp.reads, sp.writes), (
                f"{tag}: shard {s} replayed op stats diverge"
            )
        # restore path parity: Python KVStore restored from a fresh
        # KVStore(cfg) is covered by the apply gate; here pin that BOTH
        # recovered directories agree on the snapshot-frontier barrier
        pn = WalPersistence(
            dirs["native"], segment_bytes=segment_bytes, n_shards=n_shards
        )
        pp = WalPersistence(
            dirs["python"], segment_bytes=segment_bytes, n_shards=n_shards,
            force_python=True,
        )
        try:
            assert pn.recovered.barrier == pp.recovered.barrier, (
                f"{tag}: recovered vote barriers diverge"
            )
            assert pn.recovered.ledger == pp.recovered.ledger, (
                f"{tag}: recovered ledgers diverge"
            )
        finally:
            pn.close()
            pp.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Cross-session coalescing conformance (the round-15 gate)
# ---------------------------------------------------------------------------

def random_coalesce_schedule(
    seed: int,
) -> tuple[list[list[tuple[int, int, list[bytes]]]], int, int]:
    """Random multi-client submit schedule for the coalescing gate.

    Returns ``(rounds, n_clients, n_shards)`` — each round is a list of
    ``(client, shard, ops)`` submissions launched CONCURRENTLY (one per
    client at most, so per-client seqs stay sequential). Shard counts
    are kept tiny so concurrent rounds collide on shards and the
    coalescing windows actually pack. Every client writes only its own
    key namespace and CAS uses only expected_version=0, so concurrent
    submissions commute: outcomes are deterministic regardless of the
    interleaving either lane picks.
    """
    import numpy as np

    from rabia_tpu_torch.apps.kvstore import (
        KVOperation,
        encode_cas_bin,
        encode_op_bin,
        encode_set_bin,
    )

    rng = np.random.default_rng(seed + 1517)
    n_clients = int(rng.integers(4, 9))
    n_shards = int(rng.choice([1, 2]))
    n_rounds = int(rng.integers(3, 7))

    def one_op(ci: int) -> bytes:
        k = f"c{ci}-k{int(rng.integers(0, 4))}"
        r = float(rng.random())
        if r < 0.50:
            return encode_set_bin(k, "v%d" % int(rng.integers(0, 99)))
        if r < 0.62:
            return encode_op_bin(KVOperation.get(k))
        if r < 0.72:
            return encode_op_bin(KVOperation.delete(k))
        if r < 0.80:
            return encode_op_bin(KVOperation.exists(k))
        if r < 0.92:
            # create-if-absent CAS (expected_version=0): deterministic
            # under any cross-client interleaving
            return encode_cas_bin(k + "cas", "c", 0)
        # invalid utf-8 key: packs (first byte = SET) and produces a
        # deterministic per-op error result on both lanes. Unknown
        # OPCODES are deliberately absent: they bypass packing onto the
        # scalar-command lane, where an undecodable command fails the
        # whole batch — identically on both legs, but as a client-level
        # error this harness would mistake for a divergence.
        return b"\x01\x03\x00\xff\xfe\xfd"

    rounds = []
    for _ in range(n_rounds):
        who = rng.permutation(n_clients)[: int(rng.integers(2, n_clients + 1))]
        rounds.append(
            [
                (
                    int(ci),
                    int(rng.integers(0, n_shards)),
                    [one_op(int(ci)) for _ in range(int(rng.integers(1, 4)))],
                )
                for ci in who
            ]
        )
    return rounds, n_clients, n_shards


async def _run_coalesce_leg(
    rounds, n_clients: int, n_shards: int, coalesce: bool, tag: str
) -> dict:
    import uuid as _uuid

    from rabia_tpu_torch.core.messages import Submit
    from rabia_tpu_torch.gateway import GatewayConfig, RabiaClient
    from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

    cfg = GatewayConfig(
        coalesce=coalesce,
        # pinned windows (no adaptive shrink): concurrent round
        # submissions must land in one flush for the gate to be
        # non-vacuous
        coalesce_window=0.03,
        coalesce_window_min=0.03,
    )
    cluster = GatewayCluster(
        n_replicas=3, n_shards=n_shards, gateway_config=cfg
    )
    await cluster.start()
    clients = []
    out: dict = {"responses": {}, "cmds": {}}
    try:
        for i in range(n_clients):
            # every client on ONE gateway: the consistent-hash-routed
            # fleet shape (ROADMAP item 2) — and the only shape where
            # same-shard windows reliably pack for the gate
            c = RabiaClient(
                [cluster.endpoint(0)],
                call_timeout=30.0,
                client_id=_uuid.UUID(int=(0xC0A1E5CE << 32) | i),
            )
            await c.connect()
            clients.append(c)
        seqs = [0] * n_clients

        async def one(ci: int, shard: int, ops: list) -> None:
            seqs[ci] += 1
            seq = seqs[ci]
            r = await clients[ci].submit(shard, ops)
            out["responses"][(ci, seq)] = tuple(bytes(x) for x in r)
            out["cmds"][(ci, seq)] = (shard, tuple(ops))

        for rnd in rounds:
            await asyncio.gather(
                *(one(ci, s, ops) for ci, s, ops in rnd)
            )
        await cluster.wait_converged()
        # replay EVERY (client, seq) raw: exactly-once requires a
        # byte-identical answer (dedup cache or ledger) and ZERO state
        # mutation — mutation counts are the race-free double-apply
        # detector (decided-slot counts can grow from benign duplicate-
        # forwarding races that dedup at apply)
        muts_before = [
            [m.store.version for m in ms] for ms in cluster.machines
        ]
        for (ci, seq), (shard, ops) in out["cmds"].items():
            res = await clients[ci]._call(
                seq,
                Submit(
                    client_id=clients[ci].client_id, seq=seq,
                    shard=shard, commands=ops,
                ),
            )
            replay = tuple(bytes(x) for x in res.payload)
            assert replay == out["responses"][(ci, seq)], (
                f"{tag}: replay of client {ci} seq {seq} returned "
                f"different bytes (coalesce={coalesce})"
            )
        await asyncio.sleep(0.2)
        assert [
            [m.store.version for m in ms] for ms in cluster.machines
        ] == muts_before, (
            f"{tag}: replays mutated state — double apply "
            f"(coalesce={coalesce})"
        )
        out["checksums"] = [
            [m.store.checksum() for m in ms] for ms in cluster.machines
        ]
        out["versions"] = [
            m.store.version for m in cluster.machines[0]
        ]
        # version-INSENSITIVE key/value state: entry version stamps are
        # interleaving-dependent, so enumerate the schedule's key
        # namespace through the store API instead of hashing entries
        keys = [
            f"c{ci}-k{j}{suffix}"
            for ci in range(n_clients)
            for j in range(4)
            for suffix in ("", "cas")
        ]
        state = []
        for s in range(n_shards):
            store = cluster.machines[0][s].store
            vals = {}
            for k in keys:
                res = store.get(k)
                if getattr(res, "value", None) is not None:
                    vals[k] = res.value
            state.append(sorted(vals.items()))
        out["state"] = state
        gw_stats = [g.stats for g in cluster.gateways]
        out["coalesced"] = sum(s.submits_coalesced for s in gw_stats)
        out["waves"] = sum(s.coalesce_waves for s in gw_stats)
    finally:
        for c in clients:
            await c.close()
        await cluster.stop()
    return out


async def run_submits_on_coalesce_paths(
    rounds, n_clients: int, n_shards: int, *, tag: str = ""
) -> None:
    """Coalescing-lane conformance: the SAME multi-client submit
    schedule through a coalesce-ON cluster and a coalesce-OFF cluster
    (the per-submit round-10 lane) must produce:

    - semantically identical per-client responses (result kind + value;
      version stamps are interleaving-dependent in BOTH lanes and are
      excluded — see KVStore._version),
    - identical final key/value state and per-shard store MUTATION
      COUNTS across paths and replicas (a double apply anywhere bumps a
      count),
    - and, within each leg, byte-identical answers to a full replay of
      every (client, seq) with zero new proposals (exactly-once).

    The ON leg must actually coalesce (non-vacuousness) — the schedule
    generator keeps shard counts tiny so windows pack.
    """
    from rabia_tpu_torch.apps.kvstore import decode_result_bin

    on = await _run_coalesce_leg(
        rounds, n_clients, n_shards, True, f"{tag}[coalesce]"
    )
    off = await _run_coalesce_leg(
        rounds, n_clients, n_shards, False, f"{tag}[per-submit]"
    )
    assert on["waves"] >= 1 and on["coalesced"] >= 2, (
        f"{tag}: coalesce leg never packed a multi-client wave "
        f"(coalesced={on['coalesced']}) — gate vacuous"
    )
    assert off["coalesced"] == 0, (
        f"{tag}: per-submit leg coalesced — legs misconfigured"
    )
    assert set(on["responses"]) == set(off["responses"]), (
        f"{tag}: completed submit sets diverge"
    )
    for key in on["responses"]:
        a, b = on["responses"][key], off["responses"][key]
        assert len(a) == len(b), (
            f"{tag}: response arity diverges for {key}"
        )
        for ra, rb in zip(a, b):
            da, db = decode_result_bin(ra), decode_result_bin(rb)
            ka = (da.kind, da.value, da.error)
            kb = (db.kind, db.value, db.error)
            assert ka == kb, (
                f"{tag}: response diverges for {key}: {ka} != {kb}"
            )
    assert on["state"] == off["state"], (
        f"{tag}: final key/value state diverges across lanes"
    )
    assert on["versions"] == off["versions"], (
        f"{tag}: per-shard mutation counts diverge across lanes "
        f"(double apply): {on['versions']} != {off['versions']}"
    )
    for leg in (on, off):
        sums = leg["checksums"]
        assert all(s == sums[0] for s in sums[1:]), (
            f"{tag}: replicas diverge within a leg"
        )
