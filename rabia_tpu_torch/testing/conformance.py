"""Engine-level plane-conformance gate.

The port of the reference's ``run_schedule_on_both_planes``
(``rabia_tpu/testing/conformance.py``): one submission schedule driven
through BOTH deployment planes — a transport-engine cluster over the
in-memory hub, then a :class:`~rabia_tpu_torch.parallel.MeshEngine` —
must produce bit-identical per-shard decisions, successful client
futures, and byte-identical replica state. The port's ``MeshEngine``
takes a ``device`` (CUDA unless the caller passes another) in place of
the reference's ``mesh=``.

Beyond the reference, the gate returns what it timed on the transport
plane (wall time, submit-to-settle latencies, decided slots) and the
``MeshEngine`` it drove, so a caller can report the numbers and keep
using the engine.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional, Sequence


async def run_schedule_on_both_planes(
    schedule: Sequence[dict[int, list[str]]],
    n_shards: int,
    n_replicas: int = 3,
    *,
    tag: str = "",
    device=None,
) -> dict:
    """Raise AssertionError (prefixed with ``tag``) on any divergence.

    ``schedule``: per wave, {shard: [command strings]} — submitted in
    wave order on both planes. Fault-free only (faults are masked
    differently per plane; they have their own gates). ``device`` is the
    ``MeshEngine``'s. Returns ``transport_wall_s`` (first submit to last
    settle), ``wave_s`` (each wave's), ``settle_s`` (each future's
    submit-to-settle seconds), ``decided_slots`` (slots decided over all
    shards, on the submitting replica), ``snapshot`` (the replicas'
    agreed state) and ``mesh_engine``.
    """
    from rabia_tpu_torch.core.config import RabiaConfig
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
    from rabia_tpu_torch.core.types import CommandBatch, NodeId
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.net import InMemoryHub
    from rabia_tpu_torch.parallel import MeshEngine

    # -- transport plane ----------------------------------------------------
    # phase_timeout is a retransmit/lag timer only — the lossless hub never
    # needs it for fault-free progress, and a generous value keeps a loaded
    # host from tripping the mild-lag snapshot sync (which fails the
    # submitter future by design: engine._settle_from_ledger)
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
                    lambda _f, t0=t0: settle_s.append(time.perf_counter() - t0)
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
    kw = {} if device is None else {"device": device}
    mesh_eng = MeshEngine(
        InMemoryStateMachine, n_shards=n_shards, n_replicas=n_replicas,
        window=2, **kw,
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
    return {
        "transport_wall_s": transport_wall_s,
        "wave_s": wave_s,
        "settle_s": settle_s,
        "decided_slots": sum(len(d) for d in transport_decisions.values()),
        "snapshot": snap,
        "mesh_engine": mesh_eng,
    }


def settle_quantiles(settle_s: Sequence[float], qs=(0.5, 0.99)) -> list[Optional[float]]:
    """Nearest-rank quantiles of a list of latencies (None when empty)."""
    xs = sorted(settle_s)
    if not xs:
        return [None for _ in qs]
    return [xs[min(len(xs) - 1, max(0, int(round(q * len(xs))) - 1))] for q in qs]
