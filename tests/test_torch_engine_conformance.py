"""Engine conformance gates of the port, exact.

1. The port's planes gate (``rabia_tpu_torch.testing.conformance``): one
   schedule through a cluster of the port's transport engines over the
   in-memory hub and through the port's ``MeshEngine`` on the CPU; per-shard
   decisions, futures and replica state must be identical.
2. One seeded schedule through a cluster of the reference's
   ``RabiaEngine`` and through a cluster of the port's, both on their
   Python tick (``RABIA_PY_TICK=1``) and both on their defaults (the
   native tick): per-shard decision logs (slot, value and batch
   payload), every future's responses and every replica's snapshot must
   be identical.

Both use the reference gate's timing (phase_timeout 3.0, heartbeat 0.05,
round interval 0.002) and wait on quorum, never on a fixed sleep.
"""

from __future__ import annotations

import asyncio
import importlib

import numpy as np
import pytest

from rabia_tpu_torch.testing.conformance import (
    run_schedule_on_both_planes,
    settle_quantiles,
)


def _schedule(seed: int, n_shards: int, waves: int, *, sets_only: bool):
    """Per wave {shard: [commands]}: a random subset of shards, one to
    four commands each over a small key set (GETs and DELs answer with
    the state, so futures carry more than OK)."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(waves):
        wave = {}
        for s in range(n_shards):
            if rng.random() < 0.25:
                continue
            cmds = []
            for _ in range(int(rng.integers(1, 5))):
                k = f"k{s}_{int(rng.integers(0, 3))}"
                op = 0 if sets_only else int(rng.integers(0, 4))
                if op in (0, 1):
                    cmds.append(f"SET {k} v{w}_{int(rng.integers(0, 100))}")
                elif op == 2:
                    cmds.append(f"GET {k}")
                else:
                    cmds.append(f"DEL {k}")
            wave[s] = cmds
        out.append(wave)
    return out


# -- 1. the port's planes gate ---------------------------------------------


@pytest.mark.parametrize("n_shards,n_replicas,seed", [(6, 3, 1), (4, 5, 2)])
@pytest.mark.asyncio
async def test_port_planes_gate(n_shards, n_replicas, seed):
    sched = _schedule(seed, n_shards, 4, sets_only=True)
    out = await run_schedule_on_both_planes(
        sched, n_shards, n_replicas, tag=f"planes S={n_shards} R={n_replicas}", device="cpu"
    )
    n_batches = sum(len(w) for w in sched)
    assert out["decided_slots"] == n_batches  # one slot per batch
    assert len(out["settle_s"]) == n_batches
    p50, p99 = settle_quantiles(out["settle_s"])
    assert 0 < p50 <= p99 < 15.0
    assert out["mesh_engine"].device.type == "cpu"


def test_settle_quantiles_nearest_rank():
    xs = [float(i) for i in range(1, 101)]
    assert settle_quantiles(xs) == [50.0, 99.0]
    assert settle_quantiles([]) == [None, None]


# -- 2. reference engine cluster vs the port's --------------------------------


async def _run_cluster(pkg: str, schedule, n_shards: int, n_replicas: int):
    """One transport cluster of ``pkg``'s engines through ``schedule``,
    submitting each wave from a different replica; returns (decision
    logs, futures' responses, every replica's snapshot, native tick on)."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    RabiaConfig = imp("core.config").RabiaConfig
    ClusterConfig = imp("core.network").ClusterConfig
    InMemoryStateMachine = imp("core.state_machine").InMemoryStateMachine
    types = imp("core.types")
    RabiaEngine = imp("engine").RabiaEngine
    InMemoryHub = imp("net").InMemoryHub

    config = RabiaConfig(
        phase_timeout=3.0, heartbeat_interval=0.05, round_interval=0.002
    ).with_kernel(num_shards=n_shards, shard_pad_multiple=2)
    hub = InMemoryHub()
    nodes = [types.NodeId.from_int(i + 1) for i in range(n_replicas)]
    sms = [InMemoryStateMachine() for _ in nodes]
    engines = [
        RabiaEngine(ClusterConfig.new(n, nodes), sm, hub.register(n), config=config)
        for n, sm in zip(nodes, sms)
    ]
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    try:
        for _ in range(300):
            await asyncio.sleep(0.01)
            if all([(await e.get_statistics()).has_quorum for e in engines]):
                break
        else:
            raise AssertionError(f"{pkg}: cluster never formed quorum")
        responses = []
        payload = {None: None}  # batch id -> its commands (ids differ per run)
        for w, wave in enumerate(schedule):
            eng = engines[w % n_replicas]
            futs = {}
            for s, c in wave.items():
                batch = types.CommandBatch.new(list(c))
                payload[batch.id] = tuple(c)
                futs[s] = await eng.submit_batch(batch, shard=s)
            responses.append({s: await asyncio.wait_for(f, 15.0) for s, f in futs.items()})
        # peers apply after the submitter settles: wait for convergence
        snap = sms[0].create_snapshot().data
        for _ in range(500):
            if all(sm.create_snapshot().data == snap for sm in sms):
                break
            await asyncio.sleep(0.01)
        logs = []
        for e in engines:
            logs.append({
                s: {
                    slot: (int(rec.value), payload[rec.batch_id])
                    for slot, rec in sorted(e.rt.shards[s].decisions.items())
                }
                for s in range(n_shards)
            })
        native = [e._rk is not None for e in engines]
        return logs, responses, [sm.create_snapshot().data for sm in sms], native
    finally:
        for e in engines:
            await e.shutdown()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


@pytest.mark.parametrize("ref_tick", ["python", "default"])
@pytest.mark.parametrize("n_shards,n_replicas,seed", [(8, 3, 11), (5, 5, 12)])
def test_reference_and_port_engines_agree(n_shards, n_replicas, seed, ref_tick, monkeypatch):
    sched = _schedule(seed, n_shards, 5, sets_only=False)
    if ref_tick == "python":
        monkeypatch.setenv("RABIA_PY_TICK", "1")
    else:
        monkeypatch.delenv("RABIA_PY_TICK", raising=False)
    ref = asyncio.run(_run_cluster("rabia_tpu", sched, n_shards, n_replicas))
    port = asyncio.run(_run_cluster("rabia_tpu_torch", sched, n_shards, n_replicas))
    ref_logs, ref_resp, ref_snaps, ref_native = ref
    port_logs, port_resp, port_snaps, port_native = port
    # RABIA_PY_TICK holds for both packages: both tick in Python, or both
    # run their native tick
    assert ref_native == port_native == [ref_tick == "default"] * n_replicas
    assert port_resp == ref_resp  # every future, in order
    for r in range(n_replicas):
        assert port_logs[r] == ref_logs[r], f"replica {r}: decision logs differ"
    assert port_logs[0] == port_logs[-1]
    assert len(set(port_snaps)) == 1 and port_snaps == ref_snaps
    assert sum(len(d) for d in port_logs[0].values()) == sum(len(w) for w in sched)


# -- 3. chip_smoke.py's phase 10 at a small size on the CPU ---------------------


def test_chip_smoke_phase10_on_cpu():
    """Phase 10's code with device="cpu": the planes gate at config 2's
    shape (64 shards x 3 replicas, 8 waves), save_to / load_from of the
    gate's MeshEngine with a further wave on both, and a transport
    replica restarted from its persistence layer."""
    import chip_smoke

    gate, eng = chip_smoke.planes_gate("cpu", chip_smoke.CFG2_S, chip_smoke.CFG2_R,
                                       chip_smoke.CFG2_WAVES)
    assert gate["decided_slots"] == chip_smoke.CFG2_S * chip_smoke.CFG2_WAVES
    assert gate["transport_decisions_per_s"] > 0
    assert 0 < gate["settle_p50_s"] <= gate["settle_p99_s"]
    ckpt = chip_smoke.mesh_persistence("cpu", eng, chip_smoke.CFG2_S, chip_smoke.CFG2_R)
    assert ckpt["state_bytes"] > 0
    restart = chip_smoke.transport_restart(8, 3)
    assert restart["tainted_shards"] == 8  # the restored vote barrier
