"""The port's engine on its device backend (``KernelConfig.backend =
"jax"``: ``NodeKernel``, one ``node_cycle`` and one fetch a tick), run on
``device="cpu"`` here, where the node kernel is its plain version.

- selection: the reference's warning (tests/test_engine.py,
  ``test_jax_backend_warns_on_selection``), the host kernel by default,
  the native tick and runtime declined and ``health()["planes"]`` saying
  so, and the phases-to-decide curve fed from the device bins;
- the block lane on the device backend (tests/test_blocks.py,
  ``test_jax_kernel_backend_commits``);
- the plane-conformance gate at BASELINE.json config 2's shape (64
  shards x 3 replicas, 8 waves of 4 SETs a shard), the transport cluster
  on the device backend with ``zero_copy_inbox`` off and on, against
  ``MeshEngine``: decisions, futures and replica state equal.

Tolerance: exact equality (the gate compares decisions, responses and
snapshots byte for byte).
"""

from __future__ import annotations

import asyncio
import logging

import pytest

from netwait import wait_until
from rabia_tpu_torch.core.config import RabiaConfig
from rabia_tpu_torch.core.network import ClusterConfig
from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
from rabia_tpu_torch.core.types import Command, CommandBatch, NodeId
from rabia_tpu_torch.engine import RabiaEngine
from rabia_tpu_torch.kernel.host_driver import HostNodeKernel
from rabia_tpu_torch.kernel.phase_driver import NodeKernel
from rabia_tpu_torch.net import InMemoryHub
from rabia_tpu_torch.testing.conformance import run_schedule_on_both_planes


def _engine(config, device=None):
    nodes = [NodeId.from_int(i + 1) for i in range(3)]
    return RabiaEngine(
        ClusterConfig.new(nodes[0], nodes), InMemoryStateMachine(),
        InMemoryHub().register(nodes[0]), config=config, device=device,
    )


def test_default_engine_is_host_kernel():
    eng = _engine(RabiaConfig())
    assert eng._host_kernel
    assert type(eng.kernel) is HostNodeKernel


def test_jax_backend_warns_on_selection(caplog):
    with caplog.at_level(logging.WARNING, logger="rabia_tpu_torch.engine"):
        _engine(RabiaConfig().with_kernel(num_shards=2, shard_pad_multiple=2, backend="jax"),
                device="cpu")
    assert any("directly-attached" in r.message for r in caplog.records)


def test_device_backend_declines_the_native_tick_and_runtime():
    eng = _engine(RabiaConfig().with_kernel(num_shards=4, shard_pad_multiple=4,
                                            backend="jax", device_substeps=2), device="cpu")
    assert not eng._host_kernel and isinstance(eng.kernel, NodeKernel)
    assert eng.kernel.device.type == "cpu" and eng._substeps == 2
    assert eng._rk is None and eng._rtm is None
    planes = eng.health()["planes"]
    assert planes["tick"] == "python" and planes["runtime"] == "python"
    # the mirrors are writable copies of the fetched state
    assert eng._cur_slot.flags.writeable and eng._cur_slot.dtype.name == "int64"
    assert eng._done.dtype == bool and eng._done.shape == (eng.S,)
    eng._dev_phase_hist[2] = 3
    eng._dev_phase_sum = 6
    text = eng.metrics.render_prometheus()
    assert "phases_to_decide" in text and "phases_to_decide_count 3" in text.replace(
        "rabia_", "")


@pytest.mark.asyncio
async def test_device_backend_block_lane_commits():
    """The device backend (device-array state + inbox planes) commits the
    same as the host kernel, on a sharded KV store."""
    from rabia_tpu_torch.apps import make_sharded_kv
    from rabia_tpu_torch.apps.kvstore import encode_set_bin

    S, R = 4, 3
    nodes = [NodeId.from_int(i + 1) for i in range(R)]
    hub = InMemoryHub()
    cfg = RabiaConfig(
        phase_timeout=0.5, heartbeat_interval=0.1, round_interval=0.001
    ).with_kernel(num_shards=S, shard_pad_multiple=S, backend="jax")
    engines, stores, tasks = [], [], []
    for n in nodes:
        sm, machines = make_sharded_kv(S, native=False)
        stores.append(machines)
        engines.append(RabiaEngine(ClusterConfig.new(n, nodes), sm, hub.register(n),
                                   config=cfg, device="cpu"))
        tasks.append(asyncio.ensure_future(engines[-1].run()))
    try:
        for _ in range(300):
            await asyncio.sleep(0.01)
            sts = [await e.get_statistics() for e in engines]
            if all(s.has_quorum for s in sts):
                break
        fut = await engines[0].submit_batch(
            CommandBatch.new([Command.new(encode_set_bin("jk", "jv"))], shard=1), shard=1,
        )
        responses = await asyncio.wait_for(fut, 30.0)
        assert len(responses) == 1

        def converged():
            vals = [ms[1].store.get("jk") for ms in stores]
            return all(v is not None and v.value == "jv" for v in vals)

        await wait_until(converged, budget=30.0, desc="replica catch-up")
        assert all(e.device_tick_stats["ticks"] > 0 for e in engines)
    finally:
        for e in engines:
            await e.shutdown()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


@pytest.mark.parametrize("zc", [False, True], ids=["copy", "zero_copy"])
@pytest.mark.asyncio
async def test_planes_gate_config2_on_device_backend(zc):
    S, R, waves = 64, 3, 8
    schedule = [{s: [f"SET k{s}_{j} v{w}_{j}" for j in range(4)] for s in range(S)}
                for w in range(waves)]
    out = await run_schedule_on_both_planes(
        schedule, S, R, tag=f"device backend S={S} R={R} zc={zc}", device="cpu",
        kernel={"backend": "jax", "zero_copy_inbox": zc}, engine_device="cpu",
    )
    assert out["decided_slots"] == S * waves
    assert out["device_ticks"]["ticks"] > 0
    assert out["device_ticks"]["h2d_bytes"] == 0  # nothing crosses to a card here


# -- the reference's device backend beside the port's ------------------------


async def _device_cluster(pkg: str, schedule, n_shards: int, n_replicas: int, zc: bool):
    """One transport cluster of ``pkg``'s engines on the device backend
    (``backend="jax"``, ``zero_copy_inbox=zc``; the port's on
    ``device="cpu"``) through ``schedule``, each wave from another
    replica; returns (decision logs, responses, replica snapshots)."""
    import importlib

    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    types = imp("core.types")
    # a long phase timeout: the reference's first ticks compile its programs
    config = imp("core.config").RabiaConfig(
        phase_timeout=10.0, heartbeat_interval=0.05, round_interval=0.002
    ).with_kernel(num_shards=n_shards, shard_pad_multiple=2, backend="jax", zero_copy_inbox=zc)
    hub = imp("net").InMemoryHub()
    nodes = [types.NodeId.from_int(i + 1) for i in range(n_replicas)]
    sms = [imp("core.state_machine").InMemoryStateMachine() for _ in nodes]
    kw = {"device": "cpu"} if pkg == "rabia_tpu_torch" else {}
    engines = [imp("engine").RabiaEngine(imp("core.network").ClusterConfig.new(n, nodes), sm,
                                         hub.register(n), config=config, **kw)
               for n, sm in zip(nodes, sms)]
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    try:
        for _ in range(600):
            await asyncio.sleep(0.01)
            if all([(await e.get_statistics()).has_quorum for e in engines]):
                break
        payload, responses = {}, []
        for w, wave in enumerate(schedule):
            futs = {}
            for s, cmds in wave.items():
                batch = types.CommandBatch.new(list(cmds))
                payload[batch.id] = tuple(cmds)
                futs[s] = await engines[w % n_replicas].submit_batch(batch, shard=s)
            responses.append({s: await asyncio.wait_for(f, 60.0) for s, f in futs.items()})
        # peers learn decisions and apply after the submitter settles: wait
        # until every replica's state and committed batches have caught up
        def caught_up() -> bool:
            snap = sms[0].create_snapshot().data
            return all(sm.create_snapshot().data == snap for sm in sms) and all(
                sum(int(rec.value) == 1 for rec in e.rt.shards[s].decisions.values())
                >= len([w for w in schedule if s in w]) for e in engines for s in range(n_shards))

        for _ in range(1500):
            if caught_up():
                break
            await asyncio.sleep(0.01)
        assert caught_up(), f"{pkg}: the replicas did not catch up"
        logs = [{s: {slot: (int(rec.value), payload.get(rec.batch_id))
                     for slot, rec in sorted(e.rt.shards[s].decisions.items())}
                 for s in range(n_shards)} for e in engines]
        return logs, responses, [sm.create_snapshot().data for sm in sms]
    finally:
        for e in engines:
            await e.shutdown()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


@pytest.mark.parametrize("zc", [False, True], ids=["copy", "zero_copy"])
def test_device_backend_matches_reference_plane_by_plane(zc):
    """The port's device backend on the CPU (``NodeKernel``'s plain
    versions, the planes copied or adopted by dlpack) beside the
    reference's on the same schedule, zero_copy_inbox off and on: every
    response, every replica's committed log (the batches decided V1,
    shard by shard, in slot order; a null slot that a timeout opens under
    load is the protocol's, not the plane's) and every snapshot equal."""
    S, R = 6, 3
    sched = [{s: [f"SET k{s}_{w} v{w}", f"GET k{s}_{w}"] for s in range(S) if (s + w) % 3}
             for w in range(4)]
    ref = asyncio.run(_device_cluster("rabia_tpu", sched, S, R, zc))
    port = asyncio.run(_device_cluster("rabia_tpu_torch", sched, S, R, zc))
    def committed(logs):
        return [{s: [p for _, (v, p) in sorted(d.items()) if v == 1] for s, d in log.items()}
                for log in logs]

    assert port[1] == ref[1]
    for r in range(R):
        assert committed(port[0])[r] == committed(ref[0])[r], f"replica {r}: logs differ"
    assert len(set(port[2])) == 1 and port[2] == ref[2]
    assert sum(len(c) for c in committed(port[0])[0].values()) == sum(len(w) for w in sched)
