"""The PyTorch port stands alone: it imports neither jax nor rabia_tpu,
and its entry points never fall back to the CPU on their own."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "rabia_tpu_torch"
FORBIDDEN = {"jax", "rabia_tpu"}


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rabia_tpu'] = None\n"
        "import importlib, pkgutil\n"
        "import rabia_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    rabia_tpu_torch.__path__, 'rabia_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 55  # every submodule was walked


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_no_import_of_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            # "rabia_tpu_torch" is the port itself; only the exact top-level
            # names jax / rabia_tpu are forbidden
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_oracle_and_round_kernels_run_with_jax_and_reference_blocked():
    """The port's copy of the oracle, and the two kernel modules of the
    decision core's scanned protocol and packed window, import and run
    (plain versions, on the CPU) with jax and rabia_tpu unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rabia_tpu'] = None\n"
        "import torch\n"
        "from rabia_tpu_torch.core.oracle import WeakMVCOracle, seeded_coin\n"
        "from rabia_tpu_torch.kernel import cluster_round, packed_window\n"
        "from rabia_tpu_torch import ClusterKernel\n"
        "o = WeakMVCOracle(5, [1, 1, 0, 1, 1], seeded_coin(3))\n"
        "assert o.run() == 1\n"
        "k = ClusterKernel(4, 5, device='cpu')\n"
        "d, _ = k.slot_pipeline(torch.ones((2, 4, 5), dtype=torch.int8),\n"
        "                       torch.ones((4, 5), dtype=torch.bool), 2)\n"
        "v = packed_window.pack_codes(torch.ones((5, 2, 4), dtype=torch.int8))\n"
        "a = packed_window.pack_alive(torch.ones((5, 4), dtype=torch.bool))\n"
        "p = k.slot_pipeline_fused_packed(v, a, 2)\n"
        "assert bool((d == 1).all()) and bool((packed_window.unpack_codes(p, 4) == 1).all())\n"
        "print(cluster_round.CLUSTER_ROUND.launches + packed_window.PACKED_WINDOW.launches)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "0"  # no kernel on the CPU


def _entry_points():
    from rabia_tpu_torch import ClusterKernel, MeshEngine, MeshPhaseKernel
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine

    return {
        "ClusterKernel": lambda **kw: ClusterKernel(8, 3, **kw),
        "MeshPhaseKernel": lambda **kw: MeshPhaseKernel(8, 3, **kw),
        "MeshEngine": lambda **kw: MeshEngine(InMemoryStateMachine, 8, 3, **kw),
    }


@pytest.mark.parametrize("name", ["ClusterKernel", "MeshPhaseKernel", "MeshEngine"])
def test_entry_points_default_to_cuda_and_never_fall_back(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_unported_engine_lanes_are_refused_not_ignored():
    from rabia_tpu_torch import MeshEngine
    from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
    from rabia_tpu_torch.core.errors import ValidationError
    from rabia_tpu_torch.core.state_machine import InMemoryStateMachine

    # multi-device meshes are refused; the latency governor is ported
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MeshEngine(InMemoryStateMachine, 4, 3, device="cpu", mesh=object())
    # the transport engine's node kernel on the device is refused
    from rabia_tpu_torch.core.config import RabiaConfig
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.types import NodeId
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.net import InMemoryHub

    nodes = [NodeId.from_int(i + 1) for i in range(3)]
    for kernel_kw in ({"backend": "jax"}, {"zero_copy_inbox": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
            RabiaEngine(
                ClusterConfig.new(nodes[0], nodes), InMemoryStateMachine(),
                InMemoryHub().register(nodes[0]),
                config=RabiaConfig().with_kernel(**kernel_kw),
            )
    gov = MeshEngine(lambda: VectorShardedKV(4), 4, 3, device="cpu", device_store=True,
                     window=64, latency_target_ms=50.0, min_window=2, max_window=32)
    assert gov.governor_stats()["inflight"] == 1  # one window deep under a target
    assert gov.min_window <= gov.window <= gov.max_window
    # the device-resident KV lane and its read lane are ported: they need
    # replicas they can demote to, and run on them
    with pytest.raises(ValidationError, match="VectorShardedKV"):
        MeshEngine(InMemoryStateMachine, 4, 3, device="cpu", device_store=True)
    eng = MeshEngine(lambda: VectorShardedKV(4), 4, 3, device="cpu", device_store=True,
                     device_read_lane=True)
    assert eng.device_lane_active


def test_read_lane_and_dictionary_windows_run_with_jax_and_reference_blocked():
    """The dictionary packers, the dictionary windows and the read lane's
    probe run with jax and rabia_tpu unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rabia_tpu'] = None\n"
        "from rabia_tpu_torch import MeshEngine\n"
        "from rabia_tpu_torch.apps.device_kv import DeviceDictOps\n"
        "from rabia_tpu_torch.apps.kvstore import decode_result_bin, encode_set_bin\n"
        "from rabia_tpu_torch.apps.vector_kv import VectorShardedKV\n"
        "from rabia_tpu_torch.core.blocks import build_block\n"
        "eng = MeshEngine(lambda: VectorShardedKV(4), 4, 3, device='cpu', window=4,\n"
        "                 device_store=True, device_read_lane=True)\n"
        "sh = list(range(4))\n"
        "sets = [build_block(sh, [[encode_set_bin('k%d' % s, 'v')] for s in sh])] * 2\n"
        "assert isinstance(eng._dev.pack_window_auto(sets), DeviceDictOps)\n"
        "for b in sets:\n"
        "    eng.submit_block(b)\n"
        "eng.flush()\n"
        "get = bytes((2,)) + (2).to_bytes(2, 'little')\n"
        "f = eng.submit_block(build_block(sh, [[get + b'k%d' % s] for s in sh]))\n"
        "eng.flush()\n"
        "assert [decode_result_bin(r[0]).value for r in f.result()] == ['v'] * 4\n"
        "print(eng.read_lane_stats()['probe'])\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "4"  # the GETs were served off consensus


def test_transport_cluster_commits_with_jax_and_reference_blocked():
    """A 3-node cluster of the port's transport engines over the in-memory
    hub commits a batch on every replica, and MeshEngine.save_to /
    load_from round-trip through the port's persistence, with jax and
    rabia_tpu unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rabia_tpu'] = None\n"
        "import asyncio\n"
        "from rabia_tpu_torch.core.config import RabiaConfig\n"
        "from rabia_tpu_torch.core.network import ClusterConfig\n"
        "from rabia_tpu_torch.core.state_machine import InMemoryStateMachine\n"
        "from rabia_tpu_torch.core.types import CommandBatch, NodeId\n"
        "from rabia_tpu_torch.engine import RabiaEngine\n"
        "from rabia_tpu_torch.net import InMemoryHub\n"
        "from rabia_tpu_torch.parallel import MeshEngine\n"
        "from rabia_tpu_torch.persistence import InMemoryPersistence\n"
        "async def main():\n"
        "    cfg = RabiaConfig(phase_timeout=3.0, heartbeat_interval=0.05,\n"
        "                      round_interval=0.002).with_kernel(num_shards=2, shard_pad_multiple=2)\n"
        "    hub = InMemoryHub()\n"
        "    nodes = [NodeId.from_int(i + 1) for i in range(3)]\n"
        "    sms = [InMemoryStateMachine() for _ in nodes]\n"
        "    engs = [RabiaEngine(ClusterConfig.new(n, nodes), sm, hub.register(n), config=cfg)\n"
        "            for n, sm in zip(nodes, sms)]\n"
        "    tasks = [asyncio.ensure_future(e.run()) for e in engs]\n"
        "    for _ in range(300):\n"
        "        await asyncio.sleep(0.01)\n"
        "        if all([(await e.get_statistics()).has_quorum for e in engs]):\n"
        "            break\n"
        "    f = await engs[1].submit_batch(CommandBatch.new(['SET a 1', 'SET b 2']), shard=1)\n"
        "    assert await asyncio.wait_for(f, 15.0) == [b'OK', b'OK']\n"
        "    for _ in range(500):\n"
        "        if all(sm.get('b') == '2' for sm in sms):\n"
        "            break\n"
        "        await asyncio.sleep(0.01)\n"
        "    assert [sm.get('b') for sm in sms] == ['2'] * 3\n"
        "    assert engs[0].health()['planes']['tick'] == 'native'\n"
        "    for e in engs:\n"
        "        await e.shutdown()\n"
        "    for t in tasks:\n"
        "        t.cancel()\n"
        "    await asyncio.gather(*tasks, return_exceptions=True)\n"
        "    mesh = MeshEngine(InMemoryStateMachine, 2, 3, device='cpu')\n"
        "    mesh.submit([b'SET m 1'], 0)\n"
        "    mesh.flush()\n"
        "    p = InMemoryPersistence()\n"
        "    await mesh.save_to(p)\n"
        "    back = MeshEngine(InMemoryStateMachine, 2, 3, device='cpu')\n"
        "    assert await back.load_from(p) and back.sms[2].get('m') == '1'\n"
        "    print(sum(len(e.rt.shards[1].decisions) for e in engs))\n"
        "asyncio.run(main())\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "3"  # one decided slot on each replica


def test_apps_and_harnesses_run_with_jax_and_reference_blocked():
    """The apps (counter, KV store, banking, the sharded KV service with
    adaptive batching), the batcher and the fault-injection harness run
    with jax and rabia_tpu unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rabia_tpu'] = None\n"
        "import asyncio\n"
        "from rabia_tpu_torch.apps import (BankCommand, BankingSMR, CounterCommand, CounterSMR,\n"
        "    ShardedKVService, make_sharded_kv)\n"
        "from rabia_tpu_torch.core.batching import CommandBatcher\n"
        "from rabia_tpu_torch.core.config import BatchConfig\n"
        "from rabia_tpu_torch.core.types import Command\n"
        "from rabia_tpu_torch.testing import TestScenario, run_scenario\n"
        "c = CounterSMR()\n"
        "assert c.apply_command(CounterCommand.increment(3)).value == 3\n"
        "b = BankingSMR()\n"
        "assert b.apply_command(BankCommand.create('a', 5)).ok and b.total_value() == 5\n"
        "bat = CommandBatcher(BatchConfig(max_batch_size=2, adaptive=False))\n"
        "assert bat.add(Command.new('x'), now=0.0) is None and len(bat.add(Command.new('y'), now=0.0)) == 2\n"
        "async def main():\n"
        "    sm, machines = make_sharded_kv(4)\n"
        "    async def submit(batch, shard):\n"
        "        f = asyncio.get_running_loop().create_future()\n"
        "        f.set_result(sm.apply_batch(batch))\n"
        "        return f\n"
        "    svc = ShardedKVService(4, submit, machines, batching=BatchConfig(max_batch_size=4))\n"
        "    rs = await asyncio.gather(*[svc.set(f'k{i}', 'v') for i in range(8)])\n"
        "    await svc.close()\n"
        "    assert all(r.ok for r in rs) and sum(m.store.size() for m in machines) == 8\n"
        "    res = await run_scenario(TestScenario(name='basic', node_count=3, initial_commands=3))\n"
        "    assert res.passed, res.detail\n"
        "    print(sum(s.batches_created for s in svc.batch_stats))\n"
        "asyncio.run(main())\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert 2 <= int(out.stdout.split()[-1]) < 8  # the 8 SETs rode fewer batches than SETs


def test_native_kv_store_is_refused_not_replaced(monkeypatch):
    """make_sharded_kv builds native stores over one plane by default and
    with native=True, Python stores with native=False. With the native
    apply plane switched off (RABIA_PY_APPLY=1) the default builds Python
    stores, and native=True raises: it never quietly builds Python stores
    in place of the native ones asked for."""
    from rabia_tpu_torch.apps import KVStore, make_sharded_kv
    from rabia_tpu_torch.apps.native_store import NativeKVStore
    from rabia_tpu_torch.apps.kvstore import StoreError

    for native in (None, True):
        sm, machines = make_sharded_kv(4, native=native)
        assert all(type(m.store) is NativeKVStore for m in machines)
        assert sm._native_plane is machines[0].store.plane
    sm, machines = make_sharded_kv(4, native=False)
    assert all(type(m.store) is KVStore for m in machines)
    assert sm._native_plane is None
    monkeypatch.setenv("RABIA_PY_APPLY", "1")
    with pytest.raises(StoreError, match="statekernel unavailable"):
        make_sharded_kv(4, native=True)
    for native in (None, False):
        sm, machines = make_sharded_kv(4, native=native)
        assert len(machines) == 4 and all(type(m.store) is KVStore for m in machines)
        assert sm._native_plane is None


def test_fleet_critpath_and_chaos_run_with_jax_and_reference_blocked():
    """The fleet tier (a MOVED redirect and a replay through two fleet
    gateways), the critical-path decomposition of the cluster's slowlog
    exemplars and a chaos profile on the simulator run with jax and
    rabia_tpu unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rabia_tpu'] = None\n"
        "import asyncio\n"
        "from rabia_tpu_torch.apps.kvstore import encode_set_bin\n"
        "from rabia_tpu_torch.chaos import ChaosProfile, run_profile\n"
        "from rabia_tpu_torch.core.messages import ResultStatus\n"
        "from rabia_tpu_torch.fleet.harness import FleetHarness, FleetSession\n"
        "from rabia_tpu_torch.obs.critpath import (CritpathAggregator, decompose_exemplars,\n"
        "    inprocess_exemplar_timeline)\n"
        "async def main():\n"
        "    h = FleetHarness(n_gateways=2, n_shards=4, persistence=False)\n"
        "    await h.start()\n"
        "    try:\n"
        "        owner = h.gateways[0].ring.owner(0).name\n"
        "        wrong = next(g for g in h.gateways if g.config.name != owner)\n"
        "        r = h.resolver()\n"
        "        r.note_moved(0, ('127.0.0.1', wrong.port))\n"
        "        s = FleetSession(h.ser, r)\n"
        "        res = await s.submit(0, [encode_set_bin('p', '1')])\n"
        "        assert res.status == ResultStatus.OK and s.redirects == 1\n"
        "        again = await s.submit_seq(res.seq, 0, [encode_set_bin('p', '1')])\n"
        "        assert again.status == ResultStatus.CACHED\n"
        "        ex = [e for g in h.cluster.gateways for e in g.slowlog.document()['exemplars']]\n"
        "        agg = CritpathAggregator()\n"
        "        engines = list(h.cluster.engines)\n"
        "        d = decompose_exemplars(ex, lambda e: inprocess_exemplar_timeline(engines, e), agg)\n"
        "        assert any(x['ok'] for x in d)\n"
        "        await s.close()\n"
        "    finally:\n"
        "        await h.stop()\n"
        "    rep = await run_profile(ChaosProfile(name='p', fabric='sim', description='',\n"
        "        duration=1.0, warmup=0.5, rate=40.0, min_availability=0.2), verbose=False)\n"
        "    assert rep['pass'], rep['problems']\n"
        "    print(agg.summary()['exemplars'])\n"
        "asyncio.run(main())\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 1
