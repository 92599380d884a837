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
    assert int(out.stdout.split()[-1]) >= 24  # every submodule was walked


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
