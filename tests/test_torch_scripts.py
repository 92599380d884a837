"""The port's entry points beside the reference's scripts, on the CPU.

- ``scripts/torch_smoke_engine.py`` prints what ``scripts/smoke_engine.py``
  prints, the decision's seconds apart.
- ``scripts/torch_soak.py`` passes each leg (the transport soak on both
  backends, the mesh plane with and without the device store, the TCP
  restarts) at a few seconds and 8 shards, the device legs under
  ``--device cpu``; without a card and without ``--device cpu`` the
  device legs raise.
- ``scripts/torch_load_soak.py`` runs a port test file under a hog.
- ``scripts/torch_lint_gate.py`` fails on a planted F401 in a scratch
  tree and passes on the port's tree.
- ``scripts/torch_sanitize_gate.py --selfcheck`` catches its planted bug
  on the cheapest sanitizer flavor this host has.
- The fleet smokes pass (the group smoke is ``slow``: its replica
  processes take ports picked before they bind).
- ``chip_smoke.py`` phase 20's two functions at a small size.
- No program of the port imports jax or the JAX package.
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
SCRIPTS = ["fuzz_conformance", "smoke_engine", "soak", "load_soak", "group_smoke",
           "fleet_smoke", "fleet_obs_smoke", "slowlog_smoke", "sanitize_gate", "lint_gate"]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args: list, timeout: float = 240.0) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=ENV)


def test_every_queue_1b_script_has_a_port_that_imports_no_jax():
    banned = re.compile(r"^\s*(from|import) (jax|rabia_tpu)(\.|\s|$)", re.MULTILINE)
    files = [ROOT / "scripts" / f"torch_{n}.py" for n in SCRIPTS]
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "rabia_tpu_torch").rglob("*.py"))]
    for f in files:
        assert f.exists(), f
        assert not banned.search(f.read_text()), f


def test_smoke_engine_prints_what_the_reference_prints():
    timed = re.compile(r"^decision in \d+\.\d+s")
    port, ref = _run(["scripts/torch_smoke_engine.py"]), _run(["scripts/smoke_engine.py"])
    assert port.returncode == 0 and ref.returncode == 0, port.stderr[-2000:] + ref.stderr[-2000:]
    a = [timed.sub("decision in", ln) for ln in port.stdout.splitlines()]
    b = [timed.sub("decision in", ln) for ln in ref.stdout.splitlines()]
    assert a == b and a[-1] == "PASS", (a, b)


@pytest.mark.parametrize("leg, ok", [
    (["--backend", "host"], "soak OK: all replicas convergent"),
    (["--backend", "jax", "--device", "cpu"], "soak OK: all replicas convergent"),
    (["--plane", "mesh", "--device", "cpu"], "mesh soak OK:"),
    (["--plane", "mesh", "--device-store", "--device", "cpu"], "mesh soak OK:"),
    (["--transport", "tcp"], "tcp soak OK: replicas convergent across restarts"),
])
def test_soak_leg_passes(leg, ok):
    proc = _run(["scripts/torch_soak.py", "--seconds", "3", "--shards", "8", *leg])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1].startswith(ok), proc.stdout[-2000:]


@pytest.mark.parametrize("leg", [["--plane", "mesh"], ["--plane", "mesh", "--device-store"],
                                 ["--backend", "jax"]])
def test_soak_device_legs_raise_without_a_card(monkeypatch, leg):
    soak = _load("torch_soak")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["--seconds", "0", *leg])


def test_load_soak_runs_a_port_test_file_under_a_hog():
    load = _load("torch_load_soak")
    assert "tests/test_torch_scripts.py" in load.port_tests()
    assert load.targets(["-x"])[-1] == "-x" and len(load.targets(["-x"])) > 2
    proc = _run(["scripts/torch_load_soak.py", "--runs", "1", "--hogs", "1", "--duty", "0.1",
                 "--", "tests/test_torch_coin.py", "-p", "no:cacheprovider"])
    assert proc.returncode == 0, proc.stdout[-2000:]
    assert '"green": 1' in proc.stdout.splitlines()[-1]


def test_lint_gate_fails_on_a_planted_finding_and_passes_on_the_port(tmp_path, capsys):
    lint = _load("torch_lint_gate")
    pkg = tmp_path / "rabia_tpu_torch"
    pkg.mkdir()
    (pkg / "ok.py").write_text("import os\n\nprint(os.sep)\n")
    assert lint.run_fallback(tmp_path) == 0
    (pkg / "planted.py").write_text("from json import (\n    dumps,\n    loads,\n)\n")
    (tmp_path / "chip_smoke.py").write_text("try:\n    pass\nexcept:\n    pass\n")
    assert lint.run_fallback(tmp_path) == 1
    out = capsys.readouterr().out
    assert "planted.py:1: F401 unused import 'dumps'" in out
    assert "chip_smoke.py:3: E722 bare except" in out
    assert lint.run_fallback(ROOT) == 0, capsys.readouterr().out[-3000:]


def test_sanitize_gate_selfcheck_catches_its_planted_bug():
    from rabia_tpu_torch.native import build as nb

    flavor = next((f for f in ("ubsan", "asan", "tsan") if nb.find_sanitizer_toolchain(f)), None)
    if flavor is None:
        pytest.skip("no viable sanitizer toolchain on this host")
    proc = _run(["scripts/torch_sanitize_gate.py", "--flavor", flavor, "--selfcheck",
                 "--programs", "session"], timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert f"{flavor}/selfcheck   PASS (planted bug caught)" in proc.stdout


@pytest.mark.parametrize("args", [
    ["scripts/torch_fleet_smoke.py", "--scale", "0.5"],
    ["scripts/torch_fleet_obs_smoke.py", "--out-dir", "{tmp}"],
    ["scripts/torch_slowlog_smoke.py", "--out-dir", "{tmp}"],
])
def test_fleet_smoke_passes(tmp_path, args):
    proc = _run([a.format(tmp=tmp_path) for a in args])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "PASS" in proc.stdout.strip().splitlines()[-1]


@pytest.mark.slow
def test_group_smoke_passes(tmp_path):
    proc = _run(["scripts/torch_group_smoke.py", "--scale", "0.5", "--out",
                 str(tmp_path / "g.json")], timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].endswith("PASS")


def test_chip_smoke_phase_20_at_a_small_size():
    """Phase 20's fuzz (its pools, budget 0, one mesh round: each
    geometry once, 4096 x 5 and its 4x1 and 4x5 meshes included) and its
    soak legs at 8 shards, on the CPU."""
    import chip_smoke

    fuzz = chip_smoke.conformance_fuzz("cpu", budget_s=0.0, mesh_rounds=1)
    t = fuzz["trials"]
    assert t["stepwise 4096x5"] == 1 and t["fused 4096x5"] == 1 and t["planes"] == 1
    assert t["mesh-crash 4096x5 on 4x5"] == 1 and t["sharded-lossy 4096x5 on 4x1"] == 1
    assert sum(t.values()) == 8 + 10 + 1
    soak = chip_smoke.chaos_soak("cpu", S=8, mesh_s=2.0, jax_s=2.0)
    assert soak["mesh --device-store"]["repromotions"] >= 1
    assert soak["mesh --device-store"]["last"].startswith("mesh soak OK:")
    assert soak["transport --backend jax"]["last"] == "soak OK: all replicas convergent"
