"""The port's conformance fuzz (``scripts/torch_fuzz_conformance.py``)
against the reference's (``scripts/fuzz_conformance.py``) on the CPU.

- Each of the four kernel trials (stepwise, fused, mesh-crash,
  sharded-lossy) runs in both programs on fixed seeds: both pass, and
  every input a trial hands its kernels (initial votes, alive masks,
  delivery masks, window votes) is equal, call for call, so a repro
  seed printed by one program reproduces in the other. The port's
  kernels take their plain versions here (CPU tensors).
- The CLI under ``--device cpu`` with every engine-level trial kind.
- Two planted faults (a round step that flips one shard's decision, a
  fused window that flips one slot) fail the fuzz with the seed.
- Without a card and without ``--device cpu`` the fuzz raises.
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
ABSENT = 3


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_fuzz_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("torch_fuzz_conformance")


@pytest.fixture(scope="module")
def ref():
    return _load("fuzz_conformance")


def _np(x) -> np.ndarray:
    """A JAX array's, a tensor's or a MeshArray's values."""
    return x.numpy() if type(x).__name__ == "MeshArray" else np.asarray(x)


class _Rec:
    """A kernel that logs what a trial hands it, then runs it."""

    def __init__(self, k, log: list) -> None:
        self._k, self._log = k, log

    def __getattr__(self, name):
        return getattr(self._k, name)

    def start_slot(self, state, mask, votes):
        self._log.append(("start_slot", _np(votes)))
        return self._k.start_slot(state, mask, votes)

    def round_step(self, state, alive, deliver):
        self._log.append(("round_step", _np(alive), _np(deliver)))
        return self._k.round_step(state, alive, deliver)

    def slot_pipeline(self, votes, alive, n_slots, *rest):
        self._log.append(("slot_pipeline", _np(votes), _np(alive)))
        return self._k.slot_pipeline(votes, alive, n_slots, *rest)

    def phase_step(self, state, alive, idx):
        self._log.append(("phase_step", _np(alive)))
        return self._k.phase_step(state, alive, idx)


@pytest.fixture(scope="module")
def kernels(port, ref):
    """Each program's kernel caches, built once for the module."""
    return {"port": (port._kernels("cpu"), port._mesh_kernels("cpu")),
            "ref": (ref._kernels(), ref._mesh_kernels())}


def _run(mod, caches, kind: str, seed: int) -> list:
    """One trial of ``kind`` on ``seed`` through recording kernels."""
    log: list = []
    get_kernel, get_mesh = caches
    if kind in ("stepwise", "fused"):
        rec = lambda S, R, kseed: _Rec(get_kernel(S, R, kseed), log)  # noqa: E731
        getattr(mod, f"_trial_{kind}")(rec, seed)
    else:
        rec = lambda geo: tuple(  # noqa: E731
            x if i == 2 else _Rec(x, log) for i, x in enumerate(get_mesh(geo)))
        getattr(mod, f"_trial_{kind}")(rec, seed)
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
@pytest.mark.parametrize("kind", ["stepwise", "fused", "mesh_crash", "sharded_lossy"])
def test_trial_draws_the_reference_schedule_and_passes(port, ref, kernels, kind, seed):
    got = _run(port, kernels["port"], kind, seed)
    want = _run(ref, kernels["ref"], kind, seed)
    assert [e[0] for e in got] == [e[0] for e in want]
    assert got, "the trial handed its kernels nothing"
    for n, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a[1:], b[1:]):
            assert x.shape == y.shape, (kind, seed, n, a[0])
            assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), (kind, seed, n, a[0])


def test_oracle_sample_covers_the_tile_edges(port):
    sample = port.oracle_sample(4096)
    assert sample[0] == 0 and sample[-1] == 4095
    for b in list(range(16, 257, 16)) + list(range(3840, 4096, 16)):
        assert b - 1 in sample and b in sample
    assert port.oracle_sample(8) == [0, 7]


def test_wide_stepwise_holds_every_shard_against_the_plain_round(port):
    """The wide form (a sample of shards against the oracle, every
    shard's state against round_step_plain) on a pool of one geometry
    wider than a tile."""
    get = port._kernels("cpu")
    pool = [(300, 5, 3)]
    for seed in (0, 1):
        port._trial_stepwise(get, seed, pool, port.oracle_sample(300))


class _FlipDecision(_Rec):
    """round_step flips shard 0's decision (ABSENT becomes V0)."""

    def round_step(self, state, alive, deliver):
        out = self._k.round_step(state, alive, deliver)
        d = out.decided.clone()
        d[0] = 0 if int(d[0]) == ABSENT else 1 - int(d[0])
        return out._replace(decided=d)


class _FlipSlot(_Rec):
    """slot_pipeline_fused flips one slot's decision."""

    def slot_pipeline_fused(self, votes, alive, n_slots):
        d, p = self._k.slot_pipeline_fused(votes, alive, n_slots)
        d = d.clone()
        d[0, 0] = (int(d[0, 0]) + 1) % 4
        return d, p


@pytest.mark.parametrize("fault, message", [
    (_FlipDecision, "seed=0 t=0 shard=0"),
    (_FlipSlot, "fused divergence: seed=0"),
])
def test_planted_fault_fails_with_its_seed(port, monkeypatch, fault, message):
    kernels = port._kernels

    def faulty(device):
        get = kernels(device)
        return lambda S, R, kseed: fault(get(S, R, kseed), [])

    monkeypatch.setattr(port, "_kernels", faulty)
    with pytest.raises(AssertionError, match=message):
        port.main(["--device", "cpu", "--seconds", "0"])


def test_cli_on_the_cpu_runs_every_trial_kind():
    proc = subprocess.run(
        [sys.executable, "scripts/torch_fuzz_conformance.py", "--device", "cpu",
         "--seconds", "2", "--mesh", "2", "--planes", "1", "--tick", "1", "--apply", "2",
         "--gateway", "2", "--wal", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert out.startswith("fuzz OK: ")
    for what in ("1 plane-differential", "1 tick-path", "2 apply-path", "2 gateway-table",
                 "2 durability-plane", "2 mesh-plane fault schedules conformant"):
        assert what in out, out


def test_without_a_card_the_fuzz_raises(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--seconds", "0"])
