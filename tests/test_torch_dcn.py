"""The multi-controller mesh across OS processes on the CPU (gloo).

``scripts/torch_dcn_dryrun.py --procs 2`` runs two ranks of one world
mesh (``phase_step``, ``slot_window`` and the whole ``MeshEngine`` across
the processes, each rank checking its blocks); the ``engine`` workload's
two ranks must land on the reference ``MeshEngine``'s decisions, futures
and replica state. Every run has its limits: the ranks' process group
times out after 60 s, the parent kills every rank after its own timeout
(at most 100 s here), and the subprocess around the script after 120 s.
Tolerance: exact equality."""

from __future__ import annotations

import subprocess
import sys

import pytest

from rabia_tpu.core.state_machine import InMemoryStateMachine as RefSM
from rabia_tpu.parallel import MeshEngine as RefEngine
from rabia_tpu.parallel import make_mesh as ref_make_mesh
from rabia_tpu_torch.testing import dcn
from rabia_tpu_torch.testing.multiproc import REPO


def test_dryrun_script_two_gloo_ranks():
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_dcn_dryrun.py"), "--procs", "2",
         "--timeout", "100"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "torch dcn dryrun ok: 2 processes (gloo, cpu)" in proc.stdout
    assert proc.stdout.count("equal the one-device plain versions") == 2


def test_engine_ranks_match_the_reference_engine():
    """Two ranks (shard axis across them, S = 16 padded to 16) run the
    engine workload through ``_run_window_multihost``; both equal the
    reference engine on its 8-device mesh, byte for byte."""
    S, R, W = 16, 5, 4
    ranks = dcn.spawn_ranks(2, backend="gloo", device="cpu", workload="engine",
                            timeout=100, args=(S, R, W))
    want = dcn.digest(dcn.engine_workload(RefEngine(RefSM, S, R, mesh=ref_make_mesh(),
                                                    window=W)))
    assert [r["digest"] for r in ranks] == [want, want]
    assert all(r["backend"] == "gloo" and r["windows"] > 0 for r in ranks)


def test_ranks_that_outlast_the_deadline_are_killed():
    with pytest.raises(RuntimeError, match="outlasted 1.0 s; every rank killed"):
        dcn.spawn_ranks(2, backend="gloo", device="cpu", workload="dryrun", timeout=1.0)
