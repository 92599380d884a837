"""The sanitizer matrix over the port's native sources
(``rabia_tpu_torch/native/*.cpp`` and ``native/stress/``).

The port's copy of the reference's sanitizer cells
(tests/test_static_analysis.py, ``TestSanitizerMatrix``): each stress
program, built by the port's ``native/build.build_stress`` from the port's
own sources into ``build/rabia_tpu_torch/stress/``, runs under TSan or
ASan with ``halt_on_error`` (any finding is a nonzero exit), after
``find_sanitizer_toolchain`` has proved the toolchain (a clean probe
passes and a planted bug is caught); the selfchecks prove the gate red
on a planted race and a planted use-after-free. The ``slow`` marks are
the reference's.
"""

from __future__ import annotations

import shutil
import subprocess

import pytest

from rabia_tpu_torch.native import build as nb


def _toolchain_or_skip(flavor: str):
    if shutil.which("g++") is None and shutil.which("clang++") is None:
        pytest.skip("no C++ compiler")
    tc = nb.find_sanitizer_toolchain(flavor)
    if tc is None:
        reason = getattr(nb.find_sanitizer_toolchain, "reason", "?")
        pytest.skip(f"no viable {flavor} toolchain: {reason}")
    return tc


def _run_cell(name: str, flavor: str, extra_args: list[str] | None = None):
    """Build + run one enforced sanitizer cell; any finding is FATAL
    (no skip past this point — the toolchain is already proven)."""
    exe = nb.build_stress(name, flavor)
    proc = subprocess.run(
        [str(exe), *(extra_args or [])],
        capture_output=True, text=True, timeout=300,
        env=nb.stress_env(flavor),
    )
    assert proc.returncode == 0, (
        f"{flavor}/{name} stress FAILED rc={proc.returncode}\n"
        f"{proc.stdout[-800:]}\n{proc.stderr[-4000:]}"
    )
    assert "stress ok" in proc.stdout  # the seam did real work


class TestSanitizerMatrix:
    """Enforced TSan/ASan cells over the cross-thread seams that the
    thread-per-shard-group runtime (ROADMAP item 1) will multiply."""

    def test_tsan_transport(self):
        _toolchain_or_skip("tsan")
        _run_cell("transport", "tsan")

    def test_tsan_wal(self, tmp_path):
        _toolchain_or_skip("tsan")
        _run_cell("wal", "tsan", [str(tmp_path)])

    def test_tsan_session(self):
        _toolchain_or_skip("tsan")
        _run_cell("session", "tsan")

    def test_tsan_statekernel(self):
        _toolchain_or_skip("tsan")
        _run_cell("statekernel", "tsan")

    @pytest.mark.slow
    def test_tsan_runtime(self):
        _toolchain_or_skip("tsan")
        _run_cell("runtime", "tsan")

    def test_tsan_runtime_mt(self, tmp_path):
        # the thread-per-shard-group seams: 2 workers vs group inbox
        # routing, per-lane applies, shared WAL staging, the pause
        # barrier — the round-14 correctness gate
        _toolchain_or_skip("tsan")
        _run_cell("runtime_mt", "tsan", [str(tmp_path)])

    @pytest.mark.slow
    def test_asan_runtime_mt(self, tmp_path):
        _toolchain_or_skip("asan")
        _run_cell("runtime_mt", "asan", [str(tmp_path)])

    def test_asan_wal(self, tmp_path):
        _toolchain_or_skip("asan")
        _run_cell("wal", "asan", [str(tmp_path)])

    def test_asan_session(self):
        _toolchain_or_skip("asan")
        _run_cell("session", "asan")

    @pytest.mark.slow
    def test_asan_transport(self):
        _toolchain_or_skip("asan")
        _run_cell("transport", "asan")

    @pytest.mark.slow
    def test_asan_statekernel_and_runtime(self):
        _toolchain_or_skip("asan")
        _run_cell("statekernel", "asan")
        _run_cell("runtime", "asan")

    @pytest.mark.slow
    def test_ubsan_all(self, tmp_path):
        _toolchain_or_skip("ubsan")
        for name in sorted(nb.STRESS_PROGRAMS):
            needs_dir = name in ("wal", "runtime_mt")
            args = [str(tmp_path / name)] if needs_dir else []
            if needs_dir:
                (tmp_path / name).mkdir()
            _run_cell(name, "ubsan", args)

    def test_tsan_gate_is_red_on_a_planted_race(self):
        """The gate must FAIL on a real race — proof the matrix is
        enforced, not green-by-silence."""
        _toolchain_or_skip("tsan")
        exe = nb.build_selfcheck("tsan")
        for _ in range(5):
            proc = subprocess.run(
                [str(exe)], capture_output=True, text=True, timeout=120,
                env=nb.stress_env("tsan"),
            )
            if proc.returncode != 0:
                return
        pytest.fail("TSan did not catch the planted data race")

    def test_asan_gate_is_red_on_a_planted_uaf(self):
        _toolchain_or_skip("asan")
        exe = nb.build_selfcheck("asan")
        proc = subprocess.run(
            [str(exe)], capture_output=True, text=True, timeout=120,
            env=nb.stress_env("asan"),
        )
        assert proc.returncode != 0, (
            "ASan did not catch the planted use-after-free"
        )
