"""Every cell of BENCHMARK.json driven end to end on the port's CPU path
at a tiny width (the harness's look for a card skipped): the comparison
passes on the program as it is, and ``correct`` comes out false with the
timed path broken underneath, once for each fault the cell can have: an
answer altered where it is produced, half of the batch left out, and a
step that returns its state unchanged (the cells that write). The control
(the reference with a guarantee broken, in the program's place) fails.
The same control at the cells' own sizes runs on the card (``-m cuda``)."""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pbench import spec
from pbench.trace import Spans

import run as bench_run

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")
SEED = 2**41 + 3


def tiny(name: str):
    """The cell at 64 shards, a 16-block pool, 64 slots a window."""
    cell = spec.resolve(BENCH, name)
    cell.config = dict(cell.config, shards=64)
    if cell.traffic["driver"] == "mesh_blocks":
        cell.traffic = dict(cell.traffic, pool_blocks=16, warmup_blocks=16)
    else:
        cell.traffic = dict(cell.traffic, slots_per_window=64)
    return cell


def run_tiny(name: str, trace: bool = False, seconds: float = 0.6) -> dict:
    return bench_run.run_cell(tiny(name), SEED, seconds, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu_path(name):
    out = run_tiny(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in spec.resolve(BENCH, name).end_to_end}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_per_layer_metrics(name):
    out = run_tiny(name, trace=True)
    assert out["correct"], out["checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in spec.resolve(BENCH, name).per_layer}
    # device-trace metrics find nothing to read on the CPU and are left out
    assert set(out["metrics"]) <= names
    for m in out["metrics"].values():
        assert np.isfinite(m["value"])


# -- faults planted under the timed path ----------------------------------------


def _flip_first_frame(monkeypatch):
    from rabia_tpu_torch.parallel import mesh_engine

    real = mesh_engine.MeshBlockFuture.result

    def result(self):
        out = real(self)
        frame = bytearray(bytes(out[0][0]))
        frame[1] ^= 1  # the version's low byte
        return [[bytes(frame)]] + out[1:]

    monkeypatch.setattr(mesh_engine.MeshBlockFuture, "result", result)


def _mixed_keeps_state(monkeypatch):
    from rabia_tpu_torch.apps import device_kv

    real = device_kv.DeviceKVTable.mixed_apply

    def mixed_apply(self, *a, state=None, **kw):
        _, flags, meta, gval = real(self, *a, state=state, **kw)
        return (self.state if state is None else state), flags, meta, gval

    monkeypatch.setattr(device_kv.DeviceKVTable, "mixed_apply", mixed_apply)


def _mixed_drops_half(monkeypatch):
    from rabia_tpu_torch.apps import device_kv

    real = device_kv.DeviceKVTable.pack_mixed_window_auto

    def pack(self, blocks):
        got = real(self, blocks)
        if got is not None:
            got[0][:, got[0].shape[1] // 2:] = 0  # no op on the second half of the shards
        return got

    monkeypatch.setattr(device_kv.DeviceKVTable, "pack_mixed_window_auto", pack)


def _probe_drops_half(monkeypatch):
    from rabia_tpu_torch.apps import device_kv

    real = device_kv.DeviceKVTable.lookup_only

    def lookup_only(self, *a, **kw):
        found, *rest = real(self, *a, **kw)
        found = found.clone()
        found[:, found.shape[1] // 2:] = False
        return (found, *rest)

    monkeypatch.setattr(device_kv.DeviceKVTable, "lookup_only", lookup_only)


def _decide_patch(monkeypatch, change):
    from rabia_tpu_torch.kernel import fused_window

    real = fused_window.window_rmajor

    def window_rmajor(votes, alive, quorum, want_phase=True):
        return change(real(votes, alive, quorum, want_phase))

    monkeypatch.setattr(fused_window, "window_rmajor", window_rmajor)


def _flip_one_decision(dec):
    dec = dec.clone()
    dec[0, 0] = 1 - dec[0, 0] if int(dec[0, 0]) in (0, 1) else 1
    return dec


def _unchanged(dec):
    return torch.full_like(dec, 3)  # the plane as a window starts it: nothing decided


def _half_slots(dec):
    dec = dec.clone()
    dec[dec.shape[0] // 2:] = 3
    return dec


FAULTS = {
    "kv4096-ycsbA": {"answer_altered": _flip_first_frame, "state_unchanged": _mixed_keeps_state,
                     "half_batch": _mixed_drops_half},
    "kv16384z-ycsbC": {"answer_altered": _flip_first_frame, "half_batch": _probe_drops_half},
    "kv4096-decide": {
        "answer_altered": lambda mp: _decide_patch(mp, _flip_one_decision),
        "state_unchanged": lambda mp: _decide_patch(mp, _unchanged),
        "half_batch": lambda mp: _decide_patch(mp, _half_slots),
    },
}


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in sorted(FAULTS[n])])
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[name][fault](monkeypatch)
    with contextlib.redirect_stderr(sys.stdout):
        out = run_tiny(name)
    assert not out["correct"], out["checks"]


# -- the control ----------------------------------------------------------------


def _control_readings(cell, seed: int, device, seconds: float) -> tuple[dict, dict]:
    drv = spec.driver(cell.traffic["driver"])
    st = drv.setup(cell, seed, device)
    run = drv.window(st, seconds, Spans(False))
    return {k: v for k, (v, _) in drv.check(st, run).items()}, drv.control(st)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    program, control = _control_readings(tiny(name), SEED, CPU, 0.5)
    assert all(v == 0 for v in program.values()), program
    assert any(v > 0 for v in control.values()), control


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card_at_the_cells_size(name, cuda_device):
    """The control at the cell's own size and load, on three seeds: every
    number of the program's reads 0, and the control fails one."""
    for seed in (2**33 + 1, 2**35 + 5, 2**37 + 9):
        program, control = _control_readings(spec.resolve(BENCH, name), seed, cuda_device, 3.0)
        print(name, seed, "program", program, "control", control)
        assert all(v == 0 for v in program.values()), program
        assert any(v > 0 for v in control.values()), control


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch; sys.path[:0] = [{root!r}, {bench!r}];"
        "import run; from pbench import spec; b = spec.load_benchmark();"
        "cells = [spec.resolve(b, n) for n in ('kv4096-ycsbA', 'kv4096-decide')];"
        "cells[0].config = dict(cells[0].config, shards=16);"
        "cells[0].traffic = dict(cells[0].traffic, pool_blocks=8, warmup_blocks=8);"
        "cells[1].config = dict(cells[1].config, shards=16);"
        "cells[1].traffic = dict(cells[1].traffic, slots_per_window=8);"
        "[run.run_cell(c, 1, 0.3, False, torch.device('cpu'), time.perf_counter()) for c in cells];"
        "print('FOUND', run.forbidden_modules())"
    ).format(root=str(spec.ROOT), bench=str(spec.HERE))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(spec.ROOT))
    assert "FOUND []" in got.stdout, got.stdout[-2000:] + got.stderr[-2000:]


def test_result_line_is_plain_json():
    out = run_tiny("kv4096-decide")
    line = json.dumps(out)
    assert json.loads(line)["checks"]["decisions_wrong"] == {"value": 0, "limit": 0}
