"""The whole slice at a small size on the CPU: the twin of chip_smoke.py's
phases 3-5, 7 and 8 (protocol vs fused entry, the decision core checked
against both plain windows, the MeshEngine serving lane, the
device-resident KV lane beside the host block lane, the read lane beside
the device lane without it and the host block lane), run by the same code
with device="cpu" at S=16, R=5. The same phases on the card are the
cuda-marked tests at the end."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from rabia_tpu_torch.core.types import ABSENT, V0, V1
from rabia_tpu_torch.kernel import fused_window, kv_window, mesh_window
from rabia_tpu_torch.parallel import MeshPhaseKernel

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

S, R = 16, 5


def test_protocol_vs_fused_entry_cpu():
    chip_smoke.protocol_vs_fused("cpu", S, R, 16)


def test_decision_core_cpu_matches_an_independent_count():
    k, bufs, alive, err = chip_smoke.decision_core("cpu", S, R, 64)
    assert err == 0
    # an independent count in numpy, not the port's own plain version
    votes, a = bufs[0].numpy(), alive.numpy()
    c1 = ((votes == V1) & a[:, None, :]).sum(0)
    c0 = ((votes == V0) & a[:, None, :]).sum(0)
    want = np.where(c1 >= k.quorum, V1, np.where(c0 >= k.quorum, V0, ABSENT))
    got = k.slot_pipeline_fused_rmajor(bufs[0], alive, 64, want_phase=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serving_lane_cpu():
    before = fused_window.FUSED_WINDOW.launches
    lane = chip_smoke.serving_lane("cpu", S, R, window=16)
    assert lane["first_flush_cycles"] == 1  # SET+GET per shard fit one window
    assert lane["throughput_applied"] == 4 * S
    assert fused_window.FUSED_WINDOW.launches == before  # no kernel on the CPU


def test_device_kv_lane_cpu():
    before = kv_window.KV_WINDOW.launches
    stats, eng = chip_smoke.device_kv_lane("cpu", S, R)
    assert stats["blocks"] == 102 and stats["entries"] > 0
    assert not eng.device_lane_active  # sync_to_host demoted it at the end
    assert eng.device.type == "cpu" and eng._dev.state.used.device.type == "cpu"
    assert kv_window.KV_WINDOW.launches == before  # no kernel on the CPU


def test_read_lane_cpu():
    before = kv_window.KV_WINDOW.launches
    stats, eng = chip_smoke.device_read_lane("cpu", S, R, groups=2)
    for stream in ("uniform", "zipf"):
        assert stats[stream]["read_slots"] == 0 and stats[stream]["probe_windows"] == 2
    assert eng.read_lane_stats()["probe"] == 2 * 2 * 9 * S
    assert kv_window.KV_WINDOW.launches == before  # no kernel on the CPU


def test_pack_costs_cpu():
    _, eng = chip_smoke.device_kv_lane("cpu", S, R)
    costs = chip_smoke.pack_costs(eng._dev, S, reps=1)
    assert costs["fill set"]["D"] == 16  # every op its own row
    assert costs["fill set"]["auto_upload_bytes"] == costs["fill set"]["rows_upload_bytes"] + 16 * S


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,R", [(17, 1), (1000, 3), (4096, 5), (4096, 7)])
def test_kernel_matches_plain_on_card(cuda, S, R):
    g = torch.Generator(device=cuda).manual_seed(S + R)
    T = 33
    votes = torch.randint(0, 4, (R, T, S), generator=g, device=cuda, dtype=torch.int8)
    alive = torch.rand((R, S), generator=g, device=cuda) < 0.7
    q = R // 2 + 1
    want_d, want_p = fused_window.closed_form_window_rmajor(votes, alive, q)
    d, p = fused_window.FUSED_WINDOW(votes, alive, q)
    torch.cuda.synchronize()
    assert torch.equal(d, want_d) and torch.equal(p, want_p)


@pytest.mark.cuda
@pytest.mark.parametrize("S,R,T", [(17, 1, 1), (1000, 3, 16), (4096, 5, 16), (4096, 7, 16), (999, 64, 3)])
@pytest.mark.parametrize("max_phases", [1, 4])
def test_mesh_window_matches_plain_on_card(cuda, S, R, T, max_phases):
    g = torch.Generator(device=cuda).manual_seed(S + R + T)
    votes, alive, base = chip_smoke.mesh_case(g, S, R, T, cuda)
    mk = MeshPhaseKernel(S, R, seed=S, device=cuda)
    want = mk.decide_slots_plain(votes, alive, base, max_phases)
    before = mesh_window.MESH_WINDOW.launches
    got = mk.slot_window(votes, alive, base, n_slots=T, max_phases=max_phases)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and mesh_window.MESH_WINDOW.launches == before + 1


@pytest.mark.cuda
def test_slice_on_card(cuda):
    assert chip_smoke.kernel_vs_plain(cuda) == (0, 0)  # replica-major, [T,S,R]
    assert chip_smoke.mesh_kernel_vs_plain(cuda) == 0
    chip_smoke.protocol_vs_fused(cuda, 256, R, 16)
    before = fused_window.FUSED_WINDOW.launches
    _, _, _, err = chip_smoke.decision_core(cuda, 256, R, 128)
    assert err == 0 and fused_window.FUSED_WINDOW.launches == before + 2
    before = mesh_window.MESH_WINDOW.launches
    chip_smoke.serving_lane(cuda, 64, R)
    assert mesh_window.MESH_WINDOW.launches > before


@pytest.mark.cuda
def test_device_kv_lane_on_card(cuda):
    assert chip_smoke.kv_kernel_vs_plain(cuda) == 0
    assert chip_smoke.decide_kernel_vs_plain(cuda) == 0
    before = kv_window.KV_WINDOW.launches
    stats, _ = chip_smoke.device_kv_lane(cuda, 64, R)
    assert stats["blocks"] == 102 and kv_window.KV_WINDOW.launches > before


@pytest.mark.cuda
def test_device_lane_window_is_one_kv_launch_on_card(cuda):
    """One decide_apply on a card launches the kv-window kernel once (the
    decision folded in) and the mesh-window kernel never; its table and
    flags equal the plain composition's."""
    from rabia_tpu_torch.apps.device_kv import DeviceKVTable
    from rabia_tpu_torch.core.blocks import build_block

    S_, W = 64, 16
    mk = MeshPhaseKernel(S_, R, device=cuda)
    dkv = DeviceKVTable(S_, mk)
    ops = dkv.pack_window([
        build_block(range(S_), [[chip_smoke._set_op(chip_smoke._key(s, j), b"v")] for s in range(S_)])
        for j in range(W)
    ])
    alive, base = np.ones((S_, R), bool), np.zeros(S_, np.int32)
    kv0, mw0 = kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches
    new, flags = dkv.decide_apply(alive, base, W, ops, W=W)
    torch.cuda.synchronize()
    assert kv_window.KV_WINDOW.launches == kv0 + 1 and mesh_window.MESH_WINDOW.launches == mw0
    assert flags.tolist() == [1, 0, 0]
    mk_cpu = MeshPhaseKernel(S_, R, device="cpu")
    cpu = DeviceKVTable(S_, mk_cpu)
    want, want_flags = cpu.decide_apply(alive, base, W, ops, W=W)
    assert want_flags.tolist() == flags.tolist()
    for a, b in zip(want, new):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("S,R", [(17, 1), (1000, 3), (4096, 5), (1000, 8)])
def test_tsr_kernel_matches_plain_on_card(cuda, S, R):
    """The [T, S, R] kernel reads the votes in place (no relayout), also
    from a view one byte into a buffer, and equals the plain closed form."""
    g = torch.Generator(device=cuda).manual_seed(S + R)
    T = 33
    votes = torch.randint(0, 4, (T, S, R), generator=g, device=cuda, dtype=torch.int8)
    alive = torch.rand((S, R), generator=g, device=cuda) < 0.7
    q = R // 2 + 1
    want_d, want_p = fused_window.closed_form_window(votes, alive, q)
    buf = torch.empty(votes.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = buf[1:].view(T, S, R)
    shifted.copy_(votes)
    for v in (votes, shifted):
        before = fused_window.FUSED_WINDOW_TSR.launches
        d, p = fused_window.window(v, alive, q)
        torch.cuda.synchronize()
        assert torch.equal(d, want_d) and torch.equal(p, want_p)
        assert fused_window.FUSED_WINDOW_TSR.launches == before + 1


@pytest.mark.cuda
def test_dict_kernel_and_probe_match_plain_on_card(cuda):
    assert chip_smoke.dict_kernel_vs_plain(cuda) == 0


@pytest.mark.cuda
def test_read_lane_on_card(cuda):
    before = dict(kv_window.KV_WINDOW.counts)
    stats, eng = chip_smoke.device_read_lane(cuda, 64, R, groups=2)
    assert stats["zipf"]["read_slots"] == 0 and eng.read_lane_stats()["probe"] == 2 * 2 * 9 * 64
    assert kv_window.KV_WINDOW.counts["dict"] > before["dict"]
    assert kv_window.KV_WINDOW.counts["dict+decide"] > before["dict+decide"]
