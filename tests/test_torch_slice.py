"""The whole slice at a small size on the CPU: the twin of chip_smoke.py's
phases 3-5, 7, 8 and 18 (protocol vs fused entry, the decision core checked
against both plain windows, the scanned protocol against the fused entry,
the selftest's fault path, the packed window at depth against the V1
row, the MeshEngine serving lane, the
device-resident KV lane beside the host block lane, the read lane beside
the device lane without it and the host block lane, and phase 18's
tables and lanes over logical meshes), run by the same code with
device="cpu" at S=16, R=5 (phase 18 at 64 shards). The same phases on the card are the
cuda-marked tests at the end."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from rabia_tpu_torch.core.types import ABSENT, V0, V1
from rabia_tpu_torch.kernel import cluster_round, fused_window, kv_window, mesh_window, packed_window
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel
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


def test_scan_fault_path_and_deep_packed_window_cpu():
    before = (dict(cluster_round.CLUSTER_ROUND.counts), packed_window.PACKED_WINDOW.launches)
    assert chip_smoke.scan_vs_fused("cpu", S, R, 16)[3] == 0
    k, st0, alive, err = chip_smoke.fault_path("cpu", S)
    assert err == 0 and bool(st0.active.all()) and alive.shape == (S, R)
    _, bufs, alive_p, row, err = chip_smoke.packed_deep("cpu", S, R, 64)
    assert err == 0 and len(bufs) == 2 and row.shape == (1,)
    assert (dict(cluster_round.CLUSTER_ROUND.counts), packed_window.PACKED_WINDOW.launches) == before


def test_operation_counts_follow_the_shapes():
    # the full-delivery rule: nothing below 2 rounds, the counts from 2,
    # and from 4 the coin of each entry that takes it
    assert chip_smoke.pipeline_ops(S, R, 3) == 3 * S * (6 * R + 8)
    assert chip_smoke.pipeline_ops(S, R, 3, rounds=1) == 0
    assert chip_smoke.pipeline_ops(S, R, 3, 3, coins=5) == 3 * S * (6 * R + 8)
    assert chip_smoke.pipeline_ops(S, R, 3, 4, coins=5) == 3 * S * (6 * R + 8) + 5 * 21
    # R=5: 15 for the planes, two trees of 2 full adders, two 3-plane compares, 3 for the codes
    assert chip_smoke.packed_ops(5, 4, 2) == 4 * 2 * (15 + 8 + 6 + 3)
    assert [chip_smoke.packed_ops(r, 1, 1) for r in (1, 3, 7)] == [8, 20, 46]


def test_serving_lane_cpu():
    before = fused_window.FUSED_WINDOW.launches
    lane = chip_smoke.serving_lane("cpu", S, R, window=16)
    assert lane["first_flush_cycles"] == 1  # SET+GET per shard fit one window
    assert lane["throughput_applied"] == 4 * S
    assert fused_window.FUSED_WINDOW.launches == before  # no kernel on the CPU


def test_device_kv_lane_cpu():
    before = kv_window.KV_WINDOW.launches
    stats, eng = chip_smoke.device_kv_lane("cpu", S, R)
    assert stats["blocks"] == 86 and stats["entries"] > 0
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


def test_phase18_mesh_tables_cpu():
    """Phase 18 (a) at 64 shards on logical CPU meshes 4x1, 1x5 and 4x5:
    every table in shard blocks equals the one-device table (the function
    checks flags, reads, gathered rows and dumps, one upload a block)."""
    before = kv_window.KV_WINDOW.launches
    out = chip_smoke.mesh_tables_vs_one_device("cpu", 64, R)
    assert {k: v["shard_blocks"] for k, v in out.items() if "x" in k} == \
        {"4x1": 4, "1x5": 1, "4x5": 4}
    assert out["tables"]["4x1"].mesh is not None and out["tables"]["1x5"].mesh is None
    assert kv_window.KV_WINDOW.launches == before  # no kernel on the CPU


def test_phase18_lanes_replayed_on_a_mesh_cpu():
    """Phase 18 (b) at 64 shards: phase 7's device-lane stream and phase
    8's read-lane stream replayed on a 4x1 CPU mesh engine against the
    records of their one-device runs (the host lane runs once)."""
    from rabia_tpu_torch.parallel import make_mesh

    stats7, _ = chip_smoke.device_kv_lane("cpu", 64, R)
    stats8, _ = chip_smoke.device_read_lane("cpu", 64, R, groups=2)
    mesh = make_mesh(["cpu"] * 4, 4, 1)
    got7, eng7 = chip_smoke.device_kv_lane("cpu", 64, R, mesh=mesh, want=stats7["_record"])
    got8, eng8 = chip_smoke.device_read_lane("cpu", 64, R, groups=2, mesh=mesh,
                                             want=stats8["_record"])
    assert eng7._dev.mesh is mesh and eng8._dev.mesh is mesh
    assert got7["blocks"] == stats7["blocks"] == 86
    assert got7["repromoted_after_waves"] == stats7["repromoted_after_waves"]
    for stream in ("uniform", "zipf"):
        assert got8[stream]["read_slots"] == 0
        assert got8[stream]["probe_windows"] == stats8[stream]["probe_windows"]


def test_pack_costs_cpu():
    _, eng = chip_smoke.device_kv_lane("cpu", S, R)
    costs = chip_smoke.pack_costs(eng._dev, S, reps=1)
    assert costs["fill set"]["D"] == 16  # every op its own row
    assert costs["fill set"]["auto_upload_bytes"] == costs["fill set"]["rows_upload_bytes"] + 16 * S


def test_window_ladder_cpu():
    _, eng = chip_smoke.device_kv_lane("cpu", S, R)
    before = (kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches)
    ladder, err = chip_smoke.window_ladder(eng._dev, eng._dev.kernel, S, R,
                                           chip_smoke.ladder_blocks(S))
    assert err == 0 and sorted(ladder) == [1, 2, 4, 8, 16, 32, 64, 128, 256]
    assert eng._dev.pack_stats["numpy"] == 0  # every ladder window went through the C gather
    assert (kv_window.KV_WINDOW.launches, mesh_window.MESH_WINDOW.launches) == before


def test_governed_lane_and_pack_gathers_cpu():
    stats, engines = chip_smoke.governed_lane("cpu", S, R, groups=2)
    assert stats["loose"]["resizes"] >= 1 and stats["loose"]["inflight"] == 1
    assert stats["tight"]["window"] == 1 and stats["tight"]["unachievable"] is True
    assert stats["tight"]["walk"] == [16, 8, 4, 2, 1]
    assert any(ln.startswith("rabia_mesh_window_resizes_total") for ln in stats["prometheus"])
    assert all(e._dev.pack_stats["numpy"] == 0 < e._dev.pack_stats["native"] for e in engines)
    rates = chip_smoke.lane_native_vs_numpy("cpu", S, R)
    assert [len(v) for v in rates.values()] == [2, 2]
    costs = chip_smoke.pack_native_vs_numpy(engines[0]._dev, S, (16, 32), reps=1)
    assert sorted(costs) == [16, 32] and len(costs[32]["native rows host ms"]) == 2


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
@pytest.mark.parametrize("S,R,T", [(17, 1, 1), (1000, 3, 16), (4096, 5, 16), (999, 64, 3),
                                   (300, 5, 33)])
def test_mapped_window_matches_plain_on_card(cuda, S, R, T):
    """mw_window on a pinned staging buffer (mapped, the engine's window)
    against the plain loop, one launch a window."""
    g = torch.Generator().manual_seed(S + R + T)
    votes, alive, base = chip_smoke.mesh_case(g, S, R, T, "cpu")
    mk = MeshPhaseKernel(S, R, seed=S, device=cuda)
    stage = mesh_window.WindowStage(S, R, T, pinned=True)
    stage.votes[...], stage.alive[...], stage.base[...] = votes.numpy(), alive.numpy(), base.numpy()
    before = mesh_window.MESH_WINDOW.launches
    mk.decide_staged(stage, T, 4)
    stage.wait()
    want = mk.decide_slots_plain(votes.to(cuda), alive.to(cuda), base.to(cuda), 4)
    assert np.array_equal(stage.decided[:T], want.cpu().numpy())
    assert mesh_window.MESH_WINDOW.launches == before + 1


@pytest.mark.cuda
def test_start_slot_and_packers_on_card(cuda):
    """Phase 16 (c)'s checks on the card: start_slot (masks none, all and
    random; ragged S; R up to 9; in place; one byte in; 20 blocks in two
    launches) and the packers with pack_inputs against plain."""
    assert chip_smoke.start_slot_vs_plain(cuda, Rs=(1, 9), Ss=(17, 1000)) == 0
    assert chip_smoke.packers_vs_plain(cuda, Rs=(5,), Ss=(17, 4095)) == 0


@pytest.mark.cuda
def test_launch_floor_on_card(cuda):
    """The node kernel on mapped planes and image against plain (host
    arrays, its own plane views, start_slots + node_steps), and a tick's
    and a window's timing functions (one launch each, no copy)."""
    err, cases = chip_smoke.node_kernel_vs_plain(cuda, Rs=(1, 5, 70), Ss=(17, 1000), Ks=(0, 3))
    assert err == 0 and cases == 12
    name = torch.cuda.get_device_name(0)
    tick = chip_smoke.node_tick_times(cuda, name, 1000, 5, 3, reps=10)
    assert tick["trace"]["copies"] == 0 and tick["trace"]["launches"] == tick["trace"]["calls"]
    win = chip_smoke.window_times(cuda, name, 1000, 5, 16, reps=10)
    assert win["max_abs_err"] == 0
    assert win["trace"]["copies"] == 0 and win["trace"]["launches"] == win["trace"]["calls"]


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
def test_packed_and_round_kernels_on_card(cuda):
    assert chip_smoke.packed_kernel_vs_plain(cuda) == 0
    assert chip_smoke.round_kernel_vs_plain(cuda) == 0
    assert chip_smoke.pipeline_every_r(cuda) == 0
    chip_smoke.round_kernel_vs_oracle(cuda)
    before = dict(cluster_round.CLUSTER_ROUND.counts)
    assert chip_smoke.scan_vs_fused(cuda, 256, R, 64)[3] == 0
    assert chip_smoke.fault_path(cuda, 256)[3] == 0
    assert cluster_round.CLUSTER_ROUND.counts["slot_pipeline"] == before["slot_pipeline"] + 2
    assert cluster_round.CLUSTER_ROUND.counts["rounds"] == before["rounds"] + 1
    before = packed_window.PACKED_WINDOW.launches
    assert chip_smoke.packed_deep(cuda, 256, R, 1024)[4] == 0
    assert packed_window.PACKED_WINDOW.launches == before + 2


@pytest.mark.cuda
def test_device_kv_lane_on_card(cuda):
    assert chip_smoke.kv_kernel_vs_plain(cuda) == 0
    assert chip_smoke.decide_kernel_vs_plain(cuda) == 0
    before = kv_window.KV_WINDOW.launches
    stats, _ = chip_smoke.device_kv_lane(cuda, 64, R)
    assert stats["blocks"] == 86 and kv_window.KV_WINDOW.launches > before


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
    assert kv_window.KV_WINDOW.counts["probe dict"] > before["probe dict"]
    assert kv_window.KV_WINDOW.counts["dict+decide"] > before["dict+decide"]


@pytest.mark.cuda
@pytest.mark.parametrize("S,R", [(17, 1), (1000, 3), (4096, 5), (1000, 8), (300, 13)])
def test_packed_window_kernel_matches_plain_on_card(cuda, S, R):
    """The kernel equals the plain version at every quorum, also on a
    view that starts one word into a buffer (the unvectorised path)."""
    g = torch.Generator(device=cuda).manual_seed(S + R)
    T = 33
    votes = torch.randint(0, 4, (R, T, S), generator=g, device=cuda, dtype=torch.int8)
    alive = torch.rand((R, S), generator=g, device=cuda) < 0.7
    packed, alive_p = packed_window.pack_codes(votes), packed_window.pack_alive(alive)
    buf = torch.empty(packed.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = buf[1:].view(packed.shape)
    shifted.copy_(packed)
    for q in range(0, R + 2):
        want = packed_window.packed_window_rmajor(packed, alive_p, q)
        for p in (packed, shifted):
            before = packed_window.PACKED_WINDOW.launches
            got = packed_window.window(p, alive_p, q)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and packed_window.PACKED_WINDOW.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("S,R", [(17, 1), (1000, 5), (4096, 5), (300, 8), (100, 64)])
def test_round_kernels_match_plain_on_card(cuda, S, R):
    """round_step, run_rounds (p 0.6, a static partition) and
    slot_pipeline on a card, each one launch, equal the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(S + R)
    k = ClusterKernel(S, R, seed=S, device=cuda)
    votes = torch.randint(0, 2, (8, S, R), generator=g, device=cuda, dtype=torch.int8)
    alive = torch.rand((S, R), generator=g, device=cuda) > 0.2
    st = k.start_slot(k.init_state(), torch.ones(S, dtype=torch.bool, device=cuda), votes[0])
    K = cluster_round.CLUSTER_ROUND
    before = K.launches
    full = torch.ones((S, R, R), dtype=torch.bool, device=cuda)
    got, want = k.round_step(st, alive, full), k.round_step_plain(st, alive, full)
    side = torch.arange(R, device=cuda) < max(1, R // 3)
    part = side[:, None] == side[None, :]
    gens = [torch.Generator(device=cuda).manual_seed(7) for _ in range(2)]
    got2 = k.run_rounds(got, alive, 9, gens[0], p_deliver=0.6, link_mask=part)
    want2 = k.run_rounds_plain(want, alive, 9, gens[1], p_deliver=0.6, link_mask=part)
    d, ph = k.slot_pipeline(votes, alive, 8, rounds_per_slot=2, start_slot_index=2**31 - 4)
    wd, wp = k.slot_pipeline_plain(votes, alive, 8, rounds_per_slot=2, start_slot_index=2**31 - 4)
    torch.cuda.synchronize()
    assert K.launches == before + 3
    for a, b in zip(list(got) + list(got2) + [d, ph], list(want) + list(want2) + [wd, wp]):
        assert torch.equal(a, b)


def test_sharded_cluster_cpu():
    """Phase 17 (c) at S=16 on a logical 4 x 1 CPU mesh (and 1024 x 9)."""
    r = chip_smoke.sharded_cluster(torch.device("cpu"), S, R, T=16)
    assert r["max_abs_err"] == 0 and r["blocks"] == 4 and r["coin_slots"] > 0


@pytest.mark.cuda
def test_mesh_on_card(cuda):
    """Phase 17 (a)-(c) on the card: logical meshes of it against the
    one-device kernel and plain, the 1x1 and 4x5 engines against the
    one-device engine, ShardedClusterKernel against ClusterKernel."""
    assert chip_smoke.mesh_windows_vs_one_device(cuda, 4096, 5)["max_abs_err"] == 0
    assert chip_smoke.sharded_cluster(cuda, 4096, 5)["max_abs_err"] == 0
    chip_smoke.mesh_engines(cuda)
