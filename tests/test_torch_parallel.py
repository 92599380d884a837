"""The port's device mesh against the reference's, on the same mesh shapes.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on logical CPU meshes, ``make_mesh(["cpu"] * n, a, b)``: every
block of the port is a tensor of its own, and every exchange over the
replica axis goes through the blocked layout. The cases are those of
``tests/test_parallel.py`` (the factorization, the sharded pipeline
against one device, an indivisible S, the 2 x 4 ``phase_step``
unanimous, mixed and crashed, the windows, crash-mask conformance and the
coin stream's offsets), each also held to the reference's numbers, and
cases that reach the common coin: votes over all four codes, split V0/V1
rows, crash masks with a quorum-less shard, bases near 2^31 - 1 and
several phases, where a block that numbered its shards from 0 would
disagree. Tolerance: exact equality (decisions and states are codes and
counters)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabia_tpu.parallel import MeshPhaseKernel as RefMesh
from rabia_tpu.parallel import ShardedClusterKernel as RefSharded
from rabia_tpu.parallel import make_mesh as ref_make_mesh
from rabia_tpu_torch import convert
from rabia_tpu_torch.core.types import ABSENT, V0, V1, quorum_size
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel
from rabia_tpu_torch.parallel import (
    MeshArray,
    MeshPhaseKernel,
    ShardedClusterKernel,
    make_mesh,
)

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

SHAPES = [(8, 1), (2, 4), (4, 2), (1, 8), (1, 1)]


def _ref_mesh(a, b):
    return ref_make_mesh(jax.devices()[: a * b], shard_axis_size=a, replica_axis_size=b)


def _mesh(a, b):
    return make_mesh(["cpu"] * (a * b), shard_axis_size=a, replica_axis_size=b)


def _split_case(seed: int, S: int, R: int, T: int):
    """Votes over all four codes with a third of the rows split V0/V1 (the
    coin decides them), a crash mask with a dead replica column and shard
    0 without a quorum, and per-shard bases near the int32 wrap."""
    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 4, size=(T, S, R)).astype(np.int8)
    votes[:, 1::3] = rng.integers(0, 2, size=votes[:, 1::3].shape)
    alive = rng.random((S, R)) >= 0.15
    alive[:, -1] = R < 3 or alive[:, -1].all()  # a dead column where R allows one
    alive[0, : quorum_size(R)] = False
    base = rng.integers(0, 1000, size=S).astype(np.int64)
    base[::2] = 2**31 - 1 - rng.integers(0, T, size=base[::2].shape)
    return votes, alive, base.astype(np.int32)


# ---- make_mesh ---------------------------------------------------------------


class TestMakeMesh:
    def test_default_all_on_shard_axis(self):
        m = make_mesh(["cpu"] * 8)
        assert m.shape == {"shard": 8, "replica": 1} == dict(ref_make_mesh().shape)

    def test_two_d(self):
        m = make_mesh(["cpu"] * 8, shard_axis_size=2, replica_axis_size=4)
        ref = ref_make_mesh(shard_axis_size=2, replica_axis_size=4)
        assert m.shape == {"shard": 2, "replica": 4} == dict(ref.shape)
        # device k at (k // b, k % b), as the reference places it
        devs = [torch.device("cpu", k) for k in range(8)]
        m = make_mesh(devs, shard_axis_size=2, replica_axis_size=4)
        assert [m.device_at((i, j)).index for i in range(2) for j in range(4)] == list(range(8))
        assert [[d.id for d in row] for row in ref.devices] == [[0, 1, 2, 3], [4, 5, 6, 7]]

    def test_bad_factorization_rejected(self):
        with pytest.raises(ValueError, match="3x3 != 8 devices"):
            make_mesh(["cpu"] * 8, shard_axis_size=3, replica_axis_size=3)
        with pytest.raises(ValueError, match="3x3 != 8 devices"):
            ref_make_mesh(shard_axis_size=3, replica_axis_size=3)

    def test_default_devices_need_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU: the default devices are usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()

    def test_a_device_named_twice_keeps_blocks_of_its_own(self):
        m = _mesh(2, 4)
        x = np.arange(8 * 8, dtype=np.int32).reshape(8, 8)
        arr = MeshArray.cut(m, x, 0, 1)
        ptrs = {t.data_ptr() for t in arr.blocks.values()}
        assert len(arr.blocks) == 8 and len(ptrs) == 8
        assert np.array_equal(arr.numpy(), x)
        assert arr.blocks[(1, 2)].tolist() == x[4:8, 4:6].tolist()


# ---- ShardedClusterKernel ------------------------------------------------------


class TestShardedClusterKernel:
    def test_pipeline_matches_single_device(self):
        S, R, T = 16, 3, 4
        votes = np.random.RandomState(0).choice([V0, V1], size=(T, S, R)).astype(np.int8)
        plain = ClusterKernel(S, R, seed=11, device="cpu")
        d_plain, p_plain = plain.slot_pipeline(torch.from_numpy(votes),
                                               torch.ones((S, R), dtype=torch.bool), T)
        sharded = ShardedClusterKernel(S, R, _mesh(8, 1), seed=11)
        d_shard, p_shard = sharded.slot_pipeline(sharded.place_votes(votes), np.ones((S, R), bool), T)
        assert torch.equal(d_plain, d_shard.full()) and torch.equal(p_plain, p_shard.full())
        ref = RefSharded(S, R, _ref_mesh(8, 1), seed=11)
        d_ref, p_ref = ref.slot_pipeline(ref.place_votes(jnp.asarray(votes)),
                                         jnp.ones((S, R), bool), T)
        np.testing.assert_array_equal(d_shard.numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(p_shard.numpy(), np.asarray(p_ref))

    def test_state_is_actually_sharded(self):
        k = ShardedClusterKernel(32, 3, _mesh(8, 1))
        st = k.init_state()
        assert len(st.phase.blocks) == 8 and st.phase.shape == (32, 3)
        assert {tuple(t.shape) for t in st.led1.blocks.values()} == {(4, 3, 3)}
        ref = RefSharded(32, 3, _ref_mesh(8, 1)).init_state()
        assert len(ref.phase.sharding.device_set) == 8

    def test_indivisible_shards_rejected(self):
        with pytest.raises(ValueError, match="not divisible by shard axis 8"):
            ShardedClusterKernel(12, 3, _mesh(8, 1))
        with pytest.raises(ValueError, match="not divisible by shard axis 8"):
            RefSharded(12, 3, _ref_mesh(8, 1))

    @pytest.mark.parametrize("a,b", [(8, 1), (4, 2), (2, 4)])
    @pytest.mark.parametrize("rounds", [2, 4])
    def test_pipeline_reaches_the_coin_like_the_reference(self, a, b, rounds):
        """Split votes, a crash mask and 4 rounds a slot: the coin decides
        some slots, keyed by each block's global shard numbers."""
        S, R, T = 16, 5, 6
        votes, alive, _ = _split_case(10 * a + rounds, S, R, T)
        start = 2**31 - 3
        sk = ShardedClusterKernel(S, R, _mesh(a, b), seed=21)
        got = sk.slot_pipeline(votes, alive, T, rounds_per_slot=rounds, start_slot_index=start)
        wide = sk.slot_pipeline_wide(votes, alive, T, rounds, start, block=2)
        one = ClusterKernel(S, R, seed=21, device="cpu").slot_pipeline(
            torch.from_numpy(votes), torch.from_numpy(alive), T, rounds, start)
        ref = RefSharded(S, R, _ref_mesh(a, b), seed=21)
        want = ref.slot_pipeline(ref.place_votes(jnp.asarray(votes)), jnp.asarray(alive), T,
                                 rounds_per_slot=rounds, start_slot_index=start)
        for g, w, o in zip(got, want, one):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert torch.equal(g.full(), o)
        for g, o in zip(wide, one):
            assert torch.equal(g.full(), o)
        if rounds == 4:
            assert (got[1].numpy() == 1).any()  # some slots went through the coin

    @pytest.mark.parametrize("a,b", [(8, 1), (2, 4)])
    def test_fault_path_run_rounds_matches_one_device(self, a, b):
        """start_slot, round_step and lossy run_rounds block by block: the
        same generator seed draws the same masks, so every field equals
        one device's."""
        S, R = 16, 5
        votes, alive, _ = _split_case(3, S, R, 1)
        one = ClusterKernel(S, R, seed=4, device="cpu")
        sk = ShardedClusterKernel(S, R, _mesh(a, b), seed=4)
        every = np.ones(S, bool)
        st1 = one.start_slot(one.init_state(), torch.from_numpy(every), torch.from_numpy(votes[0]))
        st2 = sk.start_slot(sk.init_state(), every, votes[0])
        d = np.random.default_rng(5).random((S, R, R)) < 0.7
        st1 = one.round_step(st1, torch.from_numpy(alive), torch.from_numpy(d))
        st2 = sk.round_step(st2, alive, d)
        st1 = one.run_rounds(st1, torch.from_numpy(alive), 40, torch.Generator().manual_seed(6),
                             p_deliver=0.6)
        st2 = sk.run_rounds(st2, alive, 40, torch.Generator().manual_seed(6), p_deliver=0.6)
        for f1, f2 in zip(st1, st2):
            assert torch.equal(f1, f2.full())
        assert (st1.decided != ABSENT).sum() > S // 2
        assert (st1.decided_phase > 0).any()  # a decision after the first phase

    def test_fused_entries_run_per_block(self):
        S, R, T = 32, 5, 4
        votes, alive, _ = _split_case(8, S, R, T)
        one = ClusterKernel(S, R, device="cpu")
        sk = ShardedClusterKernel(S, R, _mesh(2, 4))
        want = one.slot_pipeline_fused(torch.from_numpy(votes), torch.from_numpy(alive), T)
        for g, w in zip(sk.slot_pipeline_fused(votes, alive, T), want):
            assert torch.equal(g.full(), w)
        vrm = np.ascontiguousarray(votes.transpose(2, 0, 1))
        arm = np.ascontiguousarray(alive.T)
        want = one.slot_pipeline_fused_rmajor(torch.from_numpy(vrm), torch.from_numpy(arm), T)
        for g, w in zip(sk.slot_pipeline_fused_rmajor(vrm, arm, T), want):
            assert torch.equal(g.full(), w)
        assert torch.equal(sk.slot_pipeline_fused_rmajor(vrm, arm, T, want_phase=False).full(),
                           want[0])
        from rabia_tpu_torch.kernel import packed_window

        packed = packed_window.pack_codes(torch.from_numpy(vrm))
        palive = packed_window.pack_alive(torch.from_numpy(arm))
        want = one.slot_pipeline_fused_packed(packed, palive, T)
        assert torch.equal(sk.slot_pipeline_fused_packed(packed, palive, T).full(), want)


# ---- MeshPhaseKernel.phase_step --------------------------------------------------


def _both(S, R, a, b, seed, **kw):
    return MeshPhaseKernel(S, R, _mesh(a, b), seed=seed, **kw), RefMesh(
        S, R, _ref_mesh(a, b), seed=seed, **kw)


def _state_np(st):
    return [np.asarray(f) if not isinstance(f, MeshArray) else f.numpy() for f in st]


class TestMeshPhaseKernel:
    def test_unanimous_v1_decides_first_phase(self):
        S, R = 16, 4
        k, ref = _both(S, R, 2, 4, 5)
        st = k.init_state(np.full((S, R), V1, np.int8))
        st = k.phase_step(st, k.place(np.ones((S, R), bool)), k.shard_index_array())
        assert np.all(st.decided.numpy() == V1)
        rst = ref.init_state(jnp.full((S, R), V1, jnp.int8))
        rst = ref.phase_step(rst, ref.place(jnp.ones((S, R), bool)), ref.shard_index_array())
        for g, w in zip(_state_np(st), _state_np(rst)):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("a,b", [(2, 4), (4, 2), (1, 8), (8, 1)])
    def test_mixed_votes_terminate_and_agree(self, a, b):
        S, R = 8, 8 if b == 8 else 4
        k, ref = _both(S, R, a, b, 7)
        votes = np.random.RandomState(3).choice([V0, V1], size=(S, R)).astype(np.int8)
        st, rst = k.init_state(votes), ref.init_state(jnp.asarray(votes))
        alive, ralive = k.place(np.ones((S, R), bool)), ref.place(jnp.ones((S, R), bool))
        idx, ridx = k.shard_index_array(), ref.shard_index_array()
        for _ in range(12):
            st, rst = k.phase_step(st, alive, idx), ref.phase_step(rst, ralive, ridx)
            for g, w in zip(_state_np(st), _state_np(rst)):
                np.testing.assert_array_equal(g, w)
        dec = st.decided.numpy()
        assert np.all(dec != ABSENT) and np.all(dec == dec[:, :1])

    def test_conformance_with_cluster_kernel(self):
        S, R, T, seed = 8, 4, 3, 23
        votes = np.random.RandomState(9).choice([V0, V1], size=(T, S, R)).astype(np.int8)
        d_plain, _ = ClusterKernel(S, R, seed=seed, device="cpu").slot_pipeline(
            torch.from_numpy(votes), torch.ones((S, R), dtype=torch.bool), T, rounds_per_slot=16)
        k = MeshPhaseKernel(S, R, _mesh(2, 4), seed=seed)
        alive, idx = k.place(np.ones((S, R), bool)), k.shard_index_array()
        decisions = []
        for t in range(T):
            st = k.init_state(votes[t])._replace(slot=k.place(np.full((S, R), t, np.int32)))
            for _ in range(16):
                st = k.phase_step(st, alive, idx)
            dec = st.decided.numpy()
            assert np.all(dec == dec[:, :1])
            decisions.append(dec[:, 0])
        np.testing.assert_array_equal(d_plain.numpy(), np.stack(decisions))

    def test_minority_crash_still_decides(self):
        S, R = 8, 4
        k, ref = _both(S, R, 2, 4, 1)
        alive = np.ones((S, R), bool)
        alive[:, 0] = False
        st, rst = k.init_state(np.full((S, R), V1, np.int8)), ref.init_state(
            jnp.full((S, R), V1, jnp.int8))
        for _ in range(8):
            st = k.phase_step(st, k.place(alive), k.shard_index_array())
            rst = ref.phase_step(rst, ref.place(jnp.asarray(alive)), ref.shard_index_array())
        assert np.all(st.decided.numpy()[:, 1:] == V1)
        for g, w in zip(_state_np(st), _state_np(rst)):
            np.testing.assert_array_equal(g, w)

    def test_split_votes_and_crashes_reach_the_coin_like_the_reference(self):
        S, R = 16, 4
        votes, alive, base = _split_case(12, S, R, 1)
        k, ref = _both(S, R, 2, 4, 9, coin_p1=0.5)
        st = k.init_state(votes[0])._replace(slot=k.place(np.broadcast_to(base[:, None], (S, R))))
        rst = ref.init_state(jnp.asarray(votes[0]))._replace(
            slot=ref.place(jnp.broadcast_to(jnp.asarray(base)[:, None], (S, R))))
        for _ in range(6):
            st = k.phase_step(st, k.place(alive), k.shard_index_array())
            rst = ref.phase_step(rst, ref.place(jnp.asarray(alive)), ref.shard_index_array())
        for g, w in zip(_state_np(st), _state_np(rst)):
            np.testing.assert_array_equal(g, w)
        assert (st.phase.numpy() > 1).any()  # some rows went through the coin

    def test_shard_index_array_holds_global_ids(self):
        k = MeshPhaseKernel(8, 4, _mesh(2, 4))
        idx = k.shard_index_array()
        assert idx.blocks[(1, 3)].tolist() == [[4], [5], [6], [7]]
        np.testing.assert_array_equal(idx.numpy(), np.asarray(
            RefMesh(8, 4, _ref_mesh(2, 4)).shard_index_array()))

    def test_indivisible_axes_rejected(self):
        with pytest.raises(ValueError, match="n_shards not divisible by shard axis"):
            MeshPhaseKernel(7, 4, _mesh(2, 4))
        with pytest.raises(ValueError, match="n_replicas not divisible by replica axis"):
            MeshPhaseKernel(8, 5, _mesh(2, 4))
        with pytest.raises(ValueError, match="n_replicas not divisible by replica axis"):
            RefMesh(8, 5, _ref_mesh(2, 4))
        with pytest.raises(ValueError, match="not both"):
            MeshPhaseKernel(8, 4, _mesh(2, 4), device="cpu")

    def test_mesh_state_converts_both_ways(self):
        S, R = 8, 4
        m = _mesh(2, 4)
        rng = np.random.default_rng(1)
        fields = {"slot": rng.integers(0, 9, (S, R)), "phase": rng.integers(0, 3, (S, R)),
                  "my_r1": rng.integers(0, 4, (S, R)), "decided": rng.integers(0, 4, (S, R))}
        st = convert.mesh_state_to_blocks(fields, m)
        assert st.my_r1.blocks[(1, 2)].dtype == torch.int8 and len(st.slot.blocks) == 8
        back = convert.mesh_state_from_blocks(st)
        for name, arr in fields.items():
            np.testing.assert_array_equal(back[name], arr)


# ---- the windows ------------------------------------------------------------------


class TestMeshSlotPipeline:
    def test_window_matches_cluster_kernel(self):
        S, R, T = 16, 4, 6
        mk, ref = _both(S, R, 2, 4, 5)
        votes = np.random.default_rng(0).choice(np.array([0, 1], np.int8), size=(T, S, R))
        decided = mk.slot_pipeline(votes, mk.place(np.ones((S, R), bool)), T, max_phases=6)
        want = ref.slot_pipeline(jnp.asarray(votes), ref.place(jnp.ones((S, R), bool)), T,
                                 max_phases=6)
        np.testing.assert_array_equal(decided.numpy(), np.asarray(want))
        assert (decided != ABSENT).all()
        ck, _ = ClusterKernel(S, R, seed=5, device="cpu").slot_pipeline(
            torch.from_numpy(votes), torch.ones((S, R), dtype=torch.bool), T, rounds_per_slot=12)
        unanimous = (votes == votes[..., :1]).all(-1)
        assert torch.equal(decided[torch.from_numpy(unanimous)], ck[torch.from_numpy(unanimous)])

    def test_window_with_crashed_minority(self):
        S, R, T = 8, 4, 3
        mk = MeshPhaseKernel(S, R, _mesh(2, 4), seed=1)
        alive = np.broadcast_to(np.array([True, True, True, False]), (S, R))
        decided = mk.slot_pipeline(np.ones((T, S, R), np.int8), mk.place(alive), T, max_phases=4)
        assert (decided == 1).all()

    def test_slot_window_matches_slot_pipeline_uniform_base(self):
        S, R, T = 8, 4, 5
        mk = MeshPhaseKernel(S, R, _mesh(2, 4), seed=9)
        votes = np.random.RandomState(4).choice([V0, V1], size=(T, S, R)).astype(np.int8)
        alive = mk.place(np.ones((S, R), bool))
        d_pipe = mk.slot_pipeline(votes, alive, T, max_phases=8, start_slot_index=7)
        d_win = mk.slot_window(votes, alive, np.full(S, 7, np.int32), n_slots=T, max_phases=8)
        assert torch.equal(d_pipe, d_win)

    def test_crash_mask_conformance_with_cluster_kernel(self):
        S, R, T, seed = 8, 4, 4, 31
        rng = np.random.RandomState(8)
        votes = rng.choice([V0, V1], size=(T, S, R)).astype(np.int8)
        alive = np.ones((S, R), bool)
        for s in range(S):
            alive[s, rng.randint(R)] = False
        d_plain, _ = ClusterKernel(S, R, seed=seed, device="cpu").slot_pipeline(
            torch.from_numpy(votes), torch.from_numpy(alive), T, rounds_per_slot=16)
        mk, ref = _both(S, R, 2, 4, seed)
        d_mesh = mk.slot_pipeline(votes, mk.place(alive), T, max_phases=16)
        assert (d_mesh != ABSENT).all() and torch.equal(d_plain, d_mesh)
        np.testing.assert_array_equal(d_mesh.numpy(), np.asarray(ref.slot_pipeline(
            jnp.asarray(votes), ref.place(jnp.asarray(alive)), T, max_phases=16)))

    def test_lossy_cluster_agrees_with_mesh_on_unanimous_slots(self):
        S, R, T, seed = 8, 4, 4, 13
        rng = np.random.RandomState(5)
        votes = rng.choice([V0, V1], size=(T, S, R)).astype(np.int8)
        votes[:, ::2, :] = V1
        unanimous = np.zeros((T, S), bool)
        unanimous[:, ::2] = True
        mk, ref = _both(S, R, 2, 4, seed)
        d_mesh = mk.slot_pipeline(votes, mk.place(np.ones((S, R), bool)), T, max_phases=12)
        np.testing.assert_array_equal(d_mesh.numpy(), np.asarray(ref.slot_pipeline(
            jnp.asarray(votes), ref.place(jnp.ones((S, R), bool)), T, max_phases=12)))
        ck = ClusterKernel(S, R, seed=seed, device="cpu")
        alive = torch.ones((S, R), dtype=torch.bool)
        every = torch.ones(S, dtype=torch.bool)
        st = ck.init_state()
        lossy = []
        for t in range(T):
            st = ck.start_slot(st, every, torch.from_numpy(votes[t]))
            st = st._replace(slot=torch.full((S,), t, dtype=torch.int32))
            st = ck.run_rounds(st, alive, 60, torch.Generator().manual_seed(100 + t),
                               p_deliver=0.7)
            assert (st.decided != ABSENT).all(), "lossy run failed to terminate"
            lossy.append(st.decided.numpy())
        d_lossy = np.stack(lossy)
        np.testing.assert_array_equal(d_lossy[unanimous], d_mesh.numpy()[unanimous])
        assert (d_lossy[unanimous] == V1).all()

    def test_window_offsets_change_coin_stream(self):
        S, R, T = 8, 4, 8
        mk, ref = _both(S, R, 2, 4, 3)
        votes = np.zeros((T, S, R), np.int8)
        votes[:, :, :2] = 1  # 2-2 split: every decision goes through the coin
        alive = mk.place(np.ones((S, R), bool))
        d0 = mk.slot_pipeline(votes, alive, T, max_phases=8)
        d1 = mk.slot_pipeline(votes, alive, T, max_phases=8, start_slot_index=16)
        assert (d0 != 3).all() and (d1 != 3).all()
        assert (d0 != d1).any(), "windows drew identical coin streams"
        ralive = ref.place(jnp.ones((S, R), bool))
        for got, start in ((d0, 0), (d1, 16)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref.slot_pipeline(
                jnp.asarray(votes), ralive, T, max_phases=8, start_slot_index=start)))

    @pytest.mark.parametrize("p1", [0.0, 0.5, 1.0])
    @pytest.mark.parametrize("a,b", SHAPES)
    def test_slot_window_reaches_the_coin_like_the_reference(self, a, b, p1):
        """Votes over all four codes, split rows, crash masks with a
        quorum-less shard, bases near 2^31 - 1 and 4 phases, on every mesh
        shape of the 8 devices: the reference's slot_window, the port's on
        the same shape and the port's one-device plain loop agree."""
        R = 8 if b == 8 else 4
        S, T = 16, 6
        votes, alive, base = _split_case(a * 10 + b + int(2 * p1), S, R, T)
        mk, ref = _both(S, R, a, b, 40 + a, coin_p1=p1)
        got = mk.slot_window(votes, alive, base, n_slots=T, max_phases=4)
        want = ref.slot_window(jnp.asarray(votes), ref.place(jnp.asarray(alive)),
                               jnp.asarray(base), n_slots=T, max_phases=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        one = MeshPhaseKernel(S, R, seed=40 + a, coin_p1=p1, device="cpu")
        assert torch.equal(got, one.decide_slots_plain(
            torch.from_numpy(votes), torch.from_numpy(alive), torch.from_numpy(base), 4))
        assert (got[:, 0] == ABSENT).all()  # the quorum-less shard never decides
        if p1 == 0.5:
            assert {0, 1} <= set(got.unique().tolist())

    def test_exchange_leaves_the_blocked_layout(self):
        """One exchange gives each shard row its replica blocks in order:
        block jj of row i is position (i, jj)'s votes and alive rows."""
        S, R, T = 8, 4, 3
        votes, alive, _ = _split_case(2, S, R, T)
        mk = MeshPhaseKernel(S, R, _mesh(2, 4))
        rows = mk.exchange_window(votes, alive)
        assert sorted(rows) == [0, 1]
        v, al = rows[1]
        assert tuple(v.shape) == (4, T, 4, 1) and tuple(al.shape) == (4, 4, 1)
        for jj in range(4):
            np.testing.assert_array_equal(v[jj].numpy(), votes[:, 4:8, jj:jj + 1])
            np.testing.assert_array_equal(al[jj].numpy(), alive[4:8, jj:jj + 1])
