"""The port's one-device MeshPhaseKernel against the reference's
MeshPhaseKernel on its default test mesh (8 virtual CPU devices on the
shard axis). Split initial votes force the common coin; crash masks and
per-shard slot bases are included. Also ``ShardedClusterKernel.start_slot``
as the card runs it: its shard blocks, one table a device, through the
g++ build of the kernel (``start_slot_host``), against the reference's
``ShardedClusterKernel`` on logical CPU meshes 4x1, 2x4 and a padded
4x2. Tolerance: exact equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import start_slot_host

from rabia_tpu.kernel.phase_driver import ClusterKernel as RefKernel
from rabia_tpu.kernel.phase_driver import ClusterState as RefState
from rabia_tpu.parallel import MeshPhaseKernel as RefMesh
from rabia_tpu.parallel import ShardedClusterKernel as RefSharded
from rabia_tpu.parallel import make_mesh
from rabia_tpu_torch import convert
from rabia_tpu_torch.core.types import ABSENT
from rabia_tpu_torch.kernel import cluster_round
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel, ClusterState
from rabia_tpu_torch.parallel import MeshPhaseKernel, ShardedClusterKernel
from rabia_tpu_torch.parallel import make_mesh as port_make_mesh

torch.set_num_threads(1)  # tiny tensors: one thread keeps parallel test workers off each other

S, R = 16, 5


def _kernels(seed):
    return RefMesh(S, R, make_mesh(), seed=seed), MeshPhaseKernel(S, R, seed=seed, device="cpu")


def _inputs(seed, T):
    rng = np.random.default_rng(seed)
    votes = rng.choice([0, 1], size=(T, S, R)).astype(np.int8)  # split: the coin decides
    alive = np.ones((S, R), bool)
    alive[:, 4] = False
    alive[rng.random(S) < 0.3, 3] = False  # some shards lose a second replica
    alive[0, :3] = False  # shard 0 has lost its quorum
    return votes, alive


@pytest.mark.parametrize("seed", [0, 1])
def test_phase_step_matches_reference_every_field(seed):
    votes, alive = _inputs(seed, 1)
    ref, port = _kernels(seed)
    rs = ref.init_state(jnp.asarray(votes[0]))
    rs = rs._replace(slot=ref.place(jnp.full((S, R), 5 + seed, jnp.int32)))
    ps = convert.mesh_state_from_numpy(
        {f: np.asarray(getattr(rs, f)) for f in rs._fields}, "cpu"
    )
    ralive, rshard = ref.place(jnp.asarray(alive)), ref.shard_index_array()
    palive, pshard = torch.from_numpy(alive), port.shard_index_array()
    for step in range(5):
        rs = ref.phase_step(rs, ralive, rshard)
        ps = port.phase_step(ps, palive, pshard)
        got = convert.mesh_state_to_numpy(ps)
        for f in rs._fields:
            np.testing.assert_array_equal(
                got[f], np.asarray(getattr(rs, f)), err_msg=f"step {step} field {f}"
            )
    init = port.init_state(torch.from_numpy(votes[0]))
    assert init.my_r1.dtype == torch.int8 and torch.all(init.decided == ABSENT)


@pytest.mark.parametrize("max_phases", [1, 4])
def test_slot_pipeline_matches_reference(max_phases):
    T = 6
    votes, alive = _inputs(7 + max_phases, T)
    ref, port = _kernels(3)
    want = ref.slot_pipeline(
        jnp.asarray(votes), ref.place(jnp.asarray(alive)), T,
        max_phases=max_phases, start_slot_index=11,
    )
    got = port.slot_pipeline(
        torch.from_numpy(votes), torch.from_numpy(alive), T,
        max_phases=max_phases, start_slot_index=11,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_window_matches_reference_per_shard_bases(seed):
    T = 5
    votes, alive = _inputs(20 + seed, T)
    base = np.random.default_rng(seed).integers(0, 1000, size=S).astype(np.int32)
    ref, port = _kernels(seed)
    want = np.asarray(ref.slot_window(
        jnp.asarray(votes), ref.place(jnp.asarray(alive)), jnp.asarray(base),
        n_slots=T, max_phases=4,
    ))
    got = port.slot_window(
        torch.from_numpy(votes), torch.from_numpy(alive), torch.from_numpy(base),
        n_slots=T, max_phases=4,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] == ABSENT).all()  # the quorum-less shard never decides
    assert set(np.unique(want[:, 1:])) <= {0, 1, ABSENT}
    with pytest.raises(ValueError, match="initial_votes"):
        port.slot_window(
            torch.from_numpy(votes), torch.from_numpy(alive), torch.from_numpy(base),
            n_slots=T + 1,
        )


# ---- ShardedClusterKernel.start_slot: one table (one launch) a device -------

FIELDS = [name for name, _, _ in cluster_round.FIELDS]


@pytest.fixture(scope="module")
def start_host(tmp_path_factory):
    return start_slot_host.build(tmp_path_factory, "ss_mesh_host")


def _blocks_on_the_host(host, sk, state, mask, votes):
    """``sk.start_slot`` as a card runs it: each device's shard blocks in
    one table, run by the kernel's host build; returns the state and the
    launches a device."""
    rows, launches = {}, {}
    for dev, blocks in sk.start_slot_blocks(state, mask, votes).items():
        outs, launches[str(dev)] = host.run([b[1:] for b in blocks])
        rows.update((b[0], o) for b, o in zip(blocks, outs))
    return sk._state_out(rows), launches


@pytest.mark.parametrize("a,b,S,real", [(4, 1, 64, 64), (2, 4, 40, 40), (4, 2, 8, 6)])
def test_sharded_start_slot_table_matches_reference(start_host, a, b, S, real):
    """The shard blocks of a logical CPU mesh, all on one device, go in
    one table (one launch); the state equals the reference's
    ``ShardedClusterKernel.start_slot`` on its virtual devices and the
    port's plain blocks. The padded case holds 6 shards in 8 (2 a block
    on 4 x 2): the pad shards are never masked and keep their state, the
    real ones equal the reference's ``ClusterKernel`` on 6 shards."""
    Rr = 5
    rng = np.random.default_rng(10 * a + b)
    fields = start_slot_host.random_state_fields(rng, S, Rr)
    mask = rng.random(S) < 0.5
    mask[real:] = False
    votes = rng.integers(0, 4, (S, Rr)).astype(np.int8)
    sk = ShardedClusterKernel(S, Rr, port_make_mesh(["cpu"] * (a * b), a, b))
    st = ClusterState(*(torch.from_numpy(fields[f].copy()) for f in FIELDS))
    got, launches = _blocks_on_the_host(start_host, sk, st, torch.from_numpy(mask),
                                        torch.from_numpy(votes))
    assert launches == {"cpu": 1}
    plain = sk.start_slot(st, mask, votes)
    if real == S:
        ref = RefSharded(S, Rr, make_mesh(jax.devices()[: a * b], shard_axis_size=a,
                                          replica_axis_size=b))
        rst = ref.start_slot(RefState(**{f: jnp.asarray(v) for f, v in fields.items()}),
                             jnp.asarray(mask), jnp.asarray(votes))
    else:
        ref = RefKernel(real, Rr)
        rst = ref.start_slot(RefState(**{f: jnp.asarray(v[:real]) for f, v in fields.items()}),
                             jnp.asarray(mask[:real]), jnp.asarray(votes[:real]))
    for f, g, p in zip(FIELDS, got, plain):
        want = np.asarray(getattr(rst, f))
        np.testing.assert_array_equal(g.numpy()[:real], want, err_msg=f)
        np.testing.assert_array_equal(g.numpy()[real:], fields[f][real:], err_msg=f"pad {f}")
        assert torch.equal(g.full(), p.full()), f


@pytest.mark.cuda
def test_sharded_start_slot_is_one_launch_a_device():
    """On a card: a 4 x 1 logical mesh of it takes one ``cr_start_slot``
    launch for its four shard blocks, and equals one device's
    ``ClusterKernel.start_slot`` row for row."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the start_slot kernel runs only on a card")
    dev = torch.device("cuda", 0)
    S, Rr = 4096, 5
    rng = np.random.default_rng(4)
    fields = start_slot_host.random_state_fields(rng, S, Rr)
    st = ClusterState(*(torch.from_numpy(fields[f].copy()).to(dev) for f in FIELDS))
    mask = torch.from_numpy(rng.random(S) < 0.5).to(dev)
    votes = torch.from_numpy(rng.integers(0, 4, (S, Rr)).astype(np.int8)).to(dev)
    sk = ShardedClusterKernel(S, Rr, port_make_mesh([dev] * 4, 4, 1))
    n0 = cluster_round.CLUSTER_ROUND.counts["start_slot"]
    got = sk.start_slot(st, mask, votes)
    assert cluster_round.CLUSTER_ROUND.counts["start_slot"] - n0 == 1
    want = ClusterKernel(S, Rr, device=dev).start_slot_plain(st, mask, votes)
    for g, w in zip(got, want):
        assert torch.equal(g.full(), w)
