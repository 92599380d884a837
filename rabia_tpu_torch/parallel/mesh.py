"""Device meshes and lockstep replica-parallel weak MVC.

The port of the reference's ``rabia_tpu/parallel/mesh.py``. Within a mesh,
consensus replicas map onto the replica axis and a round's vote exchange
is one all_gather over that axis; the shard axis is data-parallel, S
independent consensus instances cut in blocks over its devices.

- :func:`make_mesh` builds a :class:`Mesh`, a 2-D (shard × replica) grid
  of devices. On one controller one process holds every position (a
  logical mesh may name one device more than once: torch has one CPU
  device, and one card can stand in for every device of a mesh). Under
  an initialized ``torch.distributed`` process group (the counterpart of
  ``jax.distributed.initialize()``) rank k holds position (k // b, k % b)
  alone, and the mesh holds one group per shard row (the replica group)
  and one per replica column (the shard group).
- :class:`MeshArray` is an array cut in blocks over a mesh, the
  counterpart of a ``NamedSharding``-placed global array: each block is a
  tensor of its own on its position's device.
- :class:`ShardedClusterKernel`: a ``ClusterKernel`` whose state is cut in
  shard blocks over the shard axis; every method runs block by block, each
  block on its device's kernels with its global shard base (shards never
  interact, so there is no communication), except ``start_slot``, one
  launch a device over all of that device's blocks.
- :class:`MeshPhaseKernel`: one full weak-MVC phase per ``phase_step``,
  with the reference's two exchanges over the replica axis (the R1 votes,
  then the R2 votes). ``phase_step`` stays plain PyTorch, a block at a
  time: it is the specification. ``slot_window`` and ``slot_pipeline``
  exchange a window's votes and alive rows over the replica axis once,
  then make one launch of the CUDA kernel of
  :mod:`rabia_tpu_torch.kernel.mesh_window` a shard block, on the gathered
  blocks, with the block's first global shard as the coin's base. This is
  exact: in the reference's ``step_block`` a replica's next fields depend
  only on its own fields and on the tallies of its full row, so once a
  shard row's ``[T, S_blk, R]`` votes are local the window is the
  one-device function of them. On a multi-controller mesh the decided
  ``[T, S_blk]`` blocks are then all-gathered over the shard group, so
  every rank holds ``[T, S]`` (the reference's ``process_allgather``).

Without a mesh, ``MeshPhaseKernel`` runs on one device: the whole
``[S, R]`` state is local and each exchange is a read of the full replica
row; the plain window (``decide_slots_plain``) evaluates its T independent
slots as one ``[T, S, R]`` state.

The collectives are library calls, as ``lax.all_gather`` is XLA's:
``all_gather`` on an NCCL group, the same on a gloo group, and copies into
the blocked layout within one process.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from rabia_tpu_torch.core.device import DeviceLike, resolve_device, to_device
from rabia_tpu_torch.core.types import ABSENT, V0, V1, VQUESTION, f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cluster_round, mesh_window, packed_window
from rabia_tpu_torch.kernel.phase_driver import (
    ClusterKernel,
    ClusterState,
    _coin_bits,
    _pick,
    delivery_masks,
)

I8 = torch.int8
I32 = torch.int32

SHARD_AXIS = "shard"
REPLICA_AXIS = "replica"


def _dist():
    import torch.distributed as dist

    return dist


def _process_group_ready() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A 2-D (shard × replica) grid of devices: device k of the list sits
    at ``(k // replica_axis, k % replica_axis)``.

    ``shape`` maps the axis names to their sizes, as a JAX mesh's does.
    ``local`` lists the positions this process holds: every position on
    one controller; under a process group (``distributed``), rank k's
    position alone. ``local_rows`` maps each shard row this process holds
    to its first such position: an array that is not cut over the replica
    axis lives there once a row."""

    def __init__(self, devices: Sequence, shard_axis_size: int, replica_axis_size: int,
                 *, distributed: bool = False) -> None:
        a, b = int(shard_axis_size), int(replica_axis_size)
        self.devices = np.empty((a, b), dtype=object)
        for k, d in enumerate(devices):
            self.devices[k // b, k % b] = torch.device(d)
        self.shape = {SHARD_AXIS: a, REPLICA_AXIS: b}
        self.axis_names = (SHARD_AXIS, REPLICA_AXIS)
        self.distributed = bool(distributed)
        self.replica_group = self.shard_group = None
        self.backend: Optional[str] = None
        if self.distributed:
            dist = _dist()
            rank = dist.get_rank()
            # every rank creates every group, in the same order
            rows = [dist.new_group([i * b + j for j in range(b)]) for i in range(a)]
            cols = [dist.new_group([i * b + j for i in range(a)]) for j in range(b)]
            i, j = divmod(rank, b)
            self.replica_group, self.shard_group = rows[i], cols[j]
            self.backend = str(dist.get_backend(self.replica_group))
            self.local = [(i, j)]
        else:
            self.local = [(i, j) for i in range(a) for j in range(b)]
        self.local_rows: dict[int, tuple[int, int]] = {}
        for p in self.local:
            self.local_rows.setdefault(p[0], p)

    @property
    def size(self) -> int:
        return self.devices.size

    def device_at(self, pos: tuple[int, int]) -> torch.device:
        return self.devices[pos]

    def __repr__(self) -> str:
        kind = f"distributed, {self.backend}" if self.distributed else "one controller"
        return (f"Mesh({self.shape[SHARD_AXIS]}x{self.shape[REPLICA_AXIS]}, {kind}, "
                f"devices={[str(d) for d in self.devices.ravel()]})")

    # -- collectives ------------------------------------------------------

    def _all_gather(self, flat: torch.Tensor, group, n: int) -> torch.Tensor:
        """Every member's 1-d ``flat`` concatenated in group-rank order
        (``[n * len]``), on ``flat``'s device. An NCCL group gathers on the
        card. gloo is a host library: on a gloo group the blocks move
        through host memory by design (one copy to the host, the gather,
        one copy back), whatever device they live on."""
        dist = _dist()
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        if "nccl" in self.backend and flat.device.type == "cuda":
            out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
            gather(out, flat, group=group)
            return out
        if self.backend == "gloo":
            host = flat.cpu()
            out = torch.empty(n * flat.numel(), dtype=flat.dtype)
            gather(out, host, group=group)
            return out.to(flat.device)
        raise ValueError(
            f"mesh collectives take an NCCL group on CUDA tensors or a gloo group; "
            f"got backend {self.backend!r} for a tensor on {flat.device}")

    def gather_replicas(self, parts: dict, rows_only: bool = False) -> dict:
        """The all_gather over the replica axis. ``parts`` maps each local
        position to a list of 1-byte tensors (the same shapes across a
        shard row). Returns, for each local position (with ``rows_only``,
        each local row's first position), ``uint8[b, n]`` on its device:
        row jj holds the bytes of position (i, jj)'s tensors, one after
        another. On one controller this is copies into the blocked layout;
        under a process group, one collective over the replica group."""
        b = self.shape[REPLICA_AXIS]
        if self.distributed:
            (p,) = self.local
            flat = torch.cat([_bytes(t) for t in parts[p]])
            return {p: self._all_gather(flat, self.replica_group, b).view(b, -1)}
        out = {}
        for p in (self.local_rows.values() if rows_only else self.local):
            dev, i = self.device_at(p), p[0]
            row = [parts[(i, jj)] for jj in range(b)]
            n = sum(t.numel() for t in row[0])
            buf = torch.empty((b, n), dtype=torch.uint8, device=dev)
            for jj, ts in enumerate(row):
                off = 0
                for t in ts:
                    buf[jj, off:off + t.numel()].copy_(_bytes(t), non_blocking=True)
                    off += t.numel()
            out[p] = buf
        return out

    def gather_shards(self, t: torch.Tensor) -> torch.Tensor:
        """Under a process group: the all_gather of this rank's ``t`` over
        its shard group (its replica column), ``[a, *t.shape]``."""
        if not self.distributed:
            raise ValueError("gather_shards is the multi-controller mesh's collective")
        a = self.shape[SHARD_AXIS]
        return self._all_gather(t.contiguous().view(-1), self.shard_group, a).view(a, *t.shape)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte tensor's bytes, flat (a view where it is contiguous)."""
    if t.element_size() != 1:
        raise ValueError(f"replica exchanges carry 1-byte codes, got {t.dtype}")
    return t.contiguous().view(-1).view(torch.uint8)


def make_mesh(
    devices: Optional[Sequence] = None,
    shard_axis_size: Optional[int] = None,
    replica_axis_size: int = 1,
) -> Mesh:
    """Build a 2-D (shard × replica) device mesh.

    Default devices: every visible CUDA device (raises without a card, as
    the port's entry points do: pass ``devices=["cpu"] * n`` for the CPU);
    under an initialized ``torch.distributed`` process group, the world,
    one device per rank in rank order (this rank's current card). Default
    axes: every device on the shard axis. The axis sizes must multiply to
    the device count. A device may be named more than once: each position
    still holds tensors of its own."""
    distributed = _process_group_ready()
    if devices is None:
        resolve_device(None)  # raises without a card
        if distributed:
            devices = [torch.device("cuda", torch.cuda.current_device())] * _dist().get_world_size()
        else:
            devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if shard_axis_size is None:
        shard_axis_size = n // replica_axis_size
    if shard_axis_size * replica_axis_size != n:
        raise ValueError(f"mesh {shard_axis_size}x{replica_axis_size} != {n} devices")
    if distributed and n != _dist().get_world_size():
        raise ValueError(
            f"a mesh over a process group places one device a rank: {n} devices for a "
            f"world of {_dist().get_world_size()}")
    return Mesh(devs, shard_axis_size, replica_axis_size, distributed=distributed)


class MeshArray:
    """An array cut in blocks over a mesh: dimension ``sdim`` over the
    shard axis and ``rdim`` (or None) over the replica axis, the
    counterpart of a global array placed with a ``NamedSharding``.
    ``blocks`` maps a mesh position to the block on its device, for the
    positions this process holds. An array not cut over the replica axis
    is held once a shard row, at the row's first local position."""

    __slots__ = ("mesh", "shape", "sdim", "rdim", "blocks")

    def __init__(self, mesh: Mesh, shape, sdim: int, rdim: Optional[int], blocks: dict) -> None:
        self.mesh = mesh
        self.shape = tuple(int(n) for n in shape)
        self.sdim, self.rdim = sdim, rdim
        self.blocks = blocks

    @classmethod
    def cut(cls, mesh: Mesh, x, sdim: int, rdim: Optional[int] = None, dtype=None) -> "MeshArray":
        """``x`` (numpy, a tensor, or a MeshArray cut the same way) in
        blocks over ``mesh``: each local position's slice on its device, a
        tensor of its own. ``dtype`` converts every block."""
        if isinstance(x, MeshArray):
            if (x.mesh is not mesh or x.sdim != sdim % len(x.shape)
                    or x.rdim != (None if rdim is None else rdim % len(x.shape))):
                raise ValueError("the array is cut over another mesh or other dimensions")
            return x if dtype is None else x.map(lambda t: t.to(dtype))
        shape = tuple(x.shape)
        sdim %= len(shape)
        rdim = None if rdim is None else rdim % len(shape)
        a, b = mesh.shape[SHARD_AXIS], mesh.shape[REPLICA_AXIS]
        if shape[sdim] % a or (rdim is not None and shape[rdim] % b):
            raise ValueError(f"an array of shape {list(shape)} does not cut into "
                             f"{a} x {b} blocks (dims {sdim}, {rdim})")
        sb = shape[sdim] // a
        rb = None if rdim is None else shape[rdim] // b
        blocks = {}
        for p in (mesh.local if rdim is not None else mesh.local_rows.values()):
            idx = [slice(None)] * len(shape)
            idx[sdim] = slice(p[0] * sb, (p[0] + 1) * sb)
            if rdim is not None:
                idx[rdim] = slice(p[1] * rb, (p[1] + 1) * rb)
            dev = mesh.device_at(p)
            part = x[tuple(idx)]
            t = (to_device(np.require(part, requirements=["C", "W"]), dev)
                 if isinstance(part, np.ndarray) else part.to(dev).contiguous())
            blocks[p] = t if dtype is None else t.to(dtype)
        return cls(mesh, shape, sdim, rdim, blocks)

    def map(self, fn) -> "MeshArray":
        """``fn`` applied to every block (it keeps the block's shape)."""
        return MeshArray(self.mesh, self.shape, self.sdim, self.rdim,
                         {p: fn(t) for p, t in self.blocks.items()})

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    def row(self, i: int) -> torch.Tensor:
        """Shard row i's block of an array not cut over the replica axis."""
        return self.blocks[self.mesh.local_rows[i]]

    def full(self, device: DeviceLike = None) -> torch.Tensor:
        """The whole array on ``device`` (default: the mesh's first
        device). One controller only: under a process group a rank holds
        its own blocks alone."""
        mesh = self.mesh
        if mesh.distributed:
            raise ValueError("a multi-controller MeshArray holds this rank's blocks only")
        dev = mesh.device_at((0, 0)) if device is None else torch.device(device)
        a, b = mesh.shape[SHARD_AXIS], mesh.shape[REPLICA_AXIS]
        rows = []
        for i in range(a):
            if self.rdim is None:
                rows.append(self.row(i).to(dev))
            else:
                rows.append(torch.cat([self.blocks[(i, j)].to(dev) for j in range(b)], self.rdim))
        return torch.cat(rows, self.sdim)

    def numpy(self) -> np.ndarray:
        return self.full("cpu").numpy()

    def __repr__(self) -> str:
        return (f"MeshArray(shape={list(self.shape)}, dtype={self.dtype}, sdim={self.sdim}, "
                f"rdim={self.rdim}, {len(self.blocks)} local blocks)")


# ---------------------------------------------------------------------------
# Shard-axis data parallelism over ClusterKernel
# ---------------------------------------------------------------------------


class ShardedClusterKernel:
    """``ClusterKernel`` with its state cut in shard blocks over the mesh's
    shard axis, as the reference's ``_CLUSTER_SPECS`` cut it (every field's
    leading dimension; replicated over the replica axis, so a block lives
    once a shard row). Every method runs block by block, each block on its
    device's ``ClusterKernel`` with its global shard base, so the common
    coin sees the whole mesh's shard numbering; shards never interact, so
    nothing crosses devices. States, votes and results are
    :class:`MeshArray`; inputs may also be whole arrays, which are cut."""

    def __init__(
        self,
        n_shards: int,
        n_replicas: int,
        mesh: Mesh,
        *,
        coin_p1: float = 0.5,
        seed: int = 0,
    ):
        axis = mesh.shape[SHARD_AXIS]
        if n_shards % axis != 0:
            raise ValueError(f"n_shards {n_shards} not divisible by shard axis {axis}")
        self.S = int(n_shards)
        self.R = int(n_replicas)
        self.mesh = mesh
        self.quorum = quorum_size(self.R)
        self.f1 = f_plus_1(self.R)
        self.coin_p1 = float(coin_p1)
        self.seed = int(seed)
        self.S_blk = self.S // axis
        self.blocks = {
            i: ClusterKernel(self.S_blk, self.R, coin_p1=coin_p1, seed=seed,
                             device=mesh.device_at(p), shard_base=i * self.S_blk)
            for i, p in mesh.local_rows.items()
        }
        self.device = mesh.device_at(mesh.local[0])

    # -- cutting and assembling -------------------------------------------

    def _cut(self, x, sdim: int, shape=None, dtype=None) -> MeshArray:
        if shape is not None and not isinstance(x, MeshArray):
            x = torch.broadcast_to(torch.as_tensor(x, device=self.device), shape)
        return MeshArray.cut(self.mesh, x, sdim, None, dtype)

    def _out(self, shape, sdim: int, rows: dict) -> MeshArray:
        return MeshArray(self.mesh, shape, sdim, None,
                         {self.mesh.local_rows[i]: t for i, t in rows.items()})

    def _state_out(self, rows: dict) -> ClusterState:
        """A ClusterState of MeshArrays from each local row's block state."""
        S, R = self.S, self.R
        shapes = {"S": (S,), "SR": (S, R), "SRR": (S, R, R)}
        kinds = ("S", "SR", "SR", "SR", "SR", "SR", "SR", "SRR", "SRR", "S", "S", "SR", "S")
        return ClusterState(*(
            self._out(shapes[k], 0, {i: st[f] for i, st in rows.items()})
            for f, k in enumerate(kinds)
        ))

    def _state_rows(self, state: ClusterState) -> dict:
        fields = [self._cut(f, 0) for f in state]
        return {i: ClusterState(*(f.row(i) for f in fields)) for i in self.blocks}

    def _alive(self, alive) -> MeshArray:
        return self._cut(alive, 0, (self.S, self.R), torch.bool)

    # -- ClusterKernel's methods, block by block ---------------------------

    def init_state(self) -> ClusterState:
        return self._state_out({i: k.init_state() for i, k in self.blocks.items()})

    def place_votes(self, votes) -> MeshArray:
        """Cut an ``[T, S, R]`` (or ``[S, R]``) initial-vote array over S."""
        return self._cut(votes, 1 if len(votes.shape) == 3 else 0)

    def start_slot_blocks(self, state: ClusterState, shard_mask, initial_votes) -> dict:
        """``start_slot``'s shard blocks by device: ``{device: [(row,
        fields, mask, votes), ...]}``, each block's 13 fields, bool mask
        and int8 votes contiguous on its device."""
        mask = self._cut(shard_mask, 0, (self.S,), torch.bool)
        votes = self._cut(initial_votes, 0, (self.S, self.R), I8)
        fields = [self._cut(f, 0) for f in state]
        out: dict = {}
        for i in self.blocks:
            dev = self.mesh.device_at(self.mesh.local_rows[i])
            out.setdefault(dev, []).append(
                (i, [f.row(i).contiguous() for f in fields], mask.row(i), votes.row(i)))
        return out

    def start_slot(self, state: ClusterState, shard_mask, initial_votes) -> ClusterState:
        """``ClusterKernel.start_slot`` on every shard block: on a card one
        ``cr_start_slot`` launch a device for all of its blocks (the
        kernel's table of blocks), on the CPU each block's plain version.
        Opening a slot reads no shard coordinate."""
        rows = {}
        for dev, blocks in self.start_slot_blocks(state, shard_mask, initial_votes).items():
            if dev.type == "cuda":
                outs = cluster_round.CLUSTER_ROUND.start_slot_blocks([b[1:] for b in blocks])
                rows.update((b[0], o) for b, o in zip(blocks, outs))
            else:
                for i, f, m, v in blocks:
                    rows[i] = self.blocks[i].start_slot(ClusterState(*f), m, v)
        return self._state_out(rows)

    def round_step(self, state: ClusterState, alive, deliver) -> ClusterState:
        alive = self._alive(alive)
        deliver = self._cut(deliver, 0, (self.S, self.R, self.R), torch.bool)
        rows = self._state_rows(state)
        return self._state_out({
            i: k.round_step(rows[i], alive.row(i), deliver.row(i))
            for i, k in self.blocks.items()
        })

    def run_rounds(
        self,
        state: ClusterState,
        alive,
        n_rounds: int,
        generator: torch.Generator,
        p_deliver: float = 1.0,
        link_mask: Optional[torch.Tensor] = None,
    ) -> ClusterState:
        """``ClusterKernel.run_rounds``: the delivery masks are drawn for
        the whole ``[S, R, R]`` grid as it draws them (on this kernel's
        first device, from ``generator``), then each block runs its
        rounds under its slice of them: the same seed gives the same
        masks and so the same run as one device's."""
        if n_rounds == 0:
            return state
        shape = (self.S, self.R, self.R)
        masks = delivery_masks(shape, n_rounds, generator, self.device, p_deliver, link_mask)
        cut = None if masks is None else self._cut(masks, masks.dim() - 3)
        alive = self._alive(alive)
        rows = self._state_rows(state)
        return self._state_out({
            i: k.rounds_masked(rows[i], alive.row(i), None if cut is None else cut.row(i),
                               n_rounds)
            for i, k in self.blocks.items()
        })

    def _pipelines(self, votes, alive, run, T: int):
        votes = self._cut(votes, 1)
        alive = self._alive(alive)
        outs = {i: run(k, votes.row(i), alive.row(i)) for i, k in self.blocks.items()}
        return tuple(self._out((T, self.S), 1, {i: o[n] for i, o in outs.items()})
                     for n in range(2))

    def slot_pipeline(self, initial_votes, alive, n_slots: int, rounds_per_slot: int = 2,
                      start_slot_index: int = 0) -> tuple[MeshArray, MeshArray]:
        """``(decided i8[T, S], decided_phase i32[T, S])``, each block by
        its ``ClusterKernel.slot_pipeline``."""
        return self._pipelines(initial_votes, alive, lambda k, v, a: k.slot_pipeline(
            v, a, n_slots, rounds_per_slot, start_slot_index), n_slots)

    def slot_pipeline_wide(self, initial_votes, alive, n_slots: int, rounds_per_slot: int = 2,
                           start_slot_index: int = 0,
                           block: int = 256) -> tuple[MeshArray, MeshArray]:
        return self._pipelines(initial_votes, alive, lambda k, v, a: k.slot_pipeline_wide(
            v, a, n_slots, rounds_per_slot, start_slot_index, block), n_slots)

    def slot_pipeline_fused(self, initial_votes, alive,
                            n_slots: int) -> tuple[MeshArray, MeshArray]:
        """The fused window reads no shard coordinate: each block runs it
        unchanged."""
        return self._pipelines(initial_votes, alive,
                               lambda k, v, a: k.slot_pipeline_fused(v, a, n_slots), n_slots)

    def slot_pipeline_fused_rmajor(self, votes_rm, alive_rm, n_slots: int,
                                   want_phase: bool = True):
        votes = self._cut(votes_rm, 2)
        alive = self._cut(alive_rm, 1, (self.R, self.S))
        outs = {i: k.slot_pipeline_fused_rmajor(votes.row(i), alive.row(i), n_slots, want_phase)
                for i, k in self.blocks.items()}
        if not want_phase:
            return self._out((n_slots, self.S), 1, outs)
        return tuple(self._out((n_slots, self.S), 1, {i: o[n] for i, o in outs.items()})
                     for n in range(2))

    def slot_pipeline_fused_packed(self, packed_rm, alive_packed, n_slots: int) -> MeshArray:
        """The packed window is elementwise over its 16-shard words: each
        block takes its run of words (``SW`` must divide by the shard
        axis). Returns packed decisions i32[T, SW]."""
        SW = packed_window.packed_width(self.S)
        if tuple(packed_rm.shape) != (self.R, n_slots, SW):
            raise ValueError(f"packed_rm is {tuple(packed_rm.shape)}, expected packed "
                             f"replica-major [R={self.R}, T={n_slots}, SW={SW}]")
        votes = self._cut(packed_rm, 2)
        alive = self._cut(alive_packed, 1, (self.R, SW))
        return self._out((n_slots, SW), 1, {
            i: packed_window.window(votes.row(i), alive.row(i), self.quorum) for i in self.blocks
        })


# ---------------------------------------------------------------------------
# Replica-axis collectives
# ---------------------------------------------------------------------------


class MeshPhaseState(NamedTuple):
    """Lockstep replica-parallel state, ``[..., S, R]`` (over a mesh, each
    field a :class:`MeshArray` in ``[S/a, R/b]`` blocks)."""

    slot: torch.Tensor  # i32[..., S, R] (same value across R)
    phase: torch.Tensor  # i32[..., S, R]
    my_r1: torch.Tensor  # i8[..., S, R]
    decided: torch.Tensor  # i8[..., S, R] (each replica's view; ABSENT until known)


class MeshPhaseKernel:
    """One full weak-MVC phase per step over every (shard, replica).

    Lockstep model: every live replica takes part in each phase and
    delivery is reliable within the exchange; a crashed replica is an
    ``alive`` mask column whose votes are masked out of the tally.

    With ``mesh`` the state lives in ``[S/a, R/b]`` blocks over the
    mesh's (shard × replica) axes; without one, on ``device`` (CUDA unless
    the caller passes another)."""

    def __init__(
        self,
        n_shards: int,
        n_replicas: int,
        mesh: Optional[Mesh] = None,
        *,
        coin_p1: float = 0.5,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.S = int(n_shards)
        self.R = int(n_replicas)
        self.mesh = mesh
        self.quorum = quorum_size(self.R)
        self.f1 = f_plus_1(self.R)
        self.coin_p1 = float(coin_p1)
        self.seed = int(seed)
        if mesh is None:
            self.device = resolve_device(device)
            return
        if device is not None:
            raise ValueError("pass a mesh or a device, not both: a mesh names its devices")
        if self.S % mesh.shape[SHARD_AXIS] != 0:
            raise ValueError("n_shards not divisible by shard axis")
        if self.R % mesh.shape[REPLICA_AXIS] != 0:
            raise ValueError("n_replicas not divisible by replica axis")
        self.device = mesh.device_at(mesh.local[0])
        self.S_blk = self.S // mesh.shape[SHARD_AXIS]
        self.R_blk = self.R // mesh.shape[REPLICA_AXIS]

    # -- placement ---------------------------------------------------------

    def place(self, arr, dtype=None):
        """Put an ``[S, R]`` array (numpy, a tensor) on this kernel's
        device, or over a mesh in ``[S/a, R/b]`` blocks."""
        if self.mesh is None:
            t = torch.as_tensor(arr, device=self.device)
            return t if dtype is None else t.to(dtype)
        return MeshArray.cut(self.mesh, arr, 0, 1, dtype)

    def _blocks_of(self, fill) -> MeshArray:
        """A MeshArray of ``[S, R]`` whose block at p is ``fill(p)``."""
        return MeshArray(self.mesh, (self.S, self.R), 0, 1,
                         {p: fill(p) for p in self.mesh.local})

    def init_state(self, initial_votes) -> MeshPhaseState:
        """Start slot 0 on every shard with the given i8[S, R] R1 votes."""
        S, R = self.S, self.R
        if self.mesh is None:
            dev = self.device
            return MeshPhaseState(
                slot=torch.zeros((S, R), dtype=I32, device=dev),
                phase=torch.zeros((S, R), dtype=I32, device=dev),
                my_r1=self.place(initial_votes).to(I8),
                decided=torch.full((S, R), ABSENT, dtype=I8, device=dev),
            )
        shape = (self.S_blk, self.R_blk)
        fill = lambda v, dt: self._blocks_of(  # noqa: E731
            lambda p: torch.full(shape, v, dtype=dt, device=self.mesh.device_at(p)))
        return MeshPhaseState(
            slot=fill(0, I32), phase=fill(0, I32), my_r1=self.place(initial_votes, I8),
            decided=fill(ABSENT, I8),
        )

    def shard_index_array(self):
        """i32[S, R] global shard ids (the coin's shard coordinate), placed
        like the state."""
        if self.mesh is None:
            idx = torch.arange(self.S, dtype=I32, device=self.device)
            return idx[:, None].expand(self.S, self.R)
        Sb, Rb = self.S_blk, self.R_blk
        return self._blocks_of(lambda p: torch.arange(
            p[0] * Sb, (p[0] + 1) * Sb, dtype=I32, device=self.mesh.device_at(p)
        )[:, None].expand(Sb, Rb).contiguous())

    # -- one phase -----------------------------------------------------------

    def _r2_of(self, r1_all: torch.Tensor) -> torch.Tensor:
        """Every replica's round-2 vote ``[..., 1]`` from the row's live
        round-1 votes ``[..., R]``: V1 at a quorum of V1, V0 at a quorum
        of V0, else V?."""
        Q = self.quorum
        c0 = (r1_all == V0).sum(-1, keepdim=True, dtype=I32)
        c1 = (r1_all == V1).sum(-1, keepdim=True, dtype=I32)
        return _pick(c1 >= Q, V1, c0 >= Q, V0, VQUESTION)

    def _advance(self, slot, phase, my_r1, decided, live, r2_all, shard_index) -> MeshPhaseState:
        """A phase's end from the row's live round-2 votes ``[..., R]``:
        decide at f+1 equal votes, else adopt a non-? vote, else flip the
        common coin of (seed, shard, slot, phase)."""
        F1 = self.f1
        d0 = (r2_all == V0).sum(-1, keepdim=True, dtype=I32)
        d1 = (r2_all == V1).sum(-1, keepdim=True, dtype=I32)
        decide1 = d1 >= F1
        decide0 = d0 >= F1
        coin = _coin_bits(self.seed, shard_index, slot, phase, self.coin_p1)
        next_v = _pick(decide1, V1, decide0, V0, _pick(d1 > 0, V1, d0 > 0, V0, coin))
        newly = (decide1 | decide0) & live
        dec_val = torch.where(decide1, V1, V0).to(I8)
        return MeshPhaseState(
            slot=slot,
            phase=torch.where(live, phase + 1, phase),
            my_r1=torch.where(live, next_v, my_r1),
            decided=torch.where(newly, dec_val, decided),
        )

    def phase_step(self, state: MeshPhaseState, alive, shard_index) -> MeshPhaseState:
        """One MVC phase for every (shard, replica): round-1 tally, round-2
        vote, round-2 tally, then decide / adopt / flip the coin.

        ``alive``: bool[S, R]; ``shard_index``: i32[S, R] global shard ids
        (for the common coin). On one device both broadcast over leading
        slot axes; over a mesh they are cut like the state, and the two
        tallies read the replica row that an exchange over the replica axis
        gathers (the round-1 votes, then the round-2 votes)."""
        if self.mesh is not None:
            return self._phase_step_mesh(state, alive, shard_index)
        return self._phase_step_one(state, alive, shard_index)

    def _phase_step_one(self, state: MeshPhaseState, alive, shard_index) -> MeshPhaseState:
        """:meth:`phase_step` where the whole replica row is local."""
        live = alive & (state.decided == ABSENT)
        # ---- round 1: every replica reads the whole replica row --------
        r2 = self._r2_of(torch.where(live, state.my_r1, ABSENT)).expand_as(state.my_r1)
        # ---- round 2: every replica reads the row's R2 votes -----------
        return self._advance(state.slot, state.phase, state.my_r1, state.decided, live,
                             torch.where(live, r2, ABSENT), shard_index)

    def _row_votes(self, parts: dict) -> dict:
        """Each local position's full replica row ``i8[S_blk, R]`` of the
        1-byte ``[S_blk, R_blk]`` blocks in ``parts``, by one exchange
        over the replica axis."""
        b, Sb, Rb = self.mesh.shape[REPLICA_AXIS], self.S_blk, self.R_blk
        got = self.mesh.gather_replicas({p: [t] for p, t in parts.items()})
        return {p: g.view(I8).view(b, Sb, Rb).permute(1, 0, 2).reshape(Sb, b * Rb)
                for p, g in got.items()}

    def _phase_step_mesh(self, state: MeshPhaseState, alive, shard_index) -> MeshPhaseState:
        st = MeshPhaseState(*(self.place(f) for f in state))
        alive = self.place(alive, torch.bool).blocks
        idx = self.place(shard_index).blocks
        local = self.mesh.local
        live = {p: alive[p] & (st.decided.blocks[p] == ABSENT) for p in local}
        # ---- round 1: all_gather the live R1 votes over the replica axis
        r1_all = self._row_votes({
            p: torch.where(live[p], st.my_r1.blocks[p], ABSENT).to(I8) for p in local})
        r2 = {p: self._r2_of(r1_all[p]).expand_as(st.my_r1.blocks[p]) for p in local}
        # ---- round 2: all_gather the live R2 votes ----------------------
        r2_all = self._row_votes({p: torch.where(live[p], r2[p], ABSENT).to(I8) for p in local})
        out = {p: self._advance(st.slot.blocks[p], st.phase.blocks[p], st.my_r1.blocks[p],
                                st.decided.blocks[p], live[p], r2_all[p], idx[p])
               for p in local}
        return MeshPhaseState(*(
            self._blocks_of(lambda p, f=f: out[p][f]) for f in range(len(MeshPhaseState._fields))
        ))

    # -- windows ---------------------------------------------------------------

    def decide_slots_plain(self, votes, alive, base_slots, max_phases: int,
                           shard0: int = 0) -> torch.Tensor:
        """Run ``max_phases`` phases on T independent slots at once, plain
        PyTorch; entry ``t`` of shard ``s`` is slot ``base_slots[s] + t``
        (int32, wrapping), and shard ``s`` is global shard ``shard0 + s``
        for the coin. Returns decided i8[T, S]."""
        T, S, R = votes.shape
        dev = votes.device
        offsets = torch.arange(T, dtype=I32, device=dev)
        slots = base_slots.to(I32)[None, :] + offsets[:, None]
        st = MeshPhaseState(
            slot=slots[:, :, None].expand(votes.shape).contiguous(),
            phase=torch.zeros(votes.shape, dtype=I32, device=dev),
            my_r1=votes.to(I8),
            decided=torch.full(votes.shape, ABSENT, dtype=I8, device=dev),
        )
        shard_idx = torch.arange(shard0, shard0 + S, dtype=I32, device=dev)[:, None].expand(S, R)
        for _ in range(max_phases):
            st = self._phase_step_one(st, alive, shard_idx)
        # a decided replica's view; the max over replicas would pick
        # ABSENT (=3) over a decision, so mask it out explicitly
        concrete = torch.where(st.decided == ABSENT, -1, st.decided)
        best = concrete.amax(-1)
        return torch.where(best < 0, ABSENT, best).to(I8)

    def decide_blocks_plain(self, votes, alive, base_slots, max_phases: int,
                            shard0: int = 0) -> torch.Tensor:
        """:meth:`decide_slots_plain` on a shard block's window as the
        replica exchange leaves it: votes ``i8[B, T, S_blk, R/B]``, alive
        ``bool[B, S_blk, R/B]`` (replica block b holds replicas
        b*R/B .. b*R/B + R/B - 1)."""
        B, T, Sb, Rb = votes.shape
        v = votes.permute(1, 2, 0, 3).reshape(T, Sb, B * Rb)
        a = alive.permute(1, 0, 2).reshape(Sb, B * Rb)
        return self.decide_slots_plain(v, a, base_slots, max_phases, shard0)

    def _decide_slots(self, votes, alive, base_slots, max_phases: int,
                      shard0: int = 0) -> torch.Tensor:
        """One window: the CUDA kernel for CUDA tensors, the plain loop
        for CPU tensors. Votes ``[T, S, R]`` and alive ``[S, R]``, or a
        shard block's ``[B, T, S_blk, R/B]`` and ``[B, S_blk, R/B]``."""
        if votes.device.type == "cuda":
            if votes.dim() == 3:
                votes, alive = votes.to(I8).contiguous(), alive.to(torch.bool).contiguous()
            return mesh_window.MESH_WINDOW(
                votes, alive, base_slots.to(I32).contiguous(),
                seed=self.seed, coin_p1=self.coin_p1, max_phases=max_phases, shard0=shard0,
            )
        if votes.device.type == "cpu":
            plain = self.decide_blocks_plain if votes.dim() == 4 else self.decide_slots_plain
            return plain(votes, alive, base_slots, max_phases, shard0)
        raise ValueError(f"no mesh window for device {votes.device}")

    def decide_staged(self, stage, n_slots: int, max_phases: int) -> None:
        """One window on a staging buffer that the caller owns
        (:class:`~rabia_tpu_torch.kernel.mesh_window.WindowStage`, one
        device only): entry ``t`` of shard ``s`` runs as slot
        ``stage.base[s] + t`` on ``stage.votes[:n_slots]`` and
        ``stage.alive``, and the decisions go to ``stage.decided[:n_slots]``.
        On a card one ``mw_window`` launch reads and writes the pinned
        buffer in place (``stage.event`` marks its end); on the CPU the
        plain loop runs on views of it."""
        if self.mesh is not None:
            raise ValueError("a staged window runs on one device, not over a mesh")
        T = int(n_slots)
        if self.device.type == "cuda":
            mesh_window.MESH_WINDOW.mapped(stage, T, self.device, seed=self.seed,
                                           coin_p1=self.coin_p1, max_phases=max_phases)
            return
        if self.device.type != "cpu":
            raise ValueError(f"no mesh window for device {self.device}")
        stage.decided[:T] = self.decide_slots_plain(
            torch.from_numpy(stage.votes[:T]), torch.from_numpy(stage.alive),
            torch.from_numpy(stage.base), max_phases).numpy()

    def exchange_window(self, votes, alive) -> dict:
        """The window's one exchange over the replica axis: for each local
        shard row i, ``(votes i8[b, T, S_blk, R_blk], alive bool[b,
        S_blk, R_blk])`` on the row's first local device, as the
        all_gather leaves them (replica block jj at row jj of one buffer,
        its votes then its alive rows). On one controller a replica axis
        of 1 needs no exchange: the row's block is taken as it is."""
        mesh = self.mesh
        V = MeshArray.cut(mesh, votes, 1, 2, I8)
        A = MeshArray.cut(mesh, alive, 0, 1, torch.bool)
        T = V.shape[0]
        b, Sb, Rb = mesh.shape[REPLICA_AXIS], self.S_blk, self.R_blk
        if b == 1 and not mesh.distributed:
            return {p[0]: (V.blocks[p].unsqueeze(0), A.blocks[p].unsqueeze(0))
                    for p in mesh.local_rows.values()}
        nv = T * Sb * Rb
        got = mesh.gather_replicas({p: [V.blocks[p], A.blocks[p]] for p in mesh.local},
                                   rows_only=True)
        return {p[0]: (g[:, :nv].view(I8).view(b, T, Sb, Rb),
                       g[:, nv:].view(torch.bool).view(b, Sb, Rb))
                for p, g in got.items()}

    def _decide_mesh(self, votes, alive, base_slots, max_phases: int) -> torch.Tensor:
        """A window over the mesh: one exchange, one launch a shard block,
        then the decided blocks assembled into ``[T, S]`` (over the shard
        group under a process group)."""
        mesh = self.mesh
        rows = self.exchange_window(votes, alive)
        base = MeshArray.cut(mesh, base_slots, 0, None, I32)
        dec = {i: self._decide_slots(v, a, base.row(i).to(v.device), max_phases,
                                     shard0=i * self.S_blk)
               for i, (v, a) in rows.items()}
        if mesh.distributed:
            ((i, d),) = dec.items()
            T = d.shape[0]
            return mesh.gather_shards(d).permute(1, 0, 2).reshape(T, self.S)
        if len(dec) == 1:
            return dec[0]
        return torch.cat([dec[i].to(self.device) for i in range(mesh.shape[SHARD_AXIS])], 1)

    def _check(self, initial_votes, n_slots: int) -> None:
        if tuple(initial_votes.shape) != (n_slots, self.S, self.R):
            raise ValueError(
                f"initial_votes is {tuple(initial_votes.shape)}, expected "
                f"[T={n_slots}, S={self.S}, R={self.R}]"
            )

    def _window(self, votes, alive, base_slots, max_phases: int) -> torch.Tensor:
        if self.mesh is not None:
            return self._decide_mesh(votes, alive, base_slots, max_phases)
        return self._decide_slots(votes, alive, base_slots, max_phases)

    def slot_pipeline(
        self,
        initial_votes,  # i8[T, S, R] per-slot initial R1 votes
        alive,  # bool[S, R]
        n_slots: int,
        max_phases: int = 4,
        start_slot_index: int = 0,
    ) -> torch.Tensor:
        """Decide ``n_slots`` consecutive slots for all shards,
        ``max_phases`` phases each (one suffices fault-free; extra phases
        absorb split initial votes via the common coin). Returns decided
        i8[T, S]; ABSENT only where a shard failed to decide in time.
        ``start_slot_index`` offsets the slot numbering (and therefore the
        coin stream). Over a mesh the inputs may be whole arrays (numpy
        or tensors) or MeshArrays, and every process gets the whole
        ``[T, S]``."""
        self._check(initial_votes, n_slots)
        base = torch.full((self.S,), start_slot_index, dtype=I32, device=self.device)
        return self._window(initial_votes, alive, base, max_phases)

    def slot_window(
        self,
        initial_votes,  # i8[T, S, R] per-slot initial R1 votes
        alive,  # bool[S, R]
        base_slots,  # i32[S] PER-SHARD first slot number
        *,
        n_slots: int,
        max_phases: int = 4,
    ) -> torch.Tensor:
        """:meth:`slot_pipeline` with per-shard slot numbering: window
        entry ``t`` of shard ``s`` runs as slot ``base_slots[s] + t``, so
        a shard's coin stream never depends on other shards' progress.
        Returns decided i8[T, S]."""
        self._check(initial_votes, n_slots)
        return self._window(initial_votes, alive, base_slots, max_phases)
