"""Lockstep replica-parallel weak MVC on one device.

The port of the reference's ``MeshPhaseKernel`` (``rabia_tpu/parallel/
mesh.py``) for a single device. In the reference each device owns a block
of (shard, replica) state and a phase exchanges votes with two
``all_gather``s over the replica axis; on one device the whole ``[S, R]``
tensor is local, so each exchange is a read of the full replica row.
Every step is elementwise over (shard, replica) with a reduction over the
replica axis, so it runs unchanged on a leading batch of slots: the plain
window (``decide_slots_plain``) evaluates its T independent slots as one
``[T, S, R]`` state instead of mapping over them. On a card,
``slot_window`` and ``slot_pipeline`` are one launch of the CUDA kernel
of :mod:`rabia_tpu_torch.kernel.mesh_window`; ``phase_step`` stays plain
PyTorch, the specification the kernel and the plain window are held to.

Multi-device meshes (``make_mesh``, ``ShardedClusterKernel``) are not
ported yet (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rabia_tpu_torch.core.device import DeviceLike, resolve_device
from rabia_tpu_torch.core.types import ABSENT, V0, V1, VQUESTION, f_plus_1, quorum_size
from rabia_tpu_torch.kernel import mesh_window
from rabia_tpu_torch.kernel.phase_driver import _coin_bits, _pick

I8 = torch.int8
I32 = torch.int32


class MeshPhaseState(NamedTuple):
    """Lockstep replica-parallel state, ``[..., S, R]``."""

    slot: torch.Tensor  # i32[..., S, R] (same value across R)
    phase: torch.Tensor  # i32[..., S, R]
    my_r1: torch.Tensor  # i8[..., S, R]
    decided: torch.Tensor  # i8[..., S, R] (each replica's view; ABSENT until known)


class MeshPhaseKernel:
    """One full weak-MVC phase per step over every (shard, replica).

    Lockstep model: every live replica takes part in each phase and
    delivery is reliable; a crashed replica is an ``alive`` mask column
    whose votes are masked out of the tally."""

    def __init__(
        self,
        n_shards: int,
        n_replicas: int,
        *,
        coin_p1: float = 0.5,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.S = int(n_shards)
        self.R = int(n_replicas)
        self.quorum = quorum_size(self.R)
        self.f1 = f_plus_1(self.R)
        self.coin_p1 = float(coin_p1)
        self.seed = int(seed)

    def init_state(self, initial_votes: torch.Tensor) -> MeshPhaseState:
        """Start slot 0 on every shard with the given i8[S, R] R1 votes."""
        S, R, dev = self.S, self.R, self.device
        return MeshPhaseState(
            slot=torch.zeros((S, R), dtype=I32, device=dev),
            phase=torch.zeros((S, R), dtype=I32, device=dev),
            my_r1=self.place(initial_votes).to(I8),
            decided=torch.full((S, R), ABSENT, dtype=I8, device=dev),
        )

    def phase_step(
        self, state: MeshPhaseState, alive: torch.Tensor, shard_index: torch.Tensor
    ) -> MeshPhaseState:
        """One MVC phase for every (shard, replica): round-1 tally, round-2
        vote, round-2 tally, then decide / adopt / flip the coin.

        ``alive``: bool[S, R]; ``shard_index``: i32[S, R] global shard ids
        (for the common coin). Both broadcast over leading slot axes."""
        Q, F1 = self.quorum, self.f1
        live = alive & (state.decided == ABSENT)
        # ---- round 1: every replica reads the whole replica row --------
        r1_all = torch.where(live, state.my_r1, ABSENT)
        c0 = (r1_all == V0).sum(-1, keepdim=True, dtype=I32)
        c1 = (r1_all == V1).sum(-1, keepdim=True, dtype=I32)
        r2 = _pick(c1 >= Q, V1, c0 >= Q, V0, VQUESTION).expand_as(state.my_r1)
        # ---- round 2: exchange R2 votes ---------------------------------
        r2_all = torch.where(live, r2, ABSENT)
        d0 = (r2_all == V0).sum(-1, keepdim=True, dtype=I32)
        d1 = (r2_all == V1).sum(-1, keepdim=True, dtype=I32)
        decide1 = d1 >= F1
        decide0 = d0 >= F1
        coin = _coin_bits(self.seed, shard_index, state.slot, state.phase, self.coin_p1)
        next_v = _pick(decide1, V1, decide0, V0, _pick(d1 > 0, V1, d0 > 0, V0, coin))
        newly = (decide1 | decide0) & live
        dec_val = torch.where(decide1, V1, V0).to(I8)
        return MeshPhaseState(
            slot=state.slot,
            phase=torch.where(live, state.phase + 1, state.phase),
            my_r1=torch.where(live, next_v, state.my_r1),
            decided=torch.where(newly, dec_val, state.decided),
        )

    def shard_index_array(self) -> torch.Tensor:
        """i32[S, R] global shard ids (the coin's shard coordinate)."""
        idx = torch.arange(self.S, dtype=I32, device=self.device)
        return idx[:, None].expand(self.S, self.R)

    def place(self, arr) -> torch.Tensor:
        """Put an array (numpy or tensor) on this kernel's device."""
        return torch.as_tensor(arr, device=self.device)

    def decide_slots_plain(self, votes, alive, base_slots, max_phases: int) -> torch.Tensor:
        """Run ``max_phases`` phases on T independent slots at once, plain
        PyTorch; entry ``t`` of shard ``s`` is slot ``base_slots[s] + t``
        (int32, wrapping). Returns decided i8[T, S]."""
        offsets = torch.arange(votes.shape[0], dtype=I32, device=self.device)
        slots = base_slots.to(I32)[None, :] + offsets[:, None]
        st = MeshPhaseState(
            slot=slots[:, :, None].expand(votes.shape).contiguous(),
            phase=torch.zeros(votes.shape, dtype=I32, device=self.device),
            my_r1=votes.to(I8),
            decided=torch.full(votes.shape, ABSENT, dtype=I8, device=self.device),
        )
        shard_idx = self.shard_index_array()
        for _ in range(max_phases):
            st = self.phase_step(st, alive, shard_idx)
        # a decided replica's view; the max over replicas would pick
        # ABSENT (=3) over a decision, so mask it out explicitly
        concrete = torch.where(st.decided == ABSENT, -1, st.decided)
        best = concrete.amax(-1)
        return torch.where(best < 0, ABSENT, best).to(I8)

    def _decide_slots(self, votes, alive, base_slots, max_phases: int) -> torch.Tensor:
        """The window: the CUDA kernel for CUDA tensors, the plain loop
        for CPU tensors."""
        if votes.device.type == "cuda":
            return mesh_window.MESH_WINDOW(
                votes.to(I8).contiguous(), alive.to(torch.bool).contiguous(),
                base_slots.to(I32).contiguous(),
                seed=self.seed, coin_p1=self.coin_p1, max_phases=max_phases,
            )
        if votes.device.type == "cpu":
            return self.decide_slots_plain(votes, alive, base_slots, max_phases)
        raise ValueError(f"no mesh window for device {votes.device}")

    def _check(self, initial_votes: torch.Tensor, n_slots: int) -> None:
        if tuple(initial_votes.shape) != (n_slots, self.S, self.R):
            raise ValueError(
                f"initial_votes is {tuple(initial_votes.shape)}, expected "
                f"[T={n_slots}, S={self.S}, R={self.R}]"
            )

    def slot_pipeline(
        self,
        initial_votes: torch.Tensor,  # i8[T, S, R] per-slot initial R1 votes
        alive: torch.Tensor,  # bool[S, R]
        n_slots: int,
        max_phases: int = 4,
        start_slot_index: int = 0,
    ) -> torch.Tensor:
        """Decide ``n_slots`` consecutive slots for all shards,
        ``max_phases`` phases each (one suffices fault-free; extra phases
        absorb split initial votes via the common coin). Returns decided
        i8[T, S]; ABSENT only where a shard failed to decide in time.
        ``start_slot_index`` offsets the slot numbering (and therefore the
        coin stream)."""
        self._check(initial_votes, n_slots)
        base = torch.full((self.S,), start_slot_index, dtype=I32, device=self.device)
        return self._decide_slots(initial_votes, alive, base, max_phases)

    def slot_window(
        self,
        initial_votes: torch.Tensor,  # i8[T, S, R] per-slot initial R1 votes
        alive: torch.Tensor,  # bool[S, R]
        base_slots: torch.Tensor,  # i32[S] PER-SHARD first slot number
        *,
        n_slots: int,
        max_phases: int = 4,
    ) -> torch.Tensor:
        """:meth:`slot_pipeline` with per-shard slot numbering: window
        entry ``t`` of shard ``s`` runs as slot ``base_slots[s] + t``, so
        a shard's coin stream never depends on other shards' progress.
        Returns decided i8[T, S]."""
        self._check(initial_votes, n_slots)
        return self._decide_slots(initial_votes, alive, base_slots, max_phases)
