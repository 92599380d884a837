"""The batched weak-MVC phase driver: consensus as a tensor program.

The port of the reference's ``rabia_tpu/kernel/phase_driver.py``
(``ClusterKernel`` and the common coin). The weak-MVC transition relation
runs over ``S`` independent consensus instances ("shards") × ``R``
replicas at once: vote ledgers are ``int8[S, R, R]`` tensors
(receiver-major), the majority tally is a sum over the sender axis, the
round-2 tie-break is a common coin hashed from (seed, shard, slot,
phase), and crashes and partitions are boolean masks.

For CUDA tensors the protocol runs hand-written CUDA kernels:
``round_step``, ``run_rounds``, ``slot_pipeline`` and
``slot_pipeline_wide`` the kernels of
:mod:`rabia_tpu_torch.kernel.cluster_round` (a chain of rounds, or a
whole window of slots, in one launch), the fused fault-free entries those
of :mod:`rabia_tpu_torch.kernel.fused_window` and
:mod:`rabia_tpu_torch.kernel.packed_window`, and ``start_slot`` one
launch of the round kernels' ``start_slot`` entry (``init_state`` stays
tensor ops). For CPU tensors they run the
plain PyTorch versions (``round_step_plain``, ``run_rounds_plain``,
``slot_pipeline_plain``, ``slot_pipeline_wide_plain``,
``start_slot_plain``, the closed forms), which own the
semantics: the reference's ``lax.scan`` loops are Python loops there,
and its ``vmap`` over slots is a batch of shards written out
(``slot_pipeline_wide_plain``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rabia_tpu_torch.core.device import DeviceLike, resolve_device
from rabia_tpu_torch.core.types import ABSENT, V0, V1, VQUESTION, f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cluster_round, cuda_build, fused_window, node_kernel, packed_window

I8 = torch.int8
I32 = torch.int32
I64 = torch.int64

R1_WAIT = 0
R2_WAIT = 1

# ---------------------------------------------------------------------------
# Common coin
# ---------------------------------------------------------------------------
#
# A portable uint32 avalanche hash of (seed, shard, slot, phase): every
# replica, and every backend of the reference, evaluates the same bits.
# PyTorch's uint32 lacks shifts and compares, so the hash runs in int64
# masked to 32 bits after every step; each product stays below 2^63.

_GOLD = 0x9E3779B9  # 2^32 / golden ratio, the hash_combine offset
_M32 = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = (h * 0x21F0AAAD) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x735A2D97) & _M32
    h = h ^ (h >> 15)
    return h


def coin_threshold(p1: float) -> int:
    """uint32 acceptance threshold for coin probability ``p1``, rounded
    and clamped exactly as the reference does (bit-identity-critical)."""
    return min(int(p1 * 4294967296.0), 4294967295)


def _coin_bits(seed: int, shard, slot, phase, p1: float) -> torch.Tensor:
    """Common-coin values for (shard, slot, phase) triples (broadcast
    together); int8 V0/V1. Depends only on the seed and the triple."""
    shard, slot, phase = torch.broadcast_tensors(
        torch.as_tensor(shard), torch.as_tensor(slot), torch.as_tensor(phase)
    )
    h = torch.full(shard.shape, (seed & _M32) ^ _GOLD, dtype=I64, device=shard.device)
    h = _mix32(h)
    h = _mix32(h ^ ((shard.to(I64) + _GOLD) & _M32))
    h = _mix32(h ^ ((slot.to(I64) + _GOLD) & _M32))
    h = _mix32(h ^ ((phase.to(I64) + _GOLD) & _M32))
    return torch.where(h < coin_threshold(p1), V1, V0).to(I8)


def _wrap_i32(x: int) -> int:
    """``x`` as int32 arithmetic wraps it (the reference's int32 slots)."""
    return (int(x) + 2**31) % 2**32 - 2**31


def device_coin(seed: int, shard: int, slot: int, phase: int, p1: float = 0.5) -> int:
    """Scalar host-side view of the common coin."""
    one = lambda v: torch.tensor([v], dtype=I64)  # noqa: E731
    return int(_coin_bits(seed, one(shard), one(slot), one(phase), p1)[0])


def _tally(ledger: torch.Tensor):
    """Count V0/V1/V? and total present votes over the last (sender) axis."""
    c0 = (ledger == V0).sum(-1, dtype=I32)
    c1 = (ledger == V1).sum(-1, dtype=I32)
    cq = (ledger == VQUESTION).sum(-1, dtype=I32)
    return c0, c1, cq, c0 + c1 + cq


def delivery_masks(shape, n_rounds: int, generator: torch.Generator, device,
                   p_deliver: float = 1.0, link_mask: Optional[torch.Tensor] = None):
    """The delivery masks of ``run_rounds``: None (full delivery), the
    static ``link_mask`` for every round, or ``bool[n_rounds, *shape]``
    drawn as ``run_rounds_plain`` draws them (one Bernoulli draw of
    ``shape`` a round from ``generator``) and anded with the link mask."""
    base_link = None if link_mask is None else torch.broadcast_to(link_mask, shape)
    if p_deliver >= 1.0:
        return base_link
    masks = torch.stack([
        torch.rand(shape, generator=generator, device=device) < p_deliver
        for _ in range(n_rounds)
    ])
    if base_link is not None:
        masks &= base_link
    return masks


def _pick(cond_a, a: int, cond_b, b: int, other) -> torch.Tensor:
    """int8 ``a`` where cond_a, else ``b`` where cond_b, else ``other``."""
    other = torch.as_tensor(other, dtype=I8, device=cond_a.device)
    return torch.where(cond_a, a, torch.where(cond_b, b, other)).to(I8)


# ---------------------------------------------------------------------------
# Cluster-simulation kernel
# ---------------------------------------------------------------------------


class ClusterState(NamedTuple):
    """All-replica consensus state for S shards × R replicas."""

    slot: torch.Tensor  # i32[S]   decision-slot counter (host-advanced)
    phase: torch.Tensor  # i32[S,R] weak-MVC phase within the slot
    stage: torch.Tensor  # i8[S,R]  R1_WAIT | R2_WAIT
    my_r1: torch.Tensor  # i8[S,R]  this replica's round-1 vote (current phase)
    my_r2: torch.Tensor  # i8[S,R]  round-2 vote (ABSENT until cast)
    # previous phase's votes, re-offered to stragglers one phase behind
    prev_r1: torch.Tensor  # i8[S,R]
    prev_r2: torch.Tensor  # i8[S,R]
    led1: torch.Tensor  # i8[S,R,R] round-1 ledger [shard, receiver, sender]
    led2: torch.Tensor  # i8[S,R,R]
    decided: torch.Tensor  # i8[S]  slot decision (ABSENT until first decider)
    decided_phase: torch.Tensor  # i32[S] min MVC phase of any decision (or -1)
    done: torch.Tensor  # bool[S,R] replica knows the decision
    active: torch.Tensor  # bool[S] shard has a live instance this slot


class ClusterKernel:
    """Whole-cluster weak-MVC simulation over S shards × R replicas.

    Runs on ``device`` (CUDA unless the caller passes another; raises
    when CUDA is asked for and absent). ``shard_base`` is the global
    index of its first shard, the common coin's shard coordinate: 0 for a
    whole cluster, the block's first shard for one block of a mesh's shard
    axis (:class:`~rabia_tpu_torch.parallel.ShardedClusterKernel`)."""

    def __init__(
        self,
        n_shards: int,
        n_replicas: int,
        *,
        coin_p1: float = 0.5,
        seed: int = 0,
        device: DeviceLike = None,
        shard_base: int = 0,
    ):
        self.device = resolve_device(device)
        self.S = int(n_shards)
        self.R = int(n_replicas)
        self.quorum = quorum_size(self.R)
        self.f1 = f_plus_1(self.R)
        self.coin_p1 = float(coin_p1)
        self.seed = int(seed)
        self.shard_base = int(shard_base)
        self._shard_idx = torch.arange(
            self.shard_base, self.shard_base + self.S, dtype=I32, device=self.device)
        self._eye = torch.eye(self.R, dtype=torch.bool, device=self.device)

    # -- state constructors -------------------------------------------------

    def _init(self, S: int) -> ClusterState:
        R, dev = self.R, self.device

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return ClusterState(
            slot=full((S,), 0, I32),
            phase=full((S, R), 0, I32),
            stage=full((S, R), R1_WAIT, I8),
            my_r1=full((S, R), ABSENT, I8),
            my_r2=full((S, R), ABSENT, I8),
            prev_r1=full((S, R), ABSENT, I8),
            prev_r2=full((S, R), ABSENT, I8),
            led1=full((S, R, R), ABSENT, I8),
            led2=full((S, R, R), ABSENT, I8),
            decided=full((S,), ABSENT, I8),
            decided_phase=full((S,), -1, I32),
            done=full((S, R), False, torch.bool),
            active=full((S,), False, torch.bool),
        )

    def init_state(self) -> ClusterState:
        return self._init(self.S)

    def start_slot(
        self, state: ClusterState, shard_mask: torch.Tensor, initial_votes: torch.Tensor
    ) -> ClusterState:
        """Begin a new decision slot on masked shards with the given initial
        round-1 votes (V1 where the replica holds the proposal, V0 where it
        gave up waiting). A state on a card takes one launch of the round
        kernels' ``start_slot`` entry, a CPU state :meth:`start_slot_plain`."""
        if state.slot.device.type == "cuda":
            votes = torch.broadcast_to(initial_votes, (self.S, self.R)).to(I8).contiguous()
            mask = torch.broadcast_to(shard_mask, (self.S,)).to(torch.bool).contiguous()
            return ClusterState(*cluster_round.CLUSTER_ROUND.start_slot(
                [t.contiguous() for t in state], mask, votes))
        return self.start_slot_plain(state, shard_mask, initial_votes)

    def start_slot_plain(
        self, state: ClusterState, shard_mask: torch.Tensor, initial_votes: torch.Tensor
    ) -> ClusterState:
        """:meth:`start_slot` in plain PyTorch, on any device."""
        m = shard_mask
        mr = m[:, None]
        votes = initial_votes.to(I8)
        led1_fresh = torch.where(self._eye[None], votes[:, :, None], ABSENT).to(I8)
        return ClusterState(
            slot=torch.where(m, state.slot + state.active.to(I32), state.slot),
            phase=torch.where(mr, 0, state.phase),
            stage=torch.where(mr, R1_WAIT, state.stage),
            my_r1=torch.where(mr, votes, state.my_r1),
            my_r2=torch.where(mr, ABSENT, state.my_r2),
            prev_r1=torch.where(mr, ABSENT, state.prev_r1),
            prev_r2=torch.where(mr, ABSENT, state.prev_r2),
            led1=torch.where(mr[:, :, None], led1_fresh, state.led1),
            led2=torch.where(mr[:, :, None], ABSENT, state.led2),
            decided=torch.where(m, ABSENT, state.decided),
            decided_phase=torch.where(m, -1, state.decided_phase),
            done=state.done & ~mr,
            active=state.active | m,
        )

    # -- the synchronous round step ----------------------------------------

    def round_step(
        self,
        state: ClusterState,
        alive: torch.Tensor,  # bool[S,R] (or broadcastable [R])
        deliver: torch.Tensor,  # bool[S,R,R]  [shard, sender, receiver]
    ) -> ClusterState:
        """One synchronous communication round for every shard at once:
        (1) deliver outstanding votes under the mask (a sender's current
        votes are re-offered every round), (2) run every enabled R1→R2 and
        R2→advance transition, (3) propagate decisions. A state on a card
        takes one launch of the round kernel, a CPU state
        :meth:`round_step_plain`."""
        if state.slot.device.type == "cuda":
            d = torch.broadcast_to(deliver, (self.S, self.R, self.R))
            return self._rounds_on_card(state, alive, d, 1)
        return self.round_step_plain(state, alive, deliver)

    def round_step_plain(self, state: ClusterState, alive, deliver) -> ClusterState:
        """:meth:`round_step` in plain PyTorch, on any device."""
        return self._round(state, alive, deliver, self._shard_idx)

    def _kernel_args(self) -> dict:
        return dict(quorum=self.quorum, f1=self.f1, seed=self.seed,
                    threshold=coin_threshold(self.coin_p1), shard0=self.shard_base)

    def _rounds_on_card(self, state: ClusterState, alive, masks, n: int) -> ClusterState:
        """n rounds in one launch of the round kernel; ``masks`` as
        :meth:`ClusterRoundKernel.rounds` takes them."""
        alive = torch.broadcast_to(alive, (self.S, self.R)).to(torch.bool).contiguous()
        if masks is not None:
            masks = masks.to(torch.bool).contiguous()
        fields = [t.contiguous() for t in state]
        return ClusterState(*cluster_round.CLUSTER_ROUND.rounds(
            fields, alive, masks, n, **self._kernel_args()))

    def _round(self, state, alive, deliver, shard_idx) -> ClusterState:
        """:meth:`round_step` over however many shards ``state`` holds;
        ``shard_idx`` gives each row's shard number for the coin."""
        R, Q, F1 = self.R, self.quorum, self.f1
        S = state.slot.shape[0]
        alive = torch.broadcast_to(alive, (S, R))
        deliver = torch.broadcast_to(deliver, (S, R, R))
        eye = self._eye[None]

        # ---- 1. delivery ------------------------------------------------
        # link[s,i,j]: sender i's traffic reaches receiver j this round
        link = deliver & alive[:, :, None] & alive[:, None, :] & ~eye
        same_phase = state.phase[:, :, None] == state.phase[:, None, :]  # [s,i,j]
        ahead_one = state.phase[:, :, None] == state.phase[:, None, :] + 1
        rcv_open = ~state.done[:, None, :]  # decided receivers stop listening
        offer1 = link & rcv_open & (
            (same_phase & (state.my_r1 != ABSENT)[:, :, None])
            | (ahead_one & (state.prev_r1 != ABSENT)[:, :, None])
        )
        offer2 = link & rcv_open & (
            (
                same_phase
                & (state.stage == R2_WAIT)[:, :, None]
                & (state.my_r2 != ABSENT)[:, :, None]
            )
            | (ahead_one & (state.prev_r2 != ABSENT)[:, :, None])
        )
        val1 = torch.where(same_phase, state.my_r1[:, :, None], state.prev_r1[:, :, None])
        val2 = torch.where(same_phase, state.my_r2[:, :, None], state.prev_r2[:, :, None])
        # ledgers are [s, receiver, sender]: transpose the offer/value grids
        led1 = torch.where(
            (state.led1 == ABSENT) & offer1.transpose(1, 2), val1.transpose(1, 2), state.led1
        )
        led2 = torch.where(
            (state.led2 == ABSENT) & offer2.transpose(1, 2), val2.transpose(1, 2), state.led2
        )

        # ---- 2. transitions (on pre-step stages) ------------------------
        enabled = state.active[:, None] & alive & ~state.done

        # R1 -> R2: with a quorum of round-1 votes, vote v on an all-v
        # majority, else V?
        c0, c1, _, tot1 = _tally(led1)
        cast_r2 = enabled & (state.stage == R1_WAIT) & (tot1 >= Q)
        r2_val = _pick(c1 >= Q, V1, c0 >= Q, V0, VQUESTION)
        my_r2 = torch.where(cast_r2, r2_val, state.my_r2)
        stage = torch.where(cast_r2, R2_WAIT, state.stage)
        led2 = torch.where(cast_r2[:, :, None] & eye, my_r2[:, :, None], led2)

        # R2 -> advance: decide on f+1 agreeing non-? votes; else adopt any
        # non-? vote; else flip the common coin
        d0, d1, _, tot2 = _tally(led2)
        advance = enabled & (state.stage == R2_WAIT) & (tot2 >= Q)
        decide1 = d1 >= F1
        decide0 = d0 >= F1
        coin = _coin_bits(
            self.seed, shard_idx[:, None], state.slot[:, None], state.phase, self.coin_p1
        )
        next_v = _pick(decide1, V1, decide0, V0, _pick(d1 > 0, V1, d0 > 0, V0, coin))
        newly_decided = advance & (decide1 | decide0)
        dec_vals = torch.where(newly_decided, torch.where(decide1, V1, V0), -1).to(I8)
        shard_dec = dec_vals.amax(1)  # -1 if no decider this round
        decided = torch.where(
            (state.decided == ABSENT) & (shard_dec >= 0), shard_dec, state.decided
        )
        # decided_phase = minimum MVC phase at which any replica decided
        intmax = torch.iinfo(I32).max
        round_min = torch.where(newly_decided, state.phase, intmax).amin(1)
        existing = torch.where(state.decided_phase < 0, intmax, state.decided_phase)
        merged = torch.minimum(existing, round_min)
        decided_phase = torch.where(merged == intmax, -1, merged)
        done = state.done | newly_decided

        phase = torch.where(advance, state.phase + 1, state.phase)
        prev_r1 = torch.where(advance, state.my_r1, state.prev_r1)
        prev_r2 = torch.where(advance, my_r2, state.prev_r2)
        my_r1 = torch.where(advance, next_v, state.my_r1)
        stage = torch.where(advance, R1_WAIT, stage)
        my_r2 = torch.where(advance, ABSENT, my_r2)
        adv3 = advance[:, :, None]
        led1 = torch.where(
            adv3, torch.where(eye, next_v[:, :, None], ABSENT).to(I8), led1
        )
        led2 = torch.where(adv3, ABSENT, led2)

        # ---- 3. decision propagation ------------------------------------
        # any done replica whose link reaches an undecided one informs it
        informed = ((done & alive)[:, :, None] & deliver).any(1)
        adopt = (
            state.active[:, None] & alive & ~done & informed & (decided != ABSENT)[:, None]
        )
        done = done | adopt

        return ClusterState(
            slot=state.slot,
            phase=phase,
            stage=stage,
            my_r1=my_r1,
            my_r2=my_r2,
            prev_r1=prev_r1,
            prev_r2=prev_r2,
            led1=led1,
            led2=led2,
            decided=decided,
            decided_phase=decided_phase,
            done=done,
            active=state.active,
        )

    # -- multi-round / multi-slot drivers ----------------------------------

    def run_rounds(
        self,
        state: ClusterState,
        alive: torch.Tensor,
        n_rounds: int,
        generator: torch.Generator,
        p_deliver: float = 1.0,
        link_mask: Optional[torch.Tensor] = None,
    ) -> ClusterState:
        """Run ``n_rounds`` round_steps, drawing a fresh Bernoulli delivery
        mask per round from ``generator`` (on this kernel's device) ∧ an
        optional static link mask (partitions). The generator seeds
        delivery only; protocol coins come from the kernel's seed. On a
        card the masks are drawn as :meth:`run_rounds_plain` draws them
        (one draw a round), stacked, and the rounds run in one launch of
        the round kernel."""
        if state.slot.device.type != "cuda":
            return self.run_rounds_plain(state, alive, n_rounds, generator, p_deliver, link_mask)
        if n_rounds == 0:
            return state
        masks = delivery_masks((self.S, self.R, self.R), n_rounds, generator, self.device,
                               p_deliver, link_mask)
        return self._rounds_on_card(state, alive, masks, n_rounds)

    def rounds_masked(
        self, state: ClusterState, alive: torch.Tensor, masks: Optional[torch.Tensor], n: int
    ) -> ClusterState:
        """n rounds under ``masks`` as :func:`delivery_masks` gives them
        (None: full delivery; ``[S, R, R]``: one mask for every round;
        ``[n, S, R, R]``: round k's k-th). A state on a card takes one
        launch of the round kernel, a CPU state n ``round_step_plain``."""
        if state.slot.device.type == "cuda":
            return self._rounds_on_card(state, alive, masks, n) if n else state
        full = torch.ones((self.S, self.R, self.R), dtype=torch.bool, device=self.device)
        for k in range(n):
            d = full if masks is None else masks if masks.dim() == 3 else masks[k]
            state = self.round_step_plain(state, alive, d)
        return state

    def run_rounds_plain(
        self,
        state: ClusterState,
        alive: torch.Tensor,
        n_rounds: int,
        generator: torch.Generator,
        p_deliver: float = 1.0,
        link_mask: Optional[torch.Tensor] = None,
    ) -> ClusterState:
        """:meth:`run_rounds` in plain PyTorch, one round at a time."""
        S, R = self.S, self.R
        shape = (S, R, R)
        base_link = (
            torch.ones(shape, dtype=torch.bool, device=self.device)
            if link_mask is None
            else torch.broadcast_to(link_mask, shape)
        )
        for _ in range(n_rounds):
            d = base_link
            if p_deliver < 1.0:
                draw = torch.rand(shape, generator=generator, device=self.device)
                d = base_link & (draw < p_deliver)
            state = self.round_step_plain(state, alive, d)
        return state

    def _check_slots(self, votes: torch.Tensor, n_slots: int, axis: int = 0) -> None:
        if votes.shape[axis] != n_slots:
            raise ValueError(f"votes carry {votes.shape[axis]} slots, n_slots={n_slots}")

    def slot_pipeline(
        self,
        initial_votes: torch.Tensor,  # i8[T, S, R] per-slot initial R1 votes
        alive: torch.Tensor,  # bool[S,R]
        n_slots: int,
        rounds_per_slot: int = 2,
        start_slot_index: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Decide ``n_slots`` consecutive slots for all S shards: one slot
        after another, ``rounds_per_slot`` full-delivery rounds each; slot
        t is ``start_slot_index + t`` in int32 (it wraps, as the
        reference's does). Returns ``(decided i8[T, S], decided_phase
        i32[T, S])``. This is the semantics owner of the fused entries.
        Votes on a card take one launch of the slot-pipeline kernel (slots
        are independent: ``start_slot`` resets every field, and a fresh
        slot's full-delivery rounds collapse to a rule on its vote counts,
        ``csrc/cluster_round.cuh``), CPU votes
        :meth:`slot_pipeline_plain`."""
        self._check_slots(initial_votes, n_slots)
        if initial_votes.device.type == "cuda":
            return self._pipeline_on_card(initial_votes, alive, rounds_per_slot, start_slot_index)
        return self.slot_pipeline_plain(
            initial_votes, alive, n_slots, rounds_per_slot, start_slot_index)

    def _pipeline_on_card(self, votes, alive, rounds_per_slot: int, start_slot_index: int):
        alive = torch.broadcast_to(alive, (self.S, self.R)).to(torch.bool).contiguous()
        return cluster_round.CLUSTER_ROUND.slot_pipeline(
            votes.to(I8).contiguous(), alive, base=_wrap_i32(start_slot_index),
            rounds=rounds_per_slot, **self._kernel_args())

    def slot_pipeline_plain(
        self,
        initial_votes: torch.Tensor,  # i8[T, S, R]
        alive: torch.Tensor,  # bool[S,R]
        n_slots: int,
        rounds_per_slot: int = 2,
        start_slot_index: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`slot_pipeline` in plain PyTorch, one slot and one round
        at a time."""
        self._check_slots(initial_votes, n_slots)
        S, R = self.S, self.R
        full = torch.ones((S, R, R), dtype=torch.bool, device=self.device)
        every = torch.ones((S,), dtype=torch.bool, device=self.device)
        decided = torch.empty((n_slots, S), dtype=I8, device=self.device)
        dphase = torch.empty((n_slots, S), dtype=I32, device=self.device)
        state = self.init_state()
        for t in range(n_slots):
            st = self.start_slot_plain(state, every, initial_votes[t])
            st = st._replace(slot=torch.full_like(st.slot, _wrap_i32(start_slot_index + t)))
            for _ in range(rounds_per_slot):
                st = self.round_step_plain(st, alive, full)
            decided[t] = st.decided
            dphase[t] = st.decided_phase
            state = st
        return decided, dphase

    def slot_pipeline_wide(
        self,
        initial_votes: torch.Tensor,  # i8[T, S, R] per-slot initial R1 votes
        alive: torch.Tensor,  # bool[S,R]
        n_slots: int,
        rounds_per_slot: int = 2,
        start_slot_index: int = 0,
        block: int = 256,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`slot_pipeline` with ``block`` slots evaluated together.

        Consecutive slots of one shard are independent instances (each
        starts from fresh state), so a block of B slots runs as one state
        of B*S shards, each row carrying its own shard number and slot for
        the coin. Decisions are bit-identical to :meth:`slot_pipeline`.
        ``n_slots`` must be a multiple of ``block``. Votes on a card take
        the slot-pipeline kernel's one launch for the whole window, as
        :meth:`slot_pipeline`'s do, CPU votes
        :meth:`slot_pipeline_wide_plain`."""
        if n_slots % block:
            raise ValueError(f"n_slots {n_slots} not a multiple of block {block}")
        self._check_slots(initial_votes, n_slots)
        if initial_votes.device.type == "cuda":
            return self._pipeline_on_card(initial_votes, alive, rounds_per_slot, start_slot_index)
        return self.slot_pipeline_wide_plain(
            initial_votes, alive, n_slots, rounds_per_slot, start_slot_index, block)

    def slot_pipeline_wide_plain(
        self,
        initial_votes: torch.Tensor,  # i8[T, S, R]
        alive: torch.Tensor,  # bool[S,R]
        n_slots: int,
        rounds_per_slot: int = 2,
        start_slot_index: int = 0,
        block: int = 256,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`slot_pipeline_wide` in plain PyTorch: ``block`` slots a
        step, as one state of block*S shards."""
        if n_slots % block:
            raise ValueError(f"n_slots {n_slots} not a multiple of block {block}")
        self._check_slots(initial_votes, n_slots)
        S, R, B = self.S, self.R, block
        dev = self.device
        rows = B * S
        shard_idx = self._shard_idx.repeat(B)
        alive_rows = torch.broadcast_to(alive, (S, R)).repeat(B, 1)
        full = torch.ones((rows, R, R), dtype=torch.bool, device=dev)
        every = torch.ones((rows,), dtype=torch.bool, device=dev)
        state0 = self._init(rows)
        decided = torch.empty((n_slots, S), dtype=I8, device=dev)
        dphase = torch.empty((n_slots, S), dtype=I32, device=dev)
        for c in range(n_slots // B):
            votes = initial_votes[c * B:(c + 1) * B].reshape(rows, R)
            first = start_slot_index + c * B
            slots = torch.arange(first, first + B, dtype=I32, device=dev)
            st = self.start_slot_plain(state0, every, votes)
            st = st._replace(slot=slots.repeat_interleave(S))
            for _ in range(rounds_per_slot):
                st = self._round(st, alive_rows, full, shard_idx)
            decided[c * B:(c + 1) * B] = st.decided.reshape(B, S)
            dphase[c * B:(c + 1) * B] = st.decided_phase.reshape(B, S)
        return decided, dphase

    def slot_pipeline_fused(
        self,
        initial_votes: torch.Tensor,  # i8[T, S, R]
        alive: torch.Tensor,  # bool[S,R] (or broadcastable [R])
        n_slots: int,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Fault-free fast path, bit-identical to
        ``slot_pipeline(votes, alive, T)`` at the default two rounds per
        slot: the closed-form quorum tally. CUDA tensors run the CUDA
        kernel that reads the ``[T, S, R]`` votes in place; CPU tensors
        the plain PyTorch closed form."""
        self._check_slots(initial_votes, n_slots)
        alive = torch.broadcast_to(alive, (self.S, self.R)).contiguous()
        return fused_window.window(initial_votes, alive, self.quorum)

    def slot_pipeline_fused_rmajor(
        self,
        votes_rm: torch.Tensor,  # i8[R, T, S] — replica-major planes
        alive_rm: torch.Tensor,  # bool[R, S] (or broadcastable [R, 1])
        n_slots: int,
        want_phase: bool = True,
    ):
        """:meth:`slot_pipeline_fused` on replica-major votes, the entry
        for producers that build the vote tensor themselves: no relayout
        of the votes. ``want_phase=False`` skips the i32 phase plane
        (derivable: 0 iff decided) and returns only the decisions."""
        self._check_slots(votes_rm, n_slots, axis=1)
        if votes_rm.shape[0] != self.R or votes_rm.shape[2] != self.S:
            raise ValueError(
                f"votes_rm is {tuple(votes_rm.shape)}, expected replica-major "
                f"[R={self.R}, T={n_slots}, S={self.S}]"
            )
        alive_rm = torch.broadcast_to(alive_rm, (self.R, self.S)).contiguous()
        return fused_window.window_rmajor(
            votes_rm, alive_rm, self.quorum, want_phase=want_phase
        )

    def slot_pipeline_fused_packed(
        self,
        packed_rm: torch.Tensor,  # i32[R, T, SW] — 16 votes/word, 2-bit codes
        alive_packed: torch.Tensor,  # i32[R, SW] — lane-LSB alive bits
        n_slots: int,
    ) -> torch.Tensor:
        """:meth:`slot_pipeline_fused_rmajor` on word-packed votes
        (:mod:`packed_window`); returns packed decisions i32[T, SW]. CUDA
        tensors run the packed-window CUDA kernel, CPU tensors the plain
        version."""
        SW = packed_window.packed_width(self.S)
        self._check_slots(packed_rm, n_slots, axis=1)
        if packed_rm.shape[0] != self.R or packed_rm.shape[2] != SW:
            raise ValueError(
                f"packed_rm is {tuple(packed_rm.shape)}, expected packed "
                f"replica-major [R={self.R}, T={n_slots}, SW={SW}]"
            )
        return packed_window.window(packed_rm, alive_packed, self.quorum)


# ---------------------------------------------------------------------------
# Per-node kernel (the host engine's device half)
# ---------------------------------------------------------------------------


class NodeState(NamedTuple):
    """One node's consensus state over its S shards."""

    slot: torch.Tensor  # i32[S]
    phase: torch.Tensor  # i32[S]
    stage: torch.Tensor  # i8[S]
    my_r1: torch.Tensor  # i8[S]
    my_r2: torch.Tensor  # i8[S]
    led1: torch.Tensor  # i8[S,R]  votes seen for current (slot, phase)
    led2: torch.Tensor  # i8[S,R]
    decided: torch.Tensor  # i8[S]
    done: torch.Tensor  # bool[S]
    active: torch.Tensor  # bool[S]


class NodeOutbox(NamedTuple):
    """What the host must transmit after a node_step ([S] planes; [K, S]
    from node_cycle)."""

    cast_r2: torch.Tensor  # bool — broadcast VoteRound2(phase, my_r2)
    r2_vals: torch.Tensor  # i8
    advanced: torch.Tensor  # bool — broadcast VoteRound1(phase+1, my_r1)
    new_r1: torch.Tensor  # i8
    new_phase: torch.Tensor  # i32
    newly_decided: torch.Tensor  # bool — broadcast Decision(slot, value)
    decided_vals: torch.Tensor  # i8


class NodePlanes(NamedTuple):
    """A tick's six input planes as a card's NodeKernel reads them: numpy
    views of its pinned plane buffer, which the host writes and the
    launch reads in place."""

    shard_mask: np.ndarray  # bool[S]
    slot_index: np.ndarray  # i32[S]
    initial_votes: np.ndarray  # i8[S]
    inbox_r1: np.ndarray  # i8[S,R]
    inbox_r2: np.ndarray  # i8[S,R]
    decision_in: np.ndarray  # i8[S]


class _NodeFetch:
    """A node kernel's fetch in flight: ``result()`` waits for the
    launch's event (None: nothing to wait for) and returns ``(NodeState,
    NodeOutbox or None)`` of numpy arrays."""

    __slots__ = ("_event", "_arrays")

    def __init__(self, event, arrays) -> None:
        self._event, self._arrays = event, arrays

    def result(self):
        if self._event is not None:
            self._event.synchronize()
        return self._arrays


class NodeKernel:
    """One node's per-shard weak-MVC step: ledgers in, transitions out.

    The host engine owns message routing and slot lifecycle; this kernel
    owns the per-phase math for all S shards at once. Runs on ``device``
    (CUDA unless the caller passes another; raises when CUDA is asked for
    and absent). On a card ``start_slots``, ``node_step`` and
    ``node_cycle`` are one launch each of ``csrc/node_kernel.cu``
    (:mod:`rabia_tpu_torch.kernel.node_kernel`), on the CPU the plain
    versions (``start_slots_plain``, ``node_step_plain``,
    ``node_cycle_plain``). Both are functional: a launch writes its state
    and outbox into a new tick buffer, which becomes the kernel's newest.
    With ``donate=True`` (the reference's ``donate_argnums``) a launch
    given the kernel's newest state updates it in place, which overwrites
    the outbox of the launch before; the caller must not use the state it
    gave. The CPU ignores ``donate``.

    On a card the tick's planes are host arrays: the launch reads them
    from the kernel's pinned plane buffer (:attr:`planes`, views the
    caller may write into between launches; other host arrays are written
    there first, after the previous launch has read the buffer), and
    writes the mirrored state fields and the outbox rows into a pinned
    host image, which :meth:`fetch` returns once the launch's event has
    completed: nothing is copied, and :attr:`mapped_bytes` counts what
    the launches moved over the link. A fetched array is a view of the
    image, valid until the next launch."""

    def __init__(
        self,
        n_shards: int,
        n_replicas: int,
        me: int,
        *,
        coin_p1: float = 0.5,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.S = int(n_shards)
        self.R = int(n_replicas)
        self.me = int(me)
        self.quorum = quorum_size(self.R)
        self.f1 = f_plus_1(self.R)
        self.coin_p1 = float(coin_p1)
        self.seed = int(seed)
        self._shard_idx = torch.arange(self.S, dtype=I32, device=self.device)
        self._own = torch.arange(self.R, device=self.device)[None, :] == self.me
        # (buffer, TickLayout) of the newest state made on a card
        self._tick: Optional[tuple[torch.Tensor, node_kernel.TickLayout]] = None
        self.fetch_bytes = 0  # bytes fetch copied from the card: none, the image is written in place
        self.mapped_bytes = 0  # bytes the launches read and wrote over the link
        self.planes: Optional[NodePlanes] = None
        if self.device.type == "cuda":
            self._plane_layout = node_kernel.PlaneLayout(self.S, self.R)
            self._plane_buf = torch.empty(self._plane_layout.nbytes, dtype=torch.uint8,
                                          pin_memory=True)
            self.planes = NodePlanes(*self._plane_layout.views(self._plane_buf.numpy()))
            for p in (self.planes.inbox_r1, self.planes.inbox_r2, self.planes.decision_in):
                p.fill(ABSENT)
            # (buffer, TickLayout, numpy view) of the host image
            self._image: Optional[tuple] = None
            self._event = None  # the newest launch's, recorded after it
            # the in-place launches, checked and bound once for their
            # buffers (a tick that opens slots and one that does not):
            # key -> (Prepared, its outbox views); and the image's views
            # that fetch returns, by outbox rows
            self._prepared: dict = {}
            self._image_views: dict = {}
            self._newest: tuple = (None, None)  # what the newest launch returned

    def _on_card(self, state) -> bool:
        return state.slot.device.type == "cuda"

    def _new_tick(self, K: int) -> tuple[torch.Tensor, node_kernel.TickLayout]:
        """A new tick buffer (contents undefined) for K steps, now the
        kernel's newest."""
        layout = node_kernel.TickLayout(self.S, self.R, K)
        buf = torch.empty(layout.nbytes, dtype=torch.uint8, device=self.device)
        self._tick = (buf, layout)
        return self._tick

    def _in_tick(self, fields) -> bool:
        """True when ``fields`` are the state views of the newest tick
        buffer."""
        return self._tick is not None and self._tick[1].owns(self._tick[0], fields)

    def _wait(self) -> None:
        """Block until the newest launch has completed: it no longer reads
        the plane buffer and has written the image."""
        if self._event is not None:
            self._event.synchronize()

    def _image_for(self, K: int) -> tuple:
        """The host image, with room for K outbox rows: allocated anew
        (pinned) only when K grows past it."""
        if self._image is None or self._image[1].K < K:
            self._wait()  # the old image may still be written
            layout = node_kernel.TickLayout(self.S, self.R, max(K, 1))
            buf = torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=True)
            self._image = (buf, layout, buf.numpy())
            self._image_views = {}
        return self._image

    def init_state(self) -> NodeState:
        S, R, dev = self.S, self.R, self.device
        inits = (0, 0, R1_WAIT, ABSENT, ABSENT, ABSENT, ABSENT, ABSENT, False, False)
        if dev.type == "cuda":
            buf, layout = self._new_tick(1)
            st = NodeState(*layout.state_views(buf))
            for t, v in zip(st, inits):
                t.fill_(v)
            self._newest = (None, None)
            _, image, host = self._image_for(1)
            self._wait()
            for a, v in zip(image.state_views(host), inits):
                a.fill(v)
            return st

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return NodeState(
            slot=full((S,), 0, I32),
            phase=full((S,), 0, I32),
            stage=full((S,), R1_WAIT, I8),
            my_r1=full((S,), ABSENT, I8),
            my_r2=full((S,), ABSENT, I8),
            led1=full((S, R), ABSENT, I8),
            led2=full((S, R), ABSENT, I8),
            decided=full((S,), ABSENT, I8),
            done=full((S,), False, torch.bool),
            active=full((S,), False, torch.bool),
        )

    # -- the entry points: one launch on a card, the plain version on the CPU

    def start_slots(
        self, state: NodeState, shard_mask, slot_index, initial_votes, *, donate: bool = False
    ) -> NodeState:
        """Open a slot on the masked shards: ``slot_index[s]`` at phase 0,
        ``initial_votes[s]`` as the round-1 vote (in the node's own cell of
        led1)."""
        if self._on_card(state):
            st, _ = self._launch("start_slots", state, shard_mask, slot_index, initial_votes,
                                 None, None, None, 0, donate)
            return st
        return self.start_slots_plain(state, shard_mask, slot_index, initial_votes)

    def node_step(
        self, state: NodeState, inbox_r1, inbox_r2, decision_in, *, donate: bool = False
    ) -> tuple[NodeState, NodeOutbox]:
        """Consume routed inboxes (i8[S,R] votes for the current (slot,
        phase), ABSENT elsewhere; ``decision_in`` i8[S] ABSENT or an
        adopted decision), run the enabled transitions on every shard."""
        if self._on_card(state):
            st, ob = self._launch("node_step", state, None, None, None, inbox_r1, inbox_r2,
                                  decision_in, 1, donate)
            return st, NodeOutbox(*(p[0] for p in ob))
        return self.node_step_plain(state, inbox_r1, inbox_r2, decision_in)

    def node_cycle(
        self,
        state: NodeState,
        shard_mask,  # bool[S] slots to (re)start this tick, or None: none
        slot_index,  # i32[S]
        initial_votes,  # i8[S]
        inbox_r1,  # i8[S,R]
        inbox_r2,  # i8[S,R]
        decision_in,  # i8[S]
        n_steps: int,
        *,
        donate: bool = False,
    ) -> tuple[NodeState, NodeOutbox]:
        """One dispatch for a whole engine tick: start newly opened slots,
        then chain ``n_steps`` node_steps (inboxes consumed by the first;
        later substeps cascade stage transitions on ledger-resident votes).
        Returns the final state and a NodeOutbox of ``[n_steps, S]``
        planes. On a card a mask of None opens no slot (and the open
        planes are not read)."""
        if self._on_card(state):
            return self._launch("node_cycle", state, shard_mask, slot_index, initial_votes,
                                inbox_r1, inbox_r2, decision_in, int(n_steps), donate)
        return self.node_cycle_plain(state, shard_mask, slot_index, initial_votes, inbox_r1,
                                     inbox_r2, decision_in, n_steps)

    def _stage_planes(self, given) -> list[bool]:
        """The tick's planes (``PLANE_FIELDS``' order, None where absent)
        in the pinned plane buffer: one of its views (:attr:`planes`) is
        taken as it is, another host array written into it (after the
        newest launch has read it). Returns which planes are present."""
        waited = False
        for x, view in zip(given, self.planes):
            if x is None or x is view:
                continue
            if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                raise ValueError(f"on a card the node kernel reads its planes from pinned host "
                                 f"memory: pass host arrays, not a tensor on {x.device}")
            if not waited:
                self._wait()
                waited = True
            np.copyto(view, np.broadcast_to(np.asarray(x), view.shape), casting="unsafe")
        return [x is not None for x in given]

    def _launch(self, entry, state, mask, slot_index, init, ib1, ib2, dec, K: int,
                donate: bool):
        """One launch of the node kernel on the state's card; returns the
        state and outbox views of the tick buffer it wrote: the newest one
        in place when ``donate`` and the state lies there with room for K
        steps, else a new one. The planes come from the pinned plane
        buffer, the results also go to the host image, and one event marks
        the launch's end."""
        if self.device.type != "cuda":
            raise ValueError(f"a node kernel on {self.device} has no card to launch on")
        fields = list(state)
        present = tuple(self._stage_planes((mask, slot_index, init, ib1, ib2, dec)))
        in_place = donate and (state is self._newest[0] or self._in_tick(fields)) \
            and self._tick[1].K >= K
        if in_place:
            buf, layout = self._tick
        else:
            buf, layout = self._new_tick(K)
        image, image_layout, _ = self._image_for(K)
        key = (buf.data_ptr(), K, present, image.data_ptr())
        if in_place and key in self._prepared:
            prepared, outbox = self._prepared[key]
        else:
            out = fields if in_place else layout.state_views(buf)
            planes = layout.outbox_views(buf, K) if K else None
            prepared = node_kernel.NODE_CYCLE.prepare(
                fields, out, planes, self._plane_buf, self._plane_layout, present, image,
                image_layout, K, me=self.me, quorum=self.quorum, f1=self.f1, seed=self.seed,
                threshold=coin_threshold(self.coin_p1),
            )
            if planes is None:  # no steps: node_cycle's outbox has no rows
                planes = [torch.empty((0, self.S), dtype=dtype, device=self.device)
                          for _, dtype in node_kernel.OUTBOX_FIELDS]
            outbox = NodeOutbox(*planes)
            if in_place:  # reads and writes the tick buffer: the same launch next tick
                if any(k[0] != key[0] or k[3] != key[3] for k in self._prepared):
                    self._prepared = {}  # bound to an older tick buffer or image
                self._prepared[key] = (prepared, outbox)
            fields = out
        self.mapped_bytes += node_kernel.NODE_CYCLE.launch(entry, prepared)
        if self._event is None:
            self._event = torch.cuda.Event()
        self._event.record(cuda_build.current_stream(self.device)[1])
        self._newest = (NodeState(*fields), outbox)
        return self._newest

    def fetch(self, state: NodeState, outbox: Optional[NodeOutbox] = None):
        """``(state, outbox)`` as numpy arrays on the host (``outbox`` None
        when not given). On a card they must be the kernel's newest state
        and outbox: the arrays are views of the host image, which the
        launch wrote in place (the ledgers stay on the card: the state's
        led1 and led2 are None); a CPU state's arrays share its tensors'
        memory."""
        return self.fetch_start(state, outbox).result()

    def fetch_start(self, state: NodeState, outbox: Optional[NodeOutbox] = None) -> "_NodeFetch":
        """:meth:`fetch` in two halves: this returns at once, and
        ``result()`` of what it returns waits for the newest launch's
        event."""
        if not self._on_card(state):
            return _NodeFetch(None, (
                NodeState(*(t.numpy() for t in state)),
                None if outbox is None else NodeOutbox(*(t.numpy() for t in outbox))))
        newest = state is self._newest[0] and (outbox is None or outbox is self._newest[1])
        if not newest and (not self._in_tick(list(state)) or (outbox is not None and not all(
            p.data_ptr() == self._tick[0].data_ptr() + off
            for p, (off, _, _) in zip(outbox, self._tick[1].outbox)
        ))):
            raise ValueError("fetch takes the kernel's newest state and outbox on a card")
        rows = None if outbox is None else -1 if outbox[0].dim() == 1 else outbox[0].shape[0]
        views = self._image_views.get(rows)
        if views is None:
            _, layout, host = self._image
            st = NodeState(*(None if shape == "SR" else v for v, (_, _, shape) in zip(
                layout.state_views(host), node_kernel.STATE_FIELDS)))
            ob = None
            if rows is not None:
                planes = layout.outbox_views(host, 1 if rows == -1 else rows)
                ob = NodeOutbox(*(p[0] for p in planes) if rows == -1 else planes)
            views = self._image_views[rows] = (st, ob)
        return _NodeFetch(self._event, views)

    # -- the plain versions (any device)

    def start_slots_plain(self, state: NodeState, shard_mask, slot_index, initial_votes) -> NodeState:
        """:meth:`start_slots` in plain PyTorch."""
        dev = state.slot.device
        m = torch.as_tensor(shard_mask, device=dev).to(torch.bool)
        slot_index = torch.as_tensor(slot_index, device=dev).to(I32)
        votes = torch.as_tensor(initial_votes, device=dev).to(I8)
        own = self._own.to(dev)
        led1 = torch.where(
            m[:, None], torch.where(own, votes[:, None], ABSENT).to(I8), state.led1
        )
        return NodeState(
            slot=torch.where(m, slot_index, state.slot),
            phase=torch.where(m, 0, state.phase),
            stage=torch.where(m, R1_WAIT, state.stage),
            my_r1=torch.where(m, votes, state.my_r1),
            my_r2=torch.where(m, ABSENT, state.my_r2),
            led1=led1,
            led2=torch.where(m[:, None], ABSENT, state.led2),
            decided=torch.where(m, ABSENT, state.decided),
            done=state.done & ~m,
            active=state.active | m,
        )

    def node_cycle_plain(
        self, state: NodeState, shard_mask, slot_index, initial_votes, inbox_r1, inbox_r2,
        decision_in, n_steps: int,
    ) -> tuple[NodeState, NodeOutbox]:
        """:meth:`node_cycle` in plain PyTorch: start, then ``n_steps``
        steps, ABSENT inboxes after the first."""
        state = self.start_slots_plain(state, shard_mask, slot_index, initial_votes)
        dev = state.slot.device
        absent_sr = torch.full((self.S, self.R), ABSENT, dtype=I8, device=dev)
        absent_s = torch.full((self.S,), ABSENT, dtype=I8, device=dev)
        outs = []
        for k in range(int(n_steps)):
            first = k == 0
            state, ob = self.node_step_plain(
                state, inbox_r1 if first else absent_sr, inbox_r2 if first else absent_sr,
                decision_in if first else absent_s,
            )
            outs.append(ob)
        if not outs:
            return state, NodeOutbox(*(
                torch.empty((0, self.S), dtype=dtype, device=dev)
                for _, dtype in node_kernel.OUTBOX_FIELDS))
        return state, NodeOutbox(*(torch.stack(planes) for planes in zip(*outs)))

    def node_step_plain(
        self, state: NodeState, inbox_r1, inbox_r2, decision_in
    ) -> tuple[NodeState, NodeOutbox]:
        """:meth:`node_step` in plain PyTorch."""
        Q, F1 = self.quorum, self.f1
        dev = state.slot.device
        own = self._own.to(dev)
        inbox_r1 = torch.as_tensor(inbox_r1, device=dev).to(I8)
        inbox_r2 = torch.as_tensor(inbox_r2, device=dev).to(I8)
        decision_in = torch.as_tensor(decision_in, device=dev).to(I8)

        led1 = torch.where((state.led1 == ABSENT) & (inbox_r1 != ABSENT), inbox_r1, state.led1)
        led2 = torch.where((state.led2 == ABSENT) & (inbox_r2 != ABSENT), inbox_r2, state.led2)

        enabled = state.active & ~state.done

        c0, c1, _, tot1 = _tally(led1)
        cast_r2 = enabled & (state.stage == R1_WAIT) & (tot1 >= Q)
        r2_val = _pick(c1 >= Q, V1, c0 >= Q, V0, VQUESTION)
        my_r2 = torch.where(cast_r2, r2_val, state.my_r2)
        stage = torch.where(cast_r2, R2_WAIT, state.stage).to(I8)
        led2 = torch.where(cast_r2[:, None] & own, my_r2[:, None], led2)

        d0, d1, _, tot2 = _tally(led2)
        advance = enabled & (state.stage == R2_WAIT) & (tot2 >= Q)
        decide1 = d1 >= F1
        decide0 = d0 >= F1
        coin = _coin_bits(self.seed, self._shard_idx.to(dev), state.slot, state.phase, self.coin_p1)
        next_v = _pick(decide1, V1, decide0, V0, _pick(d1 > 0, V1, d0 > 0, V0, coin))
        newly_decided = advance & (decide1 | decide0)
        dec_val = torch.where(decide1, V1, V0).to(I8)

        # external decision adoption (Decision broadcast / sync)
        adopt = enabled & ~newly_decided & (decision_in != ABSENT)
        decided = torch.where(
            newly_decided, dec_val, torch.where(adopt, decision_in, state.decided)
        )
        done = state.done | newly_decided | adopt

        phase = torch.where(advance, state.phase + 1, state.phase)
        my_r1 = torch.where(advance, next_v, state.my_r1)
        stage = torch.where(advance, R1_WAIT, stage).to(I8)
        my_r2_out = my_r2
        my_r2 = torch.where(advance, ABSENT, my_r2).to(I8)
        led1 = torch.where(
            advance[:, None], torch.where(own, next_v[:, None], ABSENT).to(I8), led1
        )
        led2 = torch.where(advance[:, None], ABSENT, led2).to(I8)

        new_state = NodeState(
            slot=state.slot,
            phase=phase,
            stage=stage,
            my_r1=my_r1,
            my_r2=my_r2,
            led1=led1,
            led2=led2,
            decided=decided,
            done=done,
            active=state.active,
        )
        outbox = NodeOutbox(
            cast_r2=cast_r2,
            r2_vals=my_r2_out,
            advanced=advance,
            new_r1=my_r1,
            new_phase=phase,
            newly_decided=newly_decided,
            decided_vals=decided,
        )
        return new_state, outbox


# ---------------------------------------------------------------------------
# Wire phase packing: (slot, mvc_phase) <-> u64 sequence number
# ---------------------------------------------------------------------------

_MVC_BITS = 16


def pack_phase(slot: int, mvc_phase: int) -> int:
    """Encode (decision slot, weak-MVC phase) into a wire sequence number."""
    if mvc_phase >= (1 << _MVC_BITS):
        raise ValueError("mvc phase overflow")
    return (slot << _MVC_BITS) | mvc_phase


def unpack_phase(seq: int) -> tuple[int, int]:
    return seq >> _MVC_BITS, seq & ((1 << _MVC_BITS) - 1)
