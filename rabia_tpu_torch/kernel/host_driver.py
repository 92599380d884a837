"""Numpy host kernel: the transport engine's per-replica weak-MVC step.

The port of the reference's ``rabia_tpu/kernel/host_driver.py`` on its
numpy path. The host engine paces consensus in *rounds* — one
``node_step`` per round per replica — over host arrays, so its hot loop
runs here with no device dispatch or readback per round.

Layout: ledgers are **replica-major** ``[R, S]`` — vote ingest writes one
sender row at a time, and the quorum tallies become contiguous row sums.
The engine scatters arriving votes directly into the ledger rows
(:meth:`HostNodeKernel.offer_votes`), so the hot path has no per-round
inbox materialization at all.

Bit-identity contract: every transition, the common coin included, is
element for element the reference's ``HostNodeKernel`` (and so its
``NodeKernel``); tests/test_torch_host_kernel.py holds every state field
after every step against the reference. The reference also runs a C
step here (``native/hostkernel.cpp``'s ``rk_node_step``); the port runs the
numpy step below on the Python tick, and the C step inside the native tick
context (:mod:`rabia_tpu_torch.engine.native_tick`), which the engine uses
unless ``RABIA_PY_TICK=1``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from rabia_tpu_torch.core.types import ABSENT, V0, V1, VQUESTION, f_plus_1, quorum_size
from rabia_tpu_torch.kernel.phase_driver import R1_WAIT, R2_WAIT, coin_threshold

I8 = np.int8
I32 = np.int32
_ABS = np.int8(ABSENT)

# The common coin in numpy: the uint32 avalanche hash of
# rabia_tpu_torch.kernel.phase_driver._coin_bits (which runs it on torch
# int64 masked to 32 bits), here on numpy uint32, whose products and
# sums wrap mod 2^32 as the reference's do.
_GOLD = np.uint32(0x9E3779B9)


def _mix32_np(h: np.ndarray) -> np.ndarray:
    """lowbias32 avalanche on uint32 arrays (wrapping multiplies)."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x21F0AAAD)
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x735A2D97)
    h = h ^ (h >> np.uint32(15))
    return h


def coin_bits_np(seed: int, shard, slot, phase, p1: float) -> np.ndarray:
    """Common-coin values (int8 V0/V1) for (shard, slot, phase) triples,
    broadcast together. Depends only on the seed and the triple."""
    u32 = np.uint32
    shard, slot, phase = np.broadcast_arrays(
        np.asarray(shard), np.asarray(slot), np.asarray(phase)
    )
    with np.errstate(over="ignore"):
        h = _mix32_np(np.full(shard.shape, u32(seed & 0xFFFFFFFF)) ^ _GOLD)
        h = _mix32_np(h ^ (shard.astype(u32) + _GOLD))
        h = _mix32_np(h ^ (slot.astype(u32) + _GOLD))
        h = _mix32_np(h ^ (phase.astype(u32) + _GOLD))
    return np.where(h < u32(coin_threshold(p1)), I8(V1), I8(V0))


class NodeOutbox(NamedTuple):
    """What the host must transmit after a node_step (host arrays)."""

    cast_r2: np.ndarray  # bool[S] — broadcast VoteRound2(phase, my_r2)
    r2_vals: np.ndarray  # i8[S]
    advanced: np.ndarray  # bool[S] — broadcast VoteRound1(phase+1, my_r1)
    new_r1: np.ndarray  # i8[S]
    new_phase: np.ndarray  # i32[S]
    newly_decided: np.ndarray  # bool[S] — broadcast Decision(slot, value)
    decided_vals: np.ndarray  # i8[S]


class HostNodeState(NamedTuple):
    """One node's consensus state over its S shards (host arrays).

    The reference's ``NodeState`` fields, with ``led1``/``led2``
    ``[R, S]`` (replica-major; see module doc).
    """

    slot: np.ndarray  # i32[S]
    phase: np.ndarray  # i32[S]
    stage: np.ndarray  # i8[S]
    my_r1: np.ndarray  # i8[S]
    my_r2: np.ndarray  # i8[S]
    led1: np.ndarray  # i8[R,S]
    led2: np.ndarray  # i8[R,S]
    decided: np.ndarray  # i8[S]
    done: np.ndarray  # bool[S]
    active: np.ndarray  # bool[S]


def _rowsum_eq(led: np.ndarray, value: int) -> np.ndarray:
    """Count, per shard, how many sender rows equal ``value``. uint8[S]."""
    eq = (led == value).view(np.uint8)
    if led.shape[0] == 1:
        return eq[0]
    acc = eq[0] + eq[1]
    for i in range(2, led.shape[0]):
        acc += eq[i]
    return acc


# NOTE: quorum presence (`tot`) must count only the valid vote codes
# (V0+V1+V?), exactly like phase_driver._tally — counting "anything
# non-ABSENT" would let garbage codes from a faulty peer fabricate quorum
# presence (and diverge bit-wise from the reference's kernels).


class HostNodeKernel:
    """One replica's weak-MVC step over its S shards, in numpy.

    State arrays are host numpy and steps mutate fresh copies (callers
    may alias the previous state's ledgers only until the next
    ``node_step``). Two ingest styles:

    - functional: pass ``inbox_r1/inbox_r2`` ``[S, R]`` arrays to
      ``node_step``;
    - zero-copy: scatter arriving votes with :meth:`offer_votes` as
      messages land, then call ``node_step()`` with no inboxes.
    """

    def __init__(
        self,
        n_shards: int,
        n_replicas: int,
        me: int,
        *,
        coin_p1: float = 0.5,
        seed: int = 0,
    ):
        self.S = int(n_shards)
        self.R = int(n_replicas)
        self.me = int(me)
        self.quorum = quorum_size(self.R)
        self.f1 = f_plus_1(self.R)
        self.coin_p1 = float(coin_p1)
        self.seed = int(seed)
        # the coin's integer threshold, as the C step takes it
        self._coin_threshold = coin_threshold(coin_p1)
        self._native_lib: object = False  # False = not probed yet
        # consensus-health telemetry: common-coin flip outcomes ([V0, V1]
        # counts) and the phases-to-decide distribution of
        # locally tally-decided slots (bin p = decisions taking p
        # weak-MVC phases, top bin clamps). Accounting only — no
        # protocol effect.
        self.coin_flips = np.zeros(2, np.uint64)
        self.phase_hist = np.zeros(32, np.uint64)
        self.phase_sum = 0

    def init_state(self) -> HostNodeState:
        S, R = self.S, self.R
        return HostNodeState(
            slot=np.zeros((S,), I32),
            phase=np.zeros((S,), I32),
            stage=np.full((S,), R1_WAIT, I8),
            my_r1=np.full((S,), ABSENT, I8),
            my_r2=np.full((S,), ABSENT, I8),
            led1=np.full((R, S), ABSENT, I8),
            led2=np.full((R, S), ABSENT, I8),
            decided=np.full((S,), ABSENT, I8),
            done=np.zeros((S,), bool),
            active=np.zeros((S,), bool),
        )

    # -- zero-copy ingest ----------------------------------------------------

    def offer_votes(
        self,
        state: HostNodeState,
        round_no: int,
        row: int,
        shards: np.ndarray,
        votes: np.ndarray,
    ) -> None:
        """Scatter one sender's votes into the ledger (first write wins
        across calls; the caller routes only votes matching each shard's
        current (slot, phase))."""
        led = state.led1 if round_no == 1 else state.led2
        led_row = led[row]
        writable = led_row[shards] == ABSENT
        if writable.all():
            led_row[shards] = votes
        else:
            led_row[shards[writable]] = votes[writable]

    # -- slot lifecycle -------------------------------------------------------

    def start_slots(
        self,
        state: HostNodeState,
        shard_mask: np.ndarray,  # bool[S]
        slot_index: np.ndarray,  # i32[S]
        initial_votes: np.ndarray,  # i8[S]
    ) -> HostNodeState:
        lib = self._native()
        if lib is not None:
            m = np.ascontiguousarray(shard_mask, bool)
            sl = np.ascontiguousarray(slot_index, I32)
            iv = np.ascontiguousarray(initial_votes, I8)
            st = HostNodeState(*(a.copy() for a in state))
            lib.rk_start_slots(
                self.S, self.R, self.me,
                m.ctypes.data, sl.ctypes.data, iv.ctypes.data,
                st.slot.ctypes.data, st.phase.ctypes.data,
                st.stage.ctypes.data, st.my_r1.ctypes.data,
                st.my_r2.ctypes.data, st.led1.ctypes.data,
                st.led2.ctypes.data, st.decided.ctypes.data,
                st.done.ctypes.data, st.active.ctypes.data,
            )
            return st
        return self._start_slots_np(state, shard_mask, slot_index,
                                    initial_votes)

    def _start_slots_np(
        self,
        state: HostNodeState,
        shard_mask: np.ndarray,
        slot_index: np.ndarray,
        initial_votes: np.ndarray,
    ) -> HostNodeState:
        m = np.asarray(shard_mask, bool)
        slot_index = np.asarray(slot_index)
        initial_votes = np.asarray(initial_votes, I8)
        st = HostNodeState(*(a.copy() for a in state))
        np.copyto(st.slot, slot_index.astype(I32), where=m)
        np.copyto(st.phase, I32(0), where=m)
        np.copyto(st.stage, I8(R1_WAIT), where=m)
        np.copyto(st.my_r1, initial_votes, where=m)
        np.copyto(st.my_r2, _ABS, where=m)
        np.copyto(st.led1, _ABS, where=m[None, :])
        np.copyto(st.led1[self.me], initial_votes, where=m)
        np.copyto(st.led2, _ABS, where=m[None, :])
        np.copyto(st.decided, _ABS, where=m)
        st.done[m] = False
        np.copyto(st.active, True, where=m)
        return st

    # -- the round step --------------------------------------------------------

    def _acct_decided(self, newly, phase) -> None:
        """Fold this step's tally decisions into the phases-to-decide
        telemetry (post-advance phase == phases used)."""
        idx = np.nonzero(newly)[0]
        if len(idx) == 0:
            return
        ph = np.asarray(phase)[idx].astype(np.int64)
        self.phase_sum += int(ph.sum())
        np.add.at(
            self.phase_hist, np.minimum(ph, len(self.phase_hist) - 1), 1
        )

    def node_step(
        self,
        state: HostNodeState,
        inbox_r1: Optional[np.ndarray] = None,  # i8[S,R] (compat path)
        inbox_r2: Optional[np.ndarray] = None,
        decision_in: Optional[np.ndarray] = None,  # i8[S]
    ) -> tuple[HostNodeState, NodeOutbox]:
        lib = self._native()
        if lib is not None:
            return self._node_step_c(
                lib, state, inbox_r1, inbox_r2, decision_in
            )
        return self._node_step_np(state, inbox_r1, inbox_r2, decision_in)

    def _native(self):
        """The C step library, or None (``RABIA_PY_HOSTKERNEL`` set, or
        ``_native_lib`` set to None by a caller that wants the numpy
        step)."""
        lib = self._native_lib
        if lib is False:
            from rabia_tpu_torch.native.build import load_hostkernel

            lib = self._native_lib = load_hostkernel()
            if lib is not None:
                self._mk_workspaces()
        return lib

    def _node_step_c(
        self,
        lib,
        state: HostNodeState,
        inbox_r1: Optional[np.ndarray],
        inbox_r2: Optional[np.ndarray],
        decision_in: Optional[np.ndarray],
    ) -> tuple[HostNodeState, NodeOutbox]:
        """One C call instead of ~40 numpy dispatches (the per-activation
        floor under serial commit latency; see native/hostkernel.cpp).

        Output arrays come from two ping-ponged workspaces with cached
        raw pointers — a returned state/outbox stays valid until the
        *second* following ``node_step`` (strictly wider than the
        documented one-step aliasing contract). The C routine mutates the
        workspace in place and fills the outbox extras."""
        ws = self._ws[self._ws_flip]
        self._ws_flip ^= 1
        st_out, out_extra, ptrs = ws
        # copy current state into the workspace (the functional step);
        # np.copyto(a, a) when the caller passes the same workspace back
        # after an offer_votes-only mutation is a safe no-op-by-value
        for dst, src in zip(st_out, state):
            np.copyto(dst, src, casting="unsafe")
        led1, led2 = st_out.led1, st_out.led2
        if inbox_r1 is not None:
            ib = np.asarray(inbox_r1, I8).T
            np.copyto(led1, ib, where=(led1 == ABSENT) & (ib != ABSENT))
        if inbox_r2 is not None:
            ib = np.asarray(inbox_r2, I8).T
            np.copyto(led2, ib, where=(led2 == ABSENT) & (ib != ABSENT))
        if decision_in is None:
            dec_ptr = 0
        else:
            decision_in = np.ascontiguousarray(decision_in, I8)
            dec_ptr = decision_in.ctypes.data
        lib.rk_node_step_ex(
            *self._const_args, *ptrs[:10], dec_ptr, *ptrs[10:],
            self._coin_ptr,
        )
        self._acct_decided(out_extra[3], st_out.phase)
        outbox = NodeOutbox(
            cast_r2=out_extra[0],
            r2_vals=out_extra[1],
            advanced=out_extra[2],
            new_r1=st_out.my_r1,
            new_phase=st_out.phase,
            newly_decided=out_extra[3],
            decided_vals=st_out.decided,
        )
        return st_out, outbox

    def _mk_workspaces(self) -> None:
        """Two ping-ponged output workspaces for the C step: state arrays,
        outbox extras, and their raw pointers precomputed once (ctypes
        marshalling of ``ndarray.ctypes.data`` per call costs more than
        the C step itself at small S)."""
        S, R = self.S, self.R
        self._ws = []
        for _ in range(2):
            st = HostNodeState(
                slot=np.zeros((S,), I32),
                phase=np.zeros((S,), I32),
                stage=np.full((S,), R1_WAIT, I8),
                my_r1=np.full((S,), ABSENT, I8),
                my_r2=np.full((S,), ABSENT, I8),
                led1=np.full((R, S), ABSENT, I8),
                led2=np.full((R, S), ABSENT, I8),
                decided=np.full((S,), ABSENT, I8),
                done=np.zeros((S,), bool),
                active=np.zeros((S,), bool),
            )
            extra = (
                np.empty(S, bool),  # cast_r2
                np.empty(S, I8),  # r2_vals
                np.empty(S, bool),  # advanced
                np.empty(S, bool),  # newly_decided
            )
            ptrs = tuple(a.ctypes.data for a in st) + tuple(
                a.ctypes.data for a in extra
            )
            self._ws.append((st, extra, ptrs))
        self._ws_flip = 0
        self._const_args = (
            S, R, self.me, self.quorum, self.f1,
            self.seed & 0xFFFFFFFF, self._coin_threshold,
        )
        self._coin_ptr = self.coin_flips.ctypes.data

    def _node_step_np(
        self,
        state: HostNodeState,
        inbox_r1: Optional[np.ndarray] = None,
        inbox_r2: Optional[np.ndarray] = None,
        decision_in: Optional[np.ndarray] = None,
    ) -> tuple[HostNodeState, NodeOutbox]:
        Q, F1 = self.quorum, self.f1

        led1 = state.led1.copy()
        led2 = state.led2.copy()
        if inbox_r1 is not None:
            ib = np.asarray(inbox_r1, I8).T
            np.copyto(led1, ib, where=(led1 == ABSENT) & (ib != ABSENT))
        if inbox_r2 is not None:
            ib = np.asarray(inbox_r2, I8).T
            np.copyto(led2, ib, where=(led2 == ABSENT) & (ib != ABSENT))

        enabled = state.active & ~state.done

        c0 = _rowsum_eq(led1, V0)
        c1 = _rowsum_eq(led1, V1)
        tot1 = c0 + c1 + _rowsum_eq(led1, VQUESTION)
        cast_r2 = enabled & (state.stage == R1_WAIT) & (tot1 >= Q)
        r2_val = np.where(
            c1 >= Q, I8(V1), np.where(c0 >= Q, I8(V0), I8(VQUESTION))
        )
        my_r2 = state.my_r2.copy()
        np.copyto(my_r2, r2_val, where=cast_r2)
        stage = state.stage.copy()
        np.copyto(stage, I8(R2_WAIT), where=cast_r2)
        np.copyto(led2[self.me], my_r2, where=cast_r2)

        d0 = _rowsum_eq(led2, V0)
        d1 = _rowsum_eq(led2, V1)
        tot2 = d0 + d1 + _rowsum_eq(led2, VQUESTION)
        advance = enabled & (state.stage == R2_WAIT) & (tot2 >= Q)
        decide1 = d1 >= F1
        decide0 = d0 >= F1
        # next round-1 vote: decided value, else any seen non-? value, else
        # the common coin — computed lazily (the coin hash is the single
        # most expensive op; fault-free traffic never reaches it)
        next_v = np.where(
            decide1,
            I8(V1),
            np.where(
                decide0,
                I8(V0),
                np.where(d1 > 0, I8(V1), I8(V0)),
            ),
        )
        coin_case = advance & ~decide1 & ~decide0 & (d1 == 0) & (d0 == 0)
        if coin_case.any():
            idx = np.nonzero(coin_case)[0]
            bits = coin_bits_np(
                self.seed,
                idx.astype(I32),
                state.slot[idx],
                state.phase[idx],
                self.coin_p1,
            )
            next_v[idx] = bits
            n1 = int((bits == V1).sum())
            self.coin_flips[0] += len(idx) - n1
            self.coin_flips[1] += n1
        newly_decided = advance & (decide1 | decide0)
        dec_val = np.where(decide1, I8(V1), I8(V0))

        adopt = (
            enabled & ~newly_decided & (decision_in != ABSENT)
            if decision_in is not None
            else np.zeros_like(enabled)
        )
        decided = state.decided.copy()
        np.copyto(decided, dec_val, where=newly_decided)
        if decision_in is not None:
            np.copyto(decided, np.asarray(decision_in, I8), where=adopt)
        done = state.done | newly_decided | adopt

        phase = state.phase.copy()
        my_r1 = state.my_r1.copy()
        my_r2_out = my_r2.copy()
        if advance.any():
            np.copyto(phase, state.phase + 1, where=advance)
            np.copyto(my_r1, next_v, where=advance)
            np.copyto(stage, I8(R1_WAIT), where=advance)
            np.copyto(my_r2, _ABS, where=advance)
            np.copyto(led1, _ABS, where=advance[None, :])
            np.copyto(led1[self.me], next_v, where=advance)
            np.copyto(led2, _ABS, where=advance[None, :])

        self._acct_decided(newly_decided, phase)
        new_state = HostNodeState(
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
