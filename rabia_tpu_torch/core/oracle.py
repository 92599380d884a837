"""Scalar weak-MVC oracle: the executable form of the Ivy spec.

The port's copy of the reference's ``rabia_tpu/core/oracle.py`` (stdlib
only), so that the port's ``ClusterKernel.round_step`` and the round
kernel behind it (``csrc/cluster_round.cu``) are held against the spec in
the port's own terms. This is the property-test reference for the
vectorized kernel (:mod:`rabia_tpu_torch.kernel.phase_driver`): a direct,
slow, obviously-correct transcription of the weak-MVC transition
relation from the reference's formal spec (docs/weak_mvc.ivy:82-186)
into a synchronous-round state machine with lossy delivery.

Protocol (one consensus instance = one "slot"; phases 0,1,2,... within it):

- Round 1 of phase p: every node broadcasts ``vote_rnd1(p, v)`` where v is
  its current value (phase 0: V1 if it holds the proposal, else V0 —
  weak_mvc.ivy:113-131 ``initial_vote1``).
- A node that has received round-1 votes from a majority set casts
  ``vote_rnd2(p, v)`` = v if some majority all voted v, else V?
  (weak_mvc.ivy:133-147 ``phase_rnd1``).
- A node that has received round-2 votes from a majority set
  (weak_mvc.ivy:149-186 ``phase_rnd2``):
  - **decides v** if ≥ f+1 of them voted v ≠ V? (and carries v into
    phase p+1's round-1 vote);
  - else adopts any seen v ≠ V? as its next round-1 vote;
  - else flips the **common coin** ``coin(p)`` — shared by construction
    (weak_mvc.ivy:169-182), not per-node randomness (the reference
    *implementation*'s per-node RNG at engine.rs:454-481 is a documented
    deviation from its own spec — SURVEY.md §3.1 — which this rebuild fixes).

Safety intuition encoded by the Ivy invariants (weak_mvc.ivy:190+): two
non-? round-2 votes in a phase carry the same value (their round-1
majorities intersect), and a decision's f+1 votes intersect every majority,
so every node leaves the phase carrying the decided value.

Delivery model: synchronous steps with per-step Bernoulli/mask delivery and
implicit retransmission — each step, every node's *current* outstanding vote
is re-offered to every peer; a vote is received at most once. A node only
accepts votes matching its own current (phase, round); decisions propagate
out-of-band (Decision broadcast) and are adopted directly, which is how the
real engine unsticks stragglers.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from rabia_tpu_torch.core.types import (
    ABSENT,
    V0,
    V1,
    VQUESTION,
    f_plus_1,
    quorum_size,
)

R1_WAIT = 0
R2_WAIT = 1


@dataclass
class OracleNode:
    """One node's view of one weak-MVC instance."""

    index: int
    n_nodes: int
    phase: int = 0
    stage: int = R1_WAIT
    my_r1: int = VQUESTION  # set by start()
    my_r2: int = ABSENT
    # previous phase's votes, kept for retransmission: weak MVC assumes
    # reliable broadcast (every vote eventually arrives), so under lossy
    # delivery a sender must keep re-offering the votes of the phase it just
    # left — a straggler one phase behind may still need them. Without this,
    # a quorum can splinter across adjacent phases and deadlock.
    prev_r1: int = ABSENT
    prev_r2: int = ABSENT
    led1: dict[int, int] = field(default_factory=dict)  # sender -> vote
    led2: dict[int, int] = field(default_factory=dict)
    decided: Optional[int] = None
    alive: bool = True

    def start(self, initial_value: int) -> None:
        assert initial_value in (V0, V1)
        self.my_r1 = initial_value
        self.led1 = {self.index: initial_value}
        self.led2 = {}
        self.phase = 0
        self.stage = R1_WAIT
        self.my_r2 = ABSENT
        self.prev_r1 = ABSENT
        self.prev_r2 = ABSENT
        self.decided = None


CoinFn = Callable[[int], int]  # mvc_phase -> V0|V1 (must be common!)
DeliverFn = Callable[[int, int], bool]  # (sender, receiver) -> delivered?


class WeakMVCOracle:
    """N-node single-instance weak-MVC simulator in synchronous steps."""

    def __init__(
        self,
        n_nodes: int,
        initial_values: Sequence[int],
        coin: CoinFn,
        alive: Optional[Sequence[bool]] = None,
    ):
        assert len(initial_values) == n_nodes
        self.n = n_nodes
        self.quorum = quorum_size(n_nodes)
        self.f1 = f_plus_1(n_nodes)
        self.coin = coin
        self.nodes = [OracleNode(i, n_nodes) for i in range(n_nodes)]
        for node, v in zip(self.nodes, initial_values):
            node.start(v)
        if alive is not None:
            for node, a in zip(self.nodes, alive):
                node.alive = bool(a)
        self.decided_value: Optional[int] = None  # first decision (global)
        self.decided_phase: Optional[int] = None

    # -- one synchronous step ---------------------------------------------

    def step(self, deliver: DeliverFn = lambda i, j: True) -> None:
        """Deliver current votes per ``deliver``, then run all enabled
        transitions once. Mirrors the kernel's ``round_step`` exactly."""
        self._deliver(deliver)
        self._transition()
        self._adopt_decisions(deliver)

    def _deliver(self, deliver: DeliverFn) -> None:
        for snd in self.nodes:
            if not snd.alive:
                continue
            for rcv in self.nodes:
                if not rcv.alive or rcv.index == snd.index:
                    continue
                if rcv.decided is not None:
                    continue
                if not deliver(snd.index, rcv.index):
                    continue
                # R1 votes: valid while the sender is in the same phase
                # (it cast its R1 vote on entering the phase).
                if snd.phase == rcv.phase:
                    if snd.my_r1 != ABSENT and snd.index not in rcv.led1:
                        rcv.led1[snd.index] = snd.my_r1
                    if (
                        snd.stage == R2_WAIT
                        and snd.my_r2 != ABSENT
                        and snd.index not in rcv.led2
                    ):
                        rcv.led2[snd.index] = snd.my_r2
                elif snd.phase == rcv.phase + 1:
                    # sender already advanced: re-offer its previous-phase
                    # votes (reliable-broadcast emulation; see prev_r1 note)
                    if snd.prev_r1 != ABSENT and snd.index not in rcv.led1:
                        rcv.led1[snd.index] = snd.prev_r1
                    if snd.prev_r2 != ABSENT and snd.index not in rcv.led2:
                        rcv.led2[snd.index] = snd.prev_r2

    def _transition(self) -> None:
        for node in self.nodes:
            if not node.alive or node.decided is not None:
                continue
            if node.stage == R1_WAIT and len(node.led1) >= self.quorum:
                votes = list(node.led1.values())
                if votes.count(V1) >= self.quorum:
                    node.my_r2 = V1
                elif votes.count(V0) >= self.quorum:
                    node.my_r2 = V0
                else:
                    node.my_r2 = VQUESTION
                node.led2[node.index] = node.my_r2
                node.stage = R2_WAIT
            elif node.stage == R2_WAIT and len(node.led2) >= self.quorum:
                votes = list(node.led2.values())
                c0, c1 = votes.count(V0), votes.count(V1)
                if c1 >= self.f1:
                    self._record_decision(node, V1)
                    next_v = V1
                elif c0 >= self.f1:
                    self._record_decision(node, V0)
                    next_v = V0
                elif c1 > 0:
                    next_v = V1
                elif c0 > 0:
                    next_v = V0
                else:
                    next_v = self.coin(node.phase)
                    assert next_v in (V0, V1), "coin must be concrete"
                node.prev_r1 = node.my_r1
                node.prev_r2 = node.my_r2
                node.phase += 1
                node.stage = R1_WAIT
                node.my_r1 = next_v
                node.my_r2 = ABSENT
                node.led1 = {node.index: next_v}
                node.led2 = {}

    def _record_decision(self, node: OracleNode, value: int) -> None:
        node.decided = value
        if self.decided_value is None:
            self.decided_value = value
        # decided_phase = minimum MVC phase at which any replica decided
        if self.decided_phase is None or node.phase < self.decided_phase:
            self.decided_phase = node.phase

    def _adopt_decisions(self, deliver: DeliverFn) -> None:
        """Decision broadcast: any decided node's value is adopted by
        undecided peers the message reaches."""
        deciders = [n for n in self.nodes if n.alive and n.decided is not None]
        if not deciders:
            return
        for rcv in self.nodes:
            if not rcv.alive or rcv.decided is not None:
                continue
            for snd in deciders:
                if deliver(snd.index, rcv.index):
                    rcv.decided = snd.decided
                    break

    # -- drivers -----------------------------------------------------------

    def run(
        self,
        max_steps: int = 1000,
        deliver: DeliverFn = lambda i, j: True,
    ) -> Optional[int]:
        """Step until every alive node decided (or step budget exhausted).
        Returns the decided value, or None on no decision."""
        for _ in range(max_steps):
            if all(n.decided is not None for n in self.nodes if n.alive):
                break
            self.step(deliver)
        return self.decided_value

    # -- invariant checks (the Ivy properties, weak_mvc.ivy:190+) ----------

    def check_agreement(self) -> None:
        vals = {n.decided for n in self.nodes if n.alive and n.decided is not None}
        assert len(vals) <= 1, f"agreement violated: decisions {vals}"

    def check_validity(self, initial_values: Sequence[int]) -> None:
        if self.decided_value is None:
            return
        if all(v == V1 for v in initial_values):
            assert self.decided_value == V1, "validity: all proposed V1"
        if all(v == V0 for v in initial_values):
            assert self.decided_value == V0, "validity: all proposed V0"


def seeded_coin(seed: int, shard: int = 0, slot: int = 0, p1: float = 0.5) -> CoinFn:
    """Deterministic common coin for host-side use: value depends only on
    (seed, shard, slot, phase) — never on the node flipping it. The kernel's
    device coin uses the same principle with an integer hash
    (``phase_driver.device_coin``)."""

    def coin(phase: int) -> int:
        rng = _random.Random(f"{seed}:{shard}:{slot}:{phase}")
        return V1 if rng.random() < p1 else V0

    return coin


def bernoulli_deliver(rng: _random.Random, p: float) -> DeliverFn:
    """Random lossy delivery with per-(step-call) fresh draws."""

    def deliver(i: int, j: int) -> bool:
        return rng.random() < p

    return deliver
