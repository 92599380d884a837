"""Deterministic leader selection (informational) and slot proposers.

Reference parity: rabia-engine/src/leader.rs — "leader = min NodeId in the
sorted cluster view", no elections, no terms, recomputed on membership
change (`determine_leader` leader.rs:54-56); `LeadershipInfo` record. As in
the reference, the leader plays **no role in consensus** (engine.rs:127-153
uses it only for observability).

New here: :func:`slot_proposer` — the rotating per-(shard, slot) proposer
this framework uses to serialize proposals for one decision slot. Rotation
(not leadership) preserves Rabia's leaderless guarantee: a crashed
proposer's slot times out, the cluster decides V0 (null), and the next slot
rotates to a live proposer — no election protocol, no terms.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable, Optional

from rabia_tpu_torch.core.types import NodeId, sorted_nodes


@dataclass(frozen=True)
class LeadershipInfo:
    """Current informational leader (leader.rs LeadershipInfo analog)."""

    leader: Optional[NodeId]
    since: float
    cluster_size: int

    def is_leader(self, node: NodeId) -> bool:
        return self.leader == node


class LeaderSelector:
    """Min-NodeId deterministic selector (leader.rs:35-140)."""

    def __init__(self, nodes: Iterable[NodeId] = ()) -> None:
        self._nodes: list[NodeId] = sorted_nodes(nodes)
        self._info = LeadershipInfo(
            leader=self._nodes[0] if self._nodes else None,
            since=time.time(),
            cluster_size=len(self._nodes),
        )

    @property
    def current_leader(self) -> Optional[NodeId]:
        return self._info.leader

    @property
    def info(self) -> LeadershipInfo:
        return self._info

    def update_nodes(self, nodes: Iterable[NodeId]) -> Optional[NodeId]:
        """Recompute on membership change; returns the (possibly new) leader."""
        ns = sorted_nodes(nodes)
        new_leader = ns[0] if ns else None
        if new_leader != self._info.leader or len(ns) != self._info.cluster_size:
            self._info = LeadershipInfo(
                leader=new_leader, since=time.time(), cluster_size=len(ns)
            )
        self._nodes = ns
        return new_leader

    def is_leader(self, node: NodeId) -> bool:
        return self._info.is_leader(node)


def slot_proposer(shard: int, slot: int, n_replicas: int) -> int:
    """Replica row responsible for proposing (shard, slot).

    Deterministic rotation — every replica computes the same answer with no
    coordination, and consecutive slots of one shard rotate through all
    replicas so a crashed proposer only costs its own slots (which decide V0
    by timeout and move on).

    Keep :func:`slot_proposer_vec` in lockstep with any change here — the
    engine's columnar scans use the vectorized form.
    """
    return (shard + slot) % n_replicas


def slot_proposer_vec(shards, slots, n_replicas: int):
    """Vectorized :func:`slot_proposer` over numpy shard/slot arrays."""
    return (shards + slots) % n_replicas
