"""Consistent-hash router: shard -> owning fleet gateway.

Classic ring with virtual nodes (blake2b points, deterministic across
processes — every gateway and every client resolver computes the SAME
ownership from the same membership doc, no coordination service). The
property the fleet tier leans on is **bounded movement**: removing a
member moves only the shards that member owned, and each of those moves
to the shard's next distinct successor on the ring — which is exactly
the gateway the dedup-ledger replication targeted
(:mod:`rabia_tpu_torch.fleet.ledger`), so failover lands replays where the
records already are. Adding a member steals only the shards whose ring
point now falls to the newcomer.

Membership docs serialize to JSON (the ``AdminKind.RING`` body, the
``python -m rabia_tpu_torch ring`` CLI, and the handoff trigger all speak it):
``{"version": N, "vnodes": V, "members": [{"name", "host", "port",
"node": hex}]}``.

The port's copy of the reference's ``rabia_tpu/fleet/ring.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import uuid
from bisect import bisect_right
from dataclasses import dataclass
from typing import Optional

from rabia_tpu_torch.core.types import NodeId

DEFAULT_VNODES = 64


def _point(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def shard_point(shard: int) -> int:
    """The ring point a shard hashes to (stable across processes)."""
    return _point(b"shard:%d" % int(shard))


@dataclass(frozen=True)
class RingMember:
    """One fleet gateway's address card on the ring."""

    name: str
    host: str
    port: int
    node: NodeId  # the gateway's transport identity (MOVED carries it)

    def to_doc(self) -> dict:
        return {
            "name": self.name,
            "host": self.host,
            "port": self.port,
            "node": self.node.value.hex,
        }

    @staticmethod
    def from_doc(doc: dict) -> "RingMember":
        return RingMember(
            name=str(doc["name"]),
            host=str(doc["host"]),
            port=int(doc["port"]),
            node=NodeId(uuid.UUID(hex=doc["node"])),
        )


class HashRing:
    """Virtual-node consistent-hash ring over :class:`RingMember`s.

    ``version`` increments on every membership change; a gateway answers
    ``MOVED`` from its CURRENT view, and a client resolver updates its
    view from the redirect — stale views converge by following at most
    one redirect per change.
    """

    def __init__(self, vnodes: int = DEFAULT_VNODES) -> None:
        self.vnodes = max(1, int(vnodes))
        self.version = 0
        self.members: dict[str, RingMember] = {}
        self._points: list[int] = []  # sorted vnode hash points
        self._owners: list[str] = []  # member name per point

    # -- membership ---------------------------------------------------------

    def add(self, member: RingMember) -> None:
        self.members[member.name] = member
        self.version += 1
        self._rebuild()

    def remove(self, name: str) -> Optional[RingMember]:
        gone = self.members.pop(name, None)
        if gone is not None:
            self.version += 1
            self._rebuild()
        return gone

    def _rebuild(self) -> None:
        pts: list[tuple[int, str]] = []
        for name in self.members:
            for v in range(self.vnodes):
                pts.append((_point(f"{name}#{v}".encode()), name))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [n for _, n in pts]

    # -- resolution ---------------------------------------------------------

    def owner(self, shard: int) -> Optional[RingMember]:
        """The member owning ``shard`` (None on an empty ring)."""
        if not self._points:
            return None
        i = bisect_right(self._points, shard_point(shard)) % len(self._points)
        return self.members[self._owners[i]]

    def successors(self, shard: int, k: int) -> list[RingMember]:
        """The shard's first ``k`` DISTINCT members clockwise from its
        ring point (``[0]`` is the owner). The replication group for the
        shard's dedup ledger is ``successors(shard, rf)``."""
        if not self._points:
            return []
        out: list[RingMember] = []
        seen: set[str] = set()
        start = bisect_right(self._points, shard_point(shard))
        n = len(self._points)
        for j in range(n):
            name = self._owners[(start + j) % n]
            if name not in seen:
                seen.add(name)
                out.append(self.members[name])
                if len(out) >= k:
                    break
        return out

    def owned_shards(self, name: str, n_shards: int) -> list[int]:
        return [
            s for s in range(n_shards)
            if (m := self.owner(s)) is not None and m.name == name
        ]

    # -- wire ---------------------------------------------------------------

    def to_doc(self) -> dict:
        return {
            "version": self.version,
            "vnodes": self.vnodes,
            "members": [
                self.members[n].to_doc() for n in sorted(self.members)
            ],
        }

    @staticmethod
    def from_doc(doc: dict) -> "HashRing":
        ring = HashRing(vnodes=int(doc.get("vnodes", DEFAULT_VNODES)))
        for m in doc.get("members", []):
            ring.members[str(m["name"])] = RingMember.from_doc(m)
        ring._rebuild()
        ring.version = int(doc.get("version", 0))
        return ring

    def copy(self) -> "HashRing":
        return HashRing.from_doc(self.to_doc())

    def __len__(self) -> int:
        return len(self.members)


def moved_shards(old: HashRing, new: HashRing, n_shards: int) -> dict[int, str]:
    """Shards whose owner changed between two views:
    ``{shard: new_owner_name}``. This is both the handoff work list and
    the bounded-movement assertion surface (a one-member change moves
    only that member's shards)."""
    out: dict[int, str] = {}
    for s in range(n_shards):
        a, b = old.owner(s), new.owner(s)
        if b is not None and (a is None or a.name != b.name):
            out[s] = b.name
    return out
