"""Shard-group scale-out: partitioned consensus groups (docs/FLEET.md).

One replica process set can only spend one machine's cores and one WAL's
fsync lane. This module partitions the SHARD SPACE itself into
independent consensus **groups** — each group is a complete Rabia
cluster (its own replica processes, its own runtime, its own WAL
directory, its own coalescing windows) that owns a contiguous range of
the global shard ids. Nothing crosses a group boundary: Submits route by
shard to the owning group, coalesced PayloadBlocks pack only one shard
(hence one group), read-index probe rounds stay inside the owning
group's quorum, and the dedup/alias exactly-once ledger is per group —
deterministic batch ids derive from ``(client_id, seq)``, so a replay
that lands on a re-routed group dedups against whatever that group
already applied.

The pieces:

- :class:`GroupMap` — the versioned routing doc (the hash ring's
  bounded-movement idiom applied to contiguous ranges): sorted
  half-open ``[lo, hi) -> group id`` ranges covering the whole shard
  space. ``move_range`` bumps the version and moves ONLY the shards in
  the moved range (:func:`moved_group_shards` is the assertion
  surface). JSON doc on the wire: ``{"version": N, "n_shards": S,
  "ranges": [[lo, hi, gid], ...]}``.
- :class:`GroupRouter` — GroupMap + per-group upstream address lists;
  resolves ``shard -> (host, port)`` with the same ``shard % len``
  spreading the flat fleet tier uses inside one group. Version-gated
  ``adopt`` so a stale push never rolls routing back.
- :class:`GroupProcHarness` — one durable
  :class:`~rabia_tpu_torch.testing.recovery.RecoveryHarness` per group (real
  OS processes, real SIGKILL), each under its own WAL subtree, each
  child told its group id + owned ranges so the replica gateways
  ENFORCE group locality (out-of-range Submits shed retryable).
- :class:`GroupedFleetHarness` — fleet gateways
  (:mod:`rabia_tpu_torch.fleet.gateway_proc`) configured with
  ``upstream_groups`` so the routed-fleet front door sends each Submit
  to the owning group's upstream lane.

Rebalance is ROUTING-PLANE ONLY (state does not migrate between
groups — see docs/FLEET.md for the honest limitation): the safe order
is widen-the-new-owner first (replica gateways accept the range), flip
the GroupMap at the routing tier, then shrink the old owner. A replay
that crosses the flip dedups at the routing tier's session cache, or —
past it — against the group ledger its original commit lives in.

The port's copy of the reference's ``rabia_tpu/fleet/groups.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import os
from bisect import bisect_right
from typing import Optional, Sequence

__all__ = [
    "GroupMap",
    "GroupRouter",
    "GroupProcHarness",
    "GroupedFleetHarness",
    "moved_group_shards",
]


class GroupMap:
    """Versioned contiguous shard-range -> group-id map.

    Invariants (checked on every mutation): ranges are sorted,
    half-open, non-overlapping, and cover ``[0, n_shards)`` exactly.
    ``version`` bumps on every change; routers adopt only strictly
    newer docs (the hash ring's convergence rule).
    """

    def __init__(
        self, n_shards: int, ranges: Sequence[tuple[int, int, int]]
    ) -> None:
        self.n_shards = int(n_shards)
        self.version = 0
        self._ranges: list[tuple[int, int, int]] = []
        self._set_ranges(ranges)

    # -- construction -------------------------------------------------------

    @staticmethod
    def initial(n_shards: int, n_groups: int) -> "GroupMap":
        """The even contiguous partition: group g owns
        ``[g*S/G, (g+1)*S/G)`` (remainder spread over the low groups).
        Deterministic across processes — every router computes the SAME
        bootstrap map from ``(n_shards, n_groups)`` alone."""
        if n_groups < 1 or n_groups > n_shards:
            raise ValueError(
                f"n_groups must be in [1, {n_shards}], got {n_groups}"
            )
        base, rem = divmod(n_shards, n_groups)
        ranges = []
        lo = 0
        for g in range(n_groups):
            hi = lo + base + (1 if g < rem else 0)
            ranges.append((lo, hi, g))
            lo = hi
        return GroupMap(n_shards, ranges)

    def _set_ranges(
        self, ranges: Sequence[tuple[int, int, int]]
    ) -> None:
        rs = sorted(
            (int(lo), int(hi), int(g)) for lo, hi, g in ranges
        )
        cursor = 0
        for lo, hi, g in rs:
            if lo != cursor or hi <= lo or g < 0:
                raise ValueError(
                    f"ranges must tile [0, {self.n_shards}) contiguously; "
                    f"got {rs}"
                )
            cursor = hi
        if cursor != self.n_shards:
            raise ValueError(
                f"ranges cover [0, {cursor}), need [0, {self.n_shards})"
            )
        # merge adjacent same-group ranges so the doc stays canonical
        # (two equal maps serialize identically regardless of history)
        merged: list[tuple[int, int, int]] = []
        for lo, hi, g in rs:
            if merged and merged[-1][2] == g and merged[-1][1] == lo:
                merged[-1] = (merged[-1][0], hi, g)
            else:
                merged.append((lo, hi, g))
        self._ranges = merged
        self._los = [lo for lo, _hi, _g in merged]

    # -- resolution ---------------------------------------------------------

    def group_of(self, shard: int) -> int:
        if not (0 <= shard < self.n_shards):
            raise ValueError(
                f"shard {shard} outside [0, {self.n_shards})"
            )
        i = bisect_right(self._los, shard) - 1
        return self._ranges[i][2]

    def groups(self) -> list[int]:
        return sorted({g for _lo, _hi, g in self._ranges})

    def ranges(self) -> list[tuple[int, int, int]]:
        return list(self._ranges)

    def ranges_of(self, group: int) -> list[tuple[int, int]]:
        return [
            (lo, hi) for lo, hi, g in self._ranges if g == int(group)
        ]

    def shards_of(self, group: int) -> list[int]:
        return [
            s
            for lo, hi, g in self._ranges
            if g == int(group)
            for s in range(lo, hi)
        ]

    # -- mutation -----------------------------------------------------------

    def move_range(self, lo: int, hi: int, group: int) -> None:
        """Reassign ``[lo, hi)`` to ``group``; every shard outside the
        moved range keeps its owner (bounded movement, asserted by
        :func:`moved_group_shards` in tests)."""
        if not (0 <= lo < hi <= self.n_shards):
            raise ValueError(
                f"[{lo}, {hi}) outside [0, {self.n_shards})"
            )
        out: list[tuple[int, int, int]] = []
        for rlo, rhi, g in self._ranges:
            # the part of [rlo, rhi) below / above the moved range
            if rlo < lo:
                out.append((rlo, min(rhi, lo), g))
            if rhi > hi:
                out.append((max(rlo, hi), rhi, g))
        out.append((lo, hi, int(group)))
        self._set_ranges(out)
        self.version += 1

    # -- wire ---------------------------------------------------------------

    def to_doc(self) -> dict:
        return {
            "version": self.version,
            "n_shards": self.n_shards,
            "ranges": [[lo, hi, g] for lo, hi, g in self._ranges],
        }

    @staticmethod
    def from_doc(doc: dict) -> "GroupMap":
        gm = GroupMap(
            int(doc["n_shards"]),
            [tuple(r) for r in doc["ranges"]],
        )
        gm.version = int(doc.get("version", 0))
        return gm

    def copy(self) -> "GroupMap":
        return GroupMap.from_doc(self.to_doc())

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, GroupMap)
            and self.n_shards == other.n_shards
            and self._ranges == other._ranges
        )

    def __repr__(self) -> str:
        return (
            f"GroupMap(v{self.version}, "
            + ", ".join(
                f"[{lo},{hi})->g{g}" for lo, hi, g in self._ranges
            )
            + ")"
        )


def moved_group_shards(old: GroupMap, new: GroupMap) -> dict[int, int]:
    """Shards whose owning group changed between two maps:
    ``{shard: new_group}`` — the bounded-movement assertion surface
    (a ``move_range(lo, hi, g)`` moves only shards in ``[lo, hi)``)."""
    if old.n_shards != new.n_shards:
        raise ValueError("maps cover different shard spaces")
    return {
        s: new.group_of(s)
        for s in range(old.n_shards)
        if old.group_of(s) != new.group_of(s)
    }


class GroupRouter:
    """GroupMap + per-group upstream addresses -> a shard's dial target.

    Within a group the same deterministic ``shard % len(addrs)`` spread
    the flat fleet tier uses applies, so a group's replica-side
    coalescing windows still see concentrated per-shard arrivals."""

    def __init__(
        self,
        group_map: GroupMap,
        upstreams: dict[int, Sequence[tuple[str, int]]],
    ) -> None:
        self.group_map = group_map
        self.upstreams: dict[int, list[tuple[str, int]]] = {
            int(g): [(str(h), int(p)) for h, p in addrs]
            for g, addrs in upstreams.items()
        }
        for g in group_map.groups():
            if not self.upstreams.get(g):
                raise ValueError(f"group {g} has no upstream addresses")

    def group_of(self, shard: int) -> int:
        return self.group_map.group_of(shard)

    def upstream_for(self, shard: int) -> tuple[str, int]:
        addrs = self.upstreams[self.group_map.group_of(shard)]
        return addrs[shard % len(addrs)]

    def candidates(self, shard: int) -> list[tuple[str, int]]:
        """Every address of the owning group, preferred first — the
        client failover order when the preferred replica is down."""
        addrs = self.upstreams[self.group_map.group_of(shard)]
        k = shard % len(addrs)
        return addrs[k:] + addrs[:k]

    def adopt(self, new_map: GroupMap) -> bool:
        """Install a strictly newer map; a stale or same-version push is
        ignored (returns False) so races never roll routing back."""
        if new_map.version <= self.group_map.version:
            return False
        if new_map.n_shards != self.group_map.n_shards:
            raise ValueError("adopted map covers a different shard space")
        self.group_map = new_map
        return True


# ---------------------------------------------------------------------------
# Process-group harness: one durable replica process set per group
# ---------------------------------------------------------------------------


class GroupProcHarness:
    """N independent durable consensus groups, each a
    :class:`~rabia_tpu_torch.testing.recovery.RecoveryHarness` of real OS
    processes under its own WAL subtree. Every child is configured with
    the FULL global shard space plus its group's owned ranges, so the
    replica gateways enforce group locality and the per-shard metric
    labels stay globally meaningful across groups."""

    def __init__(
        self,
        group_map: GroupMap,
        n_replicas: int = 3,
        wal_root: Optional[str] = None,
        extras: Optional[dict] = None,
    ) -> None:
        import tempfile

        from rabia_tpu_torch.testing.recovery import RecoveryHarness

        self.group_map = group_map
        self.n_replicas = n_replicas
        self.wal_root = wal_root or tempfile.mkdtemp(prefix="rabia-groups-")
        self.harnesses: dict[int, RecoveryHarness] = {}
        for g in group_map.groups():
            gx = dict(extras or {})
            gx["group"] = g
            gx["group_shards"] = [
                [lo, hi] for lo, hi in group_map.ranges_of(g)
            ]
            self.harnesses[g] = RecoveryHarness(
                n_replicas=n_replicas,
                n_shards=group_map.n_shards,
                wal_root=os.path.join(self.wal_root, f"group-{g}"),
                extras=gx,
            )

    def start(self, timeout: float = 120.0) -> dict[int, list[dict]]:
        """Spawn every group's replicas; returns ready reports by group.
        Groups spawn together and are awaited together, so wall time is
        one group's startup, not the sum."""
        for h in self.harnesses.values():
            for i in range(h.n):
                h._spawn(i)
        return {
            g: [
                h.procs[i].wait_event("ready", timeout)
                for i in range(h.n)
            ]
            for g, h in self.harnesses.items()
        }

    def endpoints(self, group: int):
        return self.harnesses[group].endpoints()

    def upstream_addrs(self) -> dict[int, list[tuple[str, int]]]:
        """``{group: [(host, port), ...]}`` of replica gateway ports —
        the :class:`GroupRouter` construction input."""
        return {
            g: [("127.0.0.1", p) for p in h.gw_ports]
            for g, h in self.harnesses.items()
        }

    def router(self) -> GroupRouter:
        return GroupRouter(self.group_map, self.upstream_addrs())

    def kill9(self, group: int, idx: int) -> None:
        self.harnesses[group].kill9(idx)

    def restart(self, group: int, idx: int, timeout: float = 120.0) -> dict:
        return self.harnesses[group].restart(idx, timeout)

    def alive(self) -> dict[int, int]:
        """Live replica processes per group (the watchdog membership
        sample: a killed proposer reads as members_alive < total)."""
        out: dict[int, int] = {}
        for g, h in self.harnesses.items():
            out[g] = sum(
                1
                for rp in h.procs
                if rp is not None and rp.proc.poll() is None
            )
        return out

    async def rebalance(self, lo: int, hi: int, group: int) -> GroupMap:
        """Move ``[lo, hi)`` to ``group`` in the SAFE order: widen the
        new owner's replica gateways first (they accept the range before
        any router sends it), then flip the map, then shrink the old
        owners. Returns the new map (callers push it to their routing
        tier — this harness owns only the replica plane)."""
        new_map = self.group_map.copy()
        new_map.move_range(lo, hi, group)
        await self._push_group_ranges(group, new_map.ranges_of(group))
        old_map, self.group_map = self.group_map, new_map
        for g in old_map.groups():
            if g != group and new_map.ranges_of(g) != old_map.ranges_of(g):
                await self._push_group_ranges(g, new_map.ranges_of(g))
        # refresh spawn extras so a replica restarted AFTER the move
        # comes up owning the post-rebalance ranges, not the stale ones
        for g, h in self.harnesses.items():
            h.extras["group_shards"] = [
                [lo_, hi_] for lo_, hi_ in new_map.ranges_of(g)
            ]
        return new_map

    async def _push_group_ranges(
        self, group: int, ranges: list[tuple[int, int]]
    ) -> None:
        import json

        from rabia_tpu_torch.core.messages import AdminKind
        from rabia_tpu_torch.gateway.client import admin_fetch

        h = self.harnesses[group]
        query = json.dumps(
            {"op": "set_group", "shards": [[lo, hi] for lo, hi in ranges]}
        ).encode()
        for i, port in enumerate(h.gw_ports):
            rp = h.procs[i]
            if rp is None or rp.proc.poll() is not None:
                continue  # a dead replica re-reads ranges on restart
            await admin_fetch(
                "127.0.0.1", port, kind=int(AdminKind.RING),
                timeout=10.0, query=query,
            )

    def stop(self) -> None:
        for h in self.harnesses.values():
            h.stop()


# ---------------------------------------------------------------------------
# Grouped fleet harness: fleet gateways routing to N replica planes
# ---------------------------------------------------------------------------


class GroupedFleetHarness:
    """Fleet gateways (:class:`~rabia_tpu_torch.fleet.gateway_proc
    .FleetGateway`) configured with ``upstream_groups`` so the routed
    front door sends each Submit to the owning group's upstream lane.
    Owns only the routing tier — the replica planes behind it are
    whatever the caller built (in-process :class:`~rabia_tpu_torch.testing
    .gateway_cluster.GatewayCluster`s or a :class:`GroupProcHarness`)."""

    def __init__(
        self,
        group_map: GroupMap,
        upstreams: dict[int, Sequence[tuple[str, int]]],
        n_gateways: int = 1,
        replication_factor: int = 1,
        forward_timeout: float = 30.0,
    ) -> None:
        self.group_map = group_map
        self.upstreams = {
            int(g): [(str(h), int(p)) for h, p in addrs]
            for g, addrs in upstreams.items()
        }
        self.n_gateways = n_gateways
        self.replication_factor = replication_factor
        self.forward_timeout = forward_timeout
        self.gateways: list = []

    async def start(self) -> None:
        from rabia_tpu_torch.core.types import NodeId
        from rabia_tpu_torch.fleet.gateway_proc import (
            FleetGateway,
            FleetGatewayConfig,
        )
        from rabia_tpu_torch.fleet.ring import HashRing

        groups = sorted(self.upstreams)
        upstream_groups = tuple(
            tuple(self.upstreams[g]) for g in groups
        )
        if groups != list(range(len(groups))):
            raise ValueError(
                "group ids must be dense 0..G-1 (they index "
                f"upstream_groups); got {groups}"
            )
        for i in range(self.n_gateways):
            gw = FleetGateway(
                FleetGatewayConfig(
                    name=f"gw{i}",
                    # flattened list: what the fleet aggregator walks to
                    # scrape the replica tier (every group's replicas)
                    upstreams=tuple(
                        a for grp in upstream_groups for a in grp
                    ),
                    upstream_groups=upstream_groups,
                    groups=self.group_map.to_doc(),
                    n_shards=self.group_map.n_shards,
                    replication_factor=self.replication_factor,
                    forward_timeout=self.forward_timeout,
                ),
                node_id=NodeId.from_int(2000 + i),
            )
            await gw.start()
            self.gateways.append(gw)
        ring = HashRing()
        for gw in self.gateways:
            ring.add(gw.member())
        for gw in self.gateways:
            gw.adopt_ring(ring.copy())

    def endpoints(self):
        from rabia_tpu_torch.gateway.server import GatewayEndpoint

        return [
            GatewayEndpoint(
                node_id=gw.node_id,
                host=gw.config.bind_host,
                port=gw.port,
            )
            for gw in self.gateways
        ]

    def adopt_groups(self, new_map: GroupMap) -> None:
        """Flip routing on every fleet gateway (the middle step of the
        safe rebalance order — replica-side ranges widen first)."""
        self.group_map = new_map
        for gw in self.gateways:
            gw.adopt_groups(new_map.copy())

    async def stop(self) -> None:
        for gw in self.gateways:
            await gw.close()
        self.gateways.clear()
