"""Routed gateway fleet: many standalone gateway processes behind a
consistent-hash front door (docs/FLEET.md).

- :mod:`rabia_tpu_torch.fleet.ring` — the consistent-hash router mapping
  shard -> owning gateway, with bounded-movement rebalance;
- :mod:`rabia_tpu_torch.fleet.ledger` — completed-result records replicated
  to the shard's gateway group (exactly-once across gateway failover);
- :mod:`rabia_tpu_torch.fleet.handoff` — session transfer on planned
  rebalance (windows, ack frontiers, inflight reservations);
- :mod:`rabia_tpu_torch.fleet.gateway_proc` — the standalone gateway itself:
  holds sessions and forward windows, proxies Submits to the replica
  cluster over the mux transport lane, answers ``MOVED`` for shards it
  does not own;
- :mod:`rabia_tpu_torch.fleet.harness` — in-process fleet harness + the
  MOVED-following client session used by tests/chaos/bench;
- :mod:`rabia_tpu_torch.fleet.groups` — shard-group scale-out: the versioned
  GroupMap partitioning the shard space into independent consensus
  groups (own replica processes, WAL, coalescing windows), the
  GroupRouter resolving shard -> owning group's upstream, and the
  process-group harnesses.

The port's copy of the reference's ``rabia_tpu/fleet/__init__.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from rabia_tpu_torch.fleet.ring import HashRing, RingMember, moved_shards
from rabia_tpu_torch.fleet.ledger import LedgerRecord, apply_record
from rabia_tpu_torch.fleet.gateway_proc import FleetGateway, FleetGatewayConfig
from rabia_tpu_torch.fleet.groups import (
    GroupMap,
    GroupRouter,
    GroupProcHarness,
    GroupedFleetHarness,
    moved_group_shards,
)

__all__ = [
    "HashRing",
    "RingMember",
    "moved_shards",
    "LedgerRecord",
    "apply_record",
    "FleetGateway",
    "FleetGatewayConfig",
    "GroupMap",
    "GroupRouter",
    "GroupProcHarness",
    "GroupedFleetHarness",
    "moved_group_shards",
]
