"""Persistence trait and the persisted engine-state blob.

A copy of the reference package's ``rabia_tpu/core/persistence.py``: the
single-blob ``PersistenceLayer`` trait (save one opaque state blob, load
it back, plus small named *aux* blobs) and ``PersistedEngineState``
(phase counters, the per-shard slot vectors and the replica snapshot, as
JSON). The encoding is the reference's, byte for byte.
"""

from __future__ import annotations

import abc
import base64
import json
from dataclasses import dataclass, field
from typing import Optional

from rabia_tpu_torch.core.errors import PersistenceError
from rabia_tpu_torch.core.state_machine import Snapshot


@dataclass
class PersistedEngineState:
    """Durable engine record (persistence.rs:9-42)."""

    current_phase: int = 0
    last_committed_phase: int = 0
    state_version: int = 0
    snapshot: Optional[Snapshot] = None
    per_shard_phase: list[int] = field(default_factory=list)
    per_shard_committed: list[int] = field(default_factory=list)
    # per-shard V1-applied batch counts (the unit of state_version)
    per_shard_version: list[int] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        doc = {
            "current_phase": self.current_phase,
            "last_committed_phase": self.last_committed_phase,
            "state_version": self.state_version,
            "snapshot": (
                base64.b64encode(self.snapshot.to_bytes()).decode("ascii")
                if self.snapshot
                else None
            ),
            "per_shard_phase": self.per_shard_phase,
            "per_shard_committed": self.per_shard_committed,
            "per_shard_version": self.per_shard_version,
        }
        return json.dumps(doc, separators=(",", ":")).encode("utf-8")

    @staticmethod
    def from_bytes(raw: bytes) -> "PersistedEngineState":
        try:
            doc = json.loads(raw.decode("utf-8"))
            snap = (
                Snapshot.from_bytes(base64.b64decode(doc["snapshot"]))
                if doc.get("snapshot")
                else None
            )
            return PersistedEngineState(
                current_phase=int(doc["current_phase"]),
                last_committed_phase=int(doc["last_committed_phase"]),
                state_version=int(doc.get("state_version", 0)),
                snapshot=snap,
                per_shard_phase=[int(x) for x in doc.get("per_shard_phase", [])],
                per_shard_committed=[
                    int(x) for x in doc.get("per_shard_committed", [])
                ],
                per_shard_version=[
                    int(x) for x in doc.get("per_shard_version", [])
                ],
            )
        except (ValueError, KeyError) as e:
            raise PersistenceError(f"corrupt engine state: {e}") from None


class PersistenceLayer(abc.ABC):
    """Single-blob durability trait (persistence.rs:49-68).

    Beyond the reference's single blob, backends may support small named
    *aux* blobs via :meth:`save_aux` / :meth:`load_aux`. The engine uses one
    ("vote_barrier") as a write-ahead record of the highest slot each shard
    may have voted in, so a restarted replica can avoid equivocating —
    casting a different vote in a (slot, phase) it already voted in before
    the crash. Aux blobs are tiny (bytes of an int64[S] array) and written
    far more often than the full snapshot, hence the separate channel. The
    defaults are no-ops (load returns None): a backend that ignores them
    degrades to the reference's behavior (no restart-equivocation guard),
    it does not break.
    """

    @abc.abstractmethod
    async def save_state(self, data: bytes) -> None:
        ...

    @abc.abstractmethod
    async def load_state(self) -> Optional[bytes]:
        ...

    async def save_aux(self, key: str, data: bytes) -> None:
        return None

    async def load_aux(self, key: str) -> Optional[bytes]:
        return None

    async def save_engine_state(self, state: PersistedEngineState) -> None:
        await self.save_state(state.to_bytes())

    async def load_engine_state(self) -> Optional[PersistedEngineState]:
        raw = await self.load_state()
        return PersistedEngineState.from_bytes(raw) if raw is not None else None
