"""Durability backends for the single-blob persistence model.

Reference parity: the rabia-persistence crate (SURVEY.md §1.3) — Rabia
persists one opaque state blob (no WAL; in-flight phases are re-derived
from peers via sync, rabia-core/src/persistence.rs:44-48).
"""

from rabia_tpu_torch.persistence.backends import FileSystemPersistence, InMemoryPersistence
from rabia_tpu_torch.persistence.native_wal import WalPersistence

__all__ = ["FileSystemPersistence", "InMemoryPersistence", "WalPersistence"]
