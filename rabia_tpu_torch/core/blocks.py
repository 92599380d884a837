"""Payload blocks: one proposer's whole cycle of batches, columnar.

The scalar lane carries one ``Propose(CommandBatch)`` per (shard, slot) —
fine for sparse traffic, hopeless for the dense lockstep case where a
replica proposes for ~S/R shards *every cycle* (each scalar Propose costs a
Python decode on every receiver). A :class:`PayloadBlock` packs all of a
proposer's current-cycle batches into ONE broadcast message with columnar
layout (shard/slot/count arrays + one concatenated command-bytes buffer),
so binding, validation and routing on the receiver are bulk array ops and
the per-command cost is two offsets and a byte-slice at apply time.

No direct reference analog (the reference proposes one batch per phase —
rabia-engine/src/engine.rs:312-347); this is the S-axis design of
SURVEY.md §7.1 applied to the payload plane.

Identity: a command inside a block has no UUID — its replicated identity
is derived from ``(block.id, shard)`` for the batch and the position ``j``
within the shard's region for the command. ``block_batch_id(block_id,
shard)`` derives a real, wire-representable :class:`BatchId` (every replica
derives the same id for the same block region), so block-lane ids flow
through the binary codec (SyncResponse.applied_ids, Decision.batch_id)
exactly like scalar-lane ids.

The port's copy of the reference package's ``rabia_tpu/core/blocks.py``:
the same layout, ids and validation (tests/test_torch_blocks_vector_kv.py
checks the fields and ids against the reference).
"""

from __future__ import annotations

import uuid
import zlib
from typing import Optional, Sequence

import numpy as np

from rabia_tpu_torch.core.errors import ValidationError
from rabia_tpu_torch.core.types import BatchId, Command, CommandBatch, ShardId, fast_uuid4

# 128-bit odd mixing constant (golden-ratio extension) — spreads the shard
# index across the whole id so distinct shards of one block never collide.
_SHARD_MIX = 0x9E3779B97F4A7C15F39CC0605CEDC835
_U128 = (1 << 128) - 1


def block_batch_id(block_id: uuid.UUID, shard: int) -> BatchId:
    """Deterministic :class:`BatchId` for one shard's batch inside a block.

    Pure function of ``(block_id, shard)`` so every replica derives the
    identical id without coordination; XOR-multiply mixing keeps it cheap
    enough for the bulk lane (no hashing).
    """
    mixed = (block_id.int ^ (((int(shard) + 1) * _SHARD_MIX) & _U128)) & _U128
    return BatchId(uuid.UUID(int=mixed))


def block_id_for_batch(batch_id: uuid.UUID, shard: int) -> uuid.UUID:
    """Inverse of :func:`block_batch_id`: the block id whose covered
    ``shard`` carries exactly ``batch_id``. The XOR mix is an involution,
    so applying :func:`block_batch_id` to a batch id yields the block id
    — ONE copy of the consensus-critical mix expression. A caller that
    already owns a deterministic batch id (the gateway's ``(client_id,
    seq)``-derived ids) can thereby route it through the block lane and
    commit it under the SAME id the scalar lane would use — replays
    dedup in the engine's ``applied_ids`` ledger regardless of which
    lane the original rode."""
    bid = batch_id.value if isinstance(batch_id, BatchId) else batch_id
    return block_batch_id(bid, shard).value


class PayloadBlock:
    """Columnar batch-of-batches covering a set of shards.

    Arrays (parallel over the k covered shards):
      - ``shards`` i64[k] — covered shard indices (unique);
      - ``slots`` i64[k] — the decision slot each batch is bound to
        (-1 until the proposer assigns slots at open time);
      - ``counts`` i32[k] — commands per shard;
    plus the command plane:
      - ``cmd_sizes`` i64[total] — per-command byte length, shard-major;
      - ``data`` bytes — concatenated command payloads.
    """

    __slots__ = (
        "id",
        "shards",
        "slots",
        "counts",
        "cmd_sizes",
        "data",
        "aliases",
        "_cmd_offsets",
        "_shard_starts",
        "_id_cache",
    )

    def __init__(
        self,
        block_id: uuid.UUID,
        shards: np.ndarray,
        slots: np.ndarray,
        counts: np.ndarray,
        cmd_sizes: np.ndarray,
        data: bytes,
    ) -> None:
        self.id = block_id
        self.shards = np.asarray(shards, np.int64)
        self.slots = np.asarray(slots, np.int64)
        self.counts = np.asarray(counts, np.int64)
        self.cmd_sizes = np.asarray(cmd_sizes, np.int64)
        # exact bytes, enforced: downstream numpy object-array stores
        # (`vbufs[a:b] = block.data`, apps/vector_kv.py) treat bytes as a
        # scalar ref — a bytearray/memoryview would broadcast
        # element-wise there. bytes(b) is a no-op for bytes input.
        self.data = bytes(data)
        if not (len(self.shards) == len(self.slots) == len(self.counts)):
            raise ValidationError("block arrays must be parallel")
        if int(self.counts.sum()) != len(self.cmd_sizes):
            raise ValidationError("block counts disagree with cmd_sizes")
        if int(self.cmd_sizes.sum()) != len(data):
            raise ValidationError("block cmd_sizes disagree with data length")
        self._cmd_offsets: Optional[np.ndarray] = None
        self._shard_starts: Optional[np.ndarray] = None
        self._id_cache: dict[int, BatchId] = {}
        # per-entry ALIAS batch ids (proposer-local, NEVER on the wire):
        # the cross-session coalescing lane packs many clients' commands
        # into one entry, and each non-lead client's deterministic
        # (client_id, seq)-derived id rides here as
        # (bid_bytes16, op_lo, op_hi) — op indices RELATIVE to the
        # entry's command range. The apply/settle paths register every
        # alias in the engine's ``applied_ids`` dedup ledger (and stage
        # K_LEDGER records on durable clusters) so a replayed Submit
        # dedups exactly like a scalar-lane commit would, even though
        # the wire only ever carried the entry's lead-derived id.
        self.aliases: Optional[dict[int, tuple]] = None

    # -- derived indices ------------------------------------------------------

    @property
    def cmd_offsets(self) -> np.ndarray:
        """i64[total+1] byte offset of each command in ``data``."""
        if self._cmd_offsets is None:
            self._cmd_offsets = np.concatenate(
                ([0], np.cumsum(self.cmd_sizes))
            )
        return self._cmd_offsets

    @property
    def shard_starts(self) -> np.ndarray:
        """i64[k+1] first command index of each covered shard."""
        if self._shard_starts is None:
            self._shard_starts = np.concatenate(([0], np.cumsum(self.counts)))
        return self._shard_starts

    def __len__(self) -> int:
        return len(self.shards)

    @property
    def total_commands(self) -> int:
        return len(self.cmd_sizes)

    def checksum(self) -> int:
        return zlib.crc32(self.data) & 0xFFFFFFFF

    # -- per-shard access -----------------------------------------------------

    def commands_for(self, i: int) -> list[bytes]:
        """Command payload bytes of covered-shard index ``i`` (slices)."""
        starts = self.shard_starts
        offs = self.cmd_offsets
        lo, hi = int(starts[i]), int(starts[i + 1])
        return [
            self.data[int(offs[j]) : int(offs[j + 1])] for j in range(lo, hi)
        ]

    def batch_id_for(self, i: int) -> BatchId:
        bid = self._id_cache.get(i)
        if bid is None:
            bid = block_batch_id(self.id, int(self.shards[i]))
            self._id_cache[i] = bid
        return bid

    def alias_ids_for(self, i: int) -> tuple:
        """Alias (bid_bytes16, op_lo, op_hi) triples of covered-shard
        index ``i`` (empty for every lane but the coalescing lane)."""
        if self.aliases is None:
            return ()
        return self.aliases.get(i, ())

    def materialize_batch(self, i: int) -> CommandBatch:
        """Build a scalar-lane CommandBatch for covered-shard index ``i``
        (demotion/fallback path). The batch id is the entry's replicated
        identity (:func:`block_batch_id`), so a demoted entry commits
        under the SAME id it would have carried in the block lane and the
        ``applied_ids`` dedup ledger stays lane-agnostic. Command UUIDs
        are freshly generated and therefore NOT replicated — consumers
        must not let responses depend on command ids (none of the
        built-in SMs do)."""
        cmds = tuple(Command.new(b) for b in self.commands_for(i))
        return CommandBatch(
            id=self.batch_id_for(i),
            commands=cmds,
            shard=ShardId(int(self.shards[i])),
            aliases=self.alias_ids_for(i),
        )

    def subset(self, idxs: np.ndarray) -> "PayloadBlock":
        """A new block covering only the given covered-shard indices (used
        when an open wave covers part of the block). Shares the id — batch
        identities are per (id, shard), so a subset stays consistent."""
        idxs = np.asarray(idxs, np.int64)
        starts = self.shard_starts
        offs = self.cmd_offsets
        pieces = []
        sizes = []
        for i in idxs:
            lo, hi = int(starts[i]), int(starts[i + 1])
            pieces.append(self.data[int(offs[lo]) : int(offs[hi])])
            sizes.append(self.cmd_sizes[lo:hi])
        sub = PayloadBlock(
            self.id,
            self.shards[idxs],
            self.slots[idxs],
            self.counts[idxs],
            np.concatenate(sizes) if sizes else np.zeros(0, np.int64),
            b"".join(pieces),
        )
        if self.aliases:
            # alias op ranges are entry-relative, so they survive the
            # subset unchanged — only the covered-shard index remaps
            remapped = {
                j: self.aliases[int(i)]
                for j, i in enumerate(idxs)
                if int(i) in self.aliases
            }
            sub.aliases = remapped or None
        return sub


def build_block(
    shards: Sequence[int] | np.ndarray,
    commands: Sequence[Sequence[bytes]],
    block_id: Optional[uuid.UUID] = None,
) -> PayloadBlock:
    """Assemble a block from per-shard command lists (client side)."""
    shards = np.asarray(shards, np.int64)
    if len(shards) != len(commands):
        raise ValidationError("one command list per shard required")
    if len(np.unique(shards)) != len(shards):
        raise ValidationError("block shards must be unique")
    counts = np.fromiter((len(c) for c in commands), np.int64, len(commands))
    if len(counts) and int(counts.min()) < 1:
        raise ValidationError("every covered shard needs >= 1 command")
    flat: list[bytes] = [b for cs in commands for b in cs]
    sizes = np.fromiter((len(b) for b in flat), np.int64, len(flat))
    return PayloadBlock(
        block_id or fast_uuid4(),
        shards,
        np.full(len(shards), -1, np.int64),
        counts,
        sizes,
        b"".join(flat),
    )
