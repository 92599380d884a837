"""Ingest-path validation.

Reference parity: rabia-core/src/validation.rs — Validator trait (:5-7),
per-message structural checks + clock-skew windows (:30-124), batch limits
(:126-180), monotonic phase sequence checks (:182-226).
"""

from __future__ import annotations

import time
from typing import Optional, Protocol

import numpy as np

from rabia_tpu_torch.core.config import ValidationConfig
from rabia_tpu_torch.core.errors import ValidationError
from rabia_tpu_torch.core.messages import (
    Decision,
    HeartBeat,
    NewBatch,
    ProposeBlock,
    ProtocolMessage,
    Propose,
    SyncRequest,
    SyncResponse,
    VoteRound1,
    VoteRound2,
)
from rabia_tpu_torch.core.types import CommandBatch, StateValue


class Validator(Protocol):
    """Validator trait (validation.rs:5-7)."""

    def validate_message(self, msg: ProtocolMessage) -> None: ...

    def validate_batch(self, batch: CommandBatch) -> None: ...


class MessageValidator:
    """Structural + temporal validation of inbound protocol traffic."""

    def __init__(self, config: ValidationConfig | None = None):
        self.config = config or ValidationConfig()
        self._last_phase_seen: dict = {}

    # -- messages ----------------------------------------------------------

    def validate_message(self, msg: ProtocolMessage, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self._validate_timestamp(msg.timestamp, now)
        payload = msg.payload
        if isinstance(payload, Propose):
            self._validate_propose(payload)
        elif isinstance(payload, ProposeBlock):
            self._validate_block(payload)
        elif isinstance(payload, (VoteRound1, VoteRound2)):
            self._validate_votes(payload)
        elif isinstance(payload, Decision):
            if len(payload) and (
                (payload.vals == int(StateValue.VQuestion)).any()
            ):
                raise ValidationError("decision cannot be V?")
            if len(payload) and (
                int(payload.phases.min()) < 0 or int(payload.shards.min()) < 0
            ):
                raise ValidationError("negative phase/shard in decision")
        elif isinstance(payload, (SyncRequest, HeartBeat)):
            self._validate_phase(payload.current_phase)
        elif isinstance(payload, SyncResponse):
            self._validate_phase(payload.responder_phase)
        elif isinstance(payload, NewBatch):
            self.validate_batch(payload.batch)

    def _validate_timestamp(self, ts: float, now: float) -> None:
        if ts > now + self.config.max_future_skew:
            raise ValidationError(
                f"message timestamp {ts - now:.1f}s in the future "
                f"(max {self.config.max_future_skew}s)"
            )
        if ts < now - self.config.max_age:
            raise ValidationError(
                f"message is {now - ts:.1f}s old (max {self.config.max_age}s)"
            )

    def _validate_propose(self, p: Propose) -> None:
        self._validate_phase(p.phase)
        if p.value == StateValue.Absent:
            raise ValidationError("proposal value cannot be ABSENT")
        if p.batch is not None:
            self.validate_batch(p.batch)

    def _validate_votes(self, v: VoteRound1 | VoteRound2) -> None:
        """Structural check only. Element-wise bounds are enforced by the
        engine's vectorized ingest (which must mask-filter before any
        fancy indexing anyway); re-scanning every entry here would double
        the per-message cost of the hottest wire path. ABSENT vote codes
        are harmless by construction (offering ABSENT into a ledger cell
        is a no-op) and negative phases resolve as stale slots."""
        if len(v) == 0:
            raise ValidationError("vote vector must be non-empty")

    def _validate_phase(self, phase: int) -> None:
        if phase < 0:
            raise ValidationError(f"negative phase {phase}")

    def _validate_block(self, p: ProposeBlock) -> None:
        b = p.block
        if len(b) == 0:
            raise ValidationError("block must cover at least one shard")
        if int(b.shards.min()) < 0:
            raise ValidationError("negative shard index in block")
        if int(b.slots.min()) < 0:
            raise ValidationError("block slots must be assigned (>= 0)")
        if int(b.counts.min()) < 1:
            raise ValidationError("every covered shard needs >= 1 command")
        # uniqueness of covered shards (binding arrays assume it); blocks
        # are shard-sorted in practice, so the cheap monotonic check
        # usually settles it
        if len(b) > 1:
            d = np.diff(b.shards)
            if not (d > 0).all() and len(np.unique(b.shards)) != len(b.shards):
                raise ValidationError("block shards must be unique")
        if int(b.counts.max()) > self.config.max_commands_per_batch:
            raise ValidationError(
                f"block shard batch exceeds {self.config.max_commands_per_batch} commands"
            )
        if b.total_commands and int(b.cmd_sizes.max()) > self.config.max_command_size:
            raise ValidationError(
                f"block command exceeds {self.config.max_command_size} bytes"
            )

    # -- batches (validation.rs:126-180) -----------------------------------

    def validate_batch(self, batch: CommandBatch) -> None:
        if batch.is_empty():
            raise ValidationError("batch must contain at least one command")
        if len(batch) > self.config.max_commands_per_batch:
            raise ValidationError(
                f"batch has {len(batch)} commands "
                f"(max {self.config.max_commands_per_batch})"
            )
        for c in batch.commands:
            if c.size() > self.config.max_command_size:
                raise ValidationError(
                    f"command {c.id} is {c.size()} bytes "
                    f"(max {self.config.max_command_size})"
                )

    # -- phase-sequence sanity (validation.rs:182-226) ----------------------

    def check_phase_progression(self, key, new_phase: int) -> bool:
        """True if the jump from the last-seen phase looks sane.

        Large forward jumps (> max_phase_jump) are suspicious but allowed
        (sync can legitimately fast-forward); callers may log/deprioritize.
        """
        last = self._last_phase_seen.get(key, -1)
        self._last_phase_seen[key] = max(last, new_phase)
        if new_phase < last:
            return True  # old traffic — duplicate delivery, not suspicious
        return (new_phase - last) <= self.config.max_phase_jump
