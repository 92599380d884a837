"""Command batching: size+time flush with adaptive sizing.

Reference parity: rabia-core/src/batching.rs — ``BatchConfig`` (:8-29),
``CommandBatcher`` with size/time flush and the ±10% adaptive algorithm
(:50-166; the adaptive rule :150-165 widens the batch when flushes are
size-triggered and shrinks it when they are timeout-triggered),
``AsyncCommandBatcher`` (:168-259), ``BatchProcessor`` (:261-326) and
``BatchStats`` (:32-48).

TPU relevance: the batcher is what turns an irregular client command stream
into *fixed-cadence, per-shard* batches so the device sees dense steps; the
adaptive size targets keeping every kernel dispatch busy.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from rabia_tpu_torch.core.config import BatchConfig
from rabia_tpu_torch.core.types import Command, CommandBatch, ShardId


@dataclass
class BatchStats:
    """Batching counters (batching.rs:32-48)."""

    batches_created: int = 0
    commands_batched: int = 0
    size_flushes: int = 0
    timeout_flushes: int = 0
    manual_flushes: int = 0
    current_target_size: int = 0

    @property
    def avg_batch_size(self) -> float:
        if not self.batches_created:
            return 0.0
        return self.commands_batched / self.batches_created


class CommandBatcher:
    """Synchronous batcher (batching.rs:50-166).

    Accumulates commands; flushes when the adaptive target size is reached or
    ``max_batch_delay`` has elapsed since the first pending command. Poll
    :meth:`poll` from the engine loop, or :meth:`add` which returns a flushed
    batch when the add itself triggers one.
    """

    def __init__(self, config: BatchConfig | None = None, shard: ShardId = ShardId(0)):
        self.config = config or BatchConfig()
        self.shard = shard
        self._pending: list[Command] = []
        self._first_pending_at: Optional[float] = None
        self._last_adapt_total = 0
        self._target_size = self.config.max_batch_size
        self.stats = BatchStats(current_target_size=self._target_size)

    @property
    def target_size(self) -> int:
        return self._target_size

    def add(self, command: Command, now: Optional[float] = None) -> Optional[CommandBatch]:
        now = time.monotonic() if now is None else now
        if len(self._pending) >= self.config.buffer_capacity:
            # backpressure: force a flush rather than dropping
            return self._flush("size", now, extra=command)
        self._pending.append(command)
        if self._first_pending_at is None:
            self._first_pending_at = now
        if len(self._pending) >= self._target_size:
            return self._flush("size", now)
        return None

    def poll(self, now: Optional[float] = None) -> Optional[CommandBatch]:
        """Time-based flush check; call at engine-loop cadence."""
        now = time.monotonic() if now is None else now
        if (
            self._pending
            and self._first_pending_at is not None
            and now - self._first_pending_at >= self.config.max_batch_delay
        ):
            return self._flush("timeout", now)
        return None

    def flush(self, now: Optional[float] = None) -> Optional[CommandBatch]:
        now = time.monotonic() if now is None else now
        if not self._pending:
            return None
        return self._flush("manual", now)

    def pending_count(self) -> int:
        return len(self._pending)

    def _flush(
        self, cause: str, now: float, extra: Optional[Command] = None
    ) -> CommandBatch:
        cmds = self._pending
        self._pending = [extra] if extra is not None else []
        self._first_pending_at = now if extra is not None else None
        batch = CommandBatch.new(cmds, shard=self.shard)
        self.stats.batches_created += 1
        self.stats.commands_batched += len(cmds)
        if cause == "size":
            self.stats.size_flushes += 1
        elif cause == "timeout":
            self.stats.timeout_flushes += 1
        else:
            self.stats.manual_flushes += 1
        # only automatic flushes carry a demand signal; manual flushes must
        # not re-trigger adaptation at a stale flush count
        if self.config.adaptive and cause in ("size", "timeout"):
            self._adapt()
        return batch

    def _adapt(self) -> None:
        """±step sizing from the flush-cause ratio (batching.rs:150-165).

        Mostly size-triggered flushes → demand is high → grow the target by
        ``adaptive_step``; mostly timeout-triggered → shrink. Clamped to
        [min_adaptive_size, max_adaptive_size].
        """
        total = self.stats.size_flushes + self.stats.timeout_flushes
        if total < 10 or total % 10 or total == self._last_adapt_total:
            return  # adapt every 10 automatic flushes, once per count
        self._last_adapt_total = total
        ratio = self.stats.size_flushes / total
        step = max(1, int(self._target_size * self.config.adaptive_step))
        if ratio > 0.8:
            self._target_size += step
        elif ratio < 0.2:
            self._target_size -= step
        self._target_size = min(
            self.config.max_adaptive_size,
            max(self.config.min_adaptive_size, self._target_size),
        )
        self.stats.current_target_size = self._target_size


class AsyncCommandBatcher:
    """Asyncio-task batcher (batching.rs:168-259).

    Commands go in via :meth:`submit`; completed batches come out of
    :attr:`batches` (an ``asyncio.Queue``). A background task enforces the
    time-flush deadline.
    """

    def __init__(self, config: BatchConfig | None = None, shard: ShardId = ShardId(0)):
        self._inner = CommandBatcher(config, shard)
        self.batches: asyncio.Queue[CommandBatch] = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._closed = False

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._ticker())

    async def submit(self, command: Command) -> None:
        if self._closed:
            raise RuntimeError("batcher closed")
        batch = self._inner.add(command)
        if batch is not None:
            await self.batches.put(batch)

    async def _ticker(self) -> None:
        delay = max(self._inner.config.max_batch_delay / 2, 0.001)
        while not self._closed:
            await asyncio.sleep(delay)
            batch = self._inner.poll()
            if batch is not None:
                await self.batches.put(batch)

    async def close(self) -> None:
        self._closed = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        batch = self._inner.flush()
        if batch is not None:
            await self.batches.put(batch)

    @property
    def stats(self) -> BatchStats:
        return self._inner.stats


class BatchProcessor:
    """Applies an optional transform then an apply fn over batches
    (batching.rs:261-326). ``parallel`` fans commands out to an executor —
    useful only for I/O-bound state machines; CPU-bound ones should stay
    sequential (determinism requires order-independence if parallel)."""

    def __init__(
        self,
        apply: Callable[[Command], Awaitable[bytes]],
        transform: Optional[Callable[[CommandBatch], CommandBatch]] = None,
        parallel: bool = False,
    ):
        self._apply = apply
        self._transform = transform
        self._parallel = parallel

    async def process(self, batch: CommandBatch) -> list[bytes]:
        if self._transform:
            batch = self._transform(batch)
        if self._parallel:
            return list(
                await asyncio.gather(*(self._apply(c) for c in batch.commands))
            )
        return [await self._apply(c) for c in batch.commands]


class ShardedBatcher:
    """One batcher per shard — the host-side feeder of the [S]-wide kernel.

    No single-object reference analog (the reference has one consensus
    instance); this is the fan-out of C8 across the TPU shard axis.
    """

    def __init__(self, num_shards: int, config: BatchConfig | None = None):
        self.config = config or BatchConfig()
        self.batchers = [
            CommandBatcher(self.config, ShardId(s)) for s in range(num_shards)
        ]

    def add(self, shard: int, command: Command) -> Optional[CommandBatch]:
        return self.batchers[shard].add(command)

    def poll_all(self) -> list[CommandBatch]:
        out = []
        now = time.monotonic()
        for b in self.batchers:
            batch = b.poll(now)
            if batch is not None:
                out.append(batch)
        return out

    def flush_all(self) -> list[CommandBatch]:
        return [b for b in (bb.flush() for bb in self.batchers) if b is not None]
