"""Pipelined apply stage: decided slots drain decoupled from the tick.

Before this module the engine applied EVERY ready slot inline in
``_tick`` (engine.rs:684-746 parity): a deep decided backlog — a healed
replica adopting hundreds of Decisions, a slow state machine, a post-
crash resync — stalled the consensus tick behind state-machine work, so
peers timed out and retransmitted into exactly the replica that was
busiest (docs/PERFORMANCE.md, transport tier).

The split: :meth:`ApplyPlane.apply_ready` applies up to an inline budget
synchronously (the serial commit path keeps its latency — one decided
slot never waits for a scheduler hop), and defers anything beyond it to
a background drain task that applies bounded chunks with a yield between
chunks — decided batches queue here while the NEXT consensus round
progresses on the loop. Frontier semantics are unchanged: a slot's
``applied_upto`` advance, its flight APPLY record, its submitter-future
settle and the gateway frontier listeners all still happen exactly at
apply time, in per-shard slot order (the drain never reorders a shard's
log; it only moves WHEN the tail of a backlog applies).

The port of the reference's ``rabia_tpu/engine/apply_plane.py``. The
state-machine work itself is the state machine's own ``apply_batch`` /
``apply_block`` (a native store applies a wave in one C call).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

logger = logging.getLogger("rabia_tpu_torch.engine.apply_plane")


class ApplyPlane:
    """Per-engine apply scheduler (see module doc).

    ``inline_budget`` slots apply synchronously per tick; the rest queue
    to the drain task (``chunk`` slots per scheduling generation).
    ``RABIA_APPLY_INLINE`` overrides the budget (0 = defer everything —
    differential testing of the drain path)."""

    INLINE_BUDGET = 512
    CHUNK = 256

    def __init__(self, engine) -> None:
        self.engine = engine
        self._pending: set[int] = set()
        self._task: asyncio.Task | None = None
        self.deferred_slots = 0  # slots applied by the drain task
        self.drains = 0  # drain task activations
        env = os.environ.get("RABIA_APPLY_INLINE")
        self.inline_budget = (
            int(env) if env is not None else self.INLINE_BUDGET
        )

    @property
    def backlog(self) -> int:
        return len(self._pending)

    def apply_ready(self, dirty: set) -> int:
        """Apply ready slots of the dirty shards: inline up to the
        budget, the rest deferred to the drain. Returns slots applied
        INLINE (the tick's progress signal)."""
        e = self.engine
        applied = 0
        for s in dirty:
            budget = self.inline_budget - applied
            if budget <= 0:
                self._pending.add(s)
                continue
            n, more = e._apply_shard_ready(s, budget)
            applied += n
            if more:
                self._pending.add(s)
        if self._pending:
            self._ensure_drain()
        if applied:
            e.rt.last_apply_time = time.time()
        return applied

    def _ensure_drain(self) -> None:
        if self._task is None or self._task.done():
            self.drains += 1
            self._task = asyncio.ensure_future(self._drain())
            # strong ref + GC on completion (the engine loop holds tasks
            # weakly)
            e = self.engine
            e._bg_tasks.add(self._task)
            self._task.add_done_callback(e._bg_tasks.discard)

    async def _drain(self) -> None:
        """Apply the deferred backlog in bounded chunks, yielding to the
        event loop between chunks so consensus ticks interleave.

        A chunk is CHUNK slots ACROSS shards, not per shard: post-crash
        backlogs are typically wide-and-shallow (a thousand shards, one
        ready slot each), and a per-shard chunk would burn one scheduling
        generation per slot there."""
        e = self.engine
        while self._pending and e._running:
            done = 0
            while self._pending and done < self.CHUNK:
                s = next(iter(self._pending))
                n, more = e._apply_shard_ready(s, self.CHUNK - done)
                done += n
                if not more:
                    self._pending.discard(s)
                    continue
                if n == 0:
                    break  # budget exhausted mid-shard
            if done:
                self.deferred_slots += done
                e.rt.last_apply_time = time.time()
                e._frontier_dirty = True
                if e.persistence is not None:
                    e._dirty = True
                # wake the run loop: frontier listeners fire on-tick
                e._wake.set()
            # the pipelining: one scheduling generation per chunk lets
            # the run loop drain inbound + step the kernel in between
            await asyncio.sleep(0)

    def flush_sync(self) -> int:
        """Apply the ENTIRE backlog synchronously (snapshot serving and
        shutdown need the applied frontier caught up to the decided
        ledger before state is externalized)."""
        e = self.engine
        applied = 0
        while self._pending:
            s = next(iter(self._pending))
            n, more = e._apply_shard_ready(s, 1 << 30)
            applied += n
            if not more:
                self._pending.discard(s)
        if applied:
            e.rt.last_apply_time = time.time()
            e._frontier_dirty = True
            if e.persistence is not None:
                e._dirty = True
        return applied
