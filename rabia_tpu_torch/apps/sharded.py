"""Shard-routing state machine + the client-facing sharded KV service.

The port's copy of the reference's ``rabia_tpu/apps/sharded.py``. The
native apply plane's hooks (``is_native`` stores, ``_native_plane``) stay
where the reference has them; the port builds Python stores only
(:func:`make_sharded_kv`).

No direct reference analog: the reference runs ONE consensus instance per
cluster (its kvstore_smr bridges a single store — smr_impl.rs:22-100). Here
the store is partitioned by key range and every shard is an independent
consensus instance — the batched ``S`` axis of the device kernel
(SURVEY.md §5.7, §7.1). This module provides:

- :class:`ShardedStateMachine` — engine-facing bytes SM that routes each
  committed batch to its shard's sub-machine (`CommandBatch.shard` carries
  the index through consensus);
- :class:`ShardedKVService` — the client API: key → shard → engine submit,
  with typed encode/decode via the shard's `KVStoreSMR`.
"""

from __future__ import annotations

import asyncio
import json
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from rabia_tpu_torch.core.batching import ShardedBatcher
from rabia_tpu_torch.core.blocks import build_block
from rabia_tpu_torch.core.config import BatchConfig
from rabia_tpu_torch.core.smr import SMRBridge, TypedStateMachine
from rabia_tpu_torch.core.state_machine import Snapshot, StateMachine, VectorStateMachine
from rabia_tpu_torch.core.types import Command, CommandBatch, ShardId
from rabia_tpu_torch.apps.kvstore import (
    KVOperation,
    KVResult,
    KVStoreConfig,
    KVStoreSMR,
    encode_op_bin,
    encode_set_bin,
    shard_for_key,
)


_BIN_OPCODES = frozenset(
    bytes((c,)) for c in (1, 2, 3, 4, 5, 6)
)  # SET GET DEL EXISTS CLEAR CAS (apps/kvstore.py binary op codec)


class ShardedStateMachine(StateMachine, VectorStateMachine):
    """Routes committed batches to per-shard typed machines by batch.shard.

    The engine applies whole batches (engine.rs:684-706 analog); the shard
    index rides on the batch, so routing is O(1) and the per-shard machines
    stay single-writer (no cross-shard synchronization — matching how the
    kernel treats shards as independent instances).

    Also implements the block lane's :class:`VectorStateMachine`: a whole
    decided wave of per-shard batches applies in one call, each command as
    a byte-slice through the shard machine's ``apply_raw`` fast path (no
    per-command object materialization).
    """

    def __init__(self, machines: Sequence[TypedStateMachine]) -> None:
        self.bridges = [SMRBridge(m) for m in machines]
        self.machines = list(machines)
        self._version = 0
        # native apply plane (apps/native_store): when every shard store
        # is a NativeKVStore view over ONE shared plane, a decided wave
        # applies in a single statekernel call (apply_block below)
        self._native_plane = None
        self._native_stores = [
            getattr(m, "store", None) for m in self.machines
        ]
        stores = self._native_stores
        if stores and all(
            getattr(s, "is_native", False) for s in stores
        ):
            planes = {id(s.plane) for s in stores}
            # exact width match: the native wave routes by
            # shard % n_stores while the Python paths route by
            # shard % len(machines) — any mismatch would silently
            # diverge the two conformance-pinned paths
            if len(planes) == 1 and stores[0].plane.n_stores == len(stores):
                self._native_plane = stores[0].plane

    @property
    def num_shards(self) -> int:
        return len(self.bridges)

    def _bridge_for(self, shard: int) -> SMRBridge:
        return self.bridges[shard % len(self.bridges)]

    def apply_command(self, command: Command) -> bytes:
        # unrouted single commands go to shard 0 (engine tests / smoke)
        return self.bridges[0].apply_command(command)

    def apply_batch(self, batch: CommandBatch) -> list[bytes]:
        shard = int(batch.shard)
        cmds = batch.commands
        m = self.machines[shard % len(self.machines)]
        raw_many = getattr(m, "apply_raw_many", None)
        if (
            raw_many is not None
            and cmds
            and all(c.data[:1] in _BIN_OPCODES for c in cmds)
        ):
            # binary commands skip per-op Command/typed materialization
            # (scalar-lane analog of the block lane's apply_raw path;
            # native stores take the statekernel from here)
            return list(raw_many([c.data for c in cmds]))
        bridge = self._bridge_for(shard)
        return [bridge.apply_command(c) for c in cmds]

    def apply_block(self, block, idxs, want_responses: bool = True):
        """Bulk apply for the engine's block lane (VectorStateMachine).

        One wave-level clock read; array indices are materialized to Python
        ints once so the inner loop is slice + dict work only.
        """
        import time as _time

        now = _time.time()
        n = len(self.machines)
        plane = self._native_plane
        if plane is not None:
            # subscribed stores demote (old-value capture for the
            # notification stream happens per op in the bridge)
            covered = np.asarray(idxs).tolist()
            stores = self._native_stores
            shards_l = block.shards
            if not any(
                stores[int(shards_l[i]) % n]._subscribed() for i in covered
            ):
                res = plane.apply_block_wave(
                    block, covered, now, want_responses
                )
                if res is not NotImplemented:
                    self._version += len(covered)
                    return res
        machines = self.machines
        shards = block.shards.tolist()
        starts = block.shard_starts.tolist()
        offs = block.cmd_offsets.tolist()
        data = block.data
        responses: list[list[bytes]] = []
        applied = 0
        for i in np.asarray(idxs).tolist():
            m = machines[shards[i] % n]
            lo, hi = starts[i], starts[i + 1]
            applied += 1
            if hi - lo == 1:
                b = data[offs[lo] : offs[lo + 1]]
                store = getattr(m, "store", None)
                if store is not None and b[:1] == b"\x01":
                    r = store.apply_set_bin_fast(b, now)
                    if r is not None:
                        if want_responses:
                            responses.append([r])
                        continue
            ops = [data[offs[j] : offs[j + 1]] for j in range(lo, hi)]
            raw_many = getattr(m, "apply_raw_many", None)
            if raw_many is not None:
                rs = raw_many(ops, now)
            else:
                bridge = self._bridge_for(shards[i])
                rs = [bridge.apply_command(Command.new(b)) for b in ops]
            if want_responses:
                responses.append(rs)
        self._version += applied
        return responses if want_responses else None

    def create_snapshot(self) -> Snapshot:
        self._version += 1
        doc = {
            "shards": [
                bridge.create_snapshot().to_bytes().hex() for bridge in self.bridges
            ]
        }
        return Snapshot.create(
            self._version, json.dumps(doc, separators=(",", ":")).encode()
        )

    def restore_snapshot(self, snapshot: Snapshot) -> None:
        snapshot.verify()
        doc = json.loads(snapshot.data)
        for bridge, blob_hex in zip(self.bridges, doc["shards"]):
            bridge.restore_snapshot(Snapshot.from_bytes(bytes.fromhex(blob_hex)))
        self._version = snapshot.version

    def restore_shards(self, snapshot: Snapshot, shard_ids) -> None:
        """Restore ONLY the given shards from the snapshot (sync adoption
        under mixed per-shard progress: the engine adopts a responder's
        state solely for shards where the responder is ahead — wholesale
        restore would regress shards where WE are ahead)."""
        snapshot.verify()
        doc = json.loads(snapshot.data)
        blobs = doc["shards"]
        for s in shard_ids:
            s = int(s)
            # tolerate a responder configured with fewer shards (reconfig
            # skew): indices beyond its snapshot are simply not adopted
            if 0 <= s < len(self.bridges) and s < len(blobs):
                self.bridges[s].restore_snapshot(
                    Snapshot.from_bytes(bytes.fromhex(blobs[s]))
                )
        self._version = max(self._version, snapshot.version)

    def get_state_summary(self) -> str:
        return f"{len(self.bridges)} shards"


def make_sharded_kv(
    num_shards: int,
    config: Optional[KVStoreConfig] = None,
    native: Optional[bool] = None,
) -> tuple[ShardedStateMachine, list[KVStoreSMR]]:
    """Build one `KVStoreSMR` per shard behind a routing SM.

    ``native`` selects the apply plane. None (default) and False build the
    Python :class:`KVStore` per shard (the semantics owner). True asks for
    the reference's statekernel-backed native store, which the port has
    not ported (ROADMAP Queue 1 item 7.3): it raises rather than building
    Python stores in its place."""
    if native:
        raise NotImplementedError(
            "the native apply plane (NativeKVStore) is not ported yet "
            "(ROADMAP Queue 1 item 7.3); pass native=False or None"
        )
    machines = [KVStoreSMR(config) for _ in range(num_shards)]
    return ShardedStateMachine(machines), machines


class ShardedKVService:
    """Client facade: key-routed KV operations through consensus.

    `submit` is the engine's `submit_batch`; injected so the service works
    with any engine (or a local loopback in tests). Three submission modes:

    - direct (default): one consensus slot per operation;
    - **adaptive batching** (pass ``batching=BatchConfig(...)``): ops
      accumulate per shard through a :class:`ShardedBatcher` (size+time
      flush, ±10% adaptive sizing — rabia-core/src/batching.rs:150-165) so
      one consensus slot carries ~target_size commands;
    - **block lane** (pass ``submit_block=engine.submit_block``):
      :meth:`set_many` ships a whole columnar
      :class:`~rabia_tpu_torch.core.blocks.PayloadBlock` across shards in one
      submission.
    """

    def __init__(
        self,
        num_shards: int,
        submit: Callable,  # async (CommandBatch, shard) -> Future[list[bytes]]
        machines: Sequence[KVStoreSMR],
        submit_block: Optional[Callable] = None,  # async (PayloadBlock) -> Future
        batching: Optional[BatchConfig] = None,
    ) -> None:
        self.num_shards = num_shards
        self._submit = submit
        self._machines = list(machines)
        self._submit_block = submit_block
        self._batcher = ShardedBatcher(num_shards, batching) if batching else None
        self._op_futures: list[deque] = [deque() for _ in range(num_shards)]
        self._flusher: Optional[asyncio.Task] = None
        self._bg: set = set()

    def shard_of(self, key: str) -> int:
        return shard_for_key(key, self.num_shards)

    @property
    def batch_stats(self):
        """Per-shard BatchStats (adaptive mode only)."""
        return (
            [b.stats for b in self._batcher.batchers] if self._batcher else []
        )

    async def close(self) -> None:
        if self._flusher is not None:
            self._flusher.cancel()
            try:
                await self._flusher
            except asyncio.CancelledError:
                pass
            self._flusher = None
        if self._batcher is not None:
            # drain partial batches so no awaiting caller hangs on an op
            # that never flushed
            for batch in self._batcher.flush_all():
                self._dispatch_batch(int(batch.shard), batch)
        if self._bg:
            await asyncio.gather(*list(self._bg), return_exceptions=True)

    # -- adaptive batching lane ---------------------------------------------

    def _spawn(self, coro) -> None:
        t = asyncio.ensure_future(coro)
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)

    def _dispatch_batch(self, shard: int, batch: CommandBatch) -> None:
        futs = [self._op_futures[shard].popleft() for _ in batch.commands]

        async def run():
            try:
                f = await self._submit(batch, shard)
                responses = await f
                for fu, r in zip(futs, responses):
                    if not fu.done():
                        fu.set_result(r)
            except Exception as e:
                for fu in futs:
                    if not fu.done():
                        fu.set_exception(e)

        self._spawn(run())

    async def _flush_loop(self) -> None:
        delay = max(self._batcher.config.max_batch_delay / 2, 0.001)
        while True:
            await asyncio.sleep(delay)
            for batch in self._batcher.poll_all():
                self._dispatch_batch(int(batch.shard), batch)

    async def _roundtrip_batched(self, op: KVOperation, shard: int) -> KVResult:
        if self._flusher is None:
            self._flusher = asyncio.ensure_future(self._flush_loop())
        codec = self._machines[shard]
        cmd = Command.new(codec.encode_command(op))
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._op_futures[shard].append(fut)
        batch = self._batcher.add(shard, cmd)
        if batch is not None:
            self._dispatch_batch(shard, batch)
        return codec.decode_response(await fut)

    # -- block lane -----------------------------------------------------------

    async def _block_roundtrip(
        self, keyed_ops: Sequence[tuple[str, bytes]]
    ) -> list[KVResult]:
        """Route (key, encoded-op) pairs shard-wise through one columnar
        block submission; results in input order."""
        if not keyed_ops:
            return []
        by_shard: dict[int, list[bytes]] = {}
        positions: dict[int, list[int]] = {}
        for pos, (k, op) in enumerate(keyed_ops):
            s = self.shard_of(k)
            by_shard.setdefault(s, []).append(op)
            positions.setdefault(s, []).append(pos)
        shards = sorted(by_shard)
        block = build_block(shards, [by_shard[s] for s in shards])
        fut = await self._submit_block(block)
        per_shard = await fut
        out: list[KVResult] = [KVResult.err("missing response")] * len(keyed_ops)
        for i, s in enumerate(shards):
            resp = per_shard[i]
            if isinstance(resp, Exception):
                for pos in positions[s]:
                    out[pos] = KVResult.err(str(resp))
            else:
                codec = self._machines[s]
                for pos, raw in zip(positions[s], resp):
                    # decode_response sniffs binary vs JSON — demoted
                    # shards come back through the scalar (JSON) path
                    out[pos] = codec.decode_response(raw)
        return out

    async def set_many(self, pairs: Sequence[tuple[str, str]]) -> list[KVResult]:
        """Write many keys in one columnar block submission (one consensus
        slot per covered shard). Falls back to per-op submission when the
        engine exposes no block lane."""
        if self._submit_block is None:
            return list(
                await asyncio.gather(*[self.set(k, v) for k, v in pairs])
            )
        return await self._block_roundtrip(
            [(k, encode_set_bin(k, v)) for k, v in pairs]
        )

    async def get_many(self, keys: Sequence[str]) -> list[KVResult]:
        """Linearizable bulk reads through consensus (one slot per covered
        shard), mirroring :meth:`set_many`. Falls back to per-op submission
        without a block lane."""
        if self._submit_block is None:
            return list(
                await asyncio.gather(*[self.get(k) for k in keys])
            )
        return await self._block_roundtrip(
            [(k, encode_op_bin(KVOperation.get(k))) for k in keys]
        )

    async def _roundtrip(self, op: KVOperation, shard: int) -> KVResult:
        if self._batcher is not None:
            return await self._roundtrip_batched(op, shard)
        codec = self._machines[shard]
        batch = CommandBatch.new(
            [Command.new(codec.encode_command(op))], shard=ShardId(shard)
        )
        fut = await self._submit(batch, shard)
        responses = await fut
        return codec.decode_response(responses[0])

    async def set(self, key: str, value: str) -> KVResult:
        return await self._roundtrip(KVOperation.set(key, value), self.shard_of(key))

    async def get(self, key: str) -> KVResult:
        return await self._roundtrip(KVOperation.get(key), self.shard_of(key))

    async def delete(self, key: str) -> KVResult:
        return await self._roundtrip(KVOperation.delete(key), self.shard_of(key))

    async def exists(self, key: str) -> bool:
        res = await self._roundtrip(KVOperation.exists(key), self.shard_of(key))
        return res.value == "true"

    def local_store(self, shard: int):
        """Direct access to a shard's local replica store (reads/tests)."""
        return self._machines[shard].store
