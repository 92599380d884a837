"""The port's command batcher against the reference's, on the CPU.

The reference's batcher cases (tests/test_core_types.py::TestBatcher) run
over both packages, with the asynchronous batcher and the batch
processor. Then one seeded ``add`` / ``poll`` / ``flush`` sequence with
injected times goes through both packages' ``CommandBatcher``: every
flushed batch's size, shard and command bytes, and ``target_size`` after
every step, must be equal; the stats (the average batch size included)
are compared with ``==`` after the same sequence. No test sleeps on the
batcher's deadline: times are injected.
"""

from __future__ import annotations

import asyncio
import importlib
import types

import numpy as np
import pytest

PACKAGES = ("rabia_tpu", "rabia_tpu_torch")


def _pkg(name: str) -> types.SimpleNamespace:
    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    return types.SimpleNamespace(
        name=name, b=m("core.batching"), config=m("core.config"), types=m("core.types")
    )


@pytest.fixture(params=PACKAGES)
def P(request):
    return _pkg(request.param)


def _cmd(P, data):
    return P.types.Command.new(data)


class TestBatcher:
    def test_size_flush(self, P):
        b = P.b.CommandBatcher(P.config.BatchConfig(max_batch_size=3, adaptive=False))
        assert b.add(_cmd(P, "a")) is None
        assert b.add(_cmd(P, "b")) is None
        batch = b.add(_cmd(P, "c"))
        assert batch is not None and len(batch) == 3
        assert b.pending_count() == 0

    def test_timeout_flush(self, P):
        b = P.b.CommandBatcher(
            P.config.BatchConfig(max_batch_size=100, max_batch_delay=0.01, adaptive=False))
        b.add(_cmd(P, "a"), now=0.0)
        assert b.poll(now=0.005) is None
        batch = b.poll(now=0.02)
        assert batch is not None and len(batch) == 1

    def test_adaptive_grows_under_load(self, P):
        b = P.b.CommandBatcher(P.config.BatchConfig(max_batch_size=10, adaptive=True))
        for _ in range(10):  # 10 size-triggered flushes
            for i in range(10):
                b.add(_cmd(P, f"c{i}"), now=0.0)
        assert b.target_size > 10

    def test_adaptive_shrinks_when_idle(self, P):
        b = P.b.CommandBatcher(
            P.config.BatchConfig(max_batch_size=100, max_batch_delay=0.01, adaptive=True))
        for k in range(10):  # 10 timeout-triggered flushes
            b.add(_cmd(P, "x"), now=float(k))
            assert b.poll(now=float(k) + 0.5) is not None
        assert b.target_size < 100

    def test_sharded_batcher_routes(self, P):
        sb = P.b.ShardedBatcher(4, P.config.BatchConfig(max_batch_size=1, adaptive=False))
        batch = sb.add(2, _cmd(P, "x"))
        assert batch is not None and int(batch.shard) == 2

    def test_stats(self, P):
        b = P.b.CommandBatcher(P.config.BatchConfig(max_batch_size=2, adaptive=False))
        b.add(_cmd(P, "a"))
        b.add(_cmd(P, "b"))
        assert b.stats.batches_created == 1
        assert b.stats.commands_batched == 2
        assert b.stats.avg_batch_size == 2.0

    def test_backpressure_flushes_full_buffer(self, P):
        b = P.b.CommandBatcher(P.config.BatchConfig(
            max_batch_size=50, buffer_capacity=4, adaptive=False))
        for i in range(4):
            assert b.add(_cmd(P, f"c{i}"), now=0.0) is None or i == 3
        batch = b.add(_cmd(P, "over"), now=1.0)
        assert batch is not None and [c.data for c in batch.commands] == [
            b"c0", b"c1", b"c2", b"c3"]
        assert b.pending_count() == 1  # the overflowing command starts the next batch
        assert b.poll(now=1.0 + b.config.max_batch_delay) is not None

    def test_manual_flush_does_not_adapt(self, P):
        b = P.b.CommandBatcher(P.config.BatchConfig(max_batch_size=10, adaptive=True))
        for _ in range(30):
            b.add(_cmd(P, "m"), now=0.0)
            assert b.flush(now=0.0) is not None
        assert b.flush(now=0.0) is None
        assert b.target_size == 10 and b.stats.manual_flushes == 30


class TestAsyncBatcher:
    @pytest.mark.asyncio
    async def test_ticker_flushes_on_deadline_and_close_cancels_it(self, P):
        ab = P.b.AsyncCommandBatcher(
            P.config.BatchConfig(max_batch_size=100, max_batch_delay=0.005, adaptive=False))
        await ab.start()
        await ab.submit(_cmd(P, "a"))
        batch = await asyncio.wait_for(ab.batches.get(), 5.0)
        assert [c.data for c in batch.commands] == [b"a"]
        await ab.submit(_cmd(P, "b"))
        task = ab._task
        await ab.close()
        assert task.cancelled() or task.done()
        assert ab._task is None
        # close flushes what was pending, and refuses more
        drained = []
        while not ab.batches.empty():
            drained.extend(c.data for c in ab.batches.get_nowait().commands)
        assert drained in ([b"b"], [])  # the ticker may have flushed it already
        assert ab.stats.commands_batched == 2
        with pytest.raises(RuntimeError):
            await ab.submit(_cmd(P, "c"))

    @pytest.mark.asyncio
    async def test_size_flush_without_ticker(self, P):
        ab = P.b.AsyncCommandBatcher(P.config.BatchConfig(max_batch_size=2, adaptive=False))
        await ab.submit(_cmd(P, "a"))
        await ab.submit(_cmd(P, "b"))
        assert len(ab.batches.get_nowait()) == 2
        await ab.close()


class TestBatchProcessor:
    @pytest.mark.asyncio
    @pytest.mark.parametrize("parallel", [False, True])
    async def test_transform_then_apply_in_order(self, P, parallel):
        async def apply(c):
            await asyncio.sleep(0)
            return c.data.upper()

        def transform(batch):
            return P.types.CommandBatch.new(list(reversed(batch.commands)))

        proc = P.b.BatchProcessor(apply, transform=transform, parallel=parallel)
        batch = P.types.CommandBatch.new([_cmd(P, "a"), _cmd(P, "b"), _cmd(P, "c")])
        assert await proc.process(batch) == [b"C", b"B", b"A"]


def _drive(P, seed: int, n: int = 4000) -> tuple[list, object]:
    """One seeded add/poll/flush sequence with injected times through a
    CommandBatcher and a ShardedBatcher's shard batchers; returns a trace
    of every step's outcome and target size."""
    rng = np.random.default_rng(seed)
    cfg = P.config.BatchConfig(max_batch_size=12, max_batch_delay=0.01, buffer_capacity=40,
                               min_adaptive_size=4, max_adaptive_size=64, adaptive=True)
    single = P.b.CommandBatcher(cfg, P.types.ShardId(3))
    sharded = P.b.ShardedBatcher(4, cfg)
    # a busy first fifth (bursts: size-triggered flushes grow the target),
    # then sparse traffic (deadline flushes shrink it)
    busy = n // 5
    actions = np.concatenate([
        rng.choice(["add", "burst", "burst", "poll", "flush"], size=busy),
        rng.choice(["add", "add", "poll", "poll", "flush"], size=n - busy),
    ])
    gaps = np.concatenate([rng.exponential(0.0005, size=busy),
                           rng.exponential(0.008, size=n - busy)])
    shards = rng.integers(0, 4, size=n)
    now = 0.0
    trace = []

    def rec(tag, batch, b):
        trace.append((tag, id(b) == id(single), None if batch is None else (
            int(batch.shard), [c.data for c in batch.commands]), b.target_size,
            b.pending_count()))

    for i in range(n):
        now += float(gaps[i])
        a = str(actions[i])
        targets = (single, sharded.batchers[int(shards[i])])
        for b in targets:
            if a == "add":
                rec("add", b.add(_cmd(P, f"c{i}"), now=now), b)
            elif a == "burst":
                for j in range(17):
                    rec("burst", b.add(_cmd(P, f"c{i}.{j}"), now=now), b)
            elif a == "poll":
                rec("poll", b.poll(now=now), b)
            else:
                rec("flush", b.flush(now=now) if i % 7 == 0 else b.poll(now=now), b)
    stats = [vars(b.stats) | {"avg": b.stats.avg_batch_size}
             for b in (single, *sharded.batchers)]
    return trace, stats


class TestCrossPackage:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_sequence(self, seed):
        ref, port = (_drive(_pkg(n), seed) for n in PACKAGES)
        assert ref[0] == port[0]
        assert ref[1] == port[1]
        flushes = [s["size_flushes"] + s["timeout_flushes"] for s in port[1]]
        assert min(flushes) >= 10  # every batcher adapted at least once
        targets = [t[3] for t in port[0] if not t[1]]  # the shard batchers' targets
        assert max(targets) > targets[-1] > min(targets)  # grew, then shrank
