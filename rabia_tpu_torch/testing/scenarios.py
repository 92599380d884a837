"""Performance harness: cluster throughput/latency under simulated load.

Reference parity: rabia-testing/src/scenarios.rs — `PerformanceTest` spec
(:16-41), `PerformanceBenchmark` run loop with round-robin submission and
per-batch latency capture (:43-292; percentiles :230-243), the canned test
set (:294-375) and the summary printer (:410-451). Unlike the reference —
whose engine-level perf tests are `#[ignore]`d ("needs consensus engine
improvements", :459,490) — these run and pass.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from rabia_tpu_torch.core.types import CommandBatch
from rabia_tpu_torch.net import NetworkConditions
from rabia_tpu_torch.testing.cluster import TestCluster, default_test_config


@dataclass(frozen=True)
class PerformanceTest:
    """One load spec (scenarios.rs:16-41)."""

    name: str
    node_count: int = 3
    total_operations: int = 100
    operations_per_second: float = 100.0
    batch_size: int = 10
    packet_loss: float = 0.0
    latency_ms: float = 0.0
    num_shards: int = 1
    timeout: float = 60.0


@dataclass
class PerformanceReport:
    """Measured outcome (scenarios.rs result struct analog)."""

    name: str
    submitted_batches: int = 0
    committed_batches: int = 0
    failed_batches: int = 0
    elapsed: float = 0.0
    latencies: list[float] = field(default_factory=list)
    # MEASURED process peak RSS at collection time — the reference reports
    # a hard-coded per-node constant here (scenarios.rs:276-283)
    memory_usage_mb: float = 0.0

    @property
    def throughput_ops(self) -> float:
        return self.committed_batches / self.elapsed if self.elapsed else 0.0

    def _pct(self, p: float) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
        return xs[i]

    @property
    def p50(self) -> float:
        return self._pct(50)

    @property
    def p95(self) -> float:
        return self._pct(95)

    @property
    def p99(self) -> float:
        return self._pct(99)

    def summary(self) -> str:
        return (
            f"{self.name}: {self.committed_batches}/{self.submitted_batches} "
            f"batches in {self.elapsed:.2f}s "
            f"({self.throughput_ops:.1f} batches/s), "
            f"latency p50={self.p50*1000:.1f}ms p95={self.p95*1000:.1f}ms "
            f"p99={self.p99*1000:.1f}ms, rss={self.memory_usage_mb:.0f}MB"
        )


class PerformanceBenchmark(TestCluster):
    """Runs a `PerformanceTest` against a real in-process cluster
    (scenarios.rs:120-263). Cluster lifecycle comes from
    :class:`~rabia_tpu_torch.testing.cluster.TestCluster`."""

    def __init__(self, test: PerformanceTest, seed: int = 0) -> None:
        self.test = test
        super().__init__(
            test.node_count,
            config=default_test_config(test.num_shards),
            conditions=NetworkConditions(
                latency_min=test.latency_ms / 2000.0,
                latency_max=test.latency_ms / 1000.0,
                packet_loss_rate=test.packet_loss,
            ),
            seed=seed,
        )

    async def run(self) -> PerformanceReport:
        t = self.test
        rep = PerformanceReport(name=t.name)
        n_batches = max(1, t.total_operations // t.batch_size)
        interval = t.batch_size / t.operations_per_second
        t0 = time.time()

        async def one(i: int) -> None:
            eng = self.engines[i % len(self.engines)]
            shard = i % max(1, t.num_shards)
            cmds = [
                f"SET key{i}_{j} value{j}" for j in range(t.batch_size)
            ]
            start = time.time()
            try:
                fut = await eng.submit_batch(CommandBatch.new(cmds), shard=shard)
                await asyncio.wait_for(fut, t.timeout)
                rep.committed_batches += 1
                rep.latencies.append(time.time() - start)
            except Exception:
                rep.failed_batches += 1

        pending: list[asyncio.Task] = []
        for i in range(n_batches):
            rep.submitted_batches += 1
            pending.append(asyncio.ensure_future(one(i)))
            await asyncio.sleep(interval)
        await asyncio.gather(*pending, return_exceptions=True)
        rep.elapsed = time.time() - t0
        try:
            import resource
            import sys as _sys

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss is KILOBYTES on Linux but BYTES on macOS
            rep.memory_usage_mb = rss / (
                1024.0 * 1024.0 if _sys.platform == "darwin" else 1024.0
            )
        except Exception:
            pass  # non-POSIX: leave 0.0
        return rep


async def run_performance_test(test: PerformanceTest, seed: int = 0) -> PerformanceReport:
    bench = PerformanceBenchmark(test, seed=seed)
    await bench.start()
    try:
        return await bench.run()
    finally:
        await bench.stop()


def canned_performance_tests() -> list[PerformanceTest]:
    """The 6 standard load specs (scenarios.rs:294-375), scaled to run in CI."""
    return [
        PerformanceTest("baseline_throughput", 3, 100, 100.0, 10),
        PerformanceTest("high_load", 5, 500, 500.0, 50),
        PerformanceTest("large_cluster", 7, 100, 100.0, 10, packet_loss=0.01),
        PerformanceTest("lossy_network", 3, 50, 50.0, 10, packet_loss=0.05),
        PerformanceTest("wan_latency", 3, 50, 50.0, 10, latency_ms=20.0),
        PerformanceTest("sharded_load", 3, 200, 400.0, 10, num_shards=8),
    ]


def print_summary(reports: list[PerformanceReport]) -> None:
    print("=" * 72)
    for r in reports:
        print(r.summary())
    print("=" * 72)
