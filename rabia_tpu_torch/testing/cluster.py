"""Shared in-process cluster bootstrap for harnesses and tests.

One place owning the build/start/stop cycle of N real engines over a
simulated (or hub) transport — the pattern fault_injection.rs:83-142 and
scenarios.rs:120-150 each hand-roll in the reference.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional

from rabia_tpu_torch.core.config import RabiaConfig
from rabia_tpu_torch.core.errors import QuorumNotAvailableError
from rabia_tpu_torch.core.network import ClusterConfig
from rabia_tpu_torch.core.state_machine import InMemoryStateMachine, StateMachine
from rabia_tpu_torch.core.types import NodeId
from rabia_tpu_torch.engine import RabiaEngine
from rabia_tpu_torch.net import NetworkConditions, NetworkSimulator


def default_test_config(num_shards: int = 1) -> RabiaConfig:
    """Fast-timeout config for in-process clusters."""
    return RabiaConfig(
        phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
    ).with_kernel(num_shards=num_shards, shard_pad_multiple=max(1, num_shards))


class TestCluster:
    """N engines + state machines over one simulator, lifecycle-managed."""

    def __init__(
        self,
        node_count: int,
        config: Optional[RabiaConfig] = None,
        conditions: Optional[NetworkConditions] = None,
        seed: int = 0,
        sm_factory: Callable[[], StateMachine] = InMemoryStateMachine,
    ) -> None:
        self.n = node_count
        self.config = config or default_test_config()
        self.sim = NetworkSimulator(conditions, seed=seed)
        self.nodes = [NodeId.from_int(i + 1) for i in range(node_count)]
        self.sms: list[StateMachine] = []
        self.engines: list[RabiaEngine] = []
        self.tasks: list[asyncio.Task] = []
        self._sm_factory = sm_factory

    async def start(self, quorum_wait: float = 5.0) -> None:
        for node in self.nodes:
            sm = self._sm_factory()
            eng = RabiaEngine(
                ClusterConfig.new(node, self.nodes),
                sm,
                self.sim.register(node),
                config=self.config,
            )
            self.sms.append(sm)
            self.engines.append(eng)
            self.tasks.append(asyncio.ensure_future(eng.run()))
        deadline = time.time() + quorum_wait
        while time.time() < deadline:
            stats = [await e.get_statistics() for e in self.engines]
            if all(s.has_quorum for s in stats):
                return
            await asyncio.sleep(0.01)
        # a non-quorate cluster produces misleading downstream failures
        # ("0 committed") — fail loudly at the source, but tear down the
        # engines we already spawned first (callers invoke start() outside
        # their try/finally, so nothing else will)
        dead = [t for t in self.tasks if t.done()]
        detail = f"; {len(dead)} engine task(s) died" if dead else ""
        await self.stop()
        raise QuorumNotAvailableError(
            f"cluster failed to reach quorum within {quorum_wait}s{detail}"
        )

    async def stop(self) -> None:
        for e in self.engines:
            await e.shutdown()
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        await self.sim.close()
