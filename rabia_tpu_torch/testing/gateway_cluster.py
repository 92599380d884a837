"""Gateway cluster harness: N replicas over real TCP, each fronted by a
:class:`~rabia_tpu_torch.gateway.server.GatewayServer`, with replica
restart support for chaos runs.

Shared by tests/test_torch_gateway.py, test_torch_wal.py,
test_torch_coalesce.py and chip_smoke.py's phase 13 — one place owning
the build/start/restart/stop cycle of the full client-facing stack (the gateway analog of
:class:`~rabia_tpu_torch.testing.cluster.TestCluster`).

The port's copy of the reference's ``rabia_tpu/testing/gateway_cluster.py``, its imports
retargeted to ``rabia_tpu_torch`` and its native library the port's own.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from rabia_tpu_torch.apps.sharded import make_sharded_kv
from rabia_tpu_torch.core.config import RabiaConfig, TcpNetworkConfig
from rabia_tpu_torch.core.errors import QuorumNotAvailableError
from rabia_tpu_torch.core.network import ClusterConfig
from rabia_tpu_torch.core.types import NodeId
from rabia_tpu_torch.engine import RabiaEngine
from rabia_tpu_torch.gateway import GatewayConfig, GatewayEndpoint, GatewayServer
from rabia_tpu_torch.net.tcp import TcpNetwork
from rabia_tpu_torch.persistence.backends import InMemoryPersistence


def default_gateway_test_config(num_shards: int = 4) -> RabiaConfig:
    return RabiaConfig(
        phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
    ).with_kernel(
        num_shards=num_shards, shard_pad_multiple=max(1, num_shards)
    )


class GatewayCluster:
    """N real-TCP replicas + per-replica gateways, lifecycle-managed."""

    def __init__(
        self,
        n_replicas: int = 3,
        n_shards: int = 4,
        config: Optional[RabiaConfig] = None,
        gateway_config: Optional[GatewayConfig] = None,
        persistence: bool | str = True,
        wal_dir: Optional[str] = None,
        wal_kwargs: Optional[dict] = None,
    ) -> None:
        self.n = n_replicas
        self.n_shards = n_shards
        self.config = config or default_gateway_test_config(n_shards)
        self.gateway_config = gateway_config or GatewayConfig()
        if self.gateway_config.runtime_workers is not None:
            # GatewayConfig.runtime_workers flows into the engine config
            # (thread-per-shard-group native runtime worker count)
            from dataclasses import replace

            self.config = replace(
                self.config,
                runtime_workers=self.gateway_config.runtime_workers,
            )
        self.ids = [NodeId.from_int(i + 1) for i in range(n_replicas)]
        self.nets: list[TcpNetwork] = []
        self.engines: list[RabiaEngine] = []
        self.machines: list[list] = []  # per replica: per-shard KVStoreSMR
        self.gateways: list[GatewayServer] = []
        self.tasks: list[asyncio.Task] = []
        # durable per-replica state surviving restart_replica: a replica
        # restarting with NO persistence is outside the engine's supported
        # crash-recovery model (the vote-barrier taint that prevents a
        # restarted proposer from rebinding fresh batches into anciently
        # decided slots lives in the persistence layer).
        # persistence=False trades restart_replica away for the native
        # engine runtime. persistence="wal" builds the durability plane
        # (persistence/native_wal.py, one directory per replica under
        # wal_dir) — the native runtime ENGAGES on those replicas AND
        # restart_replica recovers from snapshot chain + WAL replay.
        self.wal_kwargs = dict(wal_kwargs or {})
        if persistence == "wal":
            import tempfile

            from rabia_tpu_torch.persistence.native_wal import WalPersistence

            self.wal_dir = wal_dir or tempfile.mkdtemp(prefix="rabia-wal-")
            self.persists = [
                WalPersistence(
                    f"{self.wal_dir}/replica-{i}",
                    n_shards=n_shards,
                    **self.wal_kwargs,
                )
                for i in range(n_replicas)
            ]
        else:
            self.wal_dir = wal_dir
            self.persists = [
                InMemoryPersistence() if persistence else None
                for _ in range(n_replicas)
            ]

    # -- lifecycle ----------------------------------------------------------

    def _build_replica(self, i: int, bind_port: int = 0) -> None:
        net = TcpNetwork(self.ids[i], TcpNetworkConfig(bind_port=bind_port))
        sm, machines = make_sharded_kv(self.n_shards)
        eng = RabiaEngine(
            ClusterConfig.new(self.ids[i], self.ids),
            sm,
            net,
            persistence=self.persists[i],
            config=self.config,
        )
        self.nets[i] = net
        self.engines[i] = eng
        self.machines[i] = machines

    async def start(self, quorum_wait: float = 10.0) -> None:
        self.nets = [None] * self.n  # type: ignore[list-item]
        self.engines = [None] * self.n  # type: ignore[list-item]
        self.machines = [None] * self.n  # type: ignore[list-item]
        for i in range(self.n):
            self._build_replica(i)
        for i in range(self.n):
            for j in range(self.n):
                if i != j:
                    self.nets[i].add_peer(
                        self.ids[j], "127.0.0.1", self.nets[j].port
                    )
        self.tasks = [
            asyncio.ensure_future(e.run()) for e in self.engines
        ]
        deadline = time.time() + quorum_wait
        while time.time() < deadline:
            stats = [await e.get_statistics() for e in self.engines]
            if all(s.has_quorum for s in stats):
                break
            await asyncio.sleep(0.01)
        else:
            await self.stop()
            raise QuorumNotAvailableError(
                f"gateway cluster: no quorum within {quorum_wait}s"
            )
        self.gateways = [
            GatewayServer(self.engines[i], config=self.gateway_config)
            for i in range(self.n)
        ]
        for g in self.gateways:
            await g.start()
        self._mesh_gateways()

    def _mesh_gateways(self) -> None:
        for i in range(self.n):
            for j in range(self.n):
                if (
                    i != j
                    and self.gateways[i] is not None
                    and self.gateways[j] is not None
                ):
                    self.gateways[i].add_peer_gateway(
                        self.gateways[j].node_id,
                        "127.0.0.1",
                        self.gateways[j].port,
                    )

    def endpoint(self, i: int) -> GatewayEndpoint:
        return self.gateways[i].endpoint

    def endpoints(self) -> list[GatewayEndpoint]:
        return [g.endpoint for g in self.gateways]

    def store(self, replica: int, shard: int):
        """Direct host-store access (the linearizability oracle)."""
        return self.machines[replica][shard].store

    # -- chaos / elastic membership -----------------------------------------
    #
    # The replica ROSTER is fixed (Rabia has no in-protocol
    # reconfiguration; neither does the reference) — what is elastic is
    # the LIVE SET: replicas decommission (`stop_replica`), rejoin
    # (`start_replica`, recovering from their persistence layer and
    # catching up via peer Decisions/snapshot sync), or roll
    # (`restart_replica`) while the rest of the cluster keeps serving.
    # The chaos plane's membership profiles drive exactly these
    # transitions under sustained open-loop load.

    def is_down(self, i: int) -> bool:
        return self.engines[i] is None

    @property
    def live_replicas(self) -> list[int]:
        return [i for i in range(self.n) if self.engines[i] is not None]

    async def stop_replica(self, i: int, settle: float = 0.2) -> None:
        """Decommission replica ``i``: gateway, engine and transport go
        down and STAY down until :meth:`start_replica`. Its persistence
        layer (and port reservations, best-effort) survive for the
        rejoin."""
        if self.persists[i] is None:
            raise RuntimeError(
                "stop_replica requires persistence "
                "(GatewayCluster(persistence=True)): rejoining with no "
                "persistence is outside the crash-recovery model"
            )
        if self.engines[i] is None:
            return
        gw = self.gateways[i]
        self._down_state = getattr(self, "_down_state", {})
        self._down_state[i] = {
            "net_port": self.nets[i].port,
            "gw_port": gw.port,
            "gw_node": gw.node_id,
            "gw_cfg": gw.config,
        }
        await gw.close()
        self.gateways[i] = None
        await self.engines[i].shutdown()
        self.tasks[i].cancel()
        try:
            await self.tasks[i]
        except (asyncio.CancelledError, Exception):
            pass
        await self.nets[i].close()
        self.engines[i] = None
        self.nets[i] = None  # type: ignore[call-overload]
        await asyncio.sleep(settle)

    async def start_replica(self, i: int) -> None:
        """Rejoin a decommissioned replica under its original identity
        and ports: the new engine restores from the replica's
        persistence layer (vote barrier + snapshot chain + WAL replay
        where present) and catches up the tail via peer Decisions /
        snapshot sync; peers and clients redial transparently because
        the ports are rebound."""
        if self.engines[i] is not None:
            return
        st = self._down_state.pop(i)
        p = self.persists[i]
        if getattr(p, "supports_wal", False):
            # a fresh WalPersistence re-runs the recovery scan (torn-tail
            # truncation + chain load) exactly like a restarted process
            p.close()
            from rabia_tpu_torch.persistence.native_wal import WalPersistence

            self.persists[i] = WalPersistence(
                f"{self.wal_dir}/replica-{i}",
                n_shards=self.n_shards,
                **self.wal_kwargs,
            )
        self._build_replica(i, bind_port=st["net_port"])
        for j in range(self.n):
            if i != j and self.nets[j] is not None:
                self.nets[i].add_peer(
                    self.ids[j], "127.0.0.1", self.nets[j].port
                )
                self.nets[j].add_peer(
                    self.ids[i], "127.0.0.1", self.nets[i].port
                )
        self.tasks[i] = asyncio.ensure_future(self.engines[i].run())
        cfg = GatewayConfig(
            **{**st["gw_cfg"].__dict__, "bind_port": st["gw_port"]}
        )
        self.gateways[i] = GatewayServer(
            self.engines[i], config=cfg, node_id=st["gw_node"]
        )
        await self.gateways[i].start()
        self._mesh_gateways()

    async def restart_replica(self, i: int, settle: float = 0.2) -> None:
        """Restart replica ``i`` (engine, transport and gateway) — one
        rolling-restart step: :meth:`stop_replica` + :meth:`start_replica`."""
        await self.stop_replica(i, settle=settle)
        await self.start_replica(i)

    async def wait_converged(self, timeout: float = 15.0) -> None:
        """Block until every LIVE replica's per-shard store checksums
        agree (a decommissioned replica's frozen pre-stop stores can
        never converge and are excluded; they re-enter the comparison
        when ``start_replica`` rebuilds them)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            live = self.live_replicas
            sums = [
                tuple(
                    self.machines[r][s].store.checksum()
                    for s in range(self.n_shards)
                )
                for r in live
            ]
            if sums and all(s == sums[0] for s in sums[1:]):
                return
            await asyncio.sleep(0.05)
        detail = "; ".join(
            f"r{r}=" + ",".join(
                f"s{s}:{self.machines[r][s].store.checksum() & 0xFFFF:04x}"
                f"/v{self.machines[r][s].store.version}"
                f"/n{len(self.machines[r][s].store)}"
                for s in range(self.n_shards)
            )
            for r in self.live_replicas
        )
        applied = "; ".join(
            f"r{r}={self.engines[r].applied_frontier().tolist()}"
            for r in self.live_replicas
        )
        raise TimeoutError(
            f"replica stores did not converge within {timeout}s "
            f"({detail}) applied: {applied}"
        )

    async def stop(self) -> None:
        for g in self.gateways:
            if g is not None:
                await g.close()
        self.gateways = []
        for e in self.engines:
            if e is not None:
                await e.shutdown()
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        self.tasks = []
        for n in self.nets:
            if n is not None:
                await n.close()
        self.nets = []
        for p in self.persists:
            if getattr(p, "supports_wal", False):
                p.close()
