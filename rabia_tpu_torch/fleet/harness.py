"""Fleet test/bench fabric: resolver, MOVED-following client, harnesses.

Four pieces shared by tests/test_fleet.py, the chaos plane's fleet
fabric (rabia_tpu_torch/chaos/runner.py) and ``benchmarks/loadgen.py
--fleet``:

- :class:`FleetResolver` — a client-side hash-ring view: shard ->
  gateway address, updated from ``MOVED`` redirects and refreshable
  from any live member's ``AdminKind.RING`` frame;
- :class:`FleetSession` — ONE client identity across the whole fleet.
  Follows MOVED, retries RETRY, and fails over to ring successors when
  a gateway dies mid-call — always re-sending the SAME seq, so the
  session tables (fleet tier, then replica tier, then the engine's
  deterministic batch ids) enforce exactly-once end to end;
- :class:`FleetHarness` — in-process: a real-TCP GatewayCluster plus N
  in-process :class:`~rabia_tpu_torch.fleet.gateway_proc.FleetGateway`\\ s on
  the same loop, with rebalance/kill hooks;
- :class:`FleetProcHarness` — each fleet gateway as its own OS process
  (the testing/recovery.py child protocol), so a SIGKILL is a real
  crash with no in-process cleanup.

The port's copy of the reference's ``rabia_tpu/fleet/harness.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import uuid
from typing import Optional, Sequence

from rabia_tpu_torch.core.messages import AdminKind, Result, ResultStatus
from rabia_tpu_torch.core.serialization import Serializer
from rabia_tpu_torch.core.types import NodeId
from rabia_tpu_torch.fleet.gateway_proc import FleetGateway, FleetGatewayConfig
from rabia_tpu_torch.fleet.ring import HashRing, RingMember
from rabia_tpu_torch.testing.loadsession import LoadSession, MuxConn
from rabia_tpu_torch.testing.multiproc import REPO, free_ports

Addr = tuple[str, int]


class FleetResolver:
    """Client-side ring view with per-shard MOVED overrides."""

    def __init__(self, ring: HashRing) -> None:
        self.ring = ring
        self.overrides: dict[int, Addr] = {}

    def addr_for(self, shard: int) -> Optional[Addr]:
        ov = self.overrides.get(shard)
        if ov is not None:
            return ov
        m = self.ring.owner(shard)
        return (m.host, m.port) if m is not None else None

    def candidates(self, shard: int) -> list[Addr]:
        """Failover order: current answer first, then every distinct
        ring successor clockwise from the shard's point."""
        out: list[Addr] = []
        first = self.addr_for(shard)
        if first is not None:
            out.append(first)
        for m in self.ring.successors(shard, len(self.ring)):
            a = (m.host, m.port)
            if a not in out:
                out.append(a)
        return out

    def note_moved(self, shard: int, addr: Addr) -> None:
        self.overrides[shard] = addr

    def update(self, ring: HashRing) -> None:
        self.ring = ring
        self.overrides.clear()

    async def refresh(self, timeout: float = 5.0) -> bool:
        """Re-fetch the ring from any live member (after a kill the
        stale view's MOVED chain dead-ends; survivors know the truth)."""
        from rabia_tpu_torch.gateway.client import admin_fetch

        addrs = {(m.host, m.port) for m in self.ring.members.values()}
        addrs.update(self.overrides.values())
        for host, port in addrs:
            try:
                body = await admin_fetch(
                    host, port, kind=int(AdminKind.RING), timeout=timeout
                )
                doc = json.loads(body.decode())
                self.update(HashRing.from_doc(doc["ring"]))
                return True
            except Exception:
                continue
        return False


class FleetConnPool:
    """Shared mux connections: one :class:`MuxConn` per gateway address
    serves EVERY session's frames there — the 10^5-session lane (a
    session costs a dict entry, not a socket)."""

    def __init__(self, ser: Serializer) -> None:
        self.ser = ser
        self.muxes: dict[Addr, MuxConn] = {}
        self._dialing: dict[Addr, asyncio.Lock] = {}

    async def attach(
        self, session: LoadSession, addr: Addr, timeout: float = 10.0
    ) -> LoadSession:
        lock = self._dialing.setdefault(addr, asyncio.Lock())
        async with lock:
            mux = self.muxes.get(addr)
            if (
                mux is None or mux.closed or mux.writer is None
                or mux.writer.is_closing()
            ):
                mux = MuxConn(self.ser)
                await mux.connect(addr[0], addr[1], timeout)
                self.muxes[addr] = mux
        return await session.connect_mux(mux, timeout)

    def drop(self, addr: Addr, mux: Optional[MuxConn] = None) -> None:
        """Close the shared connection to ``addr``; with ``mux``, only
        if that is still the one held (a session that failed on an old
        connection must not close the fresh one another session dialed)."""
        cur = self.muxes.get(addr)
        if cur is None or (mux is not None and cur is not mux):
            return
        del self.muxes[addr]
        asyncio.ensure_future(cur.close())

    async def close(self) -> None:
        muxes, self.muxes = list(self.muxes.values()), {}
        for mux in muxes:
            await mux.close()


class FleetSession:
    """One client identity routed across the fleet (see module doc)."""

    def __init__(
        self,
        ser: Serializer,
        resolver: FleetResolver,
        client_id: Optional[uuid.UUID] = None,
        pool: Optional[FleetConnPool] = None,
        call_timeout: float = 5.0,
    ) -> None:
        self.ser = ser
        self.resolver = resolver
        self.client_id = client_id or uuid.uuid4()
        self.pool = pool
        self.call_timeout = call_timeout
        self.conns: dict[Addr, LoadSession] = {}
        self._seq = 0
        self._dial_lock = asyncio.Lock()
        self.redirects = 0  # MOVED hops followed
        self.failovers = 0  # dead-gateway candidate advances

    async def _conn(self, addr: Addr, timeout: float) -> LoadSession:
        ls = self.conns.get(addr)
        if ls is not None and ls.alive:
            return ls
        # serialize dials: two concurrent submits racing a fresh dial
        # would register two LoadSessions under ONE client id (the
        # second overwrites the first's mux slot, stranding its futures)
        async with self._dial_lock:
            ls = self.conns.get(addr)
            if ls is not None and ls.alive:
                return ls
            if ls is not None:
                # its connection closed under it (the gateway died, or
                # another session dropped the shared mux): dial anew
                self.conns.pop(addr, None)
                await ls.close()
            ls = LoadSession(self.ser, client_id=self.client_id)
            if self.pool is not None:
                await self.pool.attach(ls, addr, timeout)
            else:
                await ls.connect(addr[0], addr[1], timeout)
            self.conns[addr] = ls
            return ls

    async def _drop(self, addr: Addr) -> None:
        ls = self.conns.pop(addr, None)
        mux = ls._mux if ls is not None else None
        if ls is not None:
            try:
                await ls.close()
            except Exception:
                pass
        if self.pool is not None:
            self.pool.drop(addr, mux)

    async def submit(
        self, shard: int, commands: Sequence[bytes], timeout: float = 20.0
    ) -> Result:
        self._seq += 1
        return await self.submit_seq(self._seq, shard, commands, timeout)

    async def submit_seq(
        self,
        seq: int,
        shard: int,
        commands: Sequence[bytes],
        timeout: float = 20.0,
    ) -> Result:
        """Drive one seq to an answer, re-sending the SAME seq across
        MOVED redirects, RETRY backoffs and gateway failovers."""
        if seq > self._seq:
            self._seq = seq
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        tried: set[Addr] = set()
        addr = self.resolver.addr_for(shard)
        refreshed = False
        while True:
            remaining = deadline - loop.time()
            if remaining <= 0 or addr is None:
                raise TimeoutError(
                    f"fleet submit (client={self.client_id}, seq={seq}, "
                    f"shard={shard}) unanswered within {timeout}s"
                )
            call = min(self.call_timeout, remaining)
            try:
                ls = await self._conn(addr, call)
                res = await ls.submit_seq(seq, shard, commands, call)
            except (asyncio.TimeoutError, TimeoutError, ConnectionError,
                    OSError) as e:
                await self._drop(addr)
                tried.add(addr)
                addr = next(
                    (a for a in self.resolver.candidates(shard)
                     if a not in tried),
                    None,
                )
                if addr is not None:
                    self.failovers += 1
                    continue
                if not refreshed:
                    # every known candidate dead or stale: ask a
                    # survivor for the current ring, then start over
                    refreshed = await self.resolver.refresh(
                        timeout=min(5.0, max(0.5, remaining))
                    )
                    if refreshed:
                        tried.clear()
                        addr = self.resolver.addr_for(shard)
                        continue
                raise TimeoutError(
                    f"fleet submit seq={seq}: no live gateway ({e})"
                ) from None
            st = res.status
            if st == ResultStatus.MOVED:
                host, _, port = res.payload[0].decode().rpartition(":")
                addr = (host, int(port))
                self.resolver.note_moved(shard, addr)
                self.redirects += 1
                continue
            if st == ResultStatus.RETRY:
                await asyncio.sleep(min(0.05, max(0.0, remaining)))
                continue
            return res

    async def close(self) -> None:
        conns, self.conns = list(self.conns.values()), {}
        for ls in conns:
            try:
                await ls.close()
            except Exception:
                pass


class FleetHarness:
    """In-process fleet: real-TCP replica cluster + N FleetGateways on
    this loop, with the rebalance and kill hooks chaos/tests drive."""

    def __init__(
        self,
        n_gateways: int = 2,
        n_replicas: int = 3,
        n_shards: int = 4,
        replication_factor: int = 2,
        persistence: bool | str = True,
        gateway_config=None,
        forward_timeout: float = 20.0,
        waiter_timeout: float = 5.0,
        vnodes: int = 16,
    ) -> None:
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        self.n_gateways = n_gateways
        self.n_shards = n_shards
        self.rf = replication_factor
        self.vnodes = vnodes
        self.forward_timeout = forward_timeout
        self.waiter_timeout = waiter_timeout
        self.cluster = GatewayCluster(
            n_replicas=n_replicas,
            n_shards=n_shards,
            gateway_config=gateway_config,
            persistence=persistence,
        )
        self.gateways: list[Optional[FleetGateway]] = []
        self.ser = Serializer()

    async def start(self) -> None:
        await self.cluster.start()
        upstreams = tuple(
            (ep.host, ep.port) for ep in self.cluster.endpoints()
        )
        self.gateways = [
            FleetGateway(
                FleetGatewayConfig(
                    name=f"gw{i}",
                    upstreams=upstreams,
                    n_shards=self.n_shards,
                    replication_factor=self.rf,
                    forward_timeout=self.forward_timeout,
                    waiter_timeout=self.waiter_timeout,
                ),
                node_id=NodeId.from_int(2000 + i),
            )
            for i in range(self.n_gateways)
        ]
        for gw in self.gateways:
            await gw.start()
        ring = self.build_ring(range(self.n_gateways))
        for gw in self.gateways:
            gw.adopt_ring(ring.copy())

    def build_ring(self, indices) -> HashRing:
        ring = HashRing(vnodes=self.vnodes)
        for i in indices:
            gw = self.gateways[i]
            ring.add(gw.member())
        return ring

    def live_indices(self) -> list[int]:
        return [i for i, g in enumerate(self.gateways) if g is not None]

    def resolver(self) -> FleetResolver:
        ring = self.build_ring(self.live_indices())
        return FleetResolver(ring)

    async def rebalance(self, indices) -> None:
        """Push a new membership view to every LIVE gateway; members
        losing shards hand their sessions off before answering MOVED."""
        ring = self.build_ring(indices)
        await asyncio.gather(*(
            self.gateways[i]._rebalance(ring.copy())
            for i in self.live_indices()
        ))

    async def kill_gateway(self, i: int) -> None:
        """Abrupt death: NO handoff runs (close only tears the tasks
        down); survivors then adopt the shrunken ring. Redirected
        replays must be answered by the replicated ledger records."""
        gw = self.gateways[i]
        self.gateways[i] = None
        if gw is not None:
            await gw.close()
        await self.rebalance(self.live_indices())

    async def stop(self) -> None:
        for i, gw in enumerate(self.gateways):
            if gw is not None:
                await gw.close()
                self.gateways[i] = None
        await self.cluster.stop()


class FleetProcHarness:
    """N fleet gateways as real OS processes (SIGKILL-able), proxying
    to an externally managed replica cluster's gateway endpoints."""

    def __init__(
        self,
        upstream_addrs: list[Addr],
        n_gateways: int = 2,
        n_shards: int = 4,
        extras: Optional[dict] = None,
    ) -> None:
        from rabia_tpu_torch.testing.recovery import ReplicaProc

        self._proc_cls = ReplicaProc
        self.upstream_addrs = [list(a) for a in upstream_addrs]
        self.n = n_gateways
        self.n_shards = n_shards
        self.extras = dict(extras or {})
        self.ports = free_ports(n_gateways)
        self.procs: list[Optional[object]] = [None] * n_gateways

    def _spawn(self, i: int):
        env = dict(os.environ)
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "rabia_tpu_torch.fleet.gateway_proc",
                "--child", str(i),
                json.dumps(self.ports), json.dumps(self.upstream_addrs),
                str(self.n_shards), json.dumps(self.extras),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            env=env,
            cwd=REPO,
        )
        rp = self._proc_cls(proc)
        self.procs[i] = rp
        return rp

    def start(self, timeout: float = 60.0) -> list[dict]:
        for i in range(self.n):
            self._spawn(i)
        return [
            self.procs[i].wait_event("ready", timeout) for i in range(self.n)
        ]

    def ring(self, indices: Optional[Sequence[int]] = None) -> HashRing:
        ring = HashRing()
        for i in (range(self.n) if indices is None else indices):
            ring.add(RingMember(
                name=f"gw{i}", host="127.0.0.1", port=self.ports[i],
                node=NodeId.from_int(2000 + i),
            ))
        return ring

    async def push_ring(
        self, indices: Sequence[int], timeout: float = 10.0
    ) -> HashRing:
        """The control-plane move an operator makes after a member
        dies or joins: push the new membership to every named member
        over the RING admin frame ({"op": "set"}); each adoption runs
        the handoff protocol for shards it is losing."""
        from rabia_tpu_torch.gateway.client import admin_fetch

        ring = self.ring(indices)
        query = json.dumps(
            {"op": "set", "ring": ring.to_doc()}
        ).encode()
        for i in indices:
            await admin_fetch(
                "127.0.0.1", self.ports[i],
                kind=int(AdminKind.RING), timeout=timeout, query=query,
            )
        return ring

    def kill9(self, i: int) -> None:
        rp = self.procs[i]
        assert rp is not None
        rp.proc.send_signal(signal.SIGKILL)
        rp.proc.wait(timeout=10)
        self.procs[i] = None

    def stop(self) -> None:
        for rp in self.procs:
            if rp is not None and rp.proc.poll() is None:
                rp.proc.send_signal(signal.SIGTERM)
        for rp in self.procs:
            if rp is not None:
                try:
                    rp.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    rp.proc.kill()
