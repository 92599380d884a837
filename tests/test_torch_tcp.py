"""Native TCP transport tests: framing, handshake, cluster over real sockets.

The port's copy of the reference's tests/test_tcp.py, retargeted to
rabia_tpu_torch (the port's native libraries, built from its own sources).

Reference parity: tcp.rs:829-891 (create/frame/2-node-connect unit tests)
plus a 3-node consensus run over real localhost TCP (the tcp_networking
example's core assertion).
"""

import asyncio
import os

import pytest

from rabia_tpu_torch.core.config import RabiaConfig, TcpNetworkConfig
from rabia_tpu_torch.core.network import ClusterConfig
from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
from rabia_tpu_torch.core.types import CommandBatch, NodeId
from rabia_tpu_torch.engine import RabiaEngine
from rabia_tpu_torch.net.tcp import TcpNetwork

from netwait import wait_connected, wait_full_mesh


def _cfg(n: int = 1) -> RabiaConfig:
    return RabiaConfig(
        phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
    ).with_kernel(num_shards=n, shard_pad_multiple=max(1, n))


class TestTransportBasics:
    @pytest.mark.asyncio
    async def test_bind_ephemeral_port(self):
        t = TcpNetwork(NodeId.from_int(1), TcpNetworkConfig(bind_port=0))
        try:
            assert t.port > 0
        finally:
            await t.close()

    @pytest.mark.asyncio
    async def test_two_node_handshake_and_send(self):
        a, b = NodeId.from_int(1), NodeId.from_int(2)
        ta = TcpNetwork(a, TcpNetworkConfig(bind_port=0))
        tb = TcpNetwork(b, TcpNetworkConfig(bind_port=0))
        try:
            ta.add_peer(b, "127.0.0.1", tb.port)
            tb.add_peer(a, "127.0.0.1", ta.port)
            await wait_connected((ta, b), (tb, a))
            await ta.send_to(b, b"hello over tcp")
            sender, data = await tb.receive(timeout=5.0)
            assert sender == a
            assert data == b"hello over tcp"
        finally:
            await ta.close()
            await tb.close()

    @pytest.mark.asyncio
    async def test_large_frame_roundtrip(self):
        a, b = NodeId.from_int(1), NodeId.from_int(2)
        ta = TcpNetwork(a, TcpNetworkConfig(bind_port=0))
        tb = TcpNetwork(b, TcpNetworkConfig(bind_port=0))
        try:
            ta.add_peer(b, "127.0.0.1", tb.port)
            await wait_connected((ta, b))
            payload = bytes(range(256)) * 4096  # 1 MiB
            await ta.send_to(b, payload)
            _, data = await tb.receive(timeout=15.0)
            assert data == payload
        finally:
            await ta.close()
            await tb.close()

    @pytest.mark.asyncio
    async def test_broadcast_reaches_all(self):
        ids = [NodeId.from_int(i + 1) for i in range(3)]
        nets = [TcpNetwork(i, TcpNetworkConfig(bind_port=0)) for i in ids]
        try:
            for i, a in enumerate(ids):
                for j, b in enumerate(ids):
                    if i != j:
                        nets[i].add_peer(b, "127.0.0.1", nets[j].port)
            await wait_full_mesh(nets, 2)
            await nets[0].broadcast(b"to everyone")
            for k in (1, 2):
                sender, data = await nets[k].receive(timeout=15.0)
                assert sender == ids[0]
                assert data == b"to everyone"
        finally:
            for n in nets:
                await n.close()


class TestPoolStats:
    @pytest.mark.asyncio
    async def test_out_pool_stats_readable_and_counted(self):
        """The outbound frame arena's hit/miss counters (kept natively in
        transport.cpp since the out-pool landed) must be readable from
        Python: misses on cold sends, hits once recycled frames get
        reused, and the merged pool_stats view stays a superset."""
        a, b = NodeId.from_int(1), NodeId.from_int(2)
        ta = TcpNetwork(a, TcpNetworkConfig(bind_port=0))
        tb = TcpNetwork(b, TcpNetworkConfig(bind_port=0))
        try:
            ta.add_peer(b, "127.0.0.1", tb.port)
            tb.add_peer(a, "127.0.0.1", ta.port)
            await wait_connected((ta, b), (tb, a))
            assert ta.out_pool_stats == (0, 0)  # nothing sent yet
            # sequential send/receive round-trips: each completed write
            # recycles its frame buffer, so later sends HIT the arena
            for i in range(32):
                await ta.send_to(b, b"x" * 64)
                await tb.receive(timeout=10.0)
            hits, misses = ta.out_pool_stats
            # recycled-buffer reuse must actually happen (even send #1
            # can hit: the flushed 16B handshake buffer is recycled into
            # the arena before the first data frame)
            assert hits >= 1
            assert hits + misses == 32
            # the merged view includes the out-pool numbers
            mh, mm = ta.pool_stats
            assert mh >= hits and mm >= misses
            # and the counter block agrees with the dedicated accessor
            ctrs = ta.transport_counters()
            assert ctrs["out_pool_hits"] == hits
            assert ctrs["out_pool_misses"] == misses
        finally:
            await ta.close()
            await tb.close()
        # closed: late scrapes read the state frozen at teardown
        assert ta.out_pool_stats == (hits, misses)
        assert ta.transport_counters()["out_pool_hits"] == hits


class TestClosedTransportDrops:
    """A send on a closed transport is dropped in Python. ``close()``
    swaps the native handle to None, and ``rt_send`` / ``rt_broadcast``
    dereference the handle they are given: the reference's copy passes
    None through, so a late send (an engine's timer that outlived its
    shutdown) kills the process with SIGSEGV."""

    @pytest.mark.asyncio
    async def test_send_after_close_never_reaches_the_native_entry(self):
        t = TcpNetwork(NodeId.from_int(1), TcpNetworkConfig(bind_port=0))
        await t.close()
        calls = []

        class Spy:
            def __getattr__(self, name):
                return lambda *args: calls.append((name, args)) or 0

        t._lib = Spy()
        assert t.broadcast_nowait(b"late") is False
        assert t.send_to_nowait(NodeId.from_int(2), b"late") is False
        assert calls == []


class TestSimultaneousDialDrain:
    @pytest.mark.asyncio
    async def test_send_in_dup_race_window_not_lost(self):
        """Both sides dial at once, and the sender fires the moment ITS
        side reports connected — possibly on the duplicate connection
        that the deterministic smaller-id-wins tiebreak is about to
        cull. Pre-round-5 the loser was ::close()d immediately, so a
        frame in flight on it was silently dropped (a rare receive
        timeout under CPU load, a different test each run); the drain
        path (native/transport.cpp Conn::draining) must deliver it.
        Probabilistic pin: each iteration reopens the race window."""
        # load-aware receive budget: the 15s default is generous on an
        # idle host but this file shares CI boxes with the chaos/fleet
        # suites; when the 1-minute load average exceeds the core count
        # scale the budget up (capped at 2x) instead of flaking
        load = os.getloadavg()[0] / max(1, os.cpu_count() or 1)
        budget = 15.0 * max(1.0, min(2.0, load))
        for i in range(25):
            a = NodeId.from_int(1000 + 2 * i)
            b = NodeId.from_int(1001 + 2 * i)
            ta = TcpNetwork(a, TcpNetworkConfig(bind_port=0))
            tb = TcpNetwork(b, TcpNetworkConfig(bind_port=0))
            try:
                # both add_peer -> both dial -> duplicate resolution
                ta.add_peer(b, "127.0.0.1", tb.port)
                tb.add_peer(a, "127.0.0.1", ta.port)
                await wait_connected((ta, b))  # ONE side only, on purpose
                await ta.send_to(b, b"race window frame")
                sender, data = await tb.receive(timeout=budget)
                assert sender == a, i
                assert data == b"race window frame", i
            finally:
                await ta.close()
                await tb.close()


class TestConsensusOverTcp:
    @pytest.mark.asyncio
    async def test_three_node_cluster_commits(self):
        """Full consensus over real localhost sockets (BASELINE config #5's
        transport)."""
        ids = [NodeId.from_int(i + 1) for i in range(3)]
        nets = [TcpNetwork(i, TcpNetworkConfig(bind_port=0)) for i in ids]
        for i in range(3):
            for j in range(3):
                if i != j:
                    nets[i].add_peer(ids[j], "127.0.0.1", nets[j].port)
        sms = [InMemoryStateMachine() for _ in ids]
        engines = [
            RabiaEngine(
                ClusterConfig.new(ids[i], ids), sms[i], nets[i], config=_cfg()
            )
            for i in range(3)
        ]
        tasks = [asyncio.ensure_future(e.run()) for e in engines]
        try:
            for _ in range(200):
                await asyncio.sleep(0.01)
                sts = [await e.get_statistics() for e in engines]
                if all(s.has_quorum for s in sts):
                    break
            fut = await engines[0].submit_batch(
                CommandBatch.new(["SET tcp works"])
            )
            responses = await asyncio.wait_for(fut, 15.0)
            assert responses == [b"OK"]

            async def converged():
                while not all(sm.get("tcp") == "works" for sm in sms):
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(converged(), 10.0)
        finally:
            for e in engines:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for n in nets:
                await n.close()
