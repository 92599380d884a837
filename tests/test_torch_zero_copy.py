"""Zero-copy inbox handoff of the port's device backend
(``KernelConfig.zero_copy_inbox``), the port's copy of the reference's
tests/test_zero_copy.py for the planes and the engine (its transport
borrow cases are the TCP transport's, tested in test_torch_tcp.py).

1. dlpack plane adoption on the CPU: ``torch.from_dlpack`` of the
   engine's 64-byte-aligned planes shares their memory (pointer
   identity, as the reference pins for XLA's CPU client); unlike XLA,
   which copied an unaligned plane, torch shares that one too; writes
   before the dispatch are seen; ``node_cycle`` on adopted planes equals
   ``node_cycle`` on copies and the reference's ``node_cycle``.
2. The engine: with ``zero_copy_inbox`` the planes a tick hands the node
   kernel ARE the engine's planes (without it, copies); a device-backend
   cluster on ``device="cpu"`` commits with the flag; the host backend
   ignores it, as the reference's does.

Tolerance: exact equality.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabia_tpu_torch.core.config import RabiaConfig
from rabia_tpu_torch.core.network import ClusterConfig
from rabia_tpu_torch.core.state_machine import InMemoryStateMachine
from rabia_tpu_torch.core.types import ABSENT, V0, V1, CommandBatch, NodeId
from rabia_tpu_torch.engine import RabiaEngine
from rabia_tpu_torch.engine.engine import _aligned_i8
from rabia_tpu_torch.kernel.phase_driver import NodeKernel
from rabia_tpu_torch.net import InMemoryHub


class TestDlpackPlaneAdoption:
    def test_pointer_identity_on_cpu(self):
        plane = _aligned_i8((8, 3), ABSENT)
        assert plane.ctypes.data % 64 == 0
        adopted = torch.from_dlpack(plane)
        # the tensor reads the numpy plane's memory, not a copy
        assert adopted.data_ptr() == plane.ctypes.data
        # the reference's XLA client adopts the same aligned plane
        from rabia_tpu.engine.engine import _aligned_i8 as ref_aligned

        ref_plane = ref_aligned((8, 3), ABSENT)
        assert jax.dlpack.from_dlpack(ref_plane).unsafe_buffer_pointer() == ref_plane.ctypes.data

    def test_unaligned_plane_is_shared_too(self):
        # the reference's control: XLA copies a misaligned buffer. torch's
        # dlpack import has no alignment rule, so the port shares it
        raw = np.zeros(24 + 1, np.int8)
        off = 1 if raw.ctypes.data % 64 == 0 else 0
        mis = raw[off : off + 24].reshape(8, 3)
        assert mis.ctypes.data % 64 != 0
        assert torch.from_dlpack(mis).data_ptr() == mis.ctypes.data

    def test_adopted_plane_sees_pre_dispatch_writes(self):
        plane = _aligned_i8((16, 5), ABSENT)
        plane[3, 2] = V1
        plane[7, 0] = V0
        got = torch.from_dlpack(plane).numpy()
        assert got[3, 2] == V1 and got[7, 0] == V0
        assert (got == ABSENT).sum() == 16 * 5 - 2
        plane[1, 1] = V1  # a write after adoption is seen too: shared memory
        assert int(torch.from_dlpack(plane)[1, 1]) == V1

    def test_node_cycle_identical_with_adopted_inboxes(self):
        """The flag's contract: node_cycle(adopted planes) ==
        node_cycle(copied planes) == the reference's, state and outbox,
        bit for bit."""
        from rabia_tpu.kernel.phase_driver import NodeKernel as RefNode

        S, R = 16, 3
        k = NodeKernel(S, R, me=0, seed=5, device="cpu")
        rng = np.random.default_rng(9)
        ib1 = _aligned_i8((S, R), ABSENT)
        ib2 = _aligned_i8((S, R), ABSENT)
        dec = _aligned_i8(S, ABSENT)
        m = rng.random((S, R)) < 0.5
        ib1[m] = rng.choice(np.array([V0, V1], np.int8), size=int(m.sum()))
        m2 = rng.random((S, R)) < 0.3
        ib2[m2] = rng.choice(np.array([V0, V1], np.int8), size=int(m2.sum()))
        mask = np.ones(S, bool)
        slots = np.zeros(S, np.int32)
        init = rng.choice(np.array([V0, V1], np.int8), size=S)
        open_planes = [torch.from_numpy(a) for a in (mask, slots, init)]
        st_a, ob_a = k.node_cycle(k.init_state(), *open_planes,
                                  *(torch.from_dlpack(a) for a in (ib1, ib2, dec)), 3)
        st_b, ob_b = k.node_cycle(k.init_state(), *open_planes,
                                  *(torch.tensor(a) for a in (ib1, ib2, dec)), 3)
        ref = RefNode(S, R, me=0, seed=5)
        st_r, ob_r = ref.node_cycle(ref.init_state(), *map(jnp.asarray, (
            mask, slots, init, ib1, ib2, dec)), 3)
        for fa, fb, fr in zip(st_a, st_b, st_r):
            assert torch.equal(fa, fb) and np.array_equal(fa.numpy(), np.asarray(fr))
        for fa, fb, fr in zip(ob_a, ob_b, ob_r):
            assert torch.equal(fa, fb) and np.array_equal(fa.numpy(), np.asarray(fr))


def _engine(config, device="cpu"):
    nodes = [NodeId.from_int(i + 1) for i in range(3)]
    return RabiaEngine(
        ClusterConfig.new(nodes[0], nodes), InMemoryStateMachine(),
        InMemoryHub().register(nodes[0]), config=config, device=device,
    )


class TestEngineZeroCopy:
    @pytest.mark.parametrize("zc", [True, False])
    def test_tick_planes_are_the_engine_planes_only_with_the_flag(self, zc):
        eng = _engine(RabiaConfig().with_kernel(
            num_shards=4, shard_pad_multiple=4, backend="jax", zero_copy_inbox=zc))
        assert eng._zc_inbox is zc
        for plane in (eng._inbox1, eng._inbox2, eng._dec_plane):
            assert plane.ctypes.data % 64 == 0
        S = eng.S
        planes = eng._tick_planes(np.zeros(S, bool), np.zeros(S, np.int32),
                                    np.full(S, V0, np.int8))
        shared = [p.data_ptr() == a.ctypes.data
                  for p, a in zip(planes[3:], (eng._inbox1, eng._inbox2, eng._dec_plane))]
        assert shared == [zc] * 3

    @pytest.mark.asyncio
    async def test_device_backend_cluster_commits_with_zero_copy_inbox(self):
        nodes = [NodeId.from_int(i + 1) for i in range(3)]
        hub = InMemoryHub()
        config = RabiaConfig(
            phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002,
        ).with_kernel(num_shards=2, shard_pad_multiple=2, backend="jax", zero_copy_inbox=True)
        engines, sms, tasks = [], [], []
        for node in nodes:
            sm = InMemoryStateMachine()
            eng = RabiaEngine(ClusterConfig.new(node, nodes), sm, hub.register(node),
                              config=config, device="cpu")
            assert eng._zc_inbox
            engines.append(eng)
            sms.append(sm)
            tasks.append(asyncio.ensure_future(eng.run()))
        try:
            for _ in range(200):
                await asyncio.sleep(0.01)
                stats = [await e.get_statistics() for e in engines]
                if all(s.has_quorum for s in stats):
                    break
            futs = [
                await e.submit_batch(CommandBatch.new([f"SET zc{i} v{i}"]), shard=i % 2)
                for i, e in enumerate(engines)
            ]
            for f in futs:
                await asyncio.wait_for(f, 20.0)

            async def converged():
                while not all(
                    all(sm.get(f"zc{i}") == f"v{i}" for i in range(3)) for sm in sms
                ):
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(converged(), 20.0)
            assert all(e.device_tick_stats["ticks"] > 0 for e in engines)
        finally:
            for e in engines:
                await e.shutdown()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    def test_flag_ignored_on_host_backend(self):
        # host backend ignores the flag (there is no device boundary)
        nodes = [NodeId.from_int(1)]
        eng = RabiaEngine(
            ClusterConfig.new(nodes[0], nodes), InMemoryStateMachine(),
            InMemoryHub().register(nodes[0]),
            config=RabiaConfig().with_kernel(zero_copy_inbox=True),
        )
        assert eng._host_kernel and not eng._zc_inbox
