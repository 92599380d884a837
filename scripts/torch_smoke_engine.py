"""3-node in-memory cluster smoke test for the port's host engine (dev script).

The counterpart of ``scripts/smoke_engine.py`` over ``rabia_tpu_torch``:
the same cluster, submissions, checks and printed lines.

    python scripts/torch_smoke_engine.py
"""

import asyncio
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rabia_tpu_torch.core.config import RabiaConfig  # noqa: E402
from rabia_tpu_torch.core.network import ClusterConfig  # noqa: E402
from rabia_tpu_torch.core.state_machine import InMemoryStateMachine  # noqa: E402
from rabia_tpu_torch.core.types import CommandBatch, NodeId  # noqa: E402
from rabia_tpu_torch.engine import RabiaEngine  # noqa: E402
from rabia_tpu_torch.net import InMemoryHub  # noqa: E402


async def main() -> int:
    nodes = [NodeId.from_int(i + 1) for i in range(3)]
    hub = InMemoryHub()
    config = RabiaConfig(
        phase_timeout=0.5, heartbeat_interval=0.1, round_interval=0.002
    ).with_kernel(num_shards=2, shard_pad_multiple=2)
    engines = []
    sms = []
    for n in nodes:
        sm = InMemoryStateMachine()
        t = hub.register(n)
        eng = RabiaEngine(
            ClusterConfig.new(n, nodes), sm, t, persistence=None, config=config
        )
        engines.append(eng)
        sms.append(sm)
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    await asyncio.sleep(0.5)  # let heartbeats establish quorum

    t0 = time.time()
    fut = await engines[0].submit_batch(
        CommandBatch.new(["SET k1 hello", "SET k2 world"]), shard=0
    )
    responses = await asyncio.wait_for(fut, 10.0)
    print(f"decision in {time.time()-t0:.3f}s; responses={responses}")

    fut2 = await engines[1].submit_batch(CommandBatch.new(["SET k3 again"]), shard=1)
    r2 = await asyncio.wait_for(fut2, 10.0)
    print(f"second batch: {r2}")

    await asyncio.sleep(1.0)  # let followers apply
    ok = True
    for i, sm in enumerate(sms):
        st = await engines[i].get_statistics()
        print(f"node{i}: {sm.get_state_summary()} k1={sm.get('k1')} k3={sm.get('k3')} "
              f"applied={st.committed_slots} v1={st.decided_v1} v0={st.decided_v0}")
        if sm.get("k1") != "hello" or sm.get("k3") != "again":
            ok = False
    for e in engines:
        await e.shutdown()
    for t in tasks:
        t.cancel()
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
