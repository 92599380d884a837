"""Look inside the port's transport engine on the planes gate's workload.

    python3 scripts/torch_transport_gate.py --shards 2048 --replicas 5 --waves 3 --cap 256 --profile
    python3 scripts/torch_transport_gate.py --gate-turns per-shard,256,256,per-shard --device cuda

The first form runs a cluster of ``rabia_tpu_torch``'s ``RabiaEngine`` over
the in-memory hub with the planes gate's timing (phase_timeout 3.0,
heartbeat 0.05, round interval 0.002), submits waves of 4 SETs on every
shard from replica 0, and prints each wave's seconds, the null (V0)
slots decided, the slots each engine opened with V0 and why (peers
already voting, or the forward timeout on an unresponsive proposer), how
many of those shards had their Propose already waiting unread in the
engine's inbox, the largest inbound backlog per engine, tick times, and
the seconds spent in the engine's main steps. ``--cap 256`` runs the
engines with the reference's fixed drain cap instead of the port's one
message a shard; ``--profile`` runs under cProfile (which slows the host
about twofold: a loaded host).

The second form runs ``chip_smoke.planes_gate`` (config 3's shape: 4096
shards x 5 replicas, 3 waves; the MeshEngine on ``--device``) once for
each cap named, in turns, and prints pass or the divergence.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import gc
import inspect
import io
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rabia_tpu_torch.core import serialization  # noqa: E402
from rabia_tpu_torch.core.config import RabiaConfig  # noqa: E402
from rabia_tpu_torch.core.messages import Propose  # noqa: E402
from rabia_tpu_torch.core.network import ClusterConfig  # noqa: E402
from rabia_tpu_torch.core.state_machine import InMemoryStateMachine  # noqa: E402
from rabia_tpu_torch.core.types import V0, CommandBatch, NodeId  # noqa: E402
from rabia_tpu_torch.engine import RabiaEngine  # noqa: E402
from rabia_tpu_torch.net import InMemoryHub  # noqa: E402

STEPS = ("_drain_messages", "_forward_submissions", "_kernel_round", "_apply_ready",
         "_process_outbox", "_record_decision", "_send")


def _set_cap(cap: str) -> None:
    """Make every RabiaEngine built from now on drain ``cap`` messages a
    tick ("per-shard": the port's own rule)."""
    init = RabiaEngine.__dict__.get("_orig_init", RabiaEngine.__init__)
    RabiaEngine._orig_init = init

    def patched(self, *a, **k):
        init(self, *a, **k)
        if cap != "per-shard":
            self._drain_cap = int(cap)

    RabiaEngine.__init__ = patched


def _instrument(spent: dict) -> None:
    """Accumulate wall seconds per engine step and codec call."""

    def timed(name, fn):
        if inspect.iscoroutinefunction(fn):
            async def wrap(self, *a, **k):
                t = time.perf_counter()
                try:
                    return await fn(self, *a, **k)
                finally:
                    spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
        else:
            def wrap(self, *a, **k):
                t = time.perf_counter()
                try:
                    return fn(self, *a, **k)
                finally:
                    spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
        return wrap

    for name in STEPS:
        setattr(RabiaEngine, name, timed(name, getattr(RabiaEngine, name)))
    for name in ("serialize", "deserialize"):
        setattr(serialization.Serializer, name,
                timed(f"codec.{name}", getattr(serialization.Serializer, name)))


class _Watched(RabiaEngine):
    """Records why each slot opens with V0, inbound backlogs and ticks."""

    opens_v0: list = []
    queued: list = []
    backlog: dict = {}
    ticks_ns: list = []

    def _open_slots(self):
        n = self.n_shards
        now = time.time()
        seen = self.rt.votes_seen_slot[:n].copy()
        out = super()._open_slots()
        v0 = {(s, slot) for s, slot, v in out if v == V0}
        if v0:
            pending = 0
            for _sender, data in list(self.transport.hub.queue_of(self.node_id)._queue):
                p = self.serializer.deserialize(data).payload
                if isinstance(p, Propose) and (p.shard, p.phase >> 16) in v0:
                    pending += 1
            _Watched.queued.append((len(v0), pending))
            for s, slot in v0:
                sh = self.rt.shards[s]
                ff = sh.queue[0].first_forwarded_at if sh.queue else 0.0
                _Watched.opens_v0.append(
                    "votes_seen" if seen[s] >= slot else
                    f"forward_timeout ({now - ff:.2f} s)" if ff else "other")
        return out

    async def _tick(self):
        t = time.perf_counter_ns()
        out = await super()._tick()
        _Watched.ticks_ns.append(time.perf_counter_ns() - t)
        q = self.transport.hub.queue_of(self.node_id).qsize()
        _Watched.backlog[self.me] = max(_Watched.backlog.get(self.me, 0), q)
        return out


async def _cluster(S: int, R: int, waves: int) -> dict:
    config = RabiaConfig(phase_timeout=3.0, heartbeat_interval=0.05,
                         round_interval=0.002).with_kernel(num_shards=S, shard_pad_multiple=2)
    hub = InMemoryHub()
    nodes = [NodeId.from_int(i + 1) for i in range(R)]
    engines = [_Watched(ClusterConfig.new(n, nodes), InMemoryStateMachine(), hub.register(n),
                        config=config) for n in nodes]
    tasks = [asyncio.ensure_future(e.run()) for e in engines]
    try:
        for _ in range(500):
            await asyncio.sleep(0.01)
            if all([(await e.get_statistics()).has_quorum for e in engines]):
                break
        wave_s = []
        for w in range(waves):
            t = time.perf_counter()
            futs = [await engines[0].submit_batch(
                CommandBatch.new([f"SET k{s}_{i} w{w}" for i in range(4)]), shard=s)
                for s in range(S)]
            for f in futs:
                await asyncio.wait_for(f, 60.0)
            wave_s.append(time.perf_counter() - t)
        null_slots = sum(1 for s in range(S) for rec in engines[0].rt.shards[s].decisions.values()
                         if int(rec.value) == V0)
        return {"wave_s": wave_s, "null_slots": null_slots, "drain_cap": engines[0]._drain_cap}
    finally:
        for e in engines:
            await e.shutdown()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


def cluster_main(args) -> None:
    _set_cap(args.cap)
    spent: dict = {}
    _instrument(spent)
    prof = cProfile.Profile() if args.profile else None
    if prof:
        prof.enable()
    out = asyncio.run(_cluster(args.shards, args.replicas, args.waves))
    if prof:
        prof.disable()
    reasons: dict = {}
    for r in _Watched.opens_v0:
        key = r.split(" (")[0]
        reasons[key] = reasons.get(key, 0) + 1
    ticks = np.array(_Watched.ticks_ns) / 1e6
    print(f"S={args.shards} R={args.replicas} cap={args.cap} (drains {out['drain_cap']} a tick)"
          f"{' under cProfile' if prof else ''}")
    print(f"waves s: {[round(x, 3) for x in out['wave_s']]}; null (V0) slots decided on replica "
          f"0: {out['null_slots']}")
    print(f"slots opened with V0, by reason: {reasons}; first: {_Watched.opens_v0[:3]}")
    print("V0 openings (shards, of them with their Propose already unread in the inbox): "
          f"{_Watched.queued}")
    print(f"largest inbound backlog by replica: {_Watched.backlog}")
    print(f"ticks: {len(ticks)}, ms p50/p90/p99/max {np.percentile(ticks, [50, 90, 99]).round(2).tolist()}"
          f" / {ticks.max():.2f}")
    print("seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(spent.items(), key=lambda kv: -kv[1])))
    if prof:
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(15)
        print(buf.getvalue())


def gate_main(args) -> None:
    import torch

    import chip_smoke

    device = torch.device(args.device)
    for turn, cap in enumerate(args.gate_turns.split(",")):
        _set_cap(cap)
        gc.collect()
        t = time.perf_counter()
        try:
            g, eng = chip_smoke.planes_gate(device, 4096, 5, 3)
            del eng
            res = (f"pass; waves {[round(x, 3) for x in g['wave_s']]} s, p50 "
                   f"{g['settle_p50_s']:.3f} s, p99 {g['settle_p99_s']:.3f} s, "
                   f"{g['transport_decisions_per_s']:.1f} decisions/s")
        except AssertionError as e:
            res = f"FAIL: {str(e)[:300]}"
        print(f"turn {turn} cap {cap}: {res} ({time.perf_counter() - t:.1f} s)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=2048)
    ap.add_argument("--replicas", type=int, default=5)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--cap", default="per-shard", help='"per-shard" or a number (the reference: 256)')
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--gate-turns", default="", help="caps to run chip_smoke.planes_gate with, in turns")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.gate_turns:
        gate_main(args)
    else:
        cluster_main(args)


if __name__ == "__main__":
    main()
