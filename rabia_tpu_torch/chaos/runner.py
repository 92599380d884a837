"""Chaos scenario runner: drive a full cluster through adverse-network /
elastic-membership profiles under open-loop load, continuously recording
consensus-health telemetry.

One :func:`run_profile` call executes one :class:`~rabia_tpu_torch.chaos.
profiles.ChaosProfile`:

1. build the profile's fabric — an in-process simulator cluster
   (``fabric="sim"``) or a real-TCP gateway + native-runtime + WAL
   cluster (``fabric="tcp"``);
2. start an **open-loop Poisson load** (arrivals keep firing whether or
   not the system keeps up — a partition shows up as failed windows, not
   as a silently reduced offered rate; the r09 loadgen methodology);
3. fire the profile's timed :class:`ChaosEvent` injections;
4. sample a **continuous timeline** (~8 Hz): per-window commit
   availability (ok arrivals / offered arrivals, scored at the arrival's
   window) and per-replica decided counters — the dip during the fault
   IS the datum;
5. score the run: availability floors, a wedge check on the final
   quarter, end-state convergence, and the consensus-health evidence the
   paper's claim needs — the **phases-to-decide distribution** and
   **coin-flip tallies** pulled from the engines' telemetry (C counter
   blocks + host bins feeding the ``rabia_phases_to_decide`` /
   ``rabia_coin_flips_total`` families).

:func:`run_matrix` runs a profile dict and merges everything into one
``scenario_matrix_r12`` report (schema in docs/SCENARIOS.md), which
:func:`record_matrix` merges into a JSON file.

The port's copy of the reference's ``rabia_tpu/chaos/runner.py``, its
imports retargeted to ``rabia_tpu_torch``. Its mesh fabric runs the
one-device engine on the caller's ``device`` (CUDA unless the caller
passes another), and :func:`record_matrix` writes where its caller
says.
"""

from __future__ import annotations

import asyncio
import math
import random
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from rabia_tpu_torch.chaos.profiles import ChaosProfile
from rabia_tpu_torch.core.errors import QuorumNotAvailableError, RabiaError
from rabia_tpu_torch.core.messages import ResultStatus
from rabia_tpu_torch.core.types import CommandBatch
from rabia_tpu_torch.testing.loadsession import LoadSession

MATRIX_VERSION = 1
MATRIX_KEY = "scenario_matrix_r12"

_OUTCOMES = ("ok", "shed", "error", "timeout", "overflow")


class _Arrivals:
    """Per-arrival score sheet -> post-hoc windowed availability curve."""

    def __init__(self) -> None:
        self.rows: list[tuple[float, str, float]] = []  # (t, outcome, ms)

    def score(self, t: float, outcome: str, ms: float = 0.0) -> None:
        self.rows.append((t, outcome, ms))

    def timeline(
        self, t0: float, duration: float, window: float
    ) -> list[dict]:
        n_win = max(1, int(math.ceil(duration / window)))
        wins = [
            {"t": round(k * window, 3), "attempts": 0, "ok": 0,
             "failed": 0, "lat_ms": []}
            for k in range(n_win)
        ]
        for t, outcome, ms in self.rows:
            k = int((t - t0) / window)
            if k < 0 or k >= n_win:
                continue
            w = wins[k]
            w["attempts"] += 1
            if outcome == "ok":
                w["ok"] += 1
                w["lat_ms"].append(ms)
            else:
                w["failed"] += 1
        out = []
        for w in wins:
            lat = sorted(w.pop("lat_ms"))
            w["availability"] = (
                round(w["ok"] / w["attempts"], 4) if w["attempts"] else None
            )
            w["p99_ms"] = (
                round(lat[min(len(lat) - 1, int(0.99 * len(lat)))], 2)
                if lat
                else None
            )
            out.append(w)
        return out


# ---------------------------------------------------------------------------
# Fabrics
# ---------------------------------------------------------------------------


class _SimFabric:
    """TestCluster over the NetworkSimulator; events map to simulator
    fault-injection calls; load submits straight to the engines."""

    name = "sim"

    def __init__(self, profile: ChaosProfile) -> None:
        from rabia_tpu_torch.testing.cluster import TestCluster, default_test_config

        self.profile = profile
        self.cluster = TestCluster(
            profile.n_replicas,
            config=default_test_config(profile.n_shards),
            seed=profile.seed,
        )
        self._crashed: set[int] = set()

    async def start(self) -> None:
        await self.cluster.start()

    async def stop(self) -> None:
        await self.cluster.stop()

    def _node(self, i: int):
        return self.cluster.nodes[i]

    def apply_event(self, action: str, args: dict) -> None:
        sim = self.cluster.sim
        if action == "wan":
            base = args.get("latency_ms", 0.0) / 1000.0
            jit = args.get("jitter_ms", 0.0) / 2000.0
            sim.conditions.latency_min = max(0.0, base - jit)
            sim.conditions.latency_max = base + jit
        elif action == "link_loss":
            sim.set_link_loss(
                self._node(args["src"]), self._node(args["dst"]),
                args["rate"],
            )
        elif action == "flap":
            sim.set_flap(
                {self._node(i) for i in args["group"]},
                period=args["period"],
                duty=args.get("duty", 0.5),
                duration=args.get("duration"),
            )
        elif action == "partition":
            sim.partition(
                {self._node(i) for i in args["group"]},
                duration=args.get("duration"),
            )
        elif action == "heal":
            sim.heal_partition()
            sim.clear_flap()
        elif action == "slow":
            sim.set_node_delay(
                self._node(args["node"]), args.get("delay_ms", 0.0) / 1000.0
            )
        elif action == "crash":
            sim.crash(self._node(args["node"]))
            self._crashed.add(args["node"])
        elif action == "recover":
            sim.recover(self._node(args["node"]))
            self._crashed.discard(args["node"])
        elif action == "clear":
            sim.clear_link_faults()
            sim.conditions.latency_min = 0.0
            sim.conditions.latency_max = 0.0
        else:
            raise ValueError(f"sim fabric: unknown action {action!r}")

    def clear_faults(self) -> None:
        sim = self.cluster.sim
        sim.heal_partition()
        sim.clear_flap()
        sim.clear_link_faults()
        for i in list(self._crashed):
            sim.recover(self._node(i))
        self._crashed.clear()
        for node in self.cluster.nodes:
            sim.set_node_delay(node, 0.0)

    async def submit(self, i: int, pairs: list, timeout: float) -> str:
        """One open-loop arrival routed like an honest client: round-robin
        over replicas not currently crashed."""
        live = [
            j for j in range(self.profile.n_replicas)
            if j not in self._crashed
        ]
        if not live:
            return "shed"
        eng = self.cluster.engines[live[i % len(live)]]
        shard = i % self.profile.n_shards
        cmds = [f"SET {k} {v}" for k, v in pairs]
        try:
            fut = await eng.submit_batch(CommandBatch.new(cmds), shard=shard)
            await asyncio.wait_for(fut, timeout)
            return "ok"
        except QuorumNotAvailableError:
            return "shed"
        except asyncio.TimeoutError:
            return "timeout"
        except (RabiaError, Exception):
            return "error"

    def engines(self) -> list:
        return [e for e in self.cluster.engines if e is not None]

    def decided_totals(self) -> list[Optional[int]]:
        return [
            int(e.rt.decided_v1 + e.rt.decided_v0)
            for e in self.cluster.engines
        ]

    def watchdog_sample(self) -> dict:
        n = self.profile.n_replicas
        return {
            "members_alive": n - len(self._crashed),
            "members_total": n,
        }

    async def converged(self, timeout: float) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            datas = [
                getattr(sm, "_data", None) for sm in self.cluster.sms
            ]
            if all(d is not None for d in datas) and all(
                d == datas[0] for d in datas[1:]
            ):
                return True
            await asyncio.sleep(0.05)
        return False


class _TcpFabric:
    """GatewayCluster (real TCP, gateway + native runtime + WAL
    durability) driven through protocol-faithful LoadSessions; events map
    to the C transport's shaping layer and the elastic-membership
    surface."""

    name = "tcp"

    SESSIONS_PER_GW = 8

    def __init__(self, profile: ChaosProfile) -> None:
        from rabia_tpu_torch.gateway import GatewayConfig
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        self.profile = profile
        # profile-pinned gateway knobs (e.g. the coalescing lane's
        # window for the coalesce_flap_restart scenario)
        gw_cfg = (
            GatewayConfig(**dict(profile.gateway_overrides))
            if profile.gateway_overrides
            else None
        )
        self.cluster = GatewayCluster(
            n_replicas=profile.n_replicas,
            n_shards=profile.n_shards,
            gateway_config=gw_cfg,
            persistence="wal",
        )
        self._ser = None
        self._sessions: dict[int, list] = {}  # gw index -> LoadSession pool
        self._down: set[int] = set()
        self._redials: set[asyncio.Task] = set()

    async def start(self) -> None:
        from rabia_tpu_torch.core.serialization import Serializer

        await self.cluster.start()
        self._ser = Serializer()
        for i in range(self.profile.n_replicas):
            self._sessions[i] = await self._dial_pool(i)

    async def _dial_pool(self, i: int) -> list:
        out = []
        gw = self.cluster.gateways[i]
        if gw is None:
            return out
        for _ in range(self.SESSIONS_PER_GW):
            s = LoadSession(self._ser)
            try:
                await s.connect("127.0.0.1", gw.port)
                out.append(s)
            except Exception:
                await s.close()
        return out

    async def stop(self) -> None:
        for t in list(self._redials):
            t.cancel()
        await asyncio.gather(*self._redials, return_exceptions=True)
        for pool in self._sessions.values():
            await asyncio.gather(
                *(s.close() for s in pool), return_exceptions=True
            )
        self._sessions.clear()
        await self.cluster.stop()
        # the fabric owns the cluster's implicit mkdtemp WAL dir: remove
        # it, or every matrix/CI run litters /tmp with full WAL chains
        if self.cluster.wal_dir:
            import shutil

            shutil.rmtree(self.cluster.wal_dir, ignore_errors=True)

    # -- events -------------------------------------------------------------

    def _shape(self, src: int, dst: int, **kw) -> None:
        net = self.cluster.nets[src]
        if net is not None:
            net.set_peer_shaping(self.cluster.ids[dst], **kw)

    def apply_event(self, action: str, args: dict) -> None:
        n = self.profile.n_replicas
        if action == "wan":
            # symmetric one-way delay on every replica-to-replica link.
            # jitter_ms is the TOTAL spread on both fabrics (latency
            # +/- jitter/2 — the NetworkConditions.wan convention);
            # rt_set_shaping takes the half-amplitude, so halve here to
            # keep sim and tcp matrix cells comparable
            delay = args.get("latency_ms", 0.0)
            jit = args.get("jitter_ms", 0.0) / 2.0
            for i in range(n):
                for j in range(n):
                    if i != j:
                        self._shape(
                            i, j, delay_ms=delay, jitter_ms=jit,
                            seed=self.profile.seed + i * n + j,
                        )
        elif action == "link_loss":
            self._shape(
                args["src"], args["dst"], drop_rate=args["rate"],
                seed=self.profile.seed + 7,
            )
        elif action == "slow":
            d = args.get("delay_ms", 0.0)
            for j in range(n):
                if j != args["node"]:
                    self._shape(args["node"], j, delay_ms=d)
        elif action == "clear":
            for net in self.cluster.nets:
                if net is not None:
                    net.clear_shaping()
        elif action in ("stop_replica", "start_replica", "restart_replica"):
            # handled asynchronously by the runner (they await)
            raise RuntimeError("membership events are async — runner bug")
        else:
            raise ValueError(f"tcp fabric: unknown action {action!r}")

    async def apply_event_async(self, action: str, args: dict) -> None:
        if action == "stop_replica":
            i = args["node"]
            self._down.add(i)
            pool = self._sessions.pop(i, [])
            await asyncio.gather(
                *(s.close() for s in pool), return_exceptions=True
            )
            await self.cluster.stop_replica(i)
        elif action == "start_replica":
            i = args["node"]
            await self.cluster.start_replica(i)
            self._down.discard(i)
            self._spawn_redial(i)
        elif action == "restart_replica":
            i = args["node"]
            self._down.add(i)
            pool = self._sessions.pop(i, [])
            await asyncio.gather(
                *(s.close() for s in pool), return_exceptions=True
            )
            await self.cluster.restart_replica(i)
            self._down.discard(i)
            self._spawn_redial(i)
        else:
            self.apply_event(action, args)

    def _spawn_redial(self, i: int) -> None:
        async def redial():
            self._sessions[i] = await self._dial_pool(i)

        t = asyncio.ensure_future(redial())
        self._redials.add(t)
        t.add_done_callback(self._redials.discard)

    def clear_faults(self) -> None:
        for net in self.cluster.nets:
            if net is not None:
                net.clear_shaping()

    # -- load ---------------------------------------------------------------

    async def submit(self, i: int, pairs: list, timeout: float) -> str:
        from rabia_tpu_torch.apps.kvstore import encode_set_bin

        live = [
            j for j in range(self.profile.n_replicas)
            if j not in self._down and self._sessions.get(j)
        ]
        if not live:
            return "shed"
        pool = self._sessions[live[i % len(live)]]
        sess = pool[i % len(pool)]
        shard = i % self.profile.n_shards
        cmds = [encode_set_bin(k, v) for k, v in pairs]
        try:
            res = await sess.submit(shard, cmds, timeout)
            if res.status in (ResultStatus.OK, ResultStatus.CACHED):
                return "ok"
            if res.status == ResultStatus.RETRY:
                return "shed"
            return "error"
        except asyncio.TimeoutError:
            return "timeout"
        except Exception:
            return "error"

    def engines(self) -> list:
        return [e for e in self.cluster.engines if e is not None]

    def decided_totals(self) -> list[Optional[int]]:
        return [
            int(e.rt.decided_v1 + e.rt.decided_v0) if e is not None else None
            for e in self.cluster.engines
        ]

    def watchdog_sample(self) -> dict:
        # membership from the fabric's OWN knowledge of what it stopped
        # (deterministic — no scrape race), coalesce counters from the
        # live gateways' per-shard stats (cumulative; a restarted
        # gateway's counters reset, which a delta window just skips)
        n = self.profile.n_replicas
        waves = covered = 0
        for g in self.cluster.gateways:
            if g is None:
                continue
            for cs in getattr(g, "coal_shard_stats", {}).values():
                waves += cs["waves"]
                covered += cs["covered"]
        return {
            "members_alive": n - len(self._down),
            "members_total": n,
            "waves": waves,
            "covered": covered,
        }

    def critpath_sample(
        self, pool: int = 8, max_age_s: Optional[float] = None
    ) -> Optional[dict]:
        """Decompose the live gateways' slow exemplars in-process (zero
        alignment error) into one attribution sample: which critical-
        path segment the tail's wall time sits in RIGHT NOW. The runner
        records these at the health cadence for profiles with
        ``expect_critpath`` — the watchdog pattern applied to
        attribution instead of burn rate.

        Decomposes up to ``pool`` exemplars across the gateways (not
        just the global slowest few: a multi-second straggler whose
        ring has wrapped is honestly excluded from the aggregate, and
        taking only the top walls would leave such samples empty).

        ``max_age_s`` keeps only exemplars whose completion is at most
        that many seconds old — the recovery sample uses it so fault-era
        stragglers that legitimately finish (and therefore pin the
        slowest-first reservoir) cannot mask a healthy post-fault
        tail."""
        from rabia_tpu_torch.obs.critpath import (
            decompose,
            inprocess_exemplar_timeline,
        )

        exemplars = []
        for g in self.cluster.gateways:
            if g is None or getattr(g, "slowlog", None) is None:
                continue
            # age-filtered samples read the FULL reservoir before the
            # filter: a recovering cluster's last fault-era stragglers
            # are the slowest entries, and cutting to the per-gateway
            # top few first would evict the young exemplars the filter
            # is there to isolate
            doc = g.slowlog.document(None if max_age_s is not None
                                     else 4)
            exemplars.extend(doc.get("exemplars", []))
        if max_age_s is not None:
            exemplars = [
                e for e in exemplars
                if float(e.get("age_s", 0.0)) <= max_age_s
            ]
        if not exemplars:
            return None
        exemplars.sort(key=lambda e: -float(e.get("wall_s", 0.0)))
        exemplars = exemplars[:pool]
        engines = [e for e in self.cluster.engines if e is not None]
        # each engine's rings read once for the whole sample: a read
        # rebuilds tens of thousands of events, and one a slice (the
        # reference) held this loop for seconds at the health cadence,
        # starving the arrivals the sample is meant to observe
        events = [e.flight_events() for e in engines]
        seg_tot: dict[str, float] = {}
        n_ok = n_trunc = n_bad = 0
        for ex in exemplars:
            try:
                merged = inprocess_exemplar_timeline(
                    engines, ex, events=events
                )
                d = decompose(
                    merged,
                    coalesced=ex.get("coalesced"),
                    wall_s=ex.get("wall_s"),
                )
            except Exception:
                n_bad += 1
                continue
            if not d["ok"]:
                n_bad += 1
                continue
            if d["truncated"]:
                n_trunc += 1
                continue
            n_ok += 1
            for k, v in d["segments"].items():
                seg_tot[k] = seg_tot.get(k, 0.0) + v
            seg_tot["unattributed"] = (
                seg_tot.get("unattributed", 0.0) + d["unattributed_s"]
            )
        out = {
            "exemplars": n_ok,
            "truncated": n_trunc,
            "unanchored": n_bad,
            "worst_ms": round(
                float(exemplars[0].get("wall_s", 0.0)) * 1e3, 3
            ),
        }
        if n_ok:
            out["dominant"] = max(
                seg_tot.items(), key=lambda kv: kv[1]
            )[0]
            out["segments_ms"] = {
                k: round(v / n_ok * 1e3, 3)
                for k, v in sorted(seg_tot.items())
            }
        return out

    async def converged(self, timeout: float) -> bool:
        try:
            await self.cluster.wait_converged(timeout)
            return True
        except Exception as e:
            # the divergence detail (per-replica checksums/versions/
            # frontiers) is the evidence a failing matrix row needs
            print(f"# convergence failure: {e}", file=sys.stderr)
            return False


class _FleetFabric:
    """Routed fleet (round 16): a real-TCP replica cluster behind
    consistent-hash-routed fleet gateways
    (:class:`~rabia_tpu_torch.fleet.harness.FleetHarness`), driven by
    MOVED-following :class:`~rabia_tpu_torch.fleet.harness.FleetSession`
    clients over shared mux connections. Events add ``kill_gateway``
    (abrupt death, no handoff — survivors adopt the shrunken ring) and
    ``rebalance`` (planned drain with session handoff). The post-run
    :meth:`verify` hook is the scenario's exactly-once gate: every
    session's last ACKED result must replay byte-identical wherever
    the ring routes it now, with zero store mutation."""

    name = "fleet"

    N_SESSIONS = 24

    def __init__(self, profile: ChaosProfile) -> None:
        from rabia_tpu_torch.fleet.harness import FleetHarness
        from rabia_tpu_torch.gateway import GatewayConfig

        self.profile = profile
        gw_cfg = (
            GatewayConfig(**dict(profile.gateway_overrides))
            if profile.gateway_overrides
            else None
        )
        self.harness = FleetHarness(
            n_gateways=profile.n_gateways,
            n_replicas=profile.n_replicas,
            n_shards=profile.n_shards,
            persistence="wal",
            gateway_config=gw_cfg,
        )
        self._sessions: list = []
        self._pool = None
        # per session: (seq, shard, payload bytes) of the LAST acked
        # submit — the verify() replay sample (newest seq per session
        # is never GC-eligible under its own ack frontier)
        self._last_acked: dict[int, tuple] = {}

    async def start(self) -> None:
        from rabia_tpu_torch.fleet.harness import FleetConnPool, FleetSession

        await self.harness.start()
        self._pool = FleetConnPool(self.harness.ser)
        resolver = self.harness.resolver()
        self._sessions = [
            FleetSession(
                self.harness.ser, resolver, pool=self._pool,
                call_timeout=min(5.0, self.profile.call_timeout),
            )
            for _ in range(self.N_SESSIONS)
        ]

    async def stop(self) -> None:
        for s in self._sessions:
            await s.close()
        self._sessions = []
        if self._pool is not None:
            await self._pool.close()
        await self.harness.stop()
        if self.harness.cluster.wal_dir:
            import shutil

            shutil.rmtree(self.harness.cluster.wal_dir, ignore_errors=True)

    # -- events -------------------------------------------------------------

    def apply_event(self, action: str, args: dict) -> None:
        if action == "clear":
            return
        if action in ("kill_gateway", "rebalance"):
            raise RuntimeError("fleet events are async — runner bug")
        raise ValueError(f"fleet fabric: unknown action {action!r}")

    async def apply_event_async(self, action: str, args: dict) -> None:
        if action == "kill_gateway":
            await self.harness.kill_gateway(args["gw"])
        elif action == "rebalance":
            await self.harness.rebalance(args["members"])
        else:
            self.apply_event(action, args)

    def clear_faults(self) -> None:
        pass

    # -- load ---------------------------------------------------------------

    async def submit(self, i: int, pairs: list, timeout: float) -> str:
        from rabia_tpu_torch.apps.kvstore import encode_set_bin

        si = i % len(self._sessions)
        sess = self._sessions[si]
        shard = i % self.profile.n_shards
        cmds = [encode_set_bin(k, v) for k, v in pairs]
        try:
            res = await sess.submit(shard, cmds, timeout=timeout)
        except (asyncio.TimeoutError, TimeoutError):
            return "timeout"
        except Exception:
            return "error"
        if res.status in (ResultStatus.OK, ResultStatus.CACHED):
            self._last_acked[si] = (
                res.seq, shard, tuple(bytes(p) for p in res.payload)
            )
            return "ok"
        if res.status == ResultStatus.RETRY:
            return "shed"
        return "error"

    # -- scoring ------------------------------------------------------------

    async def verify(self) -> list[str]:
        """The routed-failover acceptance gates: zero lost acked
        Results (byte-identical replays through the post-fault ring)
        and zero double-applies (store mutation parity across the
        replay sweep)."""
        from rabia_tpu_torch.apps.kvstore import encode_set_bin

        problems: list[str] = []
        if not self._last_acked:
            return ["fleet verify: no acked submits to replay"]

        def versions():
            return [
                [
                    self.harness.cluster.store(r, s).version
                    for s in range(self.profile.n_shards)
                ]
                for r in range(self.profile.n_replicas)
            ]

        before = versions()
        lost = 0
        for si in sorted(self._last_acked):
            seq, shard, want = self._last_acked[si]
            try:
                res = await self._sessions[si].submit_seq(
                    seq, shard,
                    [encode_set_bin("verify-replay", "X")],
                    timeout=15.0,
                )
            except Exception as e:
                problems.append(
                    f"fleet verify: replay session {si} seq {seq} "
                    f"failed: {e}"
                )
                continue
            if tuple(bytes(p) for p in res.payload) != want:
                lost += 1
        if lost:
            problems.append(
                f"fleet verify: {lost} acked result(s) replayed "
                "non-identical — exactly-once broken"
            )
        await asyncio.sleep(0.3)
        if versions() != before:
            problems.append(
                "fleet verify: replays mutated replica state — "
                "double apply"
            )
        return problems

    def engines(self) -> list:
        return [
            e for e in self.harness.cluster.engines if e is not None
        ]

    def decided_totals(self) -> list[Optional[int]]:
        return [
            int(e.rt.decided_v1 + e.rt.decided_v0) if e is not None else None
            for e in self.harness.cluster.engines
        ]

    def watchdog_sample(self) -> dict:
        # members = the ROUTING tier (a killed fleet gateway is what
        # ring_stale names here); coalesce counters come from the
        # replica-cluster gateways that actually pack the waves
        waves = covered = 0
        for g in self.harness.cluster.gateways:
            if g is None:
                continue
            for cs in getattr(g, "coal_shard_stats", {}).values():
                waves += cs["waves"]
                covered += cs["covered"]
        return {
            "members_alive": len(self.harness.live_indices()),
            "members_total": self.profile.n_gateways,
            "waves": waves,
            "covered": covered,
        }

    async def converged(self, timeout: float) -> bool:
        try:
            await self.harness.cluster.wait_converged(timeout)
            return True
        except Exception as e:
            print(f"# convergence failure: {e}", file=sys.stderr)
            return False


class _MeshFabric:
    """MeshEngine colocated-lockstep fabric: the whole cluster is ONE
    in-process device engine (``n_replicas`` lockstep replicas on one
    device) with the device-resident KV table AND the read-index
    lane on. Load is full-width PayloadBlocks — a SET wave or (every
    third arrival) a GET wave that the read lane must serve from
    consensus-free ``lookup_only`` probe windows. Events map to the
    alive-mask (``crash``/``recover``) and to forced device-lane
    demotion (``demote_device``): parked probe reads must flush to the
    consensus path, and the auto-repromote must re-engage the lane —
    with correct write barriers — while arrivals keep firing.

    The engine runs over ``mesh``, as the reference's runs over
    ``make_mesh()``; by default a 1 x 1 mesh of ``device`` (CUDA unless
    the caller passes another). Over a mesh of several shard blocks the
    device table is cut in blocks and each window launches once a block."""

    name = "mesh"

    # the runner's keys: k{i % 512}-{j} an arrival, warm{0..63}-{j} in
    # the warmup (and the start's "warm")
    KEY_SPACE = 512
    WARM_KEYS = 64

    def __init__(self, profile: ChaosProfile, device=None, mesh=None) -> None:
        from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
        from rabia_tpu_torch.core.device import resolve_device
        from rabia_tpu_torch.parallel import MeshEngine, make_mesh

        self.profile = profile
        n_shards = profile.n_shards
        self.eng = MeshEngine(
            lambda: VectorShardedKV(n_shards, capacity=1 << 14),
            n_shards=n_shards,
            n_replicas=profile.n_replicas,
            mesh=make_mesh([resolve_device(device)]) if mesh is None else mesh,
            window=8,
            device_store=True,
            # a device table that holds every key the fabric writes: a
            # shard sees up to KEY_SPACE keys an op of the batch, plus
            # the warmup's. The reference keeps the table's default 64
            # slots a shard, so its lane overflows about 1.4 s into a
            # run and can never re-promote (ROADMAP Queue 3)
            device_store_kw={
                "per_shard_capacity": self.KEY_SPACE * profile.batch
                + self.WARM_KEYS + 1
            },
            device_read_lane=True,
            # small repromote horizon so a mid-run demote_device event
            # re-engages the lane INSIDE the measure window (the
            # barrier-reset path is part of what this fabric scores)
            device_store_repromote=24,
        )
        self._crashed: set[int] = set()
        self._pump_task: Optional[asyncio.Task] = None
        self._running = False
        # the device lane's transitions, seen after every cycle and
        # event, for the report (summary())
        self._lane_was_active = self.eng.device_lane_active
        self.lane_demotions = 0
        self.lane_promotions = 0
        self._forced_demotions = 0
        # the seconds of each call that moved the lane: the event loop is
        # held that long (a demotion rebuilds the host stores, a
        # re-promotion the device table)
        self.lane_transition_s: list[tuple[str, float]] = []

    def _note_lane(self, held_s: float) -> None:
        active = self.eng.device_lane_active
        if active != self._lane_was_active:
            if active:
                self.lane_promotions += 1
            else:
                self.lane_demotions += 1
            self.lane_transition_s.append(
                ("promote" if active else "demote", round(held_s, 4))
            )
            self._lane_was_active = active

    def _blocks(self, idx: int, pairs: list):
        """One full-width wave per arrival: SET waves carry the runner's
        key/value pairs fanned across shards; every third arrival is a
        GET wave on the j=0 keys an earlier same-slot SET wrote."""
        from rabia_tpu_torch.apps.kvstore import (
            KVOperation,
            KVOpType,
            encode_op_bin,
            encode_set_bin,
        )
        from rabia_tpu_torch.core.blocks import build_block

        shards = list(range(self.profile.n_shards))
        if idx % 3 == 0:
            cmds = [
                [encode_op_bin(
                    KVOperation(KVOpType.Get, f"k{idx % 512}-0-{s}")
                )]
                for s in shards
            ]
        else:
            cmds = [
                [encode_set_bin(f"{k}-{s}", v) for k, v in pairs]
                for s in shards
            ]
        return build_block(shards, cmds)

    async def start(self) -> None:
        # pin every program compile (SET wave, GET wave, lookup_only
        # probe) OUTSIDE the measured window
        self.eng.submit_block(self._blocks(1, [("warm", "w")]))
        self.eng.submit_block(self._blocks(0, [("warm", "w")]))
        self.eng.flush(max_cycles=400)
        self._running = True
        self._pump_task = asyncio.ensure_future(self._pump())

    async def _pump(self) -> None:
        # the engine is synchronous: one background task turns cycles
        # whenever work is pending, yielding between cycles so the
        # arrival generator and event injections interleave honestly
        while self._running:
            t0 = time.perf_counter()
            got = self.eng.run_cycle()
            self._note_lane(time.perf_counter() - t0)
            await asyncio.sleep(0.0 if got else 0.002)

    async def stop(self) -> None:
        self._running = False
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except (asyncio.CancelledError, Exception):
                pass
        self.eng.close()

    def apply_event(self, action: str, args: dict) -> None:
        eng = self.eng
        if action == "crash":
            eng.crash_replica(args["node"])
            self._crashed.add(args["node"])
        elif action == "recover":
            eng.heal_replica(args["node"])
            self._crashed.discard(args["node"])
        elif action == "demote_device":
            # forced mid-window demotion: the device table syncs to the
            # host replica stores, parked probe reads flush back into
            # the consensus stream, and (repromote horizon permitting)
            # the lane re-engages with reset write barriers
            t0 = time.perf_counter()
            if eng._dev_active:
                eng._demote_device_store()
                self._forced_demotions += 1
            self._note_lane(time.perf_counter() - t0)
        elif action == "clear":
            for r in list(self._crashed):
                eng.heal_replica(r)
            self._crashed.clear()
        else:
            raise ValueError(f"mesh fabric: unknown action {action!r}")

    def clear_faults(self) -> None:
        for r in list(self._crashed):
            self.eng.heal_replica(r)
        self._crashed.clear()

    async def submit(self, i: int, pairs: list, timeout: float) -> str:
        eng = self.eng
        if not eng.has_quorum:
            return "shed"
        try:
            bfut = eng.submit_block(self._blocks(i, pairs))
        except Exception:
            return "error"
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while not bfut.done():
            if loop.time() >= deadline:
                return "timeout"
            await asyncio.sleep(0.001)
        return "ok"

    async def verify(self) -> list[str]:
        """Mesh acceptance gates: the read lane actually engaged (probe
        reads > 0 — a run whose GETs all fell back to consensus slots
        is a silent regression of the tier under test) and the lockstep
        replicas never diverged on an apply outcome."""
        problems: list[str] = []
        rl = self.eng.read_lane_stats()
        if rl["probe"] <= 0:
            problems.append(
                "mesh verify: read lane served zero off-consensus "
                f"probe reads (stats {rl})"
            )
        if int(self.eng.divergences) != 0:
            problems.append(
                f"mesh verify: {self.eng.divergences} lockstep apply "
                "divergences"
            )
        return problems

    def summary(self) -> dict:
        """What the verify sweep read, for the report, with the most keys
        a shard holds in replica 0's store beside the device table's
        slots a shard (a lane re-promotes only onto a table that holds
        every key)."""
        st = self.eng.sms[0].store
        used = st.shard_col[st.state == 1]
        keys = np.bincount(used, minlength=self.eng.n_shards)
        return {
            "read_lane": self.eng.read_lane_stats(),
            "divergences": int(self.eng.divergences),
            "forced_demotions": self._forced_demotions,
            "lane_demotions": self.lane_demotions,
            "lane_promotions": self.lane_promotions,
            "lane_transition_s": self.lane_transition_s,
            "keys_per_shard_max": int(keys.max(initial=0)),
            "device_table_slots": int(self.eng._dev.P),
            "device": str(self.eng.device),
            "mesh": [self.eng.mesh.shape["shard"], self.eng.mesh.shape["replica"]],
        }

    def engines(self) -> list:
        return [self.eng]

    def decided_totals(self) -> list[Optional[int]]:
        return [int(self.eng.decided_v1 + self.eng.decided_v0)]

    def watchdog_sample(self) -> dict:
        n = self.profile.n_replicas
        return {
            "members_alive": n - len(self._crashed),
            "members_total": n,
        }

    async def converged(self, timeout: float) -> bool:
        eng = self.eng
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not eng._has_pending():
                break
            await asyncio.sleep(0.02)
        else:
            return False
        if eng._dev_active:
            eng.sync_to_host()  # device table down into every replica
        from rabia_tpu_torch.apps.vector_kv import VectorKVStore

        def canon(sm):
            # logical content only: snapshot bytes embed per-store
            # wall-clock created/updated stamps that legitimately differ
            sv, rows, over = VectorKVStore._parse_snapshot(
                sm.store.snapshot_bytes()
            )
            shards, keys, vals, vers, _cr, _up = rows
            return (
                sv.tolist(), shards, keys, vals, vers,
                sorted(
                    (d["shard"], d["key"], d["value"], d["version"])
                    for d in over
                ),
            )

        snaps = [canon(sm) for sm in eng.sms]
        return all(s == snaps[0] for s in snaps[1:])


class _GroupFabric:
    """Partitioned shard-group fabric (round 20, fleet/groups.py): N
    independent consensus groups, each a real OS-process replica set
    (:class:`~rabia_tpu_torch.fleet.groups.GroupProcHarness` — durable WAL
    children, SIGKILL-able) under its own WAL subtree. Sessions are
    group-routed client-side: every arrival's home shard maps through
    the :class:`~rabia_tpu_torch.fleet.groups.GroupMap` to its owning group,
    and the session dials that group's preferred ("proposer") replica
    gateway, failing over INSIDE the group when it dies. Events add
    ``kill_group_proposer`` (SIGKILL — no graceful anything) and
    ``restart_group_proposer`` (respawn + WAL recovery). Scoring adds
    the blast-radius gate: the NON-killed groups' goodput during the
    kill window must hold against their own healthy control band, and
    the post-run :meth:`verify` replays every session's last acked seq
    through a DIFFERENT replica gateway of its group (byte-identical,
    zero applied-frontier movement = exactly-once held per group).

    Everything observed cross-process comes from the replica gateways'
    admin plane (METRICS scrape) — there are no in-process engines, so
    the fabric carries its own scrape-based evidence collector."""

    name = "groups"

    SESSIONS_PER_LANE = 6

    def __init__(self, profile: ChaosProfile) -> None:
        from rabia_tpu_torch.fleet.groups import GroupMap, GroupProcHarness

        self.profile = profile
        self.group_map = GroupMap.initial(
            profile.n_shards, profile.n_groups
        )
        self.harness = GroupProcHarness(
            self.group_map, n_replicas=profile.n_replicas
        )
        self._ser = None
        # (group, replica) -> LoadSession pool; sessions prefer the
        # lowest live replica index of their group (the "proposer")
        self._sessions: dict[tuple[int, int], list] = {}
        self._down: set[tuple[int, int]] = set()
        self._redials: set[asyncio.Task] = set()
        # last acked submit per session: client_id -> (group, replica,
        # seq, shard, payload) — the verify() replay sample
        self._last_acked: dict = {}
        # per-group goodput rows (arrival wall time, group, outcome)
        # and the kill/restart edges, for the blast-radius gate
        self._group_rows: list[tuple[float, int, str]] = []
        self._kill_edges: dict[int, list[float]] = {}
        self._scrape_task: Optional[asyncio.Task] = None
        self._decided_cache: dict[tuple[int, int], Optional[int]] = {}
        self._running = False

    async def start(self) -> None:
        from rabia_tpu_torch.core.serialization import Serializer

        loop = asyncio.get_event_loop()
        await loop.run_in_executor(None, self.harness.start)
        self._ser = Serializer()
        for g in self.group_map.groups():
            for r in range(self.profile.n_replicas):
                self._sessions[(g, r)] = await self._dial_pool(g, r)
        self._running = True
        self._scrape_task = asyncio.ensure_future(self._scrape_loop())

    async def _dial_pool(self, g: int, r: int) -> list:
        port = self.harness.harnesses[g].gw_ports[r]
        out = []
        for _ in range(self.SESSIONS_PER_LANE):
            s = LoadSession(self._ser)
            try:
                await s.connect("127.0.0.1", port)
                out.append(s)
            except Exception:
                await s.close()
        return out

    async def stop(self) -> None:
        self._running = False
        if self._scrape_task is not None:
            self._scrape_task.cancel()
            try:
                await self._scrape_task
            except (asyncio.CancelledError, Exception):
                pass
        for t in list(self._redials):
            t.cancel()
        await asyncio.gather(*self._redials, return_exceptions=True)
        for pool in self._sessions.values():
            await asyncio.gather(
                *(s.close() for s in pool), return_exceptions=True
            )
        self._sessions.clear()
        self.harness.stop()
        import shutil

        shutil.rmtree(self.harness.wal_root, ignore_errors=True)

    # -- admin-plane scraping ----------------------------------------------

    def _live(self, g: int, r: int) -> bool:
        rp = self.harness.harnesses[g].procs[r]
        return (
            (g, r) not in self._down
            and rp is not None
            and rp.proc.poll() is None
        )

    async def _scrape_metrics(
        self, g: int, r: int, timeout: float = 3.0
    ) -> Optional[dict]:
        from rabia_tpu_torch.core.messages import AdminKind
        from rabia_tpu_torch.gateway.client import admin_fetch
        from rabia_tpu_torch.obs.registry import parse_prometheus_text

        if not self._live(g, r):
            return None
        port = self.harness.harnesses[g].gw_ports[r]
        try:
            body = await admin_fetch(
                "127.0.0.1", port, kind=int(AdminKind.METRICS),
                timeout=timeout,
            )
            return parse_prometheus_text(body.decode(errors="replace"))
        except Exception:
            return None

    async def _scrape_loop(self) -> None:
        """Background decided-counter cache: ``decided_totals`` is
        called synchronously at the health cadence, and a cross-process
        fabric cannot afford a blocking scrape there."""
        keys = [
            (g, r)
            for g in self.group_map.groups()
            for r in range(self.profile.n_replicas)
        ]
        while self._running:
            for g, r in keys:
                mm = await self._scrape_metrics(g, r, timeout=2.0)
                if mm is None:
                    self._decided_cache[(g, r)] = None
                    continue
                self._decided_cache[(g, r)] = int(
                    mm.get('rabia_engine_decided_total{value="v0"}', 0)
                    + mm.get('rabia_engine_decided_total{value="v1"}', 0)
                )
            await asyncio.sleep(0.3)

    # -- events -------------------------------------------------------------

    def apply_event(self, action: str, args: dict) -> None:
        if action == "clear":
            return
        if action in ("kill_group_proposer", "restart_group_proposer"):
            raise RuntimeError("group events are async — runner bug")
        raise ValueError(f"groups fabric: unknown action {action!r}")

    async def apply_event_async(self, action: str, args: dict) -> None:
        loop = asyncio.get_event_loop()
        if action == "kill_group_proposer":
            g = args["group"]
            self._down.add((g, 0))
            self._kill_edges.setdefault(g, []).append(loop.time())
            pool = self._sessions.pop((g, 0), [])
            await loop.run_in_executor(
                None, self.harness.kill9, g, 0
            )
            await asyncio.gather(
                *(s.close() for s in pool), return_exceptions=True
            )
        elif action == "restart_group_proposer":
            g = args["group"]
            await loop.run_in_executor(
                None, self.harness.restart, g, 0
            )
            self._down.discard((g, 0))
            self._kill_edges.setdefault(g, []).append(loop.time())

            async def redial(g=g):
                self._sessions[(g, 0)] = await self._dial_pool(g, 0)

            t = asyncio.ensure_future(redial())
            self._redials.add(t)
            t.add_done_callback(self._redials.discard)
        else:
            self.apply_event(action, args)

    def clear_faults(self) -> None:
        pass

    # -- load ---------------------------------------------------------------

    async def submit(self, i: int, pairs: list, timeout: float) -> str:
        from rabia_tpu_torch.apps.kvstore import encode_set_bin

        shard = i % self.profile.n_shards
        g = self.group_map.group_of(shard)
        arrived = asyncio.get_event_loop().time()
        live = [
            r for r in range(self.profile.n_replicas)
            if self._live(g, r) and self._sessions.get((g, r))
        ]
        if not live:
            self._group_rows.append((arrived, g, "shed"))
            return "shed"
        pool = self._sessions[(g, live[0])]
        sess = pool[i % len(pool)]
        cmds = [encode_set_bin(k, v) for k, v in pairs]
        try:
            res = await sess.submit(shard, cmds, timeout)
        except asyncio.TimeoutError:
            self._group_rows.append((arrived, g, "timeout"))
            return "timeout"
        except Exception:
            self._group_rows.append((arrived, g, "error"))
            return "error"
        if res.status in (ResultStatus.OK, ResultStatus.CACHED):
            self._last_acked[sess.client_id] = (
                g, live[0], res.seq, shard,
                tuple(bytes(p) for p in res.payload),
            )
            self._group_rows.append((arrived, g, "ok"))
            return "ok"
        self._group_rows.append((arrived, g, "shed"))
        if res.status == ResultStatus.RETRY:
            return "shed"
        return "error"

    # -- scoring ------------------------------------------------------------

    def _blast_radius_problems(self) -> list[str]:
        """The isolation gate: for every group that was NOT killed, its
        goodput during another group's kill window must hold against
        its OWN healthy control (the equal-length window just before
        the kill). Allows a 50% dip — a 1-core host legitimately bleeds
        some CPU into the victim's WAL recovery — but a partitioned
        tier whose healthy groups halt with the victim is a failed
        isolation story."""
        problems: list[str] = []
        for victim, edges in self._kill_edges.items():
            kill_t = edges[0]
            end_t = edges[1] if len(edges) > 1 else max(
                (t for t, _g, _o in self._group_rows), default=kill_t
            )
            span = end_t - kill_t
            if span <= 0:
                continue
            for g in self.group_map.groups():
                if g == victim:
                    continue

                def avail(lo: float, hi: float, g=g) -> tuple:
                    att = ok = 0
                    for t, gg, o in self._group_rows:
                        if gg == g and lo <= t < hi:
                            att += 1
                            ok += o == "ok"
                    return (ok / att if att else None), att

                ctrl, ctrl_n = avail(kill_t - span, kill_t)
                fault, fault_n = avail(kill_t, end_t)
                if ctrl is None or fault is None:
                    problems.append(
                        f"blast radius: group {g} has no arrivals to "
                        f"score around group {victim}'s kill window"
                    )
                    continue
                if fault < 0.5 * ctrl:
                    problems.append(
                        f"blast radius: group {g} goodput fell to "
                        f"{fault:.3f} (n={fault_n}) during group "
                        f"{victim}'s kill window vs healthy control "
                        f"{ctrl:.3f} (n={ctrl_n}) — isolation broken"
                    )
        return problems

    async def verify(self) -> list[str]:
        """Per-group exactly-once sweep: every session's last ACKED seq
        re-submitted through a DIFFERENT replica gateway of the SAME
        group must answer byte-identical (the engine ledger's replay
        lane), and the sweep must move no group's applied frontier
        (a moved frontier = a replay consumed a real slot = double
        apply)."""
        problems = self._blast_radius_problems()
        if not self._last_acked:
            return problems + ["groups verify: no acked submits to replay"]
        from rabia_tpu_torch.apps.kvstore import encode_set_bin

        async def frontier() -> dict:
            out = {}
            for g in self.group_map.groups():
                for r in range(self.profile.n_replicas):
                    mm = await self._scrape_metrics(g, r)
                    out[(g, r)] = (
                        None if mm is None else
                        int(mm.get("rabia_engine_applied_slots_total", 0))
                    )
            return out

        before = await frontier()
        lost = 0
        identical = 0
        aged = 0
        for cid, (g, r_used, seq, shard, want) in sorted(
            self._last_acked.items(), key=lambda kv: str(kv[0])
        ):
            others = [
                r for r in range(self.profile.n_replicas)
                if r != r_used and self._live(g, r)
            ]
            if not others:
                problems.append(
                    f"groups verify: group {g} has no OTHER live "
                    "replica to replay against"
                )
                continue
            s = LoadSession(self._ser, client_id=cid)
            try:
                await s.connect(
                    "127.0.0.1",
                    self.harness.harnesses[g].gw_ports[others[0]],
                )
                # replay at the ORIGINAL arity: the ledger-replay lane
                # narrows an over-long recorded response list to the
                # replayed command count (it must never widen), so a
                # 1-command probe of a 4-command batch would read as a
                # truncated — hence "lost" — payload
                res = await s.submit_seq(
                    seq, shard,
                    [encode_set_bin("verify-replay", "X")] * len(want),
                    timeout=15.0,
                )
                got = tuple(bytes(p) for p in res.payload)
                if res.status in (
                    ResultStatus.OK, ResultStatus.CACHED
                ) and got == want:
                    identical += 1
                elif (
                    res.status == ResultStatus.ERROR
                    and got
                    and b"committed but responses unavailable" in got[0]
                ):
                    # the HONEST terminal for an aged replay: the engine
                    # dedups forever on applied_ids/alias_ledger, but
                    # applied_results is a BOUNDED response cache — an
                    # old seq's recorded slice can evict cluster-wide,
                    # and the replay then gets this marker instead of a
                    # fabricated answer. Exactly-once still holds: the
                    # frontier check below proves no slot was consumed.
                    aged += 1
                else:
                    lost += 1
                    if lost <= 4:
                        problems.append(
                            f"groups verify detail: group {g} shard "
                            f"{shard} seq {seq} via r{others[0]} "
                            f"status={ResultStatus(res.status).name} "
                            f"want={len(want)}x{[w[:24] for w in want[:2]]}"
                            f" got={len(got)}x{[b[:24] for b in got[:2]]}"
                        )
            except Exception as e:
                problems.append(
                    f"groups verify: replay of group {g} session "
                    f"seq {seq} failed: {e}"
                )
            finally:
                await s.close()
        if lost:
            problems.append(
                f"groups verify: {lost} acked result(s) replayed "
                "non-identical — exactly-once broken"
            )
        if not identical:
            # all-aged (or all-errored) would make the byte-identity leg
            # vacuous: demand at least one replay actually round-tripped
            problems.append(
                "groups verify: no replay came back byte-identical "
                f"(identical=0 aged={aged} lost={lost})"
            )
        await asyncio.sleep(0.3)
        after = await frontier()
        moved = {
            k: (before[k], after[k])
            for k in before
            if before[k] is not None
            and after[k] is not None
            and after[k] != before[k]
        }
        if moved:
            problems.append(
                "groups verify: replay sweep moved applied frontiers "
                f"{moved} — double apply"
            )
        return problems

    def engines(self) -> list:
        return []  # cross-process: evidence comes from collect_evidence

    async def collect_evidence(self) -> dict:
        """Scrape-based termination evidence: rebuild the per-replica
        phases-to-decide bucket counts from the Prometheus exposition
        (cumulative ``le`` buckets diffed back to per-phase bins) and
        the coin tallies, then fold into the shared report schema."""
        hist = np.zeros(32, np.int64)
        total = 0
        ssum = 0.0
        coins = {"v0": 0, "v1": 0}
        pref = 'rabia_phases_to_decide_bucket{le="'
        for g in self.group_map.groups():
            for r in range(self.profile.n_replicas):
                mm = await self._scrape_metrics(g, r)
                if mm is None:
                    continue
                rows = []
                for k, v in mm.items():
                    if k.startswith(pref) and not k.endswith('+Inf"}'):
                        rows.append((float(k[len(pref):-2]), v))
                rows.sort()
                prev = 0.0
                for le, cum in rows:
                    c = int(cum - prev)
                    prev = cum
                    if c > 0:
                        hist[min(int(le), 31)] += c
                total += int(mm.get("rabia_phases_to_decide_count", 0))
                ssum += float(mm.get("rabia_phases_to_decide_sum", 0.0))
                for k in ("v0", "v1"):
                    coins[k] += int(
                        mm.get(
                            f'rabia_coin_flips_total{{outcome="{k}"}}', 0
                        )
                    )
        return _evidence_report(hist, total, ssum, coins)

    def decided_totals(self) -> list[Optional[int]]:
        return [
            self._decided_cache.get((g, r))
            for g in self.group_map.groups()
            for r in range(self.profile.n_replicas)
        ]

    def watchdog_sample(self) -> dict:
        alive = self.harness.alive()
        return {
            "members_alive": sum(alive.values()),
            "members_total": (
                self.profile.n_groups * self.profile.n_replicas
            ),
        }

    async def converged(self, timeout: float) -> bool:
        """Frontier convergence per group: every live replica of a
        group reports the SAME applied-slot frontier, stable across two
        scrapes. (Byte-level store parity is out of reach across
        process boundaries — the verify() replay sweep is what gates
        payload correctness.)"""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        last = None
        while loop.time() < deadline:
            snap = {}
            flat = True
            for g in self.group_map.groups():
                vals = []
                for r in range(self.profile.n_replicas):
                    mm = await self._scrape_metrics(g, r)
                    if mm is not None:
                        vals.append(
                            int(mm.get(
                                "rabia_engine_applied_slots_total", 0
                            ))
                        )
                snap[g] = vals
                if len(vals) < 2 or len(set(vals)) != 1:
                    flat = False
            if flat and snap == last:
                return True
            last = snap if flat else None
            await asyncio.sleep(0.4)
        print(
            f"# groups convergence failure: frontiers {last}",
            file=sys.stderr,
        )
        return False


# ---------------------------------------------------------------------------
# Consensus-health evidence
# ---------------------------------------------------------------------------


def _evidence_report(
    hist: np.ndarray, total: int, ssum: float, coins: dict
) -> dict:
    """Fold an aggregated phases-to-decide histogram into the matrix
    evidence schema (shared by the in-process and scrape-based
    collectors)."""
    nz = np.nonzero(hist)[0]
    dist = {str(int(p)): int(hist[p]) for p in nz}
    cum = np.cumsum(hist)

    def pct(q: float) -> Optional[int]:
        if total == 0:
            return None
        tgt = q * total
        for p in range(len(hist)):
            if cum[p] >= tgt:
                return int(p)
        return int(len(hist) - 1)

    return {
        "decisions": total,
        "hist": dist,
        "mean_phases": round(ssum / total, 4) if total else None,
        "p50_phases": pct(0.50),
        "p99_phases": pct(0.99),
        "max_phases": int(nz[-1]) if len(nz) else None,
        "coin_flips": coins,
    }


def collect_evidence(engines: list) -> dict:
    """Aggregate the termination-analysis evidence across replicas: the
    phases-to-decide distribution (rabia_phases_to_decide sources — C
    tick-context bins + host kernel bins + device-window bins) and the
    common-coin outcome tallies."""
    hist = np.zeros(32, np.int64)
    total = 0
    ssum = 0.0
    coins = {"v0": 0, "v1": 0}
    for eng in engines:
        try:
            h = eng.metrics.histogram("phases_to_decide")
            counts, count, s = h.merged()
            for j, c in enumerate(counts):
                hist[min(j + 1, 31)] += int(c)
            total += int(count)
            ssum += float(s)
            for k in ("v0", "v1"):
                coins[k] += int(
                    eng.metrics.counter(
                        "coin_flips_total", labels={"outcome": k}
                    ).value()
                )
        except Exception:
            continue
    return _evidence_report(hist, total, ssum, coins)


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


async def run_profile(
    profile: ChaosProfile, verbose: bool = True, *, device=None, mesh=None
) -> dict:
    """Execute one profile end-to-end; returns its scenario report (the
    matrix entry — schema in docs/SCENARIOS.md). ``device`` is where the
    mesh fabric's engine runs (CUDA unless the caller passes another), or
    ``mesh`` the mesh it runs over (default a 1 x 1 mesh of ``device``)."""

    def log(msg: str) -> None:
        if verbose:
            print(f"# [{profile.name}] {msg}", file=sys.stderr)

    if profile.fabric == "mesh":
        fabric = _MeshFabric(profile, device=device, mesh=mesh)
    else:
        fabric = {
            "sim": _SimFabric, "tcp": _TcpFabric, "fleet": _FleetFabric,
            "groups": _GroupFabric,
        }[profile.fabric](profile)
    log(f"starting {profile.fabric} cluster "
        f"({profile.n_replicas} replicas, {profile.n_shards} shards)")
    await fabric.start()
    arrivals = _Arrivals()
    health_rows: list[dict] = []
    rng = random.Random(profile.seed)
    loop = asyncio.get_event_loop()
    fires: set[asyncio.Task] = set()
    inflight = 0
    inflight_cap = max(64, int(profile.rate * profile.call_timeout * 2))
    window = max(0.2, profile.duration / 32.0)

    # SLO burn-rate watchdog (obs/fleet_obs.py): fed cumulative counters
    # at the health cadence — outcome totals from the arrival score
    # sheet, membership + coalesce counters from the fabric's own
    # knowledge (no scrape race). Profiles with ``expect_watchdog`` gate
    # on the verdict; everyone else carries it as report evidence.
    from rabia_tpu_torch.obs.fleet_obs import BurnRateWatchdog, SLOPolicy

    watchdog = BurnRateWatchdog(
        SLOPolicy(
            fast_window_s=2.0 * window,
            slow_window_s=8.0 * window,
        )
    )

    def wd_observe(rel_t: float) -> None:
        ok = errors = 0
        for _t, outcome, _ms in arrivals.rows:
            if outcome == "ok":
                ok += 1
            else:
                errors += 1
        sample = {"ok": ok, "errors": errors}
        if hasattr(fabric, "watchdog_sample"):
            sample.update(fabric.watchdog_sample())
        for kind in watchdog.observe(rel_t, sample):
            log(f"t={rel_t:.1f}s watchdog fired {kind}")

    # slow-exemplar attribution samples (profiles with expect_critpath
    # only — the in-process trace scan is not free at the health
    # cadence, so nobody else pays for it)
    critpath_rows: list[dict] = []

    def cp_observe(
        rel_t: float, max_age_s: Optional[float] = None
    ) -> None:
        if not profile.expect_critpath or not hasattr(
            fabric, "critpath_sample"
        ):
            return
        try:
            sample = fabric.critpath_sample(max_age_s=max_age_s)
        except Exception:  # noqa: BLE001 — evidence, never the run
            return
        if sample is not None:
            sample["t"] = round(rel_t, 3)
            if max_age_s is not None:
                sample["max_age_s"] = max_age_s
            critpath_rows.append(sample)

    try:
        # warmup: light load so the pipeline is hot before t0
        warm_end = loop.time() + profile.warmup
        while loop.time() < warm_end:
            t = asyncio.ensure_future(
                fabric.submit(
                    rng.randrange(1 << 20),
                    [(f"warm{rng.randrange(64)}", "w")] * profile.batch,
                    profile.call_timeout,
                )
            )
            fires.add(t)
            t.add_done_callback(fires.discard)
            await asyncio.sleep(max(0.005, 2.0 / profile.rate))

        t0 = loop.time()
        t_end = t0 + profile.duration
        events = sorted(profile.events, key=lambda e: e.at)
        ev_idx = 0
        next_arrival = t0
        next_sample = t0
        i = 0
        membership_pending: Optional[asyncio.Task] = None

        async def fire(idx: int, arrived: float) -> None:
            nonlocal inflight
            key = f"k{idx % 512}"
            pairs = [
                (f"{key}-{j}", f"v{idx}") for j in range(profile.batch)
            ]
            try:
                outcome = await fabric.submit(
                    idx, pairs, profile.call_timeout
                )
            except asyncio.CancelledError:
                # still unanswered when the drain gave up on it, past
                # its own call timeout: a timeout. The reference leaves
                # it unscored, so a window of such arrivals reads empty
                outcome = "timeout"
            except Exception:
                outcome = "error"
            finally:
                inflight -= 1
            arrivals.score(
                arrived, outcome, (loop.time() - arrived) * 1e3
            )

        def offer(idx: int, arrived: float) -> None:
            nonlocal inflight
            if inflight >= inflight_cap:
                arrivals.score(arrived, "overflow")
                return
            inflight += 1
            t = asyncio.ensure_future(fire(idx, arrived))
            fires.add(t)
            t.add_done_callback(fires.discard)

        while True:
            now = loop.time()
            # timed fault injections (membership events run async but
            # sequentially — one transition at a time, like a real
            # operator; load keeps firing while they run)
            while ev_idx < len(events) and now - t0 >= events[ev_idx].at:
                ev = events[ev_idx]
                ev_idx += 1
                log(f"t={now - t0:.1f}s event {ev.action} {ev.args}")
                if hasattr(fabric, "apply_event_async"):
                    # one transition at a time, like a real operator;
                    # load keeps firing while the transition runs
                    if membership_pending is not None:
                        await membership_pending
                    membership_pending = asyncio.ensure_future(
                        fabric.apply_event_async(ev.action, ev.args)
                    )
                    # let the transition coroutine reach its first await
                    # (membership bookkeeping is its first statement),
                    # then sample the watchdog on the event edge — a
                    # sub-window outage must not dodge detection by
                    # falling between cadence samples
                    await asyncio.sleep(0)
                    wd_observe(loop.time() - t0)
                else:
                    fabric.apply_event(ev.action, ev.args)
            # health sample (~per window)
            if now >= next_sample:
                health_rows.append(
                    {
                        "t": round(now - t0, 3),
                        "decided": fabric.decided_totals(),
                    }
                )
                # fresh clock read: an event-edge sample earlier in this
                # iteration may already have stamped a later t than the
                # loop-top `now`, and the watchdog windows assume
                # monotone sample times
                wd_observe(loop.time() - t0)
                cp_observe(loop.time() - t0)
                next_sample = now + window
            if now >= t_end:
                # a loop held past the window's end (by a fabric's own
                # synchronous work) still offers every arrival the
                # window scheduled, scored from its scheduled time: the
                # reference dropped them, and an empty final quarter
                # scored as a wedge
                while next_arrival < t_end:
                    offer(i, next_arrival)
                    next_arrival += rng.expovariate(profile.rate)
                    i += 1
                break
            # open-loop Poisson arrivals
            if now >= next_arrival:
                offer(i, next_arrival)
                next_arrival += rng.expovariate(profile.rate)
                i += 1
                continue
            await asyncio.sleep(
                max(0.001, min(next_arrival, next_sample, t_end) - now)
            )

        if membership_pending is not None:
            await membership_pending
        # drain stragglers (bounded), then score
        log("draining in-flight arrivals")
        if fires:
            await asyncio.wait(fires, timeout=profile.call_timeout + 1.0)
        for t in list(fires):
            t.cancel()
        if fires:
            await asyncio.gather(*fires, return_exceptions=True)
        fabric.clear_faults()

        # end-state convergence (faults cleared first)
        converged = True
        if profile.require_convergence:
            converged = await fabric.converged(timeout=10.0)
        # recovered-state attribution sample. The slowest-first
        # reservoir is honest but unforgiving here: fault-era stragglers
        # complete LATE, so they legitimately top the post-fault windows
        # and can mask the recovered tail. Drive a short healthy probe
        # load, then sample only exemplars younger than the probe phase —
        # the recovered tail, not the funeral of the faulted one.
        if profile.expect_critpath:
            # quiesce: gateway-side waves from the fault era complete on
            # their own schedule (client cancellation does not unwind
            # them) — let them land BEFORE the probe window opens so the
            # age filter below can tell the two populations apart
            await asyncio.sleep(2.0)
            probe_t0 = loop.time()
            for j in range(0, 40, 8):
                burst = [
                    fabric.submit(
                        1_000_000 + j + k,
                        [(f"probe-{j + k}", "v")],
                        profile.call_timeout,
                    )
                    for k in range(8)
                ]
                await asyncio.gather(*burst, return_exceptions=True)
                if j == 16:
                    # the first bursts absorb post-restart cold-start
                    # latency (session redial, first slot open); the
                    # verdict should judge the WARM recovered path, so
                    # age-scope the sample to the trailing bursts
                    probe_t0 = loop.time()
            cp_observe(
                loop.time() - t0,
                max_age_s=loop.time() - probe_t0 + 0.5,
            )
        else:
            cp_observe(loop.time() - t0)
        # fabric-specific end-state gates (the fleet fabric's
        # exactly-once replay sweep) — run before teardown
        fabric_problems: list = []
        fabric_summary = None
        if hasattr(fabric, "verify"):
            log("running fabric verify sweep")
            fabric_problems = await fabric.verify()
            if hasattr(fabric, "summary"):
                fabric_summary = fabric.summary()
        # cross-process fabrics have no in-process engines: they carry
        # their own (scrape-based) evidence collector
        if hasattr(fabric, "collect_evidence"):
            evidence = await fabric.collect_evidence()
        else:
            evidence = collect_evidence(fabric.engines())
    finally:
        await fabric.stop()

    timeline = arrivals.timeline(t0, profile.duration, window)
    n_ok = sum(w["ok"] for w in timeline)
    n_att = sum(w["attempts"] for w in timeline)
    avail = n_ok / n_att if n_att else 0.0
    q_len = max(1, len(timeline) // 4)
    tail = timeline[-q_len:]
    tail_ok = sum(w["ok"] for w in tail)
    tail_att = sum(w["attempts"] for w in tail)
    tail_avail = tail_ok / tail_att if tail_att else 0.0
    lat = sorted(
        ms for t, o, ms in arrivals.rows if o == "ok"
    )

    def lpct(q: float) -> Optional[float]:
        if not lat:
            return None
        return round(lat[min(len(lat) - 1, int(q * len(lat)))], 2)

    counts = {k: 0 for k in _OUTCOMES}
    for _t, o, _ms in arrivals.rows:
        counts[o] = counts.get(o, 0) + 1

    problems = []
    if n_att == 0:
        problems.append("no measured arrivals")
    if avail < profile.min_availability:
        problems.append(
            f"availability {avail:.3f} < floor {profile.min_availability}"
        )
    if tail_avail < profile.min_final_availability:
        problems.append(
            f"wedged: final-quarter availability {tail_avail:.3f} < "
            f"{profile.min_final_availability}"
        )
    if profile.require_convergence and not converged:
        problems.append("replicas did not converge after fault clearing")
    if not evidence["decisions"]:
        problems.append("no phases-to-decide evidence recorded")
    problems.extend(fabric_problems)

    # SLO watchdog verdict: profiles that declare expectations gate on
    # (a) every expected kind fired inside the fault window and (b) the
    # healthy control — NOTHING fired before the first fault event
    verdict = watchdog.verdict()
    if profile.expect_watchdog:
        first_event_at = min(
            (e.at for e in profile.events), default=0.0
        )
        for kind in profile.expect_watchdog:
            hits = [
                ep for ep in verdict["episodes"]
                if ep["kind"] == kind and ep["t"] >= first_event_at
            ]
            if not hits:
                problems.append(
                    f"watchdog: expected {kind!r} to fire during the "
                    f"fault window (fired: {verdict['fired'] or 'nothing'})"
                )
        early = [
            ep["kind"] for ep in verdict["episodes"]
            if ep["t"] < first_event_at
        ]
        if early:
            problems.append(
                "watchdog: fired on the healthy control (before "
                f"t={first_event_at}s): {sorted(set(early))}"
            )

    # critical-path attribution verdict — the watchdog's burn-rate
    # pattern applied to attribution: the expected segments' tail
    # milliseconds must BURN far above their healthy-control band
    # during the fault window, and return inside it after the faults
    # clear. (A label-argmax gate would be dishonest here: on a durable
    # profile fsync_barrier legitimately dominates the HEALTHY tail at
    # tens of ms — the fault signature is its explosion by an order of
    # magnitude, not its first appearance.)
    critpath_doc = None
    if profile.expect_critpath:
        first_event_at = min((e.at for e in profile.events), default=0.0)
        expected = set(profile.expect_critpath)

        def expected_ms(r: dict) -> float:
            segs = r.get("segments_ms", {})
            return sum(segs.get(s, 0.0) for s in expected)

        # The reservoir observes COMPLETIONS, so attribution lags the
        # fault: a wave stalled by the restart finishes (and is
        # decomposed) well after the last clear event. The burn window
        # is therefore everything from the first event through the
        # drain — while recovery is proven ONLY by the age-filtered
        # probe samples (max_age_s set), which see exclusively
        # post-quiesce traffic.
        control = [
            r for r in critpath_rows
            if r["t"] < first_event_at and r.get("exemplars")
            and "max_age_s" not in r
        ]
        fault = [
            r for r in critpath_rows
            if r["t"] >= first_event_at and r.get("exemplars")
            and "max_age_s" not in r
        ]
        post = [
            r for r in critpath_rows
            if "max_age_s" in r and r.get("exemplars")
        ]
        c_ms = max((expected_ms(r) for r in control), default=0.0)
        f_ms = max((expected_ms(r) for r in fault), default=0.0)
        r_ms = min((expected_ms(r) for r in post), default=None)
        # shift threshold: well clear of the control band (3x) with an
        # absolute floor so a near-zero control cannot make scheduler
        # noise look like a fault signature
        threshold = max(3.0 * c_ms, c_ms + 250.0)
        critpath_doc = {
            "expected": sorted(expected),
            "samples": len(critpath_rows),
            "control_ms": round(c_ms, 3),
            "fault_ms": round(f_ms, 3),
            "recovered_ms": (
                round(r_ms, 3) if r_ms is not None else None
            ),
            "threshold_ms": round(threshold, 3),
            "control_dominants": sorted(
                {r["dominant"] for r in control}
            ),
            "fault_dominants": sorted({r["dominant"] for r in fault}),
            "post_dominants": sorted({r["dominant"] for r in post}),
            "rows": critpath_rows,
        }
        if not control:
            problems.append(
                "critpath: no decomposable healthy-control sample "
                f"before t={first_event_at}s"
            )
        if f_ms < threshold:
            problems.append(
                f"critpath: {sorted(expected)} never burned above the "
                f"control band between the first event and the drain "
                f"(fault {f_ms:.0f}ms < threshold {threshold:.0f}ms, "
                f"control {c_ms:.0f}ms)"
            )
        if r_ms is None:
            problems.append(
                "critpath: no decomposable recovery-probe sample "
                "(recovery unproven)"
            )
        elif r_ms >= threshold:
            problems.append(
                f"critpath: {sorted(expected)} did not return to the "
                f"control band on the post-quiesce probe load "
                f"(best probe {r_ms:.0f}ms >= threshold "
                f"{threshold:.0f}ms)"
            )

    report = {
        "profile": profile.name,
        "fabric": profile.fabric,
        "description": profile.description,
        "duration_s": profile.duration,
        "offered_rps": profile.rate,
        "replicas": profile.n_replicas,
        "shards": profile.n_shards,
        "events": [
            {"at": e.at, "action": e.action, **e.args} for e in profile.events
        ],
        "arrivals": n_att,
        "outcomes": counts,
        "availability": round(avail, 4),
        "final_quarter_availability": round(tail_avail, 4),
        "min_window_availability": min(
            (w["availability"] for w in timeline
             if w["availability"] is not None),
            default=None,
        ),
        "settle_ms": {"p50": lpct(0.5), "p99": lpct(0.99),
                      "max": lpct(1.0)},
        "phases_to_decide": evidence,
        "timeline": timeline,
        "health": health_rows,
        "watchdog": verdict,
        "critpath": critpath_doc,
        "converged": converged,
        "fabric_summary": fabric_summary,
        "pass": not problems,
        "problems": problems,
    }
    log(
        f"done: avail={avail:.3f} tail={tail_avail:.3f} "
        f"decisions={evidence['decisions']} "
        f"mean_phases={evidence['mean_phases']} "
        f"coins={evidence['coin_flips']} "
        f"{'PASS' if not problems else 'FAIL ' + '; '.join(problems)}"
    )
    return report


async def run_matrix(
    profiles: dict[str, ChaosProfile], verbose: bool = True, *, device=None
) -> dict:
    """Run every profile sequentially and assemble the matrix report."""
    entries = {}
    for name, prof in profiles.items():
        entries[name] = await run_profile(prof, verbose=verbose, device=device)
    return {
        "version": MATRIX_VERSION,
        "benchmark": "scenario_matrix",
        "ts": time.time(),
        "profiles": entries,
        "pass": all(e["pass"] for e in entries.values()),
        "problems": {
            n: e["problems"] for n, e in entries.items() if e["problems"]
        },
    }


def render_matrix(report: dict) -> str:
    head = (
        f"{'profile':<22} {'fabric':<6} {'avail':>6} {'tail':>6} "
        f"{'p50ms':>7} {'p99ms':>8} {'decided':>8} {'phases':>11} "
        f"{'coins v0/v1':>12} {'ok?':>4}"
    )
    lines = [head, "-" * len(head)]
    for name, e in report["profiles"].items():
        ph = e["phases_to_decide"]
        s = e["settle_ms"]
        lines.append(
            f"{name:<22} {e['fabric']:<6} {e['availability']:>6.3f} "
            f"{e['final_quarter_availability']:>6.3f} "
            f"{s['p50'] if s['p50'] is not None else float('nan'):>7.1f} "
            f"{s['p99'] if s['p99'] is not None else float('nan'):>8.1f} "
            f"{ph['decisions']:>8d} "
            f"{(str(ph['mean_phases']) + '/' + str(ph['max_phases'])):>11} "
            f"{(str(ph['coin_flips']['v0']) + '/' + str(ph['coin_flips']['v1'])):>12} "
            f"{'yes' if e['pass'] else 'NO':>4}"
        )
    return "\n".join(lines)


def record_matrix(report: dict, path, key: str = MATRIX_KEY) -> None:
    """Merge the matrix (timelines trimmed) into the JSON file ``path``
    under ``key`` (latest run per key, the sweep_metrics convention).
    The reference writes its benchmarks/results.json; the port writes
    where its caller says."""
    import json

    path = Path(path)
    doc = {}
    if path.exists():
        try:
            doc = json.loads(path.read_text())
        except ValueError:
            doc = {}
    slim = {**report, "profiles": {}}
    for name, e in report["profiles"].items():
        slim["profiles"][name] = {
            k: v for k, v in e.items() if k not in ("health",)
        }
    doc[key] = slim
    path.write_text(json.dumps(doc, indent=1))
