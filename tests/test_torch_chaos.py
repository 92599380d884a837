"""Chaos-plane tests: NetworkSimulator edge semantics (partition expiry
racing heal, crash with in-flight messages, node delay x partition, the
new per-link asymmetric loss and scheduled flapping), the profile DSL,
and a short end-to-end scenario run with consensus-health evidence.
"""

from __future__ import annotations

import asyncio
import time

import pytest

from rabia_tpu_torch.chaos import default_profiles, smoke_profiles
from rabia_tpu_torch.chaos.profiles import ChaosEvent, ChaosProfile
from rabia_tpu_torch.core.types import NodeId
from rabia_tpu_torch.net import NetworkConditions, NetworkSimulator

A = NodeId.from_int(1)
B = NodeId.from_int(2)
C = NodeId.from_int(3)


def _sim(**kw) -> tuple[NetworkSimulator, dict]:
    sim = NetworkSimulator(**kw)
    nets = {n: sim.register(n) for n in (A, B, C)}
    return sim, nets


async def _drain(net, timeout=0.3):
    out = []
    while True:
        try:
            out.append(await net.receive(timeout=timeout))
        except Exception:
            return out


class TestSimulatorEdgeSemantics:
    @pytest.mark.asyncio
    async def test_partition_duration_expiry_races_heal(self):
        """A timed partition that already expired must leave heal_partition
        a no-op (not resurrect anything), and a heal BEFORE expiry must
        not be undone by the stale expiry deadline when a new untimed
        partition follows."""
        sim, nets = _sim()
        sim.partition({B}, duration=0.05)
        sim.send(A, B, b"during")
        assert sim.stats.messages_dropped == 1
        await asyncio.sleep(0.08)
        # expired: traffic flows again even with no explicit heal
        sim.send(A, B, b"after-expiry")
        assert (await nets[B].receive(timeout=0.5))[1] == b"after-expiry"
        sim.heal_partition()  # racing the (already-fired) expiry: no-op
        sim.send(A, B, b"after-heal")
        assert (await nets[B].receive(timeout=0.5))[1] == b"after-heal"

        # heal BEFORE expiry, then a new UNTIMED partition: the old
        # deadline must not expire the new partition early
        sim.partition({B}, duration=5.0)
        sim.heal_partition()
        sim.send(A, B, b"healed-early")
        assert (await nets[B].receive(timeout=0.5))[1] == b"healed-early"
        sim.partition({B})  # no duration: until healed
        await asyncio.sleep(0.06)
        dropped = sim.stats.messages_dropped
        sim.send(A, B, b"blocked")
        assert sim.stats.messages_dropped == dropped + 1

    @pytest.mark.asyncio
    async def test_crash_with_messages_in_flight_drops_at_delivery(self):
        """Messages already in the delay heap when the target crashes
        must be dropped at DELIVERY time, not handed to a dead node."""
        sim, nets = _sim(
            conditions=NetworkConditions(latency_min=0.05, latency_max=0.06)
        )
        sim.send(A, B, b"doomed")
        sim.crash(B)  # in-flight: due in ~50ms
        await asyncio.sleep(0.12)
        assert nets[B].receive_nowait() is None
        assert sim.stats.messages_dropped == 1
        # recovery does NOT resurrect the dropped message
        sim.recover(B)
        await asyncio.sleep(0.08)
        assert nets[B].receive_nowait() is None
        # but fresh traffic flows
        sim.send(A, B, b"fresh")
        assert (await nets[B].receive(timeout=0.5))[1] == b"fresh"

    @pytest.mark.asyncio
    async def test_node_delay_interacts_with_partition_at_delivery(self):
        """set_node_delay holds a message in flight; a partition that
        activates before the due time blocks it at delivery (one-sided
        membership check runs again at delivery time), and a partition
        that heals before the due time lets it through."""
        sim, nets = _sim()
        sim.set_node_delay(B, 0.08)
        sim.send(A, B, b"blocked-at-delivery")
        sim.partition({B}, duration=0.5)  # activates while in flight
        await asyncio.sleep(0.15)
        assert nets[B].receive_nowait() is None
        assert sim.stats.messages_dropped == 1
        sim.heal_partition()
        # reverse order: partitioned at SEND time drops immediately,
        # regardless of the pending delay
        dropped = sim.stats.messages_dropped
        sim.partition({B}, duration=0.02)
        sim.send(A, B, b"dropped-at-send")
        assert sim.stats.messages_dropped == dropped + 1
        # healed while in flight: delivered
        await asyncio.sleep(0.05)
        sim.send(A, B, b"in-flight-heals")
        assert (
            await nets[B].receive(timeout=1.0)
        )[1] == b"in-flight-heals"
        sim.set_node_delay(B, 0.0)

    @pytest.mark.asyncio
    async def test_asymmetric_link_loss_is_directional(self):
        sim, nets = _sim()
        sim.set_link_loss(A, B, 1.0)
        for _ in range(5):
            sim.send(A, B, b"up")   # all dropped
            sim.send(B, A, b"down")  # all delivered
        assert len(await _drain(nets[A], timeout=0.1)) == 5
        assert nets[B].receive_nowait() is None
        # other links untouched
        sim.send(A, C, b"side")
        assert (await nets[C].receive(timeout=0.5))[1] == b"side"
        sim.clear_link_faults()
        sim.send(A, B, b"cleared")
        assert (await nets[B].receive(timeout=0.5))[1] == b"cleared"

    @pytest.mark.asyncio
    async def test_flap_schedule_blocks_down_windows_then_expires(self):
        sim, nets = _sim()
        sim.set_flap({B}, period=0.2, duty=0.5, duration=0.5)
        t0 = time.monotonic()
        # first half-period: down (blocked, one-sided)
        dropped = sim.stats.messages_dropped
        sim.send(A, B, b"down-window")
        assert sim.stats.messages_dropped == dropped + 1
        sim.send(C, A, b"unaffected")  # neither endpoint in the group
        assert (await nets[A].receive(timeout=0.5))[1] == b"unaffected"
        # wait into the second half-period: up
        await asyncio.sleep(max(0.0, t0 + 0.12 - time.monotonic()))
        sim.send(A, B, b"up-window")
        assert (await nets[B].receive(timeout=0.5))[1] == b"up-window"
        # past the episode: flapping is over regardless of phase
        await asyncio.sleep(max(0.0, t0 + 0.55 - time.monotonic()))
        sim.send(A, B, b"episode-over")
        assert (await nets[B].receive(timeout=0.5))[1] == b"episode-over"
        # get_connected_nodes honors the flap window too
        sim.set_flap({B}, period=10.0, duty=1.0)
        assert B not in await nets[A].get_connected_nodes()
        sim.clear_flap()
        assert B in await nets[A].get_connected_nodes()


class TestProfileDsl:
    def test_default_matrix_shape(self):
        profs = default_profiles()
        assert len(profs) >= 6
        fabrics = {p.fabric for p in profs.values()}
        assert fabrics == {"sim", "tcp", "fleet", "mesh", "groups"}
        # the acceptance shape: >=1 real-TCP shaped, >=1 membership,
        # >=1 routed-fleet gateway failover (round 16), >=1 device-plane
        # mesh with a mid-window demotion (round 17), >=1 partitioned-
        # group proposer kill (round 20)
        assert any(
            p.fabric == "tcp"
            and any(e.action in ("wan", "link_loss") for e in p.events)
            for p in profs.values()
        )
        assert any(
            any(
                e.action in ("stop_replica", "start_replica",
                             "restart_replica")
                for e in p.events
            )
            for p in profs.values()
        )
        assert any(
            p.fabric == "fleet"
            and any(e.action == "kill_gateway" for e in p.events)
            for p in profs.values()
        )
        assert any(
            p.fabric == "mesh"
            and any(e.action == "demote_device" for e in p.events)
            for p in profs.values()
        )
        assert any(
            p.fabric == "groups"
            and any(e.action == "kill_group_proposer" for e in p.events)
            for p in profs.values()
        )
        smoke = smoke_profiles()
        assert 2 <= len(smoke) <= 7
        assert any(p.fabric == "tcp" for p in smoke.values())
        assert "routed_gateway_failover" in smoke
        assert "mesh_device_read_lane" in smoke
        assert "group_proposer_kill" in smoke

    def test_scaling_preserves_structure(self):
        p = ChaosProfile(
            name="x", fabric="sim", description="", duration=10.0,
            events=(
                ChaosEvent(2.0, "flap",
                           {"group": [1], "period": 1.0, "duty": 0.4,
                            "duration": 4.0}),
                ChaosEvent(8.0, "heal", {}),
            ),
        )
        s = p.scaled(0.5)
        assert s.duration == 5.0
        assert s.events[0].at == 1.0
        assert s.events[0].args["period"] == 0.5
        assert s.events[0].args["duration"] == 2.0
        assert s.events[0].args["duty"] == 0.4  # NOT time-scaled
        assert s.events[1].at == 4.0
        assert p.scaled(1.0) is p


class TestScenarioRunSim:
    @pytest.mark.asyncio
    async def test_short_sim_profile_records_evidence_and_timeline(self):
        """End-to-end mini scenario on the simulator fabric: the report
        must carry a continuous availability timeline, the
        phases-to-decide distribution and coin tallies — the evidence
        schema every matrix entry promises (docs/SCENARIOS.md)."""
        from rabia_tpu_torch.chaos.runner import run_profile

        prof = ChaosProfile(
            name="mini",
            fabric="sim",
            description="mini flap",
            duration=2.5,
            warmup=0.5,
            rate=60.0,
            events=(
                ChaosEvent(0.5, "flap",
                           {"group": [2], "period": 0.5, "duty": 0.4,
                            "duration": 1.2}),
            ),
            min_availability=0.2,
        )
        rep = await run_profile(prof, verbose=False)
        assert rep["arrivals"] > 0
        assert rep["outcomes"]["ok"] > 0
        assert len(rep["timeline"]) >= 8
        assert any(
            w["availability"] is not None for w in rep["timeline"]
        )
        ev = rep["phases_to_decide"]
        assert ev["decisions"] > 0
        assert ev["hist"], "empty phase-count distribution"
        assert ev["mean_phases"] >= 1.0
        assert set(ev["coin_flips"]) == {"v0", "v1"}
        assert rep["converged"] is True
        assert rep["pass"], rep["problems"]


class TestScenarioRunFleet:
    @pytest.mark.asyncio
    async def test_routed_gateway_failover_mini(self):
        """End-to-end mini routed-fleet scenario: kill a fleet gateway
        mid-wave — clients follow the ring to the survivor, the run
        scores non-zero goodput through the kill, and the post-run
        exactly-once replay sweep (fabric.verify) passes with zero
        problems."""
        from rabia_tpu_torch.chaos.profiles import default_profiles
        from rabia_tpu_torch.chaos.runner import run_profile

        prof = default_profiles()["routed_gateway_failover"].scaled(0.4)
        rep = await run_profile(prof, verbose=False)
        assert rep["fabric"] == "fleet"
        assert rep["outcomes"]["ok"] > 0
        assert rep["converged"] is True
        assert rep["pass"], rep["problems"]


class TestElasticMembership:
    @pytest.mark.asyncio
    async def test_stop_start_replica_under_client_load(self):
        """GatewayCluster's elastic-membership surface directly: a
        replica decommissions while a client keeps committing against
        the surviving quorum, then rejoins (WAL recovery) and the
        cluster reconverges with the writes that happened while it was
        gone."""
        from rabia_tpu_torch.apps.kvstore import decode_kv_response, encode_set_bin
        from rabia_tpu_torch.gateway.client import RabiaClient
        from rabia_tpu_torch.native.build import load_walkernel
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        if load_walkernel() is None:
            pytest.skip("walkernel unavailable")
        c = GatewayCluster(3, 2, persistence="wal")
        cli = None
        try:
            await c.start()
            cli = RabiaClient(
                [c.endpoint(0), c.endpoint(1)], call_timeout=30.0
            )
            await cli.connect()
            for k in range(6):
                resp = await cli.submit(
                    k % 2, [encode_set_bin(f"em{k}", f"v{k}")]
                )
                assert decode_kv_response(resp[0]).ok
            await c.stop_replica(2)
            assert c.is_down(2) and c.live_replicas == [0, 1]
            # the surviving quorum keeps serving THROUGH the outage
            for k in range(6, 12):
                resp = await cli.submit(
                    k % 2, [encode_set_bin(f"em{k}", f"v{k}")]
                )
                assert decode_kv_response(resp[0]).ok
            await c.start_replica(2)
            assert not c.is_down(2)
            await c.wait_converged(20)
            # the rejoined replica holds a write it never saw live
            # (em8 was submitted on shard 8 % 2 == 0)
            v = c.store(2, 0).get("em8")
            assert getattr(v, "value", v) == "v8"
        finally:
            if cli is not None:
                await cli.close()
            await c.stop()


# ---------------------------------------------------------------------------
# The port against the reference, and the mesh fabric on the CPU
# ---------------------------------------------------------------------------


class TestAcrossPackages:
    def test_profiles_equal_field_for_field(self):
        """``default_profiles()`` and ``smoke_profiles()`` of both
        packages name the same profiles with the same fields, events
        included, and the port's time scaling matches the reference's."""
        import dataclasses

        from rabia_tpu import chaos as ref

        for port_fn, ref_fn in ((default_profiles, ref.default_profiles),
                                (smoke_profiles, ref.smoke_profiles)):
            port_p, ref_p = port_fn(), ref_fn()
            assert list(port_p) == list(ref_p)
            for name in ref_p:
                assert dataclasses.asdict(port_p[name]) == dataclasses.asdict(
                    ref_p[name]), name
                for f in (0.3, 0.7):
                    assert dataclasses.asdict(port_p[name].scaled(f)) == (
                        dataclasses.asdict(ref_p[name].scaled(f))), (name, f)


class TestMeshFabric:
    def test_engine_runs_on_cuda_unless_asked(self):
        """The mesh fabric's engine takes the caller's device; with none
        it asks for CUDA and, with no card, raises: it never carries on
        on the CPU by itself."""
        import torch

        from rabia_tpu_torch.chaos.runner import _MeshFabric

        prof = smoke_profiles()["mesh_device_read_lane"]
        fab = _MeshFabric(prof, device="cpu")
        try:
            assert fab.eng.device.type == "cpu"
        finally:
            fab.eng.close()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                _MeshFabric(prof)

    @pytest.mark.asyncio
    async def test_smoke_mesh_profile_on_cpu(self):
        """The smoke set's mesh profile as the reference defines it, on
        the CPU: the verify sweep passes with probe reads and no lockstep
        divergence. The port's device table holds every key the fabric
        writes, so the lane stays up through the crash and the forced
        demotion finds it up (the reference's 64-slot table overflows
        first); whether it re-promotes before the run ends depends on
        the host's speed, so chip_smoke checks that on the card."""
        from rabia_tpu_torch.chaos.runner import run_profile

        prof = smoke_profiles()["mesh_device_read_lane"]
        rep = await run_profile(prof, verbose=False, device="cpu")
        assert rep["fabric"] == "mesh"
        fs = rep["fabric_summary"]
        assert fs["device"] == "cpu"
        assert fs["read_lane"]["probe"] > 0
        assert fs["divergences"] == 0
        assert fs["forced_demotions"] == 1 and fs["lane_demotions"] >= 1
        assert fs["keys_per_shard_max"] <= fs["device_table_slots"]
        # the reference's fabric keeps DeviceKVTable's default table, which
        # this run's key stream overflows
        import inspect

        from rabia_tpu.apps.device_kv import DeviceKVTable as RefTable

        ref_slots = inspect.signature(RefTable).parameters["per_shard_capacity"].default
        assert fs["keys_per_shard_max"] > ref_slots == 64
        assert rep["outcomes"]["ok"] > 0
        assert rep["converged"] is True
        assert rep["pass"], rep["problems"]


    @pytest.mark.asyncio
    async def test_smoke_mesh_profile_on_a_4x1_mesh(self):
        """The smoke set's mesh profile with the engine over a logical 4 x
        1 mesh of the CPU (the device table in four shard blocks, a
        window one launch a block): it passes as on one device, with
        probe reads, no divergence and the forced demotion; then the
        fabric's demotion and re-promotion cycle on the same shape
        re-promotes the lane and converges."""
        import sys
        from pathlib import Path

        from rabia_tpu_torch.chaos.runner import run_profile
        from rabia_tpu_torch.parallel import make_mesh

        prof = smoke_profiles()["mesh_device_read_lane"]
        rep = await run_profile(prof, verbose=False, mesh=make_mesh(["cpu"] * 4))
        fs = rep["fabric_summary"]
        assert fs["device"] == "cpu" and fs["mesh"] == [4, 1]
        assert fs["read_lane"]["probe"] > 0
        assert fs["divergences"] == 0
        assert fs["forced_demotions"] == 1 and fs["lane_demotions"] >= 1
        assert rep["outcomes"]["ok"] > 0
        assert rep["converged"] is True
        assert rep["pass"], rep["problems"]
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        import chip_smoke

        st = await chip_smoke._mesh_lane_cycle("cpu", 16, 3, mesh=make_mesh(["cpu"] * 4))
        assert st["mesh"] == [4, 1]
        assert st["forced_demotions"] == 1 and st["lane_promotions"] >= 1


class TestCritpathSampleCost:
    @pytest.mark.asyncio
    async def test_sample_reads_each_engines_rings_once(self, monkeypatch):
        """The tcp fabric's critical-path sample, taken at the health
        cadence on the run's own event loop, reads each engine's flight
        rings once for all its exemplars: the reference read them once a
        trace slice (exemplars x engines x hashes rebuilds of tens of
        thousands of events), holding the loop for seconds and starving
        the arrivals it samples (coalesce_flap_restart's failures)."""
        from rabia_tpu_torch.chaos.runner import _TcpFabric
        from rabia_tpu_torch.engine.engine import RabiaEngine

        reads = []
        orig = RabiaEngine.flight_events

        def counted(self):
            reads.append(id(self))
            return orig(self)

        monkeypatch.setattr(RabiaEngine, "flight_events", counted)
        prof = ChaosProfile(name="cp", fabric="tcp", description="",
                            duration=1.0, n_shards=2)
        fab = _TcpFabric(prof)
        await fab.start()
        try:
            for i in range(12):
                assert await fab.submit(i, [(f"cp{i}", "v")], 10.0) == "ok"
            reads.clear()
            sample = fab.critpath_sample(pool=8)
            assert sample is not None and sample["exemplars"] >= 2
            engines = fab.engines()
            assert sorted(reads) == sorted(id(e) for e in engines)
        finally:
            await fab.stop()


class TestOpenLoopScoring:
    """The runner's open-loop generator offers every arrival its window
    schedules, and an arrival left unanswered past the drain is a
    timeout: the port's repairs of the reference's runner, which dropped
    the arrivals due while a fabric held the loop past the window's end
    and left the ones the drain cancelled unscored, so either read as an
    empty final quarter: "wedged"."""

    @staticmethod
    def _stall_profile():
        return ChaosProfile(
            name="stall", fabric="sim", description="", duration=2.0,
            warmup=0.5, rate=60.0, call_timeout=0.5,
            events=(ChaosEvent(1.2, "stall", {"s": 1.2}),),
            min_availability=0.2,
        )

    @staticmethod
    def _patch(monkeypatch, runner, hang_every: int = 0):
        orig_event, orig_submit = runner._SimFabric.apply_event, runner._SimFabric.submit

        def apply_event(self, action, args):
            if action == "stall":  # a fabric's synchronous work holds the loop
                time.sleep(args["s"])
                return
            orig_event(self, action, args)

        async def submit(self, i, pairs, timeout):
            if hang_every and i % hang_every == 0:
                await asyncio.Event().wait()  # never answered
            return await orig_submit(self, i, pairs, timeout)

        monkeypatch.setattr(runner._SimFabric, "apply_event", apply_event)
        monkeypatch.setattr(runner._SimFabric, "submit", submit)

    @pytest.mark.asyncio
    async def test_loop_held_past_the_window_still_offers_its_arrivals(self, monkeypatch):
        from rabia_tpu.chaos import runner as ref_runner
        from rabia_tpu_torch.chaos import runner

        self._patch(monkeypatch, runner)
        self._patch(monkeypatch, ref_runner)
        prof = self._stall_profile()
        rep = await runner.run_profile(prof, verbose=False)
        tail = rep["timeline"][-len(rep["timeline"]) // 4:]
        assert all(w["attempts"] > 0 for w in tail), tail
        assert rep["final_quarter_availability"] > 0.5
        assert rep["pass"], rep["problems"]
        # the reference drops them: its final quarter is empty
        ref = await ref_runner.run_profile(
            ref_runner.ChaosProfile(**prof.__dict__), verbose=False)
        assert ref["final_quarter_availability"] == 0.0
        assert any("wedged" in p for p in ref["problems"])

    @pytest.mark.asyncio
    async def test_arrival_cancelled_by_the_drain_is_a_timeout(self, monkeypatch):
        from rabia_tpu_torch.chaos import runner

        self._patch(monkeypatch, runner, hang_every=5)
        prof = ChaosProfile(name="hang", fabric="sim", description="",
                            duration=1.5, warmup=0.5, rate=40.0,
                            call_timeout=0.5, min_availability=0.2)
        rep = await runner.run_profile(prof, verbose=False)
        n = rep["arrivals"]
        assert rep["outcomes"]["timeout"] >= n // 5 - 1 > 0
        assert rep["outcomes"]["ok"] + rep["outcomes"]["timeout"] == n


class TestSmokeProfilesOnCpu:
    """The chaos smoke set's host-only profiles, each as the reference
    defines it (chip_smoke.py runs the mesh profile on the card): every
    one passes its own gates."""

    @pytest.mark.parametrize("name", [
        "flapping_partition", "tcp_shaped_wan", "membership_elastic",
        "coalesce_flap_restart", "routed_gateway_failover",
        # six replica processes on ports picked before they bind: slow,
        # as the reference marks its process-group tests (another test's
        # process can take a port first on a busy host)
        pytest.param("group_proposer_kill", marks=pytest.mark.slow),
    ])
    @pytest.mark.asyncio
    async def test_smoke_profile_passes(self, name):
        from rabia_tpu_torch.chaos.runner import run_profile

        prof = smoke_profiles()[name]
        assert prof.fabric != "mesh"
        rep = await run_profile(prof, verbose=False)
        assert rep["arrivals"] > 0 and rep["outcomes"]["ok"] > 0
        assert rep["pass"], rep["problems"]
