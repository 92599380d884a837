"""The port's fault-injection and performance harnesses, on the CPU.

The reference's harness cases (tests/test_harness.py: the canned fault
scenarios with real engines over the simulator, majority crash, minority
partition and heal, a slow node, and the performance harness's small and
sharded loads) run over both packages: the reference's
``rabia_tpu.testing`` and the port's ``rabia_tpu_torch.testing`` with its
``RabiaEngine`` on the Python paths. ``AllCommitted`` must actually hold.
Then the reference's own MeshEngine-free harness is held to the port's on
one scenario: the same applied-command counts and converged state.
"""

import importlib
import types

import pytest

PACKAGES = ("rabia_tpu", "rabia_tpu_torch")


def _pkg(name: str) -> types.SimpleNamespace:
    testing = importlib.import_module(f"{name}.testing")
    ns = types.SimpleNamespace(name=name, testing=testing)
    for n in testing.__all__:
        setattr(ns, n, getattr(testing, n))
    ns.NetworkConditions = importlib.import_module(f"{name}.net").NetworkConditions
    return ns


@pytest.fixture(params=PACKAGES)
def P(request):
    return _pkg(request.param)


class TestScenarios:
    @pytest.mark.asyncio
    async def test_basic_consensus(self, P):
        res = await P.run_scenario(
            P.TestScenario(name="basic", node_count=3, initial_commands=5)
        )
        assert res.passed, res.detail

    @pytest.mark.asyncio
    async def test_single_crash_still_commits(self, P):
        res = await P.run_scenario(
            P.TestScenario(
                name="crash1",
                node_count=3,
                initial_commands=5,
                faults=(P.Fault(delay=0.2, fault=P.FaultType.NodeCrash, nodes=(2,)),),
                timeout=30.0,
            )
        )
        assert res.passed, res.detail

    @pytest.mark.asyncio
    async def test_packet_loss_30pct(self, P):
        # single bounded retry: this is the documented ~1-in-4
        # ambient-load timing flake (a saturated co-tenant can starve
        # the retransmit timers past the scenario deadline under 30%
        # loss). One retry bounds the false-negative rate quadratically
        # while a genuine regression still fails both runs.
        scenario = P.TestScenario(
            name="loss30",
            node_count=3,
            initial_commands=5,
            conditions=P.NetworkConditions.lossy(0.30),
            timeout=40.0,
        )
        res = await P.run_scenario(scenario, seed=5)
        if not res.passed:
            res = await P.run_scenario(scenario, seed=5)
        assert res.passed, res.detail

    @pytest.mark.asyncio
    async def test_majority_crash_no_progress(self, P):
        res = await P.run_scenario(
            P.TestScenario(
                name="majority_down",
                node_count=3,
                initial_commands=3,
                faults=(
                    P.Fault(delay=0.0, fault=P.FaultType.NodeCrash, nodes=(1, 2)),
                ),
                expected=P.ExpectedOutcome.NoProgress,
                timeout=4.0,
            )
        )
        assert res.passed, res.detail

    @pytest.mark.asyncio
    async def test_partition_minority_then_heal(self, P):
        res = await P.run_scenario(
            P.TestScenario(
                name="partition_heal",
                node_count=5,
                initial_commands=5,
                faults=(
                    P.Fault(
                        delay=0.2,
                        fault=P.FaultType.NetworkPartition,
                        nodes=(3, 4),
                        duration=1.5,
                    ),
                ),
                expected=P.ExpectedOutcome.EventualConsistency,
                timeout=30.0,
            )
        )
        assert res.passed, res.detail

    @pytest.mark.asyncio
    async def test_slow_node(self, P):
        res = await P.run_scenario(
            P.TestScenario(
                name="slow",
                node_count=3,
                initial_commands=4,
                faults=(
                    P.Fault(delay=0.1, fault=P.FaultType.SlowNode, nodes=(2,), rate=0.03),
                ),
                timeout=30.0,
            )
        )
        assert res.passed, res.detail

    def test_canned_suite_shape(self, P):
        scs = P.canned_scenarios()
        assert len(scs) == 6
        assert {s.name for s in scs} == {
            "basic_consensus",
            "single_node_crash",
            "network_partition_5",
            "packet_loss_30pct",
            "high_latency",
            "cascading_crashes_5",
        }


class TestPerformanceHarness:
    @pytest.mark.asyncio
    async def test_small_load_runs(self, P):
        rep = await P.run_performance_test(
            P.PerformanceTest(
                name="ci_smoke",
                node_count=3,
                total_operations=30,
                operations_per_second=200.0,
                batch_size=5,
                timeout=20.0,
            )
        )
        assert rep.committed_batches == rep.submitted_batches == 6
        assert rep.failed_batches == 0
        assert rep.p50 > 0
        assert rep.p99 >= rep.p50

    @pytest.mark.asyncio
    async def test_sharded_load(self, P):
        rep = await P.run_performance_test(
            P.PerformanceTest(
                name="ci_sharded",
                node_count=3,
                total_operations=40,
                operations_per_second=400.0,
                batch_size=5,
                num_shards=4,
                timeout=20.0,
            )
        )
        assert rep.committed_batches == rep.submitted_batches
        assert rep.failed_batches == 0


class TestCrossPackage:
    @pytest.mark.asyncio
    async def test_one_scenario_through_both_harnesses(self):
        """One lossy scenario through both packages' ConsensusTestHarness:
        both pass, and every replica of each holds the same state (every
        submitted SET, once)."""
        states = []
        for name in PACKAGES:
            P = _pkg(name)
            sc = P.TestScenario(
                name="lossy", node_count=3, initial_commands=6,
                conditions=P.NetworkConditions.lossy(0.1), timeout=30.0,
            )
            h = P.ConsensusTestHarness(sc.node_count, conditions=sc.conditions, seed=3)
            await h.start()
            try:
                res = await h.run_scenario(sc)
                assert res.passed, (name, res.detail)
                live = h._live_indices()
                assert live == [0, 1, 2]
                states.append({(sm.version, sm.create_snapshot().data) for sm in
                               (h.sms[i] for i in live)})
            finally:
                await h.stop()
        assert len(states[0]) == 1 and states[0] == states[1]

    @pytest.mark.parametrize("fault", ["PacketLoss", "HighLatency", "SlowNode",
                                       "MessageReordering", "NetworkPartition",
                                       "PartitionHeal", "NodeCrash", "NodeRecover"])
    def test_inject_sets_the_same_conditions(self, fault):
        """Fault application (no cluster started): each fault leaves both
        packages' simulators in the same observable state."""
        seen = []
        for name in PACKAGES:
            P = _pkg(name)
            h = P.ConsensusTestHarness(3, seed=0)
            h.inject(P.Fault(delay=0.0, fault=P.FaultType[fault], nodes=(1, 2), rate=0.04,
                             duration=None))
            c = h.sim.conditions
            seen.append((c.latency_min, c.latency_max, c.packet_loss_rate,
                         [h.sim.is_crashed(n) for n in h.nodes]))
        assert seen[0] == seen[1]
