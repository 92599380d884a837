"""Test & benchmark harnesses of the port: the cluster bootstrap, fault
injection, the performance scenarios and the engine-level
plane-conformance gate.

The port's copy of the reference's ``rabia_tpu/testing`` (its
gateway, load-session, multi-process and recovery harnesses are not
ported). Re-exports are lazy (PEP 562): the harness submodules pull the
engine on first attribute access.
"""

_EXPORTS = {
    "TestCluster": "rabia_tpu_torch.testing.cluster",
    "default_test_config": "rabia_tpu_torch.testing.cluster",
    "ConsensusTestHarness": "rabia_tpu_torch.testing.fault_injection",
    "ExpectedOutcome": "rabia_tpu_torch.testing.fault_injection",
    "Fault": "rabia_tpu_torch.testing.fault_injection",
    "FaultType": "rabia_tpu_torch.testing.fault_injection",
    "ScenarioResult": "rabia_tpu_torch.testing.fault_injection",
    "TestScenario": "rabia_tpu_torch.testing.fault_injection",
    "canned_scenarios": "rabia_tpu_torch.testing.fault_injection",
    "run_scenario": "rabia_tpu_torch.testing.fault_injection",
    "PerformanceBenchmark": "rabia_tpu_torch.testing.scenarios",
    "PerformanceReport": "rabia_tpu_torch.testing.scenarios",
    "PerformanceTest": "rabia_tpu_torch.testing.scenarios",
    "canned_performance_tests": "rabia_tpu_torch.testing.scenarios",
    "print_summary": "rabia_tpu_torch.testing.scenarios",
    "run_performance_test": "rabia_tpu_torch.testing.scenarios",
    "run_schedule_on_both_planes": "rabia_tpu_torch.testing.conformance",
    "settle_quantiles": "rabia_tpu_torch.testing.conformance",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
