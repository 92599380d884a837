"""Chaos plane: adverse-network scenario engine + elastic membership.

Rabia's pitch is randomized termination without a leader; this package
proves it where it is hard. A declarative profile matrix
(:mod:`~rabia_tpu_torch.chaos.profiles`) drives full clusters — the in-process
simulator fabric AND real-TCP clusters shaped inside the C transport —
through WAN jitter, sustained asymmetric loss, flapping partitions,
lagging replicas, crash/recover churn and elastic-membership transitions
under sustained open-loop load, while the runner
(:mod:`~rabia_tpu_torch.chaos.runner`) continuously records commit
availability and the consensus-health evidence the paper's claim needs:
the phases-to-decide distribution and coin-flip tallies.

Entry points: :func:`run_profile` / :func:`run_matrix` (chip_smoke.py's
phase 15 runs :func:`smoke_profiles` through them on the card). The
report schema is the reference's docs/SCENARIOS.md.

The port's copy of the reference's ``rabia_tpu/chaos/__init__.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from rabia_tpu_torch.chaos.profiles import (
    ChaosEvent,
    ChaosProfile,
    default_profiles,
    get_profile,
    smoke_profiles,
)
from rabia_tpu_torch.chaos.runner import (
    MATRIX_KEY,
    collect_evidence,
    record_matrix,
    render_matrix,
    run_matrix,
    run_profile,
)

__all__ = [
    "ChaosEvent",
    "ChaosProfile",
    "default_profiles",
    "smoke_profiles",
    "get_profile",
    "run_profile",
    "run_matrix",
    "render_matrix",
    "record_matrix",
    "collect_evidence",
    "MATRIX_KEY",
]
