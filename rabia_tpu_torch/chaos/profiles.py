"""Adverse-network / elastic-membership scenario profiles (the chaos DSL).

A :class:`ChaosProfile` is a declarative description of ONE scenario: a
load shape (open-loop Poisson arrivals, never waiting on the system), a
timed list of :class:`ChaosEvent` fault injections, and acceptance floors
the matrix gate scores against. Profiles are data, not code — the runner
(:mod:`rabia_tpu_torch.chaos.runner`) interprets the events against whichever
fabric the profile targets:

- ``fabric="sim"``  — an in-process :class:`~rabia_tpu_torch.net.NetworkSimulator`
  cluster (deterministic impairments: per-link asymmetric loss, scheduled
  flapping, timed partitions, slow nodes, crash/recover);
- ``fabric="tcp"``  — a real-TCP :class:`~rabia_tpu_torch.testing.gateway_cluster.
  GatewayCluster` (gateway + native engine runtime + WAL durability plane),
  impaired through the C transport's shaping layer (``rt_set_shaping``)
  and the elastic-membership surface (stop/start/rolling-restart) — the
  PRODUCTION commit path carries the shaped traffic, not a stand-in.

Event vocabulary (``ChaosEvent.action``):

====================  =======  ====================================================
action                fabrics  args
====================  =======  ====================================================
``wan``               both     ``latency_ms``, ``jitter_ms`` = TOTAL spread (all links)
``link_loss``         both     ``src``, ``dst`` (replica indices), ``rate``
``flap``              sim      ``group`` (indices), ``period``, ``duty``, ``duration``
``partition``         sim      ``group``, ``duration`` (None = until ``heal``)
``heal``              sim      — (heals partition AND flapping)
``slow``              both     ``node``, ``delay_ms`` (0 clears)
``crash``             sim/mesh ``node``
``recover``           sim/mesh ``node``
``demote_device``     mesh     — (force device-lane demotion mid-window)
``stop_replica``      tcp      ``node``
``start_replica``     tcp      ``node``
``restart_replica``   tcp      ``node``
``kill_gateway``      fleet    ``gw`` (fleet gateway index; abrupt, no handoff)
``rebalance``         fleet    ``members`` (surviving gateway indices; handoff runs)
``kill_group_proposer`` groups ``group`` (SIGKILL that group's proposer replica)
``restart_group_proposer`` groups ``group`` (restart the killed proposer)
``clear``             both     — (clears link faults / shaping)
====================  =======  ====================================================

``fabric="mesh"`` (round 17) is the device-plane tier: one colocated
lockstep :class:`~rabia_tpu_torch.parallel.MeshEngine` with the
device-resident KV table AND the consensus-free read-index lane on —
full-width SET waves interleave with GET waves the lane must serve off
consensus, while replicas drop out of the alive mask and the device
store is force-demoted mid-window; the post-run verify gates on the
lane having actually engaged (probe reads > 0) and on zero lockstep
apply divergences.

``fabric="groups"`` (round 20) is the partitioned tier: N independent
consensus groups, each its own OS-process replica set with its own WAL
root (``fleet/groups.py``), loaded through group-routed sessions; the
scenario SIGKILLs one group's proposer mid-wave and gates on the OTHER
groups' goodput holding inside the healthy control band (blast-radius
isolation) plus a post-run per-group exactly-once replay sweep.

``fabric="fleet"`` (round 16) is the routed tier: the same real-TCP
replica cluster behind consistent-hash-routed fleet gateways
(docs/FLEET.md), loaded through MOVED-following sessions; its runs add
a post-run exactly-once replay sweep (every session's last acked
Result must replay byte-identical through the post-fault ring with
zero store mutation).

Every profile measures the same consensus-health evidence regardless of
fabric: the per-decision **phases-to-decide distribution** and
**coin-flip tallies** (the paper's randomized-termination analysis), and
a **continuous commit-availability timeline** (per-window goodput over
offered arrivals — the dip during the partition is the datum, not the
end-of-run average). docs/SCENARIOS.md documents the schema.

The port's copy of the reference's ``rabia_tpu/chaos/profiles.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ChaosEvent:
    """One timed fault injection: run ``action(args)`` at ``at`` seconds
    after the measure window opens."""

    at: float
    action: str
    args: dict = field(default_factory=dict)


@dataclass(frozen=True)
class ChaosProfile:
    """One named scenario (see module doc for the event vocabulary)."""

    name: str
    fabric: str  # "sim" | "tcp" | "fleet" | "mesh" | "groups"
    description: str
    duration: float  # measure window, seconds
    events: tuple[ChaosEvent, ...] = ()
    # open-loop load shape
    rate: float = 120.0  # offered ops/s (Poisson)
    warmup: float = 1.0
    batch: int = 4  # commands per submit
    call_timeout: float = 8.0
    n_replicas: int = 3
    n_shards: int = 4
    n_gateways: int = 2  # fleet fabric only: routing-tier size
    n_groups: int = 2  # groups fabric only: partitioned consensus groups
    # acceptance floors (the matrix gate)
    min_availability: float = 0.5  # mean over the whole run
    min_final_availability: float = 0.05  # last-quarter mean: wedge guard
    require_convergence: bool = True
    seed: int = 20260803
    # tcp fabric only: GatewayConfig field overrides as a (key, value)
    # tuple-of-pairs (profiles are frozen/hashable — no dict field)
    gateway_overrides: tuple = ()
    # SLO burn-rate watchdog (obs/fleet_obs.py, round 18): journal kinds
    # the watchdog MUST record during the fault window — and before the
    # first fault event it must stay quiet (the healthy control). Empty
    # tuple = watchdog runs but is not asserted on.
    expect_watchdog: tuple = ()
    # Critical-path attribution gate (obs/critpath.py, round 19):
    # segment names whose combined slow-exemplar milliseconds must burn
    # far above their healthy-control band during the fault window and
    # return inside it after the faults clear (the burn-rate watchdog
    # pattern applied to attribution — on a durable profile
    # fsync_barrier dominates the HEALTHY tail too, so the signature is
    # magnitude, not first appearance). Empty tuple = no exemplar
    # sampling (the decomposition scan is not free).
    expect_critpath: tuple = ()

    def scaled(self, factor: float) -> "ChaosProfile":
        """Time-scaled copy (the CI smoke cell runs factor < 1)."""
        if factor == 1.0:
            return self
        ev = tuple(
            ChaosEvent(
                at=e.at * factor,
                action=e.action,
                args={
                    k: (v * factor if k in ("duration", "period") else v)
                    for k, v in e.args.items()
                },
            )
            for e in self.events
        )
        return ChaosProfile(
            **{
                **self.__dict__,
                "duration": self.duration * factor,
                "warmup": max(0.5, self.warmup * factor),
                "events": ev,
            }
        )


def _p(name, fabric, desc, duration, events, **kw) -> ChaosProfile:
    return ChaosProfile(
        name=name,
        fabric=fabric,
        description=desc,
        duration=duration,
        events=tuple(events),
        **kw,
    )


def default_profiles() -> dict[str, ChaosProfile]:
    """The standing scenario matrix (``scenario_matrix_r12``): ≥6 named
    profiles, at least one real-TCP shaped and at least one elastic
    membership change under sustained load."""
    profiles = [
        # -- simulator fabric -------------------------------------------
        _p(
            "wan_jitter",
            "sim",
            "WAN latency with heavy jitter on every link (25ms one-way, "
            "20ms total spread): decisions must keep terminating in few phases "
            "with round trips two orders slower than LAN",
            duration=8.0,
            events=[
                ChaosEvent(0.0, "wan", {"latency_ms": 25.0, "jitter_ms": 20.0}),
            ],
            # WAN round trips serialize slot progress: offer well under
            # the ~shards/RTT capacity so the curve scores the network,
            # not a queueing collapse of the generator's own making
            rate=36.0,
            min_availability=0.8,
        ),
        _p(
            "asymmetric_loss",
            "sim",
            "Sustained asymmetric loss: replica 0's OUTBOUND links drop "
            "30%, then 60% mid-run, while its inbound stays clean (the "
            "wireless-BFT lossy-uplink shape); retransmission must keep "
            "the phase-count tail bounded",
            duration=10.0,
            events=[
                ChaosEvent(0.0, "link_loss", {"src": 0, "dst": 1, "rate": 0.3}),
                ChaosEvent(0.0, "link_loss", {"src": 0, "dst": 2, "rate": 0.3}),
                ChaosEvent(4.0, "link_loss", {"src": 0, "dst": 1, "rate": 0.6}),
                ChaosEvent(4.0, "link_loss", {"src": 0, "dst": 2, "rate": 0.6}),
                ChaosEvent(8.0, "clear", {}),
            ],
            min_availability=0.55,
        ),
        _p(
            "flapping_partition",
            "sim",
            "A minority replica flaps in and out of a partition every "
            "1.2s (40% down duty): the cluster must ride through every "
            "flap without wedging on stale votes",
            duration=10.0,
            events=[
                ChaosEvent(
                    1.0,
                    "flap",
                    {"group": [2], "period": 1.2, "duty": 0.4,
                     "duration": 7.0},
                ),
                ChaosEvent(8.5, "heal", {}),
            ],
            min_availability=0.6,
        ),
        _p(
            "slow_replica",
            "sim",
            "One chronically lagging replica (35ms extra on all its "
            "traffic): the quorum path must route around it, and its "
            "stale votes must not poison phase counts",
            duration=8.0,
            events=[
                ChaosEvent(0.5, "slow", {"node": 1, "delay_ms": 35.0}),
                ChaosEvent(6.5, "slow", {"node": 1, "delay_ms": 0.0}),
            ],
            rate=90.0,
            min_availability=0.7,
        ),
        _p(
            "crash_recover_churn",
            "sim",
            "Minority crash/recover churn: each replica in turn crashes "
            "for ~1.5s and recovers; availability must hold through "
            "every single-replica outage",
            duration=10.0,
            events=[
                ChaosEvent(1.0, "crash", {"node": 2}),
                ChaosEvent(2.5, "recover", {"node": 2}),
                ChaosEvent(4.0, "crash", {"node": 1}),
                ChaosEvent(5.5, "recover", {"node": 1}),
                ChaosEvent(7.0, "crash", {"node": 0}),
                ChaosEvent(8.5, "recover", {"node": 0}),
            ],
            min_availability=0.5,
        ),
        # -- real-TCP fabric (gateway + native runtime + durability) ----
        _p(
            "tcp_shaped_wan",
            "tcp",
            "Real-TCP cluster under C-transport shaping: every "
            "replica-to-replica link carries 10ms (6ms jitter spread) injected "
            "one-way delay inside the native io loop — the production "
            "epoll path, not a simulator",
            duration=8.0,
            events=[
                ChaosEvent(0.0, "wan", {"latency_ms": 10.0, "jitter_ms": 6.0}),
            ],
            rate=80.0,
            min_availability=0.7,
        ),
        _p(
            "tcp_asymmetric_loss",
            "tcp",
            "Real-TCP asymmetric drop: replica 0's outbound consensus "
            "frames drop 25% in the C transport while everything else "
            "flows clean; vote retransmission must carry the slack",
            duration=8.0,
            events=[
                ChaosEvent(
                    0.5, "link_loss", {"src": 0, "dst": 1, "rate": 0.25}
                ),
                ChaosEvent(
                    0.5, "link_loss", {"src": 0, "dst": 2, "rate": 0.25}
                ),
                ChaosEvent(6.5, "clear", {}),
            ],
            rate=80.0,
            min_availability=0.6,
        ),
        _p(
            "membership_elastic",
            "tcp",
            "Elastic membership under sustained load: a replica is "
            "DECOMMISSIONED mid-run (gateway, engine and transport down),"
            " the remaining quorum keeps committing, then it REJOINS "
            "(WAL recovery + tail catch-up) — commit availability and "
            "settle latency are scored CONTINUOUSLY through both "
            "transitions, not just at end-state convergence",
            duration=12.0,
            events=[
                ChaosEvent(3.0, "stop_replica", {"node": 2}),
                ChaosEvent(7.0, "start_replica", {"node": 2}),
            ],
            rate=80.0,
            min_availability=0.55,
        ),
        _p(
            "coalesce_flap_restart",
            "tcp",
            "Cross-session coalescing lane under compound adversity: a "
            "flapping partial partition (replica 2's links drop 100% in "
            "1s bursts) while a proposer restarts mid-run with decided "
            "coalesced waves whose durability barrier is still pending "
            "— parked windows must shed retryable (never duplicate-"
            "apply), multi-client waves must keep packing between "
            "flaps, and every covered session's Result must stay "
            "exactly-once through the WAL recovery",
            duration=12.0,
            events=[
                # flapping partial partition: 1s on / 1s off bursts
                ChaosEvent(1.0, "link_loss", {"src": 2, "dst": 0, "rate": 1.0}),
                ChaosEvent(1.0, "link_loss", {"src": 2, "dst": 1, "rate": 1.0}),
                ChaosEvent(2.0, "clear", {}),
                ChaosEvent(3.0, "link_loss", {"src": 2, "dst": 0, "rate": 1.0}),
                ChaosEvent(3.0, "link_loss", {"src": 2, "dst": 1, "rate": 1.0}),
                ChaosEvent(4.0, "clear", {}),
                # proposer restart mid-load: decided-but-barrier-pending
                # coalesced waves ride the WAL recovery
                ChaosEvent(6.0, "restart_replica", {"node": 0}),
                ChaosEvent(8.0, "link_loss", {"src": 2, "dst": 0, "rate": 1.0}),
                ChaosEvent(8.0, "link_loss", {"src": 2, "dst": 1, "rate": 1.0}),
                # cleared well before run end: the flapped replica's
                # catch-up sync must fit the convergence window even on
                # a loaded CI host
                ChaosEvent(9.0, "clear", {}),
            ],
            rate=80.0,
            min_availability=0.45,
            # pinned coalescing windows so multi-client packing is the
            # shape under test, not an arrival-rate accident
            gateway_overrides=(
                ("coalesce", True),
                ("coalesce_window", 0.02),
                ("coalesce_window_min", 0.02),
                # fast slowlog rotation so each attribution sample sees
                # only the last ~2s of exemplars (current + previous
                # window), not the whole run's tail
                ("slowlog_window", 1.0),
            ),
            # the proposer restart takes a member out of the watchdog's
            # alive set mid-run: ring_stale must fire in the fault
            # window and nothing may fire before the first event
            expect_watchdog=("ring_stale",),
            # attribution gate: while the faults are live the slow
            # tail's time must pile into the stall legs — proposals
            # waiting for a slot to open while the flapped/restarted
            # proposer recovers (propose_to_open), the WAL barrier
            # (fsync_barrier), and coalesce parking (coalesce_park).
            # WHICH of the three absorbs a given straggler depends on
            # where its wave was when the fault landed, so the gate
            # sums the set rather than asserting one label; after the
            # faults clear the sum must drop back inside the control
            # band
            expect_critpath=(
                "propose_to_open",
                "fsync_barrier",
                "coalesce_park",
            ),
        ),
        # -- device-mesh fabric (round 17: device KV + read-index lane) -
        _p(
            "mesh_device_read_lane",
            "mesh",
            "Device-plane read lane under replica loss and forced "
            "demotion: a colocated MeshEngine serves full-width SET "
            "waves plus GET waves off-consensus (zero slots) while a "
            "minority replica crashes out of the alive mask and "
            "recovers, then the device store is force-DEMOTED "
            "mid-window — parked probe reads must flush to the "
            "consensus path, the auto-repromote must re-engage the "
            "lane with reset write barriers, and the verify sweep "
            "gates on probe reads > 0 and zero lockstep divergences",
            duration=10.0,
            events=[
                ChaosEvent(2.0, "crash", {"node": 2}),
                ChaosEvent(4.0, "recover", {"node": 2}),
                ChaosEvent(6.0, "demote_device", {}),
            ],
            rate=60.0,
            batch=1,
            n_replicas=3,
            n_shards=4,
            min_availability=0.6,
        ),
        # -- routed fleet fabric (round 16: gateway tier + hash ring) ---
        _p(
            "routed_gateway_failover",
            "fleet",
            "Kill a fleet gateway mid-wave: clients follow MOVED / ring "
            "failover to the successor, whose replicated dedup ledger "
            "answers every redirected replay byte-identically — zero "
            "double-applies, zero lost acked Results (the post-run "
            "replay sweep is the gate), and goodput recovers once the "
            "survivors adopt the shrunken ring",
            duration=10.0,
            events=[
                ChaosEvent(4.0, "kill_gateway", {"gw": 0}),
            ],
            rate=80.0,
            n_gateways=2,
            min_availability=0.5,
            # the killed fleet gateway leaves the watchdog's alive set
            # for the rest of the run: ring_stale is the asserted kind
            expect_watchdog=("ring_stale",),
        ),
        # -- partitioned shard-group fabric (round 20: fleet/groups.py) -
        _p(
            "group_proposer_kill",
            "groups",
            "SIGKILL one consensus group's proposer replica mid-wave in "
            "a 2-group partitioned fleet: the victim group rides through "
            "on its surviving quorum while the OTHER group's goodput "
            "must hold inside the healthy control band (blast-radius "
            "isolation is the datum) — then the proposer restarts (WAL "
            "recovery) and a per-group exactly-once replay sweep "
            "re-submits every session's last acked seq through a "
            "DIFFERENT replica gateway of its group, expecting CACHED "
            "byte-identical answers and zero store mutation",
            duration=12.0,
            events=[
                ChaosEvent(4.0, "kill_group_proposer", {"group": 0}),
                ChaosEvent(8.0, "restart_group_proposer", {"group": 0}),
            ],
            # 2 groups x 3 replicas = 6 OS processes sharing whatever
            # cores the host has: offer modestly so the curve scores the
            # kill, not CPU starvation of the generator's own making
            rate=60.0,
            n_groups=2,
            min_availability=0.5,
            # the SIGKILLed proposer leaves the watchdog's per-process
            # alive set for the kill window: ring_stale is the asserted
            # kind, and nothing may fire in the healthy control prefix
            expect_watchdog=("ring_stale",),
        ),
        _p(
            "rolling_restart",
            "tcp",
            "Rolling restart under load: each replica in turn restarts "
            "(WAL recovery, port rebind, peer redial) while clients keep "
            "submitting — the zero-downtime-deploy drill",
            duration=12.0,
            events=[
                ChaosEvent(2.0, "restart_replica", {"node": 0}),
                ChaosEvent(6.0, "restart_replica", {"node": 1}),
                ChaosEvent(10.0, "restart_replica", {"node": 2}),
            ],
            rate=80.0,
            min_availability=0.5,
        ),
    ]
    return {p.name: p for p in profiles}


def smoke_profiles() -> dict[str, ChaosProfile]:
    """The CI smoke subset: 7 short profiles — one simulator adverse-net,
    one real-TCP shaped, one membership change under load, one routed
    gateway failover, the device-mesh read-lane drill, and the
    partitioned-group proposer kill — time-scaled to keep the cell
    under a couple of minutes."""
    all_p = default_profiles()
    out = {}
    for name, factor in (
        ("flapping_partition", 0.6),
        ("tcp_shaped_wan", 0.6),
        ("membership_elastic", 0.7),
        ("coalesce_flap_restart", 0.7),
        ("routed_gateway_failover", 0.7),
        ("mesh_device_read_lane", 0.6),
        ("group_proposer_kill", 0.7),
    ):
        out[name] = all_p[name].scaled(factor)
    return out


def get_profile(name: str) -> Optional[ChaosProfile]:
    return default_profiles().get(name)
