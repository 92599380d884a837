"""Configuration dataclass tree (a copy of the reference package's
``rabia_tpu/core/config.py``).

Reference parity: rabia-engine/src/config.rs:4-73 (RabiaConfig), nested
TcpNetworkConfig/RetryConfig/BufferConfig (rabia-engine/src/network/tcp.rs:
31-112), BatchConfig (rabia-core/src/batching.rs:8-29), ValidationConfig
(rabia-core/src/validation.rs:9-28), SerializationConfig
(rabia-core/src/serialization.rs:100-114), KVStoreConfig
(rabia-kvstore/src/store.rs:18-42), PoolConfig (memory_pool.rs:13-30).

New here: :class:`KernelConfig` and :class:`MeshConfig` — the TPU shard-axis
and device-mesh settings the reference has no analog for.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class RetryConfig:
    """Connection retry/backoff (tcp.rs:54-72)."""

    max_attempts: int = 5
    base_delay: float = 0.1  # seconds; doubles each attempt
    backoff_multiplier: float = 2.0
    max_delay: float = 30.0

    def delay_for_attempt(self, attempt: int) -> float:
        return min(
            self.base_delay * (self.backoff_multiplier ** max(0, attempt)),
            self.max_delay,
        )


@dataclass(frozen=True)
class BufferConfig:
    """Transport buffer sizing (tcp.rs:94-112)."""

    read_buffer_size: int = 64 * 1024
    write_buffer_size: int = 64 * 1024
    max_frame_size: int = 16 * 1024 * 1024  # 16MB frame cap (tcp.rs:86,125)


def _ci_scaled(base: float) -> float:
    """CI environments get stretched timeouts (tcp.rs:74-79 analog)."""
    return base * 3.0 if os.environ.get("CI") else base


@dataclass(frozen=True)
class TcpNetworkConfig:
    """TCP transport settings (tcp.rs:31-92)."""

    bind_host: str = "127.0.0.1"
    bind_port: int = 0  # 0 = ephemeral; actual port recorded after bind
    connect_timeout: float = field(default_factory=lambda: _ci_scaled(5.0))
    handshake_timeout: float = field(default_factory=lambda: _ci_scaled(5.0))
    keepalive_interval: float = 10.0
    stale_connection_age: float = 60.0
    retry: RetryConfig = RetryConfig()
    buffers: BufferConfig = BufferConfig()


@dataclass(frozen=True)
class BatchConfig:
    """Command batching (batching.rs:8-29)."""

    max_batch_size: int = 100
    max_batch_delay: float = 0.010  # 10ms
    buffer_capacity: int = 1000
    adaptive: bool = True
    # adaptive sizing bounds (batching.rs:150-165 keeps size within [10, 1000]
    # and nudges by ±10% from the flush-cause ratio)
    min_adaptive_size: int = 10
    max_adaptive_size: int = 1000
    adaptive_step: float = 0.10


@dataclass(frozen=True)
class ValidationConfig:
    """Ingest validation limits (validation.rs:9-28)."""

    max_future_skew: float = 60.0  # reject msgs >60s in the future
    max_age: float = 600.0  # reject msgs older than 10 min
    max_commands_per_batch: int = 1000
    max_command_size: int = 1024 * 1024  # 1MB per command
    max_phase_jump: int = 1000  # suspicious phase jump threshold


@dataclass(frozen=True)
class SerializationConfig:
    """Codec selection (serialization.rs:100-114)."""

    use_binary: bool = True
    compression_threshold: int = 4096  # compress payloads larger than this


@dataclass(frozen=True)
class KVStoreConfig:
    """KV store limits (store.rs:18-42)."""

    max_keys: int = 1_000_000
    max_value_size: int = 1024 * 1024
    max_key_length: int = 256
    snapshot_frequency: int = 10_000
    notifications_enabled: bool = True
    num_shards: int = 1  # key-range shards == consensus instances


@dataclass(frozen=True)
class PoolConfig:
    """Host buffer-pool tiers (memory_pool.rs:13-30)."""

    small_size: int = 1024
    medium_size: int = 8 * 1024
    large_size: int = 64 * 1024
    max_pooled_per_tier: int = 100


@dataclass(frozen=True)
class KernelConfig:
    """JAX batched phase-driver settings (no reference analog).

    ``num_shards`` is padded up to ``shard_pad_multiple`` so shapes stay
    static across membership/load changes; ``coin_p1`` is the common-coin
    probability of V1 (the Ivy coin — docs/weak_mvc.ivy:169-182 — is an
    arbitrary non-question value; 0.5 is the paper's fair coin).
    """

    num_shards: int = 1
    shard_pad_multiple: int = 8
    coin_p1: float = 0.5
    seed: int = 0
    max_phases_per_step: int = 1  # full weak-MVC phases evaluated per kernel call
    dtype_votes: str = "int8"
    # engine kernel implementation: "host" = the numpy HostNodeKernel
    # (host round pacing, no per-round device dispatch). The reference's
    # "jax" (its node kernel on the device) is not ported: the port's
    # engine refuses it (ROADMAP Queue 1 item 8).
    backend: str = "host"
    # the reference's "jax" backend settings, kept so configurations
    # carry over: kernel substeps chained in one device dispatch, and the
    # inbox planes handed to the device by dlpack. The port's engine
    # refuses zero_copy_inbox=True with backend="jax".
    device_substeps: int = 3
    zero_copy_inbox: bool = False

    @property
    def padded_shards(self) -> int:
        m = self.shard_pad_multiple
        return max(m, (self.num_shards + m - 1) // m * m)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip execution (no reference analog).

    ``shard_axis`` devices partition the S axis; ``replica_axis`` devices
    partition the R axis (vote exchange = psum over this axis). Axis sizes of
    1 collapse to single-device vmap mode.
    """

    shard_axis_size: int = 1
    replica_axis_size: int = 1
    shard_axis_name: str = "shard"
    replica_axis_name: str = "replica"


@dataclass(frozen=True)
class RabiaConfig:
    """Top-level engine configuration (config.rs:4-37)."""

    phase_timeout: float = 5.0
    sync_timeout: float = 10.0
    # committed-slot lag vs the most advanced peer that triggers a snapshot
    # sync (a shard mid-decision naturally lags ~1; 3 = genuinely behind)
    sync_lag_slots: int = 3
    max_batch_size: int = 1000
    max_pending_batches: int = 100
    cleanup_interval: float = 30.0
    max_phase_history: int = 1000
    heartbeat_interval: float = 1.0
    randomization_seed: Optional[int] = None
    round_interval: float = 0.001  # host pacing of kernel rounds (engine.rs:233 analog)
    # the write-ahead vote barrier is persisted this many slots AHEAD of the
    # opened slot so one fsync amortizes over K opens per shard (a restart
    # taints at most K-1 extra slots, resolved by the taint-release window)
    barrier_stride: int = 64
    # taint-release window factor: a restored replica re-votes in a tainted
    # slot only after taint_release_factor * phase_timeout passes with NO
    # tainted-slot vote traffic (4x longer still when any member is out of
    # view — an absent peer is exactly the one that could hold pre-crash
    # votes). SAFETY ASSUMPTION (partial synchrony): an in-flight peer
    # retransmits every phase_timeout, so a quiet window many times that
    # implies nobody live still holds this replica's pre-crash votes. A
    # CONNECTED peer stalled longer than the window (GC pause) that later
    # resurrects an old vote can still violate the guard — set math.inf
    # for fully-asynchronous safety (tainted slots then resolve only via
    # adopted Decisions or snapshot sync, and a shard whose rotation parks
    # on the restored replica waits for peers).
    taint_release_factor: float = 16.0
    # broadcast Decision messages for newly decided slots (engine.rs:667-679
    # parity). In the dense lockstep regime every replica decides each slot
    # itself from round-2 votes, making the broadcast redundant; with False,
    # stragglers recover via the targeted stale-vote repair (decided-value
    # ring) and snapshot sync. Keep True for sparse/lossy deployments where
    # proactive decision propagation shortens catch-up.
    decision_broadcast: bool = True
    # thread-per-shard-group native runtime: number of C worker threads,
    # each owning a contiguous shard group end-to-end (ingest → tick →
    # apply → result staging). None = auto: min(shards, max(1, cores-1))
    # — one core is left for the Python control plane; on hosts with
    # <= 2 cores auto resolves to 1 (the single-thread runtime, which is
    # byte-for-byte the historical behavior). The RABIA_RT_WORKERS env
    # var overrides this knob; workers cap at min(64, num_shards).
    runtime_workers: Optional[int] = None
    # shard-group scale-out (fleet/groups.py): the consensus group this
    # engine's replica set belongs to in a partitioned deployment. The
    # engine itself is group-agnostic (it still runs the full global
    # shard space — unowned shards simply stay idle); the id scopes
    # health documents, per-group metric attribution, and WAL/test
    # tooling that must tell sibling groups apart. None = ungrouped.
    group_id: Optional[int] = None
    tcp: TcpNetworkConfig = TcpNetworkConfig()
    batching: BatchConfig = BatchConfig()
    validation: ValidationConfig = ValidationConfig()
    serialization: SerializationConfig = SerializationConfig()
    kernel: KernelConfig = KernelConfig()
    mesh: MeshConfig = MeshConfig()

    # builder-style helpers (config.rs:39-73)
    def with_seed(self, seed: int) -> "RabiaConfig":
        return replace(self, randomization_seed=seed)

    def with_phase_timeout(self, seconds: float) -> "RabiaConfig":
        return replace(self, phase_timeout=seconds)

    def with_heartbeat_interval(self, seconds: float) -> "RabiaConfig":
        return replace(self, heartbeat_interval=seconds)

    def with_shards(self, num_shards: int) -> "RabiaConfig":
        return replace(self, kernel=replace(self.kernel, num_shards=num_shards))

    def with_kernel(self, **kw) -> "RabiaConfig":
        return replace(self, kernel=replace(self.kernel, **kw))
