"""GatewayServer: the replica's client-facing front door.

One gateway runs next to each :class:`~rabia_tpu_torch.engine.RabiaEngine`
replica, on its OWN native transport instance (own node id, own port) —
client traffic never rides the consensus plane's broadcast fan-out and
the engine's message loop never sees a client frame. The gateway talks
to its engine in-process and to peer gateways over the wire (read-index
frontier probes).

Three request paths:

- **Submit** — exactly-once writes. The session table answers duplicate
  ``(client_id, seq)`` submissions from cache (or attaches them to the
  in-flight proposal); fresh seqs go through admission control and then
  ``engine.submit_batch``.
- **ReadIndex (READ)** — linearizable GETs with no consensus slot
  consumed. The gateway probes a quorum of gateways for their potential
  decided frontiers (:meth:`RabiaEngine.decided_frontier`), takes the
  per-shard max as the read index, waits until the local applied
  frontier covers it, and serves the value from the local state machine.
  Quorum intersection makes this linearizable: every write committed
  before the probe has a round-2 quorum, and any probed quorum shares a
  member with it that reports a frontier above the write's slot.
  Probe rounds are shared by every read that arrived before the round
  started — read throughput is decoupled from the probe RTT.
- **Admission control** — a bounded per-session inflight window plus an
  engine queue-depth ceiling; both shed load with a retryable
  ``ResultStatus.RETRY`` before the engine inbox saturates.

The port's copy of the reference's ``rabia_tpu/gateway/server.py``, its imports
retargeted to ``rabia_tpu_torch`` and its native library the port's own;
``devkv_read_handler`` reads the port's device tensors back to the host,
and while a restarted replica's frontier is floored at its vote barrier
(``RabiaEngine.frontier_floored``) its gateway takes its read index from a
quorum of the other replicas and abstains from their probes.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from rabia_tpu_torch.core.config import TcpNetworkConfig
from rabia_tpu_torch.core.errors import (
    RabiaError,
    ResponsesUnavailableError,
    TimeoutError_,
)
from rabia_tpu_torch.core.messages import (
    AdminKind,
    AdminRequest,
    AdminResponse,
    ClientHello,
    ProtocolMessage,
    ReadIndex,
    ReadIndexMode,
    Result,
    ResultStatus,
    Submit,
)
from rabia_tpu_torch.core.serialization import Serializer
from rabia_tpu_torch.core.types import (
    BatchId,
    Command,
    CommandBatch,
    NodeId,
    ShardId,
)
from rabia_tpu_torch.gateway.session import (
    SUBMIT_DUP_CACHED,
    SUBMIT_DUP_INFLIGHT,
    SUBMIT_FRESH,
    SUBMIT_SHED_WINDOW,
)
from rabia_tpu_torch.obs.flight import (
    FRE_BARRIER,
    FRE_GW_RECV,
    FRE_RESULT,
    batch_id_for,
    fr_hash,
)

logger = logging.getLogger("rabia_tpu_torch.gateway")

# reader: (shard, key bytes) -> encoded result bytes (the host store's
# binary result framing — byte-identical to a committed GET's response)
ReadHandler = Callable[[int, bytes], bytes]


@dataclass
class GatewayConfig:
    bind_host: str = "127.0.0.1"
    bind_port: int = 0  # ephemeral
    max_inflight_per_session: int = 64
    # shed Submits once the engine's local submission queues hold this
    # many batches (well under the native transport's 64Ki-frame inbox)
    max_queue_depth: int = 1024
    session_ttl: float = 600.0
    result_cache_cap: int = 4096
    # hard session lease (seconds): a session silent this long is dropped
    # by GC even with in-flight seqs, so a stalled frontier / wedged
    # engine cannot pin dead sessions forever. None = 4 x session_ttl.
    session_lease: Optional[float] = None
    # one probe round answers every read that arrived before it started;
    # a round that cannot assemble a quorum of frontiers by this deadline
    # fails those reads with a retryable RETRY
    probe_timeout: float = 2.0
    # how long a read may wait for the local applied frontier to cover
    # its read index before failing retryable
    read_timeout: float = 5.0
    gc_interval: float = 1.0
    # observability HTTP shim (obs/http.py): None = no HTTP listener
    # (the admin FRAMES on the native transport are always served);
    # 0 = bind an ephemeral port, exposed as GatewayServer.http_port
    http_port: Optional[int] = None
    http_host: str = "127.0.0.1"
    # per-second telemetry ring (obs/telemetry.TelemetrySampler): one
    # registry snapshot per interval into a bounded ring, served as
    # AdminKind.TIMELINE and /timeline. 0 disables the sampler.
    telemetry_interval: float = 1.0
    telemetry_cap: int = 900
    # thread-per-shard-group native runtime workers for engines built by
    # GatewayCluster from this config (None = the engine default /
    # RabiaConfig.runtime_workers / RABIA_RT_WORKERS — see
    # docs/PERFORMANCE.md "Thread-per-shard-group runtime")
    runtime_workers: Optional[int] = None
    # -- cross-session submit coalescing (docs/PERFORMANCE.md
    # "Coalescing tier"): eligible fresh binary-op Submits arriving
    # within a short adaptive window pack into ONE multi-client
    # PayloadBlock entry per shard — one consensus slot, one
    # sk_apply_wave, one durability-barrier wait for MANY sessions.
    # False = the per-submit lane only (the round-10 shape).
    coalesce: bool = True
    # latency budget: the LONGEST a parked Submit waits for its window
    # to fill; the adaptive window (sized from the eligible-arrival
    # rate EWMA) never exceeds it. None = auto: 2ms, raised to 8ms on
    # durable clusters (results there cannot leave before the fsync
    # barrier anyway, so a longer window is nearly free and buys
    # cross-session batching)
    coalesce_window: Optional[float] = None
    # adaptive floor: under dense arrivals the window shrinks toward
    # this instead of zero (a too-small window degenerates to solo)
    coalesce_window_min: float = 0.0005
    # ops budget per packed entry (clamped further to the engine's
    # max-batch validation limits at flush time)
    coalesce_max_ops: int = 128
    # bytes budget for a packed entry's command payloads
    coalesce_max_bytes: int = 256 * 1024
    # -- tail-exemplar slowlog (obs/critpath.py; AdminKind.SLOWLOG):
    # the gateway keeps a bounded reservoir of the SLOWEST fresh-Submit
    # completions per rotation window (batch id + wall time + outcome),
    # so p99 exemplars are capturable with no operator foreknowledge of
    # batch ids. Serving merges the live and previous windows — a fresh
    # rotation never empties the reply. 0 exemplars disables capture.
    slowlog_cap: int = 8
    slowlog_window: float = 10.0
    # -- shard-group scale-out (fleet/groups.py): when this replica
    # belongs to one consensus group of a partitioned deployment,
    # group_id names the group and group_shards lists the half-open
    # [lo, hi) global shard ranges the group owns. Submits outside the
    # owned ranges shed retryable (reason "group_range") — the router's
    # map flip re-aims the client's retry — and the coalescing lane
    # asserts every flushed window is group-local. The owned ranges are
    # RUNTIME-UPDATABLE via the AdminKind.RING {"op": "set_group"}
    # frame (rebalance widens the new owner before the route flips).
    # None = ungrouped (the classic whole-shard-space replica).
    group_id: Optional[int] = None
    group_shards: Optional[tuple[tuple[int, int], ...]] = None


class _SlowlogReservoir:
    """Per-window bounded reservoir of the slowest completions.

    ``observe`` is the hot call: one comparison against the window's
    current floor in the common case (a completion faster than every
    kept exemplar). The reservoir keeps the ``cap`` slowest entries of
    the live window and rotates on a wall cadence, retaining exactly one
    previous window so a scrape right after rotation still sees the
    recent tail. Exemplar documents are JSON-ready plain dicts."""

    __slots__ = (
        "cap", "window", "_cur", "_prev", "_floor", "_window_start",
        "observed", "rotations",
    )

    def __init__(self, cap: int, window: float) -> None:
        self.cap = cap
        self.window = window
        self._cur: list[tuple[float, dict, float]] = []
        self._prev: list[tuple[float, dict, float]] = []
        self._floor = 0.0
        self._window_start = time.monotonic()
        self.observed = 0
        self.rotations = 0

    def _rotate_if_due(self, now: float) -> None:
        if now - self._window_start < self.window:
            return
        self._prev = self._cur
        self._cur = []
        self._floor = 0.0
        self._window_start = now
        self.rotations += 1

    def observe(self, wall_s: float, exemplar: dict) -> None:
        if self.cap <= 0:
            return
        self.observed += 1
        now = time.monotonic()
        self._rotate_if_due(now)
        cur = self._cur
        if len(cur) >= self.cap:
            if wall_s <= self._floor:
                return
            # evict the fastest kept exemplar (linear over a tiny cap)
            cur.pop(min(range(len(cur)), key=lambda i: cur[i][0]))
        cur.append((wall_s, exemplar, now))
        self._floor = min(w for w, _, _ in cur) if len(cur) >= self.cap \
            else 0.0

    def document(self, last: Optional[int] = None) -> dict:
        """The AdminKind.SLOWLOG reply body: live + previous windows,
        slowest first, with the serve-time clock pair the collector
        aligns with (the TraceSlice convention)."""
        now = time.monotonic()
        self._rotate_if_due(now)
        ex = sorted(
            self._cur + self._prev, key=lambda e: -e[0]
        )
        if last is not None:
            ex = ex[: max(0, last)]
        return {
            "version": 1,
            "cap": self.cap,
            "window_s": self.window,
            "observed": self.observed,
            "rotations": self.rotations,
            "wall": time.time(),
            "mono_ns": time.monotonic_ns(),
            "exemplars": [
                dict(e, wall_s=w, age_s=round(now - at, 3))
                for w, e, at in ex
            ],
        }


@dataclass
class GatewayStats:
    submits: int = 0
    submits_deduped: int = 0
    submits_shed: int = 0
    reads: int = 0
    reads_failed: int = 0
    probe_rounds: int = 0
    results_sent: int = 0
    results_repaired: int = 0  # fetched from a peer after a sync overtake
    submits_coalesced: int = 0  # submits that rode a multi-client wave
    coalesce_waves: int = 0  # multi-client waves proposed
    reads_batched: int = 0  # reads served via the handler's read_many batch


@dataclass
class GatewayEndpoint:
    """Address card for one gateway (what a client/peer needs to dial)."""

    node_id: NodeId
    host: str
    port: int


def kv_read_handler(sm) -> ReadHandler:
    """Default read handler over a sharded KV state machine
    (:class:`~rabia_tpu_torch.apps.sharded.ShardedStateMachine` of
    ``KVStoreSMR`` shards): serve GETs straight from the shard's host
    store, framed byte-identically to a committed GET response. A
    device-lane deployment (apps/device_kv) plugs in a handler backed by
    the device table's GET lane here instead — the gateway only needs
    the ``(shard, key) -> result bytes`` seam."""
    from rabia_tpu_torch.apps.kvstore import KVResultKind, _result_bin

    machines = getattr(sm, "machines", None)
    if machines is None:
        raise TypeError(
            "kv_read_handler needs a sharded state machine with .machines"
        )

    def read(shard: int, key: bytes) -> bytes:
        store = machines[shard % len(machines)].store
        try:
            k = key.decode()
        except UnicodeDecodeError:
            return _result_bin(2, 0, "malformed key")
        if getattr(store, "is_native", False):
            # native apply plane: one borrowed C lookup, result framed
            # directly — no op encode/apply/decode round trip. Stats
            # are counted like KVStore.get so the two store paths stay
            # parity-comparable.
            plane, idx = store.plane, store.idx
            got = plane.get(idx, key)
            plane.add_stats(idx, 1, 1, 0)
            if got is None:
                return _result_bin(1, 0)
            val, ver = got
            return (
                b"\x00"
                + (ver & 0xFFFFFFFF).to_bytes(4, "little")
                + b"\x01"
                + val
            )
        res = store.get(k)
        if res.kind == KVResultKind.NotFound:
            return _result_bin(1, 0)
        return _result_bin(0, res.version or 0, res.value)

    return read


def devkv_read_handler(engine) -> ReadHandler:
    """Read handler over a device-store MeshEngine
    (:class:`~rabia_tpu_torch.parallel.mesh_engine.MeshEngine` with
    ``device_store=True``): probe-covered GETs are answered by a
    consensus-free ``lookup_only`` dispatch against the device-resident
    table — zero consensus slots, zero collectives in the program —
    with meta-only readback (~5 bytes/op) and host-segment value
    resolution (value planes download only on the eviction edge).

    The handler also exposes ``read_many`` so the gateway batches ALL
    reads covered by one probe round into a SINGLE device dispatch: one
    plane fetch per probe window instead of one per read. With the
    device lane demoted, reads fall back to the host replica store (the
    semantics owner, synced at demotion). Drive the engine and this
    handler from one thread — the device table is not locked."""
    from rabia_tpu_torch.apps.device_kv import _bucket, _get_frame

    def _host_one(shard: int, key: bytes) -> bytes:
        got = engine.sms[0].store.get(shard, key)
        if got is None:
            return _get_frame(False, 0, b"")
        val, ver = got
        return _get_frame(True, ver, val)

    def read_many(items: list) -> list:
        if engine._dev is None or not engine._dev_active:
            return [_host_one(s, k) for s, k in items]
        dev = engine._dev
        W = engine.window
        out: list = [None] * len(items)
        sel = []
        for i, (s, k) in enumerate(items):
            if len(k) > dev.K or not (0 <= s < engine.n_shards):
                # a key wider than the table's lanes cannot have been
                # SET while the lane is active (it would have demoted):
                # not-found by construction, no dispatch needed
                out[i] = _get_frame(False, 0, b"")
            else:
                sel.append(i)
        if not sel:
            return out
        # wave-pack: at most one key per shard per wave (the lookup
        # program's shape); duplicate-shard reads spill to later waves
        waves: list[dict] = []
        for i in sel:
            s = items[i][0]
            for used in waves:
                if s not in used:
                    used[s] = i
                    break
            else:
                waves.append({s: i})
        Ku = min(
            _bucket(max(len(items[i][1]) for i in sel)), dev.K
        )
        for c0 in range(0, len(waves), W):
            chunk = waves[c0 : c0 + W]
            depth = len(chunk)
            klen = np.zeros((depth, dev.S), np.int16)
            kwin = np.zeros((depth, dev.S, Ku), np.uint8)
            for t, wv in enumerate(chunk):
                for s, i in wv.items():
                    k = items[i][1]
                    klen[t, s] = len(k)
                    kwin[t, s, : len(k)] = np.frombuffer(k, np.uint8)
            found_d, ver_d, vlen_d, valw_d = dev.lookup_only(
                (klen, np.ascontiguousarray(kwin).view(np.uint32)),
                W=W,
                state=engine._dev_chain_base(),
            )
            # the port's table returns device tensors: meta only comes
            # back here (the value planes on the eviction edge below)
            found = found_d.cpu().numpy()
            ver = ver_d.cpu().numpy()
            n_ops = sum(len(wv) for wv in chunk)
            engine._read_stats["probe"] += n_ops
            engine._read_stats["probe_windows"] += 1
            engine._h_read_batch.observe(float(depth))
            if engine._dev_unresolvable(found[:depth], ver[:depth]):
                # eviction edge: this window downloads the value planes
                engine._read_stats["fallback"] += n_ops
                resolver = None
                vlen = vlen_d.cpu().numpy()
                valb = np.ascontiguousarray(valw_d.cpu().numpy()).view(
                    np.uint8
                )
            else:
                resolver = engine._dev_make_resolver()
            for t, wv in enumerate(chunk):
                for s, i in wv.items():
                    f, v = bool(found[t, s]), int(ver[t, s])
                    if not f:
                        out[i] = _get_frame(False, 0, b"")
                    elif resolver is not None:
                        out[i] = _get_frame(True, v, resolver(s, v))
                    else:
                        out[i] = _get_frame(
                            True, v,
                            valb[t, s, : int(vlen[t, s])].tobytes(),
                        )
        return out

    def read(shard: int, key: bytes) -> bytes:
        return read_many([(shard, key)])[0]

    read.read_many = read_many  # the gateway's batched probe-round seam
    return read


_COAL_SHARD_FIELDS = ("waves", "covered", "solo", "scalar", "results_ok")
_COAL_SHARD_ZERO = {f: 0 for f in _COAL_SHARD_FIELDS}


class _CoalesceWindow:
    """One shard's open coalescing window: parked FRESH submits (their
    session reservations held), running op/byte totals, and the armed
    flush timer."""

    __slots__ = ("entries", "ops", "size", "timer")

    def __init__(self) -> None:
        self.entries: list = []  # (sender NodeId, Submit, t0 perf_counter)
        self.ops = 0
        self.size = 0
        self.timer = None  # asyncio.TimerHandle while armed


class _ProbeRound:
    """One in-flight frontier probe: nonce, collected reply vectors, and
    the waiters served by this round."""

    __slots__ = ("nonce", "replies", "done", "waiters", "started_at", "need")

    def __init__(self, nonce: int, waiters: list, need: int) -> None:
        self.nonce = nonce
        self.need = need  # peer replies that complete the round
        self.replies: dict[NodeId, np.ndarray] = {}
        self.done = asyncio.Event()
        self.waiters = waiters
        self.started_at = time.time()


class GatewayServer:
    """Client-facing service over one engine replica (see module doc)."""

    def __init__(
        self,
        engine,
        reader: Optional[ReadHandler] = None,
        config: Optional[GatewayConfig] = None,
        node_id: Optional[NodeId] = None,
    ) -> None:
        self.engine = engine
        self.config = config or GatewayConfig()
        self.node_id = node_id or NodeId.new()
        self.reader = reader if reader is not None else kv_read_handler(
            engine.sm
        )
        self.serializer = Serializer(engine.config.serialization)
        # the session/dedup table: the native C plane (sessionkernel.cpp)
        # when it builds, else the Python semantics owner
        # (RABIA_PY_GATEWAY=1 forces the latter)
        from rabia_tpu_torch.gateway.native_session import make_session_table

        self.sessions = make_session_table(
            default_window=self.config.max_inflight_per_session,
            session_ttl=self.config.session_ttl,
            result_cache_cap=self.config.result_cache_cap,
            lease_ttl=self.config.session_lease,
        )
        self.stats = GatewayStats()
        self._net = None
        self._peer_gateways: dict[NodeId, tuple[str, int]] = {}
        self._frontier_event = asyncio.Event()
        self._round: Optional[_ProbeRound] = None
        self._round_waiters: list[asyncio.Future] = []
        self._probe_kick = asyncio.Event()
        self._nonce = 0
        self._fetches: dict[int, asyncio.Future] = {}
        self._fetch_nonce = 0
        # reads in flight by (client_id, seq): client retransmits of a
        # slow read must attach to the original, not spawn parallel
        # probe rounds + reader calls (the read twin of sess.inflight)
        self._reads_inflight: set[tuple[uuid.UUID, int]] = set()
        # reads waiting for the next shared probe round: every GET that
        # arrived before the round starts is served by THAT round (one
        # quorum probe amortized over the whole window, Velos-style one-
        # sided reads) — no per-read task, no per-read future
        self._pending_reads: list[tuple[NodeId, ReadIndex]] = []
        # cross-session coalescing lane: per-shard open windows of
        # parked FRESH submits + per-shard eligible-arrival-rate EWMAs
        # that size the adaptive flush window and gate parking — sparse
        # lanes skip the window entirely on EVERY cluster flavor (no
        # batching chance means only the latency tax, and a parked solo
        # submit can miss its proposer-eligibility instant; see
        # _coal_add). Durable clusters merely get a LONGER default
        # window (below), engaged only once traffic is dense.
        self._coal: dict[int, _CoalesceWindow] = {}
        self._coal_rate: dict[int, float] = {}
        self._coal_last_arrival: dict[int, float] = {}
        self._coal_window_cfg = (
            self.config.coalesce_window
            if self.config.coalesce_window is not None
            else (0.008 if getattr(engine, "_wal", None) is not None
                  else 0.002)
        )
        # ops budget clamped to what submit_block will accept, so a
        # packed entry can never bounce off the engine's validators
        self._coal_max_ops = max(1, min(
            self.config.coalesce_max_ops,
            engine.config.max_batch_size,
            engine.config.validation.max_commands_per_batch,
        ))
        # an over-limit command must fail ITS OWN submit on the classic
        # lane, not poison window-mates with a batch-level rejection
        self._coal_max_cmd = engine.config.validation.max_command_size
        self.coalesce_outcomes: dict[str, int] = {
            "coalesced": 0,  # submits that rode a multi-client wave
            "solo": 0,       # windows that flushed with one submit
            "bypass": 0,     # eligible lane on, submit not packable
            "sparse": 0,     # density gate: parking would not batch
        }
        # per-SHARD coalescing/commit counters (fleet observability):
        # the fleet aggregator groups these by ring shard ownership to
        # attribute coalesce density and slots/op to the fleet gateway
        # that concentrated the traffic. "waves"+"scalar" is the
        # slots-proposed proxy for the shard (each wave and each
        # per-submit drive proposes exactly one consensus entry);
        # "covered" counts submits riding waves, "results_ok" the OK
        # results fanned out.
        self.coal_shard_stats: dict[int, dict[str, int]] = {}
        # serialization ns credited inside the current gateway stage
        # bracket (carved out so the two stages never double-count)
        self._ser_carve = 0
        # tail-exemplar slowlog: the slowest fresh-Submit completions
        # per rotation window, served over AdminKind.SLOWLOG so the
        # critpath decomposer (obs/critpath.py) can pick p99 exemplars
        # without knowing any batch id in advance
        self.slowlog = _SlowlogReservoir(
            self.config.slowlog_cap, self.config.slowlog_window
        )
        self._tasks: set = set()
        self._running = False
        self._run_task = None
        self._probe_task = None
        self._http = None
        self._telemetry = None
        # admission-control outcomes by reason (exported as
        # rabia_gateway_shed_total{reason=...} — today's sheds were only
        # visible to the shedding client as RETRY)
        self.shed_reasons: dict[str, int] = {
            "session_window": 0,
            "queue_depth": 0,
            "no_quorum": 0,
            "engine_reject": 0,
            "group_range": 0,
        }
        # shard-group locality enforcement (fleet/groups.py): the
        # half-open global shard ranges this replica's group owns.
        # None = ungrouped. Mutable at runtime (set_group admin) so a
        # rebalance can widen the new owner BEFORE the route flips.
        self._group_ranges: Optional[list[tuple[int, int]]] = (
            [(int(lo), int(hi)) for lo, hi in self.config.group_shards]
            if self.config.group_shards is not None
            else None
        )
        # observability: the gateway registers into ITS ENGINE's registry
        # so one scrape covers the whole replica (engine + transport
        # counter block + gateway). Registration is idempotent by metric
        # identity, so a gateway restart on the same engine re-binds.
        self.metrics = engine.metrics
        self._register_metrics()

    def _register_metrics(self) -> None:
        m = self.metrics
        st = self.stats
        for name, help_ in (
            ("submits", "Submit frames received"),
            ("submits_deduped", "Duplicate (client_id, seq) submits"),
            ("submits_shed", "Submits shed by admission control"),
            ("reads", "Linearizable READ requests"),
            ("reads_failed", "READs failed (retryable or terminal)"),
            ("reads_batched", "READs served via the reader's read_many "
             "batch (one device-plane dispatch per probe round)"),
            ("probe_rounds", "Read-index frontier probe rounds"),
            ("results_sent", "Result frames sent to clients"),
            ("results_repaired", "Results repaired from peer gateways"),
            ("submits_coalesced", "Submits committed via multi-client waves"),
            ("coalesce_waves", "Multi-client coalesced waves proposed"),
        ):
            m.counter(
                f"gateway_{name}_total", help_,
                fn=lambda n=name: getattr(st, n),
            )
        m.gauge(
            "gateway_sessions", "Live client sessions",
            fn=lambda: len(self.sessions),
        )
        m.gauge(
            "gateway_reads_inflight", "READs currently being driven",
            fn=lambda: len(self._reads_inflight),
        )
        # admission-control outcomes, by reason (stats.submits_shed stays
        # the total; the labeled family makes shed behavior scrapeable)
        for reason in self.shed_reasons:
            m.counter(
                "gateway_shed_total",
                "Submits shed by admission control, by reason",
                {"reason": reason},
                fn=lambda r=reason: self.shed_reasons[r],
            )
        # native session plane: the GWC_* counter block (sessionkernel.cpp)
        # read zero-copy at scrape time, one family per counter — absent
        # entirely when the Python table owns the plane (scrapes tell the
        # active plane from rabia_gateway_plane_native too)
        m.gauge(
            "gateway_plane_native",
            "1 when the C session/dedup table owns the gateway plane",
            fn=lambda: 1.0 if self.sessions.is_native else 0.0,
        )
        # shard-group membership (fleet/groups.py): exported only on
        # grouped replicas so every series scraped from this process
        # attributes to its group (fleet-top / burn-rate labels join on
        # it); ungrouped deployments keep their metric surface unchanged
        if self.config.group_id is not None:
            m.gauge(
                "gateway_group",
                "Shard-group id this replica's consensus group serves",
                fn=lambda: float(self.config.group_id),
            )
            m.gauge(
                "gateway_group_shards",
                "Global shards currently owned by this replica's group",
                fn=lambda: float(sum(
                    hi - lo for lo, hi in (self._group_ranges or [])
                )),
            )
        if self.sessions.is_native:
            from rabia_tpu_torch.gateway.native_session import GWC_COUNTER_NAMES

            for cname in GWC_COUNTER_NAMES:
                m.counter(
                    f"gateway_plane_{cname}_total",
                    "Native gateway session plane counter "
                    "(sessionkernel.cpp GWC block)",
                    fn=lambda c=cname: self.sessions.counters_dict().get(
                        c, 0
                    ),
                )
        # client-observed submit→result latency: the SLO evidence
        # plane's top stage (rabia_slo_seconds{stage="submit_result"}),
        # observed for every freshly driven submit — dedup cache hits
        # and sheds answer in microseconds and are counted by their own
        # families instead of skewing the commit-latency curve
        from rabia_tpu_torch.obs.registry import SLO_BUCKETS

        self._h_submit_result = m.histogram(
            "slo_seconds",
            "SLO latency histograms by pipeline stage "
            "(log-bucketed; native RTH block + Python observes)",
            {"stage": "submit_result"},
            buckets=SLO_BUCKETS,
        )
        # cross-session coalescing lane (docs/OBSERVABILITY.md):
        # per-outcome submit counts and the submits-per-flush size
        # distribution. Slots-per-committed-op derives from these plus
        # the runtime's decided counters (rabia_engine_* / RKC block):
        # slots/op = Δdecided_v1 / Δ(ok results).
        for oc in self.coalesce_outcomes:
            m.counter(
                "coalesce_total",
                "Coalescing-lane submit outcomes "
                "(coalesced=rode a multi-client wave, solo=window of "
                "one, bypass=not packable)",
                {"outcome": oc},
                fn=lambda o=oc: self.coalesce_outcomes[o],
            )
        self._h_coal = m.histogram(
            "coalesce_batch_size",
            "Submits per coalescing-window flush (1 = solo)",
            buckets=[1, 2, 4, 8, 16, 32, 64, 128, 256],
        )
        # per-shard coalescing/commit counters, one series per (shard,
        # field) — the fleet aggregator's per-gateway attribution input
        # (see coal_shard_stats above). Registered for every shard up
        # front so scrapes see zeros, not absences, before traffic.
        for s in range(self.engine.n_shards):
            for fld in _COAL_SHARD_FIELDS:
                m.counter(
                    "coalesce_shard_total",
                    "Per-shard coalescing-lane counters "
                    "(waves=multi-client flushes, covered=submits "
                    "riding waves, solo=windows of one, scalar="
                    "per-submit proposals, results_ok=OK results)",
                    {"shard": str(s), "field": fld},
                    fn=lambda s=s, f=fld: self.coal_shard_stats.get(
                        s, _COAL_SHARD_ZERO
                    )[f],
                )

    # -- observability surface ----------------------------------------------

    def health(self) -> dict:
        """The /healthz document: the engine's health plus the gateway's
        client-facing view."""
        doc = self.engine.health()
        # the gateway plane joins the engine's plane ground truth (an
        # env toggle or a silent sessionkernel build failure both read
        # as "python" here — the loadgen CI gate checks this key)
        doc.setdefault("planes", {})["gateway"] = (
            "native" if self.sessions.is_native else "python"
        )
        doc["gateway"] = {
            "node": str(self.node_id.value),
            "port": self.port,
            "sessions": len(self.sessions),
            "peer_gateways": len(self._peer_gateways),
            "submits": self.stats.submits,
            "reads": self.stats.reads,
            "reads_batched": self.stats.reads_batched,
        }
        if self.config.group_id is not None:
            doc["gateway"]["group"] = {
                "id": self.config.group_id,
                "shards": [
                    [lo, hi] for lo, hi in (self._group_ranges or [])
                ],
            }
        return doc

    def _group_owns(self, shard: int) -> bool:
        if self._group_ranges is None:
            return True
        return any(lo <= shard < hi for lo, hi in self._group_ranges)

    def _admin_body(self, kind: int, query: bytes = b"") -> tuple[int, bytes]:
        import json

        if kind == AdminKind.METRICS:
            return 0, self.metrics.render_prometheus().encode()
        if kind == AdminKind.HEALTH:
            return 0, json.dumps(self.health()).encode()
        if kind == AdminKind.JOURNAL:
            jkind, last = None, 64
            if query:
                try:
                    q = json.loads(query)
                    jkind = q.get("kind")
                    last = max(0, int(q.get("last", 64)))
                except (ValueError, TypeError, AttributeError):
                    return 1, b"malformed journal query"
            return 0, json.dumps(
                {
                    "anomalies": self.engine.journal.snapshot(
                        limit=last, kind=jkind
                    )
                }
            ).encode()
        if kind == AdminKind.TRACE:
            # TraceQuery -> TraceSlice (obs/flight): the query names a
            # batch by session coordinates (ids derive deterministically,
            # so any replica can compute the hash) or by batch id hex
            from rabia_tpu_torch.obs.flight import (
                batch_id_for,
                build_trace_slice,
            )

            try:
                q = json.loads(query) if query else {}
                if "batch" in q:
                    bid = uuid.UUID(hex=q["batch"])
                else:
                    bid = batch_id_for(
                        uuid.UUID(hex=q["client"]), int(q["seq"])
                    )
            except (ValueError, TypeError, KeyError):
                return 1, b"malformed trace query"
            doc = build_trace_slice(self.engine, fr_hash(bid))
            doc["gateway"] = str(self.node_id.value)
            doc["batch_id"] = bid.hex
            return 0, json.dumps(doc).encode()
        if kind == AdminKind.TIMELINE:
            if self._telemetry is None:
                return 1, b"telemetry sampler disabled"
            last = None
            if query:
                try:
                    last = json.loads(query).get("last")
                    # "last" is optional: {} serves the full ring, same
                    # as an empty query
                    if last is not None:
                        last = int(last)
                except (ValueError, TypeError, AttributeError):
                    return 1, b"malformed timeline query"
            return 0, json.dumps(self._telemetry.document(last)).encode()
        if kind == AdminKind.SLOWLOG:
            last = None
            if query:
                try:
                    last = json.loads(query).get("last")
                    if last is not None:
                        last = int(last)
                except (ValueError, TypeError, AttributeError):
                    return 1, b"malformed slowlog query"
            doc = self.slowlog.document(last)
            doc["node"] = str(self.node_id.value)
            return 0, json.dumps(doc).encode()
        if kind == AdminKind.RING:
            # the replica-side slice of the shard-group plane: a plain
            # get answers the group card; {"op": "set_group"} adopts
            # new owned ranges — the widen-the-new-owner-first step of
            # a group rebalance (fleet/groups.py), pushed BEFORE the
            # routing tier flips its GroupMap
            try:
                q = json.loads(query) if query else {}
            except (ValueError, TypeError):
                return 1, b"malformed ring query"
            if q.get("op") == "set_group":
                if self.config.group_id is None:
                    return 1, b"replica is not grouped"
                try:
                    ranges = [
                        (int(lo), int(hi)) for lo, hi in q["shards"]
                    ]
                except (ValueError, TypeError, KeyError):
                    return 1, b"malformed set_group ranges"
                for lo, hi in ranges:
                    if not (0 <= lo < hi <= self.engine.n_shards):
                        return 1, b"set_group range out of shard space"
                self._group_ranges = ranges
            return 0, json.dumps({
                "group": self.config.group_id,
                "shards": (
                    [[lo, hi] for lo, hi in self._group_ranges]
                    if self._group_ranges is not None
                    else None
                ),
                "n_shards": self.engine.n_shards,
                "node": str(self.node_id.value),
            }).encode()
        return 1, f"unknown admin kind {kind}".encode()

    def _on_admin(self, sender: NodeId, p: AdminRequest) -> None:
        """Serve one admin document as a framed response. Read-only and
        unauthenticated by design (same trust domain as the scrape shim);
        anything beyond the known kinds answers status=1."""
        if p.kind == AdminKind.TIMELINE and self._telemetry is not None:
            # an unbounded ring is up to cap (900) registry snapshots —
            # multi-MB of dict building + json.dumps; done inline it
            # stalls the loop driving submits/results and perturbs the
            # very curves the timeline measures. The document build only
            # touches the sampler's deque (already read from a foreign
            # thread by the sampler contract), so serve it off-loop.
            self._spawn(self._serve_admin_offloop(sender, p))
            return
        try:
            status, body = self._admin_body(p.kind, p.query)
        except Exception as e:  # a broken provider must still answer
            logger.exception("admin request failed")
            status, body = 1, f"admin handler failed: {e}".encode()
        self._send(
            AdminResponse(nonce=p.nonce, status=status, body=body), sender
        )

    async def _serve_admin_offloop(
        self, sender: NodeId, p: AdminRequest
    ) -> None:
        loop = asyncio.get_running_loop()
        try:
            status, body = await loop.run_in_executor(
                None, self._admin_body, p.kind, p.query
            )
        except Exception as e:  # a broken provider must still answer
            logger.exception("admin request failed")
            status, body = 1, f"admin handler failed: {e}".encode()
        self._send(
            AdminResponse(nonce=p.nonce, status=status, body=body), sender
        )

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        from rabia_tpu_torch.net.tcp import TcpNetwork

        self._net = TcpNetwork(
            self.node_id,
            TcpNetworkConfig(
                bind_host=self.config.bind_host,
                bind_port=self.config.bind_port,
            ),
        )
        self.engine.add_frontier_listener(self._frontier_event.set)
        if self.config.telemetry_interval > 0 and self._telemetry is None:
            from rabia_tpu_torch.obs import TelemetrySampler

            self._telemetry = TelemetrySampler(
                self.metrics,
                node=str(self.engine.node_id.value),
                interval=self.config.telemetry_interval,
                cap=self.config.telemetry_cap,
            ).start()
        if self.config.http_port is not None and self._http is None:
            from rabia_tpu_torch.obs import AdminHTTPServer

            self._http = AdminHTTPServer(
                self.metrics,
                health_fn=self.health,
                journal=self.engine.journal,
                host=self.config.http_host,
                port=self.config.http_port,
                timeline_fn=(
                    (lambda last: self._telemetry.document(last))
                    if self._telemetry is not None
                    else None
                ),
            )
        self._running = True
        self._run_task = asyncio.ensure_future(self._run())
        self._probe_task = asyncio.ensure_future(self._probe_loop())

    @property
    def http_port(self) -> int:
        """Bound port of the observability HTTP shim (0 when disabled)."""
        return self._http.port if self._http is not None else 0

    @property
    def port(self) -> int:
        return self._net.port if self._net is not None else 0

    @property
    def endpoint(self) -> GatewayEndpoint:
        return GatewayEndpoint(
            self.node_id, self.config.bind_host, self.port
        )

    def add_peer_gateway(
        self, node_id: NodeId, host: str, port: int
    ) -> None:
        """Register a peer replica's gateway (read-index probe quorum)."""
        self._peer_gateways[node_id] = (host, port)
        self._net.add_peer(node_id, host, port)

    async def close(self) -> None:
        self._running = False
        # open coalescing windows: nothing in them was proposed — shed
        # the parked submits retryable while the transport still sends
        self._coal_abort_all()
        if self._http is not None:
            self._http.close()
            self._http = None
        if self._telemetry is not None:
            # final flush so the ring covers the run's last instant even
            # when the gateway closes between 1 Hz samples
            self._telemetry.sample()
            self._telemetry.close()
            self._telemetry = None
        self.engine.remove_frontier_listener(self._frontier_event.set)
        for t in (self._run_task, self._probe_task, *self._tasks):
            if t is not None:
                t.cancel()
        await asyncio.gather(
            *(t for t in (self._run_task, self._probe_task, *self._tasks) if t),
            return_exceptions=True,
        )
        self._tasks.clear()
        if self._net is not None:
            await self._net.close()
            self._net = None
        closer = getattr(self.sessions, "close", None)
        if closer is not None:
            # native plane: freeze the GWC counter block for late scrapes
            # and free the C table
            closer()

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # -- receive loop -------------------------------------------------------

    async def _run(self) -> None:
        pcns = time.perf_counter_ns
        last_gc = time.time()
        while self._running:
            try:
                sender, data = await self._net.receive(
                    timeout=self.config.gc_interval
                )
            except TimeoutError_:
                sender = None
            except asyncio.CancelledError:
                return
            if sender is not None:
                # stage profiler: the control-plane work the r09 profile
                # buried in `other` — codec time as "serialization",
                # dispatch + session/table work as "gateway"
                t0 = pcns()
                try:
                    msg = self.serializer.deserialize(data)
                except RabiaError as e:
                    self._stg_ser(pcns() - t0)
                    logger.warning(
                        "gateway %s: dropping bad frame from %s: %s",
                        self.node_id.short(),
                        sender,
                        e,
                    )
                else:
                    self._stg_ser(pcns() - t0)
                    t1 = pcns()
                    self._ser_carve = 0
                    self._handle(sender, msg)
                    self._stg_gw(pcns() - t1)
            now = time.time()
            if now - last_gc >= self.config.gc_interval:
                last_gc = now
                t0 = pcns()
                self.sessions.gc(self.engine.rt.state_version, now)
                self._ser_carve = 0
                self._stg_gw(pcns() - t0)

    # -- stage accounting (asyncio-owner control plane) ---------------------
    #
    # The gateway shares the engine's asyncio loop; its work used to land
    # in the runtime stage profiler's `other` remainder. These helpers
    # credit the named "serialization"/"gateway" stages on the ENGINE's
    # accounting (engine._stg_ext excludes the ns from `other`), with
    # serialization carved out of enclosing gateway brackets so nested
    # _send() serializes never double-count.

    def _stg_ser(self, ns: int) -> None:
        f = getattr(self.engine, "_stg_ext", None)
        if f is not None:
            self._ser_carve += ns
            f("serialization", ns)

    def _stg_gw(self, ns: int) -> None:
        f = getattr(self.engine, "_stg_ext", None)
        if f is not None:
            ns -= self._ser_carve
            self._ser_carve = 0
            if ns > 0:
                f("gateway", ns)

    def _stg_rp(self, ns: int) -> None:
        # "read_probe": serving probe-covered reads through the read
        # handler (the device read-index lane's host-side cost); nested
        # _send_result serializes carve out like the gateway bracket
        f = getattr(self.engine, "_stg_ext", None)
        if f is not None:
            ns -= self._ser_carve
            self._ser_carve = 0
            if ns > 0:
                f("read_probe", ns)

    def _handle(self, sender: NodeId, msg: ProtocolMessage) -> None:
        p = msg.payload
        if isinstance(p, (ClientHello, Submit)) or (
            isinstance(p, ReadIndex) and p.mode == ReadIndexMode.READ
        ):
            # a client's transport identity IS its session id (the client
            # library dials with NodeId(client_id)); mismatches would let
            # one client replay into another's session
            if sender.value != p.client_id:
                logger.warning(
                    "gateway %s: client frame session/transport mismatch "
                    "(%s via %s)",
                    self.node_id.short(),
                    p.client_id,
                    sender,
                )
                return
        if isinstance(p, ClientHello):
            self._on_hello(sender, p)
        elif isinstance(p, Submit):
            self._on_submit(sender, p)
        elif isinstance(p, ReadIndex):
            if p.mode == ReadIndexMode.READ:
                self._on_read(sender, p)
            elif p.mode == ReadIndexMode.PROBE:
                self._on_probe(sender, p)
            elif p.mode == ReadIndexMode.REPLY:
                self._on_probe_reply(sender, p)
            elif p.mode == ReadIndexMode.FETCH_RESULT:
                self._on_fetch_result(sender, p)
        elif isinstance(p, Result):
            # a peer gateway answering one of our result-repair fetches
            self._on_peer_result(sender, p)
        elif isinstance(p, AdminRequest):
            self._on_admin(sender, p)
        # anything else on the gateway port is noise; ignore

    def _send(self, payload, recipient: NodeId) -> None:
        msg = ProtocolMessage.new(self.node_id, payload, recipient)
        t0 = time.perf_counter_ns()
        data = self.serializer.serialize(msg)
        self._stg_ser(time.perf_counter_ns() - t0)
        try:
            self._net.send_to_nowait(recipient, data)
        except RabiaError:
            logger.warning(
                "gateway %s: send of %s to %s failed",
                self.node_id.short(),
                type(payload).__name__,
                recipient.short(),
            )

    def _send_result(
        self,
        recipient: NodeId,
        client_id: uuid.UUID,
        seq: int,
        status: int,
        payload: tuple[bytes, ...],
    ) -> None:
        self.stats.results_sent += 1
        self._send(
            Result(
                client_id=client_id, seq=seq, status=int(status),
                payload=payload,
            ),
            recipient,
        )

    # -- session / submit path ---------------------------------------------

    def _on_hello(self, sender: NodeId, p: ClientHello) -> None:
        window, last_seq = self.sessions.hello(p.client_id, p.max_inflight)
        self._send(
            ClientHello(
                client_id=p.client_id,
                ack=True,
                last_seq=last_seq,
                max_inflight=window,
            ),
            sender,
        )

    def _on_submit(self, sender: NodeId, p: Submit) -> None:
        self.stats.submits += 1
        # the submit hot path in ONE table op (native: one C call):
        # ensure/touch + ack advance + dedup classify + window check +
        # FRESH reservation
        decision, cstatus, cpayload = self.sessions.submit_check(
            p.client_id, p.seq, p.ack_upto
        )
        if decision == SUBMIT_DUP_CACHED:
            # exactly-once: a completed seq is answered from cache, never
            # re-proposed. OK results resend as CACHED so tests/clients
            # can observe the dedup; terminal errors resend as-is.
            self.stats.submits_deduped += 1
            status = (
                ResultStatus.CACHED
                if cstatus == ResultStatus.OK
                else cstatus
            )
            self._send_result(sender, p.client_id, p.seq, status, cpayload)
            return
        if decision == SUBMIT_DUP_INFLIGHT:
            # concurrent duplicate: the original proposal's completion
            # answers it (same commit, one apply)
            self.stats.submits_deduped += 1
            return
        if decision == SUBMIT_SHED_WINDOW:
            self.stats.submits_shed += 1
            self.shed_reasons["session_window"] += 1
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.RETRY,
                (b"backpressure: session window full",),
            )
            return
        assert decision == SUBMIT_FRESH
        if not (0 <= p.shard < self.engine.n_shards):
            # shard validation FIRST: the ledger lookup below indexes
            # rt.shards, and a malformed frame must answer (and release
            # its reservation), not raise out of the receive loop
            self.sessions.abort(p.client_id, p.seq)
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.ERROR,
                (b"shard out of range",),
            )
            return
        if not self._group_owns(p.shard):
            # group-locality fence (fleet/groups.py): RETRYABLE, not an
            # error — mid-rebalance a router's stale map can land one
            # in-flight submit here after this group shrank; the retry
            # re-resolves against the flipped map and reaches the new
            # owner, where the deterministic batch id dedups any replay
            self.sessions.abort(p.client_id, p.seq)
            self.stats.submits_shed += 1
            self.shed_reasons["group_range"] += 1
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.RETRY,
                (b"shard not owned by this group",),
            )
            return
        if not p.commands:
            # validate BEFORE the ledger dedup: an empty replay of an
            # applied seq must stay an error, not an OK with a
            # zero-truncated payload cached in the session table
            self.sessions.abort(p.client_id, p.seq)
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.ERROR,
                (b"empty submit",),
            )
            return
        # engine-ledger dedup BEFORE any proposal: a seq whose result
        # was evicted from the session cache (ack + GC, lease expiry,
        # session loss) re-arrives FRESH, but its deterministic batch id
        # may already be known applied — scalar commits and wave-lane
        # entry ids in applied_ids, coalesced-wave per-client ALIASES in
        # the proposer-local alias_ledger (kept out of applied_ids so
        # the apply-path dedup stays symmetric across replicas). Answer
        # from the ledger instead of burning a slot (and instead of
        # re-applying through the wave lane, which applies decided
        # waves unconditionally).
        bid = BatchId(batch_id_for(p.client_id, p.seq))
        sh = self.engine.rt.shards[p.shard]
        if bid in sh.applied_ids or bid in sh.alias_ledger:
            self.stats.submits_deduped += 1
            self._spawn(self._drive_ledger_replay(sender, p, bid, sh))
            return
        # -- admission control (shed BEFORE the engine sees the batch;
        # the FRESH reservation is released on every shed path) --
        if self.engine.pending_queue_depth() >= self.config.max_queue_depth:
            self.sessions.abort(p.client_id, p.seq)
            self.stats.submits_shed += 1
            self.shed_reasons["queue_depth"] += 1
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.RETRY,
                (b"backpressure: engine queue saturated",),
            )
            return
        if not self.engine.rt.has_quorum:
            self.sessions.abort(p.client_id, p.seq)
            self.stats.submits_shed += 1
            self.shed_reasons["no_quorum"] += 1
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.RETRY,
                (b"no quorum",),
            )
            return
        t0 = time.perf_counter()
        coal = self.config.coalesce and self._coal_eligible(p)
        # flight: the gateway-accept stamp (critpath's gateway_queue /
        # coalesce_park boundary; arg records the park decision)
        self.engine.flight.record(
            FRE_GW_RECV, shard=p.shard, arg=1 if coal else 0,
            batch=fr_hash(bid),
        )
        if coal:
            self._coal_add(sender, p, t0)
            return
        if self.config.coalesce:
            self.coalesce_outcomes["bypass"] += 1
        self._spawn(self._drive_submit(sender, p, t0))

    @staticmethod
    def _deterministic_batch(p: Submit) -> CommandBatch:
        """Build the consensus batch with ids derived from
        ``(client_id, seq)`` instead of fresh uuid4s. A replay of the
        same Submit — even after the gateway lost its session state
        (restart, cache eviction, session expiry) — therefore produces
        a byte-identical batch with the SAME batch id, and the engine's
        ``applied_ids`` dedup ledger blocks the double apply that a
        random id would slip past. The derivation lives in
        :func:`rabia_tpu_torch.obs.flight.batch_id_for` (the trace collector
        names batches from session coordinates the same way)."""
        import hashlib


        seed = p.client_id.bytes + p.seq.to_bytes(8, "little")
        bid = batch_id_for(p.client_id, p.seq)
        cmds = [
            Command(
                id=uuid.UUID(
                    bytes=hashlib.blake2s(
                        seed + i.to_bytes(4, "little"), digest_size=16
                    ).digest()
                ),
                data=c,
            )
            for i, c in enumerate(p.commands)
        ]
        return CommandBatch(
            id=BatchId(bid), commands=tuple(cmds), shard=ShardId(p.shard)
        )

    def _wave_block(self, p: Submit):
        """Build the one-shard :class:`PayloadBlock` that routes this
        submit through the zero-handoff wave lane, or None when it must
        ride the scalar lane. Eligible when the native runtime owns the
        commit path, this replica is the rotation proposer at the
        shard's head RIGHT NOW, and every command is a binary op (the
        consensus wave-routing rule) — then decide→apply→result runs
        end-to-end in C (``waves_native`` grows, ``gil_handoffs`` stays
        flat), where the scalar lane pays one designed GIL handoff per
        decide. The block id is derived so the entry commits under the
        SAME deterministic ``(client_id, seq)`` batch id the scalar lane
        would use: replays dedup in ``applied_ids`` regardless of lane,
        even if the entry demotes mid-flight."""
        e = self.engine
        if getattr(e, "_rtm", None) is None:
            return None
        if not bool((e.proposer_eligible_shards() == p.shard).any()):
            return None
        from rabia_tpu_torch.apps.native_store import binary_wave_eligible
        from rabia_tpu_torch.core.blocks import block_id_for_batch, build_block

        blk = build_block(
            [p.shard], [list(p.commands)],
            block_id=block_id_for_batch(
                batch_id_for(p.client_id, p.seq), p.shard
            ),
        )
        if not binary_wave_eligible(
            blk.data, blk.cmd_offsets, blk.shard_starts, 1,
            np.arange(1),
        ):
            return None
        # self-alias: the per-submit wave registers its own (client_id,
        # seq)-derived id + responses in the applied ledger exactly like
        # a coalesced wave's covered clients — a replay after session-
        # state loss answers from the ledger instead of re-applying
        # through the wave lane (which never consults applied_ids)
        blk.aliases = {
            0: (
                (
                    batch_id_for(p.client_id, p.seq).bytes,
                    0, len(p.commands),
                ),
            )
        }
        return blk

    async def _drive_ledger_replay(
        self, sender: NodeId, p: Submit, bid, sh
    ) -> None:
        """Answer a FRESH submit whose batch id is already in the
        engine's applied ledger: the commit happened in an earlier life
        of this session. Serve the recorded responses (or repair them
        from a peer) — NEVER re-propose."""
        responses = sh.applied_results.get(bid)
        if bid in sh.applied_results:
            if responses is None:
                # applied but deterministically rejected: that failure
                # is the true outcome of this seq
                status, payload = ResultStatus.ERROR, (b"apply failed",)
            else:
                status, payload = ResultStatus.OK, tuple(responses)
        else:
            # committed, responses not recorded here (a C-applied wave
            # on a ledger-recovered replica): try the peer repair lane
            # (which is terminal — it returns OK or ERROR, never RETRY)
            status, payload = await self._repair_result(bid, p.shard)
        if status == ResultStatus.OK:
            # the LEAD client of a coalesced entry replays under the
            # entry's own id, whose recorded/repaired responses may be
            # the FULL entry list (the scalar-demoted lane records the
            # whole entry under that id, and entry-level repair/settle
            # need it intact) — the lead's ops are the entry's PREFIX
            # by construction, so its own answers are the first
            # `count` responses. The count comes from the alias ledger
            # (recorded at apply time), NEVER from the replayed
            # Submit's arity: a replay with inflated command count must
            # not receive other covered clients' response slices. Post-
            # crash the recorded count is gone (K_LEDGER has no op
            # ranges) — fall back to the replayed arity, which can only
            # NARROW an over-long list, never widen the slice.
            count = sh.alias_ledger.get(bid)
            if count is None:
                count = len(p.commands)
            if len(payload) > count:
                payload = payload[:count]
        if status == ResultStatus.OK:
            wal = getattr(self.engine, "_wal", None)
            if wal is not None:
                # the ledger entry was written at APPLY time, possibly
                # ahead of the wave's fsync — an OK replay answer must
                # honor the same durability fence as every other OK
                # Result on a durable cluster
                try:
                    await wal.durability_barrier()
                except Exception as e:
                    status, payload = ResultStatus.ERROR, (
                        f"durability barrier failed: {e}".encode(),
                    )
        self.sessions.complete_op(
            p.client_id, p.seq, int(status), payload,
            self.engine.rt.state_version,
        )
        # a replayed commit resends as CACHED (the dedup observable),
        # matching the session-cache path's wire behavior
        wire_status = (
            ResultStatus.CACHED if status == ResultStatus.OK else status
        )
        self._send_result(sender, p.client_id, p.seq, wire_status, payload)

    # -- cross-session coalescing lane (docs/PERFORMANCE.md) ----------------
    #
    # Many sessions' FRESH binary-op Submits to one shard pack into ONE
    # PayloadBlock entry under the lead client's deterministic batch id:
    # one consensus slot, one apply, one result-staging pass, and on
    # durable clusters ONE durability-barrier wait for every covered
    # session. Every covered client's (client_id, seq)-derived id rides
    # the block as an ALIAS (core/blocks.py) so dedup/replay/K_LEDGER
    # stay exactly-once PER CLIENT with zero new wire semantics.

    def _coal_eligible(self, p: Submit) -> bool:
        """Packable: every command a binary KV op (opcodes 1..6 — the
        wave-routing rule) and the submit alone within the ops budget.
        Everything else rides the classic per-submit lane."""
        cmds = p.commands
        if not cmds or len(cmds) > self._coal_max_ops:
            return False
        for c in cmds:
            if not c or not (1 <= c[0] <= 6) or len(c) > self._coal_max_cmd:
                return False
        return True

    def _coal_window_s(self, shard: int) -> float:
        """Adaptive flush window: aim to collect several submits at the
        shard's eligible-arrival rate, floored and capped by config (the
        cap IS the per-submit latency budget)."""
        cfg = self.config
        rate = self._coal_rate.get(shard, 0.0)
        if rate <= 1.0:
            return self._coal_window_cfg
        return min(
            self._coal_window_cfg,
            max(cfg.coalesce_window_min, 8.0 / rate),
        )

    def _coal_add(self, sender: NodeId, p: Submit, t0: float) -> None:
        """Park one FRESH eligible submit in its shard's window (the
        session reservation from submit_check is HELD while parked, so
        client retransmits attach as DUP_INFLIGHT). Sparse lanes drive
        straight through instead: with no realistic chance of a window
        companion, parking buys nothing and can cost a lot more than
        the window itself — a parked submit can MISS its shard's
        proposer-eligibility instant and demote to the forwarded scalar
        path (measured: +50ms p50 at 30/s on a 3-gateway cluster)."""
        # per-shard arrival-rate EWMA (adaptive window + density gate)
        s = p.shard
        last = self._coal_last_arrival.get(s, 0.0)
        self._coal_last_arrival[s] = t0
        rate = self._coal_rate.get(s, 0.0)
        dt = t0 - last
        if 0.0 < dt < 1.0:
            rate += 0.2 * ((1.0 / dt) - rate)
        else:
            rate *= 0.5
        self._coal_rate[s] = rate
        w = self._coal.get(s)
        if w is None and rate * self._coal_window_cfg < 0.5:
            self.coalesce_outcomes["sparse"] += 1
            self._spawn(self._drive_submit(sender, p, t0))
            return
        n_ops = len(p.commands)
        n_bytes = sum(len(c) for c in p.commands)
        if w is not None and w.entries and (
            w.ops + n_ops > self._coal_max_ops
            or w.size + n_bytes > self.config.coalesce_max_bytes
        ):
            # budget would overflow: flush what is parked, start fresh
            self._coal_flush(s)
            w = None
        if w is None:
            w = self._coal[s] = _CoalesceWindow()
        w.entries.append((sender, p, t0))
        w.ops += n_ops
        w.size += n_bytes
        if (
            w.ops >= self._coal_max_ops
            or w.size >= self.config.coalesce_max_bytes
        ):
            self._coal_flush(s)
            return
        if w.timer is None:
            w.timer = asyncio.get_event_loop().call_later(
                self._coal_window_s(s), self._coal_flush_timed, s
            )

    def _coal_flush_timed(self, shard: int) -> None:
        """Timer-fired flush: bracket the assembly work for the stage
        profiler (the _on_submit path is already inside a bracket)."""
        t0 = time.perf_counter_ns()
        self._ser_carve = 0
        self._coal_flush(shard)
        self._stg_gw(time.perf_counter_ns() - t0)

    def _coal_flush(self, shard: int) -> None:
        w = self._coal.pop(shard, None)
        if w is None:
            return
        # a coalesced PayloadBlock must NEVER span groups: windows key
        # per shard (structural), and on a grouped replica the flushed
        # shard must sit inside the owned ranges — asserted, not
        # assumed (admission fences every parked submit, and set_group
        # only ever WIDENS before routing flips toward a group)
        assert self._group_owns(shard), (
            f"coalesce window for shard {shard} outside group "
            f"{self.config.group_id} ranges {self._group_ranges}"
        )
        if w.timer is not None:
            w.timer.cancel()
            w.timer = None
        entries = w.entries
        self._h_coal.observe(len(entries))
        cs = self._coal_shard(shard)
        if len(entries) == 1:
            # window of one: the classic lane is strictly cheaper (and
            # keeps the zero-handoff per-submit wave path hot)
            self.coalesce_outcomes["solo"] += 1
            cs["solo"] += 1
            sender, p, t0 = entries[0]
            self._spawn(self._drive_submit(sender, p, t0))
            return
        self.coalesce_outcomes["coalesced"] += len(entries)
        self.stats.submits_coalesced += len(entries)
        self.stats.coalesce_waves += 1
        cs["waves"] += 1
        cs["covered"] += len(entries)
        self._spawn(self._drive_coalesced(shard, entries))

    def _coal_shard(self, shard: int) -> dict:
        cs = self.coal_shard_stats.get(shard)
        if cs is None:
            cs = self.coal_shard_stats[shard] = dict(_COAL_SHARD_ZERO)
        return cs

    def _coal_abort_all(self, notify: bool = True) -> None:
        """Tear down every open window (gateway close): release the
        session reservations and shed the parked submits retryable —
        nothing was proposed, so a client retry is FRESH everywhere."""
        for s in list(self._coal):
            w = self._coal.pop(s)
            if w.timer is not None:
                w.timer.cancel()
            for sender, p, _t0 in w.entries:
                self.sessions.abort(p.client_id, p.seq)
                if notify:
                    self._send_result(
                        sender, p.client_id, p.seq, ResultStatus.RETRY,
                        (b"gateway closing",),
                    )

    async def _drive_coalesced(self, shard: int, entries: list) -> None:
        """Commit ONE multi-client wave and fan its Result slices out to
        every covered session (the coalescing twin of _drive_submit)."""
        pcns = time.perf_counter_ns
        tb = pcns()
        from rabia_tpu_torch.core.blocks import block_id_for_batch, build_block

        flat: list[bytes] = []
        ranges: list[tuple[int, int]] = []
        for _sender, p, _t0 in entries:
            lo = len(flat)
            flat.extend(p.commands)
            ranges.append((lo, len(flat)))
        lead = entries[0][1]
        lead_bid = batch_id_for(lead.client_id, lead.seq)
        blk = build_block(
            [shard], [flat],
            block_id=block_id_for_batch(lead_bid, shard),
        )
        # EVERY covered client (lead included) aliases the entry with
        # its deterministic id + op range: the apply paths register
        # them in alias_ledger/applied_results/K_LEDGER
        blk.aliases = {
            0: tuple(
                (batch_id_for(p.client_id, p.seq).bytes, lo, hi)
                for (_s, p, _t), (lo, hi) in zip(entries, ranges)
            )
        }
        batch_id = blk.batch_id_for(0)  # == lead_bid by construction
        self._ser_carve = 0
        self._stg_gw(pcns() - tb)
        proposed = False
        status: int = ResultStatus.OK
        responses: Optional[list] = None
        payload_all: tuple[bytes, ...] = ()
        try:
            fut = await self.engine.submit_block(blk)
            proposed = True
            entry = (await fut)[0]
            if isinstance(entry, Exception):
                raise entry
            responses = list(entry)
        except asyncio.CancelledError:
            for _sender, p, _t0 in entries:
                self.sessions.abort(p.client_id, p.seq)
            raise
        except ResponsesUnavailableError:
            # committed, responses adopted away by a sync overtake:
            # repair the ENTRY once by its lead id, slice per client
            status, payload = await self._repair_result(batch_id, shard)
            if status == ResultStatus.OK:
                responses = list(payload)
                if len(responses) != len(flat):
                    status = ResultStatus.ERROR
                    payload_all = (
                        b"repaired responses misaligned with wave",
                    )
            else:
                payload_all = payload
        except RabiaError as e:
            if not proposed and e.is_retryable():
                # rejected before any proposal reached consensus: shed
                # every covered submit retryable
                for sender, p, _t0 in entries:
                    self.sessions.abort(p.client_id, p.seq)
                    self.stats.submits_shed += 1
                    self.shed_reasons["engine_reject"] += 1
                    self._send_result(
                        sender, p.client_id, p.seq, ResultStatus.RETRY,
                        (str(e).encode(),),
                    )
                return
            # post-proposal failures are terminal for every covered seq
            # (cached; clients retry under new seqs) — same contract as
            # the scalar lane
            status = ResultStatus.ERROR
            payload_all = (str(e).encode(),)
        # cross-session durability-barrier batching: the wave staged its
        # WAL record at apply, so ONE watermark wait here releases EVERY
        # covered session's Result frame
        wal = getattr(self.engine, "_wal", None)
        if wal is not None and status == ResultStatus.OK:
            try:
                await wal.durability_barrier(covered=len(entries))
                # flight: one barrier stamp per wave, keyed by the LEAD
                # batch hash (covered entries' traces merge the wave's
                # trace in — obs/critpath fetches both hashes)
                self.engine.flight.record(
                    FRE_BARRIER, shard=shard, batch=fr_hash(batch_id),
                )
            except Exception as e:
                status = ResultStatus.ERROR
                payload_all = (
                    f"durability barrier failed: {e}".encode(),
                )
        tc = pcns()
        self._ser_carve = 0
        if status == ResultStatus.OK:
            self._coal_shard(shard)["results_ok"] += len(entries)
        sv = self.engine.rt.state_version
        now = time.perf_counter()
        for (sender, p, t0), (lo, hi) in zip(entries, ranges):
            pay = (
                tuple(responses[lo:hi])
                if status == ResultStatus.OK and responses is not None
                else payload_all
            )
            self.sessions.complete_op(
                p.client_id, p.seq, int(status), pay, sv
            )
            self.engine.flight.record(
                FRE_RESULT, shard=shard, arg=int(status),
                batch=fr_hash(batch_id_for(p.client_id, p.seq)),
            )
            if t0:
                wall = now - t0
                self._h_submit_result.observe(wall)
                self.slowlog.observe(
                    wall,
                    {
                        "client": p.client_id.hex,
                        "seq": int(p.seq),
                        "batch": batch_id_for(p.client_id, p.seq).hex,
                        "wave": getattr(
                            batch_id, "value", batch_id
                        ).hex,
                        "shard": int(shard),
                        "status": int(status),
                        "coalesced": True,
                    },
                )
            self._send_result(sender, p.client_id, p.seq, status, pay)
        self._stg_gw(pcns() - tc)

    async def _drive_submit(
        self, sender: NodeId, p: Submit, t0: float = 0.0
    ) -> None:
        pcns = time.perf_counter_ns
        tb = pcns()
        # per-shard slots proxy: one per-submit drive = one proposal
        # attempt (engine-reject sheds inflate this by the shed count —
        # zero on a healthy run, and the aggregator's tolerance absorbs
        # fault-window noise)
        cs = self._coal_shard(p.shard)
        cs["scalar"] += 1
        blk = self._wave_block(p)
        if blk is None:
            batch = self._deterministic_batch(p)
            batch_id = batch.id
        else:
            batch = None
            batch_id = blk.batch_id_for(0)
        self._ser_carve = 0
        self._stg_gw(pcns() - tb)
        proposed = False
        try:
            if blk is not None:
                fut = await self.engine.submit_block(blk)
                proposed = True
                entry = (await fut)[0]
                if isinstance(entry, Exception):
                    # per-entry failures surface as values on the block
                    # future; re-raise into the scalar lane's handlers
                    # (sync overtake -> ResponsesUnavailableError ->
                    # peer repair, like the scalar path)
                    raise entry
                responses = entry
            else:
                fut = await self.engine.submit_batch(batch, p.shard)
                proposed = True
                responses = await fut
            status: int = ResultStatus.OK
            payload = tuple(responses)
        except asyncio.CancelledError:
            self.sessions.abort(p.client_id, p.seq)
            raise
        except ResponsesUnavailableError:
            # the batch COMMITTED but this replica adopted its slots via
            # snapshot sync — the responses exist on peers that applied
            # normally. Repair from a peer gateway; never re-propose.
            status, payload = await self._repair_result(batch_id, p.shard)
        except RabiaError as e:
            if not proposed and e.is_retryable():
                # rejected before any proposal reached consensus: shed
                # retryable, nothing to dedup against
                self.sessions.abort(p.client_id, p.seq)
                self.stats.submits_shed += 1
                self.shed_reasons["engine_reject"] += 1
                self._send_result(
                    sender, p.client_id, p.seq, ResultStatus.RETRY,
                    (str(e).encode(),),
                )
                return
            # post-proposal failures are terminal for this seq: the batch
            # MAY have committed (e.g. applied via snapshot sync with
            # responses unavailable) — a silent retry under the same seq
            # could double-apply under a fresh batch id, so the error is
            # cached and the client must use a new seq to retry
            status = ResultStatus.ERROR
            payload = (str(e).encode(),)
        # durability barrier (docs/DURABILITY.md): on a WAL cluster the
        # decided wave's record must survive an fsync BEFORE this seq's
        # result frame leaves the replica. The wave was staged at apply
        # (before the submit future settled, on both runtime paths), so
        # one group-amortized wait on the current watermark covers it.
        wal = getattr(self.engine, "_wal", None)
        if wal is not None and status == ResultStatus.OK:
            try:
                await wal.durability_barrier()
                self.engine.flight.record(
                    FRE_BARRIER, shard=p.shard, batch=fr_hash(batch_id),
                )
            except Exception as e:
                # lost durability must not ack: terminal for this seq
                # (cached; the client retries under a new seq)
                status = ResultStatus.ERROR
                payload = (f"durability barrier failed: {e}".encode(),)
        # result staging to the session plane: one table op drops the
        # inflight reservation and caches (status, payload, frontier) —
        # on the native plane the payload views (the apply plane's lazy
        # result frames) are packed once into the C-resident blob the
        # dedup path answers from, with no per-part Python bytes kept
        tc = pcns()
        self._ser_carve = 0
        if status == ResultStatus.OK:
            cs["results_ok"] += 1
        self.sessions.complete_op(
            p.client_id, p.seq, int(status), payload,
            self.engine.rt.state_version,
        )
        # flight: the commit timeline's terminal stage (the batch hash
        # ties it back to submit/propose/decide/apply)
        self.engine.flight.record(
            FRE_RESULT, shard=p.shard, arg=int(status),
            batch=fr_hash(batch_id),
        )
        if t0:
            wall = time.perf_counter() - t0
            self._h_submit_result.observe(wall)
            self.slowlog.observe(
                wall,
                {
                    "client": p.client_id.hex,
                    "seq": int(p.seq),
                    "batch": getattr(batch_id, "value", batch_id).hex,
                    "wave": getattr(batch_id, "value", batch_id).hex,
                    "shard": int(p.shard),
                    "status": int(status),
                    "coalesced": False,
                },
            )
        self._send_result(sender, p.client_id, p.seq, status, payload)
        self._stg_gw(pcns() - tc)

    # -- linearizable read path ---------------------------------------------

    def _on_read(self, sender: NodeId, p: ReadIndex) -> None:
        self.stats.reads += 1
        if not self.engine.rt.has_quorum:
            self.stats.reads_failed += 1
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.RETRY,
                (b"no quorum",),
            )
            return
        if not (0 <= p.shard < self.engine.n_shards):
            self.stats.reads_failed += 1
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.ERROR,
                (b"shard out of range",),
            )
            return
        key = (p.client_id, p.seq)
        if key in self._reads_inflight:
            return  # retransmit of a slow read: the original answers
        self._reads_inflight.add(key)
        # queue for the NEXT shared probe round (a round already in
        # flight started before this read arrived, so its frontiers may
        # predate writes the read must observe). No per-read task, no
        # per-read future: the round serves the whole window.
        self._pending_reads.append((sender, p))
        self._probe_kick.set()

    def _fail_read(self, sender: NodeId, p: ReadIndex, status: int,
                   text: bytes) -> None:
        self.stats.reads_failed += 1
        self._reads_inflight.discard((p.client_id, p.seq))
        self._send_result(sender, p.client_id, p.seq, status, (text,))

    def _serve_read(self, sender: NodeId, p: ReadIndex) -> None:
        """Serve one read whose read index the applied frontier already
        covers (synchronous: one reader call, one result frame)."""
        try:
            data = self.reader(p.shard, p.key)
        except Exception as e:
            # the reader is a pluggable seam (device-KV handlers can
            # fail transiently): the client must get a frame, never
            # silence — a dropped read would make it retransmit forever
            logger.warning(
                "gateway %s: read handler failed for shard %d: %s",
                self.node_id.short(), p.shard, e,
            )
            self._fail_read(
                sender, p, ResultStatus.ERROR,
                f"read handler failed: {e}".encode(),
            )
            return
        self._reads_inflight.discard((p.client_id, p.seq))
        self._send_result(
            sender, p.client_id, p.seq, ResultStatus.OK, (data,)
        )

    async def _acquire_read_index(self) -> np.ndarray:
        """Join the NEXT probe round as a bare frontier waiter (non-read
        callers, tests)."""
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._round_waiters.append(fut)
        self._probe_kick.set()
        return await fut

    async def _probe_loop(self) -> None:
        while self._running:
            try:
                await self._probe_kick.wait()
            except asyncio.CancelledError:
                return
            self._probe_kick.clear()
            if not self._round_waiters and not self._pending_reads:
                continue
            waiters, self._round_waiters = self._round_waiters, []
            reads, self._pending_reads = self._pending_reads, []
            try:
                frontier = await self._run_probe_round(waiters)
            except asyncio.CancelledError:
                for w in waiters:
                    if not w.done():
                        w.set_exception(
                            TimeoutError_("read-index probe cancelled")
                        )
                for sender, p in reads:
                    self._fail_read(
                        sender, p, ResultStatus.RETRY,
                        b"read-index probe cancelled",
                    )
                return
            except RabiaError as e:
                for w in waiters:
                    if not w.done():
                        w.set_exception(e)
                for sender, p in reads:
                    self._fail_read(
                        sender, p, ResultStatus.RETRY, str(e).encode()
                    )
                continue
            for w in waiters:
                if not w.done():
                    w.set_result(frontier)
            if reads:
                self._finish_reads(reads, frontier)

    def _finish_reads(self, reads: list, frontier: np.ndarray) -> None:
        """Serve every read of one probe round: reads whose shard's
        applied frontier already covers its read index answer inline
        (zero additional tasks — the common case on a healthy replica);
        the rest group into ONE waiter task per shard."""
        rt = self.engine.rt
        inline: list = []
        deferred: dict[int, list] = {}
        for sender, p in reads:
            target = int(frontier[p.shard])
            if rt.applied_upto[p.shard] >= target:
                inline.append((sender, p))
            else:
                deferred.setdefault(p.shard, []).append(
                    (sender, p, target)
                )
        if inline:
            self._serve_reads_batch(inline)
        for shard, items in deferred.items():
            self._spawn(self._serve_deferred_reads(shard, items))

    def _serve_reads_batch(self, pairs: list) -> None:
        """Serve every probe-covered read of one round in ONE handler
        call when the reader exposes ``read_many`` (the device-plane
        batched seam: all GETs of the probe window become a single
        ``lookup_only`` dispatch — one plane fetch per probe round
        instead of one per read). Handlers without the batch seam fall
        back to per-read serving."""
        rm = getattr(self.reader, "read_many", None)
        if rm is None or len(pairs) == 1:
            t0 = time.perf_counter_ns()
            for sender, p in pairs:
                self._serve_read(sender, p)
            self._stg_rp(time.perf_counter_ns() - t0)
            return
        t0 = time.perf_counter_ns()
        try:
            frames = rm([(p.shard, p.key) for _, p in pairs])
        except Exception as e:
            logger.warning(
                "gateway %s: batched read handler failed: %s",
                self.node_id.short(), e,
            )
            for sender, p in pairs:
                self._fail_read(
                    sender, p, ResultStatus.ERROR,
                    f"read handler failed: {e}".encode(),
                )
            self._stg_rp(time.perf_counter_ns() - t0)
            return
        self.stats.reads_batched += len(pairs)
        for (sender, p), data in zip(pairs, frames):
            self._reads_inflight.discard((p.client_id, p.seq))
            self._send_result(
                sender, p.client_id, p.seq, ResultStatus.OK, (data,)
            )
        self._stg_rp(time.perf_counter_ns() - t0)

    async def _serve_deferred_reads(self, shard: int, items: list) -> None:
        """One apply-frontier wait covers every deferred read of the
        round on this shard (targets share the round's frontier, so the
        max dominates)."""
        target = max(t for _, _, t in items)
        try:
            await self._await_applied(shard, target)
        except RabiaError as e:
            for sender, p, _ in items:
                self._fail_read(
                    sender, p, ResultStatus.RETRY, str(e).encode()
                )
            return
        except asyncio.CancelledError:
            for sender, p, _ in items:
                self._reads_inflight.discard((p.client_id, p.seq))
            raise
        self._serve_reads_batch([(sender, p) for sender, p, _ in items])

    async def _run_probe_round(self, waiters: list) -> np.ndarray:
        self.stats.probe_rounds += 1
        frontier = self.engine.decided_frontier().astype(np.int64)
        need = self.engine.cluster.quorum_size - 1
        if need <= 0:
            return frontier  # single-replica cluster: self IS a quorum
        if self.engine.frontier_floored():
            # a restarted replica: its frontier is floored at its vote
            # barrier, above anything a read needs; a quorum of the OTHER
            # replicas covers every committed write without it
            # (RabiaEngine.frontier_floored)
            frontier = self.engine._own_frontier().astype(np.int64)
            need += 1
        if len(self._peer_gateways) < need:
            raise TimeoutError_("read-index: not enough peer gateways")
        self._nonce += 1
        round_ = _ProbeRound(self._nonce, waiters, need)
        self._round = round_
        probe = ReadIndex(
            mode=int(ReadIndexMode.PROBE),
            client_id=self.node_id.value,
            seq=round_.nonce,
        )
        for peer in self._peer_gateways:
            self._send(probe, peer)
        try:
            await asyncio.wait_for(
                round_.done.wait(), self.config.probe_timeout
            )
        except asyncio.TimeoutError:
            raise TimeoutError_(
                "read-index probe", self.config.probe_timeout
            ) from None
        finally:
            self._round = None
        for vec in round_.replies.values():
            m = min(len(vec), len(frontier))
            np.maximum(frontier[:m], vec[:m], out=frontier[:m])
        return frontier

    def _on_probe(self, sender: NodeId, p: ReadIndex) -> None:
        # answer only known peer gateways: the frontier is engine state
        if sender not in self._peer_gateways:
            return
        if self.engine.frontier_floored():
            # a restarted replica abstains while its frontier is floored
            # at its vote barrier: the floored vector would hold the
            # asker's reads until traffic passed the barrier, and a quorum
            # of the replicas that never lost their votes covers every
            # committed write without this one
            return
        self._send(
            ReadIndex(
                mode=int(ReadIndexMode.REPLY),
                client_id=self.node_id.value,
                seq=p.seq,
                frontier=tuple(
                    int(x) for x in self.engine.decided_frontier()
                ),
            ),
            sender,
        )

    def _on_probe_reply(self, sender: NodeId, p: ReadIndex) -> None:
        if sender not in self._peer_gateways:
            return
        round_ = self._round
        if round_ is None or p.seq != round_.nonce:
            return  # stale reply from an expired round
        round_.replies[sender] = np.asarray(p.frontier, np.int64)
        if len(round_.replies) >= round_.need:
            round_.done.set()

    # -- result repair (committed, responses lost to a sync overtake) -------

    def _on_fetch_result(self, sender: NodeId, p: ReadIndex) -> None:
        """A peer gateway asks for a committed batch's applied responses
        (its replica adopted the slots via snapshot sync and never ran
        the apply). ``key`` is the 16-byte batch id."""
        if sender not in self._peer_gateways:
            return
        status, payload = ResultStatus.RETRY, ()  # unknown here
        if len(p.key) == 16 and 0 <= p.shard < self.engine.n_shards:
            sh = self.engine.rt.shards[p.shard]
            bid = BatchId(uuid.UUID(bytes=p.key))
            if bid in sh.applied_results:
                responses = sh.applied_results[bid]
                if responses is None:
                    # applied here too, but the state machine rejected it
                    # deterministically: the failure is the true outcome
                    status, payload = ResultStatus.ERROR, (b"apply failed",)
                else:
                    status, payload = ResultStatus.OK, tuple(responses)
        self._send_result(sender, self.node_id.value, p.seq, status, payload)

    def _on_peer_result(self, sender: NodeId, p: Result) -> None:
        if sender not in self._peer_gateways:
            return
        fut = self._fetches.get(p.seq)
        if fut is not None and not fut.done():
            fut.set_result(p)

    async def _repair_result(
        self, batch_id, shard: int
    ) -> tuple[int, tuple[bytes, ...]]:
        """Fetch a committed batch's responses from peer gateways — never
        re-proposes, so exactly-once is preserved. Returns (status,
        payload); ERROR with a diagnostic when no peer holds them."""
        for peer in list(self._peer_gateways):
            self._fetch_nonce += 1
            nonce = self._fetch_nonce
            fut: asyncio.Future = asyncio.get_event_loop().create_future()
            self._fetches[nonce] = fut
            try:
                self._send(
                    ReadIndex(
                        mode=int(ReadIndexMode.FETCH_RESULT),
                        client_id=self.node_id.value,
                        seq=nonce,
                        shard=shard,
                        key=batch_id.value.bytes,
                    ),
                    peer,
                )
                res = await asyncio.wait_for(
                    fut, self.config.probe_timeout
                )
            except asyncio.TimeoutError:
                continue
            finally:
                self._fetches.pop(nonce, None)
            if res.status == ResultStatus.OK:
                self.stats.results_repaired += 1
                return ResultStatus.OK, tuple(res.payload)
            if res.status == ResultStatus.ERROR:
                return ResultStatus.ERROR, tuple(res.payload)
            # RETRY: this peer doesn't hold it either; try the next
        return ResultStatus.ERROR, (
            b"committed but responses unavailable cluster-wide",
        )

    async def _await_applied(self, shard: int, target: int) -> None:
        """Block until the local applied frontier covers ``target`` on
        ``shard`` (event-driven via the engine's frontier hook, with a
        coarse poll guard)."""
        rt = self.engine.rt
        if rt.applied_upto[shard] >= target:
            return
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.config.read_timeout
        while rt.applied_upto[shard] < target:
            left = deadline - loop.time()
            if left <= 0:
                raise TimeoutError_(
                    "read-index apply wait", self.config.read_timeout
                )
            self._frontier_event.clear()
            if rt.applied_upto[shard] >= target:
                return
            try:
                await asyncio.wait_for(
                    self._frontier_event.wait(), min(left, 0.05)
                )
            except asyncio.TimeoutError:
                pass
