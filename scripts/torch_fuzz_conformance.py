"""Randomized protocol-conformance fuzz on the PyTorch/CUDA port: kernel
vs oracle, fused vs scan, mesh plane vs host plane under faults.

The port's counterpart of ``scripts/fuzz_conformance.py``: the same
trials, gates, arguments, messages and exit codes, over
``rabia_tpu_torch``. The fixed-seed suites pin the round kernel to the
scalar weak-MVC oracle (and the mesh plane to the one-device plane) on a
handful of schedules; this script keeps drawing NEW random schedules
until a time budget expires — random loss rates, crash masks, and V0/V1
initial votes (V? is never a valid round-1 input; it arises only from
tallies) — and fails loudly with the repro seed on the first divergence.
Schedules are drawn from numpy exactly as the JAX package's script
draws them, so one seed gives one schedule in both programs. Gates:

1. step-for-step decision identity between ``ClusterKernel.round_step``
   (one ``cr_rounds`` launch a round on a card, after one
   ``cr_start_slot`` launch) and one ``WeakMVCOracle`` per shard under
   the SAME delivery masks and the same common coin;
2. bit-identity of ``slot_pipeline_fused`` and
   ``slot_pipeline_fused_rmajor`` (the closed form: the fused-window
   kernels on a card) with the scanned ``slot_pipeline`` (the
   slot-pipeline kernel) on random fault-free windows;
3. (``--mesh N``) the mesh plane under faults, on a logical 8-device
   mesh (``["cpu"] * 8`` under ``--device cpu``, the card eight times
   otherwise): random monotonic crash schedules through
   ``MeshPhaseKernel``'s replica exchanges diffed per phase against
   ``ClusterKernel`` with full delivery, and random loss+crash
   schedules through ``ShardedClusterKernel`` (a block a shard row)
   diffed bit-for-bit against the one-device kernel each round;
4. the engine-level differentials (``--planes``, ``--tick``,
   ``--apply``, ``--runtime``, ``--gateway``, ``--wal``,
   ``--coalesce``) through ``rabia_tpu_torch.testing.conformance``.

Usage::

    python scripts/torch_fuzz_conformance.py [--seconds 30] [--base-seed 0]
        [--planes N] [--mesh N] [--device cpu]

The kernel trials, the mesh trials and ``--planes``' ``MeshEngine`` run
on the card unless ``--device cpu`` is given; without a card and without
``--device cpu`` the script raises. On the CPU every kernel wrapper runs
its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ABSENT = 3

# trials cycle through these geometries (one kernel a geometry, built
# during warmup) and spend the whole schedule budget on actual schedules
GEOMETRY_POOL = [(4, 3, 0), (8, 5, 0), (4, 4, 1)]

_FIELDS = ("slot", "phase", "stage", "my_r1", "my_r2", "prev_r1", "prev_r2", "led1", "led2",
           "decided", "decided_phase", "done", "active")


def oracle_sample(S: int) -> list[int]:
    """The shards a wide stepwise trial holds against the scalar oracle:
    shard 0, shard S-1, and both sides of every 16-shard boundary in the
    first and last 256 shards (the round kernel's 16-shard tiles)."""
    out = {0, S - 1}
    for b in range(16, min(S, 256) + 1, 16):
        out.update((b - 1, b))
    for b in range(max(16, (S - 256) // 16 * 16), S, 16):
        out.update((b - 1, b))
    return sorted(s for s in out if 0 <= s < S)


def _host(x) -> np.ndarray:
    """A tensor's or a MeshArray's values as numpy."""
    if hasattr(x, "numpy") and not isinstance(x, torch.Tensor):
        return x.numpy()
    return x.detach().cpu().numpy()


def _kernels(device):
    """(S, R, kernel_seed) -> ClusterKernel cache on ``device``: trials
    reuse a small pool and vary everything else."""
    from rabia_tpu_torch.kernel import ClusterKernel

    cache: dict[tuple, ClusterKernel] = {}

    def get(S: int, R: int, kseed: int):
        key = (S, R, kseed)
        if key not in cache:
            cache[key] = ClusterKernel(S, R, seed=kseed, device=device)
        return cache[key]

    return get


def _trial_stepwise(get_kernel, seed: int, pool=GEOMETRY_POOL, sample=None) -> None:
    """Gate 1. ``pool`` is the geometry pool (the reference's by
    default, so a seed reproduces across packages). ``sample``, a list
    of shards, holds only those shards against the oracle (its scalar
    Python is slow at thousands of shards) and then every shard's whole
    state against ``round_step_plain`` each round, on the same masks."""
    from rabia_tpu_torch.core.oracle import WeakMVCOracle
    from rabia_tpu_torch.kernel.phase_driver import device_coin

    rng = np.random.default_rng(seed)
    # geometry comes round-robin from the pool (kernels are built once,
    # before the schedule budget starts) — the randomness that matters
    # lives in the schedules: votes, loss masks, crashes
    S, R, kseed = pool[seed % len(pool)]
    p = float(rng.uniform(0.3, 1.0))
    T = 40
    # initial round-1 votes are V0/V1 only (weak_mvc.ivy:113-131 — a
    # replica proposes or forfeits; V? arises from tallies, never inputs)
    initial = rng.integers(0, 2, size=(S, R))
    alive_np = rng.random((S, R)) > float(rng.uniform(0.0, 0.4))

    k = get_kernel(S, R, kseed)
    dev = k.device
    votes = torch.as_tensor(initial, dtype=torch.int8, device=dev)
    every = torch.ones((S,), dtype=torch.bool, device=dev)
    state = k.start_slot(k.init_state(), every, votes)
    shards = range(S) if sample is None else sample
    plain = None if sample is None else k.start_slot_plain(k.init_state(), every, votes)
    oracles = {
        s: WeakMVCOracle(
            R,
            list(initial[s]),
            lambda phase, s=s: device_coin(kseed, s, 0, phase),
            alive=list(alive_np[s]),
        )
        for s in shards
    }
    alive = torch.as_tensor(alive_np, device=dev)
    masks = rng.random((T, S, R, R)) < p
    for t in range(T):
        mask = torch.as_tensor(masks[t], device=dev)
        state = k.round_step(state, alive, mask)
        if plain is not None:
            plain = k.round_step_plain(plain, alive, mask)
            for f, a, b in zip(_FIELDS, state, plain):
                if not torch.equal(a, b):
                    bad = np.nonzero((_host(a) != _host(b)).reshape(S, -1).any(1))[0]
                    raise AssertionError(
                        f"seed={seed} t={t} S={S} R={R} p={p:.2f}: kernel field {f} != "
                        f"round_step_plain on {len(bad)} shards, the first {bad[:8].tolist()}"
                    )
        decided = _host(state.decided)
        for s in shards:
            m = masks[t, s]
            oracles[s].step(lambda i, j, m=m: bool(m[i, j]))
            want = oracles[s].decided_value
            got = None if decided[s] == ABSENT else int(decided[s])
            if got != (None if want is None else int(want)):
                raise AssertionError(
                    f"seed={seed} t={t} shard={s} S={S} R={R} p={p:.2f}: "
                    f"kernel decided {got}, oracle {want}"
                )


def _trial_fused(get_kernel, seed: int, pool=GEOMETRY_POOL) -> None:
    """Gate 2: the closed form against the scan, on both fused entries."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    S, R, kseed = pool[(seed + 1) % len(pool)]
    T = 8
    k = get_kernel(S, R, kseed)
    dev = k.device
    votes = torch.as_tensor(
        rng.choice([0, 1, 2, 3], p=[0.3, 0.4, 0.15, 0.15],
                   size=(T, S, R)).astype(np.int8), device=dev
    )
    alive = torch.as_tensor(rng.random((S, R)) > float(rng.uniform(0.0, 0.5)), device=dev)
    d1, p1 = k.slot_pipeline(votes, alive, T)
    d2, p2 = k.slot_pipeline_fused(votes, alive, T)
    if not (torch.equal(d1, d2) and torch.equal(p1, p2)):
        raise AssertionError(
            f"fused divergence: seed={seed} S={S} R={R} T={T}"
        )
    # replica-major entry (the production path): same schedule through
    # [R,T,S] votes, with and without the derivable phase plane
    votes_rm = votes.permute(2, 0, 1).contiguous()
    alive_rm = alive.t().contiguous()
    d3, p3 = k.slot_pipeline_fused_rmajor(votes_rm, alive_rm, T)
    d4 = k.slot_pipeline_fused_rmajor(votes_rm, alive_rm, T, want_phase=False)
    if not (torch.equal(d1, d3) and torch.equal(p1, p3) and torch.equal(d1, d4)):
        raise AssertionError(
            f"rmajor divergence: seed={seed} S={S} R={R} T={T}"
        )


# (S, R, shard_axis, replica_axis) on the logical 8-device mesh: covers
# replica-axis exchanges (4-way, 2-way) and the pure shard-data-parallel
# layout (replica axis 1, a block holding every replica)
MESH_GEOMETRY_POOL = [(8, 4, 2, 4), (16, 2, 4, 2), (8, 5, 8, 1)]


def _mesh_kernels(device):
    """Geometry -> (plain ClusterKernel, MeshPhaseKernel, shard-idx,
    ShardedClusterKernel) cache, over a logical mesh of ``device``
    (named once a position)."""
    from rabia_tpu_torch.kernel import ClusterKernel
    from rabia_tpu_torch.parallel.mesh import (
        MeshPhaseKernel,
        ShardedClusterKernel,
        make_mesh,
    )

    cache: dict[tuple, tuple] = {}

    def get(geo: tuple):
        if geo not in cache:
            S, R, sa, ra = geo
            mesh = make_mesh([device] * (sa * ra), sa, ra)
            plain = ClusterKernel(S, R, seed=101, device=device)
            mk = MeshPhaseKernel(S, R, mesh, seed=101)
            sk = ShardedClusterKernel(S, R, mesh, seed=101)
            cache[geo] = (plain, mk, mk.shard_index_array(), sk)
        return cache[geo]

    return get


def _trial_mesh_crash(get_mesh, seed: int, pool=MESH_GEOMETRY_POOL) -> None:
    """Random monotonic crash schedule through the replica exchanges.

    The mesh plane is lockstep (delivery is the exchange; a crash is an
    ``alive`` row that stops contributing — monotonic, since a revived
    replica would rejoin out of phase, which the model excludes). The
    same schedule runs on ``ClusterKernel`` with full delivery, two
    rounds per phase; at EVERY phase boundary each shard's unique
    non-ABSENT mesh decision (agreement is asserted across replica
    views) must equal the host plane's decided value, including the
    never-decides case (majority crash -> ABSENT on both)."""
    rng = np.random.default_rng(seed ^ 0x3E5B)
    geo = pool[seed % len(pool)]
    S, R, _, _ = geo
    plain, mk, idx, _ = get_mesh(geo)
    dev = plain.device

    K = 10  # phases
    votes = rng.integers(0, 2, (S, R)).astype(np.int8)
    alive = rng.random((S, R)) > float(rng.uniform(0.0, 0.4))
    crash_phase = int(rng.integers(0, K))  # a second crash wave mid-run
    survivors = rng.random((S, R)) > float(rng.uniform(0.0, 0.3))

    st = mk.init_state(votes)
    ps = plain.start_slot(
        plain.init_state(), torch.ones((S,), dtype=torch.bool, device=dev),
        torch.as_tensor(votes, device=dev)
    )
    full = torch.ones((S, R, R), dtype=torch.bool, device=dev)
    for ph in range(K):
        if ph == crash_phase:
            alive = alive & survivors
        a = torch.as_tensor(alive, device=dev)
        st = mk.phase_step(st, mk.place(alive), idx)
        ps = plain.round_step(ps, a, full)  # R1 exchange -> R2 cast
        ps = plain.round_step(ps, a, full)  # R2 exchange -> decide/advance
        mdec = _host(st.decided).astype(np.int32)
        pdec = _host(ps.decided)
        # each shard's non-ABSENT views: their least and greatest value
        known = mdec != ABSENT
        lo = np.where(known, mdec, 99).min(1)
        hi = np.where(known, mdec, -1).max(1)
        split = known.any(1) & (lo != hi)
        got = np.where(known.any(1), lo, ABSENT)
        bad = np.nonzero(split | (got != pdec))[0]
        if len(bad):
            s = int(bad[0])  # the first failing shard, as a shard-by-shard walk finds it
            if split[s]:
                vals = {int(v) for v in mdec[s] if v != ABSENT}
                raise AssertionError(
                    f"mesh-crash seed={seed} phase={ph} shard={s}: replica "
                    f"views disagree: {sorted(vals)}"
                )
            g = None if got[s] == ABSENT else int(got[s])
            want = None if pdec[s] == ABSENT else int(pdec[s])
            raise AssertionError(
                f"mesh-crash seed={seed} phase={ph} shard={s} "
                f"geo={geo}: mesh decided {g}, host plane {want}"
            )


def _trial_sharded_lossy(get_mesh, seed: int, pool=MESH_GEOMETRY_POOL) -> None:
    """Random loss + crash schedule through the sharded kernel.

    ``ShardedClusterKernel`` is the same program as ``ClusterKernel``
    with state cut in shard blocks over the mesh's shard axis — every
    step must stay BIT-identical under arbitrary per-round delivery
    masks and crash masks (a block's shard base or layout bug shows up
    exactly here)."""
    rng = np.random.default_rng(seed ^ 0x51A2)
    geo = pool[(seed + 1) % len(pool)]
    S, R, _, _ = geo
    plain, _, _, sk = get_mesh(geo)
    dev = plain.device

    T = 24
    p = float(rng.uniform(0.3, 1.0))
    votes = torch.as_tensor(rng.integers(0, 2, (S, R)).astype(np.int8), device=dev)
    alive = torch.as_tensor(rng.random((S, R)) > float(rng.uniform(0.0, 0.4)), device=dev)
    every = torch.ones((S,), dtype=torch.bool, device=dev)

    ps = plain.start_slot(plain.init_state(), every, votes)
    ms = sk.start_slot(sk.init_state(), every, sk.place_votes(votes))
    for t in range(T):
        mask = torch.as_tensor(rng.random((S, R, R)) < p, device=dev)
        ps = plain.round_step(ps, alive, mask)
        ms = sk.round_step(ms, alive, mask)
        if t % 6 == 5 or t == T - 1:
            for f in ("decided", "phase", "my_r1", "my_r2", "done"):
                a = _host(getattr(ps, f))
                b = _host(getattr(ms, f))
                if not np.array_equal(a, b):
                    raise AssertionError(
                        f"sharded-lossy seed={seed} t={t} geo={geo} "
                        f"p={p:.2f}: field {f} diverged"
                    )


async def _trial_planes(seed: int, device=None) -> None:
    """Engine-level differential: one RANDOM fault-free submission
    schedule through BOTH deployment planes (the transport cluster on
    the host, ``MeshEngine`` on ``device``), via the shared gate
    (rabia_tpu_torch.testing.conformance — the same code path as the
    fixed test, so the two checks cannot drift)."""
    from rabia_tpu_torch.testing.conformance import run_schedule_on_both_planes

    rng = np.random.default_rng(seed + 77)
    S = int(rng.choice([2, 3]))
    waves = int(rng.integers(2, 5))
    # random schedule: each wave covers a random non-empty shard subset
    # with 1-2 commands per covered shard
    schedule = []
    for w in range(waves):
        covered = sorted(
            rng.choice(S, size=int(rng.integers(1, S + 1)), replace=False)
        )
        schedule.append(
            {
                int(s): [
                    f"SET w{w}s{s}k{j} v{int(rng.integers(0, 9))}"
                    for j in range(int(rng.integers(1, 3)))
                ]
                for s in covered
            }
        )
    await run_schedule_on_both_planes(
        schedule, n_shards=S, n_replicas=3, tag=f"planes seed={seed}", device=device
    )


async def _trial_tick_paths(seed: int) -> None:
    """Engine-level differential: one RANDOM submission schedule through
    the native per-tick fast path AND the Python tick path (the
    semantics owner), via the shared gate — identical decision ledgers
    and byte-identical replica state required."""
    from rabia_tpu_torch.testing.conformance import run_schedule_on_both_tick_paths

    rng = np.random.default_rng(seed + 191)
    S = int(rng.choice([1, 2, 3]))
    R = int(rng.choice([3, 5]))
    waves = int(rng.integers(2, 5))
    schedule = []
    for w in range(waves):
        covered = sorted(
            rng.choice(S, size=int(rng.integers(1, S + 1)), replace=False)
        )
        schedule.append(
            {
                int(s): [
                    f"SET w{w}s{s}k{j} v{int(rng.integers(0, 9))}"
                    for j in range(int(rng.integers(1, 3)))
                ]
                for s in covered
            }
        )
    try:
        await run_schedule_on_both_tick_paths(
            schedule, n_shards=S, n_replicas=R, tag=f"tick seed={seed}"
        )
    except AssertionError as e:
        # triage context: the gate embeds the deterministic counter
        # subset for both paths in its message AND writes both paths'
        # flight-recorder dumps (to $RABIA_FLIGHT_DIR, default
        # flight-dumps/) — surface all of it loudly next to the repro seed
        print(
            f"tick-path divergence (seed={seed}, S={S}, R={R}): {e}",
            file=sys.stderr,
        )
        raise


async def _trial_runtime_paths(seed: int) -> None:
    """Engine-level differential: one RANDOM schedule of SET waves
    (scalar + block lanes) through the native engine runtime
    (runtime.cpp io/tick thread) AND the asyncio orchestration
    (``RABIA_PY_RUNTIME=1``, the semantics owner) over native TCP —
    identical decision ledgers, client responses, replica state and
    counters required (~8s each: two real TCP clusters)."""
    from rabia_tpu_torch.testing.conformance import run_schedule_on_runtime_paths

    rng = np.random.default_rng(seed + 733)
    S = int(rng.choice([2, 3, 4]))
    R = int(rng.choice([3, 5]))
    # thread-per-shard-group geometry: half the trials run the runtime
    # leg multi-worker (clamped by the shard count) so worker routing
    # fuzzes alongside the schedules; an explicit RABIA_RT_WORKERS pins
    # the geometry instead
    env_w = os.environ.get("RABIA_RT_WORKERS")
    workers = None if env_w else min(int(rng.choice([1, 2])), S)
    waves = int(rng.integers(3, 6))
    schedule = []
    for w in range(waves):
        covered = sorted(
            rng.choice(S, size=int(rng.integers(1, S + 1)), replace=False)
        )
        schedule.append(
            {
                int(s): [
                    (f"w{w}s{s}k{j}", f"v{int(rng.integers(0, 9))}")
                    for j in range(int(rng.integers(1, 3)))
                ]
                for s in covered
            }
        )
    try:
        await run_schedule_on_runtime_paths(
            schedule, n_shards=S, n_replicas=R,
            tag=f"runtime seed={seed} workers={workers or env_w or 'auto'}",
            workers=workers,
        )
    except AssertionError as e:
        print(
            f"runtime-path divergence (seed={seed}, S={S}, R={R}, "
            f"workers={workers or env_w or 'auto'}): {e}",
            file=sys.stderr,
        )
        raise


def _trial_apply_paths(seed: int) -> None:
    """Apply-plane differential: one RANDOM binary-op schedule through
    the native statekernel stores AND the Python KVStore stores (the
    semantics owner), via the shared gate — byte-identical per-op result
    frames and state hashes required. Ops are drawn to hit the edges:
    CAS misses, DELs of absent keys, oversized values, over-long and
    multi-byte keys, invalid UTF-8, unknown opcodes, replayed waves."""
    from rabia_tpu_torch.apps.kvstore import (
        encode_cas_bin,
        encode_op_bin,
        encode_set_bin,
        KVOperation,
        KVOpType,
    )
    from rabia_tpu_torch.testing.conformance import run_ops_on_both_apply_paths

    rng = np.random.default_rng(seed + 313)
    S = int(rng.choice([1, 2, 4]))
    keys = (
        ["k%d" % i for i in range(6)]
        + ["κλειδί", "ключ", "k" * 24, "k" * 25]  # unicode + length edge
    )

    def one_op() -> bytes:
        k = keys[int(rng.integers(0, len(keys)))]
        r = float(rng.random())
        if r < 0.35:
            return encode_set_bin(k, "v" * int(rng.integers(0, 140)))
        if r < 0.50:
            return encode_cas_bin(
                k, "c%d" % int(rng.integers(0, 9)),
                int(rng.integers(0, 6)),
            )
        if r < 0.62:
            return encode_op_bin(KVOperation.get(k))
        if r < 0.74:
            return encode_op_bin(KVOperation.delete(k))
        if r < 0.80:
            return encode_op_bin(KVOperation.exists(k))
        if r < 0.83:
            return encode_op_bin(KVOperation(KVOpType.Clear))
        if r < 0.85:
            return b""  # zero-length command (trailing-offset edge)
        if r < 0.88:
            return b"\x01\x03\x00\xff\xfe\xfdxy"  # invalid utf-8 key
        if r < 0.91:
            return b"\x01\xff\x7f"  # klen exceeds payload
        if r < 0.95:
            return bytes([int(rng.integers(7, 250))]) + b"\x01\x00k"
        return b"\x06\x02\x00kk\x01"  # short CAS version field
    waves = int(rng.integers(3, 8))
    schedule = []
    for _ in range(waves):
        covered = sorted(
            rng.choice(S, size=int(rng.integers(1, S + 1)), replace=False)
        )
        schedule.append(
            {
                int(s): [one_op() for _ in range(int(rng.integers(1, 6)))]
                for s in covered
            }
        )
    # replay a random earlier wave verbatim (duplicate-delivery shape)
    schedule.append(dict(schedule[int(rng.integers(0, len(schedule)))]))
    run_ops_on_both_apply_paths(
        schedule, n_shards=S, tag=f"apply seed={seed}"
    )


def _trial_gateway_tables(seed: int) -> None:
    """Gateway-plane differential: one RANDOM session-table op schedule
    (hello/submit/complete/abort/gc with time jumps past the idle ttl
    and the hard lease) through the native sessionkernel table AND the
    Python SessionTable (the semantics owner) — identical decisions,
    byte-identical cached reply payloads, identical GC survivors and
    stats required. Sub-second each."""
    from rabia_tpu_torch.testing.conformance import (
        random_gateway_ops,
        run_gateway_ops_on_both_tables,
    )

    run_gateway_ops_on_both_tables(
        random_gateway_ops(seed + 517), tag=f"gateway seed={seed}"
    )


def _trial_wal_paths(seed: int) -> None:
    """Durability-plane differential: one RANDOM record sequence (waves
    with binary ops and V0 gaps, barriers, ledgers, frontier marks)
    through the C walkernel writer AND the pure-Python twin (the byte
    format's semantics owner) — byte-identical segment files, identical
    recovery scans, identical torn-tail truncation at a random cut, and
    identical replayed state through both apply paths. Sub-second each."""
    from rabia_tpu_torch.testing.conformance import (
        random_wal_records,
        run_waves_on_both_wal_paths,
    )

    run_waves_on_both_wal_paths(
        random_wal_records(seed + 911), tag=f"wal seed={seed}"
    )


def _trial_coalesce_paths(seed: int) -> None:
    """Coalescing-lane differential: one RANDOM multi-client submit
    schedule through a coalesce-ON gateway cluster and the per-submit
    lane — semantically identical per-client responses, identical
    key/value state + per-shard mutation counts (the double-apply
    detector), and byte-identical full-replay answers within each leg.
    The ON leg must actually pack multi-client waves. ~10s each."""
    import asyncio

    from rabia_tpu_torch.testing.conformance import (
        random_coalesce_schedule,
        run_submits_on_coalesce_paths,
    )

    rounds, n_clients, n_shards = random_coalesce_schedule(seed + 2113)
    asyncio.run(
        run_submits_on_coalesce_paths(
            rounds, n_clients, n_shards, tag=f"coalesce seed={seed}"
        )
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument(
        "--device", default=None,
        help="where the kernel, mesh and plane trials run: CUDA unless "
        "given (e.g. 'cpu', where every kernel takes its plain version); "
        "without a card and without this flag the script raises",
    )
    ap.add_argument(
        "--planes", type=int, default=0,
        help="additionally run N engine-level plane-differential trials "
        "(random schedules through the transport engine AND MeshEngine; "
        "~4s each)",
    )
    ap.add_argument(
        "--tick", type=int, default=0,
        help="additionally run N native-vs-Python tick-path differential "
        "trials (random schedules through the transport engine with the "
        "hostkernel rk_tick fast path on, then with RABIA_PY_TICK=1; "
        "identical decisions/state required; ~4s each)",
    )
    ap.add_argument(
        "--apply", type=int, default=0,
        help="additionally run N native-vs-Python APPLY-path differential "
        "trials (random binary-op schedules through the statekernel "
        "stores and the Python KVStore; byte-identical result frames + "
        "state hashes required; sub-second each)",
    )
    ap.add_argument(
        "--runtime", type=int, default=0,
        help="additionally run N native-runtime differential trials "
        "(random scalar+block schedules through the GIL-free runtime "
        "thread over TCP, then with RABIA_PY_RUNTIME=1; identical "
        "decisions/responses/state required; ~8s each)",
    )
    ap.add_argument(
        "--gateway", type=int, default=0,
        help="additionally run N native-vs-Python gateway session-table "
        "differential trials (random hello/submit/complete/abort/gc "
        "schedules through the sessionkernel table and the Python "
        "SessionTable; identical decisions + byte-identical cached "
        "replies + identical GC survivors required; sub-second each)",
    )
    ap.add_argument(
        "--wal", type=int, default=0,
        help="additionally run N durability-plane differential trials "
        "(random WAL record sequences through the C walkernel writer "
        "and the Python twin; byte-identical segments + identical "
        "torn-tail recovery + identical replayed state required; "
        "sub-second each)",
    )
    ap.add_argument(
        "--coalesce", type=int, default=0,
        help="additionally run N coalescing-lane differential trials "
        "(random multi-client submit schedules through a coalesce-ON "
        "gateway cluster and the per-submit lane; identical responses/"
        "state/mutation counts + byte-identical replays required; "
        "~10s each)",
    )
    ap.add_argument(
        "--mesh", type=int, default=0,
        help="additionally run N mesh-plane fault trials (crash schedules "
        "through MeshPhaseKernel's replica exchanges + loss/crash "
        "through ShardedClusterKernel's shard blocks) on a logical "
        "8-device mesh of --device, each diffed against the one-device "
        "ClusterKernel",
    )
    args = ap.parse_args(argv)

    from rabia_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)  # raises without a card unless --device cpu
    get_kernel = _kernels(device)
    # warmup: build every pool geometry's kernel (and, on a card, the
    # CUDA libraries) BEFORE the budget clock starts, so --seconds buys
    # schedules, not builds
    t0 = time.time()
    for i in range(len(GEOMETRY_POOL)):
        _trial_stepwise(get_kernel, args.base_seed + i)
        _trial_fused(get_kernel, args.base_seed + i)
    warm_s = time.time() - t0
    deadline = time.time() + args.seconds
    trial = len(GEOMETRY_POOL)
    while time.time() < deadline:
        seed = args.base_seed + trial
        _trial_stepwise(get_kernel, seed)
        _trial_fused(get_kernel, seed)
        trial += 1
    mesh_trials = 0
    if args.mesh > 0:
        get_mesh = _mesh_kernels(device)
        for geo in MESH_GEOMETRY_POOL:  # build warmup
            get_mesh(geo)
        for i in range(args.mesh):
            _trial_mesh_crash(get_mesh, args.base_seed + i)
            _trial_sharded_lossy(get_mesh, args.base_seed + i)
            mesh_trials += 1
    plane_trials = 0
    if args.planes > 0:
        import asyncio

        for i in range(args.planes):
            asyncio.run(_trial_planes(args.base_seed + i, device))
            plane_trials += 1
    tick_trials = 0
    if args.tick > 0:
        import asyncio

        for i in range(args.tick):
            asyncio.run(_trial_tick_paths(args.base_seed + i))
            tick_trials += 1
    apply_trials = 0
    if args.apply > 0:
        for i in range(args.apply):
            _trial_apply_paths(args.base_seed + i)
            apply_trials += 1
    gateway_trials = 0
    if args.gateway > 0:
        for i in range(args.gateway):
            _trial_gateway_tables(args.base_seed + i)
            gateway_trials += 1
    runtime_trials = 0
    if args.runtime > 0:
        import asyncio

        for i in range(args.runtime):
            asyncio.run(_trial_runtime_paths(args.base_seed + i))
            runtime_trials += 1
    wal_trials = 0
    if args.wal > 0:
        for i in range(args.wal):
            _trial_wal_paths(args.base_seed + i)
            wal_trials += 1
    coalesce_trials = 0
    if args.coalesce > 0:
        for i in range(args.coalesce):
            _trial_coalesce_paths(args.base_seed + i)
            coalesce_trials += 1
    extra = (
        f"; {plane_trials} plane-differential schedules identical"
        if plane_trials
        else ""
    )
    if tick_trials:
        extra += f"; {tick_trials} tick-path differential schedules identical"
    if apply_trials:
        extra += (
            f"; {apply_trials} apply-path differential schedules identical"
        )
    if runtime_trials:
        extra += (
            f"; {runtime_trials} runtime-path differential schedules "
            "identical"
        )
    if gateway_trials:
        extra += (
            f"; {gateway_trials} gateway-table differential schedules "
            "identical"
        )
    if wal_trials:
        extra += (
            f"; {wal_trials} durability-plane differential sequences "
            "identical"
        )
    if coalesce_trials:
        extra += (
            f"; {coalesce_trials} coalescing-lane differential "
            "schedules identical"
        )
    if mesh_trials:
        extra += (
            f"; {mesh_trials} mesh-plane fault schedules conformant "
            "(crash x replica exchange, loss+crash x shard blocks)"
        )
    print(
        f"fuzz OK: {trial} random schedules conformant "
        f"(kernel==oracle stepwise; fused==scan), no divergence "
        f"(warmup {warm_s:.0f}s excluded from budget){extra}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
