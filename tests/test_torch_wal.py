"""The port's durability plane (``rabia_tpu_torch/persistence/native_wal.py``
over the port's ``native/walkernel.cpp``).

The port's copy of the reference's tests/test_wal.py (WAL format,
torn-write recovery, incremental snapshots, native-runtime engagement on
a durable cluster, the kill -9 crash-recovery smoke, the ``wal-dump``
command line). Then the cross-package
checks (``TestAcrossPackages``): the port's C writer, its Python writer
and the reference's C writer write byte-identical segments from one
record sequence; a WAL directory written by either package recovers in
the other to equal stores; and a torn tail cut at every offset across a
record boundary scans and truncates alike in both packages.
"""

from __future__ import annotations

import asyncio
import os
import struct
import uuid
from pathlib import Path

import pytest

from rabia_tpu_torch.apps.kvstore import decode_kv_response, encode_set_bin
from rabia_tpu_torch.persistence.native_wal import (
    SEG_HEADER,
    WalPersistence,
    decode_record,
    encode_barrier,
    encode_frontier,
    encode_ledger,
    encode_wave,
    scan_wal,
    truncate_torn_tail,
)


def _mk_records(n: int = 12) -> list[bytes]:
    out = []
    for i in range(n):
        out.append(
            encode_wave(
                i % 4, i // 4, 1, bytes([i]) * 16,
                [b"\x01\x02\x00k%d" % i + b"v" * (i % 7)],
            )
        )
    return out


class TestWalFormat:
    def test_record_roundtrip(self):
        ops = [b"\x01\x03\x00abcv1", b"", b"\xffgarbage"]
        bid = uuid.uuid4().bytes
        rec = decode_record(encode_wave(3, 77, 1, bid, ops))
        assert rec["kind"] == 1
        assert (rec["shard"], rec["slot"], rec["value"]) == (3, 77, 1)
        assert rec["bid"] == bid
        assert rec["ops"] == ops
        rec = decode_record(encode_wave(0, 5, 0, None, None))
        assert rec["ops"] is None and rec["bid"] is None
        vec = struct.pack("<4q", 1, 2, 3, 4)
        assert decode_record(encode_barrier(vec))["barrier"] == [1, 2, 3, 4]
        fr = decode_record(encode_frontier(7, 99, [5, 6]))
        assert fr["snap_index"] == 7 and fr["applied"] == [5, 6]
        led = decode_record(encode_ledger(2, 11, bid))
        assert (led["shard"], led["slot"], led["bid"]) == (2, 11, bid)

    def test_writer_scan_roundtrip_and_rotation(self, tmp_path):
        p = WalPersistence(tmp_path, segment_bytes=256, n_shards=4)
        recs = _mk_records(40)
        for r in recs:
            p._writer.append(r)
        p.flush_sync()
        p.close()
        scan = scan_wal(tmp_path)
        assert scan.torn is None
        assert [r[3] for r in scan.records] == recs
        assert len(list(tmp_path.glob("wal-*.seg"))) > 1  # rotated

    def test_lsn_continues_across_restart(self, tmp_path):
        p = WalPersistence(tmp_path, n_shards=4)
        for r in _mk_records(5):
            p._writer.append(r)
        p.flush_sync()
        p.close()
        p2 = WalPersistence(tmp_path, n_shards=4)
        assert p2.staged_lsn() == 5
        lsn = p2.stage_wave(0, 9, 0, None, None)
        assert lsn == 6
        p2.flush_sync()
        p2.close()
        assert scan_wal(tmp_path).last_lsn == 6


class TestTornWriteRecovery:
    def test_truncation_at_every_offset_across_a_record_boundary(
        self, tmp_path
    ):
        """The satellite pin: cut the log at EVERY byte offset across
        the last record's frame; recovery must land exactly on the last
        WHOLE record before the cut — never a torn apply, never a
        crash."""
        base = tmp_path / "base"
        base.mkdir()
        p = WalPersistence(base, n_shards=4)
        recs = _mk_records(6)
        for r in recs:
            p._writer.append(r)
        p.flush_sync()
        p.close()
        seg = next(base.glob("wal-*.seg"))
        blob = seg.read_bytes()
        # frame boundaries: offsets where records START
        bounds = [SEG_HEADER]
        pos = SEG_HEADER
        while pos < len(blob):
            plen = struct.unpack_from("<I", blob, pos)[0]
            pos += 8 + plen
            bounds.append(pos)
        # cut at every offset spanning the LAST record (and the frame
        # header of the one before it)
        for cut in range(bounds[-3], len(blob) + 1):
            d = tmp_path / f"cut{cut}"
            d.mkdir()
            (d / seg.name).write_bytes(blob[:cut])
            scan = scan_wal(d)
            whole = sum(1 for b in bounds[1:] if b <= cut)
            assert len(scan.records) == whole, (
                f"cut at {cut}: expected {whole} whole records, "
                f"scanned {len(scan.records)}"
            )
            assert [r[3] for r in scan.records] == recs[:whole]
            if cut in bounds:
                assert scan.torn is None
            else:
                assert scan.torn is not None
            # truncation leaves a clean log that re-scans identically
            truncate_torn_tail(d, scan)
            rescan = scan_wal(d)
            assert rescan.torn is None
            assert [r[3] for r in rescan.records] == recs[:whole]
            # and a new writer continues from the truncated prefix
            p2 = WalPersistence(d, n_shards=4)
            assert p2.staged_lsn() == whole
            p2.close()

    def test_corrupt_byte_flags_crc(self, tmp_path):
        p = WalPersistence(tmp_path, n_shards=4)
        for r in _mk_records(4):
            p._writer.append(r)
        p.flush_sync()
        p.close()
        seg = next(tmp_path.glob("wal-*.seg"))
        blob = bytearray(seg.read_bytes())
        blob[-3] ^= 0xFF  # flip a byte inside the last payload
        seg.write_bytes(bytes(blob))
        scan = scan_wal(tmp_path)
        assert scan.torn is not None
        assert scan.torn["reason"] == "crc mismatch"
        assert len(scan.records) == 3


class TestWalConformance:
    def test_byte_parity_fixed_seeds(self):
        from rabia_tpu_torch.testing.conformance import (
            random_wal_records,
            run_waves_on_both_wal_paths,
        )

        for seed in (3, 20260803):
            run_waves_on_both_wal_paths(
                random_wal_records(seed, 200), tag=f"fixed seed={seed}"
            )


class TestIncrementalSnapshots:
    def test_delta_tracks_mutations_and_deletions(self):
        from rabia_tpu_torch.apps.native_store import NativeStorePlane
        from rabia_tpu_torch.persistence.native_wal import decode_store_delta

        if not _native_wal_available():
            pytest.skip("statekernel unavailable")
        pl = NativeStorePlane(1)

        def _set(k, v):
            return bytes([1]) + len(k).to_bytes(2, "little") + k + v

        def _del(k):
            return bytes([3]) + len(k).to_bytes(2, "little") + k

        pl.apply_ops(0, [_set(b"a", b"1"), _set(b"b", b"2")], 1.0)
        cleared, dels, ents = decode_store_delta(pl.snapshot_delta(0))
        assert not cleared and not dels and len(ents) == 2
        pl.snapshot_mark(0)
        cleared, dels, ents = decode_store_delta(pl.snapshot_delta(0))
        assert not dels and not ents  # clean after mark
        pl.apply_ops(0, [_del(b"a"), _set(b"c", b"3")], 2.0)
        cleared, dels, ents = decode_store_delta(pl.snapshot_delta(0))
        assert dels == [b"a"]
        assert [e[0] for e in ents] == [b"c"]
        pl.close()

    @pytest.mark.asyncio
    async def test_checkpoint_chain_and_gc(self, tmp_path):
        """Checkpoints write delta frames, GC drops covered segments,
        and restore replays the chain byte-identically."""
        from rabia_tpu_torch.apps.sharded import make_sharded_kv

        sm, machines = make_sharded_kv(2)
        if sm._native_plane is None:
            pytest.skip("native plane unavailable")
        p = WalPersistence(
            tmp_path, segment_bytes=1024, n_shards=2, rebase_every=4
        )
        plane = sm._native_plane

        def _set(k, v):
            return bytes([1]) + len(k).to_bytes(2, "little") + k + v

        meta = {"next_slot": [0, 0], "applied_upto": [0, 0],
                "state_version": 0, "v1_applied": [0, 0]}
        for round_i in range(3):
            for i in range(30):
                plane.apply_ops(
                    i % 2, [_set(b"k%d" % i, b"v%d" % round_i)], 1.0
                )
                p.stage_wave(
                    i % 2, round_i * 15 + i // 2, 1, None,
                    [_set(b"k%d" % i, b"v%d" % round_i)],
                )
            meta = {
                "next_slot": [15 * (round_i + 1)] * 2,
                "applied_upto": [15 * (round_i + 1)] * 2,
                "state_version": 30 * (round_i + 1),
                "v1_applied": [15 * (round_i + 1)] * 2,
            }
            await p.checkpoint(meta, sm)
        assert p.checkpoints == 3
        snaps = sorted(tmp_path.glob("snap-*.dat"))
        assert len(snaps) == 3
        # chain restore into a FRESH plane lands on identical state
        sm2, machines2 = make_sharded_kv(2)
        p2 = WalPersistence(tmp_path, segment_bytes=1024, n_shards=2)
        meta2 = p2.restore_chain_into(sm2)
        assert meta2 is not None
        assert int(meta2["state_version"]) == 90
        for s in range(2):
            assert (
                machines[s].store.checksum()
                == machines2[s].store.checksum()
            )
            assert (
                machines[s].store.version == machines2[s].store.version
            )
        p.close()
        p2.close()


def _native_wal_available() -> bool:
    from rabia_tpu_torch.native.build import load_statekernel

    return load_statekernel() is not None


class TestRecoveryGuards:
    def test_replay_stops_at_slot_gap(self, tmp_path):
        """A crash in the sync-adoption -> checkpoint window leaves a
        slot gap in the WAL; replay must stop the shard AT the gap
        (divergent-state guard), not apply past it."""
        from rabia_tpu_torch.apps.sharded import make_sharded_kv
        from rabia_tpu_torch.core.config import RabiaConfig
        from rabia_tpu_torch.core.network import ClusterConfig
        from rabia_tpu_torch.core.types import NodeId
        from rabia_tpu_torch.engine import RabiaEngine
        from rabia_tpu_torch.net import InMemoryHub

        p = WalPersistence(tmp_path, n_shards=2)
        op = b"\x01\x01\x00kv"
        p.stage_wave(0, 0, 1, bytes(16), [op])
        p.stage_wave(0, 3, 1, bytes(16), [op])  # gap: slots 1-2 missing
        p.flush_sync()
        p.close()
        p2 = WalPersistence(tmp_path, n_shards=2)
        hub = InMemoryHub()
        nid = NodeId.from_int(1)
        sm, _m = make_sharded_kv(2)
        cfg = RabiaConfig().with_kernel(num_shards=2, shard_pad_multiple=2)
        eng = RabiaEngine(
            ClusterConfig.new(nid, [nid]), sm, hub.register(nid),
            persistence=p2, config=cfg,
        )
        rep = p2.recover_engine(eng)
        assert rep["waves_replayed"] == 1  # slot 0 only
        assert int(eng.rt.applied_upto[0]) == 1  # stopped AT the gap
        p2.close()

    def test_barrier_survives_wal_prefix_gc(self, tmp_path):
        """The vote barrier rides the checkpoint chain meta: even after
        every K_BARRIER-bearing segment is GC'd, recovery still
        restores the vector (elementwise max of chain + records)."""
        import numpy as np

        from rabia_tpu_torch.apps.sharded import make_sharded_kv

        sm, _m = make_sharded_kv(2)
        p = WalPersistence(tmp_path, segment_bytes=1024, n_shards=2)
        p._writer.set_barrier(np.asarray([7, 9], np.int64))
        p._writer.append(encode_barrier(struct.pack("<2q", 7, 9)))
        # filler forces rotation so the barrier-bearing segment is not
        # the open one (the case GC can actually unlink)
        for i in range(40):
            p.stage_wave(i % 2, i // 2, 1, bytes(16), [b"\x01\x01\x00kv"])
        asyncio.run(
            p.checkpoint(
                {"next_slot": [20, 20], "applied_upto": [20, 20],
                 "state_version": 40, "v1_applied": [20, 20]}, sm,
            )
        )
        p.flush_sync()
        p.close()
        segs = sorted(tmp_path.glob("wal-*.seg"))
        assert segs, "no segments on disk"
        # the barrier-bearing first segment must be GONE below the
        # checkpoint frontier: either the checkpoint's REAL WAL-prefix
        # GC already unlinked it (the flush thread rotated before the
        # checkpoint — timing-dependent), or we simulate the loss by
        # unlinking everything but the open tail
        assert p.gc_segments > 0 or len(segs) > 1, (
            "filler did not rotate a segment"
        )
        for seg in segs[:-1]:
            seg.unlink()
        p2 = WalPersistence(tmp_path, segment_bytes=1024, n_shards=2)
        assert p2.recovered.barrier is not None
        vec = list(struct.unpack("<2q", p2.recovered.barrier))
        assert vec == [7, 9]
        p2.close()


class TestBackendsOrphanSweep:
    @pytest.mark.asyncio
    async def test_sweep_does_not_race_live_aux_write(self, tmp_path):
        """Regression (satellite): constructing a SECOND
        FileSystemPersistence on a directory must not unlink a sibling
        instance's in-flight tmp file — its os.replace would fail with
        ENOENT and drop the aux write."""
        import threading

        from rabia_tpu_torch.persistence.backends import FileSystemPersistence

        a = FileSystemPersistence(tmp_path)
        # hold a tmp file alive exactly as an executor-thread aux write
        # would, while a second instance runs its constructor sweep
        start = threading.Event()
        stop = threading.Event()
        errors: list[Exception] = []

        def writer() -> None:
            try:
                for i in range(200):
                    if i == 5:
                        start.set()
                    a._atomic_write(
                        a._aux_path("vote_barrier"), b"x" * 64
                    )
                    if stop.is_set():
                        break
            except Exception as e:  # noqa: BLE001
                errors.append(e)
            finally:
                start.set()

        th = threading.Thread(target=writer)
        th.start()
        start.wait(5)
        for _ in range(20):
            FileSystemPersistence(tmp_path)  # constructor sweep
        stop.set()
        th.join(10)
        assert not errors, f"aux write lost to the orphan sweep: {errors}"
        assert (await a.load_aux("vote_barrier")) == b"x" * 64

    def test_sweep_still_removes_foreign_orphans(self, tmp_path):
        from rabia_tpu_torch.persistence.backends import FileSystemPersistence

        orphan = tmp_path / "state.tmp99999.0"  # a dead pid's leftovers
        tmp_path.mkdir(exist_ok=True)
        orphan.write_bytes(b"junk")
        FileSystemPersistence(tmp_path)
        assert not orphan.exists()


class TestDurableNativeRuntime:
    @pytest.mark.asyncio
    async def test_native_runtime_engages_with_wal_persistence(self):
        """The headline unlock: a persistence-ON cluster runs the
        GIL-free commit path when the persistence layer is the native
        WAL (the historical gate forced asyncio for ANY persistence)."""
        from rabia_tpu_torch.native.build import load_runtime, load_walkernel
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        if load_runtime() is None or load_walkernel() is None:
            pytest.skip("native runtime/walkernel unavailable")
        c = GatewayCluster(3, 2, persistence="wal")
        try:
            await c.start()
            assert all(e._rtm is not None for e in c.engines), (
                "native runtime did not engage on the WAL cluster"
            )
            assert all(e._wal is not None and e._wal.native
                       for e in c.engines)
        finally:
            await c.stop()

    @pytest.mark.asyncio
    async def test_gil_handoffs_flat_and_waves_durable_on_wal_cluster(self):
        """Acceptance: on a DURABLE (WAL) cluster, a wave-lane submit ->
        result round trip grows waves_native with gil_handoffs flat, and
        the decided wave is durable (WLC wave count + durable watermark)
        before the result frame left the replica."""
        from rabia_tpu_torch.gateway.client import RabiaClient
        from rabia_tpu_torch.native.build import (
            load_runtime,
            load_sessionkernel,
            load_walkernel,
        )
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        if (
            load_runtime() is None
            or load_walkernel() is None
            or load_sessionkernel() is None
        ):
            pytest.skip("native libraries unavailable")
        c = GatewayCluster(3, 2, persistence="wal")
        cli = None
        try:
            await c.start()
            e0 = c.engines[0]
            if e0._rtm is None:
                pytest.skip("native runtime did not engage")
            cli = RabiaClient([c.endpoint(0)], call_timeout=30.0)
            await cli.connect()
            await asyncio.sleep(0.3)
            deadline = asyncio.get_event_loop().time() + 20.0
            hit = False
            k = 0
            while asyncio.get_event_loop().time() < deadline:
                before = e0._rtm.counters_dict()
                wal_before = e0._wal.counters_dict()
                resp = await cli.submit(
                    k % 2, [encode_set_bin(f"gilk{k}", "v")]
                )
                assert decode_kv_response(resp[0]).ok
                after = e0._rtm.counters_dict()
                wal_after = e0._wal.counters_dict()
                k += 1
                if after["waves_native"] > before["waves_native"]:
                    # the wave lane fired: the C thread applied AND
                    # staged the wave; results only left after the
                    # durability barrier
                    assert (
                        after["gil_handoffs"] == before["gil_handoffs"]
                    ), (
                        "durable submit->result round trip required a "
                        f"GIL handoff: {before} -> {after}"
                    )
                    assert wal_after["waves"] > wal_before["waves"], (
                        "wave-lane commit staged no WAL record"
                    )
                    assert e0._wal.durable_lsn() >= 1
                    hit = True
                    break
            assert hit, "no wave-lane submit landed within the deadline"
        finally:
            if cli is not None:
                await cli.close()
            await c.stop()

    @pytest.mark.asyncio
    async def test_restart_recovers_from_chain_plus_replay(self):
        """In-process restart on the WAL plane: the restarted replica
        recovers from snapshot chain + WAL replay and reconverges."""
        from rabia_tpu_torch.gateway.client import RabiaClient
        from rabia_tpu_torch.native.build import load_walkernel
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        if load_walkernel() is None and os.environ.get("RABIA_PY_WAL") != "1":
            pytest.skip("walkernel unavailable")
        c = GatewayCluster(3, 2, persistence="wal")
        cli = None
        try:
            await c.start()
            cli = RabiaClient(c.endpoints(), call_timeout=30.0)
            await cli.connect()
            for k in range(24):
                resp = await cli.submit(
                    k % 2, [encode_set_bin(f"rk{k}", f"v{k}")]
                )
                assert decode_kv_response(resp[0]).ok
            await cli.close()
            cli = None
            await c.restart_replica(1, settle=0.3)
            await c.wait_converged(20)
            rec = c.persists[1].last_recovery
            assert rec["chain_files"] + rec["waves_replayed"] > 0, (
                f"restart recovered nothing: {rec}"
            )
            r = c.store(1, 0).get("rk0")
            assert getattr(r, "value", None) == "v0" or r == "v0"
        finally:
            if cli is not None:
                await cli.close()
            await c.stop()


class TestCrashRecoverySmoke:
    @pytest.mark.asyncio
    async def test_kill9_restart_rejoins_under_load(self):
        """The CI recovery smoke cell: 3 real replica processes on the
        durability plane, kill -9 one under sustained loadgen traffic,
        restart it, assert rejoin within budget and non-zero
        post-rejoin goodput."""
        from rabia_tpu_torch.testing.recovery import run_crash_recovery_trial

        report = await run_crash_recovery_trial(
            preload_keys=40, rejoin_timeout=90.0
        )
        assert report["rejoined"], f"replica never rejoined: {report}"
        assert report["rejoin_under_load_s"] < 90.0
        assert report["post_rejoin_goodput_ok"] > 0, (
            f"cluster made no progress after rejoin: {report}"
        )
        # the restarted process actually recovered durable state
        assert (report["waves_replayed"] or 0) + (
            report["chain_files"] or 0
        ) > 0, f"nothing recovered: {report}"


class TestWalDumpCli:
    def test_wal_dump_renders_and_flags_torn_tail(self, tmp_path, capsys):
        from rabia_tpu_torch.__main__ import main as cli_main

        p = WalPersistence(tmp_path, n_shards=2)
        for i in range(8):
            p.stage_wave(i % 2, i // 2, 1, bytes(16), [b"\x01\x01\x00kv"])
        p.flush_sync()
        p.close()
        assert cli_main(["wal-dump", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "records: 8" in out and "crc=ok" in out
        # torn tail flags, never crashes
        seg = sorted(tmp_path.glob("wal-*.seg"))[-1]
        with open(seg, "ab") as f:
            f.write(b"\x55" * 9)
        assert cli_main(["wal-dump", str(tmp_path), "--records"]) == 0
        out = capsys.readouterr().out
        assert "torn tail" in out and "TORN" in out


class TestChildrenFollowTheirParent:
    def test_replica_processes_exit_when_the_harness_dies(self):
        """A harness killed before ``stop()`` (a time limit, a crash)
        leaves no replica process behind: each child exits once its
        parent is gone."""
        import subprocess
        import sys
        import time

        code = (
            "import os\n"
            "from rabia_tpu_torch.testing.recovery import RecoveryHarness\n"
            "h = RecoveryHarness(3, 4)\n"
            "h.start()\n"
            "print(' '.join(str(p.proc.pid) for p in h.procs), flush=True)\n"
            "os._exit(0)\n"
        )
        def running(pid: int) -> bool:
            try:  # a zombie waits for its reaper: it no longer runs
                return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
            except OSError:
                return False

        repo = Path(__file__).resolve().parent.parent
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, cwd=repo,
            env={**os.environ, "PYTHONPATH": str(repo)},
        )
        pids = [int(x) for x in out.stdout.split()]
        assert len(pids) == 3, out.stderr[-2000:]
        deadline = time.time() + 20.0
        alive = pids
        while alive and time.time() < deadline:
            time.sleep(0.2)
            alive = [p for p in alive if running(p)]
        for p in alive:  # leave nothing running, then fail
            os.kill(p, 9)
        assert not alive, f"replica processes outlived their parent: {alive}"


class TestReceiverLedgerCompleteness:
    """Receiver-side batch-id ledger backfill (ROADMAP 3c / chaos-plane
    satellite): NON-proposer replicas must resolve a batch id for every
    V1 wave the C runtime staged with a zero bid field — via the
    EV_LEDGER-driven K_LEDGER records — so a follower's crash replay
    repopulates its ``applied_ids`` dedup ledger in parity with the
    proposer's."""

    @pytest.mark.asyncio
    async def test_follower_wal_resolves_every_v1_bid_and_replay_parity(
        self, tmp_path
    ):
        import shutil

        from rabia_tpu_torch.core.blocks import block_batch_id  # noqa: F401
        from rabia_tpu_torch.gateway.client import RabiaClient
        from rabia_tpu_torch.native.build import (
            load_runtime,
            load_sessionkernel,
            load_walkernel,
        )
        from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

        if (
            load_runtime() is None
            or load_walkernel() is None
            or load_sessionkernel() is None
        ):
            pytest.skip("native libraries unavailable")
        c = GatewayCluster(
            3, 2, persistence="wal",
            # no periodic checkpoints: the whole run must stay in the
            # replayable WAL suffix (a clean shutdown's final checkpoint
            # would fence it; the mid-run dir copy below simulates the
            # crash shape recovery actually faces)
            wal_kwargs={
                "checkpoint_interval": 3600.0,
                "checkpoint_bytes": 1 << 30,
            },
        )
        cli = None
        crash_copies = {}
        try:
            await c.start()
            if any(e._rtm is None for e in c.engines):
                pytest.skip("native runtime did not engage")
            cli = RabiaClient([c.endpoint(0)], call_timeout=30.0)
            await cli.connect()
            for k in range(24):
                resp = await cli.submit(
                    k % 2, [encode_set_bin(f"led{k}", f"v{k}")]
                )
                assert decode_kv_response(resp[0]).ok
            await cli.close()
            cli = None
            await asyncio.sleep(0.5)
            for e in c.engines:
                e._wal.flush_sync()
            # crash-shaped evidence: copy the durable dirs NOW (no clean
            # shutdown checkpoint in the copy)
            for r in range(3):
                dst = tmp_path / f"crash-{r}"
                shutil.copytree(f"{c.wal_dir}/replica-{r}", dst)
                crash_copies[r] = dst
        finally:
            if cli is not None:
                await cli.close()
            await c.stop()

        # scan-level parity: every replica resolves a bid for every V1
        # wave (zero-bid C-staged ones via K_LEDGER), and the resolved
        # (shard, slot) -> bid maps agree across replicas
        maps = {}
        zero_backfilled = {}
        for r, d in crash_copies.items():
            p = WalPersistence(d, n_shards=2)
            try:
                m = {}
                n_zero = 0
                for _lsn, rec in p.recovered.waves:
                    if rec["value"] != 1:
                        continue
                    bid = rec["bid"]
                    if not bid or bid == bytes(16):
                        n_zero += 1
                        # ledger values are LISTS since round 15 (the
                        # coalescing lane stages alias ids after the
                        # wave's own id); the wave's id is first
                        lst = p.recovered.ledger.get(
                            (rec["shard"], rec["slot"])
                        )
                        bid = lst[0] if lst else None
                    assert bid, (
                        f"replica {r}: V1 wave (shard {rec['shard']} "
                        f"slot {rec['slot']}) has no resolvable batch "
                        "id — receiver-side K_LEDGER backfill missing"
                    )
                    m[(rec["shard"], rec["slot"])] = bytes(bid)
                maps[r] = m
                zero_backfilled[r] = n_zero
            finally:
                p.close()
        assert any(m for m in maps.values()), "no V1 waves recovered"
        # at least one replica exercised the zero-bid (C-staged peer
        # block) lane — otherwise this test proved nothing
        assert sum(zero_backfilled.values()) > 0, (
            f"no zero-bid waves were staged anywhere: {zero_backfilled}"
        )
        for r in (1, 2):
            common = set(maps[0]) & set(maps[r])
            for key in common:
                assert maps[0][key] == maps[r][key], (
                    f"bid mismatch at {key}: proposer "
                    f"{maps[0][key].hex()} vs replica {r} "
                    f"{maps[r][key].hex()}"
                )

        # replay parity: recover a FOLLOWER copy into a fresh engine and
        # check the dedup ledger repopulates with the same ids
        follower = max(
            (r for r in maps if r != 0),
            key=lambda r: zero_backfilled[r],
        )
        from rabia_tpu_torch.apps.sharded import make_sharded_kv
        from rabia_tpu_torch.core.network import ClusterConfig
        from rabia_tpu_torch.engine import RabiaEngine
        from rabia_tpu_torch.net import NetworkSimulator

        p = WalPersistence(crash_copies[follower], n_shards=2)
        try:
            sim = NetworkSimulator()
            sm, _machines = make_sharded_kv(2)
            eng = RabiaEngine(
                ClusterConfig.new(c.ids[follower], c.ids),
                sm,
                sim.register(c.ids[follower]),
                persistence=p,
                config=c.config,
            )
            p.recover_engine(eng)
            replayed_ids = {
                bid.value.bytes
                for s in range(2)
                for bid in eng.rt.shards[s].applied_ids
            }
            missing = [
                key for key, bid in maps[follower].items()
                if bid not in replayed_ids
            ]
            assert not missing, (
                f"follower replay missed {len(missing)} batch ids in "
                f"applied_ids: {missing[:4]}"
            )
        finally:
            p.close()


class TestMultiWorkerWalOrdering:
    """Thread-per-shard-group runtime x durability plane (round 14):
    N workers stage decided waves through per-worker WAL lanes into the
    ONE group-commit flush thread. The staging mutex assigns LSNs, so
    the on-disk record sequence must stay monotone-contiguous, and a
    kill -9 mid-load must recover exactly as the single-worker runtime
    does (state parity across worker counts is pinned separately by
    run_schedule_on_runtime_paths)."""

    @pytest.mark.asyncio
    async def test_kill9_recovery_with_two_workers(self, monkeypatch):
        from rabia_tpu_torch.persistence.native_wal import scan_wal
        from rabia_tpu_torch.testing.recovery import run_crash_recovery_trial

        monkeypatch.setenv("RABIA_RT_WORKERS", "2")
        report = await run_crash_recovery_trial(
            n_shards=4, preload_keys=40, rejoin_timeout=90.0
        )
        assert report["rejoined"], f"replica never rejoined: {report}"
        assert report["post_rejoin_goodput_ok"] > 0, report
        # the restarted process replayed real durable state
        assert (report["waves_replayed"] or 0) + (
            report["chain_files"] or 0
        ) > 0, f"nothing recovered: {report}"
        # multi-lane staging yielded a monotone, contiguous LSN
        # sequence on disk: scan every replica's log — a discontinuity
        # or a mid-log tear is a staging-order violation (a tear in the
        # FINAL segment is an in-flight group commit at shutdown, the
        # normal crash shape)
        from pathlib import Path as _Path

        root = _Path(report["wal_root"])
        scanned = 0
        for sub in sorted(root.iterdir()):
            if not sub.is_dir():
                continue
            segs = sorted(sub.glob("wal-*.seg"))
            if not segs:
                continue
            scan = scan_wal(sub)
            scanned += 1
            assert scan.last_lsn > 0, f"{sub}: empty durable prefix"
            if scan.torn is not None:
                last_idx = max(
                    int(p.stem.split("-", 1)[1]) for p in segs
                )
                assert scan.torn["segment"] == last_idx, (
                    f"{sub}: mid-log tear/discontinuity under "
                    f"multi-worker staging: {scan.torn}"
                )
        assert scanned >= 3, f"expected 3 replica logs under {root}"
        # leave no tempdir behind on success
        import shutil as _shutil

        _shutil.rmtree(root, ignore_errors=True)


def _wal_pkg(name: str):
    """Namespace of one package's WAL surface: ``port`` or ``reference``."""
    import importlib
    import types

    root = "rabia_tpu_torch" if name == "port" else "rabia_tpu"
    nw = importlib.import_module(f"{root}.persistence.native_wal")
    return types.SimpleNamespace(
        name=name,
        nw=nw,
        sharded=importlib.import_module(f"{root}.apps.sharded"),
        config=importlib.import_module(f"{root}.core.config"),
        network=importlib.import_module(f"{root}.core.network"),
        types=importlib.import_module(f"{root}.core.types"),
        engine=importlib.import_module(f"{root}.engine"),
        net=importlib.import_module(f"{root}.net"),
        conformance=importlib.import_module(f"{root}.testing.conformance"),
    )


def _segments(d: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.glob("wal-*.seg"))}


def _set_op(k: bytes, v: bytes) -> bytes:
    return bytes([1]) + len(k).to_bytes(2, "little") + k + v


def _del_op(k: bytes) -> bytes:
    return bytes([3]) + len(k).to_bytes(2, "little") + k


class TestAcrossPackages:
    @pytest.mark.parametrize("seed", [3, 11, 20260803])
    def test_three_writers_write_identical_segments(self, tmp_path, seed):
        """The port's C writer, the port's Python writer and the
        reference's C writer, fed one ``random_wal_records(seed)``
        sequence (the generators of both packages draw the same bytes),
        write byte-identical segment files."""
        port, ref = _wal_pkg("port"), _wal_pkg("reference")
        recs = port.conformance.random_wal_records(seed, 200)
        assert recs == ref.conformance.random_wal_records(seed, 200)
        legs = {
            "port C": (port, False),
            "port python": (port, True),
            "reference C": (ref, False),
        }
        out = {}
        for leg, (pkg, py) in legs.items():
            d = tmp_path / leg.replace(" ", "-")
            p = pkg.nw.WalPersistence(
                d, segment_bytes=2048, n_shards=4, force_python=py
            )
            assert p.native is (not py), leg
            for r in recs:
                p._writer.append(r)
            p.flush_sync()
            p.close()
            out[leg] = _segments(d)
        assert len(out["port C"]) > 1  # rotated
        assert out["port C"] == out["port python"] == out["reference C"]
        for pkg in (port, ref):
            scan = pkg.nw.scan_wal(tmp_path / "port-C")
            assert scan.torn is None
            assert [r[3] for r in scan.records] == recs

    @pytest.mark.parametrize(
        "writer,reader", [("port", "reference"), ("reference", "port")]
    )
    @pytest.mark.asyncio
    async def test_wal_dir_recovers_in_the_other_package(
        self, tmp_path, writer, reader
    ):
        """A WAL directory written by one package (a checkpoint chain,
        then waves past it) recovers through the other package's
        ``recover_engine`` to stores with the writer's checksums and
        versions."""
        w, r = _wal_pkg(writer), _wal_pkg(reader)
        n = 2
        sm, machines = w.sharded.make_sharded_kv(n)
        plane = sm._native_plane
        assert plane is not None
        p = w.nw.WalPersistence(
            tmp_path, segment_bytes=1024, n_shards=n, rebase_every=4
        )
        slots = [0] * n
        for round_i in range(4):
            for i in range(24):
                s = i % n
                k = b"k%d" % (i % 9)
                ops = (
                    [_del_op(k)] if (i + round_i) % 7 == 0
                    else [_set_op(k, b"v%d-%d" % (round_i, i))]
                )
                plane.apply_ops(s, ops, 1.0)
                p.stage_wave(s, slots[s], 1, uuid.uuid4().bytes, ops)
                slots[s] += 1
            if round_i < 2:
                applied = list(slots)
                await p.checkpoint(
                    {
                        "next_slot": applied,
                        "applied_upto": applied,
                        "state_version": sum(applied),
                        "v1_applied": applied,
                    },
                    sm,
                )
        p.flush_sync()
        p.close()
        assert sorted(tmp_path.glob("snap-*.dat"))

        nid = r.types.NodeId.from_int(1)
        sm2, machines2 = r.sharded.make_sharded_kv(n)
        p2 = r.nw.WalPersistence(tmp_path, segment_bytes=1024, n_shards=n)
        cfg = r.config.RabiaConfig().with_kernel(
            num_shards=n, shard_pad_multiple=n
        )
        eng = r.engine.RabiaEngine(
            r.network.ClusterConfig.new(nid, [nid]), sm2,
            r.net.InMemoryHub().register(nid), persistence=p2, config=cfg,
        )
        rep = p2.recover_engine(eng)
        assert rep["chain_files"] > 0 and rep["waves_replayed"] > 0, rep
        assert [int(eng.rt.applied_upto[s]) for s in range(n)] == slots
        for s in range(n):
            assert machines2[s].store.checksum() == machines[s].store.checksum()
            assert machines2[s].store.version == machines[s].store.version
        p2.close()

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_torn_tail_cut_alike_in_both_packages(self, tmp_path, writer):
        """Cut one package's log at every offset across the last two
        records: both packages' scans find the same whole records and
        the same tear, and both truncations leave the same bytes."""
        w = _wal_pkg(writer)
        pkgs = (_wal_pkg("port"), _wal_pkg("reference"))
        base = tmp_path / "base"
        p = w.nw.WalPersistence(base, n_shards=4)
        recs = _mk_records(6)
        for rr in recs:
            p._writer.append(rr)
        p.flush_sync()
        p.close()
        seg = next(base.glob("wal-*.seg"))
        blob = seg.read_bytes()
        bounds = [SEG_HEADER]
        pos = SEG_HEADER
        while pos < len(blob):
            pos += 8 + struct.unpack_from("<I", blob, pos)[0]
            bounds.append(pos)
        for cut in range(bounds[-3], len(blob) + 1):
            whole = sum(1 for b in bounds[1:] if b <= cut)
            left = []
            for pkg in pkgs:
                d = tmp_path / f"{pkg.name}-{cut}"
                d.mkdir()
                (d / seg.name).write_bytes(blob[:cut])
                scan = pkg.nw.scan_wal(d)
                assert [x[3] for x in scan.records] == recs[:whole]
                assert (scan.torn is None) == (cut in bounds)
                pkg.nw.truncate_torn_tail(d, scan)
                left.append((d / seg.name).read_bytes())
            assert left[0] == left[1], f"cut {cut}"

    @pytest.mark.parametrize("force_python", [False, True])
    def test_engine_wal_planes_and_metric_families_match(self, tmp_path, force_python):
        """A one-replica engine on a WAL in each package: ``_wal`` is set,
        ``health()["planes"]["wal"]`` names the same writer, and the
        engine's metric registry has the same ``wal`` families."""
        out = {}
        for name in ("port", "reference"):
            pkg = _wal_pkg(name)
            nid = pkg.types.NodeId.from_int(1)
            sm, _m = pkg.sharded.make_sharded_kv(2)
            p = pkg.nw.WalPersistence(
                tmp_path / name, n_shards=2, force_python=force_python
            )
            cfg = pkg.config.RabiaConfig().with_kernel(
                num_shards=2, shard_pad_multiple=2
            )
            eng = pkg.engine.RabiaEngine(
                pkg.network.ClusterConfig.new(nid, [nid]), sm,
                pkg.net.InMemoryHub().register(nid), persistence=p,
                config=cfg,
            )
            assert eng._wal is p
            text = eng.metrics.render_prometheus()
            fams = sorted(
                {
                    line.split()[2]
                    for line in text.splitlines()
                    if line.startswith("# TYPE rabia_wal_")
                }
            )
            out[name] = (eng.health()["planes"]["wal"], fams)
            p.close()
        assert out["port"] == out["reference"]
        assert out["port"][0] == ("python" if force_python else "native")
        assert len(out["port"][1]) > 10
