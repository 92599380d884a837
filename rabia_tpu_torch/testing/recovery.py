"""Crash-recovery harness: real kill-9 of a durable replica process.

The in-process harnesses (:mod:`rabia_tpu_torch.testing.gateway_cluster`)
restart a replica by tearing its objects down — a CLEAN shutdown that
always gets its final checkpoint. This harness runs each replica as its
own OS process (multiproc.py's deployment shape) on the durability plane
(:mod:`rabia_tpu_torch.persistence.native_wal`), so a SIGKILL is a real crash:
whatever the group-commit fsync had not yet covered is torn off the WAL
tail, and the restarted process recovers through snapshot-chain restore
+ WAL replay while the survivors keep serving.

Used by tests/test_torch_wal.py (the recovery smoke cell) and
chip_smoke.py's phase 13 (b) (kill -9 at 4096 shards x 5 replicas).

The port's copy of the reference's ``rabia_tpu/testing/recovery.py``;
its children also mesh their gateways with each other, so a client can
read by ReadIndex through any replica's gateway, the restarted one's
included, and exit when their parent dies.

Child protocol (one JSON object per stdout line):
  {"event": "ready", "recovery": {...}, "planes": {...}, "pid": ...}
  emitted once the engine runs and the gateway listens; ``recovery`` is
  WalPersistence.last_recovery (snapshot_restore_s / wal_replay_s /
  waves_replayed / torn).
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from rabia_tpu_torch.testing.multiproc import REPO, free_ports


def _child_main(argv: list[str]) -> int:
    idx = int(argv[0])
    net_ports = json.loads(argv[1])
    gw_ports = json.loads(argv[2])
    wal_root = argv[3]
    n_shards = int(argv[4])
    # optional extras (bench topologies): {"workers": N} pins the
    # thread-per-shard-group runtime worker count inside THIS process —
    # the single-process-per-replica shape benchmarks/worker_scaling.py
    # --procs drives, where workers never compete with sibling replicas
    extras = json.loads(argv[5]) if len(argv) > 5 else {}
    parent = os.getppid()

    def orphan_watch() -> None:
        # a replica never outlives its harness: when the parent dies
        # without stop() (killed, or cut off at a time limit), exit too
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(0)

    threading.Thread(target=orphan_watch, daemon=True).start()

    from rabia_tpu_torch.apps.sharded import make_sharded_kv
    from rabia_tpu_torch.core.config import RabiaConfig, TcpNetworkConfig
    from rabia_tpu_torch.core.network import ClusterConfig
    from rabia_tpu_torch.core.types import NodeId
    from rabia_tpu_torch.engine import RabiaEngine
    from rabia_tpu_torch.gateway import GatewayConfig, GatewayServer
    from rabia_tpu_torch.net.tcp import TcpNetwork
    from rabia_tpu_torch.persistence.native_wal import WalPersistence

    async def run() -> int:
        node_ids = [NodeId.from_int(i + 1) for i in range(len(net_ports))]
        me = node_ids[idx]
        net = TcpNetwork(me, TcpNetworkConfig(bind_port=net_ports[idx]))
        sm, _machines = make_sharded_kv(n_shards)
        pers = WalPersistence(
            Path(wal_root) / f"replica-{idx}", n_shards=n_shards
        )
        cfg = RabiaConfig(
            phase_timeout=0.4, heartbeat_interval=0.05, round_interval=0.002
        ).with_kernel(
            num_shards=n_shards, shard_pad_multiple=max(1, n_shards)
        )
        if extras.get("workers"):
            from dataclasses import replace

            cfg = replace(cfg, runtime_workers=int(extras["workers"]))
        # shard-group membership (fleet/groups.py GroupProcHarness):
        # {"group": g, "group_shards": [[lo, hi], ...]} scopes this
        # replica set to one consensus group of a partitioned
        # deployment — the gateway enforces the owned ranges
        group_id = extras.get("group")
        if group_id is not None:
            from dataclasses import replace

            cfg = replace(cfg, group_id=int(group_id))
        eng = RabiaEngine(
            ClusterConfig.new(me, node_ids), sm, net,
            persistence=pers, config=cfg,
        )
        for j, p in enumerate(net_ports):
            if j != idx:
                net.add_peer(node_ids[j], "127.0.0.1", p)
        task = asyncio.ensure_future(eng.run())
        # gateway under a DETERMINISTIC node id so the parent can build
        # endpoints without a handshake
        gw_cfg = GatewayConfig(bind_port=gw_ports[idx])
        if group_id is not None:
            from dataclasses import replace

            gw_cfg = replace(
                gw_cfg,
                group_id=int(group_id),
                group_shards=tuple(
                    (int(lo), int(hi))
                    for lo, hi in extras.get("group_shards", [])
                ),
            )
        gw = GatewayServer(
            eng,
            config=gw_cfg,
            node_id=NodeId.from_int(1000 + idx),
        )
        # wait for the engine to finish initialize: recover_engine stamps
        # last_recovery on the persistence layer at its end (rt.is_active
        # is True from construction, so it is NOT a readiness signal)
        deadline = time.time() + 30.0
        while time.time() < deadline and not hasattr(pers, "last_recovery"):
            if task.done():
                task.result()
            await asyncio.sleep(0.01)
        await gw.start()
        # the peer gateways (deterministic ids and known ports): a
        # ReadIndex read probes a quorum of them for the decided frontier
        for j, port in enumerate(gw_ports):
            if j != idx:
                gw.add_peer_gateway(NodeId.from_int(1000 + j), "127.0.0.1", port)
        print(
            json.dumps(
                {
                    "event": "ready",
                    "pid": os.getpid(),
                    "recovery": getattr(pers, "last_recovery", None),
                    "planes": eng.health()["planes"],
                    "group": group_id,
                }
            ),
            flush=True,
        )
        await task  # runs until SIGKILL/SIGTERM
        return 0

    return asyncio.run(run())


class ReplicaProc:
    """One replica subprocess + its stdout line pump."""

    def __init__(self, proc: subprocess.Popen) -> None:
        self.proc = proc
        self.lines: list[dict] = []
        self._lock = threading.Lock()
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()

    def _pump(self) -> None:
        assert self.proc.stdout is not None
        for line in self.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                doc = {"event": "log", "line": line}
            with self._lock:
                self.lines.append(doc)

    def wait_event(self, event: str, timeout: float) -> dict:
        deadline = time.time() + timeout
        seen = 0
        while time.time() < deadline:
            with self._lock:
                for doc in self.lines[seen:]:
                    if doc.get("event") == event:
                        return doc
                seen = len(self.lines)
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica exited rc={self.proc.returncode} before "
                    f"'{event}': {self.lines}"
                )
            time.sleep(0.02)
        raise TimeoutError(f"no '{event}' from replica within {timeout}s")


class RecoveryHarness:
    """N one-process replicas on the durability plane, with kill-9 and
    measured restart."""

    def __init__(
        self, n_replicas: int = 3, n_shards: int = 4,
        wal_root: Optional[str] = None,
        extras: Optional[dict] = None,
    ) -> None:
        import tempfile

        self.n = n_replicas
        self.n_shards = n_shards
        self.extras = dict(extras or {})
        self.wal_root = wal_root or tempfile.mkdtemp(prefix="rabia-recovery-")
        ports = free_ports(2 * n_replicas)
        self.net_ports = ports[:n_replicas]
        self.gw_ports = ports[n_replicas:]
        self.procs: list[Optional[ReplicaProc]] = [None] * n_replicas

    def _spawn(self, i: int) -> ReplicaProc:
        env = dict(os.environ)
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "rabia_tpu_torch.testing.recovery",
                "--child", str(i),
                json.dumps(self.net_ports), json.dumps(self.gw_ports),
                self.wal_root, str(self.n_shards),
                json.dumps(self.extras),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            env=env,
            cwd=REPO,
        )
        rp = ReplicaProc(proc)
        self.procs[i] = rp
        return rp

    def start(self, timeout: float = 60.0) -> list[dict]:
        """Spawn every replica; returns their ready reports."""
        for i in range(self.n):
            self._spawn(i)
        return [
            self.procs[i].wait_event("ready", timeout) for i in range(self.n)
        ]

    def kill9(self, i: int) -> None:
        rp = self.procs[i]
        assert rp is not None
        rp.proc.send_signal(signal.SIGKILL)
        rp.proc.wait(timeout=10)

    def restart(self, i: int, timeout: float = 120.0) -> dict:
        """Respawn replica ``i``; returns its ready report (with the
        recovery timings measured inside the child)."""
        self._spawn(i)
        return self.procs[i].wait_event("ready", timeout)

    def endpoints(self):
        from rabia_tpu_torch.core.types import NodeId
        from rabia_tpu_torch.gateway import GatewayEndpoint

        return [
            GatewayEndpoint(
                node_id=NodeId.from_int(1000 + i),
                host="127.0.0.1",
                port=self.gw_ports[i],
            )
            for i in range(self.n)
        ]

    def stop(self) -> None:
        for rp in self.procs:
            if rp is not None and rp.proc.poll() is None:
                rp.proc.send_signal(signal.SIGTERM)
        for rp in self.procs:
            if rp is not None:
                try:
                    rp.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    rp.proc.kill()


async def run_crash_recovery_trial(
    *,
    n_shards: int = 4,
    preload_keys: int = 100,
    value_bytes: int = 64,
    load_rate: float = 50.0,
    kill_index: int = 2,
    rejoin_timeout: float = 120.0,
) -> dict:
    """One full trial: start a 3-replica durable cluster of real
    processes, preload state, kill -9 one replica under sustained client
    traffic, restart it, and measure every recovery phase. Returns the
    measurement dict (the ``recovery_slo_r11`` row shape)."""
    from rabia_tpu_torch.apps.kvstore import decode_kv_response, encode_set_bin
    from rabia_tpu_torch.gateway.client import RabiaClient

    h = RecoveryHarness(3, n_shards)
    try:
        h.start()
        eps = h.endpoints()
        survivors = [eps[j] for j in range(3) if j != kill_index]
        cli = RabiaClient(survivors, call_timeout=30.0)
        await cli.connect()
        # -- preload: the state the restarted replica must recover -----
        val = "x" * value_bytes
        t0 = time.perf_counter()
        for k in range(preload_keys):
            resp = await cli.submit(
                k % n_shards, [encode_set_bin(f"key-{k}", val)]
            )
            assert decode_kv_response(resp[0]).ok
        preload_s = time.perf_counter() - t0

        # -- kill -9 under sustained traffic ---------------------------
        h.kill9(kill_index)
        stop_load = asyncio.Event()
        load_ok = 0

        async def loadgen() -> None:
            nonlocal load_ok
            k = 0
            while not stop_load.is_set():
                try:
                    resp = await cli.submit(
                        k % n_shards,
                        [encode_set_bin(f"load-{k % 500}", val)],
                    )
                    if decode_kv_response(resp[0]).ok:
                        load_ok += 1
                except Exception:
                    await asyncio.sleep(0.05)
                k += 1
                await asyncio.sleep(1.0 / load_rate)

        load_task = asyncio.ensure_future(loadgen())
        await asyncio.sleep(1.0)  # decided waves the dead replica missed

        # -- restart + measure -----------------------------------------
        t_restart = time.perf_counter()
        report = await asyncio.get_running_loop().run_in_executor(
            None, lambda: h.restart(kill_index, rejoin_timeout)
        )
        ready_s = time.perf_counter() - t_restart
        # rejoin-under-load: the restarted gateway answers a submit
        rejoin_cli = RabiaClient([h.endpoints()[kill_index]],
                                 call_timeout=30.0)
        await rejoin_cli.connect()
        deadline = time.time() + rejoin_timeout
        rejoined = False
        while time.time() < deadline:
            try:
                resp = await rejoin_cli.submit(
                    0, [encode_set_bin("rejoin-probe", "1")]
                )
                if decode_kv_response(resp[0]).ok:
                    rejoined = True
                    break
            except Exception:
                await asyncio.sleep(0.1)
        rejoin_s = time.perf_counter() - t_restart
        await rejoin_cli.close()
        pre_stop_ok = load_ok
        await asyncio.sleep(1.0)  # post-rejoin goodput window
        stop_load.set()
        await load_task
        post_rejoin_ok = load_ok - pre_stop_ok
        await cli.close()
        rec = report.get("recovery") or {}
        return {
            "preload_keys": preload_keys,
            "value_bytes": value_bytes,
            "preload_s": round(preload_s, 3),
            "snapshot_restore_s": rec.get("snapshot_restore_s"),
            "wal_replay_s": rec.get("wal_replay_s"),
            "waves_replayed": rec.get("waves_replayed"),
            "wal_records": rec.get("wal_records"),
            "chain_files": rec.get("chain_files"),
            "torn_tail": rec.get("torn") is not None,
            "process_ready_s": round(ready_s, 3),
            "rejoin_under_load_s": round(rejoin_s, 3),
            "rejoined": rejoined,
            "post_rejoin_goodput_ok": post_rejoin_ok,
            "planes": report.get("planes"),
            # the harness's WAL root survives h.stop(): callers scan the
            # killed replica's log post-trial (LSN continuity asserts)
            "wal_root": h.wal_root,
            "kill_index": kill_index,
        }
    finally:
        h.stop()


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        sys.exit(_child_main(sys.argv[2:]))
    print(
        "usage: python -m rabia_tpu_torch.testing.recovery --child ... "
        "(spawned by RecoveryHarness)",
        file=sys.stderr,
    )
    sys.exit(2)
