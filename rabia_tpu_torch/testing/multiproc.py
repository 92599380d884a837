"""Multi-OS-process cluster harness: spawn one Python child per replica.

Shared by the programs that exercise the true production deployment shape
(one process per replica over the native TCP plane on localhost): the
kill -9 harness (:mod:`rabia_tpu_torch.testing.recovery`) takes its
``free_ports`` and ``REPO`` from here. Children are new interpreters
started with ``subprocess`` (never forked from a parent that may hold a
GPU).

The port's copy of the reference's ``rabia_tpu/testing/multiproc.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def free_ports(n: int) -> list[int]:
    """n distinct ephemeral localhost ports (close-then-rebind pattern —
    a tiny steal window exists; callers treat bind failure as retryable)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def run_replica_cluster(
    replica_code: str,
    n: int,
    extra_args: list[str],
    *,
    timeout: float = 240.0,
) -> list[str]:
    """Launch ``n`` children running ``replica_code`` (argv: index,
    ports-json, *extra_args), collect each stdout, and NEVER orphan
    survivors: any child failing or hanging kills the rest.

    Returns the per-child stdout. Raises SystemExit on a nonzero child.
    """
    ports = free_ports(n)
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-c", replica_code,
                str(i), json.dumps(ports), *extra_args,
            ],
            stdout=subprocess.PIPE,
            text=True,
            env=env,
            cwd=REPO,
        )
        for i in range(n)
    ]
    outs: list[str] = []
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                # print EVERY collected replica's output, not just the
                # failer's — cross-replica context (who dropped quorum
                # first) is usually the diagnosis
                for j, o in enumerate(outs):
                    print(f"--- replica {j} output ---")
                    print(o)
                raise SystemExit(f"replica {i} failed rc={p.returncode}")
    finally:
        for p in procs:  # a hung/failed replica must not orphan the rest
            if p.poll() is None:
                p.kill()
    return outs
