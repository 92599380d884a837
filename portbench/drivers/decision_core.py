"""Driver: the deployment's decision core in bulk.

The system under test is ``ClusterKernel(S, R).slot_pipeline_fused_rmajor``
on replica-major vote planes i8[R, T, S] (``csrc/fused_window.cu``): T
slots of every shard decided in one window, the decisions left on the
device. Set-up makes the mix's vote planes on the card from the seed (the
buffers taken in turns) and warms the kernel. The window dispatches
windows ``dispatch_ahead`` ahead of the one the host waits for, and
counts a window done when the host sees its completion event. The check
holds a sample of the window's decision planes, drawn from the seed (with
the last), to the plain reference's decisions on the same votes.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch
from rabia_tpu_torch.kernel import fused_window
from rabia_tpu_torch.kernel.phase_driver import ClusterKernel

from pbench import traffic as tr
from pbench.sample import Reservoir
from reference import decide_ref

SAMPLE_WINDOWS = 6  # decision planes the check compares, with the last


@dataclass
class State:
    cell: object
    device: object
    kernel: object
    votes: list
    alive: object
    sample: Reservoir  # window index -> decision plane


class _Done:
    """Completion of the work queued so far: a CUDA event on a card; on
    the CPU the work is done when the call returns."""

    def __init__(self, device) -> None:
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def setup(cell, seed: int, device) -> State:
    cfg, mix = cell.config, cell.traffic
    t0 = time.perf_counter()
    S, R, T = cfg["shards"], cfg["replicas"], int(mix["slots_per_window"])
    k = ClusterKernel(S, R, device=device)
    votes = tr.vote_planes(cfg, mix, seed, device)
    alive = torch.ones((R, S), dtype=torch.bool, device=device)
    st = State(cell, device, k, votes, alive, Reservoir(SAMPLE_WINDOWS, tr.rng_for(seed, "sample")))
    for i in range(2 * len(votes)):
        k.slot_pipeline_fused_rmajor(votes[i % len(votes)], alive, T, want_phase=False)
    _Done(device).wait()
    print(f"set-up: votes made and kernel warmed {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    return st


def window(st: State, seconds: float, spans) -> dict:
    mix = st.cell.traffic
    T, ahead = int(mix["slots_per_window"]), int(mix["dispatch_ahead"])
    S, R = st.cell.config["shards"], st.cell.config["replicas"]
    k, votes, alive = st.kernel, st.votes, st.alive
    launches0 = fused_window.FUSED_WINDOW.launches
    inflight: deque = deque()
    lat, i = [], 0
    with spans("pb.window"):
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            sent = time.perf_counter()
            if sent > end:
                break
            with spans("pb.dispatch"):
                dec = k.slot_pipeline_fused_rmajor(votes[i % len(votes)], alive, T,
                                                   want_phase=False)
                inflight.append((_Done(st.device), sent, i, dec))
            i += 1
            if len(inflight) > ahead:
                with spans("pb.wait"):
                    done, at, j, dec = inflight.popleft()
                    done.wait()
                now = time.perf_counter()
                if now <= end:
                    lat.append((now - at) * 1e3)
                    st.sample.offer(j, dec)
    for done, _, _, _ in inflight:
        done.wait()
    p95 = float(np.percentile(lat, 95)) if lat else None
    return {
        "e2e": {"decisions_per_s": len(lat) * T * S / seconds, "decide_p95_ms": p95},
        "seconds": seconds,
        "attempted": i * T * S,
        "windows_done": len(lat),
        "window_ms": lat,
        "fused_launches": fused_window.FUSED_WINDOW.launches - launches0,
        "shape": {"replicas": R, "slots": T, "shards": S},
    }


def check(st: State, run: dict) -> dict:
    """The sampled decision planes against the reference's decisions on
    the same votes. Returns {name: (value, limit)}."""
    alive = st.alive.cpu().numpy()
    want = [decide_ref.decide(v.cpu().numpy(), alive) for v in st.votes]
    kept = st.sample.items()
    wrong = sum(int((dec.cpu().numpy() != want[i % len(want)]).sum()) for i, dec in kept.items())
    missing = run["attempted"] and not kept
    return {"decisions_wrong": (wrong + int(missing), 0)}


def control(st: State, quorum: int = 2) -> dict:
    """The control in the program's place: the reference deciding on a
    quorum of ``quorum`` (below the majority), held to the reference."""
    alive = st.alive.cpu().numpy()
    wrong = 0
    for v in st.votes:
        h = v.cpu().numpy()
        wrong += int((decide_ref.decide(h, alive, quorum=quorum) != decide_ref.decide(h, alive))
                     .sum())
    return {"decisions_wrong": wrong}
