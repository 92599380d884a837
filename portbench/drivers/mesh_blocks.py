"""Driver: the replicated KV store's block lane on the device table.

The system under test is ``MeshEngine(device_store=True)`` over
``VectorShardedKV`` replicas: full-width blocks of one op a shard through
``submit_block`` and ``run_cycle``, consensus folded into the kv kernels,
the table on the card, the host replicas the demotion target. With the
mix's ``read_lane`` on, GET-only blocks take the read lane (probe windows,
no slot).

Set-up builds the engine, loads the table with the configuration's SET
blocks (YCSB's load phase), makes the mix's pool of blocks, and warms the
lane with the stream's first ``warmup_blocks`` blocks (every kernel and
shape the window uses). The window is a closed loop: it keeps
``outstanding_blocks`` blocks submitted and unsettled, runs one
``run_cycle`` and settles what resolved, until the time is up; the stream
is the pool's blocks in turn, each sent as a new block. Then the check
drains the engine and replays the whole stream (load, warm-up, window)
through the plain reference: the response frames of a sample of the
window's blocks drawn from the seed (with the last), every shard's slot
counter and the decision count, and every replica's store after
``sync_to_host``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
from rabia_tpu_torch.apps.vector_kv import VectorShardedKV
from rabia_tpu_torch.core.blocks import PayloadBlock
from rabia_tpu_torch.core.types import fast_uuid4
from rabia_tpu_torch.kernel import kv_window
from rabia_tpu_torch.parallel.mesh_engine import MeshEngine

from pbench import traffic as tr
from pbench.sample import Reservoir
from reference.kv_ref import KVReference

SAMPLE_BLOCKS = 12  # window blocks whose frames the check compares, with the last
SAMPLE_SHARDS = 8  # replicas past the first compare every key of one shard in this many


@dataclass
class State:
    cell: object
    eng: object
    load: list
    pool: list
    rng: np.random.Generator
    sample: Reservoir  # position in seq -> future, of the window's blocks
    seq: list = field(default_factory=list)  # pool index of every block sent after the load
    outstanding: list = field(default_factory=list)  # (future, sent at, ops) not yet settled


def _send(eng, kb: tr.KVBlock):
    S = len(kb.shards)
    block = PayloadBlock(fast_uuid4(), kb.shards, np.full(S, -1, np.int64),
                         np.ones(S, np.int64), kb.cmd_sizes, kb.data)
    return eng.submit_block(block)


def key_lanes(key_bytes: int) -> int:
    """8-byte lanes of the device table's key: the key's width rounded up
    to a power of two, as the window packers bucket it."""
    return max(8, 1 << (key_bytes - 1).bit_length()) // 8


def setup(cell, seed: int, device) -> State:
    cfg, mix = cell.config, cell.traffic
    t0 = time.perf_counter()
    S, R, P = cfg["shards"], cfg["replicas"], cfg["keys_per_shard"]
    eng = MeshEngine(
        lambda: VectorShardedKV(S, capacity=2 * S * P), S, R, device=device,
        window=cfg["window"], device_store=True,
        device_store_kw={"per_shard_capacity": P, "key_lanes": key_lanes(cfg["key_bytes"]),
                         "value_width": cfg["value_bytes"]},
        device_read_lane=bool(mix["read_lane"]))
    t1 = time.perf_counter()
    rng = tr.rng_for(seed, "sample")
    st = State(cell, eng, *tr.kv_streams(cfg, mix, seed), rng, Reservoir(SAMPLE_BLOCKS, rng))
    t2 = time.perf_counter()
    for kb in st.load:
        _send(eng, kb)
    eng.flush()
    t3 = time.perf_counter()
    warm = int(mix["warmup_blocks"])
    while len(st.seq) < warm:
        _fill(st, warm)
        eng.run_cycle()
        st.outstanding = [o for o in st.outstanding if not o[0].done()]
    eng.flush()
    st.outstanding.clear()
    if not eng.device_lane_active:
        raise RuntimeError("the device lane demoted during set-up")
    print(f"set-up: engine {t1 - t0:.2f} s, blocks made {t2 - t1:.2f} s, load phase "
          f"{t3 - t2:.2f} s, warm-up {time.perf_counter() - t3:.2f} s", file=sys.stderr)
    return st


def _fill(st: State, limit: int, keep: bool = False) -> None:
    """Send blocks until ``outstanding_blocks`` are out (or ``limit`` sent
    after the load); with ``keep``, offer each to the check's sample."""
    want = int(st.cell.traffic["outstanding_blocks"])
    while len(st.outstanding) < want and len(st.seq) < limit:
        i = len(st.seq) % len(st.pool)
        fut = _send(st.eng, st.pool[i])
        st.seq.append(i)
        st.outstanding.append((fut, time.perf_counter(), len(st.pool[i].shards)))
        if keep:
            st.sample.offer(len(st.seq) - 1, fut)


def _dispatched(eng) -> tuple[int, int]:
    """(ops, GETs) the engine has put into device windows: a window
    advances every shard's slot by its depth when it launches, and a probe
    window, which takes no slot, counts its GETs when it launches."""
    reads = eng.read_lane_stats()
    return int(np.asarray(eng.next_slot).sum()) + reads["probe"], reads["probe"] + reads["slot"]


def window(st: State, seconds: float, spans) -> dict:
    eng = st.eng
    first = len(st.seq)
    launches0 = kv_window.KV_WINDOW.launches
    reads0 = eng.read_lane_stats()
    ops0, gets0 = _dispatched(eng)
    lat, ops, demotions = [], 0, 0
    with spans("pb.window"):
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            with spans("pb.submit"):
                _fill(st, 1 << 62, keep=True)
            active = eng.device_lane_active
            with spans("pb.run_cycle"):
                eng.run_cycle()
            demotions += active and not eng.device_lane_active
            now = time.perf_counter()
            if now > end:
                break
            with spans("pb.settle"):
                left = []
                for o in st.outstanding:
                    if o[0].done():
                        lat.append((now - o[1]) * 1e3)
                        ops += o[2]
                    else:
                        left.append(o)
                st.outstanding = left
    reads = {k: v - reads0[k] for k, v in eng.read_lane_stats().items()}
    ops1, gets1 = _dispatched(eng)
    sent = st.seq[first:]
    return {
        "e2e": {"ops_per_s": ops / seconds},
        "seconds": seconds,
        "attempted": sum(len(st.pool[i].shards) for i in sent),
        "settled_ops": ops,
        "settled_blocks": len(lat),
        "block_ms": lat,
        "kv_launches": kv_window.KV_WINDOW.launches - launches0,
        "reads": reads,
        "demotions": demotions,
        "launched_set_ops": (ops1 - ops0) - (gets1 - gets0),
        "launched_get_ops": gets1 - gets0,
        "shape": {k: st.cell.config[k] for k in ("shards", "replicas", "keys_per_shard",
                                                   "key_bytes", "value_bytes", "window")},
    }


def _takes_slot(kb: tr.KVBlock, read_lane: bool) -> bool:
    """A block takes a slot on every shard, unless the read lane serves
    it: then a GET-only block takes none."""
    return not (read_lane and kb.n_set == 0)


def replay(st: State, lose_every: int = 0) -> tuple[KVReference, dict]:
    """The whole stream through the reference: (reference, {position:
    frames}) for the sampled positions. ``lose_every`` > 0 is the
    control: every ``lose_every``-th block of the stream, the load's
    included, loses its writes."""
    cfg = st.cell.config
    ref = KVReference(cfg["shards"], cfg["keys_per_shard"], cfg["key_bytes"],
                      cfg["value_bytes"])
    n = 0

    def lose() -> bool:
        return bool(lose_every) and n % lose_every == lose_every - 1

    for kb in st.load:
        ref.apply(kb.shards, kb.cmd_sizes, kb.data, lose_writes=lose())
        n += 1
    want = set(st.sample.items())
    frames = {}
    for pos, i in enumerate(st.seq):
        kb = st.pool[i]
        if kb.n_set or pos in want:  # a block of reads alone changes nothing
            got = ref.apply(kb.shards, kb.cmd_sizes, kb.data, frames=pos in want,
                            lose_writes=lose())
            if got is not None:
                frames[pos] = got
        n += 1
    return ref, frames


def _frames_of(fut) -> list:
    return [bytes(g[0]) if len(g) == 1 else None for g in fut.result()]


def compare(st: State, ref: KVReference, want: dict, got_frames: dict, stores: list) -> dict:
    """The numbers the check holds at zero: sampled frames that differ, and
    store entries that differ from the reference's table: every key on the
    first store; on the others every shard's version counter, the entry
    count and every key of a sample of the shards drawn from the seed."""
    frames_wrong = 0
    for pos, frames in want.items():
        got = got_frames.get(pos, [])
        frames_wrong += sum(a != b for a, b in zip(frames, got)) + abs(len(frames) - len(got))
    s, klen, lanes, ver, vals = ref.entries()
    S = ref.S
    some = np.isin(s, st.rng.choice(S, max(1, S // SAMPLE_SHARDS), replace=False))
    table_wrong = 0
    for i, store in enumerate(stores):
        pick = slice(None) if i == 0 else some
        wide = np.zeros((len(s), store.L), np.uint64)  # the store's key lanes
        wide[:, :lanes.shape[1]] = lanes
        vers, got = store.bulk_get(s[pick], wide[pick], klen[pick])
        want_vals = vals if i == 0 else [v for v, k in zip(vals, some) if k]
        table_wrong += int((vers != ver[pick]).sum()) + sum(a != b for a, b in zip(got, want_vals))
        table_wrong += abs(len(store) - len(s))
        table_wrong += int((np.asarray(store.shard_version[:S]) != ref.shard_version).sum())
    return {"frames_wrong": frames_wrong, "table_wrong": table_wrong}


def check(st: State, run: dict) -> dict:
    """Drain, then hold the program to the reference. Returns {name:
    (value, limit)}."""
    eng = st.eng
    t0 = time.perf_counter()
    eng.flush()
    unsettled = sum(o[2] for o in st.outstanding if not o[0].done())
    read_lane = bool(st.cell.traffic["read_lane"])
    slots = len(st.load) + sum(_takes_slot(st.pool[i], read_lane) for i in st.seq)
    S = st.cell.config["shards"]
    slots_wrong = int((np.asarray(eng.next_slot) != slots).sum())
    slots_wrong += abs(int(eng.decided_v1) - slots * S)
    samples = st.sample.items()
    got_frames = {p: _frames_of(f) for p, f in samples.items() if f.done()}
    t1 = time.perf_counter()
    eng.sync_to_host()
    t2 = time.perf_counter()
    ref, want = replay(st)
    t3 = time.perf_counter()
    numbers = compare(st, ref, want, got_frames, [sm.store for sm in eng.sms])
    print(f"check: drain and frames {t1 - t0:.2f} s, sync_to_host {t2 - t1:.2f} s, replay of "
          f"{len(st.load) + len(st.seq)} blocks {t3 - t2:.2f} s, compare "
          f"{time.perf_counter() - t3:.2f} s", file=sys.stderr)
    return {
        "unsettled_ops": (unsettled, 0),
        "frames_wrong": (numbers["frames_wrong"], 0),
        "slots_wrong": (slots_wrong, 0),
        "table_wrong": (numbers["table_wrong"], 0),
    }


def control(st: State, lose_every: int = 16) -> dict:
    """The control in the program's place: the reference that loses the
    writes of every ``lose_every``-th block (one wave a window), its
    frames and table held to the true reference's by :func:`compare`."""
    ref, want = replay(st)
    bad, got = replay(st, lose_every)
    s, klen, lanes, ver, vals = bad.entries()

    class _Table:  # the control's table, read as the check reads a store
        shard_version = bad.shard_version
        L = bad.K // 8

        def __len__(self) -> int:
            return len(s)

        def bulk_get(self, qs, qlanes, qklen):
            col = bad._find(np.asarray(qs, np.int64), np.asarray(qklen, np.int64), qlanes)
            hit = col >= 0
            c = np.maximum(col, 0)
            vers = np.where(hit, bad.version[qs, c], -1)
            return vers, [bad.value[a, b][:n].tobytes() if h else None for a, b, n, h in
                          zip(qs.tolist(), c.tolist(), bad.vlen[qs, c].tolist(), hit.tolist())]

    numbers = compare(st, ref, want, got, [_Table()])
    return {"frames_wrong": numbers["frames_wrong"], "table_wrong": numbers["table_wrong"]}
