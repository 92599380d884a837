"""The native host plane across both packages: four legs a case.

Each package runs its native path beside its Python twin, and the two
packages run beside each other, on the same seeded schedules:

- the native tick beside the Python tick (``RABIA_PY_TICK=1``): decision
  ledgers, replica state, counter parity and the flight lifecycle;
- the GIL-free runtime beside the asyncio owner (``RABIA_PY_RUNTIME=1``),
  over TCP: client responses, store checksums, counter parity and the
  decided values on the slots all legs hold;
- the native store (``NativeKVStore``) beside the Python ``KVStore``: the
  result frames of every wave and every shard's checksum, version, op
  stats and snapshot bytes;
- the C codec beside the Python codec: the encoded bytes of every hot
  message kind.

All four legs of a case must agree. The reference's runtime empties a
shard group, and crashes its process, where ``(W - 1) * ceil(n / W) > n``
(W the worker count, n the shard count; ROADMAP Queue 3). Its legs here
run only at RABIA_RT_WORKERS=1 or at shapes that leave every group
non-empty (8 shards at W = 4), never at a crashing shape: the crash would
kill the test worker. The port's legs also run at W = 7.
"""

from __future__ import annotations

import asyncio
import importlib
import os

import numpy as np
import pytest

from test_torch_serialization import KINDS, PORT, REF, _message

PACKAGES = ("rabia_tpu", "rabia_tpu_torch")


def _conf(pkg: str):
    return importlib.import_module(f"{pkg}.testing.conformance")


def _schedule(seed: int, n_shards: int, n_waves: int):
    """Waves of {shard: [command strings]} (the tick gate's form)."""
    rng = np.random.default_rng(seed)
    return [
        {
            int(s): [f"SET k{int(s)}-{w}-{j} v{seed}" for j in range(int(rng.integers(1, 3)))]
            for s in rng.choice(n_shards, size=int(rng.integers(1, n_shards + 1)), replace=False)
        }
        for w in range(n_waves)
    ]


def _kv_schedule(seed: int, n_shards: int, n_waves: int):
    """Waves of {shard: [(key, value)]} (the runtime gate's form)."""
    rng = np.random.default_rng(seed)
    return [
        {
            int(s): [(f"k{int(rng.integers(0, 6))}", f"v{w}-{j}") for j in range(int(rng.integers(1, 3)))]
            for s in rng.choice(n_shards, size=int(rng.integers(1, n_shards + 1)), replace=False)
        }
        for w in range(n_waves)
    ]


class _Env:
    """Set environment variables for a block, restoring them after."""

    def __init__(self, **kv) -> None:
        self.kv = kv

    def __enter__(self):
        self.prev = {k: os.environ.get(k) for k in self.kv}
        for k, v in self.kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("seed", [5, 6])
def test_tick_paths_agree_across_packages(seed):
    n_shards = 6
    schedule = _schedule(seed, n_shards, 4)
    legs = {}
    for pkg in PACKAGES:
        for path, flag in (("native", None), ("python", "1")):
            with _Env(RABIA_PY_TICK=flag):
                dec, snap, native, obs = asyncio.run(
                    _conf(pkg)._run_transport_schedule(
                        schedule, n_shards, 3, tag=f"{pkg}-{path}-{seed}"
                    )
                )
            assert native == (path == "native"), (pkg, path)
            legs[(pkg, path)] = (dec, snap, obs["parity"], obs["flight_lifecycle"])
    first = legs[("rabia_tpu", "python")]
    assert first[2]["decided_v1"] > 0
    for key, leg in legs.items():
        assert leg[0] == first[0], f"{key}: decision ledger"
        assert leg[1] == first[1], f"{key}: replica state"
        assert leg[2] == first[2], f"{key}: counter parity"
        assert leg[3] == first[3], f"{key}: flight lifecycle"


def _runtime_api(pkg: str):
    """The names the port's runtime gate drives, from ``pkg``: both
    packages' engines go through the one runner, so the four legs are
    driven and observed alike."""
    conf = importlib.import_module("rabia_tpu_torch.testing.conformance")
    if pkg == "rabia_tpu_torch":
        return conf.runtime_api()
    from types import SimpleNamespace

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    port = vars(conf.runtime_api())
    where = {
        "encode_set_bin": "apps.kvstore", "make_sharded_kv": "apps.sharded",
        "build_block": "core.blocks", "RabiaConfig": "core.config",
        "TcpNetworkConfig": "core.config", "ResponsesUnavailableError": "core.errors",
        "ClusterConfig": "core.network", "Command": "core.types",
        "CommandBatch": "core.types", "NodeId": "core.types",
        "RabiaEngine": "engine", "slot_proposer": "engine.leader",
        "TcpNetwork": "net.tcp",
    }
    assert set(where) == set(port)
    return SimpleNamespace(**{k: getattr(mod(m), k) for k, m in where.items()})


@pytest.mark.parametrize(
    "n_shards,ref_workers,port_workers", [(8, "1", "7"), (8, "4", "4")]
)
def test_runtime_paths_agree_across_packages(n_shards, ref_workers, port_workers):
    """Each package's runtime and asyncio owner through the port's gate
    runner. What a loaded host may change, and the runner names and
    leaves out (a deduplicated slot, a replica that took a snapshot sync,
    a response that sync overtook), is asserted to be all that was left
    out: nothing is retried."""
    conf = importlib.import_module("rabia_tpu_torch.testing.conformance")
    schedule = _kv_schedule(n_shards + int(ref_workers), n_shards, 4)
    legs = {}
    for pkg, workers in (("rabia_tpu", ref_workers), ("rabia_tpu_torch", port_workers)):
        api = _runtime_api(pkg)
        for path, flag in (("runtime", None), ("asyncio", "1")):
            with _Env(RABIA_PY_RUNTIME=flag, RABIA_RT_WORKERS=workers):
                leg = asyncio.run(
                    conf._run_runtime_schedule(
                        schedule, n_shards, 3, tag=f"{pkg}-{path}-w{workers}", api=api
                    )
                )
            active, obs = leg[3], leg[4]
            assert active == (path == "runtime"), (pkg, path)
            if active:
                assert obs["runtime"].get("waves_native", 0) > 0, (pkg, obs["runtime"])
            legs[(pkg, path)] = leg
    first = legs[("rabia_tpu", "asyncio")]
    for key, leg in legs.items():
        conf.runtime_legs_agree(leg, first, f"{key}")


def _op_waves(seed: int, n_shards: int, n_waves: int):
    """Binary op waves: SET/GET/DEL/EXISTS/CAS/CLEAR over a small key
    pool, oversized values and keys, an unknown opcode."""
    kv = importlib.import_module("rabia_tpu_torch.apps.kvstore")
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        wave = {}
        for s in rng.choice(n_shards, size=int(rng.integers(1, n_shards + 1)), replace=False):
            ops = []
            for _ in range(int(rng.integers(1, 5))):
                key = f"key{int(rng.integers(0, 10))}"
                r = rng.random()
                if r < 0.4:
                    size = 200 if rng.random() < 0.1 else int(rng.integers(0, 12))
                    ops.append(kv.encode_set_bin(key, "x" * size))
                elif r < 0.55:
                    ops.append(b"\x02" + len(key).to_bytes(2, "little") + key.encode())
                elif r < 0.65:
                    ops.append(b"\x03" + len(key).to_bytes(2, "little") + key.encode())
                elif r < 0.75:
                    ops.append(b"\x04" + len(key).to_bytes(2, "little") + key.encode())
                elif r < 0.88:
                    ops.append(kv.encode_cas_bin(key, "c", int(rng.integers(0, 3))))
                elif r < 0.93:
                    ops.append(kv.encode_set_bin("k" * 40, "long key"))
                elif r < 0.97:
                    ops.append(b"\x05\x00\x00")
                else:
                    ops.append(b"\x09\x01\x00k")
            wave[int(s)] = ops
        waves.append(wave)
    return waves


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_apply_paths_agree_across_packages(seed):
    n_shards = 4
    waves = _op_waves(seed, n_shards, 12)
    sms = {}
    for pkg in PACKAGES:
        sharded = importlib.import_module(f"{pkg}.apps.sharded")
        cfg = importlib.import_module(f"{pkg}.core.config").KVStoreConfig(
            max_keys=8, max_key_length=24, max_value_size=128
        )
        for native in (True, False):
            sm, machines = sharded.make_sharded_kv(n_shards, cfg, native=native)
            assert (sm._native_plane is not None) == native, (pkg, native)
            sms[(pkg, native)] = (pkg, sm, machines)
    for w, wave in enumerate(waves):
        shards = sorted(wave)
        outs = {}
        for key, (pkg, sm, _m) in sms.items():
            blocks = importlib.import_module(f"{pkg}.core.blocks")
            block = blocks.build_block(np.asarray(shards), [list(wave[s]) for s in shards])
            rs = sm.apply_block(block, np.arange(len(shards)), want_responses=True)
            outs[key] = [[bytes(x) for x in r] for r in rs]
        first = outs[("rabia_tpu", False)]
        for key, got in outs.items():
            assert got == first, f"wave {w}: {key} result frames"
    for s in range(n_shards):
        stores = {key: m[s].store for key, (_p, _sm, m) in sms.items()}
        want = stores[("rabia_tpu", False)]
        for key, st in stores.items():
            assert st.checksum() == want.checksum(), f"shard {s}: {key} checksum"
            assert st.version == want.version, f"shard {s}: {key} version"
            a, b = st.stats, want.stats
            assert (a.total_operations, a.reads, a.writes) == (
                b.total_operations, b.reads, b.writes
            ), f"shard {s}: {key} op stats"
        # each native snapshot restores into the other package's Python store
        for src, dst in (("rabia_tpu", "rabia_tpu_torch"), ("rabia_tpu_torch", "rabia_tpu")):
            restored = importlib.import_module(f"{dst}.apps.kvstore").KVStore(
                sms[(dst, False)][2][s].store.config
            )
            restored.restore_bytes(stores[(src, True)].snapshot_bytes())
            assert restored.checksum() == want.checksum(), (s, src, dst)


# the message kinds the C codec encodes (the rest fall through to Python)
HOT = ["VoteRound1", "VoteRound2", "Decision", "HeartBeat", "SyncRequest",
       "SyncResponse", "Propose", "NewBatch", "ProposeBlock"]


@pytest.mark.parametrize("kind", HOT)
def test_codec_bytes_agree_across_packages(kind):
    assert set(HOT) <= set(KINDS)
    codecs = {}
    for name, p in (("rabia_tpu", REF), ("rabia_tpu_torch", PORT)):
        ser = p.ser.BinarySerializer()
        assert ser._native is not None, name
        codecs[name] = (p, ser)
    encoded = 0
    for seed in (1, 2, 3, 4):
        for big in (False, True):
            for to in (False, True):
                outs = {}
                for name, (p, ser) in codecs.items():
                    msg = _message(p, kind, seed, big, to)
                    n_bytes = ser._native.encode(msg, ser.config.compression_threshold or 0)
                    py_bytes = ser._serialize_py(msg)
                    outs[(name, "python")] = py_bytes
                    if n_bytes is not None:
                        outs[(name, "native")] = n_bytes
                first = outs[("rabia_tpu", "python")]
                for key, got in outs.items():
                    assert got == first, (kind, seed, big, to, key)
                # each package's C codec decodes the other's bytes
                for name, (p, ser) in codecs.items():
                    back = ser._native.decode(first)
                    if back is not None:
                        assert ser._serialize_py(back) == first, (kind, name)
                # both packages' C codecs take or decline the same messages
                assert (("rabia_tpu", "native") in outs) == (
                    ("rabia_tpu_torch", "native") in outs
                ), (kind, seed, big, to)
                encoded += ("rabia_tpu_torch", "native") in outs
    assert encoded > 0, f"{kind}: the C codec declined every case"


def test_chip_smoke_phase12_on_cpu():
    """chip_smoke.py's phase 12 with device="cpu" at a small size: config
    5's shape of cluster (VectorShardedKV over TCP, Zipf keys: native tick
    and codec, Python apply and runtime) and config 6's (the native store:
    runtime, tick and apply native with no GIL handoff, then the asyncio
    owner), each beside a device-store MeshEngine fed the committed SETs
    whose table must equal the replicas'."""
    import chip_smoke

    st5 = chip_smoke.tcp_config5("cpu", S=64, R=3, dur=1.0)
    assert st5["committed_slots"] > 0 and st5["committed_commands"] >= st5["committed_slots"]
    assert st5["device_table_entries"] > 0 and st5["hot_shards"] > 0
    assert all(p["tick"] == "native" for p in st5["planes"])
    # on a loaded host a replica that still has a shard's slot in flight
    # when the next proposer's block arrives escalates it and decides it
    # on the scalar lane: each such handoff is named by decided_scalar and
    # left out; no wave may apply in Python. The card's host runs the full
    # size with no handoff at all.
    st6 = chip_smoke.tcp_config6("cpu", S=32, R=3, dur=1.0)
    for leg in ("runtime", "asyncio"):
        assert st6[leg]["committed_slots"] > 0
        assert st6[leg]["device_table_entries"] > 0
    assert all(d["waves_native"] > 0 and d["waves_py"] == 0
               and d["gil_handoffs"] == d["decided_scalar"]
               for d in st6["runtime"]["runtime_counter_deltas"])
