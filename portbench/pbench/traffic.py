"""The general traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) and the deployment's sizes (``configs/``), and
this module makes the inputs from them and the seed alone. The same seed
gives the same inputs; every seed gives the same sizes in another order.

Two kinds of input:

- key-value blocks (``kv_streams``: the load and the pool): columnar
  blocks of one binary op a shard, the store's wire form (``code u8 | key
  length u16 LE | key | value``; SET is code 1, GET code 2), as raw
  columns ``(shards, cmd_sizes, data)``; keys are YCSB-style ``user...``
  keys of the configuration's width, drawn a shard at a time from the
  configuration's request distribution; values are YCSB's records:
  printable ASCII of the configuration's value width (its fields'
  bytes, written whole);
- vote planes (``vote_planes``): replica-major int8 vote planes made on
  the device by a ``torch.Generator`` seeded from the seed.

Nothing of the program is imported here: the drivers wrap the columns in
the program's block type.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SET, GET = 1, 2
V0, V1, VQUESTION = 0, 1, 2  # the protocol's vote codes
HEADER = 3  # code byte and the key length
VALUE_OFFSETS = 1 << 20  # distinct places a value can start in the value buffer


@dataclass
class KVBlock:
    """One block's raw columns and what it holds."""

    shards: np.ndarray  # i64[S]: every shard once, in order
    cmd_sizes: np.ndarray  # i64[S]: one op a shard
    data: bytes
    n_set: int
    n_get: int


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one named stream of one seed (any
    whole number, also past 64 bits)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0)] + list(stream.encode()))


def key_table(shards: int, keys_per_shard: int, key_bytes: int) -> np.ndarray:
    """u8[S, P, K]: key j of shard s, ``user`` then the shard's and the
    key's decimal digits, padded with digits of a hash of both (as YCSB
    hashes its record numbers), exactly ``key_bytes`` long. Built once a
    run and shared by the load and the pool."""
    S, P, K = shards, keys_per_shard, key_bytes
    if K < 16:
        raise ValueError("keys need at least 16 bytes for the shard and key digits")
    s = np.arange(S, dtype=np.uint64)[:, None]
    j = np.arange(P, dtype=np.uint64)[None, :]
    out = np.empty((S, P, K), np.uint8)
    out[:, :, :4] = np.frombuffer(b"user", np.uint8)

    def digits(x: np.ndarray, n: int, at: int) -> None:
        x = np.broadcast_to(x, (S, P)).copy()
        for i in range(n - 1, -1, -1):
            out[:, :, at + i] = (x % np.uint64(10)).astype(np.uint8) + ord("0")
            x //= np.uint64(10)

    digits(s, 6, 4)
    digits(j, 6, 10)
    h = (s * np.uint64(0x9E3779B97F4A7C15)) ^ (j * np.uint64(0xBF58476D1CE4E5B9) + np.uint64(1))
    for i in range(16, K, 19):  # 19 decimal digits of the hash at a time
        n = min(19, K - i)
        digits(h, n, i)
        h = h * np.uint64(0x94D049BB133111EB) + np.uint64(i)
    return out


def zipf_ranks(n: int, items: int, theta: float) -> np.ndarray:
    """i64[n]: the ``n`` quantiles of the zipfian distribution over
    ``items`` (P(r) proportional to 1 / (r + 1) ** theta, rank 0 the
    hottest): the ranks of ``n`` draws, the same for every seed."""
    w = 1.0 / np.arange(1, items + 1) ** float(theta)
    cdf = np.cumsum(w / w.sum())
    return np.minimum(np.searchsorted(cdf, (np.arange(n) + 0.5) / n), items - 1)


def value_buffer(seed: int, value_bytes: int) -> np.ndarray:
    """u8[VALUE_OFFSETS + V - 1] of printable ASCII drawn from the seed:
    every value is the ``V`` bytes at an offset of its own, as YCSB fills
    a record's fields with random printable characters."""
    return rng_for(seed, "values").integers(33, 127, VALUE_OFFSETS + value_bytes - 1,
                                            dtype=np.uint8)


def _blocks(keys: np.ndarray, kinds: np.ndarray, cols: np.ndarray, voff: np.ndarray,
            vbuf: np.ndarray, value_bytes: int) -> list[KVBlock]:
    """Blocks t = 0..n-1: shard s carries op ``kinds[t, s]`` on its key
    ``cols[t, s]`` (``keys`` u8[S, P, K]); a SET's value is the
    ``value_bytes`` of ``vbuf`` at ``voff[t, s]``. Each block's ops are laid
    out as rows of a SET's width and cut to their sizes: whole where every
    op has one size, else by one mask of rows."""
    n, S = kinds.shape
    K, VB = keys.shape[2], value_bytes
    head, wide = HEADER + K, HEADER + K + VB
    windows = np.lib.stride_tricks.sliding_window_view(vbuf, VB)
    at = np.arange(S)
    rows = np.empty((S, wide), np.uint8)
    rows[:, 1] = K & 0xFF
    rows[:, 2] = K >> 8
    masks = np.stack([np.arange(wide) < head, np.ones(wide, bool)])  # a GET's row, a SET's
    out = []
    for t in range(n):
        is_set = kinds[t] == SET
        n_set = int(is_set.sum())
        rows[:, 0] = kinds[t]
        rows[:, HEADER:head] = keys[at, cols[t]]
        if n_set:
            rows[is_set, head:] = windows[voff[t, is_set]]
        if n_set in (0, S):
            data = rows[:, :wide if n_set else head].tobytes()
        else:
            data = rows[masks[is_set.view(np.int8)]].tobytes()
        sizes = np.where(is_set, wide, head).astype(np.int64)
        out.append(KVBlock(at.astype(np.int64), sizes, data, n_set, S - n_set))
    return out


def kv_load(config: dict, seed: int, keys: np.ndarray, vbuf: np.ndarray) -> list[KVBlock]:
    """The load phase: ``keys_per_shard`` full-width SET blocks, block j
    writing key j of every shard (YCSB's load of every record)."""
    S, P = config["shards"], config["keys_per_shard"]
    rng = rng_for(seed, "load")
    kinds = np.full((P, S), SET, np.int8)
    cols = np.broadcast_to(np.arange(P)[:, None], (P, S))
    return _blocks(keys, kinds, cols, rng.integers(0, VALUE_OFFSETS, (P, S)), vbuf,
                   config["value_bytes"])


def kv_pool(config: dict, traffic: dict, seed: int, keys: np.ndarray,
            vbuf: np.ndarray) -> list[KVBlock]:
    """``traffic["pool_blocks"]`` full-width blocks of the mix. Every shard
    gets the same ops, in an order of its own drawn from the seed: a share
    ``read_share`` of its ops reads, the rest updates (SETs of loaded
    keys, the whole record), and the keys' ranks the zipfian quantiles of
    the configuration's request distribution over the shard's loaded keys,
    a rank mapped to a key a shard at a time (YCSB's scrambled zipfian:
    which key is hot differs by shard). So every seed makes the same work
    in another order."""
    S, P = config["shards"], config["keys_per_shard"]
    n = int(traffic["pool_blocks"])
    rng = rng_for(seed, "pool")
    dist = config["request_distribution"]
    if dist != "zipfian":
        raise ValueError(f"unknown request distribution {dist!r}")
    ranks = rng.permuted(np.tile(zipf_ranks(n, P, config["zipf_constant"]), (S, 1)), axis=1).T
    perm = rng.permuted(np.tile(np.arange(P), (S, 1)), axis=1)  # rank -> key, a shard at a time
    cols = perm[np.arange(S)[None, :], ranks]
    n_get = int(round(n * float(traffic["read_share"])))
    reads = rng.permuted(np.tile(np.arange(n) < n_get, (S, 1)), axis=1).T
    kinds = np.where(reads, GET, SET).astype(np.int8)
    return _blocks(keys, kinds, cols, rng.integers(0, VALUE_OFFSETS, (n, S)), vbuf,
                   config["value_bytes"])


def kv_streams(config: dict, traffic: dict, seed: int) -> tuple[list, list]:
    """(load, pool) of a key-value mix, on one key table and one value
    buffer."""
    keys = key_table(config["shards"], config["keys_per_shard"], config["key_bytes"])
    vbuf = value_buffer(seed, config["value_bytes"])
    return kv_load(config, seed, keys, vbuf), kv_pool(config, traffic, seed, keys, vbuf)


def vote_planes(config: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["buffers"]`` replica-major vote planes i8[R, T, S], made
    on ``device``: a slot's votes are unanimous V1, except in a share
    ``split_share`` of slots, where each replica's vote is drawn from V0,
    V1 and VQUESTION alike (such a slot decides only where three of five
    agree)."""
    import torch

    R, S, T = config["replicas"], config["shards"], int(traffic["slots_per_window"])
    gen = torch.Generator(device=device)
    gen.manual_seed(abs(int(seed)) % (1 << 63))
    out = []
    for _ in range(int(traffic["buffers"])):
        split = torch.rand((T, S), generator=gen, device=device) < float(traffic["split_share"])
        votes = torch.randint(0, 3, (R, T, S), generator=gen, device=device, dtype=torch.int8)
        votes.masked_fill_(~split, V1)
        out.append(votes)
    return out
