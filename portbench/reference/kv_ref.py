"""Plain NumPy reference of the replicated key-value store's semantics.

The store is partitioned by shard; each shard holds its keys with a value
and a version, and a per-shard version counter that every SET advances by
one (the SET's version is the counter's new value). A block of the block
lane carries one op a shard, so its ops touch distinct shards and apply
together; blocks apply in the order they were submitted. Responses are the
store's binary frames: ``kind u8 | version u32 LE | has-value u8 | value``
with kind 0 for success, 1 for not found, 2 for an error:

- SET: ``0 | version | 0``;
- GET of a present key: ``0 | its version | 1 | value`` (a value that is
  not UTF-8 answers ``2 | version | 1 | "value is not utf-8 text"``);
- GET of an absent key: ``1 | 0 | 0``.

Only SET and GET, of keys no wider than ``key_bytes`` and values no
wider than ``value_bytes``: anything else raises (outside the envelope of
this reference). This file imports numpy only.
"""

from __future__ import annotations

import numpy as np

SET, GET = 1, 2
_HDR = 3
_MIX = np.uint64(0x9E3779B97F4A7C15)


def _hash(shards: np.ndarray, lanes: np.ndarray) -> np.ndarray:
    h = shards.astype(np.uint64) * _MIX
    for i in range(lanes.shape[1]):
        h = (h ^ lanes[:, i]) * np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(31)
    return h


class KVReference:
    """The store's state as dense arrays, ``capacity`` keys a shard."""

    def __init__(self, shards: int, capacity: int, key_bytes: int, value_bytes: int) -> None:
        S, P = shards, capacity
        self.S, self.P, self.VB = S, P, value_bytes
        self.key_bytes = key_bytes
        self.K = -(-key_bytes // 8) * 8  # a key's width in whole 8-byte lanes
        self.keys = np.zeros((S, P, self.K), np.uint8)
        self.klen = np.zeros((S, P), np.int64)
        self.used = np.zeros((S, P), bool)
        self.version = np.zeros((S, P), np.int64)
        self.value = np.zeros((S, P, value_bytes), np.uint8)
        self.vlen = np.zeros((S, P), np.int64)
        self.shard_version = np.zeros(S, np.int64)
        self.fill = np.zeros(S, np.int64)
        self._index = (np.zeros(0, np.uint64), np.zeros(0, np.int64))
        self._index_gen = 0  # bumped whenever a key enters the index
        self._parsed: dict = {}

    # -- parsing --------------------------------------------------------------

    def _parse(self, shards: np.ndarray, sizes: np.ndarray, data: bytes):
        """[shards, code, klen, lanes u64[n, K/8], keys, (the SETs' positions,
        shards, value lengths, values), index generation, key columns] of a
        block; kept by the identity of ``data``, since a stream may send the
        same bytes again (the columns are found again once a key has entered
        the index)."""
        got = self._parsed.get(id(data))
        if got is not None and got[0] is data:
            return got[1]
        shards = np.asarray(shards, np.int64)
        sizes = np.asarray(sizes, np.int64)
        if len(np.unique(shards)) != len(shards) or len(sizes) != len(shards):
            raise ValueError("a block carries one op on each of distinct shards")
        raw = np.frombuffer(data, np.uint8)
        if int(sizes.sum()) != len(raw):
            raise ValueError("the ops' sizes disagree with the block's bytes")
        off = np.zeros(len(sizes), np.int64)
        np.cumsum(sizes[:-1], out=off[1:])
        pad = np.concatenate([raw, np.zeros(_HDR + self.K + self.VB, np.uint8)])
        code = pad[off]
        klen = pad[off + 1].astype(np.int64) | (pad[off + 2].astype(np.int64) << 8)
        vlen = sizes - _HDR - klen
        if bool(((code != SET) & (code != GET)).any()):
            raise ValueError("an op other than SET and GET")
        if bool((klen > self.key_bytes).any() | (vlen < 0).any()):
            raise ValueError("a key wider than the store's key width")
        if bool(((code == SET) & (vlen > self.VB)).any()):
            raise ValueError("a value wider than the store's value width")
        # each op's key and each SET's value as rows of fixed width read in
        # place, then zeroed past their lengths
        keys = np.lib.stride_tricks.sliding_window_view(pad, self.K)[off + _HDR]
        keys = np.where(np.arange(self.K) < klen[:, None], keys, 0).astype(np.uint8)
        lanes = keys.view(np.uint64)
        is_set = np.nonzero(code == SET)[0]
        vstart = (off + _HDR + klen)[is_set]
        values = np.lib.stride_tricks.sliding_window_view(pad, self.VB)[vstart]
        values = np.where(np.arange(self.VB) < vlen[is_set][:, None], values, 0).astype(np.uint8)
        sets = (is_set, shards[is_set], vlen[is_set], values)
        out = [shards, code, klen, lanes, keys, sets, -1, None]
        self._parsed[id(data)] = (data, out)
        return out

    # -- key index ------------------------------------------------------------

    def _index_add(self, s: np.ndarray, c: np.ndarray) -> None:
        """Merge the keys now in columns ``c`` of shards ``s`` into the
        sorted hash index."""
        lanes = np.ascontiguousarray(self.keys[s, c]).view(np.uint64)
        h = _hash(s, lanes) ^ self.klen[s, c].astype(np.uint64)
        order = np.argsort(h)
        hs, pos = self._index
        at = np.searchsorted(hs, h[order])
        self._index = (np.insert(hs, at, h[order]), np.insert(pos, at, (s * self.P + c)[order]))
        self._index_gen += 1

    def _find(self, shards, klen, lanes) -> np.ndarray:
        """The column of each op's key in its shard, -1 where absent."""
        hs, pos = self._index
        h = _hash(shards, lanes) ^ klen.astype(np.uint64)
        i = np.minimum(np.searchsorted(hs, h), max(len(hs) - 1, 0))
        col = np.full(len(h), -1, np.int64)
        if len(hs) == 0:
            return col
        hit = hs[i] == h
        c = pos[i] % self.P
        same = (self.used[shards, c] & (self.klen[shards, c] == klen)
                & (np.ascontiguousarray(self.keys[shards, c]).view(np.uint64) == lanes).all(1))
        if bool((hit & ~same).any()):
            raise RuntimeError("the reference's key hash collided")
        col[hit] = c[hit]
        return col

    # -- apply ------------------------------------------------------------------

    def apply(self, shards, sizes, data: bytes, frames: bool = False, lose_writes: bool = False):
        """Apply one block; with ``frames`` return its response frames, one
        a shard in block order. ``lose_writes`` answers the block's SETs
        as if applied but keeps none of them (a control that breaks the
        guarantee that every acknowledged write is read back)."""
        parsed = self._parse(shards, sizes, data)
        sh, code, klen, lanes, keys, (set_at, s_sh, s_vlen, s_val), gen, col = parsed
        if gen != self._index_gen:  # the block's key columns, while no key enters
            parsed[6], parsed[7] = self._index_gen, self._find(sh, klen, lanes)
        col = parsed[7]
        is_set = code == SET
        new = is_set & (col < 0)
        if new.any():
            col = col.copy()
            ns = sh[new]
            if bool((self.fill[ns] >= self.P).any()):
                raise ValueError("a shard holds more keys than the reference's capacity")
            col[new] = self.fill[ns]
        out = self._frames(sh, code, col) if frames else None
        sc = col[set_at]
        s_ver = self.shard_version[s_sh] + 1
        self.shard_version[s_sh] = s_ver
        if not lose_writes:
            self.version[s_sh, sc] = s_ver
            self.value[s_sh, sc] = s_val
            self.vlen[s_sh, sc] = s_vlen
            if new.any():
                ns, nc = sh[new], col[new]
                self.keys[ns, nc] = keys[new]
                self.klen[ns, nc] = klen[new]
                self.used[ns, nc] = True
                self.fill[ns] += 1
                self._index_add(ns, nc)
        if out is not None:
            for i, v in zip(set_at.tolist(), s_ver.tolist()):
                out[i] = _frame(0, v)
        return out

    def _frames(self, sh, code, col) -> list:
        """The GETs' frames against the table as the block finds it (the
        SETs' are filled in once their versions are known)."""
        out: list = [None] * len(sh)
        is_get = code == GET
        found = is_get & (col >= 0)
        for i in np.nonzero(is_get & ~found)[0].tolist():
            out[i] = _frame(1, 0)
        gs, gc = sh[found], col[found]
        for i, v, n, val in zip(np.nonzero(found)[0].tolist(), self.version[gs, gc].tolist(),
                                self.vlen[gs, gc].tolist(), self.value[gs, gc]):
            b = val[:n].tobytes()
            try:
                out[i] = _frame(0, v, b.decode("utf-8"))
            except UnicodeDecodeError:
                out[i] = _frame(2, v, "value is not utf-8 text")
        return out

    # -- the table --------------------------------------------------------------

    def entries(self) -> tuple:
        """(shards, klen, lanes u64[n, K/8], versions, values as bytes) of
        every present key, shard by shard in column order."""
        s, c = np.nonzero(self.used)
        lanes = np.ascontiguousarray(self.keys[s, c]).view(np.uint64)
        vals = [v[:n].tobytes() for v, n in zip(self.value[s, c], self.vlen[s, c].tolist())]
        return s, self.klen[s, c], lanes, self.version[s, c], vals


def _frame(kind: int, version: int, value: str | None = None) -> bytes:
    head = bytes((kind,)) + (version & 0xFFFFFFFF).to_bytes(4, "little")
    return head + (b"\x00" if value is None else b"\x01" + value.encode())
