"""Device-resident KV table: the block lane's apply plane on the card.

The port of the reference package's ``rabia_tpu/apps/device_kv.py``
(row-packed windows). The table of every shard lives on the device, and
one window decides its slots (the consensus ``slot_window``) and then
scans its waves, applying every decided op (``kernel/kv_window.py``
``decide_window``: one launch of the CUDA kernel ``csrc/kv_window.cu``
for a CUDA table, which folds the decision in; the plain PyTorch
composition for a CPU table). A window's host arrays go to the device
as one copy. Per window only a 12-byte flag vector, and for reads the
found bits and versions, need to come back to the host: SET versions
are derived on the host from a mirror of the shard counters.

Scope (the fast lane, not a general store): full-width blocks of
well-formed binary SET/GET/DEL/EXISTS ops, one op per covered shard per
wave, keys up to ``key_lanes*8`` bytes, values up to ``value_width``
bytes, at most ``per_shard_capacity`` distinct keys per shard. Anything
outside that envelope, a table overflow or a fault makes the engine
demote: the device table syncs down into the host replica stores
(``VectorShardedKV``), which own the semantics.

Table layout (K4 = K/4, VW4 = VW/4 words; words are int32 bit patterns
of the key and value bytes, zero past their length):
  used     bool[S, P]      keyw i32[S, P, K4]   klen i32[S, P]
  ver      i32[S, P]       valw i32[S, P, VW4]  vlen i32[S, P]
  sver     i32[S]

Matching is a full-key compare against all P slots of the op's shard, so
slot layout differs from the host store but the observable key ->
(value, version) mapping cannot. Not ported yet: the dictionary-
compressed uploads and the consensus-free ``lookup_only`` read window
(ROADMAP Queue 1, items 1-2). The window packers are the reference's numpy path (its
``RABIA_PY_DEVPACK=1`` path), byte for byte.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple, Optional

import numpy as np
import torch

from rabia_tpu_torch.apps.kvstore import _result_bin
from rabia_tpu_torch.apps.vector_kv import _RESP_DT, _USED, VectorKVStore
from rabia_tpu_torch.core.device import to_device, to_device_all
from rabia_tpu_torch.kernel import kv_window
from rabia_tpu_torch.kernel.kv_window import KIND_GET, VERSION_WRAP, KVTable

__all__ = [
    "DeviceKVTable",
    "DeviceWindowOps",
    "GetFrameGroups",
    "MixedFrameGroups",
    "ResolvedGetFrameGroups",
]

_SET_HDR = 3  # binary op: u8 opcode + u16 klen + key + value


def _bucket(n: int, lo: int = 4) -> int:
    """Round up to a power of two (>= lo, multiple of 4 for u32 views)."""
    b = lo
    while b < n:
        b <<= 1
    return b


class DeviceWindowOps(NamedTuple):
    """One window's ops packed for the device (host numpy arrays):
    key/value bytes zero-padded to the window's bucketed widths and
    viewed as u32 words."""

    klen: np.ndarray  # i16[W, S] (0 = no op on this (wave, shard))
    vlen: np.ndarray  # i16[W, S]
    kwin: np.ndarray  # u32[W, S, Ku/4]
    vwin: np.ndarray  # u32[W, S, VWu/4]


def _get_frame(found: bool, ver: int, val: bytes) -> bytes:
    """One GET response frame, byte for byte the host store's framing."""
    if not found:
        return _result_bin(1, 0)
    try:
        return _result_bin(0, ver, val.decode("utf-8"))
    except UnicodeDecodeError:
        return _result_bin(2, ver, "value is not utf-8 text")


class _ShardFrameGroups(Sequence):
    """Lazy per-shard responses of one wave: group ``j`` covers
    ``shards[j]`` with exactly one frame, built by ``_frame(shard)`` when
    a client reads it."""

    __slots__ = ()

    def __len__(self) -> int:
        return len(self.shards)

    def __getitem__(self, j):
        if isinstance(j, slice):
            return [self[i] for i in range(*j.indices(len(self)))]
        if j < 0:
            j += len(self)
        if not (0 <= j < len(self)):
            raise IndexError(j)
        return [self._frame(int(self.shards[j]))]

    def __iter__(self):
        for j in range(len(self)):
            yield self[j]

    def group_counts(self) -> np.ndarray:
        return np.ones(len(self), np.int64)

    def __eq__(self, other) -> bool:
        if not isinstance(other, (list, tuple, Sequence)):
            return NotImplemented
        return len(self) == len(other) and all(a == b for a, b in zip(self, other))


class GetFrameGroups(_ShardFrameGroups):
    """Per-shard GET responses over one wave's downloaded lookup planes."""

    __slots__ = ("shards", "found", "ver", "vlen", "valb")

    def __init__(self, shards, found, ver, vlen, val_words) -> None:
        self.shards = shards  # i64[k] covered shards, group order
        self.found = found  # bool[S]
        self.ver = ver  # i32[S]
        self.vlen = vlen  # i32[S]
        self.valb = np.ascontiguousarray(val_words).view(np.uint8)  # u8[S, VW]

    def _frame(self, s: int) -> bytes:
        return _get_frame(
            bool(self.found[s]), int(self.ver[s]), self.valb[s, : int(self.vlen[s])].tobytes()
        )


class ResolvedGetFrameGroups(_ShardFrameGroups):
    """Per-shard GET responses whose value bytes come from host-side value
    segments: only found bits and versions crossed from the device.
    ``resolver(s, ver) -> bytes`` is a snapshot taken at settle time
    ((shard, version) identifies content: every version is assigned
    once), so later evictions cannot change a settled response."""

    __slots__ = ("shards", "found", "ver", "resolver")

    def __init__(self, shards, found, ver, resolver) -> None:
        self.shards = shards
        self.found = found  # bool[S]
        self.ver = ver  # i32[S]
        self.resolver = resolver

    def _frame(self, s: int) -> bytes:
        if not self.found[s]:
            return _get_frame(False, 0, b"")
        ver = int(self.ver[s])
        return _get_frame(True, ver, self.resolver(s, ver))


class MixedFrameGroups(_ShardFrameGroups):
    """Per-shard responses of one mixed wave: SET ops answer with the
    derived 6-byte version frame (``VectorShardedKV._vers_frames``), GET
    ops with the GET framing, DEL/EXISTS with their found-bit framing
    (the vector store's ``_apply_one``)."""

    __slots__ = ("shards", "kind", "svers", "_get")

    def __init__(self, shards, kind_row, set_vers, get_frames) -> None:
        self.shards = shards
        self.kind = kind_row  # i8[S]: 1=SET 2=GET 3=DEL 4=EXISTS
        self.svers = set_vers  # i64[S] derived SET response versions
        self._get = get_frames  # the wave's GET view, also the found bits

    def _frame(self, s: int) -> bytes:
        k = int(self.kind[s])
        if k == 1:
            arr = np.zeros(1, _RESP_DT)
            arr["version"] = np.uint32(self.svers[s])
            return arr.tobytes()
        if k == 3:
            return _result_bin(0 if self._get.found[s] else 1, 0)
        if k == 4:
            return _result_bin(0, 0, "true" if self._get.found[s] else "false")
        return self._get._frame(s)


class DeviceKVTable:
    """Device twin of the vector store's block lane (see module doc)."""

    def __init__(
        self,
        n_shards: int,
        kernel,  # MeshPhaseKernel: the decide plane and the device
        *,
        per_shard_capacity: int = 64,
        key_lanes: int = 4,
        value_width: int = 64,
    ) -> None:
        self.n_shards = int(n_shards)
        self.kernel = kernel
        self.device = kernel.device
        self.S = self.n_shards  # one device: no padding to a mesh axis
        self.P = int(per_shard_capacity)
        self.K = int(key_lanes) * 8
        self.VW = _bucket(int(value_width))
        self.K4 = self.K // 4
        self.VW4 = self.VW // 4
        S, P, dev = self.S, self.P, self.device
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731
        self.state = KVTable(
            torch.zeros((S, P), dtype=torch.bool, device=dev),
            z(S, P, self.K4), z(S, P), z(S, P), z(S, P, self.VW4), z(S, P), z(S),
        )

    # -- host-side packing -------------------------------------------------

    def _parse_block(self, b):
        """Per-block op parse for the window packers: ``(dbuf, off, klen,
        vlen, opcode)`` (dbuf is the block's bytes padded with K+header
        slack so fixed-width gathers past the last op stay in bounds), or
        None when the block is not one-op-per-shard / too short."""
        if not bool((b.counts == 1).all()):
            return None
        raw = np.frombuffer(b.data, np.uint8)
        if len(raw) < _SET_HDR * len(b):
            return None
        off = b.cmd_offsets[:-1]
        ln = b.cmd_sizes
        dbuf = np.concatenate([raw, np.zeros(self.K + _SET_HDR, np.uint8)])
        opcode = dbuf[off]
        klen = dbuf[off + 1].astype(np.int64) | (dbuf[off + 2].astype(np.int64) << 8)
        vlen = ln - _SET_HDR - klen
        return dbuf, off, klen, vlen, opcode

    def _gather_window(self, blocks, allow: str) -> Optional[tuple]:
        """Validate + bucket + fixed-width gather behind the window
        packers (``allow``: "set", "get" or "mixed").

        Returns ``(kind i8[W,S], klen i16[W,S], vlen i16[W,S], kwin
        u8[W,S,Ku], vwin u8[W,S,VWu])`` or None when any op is outside the
        requested envelope (wrong opcode, >1 op per shard, key/value over
        the table widths): the caller demotes."""
        W = len(blocks)
        S = self.S
        parsed = []
        ku = vu = 4
        for b in blocks:
            pb = self._parse_block(b)
            if pb is None:
                return None
            dbuf, off, klen, vlen, opcode = pb
            is_set = opcode == 1
            is_get = opcode == 2
            kind_ok = {
                "set": is_set,
                "get": is_get,
                # DEL and EXISTS carry exactly a key, like GET
                "mixed": is_set | is_get | (opcode == 3) | (opcode == 4),
            }[allow]
            ok = (
                kind_ok
                & (klen > 0)
                & (klen <= self.K)
                & (vlen >= 0)
                & (vlen <= self.VW)
                & (is_set | (vlen == 0))
            )
            if not bool(ok.all()):
                return None
            ku = max(ku, _bucket(int(klen.max())))
            vu = max(vu, _bucket(int(vlen.max(initial=0))))
            parsed.append((b, dbuf, off, klen, vlen, opcode))
        kind_w = np.zeros((W, S), np.int8)
        klen_w = np.zeros((W, S), np.int16)
        vlen_w = np.zeros((W, S), np.int16)
        kwin_w = np.zeros((W, S, ku), np.uint8)
        vwin_w = np.zeros((W, S, vu), np.uint8)
        kcols = np.arange(ku)[None, :]
        vcols = np.arange(vu)[None, :]
        # one gather for the whole window: concatenate the block buffers
        # and rebase the offsets; a value gather that runs past its
        # block's end is zeroed by the vlen mask
        sizes = [len(p[1]) for p in parsed]
        bases = np.zeros(W, np.int64)
        bases[1:] = np.cumsum(sizes[:-1])
        dbuf_all = np.concatenate([p[1] for p in parsed])
        off_all = np.concatenate([p[2] + bases[t] for t, p in enumerate(parsed)])
        klen_all = np.concatenate([p[3] for p in parsed])
        vlen_all = np.concatenate([p[4] for p in parsed])
        op_all = np.concatenate([p[5] for p in parsed])
        sh_all = np.concatenate([p[0].shards for p in parsed])
        n = self.n_shards
        grid = len(sh_all) == W * n and bool(
            (sh_all.reshape(W, n) == np.arange(n)[None, :]).all()
        )
        kw = dbuf_all[(off_all + _SET_HDR)[:, None] + kcols]
        kw = np.where(kcols < klen_all[:, None], kw, 0)
        vidx = np.minimum((off_all + _SET_HDR + klen_all)[:, None] + vcols, len(dbuf_all) - 1)
        vw = dbuf_all[vidx]
        vw = np.where(vcols < vlen_all[:, None], vw, 0)
        if grid:
            # full-width sorted blocks (the block lane's shape): the
            # scatter is a contiguous reshape-assign
            kind_w[:, :n] = op_all.reshape(W, n)
            klen_w[:, :n] = klen_all.reshape(W, n)
            vlen_w[:, :n] = vlen_all.reshape(W, n)
            kwin_w[:, :n] = kw.reshape(W, n, ku)
            vwin_w[:, :n] = vw.reshape(W, n, vu)
        else:
            t_all = np.repeat(np.arange(W), [len(p[2]) for p in parsed])
            kind_w[t_all, sh_all] = op_all
            klen_w[t_all, sh_all] = klen_all
            vlen_w[t_all, sh_all] = vlen_all
            kwin_w[t_all, sh_all] = kw
            vwin_w[t_all, sh_all] = vw
        return kind_w, klen_w, vlen_w, kwin_w, vwin_w

    @staticmethod
    def _rows_from_gathered(g: tuple) -> DeviceWindowOps:
        _kind, klen_w, vlen_w, kwin_w, vwin_w = g
        return DeviceWindowOps(
            klen_w,
            vlen_w,
            np.ascontiguousarray(kwin_w).view(np.uint32),
            np.ascontiguousarray(vwin_w).view(np.uint32),
        )

    def pack_window(self, blocks) -> Optional[DeviceWindowOps]:
        """Pack SET-only ``blocks`` (one per wave, FIFO order) into device
        inputs; None when outside the write lane's envelope."""
        g = self._gather_window(blocks, "set")
        return None if g is None else self._rows_from_gathered(g)

    def pack_mixed_window(self, blocks) -> Optional[tuple]:
        """Pack blocks whose ops are any interleaving of SET, GET, DEL and
        EXISTS into one window: ``(kind i8[W, S], DeviceWindowOps)``, or
        None when any op is outside the envelope."""
        g = self._gather_window(blocks, "mixed")
        return None if g is None else (g[0], self._rows_from_gathered(g))

    def pack_get_window(self, blocks) -> Optional[tuple]:
        """Pack GET-only blocks: ``(klen i16[W, S], kwin u32[W, S, Ku4])``,
        or None when outside the read envelope."""
        g = self._gather_window(blocks, "get")
        if g is None:
            return None
        return g[1], np.ascontiguousarray(g[3]).view(np.uint32)

    # -- the programs ----------------------------------------------------------

    def _window(self, alive, base, depth: int, kind: Optional[np.ndarray], klen, vlen, kwin,
                vwin, W: int, max_phases: int, state: Optional[KVTable], *,
                want_table: bool = True, want_reads: bool = False):
        """Upload one window's host arrays (op planes padded with empty
        waves to W) in one copy, then decide and apply it
        (:func:`kv_window.decide_window`; ``kind`` None: every op is a
        SET). Returns ``(new table or None, overflow, reads, flags)``."""
        def pad(a):
            if a.shape[0] == W:
                return a
            return np.concatenate([a, np.zeros((W - a.shape[0],) + a.shape[1:], a.dtype)])

        host = [np.asarray(alive, bool), np.asarray(base, np.int32), pad(klen), pad(vlen),
                pad(kwin).view(np.int32), pad(vwin).view(np.int32)]
        if kind is not None:
            host.append(pad(kind))
        dev = to_device_all(host, self.device)
        return kv_window.decide_window(
            self.kernel, self.state if state is None else state,
            dev[6] if kind is not None else None, *dev[2:6], depth, dev[0], dev[1], max_phases,
            want_table=want_table, want_reads=want_reads,
        )

    def decide_apply(self, alive, base, depth: int, ops: DeviceWindowOps, W: int,
                     max_phases: int = 4, state: Optional[KVTable] = None):
        """One decide+apply SET window. Returns device tensors
        ``(new_state, flags)`` with ``flags`` i32[3] ``[all_v1, overflow,
        ver_overflow]``. The caller adopts ``new_state`` only when the
        flags are clean; the input state is never written, so a dirty
        window rolls back by keeping it."""
        new, _, _, flags = self._window(alive, base, depth, None, *ops, W, max_phases, state)
        return new, flags

    def lookup_window(self, alive, base, depth: int, ops, W: int,
                      max_phases: int = 4, state: Optional[KVTable] = None):
        """One consensus+lookup GET window against ``state`` (default the
        current table), read-only. ``ops`` is ``(klen i16[W,S], kwin
        u32[W,S,Ku4])``. Returns device tensors ``(all_v1 i32, found[W,S],
        ver[W,S], vlen[W,S], val_words[W,S,VW4])``."""
        klen, kwin = ops
        kind = np.where(klen > 0, KIND_GET, 0).astype(np.int8)
        vwin = np.zeros(klen.shape + (1,), np.uint32)
        _, _, reads, flags = self._window(
            alive, base, depth, kind, klen, np.zeros_like(klen), kwin, vwin, W, max_phases, state,
            want_table=False, want_reads=True,
        )
        return (flags[0], *reads)

    def mixed_apply(self, alive, base, depth: int, kind: np.ndarray, get_waves: np.ndarray,
                    ops: DeviceWindowOps, W: int, max_phases: int = 4,
                    state: Optional[KVTable] = None):
        """One mixed decide+apply+lookup window (SET/GET/DEL/EXISTS per
        op). Returns device tensors ``(new_state, flags, meta, gval)``:
        ``meta`` i32[2, Gp, S] (``[0]`` = version, ``[1]`` =
        ``(vlen << 1) | found``) and ``gval`` i32[Gp, S, VW4], gathered to
        the ``get_waves`` rows padded to a power of two Gp."""
        new, _, reads, flags = self._window(
            alive, base, depth, kind, *ops, W, max_phases, state, want_reads=True,
        )
        Gp = 1
        while Gp < max(1, len(get_waves)):
            Gp <<= 1
        gidx = np.zeros(Gp, np.int64)
        gidx[: len(get_waves)] = get_waves
        g = to_device(gidx, self.device)
        meta = torch.stack([
            reads.ver.index_select(0, g),
            (reads.vlen.index_select(0, g) << 1) | reads.found.index_select(0, g).to(torch.int32),
        ])
        return new, flags, meta, reads.val.index_select(0, g)

    def adopt(self, new_state: KVTable) -> None:
        self.state = new_state

    # -- sync down (demotion / checkpoint) and up (re-promotion) --------------

    def dump(self) -> dict:
        """The table on the host as columns of its used slots, in (shard,
        slot) order: ``shard``, ``key`` u8[n, K], ``key_len``, ``value``
        u8[n, VW], ``value_len``, ``version``, plus ``shard_version``."""
        used, keyw, klen, ver, valw, vlen, sver = (x.cpu().numpy() for x in self.state)
        s_idx, p_idx = np.nonzero(used)
        S, P = self.S, self.P
        return {
            "shard": s_idx.astype(np.int64),
            "key": keyw.view(np.uint8).reshape(S, P, self.K)[s_idx, p_idx],
            "key_len": klen[s_idx, p_idx].astype(np.int64),
            "value": valw.view(np.uint8).reshape(S, P, self.VW)[s_idx, p_idx],
            "value_len": vlen[s_idx, p_idx].astype(np.int64),
            "version": ver[s_idx, p_idx].astype(np.int64),
            "shard_version": sver.astype(np.int64),
        }

    def upload_from(self, sm, seed_cache: Optional[dict] = None) -> bool:
        """Rebuild the device table from one host replica store (the
        re-promotion path after a demotion).

        ``seed_cache`` (optional) gets ``(shard, version) -> value bytes``
        for every uploaded entry, so the GET lane can resolve versions
        from before the promotion without downloading values.

        Returns False, leaving the device table untouched, when the host
        content is outside the lane's envelope: an overflow side-store
        entry, a key over ``K`` bytes, a value over ``VW`` bytes, more than
        ``P`` live entries in one shard, or a version near the i32 wrap.
        Any assignment of a shard's entries to distinct slots is a valid
        table (the match compares against all P slots)."""
        store = sm.store
        if store._overflow:
            return False  # long keys live outside the inline table
        idx = np.nonzero(store.state == _USED)[0]
        shards = store.shard_col[idx]
        if idx.size:
            if int(store.key_len[idx].max()) > self.K:
                return False
            if int(store.val_len[idx].max()) > self.VW:
                return False
            if int(store.version[idx].max()) >= VERSION_WRAP:
                return False
            if int(np.bincount(shards, minlength=self.n_shards).max()) > self.P:
                return False
        if int(store.shard_version[: self.n_shards].max(initial=0)) >= VERSION_WRAP:
            return False

        S, P = self.S, self.P
        used = np.zeros((S, P), bool)
        keyb = np.zeros((S, P, self.K), np.uint8)
        klen = np.zeros((S, P), np.int32)
        ver = np.zeros((S, P), np.int32)
        valb = np.zeros((S, P, self.VW), np.uint8)
        vlen = np.zeros((S, P), np.int32)
        if idx.size:
            # stable per-shard slot assignment: slot = rank within the shard
            order = np.argsort(shards, kind="stable")
            sh_sorted = shards[order]
            starts = np.searchsorted(sh_sorted, np.arange(self.n_shards))
            pos = np.arange(idx.size) - starts[sh_sorted]
            src = idx[order]
            used[sh_sorted, pos] = True
            klen[sh_sorted, pos] = store.key_len[src]
            ver[sh_sorted, pos] = store.version[src]
            vlen[sh_sorted, pos] = store.val_len[src]
            key_bytes = store.key_lanes[src].view(np.uint8)  # [n, L*8], zero tails
            kb_w = min(self.K, key_bytes.shape[1])
            keyb[sh_sorted, pos, :kb_w] = key_bytes[:, :kb_w]
            for j in range(idx.size):
                i = src[j]
                buf = store.val_buf[i]
                a = int(store.val_off[i])
                v = buf[a : a + int(store.val_len[i])] if buf is not None else b""
                valb[sh_sorted[j], pos[j], : len(v)] = np.frombuffer(v, np.uint8)
                if seed_cache is not None:
                    seed_cache[(int(sh_sorted[j]), int(store.version[i]))] = bytes(v)
        sver = np.asarray(store.shard_version[: self.n_shards], np.int32)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        self.state = KVTable(
            put(used), put(keyb.view(np.int32)), put(klen), put(ver),
            put(valb.view(np.int32)), put(vlen), put(sver),
        )
        return True

    def sync_into(self, sm, dump: Optional[dict] = None) -> None:
        """Rebuild one host replica store (``VectorShardedKV``) from the
        device table; the host store is replaced (in device mode the host
        replicas saw none of the device lane's applies). Pass a
        precomputed :meth:`dump` when syncing several replicas. One bulk
        insert of every entry, then the versions and counters pinned."""
        d = dump if dump is not None else self.dump()
        n = len(d["shard"])
        store = VectorKVStore(self.n_shards, capacity=max(1 << 10, 2 * n))
        if n:
            if self.K > store.K:
                raise ValueError(f"device keys of {self.K} B exceed the store's {store.K} B lanes")
            keys = np.zeros((n, store.K), np.uint8)
            keys[:, : self.K] = d["key"]
            lanes = keys.view(np.uint64).reshape(n, store.L)
            shards = d["shard"]
            voffs = np.arange(n, dtype=np.int64) * self.VW
            store.bulk_set(shards, lanes, d["key_len"],
                           (np.ascontiguousarray(d["value"]).tobytes(), voffs, d["value_len"]))
            store.version[store._lookup(shards, lanes, d["key_len"])] = d["version"]
        store.shard_version[:] = 0
        store.shard_version[: self.n_shards] = d["shard_version"]
        sm.store = store
