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
(value, version) mapping cannot. The window packers are the reference's,
byte for byte: a window of full-width sorted blocks (the block lane's
shape) gathers its key and value bytes in one C pass
(``csrc/host_pack.cpp``, built with g++ on first use; a build or load
failure raises); every other window, one whose ops trip the C bounds
check, and every window under ``RABIA_PY_DEVPACK=1`` go through the
numpy gather, which owns the semantics. They include the dictionary
form (:class:`DeviceDictOps`: each shard's distinct op rows once, and a
rank per (wave, shard)), which the ``*_auto`` packers
choose whenever a window has at most 32 distinct rows per shard: at the
lane's window of 16 that is every window. Every program takes either
form; a card runs dictionary windows that write the table on
``csrc/kv_dict.cu`` (the waves on the dictionary's key classes) and
reads the dictionary in place. ``lookup_only`` is the
consensus-free read window of the read lane: no decision, no slot, no
output table.
"""

from __future__ import annotations

import ctypes
import os
from collections.abc import Sequence
from typing import NamedTuple, Optional

import numpy as np
import torch

from rabia_tpu_torch.apps.kvstore import _result_bin
from rabia_tpu_torch.apps.vector_kv import _RESP_DT, _USED, VectorKVStore
from rabia_tpu_torch.core.device import to_device_all
from rabia_tpu_torch.kernel import cuda_build, kv_window
from rabia_tpu_torch.kernel.kv_window import KIND_GET, VERSION_WRAP, KVTable

__all__ = [
    "HOST_PACK",
    "DeviceDictOps",
    "DeviceKVTable",
    "DeviceWindowOps",
    "GetFrameGroups",
    "MixedFrameGroups",
    "ResolvedGetFrameGroups",
]

_SET_HDR = 3  # binary op: u8 opcode + u16 klen + key + value

# fixed odd multipliers of the dictionary packer's 64-bit row hash (a
# collision is caught by the full byte compare, never trusted)
_HASH_W = np.random.default_rng(0x5EED).integers(1, 2**62, 4, dtype=np.uint64) * 2 + 1


def _fold_words(a: np.ndarray) -> np.ndarray:
    """Polynomial fold of a u8[..., B] byte plane into u64[...], viewed
    as native u32/u64 words (B is a power of two >= 4), mod 2^64."""
    mul = np.uint64(0x9E3779B97F4A7C15)
    w = a.view(np.uint64) if a.shape[-1] % 8 == 0 else a.view(np.uint32)
    h = np.zeros(a.shape[:-1], np.uint64)
    for j in range(w.shape[-1]):
        h *= mul
        h += w[..., j]
    return h


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


class DeviceDictOps(NamedTuple):
    """One window dictionary-compressed for upload (host numpy arrays):
    each shard's distinct (key, value) rows once (D rows a shard) and a
    rank per (wave, shard). A GET row is a key with an empty value."""

    idx: np.ndarray  # u8[W, S] within-shard dictionary rank
    dkl: np.ndarray  # i16[S, D] key lengths
    dvl: np.ndarray  # i16[S, D] value lengths
    dk: np.ndarray  # u32[S, D, Ku/4] key words
    dv: np.ndarray  # u32[S, D, VWu/4] value words


def _pad_dict_idx(ops: DeviceDictOps, W: int) -> DeviceDictOps:
    """Pad the rank plane to the window's W waves with rank 0. Rank 0
    names a real dictionary row: the SET and mixed programs leave pad
    waves out by depth, while ``lookup_only`` (which has no depth) reads
    row 0's key on them, as the reference's probe does."""
    if ops.idx.shape[0] < W:
        pad = np.zeros((W - ops.idx.shape[0], ops.idx.shape[1]), np.uint8)
        ops = ops._replace(idx=np.concatenate([ops.idx, pad]))
    return ops


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


class HostPackGather:
    """ctypes wrapper of ``hp_pack_gather`` (csrc/host_pack.cpp): the
    window pack's one-pass C gather on the host. The library builds with
    g++ on the first call of :meth:`load`; a build or load failure
    raises (the numpy gather takes a window only by rule, never because
    the library is missing)."""

    def __init__(self) -> None:
        self._lib = None
        self._fn = None

    @property
    def loaded(self) -> bool:
        return self._fn is not None

    def load(self):
        """Build (if needed) and bind the library; returns the C function."""
        if self._fn is None:
            lib = ctypes.CDLL(str(cuda_build.build_host("host_pack")))
            fn = lib.hp_pack_gather
            ll, vp = ctypes.c_longlong, ctypes.c_void_p
            fn.argtypes = [vp, ll, vp, vp, vp, ll, ll, ll, ll, ll, ll, vp, vp]
            fn.restype = ctypes.c_int32
            self._lib, self._fn = lib, fn
        return self._fn


HOST_PACK = HostPackGather()


class DeviceKVTable:
    """Device twin of the vector store's block lane (see module doc).

    ``pack_stats`` counts the windows each gather packed: ``native`` (the
    C gather), ``numpy`` (every other window) and ``bounds_trip`` (grid
    windows the C gather handed to numpy, also counted in ``numpy``).
    ``compiled_on_last_call`` is True after a program call (a window or a
    probe) when a library was built or loaded since the previous one: the
    kv kernels' on first use on a card, the host pack's on the first grid
    window. The latency governor does not read such a call's wall time
    as window latency (the reference's flag marks a jit compile)."""

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
        self.pack_stats = {"native": 0, "numpy": 0, "bounds_trip": 0}
        self.uploads = 0  # host-to-device copies (_upload): one a program call
        self.compiled_on_last_call = False
        self._bound = self._libraries_bound()

    @staticmethod
    def _libraries_bound() -> tuple[bool, bool]:
        return HOST_PACK.loaded, kv_window.KV_WINDOW.loaded

    def _note_call(self) -> None:
        """End of a program call: set ``compiled_on_last_call``."""
        bound = self._libraries_bound()
        self.compiled_on_last_call = bound != self._bound
        self._bound = bound

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
        if grid:
            # full-width sorted blocks (the block lane's shape): the
            # scatter is a contiguous reshape-assign, and the bytes go in
            # one C pass
            kind_w[:, :n] = op_all.reshape(W, n)
            klen_w[:, :n] = klen_all.reshape(W, n)
            vlen_w[:, :n] = vlen_all.reshape(W, n)
            if self._native_pack_gather(dbuf_all, off_all, klen_all, vlen_all, n, kwin_w, vwin_w):
                self.pack_stats["native"] += 1
                return kind_w, klen_w, vlen_w, kwin_w, vwin_w
        self.pack_stats["numpy"] += 1
        kw = dbuf_all[(off_all + _SET_HDR)[:, None] + kcols]
        kw = np.where(kcols < klen_all[:, None], kw, 0)
        vidx = np.minimum((off_all + _SET_HDR + klen_all)[:, None] + vcols, len(dbuf_all) - 1)
        vw = dbuf_all[vidx]
        vw = np.where(vcols < vlen_all[:, None], vw, 0)
        if grid:
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

    def _native_pack_gather(self, dbuf_all, off_all, klen_all, vlen_all, n, kwin_w,
                            vwin_w) -> bool:
        """The grid window's key and value bytes into the zeroed planes
        ``kwin_w`` u8[W, S, ku] and ``vwin_w`` u8[W, S, vu] in one C pass
        (op i = wave i // n, shard i % n). False hands the window to the
        numpy gather: under ``RABIA_PY_DEVPACK=1`` (only ``"1"`` opts out),
        or when the C bounds check trips (the planes are re-zeroed
        first)."""
        if os.environ.get("RABIA_PY_DEVPACK") == "1":
            return False
        fn = HOST_PACK.load()
        W, S, ku = kwin_w.shape
        vu = vwin_w.shape[2]
        n_ops = len(off_all)
        if not (0 < n <= S and n_ops == W * n and vwin_w.shape[:2] == (W, S)
                and kwin_w.dtype == vwin_w.dtype == np.uint8
                and kwin_w.flags.c_contiguous and vwin_w.flags.c_contiguous
                and len(klen_all) == len(vlen_all) == n_ops):
            raise ValueError("the C pack gather takes a grid window and contiguous u8 planes")
        dbuf = np.ascontiguousarray(dbuf_all, np.uint8)
        off = np.ascontiguousarray(off_all, np.int64)
        klen = np.ascontiguousarray(klen_all, np.int64)
        vlen = np.ascontiguousarray(vlen_all, np.int64)
        rc = fn(dbuf.ctypes.data, len(dbuf), off.ctypes.data, klen.ctypes.data,
                vlen.ctypes.data, n_ops, n, S, _SET_HDR, ku, vu,
                kwin_w.ctypes.data, vwin_w.ctypes.data)
        if rc != 0:
            kwin_w[...] = 0
            vwin_w[...] = 0
            self.pack_stats["bounds_trip"] += 1
            return False
        return True

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

    def pack_window_dict(self, blocks, max_dict: int = 32) -> Optional[DeviceDictOps]:
        """Dictionary-compress a SET window: per-shard distinct (key,
        value) rows and a rank per (wave, shard); None when outside the
        envelope, over ``max_dict`` rows in a shard, or when the byte
        compare finds a hash collision (the caller then packs rows)."""
        g = self._gather_window(blocks, "set")
        if g is None:
            return None
        return self._dict_from_gathered(g, max_dict)

    @staticmethod
    def _dict_from_gathered(g: tuple, max_dict: int = 32) -> Optional[DeviceDictOps]:
        """The dictionary form of a gathered window. Rows are told apart
        by a 64-bit hash sorted per shard; every op is then compared byte
        for byte with the row its rank names, so the result never rides
        on the hash: a collision returns None."""
        _kind, klen_w, vlen_w, kwin_w, vwin_w = g
        W, S = klen_w.shape
        h = klen_w.astype(np.uint64) * _HASH_W[0]
        h += vlen_w.astype(np.uint64) * _HASH_W[1]
        h += _fold_words(kwin_w) * _HASH_W[2]
        h += _fold_words(vwin_w) * _HASH_W[3]
        if bool((h == h[:1]).all()):
            # every wave repeats its shard's one row: D = 1, wave 0 the
            # representative, no sort (the same full compare follows)
            ok = (
                (klen_w == klen_w[:1]).all()
                and (vlen_w == vlen_w[:1]).all()
                and (kwin_w == kwin_w[:1]).all()
                and (vwin_w == vwin_w[:1]).all()
            )
            if not bool(ok):
                return None
            # copies: views would pin the whole [W, S, *] gather planes
            return DeviceDictOps(
                np.zeros((W, S), np.uint8),
                klen_w[:1].T.copy(),
                vlen_w[:1].T.copy(),
                kwin_w[0][:, None].copy().view(np.uint32),
                vwin_w[0][:, None].copy().view(np.uint32),
            )
        h = np.ascontiguousarray(h.T)  # [S, W]
        o = np.argsort(h, axis=1, kind="stable")
        hs = np.take_along_axis(h, o, axis=1)
        new = np.ones((S, W), bool)
        new[:, 1:] = hs[:, 1:] != hs[:, :-1]
        rank_sorted = np.cumsum(new, axis=1) - 1  # [S, W]
        D = int(rank_sorted[:, -1].max()) + 1
        if D > max_dict:
            return None
        rank = np.empty((S, W), np.int64)
        np.put_along_axis(rank, o, rank_sorted, axis=1)
        # representative wave of each (shard, row): its first occurrence
        rep_t = np.zeros((S, D), np.int64)
        s_new, pos_new = np.nonzero(new)
        rep_t[s_new, rank_sorted[s_new, pos_new]] = o[s_new, pos_new]
        s_cols = np.arange(S)[:, None]
        dkl = klen_w[rep_t, s_cols]  # [S, D]
        dvl = vlen_w[rep_t, s_cols]
        dkb = kwin_w[rep_t, s_cols]  # [S, D, ku]
        dvb = vwin_w[rep_t, s_cols]
        rank_ts = rank.T  # [W, S]
        sc = np.arange(S)[None, :]
        ok = (
            (klen_w == dkl[sc, rank_ts]).all()
            and (vlen_w == dvl[sc, rank_ts]).all()
            and (kwin_w == dkb[sc, rank_ts]).all()
            and (vwin_w == dvb[sc, rank_ts]).all()
        )
        if not bool(ok):
            return None
        return DeviceDictOps(
            np.ascontiguousarray(rank_ts.astype(np.uint8)),
            np.ascontiguousarray(dkl),
            np.ascontiguousarray(dvl),
            np.ascontiguousarray(dkb).view(np.uint32),
            np.ascontiguousarray(dvb).view(np.uint32),
        )

    def pack_window_auto(self, blocks):
        """A SET window in the dictionary form when it has at most 32
        distinct rows per shard, else the row form; None demotes. One
        gather serves both attempts."""
        g = self._gather_window(blocks, "set")
        if g is None:
            return None
        d = self._dict_from_gathered(g)
        return d if d is not None else self._rows_from_gathered(g)

    def pack_mixed_window_auto(self, blocks) -> Optional[tuple]:
        """A mixed window in the dictionary form where it pays, else the
        row form; None demotes. Returns ``(kind, ops, vlen_plane,
        vwin_plane)``: the two planes are the full per-wave value planes,
        which the engine's host-side value segments need whatever form
        the ops travel in."""
        g = self._gather_window(blocks, "mixed")
        if g is None:
            return None
        kind_w, klen_w, vlen_w, kwin_w, _ = g
        vwin_u32 = np.ascontiguousarray(g[4]).view(np.uint32)
        d = self._dict_from_gathered(g)
        if d is not None:
            return kind_w, d, vlen_w, vwin_u32
        ops = DeviceWindowOps(klen_w, vlen_w, np.ascontiguousarray(kwin_w).view(np.uint32),
                              vwin_u32)
        return kind_w, ops, vlen_w, vwin_u32

    def pack_get_window_auto(self, blocks):
        """A GET window in the dictionary form where the keys repeat
        enough, else the row pair ``(klen, kwin)``; None demotes."""
        g = self._gather_window(blocks, "get")
        if g is None:
            return None
        d = self._dict_from_gathered(g)
        if d is not None:
            return d
        return g[1], np.ascontiguousarray(g[3]).view(np.uint32)

    # -- the programs ----------------------------------------------------------

    @staticmethod
    def _host_ops(ops, W: int, values: bool = True) -> list:
        """A window's op planes as host arrays in the kernel's order
        ``[idx, klen, vlen, kwin, vwin]`` (words as int32): a
        :class:`DeviceDictOps` with its ranks padded to W
        (:func:`_pad_dict_idx`), or row planes (a :class:`DeviceWindowOps`
        or a lookup's ``(klen, kwin)`` pair) padded with empty waves to W.
        ``idx`` is None for the row form; ``vlen`` and ``vwin`` are None
        without ``values`` or for a lookup pair."""
        if isinstance(ops, DeviceDictOps):
            ops = _pad_dict_idx(ops, W)
            planes = [ops.idx, ops.dkl, ops.dvl, ops.dk, ops.dv]
        else:
            def pad(a):
                if a.shape[0] >= W:
                    return a
                return np.concatenate([a, np.zeros((W - a.shape[0],) + a.shape[1:], a.dtype)])

            klen, vlen, kwin, vwin = ops if len(ops) == 4 else (ops[0], None, ops[1], None)
            planes = [None, pad(klen), None if vlen is None else pad(vlen), pad(kwin),
                      None if vwin is None else pad(vwin)]
        if not values:
            planes[2] = planes[4] = None
        return [a if a is None or a.dtype != np.uint32 else a.view(np.int32) for a in planes]

    def _upload(self, arrays: list) -> list:
        """Host arrays on the device as one copy; None stays None."""
        sent = iter(to_device_all([a for a in arrays if a is not None], self.device))
        self.uploads += 1
        return [None if a is None else next(sent) for a in arrays]

    def _window(self, alive, base, depth: int, kind, ops, W: int, max_phases: int,
                state: Optional[KVTable], *, values: bool = True, want_table: bool = True,
                want_reads: bool = False, gidx: Optional[np.ndarray] = None):
        """Upload one window's host arrays (ops of either form, padded to
        W waves, and ``gidx`` where the reads are gathered) in one copy,
        then decide and apply it (:func:`kv_window.decide_window`).
        ``kind``: an i8[W', S] plane, None (every op a SET) or
        ``KIND_GET`` (a read of every non-empty key). Returns ``(new table
        or None, overflow, reads, flags)``."""
        planes = self._host_ops(ops, W, values)
        plane = kind if isinstance(kind, np.ndarray) else None
        if plane is not None and plane.shape[0] < W:
            plane = np.concatenate([plane, np.zeros((W - plane.shape[0], plane.shape[1]),
                                                    plane.dtype)])
        dev = self._upload([np.asarray(alive, bool), np.asarray(base, np.int32), plane, gidx,
                            *planes])
        alive_d, base_d, plane_d, gidx_d, idx, klen, vlen, kwin, vwin = dev
        out = kv_window.decide_window(
            self.kernel, self.state if state is None else state,
            plane_d if plane is not None else kind, klen, vlen, kwin, vwin, depth, alive_d,
            base_d, max_phases, idx=idx, want_table=want_table, want_reads=want_reads,
            gidx=gidx_d,
        )
        self._note_call()
        return out

    def decide_apply(self, alive, base, depth: int, ops, W: int, max_phases: int = 4,
                     state: Optional[KVTable] = None):
        """One decide+apply SET window on :class:`DeviceWindowOps` or
        :class:`DeviceDictOps`. Returns device tensors ``(new_state,
        flags)`` with ``flags`` i32[3] ``[all_v1, overflow,
        ver_overflow]``. The caller adopts ``new_state`` only when the
        flags are clean; the input state is never written, so a dirty
        window rolls back by keeping it."""
        new, _, _, flags = self._window(alive, base, depth, None, ops, W, max_phases, state)
        return new, flags

    def lookup_window(self, alive, base, depth: int, ops, W: int,
                      max_phases: int = 4, state: Optional[KVTable] = None):
        """One consensus+lookup GET window against ``state`` (default the
        current table), read-only. ``ops`` is ``(klen i16[W,S], kwin
        u32[W,S,Ku4])`` or a :class:`DeviceDictOps`, of which only the
        key dictionary is uploaded. Returns device tensors ``(all_v1 i32,
        found[W,S], ver[W,S], vlen[W,S], val_words[W,S,VW4])``."""
        _, _, reads, flags = self._window(
            alive, base, depth, KIND_GET, ops, W, max_phases, state, values=False,
            want_table=False, want_reads=True,
        )
        return (flags[0], *reads)

    def lookup_only(self, ops, W: int, state: Optional[KVTable] = None):
        """One consensus-free read window (the read lane's probe) against
        ``state`` (default the current table): ``ops`` as
        :meth:`lookup_window` takes them, padded to W waves. No decision,
        no slot, no output table: one read-only kernel launch on a card.
        Returns device tensors ``(found[W,S], ver[W,S], vlen[W,S],
        val_words[W,S,VW4])``. A dictionary window's pad waves carry rank
        0 and so read row 0's key, as the reference's probe does."""
        idx, klen, _, kwin, _ = self._upload(self._host_ops(ops, W, values=False))
        _, _, reads = kv_window.window(
            self.state if state is None else state, KIND_GET, klen, None, kwin, None, 0,
            idx=idx, want_table=False, want_reads=True,
        )
        self._note_call()
        return tuple(reads)

    def mixed_apply(self, alive, base, depth: int, kind: np.ndarray, get_waves: np.ndarray,
                    ops, W: int, max_phases: int = 4, state: Optional[KVTable] = None):
        """One mixed decide+apply+lookup window (SET/GET/DEL/EXISTS per
        op) on :class:`DeviceWindowOps` or :class:`DeviceDictOps`. Returns
        device tensors ``(new_state, flags, meta, gval)``: ``meta`` i32[2,
        Gp, S] (``[0]`` = version, ``[1]`` = ``(vlen << 1) | found``) and
        ``gval`` i32[Gp, S, VW4], gathered to the ``get_waves`` rows
        padded to a power of two Gp (the pad rows are wave 0's, as the
        reference's). The wave-to-row map goes up with the ops in one
        copy, and a card writes the gathered rows in the window's one
        launch."""
        Gp = 1
        while Gp < max(1, len(get_waves)):
            Gp <<= 1
        gidx = np.zeros(Gp, np.int32)
        gidx[: len(get_waves)] = get_waves
        new, _, reads, flags = self._window(
            alive, base, depth, kind, ops, W, max_phases, state, want_reads=True, gidx=gidx,
        )
        return new, flags, reads.meta, reads.val

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
            # each value lies at val_off in its arrival buffer (one buffer
            # a decided block, shared by its entries): gather them all from
            # the distinct buffers laid end to end. The reference copies
            # them one entry at a time, 6 s for a million entries
            bufs = store.val_buf[src]
            ids = np.fromiter((id(b) for b in bufs), np.int64, idx.size)
            _, first, inv = np.unique(ids, return_index=True, return_inverse=True)
            blobs = [bufs[i] if bufs[i] is not None else b"" for i in first]
            base = np.zeros(len(blobs) + 1, np.int64)
            np.cumsum([len(b) for b in blobs], out=base[1:])
            flat = np.frombuffer(b"".join(blobs) + bytes(self.VW), np.uint8)
            lens = store.val_len[src]
            cols = np.arange(self.VW)
            vals = flat[(base[inv] + store.val_off[src])[:, None] + cols[None, :]]
            vals[cols[None, :] >= lens[:, None]] = 0
            valb[sh_sorted, pos] = vals
            if seed_cache is not None:
                blob, w = vals.tobytes(), self.VW
                seed_cache.update(zip(
                    zip(sh_sorted.tolist(), store.version[src].tolist()),
                    [blob[i * w : i * w + n] for i, n in enumerate(lens.tolist())],
                ))
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
        sm.store = self.host_store(dump if dump is not None else self.dump())

    def host_store(self, d: dict) -> VectorKVStore:
        """The host replica store (``VectorKVStore``) a :meth:`dump` holds:
        one bulk insert of every entry, then the versions and counters
        pinned."""
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
        return store
