"""The device KV table's wave scan: plain PyTorch and the CUDA kernel.

One window of W waves over a table of S shards x P slots (see
``csrc/kv_window.cuh`` for the per-op rules). Every program of
:class:`~rabia_tpu_torch.apps.device_kv.DeviceKVTable` is this scan with
its own kinds: a SET window passes ``kind=None`` (every op a SET), a
lookup and the consensus-free probe ``kind=KIND_GET`` (a read of every
non-empty key) and no output table, a mixed window its kind plane.

The op planes come in the row form (``klen``/``vlen`` i16[W, S],
``kwin``/``vwin`` i32[W, S, *]) or, with ``idx`` u8[W, S], in the
dictionary form: the same four arguments are each shard's D distinct
rows (i16[S, D], i32[S, D, *]) and op (t, s) is row ``idx[t, s]`` of its
shard (:func:`expand_dict`). ``vlen`` and ``vwin`` may be None where
every value is empty (the lookups upload no value planes).

``kv_window_plain`` is the plain PyTorch version (a loop over the waves,
each wave vectorised over the shards). ``KV_WINDOW`` wraps three
hand-written kernels that replace the wave scans of the reference's XLA
programs in ``rabia_tpu/apps/device_kv.py``: ``csrc/kv_window.cu`` the
windows that write a table in the row form (``_apply_set_wave`` under
``_build_fused``, ``_build_mixed``) and in the dictionary form on tables
wider than 64 slots or with more than 32 rows a shard;
``csrc/kv_dict.cu`` the other windows that write a table in the
dictionary form (``_build_fused_dict``, the ``D`` branch of
``_build_mixed``); and
``csrc/kv_read.cu`` the windows that only read (``_build_lookup_only``,
``_build_lookup``): a call without an output table must read every
non-empty key (``kind=KIND_GET``), and its waves are then independent.
``window`` dispatches on the tensor's device alone: a CUDA table goes to
the kernels (or the wrapper raises), a CPU table to the plain version.

A window that writes a table can return its reads gathered to given
waves (``gidx`` i32[G]: row g is wave ``gidx[g]``), as ``mixed_apply``
returns them: :class:`GatheredReads`, ``meta`` i32[2, G, S] (the
version, and ``(vlen << 1) | found``) and ``val`` i32[G, S, VW4]. The
write kernels write their reads only so, in the same launch; without
``gidx`` the wrapper has them gather every wave and splits ``meta``
into :class:`WindowReads`.

The device lane's programs also decide the window first (every replica
votes V1 for the waves that carry ops) and reduce to flags ``i32[3] =
[all_v1, overflow, version near the wrap]``. ``decide_window`` does both
in one launch on a card (``KV_WINDOW.decide``: the mesh window's math
folded into the same kernel); its plain version ``decide_window_plain``
is the composition of the plain mesh window, ``kv_window_plain`` and the
flag reduction.

Both are functional: they return a fresh table and never write the
input, so a dirty window rolls back by keeping the old table. Key and
value words are int32 bit patterns (equality and selects are exact).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from rabia_tpu_torch.core.types import V1, f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cuda_build
from rabia_tpu_torch.kernel.phase_driver import coin_threshold

I8, I16, I32 = torch.int8, torch.int16, torch.int32
KIND_SET, KIND_GET, KIND_DEL = 1, 2, 3  # 4 is EXISTS: a read, like GET
I64 = torch.int64
VERSION_WRAP = 2**31 - 2  # a shard counter this high demotes (i32 table)
MAX_REPLICAS = 64  # csrc/mesh_window.cuh: one bit per replica in a uint64_t


class KVTable(NamedTuple):
    """The device table: one row of P slots per shard."""

    used: torch.Tensor  # bool[S, P]
    keyw: torch.Tensor  # i32[S, P, K4] key words
    klen: torch.Tensor  # i32[S, P]
    ver: torch.Tensor  # i32[S, P]
    valw: torch.Tensor  # i32[S, P, VW4] value words
    vlen: torch.Tensor  # i32[S, P]
    sver: torch.Tensor  # i32[S] shard version counter


class WindowReads(NamedTuple):
    """Per (wave, shard) read outputs; ver/vlen/val are zero except
    where a GET found its key."""

    found: torch.Tensor  # bool[W, S] found, for GET/DEL/EXISTS with a key
    ver: torch.Tensor  # i32[W, S]
    vlen: torch.Tensor  # i32[W, S]
    val: torch.Tensor  # i32[W, S, VW4]


class GatheredReads(NamedTuple):
    """The read outputs of the waves ``gidx`` names, row g for wave
    ``gidx[g]``: ``mixed_apply``'s ``meta`` and ``gval``."""

    meta: torch.Tensor  # i32[2, G, S]: [0] the version, [1] (vlen << 1) | found
    val: torch.Tensor  # i32[G, S, VW4]


def gather_reads(reads: WindowReads, gidx: torch.Tensor) -> GatheredReads:
    """The plain gather of ``reads`` to the waves ``gidx``."""
    g = gidx.to(I64)
    meta = torch.stack([reads.ver.index_select(0, g),
                        (reads.vlen.index_select(0, g) << 1) | reads.found.index_select(0, g).to(I32)])
    return GatheredReads(meta, reads.val.index_select(0, g))


def _pad_words(w: torch.Tensor, width: int) -> torch.Tensor:
    """Op words zero-padded to the table width (zero tails keep prefix
    equality equal to full-key equality)."""
    if w.shape[-1] == width:
        return w
    out = torch.zeros(w.shape[:-1] + (width,), dtype=I32, device=w.device)
    out[..., : w.shape[-1]] = w
    return out


def expand_dict(idx: torch.Tensor, dkl: torch.Tensor, dvl: Optional[torch.Tensor],
                dk: torch.Tensor, dv: Optional[torch.Tensor]) -> tuple:
    """The row planes ``(klen, vlen, kwin, vwin)`` that a dictionary-form
    window stands for: op (t, s) is row ``idx[t, s]`` of shard s's
    dictionary, and a rank at or past D is an empty op (the reference's
    one-hot expansion gives zeros there). None stays None. This is the
    plain version's reading of the form; the kernel reads the dictionary
    in place."""
    W, S = idx.shape
    D = dkl.shape[1]
    rank = idx.to(I64)
    ok = rank < D
    rank = torch.where(ok, rank, 0)
    shard = torch.arange(S, device=idx.device)[None, :]

    def take(x):
        if x is None:
            return None
        if D == 0:
            return torch.zeros((W, S) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        rows = x[shard, rank]  # [W, S, ...]
        keep = ok if rows.dim() == 2 else ok[..., None]
        return torch.where(keep, rows, torch.zeros((), dtype=x.dtype, device=x.device))

    return take(dkl), take(dvl), take(dk), take(dv)


def implied_kind(kind, klen: torch.Tensor) -> torch.Tensor:
    """The kind plane of a window: ``kind`` itself when it is one, else
    every op a SET (``None`` or ``KIND_SET``) or a read of every
    non-empty key (``KIND_GET``), from the row-form key lengths."""
    if isinstance(kind, torch.Tensor):
        return kind
    if kind is None or kind == KIND_SET:
        return torch.full(klen.shape, KIND_SET, dtype=I8, device=klen.device)
    return torch.where(klen > 0, KIND_GET, 0).to(I8)


def _row_ops(kind, klen, vlen, kwin, vwin, idx):
    """The op planes in the row form with a kind plane and no None."""
    if idx is not None:
        klen, vlen, kwin, vwin = expand_dict(idx, klen, vlen, kwin, vwin)
    dev = klen.device
    if vlen is None:
        vlen = torch.zeros(klen.shape, dtype=I16, device=dev)
    if vwin is None:
        vwin = torch.zeros(tuple(klen.shape) + (0,), dtype=I32, device=dev)
    return implied_kind(kind, klen), klen, vlen, kwin, vwin


def window_waves(kind, klen: torch.Tensor, idx: Optional[torch.Tensor]) -> int:
    """W of a window in either form."""
    if idx is not None:
        return idx.shape[0]
    return kind.shape[0] if isinstance(kind, torch.Tensor) else klen.shape[0]


def kv_window_plain(
    table: KVTable,
    kind,  # i8[W, S]; None or KIND_SET: every op a SET; KIND_GET: reads of non-empty keys
    klen: torch.Tensor,  # i16[W, S] (with idx: i16[S, D])
    vlen: Optional[torch.Tensor],  # as klen; None: empty values
    kwin: torch.Tensor,  # i32[W, S, Ku4] (with idx: i32[S, D, Ku4])
    vwin: Optional[torch.Tensor],  # i32[W, S, VWu4] (with idx: [S, D, VWu4]); None: no words
    depth: int,
    *,
    idx: Optional[torch.Tensor] = None,  # u8[W, S]: the dictionary form
    want_table: bool = True,
    want_reads: bool = False,
    gidx: Optional[torch.Tensor] = None,  # i32[G]: reads gathered to these waves
) -> tuple[Optional[KVTable], torch.Tensor, Optional[WindowReads]]:
    """The wave scan in plain PyTorch. Returns ``(new table or None,
    overflow bool[S], reads or None)``; the reads are
    :class:`GatheredReads` with ``gidx``."""
    kind, klen, vlen, kwin, vwin = _row_ops(kind, klen, vlen, kwin, vwin, idx)
    used, keyw, kl, ver, valw, vl, sver = table
    S, P, K4 = keyw.shape
    VW4 = valw.shape[2]
    W = klen.shape[0]
    dev = keyw.device
    kw_full = _pad_words(kwin, K4)
    vw_full = _pad_words(vwin, VW4)
    slots = torch.arange(P, device=dev)
    rows = torch.arange(S, device=dev)
    overflow = torch.zeros(S, dtype=torch.bool, device=dev)
    reads = None
    if want_reads:
        reads = WindowReads(
            torch.zeros((W, S), dtype=torch.bool, device=dev),
            torch.zeros((W, S), dtype=I32, device=dev),
            torch.zeros((W, S), dtype=I32, device=dev),
            torch.zeros((W, S, VW4), dtype=I32, device=dev),
        )
    for t in range(W):
        k = kind[t].to(I32)
        kt = klen[t].to(I32)
        kwt, vwt = kw_full[t], vw_full[t]
        eq = used & (kl == kt[:, None]) & (keyw == kwt[:, None, :]).all(-1)  # [S, P]
        found = eq.any(1)
        # argmax on bool is refused by torch; int8 keeps "first maximum"
        match = eq.to(I8).argmax(1)
        if reads is not None:  # reads see the wave-entry state
            hit = found & (k == KIND_GET)
            reads.found[t] = found & (k >= KIND_GET) & (kt > 0)
            reads.ver[t] = torch.where(hit, ver[rows, match], 0)
            reads.vlen[t] = torch.where(hit, vl[rows, match], 0)
            reads.val[t] = torch.where(hit[:, None], valw[rows, match], 0)
        if t >= depth:
            continue  # a wave outside the window applies nothing
        del_hit = (k == KIND_DEL) & found
        used = used & ~(eq & del_hit[:, None])
        sver = sver + del_hit.to(I32)
        is_set = k == KIND_SET
        free = ~used
        full = ~free.any(1)
        slot = torch.where(found, match, free.to(I8).argmax(1))
        apply = is_set & (found | ~full)
        overflow |= is_set & ~found & full
        onehot = (slots[None, :] == slot[:, None]) & apply[:, None]  # [S, P]
        oh3 = onehot[:, :, None]
        new_ver = sver + 1  # int32: wraps like the reference's counters
        used = used | onehot
        keyw = torch.where(oh3, kwt[:, None, :], keyw)
        kl = torch.where(onehot, kt[:, None], kl)
        ver = torch.where(onehot, new_ver[:, None], ver)
        valw = torch.where(oh3, vwt[:, None, :], valw)
        vl = torch.where(onehot, vlen[t].to(I32)[:, None], vl)
        sver = torch.where(apply, new_ver, sver)
    new = KVTable(used, keyw, kl, ver, valw, vl, sver) if want_table else None
    if gidx is not None:
        reads = gather_reads(reads, gidx)
    return new, overflow, reads


def _check_args(table: KVTable, kind, klen, vlen, kwin, vwin, depth: int, idx=None,
                want_table: bool = True, want_reads: bool = False, gidx=None) -> None:
    used = table.used
    if used.dtype != torch.bool or used.dim() != 2:
        raise ValueError(f"table.used must be bool[S, P], got {used.dtype}{list(used.shape)}")
    S, P = used.shape
    if table.keyw.dtype != I32 or table.keyw.dim() != 3 or table.keyw.shape[:2] != (S, P):
        raise ValueError(f"table.keyw must be int32[{S}, {P}, K4], got "
                         f"{table.keyw.dtype}{list(table.keyw.shape)}")
    if table.valw.dtype != I32 or table.valw.dim() != 3 or table.valw.shape[:2] != (S, P):
        raise ValueError(f"table.valw must be int32[{S}, {P}, VW4], got "
                         f"{table.valw.dtype}{list(table.valw.shape)}")
    for name in ("klen", "ver", "vlen"):
        x = getattr(table, name)
        if x.dtype != I32 or tuple(x.shape) != (S, P):
            raise ValueError(f"table.{name} must be int32[{S}, {P}], got {x.dtype}{list(x.shape)}")
    if table.sver.dtype != I32 or tuple(table.sver.shape) != (S,):
        raise ValueError(f"table.sver must be int32[{S}], got {table.sver.dtype}{list(table.sver.shape)}")
    is_plane = isinstance(kind, torch.Tensor)
    if not is_plane and kind not in (None, KIND_SET, KIND_GET):
        raise ValueError(f"kind must be an int8[W, S] plane, None, KIND_SET or KIND_GET, got {kind!r}")
    if is_plane and (kind.dtype != I8 or kind.dim() != 2 or kind.shape[1] != S):
        raise ValueError(f"kind must be int8[W, {S}], got {kind.dtype}{list(kind.shape)}")
    if idx is not None:
        if idx.dtype != torch.uint8 or idx.dim() != 2 or idx.shape[1] != S:
            raise ValueError(f"idx must be uint8[W, {S}], got {idx.dtype}{list(idx.shape)}")
        if klen.dim() != 2 or klen.shape[0] != S:
            raise ValueError(f"klen must be int16[{S}, D] with idx, got {klen.dtype}{list(klen.shape)}")
        lead = (S, klen.shape[1])
    else:
        lead = (window_waves(kind, klen, None), S)
    W = window_waves(kind, klen, idx)
    if is_plane and kind.shape[0] != W:
        raise ValueError(f"kind must be int8[{W}, {S}], got {kind.dtype}{list(kind.shape)}")
    for name, x in (("klen", klen), ("vlen", vlen)):
        if x is None and name == "vlen":
            continue
        if x.dtype != I16 or tuple(x.shape) != lead:
            raise ValueError(f"{name} must be int16{list(lead)}, got {x.dtype}{list(x.shape)}")
    K4, VW4 = table.keyw.shape[2], table.valw.shape[2]
    for name, x, width in (("kwin", kwin, K4), ("vwin", vwin, VW4)):
        if x is None and name == "vwin":
            continue
        if x.dtype != I32 or x.dim() != 3 or tuple(x.shape[:2]) != lead or x.shape[2] > width:
            raise ValueError(f"{name} must be int32[{lead[0]}, {lead[1]}, <= {width}], got "
                             f"{x.dtype}{list(x.shape)}")
    if not 0 <= depth <= W:
        raise ValueError(f"depth {depth} outside 0..{W}")
    if not want_table and (is_plane or kind != KIND_GET):
        raise ValueError("a window without an output table reads: kind must be KIND_GET "
                         "(a read of every non-empty key)")
    if gidx is not None:
        if not (want_table and want_reads):
            raise ValueError("gathered reads (gidx) need want_table and want_reads")
        if gidx.dtype != I32 or gidx.dim() != 1:
            raise ValueError(f"gidx must be int32[G], got {gidx.dtype}{list(gidx.shape)}")
    tensors = [*table, klen, kwin] + [x for x in (kind, vlen, vwin, idx, gidx)
                                      if isinstance(x, torch.Tensor)]
    if any(x.device != used.device for x in tensors):
        raise ValueError("the table and the op planes lie on different devices")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("kv window kernel needs contiguous tables and op planes")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(
        *[None if x is None else x.data_ptr() for x in tensors]
    )


class KVWindowKernel:
    """ctypes wrapper of the kv kernels' C entries, each as a window and as
    the window with its decision in the same launch (:meth:`decide`):
    ``kvw_window`` / ``kvw_decide_window`` (csrc/kv_window.cu),
    ``kvd_window`` / ``kvd_decide_window`` (csrc/kv_dict.cu) and
    ``kvr_window`` / ``kvr_decide_window`` (csrc/kv_read.cu). Where a
    window goes is decided here, from its form alone:

    - a window without an output table (a read of every non-empty key) to
      ``kv_read.cu``;
    - a window that writes a table, with dictionary-form ops, a table of
      at most ``DICT_MAX_SLOTS`` slots and at most ``DICT_MAX_ROWS`` rows a
      shard (the packers' ``max_dict``), to ``kv_dict.cu``;
    - every other window that writes a table (the row form, and the
      dictionary form on wider tables or larger dictionaries) to
      ``kv_window.cu``.

    ``launches`` counts kernel launches of all six entries, and ``counts``
    the same launches by form: ``rows``, ``rows+decide`` (kv_window.cu),
    ``dict``, ``dict+decide`` (kv_dict.cu), ``dict wide``, ``dict
    wide+decide`` (kv_window.cu on the dictionary form), ``probe rows``,
    ``probe dict`` (the read kernel alone: ``lookup_only``) and ``lookup
    rows``, ``lookup dict`` (the read kernel with the decision: the GET
    window); each grows by one exactly where a kernel is launched. The
    libraries build on the first call. A caller that sets ``events`` to
    a list gets, for each launch, (form, start, end): CUDA events recorded
    on the launch's stream just before and after it."""

    FORMS = ("rows", "dict", "dict wide", "rows+decide", "dict+decide", "dict wide+decide",
             "probe rows", "probe dict", "lookup rows", "lookup dict")
    DICT_MAX_SLOTS = 64  # kv_dict.cu keeps a shard's slots in one 64-bit mask
    DICT_MAX_ROWS = 32  # and its rows' keys and tag tables in shared memory
    # The write kernels write their reads gathered (``gidx``; a window
    # without one gets every wave's, rows 0..W-1, as read planes). False
    # binds builds of kv_window.cu that write read planes instead, as
    # ``scripts/torch_kv_window_ab.py`` binds an earlier commit's.
    gathered_reads = True

    def __init__(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.FORMS, 0)
        self.events: list | None = None
        self._libs = []
        self._fn = None
        self._decide_fn = None
        self._dict_fn = None
        self._dict_decide_fn = None
        self._read_fn = None
        self._read_decide_fn = None
        self._scratch: dict[torch.device, torch.Tensor] = {}

    def reset_counts(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.FORMS, 0)

    @property
    def loaded(self) -> bool:
        return self._fn is not None

    def load(self):
        """Build (if needed) and bind the three libraries; returns the C
        function of the plain row-form window."""
        if self._fn is None:
            paths = cuda_build.build(["kv_window", "kv_dict", "kv_read"])
            vpp = ctypes.POINTER(ctypes.c_void_p)
            llp = ctypes.POINTER(ctypes.c_longlong)
            fns = []
            for name, prefix in (("kv_window", "kvw"), ("kv_dict", "kvd"), ("kv_read", "kvr")):
                lib = ctypes.CDLL(str(paths[name]))
                fn = getattr(lib, f"{prefix}_window")
                fn.argtypes = [vpp, vpp, vpp, vpp, llp, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                dfn = getattr(lib, f"{prefix}_decide_window")
                dfn.argtypes = [vpp, vpp, vpp, vpp, llp, vpp, llp, ctypes.c_void_p]
                dfn.restype = ctypes.c_int
                self._libs.append(lib)
                fns += [fn, dfn]
            (self._fn, self._decide_fn, self._dict_fn, self._dict_decide_fn,
             self._read_fn, self._read_decide_fn) = fns
        return self._fn

    def _route(self, idx, P: int, D: int, want_table: bool, decide: bool):
        """The C entry and the count key of a window (D: the dictionary's
        rows a shard)."""
        if not want_table:  # a read: the op values are not read
            return ((self._read_decide_fn if decide else self._read_fn),
                    ("lookup " if decide else "probe ") + ("rows" if idx is None else "dict"))
        if idx is None:
            entry, form = (self._decide_fn if decide else self._fn), "rows"
        elif P <= self.DICT_MAX_SLOTS and D <= self.DICT_MAX_ROWS:
            entry, form = (self._dict_decide_fn if decide else self._dict_fn), "dict"
        else:
            entry, form = (self._decide_fn if decide else self._fn), "dict wide"
        return entry, form + ("+decide" if decide else "")

    def _launch(self, table, kind, klen, vlen, kwin, vwin, depth, idx, want_table, want_reads,
                gidx, decide, extra=()):
        """Allocate the outputs and launch the window's entry (see
        :meth:`_route`) with the window's arguments followed by
        ``extra``."""
        dev = table.used.device
        S, P, K4 = table.keyw.shape
        VW4 = table.valw.shape[2]
        entry, form = self._route(idx, P, 0 if idx is None else klen.shape[1], want_table, decide)
        if not want_table:
            vlen = vwin = None
        W = window_waves(kind, klen, idx)
        out = KVTable(*(torch.empty_like(x) for x in table)) if want_table else None
        overflow = torch.empty(S, dtype=torch.bool, device=dev)
        reads, g = None, None
        rd = [overflow.view(torch.uint8), None, None, None, None, None]
        if want_reads and (not want_table or (gidx is None and not self.gathered_reads)):
            reads = WindowReads(
                torch.empty((W, S), dtype=torch.bool, device=dev),
                torch.empty((W, S), dtype=I32, device=dev),
                torch.empty((W, S), dtype=I32, device=dev),
                torch.empty((W, S, VW4), dtype=I32, device=dev),
            )
            rd[1:5] = [reads.found.view(torch.uint8), reads.ver, reads.vlen, reads.val]
        elif want_reads:  # gathered to gidx; every wave's reads are rows 0..W-1
            g = gidx if gidx is not None else torch.arange(W, dtype=I32, device=dev)
            reads = GatheredReads(torch.empty((2, g.shape[0], S), dtype=I32, device=dev),
                                  torch.empty((g.shape[0], S, VW4), dtype=I32, device=dev))
            rd[2:] = [reads.meta[0], reads.meta[1], reads.val, g]
        if S:
            tin = [table.used.view(torch.uint8), *table[1:]]
            tout = [None] * 7 if out is None else [out.used.view(torch.uint8), *out[1:]]
            plane = kind if isinstance(kind, torch.Tensor) else None
            kind_all = KIND_GET if plane is None and kind == KIND_GET else KIND_SET
            dims = (ctypes.c_longlong * 11)(
                S, W, depth, P, K4, VW4, kwin.shape[2], 0 if vwin is None else vwin.shape[2],
                0 if idx is None else klen.shape[1], kind_all,
                0 if g is None else g.shape[0],
            )
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream().cuda_stream
                marks = cuda_build.record_event(self.events)
                err = entry(_ptrs(tin), _ptrs(tout), _ptrs([plane, klen, vlen, kwin, vwin, idx]),
                            _ptrs(rd), dims, *extra, stream)
                if marks is not None:
                    self.events.append((form, marks, cuda_build.record_event(self.events)))
            if err != 0:
                raise RuntimeError(f"kv window kernel launch failed ({form}): cudaError {err}")
            self.launches += 1
            self.counts[form] += 1
        if g is not None and gidx is None:  # every wave's reads, as read planes
            meta, val = reads
            reads = WindowReads((meta[1] & 1).bool(), meta[0], meta[1] >> 1, val)
        return out, overflow, reads

    def __call__(
        self,
        table: KVTable,
        kind,
        klen: torch.Tensor,
        vlen: Optional[torch.Tensor],
        kwin: torch.Tensor,
        vwin: Optional[torch.Tensor],
        depth: int,
        *,
        idx: Optional[torch.Tensor] = None,
        want_table: bool = True,
        want_reads: bool = False,
        gidx: Optional[torch.Tensor] = None,
    ) -> tuple[Optional[KVTable], torch.Tensor, Optional[WindowReads]]:
        _check_args(table, kind, klen, vlen, kwin, vwin, depth, idx, want_table, want_reads,
                    gidx)
        dev = table.used.device
        if dev.type != "cuda":
            raise ValueError(f"kv window kernel needs CUDA tensors, got {dev}")
        self.load()
        return self._launch(table, kind, klen, vlen, kwin, vwin, depth, idx, want_table,
                            want_reads, gidx, False)

    def decide(
        self,
        table: KVTable,
        kind,
        klen: torch.Tensor,
        vlen: Optional[torch.Tensor],
        kwin: torch.Tensor,
        vwin: Optional[torch.Tensor],
        depth: int,
        alive: torch.Tensor,  # bool[S, R]
        base: torch.Tensor,  # i32[S]: wave t of shard s is slot base[s] + t
        *,
        seed: int,
        coin_p1: float,
        max_phases: int,
        idx: Optional[torch.Tensor] = None,
        want_table: bool = True,
        want_reads: bool = False,
        gidx: Optional[torch.Tensor] = None,
        shard0: int = 0,
    ) -> tuple[Optional[KVTable], torch.Tensor, Optional[WindowReads], torch.Tensor]:
        """The window with its decision, one launch. Returns ``(new table
        or None, overflow bool[S], reads or None, flags i32[3])``; the
        reads are :class:`GatheredReads` with ``gidx``. Shard ``s`` of the
        table is global shard ``shard0 + s`` for the coin (a shard block's
        offset over a mesh).

        The flags' scratch words are cached per device and left zero by
        every launch, so windows on one device must not run on two
        streams at once."""
        _check_args(table, kind, klen, vlen, kwin, vwin, depth, idx, want_table, want_reads,
                    gidx)
        S = table.used.shape[0]
        if alive.dtype != torch.bool or alive.dim() != 2 or alive.shape[0] != S:
            raise ValueError(f"alive must be bool[{S}, R], got {alive.dtype}{list(alive.shape)}")
        R = alive.shape[1]
        if not 1 <= R <= MAX_REPLICAS:
            raise ValueError(f"the window's decision takes 1..{MAX_REPLICAS} replicas, got R={R}")
        if base.dtype != I32 or tuple(base.shape) != (S,):
            raise ValueError(f"base must be int32[{S}], got {base.dtype}{list(base.shape)}")
        if max_phases < 0:
            raise ValueError(f"max_phases must be >= 0, got {max_phases}")
        if not 0 <= shard0 < 2**32:
            raise ValueError(f"shard0 must be a uint32, got {shard0}")
        if S == 0:
            raise ValueError("the window's decision needs at least one shard")
        dev = table.used.device
        if alive.device != dev or base.device != dev:
            raise ValueError("the table, alive and base lie on different devices")
        if not (alive.is_contiguous() and base.is_contiguous()):
            raise ValueError("kv window kernel needs contiguous alive and base")
        if dev.type != "cuda":
            raise ValueError(f"kv window kernel needs CUDA tensors, got {dev}")
        self.load()
        scratch = self._scratch.get(dev)
        if scratch is None:
            scratch = self._scratch[dev] = torch.zeros(2, dtype=I32, device=dev)
        flags = torch.empty(3, dtype=I32, device=dev)
        params = (ctypes.c_longlong * 7)(
            R, quorum_size(R), f_plus_1(R), max_phases, int(seed) & 0xFFFFFFFF,
            coin_threshold(coin_p1), shard0,
        )
        out, overflow, reads = self._launch(
            table, kind, klen, vlen, kwin, vwin, depth, idx, want_table, want_reads, gidx, True,
            (_ptrs([alive.view(torch.uint8), base, flags, scratch]), params),
        )
        return out, overflow, reads, flags


KV_WINDOW = KVWindowKernel()


def window(table: KVTable, kind, klen, vlen, kwin, vwin, depth: int, *,
           idx: Optional[torch.Tensor] = None, want_table: bool = True, want_reads: bool = False,
           gidx: Optional[torch.Tensor] = None):
    """The wave scan: the CUDA kernel for a CUDA table, the plain version
    for a CPU table."""
    dev = table.used.device
    kw = dict(idx=idx, want_table=want_table, want_reads=want_reads, gidx=gidx)
    if dev.type == "cuda":
        return KV_WINDOW(table, kind, klen, vlen, kwin, vwin, depth, **kw)
    if dev.type == "cpu":
        return kv_window_plain(table, kind, klen, vlen, kwin, vwin, depth, **kw)
    raise ValueError(f"no kv window for device {dev}")


def decide_window_plain(mesh, table: KVTable, kind, klen, vlen, kwin, vwin, depth: int,
                        alive: torch.Tensor, base: torch.Tensor, max_phases: int, *,
                        idx: Optional[torch.Tensor] = None, want_table: bool = True,
                        want_reads: bool = False, gidx: Optional[torch.Tensor] = None,
                        shard0: int = 0):
    """The device lane's window in plain PyTorch: every live replica of
    ``mesh`` (a ``MeshPhaseKernel``) votes V1 for the ``depth`` waves that
    carry ops, the plain mesh window decides them (shard ``s`` as global
    shard ``shard0 + s``), the plain wave scan applies the window, and the
    flags reduce both. Returns what :meth:`KVWindowKernel.decide` returns;
    the flags are ``i32[3] = [all_v1, overflow anywhere, a shard version
    at the wrap]``."""
    W, S = window_waves(kind, klen, idx), table.used.shape[0]
    votes = torch.zeros((W, S, alive.shape[1]), dtype=I8, device=klen.device)
    votes[:depth] = V1
    decided = mesh.decide_slots_plain(votes, alive, base, max_phases, shard0)
    all_v1 = (decided[:depth] == V1).all()
    new, overflow, reads = kv_window_plain(table, kind, klen, vlen, kwin, vwin, depth, idx=idx,
                                           want_reads=want_reads, gidx=gidx)
    flags = torch.stack([all_v1, overflow.any(), (new.sver >= VERSION_WRAP).any()]).to(I32)
    return (new if want_table else None), overflow, reads, flags


def decide_window(mesh, table: KVTable, kind, klen, vlen, kwin, vwin, depth: int,
                  alive: torch.Tensor, base: torch.Tensor, max_phases: int, *,
                  idx: Optional[torch.Tensor] = None, want_table: bool = True,
                  want_reads: bool = False, gidx: Optional[torch.Tensor] = None,
                  shard0: int = 0):
    """The device lane's window, decided and applied: one kernel launch
    for a CUDA table, the plain version for a CPU table. ``mesh`` (a
    ``MeshPhaseKernel``) gives the coin's seed and probability; ``shard0``
    is the table's first global shard (a shard block's offset)."""
    dev = table.used.device
    kw = dict(idx=idx, want_table=want_table, want_reads=want_reads, gidx=gidx, shard0=shard0)
    if dev.type == "cuda":
        return KV_WINDOW.decide(table, kind, klen, vlen, kwin, vwin, depth, alive, base,
                                seed=mesh.seed, coin_p1=mesh.coin_p1, max_phases=max_phases, **kw)
    if dev.type == "cpu":
        return decide_window_plain(mesh, table, kind, klen, vlen, kwin, vwin, depth, alive, base,
                                   max_phases, **kw)
    raise ValueError(f"no kv window for device {dev}")
