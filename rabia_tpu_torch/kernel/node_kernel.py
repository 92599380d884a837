"""One node's weak-MVC kernel as a CUDA kernel (``csrc/node_kernel.cu``).

``NODE_CYCLE`` wraps ``nk_node_cycle``, which replaces the reference's
``NodeKernel.node_cycle``, ``node_step`` and ``start_slots``
(``rabia_tpu/kernel/phase_driver.py``): a whole engine tick (open the
masked slots, then K chained node steps) in one launch, on the per-shard
math of ``csrc/node_kernel.cuh``. ``start_slots`` is the launch with K =
0, ``node_step`` the launch with no mask and K = 1. The plain versions
are ``NodeKernel.start_slots_plain``, ``node_step_plain`` and
``node_cycle_plain`` (:mod:`rabia_tpu_torch.kernel.phase_driver`), which
dispatches on the state's device alone.

The node's state lies on the card in a tick buffer (:class:`TickLayout`:
the state's fields and K outbox planes). The tick's six input planes lie
in one pinned host buffer (:class:`PlaneLayout`) that the host writes,
and the launch writes the results the host reads (the mirrored state
fields, :data:`MIRROR_FIELDS`, and the outbox) into a pinned host image
in :class:`TickLayout`'s layout: the kernel reads and writes both in
place over the link, so a tick copies nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from rabia_tpu_torch.kernel import cuda_build

I8 = torch.int8
I32 = torch.int32
BOOL = torch.bool

# NodeState's fields, in order, with their dtypes and shapes ("S" per
# shard, "SR" a ledger row per shard)
STATE_FIELDS = (
    ("slot", I32, "S"),
    ("phase", I32, "S"),
    ("stage", I8, "S"),
    ("my_r1", I8, "S"),
    ("my_r2", I8, "S"),
    ("led1", I8, "SR"),
    ("led2", I8, "SR"),
    ("decided", I8, "S"),
    ("done", BOOL, "S"),
    ("active", BOOL, "S"),
)
# the state fields the host mirrors (all but the ledgers), in order: what
# the launch writes into the host image
MIRROR_FIELDS = tuple(f for f in STATE_FIELDS if f[2] == "S")
# NodeOutbox's planes, in order, each [K, S]
OUTBOX_FIELDS = (
    ("cast_r2", BOOL),
    ("r2_vals", I8),
    ("advanced", BOOL),
    ("new_r1", I8),
    ("new_phase", I32),
    ("newly_decided", BOOL),
    ("decided_vals", I8),
)
_NP = {I8: np.int8, I32: np.int32, BOOL: np.bool_}
_ITEMSIZE = {I8: 1, I32: 4, BOOL: 1}


def _u8_ptr(t: torch.Tensor) -> int:
    return (t.view(torch.uint8) if t.dtype == BOOL else t).data_ptr()


class TickLayout:
    """Byte offsets of a node's state (S shards, R replicas) and of K
    outbox planes in one buffer: the state's fields first, then the
    planes, each at a 16-byte boundary."""

    def __init__(self, S: int, R: int, K: int) -> None:
        self.S, self.R, self.K = S, R, K
        n = 0
        self.state = []
        for _, dtype, shape in STATE_FIELDS:
            dims = (S,) if shape == "S" else (S, R)
            self.state.append((n, dtype, dims))
            n += (math.prod(dims) * _ITEMSIZE[dtype] + 15) // 16 * 16
        self.outbox = []
        for _, dtype in OUTBOX_FIELDS:
            self.outbox.append((n, dtype, (K, S)))
            n += (K * S * _ITEMSIZE[dtype] + 15) // 16 * 16
        self.nbytes = max(n, 16)

    @staticmethod
    def _views(buf, parts):
        out = []
        for off, dtype, dims in parts:
            size = math.prod(dims) * _ITEMSIZE[dtype]
            if isinstance(buf, np.ndarray):
                out.append(buf[off:off + size].view(_NP[dtype]).reshape(dims))
            else:
                out.append(buf[off:off + size].view(dtype).view(dims))
        return out

    def state_views(self, buf) -> list:
        """The state's fields as views of ``buf`` (a uint8 tensor or
        numpy array of at least ``nbytes``)."""
        return self._views(buf, self.state)

    def outbox_views(self, buf, K: Optional[int] = None) -> list:
        """The outbox planes as views of ``buf``, their first ``K`` steps
        (default all)."""
        planes = self._views(buf, self.outbox)
        return planes if K is None or K == self.K else [p[:K] for p in planes]

    def owns(self, buf: torch.Tensor, fields: Sequence[torch.Tensor]) -> bool:
        """True when ``fields`` are exactly this layout's state views of
        ``buf``."""
        base = buf.data_ptr()
        return len(fields) == len(self.state) and all(
            t.data_ptr() == base + off and t.dtype == dtype and tuple(t.shape) == dims
            for t, (off, dtype, dims) in zip(fields, self.state)
        )


# a tick's input planes, in the order the kernel takes them ("S" per
# shard, "SR" a ledger row per shard), and where each lies in a
# PlaneLayout buffer (the inboxes and the decision plane first)
PLANE_FIELDS = (
    ("shard_mask", BOOL, "S"),
    ("slot_index", I32, "S"),
    ("initial_votes", I8, "S"),
    ("inbox_r1", I8, "SR"),
    ("inbox_r2", I8, "SR"),
    ("decision_in", I8, "S"),
)
_PLANE_ORDER = (3, 4, 5, 0, 1, 2)


class PlaneLayout:
    """Byte offsets of a tick's six input planes (S shards, R replicas)
    in one buffer: inbox_r1 and inbox_r2 i8[S, R], decision_in i8[S],
    shard_mask bool[S], slot_index i32[S] and initial_votes i8[S], each at
    a 64-byte boundary (the kernel reads each plane as 16-byte chunks, the
    last of which may run into the padding). ``offsets`` follow
    :data:`PLANE_FIELDS`' order."""

    def __init__(self, S: int, R: int) -> None:
        self.S, self.R = S, R
        self.offsets = [0] * len(PLANE_FIELDS)
        n = 0
        for i in _PLANE_ORDER:
            self.offsets[i] = n
            n += (self.size(i) + 63) // 64 * 64
        self.nbytes = max(n, 64)

    def shape(self, i: int) -> tuple:
        return (self.S,) if PLANE_FIELDS[i][2] == "S" else (self.S, self.R)

    def size(self, i: int) -> int:
        return math.prod(self.shape(i)) * _ITEMSIZE[PLANE_FIELDS[i][1]]

    def views(self, buf) -> list:
        """The planes as views of ``buf`` (a uint8 tensor or numpy array
        of at least ``nbytes``), in :data:`PLANE_FIELDS`' order."""
        return TickLayout._views(buf, [(self.offsets[i], PLANE_FIELDS[i][1], self.shape(i))
                                       for i in range(len(PLANE_FIELDS))])


class Prepared(NamedTuple):
    """A checked launch of the node kernel, bound to its buffers: the C
    arguments but the stream, the card, and the bytes it moves over the
    link. Launching it again runs the same tick on the same buffers."""

    args: tuple
    device: torch.device
    nbytes: int


class NodeCycleKernel:
    """ctypes wrapper of ``nk_node_cycle`` (csrc/node_kernel.cu).

    ``counts`` holds the launches by entry (``node_cycle``,
    ``node_step``, ``start_slots``) and ``launches`` their sum; each grows
    by one exactly where the kernel is launched. The library builds on
    the first call."""

    ENTRIES = ("node_cycle", "node_step", "start_slots")

    def __init__(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.ENTRIES, 0)
        self._lib = None
        self._fn = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.ENTRIES, 0)

    def load(self):
        """Build (if needed) and bind the library; returns the C function."""
        if self._fn is None:
            path = cuda_build.build(["node_kernel"])["node_kernel"]
            lib = ctypes.CDLL(str(path))
            fn = lib.nk_node_cycle
            P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
            fn.argtypes = [P, P, P, P, P, P, P, I, LL, I, I, I, I, I, U, U, P]
            fn.restype = I
            lib.nk_empty.argtypes = [LL, I, I, P]
            lib.nk_empty.restype = I
            self._lib, self._fn = lib, fn
        return self._fn

    def empty(self, S: int, R: int, K: int, device) -> None:
        """Launch an empty kernel at the grid and shared memory the tick
        takes for S x R x K: the floor of a launch of its own, for timing
        beside the tick. Not counted in ``launches``."""
        self.load()
        with torch.cuda.device(device):
            err = self._lib.nk_empty(S, R, K, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {err}")

    @staticmethod
    def _check(t: Optional[torch.Tensor], dtype, dims: tuple, what: str, device) -> None:
        if t is None:
            return
        if t.dtype != dtype or tuple(t.shape) != dims:
            raise ValueError(f"{what} must be {dtype}{list(dims)}, got {t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.device != device:
            raise ValueError(f"{what} lies on {t.device}, the state on {device}")

    @staticmethod
    def _check_pinned(buf: torch.Tensor, nbytes: int, what: str) -> None:
        if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.device.type != "cpu":
            raise ValueError(f"{what} must be a uint8 host buffer, got {buf.dtype} on {buf.device}")
        if not buf.is_pinned():
            raise ValueError(f"{what} must be pinned host memory (the kernel maps it)")
        if buf.numel() < nbytes:
            raise ValueError(f"{what} holds {buf.numel()} bytes, its layout {nbytes}")

    def __call__(self, entry: str, *args, **kw) -> int:
        """:meth:`prepare`, then :meth:`launch`: one launch. Returns the
        bytes it moves over the link."""
        if entry not in self.ENTRIES:
            raise ValueError(f"unknown entry {entry!r}")
        return self.launch(entry, self.prepare(*args, **kw))

    def prepare(
        self,
        fields: Sequence[torch.Tensor],  # a NodeState's 10 fields on the card, in order
        out: Sequence[torch.Tensor],  # where the state goes (may be ``fields``)
        outbox: Optional[Sequence[torch.Tensor]],  # 7 planes [K, S] on the card, or None for K = 0
        planes: Optional[torch.Tensor],  # pinned uint8 host buffer in ``plane_layout``
        plane_layout: Optional[PlaneLayout],
        present: Sequence[bool],  # which of PLANE_FIELDS the tick has
        image: torch.Tensor,  # pinned uint8 host buffer in ``image_layout``
        image_layout: TickLayout,
        K: int,
        *,
        me: int,
        quorum: int,
        f1: int,
        seed: int,
        threshold: int,
    ) -> Prepared:
        """Check and bind one launch: open the masked slots, then K
        chained steps; the state from ``fields`` into ``out``, step k's
        outbox in row k of the planes, and the mirrored fields and outbox
        rows into the image. The kernel reads the present planes from
        ``planes`` and writes ``image`` in place, through their device
        addresses (the launch raises when they cannot be mapped). Votes
        are codes 0..3, stages 0 and 1. The buffers must stay alive while
        the launch may be issued."""
        S = fields[0].shape[0]
        R = fields[5].shape[1] if fields[5].dim() == 2 else 0
        if R < 1:
            raise ValueError(f"the node kernel takes R >= 1, got led1 {list(fields[5].shape)}")
        if K < 0:
            raise ValueError(f"K must be >= 0, got {K}")
        dev = fields[0].device
        dims = {"S": (S,), "SR": (S, R)}
        for group, what in ((fields, "state"), (out, "out")):
            if len(group) != len(STATE_FIELDS):
                raise ValueError(f"{what} must hold {len(STATE_FIELDS)} fields")
            for t, (name, dtype, shape) in zip(group, STATE_FIELDS):
                self._check(t, dtype, dims[shape], f"{what}.{name}", dev)
        if K > 0:
            if outbox is None or len(outbox) != len(OUTBOX_FIELDS):
                raise ValueError(f"K={K} needs the {len(OUTBOX_FIELDS)} outbox planes")
            for t, (name, dtype) in zip(outbox, OUTBOX_FIELDS):
                self._check(t, dtype, (K, S), f"outbox.{name}", dev)
        if dev.type != "cuda":
            raise ValueError(f"the node kernel needs CUDA tensors, got {dev}")
        present = [bool(x) for x in present]
        if len(present) != len(PLANE_FIELDS):
            raise ValueError(f"present must name the {len(PLANE_FIELDS)} planes")
        if K > 0 and not all(present[3:]):
            raise ValueError("K > 0 needs the inboxes and the decision plane")
        if present[0] and not (present[1] and present[2]):
            raise ValueError("a mask needs the slot indices and initial votes")
        if any(present):
            if planes is None or plane_layout is None:
                raise ValueError("the tick's planes need their buffer and layout")
            if (plane_layout.S, plane_layout.R) != (S, R):
                raise ValueError(f"the plane layout is for S={plane_layout.S} R={plane_layout.R}")
            self._check_pinned(planes, plane_layout.nbytes, "the plane buffer")
        if (image_layout.S, image_layout.R) != (S, R) or image_layout.K < K:
            raise ValueError(f"the image layout (S={image_layout.S} R={image_layout.R} "
                             f"K={image_layout.K}) does not take S={S} R={R} K={K}")
        self._check_pinned(image, image_layout.nbytes, "the image")
        ins = (ctypes.c_void_p * 10)(*(_u8_ptr(t) for t in fields))
        outs = (ctypes.c_void_p * 10)(*(_u8_ptr(t) for t in out))
        obs = None if K == 0 else (ctypes.c_void_p * 7)(*(_u8_ptr(t) for t in outbox))
        offs = [plane_layout.offsets[i] if p else -1 for i, p in enumerate(present)]
        mirror = [off for (off, _, _), (_, _, shape) in zip(image_layout.state, STATE_FIELDS)
                  if shape == "S"]
        img_offs = mirror + [off for off, _, _ in image_layout.outbox]
        read = sum(plane_layout.size(i) for i, p in enumerate(present) if p)
        written = S * sum(_ITEMSIZE[dt] for _, dt, _ in MIRROR_FIELDS)
        written += K * S * sum(_ITEMSIZE[dt] for _, dt in OUTBOX_FIELDS)
        args = (ins, outs, obs, None if planes is None else planes.data_ptr(),
                (ctypes.c_longlong * 6)(*offs), image.data_ptr(),
                (ctypes.c_longlong * 15)(*img_offs), image_layout.K, S, R, K, me, quorum, f1,
                int(seed) & 0xFFFFFFFF, threshold)
        return Prepared(args, dev, 0 if S == 0 else read + written)

    def launch(self, entry: str, prepared: Prepared) -> int:
        """Issue a prepared launch on its card's current stream; returns
        the bytes it moves over the link. ``entry`` names the launch in
        ``counts``."""
        if entry not in self.ENTRIES:
            raise ValueError(f"unknown entry {entry!r}")
        fn = self.load()
        if prepared.nbytes == 0:  # no shards
            return 0
        index, _, stream = cuda_build.current_stream(prepared.device)
        with cuda_build.on_device(index):
            err = fn(*prepared.args, stream)
        if err != 0:
            raise RuntimeError(f"node kernel ({entry}) launch failed: cudaError {err} (a plane "
                               f"buffer or image that cannot be mapped raises here)")
        self.launches += 1
        self.counts[entry] += 1
        return prepared.nbytes


NODE_CYCLE = NodeCycleKernel()
