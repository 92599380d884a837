"""One node's weak-MVC kernel as a CUDA kernel (``csrc/node_kernel.cu``).

``NODE_CYCLE`` wraps ``nk_node_cycle``, which replaces the reference's
``NodeKernel.node_cycle``, ``node_step`` and ``start_slots``
(``rabia_tpu/kernel/phase_driver.py``): a whole engine tick (open the
masked slots, then K chained node steps) in one launch, one thread a
shard, on the per-shard math of ``csrc/node_kernel.cuh``. ``start_slots``
is the launch with K = 0, ``node_step`` the launch with no mask and
K = 1. The plain versions are ``NodeKernel.start_slots_plain``,
``node_step_plain`` and ``node_cycle_plain``
(:mod:`rabia_tpu_torch.kernel.phase_driver`), which dispatches on the
state's device alone.

:class:`TickLayout` places a node's state and K outbox planes in one
byte buffer (``NodeKernel`` keeps its newest), so a tick's results come
back to the host in one copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

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
            n += (int(np.prod(dims)) * _itemsize(dtype) + 15) // 16 * 16
        self.outbox = []
        for _, dtype in OUTBOX_FIELDS:
            self.outbox.append((n, dtype, (K, S)))
            n += (K * S * _itemsize(dtype) + 15) // 16 * 16
        self.nbytes = max(n, 16)

    @staticmethod
    def _views(buf, parts):
        out = []
        for off, dtype, dims in parts:
            size = int(np.prod(dims)) * _itemsize(dtype)
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


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


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
        self._fn = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.ENTRIES, 0)

    def load(self):
        """Build (if needed) and bind the library; returns the C function."""
        if self._fn is None:
            path = cuda_build.build(["node_kernel"])["node_kernel"]
            fn = ctypes.CDLL(str(path)).nk_node_cycle
            P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
            fn.argtypes = [P, P, P, P, P, P, P, P, P, LL, I, I, I, I, I, U, U, P]
            fn.restype = I
            self._fn = fn
        return self._fn

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

    def __call__(
        self,
        entry: str,
        fields: Sequence[torch.Tensor],  # a NodeState's 10 fields, in order
        out: Sequence[torch.Tensor],  # where the state goes (may be ``fields``)
        outbox: Optional[Sequence[torch.Tensor]],  # 7 planes [K, S], or None for K = 0
        mask: Optional[torch.Tensor],  # bool[S], or None: no slot opens
        slot_index: Optional[torch.Tensor],  # i32[S]
        init: Optional[torch.Tensor],  # i8[S]
        ib1: Optional[torch.Tensor],  # i8[S, R] the first step's inboxes
        ib2: Optional[torch.Tensor],  # i8[S, R]
        dec: Optional[torch.Tensor],  # i8[S]
        K: int,
        *,
        me: int,
        quorum: int,
        f1: int,
        seed: int,
        threshold: int,
    ) -> None:
        """One launch: open the masked slots, then K chained steps; the
        state from ``fields`` into ``out``, step k's outbox in row k of
        the planes. Votes are codes 0..3, stages 0 and 1."""
        if entry not in self.ENTRIES:
            raise ValueError(f"unknown entry {entry!r}")
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
            if ib1 is None or ib2 is None or dec is None:
                raise ValueError("K > 0 needs the inboxes and the decision plane")
        self._check(ib1, I8, (S, R), "inbox_r1", dev)
        self._check(ib2, I8, (S, R), "inbox_r2", dev)
        self._check(dec, I8, (S,), "decision_in", dev)
        if mask is not None:
            self._check(mask, BOOL, (S,), "shard_mask", dev)
            self._check(slot_index, I32, (S,), "slot_index", dev)
            self._check(init, I8, (S,), "initial_votes", dev)
            if slot_index is None or init is None:
                raise ValueError("a mask needs the slot indices and initial votes")
        if dev.type != "cuda":
            raise ValueError(f"the node kernel needs CUDA tensors, got {dev}")
        fn = self.load()
        if S == 0:
            return

        def ptr(t):
            return None if t is None else _u8_ptr(t)

        ins = (ctypes.c_void_p * 10)(*(_u8_ptr(t) for t in fields))
        outs = (ctypes.c_void_p * 10)(*(_u8_ptr(t) for t in out))
        obs = None if K == 0 else (ctypes.c_void_p * 7)(*(_u8_ptr(t) for t in outbox))
        with torch.cuda.device(dev):
            err = fn(ins, outs, obs, ptr(mask), ptr(slot_index), ptr(init), ptr(ib1), ptr(ib2),
                     ptr(dec), S, R, K, me, quorum, f1, int(seed) & 0xFFFFFFFF, threshold,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"node kernel ({entry}) launch failed: cudaError {err}")
        self.launches += 1
        self.counts[entry] += 1


NODE_CYCLE = NodeCycleKernel()
