"""The scanned weak-MVC protocol as CUDA kernels.

``CLUSTER_ROUND`` wraps ``csrc/cluster_round.cu``, which replaces the
reference's ``ClusterKernel.round_step`` (``rabia_tpu/kernel/
phase_driver.py``) and the scans over it. Two entries, on the math of
``csrc/cluster_round.cuh``:

- :meth:`ClusterRoundKernel.rounds`: n rounds over the 13 fields of a
  ``ClusterState`` (in its field order), under full delivery, one
  delivery mask for every round, or a stack of n masks. For R <= 8 an
  8-lane segment a shard runs the round one lane a receiver, from masks
  staged in shared memory, and stops once the shard's live replicas have
  all decided; above 8, one thread a shard runs the per-shard round.
  ``ClusterKernel.round_step`` launches it with n = 1 and ``run_rounds``
  with the n masks it draws.
- :meth:`ClusterRoundKernel.slot_pipeline`: every (slot, shard) of a
  window of initial votes, ``rounds`` full-delivery rounds each, which
  collapse to a rule on the slot's V0, V1 and V? counts (derived in the
  header for every ``rounds``); a memory-bound kernel reads the
  ``[T, S, R]`` votes in place, 16 shards a thread for R <= 8, one
  (slot, shard) a thread above. ``slot_pipeline`` and
  ``slot_pipeline_wide`` launch it.
- :meth:`ClusterRoundKernel.start_slot`: ``ClusterKernel.start_slot``,
  the state's 13 fields to fresh ones, written 16 bytes a thread over
  each field's plane (any R); the 13 outputs are views of one
  allocation. :meth:`ClusterRoundKernel.start_slot_blocks` does the same
  for several shard blocks on one device in one launch (the kernel reads
  a table of the blocks' field pointers): ``ShardedClusterKernel``'s
  ``start_slot`` makes one such launch a device.

The plain versions are ``ClusterKernel.round_step_plain``,
``run_rounds_plain``, ``slot_pipeline_plain``,
``slot_pipeline_wide_plain`` and ``start_slot_plain``; ``ClusterKernel`` dispatches on the
tensors' device alone: a CUDA tensor goes to this kernel (or the wrapper
raises, for R > 64 too), a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from rabia_tpu_torch.kernel import cuda_build

I8 = torch.int8
I32 = torch.int32
MAX_REPLICAS = 64  # csrc/cluster_round.cuh: one bit per replica in a uint64_t

# ClusterState's fields, in order, with their dtypes and shapes ("S" per
# shard, "SR" per replica, "SRR" a ledger)
FIELDS = (
    ("slot", I32, "S"),
    ("phase", I32, "SR"),
    ("stage", I8, "SR"),
    ("my_r1", I8, "SR"),
    ("my_r2", I8, "SR"),
    ("prev_r1", I8, "SR"),
    ("prev_r2", I8, "SR"),
    ("led1", I8, "SRR"),
    ("led2", I8, "SRR"),
    ("decided", I8, "S"),
    ("decided_phase", I32, "S"),
    ("done", torch.bool, "SR"),
    ("active", torch.bool, "S"),
)


def _uint32(shard0: int) -> int:
    """A block's first global shard, checked to fit the kernels' uint32."""
    if not 0 <= shard0 < 2**32:
        raise ValueError(f"shard0 {shard0} is not a uint32")
    return int(shard0)


def _u8_ptr(t: torch.Tensor) -> int:
    return (t.view(torch.uint8) if t.dtype == torch.bool else t).data_ptr()


class StartSlotTable:
    """The argument table of ``cr_start_slot_blocks`` for ``nblk`` shard
    blocks of S shards and R replicas, built once per shape: the ctypes
    pointer arrays the C entry reads (a call writes its blocks' pointers
    into them), the fields' dtypes and shapes the blocks are checked
    against, and where the outputs lie in one buffer (each block's field
    16-byte aligned, with ClusterState's dtype and shape)."""

    def __init__(self, S: int, R: int, nblk: int) -> None:
        self.S, self.R, self.nblk = S, R, nblk
        dims = {"S": (S,), "SR": (S, R), "SRR": (S, R, R)}
        self.want = [(dtype, torch.Size(dims[kind])) for _, dtype, kind in FIELDS]
        # field by field, the blocks' copies of a field side by side, each
        # 16-byte aligned: a field's views of every block are one view and
        # one unbind
        self._views = []  # (dtype, shape, strides, offset), in elements of the dtype
        off = 0
        for dtype, shape in self.want:
            esize = 4 if dtype == I32 else 1
            per_block = -(-math.prod(shape) * esize // 16) * 16
            strides = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
            if nblk > 1:
                shape, strides = (nblk, *shape), (per_block // esize, *strides)
            self._views.append((dtype, shape, strides, off // esize))
            off += nblk * per_block
        self.nbytes = off
        P = ctypes.c_void_p
        self.ins = (P * (13 * nblk))()
        self.outs = (P * (13 * nblk))()
        self.masks = (P * nblk)()
        self.votes = (P * nblk)()
        self.launches = ctypes.c_int(0)

    def outputs(self, device) -> list:
        """Each block's 13 fresh output fields: views of one allocation."""
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=device)
        typed = {I32: buf.view(I32), I8: buf.view(I8), torch.bool: buf.view(torch.bool)}
        fields = [typed[dtype].as_strided(shape, strides, off)
                  for dtype, shape, strides, off in self._views]
        if self.nblk == 1:
            return [fields]
        return [list(b) for b in zip(*(f.unbind(0) for f in fields))]

    def check(self, fields: Sequence, device) -> None:
        """Raise unless ``fields`` are a ClusterState's 13 fields of this
        shape, contiguous, on ``device``."""
        if len(fields) != len(FIELDS):
            raise ValueError(f"a ClusterState has {len(FIELDS)} fields, got {len(fields)}")
        for t, (dtype, shape), (name, _, _) in zip(fields, self.want, FIELDS):
            if t.dtype != dtype or t.shape != shape:
                raise ValueError(
                    f"{name} must be {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}")
            if not t.is_contiguous() or t.device != device:
                raise ValueError(f"start_slot needs contiguous fields on one device ({name})")

    def fill(self, fields: Sequence, outs: Sequence, masks: Sequence, votes: Sequence) -> None:
        """Write the blocks' pointers into the table."""
        self.ins[:] = [t.data_ptr() for fs in fields for t in fs]
        self.outs[:] = [t.data_ptr() for fs in outs for t in fs]
        self.masks[:] = [m.data_ptr() for m in masks]
        self.votes[:] = [v.data_ptr() for v in votes]


class ClusterRoundKernel:
    """ctypes wrapper of ``cr_rounds`` and ``cr_slot_pipeline``
    (csrc/cluster_round.cu).

    ``launches`` counts kernel launches of both entries, and ``counts``
    the same launches by entry (``rounds``, ``slot_pipeline``,
    ``start_slot``); each grows
    by one exactly where the kernel is launched. The library builds on the
    first call."""

    ENTRIES = ("rounds", "slot_pipeline", "start_slot")

    def __init__(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.ENTRIES, 0)
        self._lib = None
        self._tables: dict = {}  # (S, R, nblk) -> StartSlotTable

    def reset_counts(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.ENTRIES, 0)

    def load(self, path=None):
        """Build (if needed) and bind the library, or bind the one built
        at ``path`` (another build of the same source); returns it."""
        if self._lib is None:
            path = path or cuda_build.build(["cluster_round"])["cluster_round"]
            lib = ctypes.CDLL(str(path))
            P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
            lib.cr_rounds.argtypes = [P, P, P, P, LL, I, LL, I, I, I, U, U, U, P]
            lib.cr_rounds.restype = I
            lib.cr_slot_pipeline.argtypes = [P, P, P, P, LL, LL, I, I, I, I, I, U, U, U, P]
            lib.cr_slot_pipeline.restype = I
            lib.cr_start_slot_blocks.argtypes = [I, P, P, P, P, LL, I, I, P, P]
            lib.cr_start_slot_blocks.restype = I
            self._lib = lib
        return self._lib

    @staticmethod
    def _check_replicas(R: int) -> None:
        if not 1 <= R <= MAX_REPLICAS:
            raise ValueError(f"cluster round kernel takes 1..{MAX_REPLICAS} replicas, got R={R}")

    @staticmethod
    def _check_cuda(*tensors: torch.Tensor) -> None:
        dev = tensors[0].device
        for t in tensors:
            if t.device != dev:
                raise ValueError("the kernel's tensors lie on different devices")
            if not t.is_contiguous():
                raise ValueError("cluster round kernel needs contiguous tensors")
        if dev.type != "cuda":
            raise ValueError(f"cluster round kernel needs CUDA tensors, got {dev}")

    def _launched(self, err: int, entry: str) -> None:
        if err != 0:
            raise RuntimeError(f"cluster round kernel ({entry}) launch failed: cudaError {err}")
        self.launches += 1
        self.counts[entry] += 1

    def rounds(
        self,
        fields: Sequence[torch.Tensor],  # a ClusterState's 13 fields, in order
        alive: torch.Tensor,  # bool[S, R]
        masks: Optional[torch.Tensor],  # None, bool[S, R, R] or bool[n, S, R, R]
        n: int,
        *,
        quorum: int,
        f1: int,
        seed: int,
        threshold: int,
        out: Optional[Sequence[torch.Tensor]] = None,
        shard0: int = 0,
    ) -> list[torch.Tensor]:
        """n rounds; returns the 13 fields after them, in ``out`` when
        given (``out`` may be ``fields``: the state is then updated in
        place), else in fresh tensors. ``masks`` None is full delivery, a
        3-d mask holds for every round, a 4-d one gives round k its k-th
        ``[shard, sender, receiver]`` mask. Shard s is global shard
        ``shard0 + s`` in the common coin."""
        fields = list(fields)
        S, R = self._check_fields(fields)
        self._check_replicas(R)
        if alive.dtype != torch.bool or tuple(alive.shape) != (S, R):
            raise ValueError(f"alive must be bool[{S}, {R}], got {alive.dtype}{list(alive.shape)}")
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        stride = 0
        if masks is not None:
            if masks.dtype != torch.bool or tuple(masks.shape[-3:]) != (S, R, R) or not (
                masks.dim() == 3 or (masks.dim() == 4 and masks.shape[0] == n)
            ):
                raise ValueError(
                    f"masks must be bool[{S}, {R}, {R}] or bool[{n}, {S}, {R}, {R}], got "
                    f"{masks.dtype}{list(masks.shape)}"
                )
            stride = S * R * R if masks.dim() == 4 else 0
        outs = [torch.empty_like(t) for t in fields] if out is None else list(out)
        if len(outs) != len(FIELDS) or any(
            o.dtype != t.dtype or o.shape != t.shape for o, t in zip(outs, fields)
        ):
            raise ValueError("out must match the state's fields")
        extra = [] if masks is None else [masks]
        self._check_cuda(*fields, *outs, alive, *extra)
        lib = self.load()
        if S:
            ins = (ctypes.c_void_p * 13)(*(_u8_ptr(t) for t in fields))
            outp = (ctypes.c_void_p * 13)(*(_u8_ptr(t) for t in outs))
            with torch.cuda.device(alive.device):
                err = lib.cr_rounds(
                    ins, outp, _u8_ptr(alive), None if masks is None else _u8_ptr(masks), stride,
                    n, S, R, quorum, f1, int(seed) & 0xFFFFFFFF, threshold, _uint32(shard0),
                    torch.cuda.current_stream().cuda_stream,
                )
            self._launched(err, "rounds")
        return outs

    @staticmethod
    def _check_fields(fields: Sequence[torch.Tensor]) -> tuple[int, int]:
        """(S, R) of a ClusterState's 13 fields; raises on a field of the
        wrong dtype or shape."""
        if len(fields) != len(FIELDS):
            raise ValueError(f"a ClusterState has {len(FIELDS)} fields, got {len(fields)}")
        S = fields[0].shape[0]
        R = fields[1].shape[1] if fields[1].dim() == 2 else -1
        dims = {"S": (S,), "SR": (S, R), "SRR": (S, R, R)}
        for t, (name, dtype, shape) in zip(fields, FIELDS):
            if t.dtype != dtype or tuple(t.shape) != dims[shape]:
                raise ValueError(
                    f"{name} must be {dtype}{list(dims[shape])}, got {t.dtype}{list(t.shape)}"
                )
        return S, R

    def start_slot(
        self,
        fields: Sequence[torch.Tensor],  # a ClusterState's 13 fields, in order
        mask: torch.Tensor,  # bool[S]
        votes: torch.Tensor,  # i8[S, R] initial round-1 votes
        *,
        out: Optional[Sequence[torch.Tensor]] = None,
    ) -> list[torch.Tensor]:
        """``ClusterKernel.start_slot`` in one launch: the 13 fields after
        it (any R >= 1), in ``out`` when given (``out`` may be ``fields``:
        the state is then updated in place), else in fresh views of one
        allocation."""
        return self.start_slot_blocks(
            [(fields, mask, votes)], out=None if out is None else [out])[0]

    def table(self, blocks: Sequence, out: Optional[Sequence] = None) -> tuple:
        """Check ``blocks`` (``(fields, mask, votes)`` of one S and R each,
        all on one device, contiguous) and fill their shape's
        :class:`StartSlotTable`; returns ``(table, outs)``, ``outs`` each
        block's 13 output fields (``out`` when given, else fresh views of
        one allocation)."""
        if not blocks:
            raise ValueError("start_slot takes at least one shard block")
        f0, mask0, _ = blocks[0]
        phase = f0[1] if len(f0) == len(FIELDS) else None
        if phase is None or phase.dim() != 2 or phase.shape[1] < 1:
            raise ValueError("start_slot takes a ClusterState's 13 fields, phase int32[S, R] "
                             "with R >= 1")
        S, R = phase.shape
        key = (S, R, len(blocks))
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = StartSlotTable(S, R, len(blocks))
        device = mask0.device
        fields = [f for f, _, _ in blocks]
        outs = table.outputs(device) if out is None else list(out)
        if len(outs) != len(blocks):
            raise ValueError(f"out must hold {len(blocks)} blocks' fields, got {len(outs)}")
        for f, mask, votes in blocks:
            table.check(f, device)
            if mask.dtype != torch.bool or mask.shape != (S,):
                raise ValueError(f"mask must be bool[{S}], got {mask.dtype}{list(mask.shape)}")
            if votes.dtype != I8 or votes.shape != (S, R):
                raise ValueError(
                    f"votes must be int8[{S}, {R}], got {votes.dtype}{list(votes.shape)}")
            if not (mask.is_contiguous() and votes.is_contiguous()) or (
                    mask.device != device or votes.device != device):
                raise ValueError("start_slot needs a contiguous mask and votes on one device")
        if out is not None:
            for o in outs:
                table.check(o, device)
        table.fill(fields, outs, [m for _, m, _ in blocks], [v for _, _, v in blocks])
        return table, outs

    def start_slot_blocks(self, blocks: Sequence, *, out: Optional[Sequence] = None,
                          empty: bool = False) -> list:
        """``ClusterKernel.start_slot`` on several shard blocks of one
        device, each ``(fields, mask, votes)`` as :meth:`start_slot` takes
        them: one launch for up to 16 blocks (the kernel's table), however
        their tensors lie. Returns each block's 13 fields after it.
        ``empty`` launches a kernel that does nothing on the same grid and
        table instead (its time is the launch's own; not counted)."""
        table, outs = self.table(blocks, out)
        device = blocks[0][1].device
        if device.type != "cuda":
            raise ValueError(f"cluster round kernel needs CUDA tensors, got {device}")
        lib = self.load()
        with torch.cuda.device(device):
            err = lib.cr_start_slot_blocks(
                table.nblk, table.ins, table.outs, table.masks, table.votes, table.S, table.R,
                int(empty), ctypes.byref(table.launches), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"cluster round kernel (start_slot) launch failed: cudaError {err}")
        if not empty:
            self.launches += table.launches.value
            self.counts["start_slot"] += table.launches.value
        return outs

    def slot_pipeline(
        self,
        votes: torch.Tensor,  # i8[T, S, R] initial round-1 votes
        alive: torch.Tensor,  # bool[S, R]
        *,
        base: int,
        rounds: int,
        quorum: int,
        f1: int,
        seed: int,
        threshold: int,
        shard0: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Every (slot, shard): a fresh slot ``base + t`` (int32, wrapped)
        with ``rounds`` full-delivery rounds. Returns ``(decided i8[T, S],
        decided_phase i32[T, S])``. Votes are codes 0..3; others are
        outside the contract, and the kernel need not match the plain
        loop on them. ``f1 <= quorum`` (as ``quorum_size`` and
        ``f_plus_1`` give), on which the kernel's rule rests. Shard s is
        global shard ``shard0 + s`` in the common coin."""
        if votes.dtype != I8 or votes.dim() != 3:
            raise ValueError(f"votes must be int8[T, S, R], got {votes.dtype}{list(votes.shape)}")
        T, S, R = votes.shape
        self._check_replicas(R)
        if alive.dtype != torch.bool or tuple(alive.shape) != (S, R):
            raise ValueError(f"alive must be bool[{S}, {R}], got {alive.dtype}{list(alive.shape)}")
        if rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {rounds}")
        if not -(2**31) <= base < 2**31:
            raise ValueError(f"base {base} is not an int32")
        if not 1 <= f1 <= quorum:
            raise ValueError(f"the slot pipeline needs 1 <= f1 <= quorum, got f1={f1} quorum={quorum}")
        self._check_cuda(votes, alive)
        lib = self.load()
        decided = torch.empty((T, S), dtype=I8, device=votes.device)
        dphase = torch.empty((T, S), dtype=I32, device=votes.device)
        if decided.numel():
            with torch.cuda.device(votes.device):
                err = lib.cr_slot_pipeline(
                    votes.data_ptr(), _u8_ptr(alive), decided.data_ptr(), dphase.data_ptr(), T, S,
                    R, base, rounds, quorum, f1, int(seed) & 0xFFFFFFFF, threshold,
                    _uint32(shard0), torch.cuda.current_stream().cuda_stream,
                )
            self._launched(err, "slot_pipeline")
        return decided, dphase


CLUSTER_ROUND = ClusterRoundKernel()
