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
  one thread a shard (any R), the state's 13 fields to fresh ones.

The plain versions are ``ClusterKernel.round_step_plain``,
``run_rounds_plain``, ``slot_pipeline_plain``,
``slot_pipeline_wide_plain`` and ``start_slot_plain``; ``ClusterKernel`` dispatches on the
tensors' device alone: a CUDA tensor goes to this kernel (or the wrapper
raises, for R > 64 too), a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes
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
            lib.cr_start_slot.argtypes = [P, P, P, P, LL, I, P]
            lib.cr_start_slot.restype = I
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
    ) -> list[torch.Tensor]:
        """``ClusterKernel.start_slot`` in one launch: the 13 fields after
        it, in fresh tensors (any R >= 1)."""
        fields = list(fields)
        S, R = self._check_fields(fields)
        if R < 1:
            raise ValueError(f"start_slot takes R >= 1, got R={R}")
        if mask.dtype != torch.bool or tuple(mask.shape) != (S,):
            raise ValueError(f"mask must be bool[{S}], got {mask.dtype}{list(mask.shape)}")
        if votes.dtype != I8 or tuple(votes.shape) != (S, R):
            raise ValueError(f"votes must be int8[{S}, {R}], got {votes.dtype}{list(votes.shape)}")
        outs = [torch.empty_like(t) for t in fields]
        self._check_cuda(*fields, *outs, mask, votes)
        lib = self.load()
        if S:
            ins = (ctypes.c_void_p * 13)(*(_u8_ptr(t) for t in fields))
            outp = (ctypes.c_void_p * 13)(*(_u8_ptr(t) for t in outs))
            with torch.cuda.device(mask.device):
                err = lib.cr_start_slot(ins, outp, _u8_ptr(mask), votes.data_ptr(), S, R,
                                        torch.cuda.current_stream().cuda_stream)
            self._launched(err, "start_slot")
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
