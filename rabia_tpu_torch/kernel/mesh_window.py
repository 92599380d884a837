"""The lockstep replica-parallel window as one CUDA kernel.

``MESH_WINDOW`` wraps ``csrc/mesh_window.cu``, which replaces the
reference's ``MeshPhaseKernel.slot_window`` and ``slot_pipeline``
(``rabia_tpu/parallel/mesh.py``): for each window entry t and shard s it
runs ``max_phases`` lockstep weak-MVC phases over the R replicas and
returns the decision (``decided i8[T, S]``, ABSENT where none). The plain
version is :meth:`rabia_tpu_torch.parallel.mesh.MeshPhaseKernel.
decide_slots_plain`, the loop over ``phase_step``;
``MeshPhaseKernel._decide_slots`` dispatches on the tensor's device: a
CUDA tensor goes to this kernel (or the wrapper raises), a CPU tensor to
the plain loop.

Over a mesh, ``MeshPhaseKernel`` gathers a shard block's window votes and
alive rows over the replica axis and launches the kernel once a shard
block on what the gather left: votes ``[B, T, S_blk, R/B]`` and alive
``[B, S_blk, R/B]``, each replica block at its own stride, with
``shard0`` the block's first global shard (the coin's shard coordinate).

A one-device engine's window lies in a :class:`WindowStage`: one host
buffer holding its votes, alive rows, base slots and decisions, pinned on
a card, where :meth:`MeshWindowKernel.mapped` launches the same kernel on
the buffer's device addresses: the window is read and its decisions
written in place over the link, with no copy. The mapped path is taken
only for a stage that its caller hands over; a tensor is never mapped.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rabia_tpu_torch.core.types import f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cuda_build
from rabia_tpu_torch.kernel.phase_driver import coin_threshold

I8 = torch.int8
I32 = torch.int32
MAX_REPLICAS = 64  # csrc/mesh_window.cuh: one bit per replica in a uint64_t


class WindowStage:
    """One window's host buffer: alive rows ``u8[S, R]`` (viewed as bool),
    base slots ``i32[S]``, votes ``i8[W, S, R]`` and decisions ``i8[W,
    S]``, each at a 64-byte boundary, for windows of up to ``W`` entries.
    Pinned memory when ``pinned`` (a card's engine), which the kernel maps;
    plain host memory otherwise (the CPU's plain loop reads views of it).
    ``event`` marks the end of the newest launch on the buffer (None:
    nothing in flight); the buffer may be rewritten only once it has
    completed."""

    def __init__(self, S: int, R: int, W: int, pinned: bool) -> None:
        self.S, self.R, self.W = S, R, W
        parts = ((np.bool_, (S, R)), (np.int32, (S,)), (np.int8, (W, S, R)), (np.int8, (W, S)))
        offs, n = [], 0
        for dt, shape in parts:
            offs.append(n)
            n += (int(np.prod(shape)) * np.dtype(dt).itemsize + 63) // 64 * 64
        self.offsets = offs
        self.buffer = torch.empty(max(n, 64), dtype=torch.uint8, pin_memory=pinned)
        host = self.buffer.numpy()
        self.alive, self.base, self.votes, self.decided = (
            host[o:o + int(np.prod(shape)) * np.dtype(dt).itemsize].view(dt).reshape(shape)
            for (dt, shape), o in zip(parts, offs))
        self.event = None
        self.device_address = None  # the buffer's on the card, once mapped
        self.votes_key = None  # what the votes hold, for a writer that skips a rewrite

    def wait(self) -> None:
        """Block until the newest launch on the buffer has completed."""
        if self.event is not None:
            self.event.synchronize()

    def nbytes(self, T: int) -> int:
        """The bytes a T-entry window reads and writes: the votes, alive
        rows and bases once each, and the decisions."""
        S, R = self.S, self.R
        return T * S * R + S * R + 4 * S + T * S


class MeshWindowKernel:
    """ctypes wrapper of ``mw_window`` (csrc/mesh_window.cu).

    ``launches`` counts kernel launches; it grows by one exactly where
    the kernel is launched. The library builds on the first call. A caller
    that sets ``events`` to a list gets, for each launch, (start, end):
    CUDA events recorded on the launch's stream just before and after it."""

    def __init__(self) -> None:
        self.launches = 0
        self.events: list | None = None
        self._lib = None
        self._fn = None

    def load(self):
        """Build (if needed) and bind the library; returns the C function."""
        if self._fn is None:
            path = cuda_build.build(["mesh_window"])["mesh_window"]
            lib = ctypes.CDLL(str(path))
            fn = lib.mw_window
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            lib.mw_empty.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
            lib.mw_empty.restype = ctypes.c_int
            lib.mw_device_pointer.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
            lib.mw_device_pointer.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def empty(self, T: int, S: int, device) -> None:
        """Launch an empty kernel at the grid the window takes for T x S:
        the floor of a launch of its own, for timing beside the window.
        Not counted in ``launches``."""
        self.load()
        with torch.cuda.device(device):
            err = self._lib.mw_empty(T, S, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {err}")

    @staticmethod
    def blocks_of(votes: torch.Tensor, alive: torch.Tensor) -> tuple[int, int, int, int, int, int]:
        """``(B, T, S, Rb, vstride, astride)`` of votes ``i8[T, S, R]`` and
        alive ``bool[S, R]`` (B = 1), or of votes ``i8[B, T, S, Rb]`` and
        alive ``bool[B, S, Rb]`` whose replica blocks lie at any stride
        and whose rows are contiguous within a block; raises on anything
        else."""
        if votes.dtype != I8 or votes.dim() not in (3, 4):
            raise ValueError(
                f"votes must be int8[T, S, R] or int8[B, T, S, Rb], got "
                f"{votes.dtype}{list(votes.shape)}")
        blocked = votes.dim() == 4
        B, T, S, Rb = votes.shape if blocked else (1, *votes.shape)
        want = (B, S, Rb) if blocked else (S, Rb)
        if alive.dtype != torch.bool or tuple(alive.shape) != want:
            raise ValueError(f"alive must be bool{list(want)}, got {alive.dtype}{list(alive.shape)}")
        if not 1 <= B * Rb <= MAX_REPLICAS:
            raise ValueError(f"mesh window kernel takes 1..{MAX_REPLICAS} replicas, got R={B * Rb}")
        if blocked and not (votes[0].is_contiguous() and alive[0].is_contiguous()):
            raise ValueError("mesh window kernel needs each replica block contiguous")
        if not blocked and not (votes.is_contiguous() and alive.is_contiguous()):
            raise ValueError("mesh window kernel needs contiguous votes and alive")
        vstride = votes.stride(0) if blocked and B > 1 else 0
        astride = alive.stride(0) if blocked and B > 1 else 0
        return B, T, S, Rb, vstride, astride

    def __call__(
        self,
        votes: torch.Tensor,  # i8[T, S, R], or i8[B, T, S, R/B] in replica blocks, on CUDA
        alive: torch.Tensor,  # bool[S, R], or bool[B, S, R/B]
        base_slots: torch.Tensor,  # i32[S]: entry t of shard s is slot base_slots[s] + t
        *,
        seed: int,
        coin_p1: float,
        max_phases: int,
        shard0: int = 0,  # global index of the first shard (the coin's shard coordinate)
    ) -> torch.Tensor:
        B, T, S, Rb, vstride, astride = self.blocks_of(votes, alive)
        R = B * Rb
        if base_slots.dtype != I32 or tuple(base_slots.shape) != (S,):
            raise ValueError(
                f"base_slots must be int32[{S}], got {base_slots.dtype}{list(base_slots.shape)}"
            )
        if max_phases < 0:
            raise ValueError(f"max_phases must be >= 0, got {max_phases}")
        if not 0 <= shard0 < 2**32:
            raise ValueError(f"shard0 {shard0} is not a uint32")
        if alive.device != votes.device or base_slots.device != votes.device:
            raise ValueError("votes, alive and base_slots lie on different devices")
        if not base_slots.is_contiguous():
            raise ValueError("mesh window kernel needs contiguous base_slots")
        if votes.device.type != "cuda":
            raise ValueError(f"mesh window kernel needs CUDA tensors, got {votes.device}")
        fn = self.load()
        decided = torch.empty((T, S), dtype=I8, device=votes.device)
        if decided.numel():
            with torch.cuda.device(votes.device):
                stream = torch.cuda.current_stream().cuda_stream
                marks = cuda_build.record_event(self.events)
                err = fn(
                    votes.data_ptr(), alive.view(torch.uint8).data_ptr(), base_slots.data_ptr(),
                    decided.data_ptr(), T, S, B, Rb, vstride, astride, int(shard0),
                    quorum_size(R), f_plus_1(R), int(seed) & 0xFFFFFFFF,
                    coin_threshold(coin_p1), int(max_phases), stream,
                )
                if marks is not None:
                    self.events.append((marks, cuda_build.record_event(self.events)))
            if err != 0:
                raise RuntimeError(f"mesh window kernel launch failed: cudaError {err}")
            self.launches += 1
        return decided


    def mapped(self, stage: WindowStage, T: int, device, *, seed: int, coin_p1: float,
               max_phases: int) -> None:
        """One window of T entries on ``stage`` (pinned), one launch on
        ``device``'s current stream: the kernel reads the stage's votes,
        alive rows and bases and writes its decisions there, through the
        buffer's device address, and ``stage.event`` marks the launch's
        end (read ``stage.decided[:T]`` once it has completed). Raises
        when the buffer cannot be mapped; nothing is copied."""
        if not 0 <= T <= stage.W:
            raise ValueError(f"a window of {T} entries does not fit a stage of {stage.W}")
        if not 1 <= stage.R <= MAX_REPLICAS:
            raise ValueError(f"mesh window kernel takes 1..{MAX_REPLICAS} replicas, got R={stage.R}")
        if max_phases < 0:
            raise ValueError(f"max_phases must be >= 0, got {max_phases}")
        if not stage.buffer.is_pinned():
            raise ValueError("a mapped window needs a pinned stage")
        fn = self.load()
        if stage.device_address is None:
            dev = ctypes.c_void_p()
            with torch.cuda.device(torch.device(device)):
                err = self._lib.mw_device_pointer(stage.buffer.data_ptr(), ctypes.byref(dev))
            if err != 0:
                raise RuntimeError(f"the window's stage cannot be mapped: cudaError {err}")
            stage.device_address = dev.value
        a_off, b_off, v_off, d_off = (stage.device_address + o for o in stage.offsets)
        S, R = stage.S, stage.R
        index, stream, raw = cuda_build.current_stream(torch.device(device))
        with cuda_build.on_device(index):
            if T and S:
                marks = cuda_build.record_event(self.events)
                err = fn(v_off, a_off, b_off, d_off, T, S, 1, R, 0, 0, 0, quorum_size(R),
                         f_plus_1(R), int(seed) & 0xFFFFFFFF, coin_threshold(coin_p1),
                         int(max_phases), raw)
                if marks is not None:
                    self.events.append((marks, cuda_build.record_event(self.events)))
                if err != 0:
                    raise RuntimeError(f"mesh window kernel launch failed: cudaError {err}")
                self.launches += 1
            if stage.event is None:
                stage.event = torch.cuda.Event()
            stage.event.record(stream)


MESH_WINDOW = MeshWindowKernel()
