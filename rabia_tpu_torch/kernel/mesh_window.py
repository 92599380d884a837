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
"""

from __future__ import annotations

import ctypes

import torch

from rabia_tpu_torch.core.types import f_plus_1, quorum_size
from rabia_tpu_torch.kernel import cuda_build
from rabia_tpu_torch.kernel.phase_driver import coin_threshold

I8 = torch.int8
I32 = torch.int32
MAX_REPLICAS = 64  # csrc/mesh_window.cuh: one bit per replica in a uint64_t


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
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            lib.mw_empty.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
            lib.mw_empty.restype = ctypes.c_int
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

    def __call__(
        self,
        votes: torch.Tensor,  # i8[T, S, R] initial R1 votes, contiguous, on CUDA
        alive: torch.Tensor,  # bool[S, R]
        base_slots: torch.Tensor,  # i32[S]: entry t of shard s is slot base_slots[s] + t
        *,
        seed: int,
        coin_p1: float,
        max_phases: int,
    ) -> torch.Tensor:
        if votes.dtype != I8 or votes.dim() != 3:
            raise ValueError(f"votes must be int8[T, S, R], got {votes.dtype}{list(votes.shape)}")
        T, S, R = votes.shape
        if not 1 <= R <= MAX_REPLICAS:
            raise ValueError(f"mesh window kernel takes 1..{MAX_REPLICAS} replicas, got R={R}")
        if alive.dtype != torch.bool or tuple(alive.shape) != (S, R):
            raise ValueError(f"alive must be bool[{S}, {R}], got {alive.dtype}{list(alive.shape)}")
        if base_slots.dtype != I32 or tuple(base_slots.shape) != (S,):
            raise ValueError(
                f"base_slots must be int32[{S}], got {base_slots.dtype}{list(base_slots.shape)}"
            )
        if max_phases < 0:
            raise ValueError(f"max_phases must be >= 0, got {max_phases}")
        if alive.device != votes.device or base_slots.device != votes.device:
            raise ValueError("votes, alive and base_slots lie on different devices")
        if not (votes.is_contiguous() and alive.is_contiguous() and base_slots.is_contiguous()):
            raise ValueError("mesh window kernel needs contiguous votes, alive and base_slots")
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
                    decided.data_ptr(), T, S, R, quorum_size(R), f_plus_1(R),
                    int(seed) & 0xFFFFFFFF, coin_threshold(coin_p1), int(max_phases), stream,
                )
                if marks is not None:
                    self.events.append((marks, cuda_build.record_event(self.events)))
            if err != 0:
                raise RuntimeError(f"mesh window kernel launch failed: cudaError {err}")
            self.launches += 1
        return decided


MESH_WINDOW = MeshWindowKernel()
