"""The fault-free slot window: closed-form quorum tally.

Under full delivery, fresh per-slot state and two rounds per slot, the
scanned weak-MVC pipeline (:meth:`ClusterKernel.slot_pipeline`) collapses
to a closed form (derivation in the reference's
``rabia_tpu/kernel/fused_window.py``)::

    decided[t, s] = V1      if c1 >= Q
                    V0      elif c0 >= Q
                    ABSENT  else

with ``c1``/``c0`` the V1/V0 votes of alive replicas, and the phase 0
where decided, -1 where not.

This module holds the plain PyTorch versions (``closed_form_window``,
``closed_form_window_rmajor``) and the wrappers of the two hand-written
CUDA kernels of ``csrc/fused_window.cu``: ``FUSED_WINDOW`` on
replica-major votes replaces the TPU kernel ``pallas_window_rmajor``,
``FUSED_WINDOW_TSR`` on ``[T, S, R]`` votes (read in place, no relayout)
replaces ``pallas_window``. ``window`` and ``window_rmajor`` dispatch on
the tensor's device alone: a CUDA tensor goes to its kernel (or the
wrapper raises), a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from rabia_tpu_torch.core.tracing import span
from rabia_tpu_torch.core.types import ABSENT, V0, V1
from rabia_tpu_torch.kernel import cuda_build

I8 = torch.int8
I32 = torch.int32
MAX_REPLICAS = 8  # csrc/fused_window.cuh: per-byte counters stay < 0x80
MAX_QUORUM = 128


def _decide(c0: torch.Tensor, c1: torch.Tensor, quorum: int) -> torch.Tensor:
    dec = torch.full(c0.shape, ABSENT, dtype=I8, device=c0.device)
    dec.masked_fill_(c0 >= quorum, V0)
    return dec.masked_fill_(c1 >= quorum, V1)  # V1 wins where both reach Q


def _phase(dec: torch.Tensor) -> torch.Tensor:
    return (dec == ABSENT).to(I32).neg_()  # 0 where decided, -1 where not


def closed_form_window(
    votes: torch.Tensor,  # i8[T, S, R]
    alive: torch.Tensor,  # bool[S, R]
    quorum: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The closed form on the API layout, plain PyTorch."""
    live = alive[None, :, :]
    c1 = ((votes == V1) & live).sum(-1, dtype=I32)
    c0 = ((votes == V0) & live).sum(-1, dtype=I32)
    dec = _decide(c0, c1, quorum)
    return dec, _phase(dec)


def closed_form_window_rmajor(
    votes_rm: torch.Tensor,  # i8[R, T, S] — replica-major planes
    alive_rm: torch.Tensor,  # bool[R, S]
    quorum: int,
    want_phase: bool = True,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """The closed form on replica-major votes, plain PyTorch.
    ``want_phase=False`` returns only the decision plane."""
    R, T, S = votes_rm.shape
    c1 = torch.zeros((T, S), dtype=I32, device=votes_rm.device)
    c0 = torch.zeros((T, S), dtype=I32, device=votes_rm.device)
    for r in range(R):
        a = alive_rm[r][None, :]
        c1 += (votes_rm[r] == V1) & a
        c0 += (votes_rm[r] == V0) & a
    dec = _decide(c0, c1, quorum)
    if not want_phase:
        return dec
    return dec, _phase(dec)


class FusedWindowKernel:
    """ctypes wrapper of ``rw_fused_window`` (csrc/fused_window.cu), the
    replica-major kernel.

    ``launches`` counts kernel launches; it grows by one exactly where
    the kernel is launched. The library builds on the first call."""

    symbol = "rw_fused_window"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        """Build (if needed) and bind the library; returns the C function."""
        if self._fn is None:
            path = cuda_build.build(["fused_window"])["fused_window"]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def _launch(self, votes, alive, R: int, T: int, S: int, quorum: int, want_phase: bool):
        """Checks shared by both layouts, then one launch; returns the
        decision plane and the phase plane (or None)."""
        if not 1 <= R <= MAX_REPLICAS:
            raise ValueError(f"fused window kernel takes 1..{MAX_REPLICAS} replicas, got R={R}")
        if not 1 <= quorum <= MAX_QUORUM:
            raise ValueError(f"quorum {quorum} outside 1..{MAX_QUORUM}")
        if alive.device != votes.device:
            raise ValueError("the votes and alive lie on different devices")
        if not (votes.is_contiguous() and alive.is_contiguous()):
            raise ValueError("fused window kernel needs contiguous votes and alive")
        if votes.device.type != "cuda":
            raise ValueError(f"fused window kernel needs a CUDA tensor, got {votes.device}")
        fn = self.load()
        dec = torch.empty((T, S), dtype=I8, device=votes.device)
        ph = torch.empty((T, S), dtype=I32, device=votes.device) if want_phase else None
        if dec.numel():
            with torch.cuda.device(votes.device):
                stream = torch.cuda.current_stream().cuda_stream
                err = fn(
                    votes.data_ptr(), alive.view(torch.uint8).data_ptr(),
                    dec.data_ptr(), ph.data_ptr() if ph is not None else None,
                    R, T, S, quorum, stream,
                )
            if err != 0:
                raise RuntimeError(f"fused window kernel launch failed: cudaError {err}")
            self.launches += 1
        return dec, ph

    def __call__(
        self,
        votes_rm: torch.Tensor,  # i8[R, T, S], contiguous, on CUDA
        alive_rm: torch.Tensor,  # bool[R, S], contiguous, same device
        quorum: int,
        want_phase: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
        if votes_rm.dtype != I8 or votes_rm.dim() != 3:
            raise ValueError(
                f"votes_rm must be int8[R, T, S], got {votes_rm.dtype}{list(votes_rm.shape)}"
            )
        R, T, S = votes_rm.shape
        if alive_rm.dtype != torch.bool or tuple(alive_rm.shape) != (R, S):
            raise ValueError(
                f"alive_rm must be bool[{R}, {S}], got {alive_rm.dtype}{list(alive_rm.shape)}"
            )
        dec, ph = self._launch(votes_rm, alive_rm, R, T, S, quorum, want_phase)
        return (dec, ph) if want_phase else dec


class FusedWindowTSRKernel(FusedWindowKernel):
    """ctypes wrapper of ``rw_fused_window_tsr`` (csrc/fused_window.cu),
    the kernel that reads ``[T, S, R]`` votes in place (the port of
    ``pallas_window``). Its own ``launches`` count, as above."""

    symbol = "rw_fused_window_tsr"

    def __call__(
        self,
        votes: torch.Tensor,  # i8[T, S, R], contiguous (any byte offset), on CUDA
        alive: torch.Tensor,  # bool[S, R], contiguous, same device
        quorum: int,
        want_phase: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
        if votes.dtype != I8 or votes.dim() != 3:
            raise ValueError(f"votes must be int8[T, S, R], got {votes.dtype}{list(votes.shape)}")
        T, S, R = votes.shape
        if alive.dtype != torch.bool or tuple(alive.shape) != (S, R):
            raise ValueError(f"alive must be bool[{S}, {R}], got {alive.dtype}{list(alive.shape)}")
        dec, ph = self._launch(votes, alive, R, T, S, quorum, want_phase)
        return (dec, ph) if want_phase else dec


FUSED_WINDOW = FusedWindowKernel()
FUSED_WINDOW_TSR = FusedWindowTSRKernel()


def window_rmajor(
    votes_rm: torch.Tensor,  # i8[R, T, S]
    alive_rm: torch.Tensor,  # bool[R, S]
    quorum: int,
    want_phase: bool = True,
):
    """The closed form on replica-major votes: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    with span("fw.window"):
        if votes_rm.device.type == "cuda":
            return FUSED_WINDOW(votes_rm, alive_rm, quorum, want_phase)
        if votes_rm.device.type == "cpu":
            return closed_form_window_rmajor(votes_rm, alive_rm, quorum, want_phase)
    raise ValueError(f"no fused window for device {votes_rm.device}")


def window(
    votes: torch.Tensor,  # i8[T, S, R]
    alive: torch.Tensor,  # bool[S, R]
    quorum: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The closed form on the API ``[T, S, R]`` layout: the kernel that
    reads the votes in place for a CUDA tensor, the plain version for a
    CPU tensor."""
    if votes.device.type == "cuda":
        return FUSED_WINDOW_TSR(votes, alive, quorum)
    if votes.device.type == "cpu":
        return closed_form_window(votes, alive, quorum)
    raise ValueError(f"no fused window for device {votes.device}")
