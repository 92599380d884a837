"""Packed-vote fused window: 16 votes per 32-bit word, bitwise tally.

The port of the reference's ``rabia_tpu/kernel/packed_window.py``, in
plain PyTorch. The four vote codes are 2 bits each, packed 16 to a word
along the shard axis; the closed form of :mod:`fused_window` is then
evaluated with word-wise bit arithmetic: per-lane V1/V0 bit-planes, a
bit-sliced carry-save counter across replicas (:func:`_csa_inc`) and a
bit-sliced comparator against the constant quorum (:func:`_ge_const`).
Decisions come back packed in the same 2-bit layout.

Words are ``torch.int32`` holding the uint32 bit pattern (PyTorch's
uint32 lacks shifts and compares); the arithmetic runs in int64 masked to
32 bits, so no shift ever sees a sign bit. Compare results as
``.numpy().view(np.uint32)``.

``packed_window_rmajor`` is the plain version. ``PACKED_WINDOW`` wraps
the hand-written CUDA kernel of ``csrc/packed_window.cu``, which replaces
the reference's ``packed_window_rmajor``; ``window`` dispatches on the
tensor's device alone: a CUDA tensor goes to the kernel (or the wrapper
raises), a CPU tensor to the plain version. The packers, which feed and
read the window, are entries of the same library (``PACKERS``, one
thread a 32-bit word); ``pack_codes``, ``unpack_codes`` and
``pack_alive`` dispatch the same way, and ``pack_codes_plain``,
``unpack_codes_plain`` and ``pack_alive_plain`` are their plain
versions. ``pack_inputs`` packs a window's votes and alive plane in one
launch (``pack_alive`` alone is a launch for a few KB).
"""

from __future__ import annotations

import ctypes

import torch

from rabia_tpu_torch.core.types import ABSENT
from rabia_tpu_torch.kernel import cuda_build

LANES = 16  # 2-bit codes per word
_EVEN = 0x55555555  # lane-LSB positions (bits 0,2,…,30)
_M32 = 0xFFFFFFFF
I32 = torch.int32
I64 = torch.int64
MAX_REPLICAS = 127  # csrc/packed_window.cuh: at most 7 counter planes


def packed_width(S: int) -> int:
    """Words per row for S shards (ceil division)."""
    return -(-S // LANES)


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same 32-bit pattern."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _u32(w: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 in [0, 2^32)."""
    return w.to(I64) & _M32


def _pack(x: torch.Tensor, fill: int) -> torch.Tensor:
    S = x.shape[-1]
    SW = packed_width(S)
    pad = SW * LANES - S
    x = x.to(I64)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=fill)
    w = x.reshape(x.shape[:-1] + (SW, LANES))
    shifts = torch.arange(LANES, dtype=I64, device=x.device) * 2
    # disjoint 2-bit fields: sum == bitwise-or
    return _to_i32((w << shifts).sum(-1))


def pack_codes_plain(x: torch.Tensor) -> torch.Tensor:
    """Pack 2-bit codes i8[..., S] -> i32[..., ceil(S/16)].

    Ragged widths pad with ABSENT: absent votes never tally, so padding
    lanes decide ABSENT and :func:`unpack_codes` truncates them away.
    """
    return _pack(x, ABSENT)


def unpack_codes_plain(p: torch.Tensor, S: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: i32[..., SW] -> i8[..., S]."""
    shifts = torch.arange(LANES, dtype=I64, device=p.device) * 2
    x = (_u32(p)[..., None] >> shifts) & 3
    x = x.reshape(p.shape[:-1] + (p.shape[-1] * LANES,)).to(torch.int8)
    return x[..., :S]


def pack_alive_plain(alive: torch.Tensor) -> torch.Tensor:
    """Pack bool[..., S] -> i32[..., SW] with one bit per lane at the
    lane LSB position (dead/padding lanes are 0)."""
    return _pack(alive, 0)


def pack_codes(x: torch.Tensor) -> torch.Tensor:
    """:func:`pack_codes_plain`: the packer kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return PACKERS.pack_codes(x)
    return pack_codes_plain(x)


def unpack_codes(p: torch.Tensor, S: int) -> torch.Tensor:
    """:func:`unpack_codes_plain`: the unpacker kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if p.device.type == "cuda":
        return PACKERS.unpack_codes(p, S)
    return unpack_codes_plain(p, S)


def pack_alive(alive: torch.Tensor) -> torch.Tensor:
    """:func:`pack_alive_plain`: the packer kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if alive.device.type == "cuda":
        return PACKERS.pack_alive(alive)
    return pack_alive_plain(alive)


def pack_inputs(votes: torch.Tensor, alive: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pack_codes(votes), pack_alive(alive))`` of a window's votes
    ``i8[..., S]`` and alive plane ``bool[..., S]``: one packer launch
    for both on CUDA tensors, the plain versions for CPU tensors."""
    if votes.device.type == "cuda":
        return PACKERS.pack_inputs(votes, alive)
    return pack_codes_plain(votes), pack_alive_plain(alive)


def _csa_inc(planes: list, b, cap: int) -> list:
    """Add bit-plane ``b`` (one bit per lane) into the bit-sliced
    counter ``planes`` (LSB-first). The count after k increments is at
    most k <= R < 2**cap, so the carry out of plane cap-1 is zero."""
    carry = b
    out = []
    for p in planes:
        out.append(p ^ carry)
        carry = p & carry
    if len(out) < cap:
        out.append(carry)
    return out


def _ge_const(planes: list, q: int, m: torch.Tensor) -> torch.Tensor:
    """Bit-sliced ``count >= q`` for a constant q (MSB-first magnitude
    scan); returns a mask in the lane-LSB positions of ``m``."""
    if q <= 0:
        return m
    nbits = len(planes)
    if q > (1 << nbits) - 1:
        return torch.zeros_like(m)
    ge = torch.zeros_like(m)
    eq = m
    for bit in reversed(range(nbits)):
        p = planes[bit]
        if (q >> bit) & 1:
            eq = eq & p
        else:
            ge = ge | (eq & p)
    return ge | eq


def packed_window_rmajor(
    packed_rm: torch.Tensor,  # i32[R, T, SW] — replica-major packed planes
    alive_packed: torch.Tensor,  # i32[R, SW] — lane-LSB alive bits
    quorum: int,
) -> torch.Tensor:
    """The fault-free closed form on packed votes; returns packed
    decisions i32[T, SW] in the same 2-bit layout (V1/V0/ABSENT). The
    phase plane is not produced (0 iff decided)."""
    R = packed_rm.shape[0]
    cap = R.bit_length()
    m = torch.full(packed_rm.shape[1:], _EVEN, dtype=I64, device=packed_rm.device)
    c1: list = []
    c0: list = []
    for r in range(R):
        w = _u32(packed_rm[r])
        a = _u32(alive_packed[r])[None, :]
        lo = w & m
        hi = (w >> 1) & m
        b1 = lo & (hi ^ m) & a
        b0 = ((lo | hi) ^ m) & a  # ~(lo|hi) confined to lane-LSB bits
        c1 = _csa_inc(c1, b1, cap)
        c0 = _csa_inc(c0, b0, cap)
    ge1 = _ge_const(c1, quorum, m)
    ge0 = _ge_const(c0, quorum, m)
    # lane codes: V1=01 where ge1; else V0=00 where ge0; else ABSENT=11
    babs = (ge1 | ge0) ^ m
    return _to_i32(ge1 | babs | (babs << 1))


class PackedWindowKernel:
    """ctypes wrapper of ``pw_window`` (csrc/packed_window.cu).

    ``launches`` counts kernel launches; it grows by one exactly where
    the kernel is launched. The library builds on the first call."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def load(self):
        """Build (if needed) and bind the library; returns the C function."""
        if self._fn is None:
            path = cuda_build.build(["packed_window"])["packed_window"]
            fn = ctypes.CDLL(str(path)).pw_window
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(
        self,
        packed_rm: torch.Tensor,  # i32[R, T, SW], contiguous (any word offset), on CUDA
        alive_packed: torch.Tensor,  # i32[R, SW], contiguous, same device
        quorum: int,
    ) -> torch.Tensor:
        if packed_rm.dtype != I32 or packed_rm.dim() != 3:
            raise ValueError(
                f"packed_rm must be int32[R, T, SW], got {packed_rm.dtype}{list(packed_rm.shape)}"
            )
        R, T, SW = packed_rm.shape
        if not 1 <= R <= MAX_REPLICAS:
            raise ValueError(f"packed window kernel takes 1..{MAX_REPLICAS} replicas, got R={R}")
        if alive_packed.dtype != I32 or tuple(alive_packed.shape) != (R, SW):
            raise ValueError(
                f"alive_packed must be int32[{R}, {SW}], got "
                f"{alive_packed.dtype}{list(alive_packed.shape)}"
            )
        if alive_packed.device != packed_rm.device:
            raise ValueError("the votes and alive lie on different devices")
        if not (packed_rm.is_contiguous() and alive_packed.is_contiguous()):
            raise ValueError("packed window kernel needs contiguous votes and alive")
        if packed_rm.device.type != "cuda":
            raise ValueError(f"packed window kernel needs a CUDA tensor, got {packed_rm.device}")
        fn = self.load()
        out = torch.empty((T, SW), dtype=I32, device=packed_rm.device)
        if out.numel():
            with torch.cuda.device(packed_rm.device):
                stream = torch.cuda.current_stream().cuda_stream
                err = fn(packed_rm.data_ptr(), alive_packed.data_ptr(), out.data_ptr(), R, T, SW,
                         int(quorum), stream)
            if err != 0:
                raise RuntimeError(f"packed window kernel launch failed: cudaError {err}")
            self.launches += 1
        return out


PACKED_WINDOW = PackedWindowKernel()


class PackersKernel:
    """ctypes wrapper of ``pw_pack_codes``, ``pw_unpack_codes``,
    ``pw_pack_alive`` and ``pw_pack_inputs`` (csrc/packed_window.cu).

    ``counts`` holds the launches by entry (``pack_codes``,
    ``unpack_codes``, ``pack_alive``, ``pack_inputs``) and ``launches``
    their sum; each grows by one exactly where a kernel is launched. The
    library builds on the first call."""

    ENTRIES = ("pack_codes", "unpack_codes", "pack_alive", "pack_inputs")

    def __init__(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.ENTRIES, 0)
        self._lib = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.ENTRIES, 0)

    def load(self):
        """Build (if needed) and bind the library; returns it."""
        if self._lib is None:
            path = cuda_build.build(["packed_window"])["packed_window"]
            lib = ctypes.CDLL(str(path))
            P, LL = ctypes.c_void_p, ctypes.c_longlong
            for fn in (lib.pw_pack_codes, lib.pw_pack_alive, lib.pw_unpack_codes):
                fn.argtypes = [P, P, LL, LL, LL, P]
                fn.restype = ctypes.c_int
            lib.pw_pack_inputs.argtypes = [P, P, LL, P, P, LL, LL, LL, P]
            lib.pw_pack_inputs.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    @staticmethod
    def _check(t: torch.Tensor, dtype, what: str) -> None:
        if t.dtype != dtype or t.dim() < 1:
            raise ValueError(f"{what} must be {dtype}[..., n], got {t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.device.type != "cuda":
            raise ValueError(f"the packer kernels need a CUDA tensor, got {t.device}")

    def _launched(self, err: int, entry: str) -> None:
        if err != 0:
            raise RuntimeError(f"packer kernel ({entry}) launch failed: cudaError {err}")
        self.launches += 1
        self.counts[entry] += 1

    def _launch(self, entry: str, src: torch.Tensor, out: torch.Tensor, rows: int, a: int,
                b: int) -> torch.Tensor:
        lib = self.load()
        if out.numel():
            with torch.cuda.device(src.device):
                err = getattr(lib, f"pw_{entry}")(
                    src.data_ptr(), out.data_ptr(), rows, a, b,
                    torch.cuda.current_stream().cuda_stream)
            self._launched(err, entry)
        return out

    def _pack(self, entry: str, x: torch.Tensor) -> torch.Tensor:
        S = x.shape[-1]
        SW = packed_width(S)
        out = torch.empty(x.shape[:-1] + (SW,), dtype=I32, device=x.device)
        rows = x.numel() // S if S else 0
        return self._launch(entry, x, out, rows, S, SW)

    def pack_codes(self, x: torch.Tensor) -> torch.Tensor:
        """Codes i8[..., S] -> words i32[..., ceil(S/16)], pad lanes
        ABSENT (codes 0..3; any byte packs as the plain sum does)."""
        self._check(x, torch.int8, "codes")
        return self._pack("pack_codes", x)

    def pack_alive(self, alive: torch.Tensor) -> torch.Tensor:
        """Flags bool[..., S] -> lane-LSB alive words i32[..., SW]."""
        self._check(alive, torch.bool, "alive")
        return self._pack("pack_alive", alive)

    def pack_inputs(self, votes: torch.Tensor,
                    alive: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """A window's codes i8[..., S] and alive flags bool[..., S] (the
        same S, one device) -> ``(pack_codes(votes), pack_alive(alive))``
        in one launch."""
        self._check(alive, torch.bool, "alive")
        self._check(votes, torch.int8, "codes")
        S = votes.shape[-1]
        if alive.shape[-1] != S or alive.device != votes.device:
            raise ValueError(f"alive must be bool[..., {S}] on {votes.device}, got "
                             f"{list(alive.shape)} on {alive.device}")
        SW = packed_width(S)
        codes_out = torch.empty(votes.shape[:-1] + (SW,), dtype=I32, device=votes.device)
        alive_out = torch.empty(alive.shape[:-1] + (SW,), dtype=I32, device=votes.device)
        lib = self.load()
        if codes_out.numel() + alive_out.numel():
            with torch.cuda.device(votes.device):
                err = lib.pw_pack_inputs(
                    votes.data_ptr(), codes_out.data_ptr(), votes.numel() // S if S else 0,
                    alive.data_ptr(), alive_out.data_ptr(), alive.numel() // S if S else 0, S, SW,
                    torch.cuda.current_stream().cuda_stream)
            self._launched(err, "pack_inputs")
        return codes_out, alive_out

    def unpack_codes(self, p: torch.Tensor, S: int) -> torch.Tensor:
        """Words i32[..., SW] -> codes i8[..., min(S, 16*SW)]."""
        self._check(p, I32, "words")
        SW = p.shape[-1]
        S = max(0, min(int(S), LANES * SW))
        out = torch.empty(p.shape[:-1] + (S,), dtype=torch.int8, device=p.device)
        rows = p.numel() // SW if SW else 0
        return self._launch("unpack_codes", p, out, rows, SW, S)


PACKERS = PackersKernel()


def window(packed_rm: torch.Tensor, alive_packed: torch.Tensor, quorum: int) -> torch.Tensor:
    """The packed closed form: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if packed_rm.device.type == "cuda":
        return PACKED_WINDOW(packed_rm, alive_packed, quorum)
    if packed_rm.device.type == "cpu":
        return packed_window_rmajor(packed_rm, alive_packed, quorum)
    raise ValueError(f"no packed window for device {packed_rm.device}")
