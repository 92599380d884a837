"""Published peaks of the card and the bytes each kernel's work needs.

A roofline share is the least time the card could take for the work (its
bytes over the peak rate) divided by the time the profiler saw the kernel
take. The bytes are those the work needs, counted from its shapes: each
input byte read once, each output byte written once, and where the work
depends on the data, what these inputs need and not the most they could.

The card's peak comes from NVIDIA's data sheet for the H100 SXM part
(80 GB of HBM3 at 3.35 TB/s) at its full power limit of 700 W; the run
prints the card's name and its power limit beside every share.
"""

from __future__ import annotations

H100_SXM_BYTES_PER_S = 3.35e12

WORD = 4  # a slot's version and each length are 32-bit words


def peak_bytes_per_s() -> float:
    return H100_SXM_BYTES_PER_S


def fused_window_bytes(replicas: int, slots: int, shards: int) -> int:
    """``rw_fused_window`` on replica-major votes without the phase plane:
    the votes i8[R, T, S] and the alive plane i8[R, S] read, the decisions
    i8[T, S] written. 805,326,848 bytes at R=5, T=32768, S=4096."""
    return replicas * slots * shards + replicas * shards + slots * shards


def kv_op_bytes(key_bytes: int, value_bytes: int) -> dict:
    """Bytes one op of a kv window on a present key needs, by kind,
    whatever the kernel's layout of the table (every op of the YCSB mixes
    after the load finds its key):

    - an update (a SET of a present key) reads its key and key length and
      its value and value length from the op planes, reads its slot's key
      and key length to find the slot, and writes the slot's value, value
      length and version: ``2 * (K + 4) + (V + 4) + (V + 8)``;
    - a read (a GET in a mixed window, or a probe) reads its key and key
      length, its slot's key and key length, version, value length and
      value, and writes its found byte, version, value length and value:
      ``2 * (K + 4) + (V + 8) + (1 + 8 + V)``.

    One slot's key is counted for the search, the least a lookup reads. The
    copy of the whole table that today's functional windows make is not
    counted: an in-place window would not need it."""
    K, V = key_bytes, value_bytes
    return {"set": 2 * (K + WORD) + (V + WORD) + (V + 2 * WORD),
            "get": 2 * (K + WORD) + (V + 2 * WORD) + (1 + 2 * WORD + V)}


def share_pct(nbytes: float, seconds: float) -> float | None:
    """``nbytes`` moved in ``seconds`` of kernel time as a percentage of
    the peak rate; None where no kernel time was seen."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / seconds / peak_bytes_per_s()
