"""Plain NumPy reference of the fault-free slot window's decisions.

Under full delivery, every replica alive or crashed per the alive plane,
and two rounds a slot, the weak-MVC pipeline decides each slot by the
votes of the alive replicas alone: V1 where at least a quorum (a
majority of all replicas, ``R // 2 + 1``) of them vote V1, else V0 where
a quorum votes V0, else nothing (ABSENT). Imports numpy only.
"""

from __future__ import annotations

import numpy as np

V0, V1, ABSENT = 0, 1, 3


def decide(votes_rm: np.ndarray, alive_rm: np.ndarray, rows: int = 2048,
           quorum: int | None = None) -> np.ndarray:
    """Decisions i8[T, S] of replica-major votes i8[R, T, S] under the
    alive plane bool[R, S], ``rows`` slots at a time. ``quorum`` other
    than the majority breaks the protocol's guarantee (a control)."""
    R, T, S = votes_rm.shape
    q = R // 2 + 1 if quorum is None else quorum
    live = np.asarray(alive_rm, bool)[:, None, :]
    out = np.empty((T, S), np.int8)
    for t in range(0, T, rows):
        v = votes_rm[:, t:t + rows]
        c1 = ((v == V1) & live).sum(0, dtype=np.int32)
        c0 = ((v == V0) & live).sum(0, dtype=np.int32)
        out[t:t + rows] = np.where(c1 >= q, V1, np.where(c0 >= q, V0, ABSENT))
    return out
