"""The check's sample of a window's outputs: a uniform reservoir, drawn
from the seed, plus the last output of the window."""

from __future__ import annotations

import numpy as np


class Reservoir:
    """Keeps a uniform sample of ``size`` of the items offered (reservoir
    sampling by ``rng``) and the last one offered."""

    def __init__(self, size: int, rng: np.random.Generator) -> None:
        self.size, self.rng = size, rng
        self.kept: dict = {}
        self.seen = 0
        self.last: tuple = ()

    def offer(self, key, item) -> None:
        if self.seen < self.size:
            self.kept[key] = item
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                del self.kept[sorted(self.kept)[j]]
                self.kept[key] = item
        self.seen += 1
        self.last = (key, item)

    def items(self) -> dict:
        """{key: item} of the sample and the last item."""
        out = dict(self.kept)
        if self.last:
            out[self.last[0]] = self.last[1]
        return out
