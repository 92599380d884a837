"""block_p99_ms.kv: the 99th percentile of the time from a block's
``submit_block`` to the host seeing its future settled, over every block
that settled in the window (the harness's own clock, ms)."""

import numpy as np


def read(run: dict):
    lat = run.get("block_ms")
    return float(np.percentile(lat, 99)) if lat else None
