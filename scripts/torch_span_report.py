#!/usr/bin/env python3
"""The port's spans in one traced run of a benchmark cell.

    python3 scripts/torch_span_report.py --workload kv4096-ycsbA --seed 7 --seconds 20

is ``portbench/run.py --trace 1`` with the profiler's summary reduced by
``portbench/pbench/spans.py`` as well: the result line's ``breakdown``
also holds ``spans`` (``{name: [count, seconds, self seconds]}`` of the
program's spans in the window), ``span_figures`` (per window of the device
KV lane: ``pack_ms``, ``dispatch_ms``, ``wait_ms``, ``settle_ms``,
``cycle_self_pct``, ``tiling``; per call of the decision core:
``dispatch_us``) and ``span_idle_gaps`` (the longest idle gaps, each named
by the innermost span that covers it). The reduction runs once the window
has closed, so the window and every other figure of the line are the
harness's own. Like ``portbench/run.py`` it needs a CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import run  # noqa: E402  (portbench/run.py)
from pbench import spans, trace  # noqa: E402


def main(argv=None) -> int:
    trace.DeviceTrace = spans.SpanTrace  # run.run_cell imports it at call time
    args = list(sys.argv[1:] if argv is None else argv)
    return run.main(args + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
