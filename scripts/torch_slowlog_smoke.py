#!/usr/bin/env python
"""Slowlog critical-path CI smoke on the PyTorch/CUDA port
(docs/OBSERVABILITY.md "Critical path").

The counterpart of ``scripts/slowlog_smoke.py`` over ``rabia_tpu_torch``
(the same cluster, gates, artifacts and exit codes; artifacts under
``build/`` by default). Host-only: it reads no device.

Spins a 3-replica real-TCP gateway cluster on the WAL durability plane,
drives a short burst of fresh Submits, then exercises the tail-exemplar
pipeline end to end exactly the way an operator would:

1. fetches every gateway's slowlog reservoir over the admin plane
   (``AdminKind.SLOWLOG`` — the same frames ``python -m
   rabia_tpu_torch slowlog`` uses, NOT the in-process shortcut);
2. decomposes each exemplar's cross-tier flight trace into named
   critical-path segments and FAILS unless at least one fresh (non-
   truncated) exemplar decomposes with ``unattributed`` below 20% of
   its wall time — an attribution plane that cannot account for the
   tail it captured is a broken evidence plane, not a smoke pass;
3. writes the raw slowlog + decomposition JSON and the rendered
   worst-exemplar waterfall as CI artifacts.

Usage: python scripts/torch_slowlog_smoke.py [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

UNATTRIBUTED_GATE = 0.20


async def run(out_dir: Path) -> int:
    from rabia_tpu_torch.apps.kvstore import encode_set_bin
    from rabia_tpu_torch.gateway.client import RabiaClient
    from rabia_tpu_torch.obs.critpath import (
        CritpathAggregator,
        collect_exemplar_trace,
        collect_slowlog,
        decompose_exemplars,
        dominant_segment,
        render_slowlog,
        render_waterfall,
    )
    from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

    wal_dir = tempfile.mkdtemp(prefix="slowlog-smoke-wal-")
    cluster = GatewayCluster(
        n_replicas=3, n_shards=2, persistence="wal", wal_dir=wal_dir
    )
    await cluster.start()
    client = None
    try:
        client = RabiaClient(cluster.endpoints())
        await client.connect()
        for i in range(48):
            resp = await client.submit(
                i % 2, [encode_set_bin(f"slow{i}", f"v{i}")]
            )
            assert resp, f"submit {i} failed"

        addrs = [("127.0.0.1", g.port) for g in cluster.gateways]
        agg = CritpathAggregator()
        all_docs, all_decomps = [], []
        for host, port in addrs:
            doc = await collect_slowlog(host, port)
            exemplars = doc.get("exemplars", [])
            all_docs.append(doc)
            if not exemplars:
                continue

            # decompose_exemplars is sync; fetch the traces here and
            # feed it prebuilt timelines
            timelines = {}
            for ex in exemplars:
                timelines[id(ex)] = await collect_exemplar_trace(
                    addrs, ex
                )
            decomps = decompose_exemplars(
                exemplars,
                lambda ex: timelines[id(ex)],
                aggregator=agg,
            )
            all_decomps.extend(decomps)
            print(render_slowlog(doc, decomps))
            print()

        fresh = [
            d for d in all_decomps
            if d.get("ok") and not d.get("truncated")
        ]
        if not fresh:
            print(
                "FAIL: no fresh exemplar decomposed "
                f"({len(all_decomps)} total, "
                f"{agg.truncated_total} truncated, "
                f"{agg.unanchored_total} unanchored)"
            )
            return 1
        worst = max(fresh, key=lambda d: d["total_s"])
        frac = worst["unattributed_frac"]
        print(
            f"worst fresh exemplar: {worst['total_s'] * 1e3:.3f} ms, "
            f"dominant {dominant_segment(worst)}, "
            f"unattributed {frac * 100:.1f}% "
            f"(gate < {UNATTRIBUTED_GATE * 100:.0f}%)"
        )

        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "slowlog.json").write_text(
            json.dumps(
                {
                    "reservoirs": all_docs,
                    "decompositions": all_decomps,
                    "aggregate": agg.summary(),
                },
                indent=2,
                default=str,
            )
        )
        (out_dir / "waterfall.txt").write_text(
            render_waterfall(worst) + "\n"
        )

        if frac >= UNATTRIBUTED_GATE:
            print(
                f"FAIL: unattributed {frac * 100:.1f}% >= "
                f"{UNATTRIBUTED_GATE * 100:.0f}% — the decomposer "
                "cannot account for the tail it captured"
            )
            return 1
        print(f"slowlog smoke PASS ({len(fresh)} fresh exemplar(s))")
        return 0
    finally:
        if client is not None:
            await client.close()
        await cluster.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--out-dir", default="build/slowlog-artifacts",
        help="artifact directory (slowlog.json + waterfall.txt)",
    )
    args = ap.parse_args(argv)
    return asyncio.run(run(Path(args.out_dir)))


if __name__ == "__main__":
    raise SystemExit(main())
