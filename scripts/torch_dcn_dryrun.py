"""Multi-process dry run of the port's device mesh, the counterpart of
``scripts/dcn_dryrun.py``.

N OS processes join one ``torch.distributed`` process group, build one
(shard x replica) mesh over the world, and run the mesh as a single
multi-controller program (``rabia_tpu_torch.testing.dcn``, workload
``dryrun``): ``MeshPhaseKernel.phase_step`` with its two exchanges over
the replica axis across the processes, ``slot_window`` over ``1 x N`` and
``N x 1`` meshes, and the whole ``MeshEngine`` (scalar and block lanes)
over both. Each rank checks its blocks against the one-device plain
versions and a one-device engine it runs itself, and the ranks' replica
state against each other; the parent checks every exit code and kills
every rank when they outlast ``--timeout``.

    python scripts/torch_dcn_dryrun.py [--procs N] [--device cpu|cuda]
                                       [--backend gloo|nccl] [--timeout S]

On the CPU the ranks use gloo. On a card (``--device cuda``) gloo lets
the ranks share one card (their blocks go through host memory by
design); NCCL takes one card a rank.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rabia_tpu_torch.testing.dcn import spawn_ranks  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2, help="ranks in the world mesh")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds before every rank is killed")
    args = ap.parse_args()
    if args.procs < 1:
        ap.error("--procs must be >= 1")
    try:
        results = spawn_ranks(args.procs, backend=args.backend, device=args.device,
                              workload="dryrun", timeout=args.timeout)
    except RuntimeError as e:
        print(f"torch dcn dryrun FAILED: {e}", file=sys.stderr)
        return 1
    for r in results:
        print(f"rank {r['rank']}: phase_step block {r['phase_step_block']} and slot_window over "
              f"1x{args.procs} and {args.procs}x1 equal the one-device plain versions; "
              f"MeshEngine over both meshes equals the one-device engine "
              f"(state digests {r[f'engine_{args.procs}x1'][:12]}, "
              f"{r[f'engine_1x{args.procs}'][:12]})")
    print(f"torch dcn dryrun ok: {args.procs} processes ({args.backend}, {args.device}), one "
          f"world mesh: the replica exchanges and the decided plane's gather across processes, "
          f"state agreed on every rank")
    return 0


if __name__ == "__main__":
    sys.exit(main())
