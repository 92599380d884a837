"""Time the port's kv-window kernels beside another build of them, on one GPU.

    python3 scripts/torch_kv_window_ab.py OTHER_KV_WINDOW_CU ...
        [--modes mixed,fold,set,probe,lookup,dict] [--reps 50] [--rounds 2]

Each OTHER_KV_WINDOW_CU is a ``kv_window.cu`` with the same C interface
(``kvw_window``, ``kvw_decide_window``), its headers beside it, for
example from an earlier commit unpacked with ``git archive`` into a
directory that .gitignore lists. All its windows go through those two
entries: its read-only windows with no output table, as builds before
``kv_read.cu`` ran them, and its dictionary windows with the ranks, as
builds before ``kv_dict.cu`` ran them; this tree's go where
``KV_WINDOW`` sends them (``kv_read.cu``, ``kv_dict.cu``). Every build is
made with nvcc (sm_90a), checked bit for bit against the plain version,
and timed on windows over a full S=4096 x P=64 table (32 B keys, 64 B
values), R=5 with every replica alive: at W=16, ``mixed`` (the mixed
window ``chip_smoke.py`` times), ``fold`` (the same with its decision),
``set`` (a SET window with its decision), ``probe`` (a read of every
op's key, no decision) and ``lookup`` (the GET window: the same with its
decision), all in the row form; ``dict`` adds the dictionary form's SET
window and mixed window, each with its decision, at W = 1, 4, 16, 64
and 256 (D = min(W, 32) rows a shard, about one in four sharing a key
with the row before it). A mixed window is timed as ``mixed_apply``
runs it, its reads gathered to the GET waves (G rows): one launch in
this tree; in an OTHER build that writes every wave's read planes, its
launch and then the gather's ``index_select``s and ``stack``. Device
time per window by CUDA graph replay, in turns (others, this, this,
others reversed) each round.
Prints each build's register report, the card as nvidia-smi names it and
one JSON line with each mode's bytes bound. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from rabia_tpu_torch.kernel import cuda_build, kv_window  # noqa: E402
from rabia_tpu_torch.parallel import MeshPhaseKernel  # noqa: E402


def other_kernel(src: Path, i: int) -> kv_window.KVWindowKernel:
    """A kv-window wrapper bound to ``src`` built into its own library."""
    out = cuda_build.BUILD_DIR / "ab" / f"libkv_window_other{i}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, f"-I{src.parent}", "-o", str(out), str(src)],
        capture_output=True, text=True,
    )
    print(f"{src}:\n{proc.stdout}{proc.stderr}".strip())
    proc.check_returncode()
    kern = kv_window.KVWindowKernel()
    kern.gathered_reads = False
    lib = ctypes.CDLL(str(out))
    vpp = ctypes.POINTER(ctypes.c_void_p)
    llp = ctypes.POINTER(ctypes.c_longlong)
    fn = lib.kvw_window
    fn.argtypes = [vpp, vpp, vpp, vpp, llp, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dfn = lib.kvw_decide_window
    dfn.argtypes = [vpp, vpp, vpp, vpp, llp, vpp, llp, ctypes.c_void_p]
    dfn.restype = ctypes.c_int
    kern._libs = [lib]
    # every window through the build's two entries (reads with no output
    # table, dictionaries with their ranks)
    kern._fn = kern._dict_fn = kern._read_fn = fn
    kern._decide_fn = kern._dict_decide_fn = kern._read_decide_fn = dfn
    return kern


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--modes", default="mixed,fold,set,probe,lookup,dict")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kernels = {"this": kv_window.KV_WINDOW}
    kernels["this"].load()
    for lib in ("kv_window", "kv_dict", "kv_read"):
        print(cuda_build.library_path(lib).with_suffix(".log").read_text().strip())
    for i, src in enumerate(args.others):
        kernels[str(src)] = other_kernel(src, i)

    S, P, K4, VW4, W = chip_smoke.S_FULL, chip_smoke.P_FULL, 8, 16, 16
    gen = torch.Generator(device=dev).manual_seed(8)
    table, ops, _ = chip_smoke.random_kv_case(gen, S, P, K4, VW4, W, K4, VW4, dev, p_used=1.0)
    kind, klen, vlen, kw, vw = ops
    mk = MeshPhaseKernel(S, chip_smoke.R_FULL, device=dev)
    alive = torch.ones((S, mk.R), dtype=torch.bool, device=dev)
    base = torch.zeros(S, dtype=torch.int32, device=dev)
    dk = dict(seed=mk.seed, coin_p1=mk.coin_p1, max_phases=4)
    rk = dict(want_table=False, want_reads=True)
    get = kv_window.KIND_GET

    def mixed(k, call, g):
        """A mixed window's device work as mixed_apply does it on build k:
        ``call(**kw)`` launches it with reads, which are gathered to the
        GET waves ``g`` (i32, and its int64 copy) by the launch, or after
        it by index_select and stack, as mixed_apply did before its
        kernels gathered."""
        if k.gathered_reads:
            return call(want_reads=True, gidx=g[0])
        out = list(call(want_reads=True))
        out[2] = kv_window.gather_reads(out[2], g[1])
        return tuple(out)

    def rows_of(kind_):  # made before any graph capture (nonzero syncs)
        g = chip_smoke._gidx(kind_)
        return g, g.to(torch.int64)

    g16 = rows_of(kind)
    gm = dict(want_reads=True, gidx=g16[0])
    calls = {  # mode -> (kernel call, plain call)
        "mixed": (lambda k: mixed(k, lambda **kw: k(table, *ops, W, **kw), g16),
                  lambda: kv_window.kv_window_plain(table, *ops, W, **gm)),
        "fold": (lambda k: mixed(k, lambda **kw: k.decide(table, *ops, W, alive, base, **dk, **kw),
                                 g16),
                 lambda: kv_window.decide_window_plain(mk, table, *ops, W, alive, base, 4, **gm)),
        "set": (lambda k: k.decide(table, None, klen, vlen, kw, vw, W, alive, base, **dk),
                lambda: kv_window.decide_window_plain(mk, table, None, klen, vlen, kw, vw, W,
                                                      alive, base, 4)),
        "probe": (lambda k: k(table, get, klen, None, kw, None, 0, **rk),
                  lambda: kv_window.kv_window_plain(table, get, klen, None, kw, None, 0, **rk)),
        "lookup": (lambda k: k.decide(table, get, klen, None, kw, None, W, alive, base, **dk,
                                      **rk),
                   lambda: kv_window.decide_window_plain(mk, table, get, klen, None, kw, None, W,
                                                         alive, base, 4, **rk)),
    }
    bound_bytes = {}
    nbytes = lambda xs: sum(x.numel() * x.element_size() for x in xs if x is not None)  # noqa: E731
    tbl_bytes = nbytes(table)
    decide_bytes = alive.numel() + 4 * base.numel() + 4 * 3
    modes = args.modes.split(",")
    gathered = lambda g: g.numel() * S * (8 + 4 * VW4)  # noqa: E731
    if "dict" in modes:  # the dictionary form at W = 1, 4, 16, 64, 256
        modes.remove("dict")
        for Wd in (1, 4, 16, 64, 256):
            # ops over the row-form modes' key space, on the same full table
            _, dkind, dops, didx, _ = chip_smoke.random_dict_case(
                gen, S, P, K4, VW4, Wd, K4, VW4, min(Wd, 32), dev, p_used=1.0)
            dg = rows_of(dkind)
            calls[f"dict set W={Wd}"] = (
                lambda k, a=(dops, didx, Wd): k.decide(table, None, *a[0], a[2], alive, base,
                                                       idx=a[1], **dk),
                lambda a=(dops, didx, Wd): kv_window.decide_window_plain(
                    mk, table, None, *a[0], a[2], alive, base, 4, idx=a[1]))
            calls[f"dict mixed W={Wd}"] = (
                lambda k, a=(dkind, dops, didx, Wd, dg): mixed(
                    k, lambda **kw: k.decide(table, a[0], *a[1], a[3], alive, base, idx=a[2],
                                             **dk, **kw), a[4]),
                lambda a=(dkind, dops, didx, Wd, dg): kv_window.decide_window_plain(
                    mk, table, a[0], *a[1], a[3], alive, base, 4, idx=a[2], want_reads=True,
                    gidx=a[4][0]))
            bound_bytes[f"dict set W={Wd}"] = (2 * tbl_bytes + nbytes((*dops, didx)) + S
                                               + decide_bytes)
            bound_bytes[f"dict mixed W={Wd}"] = (
                2 * tbl_bytes + nbytes((dkind, *dops, didx, dg[0])) + S + gathered(dg[0])
                + decide_bytes)
            modes += [f"dict set W={Wd}", f"dict mixed W={Wd}"]
    for mode in modes:
        want = chip_smoke._flat(calls[mode][1]())
        for name, kern in kernels.items():
            got = chip_smoke._flat(calls[mode][0](kern))
            torch.cuda.synchronize(dev)
            if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(want, got)):
                raise AssertionError(f"{name} differs from the plain version ({mode})")

    times = {mode: {name: [] for name in kernels} for mode in modes}
    order = list(kernels)[1:] + ["this", "this"] + list(kernels)[1:][::-1]
    for _ in range(args.rounds):
        for mode in modes:
            for name in order:
                times[mode][name].append(chip_smoke._graph_ms(
                    lambda i=0, k=kernels[name], m=mode: calls[m][0](k), args.reps))
    read_bytes = W * S * (1 + 4 + 4 + 4 * VW4) + S
    mixed_bytes = 2 * tbl_bytes + nbytes((*ops, gm["gidx"])) + S + gathered(gm["gidx"])
    # a read moves the used flags, key lengths and keys, each found slot's
    # version, length and value, the op keys and the read planes; the GET
    # window adds the decision's inputs and each shard's version counter
    reads = calls["probe"][1]()[2]
    hits = len({(int(t), int(s_)) for t, s_ in zip(*(x.cpu().numpy() for x in (
        torch.nonzero(reads.found)[:, 1], reads.ver[reads.found])))})
    probe_bytes = (table.used.numel() + nbytes((table.keyw, table.klen)) + hits * (8 + 4 * VW4)
                   + nbytes((klen, kw)) + read_bytes)
    bound_bytes |= {
        "mixed": mixed_bytes,
        "fold": mixed_bytes + decide_bytes,
        "set": 2 * tbl_bytes + nbytes((klen, vlen, kw, vw)) + S + decide_bytes,
        "probe": probe_bytes,
        "lookup": probe_bytes + decide_bytes + 4 * S,
    }
    rate = chip_smoke._card_rate_bytes_per_s(torch.cuda.get_device_name(0))
    bound_ms = {mode: bound_bytes[mode] / rate * 1e3 for mode in modes}
    print(smi)
    print(json.dumps({
        "shape": {"S": S, "P": P, "K4": K4, "VW4": VW4, "W": W, "R": mk.R},
        "bound_ms": bound_ms, "times_ms": times,
        "share_of_bound": {mode: {name: [bound_ms[mode] / t for t in ts]
                                  for name, ts in times[mode].items()} for mode in modes},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
