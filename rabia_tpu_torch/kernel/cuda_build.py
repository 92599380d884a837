"""Build the port's CUDA sources into shared libraries with a plain C
interface (loaded with ctypes by each kernel's wrapper).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/rabia_tpu_torch/lib<name>-<digest>.so`` at the repository root,
where ``<digest>`` covers the sources, headers and flags, so an edited
source never loads a stale library. Nothing is built at import time:
the first launch of a kernel builds it. ``build`` starts one ``nvcc``
per source, all at once, and waits for all of them.

The host C++ sources (``csrc/<name>.cpp``: code for the CPU, not the
card) build with ``g++`` by :func:`build_host` into the same directory,
under a digest of their own source, compiler and flags.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rabia_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CXX = "g++"  # the host compiler of csrc/*.cpp
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source, started together. Returns name -> library path.
    The compiler's output (with ptxas's register report) is kept beside
    each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def host_library_path(name: str) -> Path:
    """Where the library for the host source ``csrc/<name>.cpp`` lives
    once built: its digest covers that source, the compiler and the
    flags (the CUDA sources' digest does not include it)."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` with ``g++`` unless it is built;
    returns the library path. Raises when the compiler is missing or
    fails."""
    out = host_library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the host compiler {CXX!r} for {name}.cpp: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed for {name}.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def record_event(events):
    """A timing CUDA event recorded on the current stream, or None when
    the caller of a kernel wrapper times nothing (``events`` is None)."""
    if events is None:
        return None
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev
