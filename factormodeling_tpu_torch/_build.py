"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each source in ``csrc/`` has a plain C interface and compiles on its own
into a shared library for Hopper (``sm_90a``). The build runs at first use,
into ``build/kernels/`` beside the package (listed in ``.gitignore``), named
by a hash of the source, the headers it includes and the flags, so an
edited source or header rebuilds and an unchanged one loads at once.
Several sources build in parallel, one ``nvcc`` process each
(:func:`build`). A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "build", "load", "source_path"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

#: kernel library name -> source file under csrc/
KERNEL_SOURCES = {"rank_ic": "rank_ic.cu", "admm_segment": "admm_segment.cu",
                  "window_stream": "window_stream.cu",
                  "zscore_group": "zscore_group.cu",
                  "rank_sort": "rank_sort.cu", "fp32_probe": "fp32_probe.cu"}

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)

_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time, "ptxas": register, shared-memory and
#: spill report lines};
#: empty for a library that was already built
BUILD_LOG: dict[str, dict] = {}


def source_path(name: str) -> Path:
    return CSRC / KERNEL_SOURCES[name]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the port's "
        "CUDA kernels are compiled on first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header of
    ``csrc/`` the source includes (``#include "..."``), and the flags."""
    src = source_path(name).read_bytes()
    h = hashlib.sha1(src)
    for header in sorted(set(_INCLUDE.findall(src.decode()))):
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=tuple(KERNEL_SOURCES)) -> dict:
    """Compile every library in ``names`` that is not built yet, all at once
    (one ``nvcc`` each), and wait for them. Returns :data:`BUILD_LOG`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
        BUILD_LOG[name] = {
            "seconds": seconds,
            "ptxas": [ln.strip() for ln in (stdout + stderr).splitlines()
                      if ("ptxas info" in ln and ("registers" in ln
                                                  or "Compiling" in ln))
                      or "spill" in ln]}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
