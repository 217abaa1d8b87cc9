"""Build the port's CUDA kernels with nvcc at first use and load them.

Each kernel source under `tantivy_tpu_torch/csrc/` compiles to a shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries land in `build/kernels/` at the repo
root, named by a hash of the source, the headers beside it and the flags,
so an edited source or header rebuilds and an unchanged one is reused.
Nothing is fetched: the build reads only the repo's sources and the local
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

#: sm_90a keeps Hopper-only instructions available; --fmad=false forbids
#: contracting `a + b * c` into one FMA, which would change score bits;
#: -Xptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the kernel sources, `csrc/<name>.cu`, one library each
KERNELS = ("group_probe", "phrase_probe", "bool_probe", "packed_flat",
           "deep_probe", "seg_phrase", "dense_flat", "merge_tail",
           "ub_sweep")

_lock = threading.Lock()
#: one lock per kernel, so that different kernels build concurrently
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 = reused)
build_seconds: dict[str, float] = {}
#: what ptxas reported for each library built in this process
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from `csrc/<name>.cu`, compiling it first
    when no library for the current source and flags exists. Different
    kernels may be loaded from several threads at once; each builds once."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; sources: {KERNELS}")
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(_CSRC, f"{name}.cu")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
        for path in [src] + [os.path.join(_CSRC, f) for f in headers]:
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        build_seconds[name] = 0.0
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src}:\n{proc.stderr}"
                )
            os.replace(tmp, out)
            build_seconds[name] = time.perf_counter() - t0
            ptxas_report[name] = "\n".join(
                line.strip() for line in proc.stderr.splitlines()
                if "ptxas info" in line or "spill" in line
            )
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib
