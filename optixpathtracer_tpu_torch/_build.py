"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
`_build/`, which git ignores. The library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale one never
loaded. Nothing here runs at import time: the CPU tests import every module
of the package on machines with neither a GPU nor `nvcc`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("dense_intersect", "walk_intersect", "packet_intersect",
           "layered_bsdf")

# sm_90a: Hopper with its arch-specific features. --fmad=false keeps every
# multiply and add separately rounded, as the reference kernels and the
# plain PyTorch versions round them: FMA contraction would move t at the
# last bit, and at knife edges that changes which triangle id wins.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict:
    """Compile every listed source that has no up-to-date library, one
    `nvcc` per source, all started together. Returns {name: ptxas report}
    for every listed source: this call's compile's, or the one saved beside
    a library built earlier; raises if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, reports = {}, {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            try:
                with open(f"{out}.ptxas") as f:
                    reports[name] = f.read()
            except FileNotFoundError:
                reports[name] = ""
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            with open(f"{out}.ptxas", "w") as f:
                f.write(log)
            os.replace(tmp, out)  # atomic: concurrent builders never clash
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The compiled library of `csrc/<name>.cu`, built if needed."""
    build((name,))
    return ctypes.CDLL(library_path(name))
