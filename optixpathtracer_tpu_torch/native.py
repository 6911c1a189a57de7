"""ctypes binding to the native (C++) BVH builder.

The port compiles its own copy of the reference's builder,
`csrc/bvh_builder.cpp` (the code of `optixpathtracer_tpu/native/
bvh_builder.cpp`, unchanged), with the reference's flags into the port's
build directory `_build/`, the library named by a hash of the source and
flags: the same builder gives the same triangle order, hence the same
triangle ids, in both packages. If the compile or load fails,
`scene.bvh.build_bvh` falls back to its numpy builder, as the reference
does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import warnings

import numpy as np

from ._build import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "bvh_builder.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


@functools.cache
def _lib():
    try:
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode())
        path = os.path.join(
            BUILD_DIR, f"libbvh_builder-{digest.hexdigest()[:12]}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError) as e:
        warnings.warn(f"native BVH builder unavailable ({e}); "
                      "using numpy fallback")
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.bvh_build.restype = ctypes.c_int64
    lib.bvh_build.argtypes = [fp, fp, fp, ctypes.c_int64,
                              fp, fp, ip, ip, ip, ip]
    return lib


def native_available() -> bool:
    return _lib() is not None


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """Skip-link BVH from the C++ builder, as `scene.bvh.BVHArrays`, or
    None when the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    n = len(v0)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    bound = 2 * n + 1
    node_min = np.empty((bound, 3), np.float32)
    node_max = np.empty((bound, 3), np.float32)
    node_skip = np.empty(bound, np.int32)
    node_first = np.empty(bound, np.int32)
    node_count = np.empty(bound, np.int32)
    tri_order = np.empty(n, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.bvh_build(
        v0.ctypes.data_as(fp), v1.ctypes.data_as(fp), v2.ctypes.data_as(fp),
        n,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        node_skip.ctypes.data_as(ip), node_first.ctypes.data_as(ip),
        node_count.ctypes.data_as(ip), tri_order.ctypes.data_as(ip))
    if n_nodes <= 0:
        return None
    from .scene.bvh import BVHArrays
    return BVHArrays(
        node_min=node_min[:n_nodes].copy(),
        node_max=node_max[:n_nodes].copy(),
        node_skip=node_skip[:n_nodes].copy(),
        node_first=node_first[:n_nodes].copy(),
        node_count=node_count[:n_nodes].copy(),
        tri_order=tri_order,
    )
