"""Native (C++) runtime components, loaded via ctypes.

The reference's runtime substrate is C++ (SURVEY §0); here the device
compute path is JAX and the host-side heavy lifting — BVH clustering over
millions of primitives — is a small C++ library compiled on first use with
the system toolchain from the committed source. Everything has a numpy
fallback, so the package works without a compiler.

The library is built into the gitignored `.native_build/` directory of the
checkout, under a name keyed by the source's hash and the host, so a
library built on one machine is never loaded on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                          ".native_build")


def lib_path() -> str:
    """Path of the library for this source and this host."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(f"{platform.node()}|{platform.machine()}".encode())
    return os.path.join(_BUILD_DIR, f"_bvh_builder-{h.hexdigest()[:16]}.so")


_lock = threading.Lock()
_lib = None
_tried = False


def _compile(out: str) -> bool:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, out)  # atomic: concurrent builders never see half
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False


def load():
    """The builder library, or None when no toolchain is available."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not _compile(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.median_split.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.median_split.restype = None
        lib.ranges_to_perm.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.ranges_to_perm.restype = None
        _lib = lib
        return _lib


def median_split(centroids: np.ndarray, n_leaves: int):
    """Partition prims into n_leaves median-split ranges.

    Returns (order [n] int64 permutation, bounds [n_leaves+1] int64 range
    offsets into order) or None if the native library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    cent = np.ascontiguousarray(centroids, np.float32)
    n = cent.shape[0]
    order = np.arange(n, dtype=np.int64)
    bounds = np.zeros(n_leaves + 1, np.int64)
    lib.median_split(
        cent.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int64(n_leaves),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return order, bounds


def ranges_to_perm(order: np.ndarray, bounds: np.ndarray, n_leaves: int,
                   leaf_size: int):
    """Threaded C++ scatter of median_split ranges into padded leaf slots
    ([n_leaves*leaf_size] int64, -1 pads), or None without the library."""
    lib = load()
    if lib is None:
        return None
    order = np.ascontiguousarray(order, np.int64)
    bounds = np.ascontiguousarray(bounds, np.int64)
    perm = np.empty(n_leaves * leaf_size, np.int64)
    lib.ranges_to_perm(
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_leaves), ctypes.c_int64(leaf_size),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return perm
