"""ctypes bindings for the native (C++) runtime components.

The compute path of this framework is JAX/XLA/Pallas; the host-side runtime
pieces with irregular control flow — mesh parsing and BVH construction —
run as native code (native/mitr_native.cpp), mirroring where the reference
stack keeps its C++ (SURVEY.md section 2.2).  The library is compiled on
first use with g++ and cached next to the source; every entry point has a
pure-Python fallback so the framework works without a toolchain.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")
_SRC = os.path.join(_NATIVE_DIR, "mitr_native.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libmitr_native.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
            ):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC],
                    check=True, capture_output=True,
                )
            lib = ctypes.CDLL(_LIB)
            lib.mitr_obj_count.restype = ctypes.c_int32
            lib.mitr_obj_count.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mitr_obj_load.restype = ctypes.c_int32
            lib.mitr_obj_load.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ]
            _bvh_sig = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.mitr_build_bvh.restype = ctypes.c_int64
            lib.mitr_build_bvh.argtypes = _bvh_sig
            lib.mitr_build_bvh_sah.restype = ctypes.c_int64
            lib.mitr_build_bvh_sah.argtypes = _bvh_sig
            _lib = lib
        except Exception:
            _lib_failed = True
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_native(path: str):
    """Fast OBJ parse -> (verts (V,3) f32, faces (F,3) i32).  Positions and
    topology only (uvs fall back to the Python loader when needed).
    Returns None if the native library is unavailable or parsing fails."""
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    if lib.mitr_obj_count(path.encode(), ctypes.byref(nv),
                          ctypes.byref(nt)) != 0:
        return None
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nt.value, 3), np.int32)
    rc = lib.mitr_obj_load(path.encode(), _fptr(verts), nv.value,
                           _iptr(faces), nt.value)
    if rc != 0:
        return None
    return verts, faces


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int = 4, method: str = "sah"):
    """BVH over a triangle soup -> dict of flat arrays
    (bbox_min/bbox_max (N,3), left/right/count (N,), prim_order (M,)).

    ``method``: "sah" (binned surface-area heuristic, default — tighter
    subtree bounds, fewer nodes visited per ray) or
    "median" (centroid median split).  Falls back to a Python median-split
    builder when the native library is unavailable."""
    m = v0.shape[0]
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    lib = _load()
    if lib is not None:
        cap = 2 * m
        bmin = np.empty((cap, 3), np.float32)
        bmax = np.empty((cap, 3), np.float32)
        left = np.empty((cap,), np.int32)
        right = np.empty((cap,), np.int32)
        count = np.empty((cap,), np.int32)
        order = np.empty((m,), np.int32)
        fn = (lib.mitr_build_bvh_sah if method == "sah"
              else lib.mitr_build_bvh)
        n_nodes = fn(
            _fptr(v0), _fptr(e1), _fptr(e2), m, leaf_size,
            _fptr(bmin), _fptr(bmax), _iptr(left), _iptr(right),
            _iptr(count), _iptr(order),
        )
        if n_nodes > 0:
            n = int(n_nodes)
            return {
                "bbox_min": bmin[:n], "bbox_max": bmax[:n],
                "left": left[:n], "right": right[:n], "count": count[:n],
                "prim_order": order,
            }
    return _build_bvh_py(v0, e1, e2, leaf_size)


def _build_bvh_py(v0, e1, e2, leaf_size=4):
    """Reference Python BVH builder (same output contract)."""
    m = v0.shape[0]
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (M, 3, 3)
    tmin = pts.min(axis=1)
    tmax = pts.max(axis=1)
    cent = 0.5 * (tmin + tmax)
    order = np.arange(m, dtype=np.int32)
    bmin, bmax, left, right, count = [], [], [], [], []

    def rec(lo, hi):
        node = len(bmin)
        sel = order[lo:hi]
        bmin.append(tmin[sel].min(axis=0))
        bmax.append(tmax[sel].max(axis=0))
        left.append(0)
        right.append(0)
        count.append(0)
        n = hi - lo
        if n <= leaf_size:
            left[node] = -1
            right[node] = lo
            count[node] = n
            return node
        c = cent[sel]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = n // 2
        part = np.argpartition(c[:, axis], mid)
        order[lo:hi] = sel[part]
        l = rec(lo, lo + mid)
        r = rec(lo + mid, hi)
        left[node] = l
        right[node] = r
        count[node] = 0
        return node

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(0, m)
    finally:
        sys.setrecursionlimit(old)
    return {
        "bbox_min": np.asarray(bmin, np.float32),
        "bbox_max": np.asarray(bmax, np.float32),
        "left": np.asarray(left, np.int32),
        "right": np.asarray(right, np.int32),
        "count": np.asarray(count, np.int32),
        "prim_order": order,
    }
