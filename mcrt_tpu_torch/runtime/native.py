"""ctypes bridge to the native host library (``native/libmcrt_native.so``),
counterpart of ``mcrt_tpu/runtime/native.py``.

The library is framework-free C++ shared with the JAX package and is built
on first use with ``make -C native``.  It gives the port three things: the
binned-SAH block decomposition (``sah_block_order``), the spatial-split
(SBVH) reference decomposition (``sbvh_block_refs``) and a fast OBJ
geometry parse (``parse_obj_native``).  Each returns None when the library
cannot be built or loaded, and its caller then falls back as the JAX
package does: SBVH to SAH, SAH to Morton blocks, the native OBJ parse to
the Python line parser.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmcrt_native.so")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


@contextlib.contextmanager
def build_lock(name: str):
    """An exclusive file lock (``mcrt_tpu_torch/_build/<name>.lock``) that
    serializes builds across processes: ranks that start together would
    otherwise race on the same outputs."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, f"{name}.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


class _NativeLib:
    """Lazily built and loaded library handle (one per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        # the SBVH build keeps its result in library-global state until
        # ``sbvh_fetch`` copies it out: one build-and-fetch at a time
        self.sbvh_lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._tried = False

    def get(self) -> ctypes.CDLL | None:
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            with build_lock("native"):
                if not os.path.exists(_LIB_PATH) and not _build():
                    return None
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                return None
            lib.sah_build_blocks.restype = ctypes.c_int32
            lib.sah_build_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.sbvh_build_blocks.restype = ctypes.c_int64
            lib.sbvh_build_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ]
            lib.sbvh_fetch.restype = ctypes.c_int32
            lib.sbvh_fetch.argtypes = [ctypes.c_void_p] * 3
            lib.obj_parse.restype = ctypes.c_void_p
            lib.obj_parse.argtypes = [ctypes.c_char_p]
            lib.obj_counts.restype = None
            lib.obj_counts.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 6
            lib.obj_fill.restype = None
            lib.obj_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
            lib.obj_mat_name.restype = ctypes.c_char_p
            lib.obj_mat_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.obj_mtl_lib.restype = ctypes.c_char_p
            lib.obj_mtl_lib.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.obj_free.restype = None
            lib.obj_free.argtypes = [ctypes.c_void_p]
            self._lib = lib
            return lib


def _build() -> bool:
    try:
        r = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                           text=True, timeout=120)
        return r.returncode == 0 and os.path.exists(_LIB_PATH)
    except (OSError, subprocess.TimeoutExpired):
        return False


_NATIVE = _NativeLib()


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library (built on first use); None where it
    cannot be built or loaded."""
    return _NATIVE.get()


def available() -> bool:
    """Whether the native library built and loaded."""
    return get_lib() is not None


def sah_block_order(positions: np.ndarray, indices: np.ndarray,
                    block_size: int = 128, bins: int = 16):
    """Binned-SAH block decomposition: (order (ntri,), block_start
    (n_blocks+1,)), or None if the native library is unavailable."""
    lib = _NATIVE.get()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    ntri = indices.shape[0]
    order = np.empty((ntri,), np.int32)
    block_start = np.empty((ntri + 1,), np.int32)
    nb = lib.sah_build_blocks(
        positions.ctypes.data, indices.ctypes.data, ntri, block_size, bins,
        order.ctypes.data, block_start.ctypes.data,
    )
    return order, block_start[: nb + 1]


def sbvh_block_refs(positions: np.ndarray, indices: np.ndarray, block_size: int = 128,
                    bins: int = 16, max_split_depth: int = 16, min_overlap: float = 1e-5,
                    extra_refs_budget: float = 0.5):
    """Spatial-split (SBVH) block decomposition: (ref_tri (n_refs,),
    ref_bounds (n_refs, 6) plane-clipped lo/hi boxes, block_start
    (n_blocks+1,)), or None if the native library is unavailable or the
    build failed.  A triangle that straddles a split may be referenced from
    more than one block; n_refs <= ntri * (1 + extra_refs_budget)."""
    lib = _NATIVE.get()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    ntri = indices.shape[0]
    with _NATIVE.sbvh_lock:
        n_refs = lib.sbvh_build_blocks(
            positions.ctypes.data, indices.ctypes.data, ntri, block_size, bins,
            max_split_depth, min_overlap, extra_refs_budget)
        if n_refs <= 0:
            return None
        ref_tri = np.empty((n_refs,), np.int32)
        ref_bounds = np.empty((n_refs, 6), np.float32)
        block_start = np.empty((n_refs + 2,), np.int32)
        nb = lib.sbvh_fetch(ref_tri.ctypes.data, ref_bounds.ctypes.data,
                            block_start.ctypes.data)
    if nb <= 0:
        return None
    return ref_tri, ref_bounds, block_start[: nb + 1]


@dataclass
class ObjGeometry:
    """Raw OBJ geometry from the native parser, before materials are
    resolved."""

    v: np.ndarray  # (nv, 3) f32
    vn: np.ndarray  # (nvn, 3) f32
    vt: np.ndarray  # (nvt, 2) f32
    f_v: np.ndarray  # (ntri, 3) i32
    f_vt: np.ndarray  # (ntri, 3) i32, -1 = none
    f_vn: np.ndarray  # (ntri, 3) i32, -1 = none
    f_m: np.ndarray  # (ntri,) i32 material slot, -1 = default
    mat_names: list[str]
    mtl_libs: list[str]


def parse_obj_native(path: str) -> ObjGeometry | None:
    """Parse an OBJ file's geometry with the native library; None if the
    library is unavailable or cannot open the file."""
    lib = _NATIVE.get()
    if lib is None:
        return None
    h = lib.obj_parse(path.encode())
    if not h:
        return None
    try:
        c = [ctypes.c_int64(0) for _ in range(6)]
        lib.obj_counts(h, *[ctypes.byref(x) for x in c])
        nv, nvn, nvt, ntri, nmat, nlib = (x.value for x in c)
        v = np.empty((nv, 3), np.float32)
        vn = np.empty((nvn, 3), np.float32)
        vt = np.empty((nvt, 2), np.float32)
        f_v = np.empty((ntri, 3), np.int32)
        f_vt = np.empty((ntri, 3), np.int32)
        f_vn = np.empty((ntri, 3), np.int32)
        f_m = np.empty((ntri,), np.int32)
        lib.obj_fill(h, v.ctypes.data, vn.ctypes.data, vt.ctypes.data, f_v.ctypes.data,
                     f_vt.ctypes.data, f_vn.ctypes.data, f_m.ctypes.data)
        mat_names = [lib.obj_mat_name(h, i).decode() for i in range(nmat)]
        mtl_libs = [lib.obj_mtl_lib(h, i).decode() for i in range(nlib)]
        return ObjGeometry(v, vn, vt, f_v, f_vt, f_vn, f_m, mat_names, mtl_libs)
    finally:
        lib.obj_free(h)
