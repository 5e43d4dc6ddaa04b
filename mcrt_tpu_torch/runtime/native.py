"""ctypes bridge to the native host library (``native/libmcrt_native.so``),
counterpart of ``mcrt_tpu/runtime/native.py``.

The library is framework-free C++ shared with the JAX package and is built
on first use with ``make -C native``.  The port needs only the binned-SAH
block decomposition; ``sah_block_order`` returns None when the library
cannot be built or loaded, and the caller then falls back to Morton blocks
exactly as the JAX package does.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmcrt_native.so")


class _NativeLib:
    """Lazily built and loaded library handle (one per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._tried = False

    def get(self) -> ctypes.CDLL | None:
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
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
