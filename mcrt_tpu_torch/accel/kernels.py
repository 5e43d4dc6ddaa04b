"""Wrappers for the blocked intersector's CUDA kernels K1-K3.

The kernels are CUDA C++ in ``mcrt_tpu_torch/csrc/blocked.cu``, compiled
at first use with nvcc into a shared library with a plain C interface
(``mcrt_tpu_torch/_build/``, rebuilt when the sources' hash changes) and
loaded with ctypes.

The wrappers take CUDA tensors only: each checks device, dtype, shape and
contiguity, allocates the outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and raises if the launch reports an error;
there is no fallback.  The kernels' plain PyTorch versions, and the choice
between kernel and plain version by the rays' device, are in
``blocked.py``.  ``<wrapper>.launches`` counts the kernel's launches.

ctypes: every pointer and the stream go as ``c_void_p`` and
every int as ``c_int``; a default ctypes argument is a 32-bit int and would
cut a pointer.  A kernel may still be running when its wrapper returns and
the caller drops an input tensor: that is safe because PyTorch's caching
allocator hands freed memory only to later work on the same stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_SOURCES = ("blocked.cuh", "blocked.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# Float contraction: -fmad=false and no --use_fast_math, so
# every multiply and add rounds on its own as in the plain versions;
# later performance work may revisit this.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cuda_nvcc):
        return cuda_nvcc
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the blocked-intersector "
                       "kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


class _KernelLibrary:
    """The compiled kernel library: built once per source hash, loaded
    once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: str | None = None
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load(self._build())
            return self._lib

    def _build(self) -> str:
        path = os.path.join(BUILD_DIR, f"libmcrt_blocked_{_source_hash()}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, "blocked.cu")]
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            self.build_log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}):\n{self.build_log[-4000:]}")
            os.replace(tmp, path)
        self.path = path
        return path

    @staticmethod
    def _load(path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mcrt_cull.argtypes = [p, p, p, p, i, i, i, p]
        lib.mcrt_closest.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.mcrt_occluded.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        for fn in (lib.mcrt_cull, lib.mcrt_closest, lib.mcrt_occluded):
            fn.restype = ctypes.c_int
        return lib


LIBRARY = _KernelLibrary()


def build() -> str:
    """Build (if needed) and load the kernel library; returns its path."""
    LIBRARY.get()
    return LIBRARY.path


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
             device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"kernel input is on {t.device}: the kernels take CUDA tensors")
    return t.device


def _check_tile(tile: int, npad: int):
    if tile % 32 or not 32 <= tile <= 1024 or npad % tile:
        raise ValueError(f"tile {tile} must be a multiple of 32 in [32, 1024] "
                         f"dividing the padded ray count {npad}")


def cull(rays_packed: torch.Tensor, chunk_aabb: torch.Tensor,
         aabb: torch.Tensor, tile: int) -> torch.Tensor:
    """K1: (n_tiles, NBpad) block keys, the entry distance min over the
    tile's rays or BIG (replaces ``pallas_blocked.py:_cull_kernel``)."""
    dev = _cuda_device(rays_packed)
    npad, nbpad = rays_packed.shape[1], aabb.shape[0]
    _check_tile(tile, npad)
    if nbpad % 128:
        raise ValueError(f"aabb rows {nbpad} must be a multiple of 128")
    _require(rays_packed, "rays_packed", torch.float32, (8, npad), dev)
    _require(chunk_aabb, "chunk_aabb", torch.float32, (nbpad // 128, 8), dev)
    _require(aabb, "aabb", torch.float32, (nbpad, 8), dev)
    keys = torch.empty((npad // tile, nbpad), dtype=torch.float32, device=dev)
    if keys.numel() == 0:
        return keys
    err = LIBRARY.get().mcrt_cull(
        rays_packed.data_ptr(), chunk_aabb.data_ptr(), aabb.data_ptr(),
        keys.data_ptr(), npad, tile, nbpad, _stream(dev))
    cull.launches += 1
    _check_launch(err, "K1 cull")
    return keys


def _check_walk(counts, rays_packed, lists, tri, tile, group):
    dev = _cuda_device(rays_packed)
    npad = rays_packed.shape[1]
    _check_tile(tile, npad)
    if not 1 <= group <= 8:
        raise ValueError(f"group {group} must be in [1, 8]")
    n_tiles, nbpad = npad // tile, lists.shape[1]
    if tri.shape[0] != 16 or tri.shape[1] % 128 or tri.shape[1] == 0:
        raise ValueError(f"tri has shape {tuple(tri.shape)}, expected (16, k*128)")
    _require(counts, "counts", torch.int32, (n_tiles,), dev)
    _require(rays_packed, "rays_packed", torch.float32, (8, npad), dev)
    _require(lists, "lists", torch.int32, (n_tiles, nbpad), dev)
    _require(tri, "tri", torch.float32, tuple(tri.shape), dev)
    return dev, npad, nbpad


def closest(counts, rays_packed, lists, tn_sorted, tri, tile: int, group: int):
    """K2: (Npad,) best t (BIG on a miss) and (Npad,) slot (-1 on a miss)
    (replaces ``pallas_blocked.py:_closest_kernel``)."""
    dev, npad, nbpad = _check_walk(counts, rays_packed, lists, tri, tile, group)
    _require(tn_sorted, "tn_sorted", torch.float32, tuple(lists.shape), dev)
    t = torch.empty((npad,), dtype=torch.float32, device=dev)
    slot = torch.empty((npad,), dtype=torch.int32, device=dev)
    if npad == 0:
        return t, slot
    err = LIBRARY.get().mcrt_closest(
        counts.data_ptr(), rays_packed.data_ptr(), lists.data_ptr(),
        tn_sorted.data_ptr(), tri.data_ptr(), t.data_ptr(), slot.data_ptr(),
        npad, tile, nbpad, tri.shape[1], group, _stream(dev))
    closest.launches += 1
    _check_launch(err, "K2 closest")
    return t, slot


def occluded(counts, rays_packed, lists, tri, tile: int, group: int):
    """K3: (Npad,) 1.0 where the segment is blocked, else 0.0 (replaces
    ``pallas_blocked.py:_occluded_kernel``)."""
    dev, npad, nbpad = _check_walk(counts, rays_packed, lists, tri, tile, group)
    out = torch.empty((npad,), dtype=torch.float32, device=dev)
    if npad == 0:
        return out
    err = LIBRARY.get().mcrt_occluded(
        counts.data_ptr(), rays_packed.data_ptr(), lists.data_ptr(),
        tri.data_ptr(), out.data_ptr(), npad, tile, nbpad, tri.shape[1],
        group, _stream(dev))
    occluded.launches += 1
    _check_launch(err, "K3 occluded")
    return out


WRAPPERS = {"K1": cull, "K2": closest, "K3": occluded}
for _w in WRAPPERS.values():
    _w.launches = 0


def reset_launch_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {k: w.launches for k, w in WRAPPERS.items()}
