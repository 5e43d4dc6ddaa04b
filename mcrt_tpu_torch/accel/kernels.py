"""Wrappers for the port's CUDA kernels: K1 cull, K2 closest hit and K3 any
hit of the blocked visit-list walk (``csrc/blocked.cu``), K4/K5 of the
dense small-scene path (``csrc/dense.cu``), K6/K7 of the two-level
instanced walk (``csrc/two_level.cu``), and the card micro-benchmark's K8
elementwise chain and K9 small-K matrix product (``csrc/vpu.cu``).

The sources are compiled at first use with nvcc, one process per source
started together, and linked into one shared library with a plain C
interface (``mcrt_tpu_torch/_build/``, rebuilt when the sources' hash
changes), loaded with ctypes.

The wrappers take CUDA tensors only: each checks device, dtype, shape and
contiguity, allocates the outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and raises if the launch reports an error;
there is no fallback.  The kernels' plain PyTorch versions, and the choice
between kernel and plain version by the input's device, are in
``blocked.py``, ``two_level.py`` and ``tools/vpu_bench.py``.
``<wrapper>.launches`` counts the kernel's launches.

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
_HEADERS = ("blocked.cuh", "walk.cuh")
_UNITS = ("blocked.cu", "dense.cu", "two_level.cu", "vpu.cu")
_SOURCES = _HEADERS + _UNITS
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# Float contraction: -fmad=false and no --use_fast_math, so every multiply
# and add of K1, K4/K5 and K8/K9 rounds on its own as in the plain versions
# (K8/K9 fuse with explicit __fmaf_rn where their reference does), and so
# do K6/K7's world-space rows.  The list walks K2/K3 and K6/K7 prefilter
# with a test fused by explicit __fmaf_rn and are held to their plain
# versions within a stated tolerance instead (csrc/walk.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
DENSE_MAX_SLOTS = 1024  # K4/K5 stage a table's real slots: 8 blocks of 128 at most
WALK_MAX_TILE = 256  # the list walks' launch bound (MCRT_WALK_MAX_TILE in csrc/walk.cuh)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cuda_nvcc):
        return cuda_nvcc
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's kernels "
                       "need the CUDA toolkit")


def _source_hash(csrc: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The compiled kernel library of the sources in ``csrc`` (this
    package's by default; ``tools/tree_ab.py`` builds other trees'): built
    once per source hash, loaded once per process."""

    def __init__(self, csrc: str = _CSRC):
        self.csrc = csrc
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: str | None = None
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        from ..runtime.native import build_lock

        with self._lock:
            if self._lib is None:
                with build_lock("kernels"):  # ranks that start together build once
                    path = self._build()
                self._lib = self._load(path)
            return self._lib

    def _build(self) -> str:
        path = os.path.join(BUILD_DIR, f"libmcrt_kernels_{_source_hash(self.csrc)}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tag = f"{os.getpid()}.tmp"
            nvcc = _nvcc()
            objs = [os.path.join(BUILD_DIR, f"{u}.{tag}.o") for u in _UNITS]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o,
                                       os.path.join(self.csrc, u)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for u, o in zip(_UNITS, objs)]
            try:
                logs = [p.communicate(timeout=600)[0] for p in procs]
            finally:  # a timeout or an interrupt must not leave compilers running
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            self.build_log = "".join(logs)
            failed = [(u, p.returncode) for u, p in zip(_UNITS, procs) if p.returncode]
            if failed:
                raise RuntimeError(f"nvcc failed {failed}:\n{self.build_log[-6000:]}")
            tmp = f"{path}.{tag}"
            r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                               text=True, timeout=600)
            self.build_log += r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                                   f"{self.build_log[-4000:]}")
            for o in objs:
                os.remove(o)
            os.replace(tmp, path)
        self.path = path
        return path

    @staticmethod
    def _load(path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mcrt_cull.argtypes = [p, p, p, p, i, i, i, p]
        lib.mcrt_closest.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.mcrt_occluded.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.mcrt_dense_closest.argtypes = [p, p, p, p, i, i, p]
        lib.mcrt_dense_any.argtypes = [p, p, p, i, i, p]
        lib.mcrt_closest2.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.mcrt_occluded2.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.mcrt_vpu_chain_f32.argtypes = [p, p, i, i, p]
        lib.mcrt_vpu_chain_bf16.argtypes = [p, p, i, i, p]
        lib.mcrt_vpu_matmul.argtypes = [p, p, p, i, i, p]
        for fn in (lib.mcrt_cull, lib.mcrt_closest, lib.mcrt_occluded,
                   lib.mcrt_dense_closest, lib.mcrt_dense_any, lib.mcrt_closest2,
                   lib.mcrt_occluded2, lib.mcrt_vpu_chain_f32, lib.mcrt_vpu_chain_bf16,
                   lib.mcrt_vpu_matmul):
            fn.restype = ctypes.c_int
        return lib


LIBRARY = KernelLibrary()


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


def _check_tri(tri: torch.Tensor, dev, max_slots: int | None = None):
    if (tri.dim() != 2 or tri.shape[0] != 16 or tri.shape[1] % 128 or tri.shape[1] == 0
            or (max_slots is not None and tri.shape[1] > max_slots)):
        raise ValueError(f"tri has shape {tuple(tri.shape)}, expected (16, k*128)"
                         + (f" with k*128 <= {max_slots}" if max_slots else ""))
    _require(tri, "tri", torch.float32, tuple(tri.shape), dev)


def _check_walk(counts, rays_packed, lists, tri, tile, group):
    dev = _cuda_device(rays_packed)
    npad = rays_packed.shape[1]
    _check_tile(tile, npad)
    if not 1 <= group <= 8:
        raise ValueError(f"group {group} must be in [1, 8]")
    n_tiles, nbpad = npad // tile, lists.shape[1]
    _check_tri(tri, dev)
    _require(counts, "counts", torch.int32, (n_tiles,), dev)
    _require(rays_packed, "rays_packed", torch.float32, (8, npad), dev)
    _require(lists, "lists", torch.int32, (n_tiles, nbpad), dev)
    return dev, npad, nbpad


def _check_boxes(dev, tile, tri, boxes, rows, name="aabb"):
    """The list walks' extra checks: the tile within their launch bound,
    the box table the lists index ((NBpad, 8) block boxes for K2/K3,
    (Ppad, 8) pair boxes for K6/K7), and both tables on 16-byte boundaries
    (the kernels copy them to shared memory 16 bytes at a time)."""
    if tile > WALK_MAX_TILE:
        raise ValueError(f"tile {tile} exceeds the list walks' {WALK_MAX_TILE}")
    _require(boxes, name, torch.float32, (rows, 8), dev)
    if tri.data_ptr() % 16 or boxes.data_ptr() % 16:
        raise ValueError(f"tri and {name} must start on 16-byte boundaries")


def closest(counts, rays_packed, lists, tn_sorted, tri, aabb, tile: int, group: int):
    """K2: (Npad,) best t (BIG on a miss) and (Npad,) slot (-1 on a miss)
    (replaces ``pallas_blocked.py:_closest_kernel``); ``aabb`` is the
    (NBpad, 8) block box table the lists index."""
    dev, npad, nbpad = _check_walk(counts, rays_packed, lists, tri, tile, group)
    _require(tn_sorted, "tn_sorted", torch.float32, tuple(lists.shape), dev)
    _check_boxes(dev, tile, tri, aabb, nbpad)
    t = torch.empty((npad,), dtype=torch.float32, device=dev)
    slot = torch.empty((npad,), dtype=torch.int32, device=dev)
    if npad == 0:
        return t, slot
    err = LIBRARY.get().mcrt_closest(
        counts.data_ptr(), rays_packed.data_ptr(), lists.data_ptr(),
        tn_sorted.data_ptr(), tri.data_ptr(), aabb.data_ptr(), t.data_ptr(),
        slot.data_ptr(), npad, tile, nbpad, tri.shape[1], group, _stream(dev))
    closest.launches += 1
    _check_launch(err, "K2 closest")
    return t, slot


def occluded(counts, rays_packed, lists, tri, aabb, tile: int, group: int):
    """K3: (Npad,) 1.0 where the segment is blocked, else 0.0 (replaces
    ``pallas_blocked.py:_occluded_kernel``); ``aabb`` as for K2."""
    dev, npad, nbpad = _check_walk(counts, rays_packed, lists, tri, tile, group)
    _check_boxes(dev, tile, tri, aabb, nbpad)
    out = torch.empty((npad,), dtype=torch.float32, device=dev)
    if npad == 0:
        return out
    err = LIBRARY.get().mcrt_occluded(
        counts.data_ptr(), rays_packed.data_ptr(), lists.data_ptr(),
        tri.data_ptr(), aabb.data_ptr(), out.data_ptr(), npad, tile, nbpad,
        tri.shape[1], group, _stream(dev))
    occluded.launches += 1
    _check_launch(err, "K3 occluded")
    return out


def _check_dense(rays_packed, tri):
    dev = _cuda_device(rays_packed)
    npad = rays_packed.shape[1]
    _require(rays_packed, "rays_packed", torch.float32, (8, npad), dev)
    _check_tri(tri, dev, DENSE_MAX_SLOTS)
    return dev, npad


def dense_closest(rays_packed: torch.Tensor, tri: torch.Tensor):
    """K4: (Npad,) best t (BIG on a miss) and slot (-1 on a miss) over every
    slot of a table of at most 1,024 slots (replaces
    ``pallas_blocked.py:_dense_closest_kernel``)."""
    dev, npad = _check_dense(rays_packed, tri)
    t = torch.empty((npad,), dtype=torch.float32, device=dev)
    slot = torch.empty((npad,), dtype=torch.int32, device=dev)
    if npad == 0:
        return t, slot
    err = LIBRARY.get().mcrt_dense_closest(rays_packed.data_ptr(), tri.data_ptr(),
                                           t.data_ptr(), slot.data_ptr(), npad,
                                           tri.shape[1], _stream(dev))
    dense_closest.launches += 1
    _check_launch(err, "K4 dense_closest")
    return t, slot


def dense_any(rays_packed: torch.Tensor, tri: torch.Tensor):
    """K5: (Npad,) 1.0 where a slot of the table blocks the segment, else
    0.0 (replaces ``pallas_blocked.py:_dense_any_kernel``)."""
    dev, npad = _check_dense(rays_packed, tri)
    out = torch.empty((npad,), dtype=torch.float32, device=dev)
    if npad == 0:
        return out
    err = LIBRARY.get().mcrt_dense_any(rays_packed.data_ptr(), tri.data_ptr(),
                                       out.data_ptr(), npad, tri.shape[1], _stream(dev))
    dense_any.launches += 1
    _check_launch(err, "K5 dense_any")
    return out


def _check_pairs(dev, lists, pair_code, tw_rows):
    _require(pair_code, "pair_code", torch.int32, (lists.shape[1],), dev)
    if tw_rows.dim() != 1 or tw_rows.numel() == 0 or tw_rows.numel() % 12:
        raise ValueError(f"tw_rows has shape {tuple(tw_rows.shape)}, expected (I*12,)")
    _require(tw_rows, "tw_rows", torch.float32, tuple(tw_rows.shape), dev)
    return tw_rows.numel() // 12


def closest2(counts, rays_packed, lists, tn_sorted, tri, pair_code, tw_rows, pair_aabb,
             tile: int, group: int):
    """K6: (Npad,) best t (BIG on a miss), slot (-1 on a miss) and instance
    (-1 on a miss) of the walk over (instance, block) pair lists (replaces
    ``two_level.py:_closest2_kernel``); ``pair_aabb`` is the (Ppad, 8) pair
    box table the lists index."""
    dev, npad, ppad = _check_walk(counts, rays_packed, lists, tri, tile, group)
    _require(tn_sorted, "tn_sorted", torch.float32, tuple(lists.shape), dev)
    n_inst = _check_pairs(dev, lists, pair_code, tw_rows)
    _check_boxes(dev, tile, tri, pair_aabb, ppad, "pair_aabb")
    t = torch.empty((npad,), dtype=torch.float32, device=dev)
    slot = torch.empty((npad,), dtype=torch.int32, device=dev)
    inst = torch.empty((npad,), dtype=torch.int32, device=dev)
    if npad == 0:
        return t, slot, inst
    err = LIBRARY.get().mcrt_closest2(
        counts.data_ptr(), rays_packed.data_ptr(), lists.data_ptr(), tn_sorted.data_ptr(),
        pair_code.data_ptr(), tw_rows.data_ptr(), pair_aabb.data_ptr(), tri.data_ptr(),
        t.data_ptr(), slot.data_ptr(), inst.data_ptr(), npad, tile, ppad, tri.shape[1],
        n_inst, group, _stream(dev))
    closest2.launches += 1
    _check_launch(err, "K6 closest2")
    return t, slot, inst


def occluded2(counts, rays_packed, lists, tri, pair_code, tw_rows, pair_aabb, tile: int,
              group: int):
    """K7: (Npad,) 1.0 where an instance blocks the segment, else 0.0
    (replaces ``two_level.py:_occluded2_kernel``); ``pair_aabb`` as for K6."""
    dev, npad, ppad = _check_walk(counts, rays_packed, lists, tri, tile, group)
    n_inst = _check_pairs(dev, lists, pair_code, tw_rows)
    _check_boxes(dev, tile, tri, pair_aabb, ppad, "pair_aabb")
    out = torch.empty((npad,), dtype=torch.float32, device=dev)
    if npad == 0:
        return out
    err = LIBRARY.get().mcrt_occluded2(
        counts.data_ptr(), rays_packed.data_ptr(), lists.data_ptr(), pair_code.data_ptr(),
        tw_rows.data_ptr(), pair_aabb.data_ptr(), tri.data_ptr(), out.data_ptr(), npad,
        tile, ppad, tri.shape[1], n_inst, group, _stream(dev))
    occluded2.launches += 1
    _check_launch(err, "K7 occluded2")
    return out


def _check_iters(iters: int):
    if not 1 <= iters <= 2**30:
        raise ValueError(f"iters {iters} must be in [1, 2**30]")


def vpu_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """K8: the elementwise chain of ``tools/vpu_bench.py`` (20 rounds of
    multiply-add, min and abs-subtract) on a (256, 1024) float32 or
    bfloat16 tensor, computed ``iters`` times; returns one pass's result
    (replaces ``tools/vpu_bench.py:chain_kernel``)."""
    dev = _cuda_device(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or bfloat16")
    _require(x, "x", x.dtype, (256, 1024), dev)
    if x.data_ptr() % 4:  # the kernels read and write 4-byte words
        raise ValueError("x must start on a 4-byte boundary")
    _check_iters(iters)
    out = torch.empty_like(x)
    fn = (LIBRARY.get().mcrt_vpu_chain_f32 if x.dtype == torch.float32
          else LIBRARY.get().mcrt_vpu_chain_bf16)
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(), iters, _stream(dev))
    vpu_chain.launches += 1
    _check_launch(err, "K8 vpu_chain")
    return out


def vpu_matmul(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """K9: (512, 1024) float32 a @ b for a (512, k), b (k, 1024), 1 <= k <= 128,
    each output accumulated in k order with single-rounded multiply-adds,
    computed ``iters`` times (replaces ``tools/vpu_bench.py:matmul_kernel``)."""
    dev = _cuda_device(a)
    k = a.shape[1] if a.dim() == 2 else 0
    if not 1 <= k <= 128:
        raise ValueError(f"a has shape {tuple(a.shape)}, expected (512, k), 1 <= k <= 128")
    _require(a, "a", torch.float32, (512, k), dev)
    _require(b, "b", torch.float32, (k, 1024), dev)
    _check_iters(iters)
    out = torch.empty((512, 1024), dtype=torch.float32, device=dev)
    err = LIBRARY.get().mcrt_vpu_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), k, iters,
                                        _stream(dev))
    vpu_matmul.launches += 1
    _check_launch(err, "K9 vpu_matmul")
    return out


WRAPPERS = {"K1": cull, "K2": closest, "K3": occluded, "K4": dense_closest,
            "K5": dense_any, "K6": closest2, "K7": occluded2, "K8": vpu_chain,
            "K9": vpu_matmul}
for _w in WRAPPERS.values():
    _w.launches = 0


def reset_launch_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {k: w.launches for k, w in WRAPPERS.items()}
