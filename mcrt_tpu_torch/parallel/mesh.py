"""Process groups, the (spp, rays) device mesh and each rank's share of
it (counterpart of ``mcrt_tpu/parallel/mesh.py``).

The renderer's two data axes map onto a 2-D
``torch.distributed.device_mesh.DeviceMesh``:

- ``"spp"``: samples per pixel split over ranks; the spp mean becomes an
  ``all_reduce`` over the axis's group;
- ``"rays"``: the Morton-ordered trace slots (or, under the ray ring, the
  rays of each query) split over ranks; the image is assembled with an
  ``all_gather`` over the axis's group.

The JAX package states shardings (``replicated``, ``rays_sharding``,
``spp_rays_sharding``) and lets GSPMD insert the collectives.  Here every
rank runs the same Python: ``spp_share`` and ``rays_share`` give a rank
its frames and its range of trace slots, and plain collectives over
``mesh.get_group(axis)`` do the rest.  Scene and accel are replicated,
except under the ring (``parallel/ring.py``), where each rank holds one
shard of the faces' accel.

One rank per device.  On the card the backend is NCCL (NCCL refuses two
ranks on one card); on the CPU it is gloo.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SPP_AXIS = "spp"
RAYS_AXIS = "rays"


def init_process_group(device=None, init_method: str | None = None,
                       rank: int | None = None, world_size: int | None = None
                       ) -> torch.device:
    """Start the default process group and return this rank's device.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; ``init_method`` to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``), or pass a store such as ``file:///tmp/x``.  On the
    card (the default) the rank takes the card ``LOCAL_RANK`` (else its
    rank) with ``torch.cuda.set_device`` before any tensor is made, and the
    group is NCCL; where ``device`` names the CPU the group is gloo."""
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    kw = {}
    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass device=\"cpu\" to run "
                               "the ranks on the CPU (gloo)")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        backend, dev = "nccl", torch.device("cuda", local)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kw)
    return dev


def make_mesh(n_spp: int | None = None, n_rays: int | None = None,
              device=None) -> DeviceMesh:
    """An (spp, rays) mesh over every rank of the default process group
    (which must be started, ``init_process_group``).  With no shape given,
    every rank goes to the rays axis, the JAX package's default; the
    product of the two sizes must be the world size.  ``device`` names the
    ranks' device type: the card unless the caller names the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "parallel.mesh.init_process_group first")
    n = dist.get_world_size()
    if n_spp is None and n_rays is None:
        n_spp, n_rays = 1, n
    elif n_spp is None:
        n_spp = n // n_rays
    elif n_rays is None:
        n_rays = n // n_spp
    if n_spp * n_rays != n:
        raise ValueError(f"mesh ({n_spp}, {n_rays}) does not hold the {n} ranks")
    device_type = "cpu" if device is not None and torch.device(device).type == "cpu" \
        else "cuda"
    return init_device_mesh(device_type, (n_spp, n_rays),
                            mesh_dim_names=(SPP_AXIS, RAYS_AXIS))


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself; raises ``TypeError`` unless it is an (spp, rays)
    ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != (SPP_AXIS, RAYS_AXIS):
        raise TypeError(f"expected a DeviceMesh with dimensions ({SPP_AXIS!r}, "
                        f"{RAYS_AXIS!r}) from make_mesh, got {mesh!r}")
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks on ``axis`` of ``mesh``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def spp_share(mesh: DeviceMesh, frames) -> list[int]:
    """This rank's frames: its contiguous S / n_spp of ``frames``."""
    frames = [int(f) for f in frames]
    n = axis_size(mesh, SPP_AXIS)
    if len(frames) % n:
        raise ValueError(f"{len(frames)} samples do not divide over the {n} ranks of the "
                         f"{SPP_AXIS!r} axis")
    per = len(frames) // n
    i = mesh.get_local_rank(SPP_AXIS)
    return frames[i * per:(i + 1) * per]


def rays_share(mesh: DeviceMesh, n: int) -> tuple[int, int]:
    """This rank's contiguous range [lo, hi) of ``n`` rays or trace slots
    on the rays axis."""
    k = axis_size(mesh, RAYS_AXIS)
    if n % k:
        raise ValueError(f"{n} rays do not divide over the {k} ranks of the "
                         f"{RAYS_AXIS!r} axis")
    per = n // k
    j = mesh.get_local_rank(RAYS_AXIS)
    return j * per, (j + 1) * per


def _rank_main(rank, fn, world_size, init_method, device, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    init_process_group(device, init_method, rank, world_size)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args=(), device=None, init_method: str = "",
                timeout: float = 600.0):
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes
    (``torch.multiprocessing``'s ``spawn`` start method), each a rank of a
    process group started by ``init_process_group(device, init_method,
    rank, world_size)``; on the card rank r takes card r.  ``fn`` must be
    importable by name.  If a rank fails, the others are stopped and the
    first failure's traceback is raised (``ProcessRaisedException``); if
    ``timeout`` seconds pass, every rank is stopped and ``RuntimeError``
    raised."""
    if not init_method:
        raise ValueError("spawn_ranks needs an init_method, e.g. file://<fresh path>")
    device = "cuda" if device is None else device
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world_size, init_method, device, args), nprocs=world_size,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
