"""Sharded-scene intersection with a ray ring (counterpart of
``mcrt_tpu/parallel/ring.py``).

The per-face tables are split into one Morton-contiguous shard per rank
of the mesh's ``rays`` axis, and rays travel to the data: each ring step
intersects the resident block of rays against the local shard (the
blocked queries, K1-K3 on a list-path shard, K4/K5 on a shard of at most
8 blocks; or, with ``use_blocked=False``, the brute-force oracle over the
shard's faces, whose accel is ``ShardedFaces``), merges into the running
closest hit, then sends (rays, best hit) to the next rank and receives
the previous rank's.  After
``n_shards`` steps every block of rays has met every shard and is home.
Vertex and face tables stay whole on every rank for shading; only the
accel is split, and each rank holds its own shard's.

The JAX package writes this as a ``shard_map`` region that takes global
rays and gives global hits; the port keeps those semantics with explicit
collectives: each rank takes its rays-axis slice of the rays it is given,
coherence-sorts it once with the global bounds (the blocked variant
only), runs the ring, unsorts,
and ``all_gather``s the hits over the rays group.  The exchange packs
each block into one float32 and one int32 tensor (NCCL has no bool) and
posts the send and the receive together (``dist.batch_isend_irecv``); a
blocking send before a receive would deadlock the ring.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..accel import Intersector
from ..accel.brute import intersect_brute, occluded_brute
from ..accel.blocked import (BLOCK, BlockedAccel, _coherence_order, _morton_u32,
                             _resolve_uv, build_blocked, intersect_blocked,
                             occluded_blocked)
# F32_MAX stays a name of this module, as of the JAX ring
from ..core.types import F32_MAX, Hit, Rays, TensorRecord  # noqa: F401
from ..scene.scene import FA_LIGHT, FA_MAT, Geometry, take_clip
from .mesh import RAYS_AXIS, axis_size, check_mesh


def shard_faces(geom: Geometry, n_shards: int, return_face_map: bool = False):
    """Partition the per-face tables into ``n_shards`` equal blocks in
    Morton order over the centroids (the blocked build's key), padded to a
    common size; vertex tables are kept whole.  Shard i owns rows
    [i*Fpad, (i+1)*Fpad); ``face_valid`` is False on padding, whose
    material and light ids are -1.  ``return_face_map`` also returns the
    (F_old,) old-to-new face index map (numpy int64, -1 for padding)."""
    idx = geom.indices.cpu().numpy()
    valid = geom.face_valid.cpu().numpy()
    pos = geom.positions.cpu().numpy()
    real = np.nonzero(valid)[0]
    tri = idx[real]
    cent = (pos[tri[:, 0]] + pos[tri[:, 1]] + pos[tri[:, 2]]) / 3.0
    lo = cent.min(0)
    span = np.maximum(cent.max(0) - lo, 1e-12)
    order = real[np.argsort(_morton_u32((cent - lo) / span), kind="stable")]

    n = len(order)
    fpad = max(1, -(-n // n_shards))
    total = n_shards * fpad
    sel = np.zeros((total,), np.int64)
    ok = np.zeros((total,), bool)
    sel[:n] = order
    ok[:n] = True
    new_attrs = geom.face_attrs.cpu().numpy()[sel]
    new_attrs[~ok, FA_MAT] = -1.0
    new_attrs[~ok, FA_LIGHT] = -1.0
    shape = geom.face_shape.cpu().numpy()[sel]
    device = geom.indices.device
    out = geom.replace(
        indices=torch.from_numpy(np.ascontiguousarray(idx[sel])).to(device),
        face_shape=torch.from_numpy(np.where(ok, shape, -1).astype(np.int32)).to(device),
        face_valid=torch.from_numpy(ok).to(device),
        face_attrs=torch.from_numpy(new_attrs).to(device),
    )
    if not return_face_map:
        return out
    face_map = np.full((idx.shape[0],), -1, np.int64)
    face_map[sel[:n]] = np.arange(n)
    return out, face_map


def _shard_rows(geom: Geometry, s: int, fpad: int) -> Geometry:
    """Shard ``s``'s face rows of the sharded geometry (vertex tables
    whole)."""
    rows = slice(s * fpad, (s + 1) * fpad)
    return geom.replace(indices=geom.indices[rows], face_shape=geom.face_shape[rows],
                        face_valid=geom.face_valid[rows], face_attrs=geom.face_attrs[rows])


@dataclass
class ShardedBlockedAccel(TensorRecord):
    """Blocked accels of face shards, padded to common shapes and stacked
    on a leading axis.  ``first`` is the shard index of row 0: a rank of
    the ring holds only its own shard (one row), a host build all of
    them.  ``bounds`` are the whole scene's (the coherence key)."""

    tri: torch.Tensor  # (k, 16, NT)
    aabb: torch.Tensor  # (k, NBpad, 8)
    chunk_aabb: torch.Tensor  # (k, NBpad / 128, 8)
    slot_prim: torch.Tensor  # (k, NT) shard-local prim ids, -1 padding
    bounds: torch.Tensor  # (2, 3)
    num_blocks: int
    first: int = 0

    def shard(self, s: int) -> BlockedAccel:
        """Shard ``s``'s blocked accel (it must be held)."""
        i = s - self.first
        if not 0 <= i < self.tri.shape[0]:
            raise IndexError(f"shard {s} is not held (shards {self.first}.."
                             f"{self.first + self.tri.shape[0] - 1})")
        return BlockedAccel(tri=self.tri[i], aabb=self.aabb[i], slot_prim=self.slot_prim[i],
                            bounds=self.bounds, chunk_aabb=self.chunk_aabb[i],
                            num_blocks=self.num_blocks)

    def held(self, s: int) -> "ShardedBlockedAccel":
        """The record of shard ``s`` alone."""
        i = s - self.first
        return self.replace(tri=self.tri[i:i + 1], aabb=self.aabb[i:i + 1],
                            chunk_aabb=self.chunk_aabb[i:i + 1],
                            slot_prim=self.slot_prim[i:i + 1], first=s)


@dataclass
class ShardedFaces(TensorRecord):
    """The accel of the ring's brute-force variant: no tables.  Each step
    tests every face of its shard (``accel/brute.py``)."""


def _build_shard_accels(geom: Geometry, n_shards: int, fpad: int, cfg=None,
                        device=None) -> ShardedBlockedAccel:
    """Host build: one blocked accel per contiguous face shard, padded to
    common shapes; padding blocks carry NaN boxes (never entered), padding
    slots degenerate triangles and prim id -1.  Tables on ``device`` (the
    geometry's by default)."""
    device = geom.positions.device if device is None else device
    accels = []
    for s in range(n_shards):
        sub = _shard_rows(geom, s, fpad)
        accels.append(build_blocked(sub, cfg, device="cpu") if bool(sub.face_valid.any())
                      else None)
    built = [a for a in accels if a is not None]
    nt = max((a.tri.shape[1] for a in built), default=BLOCK)
    nb = max((a.aabb.shape[0] for a in built), default=128)
    tris = np.zeros((n_shards, 16, nt), np.float32)
    aabbs = np.full((n_shards, nb, 8), np.nan, np.float32)
    chunks = np.full((n_shards, nb // 128, 8), np.nan, np.float32)
    slots = np.full((n_shards, nt), -1, np.int32)
    lo = np.full((3,), np.inf, np.float32)
    hi = np.full((3,), -np.inf, np.float32)
    for s, a in enumerate(accels):
        if a is None:
            continue
        tris[s, :, :a.tri.shape[1]] = a.tri.numpy()
        aabbs[s, :a.aabb.shape[0]] = a.aabb.numpy()
        chunks[s, :a.chunk_aabb.shape[0]] = a.chunk_aabb.numpy()
        slots[s, :a.slot_prim.shape[0]] = a.slot_prim.numpy()
        b = a.bounds.numpy()
        lo = np.minimum(lo, b[0])
        hi = np.maximum(hi, b[1])

    def dev(x):
        return torch.from_numpy(x).to(device)

    return ShardedBlockedAccel(tri=dev(tris), aabb=dev(aabbs), chunk_aabb=dev(chunks),
                               slot_prim=dev(slots), bounds=dev(np.stack([lo, hi])),
                               num_blocks=nt // BLOCK)


def _merge_best(h: Hit, best: Hit, base_prim: int) -> Hit:
    better = h.valid & (h.t < best.t)
    return Hit(t=torch.where(better, h.t, best.t),
               prim=torch.where(better, h.prim + base_prim, best.prim),
               shape=torch.where(better, h.shape, best.shape),
               u=torch.where(better, h.u, best.u),
               v=torch.where(better, h.v, best.v),
               valid=best.valid | better)


def closest_step(geom: Geometry, accel: ShardedBlockedAccel | ShardedFaces, s: int,
                 fpad: int, rays: Rays, best: Hit) -> Hit:
    """One ring step of the closest-hit query: the (sorted) rays against
    shard ``s``, merged into ``best`` with prim ids rebased to the sharded
    face tables."""
    sub = _shard_rows(geom, s, fpad)
    if isinstance(accel, ShardedFaces):
        h = intersect_brute(sub, rays)
    else:
        h = intersect_blocked(sub, accel.shard(s), rays, sort=False)
    return _merge_best(h, best, s * fpad)


def occluded_step(geom: Geometry, accel: ShardedBlockedAccel | ShardedFaces, s: int,
                  fpad: int, rays: Rays, blocked: torch.Tensor):
    """One ring step of the any-hit query: (rays with the lanes now
    blocked deactivated, blocked so far)."""
    sub = _shard_rows(geom, s, fpad)
    if isinstance(accel, ShardedFaces):
        b = occluded_brute(sub, rays)
    else:
        b = occluded_blocked(sub, accel.shard(s), rays, sort=False)
    return rays.replace(active=rays.active & ~b), blocked | b


def _resolve_hit_uv(geom: Geometry, rays: Rays, hit: Hit) -> Hit:
    """``hit`` with u, v resolved again on the caller's ``rays`` from the
    sharded face tables.  The ring's exchange carries no graph, so this
    puts back what the replicated query's ``_resolve_uv`` gives: u, v
    differentiable in the rays (a bounce's origin depends on the scene's
    parameters), constant in the vertex positions, as its accel's
    triangle rows are."""
    pos = geom.positions.detach()
    idx = take_clip(geom.indices, hit.prim.clamp_min(0))
    p0, p1, p2 = (take_clip(pos, idx[:, k]) for k in range(3))
    tri = torch.cat([p0.T, (p1 - p0).T, (p2 - p0).T])
    u, v = _resolve_uv(tri, torch.arange(rays.n, device=tri.device), rays)
    return hit.replace(u=torch.where(hit.valid, u, 0.0), v=torch.where(hit.valid, v, 0.0))


def _take(rec, idx):
    """The record with every tensor field indexed by ``idx``."""
    return rec.replace(**{k: getattr(rec, k)[idx] for k in rec.__dataclass_fields__
                          if isinstance(getattr(rec, k), torch.Tensor)})


def _unsort(rec, order: torch.Tensor):
    """The record in the order before ``rec = _take(rec0, order)``."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return _take(rec, inv)


_HIT_F, _HIT_I = ("t", "u", "v"), ("prim", "shape", "valid")


def _pack(rays: Rays | None, hit, blocked=None):
    """(float32 (n, k), int32 (n, j)) of the rays, the hit and the blocked
    flags given."""
    fl, it = [], []
    if rays is not None:
        fl += [rays.o, rays.d, rays.tmin[:, None], rays.tmax[:, None]]
        it.append(rays.active[:, None])
    if hit is not None:
        fl += [getattr(hit, k)[:, None] for k in _HIT_F]
        it += [getattr(hit, k)[:, None] for k in _HIT_I]
    if blocked is not None:
        it.append(blocked[:, None])
    f = torch.cat([x.detach().float() for x in fl], dim=1)
    i = torch.cat([x.to(torch.int32) for x in it], dim=1)
    return f, i


def _unpack(f, i, with_rays: bool, with_hit: bool, with_blocked: bool):
    """(rays, hit, blocked) from ``_pack``'s columns (None where absent)."""
    rays = hit = blocked = None
    fc = ic = 0
    if with_rays:
        rays = Rays(o=f[:, 0:3], d=f[:, 3:6], tmin=f[:, 6], tmax=f[:, 7], active=i[:, 0] != 0)
        fc, ic = 8, 1
    if with_hit:
        hit = Hit(t=f[:, fc], u=f[:, fc + 1], v=f[:, fc + 2], prim=i[:, ic],
                  shape=i[:, ic + 1], valid=i[:, ic + 2] != 0)
        ic += 3
    if with_blocked:
        blocked = i[:, ic] != 0
    return rays, hit, blocked


class _Ring:
    """The rays axis's group, as the ring sees it."""

    def __init__(self, mesh):
        self.group = mesh.get_group(RAYS_AXIS)
        self.size = axis_size(mesh, RAYS_AXIS)
        self.me = mesh.get_local_rank(RAYS_AXIS)

    def local(self, rays: Rays) -> Rays:
        n = rays.n
        if n % self.size:
            raise ValueError(f"{n} rays do not divide over the {self.size} ranks of the "
                             f"{RAYS_AXIS!r} axis")
        per = n // self.size
        return _take(rays, slice(self.me * per, (self.me + 1) * per))

    def rotate(self, *tensors):
        """Send ``tensors`` to the next rank of the ring and return the
        previous rank's (the identity on a ring of one)."""
        if self.size == 1:
            return tensors
        nxt = dist.get_global_rank(self.group, (self.me + 1) % self.size)
        prv = dist.get_global_rank(self.group, (self.me - 1) % self.size)
        out = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, o in zip(tensors, out):
            ops += [dist.P2POp(dist.isend, t.contiguous(), nxt, self.group),
                    dist.P2POp(dist.irecv, o, prv, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(out)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated in rank order."""
        if self.size == 1:
            return t
        pieces = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(pieces, t.contiguous(), group=self.group)
        return torch.cat(pieces)


def make_ring_intersector(mesh, n_shards: int, fpad: int,
                          accel: ShardedBlockedAccel | ShardedFaces):
    """(intersect, occluded): ``(geom, rays) -> Hit`` and ``-> (N,) bool``
    over the sharded geometry ``geom``, running the ray ring over the
    mesh's rays axis with this rank's shard of ``accel``.  Every rank of the
    axis calls them with the same global rays and gets the global
    result.  The brute variant (``ShardedFaces``) takes the rays unsorted,
    as the JAX package's does."""
    ring = _Ring(mesh)
    if ring.size != n_shards:
        raise ValueError(f"{n_shards} shards on a rays axis of {ring.size} ranks")
    me = ring.me

    def sort_order(local: Rays) -> torch.Tensor:
        if isinstance(accel, ShardedFaces):
            return torch.arange(local.n, device=local.o.device)
        return _coherence_order(local, accel.bounds)

    def ring_intersect(geom: Geometry, rays: Rays) -> Hit:
        local = ring.local(rays)
        order = sort_order(local)
        rays_s = _take(local, order)
        best = Hit.none(local.n, local.o.device)
        # as many rotations as shards: every block of rays comes home
        for _ in range(ring.size):
            best = closest_step(geom, accel, me, fpad, rays_s, best)
            f, i = ring.rotate(*_pack(rays_s, best))
            rays_s, best, _ = _unpack(f, i, True, True, False)
        f, i = _pack(None, _unsort(best, order))
        _, hit, _ = _unpack(ring.gather(f), ring.gather(i), False, True, False)
        return _resolve_hit_uv(geom, rays, hit)

    def ring_occluded(geom: Geometry, rays: Rays) -> torch.Tensor:
        local = ring.local(rays)
        order = sort_order(local)
        rays_s = _take(local, order)
        blocked = torch.zeros((local.n,), dtype=torch.bool, device=local.o.device)
        for _ in range(ring.size):
            rays_s, blocked = occluded_step(geom, accel, me, fpad, rays_s, blocked)
            f, i = ring.rotate(*_pack(rays_s, None, blocked))
            rays_s, _, blocked = _unpack(f, i, True, False, True)
        out = torch.empty_like(blocked)
        out[order] = blocked
        return ring.gather(out.to(torch.int32)) != 0

    return ring_intersect, ring_occluded


def build_sharded_scene(scene, mesh, use_blocked: bool = True):
    """Shard a scene's face tables over the mesh's rays axis; returns
    (sharded scene, ring intersector).  Every rank of the mesh calls it on
    the same scene; each keeps its own shard's accel on the scene's device
    and the whole face and vertex tables for shading.  ``use_blocked=False``
    runs the brute-force oracle over each shard's faces instead.  Mesh
    lights' ``tri_index`` is remapped to the sharded face order."""
    check_mesh(mesh)
    if scene.instances is not None:
        raise ValueError(
            "scene sharding does not support instanced scenes yet: shard "
            "faces reference world-space geometry; bake instances "
            "(SceneBuffers.add_instance) before sharding")
    n_shards = axis_size(mesh, RAYS_AXIS)
    geom, face_map = shard_faces(scene.geometry, n_shards, return_face_map=True)
    fpad = geom.indices.shape[0] // n_shards
    lights = scene.lights
    if lights.tri_index.shape[0] > 0:
        old = lights.tri_index.cpu().numpy()
        remapped = np.where(old >= 0, face_map[np.maximum(old, 0)], -1).astype(np.int32)
        lights = lights.replace(tri_index=torch.from_numpy(remapped).to(lights.tri_index.device))
    scene = scene.replace(geometry=geom, lights=lights)
    if use_blocked:
        me = mesh.get_local_rank(RAYS_AXIS)
        accel = _build_shard_accels(geom, n_shards, fpad, device="cpu").held(me).to(
            geom.positions.device)
    else:
        accel = ShardedFaces()
    intersect, occluded = make_ring_intersector(mesh, n_shards, fpad, accel)
    return scene, Intersector(intersect=lambda s, r: intersect(s.geometry, r),
                              occluded=lambda s, r: occluded(s.geometry, r),
                              accel=accel)
