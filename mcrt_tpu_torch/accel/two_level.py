"""Two-level (instanced) intersection (counterpart of
``mcrt_tpu/accel/two_level.py``): shared object-space BLASes plus
per-instance transforms, traversed by one list-driven walk.

The product of instances and BLAS blocks is flattened into a table of
(instance, block) pairs, each with the world-space box of that instance's
transformed block.  The flat engine's cull (kernel K1) and visit-list sort
then run unchanged over the pair boxes, giving per-tile front-to-back pair
lists, so cull and walk cost scale with the pairs entered, not with the
instances that exist.  The walk (kernel K6 closest hit / K7 any hit,
``csrc/two_level.cu``) is K2/K3's (the fused prefilter, the per-warp skip,
here of pairs whose box ``pair_aabb`` no lane enters, and ``cp.async``
staging), held to its plain version within the same stated tolerance.  It
differs per visit: it decodes (block, instance) from the pair code and
transforms the block's p0/e1/e2 rows to world space by the instance's 3x4
``tw_rows`` (``_world_rows``' arithmetic, bit for bit) before testing the
untransformed world rays, so t needs no rescaling.

The host build (``build_two_level``, ``build_two_level_scene``) is the JAX
package's numpy code, so both packages build identical tables.  Beside
each kernel is its plain PyTorch version (``closest2_plain``,
``occluded2_plain``), taken only for CPU tensors.  A hit reports the
instance's shape id (identity instances of free geometry report -1, and
the hit's shape then comes from the face table).  ``refit_two_level``
and ``refit_two_level_scene`` move the instances without a rebuild: they
keep the BLAS and the pair decomposition and recompute, in torch ops on
the accel's device, the instance matrices, the world rows ``tw_rows`` the
walks read and the pair boxes.  ``intersect_two_level_loop`` and
``occluded_two_level_loop`` are the JAX package's conformance oracle of
K6/K7: the flat blocked queries (K1-K3 on the card) run once an instance
on rays moved into its object space.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.math import inverse3
from ..core.types import F32_MAX, Hit, Rays, TensorRecord
from ..scene.scene import Geometry, take_clip
from ..utils.profiling import span
from . import kernels
from .blocked import (BIG, BLOCK, GROUP, TILE, BlockedAccel, _kernel_or_plain, _sorted_table,
                      _unsort, _walk_plain, build_blocked, chunk_union, cull_plain,
                      intersect_blocked, lists_from_keys, occluded_blocked)

INST_BITS = 12  # pair code = (block << INST_BITS) | instance
MAX_INSTANCES = 1 << INST_BITS


@dataclass
class TwoLevelAccel(TensorRecord):
    """Shared BLAS table, instance table and the flattened pairs."""

    blas: BlockedAccel  # object-space blocked accel (BLAS tables concatenated)
    world_to_object: torch.Tensor  # (I, 4, 4)
    tw_rows: torch.Tensor  # (I*12,) to_world rows, row-major 3x4
    shape_id: torch.Tensor  # (I,) i32 shape id reported for hits
    pair_aabb: torch.Tensor  # (Ppad, 8) world box per (instance, block) pair
    pair_chunk: torch.Tensor  # (Ppad//128, 8) cull-chunk union boxes
    pair_code: torch.Tensor  # (Ppad,) i32 (block << INST_BITS) | instance
    bounds: torch.Tensor  # (2, 3) world scene bounds (ray coherence key)
    num_instances: int
    num_pairs: int


def _pair_table(plo, phi, code):
    """(pair_aabb, pair_code) padded to a multiple of 128 pairs with
    NaN-poisoned boxes."""
    p = plo.shape[0]
    ppad = max(128, -(-p // 128) * 128)
    pair_aabb = np.full((ppad, 8), np.nan, np.float32)
    pair_aabb[:, 6:8] = 0.0
    pair_aabb[:p, 0:3] = plo
    pair_aabb[:p, 3:6] = phi
    pair_code = np.zeros((ppad,), np.int32)
    pair_code[:p] = code.astype(np.int32)
    return pair_aabb, pair_code


def _accel(blas, tw, shape_ids, plo, phi, code, device) -> TwoLevelAccel:
    n_inst = tw.shape[0]
    if n_inst > MAX_INSTANCES:
        raise ValueError(f"two-level supports <= {MAX_INSTANCES} instances")
    pair_aabb, pair_code = _pair_table(plo, phi, code)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    pair_aabb = dev(pair_aabb)

    return TwoLevelAccel(
        blas=blas, world_to_object=dev(np.linalg.inv(tw).astype(np.float32)),
        tw_rows=dev(tw[:, :3, :4].reshape(-1)),
        shape_id=dev(np.asarray(shape_ids, np.int32)),
        pair_aabb=pair_aabb, pair_chunk=chunk_union(pair_aabb),
        pair_code=dev(pair_code),
        bounds=dev(np.stack([plo.min(0), phi.max(0)]).astype(np.float32)),
        num_instances=n_inst, num_pairs=plo.shape[0])


def build_two_level(source: Geometry, to_world: np.ndarray, shape_ids: np.ndarray,
                    cfg=None) -> TwoLevelAccel:
    """Build from one object-space source mesh and (I, 4, 4) instance
    transforms."""
    blas = build_blocked(source, cfg)
    tw = np.asarray(to_world, np.float32)
    # world box per (instance, real block): the 8 corners of the block's
    # object-space box under the instance's transform
    aabb = blas.aabb.cpu().numpy()
    nb = blas.num_blocks
    rb = np.nonzero(~np.isnan(aabb[:nb, 0]))[0]
    lo, hi = aabb[rb, 0:3], aabb[rb, 3:6]
    corners = np.stack([np.where(np.asarray(m)[None, :], hi, lo)
                        for m in np.ndindex(2, 2, 2)], axis=1)  # (B, 8, 3)
    wc = np.einsum("iab,kcb->ikca", tw[:, :3, :3], corners) + tw[:, None, None, :3, 3]
    plo = wc.min(axis=2).reshape(-1, 3)
    phi = wc.max(axis=2).reshape(-1, 3)
    code = ((rb[None, :].astype(np.int64) << INST_BITS)
            | np.arange(tw.shape[0], dtype=np.int64)[:, None]).reshape(-1)
    return _accel(blas, tw, shape_ids, plo, phi, code, source.positions.device)


def _pair_boxes(aabb: np.ndarray, block_ids: np.ndarray,
                tw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """World (lo, hi) of object-space block boxes under one transform."""
    lo, hi = aabb[block_ids, 0:3], aabb[block_ids, 3:6]
    corners = np.stack([np.where(np.asarray(m)[None, :], hi, lo)
                        for m in np.ndindex(2, 2, 2)], axis=1)  # (B, 8, 3)
    wc = np.einsum("ab,kcb->kca", tw[:3, :3], corners) + tw[:3, 3]
    return wc.min(axis=1), wc.max(axis=1)


def build_two_level_scene(geom: Geometry, shape_to_world, instances,
                          cfg=None) -> TwoLevelAccel:
    """Multi-BLAS two-level build of a scene in which several instanced
    meshes and free (non-instanced) geometry coexist.

    One blocked BLAS per instanced source mesh (its face range of the
    global table) plus one BLAS of all free faces; their triangle tables are
    concatenated into one (16, NT) table, so a pair code's block id also
    names its BLAS.  Instances: one identity instance per BLAS (free
    geometry and each source render as they are, reporting shape -1) and
    one per ``add_instanced`` shape (reporting its shape id)."""
    device = geom.positions.device
    tw_all = np.asarray(torch.as_tensor(shape_to_world).cpu(), np.float32)  # (S, 4, 4)
    inst_shape_np = instances.shape.cpu().numpy().astype(np.int32)
    ranges = list(zip(instances.face_lo, instances.face_hi))
    n_faces = int(geom.indices.shape[0])
    face_valid = geom.face_valid.cpu().numpy()

    by_src: dict[tuple[int, int], list[int]] = {}
    for k, r in enumerate(ranges):
        by_src.setdefault(r, []).append(k)
    src_mask = np.zeros((n_faces,), bool)
    for lo, hi in by_src:
        src_mask[lo:hi] = True
    free_mask = face_valid & ~src_mask

    # each BLAS is built on a face_valid-masked view of the FULL geometry,
    # so that slot_prim stays a global primitive id
    def masked(mask):
        return build_blocked(geom.replace(face_valid=torch.from_numpy(mask).to(device)), cfg)

    blas_list = []
    if free_mask.any():
        blas_list.append(("free", masked(free_mask)))
    src_blas: dict[tuple[int, int], int] = {}
    for r in by_src:
        mask = np.zeros((n_faces,), bool)
        mask[r[0]:r[1]] = True
        src_blas[r] = len(blas_list)
        blas_list.append((r, masked(mask & face_valid)))

    # concatenate the BLAS tables; block offsets identify the BLAS
    tris, slots, aabbs, offsets = [], [], [], []
    off = 0
    for _, b in blas_list:
        offsets.append(off)
        tris.append(b.tri.cpu().numpy())
        slots.append(b.slot_prim.cpu().numpy())
        aabbs.append(b.aabb.cpu().numpy()[:b.num_blocks])
        off += b.num_blocks
    tri = np.concatenate(tris, axis=1)
    slot_prim = np.concatenate(slots)
    nbpad = max(128, -(-off // 128) * 128)
    aabb = np.full((nbpad, 8), np.nan, np.float32)
    aabb[:, 6:8] = 0.0
    aabb[:off] = np.concatenate(aabbs, axis=0)

    # instance table: identity per BLAS (shape -1), then the real instances
    ident = np.eye(4, dtype=np.float32)
    inst_tw = [ident] * len(blas_list)
    inst_sid = [-1] * len(blas_list)
    inst_blas = list(range(len(blas_list)))
    for k, r in enumerate(ranges):
        inst_tw.append(tw_all[int(inst_shape_np[k])])
        inst_sid.append(int(inst_shape_np[k]))
        inst_blas.append(src_blas[r])
    if len(inst_tw) > MAX_INSTANCES:
        raise ValueError(f"two-level supports <= {MAX_INSTANCES} instances")
    tw_inst = np.stack(inst_tw)

    # pairs: every instance x the real blocks of its BLAS
    plos, phis, codes = [], [], []
    for i in range(len(inst_tw)):
        b = blas_list[inst_blas[i]][1]
        ba = b.aabb.cpu().numpy()[:b.num_blocks]
        gids = np.nonzero(~np.isnan(ba[:, 0]))[0] + offsets[inst_blas[i]]
        lo, hi = _pair_boxes(aabb, gids, tw_inst[i])
        plos.append(lo)
        phis.append(hi)
        codes.append((gids.astype(np.int64) << INST_BITS) | i)
    plo, phi, code = np.concatenate(plos), np.concatenate(phis), np.concatenate(codes)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    aabb = dev(aabb)
    merged = BlockedAccel(
        tri=dev(tri), aabb=aabb, slot_prim=dev(slot_prim),
        bounds=dev(np.stack([plo.min(0), phi.max(0)])),
        chunk_aabb=chunk_union(aabb), num_blocks=off,
        builder=blas_list[0][1].builder)
    return _accel(merged, tw_inst, inst_sid, plo, phi, code, device)


def affine_inverse(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) inverses of affine transforms (last row 0 0 0 1):
    ``R^-1`` by ``inverse3`` and the translation ``-R^-1 t``.  The
    two-level engine reads only the 3x4 part of a transform, as the kernels
    do, so instance transforms are affine."""
    inv = inverse3(m[..., :3, :3])
    t = m[..., :3, 3]
    t_inv = -(inv[..., 0] * t[..., 0:1] + inv[..., 1] * t[..., 1:2] + inv[..., 2] * t[..., 2:3])
    bottom = torch.zeros_like(m[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([inv, t_inv[..., None]], dim=-1), bottom], dim=-2)


def refit_two_level(accel: TwoLevelAccel, to_world: torch.Tensor) -> TwoLevelAccel:
    """Instance-transform refit: new world-to-object matrices, world rows
    ``tw_rows`` (which K6/K7 read: without them a frame would show the old
    poses), pair boxes, chunk boxes and bounds from new (I, 4, 4)
    transforms, keeping the BLAS and the pair decomposition (the JAX
    package's ``refit_two_level``).  A pair's box is the union of its
    object-space block box's 8 corners under the instance's transform,
    each corner ``((r0 x + r1 y) + r2 z) + t`` without fused multiply-add,
    so the card and the CPU give the same bits."""
    tw = to_world.to(device=accel.pair_code.device, dtype=torch.float32)
    code = accel.pair_code.long()
    ppad = code.shape[0]
    valid = (torch.arange(ppad, device=code.device) < accel.num_pairs)[:, None]
    ob = accel.blas.aabb[code >> INST_BITS]  # (P, 8) object-space block boxes
    m = tw[code & (MAX_INSTANCES - 1)]  # (P, 4, 4)
    k = torch.arange(8, device=code.device)[:, None]
    upper = ((k >> (2 - torch.arange(3, device=code.device))) & 1).bool()  # (8, 3) corner bits
    corners = torch.where(upper, ob[:, None, 3:6], ob[:, None, 0:3])  # (P, 8, 3)
    prod = m[:, None, :3, :3] * corners[:, :, None, :]  # (P, 8, 3 rows, 3)
    wc = prod[..., 0] + prod[..., 1] + prod[..., 2] + m[:, None, :3, 3]  # (P, 8, 3)
    plo, phi = wc.amin(dim=1), wc.amax(dim=1)
    nan = float("nan")
    pair_aabb = torch.cat([torch.where(valid, plo, nan), torch.where(valid, phi, nan),
                           torch.zeros((ppad, 2), dtype=torch.float32, device=code.device)],
                          dim=1)
    bounds = torch.stack([torch.where(valid, plo, BIG).amin(dim=0),
                          torch.where(valid, phi, -BIG).amax(dim=0)])
    return accel.replace(world_to_object=affine_inverse(tw),
                         tw_rows=tw[:, :3, :4].reshape(-1), pair_aabb=pair_aabb,
                         pair_chunk=chunk_union(pair_aabb), bounds=bounds)


def refit_two_level_scene(accel: TwoLevelAccel, scene) -> TwoLevelAccel:
    """Refit after instance-transform edits of a scene: each instance's
    transform is gathered from ``scene.shapes.to_world`` (the identity
    instances of free geometry and source meshes stay fixed)."""
    sid = accel.shape_id.long()
    live = take_clip(scene.shapes.to_world, sid.clamp_min(0))
    ident = torch.eye(4, dtype=torch.float32, device=live.device)
    return refit_two_level(accel, torch.where((sid >= 0)[:, None, None], live, ident))


# --------------------------------------------------------------------------
# Plain versions of K6/K7 (used only for CPU tensors)
# --------------------------------------------------------------------------


def _world_rows(tri9, m):
    """World-space triangle rows from object-space ones (each (A, W)) under
    per-column 3x4 rows ``m`` (A, W, 12), in the kernels' order of
    operations: p0' = R p0 + t, e1' = R e1, e2' = R e2."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    r = [m[..., j] for j in range(12)]
    return [r[0] * p0x + r[1] * p0y + r[2] * p0z + r[3],
            r[4] * p0x + r[5] * p0y + r[6] * p0z + r[7],
            r[8] * p0x + r[9] * p0y + r[10] * p0z + r[11],
            r[0] * e1x + r[1] * e1y + r[2] * e1z,
            r[4] * e1x + r[5] * e1y + r[6] * e1z,
            r[8] * e1x + r[9] * e1y + r[10] * e1z,
            r[0] * e2x + r[1] * e2y + r[2] * e2z,
            r[4] * e2x + r[5] * e2y + r[6] * e2z,
            r[8] * e2x + r[9] * e2y + r[10] * e2z]


def pair_rows(tri: torch.Tensor, pair_code: torch.Tensor, tw_rows: torch.Tensor):
    """The walk's group loader for pair lists: visit-list entries (A, G)
    are pair ids -> world-space triangle rows (A, G*128, 1), slot ids and
    instance ids (A, G*128).  Block and instance are clamped into their
    tables, as the kernels do."""
    nt_blocks = tri.shape[1] // BLOCK
    tw = tw_rows.reshape(-1, 12)
    lanes = torch.arange(BLOCK, device=tri.device)

    def rows(ent):
        code = pair_code[ent]  # (A, G)
        blk = (code >> INST_BITS).clamp(max=nt_blocks - 1).to(torch.int64)
        inst = (code & (MAX_INSTANCES - 1)).clamp(max=tw.shape[0] - 1).to(torch.int64)
        cols = (blk[:, :, None] * BLOCK + lanes).reshape(ent.shape[0], -1)
        who = inst.repeat_interleave(BLOCK, dim=1)  # (A, G*128)
        world = _world_rows([tri[c][cols] for c in range(9)], tw[who])
        return [w[:, :, None] for w in world], cols, who

    return rows


def closest2_plain(counts, rays_packed, lists, tn_sorted, tri, pair_code, tw_rows,
                   tile: int = TILE, group: int = GROUP):
    """Plain version of K6: (Npad,) best t (BIG on a miss), slot and
    instance (-1 on a miss)."""
    return _walk_plain(counts, rays_packed, lists, tn_sorted,
                       pair_rows(tri, pair_code, tw_rows), tile, group, closest=True)


def occluded2_plain(counts, rays_packed, lists, tri, pair_code, tw_rows,
                    tile: int = TILE, group: int = GROUP):
    """Plain version of K7: (Npad,) 1.0 where blocked, else 0.0."""
    return _walk_plain(counts, rays_packed, lists, None,
                       pair_rows(tri, pair_code, tw_rows), tile, group, closest=False)


# --------------------------------------------------------------------------
# Queries
# --------------------------------------------------------------------------


def pair_lists(rays_packed, accel: TwoLevelAccel):
    """Front-to-back pair visit lists (K1 over the pair boxes, then the
    per-tile sort): counts, lists, tn_sorted."""
    cull = _kernel_or_plain(rays_packed, kernels.cull, cull_plain)
    with span("mcrt.query.cull"):
        return lists_from_keys(cull(rays_packed, accel.pair_chunk, accel.pair_aabb, TILE))


def _query2_closest(rays_packed, accel: TwoLevelAccel):
    rays_packed = rays_packed.detach()  # no gradient through the query
    counts, lists, tn_sorted = pair_lists(rays_packed, accel)
    args = (accel.blas.tri, accel.pair_code, accel.tw_rows)
    with span("mcrt.query.walk"):
        if rays_packed.device.type == "cpu":  # as _kernel_or_plain; K6 also takes the boxes
            return closest2_plain(counts, rays_packed, lists, tn_sorted, *args, TILE, GROUP)
        return kernels.closest2(counts, rays_packed, lists, tn_sorted, *args,
                                accel.pair_aabb, TILE, GROUP)


def _query2_any(rays_packed, accel: TwoLevelAccel):
    rays_packed = rays_packed.detach()
    counts, lists, _ = pair_lists(rays_packed, accel)
    args = (accel.blas.tri, accel.pair_code, accel.tw_rows)
    with span("mcrt.query.walk"):
        if rays_packed.device.type == "cpu":
            return occluded2_plain(counts, rays_packed, lists, *args, TILE, GROUP)
        return kernels.occluded2(counts, rays_packed, lists, *args, accel.pair_aabb, TILE,
                                 GROUP)


def _object_rays(rays: Rays, m: torch.Tensor) -> Rays:
    """The rays under the affine ``m``: one (4, 4) for all rays or one
    (N, 4, 4) per ray.  Directions keep their length, so an object-space t
    is the world-space t."""
    r = m[..., :3, :3]
    return rays.replace(o=(r * rays.o[:, None, :]).sum(-1) + m[..., :3, 3],
                        d=(r * rays.d[:, None, :]).sum(-1))


def _resolve_uv2(accel: TwoLevelAccel, slot, inst, rays: Rays):
    """Barycentrics of each ray's winning (slot, instance), from the ray in
    the instance's object space."""
    obj = _object_rays(rays, take_clip(accel.world_to_object, inst.clamp_min(0)))
    o, d = obj.o, obj.d
    cols = accel.blas.tri[:, slot.clamp_min(0).long()]  # (16, N)
    p0, e1, e2 = cols[0:3].T, cols[3:6].T, cols[6:9].T
    pv = torch.linalg.cross(d, e2, dim=-1)
    det = torch.sum(e1 * pv, dim=1)
    inv = torch.where(torch.abs(det) > 1e-12,
                      1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tv = o - p0
    u = torch.sum(tv * pv, dim=1) * inv
    qv = torch.linalg.cross(tv, e1, dim=-1)
    v = torch.sum(d * qv, dim=1) * inv
    return u.clamp(0.0, 1.0), v.clamp(0.0, 1.0)


def intersect_two_level(source: Geometry, accel: TwoLevelAccel, rays: Rays,
                        sort: bool = True) -> Hit:
    """Closest hit over all instances; ``shape`` is the instance's shape id
    (or the face table's for free geometry), ``prim`` indexes the shared
    global face table.  ``sort=False`` hands the cull and the walk the rays
    in their given order (the coherence sort only speeds them up)."""
    n = rays.n
    packed, order = _sorted_table(rays, accel, sort)
    t, slot, inst = _query2_closest(packed, accel)
    with span("mcrt.query.resolve"):
        t, slot, inst = (_unsort(a, order, n) for a in (t, slot, inst))
        found = slot >= 0
        u, v = _resolve_uv2(accel, slot, inst, rays)
        u = torch.where(found, u, 0.0)
        v = torch.where(found, v, 0.0)
        prim = torch.where(found, take_clip(accel.blas.slot_prim, slot.clamp_min(0)), -1)
        valid = found & rays.active
        inst_shape = take_clip(accel.shape_id, inst.clamp_min(0))
        face_sh = take_clip(source.face_shape, prim.clamp_min(0))
        shape = torch.where(valid, torch.where(inst_shape >= 0, inst_shape, face_sh), -1)
        return Hit(t=torch.where(valid, t, F32_MAX), prim=prim.to(torch.int32),
                   shape=shape.to(torch.int32), u=u, v=v, valid=valid)


def occluded_two_level(source: Geometry, accel: TwoLevelAccel, rays: Rays,
                       sort: bool = True) -> torch.Tensor:
    """Any-hit query over all instances: (N,) bool, True where blocked."""
    packed, order = _sorted_table(rays, accel, sort)
    out = _query2_any(packed, accel)
    with span("mcrt.query.resolve"):
        return (_unsort(out, order, rays.n) > 0.0) & rays.active


# --------------------------------------------------------------------------
# The per-instance loop oracle: the flat blocked queries (K1-K3 on the card)
# on the shared BLAS, once per instance, with the rays moved into the
# instance's object space.  It holds for an accel of one BLAS
# (``build_two_level``, or ``build_two_level_scene`` of a scene whose faces
# all belong to one source mesh): the queries walk every block of
# ``accel.blas`` under each instance.
# --------------------------------------------------------------------------


def intersect_two_level_loop(source: Geometry, accel: TwoLevelAccel, rays: Rays) -> Hit:
    """Closest hit over the instances, one flat query each: a ray's
    ``tmax`` is clipped to its best t so far, and a later instance wins
    only at a smaller t."""
    n, dev = rays.n, rays.o.device
    best = Hit.none(n, dev)
    for i in range(accel.num_instances):
        r_obj = _object_rays(rays, accel.world_to_object[i])
        r_obj = r_obj.replace(tmax=torch.minimum(r_obj.tmax, best.t))
        h = intersect_blocked(source, accel.blas, r_obj)
        better = h.valid & (h.t < best.t)
        sid = torch.where(accel.shape_id[i] >= 0, accel.shape_id[i], h.shape)
        best = Hit(t=torch.where(better, h.t, best.t),
                   prim=torch.where(better, h.prim, best.prim),
                   shape=torch.where(better, sid, best.shape),
                   u=torch.where(better, h.u, best.u),
                   v=torch.where(better, h.v, best.v),
                   valid=best.valid | better)
    return best


def occluded_two_level_loop(source: Geometry, accel: TwoLevelAccel,
                            rays: Rays) -> torch.Tensor:
    """Any-hit query over the instances, one flat query each; a ray blocked
    by one instance is inactive for the rest."""
    blocked = torch.zeros((rays.n,), dtype=torch.bool, device=rays.o.device)
    for i in range(accel.num_instances):
        b = occluded_blocked(source, accel.blas, _object_rays(rays, accel.world_to_object[i]))
        rays = rays.replace(active=rays.active & ~b)
        blocked = blocked | b
    return blocked
