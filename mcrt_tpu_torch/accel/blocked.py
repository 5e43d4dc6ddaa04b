"""Sorted-wavefront blocked intersector (counterpart of
``mcrt_tpu/accel/pallas_blocked.py``).

1. **Build** (host numpy, identical to the JAX package's): triangles are
   SAH- or Morton-ordered into fixed 128-slot blocks, stored as the
   transposed (16, NT) p0/e1/e2 table, with one AABB per block
   (NaN-poisoned when empty) and one union AABB per 128-block cull chunk.
2. **Dense path** (kernels K4 closest hit / K5 any hit) for scenes of at
   most ``DENSE_BLOCKS`` blocks: no cull, no sort, every ray tests every
   slot of the table.
3. Otherwise the **visit-list path**: **cull** (kernel K1), per ray tile,
   the entry distance of every block the tile enters (``BIG`` otherwise);
   **sort** (torch), one packed-key sort per tile into the front-to-back
   visit list; **walk** (kernels K2 closest hit / K3 any hit), each tile
   tests its list's blocks ``GROUP`` at a time with an early exit.
4. **Resolve** (torch): barycentrics for each ray's single winning slot.

While a profiler records, the stages open the spans ``mcrt.query.sort``
(the ray table, the coherence sort and the packing), ``mcrt.query.cull``
(K1 and the visit lists), ``mcrt.query.walk`` (K2/K3 or K4/K5, or their
plain versions) and ``mcrt.query.resolve`` (the unsort and the hit
record), inside the query's own span.

The kernels are CUDA C++ (``csrc/``), launched through the wrappers in
``kernels.py``.  This module holds the glue and, beside each kernel, its
plain PyTorch version (``cull_plain``, ``closest_plain``,
``occluded_plain``, ``dense_closest_plain``, ``dense_any_plain``).
``_kernel_or_plain`` picks between them by the rays' device: the plain
version only for CPU tensors, otherwise the kernel, whose wrapper launches
on a CUDA tensor or raises.  ``cull_tests``, ``walk_tests``, ``walk_work``
and ``dense_tests`` count the work on given inputs (slab and
Moller-Trumbore tests), from which a run computes each kernel's bound.
K1 and K4/K5 equal their plain versions bit for bit; K2/K3 fuse their
arithmetic and skip, per warp, blocks no ray of the warp enters, so they
are held to ``closest_plain`` / ``occluded_plain`` within a stated share
of differing rays (``chip_smoke.py``), as are the two-level K6/K7.

Intersection carries no gradient: the JAX package's queries return zero
cotangents, and ``_query_closest`` / ``_query_any`` detach the packed ray
table they hand the kernels or the plain versions, so neither route builds
a graph.  ``_resolve_uv`` runs outside them on the attached rays, as the
JAX package's runs outside its ``custom_vjp``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import BuilderType, BVHConfig
from ..core.types import F32_MAX, Hit, Rays, TensorRecord
from ..scene.scene import Geometry, take_clip
from ..utils.profiling import span
from . import kernels

BLOCK = 128  # triangles per block (the JAX package's table layout)
# rays per tile (one CTA of K2/K3, one thread per ray) and blocks staged per
# walk step.  The JAX package's TILE=256/GROUP=4 were tuned for the TPU;
# these are the port's first choice, not yet tuned on the card.
TILE = 128
GROUP = 4
BIG = 3.0e38
PACKED_KEY_MAX_BLOCKS = 4096  # the block id must fit the key's low 12 bits
DENSE_BLOCKS = 8  # scenes of at most this many blocks take the dense path


@dataclass
class BlockedAccel(TensorRecord):
    """``tri``: (16, NT) transposed p0/e1/e2 rows (rows 9..15 pad); padding
    columns are degenerate (e1=e2=0 -> det 0 -> miss).
    ``aabb``: (NBpad, 8) block lo.xyz/hi.xyz (cols 6..7 pad); empty blocks
    are NaN so every slab comparison fails.
    ``chunk_aabb``: (NBpad/128, 8) union box per 128-block cull chunk.
    ``slot_prim``: (NT,) slot -> primitive id (-1 padding).
    ``bounds``: (2, 3) scene lo/hi for the ray-coherence key.
    ``builder``: which decomposition ran ("sah", "sbvh", or "lbvh" when the
    native library was unavailable or not asked for)."""

    tri: torch.Tensor
    aabb: torch.Tensor
    slot_prim: torch.Tensor
    bounds: torch.Tensor
    chunk_aabb: torch.Tensor
    num_blocks: int
    builder: str = "sah"

    @property
    def num_slots(self) -> int:
        return self.tri.shape[1]


# --------------------------------------------------------------------------
# Build (host numpy, the JAX package's code)
# --------------------------------------------------------------------------


def _morton_u32(c01: np.ndarray) -> np.ndarray:
    """30-bit Morton code from (N, 3) coordinates in [0, 1]."""
    v = np.clip((c01 * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def expand(x):
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    return ((expand(v[:, 0]) << np.uint64(2)) | (expand(v[:, 1]) << np.uint64(1))
            | expand(v[:, 2])).astype(np.uint64)


def build_blocked(geom: Geometry, cfg: BVHConfig | None = None,
                  device=None) -> BlockedAccel:
    """Host-side build.  SAH (default): native binned-SAH leaves become
    blocks, greedily merged while they fit 128 slots; falls back to Morton
    blocks (LBVH) when the native library is unavailable, as the JAX
    package does.  LBVH: Morton-ordered triangles cut into full blocks.
    SBVH: the native spatial-split decomposition, in which a triangle that
    straddles a split is referenced from more than one block and the block
    boxes come from the plane-clipped references (``_pack_ref_blocks``);
    falls back to SAH when the native library is unavailable."""
    cfg = cfg or BVHConfig()
    device = geom.positions.device if device is None else device
    pos = geom.positions.cpu().numpy()
    idx = geom.indices.cpu().numpy()
    valid = geom.face_valid.cpu().numpy()
    prim_ids = np.nonzero(valid)[0].astype(np.int32)
    tri_idx = idx[prim_ids]

    if cfg.builder == BuilderType.SBVH:
        from ..runtime.native import sbvh_block_refs

        sbvh = sbvh_block_refs(pos, tri_idx, BLOCK, cfg.sah_bins, cfg.max_split_depth,
                               cfg.min_overlap, cfg.extra_refs_budget)
        if sbvh is not None:
            return _pack_ref_blocks(prim_ids, tri_idx, pos, *sbvh, device=device)

    sah = None
    if cfg.builder in (BuilderType.SAH, BuilderType.SBVH):
        from ..runtime.native import sah_block_order

        sah = sah_block_order(pos, tri_idx, BLOCK, cfg.sah_bins)

    if sah is not None:
        order, bstart = sah
        merged = [0]
        for b in range(len(bstart) - 1):
            if bstart[b + 1] - merged[-1] > BLOCK:
                merged.append(bstart[b])
        merged.append(bstart[-1])
        bstart = np.asarray(merged)
        n_real_blocks = len(bstart) - 1
        slots = np.full((n_real_blocks * BLOCK,), -1, np.int64)
        lens = bstart[1:] - bstart[:-1]
        block_of = np.repeat(np.arange(n_real_blocks), lens)
        pos_in_block = np.arange(len(order)) - np.repeat(bstart[:-1], lens)
        slots[block_of * BLOCK + pos_in_block] = order
        filled = slots >= 0
        src = np.clip(slots, 0, None)
        p0 = np.where(filled[:, None], pos[tri_idx[src, 0]], 0.0)
        p1 = np.where(filled[:, None], pos[tri_idx[src, 1]], 0.0)
        p2 = np.where(filled[:, None], pos[tri_idx[src, 2]], 0.0)
        slot_ids = np.where(filled, prim_ids[src], -1).astype(np.int32)
        n = len(slots)
    else:
        cent_pos = (pos[tri_idx[:, 0]] + pos[tri_idx[:, 1]]
                    + pos[tri_idx[:, 2]]) / 3.0
        lo = cent_pos.min(0)
        span = np.maximum(cent_pos.max(0) - lo, 1e-12)
        order = np.argsort(_morton_u32((cent_pos - lo) / span), kind="stable")
        p0 = pos[tri_idx[order, 0]]
        p1 = pos[tri_idx[order, 1]]
        p2 = pos[tri_idx[order, 2]]
        slot_ids = prim_ids[order].astype(np.int32)
        n = p0.shape[0]

    nt = max(BLOCK, -(-n // BLOCK) * BLOCK)
    tri = np.zeros((16, nt), np.float32)
    tri[0:3, :n] = p0.T
    tri[3:6, :n] = (p1 - p0).T
    tri[6:9, :n] = (p2 - p0).T

    nb = nt // BLOCK
    nbpad = max(128, -(-nb // 128) * 128)
    aabb = np.empty((nbpad, 8), np.float32)
    aabb[:, 0:3] = BIG
    aabb[:, 3:6] = -BIG
    aabb[:, 6:8] = 0.0
    pmin = np.minimum(np.minimum(p0, p1), p2)
    pmax = np.maximum(np.maximum(p0, p1), p2)
    real = slot_ids >= 0 if sah is not None else np.ones((n,), bool)
    pmn = np.full((nt, 3), BIG, np.float32)
    pmx = np.full((nt, 3), -BIG, np.float32)
    pmn[:n][real] = pmin[real]
    pmx[:n][real] = pmax[real]
    blo = pmn.reshape(nb, BLOCK, 3).min(1)
    bhi = pmx.reshape(nb, BLOCK, 3).max(1)
    nonempty = blo[:, 0] <= bhi[:, 0]
    aabb[:nb, 0:3] = np.where(nonempty[:, None], blo, BIG)
    aabb[:nb, 3:6] = np.where(nonempty[:, None], bhi, -BIG)
    # NaN-poisoned AABBs: an inverted +-BIG box PASSES the
    # slab test (the per-axis min/max swap makes it a full-range interval),
    # so empty boxes are NaN.  Every slab test on them must then be false,
    # which holds for torch.minimum/maximum (they propagate NaN) and for the
    # kernels' own NaN-propagating min/max, but NOT for CUDA's fminf/fmaxf.
    empty = aabb[:, 0] > aabb[:, 3]
    aabb[empty, 0:6] = np.nan

    slot_prim = np.full((nt,), -1, np.int32)
    slot_prim[:n] = slot_ids
    if sah is not None:
        bounds = np.stack([pmin[real].min(0), pmax[real].max(0)]).astype(np.float32)
    else:
        bounds = np.stack([pmin.min(0), pmax.max(0)]).astype(np.float32)

    return _accel(tri, aabb, slot_prim, bounds, nb, "sah" if sah is not None else "lbvh",
                  device)


def _accel(tri, aabb, slot_prim, bounds, nb, builder, device) -> BlockedAccel:
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    aabb = dev(aabb)
    return BlockedAccel(tri=dev(tri), aabb=aabb, slot_prim=dev(slot_prim), bounds=dev(bounds),
                        chunk_aabb=chunk_union(aabb), num_blocks=nb, builder=builder)


def _pack_ref_blocks(prim_ids, tri_idx, pos, ref_tri, ref_bounds, bstart,
                     device) -> BlockedAccel:
    """Pack an SBVH reference decomposition into the fixed-block layout
    (the JAX package's code).  Consecutive leaves are merged greedily while
    they fit 128 slots; each block's box comes from its references'
    clipped bounds, while the walks test each reference's full triangle,
    so a hit found through any reference of a triangle is a true hit."""
    merged = [0]
    for b in range(len(bstart) - 1):
        if bstart[b + 1] - merged[-1] > BLOCK:
            merged.append(bstart[b])
    merged.append(int(bstart[-1]))
    bstart = np.asarray(merged)
    nb = len(bstart) - 1
    slots = np.full((nb * BLOCK,), -1, np.int64)
    n_refs = int(bstart[-1])
    lens = bstart[1:] - bstart[:-1]
    block_of = np.repeat(np.arange(nb), lens)
    pos_in_block = np.arange(n_refs) - np.repeat(bstart[:-1], lens)
    slots[block_of * BLOCK + pos_in_block] = np.arange(n_refs)
    filled = slots >= 0
    src = np.clip(slots, 0, None)  # reference index per slot
    t_of = ref_tri[src]  # local triangle index per slot
    p0 = np.where(filled[:, None], pos[tri_idx[t_of, 0]], 0.0)
    p1 = np.where(filled[:, None], pos[tri_idx[t_of, 1]], 0.0)
    p2 = np.where(filled[:, None], pos[tri_idx[t_of, 2]], 0.0)
    slot_ids = np.where(filled, prim_ids[t_of], -1).astype(np.int32)
    n = len(slots)

    nt = max(BLOCK, -(-n // BLOCK) * BLOCK)
    tri = np.zeros((16, nt), np.float32)
    tri[0:3, :n] = p0.T
    tri[3:6, :n] = (p1 - p0).T
    tri[6:9, :n] = (p2 - p0).T

    nbpad = max(128, -(-nb // 128) * 128)
    aabb = np.empty((nbpad, 8), np.float32)
    aabb[:, 0:3] = BIG
    aabb[:, 3:6] = -BIG
    aabb[:, 6:8] = 0.0
    # block boxes from the clipped reference bounds, through the same slot
    # scatter (padding slots keep the +-BIG identity)
    rlo = np.full((nb * BLOCK, 3), BIG, np.float32)
    rhi = np.full((nb * BLOCK, 3), -BIG, np.float32)
    rlo[filled] = ref_bounds[src[filled], 0:3]
    rhi[filled] = ref_bounds[src[filled], 3:6]
    aabb[:nb, 0:3] = rlo.reshape(nb, BLOCK, 3).min(1)
    aabb[:nb, 3:6] = rhi.reshape(nb, BLOCK, 3).max(1)
    empty = aabb[:, 0] > aabb[:, 3]
    aabb[empty, 0:6] = np.nan

    slot_prim = np.full((nt,), -1, np.int32)
    slot_prim[:n] = slot_ids
    bounds = np.stack([ref_bounds[:, 0:3].min(0), ref_bounds[:, 3:6].max(0)]).astype(np.float32)
    return _accel(tri, aabb, slot_prim, bounds, nb, "sbvh", device)


def _nan_reduce(boxes: torch.Tensor, lo: bool) -> torch.Tensor:
    """``jnp.nanmin`` (``lo``) or ``jnp.nanmax`` over axis 1 of (C, 128, 3)
    boxes: NaN (empty) boxes are skipped, and a chunk with no other box
    stays NaN.  torch's own min/max would propagate the NaN instead."""
    nan = torch.isnan(boxes)
    fill = float("inf") if lo else float("-inf")
    out = torch.where(nan, fill, boxes)
    out = out.amin(dim=1) if lo else out.amax(dim=1)
    return torch.where(nan.all(dim=1), float("nan"), out)


def chunk_union(aabb: torch.Tensor) -> torch.Tensor:
    """(NBpad//128, 8) union box per 128-box cull chunk of (NBpad, 8)
    boxes, in torch ops on the boxes' device.  All-empty chunks stay
    NaN-poisoned (slab comparisons false -> chunk skipped)."""
    ch = aabb.reshape(-1, 128, 8)
    pad = torch.zeros((ch.shape[0], 2), dtype=aabb.dtype, device=aabb.device)
    return torch.cat([_nan_reduce(ch[:, :, 0:3], True), _nan_reduce(ch[:, :, 3:6], False),
                      pad], dim=1)


def refit_blocked(accel: BlockedAccel, geom: Geometry) -> BlockedAccel:
    """Refit for edits that move vertices but keep the faces: the build's
    block decomposition (``slot_prim``, ``num_blocks``) stays, and the
    triangle rows, block boxes (NaN where a block is empty), chunk boxes
    and scene bounds are recomputed from the current positions (the JAX
    package's ``refit_blocked``).  Torch ops on the geometry's device with
    no host round trip, so an animated frame makes no host sync.  The
    operations are gathers, subtractions and min/max, so the tables equal
    the JAX package's, and a card's a CPU's, bit for bit.  An SBVH accel's
    refitted blocks are bounded by whole-triangle boxes (the clipped
    reference bounds cannot be recomputed here): looser, still correct.
    Rebuild when the faces change."""
    nt, nb = accel.num_slots, accel.num_blocks
    nbpad = accel.aabb.shape[0]
    slot = accel.slot_prim.long()
    filled = (slot >= 0)[:, None]
    tri_idx = take_clip(geom.indices, slot.clamp_min(0))  # (NT, 3)
    p0, p1, p2 = (take_clip(geom.positions, tri_idx[:, k]) for k in range(3))
    p0 = torch.where(filled, p0, 0.0)
    e1 = torch.where(filled, p1 - p0, 0.0)
    e2 = torch.where(filled, p2 - p0, 0.0)
    dev = p0.device
    tri = torch.cat([p0.T, e1.T, e2.T, torch.zeros((7, nt), dtype=torch.float32, device=dev)])

    pmin = torch.where(filled, torch.minimum(torch.minimum(p0, p1), p2), BIG)
    pmax = torch.where(filled, torch.maximum(torch.maximum(p0, p1), p2), -BIG)
    blo = pmin.reshape(nb, BLOCK, 3).amin(dim=1)
    bhi = pmax.reshape(nb, BLOCK, 3).amax(dim=1)
    empty = (blo[:, 0] > bhi[:, 0])[:, None]
    nan = float("nan")
    rows = torch.cat([torch.where(empty, nan, blo), torch.where(empty, nan, bhi),
                      torch.zeros((nb, 2), dtype=torch.float32, device=dev)], dim=1)
    pad = torch.full((nbpad - nb, 8), nan, dtype=torch.float32, device=dev)
    pad[:, 6:8] = 0.0
    aabb = torch.cat([rows, pad])
    bounds = torch.stack([pmin.amin(dim=0), pmax.amax(dim=0)])
    return accel.replace(tri=tri, aabb=aabb, chunk_aabb=chunk_union(aabb), bounds=bounds)


# --------------------------------------------------------------------------
# Ray table and coherence order (torch glue)
# --------------------------------------------------------------------------


def _expand10(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third bit (uint32 math done in int64)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _quantize(x: torch.Tensor, cells: int) -> torch.Tensor:
    """``clip(x.astype(int32), 0, cells-1)``; the float is clamped first so
    the int conversion never leaves int32 range (same result in range)."""
    return x.clamp(-1.0, float(cells)).to(torch.int64).clamp(0, cells - 1)


def _coherence_order(rays: Rays, bounds: torch.Tensor) -> torch.Tensor:
    """Ray permutation for the coherence sort, equal to the JAX package's:
    a Morton key of 8 position + up to 6 direction bits in the top bits of a
    u32, the ray index in the low bits, inactive rays forced last.

    uint32 in torch: the key is built and sorted in int64
    with explicit 32-bit masks.  The packed keys are unique, so the sorted
    order (and therefore the permutation) is the JAX package's exactly."""
    lo, hi = bounds[0], bounds[1]
    p01 = (rays.o - lo) / torch.clamp_min(hi - lo, 1e-12)
    q = _quantize(p01 * 64.0, 64)
    dq = _quantize((rays.d * 0.5 + 0.5) * 8.0, 8)
    code = (_expand10(q[:, 0]) << 2) | (_expand10(q[:, 1]) << 1) | _expand10(q[:, 2])
    dcode = (_expand10(dq[:, 0]) << 2) | (_expand10(dq[:, 1]) << 1) | _expand10(dq[:, 2])
    n = q.shape[0]
    idx_bits = max(1, (n - 1).bit_length())
    key_bits = max(32 - idx_bits, 0)
    dir_bits = min(9, max(0, key_bits - 8))
    pos_bits = min(18, key_bits - dir_bits)
    if key_bits:
        key = ((code >> (18 - pos_bits)) << dir_bits) | (dcode >> (9 - dir_bits))
    else:
        key = torch.zeros_like(code)
    mask = (1 << idx_bits) - 1
    iota = torch.arange(n, dtype=torch.int64, device=q.device)
    packed = ((key << idx_bits) & 0xFFFFFFFF) | iota
    packed = torch.where(rays.active, packed, (0xFFFFFFFF & ~mask) | iota)
    return torch.sort(packed).values & mask


def _ray_table(rays: Rays) -> torch.Tensor:
    """(N, 8) rows o.xyz, d.xyz, tmin, tmax.  Inactive rays get tmax=-BIG
    so every test fails (``_pack_table`` gives padding rays the same)."""
    tmax = torch.where(rays.active, torch.clamp_max(rays.tmax, BIG), -BIG)
    return torch.cat([rays.o, rays.d, rays.tmin[:, None], tmax[:, None]], dim=1)


def _pack_table(table: torch.Tensor) -> torch.Tensor:
    """(N, 8) -> (8, Npad) transposed and TILE-padded kernel input (padding
    rays carry tmax=-BIG)."""
    n = table.shape[0]
    npad = -(-n // TILE) * TILE
    packed = torch.zeros((8, npad), dtype=torch.float32, device=table.device)
    packed[:, :n] = table.T
    packed[7, n:] = -BIG
    return packed


def _ray_rows(rt: torch.Tensor):
    """Unpack ray rows (each (..., T)) plus the inverse directions.
    Float contraction: ``1/sd(d)`` with ``sd`` clamping |d| <= 1e-12 to +1e-12
    (sign lost, as the JAX package writes it), an IEEE reciprocal."""
    ox, oy, oz, dx, dy, dz, tmn, tmx = rt.unbind(0)

    def sd(c):
        return torch.where(torch.abs(c) > 1e-12, c, 1e-12)

    return (ox, oy, oz, dx, dy, dz, torch.reciprocal(sd(dx)),
            torch.reciprocal(sd(dy)), torch.reciprocal(sd(dz)), tmn, tmx)


# --------------------------------------------------------------------------
# Plain PyTorch versions of kernels K1-K3 (used only for CPU tensors)
# --------------------------------------------------------------------------


def _slab(lo, hi, o, inv, tmn, tmx):
    """Entry/exit distances of rays against boxes (broadcasting), with the
    JAX package's min/max nesting.  NaN boxes give NaN, so ``tn <= tf``
    fails."""
    t0 = [(lo[k] - o[k]) * inv[k] for k in range(3)]
    t1 = [(hi[k] - o[k]) * inv[k] for k in range(3)]
    mn = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    mx = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    tn = torch.maximum(torch.maximum(mn[0], mn[1]), torch.maximum(mn[2], tmn))
    tf = torch.minimum(torch.minimum(mx[0], mx[1]), torch.minimum(mx[2], tmx))
    return tn, tf


def cull_plain(rays_packed: torch.Tensor, chunk_aabb: torch.Tensor,
               aabb: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Plain version of K1: (n_tiles, NBpad) key = min over the tile's rays
    of the block entry distance, or BIG where no ray enters.  Skipping
    chunks whose union box no ray enters (what the kernel does) cannot
    change a key: a box inside the union is entered only if the union is,
    so the plain version tests every block."""
    npad = rays_packed.shape[1]
    n_tiles = npad // tile
    nbpad = aabb.shape[0]
    ox, oy, oz, _, _, _, ix, iy, iz, tmn, tmx = _ray_rows(
        rays_packed.reshape(8, n_tiles, tile, 1))
    keys = torch.empty((n_tiles, nbpad), dtype=torch.float32,
                       device=rays_packed.device)
    for c in range(nbpad // 128):
        a = aabb[c * 128:(c + 1) * 128]  # (128, 8)
        tn, tf = _slab(a[:, 0:3].T, a[:, 3:6].T, (ox, oy, oz), (ix, iy, iz),
                       tmn, tmx)  # (n_tiles, tile, 128)
        keys[:, c * 128:(c + 1) * 128] = torch.where(tn <= tf, tn, BIG).amin(dim=1)
    return keys


def _mt(tri9, o, d, tmn, tmx, best_t):
    """Möller-Trumbore of triangle columns against rays, in the kernel's
    exact operation order (no fused multiply-add on either side)."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    ox, oy, oz = o
    dx, dy, dz = d
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > 1e-9
    inv = torch.where(ok, torch.reciprocal(torch.where(ok, det, 1.0)), 0.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmn) & (t < tmx) & (t < best_t))
    return t, hit


def flat_rows(tri: torch.Tensor):
    """The walk's group loader for a flat table: visit-list entries (A, G)
    are block ids (clamped into the table, as the kernels do) -> the 9
    triangle rows (A, G*128, 1), the slot ids (A, G*128) and no instance."""
    nt_blocks = tri.shape[1] // BLOCK
    lanes = torch.arange(BLOCK, device=tri.device)

    def rows(ent):
        cols = (ent.clamp(max=nt_blocks - 1)[:, :, None] * BLOCK + lanes).reshape(
            ent.shape[0], -1)
        return [tri[c][cols][:, :, None] for c in range(9)], cols, None

    return rows


def _walk_plain(counts, rays_packed, lists, tn_sorted, rows_of, tile, group,
                closest: bool, tally: list | None = None, observe=None):
    """Shared plain version of K2/K3 (and, with another ``rows_of``, of the
    two-level K6/K7): per tile, walk the visit list ``group`` entries per
    step, testing every ray of the tile, with the kernels' loop condition;
    all tiles advance in lock-step.  ``tally`` (a list) receives, per step,
    the Moller-Trumbore tests the tile walk runs (the rays that test: live
    for K2, live and still unblocked for K3, times the group's slots) and
    the slots it stages.  ``observe(r, e, t, hit, best_t, blocked)`` sees
    each step's tiles ``r``, list positions ``e``, test results (A,
    G*128, tile) and the state before the step; it changes nothing."""
    dev = rays_packed.device
    npad = rays_packed.shape[1]
    n_tiles = npad // tile
    nbpad = lists.shape[1]
    ox, oy, oz, dx, dy, dz, _, _, _, tmn, tmx = _ray_rows(
        rays_packed.reshape(8, n_tiles, 1, tile))
    groups = (counts.to(torch.int64) + group - 1) // group
    best_t = torch.full((n_tiles, 1, tile), BIG, dtype=torch.float32, device=dev)
    best_slot = torch.full((n_tiles, 1, tile), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((n_tiles, 1, tile), -1, dtype=torch.int32, device=dev)
    blocked = torch.zeros((n_tiles, 1, tile), dtype=torch.bool, device=dev)
    live0 = tmx > tmn
    walking = groups > 0
    # bound the (tiles, group*128, tile) test matrix to ~2^25 elements
    step_tiles = max(1, (1 << 25) // (group * BLOCK * tile))
    k = 0
    while True:
        rows = walking.nonzero().squeeze(1)
        if rows.numel() == 0:
            break
        if closest:
            # exit once the group's nearest block opens beyond every live
            # ray's best hit (dead rays carry tmax=-BIG)
            t_exit = torch.minimum(best_t[rows], tmx[rows]).amax(dim=(1, 2))
            go = (k < groups[rows]) & (
                tn_sorted[rows, min(k * group, nbpad - 1)] <= t_exit)
        else:
            go = (k < groups[rows]) & (live0[rows] & ~blocked[rows]).any(dim=2).squeeze(1)
        walking[rows] = go
        rows = rows[go]
        if tally is not None:
            testing = live0[rows] if closest else live0[rows] & ~blocked[rows]
            tally.append((testing.sum() * group * BLOCK, rows.numel() * group * BLOCK))
        for s in range(0, rows.numel(), step_tiles):
            r = rows[s:s + step_tiles]
            e = torch.clamp(k * group + torch.arange(group, device=dev), max=nbpad - 1)
            tri9, cols, who = rows_of(lists[r][:, e].to(torch.int64))  # (A, G*128)
            o = (ox[r], oy[r], oz[r])
            d = (dx[r], dy[r], dz[r])
            if closest:
                t, hit = _mt(tri9, o, d, tmn[r], tmx[r], best_t[r])
                if observe is not None:
                    observe(r, e, t, hit, best_t[r], blocked[r])
                tnew, j = torch.where(hit, t, BIG).min(dim=1, keepdim=True)
                better = tnew < best_t[r]
                j = j.squeeze(1)
                slot = torch.gather(cols, 1, j).to(torch.int32)[:, None, :]
                best_slot[r] = torch.where(better, slot, best_slot[r])
                if who is not None:
                    inst = torch.gather(who, 1, j).to(torch.int32)[:, None, :]
                    best_inst[r] = torch.where(better, inst, best_inst[r])
                best_t[r] = torch.where(better, tnew, best_t[r])
            else:
                bt = torch.where(blocked[r], -BIG, BIG)
                t, hit = _mt(tri9, o, d, tmn[r], tmx[r], bt)
                if observe is not None:
                    observe(r, e, t, hit, best_t[r], blocked[r])
                blocked[r] = blocked[r] | hit.any(dim=1, keepdim=True)
        k += 1
    if closest:
        return best_t.reshape(-1), best_slot.reshape(-1), best_inst.reshape(-1)
    return blocked.reshape(-1).to(torch.float32)


def closest_plain(counts, rays_packed, lists, tn_sorted, tri,
                  tile: int = TILE, group: int = GROUP):
    """Plain version of K2: (Npad,) best t (BIG on a miss) and (Npad,) slot
    = block*128 + lane (-1 on a miss); ties go to the first triangle in
    visit order."""
    t, slot, _ = _walk_plain(counts, rays_packed, lists, tn_sorted, flat_rows(tri),
                             tile, group, closest=True)
    return t, slot


def occluded_plain(counts, rays_packed, lists, tri, tile: int = TILE,
                   group: int = GROUP):
    """Plain version of K3: (Npad,) 1.0 where blocked, else 0.0."""
    return _walk_plain(counts, rays_packed, lists, None, flat_rows(tri), tile, group,
                       closest=False)


def walk_tests(counts, rays_packed, lists, tn_sorted, rows_of, tile: int = TILE,
               group: int = GROUP, closest: bool = True) -> tuple[int, int]:
    """(Moller-Trumbore tests, staged slots) that the walk kernel (K2 or
    K3 with ``flat_rows``; K6 or K7 with the two-level loader) runs on
    these inputs: the groups walked before the early exit, times the group's
    slots, times the rays of the tile that test."""
    tally = []
    _walk_plain(counts, rays_packed, lists, tn_sorted, rows_of, tile, group, closest,
                tally=tally)
    return (int(sum(int(a) for a, _ in tally)), int(sum(b for _, b in tally)))


def _ray_boxes(rays_packed, boxes, ids, r, pos, tile):
    """Slab test of tiles ``r``' rays (A, 1, tile) against the boxes of
    their list entries ``ids`` (int64 rows of ``boxes``) at positions
    ``pos`` (P,): entry distances and whether each ray enters, both (A, P,
    tile)."""
    n_tiles = rays_packed.shape[1] // tile
    ox, oy, oz, _, _, _, ix, iy, iz, tmn, tmx = _ray_rows(
        rays_packed.reshape(8, n_tiles, 1, tile)[:, r])
    box = boxes[ids[r][:, pos]]  # (A, P, 8)
    tn, tf = _slab([box[..., c, None] for c in range(3)],
                   [box[..., 3 + c, None] for c in range(3)],
                   (ox, oy, oz), (ix, iy, iz), tmn, tmx)
    return tn, tn <= tf


def block_boxes(tri: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """The block boxes as K2/K3 index them: a list entry is clamped into the
    triangle table's blocks, so ``aabb``'s padding rows past them are never
    read."""
    return aabb[:tri.shape[1] // BLOCK]


def walk_work(counts, rays_packed, lists, tn_sorted, rows_of, boxes, tile: int = TILE,
              group: int = GROUP, closest: bool = True) -> tuple[int, int]:
    """Two counts of the work of a list walk on these inputs, beside
    ``walk_tests``' tile walk: K2 (``closest``) or K3 with ``rows_of`` =
    ``flat_rows(tri)`` and ``boxes`` = ``block_boxes(tri, aabb)``; K6 or K7
    with ``two_level.pair_rows`` and ``pair_aabb``.  ``boxes`` is the box
    table the list entries index, each entry clamped into it as the kernels
    clamp.  A list entry is a block (K2/K3) or an (instance, block) pair
    (K6/K7):

    - ``least``: ray-entry visits that any front-to-back walk of these
      lists must make.  For each live ray, the entries of its tile's list
      (the first ``counts``) whose box it enters at an entry distance no
      greater than its final t (the plain version's hit distance; tmax on a
      miss), and for the any-hit walk only up to its first blocking entry
      in list order.  Each costs a slab test and 128 Moller-Trumbore tests.
    - ``warp``: the (warp of 32 rays, entry) visits the kernel makes: the
      plain walk with the kernel's warp mask, an entry of a walked group
      counting for a warp when one of its lanes enters the box (closest
      hit: no farther than the best t so far; any hit: live and not yet
      blocked).  Each costs 32 slab tests and 32 x 128 Moller-Trumbore
      tests.
    """
    npad = rays_packed.shape[1]
    n_tiles = npad // tile
    dev = rays_packed.device
    nbpad = lists.shape[1]
    ids = lists.to(torch.int64).clamp(max=boxes.shape[0] - 1)  # as the kernels clamp
    warp = 0
    stop = torch.full((n_tiles, 1, tile), nbpad, dtype=torch.int64, device=dev)
    live = (rays_packed[7] > rays_packed[6]).reshape(n_tiles, 1, tile)

    def observe(r, e, t, hit, best0, blocked0):
        nonlocal warp
        a, g = r.numel(), e.numel()
        tn, inside = _ray_boxes(rays_packed, boxes, ids, r, e, tile)  # (A, G, tile)
        hb = hit.reshape(a, g, BLOCK, tile)
        if closest:
            tb = torch.where(hb, t.reshape(a, g, BLOCK, tile), BIG).amin(dim=2)
            best = torch.cat([best0, tb[:, :-1]], dim=1).cummin(dim=1).values
            enter = inside & (tn <= best)
        else:
            hit_any = hb.any(dim=2)  # (A, G, tile)
            before = torch.cat([blocked0, hit_any[:, :-1]], dim=1).to(torch.int8)
            enter = inside & live[r] & (before.cummax(dim=1).values == 0)
            first = torch.where(hit_any.any(dim=1, keepdim=True),
                                e[hit_any.to(torch.int8).argmax(dim=1, keepdim=True)], nbpad)
            stop[r] = torch.where(blocked0, stop[r], first)
        warp += int(enter.reshape(a, g, tile // 32, 32).any(dim=3).sum())

    out = _walk_plain(counts, rays_packed, lists, tn_sorted, rows_of, tile, group, closest,
                      observe=observe)
    final_t = out[0].reshape(n_tiles, 1, tile) if closest else None
    least = 0
    counts64 = counts.to(torch.int64)
    step = max(1, (1 << 24) // (n_tiles * tile))
    for p0 in range(0, int(counts64.max()) if n_tiles else 0, step):
        r = (counts64 > p0).nonzero().squeeze(1)
        pos = torch.arange(p0, min(p0 + step, nbpad), device=dev)
        tn, inside = _ray_boxes(rays_packed, boxes, ids, r, pos, tile)  # (A, P, tile)
        ok = inside & (pos[None, :, None] < counts64[r][:, None, None])
        if closest:
            ok = ok & (tn <= final_t[r])
        else:
            ok = ok & (pos[None, :, None] <= stop[r])
        least += int(ok.sum())
    return least, warp


def cull_tests(rays_packed: torch.Tensor, chunk_aabb: torch.Tensor,
               aabb: torch.Tensor, tile: int = TILE) -> int:
    """Slab tests that K1 needs on these inputs, at three levels:

    1. a tile with a live ray tests its rays against every real chunk box
       (a tile whose rays all have tmax < tmin can enter no box, since
       tn >= tmin > tmax >= tf, and tests nothing);
    2. in each chunk that one of them enters, it tests its rays against
       the union box of each group of 32 blocks (a warp's) that holds a
       real block;
    3. each ray that enters a group's union then tests the group's real
       blocks.
    """
    npad = rays_packed.shape[1]
    n_tiles = npad // tile
    ox, oy, oz, _, _, _, ix, iy, iz, tmn, tmx = _ray_rows(
        rays_packed.reshape(8, n_tiles, tile, 1))
    tn, tf = _slab(chunk_aabb[:, 0:3].T, chunk_aabb[:, 3:6].T, (ox, oy, oz),
                   (ix, iy, iz), tmn, tmx)  # (n_tiles, tile, n_chunks)
    entered = (tn <= tf).any(dim=1)  # (n_tiles, n_chunks)
    live_tiles = int((~(tmx < tmn)).any(dim=1).sum())
    real_chunks = int((~torch.isnan(chunk_aabb[:, 0])).sum())
    real = ~torch.isnan(aabb[:, 0])
    real_in_group = real.reshape(-1, 32).sum(dim=1)  # (NBpad / 32,)
    # the groups' union boxes, NaN where a group has no real block
    inf = float("inf")
    lo = torch.where(real[:, None], aabb[:, 0:3], inf).reshape(-1, 32, 3).amin(dim=1)
    hi = torch.where(real[:, None], aabb[:, 3:6], -inf).reshape(-1, 32, 3).amax(dim=1)
    lo = torch.where(real_in_group[:, None] > 0, lo, float("nan"))
    total = live_tiles * real_chunks * tile
    for c in entered.any(dim=0).nonzero().flatten().tolist():
        r = entered[:, c]
        g = slice(4 * c, 4 * c + 4)
        gn, gf = _slab(lo[g].T, hi[g].T, (ox[r], oy[r], oz[r]), (ix[r], iy[r], iz[r]),
                       tmn[r], tmx[r])  # (A, tile, 4)
        total += int(r.sum()) * int((real_in_group[g] > 0).sum()) * tile
        total += int(((gn <= gf).sum(dim=1) * real_in_group[g]).sum())
    return total


# --------------------------------------------------------------------------
# Plain versions of the dense kernels K4/K5 (used only for CPU tensors)
# --------------------------------------------------------------------------


def _dense_plain(rays_packed: torch.Tensor, tri: torch.Tensor, closest: bool):
    """Every ray against every slot of a <= DENSE_BLOCKS-block table, one
    block at a time in slot order (as the JAX package's dense kernels); rays
    are taken in chunks to bound the (rays, 128) test matrices."""
    npad = rays_packed.shape[1]
    dev = rays_packed.device
    best_t = torch.full((npad,), BIG, dtype=torch.float32, device=dev)
    best_slot = torch.full((npad,), -1, dtype=torch.int32, device=dev)
    blocked = torch.zeros((npad,), dtype=torch.bool, device=dev)
    step = (1 << 22) // BLOCK
    for s in range(0, npad, step):
        ox, oy, oz, dx, dy, dz, _, _, _, tmn, tmx = _ray_rows(
            rays_packed[:, s:s + step, None])  # each (R, 1)
        bt, bs, bb = best_t[s:s + step, None], best_slot[s:s + step, None], blocked[s:s + step]
        for b in range(-(-tri.shape[1] // BLOCK)):  # a ragged last block too
            tri9 = [tri[c, None, b * BLOCK:(b + 1) * BLOCK] for c in range(9)]  # (1, 128)
            if closest:
                t, hit = _mt(tri9, (ox, oy, oz), (dx, dy, dz), tmn, tmx, bt)
                tnew, j = torch.where(hit, t, BIG).min(dim=1, keepdim=True)
                better = tnew < bt
                bs = torch.where(better, b * BLOCK + j.to(torch.int32), bs)
                bt = torch.where(better, tnew, bt)
            else:
                _, hit = _mt(tri9, (ox, oy, oz), (dx, dy, dz), tmn, tmx,
                             torch.where(bb, -BIG, BIG)[:, None])
                bb = bb | hit.any(dim=1)
        best_t[s:s + step], best_slot[s:s + step], blocked[s:s + step] = bt[:, 0], bs[:, 0], bb
    if closest:
        return best_t, best_slot
    return blocked.to(torch.float32)


def dense_closest_plain(rays_packed: torch.Tensor, tri: torch.Tensor):
    """Plain version of K4: (Npad,) best t (BIG on a miss) and slot (-1 on
    a miss) over every slot of the table; ties go to the lowest slot."""
    return _dense_plain(rays_packed, tri, True)


def dense_any_plain(rays_packed: torch.Tensor, tri: torch.Tensor):
    """Plain version of K5: (Npad,) 1.0 where a slot blocks the segment."""
    return _dense_plain(rays_packed, tri, False)


def dense_kept(tri: torch.Tensor) -> torch.Tensor:
    """(NT,) bool: the slots K4/K5 stage, those whose six edge components
    (rows 3-8, e1 and e2) are not all exactly zero.  A dropped slot can
    never hit: with e1 = e2 = 0, det is 0 or NaN and fails |det| > 1e-9
    (``_mt``), whatever the ray.  Padding slots are such slots."""
    return (tri[3:9] != 0.0).any(dim=0)


def dense_tests(rays_packed: torch.Tensor, tri: torch.Tensor, closest: bool) -> int:
    """Moller-Trumbore tests that K4 (``closest``) or K5 runs on these
    inputs: every live ray tests every kept slot (``dense_kept``), except
    that K5 stops a ray at its first blocking slot."""
    _, _, _, _, _, _, _, _, _, tmn, tmx = _ray_rows(rays_packed)
    live = tmx > tmn
    kept = tri[:, dense_kept(tri)]
    nk = kept.shape[1]
    if closest or nk == 0:
        return int(live.sum()) * nk
    total = 0
    step = (1 << 22) // nk
    for s in range(0, rays_packed.shape[1], step):
        ox, oy, oz, dx, dy, dz, _, _, _, tmn, tmx = _ray_rows(rays_packed[:, s:s + step, None])
        _, hit = _mt([kept[c, None, :] for c in range(9)], (ox, oy, oz), (dx, dy, dz),
                     tmn, tmx, BIG)  # (R, kept)
        first = torch.where(hit.any(dim=1), hit.to(torch.int8).argmax(dim=1) + 1, nk)
        total += int(torch.where(live[s:s + step], first, 0).sum())
    return total


# --------------------------------------------------------------------------
# Visit lists and queries
# --------------------------------------------------------------------------


def _kernel_or_plain(rays_packed: torch.Tensor, kernel, plain):
    """The plain version for rays on the CPU, else the kernel (its wrapper
    launches on a CUDA tensor and raises on any other device)."""
    return plain if rays_packed.device.type == "cpu" else kernel


def _visit_lists(rays_packed, accel: BlockedAccel):
    """Front-to-back visit lists: counts (n_tiles,) i32, lists (n_tiles,
    NBpad) i32, tn_sorted (n_tiles, NBpad) f32."""
    cull = _kernel_or_plain(rays_packed, kernels.cull, cull_plain)
    with span("mcrt.query.cull"):
        return lists_from_keys(cull(rays_packed, accel.chunk_aabb, accel.aabb, TILE))


def lists_from_keys(key: torch.Tensor):
    """Sort each tile's (n_tiles, NBpad) cull keys into its visit list."""
    nbpad = key.shape[1]
    # Dtypes: the JAX package runs with x64 off, so its integers are int32;
    # torch's default is int64, so the kernels' integer inputs are made
    # int32 explicitly
    counts = (key < 0.5 * BIG).sum(dim=1, dtype=torch.int32)
    if nbpad <= PACKED_KEY_MAX_BLOCKS:
        # The packed cull key: non-negative f32 bit
        # patterns sort like int32, so (entry distance | block id) is ONE
        # int32 key with the low 12 mantissa bits replaced by the block id.
        # The recovered distance is truncated downward, a lower bound, so
        # the walk's early exit stays conservative.  ``where(key > 0)``
        # also turns -0.0 into +0.0, keeping the sign bit clear.
        kb = torch.where(key > 0.0, key, 0.0).view(torch.int32)
        iota = torch.arange(nbpad, dtype=torch.int32, device=key.device)
        packed = torch.sort((kb & ~0xFFF) | iota, dim=1).values
        lists = packed & 0xFFF
        tn_sorted = (packed & ~0xFFF).view(torch.float32)
    else:
        tn_sorted, ids = torch.sort(key, dim=1, stable=True)
        lists = ids.to(torch.int32)
    return counts, lists.contiguous(), tn_sorted.contiguous()


def _dense_query(rays_packed, tri, closest: bool):
    """The dense kernels take the (8, Npad) ray table as the visit-list
    path packs it: they mask the ragged end themselves, so no wider padding
    (the JAX package's ``_dense_pad``) is needed."""
    if closest:
        return _kernel_or_plain(rays_packed, kernels.dense_closest,
                                dense_closest_plain)(rays_packed, tri)
    return _kernel_or_plain(rays_packed, kernels.dense_any, dense_any_plain)(rays_packed, tri)


def _query_closest(rays_packed, accel: BlockedAccel):
    rays_packed = rays_packed.detach()  # no gradient through the query
    if accel.num_blocks <= DENSE_BLOCKS:
        with span("mcrt.query.walk"):
            return _dense_query(rays_packed, accel.tri, True)
    counts, lists, tn_sorted = _visit_lists(rays_packed, accel)
    with span("mcrt.query.walk"):
        if rays_packed.device.type == "cpu":  # as _kernel_or_plain; K2 also takes the boxes
            return closest_plain(counts, rays_packed, lists, tn_sorted, accel.tri, TILE, GROUP)
        return kernels.closest(counts, rays_packed, lists, tn_sorted, accel.tri, accel.aabb,
                               TILE, GROUP)


def _query_any(rays_packed, accel: BlockedAccel):
    rays_packed = rays_packed.detach()
    if accel.num_blocks <= DENSE_BLOCKS:
        with span("mcrt.query.walk"):
            return _dense_query(rays_packed, accel.tri, False)
    counts, lists, _ = _visit_lists(rays_packed, accel)
    with span("mcrt.query.walk"):
        if rays_packed.device.type == "cpu":
            return occluded_plain(counts, rays_packed, lists, accel.tri, TILE, GROUP)
        return kernels.occluded(counts, rays_packed, lists, accel.tri, accel.aabb, TILE,
                                GROUP)


def _resolve_uv(tri: torch.Tensor, slot: torch.Tensor, rays: Rays):
    """Barycentrics of each ray's winning slot (one triangle per ray)."""
    cols = tri[:, slot.clamp_min(0).long()]  # (16, N)
    p0, e1, e2 = cols[0:3].T, cols[3:6].T, cols[6:9].T
    d = rays.d
    pv = torch.linalg.cross(d, e2, dim=-1)
    det = torch.sum(e1 * pv, dim=1)
    inv = torch.where(torch.abs(det) > 1e-12,
                      1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tv = rays.o - p0
    u = torch.sum(tv * pv, dim=1) * inv
    qv = torch.linalg.cross(tv, e1, dim=-1)
    v = torch.sum(d * qv, dim=1) * inv
    return u.clamp(0.0, 1.0), v.clamp(0.0, 1.0)


def _sorted_table(rays: Rays, accel: BlockedAccel, sort: bool):
    with span("mcrt.query.sort"):
        table = _ray_table(rays)
        order = None
        if sort:
            order = _coherence_order(rays, accel.bounds)
            table = table[order]
        return _pack_table(table), order


def _unsort(a: torch.Tensor, order, n: int) -> torch.Tensor:
    a = a[:n]
    if order is None:
        return a
    out = torch.empty_like(a)
    out[order] = a
    return out


def intersect_blocked(geom: Geometry, accel: BlockedAccel, rays: Rays,
                      sort: bool = True) -> Hit:
    """Closest-hit query."""
    n = rays.n
    packed, order = _sorted_table(rays, accel, sort)
    t, slot = _query_closest(packed, accel)
    with span("mcrt.query.resolve"):
        t, slot = _unsort(t, order, n), _unsort(slot, order, n)
        found = slot >= 0
        u, v = _resolve_uv(accel.tri, slot, rays)
        u = torch.where(found, u, 0.0)
        v = torch.where(found, v, 0.0)
        prim = torch.where(found, take_clip(accel.slot_prim, slot.clamp_min(0)), -1)
        valid = found & rays.active
        shape = torch.where(valid, take_clip(geom.face_shape, prim.clamp_min(0)), -1)
        return Hit(t=torch.where(valid, t, F32_MAX), prim=prim.to(torch.int32),
                   shape=shape.to(torch.int32), u=u, v=v, valid=valid)


def occluded_blocked(geom: Geometry, accel: BlockedAccel, rays: Rays,
                     sort: bool = True) -> torch.Tensor:
    """Any-hit query: (N,) bool, True where the segment is blocked."""
    packed, order = _sorted_table(rays, accel, sort)
    out = _query_any(packed, accel)
    with span("mcrt.query.resolve"):
        return (_unsort(out, order, rays.n) > 0.0) & rays.active
