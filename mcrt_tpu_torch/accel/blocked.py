"""Sorted-wavefront blocked intersector (counterpart of
``mcrt_tpu/accel/pallas_blocked.py``).

1. **Build** (host numpy, identical to the JAX package's): triangles are
   SAH- or Morton-ordered into fixed 128-slot blocks, stored as the
   transposed (16, NT) p0/e1/e2 table, with one AABB per block
   (NaN-poisoned when empty) and one union AABB per 128-block cull chunk.
2. **Cull** (kernel K1): per ray tile, the entry distance of every block
   the tile enters (``BIG`` otherwise).
3. **Sort** (torch): one packed-key sort per tile gives the front-to-back
   visit list and per-visit entry distances.
4. **Walk** (kernels K2 closest hit / K3 any hit): each tile tests its
   list's blocks ``GROUP`` at a time with an early exit.
5. **Resolve** (torch): barycentrics for each ray's single winning slot.

The three kernels are CUDA C++ (``csrc/blocked.cu``), launched through the
wrappers in ``kernels.py``.  This module holds the glue and, beside each
kernel, its plain PyTorch version (``cull_plain``, ``closest_plain``,
``occluded_plain``).  ``_kernel_or_plain`` picks between them by the rays'
device: the plain version only for CPU tensors, otherwise the kernel, whose
wrapper launches on a CUDA tensor or raises.

Intersection carries no gradient (the JAX package returns zero
cotangents); callers run under ``torch.no_grad()``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import BuilderType, BVHConfig
from ..core.types import F32_MAX, Hit, Rays, TensorRecord
from ..scene.scene import Geometry, take_clip
from . import kernels

BLOCK = 128  # triangles per block (the JAX package's table layout)
# rays per tile (one CTA of K2/K3, one thread per ray) and blocks staged per
# walk step.  The JAX package's TILE=256/GROUP=4 were tuned for the TPU;
# these are the port's first choice, not yet tuned on the card.
TILE = 128
GROUP = 4
BIG = 3.0e38
PACKED_KEY_MAX_BLOCKS = 4096  # the block id must fit the key's low 12 bits


@dataclass
class BlockedAccel(TensorRecord):
    """``tri``: (16, NT) transposed p0/e1/e2 rows (rows 9..15 pad); padding
    columns are degenerate (e1=e2=0 -> det 0 -> miss).
    ``aabb``: (NBpad, 8) block lo.xyz/hi.xyz (cols 6..7 pad); empty blocks
    are NaN so every slab comparison fails.
    ``chunk_aabb``: (NBpad/128, 8) union box per 128-block cull chunk.
    ``slot_prim``: (NT,) slot -> primitive id (-1 padding).
    ``bounds``: (2, 3) scene lo/hi for the ray-coherence key.
    ``builder``: which decomposition ran ("sah", or "lbvh" when the native
    SAH library was unavailable or not asked for)."""

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


def _chunk_bounds(aabb: np.ndarray) -> np.ndarray:
    """(NBpad//128, 8) union box per 128-block cull chunk.  All-empty
    chunks stay NaN-poisoned (slab comparisons false -> chunk skipped)."""
    import warnings

    nbpad = aabb.shape[0]
    ch = aabb.reshape(nbpad // 128, 128, 8)
    out = np.empty((nbpad // 128, 8), np.float32)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN chunks
        out[:, 0:3] = np.nanmin(ch[:, :, 0:3], axis=1)
        out[:, 3:6] = np.nanmax(ch[:, :, 3:6], axis=1)
    out[:, 6:8] = 0.0
    return out


def build_blocked(geom: Geometry, cfg: BVHConfig | None = None,
                  device=None) -> BlockedAccel:
    """Host-side build.  SAH (default): native binned-SAH leaves become
    blocks, greedily merged while they fit 128 slots; falls back to Morton
    blocks (LBVH) when the native library is unavailable, as the JAX
    package does.  LBVH: Morton-ordered triangles cut into full blocks."""
    cfg = cfg or BVHConfig()
    if cfg.builder == BuilderType.SBVH:
        raise NotImplementedError(
            "SBVH blocks are not ported yet (ROADMAP, Queue 1: refit and "
            "dynamic scenes); use BuilderType.SAH or LBVH")
    device = geom.positions.device if device is None else device
    pos = geom.positions.cpu().numpy()
    idx = geom.indices.cpu().numpy()
    valid = geom.face_valid.cpu().numpy()
    prim_ids = np.nonzero(valid)[0].astype(np.int32)
    tri_idx = idx[prim_ids]

    sah = None
    if cfg.builder == BuilderType.SAH:
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

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BlockedAccel(
        tri=dev(tri), aabb=dev(aabb), slot_prim=dev(slot_prim),
        bounds=dev(bounds), chunk_aabb=dev(_chunk_bounds(aabb)),
        num_blocks=nb, builder="sah" if sah is not None else "lbvh",
    )


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


def _walk_plain(counts, rays_packed, lists, tn_sorted, tri, tile, group,
                closest: bool):
    """Shared plain version of K2/K3: per tile, walk the visit list
    ``group`` blocks per step, testing every ray of the tile, with the
    kernels' loop condition; all tiles advance in lock-step."""
    dev = rays_packed.device
    npad = rays_packed.shape[1]
    n_tiles = npad // tile
    nbpad = lists.shape[1]
    nt_blocks = tri.shape[1] // BLOCK
    ox, oy, oz, dx, dy, dz, _, _, _, tmn, tmx = _ray_rows(
        rays_packed.reshape(8, n_tiles, 1, tile))
    groups = (counts.to(torch.int64) + group - 1) // group
    best_t = torch.full((n_tiles, 1, tile), BIG, dtype=torch.float32, device=dev)
    best_slot = torch.full((n_tiles, 1, tile), -1, dtype=torch.int32, device=dev)
    blocked = torch.zeros((n_tiles, 1, tile), dtype=torch.bool, device=dev)
    live0 = tmx > tmn
    walking = groups > 0
    lanes = torch.arange(BLOCK, device=dev)
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
        for s in range(0, rows.numel(), step_tiles):
            r = rows[s:s + step_tiles]
            e = torch.clamp(k * group + torch.arange(group, device=dev), max=nbpad - 1)
            ent = lists[r][:, e].clamp(max=nt_blocks - 1).to(torch.int64)  # (A, G)
            cols = (ent[:, :, None] * BLOCK + lanes).reshape(r.numel(), -1)
            tri9 = [tri[c][cols][:, :, None] for c in range(9)]  # (A, G*128, 1)
            o = (ox[r], oy[r], oz[r])
            d = (dx[r], dy[r], dz[r])
            if closest:
                t, hit = _mt(tri9, o, d, tmn[r], tmx[r], best_t[r])
                tnew, j = torch.where(hit, t, BIG).min(dim=1, keepdim=True)
                better = tnew < best_t[r]
                slot = torch.gather(cols, 1, j.squeeze(1)).to(torch.int32)[:, None, :]
                best_slot[r] = torch.where(better, slot, best_slot[r])
                best_t[r] = torch.where(better, tnew, best_t[r])
            else:
                bt = torch.where(blocked[r], -BIG, BIG)
                _, hit = _mt(tri9, o, d, tmn[r], tmx[r], bt)
                blocked[r] = blocked[r] | hit.any(dim=1, keepdim=True)
        k += 1
    if closest:
        return best_t.reshape(-1), best_slot.reshape(-1)
    return blocked.reshape(-1).to(torch.float32)


def closest_plain(counts, rays_packed, lists, tn_sorted, tri,
                  tile: int = TILE, group: int = GROUP):
    """Plain version of K2: (Npad,) best t (BIG on a miss) and (Npad,) slot
    = block*128 + lane (-1 on a miss); ties go to the first triangle in
    visit order."""
    return _walk_plain(counts, rays_packed, lists, tn_sorted, tri, tile,
                       group, closest=True)


def occluded_plain(counts, rays_packed, lists, tri, tile: int = TILE,
                   group: int = GROUP):
    """Plain version of K3: (Npad,) 1.0 where blocked, else 0.0."""
    return _walk_plain(counts, rays_packed, lists, None, tri, tile, group,
                       closest=False)


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


def _query_closest(rays_packed, accel: BlockedAccel):
    # K4/K5 (the dense kernels for scenes of at most 8 blocks) are the next
    # step here; until then every scene takes the visit-list path.
    counts, lists, tn_sorted = _visit_lists(rays_packed, accel)
    closest = _kernel_or_plain(rays_packed, kernels.closest, closest_plain)
    return closest(counts, rays_packed, lists, tn_sorted, accel.tri, TILE, GROUP)


def _query_any(rays_packed, accel: BlockedAccel):
    counts, lists, _ = _visit_lists(rays_packed, accel)
    occluded = _kernel_or_plain(rays_packed, kernels.occluded, occluded_plain)
    return occluded(counts, rays_packed, lists, accel.tri, TILE, GROUP)


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
    return (_unsort(out, order, rays.n) > 0.0) & rays.active
