// Shared device code of the list walks: K2/K3 over block lists (blocked.cu)
// and K6/K7 over (instance, block) pair lists (two_level.cu).
//
// A walk is one CTA per ray tile (`tile` threads, one per ray) stepping
// through the tile's front-to-back visit list `group` entries at a time.
// What bounds it on this card: instruction slots.  Every operand of a
// ray-triangle test is a shared-memory broadcast and the work is float32
// arithmetic, so a walk is operation bound; the bound counts a
// Moller-Trumbore test as 54 operations, 27 fused multiply-adds.  The
// pieces here answer the three costs that kept the first ports of the
// walks near a tenth of that bound:
//
// 1. The test (mt_cand).  Products and dot products are written with
//    __fmaf_rn, so they fuse although the library keeps -fmad=false for
//    everything else.  The division is deferred: u, v and t are compared in
//    their unscaled form (u*det, v*det, t*det against det, made sign-aware
//    by flipping the sign bit with det's), with a relative slack of 2^-10,
//    and no pair divides.  The rare pair that passes is decided by mt_hit,
//    the plain version's own arithmetic (an IEEE reciprocal): a hit
//    distance on a cancelling triangle (a bounce ray's t of 1e-3, say)
//    moves by up to 1e-3 relative under reordered rounding, so t is taken
//    from the plain arithmetic, and the slack keeps the fused rejection
//    from dropping a pair the plain test accepts.  A thread tests 4
//    consecutive triangles per step, reading each of the 9 staged SoA rows
//    as one float4: 9 LDS.128 broadcasts per 4 tests, and no bank
//    conflict, since a warp reads one address.
// 2. Entries the ray never enters.  The list is the union over the tile's
//    rays (K1), and incoherent bounce rays enter few of its entries.  Each
//    entry's box is staged with its triangles; before each entry every lane
//    runs the slab test (slab_enter: NaN boxes never pass), and the warp
//    skips the entry's 128 tests when __ballot_sync finds no lane entering
//    (closest hit: the box is entered no farther than min(best_t, tmax);
//    any hit: the lane is live and not yet blocked).  A warp that tests an
//    entry tests it on every lane, so only entries a whole warp skips can
//    change a result.
// 3. Staging.  The entries' rows and boxes are copied with 16-byte
//    cp.async copies that are in flight while the previous group is
//    tested, as in the TPU kernels' double buffer.
//
// Numerics: a pair is decided, and its t computed, exactly as in the plain
// versions (accel/blocked.py); what can differ is a pair the fused
// prefilter rejects beyond its slack (a grazing edge, or a tie between the
// two triangles of a shared edge) and an entry a whole warp skips at the
// box's rounding edge.  The walks are held to their plain versions within
// a stated share of differing rays (chip_smoke.py).
#pragma once

#include "blocked.cuh"

// The widest ray tile the walks take (their launch bound; kernels.py checks it).
#define MCRT_WALK_MAX_TILE 256
// 16-byte copies a staged entry takes: 9 rows of 128 floats, and its box.
#define WALK_ROW_CHUNKS (9 * MCRT_BLOCK / 4)
#define WALK_CHUNKS (WALK_ROW_CHUNKS + 2)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One group of entries as the warps test it: 9 SoA rows of group*128
// world-space triangle floats, each entry's box (8 floats), block id and,
// for pair lists, instance (nullptr for block lists).
struct WalkBuffer {
    float* tri;
    float* box;
    int* ent;
    int* inst;
};

struct WalkRay {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmn, tmx;
};

__device__ __forceinline__ WalkRay load_ray(const float* __restrict__ rays, int npad,
                                            int col) {
    WalkRay r;
    r.ox = rays[0 * npad + col];
    r.oy = rays[1 * npad + col];
    r.oz = rays[2 * npad + col];
    r.dx = rays[3 * npad + col];
    r.dy = rays[4 * npad + col];
    r.dz = rays[5 * npad + col];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    r.tmn = rays[6 * npad + col];
    r.tmx = rays[7 * npad + col];
    return r;
}

// The slab test of the ray against a staged box (lo.xyz, hi.xyz, 2 pad).
__device__ __forceinline__ bool enters(const WalkRay& r, const float* box, float* tn) {
    const float4 a = *reinterpret_cast<const float4*>(box);
    const float4 b = *reinterpret_cast<const float4*>(box + 4);
    const float bb[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
    return slab_enter(bb, r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, r.tmn, r.tmx, tn);
}

// Relative slack of mt_cand's comparisons: the fused test may reject only
// pairs the plain arithmetic also rejects, unless their rounding errors
// differ by more than this share of |det| (or of the t bounds).
#define MCRT_CAND_SLACK (1.0f / 1024.0f)

// Moller-Trumbore prefilter with fused products and a deferred division.
// Returns whether the ray may cross the triangle inside (tlo, thi), judged
// on the unscaled quantities (u*det, v*det, t*det, each signed by det,
// against |det|) with MCRT_CAND_SLACK of room; the caller decides a
// passing pair with mt_hit, the plain version's arithmetic.
__device__ __forceinline__ bool mt_cand(float p0x, float p0y, float p0z, float e1x,
                                        float e1y, float e1z, float e2x, float e2y,
                                        float e2z, const WalkRay& r, float tlo, float thi) {
    const float pvx = __fmaf_rn(r.dy, e2z, -(r.dz * e2y));
    const float pvy = __fmaf_rn(r.dz, e2x, -(r.dx * e2z));
    const float pvz = __fmaf_rn(r.dx, e2y, -(r.dy * e2x));
    const float det = __fmaf_rn(e1x, pvx, __fmaf_rn(e1y, pvy, e1z * pvz));
    const float tvx = r.ox - p0x, tvy = r.oy - p0y, tvz = r.oz - p0z;
    const float us = __fmaf_rn(tvx, pvx, __fmaf_rn(tvy, pvy, tvz * pvz));
    const float qvx = __fmaf_rn(tvy, e1z, -(tvz * e1y));
    const float qvy = __fmaf_rn(tvz, e1x, -(tvx * e1z));
    const float qvz = __fmaf_rn(tvx, e1y, -(tvy * e1x));
    const float vs = __fmaf_rn(r.dx, qvx, __fmaf_rn(r.dy, qvy, r.dz * qvz));
    const float ts = __fmaf_rn(e2x, qvx, __fmaf_rn(e2y, qvy, e2z * qvz));
    const unsigned sgn = __float_as_uint(det) & 0x80000000u;
    const float a = fabsf(det), ea = MCRT_CAND_SLACK * a;
    const float u = __uint_as_float(__float_as_uint(us) ^ sgn);
    const float v = __uint_as_float(__float_as_uint(vs) ^ sgn);
    const float t = __uint_as_float(__float_as_uint(ts) ^ sgn);
    return a > (1.0f - MCRT_CAND_SLACK) * 1e-9f && u >= -ea && v >= -ea && u + v <= a + ea &&
           t > tlo * a && t < thi * a;
}

// The 9 staged rows of 4 consecutive triangles, one float4 per row.
struct Quad {
    float4 c[9];
};

__device__ __forceinline__ Quad load_quad(const float* rows, int width) {
    Quad q;
#pragma unroll
    for (int i = 0; i < 9; ++i) q.c[i] = *reinterpret_cast<const float4*>(rows + i * width);
    return q;
}

#define MCRT_QUAD_TRI(Q, F)                                                        \
    Q.c[0].F, Q.c[1].F, Q.c[2].F, Q.c[3].F, Q.c[4].F, Q.c[5].F, Q.c[6].F, Q.c[7].F, \
        Q.c[8].F
#define MCRT_RAY_HIT(R) R.ox, R.oy, R.oz, R.dx, R.dy, R.dz, R.tmn, R.tmx

// Closest hit over one staged group: per entry, the warp-wide skip, then
// the 128 tests in slot order, 4 a step.  best_inst takes the entry's
// instance (-1 for block lists).
__device__ __forceinline__ void closest_group(const WalkRay& r, WalkBuffer buf, int group,
                                              float& best_t, int& best_slot, int& best_inst) {
    const int width = group * MCRT_BLOCK;
    const float tlo = r.tmn * (1.0f - MCRT_CAND_SLACK);
    for (int g = 0; g < group; ++g) {
        float tn;
        const bool in = enters(r, buf.box + g * 8, &tn) && tn <= best_t;
        if (!__ballot_sync(0xffffffffu, in)) continue;
        const float* rows = buf.tri + g * MCRT_BLOCK;
        const int base = buf.ent[g] * MCRT_BLOCK;
        const int inst = buf.inst ? buf.inst[g] : -1;
        for (int j = 0; j < MCRT_BLOCK; j += 4) {
            const Quad q = load_quad(rows + j, width);
            const float thi = fminf(best_t, r.tmx) * (1.0f + MCRT_CAND_SLACK);
            float th;
            // strict t < best_t: ties go to the first triangle visited (the
            // Pallas argmin's rule)
            if (mt_cand(MCRT_QUAD_TRI(q, x), r, tlo, thi) &&
                mt_hit(MCRT_QUAD_TRI(q, x), MCRT_RAY_HIT(r), best_t, &th)) {
                best_t = th;
                best_slot = base + j;
                best_inst = inst;
            }
            if (mt_cand(MCRT_QUAD_TRI(q, y), r, tlo, thi) &&
                mt_hit(MCRT_QUAD_TRI(q, y), MCRT_RAY_HIT(r), best_t, &th)) {
                best_t = th;
                best_slot = base + j + 1;
                best_inst = inst;
            }
            if (mt_cand(MCRT_QUAD_TRI(q, z), r, tlo, thi) &&
                mt_hit(MCRT_QUAD_TRI(q, z), MCRT_RAY_HIT(r), best_t, &th)) {
                best_t = th;
                best_slot = base + j + 2;
                best_inst = inst;
            }
            if (mt_cand(MCRT_QUAD_TRI(q, w), r, tlo, thi) &&
                mt_hit(MCRT_QUAD_TRI(q, w), MCRT_RAY_HIT(r), best_t, &th)) {
                best_t = th;
                best_slot = base + j + 3;
                best_inst = inst;
            }
        }
    }
}

// Any hit over one staged group: per entry, the warp-wide skip, then the
// tests until every lane of the warp is blocked or dead.
__device__ __forceinline__ void occluded_group(const WalkRay& r, bool live, WalkBuffer buf,
                                               int group, bool& blocked) {
    const int width = group * MCRT_BLOCK;
    const float tlo = r.tmn * (1.0f - MCRT_CAND_SLACK);
    const float thi = r.tmx * (1.0f + MCRT_CAND_SLACK);
    for (int g = 0; g < group; ++g) {
        float tn;
        const bool in = live && !blocked && enters(r, buf.box + g * 8, &tn);
        if (!__ballot_sync(0xffffffffu, in)) continue;
        const float* rows = buf.tri + g * MCRT_BLOCK;
        for (int j = 0; j < MCRT_BLOCK; j += 4) {
            if (!__any_sync(0xffffffffu, live && !blocked)) break;
            const Quad q = load_quad(rows + j, width);
            float th;
            blocked |= (mt_cand(MCRT_QUAD_TRI(q, x), r, tlo, thi) &&
                        mt_hit(MCRT_QUAD_TRI(q, x), MCRT_RAY_HIT(r), MCRT_BIG, &th)) ||
                       (mt_cand(MCRT_QUAD_TRI(q, y), r, tlo, thi) &&
                        mt_hit(MCRT_QUAD_TRI(q, y), MCRT_RAY_HIT(r), MCRT_BIG, &th)) ||
                       (mt_cand(MCRT_QUAD_TRI(q, z), r, tlo, thi) &&
                        mt_hit(MCRT_QUAD_TRI(q, z), MCRT_RAY_HIT(r), MCRT_BIG, &th)) ||
                       (mt_cand(MCRT_QUAD_TRI(q, w), r, tlo, thi) &&
                        mt_hit(MCRT_QUAD_TRI(q, w), MCRT_RAY_HIT(r), MCRT_BIG, &th));
        }
    }
}
#undef MCRT_QUAD_TRI
#undef MCRT_RAY_HIT

__device__ __forceinline__ float warp_max(float v) {
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}
