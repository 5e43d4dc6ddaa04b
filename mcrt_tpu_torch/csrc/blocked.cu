// Blocked-intersector kernels K1-K3 for Hopper (sm_90a), with a plain C
// interface for ctypes (see mcrt_tpu_torch/accel/kernels.py).  The dense
// kernels K4/K5 are in dense.cu, the two-level K6/K7 in two_level.cu.
//
// Layouts (the JAX package's): rays (8, Npad) rows o.xyz, d.xyz, tmin,
// tmax with inactive and padding rays at tmax = -BIG; tri (16, NT) rows
// p0.xyz, e1.xyz, e2.xyz (rows 9..15 pad); aabb (NBpad, 8) block boxes;
// chunk_aabb (NBpad/128, 8) union box per 128-block chunk.  Each kernel
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include "blocked.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1 cull.  Replaces mcrt_tpu/accel/pallas_blocked.py:_cull_kernel.
//
// One CTA per (ray tile, 128-block chunk), one thread per block AABB.  The
// tile's rays (origin, inverse direction, tmin, tmax) are staged once in
// shared memory and read as broadcasts.  Level 1: the threads test the
// tile's rays against the chunk's union box and __syncthreads_or decides
// whether the chunk is skipped (no ray enters it, or no ray of the tile is
// live).  Level 2: each thread walks the tile's rays and keeps the minimum
// entry distance of its block.  One key row per tile: the TPU kernel's 8
// duplicate rows are not written.
//
// Bound on the card: the slab test is about 20 flops per (ray, block)
// pair, reading only shared memory, so K1 is arithmetic bound on entered
// chunks; the chunk-level skip removes most pairs because blocks are SAH
// ordered and chunks spatially compact.  Output is n_tiles * NBpad floats.
// ---------------------------------------------------------------------------
__global__ void cull_kernel(const float* __restrict__ rays,
                            const float* __restrict__ chunk_aabb,
                            const float* __restrict__ aabb,
                            float* __restrict__ keys, int npad, int tile,
                            int nbpad) {
    extern __shared__ float s_ray[];  // 8 rows of `tile`: o, 1/d, tmin, tmax
    const int t = blockIdx.x;
    const int c = blockIdx.y;
    const int tid = threadIdx.x;
    for (int r = tid; r < tile; r += blockDim.x) {
        const int col = t * tile + r;
        s_ray[0 * tile + r] = rays[0 * npad + col];
        s_ray[1 * tile + r] = rays[1 * npad + col];
        s_ray[2 * tile + r] = rays[2 * npad + col];
        s_ray[3 * tile + r] = safe_inv(rays[3 * npad + col]);
        s_ray[4 * tile + r] = safe_inv(rays[4 * npad + col]);
        s_ray[5 * tile + r] = safe_inv(rays[5 * npad + col]);
        s_ray[6 * tile + r] = rays[6 * npad + col];
        s_ray[7 * tile + r] = rays[7 * npad + col];
    }
    __syncthreads();

#define MCRT_RAY(r)                                                        \
    s_ray[(r)], s_ray[tile + (r)], s_ray[2 * tile + (r)],                  \
        s_ray[3 * tile + (r)], s_ray[4 * tile + (r)], s_ray[5 * tile + (r)], \
        s_ray[6 * tile + (r)], s_ray[7 * tile + (r)]

    // level 1: the chunk's union box (NaN for an all-empty chunk: skipped)
    const float* cb = chunk_aabb + c * 8;
    int enter_any = 0;
    if (!box_is_nan(cb)) {
        for (int r = tid; r < tile && !enter_any; r += blockDim.x) {
            float tn;
            enter_any = slab_enter(cb, MCRT_RAY(r), &tn);
        }
    }
    enter_any = __syncthreads_or(enter_any);

    // level 2: this thread's block against every ray of the tile
    const int b = c * MCRT_BLOCK + tid;
    float key = MCRT_BIG;
    const float* bb = aabb + (size_t)b * 8;
    if (enter_any && !box_is_nan(bb)) {
        const float box[6] = {bb[0], bb[1], bb[2], bb[3], bb[4], bb[5]};
        for (int r = 0; r < tile; ++r) {
            float tn;
            if (slab_enter(box, MCRT_RAY(r), &tn) && tn < key) key = tn;
        }
    }
#undef MCRT_RAY
    keys[(size_t)t * nbpad + b] = key;
}

// ---------------------------------------------------------------------------
// The visit-list walks K2 (closest hit) and K3 (any hit).
//
// K2 replaces mcrt_tpu/accel/pallas_blocked.py:_closest_kernel and K3
// _occluded_kernel.  One CTA per ray tile (`tile` threads, one per ray)
// walks the tile's front-to-back visit list `group` blocks at a time.
//
// What bounds them on this card: instruction slots.  Every operand of a
// ray-triangle test is a shared-memory broadcast and the work is float32
// arithmetic, so a walk is operation bound; the bound counts a
// Moller-Trumbore test as 54 operations, 27 fused multiply-adds.  Three
// costs kept the first port of these walks near a tenth of that bound, and
// the design answers each:
//
// 1. The test (mt_cand).  Products and dot products are written with
//    __fmaf_rn, so they fuse although the library keeps -fmad=false for
//    K1 and K4-K9.  The division is deferred: u, v and t are compared in
//    their unscaled form (u*det, v*det, t*det against det, made
//    sign-aware by flipping the sign bit with det's), with a relative
//    slack of 2^-10, and no pair divides.  The rare pair that passes is
//    decided by mt_hit, the plain version's own arithmetic (an IEEE
//    reciprocal): a hit distance on a cancelling triangle (a bounce ray's
//    t of 1e-3, say) moves by up to 1e-3 relative under reordered
//    rounding, so t is taken from the plain arithmetic, and the slack keeps
//    the fused rejection from dropping a pair the plain test accepts.  A
//    thread tests 4 consecutive triangles per step, reading each of the 9
//    staged SoA rows as one float4: 9 LDS.128 broadcasts per 4 tests, and
//    no bank conflict, since a warp reads one address.
// 2. Blocks the ray never enters.  The list is the union over the tile's
//    rays (K1), and incoherent bounce rays enter few of its blocks.  The
//    group's block boxes are staged with its triangles; before each block
//    every lane runs the slab test (slab_enter: NaN boxes never pass), and
//    the warp skips the block's 128 tests when __ballot_sync finds no lane
//    entering (K2: the box is entered no farther than min(best_t, tmax);
//    K3: the lane is live and not yet blocked).  A warp that tests a block
//    tests it on every lane, so only blocks a whole warp skips can change
//    a result.  The tile-wide early exit stays as a bound uniform across
//    the CTA; it compares the packed keys' entry distances, which are
//    truncated downward, so it stays conservative.
// 3. Staging.  The group's triangle rows and boxes are double buffered in
//    shared memory with 16-byte cp.async copies: group k+1 is in flight
//    while group k is tested, as in the TPU kernel.  One barrier a group
//    both publishes the copies and the warps' partial exit reductions.
//
// Numerics: a pair is decided, and its t computed, exactly as in the plain
// versions (accel/blocked.py); what can differ is a pair the fused
// prefilter rejects beyond its slack (a grazing edge, or a tie between the
// two triangles of a shared edge) and a block a whole warp skips at the
// box's rounding edge.  The kernels are held to the plain versions within
// a stated share of differing rays (chip_smoke.py).
// ---------------------------------------------------------------------------

// The widest ray tile K2/K3 take (their launch bound; kernels.py checks it).
#define MCRT_WALK_MAX_TILE 256
// 16-byte copies a staged block takes: 9 rows of 128 floats, and its box.
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

// One staging buffer of the walk: 9 SoA rows of group*128 triangle floats,
// the group's boxes (8 floats each) and block ids.
struct WalkBuffer {
    float* tri;
    float* box;
    int* ent;
};

// Buffer b of the two in dynamic shared memory, laid out as both triangle
// buffers, then both box buffers, then both id lists (16-byte aligned).
__device__ __forceinline__ WalkBuffer walk_buffer(float* smem, int group, int b) {
    const int width = group * MCRT_BLOCK;
    return {smem + b * 9 * width, smem + 18 * width + b * group * 8,
            reinterpret_cast<int*>(smem + 18 * width + 16 * group) + b * group};
}

// Start the cp.async copies of group k's blocks into `buf` and commit them.
// Entries past the list's end are clamped into the table, as the JAX
// package's _group_helpers does: testing a real block twice is redundant
// but harmless.
__device__ __forceinline__ void stage_async(const int* __restrict__ list_row,
                                            const float* __restrict__ tri,
                                            const float* __restrict__ aabb, int k,
                                            int group, int nbpad, int nt, WalkBuffer buf) {
    const int width = group * MCRT_BLOCK;
    for (int i = threadIdx.x; i < group * WALK_CHUNKS; i += blockDim.x) {
        const int g = i / WALK_CHUNKS, c = i - g * WALK_CHUNKS;
        const int b = min(__ldg(list_row + min(k * group + g, nbpad - 1)),
                          nt / MCRT_BLOCK - 1);
        if (c < WALK_ROW_CHUNKS) {
            const int row = c / (MCRT_BLOCK / 4), q = (c % (MCRT_BLOCK / 4)) * 4;
            cp_async16(buf.tri + row * width + g * MCRT_BLOCK + q,
                       tri + (size_t)row * nt + (size_t)b * MCRT_BLOCK + q);
        } else {
            const int q = (c - WALK_ROW_CHUNKS) * 4;
            if (q == 0) buf.ent[g] = b;
            cp_async16(buf.box + g * 8 + q, aabb + (size_t)b * 8 + q);
        }
    }
    cp_async_commit();
}

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

// The slab test of the ray against staged box g (lo.xyz, hi.xyz, 2 pad).
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

// K2 over one staged group: per block, the warp-wide skip, then the 128
// tests in slot order, 4 a step.
__device__ __forceinline__ void closest_group(const WalkRay& r, WalkBuffer buf, int group,
                                              float& best_t, int& best_slot) {
    const int width = group * MCRT_BLOCK;
    const float tlo = r.tmn * (1.0f - MCRT_CAND_SLACK);
    for (int g = 0; g < group; ++g) {
        float tn;
        const bool in = enters(r, buf.box + g * 8, &tn) && tn <= best_t;
        if (!__ballot_sync(0xffffffffu, in)) continue;
        const float* rows = buf.tri + g * MCRT_BLOCK;
        const int base = buf.ent[g] * MCRT_BLOCK;
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
            }
            if (mt_cand(MCRT_QUAD_TRI(q, y), r, tlo, thi) &&
                mt_hit(MCRT_QUAD_TRI(q, y), MCRT_RAY_HIT(r), best_t, &th)) {
                best_t = th;
                best_slot = base + j + 1;
            }
            if (mt_cand(MCRT_QUAD_TRI(q, z), r, tlo, thi) &&
                mt_hit(MCRT_QUAD_TRI(q, z), MCRT_RAY_HIT(r), best_t, &th)) {
                best_t = th;
                best_slot = base + j + 2;
            }
            if (mt_cand(MCRT_QUAD_TRI(q, w), r, tlo, thi) &&
                mt_hit(MCRT_QUAD_TRI(q, w), MCRT_RAY_HIT(r), best_t, &th)) {
                best_t = th;
                best_slot = base + j + 3;
            }
        }
    }
}

// K3 over one staged group: per block, the warp-wide skip, then the tests
// until every lane of the warp is blocked or dead.
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

// K2.  The loop head of group k: each warp publishes its max of
// min(best_t, tmax) (dead rays carry tmax = -BIG), the thread waits for its
// own copies of group k, and one barrier makes both the copies and the
// partial maxima visible.  The CTA then exits once group k's nearest entry
// distance lies beyond every live ray's bound, or else starts group k+1's
// copies into the other buffer (free: every warp has passed the barrier,
// so none still tests group k-1) and tests group k.  Inactive and padding
// rays sort to the end of the wavefront, so trailing tiles have count 0:
// such a tile writes misses and does nothing else.
__global__ void __launch_bounds__(MCRT_WALK_MAX_TILE)
    closest_kernel(const int* __restrict__ counts, const float* __restrict__ rays,
                   const int* __restrict__ lists, const float* __restrict__ tn_sorted,
                   const float* __restrict__ tri, const float* __restrict__ aabb,
                   float* __restrict__ t_out, int* __restrict__ slot_out, int npad,
                   int nbpad, int nt, int group) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float s_red[2][32];
    const int t = blockIdx.x;
    const int col = t * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const WalkRay r = load_ray(rays, npad, col);
    const int groups = (counts[t] + group - 1) / group;
    const int* list_row = lists + (size_t)t * nbpad;
    const float* tn_row = tn_sorted + (size_t)t * nbpad;
    float best_t = MCRT_BIG;
    int best_slot = -1;
    if (groups > 0)
        stage_async(list_row, tri, aabb, 0, group, nbpad, nt, walk_buffer(smem, group, 0));
    for (int k = 0; k < groups; ++k) {
        const float m = warp_max(best_t < r.tmx ? best_t : r.tmx);
        if (lane == 0) s_red[k & 1][warp] = m;
        const float tn = tn_row[min(k * group, nbpad - 1)];
        cp_async_wait_all();
        __syncthreads();
        float t_exit = s_red[k & 1][0];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) t_exit = fmaxf(t_exit, s_red[k & 1][w]);
        if (!(tn <= t_exit)) break;
        if (k + 1 < groups)
            stage_async(list_row, tri, aabb, k + 1, group, nbpad, nt,
                        walk_buffer(smem, group, (k + 1) & 1));
        closest_group(r, walk_buffer(smem, group, k & 1), group, best_t, best_slot);
    }
    t_out[col] = best_t;
    slot_out[col] = best_slot;
}

// K3.  K2's loop with the any-hit exit: the CTA stops once no warp has a
// live ray left unblocked.
__global__ void __launch_bounds__(MCRT_WALK_MAX_TILE)
    occluded_kernel(const int* __restrict__ counts, const float* __restrict__ rays,
                    const int* __restrict__ lists, const float* __restrict__ tri,
                    const float* __restrict__ aabb, float* __restrict__ out, int npad,
                    int nbpad, int nt, int group) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float s_red[2][32];
    const int t = blockIdx.x;
    const int col = t * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const WalkRay r = load_ray(rays, npad, col);
    const bool live = r.tmx > r.tmn;  // inactive rays carry tmax = -BIG
    const int groups = (counts[t] + group - 1) / group;
    const int* list_row = lists + (size_t)t * nbpad;
    bool blocked = false;
    if (groups > 0)
        stage_async(list_row, tri, aabb, 0, group, nbpad, nt, walk_buffer(smem, group, 0));
    for (int k = 0; k < groups; ++k) {
        const bool open = __any_sync(0xffffffffu, live && !blocked);
        if (lane == 0) s_red[k & 1][warp] = open ? 1.0f : 0.0f;
        cp_async_wait_all();
        __syncthreads();
        float any_open = 0.0f;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) any_open = fmaxf(any_open, s_red[k & 1][w]);
        if (any_open == 0.0f) break;
        if (k + 1 < groups)
            stage_async(list_row, tri, aabb, k + 1, group, nbpad, nt,
                        walk_buffer(smem, group, (k + 1) & 1));
        occluded_group(r, live, walk_buffer(smem, group, k & 1), group, blocked);
    }
    out[col] = blocked ? 1.0f : 0.0f;
}

// Dynamic shared memory of K2/K3: two staging buffers.
inline size_t walk2_smem(int group) {
    return 2 * (walk_smem(group, 1) + (size_t)group * 8 * sizeof(float));
}

// Above 48 KB (group > 5) a kernel takes dynamic shared memory only after
// opting in.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace

extern "C" {

int mcrt_cull(const float* rays, const float* chunk_aabb, const float* aabb,
              float* keys, int npad, int tile, int nbpad, void* stream) {
    const dim3 grid(npad / tile, nbpad / MCRT_BLOCK);
    cull_kernel<<<grid, MCRT_BLOCK, 8 * tile * sizeof(float),
                  static_cast<cudaStream_t>(stream)>>>(rays, chunk_aabb, aabb,
                                                       keys, npad, tile, nbpad);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_closest(const int* counts, const float* rays, const int* lists,
                 const float* tn_sorted, const float* tri, const float* aabb,
                 float* t_out, int* slot_out, int npad, int tile, int nbpad, int nt,
                 int group, void* stream) {
    const size_t smem = walk2_smem(group);
    const cudaError_t err = opt_in_smem(closest_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    closest_kernel<<<npad / tile, tile, smem, static_cast<cudaStream_t>(stream)>>>(
        counts, rays, lists, tn_sorted, tri, aabb, t_out, slot_out, npad, nbpad, nt,
        group);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_occluded(const int* counts, const float* rays, const int* lists,
                  const float* tri, const float* aabb, float* out, int npad, int tile,
                  int nbpad, int nt, int group, void* stream) {
    const size_t smem = walk2_smem(group);
    const cudaError_t err = opt_in_smem(occluded_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    occluded_kernel<<<npad / tile, tile, smem, static_cast<cudaStream_t>(stream)>>>(
        counts, rays, lists, tri, aabb, out, npad, nbpad, nt, group);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
