// Blocked-intersector kernels K1-K3 for Hopper (sm_90a), with a plain C
// interface for ctypes (see mcrt_tpu_torch/accel/kernels.py).  The dense
// kernels K4/K5 are in dense.cu, the two-level K6/K7 in two_level.cu; the
// walks' shared device code is in walk.cuh.
//
// Layouts (the JAX package's): rays (8, Npad) rows o.xyz, d.xyz, tmin,
// tmax with inactive and padding rays at tmax = -BIG; tri (16, NT) rows
// p0.xyz, e1.xyz, e2.xyz (rows 9..15 pad); aabb (NBpad, 8) block boxes;
// chunk_aabb (NBpad/128, 8) union box per 128-block chunk.  Each kernel
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include "walk.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1 cull.  Replaces mcrt_tpu/accel/pallas_blocked.py:_cull_kernel.
//
// The keys: (n_tiles, NBpad) floats, per (ray tile, block) the least entry
// distance over the tile's rays, BIG where none enters.  A CTA of 128
// threads serves one ray tile and every `split`-th 128-block chunk of it
// (grid (n_tiles, split)):
//
// 1. Dead tile.  The CTA reads the tile's tmin and tmax first.  If every
//    ray has tmax < tmin (inactive and padding rays carry tmax = -BIG), no
//    ray can enter any box: tn >= tmin > tmax >= tf.  The CTA writes its
//    chunks' keys as float4 BIG and returns.  This is the TPU kernel's
//    any_live exit, on a condition that provably changes no key.  Inactive
//    rays sort last, so in a real frame's late bounces nearly every tile
//    takes it.
// 2. Stage.  The tile's rays go to shared memory once, inverted once, as
//    two float4s a ray, (o.xyz, tmin) and (1/d.xyz, tmax): a test reads
//    them as 2 broadcast LDS.128.
// 3. Level 1.  One warp per chunk, lanes over the tile's rays, stops at the
//    first ray that enters the chunk's union box; a chunk no ray enters
//    (or a NaN chunk) gets its 128 keys written as float4 BIG by that warp,
//    an entered chunk goes onto a shared list.
// 4. Level 2, over the listed chunks only.  Thread lane holds the box of
//    block lane of the chunk.  Each warp first tests the tile's rays, 32 at
//    a time, against the union box of its 32 blocks and then only the rays
//    that enter it, 4 a step, with independent entry distances folded into
//    the key by min (exact and order-free: the keys do not change).
//
// What bounds it on this card: the slab test, 6 subtracts, 6 multiplies
// and 12 min/max (one PTX instruction each, blocked.cuh) on shared-memory
// broadcasts, so entered chunks are operation bound (blocked.cull_tests
// counts the three levels' tests); and the key write, n_tiles x NBpad
// floats (24 MB on sphere_field's 512x512 wavefronts, about 7 us at 3.35
// TB/s), which is the floor of a launch whose tiles are mostly dead.  The
// second grid dimension is for the late bounces' few live tiles, which
// enter about 10 chunks each: with one CTA a tile, such a tile tests its
// chunks one after another while the rest of the card idles, and the
// launch waits for it.  Measured on the H100 (PERF.md): one CTA a tile
// made a real frame's launches 17% slower than 6 chunks a CTA, and 256
// threads a CTA (two ray slices, their keys met in shared memory) slower
// than 128.
// ---------------------------------------------------------------------------
#define CULL_CHUNKS_PER_CTA 6  // split = ceil(chunks / this): a CTA serves at most this many

// Entry distance of the staged ray (o, inv) into box b, BIG where it does not enter.
__device__ __forceinline__ float cull_entry(const float (&b)[6], float4 o, float4 inv) {
    float tn;
    return slab_enter(b, o.x, o.y, o.z, inv.x, inv.y, inv.z, o.w, inv.w, &tn) ? tn : MCRT_BIG;
}

__device__ __forceinline__ bool cull_enters(const float (&b)[6], float4 o, float4 inv) {
    float tn;
    return slab_enter(b, o.x, o.y, o.z, inv.x, inv.y, inv.z, o.w, inv.w, &tn);
}

__device__ __forceinline__ void load_box(const float* __restrict__ p, float (&b)[6]) {
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = __ldg(p + k);
}

// Chunk c's 128 keys of this tile's row as BIG, one float4 a lane.
__device__ __forceinline__ void write_big(float* __restrict__ row, int c, int lane) {
    reinterpret_cast<float4*>(row + c * MCRT_BLOCK)[lane] =
        make_float4(MCRT_BIG, MCRT_BIG, MCRT_BIG, MCRT_BIG);
}

// Level 2 of one warp: the key of this lane's block `box` over the tile's
// rays that enter the warp's union box.
__device__ __forceinline__ float block_key(const float (&box)[6], const float4* s_ray,
                                           int tile, int lane) {
    // A ray that misses the union of the warp's 32 blocks misses each of
    // them (per axis a block's interval lies inside the union's, rounding
    // being monotonic).  NaN boxes drop out of the union (fminf/fmaxf) and
    // fail every test of their own.
    float u[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        float v = box[k];
        for (int off = 16; off > 0; off >>= 1) {
            const float w = __shfl_xor_sync(0xffffffffu, v, off);
            v = k < 3 ? fminf(v, w) : fmaxf(v, w);
        }
        u[k] = v;
    }
    float key = MCRT_BIG;
    for (int g = 0; g < tile; g += 32) {
        const float4* grp = s_ray + 2 * g;
        unsigned mask = __ballot_sync(0xffffffffu,
                                      cull_enters(u, grp[2 * lane], grp[2 * lane + 1]));
        while (mask) {  // 4 entering rays a step; a short step repeats its first
            const int r0 = __ffs(mask) - 1;
            mask &= mask - 1;
            const int r1 = mask ? __ffs(mask) - 1 : r0;
            mask &= mask - 1;
            const int r2 = mask ? __ffs(mask) - 1 : r0;
            mask &= mask - 1;
            const int r3 = mask ? __ffs(mask) - 1 : r0;
            mask &= mask - 1;
            const float k0 = cull_entry(box, grp[2 * r0], grp[2 * r0 + 1]);
            const float k1 = cull_entry(box, grp[2 * r1], grp[2 * r1 + 1]);
            const float k2 = cull_entry(box, grp[2 * r2], grp[2 * r2 + 1]);
            const float k3 = cull_entry(box, grp[2 * r3], grp[2 * r3 + 1]);
            key = fminf(key, fminf(fminf(k0, k1), fminf(k2, k3)));
        }
    }
    return key;
}

__global__ void __launch_bounds__(MCRT_BLOCK)
    cull_kernel(const float* __restrict__ rays, const float* __restrict__ chunk_aabb,
                const float* __restrict__ aabb, float* __restrict__ keys, int npad,
                int tile, int nbpad) {
    extern __shared__ float4 s_ray[];  // 2 a ray: (o.xyz, tmin), (1/d.xyz, tmax)
    __shared__ int s_list[CULL_CHUNKS_PER_CTA];
    __shared__ int s_count;
    const int t = blockIdx.x, split = gridDim.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int n_warps = MCRT_BLOCK / 32;
    float* row = keys + (size_t)t * nbpad;
    // this CTA's chunks: blockIdx.y, + split, ...
    const int n_chunks = nbpad / MCRT_BLOCK;
    const int mine = (n_chunks - (int)blockIdx.y + split - 1) / split;

    int live = 0;
    for (int r = tid; r < tile; r += MCRT_BLOCK)
        live |= !(rays[7 * npad + t * tile + r] < rays[6 * npad + t * tile + r]);
    if (!__syncthreads_or(live)) {
        for (int i = warp; i < mine; i += n_warps)
            write_big(row, blockIdx.y + i * split, lane);
        return;
    }
    for (int r = tid; r < tile; r += MCRT_BLOCK) {
        const int col = t * tile + r;
        s_ray[2 * r] = make_float4(rays[col], rays[npad + col], rays[2 * npad + col],
                                   rays[6 * npad + col]);
        s_ray[2 * r + 1] = make_float4(safe_inv(rays[3 * npad + col]),
                                       safe_inv(rays[4 * npad + col]),
                                       safe_inv(rays[5 * npad + col]), rays[7 * npad + col]);
    }

    if (tid == 0) s_count = 0;
    __syncthreads();

    // level 1: chunk union boxes, a warp each
    for (int i = warp; i < mine; i += n_warps) {
        const int c = blockIdx.y + i * split;
        float cb[6];
        load_box(chunk_aabb + (size_t)c * 8, cb);
        bool in = false;
        if (!box_is_nan(cb)) {
            for (int r = lane; r < tile; r += 32) {  // trip count uniform over the warp
                in = __any_sync(0xffffffffu, cull_enters(cb, s_ray[2 * r], s_ray[2 * r + 1]));
                if (in) break;
            }
        }
        if (!in)
            write_big(row, c, lane);
        else if (lane == 0)
            s_list[atomicAdd(&s_count, 1)] = c;
    }
    __syncthreads();

    // level 2: the listed chunks' blocks against the tile's rays
    const int listed = s_count;
    for (int j = 0; j < listed; ++j) {
        const int b = s_list[j] * MCRT_BLOCK + tid;
        float box[6];
        load_box(aabb + (size_t)b * 8, box);
        row[b] = block_key(box, s_ray, tile, lane);
    }
}

// ---------------------------------------------------------------------------
// The visit-list walks K2 (closest hit) and K3 (any hit).
//
// K2 replaces mcrt_tpu/accel/pallas_blocked.py:_closest_kernel and K3
// _occluded_kernel.  One CTA per ray tile walks the tile's front-to-back
// list of block ids with the test, the per-warp block skip and the cp.async
// staging of walk.cuh; the block rows and boxes are copied straight into
// the buffer the warps test, two buffers deep, so one barrier a group both
// publishes the copies and the warps' partial exit reductions.  The
// tile-wide early exit stays as a bound uniform across the CTA; it
// compares the packed keys' entry distances, which are truncated downward,
// so it stays conservative.
// ---------------------------------------------------------------------------

// Buffer b of the two in dynamic shared memory, laid out as both triangle
// buffers, then both box buffers, then both id lists (16-byte aligned).
__device__ __forceinline__ WalkBuffer walk_buffer(float* smem, int group, int b) {
    const int width = group * MCRT_BLOCK;
    return {smem + b * 9 * width, smem + 18 * width + b * group * 8,
            reinterpret_cast<int*>(smem + 18 * width + 16 * group) + b * group, nullptr};
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

// K2.  The loop head of group k: each warp publishes its max of
// min(best_t, tmax) (dead rays carry tmax = -BIG), the thread waits for its
// own copies of group k, and one barrier makes both the copies and the
// partial maxima visible.  The CTA then exits once group k's nearest entry
// distance lies beyond every live ray's bound, or else starts group k+1's
// copies into the other buffer (free: every warp has passed the barrier,
// so none still tests group k-1) and tests group k.  The partial maxima
// take two slots: no warp can write group k+2's slot before every warp has
// read group k's.  Inactive and padding rays sort to the end of the
// wavefront, so trailing tiles have count 0: such a tile writes misses and
// does nothing else.
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
    int best_slot = -1, no_inst = -1;
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
        closest_group(r, walk_buffer(smem, group, k & 1), group, best_t, best_slot, no_inst);
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

// Dynamic shared memory of K2/K3: two staging buffers, each 9 rows of
// group*128 triangle floats, the group's boxes and block ids.
inline size_t walk2_smem(int group) {
    return 2 * ((size_t)(9 * MCRT_BLOCK + 8) * group * sizeof(float) + group * sizeof(int));
}

}  // namespace

extern "C" {

int mcrt_cull(const float* rays, const float* chunk_aabb, const float* aabb,
              float* keys, int npad, int tile, int nbpad, void* stream) {
    const int n_chunks = nbpad / MCRT_BLOCK;
    const dim3 grid(npad / tile, (n_chunks + CULL_CHUNKS_PER_CTA - 1) / CULL_CHUNKS_PER_CTA);
    cull_kernel<<<grid, MCRT_BLOCK, 2 * tile * sizeof(float4),
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
