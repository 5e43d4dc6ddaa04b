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
