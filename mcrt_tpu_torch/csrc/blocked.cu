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

// Stage `group` visit-list entries' triangle columns into shared memory:
// s_tri is 9 rows of group*128 floats (p0, e1, e2 components), s_ent the
// entries' block ids.  Entries past `count` are clamped into the real
// table, as the JAX package's _group_helpers does: testing a real block
// twice is redundant but harmless.
__device__ void stage_group(const int* __restrict__ list_row,
                            const float* __restrict__ tri, int k, int group,
                            int nbpad, int nt, float* s_tri, int* s_ent) {
    const int width = group * MCRT_BLOCK;
    if ((int)threadIdx.x < group) {
        const int e = min(k * group + (int)threadIdx.x, nbpad - 1);
        s_ent[threadIdx.x] = min(list_row[e], nt / MCRT_BLOCK - 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 9 * width; i += blockDim.x) {
        const int comp = i / width, j = i - comp * width;
        const int b = s_ent[j / MCRT_BLOCK];
        s_tri[i] = tri[(size_t)comp * nt + (size_t)b * MCRT_BLOCK + (j % MCRT_BLOCK)];
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// K2 closest hit.  Replaces pallas_blocked.py:_closest_kernel.
//
// One CTA per ray tile, one thread per ray.  The CTA walks the tile's
// front-to-back visit list `group` blocks at a time: all threads stage the
// group's 9 x group*128 triangle floats in shared memory, then each thread
// runs Moller-Trumbore over them in list order with strict t < best_t, so
// ties go to the first triangle visited (the Pallas kernel's argmin).  The
// early exit compares the next group's entry distance with the block-wide
// max over rays of min(best_t, tmax); that bound is uniform across the CTA,
// so the loop condition is too.  Inactive and padding rays carry
// tmax = -BIG and sort to the end of the wavefront, so trailing tiles have
// count 0: such a tile writes misses and does nothing else.
//
// Bound on the card: about 30 flops per ray-triangle test with operands
// broadcast from shared memory, so K2 is arithmetic bound; staging moves
// 4.6 KB per block, reused by every ray of the tile.  Coherent tiles and
// the early exit keep the visited-block count low.
// ---------------------------------------------------------------------------
__global__ void closest_kernel(const int* __restrict__ counts,
                               const float* __restrict__ rays,
                               const int* __restrict__ lists,
                               const float* __restrict__ tn_sorted,
                               const float* __restrict__ tri,
                               float* __restrict__ t_out,
                               int* __restrict__ slot_out, int npad, int nbpad,
                               int nt, int group) {
    extern __shared__ float smem[];
    __shared__ float s_red[32];
    const int width = group * MCRT_BLOCK;
    float* s_tri = smem;
    int* s_ent = reinterpret_cast<int*>(smem + 9 * width);
    const int t = blockIdx.x;
    const int col = t * blockDim.x + threadIdx.x;
    const float ox = rays[0 * npad + col], oy = rays[1 * npad + col],
                oz = rays[2 * npad + col];
    const float dx = rays[3 * npad + col], dy = rays[4 * npad + col],
                dz = rays[5 * npad + col];
    const float tmn = rays[6 * npad + col], tmx = rays[7 * npad + col];
    const int groups = (counts[t] + group - 1) / group;
    const int* list_row = lists + (size_t)t * nbpad;
    float best_t = MCRT_BIG;
    int best_slot = -1;
    for (int k = 0; k < groups; ++k) {
        const float t_exit = block_max(best_t < tmx ? best_t : tmx, s_red);
        const float tn = tn_sorted[(size_t)t * nbpad + min(k * group, nbpad - 1)];
        if (!(tn <= t_exit)) break;
        stage_group(list_row, tri, k, group, nbpad, nt, s_tri, s_ent);
        if (tmx > tmn) {  // a dead ray (tmax = -BIG) can never hit
            for (int j = 0; j < width; ++j) {
                float th;
                if (mt_hit(s_tri[j], s_tri[width + j], s_tri[2 * width + j],
                           s_tri[3 * width + j], s_tri[4 * width + j],
                           s_tri[5 * width + j], s_tri[6 * width + j],
                           s_tri[7 * width + j], s_tri[8 * width + j], ox, oy,
                           oz, dx, dy, dz, tmn, tmx, best_t, &th)) {
                    best_t = th;
                    best_slot = s_ent[j / MCRT_BLOCK] * MCRT_BLOCK + (j % MCRT_BLOCK);
                }
            }
        }
        __syncthreads();  // the next group overwrites s_tri / s_ent
    }
    t_out[col] = best_t;
    slot_out[col] = best_slot;
}

// ---------------------------------------------------------------------------
// K3 any hit.  Replaces pallas_blocked.py:_occluded_kernel.
//
// The same walk as K2 without the entry-distance bound: the CTA exits once
// __syncthreads_or finds no live ray left unblocked.  A blocked ray stops
// testing.  Bound on the card: as K2, arithmetic bound, usually shorter
// because shadow rays stop at their first hit.
// ---------------------------------------------------------------------------
__global__ void occluded_kernel(const int* __restrict__ counts,
                                const float* __restrict__ rays,
                                const int* __restrict__ lists,
                                const float* __restrict__ tri,
                                float* __restrict__ out, int npad, int nbpad,
                                int nt, int group) {
    extern __shared__ float smem[];
    const int width = group * MCRT_BLOCK;
    float* s_tri = smem;
    int* s_ent = reinterpret_cast<int*>(smem + 9 * width);
    const int t = blockIdx.x;
    const int col = t * blockDim.x + threadIdx.x;
    const float ox = rays[0 * npad + col], oy = rays[1 * npad + col],
                oz = rays[2 * npad + col];
    const float dx = rays[3 * npad + col], dy = rays[4 * npad + col],
                dz = rays[5 * npad + col];
    const float tmn = rays[6 * npad + col], tmx = rays[7 * npad + col];
    const bool live = tmx > tmn;  // inactive rays carry tmax = -BIG
    const int groups = (counts[t] + group - 1) / group;
    const int* list_row = lists + (size_t)t * nbpad;
    bool blocked = false;
    for (int k = 0; k < groups; ++k) {
        if (!__syncthreads_or(live && !blocked)) break;
        stage_group(list_row, tri, k, group, nbpad, nt, s_tri, s_ent);
        if (live && !blocked) {
            for (int j = 0; j < width; ++j) {
                float th;
                if (mt_hit(s_tri[j], s_tri[width + j], s_tri[2 * width + j],
                           s_tri[3 * width + j], s_tri[4 * width + j],
                           s_tri[5 * width + j], s_tri[6 * width + j],
                           s_tri[7 * width + j], s_tri[8 * width + j], ox, oy,
                           oz, dx, dy, dz, tmn, tmx, MCRT_BIG, &th)) {
                    blocked = true;
                    break;
                }
            }
        }
        __syncthreads();
    }
    out[col] = blocked ? 1.0f : 0.0f;
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
                 const float* tn_sorted, const float* tri, float* t_out,
                 int* slot_out, int npad, int tile, int nbpad, int nt,
                 int group, void* stream) {
    closest_kernel<<<npad / tile, tile, walk_smem(group, 1),
                     static_cast<cudaStream_t>(stream)>>>(
        counts, rays, lists, tn_sorted, tri, t_out, slot_out, npad, nbpad, nt,
        group);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_occluded(const int* counts, const float* rays, const int* lists,
                  const float* tri, float* out, int npad, int tile, int nbpad,
                  int nt, int group, void* stream) {
    occluded_kernel<<<npad / tile, tile, walk_smem(group, 1),
                      static_cast<cudaStream_t>(stream)>>>(
        counts, rays, lists, tri, out, npad, nbpad, nt, group);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
