// Two-level (instanced) walk kernels K6 (closest hit) and K7 (any hit) for
// Hopper (sm_90a), with a plain C interface for ctypes (see
// mcrt_tpu_torch/accel/kernels.py).
//
// Replace mcrt_tpu/accel/two_level.py:_closest2_kernel and
// _occluded2_kernel.  The visit lists come from K1 run over the
// (instance, block) pair boxes; a list entry is a pair id, whose pair code
// is (block << 12) | instance.  The walk is K2's / K3's (walk.cuh): the
// fused prefilter decided by mt_hit, 4 triangles a step read as float4,
// and the per-warp skip of entries no lane enters, here on each entry's
// world-space pair box (pair_aabb, the table K1 culled), staged by pair id.
//
// What differs is the staging.  The warps test world rays against world
// rows: each staged slot's p0/e1/e2 are transformed once per CTA by the
// instance's 3x4 to_world rows (48 operations a slot), unfused and in
// _world_rows' order of operations, so the rows a pair is decided on are
// bit-equal to the plain version's and t needs no rescaling.  Two buffers:
// the raw one, which cp.async fills with group k+1's object-space rows and
// pair boxes (and pair codes, stored plainly) while the warps test group k,
// and the world one that the warps test.  A group takes two barriers:
//
//   wait for this thread's copies of group k; barrier 1 (publishes the
//   copies and the warps' exit partials); the exit test; raw -> world;
//   barrier 2 (publishes the world rows; raw is free); start group k+1's
//   copies into raw; test group k.
//
// One slot of exit partials suffices: a warp writes group k+1's partial
// only after barrier 2 of group k, by which every warp has read group k's.
// Block and instance are clamped into their tables, as the JAX package's
// _pair_group_helpers clamps entries past the count.
//
// Bound on the card: 54 operations per ray-triangle test (operation bound,
// as K2/K3) plus the 48 operations a staged slot.  Each launch returns
// cudaGetLastError().
#include "walk.cuh"

#define INST_BITS 12
#define INST_MASK 4095

namespace {

// The raw buffer: object-space rows, pair boxes and pair codes of a group.
struct PairStage {
    float* tri;
    float* box;
    int* code;
};

// Dynamic shared memory, laid out as the raw rows, the world rows, the raw
// boxes, the world boxes (16-byte aligned), then the raw pair codes and the
// world block ids and instances.
__device__ __forceinline__ void pair_buffers(float* smem, int group, PairStage* raw,
                                             WalkBuffer* world) {
    const int width = group * MCRT_BLOCK;
    int* ids = reinterpret_cast<int*>(smem + 18 * width + 16 * group);
    *raw = {smem, smem + 18 * width, ids};
    *world = {smem + 9 * width, smem + 18 * width + 8 * group, ids + group, ids + 2 * group};
}

inline size_t pair_smem(int group) {
    return (size_t)(18 * MCRT_BLOCK + 16) * group * sizeof(float) + 3 * group * sizeof(int);
}

// Start the cp.async copies of group k's pairs into `raw` and commit them:
// each entry's block rows (by its pair code's block) and pair box (by its
// pair id).
__device__ __forceinline__ void stage_pairs(const int* __restrict__ list_row,
                                            const int* __restrict__ pair_code,
                                            const float* __restrict__ pair_aabb,
                                            const float* __restrict__ tri, int k, int group,
                                            int ppad, int nt, PairStage raw) {
    const int width = group * MCRT_BLOCK;
    for (int i = threadIdx.x; i < group * WALK_CHUNKS; i += blockDim.x) {
        const int g = i / WALK_CHUNKS, c = i - g * WALK_CHUNKS;
        const int p = __ldg(list_row + min(k * group + g, ppad - 1));
        const int code = __ldg(pair_code + p);
        if (c < WALK_ROW_CHUNKS) {
            const int b = min(code >> INST_BITS, nt / MCRT_BLOCK - 1);
            const int row = c / (MCRT_BLOCK / 4), q = (c % (MCRT_BLOCK / 4)) * 4;
            cp_async16(raw.tri + row * width + g * MCRT_BLOCK + q,
                       tri + (size_t)row * nt + (size_t)b * MCRT_BLOCK + q);
        } else {
            const int q = (c - WALK_ROW_CHUNKS) * 4;
            if (q == 0) raw.code[g] = code;
            cp_async16(raw.box + g * 8 + q, pair_aabb + (size_t)p * 8 + q);
        }
    }
    cp_async_commit();
}

// raw -> world: every slot's rows under its instance's to_world rows, in
// _world_rows' order (p0' = R p0 + t, e1' = R e1, e2' = R e2), and each
// entry's box, block id and instance.
__device__ __forceinline__ void to_world(PairStage raw, WalkBuffer world,
                                         const float* __restrict__ tw_rows, int group, int nt,
                                         int n_inst) {
    const int width = group * MCRT_BLOCK;
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
        const int inst = min(raw.code[j / MCRT_BLOCK] & INST_MASK, n_inst - 1);
        const float* m = tw_rows + (size_t)inst * 12;
        float r[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) r[i] = __ldg(m + i);
        const float* s = raw.tri + j;
        const float p0x = s[0], p0y = s[width], p0z = s[2 * width];
        const float e1x = s[3 * width], e1y = s[4 * width], e1z = s[5 * width];
        const float e2x = s[6 * width], e2y = s[7 * width], e2z = s[8 * width];
        float* d = world.tri + j;
        d[0] = r[0] * p0x + r[1] * p0y + r[2] * p0z + r[3];
        d[width] = r[4] * p0x + r[5] * p0y + r[6] * p0z + r[7];
        d[2 * width] = r[8] * p0x + r[9] * p0y + r[10] * p0z + r[11];
        d[3 * width] = r[0] * e1x + r[1] * e1y + r[2] * e1z;
        d[4 * width] = r[4] * e1x + r[5] * e1y + r[6] * e1z;
        d[5 * width] = r[8] * e1x + r[9] * e1y + r[10] * e1z;
        d[6 * width] = r[0] * e2x + r[1] * e2y + r[2] * e2z;
        d[7 * width] = r[4] * e2x + r[5] * e2y + r[6] * e2z;
        d[8 * width] = r[8] * e2x + r[9] * e2y + r[10] * e2z;
    }
    for (int j = threadIdx.x; j < 8 * group; j += blockDim.x) world.box[j] = raw.box[j];
    if ((int)threadIdx.x < group) {
        const int code = raw.code[threadIdx.x];
        world.ent[threadIdx.x] = min(code >> INST_BITS, nt / MCRT_BLOCK - 1);
        world.inst[threadIdx.x] = min(code & INST_MASK, n_inst - 1);
    }
}

// K6: K2's walk over pair lists; tracks the winning (slot, instance).
__global__ void __launch_bounds__(MCRT_WALK_MAX_TILE)
    closest2_kernel(const int* __restrict__ counts, const float* __restrict__ rays,
                    const int* __restrict__ lists, const float* __restrict__ tn_sorted,
                    const int* __restrict__ pair_code, const float* __restrict__ tw_rows,
                    const float* __restrict__ pair_aabb, const float* __restrict__ tri,
                    float* __restrict__ t_out, int* __restrict__ slot_out,
                    int* __restrict__ inst_out, int npad, int ppad, int nt, int n_inst,
                    int group) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float s_red[32];
    PairStage raw;
    WalkBuffer world;
    pair_buffers(smem, group, &raw, &world);
    const int t = blockIdx.x;
    const int col = t * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const WalkRay r = load_ray(rays, npad, col);
    const int groups = (counts[t] + group - 1) / group;
    const int* list_row = lists + (size_t)t * ppad;
    const float* tn_row = tn_sorted + (size_t)t * ppad;
    float best_t = MCRT_BIG;
    int best_slot = -1, best_inst = -1;
    if (groups > 0) stage_pairs(list_row, pair_code, pair_aabb, tri, 0, group, ppad, nt, raw);
    for (int k = 0; k < groups; ++k) {
        const float m = warp_max(best_t < r.tmx ? best_t : r.tmx);
        if (lane == 0) s_red[warp] = m;
        const float tn = tn_row[min(k * group, ppad - 1)];
        cp_async_wait_all();
        __syncthreads();
        float t_exit = s_red[0];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) t_exit = fmaxf(t_exit, s_red[w]);
        if (!(tn <= t_exit)) break;
        to_world(raw, world, tw_rows, group, nt, n_inst);
        __syncthreads();
        if (k + 1 < groups)
            stage_pairs(list_row, pair_code, pair_aabb, tri, k + 1, group, ppad, nt, raw);
        closest_group(r, world, group, best_t, best_slot, best_inst);
    }
    t_out[col] = best_t;
    slot_out[col] = best_slot;
    inst_out[col] = best_inst;
}

// K7: K3's walk over pair lists; the CTA exits once every live ray of the
// tile is blocked.
__global__ void __launch_bounds__(MCRT_WALK_MAX_TILE)
    occluded2_kernel(const int* __restrict__ counts, const float* __restrict__ rays,
                     const int* __restrict__ lists, const int* __restrict__ pair_code,
                     const float* __restrict__ tw_rows, const float* __restrict__ pair_aabb,
                     const float* __restrict__ tri, float* __restrict__ out, int npad,
                     int ppad, int nt, int n_inst, int group) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float s_red[32];
    PairStage raw;
    WalkBuffer world;
    pair_buffers(smem, group, &raw, &world);
    const int t = blockIdx.x;
    const int col = t * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const WalkRay r = load_ray(rays, npad, col);
    const bool live = r.tmx > r.tmn;  // inactive rays carry tmax = -BIG
    const int groups = (counts[t] + group - 1) / group;
    const int* list_row = lists + (size_t)t * ppad;
    bool blocked = false;
    if (groups > 0) stage_pairs(list_row, pair_code, pair_aabb, tri, 0, group, ppad, nt, raw);
    for (int k = 0; k < groups; ++k) {
        const bool open = __any_sync(0xffffffffu, live && !blocked);
        if (lane == 0) s_red[warp] = open ? 1.0f : 0.0f;
        cp_async_wait_all();
        __syncthreads();
        float any_open = 0.0f;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) any_open = fmaxf(any_open, s_red[w]);
        if (any_open == 0.0f) break;
        to_world(raw, world, tw_rows, group, nt, n_inst);
        __syncthreads();
        if (k + 1 < groups)
            stage_pairs(list_row, pair_code, pair_aabb, tri, k + 1, group, ppad, nt, raw);
        occluded_group(r, live, world, group, blocked);
    }
    out[col] = blocked ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

int mcrt_closest2(const int* counts, const float* rays, const int* lists,
                  const float* tn_sorted, const int* pair_code, const float* tw_rows,
                  const float* pair_aabb, const float* tri, float* t_out, int* slot_out,
                  int* inst_out, int npad, int tile, int ppad, int nt, int n_inst, int group,
                  void* stream) {
    const size_t smem = pair_smem(group);
    const cudaError_t err = opt_in_smem(closest2_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    closest2_kernel<<<npad / tile, tile, smem, static_cast<cudaStream_t>(stream)>>>(
        counts, rays, lists, tn_sorted, pair_code, tw_rows, pair_aabb, tri, t_out, slot_out,
        inst_out, npad, ppad, nt, n_inst, group);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_occluded2(const int* counts, const float* rays, const int* lists,
                   const int* pair_code, const float* tw_rows, const float* pair_aabb,
                   const float* tri, float* out, int npad, int tile, int ppad, int nt,
                   int n_inst, int group, void* stream) {
    const size_t smem = pair_smem(group);
    const cudaError_t err = opt_in_smem(occluded2_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    occluded2_kernel<<<npad / tile, tile, smem, static_cast<cudaStream_t>(stream)>>>(
        counts, rays, lists, pair_code, tw_rows, pair_aabb, tri, out, npad, ppad, nt, n_inst,
        group);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
