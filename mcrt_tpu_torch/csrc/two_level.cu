// Two-level (instanced) walk kernels K6 (closest hit) and K7 (any hit) for
// Hopper (sm_90a), with a plain C interface for ctypes (see
// mcrt_tpu_torch/accel/kernels.py).
//
// Replace mcrt_tpu/accel/two_level.py:_closest2_kernel and
// _occluded2_kernel.  The visit lists come from K1 run over the
// (instance, block) pair boxes; a list entry is a pair id, whose pair code
// is (block << 12) | instance.  The walk is K2's / K3's: one CTA per ray
// tile, one thread per ray, `group` list entries per step, the same early
// exits.  What differs is the staging: per group entry the CTA decodes the
// pair code (the block clamped into the table and the instance into the
// instance table, as the JAX package's _pair_group_helpers clamps entries
// past the count), and writes the block's p0/e1/e2 columns into shared
// memory already transformed to world space by the instance's 3x4
// to_world rows, in _world_rows' order of operations.  The transform
// costs 48 flops a slot once per CTA instead of once per ray, and every
// thread then tests untransformed world rays, so t needs no rescaling.
//
// Bound on the card: 54 flops per ray-triangle test (arithmetic bound, as
// K2/K3) plus the 48 flops a staged slot.  Each launch returns
// cudaGetLastError().
#include "blocked.cuh"

#define INST_BITS 12
#define INST_MASK 4095

namespace {

// Stage group entries k*group .. k*group+group-1 of the tile's pair list:
// s_tri holds 9 rows of group*128 world-space triangle floats, s_blk and
// s_inst each entry's block and instance.
__device__ void stage_pair_group(const int* __restrict__ list_row,
                                 const int* __restrict__ pair_code,
                                 const float* __restrict__ tw_rows,
                                 const float* __restrict__ tri, int k, int group,
                                 int ppad, int nt, int n_inst, float* s_tri,
                                 int* s_blk, int* s_inst) {
    const int width = group * MCRT_BLOCK;
    if ((int)threadIdx.x < group) {
        const int e = min(k * group + (int)threadIdx.x, ppad - 1);
        const int code = pair_code[list_row[e]];
        s_blk[threadIdx.x] = min(code >> INST_BITS, nt / MCRT_BLOCK - 1);
        s_inst[threadIdx.x] = min(code & INST_MASK, n_inst - 1);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
        const int g = j / MCRT_BLOCK;
        const float* m = tw_rows + (size_t)s_inst[g] * 12;
        const size_t c = (size_t)s_blk[g] * MCRT_BLOCK + (j % MCRT_BLOCK);
        const float p0x = tri[0 * (size_t)nt + c], p0y = tri[1 * (size_t)nt + c],
                    p0z = tri[2 * (size_t)nt + c];
        const float e1x = tri[3 * (size_t)nt + c], e1y = tri[4 * (size_t)nt + c],
                    e1z = tri[5 * (size_t)nt + c];
        const float e2x = tri[6 * (size_t)nt + c], e2y = tri[7 * (size_t)nt + c],
                    e2z = tri[8 * (size_t)nt + c];
        s_tri[0 * width + j] = m[0] * p0x + m[1] * p0y + m[2] * p0z + m[3];
        s_tri[1 * width + j] = m[4] * p0x + m[5] * p0y + m[6] * p0z + m[7];
        s_tri[2 * width + j] = m[8] * p0x + m[9] * p0y + m[10] * p0z + m[11];
        s_tri[3 * width + j] = m[0] * e1x + m[1] * e1y + m[2] * e1z;
        s_tri[4 * width + j] = m[4] * e1x + m[5] * e1y + m[6] * e1z;
        s_tri[5 * width + j] = m[8] * e1x + m[9] * e1y + m[10] * e1z;
        s_tri[6 * width + j] = m[0] * e2x + m[1] * e2y + m[2] * e2z;
        s_tri[7 * width + j] = m[4] * e2x + m[5] * e2y + m[6] * e2z;
        s_tri[8 * width + j] = m[8] * e2x + m[9] * e2y + m[10] * e2z;
    }
    __syncthreads();
}

// K6: K2's walk over pair lists; tracks the winning (block, instance).
__global__ void closest2_kernel(const int* __restrict__ counts,
                                const float* __restrict__ rays,
                                const int* __restrict__ lists,
                                const float* __restrict__ tn_sorted,
                                const int* __restrict__ pair_code,
                                const float* __restrict__ tw_rows,
                                const float* __restrict__ tri,
                                float* __restrict__ t_out, int* __restrict__ slot_out,
                                int* __restrict__ inst_out, int npad, int ppad, int nt,
                                int n_inst, int group) {
    extern __shared__ float smem[];
    __shared__ float s_red[32];
    const int width = group * MCRT_BLOCK;
    float* s_tri = smem;
    int* s_blk = reinterpret_cast<int*>(smem + 9 * width);
    int* s_inst = s_blk + group;
    const int t = blockIdx.x;
    const int col = t * blockDim.x + threadIdx.x;
    const float ox = rays[0 * npad + col], oy = rays[1 * npad + col],
                oz = rays[2 * npad + col];
    const float dx = rays[3 * npad + col], dy = rays[4 * npad + col],
                dz = rays[5 * npad + col];
    const float tmn = rays[6 * npad + col], tmx = rays[7 * npad + col];
    const int groups = (counts[t] + group - 1) / group;
    const int* list_row = lists + (size_t)t * ppad;
    float best_t = MCRT_BIG;
    int best_slot = -1, best_inst = -1;
    for (int k = 0; k < groups; ++k) {
        const float t_exit = block_max(best_t < tmx ? best_t : tmx, s_red);
        const float tn = tn_sorted[(size_t)t * ppad + min(k * group, ppad - 1)];
        if (!(tn <= t_exit)) break;
        stage_pair_group(list_row, pair_code, tw_rows, tri, k, group, ppad, nt, n_inst,
                         s_tri, s_blk, s_inst);
        if (tmx > tmn) {  // a dead ray (tmax = -BIG) can never hit
            for (int j = 0; j < width; ++j) {
                float th;
                if (mt_hit(s_tri[j], s_tri[width + j], s_tri[2 * width + j],
                           s_tri[3 * width + j], s_tri[4 * width + j],
                           s_tri[5 * width + j], s_tri[6 * width + j],
                           s_tri[7 * width + j], s_tri[8 * width + j], ox, oy, oz, dx,
                           dy, dz, tmn, tmx, best_t, &th)) {
                    best_t = th;
                    best_slot = s_blk[j / MCRT_BLOCK] * MCRT_BLOCK + (j % MCRT_BLOCK);
                    best_inst = s_inst[j / MCRT_BLOCK];
                }
            }
        }
        __syncthreads();  // the next group overwrites s_tri / s_blk / s_inst
    }
    t_out[col] = best_t;
    slot_out[col] = best_slot;
    inst_out[col] = best_inst;
}

// K7: K3's walk over pair lists; the CTA exits once every live ray of the
// tile is blocked.
__global__ void occluded2_kernel(const int* __restrict__ counts,
                                 const float* __restrict__ rays,
                                 const int* __restrict__ lists,
                                 const int* __restrict__ pair_code,
                                 const float* __restrict__ tw_rows,
                                 const float* __restrict__ tri, float* __restrict__ out,
                                 int npad, int ppad, int nt, int n_inst, int group) {
    extern __shared__ float smem[];
    const int width = group * MCRT_BLOCK;
    float* s_tri = smem;
    int* s_blk = reinterpret_cast<int*>(smem + 9 * width);
    int* s_inst = s_blk + group;
    const int t = blockIdx.x;
    const int col = t * blockDim.x + threadIdx.x;
    const float ox = rays[0 * npad + col], oy = rays[1 * npad + col],
                oz = rays[2 * npad + col];
    const float dx = rays[3 * npad + col], dy = rays[4 * npad + col],
                dz = rays[5 * npad + col];
    const float tmn = rays[6 * npad + col], tmx = rays[7 * npad + col];
    const bool live = tmx > tmn;  // inactive rays carry tmax = -BIG
    const int groups = (counts[t] + group - 1) / group;
    const int* list_row = lists + (size_t)t * ppad;
    bool blocked = false;
    for (int k = 0; k < groups; ++k) {
        if (!__syncthreads_or(live && !blocked)) break;
        stage_pair_group(list_row, pair_code, tw_rows, tri, k, group, ppad, nt, n_inst,
                         s_tri, s_blk, s_inst);
        if (live && !blocked) {
            for (int j = 0; j < width; ++j) {
                float th;
                if (mt_hit(s_tri[j], s_tri[width + j], s_tri[2 * width + j],
                           s_tri[3 * width + j], s_tri[4 * width + j],
                           s_tri[5 * width + j], s_tri[6 * width + j],
                           s_tri[7 * width + j], s_tri[8 * width + j], ox, oy, oz, dx,
                           dy, dz, tmn, tmx, MCRT_BIG, &th)) {
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

int mcrt_closest2(const int* counts, const float* rays, const int* lists,
                  const float* tn_sorted, const int* pair_code, const float* tw_rows,
                  const float* tri, float* t_out, int* slot_out, int* inst_out,
                  int npad, int tile, int ppad, int nt, int n_inst, int group,
                  void* stream) {
    closest2_kernel<<<npad / tile, tile, walk_smem(group, 2),
                      static_cast<cudaStream_t>(stream)>>>(
        counts, rays, lists, tn_sorted, pair_code, tw_rows, tri, t_out, slot_out,
        inst_out, npad, ppad, nt, n_inst, group);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_occluded2(const int* counts, const float* rays, const int* lists,
                   const int* pair_code, const float* tw_rows, const float* tri,
                   float* out, int npad, int tile, int ppad, int nt, int n_inst,
                   int group, void* stream) {
    occluded2_kernel<<<npad / tile, tile, walk_smem(group, 2),
                       static_cast<cudaStream_t>(stream)>>>(
        counts, rays, lists, pair_code, tw_rows, tri, out, npad, ppad, nt, n_inst, group);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
