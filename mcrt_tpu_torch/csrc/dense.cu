// Dense small-scene kernels K4 (closest hit) and K5 (any hit) for Hopper
// (sm_90a), with a plain C interface for ctypes (see
// mcrt_tpu_torch/accel/kernels.py).
//
// Replace mcrt_tpu/accel/pallas_blocked.py:_dense_closest_kernel and
// _dense_any_kernel: for scenes of at most 8 blocks (1,024 triangle slots)
// there is no cull, no sort and no visit list; every ray tests every slot.
//
// Layouts (the JAX package's): rays (8, Npad) rows o.xyz, d.xyz, tmin,
// tmax with inactive and padding rays at tmax = -BIG; tri (16, NT) rows
// p0.xyz, e1.xyz, e2.xyz, NT <= 1024.  One thread per ray, a CTA of
// DENSE_CTA rays; the CTA stages the table's 9 used rows (at most
// 9 x 1,024 x 4 B = 36 KB, under the 48 KB of default dynamic shared
// memory) once, and every thread then reads them as broadcasts.  The grid
// masks the ragged end of the wavefront, so Npad needs no wider padding.
//
// Bound on the card: 54 flops per ray-triangle test on operands broadcast
// from shared memory, against 32 bytes of ray read and at most 8 written
// per ray, so both kernels are arithmetic bound: K4 runs live rays x NT
// tests, K5 stops each ray at its first blocking slot.  Each launch
// returns cudaGetLastError().
#include "blocked.cuh"

#define DENSE_CTA 256

namespace {

__device__ void stage_table(const float* __restrict__ tri, int nt, float* s_tri) {
    for (int i = threadIdx.x; i < 9 * nt; i += blockDim.x) s_tri[i] = tri[i];
    __syncthreads();
}

// K4: ties go to the lowest slot (strict <, slots in order), which is the
// Pallas kernel's first argmin within a block and strict < across blocks.
__global__ void dense_closest_kernel(const float* __restrict__ rays,
                                     const float* __restrict__ tri,
                                     float* __restrict__ t_out,
                                     int* __restrict__ slot_out, int npad, int nt) {
    extern __shared__ float s_tri[];  // 9 rows of nt
    stage_table(tri, nt, s_tri);
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= npad) return;
    const float ox = rays[0 * npad + col], oy = rays[1 * npad + col],
                oz = rays[2 * npad + col];
    const float dx = rays[3 * npad + col], dy = rays[4 * npad + col],
                dz = rays[5 * npad + col];
    const float tmn = rays[6 * npad + col], tmx = rays[7 * npad + col];
    float best_t = MCRT_BIG;
    int best_slot = -1;
    if (tmx > tmn) {  // a dead ray (tmax = -BIG) can never hit
        for (int j = 0; j < nt; ++j) {
            float th;
            if (mt_hit(s_tri[j], s_tri[nt + j], s_tri[2 * nt + j], s_tri[3 * nt + j],
                       s_tri[4 * nt + j], s_tri[5 * nt + j], s_tri[6 * nt + j],
                       s_tri[7 * nt + j], s_tri[8 * nt + j], ox, oy, oz, dx, dy, dz,
                       tmn, tmx, best_t, &th)) {
                best_t = th;
                best_slot = j;
            }
        }
    }
    t_out[col] = best_t;
    slot_out[col] = best_slot;
}

// K5: a thread stops at its ray's first blocking slot.
__global__ void dense_any_kernel(const float* __restrict__ rays,
                                 const float* __restrict__ tri,
                                 float* __restrict__ out, int npad, int nt) {
    extern __shared__ float s_tri[];
    stage_table(tri, nt, s_tri);
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= npad) return;
    const float ox = rays[0 * npad + col], oy = rays[1 * npad + col],
                oz = rays[2 * npad + col];
    const float dx = rays[3 * npad + col], dy = rays[4 * npad + col],
                dz = rays[5 * npad + col];
    const float tmn = rays[6 * npad + col], tmx = rays[7 * npad + col];
    float blocked = 0.0f;
    if (tmx > tmn) {
        for (int j = 0; j < nt; ++j) {
            float th;
            if (mt_hit(s_tri[j], s_tri[nt + j], s_tri[2 * nt + j], s_tri[3 * nt + j],
                       s_tri[4 * nt + j], s_tri[5 * nt + j], s_tri[6 * nt + j],
                       s_tri[7 * nt + j], s_tri[8 * nt + j], ox, oy, oz, dx, dy, dz,
                       tmn, tmx, MCRT_BIG, &th)) {
                blocked = 1.0f;
                break;
            }
        }
    }
    out[col] = blocked;
}

}  // namespace

extern "C" {

int mcrt_dense_closest(const float* rays, const float* tri, float* t_out,
                       int* slot_out, int npad, int nt, void* stream) {
    const int grid = (npad + DENSE_CTA - 1) / DENSE_CTA;
    dense_closest_kernel<<<grid, DENSE_CTA, (size_t)9 * nt * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(rays, tri, t_out,
                                                                slot_out, npad, nt);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_dense_any(const float* rays, const float* tri, float* out, int npad,
                   int nt, void* stream) {
    const int grid = (npad + DENSE_CTA - 1) / DENSE_CTA;
    dense_any_kernel<<<grid, DENSE_CTA, (size_t)9 * nt * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(rays, tri, out, npad, nt);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
