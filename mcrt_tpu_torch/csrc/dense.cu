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
// p0.xyz, e1.xyz, e2.xyz, NT <= 1024.  A CTA of DENSE_CTA threads serves
// DENSE_CTA consecutive rays; the grid masks the ragged end of the
// wavefront, so Npad needs no wider padding.
//
// What bounds it on this card: instruction slots.  A ray-triangle test is
// about 54 float32 operations and an IEEE division against 32 bytes of ray
// read and at most 8 written per ray.  The first port ran at a fifth of
// that bound; the design answers its three costs:
//
// 1. Slots that cannot hit.  A table's blocks are padded to 128 slots, and
//    a padding slot has e1 = e2 = 0 (accel/blocked.py, build_blocked).  For
//    such a slot every component of pv = d x e2 is a product with a zero
//    (0, or NaN where d holds an infinity or a NaN), so det = e1 . pv is 0
//    or NaN, and mt_hit's |det| > 1e-9 rejects the pair whatever the ray
//    (the same holds for any slot whose e1 or e2 is all zero).  So each CTA
//    stages only the slots whose six edge components are not all exactly
//    zero, in slot order, each with its slot index.  Order is kept, so ties
//    still go to the lowest slot (strict < over kept slots in order is
//    strict < over all slots: a dropped slot never hits).  textured_hall
//    keeps 44 of its 128 slots.
// 2. Dead rays.  The dense path does not sort its rays (accel/__init__.py:
//    the coherence sort pays only where the cull can skip blocks), so a
//    late bounce's few live rays lie scattered over the wavefront, a few in
//    every warp, and one ray a thread would keep every warp busy for the
//    whole table.  So a CTA first reads its rays' tmin/tmax, writes misses
//    for the dead ones (tmax <= tmin can never hit), and lists its live
//    rays in column order; thread i then takes the i-th listed ray, so only
//    the first warps run the table loop, each for 32 live rays (the last
//    for the rest).  A CTA with no live ray returns before it stages
//    anything.
// 3. Shared-memory loads.  A kept slot is one 12-float record (p0, e1, e2,
//    the slot index in the spare word, two words of padding), read as
//    three float4 broadcasts in place of 9 scalar loads.  The records take
//    at most 1,024 x 48 B = 48 KB.
//
// Both lists (kept slots, live rays) are stream compactions in index
// order: a ballot mask per 32 entries, one warp's prefix sum over the masks.
//
// Numerics: every pair that is tested is decided, and its t computed, by
// mt_hit, the plain version's arithmetic (-fmad=false, IEEE division), and
// the pairs not tested can never hit; so t, slot and the blocked flag
// equal the plain versions' bit for bit.  Dead and padding rays give
// t = BIG, slot = -1 and blocked = 0.0.  K5 stops a ray at its first
// blocking kept slot.  Each launch returns cudaGetLastError().
#include "blocked.cuh"

#define DENSE_CTA 256   // threads a CTA, and rays
#define DENSE_RECORD 3  // float4s a staged slot

namespace {

// The dynamic shared memory of a launch over nt slots: the records, the
// live-ray list, then each list's masks and offsets (one a 32 entries, and
// one more offset for the count).
struct DenseShared {
    float4* rec;
    int* live;
    unsigned *slot_mask, *ray_mask;
    int *slot_off, *ray_off;
};

size_t dense_smem(int nt) {
    return (size_t)nt * DENSE_RECORD * sizeof(float4) + DENSE_CTA * sizeof(int) +
           (size_t)(2 * (nt / 32) + 1 + 2 * (DENSE_CTA / 32) + 1) * sizeof(int);
}

__device__ DenseShared dense_shared(float4* base, int nt) {
    DenseShared s;
    s.rec = base;
    s.live = reinterpret_cast<int*>(base + (size_t)nt * DENSE_RECORD);
    s.slot_mask = reinterpret_cast<unsigned*>(s.live + DENSE_CTA);
    s.slot_off = reinterpret_cast<int*>(s.slot_mask + nt / 32);
    s.ray_mask = reinterpret_cast<unsigned*>(s.slot_off + nt / 32 + 1);
    s.ray_off = reinterpret_cast<int*>(s.ray_mask + DENSE_CTA / 32);
    return s;
}

// Compaction in index order of the n entries (n a multiple of 32, at most
// 1,024) whose keep(i) holds: fills mask (one word a 32 entries) and off
// (each word's first list position, then the count), and returns the
// count.  Entry i's list position is then off[i / 32] plus the bits of
// mask[i / 32] below i's.  DENSE_CTA is a multiple of 32, so every warp
// runs each pass of the loop whole and its ballot sees 32 entries.
template <typename Keep>
__device__ int compact(int n, Keep keep, unsigned* mask, int* off) {
    const int lane = threadIdx.x & 31;
    for (int i = threadIdx.x; i < n; i += DENSE_CTA) {
        const unsigned m = __ballot_sync(0xffffffffu, keep(i));
        if (lane == 0) mask[i / 32] = m;
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // exclusive prefix over the n / 32 <= 32 masks
        const int words = n / 32;
        const int c = lane < words ? __popc(mask[lane]) : 0;
        int incl = c;
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += up;
        }
        if (lane < words) off[lane] = incl - c;
        if (lane == 31) off[words] = incl;
    }
    __syncthreads();
    return off[n / 32];
}

// Entry i's list position, or -1 when it was not kept.
__device__ __forceinline__ int listed(int i, const unsigned* mask, const int* off) {
    const unsigned m = mask[i / 32], bit = 1u << (i & 31);
    return m & bit ? off[i / 32] + __popc(m & (bit - 1u)) : -1;
}

// Lists the CTA's live rays (item 2) and calls miss(col) for each dead
// one; returns the number listed.
template <typename Miss>
__device__ int list_live(const float* __restrict__ rays, int npad, const DenseShared& s,
                         Miss miss) {
    const int col = blockIdx.x * DENSE_CTA + threadIdx.x;
    const int n = compact(DENSE_CTA, [&](int) {
        return col < npad && rays[7 * npad + col] > rays[6 * npad + col];
    }, s.ray_mask, s.ray_off);
    const int k = listed(threadIdx.x, s.ray_mask, s.ray_off);
    if (k >= 0) s.live[k] = col;
    else if (col < npad) miss(col);
    return n;
}

// Stages the table's kept slots (item 1) as records in slot order; returns
// their number.
__device__ int stage_kept(const float* __restrict__ tri, int nt, const DenseShared& s) {
    const int kept = compact(nt, [&](int j) {
        return tri[3 * nt + j] != 0.0f || tri[4 * nt + j] != 0.0f || tri[5 * nt + j] != 0.0f ||
               tri[6 * nt + j] != 0.0f || tri[7 * nt + j] != 0.0f || tri[8 * nt + j] != 0.0f;
    }, s.slot_mask, s.slot_off);
    for (int j = threadIdx.x; j < nt; j += DENSE_CTA) {
        const int k = listed(j, s.slot_mask, s.slot_off);
        if (k >= 0) {
            s.rec[DENSE_RECORD * k] =
                make_float4(tri[j], tri[nt + j], tri[2 * nt + j], tri[3 * nt + j]);
            s.rec[DENSE_RECORD * k + 1] =
                make_float4(tri[4 * nt + j], tri[5 * nt + j], tri[6 * nt + j], tri[7 * nt + j]);
            s.rec[DENSE_RECORD * k + 2] =
                make_float4(tri[8 * nt + j], __int_as_float(j), 0.0f, 0.0f);
        }
    }
    __syncthreads();  // the records and the live list are read by every thread
    return kept;
}

struct DenseRay {
    float ox, oy, oz, dx, dy, dz, tmn, tmx;
};

__device__ __forceinline__ DenseRay load_ray(const float* __restrict__ rays, int npad,
                                             int col) {
    return {rays[col], rays[npad + col], rays[2 * npad + col], rays[3 * npad + col],
            rays[4 * npad + col], rays[5 * npad + col], rays[6 * npad + col],
            rays[7 * npad + col]};
}

__device__ __forceinline__ bool test_record(const float4* rec, int k, const DenseRay& r,
                                            float best_t, float* th) {
    const float4 a = rec[DENSE_RECORD * k], b = rec[DENSE_RECORD * k + 1],
                 c = rec[DENSE_RECORD * k + 2];
    return mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r.ox, r.oy, r.oz, r.dx, r.dy,
                  r.dz, r.tmn, r.tmx, best_t, th);
}

// K4: the closest kept slot; ties go to the lowest slot (strict <, kept
// slots in slot order), which is the Pallas kernel's first argmin within a
// block and strict < across blocks.
__global__ void __launch_bounds__(DENSE_CTA)
    dense_closest_kernel(const float* __restrict__ rays, const float* __restrict__ tri,
                         float* __restrict__ t_out, int* __restrict__ slot_out, int npad,
                         int nt) {
    extern __shared__ float4 smem[];
    const DenseShared s = dense_shared(smem, nt);
    const int n_live = list_live(rays, npad, s, [&](int col) {
        t_out[col] = MCRT_BIG;
        slot_out[col] = -1;
    });
    if (n_live == 0) return;
    const int kept = stage_kept(tri, nt, s);
    if (static_cast<int>(threadIdx.x) >= n_live) return;
    const int col = s.live[threadIdx.x];
    const DenseRay r = load_ray(rays, npad, col);
    float best_t = MCRT_BIG;
    int best_slot = -1;
    for (int k = 0; k < kept; ++k) {
        float th;
        if (test_record(s.rec, k, r, best_t, &th)) {
            best_t = th;
            best_slot = __float_as_int(s.rec[DENSE_RECORD * k + 2].y);
        }
    }
    t_out[col] = best_t;
    slot_out[col] = best_slot;
}

// K5: a ray stops at its first blocking kept slot.
__global__ void __launch_bounds__(DENSE_CTA)
    dense_any_kernel(const float* __restrict__ rays, const float* __restrict__ tri,
                     float* __restrict__ out, int npad, int nt) {
    extern __shared__ float4 smem[];
    const DenseShared s = dense_shared(smem, nt);
    const int n_live = list_live(rays, npad, s, [&](int col) { out[col] = 0.0f; });
    if (n_live == 0) return;
    const int kept = stage_kept(tri, nt, s);
    if (static_cast<int>(threadIdx.x) >= n_live) return;
    const int col = s.live[threadIdx.x];
    const DenseRay r = load_ray(rays, npad, col);
    float blocked = 0.0f;
    for (int k = 0; k < kept; ++k) {
        float th;
        if (test_record(s.rec, k, r, MCRT_BIG, &th)) {
            blocked = 1.0f;
            break;
        }
    }
    out[col] = blocked;
}

}  // namespace

extern "C" {

int mcrt_dense_closest(const float* rays, const float* tri, float* t_out,
                       int* slot_out, int npad, int nt, void* stream) {
    const size_t smem = dense_smem(nt);
    const cudaError_t err = opt_in_smem(dense_closest_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (npad + DENSE_CTA - 1) / DENSE_CTA;
    dense_closest_kernel<<<grid, DENSE_CTA, smem, static_cast<cudaStream_t>(stream)>>>(
        rays, tri, t_out, slot_out, npad, nt);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_dense_any(const float* rays, const float* tri, float* out, int npad,
                   int nt, void* stream) {
    const size_t smem = dense_smem(nt);
    const cudaError_t err = opt_in_smem(dense_any_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (npad + DENSE_CTA - 1) / DENSE_CTA;
    dense_any_kernel<<<grid, DENSE_CTA, smem, static_cast<cudaStream_t>(stream)>>>(
        rays, tri, out, npad, nt);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
