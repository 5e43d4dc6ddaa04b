// Shared device functions of the blocked intersector's kernels K1-K3:
// NaN-propagating min/max, the ray-slab test and the Moller-Trumbore test.
//
// Every formula follows mcrt_tpu_torch/accel/blocked.py (_ray_rows, _slab,
// _mt) operation for operation.  The library is compiled with -fmad=false
// and without --use_fast_math (float contraction), so each
// multiply and add rounds on its own exactly as the plain PyTorch versions
// do, and `1.0f / x` is an IEEE division.  Later performance work may
// revisit this.
#pragma once

#include <cuda_runtime.h>

#define MCRT_BLOCK 128
#define MCRT_BIG 3.0e38f

// NaN-poisoned AABBs: empty blocks and all-empty chunks are
// stored as NaN boxes so that every slab test on them fails.  CUDA's
// fminf/fmaxf DROP a NaN operand (fmaxf(NaN, tmin) == tmin), which would let
// every ray enter an empty box; these propagate NaN like torch.minimum /
// jnp.minimum, and the kernels also test a box for NaN before using it.
__device__ __forceinline__ float nan_min(float a, float b) {
    if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
    return b < a ? b : a;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
    return b > a ? b : a;
}

// 1 / sd(c), sd clamping |c| <= 1e-12 to +1e-12 (sign lost, as the JAX
// package's _ray_rows writes it); an IEEE division.
__device__ __forceinline__ float safe_inv(float c) {
    return 1.0f / (fabsf(c) > 1e-12f ? c : 1e-12f);
}

__device__ __forceinline__ bool box_is_nan(const float* b) {
    return isnan(b[0]) || isnan(b[1]) || isnan(b[2]) ||
           isnan(b[3]) || isnan(b[4]) || isnan(b[5]);
}

// Slab test of one ray against the box b = (lo.xyz, hi.xyz); writes the
// entry distance and returns whether the ray enters within [tmn, tmx].
__device__ __forceinline__ bool slab_enter(const float* b, float ox, float oy,
                                           float oz, float ix, float iy,
                                           float iz, float tmn, float tmx,
                                           float* tn_out) {
    const float tx0 = (b[0] - ox) * ix, tx1 = (b[3] - ox) * ix;
    const float ty0 = (b[1] - oy) * iy, ty1 = (b[4] - oy) * iy;
    const float tz0 = (b[2] - oz) * iz, tz1 = (b[5] - oz) * iz;
    const float tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                             nan_max(nan_min(tz0, tz1), tmn));
    const float tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                             nan_min(nan_max(tz0, tz1), tmx));
    *tn_out = tn;
    return tn <= tf;  // false when either is NaN
}

// Moller-Trumbore against one triangle (p0, e1, e2), as _mt_block: returns
// whether the ray hits at t in (tmn, tmx) with t < best_t.
__device__ __forceinline__ bool mt_hit(float p0x, float p0y, float p0z,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float tmn, float tmx, float best_t,
                                       float* t_out) {
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const bool ok = fabsf(det) > 1e-9f;
    const float inv = ok ? 1.0f / det : 0.0f;
    const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
    *t_out = t;
    return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmn &&
           t < tmx && t < best_t;
}
