// Arithmetic micro-benchmark kernels K8 (elementwise chain, float32 and
// bfloat16) and K9 (small-K float32 matrix product) for Hopper (sm_90a),
// with a plain C interface for ctypes (see mcrt_tpu_torch/accel/kernels.py
// and mcrt_tpu_torch/tools/vpu_bench.py).
//
// Replace tools/vpu_bench.py:chain_kernel (K8) and matmul_kernel (K9).  The
// TPU kernels run a grid of `iters` steps that each recompute the same
// VMEM-resident block, so the launch cost is amortised and the time is that
// of the arithmetic; here a loop over `iters` inside each thread does the
// same, and the output is stored once after the last pass.
//
// Bounds on the card, both set by operations: K8 does 20 rounds of
// (multiply-add, min, abs-subtract), counted as 5 operations a round as the
// TPU tool counts them, on 4 bytes (or 2) read and written per element; its
// float32 form issues 3 instructions a round (FFMA, FMNMX, FADD with the |.|
// modifier), its bfloat16 form 4 packed ones for two elements.  K9 does
// 2*k flops per output per pass against (512*k + k*1024 + 512*1024) * 4
// bytes moved once.  Design: K8 runs one thread per element (bfloat16: per pair, packed
// in __nv_bfloat162), enough warps to fill every SM, each a dependent
// chain; K9 stages a block's A rows and B columns in shared memory once and
// gives each thread a 4x4 register tile, accumulated in k order.
//
// The passes must not be merged by the compiler: every pass is
// loop-invariant, so nvcc (or ptxas) would otherwise compute one and skip
// the rest.  Each pass therefore starts from `x | (previous result &
// zero)` (bitwise), where `zero` is a kernel argument the launcher sets to
// 0: the value is x at run time, but no compiler can prove it, so pass i+1
// depends on pass i.  chip_smoke.py checks that doubling `iters` doubles
// the time.
//
// Rounding: the library is built with -fmad=false, so the float32
// multiply-add is the explicit __fmaf_rn (one rounding, as the JAX kernel
// contracts it); bfloat16 rounds every operation on its own (__hmul2_rn,
// __hadd2_rn, __hsub2_rn), as the JAX kernel does.  min is NaN-propagating
// as jnp.minimum is (CUDA's fminf drops a NaN).  Each launch returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#define VPU_CTA 256
#define MM_M 512   // K9's product: out (MM_M, MM_N) = a (MM_M, k) @ b (k, MM_N)
#define MM_N 1024
#define MM_BM 32   // K9 output rows of a block
#define MM_BN 64   // K9 output columns of a block
#define MM_THREADS 128  // 8 x 16 threads, 4 x 4 outputs each
#define MM_KMAX 128  // (32 + 64) x 128 x 4 B = 48 KB of shared memory

namespace {

constexpr int kRounds = 20;

__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
    unsigned u;
    memcpy(&u, &v, sizeof(u));
    return u;
}

__device__ __forceinline__ __nv_bfloat162 bf2(unsigned u) {
    __nv_bfloat162 v;
    memcpy(&v, &u, sizeof(u));
    return v;
}

// K8 float32: one element a thread.
__global__ void chain_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 int n, int iters, unsigned zero) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const unsigned x0 = __float_as_uint(x[i]);
    float acc = __uint_as_float(x0);
    for (int it = 0; it < iters; ++it) {
        const float xv = __uint_as_float(x0 | (__float_as_uint(acc) & zero));
        acc = xv;
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
            acc = __fmaf_rn(acc, xv, xv);
            acc = min_nan(acc, xv);
            acc = __fsub_rn(fabsf(acc), xv);
        }
    }
    out[i] = acc;
}

// K8 bfloat16: one pair of elements a thread, as one packed __nv_bfloat162.
__global__ void chain_bf16_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                                  int npairs, int iters, unsigned zero) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= npairs) return;
    const unsigned x0 = x[i];
    unsigned acc_bits = x0;
    for (int it = 0; it < iters; ++it) {
        const __nv_bfloat162 xv = bf2(x0 | (acc_bits & zero));
        __nv_bfloat162 acc = xv;
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
            acc = __hadd2_rn(__hmul2_rn(acc, xv), xv);
            acc = __hmin2_nan(acc, xv);
            acc = __hsub2_rn(__habs2(acc), xv);
        }
        acc_bits = bits(acc);
    }
    out[i] = acc_bits;
}

// K9: out (MM_M, MM_N) = a (MM_M, k) @ b (k, MM_N), float32,
// 1 <= k <= MM_KMAX.  A is staged k-major so that a thread reads its 4 rows
// as one float4; each output is a chain of __fmaf_rn in k order from +0.
__global__ void __launch_bounds__(MM_THREADS)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int k, int iters, unsigned zero) {
    extern __shared__ __align__(16) float smem[];
    float* s_a = smem;                 // k x MM_BM
    float* s_b = smem + k * MM_BM;     // k x MM_BN
    const int row0 = blockIdx.y * MM_BM, col0 = blockIdx.x * MM_BN;
    for (int i = threadIdx.x; i < MM_BM * k; i += MM_THREADS) {
        const int r = i / k, kk = i % k;
        s_a[kk * MM_BM + r] = a[(size_t)(row0 + r) * k + kk];
    }
    for (int i = threadIdx.x; i < MM_BN * k; i += MM_THREADS) {
        const int kk = i / MM_BN, c = i % MM_BN;
        s_b[kk * MM_BN + c] = b[(size_t)kk * MM_N + col0 + c];
    }
    __syncthreads();
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)  // +0 at run time, opaque to the compiler
                acc[i][j] = __uint_as_float(__float_as_uint(acc[i][j]) & zero);
        for (int kk = 0; kk < k; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(s_a + kk * MM_BM + ty * 4);
            const float4 bv = *reinterpret_cast<const float4*>(s_b + kk * MM_BN + tx * 4);
            const float ar[4] = {av.x, av.y, av.z, av.w};
            const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(out + (size_t)(row0 + ty * 4 + i) * MM_N + col0 + tx * 4) = v;
    }
}

}  // namespace

extern "C" {

int mcrt_vpu_chain_f32(const float* x, float* out, int n, int iters, void* stream) {
    const int grid = (n + VPU_CTA - 1) / VPU_CTA;
    chain_f32_kernel<<<grid, VPU_CTA, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out, n, iters, 0u);
    return static_cast<int>(cudaGetLastError());
}

// n counts bfloat16 elements and is even; x and out hold n / 2 packed pairs.
int mcrt_vpu_chain_bf16(const void* x, void* out, int n, int iters, void* stream) {
    const int npairs = n / 2;
    const int grid = (npairs + VPU_CTA - 1) / VPU_CTA;
    chain_bf16_kernel<<<grid, VPU_CTA, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(x), static_cast<unsigned*>(out), npairs, iters, 0u);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_vpu_matmul(const float* a, const float* b, float* out, int k, int iters,
                    void* stream) {
    if (k < 1 || k > MM_KMAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(MM_N / MM_BN, MM_M / MM_BM);
    matmul_kernel<<<grid, MM_THREADS, (size_t)k * (MM_BM + MM_BN) * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(a, b, out, k, iters, 0u);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
