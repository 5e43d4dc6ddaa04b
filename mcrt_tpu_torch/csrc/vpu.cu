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
// TPU tool counts them, on 4 bytes (or 2) read and written per element.
// K9 does 2*k flops per output per pass against (512*k + k*1024 +
// 512*1024) * 4 bytes moved once.  Both are bound by instruction issue: a
// scheduler issues one warp instruction a clock; FMNMX, HMNMX2 and LOP3 run
// at half that rate, the packed bfloat16 HMUL2/HADD2/HFMA2 at about 0.85
// of it (tools/issue_rates.py).
//
// K8 design.  A float32 round is 3 instructions (FFMA, FMNMX, FADD with the
// |.| modifier); a bfloat16 round, on a packed pair, 5: HMUL2, HADD2,
// HMNMX2, a LOP3 that clears the sign bits (the abs) and an HFMA2 computing
// x * -1 + |a|, which rounds once exactly as |a| - x does, signs of zero
// included.  ptxas folds the abs into no bfloat16 instruction: written as
// __habs2 it is an HFMA2 of its own on the packed pipe, while the LOP3 runs
// on the integer pipe beside it.  The data give one chain per element
// (bfloat16: per pair), 7.8 warps a scheduler, too few to hide the packed
// instructions' 9-clock latency, so each thread runs several passes at
// once (kStreamsBF16, kStreamsF32), their rounds interleaved: the passes
// are independent by nature (each recomputes the same result), so this
// adds independent chains without changing the work.  For the same reason
// the work is split evenly by passes, not by chains, over a grid that
// fills every SM once: chains alone would leave the busiest SMs a warp
// more than the average.
//
// K9 design.  At k = MM_KREG (8) every thread keeps its row of A and its
// kRegCols columns of B in registers, loaded once, and a pass is 8 FFMAs
// on each of its outputs, fully unrolled, with no loads.  Every other k
// (1..128) takes the generic kernel: a block's A rows and B columns staged
// in shared memory once, a 4x4 register tile a thread, the k loop unrolled
// by 32.  Each output is a chain of __fmaf_rn in k order from +0 in both.
// What holds both below the FFMA rate is register-bank conflicts: FFMAs
// whose two operands not held in the reuse cache share a bank.
//
// The passes must not be merged by the compiler: every pass is
// loop-invariant, so nvcc (or ptxas) would otherwise compute one and skip
// the rest.  So each pass starts from a value that is x or +0 at run time
// through `zero`, a kernel argument the launcher sets to 0, but that no
// compiler can prove: K8 starts a stream's pass from `x | (the stream's
// previous result & zero)`, stream s's first one from `x | (s & zero)`,
// so that no two streams are provably the same computation, and stores
// the first stream's result ORed with `(the other streams' results) &
// zero`, so no stream is dead; K9 starts
// every output of a pass from `(OR of the previous pass's outputs) &
// zero`, one LOP3 for two outputs, and the generic kernel each output from
// `(its previous value) & zero`.  chip_smoke.py checks that doubling
// `iters` doubles the time.
//
// Rounding: the library is built with -fmad=false, so the float32
// multiply-add is the explicit __fmaf_rn (one rounding, as the JAX kernel
// contracts it); bfloat16 rounds every operation on its own (__hmul2_rn,
// __hadd2_rn, and the abs-subtract's fma), as the JAX kernel does.  min is
// NaN-propagating as jnp.minimum is (CUDA's fminf drops a NaN).  Each
// launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#define VPU_CTA 256
#define MM_M 512   // K9's product: out (MM_M, MM_N) = a (MM_M, k) @ b (k, MM_N)
#define MM_N 1024
#define MM_BM 32   // generic K9: output rows of a block
#define MM_BN 64   // generic K9: output columns of a block
#define MM_THREADS 128  // generic K9: 8 x 16 threads, 4 x 4 outputs each
#define MM_KMAX 128  // (32 + 64) x 128 x 4 B = 48 KB of shared memory
#define MM_KREG 8  // K9's k whose operands a thread holds in registers

namespace {

constexpr int kRounds = 20;
constexpr int kStreamsF32 = 8;   // K8: passes a thread runs at once
constexpr int kStreamsBF16 = 4;
constexpr int kRegCols = 8;      // K9 at k = MM_KREG: outputs of a thread, along a row

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

// K8's two element types: the value a thread holds (T), its round, and
// its conversions from and to the 32-bit word it is read and written as.
struct F32 {
    using T = float;
    __device__ __forceinline__ static T from(unsigned u) { return __uint_as_float(u); }
    __device__ __forceinline__ static unsigned to(T v) { return __float_as_uint(v); }
    __device__ __forceinline__ static T round(T acc, T x) {
        acc = __fmaf_rn(acc, x, x);
        acc = min_nan(acc, x);
        return __fsub_rn(fabsf(acc), x);
    }
};

struct BF16x2 {  // a packed pair
    using T = __nv_bfloat162;
    __device__ __forceinline__ static T from(unsigned u) { return bf2(u); }
    __device__ __forceinline__ static unsigned to(T v) { return bits(v); }
    __device__ __forceinline__ static T round(T acc, T x) {
        acc = __hadd2_rn(__hmul2_rn(acc, x), x);
        acc = __hmin2_nan(acc, x);
        return __hfma2(x, bf2(0xbf80bf80u), bf2(bits(acc) & 0x7fff7fffu));  // -x + |acc|
    }
};

// S passes of K8 at once, their rounds interleaved; acc[s] holds stream
// s's previous result and receives its new one.
template <int S, class E>
__device__ __forceinline__ void chain_passes(unsigned x0, unsigned* acc, unsigned zero) {
    typename E::T xv[S], a[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        xv[s] = E::from(x0 | (acc[s] & zero));
        a[s] = xv[s];
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
#pragma unroll
        for (int s = 0; s < S; ++s) a[s] = E::round(a[s], xv[s]);
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = E::to(a[s]);
}

// K8 on n chains (elements, F32, or packed pairs, BF16x2; n a multiple
// of 32) of `iters` passes each.  The n / 32 * iters warp-passes are split
// evenly over the launch's warps, a contiguous range each, and the launcher
// fills every SM once, so every SM gets the same work.  A range covers one
// or two groups of 32 chains; for each, the lanes run their chains' passes
// of the range, S at once and the rest one by one, and store the result.
// Every pass gives the same result, so a chain whose passes two warps share
// is stored twice with the same bits.
template <int S, class E>
__global__ void __launch_bounds__(VPU_CTA)
chain_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out, int n, int iters,
             unsigned zero) {
    constexpr int kWarps = VPU_CTA / 32;
    const long long warps = static_cast<long long>(gridDim.x) * kWarps;
    const long long w = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
    const long long total = static_cast<long long>(n / 32) * iters;
    const long long end = total * (w + 1) / warps;
    for (long long u = total * w / warps; u < end;) {
        const long long group = u / iters;
        const long long group_end = (group + 1) * iters;
        const int passes = static_cast<int>((end < group_end ? end : group_end) - u);
        const int i = static_cast<int>(group) * 32 + threadIdx.x % 32;
        const unsigned x0 = x[i];
        unsigned acc[S];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = x0 | (s & zero);  // x0 at run time
        int p = 0;
        for (; p + S <= passes; p += S) chain_passes<S, E>(x0, acc, zero);
        for (; p < passes; ++p) chain_passes<1, E>(x0, acc, zero);
        unsigned rest = 0;
#pragma unroll
        for (int s = 1; s < S; ++s) rest |= acc[s];
        out[i] = acc[0] | (rest & zero);
        u += passes;
    }
}

// Blocks of VPU_CTA threads that fill every SM of the current device once.
template <class Kernel>
int full_grid(Kernel kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, VPU_CTA, 0);
    return sms * per_sm;
}

// K9 at k = K: each thread's row of A and kRegCols columns of B held in
// registers; a pass is K FFMAs on each of its outputs.  A warp covers 256
// contiguous columns of one row.
template <int K>
__global__ void __launch_bounds__(VPU_CTA)
matmul_reg_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int iters, unsigned zero) {
    constexpr int kColGroups = MM_N / kRegCols;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = t / kColGroups, col0 = (t % kColGroups) * kRegCols;
    float ar[K], br[K][kRegCols], acc[kRegCols];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
        ar[kk] = a[row * K + kk];
#pragma unroll
        for (int j = 0; j < kRegCols; ++j) br[kk][j] = b[kk * MM_N + col0 + j];
    }
#pragma unroll
    for (int j = 0; j < kRegCols; ++j) acc[j] = 0.0f;
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
        unsigned prev = 0;
#pragma unroll
        for (int j = 0; j < kRegCols; ++j) prev |= __float_as_uint(acc[j]);
        const float start = __uint_as_float(prev & zero);  // +0 at run time
#pragma unroll
        for (int j = 0; j < kRegCols; ++j) {
            float s = __fmaf_rn(ar[0], br[0][j], start);
#pragma unroll
            for (int kk = 1; kk < K; ++kk) s = __fmaf_rn(ar[kk], br[kk][j], s);
            acc[j] = s;
        }
    }
#pragma unroll
    for (int j = 0; j < kRegCols; ++j) out[row * MM_N + col0 + j] = acc[j];
}

// K9, generic: out (MM_M, MM_N) = a (MM_M, k) @ b (k, MM_N), float32,
// 1 <= k <= MM_KMAX.  A is staged k-major so that a thread reads its 4
// rows as one float4.
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
#pragma unroll 32
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
    if (n % 32) return static_cast<int>(cudaErrorInvalidValue);
    chain_kernel<kStreamsF32, F32><<<full_grid(chain_kernel<kStreamsF32, F32>), VPU_CTA, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const unsigned*>(x), reinterpret_cast<unsigned*>(out), n, iters, 0u);
    return static_cast<int>(cudaGetLastError());
}

// n counts bfloat16 elements; x and out hold n / 2 packed pairs.
int mcrt_vpu_chain_bf16(const void* x, void* out, int n, int iters, void* stream) {
    if (n % 64) return static_cast<int>(cudaErrorInvalidValue);
    chain_kernel<kStreamsBF16, BF16x2><<<full_grid(chain_kernel<kStreamsBF16, BF16x2>), VPU_CTA, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(x), static_cast<unsigned*>(out), n / 2, iters, 0u);
    return static_cast<int>(cudaGetLastError());
}

int mcrt_vpu_matmul(const float* a, const float* b, float* out, int k, int iters,
                    void* stream) {
    if (k < 1 || k > MM_KMAX) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k == MM_KREG) {
        const int threads = MM_M * MM_N / kRegCols;
        matmul_reg_kernel<MM_KREG><<<threads / VPU_CTA, VPU_CTA, 0, s>>>(a, b, out, iters, 0u);
    } else {
        const dim3 grid(MM_N / MM_BN, MM_M / MM_BM);
        const size_t smem = (size_t)k * (MM_BM + MM_BN) * sizeof(float);
        matmul_kernel<<<grid, MM_THREADS, smem, s>>>(a, b, out, k, iters, 0u);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
