// Issue-rate probe: how many lanes a clock one SM of the card completes of
// FFMA (K9's instruction, and the rate the issue floors of the
// micro-benchmark kernels K8 and K9 in csrc/vpu.cu count at) and of K8's
// whole rounds, when the work has no dependences to wait on.  A
// stand-alone program (no PyTorch) that runs on the first visible card,
// built and run by mcrt_tpu_torch/tools/issue_rates.py; prints one JSON
// object.
//
// Throughput: every thread runs ILP = 8 independent chains (chain i takes
// chain i+1's previous value as its second operand, so no compiler can
// fold a chain), the step loop unrolled by 16 (loop control is under 3%
// of the instructions), at the occupancy the kernel allows (one wave).
// Latency: one warp on each SM, two chains, cycles per step.  Each block
// reads clock64() (the SM's cycle counter) after a barrier at start and
// end; an SM's window runs from its first block's start to its last
// block's end, and its rate is the lane-operations its blocks did over
// that window.  The median over SMs is printed, with the SM clock that
// the cycles and the event time of the launch imply.
//
// Built with the kernel library's flags (-fmad=false, sm_90a), so each
// operation compiles as it does in vpu.cu; `cuobjdump -sass` of the binary
// shows the instructions of each probe.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kSteps = 8192;  // steps of each probe, unrolled by 16
constexpr int kUnroll = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float fl(unsigned u) { return __uint_as_float(u); }
__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }

__device__ __forceinline__ __nv_bfloat162 h2(unsigned u) {
    __nv_bfloat162 v;
    memcpy(&v, &u, sizeof(u));
    return v;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
    unsigned u;
    memcpy(&u, &v, sizeof(u));
    return u;
}

__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// One operation of a probe: (v, w, c) -> new v; w is the neighbouring
// chain's value, c a run-time constant.  kOps counts the operations.
#define PROBE(NAME, OPS, EXPR)                                                      \
    struct probe_##NAME {                                                           \
        static constexpr int kOps = OPS;                                            \
        static constexpr const char* kName = #NAME;                                 \
        __device__ __forceinline__ static unsigned run(unsigned v, unsigned w,      \
                                                       unsigned c) { EXPR }         \
    };

PROBE(ffma, 1, return bits(__fmaf_rn(fl(v), fl(c), fl(w)));)
// K8's rounds as csrc/vpu.cu writes them; w plays x
PROBE(round_f32, 3, float a = __fmaf_rn(fl(v), fl(w), fl(w)); a = min_nan(a, fl(w));
      return bits(__fsub_rn(fabsf(a), fl(w)));)
PROBE(round_bf16, 4, __nv_bfloat162 x = h2(w);
      __nv_bfloat162 a = __hadd2_rn(__hmul2_rn(h2(v), x), x); a = __hmin2_nan(a, x);
      return bits(__hfma2(x, h2(0xbf80bf80u), h2(bits(a) & 0x7fff7fffu)));)

struct SmWindow {
    unsigned long long* start;
    unsigned long long* end;
    unsigned* blocks;
};

__device__ __forceinline__ unsigned smid() {
    unsigned r;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
    return r;
}

template <class Op, int ILP>
__global__ void probe_kernel(const unsigned* __restrict__ in, unsigned* __restrict__ out,
                             int steps, SmWindow win) {
    unsigned v[ILP];
#pragma unroll
    for (int i = 0; i < ILP; ++i) v[i] = in[i] ^ (threadIdx.x << 3);
    const unsigned c = in[ILP];
    __syncthreads();
    const unsigned long long t0 = clock64();
    for (int s = 0; s < steps; s += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            unsigned w[ILP];
#pragma unroll
            for (int i = 0; i < ILP; ++i) w[i] = Op::run(v[i], v[(i + 1) % ILP], c);
#pragma unroll
            for (int i = 0; i < ILP; ++i) v[i] = w[i];
        }
    }
    __syncthreads();
    const unsigned long long t1 = clock64();
    if (threadIdx.x == 0) {
        const unsigned sm = smid();
        atomicMin(win.start + sm, t0);
        atomicMax(win.end + sm, t1);
        atomicAdd(win.blocks + sm, 1u);
    }
    unsigned acc = 0;
#pragma unroll
    for (int i = 0; i < ILP; ++i) acc ^= v[i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

struct Result {
    double lanes_per_clk;  // lane-operations a clock, median over SMs
    double mhz;            // SM clock implied by the cycles and the event time
};

template <class Op, int ILP>
Result run_probe(int n_sm, int grid_per_sm, int threads, int steps, const unsigned* in,
                 unsigned* out, SmWindow win) {
    std::vector<unsigned long long> start(n_sm, ULLONG_MAX), end(n_sm, 0);
    std::vector<unsigned> blocks(n_sm, 0);
    cudaMemcpy(win.start, start.data(), n_sm * sizeof(start[0]), cudaMemcpyHostToDevice);
    cudaMemcpy(win.end, end.data(), n_sm * sizeof(end[0]), cudaMemcpyHostToDevice);
    cudaMemcpy(win.blocks, blocks.data(), n_sm * sizeof(blocks[0]), cudaMemcpyHostToDevice);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    probe_kernel<Op, ILP><<<n_sm * grid_per_sm, threads>>>(in, out, steps, win);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, e0, e1);
    cudaEventDestroy(e0);
    cudaEventDestroy(e1);
    cudaMemcpy(start.data(), win.start, n_sm * sizeof(start[0]), cudaMemcpyDeviceToHost);
    cudaMemcpy(end.data(), win.end, n_sm * sizeof(end[0]), cudaMemcpyDeviceToHost);
    cudaMemcpy(blocks.data(), win.blocks, n_sm * sizeof(blocks[0]), cudaMemcpyDeviceToHost);
    std::vector<double> rates, cycles;
    for (int s = 0; s < n_sm; ++s) {
        if (!blocks[s]) continue;
        const double cyc = static_cast<double>(end[s] - start[s]);
        rates.push_back(double(blocks[s]) * threads * steps * ILP * Op::kOps / cyc);
        cycles.push_back(cyc);
    }
    std::sort(rates.begin(), rates.end());
    const double longest = *std::max_element(cycles.begin(), cycles.end());
    return {rates[rates.size() / 2], longest / (ms * 1e3)};
}

template <class Op>
void report(int n_sm, const unsigned* in, unsigned* out, SmWindow win, const char* sep) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel<Op, 8>, kThreads, 0);
    const Result tp = run_probe<Op, 8>(n_sm, per_sm, kThreads, kSteps, in, out, win);
    const Result lat = run_probe<Op, 2>(n_sm, 1, 32, kSteps, in, out, win);
    // latency: two chains of one warp, so a step's cycles are one operation's latency
    const double lat_cycles = 2.0 * 32 * Op::kOps / lat.lanes_per_clk;
    std::printf("    \"%s\": {\"ops\": %d, \"lanes_per_clk_sm\": %.3f, \"warps_per_sm\": %d, "
                "\"latency_clk\": %.2f, \"mhz\": %.1f}%s\n",
                Op::kName, Op::kOps, tp.lanes_per_clk, per_sm * kThreads / 32,
                lat_cycles / Op::kOps, tp.mhz, sep);
}

}  // namespace

int main() {
    int dev = 0, n_sm = 0;
    cudaSetDevice(dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    unsigned host_in[9];
    for (int i = 0; i < 9; ++i) host_in[i] = 0x3f803f80u + 0x00010001u * i;  // bf16 pairs near 1
    unsigned *in, *out;
    SmWindow win;
    cudaMalloc(&in, sizeof(host_in));
    cudaMemcpy(in, host_in, sizeof(host_in), cudaMemcpyHostToDevice);
    cudaMalloc(&out, sizeof(unsigned) * n_sm * 2048);
    cudaMalloc(&win.start, sizeof(unsigned long long) * n_sm);
    cudaMalloc(&win.end, sizeof(unsigned long long) * n_sm);
    cudaMalloc(&win.blocks, sizeof(unsigned) * n_sm);
    for (int i = 0; i < 20; ++i)  // warm-up: module loaded, clocks up
        run_probe<probe_ffma, 8>(n_sm, 1, kThreads, kSteps, in, out, win);
    std::printf("{\"sms\": %d, \"probes\": {\n", n_sm);
    report<probe_ffma>(n_sm, in, out, win, ",");
    report<probe_round_f32>(n_sm, in, out, win, ",");
    report<probe_round_bf16>(n_sm, in, out, win, "");
    std::printf("}}\n");
    const cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) {
        std::fprintf(stderr, "issue_rates: %s\n", cudaGetErrorString(err));
        return 1;
    }
    return 0;
}
