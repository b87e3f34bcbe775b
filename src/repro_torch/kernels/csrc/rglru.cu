// RG-LRU linear recurrence (RecurrentGemma's gated scan): the Hopper port
// of the Pallas kernel src/repro/kernels/rglru.py:rglru (pallas_call at
// :65).
//
// What it computes. x and a are [B, T, D] float32 (a in (0, 1)), h0 an
// optional [B, D] float32 carry (zeros when absent). For every (b, d):
//
//     h_t = a_t * h_{t-1} + sqrt(max(1 - a_t * a_t, 0)) * x_t
//
// y [B, T, D] float32 gets every h_t and hT [B, D] float32 the last one.
// Every operation rounds on its own (the explicit _rn intrinsics never
// contract into a fused multiply-add, and the build adds --fmad=false),
// and the square root is IEEE-rounded, so y and hT equal the plain
// version (ref.py:rglru_plain) bit for bit.
//
// Bound on this card. Each element is read once from x and a and written
// once to y: 12 bytes against 6 float operations, so the bytes bound
// rules by far (at recurrentgemma-9b's [8, 2048, 4096] prefill 805 MB,
// 0.240 ms at 3.35 TB/s, against 0.006 ms of float32 operations).
//
// What the design does about it. The TPU kernel walks time blocks in a
// sequential grid with the carry in VMEM scratch; here there is no grid
// order, so one thread owns one (b, d) column for all of T with h in a
// register, and a block of 256 threads covers 256 neighbouring d, so
// every load and store of a time step is coalesced along d. The chain
// over t is serial per thread, so the loads of kChunk time steps are
// issued together before their arithmetic: the memory latency of a chunk
// overlaps itself instead of adding up step by step. Grid:
// ceil(D / 256) x B blocks (128 x 8 = 32,768 threads at [8, *, 4096]).
//
// C interface (loaded with ctypes): rglru_f32 takes device pointers x,
// a, h0 (may be null), y, hT, the sizes B, T, D and the CUDA stream; it
// returns the cudaError_t of the launch (0 = success). The launch is
// asynchronous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // time steps whose loads are issued together

__device__ __forceinline__ float step(float h, float a, float x) {
  const float v = __fsub_rn(1.0f, __fmul_rn(a, a));
  const float g = __fmul_rn(__fsqrt_rn(v < 0.0f ? 0.0f : v), x);
  return __fadd_rn(__fmul_rn(a, h), g);
}

__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ h0, float* __restrict__ y,
             float* __restrict__ hT, int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const long long row = static_cast<long long>(b) * D + d;
  const long long base = static_cast<long long>(b) * T * D + d;
  float h = h0 != nullptr ? h0[row] : 0.0f;
  int t = 0;
  for (; t + kChunk <= T; t += kChunk) {
    float av[kChunk], xv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const long long at = base + static_cast<long long>(t + i) * D;
      av[i] = a[at];
      xv[i] = x[at];
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      h = step(h, av[i], xv[i]);
      y[base + static_cast<long long>(t + i) * D] = h;
    }
  }
  for (; t < T; ++t) {
    const long long at = base + static_cast<long long>(t) * D;
    h = step(h, a[at], x[at]);
    y[at] = h;
  }
  hT[row] = h;
}

}  // namespace

extern "C" int rglru_f32(const float* x, const float* a, const float* h0,
                         float* y, float* hT, int B, int T, int D,
                         cudaStream_t stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_kernel<<<grid, kThreads, 0, stream>>>(x, a, h0, y, hT, T, D);
  return static_cast<int>(cudaGetLastError());
}
