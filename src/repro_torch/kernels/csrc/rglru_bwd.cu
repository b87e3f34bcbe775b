// RG-LRU backward: the reverse-time recurrence of the gradients of the
// RG-LRU scan (csrc/rglru.cu). The Pallas kernel it backs,
// src/repro/kernels/rglru.py:rglru (pallas_call at :65), has no backward:
// the reference trains through XLA's autodiff of its lax.scan oracle
// (src/repro/kernels/ref.py:rglru_ref), so this kernel computes what that
// autodiff computes, in its order of operations.
//
// What it computes. x, a, y and dy are [B, T, D] float32 (y the forward's
// output, so y[t - 1] = h_{t-1}), h0 and dhT optional [B, D] float32
// (zeros when absent). For every (b, d), with the carry c = dhT, going
// from t = T - 1 down to 0:
//
//     g     = dy_t + c
//     s     = sqrt(max(1 - a_t * a_t, 0))
//     dx_t  = g * s
//     da_t  = g * h_{t-1} + (-(((g * x_t) * (0.5 / s)) * tie)) * (2 * a_t)
//     c     = a_t * g
//
// and dh0 = c at the end. tie is the gradient XLA gives max(v, 0) at
// v = 1 - a_t^2: 1 for v > 0, 0.5 at v = 0, 0 below. At a_t = 1 exactly
// (s = 0) dx_t is 0 and da_t is -inf * sign(g x_t), or NaN where g x_t is
// 0, as jax.grad of the oracle gives. Every operation rounds on its own
// (_rn intrinsics, --fmad=false), the square root and the division are
// IEEE-rounded, so dx, da and dh0 equal the plain version
// (ref.py:rglru_backward_plain) bit for bit.
//
// Bound on this card. Each element reads dy, x, a and y once and writes dx
// and da once: 24 bytes against 15 float operations, so bytes rule (at
// recurrentgemma-9b's training shape [4, 1024, 4096] 403 MB, 0.120 ms at
// 3.35 TB/s, against 0.004 ms of float32 operations).
//
// What the design does about it. As the forward: one thread owns one
// (b, d) column for all of T with the carry in a register, a block of 256
// threads covers 256 neighbouring d so every access of a step is coalesced
// along d, and the loads of kChunk steps (walked downward) are issued
// together before their arithmetic, so a chunk's memory latency overlaps
// itself. Grid: ceil(D / 256) x B blocks.
//
// C interface (loaded with ctypes): rglru_bwd_f32 takes device pointers x,
// a, y, dy, h0 (may be null), dhT (may be null), dx, da, dh0, the sizes B,
// T, D and the CUDA stream; it returns the cudaError_t of the launch
// (0 = success). The launch is asynchronous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // time steps whose loads are issued together

// one step of the reverse recurrence: writes dx_t, da_t, returns the carry
__device__ __forceinline__ float step(float c, float dyv, float xv, float av,
                                      float hp, float* dx, float* da) {
  const float g = __fadd_rn(dyv, c);
  const float v = __fsub_rn(1.0f, __fmul_rn(av, av));
  const float s = __fsqrt_rn(v < 0.0f ? 0.0f : v);
  const float tie = v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
  *dx = __fmul_rn(g, s);
  const float dv = __fmul_rn(__fmul_rn(__fmul_rn(g, xv), __fdiv_rn(0.5f, s)),
                             tie);
  *da = __fadd_rn(__fmul_rn(g, hp), __fmul_rn(-dv, __fmul_rn(2.0f, av)));
  return __fmul_rn(av, g);
}

__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ y, const float* __restrict__ dy,
                 const float* __restrict__ h0, const float* __restrict__ dhT,
                 float* __restrict__ dx, float* __restrict__ da,
                 float* __restrict__ dh0, int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const long long row = static_cast<long long>(b) * D + d;
  const long long base = static_cast<long long>(b) * T * D + d;
  const float first = h0 != nullptr ? h0[row] : 0.0f;  // h_{-1}
  float c = dhT != nullptr ? dhT[row] : 0.0f;
  int t = T;  // steps t - 1, t - 2, ... remain
  for (; t >= kChunk; t -= kChunk) {
    float dyv[kChunk], xv[kChunk], av[kChunk], hp[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int tt = t - 1 - i;
      const long long at = base + static_cast<long long>(tt) * D;
      dyv[i] = dy[at];
      xv[i] = x[at];
      av[i] = a[at];
      hp[i] = tt > 0 ? y[at - D] : first;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const long long at = base + static_cast<long long>(t - 1 - i) * D;
      c = step(c, dyv[i], xv[i], av[i], hp[i], dx + at, da + at);
    }
  }
  for (; t > 0; --t) {
    const long long at = base + static_cast<long long>(t - 1) * D;
    c = step(c, dy[at], x[at], a[at], t > 1 ? y[at - D] : first, dx + at,
             da + at);
  }
  dh0[row] = c;
}

}  // namespace

extern "C" int rglru_bwd_f32(const float* x, const float* a, const float* y,
                             const float* dy, const float* h0,
                             const float* dhT, float* dx, float* da,
                             float* dh0, int B, int T, int D,
                             cudaStream_t stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<<<grid, kThreads, 0, stream>>>(x, a, y, dy, h0, dhT, dx,
                                                  da, dh0, T, D);
  return static_cast<int>(cudaGetLastError());
}
