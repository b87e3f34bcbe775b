// Tiled matrix product out = x @ y with float32 accumulation: the Hopper
// port of the Pallas kernel src/repro/kernels/matmul.py:matmul
// (pallas_call at :46).
//
// What it computes. x is [M, K], y is [K, N], both float32 or both bf16,
// each read through its own element strides (so a transposed view such
// as the matrix app's x.T needs no copy); out is a dense row-major
// [M, N] of the same type. Every output element is the sum over k of
// x[m, k] * y[k, n], accumulated in float32 in ascending k with fmaf, then
// stored (bf16: rounded to nearest even, as torch's .to(bfloat16) does).
//
// Bound on this card. 2*M*N*K float32 operations against
// (M*K + K*N + M*N) elements moved: at the matrix app's n = 344..496
// squares that is 81-244 MFLOP against 1.4-3.0 MB, so the operations
// bound (67 TFLOP/s without the tensor cores) rules at every app shape,
// 1.2-3.6 us, about three times the bytes bound; a launch costs about as
// much. At larger squares the operations bound rules further.
//
// What the design does about it. A simple and exact first kernel, IEEE
// float32 throughout (no TF32, no wgmma or TMA yet): each 256-thread block
// owns a 64 x 64 output tile; each thread keeps a 4 x 4 micro-tile of
// float32 accumulators in registers; the K loop stages 16-deep slabs of
// both operands in shared memory (the x slab stored k-major so the inner
// loop reads four consecutive rows), loading along whichever dimension of
// each operand has unit stride so the loads coalesce. Bounds checks mask
// the ragged edges with zeros, so no padded copies are made, as the TPU
// kernel makes them. Each tile is reused 64 times from shared memory and
// each shared-memory value 4 times from registers.
//
// Exactness. Each accumulator sums its K products in ascending k with
// fmaf. Products of small integers and their partial sums below 2^24 are
// exact in float32 in any order, so the matrix app's integer x @ x.T
// equals any other float32 product bit for bit. Built with --fmad=false;
// the one fused multiply-add is the explicit fmaf.
//
// C interface (loaded with ctypes): matmul_f32 / matmul_bf16 take device
// pointers x, y, out, the sizes M, N, K, the element strides of x (along
// M, along K) and of y (along K, along N), and the CUDA stream; they return
// the cudaError_t of the launch (0 = success). The launch is asynchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMicro = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ out, int M, int N, int K, long long sxm,
              long long sxk, long long syk, long long syn) {
  __shared__ float xs[kBK][kBM + 4];  // k-major: xs[k][m]
  __shared__ float ys[kBK][kBN + 4];  // ys[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3 of the tile
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3 of the tile
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // load along the operand's unit-stride dimension when it has one
  const bool x_k_fast = sxk == 1;
  const bool y_n_fast = syn == 1 || syk != 1;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // each thread stages 4 of the 64 x 16 x-slab and 4 of the 16 x 64
    // y-slab; elements past an edge load as 0
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int mm = x_k_fast ? e / kBK : e % kBM;
      const int kk = x_k_fast ? e % kBK : e / kBM;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K)
                       ? to_float(x[gm * sxm + gk * sxk])
                       : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int nn = y_n_fast ? e % kBN : e / kBK;
      const int kk = y_n_fast ? e / kBN : e % kBK;
      const int gk = k0 + kk, gn = n0 + nn;
      ys[kk][nn] = (gk < K && gn < N)
                       ? to_float(y[gk * syk + gn * syn])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = xs[kk][ty * kMicro + i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = ys[kk][tx * kMicro + j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gm = m0 + ty * kMicro + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gn = n0 + tx * kMicro + j;
      if (gn < N) store(out + static_cast<long long>(gm) * N + gn, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const T* x, const T* y, T* out, int M, int N, int K,
           long long sxm, long long sxk, long long syk, long long syn,
           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, M, N, K, sxm, sxk, syk, syn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matmul_f32(const float* x, const float* y, float* out, int M,
                          int N, int K, long long sxm, long long sxk,
                          long long syk, long long syn, void* stream) {
  return launch<float>(x, y, out, M, N, K, sxm, sxk, syk, syn, stream);
}

extern "C" int matmul_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                           __nv_bfloat16* out, int M, int N, int K,
                           long long sxm, long long sxk, long long syk,
                           long long syn, void* stream) {
  return launch<__nv_bfloat16>(x, y, out, M, N, K, sxm, sxk, syk, syn,
                               stream);
}
