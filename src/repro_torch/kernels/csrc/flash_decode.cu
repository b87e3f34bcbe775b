// One-token attention against a KV cache: the Hopper port of the Pallas
// kernel src/repro/kernels/flash_decode.py:flash_decode (pallas_call at
// :88).
//
// What it computes. q is [B, Hq, D] (one new token per head), k and v
// [B, Hkv, S, D] caches, all float32 or all bf16, each read through its
// own element strides (unit stride along D); length is [B] int32 on the
// device, and so is end. Row b has n = min(max(length[b], 0), S) live
// keys: the key positions max(end[b] - n, 0) .. end[b] - 1, position P
// stored at slot P % S (the model's caches, rolled for a sliding window).
// end = n gives cache slots 0 .. n - 1, the TPU kernel's mask
// kpos < min(length, S); the wrapper (ops.py) passes that when it is
// given no end. The G = Hq / Hkv query
// heads that share KV head h are the rows of each product, so every K and
// V value is read once per group. Scores are (q . k) * scale in float32
// (the dot in ascending d with fmaf); masked keys weigh exactly nothing,
// and a row with n = 0 has a zero denominator and gives zeros (the TPU
// kernel's guard; the reference's oracle gives NaN there). out [B, Hq, D]
// (dense) gets sum_j p_j v_j / sum_j p_j in q's type.
//
// Bound on this card. 4 G D operations per live key against 2 D cache
// elements read: at G = 4..16 that is 4-16 operations per bf16 byte, far
// below the card's ~295, so reading the live part of the cache is the
// bound (llama3-8b's 2 x 8 x 4097 x 128 live bf16 keys and values,
// 16.8 MB: 5 us at 3.35 TB/s).
//
// What the design does about it. A simple and right first kernel. The
// TPU kernel's sequential KV grid axis becomes a loop inside the block:
// one 256-thread block per (KV head, batch row) walks the live keys in
// 32-key tiles in position order, staged in shared memory as float32 with
// coalesced loads along D, and reads nothing past them. The running max
// and denominator of the G rows live in shared memory, one warp per row
// takes a tile's max by shuffles and its sum of p in key order, and each
// thread keeps up to kAcc float32 accumulators of the [G, D] output in
// registers.
// Only B x Hkv blocks run (16 at llama3-8b's long batch, 2 at
// recurrentgemma-9b's, on 132 SMs): splitting the cache over blocks with
// a merge pass is the known next step (PERF.md).
//
// Exactness. Built with --fmad=false; the fused multiply-adds are the
// explicit fmaf of the dots and the p . v sums; expf is the accurate one.
// Against the plain version (ref.py:flash_decode_plain) the result
// differs only by summation order. Against flash_attention.cu it is equal
// bit for bit for the same query row and keys: the tiles start at
// multiples of 32 in key position (keys before the first live one masked)
// and every step is the same arithmetic in the same order (see
// flash_attention.cu).
//
// C interface (loaded with ctypes): flash_decode_f32 / flash_decode_bf16
// take device pointers q, k, v, length, end, out, the sizes
// B, Hq, Hkv, S, D, scale, the element strides of q along (b, h) and of k
// and v along (b, h, s) as host arrays of long long, and the CUDA stream;
// they return the cudaError_t of the launch (0 = success). The launch is
// asynchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;     // keys per tile (flash_attention.cu's)
constexpr int kAcc = 32;    // accumulators per thread: G * DPAD <= 8192
constexpr float kMasked = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int DPAD>
int smem_bytes(int G) {
  return (G * DPAD + kBK * (DPAD + 1) + kBK * DPAD + G * (kBK + 1) +
          3 * G) * static_cast<int>(sizeof(float));
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    const int* __restrict__ end, T* __restrict__ out, int G,
                    int S, int D, float scale, long long qb_s,
                    long long qh_s, long long kb_s, long long kh_s,
                    long long ks_s, long long vb_s, long long vh_s,
                    long long vs_s) {
  constexpr int KP = DPAD + 1;
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // [G][DPAD]
  float* ks = qs + G * DPAD;        // [kBK][KP]
  float* vs = ks + kBK * KP;        // [kBK][DPAD]
  float* ps = vs + kBK * DPAD;      // [G][PP]
  float* m = ps + G * PP;           // [G]
  float* l = m + G;                 // [G]
  float* alpha = l + G;             // [G]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int Hkv = gridDim.x;
  const int n = max(0, min(length[b], S));
  const int hi = end[b];  // live positions [lo, hi)
  const int lo = max(0, hi - n);
  const T* kb = k + b * kb_s + h * kh_s;
  const T* vb = v + b * vb_s + h * vh_s;

  for (int e = tid; e < G * DPAD; e += kThreads) {
    const int g = e / DPAD, d = e % DPAD;
    qs[e] = d < D ? to_float(q[b * qb_s + (h * G + g) * qh_s + d]) : 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kMasked;
    l[g] = 0.0f;
  }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;

  for (int p0 = n > 0 ? (lo / kBK) * kBK : hi; p0 < hi; p0 += kBK) {
    __syncthreads();  // q, m, l ready; the previous tile's readers done
    const int slot0 = p0 % S;  // slot of position p0 (p0 >= 0)
    for (int e = tid; e < kBK * DPAD; e += kThreads) {
      const int t = e / DPAD, d = e % DPAD;
      const int pos = p0 + t;
      const bool in = pos >= lo && pos < hi && d < D;
      int slot = slot0 + t;
      while (slot >= S) slot -= S;
      ks[t * KP + d] = in ? to_float(kb[slot * ks_s + d]) : 0.0f;
      vs[t * DPAD + d] = in ? to_float(vb[slot * vs_s + d]) : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < G * kBK; e += kThreads) {
      const int g = e / kBK, t = e % kBK;
      const float* qr = qs + g * DPAD;
      const float* kr = ks + t * KP;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DPAD; ++d) s = fmaf(qr[d], kr[d], s);
      const int pos = p0 + t;
      ps[g * PP + t] = pos >= lo && pos < hi ? s * scale : kMasked;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* pr = ps + g * PP;
      const int pos = p0 + lane;
      const bool live = pos >= lo && pos < hi;
      const float s = pr[lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      pr[lane] = live ? expf(s - m_new) : 0.0f;
      __syncwarp();
      if (lane == 0) {
        float sum = 0.0f;  // in key order, as flash_attention.cu
        for (int t = 0; t < kBK; ++t) sum += pr[t];
        const float a = expf(m[g] - m_new);
        alpha[g] = a;
        l[g] = a * l[g] + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int e = tid + j * kThreads;
      if (e < G * DPAD) {  // block-uniform past the group's [G, DPAD]
        const float* pr = ps + (e / DPAD) * PP;
        const float* vc = vs + e % DPAD;
        float a = acc[j] * alpha[e / DPAD];
        // keys in order; unrolled by 4 only (a full unroll of both loops
        // took ptxas 272 s)
#pragma unroll 4
        for (int t = 0; t < kBK; ++t) a = fmaf(pr[t], vc[t * DPAD], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();  // l final (also when no tile ran)
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int e = tid + j * kThreads;
    if (e < G * DPAD) {
      const int g = e / DPAD, d = e % DPAD;
      if (d < D) {
        const float denom = l[g] == 0.0f ? 1.0f : l[g];
        store(out + (static_cast<long long>(b) * Hkv * G + h * G + g) * D +
                  d,
              acc[j] / denom);
      }
    }
  }
}

template <typename T, int DPAD>
int launch_d(const T* q, const T* k, const T* v, const int* length,
             const int* end, T* out, int B, int Hq, int Hkv, int S, int D,
             float scale, const long long* st_q, const long long* st_k,
             const long long* st_v, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G * DPAD > kAcc * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes<DPAD>(G);
  auto kernel = flash_decode_kernel<T, DPAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      q, k, v, length, end, out, G, S, D, scale, st_q[0], st_q[1], st_k[0],
      st_k[1], st_k[2], st_v[0], st_v[1], st_v[2]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* length,
           const int* end, T* out, int B, int Hq, int Hkv, int S, int D,
           float scale, const long long* st_q, const long long* st_k,
           const long long* st_v, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || S < 0 ||
      B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_d<T, 32>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                           scale, st_q, st_k, st_v, s);
  if (D <= 64)
    return launch_d<T, 64>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                           scale, st_q, st_k, st_v, s);
  if (D <= 128)
    return launch_d<T, 128>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                            scale, st_q, st_k, st_v, s);
  return launch_d<T, 256>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                          scale, st_q, st_k, st_v, s);
}

}  // namespace

extern "C" int flash_decode_f32(const float* q, const float* k,
                                const float* v, const int* length,
                                const int* end, float* out, int B, int Hq,
                                int Hkv, int S, int D, float scale,
                                const long long* st_q, const long long* st_k,
                                const long long* st_v, void* stream) {
  return launch<float>(q, k, v, length, end, out, B, Hq, Hkv, S, D, scale,
                       st_q, st_k, st_v, stream);
}

extern "C" int flash_decode_bf16(const __nv_bfloat16* q,
                                 const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const int* length,
                                 const int* end, __nv_bfloat16* out, int B,
                                 int Hq, int Hkv, int S, int D, float scale,
                                 const long long* st_q, const long long* st_k,
                                 const long long* st_v, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                               scale, st_q, st_k, st_v, stream);
}
