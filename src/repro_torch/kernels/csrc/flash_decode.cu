// One-token attention against a KV cache: the Hopper port of the Pallas
// kernel src/repro/kernels/flash_decode.py:flash_decode (pallas_call at
// :88).
//
// What it computes. q is [B, Hq, D] (one new token per head), k and v
// [B, Hkv, S, D] caches, all float32 or all bf16, or k and v both
// float8_e4m3fn under a float32 or bf16 q (a model's fp8 KV cache), each
// read through its own element strides (unit stride along D); length is
// [B] int32 on the
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
// bf16: the tensor cores, split over the cache (attention_mma.cuh, shared
// with flash_attention.cu). The grid is (chunk, KV head and group of 16
// query heads, batch row): each block takes one 256-position chunk of its
// row's live range [end - n, end), from the chunk that holds the first
// live key, in 64-key tiles through a two-stage ring of 16-byte cp.async
// copies (rolled-cache slots P % S, read row by row; keys outside the live
// range are zeros), for up to 16 query heads of one KV head: the G = Hq /
// Hkv heads of a group are the rows of one m16 instruction tile (4 for
// llama3-8b, 12 for starcoder2-15b, 16 for recurrentgemma-9b's MQA; the
// rest zero), so every K and V value is read once per group. Its warps
// each compute the same S, m and l and add P V into their own output
// columns. Each block writes its chunk's partial (m, l and the unnormalised
// float32 accumulator of its rows) to float32 scratch that the wrapper
// allocates; a second kernel in this file, launched by the same C call,
// merges a row's partials in chunk order and writes acc / l. llama3-8b's
// long batch (4097 live keys) runs 2 x 8 x 17 working blocks (a grid of
// 2 x 8 x 18: the grid takes the most chunks a row of S slots can span,
// and a block past its row's last chunk returns at once); recurrentgemma-
// 9b's long batch (a rolled window of 2048) 2 x 1 x 9.
//
// float32: a simple and right first kernel on the CUDA cores, unchanged:
// one 256-thread block per (KV head, batch row) walks the live keys in
// 32-key tiles in position order, staged in shared memory as float32 with
// coalesced loads along D, and reads nothing past them. The running max
// and denominator of the G rows live in shared memory, one warp per row
// takes a tile's max by shuffles and its sum of p in key order, and each
// thread keeps up to kAcc float32 accumulators of the [G, D] output in
// registers. Only B x Hkv blocks run.
//
// fp8 K/V (the _kv8 entry points). The cache is widened exactly on load
// and nothing else changes: e4m3 -> half (cvt.f16x2.e4m3x2) -> bf16 or
// float32 loses no bit, so the kernel on fp8 caches equals, bit for bit,
// the same kernel on the caches widened first (k.to(bf16) / k.float()),
// and rounds neither q nor p to fp8 (the TPU kernel's astype(float32); the
// fp8 tensor-core mma would round both). bf16 q: each 64-key tile's fp8 K
// and V rows are staged by 16-byte cp.async copies into a two-stage byte
// ring (a D = 128 row is 128 B, 8 copies; rows 16-byte aligned when the
// strides are multiples of 16 elements), and after the barrier that sees
// a tile land one pass widens it, 8 elements a thread-step, into the one
// bf16 K/V tile that qk_tile / softmax_pv read; a second barrier publishes
// it. Without that alignment (or D % 16 != 0) the pass widens element by
// element from global memory. float32 q: the CUDA-core kernel widens each
// element to float32 as it stages the tile. fp8 halves the bytes that
// bound the call: qwen1.5-32b's 2 x 40 x 4097 x 128 live keys and values
// are 83.9 MB, 25 us at 3.35 TB/s (50 us in bf16).
//
// Exactness. Built with --fmad=false; the fused multiply-adds are the
// explicit fmaf of the float32 dots and p . v sums, and the tensor cores'
// own; expf is the accurate one. Against the plain version
// (ref.py:flash_decode_plain) the result differs by summation order and,
// in bf16, by p's two-part rounding. Against flash_attention.cu it is
// equal bit for bit for the same query row and keys: float32 tiles of 32
// and bf16 tiles of 64 start at multiples of their width in key position
// (keys before the first live one masked), the bf16 chunks at multiples
// of 256, and every step is the same arithmetic in the same order (see
// flash_attention.cu and attention_mma.cuh).
//
// C interface (loaded with ctypes): flash_decode_f32 / flash_decode_bf16
// (and flash_decode_f32_kv8 / flash_decode_bf16_kv8, the same arguments
// with k and v float8_e4m3fn) take device pointers q, k, v, length, end,
// out, the sizes
// B, Hq, Hkv, S, D, scale, the element strides of q along (b, h) and of k
// and v along (b, h, s) as host arrays of long long, flash_decode_bf16
// then the float32 scratch part_m and part_l [B * Hq * chunks] and
// part_acc [B * Hq * chunks * D] (chunks = flash_decode_chunks(S)), and
// the CUDA stream; they return the cudaError_t of the launch (0 =
// success). The launch is asynchronous.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

// one float8_e4m3fn element (its bits), the fp8 caches' element type
struct e4m3 {
  unsigned char bits;
};
static_assert(sizeof(e4m3) == 1, "fp8 elements are bytes");

// e4m3 -> half is exact, and so is half -> float and -> bf16
__device__ __forceinline__ float widen(e4m3 x) {
  return __half2float(
      __half(__nv_cvt_fp8_to_halfraw(x.bits, __NV_E4M3)));
}

// 8 fp8 elements (a uint2, the first in the low byte) -> 8 bf16 (a uint4)
__device__ __forceinline__ uint4 widen8(uint2 w) {
  uint32_t out[4];
  const uint32_t in[2] = {w.x, w.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(in[i / 2] >> (16 * (i % 2))),
        __NV_E4M3));
    const float2 f = __half22float2(h);
    out[i] = attn::bf16x2(f.x, f.y);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;     // keys per tile (flash_attention.cu's)
constexpr int kAcc = 32;    // accumulators per thread: G * DPAD <= 8192
constexpr float kMasked = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(e4m3 v) { return widen(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int DPAD>
int smem_bytes(int G) {
  return (G * DPAD + kBK * (DPAD + 1) + kBK * DPAD + G * (kBK + 1) +
          3 * G) * static_cast<int>(sizeof(float));
}

template <typename T, typename KV, int DPAD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const int* __restrict__ length,
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
  const KV* kb = k + b * kb_s + h * kh_s;
  const KV* vb = v + b * vb_s + h * vh_s;

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

template <typename T, typename KV, int DPAD>
int launch_d(const T* q, const KV* k, const KV* v, const int* length,
             const int* end, T* out, int B, int Hq, int Hkv, int S, int D,
             float scale, const long long* st_q, const long long* st_k,
             const long long* st_v, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G * DPAD > kAcc * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes<DPAD>(G);
  auto kernel = flash_decode_kernel<T, KV, DPAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      q, k, v, length, end, out, G, S, D, scale, st_q[0], st_q[1], st_k[0],
      st_k[1], st_k[2], st_v[0], st_v[1], st_v[2]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int launch(const T* q, const KV* k, const KV* v, const int* length,
           const int* end, T* out, int B, int Hq, int Hkv, int S, int D,
           float scale, const long long* st_q, const long long* st_k,
           const long long* st_v, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || S < 0 ||
      B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_d<T, KV, 32>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                               scale, st_q, st_k, st_v, s);
  if (D <= 64)
    return launch_d<T, KV, 64>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                               scale, st_q, st_k, st_v, s);
  if (D <= 128)
    return launch_d<T, KV, 128>(q, k, v, length, end, out, B, Hq, Hkv, S,
                                D, scale, st_q, st_k, st_v, s);
  return launch_d<T, KV, 256>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                              scale, st_q, st_k, st_v, s);
}

// ---- bf16: the tensor cores, split over the cache ---------------------------

// chunks a row of S slots can span: the grid's first dimension
__host__ __device__ inline int chunks(int S) {
  return S > 0 ? (S + attn::kChunk - 2) / attn::kChunk + 1 : 0;
}

// warps per block: each owns NT n8 tiles of the output columns
template <int DP>
__host__ __device__ constexpr int dec_warps() {
  return DP >= 64 ? 4 : DP / 16;
}

// bf16 K/V: q [16][P] and a two-stage ring of K and V tiles; fp8 K/V: q,
// one bf16 K and V tile, and a two-stage byte ring of the fp8 K and V rows
template <int DP, bool kKV8>
__host__ __device__ constexpr int dec_smem_bytes() {
  return (16 + (kKV8 ? 2 : 4) * attn::kTile) * attn::pitch<DP>() *
             static_cast<int>(sizeof(attn::bf16)) +
         (kKV8 ? 4 * attn::kTile * DP : 0);
}

// kTile fp8 rows into dst ([kTile][DP] bytes) by 16-byte cp.async copies:
// row r from row_src(r), zeros where it returns nullptr (D % 16 == 0)
template <int DP, int NTHREADS, typename RowSrc>
__device__ __forceinline__ void stage_rows8(unsigned char* dst, int D,
                                            const e4m3* any,
                                            RowSrc row_src, int tid) {
  constexpr int NCH = DP / 16;  // 16-byte chunks of a padded row
#pragma unroll
  for (int e0 = 0; e0 < attn::kTile * NCH; e0 += NTHREADS) {
    const int e = e0 + tid, r = e / NCH, c = e % NCH;
    if ((attn::kTile * NCH) % NTHREADS != 0 && e >= attn::kTile * NCH) break;
    if (c * 16 >= D) continue;
    const e4m3* src = row_src(r);
    attn::cp_async16(reinterpret_cast<attn::bf16*>(dst + r * DP + c * 16),
                     reinterpret_cast<const attn::bf16*>(
                         src ? src + c * 16 : any),
                     src ? 16 : 0);
  }
}

// the staged rows ([kTile][DP] bytes) widened into a bf16 tile ([kTile][DP]
// at pitch DP + 8), columns 0 .. D - 1, 8 a step
template <int DP, int NTHREADS>
__device__ __forceinline__ void widen_rows8(attn::bf16* dst,
                                            const unsigned char* src, int D,
                                            int tid) {
  constexpr int P = attn::pitch<DP>();
  constexpr int NCH = DP / 8;
#pragma unroll 4
  for (int e = tid; e < attn::kTile * NCH; e += NTHREADS) {
    const int r = e / NCH, c = e % NCH;
    if (c * 8 >= D) continue;
    *reinterpret_cast<uint4*>(dst + r * P + c * 8) =
        widen8(*reinterpret_cast<const uint2*>(src + r * DP + c * 8));
  }
}

// kTile fp8 rows widened from global memory element by element (rows not
// 16-byte aligned), zeros where row_src returns nullptr
template <int DP, int NTHREADS, typename RowSrc>
__device__ __forceinline__ void widen_rows_plain(attn::bf16* dst, int D,
                                                 RowSrc row_src, int tid) {
  constexpr int P = attn::pitch<DP>();
  for (int e = tid; e < attn::kTile * D; e += NTHREADS) {
    const int r = e / D, d = e - r * D;
    const e4m3* src = row_src(r);
    dst[r * P + d] = __float2bfloat16_rn(src ? widen(src[d]) : 0.0f);
  }
}

// row b's live positions [lo, hi) and the chunks they span
struct LiveRange {
  int lo, hi, first, count;
};

__device__ __forceinline__ LiveRange live_range(const int* length,
                                                const int* end, int b,
                                                int S) {
  const int n = max(0, min(length[b], S));
  const int hi = end[b];
  const int lo = max(0, hi - n);
  LiveRange r{lo, hi, lo / attn::kChunk, 0};
  if (hi > lo) r.count = (hi - 1) / attn::kChunk - r.first + 1;
  return r;
}

template <int DP, typename KV>
__global__ void __launch_bounds__(128)
flash_decode_mma(const attn::bf16* __restrict__ q,
                 const KV* __restrict__ k,
                 const KV* __restrict__ v,
                 const int* __restrict__ length,
                 const int* __restrict__ end, float* __restrict__ part_m,
                 float* __restrict__ part_l, float* __restrict__ part_acc,
                 int Hq, int Hkv, int S, int D, float scale, long long qb_s,
                 long long qh_s, long long kb_s, long long kh_s,
                 long long ks_s, long long vb_s, long long vh_s,
                 long long vs_s, int vec) {
  using attn::bf16;
  using attn::kTile;
  constexpr bool kKV8 = std::is_same<KV, e4m3>::value;
  constexpr int P = attn::pitch<DP>();
  constexpr int NW = dec_warps<DP>();
  constexpr int NT = DP / 8 / NW;  // n8 tiles of output per warp
  extern __shared__ __align__(16) unsigned char fd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fd_smem);  // [16][P]
  // bf16: 2 x (K [kTile][P], V [kTile][P]); fp8: one K and V tile
  bf16* ring = qs + 16 * P;
  // fp8: 2 x (K [kTile][DP], V [kTile][DP]) bytes, as they arrive
  unsigned char* stage =
      reinterpret_cast<unsigned char*>(ring + (kKV8 ? 2 : 4) * kTile * P);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, b = blockIdx.z;
  const int G = Hq / Hkv, groups = (G + 15) / 16;
  const int h = blockIdx.y / groups, g0 = (blockIdx.y % groups) * 16;
  const int rows = min(16, G - g0);
  const LiveRange lr = live_range(length, end, b, S);
  if (c >= lr.count) return;
  const int cc = lr.first + c;  // the chunk's index in key position
  const int p_lo = max(lr.lo, cc * attn::kChunk);
  const int p_hi = min(lr.hi, (cc + 1) * attn::kChunk);
  const int t0 = p_lo / kTile, t1 = (p_hi + kTile - 1) / kTile;
  const bf16* qb = q + b * qb_s + (h * G + g0) * qh_s;
  const KV* kb = k + b * kb_s + h * kh_s;
  const KV* vb = v + b * vb_s + h * vh_s;
  // the cache rows of tile t's keys (nullptr outside the chunk's range)
  auto k_row = [=](int t) {
    return [=](int r) -> const KV* {
      const int pos = t * kTile + r;
      return pos >= p_lo && pos < p_hi ? kb + (pos % S) * ks_s : nullptr;
    };
  };
  auto v_row = [=](int t) {
    return [=](int r) -> const KV* {
      const int pos = t * kTile + r;
      return pos >= p_lo && pos < p_hi ? vb + (pos % S) * vs_s : nullptr;
    };
  };

  attn::zero_smem(fd_smem, dec_smem_bytes<DP, kKV8>(), tid, 32 * NW);
  __syncthreads();
  attn::load_rows<DP, 16, 32 * NW>(
      qs, D, vec, qb, [=](int r) -> const bf16* {
        return r < rows ? qb + r * qh_s : nullptr;
      }, tid);
  // bf16: tile t's K and V into ring[t % 2]; fp8: its rows into stage[t %
  // 2] (vec; else nothing: widen_tile reads them); nothing past t1
  auto load_tile = [&](int t) {
    if (t >= t1) return;
    if constexpr (kKV8) {
      if (vec) {
        unsigned char* st = stage + (t & 1) * 2 * kTile * DP;
        stage_rows8<DP, 32 * NW>(st, D, kb, k_row(t), tid);
        stage_rows8<DP, 32 * NW>(st + kTile * DP, D, vb, v_row(t), tid);
      }
    } else {
      bf16* ks = ring + (t & 1) * 2 * kTile * P;
      attn::load_rows<DP, kTile, 32 * NW>(ks, D, vec, kb, k_row(t), tid);
      attn::load_rows<DP, kTile, 32 * NW>(ks + kTile * P, D, vec, vb,
                                          v_row(t), tid);
    }
  };
  // fp8: tile t widened into the bf16 tile (its stage has landed and every
  // warp is done with tile t - 1)
  auto widen_tile = [&](int t) {
    if constexpr (kKV8) {
      if (vec) {
        const unsigned char* st = stage + (t & 1) * 2 * kTile * DP;
        widen_rows8<DP, 32 * NW>(ring, st, D, tid);
        widen_rows8<DP, 32 * NW>(ring + kTile * P, st + kTile * DP, D, tid);
      } else {
        widen_rows_plain<DP, 32 * NW>(ring, D, k_row(t), tid);
        widen_rows_plain<DP, 32 * NW>(ring + kTile * P, D, v_row(t), tid);
      }
    }
  };
  load_tile(t0);
  attn::cp_async_commit();

  float m[2] = {attn::kMasked, attn::kMasked}, l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    attn::cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    load_tile(t + 1);  // into tile t - 1's place
    attn::cp_async_commit();
    if constexpr (kKV8) {
      widen_tile(t);
      __syncthreads();  // the widened tile, for every warp
    }
    const bf16* ks = ring + (kKV8 ? 0 : (t & 1) * 2 * kTile * P);
    const int j0 = t * kTile;
    auto live = [=](int, int col) {
      const int pos = j0 + col;
      return pos >= lr.lo && pos < lr.hi;
    };
    float s[kTile / 8][4];
    attn::qk_tile<DP>(qs, ks, s);
    if (j0 >= lr.lo && j0 + kTile <= lr.hi)  // every key live
      attn::softmax_pv<DP, NT, true>(s, ks + kTile * P, warp * NT, scale,
                                     live, m, l, acc);
    else
      attn::softmax_pv<DP, NT, false>(s, ks + kTile * P, warp * NT, scale,
                                      live, m, l, acc);
  }
  attn::cp_async_wait<0>();

  // the chunk's partial of the group's rows
  const int n_chunks = gridDim.x;
  const int row0 = b * Hq + h * G + g0;
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = (lane >> 2) + 8 * hh;
    if (r >= rows) continue;
    const long long slot = static_cast<long long>(row0 + r) * n_chunks + c;
    if (warp == 0 && (lane & 3) == 0) {
      part_m[slot] = m[hh];
      part_l[slot] = l[hh];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = (warp * NT + n) * 8 + cq + e;
        if (d < D) part_acc[slot * D + d] = acc[n][2 * hh + e];
      }
  }
}

// out[row] = the merge of the row's partials in chunk order, / l
__global__ void __launch_bounds__(128)
flash_decode_merge(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc,
                   const int* __restrict__ length,
                   const int* __restrict__ end, attn::bf16* __restrict__ out,
                   int Hq, int S, int D, int n_chunks) {
  const int row = blockIdx.x, b = row / Hq;
  const LiveRange lr = live_range(length, end, b, S);
  const long long base = static_cast<long long>(row) * n_chunks;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float m = attn::kMasked, l = 0.0f, a = 0.0f;
    for (int c = 0; c < lr.count; ++c) {
      float e1, e2;
      attn::merge_scales(m, part_m[base + c], e1, e2);
      l = attn::merge_value(l, e1, part_l[base + c], e2);
      a = attn::merge_value(a, e1, part_acc[(base + c) * D + d], e2);
    }
    out[static_cast<long long>(row) * D + d] =
        __float2bfloat16_rn(attn::finish(a, l));
  }
}

template <int DP, typename KV>
int launch_mma_d(const attn::bf16* q, const KV* k,
                 const KV* v, const int* length, const int* end,
                 attn::bf16* out, float* part_m, float* part_l,
                 float* part_acc, int B, int Hq, int Hkv, int S, int D,
                 float scale, const long long* st_q, const long long* st_k,
                 const long long* st_v, cudaStream_t stream) {
  const int n_chunks = chunks(S);
  if (n_chunks > 0) {
    constexpr bool kKV8 = std::is_same<KV, e4m3>::value;
    constexpr int bytes = dec_smem_bytes<DP, kKV8>();
    auto kernel = flash_decode_mma<DP, KV>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte copies: 8 bf16 or 16 fp8 elements
    constexpr int kv_vec = kKV8 ? 16 : 8;
    auto rows16 = [](const void* p, const long long* st) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
             st[0] % kv_vec == 0 && st[1] % kv_vec == 0 &&
             st[2] % kv_vec == 0;
    };
    const int vec = D % kv_vec == 0 && attn::aligned16(q, st_q[1]) &&
                    st_q[0] % 8 == 0 && rows16(k, st_k) && rows16(v, st_v);
    const int G = Hq / Hkv;
    const dim3 grid(n_chunks, Hkv * ((G + 15) / 16), B);
    kernel<<<grid, 32 * dec_warps<DP>(), bytes, stream>>>(
        q, k, v, length, end, part_m, part_l, part_acc, Hq, Hkv, S, D,
        scale, st_q[0], st_q[1], st_k[0], st_k[1], st_k[2], st_v[0],
        st_v[1], st_v[2], vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_decode_merge<<<B * Hq, 128, 0, stream>>>(
      part_m, part_l, part_acc, length, end, out, Hq, S, D, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int launch_mma(const attn::bf16* q, const KV* k, const KV* v,
               const int* length, const int* end, attn::bf16* out,
               float* part_m, float* part_l, float* part_acc, int B, int Hq,
               int Hkv, int S, int D, float scale, const long long* st_q,
               const long long* st_k, const long long* st_v, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || S < 0 ||
      B > 65535 || Hkv * ((Hq / Hkv + 15) / 16) > 65535 ||
      static_cast<long long>(B) * Hq > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FD_ARGS                                                           \
  q, k, v, length, end, out, part_m, part_l, part_acc, B, Hq, Hkv, S, D, \
      scale, st_q, st_k, st_v, s
  switch (attn::padded_dim(D)) {
    case 16: return launch_mma_d<16, KV>(FD_ARGS);
    case 32: return launch_mma_d<32, KV>(FD_ARGS);
    case 64: return launch_mma_d<64, KV>(FD_ARGS);
    case 128: return launch_mma_d<128, KV>(FD_ARGS);
    case 160: return launch_mma_d<160, KV>(FD_ARGS);
    default: return launch_mma_d<256, KV>(FD_ARGS);
  }
#undef FD_ARGS
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

extern "C" int flash_decode_f32_kv8(const float* q, const void* k,
                                    const void* v, const int* length,
                                    const int* end, float* out, int B,
                                    int Hq, int Hkv, int S, int D,
                                    float scale, const long long* st_q,
                                    const long long* st_k,
                                    const long long* st_v, void* stream) {
  return launch<float, e4m3>(q, static_cast<const e4m3*>(k),
                             static_cast<const e4m3*>(v), length, end, out,
                             B, Hq, Hkv, S, D, scale, st_q, st_k, st_v,
                             stream);
}

extern "C" int flash_decode_chunks(int S) { return chunks(S); }

extern "C" int flash_decode_bf16(const __nv_bfloat16* q,
                                 const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const int* length,
                                 const int* end, __nv_bfloat16* out, int B,
                                 int Hq, int Hkv, int S, int D, float scale,
                                 const long long* st_q, const long long* st_k,
                                 const long long* st_v, float* part_m,
                                 float* part_l, float* part_acc,
                                 void* stream) {
  return launch_mma(q, k, v, length, end, out, part_m, part_l, part_acc, B,
                    Hq, Hkv, S, D, scale, st_q, st_k, st_v, stream);
}

extern "C" int flash_decode_bf16_kv8(const __nv_bfloat16* q, const void* k,
                                     const void* v, const int* length,
                                     const int* end, __nv_bfloat16* out,
                                     int B, int Hq, int Hkv, int S, int D,
                                     float scale, const long long* st_q,
                                     const long long* st_k,
                                     const long long* st_v, float* part_m,
                                     float* part_l, float* part_acc,
                                     void* stream) {
  return launch_mma(q, static_cast<const e4m3*>(k),
                    static_cast<const e4m3*>(v), length, end, out, part_m,
                    part_l, part_acc, B, Hq, Hkv, S, D, scale, st_q, st_k,
                    st_v, stream);
}
