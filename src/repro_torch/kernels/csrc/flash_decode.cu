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

// whether key position pos is held here: its slot pos % S is one of this
// cache's run off .. off + L - 1 (every slot of a whole cache: off = 0,
// L = S)
__device__ __forceinline__ bool local(int pos, int S, int off, int L) {
  const int slot = pos % S - off;
  return slot >= 0 && slot < L;
}

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
                    long long vs_s, int off, int L,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int n_out) {
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
      int slot = slot0 + t;
      while (slot >= S) slot -= S;
      slot -= off;  // in this cache's run of slots
      const bool in = pos >= lo && pos < hi && d < D && slot >= 0 &&
                      slot < L;
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
      ps[g * PP + t] = pos >= lo && pos < hi && local(pos, S, off, L)
                           ? s * scale
                           : kMasked;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* pr = ps + g * PP;
      const int pos = p0 + lane;
      const bool live = pos >= lo && pos < hi && local(pos, S, off, L);
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
  if (part_m != nullptr) {  // this run's keys as one partial, entry 0
    const long long row0 = static_cast<long long>(b) * Hkv * G + h * G;
    for (int g = tid; g < G; g += kThreads) {
      part_m[(row0 + g) * n_out] = m[g];
      part_l[(row0 + g) * n_out] = l[g];
    }
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int e = tid + j * kThreads;
      if (e < G * DPAD && e % DPAD < D)
        part_acc[(row0 + e / DPAD) * n_out * D + e % DPAD] = acc[j];
    }
    return;
  }
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

// the float32 path's part (ops.py's partial entry, part_m non-null):
// slots off .. off + L - 1 of the S, one partial of all of them, entry 0
// of each row's n_out (the wrapper fills the others empty)
struct F32Part {
  int off, L;
  float *m, *l, *acc;
  int n_out;
};

template <typename T, typename KV, int DPAD>
int launch_d(const T* q, const KV* k, const KV* v, const int* length,
             const int* end, T* out, int B, int Hq, int Hkv, int S, int D,
             float scale, const long long* st_q, const long long* st_k,
             const long long* st_v, cudaStream_t stream, F32Part pt) {
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
      st_k[1], st_k[2], st_v[0], st_v[1], st_v[2], pt.off, pt.L, pt.m,
      pt.l, pt.acc, pt.n_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int launch(const T* q, const KV* k, const KV* v, const int* length,
           const int* end, T* out, int B, int Hq, int Hkv, int S, int D,
           float scale, const long long* st_q, const long long* st_k,
           const long long* st_v, void* stream,
           F32Part pt = {0, -1, nullptr, nullptr, nullptr, 0}) {
  if (B <= 0 || Hq <= 0) return 0;
  if (pt.L < 0) pt.L = S;  // the whole cache
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || S < 0 ||
      B > 65535 || Hkv > 65535 || pt.off < 0 || pt.off + pt.L > S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_d<T, KV, 32>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                               scale, st_q, st_k, st_v, s, pt);
  if (D <= 64)
    return launch_d<T, KV, 64>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                               scale, st_q, st_k, st_v, s, pt);
  if (D <= 128)
    return launch_d<T, KV, 128>(q, k, v, length, end, out, B, Hq, Hkv, S,
                                D, scale, st_q, st_k, st_v, s, pt);
  return launch_d<T, KV, 256>(q, k, v, length, end, out, B, Hq, Hkv, S, D,
                              scale, st_q, st_k, st_v, s, pt);
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

// whether chunk c of a row's live range holds a live key at one of the
// slots off .. off + L - 1 (ref.py:_meets): the chunk's live positions
// [p0, p1), at most S of them, sit at slots [a, a + p1 - p0) mod S
__device__ __forceinline__ bool chunk_meets(const LiveRange& lr, int c,
                                            int S, int off, int L) {
  const int p0 = max(lr.lo, (lr.first + c) * attn::kChunk);
  const int p1 = min(lr.hi, (lr.first + c + 1) * attn::kChunk);
  if (p1 <= p0) return false;
  const int a = p0 % S, b = a + (p1 - p0);
  return max(a, off) < min(b, off + L) ||
         max(a, off + S) < min(b, off + L + S);
}

// ranks whose partials one merge takes at most (a chunk's ranks are one
// 64-bit mask)
constexpr int kMaxRanks = 64;

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
                 long long vs_s, int vec, int off, int L, int part) {
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
  const int n_chunks = gridDim.x;
  const int row0 = b * Hq + h * G + g0;
  int ci = c;  // the chunk of the row's live range this block takes
  if (part) {  // the c-th of those that meet this cache's run of slots
    ci = -1;
    for (int i = 0, k = 0; i < lr.count && ci < 0; ++i)
      if (chunk_meets(lr, i, S, off, L) && k++ == c) ci = i;
    if (ci < 0) {  // an empty entry
      for (int e = tid; e < rows * D; e += 32 * NW) {
        const long long slot =
            static_cast<long long>(row0 + e / D) * n_chunks + c;
        part_acc[slot * D + e % D] = 0.0f;
        if (e % D == 0) {
          part_m[slot] = attn::kMasked;
          part_l[slot] = 0.0f;
        }
      }
      return;
    }
  } else if (c >= lr.count) {
    return;
  }
  const int cc = lr.first + ci;  // the chunk's index in key position
  const int p_lo = max(lr.lo, cc * attn::kChunk);
  const int p_hi = min(lr.hi, (cc + 1) * attn::kChunk);
  const int t0 = p_lo / kTile, t1 = (p_hi + kTile - 1) / kTile;
  const bf16* qb = q + b * qb_s + (h * G + g0) * qh_s;
  const KV* kb = k + b * kb_s + h * kh_s;
  const KV* vb = v + b * vb_s + h * vh_s;
  // the cache rows of tile t's keys (nullptr outside the chunk's range)
  // (the keys on slots outside this cache's run off .. off + L - 1 are
  // not live here: all of them are in a whole cache, off = 0 and L = S)
  auto here = [=](int pos) { return local(pos, S, off, L); };
  auto k_row = [=](int t) {
    return [=](int r) -> const KV* {
      const int pos = t * kTile + r;
      return pos >= p_lo && pos < p_hi && here(pos)
                 ? kb + (pos % S - off) * ks_s
                 : nullptr;
    };
  };
  auto v_row = [=](int t) {
    return [=](int r) -> const KV* {
      const int pos = t * kTile + r;
      return pos >= p_lo && pos < p_hi && here(pos)
                 ? vb + (pos % S - off) * vs_s
                 : nullptr;
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
      return pos >= lr.lo && pos < lr.hi && here(pos);
    };
    float s[kTile / 8][4];
    attn::qk_tile<DP>(qs, ks, s);
    const int js = j0 % S - off;  // the tile's first slot in the run
    if (j0 >= lr.lo && j0 + kTile <= lr.hi &&
        (L == S || (js >= 0 && js + kTile <= L)))  // every key live
      attn::softmax_pv<DP, NT, true>(s, ks + kTile * P, warp * NT, scale,
                                     live, m, l, acc);
    else
      attn::softmax_pv<DP, NT, false>(s, ks + kTile * P, warp * NT, scale,
                                      live, m, l, acc);
  }
  attn::cp_async_wait<0>();

  // the chunk's partial of the group's rows
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

// the merge of a sliced cache's partials runs 128 threads a row
constexpr int kMergeThreads = 128;
static_assert(kMaxRanks <= kMergeThreads, "a thread for each rank");

// the exclusive scan of v over the block under op (associative, identity
// id; kMergeThreads threads), and in *all the reduction of every v; tot:
// kMergeThreads / 32 values of shared memory
template <typename T, typename Op>
__device__ __forceinline__ T block_exclusive(T v, T id, Op op, T* tot,
                                             T* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, k);
    if (lane >= k) x = op(y, x);
  }
  T ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = id;
  if (lane == 31) tot[warp] = x;
  __syncthreads();
  T pre = id, sum = id;
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) {
    if (w < warp) pre = op(pre, tot[w]);
    sum = op(sum, tot[w]);
  }
  *all = sum;
  __syncthreads();  // tot free again
  return op(pre, ex);
}

// thread t's share [lo, hi) of n items taken in contiguous runs
__device__ __forceinline__ void share(int n, int& lo, int& hi) {
  const int per = (n + kMergeThreads - 1) / kMergeThreads;
  lo = min(n, static_cast<int>(threadIdx.x) * per);
  hi = min(n, lo + per);
}

// shared bytes of a merge: for each of a row's chunks its ranks' mask and
// its first piece; for each piece its m's and acc's offsets, e1, e2 and l
__host__ __device__ constexpr long long merge_smem_bytes(int max_chunks,
                                                         int max_pieces) {
  return 12LL * max_chunks + 28LL * max_pieces;
}

// out[row] = the merge of every rank's partials of the row (parts: rank
// r's [m | l | acc] at r * rank_stride, n_out entries a row; rank r held
// slots r L .. r L + L - 1 of the S), chunk by chunk in the whole-cache
// kernel's order, the pieces of one chunk in rank order, / l. A piece is
// a (chunk, rank) whose keys meet (chunk_meets, the partial kernel's
// test); one block a row builds the row's order once in shared memory:
// (1) each chunk's mask of ranks and its first place in the order (a
// scan of the masks' counts); (2) thread r puts rank r's entries, in
// chunk order, at their places; (3) the running max over the order (a
// scan under fmaxf, which returns one of its operands, so any grouping
// gives the sequential max's value, up to the sign of a zero that expf of
// the difference does not see), and each piece's two scales from
// merge_scales, as the sequential merge computes them; (4) each column
// thread merges l and its acc column along the order.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
flash_decode_merge_parts(const float* __restrict__ parts,
                         long long rank_stride, int ranks, int n_out,
                         const int* __restrict__ length,
                         const int* __restrict__ end, T* __restrict__ out,
                         int B, int Hq, int S, int L, int D,
                         int max_chunks, int max_pieces) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  __shared__ int tot_i[kMergeThreads / 32];
  __shared__ float tot_f[kMergeThreads / 32];
  auto* mask = reinterpret_cast<unsigned long long*>(merge_smem);
  auto* src = reinterpret_cast<long long*>(mask + max_chunks);
  long long* src_m = src + max_pieces;
  auto* first = reinterpret_cast<int*>(src_m + max_pieces);
  float* e1s = reinterpret_cast<float*>(first + max_chunks);
  float* e2s = e1s + max_pieces;  // m of each piece until (3)
  float* ls = e2s + max_pieces;
  const int row = blockIdx.x, b = row / Hq, tid = threadIdx.x;
  const LiveRange lr = live_range(length, end, b, S);
  const long long n = static_cast<long long>(B) * Hq * n_out;

  // (1) the ranks that each chunk meets, and its first piece
  int c0, c1;
  share(lr.count, c0, c1);
  int mine = 0;
  for (int c = c0; c < c1; ++c) {
    unsigned long long mk = 0;
    for (int r = 0; r < ranks; ++r)
      if (chunk_meets(lr, c, S, r * L, L)) mk |= 1ull << r;
    mask[c] = mk;
    mine += __popcll(mk);
  }
  int pieces;
  int at = block_exclusive(mine, 0, [](int x, int y) { return x + y; },
                           tot_i, &pieces);
  for (int c = c0; c < c1; ++c) {
    first[c] = at;
    at += __popcll(mask[c]);
  }
  __syncthreads();

  // (2) rank r's e-th entry is the e-th chunk that meets it: thread r
  // places its entries, then every thread reads a share of their m and l
  if (tid < ranks) {
    const unsigned long long below = (1ull << tid) - 1;
    long long e = tid * rank_stride + static_cast<long long>(row) * n_out;
    for (int c = 0; c < lr.count; ++c) {
      const unsigned long long mk = mask[c];
      if (!((mk >> tid) & 1)) continue;
      const int p = first[c] + __popcll(mk & below);
      src_m[p] = e;
      src[p] = e + 2 * n + (e - tid * rank_stride) * (D - 1);
      ++e;
    }
  }
  __syncthreads();
  for (int p = tid; p < pieces; p += kMergeThreads) {
    e2s[p] = parts[src_m[p]];
    ls[p] = parts[src_m[p] + n];
  }
  __syncthreads();

  // (3) the running max before each piece, and the piece's scales
  int p0, p1;
  share(pieces, p0, p1);
  float mx = attn::kMasked;
  for (int p = p0; p < p1; ++p) mx = fmaxf(mx, e2s[p]);
  float total;
  float m = block_exclusive(
      mx, attn::kMasked, [](float x, float y) { return fmaxf(x, y); },
      tot_f, &total);
  for (int p = p0; p < p1; ++p) {
    float e1, e2;
    attn::merge_scales(m, e2s[p], e1, e2);
    e1s[p] = e1;
    e2s[p] = e2;
  }
  __syncthreads();

  // (4) each column along the order
  for (int d = tid; d < D; d += kMergeThreads) {
    float l = 0.0f, a = 0.0f;
#pragma unroll 16
    for (int p = 0; p < pieces; ++p) {
      const float e1 = e1s[p], e2 = e2s[p];
      l = attn::merge_value(l, e1, ls[p], e2);
      a = attn::merge_value(a, e1, parts[src[p] + d], e2);
    }
    const float o = attn::finish(a, l);
    if constexpr (std::is_same<T, float>::value)
      out[static_cast<long long>(row) * D + d] = o;
    else
      out[static_cast<long long>(row) * D + d] = __float2bfloat16_rn(o);
  }
}

// the mma path's part (ops.py's partial entry, part != 0): slots off ..
// off + L - 1 of the S, the n_out chunks of a row that meet them
struct MmaPart {
  int off, L, n_out, part;
};

template <int DP, typename KV>
int launch_mma_d(const attn::bf16* q, const KV* k,
                 const KV* v, const int* length, const int* end,
                 attn::bf16* out, float* part_m, float* part_l,
                 float* part_acc, int B, int Hq, int Hkv, int S, int D,
                 float scale, const long long* st_q, const long long* st_k,
                 const long long* st_v, cudaStream_t stream, MmaPart pt) {
  const int n_chunks = pt.part ? pt.n_out : chunks(S);
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
        st_v[1], st_v[2], vec, pt.off, pt.L, pt.part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (pt.part) return 0;
  flash_decode_merge<<<B * Hq, 128, 0, stream>>>(
      part_m, part_l, part_acc, length, end, out, Hq, S, D, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int launch_mma(const attn::bf16* q, const KV* k, const KV* v,
               const int* length, const int* end, attn::bf16* out,
               float* part_m, float* part_l, float* part_acc, int B, int Hq,
               int Hkv, int S, int D, float scale, const long long* st_q,
               const long long* st_k, const long long* st_v, void* stream,
               MmaPart pt = {0, -1, 0, 0}) {
  if (B <= 0 || Hq <= 0) return 0;
  if (pt.L < 0) pt.L = S;  // the whole cache
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || S < 0 ||
      B > 65535 || Hkv * ((Hq / Hkv + 15) / 16) > 65535 ||
      static_cast<long long>(B) * Hq > 2147483647LL || pt.off < 0 ||
      pt.off + pt.L > S || pt.n_out > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FD_ARGS                                                           \
  q, k, v, length, end, out, part_m, part_l, part_acc, B, Hq, Hkv, S, D, \
      scale, st_q, st_k, st_v, s, pt
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

// ---- a cache cut along its slots (ops.py: flash_decode_partial, _merge) ----
//
// Each rank holds slots off .. off + L - 1 of the S. The _part entry
// points take the same arguments as the whole-cache ones (k and v this
// rank's run, their strides), then off, L and n_out (ref.py:
// decode_local_chunks(S, L)), and write this rank's float32 partials,
// part_m and part_l [B * Hq * n_out] and part_acc [B * Hq * n_out * D]:
// bf16 q, each chunk of the whole-cache kernel that meets the run, in
// chunk order, computed as that kernel computes it with the other slots'
// keys not live (the unused entries empty: m = kMasked, l = 0, acc = 0);
// float32 q, one partial of all the run's keys in entry 0 (the caller
// fills the rest empty). flash_decode_merge_bf16 / _f32 merge every
// rank's partials (parts [ranks][2 n + n D] floats, n = B * Hq * n_out,
// rank r at r * rank_stride) into out [B, Hq, D]. Where S and L are
// multiples of kChunk every chunk lies on one rank and bf16 gives the
// whole-cache kernel's result bit for bit.

extern "C" int flash_decode_bf16_part(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const int* length, const int* end, int B, int Hq, int Hkv, int S, int D,
    float scale, const long long* st_q, const long long* st_k,
    const long long* st_v, int off, int L, int n_out, float* part_m,
    float* part_l, float* part_acc, void* stream) {
  return launch_mma(q, k, v, length, end, nullptr, part_m, part_l, part_acc,
                    B, Hq, Hkv, S, D, scale, st_q, st_k, st_v, stream,
                    MmaPart{off, L, n_out, 1});
}

extern "C" int flash_decode_bf16_kv8_part(
    const __nv_bfloat16* q, const void* k, const void* v, const int* length,
    const int* end, int B, int Hq, int Hkv, int S, int D, float scale,
    const long long* st_q, const long long* st_k, const long long* st_v,
    int off, int L, int n_out, float* part_m, float* part_l,
    float* part_acc, void* stream) {
  return launch_mma(q, static_cast<const e4m3*>(k),
                    static_cast<const e4m3*>(v), length, end, nullptr,
                    part_m, part_l, part_acc, B, Hq, Hkv, S, D, scale, st_q,
                    st_k, st_v, stream, MmaPart{off, L, n_out, 1});
}

extern "C" int flash_decode_f32_part(
    const float* q, const float* k, const float* v, const int* length,
    const int* end, int B, int Hq, int Hkv, int S, int D, float scale,
    const long long* st_q, const long long* st_k, const long long* st_v,
    int off, int L, int n_out, float* part_m, float* part_l,
    float* part_acc, void* stream) {
  return launch<float>(q, k, v, length, end, nullptr, B, Hq, Hkv, S, D,
                       scale, st_q, st_k, st_v, stream,
                       F32Part{off, L, part_m, part_l, part_acc, n_out});
}

extern "C" int flash_decode_f32_kv8_part(
    const float* q, const void* k, const void* v, const int* length,
    const int* end, int B, int Hq, int Hkv, int S, int D, float scale,
    const long long* st_q, const long long* st_k, const long long* st_v,
    int off, int L, int n_out, float* part_m, float* part_l,
    float* part_acc, void* stream) {
  return launch<float, e4m3>(q, static_cast<const e4m3*>(k),
                             static_cast<const e4m3*>(v), length, end,
                             nullptr, B, Hq, Hkv, S, D, scale, st_q, st_k,
                             st_v, stream,
                             F32Part{off, L, part_m, part_l, part_acc,
                                     n_out});
}

template <typename T>
int merge_parts(const float* parts, long long rank_stride, int ranks,
                int n_out, const int* length, const int* end, T* out,
                int B, int Hq, int S, int L, int D, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (ranks <= 0 || ranks > kMaxRanks || L <= 0 || ranks * L != S ||
      D <= 0 || n_out < 0 || static_cast<long long>(B) * Hq > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  // a row's live range spans at most chunks(S) chunks, and each rank
  // keeps at most n_out of their pieces
  const int max_chunks = chunks(S), max_pieces = ranks * n_out;
  const long long bytes = merge_smem_bytes(max_chunks, max_pieces);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_merge_parts<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_decode_merge_parts<T>
      <<<B * Hq, kMergeThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          parts, rank_stride, ranks, n_out, length, end, out, B, Hq, S, L,
          D, max_chunks, max_pieces);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_decode_merge_bf16(const float* parts,
                                       long long rank_stride, int ranks,
                                       int n_out, const int* length,
                                       const int* end, __nv_bfloat16* out,
                                       int B, int Hq, int S, int L, int D,
                                       void* stream) {
  return merge_parts(parts, rank_stride, ranks, n_out, length, end, out, B,
                     Hq, S, L, D, stream);
}

extern "C" int flash_decode_merge_f32(const float* parts,
                                      long long rank_stride, int ranks,
                                      int n_out, const int* length,
                                      const int* end, float* out, int B,
                                      int Hq, int S, int L, int D,
                                      void* stream) {
  return merge_parts(parts, rank_stride, ranks, n_out, length, end, out, B,
                     Hq, S, L, D, stream);
}
