// Prefill attention with an online softmax: the Hopper port of the Pallas
// kernel src/repro/kernels/flash_attention.py:flash_attention (pallas_call
// at :104).
//
// What it computes. q is [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], all
// float32 or all bf16, each read through its own element strides (unit
// stride along D), so the model's head-split views of [B, S, H, D]
// projections pass without a copy. Query head h reads KV head h / G,
// G = Hq / Hkv (GQA and MQA, no repeated KV). Query row i sits at position
// qpos = Sk - Sq + i (right-aligned); key j is live iff j < Sk, j <= qpos
// under causal, and j > qpos - window under a window (window <= 0: none).
// Scores are (q . k) * scale in float32, the dot summed in ascending d
// with fmaf; masked scores are -0.7 * FLT_MAX, as on the TPU, and weigh
// exactly nothing (p = 0), so a row with no live key has a zero
// denominator and gives zeros (the TPU kernel's guard). out [B, Hq, Sq, D]
// gets sum_j p_j v_j / sum_j p_j in q's type, through its own strides.
//
// Bound on this card. Per (b, h), 4 D operations for every live
// (query, key) pair against 2 (Sq + 2 Sk) D elements moved: at a 4096-
// token causal prefill, head_dim 128, some 8.4 M live pairs per (b, h),
// 4.3 GFLOP against 4 MB, far above the card's ~295 bf16 operations per
// byte, so the operations bound rules (989 TFLOP/s with tensor cores,
// 67 without). At the serve batch's 82 tokens the bytes bound rules.
//
// bf16: the tensor cores (attention_mma.cuh, shared with flash_decode.cu).
// One 256-thread block per (query tile, query head, batch row), the tiles
// taken longest first (causal). Each warp owns 16 query rows: S = Q K^T by
// mma.sync m16n8k16 (Q and K through ldmatrix), the online softmax on the
// C fragments, then P V with p split into two bf16 parts (V through
// ldmatrix.trans). 64-key tiles of K and V come through two-tile rings
// in shared memory, filled by 16-byte cp.async copies through the strided
// head-split views (plain loads where a row is not 16-byte aligned), the
// next tile's copies in flight while the block works on this one (one
// barrier a tile); rows padded by 16 bytes against bank conflicts; head
// dims padded with zeros to 16, 32, 64, 128, 160 or 256. Up to D = 128 a
// block holds 128 rows, a warp per 16; above (stablelm's 160,
// recurrentgemma's 256) two warps share 16 rows, each keeping half of the
// output columns (each computes the same S: the float32 accumulators of
// 16 rows x 256 columns, for the chunk's partial and the merged total,
// would be 256 registers a thread), so a block holds 64. The state closes
// into a partial every 256 key positions and merges into the row's total
// in chunk order, as flash_decode.cu's blocks do. The live key range of a
// tile is computed once from its first and last query position (the
// causal upper edge, the window's lower edge), so tiles behind the window
// or past the diagonal cost nothing; a warp skips the tiles masked for all
// its rows, and evaluates no mask on tiles live for all of them.
//
// What holds it back (PERF.md, PR 17): p's two parts cost 1.5x the
// tensor-core work of one P V (a single bf16 p would miss the plain
// version by 2^-9 of max|v|), and the chunk's partial beside the total
// takes 128 of a thread's registers at D = 128, so eight warps a SM is
// the most that fits; a warp's chain of dependent softmax steps is then
// left largely unhidden. About 0.15 of the card's peak at llama3-8b's
// 4096-token prefill.
//
// float32: a simple and right first kernel on the CUDA cores (IEEE fmaf;
// no mma, cp.async or TMA). One 256-thread block per (64-query tile, query
// head, batch row) keeps the tile's running max m, denominator l and
// float32 accumulator in registers across the key loop. Each 32-key tile of
// K and V is staged in shared memory (rows padded by one to spread the
// banks), the query tile stays there for the whole loop (dynamic shared
// memory: 137 KB at D = 256). Thread (r, c), r = tid / 8, c = tid % 8, owns
// query rows r and r + 32: their scores against keys c, c + 8, c + 16,
// c + 24 (eight dots, each q value read once for four keys), the row max
// by shuffles among the row's eight threads, and the accumulators of
// output columns c + 8 j, j < DPAD / 8, for both rows (each thread also
// sums its rows' p).
//
// Exactness. Built with --fmad=false; the fused multiply-adds are the
// explicit fmaf of the float32 dot products and p . v sums, and the tensor
// cores' own; expf is the accurate one (no fast-math intrinsics). Against
// the plain version (ref.py:flash_attention_plain) the result differs by
// summation order (about 1e-6 relative in float32) and, in bf16, by p's
// two-part rounding (2^-18 of it): within 1e-5 max|v| plus one bf16 ulp
// of the output. Against flash_decode.cu it is equal bit for bit: a query
// row's result is the same arithmetic in the same order in both kernels
// (float32: the dot in ascending d, 32-key tiles at multiples of 32 in key
// position, fully masked tiles leaving m, l and the accumulators as they
// are, the tile's max, then p, the tile's sum of p and the p . v sums in
// ascending key order; bf16: the invariants of attention_mma.cuh). The
// rows of a query tile never see each other, and the tiles a row reads
// past its own live keys are masked for it, so a row's result does not
// depend on Sq either. That, with the matmul kernel's row-independent
// products, makes the model's decode step equal its prefill of one more
// token.
//
// C interface (loaded with ctypes): flash_attention_f32 /
// flash_attention_bf16 take device pointers q, k, v, out, the sizes B,
// Hq, Hkv, Sq, Sk, D, causal (0/1), window (<= 0: none), scale, the
// element strides of q, k, v and out along (b, h, s) as three 3-element
// arrays of long long on the host, and the CUDA stream; they return the
// cudaError_t of the launch (0 = success). The launch is asynchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // keys per tile
constexpr float kMasked = -0.7f * FLT_MAX;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int DPAD>
constexpr int smem_bytes() {
  return (kBQ * (DPAD + 1) + kBK * (DPAD + 1) + kBK * DPAD +
          kBQ * (kBK + 1)) * static_cast<int>(sizeof(float));
}

// rows x DPAD tile of src (rows from row0, D real columns, zeros past the
// edges) into dst with row pitch `pitch`
template <typename T, int DPAD>
__device__ __forceinline__ void stage(float* dst, int pitch,
                                      const T* __restrict__ src,
                                      long long s_stride, int row0,
                                      int rows, int n_rows, int D) {
  for (int e = threadIdx.x; e < rows * DPAD; e += kThreads) {
    const int r = e / DPAD, d = e % DPAD;
    const int gr = row0 + r;
    dst[r * pitch + d] = (gr < n_rows && d < D)
                             ? to_float(src[gr * s_stride + d])
                             : 0.0f;
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int Hkv, int Sq, int Sk, int D, int causal,
                       int window, float scale, Strides sq, Strides sk,
                       Strides sv, Strides so) {
  constexpr int QP = DPAD + 1;  // padded pitches of the q and k tiles
  constexpr int KP = DPAD + 1;
  constexpr int PP = kBK + 1;
  constexpr int NC = DPAD / 8;  // output columns per thread and row
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][QP]
  float* ks = qs + kBQ * QP;         // [kBK][KP]
  float* vs = ks + kBK * KP;         // [kBK][DPAD]
  float* ps = vs + kBK * DPAD;       // [kBQ][PP]

  const int tid = threadIdx.x;
  const int r = tid / 8, c = tid % 8;
  const int i0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  // live keys of the tile: [k_begin, k_end)
  const int q_lo = Sk - Sq + i0;
  const int q_hi = Sk - Sq + min(i0 + kBQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = max(0, min(Sk, q_hi + 1));
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  stage<T, DPAD>(qs, QP, qb, sq.s, i0, kBQ, Sq, D);

  float m[2] = {kMasked, kMasked};
  float l[2] = {0.0f, 0.0f};
  float acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[a][j] = 0.0f;

  for (int j0 = k_begin; j0 < k_end; j0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, DPAD>(ks, KP, kb, sk.s, j0, kBK, Sk, D);
    stage<T, DPAD>(vs, DPAD, vb, sv.s, j0, kBK, Sk, D);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[a][t] = 0.0f;
    const float* q0 = qs + r * QP;
    const float* q1 = qs + (r + 32) * QP;
    for (int d = 0; d < DPAD; ++d) {
      const float x0 = q0[d], x1 = q1[d];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float y = ks[(c + 8 * t) * KP + d];
        s[0][t] = fmaf(x0, y, s[0][t]);
        s[1][t] = fmaf(x1, y, s[1][t]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int qpos = Sk - Sq + i0 + r + 32 * a;
      bool live[4];
      float mx = kMasked;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int kpos = j0 + c + 8 * t;
        live[t] = kpos < Sk && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        s[a][t] = live[t] ? s[a][t] * scale : kMasked;
        mx = fmaxf(mx, s[a][t]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        ps[(r + 32 * a) * PP + c + 8 * t] =
            live[t] ? expf(s[a][t] - m_new) : 0.0f;
      alpha[a] = expf(m[a] - m_new);
      m[a] = m_new;
    }
    __syncwarp();  // a row's p values come from its own eight lanes
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[a][j] *= alpha[a];
    // keys in order: the p . v sums and the tile's sum of p, each in
    // ascending key order, as flash_decode.cu takes them (see Exactness)
    const float* p0 = ps + r * PP;
    const float* p1 = ps + (r + 32) * PP;
    float sum0 = 0.0f, sum1 = 0.0f;
    for (int t = 0; t < kBK; ++t) {
      const float w0 = p0[t], w1 = p1[t];
      sum0 += w0;
      sum1 += w1;
      const float* vr = vs + t * DPAD + c;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float y = vr[8 * j];
        acc[0][j] = fmaf(w0, y, acc[0][j]);
        acc[1][j] = fmaf(w1, y, acc[1][j]);
      }
    }
    l[0] = alpha[0] * l[0] + sum0;
    l[1] = alpha[1] * l[1] + sum1;
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = i0 + r + 32 * a;
    if (i >= Sq) continue;
    const float denom = l[a] == 0.0f ? 1.0f : l[a];
    T* o = out + b * so.b + h * so.h + i * so.s;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = c + 8 * j;
      if (d < D) store(o + d, acc[a][j] / denom);
    }
  }
}

template <typename T, int DPAD>
int launch_d(const T* q, const T* k, const T* v, T* out, int B, int Hq,
             int Hkv, int Sq, int Sk, int D, int causal, int window,
             float scale, Strides sq, Strides sk, Strides sv, Strides so,
             cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DPAD>();
  auto kernel = flash_attention_kernel<T, DPAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, out, Hq, Hkv, Sq, Sk,
                                            D, causal, window, scale, sq, sk,
                                            sv, so);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: the tensor cores -------------------------------------------------

constexpr int kMmaThreads = 256;  // eight warps, 16 query rows each

// warps sharing 16 query rows, each keeping DP / WN output columns: at
// D > 128 the float32 accumulators of all columns (the chunk's and the
// merged total) would not fit a thread's registers
template <int DP>
__host__ __device__ constexpr int col_parts() {
  return DP > 128 ? 2 : 1;
}

template <int DP>
__host__ __device__ constexpr int mma_rows() {
  return 16 * (kMmaThreads / 32) / col_parts<DP>();
}

// bf16 tiles: Q, then two K and two V tiles
template <int DP>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (mma_rows<DP>() + 4 * attn::kTile) * attn::pitch<DP>() *
         static_cast<int>(sizeof(attn::bf16));
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma(const attn::bf16* __restrict__ q,
                    const attn::bf16* __restrict__ k,
                    const attn::bf16* __restrict__ v,
                    attn::bf16* __restrict__ out, int Hq, int Hkv, int Sq,
                    int Sk, int D, int causal, int window, float scale,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    int vec) {
  using attn::bf16;
  using attn::kTile;
  constexpr int P = attn::pitch<DP>();
  constexpr int WN = col_parts<DP>();
  constexpr int BQ = mma_rows<DP>();
  constexpr int NT = DP / 8 / WN;  // n8 tiles of output per warp
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fa_smem);   // [BQ][P]
  bf16* kr = qs + BQ * P;                        // 2 x [kTile][P]
  bf16* vr = kr + 2 * kTile * P;                 // 2 x [kTile][P]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rt = warp / WN, part = warp % WN;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;

  // live keys of the tile: [k_begin, k_end)
  const int q_lo = Sk - Sq + i0;
  const int q_hi = Sk - Sq + min(i0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = max(0, min(Sk, q_hi + 1));
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  const int t0 = k_begin / kTile, t1 = (k_end + kTile - 1) / kTile;

  attn::zero_smem(fa_smem, mma_smem_bytes<DP>(), tid, kMmaThreads);
  __syncthreads();
  // tile t's K and V in kr[t % 2] and vr[t % 2]; nothing past t1
  auto load_tile = [&](int t) {
    if (t >= t1) return;
    const int j0 = t * kTile;
    attn::load_rows<DP, kTile, kMmaThreads>(
        kr + (t & 1) * kTile * P, D, vec, kb, [=](int r) -> const bf16* {
          return j0 + r < Sk ? kb + (j0 + r) * sk.s : nullptr;
        }, tid);
    attn::load_rows<DP, kTile, kMmaThreads>(
        vr + (t & 1) * kTile * P, D, vec, vb, [=](int r) -> const bf16* {
          return j0 + r < Sk ? vb + (j0 + r) * sv.s : nullptr;
        }, tid);
  };
  attn::load_rows<DP, BQ, kMmaThreads>(
      qs, D, vec, qb, [=](int r) -> const bf16* {
        return i0 + r < Sq ? qb + (i0 + r) * sq.s : nullptr;
      }, tid);
  load_tile(t0);
  attn::cp_async_commit();

  // the rows' total (m, l, acc) and the current chunk's partial
  float m[2], l[2], acc[NT][4], mc[2], lc[2], accc[NT][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = mc[hh] = attn::kMasked;
    l[hh] = lc[hh] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = accc[n][e] = 0.0f;

  const bf16* qw = qs + 16 * rt * P;
  const int qpos0 = Sk - Sq + i0 + 16 * rt;  // position of the warp's row 0
  for (int t = t0; t < t1; ++t) {
    attn::cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    load_tile(t + 1);  // into tile t - 1's place
    attn::cp_async_commit();
    const int j0 = t * kTile;
    // a tile masked for all the warp's rows would change nothing
    const bool none = (causal && j0 > qpos0 + 15) ||
                      (window > 0 && j0 + kTile - 1 <= qpos0 - window);
    if (!none) {
      float s[kTile / 8][4];
      attn::qk_tile<DP>(qw, kr + (t & 1) * kTile * P, s);
      const bf16* vs = vr + (t & 1) * kTile * P;
      auto live = [=](int r, int c) {
        const int kpos = j0 + c, qpos = qpos0 + r;
        return kpos < Sk && (!causal || kpos <= qpos) &&
               (window <= 0 || kpos > qpos - window);
      };
      // every key of the tile live for all 16 rows: no mask to evaluate
      const bool full = j0 + kTile <= Sk &&
                        (!causal || j0 + kTile - 1 <= qpos0) &&
                        (window <= 0 || j0 > qpos0 + 15 - window);
      if (full)
        attn::softmax_pv<DP, NT, true>(s, vs, part * NT, scale, live, mc,
                                       lc, accc);
      else
        attn::softmax_pv<DP, NT, false>(s, vs, part * NT, scale, live, mc,
                                        lc, accc);
    }
    if ((j0 + kTile) % attn::kChunk == 0 || t == t1 - 1) {
      // close the chunk: merge its partial into the total, start anew
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float e1, e2;
        attn::merge_scales(m[hh], mc[hh], e1, e2);
        l[hh] = attn::merge_value(l[hh], e1, lc[hh], e2);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            acc[n][e] = attn::merge_value(acc[n][e], e1, accc[n][e], e2);
            accc[n][e] = 0.0f;
          }
        mc[hh] = attn::kMasked;
        lc[hh] = 0.0f;
      }
    }
  }
  attn::cp_async_wait<0>();

  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + 16 * rt + (lane >> 2) + 8 * hh;
    if (i >= Sq) continue;
    bf16* o = out + b * so.b + h * so.h + i * so.s;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = (part * NT + n) * 8 + cq + e;
        if (d < D)
          o[d] = __float2bfloat16_rn(attn::finish(acc[n][2 * hh + e], l[hh]));
      }
  }
}

template <int DP>
int launch_mma_d(const attn::bf16* q, const attn::bf16* k,
                 const attn::bf16* v, attn::bf16* out, int B, int Hq,
                 int Hkv, int Sq, int Sk, int D, int causal, int window,
                 float scale, Strides sq, Strides sk, Strides sv,
                 Strides so, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DP>();
  auto kernel = flash_attention_mma<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = D % 8 == 0 && attn::aligned16(q, sq.s) &&
                  attn::aligned16(k, sk.s) && attn::aligned16(v, sv.s) &&
                  sq.b % 8 == 0 && sq.h % 8 == 0 && sk.b % 8 == 0 &&
                  sk.h % 8 == 0 && sv.b % 8 == 0 && sv.h % 8 == 0;
  const dim3 grid((Sq + mma_rows<DP>() - 1) / mma_rows<DP>(), Hq, B);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(q, k, v, out, Hq, Hkv, Sq,
                                               Sk, D, causal, window, scale,
                                               sq, sk, sv, so, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const attn::bf16* q, const attn::bf16* k, const attn::bf16* v,
               attn::bf16* out, int B, int Hq, int Hkv, int Sq, int Sk,
               int D, int causal, int window, float scale, Strides sq,
               Strides sk, Strides sv, Strides so, cudaStream_t s) {
  switch (attn::padded_dim(D)) {
    case 16:
      return launch_mma_d<16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                              window, scale, sq, sk, sv, so, s);
    case 32:
      return launch_mma_d<32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                              window, scale, sq, sk, sv, so, s);
    case 64:
      return launch_mma_d<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                              window, scale, sq, sk, sv, so, s);
    case 128:
      return launch_mma_d<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                               window, scale, sq, sk, sv, so, s);
    case 160:
      return launch_mma_d<160>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                               window, scale, sq, sk, sv, so, s);
    default:
      return launch_mma_d<256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                               window, scale, sq, sk, sv, so, s);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int B, int Hq,
           int Hkv, int Sq, int Sk, int D, int causal, int window,
           float scale, const long long* st_q, const long long* st_k,
           const long long* st_v, const long long* st_o, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || Sk < 0 ||
      B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{st_q[0], st_q[1], st_q[2]};
  const Strides sk{st_k[0], st_k[1], st_k[2]};
  const Strides sv{st_v[0], st_v[1], st_v[2]};
  const Strides so{st_o[0], st_o[1], st_o[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, attn::bf16>::value) {
    return launch_mma(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, window,
                      scale, sq, sk, sv, so, s);
  } else {
    if (D <= 32)
      return launch_d<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                             window, scale, sq, sk, sv, so, s);
    if (D <= 64)
      return launch_d<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                             window, scale, sq, sk, sv, so, s);
    if (D <= 128)
      return launch_d<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                              window, scale, sq, sk, sv, so, s);
    return launch_d<T, 256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                            window, scale, sq, sk, sv, so, s);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D,
                                   int causal, int window, float scale,
                                   const long long* st_q,
                                   const long long* st_k,
                                   const long long* st_v,
                                   const long long* st_o, void* stream) {
  return launch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, window,
                       scale, st_q, st_k, st_v, st_o, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v,
                                    __nv_bfloat16* out, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int D,
                                    int causal, int window, float scale,
                                    const long long* st_q,
                                    const long long* st_k,
                                    const long long* st_v,
                                    const long long* st_o, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                               window, scale, st_q, st_k, st_v, st_o,
                               stream);
}
