// The bf16 attention arithmetic that flash_attention.cu and flash_decode.cu
// share, on the tensor cores (mma.sync.m16n8k16, bf16 in, float32
// accumulation). Both kernels include this file and call the same
// functions, so a query row goes through the same instructions in the same
// order in both, which is what makes the model's bf16 decode step equal
// its prefill of one more token bit for bit.
//
// The invariants, for one query row:
//  1. Same instruction. S = Q K^T and O += P V are mma.sync m16n8k16 in
//     both kernels, the k-steps in ascending d for Q K^T and in ascending
//     key position for P V. A warp owns 16 query rows; a row's result does
//     not depend on its row slot in the instruction, nor on the other
//     rows (checked on the card by the gpu test
//     test_cuda_decode_equals_attention_of_the_last_row).
//  2. Online-softmax tiles. One step is one tile of kTile key positions at
//     a multiple of kTile: the masked max (scores (q . k) * scale, masked
//     ones kMasked), p = 2^((s - m_new) log2 e) by the hardware's
//     ex2.approx (exp_p: 2^-22 of p plus the rounding of the product,
//     against the 8 instructions of expf; p is what both kernels share, not
//     a particular exp), the tile's sum of p in a fixed
//     order over the C fragments (each lane its 16 values as a tree, then
//     the quad (t0 + t1) + (t2 + t3)), l = alpha l + sum, and
//     acc *= alpha before the tile's products (qk_tile, softmax_pv). A
//     tile without a live key leaves m, l and acc as they are.
//  3. p precision. p goes into P V as two bf16 parts, hi = bf16(p) and
//     lo = bf16(p - hi), each through the instruction (hi first): p is kept
//     to about 2^-18 of itself (a single bf16 p would cost 2^-9). V is
//     bf16 already. The sum l takes p in float32.
//  4. Fixed key chunks. Every kChunk key positions a row's running state
//     is closed into a partial (m_c, l_c, acc_c), and the partials are
//     merged in ascending chunk order from (kMasked, 0, 0) by merge_scales
//     and merge_value:
//     m = max(m, m_c), x = x * expf(m_old - m) + x_c * expf(m_c - m) for l
//     and acc, no fused multiply-add. flash_attention merges inside its
//     key loop, flash_decode across blocks (one block per chunk). A chunk
//     without a live key merges as an exact no-op.
// Keys outside a tile's range are zeros in shared memory (never read),
// and masked keys weigh exactly nothing, so the two kernels may run
// different sets of masked tiles and chunks around a row's live keys.
//
// The plain versions (ref.py: ATTN_TILE, ATTN_CHUNK, _tile_step, _merge)
// repeat this order in float32 with p unrounded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace attn {

constexpr int kTile = 64;    // key positions per online-softmax step
constexpr int kChunk = 256;  // key positions per partial
constexpr float kMasked = -0.7f * FLT_MAX;
static_assert(kChunk % kTile == 0, "chunks hold whole tiles");

typedef __nv_bfloat16 bf16;

// Head dims run padded (with zeros) to one of these; both kernels pad a D
// the same way, so they take the same k-steps.
__host__ __device__ constexpr int padded_dim(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64
         : D <= 128 ? 128 : D <= 160 ? 160 : 256;
}

// Row pitch of a [rows][DP] bf16 tile in shared memory: 16 bytes of padding
// put the 8 rows of each ldmatrix phase on distinct banks.
template <int DP>
__host__ __device__ constexpr int pitch() { return DP + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) b (16 x 8, col), float32 accumulation
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                   uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Zero `bytes` (a multiple of 16) of shared memory from p.
__device__ __forceinline__ void zero_smem(void* p, int bytes, int tid,
                                          int nthreads) {
  uint4* w = static_cast<uint4*>(p);
  for (int i = tid; i < bytes / 16; i += nthreads)
    w[i] = make_uint4(0, 0, 0, 0);
}

// ROWS x D of a tile into dst ([ROWS][DP] at pitch DP + 8) by NTHREADS
// threads: row r from row_src(r), zeros where it returns nullptr. vec:
// 16-byte cp.async copies (D % 8 == 0 and every row 16-byte aligned);
// else plain loads and stores. Columns D..DP are left as they are (zeroed
// once by the kernel).
template <int DP, int ROWS, int NTHREADS, typename RowSrc>
__device__ __forceinline__ void load_rows(bf16* dst, int D, bool vec,
                                          const bf16* any, RowSrc row_src,
                                          int tid) {
  constexpr int P = pitch<DP>();
  constexpr int NCH = DP / 8;  // 16-byte chunks of a padded row
  if (vec) {
#pragma unroll
    for (int e0 = 0; e0 < ROWS * NCH; e0 += NTHREADS) {
      const int e = e0 + tid, r = e / NCH, c = e % NCH;
      if ((ROWS * NCH) % NTHREADS != 0 && e >= ROWS * NCH) break;
      if (c * 8 >= D) continue;
      const bf16* s = row_src(r);
      cp_async16(dst + r * P + c * 8, s ? s + c * 8 : any, s ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * D; e += NTHREADS) {
      const int r = e / D, d = e - r * D;
      const bf16* s = row_src(r);
      dst[r * P + d] = s ? s[d] : __float2bfloat16_rn(0.0f);
    }
  }
}

// p of a score x = s - m_new <= 0 (invariant 2)
__device__ __forceinline__ float exp_p(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);  // x in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// p = hi + lo, each a bf16 pair (invariant 3)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16x2(__fsub_rn(x, __low2float(h)), __fsub_rn(y, __high2float(h)));
}

// S = Q K^T of a warp's 16 query rows (qs, [16][DP] at pitch DP + 8) and
// one kTile-key tile (ks, [kTile][DP]): s[j] is the C fragment of keys
// 8 j .. 8 j + 7, the k-steps in ascending d.
template <int DP>
__device__ __forceinline__ void qk_tile(const bf16* qs, const bf16* ks,
                                        float (&s)[kTile / 8][4]) {
  constexpr int P = pitch<DP>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + kk * 16 +
                   (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < kTile / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * P +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[2 * jp], a, b[0], b[1]);
      mma(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// The rest of one online-softmax step (invariant 2) after qk_tile: the
// masked max, p, the tile's sum of p, the rescale, then acc += P V with
// the tile's V (vs, [kTile][DP] at pitch DP + 8). live(r, c): whether
// row r (0..15) sees key column c (0 .. kTile - 1); kFull: every row sees
// every key of the tile (live is not called). The warp keeps the state of
// its rows: lane t holds rows t / 4 (h = 0) and t / 4 + 8 (h = 1) in
// m[h], l[h], and the output columns of n8 tiles n0 .. n0 + NT - 1 in
// acc[n][2h], acc[n][2h + 1] (columns 8 (n0 + n) + 2 (t % 4) + {0, 1}).
// Every warp that shares the rows computes the same S, m and l; each adds
// P V into its own columns. A lane's 16 values of a row are reduced as a
// tree, (j, e) pairs first, then j pairs, for instruction-level
// parallelism: the max is exact in any order, the sum's order is fixed
// (ref.py:_tile_sum repeats it).
template <int DP, int NT, bool kFull, typename Live>
__device__ __forceinline__ void softmax_pv(float (&s)[kTile / 8][4],
                                           const bf16* vs, int n0,
                                           float scale, Live live,
                                           float (&m)[2], float (&l)[2],
                                           float (&acc)[NT][4]) {
  constexpr int P = pitch<DP>();
  constexpr int J = kTile / 8;
  const int lane = threadIdx.x & 31;
  const int r0 = lane >> 2, cq = (lane & 3) * 2;
  uint32_t bits[2] = {0, 0};
  float mx[2][J];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool lv = kFull || live(r0 + 8 * h, 8 * j + cq + e);
        bits[h] |= (lv ? 1u : 0u) << (2 * j + e);
        s[j][2 * h + e] = lv ? __fmul_rn(s[j][2 * h + e], scale) : kMasked;
      }
      mx[h][j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
    }
  float m_new[2], ps[2][J], alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int w = J / 2; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j)
        mx[h][j] = fmaxf(mx[h][2 * j], mx[h][2 * j + 1]);
    float x = fmaxf(mx[h][0], __shfl_xor_sync(0xffffffffu, mx[h][0], 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    m_new[h] = fmaxf(m[h], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s[j][2 * h + e] = (bits[h] >> (2 * j + e)) & 1u
                              ? exp_p(__fsub_rn(s[j][2 * h + e], m_new[h]))
                              : 0.0f;
      ps[h][j] = __fadd_rn(s[j][2 * h], s[j][2 * h + 1]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int w = J / 2; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j)
        ps[h][j] = __fadd_rn(ps[h][2 * j], ps[h][2 * j + 1]);
    float x = __fadd_rn(ps[h][0], __shfl_xor_sync(0xffffffffu, ps[h][0], 1));
    const float sum = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
    alpha[h] = expf(__fsub_rn(m[h], m_new[h]));
    l[h] = __fadd_rn(__fmul_rn(alpha[h], l[h]), sum);
    m[h] = m_new[h];
  }
  // acc *= alpha; skipped, bits unchanged, when every alpha of the warp is 1
  if (!__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * h] = __fmul_rn(acc[n][2 * h], alpha[h]);
        acc[n][2 * h + 1] = __fmul_rn(acc[n][2 * h + 1], alpha[h]);
      }
  }

  // acc += P V, k-steps in ascending key position, hi then lo
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
    const bf16* vrow =
        vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, vrow + (n0 + 2 * np) * 8 + (lane >> 4) * 8);
      mma(acc[2 * np], hi, b[0], b[1]);
      mma(acc[2 * np], lo, b[0], b[1]);
      mma(acc[2 * np + 1], hi, b[2], b[3]);
      mma(acc[2 * np + 1], lo, b[2], b[3]);
    }
    if (NT % 2) {
      uint32_t b[2];
      ldsm_x2_t(b, vrow + (n0 + NT - 1) * 8);
      mma(acc[NT - 1], hi, b[0], b[1]);
      mma(acc[NT - 1], lo, b[0], b[1]);
    }
  }
}

// Fold a chunk's partial (mc, and its l and acc through merge_value) into
// the running total (invariant 4): sets e1, e2 and m.
__device__ __forceinline__ void merge_scales(float& m, float mc, float& e1,
                                             float& e2) {
  const float mn = fmaxf(m, mc);
  e1 = expf(__fsub_rn(m, mn));
  e2 = expf(__fsub_rn(mc, mn));
  m = mn;
}

__device__ __forceinline__ float merge_value(float x, float e1, float xc,
                                             float e2) {
  return __fadd_rn(__fmul_rn(x, e1), __fmul_rn(xc, e2));
}

// acc / l, zeros for a row without a live key
__device__ __forceinline__ float finish(float acc, float l) {
  return __fdiv_rn(acc, l == 0.0f ? 1.0f : l);
}

// Whether a pointer and a row stride (in elements) allow 16-byte copies.
__host__ __device__ inline bool aligned16(const void* p, long long stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride % 8 == 0;
}

}  // namespace attn
