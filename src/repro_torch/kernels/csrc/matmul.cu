// Matrix product out = x @ y with float32 accumulation: the Hopper port of
// the Pallas kernel src/repro/kernels/matmul.py:matmul (pallas_call at
// :46), in two kernels, one per dtype.
//
// What it computes. x is [M, K], y is [K, N], both float32 or both bf16,
// each read through its own element strides (so a transposed view such as
// the matrix app's x.T, a layer of a stacked [L, K, N] parameter, or the
// tied head's [V, d].T needs no copy); out is a dense row-major [M, N] of
// the same type. Every output element is the sum over k of x[m, k] *
// y[k, n], accumulated in float32, then stored once (bf16: rounded to
// nearest even, as torch's .to(bfloat16) does).
//
// ---- float32 (matmul_f32): the matrix application's MM stage ----
//
// Bound on this card. 2*M*N*K float32 operations against
// (M*K + K*N + M*N) elements moved: at the matrix app's n = 344..496
// squares that is 81-244 MFLOP against 1.4-3.0 MB, so the operations
// bound (67 TFLOP/s without the tensor cores) rules at every app shape,
// 1.2-3.6 us, about three times the bytes bound; a launch costs about as
// much. At larger squares the operations bound rules further.
//
// Design. A simple and exact kernel, IEEE float32 throughout (no TF32):
// each 256-thread block owns a 64 x 64 output tile, the tiles numbered
// along one grid dimension so that any row count launches; each thread
// keeps a 4 x 4 micro-tile of float32 accumulators in registers; the K
// loop stages
// 16-deep slabs of both operands in shared memory (the x slab stored
// k-major so the inner loop reads four consecutive rows), loading along
// whichever dimension of each operand has unit stride so the loads
// coalesce. Bounds checks mask the ragged edges with zeros, so no padded
// copies are made, as the TPU kernel makes them. Each accumulator sums its
// K products in ascending k with fmaf. Products of small integers and
// their partial sums below 2^24 are exact in float32 in any order, so the
// matrix app's integer x @ x.T equals any other float32 product bit for
// bit. The file is built with --fmad=false, so the CUDA-core code's one
// fused multiply-add is the explicit fmaf.
//
// ---- bf16 (matmul_bf16): every weight product of the model stack ----
//
// Bound on this card. Decode (M = 8) reads each weight once: 117 MB for
// llama3-8b's FFN products, 0.035 ms at 3.35 TB/s, against 0.9 GFLOP.
// Prefill at M = 656 does 77 GFLOP, 0.078 ms at the 989 TFLOP/s of the
// bf16 tensor cores, against the same bytes. So decode is bound by bytes
// and prefill by tensor-core operations.
//
// Design. Tensor cores fed by an asynchronous ring. A block owns a
// [64 * WG, 64 * NI] output tile: WG consumer warpgroups (64 rows each)
// run wgmma.mma_async.m64n64k16 (bf16 in, float32 accumulators in
// registers), NI of them per 16-deep k step; one producer warp keeps a
// ring of S stages of dynamic shared memory filled, each stage an x tile
// [64 * WG, 64 k] and NI y sub-tiles [64 n, 64 k], with full and empty
// mbarrier pairs. The producer loads an operand by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, hardware zero fill past the
// ragged M, N and K edges) when its base is 16-byte aligned and it
// has a unit stride and a 16-byte multiple one; otherwise its 32 lanes
// stage the tile element by element into the same swizzled layout (a
// 2-byte-aligned row, such as a 514-byte stride, is too narrow for
// cp.async's 4-, 8- and 16-byte copies) and fence it for the async proxy.
// x is held K-major. y is held as the model stores it: K-major for a
// transposed view (the tied head [V, d].T), MN-major for a [K, N] layer
// view (the transpose bit of wgmma, which bf16 allows). At decode one
// warpgroup owns the rows and a stage loads only x's real rows (the rest
// of the tile is zeroed once). One width n = 64 serves every shape: on
// the H100, n = 32 or 16 (which launch 2-4x the blocks) came within about
// 5% of it at the decode shapes, faster by a few percent at some N <= 4096
// ones, slower by up to a third at N = 14336, since a long K chain of
// dependent wgmmas, not the block count, bounds those products (PERF.md
// §6). Prefill takes two warpgroups and up
// to four instructions per step (256 columns). Blocks walk the output in
// groups of 16 row tiles so that a weight panel is read from device
// memory about once per group. Tensor maps are encoded per launch on the
// host (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint,
// so the library needs no -lcuda) and passed as __grid_constant__.
//
// Exactness: rows independent of the row count. The tile plan
// (kernels/matmul.py:tile_plan) takes the B layout from y's strides; M
// chooses only WG and NI. So every output
// element is the sum of the same m64n64k16 instructions, with the same operand
// sources (both from shared memory) and layouts, over the same 16-deep K
// chunks in ascending k into one float32 accumulator. No split-K, no
// stream-K, no atomics. Zero-filled rows, columns and k positions add
// exact zeros. The TMA and thread-staged paths write the same bytes into
// shared memory, so they give the same bits.
//
// C interface (loaded with ctypes): matmul_f32 takes device pointers x,
// y, out, the sizes M, N, K, the element strides of x (along M, along K)
// and of y (along K, along N), and the CUDA stream; matmul_bf16 takes the
// same and, before the stream, the tile plan (NI, WG, whether y is held
// K-major) and a flag that stages both operands by threads. Both
// return the cudaError_t of the launch (0 = success) and launch
// asynchronously.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMicro = 4;

__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ out, int M, int N, int K, long long sxm,
              long long sxk, long long syk, long long syn) {
  __shared__ float xs[kBK][kBM + 4];  // k-major: xs[k][m]
  __shared__ float ys[kBK][kBN + 4];  // ys[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3 of the tile
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3 of the tile
  // one grid dimension, N tiles fastest: any row count launches (gridDim.y
  // stops at 65535 tiles, and the norms' row means pass millions of rows)
  const int tiles_n = (N + kBN - 1) / kBN;
  const int m0 = static_cast<int>(blockIdx.x / tiles_n) * kBM;
  const int n0 = static_cast<int>(blockIdx.x % tiles_n) * kBN;
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
                       ? x[gm * sxm + gk * sxk]
                       : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int nn = y_n_fast ? e % kBN : e / kBK;
      const int kk = y_n_fast ? e / kBN : e % kBK;
      const int gk = k0 + kk, gn = n0 + nn;
      ys[kk][nn] = (gk < K && gn < N)
                       ? y[gk * syk + gn * syn]
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
      if (gn < N) out[static_cast<long long>(gm) * N + gn] = acc[i][j];
    }
  }
}

}  // namespace


namespace {

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int kTBK = 64;   // K per stage: one 128-byte row of bf16
constexpr int kX = 64;     // n of every wgmma: 64 columns, 128 bytes
constexpr int kGroupM = 16;  // row tiles per group of the raster

// Shared memory of one tile configuration: S stages of an x tile
// [64 * WG, 64] and NI y sub-tiles [64, 64], every tile a multiple of 1024
// bytes (the 128-byte swizzle's period), then the mbarriers.
template <int WG, int NI>
struct Tile {
  static constexpr int kBM = 64 * WG;
  static constexpr int kBN = kX * NI;
  static constexpr int kABytes = kBM * kTBK * 2;
  static constexpr int kBSub = kX * kTBK * 2;
  static constexpr int kBBytes = NI * kBSub;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // one warpgroup: two blocks on an SM; two: one block with a deep ring
  static constexpr int kBudget = WG == 1 ? 110 * 1024 : 200 * 1024;
  static constexpr int kMaxStages = WG == 1 ? 16 : 8;
  static constexpr int kStages = kBudget / kStageBytes < kMaxStages
                                     ? kBudget / kStageBytes
                                     : kMaxStages;
  static constexpr int kSmemBytes =
      kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + 1024 to align
  static constexpr int kThreads = WG * 128 + 32;       // + the producer
  static_assert(kStages >= 2, "the ring needs two stages");
};

// The operands and sizes, for the thread-staged path and the epilogue.
struct Args {
  const uint16_t* x;
  const uint16_t* y;
  __nv_bfloat16* out;
  long long sxm, sxk, syk, syn;
  int M, N, K;
  int x_tma, y_tma;
  int x_rows;  // rows of x a stage loads; the tile's rows past it stay 0
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 128-byte TMA swizzle as the hardware applies it to a shared-memory
// byte address: the 16-byte chunk index (bits 4-6) XOR the 128-byte row
// index (bits 7-9).
__device__ __forceinline__ uint32_t swizzle(uint32_t a) {
  return a ^ (((a >> 7) & 7) << 4);
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (16-byte units), layout
// 1 (128-byte swizzle). The stride offset steps 8 rows of 128 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of the given parity to complete. A wait that lasts
// 20 s traps, so that a fault in the ring ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 20000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t tx) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(tx)
      : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64, 64] += A[64, 16] (K-major) @ B[16, 64] (TB = 0: K-major, 1: MN-major)
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TB));
}

// The thread-staged path: the producer warp's 32 lanes write a tile into
// the swizzled layout TMA would give it, zeros past the edges.
__device__ void stage_x(unsigned char* tile, const Args& a, int m0, int k0,
                        int lane) {
  for (int e = lane; e < a.x_rows * kTBK; e += 32) {
    const int r = e / kTBK, k = e % kTBK;
    const int gm = m0 + r, gk = k0 + k;
    const uint16_t v = (gm < a.M && gk < a.K) ? a.x[gm * a.sxm + gk * a.sxk]
                                              : uint16_t(0);
    *reinterpret_cast<uint16_t*>(tile + swizzle(r * 128 + k * 2)) = v;
  }
}

template <int NI, bool BKM>
__device__ void stage_y(unsigned char* tile, const Args& a, int n0, int k0,
                        int lane) {
  constexpr int kSub = kX * kTBK;
  for (int e = lane; e < NI * kSub; e += 32) {
    const int j = e / kSub, rem = e % kSub;
    // K-major: rows n, 64 k each; MN-major: rows k, 64 n each
    const int n = BKM ? rem / kTBK : rem % kX;
    const int k = BKM ? rem % kTBK : rem / kX;
    const int gn = n0 + j * kX + n, gk = k0 + k;
    const uint16_t v = (gn < a.N && gk < a.K) ? a.y[gk * a.syk + gn * a.syn]
                                              : uint16_t(0);
    const uint32_t off = BKM ? swizzle(n * 128 + k * 2)
                             : swizzle(k * 128 + n * 2);
    *reinterpret_cast<uint16_t*>(tile + j * kSub * 2 + off) = v;
  }
}

__device__ __forceinline__ void store_pair(const Args& a, int row, int col,
                                           float v0, float v1) {
  if (row >= a.M) return;
  __nv_bfloat16* p = a.out + static_cast<long long>(row) * a.N + col;
  if (col + 1 < a.N && (a.N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < a.N) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < a.N) p[1] = __float2bfloat16_rn(v1);
  }
}

template <int WG, int NI, bool BKM>
__global__ void __launch_bounds__(Tile<WG, NI>::kThreads, 1)
    matmul_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap ymap,
                       const Args a) {
  using T = Tile<WG, NI>;
  constexpr int S = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + S * T::kStageBytes;  // full[S], empty[S]

  // grouped raster: kGroupM row tiles share each weight panel in turn
  const int tiles_m = (a.M + T::kBM - 1) / T::kBM;
  const int tiles_n = (a.N + T::kBN - 1) / T::kBN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * T::kBM;
  const int n0 = (in_group / group_m) * T::kBN;
  const int nk = (a.K + kTBK - 1) / kTBK;
  const bool by_threads = !(a.x_tma && a.y_tma);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (a.x_rows < T::kBM) {
    // rows past x_rows (past M at decode) are zero in every stage, once
    for (int s = 0; s < S; ++s) {
      uint4* rest = reinterpret_cast<uint4*>(gbase + s * T::kStageBytes +
                                             a.x_rows * 128);
      for (int i = tid; i < (T::kBM - a.x_rows) * 8; i += T::kThreads)
        rest[i] = make_uint4(0, 0, 0, 0);
    }
    fence_async_proxy();
  }
  __syncthreads();

  if (tid >= WG * 128) {
    // ---- producer warp: fill the ring ----
    const int lane = tid & 31;
    const uint32_t tx =
        (a.x_tma ? a.x_rows * 128 : 0) + (a.y_tma ? T::kBBytes : 0);
    int s = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(bars + 8 * (S + s), phase ^ 1);  // the stage is free
      const int k0 = kb * kTBK;
      const uint32_t sa = base + s * T::kStageBytes, sb = sa + T::kABytes;
      if (!a.x_tma) stage_x(gbase + (sa - base), a, m0, k0, lane);
      if (!a.y_tma) stage_y<NI, BKM>(gbase + (sb - base), a, n0, k0, lane);
      if (by_threads) fence_async_proxy();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_tx(bars + 8 * s, tx);
        if (a.x_tma) tma_load(sa, &xmap, bars + 8 * s, k0, m0);
        if (a.y_tma) {
          for (int j = 0; j < NI; ++j) {
            const int n = n0 + j * kX;
            if (BKM)
              tma_load(sb + j * T::kBSub, &ymap, bars + 8 * s, k0, n);
            else
              tma_load(sb + j * T::kBSub, &ymap, bars + 8 * s, n, k0);
          }
        }
      }
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma on the stages that have arrived ----
    const int wg = tid / 128;
    float acc[NI][kX / 2];
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int i = 0; i < kX / 2; ++i) acc[j][i] = 0.0f;
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(bars + 8 * s, phase);
      if (by_threads) fence_async_proxy();
      const uint32_t sa = base + s * T::kStageBytes + wg * 64 * 128;
      const uint32_t sb = base + s * T::kStageBytes + T::kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTBK / 16; ++kk) {  // ascending k
        // K-major: the next 16 k are 32 bytes along each row; MN-major:
        // 16 rows (2 KB) down, the one 64-column atom needing no leading
        // offset
        const uint64_t da = desc(sa + kk * 32, 16);
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const uint32_t sub = sb + j * T::kBSub;
          const uint64_t db = BKM ? desc(sub + kk * 32, 16)
                                  : desc(sub + kk * 2048, 1024);
          wgmma<BKM ? 0 : 1>(acc[j], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (kb > 0) mbar_arrive(bars + 8 * (S + prev));
      prev = s;
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();

    // accumulator layout of m64n64: warp w of the warpgroup holds rows
    // 16w + lane/4 (+8); register 4g + {0,1} (+{2,3}) columns
    // 8g + 2 (lane % 4) + {0, 1}
    const int lane = tid & 31;
    const int row = m0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int g = 0; g < kX / 8; ++g) {
        const int col = n0 + j * kX + g * 8 + (lane % 4) * 2;
        store_pair(a, row, col, acc[j][4 * g], acc[j][4 * g + 1]);
        store_pair(a, row + 8, col, acc[j][4 * g + 2], acc[j][4 * g + 3]);
      }
  }
}

// cuTensorMapEncodeTiled looked up at run time, without linking -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Whether TMA takes a 2-D bf16 operand: unit inner stride, 16-byte aligned
// base, outer stride a multiple of 16 bytes that does not overlap rows.
bool tma_ok(const void* p, long long inner_stride, long long outer_stride,
            long long inner, long long outer) {
  if (inner_stride != 1 || reinterpret_cast<uintptr_t>(p) % 16 != 0)
    return false;
  if (outer == 1) return true;
  return outer_stride >= inner && (outer_stride * 2) % 16 == 0 &&
         outer_stride * 2 < (1LL << 40);
}

// A 2-D map over [outer, inner] (inner contiguous) with a box [bo, 64],
// 128-byte swizzle.
int encode(CUtensorMap* map, const void* p, long long inner, long long outer,
           long long outer_stride, int bo) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (outer == 1) outer_stride = (inner + 7) / 8 * 8;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(outer_stride * 2)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(bo)};
  const cuuint32_t one[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(p), dims, strides, box, one,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int WG, int NI, bool BKM>
int run_bf16(Args a, bool force_threads, cudaStream_t stream) {
  using T = Tile<WG, NI>;
  CUtensorMap xmap, ymap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&ymap, 0, sizeof(ymap));
  a.x_tma = !force_threads && tma_ok(a.x, a.sxk, a.sxm, a.K, a.M);
  a.x_rows = a.M < T::kBM ? (a.M + 7) / 8 * 8 : T::kBM;
  a.y_tma = !force_threads &&
            (BKM ? tma_ok(a.y, a.syk, a.syn, a.K, a.N)
                 : tma_ok(a.y, a.syn, a.syk, a.N, a.K));
  int err = 0;
  if (a.x_tma) err = encode(&xmap, a.x, a.K, a.M, a.sxm, a.x_rows);
  if (err == 0 && a.y_tma)
    err = BKM ? encode(&ymap, a.y, a.K, a.N, a.syn, kX)
              : encode(&ymap, a.y, a.N, a.K, a.syk, kTBK);
  if (err != 0) return err;

  auto kernel = matmul_bf16_kernel<WG, NI, BKM>;
  static bool attr_set[64] = {};  // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) attr_set[dev] = true;
  }
  const long long blocks =
      static_cast<long long>((a.M + T::kBM - 1) / T::kBM) *
      ((a.N + T::kBN - 1) / T::kBN);
  kernel<<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes,
           stream>>>(xmap, ymap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matmul_f32(const float* x, const float* y, float* out, int M,
                          int N, int K, long long sxm, long long sxk,
                          long long syk, long long syn, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>((M + kBM - 1) / kBM) *
                           ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  matmul_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, y, out, M, N, K,
                                                       sxm, sxk, syk, syn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int matmul_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                           __nv_bfloat16* out, int M, int N, int K,
                           long long sxm, long long sxk, long long syk,
                           long long syn, int n_instr, int warpgroups,
                           int b_kmajor, int by_threads, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(M) * N * sizeof(__nv_bfloat16), st));
  const Args a{reinterpret_cast<const uint16_t*>(x),
               reinterpret_cast<const uint16_t*>(y),
               out, sxm, sxk, syk, syn, M, N, K, 0, 0, 0};
  const bool t = by_threads != 0;
  // the tile plans kernels/matmul.py:tile_plan chooses from
#define MM_CASE(WG, NI)                                   \
  if (warpgroups == WG && n_instr == NI)                  \
    return b_kmajor ? run_bf16<WG, NI, true>(a, t, st)    \
                    : run_bf16<WG, NI, false>(a, t, st);
  MM_CASE(1, 1) MM_CASE(2, 1) MM_CASE(2, 2) MM_CASE(2, 4)
#undef MM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
