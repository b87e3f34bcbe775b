// RWKV-6 backward: the gradients of the WKV recurrence (csrc/rwkv6.cu) by
// its reverse-time recurrence. The Pallas kernel it backs,
// src/repro/kernels/rwkv6.py:rwkv6 (pallas_call at :71), has no backward:
// the reference trains through XLA's autodiff of its lax.scan oracle
// (src/repro/kernels/ref.py:rwkv6_ref).
//
// What it computes. r, k, w are [B, H, T, Dk], v and do (the gradient of
// o) [B, H, T, Dv] (r, k, v, do float32 or bf16, the same for all four; w
// float32), u [H, Dk] float32, s0 and dsT (the gradient of S_T) optional
// [B, H, Dk, Dv] float32 (zeros when absent). Per (b, h), with the states
// S_{t-1} of the forward and dS = dsT, going from t = T - 1 down to 0:
//
//     dr_t[i] = sum_j ((S_{t-1}[i, j] + u[i] * (k_t[i] * v_t[j])) * do_t[j])
//     dkv     = dS[i, j] + (r_t[i] * u[i]) * do_t[j]
//     dk_t[i] = sum_j dkv[i, j] * v_t[j]
//     dv_t[j] = sum_i dkv[i, j] * k_t[i]
//     dw_t[i] = sum_j dS[i, j] * S_{t-1}[i, j]
//     du[i]  += (r_t[i] * k_t[i]) * (sum_j do_t[j] * v_t[j])
//     dS      = w_t[i] * dS[i, j] + r_t[i] * do_t[j]
//
// dr, dk, dv come back in the type of r (bf16 rounded to nearest even), dw
// in float32, ds0 = dS after t = 0, and du_part [B, H, Dk] per (b, h): the
// caller adds them over b in ascending order (kernels/ops.py, one add a
// row). Every operation rounds on its own (_rn intrinsics, --fmad=false).
// The states are recomputed forward from s0 by the forward kernel's own
// update, w * S + k * v, elementwise: they are the forward's S bit for bit,
// never inverted (w_t is exactly 0 in float32 once the decay logit passes
// ~8.6). dS is elementwise too, so every term of every sum is the plain
// version's (ref.py:rwkv6_backward_plain) bit for bit; only the orders of
// the sums differ. Those orders are fixed, whatever B, H, T, the SM count
// or the plan (ref.py:rwkv6_backward_ordered takes them in torch):
// - dr, dk, dw (sums over j): the columns, Dv padded with zero columns to a
//   multiple of four, fall into tiles of four; each tile's four terms add
//   in ascending j, starting from the first term, and the tiles' sums add
//   in ascending tile order, starting from tile 0.
// - dv (a sum over i): the same with tiles of four rows.
// - sum_j do_t[j] v_t[j]: ascending j < Dv from the first term.
// - du: each (b, h) starts at 0.0f and adds its step terms from t = T - 1
//   down to 0.
//
// Bound on this card. The gradients need, per (b, h, t), 14 Dk Dv + 11 Dk
// + 4 Dv float operations (kernels/cost.py:rwkv6_backward) against
// (4 Dk + 3 Dv) elements moved: at rwkv6-1.6b's training shape
// [4, 32, 1024, 64] bf16, 7.64 GFLOP, 0.114 ms at the 67 TFLOP/s float32
// peak, against 187 MB, 0.056 ms at 3.35 TB/s, so the operations bound
// rules. None of them may be a fused multiply-add (each rounds on its
// own), so one takes a lane a clock; and this design does about 23 a
// step and state element (18 elementwise: the state recomputed twice, 3
// each; dr's terms 4, dkv's 2, dk's, dv's and dw's products 1 each, the dS
// update 3; the tile sums' adds about 5; cost.rwkv6_backward_kernel counts
// them): 12.4 G, 0.37 ms at one a lane and clock on 132 SMs at 1.98 GHz,
// before any load, shuffle or barrier.
//
// What the design does about it. A head is a dependent chain of T steps
// over Dk Dv state elements; only the elements run side by side, and a
// chunk's tile sums need every thread's partials, so the design keeps
// every element's operations issuing and takes everything else off them:
// - Register tiles, twice the warps of a 4 x 4 tile. One block per (b, h)
//   of (Dk / 2) x ceil(Dv4 / (4 NC)) threads (512 at 64 x 64: 16 warps an
//   SM). Thread (rp, g) holds state rows 2 rp, 2 rp + 1 of the NC column
//   tiles from g NC (4 columns each); the lanes of a warp are consecutive
//   row pairs of one column group, so a step's r, k, w come as 8-byte
//   loads side by side and v, do as one broadcast 16-byte load a tile.
// - A chunk's states on chip. Pass 1 walks forward and writes the state
//   every C steps to the workspace [B, H, nC - 1, Dk, DvP], each warp's
//   pieces side by side (one 16-byte store a lane, written once and read
//   once); pass 2 walks the chunks backward, recomputes a chunk's C states
//   S_{t-1} from its checkpoint into registers (C x 2 x 4 NC = 64 floats a
//   thread: C = 8 with one tile a thread, C = 4 with two, the plans of
//   kernels/rwkv6.py:backward_plan) and runs the chunk's steps in reverse
//   on them. No state goes back to device memory in pass 2.
// - Asynchronous staging. r, k, w, v and do come as they are (bf16 stays
//   bf16) by 16-byte cp.async (element by element when a row is not
//   16-byte aligned). Pass 1 keeps three of a four-chunk ring in flight
//   and widens to float32 in registers; pass 2 copies the next chunk and
//   its checkpoint while this one computes, and widens each chunk once
//   into a float32 chunk. A last chunk cut short is filled with steps that
//   change nothing (w = 1, r = -0, k = v = do = 0: dS + (-0) 0 is dS bit
//   for bit), so every chunk runs C steps with no branch a step.
// - The sums off the chain. A step leaves each thread's tile sums in
//   shared memory: dr, dk, dw one 8-byte store (its two rows) a tile, the
//   two row pairs of a row quad side by side, and dv's tiles of four rows
//   made by one shuffle between the two row pairs (lane ^ 1: the even
//   pair's rows 4m, 4m + 1, then the odd pair's 4m + 2, 4m + 3, in order).
//   After a chunk the threads take every output's chain at once: dr, dk,
//   dw a row quad of one step a thread (a 16-byte load a tile, the tiles in
//   ascending order), dv a column of one step (rows of kVRow floats, odd:
//   no bank conflicts either way), outputs stored 8 or 16 bytes at a time
//   where aligned. The dot do . v of each step is one ascending chain,
//   taken by lane 0 of a warp from the widened chunk while the others
//   recompute; du adds (r k) dot, t descending, a chunk later, from r k
//   products kept in shared memory, its loads first. Two barriers a chunk
//   in pass 2, one in pass 1.
//
// What still bounds it (tools/rwkv6_bwd_phases.py times builds of this
// file with one phase taken out; H100 80GB HBM3, PERF.md §6): the steps
// in reverse, near an instruction a clock on each scheduler, take about
// 0.39 of the time; pass 1 0.17; the chunk's chains and their barrier
// 0.15, held by their loads' latency whatever the chains' arrangement; the
// dots 0.06; du next to nothing.
//
// C interface (loaded with ctypes): rwkv6_bwd_f32 / rwkv6_bwd_bf16 take
// device pointers r, k, v, w, u, do, s0 (may be null), dsT (may be null),
// dr, dk, dv, dw, du_part, ds0, the workspace and its size in floats, the
// sizes B, H, T, Dk, Dv, a host pointer to 27 element strides (b, h, t of
// r, k, v, w, do, dr, dk, dv and dw, in that order; the last dimension of
// each has unit stride), a host pointer to the plan (tiles a thread NC,
// chunk C: (1, 8), or (2, 4) at Dk = 64; kernels/rwkv6.py:backward_plan)
// and the CUDA stream; they return the cudaError_t of the launch (0 =
// success; cudaErrorInvalidValue for Dk not in {16, 32, 64}, Dv outside
// 1..128, a plan not compiled or whose block passes 512 threads or the
// shared memory, or a workspace smaller than workspace_floats', which
// kernels/rwkv6.py:workspace_floats mirrors). The launch is asynchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 2;           // state rows of a thread
constexpr int kTile = 4;           // columns of a tile; rows of dv's tiles
constexpr int kMaxThreads = 512;   // a block's threads (the launch bound)
constexpr int kSlots1 = 4;         // pass 1's ring: chunks in flight + 1
constexpr int kMaxDv = 128;
constexpr int kVRow = kMaxDv + 1;  // floats between dv's tile-sum rows (odd)
constexpr long long kMaxSmem = 232448;

// a staged step's fields, in their order there
constexpr int kR = 0, kK = 1, kW = 2, kV = 3, kDo = 4;

struct Layout {
  long long s[9][3];  // (r, k, v, w, do, dr, dk, dv, dw) x (b, h, t)
};

// The block's geometry for Dk, Dv and a plan (NC, C), on the host and
// passed to the kernel (kernels/rwkv6.py:backward_geometry mirrors it).
struct Geo {
  int nct;     // column tiles of Dv4 (Dv padded to a multiple of 4)
  int DvP;     // columns the threads hold: whole groups of NC tiles
  int nt;      // threads
  int PV;      // float offset of dv's tile sums (after dr's, dk's, dw's)
  int LW;      // bytes of one staged step as it came (bf16 stays bf16)
  int SF;      // floats of one widened step: r, k, w (Dk each), v, do (DvP)
  int off[5];  // byte offsets of r, k, w, v, do in a staged step
  long long slot;  // bytes of a staged chunk
  long long u;     // bytes of pass 1's ring, later pass 2's tile sums
  long long smem;  // dynamic shared memory
};

Geo geometry(int Dk, int Dv, int NC, int C, int isz) {
  Geo g;
  const int Dv4 = (Dv + kTile - 1) / kTile * kTile;
  g.nct = Dv4 / kTile;
  const int groups = (g.nct + NC - 1) / NC;
  g.DvP = groups * NC * kTile;
  g.nt = Dk / kRows * groups;
  g.PV = 3 * g.nct * C * Dk;
  g.SF = 3 * Dk + 2 * g.DvP;
  const int bytes[5] = {Dk * isz, Dk * isz, Dk * 4, g.DvP * isz, g.DvP * isz};
  int o = 0;
  for (int f = 0; f < 5; ++f) {
    g.off[f] = o;
    o += (bytes[f] + 15) / 16 * 16;
  }
  g.LW = o;
  g.slot = static_cast<long long>(C) * g.LW;
  const long long sums = 4LL * (g.PV + C * (Dk / kTile) * kVRow);
  const long long ring1 = kSlots1 * g.slot;
  g.u = ((sums > ring1 ? sums : ring1) + 15) / 16 * 16;
  // pass 2's two staged chunks, its widened chunk, the checkpoint tiles,
  // two chunks' dots and r_t k_t
  g.smem = g.u + 2 * g.slot + 4LL * C * g.SF + 4LL * Dk * g.DvP +
           8LL * C * (1 + Dk);
  return g;
}

// workspace floats: the checkpoints before chunks 0 .. nC - 2
long long workspace_floats(int B, int H, int Tn, int Dk, int C,
                           const Geo& g) {
  return static_cast<long long>(B) * H * ((Tn + C - 1) / C - 1) * Dk * g.DvP;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the float32 values of the bf16 bits in the low and high halves of x
__device__ __forceinline__ float bf_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}
// one, two and four consecutive elements widened to float32 (p aligned to
// their size): bf16 by its bits, from one 2-, 4- or 8-byte load
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf_lo(*reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned x = *reinterpret_cast<const unsigned*>(p);
  return make_float2(bf_lo(x), bf_hi(x));
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(x.x), bf_hi(x.x), bf_lo(x.y), bf_hi(x.y));
}
// two floats as one 8-byte shared store, four as one 16-byte store (a
// store of a float2 or float4 built from scalars may be split)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<unsigned long long*>(p) =
      static_cast<unsigned long long>(__float_as_uint(b)) << 32 |
      __float_as_uint(a);
}
__device__ __forceinline__ void store4_shared(float* p, float4 x) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(s),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}
// a += y, lane by lane
__device__ __forceinline__ void add4(float4& a, float4 y) {
  a.x = __fadd_rn(a.x, y.x), a.y = __fadd_rn(a.y, y.y);
  a.z = __fadd_rn(a.z, y.z), a.w = __fadd_rn(a.w, y.w);
}
// four outputs side by side: one 8- or 16-byte store where aligned
__device__ __forceinline__ void store4(float* p, float4 x) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    __stcg(reinterpret_cast<float4*>(p), x);
  } else {
    p[0] = x.x, p[1] = x.y, p[2] = x.z, p[3] = x.w;
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const unsigned lo =
      __bfloat16_as_ushort(__float2bfloat16_rn(x.x)) |
      static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(x.y)))
          << 16;
  const unsigned hi =
      __bfloat16_as_ushort(__float2bfloat16_rn(x.z)) |
      static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(x.w)))
          << 16;
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    __stcg(reinterpret_cast<uint2*>(p), make_uint2(lo, hi));
  } else {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
    q[0] = lo & 0xffffu, q[1] = lo >> 16, q[2] = hi & 0xffffu, q[3] = hi >> 16;
  }
}
// a thread's N columns (whole tiles) of a staged row
template <int N, typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N / kTile; ++q) {
    const float4 y = load4(p + q * kTile);
    x[q * kTile] = y.x, x[q * kTile + 1] = y.y;
    x[q * kTile + 2] = y.z, x[q * kTile + 3] = y.w;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest n groups of this thread's copies have landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// S = w * S + k * v (the forward kernel's update) for rows i0, i0 + 1 and
// the N columns from j0, from a step's k, w and v rows
template <int N, typename KT>
__device__ __forceinline__ void advance(float (&S)[kRows][N], const KT* kk,
                                        const float* ww, const KT* vv,
                                        int i0, int j0) {
  const float2 k2 = load2(kk + i0), w2 = load2(ww + i0);
  const float kr[kRows] = {k2.x, k2.y}, wr[kRows] = {w2.x, w2.y};
  float vj[N];
  load_cols<N>(vv + j0, vj);
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      S[a][c] = __fadd_rn(__fmul_rn(wr[a], S[a][c]), __fmul_rn(kr[a], vj[c]));
    }
  }
}

template <typename T, int DK, int NC, int C>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const T* __restrict__ dout,
                     const float* __restrict__ s0,
                     const float* __restrict__ dsT, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ ds0, float* __restrict__ work, int H,
                     int Tn, int Dv, Layout L, Geo g, int vec) {
  constexpr int RP = DK / kRows;    // row pairs: the threads of a group
  constexpr int NCOL = NC * kTile;  // columns of a thread
  constexpr int NRT = DK / kTile;   // dv's row tiles
  constexpr int isz = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rp = tid % RP, grp = tid / RP;
  const int i0 = rp * kRows, j0 = grp * NCOL;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nC = (Tn + C - 1) / C;
  const long long plane = static_cast<long long>(DK) * g.DvP;
  const long long state = static_cast<long long>(bh) * DK * Dv;
  // checkpoint c's piece (row a, tile x) of this thread: 16 bytes at
  // ck + c * plane + ((a * NC + x) * nt + tid) * 4, a warp's side by side
  float* ck = work + static_cast<long long>(bh) * (nC - 1) * plane;
  // lanes of this warp that the block has (a shuffle's mask)
  const int live = min(32, nt - (tid & ~31));
  const unsigned mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;

  // pass 2's tile sums: dr, dk, dw [field][tile][step][Dk], then dv
  // [step][row tile][kVRow] (every offset of a chain's terms fixed at
  // compile time)
  float* part = reinterpret_cast<float*>(smem);
  unsigned char* ring1 = smem;                    // pass 1: kSlots1 chunks
  unsigned char* ring2 = smem + g.u;              // pass 2: two chunks
  float* fst = reinterpret_cast<float*>(ring2 + 2 * g.slot);  // [C][SF]
  float* cks = fst + C * g.SF;    // this thread's checkpoint pieces
  float* dots = cks + DK * g.DvP;  // [2][C]
  float* rks = dots + 2 * C;       // [2][C][Dk]: r_t k_t, du's terms

  // zero columns past Dv stay zero in every staged row
  for (long long e = tid; e < g.smem / 16; e += nt) {
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // copy steps t0 .. t0 + n - 1 of the fields (r and do only when all)
  // into a staged chunk: 16-byte cp.async pieces when vec, else element by
  // element; a thread's first piece of a field takes one division, the
  // next ones a step of fixed size
  auto stage = [&](unsigned char* dst, int t0, int n, bool all) {
    auto field = [&](auto fc, const void* base) {
      constexpr int f = decltype(fc)::value;
      constexpr int a = f == kW ? 3 : f == kV ? 2 : f;  // its Layout row
      constexpr int es = f == kW ? 4 : isz;
      const long long ts = L.s[a][2] * es;  // bytes between steps
      const unsigned char* from =
          static_cast<const unsigned char*>(base) +
          (b * L.s[a][0] + h * L.s[a][1]) * es + t0 * ts;
      unsigned char* to = dst + g.off[f];
      const int unit = vec ? 16 : es;
      // pieces of a row (a shift for r, k, w)
      const int per = f < kV ? (vec ? DK * es / 16 : DK) : Dv * es / unit;
      int s = tid / per, p = tid - s * per;
      const int ds = nt / per, dp = nt - ds * per;
      while (s < n) {
        const unsigned char* x = from + s * ts + p * unit;
        unsigned char* y = to + s * g.LW + p * unit;
        if (vec) {
          cp_async16(y, x);
        } else if (es == 4) {
          *reinterpret_cast<unsigned*>(y) =
              *reinterpret_cast<const unsigned*>(x);
        } else {
          *reinterpret_cast<unsigned short*>(y) =
              *reinterpret_cast<const unsigned short*>(x);
        }
        p += dp, s += ds;
        if (p >= per) p -= per, ++s;
      }
    };
    if (all) field(std::integral_constant<int, kR>{}, r);
    field(std::integral_constant<int, kK>{}, k);
    field(std::integral_constant<int, kW>{}, w);
    field(std::integral_constant<int, kV>{}, v);
    if (all) field(std::integral_constant<int, kDo>{}, dout);
  };

  auto load_state = [&](const float* src, float (&X)[kRows][NCOL]) {
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        X[a][c] = (src != nullptr && j0 + c < Dv)
                      ? src[state + (i0 + a) * Dv + j0 + c]
                      : 0.0f;
      }
    }
  };

  // -- pass 1: the checkpoints ---------------------------------------------
  float S[kRows][NCOL];
  load_state(s0, S);
#pragma unroll 1
  for (int p = 0; p < kSlots1 - 1; ++p) {
    if (p < nC - 1) stage(ring1 + p * g.slot, p * C, C, false);
    cp_async_commit();
  }
#pragma unroll 1
  for (int c = 0; c < nC - 1; ++c) {
    cp_async_wait<kSlots1 - 2>();
    __syncthreads();  // chunk c landed; the chunk before it is read
    const int p = c + kSlots1 - 1;
    if (p < nC - 1) stage(ring1 + (p % kSlots1) * g.slot, p * C, C, false);
    cp_async_commit();
    // checkpoint c: the state before step c * C
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int x = 0; x < NC; ++x) {
        __stcg(reinterpret_cast<float4*>(ck + c * plane +
                                         ((a * NC + x) * nt + tid) * kTile),
               make_float4(S[a][x * kTile], S[a][x * kTile + 1],
                           S[a][x * kTile + 2], S[a][x * kTile + 3]));
      }
    }
    const unsigned char* slot = ring1 + (c % kSlots1) * g.slot;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const unsigned char* st = slot + s * g.LW;
      advance<NCOL>(S, reinterpret_cast<const T*>(st + g.off[kK]),
                    reinterpret_cast<const float*>(st + g.off[kW]),
                    reinterpret_cast<const T*>(st + g.off[kV]), i0, j0);
    }
  }

  // -- pass 2: the chunks in reverse ---------------------------------------
  float dS[kRows][NCOL];
  load_state(dsT, dS);
  const float uu[kRows] = {u[h * DK + i0], u[h * DK + i0 + 1]};
  float du_acc[2] = {0.0f, 0.0f};  // du of rows tid and tid + nt
  const int FV = 3 * DK, FD = 3 * DK + g.DvP;  // v and do in a widened step

  // widen a staged chunk's n steps into the float32 chunk, four elements
  // a thread a turn (columns past Dv zeros, as staged). The steps past n
  // (a last chunk cut short) become steps that change nothing: w = 1, r =
  // -0, k = v = do = 0, so dS = 1 * dS + (-0) * 0 is dS bit for bit (-0
  // too), and the chunk always runs its C steps
  auto widen = [&](const unsigned char* slot, int n) {
    const int Q = g.SF / kTile;  // quads of a step
    int s = tid / Q, q = tid - s * Q;
    const int ds = nt / Q, dq = nt - ds * Q;
    while (s < C) {
      const int e = q * kTile;
      const unsigned char* st = slot + s * g.LW;
      float4 y;
      if (s >= n) {
        const float z = e < DK ? -0.0f : e >= 2 * DK && e < FV ? 1.0f : 0.0f;
        y = make_float4(z, z, z, z);
      } else if (e < 2 * DK) {
        y = load4(reinterpret_cast<const T*>(st + (e < DK ? g.off[kR]
                                                          : g.off[kK])) +
                  (e & (DK - 1)));
      } else if (e < FV) {
        y = load4(reinterpret_cast<const float*>(st + g.off[kW]) + e - 2 * DK);
      } else if (e < FD) {
        y = load4(reinterpret_cast<const T*>(st + g.off[kV]) + e - FV);
      } else {
        y = load4(reinterpret_cast<const T*>(st + g.off[kDo]) + e - FD);
      }
      store4_shared(fst + s * g.SF + e, y);
      q += dq, s += ds;
      if (q >= Q) q -= Q, ++s;
    }
  };

  // one chain a step, by lane 0 of a warp from the last one down, from
  // the widened chunk: sum_j do_t[j] v_t[j], ascending j from the first
  // term
  auto dots_of = [&](int n, float* out) {
    if ((tid & 31) != 0) return;
    const int nw = (nt + 31) >> 5;
    for (int s = nw - 1 - (tid >> 5); s < n; s += nw) {
      const float* vv = fst + s * g.SF + FV;
      const float* dd = fst + s * g.SF + FD;
      float acc = __fmul_rn(dd[0], vv[0]);
      int j = 1;
      for (; j < kTile && j < Dv; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(dd[j], vv[j]));
      }
#pragma unroll 4
      for (; j + kTile <= Dv; j += kTile) {
        const float4 x = load4(dd + j), y = load4(vv + j);
        acc = __fadd_rn(acc, __fmul_rn(x.x, y.x));
        acc = __fadd_rn(acc, __fmul_rn(x.y, y.y));
        acc = __fadd_rn(acc, __fmul_rn(x.z, y.z));
        acc = __fadd_rn(acc, __fmul_rn(x.w, y.w));
      }
      for (; j < Dv; ++j) acc = __fadd_rn(acc, __fmul_rn(dd[j], vv[j]));
      out[s] = acc;
    }
  };

  // a chunk's outputs from its tile sums, every output element of every
  // step one chain, tiles in ascending order: dr, dk, dw a thread four rows
  // of one step (a 16-byte load a tile: the two row pairs of a row quad
  // stored side by side), dv a thread one column of one step
  auto finish = [&](int t0, int n) {
    constexpr int RQ = DK / kTile;  // row quads
    const int NQ = 3 * RQ * C;      // (step, field, quad) chains of 4 rows
    const int total = NQ + Dv * C;
    for (int e = tid; e < total; e += nt) {
      if (e < NQ) {
        const int m = e % RQ, fs = e / RQ, f = fs % 3, s = fs / 3;
        const float* p = part + (f * g.nct * C + s) * DK + m * kTile;
        float4 acc = load4(p);
        for (int x = 1; x < g.nct; ++x) add4(acc, load4(p + x * C * DK));
        if (s < n) {
          const long long t = t0 + s;
          const int i = m * kTile;
          if (f == 0) {
            store4(dr + b * L.s[5][0] + h * L.s[5][1] + t * L.s[5][2] + i,
                   acc);
          } else if (f == 1) {
            store4(dk + b * L.s[6][0] + h * L.s[6][1] + t * L.s[6][2] + i,
                   acc);
          } else {
            store4(dw + b * L.s[8][0] + h * L.s[8][1] + t * L.s[8][2] + i,
                   acc);
          }
        }
      } else {
        const int s = (e - NQ) / Dv, j = e - NQ - s * Dv;
        const float* p = part + g.PV + s * NRT * kVRow + j;
        float acc = p[0];
#pragma unroll
        for (int x = 1; x < NRT; ++x) acc = __fadd_rn(acc, p[x * kVRow]);
        if (s < n) {
          store(dv + b * L.s[7][0] + h * L.s[7][1] +
                    (t0 + s) * L.s[7][2] + j,
                acc);
        }
      }
    }
  };

  // r_t k_t of a staged chunk's n steps into rks, one product a thread a
  // turn (du's terms, added a chunk later by du_of)
  auto rk_of = [&](const unsigned char* slot, int n, float* rks) {
    for (int e = tid; e < n * DK; e += nt) {
      const int s = e / DK, i = e & (DK - 1);
      const unsigned char* st = slot + s * g.LW;
      rks[e] = __fmul_rn(load1(reinterpret_cast<const T*>(st + g.off[kR]) + i),
                         load1(reinterpret_cast<const T*>(st + g.off[kK]) + i));
    }
  };
  // du's step terms of a chunk, t descending (rows tid and tid + nt)
  auto du_of = [&](int n, const float* rks, const float* dot) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * nt;
      if (i < DK) {  // the chunk's loads first, then the adds
        float x[C];
#pragma unroll
        for (int s = 0; s < C; ++s) {
          x[s] = __fmul_rn(rks[(s < n ? s : 0) * DK + i], dot[s < n ? s : 0]);
        }
#pragma unroll
        for (int s = C - 1; s >= 0; --s) {
          if (s < n) du_acc[e] = __fadd_rn(du_acc[e], x[s]);
        }
      }
    }
  };

  stage(ring2, (nC - 1) * C, Tn - (nC - 1) * C, true);
  cp_async_commit();
#pragma unroll 1
  for (int q = 0; q < nC; ++q) {
    const int c = nC - 1 - q, t0 = c * C, n = min(C, Tn - t0);
    const unsigned char* slot = ring2 + (q & 1) * g.slot;
    cp_async_wait<0>();
    __syncthreads();  // this chunk and its checkpoint landed; the last
                      // chunk's tile sums are in
    if (q > 0) finish(t0 + C, min(C, Tn - t0 - C));
    rk_of(slot, n, rks + (q & 1) * C * DK);
    widen(slot, n);
    __syncthreads();  // the widened chunk is in; the tile sums and the
                      // last chunk's slot are free
    dots_of(n, dots + (q & 1) * C);
    if (q > 0) {
      du_of(min(C, Tn - t0 - C), rks + ((q - 1) & 1) * C * DK,
            dots + ((q - 1) & 1) * C);
    }

    // the chunk's states S_{t-1}, t = t0 .. t0 + n - 1, in registers (the
    // last chunk's first from pass 1's S, the others' from the checkpoint)
    if (q > 0) {
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
#pragma unroll
        for (int x = 0; x < NC; ++x) {
          const float4 y = *reinterpret_cast<const float4*>(
              cks + ((a * NC + x) * nt + tid) * kTile);
          S[a][x * kTile] = y.x, S[a][x * kTile + 1] = y.y;
          S[a][x * kTile + 2] = y.z, S[a][x * kTile + 3] = y.w;
        }
      }
    }
    float Sp[C][kRows][NCOL];
#pragma unroll
    for (int s = 0; s < C; ++s) {
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
#pragma unroll
        for (int x = 0; x < NCOL; ++x) Sp[s][a][x] = S[a][x];
      }
      if (s + 1 < C) {
        const float* st = fst + s * g.SF;
        advance<NCOL>(S, st + DK, st + 2 * DK, st + FV, i0, j0);
      }
    }
    if (q + 1 < nC) {  // the next chunk's checkpoint pieces and steps
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
#pragma unroll
        for (int x = 0; x < NC; ++x) {
          const int o = ((a * NC + x) * nt + tid) * kTile;
          cp_async16(cks + o, ck + (c - 1) * plane + o);
        }
      }
      stage(ring2 + ((q + 1) & 1) * g.slot, t0 - C, C, true);
      cp_async_commit();
    }

    // the steps in reverse: dS, and the tile sums of each step
#pragma unroll
    for (int s = C - 1; s >= 0; --s) {
      const float* st = fst + s * g.SF;
      const float2 r2 = load2(st + i0), k2 = load2(st + DK + i0);
      const float2 w2 = load2(st + 2 * DK + i0);
      const float rr[kRows] = {r2.x, r2.y}, kr[kRows] = {k2.x, k2.y};
      const float wr[kRows] = {w2.x, w2.y};
      float vj[NCOL], dj[NCOL];
      load_cols<NCOL>(st + FV + j0, vj);
      load_cols<NCOL>(st + FD + j0, dj);
      float pr[NC][kRows], pk[NC][kRows], pw[NC][kRows], tv[kRows][NCOL];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const float ru = __fmul_rn(rr[a], uu[a]);
#pragma unroll
        for (int c2 = 0; c2 < NCOL; ++c2) {
          const float kv = __fmul_rn(kr[a], vj[c2]);
          const float tr = __fmul_rn(
              __fadd_rn(Sp[s][a][c2], __fmul_rn(uu[a], kv)), dj[c2]);
          const float dkv = __fadd_rn(dS[a][c2], __fmul_rn(ru, dj[c2]));
          const float tk = __fmul_rn(dkv, vj[c2]);
          const float tw = __fmul_rn(dS[a][c2], Sp[s][a][c2]);
          tv[a][c2] = __fmul_rn(dkv, kr[a]);
          dS[a][c2] = __fadd_rn(__fmul_rn(wr[a], dS[a][c2]),
                                __fmul_rn(rr[a], dj[c2]));
          const int x = c2 / kTile;
          if (c2 % kTile == 0) {
            pr[x][a] = tr, pk[x][a] = tk, pw[x][a] = tw;
          } else {
            pr[x][a] = __fadd_rn(pr[x][a], tr);
            pk[x][a] = __fadd_rn(pk[x][a], tk);
            pw[x][a] = __fadd_rn(pw[x][a], tw);
          }
        }
      }
      // dv's tiles of four rows: the even row pair's two rows, then the
      // odd pair's (lane ^ 1), which holds the tile's sum
#pragma unroll
      for (int c2 = 0; c2 < NCOL; ++c2) {
        const float lo =
            __shfl_xor_sync(mask, __fadd_rn(tv[0][c2], tv[1][c2]), 1);
        tv[0][c2] = __fadd_rn(__fadd_rn(lo, tv[0][c2]), tv[1][c2]);
      }
#pragma unroll
      for (int x = 0; x < NC; ++x) {
        const int ct = grp * NC + x;
        if (ct < g.nct) {
          float* ps = part + (ct * C + s) * DK + i0;
          store2(ps, pr[x][0], pr[x][1]);
          store2(ps + g.nct * C * DK, pk[x][0], pk[x][1]);
          store2(ps + 2 * g.nct * C * DK, pw[x][0], pw[x][1]);
          if (rp & 1) {
            float* pv = part + g.PV + (s * NRT + (rp >> 1)) * kVRow +
                        ct * kTile;
#pragma unroll
            for (int c2 = 0; c2 < kTile; ++c2) {
              pv[c2] = tv[0][x * kTile + c2];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  finish(0, min(C, Tn));
  du_of(min(C, Tn), rks + ((nC - 1) & 1) * C * DK, dots + ((nC - 1) & 1) * C);

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
#pragma unroll
    for (int c2 = 0; c2 < NCOL; ++c2) {
      if (j0 + c2 < Dv) ds0[state + (i0 + a) * Dv + j0 + c2] = dS[a][c2];
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = tid + e * nt;
    if (i < DK) du_part[static_cast<long long>(bh) * DK + i] = du_acc[e];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int DK, int NC, int C>
int launch_plan(const T* r, const T* k, const T* v, const float* w,
                const float* u, const T* dout, const float* s0,
                const float* dsT, T* dr, T* dk, T* dv, float* dw,
                float* du_part, float* ds0, float* work, int B, int H,
                int Tn, int Dv, const Layout& L, const Geo& g, int vec,
                cudaStream_t stream) {
  auto kernel = rwkv6_bwd_kernel<T, DK, NC, C>;
  static long long opted = 0;  // dynamic shared memory already allowed
  if (g.smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = g.smem;
  }
  kernel<<<B * H, g.nt, g.smem, stream>>>(r, k, v, w, u, dout, s0, dsT, dr,
                                          dk, dv, dw, du_part, ds0, work, H,
                                          Tn, Dv, L, g, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const void* dout, const float* s0,
           const float* dsT, void* dr, void* dk, void* dv, float* dw,
           float* du_part, float* ds0, float* work, long long work_floats,
           int B, int H, int Tn, int Dk, int Dv, const long long* strides,
           const int* plan, cudaStream_t stream) {
  const int NC = plan[0], C = plan[1];
  if (B <= 0 || H <= 0 || Tn <= 0 || (Dk != 16 && Dk != 32 && Dk != 64) ||
      Dv <= 0 || Dv > kMaxDv || B * static_cast<long long>(H) > 2147483647LL ||
      !((NC == 1 && C == 8) || (NC == 2 && C == 4 && Dk == 64))) {
    return cudaErrorInvalidValue;
  }
  const int isz = static_cast<int>(sizeof(T));
  const Geo g = geometry(Dk, Dv, NC, C, isz);
  if (g.nt > kMaxThreads || g.smem > kMaxSmem ||
      work_floats < workspace_floats(B, H, Tn, Dk, C, g)) {
    return cudaErrorInvalidValue;
  }
  Layout L;
  for (int a = 0; a < 9; ++a)
    for (int c = 0; c < 3; ++c) L.s[a][c] = strides[a * 3 + c];
  // 16-byte copies need every staged row start 16-byte aligned (the
  // strides of the dimensions longer than 1 too) and each row a whole
  // number of 16 bytes
  bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
             aligned16(dout) && (Dv * isz) % 16 == 0 && (Dk * isz) % 16 == 0;
  const int len[3] = {B, H, Tn};
  for (int a = 0; a < 5; ++a) {  // r, k, v, w, do
    const int esz = a == 3 ? 4 : isz;
    for (int c = 0; c < 3; ++c)
      vec = vec && (len[c] == 1 || (L.s[a][c] * esz) % 16 == 0);
  }
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dp = static_cast<const T*>(dout);
  T* drp = static_cast<T*>(dr);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
#define RWKV6_BWD_LAUNCH(DK, NC_, C_)                                       \
  launch_plan<T, DK, NC_, C_>(rp, kp, vp, w, u, dp, s0, dsT, drp, dkp, dvp, \
                              dw, du_part, ds0, work, B, H, Tn, Dv, L, g,   \
                              vec ? 1 : 0, stream)
  switch (Dk) {
    case 16:
      return RWKV6_BWD_LAUNCH(16, 1, 8);
    case 32:
      return RWKV6_BWD_LAUNCH(32, 1, 8);
    default:
      return NC == 1 ? RWKV6_BWD_LAUNCH(64, 1, 8)
                     : RWKV6_BWD_LAUNCH(64, 2, 4);
  }
#undef RWKV6_BWD_LAUNCH
}

}  // namespace

extern "C" int rwkv6_bwd_f32(const void* r, const void* k, const void* v,
                             const float* w, const float* u, const void* dout,
                             const float* s0, const float* dsT, void* dr,
                             void* dk, void* dv, float* dw, float* du_part,
                             float* ds0, float* work, long long work_floats,
                             int B, int H, int T, int Dk, int Dv,
                             const long long* strides, const int* plan,
                             cudaStream_t stream) {
  return launch<float>(r, k, v, w, u, dout, s0, dsT, dr, dk, dv, dw, du_part,
                       ds0, work, work_floats, B, H, T, Dk, Dv, strides, plan,
                       stream);
}

extern "C" int rwkv6_bwd_bf16(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const void* dout, const float* s0,
                              const float* dsT, void* dr, void* dk, void* dv,
                              float* dw, float* du_part, float* ds0,
                              float* work, long long work_floats, int B,
                              int H, int T, int Dk, int Dv,
                              const long long* strides, const int* plan,
                              cudaStream_t stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, dout, s0, dsT, dr, dk, dv, dw,
                               du_part, ds0, work, work_floats, B, H, T, Dk,
                               Dv, strides, plan, stream);
}
