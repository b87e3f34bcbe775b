// RWKV-6 (Finch) WKV recurrence with data-dependent decay: the Hopper
// port of the Pallas kernel src/repro/kernels/rwkv6.py:rwkv6
// (pallas_call at :71).
//
// What it computes. r, k and w are [B, H, T, Dk], v is [B, H, T, Dv]
// (r, k, v float32 or bf16, the same for all three; w float32 in (0, 1)),
// u is [H, Dk] float32 and s0 an optional [B, H, Dk, Dv] float32 state
// (zeros when absent). Per (b, h), with state S [Dk, Dv]:
//
//     o_t[j] = sum_k r_t[k] * (S[k, j] + u[k] * (k_t[k] * v_t[j]))
//     S[k, j] = w_t[k] * S[k, j] + k_t[k] * v_t[j]
//
// o [B, H, T, Dv] comes back in the type of v (bf16 rounded to nearest
// even), S_T [B, H, Dk, Dv] in float32. Every operation rounds on its own
// (explicit _rn intrinsics, and the build adds --fmad=false): the state
// update is elementwise, so S_T equals the plain version
// (ref.py:rwkv6_plain) bit for bit.
//
// The order of o's sum over k, fixed for every T, B, H, chunk, column
// split and columns per thread: the k rows fall into four row groups of
// Dk / 4 consecutive rows, q = k / (Dk / 4); group q sums its terms
// (S[k, j] + u[k] * kv) * r_t[k] for its rows in ascending order into a
// float32 sum that starts at 0.0f, and the four sums p0..p3 add as
// (p0 + p1) + (p2 + p3). ref.py:rwkv6_ordered is this order in torch.
// Because no part of the order depends on T, prefill(S) followed by one
// step from its S_T gives the bits of prefill(S + 1).
//
// Layout. r, k, v, w and o are read and written through their element
// strides along b, h and t (the last dimension must have unit stride), so
// the model's [B, S, H, hd] projections pass as [B, H, S, hd] views with
// no copy; s0, sT and u are dense.
//
// Bound on this card. Per (b, h, t) the function needs 5 * Dk * Dv + 3 Dk
// + 2 Dv float operations: r_t^T S (a multiply and an add per state
// element), the bonus (sum_k r_t[k] u[k] k_t[k]) * v_t, and the update
// w * S + k^T v (two multiplies and an add per element), against
// (3 Dk + 2 Dv) elements moved. At rwkv6-1.6b's [8, 32, 2048, 64] the
// function's 10.9 GFLOP take 0.163 ms at the 67 TFLOP/s float32 peak
// against 0.121 ms for its 407 MB at 3.35 TB/s, so the operations bound
// rules. This kernel does 7 rounded operations per state element and step
// (kv, u * kv, S + ., * r, the sum's add, w * S, + kv), none of them a
// fused multiply-add, so its own floor is 7 Dk Dv B H T operations at half
// the peak (one per lane and clock): 0.449 ms at [8, 32, 2048, 64].
//
// What the design does about it. Every state element costs its 7
// operations, so the design keeps everything else off the float pipes:
// - Register tiles. Warp w of a block holds row group q = w mod 4 of a
//   column group of 16 C columns (C = 1 or 2 a lane). Lanes 0-15 hold
//   the group's first Dk / 8 rows, lanes 16-31 its last Dk / 8, each for C
//   columns, S in registers for all of T. A group's rows are consecutive,
//   so a lane's rows of r, k and w sit side by side in the staged step as
//   they came: one 16-byte shared load brings eight bf16 rows of r or k
//   (or four float rows of w), every lane of a half-warp reading the same
//   address, and the lane widens them to float32 in registers. A
//   broadcast load costs the shared pipe what any 16-byte load costs it,
//   so what lowers the shared pipe's share is fewer bytes a row (bf16 r
//   and k) and the C columns a lane reuses them for.
// - The sum's order across the half-warps. The second half continues the
//   first half's sum one step later: at step t lanes 0-15 add their rows'
//   terms of step t to 0.0f and hand the sum over by a shuffle, while
//   lanes 16-31 add theirs of step t - 1 to the sum handed over a step
//   before. No lane waits for another, and each group sums its rows in
//   ascending order as one chain. So a head needs twice the warps of one
//   lane a row group, which is what fills the card at few heads.
// - Partial sums through shared memory. The second half stores its
//   group's sum p_q for each step; a chunk later the block adds them as
//   (p0 + p1) + (p2 + p3) and writes o in whole rows.
// - Overlapped staging. Chunks of kChunk steps are copied with 16-byte
//   cp.async along the head dimension, two chunks ahead of the steps, into
//   a ring of kSlots steps that the two halves read in place, each at its
//   own step: no pass over the staged data. One barrier per chunk.
// - The plan. A lane takes two columns where that still leaves every
//   scheduler two warps, else one, and a head's column groups are cut into
//   blocks so that a batch with few heads still reaches every SM
//   (kernels/rwkv6.py:launch_plan, from B, H, Dv and the SM count). A plan
//   changes which thread holds a column, never a value.
// - The state. Each half-warp reads s0 and writes S_T a row of its 16 C
//   contiguous columns per instruction, straight to and from registers.
//   A decode step (T = 1) reads its one step straight from device memory
//   too, no staging ring, the first half's sum handed over at once.
//
// C interface (loaded with ctypes): rwkv6_f32 / rwkv6_bf16 take device
// pointers r, k, v, w, u, s0 (may be null), o, sT, the sizes B, H, T, Dk,
// Dv, a host pointer to 15 element strides (b, h, t of r, k, v, w and o,
// in that order), a host pointer to the plan (columns per lane, column
// groups per block, column blocks per head) and the CUDA stream; they
// return the cudaError_t of the launch (0 = success,
// cudaErrorInvalidValue for Dk not in {16, 32, 64}, Dv above 128 or a
// plan that does not cover Dv). The launch is asynchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;          // time steps per staged chunk
constexpr int kSlots = 4 * kChunk;  // steps of the ring (a power of 2): the
                                   // two halves' chunks and two in flight
constexpr int kGroups = 4;         // row groups, one a warp: q = k / (Dk / 4)
constexpr int kLanes = 16;         // lanes of a half-warp: columns of C
constexpr int kMaxDv = 128;
constexpr int kMaxGroups = 4;      // column groups a block may hold
// bits of the kernel's vec argument: staged rows by 16-byte cp.async, the
// state by C-float vector accesses
constexpr int kVecRows = 1;
constexpr int kVecState = 2;

struct Layout {
  long long s[5][3];  // (r, k, v, w, o) x (b, h, t) element strides
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest n groups of this thread's copies have landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// N floats at p as one access (p aligned to N floats).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 y = *reinterpret_cast<const float4*>(p);
    x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
  } else if constexpr (N == 2) {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x, x[1] = y.y;
  } else {
    x[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// Shared-memory geometry of one instantiation and block width.
template <int DK, typename T>
struct Geometry {
  static constexpr int KQ = DK / kGroups;  // rows of a group
  static constexpr int RL = KQ / 2;        // rows of a half-warp's lane
  int vb;    // columns of the block (16 C per column group)
  int step;  // bytes per staged step: r, k (T), w (float), v (T), padded
             // to 16 banks past a multiple of 32, so the two halves' v
             // loads (a step apart) fall in different banks
  __host__ __device__ explicit Geometry(int vb_)
      : vb(vb_),
        step(padded(2 * DK * static_cast<int>(sizeof(T)) + DK * 4 +
                    vb_ * static_cast<int>(sizeof(T)))) {}
  __host__ __device__ static int padded(int bytes) {
    const int words = (bytes + 15) / 16 * 4;
    return (words + (16 - words % 32 + 32) % 32) * 4;
  }
  __host__ __device__ size_t ring_bytes() const {
    return kSlots * static_cast<size_t>(step);
  }
  // the groups' sums of every step of the ring: [kSlots][kGroups][vb],
  // and one more slot where the first half's lanes put theirs, unread
  __host__ __device__ size_t part_bytes() const {
    return sizeof(float) * (kSlots + 1) * kGroups * static_cast<size_t>(vb);
  }
  __host__ __device__ size_t smem_bytes() const {
    return ring_bytes() + part_bytes();
  }
};

// N values of type T at p (aligned to their size, N * sizeof(T) a power of
// two up to 32 bytes), widened to float32: the widest shared loads that
// fit, bf16 widened by a shift.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
template <int N, typename T>
__device__ __forceinline__ void load_row(const unsigned char* p,
                                         float (&x)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (sizeof(T) == 4) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const float4 y = reinterpret_cast<const float4*>(p)[i];
        x[4 * i] = y.x, x[4 * i + 1] = y.y, x[4 * i + 2] = y.z,
        x[4 * i + 3] = y.w;
      }
    } else if constexpr (kBytes == 8) {
      const float2 y = *reinterpret_cast<const float2*>(p);
      x[0] = y.x, x[1] = y.y;
    } else {
      x[0] = *reinterpret_cast<const float*>(p);
    }
  } else {  // bf16
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const uint4 y = reinterpret_cast<const uint4*>(p)[i];
        const uint32_t w[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[8 * i + 2 * e] = bf16_lo(w[e]);
          x[8 * i + 2 * e + 1] = bf16_hi(w[e]);
        }
      }
    } else if constexpr (kBytes == 8) {
      const uint2 y = *reinterpret_cast<const uint2*>(p);
      x[0] = bf16_lo(y.x), x[1] = bf16_hi(y.x);
      x[2] = bf16_lo(y.y), x[3] = bf16_hi(y.y);
    } else if constexpr (kBytes == 4) {
      const uint32_t y = *reinterpret_cast<const uint32_t*>(p);
      x[0] = bf16_lo(y), x[1] = bf16_hi(y);
    } else {
      x[0] = bf16_lo(*reinterpret_cast<const uint16_t*>(p));
    }
  }
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <int DK, int C, typename T>
__global__ void __launch_bounds__(32 * kGroups * kMaxGroups, 1)
    rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ o, float* __restrict__ sT, int H, int Tn,
                 int Dv, Layout L, int vec) {
  using G = Geometry<DK, T>;
  constexpr int KQ = G::KQ, RL = G::RL;
  constexpr int kRK = DK * static_cast<int>(sizeof(T));  // bytes of r, k
  constexpr int kW = DK * 4;                              // bytes of w
  constexpr int isz = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];

  const int nt = blockDim.x;
  const G geo(nt / (32 * kGroups) * kLanes * C);
  const int vb = geo.vb;
  unsigned char* ring = smem;
  float* part = reinterpret_cast<float*>(smem + geo.ring_bytes());

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int c0 = blockIdx.y * vb;   // the block's first column
  const int nv = min(vb, Dv - c0);  // its columns inside Dv
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q = warp % kGroups;  // row group
  const int half = lane / kLanes;  // 0: the group's first rows, 1: last
  const int col = (warp / kGroups) * kLanes * C + (lane % kLanes) * C;
  const int row0 = half * RL;  // the lane's first row, within the group

  const T* rp = r + b * L.s[0][0] + h * L.s[0][1];
  const T* kp = k + b * L.s[1][0] + h * L.s[1][1];
  const T* vp = v + b * L.s[2][0] + h * L.s[2][1] + c0;
  const float* wp = w + b * L.s[3][0] + h * L.s[3][1];
  T* op = o + b * L.s[4][0] + h * L.s[4][1] + c0;
  const long long head = static_cast<long long>(bh) * DK * Dv + c0;
  const int chunks = (Tn + kChunk - 1) / kChunk;

  // stage chunk c's rows into its steps of the ring: 16-byte cp.async
  // pieces along the head dimension, or element by element when a row is
  // not 16-byte aligned (no kVecRows). A thread takes fixed pieces of a
  // step (r, k, w, then the block's v columns) for every step of the chunk.
  auto issue = [&](int c) {
    if (c >= chunks) {  // an empty group keeps the groups' count
      cp_async_commit();
      return;
    }
    const int t0 = c * kChunk;
    const int n = min(kChunk, Tn - t0);
    unsigned char* dst = ring + ((c * kChunk) & (kSlots - 1)) * geo.step;
    const int unit = (vec & kVecRows) ? 16 : 0;
    const int per = unit ? (2 * kRK + kW + nv * isz) / 16 : 3 * DK + nv;
    for (int e = tid; e < per; e += nt) {
      // the piece's source row, its byte offset there and in a raw step,
      // and its size
      const unsigned char* src;
      long long ts;  // bytes between steps
      int off, at, size;
      if (unit) {
        at = e * 16, off = at, size = 16;
      } else {
        const int f = e < 2 * DK ? e / DK : e < 3 * DK ? 2 : 3;
        off = e - (f < 3 ? f * DK : 3 * DK);
        size = f == 2 ? 4 : isz;
        at = (f < 2 ? f * kRK : f == 2 ? 2 * kRK : 2 * kRK + kW) +
             off * size;
        off *= size;
      }
      if (at < kRK) {
        src = reinterpret_cast<const unsigned char*>(rp);
        ts = L.s[0][2] * isz;
      } else if (at < 2 * kRK) {
        src = reinterpret_cast<const unsigned char*>(kp);
        ts = L.s[1][2] * isz;
        off -= unit ? kRK : 0;
      } else if (at < 2 * kRK + kW) {
        src = reinterpret_cast<const unsigned char*>(wp);
        ts = L.s[3][2] * 4;
        off -= unit ? 2 * kRK : 0;
      } else {
        src = reinterpret_cast<const unsigned char*>(vp);
        ts = L.s[2][2] * isz;
        off -= unit ? 2 * kRK + kW : 0;
      }
      src += off + t0 * ts;
      unsigned char* d = dst + at;
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        if (tt < n) {
          if (unit) {
            cp_async16(d, src);
          } else if (size == 4) {
            *reinterpret_cast<float*>(d) =
                *reinterpret_cast<const float*>(src);
          } else {
            *reinterpret_cast<T*>(d) = *reinterpret_cast<const T*>(src);
          }
        }
        src += ts;
        d += geo.step;
      }
    }
    cp_async_commit();
  };

  // o of chunk c from its groups' sums: (p0 + p1) + (p2 + p3), whole rows
  // of the block's columns
  auto reduce = [&](int c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, Tn - t0);
    const float* pb = part + (t0 & (kSlots - 1)) * kGroups * vb;
    const int j = tid % vb;
    if (j >= nv) return;
    for (int tt = tid / vb; tt < n; tt += nt / vb) {
      const float* pp = pb + tt * kGroups * vb + j;
      const float x = __fadd_rn(__fadd_rn(pp[0], pp[vb]),
                                __fadd_rn(pp[2 * vb], pp[3 * vb]));
      store(op + (t0 + tt) * L.s[4][2] + j, x);
    }
  };

  // S and u in registers: a row of the half-warp's 16 C columns per load
  const bool vec_state = (vec & kVecState) != 0;
  float uu[RL];
  float S[RL][C];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int kk = q * KQ + row0 + i;
    uu[i] = u[h * DK + kk];
    if (s0 != nullptr && vec_state && col < nv) {
      load_vec<C>(s0 + head + kk * Dv + col, S[i]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        S[i][c] = (s0 != nullptr && col + c < nv)
                      ? s0[head + kk * Dv + col + c]
                      : 0.0f;
      }
    }
  }
  // S_T straight from the registers, a row of 16 C columns per store
  auto store_state = [&]() {
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int kk = q * KQ + row0 + i;
      if (vec_state && col < nv) {
        store_vec<C>(sT + head + kk * Dv + col, S[i]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (col + c < nv) sT[head + kk * Dv + col + c] = S[i][c];
        }
      }
    }
  };

  if (Tn == 1) {
    // a decode step: its one step read straight from device memory (no
    // staging ring), the first half's sum handed over at once; the same
    // operations in the same order as the steps below
    float vj[C], term[RL][C], acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      vj[c] = col + c < nv ? to_float(vp[col + c]) : 0.0f;
      acc[c] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int kk = q * KQ + row0 + i;
      const float rr = to_float(rp[kk]), kr = to_float(kp[kk]), wr = wp[kk];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float kv = __fmul_rn(kr, vj[c]);
        term[i][c] =
            __fmul_rn(__fadd_rn(S[i][c], __fmul_rn(uu[i], kv)), rr);
        S[i][c] = __fadd_rn(__fmul_rn(wr, S[i][c]), kv);
        acc[c] = __fadd_rn(acc[c], term[i][c]);  // the first half's sum
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] = __shfl_sync(0xffffffffu, acc[c], lane % kLanes);
#pragma unroll
      for (int i = 0; i < RL; ++i) acc[c] = __fadd_rn(acc[c], term[i][c]);
    }
    if (half) store_vec<C>(part + q * vb + col, acc);
    __syncthreads();
    reduce(0);
    store_state();
    return;
  }

  issue(0);
  issue(1);

  // iteration g: the first half runs step g, the second half step g - 1;
  // blocks of kChunk iterations, chunk c's copies issued two blocks ahead
  float hand[C];  // the first half's sum of the step before, for lane + 16
#pragma unroll
  for (int cc = 0; cc < C; ++cc) hand[cc] = 0.0f;
  // the lane's rows of r, k and w, and its columns of v, in a staged step
  const int row_at = (q * KQ + row0) * isz;
  const int v_at = 2 * kRK + kW + col * isz;
  // guarded (a Flag): iteration 0 or Tn, where one half has no step
  auto step = [&](int g, auto guarded) {
    const int s = g - half;  // this lane's step
    const unsigned char* st = ring + (s & (kSlots - 1)) * geo.step;
    float acc[C];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) acc[cc] = half ? hand[cc] : 0.0f;
    if (!decltype(guarded)::value || (s >= 0 && s < Tn)) {
      float vj[C], rr[RL], kr[RL], wr[RL];
      load_row<C, T>(st + v_at, vj);
      load_row<RL, T>(st + row_at, rr);
      load_row<RL, T>(st + kRK + row_at, kr);
      load_row<RL, float>(st + 2 * kRK + (q * KQ + row0) * 4, wr);
#pragma unroll
      for (int i = 0; i < RL; ++i) {  // row q * KQ + row0 + i, ascending
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const float kv = __fmul_rn(kr[i], vj[cc]);
          const float term = __fmul_rn(
              __fadd_rn(S[i][cc], __fmul_rn(uu[i], kv)), rr[i]);
          acc[cc] = __fadd_rn(acc[cc], term);
          S[i][cc] = __fadd_rn(__fmul_rn(wr[i], S[i][cc]), kv);
        }
      }
      // the second half's sum is its group's p_q; the first half's goes
      // to the spare slot, so the store is one instruction for the warp
      store_vec<C>(part + (half ? (s & (kSlots - 1)) : kSlots) * kGroups * vb +
                       q * vb + col,
                   acc);
    }
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      hand[cc] = __shfl_sync(0xffffffffu, acc[cc], lane % kLanes);
    }
  };
  const int blocks = (Tn + kChunk) / kChunk;  // iterations 0 .. Tn
  for (int c = 0; c < blocks; ++c) {
    // chunk c landed (its copies were issued two blocks ago); the block is
    // done with chunk c - 2's steps and their sums are complete
    cp_async_wait<1>();
    __syncthreads();
    if (c >= 2) reduce(c - 2);
    issue(c + 2);
    int g = c * kChunk;
    const int g_end = min((c + 1) * kChunk, Tn + 1);
    if (g == 0) step(g++, Flag<true>{});
    // both halves have a step: no branch in the loop
#pragma unroll 2
    for (; g < min(g_end, Tn); ++g) step(g, Flag<false>{});
    if (g == Tn && g < g_end) step(g, Flag<true>{});
  }
  __syncthreads();
  for (int c = max(blocks - 2, 0); c < chunks; ++c) reduce(c);
  store_state();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int DK, int C, typename T>
int launch_dk_c(const T* r, const T* k, const T* v, const float* w,
                const float* u, const float* s0, T* o, float* sT, int B,
                int H, int Tn, int Dv, const Layout& L, int groups,
                int splits, cudaStream_t stream) {
  const Geometry<DK, T> geo(groups * kLanes * C);
  const size_t smem = geo.smem_bytes();
  auto kernel = rwkv6_kernel<DK, C, T>;
  static size_t opted = 0;  // dynamic shared memory already allowed
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  // 16-byte copies need every row start 16-byte aligned (the strides of
  // the dimensions longer than 1 too) and each row piece (r, k, w, the
  // block's v columns) a whole number of 16 bytes
  const int isz = static_cast<int>(sizeof(T));
  bool rows = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
              (Dv * isz) % 16 == 0 && (geo.vb * isz) % 16 == 0;
  const int len[3] = {B, H, Tn};
  for (int a = 0; a < 4; ++a) {  // r, k, v, w; o is written, not staged
    const int esz = a == 3 ? 4 : isz;
    for (int c = 0; c < 3; ++c)
      rows = rows && (len[c] == 1 || (L.s[a][c] * esz) % 16 == 0);
  }
  // s0 and S_T in C-float pieces along j
  const bool state = Dv % 4 == 0 && (s0 == nullptr || aligned16(s0)) &&
                     aligned16(sT);
  dim3 grid(B * H, splits);
  kernel<<<grid, groups * kGroups * 32, smem, stream>>>(
      r, k, v, w, u, s0, o, sT, H, Tn, Dv, L,
      (rows ? kVecRows : 0) | (state ? kVecState : 0));
  return static_cast<int>(cudaGetLastError());
}

template <int DK, typename T>
int launch_dk(const T* r, const T* k, const T* v, const float* w,
              const float* u, const float* s0, T* o, float* sT, int B, int H,
              int Tn, int Dv, const Layout& L, int cols, int groups,
              int splits, cudaStream_t stream) {
  switch (cols) {
    case 1:
      return launch_dk_c<DK, 1, T>(r, k, v, w, u, s0, o, sT, B, H, Tn, Dv,
                                   L, groups, splits, stream);
    case 2:
      return launch_dk_c<DK, 2, T>(r, k, v, w, u, s0, o, sT, B, H, Tn, Dv,
                                   L, groups, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* o, float* sT, int B,
           int H, int Tn, int Dk, int Dv, const long long* strides,
           const int* plan, cudaStream_t stream) {
  const int cols = plan[0], groups = plan[1], splits = plan[2];
  if ((cols != 1 && cols != 2) || B <= 0 || H <= 0 ||
      Tn <= 0 || Dv <= 0 || Dv > kMaxDv || groups <= 0 || splits <= 0 ||
      groups > kMaxGroups || groups * kLanes * cols * splits < Dv ||
      groups * kLanes * cols * (splits - 1) >= Dv) {
    return cudaErrorInvalidValue;
  }
  Layout L;
  for (int a = 0; a < 5; ++a)
    for (int c = 0; c < 3; ++c) L.s[a][c] = strides[a * 3 + c];
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (Dk) {
    case 16:
      return launch_dk<16, T>(rp, kp, vp, w, u, s0, op, sT, B, H, Tn, Dv, L,
                              cols, groups, splits, stream);
    case 32:
      return launch_dk<32, T>(rp, kp, vp, w, u, s0, op, sT, B, H, Tn, Dv, L,
                              cols, groups, splits, stream);
    case 64:
      return launch_dk<64, T>(rp, kp, vp, w, u, s0, op, sT, B, H, Tn, Dv, L,
                              cols, groups, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rwkv6_f32(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const float* s0,
                         void* o, float* sT, int B, int H, int T, int Dk,
                         int Dv, const long long* strides, const int* plan,
                         cudaStream_t stream) {
  return launch<float>(r, k, v, w, u, s0, o, sT, B, H, T, Dk, Dv, strides,
                       plan, stream);
}

extern "C" int rwkv6_bf16(const void* r, const void* k, const void* v,
                          const float* w, const float* u, const float* s0,
                          void* o, float* sT, int B, int H, int T, int Dk,
                          int Dv, const long long* strides, const int* plan,
                          cudaStream_t stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, o, sT, B, H, T, Dk, Dv,
                               strides, plan, stream);
}
