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
// (ref.py:rwkv6_plain) bit for bit; o sums over k in the order below, the
// plain version in torch's reduction order, so o agrees to the float32
// rounding of that sum (one bf16 ulp after a bf16 store).
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
// (3 Dk + 2 Dv) elements moved. This kernel does 7 * Dk * Dv (it forms
// S + u * kv for every element before the product with r). At
// rwkv6-1.6b's [8, 32, 2048, 64] the function's 10.9 GFLOP take 0.163 ms
// at the 67 TFLOP/s float32 peak against 0.121 ms for its 407 MB at
// 3.35 TB/s, so the operations bound rules. The peak counts a fused
// multiply-add as two operations; built with --fmad=false no multiply
// and add fuse, so half the peak is the most this kernel can reach.
//
// What the design does about it. The TPU kernel walks time blocks in a
// sequential grid with S in VMEM scratch. Here one block owns one (b, h)
// for all of T, and column S[:, j] belongs to kSplit = 4 neighbouring
// threads, thread q holding rows q, q + 4, q + 8, ... (Dk / 4 floats in
// registers, never written back until the end). The block stages kChunk
// time steps of r, k, w and v in shared memory with coalesced loads, then
// every thread runs those steps from shared memory with no further
// synchronisation: the four threads of a column read four neighbouring
// words of r_t, k_t, w_t and u (broadcast to the warp's eight columns, no
// bank conflicts), each sums its rows in ascending order, and two warp
// shuffles add the four partial sums as (p0 + p1) + (p2 + p3). Splitting
// the column gives four times the warps to hide shared-memory latency and
// a quarter of the serial chain per step. Grid: B * H blocks of 4 Dv
// threads (Dv rounded up to 8 columns).
//
// C interface (loaded with ctypes): rwkv6_f32 / rwkv6_bf16 take device
// pointers r, k, v, w, u, s0 (may be null), o, sT, the sizes B, H, T, Dk,
// Dv, a host pointer to 15 element strides (b, h, t of r, k, v, w and o,
// in that order) and the CUDA stream; they return the cudaError_t of the
// launch (0 = success, cudaErrorInvalidValue for Dk not in {16, 32, 64}
// or Dv above 128). The launch is asynchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;  // time steps staged in shared memory at once
constexpr int kSplit = 4;   // threads sharing one state column
constexpr int kMaxDk = 64;
constexpr int kMaxDv = 128;

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

template <int DK, typename T>
__global__ void rwkv6_kernel(const T* __restrict__ r,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ w,
                             const float* __restrict__ u,
                             const float* __restrict__ s0,
                             T* __restrict__ o, float* __restrict__ sT,
                             int H, int Tn, int Dv, Layout L) {
  constexpr int KQ = DK / kSplit;  // state rows per thread
  __shared__ float rs[kChunk][DK];
  __shared__ float ks[kChunk][DK];
  __shared__ float ws[kChunk][DK];
  __shared__ float vs[kChunk][kMaxDv];
  __shared__ float us[DK];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int j = tid / kSplit;  // the state column this thread works on
  const int q = tid % kSplit;  // its rows: q, q + kSplit, q + 2 kSplit, ...
  const bool owner = j < Dv;

  const T* rp = r + b * L.s[0][0] + h * L.s[0][1];
  const T* kp = k + b * L.s[1][0] + h * L.s[1][1];
  const T* vp = v + b * L.s[2][0] + h * L.s[2][1];
  const float* wp = w + b * L.s[3][0] + h * L.s[3][1];
  T* op = o + b * L.s[4][0] + h * L.s[4][1];
  const long long state0 = static_cast<long long>(bh) * DK * Dv;

  for (int i = tid; i < DK; i += nt) us[i] = u[h * DK + i];
  float S[KQ];
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    const int kk = q + i * kSplit;
    S[i] = (owner && s0 != nullptr) ? s0[state0 + kk * Dv + j] : 0.0f;
  }

  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int n = Tn - t0 < kChunk ? Tn - t0 : kChunk;
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < n * DK; i += nt) {
      const int tt = i / DK, kk = i % DK;
      const long long t = t0 + tt;
      rs[tt][kk] = to_float(rp[t * L.s[0][2] + kk]);
      ks[tt][kk] = to_float(kp[t * L.s[1][2] + kk]);
      ws[tt][kk] = wp[t * L.s[3][2] + kk];
    }
    for (int i = tid; i < n * Dv; i += nt) {
      const int tt = i / Dv, jj = i % Dv;
      vs[tt][jj] = to_float(vp[(t0 + tt) * L.s[2][2] + jj]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      // threads past Dv run on zeros: every lane takes part in the shuffles
      const float vj = owner ? vs[tt][j] : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < KQ; ++i) {
        const int kk = q + i * kSplit;
        const float kv = __fmul_rn(ks[tt][kk], vj);
        const float term =
            __fmul_rn(__fadd_rn(S[i], __fmul_rn(us[kk], kv)), rs[tt][kk]);
        acc = __fadd_rn(acc, term);
        S[i] = __fadd_rn(__fmul_rn(ws[tt][kk], S[i]), kv);
      }
      // the kSplit partial sums of a column sit in neighbouring lanes:
      // (p0 + p1) + (p2 + p3), the same value in all four lanes
#pragma unroll
      for (int m = 1; m < kSplit; m *= 2) {
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
      }
      if (owner && q == 0) store(op + (t0 + tt) * L.s[4][2] + j, acc);
    }
  }
  if (owner) {
#pragma unroll
    for (int i = 0; i < KQ; ++i) {
      sT[state0 + (q + i * kSplit) * Dv + j] = S[i];
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* o, float* sT, int B,
           int H, int Tn, int Dk, int Dv, const long long* strides,
           cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || Dv <= 0 || Dv > kMaxDv) {
    return cudaErrorInvalidValue;
  }
  Layout L;
  for (int a = 0; a < 5; ++a)
    for (int c = 0; c < 3; ++c) L.s[a][c] = strides[a * 3 + c];
  // kSplit threads per column, whole warps of 32 / kSplit columns
  const int cols = (Dv + 32 / kSplit - 1) / (32 / kSplit) * (32 / kSplit);
  const int threads = cols * kSplit;
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (Dk) {
    case 16:
      rwkv6_kernel<16, T><<<B * H, threads, 0, stream>>>(
          rp, kp, vp, w, u, s0, op, sT, H, Tn, Dv, L);
      break;
    case 32:
      rwkv6_kernel<32, T><<<B * H, threads, 0, stream>>>(
          rp, kp, vp, w, u, s0, op, sT, H, Tn, Dv, L);
      break;
    case kMaxDk:
      rwkv6_kernel<kMaxDk, T><<<B * H, threads, 0, stream>>>(
          rp, kp, vp, w, u, s0, op, sT, H, Tn, Dv, L);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_f32(const void* r, const void* k, const void* v,
                         const float* w, const float* u, const float* s0,
                         void* o, float* sT, int B, int H, int T, int Dk,
                         int Dv, const long long* strides,
                         cudaStream_t stream) {
  return launch<float>(r, k, v, w, u, s0, o, sT, B, H, T, Dk, Dv, strides,
                       stream);
}

extern "C" int rwkv6_bf16(const void* r, const void* k, const void* v,
                          const float* w, const float* u, const float* s0,
                          void* o, float* sT, int B, int H, int T, int Dk,
                          int Dv, const long long* strides,
                          cudaStream_t stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, o, sT, B, H, T, Dk, Dv,
                               strides, stream);
}
