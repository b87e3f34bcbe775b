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
// the sums differ. Those orders are fixed, whatever B, H, T:
// - dr, dk, dw (sums over j): the columns fall into tiles of four; each
//   tile's four terms add in ascending j, starting from the first term,
//   and the tiles' sums add in ascending tile order, starting from tile 0.
// - dv (a sum over i): the same with tiles of four rows.
// - sum_j do_t[j] v_t[j]: ascending j from the first term.
// - du: each (b, h) starts at 0.0f and adds its step terms from t = T - 1
//   down to 0.
//
// Bound on this card. Per (b, h, t) the backward does about 22 Dk Dv float
// operations (the state recomputed twice, 3 each; the terms of dr 5, of
// dkv 2, of dk, dv and dw 2 each, the dS update 3) against
// (3 Dk + 2 Dv) elements read and 3 Dk + Dv written, plus a float32
// checkpoint of the state every kChunk steps written and read once: at
// rwkv6-1.6b's training shape [4, 32, 1024, 64] 11.9 GFLOP, 0.177 ms at the
// 67 TFLOP/s float32 peak, against 0.45 GB, 0.135 ms at 3.35 TB/s, so the
// operations bound rules (kernels/cost.py:rwkv6_backward).
//
// The design (simple first, correct before fast):
// - One block per (b, h). Thread (it, jt) owns the 4 x 4 tile of state
//   rows 4 it.. and columns 4 jt.. (Dv padded to a multiple of 4 with zero
//   columns): its S and dS live in registers.
// - Pass 1 walks forward, updating S a staged chunk at a time, and writes
//   S every kChunk steps to the checkpoint workspace [B, H, nC, Dk, Dv4].
// - Pass 2 walks the chunks backward. A chunk's r, k, w, v and do are
//   staged into shared memory as float32; S is reloaded from the chunk's
//   checkpoint and the chunk's states S_{t-1} are recomputed into the
//   block's scratch [kChunk][threads][16] in device memory (32 MB at the
//   training shape, L2-resident: each thread reads back only what it
//   wrote). Then the steps run in reverse: each thread reads its S_{t-1},
//   updates its dS and leaves 16 partial sums a step (dr, dk, dw of its
//   four rows over its four columns, dv of its four columns over its four
//   rows) in shared memory; every kSub steps the block adds the tiles'
//   partials into the outputs (one thread an output element), and the
//   threads of the first column tile add their rows' du terms. The
//   outputs do not feed back into dS, so their sums leave the
//   recurrence's critical path.
//
// C interface (loaded with ctypes): rwkv6_bwd_f32 / rwkv6_bwd_bf16 take
// device pointers r, k, v, w, u, do, s0 (may be null), dsT (may be null),
// dr, dk, dv, dw, du_part, ds0, the workspace and its size in floats, the
// sizes B, H, T, Dk, Dv, a host pointer to 27 element strides (b, h, t of
// r, k, v, w, do, dr, dk, dv and dw, in that order; the last dimension of
// each has unit stride) and the CUDA stream; they return the cudaError_t
// of the launch (0 = success; cudaErrorInvalidValue for Dk not in
// {16, 32, 64}, Dv outside 1..128 or a workspace smaller than
// workspace_floats', which kernels/rwkv6.py:workspace_floats mirrors). The
// launch is asynchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // steps between checkpoints, and of a chunk
constexpr int kSub = 4;     // steps whose partial sums are added together
constexpr int kTile = 4;    // rows and columns of a thread's tile
constexpr int kParts = 16;  // partials a thread leaves a step
constexpr int kMaxThreads = (64 / kTile) * (128 / kTile);

struct Layout {
  long long s[9][3];  // (r, k, v, w, do, dr, dk, dv, dw) x (b, h, t)
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

int cdiv(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// floats of one staged step: r, k, w (Dk each), v, do (Dv4 each)
__host__ __device__ int step_floats(int Dk, int Dv4) {
  return 3 * Dk + 2 * Dv4;
}

size_t smem_bytes(int Dk, int Dv4, int nt) {
  return sizeof(float) * (static_cast<size_t>(kChunk) * step_floats(Dk, Dv4) +
                          kChunk +
                          static_cast<size_t>(kSub) * kParts * nt);
}

// workspace floats: the checkpoints, then every block's chunk scratch
long long workspace_floats(int B, int H, int T, int Dk, int Dv) {
  const long long Dv4 = (Dv + 3) / 4 * 4;
  const long long nC = cdiv(T, kChunk);
  return static_cast<long long>(B) * H * (nC + kChunk) * Dk * Dv4;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const T* __restrict__ dout,
                     const float* __restrict__ s0,
                     const float* __restrict__ dsT, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ ds0, float* __restrict__ work,
                     int H, int Tn, int Dk, int Dv, Layout L) {
  extern __shared__ __align__(16) float smem[];
  const int Dv4 = (Dv + 3) / 4 * 4;
  const int ct = Dv4 / kTile;  // column tiles
  const int rt = Dk / kTile;   // row tiles
  const int nt = blockDim.x;   // rt * ct
  const int tid = threadIdx.x;
  const int i0 = (tid / ct) * kTile, j0 = (tid % ct) * kTile;
  const int SW = step_floats(Dk, Dv4);
  float* stage = smem;                // [kChunk][SW]: r | k | w | v | do
  float* dot = stage + kChunk * SW;   // [kChunk]
  float* part = dot + kChunk;         // [kSub][kParts][nt]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int nC = (Tn + kChunk - 1) / kChunk;
  const long long state = static_cast<long long>(bh) * Dk * Dv;
  const long long plane = static_cast<long long>(Dk) * Dv4;
  float* ck = work + static_cast<long long>(bh) * nC * plane;
  float* sc = work + static_cast<long long>(gridDim.x) * nC * plane +
              static_cast<long long>(bh) * kChunk * plane +
              static_cast<long long>(tid) * kParts;  // this thread's slot

  auto at = [&](int a, int t) {
    return b * L.s[a][0] + h * L.s[a][1] +
           static_cast<long long>(t) * L.s[a][2];
  };

  // stage steps t0 .. t0 + n - 1 (float32; zeros past Dv), r and do only
  // when ``all``
  auto stage_chunk = [&](int t0, int n, bool all) {
    for (int e = tid; e < n * SW; e += nt) {
      const int s = e / SW, o = e % SW, t = t0 + s;
      float x = 0.0f;
      if (o < 3 * Dk) {
        const int f = o / Dk, i = o % Dk;
        if (f == 0) {
          if (all) x = to_float(r[at(0, t) + i]);
        } else if (f == 1) {
          x = to_float(k[at(1, t) + i]);
        } else {
          x = w[at(3, t) + i];
        }
      } else {
        const int f = (o - 3 * Dk) / Dv4, j = (o - 3 * Dk) % Dv4;
        if (j < Dv) {
          if (f == 0) {
            x = to_float(v[at(2, t) + j]);
          } else if (all) {
            x = to_float(dout[at(4, t) + j]);
          }
        }
      }
      stage[e] = x;
    }
  };
  // S = w * S + k * v at staged step st (the forward kernel's update)
  auto advance = [&](float (&S)[kTile][kTile], const float* st) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const float kr = st[Dk + i0 + a], wr = st[2 * Dk + i0 + a];
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const float kv = __fmul_rn(kr, st[3 * Dk + j0 + c]);
        S[a][c] = __fadd_rn(__fmul_rn(wr, S[a][c]), kv);
      }
    }
  };
  auto store_tile = [&](float* p, const float (&S)[kTile][kTile]) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      *reinterpret_cast<float4*>(p + 4 * a) =
          make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
    }
  };
  auto load_tile = [&](const float* p, float (&S)[kTile][kTile]) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const float4 y = *reinterpret_cast<const float4*>(p + 4 * a);
      S[a][0] = y.x, S[a][1] = y.y, S[a][2] = y.z, S[a][3] = y.w;
    }
  };
  auto load_state = [&](const float* src, float (&S)[kTile][kTile]) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        S[a][c] = (src != nullptr && j0 + c < Dv)
                      ? src[state + (i0 + a) * Dv + j0 + c]
                      : 0.0f;
      }
    }
  };

  // -- pass 1: the checkpoints -------------------------------------------
  float S[kTile][kTile];
  load_state(s0, S);
  for (int c = 0; c < nC; ++c) {
    // checkpoint c: the state before step c * kChunk, in [Dk][Dv4] rows
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      *reinterpret_cast<float4*>(ck + c * plane + (i0 + a) * Dv4 + j0) =
          make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
    }
    if (c == nC - 1) break;
    __syncthreads();  // the block is done with the previous chunk
    stage_chunk(c * kChunk, kChunk, false);
    __syncthreads();
    for (int s = 0; s < kChunk; ++s) advance(S, stage + s * SW);
  }

  // -- pass 2: the chunks in reverse -------------------------------------
  float dS[kTile][kTile];
  load_state(dsT, dS);
  float uu[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) uu[a] = u[h * Dk + i0 + a];
  float du_acc[kTile] = {0.0f, 0.0f, 0.0f, 0.0f};  // rows i0.. (j0 == 0)
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, Tn - t0);
    __syncthreads();  // the block is done with the previous chunk's stage
    stage_chunk(t0, n, true);
    __syncthreads();
    for (int s = tid; s < n; s += nt) {  // sum_j do_t[j] v_t[j], ascending j
      const float* st = stage + s * SW + 3 * Dk;
      float acc = __fmul_rn(st[Dv4], st[0]);
      for (int j = 1; j < Dv; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(st[Dv4 + j], st[j]));
      }
      dot[s] = acc;
    }
    // the chunk's states S_{t-1}, t = t0 .. t0 + n - 1, into the scratch
    {
      const float* cp = ck + c * plane;
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        const float4 y =
            *reinterpret_cast<const float4*>(cp + (i0 + a) * Dv4 + j0);
        S[a][0] = y.x, S[a][1] = y.y, S[a][2] = y.z, S[a][3] = y.w;
      }
    }
    for (int s = 0; s < n; ++s) {
      store_tile(sc + static_cast<long long>(s) * nt * kParts, S);
      if (s + 1 < n) advance(S, stage + s * SW);
    }
    for (int hi = n; hi > 0; hi -= kSub) {
      const int lo = max(hi - kSub, 0);
      for (int s = hi - 1; s >= lo; --s) {
        float Sp[kTile][kTile];
        load_tile(sc + static_cast<long long>(s) * nt * kParts, Sp);
        const float* st = stage + s * SW;
        float pr[kTile], pk[kTile], pw[kTile], pv[kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          const float rr = st[i0 + a], kr = st[Dk + i0 + a];
          const float wr = st[2 * Dk + i0 + a];
          const float ru = __fmul_rn(rr, uu[a]);
#pragma unroll
          for (int c2 = 0; c2 < kTile; ++c2) {
            const float vj = st[3 * Dk + j0 + c2];
            const float dj = st[3 * Dk + Dv4 + j0 + c2];
            const float kv = __fmul_rn(kr, vj);
            const float tr =
                __fmul_rn(__fadd_rn(Sp[a][c2], __fmul_rn(uu[a], kv)), dj);
            const float dkv = __fadd_rn(dS[a][c2], __fmul_rn(ru, dj));
            const float tk = __fmul_rn(dkv, vj);
            const float tv = __fmul_rn(dkv, kr);
            const float tw = __fmul_rn(dS[a][c2], Sp[a][c2]);
            dS[a][c2] = __fadd_rn(__fmul_rn(wr, dS[a][c2]), __fmul_rn(rr, dj));
            pr[a] = c2 ? __fadd_rn(pr[a], tr) : tr;
            pk[a] = c2 ? __fadd_rn(pk[a], tk) : tk;
            pw[a] = c2 ? __fadd_rn(pw[a], tw) : tw;
            pv[c2] = a ? __fadd_rn(pv[c2], tv) : tv;
          }
        }
        float* ps = part + (s - lo) * kParts * nt + tid;
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          ps[a * nt] = pr[a];
          ps[(4 + a) * nt] = pk[a];
          ps[(8 + a) * nt] = pw[a];
          ps[(12 + a) * nt] = pv[a];
        }
      }
      __syncthreads();
      // the steps' outputs: one thread an output element, the tiles'
      // partials added in ascending tile order
      const int outs = 3 * Dk + Dv;
      for (int e = tid; e < (hi - lo) * outs; e += nt) {
        const int s = lo + e / outs, q = e % outs, t = t0 + s;
        const float* ps = part + (s - lo) * kParts * nt;
        if (q < 3 * Dk) {
          const int f = q / Dk, i = q % Dk;  // 0 dr, 1 dk, 2 dw
          const float* p = ps + (4 * f + i % kTile) * nt + (i / kTile) * ct;
          float acc = p[0];
          for (int x = 1; x < ct; ++x) acc = __fadd_rn(acc, p[x]);
          if (f == 0) {
            store(dr + at(5, t) + i, acc);
          } else if (f == 1) {
            store(dk + at(6, t) + i, acc);
          } else {
            dw[at(8, t) + i] = acc;
          }
        } else {
          const int j = q - 3 * Dk;
          const float* p = ps + (12 + j % kTile) * nt + j / kTile;
          float acc = p[0];
          for (int x = 1; x < rt; ++x) acc = __fadd_rn(acc, p[x * ct]);
          store(dv + at(7, t) + j, acc);
        }
      }
      if (j0 == 0) {  // du's step terms of rows i0.., t descending
        for (int s = hi - 1; s >= lo; --s) {
          const float* st = stage + s * SW;
#pragma unroll
          for (int a = 0; a < kTile; ++a) {
            du_acc[a] = __fadd_rn(
                du_acc[a], __fmul_rn(__fmul_rn(st[i0 + a], st[Dk + i0 + a]),
                                     dot[s]));
          }
        }
      }
      __syncthreads();  // the partials are read before the next steps' land
    }
  }
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      if (j0 + c < Dv) ds0[state + (i0 + a) * Dv + j0 + c] = dS[a][c];
    }
  }
  if (j0 == 0) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      du_part[static_cast<long long>(bh) * Dk + i0 + a] = du_acc[a];
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const void* dout, const float* s0,
           const float* dsT, void* dr, void* dk, void* dv, float* dw,
           float* du_part, float* ds0, float* work, long long work_floats,
           int B, int H, int Tn, int Dk, int Dv, const long long* strides,
           cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || (Dk != 16 && Dk != 32 && Dk != 64) ||
      Dv <= 0 || Dv > 128 || B * static_cast<long long>(H) > 2147483647LL ||
      work_floats < workspace_floats(B, H, Tn, Dk, Dv)) {
    return cudaErrorInvalidValue;
  }
  Layout L;
  for (int a = 0; a < 9; ++a)
    for (int c = 0; c < 3; ++c) L.s[a][c] = strides[a * 3 + c];
  const int Dv4 = (Dv + 3) / 4 * 4;
  const int nt = (Dk / kTile) * (Dv4 / kTile);
  const size_t smem = smem_bytes(Dk, Dv4, nt);
  auto kernel = rwkv6_bwd_kernel<T>;
  static size_t opted = 0;  // dynamic shared memory already allowed
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  kernel<<<B * H, nt, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<const T*>(dout), s0, dsT,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw,
      du_part, ds0, work, H, Tn, Dk, Dv, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_bwd_f32(const void* r, const void* k, const void* v,
                             const float* w, const float* u, const void* dout,
                             const float* s0, const float* dsT, void* dr,
                             void* dk, void* dv, float* dw, float* du_part,
                             float* ds0, float* work, long long work_floats,
                             int B, int H, int T, int Dk, int Dv,
                             const long long* strides, cudaStream_t stream) {
  return launch<float>(r, k, v, w, u, dout, s0, dsT, dr, dk, dv, dw, du_part,
                       ds0, work, work_floats, B, H, T, Dk, Dv, strides,
                       stream);
}

extern "C" int rwkv6_bwd_bf16(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const void* dout, const float* s0,
                              const float* dsT, void* dr, void* dk, void* dv,
                              float* dw, float* du_part, float* ds0,
                              float* work, long long work_floats, int B,
                              int H, int T, int Dk, int Dv,
                              const long long* strides, cudaStream_t stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, dout, s0, dsT, dr, dk, dv, dw,
                               du_part, ds0, work, work_floats, B, H, T, Dk,
                               Dv, strides, stream);
}
