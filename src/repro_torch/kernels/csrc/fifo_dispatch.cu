// Capped FIFO public-dispatch chain: the Hopper port of the Pallas kernel
// src/repro/kernels/dispatch.py:fifo_dispatch (pallas_call at :115).
//
// What it computes. For each scenario row b, the first n_pub[b] jobs of
// order[b, :] (the stage's public jobs, in the DES's event order) replay
// one after another against a [P, C] pool of slot clocks and idle stamps.
// Job j, for every provider p: the earliest-free slot si_p (argmin of the
// clocks, first index on ties), the wait w_p = max(0, clock - ready) on a
// capped provider (0 on an uncapped one), under the cold-start model the
// cold flag c_p = (ready + w_p - idle > keep_alive) | (idle == -inf) on a
// capped provider, and the penalty pen_p = occ * (w_p + c_p * wu_p). The
// job takes the provider argmin of selc + pen (first index on ties),
// starts at (ready + w) + c * wu and ends dur later; if that provider is
// capped, its slot si gets the end as its new clock and idle stamp. The
// seven outputs (provider, segment, wait, cold, start, end, penalty) are
// written at column j; columns the chain never visits hold zeros.
//
// Bound on this card. At the engine's [B, P, J, C] = [30, 3, 4096, 2] with
// every column visited, the function reads 4*B*P*J*8 bytes (ready, dur,
// selc, occ) + B*P*J*4 (seg) + B*J*4 + B*4 (order, n_pub), about 13.8 MB,
// and writes B*J*41 bytes, about 5.0 MB: some 5.6 us at 3.35 TB/s. The
// arithmetic is a few operations per (job, provider, slot), far below the
// card's float64 rate. Its real limit is the chain inside each row: n_pub
// dependent steps, each a P x C argmin, a P argmin and a clock write that
// the next step reads.
//
// What the design does about it. One block per row, so the rows run on
// separate SMs in parallel. The slot pool lives in shared memory. The
// block gathers the columns of the next tile of chain steps (ready, dur,
// selc, occ and seg of every provider at job order[i]) from device memory
// into shared memory with all its threads, so the scattered loads overlap
// one another. One thread then runs the tile's steps out of shared
// memory: a running argmin over the providers, each priced against its
// earliest-free slot, and stores the outputs straight to device memory
// (stores never stall the chain). Overlapping the next tile's gather with
// the current chain, or speculating over the chain, is later work.
//
// Exactness. Every float expression keeps the reference's association:
// (ready + wait) + cold * wu, start + dur, occ * (wait + cold * wu),
// selc + pen, (ready + wait) - idle; both argmins are a strict < over a
// running best from index 0, so they take the first index on ties and,
// like jnp.argmin and torch.argmin, the first NaN; max(0, d)
// propagates a NaN d like jnp.maximum. No fmin/fmax (they drop NaNs).
// Build with --fmad=false: selc + occ * (...) must never contract.
//
// C interface (loaded with ctypes): fifo_dispatch_f64 takes device
// pointers, B, P, J, C, keep_alive, the cold flag (0 or 1) and the CUDA
// stream, and returns the cudaError_t of the launch (0 = success). Arrays
// are dense row-major: order [B, J] int32, n_pub [B] int32, ready, dur,
// selc, occ [B, P, J] float64, seg [B, P, J] int32, capped [P] one byte
// each, wu [P] float64, sclk0 and sidle0 [B, P, C] float64; outputs prov
// and seg_out [B, J] int32, wait, start, end, extra [B, J] float64, cold
// [B, J] one byte each. Entries of order outside [0, J) are skipped. The
// launch is asynchronous on the given stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 256;
constexpr size_t kSmemBudget = 48 * 1024;

size_t smem_bytes(int P, int C, int T) {
  return sizeof(double) * (2 * static_cast<size_t>(P) * C + P
                           + 4 * static_cast<size_t>(T) * P)
         + sizeof(int) * (static_cast<size_t>(T) * P + T) + P;
}

// running argmin over increasing indices (first index of the minimum, the
// first NaN if there is one): does the later value v replace best?
__device__ __forceinline__ bool argmin_takes(double v, double best) {
  return !isnan(best) && (isnan(v) || v < best);
}

template <bool kCold>
__global__ void __launch_bounds__(kThreads)
fifo_dispatch_kernel(const int* __restrict__ order,
                     const int* __restrict__ n_pub,
                     const double* __restrict__ ready,
                     const double* __restrict__ dur,
                     const double* __restrict__ selc,
                     const double* __restrict__ occ,
                     const int* __restrict__ seg,
                     const uint8_t* __restrict__ capped,
                     const double* __restrict__ wu,
                     const double* __restrict__ sclk0,
                     const double* __restrict__ sidle0,
                     int* __restrict__ prov_out, int* __restrict__ seg_out,
                     double* __restrict__ wait_out,
                     uint8_t* __restrict__ cold_out,
                     double* __restrict__ start_out,
                     double* __restrict__ end_out,
                     double* __restrict__ extra_out,
                     int P, int J, int C, int T, double keep_alive) {
  extern __shared__ double smem[];
  double* sclk = smem;                 // [P * C]
  double* sidle = sclk + P * C;        // [P * C]
  double* s_wu = sidle + P * C;        // [P]
  double* t_ready = s_wu + P;          // [T * P]
  double* t_dur = t_ready + T * P;
  double* t_selc = t_dur + T * P;
  double* t_occ = t_selc + T * P;
  int* t_seg = reinterpret_cast<int*>(t_occ + T * P);  // [T * P]
  int* t_j = t_seg + T * P;                            // [T]
  uint8_t* s_cap = reinterpret_cast<uint8_t*>(t_j + T);  // [P]

  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * J;
  const size_t row_pj = static_cast<size_t>(b) * P * J;
  const size_t row_pc = static_cast<size_t>(b) * P * C;

  // untouched columns keep the reference's zero fill
  for (int i = threadIdx.x; i < J; i += kThreads) {
    prov_out[row + i] = 0;
    seg_out[row + i] = 0;
    wait_out[row + i] = 0.0;
    cold_out[row + i] = 0;
    start_out[row + i] = 0.0;
    end_out[row + i] = 0.0;
    extra_out[row + i] = 0.0;
  }
  for (int i = threadIdx.x; i < P * C; i += kThreads) {
    sclk[i] = sclk0[row_pc + i];
    sidle[i] = sidle0[row_pc + i];
  }
  for (int p = threadIdx.x; p < P; p += kThreads) {
    s_wu[p] = wu[p];
    s_cap[p] = capped[p];
  }
  const int n = min(max(n_pub[b], 0), J);
  __syncthreads();

  for (int base = 0; base < n; base += T) {
    const int m = min(T, n - base);
    // gather the tile's columns: (step, provider) pairs across the block
    for (int q = threadIdx.x; q < m * P; q += kThreads) {
      const int ii = q / P;
      const int p = q - ii * P;
      const int j = order[row + base + ii];
      const bool ok = j >= 0 && j < J;
      if (p == 0) t_j[ii] = ok ? j : -1;
      if (ok) {
        const size_t g = row_pj + static_cast<size_t>(p) * J + j;
        t_ready[q] = ready[g];
        t_dur[q] = dur[g];
        t_selc[q] = selc[g];
        t_occ[q] = occ[g];
        t_seg[q] = seg[g];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int ii = 0; ii < m; ++ii) {
        const int j = t_j[ii];
        if (j < 0) continue;
        int bp = 0, bsi = 0;
        bool bcold = false;
        double bkey = 0.0, bw = 0.0, bcw = 0.0, bpen = 0.0;
        for (int p = 0; p < P; ++p) {
          const double* clk = sclk + p * C;
          int si = 0;
          double sc = clk[0];
          for (int c = 1; c < C; ++c) {
            if (argmin_takes(clk[c], sc)) {
              sc = clk[c];
              si = c;
            }
          }
          const bool cap = s_cap[p] != 0;
          const double r = t_ready[ii * P + p];
          double w = 0.0;
          if (cap) {
            const double d = sc - r;
            w = (d > 0.0 || isnan(d)) ? d : 0.0;
          }
          bool cp = false;
          if (kCold && cap) {
            const double idle = sidle[p * C + si];
            cp = (r + w - idle > keep_alive) || (idle == -INFINITY);
          }
          const double cw = (cp ? 1.0 : 0.0) * s_wu[p];
          const double pen = t_occ[ii * P + p] * (w + cw);
          const double key = t_selc[ii * P + p] + pen;
          if (p == 0 || argmin_takes(key, bkey)) {
            bkey = key;
            bp = p;
            bsi = si;
            bw = w;
            bcw = cw;
            bpen = pen;
            bcold = cp;
          }
        }
        const double start = (t_ready[ii * P + bp] + bw) + bcw;
        const double end = start + t_dur[ii * P + bp];
        prov_out[row + j] = bp;
        seg_out[row + j] = t_seg[ii * P + bp];
        wait_out[row + j] = bw;
        cold_out[row + j] = bcold ? 1 : 0;
        start_out[row + j] = start;
        end_out[row + j] = end;
        extra_out[row + j] = bpen;
        if (s_cap[bp] != 0) {
          sclk[bp * C + bsi] = end;
          sidle[bp * C + bsi] = end;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int fifo_dispatch_f64(
    const int* order, const int* n_pub, const double* ready,
    const double* dur, const double* selc, const double* occ,
    const int* seg, const uint8_t* capped, const double* wu,
    const double* sclk0, const double* sidle0, int* prov_out, int* seg_out,
    double* wait_out, uint8_t* cold_out, double* start_out, double* end_out,
    double* extra_out, int B, int P, int J, int C, double keep_alive,
    int cold, void* stream) {
  if (B <= 0 || J <= 0) return 0;
  if (P <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int T = kMaxTile;
  while (T > 1 && smem_bytes(P, C, T) > kSmemBudget) T /= 2;
  const size_t smem = smem_bytes(P, C, T);
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cold) {
    fifo_dispatch_kernel<true><<<B, kThreads, smem, s>>>(
        order, n_pub, ready, dur, selc, occ, seg, capped, wu, sclk0, sidle0,
        prov_out, seg_out, wait_out, cold_out, start_out, end_out, extra_out,
        P, J, C, T, keep_alive);
  } else {
    fifo_dispatch_kernel<false><<<B, kThreads, smem, s>>>(
        order, n_pub, ready, dur, selc, occ, seg, capped, wu, sclk0, sidle0,
        prov_out, seg_out, wait_out, cold_out, start_out, end_out, extra_out,
        P, J, C, T, keep_alive);
  }
  return static_cast<int>(cudaGetLastError());
}
