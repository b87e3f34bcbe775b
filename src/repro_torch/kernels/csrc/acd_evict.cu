// Greedy ACD evict mask: the Hopper port of the Pallas kernel
// src/repro/kernels/acd_sweep.py:acd_evict (pallas_call at :54).
//
// What it computes. For each row b of [B, J] queue data, scan the jobs
// left to right carrying the kept-demand sum s (starting at 0): a masked
// job is evicted iff s > thresh[b, j]; otherwise (and only if masked) its
// demand P[b, j] joins s. out[b, j] = 1 for an evicted job, else 0.
//
// Bound on this card. The function moves B*J*(sizeof(T) + sizeof(T) + 1
// + 1) bytes (P, thresh and the mask read once, the mask written once):
// at the engine's [30, 4096] float64 that is about 2.2 MB, under 1 us at
// 3.35 TB/s. Its real limit is the serial chain inside each row: J
// dependent compare-select-add steps on s, which no amount of memory
// bandwidth shortens. Rows are independent.
//
// What the design does about it. One block per row, so the rows run on
// separate SMs in parallel. The block copies its row through shared
// memory in coalesced tiles; one thread then runs the tile's serial chain
// out of shared memory (the loads do not depend on s, so only the
// compare, select and add sit on the critical path) and carries s from
// tile to tile in a register; the block writes the tile's result bytes
// back coalesced. Faster schemes (several speculative scans per row) are
// later work.
//
// Exactness. The only float operations are s + p and s > thresh, in the
// order of the sequential recurrence, so the result is bitwise equal to
// the plain PyTorch version and to the reference. Build with
// --fmad=false all the same: nothing here may ever contract.
//
// C interface (loaded with ctypes): acd_evict_f64 / acd_evict_f32 take
// device pointers, the row count B, the row length J and the CUDA stream
// to launch on, and return the cudaError_t of the launch (0 = success).
// Arrays are dense row-major [B, J]; mask and out hold one byte per
// element (0 or 1). The launch is asynchronous on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;

template <typename T>
__global__ void __launch_bounds__(kThreads)
acd_evict_kernel(const T* __restrict__ P, const T* __restrict__ thresh,
                 const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
                 int J) {
  __shared__ T sp[kTile];
  __shared__ T st[kTile];
  __shared__ uint8_t sm[kTile];
  __shared__ uint8_t so[kTile];

  const size_t row = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(J);
  const T* p_row = P + row;
  const T* t_row = thresh + row;
  const uint8_t* m_row = mask + row;
  uint8_t* o_row = out + row;

  T s = T(0);  // kept-demand sum; live in thread 0 only
  for (int base = 0; base < J; base += kTile) {
    const int n = min(kTile, J - base);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sp[i] = p_row[base + i];
      st[i] = t_row[base + i];
      sm[i] = m_row[base + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const bool mi = sm[i] != 0;
        const bool ev = mi && (s > st[i]);
        so[i] = ev ? 1 : 0;
        s = s + ((mi && !ev) ? sp[i] : T(0));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      o_row[base + i] = so[i];
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* P, const T* thresh, const uint8_t* mask, uint8_t* out,
           int B, int J, void* stream) {
  if (B <= 0 || J <= 0) return 0;
  acd_evict_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, thresh, mask, out, J);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int acd_evict_f64(const double* P, const double* thresh,
                             const uint8_t* mask, uint8_t* out, int B, int J,
                             void* stream) {
  return launch<double>(P, thresh, mask, out, B, J, stream);
}

extern "C" int acd_evict_f32(const float* P, const float* thresh,
                             const uint8_t* mask, uint8_t* out, int B, int J,
                             void* stream) {
  return launch<float>(P, thresh, mask, out, B, J, stream);
}
