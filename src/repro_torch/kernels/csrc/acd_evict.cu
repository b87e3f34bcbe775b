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
// 3.35 TB/s. Its real limit is the serial chain inside each row: one
// dependent compare-select-add step on s per masked job, which no amount
// of memory bandwidth shortens (the chain floor: the longest row's masked
// count times one step's latency). Rows are independent.
//
// What the design does about it. One block per row, so the rows run on
// separate SMs in parallel, and inside a row the chain carries nothing
// but s:
// - Compaction. The row goes in tiles of 1024 jobs. The block's worker
//   warps ballot a tile's mask 32 jobs at a time, take the prefix of the
//   chunks' popcounts, and write the masked jobs' (P, thresh) pairs and
//   their indices contiguously into shared memory (padded past the end
//   with steps that change nothing), so the chain visits masked jobs only.
// - Speculation. Each step computes s + p beside s > thresh and then
//   selects, so an add and a compare run side by side, then one select.
// - Loads off the chain. The chain thread reads the next eight entries
//   into registers while it runs the current eight.
// - Warp specialisation. Lane 0 of warp 0 runs tile i's chain, marking
//   evictions in a byte tile by job index, while the worker warps write
//   tile i - 1's bytes back (coalesced) and compact tile i + 1: two
//   shared buffers, one barrier per tile.
//
// Exactness. The chain skips the unmasked jobs, and an evicted job no
// longer adds 0 to s. Both are exact: s + 0.0 differs from s only when s
// is -0.0 (never: s starts at +0.0, and a round-to-nearest sum is -0.0
// only when both addends are) or a NaN (whose payload no comparison
// reads), and +0.0 and -0.0 compare alike. The float operations left are
// s + p and s > thresh, in the order of the sequential recurrence, so the
// evict mask is bitwise equal to the plain PyTorch version's and the
// reference's. Build with --fmad=false all the same: nothing here may
// ever contract.
//
// C interface (loaded with ctypes): acd_evict_f64 / acd_evict_f32 take
// device pointers, the row count B, the row length J and the CUDA stream
// to launch on, and return the cudaError_t of the launch (0 = success).
// Arrays are dense row-major [B, J]; mask and out hold one byte per
// element (0 or 1). The launch is asynchronous on the given stream.
// acd_chain_step_probe times the chain step alone (see there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWorkers = 8;                   // compacting warps
constexpr int kThreads = 32 * (1 + kWorkers);  // + the chain's warp
constexpr int kTile = 1024;                   // jobs per tile
constexpr int kChunks = kTile / 32;           // ballots per tile
constexpr int kPerWorker = kChunks / kWorkers;
constexpr int kAhead = 8;  // chain entries read ahead
// compacted entries: a tile, the pad after it, and what the chain reads
// ahead past the pad
constexpr int kCap = kTile + 2 * kAhead;
static_assert(kChunks == 32 && kChunks % kWorkers == 0, "one scan a warp");

template <typename T>
struct alignas(2 * sizeof(T)) Entry {
  T p, t;  // demand and threshold of one masked job: one shared load
};

template <typename T>
__device__ __forceinline__ T infinity();
template <>
__device__ __forceinline__ double infinity<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <>
__device__ __forceinline__ float infinity<float>() {
  return __int_as_float(0x7f800000);
}

template <typename T>
struct Buf {
  Entry<T> ent[kCap];
  uint16_t idx[kCap];  // the entry's job within the tile
  uint8_t ev[kTile];   // eviction bytes of the tile, by job
  int cnt[kChunks];    // masked jobs per chunk of 32
  int n;               // masked jobs of the tile
};

// Worker warp w (0 .. kWorkers-1) takes chunks w, w + kWorkers, ...: it
// zeroes their eviction bytes, ballots their mask and, after the workers'
// barrier, writes their masked jobs at the prefix of the chunk counts.
template <typename T>
__device__ __forceinline__ void compact(Buf<T>& b, const T* p_row,
                                        const T* t_row, const uint8_t* m_row,
                                        int base, int J, int w, int lane) {
  bool m[kPerWorker];
#pragma unroll
  for (int q = 0; q < kPerWorker; ++q) {
    const int j = base + (w + q * kWorkers) * 32 + lane;
    m[q] = j < J && m_row[j] != 0;
  }
  uint32_t bal[kPerWorker];
  T pv[kPerWorker], tv[kPerWorker];
#pragma unroll
  for (int q = 0; q < kPerWorker; ++q) {
    const int c = w + q * kWorkers, j = base + c * 32 + lane;
    bal[q] = __ballot_sync(0xffffffffu, m[q]);
    if (m[q]) pv[q] = p_row[j], tv[q] = t_row[j];
    if (lane == 0) b.cnt[c] = __popc(bal[q]);
    b.ev[c * 32 + lane] = 0;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWorkers * 32) : "memory");
  // exclusive prefix of the 32 chunk counts, lane c holding chunk c's
  const int cnt = b.cnt[lane];
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int excl = incl - cnt;
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kPerWorker; ++q) {
    const int c = w + q * kWorkers;
    const int at = __shfl_sync(0xffffffffu, excl, c);
    if (m[q]) {
      const int e = at + __popc(bal[q] & below);
      b.ent[e] = Entry<T>{pv[q], tv[q]};
      b.idx[e] = static_cast<uint16_t>(c * 32 + lane);
    }
  }
  if (w == 0) {
    // pad: p = -0.0 and thresh = +inf never evict and leave s as it is
    if (lane < kAhead) {
      b.ent[total + lane] = Entry<T>{-T(0), infinity<T>()};
      b.idx[total + lane] = 0;
    }
    if (lane == 0) b.n = total;
  }
}

template <typename T>
__device__ __forceinline__ void write_back(const Buf<T>& b, uint8_t* o_row,
                                           int base, int J, int w,
                                           int lane) {
#pragma unroll
  for (int q = 0; q < kPerWorker; ++q) {
    const int i = (w + q * kWorkers) * 32 + lane;
    if (base + i < J) o_row[base + i] = b.ev[i];
  }
}

// One step of the chain: evict iff s > t, else add p. The add is issued
// beside the compare and the select keeps one.
template <typename T>
__device__ __forceinline__ bool step(T& s, T p, T t) {
  const bool ev = s > t;
  const T kept = s + p;
  s = ev ? s : kept;
  return ev;
}

// The chain over a tile's compacted entries, eight at a time, the next
// eight read into registers while the current ones run.
template <typename T>
__device__ __forceinline__ T chain(Buf<T>& b, T s) {
  const int n = b.n;
  Entry<T> cur[kAhead];
  uint16_t ci[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) cur[u] = b.ent[u], ci[u] = b.idx[u];
  for (int e = 0; e < n; e += kAhead) {
    Entry<T> nxt[kAhead];
    uint16_t ni[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      nxt[u] = b.ent[e + kAhead + u], ni[u] = b.idx[e + kAhead + u];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (step(s, cur[u].p, cur[u].t)) b.ev[ci[u]] = 1;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u], ci[u] = ni[u];
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    acd_evict_kernel(const T* __restrict__ P, const T* __restrict__ thresh,
                     const uint8_t* __restrict__ mask,
                     uint8_t* __restrict__ out, int J) {
  __shared__ Buf<T> buf[2];

  const size_t row = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(J);
  const T* p_row = P + row;
  const T* t_row = thresh + row;
  const uint8_t* m_row = mask + row;
  uint8_t* o_row = out + row;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp - 1;  // worker index
  const int tiles = (J + kTile - 1) / kTile;

  if (warp > 0) compact(buf[0], p_row, t_row, m_row, 0, J, w, lane);
  __syncthreads();
  T s = T(0);  // kept-demand sum; live in the chain thread only
  for (int i = 0; i < tiles; ++i) {
    if (warp == 0) {
      if (lane == 0) s = chain(buf[i & 1], s);
    } else {
      if (i > 0) write_back(buf[(i - 1) & 1], o_row, (i - 1) * kTile, J, w,
                            lane);
      if (i + 1 < tiles)
        compact(buf[(i + 1) & 1], p_row, t_row, m_row, (i + 1) * kTile, J, w,
                lane);
    }
    __syncthreads();
  }
  if (warp > 0)
    write_back(buf[(tiles - 1) & 1], o_row, (tiles - 1) * kTile, J, w, lane);
}

template <typename T>
int launch(const T* P, const T* thresh, const uint8_t* mask, uint8_t* out,
           int B, int J, void* stream) {
  if (B <= 0 || J <= 0) return 0;
  acd_evict_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, thresh, mask, out, J);
  return static_cast<int>(cudaGetLastError());
}

// n rounds of eight chain steps on one thread, operands in registers: the
// latency of one dependent float64 step (compare and add side by side,
// then the select) with nothing else on the path. cycles gets the SM
// clocks the loop took; out the final sum, so nothing is optimised away.
__global__ void chain_step_probe(const double* pt, int n, double* out,
                                 long long* cycles) {
  double p[kAhead], t[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) p[u] = pt[u], t[u] = pt[kAhead + u];
  double s = 0.0;
  const long long c0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) step(s, p[u], t[u]);
  }
  const long long c1 = clock64();
  out[0] = s;
  cycles[0] = c1 - c0;
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

// The chain floor's step latency: one thread runs n x 8 steps of the
// float64 chain on the 16 values of pt (p then thresh, device memory);
// out [1] double and cycles [1] int64 on the device get the sum and the
// loop's SM clocks. Returns the launch's cudaError_t.
extern "C" int acd_chain_step_probe(const double* pt, int n, double* out,
                                    long long* cycles, void* stream) {
  chain_step_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      pt, n, out, cycles);
  return static_cast<int>(cudaGetLastError());
}
