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
// dependent steps, each a P x C argmin, a wait, a cold test, a key, a P
// argmin and a clock write that the next step reads (the chain floor: the
// longest row's n_pub times one step's latency, fifo_chain_step_probe).
//
// What the design does about it. One block per row, so the rows run on
// separate SMs in parallel, and inside a row the chain thread does nothing
// that the pool does not force:
// - The pool in registers. Lane 0 of warp 0 keeps the [P, C] slot clocks
//   and idle stamps, and each provider's earliest-free slot, in registers
//   for P <= 3, C <= 2 (the engine's 3 x 2 among them), every index
//   unrolled and every choice a select; larger pools run the same chain
//   with the pool in shared memory.
// - A step that issues little. The chain thread is bound by the
//   instructions it issues, most of them 64-bit selects, and by its
//   dependent float64 operations, so a step computes what the next step
//   needs and nothing more: every provider's key and end, with ready +
//   wait a select between ready + d and ready + 0.0 and the
//   penalty computed for both values of the cold flag and selected (each
//   value the one the sequential expressions give); the provider argmin,
//   for three providers from their three comparisons at once; and only
//   the chosen provider's new earliest-free slot. When every provider is
//   capped (a flag the kernel reads), no select for an uncapped one is
//   issued. The step's outputs are left to the workers.
// - Workers gather ahead. The block's other warps gather the next tile of
//   chain steps (ready, dur, selc and occ of every provider at job
//   order[i], one 32-byte record per provider) into a two-tile ring while
//   the chain runs the current tile: one barrier per tile.
// - Workers precompute. An uncapped provider never waits and is never
//   cold, so its whole key, penalty, start and end do not depend on the
//   pool: the workers compute them with the chain's own expressions
//   (w = 0.0, cw = 0.0 * wu, so an infinite wu still gives NaN) and the
//   chain only selects.
// - No device memory on the chain. The chain thread reads step i + 1's
//   records while step i runs and writes each step's choice (provider,
//   slot clock and idle stamp) into the shared ring; a tile later the
//   workers compute the step's outputs from it with the chain's own
//   expressions (offer()) and store them. Worker wt stores only the
//   columns j with j % kW == wt, so it zero-fills those same columns while
//   the chain runs the first tile, before its first store: in its own
//   program order a visited column's output comes after its zero.
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
// launch is asynchronous on the given stream. fifo_chain_step_probe times
// the chain step alone (see there).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWorkers = 3;                   // gathering warps
constexpr int kThreads = 32 * (1 + kWorkers);  // + the chain's warp
constexpr int kTile = 128;                    // chain steps per tile
constexpr int kRegP = 3, kRegC = 2;  // largest pool kept in registers
constexpr size_t kSmemMax = 200 * 1024;

// running argmin over increasing indices (first index of the minimum, the
// first NaN if there is one): does the later value v replace best?
__device__ __forceinline__ bool argmin_takes(double v, double best) {
  // !isnan(best) && (isnan(v) || v < best), as two comparisons
  return best == best && !(v >= best);
}

// One provider's inputs at one chain step, gathered by the workers (two
// 16-byte loads). For a capped provider a, b, key, occ are ready, dur,
// selc, occ; for an uncapped one the start, end, key and penalty the
// workers computed with the chain's expressions (no pool value changes
// them).
struct alignas(16) StepIn {
  double a, b, key, occ;
};
// What one chain step chose: the provider and the clock and idle stamp
// of its earliest-free slot at that step, written by the chain thread into
// shared memory. A tile later the workers compute the step's outputs from
// it (offer(), the chain's expressions) and store them.
struct alignas(16) StepOut {
  double sc, idle;
  int prov, pad[3];
};

// The ring in dynamic shared memory: two tiles of [T][P] inputs, two of
// [T] outputs, two of [T] jobs (-1: skipped); then the general path's
// pool.
struct Ring {
  StepIn* in;
  StepOut* out;
  int* job;
};

__host__ __device__ size_t ring_bytes(int P, int T) {
  return 2 * static_cast<size_t>(T) *
         (P * sizeof(StepIn) + sizeof(StepOut) + sizeof(int));
}

__device__ __forceinline__ Ring ring(unsigned char* smem, int P, int T,
                                     int s) {
  StepIn* in = reinterpret_cast<StepIn*>(smem);
  StepOut* out = reinterpret_cast<StepOut*>(in + 2 * T * P);
  int* job = reinterpret_cast<int*>(out + 2 * T);
  return Ring{in + s * T * P, out + s * T, job + s * T};
}

// What one provider offers the job at the current step: its key, the
// slot it would take, and the outputs if it is chosen.
struct Offer {
  double key, w, pen, start, end;
  int si;
  bool cold;
};

// One provider's offer against its earliest-free slot (clock sc, idle
// stamp idle, index si), by the chain's expressions in their order: the
// general path's step.
template <bool kCold>
__device__ __forceinline__ Offer offer(double sc, double idle, int si,
                                       const StepIn& x, bool cap, double cw1,
                                       double cw0, double ka) {
  const double d = sc - x.a;
  const double w = !(d <= 0.0) ? d : 0.0;  // d > 0 or NaN: the wait is d
  const double rw = x.a + w;
  bool cp = false;
  if (kCold) cp = (rw - idle > ka) || (idle == -INFINITY);
  const double cw = cp ? cw1 : cw0;
  const double pen = x.occ * (w + cw);
  const double start = rw + cw;
  Offer f;
  f.key = cap ? x.key + pen : x.key;
  f.w = cap ? w : 0.0;
  f.pen = cap ? pen : x.occ;
  f.start = cap ? start : x.a;
  f.end = cap ? start + x.b : x.b;
  f.si = si;
  f.cold = cap && cp;
  return f;
}

// The earliest-free slot of a provider's clocks (first index on ties,
// the first NaN), with the clock and idle stamp of slot `at` taken as `v`
// (a slot that was just given a job's end).
template <int kC>
__device__ __forceinline__ void slot_min(const double (&clk)[kC],
                                         const double (&idl)[kC], int at,
                                         double v, double& sc, double& idle,
                                         int& si) {
  sc = at == 0 ? v : clk[0];
  idle = at == 0 ? v : idl[0];
  si = 0;
#pragma unroll
  for (int c = 1; c < kC; ++c) {
    const double x = at == c ? v : clk[c];
    const bool t = argmin_takes(x, sc);
    sc = t ? x : sc;
    idle = t ? (at == c ? v : idl[c]) : idle;
    si = t ? c : si;
  }
}

// The chain thread's pool in registers: slot clocks and idle stamps, each
// provider's earliest-free slot (sc, idle, si) carried from the step
// before, and its constants.
template <int kP, int kC>
struct Pool {
  double clk[kP][kC], idl[kP][kC], sc[kP], idle[kP], cw1[kP], cw0[kP];
  int si[kP];
  bool cap[kP];
};

// A provider's pool after it takes a job ending at `end`: its
// earliest-free slot gets the end as clock and idle stamp, and the next
// earliest-free slot is found.
template <int kC>
__device__ __forceinline__ void take_slot(double (&clk)[kC],
                                          double (&idl)[kC], double& sc,
                                          double& idle, int& si, double end) {
  const int at = si;
  slot_min<kC>(clk, idl, at, end, sc, idle, si);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    clk[c] = at == c ? end : clk[c];
    idl[c] = at == c ? end : idl[c];
  }
}

// One chain step on a pool held in registers: what the next step needs
// and nothing else. Every provider's key and end are the chain's
// expressions, with two of their parts taken as selects between values
// computed side by side: ready + wait (ready + d, or ready + 0.0 when the
// wait is 0.0) and the penalty (occ * (wait + cw) for both
// values of the cold flag); each selected value is the one the sequential
// expressions give, bit for bit. Then the provider argmin and, for the
// chosen provider only, its pool's new earliest-free slot. The step's
// outputs are the workers' (StepOut): sc_out and idle_out get the chosen
// provider's slot. A step that is not valid (a skipped job, whose records
// are stale) leaves the pool as it is. kAllCap: every provider is capped
// (no select for an uncapped one). Returns the chosen provider.
template <int kP, int kC, bool kCold, bool kAllCap>
__device__ __forceinline__ int reg_step(Pool<kP, kC>& pl,
                                        const StepIn (&x)[kP], bool valid,
                                        double ka, double& sc_out,
                                        double& idle_out) {
  double key[kP], end[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const double d = pl.sc[p] - x[p].a;
    const bool pos = !(d <= 0.0);  // d > 0 or NaN: the wait is d
    const double w = pos ? d : 0.0;
    const double rw = pos ? x[p].a + d : x[p].a + 0.0;  // ready + wait
    bool cp = false;
    if (kCold) cp = (rw - pl.idle[p] > ka) || (pl.idle[p] == -INFINITY);
    const double pen1 = x[p].occ * (w + pl.cw1[p]);
    const double pen0 = x[p].occ * (w + pl.cw0[p]);
    key[p] = (kAllCap || pl.cap[p]) ? x[p].key + (cp ? pen1 : pen0)
                                     : x[p].key;
    end[p] = (rw + (cp ? pl.cw1[p] : pl.cw0[p])) + x[p].b;  // start + dur
  }
  // the provider argmin, first index on ties and the first NaN: for three
  // providers from the three comparisons at once, the sequential scan's
  // answer (1 beats 0, then 2 beats the better of them)
  int bp = 0;
  if constexpr (kP == 3) {
    const bool t01 = argmin_takes(key[1], key[0]);
    const bool t02 = argmin_takes(key[2], key[0]);
    const bool t12 = argmin_takes(key[2], key[1]);
    bp = t01 ? (t12 ? 2 : 1) : (t02 ? 2 : 0);
  } else {
    double best = key[0];
#pragma unroll
    for (int p = 1; p < kP; ++p) {
      const bool take = argmin_takes(key[p], best);
      best = take ? key[p] : best;
      bp = take ? p : bp;
    }
  }
  sc_out = pl.sc[0];
  idle_out = pl.idle[0];
#pragma unroll
  for (int p = 1; p < kP; ++p) {
    sc_out = bp == p ? pl.sc[p] : sc_out;
    idle_out = bp == p ? pl.idle[p] : idle_out;
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if (valid && bp == p && (kAllCap || pl.cap[p])) {
      take_slot<kC>(pl.clk[p], pl.idl[p], pl.sc[p], pl.idle[p], pl.si[p],
                    end[p]);
    }
  }
  return bp;
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// kP == 0: any P and C, the pool in shared memory (pclk, pidl [P * C]).
template <int kP, int kC, bool kCold>
__global__ void __launch_bounds__(kThreads, 1)
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
                     int P, int J, int C, int T, double ka) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* pclk = reinterpret_cast<double*>(smem + ring_bytes(P, T));
  double* pidl = pclk + P * C;

  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * J;
  const size_t row_pj = static_cast<size_t>(b) * P * J;
  const size_t row_pc = static_cast<size_t>(b) * P * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wt = threadIdx.x - 32;  // worker thread index
  constexpr int kW = 32 * kWorkers;
  const int n = min(max(n_pub[b], 0), J);
  const int tiles = (n + T - 1) / T;

  // the workers' gather of tile t into ring t % 2, the uncapped
  // providers' values computed on the way
  auto gather = [&](int t) {
    const Ring g = ring(smem, P, T, t % 2);
    const int base = t * T, m = min(T, n - base);
    for (int x = wt; x < m * P; x += kW) {
      const int ii = x / P, p = x - ii * P;
      const int j = order[row + base + ii];
      const bool ok = j >= 0 && j < J;
      if (p == 0) g.job[ii] = ok ? j : -1;
      if (!ok) continue;
      const size_t at = row_pj + static_cast<size_t>(p) * J + j;
      const double r = ready[at], d = dur[at], sl = selc[at], oc = occ[at];
      StepIn v;
      if (capped[p] != 0) {
        v.a = r;
        v.b = d;
        v.key = sl;
        v.occ = oc;
      } else {  // the chain's expressions with wait 0 and cold false
        const double w = 0.0;
        const double cw = 0.0 * wu[p];
        const double pen = oc * (w + cw);
        const double start = (r + w) + cw;
        v.a = start;
        v.b = start + d;
        v.key = sl + pen;
        v.occ = pen;
      }
      g.in[x] = v;
    }
  };
  // the workers' stores of tile t's outputs to device memory: column j
  // by worker j % kW, in step order, so a column visited twice keeps its
  // later visit
  auto flush = [&](int t) {
    const Ring g = ring(smem, P, T, t % 2);
    const int m = min(T, n - t * T);
    for (int ii = 0; ii < m; ++ii) {
      const int j = g.job[ii];
      if (j < 0 || j % kW != wt) continue;
      const StepOut v = g.out[ii];
      const int p = v.prov;
      const StepIn& x = g.in[ii * P + p];
      const Offer f = offer<kCold>(v.sc, v.idle, 0, x, capped[p] != 0,
                                   1.0 * wu[p], 0.0 * wu[p], ka);
      prov_out[row + j] = p;
      seg_out[row + j] = seg[row_pj + static_cast<size_t>(p) * J + j];
      wait_out[row + j] = f.w;
      cold_out[row + j] = f.cold ? 1 : 0;
      start_out[row + j] = f.start;
      end_out[row + j] = f.end;
      extra_out[row + j] = f.pen;
    }
  };

  if (warp > 0) {
    if (kP == 0) {
      for (int i = wt; i < P * C; i += kW) {
        pclk[i] = sclk0[row_pc + i];
        pidl[i] = sidle0[row_pc + i];
      }
    }
    if (tiles > 0) gather(0);
  }
  __syncthreads();
  // every column zero-filled by the worker that stores it (flush), before
  // that worker's first store, while the chain runs tile 0
  if (warp > 0) {
    for (int j = wt; j < J; j += kW) {
      prov_out[row + j] = 0;
      seg_out[row + j] = 0;
      wait_out[row + j] = 0.0;
      cold_out[row + j] = 0;
      start_out[row + j] = 0.0;
      end_out[row + j] = 0.0;
      extra_out[row + j] = 0.0;
    }
  }

  // the chain thread's pool (registers; the general path's pool was
  // loaded by the workers)
  constexpr int RP = kP > 0 ? kP : 1, RC = kC > 0 ? kC : 1;
  Pool<RP, RC> pl;
  bool all = true;  // every provider capped: no select for an uncapped one
  if constexpr (kP > 0) {
    if (warp == 0 && lane == 0) {
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        pl.cap[p] = capped[p] != 0;
        all = all && pl.cap[p];
        pl.cw1[p] = 1.0 * wu[p];
        pl.cw0[p] = 0.0 * wu[p];
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          pl.clk[p][c] = sclk0[row_pc + p * C + c];
          pl.idl[p][c] = sidle0[row_pc + p * C + c];
        }
        slot_min<RC>(pl.clk[p], pl.idl[p], -1, 0.0, pl.sc[p], pl.idle[p],
                     pl.si[p]);
      }
    }
  }

  // tile t's chain: inputs from ring t % 2, outputs into it; all_cap a
  // Flag<every provider capped>
  auto chain = [&](int t, auto all_cap) {
    constexpr bool kAllCap = decltype(all_cap)::value;
    const Ring g = ring(smem, P, T, t % 2);
    const int m = min(T, n - t * T);
    if constexpr (kP > 0) {
      // step ii's records in registers, step ii + 1's read while it runs;
      // a skipped step (job < 0) runs too, its pool update predicated off
      // (a branch around the step cost a fifth of the kernel's time)
      StepIn x[RP], nx[RP];
      int job = g.job[0], nj;
#pragma unroll
      for (int p = 0; p < RP; ++p) x[p] = g.in[p];
#pragma unroll 2
      for (int ii = 0; ii < m; ++ii) {
        const int next = min(ii + 1, m - 1);
        nj = g.job[next];
#pragma unroll
        for (int p = 0; p < RP; ++p) nx[p] = g.in[next * RP + p];
        StepOut v;
        v.prov = reg_step<RP, RC, kCold, kAllCap>(pl, x, job >= 0, ka, v.sc,
                                                  v.idle);
        g.out[ii] = v;
#pragma unroll
        for (int p = 0; p < RP; ++p) x[p] = nx[p];
        job = nj;
      }
    } else {
      for (int ii = 0; ii < m; ++ii) {
        if (g.job[ii] < 0) continue;
        Offer best;
        StepOut v;
        int bp = 0;
        for (int p = 0; p < P; ++p) {
          const double* ck = pclk + p * C;
          double sc = ck[0];
          int si = 0;
          for (int c = 1; c < C; ++c) {
            if (argmin_takes(ck[c], sc)) {
              sc = ck[c];
              si = c;
            }
          }
          const double idle = pidl[p * C + si];
          const Offer f = offer<kCold>(sc, idle, si, g.in[ii * P + p],
                                       capped[p] != 0, 1.0 * wu[p],
                                       0.0 * wu[p], ka);
          if (p == 0 || argmin_takes(f.key, best.key)) {
            best = f;
            bp = p;
            v.sc = sc;
            v.idle = idle;
          }
        }
        v.prov = bp;
        g.out[ii] = v;
        if (capped[bp] != 0) {
          pclk[bp * C + best.si] = best.end;
          pidl[bp * C + best.si] = best.end;
        }
      }
    }
  };

  // the chain runs tile t while the workers store tile t - 1's outputs
  // and then gather tile t + 1 into the ring tile t - 1 used
  for (int t = 0; t < tiles; ++t) {
    if (warp == 0) {
      if (lane == 0) {
        if (all) {
          chain(t, Flag<true>{});
        } else {
          chain(t, Flag<false>{});
        }
      }
    } else {
      if (t > 0) flush(t - 1);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kW) : "memory");
      if (t + 1 < tiles) gather(t + 1);
    }
    __syncthreads();
  }
  if (warp > 0 && tiles > 0) flush(tiles - 1);
}

// n steps of the chain on a 3 x 2 pool in registers, every provider
// capped, cold starts on: the latency of one dependent step with nothing
// else on the path. in holds 12 pool values (clocks, then idle stamps),
// then per provider a, b, key, occ, then wu; cycles gets the SM clocks the
// loop took, out the final pool, so nothing is optimised away.
__global__ void chain_step_probe(const double* in, int n, double ka,
                                 double* out, long long* cycles) {
  Pool<3, 2> pl;
  StepIn x[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      pl.clk[p][c] = in[p * 2 + c];
      pl.idl[p][c] = in[6 + p * 2 + c];
    }
    x[p].a = in[12 + 4 * p];
    x[p].b = in[13 + 4 * p];
    x[p].key = in[14 + 4 * p];
    x[p].occ = in[15 + 4 * p];
    pl.cw1[p] = 1.0 * in[24 + p];
    pl.cw0[p] = 0.0 * in[24 + p];
    pl.cap[p] = true;
    slot_min<2>(pl.clk[p], pl.idl[p], -1, 0.0, pl.sc[p], pl.idle[p],
                pl.si[p]);
  }
  int picks = 0;
  double sink = 0.0;
  const long long c0 = clock64();
  for (int i = 0; i < n; ++i) {
    double sc, idle;
    picks += reg_step<3, 2, true, true>(pl, x, true, ka, sc, idle);
    sink = sc;
  }
  const long long c1 = clock64();
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int c = 0; c < 2; ++c) out[p * 2 + c] = pl.clk[p][c] + pl.idl[p][c];
  }
  out[6] = picks + sink;
  cycles[0] = c1 - c0;
}

template <int kP, int kC, bool kCold>
int launch(const int* order, const int* n_pub, const double* ready,
           const double* dur, const double* selc, const double* occ,
           const int* seg, const uint8_t* capped, const double* wu,
           const double* sclk0, const double* sidle0, int* prov_out,
           int* seg_out, double* wait_out, uint8_t* cold_out,
           double* start_out, double* end_out, double* extra_out, int B,
           int P, int J, int C, double ka, cudaStream_t s) {
  const size_t fixed = kP == 0 ? 2 * sizeof(double) * P * C : 0;
  int T = kTile;
  while (T > 1 && ring_bytes(P, T) + fixed > kSmemMax) T /= 2;
  const size_t smem = ring_bytes(P, T) + fixed;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fifo_dispatch_kernel<kP, kC, kCold>;
  static size_t opted = 0;  // dynamic shared memory already allowed
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  kernel<<<B, kThreads, smem, s>>>(
      order, n_pub, ready, dur, selc, occ, seg, capped, wu, sclk0, sidle0,
      prov_out, seg_out, wait_out, cold_out, start_out, end_out, extra_out,
      P, J, C, T, ka);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const int*, const int*, const double*,
                         const double*, const double*, const double*,
                         const int*, const uint8_t*, const double*,
                         const double*, const double*, int*, int*, double*,
                         uint8_t*, double*, double*, double*, int, int, int,
                         int, double, cudaStream_t);

template <bool kCold>
LaunchFn pick(int P, int C) {
  static const LaunchFn reg[kRegP][kRegC] = {
      {launch<1, 1, kCold>, launch<1, 2, kCold>},
      {launch<2, 1, kCold>, launch<2, 2, kCold>},
      {launch<3, 1, kCold>, launch<3, 2, kCold>}};
  if (P <= kRegP && C <= kRegC) return reg[P - 1][C - 1];
  return launch<0, 0, kCold>;
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
  const LaunchFn fn = cold ? pick<true>(P, C) : pick<false>(P, C);
  return fn(order, n_pub, ready, dur, selc, occ, seg, capped, wu, sclk0,
            sidle0, prov_out, seg_out, wait_out, cold_out, start_out,
            end_out, extra_out, B, P, J, C, keep_alive,
            static_cast<cudaStream_t>(stream));
}

// The chain floor's step latency: one thread runs n steps of the 3 x 2
// chain, every provider capped, cold starts on (keep_alive ka), on the 27
// values of in (device memory: see chain_step_probe); out [7] double and
// cycles [1] int64 on the device get the pool and the loop's SM clocks.
// Returns the launch's cudaError_t.
extern "C" int fifo_chain_step_probe(const double* in, int n, double ka,
                                     double* out, long long* cycles,
                                     void* stream) {
  chain_step_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      in, n, ka, out, cycles);
  return static_cast<int>(cudaGetLastError());
}
