// Kernel A: the dense water-filling sweep over S independent rows, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_sweep_kernel` driven by `pallas_sweep_counts`
// in genome_downsampler_tpu/ops/pallas_sweep.py, with a row axis added: S = 1
// is the dense engine, S = W the windowed solver's windows, S = #samples the
// batched solver. In takes mode it emits the per-position take vector of
// `sweep_counts_with_takes` (solvers/device_sweep.py) instead of selend[0].
//
// What it computes. Row s is swept over its n positions from its carry-in.
// The state is the suffix form of the avail ring, F[k] = # unselected reads
// covering the position whose end is k positions ahead or further, plus the
// selected ring selend[k] and the warp-uniform cur = sum(selend). Per
// position j:
//   fold in the arrival row (reads starting at j, raw (k = span - 1) form,
//   suffix-summed over k);
//   G = F[k+1]; take = clip(target[j] - cur - G, 0, F - G); selend += take;
//   taken = min(max(target[j] - cur, 0), F[0]); F -= min(taken, F);
//   emit selend[0] (or the take vector); cur += taken - selend[0]; shift.
// Carries enter and leave in avail form (avail[k] = F[k] - F[k+1]).
//
// What bounds it on the H100. Positions are strictly sequential within a
// row, so the time is one warp's loop-carried chain per position: the
// state's dependent integer ops and warp shuffles (the F[k+1] neighbour,
// the F[0] and selend[0] broadcasts, the two-shuffle shift). The bytes are
// L * 4 of arrivals per position (1 KB at L = 256) and the operations 8 per
// slot, both far below what one SM gives, so it is latency-bound, on S of
// the 132 SMs (the dense engine, S = 1, keeps one SM busy). That is the
// algorithm, a sequential greedy, not a defect of the kernel.
//
// What the design does about it. Everything that does not depend on the
// state leaves the chain (the design of kernel B, blocked_sweep.cu). One
// CTA per row, warp-specialised: warp 0 sweeps; warps 1-3 (the producers)
// prepare the next chunk of P positions while warp 0 sweeps the current
// one, into a double buffer of dynamic shared memory, handed over by named
// barriers (FULL: producers -> sweep warp, EMPTY: sweep warp -> producers;
// the producers meet among themselves at a third). Per chunk the producers
//   - copy the chunk's raw rows (contiguous in HBM, P * L * 4 bytes) with
//     16-byte cp.async;
//   - suffix-sum each row over k in place, one warp per row, in int32
//     (nothing bounds the counts of a dense row);
//   - stage the chunk's targets;
//   - flush the sweep warp's emitted counts of a finished chunk to `out`
//     with coalesced stores.
// Lane l of warp 0 owns the SS = L/32 consecutive ring slots
// l*SS..l*SS+SS-1 in registers, and per position reads its SS slots of the
// summed row and the target, issued one position ahead; runs the step
// (gd::sweep_step, shared with kernel B); and writes selend[0] to a shared
// buffer from every lane (same address, same value: no branch, no global
// address). In takes mode the sweep warp stores its slots' takes straight
// to `takes` (16-byte stores) and nothing is flushed. No scan, no copy
// wait and no divergent store stays on the chain. P is the largest power
// of two up to 512 for which the two int32 (P, L) buffers fit 192 KB:
// 512 positions at L = 32, 64 at L = 256 and 384, 32 at L = 512 to 768.
//
// Preconditions: rows, takes 16-byte aligned (the wrapper checks); L one
// of 32, 64, 128, 256, 384, 512, 640, 768; arrival counts and targets
// non-negative.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_slots.cuh"

namespace {

using gd::bar_arrive;
using gd::bar_sync;

constexpr int kProducerWarps = 3;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = 32 + kProducers;
// named barriers (0 is __syncthreads): FULL and EMPTY per buffer, and one
// among the producers
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;
constexpr int kBarProducers = 5;

// positions per chunk: two int32 (P, L) buffers within 192 KB
__host__ __device__ constexpr int chunk_positions(int L) {
  int p = 512;
  while (2 * p * L * 4 > 192 * 1024) p >>= 1;
  return p;
}

// The sweep state of one row, in registers: F is the suffix form of the
// avail ring (F[k] = # unselected reads covering the position whose end is
// k positions ahead or further), Se the selected ring selend[k]. The row's
// carries in (avail form) -> F and Se; returns cur = sum(selend), the
// selected reads covering the position (warp-uniform).
template <int SS>
__device__ __forceinline__ int load_carries(const int32_t* __restrict__ avail0,
                                            const int32_t* __restrict__ selend0,
                                            int (&F)[SS], int (&Se)[SS],
                                            int lane) {
  const int k0 = lane * SS;
#pragma unroll
  for (int j = 0; j < SS; ++j) {
    F[j] = avail0[k0 + j];
    Se[j] = selend0[k0 + j];
  }
  gd::warp_suffix<SS>(F, lane);
  return gd::warp_sum<SS>(Se);
}

// F and Se -> carries out, avail form (avail[k] = F[k] - F[k+1])
template <int SS>
__device__ __forceinline__ void store_carries(const int (&F)[SS],
                                              const int (&Se)[SS],
                                              int32_t* __restrict__ availf,
                                              int32_t* __restrict__ selendf,
                                              int lane) {
  const int k0 = lane * SS;
  int nf = __shfl_down_sync(gd::kFull, F[0], 1);
  if (lane == 31) nf = 0;
#pragma unroll
  for (int j = 0; j < SS; ++j) {
    const int g = (j + 1 < SS) ? F[gd::next_slot(j, SS)] : nf;
    availf[k0 + j] = F[j] - g;
    selendf[k0 + j] = Se[j];
  }
}

// warp 0: the sweep over every chunk, from the carries in to the carries out
template <int SS, bool TAKES>
__device__ __forceinline__ void sweep_warp(
    const int32_t* tile, const int32_t* tgt_s, int32_t* out_s,
    const int32_t* __restrict__ avail0, const int32_t* __restrict__ selend0,
    int32_t* __restrict__ takes, int32_t* __restrict__ availf,
    int32_t* __restrict__ selendf, int64_t s, int64_t n, int lane) {
  constexpr int L = 32 * SS;
  constexpr int P = chunk_positions(L);
  const int k0 = lane * SS;
  int F[SS], Se[SS];
  int cur = load_carries<SS>(avail0 + s * L, selend0 + s * L, F, Se, lane);

  const int64_t nchunks = (n + P - 1) / P;
#pragma unroll 1
  for (int64_t c = 0; c < nchunks; ++c) {
    const int buf = static_cast<int>(c & 1);
    const int len = static_cast<int>(n - c * P < P ? n - c * P : P);
    bar_sync(kBarFull + buf, kThreads);
    const int32_t* rw = tile + buf * P * L + k0;
    const int32_t* tg = tgt_s + buf * P;
    int32_t* em_s = out_s + buf * P;
    int add[SS];
    gd::load_slots<SS>(rw, add);
    int tgt = tg[0];
#pragma unroll 1
    for (int b = 0; b < len; ++b) {
      // the next position's arrivals and target: off the state
      const int bn = b + 1 < len ? b + 1 : b;
      int nadd[SS];
      gd::load_slots<SS>(rw + bn * L, nadd);
      const int ntgt = tg[bn];
      int tk[SS];
      const int em = gd::sweep_step<SS>(F, Se, add, tgt, cur, lane, tk);
      if constexpr (TAKES) {
        int32_t* t = takes + (s * n + c * P + b) * L + k0;
        if constexpr (SS % 4 == 0) {
#pragma unroll
          for (int i = 0; i < SS / 4; ++i)
            reinterpret_cast<int4*>(t)[i] =
                make_int4(tk[4 * i], tk[4 * i + 1], tk[4 * i + 2], tk[4 * i + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < SS; ++i) t[i] = tk[i];
        }
      } else {
        em_s[b] = em;  // every lane: one address, one value
      }
      gd::shift_down<SS>(F, Se, lane);
#pragma unroll
      for (int j = 0; j < SS; ++j) add[j] = nadd[j];
      tgt = ntgt;
    }
    bar_arrive(kBarEmpty + buf, kThreads);
  }
  store_carries<SS>(F, Se, availf + s * L, selendf + s * L, lane);
}

// warps 1..kProducerWarps: summed rows, targets and the output of every chunk
template <int SS, bool TAKES>
__device__ __forceinline__ void produce(
    int32_t* tile, int32_t* tgt_s, const int32_t* out_s,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ target,
    int32_t* __restrict__ out, int64_t s, int64_t n) {
  constexpr int L = 32 * SS;
  constexpr int P = chunk_positions(L);
  const int pt = threadIdx.x - 32;  // 0..kProducers-1
  const int pw = pt >> 5;           // producer warp
  const int lane = pt & 31;
  const int32_t* __restrict__ row_s = rows + s * n * L;
  const int64_t nchunks = (n + P - 1) / P;
  auto chunk_len = [&](int64_t c) {
    return static_cast<int>(n - c * P < P ? n - c * P : P);
  };
  auto flush = [&](int64_t c) {  // chunk c's emitted counts -> out
    if constexpr (!TAKES) {
      const int32_t* src = out_s + (c & 1) * P;
      int32_t* dst = out + s * n + c * P;
      for (int i = pt; i < chunk_len(c); i += kProducers) dst[i] = src[i];
    }
  };

#pragma unroll 1
  for (int64_t c = 0; c < nchunks; ++c) {
    const int buf = static_cast<int>(c & 1);
    const int len = chunk_len(c);
    int32_t* tb = tile + buf * P * L;
    if (c >= 2) {  // chunk c - 2 left this buffer
      bar_sync(kBarEmpty + buf, kThreads);
      flush(c - 2);
    }
    // ---- the chunk's raw rows: len * L contiguous ints, 16 bytes a copy
    {
      const int32_t* src = row_s + c * P * L;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(tb));
      for (int i = pt; i < len * L / 4; i += kProducers)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * i),
                     "l"(src + 4 * i)
                     : "memory");
      gd::cp_async_commit();
      gd::cp_async_wait<0>();
    }
    bar_sync(kBarProducers, kProducers);
    // ---- suffix sums over k, in place: one producer warp per row
    for (int b = pw; b < len; b += kProducerWarps) {
      int32_t* row = tb + b * L + lane * SS;
      int a[SS];
      gd::load_slots<SS>(row, a);
      gd::warp_suffix<SS>(a, lane);
      gd::store_slots<SS>(row, a);
    }
    // ---- the chunk's targets
    {
      const int32_t* src = target + s * n + c * P;
      int32_t* tg = tgt_s + buf * P;
      for (int i = pt; i < len; i += kProducers) tg[i] = src[i];
    }
    bar_arrive(kBarFull + buf, kThreads);
  }

  // ---- the last chunks' output
  for (int64_t c = nchunks > 2 ? nchunks - 2 : 0; c < nchunks; ++c) {
    bar_sync(kBarEmpty + static_cast<int>(c & 1), kThreads);
    flush(c);
  }
}

template <int SS, bool TAKES>
__global__ void __launch_bounds__(kThreads) dense_sweep_kernel(
    const int32_t* __restrict__ rows,     // [S, n, L] raw arrival rows
    const int32_t* __restrict__ target,   // [S, n]
    const int32_t* __restrict__ avail0,   // [S, L]
    const int32_t* __restrict__ selend0,  // [S, L]
    int32_t* __restrict__ out,            // [S, n], unused if TAKES
    int32_t* __restrict__ takes,          // [S, n, L], unused unless TAKES
    int32_t* __restrict__ availf,         // [S, L]
    int32_t* __restrict__ selendf,        // [S, L]
    int64_t n) {
  constexpr int L = 32 * SS;
  constexpr int P = chunk_positions(L);
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tile = reinterpret_cast<int32_t*>(smem);  // [2][P][L]
  int32_t* tgt_s = tile + 2 * P * L;                 // [2][P]
  int32_t* out_s = tgt_s + 2 * P;                    // [2][P]

  const int64_t s = blockIdx.x;
  if (threadIdx.x < 32) {
    sweep_warp<SS, TAKES>(tile, tgt_s, out_s, avail0, selend0, takes, availf,
                          selendf, s, n, threadIdx.x);
  } else {
    produce<SS, TAKES>(tile, tgt_s, out_s, rows, target, out, s, n);
  }
}

template <int SS, bool TAKES>
cudaError_t launch_mode(const int32_t* rows, const int32_t* target,
                        const int32_t* avail0, const int32_t* selend0,
                        int32_t* out, int32_t* takes, int32_t* availf,
                        int32_t* selendf, int64_t S, int64_t n,
                        cudaStream_t stream) {
  constexpr int L = 32 * SS;
  constexpr int P = chunk_positions(L);
  const size_t smem = sizeof(int32_t) * (2 * P * L + 4 * P);
  auto kernel = dense_sweep_kernel<SS, TAKES>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)S, kThreads, smem, stream>>>(
      rows, target, avail0, selend0, out, takes, availf, selendf, n);
  return cudaGetLastError();
}

template <int SS>
cudaError_t launch_ss(const int32_t* rows, const int32_t* target,
                      const int32_t* avail0, const int32_t* selend0,
                      int32_t* out, int32_t* takes, int32_t* availf,
                      int32_t* selendf, int64_t S, int64_t n,
                      bool takes_mode, cudaStream_t stream) {
  if (takes_mode)
    return launch_mode<SS, true>(rows, target, avail0, selend0, out, takes,
                                 availf, selendf, S, n, stream);
  return launch_mode<SS, false>(rows, target, avail0, selend0, out, takes,
                                availf, selendf, S, n, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). L must be one of
// 32, 64, 128, 256, 384, 512, 640, 768; out is written unless takes_mode,
// takes only in takes_mode (either may be null when n = 0).
extern "C" int gd_dense_sweep(const void* rows, const void* target,
                              const void* avail0, const void* selend0,
                              void* out, void* takes, void* availf,
                              void* selendf, int64_t S, int64_t n, int64_t L,
                              int64_t takes_mode, void* stream) {
  if (S < 1 || S > 2147483647 || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0 && (takes_mode ? takes == nullptr : out == nullptr))
    return (int)cudaErrorInvalidValue;
  auto r = static_cast<const int32_t*>(rows);
  auto tg = static_cast<const int32_t*>(target);
  auto a0 = static_cast<const int32_t*>(avail0);
  auto s0 = static_cast<const int32_t*>(selend0);
  auto o = static_cast<int32_t*>(out);
  auto tk = static_cast<int32_t*>(takes);
  auto af = static_cast<int32_t*>(availf);
  auto sf = static_cast<int32_t*>(selendf);
  auto st = static_cast<cudaStream_t>(stream);
  const bool tm = takes_mode != 0;
#define GD_CASE(SS)                                                          \
  case 32 * SS:                                                              \
    return (int)launch_ss<SS>(r, tg, a0, s0, o, tk, af, sf, S, n, tm, st);
  switch (L) {
    GD_CASE(1)
    GD_CASE(2)
    GD_CASE(4)
    GD_CASE(8)
    GD_CASE(12)
    GD_CASE(16)
    GD_CASE(20)
    GD_CASE(24)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GD_CASE
}
