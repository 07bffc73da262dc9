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
//   suffix-summed here);
//   G = F[k+1]; take = clip(target[j] - cur - G, 0, F - G); selend += take;
//   taken = min(max(target[j] - cur, 0), F[0]); F -= min(taken, F);
//   emit selend[0] (or the take vector); cur += taken - selend[0]; shift.
// Carries enter and leave in avail form (avail[k] = F[k] - F[k+1]).
//
// What bounds it on the H100. Positions are strictly sequential within a
// row: the step is a chain of ~10 dependent integer ops plus the warp
// shuffles of the scan, the broadcasts and the shift. It moves L * 4 bytes
// of arrivals per position (1 KB at L = 256), far below what the memory
// system gives one warp, so it is latency-bound. With one warp per row it
// occupies S of the 132 SMs: the dense engine (S = 1) keeps one SM busy.
// That is the algorithm, a sequential greedy, not a defect of the kernel.
//
// What the design does about it. One warp per row, no block-wide barriers.
// Lane l owns the SS = L/32 consecutive ring slots l*SS..l*SS+SS-1 in
// registers, so F[k+1] is a register move except at the lane edge (one
// __shfl_down), F[0] and selend[0] are one __shfl each and the shift is a
// register move plus one shuffle per ring. The arrival rows stream through
// a ring of R rows in shared memory filled by cp.async, each lane copying
// (and later reading) only its own SS slots, so the loads run R - 1
// positions ahead of the sweep and no lane waits on another's copy. The
// suffix sums of an arrival row (which the TPU wrapper took outside the
// kernel, pallas_sweep.py:141-143) are a warp suffix scan in registers of
// the row the warp loads anyway: no extra (S, n, L) pass through memory.
// The targets are staged 256 positions at a time in shared memory.
//
// Preconditions: rows, takes 16-byte aligned (the wrapper checks); L one
// of 32, 64, 128, 256, 384, 512, 640, 768; arrival counts and targets
// non-negative.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_slots.cuh"

namespace {

using gd::cp_async_commit;
using gd::cp_async_slots;
using gd::cp_async_wait;
using gd::kFull;
using gd::load_slots;

constexpr int kTgtStage = 256;  // targets staged per refill

// in place: a[j] <- sum of the warp's slots >= this lane's slot j (lane l
// owns slots l*SS..); returns nothing, the row total is lane 0's a[0]
template <int SS>
__device__ __forceinline__ void warp_suffix(int (&a)[SS], int lane) {
  int tot = 0;
#pragma unroll
  for (int j = SS - 1; j >= 0; --j) {
    tot += a[j];
    a[j] = tot;
  }
  int inc = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_down_sync(kFull, inc, o);
    if (lane + o < 32) inc += v;
  }
  const int above = inc - tot;
#pragma unroll
  for (int j = 0; j < SS; ++j) a[j] += above;
}

template <int SS, bool TAKES>
__global__ void __launch_bounds__(32) dense_sweep_kernel(
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
  // rows in flight: 16 for L <= 256, 8 above (24 KB of ring at L = 768)
  constexpr int R = L <= 256 ? 16 : 8;
  constexpr int P = R - 1;  // prefetch distance in positions
  auto nxt_slot = [](int j) { return j + 1 < SS ? j + 1 : SS - 1; };
  __shared__ __align__(16) int32_t ring[R][L];
  __shared__ int32_t tgt_s[kTgtStage];

  const int64_t s = blockIdx.x;
  const int lane = threadIdx.x;
  const int k0 = lane * SS;
  const int32_t* __restrict__ row_s = rows + s * n * L + k0;

  // ---- carries in: avail form -> suffix form; cur = sum(selend)
  int F[SS], Se[SS];
#pragma unroll
  for (int j = 0; j < SS; ++j) {
    F[j] = avail0[s * L + k0 + j];
    Se[j] = selend0[s * L + k0 + j];
  }
  warp_suffix<SS>(F, lane);
  int cur = gd::warp_sum<SS>(Se);

  // ---- prime the row pipeline: one commit group per position, empty past n
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    if (p < n) cp_async_slots<SS>(&ring[p % R][k0], row_s + (int64_t)p * L);
    cp_async_commit();
  }

#pragma unroll 1
  for (int64_t j = 0; j < n; ++j) {
    if (j % kTgtStage == 0) {  // warp-uniform: refill the target stage
      __syncwarp();
      for (int i = lane; i < kTgtStage && j + i < n; i += 32)
        tgt_s[i] = target[s * n + j + i];
      __syncwarp();
    }
    const int64_t jp = j + P;
    if (jp < n) cp_async_slots<SS>(&ring[jp % R][k0], row_s + jp * L);
    cp_async_commit();
    cp_async_wait<P>();  // this lane's copy of row j has landed

    int add[SS];
    load_slots<SS>(&ring[j % R][k0], add);
    warp_suffix<SS>(add, lane);

    // ---- one sweep step
#pragma unroll
    for (int i = 0; i < SS; ++i) F[i] += add[i];
    const int tgt = tgt_s[j % kTgtStage];
    int nxt = __shfl_down_sync(kFull, F[0], 1);
    if (lane == 31) nxt = 0;
    const int F0 = __shfl_sync(kFull, F[0], 0);
    const int deficit = tgt - cur;
    const int taken = min(max(deficit, 0), F0);
    int tk[SS];
#pragma unroll
    for (int i = 0; i < SS; ++i) {
      const int G = (i + 1 < SS) ? F[nxt_slot(i)] : nxt;
      tk[i] = min(max(deficit - G, 0), F[i] - G);
      Se[i] += tk[i];
    }
    if (TAKES) {
      int32_t* t = takes + (s * n + j) * L + k0;
      if constexpr (SS % 4 == 0) {
#pragma unroll
        for (int i = 0; i < SS / 4; ++i)
          reinterpret_cast<int4*>(t)[i] =
              make_int4(tk[4 * i], tk[4 * i + 1], tk[4 * i + 2], tk[4 * i + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < SS; ++i) t[i] = tk[i];
      }
    }
#pragma unroll
    for (int i = 0; i < SS; ++i) F[i] -= min(taken, F[i]);
    const int em = __shfl_sync(kFull, Se[0], 0);
    if (!TAKES && lane == 0) out[s * n + j] = em;
    cur += taken - em;
    gd::shift_down<SS>(F, Se, lane);  // both rings one slot toward k = 0
  }
  cp_async_wait<0>();

  // ---- carries out: suffix form -> avail form
  int nf = __shfl_down_sync(kFull, F[0], 1);
  if (lane == 31) nf = 0;
#pragma unroll
  for (int i = 0; i < SS; ++i) {
    const int g = (i + 1 < SS) ? F[nxt_slot(i)] : nf;
    availf[s * L + k0 + i] = F[i] - g;
    selendf[s * L + k0 + i] = Se[i];
  }
}

template <int SS>
cudaError_t launch_ss(const int32_t* rows, const int32_t* target,
                      const int32_t* avail0, const int32_t* selend0,
                      int32_t* out, int32_t* takes, int32_t* availf,
                      int32_t* selendf, int64_t S, int64_t n,
                      bool takes_mode, cudaStream_t stream) {
  if (takes_mode) {
    dense_sweep_kernel<SS, true><<<(unsigned)S, 32, 0, stream>>>(
        rows, target, avail0, selend0, out, takes, availf, selendf, n);
  } else {
    dense_sweep_kernel<SS, false><<<(unsigned)S, 32, 0, stream>>>(
        rows, target, avail0, selend0, out, takes, availf, selendf, n);
  }
  return cudaGetLastError();
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
