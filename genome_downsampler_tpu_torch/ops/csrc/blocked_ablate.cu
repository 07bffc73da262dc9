// The ablation kernel of the blocked sweep: kernel B's step over W
// independent windows with pieces removed one at a time, to attribute its
// time per position, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `make_kernel` of
// scripts/bench_kernel_ablate.py (launched by `run_mode`), an ablation of
// kernel B (`_blocked_kernel`, ops/pallas_blocked.py; here
// blocked_sweep.cu). Only `full` is a correct sweep: of W independent
// windows from zero carries, with no carry between windows.
//
// What it computes. Per window, per block of B positions: an arrival tile
// tile[b][k] = # reads starting at b with span k + 1, from the window's
// codes start_rel * L + span - 1 (-1 pads count nothing), with lane L-1
// then overwritten by the target of position b; cur re-synced to
// sum(selend). Per position b, in avail form:
//   tgt = tile[b][L-1]; avail += tile[b] with lane L-1 masked
//     (so reads of span L count nowhere);      -- addonly stops here
//   deficit = tgt - cur;
//   take = clip(deficit - (stock above k), 0, avail); avail -= take;
//     selend += take; cur += min(max(deficit, 0), total);  -- not in notake
//   emit selend[0] to out;                     -- not in noemit
//   shift both rings one slot;                 -- not in noroll
//   cur -= selend[0].
// tileonly builds the tiles and sweeps nothing; emptyloop builds them and
// runs a loop of B counter steps per block. out is written only by full,
// notake and noroll (the wrapper zeroes it for the others); the carries
// out are the state after the last block in every mode.
//
// What bounds it on the H100. The sweep is kernel B's: a chain of
// dependent integer ops and warp shuffles per position, strictly
// sequential within a window, one warp per window. The tile build is
// parallel and short: B * L * 4 bytes of shared memory zeroed and cap
// shared-memory atomics per block of B positions.
//
// What the design does about it. One CTA of kThreads threads per window
// loops over the window's blocks. All threads build the (B, L) tile in
// shared memory (zero, scatter the codes with shared atomics, write the
// targets: the TPU kernel's one-hot MXU product is a stand-in for this
// scatter), then warp 0 sweeps it with lane l owning the SS = L/32 slots
// l*SS.. in registers, as kernel B does. Each mode is its own template
// instantiation, compiled without the pieces it removes; the empty loop
// keeps its counter in an asm operand, so that it is not folded into one
// add, and stores it, so that it is not deleted.
//
// Preconditions: codes in [0, B * L) or negative (pads); B * L * 4 bytes
// within the shared memory a block may use (the wrapper checks); L one of
// 32, 64, 128, 256.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_slots.cuh"

namespace {

using gd::kFull;

constexpr int kThreads = 128;
// modes, in the order of the wrapper's MODES
enum Mode { kFullMode, kNoTake, kNoRoll, kNoEmit, kAddOnly, kTileOnly, kEmptyLoop };

template <int SS, int MODE>
__global__ void __launch_bounds__(kThreads) blocked_ablate_kernel(
    const int32_t* __restrict__ packed,  // [nbw, W, cap]
    const int32_t* __restrict__ target,  // [W, nbw * B]
    int32_t* __restrict__ out,           // [W, nbw * B]
    int32_t* __restrict__ availf,        // [W, L]
    int32_t* __restrict__ selendf,       // [W, L]
    int64_t nbw, int64_t W, int64_t cap, int B) {
  constexpr int L = 32 * SS;
  extern __shared__ __align__(16) int32_t tile[];  // [B][L]

  const int64_t w = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int k0 = lane * SS;
  const int64_t win = nbw * B;

  int A[SS], Se[SS];  // warp 0's rings
#pragma unroll
  for (int i = 0; i < SS; ++i) A[i] = Se[i] = 0;

#pragma unroll 1
  for (int64_t t = 0; t < nbw; ++t) {
    // ---- the arrival tile of this window's block t
    int4* t4 = reinterpret_cast<int4*>(tile);
    for (int i = tid; i < B * L / 4; i += kThreads) t4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    const int32_t* __restrict__ g = packed + (t * W + w) * cap;
    for (int64_t i = tid; i < cap; i += kThreads) {
      const int c = g[i];
      if (c >= 0 && c < B * L) atomicAdd(&tile[c], 1);
    }
    __syncthreads();
    for (int b = tid; b < B; b += kThreads)
      tile[b * L + L - 1] = target[w * win + t * B + b];
    __syncthreads();

    if (MODE != kTileOnly && tid < 32) {
      int32_t* __restrict__ o = out + w * win + t * B;
      int cur = gd::warp_sum<SS>(Se);  // re-synced once per block
#pragma unroll 1
      for (int b = 0; b < B; ++b) {
        if constexpr (MODE == kEmptyLoop) {
          cur += 1;
          asm volatile("" : "+r"(cur));
          continue;
        }
        int add[SS];
        gd::load_slots<SS>(&tile[b * L + k0], add);
        const int tgt = tile[b * L + L - 1];
        if (lane == 31) add[SS - 1] = 0;  // lane L-1 is the target
#pragma unroll
        for (int i = 0; i < SS; ++i) A[i] += add[i];
        if constexpr (MODE == kAddOnly) continue;
        const int deficit = tgt - cur;
        if constexpr (MODE != kNoTake) {
          int cs[SS];
#pragma unroll
          for (int i = 0; i < SS; ++i) cs[i] = A[i];
          const int total = gd::warp_prefix<SS>(cs, lane);
#pragma unroll
          for (int i = 0; i < SS; ++i) {
            const int take = min(max(deficit - (total - cs[i]), 0), A[i]);
            A[i] -= take;
            Se[i] += take;
          }
          cur += min(max(deficit, 0), total);
        }
        const int em = __shfl_sync(kFull, Se[0], 0);
        if (MODE != kNoEmit && lane == 0) o[b] = em;
        // noroll: no shift; lane L-1 of both rings is 0 already
        if constexpr (MODE != kNoRoll) gd::shift_down<SS>(A, Se, lane);
        cur -= em;
      }
      // the empty loop's count goes to the tile, which the next block
      // clears: without a use, ptxas deletes the loop
      if (MODE == kEmptyLoop && lane == 0) tile[0] = cur;
    }
    __syncthreads();  // the next block's tile overwrites this one
  }

  if (tid < 32) {
#pragma unroll
    for (int i = 0; i < SS; ++i) {
      availf[w * L + k0 + i] = A[i];
      selendf[w * L + k0 + i] = Se[i];
    }
  }
}

template <int SS, int MODE>
cudaError_t launch_mode(const int32_t* packed, const int32_t* target,
                        int32_t* out, int32_t* availf, int32_t* selendf,
                        int64_t nbw, int64_t W, int64_t cap, int B,
                        cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * (size_t)B * 32 * SS;
  auto kernel = blocked_ablate_kernel<SS, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)W, kThreads, smem, stream>>>(packed, target, out, availf,
                                                  selendf, nbw, W, cap, B);
  return cudaGetLastError();
}

template <int SS>
cudaError_t launch_ss(int64_t mode, const int32_t* p, const int32_t* t,
                      int32_t* o, int32_t* af, int32_t* sf, int64_t nbw,
                      int64_t W, int64_t cap, int B, cudaStream_t st) {
  switch (mode) {
    case kFullMode:
      return launch_mode<SS, kFullMode>(p, t, o, af, sf, nbw, W, cap, B, st);
    case kNoTake:
      return launch_mode<SS, kNoTake>(p, t, o, af, sf, nbw, W, cap, B, st);
    case kNoRoll:
      return launch_mode<SS, kNoRoll>(p, t, o, af, sf, nbw, W, cap, B, st);
    case kNoEmit:
      return launch_mode<SS, kNoEmit>(p, t, o, af, sf, nbw, W, cap, B, st);
    case kAddOnly:
      return launch_mode<SS, kAddOnly>(p, t, o, af, sf, nbw, W, cap, B, st);
    case kTileOnly:
      return launch_mode<SS, kTileOnly>(p, t, o, af, sf, nbw, W, cap, B, st);
    case kEmptyLoop:
      return launch_mode<SS, kEmptyLoop>(p, t, o, af, sf, nbw, W, cap, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). mode indexes
// (full, notake, noroll, noemit, addonly, tileonly, emptyloop); L must be
// one of 32, 64, 128, 256 and B even, with B * L * 4 bytes of tile within
// the block's shared memory.
extern "C" int gd_blocked_ablate(const void* packed, const void* target,
                                 void* out, void* availf, void* selendf,
                                 int64_t nbw, int64_t W, int64_t cap,
                                 int64_t B, int64_t L, int64_t mode,
                                 void* stream) {
  if (nbw < 1 || W < 1 || W > 2147483647 || cap < 0 || B < 2 || B % 2 ||
      B * L > (1 << 20))
    return (int)cudaErrorInvalidValue;
  auto p = static_cast<const int32_t*>(packed);
  auto t = static_cast<const int32_t*>(target);
  auto o = static_cast<int32_t*>(out);
  auto af = static_cast<int32_t*>(availf);
  auto sf = static_cast<int32_t*>(selendf);
  auto st = static_cast<cudaStream_t>(stream);
  const int b = (int)B;
  switch (L) {
    case 32:
      return (int)launch_ss<1>(mode, p, t, o, af, sf, nbw, W, cap, b, st);
    case 64:
      return (int)launch_ss<2>(mode, p, t, o, af, sf, nbw, W, cap, b, st);
    case 128:
      return (int)launch_ss<4>(mode, p, t, o, af, sf, nbw, W, cap, b, st);
    case 256:
      return (int)launch_ss<8>(mode, p, t, o, af, sf, nbw, W, cap, b, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
