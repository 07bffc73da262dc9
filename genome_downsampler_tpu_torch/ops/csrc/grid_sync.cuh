// The grid barrier of the cooperative kernels, and the loads of what other
// CTAs wrote. A copy of ssp.cu's (which keeps its own until the two are
// merged, so that the SSP kernel's times stay comparable: ptxas moves
// schedules with small source changes).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gd {

// loads of what other CTAs wrote: through L2, never a stale L1 line
__device__ __forceinline__ int32_t ldcg(const int32_t* p) { return __ldcg(p); }
__device__ __forceinline__ long long ldcg(const long long* p) { return __ldcg(p); }

// One grid barrier: every thread of every CTA arrives before any leaves,
// and the writes before it are visible after it. `bar` counts arrivals
// over the whole launch; a CTA's thread 0 adds one (a reduction that
// returns nothing, with release semantics: the CTA's writes before the
// __syncthreads go first) and waits, reading with acquire semantics, until
// the count reaches its own `target`, G more than at its last barrier
// (compared by the wrapping difference).
// Valid only under the cooperative launch, which makes all CTAs
// co-resident. A wait of kBarrierTrap cycles (about 10 s) is a fault, and
// traps rather than holding the card. Every CTA must call it the same
// number of times: keep it outside per-thread loops.
constexpr long long kBarrierTrap = 20000000000LL;

__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(bar), "r"(1u) : "memory");
    const long long t0 = clock64();
    unsigned count;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(count) : "l"(bar) : "memory");
      if (clock64() - t0 > kBarrierTrap) __trap();
    } while (static_cast<int>(count - target) < 0);
  }
  __syncthreads();
}

}  // namespace gd
