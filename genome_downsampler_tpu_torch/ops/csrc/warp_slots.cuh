// Helpers shared by the one-warp sweep kernels (dense_sweep.cu,
// sweep_variants.cu, blocked_ablate.cu, the sweep warp of blocked_sweep.cu):
// lane l of the warp owns the SS consecutive ring slots l*SS..l*SS+SS-1 of
// an L = 32*SS ring in registers, and copies (cp.async) and reads only those
// slots of a staged row. The sweep step is here too, so that kernels A and
// B run the same arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gd {

constexpr unsigned kFull = 0xffffffffu;

// named barriers (id 0 is __syncthreads): one side syncs, the other arrives;
// the two sides' counts must add up to n on every generation, so keep every
// call outside per-thread loops
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copy this lane's SS ints of one row (global -> shared), asynchronously
template <int SS>
__device__ __forceinline__ void cp_async_slots(int32_t* dst,
                                               const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (SS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < SS / 4; ++i)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                   "l"(src + 4 * i)
                   : "memory");
  } else {
    static_assert(SS == 1 || SS == 2, "SS must be 1, 2 or a multiple of 4");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(4 * SS)
                 : "memory");
  }
}

// this lane's SS ints of one staged row (shared -> registers)
template <int SS>
__device__ __forceinline__ void load_slots(const int32_t* p, int (&a)[SS]) {
  if constexpr (SS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < SS / 4; ++i) {
      const int4 v = reinterpret_cast<const int4*>(p)[i];
      a[4 * i] = v.x;
      a[4 * i + 1] = v.y;
      a[4 * i + 2] = v.z;
      a[4 * i + 3] = v.w;
    }
  } else if constexpr (SS == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    a[0] = v.x;
    a[1] = v.y;
  } else {
    a[0] = p[0];
  }
}

// registers -> this lane's SS ints of one staged row
template <int SS>
__device__ __forceinline__ void store_slots(int32_t* p, const int (&a)[SS]) {
  if constexpr (SS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < SS / 4; ++i)
      reinterpret_cast<int4*>(p)[i] =
          make_int4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
  } else if constexpr (SS == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(a[0], a[1]);
  } else {
    p[0] = a[0];
  }
}

// in place: a[j] <- sum of the warp's slots >= this lane's slot j (an
// inclusive suffix over the ring)
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

// in place: a[j] <- sum of the warp's slots <= this lane's slot j (an
// inclusive prefix over the ring); returns the ring total, on every lane
template <int SS>
__device__ __forceinline__ int warp_prefix(int (&a)[SS], int lane) {
  int run = 0;
#pragma unroll
  for (int j = 0; j < SS; ++j) {
    run += a[j];
    a[j] = run;
  }
  int inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  const int below = inc - run;
#pragma unroll
  for (int j = 0; j < SS; ++j) a[j] += below;
  return __shfl_sync(kFull, inc, 31);
}

// the sum of the warp's slots, on every lane
template <int SS>
__device__ __forceinline__ int warp_sum(const int (&a)[SS]) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < SS; ++j) s += a[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// both rings one slot toward slot 0; the top slot empties
template <int SS>
__device__ __forceinline__ void shift_down(int (&a)[SS], int (&b)[SS],
                                           int lane) {
  int a_in = __shfl_down_sync(kFull, a[0], 1);
  int b_in = __shfl_down_sync(kFull, b[0], 1);
  if (lane == 31) a_in = b_in = 0;
#pragma unroll
  for (int i = 0; i < SS - 1; ++i) {
    a[i] = a[i + 1];
    b[i] = b[i + 1];
  }
  a[SS - 1] = a_in;
  b[SS - 1] = b_in;
}

// register slot j+1 of SS, clamped so the index stays in range where the
// caller takes the neighbour lane's value instead (j = SS - 1)
__host__ __device__ constexpr int next_slot(int j, int SS) {
  return j + 1 < SS ? j + 1 : SS - 1;
}

// One position of the water-filling sweep (kernels A and B): fold in the
// position's arrivals `add` (suffix form), then with G = F[k+1]
//   take[k] = clip(tgt - cur - G, 0, F[k] - G); selend += take;
//   taken = min(max(tgt - cur, 0), F[0]); F -= min(taken, F);
// emit selend[0]; cur += taken - selend[0]. `tk` receives take[k] of this
// lane's slots (unused by a caller that emits counts only: the compiler
// drops it). Returns the emitted selend[0], on every lane; the caller
// stores it, then shifts both rings one slot toward k = 0 (shift_down).
template <int SS>
__device__ __forceinline__ int sweep_step(int (&F)[SS], int (&Se)[SS],
                                          const int (&add)[SS], int tgt,
                                          int& cur, int lane, int (&tk)[SS]) {
#pragma unroll
  for (int j = 0; j < SS; ++j) F[j] += add[j];
  int nxt = __shfl_down_sync(kFull, F[0], 1);
  if (lane == 31) nxt = 0;
  const int F0 = __shfl_sync(kFull, F[0], 0);
  const int deficit = tgt - cur;
  const int taken = min(max(deficit, 0), F0);
#pragma unroll
  for (int j = 0; j < SS; ++j) {
    const int G = (j + 1 < SS) ? F[next_slot(j, SS)] : nxt;
    tk[j] = min(max(deficit - G, 0), F[j] - G);
    Se[j] += tk[j];
  }
#pragma unroll
  for (int j = 0; j < SS; ++j) F[j] -= min(taken, F[j]);
  const int em = __shfl_sync(kFull, Se[0], 0);
  cur += taken - em;
  return em;
}

}  // namespace gd
