// Helpers shared by the one-warp sweep kernels (dense_sweep.cu,
// sweep_variants.cu, blocked_ablate.cu, the sweep warp of blocked_sweep.cu):
// lane l of the warp owns the SS consecutive ring slots l*SS..l*SS+SS-1 of
// an L = 32*SS ring in registers, and copies (cp.async) and reads only those
// slots of a staged row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gd {

constexpr unsigned kFull = 0xffffffffu;

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

}  // namespace gd
