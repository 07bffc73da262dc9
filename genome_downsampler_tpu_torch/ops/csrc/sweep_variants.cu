// Kernel A's variants C and B: the dense water-filling sweep of one row
// from zero carries, written two other ways, for NVIDIA Hopper (sm_90a), on
// kernel A's warp-specialised frame (dense_sweep.cu), so that the three
// differ in the step alone.
//
// Replaces the Pallas kernels `make_variant_c` (scripts/kernel_variants.py:31)
// and `make_variant_b` (:68), both launched by `run_variant` (:131),
// experiments against kernel A (`_sweep_kernel`, ops/pallas_sweep.py; here
// dense_sweep.cu). Both emit kernel A's sel_per_end.
//
// What they compute. The state is the avail form of the ring, avail[x] =
// # unselected reads covering the position that end in slot x, and
// selend[x] the selected ones. Per position p:
//   fold in the arrival row (raw, reads starting at p);
//   cur = sum(selend); deficit = max(target[p] - cur, 0);
//   take from the slots of the farthest ends first:
//   take[x] = clip(deficit - (stock at ends above x), 0, avail[x]);
//   emit selend of the slot of end p, and retire that slot.
// Variant C keeps slot k = end - p (as kernel A): the stock above is
// total - prefix[k] from a full inclusive prefix scan of avail, slot 0 is
// emitted and both rings shift one slot every step. Variant B keeps slot
// x = end % L (absolute), fed by rows rotated outside the kernel
// (rows_rot[p, (p + k) % L] = rows[p, k]): the ring never shifts, the
// stock above x is read from the same prefix rotated to start at the
// expiring slot s = p % L, and slot s is emitted and emptied. Both keep cur
// as a tracked value, cur += min(deficit, total) - emitted (the takes of a
// step add up to min(deficit, total)), equal to sum(selend) and off the
// scan; kernel A tracks it the same way.
//
// What bounds them on the H100. As kernel A: positions are strictly
// sequential, so the time is one warp's loop-carried chain per position,
// on 1 of the 132 SMs. The bytes (L * 4 of arrivals a position, 1 KB at
// L = 256) and the operations (8 a slot) are far below what one SM can
// load and issue. The dependent shuffles on the chain of a position
// (ring state to ring state), as the SASS of L = 256 has them
// (cuobjdump -sass; instructions a position in brackets):
//   kernel A: SHFL.DOWN (the F[k+1] neighbour) beside SHFL.IDX (F[0]),
//     then the shift's two SHFL.DOWN side by side: 2 levels [92]; the
//     prefix it needs is the arrival row's, summed by the producers, off
//     the chain;
//   C: the 8-slot local prefix, 5 SHFL.UP (the scan of the lanes' sums),
//     then the shift's two SHFL.DOWN: 6 levels [133] (the shifted-in slot
//     is the last one the next local prefix adds, so the shift overlaps it);
//   B: the local prefix and 5 SHFL.UP: 5 levels, no shift [88.5].
// The ring total (C, B) and B's prefix before slot s come from REDUX.SUM
// of the lanes' local sums, beside the scan and off its chain; the emitted
// count is one more SHFL.IDX in each, on cur's shorter chain.
//
// What the design does about it. Everything that does not depend on the
// state leaves the chain, as in kernel A. One CTA of 4 warps per row:
// warp 0 sweeps; warps 1-3 (the producers) prepare the next chunk of P
// positions while warp 0 sweeps the current one, into a double buffer of
// dynamic shared memory, handed over by named barriers (FULL: producers ->
// sweep warp, EMPTY: sweep warp -> producers). Per chunk the producers
//   - copy the chunk's rows (contiguous in HBM, P * L * 4 bytes), raw for C
//     and rotated for B, with 16-byte cp.async: no sum;
//   - stage the chunk's targets, and zero the rows and targets of the last
//     chunk up to a multiple of SS positions (B's groups, below);
//   - flush the sweep warp's emitted counts of a finished chunk to `out`
//     with coalesced stores.
// Lane l of warp 0 owns the SS = L/32 consecutive ring slots
// l*SS..l*SS+SS-1 in registers, reads its SS slots of the staged row and
// the target one position ahead, runs the step and writes the emitted
// count to a shared buffer from every lane (same address, same value: no
// branch). The chain holds no global load or store, no cp.async wait and no
// __syncwarp. B's owner lane of slot s moves every SS positions; B sweeps
// a chunk in groups of SS positions, unrolled, so that within a group the
// owner is fixed and the owner's register (slot s % SS = the position's
// index in the group) is a constant: no per-position compare selects it.
// Positions past n in the last group run on the zeroed rows and are not
// flushed. P is the largest power of two up to 512 for which the two int32
// (P, L) buffers fit 192 KB, as kernel A's: 512 positions at L = 32, 256 at
// 64, 128 at 128, 64 at 256; a multiple of SS at every L.
//
// Preconditions: rows 16-byte aligned (the wrapper checks); L one of 32,
// 64, 128, 256; arrival counts and targets non-negative.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_slots.cuh"

namespace {

using gd::bar_arrive;
using gd::bar_sync;
using gd::kFull;

constexpr int kProducerWarps = 3;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = 32 + kProducers;
// named barriers (0 is __syncthreads): FULL and EMPTY per buffer
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;

// positions per chunk: two int32 (P, L) buffers within 192 KB
__host__ __device__ constexpr int chunk_positions(int L) {
  int p = 512;
  while (2 * p * L * 4 > 192 * 1024) p >>= 1;
  return p;
}

// the (P, L) buffers, the targets and the emitted counts, both halves
__host__ __device__ constexpr int shared_bytes(int L) {
  return 4 * (2 * chunk_positions(L) * L + 4 * chunk_positions(L));
}

// The ring's scan, from this lane's slots after the fold. cs[j] <- the
// inclusive prefix of this lane's slots through j (local); returns the sum
// of the slots of the lanes below this one (5 dependent shuffles); `run` is
// this lane's sum.
template <int SS>
__device__ __forceinline__ int ring_scan(const int (&a)[SS], int (&cs)[SS],
                                         int& run, int lane) {
  run = 0;
#pragma unroll
  for (int j = 0; j < SS; ++j) {
    run += a[j];
    cs[j] = run;
  }
  int inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  return inc - run;
}

// Variant C's step: fold, scan, take from the top, emit slot 0 (returned on
// every lane). The caller shifts both rings (gd::shift_down).
template <int SS>
__device__ __forceinline__ int step_c(int (&A)[SS], int (&Se)[SS],
                                      const int (&add)[SS], int tgt, int& cur,
                                      int lane) {
#pragma unroll
  for (int i = 0; i < SS; ++i) A[i] += add[i];
  int cs[SS], run;
  const int below = ring_scan<SS>(A, cs, run, lane);
  const int total = __reduce_add_sync(kFull, run);
  const int deficit = max(tgt - cur, 0);
  // deficit - (total - prefix[x]), prefix[x] = below + cs[i]
  const int base = deficit - total + below;
#pragma unroll
  for (int i = 0; i < SS; ++i) {
    const int take = min(max(base + cs[i], 0), A[i]);
    A[i] -= take;
    Se[i] += take;
  }
  const int em = __shfl_sync(kFull, Se[0], 0);
  cur += min(deficit, total) - em;
  return em;
}

// Variant B's step at a position whose slot s = owner * SS + JS (JS a
// constant of the unrolled group, owner fixed within it): fold, scan, take
// from the top in ring order from s, emit slot s (returned on every lane)
// and empty it.
template <int SS, int JS>
__device__ __forceinline__ int step_b(int (&A)[SS], int (&Se)[SS],
                                      const int (&add)[SS], int tgt, int& cur,
                                      int owner, int lane) {
#pragma unroll
  for (int i = 0; i < SS; ++i) A[i] += add[i];
  int cs[SS], run;
  const int below = ring_scan<SS>(A, cs, run, lane);
  const int lx = JS ? cs[JS > 0 ? JS - 1 : 0] : 0;  // local prefix before s
  const int total = __reduce_add_sync(kFull, run);
  // the plain prefix strictly before slot s
  const int cs_excl = __reduce_add_sync(
      kFull, lane < owner ? run : (lane == owner ? lx : 0));
  const int deficit = max(tgt - cur, 0);
  // deficit - (stock above x in ring order from s): slot x >= s (this
  // lane's i >= JS with lane >= owner, or i < JS with lane > owner) has the
  // stock total - prefix[x] + cs_excl above it, a slot below s cs_excl -
  // prefix[x]; prefix[x] = below + cs[i]
  const int base = deficit - cs_excl + below;
  const int hi = base - (lane >= owner ? total : 0);
  const int lo = base - (lane > owner ? total : 0);
#pragma unroll
  for (int i = 0; i < SS; ++i) {
    const int take = min(max((i >= JS ? hi : lo) + cs[i], 0), A[i]);
    A[i] -= take;
    Se[i] += take;
  }
  const int em = __shfl_sync(kFull, Se[JS], owner);
  if (lane == owner) A[JS] = Se[JS] = 0;  // slot s holds end p + L next
  cur += min(deficit, total) - em;
  return em;
}

// B's group of SS positions from position b0 of the chunk, unrolled so
// that each step's JS is a constant; returns nothing, emits to em_s
template <int SS, int JS>
__device__ __forceinline__ void group_b(int (&A)[SS], int (&Se)[SS],
                                        int (&add)[SS], int& tgt, int& cur,
                                        const int32_t* rw, const int32_t* tg,
                                        int32_t* em_s, int b0, int lenp,
                                        int owner, int lane) {
  if constexpr (JS < SS) {
    constexpr int L = 32 * SS;
    const int b = b0 + JS;
    const int bn = b + 1 < lenp ? b + 1 : b;
    int nadd[SS];
    gd::load_slots<SS>(rw + bn * L, nadd);
    const int ntgt = tg[bn];
    em_s[b] = step_b<SS, JS>(A, Se, add, tgt, cur, owner, lane);
#pragma unroll
    for (int i = 0; i < SS; ++i) add[i] = nadd[i];
    tgt = ntgt;
    group_b<SS, JS + 1>(A, Se, add, tgt, cur, rw, tg, em_s, b0, lenp, owner,
                        lane);
  }
}

// warp 0: the sweep over every chunk from zero carries
template <int SS, bool RING>
__device__ __forceinline__ void sweep_warp(const int32_t* tile,
                                           const int32_t* tgt_s,
                                           int32_t* out_s, int64_t n,
                                           int lane) {
  constexpr int L = 32 * SS;
  constexpr int P = chunk_positions(L);
  static_assert(P % SS == 0, "B's groups tile a chunk");
  const int k0 = lane * SS;
  int A[SS], Se[SS];
#pragma unroll
  for (int i = 0; i < SS; ++i) A[i] = Se[i] = 0;
  int cur = 0;

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
    if constexpr (!RING) {
#pragma unroll 1
      for (int b = 0; b < len; ++b) {
        // the next position's arrivals and target: off the state
        const int bn = b + 1 < len ? b + 1 : b;
        int nadd[SS];
        gd::load_slots<SS>(rw + bn * L, nadd);
        const int ntgt = tg[bn];
        em_s[b] = step_c<SS>(A, Se, add, tgt, cur, lane);
        gd::shift_down<SS>(A, Se, lane);
#pragma unroll
        for (int i = 0; i < SS; ++i) add[i] = nadd[i];
        tgt = ntgt;
      }
    } else {
      const int lenp = (len + SS - 1) / SS * SS;
      const int s0 = static_cast<int>((c * P) % L);  // a multiple of SS
#pragma unroll 1
      for (int b0 = 0; b0 < lenp; b0 += SS) {
        const int owner = ((s0 + b0) % L) / SS;
        group_b<SS, 0>(A, Se, add, tgt, cur, rw, tg, em_s, b0, lenp, owner,
                       lane);
      }
    }
    bar_arrive(kBarEmpty + buf, kThreads);
  }
}

// warps 1..kProducerWarps: rows, targets and the output of every chunk
template <int SS>
__device__ __forceinline__ void produce(int32_t* tile, int32_t* tgt_s,
                                        const int32_t* out_s,
                                        const int32_t* __restrict__ rows,
                                        const int32_t* __restrict__ target,
                                        int32_t* __restrict__ out, int64_t n) {
  constexpr int L = 32 * SS;
  constexpr int P = chunk_positions(L);
  const int pt = threadIdx.x - 32;  // 0..kProducers-1
  const int64_t nchunks = (n + P - 1) / P;
  auto chunk_len = [&](int64_t c) {
    return static_cast<int>(n - c * P < P ? n - c * P : P);
  };
  auto flush = [&](int64_t c) {  // chunk c's emitted counts -> out
    const int32_t* src = out_s + (c & 1) * P;
    int32_t* dst = out + c * P;
    for (int i = pt; i < chunk_len(c); i += kProducers) dst[i] = src[i];
  };

#pragma unroll 1
  for (int64_t c = 0; c < nchunks; ++c) {
    const int buf = static_cast<int>(c & 1);
    const int len = chunk_len(c);
    const int lenp = (len + SS - 1) / SS * SS;
    int32_t* tb = tile + buf * P * L;
    if (c >= 2) {  // chunk c - 2 left this buffer
      bar_sync(kBarEmpty + buf, kThreads);
      flush(c - 2);
    }
    // ---- the chunk's rows: len * L contiguous ints, 16 bytes a copy
    const int32_t* src = rows + c * P * L;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(tb));
    for (int i = pt; i < len * L / 4; i += kProducers)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * i),
                   "l"(src + 4 * i)
                   : "memory");
    gd::cp_async_commit();
    // ---- the pad rows up to a multiple of SS positions, and the targets
    for (int i = pt; i < (lenp - len) * L; i += kProducers) tb[len * L + i] = 0;
    const int32_t* tsrc = target + c * P;
    int32_t* tg = tgt_s + buf * P;
    for (int i = pt; i < lenp; i += kProducers) tg[i] = i < len ? tsrc[i] : 0;
    gd::cp_async_wait<0>();
    bar_arrive(kBarFull + buf, kThreads);
  }

  // ---- the last chunks' output
  for (int64_t c = nchunks > 2 ? nchunks - 2 : 0; c < nchunks; ++c) {
    bar_sync(kBarEmpty + static_cast<int>(c & 1), kThreads);
    flush(c);
  }
}

template <int SS, bool RING>
__global__ void __launch_bounds__(kThreads) sweep_variant_kernel(
    const int32_t* __restrict__ rows,    // [n, L], rotated if RING
    const int32_t* __restrict__ target,  // [n]
    int32_t* __restrict__ out,           // [n]
    int64_t n) {
  constexpr int L = 32 * SS;
  constexpr int P = chunk_positions(L);
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tile = reinterpret_cast<int32_t*>(smem);  // [2][P][L]
  int32_t* tgt_s = tile + 2 * P * L;                 // [2][P]
  int32_t* out_s = tgt_s + 2 * P;                    // [2][P]
  if (threadIdx.x < 32) {
    sweep_warp<SS, RING>(tile, tgt_s, out_s, n, threadIdx.x);
  } else {
    produce<SS>(tile, tgt_s, out_s, rows, target, out, n);
  }
}

// the kernel of (L, RING), or null for another L
template <bool RING>
const void* kernel_of(int64_t L) {
  switch (L) {
    case 32: return reinterpret_cast<const void*>(sweep_variant_kernel<1, RING>);
    case 64: return reinterpret_cast<const void*>(sweep_variant_kernel<2, RING>);
    case 128: return reinterpret_cast<const void*>(sweep_variant_kernel<4, RING>);
    case 256: return reinterpret_cast<const void*>(sweep_variant_kernel<8, RING>);
    default: return nullptr;
  }
}

template <bool RING>
int launch(const void* rows, const void* target, void* out, int64_t n,
           int64_t L, void* stream) {
  const void* kernel = kernel_of<RING>(L);
  if (kernel == nullptr || n < 0 || (n > 0 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int smem = shared_bytes((int)L);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // the kernel's parameters: three 8-byte pointers and n
  void* args[] = {&rows, &target, &out, &n};
  e = cudaLaunchKernel(kernel, dim3(1), dim3(kThreads), args, smem,
                       static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success). L must be one
// of 32, 64, 128, 256; rows_rot for variant B is rotate_rows(rows).
extern "C" int gd_sweep_variant_c(const void* rows, const void* target,
                                  void* out, int64_t n, int64_t L,
                                  void* stream) {
  return launch<false>(rows, target, out, n, L, stream);
}

extern "C" int gd_sweep_variant_b(const void* rows_rot, const void* target,
                                  void* out, int64_t n, int64_t L,
                                  void* stream) {
  return launch<true>(rows_rot, target, out, n, L, stream);
}

// The geometry and resources of the variant of (L, ring != 0):
// info = {positions per chunk P, dynamic shared bytes, registers per
// thread, local bytes per thread (spills)}. Returns the cudaError_t.
extern "C" int gd_sweep_variant_info(int64_t L, int64_t ring, int64_t* info) {
  const void* k = ring ? kernel_of<true>(L) : kernel_of<false>(L);
  if (k == nullptr || info == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  info[0] = chunk_positions((int)L);
  info[1] = shared_bytes((int)L);
  info[2] = a.numRegs;
  info[3] = (int64_t)a.localSizeBytes;
  return 0;
}
