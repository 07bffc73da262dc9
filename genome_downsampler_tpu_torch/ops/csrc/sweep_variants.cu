// Kernel A's variants C and B: the dense water-filling sweep of one row
// from zero carries, written two other ways, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels `make_variant_c` and `make_variant_b` of
// scripts/kernel_variants.py (both launched by `run_variant`), experiments
// against kernel A (`_sweep_kernel`, ops/pallas_sweep.py; here
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
// expiring slot s = p % L, and slot s is emitted and emptied.
//
// What bounds them on the H100. As kernel A: positions are strictly
// sequential, each step is a chain of dependent integer ops and warp
// shuffles, and the row traffic (L * 4 bytes a position) is far below what
// one warp can load; they are latency-bound on one SM. Against kernel A,
// C puts a 5-shuffle prefix scan of the ring and a 5-shuffle reduction
// for cur on the loop-carried chain (kernel A scans the arrival row, off
// the state, and tracks cur); B drops the two shift shuffles but adds the
// two broadcasts from the lane that owns slot s, which moves every step.
//
// What the design does about it. As kernel A: one warp, lane l owns the
// SS = L/32 consecutive slots l*SS..l*SS+SS-1 in registers; arrival rows
// stream through a ring of 16 rows in shared memory filled by cp.async,
// each lane copying and reading only its own slots, 15 positions ahead;
// targets are staged 256 at a time. Neither variant branches on the data.
//
// Preconditions: rows 16-byte aligned (the wrapper checks); L one of 32,
// 64, 128, 256; arrival counts and targets non-negative.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_slots.cuh"

namespace {

using gd::kFull;

constexpr int kTgtStage = 256;  // targets staged per refill
constexpr int kRows = 16;       // arrival rows in flight

template <int SS, bool RING>
__global__ void __launch_bounds__(32) sweep_variant_kernel(
    const int32_t* __restrict__ rows,    // [n, L], rotated if RING
    const int32_t* __restrict__ target,  // [n]
    int32_t* __restrict__ out,           // [n]
    int64_t n) {
  constexpr int L = 32 * SS;
  constexpr int P = kRows - 1;  // prefetch distance in positions
  __shared__ __align__(16) int32_t ring[kRows][L];
  __shared__ int32_t tgt_s[kTgtStage];

  const int lane = threadIdx.x;
  const int k0 = lane * SS;
  const int32_t* __restrict__ row = rows + k0;

  int A[SS], Se[SS];
#pragma unroll
  for (int i = 0; i < SS; ++i) A[i] = Se[i] = 0;

#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    if (p < n) gd::cp_async_slots<SS>(&ring[p % kRows][k0], row + (int64_t)p * L);
    gd::cp_async_commit();
  }

#pragma unroll 1
  for (int64_t j = 0; j < n; ++j) {
    if (j % kTgtStage == 0) {  // warp-uniform: refill the target stage
      __syncwarp();
      for (int i = lane; i < kTgtStage && j + i < n; i += 32)
        tgt_s[i] = target[j + i];
      __syncwarp();
    }
    const int64_t jp = j + P;
    if (jp < n) gd::cp_async_slots<SS>(&ring[jp % kRows][k0], row + jp * L);
    gd::cp_async_commit();
    gd::cp_async_wait<P>();  // this lane's copy of row j has landed

    int add[SS];
    gd::load_slots<SS>(&ring[j % kRows][k0], add);
#pragma unroll
    for (int i = 0; i < SS; ++i) A[i] += add[i];
    const int cur = gd::warp_sum<SS>(Se);
    const int deficit = max(tgt_s[j % kTgtStage] - cur, 0);
    int cs[SS];  // inclusive prefix of avail over the ring
#pragma unroll
    for (int i = 0; i < SS; ++i) cs[i] = A[i];
    const int total = gd::warp_prefix<SS>(cs, lane);

    if constexpr (!RING) {
#pragma unroll
      for (int i = 0; i < SS; ++i) {
        const int take = min(max(deficit - (total - cs[i]), 0), A[i]);
        A[i] -= take;
        Se[i] += take;
      }
      const int em = __shfl_sync(kFull, Se[0], 0);
      if (lane == 0) out[j] = em;
      gd::shift_down<SS>(A, Se, lane);
    } else {
      // slot s of the ends at j, held by lane `owner` in its register js
      const int s = static_cast<int>(j % L);
      const int owner = s / SS, js = s % SS;
      int mine = 0;
#pragma unroll
      for (int i = 0; i < SS; ++i)
        if (i == js) mine = cs[i] - A[i];
      const int cs_excl = __shfl_sync(kFull, mine, owner);  // prefix before s
#pragma unroll
      for (int i = 0; i < SS; ++i) {
        // prefix in ring order from s, through this slot
        const int rp = (k0 + i >= s) ? cs[i] - cs_excl : cs[i] + total - cs_excl;
        const int take = min(max(deficit - (total - rp), 0), A[i]);
        A[i] -= take;
        Se[i] += take;
      }
      int e = 0;
#pragma unroll
      for (int i = 0; i < SS; ++i)
        if (i == js) e = Se[i];
      const int em = __shfl_sync(kFull, e, owner);
      if (lane == 0) out[j] = em;
      if (lane == owner) {  // retire slot s: it holds end j + L next
#pragma unroll
        for (int i = 0; i < SS; ++i)
          if (i == js) A[i] = Se[i] = 0;
      }
    }
  }
  gd::cp_async_wait<0>();
}

template <bool RING>
int launch(const void* rows, const void* target, void* out, int64_t n,
           int64_t L, void* stream) {
  if (n < 0 || (n > 0 && out == nullptr)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto r = static_cast<const int32_t*>(rows);
  auto t = static_cast<const int32_t*>(target);
  auto o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 32:
      sweep_variant_kernel<1, RING><<<1, 32, 0, st>>>(r, t, o, n);
      break;
    case 64:
      sweep_variant_kernel<2, RING><<<1, 32, 0, st>>>(r, t, o, n);
      break;
    case 128:
      sweep_variant_kernel<4, RING><<<1, 32, 0, st>>>(r, t, o, n);
      break;
    case 256:
      sweep_variant_kernel<8, RING><<<1, 32, 0, st>>>(r, t, o, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
