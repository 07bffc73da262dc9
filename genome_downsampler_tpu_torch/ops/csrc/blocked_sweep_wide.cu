// Kernel B's wide path: one carry-relaxation round of the blocked exact
// water-filling sweep for the inputs kernel B's register path
// (blocked_sweep.cu) does not take, for NVIDIA Hopper (sm_90a):
//   - long reads: any L = 32 * S up to 4096 (the register path takes
//     L <= 768: a lane's S ring slots no longer fit in registers above);
//   - deep stacks: more than 65,535 reads of a window starting at one
//     position (the register path keeps arrival counts in uint16).
//
// Replaces, with blocked_sweep.cu, the Pallas kernel `_blocked_kernel`
// (genome_downsampler_tpu/ops/pallas_blocked.py:383); it computes what
// blocked_sweep.cu computes (see there), bit for bit, from the same
// arguments.
//
// The step in avail form. The slot-wise step (suffix sums F, take[k] =
// clip(deficit - F[k+1], 0, F[k] - F[k+1]), F -= min(taken, F)) takes
// taken = min(max(tgt - cur, 0), A) reads from the farthest ends down, A
// being the reads available. So a position needs O(1) work (the deficit,
// the emit, the expiry of the nearest end), O(1) per read that arrives and
// O(1) per end slot the take empties, once the highest live end can be
// found without a pass over the ring.
//
// What bounds it. One warp's chain per window and position, on W <= 64 of
// 132 SMs: O(1) shared-memory steps a position plus O(arrivals + emptied
// slots); amortised, each emptied slot is paid for by the arrivals that
// filled it; on a deep stack, the sweep warp's 32 arrivals a step. With
// one warp issuing, the chain's dependent instructions and
// shared-memory round trips set the time, not the card's rates: the bytes
// (codes, counts, the emitted counts, the carries) are microseconds of its
// memory rate.
//
// What the design does. Per window (one CTA) the per-end counts avail[L]
// and selend[L] live in shared memory indexed by the absolute end mod L, so
// the shift is h += 1 and one cleared slot; a bitmask of the non-empty
// avail slots (L/32 words, lane l keying words l, l + 32, ...) finds the
// highest live end in ring order with one warp max (__reduce_max_sync) and
// one __clz; the scalars A = sum(avail) and cur = sum(selend) replace every
// reduction. Warp 0 sweeps; warps 1-3 produce each block's per-position
// offsets into the group's start-sorted codes (each position's arrivals are
// one run there), its targets and the availi carry, and flush the emitted
// counts, double-buffered between FULL and EMPTY named barriers. Each
// producer takes a contiguous share of the group's codes, 8 loads at a
// time, skips a batch equal to its current code with one compare, and adds
// each run of equal codes to the coverage ring once: a deep stack (tens of
// thousands of reads with a few spans at one position) no longer costs a
// contended atomic and a load round trip per code. At a quiet position (no
// arrival, no take, nothing ending there: it only emits 0) the sweep warp
// looks 32 positions ahead, one a lane, and skips the quiet run with one
// ballot; at any other position it reads the arrival codes itself and
// folds them in with shared atomics, one a lane, 32 codes at a time
// (integer sums, so the order does not matter). Kept simple on purpose:
// keeping the top's distance across positions, loading the next run's
// codes a position ahead, or folding runs of equal codes in the sweep warp
// (across lanes or 16 codes a lane) each measured slower off the stacks
// (PERF.md §6). Shared memory is
// 8L bytes of counts, L/8 of mask, the availi ring (the least power of two
// above B + L ints) and 6 KB of offsets, targets and outputs: 71 KB at
// L = 4096, so the block need not shrink as L grows.
//
// Preconditions: as blocked_sweep.cu; L a multiple of 32 up to 4096; B at
// most 256; each group's codes sorted by start (code / L), as the packers
// emit them.

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
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;
constexpr int kBarProducers = 5;
constexpr int kMaxSpan = 4096;
constexpr int kMaxBlock = 256;
constexpr int kWordsPerLane = kMaxSpan / 32 / 32;  // mask words a lane keys
constexpr int kLoads = 8;  // codes a producer loads at once
constexpr size_t kMaxSmem = 232448;  // the most a CTA may have on sm_90

// The highest live end in ring order (physical slot h - 1 down to 0, then
// L - 1 down to h), on every lane. Lane l keys its mask words l, l + 32, ...:
// a word's live slots below h outrank every slot at or above h (key 257 + j
// against 1 + j), the warp takes the largest key, the owner lane hands over
// its masked word, and its highest bit is the slot; -1 if no slot is live.
__device__ __forceinline__ int top_slot(const uint32_t* mk, int h, int nw, int lane) {
  const int hw = h >> 5;
  const uint32_t hlo = (1u << (h & 31)) - 1u;
  int key = 0;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < kWordsPerLane; ++i) {
    const int j = lane + 32 * i;
    if (j < nw) {
      const uint32_t m = mk[j];
      const uint32_t lo = j < hw ? m : (j == hw ? (m & hlo) : 0u);
      const uint32_t hi = m & ~lo;
      // j grows with i, so a later word's key of the same region is larger
      if (lo) {
        key = 257 + j;
        word = lo;
      } else if (hi && key < 257) {
        key = 1 + j;
        word = hi;
      }
    }
  }
  const int top = __reduce_max_sync(kFull, key);
  if (top == 0) return -1;
  const int j = top > 256 ? top - 257 : top - 1;
  const uint32_t w = __shfl_sync(kFull, word, j & 31);
  return 32 * j + 31 - __clz(w);
}

// one more read ending at physical slot p (wrapped from [0, 2L))
__device__ __forceinline__ void arrive(int32_t* av, uint32_t* mk, int p, int L) {
  if (p >= L) p -= L;
  atomicAdd(av + p, 1);
  atomicOr(mk + (p >> 5), 1u << (p & 31));
}

// warp 0: the sweep over every block, per-end counts in shared memory
__device__ void sweep_warp(const int32_t* off_s, const int32_t* tgt_s, int32_t* out_s,
                           int32_t* av, int32_t* se, uint32_t* mk,
                           const int32_t* __restrict__ packed,
                           const int32_t* __restrict__ avail0,
                           const int32_t* __restrict__ selend0,
                           int32_t* __restrict__ availf, int32_t* __restrict__ selendf,
                           int64_t w, int lane, int L, int B, int64_t W, int64_t cap,
                           int64_t grid_offset, int64_t nblocks) {
  const int nw = L >> 5;
  // ---- carries in (avail form, slot k at physical k: h = 0); A, cur
  int A = 0, cur = 0;
  for (int k0 = 0; k0 < L; k0 += 32) {
    const int a = avail0[w * L + k0 + lane];
    const int s = selend0[w * L + k0 + lane];
    av[k0 + lane] = a;
    se[k0 + lane] = s;
    const unsigned live = __ballot_sync(kFull, a != 0);
    if (lane == 0) mk[k0 >> 5] = live;
    A += a;
    cur += s;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    A += __shfl_xor_sync(kFull, A, o);
    cur += __shfl_xor_sync(kFull, cur, o);
  }
  __syncwarp();

  int h = 0;
#pragma unroll 1
  for (int64_t c = 0; c < nblocks; ++c) {
    const int buf = static_cast<int>(c & 1);
    bar_sync(kBarFull + buf, kThreads);
    const int32_t* of = off_s + buf * (kMaxBlock + 1);
    const int32_t* tg = tgt_s + buf * kMaxBlock;
    int32_t* em_s = out_s + buf * kMaxBlock;
    const int32_t* __restrict__ g = packed + ((grid_offset + c) * W + w) * cap;
    int b = 0;
#pragma unroll 1
    while (b < B) {
      // position b's run, target and the two slots at h, and its first 32
      // arrival codes (the load in flight while the step goes on)
      const int o0 = of[b], o1 = of[b + 1], tgt = tg[b];
      const int code = o0 + lane < o1 ? g[o0 + lane] : 0;
      if (o0 == o1 && tgt <= cur && av[h] == 0 && se[h] == 0) {
        // position b is quiet: nothing arrives, nothing is taken (tgt <=
        // cur), nothing ends there. Lane i looks at position b + i; up to
        // the first that is not quiet, cur and A stay and each position
        // only emits 0 and advances h.
        const int i = b + lane;
        const int hp = h + lane < L ? h + lane : h + lane - L;
        const bool quiet = i < B && of[i + 1] == of[i] && tg[i] <= cur && av[hp] == 0 &&
                           se[hp] == 0;
        const unsigned busy = __ballot_sync(kFull, !quiet);
        const int k = busy ? __ffs(busy) - 1 : 32;
        if (lane < k) em_s[b + lane] = 0;
        b += k;
        h = h + k < L ? h + k : h + k - L;
        continue;
      }
      const int n = o1 - o0;
      if (n > 0) {
        // code - b * L is the span - 1: the end's distance from h
        const int base = h - b * L;
        if (lane < n) arrive(av, mk, base + code, L);
        for (int j = o0 + 32 + lane; j < o1; j += 32) arrive(av, mk, base + g[j], L);
        __syncwarp();
        A += n;
      }
      const int taken = min(max(tgt - cur, 0), A);
      // take from the highest live end down: each step ends the take or
      // empties a slot (whose bit it clears)
      for (int rem = taken; rem > 0;) {
        const int p = top_slot(mk, h, nw, lane);
        if (p < 0) break;  // A counts every live read: only bad carries get here
        int a = 0;
        if (lane == 0) a = av[p];
        a = __shfl_sync(kFull, a, 0);
        const int x = min(a, rem);
        if (lane == 0) {
          av[p] = a - x;
          se[p] += x;
          if (a == x) mk[p >> 5] &= ~(1u << (p & 31));
        }
        rem -= x;
        __syncwarp();
      }
      // emit selend at h; the untaken reads ending at h leave; slot h
      // becomes the empty top slot
      int e = 0, a = 0;
      if (lane == 0) {
        e = se[h];
        a = av[h];
        em_s[b] = e;
        se[h] = 0;
        av[h] = 0;
        if (a) mk[h >> 5] &= ~(1u << (h & 31));  // a slot's bit is set iff its count is not 0
      }
      e = __shfl_sync(kFull, e, 0);
      a = __shfl_sync(kFull, a, 0);
      cur += taken - e;
      A -= taken + a;
      h = h + 1 == L ? 0 : h + 1;
      ++b;
      __syncwarp();
    }
    bar_arrive(kBarEmpty + buf, kThreads);
  }

  // ---- carries out: slot k at physical (h + k) mod L
  for (int k = lane; k < L; k += 32) {
    const int p = h + k < L ? h + k : h + k - L;
    availf[w * L + k] = av[p];
    selendf[w * L + k] = se[p];
  }
}

// warps 1..kProducerWarps: per block the offsets of each position's run in
// the group's codes, the targets, and the output flush
template <bool AUTO>
__device__ void produce(int32_t* off_s, int32_t* tgt_s, int32_t* out_s, int32_t* ring,
                        const int32_t* __restrict__ counts,
                        const int32_t* __restrict__ packed,
                        const int32_t* __restrict__ target,
                        const int32_t* __restrict__ avail0i,
                        int32_t* __restrict__ out, int32_t* __restrict__ availfi,
                        int64_t w, int64_t nbw, int64_t W, int64_t cap, int L, int B,
                        int R, int64_t nblocks, int64_t grid_offset,
                        int32_t max_coverage) {
  const int pt = threadIdx.x - 32;
  const int pw = pt >> 5;
  const int lane = pt & 31;
  const int64_t npos = nblocks * B;
  int32_t* const o = out + w * npos;

  auto flush = [&](int64_t c) {
    const int32_t* src = out_s + (c & 1) * kMaxBlock;
    for (int i = pt; i < B; i += kProducers) o[c * B + i] = src[i];
  };

  int cover = 0;  // the coverage at the position before the block
  if (AUTO) {
    for (int i = pt; i < R; i += kProducers) ring[i] = 0;
    bar_sync(kBarProducers, kProducers);
    for (int k = pt; k < L; k += kProducers) ring[k + 1] = avail0i[w * L + k];
    if (pw == 0) {
      for (int k = lane; k < L; k += 32) cover += avail0i[w * L + k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) cover += __shfl_xor_sync(kFull, cover, off);
    }
    // the first block's arrivals add to slots these stores write
    bar_sync(kBarProducers, kProducers);
  } else {
    for (int k = pt; k < L; k += kProducers) availfi[w * L + k] = avail0i[w * L + k];
  }

#pragma unroll 1
  for (int64_t c = 0; c < nblocks; ++c) {
    const int buf = static_cast<int>(c & 1);
    const int64_t t = grid_offset + c;
    const int64_t q0 = c * B;
    if (c >= 2) {
      bar_sync(kBarEmpty + buf, kThreads);
      flush(c - 2);
    }
    // ---- of[b]: the first code of the group starting at b or later. Code
    // i writes of[b] for b in (start of code i - 1, start of code i], the
    // last code also every b after its start: each entry once. Each
    // producer takes a contiguous share of the codes, kLoads at a time, and
    // adds each run of equal codes to the coverage ring at once: a deep
    // stack costs a load round trip per kLoads codes a producer, not one
    // contended atomic per code.
    int32_t* of = off_s + buf * (kMaxBlock + 1);
    const int cnt = counts[t * W + w];
    const int32_t* __restrict__ g = packed + (t * W + w) * cap;
    if (cnt == 0) {
      for (int b = pt; b <= B; b += kProducers) of[b] = 0;
    }
    const int per = (cnt + kProducers - 1) / kProducers;
    const int i0 = min(pt * per, cnt), i1 = min(i0 + per, cnt);
    int pc = -1, ps = -1, run = 0;  // the code before i, its start, its run here
    if (i0 > 0 && i0 < i1) {
      pc = g[i0 - 1];
      ps = min(pc / L, B);  // a start past the block reads as B
    }
    // the run of pc leaves the coverage after its end, at q0 + ps + span
    auto leave = [&]() {
      if (AUTO && run && ps < B) atomicAdd(&ring[(q0 + ps + (pc - ps * L) + 1) & (R - 1)], run);
    };
#pragma unroll 1
    for (int i = i0; i < i1; i += kLoads) {
      int q[kLoads];
      bool same = true;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        q[u] = i + u < i1 ? g[i + u] : -1;
        same &= q[u] == pc;
      }
      if (same) {  // a stack: kLoads more of the run of pc (pc is a code here)
        run += kLoads;
        continue;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (q[u] >= 0 && q[u] != pc) {
          leave();
          const int sr = min(q[u] / L, B);
          for (int b = ps + 1; b <= sr; ++b) of[b] = i + u;
          pc = q[u];
          ps = sr;
          run = 0;
        }
        run += q[u] >= 0;
      }
    }
    leave();
    if (i0 < i1 && i1 == cnt)
      for (int b = ps + 1; b <= B; ++b) of[b] = cnt;
    bar_sync(kBarProducers, kProducers);
    // ---- the block's targets
    int32_t* tg = tgt_s + buf * kMaxBlock;
    if (AUTO) {
      if (pw == 0) {
        for (int i0 = 0; i0 < B; i0 += 32) {
          const int i = i0 + lane;
          int v = 0;
          if (i < B) {
            const int slot = static_cast<int>((q0 + i) & (R - 1));
            v = of[i + 1] - of[i] - ring[slot];
            ring[slot] = 0;
          }
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(kFull, v, off);
            if (lane >= off) v += u;
          }
          if (i < B) tg[i] = min(cover + v, max_coverage);
          cover += __shfl_sync(kFull, v, 31);
        }
      }
      // the next block's arrivals go into the ring only after these reads
      bar_sync(kBarProducers, kProducers);
    } else {
      const int32_t* src = target + w * nbw * B + t * B;
      for (int i = pt; i < B; i += kProducers) tg[i] = src[i];
    }
    bar_arrive(kBarFull + buf, kThreads);
  }

  for (int64_t c = nblocks > 2 ? nblocks - 2 : 0; c < nblocks; ++c) {
    bar_sync(kBarEmpty + static_cast<int>(c & 1), kThreads);
    flush(c);
  }
  if (AUTO) {
    bar_sync(kBarProducers, kProducers);
    for (int k = pt; k < L; k += kProducers)
      availfi[w * L + k] = ring[(npos + 1 + k) & (R - 1)];
  }
}

template <bool AUTO>
__global__ void __launch_bounds__(kThreads) blocked_sweep_wide_kernel(
    const int32_t* __restrict__ counts, const int32_t* __restrict__ packed,
    const int32_t* __restrict__ target, const int32_t* __restrict__ avail0,
    const int32_t* __restrict__ selend0, const int32_t* __restrict__ avail0i,
    int32_t* __restrict__ out, int32_t* __restrict__ availf,
    int32_t* __restrict__ selendf, int32_t* __restrict__ availfi, int64_t nbw,
    int64_t W, int64_t cap, int L, int B, int R, int64_t grid_offset,
    int32_t max_coverage) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* av = reinterpret_cast<int32_t*>(smem);                    // [L]
  int32_t* se = av + L;                                              // [L]
  uint32_t* mk = reinterpret_cast<uint32_t*>(se + L);                // [L / 32]
  int32_t* off_s = reinterpret_cast<int32_t*>(mk + (L >> 5));        // [2][kMaxBlock + 1]
  int32_t* tgt_s = off_s + 2 * (kMaxBlock + 1);                      // [2][kMaxBlock]
  int32_t* out_s = tgt_s + 2 * kMaxBlock;                            // [2][kMaxBlock]
  int32_t* ring = out_s + 2 * kMaxBlock;                             // [R]

  const int64_t w = blockIdx.x;
  const int64_t nblocks = nbw - grid_offset;
  if (threadIdx.x < 32) {
    sweep_warp(off_s, tgt_s, out_s, av, se, mk, packed, avail0, selend0, availf, selendf,
               w, threadIdx.x, L, B, W, cap, grid_offset, nblocks);
  } else {
    produce<AUTO>(off_s, tgt_s, out_s, ring, counts, packed, target, avail0i, out, availfi,
                  w, nbw, W, cap, L, B, R, nblocks, grid_offset, max_coverage);
  }
}

template <bool AUTO>
cudaError_t launch(const int32_t* counts, const int32_t* packed, const int32_t* target,
                   const int32_t* avail0, const int32_t* selend0, const int32_t* avail0i,
                   int32_t* out, int32_t* availf, int32_t* selendf, int32_t* availfi,
                   int64_t nbw, int64_t W, int64_t cap, int L, int B,
                   int64_t grid_offset, int32_t max_coverage, cudaStream_t stream) {
  // the availi ring: a power of two above B + L, so a block's arrivals
  // never reach a slot still to be read
  int R = 1;
  if (AUTO)
    while (R < B + L + 1) R <<= 1;
  const size_t smem = sizeof(int32_t) * (2 * static_cast<size_t>(L) + L / 32 +
                                         6 * kMaxBlock + 2 + (AUTO ? R : 0));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = blocked_sweep_wide_kernel<AUTO>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(W), kThreads, smem, stream>>>(
      counts, packed, target, avail0, selend0, avail0i, out, availf, selendf, availfi,
      nbw, W, cap, L, B, R, grid_offset, max_coverage);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The arguments are
// gd_blocked_sweep's, with any L = 32 * S up to 4096 and B at most 256;
// every count here is int32.
extern "C" int gd_blocked_sweep_wide(
    const void* counts, const void* packed, const void* target, const void* avail0,
    const void* selend0, const void* avail0i, void* out, void* availf, void* selendf,
    void* availfi, int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t L,
    int64_t grid_offset, int64_t auto_target, int64_t max_coverage, void* stream) {
  if (B > kMaxBlock || B < 1 || W < 1 || grid_offset < 0 || grid_offset >= nbw || cap < 0 ||
      L < 32 || L > kMaxSpan || L % 32 != 0)
    return (int)cudaErrorInvalidValue;
  auto c = static_cast<const int32_t*>(counts);
  auto p = static_cast<const int32_t*>(packed);
  auto tg = static_cast<const int32_t*>(target);
  auto a0 = static_cast<const int32_t*>(avail0);
  auto s0 = static_cast<const int32_t*>(selend0);
  auto i0 = static_cast<const int32_t*>(avail0i);
  auto o = static_cast<int32_t*>(out);
  auto af = static_cast<int32_t*>(availf);
  auto sf = static_cast<int32_t*>(selendf);
  auto fi = static_cast<int32_t*>(availfi);
  auto st = static_cast<cudaStream_t>(stream);
  const int32_t m = static_cast<int32_t>(max_coverage);
  const int l = static_cast<int>(L), b = static_cast<int>(B);
  if (auto_target)
    return (int)launch<true>(c, p, tg, a0, s0, i0, o, af, sf, fi, nbw, W, cap, l, b,
                             grid_offset, m, st);
  return (int)launch<false>(c, p, tg, a0, s0, i0, o, af, sf, fi, nbw, W, cap, l, b,
                            grid_offset, m, st);
}
