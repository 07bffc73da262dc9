// Kernel B's wide path: one carry-relaxation round of the blocked exact
// water-filling sweep for the inputs kernel B's register path
// (blocked_sweep.cu) does not take, for NVIDIA Hopper (sm_90a):
//   - long reads: any L = 32 * S with B * L < 2^31, the bound of the
//     blocked engine's int32 codes (the register path takes L <= 768: a
//     lane's S ring slots no longer fit in registers above);
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
// and selend[L] are indexed by the absolute end mod L, so the shift is
// h += 1 and one cleared slot; a set of the non-empty avail slots finds the
// highest live end in ring order; the scalars A = sum(avail) and cur =
// sum(selend) replace every reduction. Warp 0 sweeps; warps 1-3 produce
// each block's per-position offsets into the group's start-sorted codes
// (each position's arrivals are one run there), its targets and the availi
// carry, and flush the emitted counts, double-buffered between FULL and
// EMPTY named barriers. Each producer takes a contiguous share of the
// group's codes, 8 loads at a time, skips a batch equal to its current code
// with one compare, and adds each run of equal codes to the coverage ring
// once: a deep stack (tens of thousands of reads with a few spans at one
// position) no longer costs a contended atomic and a load round trip per
// code. At a quiet position (no arrival, no take, nothing ending there: it
// only emits 0) the sweep warp looks 32 positions ahead, one a lane, and
// skips the quiet run with one ballot; at any other position it reads the
// arrival codes itself and folds them in with atomics, one a lane, 32 codes
// at a time (integer sums, so the order does not matter). Kept simple on
// purpose: keeping the top's distance across positions, loading the next
// run's codes a position ahead, or folding runs of equal codes in the sweep
// warp (across lanes or 16 codes a lane) each measured slower off the
// stacks (PERF.md §6).
//
// Four tiers by L (a template parameter, MODE); the caller picks tier 0 up
// to L = 4096 and above it the least whose shared memory fits
// (ops/blocked.py::wide_tier; kMaxSmem, 227 KB; R is the availi ring, the
// least power of two above B + L, held only with auto targets), and may
// force a higher one there to time the tiers at one L:
//   0  L <= 4096: counts, a flat bitmask of the live ends (L/32 words,
//      lane l keying words l, l + 32, ...: one warp max and one __clz find
//      the top) and the ring in shared memory, 8L + L/8 + 4R bytes and 6 KB
//      of offsets, targets and outputs: 71 KB at L = 4096;
//   1  above, while 4 (2L + T + R) + 6 KB fit (L <= 16,128 at B = 128 with
//      auto targets, 202.8 KB): the same in shared memory, the mask with
//      summary levels (below);
//   2  above, while the tree and the 6 KB fit (L up to about 1.7M): the
//      tree in shared memory; avail, selend and the availi ring in a global
//      workspace, 8L + 4R bytes a window (16 MB at L = 65,536 and W = 16,
//      which L2 holds), read past L1 (ld.global.cg) since their atomics
//      resolve in L2;
//   3  above: the tree in the workspace too.
// The live-end set above tier 0 is a 32-ary bit tree: level 0 is the mask
// (bit p: avail[p] != 0), each higher level has one bit a word of the level
// below (set iff that word is not 0), up to a level of one word, T words in
// all (L/32 + L/1024 + ... : 8.45 KB at L = 65,536). The highest live slot
// at or below q climbs from q's word until a masked word is not 0 and
// descends by __clz, at most 2 x 7 dependent loads at any L (7 levels reach
// 2^31), so the walk no longer grows with L as tier 0's unrolled words do.
// A read's arrival sets the bits up the tree only when its count leaves 0
// (atomicOr's old word tells where to stop); a slot emptied by the take or
// the expiry clears up the tree while a word becomes 0. A sparse set of
// the live ends (about coverage-many at long-read depth) was the other
// choice; the tree keeps tier 0's per-end counts and its step unchanged,
// needs no ordered structure, and costs O(levels) a change whatever the
// number of live ends.
//
// Preconditions: as blocked_sweep.cu; L a multiple of 32 with B * L < 2^31
// and B + L < 2^30; B at most 256; each group's codes sorted by start
// (code / L), as the packers emit them; in tiers 2-3 a workspace of
// W * ws_words int32 (ops/blocked.py::wide_layout).

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
constexpr int kMaskSpan = 4096;  // the largest L of tier 0's flat mask
constexpr int kMaxBlock = 256;
constexpr int kWordsPerLane = kMaskSpan / 32 / 32;  // mask words a lane keys
constexpr int kLoads = 8;  // codes a producer loads at once
constexpr size_t kMaxSmem = 232448;  // the most a CTA may have on sm_90
constexpr int kMaxLevels = 7;  // tree levels: L / 32 < 2^26 words at level 0
// offsets, targets and outputs, double-buffered (ints)
constexpr int kStaging = 6 * kMaxBlock + 2;

// the tree's levels: level j's words start at lo[j]; lo[nlev] = T
struct TreeShape {
  int lo[kMaxLevels + 1];
  int nlev;
};

TreeShape tree_shape(int L) {
  TreeShape ts{};
  int n = L / 32, off = 0, j = 0;
  for (;;) {
    ts.lo[j++] = off;
    off += n;
    if (n == 1) break;
    n = (n + 31) / 32;
  }
  ts.lo[j] = off;
  ts.nlev = j;
  return ts;
}

// loads and stores of the counts, rings and tree: in shared memory plain,
// in the global workspace past L1, where the atomics resolve
template <bool G>
__device__ __forceinline__ int32_t ld(const int32_t* p) {
  if constexpr (G) return __ldcg(p);
  else return *p;
}
template <bool G>
__device__ __forceinline__ uint32_t ld(const uint32_t* p) {
  if constexpr (G) return __ldcg(p);
  else return *p;
}
template <bool G>
__device__ __forceinline__ void st(int32_t* p, int32_t v) {
  if constexpr (G) __stcg(p, v);
  else *p = v;
}
template <bool G>
__device__ __forceinline__ void st(uint32_t* p, uint32_t v) {
  if constexpr (G) __stcg(p, v);
  else *p = v;
}

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

// The highest live slot at or below q in the tree, or -1 (every lane walks
// the same words: broadcast loads). Climb: level j's word of q masked to
// bits <= q; if 0, the words below q's word are bits <= (q >> 5) - 1 a level
// up. Descend from the level that found one by the highest bit of each word.
template <bool G>
__device__ __forceinline__ int tree_at_or_below(const uint32_t* t, const TreeShape ts,
                                                int q) {
  int found = -1;
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j) {
    if (found < 0 && q >= 0 && j < ts.nlev) {
      const uint32_t m = ld<G>(t + ts.lo[j] + (q >> 5)) & ((2u << (q & 31)) - 1u);
      if (m) {
        found = j;
        q = (q & ~31) + 31 - __clz(m);
      } else {
        q = (q >> 5) - 1;
      }
    }
  }
  if (found < 0) return -1;
#pragma unroll
  for (int j = kMaxLevels - 1; j > 0; --j)
    if (j <= found) q = 32 * q + 31 - __clz(ld<G>(t + ts.lo[j - 1] + q));
  return q;
}

// tier 1-3's top_slot: below h first, then the whole ring
template <bool G>
__device__ __forceinline__ int tree_top(const uint32_t* t, const TreeShape ts, int h, int L) {
  const int p = tree_at_or_below<G>(t, ts, h - 1);
  return p >= 0 ? p : tree_at_or_below<G>(t, ts, L - 1);
}

// slot p becomes live: set its bit, and a level up while a word was 0
// (concurrent lanes: the one whose atomicOr found the word 0 goes on)
__device__ __forceinline__ void tree_set(uint32_t* t, const TreeShape ts, int p) {
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j) {
    if (p >= 0 && j < ts.nlev) {
      const uint32_t old = atomicOr(t + ts.lo[j] + (p >> 5), 1u << (p & 31));
      p = old ? -1 : p >> 5;
    }
  }
}

// slot p is empty (one lane): clear its bit, and a level up while a word
// becomes 0
template <bool G>
__device__ __forceinline__ void tree_clear(uint32_t* t, const TreeShape ts, int p) {
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j) {
    if (p >= 0 && j < ts.nlev) {
      uint32_t* a = t + ts.lo[j] + (p >> 5);
      const uint32_t w = ld<G>(a) & ~(1u << (p & 31));
      st<G>(a, w);
      p = w ? -1 : p >> 5;
    }
  }
}

// one more read ending at physical slot p (wrapped from [0, 2L))
template <int MODE>
__device__ __forceinline__ void arrive(int32_t* av, uint32_t* mk, const TreeShape ts, int p,
                                       int L) {
  if (p >= L) p -= L;
  if constexpr (MODE == 0) {
    atomicAdd(av + p, 1);
    atomicOr(mk + (p >> 5), 1u << (p & 31));
  } else {
    if (atomicAdd(av + p, 1) == 0) tree_set(mk, ts, p);
  }
}

// warp 0: the sweep over every block, per-end counts in shared memory (or,
// MODE >= 2, in the workspace); mk is tier 0's mask or the tree
template <int MODE>
__device__ void sweep_warp(const int32_t* off_s, const int32_t* tgt_s, int32_t* out_s,
                           int32_t* av, int32_t* se, uint32_t* mk, const TreeShape ts,
                           const int32_t* __restrict__ packed,
                           const int32_t* __restrict__ avail0,
                           const int32_t* __restrict__ selend0,
                           int32_t* __restrict__ availf, int32_t* __restrict__ selendf,
                           int64_t w, int lane, int L, int B, int64_t W, int64_t cap,
                           int64_t grid_offset, int64_t nblocks) {
  constexpr bool G = MODE >= 2;   // counts in the workspace
  constexpr bool GT = MODE == 3;  // the tree in the workspace
  const int nw = L >> 5;
  // ---- carries in (avail form, slot k at physical k: h = 0); A, cur
  int A = 0, cur = 0;
  for (int k0 = 0; k0 < L; k0 += 32) {
    const int a = avail0[w * L + k0 + lane];
    const int s = selend0[w * L + k0 + lane];
    st<G>(av + k0 + lane, a);
    st<G>(se + k0 + lane, s);
    const unsigned live = __ballot_sync(kFull, a != 0);
    if (lane == 0) st<GT>(mk + (k0 >> 5), live);
    A += a;
    cur += s;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    A += __shfl_xor_sync(kFull, A, o);
    cur += __shfl_xor_sync(kFull, cur, o);
  }
  if constexpr (MODE > 0) {
    // the tree's upper levels from the mask: a bit a word not 0
#pragma unroll
    for (int j = 1; j < kMaxLevels; ++j) {
      if (j < ts.nlev) {
        __syncwarp();
        const int n = ts.lo[j] - ts.lo[j - 1];
        for (int i0 = 0; i0 < n; i0 += 32) {
          const bool nz = i0 + lane < n && ld<GT>(mk + ts.lo[j - 1] + i0 + lane) != 0u;
          const unsigned b = __ballot_sync(kFull, nz);
          if (lane == 0) st<GT>(mk + ts.lo[j] + (i0 >> 5), b);
        }
      }
    }
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
      if (o0 == o1 && tgt <= cur && ld<G>(av + h) == 0 && ld<G>(se + h) == 0) {
        // position b is quiet: nothing arrives, nothing is taken (tgt <=
        // cur), nothing ends there. Lane i looks at position b + i; up to
        // the first that is not quiet, cur and A stay and each position
        // only emits 0 and advances h.
        const int i = b + lane;
        const int hp = h + lane < L ? h + lane : h + lane - L;
        const bool quiet = i < B && of[i + 1] == of[i] && tg[i] <= cur &&
                           ld<G>(av + hp) == 0 && ld<G>(se + hp) == 0;
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
        if (lane < n) arrive<MODE>(av, mk, ts, base + code, L);
        for (int j = o0 + 32 + lane; j < o1; j += 32) arrive<MODE>(av, mk, ts, base + g[j], L);
        __syncwarp();
        A += n;
      }
      const int taken = min(max(tgt - cur, 0), A);
      // take from the highest live end down: each step ends the take or
      // empties a slot (whose bit it clears)
      for (int rem = taken; rem > 0;) {
        int p;
        if constexpr (MODE == 0) p = top_slot(mk, h, nw, lane);
        else p = tree_top<GT>(mk, ts, h, L);
        if (p < 0) break;  // A counts every live read: only bad carries get here
        int a = 0;
        if (lane == 0) a = ld<G>(av + p);
        a = __shfl_sync(kFull, a, 0);
        const int x = min(a, rem);
        if (lane == 0) {
          st<G>(av + p, a - x);
          st<G>(se + p, ld<G>(se + p) + x);
          if (a == x) {
            if constexpr (MODE == 0) mk[p >> 5] &= ~(1u << (p & 31));
            else tree_clear<GT>(mk, ts, p);
          }
        }
        rem -= x;
        __syncwarp();
      }
      // emit selend at h; the untaken reads ending at h leave; slot h
      // becomes the empty top slot
      int e = 0, a = 0;
      if (lane == 0) {
        e = ld<G>(se + h);
        a = ld<G>(av + h);
        em_s[b] = e;
        st<G>(se + h, 0);
        st<G>(av + h, 0);
        if (a) {  // a slot's bit is set iff its count is not 0
          if constexpr (MODE == 0) mk[h >> 5] &= ~(1u << (h & 31));
          else tree_clear<GT>(mk, ts, h);
        }
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
    availf[w * L + k] = ld<G>(av + p);
    selendf[w * L + k] = ld<G>(se + p);
  }
}

// warps 1..kProducerWarps: per block the offsets of each position's run in
// the group's codes, the targets, and the output flush; the availi ring is
// in shared memory, or (G) in the workspace
template <bool AUTO, bool G>
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
    for (int i = pt; i < R; i += kProducers) st<G>(ring + i, 0);
    bar_sync(kBarProducers, kProducers);
    for (int k = pt; k < L; k += kProducers) st<G>(ring + k + 1, avail0i[w * L + k]);
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
            v = of[i + 1] - of[i] - ld<G>(ring + slot);
            st<G>(ring + slot, 0);
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
      availfi[w * L + k] = ld<G>(ring + ((npos + 1 + k) & (R - 1)));
  }
}

template <int MODE, bool AUTO>
__global__ void __launch_bounds__(kThreads) blocked_sweep_wide_kernel(
    const int32_t* __restrict__ counts, const int32_t* __restrict__ packed,
    const int32_t* __restrict__ target, const int32_t* __restrict__ avail0,
    const int32_t* __restrict__ selend0, const int32_t* __restrict__ avail0i,
    int32_t* __restrict__ out, int32_t* __restrict__ availf,
    int32_t* __restrict__ selendf, int32_t* __restrict__ availfi, int32_t* ws,
    int64_t ws_words, int64_t nbw, int64_t W, int64_t cap, int L, int B, int R,
    int64_t grid_offset, int32_t max_coverage, const TreeShape ts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t w = blockIdx.x;
  int32_t *av, *se, *ring;
  uint32_t* mk;  // tier 0's mask or the tree
  int32_t* off_s;
  if constexpr (MODE <= 1) {
    av = reinterpret_cast<int32_t*>(smem);                             // [L]
    se = av + L;                                                       // [L]
    mk = reinterpret_cast<uint32_t*>(se + L);                          // [L / 32] or [T]
    off_s = reinterpret_cast<int32_t*>(mk + (MODE == 0 ? L >> 5 : ts.lo[ts.nlev]));
    ring = off_s + kStaging;                                           // [R]
  } else {
    // the workspace's window: avail [L], selend [L], ring [R], tree [T]
    av = ws + w * ws_words;
    se = av + L;
    ring = se + L;
    if constexpr (MODE == 2) {
      mk = reinterpret_cast<uint32_t*>(smem);                          // [T]
      off_s = reinterpret_cast<int32_t*>(mk + ts.lo[ts.nlev]);
    } else {
      mk = reinterpret_cast<uint32_t*>(ring + (AUTO ? R : 0));         // [T]
      off_s = reinterpret_cast<int32_t*>(smem);
    }
  }
  int32_t* tgt_s = off_s + 2 * (kMaxBlock + 1);                        // [2][kMaxBlock]
  int32_t* out_s = tgt_s + 2 * kMaxBlock;                              // [2][kMaxBlock]

  const int64_t nblocks = nbw - grid_offset;
  if (threadIdx.x < 32) {
    sweep_warp<MODE>(off_s, tgt_s, out_s, av, se, mk, ts, packed, avail0, selend0, availf,
                     selendf, w, threadIdx.x, L, B, W, cap, grid_offset, nblocks);
  } else {
    produce<AUTO, (MODE >= 2)>(off_s, tgt_s, out_s, ring, counts, packed, target, avail0i,
                               out, availfi, w, nbw, W, cap, L, B, R, nblocks, grid_offset,
                               max_coverage);
  }
}

// The shared memory and workspace words a window of tier `mode` at (L, R)
// take (ops/blocked.py::wide_layout mirrors this; ops/blocked.py::wide_tier
// picks the tier)
struct Tier {
  int mode;
  size_t smem;
  int64_t ws_words;
};

Tier tier_layout(int mode, int L, int64_t R, const TreeShape& ts) {
  const int64_t T = ts.lo[ts.nlev];
  switch (mode) {
    case 0:
      return {0, sizeof(int32_t) * static_cast<size_t>(2 * L + L / 32 + kStaging + R), 0};
    case 1:
      return {1, sizeof(int32_t) * static_cast<size_t>(2 * int64_t{L} + T + kStaging + R), 0};
    case 2:
      return {2, sizeof(int32_t) * static_cast<size_t>(T + kStaging), 2 * int64_t{L} + R};
    default:
      return {3, sizeof(int32_t) * kStaging, 2 * int64_t{L} + R + T};
  }
}

template <int MODE, bool AUTO>
cudaError_t launch_mode(const int32_t* counts, const int32_t* packed, const int32_t* target,
                        const int32_t* avail0, const int32_t* selend0, const int32_t* avail0i,
                        int32_t* out, int32_t* availf, int32_t* selendf, int32_t* availfi,
                        int32_t* ws, const Tier& tier, int64_t nbw, int64_t W, int64_t cap,
                        int L, int B, int R, int64_t grid_offset, int32_t max_coverage,
                        const TreeShape& ts, cudaStream_t stream) {
  auto kernel = blocked_sweep_wide_kernel<MODE, AUTO>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(tier.smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(W), kThreads, tier.smem, stream>>>(
      counts, packed, target, avail0, selend0, avail0i, out, availf, selendf, availfi, ws,
      tier.ws_words, nbw, W, cap, L, B, R, grid_offset, max_coverage, ts);
  return cudaGetLastError();
}

template <bool AUTO>
cudaError_t launch(const int32_t* counts, const int32_t* packed, const int32_t* target,
                   const int32_t* avail0, const int32_t* selend0, const int32_t* avail0i,
                   int32_t* out, int32_t* availf, int32_t* selendf, int32_t* availfi,
                   int32_t* ws, int64_t ws_bytes, int mode, int64_t nbw, int64_t W, int64_t cap,
                   int L, int B, int64_t grid_offset, int32_t max_coverage,
                   cudaStream_t stream) {
  // the availi ring: a power of two above B + L, so a block's arrivals
  // never reach a slot still to be read
  int R = 1;
  if (AUTO)
    while (R < B + L + 1) R <<= 1;
  const TreeShape ts = tree_shape(L);
  const Tier tier = tier_layout(mode, L, AUTO ? R : 0, ts);
  if ((mode == 0) != (L <= kMaskSpan) || tier.smem > kMaxSmem) return cudaErrorInvalidValue;
  if (tier.ws_words && (ws == nullptr || ws_bytes < W * tier.ws_words * 4))
    return cudaErrorInvalidValue;
  switch (tier.mode) {
    case 0:
      return launch_mode<0, AUTO>(counts, packed, target, avail0, selend0, avail0i, out,
                                  availf, selendf, availfi, ws, tier, nbw, W, cap, L, B, R,
                                  grid_offset, max_coverage, ts, stream);
    case 1:
      return launch_mode<1, AUTO>(counts, packed, target, avail0, selend0, avail0i, out,
                                  availf, selendf, availfi, ws, tier, nbw, W, cap, L, B, R,
                                  grid_offset, max_coverage, ts, stream);
    case 2:
      return launch_mode<2, AUTO>(counts, packed, target, avail0, selend0, avail0i, out,
                                  availf, selendf, availfi, ws, tier, nbw, W, cap, L, B, R,
                                  grid_offset, max_coverage, ts, stream);
    default:
      return launch_mode<3, AUTO>(counts, packed, target, avail0, selend0, avail0i, out,
                                  availf, selendf, availfi, ws, tier, nbw, W, cap, L, B, R,
                                  grid_offset, max_coverage, ts, stream);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The arguments are
// gd_blocked_sweep's with, after availfi, the workspace ws (null where the
// tier keeps everything in shared memory) and, after max_coverage, its size
// in bytes and the tier (ops/blocked.py::wide_tier picks it: 0 up to L =
// 4,096, 1-3 above; a tier whose shared memory does not fit is refused): any
// L = 32 * S with B * L < 2^31 and B + L < 2^30, B at most 256; every count
// here is int32.
extern "C" int gd_blocked_sweep_wide(
    const void* counts, const void* packed, const void* target, const void* avail0,
    const void* selend0, const void* avail0i, void* out, void* availf, void* selendf,
    void* availfi, void* ws, int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t L,
    int64_t grid_offset, int64_t auto_target, int64_t max_coverage, int64_t ws_bytes,
    int64_t tier, void* stream) {
  if (B > kMaxBlock || B < 1 || W < 1 || grid_offset < 0 || grid_offset >= nbw || cap < 0 ||
      L < 32 || L % 32 != 0 || B * L >= (int64_t{1} << 31) || B + L >= (int64_t{1} << 30) ||
      tier < 0 || tier > 3)
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
  auto wsp = static_cast<int32_t*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  const int32_t m = static_cast<int32_t>(max_coverage);
  const int l = static_cast<int>(L), b = static_cast<int>(B), mode = static_cast<int>(tier);
  if (auto_target)
    return (int)launch<true>(c, p, tg, a0, s0, i0, o, af, sf, fi, wsp, ws_bytes, mode, nbw, W,
                             cap, l, b, grid_offset, m, st);
  return (int)launch<false>(c, p, tg, a0, s0, i0, o, af, sf, fi, wsp, ws_bytes, mode, nbw, W,
                            cap, l, b, grid_offset, m, st);
}
