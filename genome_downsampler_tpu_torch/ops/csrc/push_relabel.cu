// The push-relabel kernel: quasi-mcp-flow-cuda's whole solve (global
// relabels and supersteps) in one cooperative launch, for NVIDIA Hopper
// (sm_90a).
//
// Replaces two XLA device programs of genome_downsampler_tpu/solvers/
// push_relabel.py: the distance closure `_dist_closure` (lines 191-236),
// run twice by each global relabel (291-311), and the superstep `body`
// (316-362), with the outer loop around them (364-376). The network, the
// label-parity waves and the line-scan relabel are described there and in
// ops/push_relabel.py; the torch program of solvers/push_relabel.py is
// this kernel's plain twin, which it equals bit for bit (flows, excess,
// labels, steps, global relabels, closure rounds).
//
// What bounds it on the H100. The work is sequential: thousands of closure
// rounds (12,299 at config-1: the read-arc hops on a shortest path, per
// closure) and hundreds of supersteps, each needing every node's state
// from the step before. A round moves about 8 bytes a node and 10 a
// distinct read arc, a superstep 28 bytes an arc at most: microseconds of
// the card's memory rate, far below what a chain of grid-wide dependencies
// costs. So what binds is the grid barriers a round must pass (about 2 us
// each with their fold at config-1 on 117 CTAs) and the L2 round trips of
// the hops' gathers.
//
// What the design does about it. One persistent cooperative grid of
// G = min(SMs, ceil((n + 1) / 256)) CTAs of 256 threads (ops/ssp.py:
// grid_shape); CTA c owns the line nodes [c C, (c + 1) C), C =
// ceil((n + 1) / G), and keeps their d, labels, excess and flags in shared
// memory for the whole solve (in its own region of the workspace where
// C is too large for shared memory: above about 840,000 nodes on 132 SMs).
// The source S = n + 1 and sink T = n + 2 only receive flow; the last CTA
// keeps their excess.
//
// A closure round is two grid barriers (grid_sync.cuh).
//   1. The record barrier. Each CTA scans its chunk with no carry: lp(i),
//      the in-chunk prefix-min of the down keys d(j) - j, gives the
//      carry-free downward closure D(i) = min(d(i), lp(i) + i); the
//      reverse scan, segmented where the chain carries no flow (the
//      `_seg_min` combiner), gives xs(i), the min of x(j) = min(D(j) + j,
//      BIG) over j from i up to the end of i's run inside the chunk, and
//      whether that run reaches the chunk's upper end. With the chunk's
//      carry k (the min of the down keys of every chunk before it), the
//      twin's closure is d'(i) = min(D(i), k + i) downward, and each up
//      key d'(j) + j, saturated at BIG as the twin's last step saturates,
//      is min(x(j), k + 2 j): so a chunk's up aggregate is
//      min(X_c, k + 2 lo_c), X_c the carry-free one. Each CTA publishes
//      one record (its down aggregate, its segment flag, X_c and whether
//      the last round lowered a node) and, for every node, the words
//      (D, xs, reaches the upper end). After the barrier every CTA reads
//      all G records (one a thread), computes every chunk's carry with a
//      block prefix-min, every chunk's up aggregate from it, and folds them
//      segmented from the last chunk; from a node's words, its chunk's
//      carry and its chunk's fold from above, any CTA has the node's
//      post-closure d. The stop test, any(d < d0), rides on the record.
//   2. Snapshot 2. The forward hop d[start] <- min(d[start], d[end + 1] +
//      1) reads the post-closure d of other chunks' nodes from their
//      published words (no snapshot: the words are rewritten only by the
//      next round's record, behind this round's snapshot barrier); then
//      every CTA writes its d to snapshot 2, and the backward hop d[end +
//      1] <- min(d[end + 1], d[start] + 1) reads it (the Gauss-Seidel order
//      of the twin: the round counts depend on it).
// The records are double-buffered, because two record barriers follow one
// another with no barrier between them where a pass has no hops.
// Both hops are tail-owned and read tables of distinct arcs: the wrapper
// groups the valid reads by (tail, other end) for each direction, and at
// each global relabel a CTA compacts one entry a group of its tails with a
// residual member (forward: a member with no flow; backward: a member with
// flow), into shared memory where the CTA's groups fit (a template
// argument; else its region of the workspace). A hop takes the min over
// its arcs, so equal arcs give one value. Each node takes the min over its
// own entries (atomicMin in shared memory, which does not depend on order)
// and no global atomics are needed.
//
// A superstep is two grid barriers. Each eligible line node (excess > 0,
// label parity == step parity) is walked along its arc segment (the
// tail-sorted table): residuals through the arc's kind and slot, head
// labels from the pre-wave buffer, an int64 inclusive prefix of what the
// admissible arcs want, each arc taking min(remaining, want) exactly as the
// twin's segmented exclusive prefix clipped to the excess; the walk stops
// when the excess is spent. One warp walks a short segment, 32 arcs a
// step. A segment of kCtaWalkArcs arcs or more (an amplicon panel's primer
// starts and amplicon ends: hundreds to thousands of reads at one node) is
// walked by the node's whole CTA, kTile arcs a step, with a block-wide
// prefix carried across the tiles and the next tile's arcs loaded before
// this tile's scan: a warp took one dependent step per 32 arcs of a
// 10,000-arc segment while the grid waited at barrier 1. A CTA walks its
// long nodes one after another, then its warps walk the short ones. The
// order of the walks is free, since each flow slot is written by its arc's
// tail alone and the sums into `in` do not depend on order. Flow writes
// need no atomics: an arc pushes only from label l + 1 to l and only nodes
// of one label parity push in a wave, so at most one direction of any flow
// slot pushes, from its one tail, and no node reads a slot's residual that
// another node writes in the same wave (the label test comes first, and
// fails for the reverse arc of a pushing arc; a CTA walk loads the flow
// beside the label and drops it where the test fails). What reaches a head
// goes by an integer atomicAdd into `in`, whose sums do not depend on
// order. After barrier 1 each owner applies excess -= out - in and
// relabels eligible nodes that pushed nothing to min(1 + min label over
// post-wave residual arcs, 2 (n + 3)), reading head labels from the
// pre-wave buffer and writing the next buffer (other CTAs still read the
// old one), a long segment by its CTA, a short one by a warp; barrier 2
// publishes the new labels and whether any node is still active, and the
// buffers swap. `step` advances once a superstep; no-op bodies never run.
//
// The loop: while a node is active and step < max_supersteps, one global
// relabel (both closures, labels dT | n + 3 + dS | 2 (n + 3)), then
// supersteps while active and step < min(step + relabel_every,
// max_supersteps). CTA 0 counts the global-timer nanoseconds and clock64
// cycles inside global relabels and inside supersteps; every warp counts
// the arcs its walks read (a superstep's bytes depend on them), a walk
// that stops counting to the end of its step (32 arcs a warp, kTile a
// CTA), and thread 0 of each CTA also the arcs its CTA walks read.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "grid_sync.cuh"

// the dynamic shared memory: a CTA's node arrays (unless in the workspace),
// then its two hop tables
extern __shared__ __align__(16) int32_t smem[];

namespace {

using gd::grid_sync;
using gd::ldcg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = kThreads;  // G <= kThreads: one record a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t BIG = 1 << 30;
constexpr int32_t kNone = INT_MAX;  // identity of the min scans
// shared int32 arrays of C entries each: d, dold, dT, flag, lab, ex, out,
// elig, list (the closure's dc, xs and reach share out, elig and list,
// which only supersteps use)
constexpr int kNodeArrays = 9;
// a direction's compacted hop entries a CTA may hold in shared memory
// beside its node arrays; more stay in the CTA's region of the workspace
constexpr int kTabCapMax = 4096;
// a node whose arc segment holds this many arcs or more is walked by its
// whole CTA (the superstep's note), kTileItems consecutive arcs a thread,
// kTile a step. Set on the H100: at 256 a clinical ARTIC sample's ~260-arc
// primer segments go to their CTAs (its kernel 1.6% faster than at 1,024);
// at 128 half the nodes of 1M uniform pairs over 30 kb (~137 arcs) do, and
// CTAs walking dozens of nodes one after another took 13% longer there.
// Tiles of 2 items a thread were 5.5% slower on a deep ARTIC sample, of 8
// 0.7% faster for 40 more registers.
constexpr int kCtaWalkArcs = 256;
constexpr int kTileItems = 4;
constexpr int kTile = kThreads * kTileItems;

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// prefix (pf, pv) then (f, v): the segmented min of `_seg_min`
__device__ __forceinline__ void seg_combine(int pf, int pv, int& f, int& v) {
  if (!f) v = min(pv, v);
  f |= pf;
}

struct Shared {
  int wv[kWarps];  // each warp's total / prefix (scans, reductions)
  int wf[kWarps];
  long long wl[kWarps];
  long long tl[2][kWarps];  // each warp's total in a CTA walk, by tile parity
  int cnt, cntL, cntF, cntB;
  unsigned bar_target;  // thread 0's count of grid barrier arrivals
  // after the record barrier: every chunk's carry (the min of the down
  // keys of the chunks before it), and every chunk's up aggregate, then
  // the fold of the chunks after it (its reverse scan's carry)
  int carry[kMaxCtas];
  int up[kMaxCtas];
  int upf[kMaxCtas];
};
// ops/push_relabel.py::_SMEM_BUDGET leaves this much of a CTA's shared
// memory to it
static_assert(sizeof(Shared) <= 4096, "Shared outgrew the wrapper's budget");

// a block-wide sum; every thread gets the result
__device__ long long block_sum(long long v, Shared& sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) sh.wl[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < kWarps; ++w) v += sh.wl[w];
  __syncthreads();
  return v;
}

// Exclusive min over the threads' values, in thread order; `tot` gets the
// min of all. The identity is kNone.
__device__ int block_min_excl(int v, int& tot, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int w = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int p = __shfl_up_sync(kFull, w, o);
    if (lane >= o) w = min(w, p);
  }
  if (lane == 31) sh.wv[warp] = w;
  const int pe = __shfl_up_sync(kFull, w, 1);
  __syncthreads();
  int x = kNone;
  tot = kNone;
  for (int q = 0; q < kWarps; ++q) {
    if (q == warp) x = tot;
    tot = min(tot, sh.wv[q]);
  }
  __syncthreads();
  return lane > 0 ? min(x, pe) : x;
}

// Exclusive segmented scan over the threads' aggregates (f, v), in thread
// order: (ef, ev) the fold of the threads before this one, (tf, tv) the
// fold of all. The identity is (0, kNone).
__device__ void block_seg_excl(int f, int v, int& ef, int& ev, int& tf, int& tv, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int wf = f, wv = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int pf = __shfl_up_sync(kFull, wf, o);
    const int pv = __shfl_up_sync(kFull, wv, o);
    if (lane >= o) seg_combine(pf, pv, wf, wv);
  }
  if (lane == 31) {
    sh.wf[warp] = wf;
    sh.wv[warp] = wv;
  }
  int pf = __shfl_up_sync(kFull, wf, 1);
  int pv = __shfl_up_sync(kFull, wv, 1);
  __syncthreads();
  int xf = 0, xv = kNone;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      ef = xf;
      ev = xv;
    }
    int yf = sh.wf[w], yv = sh.wv[w];
    seg_combine(xf, xv, yf, yv);
    xf = yf;
    xv = yv;
  }
  tf = xf;
  tv = xv;
  if (lane > 0) {
    seg_combine(ef, ev, pf, pv);
    ef = pf;
    ev = pv;
  }
  __syncthreads();
}

// the static tables (ops/push_relabel.py: kernel_arc_table, hop_tables)
struct Net {
  // the tail-sorted arcs: (head, slot << 3 | kind); line node v's segment
  // is [off[v], off[v + 1])
  const int2* __restrict__ arcs;
  const int32_t* __restrict__ off;
  // each direction's hop table: the valid reads sorted by (tail, other
  // end), rows (read, group), CTA c's share [range[c], range[c + 1]); and
  // the groups, rows (tail, other end), CTA c's [grange[c], grange[c + 1])
  const int2* __restrict__ hopF;
  const int32_t* __restrict__ rangeF;
  const int2* __restrict__ grpF;
  const int32_t* __restrict__ grangeF;
  const int2* __restrict__ hopB;
  const int32_t* __restrict__ rangeB;
  const int2* __restrict__ grpB;
  const int32_t* __restrict__ grangeB;
  const int32_t* __restrict__ cap_src;  // int32[n + 1]
  const int32_t* __restrict__ cap_snk;  // int32[n + 1]
  int n, R, tab_cap;
};

// the solve's state (outputs, written in place) and the workspace
// (ops/push_relabel.py: _ws_words); not restrict: CTAs share them
struct Glob {
  int32_t *f_read, *f_chain, *f_src, *f_snk, *excess, *labA;
  unsigned* bar;
  // per-CTA partials: the records, two buffers of G (down aggregate,
  // segment flag, up aggregate, lowered), the excess left, active
  int4* rec;
  long long* left;
  int32_t* act;
  // each line node's closure words of the current round (D, xs, reach, 0)
  int4* words;
  int32_t *labB, *in, *snap2;
  // the compacted hop entries of CTAs whose groups exceed shared memory,
  // at the CTA's groups; a flag a group (residual this global relabel)
  int2 *cf, *cb;
  int32_t *flagF, *flagB;
};

// the CTA's line nodes; node arrays in shared memory
struct Chunk {
  // first node, nodes, items a thread holds in the scans, C, n + 1
  int lo, cl, K, C, n1;
  int wide;  // whether a node of the chunk has a long segment (kCtaWalkArcs)
  int32_t *d, *dold, *dT, *flag, *lab, *ex, *out, *elig, *list;
  int32_t *dc, *xs, *reach;  // the closure's words (out, elig, list)
};

// ---- the distance closure ----

__device__ __forceinline__ int32_t down_key(const Chunk& ch, int i) {
  return ch.d[i] >= BIG ? BIG : ch.d[i] - (ch.lo + i);
}
// the carry-free up key of node i: min(D(i) + i, BIG)
__device__ __forceinline__ int32_t x_key(const Chunk& ch, int i) {
  return ch.dc[i] >= BIG ? BIG : min(ch.dc[i] + (ch.lo + i), BIG);
}

// this thread's min of d(j) - j over its nodes [tK, tK + K)
__device__ int down_items(const Chunk& ch) {
  int m = kNone;
  for (int j = 0; j < ch.K; ++j) {
    const int i = threadIdx.x * ch.K + j;
    if (i >= ch.cl) break;
    m = min(m, down_key(ch, i));
  }
  return m;
}

// the carry-free downward closure D(i) = min(d(i), lp(i) + i) into dc, and
// (kWs false) d into dold; `run` the in-chunk min over the nodes before
// this thread's first
template <bool kWs>
__device__ void closure_down(const Chunk& ch, int run) {
  for (int j = 0; j < ch.K; ++j) {
    const int i = threadIdx.x * ch.K + j;
    if (i >= ch.cl) break;
    const int32_t d = ch.d[i];
    run = min(run, down_key(ch, i));
    if (!kWs) ch.dold[i] = d;
    ch.dc[i] = min(d, run >= BIG ? BIG : run + ch.lo + i);
  }
}

// The reverse scan runs over the chunk from its last node down: scan item
// q is node cl - 1 - q. A segment starts (in scan order) at every node
// whose upward chain arc has no residual (flag). This thread's (flag, min)
// fold of its items:
__device__ void up_items(const Chunk& ch, int& f, int& v) {
  f = 0;
  v = kNone;
  for (int j = 0; j < ch.K; ++j) {
    const int q = threadIdx.x * ch.K + j;
    if (q >= ch.cl) break;
    const int i = ch.cl - 1 - q;
    int fi = ch.flag[i], vi = x_key(ch, i);
    seg_combine(f, v, fi, vi);
    f = fi;
    v = vi;
  }
}

// each node's in-chunk suffix xs and whether its run reaches the chunk's
// upper end into the published words, and (kWs false) into shared memory;
// (ef, ev) the fold before this thread's first item
template <bool kWs>
__device__ void publish_up(const Chunk& ch, const Glob& g, int ef, int ev) {
  for (int j = 0; j < ch.K; ++j) {
    const int q = threadIdx.x * ch.K + j;
    if (q >= ch.cl) break;
    const int i = ch.cl - 1 - q;
    int fi = ch.flag[i], vi = x_key(ch, i);
    seg_combine(ef, ev, fi, vi);
    ef = fi;
    ev = vi;
    if (!kWs) {
      ch.xs[i] = ev;
      ch.reach[i] = !ef;
    }
    __stcg(g.words + ch.lo + i, make_int4(ch.dc[i], ev, !ef, 0));
  }
}

// Node gi's post-closure d from its words (dc, xs, reach), its chunk's
// carry and its chunk's fold from above. The twin's quirk kept: a run that
// reaches nothing gives BIG - gi.
__device__ __forceinline__ int32_t closed(int32_t dc, int32_t xs, int reach, int carry, int above,
                                          int gi) {
  const int32_t down = carry >= BIG ? BIG : carry + gi;
  int32_t sm = carry >= BIG ? xs : min(xs, carry + 2 * gi);
  if (reach) sm = min(sm, above);
  return min(min(dc, down), min(sm, BIG) - gi);
}

// an entry of a compacted hop table, in shared memory or the workspace
template <bool kTabSmem>
__device__ __forceinline__ int2 entry(const int2* tab, int j) {
  return kTabSmem ? tab[j] : __ldcg(tab + j);
}

// The fixpoint from the seed in ch.d (the twin's dist_closure): one closure,
// then rounds of (closure, forward hop, backward hop) until no node drops.
// `recbuf` alternates the record buffers over the whole solve. Returns the
// rounds. With the node arrays in the workspace (kWs) a CTA copies d to
// dold in node order and closes its chunk from its own published words,
// read in node order, rather than from xs and reach: the scans write a
// thread's run at a time, one warp's writes far apart in memory.
template <bool kWs, bool kTabSmem>
__device__ int closure(const Chunk& ch, const Glob& g, Shared& sh, int& recbuf, int cntF,
                       int cntB, const int2* tf, const int2* tb) {
  const int tid = threadIdx.x, c = blockIdx.x, G = gridDim.x;
  int pass = 0, my_chg = 0;
  for (;;) {
    if (kWs)
      for (int i = tid; i < ch.cl; i += kThreads) ch.dold[i] = ch.d[i];
    // the in-chunk scans, carry-free: the down aggregate, D, the up
    // aggregate and each node's words
    int tot;
    const int ex_down = block_min_excl(down_items(ch), tot, sh);
    closure_down<kWs>(ch, ex_down);
    __syncthreads();
    int uf, uv, ef, ev, tfl, tv;
    up_items(ch, uf, uv);
    block_seg_excl(uf, uv, ef, ev, tfl, tv, sh);
    publish_up<kWs>(ch, g, ef, ev);
    int4* rec = g.rec + recbuf * G;
    recbuf ^= 1;
    if (tid == 0) __stcg(rec + c, make_int4(tot, tfl, tv, my_chg));
    // the record barrier
    grid_sync(g.bar, sh.bar_target);
    const int4 r = tid < G ? __ldcg(rec + tid) : make_int4(kNone, 0, kNone, 0);
    const int any = __syncthreads_or(r.w);
    if (pass >= 2 && !any) break;
    int all;
    const int carry_t = block_min_excl(r.x, all, sh);
    if (tid < G) {
      sh.carry[tid] = carry_t;
      // an empty chunk's (0, kNone) stays the fold's identity
      sh.up[tid] = carry_t >= BIG || r.z == kNone
                       ? r.z
                       : min(r.z, carry_t + 2 * min(tid * ch.C, ch.n1));
      sh.upf[tid] = r.y;
    }
    __syncthreads();
    // every chunk's reverse-scan carry: thread u folds the chunks after
    // chunk G - 1 - u, the last chunk first
    int pf = 0, pv = kNone;
    if (tid < G) {
      pf = sh.upf[G - 1 - tid];
      pv = sh.up[G - 1 - tid];
    }
    int xf, xv, af, av;
    block_seg_excl(pf, pv, xf, xv, af, av, sh);
    if (tid < G) sh.up[G - 1 - tid] = xv;
    __syncthreads();
    const int carry = sh.carry[c], above = sh.up[c];
    for (int i = tid; i < ch.cl; i += kThreads) {
      if (kWs) {
        const int4 w = __ldcg(g.words + ch.lo + i);
        ch.d[i] = closed(w.x, w.y, w.z, carry, above, ch.lo + i);
      } else {
        ch.d[i] = closed(ch.dc[i], ch.xs[i], ch.reach[i], carry, above, ch.lo + i);
      }
    }
    __syncthreads();
    if (pass == 0) {  // the closure before the first round
      pass = 1;
      continue;
    }
    // the round's hops: forward from the other ends' published words
    for (int j = tid; j < cntF; j += kThreads) {
      const int2 e = entry<kTabSmem>(tf, j);
      const int k = e.y / ch.C;
      const int4 w = __ldcg(g.words + e.y);
      const int32_t x = closed(w.x, w.y, w.z, sh.carry[k], sh.up[k], e.y);
      if (x < BIG) atomicMin(&ch.d[e.x], x + 1);
    }
    __syncthreads();
    // snapshot 2, then the backward hop from it
    for (int i = tid; i < ch.cl; i += kThreads) g.snap2[ch.lo + i] = ch.d[i];
    grid_sync(g.bar, sh.bar_target);
    for (int j = tid; j < cntB; j += kThreads) {
      const int2 e = entry<kTabSmem>(tb, j);
      const int32_t x = ldcg(g.snap2 + e.y);
      if (x < BIG) atomicMin(&ch.d[e.x], x + 1);
    }
    __syncthreads();
    int lowered = 0;
    for (int i = tid; i < ch.cl; i += kThreads) lowered |= ch.d[i] < ch.dold[i];
    my_chg = __syncthreads_or(lowered);
    ++pass;
  }
  return pass - 1;
}

// One direction's residual groups of this CTA, one entry each, into `tab`
// (order is free: the hops take a min); `want_flow` picks the direction.
// Returns the entries.
__device__ int compact(const Glob& g, const Chunk& ch, Shared& sh, const int2* hop,
                       const int32_t* range, const int2* grp, const int32_t* grange,
                       int32_t* flag, bool want_flow, int2* tab) {
  const int tid = threadIdx.x, c = blockIdx.x;
  const int g0 = grange[c], g1 = grange[c + 1];
  if (tid == 0) sh.cnt = 0;
  for (int q = g0 + tid; q < g1; q += kThreads) __stcg(flag + q, 0);
  __syncthreads();
  for (int j = range[c] + tid; j < range[c + 1]; j += kThreads) {
    const int2 e = hop[j];
    if ((ldcg(g.f_read + e.x) > 0) == want_flow) __stcg(flag + e.y, 1);
  }
  __syncthreads();
  for (int q = g0 + tid; q < g1; q += kThreads) {
    if (__ldcg(flag + q)) {
      const int2 e = grp[q];
      tab[atomicAdd(&sh.cnt, 1)] = make_int2(e.x - ch.lo, e.y);
    }
  }
  __syncthreads();
  const int cnt = sh.cnt;
  __syncthreads();
  return cnt;
}

// Exact residual distances to T, then to S, and the labels from them
// (written to the current buffer); returns the closure rounds.
template <bool kWs, bool kTabSmem>
__device__ int global_relabel(const Net& net, const Glob& g, const Chunk& ch, Shared& sh,
                              int32_t* lab_cur, int& recbuf, int2* tf, int2* tb) {
  const int tid = threadIdx.x, n = net.n;
  const int num_nodes = n + 3;
  // the residual groups of each direction (the flags do not change during
  // the two closures)
  const int cntF = compact(g, ch, sh, net.hopF, net.rangeF, net.grpF, net.grangeF, g.flagF,
                           false, tf);
  const int cntB = compact(g, ch, sh, net.hopB, net.rangeB, net.grpB, net.grangeB, g.flagB,
                           true, tb);
  // reverse-scan segment starts, and the seed of the distance to T
  for (int i = tid; i < ch.cl; i += kThreads) {
    const int gi = ch.lo + i;
    ch.flag[i] = gi == n || ldcg(g.f_chain + gi) == 0;
    ch.d[i] = sub32(net.cap_snk[gi], ldcg(g.f_snk + gi)) > 0 ? 1 : BIG;
  }
  __syncthreads();
  int rounds = closure<kWs, kTabSmem>(ch, g, sh, recbuf, cntF, cntB, tf, tb);
  // nodes cut off from T route excess back to S
  for (int i = tid; i < ch.cl; i += kThreads) {
    ch.dT[i] = ch.d[i];
    ch.d[i] = ldcg(g.f_src + ch.lo + i) > 0 ? 1 : BIG;
  }
  __syncthreads();
  rounds += closure<kWs, kTabSmem>(ch, g, sh, recbuf, cntF, cntB, tf, tb);
  for (int i = tid; i < ch.cl; i += kThreads) {
    const int32_t dT = ch.dT[i], dS = ch.d[i];
    const int32_t l = dT < BIG ? dT : (dS < BIG ? num_nodes + dS : 2 * num_nodes);
    ch.lab[i] = l;
    lab_cur[ch.lo + i] = l;
  }
  grid_sync(g.bar, sh.bar_target);
  return rounds;
}

// ---- the superstep ----

// an arc's residual from the flows (kind 5, T -> i, has no line tail)
__device__ __forceinline__ int32_t residual(const Net& net, const Glob& g, int kind, int slot) {
  switch (kind) {
    case 0: return 1 - ldcg(g.f_read + slot);  // read_fwd (valid reads only)
    case 1: return ldcg(g.f_read + slot);      // read_bwd
    case 2: return BIG - ldcg(g.f_chain + slot);  // chain_fwd
    case 3: return ldcg(g.f_chain + slot);     // chain_bwd
    case 4: return ldcg(g.f_src + slot);       // src_bwd
    case 5: return ldcg(g.f_snk + slot);       // snk_bwd
    default: return sub32(net.cap_snk[slot], ldcg(g.f_snk + slot));  // snk_fwd
  }
}

// push `amt` along the arc: only this arc's tail writes its slot this wave
__device__ __forceinline__ void push(const Glob& g, int kind, int slot, int32_t amt) {
  int32_t* p;
  bool up = true;
  switch (kind) {
    case 0: p = g.f_read; break;
    case 1: p = g.f_read; up = false; break;
    case 2: p = g.f_chain; break;
    case 3: p = g.f_chain; up = false; break;
    case 4: p = g.f_src; up = false; break;
    case 5: p = g.f_snk; up = false; break;
    default: p = g.f_snk; break;
  }
  const int32_t f = ldcg(p + slot);
  p[slot] = up ? add32(f, amt) : sub32(f, amt);
}

// one warp discharges chunk node i along its segment, 32 arcs a step;
// lane 0 counts the arcs the warp read into `walked`
__device__ void discharge(const Net& net, const Glob& g, const Chunk& ch, int i,
                          const int32_t* lab_cur, long long& walked) {
  const int lane = threadIdx.x & 31;
  const int gi = ch.lo + i, a1 = net.off[gi + 1];
  const int32_t lt = ch.lab[i], ex = ch.ex[i];
  long long rem = ex;
  for (int base = net.off[gi]; base < a1; base += 32) {
    const int a = base + lane;
    long long want = 0;
    int head = 0, kind = 0, slot = 0;
    if (a < a1) {
      const int2 e = net.arcs[a];
      head = e.x;
      kind = e.y & 7;
      slot = e.y >> 3;
      if (lt == ldcg(lab_cur + head) + 1) {
        const int32_t r = residual(net, g, kind, slot);
        if (r > 0) want = r;
      }
    }
    long long incl = want;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long p = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += p;
    }
    const long long amt = min(max(rem - (incl - want), 0LL), want);
    if (amt > 0) {
      push(g, kind, slot, static_cast<int32_t>(amt));
      atomicAdd(g.in + head, static_cast<int32_t>(amt));
    }
    rem -= __shfl_sync(kFull, incl, 31);
    if (lane == 0) walked += min(32, a1 - base);
    if (rem <= 0) break;
  }
  if (lane == 0) ch.out[i] = static_cast<int32_t>(ex - max(rem, 0LL));
}

// one warp relabels chunk node i: 1 + the least pre-wave head label over
// its post-wave residual arcs, at most 2 (n + 3)
__device__ void relabel(const Net& net, const Glob& g, const Chunk& ch, int i,
                        const int32_t* lab_cur, int32_t cap, long long& walked) {
  const int lane = threadIdx.x & 31;
  const int gi = ch.lo + i, a1 = net.off[gi + 1];
  if (lane == 0) walked += a1 - net.off[gi];
  int32_t m = cap;
  for (int a = net.off[gi] + lane; a < a1; a += 32) {
    const int2 e = net.arcs[a];
    if (residual(net, g, e.y & 7, e.y >> 3) > 0) m = min(m, ldcg(lab_cur + e.x));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
  if (lane == 0) ch.lab[i] = min(m + 1, cap);
}

// ---- the CTA walks of long segments ----

// the flow word behind an arc's residual; kinds 0, 2 and 6 push it up
__device__ __forceinline__ int32_t* flow_word(const Glob& g, int kind, int slot) {
  return (kind <= 1 ? g.f_read : kind <= 3 ? g.f_chain : kind == 4 ? g.f_src : g.f_snk) + slot;
}

// this thread's kTileItems arcs from a (zeros past a1)
__device__ __forceinline__ void load_arcs(const Net& net, int a, int a1,
                                          int2 (&e)[kTileItems]) {
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) e[j] = a + j < a1 ? net.arcs[a + j] : make_int2(0, 0);
}

// each arc's head label and flow word (f) and residual (r) from them: every
// load issued before any is used; an arc past the segment gets r = 0
__device__ __forceinline__ void load_tile(const Net& net, const Glob& g, const int32_t* lab_cur,
                                          int a, int a1, const int2 (&e)[kTileItems],
                                          int32_t (&hl)[kTileItems], int32_t (&f)[kTileItems],
                                          int32_t (&r)[kTileItems]) {
  int32_t cs[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int kind = e[j].y & 7, slot = e[j].y >> 3;
    hl[j] = ldcg(lab_cur + e[j].x);
    f[j] = ldcg(flow_word(g, kind, slot));
    cs[j] = kind == 6 ? net.cap_snk[slot] : 0;
  }
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int kind = e[j].y & 7;
    const int32_t res = kind == 0   ? 1 - f[j]
                        : kind == 2 ? BIG - f[j]
                        : kind == 6 ? sub32(cs[j], f[j])
                                    : f[j];
    r[j] = a + j < a1 ? res : 0;
  }
}

// The whole CTA discharges chunk node i along its long segment, kTile arcs
// a step: each thread's kTileItems consecutive arcs, a block-wide int64
// exclusive prefix of their wants carried across tiles in `rem`, the next
// tile's arcs loaded before this tile's scan. `buf` alternates the warp
// totals' buffers over the CTA's walks, so no walk waits at its end.
// Thread 0 writes out[i] and counts the arcs read (whole tiles).
__device__ void discharge_cta(const Net& net, const Glob& g, const Chunk& ch, Shared& sh, int i,
                              const int32_t* lab_cur, int& buf, long long* walked) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = ch.lo + i, a0 = net.off[gi], a1 = net.off[gi + 1];
  const int32_t lt = ch.lab[i], ex = ch.ex[i];
  long long rem = ex;
  int2 e[kTileItems], nx[kTileItems];
  load_arcs(net, a0 + tid * kTileItems, a1, e);
  int base = a0;
  for (;;) {
    const int a = base + tid * kTileItems;
    int32_t hl[kTileItems], f[kTileItems], r[kTileItems];
    load_tile(net, g, lab_cur, a, a1, e, hl, f, r);
    load_arcs(net, a + kTile, a1, nx);
    long long want[kTileItems], s = 0;
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) {
      want[j] = lt == hl[j] + 1 && r[j] > 0 ? r[j] : 0;
      s += want[j];
    }
    long long w = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long p = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += p;
    }
    if (lane == 31) sh.tl[buf][warp] = w;
    __syncthreads();
    long long before = 0, total = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const long long v = sh.tl[buf][q];
      before += q < warp ? v : 0;
      total += v;
    }
    buf ^= 1;
    // what is left before this thread's first arc
    long long run = rem - before - (w - s);
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) {
      const long long amt = min(max(run, 0LL), want[j]);
      run -= want[j];
      if (amt > 0) {
        const int kind = e[j].y & 7;
        int32_t* p = flow_word(g, kind, e[j].y >> 3);
        const int32_t d = static_cast<int32_t>(amt);
        *p = kind == 0 || kind == 2 || kind == 6 ? add32(f[j], d) : sub32(f[j], d);
        atomicAdd(g.in + e[j].x, d);
      }
    }
    rem -= total;
    base += kTile;
    if (rem <= 0 || base >= a1) break;
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) e[j] = nx[j];
  }
  if (tid == 0) {
    const int read = min(base, a1) - a0;
    walked[0] += read;
    walked[2] += read;
    ch.out[i] = static_cast<int32_t>(ex - max(rem, 0LL));
  }
}

// The whole CTA relabels chunk node i along its long segment: 1 + the
// least pre-wave head label over its post-wave residual arcs, at most
// 2 (n + 3), a block-wide min; the loads as discharge_cta's.
__device__ void relabel_cta(const Net& net, const Glob& g, const Chunk& ch, Shared& sh, int i,
                            const int32_t* lab_cur, int32_t cap, int& buf, long long* walked) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gi = ch.lo + i, a0 = net.off[gi], a1 = net.off[gi + 1];
  int2 e[kTileItems], nx[kTileItems];
  load_arcs(net, a0 + tid * kTileItems, a1, e);
  int32_t m = cap;
  for (int base = a0; base < a1; base += kTile) {
    const int a = base + tid * kTileItems;
    int32_t hl[kTileItems], f[kTileItems], r[kTileItems];
    load_tile(net, g, lab_cur, a, a1, e, hl, f, r);
    load_arcs(net, a + kTile, a1, nx);
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) {
      if (r[j] > 0) m = min(m, hl[j]);
      e[j] = nx[j];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
  if ((tid & 31) == 0) sh.tl[buf][warp] = m;
  __syncthreads();
  if (tid == 0) {
    for (int q = 0; q < kWarps; ++q) m = min(m, static_cast<int32_t>(sh.tl[buf][q]));
    ch.lab[i] = min(m + 1, cap);
    walked[1] += a1 - a0;
    walked[2] += a1 - a0;
  }
  buf ^= 1;
}

// Puts chunk node i on this wave's list: a long segment (its CTA walks it)
// at the list's back, counted in cntL, a short one (a warp walks it) at its
// front, counted in cnt.
__device__ __forceinline__ void enlist(const Net& net, const Chunk& ch, Shared& sh, int i) {
  if (ch.wide && net.off[ch.lo + i + 1] - net.off[ch.lo + i] >= kCtaWalkArcs)
    ch.list[ch.cl - 1 - atomicAdd(&sh.cntL, 1)] = i;
  else
    ch.list[atomicAdd(&sh.cnt, 1)] = i;
}

// One wave at `step`; returns whether a line node is still active.
__device__ int superstep(const Net& net, const Glob& g, const Chunk& ch, Shared& sh, int step,
                         const int32_t* lab_cur, int32_t* lab_next, long long* walked) {
  const int tid = threadIdx.x, warp = tid >> 5, c = blockIdx.x, G = gridDim.x, n = net.n;
  if (tid == 0) sh.cnt = sh.cntL = 0;
  __syncthreads();
  for (int i = tid; i < ch.cl; i += kThreads) {
    const int e = ch.ex[i] > 0 && (ch.lab[i] & 1) == (step & 1);
    ch.elig[i] = e;
    ch.out[i] = 0;
    if (e) enlist(net, ch, sh, i);
  }
  __syncthreads();
  int buf = 0;
  for (int k = 0; k < sh.cntL; ++k)
    discharge_cta(net, g, ch, sh, ch.list[ch.cl - 1 - k], lab_cur, buf, walked);
  for (int k = warp; k < sh.cnt; k += kWarps)
    discharge(net, g, ch, ch.list[k], lab_cur, walked[0]);
  // 1: every push done; each owner applies what reached it
  grid_sync(g.bar, sh.bar_target);
  if (tid == 0) sh.cnt = sh.cntL = 0;
  __syncthreads();
  for (int i = tid; i < ch.cl; i += kThreads) {
    int32_t* in = g.in + ch.lo + i;
    const int32_t ex = add32(sub32(ch.ex[i], ch.out[i]), ldcg(in));
    *in = 0;
    ch.ex[i] = ex;
    if (ch.elig[i] && ch.out[i] == 0 && ex > 0) enlist(net, ch, sh, i);
  }
  if (c == G - 1 && tid < 2) {  // S and T
    const int v = n + 1 + tid;
    g.excess[v] = add32(ldcg(g.excess + v), ldcg(g.in + v));
    g.in[v] = 0;
  }
  __syncthreads();
  for (int k = 0; k < sh.cntL; ++k)
    relabel_cta(net, g, ch, sh, ch.list[ch.cl - 1 - k], lab_cur, 2 * (n + 3), buf, walked);
  for (int k = warp; k < sh.cnt; k += kWarps)
    relabel(net, g, ch, ch.list[k], lab_cur, 2 * (n + 3), walked[1]);
  __syncthreads();
  int act = 0;
  for (int i = tid; i < ch.cl; i += kThreads) {
    lab_next[ch.lo + i] = ch.lab[i];
    act |= ch.ex[i] > 0;
  }
  act = __syncthreads_or(act);
  if (tid == 0) g.act[c] = act;
  // 2: the new labels published; is any node still active?
  grid_sync(g.bar, sh.bar_target);
  return __syncthreads_or(tid < G ? ldcg(g.act + tid) : 0);
}

// The solve's loop, with the hop tables in shared memory (kTabSmem) or in
// the CTA's region of the workspace; returns (in the kernel's scalars) the
// counts and laps.
template <bool kWs, bool kTabSmem>
__device__ void solve(const Net& net, const Glob& g, const Chunk& ch, Shared& sh, int live,
                      int2* tf, int2* tb, long long* scalars, int32_t max_supersteps,
                      int32_t relabel_every) {
  const int tid = threadIdx.x, c = blockIdx.x, G = gridDim.x;
  int32_t* lab_cur = g.labA;
  int32_t* lab_next = g.labB;
  int step = 0, relabels = 0, recbuf = 0;
  long long rounds = 0, walked[3] = {0, 0, 0};
  unsigned long long ns_rl = 0, ns_ss = 0;
  long long cy_rl = 0, cy_ss = 0;
  while (live && step < max_supersteps) {
    const unsigned long long t0 = global_ns();
    const long long k0 = clock64();
    rounds += global_relabel<kWs, kTabSmem>(net, g, ch, sh, lab_cur, recbuf, tf, tb);
    ++relabels;
    const unsigned long long t1 = global_ns();
    const long long k1 = clock64();
    const int budget =
        static_cast<int>(min(static_cast<long long>(step) + relabel_every,
                             static_cast<long long>(max_supersteps)));
    while (live && step < budget) {
      live = superstep(net, g, ch, sh, step, lab_cur, lab_next, walked);
      ++step;
      int32_t* t = lab_cur;
      lab_cur = lab_next;
      lab_next = t;
    }
    ns_rl += t1 - t0;
    ns_ss += global_ns() - t1;
    cy_rl += k1 - k0;
    cy_ss += clock64() - k1;
  }
  // the final state; excess_left: the excess of line nodes still active
  long long left = 0;
  for (int i = tid; i < ch.cl; i += kThreads) {
    const int gi = ch.lo + i;
    g.excess[gi] = ch.ex[i];
    g.labA[gi] = ch.lab[i];
    if (ch.ex[i] > 0) left += ch.ex[i];
  }
  left = block_sum(left, sh);
  walked[0] = block_sum(walked[0], sh);
  walked[1] = block_sum(walked[1], sh);
  if (tid == 0) {
    g.left[c] = left;
    atomicAdd(reinterpret_cast<unsigned long long*>(scalars + 8), walked[0]);
    atomicAdd(reinterpret_cast<unsigned long long*>(scalars + 9), walked[1]);
    // thread 0 alone counts its CTA's walks
    atomicAdd(reinterpret_cast<unsigned long long*>(scalars + 10), walked[2]);
  }
  grid_sync(g.bar, sh.bar_target);
  if (c == 0) {
    long long v = 0;
    for (int q = tid; q < G; q += kThreads) v += ldcg(g.left + q);
    v = block_sum(v, sh);
    if (tid == 0) {
      scalars[0] = step;
      scalars[1] = v;
      scalars[2] = relabels;
      scalars[3] = rounds;
      scalars[4] = static_cast<long long>(ns_rl);
      scalars[5] = static_cast<long long>(ns_ss);
      scalars[6] = cy_rl;
      scalars[7] = cy_ss;
    }
  }
}

// kWs: the node arrays in the workspace (node_ws) instead of shared memory;
// a template argument, so that the shared-memory instantiation keeps its
// shared loads, stores and atomics (a pointer that may be either becomes a
// generic one, and the hops' atomicMin twice as slow). The hop tables'
// place is chosen the same way, by each CTA: shared memory where both of
// its directions' groups fit in net.tab_cap entries.
template <bool kWs>
__global__ void __launch_bounds__(kThreads, 1)
    push_relabel_kernel(Net net, Glob g, const int32_t* __restrict__ excess0,
                        const int32_t* __restrict__ label0, long long* __restrict__ scalars,
                        int32_t max_supersteps, int32_t relabel_every, int32_t* node_ws) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, c = blockIdx.x, G = gridDim.x, n = net.n;
  if (tid == 0) sh.bar_target = 0;
  const int n1 = n + 1;
  const int C = (n1 + G - 1) / G, Cp = (C + 3) & ~3;
  Chunk ch;
  ch.lo = min(c * C, n1);
  ch.cl = min(C, n1 - ch.lo);
  ch.K = (ch.cl + kThreads - 1) / kThreads;
  ch.C = C;
  ch.n1 = n1;
  int32_t* a = kWs ? node_ws + static_cast<size_t>(c) * kNodeArrays * Cp : smem;
  ch.d = a;
  ch.dold = a + Cp;
  ch.dT = a + 2 * Cp;
  ch.flag = a + 3 * Cp;
  ch.lab = a + 4 * Cp;
  ch.ex = a + 5 * Cp;
  ch.out = a + 6 * Cp;
  ch.elig = a + 7 * Cp;
  ch.list = a + 8 * Cp;
  ch.dc = ch.out;
  ch.xs = ch.elig;
  ch.reach = ch.list;
  // the preflow: the wrapper's initial state (the twin's)
  for (int r = c * kThreads + tid; r < net.R; r += G * kThreads) g.f_read[r] = 0;
  int act = 0, wide = 0;
  for (int i = tid; i < ch.cl; i += kThreads) {
    const int gi = ch.lo + i;
    wide |= net.off[gi + 1] - net.off[gi] >= kCtaWalkArcs;
    if (gi < n) g.f_chain[gi] = 0;
    g.f_src[gi] = net.cap_src[gi];
    g.f_snk[gi] = 0;
    g.in[gi] = 0;
    ch.ex[i] = excess0[gi];
    ch.lab[i] = label0[gi];
    act |= ch.ex[i] > 0;
  }
  if (c == G - 1 && tid < 2) {  // S and T: their labels never change
    const int v = n + 1 + tid;
    g.excess[v] = excess0[v];
    g.labA[v] = label0[v];
    g.labB[v] = label0[v];
    g.in[v] = 0;
  }
  act = __syncthreads_or(act);
  ch.wide = __syncthreads_or(wide);
  if (tid == 0) g.act[c] = act;
  if (c == 0 && tid == 0) scalars[8] = scalars[9] = scalars[10] = 0;
  grid_sync(g.bar, sh.bar_target);
  const int live = __syncthreads_or(tid < G ? ldcg(g.act + tid) : 0);
  const int ng = max(net.grangeF[c + 1] - net.grangeF[c], net.grangeB[c + 1] - net.grangeB[c]);
  if (ng <= net.tab_cap) {
    int2* tab = reinterpret_cast<int2*>(smem + (kWs ? 0 : kNodeArrays * Cp));
    solve<kWs, true>(net, g, ch, sh, live, tab, tab + net.tab_cap, scalars, max_supersteps,
                relabel_every);
  } else {
    solve<kWs, false>(net, g, ch, sh, live, g.cf + net.grangeF[c], g.cb + net.grangeB[c], scalars,
                 max_supersteps, relabel_every);
  }
}

}  // namespace

// The workspace, int32 words: 16 of control (the barrier at 0), 12 G of
// per-CTA partials (the records, two buffers of G int4, then left as G
// int64, then act), 7 words a node of n + 3 (the closure's words as int4,
// then labB, in, snap2), 8-byte aligned, then 6 words a read: the two
// compacted hop tables of R int2 each and the two group flags of R int32
// each, then, with nodes_in_ws, each CTA's kNodeArrays arrays of Cp = C
// rounded up to 4. ops/push_relabel.py::_ws_words mirrors it.
constexpr int64_t kCtrlWords = 16, kPartialWords = 12, kWsNodeArrays = 7, kTableWords = 6;

// Returns the cudaError_t of the launch (0 on success):
// cudaErrorNotSupported without cooperative launch,
// cudaErrorCooperativeLaunchTooLarge where G CTAs cannot be co-resident,
// cudaErrorInvalidValue for sizes it does not take (among them a chunk
// whose node arrays exceed shared memory without nodes_in_ws, which puts
// them in the workspace). arcs: int2[A] the tail-sorted
// table (head, slot << 3 | kind); off: int32[n + 2] each line node's first
// arc (off[n + 1] ends node n's segment); hopF, hopB: int2[R] the reads
// sorted by (start, end + 1) and by (end + 1, start), rows (read, group),
// rangeF, rangeB: int32[G + 1] each CTA's share of the valid ones (CTA c
// owns the nodes [c C, c C + C), C = ceil((n + 1) / G)); grpF, grpB:
// int2[R] each group's (tail, other end) at its index, grangeF, grangeB:
// int32[G + 1] each CTA's groups; cap_src, cap_snk: int32[n + 1];
// excess0, label0: int32[n + 3] the preflow; f_read int32[R], f_chain
// int32[n], f_src and f_snk int32[n + 1], excess and label int32[n + 3]:
// the final state, out; scalars: int64[11] out (step, excess_left, global
// relabels, closure rounds, ns and clock64 cycles of CTA 0 inside global
// relabels, then inside supersteps, the arcs the discharges read, the arcs
// the relabels read, the arcs of both that CTA walks read); ws: the
// workspace.
extern "C" int gd_push_relabel_solve(const void* arcs, const void* off, const void* hopF,
                                     const void* rangeF, const void* grpF, const void* grangeF,
                                     const void* hopB, const void* rangeB, const void* grpB,
                                     const void* grangeB, const void* cap_src,
                                     const void* cap_snk, const void* excess0,
                                     const void* label0, void* f_read, void* f_chain,
                                     void* f_src, void* f_snk, void* excess, void* label,
                                     void* scalars, void* ws, int64_t n, int64_t R, int64_t G,
                                     int64_t max_supersteps, int64_t relabel_every,
                                     int64_t nodes_in_ws, void* stream) {
  if (n < 1 || n > (1 << 28) || R < 1 || R >= (1 << 28) || G < 1 || G > n + 1 ||
      G > kMaxCtas || max_supersteps < 0 || max_supersteps > INT_MAX || relabel_every < 1 ||
      relabel_every > INT_MAX)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const int64_t C = (n + G) / G, Cp = (C + 3) & ~int64_t(3);
  const int64_t node_bytes = nodes_in_ws ? 0 : kNodeArrays * Cp * 4;
  const int64_t room = optin - int64_t(sizeof(Shared)) - node_bytes;
  if (room < 0) return (int)cudaErrorInvalidValue;
  // the hop tables' entries a direction in shared memory
  const int64_t tab_cap = room / int64_t(2 * sizeof(int2)) < kTabCapMax
                              ? room / int64_t(2 * sizeof(int2))
                              : kTabCapMax;
  const size_t smem_bytes = static_cast<size_t>(node_bytes + 2 * tab_cap * sizeof(int2));
  auto kernel = nodes_in_ws ? push_relabel_kernel<true> : push_relabel_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (int64_t(per_sm) * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;

  Net net{static_cast<const int2*>(arcs),       static_cast<const int32_t*>(off),
          static_cast<const int2*>(hopF),       static_cast<const int32_t*>(rangeF),
          static_cast<const int2*>(grpF),       static_cast<const int32_t*>(grangeF),
          static_cast<const int2*>(hopB),       static_cast<const int32_t*>(rangeB),
          static_cast<const int2*>(grpB),       static_cast<const int32_t*>(grangeB),
          static_cast<const int32_t*>(cap_src), static_cast<const int32_t*>(cap_snk),
          static_cast<int>(n),                  static_cast<int>(R),
          static_cast<int>(tab_cap)};
  int32_t* w = static_cast<int32_t*>(ws);
  const int64_t m = n + 3;
  int32_t* part = w + kCtrlWords;
  int4* words = reinterpret_cast<int4*>(part + kPartialWords * G);
  int32_t* nodes = reinterpret_cast<int32_t*>(words + m);
  int32_t* tabs_at = w + ((kCtrlWords + kPartialWords * G + kWsNodeArrays * m + 1) & ~int64_t(1));
  int2* tabs = reinterpret_cast<int2*>(tabs_at);
  int32_t* flags = reinterpret_cast<int32_t*>(tabs + 2 * R);
  Glob g{static_cast<int32_t*>(f_read), static_cast<int32_t*>(f_chain),
         static_cast<int32_t*>(f_src),  static_cast<int32_t*>(f_snk),
         static_cast<int32_t*>(excess), static_cast<int32_t*>(label),
         reinterpret_cast<unsigned*>(w),
         reinterpret_cast<int4*>(part),
         reinterpret_cast<long long*>(part + 8 * G),
         part + 10 * G,
         words,
         nodes, nodes + m, nodes + 2 * m,
         tabs, tabs + R,
         flags, flags + R};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(w, 0, kCtrlWords * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int32_t* ex0 = static_cast<const int32_t*>(excess0);
  const int32_t* lb0 = static_cast<const int32_t*>(label0);
  long long* sc = static_cast<long long*>(scalars);
  int32_t mss = static_cast<int32_t>(max_supersteps);
  int32_t rle = static_cast<int32_t>(relabel_every);
  int32_t* node_ws = nodes_in_ws ? tabs_at + kTableWords * R : nullptr;
  void* args[] = {&net, &g, &ex0, &lb0, &sc, &mss, &rle, &node_ws};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(G)), dim3(kThreads), args,
                                    smem_bytes, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
