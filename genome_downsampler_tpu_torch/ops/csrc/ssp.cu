// The SSP kernel: the whole successive-shortest-paths solve of the exact
// weighted QMCP in one cooperative launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA device program of genome_downsampler_tpu/solvers/
// device_mcmf.py (`_make_phase`: chain_closure, bucket_relax, phase,
// solve_loop, lines 198-429); the network and the algorithm are described
// there and in ops/ssp.py, whose plain twin this kernel equals bit for bit.
//
// What it computes. Nodes 0..n (genome positions), chain arcs i+1 -> i
// (always residual) and i -> i+1 (residual where chainflow[i] > 0), and one
// arc per bucket b, bstart[b] -> bend1[b], whose k-th unit costs
// pool[off0[b] + k]. Each phase: distances d from every node with excess
// by a Bellman-Ford fixpoint of Jacobi rounds (chain closure, forward
// bucket side, backward bucket side); the cheapest deficit node; a walk
// along the parent pointers to a source; the push delta, bounded by the
// deficit, the source's excess, each bucket hop's equal-cost run and the
// net chain usage; potentials pi += min(d, d_sink). Phases run until the
// supply is 0 or a status other than OK.
//
// What bounds it on the H100. The work is sequential: phases (about M),
// fixpoint rounds per phase (the bucket hops of a shortest path, about
// n / span), and within a round two scans over the n + 1 nodes and two
// scatter-mins over the B buckets. Each round moves (4 (n + 1) + 6 B)
// words, so the card's bytes and operations are far from binding; what
// binds is the chain of barriers a round must pass: the scans and the two
// relax sides each need every node's state from the step before. The
// one-CTA kernel this replaces ran a round on one SM behind about 46 block
// barriers (146 at n = 131,072), each after a round trip to L2, with every
// bucket's reduced cost gathered anew in each round.
//
// What the design does about it. One persistent cooperative grid of
// G = min(SMs, ceil((n + 1) / 256)) CTAs; CTA c owns the nodes
// [c C, (c + 1) C), C = ceil((n + 1) / G), and keeps their d, pi, pk, pid,
// excess, chain flags, snapshot and winner staging in shared memory for
// the whole solve. A round is four grid barriers (hand-written: one
// counter of arrivals over the launch, added to with release and read
// with acquire semantics; valid because the cooperative launch makes all
// G CTAs co-resident):
//   1. each CTA publishes its chunk's min of key(d + pi, i) (the reverse
//      scan's aggregate) and whether the last round changed a node;
//   2. after folding the aggregates to its right and scanning its chunk,
//      it publishes the (flag, key) aggregate of the forward scan
//      segmented at zero chain flow; each CTA folds those to its left;
//   3. each CTA writes its chunk of d to a global snapshot, the twin's
//      dold; the forward bucket side is run by the CTA that owns bend1[b]:
//      candidates read d[src] from the snapshot only, atomicMin into the
//      shared d, then atomicMin of the bucket id among the winners;
//   4. the same for the backward side, owned by bstart[b]'s CTA, from a
//      second snapshot buffer (a CTA still reading the first may lag).
// A fold over the G per-CTA partials is one load a thread and a block
// reduction or scan, so each costs one round trip to L2. What bounds a
// round now is those four barriers and the L2 round trips between them
// (the folds, the snapshot gathers), not the bytes or the operations.
// Keys pack (value, index) into one int64 (value * 2^32 + index), so
// integer min is the JAX program's lexicographic min, and the segmented
// combine is associative, so the chunk-and-carry scans give every node the
// same exclusive min as one scan; integer atomicMin does not depend on
// order. Flow, cap, pool and pi do not change inside a phase, so each CTA
// builds a table of its buckets' (src, dst, reduced cost) once a phase
// (in shared memory where the largest CTA's share fits, in the workspace
// otherwise), and a round gathers only d[src]. The phase-level parts (the
// argmin over deficits, the walk, the net chain usage and its prefix sum,
// the push, pi, pmax, supply) are reductions and scans through per-CTA
// partials: five grid barriers a phase. The walk stays one thread into a
// step buffer of n + 2 entries (the parents form a forest). Cross-CTA data
// is read with ld.global.cg (L2), never through a stale L1 line. int32
// sums are added as uint32 so that they wrap as XLA's do. Thread 0 of CTA
// 0 reads the global timer four times a phase and keeps three laps: the
// fixpoint rounds, each phase's reset and bucket tables before them, and
// the phase's end (argmin, walk, push, potentials, supply).
//
// The chunk floor of 256 nodes (ops/ssp.py: CHUNK_FLOOR, which sets G and
// the CTAs' ranges), chosen by measurement on the H100
// (scripts/ssp_round_split.py --floors, PERF.md §6): at config-1 (29,904
// nodes) it gives 117 CTAs of 256 nodes, one a thread, and a round as fast
// as the 132 CTAs of 227 that floors of 64 and 128 give, within 2%; 512
// (59 CTAs) was 10% slower a round, 1,024 (30 CTAs) 36%. At n = 131,072
// every floor up to 512 gives the same 132 CTAs.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t INF = 1 << 30;
constexpr int32_t IMAX = INT_MAX;
constexpr int32_t PI_GUARD = 1 << 29;
constexpr long long kNoKey = LLONG_MAX;
enum { OK = 0, INFEASIBLE, FIXPOINT_CAP, PATH_OVERFLOW, PI_OVERFLOW, DEGENERATE };
// shared int32 arrays of C entries each (d, dold, pi, pk, pid, excess,
// stage, flag) and the bytes of one bucket table entry (int4)
constexpr int kNodeArrays = 8;
constexpr int kEntryBytes = 16;

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}
// (value, index) ordered lexicographically as one integer
__device__ __forceinline__ long long make_key(int32_t v, int32_t i) {
  return static_cast<long long>(v) * 4294967296LL + static_cast<long long>(static_cast<uint32_t>(i));
}
__device__ __forceinline__ int32_t key_value(long long k) {
  return static_cast<int32_t>(k >> 32);
}
__device__ __forceinline__ int32_t key_index(long long k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k & 0xffffffffLL));
}
// the scans' key of a node: d + pi, or INF where d is INF
__device__ __forceinline__ long long node_key(int32_t d, int32_t pi, int i) {
  return make_key(d >= INF ? INF : add32(d, pi), i);
}
// floor division (JAX's // on int32), b > 0
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  if (a % b != 0 && a < 0) --q;
  return q;
}
// prefix (pf, pk) then (f, k): the segmented min of `_seg_lexmin`
__device__ __forceinline__ void seg_combine(int pf, long long pk, int& f, long long& k) {
  if (!f) k = min(pk, k);
  f |= pf;
}

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
// co-resident. The longest valid wait is one thread's walk of n + 2 steps
// (well under a second); a wait of kBarrierTrap cycles (about 10 s) is a
// fault, and traps rather than holding the card.
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

struct Shared {
  long long wk[kWarps];  // each warp's total / prefix (scans, reductions)
  int wf[kWarps];
  long long carry_k;  // a scan's carry from the other CTAs
  int carry_f;
  unsigned bar_target;  // thread 0's count of grid barrier arrivals
};

// Exclusive segmented scan over the threads' aggregates (f, k), in thread
// order, without a carry: (ef, ek) is the fold of the threads before this
// one, (tf, tk) the fold of all. The identity is (0, kNoKey).
__device__ void block_seg_excl(int f, long long k, int& ef, long long& ek, int& tf,
                               long long& tk, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int wf = f;
  long long wk = k;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int pf = __shfl_up_sync(kFull, wf, o);
    const long long pk = __shfl_up_sync(kFull, wk, o);
    if (lane >= o) seg_combine(pf, pk, wf, wk);
  }
  if (lane == 31) {
    sh.wf[warp] = wf;
    sh.wk[warp] = wk;
  }
  int pf = __shfl_up_sync(kFull, wf, 1);
  long long pk = __shfl_up_sync(kFull, wk, 1);
  __syncthreads();
  int xf = 0;
  long long xk = kNoKey;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      ef = xf;
      ek = xk;
    }
    int yf = sh.wf[w];
    long long yk = sh.wk[w];
    seg_combine(xf, xk, yf, yk);
    xf = yf;
    xk = yk;
  }
  tf = xf;
  tk = xk;
  if (lane > 0) {
    seg_combine(ef, ek, pf, pk);
    ef = pf;
    ek = pk;
  }
  __syncthreads();
}

// block-wide reductions; every thread gets the result
__device__ long long block_min(long long v, Shared& sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sh.wk[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh.wk[0];
  for (int w = 1; w < kWarps; ++w) v = min(v, sh.wk[w]);
  __syncthreads();
  return v;
}

__device__ int32_t block_sum(int32_t v, Shared& sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add32(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sh.wf[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t s = 0;
  for (int w = 0; w < kWarps; ++w) s = add32(s, sh.wf[w]);
  __syncthreads();
  return s;
}

// Exclusive wrapping int32 sum over the threads' values, in thread order;
// `tot` gets the sum of all.
__device__ int32_t block_sum_excl(int32_t v, int32_t& tot, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t w = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t p = __shfl_up_sync(kFull, w, o);
    if (lane >= o) w = add32(w, p);
  }
  if (lane == 31) sh.wf[warp] = w;
  __syncthreads();
  int32_t x = 0;
  tot = 0;
  for (int q = 0; q < kWarps; ++q) {
    if (q == warp) x = tot;
    tot = add32(tot, sh.wf[q]);
  }
  __syncthreads();
  return add32(x, sub32(w, v));
}

// Folds over the per-CTA partials [a, b), by the whole CTA (one load a
// thread while G <= kThreads), the result broadcast to every thread.
__device__ long long fold_min(const long long* p, int a, int b, Shared& sh) {
  long long v = kNoKey;
  for (int q = a + threadIdx.x; q < b; q += kThreads) v = min(v, ldcg(p + q));
  return block_min(v, sh);
}

__device__ int32_t fold_sum(const int32_t* p, int a, int b, Shared& sh) {
  int32_t v = 0;
  for (int q = a + threadIdx.x; q < b; q += kThreads) v = add32(v, ldcg(p + q));
  return block_sum(v, sh);
}

// The round's first fold: the min of the reverse aggregates of the CTAs
// after `c`, and whether any CTA's last round changed a node (`any`).
__device__ long long fold_top(const long long* agg, const int32_t* chg, int c, int& any,
                              Shared& sh) {
  long long v = kNoKey;
  int a = 0;
  for (int q = threadIdx.x; q < gridDim.x; q += kThreads) {
    const long long k = ldcg(agg + q);
    if (q > c) v = min(v, k);
    a |= ldcg(chg + q);
  }
  any = __syncthreads_or(a);
  return block_min(v, sh);
}

// the segmented fold of the forward aggregates of CTAs [0, b), in order:
// thread t folds its contiguous share, then the CTA folds the threads'
__device__ void fold_seg(const int* pf, const long long* pk, int b, int& f, long long& k,
                         Shared& sh) {
  const int per = (b + kThreads - 1) / kThreads;
  int xf = 0;
  long long xk = kNoKey;
  for (int q = threadIdx.x * per; q < min(b, (threadIdx.x + 1) * per); ++q) {
    int yf = ldcg(pf + q);
    long long yk = ldcg(pk + q);
    seg_combine(xf, xk, yf, yk);
    xf = yf;
    xk = yk;
  }
  int ef;
  long long ek;
  block_seg_excl(xf, xk, ef, ek, f, k, sh);
}

struct Net {
  const int32_t* __restrict__ bstart;
  const int32_t* __restrict__ bend1;
  const int32_t* __restrict__ off0;
  const int32_t* __restrict__ cap;
  const int32_t* __restrict__ pool;
  const int32_t* __restrict__ run_lo;
  const int32_t* __restrict__ run_hi;
  // bucket ids by bend1 (forward side) and by bstart (backward side), and
  // each CTA's range in them: [rangeF[c], rangeF[c + 1])
  const int32_t* __restrict__ orderF;
  const int32_t* __restrict__ rangeF;
  const int32_t* __restrict__ orderB;
  const int32_t* __restrict__ rangeB;
  int n, B;
};

// the workspace (ops/ssp.py: _ws_words); not restrict: CTAs share it
struct Glob {
  unsigned* bar;       // grid barrier: arrivals, generation
  int32_t* walk;       // the walk's source, bound, status, steps, source excess
  // per-CTA partials, one array each so that no CTA overwrites one that
  // another may still read (pmaxP holds -pmax, so every fold is a min)
  long long *aggR, *aggFk, *argK, *headP, *pmaxP;
  int32_t *chg, *aggFf, *sumP, *supP;
  int32_t *dbufF, *dbufB, *pk, *pid, *pi, *excess, *chainflow, *diff, *stepx, *stepk;
  int4 *tabF, *tabB;   // the bucket tables where shared memory cannot hold them
  int32_t* flow;
};

// the CTA's nodes and buckets; node arrays in shared memory
struct Chunk {
  int lo, cl, K;  // first node, nodes, items a thread holds in the scans
  int32_t *d, *dold, *pi, *pk, *pid, *ex, *stage, *flag;
  int4 *tabF, *tabB;
  int cntF, cntB;
};

// One bucket side (kind 3: forward, 4: backward) over the CTA's table,
// candidates from the snapshot `buf` of every CTA's d, `dold` this CTA's
// copy of it; returns whether this thread saw a node improve. A thread's
// first kCached entries keep their candidate in registers between the
// atomicMin pass and the winner pass; later ones gather it again.
constexpr int kCached = 4;

__device__ bool relax_side(const Chunk& ch, const int4* tab, int cnt, const int32_t* buf,
                           int kind) {
  const int tid = threadIdx.x;
  auto cand = [&](const int4& e) -> int32_t {
    if (e.x < 0) return INF;
    const int32_t ds = ldcg(buf + e.x);
    return ds < INF ? add32(ds, e.z) : INF;
  };
  auto win = [&](int32_t c, int dst, int b) {
    if (c < INF) {
      const int32_t da = ch.d[dst];
      if (c == da && da < ch.dold[dst]) atomicMin(&ch.stage[dst], b);
    }
  };
  int32_t cc[kCached];
  int cdst[kCached], cb[kCached];
#pragma unroll
  for (int u = 0; u < kCached; ++u) {
    const int j = tid + u * kThreads;
    cc[u] = INF;
    cdst[u] = 0;
    cb[u] = 0;
    if (j < cnt) {
      const int4 e = tab[j];
      cc[u] = cand(e);
      cdst[u] = e.y;
      cb[u] = e.w;
      if (cc[u] < INF) atomicMin(&ch.d[e.y], cc[u]);
    }
  }
  for (int j = tid + kCached * kThreads; j < cnt; j += kThreads) {
    const int4 e = tab[j];
    const int32_t c = cand(e);
    if (c < INF) atomicMin(&ch.d[e.y], c);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kCached; ++u) win(cc[u], cdst[u], cb[u]);
  for (int j = tid + kCached * kThreads; j < cnt; j += kThreads) {
    const int4 e = tab[j];
    win(cand(e), e.y, e.w);
  }
  __syncthreads();
  bool improved = false;
  for (int i = tid; i < ch.cl; i += kThreads) {
    if (ch.d[i] < ch.dold[i]) {
      ch.pk[i] = kind;
      ch.pid[i] = ch.stage[i];
      ch.stage[i] = IMAX;
      improved = true;
    }
  }
  return improved;
}

// each CTA's d into the snapshot `buf` and its own copy, then the barrier
__device__ void snapshot(const Chunk& ch, int32_t* buf, unsigned* bar, Shared& sh) {
  for (int i = threadIdx.x; i < ch.cl; i += kThreads) {
    buf[ch.lo + i] = ch.d[i];
    ch.dold[i] = ch.d[i];
  }
  grid_sync(bar, sh.bar_target);
}

// The phase's bucket tables: for each bucket the CTA owns on a side, its
// source (or -1 where the arc has no residual), its destination in the
// chunk, its reduced cost and its id.
__device__ void build_tables(const Net& net, const Glob& g, const Chunk& ch, int f0, int b0) {
  for (int j = threadIdx.x; j < ch.cntF; j += kThreads) {
    const int b = net.orderF[f0 + j];
    const int32_t fl = ldcg(g.flow + b), cp = net.cap[b];
    const int s = net.bstart[b], t = net.bend1[b];
    int4 e = make_int4(-1, t - ch.lo, 0, b);
    if (fl < cp) {
      const int32_t mc = net.pool[net.off0[b] + min(fl, cp - 1)];
      e.x = s;
      e.z = sub32(add32(mc, ldcg(g.pi + s)), ch.pi[t - ch.lo]);
    }
    ch.tabF[j] = e;
  }
  for (int j = threadIdx.x; j < ch.cntB; j += kThreads) {
    const int b = net.orderB[b0 + j];
    const int32_t fl = ldcg(g.flow + b);
    const int s = net.bstart[b], t = net.bend1[b];
    int4 e = make_int4(-1, s - ch.lo, 0, b);
    if (fl > 0) {
      const int32_t mc = net.pool[net.off0[b] + max(fl - 1, 0)];
      e.x = t;
      e.z = sub32(add32(sub32(0, mc), ldcg(g.pi + t)), ch.pi[s - ch.lo]);
    }
    ch.tabB[j] = e;
  }
}

// The reverse scan (downward chain arcs) runs over the chunk from its last
// node down: scan item q is node cl - 1 - q. `ek` is the exclusive fold of
// the threads before this one, `carry` the min over the CTAs to the right.
__device__ void closure_down(const Chunk& ch, long long ek, long long carry) {
  long long run = min(carry, ek);
  for (int j = 0; j < ch.K; ++j) {
    const int q = threadIdx.x * ch.K + j;
    if (q >= ch.cl) break;
    const int i = ch.cl - 1 - q;
    const long long key = node_key(ch.d[i], ch.pi[i], ch.lo + i);
    const int32_t mv = key_value(run);
    const int32_t cand = mv >= INF ? INF : sub32(mv, ch.pi[i]);
    if (cand < ch.d[i]) {
      ch.d[i] = cand;
      ch.pk[i] = 1;
      ch.pid[i] = key_index(run);
    }
    run = min(run, key);
  }
}

// The forward scan (upward arcs), segmented at zero chain flow; (ef, ek)
// the exclusive fold before this thread's first node, carry included.
__device__ void closure_up(const Chunk& ch, int ef, long long ek) {
  for (int j = 0; j < ch.K; ++j) {
    const int i = threadIdx.x * ch.K + j;
    if (i >= ch.cl) break;
    int f = ch.flag[i];
    long long key = node_key(ch.d[i], ch.pi[i], ch.lo + i);
    if (!f) {
      const int32_t mv = key_value(ek);
      const int32_t cand = mv >= INF ? INF : sub32(mv, ch.pi[i]);
      if (cand < ch.d[i]) {
        ch.d[i] = cand;
        ch.pk[i] = 2;
        ch.pid[i] = key_index(ek);
      }
    }
    seg_combine(ef, ek, f, key);
    ef = f;
    ek = key;
  }
}

// this thread's (flag, key) fold of its forward-scan nodes
__device__ void up_items(const Chunk& ch, int& f, long long& k) {
  f = 0;
  k = kNoKey;
  for (int j = 0; j < ch.K; ++j) {
    const int i = threadIdx.x * ch.K + j;
    if (i >= ch.cl) break;
    int fi = ch.flag[i];
    long long ki = node_key(ch.d[i], ch.pi[i], ch.lo + i);
    seg_combine(f, k, fi, ki);
    f = fi;
    k = ki;
  }
}

// this thread's min key of its reverse-scan nodes
__device__ long long down_items(const Chunk& ch) {
  long long k = kNoKey;
  for (int j = 0; j < ch.K; ++j) {
    const int q = threadIdx.x * ch.K + j;
    if (q >= ch.cl) break;
    const int i = ch.cl - 1 - q;
    k = min(k, node_key(ch.d[i], ch.pi[i], ch.lo + i));
  }
  return k;
}

// Walk from the sink to a source (thread 0 of CTA 0), bound the push,
// apply it; returns the phase's status, the same in every CTA. The diff
// entries were zeroed by their owners before the barrier that precedes it.
__device__ int augment(const Net& net, const Glob& g, const Chunk& ch, Shared& sh, int sink) {
  const int n = net.n, c = blockIdx.x, tid = threadIdx.x;
  if (c == 0 && tid == 0) {
    int v = sink, steps = 0, nb = 0;
    int32_t bn = sub32(0, ldcg(g.excess + sink));
    int st = OK;
    while (ldcg(g.pk + v) != 0) {
      if (steps == n + 2) {
        st = PATH_OVERFLOW;
        break;
      }
      ++steps;
      const int x = ldcg(g.pid + v), kind = ldcg(g.pk + v);
      if (kind == 1) {  // down run x -> v: chain arcs [v, x) forward
        g.diff[v] = add32(ldcg(g.diff + v), 1);
        g.diff[x] = sub32(ldcg(g.diff + x), 1);
        v = x;
      } else if (kind == 2) {  // up run x -> v: chain arcs [x, v) backward
        g.diff[x] = sub32(ldcg(g.diff + x), 1);
        g.diff[v] = add32(ldcg(g.diff + v), 1);
        v = x;
      } else if (kind == 3) {
        const int32_t k = add32(net.off0[x], ldcg(g.flow + x));
        bn = min(bn, sub32(add32(net.run_hi[k], 1), k));
        g.stepk[nb] = 1;
        g.stepx[nb++] = x;
        v = net.bstart[x];
      } else {
        const int32_t top = add32(net.off0[x], ldcg(g.flow + x));
        bn = min(bn, sub32(top, net.run_lo[top - 1]));
        g.stepk[nb] = -1;
        g.stepx[nb++] = x;
        v = net.bend1[x];
      }
    }
    g.walk[0] = v;
    g.walk[1] = bn;
    g.walk[2] = st;
    g.walk[3] = nb;
    g.walk[4] = ldcg(g.excess + v);
  }
  grid_sync(g.bar, sh.bar_target);
  const int src = ldcg(g.walk), st = ldcg(g.walk + 2);
  if (st != OK) return st;
  // coef = prefix sum of diff over the n chain arcs; the push's bound from
  // the arcs used against their flow. This CTA's arcs: [lo, min(lo + cl, n))
  const int arcs = max(0, min(ch.cl, n - ch.lo));
  int32_t part = 0;
  for (int j = 0; j < ch.K; ++j) {
    const int i = tid * ch.K + j;
    if (i >= arcs) break;
    part = add32(part, ldcg(g.diff + ch.lo + i));
  }
  int32_t tot;
  const int32_t ex = block_sum_excl(part, tot, sh);
  if (tid == 0) g.sumP[c] = tot;
  grid_sync(g.bar, sh.bar_target);
  int32_t run = add32(fold_sum(g.sumP, 0, c, sh), ex);
  int32_t head = IMAX;
  for (int j = 0; j < ch.K; ++j) {
    const int i = tid * ch.K + j;
    if (i >= arcs) break;
    run = add32(run, ldcg(g.diff + ch.lo + i));
    ch.dold[i] = run;
    if (run < 0)
      head = min(head, floordiv(ldcg(g.chainflow + ch.lo + i), max(sub32(0, run), 1)));
  }
  const long long h = block_min(head, sh);
  if (tid == 0) g.headP[c] = h;
  grid_sync(g.bar, sh.bar_target);
  head = static_cast<int32_t>(fold_min(g.headP, 0, gridDim.x, sh));
  const int32_t delta = min(min(static_cast<int32_t>(ldcg(g.walk + 1)), head), ldcg(g.walk + 4));
  if (delta <= 0) return DEGENERATE;
  for (int j = 0; j < ch.K; ++j) {
    const int i = tid * ch.K + j;
    if (i >= arcs) break;
    int32_t* cf = g.chainflow + ch.lo + i;
    *cf = add32(ldcg(cf), mul32(delta, ch.dold[i]));
  }
  const int sink_l = sink - ch.lo, src_l = src - ch.lo;
  if (tid == 0) {
    if (c == 0) {
      const int nb = ldcg(g.walk + 3);
      for (int q = 0; q < nb; ++q) {
        const int x = ldcg(g.stepx + q);
        const int32_t fl = ldcg(g.flow + x);
        g.flow[x] = ldcg(g.stepk + q) > 0 ? add32(fl, delta) : sub32(fl, delta);
      }
      g.excess[src] = sub32(ldcg(g.excess + src), delta);
      g.excess[sink] = add32(ldcg(g.excess + sink), delta);
    }
    if (src_l >= 0 && src_l < ch.cl) ch.ex[src_l] = sub32(ch.ex[src_l], delta);
    if (sink_l >= 0 && sink_l < ch.cl) ch.ex[sink_l] = add32(ch.ex[sink_l], delta);
  }
  __syncthreads();
  return OK;
}

__global__ void __launch_bounds__(kThreads, 1)
    ssp_kernel(Net net, Glob g, const int32_t* __restrict__ excess0, int32_t* __restrict__ scalars,
               long long* __restrict__ laps, int32_t phase_cap, int tables_shared, int capF) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, c = blockIdx.x, G = gridDim.x;
  if (tid == 0) sh.bar_target = 0;
  const int n1 = net.n + 1;
  const int C = (n1 + G - 1) / G, Cp = (C + 3) & ~3;
  Chunk ch;
  ch.lo = min(c * C, n1);
  ch.cl = min(C, n1 - ch.lo);
  ch.K = (ch.cl + kThreads - 1) / kThreads;
  int32_t* a = smem;
  ch.d = a;
  ch.dold = a + Cp;
  ch.pi = a + 2 * Cp;
  ch.pk = a + 3 * Cp;
  ch.pid = a + 4 * Cp;
  ch.ex = a + 5 * Cp;
  ch.stage = a + 6 * Cp;
  ch.flag = a + 7 * Cp;
  const int f0 = net.rangeF[c], b0 = net.rangeB[c];
  ch.cntF = net.rangeF[c + 1] - f0;
  ch.cntB = net.rangeB[c + 1] - b0;
  if (tables_shared) {
    ch.tabF = reinterpret_cast<int4*>(a + kNodeArrays * Cp);
    ch.tabB = ch.tabF + capF;
  } else {
    ch.tabF = g.tabF + f0;
    ch.tabB = g.tabB + b0;
  }
  for (int i = tid; i < ch.cl; i += kThreads) {
    const int gi = ch.lo + i;
    ch.ex[i] = excess0[gi];
    g.excess[gi] = ch.ex[i];
    ch.pi[i] = 0;
    g.pi[gi] = 0;
    ch.stage[i] = IMAX;
    if (gi < net.n) g.chainflow[gi] = 0;
  }
  for (int b = c * kThreads + tid; b < net.B; b += G * kThreads) g.flow[b] = 0;
  auto publish_supply = [&]() {
    int32_t v = 0;
    for (int i = tid; i < ch.cl; i += kThreads) v = add32(v, max(ch.ex[i], 0));
    v = block_sum(v, sh);
    if (tid == 0) g.supP[c] = v;
  };
  publish_supply();
  grid_sync(g.bar, sh.bar_target);
  int32_t supply = fold_sum(g.supP, 0, G, sh);
  const int it_cap = min(net.B + 3, 1 << 20);
  int status = OK, phases = 0;
  long long rounds = 0;
  // thread 0 of CTA 0: ns in the rounds, the tables and the phases' ends
  const bool timer = c == 0 && tid == 0;
  long long ns[3] = {0, 0, 0};
  while (status == OK && supply > 0 && phases < phase_cap) {
    const long long t0 = timer ? global_ns() : 0;
    for (int i = tid; i < ch.cl; i += kThreads) {
      const int gi = ch.lo + i;
      ch.d[i] = ch.ex[i] > 0 ? 0 : INF;
      ch.pk[i] = 0;
      ch.pid[i] = 0;
      ch.flag[i] = gi == 0 || ldcg(g.chainflow + gi - 1) == 0;
    }
    __syncthreads();
    build_tables(net, g, ch, f0, b0);
    __syncthreads();
    const long long t1 = timer ? global_ns() : 0;
    bool changed = true;
    int it = 0, my_chg = 0;
    for (;;) {
      // 1: the reverse scan's chunk aggregates and the last round's flags
      int ef, tf;
      long long ek, tk;
      block_seg_excl(0, down_items(ch), ef, ek, tf, tk, sh);
      if (tid == 0) {
        g.aggR[c] = tk;
        g.chg[c] = my_chg;
      }
      grid_sync(g.bar, sh.bar_target);
      int any;
      const long long carry = fold_top(g.aggR, g.chg, c, any, sh);
      changed = it == 0 || any;
      if (!changed || it == it_cap) break;
      closure_down(ch, ek, carry);
      __syncthreads();
      // 2: the forward scan, segmented at zero chain flow
      int uf;
      long long uk;
      up_items(ch, uf, uk);
      block_seg_excl(uf, uk, ef, ek, tf, tk, sh);
      if (tid == 0) {
        g.aggFk[c] = tk;
        g.aggFf[c] = tf;
      }
      grid_sync(g.bar, sh.bar_target);
      int cf;
      long long ck;
      fold_seg(g.aggFf, g.aggFk, c, cf, ck, sh);
      seg_combine(cf, ck, ef, ek);
      closure_up(ch, ef, ek);
      __syncthreads();
      // 3, 4: the bucket sides, each from a snapshot of every CTA's d
      snapshot(ch, g.dbufF, g.bar, sh);
      bool imp = relax_side(ch, ch.tabF, ch.cntF, g.dbufF, 3);
      __syncthreads();
      snapshot(ch, g.dbufB, g.bar, sh);
      imp = relax_side(ch, ch.tabB, ch.cntB, g.dbufB, 4) || imp;
      my_chg = __syncthreads_or(imp);
      ++it;
    }
    rounds += it;
    const long long t2 = timer ? global_ns() : 0;
    // the cheapest deficit node: lexicographic argmin of (d, index); the
    // parents published for the walk, the chain's diff entries zeroed
    long long best = kNoKey;
    for (int i = tid; i < ch.cl; i += kThreads) {
      const int gi = ch.lo + i;
      g.pk[gi] = ch.pk[i];
      g.pid[gi] = ch.pid[i];
      g.diff[gi] = 0;
      best = min(best, make_key(ch.ex[i] < 0 ? ch.d[i] : INF, gi));
    }
    best = block_min(best, sh);
    if (tid == 0) g.argK[c] = best;
    grid_sync(g.bar, sh.bar_target);
    best = fold_min(g.argK, 0, G, sh);
    const int32_t d_sink = key_value(best);
    const int sink = key_index(best);
    if (d_sink >= INF) {
      status = INFEASIBLE;
    } else if (changed) {
      status = FIXPOINT_CAP;
    } else {
      status = augment(net, g, ch, sh, sink);
    }
    long long npmax = kNoKey;  // -max(pi)
    for (int i = tid; i < ch.cl; i += kThreads) {
      const int32_t p = add32(ch.pi[i], min(ch.d[i], d_sink));
      ch.pi[i] = p;
      g.pi[ch.lo + i] = p;
      npmax = min(npmax, -static_cast<long long>(p));
    }
    npmax = block_min(npmax, sh);
    if (tid == 0) g.pmaxP[c] = npmax;
    publish_supply();
    grid_sync(g.bar, sh.bar_target);
    const long long pmax = -fold_min(g.pmaxP, 0, G, sh);
    if (status == OK && pmax > PI_GUARD) status = PI_OVERFLOW;
    supply = fold_sum(g.supP, 0, G, sh);
    ++phases;
    if (timer) {
      ns[0] += t2 - t1;
      ns[1] += t1 - t0;
      ns[2] += global_ns() - t2;
    }
  }
  if (status == OK && supply > 0) status = DEGENERATE;
  if (c == 0 && tid == 0) {
    scalars[0] = supply;
    scalars[1] = status;
    scalars[2] = phases;
    scalars[3] = static_cast<int32_t>(min(rounds, static_cast<long long>(INT_MAX)));
    for (int k = 0; k < 3; ++k) laps[k] = ns[k];
  }
}

}  // namespace

// The workspace, int32 words: 16 of control (the barrier at 0, the walk at
// 8), 16 G of per-CTA partials, 10 arrays of n + 2, then the two bucket
// tables of 4 B words each, 16-byte aligned. ops/ssp.py::_ws_words mirrors it.
constexpr int64_t kCtrlWords = 16, kPartialWords = 16, kWsNodeArrays = 10;

// Returns the cudaError_t of the launch (0 on success):
// cudaErrorNotSupported without cooperative launch,
// cudaErrorCooperativeLaunchTooLarge where G CTAs cannot be co-resident,
// cudaErrorInvalidValue for sizes it does not take (a chunk whose node
// arrays exceed shared memory among them). bstart, bend1, off0, cap:
// int32[B]; pool, run_lo, run_hi: int32[R]; excess0: int32[n+1]; orderF,
// orderB: int32[B] the bucket ids by bend1 and by bstart; rangeF, rangeB:
// int32[G+1] each CTA's range in them (CTA c owns the nodes [c C, c C + C),
// C = ceil((n+1) / G)); capF, capB: the largest range; flow: int32[B] out;
// scalars: 40 bytes out, 8-byte aligned: int32[4] (supply, status, phases,
// rounds), then int64[3], thread 0 of CTA 0's global-timer ns in the
// fixpoint rounds, in each phase's reset and bucket tables, and in the
// phases' ends; ws: the workspace.
extern "C" int gd_ssp_solve(const void* bstart, const void* bend1, const void* off0,
                            const void* cap, const void* pool, const void* run_lo,
                            const void* run_hi, const void* excess0, const void* orderF,
                            const void* rangeF, const void* orderB, const void* rangeB,
                            void* flow, void* scalars, void* ws, int64_t n, int64_t B,
                            int64_t R, int64_t G, int64_t capF, int64_t capB,
                            int64_t phase_cap, void* stream) {
  if (n < 1 || B < 1 || R < B || B > INT_MAX / 8 || n + 2 > INT_MAX / 16 || G < 1 ||
      G > n + 1 || capF < 0 || capF > B || capB < 0 || capB > B || phase_cap < 0 ||
      phase_cap > INT_MAX)
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
  const int64_t node_bytes = kNodeArrays * Cp * 4, budget = optin - int64_t(sizeof(Shared));
  const int64_t table_bytes = (capF + capB) * kEntryBytes;
  if (node_bytes > budget) return (int)cudaErrorInvalidValue;
  int tables_shared = node_bytes + table_bytes <= budget;
  const size_t smem = static_cast<size_t>(node_bytes + (tables_shared ? table_bytes : 0));
  err = cudaFuncSetAttribute(ssp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssp_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (int64_t(per_sm) * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;

  Net net{static_cast<const int32_t*>(bstart), static_cast<const int32_t*>(bend1),
          static_cast<const int32_t*>(off0),   static_cast<const int32_t*>(cap),
          static_cast<const int32_t*>(pool),   static_cast<const int32_t*>(run_lo),
          static_cast<const int32_t*>(run_hi), static_cast<const int32_t*>(orderF),
          static_cast<const int32_t*>(rangeF), static_cast<const int32_t*>(orderB),
          static_cast<const int32_t*>(rangeB), static_cast<int>(n),
          static_cast<int>(B)};
  int32_t* w = static_cast<int32_t*>(ws);
  const int64_t m = n + 2;
  int32_t* part = w + kCtrlWords;
  auto ll = [&](int k) { return reinterpret_cast<long long*>(part) + k * G; };
  int32_t* ints = part + 10 * G;
  int32_t* nodes = part + kPartialWords * G;
  auto arr = [&](int k) { return nodes + k * m; };
  int4* tab = reinterpret_cast<int4*>(w + ((kCtrlWords + kPartialWords * G +
                                             kWsNodeArrays * m + 3) & ~int64_t(3)));
  Glob g{reinterpret_cast<unsigned*>(w), w + 8, ll(0), ll(1), ll(2), ll(3), ll(4),
         ints, ints + G, ints + 2 * G, ints + 3 * G,
         arr(0), arr(1), arr(2), arr(3), arr(4), arr(5), arr(6), arr(7), arr(8), arr(9),
         tab, tab + B, static_cast<int32_t*>(flow)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(w, 0, kCtrlWords * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int32_t* ex0 = static_cast<const int32_t*>(excess0);
  int32_t* sc = static_cast<int32_t*>(scalars);
  long long* laps = static_cast<long long*>(scalars) + 2;
  int32_t pc = static_cast<int32_t>(phase_cap);
  int cap_f = static_cast<int>(capF);
  void* args[] = {&net, &g, &ex0, &sc, &laps, &pc, &tables_shared, &cap_f};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ssp_kernel),
                                    dim3(static_cast<unsigned>(G)), dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
