// The SSP kernel: the whole successive-shortest-paths solve of the exact
// weighted QMCP in one launch, for NVIDIA Hopper (sm_90a).
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
// by a Bellman-Ford fixpoint of (chain closure, bucket relax); the
// cheapest deficit node; a walk along the parent pointers to a source; the
// push delta, bounded by the deficit, the source's excess, each bucket
// hop's equal-cost run and the net chain usage; potentials pi += min(d,
// d_sink). Phases run until the supply is 0 or a status other than OK.
//
// What bounds it on the H100. The work is sequential: phases (one per unit
// of supply, about M), fixpoint rounds per phase (the bucket hops of a
// shortest path, about n / span), and within a round two scans over n + 1
// nodes and two scatter-mins over the B buckets. Each round moves
// (4 (n + 1) + 6 B) words and does a few operations per word, so the card's
// bytes and operations are far from binding; what binds is the chain of
// block-wide barriers, several per tile of the two scans per round.
//
// What the design does about it (simple and right first). One CTA of 1024
// threads holds the whole solve, so every barrier is a __syncthreads and
// the state (about 2 MB at config-1, 8 MB at n = 131,072) stays in global
// memory, resident in L2. The closure is two block-wide scans over tiles of
// 4096 nodes (4 a thread) with a carried (value, index) key, packed into
// one int64 (value * 2^32 + index) so that integer min is the JAX
// program's lexicographic min: a reverse min scan, then a forward min scan
// segmented at zero chain flow. The bucket relax keeps a copy of d, takes
// atomicMin into d, then a second atomicMin of the bucket id into a
// staging array for the winners; integer min does not depend on order, so
// the result is deterministic. `changed` is __syncthreads_or. The walk is
// one thread into a step buffer of n + 2 entries (a path visits a node at
// most once: the parents form a forest), the net chain coefficient a
// difference array and a block prefix sum. int32 sums are added as
// uint32 so that they wrap as XLA's do.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;  // nodes a thread holds in each scan tile
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t INF = 1 << 30;
constexpr int32_t IMAX = INT_MAX;
constexpr int32_t PI_GUARD = 1 << 29;
constexpr long long kNoKey = LLONG_MAX;
enum { OK = 0, INFEASIBLE, FIXPOINT_CAP, PATH_OVERFLOW, PI_OVERFLOW, DEGENERATE };
// int32 arrays of n + 2 entries in the workspace (ops/ssp.py: _WS_ARRAYS)
constexpr int kWsArrays = 11;

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
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
// floor division (JAX's // on int32), b > 0
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  if (a % b != 0 && a < 0) --q;
  return q;
}

struct Shared {
  long long tot_k[kWarps];  // each warp's scanned total
  int tot_f[kWarps];
  long long pre_k[kWarps];  // each warp's prefix (earlier warps and carry)
  int pre_f[kWarps];
  long long carry_k;        // the scan so far, carried between tiles
  int carry_f;
  long long red[kWarps];
  int sum_carry;
  int walk_src, walk_bn, walk_status, walk_nb;
};

// prefix (pf, pk) then (f, k): the segmented min of `_seg_lexmin`
__device__ __forceinline__ void seg_combine(int pf, long long pk, int& f, long long& k) {
  if (!f) k = min(pk, k);
  f |= pf;
}

// One tile of a segmented min scan: thread t holds items t*kItems ..
// t*kItems + kItems - 1 of the scan order (f: a segment starts at the item,
// k: its key); continues from the carry in `sh` and moves it on. Returns
// each item's exclusive result (the inclusive result of the item before).
__device__ void block_seg_scan(const int (&f)[kItems], const long long (&k)[kItems],
                               long long (&excl)[kItems], Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lf[kItems];
  long long lk[kItems];
  lf[0] = f[0];
  lk[0] = k[0];
#pragma unroll
  for (int j = 1; j < kItems; ++j) {
    lf[j] = f[j];
    lk[j] = k[j];
    seg_combine(lf[j - 1], lk[j - 1], lf[j], lk[j]);
  }
  int wf = lf[kItems - 1];
  long long wk = lk[kItems - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int pf = __shfl_up_sync(kFull, wf, o);
    const long long pk = __shfl_up_sync(kFull, wk, o);
    if (lane >= o) seg_combine(pf, pk, wf, wk);
  }
  if (lane == 31) {
    sh.tot_f[warp] = wf;
    sh.tot_k[warp] = wk;
  }
  __syncthreads();
  if (warp == 0) {
    int xf = sh.tot_f[lane];
    long long xk = sh.tot_k[lane];
    const int cf = sh.carry_f;
    const long long ck = sh.carry_k;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int pf = __shfl_up_sync(kFull, xf, o);
      const long long pk = __shfl_up_sync(kFull, xk, o);
      if (lane >= o) seg_combine(pf, pk, xf, xk);
    }
    int ef = __shfl_up_sync(kFull, xf, 1);
    long long ek = __shfl_up_sync(kFull, xk, 1);
    if (lane == 0) {
      ef = cf;
      ek = ck;
    } else {
      seg_combine(cf, ck, ef, ek);
    }
    int lastf = __shfl_sync(kFull, xf, 31);
    long long lastk = __shfl_sync(kFull, xk, 31);
    __syncwarp();
    sh.pre_f[lane] = ef;
    sh.pre_k[lane] = ek;
    if (lane == 0) {
      seg_combine(cf, ck, lastf, lastk);
      sh.carry_f = lastf;
      sh.carry_k = lastk;
    }
  }
  __syncthreads();
  // this thread's prefix: the warp's prefix, then the lower lanes
  int pf = __shfl_up_sync(kFull, wf, 1);
  long long pk = __shfl_up_sync(kFull, wk, 1);
  if (lane == 0) {
    pf = sh.pre_f[warp];
    pk = sh.pre_k[warp];
  } else {
    seg_combine(sh.pre_f[warp], sh.pre_k[warp], pf, pk);
  }
  excl[0] = pk;
#pragma unroll
  for (int j = 1; j < kItems; ++j) {
    int ff = lf[j - 1];
    long long kk = lk[j - 1];
    seg_combine(pf, pk, ff, kk);
    excl[j] = kk;
  }
}

__device__ __forceinline__ void set_carry(Shared& sh, int f, long long k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    sh.carry_f = f;
    sh.carry_k = k;
    sh.sum_carry = 0;
  }
  __syncthreads();
}

// One tile of an inclusive int32 prefix sum (wrapping), carried in sh.
__device__ void block_sum_scan(int (&x)[kItems], Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 1; j < kItems; ++j) x[j] = add32(x[j], x[j - 1]);
  int w = x[kItems - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int p = __shfl_up_sync(kFull, w, o);
    if (lane >= o) w = add32(w, p);
  }
  if (lane == 31) sh.tot_f[warp] = w;
  __syncthreads();
  if (warp == 0) {
    int v = sh.tot_f[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int p = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = add32(v, p);
    }
    const int c = sh.sum_carry;
    int e = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) e = 0;
    const int last = __shfl_sync(kFull, v, 31);
    __syncwarp();
    sh.pre_f[lane] = add32(c, e);
    if (lane == 0) sh.sum_carry = add32(c, last);
  }
  __syncthreads();
  int p = __shfl_up_sync(kFull, w, 1);
  if (lane == 0) p = 0;
  p = add32(p, sh.pre_f[warp]);
#pragma unroll
  for (int j = 0; j < kItems; ++j) x[j] = add32(x[j], p);
}

// block-wide reductions; every thread gets the result
__device__ long long block_min(long long v, Shared& sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh.red[0];
  for (int w = 1; w < kWarps; ++w) v = min(v, sh.red[w]);
  __syncthreads();
  return v;
}

__device__ int32_t block_max(int32_t v, Shared& sh) {
  return static_cast<int32_t>(-block_min(-static_cast<long long>(v), sh));
}

__device__ int32_t block_sum(int32_t v, Shared& sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add32(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t s = 0;
  for (int w = 0; w < kWarps; ++w) s = add32(s, static_cast<int32_t>(sh.red[w]));
  __syncthreads();
  return s;
}

struct Net {
  const int32_t* __restrict__ bstart;
  const int32_t* __restrict__ bend1;
  const int32_t* __restrict__ off0;
  const int32_t* __restrict__ cap;
  const int32_t* __restrict__ pool;
  const int32_t* __restrict__ run_lo;
  const int32_t* __restrict__ run_hi;
  int n, B;
};

// mutable state in global memory (not restrict: every thread writes)
struct State {
  int32_t *d, *dold, *pk, *pid, *pi, *excess, *stage, *chainflow, *diff, *stepk,
      *stepx, *flow;
};

// chain closure: downward arcs by a reverse min scan, then upward arcs by
// a forward min scan segmented at zero chain flow
__device__ void chain_closure(const Net& net, State& s, Shared& sh) {
  const int n1 = net.n + 1;
  const int tid = threadIdx.x;
  long long k[kItems], excl[kItems];
  int f[kItems];
  set_carry(sh, 0, make_key(INF, 0));
  for (int hi = n1 - 1; hi >= 0; hi -= kTile) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = hi - (tid * kItems + j);
      f[j] = 0;
      k[j] = kNoKey;
      if (i >= 0) {
        const int32_t dv = s.d[i];
        k[j] = make_key(dv >= INF ? INF : add32(dv, s.pi[i]), i);
      }
    }
    block_seg_scan(f, k, excl, sh);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = hi - (tid * kItems + j);
      if (i < 0) continue;
      const int32_t mv = key_value(excl[j]);
      const int32_t cand = mv >= INF ? INF : sub32(mv, s.pi[i]);
      if (cand < s.d[i]) {
        s.d[i] = cand;
        s.pk[i] = 1;
        s.pid[i] = key_index(excl[j]);
      }
    }
  }
  set_carry(sh, 1, make_key(INF, 0));
  for (int lo = 0; lo < n1; lo += kTile) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = lo + tid * kItems + j;
      f[j] = 0;
      k[j] = kNoKey;
      if (i < n1) {
        f[j] = (i == 0 || s.chainflow[i - 1] == 0);
        const int32_t dv = s.d[i];
        k[j] = make_key(dv >= INF ? INF : add32(dv, s.pi[i]), i);
      }
    }
    block_seg_scan(f, k, excl, sh);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = lo + tid * kItems + j;
      if (i >= n1 || f[j]) continue;
      const int32_t mv = key_value(excl[j]);
      const int32_t cand = mv >= INF ? INF : sub32(mv, s.pi[i]);
      if (cand < s.d[i]) {
        s.d[i] = cand;
        s.pk[i] = 2;
        s.pid[i] = key_index(excl[j]);
      }
    }
  }
  __syncthreads();
}

// one side of the bucket relax (kind 3: forward, 4: backward); returns
// whether this thread saw a node improve
__device__ bool relax_side(const Net& net, State& s, int kind) {
  const int n1 = net.n + 1;
  const int tid = threadIdx.x;
  for (int i = tid; i < n1; i += kThreads) {
    s.dold[i] = s.d[i];
    s.stage[i] = IMAX;
  }
  __syncthreads();
  // cand of bucket b, or INF where the arc has no residual
  auto cand_of = [&](int b, int& dst) -> int32_t {
    const int32_t fl = s.flow[b], cp = net.cap[b];
    const int32_t ps = s.pi[net.bstart[b]], pt = s.pi[net.bend1[b]];
    int src;
    int32_t rc;
    if (kind == 3) {
      if (!(fl < cp)) return INF;
      src = net.bstart[b];
      dst = net.bend1[b];
      const int32_t mc = net.pool[net.off0[b] + min(fl, cp - 1)];
      rc = sub32(add32(mc, ps), pt);
    } else {
      if (!(fl > 0)) return INF;
      src = net.bend1[b];
      dst = net.bstart[b];
      const int32_t mc = net.pool[net.off0[b] + max(fl - 1, 0)];
      rc = sub32(add32(sub32(0, mc), pt), ps);
    }
    const int32_t ds = s.dold[src];
    return ds < INF ? add32(ds, rc) : INF;
  };
  for (int b = tid; b < net.B; b += kThreads) {
    int dst = 0;
    const int32_t c = cand_of(b, dst);
    if (c < INF) atomicMin(&s.d[dst], c);
  }
  __syncthreads();
  for (int b = tid; b < net.B; b += kThreads) {
    int dst = 0;
    const int32_t c = cand_of(b, dst);
    if (c < INF) {
      const int32_t da = s.d[dst];
      if (c == da && da < s.dold[dst]) atomicMin(&s.stage[dst], b);
    }
  }
  __syncthreads();
  bool improved = false;
  for (int i = tid; i < n1; i += kThreads) {
    if (s.d[i] < s.dold[i]) {
      s.pk[i] = kind;
      s.pid[i] = s.stage[i];
      improved = true;
    }
  }
  __syncthreads();
  return improved;
}

// walk from the sink to a source (thread 0), bound the push, apply it;
// returns the phase's status
__device__ int augment(const Net& net, State& s, Shared& sh, int sink) {
  const int n = net.n;
  const int tid = threadIdx.x;
  for (int i = tid; i <= n; i += kThreads) s.diff[i] = 0;
  __syncthreads();
  if (tid == 0) {
    int v = sink, steps = 0, nb = 0;
    int32_t bn = sub32(0, s.excess[sink]);
    int st = OK;
    while (s.pk[v] != 0) {
      if (steps == n + 2) {
        st = PATH_OVERFLOW;
        break;
      }
      ++steps;
      const int x = s.pid[v], kind = s.pk[v];
      if (kind == 1) {  // down run x -> v: chain arcs [v, x) forward
        s.diff[v] += 1;
        s.diff[x] -= 1;
        v = x;
      } else if (kind == 2) {  // up run x -> v: chain arcs [x, v) backward
        s.diff[x] -= 1;
        s.diff[v] += 1;
        v = x;
      } else if (kind == 3) {
        const int32_t k = add32(net.off0[x], s.flow[x]);
        bn = min(bn, sub32(add32(net.run_hi[k], 1), k));
        s.stepk[nb] = 1;
        s.stepx[nb++] = x;
        v = net.bstart[x];
      } else {
        const int32_t top = add32(net.off0[x], s.flow[x]);
        bn = min(bn, sub32(top, net.run_lo[top - 1]));
        s.stepk[nb] = -1;
        s.stepx[nb++] = x;
        v = net.bend1[x];
      }
    }
    sh.walk_src = v;
    sh.walk_bn = bn;
    sh.walk_status = st;
    sh.walk_nb = nb;
  }
  __syncthreads();
  if (sh.walk_status != OK) return sh.walk_status;
  const int src = sh.walk_src;
  // coef = prefix sum of diff over the n chain arcs (in place); the push's
  // bound from the arcs used against their flow
  int32_t head = IMAX;
  __syncthreads();
  if (tid == 0) sh.sum_carry = 0;
  __syncthreads();
  for (int lo = 0; lo < n; lo += kTile) {
    int x[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = lo + tid * kItems + j;
      x[j] = i < n ? s.diff[i] : 0;
    }
    block_sum_scan(x, sh);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = lo + tid * kItems + j;
      if (i >= n) continue;
      s.diff[i] = x[j];
      if (x[j] < 0) head = min(head, floordiv(s.chainflow[i], max(sub32(0, x[j]), 1)));
    }
  }
  head = static_cast<int32_t>(block_min(head, sh));
  const int32_t delta = min(min(sh.walk_bn, head), s.excess[src]);
  if (delta <= 0) return DEGENERATE;
  for (int i = tid; i < n; i += kThreads)
    s.chainflow[i] = add32(s.chainflow[i], mul32(delta, s.diff[i]));
  if (tid == 0) {
    for (int q = 0; q < sh.walk_nb; ++q) {
      const int x = s.stepx[q];
      s.flow[x] = s.stepk[q] > 0 ? add32(s.flow[x], delta) : sub32(s.flow[x], delta);
    }
    s.excess[src] = sub32(s.excess[src], delta);
    s.excess[sink] = add32(s.excess[sink], delta);
  }
  __syncthreads();
  return OK;
}

__global__ void __launch_bounds__(kThreads) ssp_kernel(Net net, State s,
                                                       const int32_t* __restrict__ excess0,
                                                       int32_t* __restrict__ scalars,
                                                       int32_t phase_cap) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int n1 = net.n + 1;
  for (int i = tid; i < n1; i += kThreads) {
    s.excess[i] = excess0[i];
    s.pi[i] = 0;
    if (i < net.n) s.chainflow[i] = 0;
  }
  for (int b = tid; b < net.B; b += kThreads) s.flow[b] = 0;
  __syncthreads();
  auto supply_now = [&]() {
    int32_t v = 0;
    for (int i = tid; i < n1; i += kThreads) v = add32(v, max(s.excess[i], 0));
    return block_sum(v, sh);
  };
  const int it_cap = min(net.B + 3, 1 << 20);
  int32_t supply = supply_now();
  int status = OK, phases = 0;
  long long rounds = 0;
  while (status == OK && supply > 0 && phases < phase_cap) {
    for (int i = tid; i < n1; i += kThreads) {
      s.d[i] = s.excess[i] > 0 ? 0 : INF;
      s.pk[i] = 0;
      s.pid[i] = 0;
    }
    __syncthreads();
    bool changed = true;
    int it = 0;
    while (changed && it < it_cap) {
      chain_closure(net, s, sh);
      bool imp = relax_side(net, s, 3);
      imp = relax_side(net, s, 4) || imp;
      changed = __syncthreads_or(imp) != 0;
      ++it;
    }
    rounds += it;
    // the cheapest deficit node: lexicographic argmin of (d, index)
    long long best = kNoKey;
    for (int i = tid; i < n1; i += kThreads)
      best = min(best, make_key(s.excess[i] < 0 ? s.d[i] : INF, i));
    best = block_min(best, sh);
    const int32_t d_sink = key_value(best);
    const int sink = key_index(best);
    if (d_sink >= INF) {
      status = INFEASIBLE;
    } else if (changed) {
      status = FIXPOINT_CAP;
    } else {
      status = augment(net, s, sh, sink);
    }
    int32_t pmax = INT_MIN;
    for (int i = tid; i < n1; i += kThreads) {
      const int32_t p = add32(s.pi[i], min(s.d[i], d_sink));
      s.pi[i] = p;
      pmax = max(pmax, p);
    }
    pmax = block_max(pmax, sh);
    if (status == OK && pmax > PI_GUARD) status = PI_OVERFLOW;
    supply = supply_now();
    ++phases;
  }
  if (status == OK && supply > 0) status = DEGENERATE;
  if (tid == 0) {
    scalars[0] = supply;
    scalars[1] = status;
    scalars[2] = phases;
    scalars[3] = static_cast<int32_t>(min(rounds, static_cast<long long>(INT_MAX)));
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). bstart, bend1,
// off0, cap: int32[B]; pool, run_lo, run_hi: int32[R]; excess0: int32[n+1];
// flow: int32[B] out; scalars: int32[4] out (supply, status, phases,
// rounds); ws: int32[kWsArrays * (n + 2)] scratch.
extern "C" int gd_ssp_solve(const void* bstart, const void* bend1, const void* off0,
                            const void* cap, const void* pool, const void* run_lo,
                            const void* run_hi, const void* excess0, void* flow,
                            void* scalars, void* ws, int64_t n, int64_t B, int64_t R,
                            int64_t phase_cap, void* stream) {
  if (n < 1 || B < 1 || R < B || n + 2 > INT_MAX / kWsArrays || B > INT_MAX ||
      phase_cap < 0 || phase_cap > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Net net{static_cast<const int32_t*>(bstart), static_cast<const int32_t*>(bend1),
          static_cast<const int32_t*>(off0),   static_cast<const int32_t*>(cap),
          static_cast<const int32_t*>(pool),   static_cast<const int32_t*>(run_lo),
          static_cast<const int32_t*>(run_hi), static_cast<int>(n),
          static_cast<int>(B)};
  int32_t* w = static_cast<int32_t*>(ws);
  const int64_t m = n + 2;
  State s{w,         w + m,     w + 2 * m, w + 3 * m, w + 4 * m, w + 5 * m,
          w + 6 * m, w + 7 * m, w + 8 * m, w + 9 * m, w + 10 * m,
          static_cast<int32_t*>(flow)};
  ssp_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      net, s, static_cast<const int32_t*>(excess0), static_cast<int32_t*>(scalars),
      static_cast<int32_t>(phase_cap));
  return (int)cudaGetLastError();
}
