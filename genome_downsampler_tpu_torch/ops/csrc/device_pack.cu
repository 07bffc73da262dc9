// The device pack of config-5's reads, for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA program `build` of scripts/bench_chr1.py (:147-181):
// reads generated on the device from a Weyl sequence, bucketed into the
// blocked engine's (block, window) groups by an argsort of the groups, a
// searchsorted rank and a scatter, and the coverage difference. No Pallas
// kernel stood there; the port makes the pack a kernel of its own.
//
// What it computes. Read i of r starts at
//   s = ((i * K) mod 2^32) mod m,  K = 2654435761, m = n - read_len + 1
// (uint32 arithmetic), in window w = s / win, block t = (s mod win) / B,
// group g = t * W + w, with the code (s mod B) * L + read_len - 1. It
// writes packed[g, :counts[g]], the group's codes ascending, then -1 pads;
// counts[g]; diff, +1 at each start and -1 past each end; and fill, the
// largest group: bit-equal to ops/device_pack.py::pack_reads_plain.
//
// The inverse of the Weyl map. K is odd, so i -> (i * K) mod 2^32 is a
// bijection of [0, 2^32), whose inverse multiplies by K^-1 = 244002641
// (K * K^-1 = 1 mod 2^32). The reads that start at s are therefore exactly
// the i < r among i_j = ((s + j * m) * K^-1) mod 2^32, j = 0 .. J(s) - 1,
// where s + j * m runs over the x < 2^32 with x mod m = s: J(s) = q + (s <
// rem), q = 2^32 / m, rem = 2^32 mod m. Since r < 2^31 < 2^32, each read
// i < r is one of these candidates once and for one s only, so the start
// count c(s) is exact. The steps are constant: i_{j+1} = i_j + d with d =
// (m * K^-1) mod 2^32, so a candidate costs an add and a compare-and-count.
// Everything the pack writes follows from c:
//   - inside a group (a B-aligned block of one window) the code rises with
//     s, so its row is c(s) copies of code(s) for each s of the block in
//     order, then -1 (the first cap codes where a group holds more);
//   - counts[g] is the block's sum of c; fill the largest of these;
//   - diff[s] = c(s) - c(s - read_len), with c = 0 outside [0, m).
//
// What bounds it on the H100. Bytes: the outputs written once (packed and
// diff, 1.0 GB each at config-5) over 3.35 TB/s: 0.60 ms; nothing is read.
// Operations: the candidates are 2^32 whatever r is (17-18 a position at
// config-5), about 3 int32 operations each (the step's add, and the carry
// out of i + 2^32 - r added to a count): 0.77 ms at 16.7 T int32 op/s.
//
// What the design does about it. One launch, position-major, no atomic on
// packed or diff and no sort; every output element is written once:
//   - a CTA owns a run of P = R * B consecutive positions (R whole blocks;
//     kRunPositions at config-5) and counts c over the run and over the
//     read_len positions before it (diff needs c(s - read_len); past a
//     run's length, the run's positions read_len back and one more) into
//     shared memory, one thread a position: the candidates' loop has the
//     same trip count across the warp (q, then one more below rem);
//   - then each warp takes one block of the run: a lane scans B / 32
//     consecutive counts, shuffles make the offsets, and the warp writes
//     the group's whole row (each lane its codes, then the pads together),
//     counts[g] and the block's diff (16-byte stores where B is a multiple
//     of 128); one atomicMax a CTA on fill.
//   - Small genomes. J grows as 2^32 / m (436,000 at n = 10,000, 5M at
//     n = 1,000), and few runs would leave most SMs idle with one lane
//     walking millions of candidates. The C entry then halves the runs,
//     down to one block, until there are two a SM, and splits each
//     position's j range over `slices` threads of a CTA and over the cs
//     CTAs of a thread-block cluster (up to 8): the partial counts meet by
//     shared-memory atomics in the cluster's first CTA (distributed shared
//     memory), which alone writes the run.
//     The candidates stay 2^32 plus the look-back's, spread over the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kWeylInverse = 244002641u;  // 2654435761^-1 mod 2^32
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunPositions = 4096;  // a run at most (more if B is larger)
constexpr int kMaxBlock = 4096;      // a run's counts: <= 2 * 4096 + 1 ints
constexpr int kMaxCluster = 8;       // the portable cluster size
// a position's candidates are split only where there are this many
constexpr uint64_t kSplitMin = 64;
// items (a position's slice) a thread, where they are split: a CTA's last
// items then idle its threads for at most a quarter of its time
constexpr int kItemsPerThread = 4;

struct Plan {
  uint64_t q;       // J(s) = q + (s < rem)
  uint64_t len;     // candidates a slice (>= every J when unsplit)
  uint32_t r, m, d, rem;
  int32_t read_len, n_pad, P, W, nbw, B, L, cap, slices, cs, vec;
};

// c + (i >= r), nr = 2^32 - r: the carry out of i + nr, two adds (ptxas
// folds two carries into one add)
__device__ __forceinline__ uint32_t add_at_or_above(uint32_t c, uint32_t i, uint32_t nr) {
  asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, %2;\n\taddc.u32 %0, %0, 0;\n\t}"
      : "+r"(c) : "r"(i), "r"(nr));
  return c;
}

// #{0 <= j < n : (i + j * d) mod 2^32 >= r}; i steps past the n candidates
__device__ __forceinline__ uint32_t count_at_or_above(uint32_t& i, uint32_t d, uint32_t n,
                                                      uint32_t nr) {
  uint32_t c = 0;
#pragma unroll 4
  for (uint32_t j = 0; j < n; ++j, i += d) c = add_at_or_above(c, i, nr);
  return c;
}

__global__ void __launch_bounds__(kThreads) pack_kernel(
    int32_t* __restrict__ packed, int32_t* __restrict__ counts,
    int32_t* __restrict__ diff, int32_t* __restrict__ fill, const Plan p) {
  // cnt[k] = c(a - read_len + k) for k <= pc; cnt[h + k] = c(a + k)
  extern __shared__ int32_t cnt[];
  __shared__ int32_t warp_most[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rank = blockIdx.x % p.cs;
  const int a = (blockIdx.x / p.cs) * p.P;
  const int pc = min(p.P, p.n_pad - a);
  const int h = min(p.read_len, pc + 1);
  const int npos = pc + h;

  const uint32_t nr = 0u - p.r;
  if (p.slices * p.cs == 1) {
    // q candidates at every position (a trip count the warp shares), one
    // more below rem
    const uint32_t q = static_cast<uint32_t>(p.q);
    for (int u = threadIdx.x; u < npos; u += kThreads) {
      const int s = u < h ? a - p.read_len + u : a + (u - h);
      uint32_t c = 0;
      if (s >= 0 && static_cast<uint32_t>(s) < p.m) {
        uint32_t i = static_cast<uint32_t>(s) * kWeylInverse;
        uint32_t above = count_at_or_above(i, p.d, q, nr);
        const uint32_t extra = static_cast<uint32_t>(s) < p.rem;
        if (extra) above = add_at_or_above(above, i, nr);
        c = q + extra - above;
      }
      cnt[u] = static_cast<int32_t>(c);
    }
    __syncthreads();
  } else {
    // the slices of a position meet in the cluster's first CTA
    cg::cluster_group cluster = cg::this_cluster();
    int32_t* acc = cnt;
    if (rank == 0)
      for (int u = threadIdx.x; u < npos; u += kThreads) cnt[u] = 0;
    if (p.cs > 1) {
      cluster.sync();
      acc = cluster.map_shared_rank(cnt, 0);
    } else {
      __syncthreads();
    }
    for (int it = threadIdx.x; it < npos * p.slices; it += kThreads) {
      const int u = it % npos;
      const uint64_t k = static_cast<uint64_t>(rank) * p.slices + it / npos;
      const int s = u < h ? a - p.read_len + u : a + (u - h);
      if (s < 0 || static_cast<uint32_t>(s) >= p.m) continue;
      const uint64_t J = p.q + (static_cast<uint32_t>(s) < p.rem);
      const uint64_t j0 = k * p.len;
      if (j0 >= J) continue;
      const uint32_t n = static_cast<uint32_t>(J - j0 < p.len ? J - j0 : p.len);
      uint32_t i = (static_cast<uint32_t>(s) + static_cast<uint32_t>(j0) * p.m) * kWeylInverse;
      const uint32_t c = n - count_at_or_above(i, p.d, n, nr);
      if (c) atomicAdd(acc + u, static_cast<int32_t>(c));
    }
    if (p.cs > 1) {
      cluster.sync();
      if (rank != 0) return;
    } else {
      __syncthreads();
    }
  }

  // one warp a block: the row, counts[g] and the block's diff
  const int V = (p.B + 31) / 32;
  const int lo = min(lane * V, p.B), hi = min(lo + V, p.B);
  int32_t most = 0;
  for (int b = warp; b * p.B < pc; b += kWarps) {
    const int blk = a / p.B + b;
    const int w = blk / p.nbw;
    const int64_t g = int64_t{blk - w * p.nbw} * p.W + w;
    const int32_t* own = cnt + h + b * p.B;
    const int32_t* back = cnt + b * p.B;  // c(s - read_len)
    int32_t sum = 0;
    for (int k = lo; k < hi; ++k) sum += own[k];
    int32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int32_t total = __shfl_sync(0xffffffffu, incl, 31);
    int32_t* row = packed + g * p.cap;
    int32_t* dp = diff + a + b * p.B;
    int32_t off = incl - sum;
    for (int k = lo; k < hi; ++k) {
      const int32_t c = own[k];
      const int32_t code = k * p.L + p.read_len - 1;
      for (int32_t e = off, end = min(off + c, p.cap); e < end; ++e) row[e] = code;
      off += c;
    }
    if (p.vec) {
      for (int k = lo; k < hi; k += 4)
        *reinterpret_cast<int4*>(dp + k) =
            make_int4(own[k] - back[k], own[k + 1] - back[k + 1],
                      own[k + 2] - back[k + 2], own[k + 3] - back[k + 3]);
    } else {
      for (int k = lo; k < hi; ++k) dp[k] = own[k] - back[k];
    }
    for (int32_t e = total + lane; e < p.cap; e += 32) row[e] = -1;
    if (lane == 0) counts[g] = total;
    most = max(most, total);
  }
  // diff's last entry: c(n_pad) = 0 (n_pad >= n >= m), c(n_pad - read_len)
  if (a + pc == p.n_pad && threadIdx.x == 0) diff[p.n_pad] = -cnt[pc];
  if (lane == 0) warp_most[warp] = most;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) most = max(most, warp_most[k]);
    atomicMax(fill, most);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The outputs need no
// initial value: the kernel writes every element of packed [nbw, W, cap],
// counts [nbw * W] and diff [W * win + 1], and the entry zeroes fill [1]
// on the stream before it. win a multiple of B covering ceil(n / W);
// 1 <= r < 2^31, read_len <= min(n, L), W * win < 2^31, B * L < 2^31,
// B <= 4096 (a run's counts in shared memory), cap >= 1.
extern "C" int gd_device_pack(void* packed, void* counts, void* diff, void* fill,
                              int64_t r, int64_t n, int64_t read_len, int64_t W,
                              int64_t win, int64_t B, int64_t L, int64_t cap,
                              void* stream) {
  if (r < 1 || r >= (int64_t{1} << 31) || read_len < 1 || read_len > n ||
      read_len > L || W < 1 || B < 1 || B > kMaxBlock || win < B || win % B != 0 ||
      W * win < n || W * win >= (int64_t{1} << 31) || B * L >= (int64_t{1} << 31) ||
      cap < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(fill, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;

  Plan p{};
  const uint64_t m = static_cast<uint64_t>(n - read_len + 1);
  p.q = (uint64_t{1} << 32) / m;
  p.rem = static_cast<uint32_t>((uint64_t{1} << 32) % m);
  p.r = static_cast<uint32_t>(r);
  p.m = static_cast<uint32_t>(m);
  p.d = p.m * kWeylInverse;
  p.read_len = (int32_t)read_len;
  p.n_pad = (int32_t)(W * win);
  p.W = (int32_t)W;
  p.nbw = (int32_t)(win / B);
  p.B = (int32_t)B;
  p.L = (int32_t)L;
  p.cap = (int32_t)cap;
  p.vec = B % 128 == 0 && reinterpret_cast<uintptr_t>(diff) % 16 == 0;
  // runs of R blocks, halved while there are fewer than two a SM
  const int64_t blocks = W * (win / B), target = 2 * int64_t{sms};
  int64_t R = B < kRunPositions ? kRunPositions / B : 1;
  int64_t runs = (blocks + R - 1) / R;
  while (R > 1 && runs < target) {
    R = (R + 1) / 2;
    runs = (blocks + R - 1) / R;
  }
  p.P = (int32_t)(R * B);
  const int64_t npos = p.P + (read_len < p.P + 1 ? read_len : p.P + 1);
  p.cs = 1;
  p.slices = 1;
  if (p.q >= kSplitMin) {
    const int64_t cs = (target + runs - 1) / runs;
    p.cs = (int32_t)(cs < kMaxCluster ? cs : kMaxCluster);
    p.slices = (int32_t)((kItemsPerThread * kThreads + npos - 1) / npos);
    // m = 1: one position of 2^32 candidates, more than a slice counts
    if (p.slices * p.cs == 1 && p.q >= 0xffffffffu) p.slices = 2;
  }
  const uint64_t S = static_cast<uint64_t>(p.slices) * p.cs;
  p.len = (p.q + 1 + S - 1) / S;

  const size_t smem = sizeof(int32_t) * npos;
  auto out = static_cast<int32_t*>(packed);
  auto c = static_cast<int32_t*>(counts);
  auto d = static_cast<int32_t*>(diff);
  auto f = static_cast<int32_t*>(fill);
  if (p.cs == 1) {
    pack_kernel<<<(unsigned)runs, kThreads, smem, st>>>(out, c, d, f, p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(runs * p.cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pack_kernel, out, c, d, f, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
