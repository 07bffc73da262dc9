// Kernel C: per-slot selection bytes of the blocked exact-MCP solve, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_recon_kernel` driven by
// `blocked_selection_pass` in genome_downsampler_tpu/ops/pallas_blocked.py.
//
// What it computes. The sweep emits sel[e], the number of selected reads
// that end at genome position e. Within an end bucket the reads are taken
// in (start, read index) order, so a packed read is selected iff its rank
// in its bucket is below sel[end]. For a read of group (t, w) (block t of
// window w) with block-relative end e' = end - t*B, the rank is
//   acc_t[e'] = xwin[w, e' + t*B] (reads of earlier windows ending there;
//               0 where e' + t*B >= B + L)
//             + # reads of groups t-K..t-1 of window w ending there,
//               K = 1 + (L - 2) / B (no read of an earlier group reaches
//               further: its end is at most B + L - 2 past its block),
// plus the number of EARLIER SLOTS OF ITS GROUP WITH THE SAME END. The
// last term is the rank among same-end reads with a smaller (start, read
// index) because each group is code-sorted, stable by read index (the
// precondition below): the code start_rel * L + span - 1 is start-major,
// and a same-end read with a smaller start has a smaller code. sel is read
// at the global end, so an end past the window runs into window w+1's head
// and an end past the genome reads 0.
//
// What bounds it on the H100. Each code is read a few times (its group's
// two passes, K lookbacks, mostly L2 hits), one quota gathered and one byte
// written per slot: bytes, about 75 MB at config-4, and few operations.
// Nothing is sequential across groups, so the grid is every group.
//
// What the design does about it. One CTA of four warps per group (t, w):
// 39,072 CTAs at config-4, no walk over blocks and no ring carried
// between CTAs. The CTA builds acc_t in shared memory from the xwin slice
// and a shared-atomic histogram of the lookback groups' ends. The group's
// slots are cut into four contiguous ranges of whole 32-slot chunks, one
// per warp. Pass 1: each warp counts its range's ends in its own shared
// histogram (__match_any_sync on the end: one add per distinct end of a
// chunk, by its lowest lane). A scan across the warps turns the
// histograms into each range's starting ranks (acc_t plus the earlier
// ranges' counts). Pass 2: each warp walks its range again, chunk by
// chunk: rank = base[end] + # lower lanes with the same end, and the
// chunk's lowest lane of each end moves base[end] on. O(cnt) per group, no
// division by a runtime L (L is a template parameter).
//
// Past the shared-memory tile. The tile needs (1 + kWarps) (B + L) ints,
// which 227 KB holds up to B + L = 11,622 (L = 11,488 at B = 128). Above,
// a read's rank needs acc_t only at the distinct ends of its group, so the
// hash path (blocked_select_hash_kernel) keeps those in a shared hash table
// of H = the least power of two >= 2 min(cap, kHashChunk) entries (key,
// acc, one count a warp: 24 H bytes, 12 KB at cap = 256), inserts the
// group's ends, seeds each entry from xwin, streams the K lookback groups'
// codes once (one group a thread) and adds each code whose end is in the
// table, then runs passes 1 and 2 as above with an entry in place of an
// end. The work is O(cnt + lookback codes + K), independent of L; long
// reads give about 1-2 read starts a block. A group of more than H/2
// reads is ranked H/2 slots at a time, its earlier slots streamed like the
// lookback groups. Its division by L is a plain 32-bit one (codes are
// below B L < 2^31), where the tile's magic multiply needs B L^2 < 2^40,
// which holds wherever the tile fits.
//
// Preconditions: packed[t, w, :counts[t, w]] holds the group's codes
// start_rel * L + span - 1 (start_rel < B, span <= L), SORTED ASCENDING,
// equal codes in read-index order, as the packers emit them (io/csrc/
// greedy.cpp, gd_pack_blocked and gd_pack_flat_direct); slots past
// counts[t, w] are ignored and get 0; L a multiple of 32 with B L < 2^31
// (a template parameter for L <= 768, at run time above, the hash path
// where the tile does not fit). Output keeps the (t, w, slot) byte order of
// the packed array.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_slots.cuh"

namespace {

using gd::kFull;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 232448;  // the most a CTA may have on sm_90
constexpr int kHashChunk = 4096;     // slots the hash path ranks at once

// block-relative end of a code: start_rel + span - 1. L = 0 instantiates
// the kernel for an L known at run time (lrt), divided by the precomputed
// multiply (c * magic) >> 40, magic = 2^40 / lrt + 1: exact (and the
// product within 64 bits) for codes c < 2^40 / lrt, and codes are below
// B * lrt: B * lrt^2 < 2^35 wherever the tile fits (B + lrt <= 11,622)
template <int L>
__device__ __forceinline__ int code_end(int c, int lrt, uint64_t magic) {
  if constexpr (L > 0) {
    const int sr = c / L;  // L is a constant: a multiply and a shift
    return sr + (c - sr * L);
  } else {
    const int sr = static_cast<int>((static_cast<uint64_t>(static_cast<uint32_t>(c)) * magic) >> 40);
    return sr + (c - sr * lrt);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads) blocked_select_kernel(
    const int32_t* __restrict__ packed,  // [nbw, W, cap]
    const int32_t* __restrict__ counts,  // [nbw, W]
    const int32_t* __restrict__ sel,     // [W * nbw * B]
    const int32_t* __restrict__ xwin,    // [W, B + L]
    int8_t* __restrict__ out,            // [nbw, W, cap]
    int64_t nbw, int64_t W, int64_t cap, int B, int lrt, uint64_t magic) {
  extern __shared__ int32_t smem[];
  const int Lv = L > 0 ? L : lrt;
  const int lring = B + Lv;
  int32_t* acc = smem;           // [B + L]: acc_t
  int32_t* hist = smem + lring;  // [kWarps][B + L]

  const int64_t gi = blockIdx.x;  // group t * W + w
  const int64_t t = gi / W, w = gi - t * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t win = nbw * B;
  const int64_t n_pad = W * win;

  // ---- acc_t: the xwin slice, then the ends of the lookback groups
  for (int e = tid; e < lring; e += kThreads) {
    const int64_t x = e + t * B;
    acc[e] = x < lring ? xwin[w * lring + x] : 0;
  }
  for (int e = tid; e < kWarps * lring; e += kThreads) hist[e] = 0;
  __syncthreads();
  const int K = 1 + (Lv - 2) / B;
  for (int64_t u = t > K ? t - K : 0; u < t; ++u) {
    const int cu = counts[u * W + w];
    const int32_t* __restrict__ gu = packed + (u * W + w) * cap;
    const int back = static_cast<int>(t - u) * B;
    for (int i = tid; i < cu; i += kThreads) {
      const int e = code_end<L>(gu[i], lrt, magic) - back;
      if (e >= 0) atomicAdd(&acc[e], 1);
    }
  }

  const int cnt = counts[gi];
  const int32_t* __restrict__ g = packed + gi * cap;
  int8_t* __restrict__ o = out + gi * cap;
  for (int64_t i = cnt + tid; i < cap; i += kThreads) o[i] = 0;

  // ---- this warp's range of whole 32-slot chunks
  const int per = (cnt + 32 * kWarps - 1) / (32 * kWarps) * 32;
  const int lo = min(warp * per, cnt);
  const int hi = min(lo + per, cnt);
  int32_t* hw = hist + warp * lring;
  const unsigned lower = (1u << lane) - 1u;

  // pass 1: the range's reads per end
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    const int e = s < hi ? code_end<L>(g[s], lrt, magic) : -1;
    const unsigned peers = __match_any_sync(kFull, e);
    if (e >= 0 && (peers & lower) == 0) hw[e] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each range's starting rank per end: acc_t plus the earlier ranges
  for (int e = tid; e < lring; e += kThreads) {
    int run = acc[e];
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int h = hist[k * lring + e];
      hist[k * lring + e] = run;
      run += h;
    }
  }
  __syncthreads();
  // pass 2: rank = base + same-end lanes below; the lowest lane of each end
  // moves the base on
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    const int e = s < hi ? code_end<L>(g[s], lrt, magic) : -1;
    const unsigned peers = __match_any_sync(kFull, e);
    if (e >= 0) {
      const int rank = hw[e] + __popc(peers & lower);
      const int64_t gend = w * win + t * B + e;
      const int quota = gend < n_pad ? sel[gend] : 0;
      o[s] = static_cast<int8_t>(rank < quota);
    }
    __syncwarp();
    if (e >= 0 && (peers & lower) == 0) hw[e] += __popc(peers);
    __syncwarp();
  }
}

template <int L>
cudaError_t launch_l(const int32_t* packed, const int32_t* counts,
                     const int32_t* sel, const int32_t* xwin, int8_t* out,
                     int64_t nbw, int64_t W, int64_t cap, int B,
                     cudaStream_t stream, int lrt = L) {
  const size_t smem = sizeof(int32_t) * (1 + kWarps) * (B + lrt);
  const uint64_t magic = (uint64_t{1} << 40) / static_cast<uint64_t>(lrt) + 1;
  auto kernel = blocked_select_kernel<L>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)(nbw * W), kThreads, smem, stream>>>(
      packed, counts, sel, xwin, out, nbw, W, cap, B, lrt, magic);
  return cudaGetLastError();
}

// the hash table's slot of end e: linear probing from a multiplicative hash
__device__ __forceinline__ int hash_home(int e, int hbits) {
  return static_cast<int>((static_cast<uint32_t>(e) * 2654435761u) >> (32 - hbits));
}

// insert end e (keys -1 when empty); the table is at most half full
__device__ __forceinline__ void hash_insert(int32_t* keys, int e, int hbits) {
  const int mask = (1 << hbits) - 1;
  for (int s = hash_home(e, hbits);; s = (s + 1) & mask) {
    const int k = atomicCAS(&keys[s], -1, e);
    if (k == -1 || k == e) return;
  }
}

// end e's entry, or -1 if it is not one of the ends being ranked
__device__ __forceinline__ int hash_find(const int32_t* keys, int e, int hbits) {
  const int mask = (1 << hbits) - 1;
  for (int s = hash_home(e, hbits);; s = (s + 1) & mask) {
    const int k = keys[s];
    if (k == e) return s;
    if (k == -1) return -1;
  }
}

__device__ __forceinline__ int end_of(int c, int L) {
  const int sr = c / L;
  return sr + (c - sr * L);
}

__global__ void __launch_bounds__(kThreads) blocked_select_hash_kernel(
    const int32_t* __restrict__ packed,  // [nbw, W, cap]
    const int32_t* __restrict__ counts,  // [nbw, W]
    const int32_t* __restrict__ sel,     // [W * nbw * B]
    const int32_t* __restrict__ xwin,    // [W, B + L]
    int8_t* __restrict__ out,            // [nbw, W, cap]
    int64_t nbw, int64_t W, int64_t cap, int B, int L, int hbits) {
  extern __shared__ int32_t smem[];
  const int H = 1 << hbits;
  int32_t* keys = smem;      // [H]: an end, or -1
  int32_t* acc = keys + H;   // [H]: acc_t at the entry's end
  int32_t* hist = acc + H;   // [kWarps][H]
  const int lring = B + L;

  const int64_t gi = blockIdx.x;  // group t * W + w
  const int64_t t = gi / W, w = gi - t * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t win = nbw * B;
  const int64_t n_pad = W * win;
  const int K = 1 + (L - 2) / B;
  const int64_t u0 = t > K ? t - K : 0;

  const int cnt = counts[gi];
  const int32_t* __restrict__ g = packed + gi * cap;
  int8_t* __restrict__ o = out + gi * cap;
  for (int64_t i = cnt + tid; i < cap; i += kThreads) o[i] = 0;
  int32_t* hw = hist + warp * H;
  const unsigned lower = (1u << lane) - 1u;

  for (int c0 = 0; c0 < cnt; c0 += H / 2) {
    const int c1 = min(c0 + H / 2, cnt);
    for (int i = tid; i < H; i += kThreads) keys[i] = -1;
    for (int i = tid; i < (1 + kWarps) * H; i += kThreads) acc[i] = 0;
    __syncthreads();
    for (int s = c0 + tid; s < c1; s += kThreads) hash_insert(keys, end_of(g[s], L), hbits);
    __syncthreads();
    // ---- acc_t at each end: the xwin term, then the lookback groups' and
    // this group's earlier slots' reads ending there
    for (int i = tid; i < H; i += kThreads) {
      const int e = keys[i];
      if (e >= 0) {
        const int64_t x = e + t * B;
        acc[i] = x < lring ? xwin[w * lring + x] : 0;
      }
    }
    __syncthreads();
    for (int64_t u = u0 + tid; u < t; u += kThreads) {
      const int cu = counts[u * W + w];
      const int32_t* __restrict__ gu = packed + (u * W + w) * cap;
      const int back = static_cast<int>(t - u) * B;
      for (int i = 0; i < cu; ++i) {
        const int e = end_of(gu[i], L) - back;
        const int k = e >= 0 ? hash_find(keys, e, hbits) : -1;
        if (k >= 0) atomicAdd(&acc[k], 1);
      }
    }
    for (int s = tid; s < c0; s += kThreads) {
      const int k = hash_find(keys, end_of(g[s], L), hbits);
      if (k >= 0) atomicAdd(&acc[k], 1);
    }

    // ---- this warp's range of whole 32-slot chunks of [c0, c1)
    const int n = c1 - c0;
    const int per = (n + 32 * kWarps - 1) / (32 * kWarps) * 32;
    const int lo = c0 + min(warp * per, n);
    const int hi = min(lo + per, c1);
    // pass 1: the range's reads per end
    for (int s0 = lo; s0 < hi; s0 += 32) {
      const int s = s0 + lane;
      const int e = s < hi ? end_of(g[s], L) : -1;
      const unsigned peers = __match_any_sync(kFull, e);
      if (e >= 0 && (peers & lower) == 0) hw[hash_find(keys, e, hbits)] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // each range's starting rank per end: acc_t plus the earlier ranges
    for (int i = tid; i < H; i += kThreads) {
      int run = acc[i];
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int h = hist[k * H + i];
        hist[k * H + i] = run;
        run += h;
      }
    }
    __syncthreads();
    // pass 2: rank = base + same-end lanes below; the lowest lane of each end
    // moves the base on
    for (int s0 = lo; s0 < hi; s0 += 32) {
      const int s = s0 + lane;
      const int e = s < hi ? end_of(g[s], L) : -1;
      const unsigned peers = __match_any_sync(kFull, e);
      const int k = e >= 0 ? hash_find(keys, e, hbits) : -1;
      if (e >= 0) {
        const int rank = hw[k] + __popc(peers & lower);
        const int64_t gend = w * win + t * B + e;
        const int quota = gend < n_pad ? sel[gend] : 0;
        o[s] = static_cast<int8_t>(rank < quota);
      }
      __syncwarp();
      if (e >= 0 && (peers & lower) == 0) hw[k] += __popc(peers);
      __syncwarp();
    }
    // the next chunk rebuilds the table
    __syncthreads();
  }
}

cudaError_t launch_hash(const int32_t* packed, const int32_t* counts, const int32_t* sel,
                        const int32_t* xwin, int8_t* out, int64_t nbw, int64_t W,
                        int64_t cap, int B, int L, cudaStream_t stream) {
  int hbits = 6;  // H >= 64
  while ((int64_t{1} << hbits) < 2 * std::min<int64_t>(cap, kHashChunk)) ++hbits;
  const size_t smem = sizeof(int32_t) * (2 + kWarps) * (size_t{1} << hbits);
  cudaError_t e = cudaFuncSetAttribute(
      blocked_select_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  blocked_select_hash_kernel<<<(unsigned)(nbw * W), kThreads, smem, stream>>>(
      packed, counts, sel, xwin, out, nbw, W, cap, B, L, hbits);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). L a multiple of 32
// with B * L < 2^31; groups code-sorted (see above). hash = 1 runs the hash
// path at any L; hash = 0 the tile: 32, 64, 128, 256, 384, 512, 640 and 768
// have their own instantiation, any other L the run-time one, refused where
// the tile does not fit shared memory (ops/blocked.py::select_path picks).
extern "C" int gd_blocked_select(
    const void* packed, const void* counts, const void* sel, const void* xwin,
    void* out, int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t L, int64_t hash,
    void* stream) {
  if (nbw < 1 || W < 1 || B < 1 || nbw * W > 2147483647 || L < 32 || L % 32 != 0 ||
      B * L >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  auto p = static_cast<const int32_t*>(packed);
  auto c = static_cast<const int32_t*>(counts);
  auto s = static_cast<const int32_t*>(sel);
  auto x = static_cast<const int32_t*>(xwin);
  auto o = static_cast<int8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int b = (int)B;
  if (hash) return (int)launch_hash(p, c, s, x, o, nbw, W, cap, b, (int)L, st);
#define GD_CASE(LL) \
  case LL:          \
    return (int)launch_l<LL>(p, c, s, x, o, nbw, W, cap, b, st);
  switch (L) {
    GD_CASE(32)
    GD_CASE(64)
    GD_CASE(128)
    GD_CASE(256)
    GD_CASE(384)
    GD_CASE(512)
    GD_CASE(640)
    GD_CASE(768)
    default:  // any other L: at run time, while the tile fits
      if (sizeof(int32_t) * (1 + kWarps) * (B + L) > kMaxSmem) return (int)cudaErrorInvalidValue;
      return (int)launch_l<0>(p, c, s, x, o, nbw, W, cap, b, st, (int)L);
  }
#undef GD_CASE
}
