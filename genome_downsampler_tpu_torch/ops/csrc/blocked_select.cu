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
// Preconditions: packed[t, w, :counts[t, w]] holds the group's codes
// start_rel * L + span - 1 (start_rel < B, span <= L), SORTED ASCENDING,
// equal codes in read-index order, as the packers emit them (io/csrc/
// greedy.cpp, gd_pack_blocked and gd_pack_flat_direct); slots past
// counts[t, w] are ignored and get 0; L a multiple of 32 up to 4096
// (a template parameter for L <= 768, at run time above). Output keeps the (t, w, slot) byte order of the packed
// array.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_slots.cuh"

namespace {

using gd::kFull;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// block-relative end of a code: start_rel + span - 1. L = 0 instantiates
// the kernel for an L known at run time (lrt), divided by the precomputed
// multiply (c * magic) >> 40, magic = 2^40 / lrt + 1: exact (and the
// product within 64 bits) for codes c < 2^40 / lrt, and codes are below
// B * lrt <= 2^20
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

}  // namespace

// Returns the cudaError_t of the launch (0 on success). L a multiple of 32
// up to 4096 (32, 64, 128, 256, 384, 512, 640 and 768 have their own
// instantiation, any other L the run-time one); groups code-sorted (see
// above).
extern "C" int gd_blocked_select(
    const void* packed, const void* counts, const void* sel, const void* xwin,
    void* out, int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t L,
    void* stream) {
  if (nbw < 1 || W < 1 || B < 1 || nbw * W > 2147483647 || B + L > 8192)
    return (int)cudaErrorInvalidValue;
  auto p = static_cast<const int32_t*>(packed);
  auto c = static_cast<const int32_t*>(counts);
  auto s = static_cast<const int32_t*>(sel);
  auto x = static_cast<const int32_t*>(xwin);
  auto o = static_cast<int8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int b = (int)B;
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
    default:  // any other multiple of 32 up to 4096: L at run time
      if (L < 32 || L > 4096 || L % 32 != 0) return (int)cudaErrorInvalidValue;
      return (int)launch_l<0>(p, c, s, x, o, nbw, W, cap, b, st, (int)L);
  }
#undef GD_CASE
}
