// Kernel C: per-slot selection bytes of the blocked exact-MCP solve, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_recon_kernel` driven by
// `blocked_selection_pass` in genome_downsampler_tpu/ops/pallas_blocked.py.
//
// What it computes. The sweep emits sel[e], the number of selected reads
// that end at genome position e. Within an end bucket the reads are taken
// in (start, read index) order, so a packed read is selected iff its rank
// in its bucket is below sel[end]. The rank of a read in block t of window
// w decomposes as
//   xwin[w, e']                reads of earlier windows ending here,
// + acc[e']                    reads of earlier blocks of this window
//                              ending here (a ring over B + L ends,
//                              shifted by B per block),
// + #{slots j of this group: same end, smaller start, or same start and
//    j before this slot}       (groups list equal codes in index order),
// with e' = end - t*B the block-relative end. sel is read straight at the
// global end, so an end past the window runs into window w+1's head (the
// halo of the TPU kernel) and an end past the genome reads 0.
//
// What bounds it on the H100. The within-group rank is an all-pairs count,
// O(cap^2) per group (cap ~ 256-512 at config-4 coverage), done by 256
// threads from a shared-memory tile of the group's codes; the rest is one
// read of each code and one byte written per slot. The kernel runs once
// per solve and the blocks of a window are sequential (the ring), so one
// CTA per window again occupies at most W SMs.
//
// What the design does about it. One CTA per window walks its blocks in
// order with the ring accumulator in shared memory, so nothing crosses
// CTAs. The all-pairs count reads codes from shared memory (broadcast);
// a sorted-run rank (O(cap)) is the obvious next step.
//
// Output keeps the (t, w, slot) byte order of the packed array; padding
// slots get 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // codes per shared-memory tile

__global__ void __launch_bounds__(kThreads) blocked_select_kernel(
    const int32_t* __restrict__ packed,  // [nbw, W, cap]
    const int32_t* __restrict__ counts,  // [nbw, W]
    const int32_t* __restrict__ sel,     // [W * nbw * B]
    const int32_t* __restrict__ xwin,    // [W, B + L]
    int8_t* __restrict__ out,            // [nbw, W, cap]
    int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t L) {
  extern __shared__ int32_t smem[];
  const int64_t lring = B + L;
  int32_t* acc = smem;              // [B + L]
  int32_t* acc2 = smem + lring;     // [B + L]
  int32_t* tile = smem + 2 * lring; // [kTile]

  const int64_t w = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t win = nbw * B;
  const int64_t n_pad = W * win;

  for (int64_t e = tid; e < lring; e += kThreads) acc[e] = xwin[w * lring + e];
  __syncthreads();

  for (int64_t t = 0; t < nbw; ++t) {
    const int cnt = counts[t * W + w];
    const int32_t* __restrict__ g = packed + (t * W + w) * cap;
    int8_t* __restrict__ o = out + (t * W + w) * cap;
    for (int64_t s = cnt + tid; s < cap; s += kThreads) o[s] = 0;

    for (int s0 = 0; s0 < cnt; s0 += kThreads) {
      const int s = s0 + tid;
      const bool valid = s < cnt;
      const int c = valid ? g[s] : 0;
      const int sr = c / (int)L;
      const int er = sr + c % (int)L;
      int rank = 0;
      for (int j0 = 0; j0 < cnt; j0 += kTile) {
        const int nj = min(kTile, cnt - j0);
        __syncthreads();
        for (int i = tid; i < nj; i += kThreads) tile[i] = g[j0 + i];
        __syncthreads();
        if (valid) {
          for (int i = 0; i < nj; ++i) {
            const int c2 = tile[i];
            const int sr2 = c2 / (int)L;
            const int er2 = sr2 + c2 % (int)L;
            rank += (er2 == er) & ((sr2 < sr) | ((sr2 == sr) & (j0 + i < s)));
          }
        }
      }
      if (valid) {
        const int64_t gend = w * win + t * B + er;
        const int quota = gend < n_pad ? sel[gend] : 0;
        o[s] = (int8_t)(rank + acc[er] < quota);
      }
    }
    __syncthreads();
    // this block's reads join the ring, which then moves to block t+1
    for (int s = tid; s < cnt; s += kThreads) {
      const int c = g[s];
      atomicAdd(&acc[c / (int)L + c % (int)L], 1);
    }
    __syncthreads();
    for (int64_t e = tid; e < lring; e += kThreads)
      acc2[e] = e + B < lring ? acc[e + B] : 0;
    __syncthreads();
    int32_t* tmp = acc;
    acc = acc2;
    acc2 = tmp;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int gd_blocked_select(
    const void* packed, const void* counts, const void* sel, const void* xwin,
    void* out, int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t L,
    void* stream) {
  if (nbw < 1 || W < 1 || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (B + L) + kTile) * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  blocked_select_kernel<<<(unsigned)W, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(sel), static_cast<const int32_t*>(xwin),
      static_cast<int8_t*>(out), nbw, W, cap, B, L);
  return (int)cudaGetLastError();
}
