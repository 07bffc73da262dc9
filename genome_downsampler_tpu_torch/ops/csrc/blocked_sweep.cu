// Kernel B: one carry-relaxation round of the blocked exact water-filling
// sweep, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_blocked_kernel` driven by
// `blocked_sweep_pass` in genome_downsampler_tpu/ops/pallas_blocked.py.
//
// What it computes. W genome windows are swept independently, each from
// its carry-in, over blocks grid_offset..nbw-1 of B positions. The state
// of one window is the suffix form of the avail ring, F[k] = # unselected
// reads covering the position whose end is k positions ahead or further,
// plus the selected ring selend[k] and, under auto_target, the untaken
// coverage ring Fi. Per position:
//   fold in arrivals (reads starting here with span-1 >= k, suffix form);
//   tgt = auto_target ? min(Fi[0], M) : target[pos];
//   G = F[k+1]; take = clip(tgt - cur - G, 0, F - G); selend += take;
//   taken = min(max(tgt - cur, 0), F[0]); F -= min(taken, F);
//   emit selend[0]; cur += taken - selend[0]; shift every ring by one.
// Carries enter and leave in avail form (avail[k] = F[k] - F[k+1]).
//
// What bounds it on the H100. The step is a chain of ~10 dependent integer
// ops per position (two warp broadcasts, one neighbour shuffle, the shift
// shuffles), and positions are strictly sequential within a window:
// config-4 is 156,288 positions per window per round, times the rounds.
// Memory traffic is tiny (each read code is read once per round). The
// kernel is latency-bound, and with one CTA per window and W <= 64 it
// occupies at most 64 of the 132 SMs; re-deriving W and B for Hopper is
// later work.
//
// What the design does about it. One warp per window and no block-wide
// barriers: lane l owns the S = L/32 consecutive ring slots l*S..l*S+S-1
// in registers, so F[k+1] is a register move except at the lane edge (one
// __shfl_down), F[0] and selend[0] are one __shfl each, and the per-step
// shift is a register move plus one shuffle per ring. The TPU's one-hot
// MXU tile build is gone: the packer writes each (block, window) group
// code-sorted (start-major), so the reads that start at position b are the
// next run of the group; every lane walks that run from shared memory
// (broadcast reads) and counts span-1 >= k for its own slots.
//
// Preconditions (the packer's layout): packed[t, w, :counts[t, w]] holds
// the group's codes start_rel * L + span - 1 in ascending order, with
// span - 1 <= L - 2 (lane L-1 is reserved for the target in the TPU
// kernel); slots past counts[t, w] are ignored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCodeChunk = 1024;  // group codes staged in shared memory

template <int S, bool AUTO>
__global__ void __launch_bounds__(32) blocked_sweep_kernel(
    const int32_t* __restrict__ counts,   // [nbw, W]
    const int32_t* __restrict__ packed,   // [nbw, W, cap]
    const int32_t* __restrict__ target,   // [W, nbw * B], unused if AUTO
    const int32_t* __restrict__ avail0,   // [W, L]
    const int32_t* __restrict__ selend0,  // [W, L]
    const int32_t* __restrict__ avail0i,  // [W, L]
    int32_t* __restrict__ out,            // [W, (nbw - grid_offset) * B]
    int32_t* __restrict__ availf,         // [W, L]
    int32_t* __restrict__ selendf,        // [W, L]
    int32_t* __restrict__ availfi,        // [W, L]
    int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t grid_offset,
    int32_t max_coverage) {
  constexpr int L = 32 * S;
  // register slot j+1, clamped so the index stays in range where the
  // caller takes the neighbour lane's value instead (j = S - 1)
  auto nxt_slot = [](int j) { return j + 1 < S ? j + 1 : S - 1; };
  __shared__ int32_t codes_s[kCodeChunk];
  __shared__ int32_t tgt_s[256];

  const int64_t w = blockIdx.x;
  const int lane = threadIdx.x;
  const int k0 = lane * S;
  const int64_t ngrid = nbw - grid_offset;

  // ---- carries in: avail form -> suffix form; cur = sum(selend) is the
  // count of selected reads covering the position (warp-uniform)
  int F[S], Fi[S], Se[S];
  int cur = 0;
  {
    int tot = 0, toti = 0;
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
      tot += avail0[w * L + k0 + j];
      F[j] = tot;
      toti += avail0i[w * L + k0 + j];
      Fi[j] = toti;
      Se[j] = selend0[w * L + k0 + j];
      cur += Se[j];
    }
    // inclusive suffix sum over lanes >= lane
    int inc = tot, inci = toti;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int v = __shfl_down_sync(kFull, inc, o);
      int vi = __shfl_down_sync(kFull, inci, o);
      if (lane + o < 32) {
        inc += v;
        inci += vi;
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      F[j] += inc - tot;
      Fi[j] += inci - toti;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cur += __shfl_xor_sync(kFull, cur, o);
  }

  for (int64_t t = grid_offset; t < nbw; ++t) {
    const int cnt = counts[t * W + w];
    const int32_t* __restrict__ g = packed + (t * W + w) * cap;
    __syncwarp();
    int base = 0;
    for (int i = lane; i < kCodeChunk && i < cnt; i += 32) codes_s[i] = g[i];
    if (!AUTO) {
      for (int i = lane; i < B; i += 32) tgt_s[i] = target[w * nbw * B + t * B + i];
    }
    __syncwarp();
    int ptr = 0;
    int32_t* __restrict__ o = out + w * ngrid * B + (t - grid_offset) * B;
    for (int b = 0; b < B; ++b) {
      // ---- arrivals: the run of codes with start_rel == b
      int add[S];
#pragma unroll
      for (int j = 0; j < S; ++j) add[j] = 0;
      while (ptr < cnt) {
        if (ptr - base == kCodeChunk) {  // warp-uniform: refill the stage
          __syncwarp();
          base = ptr;
          for (int i = lane; i < kCodeChunk && base + i < cnt; i += 32)
            codes_s[i] = g[base + i];
          __syncwarp();
        }
        const int c = codes_s[ptr - base];
        if (c / L != b) break;
        const int sp = c % L;
#pragma unroll
        for (int j = 0; j < S; ++j) add[j] += (sp >= k0 + j);
        ++ptr;
      }
      // ---- one sweep step
      int tgt;
#pragma unroll
      for (int j = 0; j < S; ++j) F[j] += add[j];
      if (AUTO) {
#pragma unroll
        for (int j = 0; j < S; ++j) Fi[j] += add[j];
        tgt = min(__shfl_sync(kFull, Fi[0], 0), max_coverage);
      } else {
        tgt = tgt_s[b];
      }
      int nxt = __shfl_down_sync(kFull, F[0], 1);
      if (lane == 31) nxt = 0;
      const int F0 = __shfl_sync(kFull, F[0], 0);
      const int deficit = tgt - cur;
      const int taken = min(max(deficit, 0), F0);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int G = (j + 1 < S) ? F[nxt_slot(j)] : nxt;
        Se[j] += min(max(deficit - G, 0), F[j] - G);
      }
#pragma unroll
      for (int j = 0; j < S; ++j) F[j] -= min(taken, F[j]);
      const int em = __shfl_sync(kFull, Se[0], 0);
      if (lane == 0) o[b] = em;
      cur += taken - em;
      // ---- shift every ring one slot toward k = 0
      int f_in = __shfl_down_sync(kFull, F[0], 1);
      int s_in = __shfl_down_sync(kFull, Se[0], 1);
      int i_in = AUTO ? __shfl_down_sync(kFull, Fi[0], 1) : 0;
      if (lane == 31) f_in = s_in = i_in = 0;
#pragma unroll
      for (int j = 0; j < S - 1; ++j) {
        F[j] = F[j + 1];
        Se[j] = Se[j + 1];
        if (AUTO) Fi[j] = Fi[j + 1];
      }
      F[S - 1] = f_in;
      Se[S - 1] = s_in;
      if (AUTO) Fi[S - 1] = i_in;
    }
  }

  // ---- carries out: suffix form -> avail form
  int nf = __shfl_down_sync(kFull, F[0], 1);
  int ni = __shfl_down_sync(kFull, Fi[0], 1);
  if (lane == 31) nf = ni = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int gf = (j + 1 < S) ? F[nxt_slot(j)] : nf;
    const int gi = (j + 1 < S) ? Fi[nxt_slot(j)] : ni;
    availf[w * L + k0 + j] = F[j] - gf;
    availfi[w * L + k0 + j] = Fi[j] - gi;
    selendf[w * L + k0 + j] = Se[j];
  }
}

template <int S>
cudaError_t launch_s(const int32_t* counts, const int32_t* packed,
                     const int32_t* target, const int32_t* avail0,
                     const int32_t* selend0, const int32_t* avail0i,
                     int32_t* out, int32_t* availf, int32_t* selendf,
                     int32_t* availfi, int64_t nbw, int64_t W, int64_t cap,
                     int64_t B, int64_t grid_offset, bool auto_target,
                     int32_t max_coverage, cudaStream_t stream) {
  if (auto_target) {
    blocked_sweep_kernel<S, true><<<(unsigned)W, 32, 0, stream>>>(
        counts, packed, target, avail0, selend0, avail0i, out, availf,
        selendf, availfi, nbw, W, cap, B, grid_offset, max_coverage);
  } else {
    blocked_sweep_kernel<S, false><<<(unsigned)W, 32, 0, stream>>>(
        counts, packed, target, avail0, selend0, avail0i, out, availf,
        selendf, availfi, nbw, W, cap, B, grid_offset, max_coverage);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* gd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns the cudaError_t of the launch (0 on success). L must be one of
// 32, 64, 128, 256, 384, 512, 640, 768 and B at most 256.
extern "C" int gd_blocked_sweep(
    const void* counts, const void* packed, const void* target,
    const void* avail0, const void* selend0, const void* avail0i, void* out,
    void* availf, void* selendf, void* availfi, int64_t nbw, int64_t W,
    int64_t cap, int64_t B, int64_t L, int64_t grid_offset,
    int64_t auto_target, int64_t max_coverage, void* stream) {
  if (B > 256 || B < 1 || W < 1 || grid_offset < 0 || grid_offset >= nbw)
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
  const bool at = auto_target != 0;
  const int32_t m = (int32_t)max_coverage;
#define GD_CASE(SS)                                                         \
  case 32 * SS:                                                             \
    return (int)launch_s<SS>(c, p, tg, a0, s0, i0, o, af, sf, fi, nbw, W,   \
                             cap, B, grid_offset, at, m, st);
  switch (L) {
    GD_CASE(1)
    GD_CASE(2)
    GD_CASE(4)
    GD_CASE(8)
    GD_CASE(12)
    GD_CASE(16)
    GD_CASE(20)
    GD_CASE(24)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GD_CASE
}
