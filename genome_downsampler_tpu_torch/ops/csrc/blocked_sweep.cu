// Kernel B: one carry-relaxation round of the blocked exact water-filling
// sweep, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_blocked_kernel`
// (genome_downsampler_tpu/ops/pallas_blocked.py:383), driven by its
// `blocked_sweep_pass`.
//
// What it computes. W genome windows are swept independently, each from
// its carry-in, over blocks grid_offset..nbw-1 of B positions. The state
// of one window is the suffix form of the avail ring, F[k] = # unselected
// reads covering the position whose end is k positions ahead or further,
// and the selected ring selend[k]. Per position:
//   fold in arrivals (reads starting here with span-1 >= k, suffix form);
//   tgt = auto_target ? min(coverage, M) : target[pos];
//   G = F[k+1]; take = clip(tgt - cur - G, 0, F - G); selend += take;
//   taken = min(max(tgt - cur, 0), F[0]); F -= min(taken, F);
//   emit selend[0]; cur += taken - selend[0]; shift both rings by one.
// Carries enter and leave in avail form (avail[k] = F[k] - F[k+1]); the
// third carry, availi, is the untaken ring: the coverage carried across
// the window edge.
//
// What bounds it on the H100. Positions are strictly sequential within a
// window, so the time is one warp's loop-carried chain per position: the
// state's dependent integer ops and warp shuffles (F[0] and selend[0]
// broadcasts, the F[k+1] neighbour, the two shift shuffles), times the
// positions (156,288 a window per round at config-4), times the rounds.
// The bytes are tiny (each code read once a round), and so are the
// operations (8 int ops per slot per position), so it is bound by the
// latency of that chain, and by W of the 132 SMs, since windows are the
// only parallel axis (W = 32 at config-4).
//
// What the design does about it. Everything that does not depend on the
// sweep's state leaves the chain. One CTA per window, warp-specialised:
// warp 0 sweeps; warps 1-3 (the producers) prepare the next chunk of up to
// P positions while warp 0 sweeps the current one, into a double buffer of
// dynamic shared memory, handed over by named barriers (FULL: producers ->
// sweep warp, EMPTY: sweep warp -> producers). Per chunk the producers
//   - scatter the block's codes (read with coalesced loads, hidden behind
//     the sweep of the previous chunk) into a uint16 (P, L) arrival tile,
//     with 32-bit shared atomics on packed 16-bit counters, and suffix-sum
//     each row over k: tile[b][k] = reads starting at b with span-1 >= k
//     (exact in uint16 while at most 65535 reads start at one position);
//   - under auto_target, compute the chunk's targets min(coverage, M) by a
//     scan of starts minus ends: ends are scattered into a ring of R >=
//     P + L + 1 positions, seeded with the availi carry-in, and the ring
//     left after the last chunk is the availi carry-out;
//     otherwise copy the chunk's targets;
//   - flush the sweep warp's emitted counts of a finished chunk to `out`
//     with coalesced stores.
// Lane l of warp 0 owns the S = L/32 consecutive ring slots l*S..l*S+S-1
// in registers, and per position reads its S slots of the tile
// row (one to three shared loads of 4-16 bytes) and the target, issued one
// position ahead, runs the step (gd::sweep_step in warp_slots.cuh, shared
// with kernel A), and writes selend[0] to a shared buffer from every lane
// (same address, same value: no branch, no global address). No walk of the
// codes, no third ring and no divergent store stays on the chain. Chunks
// are cut by positions within a block, P = 128 for L <= 384 and 64 above,
// so that two uint16 tiles (192 KB at L = 768) fit the block's shared memory.
//
// Preconditions (the packer's layout): packed[t, w, :counts[t, w]] holds
// the group's codes start_rel * L + span - 1 with start_rel < B; slots past
// counts[t, w] are ignored; counts[t, w] <= cap; at most 65535 reads of a
// window start at one position (the wrapper checks).

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
// named barriers (0 is __syncthreads): FULL and EMPTY per buffer, and one
// among the producers
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;
constexpr int kBarProducers = 5;

// this lane's S 16-bit slots of a tile row (shared -> registers); p is the
// lane's first slot
template <int S>
__device__ __forceinline__ void load_row16(const uint16_t* p, int (&a)[S]) {
  if constexpr (S == 1) {
    a[0] = p[0];
  } else {
    uint32_t wd[S / 2];
    if constexpr (S % 8 == 0) {
#pragma unroll
      for (int i = 0; i < S / 8; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        wd[4 * i] = v.x;
        wd[4 * i + 1] = v.y;
        wd[4 * i + 2] = v.z;
        wd[4 * i + 3] = v.w;
      }
    } else if constexpr (S % 4 == 0) {
#pragma unroll
      for (int i = 0; i < S / 4; ++i) {
        const uint2 v = reinterpret_cast<const uint2*>(p)[i];
        wd[2 * i] = v.x;
        wd[2 * i + 1] = v.y;
      }
    } else {
      static_assert(S == 2, "S must be 1, 2 or a multiple of 4");
      wd[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < S / 2; ++i) {
      a[2 * i] = static_cast<int>(wd[i] & 0xffffu);
      a[2 * i + 1] = static_cast<int>(wd[i] >> 16);
    }
  }
}

// registers -> this lane's S 16-bit slots of a tile row (values <= 65535)
template <int S>
__device__ __forceinline__ void store_row16(uint16_t* p, const int (&a)[S]) {
  if constexpr (S == 1) {
    p[0] = static_cast<uint16_t>(a[0]);
  } else {
    uint32_t wd[S / 2];
#pragma unroll
    for (int i = 0; i < S / 2; ++i)
      wd[i] = static_cast<uint32_t>(a[2 * i]) |
              (static_cast<uint32_t>(a[2 * i + 1]) << 16);
    if constexpr (S % 8 == 0) {
#pragma unroll
      for (int i = 0; i < S / 8; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(wd[4 * i], wd[4 * i + 1], wd[4 * i + 2], wd[4 * i + 3]);
    } else if constexpr (S % 4 == 0) {
#pragma unroll
      for (int i = 0; i < S / 4; ++i)
        reinterpret_cast<uint2*>(p)[i] = make_uint2(wd[2 * i], wd[2 * i + 1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = wd[0];
    }
  }
}

// The chunking of one window's sweep: chunk c is positions b0..b0+len-1
// of block grid_offset + c / cpb; q0 is its first position in the sweep.
struct Chunk {
  int64_t t_rel, q0;
  int b0, len;
  __device__ Chunk(int64_t c, int B, int P, int cpb) {
    t_rel = c / cpb;
    b0 = static_cast<int>(c - t_rel * cpb) * P;
    len = min(P, B - b0);
    q0 = t_rel * B + b0;
  }
};

// warp 0: the sweep over every chunk, from the carries in to the carries out
template <int S>
__device__ __forceinline__ void sweep_warp(
    const uint16_t* tile, const int32_t* tgt_s, int32_t* out_s,
    const int32_t* __restrict__ avail0, const int32_t* __restrict__ selend0,
    int32_t* __restrict__ availf, int32_t* __restrict__ selendf, int64_t w,
    int lane, int B, int P, int cpb, int64_t nchunks) {
  constexpr int L = 32 * S;
  const int k0 = lane * S;

  // ---- carries in: avail form -> suffix form; cur = sum(selend) is the
  // count of selected reads covering the position (warp-uniform)
  int F[S], Se[S];
  int cur = 0;
  {
    int tot = 0;
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
      tot += avail0[w * L + k0 + j];
      F[j] = tot;
      Se[j] = selend0[w * L + k0 + j];
      cur += Se[j];
    }
    int inc = tot;  // inclusive suffix sum over lanes >= lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_down_sync(kFull, inc, o);
      if (lane + o < 32) inc += v;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) F[j] += inc - tot;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cur += __shfl_xor_sync(kFull, cur, o);
  }

#pragma unroll 1
  for (int64_t c = 0; c < nchunks; ++c) {
    const int buf = static_cast<int>(c & 1);
    const int len = Chunk(c, B, P, cpb).len;
    bar_sync(kBarFull + buf, kThreads);
    const uint16_t* rows = tile + buf * P * L + k0;
    const int32_t* tg = tgt_s + buf * P;
    int32_t* em_s = out_s + buf * P;
    int add[S];
    load_row16<S>(rows, add);
    int tgt = tg[0];
#pragma unroll 1
    for (int b = 0; b < len; ++b) {
      // the next position's arrivals and target: off the state
      const int bn = b + 1 < len ? b + 1 : b;
      int nadd[S];
      load_row16<S>(rows + bn * L, nadd);
      const int ntgt = tg[bn];
      int tk[S];  // unused: the compiler drops it
      // every lane: one address, one value
      em_s[b] = gd::sweep_step<S>(F, Se, add, tgt, cur, lane, tk);
      gd::shift_down<S>(F, Se, lane);
#pragma unroll
      for (int j = 0; j < S; ++j) add[j] = nadd[j];
      tgt = ntgt;
    }
    bar_arrive(kBarEmpty + buf, kThreads);
  }

  // ---- carries out: suffix form -> avail form
  int nf = __shfl_down_sync(kFull, F[0], 1);
  if (lane == 31) nf = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int gf = (j + 1 < S) ? F[gd::next_slot(j, S)] : nf;
    availf[w * L + k0 + j] = F[j] - gf;
    selendf[w * L + k0 + j] = Se[j];
  }
}

// warps 1..kProducerWarps: tiles, targets and the output of every chunk
template <int S, bool AUTO>
__device__ __forceinline__ void produce(
    uint16_t* tile, int32_t* tgt_s, int32_t* out_s, int32_t* ring,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ packed,
    const int32_t* __restrict__ target, const int32_t* __restrict__ avail0i,
    int32_t* __restrict__ out, int32_t* __restrict__ availfi, int64_t w,
    int64_t nbw, int64_t W, int64_t cap, int B, int P, int R, int cpb,
    int64_t nchunks, int64_t grid_offset, int32_t max_coverage) {
  constexpr int L = 32 * S;
  const int pt = threadIdx.x - 32;  // 0..kProducers-1
  const int pw = pt >> 5;           // producer warp
  const int lane = pt & 31;
  const int64_t npos = (nbw - grid_offset) * B;
  int32_t* const o = out + w * npos;

  auto flush = [&](int64_t c) {  // chunk c's emitted counts -> out
    const Chunk ch(c, B, P, cpb);
    const int32_t* src = out_s + (c & 1) * P;
    for (int i = pt; i < ch.len; i += kProducers) o[ch.q0 + i] = src[i];
  };

  // ---- carry in of the untaken ring: coverage ends (ring[q] = reads
  // whose last covered position is q - 1) and the coverage before the
  // first position (warp 0 of the producers keeps it)
  int run = 0;
  if (AUTO) {
    for (int i = pt; i < R; i += kProducers) ring[i] = 0;
    bar_sync(kBarProducers, kProducers);
    for (int k = pt; k < L; k += kProducers) ring[k + 1] = avail0i[w * L + k];
    if (pw == 0) {
      for (int k = lane; k < L; k += 32) run += avail0i[w * L + k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        run += __shfl_xor_sync(kFull, run, off);
    }
  } else {
    for (int k = pt; k < L; k += kProducers)
      availfi[w * L + k] = avail0i[w * L + k];
  }

#pragma unroll 1
  for (int64_t c = 0; c < nchunks; ++c) {
    const int buf = static_cast<int>(c & 1);
    const Chunk ch(c, B, P, cpb);
    const int64_t t = grid_offset + ch.t_rel;
    uint16_t* tb = tile + buf * P * L;
    if (c >= 2) {  // chunk c - 2 left this buffer
      bar_sync(kBarEmpty + buf, kThreads);
      flush(c - 2);
    }
    // ---- the arrival tile: zero, scatter, suffix-sum over k
    uint4* t4 = reinterpret_cast<uint4*>(tb);
    for (int i = pt; i < ch.len * L / 8; i += kProducers)
      t4[i] = make_uint4(0, 0, 0, 0);
    bar_sync(kBarProducers, kProducers);
    {
      const int cnt = counts[t * W + w];
      const int32_t* __restrict__ g = packed + (t * W + w) * cap;
      uint32_t* t32 = reinterpret_cast<uint32_t*>(tb);
      for (int i = pt; i < cnt; i += kProducers) {
        const int code = g[i];
        const int sr = code / L;
        const int sp = code - sr * L;
        const int b = sr - ch.b0;
        if (b >= 0 && b < ch.len) {
          const int e = b * L + sp;
          atomicAdd(&t32[e >> 1], 1u << ((e & 1) * 16));
          if (AUTO) atomicAdd(&ring[(ch.q0 + b + sp + 1) & (R - 1)], 1);
        }
      }
    }
    bar_sync(kBarProducers, kProducers);
    for (int b = pw; b < ch.len; b += kProducerWarps) {
      uint16_t* row = tb + b * L + lane * S;
      int a[S];
      load_row16<S>(row, a);
      int tot = 0;
#pragma unroll
      for (int j = S - 1; j >= 0; --j) {
        tot += a[j];
        a[j] = tot;
      }
      int inc = tot;  // inclusive suffix sum over lanes >= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_down_sync(kFull, inc, off);
        if (lane + off < 32) inc += v;
      }
#pragma unroll
      for (int j = 0; j < S; ++j) a[j] += inc - tot;
      store_row16<S>(row, a);
    }
    bar_sync(kBarProducers, kProducers);
    // ---- the chunk's targets
    int32_t* tg = tgt_s + buf * P;
    if (AUTO) {
      if (pw == 0) {
        // coverage[q] = coverage[q-1] + starts[q] - ends[q]; the ring
        // slots of the chunk's positions are read, then cleared for reuse
        for (int i0 = 0; i0 < ch.len; i0 += 32) {
          const int i = i0 + lane;
          int v = 0;
          if (i < ch.len) {
            const int slot = static_cast<int>((ch.q0 + i) & (R - 1));
            v = static_cast<int>(tb[i * L]) - ring[slot];
            ring[slot] = 0;
          }
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(kFull, v, off);
            if (lane >= off) v += u;
          }
          if (i < ch.len) tg[i] = min(run + v, max_coverage);
          run += __shfl_sync(kFull, v, 31);
        }
      }
    } else {
      const int32_t* src = target + w * nbw * B + t * B + ch.b0;
      for (int i = pt; i < ch.len; i += kProducers) tg[i] = src[i];
    }
    bar_arrive(kBarFull + buf, kThreads);
  }

  // ---- the last chunks' output, and the untaken ring's carry out: the
  // reads still covering, by the position after the sweep where they end
  for (int64_t c = nchunks > 2 ? nchunks - 2 : 0; c < nchunks; ++c) {
    bar_sync(kBarEmpty + static_cast<int>(c & 1), kThreads);
    flush(c);
  }
  if (AUTO) {
    bar_sync(kBarProducers, kProducers);
    for (int k = pt; k < L; k += kProducers)
      availfi[w * L + k] = ring[(npos + 1 + k) & (R - 1)];
  }
}

template <int S, bool AUTO>
__global__ void __launch_bounds__(kThreads) blocked_sweep_kernel(
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
    int64_t nbw, int64_t W, int64_t cap, int B, int P, int R,
    int64_t grid_offset, int32_t max_coverage) {
  constexpr int L = 32 * S;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);            // [2][P][L]
  int32_t* tgt_s = reinterpret_cast<int32_t*>(tile + 2 * P * L);  // [2][P]
  int32_t* out_s = tgt_s + 2 * P;                                 // [2][P]
  int32_t* ring = out_s + 2 * P;                                  // [R]

  const int64_t w = blockIdx.x;
  const int cpb = (B + P - 1) / P;
  const int64_t nchunks = (nbw - grid_offset) * cpb;
  if (threadIdx.x < 32) {
    sweep_warp<S>(tile, tgt_s, out_s, avail0, selend0, availf, selendf, w,
                  threadIdx.x, B, P, cpb, nchunks);
  } else {
    produce<S, AUTO>(tile, tgt_s, out_s, ring, counts, packed, target,
                     avail0i, out, availfi, w, nbw, W, cap, B, P, R, cpb,
                     nchunks, grid_offset, max_coverage);
  }
}

template <int S, bool AUTO>
cudaError_t launch_mode(const int32_t* counts, const int32_t* packed,
                        const int32_t* target, const int32_t* avail0,
                        const int32_t* selend0, const int32_t* avail0i,
                        int32_t* out, int32_t* availf, int32_t* selendf,
                        int32_t* availfi, int64_t nbw, int64_t W, int64_t cap,
                        int B, int64_t grid_offset, int32_t max_coverage,
                        cudaStream_t stream) {
  constexpr int L = 32 * S;
  // positions per chunk: two uint16 (P, L) tiles within the shared memory
  const int pmax = L <= 384 ? 128 : 64;
  const int P = B < pmax ? B : pmax;
  int R = 1;
  while (R < P + L + 1) R <<= 1;
  const size_t smem = sizeof(uint16_t) * 2 * P * L + sizeof(int32_t) * (4 * P + R);
  auto kernel = blocked_sweep_kernel<S, AUTO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)W, kThreads, smem, stream>>>(
      counts, packed, target, avail0, selend0, avail0i, out, availf, selendf,
      availfi, nbw, W, cap, B, P, R, grid_offset, max_coverage);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_s(const int32_t* counts, const int32_t* packed,
                     const int32_t* target, const int32_t* avail0,
                     const int32_t* selend0, const int32_t* avail0i,
                     int32_t* out, int32_t* availf, int32_t* selendf,
                     int32_t* availfi, int64_t nbw, int64_t W, int64_t cap,
                     int B, int64_t grid_offset, bool auto_target,
                     int32_t max_coverage, cudaStream_t stream) {
  if (auto_target)
    return launch_mode<S, true>(counts, packed, target, avail0, selend0,
                                avail0i, out, availf, selendf, availfi, nbw,
                                W, cap, B, grid_offset, max_coverage, stream);
  return launch_mode<S, false>(counts, packed, target, avail0, selend0,
                               avail0i, out, availf, selendf, availfi, nbw, W,
                               cap, B, grid_offset, max_coverage, stream);
}

}  // namespace

extern "C" const char* gd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns the cudaError_t of the launch (0 on success). L must be one of
// 32, 64, 128, 256, 384, 512, 640, 768 and B at most 256; at most 65535
// reads of a window may start at one position (the counts are uint16).
extern "C" int gd_blocked_sweep(
    const void* counts, const void* packed, const void* target,
    const void* avail0, const void* selend0, const void* avail0i, void* out,
    void* availf, void* selendf, void* availfi, int64_t nbw, int64_t W,
    int64_t cap, int64_t B, int64_t L, int64_t grid_offset,
    int64_t auto_target, int64_t max_coverage, void* stream) {
  if (B > 256 || B < 1 || W < 1 || grid_offset < 0 || grid_offset >= nbw ||
      cap < 0)
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
  const int b = (int)B;
#define GD_CASE(SS)                                                         \
  case 32 * SS:                                                             \
    return (int)launch_s<SS>(c, p, tg, a0, s0, i0, o, af, sf, fi, nbw, W,   \
                             cap, b, grid_offset, at, m, st);
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
