// Kernel B's wide path: one carry-relaxation round of the blocked exact
// water-filling sweep for the inputs kernel B's register path
// (blocked_sweep.cu) does not take, for NVIDIA Hopper (sm_90a):
//   - long reads: any L = 32 * S up to 4096 (the register path takes
//     L <= 768: a lane's S ring slots no longer fit in registers above);
//   - deep stacks: more than 65,535 reads of a window starting at one
//     position (the register path keeps arrival counts in uint16).
//
// Replaces, with blocked_sweep.cu, the Pallas kernel `_blocked_kernel`
// (genome_downsampler_tpu/ops/pallas_blocked.py:383); it computes what
// blocked_sweep.cu computes (see there), bit for bit, from the same
// arguments.
//
// What bounds it. As kernel B's register path: one warp's chain per
// position, times the positions. Here the chain runs over shared memory:
// per position each lane reads and writes its S slots of the two rings
// three times, separated by __syncwarp, so a position costs O(S) shared
// accesses a lane instead of O(1) registers and shuffles.
//
// What the design does. Kernel B's warp specialisation, unchanged: warp 0
// sweeps, warps 1-3 build the next chunk's suffix-form arrival tile, its
// targets and the availi carry, and flush the emitted counts; FULL and
// EMPTY named barriers per buffer. The difference is the state: the avail
// (suffix form F) and selend rings live in shared memory as circular
// arrays, slot k of the ring at (h + k) mod L, so the shift is h += 1 and
// one cleared slot. Lane l owns the slots l, l + 32, ... (no bank
// conflicts). The tile's cell type T is uint16 (packed 32-bit atomics, as
// kernel B) or int32 (any count); the chunk P is the largest power of two
// up to 128 positions whose two (P, L) tiles, the rings and the availi ring
// fit the 227 KB a CTA may have (P = 8 at L = 4096 in uint16, 4 in int32).
//
// Preconditions: as blocked_sweep.cu; L a multiple of 32 up to 4096; with
// the uint16 tile, at most 65535 reads of a window start at one position.

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
constexpr int kMaxSpan = 4096;
constexpr size_t kMaxSmem = 232448;  // the most a CTA may have on sm_90

// one more read starting at row cell e of a tile
__device__ __forceinline__ void tile_add(uint16_t* tile, int e) {
  atomicAdd(reinterpret_cast<uint32_t*>(tile) + (e >> 1), 1u << ((e & 1) * 16));
}
__device__ __forceinline__ void tile_add(int32_t* tile, int e) { atomicAdd(tile + e, 1); }

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

// the ring position of slot k (0 <= k < 2L) when slot 0 is at h
__device__ __forceinline__ int phys(int k, int h, int L) {
  const int p = k + h;
  return p >= L ? p - L : p;
}

// warp 0: the sweep over every chunk, rings in shared memory
template <class T>
__device__ void sweep_warp(const T* tile, const int32_t* tgt_s, int32_t* out_s,
                           int32_t* F, int32_t* Se,
                           const int32_t* __restrict__ avail0,
                           const int32_t* __restrict__ selend0,
                           int32_t* __restrict__ availf, int32_t* __restrict__ selendf,
                           int64_t w, int lane, int L, int B, int P, int cpb,
                           int64_t nchunks) {
  // ---- carries in: avail form -> suffix form, 32 slots at a time from the
  // top; cur = sum(selend)
  int run = 0, cur = 0;
  for (int k0 = L - 32; k0 >= 0; k0 -= 32) {
    int v = avail0[w * L + k0 + lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_down_sync(kFull, v, o);
      if (lane + o < 32) v += u;
    }
    v += run;
    F[k0 + lane] = v;
    run = __shfl_sync(kFull, v, 0);
    const int se = selend0[w * L + k0 + lane];
    Se[k0 + lane] = se;
    cur += se;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cur += __shfl_xor_sync(kFull, cur, o);
  __syncwarp();

  int h = 0;
#pragma unroll 1
  for (int64_t c = 0; c < nchunks; ++c) {
    const int buf = static_cast<int>(c & 1);
    const int len = Chunk(c, B, P, cpb).len;
    bar_sync(kBarFull + buf, kThreads);
    const T* rows = tile + static_cast<size_t>(buf) * P * L;
    const int32_t* tg = tgt_s + buf * P;
    int32_t* em_s = out_s + buf * P;
#pragma unroll 1
    for (int b = 0; b < len; ++b) {
      const T* row = rows + static_cast<size_t>(b) * L;
      // fold in the arrivals (suffix form)
      for (int k = lane; k < L; k += 32) F[phys(k, h, L)] += static_cast<int>(row[k]);
      __syncwarp();
      const int deficit = tg[b] - cur;
      const int taken = min(max(deficit, 0), F[h]);
      // take[k] = clip(deficit - F[k+1], 0, F[k] - F[k+1]) into selend
      for (int k = lane; k < L; k += 32) {
        const int p = phys(k, h, L);
        const int G = k + 1 < L ? F[phys(k + 1, h, L)] : 0;
        Se[p] += min(max(deficit - G, 0), F[p] - G);
      }
      __syncwarp();
      const int em = Se[h];
      for (int k = lane; k < L; k += 32) {
        const int p = phys(k, h, L);
        F[p] -= min(taken, F[p]);
      }
      __syncwarp();
      // emit selend[0]; shift both rings: slot 0 leaves and becomes the
      // empty top slot
      if (lane == 0) {
        em_s[b] = em;
        F[h] = 0;
        Se[h] = 0;
      }
      h = h + 1 == L ? 0 : h + 1;
      cur += taken - em;
      __syncwarp();
    }
    bar_arrive(kBarEmpty + buf, kThreads);
  }

  // ---- carries out: suffix form -> avail form
  for (int k = lane; k < L; k += 32) {
    const int p = phys(k, h, L);
    const int nf = k + 1 < L ? F[phys(k + 1, h, L)] : 0;
    availf[w * L + k] = F[p] - nf;
    selendf[w * L + k] = Se[p];
  }
}

// warps 1..kProducerWarps: tiles, targets and the output of every chunk
// (kernel B's producers with L at run time and a tile of T)
template <class T, bool AUTO>
__device__ void produce(T* tile, int32_t* tgt_s, int32_t* out_s, int32_t* ring,
                        const int32_t* __restrict__ counts,
                        const int32_t* __restrict__ packed,
                        const int32_t* __restrict__ target,
                        const int32_t* __restrict__ avail0i,
                        int32_t* __restrict__ out, int32_t* __restrict__ availfi,
                        int64_t w, int64_t nbw, int64_t W, int64_t cap, int L, int B,
                        int P, int R, int cpb, int64_t nchunks, int64_t grid_offset,
                        int32_t max_coverage) {
  const int pt = threadIdx.x - 32;
  const int pw = pt >> 5;
  const int lane = pt & 31;
  const int64_t npos = (nbw - grid_offset) * B;
  int32_t* const o = out + w * npos;

  auto flush = [&](int64_t c) {
    const Chunk ch(c, B, P, cpb);
    const int32_t* src = out_s + (c & 1) * P;
    for (int i = pt; i < ch.len; i += kProducers) o[ch.q0 + i] = src[i];
  };

  int run = 0;
  if (AUTO) {
    for (int i = pt; i < R; i += kProducers) ring[i] = 0;
    bar_sync(kBarProducers, kProducers);
    for (int k = pt; k < L; k += kProducers) ring[k + 1] = avail0i[w * L + k];
    if (pw == 0) {
      for (int k = lane; k < L; k += 32) run += avail0i[w * L + k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) run += __shfl_xor_sync(kFull, run, off);
    }
  } else {
    for (int k = pt; k < L; k += kProducers) availfi[w * L + k] = avail0i[w * L + k];
  }

#pragma unroll 1
  for (int64_t c = 0; c < nchunks; ++c) {
    const int buf = static_cast<int>(c & 1);
    const Chunk ch(c, B, P, cpb);
    const int64_t t = grid_offset + ch.t_rel;
    T* tb = tile + static_cast<size_t>(buf) * P * L;
    if (c >= 2) {
      bar_sync(kBarEmpty + buf, kThreads);
      flush(c - 2);
    }
    // ---- the arrival tile: zero, scatter, suffix-sum over k
    uint4* t4 = reinterpret_cast<uint4*>(tb);
    const int n16 = static_cast<int>(ch.len * L * sizeof(T) / 16);
    for (int i = pt; i < n16; i += kProducers) t4[i] = make_uint4(0, 0, 0, 0);
    bar_sync(kBarProducers, kProducers);
    {
      const int cnt = counts[t * W + w];
      const int32_t* __restrict__ g = packed + (t * W + w) * cap;
      for (int i = pt; i < cnt; i += kProducers) {
        const int code = g[i];
        const int sr = code / L;
        const int sp = code - sr * L;
        const int b = sr - ch.b0;
        if (b >= 0 && b < ch.len) {
          tile_add(tb, b * L + sp);
          if (AUTO) atomicAdd(&ring[(ch.q0 + b + sp + 1) & (R - 1)], 1);
        }
      }
    }
    bar_sync(kBarProducers, kProducers);
    for (int b = pw; b < ch.len; b += kProducerWarps) {
      T* row = tb + static_cast<size_t>(b) * L;
      int above = 0;
      for (int k0 = L - 32; k0 >= 0; k0 -= 32) {
        int v = static_cast<int>(row[k0 + lane]);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_down_sync(kFull, v, off);
          if (lane + off < 32) v += u;
        }
        v += above;
        row[k0 + lane] = static_cast<T>(v);
        above = __shfl_sync(kFull, v, 0);
      }
    }
    bar_sync(kBarProducers, kProducers);
    // ---- the chunk's targets
    int32_t* tg = tgt_s + buf * P;
    if (AUTO) {
      if (pw == 0) {
        for (int i0 = 0; i0 < ch.len; i0 += 32) {
          const int i = i0 + lane;
          int v = 0;
          if (i < ch.len) {
            const int slot = static_cast<int>((ch.q0 + i) & (R - 1));
            v = static_cast<int>(tb[static_cast<size_t>(i) * L]) - ring[slot];
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

template <class T, bool AUTO>
__global__ void __launch_bounds__(kThreads) blocked_sweep_wide_kernel(
    const int32_t* __restrict__ counts, const int32_t* __restrict__ packed,
    const int32_t* __restrict__ target, const int32_t* __restrict__ avail0,
    const int32_t* __restrict__ selend0, const int32_t* __restrict__ avail0i,
    int32_t* __restrict__ out, int32_t* __restrict__ availf,
    int32_t* __restrict__ selendf, int32_t* __restrict__ availfi, int64_t nbw,
    int64_t W, int64_t cap, int L, int B, int P, int R, int64_t grid_offset,
    int32_t max_coverage) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);                                    // [2][P][L]
  int32_t* F = reinterpret_cast<int32_t*>(tile + static_cast<size_t>(2) * P * L);  // [L]
  int32_t* Se = F + L;                                                     // [L]
  int32_t* tgt_s = Se + L;                                                 // [2][P]
  int32_t* out_s = tgt_s + 2 * P;                                          // [2][P]
  int32_t* ring = out_s + 2 * P;                                           // [R]

  const int64_t w = blockIdx.x;
  const int cpb = (B + P - 1) / P;
  const int64_t nchunks = (nbw - grid_offset) * cpb;
  if (threadIdx.x < 32) {
    sweep_warp<T>(tile, tgt_s, out_s, F, Se, avail0, selend0, availf, selendf, w,
                  threadIdx.x, L, B, P, cpb, nchunks);
  } else {
    produce<T, AUTO>(tile, tgt_s, out_s, ring, counts, packed, target, avail0i, out,
                     availfi, w, nbw, W, cap, L, B, P, R, cpb, nchunks, grid_offset,
                     max_coverage);
  }
}

template <class T>
size_t smem_bytes(int L, int P, int R) {
  return sizeof(T) * 2 * static_cast<size_t>(P) * L + sizeof(int32_t) * (2 * L + 4 * P + R);
}

template <class T, bool AUTO>
cudaError_t launch(const int32_t* counts, const int32_t* packed, const int32_t* target,
                   const int32_t* avail0, const int32_t* selend0, const int32_t* avail0i,
                   int32_t* out, int32_t* availf, int32_t* selendf, int32_t* availfi,
                   int64_t nbw, int64_t W, int64_t cap, int L, int B,
                   int64_t grid_offset, int32_t max_coverage, cudaStream_t stream) {
  // the chunk: the largest power of two up to 128 positions that fits
  int P = 128, R = 1;
  for (;; P >>= 1) {
    R = 1;
    while (R < P + L + 1) R <<= 1;
    if (smem_bytes<T>(L, P, R) <= kMaxSmem || P == 1) break;
  }
  const size_t smem = smem_bytes<T>(L, P, R);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = blocked_sweep_wide_kernel<T, AUTO>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(W), kThreads, smem, stream>>>(
      counts, packed, target, avail0, selend0, avail0i, out, availf, selendf, availfi,
      nbw, W, cap, L, B, P, R, grid_offset, max_coverage);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The arguments are
// gd_blocked_sweep's, with any L = 32 * S up to 4096 and B at most 256;
// wide_tile != 0 keeps the arrival counts in int32 (any number of reads
// starting at one position), else in uint16 (at most 65535).
extern "C" int gd_blocked_sweep_wide(
    const void* counts, const void* packed, const void* target, const void* avail0,
    const void* selend0, const void* avail0i, void* out, void* availf, void* selendf,
    void* availfi, int64_t nbw, int64_t W, int64_t cap, int64_t B, int64_t L,
    int64_t grid_offset, int64_t auto_target, int64_t max_coverage, int64_t wide_tile,
    void* stream) {
  if (B > 256 || B < 1 || W < 1 || grid_offset < 0 || grid_offset >= nbw || cap < 0 ||
      L < 32 || L > kMaxSpan || L % 32 != 0)
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
  const int32_t m = static_cast<int32_t>(max_coverage);
  const int l = static_cast<int>(L), b = static_cast<int>(B);
  if (wide_tile) {
    if (auto_target)
      return (int)launch<int32_t, true>(c, p, tg, a0, s0, i0, o, af, sf, fi, nbw, W, cap,
                                        l, b, grid_offset, m, st);
    return (int)launch<int32_t, false>(c, p, tg, a0, s0, i0, o, af, sf, fi, nbw, W, cap,
                                       l, b, grid_offset, m, st);
  }
  if (auto_target)
    return (int)launch<uint16_t, true>(c, p, tg, a0, s0, i0, o, af, sf, fi, nbw, W, cap,
                                       l, b, grid_offset, m, st);
  return (int)launch<uint16_t, false>(c, p, tg, a0, s0, i0, o, af, sf, fi, nbw, W, cap,
                                      l, b, grid_offset, m, st);
}
