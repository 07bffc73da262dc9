// The ablation kernel of the blocked sweep: kernel B's step over W
// independent windows with pieces removed one at a time, to attribute its
// time per position, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `make_kernel` of
// scripts/bench_kernel_ablate.py (launched by `run_mode`), an ablation of
// kernel B (`_blocked_kernel`, ops/pallas_blocked.py; here
// blocked_sweep.cu). Only `full` is a correct sweep: of W independent
// windows from zero carries, with no carry between windows.
//
// What it computes. Per window, per block of B positions: the arrivals
// of each position b from the window's codes start_rel * L + span - 1 (-1
// pads count nothing; codes of span L count nowhere, since the Pallas
// kernel overwrites that lane of its tile with the target); cur re-synced
// to sum(selend) at the block's first position. The state is the suffix
// form of the avail ring, F[k] = sum of avail[j] for j >= k, and selend.
// Per position, by mode:
//   full      gd::sweep_step (fold F += arrivals in suffix form; take
//             clip(deficit - F[k+1], 0, F[k] - F[k+1]) into selend;
//             F -= min(taken, F); cur += taken - selend[0]), the store
//             of selend[0], gd::shift_down: kernel B's exact step;
//   notake    the fold; em = selend[0] broadcast and stored; the shift;
//             cur -= em (no take split, no F -= min(taken, F), no cur +=
//             taken);
//   noroll    full without the shift (cur drifts until the next block);
//   noemit    full without the store of em (and without the flush);
//   addonly   the fold alone;
//   tileonly  nothing: the producers alone, the sweep warp only takes
//             part in the barriers;
//   emptyloop a loop over the chunk's positions with a counter kept alive.
// `out` is written in full, notake and noroll (the wrapper zeroes it for
// the others); the carries leave in avail form, availf[k] = F[k] - F[k+1],
// in every mode (zero in tileonly and emptyloop).
//
// Why this equals the twin (ops/ablate.py, avail form, unchanged). With
// csum the inclusive prefix of avail and total = csum[L-1], total - csum[k]
// = F[k+1], so the twin's take clip(deficit - (total - csum[k]), 0,
// avail[k]) is clip(deficit - F[k+1], 0, F[k] - F[k+1]), and its
// min(max(deficit, 0), total) is taken = min(max(deficit, 0), F[0]). The
// takes of slots j >= k telescope to min(max(deficit, 0), F[k]) (slot j's
// is g(F[j]) - g(F[j+1]) with g(x) = min(max(deficit, 0), x)), so
// avail -= take is F[k] -= min(taken, F[k]) in suffix form. The shift and
// the fold are linear, so they commute with the change of form.
//
// What bounds it on the H100. As kernel B: one warp's loop-carried chain
// per position (the F[0] and selend[0] broadcasts, the F[k+1] neighbour,
// the two shift shuffles), strictly sequential within a window, W of the
// 132 SMs busy (64 at the default). Bytes and operations are tiny. Under
// the chain lies the producers' time: each producer warp suffix-sums its
// rows one at a time, five dependent shuffle levels a row, so tileonly
// (the producers alone) takes most of full's time a position, and a mode
// whose sweep is shorter than that (notake, noroll, addonly, emptyloop)
// reads the producers' time, not its own.
//
// What the design does about it. Kernel B's frame (blocked_sweep.cu),
// copied piece by piece so that each mode prices a piece of the step that
// kernel B runs: one CTA of 128 threads per window; warp 0 sweeps, warps
// 1-3 (the producers) prepare the next chunk of P = min(B, 128) positions
// into a double buffer of dynamic shared memory, handed over by named
// barriers (FULL: producers -> sweep warp, EMPTY: sweep warp ->
// producers). Copied from blocked_sweep.cu: the thread and barrier
// constants (:76-83), load_row16 and store_row16 (:86-146), Chunk
// (:149-158), the sweep warp's loop (:196-222: the next row and target read
// one position ahead, em stored to shared memory by every lane) and its
// carries out (:224-232), the producers' zero / scatter / suffix-sum and
// flush (:251-257, :281-327, :358-364). What differs: the producers walk
// all cap codes of a group and skip pads (there are no counts) and codes of
// span L, copy the targets (there is no auto target), and flush only in the
// modes that emit; cur is re-synced once a block, at its first chunk.
// Each mode is its own template instantiation. notake's selend starts at
// zero and never grows, so an asm operand hides its value from the
// compiler, or its broadcast and shift would fold away; emptyloop keeps
// its counter in an asm operand and stores it once a chunk.
//
// What each mode keeps after ptxas (cuobjdump -sass, L = 256, the sweep
// loop's instructions a position; kernel B's loop is 91 with 5 shuffles):
//   full      91: SHFL.DOWN (F[k+1]) beside SHFL.IDX (F[0]), SHFL.IDX (em),
//             the shift's two SHFL.DOWN, one STS; the F chain crosses two
//             shuffle levels a position, cur's one (em);
//   noemit    87: full's shuffles, no STS;
//   noroll    75: SHFL.DOWN, SHFL.IDX (F[0]), SHFL.IDX (em): one level;
//   notake    41: SHFL.IDX (em) and the shift's two SHFL.DOWN: one level;
//   addonly   24: the row's LDS and 8 IADD, no shuffle;
//   emptyloop 4: the counter's add, the compare, the branch;
//   tileonly  no sweep loop.
// Without the minimum of one block in __launch_bounds__, ptxas gave full
// 40 registers (kernel B 48) and issued its first shuffle some 15
// instructions later in the same 91, and full ran 23% slower than kernel B
// on the same codes (bench_kernel_ablate's default); with it, 52 registers
// and the shuffles first, as in kernel B.
//
// Preconditions (the packer's layout): codes in [0, B * L) or negative;
// at most 65535 reads of a window start at one position (the tile's counts
// are uint16; the wrapper checks); L one of 32, 64, 128, 256; B even.

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
// positions per chunk: two uint16 (128, 256) tiles are 128 KB
constexpr int kMaxChunk = 128;
// modes, in the order of the wrapper's MODES
enum Mode { kFullMode, kNoTake, kNoRoll, kNoEmit, kAddOnly, kTileOnly, kEmptyLoop };

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
// of block t = c / cpb; q0 is its first position in the window. 32-bit:
// a 64-bit division is a call, and ptxas spills what lives across it.
struct Chunk {
  int64_t q0;
  int t, b0, len;
  __device__ Chunk(int c, int B, int P, int cpb) {
    t = c / cpb;
    b0 = (c - t * cpb) * P;
    len = min(P, B - b0);
    q0 = static_cast<int64_t>(t) * B + b0;
  }
};

// the modes that write `out`
template <int MODE>
constexpr bool kEmits = MODE == kFullMode || MODE == kNoTake || MODE == kNoRoll;

// warp 0: the sweep over every chunk, from zero carries to the carries out
template <int S, int MODE>
__device__ __forceinline__ void sweep_warp(const uint16_t* tile, const int32_t* tgt_s,
                                           int32_t* out_s, int32_t* __restrict__ availf,
                                           int32_t* __restrict__ selendf, int64_t w, int lane,
                                           int B, int P, int cpb, int nchunks) {
  constexpr int L = 32 * S;
  const int k0 = lane * S;
  int F[S], Se[S];
#pragma unroll
  for (int j = 0; j < S; ++j) F[j] = Se[j] = 0;
  if constexpr (MODE == kNoTake) {
#pragma unroll
    for (int j = 0; j < S; ++j) asm volatile("" : "+r"(Se[j]));
  }
  int cur = 0;

#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    const Chunk ch(c, B, P, cpb);
    bar_sync(kBarFull + buf, kThreads);
    int32_t* em_s = out_s + buf * P;
    if constexpr (MODE == kEmptyLoop) {
#pragma unroll 1
      for (int b = 0; b < ch.len; ++b) {
        cur += 1;
        asm volatile("" : "+r"(cur));
      }
      em_s[0] = cur;  // every lane: without a use, ptxas deletes the loop
    } else if constexpr (MODE != kTileOnly) {
      if (ch.b0 == 0) cur = gd::warp_sum<S>(Se);  // once a block
      const uint16_t* rows = tile + buf * P * L + k0;
      const int32_t* tg = tgt_s + buf * P;
      int add[S];
      load_row16<S>(rows, add);
      int tgt = tg[0];
#pragma unroll 1
      for (int b = 0; b < ch.len; ++b) {
        // the next position's arrivals and target: off the state
        const int bn = b + 1 < ch.len ? b + 1 : b;
        int nadd[S];
        load_row16<S>(rows + bn * L, nadd);
        const int ntgt = tg[bn];
        if constexpr (MODE == kAddOnly) {
#pragma unroll
          for (int j = 0; j < S; ++j) F[j] += add[j];
        } else if constexpr (MODE == kNoTake) {
#pragma unroll
          for (int j = 0; j < S; ++j) F[j] += add[j];
          const int em = __shfl_sync(kFull, Se[0], 0);
          em_s[b] = em;  // every lane: one address, one value
          gd::shift_down<S>(F, Se, lane);
          cur -= em;
        } else {
          int tk[S];  // unused: the compiler drops it
          const int em = gd::sweep_step<S>(F, Se, add, tgt, cur, lane, tk);
          if constexpr (MODE != kNoEmit) em_s[b] = em;
          if constexpr (MODE != kNoRoll) gd::shift_down<S>(F, Se, lane);
        }
#pragma unroll
        for (int j = 0; j < S; ++j) add[j] = nadd[j];
        tgt = ntgt;
      }
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
template <int S, int MODE>
__device__ __forceinline__ void produce(uint16_t* tile, int32_t* tgt_s, const int32_t* out_s,
                                        const int32_t* __restrict__ packed,
                                        const int32_t* __restrict__ target,
                                        int32_t* __restrict__ out, int64_t w, int64_t nbw,
                                        int64_t W, int cap, int B, int P, int cpb,
                                        int nchunks) {
  constexpr int L = 32 * S;
  const int pt = threadIdx.x - 32;  // 0..kProducers-1
  const int pw = pt >> 5;           // producer warp
  const int lane = pt & 31;
  const int64_t win = nbw * B;
  int32_t* const o = out + w * win;

  auto flush = [&](int c) {  // chunk c's emitted counts -> out
    if constexpr (kEmits<MODE>) {
      const Chunk ch(c, B, P, cpb);
      const int32_t* src = out_s + (c & 1) * P;
      for (int i = pt; i < ch.len; i += kProducers) o[ch.q0 + i] = src[i];
    }
  };

#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    const Chunk ch(c, B, P, cpb);
    uint16_t* tb = tile + buf * P * L;
    if (c >= 2) {  // chunk c - 2 left this buffer
      bar_sync(kBarEmpty + buf, kThreads);
      flush(c - 2);
    }
    // ---- the arrival tile: zero, scatter, suffix-sum over k
    uint4* t4 = reinterpret_cast<uint4*>(tb);
    for (int i = pt; i < ch.len * L / 8; i += kProducers) t4[i] = make_uint4(0, 0, 0, 0);
    bar_sync(kBarProducers, kProducers);
    {
      const int32_t* __restrict__ g = packed + (ch.t * W + w) * cap;
      uint32_t* t32 = reinterpret_cast<uint32_t*>(tb);
      for (int i = pt; i < cap; i += kProducers) {
        const int code = g[i];
        const int sr = code / L;
        const int sp = code - sr * L;
        const int b = sr - ch.b0;
        // pads and reads of span L count nowhere
        if (code >= 0 && sp != L - 1 && b >= 0 && b < ch.len) {
          const int e = b * L + sp;
          atomicAdd(&t32[e >> 1], 1u << ((e & 1) * 16));
        }
      }
    }
    bar_sync(kBarProducers, kProducers);
    for (int b = pw; b < ch.len; b += kProducerWarps) {
      uint16_t* row = tb + b * L + lane * S;
      int a[S];
      load_row16<S>(row, a);
      gd::warp_suffix<S>(a, lane);
      store_row16<S>(row, a);
    }
    // ---- the chunk's targets
    int32_t* tg = tgt_s + buf * P;
    const int32_t* src = target + w * win + ch.q0;
    for (int i = pt; i < ch.len; i += kProducers) tg[i] = src[i];
    bar_arrive(kBarFull + buf, kThreads);
  }

  // ---- the last chunks' output
  for (int c = nchunks > 2 ? nchunks - 2 : 0; c < nchunks; ++c) {
    bar_sync(kBarEmpty + (c & 1), kThreads);
    flush(c);
  }
}

// one CTA an SM at most: without the minimum of one block, ptxas gives the
// kernel 40 registers and schedules the sweep loop's shuffles late
template <int S, int MODE>
__global__ void __launch_bounds__(kThreads, 1) blocked_ablate_kernel(
    const int32_t* __restrict__ packed,  // [nbw, W, cap]
    const int32_t* __restrict__ target,  // [W, nbw * B]
    int32_t* __restrict__ out,           // [W, nbw * B]
    int32_t* __restrict__ availf,        // [W, L]
    int32_t* __restrict__ selendf,       // [W, L]
    int64_t nbw, int64_t W, int cap, int B, int P) {
  constexpr int L = 32 * S;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);            // [2][P][L]
  int32_t* tgt_s = reinterpret_cast<int32_t*>(tile + 2 * P * L);  // [2][P]
  int32_t* out_s = tgt_s + 2 * P;                                 // [2][P]

  const int64_t w = blockIdx.x;
  const int cpb = (B + P - 1) / P;
  const int nchunks = static_cast<int>(nbw) * cpb;
  if (threadIdx.x < 32) {
    sweep_warp<S, MODE>(tile, tgt_s, out_s, availf, selendf, w, threadIdx.x, B, P, cpb,
                        nchunks);
  } else {
    produce<S, MODE>(tile, tgt_s, out_s, packed, target, out, w, nbw, W, cap, B, P, cpb,
                     nchunks);
  }
}

template <int S>
const void* kernel_s(int64_t mode) {
  switch (mode) {
#define GD_MODE(M) \
  case M:          \
    return reinterpret_cast<const void*>(blocked_ablate_kernel<S, M>);
    GD_MODE(kFullMode)
    GD_MODE(kNoTake)
    GD_MODE(kNoRoll)
    GD_MODE(kNoEmit)
    GD_MODE(kAddOnly)
    GD_MODE(kTileOnly)
    GD_MODE(kEmptyLoop)
#undef GD_MODE
    default:
      return nullptr;
  }
}

// the instantiation of (L, mode), or nullptr
const void* kernel_of(int64_t L, int64_t mode) {
  switch (L) {
    case 32:
      return kernel_s<1>(mode);
    case 64:
      return kernel_s<2>(mode);
    case 128:
      return kernel_s<4>(mode);
    case 256:
      return kernel_s<8>(mode);
    default:
      return nullptr;
  }
}

int chunk_positions(int64_t B) { return B < kMaxChunk ? static_cast<int>(B) : kMaxChunk; }

// two uint16 (P, L) tiles, and two chunks each of targets and emitted counts
size_t shared_bytes(int64_t B, int64_t L) {
  const size_t P = chunk_positions(B);
  return sizeof(uint16_t) * 2 * P * L + sizeof(int32_t) * 4 * P;
}

// what the kernel's 32-bit counts of chunks, codes and blocks hold
bool valid(int64_t nbw, int64_t W, int64_t cap, int64_t B) {
  constexpr int64_t kMax = 2147483647;
  return nbw >= 1 && W >= 1 && W <= kMax && cap >= 0 && cap <= kMax && B >= 2 &&
         B % 2 == 0 && B <= kMax && nbw * ((B + kMaxChunk - 1) / kMaxChunk) <= kMax;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). mode indexes
// (full, notake, noroll, noemit, addonly, tileonly, emptyloop); L must be
// one of 32, 64, 128, 256 and B even; at most 65535 reads of a window may
// start at one position (the tile's counts are uint16).
extern "C" int gd_blocked_ablate(const void* packed, const void* target, void* out,
                                 void* availf, void* selendf, int64_t nbw, int64_t W,
                                 int64_t cap, int64_t B, int64_t L, int64_t mode,
                                 void* stream) {
  const void* k = kernel_of(L, mode);
  if (k == nullptr || !valid(nbw, W, cap, B)) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(B, L);
  cudaError_t e =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int c = static_cast<int>(cap), b = static_cast<int>(B), p = chunk_positions(B);
  void* args[] = {&packed, &target, &out, &availf, &selendf, &nbw, &W, &c, &b, &p};
  e = cudaLaunchKernel(k, dim3(static_cast<unsigned>(W)), dim3(kThreads), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The frame and resources of the instantiation of (L, mode) at block B:
// info = (positions a chunk, dynamic shared bytes, registers, local bytes).
extern "C" int gd_blocked_ablate_info(int64_t B, int64_t L, int64_t mode, int64_t* info) {
  const void* k = kernel_of(L, mode);
  if (k == nullptr || info == nullptr || B < 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  info[0] = chunk_positions(B);
  info[1] = static_cast<int64_t>(shared_bytes(B, L));
  info[2] = a.numRegs;
  info[3] = static_cast<int64_t>(a.localSizeBytes);
  return 0;
}
