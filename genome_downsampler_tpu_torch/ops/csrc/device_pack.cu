// The device pack of config-5's reads, for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA program `build` of scripts/bench_chr1.py (:147-181):
// reads generated on the device from a Weyl sequence, bucketed into the
// blocked engine's (block, window) groups by an argsort of the groups, a
// searchsorted rank and a scatter, and the coverage difference. No Pallas
// kernel stood there; the port makes the pack a kernel of its own.
//
// What it computes. Read i of r starts at
//   s = ((i * 2654435761) mod 2^32) mod (n - read_len + 1)
// (uint32 arithmetic), in window w = s / win, block t = (s mod win) / B,
// group g = t * W + w, with the code (s mod B) * L + read_len - 1. It
// writes packed[g, :counts[g]], the group's codes ascending, then -1 pads
// (the wrapper fills them); counts[g]; diff[s] += 1 and
// diff[s + read_len] -= 1 (the wrapper zeroes both); and fill, the
// largest group. Ascending codes make the output deterministic and are
// the layout the port's packers emit (ops/blocked.py's preconditions).
//
// What bounds it on the H100. Bytes: the outputs written once (packed
// and diff, 1.0 GB each at config-5) over 3.35 TB/s; the reads come from
// an index, so nothing is read. Its own traffic is larger: per read a
// slot atomic on counts (7.8 MB at config-5: L2-resident), two coverage
// reductions scattered over the 1 GB difference, and one 4-byte code
// scattered into packed; then packed read and written once more by the
// sort.
//
// What the design does about it. Two launches on the caller's stream,
// each a plain pass over its data:
//   - scatter_reads, one thread a read: the start with native uint32
//     wrap, atomicAdd on the group's counter (the returned value is the
//     read's slot), the code stored at packed[g * cap + slot] while
//     slot < cap, and the two coverage updates as reductions whose value
//     nobody reads (RED, no round trip);
//   - sort_groups, one warp a group (grid-stride, 8 warps a CTA): the
//     group's min(count, cap) codes into shared memory, each lane ranks
//     its codes against the whole group (broadcast reads: rank = # smaller
//     codes + # equal codes at lower slots) and stores each at its rank;
//     the warps' largest counts meet in one atomicMax a CTA.
// The slots that pass 1 hands out depend on the order of the atomics; the
// sort undoes that, so the result is bit-equal to the plain twin
// (ops/device_pack.py::pack_reads_plain). A group of more than cap reads
// keeps cap of them in an order the atomics chose; the wrapper raises on
// fill > cap before anyone reads them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kWeyl = 2654435761u;
constexpr int kScatterThreads = 256;
constexpr int kSortWarps = 8;
constexpr int kMaxCap = 1024;  // 8 warps x cap ints of shared memory: 32 KB

__global__ void __launch_bounds__(kScatterThreads) scatter_reads(
    int32_t* __restrict__ packed, int32_t* __restrict__ counts,
    int32_t* __restrict__ diff, int64_t r, uint32_t modulus, int32_t read_len,
    uint32_t W, uint32_t win, uint32_t B, int32_t L, int32_t cap) {
  const int64_t i = int64_t{blockIdx.x} * kScatterThreads + threadIdx.x;
  if (i >= r) return;
  const uint32_t s = (static_cast<uint32_t>(i) * kWeyl) % modulus;
  const uint32_t w = s / win;
  const uint32_t rel = s - w * win;
  const uint32_t t = rel / B;
  const int64_t g = int64_t{t} * W + w;
  const int32_t code = static_cast<int32_t>(rel - t * B) * L + (read_len - 1);
  const int32_t slot = atomicAdd(counts + g, 1);
  if (slot < cap) packed[g * cap + slot] = code;
  atomicAdd(diff + s, 1);
  atomicAdd(diff + s + read_len, -1);
}

__global__ void __launch_bounds__(32 * kSortWarps) sort_groups(
    int32_t* __restrict__ packed, const int32_t* __restrict__ counts,
    int32_t* __restrict__ fill, int64_t groups, int32_t cap) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t warp_fill[kSortWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int32_t* buf = smem + warp * cap;
  int32_t most = 0;
  for (int64_t g = int64_t{blockIdx.x} * kSortWarps + warp; g < groups;
       g += int64_t{gridDim.x} * kSortWarps) {
    const int32_t count = counts[g];
    most = max(most, count);
    const int32_t n = min(count, cap);
    int32_t* row = packed + g * cap;
    for (int32_t k = lane; k < n; k += 32) buf[k] = row[k];
    __syncwarp();
    for (int32_t k = lane; k < n; k += 32) {
      const int32_t v = buf[k];
      int32_t rank = 0;
      for (int32_t j = 0; j < n; ++j) {
        const int32_t u = buf[j];
        rank += (u < v) | ((u == v) & (j < k));
      }
      row[rank] = v;
    }
    __syncwarp();
  }
  if (lane == 0) warp_fill[warp] = most;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kSortWarps; ++k) most = max(most, warp_fill[k]);
    atomicMax(fill, most);
  }
}

}  // namespace

// Returns the cudaError_t of the two launches (0 on success). packed
// [nbw, W, cap] must hold -1 and counts [nbw * W], diff [W * win + 1] and
// fill [1] zeros; win a multiple of B covering ceil(n / W); 1 <= r < 2^31,
// read_len <= min(n, L), W * win < 2^31, B * L < 2^31, 1 <= cap <= 1024.
extern "C" int gd_device_pack(void* packed, void* counts, void* diff, void* fill,
                              int64_t r, int64_t n, int64_t read_len, int64_t W,
                              int64_t win, int64_t B, int64_t L, int64_t cap,
                              void* stream) {
  if (r < 1 || r >= (int64_t{1} << 31) || read_len < 1 || read_len > n ||
      read_len > L || W < 1 || B < 1 || win < B || win % B != 0 ||
      W * win < n || W * win >= (int64_t{1} << 31) || B * L >= (int64_t{1} << 31) ||
      cap < 1 || cap > kMaxCap)
    return (int)cudaErrorInvalidValue;
  auto p = static_cast<int32_t*>(packed);
  auto c = static_cast<int32_t*>(counts);
  auto d = static_cast<int32_t*>(diff);
  auto f = static_cast<int32_t*>(fill);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t groups = W * (win / B);
  scatter_reads<<<(unsigned)((r + kScatterThreads - 1) / kScatterThreads),
                  kScatterThreads, 0, st>>>(
      p, c, d, r, (uint32_t)(n - read_len + 1), (int32_t)read_len, (uint32_t)W,
      (uint32_t)win, (uint32_t)B, (int32_t)L, (int32_t)cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // every CTA resident at once (8 of 256 threads an SM), each walking
  // groups a grid apart
  const int64_t blocks = (groups + kSortWarps - 1) / kSortWarps;
  const unsigned grid = (unsigned)(blocks < 8 * sms ? blocks : 8 * sms);
  sort_groups<<<grid, 32 * kSortWarps, sizeof(int32_t) * kSortWarps * cap, st>>>(
      p, c, f, groups, (int32_t)cap);
  return (int)cudaGetLastError();
}
