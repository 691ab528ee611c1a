// Radix histogram and per-block stable rank kernels for Hopper (sm_90a).
//
// The radix partition and radix sort (ops/partition.py) and the kernel
// shootout (bench_kernels.py) rest on two primitives: a digit histogram
// and, for every element, its stable rank among the equal digits of its
// 2048-element block. Plain C entry points, bound with ctypes by
// kernels.py like csrc/tables.cu: every pointer is a device pointer owned
// by a PyTorch tensor, every launch goes on the caller's stream, and each
// entry returns cudaGetLastError() so a refused launch reaches the
// wrapper.
//
// rhj_radix_histogram — replaces the Pallas kernel
//   radixhashjoin_tpu/ops/pallas_radix.py:55 radix_histogram
//   (kernel _hist_kernel :34). out[b] = #{i < count : (vals[i] & (n_bins-1))
//   == b}; n_bins is a power of two >= 128; lanes at or past count are
//   padding and count nowhere.
//   Bound on this card: the streaming read of vals (4 bytes a value) and
//   one shared-memory atomic per live value. The TPU kernel compares each
//   value with every bin as a one-hot cube; here a value touches exactly
//   one bin. Design: each block privatizes the whole histogram in shared
//   memory over grid-stride lanes, then merges each nonzero bin into the
//   output with one global atomic. `count` is read from device memory, so
//   a count that is still a device scalar costs the caller no host sync.
//   Up to kHistMaxBins (32768 bins, 128 KB; dynamic shared memory above
//   48 KB needs cudaFuncSetAttribute); the wrapper raises above that.
//
// rhj_rank_hist — replaces the Pallas kernel
//   radixhashjoin_tpu/ops/pallas_partition.py:92 rank_and_hist
//   (kernel _rank_hist_kernel :54). For digits in [0, n_bins]:
//   ranks[i] = #{j < i in i's 2048-element block : digits[j] == digits[i]},
//   hists[blk][b] = #{i in blk : digits[i] == b} for b < n_bins. A digit
//   outside [0, n_bins] gets rank 0 and is counted nowhere.
//   Bound on this card: the latency of one warp walking its block in
//   order (the rank is a sequential scan by definition); the data moved is
//   only 8 bytes an element plus the block histograms. The TPU kernel
//   builds a one-hot (bins x lanes) slab per row and scans it on the MXU;
//   here one warp per 2048-element block walks its 64 chunks of 32 in
//   order with a per-digit running counter in shared memory:
//   __match_any_sync gives each lane the lanes of its chunk with the same
//   digit, a lane's rank is counter[d] + the number of those peers below
//   it, and the lowest peer advances counter[d] by the peer count. Stable
//   by construction. The block is staged in shared memory first so the
//   64 chunk loads are coalesced and in flight together. Many blocks per
//   SM hide the walk's latency. One warp per block and the counters in
//   the default 48 KB of shared memory (n_bins <= kRankMaxBins) are this
//   design's limits; multi-warp blocks are later work.

#include <cuda_runtime.h>

namespace {

// kernels.py mirrors kHistMaxBins and kRankMaxBins to raise before a launch
constexpr int kThreads = 256;
constexpr long long kRowsPerThread = 16;
constexpr int kHistMaxBins = 32 * 1024;
constexpr int kDefaultSmemBytes = 48 * 1024;

constexpr int kBlock = 2048;  // ops/partition.py BLOCK; part of the output
constexpr int kWarp = 32;
constexpr int kRankSmemInts = kDefaultSmemBytes / (int)sizeof(int);
constexpr int kRankMaxBins = kRankSmemInts - kBlock - 1;  // 10239

__global__ void radix_hist_kernel(const int* __restrict__ vals, long long n,
                                  const int* __restrict__ count,
                                  int* __restrict__ out, int n_bins) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  long long live = *count;
  if (live > n) live = n;
  const int mask = n_bins - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < live; i += stride) {
    atomicAdd(&hist[vals[i] & mask], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int v = hist[b];
    if (v != 0) atomicAdd(&out[b], v);
  }
}

// one warp per block; dynamic shared memory: kBlock staged digits, then
// n_bins + 1 running counters
__global__ void rank_hist_kernel(const int* __restrict__ digits, long long n,
                                 int n_bins, int* __restrict__ ranks,
                                 int* __restrict__ hists) {
  extern __shared__ int smem[];
  int* staged = smem;
  int* counter = smem + kBlock;
  const int lane = threadIdx.x;
  const long long base = (long long)blockIdx.x * kBlock;
  const long long left = n - base;
  const int len = left < kBlock ? (int)left : kBlock;
  for (int j = lane; j < len; j += kWarp) staged[j] = digits[base + j];
  for (int b = lane; b <= n_bins; b += kWarp) counter[b] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < len; c += kWarp) {
    const int j = c + lane;
    const bool live = j < len;
    const int d = live ? staged[j] : -1;
    const bool ok = live && (unsigned)d <= (unsigned)n_bins;
    // every lane takes part; lanes that are not ok share the key -1,
    // which no ok lane has
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? d : -1);
    int start = 0;
    if (ok) start = counter[d];
    __syncwarp();
    if (ok) {
      ranks[base + j] = start + __popc(peers & below);
      if ((peers & below) == 0u) counter[d] = start + __popc(peers);
    } else if (live) {
      ranks[base + j] = 0;
    }
    __syncwarp();
  }
  int* row = hists + (long long)blockIdx.x * n_bins;
  for (int b = lane; b < n_bins; b += kWarp) row[b] = counter[b];
}

int clamp_blocks(long long want, long long cap) {
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

}  // namespace

// out must hold n_bins zeros on entry; count points at one device int32;
// n >= 1; n_bins a power of two in [1, kHistMaxBins].
extern "C" int rhj_radix_histogram(const int* vals, long long n,
                                   const int* count, int* out, int n_bins,
                                   int sm_count, void* stream) {
  if (n_bins < 1 || n_bins > kHistMaxBins || (n_bins & (n_bins - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = n_bins * (int)sizeof(int);
  if (smem > kDefaultSmemBytes) {
    cudaError_t e = cudaFuncSetAttribute(
        radix_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, radix_hist_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long want =
      (n + kThreads * kRowsPerThread - 1) / (kThreads * kRowsPerThread);
  const int blocks = clamp_blocks(want, (long long)sm_count * per_sm);
  radix_hist_kernel<<<blocks, kThreads, smem, s>>>(vals, n, count, out,
                                                   n_bins);
  return (int)cudaGetLastError();
}

// ranks: int32[n]; hists: int32[ceil(n / kBlock) * n_bins]; n >= 1;
// 1 <= n_bins <= kRankMaxBins.
extern "C" int rhj_rank_hist(const int* digits, long long n, int n_bins,
                             int* ranks, int* hists, void* stream) {
  if (n_bins < 1 || n_bins > kRankMaxBins) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = (kBlock + n_bins + 1) * (int)sizeof(int);
  rank_hist_kernel<<<(int)blocks, kWarp, smem, s>>>(digits, n, n_bins, ranks,
                                                    hists);
  return (int)cudaGetLastError();
}
