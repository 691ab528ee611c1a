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
//   Bound on this card: the bytes (read the digit, write the rank: 8 an
//   element, plus the block histograms), once finding the equal digits of
//   a chunk costs less than moving them. The TPU kernel builds a one-hot
//   (bins x lanes) slab per row and scans it on the MXU. Here each warp
//   ranks a 2048-element block of its own, walking it in element order in
//   64 chunks of 32 (a rank is a running count), and a CUDA block holds up
//   to 8 such warps. What the design answers (same-call A/Bs on an H100
//   80GB HBM3 at 700 W, PERF.md):
//   - __match_any_sync costs about 56 SM-cycles for a chunk of mostly
//     distinct digits, which bounded the one-warp __match_any_sync
//     design; a match by one ballot per key bit costs 20 cycles for 9
//     bits. So the equal lanes meet in shared memory instead: each warp
//     keeps one {lane mask, count} cell per digit, a lane ORs its bit into
//     its digit's mask and reads the cell back (its rank: the count plus
//     its peers below it), and the lowest peer clears the mask and
//     advances the count.
//   - 32 lanes ORing one word serialize, so a set of 256 equal digits
//     (one hot digit, long runs, dead lanes) takes one shuffle and one
//     vote and a single update of the count.
//   - Eight warps sharing a 2048-element block, with an exclusive scan
//     down their rows of cells, lost 20-30% to the scan and the barriers.
//   - Each lane keeps 8 coalesced 128-byte loads in flight, the next
//     set's while it ranks the current one; ranks are stored evict-first.
//   A warp's cells take 8 (n_bins + 1) bytes: 8 warps a block up to 767
//   bins, fewer within 48 KB, one warp up to the 227 KB a block may opt
//   into (cudaFuncSetAttribute past 48 KB), so n_bins <= kRankMaxBins.

#include <cuda_runtime.h>

namespace {

// kernels.py mirrors kHistMaxBins and kRankMaxBins to raise before a launch
constexpr int kThreads = 256;
constexpr long long kRowsPerThread = 16;
constexpr int kHistMaxBins = 32 * 1024;
constexpr int kDefaultSmemBytes = 48 * 1024;

constexpr int kBlock = 2048;  // ops/partition.py BLOCK; part of the output
constexpr int kWarp = 32;
constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / kWarp;
constexpr int kChunks = 8;  // chunks of 32 digits a lane holds at once
// one warp's n_bins + 1 cells of 8 bytes fill at most the 227 KB of
// shared memory a block may opt into on sm_90
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kRankMaxBins = kMaxSmemBytes / 8 - 1;  // 29055

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

// Loads the warp's next kChunks chunks of 32 digits, chunk k = elements
// start + 32k + lane (each load one coalesced 128-byte line), as rank
// keys: the digit when it lies in [0, n_bins], else `misfit` (n_bins + 1),
// which past-the-end lanes take too.
__device__ __forceinline__ void load_keys(const int* __restrict__ digits,
                                          long long start, int left,
                                          int n_bins, int lane,
                                          int (&key)[kChunks]) {
  const int misfit = n_bins + 1;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int j = k * kWarp + lane;
    const int d = j < left ? __ldcs(digits + start + j) : misfit;
    key[k] = (unsigned)d <= (unsigned)n_bins ? d : misfit;
  }
}

// Each key's rank among the equal keys of the warp's chunks so far, in
// element order, advancing the counts of `cell` (one {lane mask, count}
// per digit); misfit keys are left unranked and counted nowhere.
__device__ __forceinline__ void rank_chunks(const int (&key)[kChunks],
                                            int misfit, int lane, int2* cell,
                                            int (&rank)[kChunks]) {
  // all 256 keys equal (one hot digit, long runs, dead lanes): every
  // lane of a chunk is a peer, and one update does for the set
  const int k0 = __shfl_sync(0xffffffffu, key[0], 0);
  bool same = true;
#pragma unroll
  for (int k = 1; k < kChunks; ++k) same &= key[k] == k0;
  if (__all_sync(0xffffffffu, same && key[0] == k0)) {
    if (k0 == misfit) return;
    const int before = cell[k0].y;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) rank[k] = before + k * kWarp + lane;
    __syncwarp();
    if (lane == 0) cell[k0].y = before + kChunks * kWarp;
    __syncwarp();
    return;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const bool fit = key[k] != misfit;
    // the chunk's lanes holding each key gather in its mask; the lowest
    // of them then clears the mask and advances the count
    if (fit) atomicOr(reinterpret_cast<unsigned*>(&cell[key[k]].x),
                      1u << lane);
    __syncwarp();
    const int2 c = fit ? cell[key[k]] : make_int2(0, 0);
    const unsigned peers = (unsigned)c.x;
    rank[k] = c.y + __popc(peers & below);
    __syncwarp();
    if (fit && (peers & below) == 0u)
      cell[key[k]] = make_int2(0, c.y + __popc(peers));
    __syncwarp();
  }
}

// Each warp ranks a 2048-element block of its own in kBlock / 256 sets of
// kChunks chunks, the next set's loads in flight while it ranks the
// current one; its cells' counts are then the block's histogram row.
__global__ void __launch_bounds__(kRankThreads)
    rank_hist_kernel(const int* __restrict__ digits, long long n,
                     long long n_blocks, int n_bins, int* __restrict__ ranks,
                     int* __restrict__ hists) {
  extern __shared__ int2 cells[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long blk = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (blk >= n_blocks) return;  // whole warps
  const int misfit = n_bins + 1;
  int2* cell = cells + warp * (n_bins + 1);
  for (int b = lane; b <= n_bins; b += kWarp) cell[b] = make_int2(0, 0);
  __syncwarp();
  const long long start = blk * kBlock;
  const int left = (int)(n - start < kBlock ? n - start : kBlock);
  constexpr int kSet = kChunks * kWarp;
  int key[kChunks], rank[kChunks];
  load_keys(digits, start, left, n_bins, lane, key);
#pragma unroll 1
  for (int g = 0; g < kBlock; g += kSet) {
    int next[kChunks];  // past the block: no loads, all misfits
    load_keys(digits, start + g + kSet, left - g - kSet, n_bins, lane, next);
    rank_chunks(key, misfit, lane, cell, rank);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int j = g + k * kWarp + lane;
      if (j < left)
        __stcs(ranks + start + j, key[k] == misfit ? 0 : rank[k]);
      key[k] = next[k];
    }
  }
  __syncwarp();
  int* row = hists + blk * n_bins;
  for (int b = lane; b < n_bins; b += kWarp) row[b] = cell[b].y;
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
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // as many warps as fit the default 48 KB of shared memory, up to 8; one
  // warp above that
  const int row_bytes = (n_bins + 1) * (int)sizeof(int2);
  int warps = kDefaultSmemBytes / row_bytes;
  if (warps > kRankWarps) warps = kRankWarps;
  if (warps < 1) warps = 1;
  const int smem = warps * row_bytes;
  if (smem > kDefaultSmemBytes) {
    cudaError_t e = cudaFuncSetAttribute(
        rank_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  rank_hist_kernel<<<(int)((n_blocks + warps - 1) / warps), warps * kWarp,
                     smem, s>>>(digits, n, n_blocks, n_bins, ranks, hists);
  return (int)cudaGetLastError();
}
