// Message-table build and lookup kernels for Hopper (sm_90a).
//
// The factorized wave (ops/factorized.py) spends its data-sized work in
// two primitives: a weighted bincount that builds a level's message
// table, and a gather that looks it up. Both are plain C entry points,
// bound with ctypes by kernels.py; every pointer is a device pointer
// owned by a PyTorch tensor, and every launch goes on the caller's
// stream. Each entry returns cudaGetLastError() so a refused launch
// surfaces in the wrapper instead of vanishing.
//
// rhj_weighted_bincount — replaces the Pallas kernel
//   radixhashjoin_tpu/ops/tables.py:283 weighted_bincount_onehot
//   (kernel _whist_kernel :260). out[b] += sum of w[i] over idx[i] == b;
//   indices outside [0, n_bins) are dropped (the wave's mask sentinel).
//   Bound on this card: random 4-byte atomic read-modify-writes, one per
//   row with a nonzero weight. The TPU kernel compares every row with
//   every bin tile in VMEM; here a row touches exactly one bin.
//   Design: when the table fits shared memory (<= kSmemMaxBins, 192 KB
//   of the 227 KB a block may use) each block keeps a private histogram
//   there, so the per-row atomics stay on the SM and only nonzero bins
//   go to device memory once per block. Wider tables (message tables
//   reach 2^20 bins, 4 MB) take global atomics, which the 50 MB L2
//   absorbs. Integer atomics commute, so the result is exact and
//   order-independent under the caller's per-bin total < 2^31 contract.
//   Zero-weight rows (masked rows) issue no atomic at all. Hot keys
//   (Zipf) serialize on one address; that contention is measured, not
//   yet tuned (warp aggregation is later work).
//
// rhj_table_gather — replaces the Pallas kernel
//   radixhashjoin_tpu/ops/tables.py:564 table_gather_pallas
//   (kernel _pgather_kernel :539). out[i] = table[keys[i]] when
//   0 <= keys[i] < n_bins, else 0.
//   Bound on this card: random 4-byte reads of the table plus a
//   streaming read of the keys and write of the output. The TPU kernel
//   keeps the table in VMEM and needs sorted keys (with a spill fallback)
//   to reach it; here the table stays L2-resident up to 50 MB on its
//   own, so one thread per key with a bounds test and a read-only-cache
//   load is the whole design: no sorting, no spill path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// rows each thread covers before the grid stops growing: amortizes the
// private histogram's zero-fill and merge over enough rows
constexpr long long kRowsPerThread = 16;
constexpr int kSmemMaxBins = 48 * 1024;
constexpr int kDefaultSmemBytes = 48 * 1024;

__global__ void bincount_smem_kernel(const int* __restrict__ idx,
                                     const int* __restrict__ w,
                                     long long n, int* __restrict__ out,
                                     int n_bins) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int k = idx[i];
    const int v = w[i];
    if ((unsigned)k < (unsigned)n_bins && v != 0) atomicAdd(&hist[k], v);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int v = hist[b];
    if (v != 0) atomicAdd(&out[b], v);
  }
}

__global__ void bincount_global_kernel(const int* __restrict__ idx,
                                       const int* __restrict__ w,
                                       long long n, int* __restrict__ out,
                                       int n_bins) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int k = idx[i];
    const int v = w[i];
    if ((unsigned)k < (unsigned)n_bins && v != 0) atomicAdd(&out[k], v);
  }
}

__global__ void gather_kernel(const int* __restrict__ table, int n_bins,
                              const int* __restrict__ keys, long long n,
                              int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int k = keys[i];
    out[i] = ((unsigned)k < (unsigned)n_bins) ? __ldg(table + k) : 0;
  }
}

int clamp_blocks(long long want, long long cap) {
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

}  // namespace

// out must hold n_bins zeros on entry; n >= 1, n_bins >= 1.
extern "C" int rhj_weighted_bincount(const int* idx, const int* w,
                                     long long n, int* out, int n_bins,
                                     int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want =
      (n + kThreads * kRowsPerThread - 1) / (kThreads * kRowsPerThread);
  if (n_bins <= kSmemMaxBins) {
    const int smem = n_bins * (int)sizeof(int);
    if (smem > kDefaultSmemBytes) {
      cudaError_t e = cudaFuncSetAttribute(
          bincount_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
    }
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bincount_smem_kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
    const int blocks = clamp_blocks(want, (long long)sm_count * per_sm);
    bincount_smem_kernel<<<blocks, kThreads, smem, s>>>(idx, w, n, out,
                                                         n_bins);
  } else {
    const int blocks = clamp_blocks(want, (long long)sm_count * 8);
    bincount_global_kernel<<<blocks, kThreads, 0, s>>>(idx, w, n, out,
                                                       n_bins);
  }
  return (int)cudaGetLastError();
}

// n >= 1, n_bins >= 1.
extern "C" int rhj_table_gather(const int* table, int n_bins,
                                const int* keys, long long n, int* out,
                                int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = clamp_blocks(want, (long long)sm_count * 32);
  gather_kernel<<<blocks, kThreads, 0, s>>>(table, n_bins, keys, n, out);
  return (int)cudaGetLastError();
}
