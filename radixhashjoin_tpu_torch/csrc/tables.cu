// Message-table build and lookup kernels for Hopper (sm_90a).
//
// The factorized wave (ops/factorized.py), the dense probes
// (ops/join_dense.py) and the fused terminal joins (ops/terminal.py)
// spend their data-sized work in two primitives: a weighted bincount that
// builds a message table, and a gather that looks it up (the dense probe
// looks two tables up with the same keys: a fused double gather). Each is
// a plain C entry point, bound with ctypes by kernels.py; every pointer is
// a device pointer owned by a PyTorch tensor, every launch goes on the
// caller's stream, nothing here allocates or synchronizes, and each entry
// returns cudaGetLastError() so a refused launch surfaces in the wrapper
// instead of vanishing. Device attributes and occupancies are read once per
// device and kept in a static (no call synchronizes).
//
// rhj_weighted_bincount — replaces the Pallas kernel
//   radixhashjoin_tpu/ops/tables.py:283 weighted_bincount_onehot
//   (kernel _whist_kernel :260), and, adding into an accumulator, the
//   per-window builds of radixhashjoin_tpu/ops/tables.py:339
//   scatter_add_window. out[b] += sum of w[i] over idx[i] == b;
//   indices outside [0, n_bins) are dropped (the wave's mask sentinel,
//   negatives included) and zero-weight rows issue nothing.
//   Bound on this card: the streaming read of idx and w (8 bytes a row)
//   at 3.35 TB/s where the atomics stay on the SM; for wide tables with
//   keys that do not repeat, the L2's atomic rate (one device atomic per
//   row). The TPU kernel compares every row with every bin tile in VMEM;
//   here a row touches exactly one bin, so the danger is the other way
//   round: under the repo's clipped Zipf(1.1) keys a quarter of all rows
//   hit one bin, and one device atomic per row queues them all on one L2
//   address. Design:
//   - up to kSmemMaxBins bins (192 KB) each block keeps a private
//     histogram in dynamic shared memory and merges its nonzero bins into
//     `out` once; a block takes the SM's 2048 thread slots divided by the
//     blocks whose tables fit an SM together, in whole warps from 256 to
//     1024 threads (one block of a table near 192 KB runs 1024 threads,
//     two of 24K bins 1024 each, three of 16K bins 672 each);
//   - wider tables (message tables reach 2^20 bins, 4 MB) take device
//     atomics behind a per-block aggregation cache: kSlots (bin, partial)
//     slots in shared memory, open addressing with kProbes linear probes,
//     a slot claimed with atomicCAS on its bin word (-1 = empty). A row
//     that finds no slot adds to `out` directly, so once a block's cache
//     is full keys that never repeat pay kProbes shared-memory probes and
//     nothing else (uniform keys measured no slower). Persistent blocks,
//     two 1024-thread blocks per SM, flush each occupied slot with one
//     device atomic: a hot bin reaches device memory once per block;
//   - each warp loads kBuildUnroll chunks of 32 rows before it adds, with
//     evict-first hints, so the table's lines keep L2.
//   Warp aggregation (__match_any_sync peers, one atomic per distinct
//   bin) was measured and left out: it cost more than the shared-memory
//   atomics it saved, on every shape (PERF.md).
//   Integer atomics commute and every partial is part of a bin total the
//   caller keeps below 2^31, so the result is exact and order-independent.
//
// rhj_table_gather — replaces the Pallas kernel
//   radixhashjoin_tpu/ops/tables.py:564 table_gather_pallas
//   (kernel _pgather_kernel :539). out[i] = table[keys[i]] when
//   0 <= keys[i] < n_bins, else 0.
//   Bound on this card: the streaming read of the keys and write of the
//   output (8 bytes a key) at 3.35 TB/s for tables that L1 holds; for
//   wider ones the L2-to-SM traffic of the random table reads, one
//   32-byte sector per key, which for unsorted keys costs about three
//   times the DRAM bound (PERF.md). The TPU kernel keeps the table
//   in VMEM and needs sorted keys (with a spill fallback) to reach it;
//   here the keys stay unsorted. Design:
//   - 16-byte I/O: keys are read and outputs written as int4, with
//     evict-first hints (__ldcs / __stcs) so the stream does not push the
//     table out of L2, and the table is read through the read-only path
//     (__ldg); each thread has kGatherVecs int4 of keys, so
//     4 * kGatherVecs independent table reads, in flight. The wrapper
//     gives `out` the same offset within 16 bytes as `keys`; the unaligned
//     head (< 4 keys) and the ragged tail (< 4 keys) run as scalars, and
//     nothing reads past n;
//   - a full grid (one step per thread; the grid-stride loop only
//     covers past 2^31 blocks): a persistent one measured slower.
//   Staging tables of up to 48K entries in shared memory was measured and
//   left out: L1 already holds them, and the staged kernel was no faster.
//
// rhj_table_gather2 — replaces the fused double lookup of
//   radixhashjoin_tpu/ops/tables.py:409 table_gather2 (an XLA one-hot
//   matmul of both tables' bytes, not a Pallas kernel). oa[i] = a[keys[i]]
//   and ob[i] = b[keys[i]] for 0 <= keys[i] < n_bins, else 0: the dense
//   probe's count and offset tables, looked up with one read of the keys.
//   Bound on this card: the streaming read of the keys and write of both
//   outputs (12 bytes a key) for tables L1 holds; else the random table
//   reads through L2. Design: the lookup's kernel (the same int4 key loads
//   and stores at the keys' offset within 16 bytes) over ONE table of
//   (a, b) pairs, which the wrapper interleaves: a key's two values share
//   one 8-byte read and one 32-byte sector. Two separate tables take two
//   sectors a key, and measured 1.77x slower at 2^26 keys into 2^20-entry
//   tables (L2-resident), no faster than two lookups (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSmemMaxBins = 48 * 1024;
// rows each thread covers before the grid stops growing: amortizes a
// block's zero-fill and merge (or cache flush) over enough rows
constexpr long long kRowsPerThread = 16;
constexpr int kBuildUnroll = 4;     // 32-row chunks a warp loads at once
constexpr int kCacheThreads = 1024;
constexpr int kSlotsLog2 = 13;
constexpr int kSlots = 1 << kSlotsLog2;
constexpr int kProbes = 4;
constexpr int kCacheBytes = 2 * kSlots * (int)sizeof(int);
constexpr int kGatherThreads = 1024;
constexpr int kGatherVecs = 2;      // int4 of keys per thread per step
constexpr int kWarpsPerSm = 64;     // 2048 resident threads
constexpr int kMinSmemWarps = 8;    // a private histogram's block: 256 to
constexpr int kMaxSmemWarps = 32;   // 1024 threads
constexpr int kMaxDevices = 64;
constexpr long long kMaxGridBlocks = 0x7fffffff;

// ---- the build ----

// Walks the rows in warp tiles of kBuildUnroll * 32 consecutive rows
// (each warp's kBuildUnroll coalesced loads of idx and of w in flight
// together) and calls add(bin, weight) for every live row: in range,
// weight nonzero.
template <typename Add>
__device__ __forceinline__ void for_each_live_row(const int* __restrict__ idx,
                                                  const int* __restrict__ w,
                                                  long long n, int n_bins,
                                                  Add add) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  constexpr long long kTile = kBuildUnroll * 32;
  for (long long t = (long long)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       t * kTile < n; t += warps) {
    int k[kBuildUnroll], v[kBuildUnroll];
#pragma unroll
    for (int u = 0; u < kBuildUnroll; ++u) {
      const long long i = t * kTile + u * 32 + lane;
      k[u] = -1;
      v[u] = 0;
      if (i < n) {
        k[u] = __ldcs(idx + i);
        v[u] = __ldcs(w + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBuildUnroll; ++u)
      if ((unsigned)k[u] < (unsigned)n_bins && v[u] != 0) add(k[u], v[u]);
  }
}

__global__ void __launch_bounds__(1024)
    bincount_smem_kernel(const int* __restrict__ idx,
                         const int* __restrict__ w, long long n,
                         int* __restrict__ out, int n_bins) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  for_each_live_row(idx, w, n, n_bins,
                    [&](int k, int v) { atomicAdd(&hist[k], v); });
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int v = hist[b];
    if (v != 0) atomicAdd(&out[b], v);
  }
}

// Adds v to bin k's slot of the block's cache; false when the bin has no
// slot within kProbes probes, and the caller then adds to device memory
// itself. Rows of one bin add to one shared-memory word, which the SM
// serializes far more cheaply than L2 does a device word.
__device__ __forceinline__ bool cache_add(int* keys, int* vals, int k,
                                          int v) {
  const unsigned h = ((unsigned)k * 0x9E3779B1u) >> (32 - kSlotsLog2);
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    const int s = (int)((h + p) & (kSlots - 1));
    int cur = *(volatile int*)&keys[s];
    if (cur == -1) {
      cur = atomicCAS(&keys[s], -1, k);
      if (cur == -1) cur = k;
    }
    if (cur == k) {
      atomicAdd(&vals[s], v);
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(kCacheThreads, 2)
    bincount_cached_kernel(const int* __restrict__ idx,
                           const int* __restrict__ w, long long n,
                           int* __restrict__ out, int n_bins) {
  extern __shared__ int cache[];
  int* keys = cache;
  int* vals = cache + kSlots;
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    keys[s] = -1;
    vals[s] = 0;
  }
  __syncthreads();
  for_each_live_row(idx, w, n, n_bins, [&](int k, int v) {
    if (!cache_add(keys, vals, k, v)) atomicAdd(&out[k], v);
  });
  __syncthreads();
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    const int k = keys[s];
    const int v = vals[s];
    if (k >= 0 && v != 0) atomicAdd(&out[k], v);
  }
}

// ---- the lookup ----

__device__ __forceinline__ int lookup(const int* __restrict__ t, int n_bins,
                                      int k) {
  return (unsigned)k < (unsigned)n_bins ? __ldg(t + k) : 0;
}

__device__ __forceinline__ int4 lookup4(const int* __restrict__ t,
                                        int n_bins, int4 k) {
  return make_int4(lookup(t, n_bins, k.x), lookup(t, n_bins, k.y),
                   lookup(t, n_bins, k.z), lookup(t, n_bins, k.w));
}

// keys + head and out + head are 16-byte aligned; head <= 3, head <= n.
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const int* __restrict__ t, int n_bins,
                  const int* __restrict__ keys, long long n, int head,
                  int* __restrict__ out) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (gtid < head) out[gtid] = lookup(t, n_bins, keys[gtid]);
  const long long n4 = (n - head) / 4;
  const int4* k4 = reinterpret_cast<const int4*>(keys + head);
  int4* o4 = reinterpret_cast<int4*>(out + head);
  for (long long v = gtid; v < n4; v += kGatherVecs * stride) {
    int4 k[kGatherVecs], r[kGatherVecs];
#pragma unroll
    for (int j = 0; j < kGatherVecs; ++j) {
      const long long vj = v + j * stride;
      k[j] = vj < n4 ? __ldcs(k4 + vj) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int j = 0; j < kGatherVecs; ++j)
      r[j] = lookup4(t, n_bins, k[j]);
#pragma unroll
    for (int j = 0; j < kGatherVecs; ++j) {
      const long long vj = v + j * stride;
      if (vj < n4) __stcs(o4 + vj, r[j]);
    }
  }
  const long long tail = head + n4 * 4;
  if (gtid < n - tail)
    out[tail + gtid] = lookup(t, n_bins, keys[tail + gtid]);
}

__device__ __forceinline__ int2 lookup_pair(const int2* __restrict__ t,
                                             int n_bins, int k) {
  return (unsigned)k < (unsigned)n_bins ? __ldg(t + k) : make_int2(0, 0);
}

// keys + head, oa + head and ob + head are 16-byte aligned; head <= 3,
// head <= n. t holds n_bins (a, b) pairs.
__global__ void __launch_bounds__(kGatherThreads)
    gather2_kernel(const int2* __restrict__ t, int n_bins,
                   const int* __restrict__ keys, long long n, int head,
                   int* __restrict__ oa, int* __restrict__ ob) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (gtid < head) {
    const int2 r = lookup_pair(t, n_bins, keys[gtid]);
    oa[gtid] = r.x;
    ob[gtid] = r.y;
  }
  const long long n4 = (n - head) / 4;
  const int4* k4 = reinterpret_cast<const int4*>(keys + head);
  int4* a4 = reinterpret_cast<int4*>(oa + head);
  int4* b4 = reinterpret_cast<int4*>(ob + head);
  for (long long v = gtid; v < n4; v += kGatherVecs * stride) {
    int4 k[kGatherVecs];
    int2 r[kGatherVecs][4];
#pragma unroll
    for (int j = 0; j < kGatherVecs; ++j) {
      const long long vj = v + j * stride;
      k[j] = vj < n4 ? __ldcs(k4 + vj) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int j = 0; j < kGatherVecs; ++j) {
      r[j][0] = lookup_pair(t, n_bins, k[j].x);
      r[j][1] = lookup_pair(t, n_bins, k[j].y);
      r[j][2] = lookup_pair(t, n_bins, k[j].z);
      r[j][3] = lookup_pair(t, n_bins, k[j].w);
    }
#pragma unroll
    for (int j = 0; j < kGatherVecs; ++j) {
      const long long vj = v + j * stride;
      if (vj < n4) {
        __stcs(a4 + vj, make_int4(r[j][0].x, r[j][1].x, r[j][2].x,
                                  r[j][3].x));
        __stcs(b4 + vj, make_int4(r[j][0].y, r[j][1].y, r[j][2].y,
                                  r[j][3].y));
      }
    }
  }
  const long long tail = head + n4 * 4;
  if (gtid < n - tail) {
    const int2 r = lookup_pair(t, n_bins, keys[tail + gtid]);
    oa[tail + gtid] = r.x;
    ob[tail + gtid] = r.y;
  }
}

// ---- launch configuration, read once per device ----

struct Device {
  bool ready;
  int smem_per_sm;     // shared memory of one SM
  int smem_reserved;   // what the runtime keeps per block
  // bincount_smem_kernel's blocks per SM by registers and threads alone,
  // by warps per block (kMinSmemWarps..kMaxSmemWarps)
  int occ_smem[kMaxSmemWarps + 1];
  int occ_cached;      // with its kCacheBytes of shared memory
};

Device g_devices[kMaxDevices];

cudaError_t occupancy(int* out, const void* fn, int threads, int smem) {
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, smem);
  if (*out < 1) *out = 1;
  return e;
}

cudaError_t device_info(const Device** out) {
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  if (d < 0 || d >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& dev = g_devices[d];
  if (!dev.ready) {
    int optin = 0;
    if ((e = cudaDeviceGetAttribute(&dev.smem_per_sm,
                                    cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    d)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&dev.smem_reserved,
                                    cudaDevAttrReservedSharedMemoryPerBlock,
                                    d)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, d)) !=
            cudaSuccess)
      return e;
    if (optin < kSmemMaxBins * (int)sizeof(int)) return cudaErrorInvalidValue;
    const void* smem_fns[] = {(const void*)bincount_smem_kernel,
                              (const void*)bincount_cached_kernel};
    for (const void* fn : smem_fns)
      if ((e = cudaFuncSetAttribute(
               fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
          cudaSuccess)
        return e;
    for (int warps = kMinSmemWarps; warps <= kMaxSmemWarps; ++warps)
      if ((e = occupancy(&dev.occ_smem[warps],
                         (const void*)bincount_smem_kernel, warps * 32, 0)) !=
          cudaSuccess)
        return e;
    if ((e = occupancy(&dev.occ_cached, (const void*)bincount_cached_kernel,
                       kCacheThreads, kCacheBytes)) != cudaSuccess)
      return e;
    dev.ready = true;
  }
  *out = &dev;
  return cudaSuccess;
}

// A block of `smem` dynamic bytes: the SM's warps shared among the
// blocks that fit it by shared memory, clamped to kMinSmemWarps..
// kMaxSmemWarps (__launch_bounds__(1024) keeps 1024 threads within the
// registers), so the SM holds close to 2048 threads wherever two or more
// blocks fit. Sets *threads and returns the blocks per SM.
int shared_memory_config(const Device& dev, int smem, int* threads) {
  int fit = dev.smem_per_sm / (smem + dev.smem_reserved);
  if (fit < 1) fit = 1;
  int warps = kWarpsPerSm / fit;
  if (warps < kMinSmemWarps) warps = kMinSmemWarps;
  if (warps > kMaxSmemWarps) warps = kMaxSmemWarps;
  *threads = warps * 32;
  return fit < dev.occ_smem[warps] ? fit : dev.occ_smem[warps];
}

int clamp_blocks(long long want, long long cap) {
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// Adds into out (n_bins int32s): every write to it, in both kernels, is an
// atomicAdd, so out may hold an earlier window's partial table (the
// huge-node window loops of ops/factorized.py); n >= 1, n_bins >= 1.
extern "C" int rhj_weighted_bincount(const int* idx, const int* w,
                                     long long n, int* out, int n_bins,
                                     int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Device* dev = nullptr;
  cudaError_t e = device_info(&dev);
  if (e != cudaSuccess) return (int)e;
  if (n_bins <= kSmemMaxBins) {
    const int smem = n_bins * (int)sizeof(int);
    int threads = 0;
    const int per_sm = shared_memory_config(*dev, smem, &threads);
    const int blocks = clamp_blocks(ceil_div(n, threads * kRowsPerThread),
                                    (long long)sm_count * per_sm);
    bincount_smem_kernel<<<blocks, threads, smem, s>>>(idx, w, n, out,
                                                       n_bins);
  } else {
    const int blocks =
        clamp_blocks(ceil_div(n, kCacheThreads * kRowsPerThread),
                     (long long)sm_count * dev->occ_cached);
    bincount_cached_kernel<<<blocks, kCacheThreads, kCacheBytes, s>>>(
        idx, w, n, out, n_bins);
  }
  return (int)cudaGetLastError();
}

// n >= 1, n_bins >= 1; out has the same address modulo 16 as keys.
extern "C" int rhj_table_gather(const int* table, int n_bins,
                                const int* keys, long long n, int* out,
                                int /*sm_count*/, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ka = reinterpret_cast<uintptr_t>(keys);
  if ((ka & 3) != 0 || (ka & 15) != (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  long long head = (long long)((16 - (ka & 15)) & 15) / 4;
  if (head > n) head = n;
  // one step of kGatherVecs int4 per thread: a full grid measured faster
  // than a persistent one (PERF.md)
  const int blocks = clamp_blocks(
      ceil_div(n, kGatherThreads * 4LL * kGatherVecs), kMaxGridBlocks);
  gather_kernel<<<blocks, kGatherThreads, 0, s>>>(table, n_bins, keys, n,
                                                  (int)head, out);
  return (int)cudaGetLastError();
}

// n >= 1, n_bins >= 1; pairs holds n_bins (a, b) int pairs, 8-byte
// aligned; oa and ob have the same address modulo 16 as keys.
extern "C" int rhj_table_gather2(const int* pairs, int n_bins,
                                 const int* keys, long long n, int* oa,
                                 int* ob, int /*sm_count*/, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ka = reinterpret_cast<uintptr_t>(keys);
  if ((reinterpret_cast<uintptr_t>(pairs) & 7) != 0 || (ka & 3) != 0 ||
      (ka & 15) != (reinterpret_cast<uintptr_t>(oa) & 15) ||
      (ka & 15) != (reinterpret_cast<uintptr_t>(ob) & 15))
    return (int)cudaErrorInvalidValue;
  long long head = (long long)((16 - (ka & 15)) & 15) / 4;
  if (head > n) head = n;
  const int blocks = clamp_blocks(
      ceil_div(n, kGatherThreads * 4LL * kGatherVecs), kMaxGridBlocks);
  gather2_kernel<<<blocks, kGatherThreads, 0, s>>>(
      reinterpret_cast<const int2*>(pairs), n_bins, keys, n, (int)head, oa,
      ob);
  return (int)cudaGetLastError();
}
