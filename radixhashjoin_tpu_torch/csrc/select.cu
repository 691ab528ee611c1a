// Conjunctive select with stable compaction for Hopper (sm_90a).
//
// Plain C entry point, bound with ctypes by kernels.py like
// csrc/tables.cu and csrc/radix.cu: every pointer is a device pointer
// owned by a PyTorch tensor (the predicate arrays excepted: host arrays
// the entry copies into the launch's parameters), every launch goes on the
// caller's stream, nothing here allocates or synchronizes, and the entry
// returns the first CUDA error so a refused launch reaches the wrapper.
//
// rhj_select — replaces no Pallas kernel: the JAX package's filters
//   (radixhashjoin_tpu/ops/filter.py filter_full / filter_live) and their
//   compaction (radixhashjoin_tpu/ops/compact.py) are plain jnp. The port
//   ran them as ~16 PyTorch passes a predicate over the slot's whole
//   padded bucket (iota, compare, mask, int32 cumsum, wheres, zero fill,
//   int64 casts, an int64-index scatter), one full sweep per predicate;
//   this kernel folds up to kMaxPreds predicates into one pass.
//   Semantics: the live set is lanes [0, live) of either the identity
//   (rows == nullptr: lane i is rowid i, each column read at i) or of the
//   int32 rowids `rows` (each column read at its rowid, clamped to the
//   column's ends; an empty column reads 0); live = the device count
//   *count when given, else host_count, clamped to [0, n]. A live lane
//   survives when every predicate (column, op, constant) holds, op one of
//   OP_EQ / OP_LT / OP_GT on int32 values. out[0, pad) receives the
//   survivors' rowids in lane order, then zeros; survivors past pad are
//   cut. *count_out = the number of survivors (cut ones included). Both
//   stay on the device: nothing is read back.
//   Bound on this card: bytes. Each distinct column is read once over the
//   live lanes (two predicates on one column, a BETWEEN, read it once),
//   the rowids once when given, and the pad output lanes are written once:
//   with two columns on the identity at 2^27 lanes, 2 x 512 MB + 512 MB,
//   ~0.48 ms at 3.35 TB/s. Design:
//   - one pass, Merrill and Garland's decoupled look-back: each block
//     claims the next tile of kTile lanes from an atomic counter (tiles
//     start in claim order, so a tile only ever waits on tiles that are
//     already running), publishes its survivor count as an aggregate at
//     once, and its warp 0 sums its predecessors' aggregates back to the
//     nearest inclusive prefix, 32 tiles a step, then publishes its own;
//     a status word packs flag and value in 64 bits, so one load reads
//     both;
//   - 16-byte loads of columns and rowids where the pointer is 16-byte
//     aligned (scalar loads of the same lanes otherwise, and at the ragged
//     end); a thread holds kVecs int4 of lanes, chunk-major so each load
//     instruction covers a warp's contiguous 512 bytes;
//   - ranks from ballots and popc within a warp, the warps' and chunks'
//     32 counts scanned by one warp; survivors are staged in shared memory
//     in lane order and written contiguously, so the block's stores
//     coalesce whatever its selectivity;
//   - tiles wholly past the live count exit at once (no live tile looks
//     back at them); the tile holding the last live lane writes the count;
//   - the zeros past the survivors, which only the last live tile's
//     prefix places, are written by a second small kernel that reads the
//     count on the device (16-byte stores), so every output lane is
//     written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kernels.py mirrors kMaxPreds (SELECT_MAX_PREDS) and kTile (SELECT_TILE)
constexpr int kMaxPreds = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                  // int4 of lanes a thread holds
constexpr int kElems = kVecs * 4;         // lanes a thread holds
constexpr int kChunk = kThreads * 4;      // lanes of one chunk of int4
constexpr int kTile = kChunk * kVecs;     // 4096 lanes a tile
constexpr int kFillThreads = 256;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

enum { OP_EQ = 0, OP_LT = 1, OP_GT = 2 };  // ops/filter.py OP_CODE

struct SelectArgs {
  const int* cols[kMaxPreds];  // distinct columns
  long long col_len[kMaxPreds];
  int n_cols;
  int pred_col[kMaxPreds];  // index into cols
  int pred_op[kMaxPreds];
  int pred_val[kMaxPreds];
  int n_preds;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// p[i .. i + 3] as an int4 (lanes at or past lim are not read and read 0);
// i is a multiple of 4, so `vec` (p 16-byte aligned) makes p + i aligned.
__device__ __forceinline__ int4 load4(const int* __restrict__ p, long long i,
                                      long long lim, bool vec) {
  if (vec && i + 4 <= lim) return __ldcs(reinterpret_cast<const int4*>(p + i));
  int4 r = make_int4(0, 0, 0, 0);
  if (i < lim) r.x = __ldcs(p + i);
  if (i + 1 < lim) r.y = __ldcs(p + i + 1);
  if (i + 2 < lim) r.z = __ldcs(p + i + 2);
  if (i + 3 < lim) r.w = __ldcs(p + i + 3);
  return r;
}

__device__ __forceinline__ void put4(int (&v)[kElems], int at, int4 q) {
  v[at] = q.x;
  v[at + 1] = q.y;
  v[at + 2] = q.z;
  v[at + 3] = q.w;
}

// bit e set where v[e] op k holds
__device__ __forceinline__ unsigned pass_mask(const int (&v)[kElems], int op,
                                              int k) {
  unsigned m = 0;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const bool b = op == OP_EQ ? v[e] == k : (op == OP_LT ? v[e] < k
                                                          : v[e] > k);
    m |= (unsigned)b << e;
  }
  return m;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Lanes [tile * kTile, ...) of this block; thread tid holds lanes
// tile * kTile + v * kChunk + tid * 4 + j (v < kVecs, j < 4) as element
// e = v * 4 + j.
__global__ void __launch_bounds__(kThreads)
select_kernel(const int* __restrict__ rows, long long n,
              const int* __restrict__ count, long long host_count,
              SelectArgs a, int* __restrict__ out, long long pad,
              int* __restrict__ count_out,
              unsigned long long* __restrict__ status,
              unsigned int* __restrict__ tile_counter) {
  __shared__ int s_tile;
  __shared__ int s_base[kVecs * kWarps];  // survivors before (chunk, warp)
  __shared__ int s_prefix;                // survivors before the tile
  __shared__ int s_count;                 // the tile's survivors
  __shared__ int s_buf[kTile];            // the tile's survivors, in order
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  long long live = count != nullptr ? (long long)*count : host_count;
  live = live < 0 ? 0 : (live > n ? n : live);
  // the tile holding the last live lane (tile 0 when none is live)
  const long long last = live > 0 ? (live - 1) / kTile : 0;
  if (tile > last) return;
  const long long t0 = tile * kTile;

  // live lanes of this thread, and its rowids
  unsigned keep = 0;
  int rid[kElems];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const long long i = t0 + (long long)v * kChunk + tid * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      keep |= (unsigned)(i + j < live) << (v * 4 + j);
    if (rows != nullptr) {
      put4(rid, v * 4, load4(rows, i, live, aligned16(rows)));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) rid[v * 4 + j] = (int)(i + j);
    }
  }

  // each distinct column once, then every predicate on it
#pragma unroll
  for (int c = 0; c < kMaxPreds; ++c) {
    if (c < a.n_cols) {
      const int* __restrict__ col = a.cols[c];
      int val[kElems];
      if (rows == nullptr) {
        const bool vec = aligned16(col);
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
          put4(val, v * 4,
               load4(col, t0 + (long long)v * kChunk + tid * 4, live, vec));
      } else {
        const long long len = a.col_len[c];
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          int x = 0;
          if (((keep >> e) & 1u) && len > 0) {
            long long r = rid[e];
            r = r < 0 ? 0 : (r >= len ? len - 1 : r);
            x = __ldg(col + r);
          }
          val[e] = x;
        }
      }
#pragma unroll
      for (int p = 0; p < kMaxPreds; ++p) {
        if (p < a.n_preds && a.pred_col[p] == c)
          keep &= pass_mask(val, a.pred_op[p], a.pred_val[p]);
      }
    }
  }

  // ranks within the warp's chunks; the 32 (chunk, warp) counts to scan
  const unsigned below_mask = (1u << lane) - 1u;
  int rank[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    int below = 0, total = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, (keep >> (v * 4 + j)) & 1u);
      below += __popc(b & below_mask);
      total += __popc(b);
    }
    rank[v] = below;
    if (lane == 0) s_base[v * kWarps + warp] = total;
  }
  __syncthreads();

  int tile_count = 0;
  if (warp == 0) {
    const int x = s_base[lane];
    int inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    s_base[lane] = inc - x;
    tile_count = __shfl_sync(0xffffffffu, inc, 31);
    if (lane == 0) s_count = tile_count;
    if (lane == 0)
      store_status(status + tile, (tile == 0 ? kPrefix : kAggregate) |
                                      (unsigned)tile_count);
  }
  __syncthreads();

  if (warp == 0) {
    // decoupled look-back: the aggregates back to the nearest prefix
    unsigned prefix = 0;
    for (long long pred = tile - 1; pred >= 0; pred -= 32) {
      const long long idx = pred - lane;
      unsigned long long s = kPrefix;  // before tile 0: prefix 0
      if (idx >= 0) {
        do {
          s = load_status(status + idx);
        } while ((s >> 32) == 0);
      }
      const unsigned done = __ballot_sync(0xffffffffu, (s >> 32) == 2);
      const int stop = done ? __ffs(done) - 1 : 31;
      prefix += __reduce_add_sync(0xffffffffu,
                                  lane <= stop ? (unsigned)s : 0u);
      if (done) break;
    }
    if (lane == 0) {
      if (tile > 0)
        store_status(status + tile, kPrefix | (prefix + (unsigned)tile_count));
      s_prefix = (int)prefix;
      if (tile == last) *count_out = (int)prefix + tile_count;
    }
  }

  // stage the survivors in lane order
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    int at = s_base[v * kWarps + warp] + rank[v];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((keep >> (v * 4 + j)) & 1u) s_buf[at++] = rid[v * 4 + j];
    }
  }
  __syncthreads();

  const long long from = s_prefix;
  const int total = s_count;
  for (int i = tid; i < total; i += kThreads) {
    const long long o = from + i;
    if (o < pad) out[o] = s_buf[i];
  }
}

// out[min(*count, pad), pad) = 0: the lanes past the survivors
__global__ void __launch_bounds__(kFillThreads)
select_fill_kernel(int* __restrict__ out, long long pad,
                   const int* __restrict__ count) {
  long long start = *count;
  start = start < 0 ? 0 : (start > pad ? pad : start);
  // out is 16-byte aligned: lanes [start, body) and [end, pad) one by one
  long long body = (start + 3) & ~3LL;
  if (body > pad) body = pad;
  const long long end = body > (pad & ~3LL) ? body : (pad & ~3LL);
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (gid < body - start) out[start + gid] = 0;
  if (gid < pad - end) out[end + gid] = 0;
  int4* __restrict__ out4 = reinterpret_cast<int4*>(out);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (long long q = body / 4 + gid; q < end / 4; q += stride)
    __stcs(out4 + q, zero);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// n >= 1 lanes (< 2^31); rows: nullptr (the identity) or int32[n]; count:
// nullptr (host_count, already in [0, n]) or one int32 on the device;
// cols[c] int32[col_len[c]] (the identity needs col_len[c] >= n);
// pred_col / pred_op / pred_val host arrays of n_preds; out int32[pad],
// 16-byte aligned when pad > 0; count_out one int32; scratch at least
// (ceil(n / kTile) + 1) * 8 bytes, 8-byte aligned (zeroed here).
extern "C" int rhj_select(const int* rows, long long n, const int* count,
                          long long host_count, const long long* col_addrs,
                          const long long* col_lens, int n_cols,
                          const int* pred_col, const int* pred_op,
                          const int* pred_val, int n_preds, int* out,
                          long long pad, int* count_out, void* scratch,
                          int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 0x7fffffffLL || pad < 0 || n_cols < 1 ||
      n_cols > kMaxPreds || n_preds < 1 || n_preds > kMaxPreds ||
      (pad > 0 && (reinterpret_cast<uintptr_t>(out) & 15) != 0) ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  SelectArgs a{};
  a.n_cols = n_cols;
  a.n_preds = n_preds;
  for (int c = 0; c < n_cols; ++c) {
    a.cols[c] = reinterpret_cast<const int*>(col_addrs[c]);
    a.col_len[c] = col_lens[c];
    if ((col_addrs[c] & 3) != 0 || col_lens[c] < 0 ||
        (rows == nullptr && col_lens[c] < n))
      return (int)cudaErrorInvalidValue;
  }
  for (int p = 0; p < n_preds; ++p) {
    if (pred_col[p] < 0 || pred_col[p] >= n_cols || pred_op[p] < OP_EQ ||
        pred_op[p] > OP_GT)
      return (int)cudaErrorInvalidValue;
    a.pred_col[p] = pred_col[p];
    a.pred_op[p] = pred_op[p];
    a.pred_val[p] = pred_val[p];
  }
  const long long tiles = ceil_div(n, kTile);
  unsigned int* counter = static_cast<unsigned int*>(scratch);
  unsigned long long* status = static_cast<unsigned long long*>(scratch) + 1;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * 8, s);
  if (e != cudaSuccess) return (int)e;
  select_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      rows, n, count, host_count, a, out, pad, count_out, status, counter);
  e = cudaGetLastError();
  if (e != cudaSuccess || pad == 0) return (int)e;
  const long long blocks = ceil_div(pad, kFillThreads * 4LL * 4);
  const long long cap = (long long)sm_count * 8;
  select_fill_kernel<<<(unsigned)(blocks < cap ? blocks : cap),
                       kFillThreads, 0, s>>>(out, pad, count_out);
  return (int)cudaGetLastError();
}
