// Sort-join probe for Hopper (sm_90a): gather, search and scan in one pass.
//
// Plain C entry points, bound with ctypes by kernels.py like csrc/select.cu:
// every pointer is a device pointer owned by a PyTorch tensor, every launch
// goes on the caller's stream, nothing here allocates or synchronizes, and
// the entry returns the first CUDA error so a refused launch reaches the
// wrapper.
//
// rhj_probe — replaces no Pallas kernel: the JAX package's probe
//   (radixhashjoin_tpu/ops/join.py probe_count) is plain jnp, a sort of
//   both sides. The port ran it as ~15 PyTorch passes over the whole padded
//   left side (clamp, index_select, iota, mask, two searchsorted, a
//   subtraction, an int64 cumsum, an int64 subtraction, three casts), every
//   one over all L lanes whatever the live count. This kernel does the part
//   from the left gather to the total in one pass over the live lanes; the
//   right side's gather, sentinel mask and stable sort stay in PyTorch
//   (ops/join.py), since R is at most a dimension's bucket.
//   Semantics, bit for bit those of ops/join.py probe_count on the gathered
//   values: live = the device count *count when given, else host_count,
//   clamped to [0, n]. A live lane i reads its rowid rows[i], clamped to the
//   column's ends (an empty column reads 0), and its value v = col[rowid];
//   lo[i] = #(rs < v) and c_i = #(rs == v) in the sorted right values rs;
//   cum[i] = c_0 + ... + c_i and offsets[i] = cum[i] - c_i, both stored as
//   their low 32 bits (the plain version's int64 scan cast to int32). A lane
//   at or past the count reads nothing and gets what the plain version's -1
//   padding gets: lo = #(rs < -1) and c = #(rs == -1) (0 and 0 on the
//   catalog's data, which is >= 0). *total = the 64-bit sum of every c, or
//   -1 when it passes 2^31 - 1.
//   Bound on this card: bytes. The live lanes' rowids and values are read
//   once, and lo, offsets and cum written once over all n lanes: at 2^27
//   all-live lanes 5 x 512 MB, ~0.80 ms at 3.35 TB/s; where the count cuts,
//   the reads shrink with it. The search adds reads of the right side that
//   this bound does not count, and they, not the bytes, set the time: a
//   warp's load of 32 lanes' unrelated addresses costs the SM about one
//   cycle a lane (one cache line each), so the design counts such loads.
//   Design:
//   - one search a live lane: a lower bound for lo, then the end of v's run
//     from lo (one compare where the right keys are unique, galloping where
//     they repeat), the same integers as two binary searches;
//   - the top of the search in shared memory, as a breadth-first tree
//     (Eytzinger's layout; a step is a shared load, a compare and a
//     shift-add, and a warp's loads spread over the banks, where a sorted
//     array's binary search meets in one bank): up to kIndex values, rs
//     whole (R = 4,096: 16 KB, no load of the right side but the stage);
//     above that, every stride-th head of rs's 32-byte sectors (built by
//     probe_index_kernel, with the heads themselves when stride > 1). A
//     lane then reads one sector of heads (stride > 1) and one sector of
//     rs: at R = 2^20, two dependent reads of 32 bytes, four 16-byte loads;
//     the heads also tell whether v's run goes on past the sector;
//   - persistent blocks of 512 threads, 8 lanes a thread, two a SM (64
//     registers), stage that tree once and claim 4096-lane tiles from an
//     atomic counter; the scan is Merrill and Garland's decoupled
//     look-back, as in select.cu, with 64-bit tile sums (flag in the top
//     two bits of the status word), so the overflow test is on the true
//     total; tiles past the last live lane are never claimed by a live
//     tile's look-back and are skipped;
//   - each step of the search runs over all of a thread's lanes, without
//     branches, so their loads are in flight together;
//   - 16-byte loads of the rowids and stores of the outputs where aligned;
//   - the lanes past the count (lo, offsets, cum) and the total are written
//     by probe_fill_kernel, which reads the count and the live sum on the
//     device, so every output lane is written once and nothing is read back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 2;                  // int4 of lanes a thread holds
constexpr int kElems = kVecs * 4;         // lanes a thread holds
constexpr int kChunk = kThreads * 4;      // lanes of one chunk of int4
constexpr int kTile = kChunk * kVecs;     // 4096 lanes a tile
constexpr int kParts = kVecs * kWarps;    // (chunk, warp) counts a tile
static_assert(kParts <= 32, "one warp scans a tile's parts");
constexpr int kIndex = 16384;             // sorted values a block's tree holds
constexpr int kSector = 8;                // int32 values of a 32-byte sector
constexpr int kGroup = 8;                 // sector heads read as one sector
constexpr int kAuxThreads = 256;
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;

struct ProbeArgs {
  const int* col;        // left column
  long long col_len;
  const int* rows;       // left rowids, n lanes
  long long n;
  const int* count;      // nullptr: host_count
  long long host_count;
  const int* rs;         // sorted right values
  int r;                 // R
  const int* heads;      // rs[8 s], padded to kGroup with kIntMax (stride > 1)
  int n_heads;
  int stride;            // sector heads an index entry spans
  const int* index;      // sorted: rs (whole) or every stride-th head
  int n_index;
  int levels;            // the tree of index[1 ..): 2^levels - 1 nodes
  bool whole;            // the index is rs
  int* lo;
  int* offsets;
  int* cum;
  unsigned long long* status;
  unsigned int* tile_counter;
  unsigned long long* live_sum;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// p[i .. i + 3] as an int4 (lanes at or past lim are not read and read 0)
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

// The node (1-based, breadth first: Eytzinger's layout) of sorted position
// i in a perfect binary tree of `levels` levels. A search step is one shared
// load, one compare and one shift-add; the first steps read a few nodes near
// the root, each later one nodes of one level, so a warp's reads spread over
// the banks (a binary search of a sorted array reads, at each step, indices
// that share their low bits: one bank).
__device__ __forceinline__ int tree_node(int i, int levels) {
  const int j = i + 1;
  const int tz = __ffs(j) - 1;
  return (1 << (levels - 1 - tz)) + (j >> (tz + 1));
}

// The sorted position of the first value >= v, from the node k a search
// for v reached after `levels` steps (the node where it last went left), or
// n when it never went left; positions past n hold kIntMax and read as n.
__device__ __forceinline__ int tree_rank(int k, int levels, int n) {
  const int kk = k >> __ffs(~k);
  if (kk == 0) return n;
  const int d = 31 - __clz(kk);
  const int r = ((2 * (kk - (1 << d)) + 1) << (levels - 1 - d)) - 1;
  return r < n ? r : n;
}

__device__ __forceinline__ int below(int4 q, int v) {
  return (q.x < v) + (q.y < v) + (q.z < v) + (q.w < v);
}

__device__ __forceinline__ long long clamp_count(const int* count,
                                                 long long host_count,
                                                 long long n) {
  long long live = count != nullptr ? (long long)*count : host_count;
  return live < 0 ? 0 : (live > n ? n : live);
}

// The first index >= pos where a[i] != v, given a[pos ..) >= v (sorted):
// the end of v's run, galloping then halving.
__device__ int run_end(const int* a, int n, int pos, int v) {
  int step = 1;
  while (pos + step - 1 < n && a[pos + step - 1] == v) {
    pos += step;
    step <<= 1;
  }
  for (step >>= 1; step > 0; step >>= 1)
    if (pos + step - 1 < n && a[pos + step - 1] == v) pos += step;
  return pos;
}

// #(a[0 .. n) < v) in sorted a, by the whole warp: 32 probes a round.
__device__ long long warp_lower_bound(const int* a, long long n, int v) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long w = hi - lo;
    const long long p = lo + w * (lane + 1) / 32 - 1;
    const unsigned lt = __ballot_sync(0xffffffffu, a[p] < v);
    const int k = __popc(lt);  // a prefix of the lanes
    const long long base = lo;
    if (k < 32) hi = base + w * (k + 1) / 32 - 1;
    if (k > 0) lo = base + w * k / 32;
  }
  const bool lt = lo + lane < hi && a[lo + lane] < v;
  return lo + __popc(__ballot_sync(0xffffffffu, lt));
}

// The 32-byte sector at a[at .. at + 8) (32-byte aligned) as two int4, read
// by this thread and its neighbour (tid ^ 1) together: each 16-byte load
// instruction reads both halves of one of their two sectors, so a warp's
// instruction touches 16 sectors, not 32, and the halves swap by shuffle.
// Every thread of the warp calls it.
__device__ __forceinline__ void load_sector_pair(const int* a, int at,
                                                 int4& first, int4& second) {
  const int odd = threadIdx.x & 1;
  const int other = __shfl_xor_sync(0xffffffffu, at, 1);
  const int4* even_s = reinterpret_cast<const int4*>(a + (odd ? other : at));
  const int4* odd_s = reinterpret_cast<const int4*>(a + (odd ? at : other));
  const int4 x = __ldg(even_s + odd);  // the even thread's sector, one half
  const int4 y = __ldg(odd_s + odd);   // the odd thread's sector, one half
  const int4 give = odd ? x : y;       // the half the neighbour lacks
  int4 got;
  got.x = __shfl_xor_sync(0xffffffffu, give.x, 1);
  got.y = __shfl_xor_sync(0xffffffffu, give.y, 1);
  got.z = __shfl_xor_sync(0xffffffffu, give.z, 1);
  got.w = __shfl_xor_sync(0xffffffffu, give.w, 1);
  first = odd ? got : x;
  second = odd ? y : got;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

__device__ __forceinline__ long long warp_inclusive(long long x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// heads[s] = rs[8 s] for s < n_heads (kIntMax up to the padded end), and
// the shared-memory index: index[k] = rs[8 stride k]
__global__ void __launch_bounds__(kAuxThreads)
probe_index_kernel(const int* __restrict__ rs, int n_heads, int heads_pad,
                   int* __restrict__ heads, int stride, int n_index,
                   int* __restrict__ index) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long s = gid; s < heads_pad; s += step)
    heads[s] = s < n_heads ? rs[s * kSector] : kIntMax;
  for (long long k = gid; k < n_index; k += step)
    index[k] = rs[k * stride * kSector];
}

// Lanes [tile * kTile, ...) of the claimed tile; thread tid holds lanes
// tile * kTile + v * kChunk + tid * 4 + j (v < kVecs, j < 4) as element
// e = v * 4 + j, so each load and store instruction covers a warp's
// contiguous 512 bytes.
__global__ void __launch_bounds__(kThreads, 2)
probe_kernel(ProbeArgs a) {
  extern __shared__ int s_tree[];   // index[1 ..] as a tree, node 1 the root
  __shared__ long long s_base[kParts];  // counts before (chunk, warp)
  __shared__ long long s_prefix;                // counts before the tile
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tree = a.n_index > 0 ? a.n_index - 1 : 0;
  for (int i = tid; i < (1 << a.levels) - 1; i += kThreads)
    s_tree[tree_node(i, a.levels)] = i < n_tree ? a.index[i + 1] : kIntMax;
  const int first = a.n_index > 0 ? __ldg(a.index) : kIntMax;
  const long long live = clamp_count(a.count, a.host_count, a.n);
  // the tile holding the last live lane (tile 0 when none is live)
  const long long last = live > 0 ? (live - 1) / kTile : 0;
  const bool vec_rows = aligned16(a.rows);
  const bool vec_rs = aligned16(a.rs);

  while (true) {
    if (tid == 0) s_tile = (int)atomicAdd(a.tile_counter, 1u);
    __syncthreads();  // also orders the index staging before any search
    const long long tile = s_tile;
    if (tile > last) break;
    const long long t0 = tile * kTile;

    // the live lanes' values
    int val[kElems];
    unsigned keep = 0;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long i = t0 + (long long)v * kChunk + tid * 4;
      const int4 r4 = load4(a.rows, i, live, vec_rows);
      const int rid[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = i + j < live;
        keep |= (unsigned)in << (v * 4 + j);
        long long r = rid[j];
        r = r < 0 ? 0 : (r >= a.col_len ? a.col_len - 1 : r);
        val[v * 4 + j] = in && a.col_len > 0 ? __ldg(a.col + r) : 0;
      }
    }

    // Each step below runs over all of a thread's lanes before the next
    // step, without branches, so their loads are in flight together.
    // The shared-memory part of the search: pos = #(index < v).
    int pos[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) pos[e] = 1;
    for (int d = 0; d < a.levels; ++d) {
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        pos[e] = 2 * pos[e] + (s_tree[pos[e]] < val[e]);
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int t = tree_rank(pos[e], a.levels, n_tree);  // #(index[1 ..] < v)
      pos[e] = t > 0 ? t + 1 : (int)(first < val[e]);
    }

    // stride > 1: q = #(heads < v) from one sector of heads (past R = 2^20,
    // halving down to the sector first), and next = heads[q], the first
    // head >= v, where that sector holds it (else v)
    int next[kElems];
    if (!a.whole && a.stride > 1) {
      unsigned none = 0;  // lanes with q = 0: rs[0] >= v
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        none |= (unsigned)(pos[e] == 0) << e;
        pos[e] = max(pos[e] - 1, 0) * a.stride;  // heads[pos] < v
      }
      for (int step = a.stride >> 1; step >= kGroup; step >>= 1) {
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          const int p = pos[e] + step;
          const int s = __ldg(a.heads + min(p, a.n_heads - 1));
          if (p < a.n_heads && s < val[e]) pos[e] = p;
        }
      }
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const int gs = pos[e] & ~(kGroup - 1);
        int4 u, w;
        load_sector_pair(a.heads, gs, u, w);
        const int x = val[e];
        const int c = below(u, x) + below(w, x);
        const int h[kGroup] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
        int nx = x;
#pragma unroll
        for (int j = kGroup - 1; j >= 0; --j) nx = c == j ? h[j] : nx;
        next[e] = nx;
        pos[e] = (none >> e) & 1u ? 0 : gs + c;
      }
    }

    // lo (into pos) and the match count of each live lane: in the whole
    // case two compares from lo, else one sector of rs; `more` marks the
    // lanes whose run of equal values may go on past what was read
    int cnt[kElems];
    unsigned more = 0;
    if (a.whole) {
      const int end = max(a.r - 1, 0);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const int lo = pos[e], x = val[e];
        const int p0 = min(lo, end), p1 = min(lo + 1, end);
        const int s0 = p0 > 0 ? s_tree[tree_node(p0 - 1, a.levels)] : first;
        const int s1 = p1 > 0 ? s_tree[tree_node(p1 - 1, a.levels)] : first;
        const bool m0 = ((keep >> e) & 1u) && lo < a.r && s0 == x;
        const bool m1 = m0 && lo + 1 < a.r && s1 == x;
        cnt[e] = (int)m0 + (int)m1;
        more |= (unsigned)(m1 && lo + 2 < a.r) << e;
      }
    } else {
      const bool vec = vec_rs && (a.r & (kSector - 1)) == 0;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const int q = pos[e], x = val[e];
        const int base = max(q - 1, 0) * kSector;  // rs[base] < x if q > 0
        int s[kSector];
        if (vec) {
          int4 u, w;
          load_sector_pair(a.rs, base, u, w);
          s[0] = u.x; s[1] = u.y; s[2] = u.z; s[3] = u.w;
          s[4] = w.x; s[5] = w.y; s[6] = w.z; s[7] = w.w;
        } else {
#pragma unroll
          for (int j = 0; j < kSector; ++j)
            s[j] = base + j < a.r ? __ldg(a.rs + base + j) : kIntMax;
        }
        int lt = 0, eq = 0;
#pragma unroll
        for (int j = 0; j < kSector; ++j) {
          lt += s[j] < x;
          eq += s[j] == x && base + j < a.r;
        }
        const int lo = q > 0 ? base + lt : 0;
        const int hi = q > 0 ? lo + eq : 0;
        const bool in = (keep >> e) & 1u;
        pos[e] = lo;
        cnt[e] = in ? hi - lo : 0;
        // the run goes on past the sector read only if the next sector's
        // head is v too (when the group of heads told it)
        const bool maybe = a.stride == 1 || next[e] == x;
        more |= (unsigned)(in && hi == (q > 0 ? base + kSector : 0) &&
                           hi < a.r && maybe) << e;
      }
    }
    if (more) {
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        if ((more >> e) & 1u)
          cnt[e] = run_end(a.rs, a.r, pos[e] + cnt[e], val[e]) - pos[e];
    }

    // the tile's inclusive scan: each thread's 4 lanes a chunk, the warp's
    // threads, the (chunk, warp) totals
    long long wex[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long x = (long long)cnt[v * 4] + cnt[v * 4 + 1] +
                          cnt[v * 4 + 2] + cnt[v * 4 + 3];
      const long long inc = warp_inclusive(x, lane);
      wex[v] = inc - x;
      if (lane == 31) s_base[v * kWarps + warp] = inc;
    }
    __syncthreads();

    if (warp == 0) {
      const long long x = lane < kParts ? s_base[lane] : 0;
      const long long inc = warp_inclusive(x, lane);
      if (lane < kParts) s_base[lane] = inc - x;
      const unsigned long long tile_sum =
          (unsigned long long)__shfl_sync(0xffffffffu, inc, 31);
      if (lane == 0)
        store_status(a.status + tile,
                     (tile == 0 ? kPrefix : kAggregate) | tile_sum);
      // decoupled look-back: the aggregates back to the nearest prefix
      unsigned long long prefix = 0;
      for (long long pred = tile - 1; pred >= 0; pred -= 32) {
        const long long idx = pred - lane;
        unsigned long long s = kPrefix;  // before tile 0: prefix 0
        if (idx >= 0) {
          do {
            s = load_status(a.status + idx);
          } while ((s >> 62) == 0);
        }
        const unsigned done = __ballot_sync(0xffffffffu, (s >> 62) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        prefix += warp_sum(lane <= stop ? (s & kValueMask) : 0ull);
        if (done) break;
      }
      if (lane == 0) {
        if (tile > 0) store_status(a.status + tile, kPrefix | (prefix + tile_sum));
        s_prefix = (long long)prefix;
        if (tile == last) *a.live_sum = prefix + tile_sum;
      }
    }
    __syncthreads();

    // lo, offsets and cum of the live lanes
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long i = t0 + (long long)v * kChunk + tid * 4;
      long long run = s_prefix + s_base[v * kWarps + warp] + wex[v];
      int o[4], c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = (int)(unsigned)run;
        run += cnt[v * 4 + j];
        c[j] = (int)(unsigned)run;
      }
      if (i + 4 <= live) {  // the outputs are 16-byte aligned
        *reinterpret_cast<int4*>(a.lo + i) =
            make_int4(pos[v * 4], pos[v * 4 + 1], pos[v * 4 + 2],
                      pos[v * 4 + 3]);
        *reinterpret_cast<int4*>(a.offsets + i) =
            make_int4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<int4*>(a.cum + i) = make_int4(c[0], c[1], c[2], c[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (i + j < live) {
            a.lo[i + j] = pos[v * 4 + j];
            a.offsets[i + j] = o[j];
            a.cum[i + j] = c[j];
          }
        }
      }
    }
    __syncthreads();  // s_tile, s_base and s_prefix are reused
  }
}

// Lanes [live, n) of lo, offsets and cum, as the plain version's -1
// padding gives them, and *total; block 0 writes the total.
__global__ void __launch_bounds__(kAuxThreads)
probe_fill_kernel(const int* __restrict__ count, long long host_count,
                  long long n, const int* __restrict__ rs, int r,
                  int* __restrict__ lo, int* __restrict__ offsets,
                  int* __restrict__ cum, int* __restrict__ total,
                  const unsigned long long* __restrict__ live_sum) {
  __shared__ long long s_dead[2];
  const long long live = clamp_count(count, host_count, n);
  const long long sum = (long long)*live_sum;
  long long dead_lo = 0, dead_cnt = 0;
  if (live < n) {  // the same for every thread of the block
    if (threadIdx.x < 64) {
      const long long b = warp_lower_bound(rs, r, threadIdx.x < 32 ? -1 : 0);
      if ((threadIdx.x & 31) == 0) s_dead[threadIdx.x >> 5] = b;
    }
    __syncthreads();
    dead_lo = s_dead[0];
    dead_cnt = s_dead[1] - s_dead[0];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long t = sum + (n - live) * dead_cnt;
    *total = t > kIntMax ? -1 : (int)t;
  }
  // lanes [live, body) and [end, n) one by one, [body, end) as int4 (the
  // outputs are 16-byte aligned)
  long long body = (live + 3) & ~3LL;
  if (body > n) body = n;
  const long long end = body > (n & ~3LL) ? body : (n & ~3LL);
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int dlo = (int)dead_lo;
  auto put = [&](long long i) {
    const long long before = sum + (i - live) * dead_cnt;
    lo[i] = dlo;
    offsets[i] = (int)(unsigned)before;
    cum[i] = (int)(unsigned)(before + dead_cnt);
  };
  if (gid < body - live) put(live + gid);
  if (gid < n - end) put(end + gid);
  int4* __restrict__ lo4 = reinterpret_cast<int4*>(lo);
  int4* __restrict__ off4 = reinterpret_cast<int4*>(offsets);
  int4* __restrict__ cum4 = reinterpret_cast<int4*>(cum);
  const int4 l4 = make_int4(dlo, dlo, dlo, dlo);
  if (dead_cnt == 0) {  // the catalog's data: offsets = cum = the live sum
    const int o = (int)(unsigned)sum;
    const int4 o4 = make_int4(o, o, o, o);
    for (long long q = body / 4 + gid; q < end / 4; q += stride) {
      __stcs(lo4 + q, l4);
      __stcs(off4 + q, o4);
      __stcs(cum4 + q, o4);
    }
    return;
  }
  for (long long q = body / 4 + gid; q < end / 4; q += stride) {
    const long long before = sum + (q * 4 - live) * dead_cnt;
    int o[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) o[j] = (int)(unsigned)(before + j * dead_cnt);
    __stcs(lo4 + q, l4);
    __stcs(off4 + q, make_int4(o[0], o[1], o[2], o[3]));
    __stcs(cum4 + q, make_int4(o[1], o[2], o[3], o[4]));
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

struct Layout {
  long long tiles;
  long long status_bytes;  // tile counter, live sum, one status a tile
  bool whole;
  long long n_heads, heads_pad, stride, n_index;
  long long heads_at, index_at;  // byte offsets in the scratch
  long long bytes;
};

Layout layout(long long n, long long r) {
  Layout l{};
  l.tiles = ceil_div(n, kTile);
  l.status_bytes = 16 + 8 * l.tiles;
  l.whole = r <= kIndex;
  l.bytes = l.status_bytes;
  if (!l.whole) {
    l.n_heads = ceil_div(r, kSector);
    l.stride = 1;
    while (ceil_div(l.n_heads, l.stride) > kIndex) l.stride *= 2;
    l.n_index = ceil_div(l.n_heads, l.stride);
    l.heads_pad = l.stride > 1 ? ceil_div(l.n_heads, kGroup) * kGroup : 0;
    l.heads_at = ceil_div(l.status_bytes, 64) * 64;
    l.index_at = l.heads_at + 4 * l.heads_pad;
    l.bytes = l.index_at + 4 * l.n_index;
  }
  return l;
}

// Blocks of probe_kernel one SM holds with `smem` bytes of shared memory
// (the last answer kept: one launch after another asks the same).
int probe_blocks_per_sm(int smem) {
  static int last_smem = -1, last_blocks = 1;
  if (smem != last_smem) {
    int b = 0;
    if (cudaFuncSetAttribute(probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kIndex * 4) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, probe_kernel,
                                                      kThreads, smem) !=
            cudaSuccess ||
        b < 1)
      b = 1;
    last_smem = smem;
    last_blocks = b;
  }
  return last_blocks;
}

}  // namespace

// Scratch bytes rhj_probe needs for n left lanes and r right values (-1
// when out of range).
extern "C" long long rhj_probe_scratch_bytes(long long n, long long r) {
  if (n < 1 || n > kIntMax || r < 0 || r > kIntMax) return -1;
  return layout(n, r).bytes;
}

// n >= 1 left lanes (< 2^31); col int32[col_len]; rows int32[n]; count:
// nullptr (host_count, already in [0, n]) or one int32 on the device; rs
// int32[r], sorted; lo, offsets, cum int32[n], 16-byte aligned; total one
// int32; scratch rhj_probe_scratch_bytes(n, r) bytes, 64-byte aligned
// (its status words are zeroed here).
extern "C" int rhj_probe(const int* col, long long col_len, const int* rows,
                         long long n, const int* count, long long host_count,
                         const int* rs, long long r, int* lo, int* offsets,
                         int* cum, int* total, void* scratch, int sm_count,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kIntMax || r < 0 || r > kIntMax || col_len < 0 ||
      (reinterpret_cast<uintptr_t>(col) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(rows) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(rs) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(lo) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(offsets) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(cum) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 63) != 0 || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(n, r);
  char* base = static_cast<char*>(scratch);
  ProbeArgs a{};
  a.col = col;
  a.col_len = col_len;
  a.rows = rows;
  a.n = n;
  a.count = count;
  a.host_count = host_count;
  a.rs = rs;
  a.r = (int)r;
  a.whole = l.whole;
  a.lo = lo;
  a.offsets = offsets;
  a.cum = cum;
  a.tile_counter = reinterpret_cast<unsigned int*>(base);
  a.live_sum = reinterpret_cast<unsigned long long*>(base + 8);
  a.status = reinterpret_cast<unsigned long long*>(base + 16);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)l.status_bytes, st);
  if (e != cudaSuccess) return (int)e;
  if (l.whole) {
    a.index = rs;
    a.n_index = (int)r;
    a.stride = 1;
  } else {
    int* heads = reinterpret_cast<int*>(base + l.heads_at);
    int* index = reinterpret_cast<int*>(base + l.index_at);
    a.heads = heads;
    a.n_heads = (int)l.n_heads;
    a.stride = (int)l.stride;
    a.index = index;
    a.n_index = (int)l.n_index;
    const long long work = l.heads_pad > l.n_index ? l.heads_pad : l.n_index;
    const long long blocks = ceil_div(work, kAuxThreads);
    const long long cap = (long long)sm_count * 8;
    probe_index_kernel<<<(unsigned)(blocks < cap ? blocks : cap), kAuxThreads,
                         0, st>>>(rs, (int)l.n_heads, (int)l.heads_pad, heads,
                                  (int)l.stride, (int)l.n_index, index);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  a.levels = 0;
  while ((1LL << a.levels) - 1 < (long long)a.n_index - 1) ++a.levels;
  const int smem = 4 << a.levels;
  const long long cap = (long long)sm_count * probe_blocks_per_sm(smem);
  probe_kernel<<<(unsigned)(l.tiles < cap ? l.tiles : cap), kThreads, smem,
                 st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long fill = ceil_div(n, kAuxThreads * 4LL * 4);
  const long long fill_cap = (long long)sm_count * 8;
  probe_fill_kernel<<<(unsigned)(fill < fill_cap ? fill : fill_cap),
                      kAuxThreads, 0, st>>>(count, host_count, n, rs, (int)r,
                                            lo, offsets, cum, total,
                                            a.live_sum);
  return (int)cudaGetLastError();
}
