// rhj_host: native host runtime of radixhashjoin_tpu_torch (counterpart:
// radixhashjoin_tpu/runtime/native/rhj_host.cpp; built at first use by
// runtime/native.py with the host C++ compiler).
//
// The reference's host-side substrate:
//   * columnar relation loader (mmap, header validation) with multithreaded
//     per-column stats — reference: relList ctor, structs.cpp:17-63, but
//     distinct counting is sort-based (no dense bitmap memory bomb,
//     SURVEY.md quirk 8.6) and the stats scan parallelizes per column.
//   * workload parser: "tables|predicates|projections" lines, `F` batch
//     terminator — reference: Query.cpp:10-63 — emitted as a flat int64
//     tape for zero-copy transfer to Python.
//   * result formatter: sums / NULL lines — reference: Query.cpp:226-235.
//
// C ABI throughout (ctypes-friendly); no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct rhj_relation {
  uint64_t num_tuples;
  uint64_t num_columns;
  const uint64_t* data;   // column-major, num_columns * num_tuples
  void* map_base;         // private
  uint64_t map_len;       // private
};

// Open + validate a binary relation file. Returns 0 on success.
int rhj_open(const char* path, rhj_relation* out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return -2; }
  if (st.st_size < 16) { ::close(fd); return -3; }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return -4;
  const uint64_t* words = (const uint64_t*)base;
  uint64_t t = words[0], c = words[1];
  // size contract: (t*c + 2) * 8 bytes (structs.cpp:30)
  if ((uint64_t)st.st_size != (t * c + 2) * 8) {
    munmap(base, (size_t)st.st_size);
    return -5;
  }
  out->num_tuples = t;
  out->num_columns = c;
  out->data = words + 2;
  out->map_base = base;
  out->map_len = (uint64_t)st.st_size;
  return 0;
}

void rhj_close(rhj_relation* rel) {
  if (rel->map_base) munmap(rel->map_base, (size_t)rel->map_len);
  rel->map_base = nullptr;
  rel->data = nullptr;
}

// Per-column stats: min, max, exact distinct (sort-based). One thread per
// column, however many columns (as in the JAX package's copy, whose comment
// says "up to the hardware limit"); serial on a one-core host. The parallel
// analog of the reference's serial load-time scans (structs.cpp:40-61).
void rhj_stats(const rhj_relation* rel, uint64_t* out_min, uint64_t* out_max,
               uint64_t* out_distinct) {
  uint64_t t = rel->num_tuples, c = rel->num_columns;
  auto one = [&](uint64_t col) {
    const uint64_t* v = rel->data + col * t;
    if (t == 0) { out_min[col] = out_max[col] = out_distinct[col] = 0; return; }
    uint64_t mn = v[0], mx = v[0];
    for (uint64_t i = 1; i < t; i++) {
      if (v[i] < mn) mn = v[i];
      if (v[i] > mx) mx = v[i];
    }
    std::vector<uint64_t> s(v, v + t);
    std::sort(s.begin(), s.end());
    uint64_t d = 1;
    for (uint64_t i = 1; i < t; i++) d += (s[i] != s[i - 1]);
    out_min[col] = mn;
    out_max[col] = mx;
    out_distinct[col] = d;
  };
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  if (c <= 1 || hw <= 1) {
    for (uint64_t col = 0; col < c; col++) one(col);
    return;
  }
  std::vector<std::thread> ts;
  for (uint64_t col = 0; col < c; col++) ts.emplace_back(one, col);
  for (auto& th : ts) th.join();
}

// ---- workload parser ----
//
// Tape encoding per query (int64 words):
//   n_slots, slots...,
//   n_joins,  (s1, c1, s2, c2)...,          // written order preserved
//   n_filters, (slot, col, op, value)...,   // op: 0 '=', 1 '<', 2 '>'
//   n_projs,  (slot, col)...
// A query ends there; a batch boundary is the single word -1; tape ends
// with -2. A number is a u64 (a filter value past 2^63 rides the tape as
// its two's-complement bit pattern); one past 2^64 - 1 is a parse error.
// Returns number of words written, or -(needed) if cap is too small, or 0
// on parse error.
long long rhj_parse_work(const char* text, long long* tape, long long cap) {
  std::vector<long long> out;
  const char* p = text;
  auto skip_ws = [&]() { while (*p == ' ' || *p == '\t') p++; };
  auto read_u64 = [&](long long* val) -> bool {
    skip_ws();
    if (*p < '0' || *p > '9') return false;
    unsigned long long v = 0;
    while (*p >= '0' && *p <= '9') {
      unsigned long long d = (unsigned long long)(*p++ - '0');
      if (v > (~0ULL - d) / 10) return false;
      v = v * 10 + d;
    }
    *val = (long long)v;
    return true;
  };
  while (*p) {
    if (*p == '\n') { p++; continue; }
    if (*p == 'F' && (p[1] == '\n' || p[1] == '\0')) {
      out.push_back(-1);
      p += (p[1] == '\n') ? 2 : 1;
      continue;
    }
    // tables
    std::vector<long long> slots;
    long long v;
    while (read_u64(&v)) slots.push_back(v);
    if (*p != '|') return 0;
    p++;
    out.push_back((long long)slots.size());
    out.insert(out.end(), slots.begin(), slots.end());
    // predicates: '&'-separated; join if rhs contains '.', else filter
    std::vector<long long> joins, filters;
    while (*p && *p != '|' && *p != '\n') {
      long long s1, c1;
      if (!read_u64(&s1) || *p++ != '.' || !read_u64(&c1)) return 0;
      skip_ws();
      char opc = *p;
      if (opc != '=' && opc != '<' && opc != '>') return 0;
      p++;
      long long a;
      if (!read_u64(&a)) return 0;
      if (*p == '.') {  // join: comparator char ignored (Query.cpp:46-48)
        p++;
        long long c2;
        if (!read_u64(&c2)) return 0;
        joins.insert(joins.end(), {s1, c1, a, c2});
      } else {
        long long op = (opc == '=') ? 0 : (opc == '<') ? 1 : 2;
        filters.insert(filters.end(), {s1, c1, op, a});
      }
      skip_ws();
      if (*p == '&') p++;
    }
    if (*p != '|') return 0;
    p++;
    out.push_back((long long)joins.size() / 4);
    out.insert(out.end(), joins.begin(), joins.end());
    out.push_back((long long)filters.size() / 4);
    out.insert(out.end(), filters.begin(), filters.end());
    // projections
    std::vector<long long> projs;
    while (*p && *p != '\n') {
      long long s, c;
      if (!read_u64(&s) || *p++ != '.' || !read_u64(&c)) return 0;
      projs.insert(projs.end(), {s, c});
      skip_ws();
    }
    out.push_back((long long)projs.size() / 2);
    out.insert(out.end(), projs.begin(), projs.end());
  }
  out.push_back(-2);
  if ((long long)out.size() > cap) return -(long long)out.size();
  std::memcpy(tape, out.data(), out.size() * sizeof(long long));
  return (long long)out.size();
}

// ---- result formatter ----
//
// sums: n values (u64); null_mask: 1 => print NULL for every projection of
// that query. Queries delimited by counts[]. Returns bytes written or
// -(needed).
long long rhj_format_results(const unsigned long long* sums,
                             const long long* proj_counts,
                             const unsigned char* null_mask,
                             long long n_queries, char* buf, long long cap) {
  std::string s;
  long long k = 0;
  char tmp[32];
  for (long long q = 0; q < n_queries; q++) {
    for (long long i = 0; i < proj_counts[q]; i++) {
      if (i) s += ' ';
      if (null_mask[q]) {
        s += "NULL";
      } else {
        int len = snprintf(tmp, sizeof tmp, "%llu", sums[k + i]);
        s.append(tmp, len);
      }
    }
    k += proj_counts[q];
    s += '\n';
  }
  if ((long long)s.size() > cap) return -(long long)s.size();
  std::memcpy(buf, s.data(), s.size());
  return (long long)s.size();
}

}  // extern "C"
