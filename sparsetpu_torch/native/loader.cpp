// Native host runtime: fast matrix-file parsing.
//
// The reference's host side is C++ on the Zynq ARM (csr.cpp:87-136
// read_csr_matrix: fscanf loop, 1-based -> 0-based conversion at
// csr.cpp:118).  Python/NumPy parsing of large .mtx files is 20-50x
// slower than this memory-mapped scanner, so the ingest hot path stays
// native, exposed to Python via ctypes (native/loader.py).
//
// Exports (C ABI):
//   stpu_count_triplets(path)            -> nnz declared in the header
//   stpu_read_triplets(path, pattern, rows, cols, vals, cap) -> n read
//   stpu_spmv_gold(...)                  -> CSR SpMV oracle (csr.cpp:184)
//   stpu_verification(...)               -> |a-b| < tol counter (csr_hw.cpp:1571)

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
}

// Skip comment/blank lines; returns pointer to the size line.
const char* find_header(const char* p, const char* end) {
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p < end && (*p == '%' || *p == '\n' || *p == '\r')) {
      while (p < end && *p != '\n') ++p;
      if (p < end) ++p;
      continue;
    }
    return p;
  }
  return end;
}

inline int64_t parse_int(const char*& p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  return neg ? -v : v;
}

inline double parse_double(const char*& p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  char* q = nullptr;
  double v = strtod(p, &q);
  p = q;
  return v;
}

inline void skip_line(const char*& p, const char* end) {
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;
}

}  // namespace

extern "C" {

long long stpu_count_triplets(const char* path) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = find_header(m.data, m.data + m.size);
  const char* end = m.data + m.size;
  parse_int(p, end);               // nr_rows
  parse_int(p, end);               // nr_cols
  long long nnz = parse_int(p, end);
  unmap(m);
  return nnz;
}

long long stpu_read_triplets(const char* path, int pattern, int32_t* rows,
                             int32_t* cols, double* vals, long long cap) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* end = m.data + m.size;
  const char* p = find_header(m.data, end);
  skip_line(p, end);               // past the size line
  long long n = 0;
  while (p < end && n < cap) {
    // skip comments / blank lines inside the body (tolerant superset of
    // the reference's strict format)
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p >= end) break;
    if (*p == '%' || *p == '\n' || *p == '\r') {
      skip_line(p, end);
      continue;
    }
    int64_t r = parse_int(p, end);
    int64_t c = parse_int(p, end);
    double v = pattern ? 1.0 : parse_double(p, end);
    skip_line(p, end);
    rows[n] = static_cast<int32_t>(r - 1);   // 1-based -> 0-based
    cols[n] = static_cast<int32_t>(c - 1);   // (csr.cpp:118)
    vals[n] = v;
    ++n;
  }
  unmap(m);
  return n;
}

// CSR SpMV oracle (csr.cpp:184-194) — for differential testing of large
// matrices where the NumPy oracle's temporaries hurt.
void stpu_spmv_gold(const int32_t* row_ptr, const int32_t* col_ind,
                    const double* values, const double* x, double* y,
                    int64_t nr_rows) {
  for (int64_t i = 0; i < nr_rows; ++i) {
    double acc = 0.0;
    for (int32_t j = row_ptr[i]; j < row_ptr[i + 1]; ++j)
      acc += values[j] * x[col_ind[j]];
    y[i] = acc;
  }
}

// Elementwise |sw - hw| < tol with NaN guard (csr_hw.cpp:1571-1590).
long long stpu_verification(const double* sw, const double* hw, int64_t n,
                            double tol) {
  long long errors = 0;
  for (int64_t i = 0; i < n; ++i) {
    double diff = std::fabs(sw[i] - hw[i]);
    if (diff >= tol || diff != diff) ++errors;
  }
  return errors;
}

}  // extern "C"
