// hostcore — native host-side runtime for petibm-jax.
//
// The device compute path is JAX/XLA; this library covers the hot
// *host* paths that the reference implements in C++ (reference:
// src/io/io.cpp:23 readLagrangianPoints, include/petibm/misc.h:148
// stretchGrid, src/body/singlebodypoints.cpp:95 updateMeshIdx): ASCII
// Lagrangian body ingestion/emission and mesh index searches, which for
// large 3D bodies (10^5-10^6 points) dominate solver start-up when done
// in interpreted Python.
//
// Pure C ABI (loaded via ctypes); all buffers are caller-allocated numpy
// arrays.  Errors return negative codes; 0 means success.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kErrIO = -1;
constexpr int kErrFormat = -2;
constexpr int kErrBounds = -3;

// Read a whole file into a string buffer; returns false on IO error.
bool slurp(const char* path, std::vector<char>& buf) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return false;
  std::fseek(fh, 0, SEEK_END);
  long size = std::ftell(fh);
  if (size < 0) {
    std::fclose(fh);
    return false;
  }
  std::fseek(fh, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), fh);
  std::fclose(fh);
  if (got != static_cast<size_t>(size)) return false;
  buf[got] = '\0';
  return true;
}

}  // namespace

extern "C" {

// Geometric-ratio cell widths: dL[0] = (end-begin)(r-1)/(r^n - 1),
// dL[i] = dL[i-1]*r; uniform when |r-1| <= 1e-12.
int ptn_stretch_grid(double begin, double end, int64_t n, double ratio,
                     double* out) {
  if (n <= 0 || !out) return kErrBounds;
  if (std::fabs(ratio - 1.0) <= 1e-12) {
    const double h = (end - begin) / static_cast<double>(n);
    for (int64_t i = 0; i < n; ++i) out[i] = h;
    return 0;
  }
  const double h0 =
      (end - begin) * (ratio - 1.0) / (std::pow(ratio, static_cast<double>(n)) - 1.0);
  double h = h0;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = h;
    h *= ratio;
  }
  return 0;
}

// First pass over a body file: number of points (first line) and the
// column count of the first data row.
int ptn_probe_points(const char* path, int64_t* n, int32_t* dim) {
  std::vector<char> buf;
  if (!slurp(path, buf)) return kErrIO;
  char* p = buf.data();
  char* endp = nullptr;
  errno = 0;
  long long count = std::strtoll(p, &endp, 10);
  if (endp == p || errno != 0 || count < 0) return kErrFormat;
  p = endp;
  // skip to the next line
  while (*p && *p != '\n') ++p;
  // count doubles on the first non-empty data line
  int cols = 0;
  while (*p) {
    if (*p == '\n' && cols > 0) break;
    char* q = nullptr;
    double v = std::strtod(p, &q);
    (void)v;
    if (q == p) {
      ++p;
      continue;
    }
    ++cols;
    p = q;
  }
  *n = static_cast<int64_t>(count);
  *dim = cols;
  return 0;
}

// Second pass: parse exactly n*dim doubles after the count line into out
// (row-major).  Extra trailing whitespace is fine; short files error.
int ptn_read_points(const char* path, double* out, int64_t n, int32_t dim) {
  if (!out || n < 0 || dim <= 0) return kErrBounds;
  std::vector<char> buf;
  if (!slurp(path, buf)) return kErrIO;
  char* p = buf.data();
  char* endp = nullptr;
  (void)std::strtoll(p, &endp, 10);  // skip the count line
  if (endp == p) return kErrFormat;
  p = endp;
  const int64_t total = n * static_cast<int64_t>(dim);
  for (int64_t i = 0; i < total; ++i) {
    char* q = nullptr;
    double v = std::strtod(p, &q);
    if (q == p) return kErrFormat;  // ran out of numbers
    out[i] = v;
    p = q;
  }
  return 0;
}

// Emit points in the reference's writeBody layout (coordinate rows,
// optionally preceded by the count line; reference:
// singlebodypoints.cpp:238-290 writes rows only, the input format has the
// count).  %.8e with tab separators matches the Python writer.
int ptn_write_points(const char* path, const double* data, int64_t n,
                     int32_t dim, int32_t with_count) {
  if (!data || n < 0 || dim <= 0) return kErrBounds;
  FILE* fh = std::fopen(path, "wb");
  if (!fh) return kErrIO;
  std::vector<char> iobuf(1 << 20);
  std::setvbuf(fh, iobuf.data(), _IOFBF, iobuf.size());
  if (with_count) std::fprintf(fh, "%lld\n", static_cast<long long>(n));
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t d = 0; d < dim; ++d) {
      std::fprintf(fh, d ? "\t%.8e" : "%.8e",
                   data[i * static_cast<int64_t>(dim) + d]);
    }
    std::fputc('\n', fh);
  }
  const int bad = std::ferror(fh);
  std::fclose(fh);
  return bad ? kErrIO : 0;
}

// Owning-cell search: for each x, the index i with grid[i] <= x < grid[i+1]
// (upper_bound - 1 on a sorted gridline — the reference's updateMeshIdx).
int ptn_search_cells(const double* grid, int64_t ng, const double* x,
                     int64_t nx, int64_t* out) {
  if (!grid || !x || !out || ng < 2) return kErrBounds;
  for (int64_t k = 0; k < nx; ++k) {
    int64_t lo = 0, hi = ng;  // first index with grid[i] > x
    const double v = x[k];
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (grid[mid] <= v)
        lo = mid + 1;
      else
        hi = mid;
    }
    out[k] = lo - 1;
  }
  return 0;
}

int ptn_abi_version(void) { return 1; }

}  // extern "C"
