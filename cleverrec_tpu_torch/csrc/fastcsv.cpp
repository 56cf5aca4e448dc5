// Columnar reader of numeric delimited files (interaction and trust
// files): one pass over an mmapped file, no allocation per row.
// data/fastcsv.py calls it where the first data line is numeric and the
// separator one byte; numpy parses every other file.
//
// C ABI (ctypes):
//   fastcsv_count_rows(path, sep, skip_header) -> rows (or -1)
//   fastcsv_parse(path, sep, skip_header, n_cols, out_cols[n_cols], rows)
//       -> rows parsed (or -1); out_cols are caller-allocated double
//       arrays of length >= rows; missing/extra fields -> 0 / ignored.
//
// Build (ops/build.py, into build/kernels/):
//   g++ -O3 -shared -fPIC -o libfastcsv.so fastcsv.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return false; }
    size = static_cast<size_t>(st.st_size);
    if (size == 0) { data = nullptr; return true; }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) { ::close(fd); return false; }
    madvise(p, size, MADV_SEQUENTIAL);
    data = static_cast<const char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

// Parse a (possibly signed, possibly fractional, possibly E-notation)
// number in [p, end) up to the next sep/newline.  Returns value; advances p.
inline double parse_number(const char*& p, const char* end, char sep) {
  // Fast path: plain integer.
  bool neg = false;
  const char* q = p;
  if (q < end && (*q == '-' || *q == '+')) { neg = (*q == '-'); ++q; }
  int64_t ival = 0;
  bool fractional = false;
  const char* digits_start = q;
  while (q < end && *q >= '0' && *q <= '9') {
    ival = ival * 10 + (*q - '0');
    ++q;
  }
  if (q < end && (*q == '.' || *q == 'e' || *q == 'E')) fractional = true;
  if (!fractional && q > digits_start) {
    p = q;
    return neg ? -static_cast<double>(ival) : static_cast<double>(ival);
  }
  // Slow path: strtod (bounded by the field end).
  char buf[64];
  size_t n = 0;
  const char* r = p;
  while (r < end && *r != sep && *r != '\n' && *r != '\r' && n < 63)
    buf[n++] = *r++;
  buf[n] = '\0';
  p = r;
  return strtod(buf, nullptr);
}

}  // namespace

extern "C" {

int64_t fastcsv_count_rows(const char* path, char sep, int skip_header) {
  MappedFile f;
  if (!f.open(path)) return -1;
  (void)sep;
  int64_t rows = 0;
  const char* p = f.data;
  const char* end = f.data + f.size;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!nl) { ++rows; break; }
    if (nl > p) ++rows;  // skip blank lines
    p = nl + 1;
  }
  return rows - (skip_header ? 1 : 0);
}

int64_t fastcsv_parse(const char* path, char sep, int skip_header,
                      int n_cols, double** out_cols, int64_t max_rows) {
  MappedFile f;
  if (!f.open(path)) return -1;
  const char* p = f.data;
  const char* end = f.data + f.size;
  int64_t row = 0;
  bool skipped = !skip_header;
  while (p < end && row < max_rows) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    if (line_end > p && *p != '\r') {
      if (!skipped) {
        skipped = true;
      } else {
        const char* q = p;
        for (int c = 0; c < n_cols; ++c) {
          double v = (q < line_end) ? parse_number(q, line_end, sep) : 0.0;
          out_cols[c][row] = v;
          // Advance past the separator (tab-or-given; tolerate repeats of
          // the sep char but not of other whitespace).
          while (q < line_end && *q == sep) ++q;
          if (sep != '\t')
            while (q < line_end && (*q == ' ')) ++q;
        }
        ++row;
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  return row;
}

}  // extern "C"
