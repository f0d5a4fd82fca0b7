// Newline-offset indexer for large TSV/text files (the port's copy of
// ofasys_tpu's line_locate tool, as a C function in a shared library).
//
// Scans a file in 1 GiB mmap windows and writes a binary index of
// line-start offsets that ofasys_torch/io/reader/file_reader.py mmaps for
// O(1) random record access. The numpy scan there writes the same bytes.
//
// C ABI (driven from ctypes; built by ofasys_torch/ops/host_build.py):
//   int ofa_line_locate(const char* input_path, const char* output_path);
//     returns 0, or the errno of the step that failed (the output may then
//     be partly written: callers write to a temporary name and rename).
//
// Output format: little-endian uint64 array
//   [n_lines, start_0, start_1, ..., start_{n-1}, file_size]

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr size_t kWindow = 1ull << 30;  // 1 GiB mmap windows

int error_code() { return errno ? errno : EIO; }

}  // namespace

extern "C" int ofa_line_locate(const char* input_path, const char* output_path) {
  int fd = ::open(input_path, O_RDONLY);
  if (fd < 0) return error_code();
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int err = error_code();
    ::close(fd);
    return err;
  }
  const uint64_t size = static_cast<uint64_t>(st.st_size);

  std::vector<uint64_t> starts;
  starts.reserve(1 << 20);
  bool at_line_start = true;
  for (uint64_t base = 0; base < size; base += kWindow) {
    const size_t len = static_cast<size_t>(std::min<uint64_t>(kWindow, size - base));
    void* map = ::mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, static_cast<off_t>(base));
    if (map == MAP_FAILED) {
      int err = error_code();
      ::close(fd);
      return err;
    }
    const char* p = static_cast<const char*>(map);
    const char* end = p + len;
    const char* cur = p;
    while (cur < end) {
      if (at_line_start) {
        starts.push_back(base + static_cast<uint64_t>(cur - p));
        at_line_start = false;
      }
      const char* nl = static_cast<const char*>(std::memchr(cur, '\n', static_cast<size_t>(end - cur)));
      if (nl == nullptr) break;
      cur = nl + 1;
      at_line_start = true;
    }
    ::munmap(map, len);
  }
  ::close(fd);

  std::FILE* out = std::fopen(output_path, "wb");
  if (out == nullptr) return error_code();
  const uint64_t n = starts.size();
  bool ok = std::fwrite(&n, sizeof(n), 1, out) == 1;
  if (n) ok = ok && std::fwrite(starts.data(), sizeof(uint64_t), starts.size(), out) == starts.size();
  ok = ok && std::fwrite(&size, sizeof(size), 1, out) == 1;
  int err = ok ? 0 : error_code();
  if (std::fclose(out) != 0 && ok) err = error_code();
  return err;
}
