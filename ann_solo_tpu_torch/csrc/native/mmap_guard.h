// Map a file for read with a guaranteed zero guard page after the data.
//
// The text parsers run strtod/strtol directly on the mapped buffer.  A
// plain mmap of a file whose size is an exact multiple of the page size
// has no readable byte past the end, so a file ending mid-number (no
// trailing newline) would let the numeric scan run off the mapping and
// SIGSEGV.  Mapping the file over a one-page-larger anonymous zeroed
// reservation guarantees at least one readable NUL byte after the data
// (when the size is not a page multiple, the kernel zero-fills the tail
// of the last file page as usual).
#pragma once

#include <sys/mman.h>
#include <unistd.h>

#include <cstddef>

namespace mmap_guard {

struct Mapping {
  const char* data = nullptr;
  size_t file_size = 0;   // bytes of file content
  size_t map_size = 0;    // total mapped bytes (incl. guard page)

  bool ok() const { return data != nullptr; }
};

inline Mapping map_readonly(int fd, size_t size) {
  Mapping m;
  const size_t page = static_cast<size_t>(::sysconf(_SC_PAGESIZE));
  const size_t rounded = (size + page - 1) / page * page;
  const size_t total = rounded + page;  // + guard page of zeros
  void* base = ::mmap(nullptr, total, PROT_READ, MAP_PRIVATE | MAP_ANONYMOUS,
                      -1, 0);
  if (base == MAP_FAILED) return m;
  void* file = ::mmap(base, size, PROT_READ, MAP_PRIVATE | MAP_FIXED, fd, 0);
  if (file == MAP_FAILED) {
    ::munmap(base, total);
    return m;
  }
  m.data = static_cast<const char*>(base);
  m.file_size = size;
  m.map_size = total;
  return m;
}

inline void unmap(const Mapping& m) {
  if (m.data != nullptr) {
    ::munmap(const_cast<char*>(m.data), m.map_size);
  }
}

}  // namespace mmap_guard
