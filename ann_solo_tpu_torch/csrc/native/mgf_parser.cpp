// Native columnar MGF (Mascot Generic Format) parser.
//
// C++ replacement for the hot query-IO path (the reference leans on
// C-accelerated pyteomics.mgf, ann_solo/reader.py:868-911): one
// sequential pass over the memory-mapped file, decoding every spectrum
// straight into packed columnar arrays (flat peak arrays + offsets).
// Query files dominate wall time in the per-raw-file production fan-out
// (the reference's Kim2014 pattern: thousands of CLI invocations).
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain).
//
// Semantics mirror ann_solo_tpu/io/mgf.py `read_mgf`:
//   BEGIN IONS / END IONS blocks; "KEY=value" parameter lines (keys
//   case-insensitive); peak lines "mz intensity [...]"; TITLE (fall back
//   to SCAN, then the 1-based block index -- resolved Python-side),
//   PEPMASS (first field), CHARGE ("2+", "3-", "2"), RTINSECONDS, SEQ,
//   and a DECOY parameter flag.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "mmap_guard.h"

namespace {

struct Parsed {
  std::vector<double> precursor_mz;
  std::vector<int32_t> precursor_charge;  // 0 = absent
  std::vector<double> retention_time;     // NaN = absent
  std::vector<uint8_t> is_decoy;
  std::vector<int64_t> title_offsets;  // into title_chars, n+1 entries
  std::string title_chars;
  std::vector<int64_t> seq_offsets;  // into seq_chars, n+1 entries
  std::string seq_chars;
  std::vector<int64_t> peak_offsets;  // n+1 entries
  std::vector<double> mz;
  std::vector<double> intensity;
};

inline bool iequals(const char* a, size_t len, const char* b) {
  for (size_t i = 0; i < len; ++i) {
    if (std::tolower(static_cast<unsigned char>(a[i])) != b[i]) return false;
  }
  return b[len] == '\0';
}

// Parse one spectrum block's parameter line "KEY=value".
void handle_param(Parsed& out, const char* key, size_t key_len,
                  const char* value, size_t value_len, std::string& title,
                  std::string& scan, std::string& seq) {
  // Trim value whitespace.
  while (value_len && std::isspace(static_cast<unsigned char>(value[0]))) {
    ++value;
    --value_len;
  }
  while (value_len &&
         std::isspace(static_cast<unsigned char>(value[value_len - 1]))) {
    --value_len;
  }
  // Trim key trailing whitespace.
  while (key_len &&
         std::isspace(static_cast<unsigned char>(key[key_len - 1]))) {
    --key_len;
  }
  if (iequals(key, key_len, "title")) {
    title.assign(value, value_len);
  } else if (iequals(key, key_len, "scan")) {
    scan.assign(value, value_len);
  } else if (iequals(key, key_len, "seq")) {
    seq.assign(value, value_len);
  } else if (iequals(key, key_len, "pepmass")) {
    out.precursor_mz.back() = std::strtod(value, nullptr);
  } else if (iequals(key, key_len, "rtinseconds")) {
    out.retention_time.back() = std::strtod(value, nullptr);
  } else if (iequals(key, key_len, "charge")) {
    // "2+", "3-", "2", possibly a list -- first token only.  Anything
    // else ("two", "2x") leaves the charge unknown, like the Python
    // reader.
    const char* p = value;
    char* end = nullptr;
    long charge = std::strtol(p, &end, 10);
    if (end != p) {
      // Sign may trail the digits ("2-"/"2+").
      if (end < value + value_len && (*end == '-' || *end == '+')) {
        if (*end == '-' && charge > 0) charge = -charge;
        ++end;
      }
      bool token_done =
          end == value + value_len ||
          std::isspace(static_cast<unsigned char>(*end));
      if (token_done) {
        out.precursor_charge.back() = static_cast<int32_t>(charge);
      }
    }
  } else if (iequals(key, key_len, "decoy")) {
    out.is_decoy.back() = 1;
  }
}

Parsed* parse(const char* data, size_t size) {
  auto* out = new Parsed();
  out->title_offsets.push_back(0);
  out->seq_offsets.push_back(0);
  out->peak_offsets.push_back(0);
  size_t pos = 0;
  bool in_ions = false;
  std::string title, scan, seq;
  while (pos < size) {
    size_t eol = pos;
    while (eol < size && data[eol] != '\n') ++eol;
    const char* line = data + pos;
    size_t len = eol - pos;
    // Trim \r and leading/trailing spaces.
    while (len && (line[len - 1] == '\r' ||
                   std::isspace(static_cast<unsigned char>(line[len - 1])))) {
      --len;
    }
    while (len && std::isspace(static_cast<unsigned char>(line[0]))) {
      ++line;
      --len;
    }
    pos = eol + 1;
    if (len == 0) continue;
    if (len == 10 && std::memcmp(line, "BEGIN IONS", 10) == 0) {
      if (in_ions) {
        // Repeated BEGIN IONS without END IONS: discard the dangling
        // block (the Python reader resets its state the same way) --
        // the metadata arrays must stay in lockstep with the offsets.
        out->precursor_mz.pop_back();
        out->precursor_charge.pop_back();
        out->retention_time.pop_back();
        out->is_decoy.pop_back();
        out->mz.resize(static_cast<size_t>(out->peak_offsets.back()));
        out->intensity.resize(
            static_cast<size_t>(out->peak_offsets.back()));
      }
      in_ions = true;
      title.clear();
      scan.clear();
      seq.clear();
      out->precursor_mz.push_back(0.0);
      out->precursor_charge.push_back(0);
      out->retention_time.push_back(NAN);
      out->is_decoy.push_back(0);
      continue;
    }
    if (len == 8 && std::memcmp(line, "END IONS", 8) == 0) {
      if (in_ions) {
        const std::string& name = !title.empty() ? title : scan;
        out->title_chars.append(name);
        out->title_offsets.push_back(
            static_cast<int64_t>(out->title_chars.size()));
        out->seq_chars.append(seq);
        out->seq_offsets.push_back(
            static_cast<int64_t>(out->seq_chars.size()));
        out->peak_offsets.push_back(static_cast<int64_t>(out->mz.size()));
      }
      in_ions = false;
      continue;
    }
    if (!in_ions) continue;
    // Python-reader rule: a parameter line contains '=' AND does not
    // start with a digit; everything else is tried as a peak line.
    const char* eq = static_cast<const char*>(std::memchr(line, '=', len));
    if (eq != nullptr &&
        !std::isdigit(static_cast<unsigned char>(line[0]))) {
      handle_param(*out, line, static_cast<size_t>(eq - line), eq + 1,
                   len - static_cast<size_t>(eq - line) - 1, title, scan,
                   seq);
      continue;
    }
    // Peak line: "mz intensity [extras]".
    char* end = nullptr;
    double peak_mz = std::strtod(line, &end);
    if (end == line) continue;
    const char* rest = end;
    double peak_int = std::strtod(rest, &end);
    if (end == rest) continue;  // need two numeric fields
    out->mz.push_back(peak_mz);
    out->intensity.push_back(peak_int);
  }
  if (in_ions) {
    // Unterminated final block (truncated file): drop it, like the
    // Python reader -- the offset arrays only grow at END IONS, so the
    // metadata arrays must shrink back in step.
    out->precursor_mz.pop_back();
    out->precursor_charge.pop_back();
    out->retention_time.pop_back();
    out->is_decoy.pop_back();
    out->mz.resize(static_cast<size_t>(out->peak_offsets.back()));
    out->intensity.resize(static_cast<size_t>(out->peak_offsets.back()));
  }
  return out;
}

}  // namespace

extern "C" {

void* mgf_parse(const char* filename) {
  int fd = ::open(filename, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return st.st_size == 0 ? static_cast<void*>(new Parsed{
                                 {}, {}, {}, {}, {0}, "", {0}, "", {0},
                                 {}, {}})
                           : nullptr;
  }
  // Guard-page mapping: strtod/strtol scan the raw buffer, so the byte
  // after the last file byte must be readable (and is zero).
  mmap_guard::Mapping map =
      mmap_guard::map_readonly(fd, static_cast<size_t>(st.st_size));
  ::close(fd);
  if (!map.ok()) return nullptr;
  Parsed* out = parse(map.data, map.file_size);
  mmap_guard::unmap(map);
  return out;
}

int64_t mgf_num_spectra(void* handle) {
  return static_cast<int64_t>(
      static_cast<Parsed*>(handle)->precursor_mz.size());
}
int64_t mgf_num_peaks(void* handle) {
  return static_cast<int64_t>(static_cast<Parsed*>(handle)->mz.size());
}
int64_t mgf_title_chars_len(void* handle) {
  return static_cast<int64_t>(
      static_cast<Parsed*>(handle)->title_chars.size());
}
int64_t mgf_seq_chars_len(void* handle) {
  return static_cast<int64_t>(
      static_cast<Parsed*>(handle)->seq_chars.size());
}
double* mgf_precursor_mz(void* handle) {
  return static_cast<Parsed*>(handle)->precursor_mz.data();
}
int32_t* mgf_precursor_charge(void* handle) {
  return static_cast<Parsed*>(handle)->precursor_charge.data();
}
double* mgf_retention_time(void* handle) {
  return static_cast<Parsed*>(handle)->retention_time.data();
}
uint8_t* mgf_is_decoy(void* handle) {
  return static_cast<Parsed*>(handle)->is_decoy.data();
}
int64_t* mgf_title_offsets(void* handle) {
  return static_cast<Parsed*>(handle)->title_offsets.data();
}
const char* mgf_title_chars(void* handle) {
  return static_cast<Parsed*>(handle)->title_chars.data();
}
int64_t* mgf_seq_offsets(void* handle) {
  return static_cast<Parsed*>(handle)->seq_offsets.data();
}
const char* mgf_seq_chars(void* handle) {
  return static_cast<Parsed*>(handle)->seq_chars.data();
}
int64_t* mgf_peak_offsets(void* handle) {
  return static_cast<Parsed*>(handle)->peak_offsets.data();
}
double* mgf_mz(void* handle) {
  return static_cast<Parsed*>(handle)->mz.data();
}
double* mgf_intensity(void* handle) {
  return static_cast<Parsed*>(handle)->intensity.data();
}
void mgf_free(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"
