// Native columnar .splib parser.
//
// C++ replacement for the reference's Cython/mmap SplibParser
// (ann_solo/parsers.pyx): one sequential pass over the memory-mapped
// SpectraST binary library, decoding every spectrum straight into packed
// columnar arrays (flat peak arrays + offsets) -- the layout the TPU
// pipeline consumes -- instead of one Python object per spectrum.
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain).
//
// File layout decoded (see parsers.pyx:89-160):
//   header: 8 bytes, one text line, uint32 n_lines, n_lines text lines
//   per spectrum:
//     uint32 identifier
//     line   "Name: X.PEPTIDE.X/charge ..."
//     double precursor m/z
//     line   (status)
//     uint32 num_peaks
//     num_peaks x { double mz; double intensity; line annotation;
//                   line info }
//     line   (comment; " Remark=DECOY_" marks decoys)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Parsed {
  // Per-spectrum metadata.
  std::vector<uint32_t> identifiers;
  std::vector<double> precursor_mz;
  std::vector<int32_t> precursor_charge;
  std::vector<uint8_t> is_decoy;
  std::vector<int64_t> peptide_offsets;  // into peptide_chars, n+1 entries
  std::string peptide_chars;
  // Flat peak arrays + offsets (n+1 entries).
  std::vector<int64_t> peak_offsets;
  std::vector<float> mz;
  std::vector<float> intensity;
  std::vector<uint8_t> ann_type;
  std::vector<int16_t> ann_index;
  std::vector<uint8_t> ann_charge;
};

class Cursor {
 public:
  Cursor(const char* data, size_t size) : data_(data), size_(size) {}

  bool done() const { return pos_ >= size_; }

  uint32_t read_u32() {
    uint32_t value;
    std::memcpy(&value, data_ + pos_, sizeof(value));
    pos_ += sizeof(value);
    return value;
  }

  double read_f64() {
    double value;
    std::memcpy(&value, data_ + pos_, sizeof(value));
    pos_ += sizeof(value);
    return value;
  }

  // Returns [start, end) of the line excluding the newline; advances past
  // it.
  std::pair<const char*, size_t> read_line() {
    const char* start = data_ + pos_;
    const char* nl = static_cast<const char*>(
        memchr(start, '\n', size_ - pos_));
    size_t len = nl == nullptr ? size_ - pos_ : nl - start;
    pos_ += len + (nl == nullptr ? 0 : 1);
    return {start, len};
  }

 private:
  const char* data_;
  size_t size_;
  size_t pos_ = 0;
};

// Ion-type byte codes (matches ann_solo_tpu.models.spectrum).
int ion_code(char ion) {
  switch (ion) {
    case 'a': return 1;
    case 'b': return 2;
    case 'c': return 3;
    case 'x': return 4;
    case 'y': return 5;
    case 'z': return 6;
    case 'I': return 7;
    case 'm': return 8;
    case 'p': return 9;
    case 'r': return 10;
    default: return 0;
  }
}

// Parse one SpectraST annotation (parsers.pyx:163-186): a/b/y ion, index,
// optional ^charge; '/' right after the index implies charge 1.
void parse_annotation(const char* s, size_t len, uint8_t* type,
                      int16_t* index, uint8_t* charge) {
  *type = 0;
  *index = 0;
  *charge = 0;
  if (len == 0) return;
  char ion = s[0];
  if (ion != 'a' && ion != 'b' && ion != 'y') return;
  size_t i = 1;
  int idx = 0;
  bool has_digits = false;
  while (i < len && s[i] >= '0' && s[i] <= '9') {
    idx = idx * 10 + (s[i] - '0');
    has_digits = true;
    ++i;
  }
  if (!has_digits) return;
  int chg = -1;
  if (i < len && s[i] == '/') {
    chg = 1;
  } else if (i < len && s[i] == '^') {
    ++i;
    chg = 0;
    bool any = false;
    while (i < len && s[i] >= '0' && s[i] <= '9') {
      chg = chg * 10 + (s[i] - '0');
      any = true;
      ++i;
    }
    if (!any) chg = -1;
  }
  if (chg <= 0) return;  // unannotated / modified-ion markers
  *type = static_cast<uint8_t>(ion_code(ion));
  *index = static_cast<int16_t>(idx);
  *charge = static_cast<uint8_t>(chg);
}

bool contains(const char* s, size_t len, const char* needle) {
  size_t nlen = std::strlen(needle);
  if (nlen > len) return false;
  return std::search(s, s + len, needle, needle + nlen) != s + len;
}

}  // namespace

extern "C" {

// Parses the file; returns an opaque handle (nullptr on failure).
void* splib_parse(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    close(fd);
    return nullptr;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char* data = static_cast<const char*>(
      mmap(nullptr, size, PROT_READ, MAP_SHARED, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return nullptr;

  auto* out = new Parsed();
  Cursor cur(data + 8, size - 8);  // skip the 8-byte header
  cur.read_line();
  uint32_t n_header_lines = cur.read_u32();
  for (uint32_t i = 0; i < n_header_lines; ++i) cur.read_line();

  out->peak_offsets.push_back(0);
  out->peptide_offsets.push_back(0);
  while (!cur.done()) {
    uint32_t identifier = cur.read_u32();
    auto name = cur.read_line();
    // "Name: X.PEPTIDE.X/charge ..."
    const char* dot1 = static_cast<const char*>(
        memchr(name.first, '.', name.second));
    if (dot1 == nullptr) break;
    const char* rest = dot1 + 1;
    size_t rest_len = name.second - (rest - name.first);
    const char* dot2 = static_cast<const char*>(
        memchr(rest, '.', rest_len));
    if (dot2 == nullptr) break;
    const char* slash = static_cast<const char*>(
        memchr(dot2, '/', name.second - (dot2 - name.first)));
    int charge = 0;
    if (slash != nullptr) {
      const char* p = slash + 1;
      const char* end = name.first + name.second;
      while (p < end && *p >= '0' && *p <= '9') {
        charge = charge * 10 + (*p - '0');
        ++p;
      }
    }
    out->identifiers.push_back(identifier);
    out->peptide_chars.append(rest, dot2 - rest);
    out->peptide_offsets.push_back(
        static_cast<int64_t>(out->peptide_chars.size()));
    out->precursor_charge.push_back(charge);
    out->precursor_mz.push_back(cur.read_f64());
    cur.read_line();  // status
    uint32_t num_peaks = cur.read_u32();
    for (uint32_t i = 0; i < num_peaks; ++i) {
      out->mz.push_back(static_cast<float>(cur.read_f64()));
      out->intensity.push_back(static_cast<float>(cur.read_f64()));
      auto ann = cur.read_line();
      cur.read_line();  // peak info
      uint8_t type, chg;
      int16_t index;
      parse_annotation(ann.first, ann.second, &type, &index, &chg);
      out->ann_type.push_back(type);
      out->ann_index.push_back(index);
      out->ann_charge.push_back(chg);
    }
    out->peak_offsets.push_back(static_cast<int64_t>(out->mz.size()));
    auto remark = cur.read_line();
    out->is_decoy.push_back(
        contains(remark.first, remark.second, " Remark=DECOY_") ? 1 : 0);
  }
  munmap(const_cast<char*>(data), size);
  return out;
}

int64_t splib_num_spectra(void* handle) {
  return static_cast<Parsed*>(handle)->identifiers.size();
}

int64_t splib_num_peaks(void* handle) {
  return static_cast<Parsed*>(handle)->mz.size();
}

int64_t splib_peptide_chars_len(void* handle) {
  return static_cast<Parsed*>(handle)->peptide_chars.size();
}

const uint32_t* splib_identifiers(void* h) {
  return static_cast<Parsed*>(h)->identifiers.data();
}
const double* splib_precursor_mz(void* h) {
  return static_cast<Parsed*>(h)->precursor_mz.data();
}
const int32_t* splib_precursor_charge(void* h) {
  return static_cast<Parsed*>(h)->precursor_charge.data();
}
const uint8_t* splib_is_decoy(void* h) {
  return static_cast<Parsed*>(h)->is_decoy.data();
}
const int64_t* splib_peptide_offsets(void* h) {
  return static_cast<Parsed*>(h)->peptide_offsets.data();
}
const char* splib_peptide_chars(void* h) {
  return static_cast<Parsed*>(h)->peptide_chars.data();
}
const int64_t* splib_peak_offsets(void* h) {
  return static_cast<Parsed*>(h)->peak_offsets.data();
}
const float* splib_mz(void* h) {
  return static_cast<Parsed*>(h)->mz.data();
}
const float* splib_intensity(void* h) {
  return static_cast<Parsed*>(h)->intensity.data();
}
const uint8_t* splib_ann_type(void* h) {
  return static_cast<Parsed*>(h)->ann_type.data();
}
const int16_t* splib_ann_index(void* h) {
  return static_cast<Parsed*>(h)->ann_index.data();
}
const uint8_t* splib_ann_charge(void* h) {
  return static_cast<Parsed*>(h)->ann_charge.data();
}

void splib_free(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"
