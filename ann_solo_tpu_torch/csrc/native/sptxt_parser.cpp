// Native columnar .sptxt (SpectraST text library) parser.
//
// C++ replacement for the regex-based text parsing the reference runs
// through joblib (ann_solo/reader.py:300-436 -- slow enough that the
// reference parallelizes it): one sequential pass over the memory-mapped
// file, decoding every entry into packed columnar arrays.  The ProForma
// modification rewrite stays in Python (string munging on the ~100-char
// "Mods=" values, not the MB-scale peak text).
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain).
//
// Semantics mirror ann_solo_tpu/io/splib.py `read_sptxt` /
// `_parse_sptxt_spectrum`:
//   entries start at lines beginning with case-insensitive "Name:";
//   "Name: PEPTIDE/charge ..." -> peptide, precursor charge;
//   metadata (before the "Num Peaks:" / "NumPeaks:" line): PrecursorMZ:
//   or Parent= float, the raw "Mods=..." token, case-insensitive
//   "decoy" marks decoys; peak lines are TAB-separated
//   "mz\tintensity\tannotation", annotations parsed like
//   parse_annotation (a/b/y ion, index, charge; -1 charge = other).

#include <cctype>
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
  std::vector<int32_t> precursor_charge;
  std::vector<uint8_t> is_decoy;
  std::vector<int64_t> peptide_offsets;  // n+1
  std::string peptide_chars;
  std::vector<int64_t> mods_offsets;  // n+1 (raw Mods= value, "" = none)
  std::string mods_chars;
  std::vector<int64_t> peak_offsets;  // n+1
  std::vector<double> mz;
  std::vector<double> intensity;
  std::vector<uint8_t> ann_type;
  std::vector<int16_t> ann_index;
  std::vector<uint8_t> ann_charge;
};

// ION_TYPE_CODES subset used by parse_annotation (a/b/y only).
inline int ion_code(char c) {
  switch (c) {
    case 'a': return 1;
    case 'b': return 2;
    case 'y': return 5;
    default: return 0;
  }
}

// Mirror of splib.parse_annotation (parsers.pyx:163-186 semantics).
void parse_annotation(const char* s, size_t len, uint8_t* type,
                      int16_t* index, uint8_t* charge) {
  *type = 0;
  *index = 0;
  *charge = 0;
  if (len == 0) return;
  int code = ion_code(s[0]);
  if (code == 0) return;
  size_t i = 1;
  long idx = 0;
  size_t digits = 0;
  while (i < len && std::isdigit(static_cast<unsigned char>(s[i]))) {
    idx = idx * 10 + (s[i] - '0');
    ++i;
    ++digits;
  }
  if (digits == 0) return;
  long chg;
  if (i < len && s[i] == '/') {
    chg = 1;
  } else if (i < len && s[i] == '^') {
    ++i;
    chg = 0;
    size_t cd = 0;
    while (i < len && std::isdigit(static_cast<unsigned char>(s[i]))) {
      chg = chg * 10 + (s[i] - '0');
      ++i;
      ++cd;
    }
    if (cd == 0) return;  // charge -1 -> zeroed annotation
  } else {
    return;  // charge -1 -> zeroed annotation
  }
  *type = static_cast<uint8_t>(code);
  *index = static_cast<int16_t>(idx);
  *charge = static_cast<uint8_t>(chg);
}

inline bool istarts(const char* s, size_t len, const char* prefix) {
  size_t n = std::strlen(prefix);
  if (len < n) return false;
  for (size_t i = 0; i < n; ++i) {
    if (std::tolower(static_cast<unsigned char>(s[i])) != prefix[i]) {
      return false;
    }
  }
  return true;
}

// Case-insensitive search for a token within one line.
const char* ifind(const char* s, size_t len, const char* needle) {
  size_t n = std::strlen(needle);
  if (n > len) return nullptr;
  for (size_t i = 0; i + n <= len; ++i) {
    size_t j = 0;
    while (j < n && std::tolower(static_cast<unsigned char>(s[i + j])) ==
                        needle[j]) {
      ++j;
    }
    if (j == n) return s + i;
  }
  return nullptr;
}

bool is_numpeaks_line(const char* line, size_t len) {
  if (!istarts(line, len, "num")) return false;
  size_t i = 3;
  if (i < len && line[i] == ' ') ++i;  // "Num Peaks:" or "NumPeaks:"
  return istarts(line + i, len - i, "peaks:");
}

struct Entry {
  bool active = false;
  bool in_peaks = false;
  bool decoy = false;
  bool has_precursor_mz = false;  // PrecursorMZ: beats Parent=
  std::string peptide;
  std::string mods;
  double precursor_mz = 0.0;
  int32_t charge = 0;
};

void flush_entry(Parsed* out, Entry& e) {
  if (!e.active) return;
  out->precursor_mz.push_back(e.precursor_mz);
  out->precursor_charge.push_back(e.charge);
  out->is_decoy.push_back(e.decoy ? 1 : 0);
  out->peptide_chars.append(e.peptide);
  out->peptide_offsets.push_back(
      static_cast<int64_t>(out->peptide_chars.size()));
  out->mods_chars.append(e.mods);
  out->mods_offsets.push_back(
      static_cast<int64_t>(out->mods_chars.size()));
  out->peak_offsets.push_back(static_cast<int64_t>(out->mz.size()));
  e = Entry{};
}

Parsed* parse(const char* data, size_t size) {
  auto* out = new Parsed();
  out->peptide_offsets.push_back(0);
  out->mods_offsets.push_back(0);
  out->peak_offsets.push_back(0);
  Entry entry;
  size_t pos = 0;
  while (pos < size) {
    size_t eol = pos;
    while (eol < size && data[eol] != '\n') ++eol;
    const char* line = data + pos;
    size_t len = eol - pos;
    while (len && (line[len - 1] == '\r' || line[len - 1] == ' ')) --len;
    pos = eol + 1;

    if (istarts(line, len, "name:")) {
      flush_entry(out, entry);
      entry.active = true;
      // "Name: PEPTIDE/2 ..." -> last space token before '/', digits
      // after (reader.py:324-340 semantics).
      const char* slash =
          static_cast<const char*>(std::memchr(line, '/', len));
      size_t name_end = slash ? static_cast<size_t>(slash - line) : len;
      size_t start = name_end;
      while (start > 0 && line[start - 1] != ' ') --start;
      entry.peptide.assign(line + start, name_end - start);
      if (slash) {
        const char* p = slash + 1;
        while (p < line + len && *p == ' ') ++p;
        long charge = std::strtol(p, nullptr, 10);
        entry.charge = static_cast<int32_t>(charge);
      }
      // "DECOY_..." names mark decoys too (the Python parser searches
      // the whole metadata block, which includes the Name line).
      if (ifind(line, len, "decoy")) entry.decoy = true;
      continue;
    }
    if (!entry.active) continue;

    if (!entry.in_peaks && is_numpeaks_line(line, len)) {
      entry.in_peaks = true;
      continue;
    }
    if (!entry.in_peaks) {
      // Metadata line: precursor m/z, Mods=, decoy flag.
      if (const char* m = ifind(line, len, "precursormz:")) {
        entry.precursor_mz = std::strtod(m + 12, nullptr);
        entry.has_precursor_mz = true;
      } else if (const char* p = ifind(line, len, "parent=")) {
        if (!entry.has_precursor_mz) {
          entry.precursor_mz = std::strtod(p + 7, nullptr);
        }
      }
      if (const char* mod = ifind(line, len, "mods=")) {
        const char* v = mod + 5;
        const char* end = line + len;
        const char* q = v;
        while (q < end &&
               !std::isspace(static_cast<unsigned char>(*q))) {
          ++q;
        }
        entry.mods.assign(v, static_cast<size_t>(q - v));
      }
      if (ifind(line, len, "decoy")) entry.decoy = true;
      continue;
    }
    // Peak line: TAB-separated "mz \t intensity \t annotation".
    const char* tab1 =
        static_cast<const char*>(std::memchr(line, '\t', len));
    if (tab1 == nullptr) continue;
    const char* rest = tab1 + 1;
    size_t rest_len = len - static_cast<size_t>(rest - line);
    const char* tab2 =
        static_cast<const char*>(std::memchr(rest, '\t', rest_len));
    char* endp = nullptr;
    double peak_mz = std::strtod(line, &endp);
    if (endp == line) continue;
    double peak_int = std::strtod(rest, &endp);
    if (endp == rest) continue;
    uint8_t t = 0, c = 0;
    int16_t idx = 0;
    if (tab2 != nullptr) {
      const char* ann = tab2 + 1;
      size_t ann_len = len - static_cast<size_t>(ann - line);
      const char* tab3 =
          static_cast<const char*>(std::memchr(ann, '\t', ann_len));
      if (tab3 != nullptr) ann_len = static_cast<size_t>(tab3 - ann);
      parse_annotation(ann, ann_len, &t, &idx, &c);
    }
    out->mz.push_back(peak_mz);
    out->intensity.push_back(peak_int);
    out->ann_type.push_back(t);
    out->ann_index.push_back(idx);
    out->ann_charge.push_back(c);
  }
  flush_entry(out, entry);
  return out;
}

}  // namespace

extern "C" {

void* sptxt_parse(const char* filename) {
  int fd = ::open(filename, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  if (st.st_size == 0) {
    ::close(fd);
    auto* out = new Parsed();
    out->peptide_offsets.push_back(0);
    out->mods_offsets.push_back(0);
    out->peak_offsets.push_back(0);
    return out;
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

int64_t sptxt_num_spectra(void* h) {
  return static_cast<int64_t>(
      static_cast<Parsed*>(h)->precursor_mz.size());
}
int64_t sptxt_num_peaks(void* h) {
  return static_cast<int64_t>(static_cast<Parsed*>(h)->mz.size());
}
int64_t sptxt_peptide_chars_len(void* h) {
  return static_cast<int64_t>(
      static_cast<Parsed*>(h)->peptide_chars.size());
}
int64_t sptxt_mods_chars_len(void* h) {
  return static_cast<int64_t>(static_cast<Parsed*>(h)->mods_chars.size());
}
double* sptxt_precursor_mz(void* h) {
  return static_cast<Parsed*>(h)->precursor_mz.data();
}
int32_t* sptxt_precursor_charge(void* h) {
  return static_cast<Parsed*>(h)->precursor_charge.data();
}
uint8_t* sptxt_is_decoy(void* h) {
  return static_cast<Parsed*>(h)->is_decoy.data();
}
int64_t* sptxt_peptide_offsets(void* h) {
  return static_cast<Parsed*>(h)->peptide_offsets.data();
}
const char* sptxt_peptide_chars(void* h) {
  return static_cast<Parsed*>(h)->peptide_chars.data();
}
int64_t* sptxt_mods_offsets(void* h) {
  return static_cast<Parsed*>(h)->mods_offsets.data();
}
const char* sptxt_mods_chars(void* h) {
  return static_cast<Parsed*>(h)->mods_chars.data();
}
int64_t* sptxt_peak_offsets(void* h) {
  return static_cast<Parsed*>(h)->peak_offsets.data();
}
double* sptxt_mz(void* h) { return static_cast<Parsed*>(h)->mz.data(); }
double* sptxt_intensity(void* h) {
  return static_cast<Parsed*>(h)->intensity.data();
}
uint8_t* sptxt_ann_type(void* h) {
  return static_cast<Parsed*>(h)->ann_type.data();
}
int16_t* sptxt_ann_index(void* h) {
  return static_cast<Parsed*>(h)->ann_index.data();
}
uint8_t* sptxt_ann_charge(void* h) {
  return static_cast<Parsed*>(h)->ann_charge.data();
}
void sptxt_free(void* h) { delete static_cast<Parsed*>(h); }

}  // extern "C"
