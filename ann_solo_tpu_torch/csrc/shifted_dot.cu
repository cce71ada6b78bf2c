// Greedy shifted-dot-product rescoring for Hopper (sm_90a).
//
// Replaces the TPU kernel ann_solo_tpu/ops/shifted_dot_pallas.py::_kernel
// (launched by shifted_dot_pallas_full).  For each (query, candidate) pair
// it builds the K x K match-score matrix
//
//   score(i, j) = (mult(i, j) * q_int[i]) * c_int[j],
//   mult(i, j)  = max over active shifts s of mult_s * [|q_mz[i] - c_mz[j]
//                 - prec_diff / s| <= tol]   (shift 0: mult 1; s >= 1:
//                 1 if c_ann[j] == s, 2/3 if c_ann[j] == 0, else 0;
//                 s >= 1 only if allow_shift, |prec_diff| >= tol, s <= charge)
//
// and, without shifts (!(allow_shift && num_shifts > 1)), by the direct
// rule score(i, j) = ([|q_mz[i] - c_mz[j]| <= tol] ? q_int[i] : 0) *
// c_int[j]: the reference's 0/1 multiplier is a converted predicate, which
// XLA turns into that select, so a non-matching entry stays 0 where q_int
// is NaN or +-inf.  Then it runs the greedy one-to-one assignment of
// SpectrumMatch.cpp:92-111: repeatedly take the largest entry (ties to the
// lowest flat index i*K+j), add it to the total, zero its row and column,
// until no entry is > 0.  A pair with a NaN entry takes nothing (total 0,
// no match): the dense loop's first argmax is that NaN, which is not > 0.
// Outputs: total (P,) float32 and match (P, K) int32, match[p, i] = the
// candidate peak assigned to query peak i, or -1.
//
// What bounds it on the H100: operations, not bytes.  A pair reads about
// 1 KB and the function needs K^2 * (5 * shifts + 2) float operations to
// build its matrix (at P = 32,768, K = 50, three shifts: 1.4e9, 0.02 ms
// at 67 TFLOP/s f32); the greedy itself needs no pass over the matrix,
// because almost every entry is 0: only peaks within the tolerance at one
// of the shifts are positive, a few dozen a pair.  The design:
//
// * one warp per pair, eight pairs a block; the candidate peaks sit in
//   registers (column j = 32 c + lane), the query peaks in shared memory;
// * the matrix is never stored: lanes build it row by row (the usual one
//   or two active shifts unrolled, each column's multipliers in
//   registers), and a ballot and a prefix count compact its positive
//   entries, in ascending flat order, into a list of (value, i << 16 | j)
//   in shared memory;
// * the greedy is an iterated argmax over that list, skipping entries
//   whose row or column is taken.  The entries alive at a step of the
//   dense loop are exactly the positive entries with a free row and
//   column, so its argmax (value desc, flat index asc, a warp reduction)
//   is the same entry: same picks, same order, `total += best` in
//   selection order;
// * a pair with more than kList positive entries (a wide tolerance) runs
//   the same argmax over the entries recomputed at each step from the
//   peaks, skipping taken rows and columns: slower, the same function.
//
// K above kMaxPeaks (128) takes the wide branch, a second kernel: the
// columns no longer fit in a lane's registers, and walking all K x K
// entries (the first wide design) is K^2 work for a few dozen positive
// entries.  One block scores one pair, a query peak a thread
// (wide_threads: K rounded up to whole warps, at most 1,024), with the
// candidate row, the match and the taken columns in shared memory:
//
// * the branch rule, checked while the row is staged
//   (ops/shifted_dot_cuda.py::search_pairs): the candidate peaks of
//   positive intensity are a prefix with finite, non-decreasing m/z (B4's
//   rule, stage1_bounds.cu), every intensity of the pair is finite and so
//   is tol.  A pair on the rule searches: in each active window the
//   passing peaks of the prefix are one range, found by a binary search
//   and a walk with the plain version's own f32 tests (row_entries), each
//   peak evaluated once with the full entry; about Kq * windows *
//   (log2 Kc + reach) loads instead of Kq * Kc * windows.  Any other pair
//   takes the dense walk over every entry in the same kernel, so callers
//   owe it no precondition; a NaN entry there (a non-finite intensity)
//   makes the pair take nothing, as the dense loop's NaN argmax does, and
//   a +inf entry (the direct rule's infinite query peak that matches)
//   sorts before every finite one;
// * the positive entries become 64-bit keys ((value desc, i asc, j asc)
//   in ascending order) in shared memory; up to kWideList of them a rank
//   sort orders, and one warp walks them 32 at a time, taking each whose
//   row and column are still free: the dense loop's picks in its order
//   (the identity of ops/shifted_dot.py::greedy_over_positives), `total
//   += best` in selection order;
// * a pair with more positive entries (a wide tolerance) keeps, for each
//   row, its best live entries (value desc, j asc), as many as the
//   list's 16 KB hold (wide_row_depth: 6 at K = 300), in shared memory;
//   each step takes the block's argmax over the rows' first live entries
//   (value desc, i asc), and a row rescans its entries only when its
//   cache runs out.  Worst case, every row prefers the same column in
//   turn: K / depth rescans of every row, K^3 / (2 depth) entries (per
//   window on the search rule) over the block's threads.
//
// A block a pair spreads any pair count over the SMs (at K = 300 and
// three shifts: 320 threads and 21,496 bytes of dynamic shared memory a
// block).  Past about K = 8,500 the row and its state no longer fit in
// shared memory; the same kernel then keeps them in a device-memory
// workspace the wrapper allocates (shifted_dot_workspace_bytes), and past
// K = 65,536, where a list key cannot hold i and j, every pair takes the
// overflow path: any K runs.  shifted_dot_wide_plan reports the layout.
//
// Arithmetic matches the plain PyTorch version bit for bit: IEEE division
// for prec_diff / s (build without fast-math; -fmad=false keeps every
// product and sum separately rounded), the product order
// (mult * q_int) * c_int, and `total += best` in selection order.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPeaks = 128;
constexpr int kCols = kMaxPeaks / kWarp;  // candidate peaks a lane holds
constexpr int kWarps = 8;                 // pairs a block
constexpr int kList = 256;                // positive entries kept a pair
constexpr size_t kSmemDefault = 48 * 1024;

// 32-bit words of shared memory one warp uses: q_mz, q_int, match and the
// taken columns (K each), the shift offsets, the list's values and (i, j).
__host__ __device__ inline int offset_words(int num_shifts) {
  return num_shifts > 1 ? num_shifts : 1;
}
__host__ __device__ inline size_t warp_smem_words(int k, int num_shifts) {
  return 4 * (size_t)k + offset_words(num_shifts) + 2 * (size_t)kList;
}

// Entry (i, j) of the match-score matrix; off[s] = prec_diff / s;
// `direct`: the direct rule (no shifts, n_shift is 0).
__device__ __forceinline__ float entry(float qmz, float qint, float cmz,
                                       float cint, int ann, int n_shift,
                                       const float* off, float tol,
                                       bool direct) {
  const float diff = qmz - cmz;
  if (direct) return (fabsf(diff) <= tol ? qint : 0.0f) * cint;
  float mult = fabsf(diff) <= tol ? 1.0f : 0.0f;
  for (int s = 1; s <= n_shift; ++s) {
    if (fabsf(diff - off[s]) <= tol) {
      const float m =
          ann == s ? 1.0f : (ann == 0 ? (float)(2.0 / 3.0) : 0.0f);
      mult = fmaxf(mult, m);
    }
  }
  return (mult * qint) * cint;
}

// Compacts the pair's positive entries into (s_val, s_ij), in ascending
// flat order (row by row, and in a row by ballot order, j = 32 c + lane);
// returns how many there are (only the first kList are stored).  NS >= 0
// is the number of active shifts, unrolled with each column's multipliers
// in registers; NS < 0 takes any count through `entry`.  The same
// operations in the same order either way, but that NS >= 0 multiplies
// where the direct rule selects: it serves only pairs of finite
// intensities, whose entries then differ at most in the sign of a zero,
// which no step reads.  kNan: the pair has a non-finite intensity, and
// `has_nan` is set (the same on every lane) when an entry is NaN.
template <int NS, bool kNan = false>
__device__ __forceinline__ int compact_positive(
    const float* s_qmz, const float* s_qint, const float (&cmz)[kCols],
    const float (&cint)[kCols], const int (&cann)[kCols], int k,
    int n_shift, const float* s_off, float tol, bool direct, int lane,
    float* s_val, int* s_ij, bool& has_nan) {
  constexpr int kNS = NS > 0 ? NS : 1;
  float off[kNS], mul[kCols][kNS];
#pragma unroll
  for (int s = 0; s < kNS; ++s) {
    off[s] = NS > 0 ? s_off[s + 1] : 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      mul[c][s] = cann[c] == s + 1 ? 1.0f
                                   : (cann[c] == 0 ? (float)(2.0 / 3.0) : 0.0f);
  }
  int n = 0;
  bool lane_nan = false;
  for (int i = 0; i < k; ++i) {
    const float qm = s_qmz[i];
    const float qi = s_qint[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c * kWarp >= k) break;  // uniform across the warp
      const int j = c * kWarp + lane;
      float v = 0.0f;
      if (j < k) {
        if (NS < 0) {
          v = entry(qm, qi, cmz[c], cint[c], cann[c], n_shift, s_off, tol,
                    direct);
        } else {
          const float diff = qm - cmz[c];
          float mult = fabsf(diff) <= tol ? 1.0f : 0.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            if (fabsf(diff - off[s]) <= tol) mult = fmaxf(mult, mul[c][s]);
          }
          v = (mult * qi) * cint[c];
        }
      }
      if (kNan) lane_nan |= v != v;
      const unsigned pos = __ballot_sync(kFull, v > 0.0f);
      if (v > 0.0f) {
        const int at = n + __popc(pos & ((1u << lane) - 1u));
        if (at < kList) {
          s_val[at] = v;
          s_ij[at] = (i << 16) | j;
        }
      }
      n += __popc(pos);
    }
  }
  if (kNan) has_nan = __any_sync(kFull, lane_nan);
  return n;
}

__global__ void __launch_bounds__(kWarps * kWarp) shifted_dot_greedy_kernel(
    const float* __restrict__ q_mz, const float* __restrict__ q_int,
    const float* __restrict__ c_mz, const float* __restrict__ c_int,
    const int* __restrict__ c_ann, const float* __restrict__ q_prec,
    const float* __restrict__ c_prec, const int* __restrict__ charge,
    float* __restrict__ total_out, int* __restrict__ match_out,
    int n_pairs, int k, float tol, int num_shifts, int allow_shift) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= n_pairs) return;  // whole warp leaves together

  float* s_qmz = smem + (size_t)warp * warp_smem_words(k, num_shifts);
  float* s_qint = s_qmz + k;
  int* s_match = reinterpret_cast<int*>(s_qint + k);
  int* s_taken = s_match + k;
  float* s_off = reinterpret_cast<float*>(s_taken + k);
  float* s_val = s_off + offset_words(num_shifts);
  int* s_ij = reinterpret_cast<int*>(s_val + kList);

  const size_t row = (size_t)pair * k;
  float cmz[kCols], cint[kCols];
  int cann[kCols];
  bool lane_finite = true;  // the intensities this lane loads
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = c * kWarp + lane;
    cmz[c] = j < k ? c_mz[row + j] : 0.0f;
    cint[c] = j < k ? c_int[row + j] : 0.0f;
    cann[c] = j < k ? c_ann[row + j] : -1;
    lane_finite = lane_finite && fabsf(cint[c]) < CUDART_INF_F;
  }
  for (int t = lane; t < k; t += kWarp) {
    s_qmz[t] = q_mz[row + t];
    s_qint[t] = q_int[row + t];
    s_match[t] = -1;
    s_taken[t] = 0;
    lane_finite = lane_finite && fabsf(s_qint[t]) < CUDART_INF_F;
  }
  // A NaN entry needs a non-finite intensity (the multipliers are 0, 2/3
  // or 1, and no product of finite values is NaN): only such a pair
  // checks its entries, on the generic path.
  const bool finite = __all_sync(kFull, lane_finite);
  const int chg = charge[pair];
  const float prec_diff = (q_prec[pair] - c_prec[pair]) * (float)chg;
  const bool shifted =
      allow_shift && num_shifts > 1 && fabsf(prec_diff) >= tol;
  // Active shifts 1..n_shift: s < num_shifts and s <= charge.
  const int n_shift = shifted ? min(num_shifts - 1, chg) : 0;
  // The direct rule is the flags' (a pair with n_shift 0 under shifts
  // keeps the product).
  const bool direct = !(allow_shift && num_shifts > 1);
  for (int s = lane; s < num_shifts; s += kWarp) {
    s_off[s] = s > 0 ? prec_diff / (float)s : 0.0f;
  }
  __syncwarp();

  // finite and n_shift are uniform across the warp: one branch runs.
  bool has_nan = false;
  const int n =
      !finite ? compact_positive<-1, true>(s_qmz, s_qint, cmz, cint, cann, k,
                                           n_shift, s_off, tol, direct, lane,
                                           s_val, s_ij, has_nan)
      : n_shift <= 0 ? compact_positive<0>(s_qmz, s_qint, cmz, cint, cann, k,
                                           n_shift, s_off, tol, direct, lane,
                                           s_val, s_ij, has_nan)
      : n_shift == 1 ? compact_positive<1>(s_qmz, s_qint, cmz, cint, cann, k,
                                           n_shift, s_off, tol, direct, lane,
                                           s_val, s_ij, has_nan)
      : n_shift == 2 ? compact_positive<2>(s_qmz, s_qint, cmz, cint, cann, k,
                                           n_shift, s_off, tol, direct, lane,
                                           s_val, s_ij, has_nan)
                     : compact_positive<-1>(s_qmz, s_qint, cmz, cint, cann,
                                            k, n_shift, s_off, tol, direct,
                                            lane, s_val, s_ij, has_nan);
  __syncwarp();

  // Greedy assignment: at most K rounds, each taking one row and column;
  // none for a pair with a NaN entry (the dense loop's argmax is NaN, not
  // > 0).  (i << 16 | j) orders entries as their flat index i * K + j does.
  const bool listed = n <= kList;
  float total = 0.0f;
  for (int step = 0; step < (has_nan ? 0 : k); ++step) {
    float best = -CUDART_INF_F;
    int best_ij = 0x7fffffff;
    if (listed) {
      for (int t = lane; t < n; t += kWarp) {  // ascending: strict > keeps
        const int ij = s_ij[t];                // the lowest index
        if (s_match[ij >> 16] >= 0 || s_taken[ij & 0xffff]) continue;
        const float v = s_val[t];
        if (v > best) {
          best = v;
          best_ij = ij;
        }
      }
    } else {  // the live entries, recomputed in ascending order
      for (int i = 0; i < k; ++i) {
        if (s_match[i] >= 0) continue;  // uniform across the warp
        const float qm = s_qmz[i];
        const float qi = s_qint[i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = c * kWarp + lane;
          if (j >= k || s_taken[j]) continue;
          const float v = entry(qm, qi, cmz[c], cint[c], cann[c], n_shift,
                                s_off, tol, direct);
          if (v > best) {
            best = v;
            best_ij = (i << 16) | j;
          }
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, best_ij, off);
      if (ov > best || (ov == best && oi < best_ij)) {
        best = ov;
        best_ij = oi;
      }
    }
    if (!(best > 0.0f)) break;  // uniform across the warp
    total += best;
    __syncwarp();  // every lane has finished reading before the update
    if (lane == 0) {
      s_match[best_ij >> 16] = best_ij & 0xffff;
      s_taken[best_ij & 0xffff] = 1;
    }
    __syncwarp();
  }

  for (int t = lane; t < k; t += kWarp) match_out[row + t] = s_match[t];
  if (lane == 0) total_out[pair] = total;
}

// The wide branch (K > kMaxPeaks): one block a pair, a query peak a
// thread (see the header for the design).
constexpr int kWideThreads = 1024;  // the most threads a block
constexpr int kWideList = 1024;     // positive entries sorted on chip
constexpr int kWideKeyPeaks = 1 << 16;  // K a list key holds (16-bit i, j)
// Dynamic shared memory a wide block may take: the opt-in limit (227 KB)
// less 1 KB for the kernel's static arrays.  A pair whose state needs more
// keeps it in a device-memory workspace instead.
constexpr size_t kWideSmemMax = 226 * 1024;

// Threads of the block that scores one pair: one a query peak, in whole
// warps, at most kWideThreads (each thread then takes every
// kWideThreads-th peak).
__host__ __device__ inline int wide_threads(int k) {
  const int t = (k + kWarp - 1) / kWarp * kWarp;
  return t < kWideThreads ? t : kWideThreads;
}

// A wide pair's state, in bytes: first a region that holds the positive
// entries' keys and their sorted copy (8 B each) or, on the overflow path,
// each row's cache of its best live entries, rounded up to 16 bytes so
// that what follows is aligned at any K; then the candidate peaks' m/z,
// intensity and annotation and each query peak's match (4 B each a peak),
// the shift offsets and a taken flag a column.
__host__ __device__ inline size_t wide_region_bytes(int k) {
  const size_t list = 2 * sizeof(unsigned long long) * kWideList;
  const size_t rows = 10 * (size_t)k;
  return ((list > rows ? list : rows) + 15) & ~(size_t)15;
}
// Entries the overflow path caches a row: 8 bytes each, beside a head and
// a length byte a row, in the region (at least one; 6 at K = 300).
__host__ __device__ inline int wide_row_depth(int k) {
  return (int)((wide_region_bytes(k) - 2 * (size_t)k) / (8 * (size_t)k));
}
__host__ __device__ inline size_t wide_state_bytes(int k, int num_shifts) {
  return wide_region_bytes(k) + 16 * (size_t)k +
         4 * (size_t)offset_words(num_shifts) + (size_t)k;
}
// The state of one pair in the workspace (a stride that keeps each pair's
// start 16-byte aligned), or 0 when it fits in shared memory.
__host__ __device__ inline size_t wide_workspace_stride(int k,
                                                        int num_shifts) {
  const size_t bytes = wide_state_bytes(k, num_shifts);
  return bytes > kWideSmemMax ? (bytes + 15) & ~(size_t)15 : 0;
}

// One pair as the wide kernel sees it: its query row in device memory,
// its candidate row and shift offsets in shared memory, and its rule.
struct WidePair {
  const float* q_mz;
  const float* q_int;
  const float* c_mz;
  const float* c_int;
  const int* c_ann;
  const float* off;  // off[s] = prec_diff / s
  float tol;
  int k;
  int n_pos;    // candidate peaks of positive intensity (a prefix)
  int n_shift;  // active shifts 1..n_shift
  bool direct;  // the direct rule (no shifts)
  bool search;  // the search rule holds
};

// The difference the plain version tests against tol in window w: the
// direct window (w = 0) or shift w.
__device__ __forceinline__ float window_diff(const WidePair& p, float qm,
                                             float cm, int w) {
  const float diff = qm - cm;
  return w == 0 ? diff : diff - p.off[w];
}

// True when (qm, cm) passes a window before w: then window w's walk
// leaves the entry to that window's.
__device__ __forceinline__ bool passes_before(const WidePair& p, float qm,
                                              float cm, int w) {
  if (w == 0) return false;
  const float diff = qm - cm;
  if (fabsf(diff) <= p.tol) return true;
  for (int s = 1; s < w; ++s) {
    if (fabsf(diff - p.off[s]) <= p.tol) return true;
  }
  return false;
}

// Calls fn(j, v) once for every entry v of row i that is positive or
// NaN (NaN only on the dense rule), v = entry(i, j) in full.  Search
// rule, for a query peak of positive intensity: in each active window w
// the candidate peaks of the ascending prefix that pass form one range
// (fl(q - c) does not increase along it, fl(y - off) does not decrease
// as y grows), so the first is found by a binary search on g_w <= tol
// and the range walked while g_w >= -tol, the plain tests on the plain
// f32 difference; each peak is evaluated in the first window it passes.
// Every other entry is <= 0: no window passes (mult 0), or the peak lies
// past the prefix (intensity <= 0).  A query peak of intensity +-0 has
// none; one of negative intensity takes the dense walk, as does every
// row of a pair off the rule.
template <class Fn>
__device__ __forceinline__ void row_entries(const WidePair& p, int i,
                                            Fn& fn) {
  const float qm = p.q_mz[i];
  const float qi = p.q_int[i];
  if (p.search && !(qi < 0.0f)) {
    if (!(qi > 0.0f)) return;
    for (int w = 0; w <= p.n_shift; ++w) {
      int lo = 0;
      for (int len = p.n_pos; len > 0;) {
        const int half = len >> 1;
        if (window_diff(p, qm, p.c_mz[lo + half], w) <= p.tol) {
          len = half;
        } else {
          lo += half + 1;
          len -= half + 1;
        }
      }
      for (int j = lo; j < p.n_pos; ++j) {
        const float cm = p.c_mz[j];
        if (!(window_diff(p, qm, cm, w) >= -p.tol)) break;
        if (passes_before(p, qm, cm, w)) continue;
        const float v = entry(qm, qi, cm, p.c_int[j], p.c_ann[j], p.n_shift,
                              p.off, p.tol, p.direct);
        if (v > 0.0f) fn(j, v);
      }
    }
  } else {
    for (int j = 0; j < p.k; ++j) {
      const float v = entry(qm, qi, p.c_mz[j], p.c_int[j], p.c_ann[j],
                            p.n_shift, p.off, p.tol, p.direct);
      if (!(v <= 0.0f)) fn(j, v);
    }
  }
}

// A positive entry as one 64-bit key whose ascending order is the
// greedy's (value desc, i asc, j asc): the value's bits inverted, then
// i and j in 16 bits each.  Positive floats order as their bits, +inf
// (0x7f800000) above every finite one; -inf is never listed (not > 0).
__device__ __forceinline__ unsigned long long wide_key(float v, int i,
                                                       int j) {
  return (unsigned long long)(~__float_as_uint(v)) << 32 |
         (unsigned)(i << 16 | j);
}

// (v, i) before (bv, bi) in the order (value desc, i asc); bi < 0: none.
__device__ __forceinline__ bool row_before(float v, int i, float bv,
                                           int bi) {
  return i >= 0 && (bi < 0 || v > bv || (v == bv && i < bi));
}

// row_entries' visitor for the list: appends (v, i, j) as a key while
// the list has room (cap entries), counts past it until the count passes
// cap (then only an overflow matters), and flags a NaN entry.
struct ListEntries {
  unsigned long long* keys;
  int* count;
  int* nan;
  int cap;
  int i;
  __device__ __forceinline__ void operator()(int j, float v) const {
    if (!(v > 0.0f)) {
      *nan = 1;
      return;
    }
    if (*(volatile int*)count > cap) return;
    const int at = atomicAdd(count, 1);
    if (at < cap) keys[at] = wide_key(v, i, j);
  }
};

// row_entries' visitor for the overflow path: keeps a row's best live
// entries (value desc, j asc), at most `depth`, sorted by insertion.
struct RowCache {
  const unsigned char* taken;
  float* cv;
  int* cj;
  int depth;
  int len;
  __device__ __forceinline__ void operator()(int j, float v) {
    if (!(v > 0.0f) || taken[j]) return;
    if (len == depth &&
        !(v > cv[len - 1] || (v == cv[len - 1] && j < cj[len - 1]))) {
      return;
    }
    int at = len < depth ? len++ : depth - 1;
    for (; at > 0 && (v > cv[at - 1] || (v == cv[at - 1] && j < cj[at - 1]));
         --at) {
      cv[at] = cv[at - 1];
      cj[at] = cj[at - 1];
    }
    cv[at] = v;
    cj[at] = j;
  }
};

// Fills row i's cache from its live entries (the row is free).
__device__ __forceinline__ void cache_row(const WidePair& p, int i,
                                          const unsigned char* taken,
                                          float* s_cv, int* s_cj, int depth,
                                          unsigned char* s_head,
                                          unsigned char* s_len) {
  RowCache cache{taken, s_cv + (size_t)i * depth, s_cj + (size_t)i * depth,
                 depth, 0};
  row_entries(p, i, cache);
  s_head[i] = 0;
  s_len[i] = (unsigned char)cache.len;
}

// kGlobal: the pair's state lives in `workspace` (wide_workspace_stride
// bytes a pair) instead of dynamic shared memory; the same code, on
// generic pointers.
template <bool kGlobal>
__global__ void __launch_bounds__(kWideThreads)
    shifted_dot_greedy_wide_kernel(
        const float* __restrict__ q_mz, const float* __restrict__ q_int,
        const float* __restrict__ c_mz, const float* __restrict__ c_int,
        const int* __restrict__ c_ann, const float* __restrict__ q_prec,
        const float* __restrict__ c_prec, const int* __restrict__ charge,
        float* __restrict__ total_out, int* __restrict__ match_out,
        unsigned char* __restrict__ workspace, int k, float tol,
        int num_shifts, int allow_shift) {
  extern __shared__ unsigned long long wide_smem[];
  __shared__ int s_count, s_nan, s_pick;
  __shared__ float s_red_v[kWideThreads / kWarp];
  __shared__ int s_red_i[kWideThreads / kWarp];
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int pair = blockIdx.x;
  const size_t row = (size_t)pair * k;

  unsigned long long* state =
      kGlobal ? reinterpret_cast<unsigned long long*>(
                    workspace +
                    (size_t)pair * wide_workspace_stride(k, num_shifts))
              : wide_smem;
  unsigned long long* s_key = state;
  unsigned long long* s_sorted = s_key + kWideList;
  float* s_cmz = reinterpret_cast<float*>(
      reinterpret_cast<char*>(state) + wide_region_bytes(k));
  float* s_cint = s_cmz + k;
  int* s_cann = reinterpret_cast<int*>(s_cint + k);
  int* s_match = s_cann + k;
  float* s_off = reinterpret_cast<float*>(s_match + k);
  unsigned char* s_taken =
      reinterpret_cast<unsigned char*>(s_off + offset_words(num_shifts));

  const int chg = charge[pair];
  const float prec_diff = (q_prec[pair] - c_prec[pair]) * (float)chg;
  const bool shifted =
      allow_shift && num_shifts > 1 && fabsf(prec_diff) >= tol;
  const int n_shift = shifted ? min(num_shifts - 1, chg) : 0;
  for (int s = tid; s < num_shifts; s += n_threads) {
    s_off[s] = s > 0 ? prec_diff / (float)s : 0.0f;
  }
  if (tid == 0) {
    s_count = 0;
    s_nan = 0;
  }

  // Stage the candidate row and check the branch rule
  // (ops/shifted_dot_cuda.py::search_pairs): its peaks of positive
  // intensity are a prefix with finite, non-decreasing m/z, and every
  // intensity of the pair and the tolerance are finite (so no entry is
  // NaN).  The barriers also publish the offsets and counters.
  int n_pos = 0;
  bool off_rule = false;
  for (int t0 = 0; t0 < k; t0 += n_threads) {  // the same trips everywhere
    const int t = t0 + tid;
    bool pos = false, bad = false;
    if (t < k) {
      const float cm = c_mz[row + t];
      const float ci = c_int[row + t];
      s_cmz[t] = cm;
      s_cint[t] = ci;
      s_cann[t] = c_ann[row + t];
      s_match[t] = -1;
      s_taken[t] = 0;
      pos = ci > 0.0f;
      bad = !isfinite(ci) || !isfinite(q_int[row + t]) ||
            (pos && !isfinite(cm)) ||
            (pos && t > 0 &&
             !(c_int[row + t - 1] > 0.0f && c_mz[row + t - 1] <= cm));
    }
    n_pos += __syncthreads_count(pos);
    off_rule = __syncthreads_or(bad) || off_rule;
  }
  const WidePair p{q_mz + row, q_int + row, s_cmz, s_cint, s_cann, s_off,
                   tol, k, n_pos, n_shift,
                   !(allow_shift && num_shifts > 1),
                   !off_rule && isfinite(tol)};

  // 1. The positive entries, as keys (ListEntries).  Past kWideKeyPeaks
  // (in the workspace only) a key cannot hold (i, j), and every pair
  // takes the overflow path.
  const int list_cap = !kGlobal || k <= kWideKeyPeaks ? kWideList : 0;
  for (int i = tid; i < k; i += n_threads) {
    const ListEntries list{s_key, &s_count, &s_nan, list_cap, i};
    row_entries(p, i, list);
  }
  __syncthreads();
  const int n = s_count;
  float total = 0.0f;  // kept by thread 0
  if (s_nan) {
    // A NaN entry: the dense greedy's first argmax is NaN, which is not
    // > 0, so it takes nothing.
  } else if (n <= list_cap) {
    // 2. Rank sort (keys are distinct), then 3. one warp walks the sorted
    // entries 32 at a time, taking each whose row and column are free:
    // the dense loop's picks in its order (ops/shifted_dot.py::
    // greedy_over_positives), total += value in that order.
    for (int e = tid; e < n; e += n_threads) {
      const unsigned long long key = s_key[e];
      int r = 0;
      for (int m = 0; m < n; ++m) r += s_key[m] < key;
      s_sorted[r] = key;
    }
    __syncthreads();
    if (warp == 0) {
      for (int base = 0; base < n; base += kWarp) {
        const int e = base + lane;
        const unsigned long long key = e < n ? s_sorted[e] : 0ull;
        const int i = (int)(key >> 16) & 0xffff;
        const int j = (int)key & 0xffff;
        const float v = __uint_as_float(~(unsigned)(key >> 32));
        bool live = e < n && s_match[i] < 0 && !s_taken[j];
        unsigned m;
        while ((m = __ballot_sync(kFull, live)) != 0u) {
          const int f = __ffs(m) - 1;  // the first live entry is taken
          const int fi = __shfl_sync(kFull, i, f);
          const int fj = __shfl_sync(kFull, j, f);
          total += __shfl_sync(kFull, v, f);
          if (lane == 0) {
            s_match[fi] = fj;
            s_taken[fj] = 1;
          }
          live = live && i != fi && j != fj;
        }
        __syncwarp();  // the next chunk reads the taken rows and columns
      }
    }
  } else {
    // 4. Overflow: each free row caches its best live entries, up to
    // `depth` of them in (value desc, j asc) order, in shared memory; its
    // first cached entry whose column is free is its best live entry
    // (every entry left out of a full cache comes after all of it).  Each
    // step takes the best over rows (value desc, i asc), the dense loop's
    // argmax; the rows whose best column it took move to their next live
    // cached entry, and rescan only when a full cache runs out.
    const int n_warps = n_threads / kWarp;
    const int depth = wide_row_depth(k);
    float* s_cv = reinterpret_cast<float*>(state);
    int* s_cj = reinterpret_cast<int*>(s_cv + (size_t)k * depth);
    unsigned char* s_head =
        reinterpret_cast<unsigned char*>(s_cj + (size_t)k * depth);
    unsigned char* s_len = s_head + k;
    for (int i = tid; i < k; i += n_threads) {
      cache_row(p, i, s_taken, s_cv, s_cj, depth, s_head, s_len);
    }
    __syncthreads();
    for (;;) {
      float bv = 0.0f;
      int bi = -1;
      for (int i = tid; i < k; i += n_threads) {
        if (s_head[i] < s_len[i]) {
          const float v = s_cv[(size_t)i * depth + s_head[i]];
          if (row_before(v, i, bv, bi)) {
            bv = v;
            bi = i;
          }
        }
      }
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (row_before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_red_v[warp] = bv;
        s_red_i[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bv = lane < n_warps ? s_red_v[lane] : 0.0f;
        bi = lane < n_warps ? s_red_i[lane] : -1;
        for (int o = kWarp / 2; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, o);
          const int oi = __shfl_xor_sync(kFull, bi, o);
          if (row_before(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          int j = -1;
          if (bi >= 0) {
            j = s_cj[(size_t)bi * depth + s_head[bi]];
            total += bv;
            s_match[bi] = j;
            s_taken[j] = 1;
            s_len[bi] = 0;  // the row is taken
          }
          s_pick = j;
        }
      }
      __syncthreads();
      const int taken = s_pick;
      if (taken < 0) break;  // uniform: read after the barrier
      for (int i = tid; i < k; i += n_threads) {
        int h = s_head[i];
        const int len = s_len[i];
        const int* cj = s_cj + (size_t)i * depth;
        if (h >= len || cj[h] != taken) continue;
        do {
          ++h;
        } while (h < len && s_taken[cj[h]]);
        if (h == len && len == depth) {
          cache_row(p, i, s_taken, s_cv, s_cj, depth, s_head, s_len);
        } else {
          s_head[i] = (unsigned char)h;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int t = tid; t < k; t += n_threads) match_out[row + t] = s_match[t];
  if (tid == 0) total_out[pair] = total;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// All pointers are device pointers to contiguous arrays: q_mz, q_int, c_mz,
// c_int, c_ann, match of shape (n_pairs, k); q_prec, c_prec, charge, total
// of shape (n_pairs,).  k above kMaxPeaks takes the wide kernel; where its
// state does not fit in shared memory, `workspace` holds
// shifted_dot_workspace_bytes(n_pairs, k, num_shifts) bytes (else it is
// unused and may be null).
int shifted_dot_greedy(const float* q_mz, const float* q_int,
                       const float* c_mz, const float* c_int,
                       const int* c_ann, const float* q_prec,
                       const float* c_prec, const int* charge, float* total,
                       int* match, void* workspace, int n_pairs, int k,
                       float tol, int num_shifts, int allow_shift,
                       void* stream) {
  if (n_pairs < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (n_pairs == 0) return (int)cudaSuccess;
  if (k > kMaxPeaks) {
    const int threads = wide_threads(k);
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    if (wide_workspace_stride(k, num_shifts) > 0) {
      if (ws == nullptr) return (int)cudaErrorInvalidValue;
      shifted_dot_greedy_wide_kernel<true>
          <<<n_pairs, threads, 0, (cudaStream_t)stream>>>(
              q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge,
              total, match, ws, k, tol, num_shifts, allow_shift);
      return (int)cudaGetLastError();
    }
    const size_t smem = wide_state_bytes(k, num_shifts);
    if (smem > kSmemDefault) {
      const cudaError_t err = cudaFuncSetAttribute(
          shifted_dot_greedy_wide_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    shifted_dot_greedy_wide_kernel<false>
        <<<n_pairs, threads, smem, (cudaStream_t)stream>>>(
            q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge, total,
            match, nullptr, k, tol, num_shifts, allow_shift);
    return (int)cudaGetLastError();
  }
  const size_t smem = kWarps * sizeof(float) * warp_smem_words(k, num_shifts);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        shifted_dot_greedy_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_pairs + kWarps - 1) / kWarps;
  shifted_dot_greedy_kernel<<<blocks, kWarps * kWarp, smem,
                              (cudaStream_t)stream>>>(
      q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge, total, match,
      n_pairs, k, tol, num_shifts, allow_shift);
  return (int)cudaGetLastError();
}

// Bytes of device memory shifted_dot_greedy's `workspace` must hold: 0
// unless k takes the wide kernel and a pair's state passes kWideSmemMax.
size_t shifted_dot_workspace_bytes(int n_pairs, int k, int num_shifts) {
  if (n_pairs < 1 || k <= kMaxPeaks) return 0;
  return (size_t)n_pairs * wide_workspace_stride(k, num_shifts);
}

// The wide kernel's launch at this k, the one source of its layout:
// plan[0] threads a block, plan[1] dynamic shared memory a block (0 when
// the state is in the workspace), plan[2] workspace bytes a pair, plan[3]
// the blocks an SM holds (the occupancy calculator's answer), plan[4]
// the positive entries the list sorts on chip, plan[5] the entries the
// overflow path caches a row; returns a CUDA error code (0 = ok).
int shifted_dot_wide_plan(int k, int num_shifts, long long* plan) {
  if (k <= kMaxPeaks) return (int)cudaErrorInvalidValue;
  const size_t stride = wide_workspace_stride(k, num_shifts);
  const size_t smem = stride > 0 ? 0 : wide_state_bytes(k, num_shifts);
  const void* kernel =
      stride > 0 ? (const void*)shifted_dot_greedy_wide_kernel<true>
                 : (const void*)shifted_dot_greedy_wide_kernel<false>;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, wide_threads(k), smem);
  plan[0] = wide_threads(k);
  plan[1] = (long long)smem;
  plan[2] = (long long)stride;
  plan[3] = per_sm;
  plan[4] = k <= kWideKeyPeaks ? kWideList : 0;
  plan[5] = wide_row_depth(k);
  return (int)err;
}

const char* shifted_dot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
