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
// and runs the greedy one-to-one assignment of SpectrumMatch.cpp:92-111:
// repeatedly take the largest entry (ties to the lowest flat index i*K+j),
// add it to the total, zero its row and column, until no entry is > 0.
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
// columns no longer fit in a lane's registers, so the warp compacts the
// positive entries tile by tile of 128 columns (four a lane in registers,
// the same arithmetic), walking every row for each tile; the query peaks
// are read from device memory (a warp-wide broadcast), the pair's match
// and taken columns live in its row of `match` and of a workspace the
// wrapper allocates (lane 0 updates them between two __syncwarp), and the
// list holds up to kListWide entries of (value, i, j).  The list is in
// tile order, not flat order, so its argmax compares (value desc, i asc,
// j asc) explicitly: the same entry as the dense loop's first maximum.  A
// pair with more positives recomputes the live entries at each step, row
// by row.  Same picks, same order, `total += best` in selection order.
// Its speed is recorded, not tuned: K = 50 keeps the bench's branch.
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
constexpr int kListWide = 1024;           // the same, wide branch
constexpr size_t kSmemDefault = 48 * 1024;

// 32-bit words of shared memory one warp uses: q_mz, q_int, match and the
// taken columns (K each), the shift offsets, the list's values and (i, j).
__host__ __device__ inline int offset_words(int num_shifts) {
  return num_shifts > 1 ? num_shifts : 1;
}
__host__ __device__ inline size_t warp_smem_words(int k, int num_shifts) {
  return 4 * (size_t)k + offset_words(num_shifts) + 2 * (size_t)kList;
}

// Entry (i, j) of the match-score matrix; off[s] = prec_diff / s.
__device__ __forceinline__ float entry(float qmz, float qint, float cmz,
                                       float cint, int ann, int n_shift,
                                       const float* off, float tol) {
  const float diff = qmz - cmz;
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
// operations in the same order either way.
template <int NS>
__device__ __forceinline__ int compact_positive(
    const float* s_qmz, const float* s_qint, const float (&cmz)[kCols],
    const float (&cint)[kCols], const int (&cann)[kCols], int k,
    int n_shift, const float* s_off, float tol, int lane, float* s_val,
    int* s_ij) {
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
          v = entry(qm, qi, cmz[c], cint[c], cann[c], n_shift, s_off, tol);
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
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = c * kWarp + lane;
    cmz[c] = j < k ? c_mz[row + j] : 0.0f;
    cint[c] = j < k ? c_int[row + j] : 0.0f;
    cann[c] = j < k ? c_ann[row + j] : -1;
  }
  for (int t = lane; t < k; t += kWarp) {
    s_qmz[t] = q_mz[row + t];
    s_qint[t] = q_int[row + t];
    s_match[t] = -1;
    s_taken[t] = 0;
  }
  const int chg = charge[pair];
  const float prec_diff = (q_prec[pair] - c_prec[pair]) * (float)chg;
  const bool shifted =
      allow_shift && num_shifts > 1 && fabsf(prec_diff) >= tol;
  // Active shifts 1..n_shift: s < num_shifts and s <= charge.
  const int n_shift = shifted ? min(num_shifts - 1, chg) : 0;
  for (int s = lane; s < num_shifts; s += kWarp) {
    s_off[s] = s > 0 ? prec_diff / (float)s : 0.0f;
  }
  __syncwarp();

  // n_shift is uniform across the warp: one branch runs.
  const int n =
      n_shift <= 0 ? compact_positive<0>(s_qmz, s_qint, cmz, cint, cann, k,
                                         n_shift, s_off, tol, lane, s_val,
                                         s_ij)
      : n_shift == 1 ? compact_positive<1>(s_qmz, s_qint, cmz, cint, cann, k,
                                           n_shift, s_off, tol, lane, s_val,
                                           s_ij)
      : n_shift == 2 ? compact_positive<2>(s_qmz, s_qint, cmz, cint, cann, k,
                                           n_shift, s_off, tol, lane, s_val,
                                           s_ij)
                     : compact_positive<-1>(s_qmz, s_qint, cmz, cint, cann,
                                            k, n_shift, s_off, tol, lane,
                                            s_val, s_ij);
  __syncwarp();

  // Greedy assignment: at most K rounds, each taking one row and column.
  // (i << 16 | j) orders entries as their flat index i * K + j does.
  const bool listed = n <= kList;
  float total = 0.0f;
  for (int step = 0; step < k; ++step) {
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
          const float v =
              entry(qm, qi, cmz[c], cint[c], cann[c], n_shift, s_off, tol);
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

// The wide branch's entry order: (value desc, i asc, j asc); true when
// (v, i, j) comes before (bv, bi, bj).
__device__ __forceinline__ bool before(float v, int i, int j, float bv,
                                       int bi, int bj) {
  return v > bv || (v == bv && (i < bi || (i == bi && j < bj)));
}

// compact_positive over any K: for each tile of kMaxPeaks columns (in
// registers, j = t0 + 32 c + lane), every row i; the entries in (tile,
// row, ballot) order, the first kListWide of them stored.
template <int NS>
__device__ __forceinline__ int compact_wide(
    const float* q_mz, const float* q_int, const float* c_mz,
    const float* c_int, const int* c_ann, int k, int n_shift,
    const float* s_off, float tol, int lane, float* s_val, int* s_i,
    int* s_j) {
  constexpr int kNS = NS > 0 ? NS : 1;
  float off[kNS];
#pragma unroll
  for (int s = 0; s < kNS; ++s) off[s] = NS > 0 ? s_off[s + 1] : 0.0f;
  int n = 0;
  for (int t0 = 0; t0 < k; t0 += kMaxPeaks) {
    float cmz[kCols], cint[kCols], mul[kCols][kNS];
    int cann[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = t0 + c * kWarp + lane;
      cmz[c] = j < k ? c_mz[j] : 0.0f;
      cint[c] = j < k ? c_int[j] : 0.0f;
      cann[c] = j < k ? c_ann[j] : -1;
#pragma unroll
      for (int s = 0; s < kNS; ++s) {
        mul[c][s] = cann[c] == s + 1
                        ? 1.0f
                        : (cann[c] == 0 ? (float)(2.0 / 3.0) : 0.0f);
      }
    }
    for (int i = 0; i < k; ++i) {
      const float qm = q_mz[i];
      const float qi = q_int[i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (t0 + c * kWarp >= k) break;  // uniform across the warp
        const int j = t0 + c * kWarp + lane;
        float v = 0.0f;
        if (j < k) {
          if (NS < 0) {
            v = entry(qm, qi, cmz[c], cint[c], cann[c], n_shift, s_off, tol);
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
        const unsigned pos = __ballot_sync(kFull, v > 0.0f);
        if (v > 0.0f) {
          const int at = n + __popc(pos & ((1u << lane) - 1u));
          if (at < kListWide) {
            s_val[at] = v;
            s_i[at] = i;
            s_j[at] = j;
          }
        }
        n += __popc(pos);
      }
    }
  }
  return n;
}

// Shared memory words of one warp of the wide kernel: the shift offsets
// and the list's values, rows and columns.
__host__ __device__ inline size_t wide_warp_smem_words(int num_shifts) {
  return offset_words(num_shifts) + 3 * (size_t)kListWide;
}

// The wide branch: one warp a pair; `taken` (n_pairs, k) is workspace.
__global__ void __launch_bounds__(kWarps * kWarp)
    shifted_dot_greedy_wide_kernel(
        const float* __restrict__ q_mz, const float* __restrict__ q_int,
        const float* __restrict__ c_mz, const float* __restrict__ c_int,
        const int* __restrict__ c_ann, const float* __restrict__ q_prec,
        const float* __restrict__ c_prec, const int* __restrict__ charge,
        float* total_out, int* match_out, int* taken_out, int n_pairs, int k,
        float tol, int num_shifts, int allow_shift) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= n_pairs) return;  // whole warp leaves together

  float* s_off = smem + (size_t)warp * wide_warp_smem_words(num_shifts);
  float* s_val = s_off + offset_words(num_shifts);
  int* s_i = reinterpret_cast<int*>(s_val + kListWide);
  int* s_j = s_i + kListWide;

  const size_t row = (size_t)pair * k;
  const float* qm_row = q_mz + row;
  const float* qi_row = q_int + row;
  const float* cm_row = c_mz + row;
  const float* ci_row = c_int + row;
  const int* ca_row = c_ann + row;
  int* match = match_out + row;
  int* taken = taken_out + row;
  for (int t = lane; t < k; t += kWarp) {
    match[t] = -1;
    taken[t] = 0;
  }
  const int chg = charge[pair];
  const float prec_diff = (q_prec[pair] - c_prec[pair]) * (float)chg;
  const bool shifted =
      allow_shift && num_shifts > 1 && fabsf(prec_diff) >= tol;
  const int n_shift = shifted ? min(num_shifts - 1, chg) : 0;
  for (int s = lane; s < num_shifts; s += kWarp) {
    s_off[s] = s > 0 ? prec_diff / (float)s : 0.0f;
  }
  __syncwarp();

  const int n =
      n_shift <= 0 ? compact_wide<0>(qm_row, qi_row, cm_row, ci_row, ca_row,
                                     k, n_shift, s_off, tol, lane, s_val,
                                     s_i, s_j)
      : n_shift == 1 ? compact_wide<1>(qm_row, qi_row, cm_row, ci_row,
                                       ca_row, k, n_shift, s_off, tol, lane,
                                       s_val, s_i, s_j)
      : n_shift == 2 ? compact_wide<2>(qm_row, qi_row, cm_row, ci_row,
                                       ca_row, k, n_shift, s_off, tol, lane,
                                       s_val, s_i, s_j)
                     : compact_wide<-1>(qm_row, qi_row, cm_row, ci_row,
                                        ca_row, k, n_shift, s_off, tol, lane,
                                        s_val, s_i, s_j);
  __syncwarp();

  const bool listed = n <= kListWide;
  float total = 0.0f;
  for (int step = 0; step < k; ++step) {
    float best = -CUDART_INF_F;
    int best_i = 0x7fffffff, best_j = 0x7fffffff;
    if (listed) {
      for (int t = lane; t < n; t += kWarp) {
        const int i = s_i[t], j = s_j[t];
        if (match[i] >= 0 || taken[j]) continue;
        const float v = s_val[t];
        if (before(v, i, j, best, best_i, best_j)) {
          best = v;
          best_i = i;
          best_j = j;
        }
      }
    } else {  // the live entries, recomputed row by row
      for (int i = 0; i < k; ++i) {
        if (match[i] >= 0) continue;  // uniform across the warp
        const float qm = qm_row[i];
        const float qi = qi_row[i];
        for (int j = lane; j < k; j += kWarp) {
          if (taken[j]) continue;
          const float v = entry(qm, qi, cm_row[j], ci_row[j], ca_row[j],
                                n_shift, s_off, tol);
          if (before(v, i, j, best, best_i, best_j)) {
            best = v;
            best_i = i;
            best_j = j;
          }
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, best_i, off);
      const int oj = __shfl_xor_sync(kFull, best_j, off);
      if (before(ov, oi, oj, best, best_i, best_j)) {
        best = ov;
        best_i = oi;
        best_j = oj;
      }
    }
    if (!(best > 0.0f)) break;  // uniform across the warp
    total += best;
    __syncwarp();  // every lane has finished reading before the update
    if (lane == 0) {
      match[best_i] = best_j;
      taken[best_j] = 1;
    }
    __syncwarp();
  }
  if (lane == 0) total_out[pair] = total;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// All pointers are device pointers to contiguous arrays: q_mz, q_int, c_mz,
// c_int, c_ann, match of shape (n_pairs, k); q_prec, c_prec, charge, total
// of shape (n_pairs,).  k above kMaxPeaks takes the wide kernel, whose
// workspace `taken` is int32 (n_pairs, k) (unused, and may be null, at
// k <= kMaxPeaks).
int shifted_dot_greedy(const float* q_mz, const float* q_int,
                       const float* c_mz, const float* c_int,
                       const int* c_ann, const float* q_prec,
                       const float* c_prec, const int* charge, float* total,
                       int* match, int* taken, int n_pairs, int k, float tol,
                       int num_shifts, int allow_shift, void* stream) {
  if (n_pairs < 0 || k < 1 || (k > kMaxPeaks && taken == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_pairs == 0) return (int)cudaSuccess;
  const bool wide = k > kMaxPeaks;
  const size_t smem =
      kWarps * sizeof(float) *
      (wide ? wide_warp_smem_words(num_shifts)
            : warp_smem_words(k, num_shifts));
  const void* kernel = wide ? (const void*)shifted_dot_greedy_wide_kernel
                            : (const void*)shifted_dot_greedy_kernel;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_pairs + kWarps - 1) / kWarps;
  if (wide) {
    shifted_dot_greedy_wide_kernel<<<blocks, kWarps * kWarp, smem,
                                     (cudaStream_t)stream>>>(
        q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge, total,
        match, taken, n_pairs, k, tol, num_shifts, allow_shift);
  } else {
    shifted_dot_greedy_kernel<<<blocks, kWarps * kWarp, smem,
                                (cudaStream_t)stream>>>(
        q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge, total,
        match, n_pairs, k, tol, num_shifts, allow_shift);
  }
  return (int)cudaGetLastError();
}

const char* shifted_dot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
