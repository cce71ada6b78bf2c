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
// What bounds it on the H100: not HBM (a pair reads ~1 KB and does
// O(K^3) compare/select work, K^2 entries per greedy step), but the K^2
// compare/select work per pair and the shared memory that holds the K x K
// matrix, which sets how many pairs are in flight per SM.  The design: one
// warp per pair, its matrix in shared memory (10 KB at K = 50, 64 KB at
// K = 128), each greedy step a strided scan plus a 5-step shuffle
// reduction on (value, flat index), early exit once the maximum is <= 0
// (typical candidates match only a handful of peaks).  Up to 8 warps share
// a block, sized so that two blocks fit an SM at K = 50.
//
// Arithmetic matches the plain PyTorch version bit for bit: IEEE division
// for prec_diff / s (build without fast-math; -fmad=false keeps every
// product and sum separately rounded), the product order
// (mult * q_int) * c_int, and `total += best` in selection order.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxPeaks = 128;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kSmemTarget = 96 * 1024;  // per block: two blocks per SM
constexpr size_t kSmemDefault = 48 * 1024;

// Floats of shared memory one warp uses: the K x K matrix, four peak rows
// (q_mz, q_int, c_mz, c_int) and two int rows (c_ann, match).
__host__ __device__ inline size_t warp_smem_words(int k) {
  return (size_t)k * k + 6 * (size_t)k;
}

__global__ void shifted_dot_greedy_kernel(
    const float* __restrict__ q_mz, const float* __restrict__ q_int,
    const float* __restrict__ c_mz, const float* __restrict__ c_int,
    const int* __restrict__ c_ann, const float* __restrict__ q_prec,
    const float* __restrict__ c_prec, const int* __restrict__ charge,
    float* __restrict__ total_out, int* __restrict__ match_out,
    int n_pairs, int k, float tol, int num_shifts, int allow_shift) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int pair = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (pair >= n_pairs) return;  // whole warp leaves together

  const int kk = k * k;
  float* mat = smem + (size_t)warp * warp_smem_words(k);
  float* s_qmz = mat + kk;
  float* s_qint = s_qmz + k;
  float* s_cmz = s_qint + k;
  float* s_cint = s_cmz + k;
  int* s_ann = reinterpret_cast<int*>(s_cint + k);
  int* s_match = s_ann + k;

  const size_t row = (size_t)pair * k;
  for (int t = lane; t < k; t += kWarp) {
    s_qmz[t] = q_mz[row + t];
    s_qint[t] = q_int[row + t];
    s_cmz[t] = c_mz[row + t];
    s_cint[t] = c_int[row + t];
    s_ann[t] = c_ann[row + t];
    s_match[t] = -1;
  }
  __syncwarp();

  const int chg = charge[pair];
  const float prec_diff = (q_prec[pair] - c_prec[pair]) * (float)chg;
  const bool shifted =
      allow_shift && num_shifts > 1 && fabsf(prec_diff) >= tol;
  const float two_thirds = (float)(2.0 / 3.0);

  // Match-score matrix, one flat entry per lane per stride.
  for (int f = lane; f < kk; f += kWarp) {
    const int i = f / k;
    const int j = f - i * k;
    const float diff = s_qmz[i] - s_cmz[j];
    float mult = fabsf(diff) <= tol ? 1.0f : 0.0f;
    if (shifted) {
      const int ann = s_ann[j];
      for (int s = 1; s < num_shifts && s <= chg; ++s) {
        const float offset = prec_diff / (float)s;
        if (fabsf(diff - offset) <= tol) {
          const float m = ann == s ? 1.0f : (ann == 0 ? two_thirds : 0.0f);
          mult = fmaxf(mult, m);
        }
      }
    }
    mat[f] = (mult * s_qint[i]) * s_cint[j];
  }
  __syncwarp();

  // Greedy assignment: at most K rounds, each consuming one row and column.
  float total = 0.0f;
  for (int step = 0; step < k; ++step) {
    float best = -CUDART_INF_F;
    int idx = kk;
    for (int f = lane; f < kk; f += kWarp) {
      const float v = mat[f];
      if (v > best) {  // ascending f: the strict > keeps the lowest index
        best = v;
        idx = f;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, best, off);
      const int oi = __shfl_xor_sync(kFullMask, idx, off);
      if (ov > best || (ov == best && oi < idx)) {
        best = ov;
        idx = oi;
      }
    }
    if (!(best > 0.0f)) break;  // uniform across the warp
    total += best;
    const int i = idx / k;
    const int j = idx - i * k;
    if (lane == 0) s_match[i] = j;
    __syncwarp();  // every lane has finished reading before the zeroing
    for (int t = lane; t < k; t += kWarp) {
      mat[i * k + t] = 0.0f;
      mat[t * k + j] = 0.0f;
    }
    __syncwarp();
  }

  for (int t = lane; t < k; t += kWarp) match_out[row + t] = s_match[t];
  if (lane == 0) total_out[pair] = total;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// All pointers are device pointers to contiguous arrays: q_mz, q_int, c_mz,
// c_int, c_ann, match of shape (n_pairs, k); q_prec, c_prec, charge, total
// of shape (n_pairs,).
int shifted_dot_greedy(const float* q_mz, const float* q_int,
                       const float* c_mz, const float* c_int,
                       const int* c_ann, const float* q_prec,
                       const float* c_prec, const int* charge, float* total,
                       int* match, int n_pairs, int k, float tol,
                       int num_shifts, int allow_shift, void* stream) {
  if (n_pairs < 0 || k < 1 || k > kMaxPeaks) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_pairs == 0) return (int)cudaSuccess;
  const size_t per_warp = warp_smem_words(k) * sizeof(float);
  int warps = (int)(kSmemTarget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarpsPerBlock ? kMaxWarpsPerBlock
                                                      : warps);
  const size_t smem = (size_t)warps * per_warp;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        shifted_dot_greedy_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_pairs + warps - 1) / warps;
  shifted_dot_greedy_kernel<<<blocks, warps * kWarp, smem,
                              (cudaStream_t)stream>>>(
      q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charge, total, match,
      n_pairs, k, tol, num_shifts, allow_shift);
  return (int)cudaGetLastError();
}

const char* shifted_dot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
