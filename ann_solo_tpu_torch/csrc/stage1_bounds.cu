// Rescore stage 1 for Hopper (sm_90a): the certificate's upper bounds.
//
// Replaces ann_solo_tpu/ops/rescore.py::_stage1_bounds, which is XLA code
// of the reference (one jitted program, no Pallas kernel).  For every
// (query row b, candidate slot c) of a (B, C) candidate matrix whose id is
// valid (>= 0), the bound is
//
//   ub = (sum_i q_int[i] * vmax[i]) * (1 + 2^-20),
//   vmax[i] = max(+0, max_j over library peaks j of the candidate of
//                 c_int[j]              if |q_mz[i] - c_mz[j]| <= tol,
//                 mult_s * c_int[j]     if |(q_mz[i] - c_mz[j]) - off_s|
//                                          <= tol, s = 1..num_shifts-1),
//   prec_diff = (q_prec - c_prec) * chg, chg = num_shifts - 1 with shifts
//   on, else 1; off_s = prec_diff / s; mult_s = 1 if c_ann[j] == s, 2/3
//   if c_ann[j] == 0, else 0; the shifted terms only with allow_shift,
//   num_shifts > 1 and |prec_diff| >= tol.
//
// An invalid id writes -inf and reads no peaks; an id >= n_lib reads row
// n_lib - 1, as the reference clips it.
//
// What bounds it on the H100: operations.  A pair needs about
// Kq * Kc * (5 * n_shifts + 2) float operations (a bench batch of
// 4,096 x 512 pairs at K = 50 and three shifts: 8.9e10, 1.3 ms at 67
// TFLOP/s f32) and reads about 1 KB of peaks, most of it shared by the
// query row.  The design keeps everything out of device memory but one
// float a pair:
//
// * one block takes one query row and kThreads candidate slots, one
//   thread a candidate; a tile whose slots are all invalid writes -inf
//   and leaves (a wide window row is mostly padding);
// * the block stages its candidates' peaks (m/z, intensity, annotation)
//   in shared memory, transposed to [peak][thread] so that each thread's
//   reads and the block's coalesced stores are free of bank conflicts:
//   once when Kc <= kMaxChunk, else in chunks again for each query tile;
// * query peaks are the same for the whole block (uniform loads); a
//   thread holds a tile of IT of them and their running maxima in
//   registers and walks the candidate peaks j, with each peak's shifted
//   multiplier products in registers;
// * the row max is exact in any order; the sum over i is taken in the
//   order the plain version states, i = 0, 1, ..., Kq - 1 from +0.0, one
//   product and one add at a time.
//
// Arithmetic matches the plain PyTorch version (ops/rescore.py::
// stage1_bounds_plain) bit for bit: IEEE division for prec_diff / s
// (built without fast-math), -fmad=false so that no product is fused into
// an add, the product order q_int * (mult * c_int), and the sequential sum.
// Padded peaks of the plain version (zero intensity, annotation -1) add
// +0 to the sum and 0 to a maximum, so the kernel reads the unpadded
// widths.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 64;              // candidate slots a block
constexpr int kStride = kThreads + 1;     // words a staged peak row
constexpr int kMaxChunk = 64;             // candidate peaks staged at once
constexpr size_t kSmemDefault = 48 * 1024;
constexpr float kTwoThirds = (float)(2.0 / 3.0);
constexpr float kInflation = 1.0f + 1.0f / 1048576.0f;  // 1 + 2^-20, exact

__host__ __device__ inline size_t smem_bytes(int chunk) {
  return 3 * (size_t)chunk * kStride * sizeof(float);
}

__device__ __forceinline__ float shift_mult(int ann, int s) {
  return ann == s ? 1.0f : (ann == 0 ? kTwoThirds : 0.0f);
}

// Copies peaks [j0, j0 + jn) of the block's candidate rows into shared
// memory, peak-major: consecutive threads read consecutive peaks of a row.
__device__ __forceinline__ void stage_peaks(
    const float* __restrict__ lib_mz, const float* __restrict__ lib_int,
    const int* __restrict__ lib_ann, const int* s_row, int kc, int j0,
    int jn, float* s_mz, float* s_int, int* s_ann) {
  const int total = kThreads * jn;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / jn;
    const int j = e - r * jn;
    const int row = s_row[r];
    if (row >= 0) {
      const size_t at = (size_t)row * kc + j0 + j;
      s_mz[j * kStride + r] = lib_mz[at];
      s_int[j * kStride + r] = lib_int[at];
      s_ann[j * kStride + r] = lib_ann[at];
    }
  }
}

// IT: query peaks a thread holds at once.  NS >= 0: the number of active
// shifts, unrolled with their offsets and products in registers; NS < 0
// takes any count `n_shift` (offsets recomputed a candidate peak at a
// time: the same IEEE quotients).
template <int IT, int NS>
__global__ void __launch_bounds__(kThreads) stage1_bounds_kernel(
    const float* __restrict__ q_mz, const float* __restrict__ q_int,
    const float* __restrict__ q_prec, const float* __restrict__ lib_mz,
    const float* __restrict__ lib_int, const int* __restrict__ lib_ann,
    const float* __restrict__ lib_prec, const long long* __restrict__ cand,
    float* __restrict__ out, int c, int tiles, int kq, int kc, int n_lib,
    float tol, float chg, int n_shift) {
  extern __shared__ float smem[];
  __shared__ int s_row[kThreads];
  const int chunk = kc < kMaxChunk ? kc : kMaxChunk;
  float* s_mz = smem;
  float* s_int = s_mz + chunk * kStride;
  int* s_ann = reinterpret_cast<int*>(s_int + chunk * kStride);

  const int b = blockIdx.x / tiles;
  const int slot = (blockIdx.x - b * tiles) * kThreads + threadIdx.x;
  const size_t at = (size_t)b * c + slot;
  long long id = slot < c ? cand[at] : -1;
  const bool valid = id >= 0;
  if (id >= n_lib) id = n_lib - 1;
  s_row[threadIdx.x] = valid ? (int)id : -1;
  if (!__syncthreads_or(valid)) {
    if (slot < c) out[at] = -CUDART_INF_F;
    return;
  }

  const float* qm_row = q_mz + (size_t)b * kq;
  const float* qi_row = q_int + (size_t)b * kq;
  float pd = 0.0f;
  bool shifted = false;
  if (valid) {
    pd = (q_prec[b] - lib_prec[id]) * chg;
    shifted = fabsf(pd) >= tol;
  }
  constexpr int kNS = NS > 0 ? NS : 1;
  float off[kNS];
#pragma unroll
  for (int s = 0; s < kNS; ++s) off[s] = NS > 0 ? pd / (float)(s + 1) : 0.0f;

  const bool resident = kc <= kMaxChunk;
  if (resident) {
    stage_peaks(lib_mz, lib_int, lib_ann, s_row, kc, 0, kc, s_mz, s_int,
                s_ann);
    __syncthreads();
  }
  float acc = 0.0f;
  for (int i0 = 0; i0 < kq; i0 += IT) {
    float qm[IT], vmax[IT];
#pragma unroll
    for (int ii = 0; ii < IT; ++ii) {
      qm[ii] = i0 + ii < kq ? __ldg(qm_row + i0 + ii) : 0.0f;
      vmax[ii] = 0.0f;
    }
    for (int j0 = 0; j0 < kc; j0 += chunk) {
      const int jn = kc - j0 < chunk ? kc - j0 : chunk;
      if (!resident) {
        __syncthreads();
        stage_peaks(lib_mz, lib_int, lib_ann, s_row, kc, j0, jn, s_mz,
                    s_int, s_ann);
        __syncthreads();
      }
      if (!valid) continue;
      for (int j = 0; j < jn; ++j) {
        const float cm = s_mz[j * kStride + threadIdx.x];
        const float ci = s_int[j * kStride + threadIdx.x];
        const int ca = s_ann[j * kStride + threadIdx.x];
        if (NS >= 0) {
          // A pair outside the shift condition gets products 0, which
          // leave every maximum as it is.
          float ct[kNS];
#pragma unroll
          for (int s = 0; s < NS; ++s)
            ct[s] = shifted ? shift_mult(ca, s + 1) * ci : 0.0f;
#pragma unroll
          for (int ii = 0; ii < IT; ++ii) {
            const float d = qm[ii] - cm;
            float v = vmax[ii];
            if (fabsf(d) <= tol) v = fmaxf(v, ci);
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              if (fabsf(d - off[s]) <= tol) v = fmaxf(v, ct[s]);
            }
            vmax[ii] = v;
          }
        } else {
#pragma unroll
          for (int ii = 0; ii < IT; ++ii) {
            if (fabsf(qm[ii] - cm) <= tol) vmax[ii] = fmaxf(vmax[ii], ci);
          }
          if (shifted) {
            for (int s = 1; s <= n_shift; ++s) {
              const float o = pd / (float)s;
              const float ct = shift_mult(ca, s) * ci;
#pragma unroll
              for (int ii = 0; ii < IT; ++ii) {
                if (fabsf((qm[ii] - cm) - o) <= tol)
                  vmax[ii] = fmaxf(vmax[ii], ct);
              }
            }
          }
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int ii = 0; ii < IT; ++ii) {
        if (i0 + ii < kq) acc = acc + __ldg(qi_row + i0 + ii) * vmax[ii];
      }
    }
  }
  if (slot < c) out[at] = valid ? acc * kInflation : -CUDART_INF_F;
}

template <int IT, int NS>
cudaError_t launch(int blocks, size_t smem, cudaStream_t stream,
                   const float* q_mz, const float* q_int,
                   const float* q_prec, const float* lib_mz,
                   const float* lib_int, const int* lib_ann,
                   const float* lib_prec, const long long* cand, float* out,
                   int c, int tiles, int kq, int kc, int n_lib, float tol,
                   float chg, int n_shift) {
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage1_bounds_kernel<IT, NS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  stage1_bounds_kernel<IT, NS><<<blocks, kThreads, smem, stream>>>(
      q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec, cand, out, c,
      tiles, kq, kc, n_lib, tol, chg, n_shift);
  return cudaGetLastError();
}

template <int IT>
cudaError_t launch_shifts(int n_shift, int blocks, size_t smem,
                          cudaStream_t stream, const float* q_mz,
                          const float* q_int, const float* q_prec,
                          const float* lib_mz, const float* lib_int,
                          const int* lib_ann, const float* lib_prec,
                          const long long* cand, float* out, int c,
                          int tiles, int kq, int kc, int n_lib, float tol,
                          float chg) {
#define STAGE1_LAUNCH(NS)                                                   \
  launch<IT, NS>(blocks, smem, stream, q_mz, q_int, q_prec, lib_mz,       \
                 lib_int, lib_ann, lib_prec, cand, out, c, tiles, kq, kc, \
                 n_lib, tol, chg, n_shift)
  switch (n_shift) {
    case 0: return STAGE1_LAUNCH(0);
    case 1: return STAGE1_LAUNCH(1);
    case 2: return STAGE1_LAUNCH(2);
    case 3: return STAGE1_LAUNCH(3);
    case 4: return STAGE1_LAUNCH(4);
    default: return STAGE1_LAUNCH(-1);
  }
#undef STAGE1_LAUNCH
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// All pointers are device pointers to contiguous arrays: q_mz, q_int
// (b, kq); q_prec (b,); lib_mz, lib_int, lib_ann (n_lib, kc); lib_prec
// (n_lib,); cand (b, c) int64, -1 = invalid; out (b, c).  i_tile is the
// number of query peaks a thread holds at once: 8, 10 or 16.
int stage1_bounds(const float* q_mz, const float* q_int, const float* q_prec,
                  const float* lib_mz, const float* lib_int,
                  const int* lib_ann, const float* lib_prec,
                  const long long* cand, float* out, int b, int c, int kq,
                  int kc, int n_lib, float tol, int num_shifts,
                  int allow_shift, int i_tile, void* stream) {
  if (b < 0 || c < 0 || kq < 0 || kc < 0 || n_lib < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || c == 0) return (int)cudaSuccess;
  const int tiles = (c + kThreads - 1) / kThreads;
  if ((long long)b * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = b * tiles;
  const int n_shift = allow_shift && num_shifts > 1 ? num_shifts - 1 : 0;
  const float chg = allow_shift ? (float)(num_shifts - 1) : 1.0f;
  const size_t smem = smem_bytes(kc < kMaxChunk ? kc : kMaxChunk);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (i_tile) {
    case 8:
      return (int)launch_shifts<8>(n_shift, blocks, smem, st, q_mz, q_int,
                                   q_prec, lib_mz, lib_int, lib_ann,
                                   lib_prec, cand, out, c, tiles, kq, kc,
                                   n_lib, tol, chg);
    case 10:
      return (int)launch_shifts<10>(n_shift, blocks, smem, st, q_mz, q_int,
                                    q_prec, lib_mz, lib_int, lib_ann,
                                    lib_prec, cand, out, c, tiles, kq, kc,
                                    n_lib, tol, chg);
    case 16:
      return (int)launch_shifts<16>(n_shift, blocks, smem, st, q_mz, q_int,
                                    q_prec, lib_mz, lib_int, lib_ann,
                                    lib_prec, cand, out, c, tiles, kq, kc,
                                    n_lib, tol, chg);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* stage1_bounds_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
