// Probe-gather IVF scan for Hopper (sm_90a).
//
// Replaces the TPU kernel ann_solo_tpu/ops/ivf_probe_pallas.py::
// _probe_scan_kernel (launched by ivf_probe_scan).  For each query b and
// probe rank p, with list l = probe_ids[b, p] and each slot s < cap:
//
//   score = (sum_d bf16_rn(q[b, d]) * float(v[l, s, d])) * scale[l, s]
//
// written to out[b, p * cap + s]; the slot is -inf unless ids[l, s] >= 0
// and, when tol_val > 0, it lies inside the precursor window:
//   Da:  |q_prec[b] - prec[l, s]| * charge <= tol_val
//   ppm: |q_prec[b] - prec[l, s]| / max(prec[l, s], 1e-6) * 1e6 <= tol_val
// (an IEEE quotient).  No selection happens here: the canonical top-k
// runs on the (B, P * cap) block afterwards.  Storage is int8 (SQ8) or
// bf16; every int8 and bf16 value is exact in bf16, so each product
// bf16(q) * v is exact in f32 and only the summation order can differ
// from the plain PyTorch version.
//
// What bounds it on the H100: device-memory bytes.  It reads
// B * P * cap * D storage bytes (at the 2.1M-spectrum point, B = 1,024,
// P = 64, cap = 768, D = 800 int8: 40 GB, about 12 ms at 3.35 TB/s with
// no L2 reuse) and writes the (B, P * cap) f32 block (201 MB); the
// arithmetic is two operations per byte.  The design streams each slot's
// row once with 16-byte loads and keeps everything else on chip:
//
// * one block per (query, probe rank), eight warps;
// * the query's bf16-rounded row in shared memory as float, laid out so
//   that the 32 lanes of a warp read consecutive 16-byte words (no bank
//   conflicts);
// * a warp scores kRows slots at a time (more loads in flight, and each
//   query word read from shared memory serves kRows rows); each lane
//   owns a fixed set of 16-byte chunks of the row, sums them in order,
//   and a 5-step xor-shuffle tree adds the lanes.  The order depends on
//   D alone, so results are deterministic, and every lane ends with the
//   same bits.
//
// Rows whose byte length is not a multiple of 16 (or a misaligned base)
// take an element-wise path with the same structure.  Each probed list is
// read once per query that probes it; the list-major tensor-core design
// (read each list once per query tile, as FAISS GPU IVF does) is later
// work.  Limits: dim <= kMaxDim (the query row in 48 KB of shared
// memory), B * P < 2^31 blocks.
//
// Build without fast-math and with -fmad=false: products and sums stay
// separately rounded and the ppm window's division is an IEEE quotient,
// as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kRows = 4;
constexpr int kMaxDim = 12288;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The kE elements of one 16-byte chunk, widened to float.
template <typename T>
struct Chunk {
  static constexpr int kE = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kE; ++i) out[i] = to_float(e[i]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * kWarp) probe_scan_kernel(
    const T* __restrict__ vectors, const int* __restrict__ ids,
    const float* __restrict__ prec, const float* __restrict__ scales,
    const float* __restrict__ queries, const float* __restrict__ q_prec,
    const int* __restrict__ probe_ids, float* __restrict__ out, int n_list,
    int cap, int dim, int n_probe, float charge, float tol_val, int ppm) {
  extern __shared__ float s_q[];
  constexpr int kE = Chunk<T>::kE;
  const int bp = blockIdx.x;  // b * n_probe + p
  const int b = bp / n_probe;
  const int list = probe_ids[bp];
  float* out_row = out + (size_t)bp * cap;
  if (list < 0 || list >= n_list) {  // not a list: nothing is valid
    for (int s = threadIdx.x; s < cap; s += blockDim.x) {
      out_row[s] = -CUDART_INF_F;
    }
    return;
  }

  // The query row, rounded to bf16.  Vector path: element d of chunk c
  // (d = c * kE + 4 * g + w) goes to float4 word g * n_chunks + c, so lane
  // i reading chunk c = i + 32 j touches consecutive 16-byte words.
  const int n_chunks = dim / kE;
  const float* q_row = queries + (size_t)b * dim;
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    const float v = __bfloat162float(__float2bfloat16_rn(q_row[d]));
    if (kVec) {
      const int c = d / kE;
      const int r = d - c * kE;
      s_q[((r >> 2) * n_chunks + c) * 4 + (r & 3)] = v;
    } else {
      s_q[d] = v;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const size_t base = (size_t)list * cap;
  const float qp = q_prec[b];
  for (int s0 = warp * kRows; s0 < cap; s0 += kWarps * kRows) {
    const T* rows[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // Rows past the list's end re-read the last slot; never written.
      const int s = min(s0 + r, cap - 1);
      rows[r] = vectors + (base + s) * (size_t)dim;
    }
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    if (kVec) {
      const float4* q4 = reinterpret_cast<const float4*>(s_q);
      for (int c = lane; c < n_chunks; c += kWarp) {
        float v[kRows][kE];
#pragma unroll
        for (int r = 0; r < kRows; ++r) Chunk<T>::load(rows[r] + c * kE, v[r]);
#pragma unroll
        for (int g = 0; g < kE / 4; ++g) {
          const float4 q = q4[g * n_chunks + c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r] += q.x * v[r][4 * g];
            acc[r] += q.y * v[r][4 * g + 1];
            acc[r] += q.z * v[r][4 * g + 2];
            acc[r] += q.w * v[r][4 * g + 3];
          }
        }
      }
    } else {
      for (int d = lane; d < dim; d += kWarp) {
        const float q = s_q[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += q * to_float(rows[r][d]);
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float total = warp_sum(acc[r]);
      if (lane == r) mine = total;
    }
    const int s = s0 + lane;
    if (lane < kRows && s < cap) {
      bool ok = ids[base + s] >= 0;
      if (tol_val > 0.0f) {
        const float pr = prec[base + s];
        const float dm = fabsf(qp - pr);
        ok = ok && (ppm ? dm / fmaxf(pr, 1e-6f) * 1e6f <= tol_val
                        : dm * charge <= tol_val);
      }
      out_row[s] = ok ? mine * scales[base + s] : -CUDART_INF_F;
    }
  }
}

template <typename T>
cudaError_t launch(const void* vectors, const int* ids, const float* prec,
                   const float* scales, const float* queries,
                   const float* q_prec, const int* probe_ids, float* out,
                   int n_list, int cap, int dim, int batch, int n_probe,
                   float charge, float tol_val, int ppm, cudaStream_t stream) {
  const T* v = static_cast<const T*>(vectors);
  const bool vec = (dim * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  const dim3 grid((unsigned)((long long)batch * n_probe));
  const dim3 block(kWarps * kWarp);
  const size_t smem = (size_t)dim * sizeof(float);
  if (vec) {
    probe_scan_kernel<T, true><<<grid, block, smem, stream>>>(
        v, ids, prec, scales, queries, q_prec, probe_ids, out, n_list, cap,
        dim, n_probe, charge, tol_val, ppm);
  } else {
    probe_scan_kernel<T, false><<<grid, block, smem, stream>>>(
        v, ids, prec, scales, queries, q_prec, probe_ids, out, n_list, cap,
        dim, n_probe, charge, tol_val, ppm);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ivf_probe_scan_max_dim() { return kMaxDim; }

// Launches the scan on `stream`; returns cudaGetLastError() (0 = ok).
// storage: 0 = int8, 1 = bf16.  Device pointers to contiguous arrays:
// vectors (n_list, cap, dim); ids int32, prec, scales (n_list, cap);
// queries float32 (batch, dim); q_prec (batch,); probe_ids int32
// (batch, n_probe); out float32 (batch, n_probe * cap).
int ivf_probe_scan(const void* vectors, int storage, const int* ids,
                   const float* prec, const float* scales,
                   const float* queries, const float* q_prec,
                   const int* probe_ids, float* out, int n_list, int cap,
                   int dim, int batch, int n_probe, float charge,
                   float tol_val, int ppm, void* stream) {
  if (n_list < 1 || cap < 1 || dim < 1 || dim > kMaxDim || batch < 0 ||
      n_probe < 1 || (long long)batch * n_probe > 0x7fffffffLL ||
      (storage != 0 && storage != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      storage == 0
          ? launch<int8_t>(vectors, ids, prec, scales, queries, q_prec,
                           probe_ids, out, n_list, cap, dim, batch, n_probe,
                           charge, tol_val, ppm, s)
          : launch<__nv_bfloat16>(vectors, ids, prec, scales, queries, q_prec,
                                  probe_ids, out, n_list, cap, dim, batch,
                                  n_probe, charge, tol_val, ppm, s);
  return (int)err;
}

const char* ivf_probe_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
