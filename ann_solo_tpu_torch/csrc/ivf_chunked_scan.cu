// Fused chunked IVF scan + per-chunk selection for Hopper (sm_90a).
//
// Replaces the TPU kernel ann_solo_tpu/ops/ivf_scan_pallas.py::_scan_kernel
// (launched by ivf_chunked_scan_select).  The (L, cap) list block is cut
// into n_chunks = L / c chunks of cw = c * cap slots.  For query b and
// each slot s of chunk j (global slot j * cw + s, list j * c + s / cap):
//
//   score = (sum_d bf16_rn(q[b, d]) * float(v[slot, d])) * scale[slot]
//
// is -inf unless the list is in the query's cold probe set (probed[b, l]),
// ids[slot] >= 0 and, when tol_val > 0, the slot is inside the precursor
// window (Da: |qp - prec| * charge <= tol; ppm: |qp - prec| /
// max(prec, 1e-6) * 1e6 <= tol, an IEEE quotient).  The score becomes its
// monotone 16-bit key (bf16 round-to-nearest-even order) and packs with
// the inverted slot, key16 << pos_bits | (cw - 1 - s): packed values are
// distinct, and larger means (larger key, smaller slot), the canonical
// order.  Each 256-slot supergroup keeps its top 24 packed values; the
// chunk keeps the top 96 of those.  The row written for (b, j) is
//
//   out[b, j, 0:96]   = the top 96, descending (-1 where fewer exist)
//   out[b, j, 96+g]   = supergroup g's 24th value, g < npc = cw / 256
//   out[b, j, rest]   = -1
//
// exactly the rows of the plain version (ops/ivf_scan.py::
// ivf_chunked_scan_rows_plain).  Chunk choice, merging and certificates
// run outside, in PyTorch.
//
// What bounds it on the H100: arithmetic.  At the 2.1M-spectrum point
// (B = 1,024, L = 4,096, cap = 768, D = 800 int8, c = 2) it does
// B * L * cap * D = 2.6e12 multiply-adds on the CUDA cores, against
// 2.5 GB of list rows (read once per 16-query tile, mostly from L2) and a
// 1.07 GB output.  The design keeps every score on chip:
//
// * one block per (16-query tile, chunk), eight warps; consecutive blocks
//   share a chunk, so its rows come from L2 for all but the first tile;
// * the tile's bf16-rounded queries in shared memory as float, [d][b], so
//   one broadcast float4 load gives four queries' values of one d;
// * each thread scores two slots for all 16 queries: 32 accumulators,
//   each query load serving two rows.  A product bf16(q) * int8 or bf16 *
//   bf16 is exact in float32, so fmaf equals a product and a sum; each
//   dot is summed over d = 0, 1, ... in order, which depends on D alone;
// * the tile's (16, cw) packed values stay in shared memory (96 KB at
//   cw = 1,536); a warp sorts a supergroup's 256 values (8 per lane) with
//   a bitonic network in registers and shuffles and keeps the first 24;
//   then a warp per query sorts the npc * 24 survivors (16 per lane) and
//   writes its row.
//
// Tensor cores (mma / wgmma) and TMA are later work.  Rows whose byte
// length is not a multiple of 16 take an element-wise path of the same
// order.  Limits: cw <= 4096, npc <= 16, the query tile shrinks to 8 or 4
// queries when its shared memory would pass 227 KB.
//
// Build without fast-math and with -fmad=false: the scale product, the
// window's division and its comparisons stay separately rounded IEEE
// operations, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kSG = 256;     // supergroup width
constexpr int kM = 24;       // kept per supergroup
constexpr int kCK = 96;      // kept per chunk
constexpr int kLanes = 128;  // row width
constexpr int kMaxNpc = 16;  // supergroups per chunk (cw <= 4096)
constexpr int kMaxC = 16;    // lists per chunk
constexpr int kNeg = -1;
constexpr size_t kMaxSmem = 232448;  // 227 KB
constexpr unsigned kFull = 0xffffffffu;

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

// Monotone 16-bit key of a float32 score (ivf_scan_pallas.py::_key16).
__device__ __forceinline__ int key16(float s) {
  const unsigned u = __float_as_uint(s);
  const unsigned rne = u + 0x7FFFu + ((u >> 16) & 1u);
  const unsigned b16 = rne >> 16;
  return (u >> 31) ? (int)(0xFFFFu - b16) : (int)(b16 | 0x8000u);
}

// Sorts the warp's 32 * N values descending; element e = lane * N + r is
// v[r] of lane `lane`.  A bitonic network: partners closer than N sit in
// one lane's registers, the others one shuffle away.
template <int N>
__device__ __forceinline__ void warp_sort_desc(int (&v)[N], int lane) {
  constexpr int kTotal = N * kWarp;
#pragma unroll
  for (int k = 2; k <= kTotal; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < N) {
#pragma unroll
        for (int r = 0; r < N; ++r) {
          if ((r & j) == 0) {
            const int e = lane * N + r;  // the lower element of the pair
            const bool desc = (e & k) == 0;
            const int a = v[r], b = v[r | j];
            if (desc ? a < b : a > b) {
              v[r] = b;
              v[r | j] = a;
            }
          }
        }
      } else {
        const int lj = j / N;
        const bool lower = (lane & lj) == 0;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const int other = __shfl_xor_sync(kFull, v[r], lj);
          const bool desc = ((lane * N + r) & k) == 0;
          v[r] = (lower == desc) ? max(v[r], other) : min(v[r], other);
        }
      }
    }
  }
}

template <int BT>
size_t smem_bytes(int cw, int c, int dim) {
  return (size_t)BT * cw * sizeof(int)     // packed values
         + (size_t)dim * BT * sizeof(float)  // query tile
         + BT * sizeof(float)                // query precursors
         + (size_t)BT * kMaxNpc * sizeof(int)  // supergroup 24th values
         + (size_t)BT * c;                   // probe bits of the chunk
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads) chunked_scan_kernel(
    const T* __restrict__ vectors, const int* __restrict__ ids,
    const float* __restrict__ prec, const float* __restrict__ scales,
    const float* __restrict__ queries, const float* __restrict__ q_prec,
    const uint8_t* __restrict__ probed, int* __restrict__ out, int n_list,
    int cap, int c, int dim, int batch, int n_tiles, int pos_bits,
    bool vec, float charge, float tol_val, int ppm) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kE = Chunk<T>::kE;
  const int cw = c * cap;
  const int npc = cw / kSG;
  const int n_chunks = n_list / c;
  const int tile = blockIdx.x % n_tiles;
  const int chunk = blockIdx.x / n_tiles;
  const int q0 = tile * BT;
  int* s_packed = reinterpret_cast<int*>(smem);          // [BT][cw]
  float* s_q = reinterpret_cast<float*>(s_packed + BT * cw);  // [dim][BT]
  float* s_qp = s_q + (size_t)dim * BT;                   // [BT]
  int* s_vlast = reinterpret_cast<int*>(s_qp + BT);       // [BT][kMaxNpc]
  uint8_t* s_probe =
      reinterpret_cast<uint8_t*>(s_vlast + BT * kMaxNpc);  // [BT][c]

  for (int i = threadIdx.x; i < BT * dim; i += kThreads) {
    const int b = i / dim;
    const int d = i - b * dim;
    const int qb = q0 + b;
    s_q[d * BT + b] =
        qb < batch
            ? __bfloat162float(__float2bfloat16_rn(queries[(size_t)qb * dim + d]))
            : 0.0f;
  }
  for (int i = threadIdx.x; i < BT * c; i += kThreads) {
    const int b = i / c;
    const int qb = q0 + b;
    s_probe[i] =
        qb < batch ? probed[(size_t)qb * n_list + chunk * c + (i - b * c)] : 0;
  }
  if (threadIdx.x < BT) {
    const int qb = q0 + threadIdx.x;
    s_qp[threadIdx.x] = qb < batch ? q_prec[qb] : 0.0f;
  }
  __syncthreads();

  // Scores: thread t takes slots s and s + kThreads of each pass.
  const size_t slot0 = (size_t)chunk * cw;
  for (int s = threadIdx.x; s < cw; s += 2 * kThreads) {
    const int slots[2] = {s, s + kThreads};
    const bool has_b = slots[1] < cw;
    const T* row_a = vectors + (slot0 + slots[0]) * (size_t)dim;
    const T* row_b = vectors + (slot0 + (has_b ? slots[1] : slots[0])) * (size_t)dim;
    float acc[2][BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[0][b] = acc[1][b] = 0.0f;
    if (vec) {
      const int n_vec = dim / kE;
      for (int ch = 0; ch < n_vec; ++ch) {
        float va[kE], vb[kE];
        Chunk<T>::load(row_a + ch * kE, va);
        Chunk<T>::load(row_b + ch * kE, vb);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float4* q4 =
              reinterpret_cast<const float4*>(s_q + (ch * kE + e) * BT);
#pragma unroll
          for (int g = 0; g < BT / 4; ++g) {
            const float4 q = q4[g];
            acc[0][4 * g] = fmaf(q.x, va[e], acc[0][4 * g]);
            acc[0][4 * g + 1] = fmaf(q.y, va[e], acc[0][4 * g + 1]);
            acc[0][4 * g + 2] = fmaf(q.z, va[e], acc[0][4 * g + 2]);
            acc[0][4 * g + 3] = fmaf(q.w, va[e], acc[0][4 * g + 3]);
            acc[1][4 * g] = fmaf(q.x, vb[e], acc[1][4 * g]);
            acc[1][4 * g + 1] = fmaf(q.y, vb[e], acc[1][4 * g + 1]);
            acc[1][4 * g + 2] = fmaf(q.z, vb[e], acc[1][4 * g + 2]);
            acc[1][4 * g + 3] = fmaf(q.w, vb[e], acc[1][4 * g + 3]);
          }
        }
      }
    } else {
      for (int d = 0; d < dim; ++d) {
        const float va = to_float(row_a[d]);
        const float vb = to_float(row_b[d]);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float q = s_q[d * BT + b];
          acc[0][b] = fmaf(q, va, acc[0][b]);
          acc[1][b] = fmaf(q, vb, acc[1][b]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = slots[h];
      if (slot >= cw) continue;
      const size_t gs = slot0 + slot;
      const bool valid = ids[gs] >= 0;
      const float sc = scales[gs];
      const float pr = prec[gs];
      const int ci = slot / cap;
      const int inv = cw - 1 - slot;
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        bool ok = valid && s_probe[b * c + ci] != 0;
        if (tol_val > 0.0f) {
          const float dm = fabsf(s_qp[b] - pr);
          ok = ok && (ppm ? dm / fmaxf(pr, 1e-6f) * 1e6f <= tol_val
                          : dm * charge <= tol_val);
        }
        const float score = ok ? acc[h][b] * sc : -CUDART_INF_F;
        s_packed[b * cw + slot] = (key16(score) << pos_bits) | inv;
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  // Level 1: the top 24 of each (query, supergroup), written in place.
  for (int item = warp; item < BT * npc; item += kWarps) {
    const int b = item / npc;
    const int g = item - b * npc;
    int* base = s_packed + b * cw + g * kSG;
    int v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = base[lane * 8 + r];
    warp_sort_desc<8>(v, lane);
    __syncwarp();
    if (lane < kM / 8) {
#pragma unroll
      for (int r = 0; r < 8; ++r) base[lane * 8 + r] = v[r];
    }
    if (lane == kM / 8 - 1) s_vlast[b * kMaxNpc + g] = v[7];
  }
  __syncthreads();

  // Level 2: the chunk's top 96 of the npc * 24 survivors, and the row.
  const int n_surv = npc * kM;
  for (int b = warp; b < BT; b += kWarps) {
    const int qb = q0 + b;
    if (qb >= batch) continue;
    int v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int e = lane * 16 + r;
      const int g = e / kM;
      v[r] = e < n_surv ? s_packed[b * cw + g * kSG + (e - g * kM)] : kNeg;
    }
    warp_sort_desc<16>(v, lane);
    int* row = out + ((size_t)qb * n_chunks + chunk) * kLanes;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int e = lane * 16 + r;
      if (e < kCK) row[e] = v[r];
    }
    row[kCK + lane] = lane < npc ? s_vlast[b * kMaxNpc + lane] : kNeg;
  }
}

// Queries per block: the largest tile whose shared memory fits.
int query_tile(int cw, int c, int dim) {
  if (smem_bytes<16>(cw, c, dim) <= kMaxSmem) return 16;
  if (smem_bytes<8>(cw, c, dim) <= kMaxSmem) return 8;
  if (smem_bytes<4>(cw, c, dim) <= kMaxSmem) return 4;
  return 0;
}

template <typename T, int BT>
cudaError_t launch(const void* vectors, const int* ids, const float* prec,
                   const float* scales, const float* queries,
                   const float* q_prec, const uint8_t* probed, int* out,
                   int n_list, int cap, int c, int dim, int batch,
                   int pos_bits, float charge, float tol_val, int ppm,
                   cudaStream_t stream) {
  const int cw = c * cap;
  const size_t smem = smem_bytes<BT>(cw, c, dim);
  auto kernel = chunked_scan_kernel<T, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (batch + BT - 1) / BT;
  const long long blocks = (long long)n_tiles * (n_list / c);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = (dim * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(vectors), ids, prec, scales, queries, q_prec,
      probed, out, n_list, cap, c, dim, batch, n_tiles, pos_bits, vec,
      charge, tol_val, ppm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int bt, const void* vectors, const int* ids,
                        const float* prec, const float* scales,
                        const float* queries, const float* q_prec,
                        const uint8_t* probed, int* out, int n_list, int cap,
                        int c, int dim, int batch, int pos_bits, float charge,
                        float tol_val, int ppm, cudaStream_t stream) {
  switch (bt) {
    case 16:
      return launch<T, 16>(vectors, ids, prec, scales, queries, q_prec,
                           probed, out, n_list, cap, c, dim, batch, pos_bits,
                           charge, tol_val, ppm, stream);
    case 8:
      return launch<T, 8>(vectors, ids, prec, scales, queries, q_prec, probed,
                          out, n_list, cap, c, dim, batch, pos_bits, charge,
                          tol_val, ppm, stream);
    default:
      return launch<T, 4>(vectors, ids, prec, scales, queries, q_prec, probed,
                          out, n_list, cap, c, dim, batch, pos_bits, charge,
                          tol_val, ppm, stream);
  }
}

}  // namespace

extern "C" {

// Queries per block for this chunk width and dimension; 0 = does not fit.
int ivf_chunked_scan_query_tile(int cw, int c, int dim) {
  return query_tile(cw, c, dim);
}

// Launches the scan on `stream`; returns cudaGetLastError() (0 = ok).
// storage: 0 = int8, 1 = bf16.  Device pointers to contiguous arrays:
// vectors (n_list * cap, dim); ids int32, prec, scales (n_list * cap);
// queries float32 (batch, dim); q_prec (batch,); probed uint8
// (batch, n_list); out int32 (batch, n_list / c, 128).
int ivf_chunked_scan(const void* vectors, int storage, const int* ids,
                     const float* prec, const float* scales,
                     const float* queries, const float* q_prec,
                     const uint8_t* probed, int* out, int n_list, int cap,
                     int c, int dim, int batch, int pos_bits, float charge,
                     float tol_val, int ppm, void* stream) {
  const int cw = c * cap;
  if (n_list < 1 || cap < 1 || dim < 1 || batch < 0 || c < 1 || c > kMaxC ||
      n_list % c != 0 || cw % kSG != 0 || cw / kSG > kMaxNpc ||
      kCK + cw / kSG > kLanes || (1 << pos_bits) < cw || pos_bits + 16 > 31 ||
      (storage != 0 && storage != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bt = query_tile(cw, c, dim);
  if (bt == 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      storage == 0
          ? launch_tile<int8_t>(bt, vectors, ids, prec, scales, queries,
                                q_prec, probed, out, n_list, cap, c, dim,
                                batch, pos_bits, charge, tol_val, ppm, s)
          : launch_tile<__nv_bfloat16>(bt, vectors, ids, prec, scales,
                                       queries, q_prec, probed, out, n_list,
                                       cap, c, dim, batch, pos_bits, charge,
                                       tol_val, ppm, s);
  return (int)err;
}

const char* ivf_chunked_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
