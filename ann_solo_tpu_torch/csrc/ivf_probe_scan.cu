// Probe-gather IVF scan for Hopper (sm_90a), list-major on the tensor cores.
//
// Replaces the TPU kernel ann_solo_tpu/ops/ivf_probe_pallas.py::
// _probe_scan_kernel (launched by ivf_probe_scan).  For each query b and
// probe rank p, with list l = probe_ids[b, p] and each slot s < cap:
//
//   score = (sum_d bf16_rn(q[b, d]) * bf16(v[l, s, d])) * scale[l, s]
//
// written to out[b, p * cap + s]; the slot is -inf unless ids[l, s] >= 0
// and, when tol_val > 0, it lies inside the precursor window:
//   Da:  |q_prec[b] - prec[l, s]| * charge <= tol_val
//   ppm: |q_prec[b] - prec[l, s]| / max(prec[l, s], 1e-6) * 1e6 <= tol_val
// (an IEEE quotient).  Every slot of a probe id outside [0, L) is -inf.
// No selection happens here: the canonical top-k runs on the (B, P * cap)
// block afterwards.  Storage is int8 (SQ8) or bf16; every int8 and bf16
// value is exact in bf16, so each product bf16(q) * v is exact in f32 and
// only the summation order can differ from the plain PyTorch version.
//
// What bounds it on the H100: device-memory bytes.  Read once, the inputs
// are the probed lists' rows and slot metadata (at the 2.1M-spectrum
// point, B = 1,024, P = 64, L = 4,096, cap = 768, D = 800 int8: about
// 2.5 GB, nearly every list probed), the queries and the probe table, and
// the output is the (B, P * cap) f32 block (201 MB): about 0.82 ms at
// 3.35 TB/s.  The arithmetic, B * P * cap * D = 4e10 multiply-adds, is
// 0.08 ms of bf16 tensor-core time.  A per-(query, probe) scan reads each
// list once per query that probes it (16 times on average there, 40 GB).
// The design reads it once per 32 of them:
//
// * the wrapper inverts the (B, P) probe table into each list's entries
//   e = b * P + p, ascending (ops/ivf_probe.py::list_probe_entries: one
//   stable sort on the device); entries of ids outside [0, L) form a last
//   pseudo-list L, whose items write -inf;
// * a work item is up to 32 entries of one list times a tile of 256
//   slots; ends[j] is the inclusive prefix sum of list j's item counts,
//   made on the device, and one wave of resident blocks strides over the
//   items, consecutive items sharing a list, so a list probed by every
//   query is 32 passes of 32 and stays balanced;
// * scores on the tensor cores: mma.sync m16n8k16 bf16 -> f32.  Entries'
//   queries are the M side (prep_queries_kernel rounds them to bf16 once,
//   zero-padded to a multiple of 64 in D), slots the N side; int8 storage
//   is widened to bf16 exactly by byte permutes (scan_mma.cuh);
// * D streams in k-tiles of 32 through a 4-stage cp.async ring in shared
//   memory, zero-filled past D and past the list's last slot through the
//   copy's source size (rows whose byte length is not a multiple of 16
//   take synchronous element loads into the same ring), so a ragged D or
//   cap adds exact zeros, masked in the epilogue;
// * the epilogue applies the scale and the masks in plain IEEE f32,
//   stages the tile's scores in shared memory (over the ring) and writes
//   each entry's 256 slots to out[b, p * cap + s0 ...] as one contiguous,
//   coalesced row segment, in (probe rank, slot) lane order.
//
// Build without fast-math and with -fmad=false: the scale product, the
// window's division and its comparisons stay separately rounded IEEE
// operations, as in the plain version.  Limits: B * P < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_mma.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMT = 32;      // entries (queries) per item: two m16 tiles
constexpr int kST = 256;     // slots per item: 32 a warp, four n8 tiles
constexpr int kKT = 32;      // D per ring stage (two k16 steps)
constexpr int kStages = 4;   // cp.async ring depth
constexpr int kDPad = 64;    // D of the bf16 query scratch rounds up to this
constexpr int kQRow = kKT * 2 + 16;  // bytes per query row in a stage
constexpr int kOutRow = kST + 8;     // floats per staged output row

// One ring stage holds kKT of D for the item's 256 slot rows and its 32
// queries, each row padded by 16 bytes so that the eight rows a fragment
// load touches fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return kKT * (int)sizeof(T) + 16;
}
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kST * row_bytes<T>() + kMT * kQRow;
}
// The ring, reused after the k loop for the (32, 256) staged scores.
template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * stage_bytes<T>() > kMT * kOutRow * 4
             ? kStages * stage_bytes<T>()
             : kMT * kOutRow * 4;
}
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)ring_bytes<T>() + 3 * kMT * sizeof(int);  // entry, b, prec
}

// Starts the copy of k-tile t (D from t * kKT) into stage t % kStages:
// the item's n_rows slot rows from `rows` and its queries (s_qid, -1 =
// none) from q_bf16.  Past D, past n_rows and for absent queries the
// stage is zero-filled.
template <typename T>
__device__ __forceinline__ void issue_tile(
    unsigned char* ring, int t, const T* __restrict__ rows, int n_rows,
    const __nv_bfloat16* __restrict__ q_bf16, const int* s_qid, int dim,
    int dim_pad, bool vec) {
  constexpr int kElem = (int)sizeof(T);
  constexpr int kRow = row_bytes<T>();
  unsigned char* st = ring + (size_t)(t % kStages) * stage_bytes<T>();
  const int k0 = t * kKT;
  if (vec) {
    constexpr int kPieces = kKT * kElem / 16;  // 16-byte pieces a row
    constexpr int kPer = 16 / kElem;           // elements a piece
    for (int i = threadIdx.x; i < kST * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int pc = i - r * kPieces;
      const int k = k0 + pc * kPer;
      const bool ok = r < n_rows && k < dim;
      const T* src = rows + (ok ? (size_t)r * dim + k : 0);
      cp_async16(st + r * kRow + pc * 16, src, ok ? 16 : 0);
    }
  } else {
    using Raw = typename Bits<T>::type;
    const Raw* src = reinterpret_cast<const Raw*>(rows);
    Raw* dst = reinterpret_cast<Raw*>(st);
    for (int i = threadIdx.x; i < kST * kKT; i += kThreads) {
      const int r = i / kKT;
      const int kk = i - r * kKT;
      const int k = k0 + kk;
      dst[r * (kRow / kElem) + kk] =
          r < n_rows && k < dim ? src[(size_t)r * dim + k] : (Raw)0;
    }
  }
  constexpr int kQPieces = kKT * 2 / 16;
  unsigned char* sq = st + kST * kRow;
  for (int i = threadIdx.x; i < kMT * kQPieces; i += kThreads) {
    const int r = i / kQPieces;
    const int pc = i - r * kQPieces;
    const int qb = s_qid[r];
    const __nv_bfloat16* src =
        q_bf16 + (qb >= 0 ? (size_t)qb * dim_pad + k0 + pc * 8 : 0);
    cp_async16(sq + r * kQRow + pc * 16, src, qb >= 0 ? 16 : 0);
  }
}

// Items ends[j - 1] .. ends[j] - 1 are list j's (j = n_list: the entries
// of probe ids outside [0, L)): pass i / nst over its entries
// starts[j] + 32 * pass ..., slot tile i % nst.
template <typename T>
__global__ void __launch_bounds__(kThreads) probe_scan_kernel(
    const T* __restrict__ vectors, const int* __restrict__ ids,
    const float* __restrict__ prec, const float* __restrict__ scales,
    const __nv_bfloat16* __restrict__ q_bf16,
    const float* __restrict__ q_prec, const int* __restrict__ entries,
    const int* __restrict__ starts, const int* __restrict__ ends,
    float* __restrict__ out, int n_list, int cap, int dim, int dim_pad,
    int n_probe, bool vec, float charge, float tol_val, int ppm) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRow = row_bytes<T>();
  const int nst = (cap + kST - 1) / kST;
  const int nkt = (dim + kKT - 1) / kKT;
  const int n_items = ends[n_list];

  unsigned char* ring = smem;
  float* s_out = reinterpret_cast<float*>(smem);  // [kMT][kOutRow]
  int* s_entry = reinterpret_cast<int*>(smem + ring_bytes<T>());  // [kMT]
  int* s_qid = s_entry + kMT;                                     // [kMT]
  float* s_qp = reinterpret_cast<float*>(s_qid + kMT);            // [kMT]

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int fg = lane >> 2;  // fragment row / column group
  const int ft = lane & 3;   // fragment k pair

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int lo = 0, hi = n_list;  // the list: first j with ends[j] > item
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (ends[mid] > item) hi = mid; else lo = mid + 1;
    }
    const int list = lo;
    const int local = item - (list > 0 ? ends[list - 1] : 0);
    const int pass = local / nst;
    const int s0 = (local - pass * nst) * kST;
    const int n_rows = min(kST, cap - s0);
    const int e0 = starts[list] + pass * kMT;
    const int nq = min(kMT, starts[list + 1] - e0);
    if (threadIdx.x < kMT) {
      const int i = threadIdx.x;
      const int e = i < nq ? entries[e0 + i] : -1;
      const int qb = e >= 0 ? e / n_probe : -1;
      s_entry[i] = e;
      s_qid[i] = qb;
      s_qp[i] = qb >= 0 ? q_prec[qb] : 0.0f;
    }
    __syncthreads();

    if (list == n_list) {  // not a list: nothing is valid
      for (int i = threadIdx.x; i < nq * n_rows; i += kThreads) {
        const int r = i / n_rows;
        out[(size_t)s_entry[r] * cap + s0 + (i - r * n_rows)] =
            -CUDART_INF_F;
      }
      __syncthreads();  // the next item rewrites the entry slots
      continue;
    }

    const T* rows = vectors + ((size_t)list * cap + s0) * dim;
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < nkt)
        issue_tile<T>(ring, t, rows, n_rows, q_bf16, s_qid, dim, dim_pad,
                      vec);
      cp_async_commit();
    }
    const int n_mt = nq > 16 ? 2 : 1;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    for (int t = 0; t < nkt; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (t + kStages - 1 < nkt)
        issue_tile<T>(ring, t + kStages - 1, rows, n_rows, q_bf16, s_qid,
                      dim, dim_pad, vec);
      cp_async_commit();

      const unsigned char* st = ring + (size_t)(t % kStages) * stage_bytes<T>();
      const __nv_bfloat16* sq =
          reinterpret_cast<const __nv_bfloat16*>(st + kST * kRow);
#pragma unroll
      for (int ks = 0; ks < kKT / 16; ++ks) {
        uint32_t b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const T* row = reinterpret_cast<const T*>(
              st + (warp * 32 + nt * 8 + fg) * kRow);
          b[nt][0] = bf16x2_of(row + ks * 16 + 2 * ft);
          b[nt][1] = bf16x2_of(row + ks * 16 + 2 * ft + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt < n_mt) {
            const __nv_bfloat16* q0 =
                sq + (mt * 16 + fg) * (kQRow / 2) + ks * 16 + 2 * ft;
            const __nv_bfloat16* q1 = q0 + 8 * (kQRow / 2);
            const uint32_t a[4] = {bf16x2_of(q0), bf16x2_of(q1),
                                   bf16x2_of(q0 + 8), bf16x2_of(q1 + 8)};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: stage the scores over it

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = warp * 32 + nt * 8 + 2 * ft + e;
        if (col >= n_rows) continue;
        const size_t gs = (size_t)list * cap + s0 + col;
        const bool valid = ids[gs] >= 0;
        const float sc = scales[gs];
        const float pr = prec[gs];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mt * 16 + fg + 8 * h;
            if (r >= nq) continue;
            bool ok = valid;
            if (tol_val > 0.0f) {
              const float dm = fabsf(s_qp[r] - pr);
              ok = ok && (ppm ? dm / fmaxf(pr, 1e-6f) * 1e6f <= tol_val
                              : dm * charge <= tol_val);
            }
            s_out[r * kOutRow + col] =
                ok ? acc[mt][nt][2 * h + e] * sc : -CUDART_INF_F;
          }
        }
      }
    }
    __syncthreads();
    // A warp an entry: its n_rows scores as one row segment.
    for (int r = warp; r < nq; r += kWarps) {
      float* dst = out + (size_t)s_entry[r] * cap + s0;
      for (int c = lane; c < n_rows; c += kWarp) dst[c] = s_out[r * kOutRow + c];
    }
    __syncthreads();  // the next item refills the ring and the entry slots
  }
}

// Allows the scan kernel its shared memory and sets *per_sm to how many
// of its blocks an SM of the current device holds.
template <typename T>
cudaError_t resident_blocks(int* per_sm) {
  auto kernel = probe_scan_kernel<T>;
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

template <typename T>
cudaError_t launch(const void* vectors, const int* ids, const float* prec,
                   const float* scales, const float* queries,
                   const float* q_prec, const int* entries, const int* starts,
                   const int* ends, void* q_bf16, float* out, int n_list,
                   int cap, int dim, int batch, int n_probe, float charge,
                   float tol_val, int ppm, cudaStream_t stream) {
  const int dim_pad = (dim + kDPad - 1) / kDPad * kDPad;
  auto* qb = static_cast<__nv_bfloat16*>(q_bf16);
  prep_queries_kernel<<<1024, 256, 0, stream>>>(queries, qb, batch, dim,
                                                dim_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // One wave of resident blocks strides over the items, whose count the
  // device knows: at most ceil(B * P / 32) + L + 1 passes of nst tiles.
  int device = 0, n_sm = 0, per_sm = 0;
  err = resident_blocks<T>(&per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const long long nst = (cap + kST - 1) / kST;
  const long long max_items =
      ((long long)batch * n_probe / kMT + n_list + 2) * nst;
  const long long wave = (long long)n_sm * per_sm;
  const int grid = (int)(max_items < wave ? max_items : wave);
  if (grid < 1) return cudaErrorInvalidValue;
  const bool vec = (dim * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  probe_scan_kernel<T><<<grid, kThreads, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(vectors), ids, prec, scales, qb, q_prec, entries,
      starts, ends, out, n_list, cap, dim, dim_pad, n_probe, vec, charge,
      tol_val, ppm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Entries a work item (pass) takes and slots a work item covers: the
// caller's `ends` counts ceil(count / entries) * ceil(cap / slots) items
// a list.
int ivf_probe_scan_entries_per_pass() { return kMT; }
int ivf_probe_scan_slots_per_item() { return kST; }

// The row length of the bf16 query scratch the caller allocates: D
// rounded up to a multiple of 64.
int ivf_probe_scan_padded_dim(int dim) {
  return (dim + kDPad - 1) / kDPad * kDPad;
}

// Dynamic shared memory of a scan block (bytes) and how many such blocks
// an SM of the current device holds; storage as below.
long long ivf_probe_scan_smem_bytes(int storage) {
  return (long long)(storage == 0 ? smem_bytes<int8_t>()
                                  : smem_bytes<__nv_bfloat16>());
}
int ivf_probe_scan_resident_blocks(int storage) {
  int per_sm = 0;
  const cudaError_t err = storage == 0
                              ? resident_blocks<int8_t>(&per_sm)
                              : resident_blocks<__nv_bfloat16>(&per_sm);
  return err == cudaSuccess ? per_sm : -1;
}

// Launches the scan on `stream`; returns cudaGetLastError() (0 = ok).
// storage: 0 = int8, 1 = bf16.  Device pointers to contiguous arrays:
// vectors (n_list, cap, dim); ids int32, prec, scales (n_list, cap);
// queries float32 (batch, dim); q_prec (batch,); entries int32
// (batch * n_probe,): the entries b * n_probe + p grouped by list, list
// n_list last for ids outside [0, n_list), ascending within a list;
// starts int32 (n_list + 2,): list j's entries are
// entries[starts[j] .. starts[j + 1] - 1]; ends int32 (n_list + 1,), the
// inclusive prefix sum of each list's item count; q_bf16 scratch
// (batch, padded dim) bf16; out float32 (batch, n_probe * cap).
int ivf_probe_scan(const void* vectors, int storage, const int* ids,
                   const float* prec, const float* scales,
                   const float* queries, const float* q_prec,
                   const int* entries, const int* starts, const int* ends,
                   void* q_bf16, float* out, int n_list, int cap, int dim,
                   int batch, int n_probe, float charge, float tol_val,
                   int ppm, void* stream) {
  if (n_list < 1 || cap < 1 || dim < 1 || batch < 0 || n_probe < 1 ||
      (long long)batch * n_probe > 0x7fffffffLL ||
      (storage != 0 && storage != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      storage == 0
          ? launch<int8_t>(vectors, ids, prec, scales, queries, q_prec,
                           entries, starts, ends, q_bf16, out, n_list, cap,
                           dim, batch, n_probe, charge, tol_val, ppm, s)
          : launch<__nv_bfloat16>(vectors, ids, prec, scales, queries, q_prec,
                                  entries, starts, ends, q_bf16, out, n_list,
                                  cap, dim, batch, n_probe, charge, tol_val,
                                  ppm, s);
  return (int)err;
}

const char* ivf_probe_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
