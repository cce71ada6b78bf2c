// Fused chunked IVF scan + per-chunk selection for Hopper (sm_90a).
//
// Replaces the TPU kernel ann_solo_tpu/ops/ivf_scan_pallas.py::_scan_kernel
// (launched by ivf_chunked_scan_select).  The (L, cap) list block is cut
// into n_chunks = L / c chunks of cw = c * cap slots.  For query b and
// each slot s of chunk j (global slot j * cw + s, list j * c + s / cap):
//
//   score = (sum_d bf16_rn(q[b, d]) * bf16(v[slot, d])) * scale[slot]
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
// What bounds it on the H100: memory.  At the 2.1M-spectrum point
// (B = 1,024, L = 4,096, cap = 768, D = 800 int8, c = 2, 56 cold probes a
// query) the function must read the 2.52 GB of list rows once and write
// the 1.07 GB of rows: about 1.08 ms at 3.35 TB/s.  Its arithmetic is
// small, because a query's scores can be finite only in the ~56 chunks it
// probes: about 57k (query, chunk) pairs, B * 56 * cap * D = 3.5e10
// multiply-adds, 0.07 ms of bf16 tensor-core time.  The design:
//
// * a row no query probes is a constant of the layout (every score -inf,
//   key 127; ops/ivf_scan.py::unprobed_row): fill_unprobed_kernel writes
//   it to every (query, chunk) first, on the same stream, 16 bytes a
//   thread;
// * the wrapper hands each chunk its ascending list of probing queries;
//   a work item is a pass over one chunk for up to 32 of them (a chunk
//   probed by 1,024 queries is 32 items), and one wave of resident
//   blocks strides over the items, consecutive items sharing a chunk, so
//   rows are read once a pass and no score is computed for an unprobed
//   pair;
// * scores on the tensor cores: mma.sync m16n8k16 bf16 -> f32.  Queries
//   are the M side (prep_queries_kernel rounds them to bf16 once, zero-
//   padded to a multiple of 64 in D), slots the N side; int8 storage is
//   widened to bf16 in registers, which is exact (|v| <= 127), and every
//   bf16 x bf16 product is exact in f32;
// * a pass streams supergroup by supergroup (256 slots) and D in k-tiles
//   of 32 through a 4-stage cp.async ring in shared memory (zero-filled
//   past D, so a ragged D adds zeros; rows whose byte length is not a
//   multiple of 16 take synchronous element loads into the same ring);
// * when a supergroup's scores are complete, the epilogue applies the
//   scale, the masks and the packing in plain IEEE f32; a warp per query
//   finds the 24th of its 256 packed values by a bitwise search (one warp
//   reduction a bit) and keeps the 24 at or above it, so only survivors
//   stay in shared memory; after the last supergroup a warp per query
//   sorts its npc * 24 survivors (bitonic, registers and shuffles) and
//   writes its row.
//
// Build without fast-math and with -fmad=false: the scale product, the
// window's division and its comparisons stay separately rounded IEEE
// operations, as in the plain version.  Limits: cw <= 4096 (npc <= 16),
// c <= 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_mma.cuh"

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
constexpr int kKeyNegInf = 127;  // key16(-inf)
constexpr size_t kMaxSmem = 232448;  // 227 KB
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMT = 32;       // queries per pass (two m16 tiles)
constexpr int kKT = 32;       // D per ring stage (two k16 steps)
constexpr int kStages = 4;    // cp.async ring depth
constexpr int kDPad = 64;     // D of the bf16 query scratch rounds up to this
constexpr int kQRow = kKT * 2 + 16;  // bytes per query row in a stage
constexpr int kPackRow = kSG + 8;    // ints per query row of packed values

// One ring stage holds kKT of D for the supergroup's 256 slot rows and
// the pass's 32 queries, each row padded by 16 bytes so that the eight
// rows a fragment load touches fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return kKT * (int)sizeof(T) + 16;
}
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kSG * row_bytes<T>() + kMT * kQRow;
}

// Monotone 16-bit key of a float32 score (ivf_scan_pallas.py::_key16).
__device__ __forceinline__ int key16(float s) {
  const unsigned u = __float_as_uint(s);
  const unsigned rne = u + 0x7FFFu + ((u >> 16) & 1u);
  const unsigned b16 = rne >> 16;
  return (u >> 31) ? (int)(0xFFFFu - b16) : (int)(b16 | 0x8000u);
}

// Lane `lane` of the row of a (query, chunk) that no query probes: the
// two selection levels over an all -inf chunk keep the lowest slots.
__device__ __forceinline__ int unprobed_lane(int lane, int pos_bits, int cw,
                                             int npc) {
  const int neg = kKeyNegInf << pos_bits;
  if (lane < kCK) {
    if (lane >= npc * kM) return kNeg;
    const int s = (lane / kM) * kSG + lane % kM;
    return neg | (cw - 1 - s);
  }
  const int g = lane - kCK;
  return g < npc ? neg | (cw - 1 - (g * kSG + kM - 1)) : kNeg;
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

// The k-th largest of the warp's 256 distinct values in [0, 2^n_bits),
// 8 a lane, built bit by bit from the top: the largest t with at least k
// values >= t.
__device__ __forceinline__ int kth_largest(const int (&v)[8], int k,
                                           int n_bits) {
  int t = 0;
  for (int bit = n_bits - 1; bit >= 0; --bit) {
    const int cand = t | (1 << bit);
    int n = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) n += v[i] >= cand;
    if ((int)__reduce_add_sync(kFull, (unsigned)n) >= k) t = cand;
  }
  return t;
}

// Level 2 for one query: sorts its n_surv <= 32 * N survivors and writes
// its row: the top 96 descending (-1 past n_surv), each supergroup's 24th
// value, -1 pads.
template <int N>
__device__ __forceinline__ void write_row(const int* surv, int n_surv,
                                          const int* vlast, int npc,
                                          int lane, int* row) {
  int v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = lane * N + i;
    v[i] = e < n_surv ? surv[e] : kNeg;
  }
  warp_sort_desc<N>(v, lane);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = lane * N + i;
    if (e < kCK) row[e] = v[i];
  }
  row[kCK + lane] = lane < npc ? vlast[lane] : kNeg;
}

__global__ void fill_unprobed_kernel(int4* __restrict__ out, size_t n_vec,
                                     int pos_bits, int cw, int npc) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;  // a multiple of 32
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane0 = (int)(i % (kLanes / 4)) * 4;
  const int4 v = make_int4(unprobed_lane(lane0, pos_bits, cw, npc),
                           unprobed_lane(lane0 + 1, pos_bits, cw, npc),
                           unprobed_lane(lane0 + 2, pos_bits, cw, npc),
                           unprobed_lane(lane0 + 3, pos_bits, cw, npc));
  for (; i < n_vec; i += stride) out[i] = v;
}

template <typename T>
size_t smem_bytes(int npc, int c) {
  return (size_t)kStages * stage_bytes<T>()           // ring
         + (size_t)kMT * kPackRow * sizeof(int)        // packed values
         + (size_t)kMT * npc * kM * sizeof(int)        // survivors
         + (size_t)kMT * kMaxNpc * sizeof(int)         // 24th values
         + kMT * sizeof(int) + kMT * sizeof(float)     // query ids, prec
         + (size_t)kMT * c;                            // probe bits
}

// Starts the copy of ring tile t of a pass (supergroup t / nkt, D from
// (t % nkt) * kKT) into stage t % kStages: the supergroup's slot rows
// from `rows` and the pass's queries (s_qid, -1 = none) from q_bf16.
// Past D, and for absent queries, the stage is zero-filled.
template <typename T>
__device__ __forceinline__ void issue_tile(
    unsigned char* ring, int t, int nkt, const T* __restrict__ rows,
    const __nv_bfloat16* __restrict__ q_bf16, const int* s_qid, int dim,
    int dim_pad, bool vec) {
  constexpr int kElem = (int)sizeof(T);
  constexpr int kRow = row_bytes<T>();
  unsigned char* st = ring + (size_t)(t % kStages) * stage_bytes<T>();
  const int g = t / nkt;
  const int k0 = (t - g * nkt) * kKT;
  rows += (size_t)g * kSG * dim;
  if (vec) {
    constexpr int kPieces = kKT * kElem / 16;  // 16-byte pieces a row
    constexpr int kPer = 16 / kElem;           // elements a piece
    for (int i = threadIdx.x; i < kSG * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int pc = i - r * kPieces;
      const int k = k0 + pc * kPer;
      const T* src = rows + (size_t)r * dim + (k < dim ? k : 0);
      cp_async16(st + r * kRow + pc * 16, src, k < dim ? 16 : 0);
    }
  } else {
    using Raw = typename Bits<T>::type;
    const Raw* src = reinterpret_cast<const Raw*>(rows);
    Raw* dst = reinterpret_cast<Raw*>(st);
    for (int i = threadIdx.x; i < kSG * kKT; i += kThreads) {
      const int r = i / kKT;
      const int kk = i - r * kKT;
      const int k = k0 + kk;
      dst[r * (kRow / kElem) + kk] =
          k < dim ? src[(size_t)r * dim + k] : (Raw)0;
    }
  }
  constexpr int kQPieces = kKT * 2 / 16;
  unsigned char* sq = st + kSG * kRow;
  for (int i = threadIdx.x; i < kMT * kQPieces; i += kThreads) {
    const int r = i / kQPieces;
    const int pc = i - r * kQPieces;
    const int qb = s_qid[r];
    const __nv_bfloat16* src =
        q_bf16 + (qb >= 0 ? (size_t)qb * dim_pad + k0 + pc * 8 : 0);
    cp_async16(sq + r * kQRow + pc * 16, src, qb >= 0 ? 16 : 0);
  }
}

// A work item is one pass: up to 32 of the queries that probe one chunk.
// ends[j] is the inclusive prefix sum of the chunks' pass counts, so
// items ends[j - 1] .. ends[j] - 1 are chunk j's.  Blocks stride over the
// items; consecutive items share a chunk, so blocks that run together
// read the same rows.
template <typename T>
__global__ void __launch_bounds__(kThreads) probed_scan_kernel(
    const T* __restrict__ vectors, const int* __restrict__ ids,
    const float* __restrict__ prec, const float* __restrict__ scales,
    const __nv_bfloat16* __restrict__ q_bf16,
    const float* __restrict__ q_prec, const uint8_t* __restrict__ probed,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const int* __restrict__ ends, int* __restrict__ out, int n_list, int cap,
    int c, int dim, int dim_pad, int batch, int pos_bits, bool vec,
    float charge, float tol_val, int ppm) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRow = row_bytes<T>();
  const int cw = c * cap;
  const int npc = cw / kSG;
  const int n_chunks = n_list / c;
  const int nkt = (dim + kKT - 1) / kKT;
  const int total = npc * nkt;  // ring tiles per pass
  const int n_items = ends[n_chunks - 1];

  unsigned char* ring = smem;
  int* s_packed =
      reinterpret_cast<int*>(smem + (size_t)kStages * stage_bytes<T>());
  int* s_surv = s_packed + kMT * kPackRow;      // [kMT][npc * kM]
  int* s_vlast = s_surv + kMT * npc * kM;       // [kMT][kMaxNpc]
  int* s_qid = s_vlast + kMT * kMaxNpc;         // [kMT]
  float* s_qp = reinterpret_cast<float*>(s_qid + kMT);  // [kMT]
  uint8_t* s_probe = reinterpret_cast<uint8_t*>(s_qp + kMT);  // [kMT][c]

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int fg = lane >> 2;  // fragment row / column group
  const int ft = lane & 3;   // fragment k pair

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int lo = 0, hi = n_chunks - 1;  // the chunk: first j with ends[j] > item
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (ends[mid] > item) hi = mid; else lo = mid + 1;
    }
    const int chunk = lo;
    const int p0 = (item - (chunk > 0 ? ends[chunk - 1] : 0)) * kMT;
    const int nq = min(kMT, counts[chunk] - p0);
    const size_t slot0 = (size_t)chunk * cw;
    const int* list = lists + (size_t)chunk * batch + p0;
    if (threadIdx.x < kMT) {
      const int i = threadIdx.x;
      const int qb = i < nq ? list[i] : -1;
      s_qid[i] = qb;
      s_qp[i] = qb >= 0 ? q_prec[qb] : 0.0f;
    }
    for (int i = threadIdx.x; i < kMT * c; i += kThreads) {
      const int r = i / c;
      s_probe[i] = r < nq ? probed[(size_t)list[r] * n_list + chunk * c +
                                   i - r * c]
                          : 0;
    }
    __syncthreads();

    const T* rows = vectors + slot0 * dim;
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < total)
        issue_tile<T>(ring, t, nkt, rows, q_bf16, s_qid, dim, dim_pad, vec);
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

    for (int t = 0; t < total; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (t + kStages - 1 < total)
        issue_tile<T>(ring, t + kStages - 1, nkt, rows, q_bf16, s_qid, dim,
                      dim_pad, vec);
      cp_async_commit();

      const unsigned char* st = ring + (size_t)(t % kStages) * stage_bytes<T>();
      const __nv_bfloat16* sq =
          reinterpret_cast<const __nv_bfloat16*>(st + kSG * kRow);
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

      if ((t + 1) % nkt != 0) continue;
      // The supergroup's scores are complete: mask, pack, keep 24 each.
      const int g = t / nkt;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = warp * 32 + nt * 8 + 2 * ft + e;
          const int s = g * kSG + col;
          const size_t gs = slot0 + s;
          const bool valid = ids[gs] >= 0;
          const float sc = scales[gs];
          const float pr = prec[gs];
          const int ci = s / cap;
          const int inv = cw - 1 - s;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = mt * 16 + fg + 8 * h;
              if (r >= nq) continue;
              bool ok = valid && s_probe[r * c + ci] != 0;
              if (tol_val > 0.0f) {
                const float dm = fabsf(s_qp[r] - pr);
                ok = ok && (ppm ? dm / fmaxf(pr, 1e-6f) * 1e6f <= tol_val
                                : dm * charge <= tol_val);
              }
              const float score =
                  ok ? acc[mt][nt][2 * h + e] * sc : -CUDART_INF_F;
              s_packed[r * kPackRow + col] = (key16(score) << pos_bits) | inv;
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      __syncthreads();
      // A warp a query: the 24th value by a bitwise search, then the 24
      // values at or above it, in any order (level 2 sorts them).
      for (int r = warp; r < nq; r += kWarps) {
        const int* base = s_packed + r * kPackRow;
        int v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = base[i * kWarp + lane];
        const int t = kth_largest(v, kM, pos_bits + 16);
        int n = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) n += v[i] >= t;
        int off = n;  // inclusive prefix sum over the lanes
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
          const int y = __shfl_up_sync(kFull, off, d);
          if (lane >= d) off += y;
        }
        off -= n;
        int* surv = s_surv + (r * npc + g) * kM;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (v[i] >= t) surv[off++] = v[i];
        }
        if (lane == 0) s_vlast[r * kMaxNpc + g] = t;
      }
      // The next write of s_packed follows at least one more barrier at
      // the top of the loop.
    }
    cp_async_wait<0>();
    __syncthreads();

    // Level 2: the chunk's top 96 of the npc * 24 survivors, and the row.
    const int n_surv = npc * kM;
    for (int r = warp; r < nq; r += kWarps) {
      int* row = out + ((size_t)s_qid[r] * n_chunks + chunk) * kLanes;
      if (n_surv <= 8 * kWarp)
        write_row<8>(s_surv + r * n_surv, n_surv, s_vlast + r * kMaxNpc,
                     npc, lane, row);
      else
        write_row<16>(s_surv + r * n_surv, n_surv, s_vlast + r * kMaxNpc,
                      npc, lane, row);
    }
    __syncthreads();  // the next item rewrites the query slots
  }
}

// Allows the scan kernel `smem` bytes of shared memory and sets *per_sm
// to how many of its blocks an SM of the current device holds.
template <typename T>
cudaError_t resident_blocks(size_t smem, int* per_sm) {
  auto kernel = probed_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

template <typename T>
cudaError_t launch(const void* vectors, const int* ids, const float* prec,
                   const float* scales, const float* queries,
                   const float* q_prec, const uint8_t* probed,
                   const int* lists, const int* counts, const int* ends,
                   void* q_bf16, int* out, int n_list, int cap, int c,
                   int dim, int batch, int pos_bits, float charge,
                   float tol_val, int ppm, cudaStream_t stream) {
  const int cw = c * cap;
  const int npc = cw / kSG;
  const int n_chunks = n_list / c;
  const int dim_pad = (dim + kDPad - 1) / kDPad * kDPad;
  const size_t n_vec = (size_t)batch * n_chunks * (kLanes / 4);
  fill_unprobed_kernel<<<2048, 256, 0, stream>>>(
      reinterpret_cast<int4*>(out), n_vec, pos_bits, cw, npc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* qb = static_cast<__nv_bfloat16*>(q_bf16);
  prep_queries_kernel<<<1024, 256, 0, stream>>>(queries, qb, batch, dim,
                                                dim_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // One wave of resident blocks strides over the items.
  const size_t smem = smem_bytes<T>(npc, c);
  int device = 0, n_sm = 0, per_sm = 0;
  err = resident_blocks<T>(smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const long long max_items = (long long)n_chunks * ((batch + kMT - 1) / kMT);
  const int grid =
      (int)(max_items < (long long)n_sm * per_sm ? max_items
                                                 : (long long)n_sm * per_sm);
  if (grid < 1) return cudaErrorInvalidValue;
  const bool vec = (dim * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  probed_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(vectors), ids, prec, scales, qb, q_prec, probed,
      lists, counts, ends, out, n_list, cap, c, dim, dim_pad, batch,
      pos_bits, vec, charge, tol_val, ppm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Queries a work item (pass) takes: the caller's `ends` counts passes of
// this many.
int ivf_chunked_scan_queries_per_pass() { return kMT; }

// The row length of the bf16 query scratch the caller allocates: D
// rounded up to a multiple of 64.
int ivf_chunked_scan_padded_dim(int dim) {
  return (dim + kDPad - 1) / kDPad * kDPad;
}

// Dynamic shared memory of a scan block (bytes) and how many such blocks
// an SM of the current device holds; storage as below.
long long ivf_chunked_scan_smem_bytes(int storage, int cw, int c) {
  return (long long)(storage == 0 ? smem_bytes<int8_t>(cw / kSG, c)
                                  : smem_bytes<__nv_bfloat16>(cw / kSG, c));
}
int ivf_chunked_scan_resident_blocks(int storage, int cw, int c) {
  const size_t smem = (size_t)ivf_chunked_scan_smem_bytes(storage, cw, c);
  int per_sm = 0;
  const cudaError_t err = storage == 0
                              ? resident_blocks<int8_t>(smem, &per_sm)
                              : resident_blocks<__nv_bfloat16>(smem, &per_sm);
  return err == cudaSuccess ? per_sm : -1;
}

// Launches the scan on `stream`; returns cudaGetLastError() (0 = ok).
// storage: 0 = int8, 1 = bf16.  Device pointers to contiguous arrays:
// vectors (n_list * cap, dim); ids int32, prec, scales (n_list * cap);
// queries float32 (batch, dim); q_prec (batch,); probed uint8
// (batch, n_list); lists int32 (n_list / c, batch): row j starts with the
// counts[j] queries that probe chunk j, ascending; counts int32
// (n_list / c,); ends int32 (n_list / c,), the inclusive prefix sum of
// ceil(counts / queries per pass); q_bf16 scratch (batch, padded dim)
// bf16; out int32 (batch, n_list / c, 128).
int ivf_chunked_scan(const void* vectors, int storage, const int* ids,
                     const float* prec, const float* scales,
                     const float* queries, const float* q_prec,
                     const uint8_t* probed, const int* lists,
                     const int* counts, const int* ends, void* q_bf16,
                     int* out, int n_list, int cap, int c, int dim, int batch,
                     int pos_bits, float charge, float tol_val, int ppm,
                     void* stream) {
  const int cw = c * cap;
  if (n_list < 1 || cap < 1 || dim < 1 || batch < 0 || c < 1 || c > kMaxC ||
      n_list % c != 0 || cw % kSG != 0 || cw / kSG > kMaxNpc ||
      kCK + cw / kSG > kLanes || (1 << pos_bits) < cw || pos_bits + 16 > 31 ||
      (storage != 0 && storage != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int npc = cw / kSG;
  const size_t smem = storage == 0 ? smem_bytes<int8_t>(npc, c)
                                   : smem_bytes<__nv_bfloat16>(npc, c);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      storage == 0
          ? launch<int8_t>(vectors, ids, prec, scales, queries, q_prec,
                           probed, lists, counts, ends, q_bf16, out, n_list,
                           cap, c, dim, batch, pos_bits, charge, tol_val, ppm,
                           s)
          : launch<__nv_bfloat16>(vectors, ids, prec, scales, queries, q_prec,
                                  probed, lists, counts, ends, q_bf16, out,
                                  n_list, cap, c, dim, batch, pos_bits,
                                  charge, tol_val, ppm, s);
  return (int)err;
}

const char* ivf_chunked_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
