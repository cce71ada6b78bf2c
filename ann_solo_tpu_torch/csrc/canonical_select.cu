// Canonical top-k select with dedup for Hopper (sm_90a): kernel B5.
//
// Replaces no Pallas kernel.  It is the selection that follows the
// probe-gather scan, XLA code of the reference: the canonical top-k of
// ann_solo_tpu/index/ivf.py::_canonical_topk (:779, packed 16-bit key
// sort) and the id gather and unique-id top-k of _ivf_probe_scan_tile
// (:1211, :1282-1291), which the port ran as a chain of torch passes
// (ops/canonical_select.py::canonical_select_plain, the plain version
// this kernel equals bit for bit).  For each row b of the (B, n) float32
// score block (n = P * cap lanes in (probe rank, slot) order, -inf where
// masked), with k_eff = min(k_sel, n):
//
//   1. key(lane) = the monotone 16-bit key of the score: round to nearest
//      even to bf16, then flip (negative) or set the sign bit (positive);
//      -inf maps to 0x7F (ops/ivf_scan.py::_key16);
//   2. the top k_eff lanes in canonical order: key descending, lane
//      ascending; each score decoded from its key (_key16_to_f32);
//   3. id = padded_ids[probe_ids[b, lane / cap], lane % cap], or -1 where
//      the decoded score is not above -inf or the probe id lies outside
//      [0, L);
//   4. with dedup (redundant, or k_eff > k): each id keeps its first lane
//      in canonical order, ids of -1 are dropped, the kept lanes stay in
//      order;
//   5. the first k lanes are written, padded with -inf and -1.
//
// What bounds it on the H100: device-memory bytes.  The f32 lanes read
// once and the (B, k) outputs written once (plus the probe table and one
// id a selected lane): at the bench's 4,096 x 49,152 lanes about 0.8 GB,
// 0.24 ms at 3.35 TB/s; the arithmetic is a few integer operations a
// lane.  The design is simple and exact first:
//
// * one block of 512 threads a row; each of the 16 warps owns a
//   contiguous run of the row's lanes and reads it 32 lanes (128 bytes) a
//   step, coalesced;
// * radix select on the 16-bit key, two 8-bit histogram passes in shared
//   memory (warp-aggregated integer atomics: lanes of one bin add once),
//   each followed by one warp's search from the top bin, find the
//   threshold key T and r, the count of lanes at T still to take;
// * the tie rule is lane order: a third pass counts each warp's lanes at
//   T, one warp scans the counts, and the fourth pass takes every lane
//   above T and the lanes at T whose rank in lane order (the warp's
//   offset plus a ballot prefix) is below r.  The taken lanes, exactly
//   k_eff, are compacted into shared memory as packed words
//   (key << 32 | n - 1 - lane) at slots from an integer counter: their
//   order there does not matter, the words are distinct;
// * a bitonic sort of the words (descending, padded to m, the least power
//   of two >= k_eff) gives the canonical order; each word decodes to its
//   score and id;
// * dedup sorts (id, rank) words ascending, marks the first rank of each
//   run of a valid id, and compacts the marked ranks in rank order by a
//   block-wide prefix count.
//
// No float atomics and no float arithmetic but the key's decode, so the
// result does not depend on the order threads run in.  The row is read
// four times (passes 1-4); the L2 holds part of it between passes.
// Limits (the wrapper raises first): 1 <= n <= 2^22 lanes (the probe
// path's MAX_PROBE_LANES), 1 <= k_eff <= 4,096, n = P * cap.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxSel = 4096;
constexpr int kMaxLanes = 1 << 22;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* flat;        // (b, n) scores, -inf masked
  const long long* probe;   // (b, p) probe list ids
  const int* ids;           // (l, cap) library ids, -1 empty
  float* out_s;             // (b, k)
  int* out_i;               // (b, k)
  int n, p, l, cap, k_eff, k, m, dedup;
};

// The key of ops/ivf_scan.py::_key16 on the uint32 bit pattern: the
// rounding add wraps modulo 2^32 as the plain version's mask does.
__device__ __forceinline__ unsigned key16(float s) {
  const unsigned u = __float_as_uint(s);
  const unsigned b16 = (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  return u >= 0x80000000u ? 0xffffu - b16 : (b16 | 0x8000u);
}

// ops/ivf_scan.py::_key16_to_f32: the bf16-rounded score of a key.
__device__ __forceinline__ float key16_to_f32(unsigned key) {
  const unsigned b16 = key < 0x8000u ? 0xffffu - key : key - 0x8000u;
  return __uint_as_float(b16 << 16);
}

// Shared memory a block needs beyond its static part: the packed words
// (8 bytes), then the decoded scores, ids and dedup marks (4 bytes each),
// m of each.
__host__ __device__ inline size_t smem_bytes(int m) {
  return (size_t)m * (8 + 4 + 4 + 4);
}

// Warp 0: the highest bin h whose count from the top reaches `need`
// (1 <= need <= the histogram's total), and `above`, the count of the
// bins over h.  Lane j holds bins 255 - 8j down to 248 - 8j.
__device__ __forceinline__ void find_bin(const int* hist, int need,
                                         int* bin, int* above) {
  const int lane = threadIdx.x & 31;
  int c[8];
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = hist[kBins - 1 - 8 * lane - j];
    s += c[j];
  }
  int incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const unsigned hit = __ballot_sync(kFull, incl >= need);
  if (lane == __ffs(hit) - 1) {
    int cum = incl - s, found = -1, at = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (found < 0 && cum + c[j] >= need) {
        found = kBins - 1 - 8 * lane - j;
        at = cum;
      }
      cum += c[j];
    }
    *bin = found;
    *above = at;
  }
}

// Warp 0: exclusive prefix sums of vals[0 .. kWarps) in place, the total
// into vals[kWarps].
__device__ __forceinline__ void scan_warp_counts(int* vals) {
  const int lane = threadIdx.x & 31;
  const int v = lane < kWarps ? vals[lane] : 0;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane < kWarps) vals[lane] = incl - v;
  if (lane == 31) vals[kWarps] = incl;
}

// Bitonic sort of words[0 .. m), m a power of two, descending or
// ascending; every thread of the block calls it.
__device__ void bitonic(unsigned long long* words, int m, bool descending) {
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (m >> 1); t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = words[lo], b = words[hi];
        // Runs alternate direction below the last merge; the last one
        // (size == m) sorts the whole array in the asked direction.
        const bool down = ((lo & size) == 0) == descending;
        if (down ? a < b : a > b) {
          words[lo] = b;
          words[hi] = a;
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    canonical_select_kernel(const Params p) {
  extern __shared__ unsigned long long words[];
  float* score = reinterpret_cast<float*>(words + p.m);
  int* ident = reinterpret_cast<int*>(score + p.m);
  int* keep = ident + p.m;
  __shared__ int hist[kBins];
  __shared__ int counts[kWarps + 1];
  __shared__ int sel[5];  // bin, above, bin, above, taken

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long row = blockIdx.x;
  const float* x = p.flat + row * (long long)p.n;
  float* out_s = p.out_s + row * (long long)p.k;
  int* out_i = p.out_i + row * (long long)p.k;
  const int k_eff = p.k_eff;
  // Each warp's run of lanes: a multiple of 32, in lane order.
  const int run = (p.n + kThreads - 1) / kThreads * 32;
  const int begin = min(p.n, warp * run);
  const int end = min(p.n, begin + run);

  // Pass 1: histogram of the keys' high bytes.
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  if (tid == 0) sel[4] = 0;
  __syncthreads();
  for (int base = begin; base < end; base += 32) {
    const int j = base + lane;
    const unsigned bin = j < end ? key16(x[j]) >> 8 : kBins;
    const unsigned peers = __match_any_sync(kFull, bin);
    if (bin < kBins && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[bin], __popc(peers));
    }
  }
  __syncthreads();
  if (warp == 0) find_bin(hist, k_eff, &sel[0], &sel[1]);
  __syncthreads();
  const unsigned high = (unsigned)sel[0];
  const int need = k_eff - sel[1];  // lanes to take within the high bin
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  __syncthreads();

  // Pass 2: histogram of the low bytes within the high bin.
  for (int base = begin; base < end; base += 32) {
    const int j = base + lane;
    unsigned bin = kBins;
    if (j < end) {
      const unsigned key = key16(x[j]);
      if ((key >> 8) == high) bin = key & 0xffu;
    }
    const unsigned peers = __match_any_sync(kFull, bin);
    if (bin < kBins && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[bin], __popc(peers));
    }
  }
  __syncthreads();
  if (warp == 0) find_bin(hist, need, &sel[2], &sel[3]);
  __syncthreads();
  const unsigned thresh = (high << 8) | (unsigned)sel[2];
  const int ties = need - sel[3];  // lanes at the threshold to take

  // Pass 3: lanes at the threshold in each warp's run.
  int at = 0;
  for (int base = begin; base < end; base += 32) {
    const int j = base + lane;
    at += __popc(__ballot_sync(kFull, j < end && key16(x[j]) == thresh));
  }
  if (lane == 0) counts[warp] = at;
  __syncthreads();
  if (warp == 0) scan_warp_counts(counts);
  __syncthreads();

  // Pass 4: take the lanes above the threshold and the first `ties` at
  // it in lane order, compacted as packed words.
  int tie_rank = counts[warp];
  for (int base = begin; base < end; base += 32) {
    const int j = base + lane;
    const unsigned key = j < end ? key16(x[j]) : 0u;
    const bool tie = j < end && key == thresh;
    const unsigned tie_mask = __ballot_sync(kFull, tie);
    const bool take = j < end && (key > thresh ||
                                  (tie && tie_rank + __popc(tie_mask & lt) <
                                              ties));
    tie_rank += __popc(tie_mask);
    const unsigned take_mask = __ballot_sync(kFull, take);
    int slot = 0;
    if (lane == 0 && take_mask) slot = atomicAdd(&sel[4], __popc(take_mask));
    slot = __shfl_sync(kFull, slot, 0) + __popc(take_mask & lt);
    if (take) {
      words[slot] = ((unsigned long long)key << 32) | (unsigned)(p.n - 1 - j);
    }
  }
  for (int i = k_eff + tid; i < p.m; i += kThreads) words[i] = 0ull;

  // Canonical order: key descending, lane ascending (reversed lane
  // descending).  A pad word 0 can only equal a real word 0, and equal
  // words are interchangeable.
  bitonic(words, p.m, true);
  for (int i = tid; i < k_eff; i += kThreads) {
    const unsigned long long w = words[i];
    const int j = p.n - 1 - (int)(unsigned)(w & 0xffffffffull);
    const float s = key16_to_f32((unsigned)(w >> 32));
    int id = -1;
    if (s > -CUDART_INF_F) {
      const int rank = j / p.cap;
      const long long list = p.probe[row * p.p + rank];
      if (list >= 0 && list < p.l) {
        id = p.ids[list * p.cap + (j - rank * p.cap)];
      }
    }
    score[i] = s;
    ident[i] = id;
  }
  __syncthreads();

  if (!p.dedup) {  // k_eff <= k here
    for (int i = tid; i < p.k; i += kThreads) {
      out_s[i] = i < k_eff ? score[i] : -CUDART_INF_F;
      out_i[i] = i < k_eff ? ident[i] : -1;
    }
    return;
  }

  // Dedup: (id, rank) words ascending, the id's sign bit flipped so that
  // unsigned order is signed order; pads sort last.
  for (int i = tid; i < p.m; i += kThreads) {
    words[i] = i < k_eff
                   ? ((unsigned long long)((unsigned)ident[i] ^ 0x80000000u)
                      << 32) | (unsigned)i
                   : ~0ull;
  }
  bitonic(words, p.m, false);
  for (int i = tid; i < k_eff; i += kThreads) {
    const unsigned long long w = words[i];
    const unsigned id_key = (unsigned)(w >> 32);
    const bool first = (i == 0 || (unsigned)(words[i - 1] >> 32) != id_key) &&
                       id_key >= 0x80000000u;  // the id is >= 0
    keep[(int)(unsigned)(w & 0xffffffffull)] = first ? 1 : 0;
  }
  __syncthreads();
  // Kept ranks in rank order: each thread a run of ranks, a block-wide
  // prefix count of the kept ones.
  const int per = (k_eff + kThreads - 1) / kThreads;
  const int r0 = min(k_eff, tid * per), r1 = min(k_eff, r0 + per);
  int cnt = 0;
  for (int i = r0; i < r1; ++i) cnt += keep[i];
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) counts[warp] = incl;
  __syncthreads();
  if (warp == 0) scan_warp_counts(counts);
  __syncthreads();
  int pos = counts[warp] + incl - cnt;
  for (int i = r0; i < r1 && pos < p.k; ++i) {
    if (keep[i]) {
      out_s[pos] = score[i];
      out_i[pos] = ident[i];
      ++pos;
    }
  }
  const int kept = min(counts[kWarps], p.k);
  for (int i = kept + tid; i < p.k; i += kThreads) {
    out_s[i] = -CUDART_INF_F;
    out_i[i] = -1;
  }
}

}  // namespace

extern "C" {

// Launches the select on `stream`; returns cudaGetLastError() (0 = ok).
// Device pointers to contiguous arrays: flat float32 (b, n_probe * cap);
// probe int64 (b, n_probe); ids int32 (n_list, cap); out_s float32 and
// out_i int32 (b, k).  k_sel is clipped to n; dedup as the caller decides
// (redundant storage, or k_eff > k; without it k_eff must be <= k).
int canonical_select(const float* flat, const long long* probe,
                     const int* ids, float* out_s, int* out_i, int b,
                     int n_probe, int n_list, int cap, int k_sel, int k,
                     int dedup, void* stream) {
  if (b < 0 || n_probe < 1 || n_list < 1 || cap < 1 || k_sel < 1 || k < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)n_probe * cap;
  if (n > kMaxLanes) return (int)cudaErrorInvalidValue;
  const int k_eff = (int)(k_sel < n ? k_sel : n);
  if (k_eff > kMaxSel || (!dedup && k_eff > k)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || k == 0) return (int)cudaSuccess;
  Params p;
  p.flat = flat;
  p.probe = probe;
  p.ids = ids;
  p.out_s = out_s;
  p.out_i = out_i;
  p.n = (int)n;
  p.p = n_probe;
  p.l = n_list;
  p.cap = cap;
  p.k_eff = k_eff;
  p.k = k;
  p.m = 1;
  while (p.m < k_eff) p.m <<= 1;
  p.dedup = dedup ? 1 : 0;
  const size_t smem = smem_bytes(p.m);
  cudaError_t err = cudaFuncSetAttribute(
      canonical_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  canonical_select_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* canonical_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
