// Canonical top-k select with dedup for Hopper (sm_90a): kernel B5.
//
// Replaces no Pallas kernel.  It is the selection that follows the
// probe-gather scan, XLA code of the reference: the canonical top-k of
// ann_solo_tpu/index/ivf.py::_canonical_topk (:673, packed 16-bit key
// sort; _canonical_topk_u16 at :719) and the id gather and unique-id
// top-k of _ivf_probe_scan_tile (:1211, :1282-1291), which the port ran
// as a chain of torch passes
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
// id a selected lane): at the bench's 4,096 x 49,152 lanes about 0.86 GB,
// 0.26 ms at 3.35 TB/s; the rest is integer work on chip.  The design:
//
// * One block of 512 threads a row.  Pass 1 reads the row from device
//   memory once, 16 bytes a thread a load (the lanes in groups of four at
//   16-byte aligned addresses; a row whose start is not aligned, n = P *
//   cap odd, takes its head and tail lanes one by one), the next two
//   loads of each thread issued before its current two are used: 16 KB
//   in flight a block, 32 KB an SM.  Each lane becomes its 16-bit key as
//   it arrives; the key goes to shared memory at index lane + off (off =
//   the row start's misalignment in lanes, so each group's four keys are
//   one 8-byte store) and its high byte into a 256-bin histogram
//   (warp-aggregated integer atomics: the lanes of one bin add once).
// * Passes 2 and 3 read the keys in shared memory, 16 a thread a chunk
//   of 8,192 positions.  Pass 2: the histogram of the low bytes within
//   the chosen high bin (the two searches from the top bin give the
//   threshold key T and the count of lanes at T still to take).  Pass 3,
//   the compaction: one block scan a chunk of each thread's counts at and
//   above T (packed in one int) gives its first tie rank and its first
//   slot; the ties go in lane order, and every taken lane goes to slot =
//   its rank in lane order among the taken lanes, so the compacted lanes
//   stay in lane order.  A warp's lanes write its taken lanes, one each
//   (a binary search over the warp's prefix counts finds the owner).
// * Canonical order: 32-bit words key << 16 | (0xffff - slot) (slot <
//   4,096, the lane kept beside in shared memory), distinct, sorted
//   descending by a bitonic network whose strides below a warp's span
//   (32 * E words, E = 2, 4 or 8 a thread for up to 1,024, 2,048 and
//   4,096 words) run in registers with __shfl_xor_sync: only the larger
//   strides pass through shared memory with a block barrier (16 barriers
//   at 1,024, 2,048 or 4,096 words, against 55, 66 and 78 for the whole
//   network in shared memory).
// * Dedup keeps each id's least rank: an open-addressing table in shared
//   memory (2 * words slots of an id and a rank, linear probing), a
//   32-bit atomicCAS claims a slot for an id and atomicMin keeps its
//   least rank, whatever order the threads run in; then a block-wide
//   prefix count of the kept ranks in rank order places them.
// * Two blocks an SM on the main path's rows (shared memory below), so
//   one row's bytes can arrive while the other block works on chip.
//
// Shared memory (dynamic; the static part is under kStaticReserve):
//   keys   2 * round_up(n + 3, 8) bytes, reused by the dedup table
//          (16 * words bytes) once the compaction is done: the area is
//          the larger of the two;
//   words  8 * words bytes (words = max(m, 128), m the least power of two
//          >= k_eff): the sort words and the slot -> lane map; the 1 KB
//          histogram lies there during passes 1 and 2.
// At the main path's shapes (chip_smoke.py SELECT_CASES; blocks an SM of
// the 233,472 bytes with 1 KB reserved a block, at most 2 by the
// registers of __launch_bounds__):
//   bench_k512, tile_2m_x1   49,152 lanes, m 1,024: 98,320 + 8,192 =
//                            106,512 B, 2 blocks;
//   bench_k1024, tile_2m     49,152 lanes, m 2,048: 98,320 + 16,384 =
//                            114,704 B, 2 blocks;
//   k_max                    49,152 lanes, m 4,096: 98,320 + 32,768 =
//                            131,088 B, 1 block;
//   stream_8m                98,304 lanes, m 1,024: 196,624 + 8,192 =
//                            204,816 B, 1 block;
//   engine                   20,480 lanes, m 2,048: 40,976 + 16,384 =
//                            57,360 B, 2 blocks (3 by shared memory
//                            alone);
//   odd                      39,347 lanes, m 1,024: 78,704 + 8,192 =
//                            86,896 B, 2 blocks.
// Rows too long for that (2 * round_up(n + 3, 8) + 8 * words above
// kSmemLimit - kStaticReserve: n above about 112,000 lanes at m 1,024,
// 107,900 at m 2,048, 99,700 at m 4,096) take the long-row branch of the
// same kernel: no keys in shared memory, passes 1-3 each read the row
// from device memory (16 bytes a thread a load), the same compaction,
// sort and dedup in 16 * words + 8 * words bytes.  No main-path row is
// that long; the branch is held against the plain version on the card
// all the same.
//
// More than kMaxSel (4,096) lanes selected (the open level's k_sel =
// redundancy x num_candidates, e.g. 8,192 at 4,096 candidates x2) take
// the wide branch, a second kernel over the same passes 1-3 (the same
// code, keys on chip while they fit beside the sort's tile, else read
// from device memory): the sort words, the sort and the dedup table
// live in a workspace in device memory that the wrapper allocates, 24
// bytes a sort word for each block of a persistent grid that walks the
// rows:
//   * words: 64-bit key << 32 | (0xffffffff - lane), so the lane needs
//     no side array and lanes up to 2^22 fit; distinct, and the pad
//     words 0 sort last;
//   * the sort: the same descending bitonic network over m words (the
//     least power of two >= k_eff); the strides below kTileWords (8,192
//     words, 64 KB) run tile by tile in shared memory (one load and one
//     store of a tile for all of a size's small strides), the larger
//     ones as block-wide passes over the workspace (L2-resident: 64 KB
//     a block at m 8,192);
//   * the dedup: the same CAS claim and atomicMin on the rank, against a
//     table of 2 * m slots in the workspace; ranks are decoded and
//     placed kThreads at a time (a block scan of the kept ranks).
// Shared memory of the wide branch: max(keys, 65,536) bytes (the keys
// until pass 3 ends, then the sort's tile) + 1 KB for the histogram;
// without the keys (rows too long): 65,536 + 1,024.  At the bench's
// 49,152 lanes: 98,320 + 1,024 = 99,344 B, 2 blocks an SM.  Its speed
// is recorded, not tuned: the sizes above 4,096 are off the bench's
// path.
//
// No float atomics and no float arithmetic but the key's decode, so the
// result does not depend on the order threads run in.  Limits (the
// wrapper raises first): 1 <= n <= 2^22 lanes (the probe path's
// MAX_PROBE_LANES), 1 <= k_eff <= n, n = P * cap.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxSel = 4096;          // the on-chip sort's largest k_eff
constexpr int kTileWords = 8192;       // the wide sort's tile in shared memory
constexpr int kHistBytes = kBins * 4;  // the wide branch's histogram area
constexpr int kMaxLanes = 1 << 22;
constexpr int kMinWords = 128;         // the word area holds the histogram
constexpr int kSmemLimit = 232448;     // shared memory a block may use
constexpr int kStaticReserve = 256;    // the kernel's static shared memory
constexpr int kLoads = 2;              // float4 loads a thread a step
constexpr int kSteps = 2;              // steps of 8 keys a thread a chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFree = 0xffffffffu;  // an empty dedup slot

struct Params {
  const float* flat;        // (b, n) scores, -inf masked
  const long long* probe;   // (b, p) probe list ids
  const int* ids;           // (l, cap) library ids, -1 empty
  float* out_s;             // (b, k)
  int* out_i;               // (b, k)
  unsigned long long* work;  // wide: 3 * words 64-bit words a block
  int n, p, l, cap, k_eff, k, words, dedup, on_chip;
  int area;                 // bytes of the key / table area
  int b;                    // rows (the wide grid walks them)
};

// The branch and the dynamic shared memory of a row of n lanes with
// k_eff selected (ops/select_cuda.py::plan computes the same).
struct Plan {
  int on_chip, words, area, smem;
};

// The wide branch (k_eff > kMaxSel): the key area holds the keys (on chip)
// or nothing, then the sort's tile; the histogram lies after it.
inline Plan make_plan(long long n, int k_eff) {
  int m = 1;
  while (m < k_eff) m <<= 1;
  Plan pl;
  pl.words = m < kMinWords ? kMinWords : m;
  const long long keys = 2 * ((n + 3 + 7) / 8 * 8);
  if (k_eff > kMaxSel) {
    const long long tile = 8LL * kTileWords;
    const long long area = keys > tile ? keys : tile;
    pl.on_chip = area + kHistBytes + kStaticReserve <= kSmemLimit;
    pl.area = (int)(pl.on_chip ? area : tile);
    pl.smem = pl.area + kHistBytes;
    return pl;
  }
  const long long table = 16LL * pl.words;
  const long long words = 8LL * pl.words;
  const long long on_chip = (keys > table ? keys : table) + words;
  pl.on_chip = on_chip + kStaticReserve <= kSmemLimit;
  pl.area = (int)(pl.on_chip ? on_chip - words : table);
  pl.smem = pl.area + (int)words;
  return pl;
}

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

// One count into hist[bin] for every lane of the warp (all 32 call it);
// bin kBins counts nothing.  Lanes of one bin add once.
__device__ __forceinline__ void add_to_bin(int* hist, unsigned bin) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin < kBins && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], __popc(peers));
  }
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

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Keys of positions 8s .. 8s + 7 (lane = position - off) and the mask of
// those that are lanes of the row: from shared memory (on chip) or from
// the row in device memory (the long-row branch; full groups of four as
// one 16-byte load, the edge groups lane by lane).
__device__ __forceinline__ unsigned keys8(const Params& p,
                                          const unsigned short* keys,
                                          const float* x, const float4* xa,
                                          int off, int s, unsigned k[8]) {
  const int lo = 8 * s;
  const int a = min(8, max(0, off - lo));
  const int b = min(8, max(0, off + p.n - lo));
  const unsigned valid = (0xffu >> (8 - b)) & (0xffu << a) & 0xffu;
  if (!valid) return 0u;
  if (p.on_chip) {
    const uint4 r = reinterpret_cast<const uint4*>(keys)[s];
    k[0] = r.x & 0xffffu; k[1] = r.x >> 16;
    k[2] = r.y & 0xffffu; k[3] = r.y >> 16;
    k[4] = r.z & 0xffffu; k[5] = r.z >> 16;
    k[6] = r.w & 0xffffu; k[7] = r.w >> 16;
    return valid;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (((valid >> (4 * h)) & 0xfu) == 0xfu) {
      const float4 v = __ldcs(xa + 2 * s + h);
      k[4 * h] = key16(v.x); k[4 * h + 1] = key16(v.y);
      k[4 * h + 2] = key16(v.z); k[4 * h + 3] = key16(v.w);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        k[4 * h + c] = ((valid >> (4 * h + c)) & 1u)
                           ? key16(x[lo + 4 * h + c - off]) : 0u;
      }
    }
  }
  return valid;
}

// One stage of the bitonic network on the E words a thread holds in
// registers (positions base .. base + E - 1 of the array): strides below
// E within the thread, strides below 32 * E with the partner lane.  The
// run of `size` containing a position sorts descending where the
// position's `size` bit is clear.
template <int E>
__device__ __forceinline__ void exchange(unsigned (&v)[E], int base,
                                         int size, int stride) {
  if (stride < E) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & stride) == 0) {
        const unsigned a = v[j], b = v[j + stride];
        const bool desc = ((base + j) & size) == 0;
        if (desc ? a < b : a > b) {
          v[j] = b;
          v[j + stride] = a;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const unsigned other = __shfl_xor_sync(kFull, v[j], stride / E);
      const bool lower = ((base + j) & stride) == 0;
      const bool desc = ((base + j) & size) == 0;
      v[j] = (lower == desc) ? max(v[j], other) : min(v[j], other);
    }
  }
}

// Bitonic sort, descending, of w[0 .. ms), ms a power of two >= 32 * E;
// every thread of the block calls it.  Each warp holds a tile of 32 * E
// words in registers (E a thread); strides of a tile's span and above go
// through shared memory with a barrier each.
template <int E>
__device__ void sort_desc(unsigned* w, int ms) {
  constexpr int S = 32 * E;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = ms / S;
  __syncthreads();
  for (int t = warp; t < tiles; t += kWarps) {
    const int base = t * S + lane * E;
    unsigned v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = w[base + j];
#pragma unroll
    for (int size = 2; size <= S; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        exchange<E>(v, base, size, stride);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) w[base + j] = v[j];
  }
  for (int size = 2 * S; size <= ms; size <<= 1) {
    for (int stride = size >> 1; stride >= S; stride >>= 1) {
      __syncthreads();
      for (int q = threadIdx.x; q < (ms >> 1); q += kThreads) {
        const int lo = 2 * q - (q & (stride - 1));
        const int hi = lo + stride;
        const unsigned a = w[lo], b = w[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? a < b : a > b) {
          w[lo] = b;
          w[hi] = a;
        }
      }
    }
    __syncthreads();
    for (int t = warp; t < tiles; t += kWarps) {
      const int base = t * S + lane * E;
      unsigned v[E];
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = w[base + j];
#pragma unroll
      for (int stride = S >> 1; stride > 0; stride >>= 1) {
        exchange<E>(v, base, size, stride);
      }
#pragma unroll
      for (int j = 0; j < E; ++j) w[base + j] = v[j];
    }
  }
  __syncthreads();
}

// The dedup table: 2 * words slots, each an id (kFree when free) and,
// in a second array, the least rank inserted with it; `shift` = 32 -
// log2(slots).  32-bit integer atomics only.
__device__ __forceinline__ unsigned slot_of(int id, int shift) {
  return ((unsigned)id * 0x9e3779b1u) >> shift;
}

__device__ __forceinline__ void table_insert(unsigned* ids, int* ranks,
                                             unsigned mask, int shift,
                                             int id, int rank) {
  unsigned h = slot_of(id, shift);
  while (true) {
    const unsigned cur = atomicCAS(&ids[h], kFree, (unsigned)id);
    if (cur == kFree || cur == (unsigned)id) {
      atomicMin(&ranks[h], rank);
      return;
    }
    h = (h + 1) & mask;
  }
}

// The least rank of an id that was inserted.
__device__ __forceinline__ int table_rank(const unsigned* ids,
                                          const int* ranks, unsigned mask,
                                          int shift, int id) {
  unsigned h = slot_of(id, shift);
  while (ids[h] != (unsigned)id) h = (h + 1) & mask;
  return ranks[h];
}

// Bitonic sort, descending, of w[0 .. m) in device memory (m a power of
// two >= 2); every thread of the block calls it.  The strides below S =
// min(m, kTileWords) run on tiles of S words in shared memory (`tile`),
// all of a size's small strides between one load and one store of each
// tile; the larger strides are block-wide passes over w.  The direction
// of a pair is set by its position in w, as in sort_desc.
__device__ void sort_desc_wide(unsigned long long* w, int m,
                               unsigned long long* tile) {
  const int S = m < kTileWords ? m : kTileWords;
  const int tid = threadIdx.x;
  // On each tile, for the sizes lo .. hi: the strides below S, from the
  // larger down to 1.
  auto tiles = [&](int lo, int hi) {
    for (int t = 0; t < m; t += S) {
      for (int i = tid; i < S; i += kThreads) tile[i] = w[t + i];
      __syncthreads();
      for (int size = lo; size <= hi; size <<= 1) {
        for (int stride = min(size, S) >> 1; stride > 0; stride >>= 1) {
          for (int q = tid; q < (S >> 1); q += kThreads) {
            const int a_at = 2 * q - (q & (stride - 1));
            const int b_at = a_at + stride;
            const unsigned long long a = tile[a_at], b = tile[b_at];
            const bool desc = ((t + a_at) & size) == 0;
            if (desc ? a < b : a > b) {
              tile[a_at] = b;
              tile[b_at] = a;
            }
          }
          __syncthreads();
        }
      }
      for (int i = tid; i < S; i += kThreads) w[t + i] = tile[i];
      __syncthreads();
    }
  };
  tiles(2, S);
  for (int size = 2 * S; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride >= S; stride >>= 1) {
      for (int q = tid; q < (m >> 1); q += kThreads) {
        const int lo = 2 * q - (q & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = w[lo], b = w[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? a < b : a > b) {
          w[lo] = b;
          w[hi] = a;
        }
      }
      __syncthreads();
    }
    tiles(size, size);
  }
}

// The wide branch after pass 3: the k_eff words of row `row` in the
// block's workspace `ws` (m = p.words of them; then the dedup table's 2 *
// m ids and 2 * m ranks) are padded with 0, sorted, decoded and, with
// dedup, kept at each id's least rank; the first k are written.
__device__ void wide_tail(const Params& p, long long row,
                          unsigned long long* ws, unsigned long long* tile,
                          int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = p.words, k_eff = p.k_eff;
  float* out_s = p.out_s + row * (long long)p.k;
  int* out_i = p.out_i + row * (long long)p.k;
  for (int i = k_eff + tid; i < m; i += kThreads) ws[i] = 0ull;
  __syncthreads();
  sort_desc_wide(ws, m, tile);

  // Rank r's score and id (-1 where the score is -inf or the probe id
  // lies outside [0, L)).
  auto decode = [&](int r, float* score) -> int {
    const unsigned long long w = ws[r];
    const int lane_r = (int)(0xffffffffu - (unsigned)w);
    *score = key16_to_f32((unsigned)(w >> 32));
    if (!(*score > -CUDART_INF_F)) return -1;
    const int rank = lane_r / p.cap;
    const long long list = p.probe[row * p.p + rank];
    if (list < 0 || list >= p.l) return -1;
    return p.ids[list * p.cap + (lane_r - rank * p.cap)];
  };

  const bool dedup = p.dedup;
  if (!dedup) {  // k_eff <= k here
    for (int r = tid; r < k_eff; r += kThreads) {
      float s;
      const int id = decode(r, &s);
      out_s[r] = s;
      out_i[r] = id;
    }
    for (int i = k_eff + tid; i < p.k; i += kThreads) {
      out_s[i] = -CUDART_INF_F;
      out_i[i] = -1;
    }
    return;
  }

  unsigned* t_ids = reinterpret_cast<unsigned*>(ws + m);
  int* t_ranks = reinterpret_cast<int*>(t_ids + 2 * m);
  const int slots = 2 * m;
  const unsigned mask = (unsigned)slots - 1u;
  const int shift = 32 - (__ffs(slots) - 1);
  for (int i = tid; i < slots; i += kThreads) {
    t_ids[i] = kFree;
    t_ranks[i] = k_eff;
  }
  __syncthreads();
  for (int r = tid; r < k_eff; r += kThreads) {
    float s;
    const int id = decode(r, &s);
    if (id >= 0) table_insert(t_ids, t_ranks, mask, shift, id, r);
  }
  __syncthreads();
  // The kept ranks in rank order, kThreads ranks a step (one each).
  int base = 0;
  for (int r0 = 0; r0 < k_eff && base < p.k; r0 += kThreads) {
    const int r = r0 + tid;
    float s = 0.0f;
    int id = -1;
    if (r < k_eff) id = decode(r, &s);
    const int kept =
        id >= 0 && table_rank(t_ids, t_ranks, mask, shift, id) == r;
    const int incl = warp_inclusive(kept);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    const int w_kept = lane < kWarps ? warp_sums[lane] : 0;
    const int pos =
        base + __reduce_add_sync(kFull, lane < warp ? w_kept : 0) + incl - kept;
    const int total = __reduce_add_sync(kFull, w_kept);
    __syncthreads();  // warp_sums is read before the next step writes it
    if (kept && pos < p.k) {
      out_s[pos] = s;
      out_i[pos] = id;
    }
    base += total;
  }
  for (int i = min(base, p.k) + tid; i < p.k; i += kThreads) {
    out_s[i] = -CUDART_INF_F;
    out_i[i] = -1;
  }
}

// One row: passes 1-3, then (Wide) wide_tail, else the sort, decode and
// dedup on chip.
template <bool Wide>
__device__ __forceinline__ void select_row(const Params& p, long long row,
                                           unsigned char* smem) {
  unsigned short* keys = reinterpret_cast<unsigned short*>(smem);
  unsigned* table_ids = reinterpret_cast<unsigned*>(smem);  // after pass 3
  int* table_ranks = reinterpret_cast<int*>(table_ids + 2 * p.words);
  unsigned* words = reinterpret_cast<unsigned*>(smem + p.area);
  int* lanes = reinterpret_cast<int*>(words + p.words);
  int* hist = reinterpret_cast<int*>(words);  // passes 1-2
  __shared__ int warp_sums[2 * kWarps];
  __shared__ int sel[4];  // bin, above, bin, above

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, k_eff = p.k_eff;
  // Wide: this block's workspace.
  unsigned long long* ws =
      Wide ? p.work + (long long)blockIdx.x * 3 * p.words : nullptr;
  const float* x = p.flat + row * (long long)n;
  float* out_s = p.out_s + row * (long long)p.k;
  int* out_i = p.out_i + row * (long long)p.k;
  // Lane j sits at position j + off; the groups of four positions are
  // 16-byte aligned in device memory; [g_lo, g_hi) are the full ones.
  const int off = (int)((reinterpret_cast<uintptr_t>(x) >> 2) & 3u);
  const float4* xa = reinterpret_cast<const float4*>(x - off);
  const int g_lo = off ? 1 : 0, g_hi = (off + n) >> 2;

  // Pass 1: the row from device memory once; keys to shared memory (on
  // chip) and the histogram of their high bytes.
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  __syncthreads();
  {
    const int full = max(0, g_hi - g_lo);
    const int steps = (full + kThreads * kLoads - 1) / (kThreads * kLoads);
    float4 cur[kLoads] = {}, nxt[kLoads] = {};
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int g = g_lo + u * kThreads + tid;
      if (g < g_hi) cur[u] = __ldcs(xa + g);
    }
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int g = g_lo + ((s + 1) * kLoads + u) * kThreads + tid;
          if (g < g_hi) nxt[u] = __ldcs(xa + g);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int g = g_lo + (s * kLoads + u) * kThreads + tid;
        const bool in = g < g_hi;
        unsigned k4[4] = {key16(cur[u].x), key16(cur[u].y),
                          key16(cur[u].z), key16(cur[u].w)};
        if (in && p.on_chip) {
          reinterpret_cast<uint2*>(keys)[g] =
              make_uint2(k4[0] | (k4[1] << 16), k4[2] | (k4[3] << 16));
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) add_to_bin(hist, in ? k4[c] >> 8 : kBins);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) cur[u] = nxt[u];
    }
  }
  // The head and tail groups, when partial, lane by lane.
  if (tid < 8) {
    const int head = off ? 0 : -1;
    int tail = ((off + n) & 3) ? g_hi : -1;
    if (tail == head) tail = -1;
    const int g = tid < 4 ? head : tail;
    const int j = 4 * g + (tid & 3) - off;
    if (g >= 0 && j >= 0 && j < n) {
      const unsigned key = key16(x[j]);
      if (p.on_chip) keys[j + off] = (unsigned short)key;
      atomicAdd(&hist[key >> 8], 1);
    }
  }
  __syncthreads();
  if (warp == 0) find_bin(hist, k_eff, &sel[0], &sel[1]);
  __syncthreads();
  const unsigned high = (unsigned)sel[0];
  const int need = k_eff - sel[1];  // lanes to take within the high bin
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  __syncthreads();

  // Passes 2 and 3 walk the row in chunks of kThreads * kSteps steps of
  // eight positions, thread t the chunk's steps t * kSteps onward: lane
  // order is chunk, thread, then position order.
  const int steps8 = (off + n + 7) >> 3;
  const int chunks = (steps8 + kThreads * kSteps - 1) / (kThreads * kSteps);
  unsigned k[8 * kSteps];
  // The keys of this thread's steps in chunk ch; bit c of the result
  // marks k[c] as a lane of the row.
  auto chunk_keys = [&](int ch) {
    unsigned valid = 0u;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int s = (ch * kThreads + tid) * kSteps + j;
      if (s < steps8) {
        valid |= keys8(p, keys, x, xa, off, s, k + 8 * j) << (8 * j);
      }
    }
    return valid;
  };

  // Pass 2: histogram of the low bytes within the high bin (plain
  // integer atomics: the low bytes spread).
  for (int ch = 0; ch < chunks; ++ch) {
    const unsigned valid = chunk_keys(ch);
#pragma unroll
    for (int c = 0; c < 8 * kSteps; ++c) {
      if (((valid >> c) & 1u) && (k[c] >> 8) == high) {
        atomicAdd(&hist[k[c] & 0xffu], 1);
      }
    }
  }
  __syncthreads();
  if (warp == 0) find_bin(hist, need, &sel[2], &sel[3]);
  __syncthreads();
  const unsigned thresh = (high << 8) | (unsigned)sel[2];
  const int ties = need - sel[3];  // lanes at the threshold to take

  // Pass 3: the taken lanes to their slots in lane order, as words
  // key << 16 | (0xffff - slot), the lane beside.  A chunk's one block
  // scan of (lanes at the threshold, lanes above it), packed in the low
  // and high 16 bits, gives each thread its first tie rank and its first
  // slot; the warps' sums alternate between two buffers, so one barrier
  // a chunk suffices.
  {
    int tie_base = 0, slot_base = 0;  // over the chunks before
    for (int ch = 0; ch < chunks; ++ch) {
      const unsigned valid = chunk_keys(ch);
      unsigned eqm = 0u, take = 0u;
#pragma unroll
      for (int c = 0; c < 8 * kSteps; ++c) {
        eqm |= (unsigned)(k[c] == thresh) << c;
        take |= (unsigned)(k[c] > thresh) << c;
      }
      eqm &= valid;
      take &= valid;
      const unsigned mine = __popc(eqm) | (__popc(take) << 16);
      const unsigned incl = (unsigned)warp_inclusive((int)mine);
      int* sums = warp_sums + (ch & 1) * kWarps;
      if (lane == 31) sums[warp] = (int)incl;
      __syncthreads();
      const int w_sum = lane < kWarps ? sums[lane] : 0;
      const unsigned before = (unsigned)__reduce_add_sync(
          kFull, lane < warp ? w_sum : 0) + incl - mine;
      const unsigned total = (unsigned)__reduce_add_sync(kFull, w_sum);
      const int eq_before = (int)(before & 0xffffu);
      // This thread's ties of rank below `ties`: its first ones.
      const int rank = tie_base + eq_before;
      int can = min(max(ties - rank, 0), __popc(eqm));
      for (unsigned m = eqm; can > 0; --can, m &= m - 1u) take |= m & (0u - m);
      int at = slot_base + (int)(before >> 16) +
               min(max(ties - tie_base, 0), eq_before);
      // The warp's taken lanes are written by its lanes, one each: lane j
      // finds the thread that owns the warp's j-th taken lane (a binary
      // search over the prefix counts) and that lane in its mask.
      const int tc = __popc(take);
      const int tc_incl = warp_inclusive(tc);
      const int warp_taken = __shfl_sync(kFull, tc_incl, 31);
      for (int j0 = 0; j0 < warp_taken; j0 += 32) {
        const int j = j0 + lane;
        int owner = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(kFull, tc_incl, owner + step - 1) <= j) owner += step;
        }
        const int r = j - __shfl_sync(kFull, tc_incl - tc, owner);
        unsigned m = __shfl_sync(kFull, take, owner);
        const int slot = __shfl_sync(kFull, at, owner) + r;
        for (int q = 0; q < r && j < warp_taken; ++q) m &= m - 1u;
        const int c = __ffs(m) - 1;  // the owner's r-th taken position
        unsigned key = 0u;
        if (!p.on_chip) {  // the owner's keys, one shuffle each
#pragma unroll
          for (int cc = 0; cc < 8 * kSteps; ++cc) {
            const unsigned v = __shfl_sync(kFull, k[cc], owner);
            if (cc == c) key = v;
          }
        }
        if (j < warp_taken) {
          const int pos = 8 * (ch * kThreads + warp * 32 + owner) * kSteps + c;
          if (p.on_chip) key = keys[pos];
          if (Wide) {
            ws[slot] = ((unsigned long long)key << 32) |
                       (0xffffffffu - (unsigned)(pos - off));
          } else {
            words[slot] = (key << 16) | (0xffffu - (unsigned)slot);
            lanes[slot] = pos - off;
          }
        }
      }
      const int eq_total = (int)(total & 0xffffu);
      slot_base += (int)(total >> 16) + min(max(ties - tie_base, 0), eq_total);
      tie_base += eq_total;
    }
  }
  // The key area is free from here: the dedup table's slots start empty.
  __syncthreads();
  if (Wide) {
    wide_tail(p, row, ws, reinterpret_cast<unsigned long long*>(smem),
              warp_sums);
    return;
  }
  if (p.dedup) {
    for (int i = tid; i < 2 * p.words; i += kThreads) {
      table_ids[i] = kFree;
      table_ranks[i] = k_eff;
    }
  }
  for (int i = k_eff + tid; i < p.words; i += kThreads) words[i] = 0u;

  // Canonical order: key descending, slot (lane) ascending.  Pad words 0
  // sort last: a real word's low half is at least 0xffff - 4095.
  if (p.words <= 1024) {
    sort_desc<2>(words, p.words);
  } else if (p.words == 2048) {
    sort_desc<4>(words, p.words);
  } else {
    sort_desc<8>(words, p.words);
  }

  // Each thread decodes a run of ranks [r0, r0 + cnt): score from the
  // key, id through the probe table (the loads of the run in flight
  // together).
  const int per = (k_eff + kThreads - 1) / kThreads;  // <= 8
  const int r0 = min(k_eff, tid * per);
  const int cnt = min(k_eff, r0 + per) - r0;
  int lane_of[8];
  long long list[8];
  int ident[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    list[c] = -1;
    if (c < cnt) {
      const unsigned w = words[r0 + c];
      lane_of[c] = lanes[0xffffu - (w & 0xffffu)];
      if (key16_to_f32(w >> 16) > -CUDART_INF_F) {
        list[c] = p.probe[row * p.p + lane_of[c] / p.cap];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    ident[c] = -1;
    if (c < cnt && list[c] >= 0 && list[c] < p.l) {
      const int rank = lane_of[c] / p.cap;
      ident[c] = p.ids[list[c] * p.cap + (lane_of[c] - rank * p.cap)];
    }
  }

  if (!p.dedup) {  // k_eff <= k here
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < cnt) {
        out_s[r0 + c] = key16_to_f32(words[r0 + c] >> 16);
        out_i[r0 + c] = ident[c];
      }
    }
    for (int i = k_eff + tid; i < p.k; i += kThreads) {
      out_s[i] = -CUDART_INF_F;
      out_i[i] = -1;
    }
    return;
  }

  // Dedup: each valid id's least rank through the table (emptied after
  // pass 3), then the kept ranks in rank order.
  const int slots = 2 * p.words;
  const unsigned mask = (unsigned)slots - 1u;
  const int shift = 32 - (__ffs(slots) - 1);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (c < cnt && ident[c] >= 0) {
      table_insert(table_ids, table_ranks, mask, shift, ident[c], r0 + c);
    }
  }
  __syncthreads();
  unsigned kept = 0u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (c < cnt && ident[c] >= 0 &&
        table_rank(table_ids, table_ranks, mask, shift, ident[c]) == r0 + c) {
      kept |= 1u << c;
    }
  }
  const int kc = __popc(kept);
  const int incl = warp_inclusive(kc);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  const int w_kept = lane < kWarps ? warp_sums[lane] : 0;
  int pos = __reduce_add_sync(kFull, lane < warp ? w_kept : 0) + incl - kc;
  const int total = min(__reduce_add_sync(kFull, w_kept), p.k);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if ((kept >> c) & 1u) {
      if (pos < p.k) {
        out_s[pos] = key16_to_f32(words[r0 + c] >> 16);
        out_i[pos] = ident[c];
      }
      ++pos;
    }
  }
  for (int i = total + tid; i < p.k; i += kThreads) {
    out_s[i] = -CUDART_INF_F;
    out_i[i] = -1;
  }
}

// One block a row, k_eff <= kMaxSel.
__global__ void __launch_bounds__(kThreads, 2)
    canonical_select_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  select_row<false>(p, blockIdx.x, smem);
}

// The wide branch: a persistent grid, block g on rows g, g + gridDim.x,
// ... with workspace g.
__global__ void __launch_bounds__(kThreads, 2)
    canonical_select_wide_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (long long row = blockIdx.x; row < p.b; row += gridDim.x) {
    select_row<true>(p, row, smem);
    __syncthreads();  // the row's last reads of shared memory are done
  }
}

// The kernels' static shared memory fits kStaticReserve (checked once).
cudaError_t check_static() {
  static cudaError_t checked = cudaErrorNotReady;
  if (checked == cudaErrorNotReady) {
    checked = cudaSuccess;
    for (const void* kernel : {(const void*)canonical_select_kernel,
                               (const void*)canonical_select_wide_kernel}) {
      cudaFuncAttributes attr;
      const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) {
        checked = err;
      } else if (attr.sharedSizeBytes > kStaticReserve) {
        checked = cudaErrorInvalidConfiguration;
      }
    }
  }
  return checked;
}

// The parameters of a launch (k_eff clipped to n, the plan's fields).
Params make_params(const float* flat, const long long* probe, const int* ids,
                   float* out_s, int* out_i, unsigned long long* work, int b,
                   int n_probe, int n_list, int cap, int k_eff, int k,
                   int dedup, const Plan& pl) {
  Params p;
  p.flat = flat;
  p.probe = probe;
  p.ids = ids;
  p.out_s = out_s;
  p.out_i = out_i;
  p.work = work;
  p.n = n_probe * cap;
  p.p = n_probe;
  p.l = n_list;
  p.cap = cap;
  p.k_eff = k_eff;
  p.k = k;
  p.words = pl.words;
  p.dedup = dedup ? 1 : 0;
  p.on_chip = pl.on_chip;
  p.area = pl.area;
  p.b = b;
  return p;
}

}  // namespace

extern "C" {

// Launches the select on `stream`; returns cudaGetLastError() (0 = ok).
// Device pointers to contiguous arrays: flat float32 (b, n_probe * cap);
// probe int64 (b, n_probe); ids int32 (n_list, cap); out_s float32 and
// out_i int32 (b, k).  k_sel is clipped to n; dedup as the caller decides
// (redundant storage, or k_eff > k; without it k_eff must be <= k).
// k_eff above kMaxSel takes canonical_select_wide.
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
  cudaError_t err = check_static();
  if (err != cudaSuccess) return (int)err;
  const Plan pl = make_plan(n, k_eff);
  const Params p = make_params(flat, probe, ids, out_s, out_i, nullptr, b,
                               n_probe, n_list, cap, k_eff, k, dedup, pl);
  err = cudaFuncSetAttribute(canonical_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (err != cudaSuccess) return (int)err;
  canonical_select_kernel<<<b, kThreads, pl.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The wide branch (kMaxSel < k_eff): as canonical_select, with `work` a
// device array of grid * 3 * m int64 (m the least power of two >= k_eff)
// and `grid` (1 to b) the blocks that walk the rows.
int canonical_select_wide(const float* flat, const long long* probe,
                          const int* ids, float* out_s, int* out_i,
                          long long* work, int b, int n_probe, int n_list,
                          int cap, int k_sel, int k, int dedup, int grid,
                          void* stream) {
  if (b < 0 || n_probe < 1 || n_list < 1 || cap < 1 || k_sel < 1 || k < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)n_probe * cap;
  if (n > kMaxLanes) return (int)cudaErrorInvalidValue;
  const int k_eff = (int)(k_sel < n ? k_sel : n);
  if (k_eff <= kMaxSel || (!dedup && k_eff > k)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || k == 0) return (int)cudaSuccess;
  if (grid < 1 || grid > b || work == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = check_static();
  if (err != cudaSuccess) return (int)err;
  const Plan pl = make_plan(n, k_eff);
  const Params p = make_params(
      flat, probe, ids, out_s, out_i,
      reinterpret_cast<unsigned long long*>(work), b, n_probe, n_list, cap,
      k_eff, k, dedup, pl);
  err = cudaFuncSetAttribute(canonical_select_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (err != cudaSuccess) return (int)err;
  canonical_select_wide_kernel<<<grid, kThreads, pl.smem,
                                 (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The launch plan of a row of n lanes with k_sel selected: the branch (0
// = the long-row branch, 1 = keys on chip, 2 = wide, 3 = wide without the
// keys on chip), the dynamic shared memory and the blocks an SM the card
// runs (cudaOccupancy...).  0 = ok.
int canonical_select_plan(long long n, int k_sel, int* branch, int* smem,
                          int* blocks_per_sm) {
  if (n < 1 || n > kMaxLanes || k_sel < 1) return (int)cudaErrorInvalidValue;
  const int k_eff = (int)(k_sel < n ? k_sel : n);
  cudaError_t err = check_static();
  if (err != cudaSuccess) return (int)err;
  const Plan pl = make_plan(n, k_eff);
  const bool wide = k_eff > kMaxSel;
  *branch = wide ? (pl.on_chip ? 2 : 3) : pl.on_chip;
  *smem = pl.smem;
  const void* kernel = wide ? (const void*)canonical_select_wide_kernel
                            : (const void*)canonical_select_kernel;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, pl.smem);
}

const char* canonical_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
