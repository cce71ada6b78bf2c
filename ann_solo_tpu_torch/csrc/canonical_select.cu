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
// the wide branch.  What bounded its first design on this card: one
// block a row (2 of the 132 SMs busy on two rows of 2^22 lanes), a
// bitonic network of m log^2 m / 2 compare-exchanges over 64-bit words
// in device memory (about 10^9 a row at 2^22), and a tail that decoded
// each rank twice.  The design now, a sequence of launches on the
// caller's stream over a workspace the wrapper allocates (a group of
// rows at a time, at most WORK_BUDGET bytes; wide_layout):
//   * the selection: with enough rows to fill the SMs, one block a row
//     runs passes 1-3 of select_row (the same code, the keys on chip
//     while they fit); with too few, each row is split into tiles of at
//     least kMinTile lanes over about two blocks an SM (wide_tiles), and
//     passes 1-3 run per (row, tile): the tiles' high-byte histograms
//     add into the row's with integer atomics, each tile keeps its
//     low-byte histogram within the high bin and its count above it, a
//     scan kernel finds the threshold key and gives each tile its first
//     tie rank and first slot, and pass 3 compacts each tile in lane
//     order from there.  Either way the row's k_eff items, key << 32 |
//     lane, leave pass 3 in lane order;
//   * the canonical order (key descending, lane ascending) is then a
//     stable sort by the 16-bit key alone: two counting passes of an
//     8-bit digit, the low byte first, each bucket order descending.  A
//     pass counts each item tile's digits (kItemTile items a block),
//     scans the counts over the tiles (each tile's start in each
//     bucket), and scatters: each warp takes a segment of the tile and
//     places a round of 32 items, in index order, at its digit's running
//     start for the warp plus its rank among the round's lanes of that
//     digit (__match_any_sync), so equal digits keep their order.  About
//     4 x 8 bytes read and 2 x 8 written an item, against m log^2 m / 2
//     compare-exchanges;
//   * the tail: each rank's id is decoded once (probe table, then the
//     list's ids) and stored in place of its lane; with dedup it goes,
//     with its rank, into the row's table of the least power of two >=
//     2 k_eff 64-bit slots (id << 32 | rank: a CAS claims a slot, a 64-bit
//     atomicMin keeps the least rank, whatever order the blocks run in);
//     a rank whose id's least rank is another is dropped, the tiles' kept
//     counts are scanned, and one block scan a tile places the kept ranks;
//   * up to kRowTail (8,192) lanes selected, the open level's 4,096
//     candidates x2, the sort and the tail run on one block of
//     kTailThreads (1,024) a row in shared memory instead
//     (wide_row_tail_kernel): the row's items read
//     once, the two digit passes between two arrays of shared memory, a
//     rank a thread a wave decoded, and the table (32-bit ids and ranks:
//     shared memory's 64-bit atomics are emulated) filled wave by wave in
//     rank order, so that a CAS claim alone settles an id but where a
//     lower rank of the same wave claims it too (atomicMin).
// Shared memory of the one-block-a-row kernel: the keys while they fit
// (2 * round_up(n + 3, 8) bytes) + 1 KB for the histogram, else 1 KB; at
// the bench's 49,152 lanes 99,344 B, 2 blocks an SM.  The row tail: 128
// KB dynamic (two arrays of 8,192 items, then the table) and 33 KB
// static, one block of 32 warps an SM.  The other kernels use static
// shared memory only (at most 17 KB).  Its bound is the row's f32 bytes
// read once and the outputs written.  What stands between: at the bench's
// rows pass 1 and the row tail's shared-memory work (the digit passes'
// __match_any_sync, which more warps did not speed up and ballots slowed,
// the decode's two dependent loads, the table's atomics); on rows split
// over many blocks, the digit passes and the table's atomics over device
// memory.
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
constexpr int kHistBytes = kBins * 4;  // the wide branch's histogram area
constexpr int kMaxLanes = 1 << 22;
constexpr int kMinWords = 128;         // the word area holds the histogram
constexpr int kSmemLimit = 232448;     // shared memory a block may use
constexpr int kStaticReserve = 256;    // the kernel's static shared memory
constexpr int kLoads = 2;              // float4 loads a thread a step
constexpr int kSteps = 2;              // steps of 8 keys a thread a chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFree = 0xffffffffu;  // an empty dedup slot
// The wide branch: lanes of the least tile of a row split over blocks,
// items a block in the sort and the tail, ints of a lane tile's entry in a
// row's meta area, the meta area's fields (the row's high-byte histogram;
// the threshold key, its ties and the kept ranks; the sort's bucket
// starts; then the lane tiles and the item tiles), an empty table slot.
constexpr int kMinTile = 4096;
constexpr int kItemTile = 4096;
constexpr int kRowTail = 8192;  // items of a row sorted on one block
constexpr int kTailThreads = 1024;  // that block's threads
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kTileInts = 260;
constexpr int kMetaHist = 0;
constexpr int kMetaMisc = 256;
constexpr int kMetaStart = 272;
constexpr int kMetaTiles = 528;
constexpr unsigned long long kEmpty = ~0ull;

struct Params {
  const float* flat;        // (b, n) scores, -inf masked
  const long long* probe;   // (b, p) probe list ids
  const int* ids;           // (l, cap) library ids, -1 empty
  float* out_s;             // (b, k)
  int* out_i;               // (b, k)
  unsigned long long* work;  // wide: the items, `words` a row
  int n, p, l, cap, k_eff, k, words, dedup, on_chip;
  int area;                 // bytes of the key / table area
  int b;                    // rows
};

// The wide branch's workspace of a group of rows: all their items
// (Params::work, `words` = round_up(k_eff, 2) a row), then their tables
// (`slots` a row), then their meta areas (`meta_ints` a row); the split of
// a row's lanes into tiles of `tile_lanes` (`tiles` blocks a row; 1: the
// fused kernel) and of its items into `itiles` tiles of kItemTile.
struct WideArgs {
  unsigned long long* table;
  int* meta;
  long long slots, meta_ints;
  int tiles, tile_lanes, tiles_max, itiles;
};

// A row's share of the workspace (ops/select_cuda.py::wide_row_words
// computes the same): items, table and meta, in 8-byte words.
struct WideLayout {
  int kw, tiles_max, itiles;
  long long slots, meta_ints, row_words;
};

inline WideLayout wide_layout(long long n, int k_eff) {
  WideLayout w;
  w.kw = (k_eff + 1) & ~1;
  w.slots = 1;
  while (w.slots < 2LL * k_eff) w.slots <<= 1;
  w.tiles_max = (int)((n + kMinTile - 1) / kMinTile);
  w.itiles = (k_eff + kItemTile - 1) / kItemTile;
  w.meta_ints = kMetaTiles + (long long)kTileInts * w.tiles_max +
                (long long)kBins * w.itiles + ((w.itiles + 3) & ~3);
  w.row_words = w.kw + w.slots + w.meta_ints / 2;
  return w;
}

// A group of `rows` rows of n lanes over the card's `sms`: tiles a row so
// that about two blocks an SM run the lane passes (1 while the rows fill
// them; at most tiles_max, tiles of at least kMinTile lanes), each tile a
// multiple of 8 lanes (ops/select_cuda.py::wide_grid computes the same).
inline void wide_tiles(int rows, long long n, int sms, int tiles_max,
                       int* tiles, int* tile_lanes) {
  long long t = (2LL * sms + rows - 1) / rows;
  if (t > tiles_max) t = tiles_max;
  if (t < 1) t = 1;
  *tile_lanes = (int)(((n + t - 1) / t + 7) / 8 * 8);
  *tiles = (int)((n + *tile_lanes - 1) / *tile_lanes);
}

// The branch and the dynamic shared memory of a row of n lanes with
// k_eff selected (ops/select_cuda.py::plan computes the same).
struct Plan {
  int on_chip, words, area, smem;
};

// The wide branch (k_eff > kMaxSel), one block a row: the key area holds
// the keys (on chip) or nothing; the histogram lies after it.
inline Plan make_plan(long long n, int k_eff) {
  int m = 1;
  while (m < k_eff) m <<= 1;
  Plan pl;
  pl.words = m < kMinWords ? kMinWords : m;
  const long long keys = 2 * ((n + 3 + 7) / 8 * 8);
  if (k_eff > kMaxSel) {
    pl.on_chip = keys + kHistBytes + kStaticReserve <= kSmemLimit;
    pl.area = (int)(pl.on_chip ? keys : 0);
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

// The wide branch's dedup table: one 64-bit slot an id, id << 32 | its
// least rank (kEmpty when free); `shift` = 32 - log2(slots).  A CAS
// claims a free slot, atomicMin keeps the least rank of an id already
// there: the table's contents do not depend on the order of the inserts
// (which slot an id takes may, which no lookup sees).
__device__ __forceinline__ void table_insert64(unsigned long long* t,
                                               unsigned mask, int shift,
                                               int id, int rank) {
  const unsigned long long word =
      ((unsigned long long)(unsigned)id << 32) | (unsigned)rank;
  unsigned h = slot_of(id, shift);
  while (true) {
    const unsigned long long cur = atomicCAS(&t[h], kEmpty, word);
    if (cur == kEmpty) return;
    if ((unsigned)(cur >> 32) == (unsigned)id) {
      atomicMin(&t[h], word);
      return;
    }
    h = (h + 1) & mask;
  }
}

// The least rank of an id that was inserted.
__device__ __forceinline__ int table_rank64(const unsigned long long* t,
                                            unsigned mask, int shift,
                                            int id) {
  unsigned h = slot_of(id, shift);
  while (true) {
    const unsigned long long cur = t[h];
    if ((unsigned)(cur >> 32) == (unsigned)id) return (int)(unsigned)cur;
    h = (h + 1) & mask;
  }
}

// In place, the exclusive prefix sums of a[0], a[stride], ... (count
// values) in index order; returns their total.  Every thread of the block
// calls it; `sums` is kWarps values of shared memory.
template <typename T>
__device__ T block_scan(T* a, int count, int stride, T* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T carry = 0;
  for (int base = 0; base < count; base += kThreads) {
    const int i = base + threadIdx.x;
    const T v = i < count ? a[(long long)i * stride] : T(0);
    T incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    T before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const T s = sums[w];
      if (w < warp) before += s;
      total += s;
    }
    if (i < count) a[(long long)i * stride] = carry + before + incl - v;
    carry += total;
    __syncthreads();
  }
  return carry;
}

// Over `rows` rows of kBins counts (row r at c + r * stride, 16-byte
// aligned): col[d] = the sum of column d; with `prefix`, each count becomes
// the sum of its column in the rows above it.  Warp w takes a run of rows,
// lane j the columns 8j .. 8j + 7; `wsum` is kWarps * kBins ints of shared
// memory.  Every thread of the block calls it; it ends with a barrier.
__device__ void column_scan(int* c, int rows, int stride, bool prefix,
                            int* col, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (rows + kWarps - 1) / kWarps;
  const int r0 = min(rows, warp * per), r1 = min(rows, r0 + per);
  int s[8] = {};
  for (int r = r0; r < r1; ++r) {
    const int4* at = reinterpret_cast<const int4*>(c + (long long)r * stride +
                                                   8 * lane);
    const int4 x = at[0], y = at[1];
    s[0] += x.x; s[1] += x.y; s[2] += x.z; s[3] += x.w;
    s[4] += y.x; s[5] += y.y; s[6] += y.z; s[7] += y.w;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) wsum[warp * kBins + 8 * lane + j] = s[j];
  __syncthreads();
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = wsum[w * kBins + d];
      wsum[w * kBins + d] = run;
      run += v;
    }
    col[d] = run;
  }
  __syncthreads();
  if (prefix) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = wsum[warp * kBins + 8 * lane + j];
    for (int r = r0; r < r1; ++r) {
      int4* at = reinterpret_cast<int4*>(c + (long long)r * stride + 8 * lane);
      const int4 x = at[0], y = at[1];
      at[0] = make_int4(s[0], s[1], s[2], s[3]);
      at[1] = make_int4(s[4], s[5], s[6], s[7]);
      s[0] += x.x; s[1] += x.y; s[2] += x.z; s[3] += x.w;
      s[4] += y.x; s[5] += y.y; s[6] += y.z; s[7] += y.w;
    }
    __syncthreads();
  }
}

// One row: passes 1-3, then (Wide) nothing more (the wide branch's sort
// and tail are kernels of their own), else the sort, decode and dedup on
// chip.
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
  // Wide: the row's items.
  unsigned long long* ws = Wide ? p.work + row * p.words : nullptr;
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
  // key << 16 | (0xffff - slot), the lane beside (Wide: key << 32 |
  // lane).  A chunk's one block scan of (lanes at the threshold, lanes
  // above it), packed in the low and high 16 bits, gives each thread its
  // first tie rank and its first slot; the warps' sums alternate between
  // two buffers, so one barrier a chunk suffices.
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
            ws[slot] = ((unsigned long long)key << 32) | (unsigned)(pos - off);
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
  if (Wide) return;
  // The key area is free from here: the dedup table's slots start empty.
  __syncthreads();
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

// The wide branch, a row on one block: passes 1-3 of select_row, the
// taken lanes to the row's items in lane order.
__global__ void __launch_bounds__(kThreads, 2)
    canonical_select_wide_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  select_row<true>(p, blockIdx.x, smem);
}

// ---- The wide branch's kernels over (row, tile) blocks ----

__device__ __forceinline__ int* row_meta(const WideArgs& w, long long row) {
  return w.meta + row * w.meta_ints;
}

// Lane tile t's entry: its low-byte histogram (kBins ints), then an int64
// (its count of lanes above the high bin, then its packed first tie rank
// and count of lanes above the threshold), its first tie rank and its
// first slot.
__device__ __forceinline__ int* lane_tile(int* meta, int t) {
  return meta + kMetaTiles + t * kTileInts;
}

// The item tiles' digit counts (itiles x kBins), then their kept counts.
__device__ __forceinline__ int* item_counts(const WideArgs& w, int* meta) {
  return meta + kMetaTiles + kTileInts * w.tiles_max;
}

__device__ __forceinline__ int* item_kept(const WideArgs& w, int* meta) {
  return item_counts(w, meta) + kBins * w.itiles;
}

// Block (row, lane tile) of a split row: its lanes [lo, hi).
struct LaneTile {
  long long row;
  int t, lo, hi;
};

__device__ __forceinline__ LaneTile lane_span(const Params& p,
                                              const WideArgs& w) {
  LaneTile s;
  s.row = blockIdx.x / w.tiles;
  s.t = (int)(blockIdx.x % w.tiles);
  s.lo = s.t * w.tile_lanes;
  s.hi = min(p.n, s.lo + w.tile_lanes);
  return s;
}

// Pass 1 of a split row: the tile's high-byte histogram, added to the
// row's (integer atomics: the sum does not depend on the blocks' order).
__global__ void __launch_bounds__(kThreads)
    wide_pass1_kernel(const Params p, const WideArgs w) {
  __shared__ int hist[kBins];
  const LaneTile s = lane_span(p, w);
  const float* x = p.flat + s.row * (long long)p.n;
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
  __syncthreads();
  for (int j0 = s.lo; j0 < s.hi; j0 += kThreads * kLoads * 2) {
    float v[kLoads * 2];
#pragma unroll
    for (int u = 0; u < kLoads * 2; ++u) {
      const int j = j0 + u * kThreads + threadIdx.x;
      v[u] = j < s.hi ? x[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads * 2; ++u) {
      const int j = j0 + u * kThreads + threadIdx.x;
      add_to_bin(hist, j < s.hi ? key16(v[u]) >> 8 : kBins);
    }
  }
  __syncthreads();
  int* meta = row_meta(w, s.row);
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    if (hist[i]) atomicAdd(&meta[kMetaHist + i], hist[i]);
  }
}

// Pass 2 of a split row: the high bin from the row's histogram, then the
// tile's low-byte histogram within it and its count of lanes above it.
__global__ void __launch_bounds__(kThreads)
    wide_pass2_kernel(const Params p, const WideArgs w) {
  __shared__ int hist[kBins];
  __shared__ int sel[2];
  __shared__ int above[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const LaneTile s = lane_span(p, w);
  const float* x = p.flat + s.row * (long long)p.n;
  int* meta = row_meta(w, s.row);
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  if (warp == 0) find_bin(meta + kMetaHist, p.k_eff, &sel[0], &sel[1]);
  __syncthreads();
  const unsigned high = (unsigned)sel[0];
  int count = 0;
  for (int j0 = s.lo; j0 < s.hi; j0 += kThreads * kLoads * 2) {
    float v[kLoads * 2];
#pragma unroll
    for (int u = 0; u < kLoads * 2; ++u) {
      const int j = j0 + u * kThreads + tid;
      v[u] = j < s.hi ? x[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads * 2; ++u) {
      const unsigned key = key16(v[u]);
      if (j0 + u * kThreads + tid < s.hi) {
        if ((key >> 8) == high) {
          atomicAdd(&hist[key & 0xffu], 1);
        } else if ((key >> 8) > high) {
          ++count;
        }
      }
    }
  }
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) above[warp] = count;
  __syncthreads();
  int* tile = lane_tile(meta, s.t);
  for (int i = tid; i < kBins; i += kThreads) tile[i] = hist[i];
  if (tid == 0) {
    long long sum = 0;
    for (int i = 0; i < kWarps; ++i) sum += above[i];
    *reinterpret_cast<long long*>(tile + kBins) = sum;
  }
}

// A split row's threshold key and ties (meta misc 0 and 1), and each
// tile's first tie rank and first slot: the tiles' counts at and above
// the threshold, scanned in tile order.  One block a row.
__global__ void __launch_bounds__(kThreads)
    wide_select_scan_kernel(const Params p, const WideArgs w) {
  __shared__ int col[kBins];
  __shared__ int wsum[kWarps * kBins];
  __shared__ long long sums[kWarps];
  __shared__ int sel[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* meta = row_meta(w, blockIdx.x);
  if (warp == 0) find_bin(meta + kMetaHist, p.k_eff, &sel[0], &sel[1]);
  column_scan(meta + kMetaTiles, w.tiles, kTileInts, false, col, wsum);
  const int need = p.k_eff - sel[1];
  if (warp == 0) find_bin(col, need, &sel[2], &sel[3]);
  __syncthreads();
  const int low = sel[2];
  const int ties = need - sel[3];
  // Each tile's lanes at the threshold and above it, packed in an int64.
  for (int t = warp; t < w.tiles; t += kWarps) {
    int* tile = lane_tile(meta, t);
    long long* packed = reinterpret_cast<long long*>(tile + kBins);
    int gt = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * lane + j > low) gt += tile[8 * lane + j];
    }
    gt = __reduce_add_sync(kFull, gt);
    const long long above_bin = *packed;
    const int eq = tile[low];
    __syncwarp();
    if (lane == 0) *packed = (long long)eq | ((above_bin + gt) << 32);
  }
  __syncthreads();
  block_scan<long long>(
      reinterpret_cast<long long*>(meta + kMetaTiles + kBins), w.tiles,
      kTileInts / 2, sums);
  for (int t = tid; t < w.tiles; t += kThreads) {
    int* tile = lane_tile(meta, t);
    const long long v = *reinterpret_cast<long long*>(tile + kBins);
    const int eq_before = (int)(v & 0xffffffffLL);
    tile[kBins + 2] = eq_before;
    tile[kBins + 3] = (int)(v >> 32) + min(ties, eq_before);
  }
  if (tid == 0) {
    meta[kMetaMisc] = (sel[0] << 8) | low;
    meta[kMetaMisc + 1] = ties;
  }
}

// Pass 3 of a split row: the tile's taken lanes to their slots in lane
// order, from the tile's first tie rank and first slot, as words key << 32
// | lane.  Rounds of 8 consecutive lanes a thread; one packed block scan
// of (lanes at the threshold, lanes above it) a round, as in select_row.
__global__ void __launch_bounds__(kThreads)
    wide_pass3_kernel(const Params p, const WideArgs w) {
  constexpr int E = 8;
  __shared__ int warp_sums[2 * kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const LaneTile s = lane_span(p, w);
  const float* x = p.flat + s.row * (long long)p.n;
  int* meta = row_meta(w, s.row);
  const int* tile = lane_tile(meta, s.t);
  const unsigned thresh = (unsigned)meta[kMetaMisc];
  const int ties = meta[kMetaMisc + 1];
  int tie_base = tile[kBins + 2], slot_base = tile[kBins + 3];
  unsigned long long* items = p.work + s.row * p.words;
  int r = 0;
  for (int j0 = s.lo; j0 < s.hi; j0 += kThreads * E, ++r) {
    const int j = j0 + tid * E;
    unsigned k[E];
    unsigned eqm = 0u, take = 0u;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool in = j + e < s.hi;
      k[e] = in ? key16(x[j + e]) : 0u;
      eqm |= (unsigned)(in && k[e] == thresh) << e;
      take |= (unsigned)(in && k[e] > thresh) << e;
    }
    const unsigned mine = __popc(eqm) | (__popc(take) << 16);
    const unsigned incl = (unsigned)warp_inclusive((int)mine);
    int* sums = warp_sums + (r & 1) * kWarps;
    if (lane == 31) sums[warp] = (int)incl;
    __syncthreads();
    const int w_sum = lane < kWarps ? sums[lane] : 0;
    const unsigned before = (unsigned)__reduce_add_sync(
        kFull, lane < warp ? w_sum : 0) + incl - mine;
    const unsigned total = (unsigned)__reduce_add_sync(kFull, w_sum);
    const int eq_before = (int)(before & 0xffffu);
    int can = min(max(ties - (tie_base + eq_before), 0), __popc(eqm));
    for (unsigned m = eqm; can > 0; --can, m &= m - 1u) take |= m & (0u - m);
    int at = slot_base + (int)(before >> 16) +
             min(max(ties - tie_base, 0), eq_before);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((take >> e) & 1u) {
        items[at++] = ((unsigned long long)k[e] << 32) | (unsigned)(j + e);
      }
    }
    const int eq_total = (int)(total & 0xffffu);
    slot_base += (int)(total >> 16) + min(max(ties - tie_base, 0), eq_total);
    tie_base += eq_total;
  }
}

// Block (row, item tile): its items [lo, hi) of the row's k_eff.
struct ItemTile {
  long long row;
  int t, lo, hi;
};

__device__ __forceinline__ ItemTile item_span(const Params& p,
                                              const WideArgs& w) {
  ItemTile s;
  s.row = blockIdx.x / w.itiles;
  s.t = (int)(blockIdx.x % w.itiles);
  s.lo = s.t * kItemTile;
  s.hi = min(p.k_eff, s.lo + kItemTile);
  return s;
}

// The digit of an item in the sort's pass at `shift` (0: the key's low
// byte, 8: its high byte).
__device__ __forceinline__ unsigned item_digit(unsigned long long v,
                                               int shift) {
  return (unsigned)(v >> (32 + shift)) & 0xffu;
}

// The sort's count: the item tile's histogram of the digit.
__global__ void __launch_bounds__(kThreads)
    wide_count_kernel(const Params p, const WideArgs w,
                      const unsigned long long* src, long long stride,
                      int shift) {
  constexpr int U = kItemTile / kThreads;
  __shared__ int hist[kBins];
  const ItemTile s = item_span(p, w);
  const unsigned long long* a = src + s.row * stride;
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
  unsigned long long v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = s.lo + u * kThreads + threadIdx.x;
    v[u] = i < s.hi ? a[i] : 0ull;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = s.lo + u * kThreads + threadIdx.x;
    add_to_bin(hist, i < s.hi ? item_digit(v[u], shift) : kBins);
  }
  __syncthreads();
  int* cnt = item_counts(w, row_meta(w, s.row)) + s.t * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads) cnt[i] = hist[i];
}

// The sort's scan, one block a row: each item tile's count of a digit
// becomes the count of that digit in the tiles before it, and the
// buckets' starts, digit 255 first (descending), go to meta's starts.
__global__ void __launch_bounds__(kThreads)
    wide_sort_scan_kernel(const Params p, const WideArgs w) {
  __shared__ int col[kBins];
  __shared__ int wsum[kWarps * kBins];
  int* meta = row_meta(w, blockIdx.x);
  column_scan(item_counts(w, meta), w.itiles, kBins, true, col, wsum);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = col[kBins - 1 - 8 * lane - j];
      sum += c[j];
    }
    int run = warp_inclusive(sum) - sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      meta[kMetaStart + kBins - 1 - 8 * lane - j] = run;
      run += c[j];
    }
  }
}

// Stable ranking by digit for a block: warp w takes the contiguous
// segment [s0, s1) of the block's items.  warp_counts: the warp's digit
// counts into `mine` (its row of wc, kBins ints, zeroed here).
// warp_starts: each warp's start in each bucket, from the buckets' starts
// for the block (start[d]): wc[w][d] = start[d] + the counts of d in the
// warps before w.  warp_place: the segment's items to their places, 32 a
// round in index order: the warp's running start of the item's digit plus
// its rank among the round's lanes of that digit (__match_any_sync).
// Equal digits keep their index order: the sort is stable.
__device__ __forceinline__ void warp_counts(const unsigned long long* src,
                                            int s0, int s1, int shift,
                                            int* mine) {
  const int lane = threadIdx.x & 31;
  for (int d = lane; d < kBins; d += 32) mine[d] = 0;
  __syncwarp();
  for (int i0 = s0; i0 < s1; i0 += 32) {
    const int i = i0 + lane;
    const unsigned d = i < s1 ? item_digit(src[i], shift) : kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < kBins && lane == __ffs(peers) - 1) mine[d] += __popc(peers);
    __syncwarp();
  }
}

template <int W = kWarps>
__device__ __forceinline__ void warp_starts(int* wc, const int* start) {
  for (int d = threadIdx.x; d < kBins; d += 32 * W) {
    int run = start[d];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int v = wc[w * kBins + d];
      wc[w * kBins + d] = run;
      run += v;
    }
  }
}

__device__ __forceinline__ void warp_place(const unsigned long long* src,
                                           int s0, int s1, int shift,
                                           int* mine,
                                           unsigned long long* dst) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int i0 = s0; i0 < s1; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < s1;
    const unsigned long long v = in ? src[i] : 0ull;
    const unsigned d = in ? item_digit(v, shift) : kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    if (in) dst[mine[d] + __popc(peers & lower)] = v;
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) mine[d] += __popc(peers);
    __syncwarp();
  }
}

// The items [s0, s1) of this warp's segment when a block's `count` items
// are split over its W warps (segments of whole rounds of 32).
template <int W = kWarps>
__device__ __forceinline__ void warp_segment(int count, int* s0, int* s1) {
  const int seg = (count + 32 * W - 1) / (32 * W) * 32;
  *s0 = min(count, (int)(threadIdx.x >> 5) * seg);
  *s1 = min(count, *s0 + seg);
}

// The sort's scatter: the item tile's items to their buckets, stable, from
// the tile's start in each bucket.
__global__ void __launch_bounds__(kThreads)
    wide_scatter_kernel(const Params p, const WideArgs w,
                        const unsigned long long* src, long long src_stride,
                        unsigned long long* dst, long long dst_stride,
                        int shift) {
  __shared__ int start[kBins];
  __shared__ int wc[kWarps * kBins];
  const ItemTile s = item_span(p, w);
  int* meta = row_meta(w, s.row);
  const int* cnt = item_counts(w, meta) + s.t * kBins;
  const unsigned long long* a = src + s.row * src_stride + s.lo;
  int s0, s1;
  warp_segment(s.hi - s.lo, &s0, &s1);
  int* mine = wc + (threadIdx.x >> 5) * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    start[i] = meta[kMetaStart + i] + cnt[i];
  }
  warp_counts(a, s0, s1, shift, mine);
  __syncthreads();
  warp_starts(wc, start);
  __syncthreads();
  warp_place(a, s0, s1, shift, mine, dst + s.row * dst_stride);
}

// The wide branch's sort and tail of a row of at most kRowTail items on one
// block, in shared memory: the items read once, the two digit passes
// between two arrays of shared memory (warp_counts, the buckets' starts,
// warp_starts, warp_place), the decode of a rank a thread a wave, and the
// dedup through a table of the least power of two >= 2 k_eff slots in the
// arrays' place (a 32-bit id and rank each; shared memory's 64-bit atomics
// are emulated): a CAS claims, and only a lower rank of the same wave
// needs an atomicMin; a block scan a wave places the kept ranks.
__global__ void __launch_bounds__(kTailThreads, 1)
    wide_row_tail_kernel(const Params p, const WideArgs w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int start[kBins];
  __shared__ int wc[kTailWarps * kBins];
  __shared__ int warp_sums[kTailWarps];
  constexpr int U = kRowTail / kTailThreads;
  unsigned long long* a = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* bb = a + kRowTail;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const int k_eff = p.k_eff;
  const unsigned long long* items = p.work + row * p.words;
  for (int i = tid; i < k_eff; i += kTailThreads) a[i] = items[i];
  int s0, s1;
  warp_segment<kTailWarps>(k_eff, &s0, &s1);
  int* mine = wc + warp * kBins;
  __syncthreads();
  for (int shift = 0; shift <= 8; shift += 8) {
    const unsigned long long* src = shift ? bb : a;
    unsigned long long* dst = shift ? a : bb;
    warp_counts(src, s0, s1, shift, mine);
    __syncthreads();
    for (int d = tid; d < kBins; d += kTailThreads) {
      int total = 0;
#pragma unroll
      for (int q = 0; q < kTailWarps; ++q) total += wc[q * kBins + d];
      start[d] = total;
    }
    __syncthreads();
    if (warp == 0) {  // the buckets' starts, digit 255 first
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = start[kBins - 1 - 8 * lane - j];
        sum += c[j];
      }
      int run = warp_inclusive(sum) - sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        start[kBins - 1 - 8 * lane - j] = run;
        run += c[j];
      }
    }
    __syncthreads();
    warp_starts<kTailWarps>(wc, start);
    __syncthreads();
    warp_place(src, s0, s1, shift, mine, dst);
    __syncthreads();
  }

  // Each thread decodes the ranks tid, tid + kTailThreads, ... (wave c
  // holds ranks c * kTailThreads onward): the key's score, the id through
  // the probe table.
  unsigned key[U];
  long long list[U];
  int id[U];
#pragma unroll
  for (int c = 0; c < U; ++c) {
    const int r = c * kTailThreads + tid;
    list[c] = -1;
    key[c] = 0u;
    id[c] = 0;
    if (r < k_eff) {
      const unsigned long long v = a[r];
      key[c] = (unsigned)(v >> 32);
      id[c] = (int)(unsigned)v;  // the lane until the id replaces it
      if (key16_to_f32(key[c]) > -CUDART_INF_F) {
        list[c] = p.probe[row * p.p + id[c] / p.cap];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < U; ++c) {
    const int lane_c = id[c];
    id[c] = -1;
    if (list[c] >= 0 && list[c] < p.l) {
      id[c] = p.ids[list[c] * p.cap + lane_c % p.cap];
    }
  }
  float* out_s = p.out_s + row * (long long)p.k;
  int* out_i = p.out_i + row * (long long)p.k;
  if (!p.dedup) {  // k_eff <= k here
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const int r = c * kTailThreads + tid;
      if (r < k_eff) {
        out_s[r] = key16_to_f32(key[c]);
        out_i[r] = id[c];
      }
    }
    for (int i = k_eff + tid; i < p.k; i += kTailThreads) {
      out_s[i] = -CUDART_INF_F;
      out_i[i] = -1;
    }
    return;
  }
  // The dedup: a table of the least power of two >= 2 k_eff slots, a
  // 32-bit id and rank each, in the arrays' place.  Wave by wave, in rank
  // order, a CAS claims an id's slot and the claimer stores its rank; an
  // id already there from an earlier wave has a lower rank, and one from
  // this wave lowers the slot's rank with atomicMin where its own is
  // lower (after a barrier, so the claimer's store is seen).  A rank is
  // kept where its slot keeps it: each id's least rank, whatever order
  // the threads run in.
  int slots = 1;
  while (slots < 2 * k_eff) slots <<= 1;
  const unsigned mask = (unsigned)slots - 1u;
  const int hash_shift = 32 - (__ffs(slots) - 1);
  unsigned* t_ids = reinterpret_cast<unsigned*>(smem);
  int* t_ranks = reinterpret_cast<int*>(t_ids + slots);
  __syncthreads();  // every rank is read: the table takes the arrays
  for (int i = tid; i < slots; i += kTailThreads) t_ids[i] = kFree;
  __syncthreads();
  int slot[U];
#pragma unroll
  for (int c = 0; c < U; ++c) {
    const int r = c * kTailThreads + tid;
    bool lost = false;
    slot[c] = -1;
    if (id[c] >= 0) {
      unsigned h = slot_of(id[c], hash_shift);
      while (true) {
        const unsigned cur = atomicCAS(&t_ids[h], kFree, (unsigned)id[c]);
        if (cur == kFree) {
          t_ranks[h] = r;
          break;
        }
        if (cur == (unsigned)id[c]) {
          lost = true;
          break;
        }
        h = (h + 1) & mask;
      }
      slot[c] = (int)h;
    }
    __syncthreads();
    if (lost && r < t_ranks[slot[c]]) atomicMin(&t_ranks[slot[c]], r);
  }
  __syncthreads();
  // The kept ranks to their places, wave by wave: a block scan of the
  // wave's kept flags after the kept ranks of the waves before.
  int base = 0;
#pragma unroll
  for (int c = 0; c < U; ++c) {
    const int r = c * kTailThreads + tid;
    const int kept = slot[c] >= 0 && t_ranks[slot[c]] == r;
    const int incl = warp_inclusive(kept);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    const int w_kept = lane < kTailWarps ? warp_sums[lane] : 0;
    const int pos = base + __reduce_add_sync(kFull, lane < warp ? w_kept : 0)
                    + incl - kept;
    base += __reduce_add_sync(kFull, w_kept);
    __syncthreads();  // warp_sums is read before the next wave writes it
    if (kept && pos < p.k) {
      out_s[pos] = key16_to_f32(key[c]);
      out_i[pos] = id[c];
    }
  }
  for (int i = min(base, p.k) + tid; i < p.k; i += kTailThreads) {
    out_s[i] = -CUDART_INF_F;
    out_i[i] = -1;
  }
}

// The written outputs of a row from position `start` to k: -inf and -1,
// the row's item tiles in turn.
__device__ __forceinline__ void pad_row(const Params& p, const WideArgs& w,
                                        const ItemTile& s, int start) {
  float* out_s = p.out_s + s.row * (long long)p.k;
  int* out_i = p.out_i + s.row * (long long)p.k;
  for (long long i0 = start + (long long)s.t * kItemTile; i0 < p.k;
       i0 += (long long)w.itiles * kItemTile) {
    const long long i1 = min(i0 + kItemTile, (long long)p.k);
    for (long long i = i0 + threadIdx.x; i < i1; i += kThreads) {
      out_s[i] = -CUDART_INF_F;
      out_i[i] = -1;
    }
  }
}

// The decode of the sorted items, a rank a thread at a time: its score
// from the key, its id through the probe table (-1 where the score is
// -inf or the probe id lies outside [0, L)).  Without dedup (k_eff <= k)
// the outputs; with it, the id in place of the lane and the id's least
// rank into the row's table.
__global__ void __launch_bounds__(kThreads)
    wide_decode_kernel(const Params p, const WideArgs w) {
  constexpr int U = kItemTile / kThreads;
  const int tid = threadIdx.x;
  const ItemTile s = item_span(p, w);
  unsigned long long* items = p.work + s.row * p.words;
  unsigned long long v[U];
  long long list[U];
  int id[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = s.lo + u * kThreads + tid;
    v[u] = i < s.hi ? items[i] : 0ull;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    list[u] = -1;
    if (s.lo + u * kThreads + tid < s.hi &&
        key16_to_f32((unsigned)(v[u] >> 32)) > -CUDART_INF_F) {
      const int lane_u = (int)(unsigned)v[u];
      list[u] = p.probe[s.row * p.p + lane_u / p.cap];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    id[u] = -1;
    if (list[u] >= 0 && list[u] < p.l) {
      const int lane_u = (int)(unsigned)v[u];
      id[u] = p.ids[list[u] * p.cap + lane_u % p.cap];
    }
  }
  if (!p.dedup) {
    float* out_s = p.out_s + s.row * (long long)p.k;
    int* out_i = p.out_i + s.row * (long long)p.k;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = s.lo + u * kThreads + tid;
      if (i < s.hi) {
        out_s[i] = key16_to_f32((unsigned)(v[u] >> 32));
        out_i[i] = id[u];
      }
    }
    pad_row(p, w, s, p.k_eff);
    return;
  }
  unsigned long long* table = w.table + s.row * w.slots;
  const unsigned mask = (unsigned)(w.slots - 1);
  const int shift = 32 - (__ffsll(w.slots) - 1);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = s.lo + u * kThreads + tid;
    if (i < s.hi) {
      items[i] = (v[u] & 0xffffffff00000000ull) | (unsigned)id[u];
      if (id[u] >= 0) table_insert64(table, mask, shift, id[u], i);
    }
  }
}

// The dedup's verdicts: a rank is kept where its id's least rank is it; a
// dropped rank's id becomes -1.  The item tile's kept count to meta.
__global__ void __launch_bounds__(kThreads)
    wide_keep_kernel(const Params p, const WideArgs w) {
  constexpr int U = kItemTile / kThreads;
  __shared__ int kept_w[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ItemTile s = item_span(p, w);
  unsigned long long* items = p.work + s.row * p.words;
  const unsigned long long* table = w.table + s.row * w.slots;
  const unsigned mask = (unsigned)(w.slots - 1);
  const int shift = 32 - (__ffsll(w.slots) - 1);
  int count = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = s.lo + u * kThreads + tid;
    if (i < s.hi) {
      const unsigned long long v = items[i];
      const int id = (int)(unsigned)v;
      if (id >= 0) {
        if (table_rank64(table, mask, shift, id) == i) {
          ++count;
        } else {
          items[i] = v | 0xffffffffull;
        }
      }
    }
  }
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) kept_w[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int q = 0; q < kWarps; ++q) sum += kept_w[q];
    item_kept(w, row_meta(w, s.row))[s.t] = sum;
  }
}

// The item tiles' first output positions (the kept ranks before each) and
// the row's kept total (meta misc 2).  One block a row.
__global__ void __launch_bounds__(kThreads)
    wide_keep_scan_kernel(const Params p, const WideArgs w) {
  __shared__ int sums[kWarps];
  int* meta = row_meta(w, blockIdx.x);
  const int total = block_scan<int>(item_kept(w, meta), w.itiles, 1, sums);
  if (threadIdx.x == 0) meta[kMetaMisc + 2] = total;
}

// The kept ranks to their output positions: a run of U ranks a thread,
// one block scan of the kept counts in rank order; then the padding.
__global__ void __launch_bounds__(kThreads)
    wide_place_kernel(const Params p, const WideArgs w) {
  constexpr int U = kItemTile / kThreads;
  __shared__ int warp_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ItemTile s = item_span(p, w);
  int* meta = row_meta(w, s.row);
  const int base = item_kept(w, meta)[s.t];
  if (base < p.k) {
    const unsigned long long* items = p.work + s.row * p.words;
    float* out_s = p.out_s + s.row * (long long)p.k;
    int* out_i = p.out_i + s.row * (long long)p.k;
    const int i0 = s.lo + tid * U;
    unsigned long long v[U];
    unsigned kept = 0u;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = i0 + u < s.hi ? items[i0 + u] : ~0ull;
      kept |= (unsigned)((int)(unsigned)v[u] >= 0) << u;
    }
    const int kc = __popc(kept);
    const int incl = warp_inclusive(kc);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    const int w_kept = lane < kWarps ? warp_sums[lane] : 0;
    int pos = base + __reduce_add_sync(kFull, lane < warp ? w_kept : 0) +
              incl - kc;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if ((kept >> u) & 1u) {
        if (pos < p.k) {
          out_s[pos] = key16_to_f32((unsigned)(v[u] >> 32));
          out_i[pos] = (int)(unsigned)v[u];
        }
        ++pos;
      }
    }
  }
  pad_row(p, w, s, min(meta[kMetaMisc + 2], p.k));
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
// device array of grid rows' workspace (grid * wide_layout(n,
// k_eff).row_words int64, ops/select_cuda.py::wide_row_words) and `grid`
// (1 to b) the rows a group: the groups run one after another, each a
// sequence of launches on `stream`.
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
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const Plan pl = make_plan(n, k_eff);
  const WideLayout lay = wide_layout(n, k_eff);
  err = cudaFuncSetAttribute(canonical_select_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wide_row_tail_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             16 * kRowTail);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* ws = reinterpret_cast<unsigned long long*>(work);
  for (int row0 = 0; row0 < b; row0 += grid) {
    const int rows = b - row0 < grid ? b - row0 : grid;
    Params q = make_params(flat + row0 * n, probe + (long long)row0 * n_probe,
                           ids, out_s + (long long)row0 * k,
                           out_i + (long long)row0 * k, ws, rows, n_probe,
                           n_list, cap, k_eff, k, dedup, pl);
    q.words = lay.kw;
    WideArgs w;
    w.table = ws + (long long)rows * lay.kw;
    w.meta = reinterpret_cast<int*>(w.table + rows * lay.slots);
    w.slots = lay.slots;
    w.meta_ints = lay.meta_ints;
    w.tiles_max = lay.tiles_max;
    w.itiles = lay.itiles;
    wide_tiles(rows, n, sms, lay.tiles_max, &w.tiles, &w.tile_lanes);
    const int lane_blocks = rows * w.tiles, item_blocks = rows * w.itiles;
    if (w.tiles == 1) {
      canonical_select_wide_kernel<<<rows, kThreads, pl.smem, st>>>(q);
    } else {
      err = cudaMemsetAsync(w.meta, 0, 4 * rows * lay.meta_ints, st);
      if (err != cudaSuccess) return (int)err;
      wide_pass1_kernel<<<lane_blocks, kThreads, 0, st>>>(q, w);
      wide_pass2_kernel<<<lane_blocks, kThreads, 0, st>>>(q, w);
      wide_select_scan_kernel<<<rows, kThreads, 0, st>>>(q, w);
      wide_pass3_kernel<<<lane_blocks, kThreads, 0, st>>>(q, w);
    }
    if (k_eff <= kRowTail) {
      wide_row_tail_kernel<<<rows, kTailThreads, 16 * kRowTail, st>>>(q,
                                                                        w);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      continue;
    }
    // The canonical order: the low byte's stable pass from the items to
    // the table area, the high byte's back.
    for (int shift = 0; shift <= 8; shift += 8) {
      unsigned long long* src = shift ? w.table : ws;
      unsigned long long* dst = shift ? ws : w.table;
      const long long s_stride = shift ? lay.slots : lay.kw;
      const long long d_stride = shift ? lay.kw : lay.slots;
      wide_count_kernel<<<item_blocks, kThreads, 0, st>>>(q, w, src,
                                                          s_stride, shift);
      wide_sort_scan_kernel<<<rows, kThreads, 0, st>>>(q, w);
      wide_scatter_kernel<<<item_blocks, kThreads, 0, st>>>(
          q, w, src, s_stride, dst, d_stride, shift);
    }
    if (dedup) {
      err = cudaMemsetAsync(w.table, 0xff, 8 * rows * lay.slots, st);
      if (err != cudaSuccess) return (int)err;
    }
    wide_decode_kernel<<<item_blocks, kThreads, 0, st>>>(q, w);
    if (dedup) {
      wide_keep_kernel<<<item_blocks, kThreads, 0, st>>>(q, w);
      wide_keep_scan_kernel<<<rows, kThreads, 0, st>>>(q, w);
      wide_place_kernel<<<item_blocks, kThreads, 0, st>>>(q, w);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
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
