// Rescore stage 1 for Hopper (sm_90a): the certificate's upper bounds.
//
// Replaces ann_solo_tpu/ops/rescore.py::_stage1_bounds, which is XLA code
// of the reference (one jitted program, no Pallas kernel).  For every
// (query row b, candidate slot c) of a (B, C) candidate matrix whose id is
// valid (>= 0), the bound is
//
//   ub = (sum_i q_int[i] * vmax[i]) * (1 + 2^-20),
//   vmax[i] = max(+0, max over library peaks j of the candidate of
//                 val_w[j] for every window w with |g_w(i, j)| <= tol),
//   g_0 = q_mz[i] - c_mz[j] (direct), val_0 = c_int[j];
//   g_s = (q_mz[i] - c_mz[j]) - off_s, val_s = mult_s * c_int[j],
//   s = 1..num_shifts-1, only with allow_shift, num_shifts > 1 and
//   |prec_diff| >= tol; prec_diff = (q_prec - c_prec) * chg, chg =
//   num_shifts - 1 with shifts on, else 1; off_s = prec_diff / s;
//   mult_s = 1 if c_ann[j] == s, 2/3 if c_ann[j] == 0, else 0.
//
// An invalid id writes -inf and reads no peaks; an id >= n_lib reads row
// n_lib - 1, as the reference clips it.  Every max propagates NaN, as the
// plain version's torch.maximum and amax do: a NaN window value that
// passes its test (a NaN intensity, or 0 * +-inf in a shift window whose
// multiplier is 0) makes vmax[i], and so the bound, NaN.
//
// Why this design.  The first port compared all Kq x Kc peak pairs once
// per window (7,500 entry-windows a pair at K = 50 and three windows) at
// about a third of the card's FP32 issue rate, so the work itself had to
// shrink.  On the main path every library row is m/z-ascending with a
// zero tail, and at tol 0.02-0.04 Da almost every compare fails:
//
// * the branch rule (ops/stage1_cuda.py::ascending_rows): a row whose
//   intensities are finite and whose peaks of positive intensity are a
//   prefix of it, with finite, non-decreasing m/z, takes the range search
//   over that prefix; any other row the dense loop over all its peaks, as
//   a per-thread branch of the same kernel, so the kernel has no
//   precondition on its caller.  A peak of finite intensity <= 0 never
//   raises a maximum that starts at +0, so leaving it out is exact: the
//   staged m/z of such a peak is +inf, which no test passes (a peak of
//   NaN or -inf intensity, which can make a NaN value, keeps its m/z, and
//   its row takes the dense loop);
// * the range search: for an ascending prefix the peaks that pass window
//   w for query peak i are one contiguous range, because fl(q - c) does
//   not increase as c grows and fl(y - off) does not decrease as y grows,
//   so g_w does not increase along the row and {j : |g_w| <= tol} is
//   {g_w <= tol} (a suffix) within {g_w >= -tol} (a prefix).  The range's
//   first peak is found with the plain version's own f32 expression,
//   never a rearranged one: by a branchless binary search over the row
//   padded with +inf to a power of two (kcp; g = -inf there) for a
//   thread's first query peak, and, while its query peaks ascend, from the
//   previous peak's edge (which cannot lie above the new one) over the
//   next kReach peaks, with the full search for a lane whose edge lies
//   past them.  The exact test at the edge is branchless, and a walk
//   takes the max while it passes; the max is exact in any order.  With
//   q, off or tol non-finite nothing passes, and the exact test finds
//   that too.  About Kq * (log2(kReach) + 1) loads a window instead of
//   Kq * Kc compares;
// * staging with cp.async, overlapped: a block copies the next work
//   item's gathered rows (lanes on consecutive peaks of one row, so a copy
//   reads contiguous bytes, into a raw stage of 33-word rows: no bank
//   conflicts) while it searches the current item, whose rows a staging
//   pass has moved to the searched layout ([peak][slot], 32-word rows: a
//   warp's lanes read their own slot columns, so the search's loads are
//   free of bank conflicts) and checked against the branch rule;
// * a persistent grid (as many blocks as fit on the SMs) whose blocks
//   walk work items of (query row, 32 candidate slots); eight warps scan
//   eight items at once for one with a valid id, with the ids loaded one
//   item ahead, and write -inf for the empty ones, which stage nothing;
// * eight warps on one item: lane = candidate slot, warp = a block of
//   i_tile = ceil(Kq / 8) query peaks (at most kMaxBlock a pass).  At
//   K = 50 a block holds 53,244 bytes of dynamic shared memory, and the
//   launch bounds cap registers at 64 a thread, so four blocks, 32 warps,
//   fit on an SM.
//
// What bounds it now (PERF.md, from builds of this file with parts cut
// out): neither the gather nor the operations the inputs need, but the
// issue of the search's dependent shared-memory loads and the block's
// barriers; the search is about three fifths of the time at the bench's
// shapes.
//
// The sum over i is taken in the order the plain version states, i = 0,
// 1, ..., Kq - 1 from +0.0, one product and one add at a time: each warp
// leaves its block's vmax in shared memory and a bit mask of its terms
// that can differ from +-0 (vmax != 0, or a non-finite q_int); warp 0 then
// adds those terms in i order.  Adding +-0 to a sum that starts at +0
// changes nothing, so the skipped terms are exact.
//
// The wide branch: any Kq and Kc.  Rows padded past 256 peaks
// (kMaxSteps), or rows and query whose staged layout passes the shared
// memory a block may use (at Kc = 300, Kq = 50 already about 273 KB),
// take a second kernel, a warp a (query row, candidate slot) pair.  What
// bounded its first design on this card: each warp re-read its row from
// device memory for the branch rule and then searched it there, a chain
// of ceil(log2(Kc + 1)) dependent L2 loads a window and query peak; a row
// that failed the rule cost every lane Kc x windows loads a query peak;
// and the terms took 32 dependent shuffles a block of query peaks.  The
// design now:
//   * 8 warps a block, each on a contiguous run of pairs (they share
//     their query rows); a warp's next 32 pairs' ids come in one load a
//     lane, and pairs with an invalid id write -inf and stage nothing;
//   * a pair's row is staged in the warp's shared memory by cp.async
//     (m/z, intensity, annotation; 16 bytes a copy where the row is
//     aligned; four words skipped every 32, so that the lanes'
//     binary-lifting probes fall in different banks; kReach words of +inf
//     after the chunk, so that the reach steps need no bound checks), in
//     chunks of at most kWideStage peaks (two blocks an SM at Kc >= 480,
//     three below about 300), double-buffered: the next chunk, or the
//     next pair's row, arrives while the current one is searched;
//   * the branch rule is checked once a stage (ballots and a shuffle a
//     32 peaks) and holds chunk by chunk: where a chunk's positive peaks
//     are a prefix of it with finite, non-decreasing m/z, the passing
//     peaks of each window are one range of that prefix, and the search
//     over it is exact (a peak of intensity <= 0 never raises a maximum;
//     for a row that fits one chunk the rule is the staged branch's);
//   * on such a chunk the lanes take runs of consecutive query peaks (at
//     most kWideR a lane, 32 * kWideR a block): a run's first peak's
//     edges by binary lifting with the plain test, the next ones, while
//     they ascend, from the previous edge over kReach peaks first, as the
//     staged branch does; then the walk.  On any other chunk the lanes
//     take its peaks and each query peak's max is reduced over the lanes.
//     vmax is a running max over the chunks in shared memory (exact in
//     any order);
//   * each block's terms q_int[i] * vmax[i] are added in i order from
//     +0.0, the +-0 ones skipped (a ballot a 32): adding +-0 changes a
//     sum that is never -0 in no way.
// What bounds it now (PERF.md §6): the instructions the search issues at
// Kq = Kc = 300 (two query peaks a lane in flight made it slower, so the
// latency is hidden), the per-pair staging and rule check at Kq = 50.
//
// Arithmetic matches the plain PyTorch version (ops/rescore.py::
// stage1_bounds_plain) bit for bit: IEEE division for prec_diff / s
// (built without fast-math), -fmad=false so that no product is fused into
// an add, the product order q_int * (mult * c_int), and the sequential sum.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kSlots = 32;                 // candidate slots a work item
constexpr int kRawStride = kSlots + 1;     // words a raw peak row
constexpr int kWarps = 8;                  // query blocks a work item
constexpr int kThreads = kSlots * kWarps;  // 256
constexpr int kMaxBlock = 32;              // query peaks a thread a pass
constexpr int kTile = 8;                   // query peaks a dense step
constexpr int kMaxSteps = 8;               // binary search: kcp <= 256
constexpr int kReach = 8;                  // peaks a step from the last edge
constexpr int kMinBlocks = 4;              // launch bounds: <= 64 registers
constexpr size_t kSmemLimit = 232448;      // shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoThirds = (float)(2.0 / 3.0);
constexpr float kInflation = 1.0f + 1.0f / 1048576.0f;  // 1 + 2^-20, exact
// The wide branch: pairs a block (a warp each), query peaks a lane a
// query block at most, peaks a staged chunk at most, and the launch
// bounds' blocks an SM.
constexpr int kWideWarps = 8;
constexpr int kWideR = 8;
constexpr int kWideStage = 480;
constexpr int kWideMinBlocks = 3;

struct Params {
  const float* q_mz;
  const float* q_int;
  const float* q_prec;
  const float* lib_mz;
  const float* lib_int;
  const int* lib_ann;
  const float* lib_prec;
  const long long* cand;
  float* out;
  long long items;  // b * tiles (wide: b * c pairs)
  int c, tiles, kq, kc, kcp, qb, n_lib, n_shift;
  float tol, chg;
};

// Widths: kcp = the row padded to a power of two (the binary search's
// range), qb = query peaks a thread a pass.
struct Widths {
  int kcp, qb;
};

__host__ __device__ inline Widths widths(int kq, int kc) {
  Widths w;
  w.kcp = 1;
  while (w.kcp < kc) w.kcp <<= 1;
  const int qb = (kq + kWarps - 1) / kWarps;
  w.qb = qb < 1 ? 1 : (qb > kMaxBlock ? kMaxBlock : qb);
  return w;
}

// Dynamic shared memory of a block, in 4-byte words: the raw stage (the
// m/z, intensity and annotation of 32 candidate rows, [peak][slot] with
// rows of kRawStride words, and the slots' and the query's precursors);
// the query row twice (m/z and intensity, by the item's parity); and per
// slot the staged m/z (kcp + kReach, +inf past the positive peaks),
// intensity and annotation (kc each), the warps' vmax (8 * qb) and masks
// (8), the row's flag and its precursor difference (1 each) and the
// scan's rows (2 * 8).
__host__ __device__ inline size_t smem_bytes(int kq, int kc) {
  const Widths w = widths(kq, kc);
  return (size_t)4 *
         ((size_t)3 * kc * kRawStride + kSlots + 1 + 4 * (size_t)kq +
          (size_t)kSlots * (w.kcp + kReach + 2 * (size_t)kc +
                            kWarps * (size_t)w.qb +
                            kWarps + 2 + 2 * kWarps));
}

// The wide branch's chunk (peaks staged at once) and a warp's shared
// memory in 4-byte words: two buffers of the chunk's m/z, intensity and
// annotation, and the running vmax of a query block.
__host__ __device__ inline int wide_stage(int kc) {
  return kc < 1 ? 1 : (kc < kWideStage ? kc : kWideStage);
}

// Words of a staged array of the chunk: its peaks and kReach words of
// padding (a multiple of 4), four words skipped every 32 (sw): a multiple
// of 4, so every array starts 16-byte aligned.
__host__ __device__ inline int wide_span(int kc) {
  const int n = (wide_stage(kc) + kReach + 3) & ~3;
  return n + 4 * ((n + 31) / 32);
}

__host__ __device__ inline int wide_warp_words(int kc) {
  return 6 * wide_span(kc) + 32 * kWideR;
}

__host__ __device__ inline size_t wide_smem_bytes(int kc) {
  return (size_t)4 * kWideWarps * wide_warp_words(kc);
}

__device__ __forceinline__ float shift_mult(int ann, int s) {
  return ann == s ? 1.0f : (ann == 0 ? kTwoThirds : 0.0f);
}

__device__ __forceinline__ float window_val(int s, int ann, float x) {
  return s == 0 ? x : shift_mult(ann, s) * x;
}

// max(v, x) as torch.maximum takes it: NaN when either is (fmaxf would
// drop a NaN value).
__device__ __forceinline__ float nan_max(float v, float x) {
  return (x > v || x != x) ? x : v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The library row of a slot of work item `item` (-1: invalid, past C or
// past the last item).
__device__ __forceinline__ int slot_row(const Params& p, long long item,
                                        int lane) {
  if (item >= p.items) return -1;
  const long long b = item / p.tiles;
  const int slot = (int)(item - b * p.tiles) * kSlots + lane;
  if (slot >= p.c) return -1;
  const long long id = p.cand[b * p.c + slot];
  if (id < 0) return -1;
  return id >= p.n_lib ? p.n_lib - 1 : (int)id;
}

// Lower edges of the windows (off[0] = 0: x - 0 is x) for query peak q
// in a column `cm` (stride kSlots) whose positive prefix's m/z ascend and
// whose other entries up to kcp (<= 2^kMaxSteps) are +inf: for each, the number
// of peaks with g = (q - c) - off > tol (false at +inf), or kcp - 1 when
// all of the first kcp - 1 are, in which case none passes.  Branchless:
// the NS + 1 searches are interleaved, one load and one compare each a
// step.
template <int NS>
__device__ __forceinline__ void lower_edges(float q, const float* off,
                                            float tol, const float* cm,
                                            int kcp, int (&at)[NS + 1]) {
#pragma unroll
  for (int w = 0; w <= NS; ++w) at[w] = 0;
#pragma unroll
  for (int t = kMaxSteps - 1; t >= 0; --t) {
    const int step = 1 << t;
    if (step >= kcp) continue;
#pragma unroll
    for (int w = 0; w <= NS; ++w) {
      const float c = cm[(at[w] + step - 1) * kSlots];
      at[w] += (q - c) - off[w] > tol ? step : 0;
    }
  }
}

// The max of window s's values over the peaks from `at` on (below kc)
// while the plain version's test passes.  Past the positive prefix the
// staged m/z is +inf, which passes no test but at tol = +inf, and then the
// value (finite, <= 0: the row's intensities are finite) raises no
// maximum.
__device__ __forceinline__ float walk(float q, float off, float tol, int s,
                                      const float* cm, const float* ci,
                                      const int* ca, int at, int kc, float v) {
  for (int k = at; k < kc; ++k) {
    if (!(fabsf((q - cm[k * kSlots]) - off) <= tol)) break;
    v = nan_max(v, window_val(s, ca[k * kSlots], ci[k * kSlots]));
  }
  return v;
}

// The vmax of each query peak i0..i1-1 of a thread's block over a column
// whose positive peaks are a prefix, ascending, with +inf for the m/z of
// every other entry up to kcp + kReach, handed to `keep(i, v)`.  Per
// window (the direct one, and NS shift windows; NS = 0 in a warp without
// a shifted pair) the lower edge is searched: from 0 over log2(kcp)
// steps (`lower_edges`) for the block's first peak and after any peak
// whose m/z does not ascend (the query row is the same for the whole
// warp, so this branch is uniform); else from the previous peak's edge,
// which cannot lie above the new one, over the next kReach peaks in
// three steps, and from 0 again for a lane whose edge lies past them.
// The plain test at each edge is branchless; a walk runs only from an
// edge that passes (the shift windows only for a shifted pair).
template <int NS, typename Keep>
__device__ __forceinline__ void range_block(const float* qm, int i0, int i1,
                                            const float* off, float tol,
                                            bool shifted, const float* cm,
                                            const float* ci, const int* ca,
                                            int kc, int kcp, Keep keep) {
  int edge[NS + 1];
  float q_prev = CUDART_NAN_F;
  for (int i = i0; i < i1; ++i) {
    const float q = qm[i];
    if (q >= q_prev) {
#pragma unroll
      for (int w = 0; w <= NS; ++w) {
        const float* at = cm + edge[w] * kSlots;
#pragma unroll
        for (int step = kReach / 2; step > 0; step >>= 1) {
          at += (q - at[(step - 1) * kSlots]) - off[w] > tol ? step * kSlots
                                                            : 0;
        }
        edge[w] = (int)(at - cm) / kSlots;
      }
#pragma unroll
      for (int w = 0; w <= NS; ++w) {
        if ((q - cm[edge[w] * kSlots]) - off[w] > tol) {
          int at[1];
          lower_edges<0>(q, off + w, tol, cm, kcp, at);
          edge[w] = at[0];
        }
      }
    } else {
      lower_edges<NS>(q, off, tol, cm, kcp, edge);
    }
    q_prev = q;
    bool hit[NS + 1];
    bool any = false;
#pragma unroll
    for (int w = 0; w <= NS; ++w) {
      hit[w] = (w == 0 || shifted) && edge[w] < kc &&
               fabsf((q - cm[edge[w] * kSlots]) - off[w]) <= tol;
      any = any || hit[w];
    }
    float v = 0.0f;
    if (any) {
#pragma unroll
      for (int w = 0; w <= NS; ++w) {
        if (hit[w]) v = walk(q, off[w], tol, w, cm, ci, ca, edge[w], kc, v);
      }
    }
    keep(i, v);
  }
}

// vmax of a tile of kTile query peaks (NaN past the thread's block: no
// test passes) over any column: every one of its kc peaks against every
// query peak of the tile, the peak's shifted products computed once.  A
// peak of finite intensity <= 0 never raises a maximum that starts at
// +0 (its staged m/z is +inf), so the column needs no compaction.
template <int NS>
__device__ __forceinline__ void dense_vmax(const float (&q)[kTile],
                                           const float* off, float tol,
                                           bool shifted, const float* cm,
                                           const float* ci, const int* ca,
                                           int kc, float (&v)[kTile]) {
#pragma unroll
  for (int u = 0; u < kTile; ++u) v[u] = 0.0f;
  for (int k = 0; k < kc; ++k) {
    const float c = cm[k * kSlots];
    const float x = ci[k * kSlots];
    float ct[NS > 0 ? NS : 1];
    if (NS > 0) {
      const int a = ca[k * kSlots];
#pragma unroll
      for (int w = 1; w <= NS; ++w) ct[w - 1] = shift_mult(a, w) * x;
    }
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const float d = q[u] - c;
      if (fabsf(d) <= tol) v[u] = nan_max(v[u], x);
      if (shifted) {
#pragma unroll
        for (int w = 1; w <= NS; ++w) {
          if (fabsf(d - off[w]) <= tol) v[u] = nan_max(v[u], ct[w - 1]);
        }
      }
    }
  }
}

// Any shift count: the windows one after another, each offset the same
// IEEE quotient prec_diff / s, recomputed.
__device__ float loop_vmax(float q, float pd, int n_shift, float tol,
                           bool shifted, bool fast, const float* cm,
                           const float* ci, const int* ca, int kc, int kcp) {
  float v = 0.0f;
  for (int s = 0; s <= (shifted ? n_shift : 0); ++s) {
    const float off = s == 0 ? 0.0f : pd / (float)s;
    if (fast) {
      int at[1];
      lower_edges<0>(q, &off, tol, cm, kcp, at);
      v = walk(q, off, tol, s, cm, ci, ca, at[0], kc, v);
    } else {
      for (int k = 0; k < kc; ++k) {
        if (fabsf((q - cm[k * kSlots]) - off) <= tol) {
          v = nan_max(v, window_val(s, ca[k * kSlots], ci[k * kSlots]));
        }
      }
    }
  }
  return v;
}

// NS >= 0: the number of shift windows, unrolled; NS < 0: any count
// p.n_shift, in a loop.
template <int NS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stage1_bounds_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ int flags[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kc = p.kc, kcp = p.kcp, qb = p.qb, kq = p.kq;
  const long long stride = gridDim.x;

  // The raw stage, written by cp.async: [peak][slot] m/z, intensity and
  // annotation, then the slots' library precursors and the query's.
  float* raw_mz = smem;
  float* raw_int = raw_mz + kc * kRawStride;
  int* raw_ann = reinterpret_cast<int*>(raw_int + kc * kRawStride);
  float* raw_prec = reinterpret_cast<float*>(raw_ann + kc * kRawStride);
  // The query rows: [2][m/z kq, intensity kq], by the item's parity.
  float* qrows = raw_prec + kSlots + 1;
  // The staged rows that the search reads ([peak][slot]; a thread reads
  // column `lane`), then the per-slot state.
  float* cmz = qrows + 4 * kq;
  float* cint = cmz + (kcp + kReach) * kSlots;
  int* cann = reinterpret_cast<int*>(cint + kc * kSlots);
  float* vmaxes = reinterpret_cast<float*>(cann + kc * kSlots);
  unsigned* masks = reinterpret_cast<unsigned*>(vmaxes + kWarps * qb * kSlots);
  int* bad = reinterpret_cast<int*>(masks + kWarps * kSlots);
  float* pds = reinterpret_cast<float*>(bad + kSlots);
  int* scan_rows = reinterpret_cast<int*>(pds + kSlots);  // [2][8][32]

  // This warp's share of each row for staging and the check.
  const int jper = (kc + kWarps - 1) / kWarps;
  const int j0 = warp * jper;
  const int j1 = min(kc, j0 + jper);

  if (warp == 0) bad[lane] = 0;
  // The padding of the staged m/z past Kc: +inf, for every item.
  for (int k = kc + warp; k < kcp + kReach; k += kWarps) {
    cmz[k * kSlots + lane] = CUDART_INF_F;
  }

  // The scan for work items with a valid id walks the block's items
  // (blockIdx.x, + gridDim.x, ...) eight at a time, one a warp; the ids
  // of its next step are loaded one item ahead (`ahead`), so that their
  // latency hides behind a search.
  long long scan = blockIdx.x;
  int parity = 0;
  int ahead = slot_row(p, scan + warp * stride, lane);
  // The next item with a valid id (p.items if none) and the lane's slot's
  // row in it; an empty item examined on the way gets its -inf row.
  auto pick = [&](int& row) -> long long {
    while (scan < p.items) {
      const long long mine = scan + warp * stride;
      int busy = 0;
      if (mine < p.items) {
        busy = __any_sync(kFull, ahead >= 0);
        if (!busy) {
          const long long b = mine / p.tiles;
          const int slot = (int)(mine - b * p.tiles) * kSlots + lane;
          if (slot < p.c) p.out[b * p.c + slot] = -CUDART_INF_F;
        }
      }
      scan_rows[(parity * kWarps + warp) * kSlots + lane] = ahead;
      if (lane == 0) flags[parity][warp] = busy;
      __syncthreads();
      int first = -1;
#pragma unroll
      for (int w = kWarps - 1; w >= 0; --w) {
        if (flags[parity][w]) first = w;
      }
      const long long base = scan;
      scan = base + (first >= 0 ? first + 1 : kWarps) * stride;
      ahead = slot_row(p, scan + warp * stride, lane);
      if (first >= 0) {
        row = scan_rows[(parity * kWarps + first) * kSlots + lane];
        parity ^= 1;
        return base + first * stride;
      }
      parity ^= 1;
    }
    row = -1;
    return p.items;
  };

  // The copies of an item into the raw stage: warp w takes slots w,
  // w + 8, ... and its lanes consecutive peaks of each row, so an
  // instruction reads one row's contiguous bytes, and the raw stride of 33
  // words keeps these stores free of bank conflicts; the slots'
  // precursors (warp 0), and the query row (warp 1) into `qrows` half
  // `half` and its precursor.  `row` is the lane's own slot's row.
  auto issue = [&](long long item, int row, int half) {
    if (item < p.items) {
      for (int slot = warp; slot < kSlots; slot += kWarps) {
        const int r = __shfl_sync(kFull, row, slot);
        if (r < 0) continue;
        const size_t base = (size_t)r * kc;
        for (int j = lane; j < kc; j += 32) {
          cp_async4(raw_mz + j * kRawStride + slot, p.lib_mz + base + j);
          cp_async4(raw_int + j * kRawStride + slot, p.lib_int + base + j);
          cp_async4(raw_ann + j * kRawStride + slot, p.lib_ann + base + j);
        }
      }
      if (warp == 0 && row >= 0) cp_async4(raw_prec + lane, p.lib_prec + row);
      if (warp == 1) {
        const long long b = item / p.tiles;
        float* q = qrows + half * 2 * kq;
        for (int i = lane; i < kq; i += 32) {
          cp_async4(q + i, p.q_mz + b * kq + i);
          cp_async4(q + kq + i, p.q_int + b * kq + i);
        }
        if (lane == 0) cp_async4(raw_prec + kSlots, p.q_prec + b);
      }
    }
    cp_async_commit();
  };

  int row;
  long long item = pick(row);
  int half = 0;
  issue(item, row, half);

  while (item < p.items) {
    cp_async_wait_all();
    __syncthreads();  // this item's copies are in; the last item is done

    // Staging from the raw stage to the searched layout (lane = slot on
    // both sides: no bank conflicts), with the branch rule checked on
    // neighbouring peaks: the range search when the intensities are
    // finite and the positive peaks are a prefix of the row (none after a
    // peak of intensity <= 0) whose m/z are finite and non-decreasing;
    // any other row: the dense loop.  A peak of finite intensity <= 0 is
    // staged with m/z +inf.
    if (row >= 0 && j0 < j1) {
      float m_prev = 0.0f;
      bool pos_prev = true;
      if (j0 > 0) {
        m_prev = raw_mz[(j0 - 1) * kRawStride + lane];
        pos_prev = raw_int[(j0 - 1) * kRawStride + lane] > 0.0f;
      }
      bool ok = true;
      for (int j = j0; j < j1; ++j) {
        const float m = raw_mz[j * kRawStride + lane];
        const float x = raw_int[j * kRawStride + lane];
        const bool finite = fabsf(x) < CUDART_INF_F;
        cmz[j * kSlots + lane] = x > 0.0f || !finite ? m : CUDART_INF_F;
        cint[j * kSlots + lane] = x;
        cann[j * kSlots + lane] = raw_ann[j * kRawStride + lane];
        const bool here = x > 0.0f;
        ok = ok && finite;
        if (here) {
          ok = ok && pos_prev && fabsf(m) < CUDART_INF_F &&
               (j == 0 || m_prev <= m);
        }
        m_prev = m;
        pos_prev = here;
      }
      if (!ok) bad[lane] = 1;
    }
    if (warp == 0 && row >= 0) {
      pds[lane] = (raw_prec[kSlots] - raw_prec[lane]) * p.chg;
    }
    __syncthreads();  // staged; the raw stage is free

    // The next item's copies overlap this item's search.
    int next_row;
    const long long next = pick(next_row);
    issue(next, next_row, half ^ 1);

    const long long b = item / p.tiles;
    const bool valid = row >= 0;
    float pd = 0.0f;
    bool shifted = false;
    if (valid) {
      pd = pds[lane];
      shifted = p.n_shift > 0 && fabsf(pd) >= p.tol;
    }
    const bool any_shift = __any_sync(kFull, shifted);
    const bool fast = bad[lane] == 0;
    constexpr int kNS = NS > 0 ? NS : 0;
    float off[kNS + 1];
    off[0] = 0.0f;
#pragma unroll
    for (int s = 1; s <= kNS; ++s) off[s] = pd / (float)s;
    const float* qm = qrows + half * 2 * kq;
    const float* qi = qm + kq;
    const float* cm = cmz + lane;
    const float* ci = cint + lane;
    const int* ca = cann + lane;

    float acc = 0.0f;
    for (int pass = 0; pass < kq; pass += kWarps * qb) {
      const int i0 = pass + warp * qb;
      const int i1 = min(kq, i0 + qb);
      unsigned mask = 0;
      // Keeps query peak i's vmax when its term can differ from +-0.
      auto keep_term = [&](int i, float v) {
        if (v != 0.0f || !(fabsf(qi[i]) < CUDART_INF_F)) {
          mask |= 1u << (i - i0);
          vmaxes[(i - pass) * kSlots + lane] = v;
        }
      };
      if (valid) {
        if (NS < 0) {
          for (int i = i0; i < i1; ++i) {
            keep_term(i, loop_vmax(qm[i], pd, p.n_shift, p.tol, shifted,
                                   fast, cm, ci, ca, kc, kcp));
          }
        } else if (fast) {
          if (any_shift) {
            range_block<kNS>(qm, i0, i1, off, p.tol, shifted, cm, ci, ca, kc,
                             kcp, keep_term);
          } else {
            range_block<0>(qm, i0, i1, off, p.tol, false, cm, ci, ca, kc,
                           kcp, keep_term);
          }
        } else {
          for (int t = i0; t < i1; t += kTile) {
            float q[kTile], v[kTile];
#pragma unroll
            for (int u = 0; u < kTile; ++u) {
              q[u] = t + u < i1 ? qm[t + u] : CUDART_NAN_F;
            }
            dense_vmax<kNS>(q, off, p.tol, shifted, cm, ci, ca, kc, v);
#pragma unroll
            for (int u = 0; u < kTile; ++u) {
              if (t + u < i1) keep_term(t + u, v[u]);
            }
          }
        }
      }
      masks[warp * kSlots + lane] = mask;
      __syncthreads();
      if (warp == 0 && valid) {
        // The terms in i order; the skipped ones are +-0.
        for (int g = 0; g < kWarps; ++g) {
          unsigned m = masks[g * kSlots + lane];
          while (m) {
            const int k = __ffs(m) - 1;
            m &= m - 1u;
            const int at = g * qb + k;
            acc = acc + qi[pass + at] * vmaxes[at * kSlots + lane];
          }
        }
      }
      if (pass + kWarps * qb < kq) __syncthreads();
    }
    if (warp == 0) {
      const int slot = (int)(item - b * p.tiles) * kSlots + lane;
      if (slot < p.c) {
        p.out[b * p.c + slot] = valid ? acc * kInflation : -CUDART_INF_F;
      }
      bad[lane] = 0;
    }
    item = next;
    row = next_row;
    half ^= 1;
  }
  cp_async_wait_all();
}

// ---- The wide branch ----

// Where a staged chunk keeps its peak j: four words skipped every 32, so
// that the lanes' probes of a binary lifting (positions step - 1 apart
// from multiples of 2 * step) fall in different banks, and four peaks
// from a multiple of 4 stay one aligned 16-byte word.
__device__ __forceinline__ int sw(int j) { return j + ((j >> 5) << 2); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(at),
               "l"(src)
               : "memory");
}

// The wide walk: as `walk`, over a staged chunk (positions sw(k)).
__device__ __forceinline__ float chunk_walk(float q, float off, float tol,
                                            int s, const float* cm,
                                            const float* ci, const int* ca,
                                            int at, int len, float v) {
  for (int k = at; k < len; ++k) {
    if (!(fabsf((q - cm[sw(k)]) - off) <= tol)) break;
    v = nan_max(v, window_val(s, ca[sw(k)], ci[sw(k)]));
  }
  return v;
}

// The lower edges in `len` staged peaks (m/z `cm`, at sw(j)) whose m/z
// are finite and do not decrease: for each window, from at[w] on, the
// count of peaks with g = (q - c) - off > tol (a prefix of them), by
// binary lifting with the plain test; `top` is the largest power of two
// <= len (0 when len is 0).
template <int NS>
__device__ __forceinline__ void chunk_edges(float q, const float* off,
                                            float tol, const float* cm,
                                            int len, int top,
                                            int (&at)[NS + 1]) {
  for (int step = top; step > 0; step >>= 1) {
#pragma unroll
    for (int w = 0; w <= NS; ++w) {
      if (at[w] + step <= len &&
          (q - cm[sw(at[w] + step - 1)]) - off[w] > tol) {
        at[w] += step;
      }
    }
  }
}

// The vmax of query peak q over the positive prefix of a staged chunk
// (len peaks, finite, non-decreasing m/z; +inf on the kReach words after
// it), from v on: per window (NS shift windows; 0 for a pair without a
// shift) the lower edge, from 0 by binary lifting when the lane's last
// peak does not lie below q (q_prev: NaN for a run's first peak), else
// from the last peak's edge, which cannot lie above the new one, by
// kReach / 2, ... 1 steps (the padding passes no test, so no step leaves
// the prefix) and by lifting from there when the edge lies further; the
// test at the edge, on one load, settles both that and whether the walk
// (while the plain test passes) starts.
template <int NS>
__device__ __forceinline__ float peak_vmax(float q, float& q_prev,
                                           int (&edge)[NS + 1],
                                           const float* off, float tol,
                                           const float* cm, const float* ci,
                                           const int* ca, int len, int top,
                                           float v) {
  if (q >= q_prev) {
#pragma unroll
    for (int step = kReach / 2; step > 0; step >>= 1) {
#pragma unroll
      for (int w = 0; w <= NS; ++w) {
        if ((q - cm[sw(edge[w] + step - 1)]) - off[w] > tol) edge[w] += step;
      }
    }
  } else {
#pragma unroll
    for (int w = 0; w <= NS; ++w) edge[w] = 0;
    chunk_edges<NS>(q, off, tol, cm, len, top, edge);
  }
  q_prev = q;
#pragma unroll
  for (int w = 0; w <= NS; ++w) {
    float g = (q - cm[sw(edge[w])]) - off[w];
    if (g > tol) {
      int at[1] = {edge[w]};
      chunk_edges<0>(q, off + w, tol, cm, len, top, at);
      edge[w] = at[0];
      g = (q - cm[sw(edge[w])]) - off[w];
    }
    if (fabsf(g) <= tol) {
      v = chunk_walk(q, off[w], tol, w, cm, ci, ca, edge[w], len, v);
    }
  }
  return v;
}

// A chunk that fails the branch rule: every peak against every query peak
// of the block, the lanes on the chunk's peaks (consecutive words, no bank
// conflicts), the query peak's max over the lanes (exact in any order)
// into vm[t] (over the chunks: `first` starts it).  NS < 0: any shift
// count, each window's offset the IEEE quotient prec_diff / s.
template <int NS>
__device__ void chunk_dense(const float* qm, int cnt, const float* off,
                            float pd, int n_windows, float tol,
                            const float* cm, const float* ci, const int* ca,
                            int len, bool first, float* vm) {
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < cnt; ++t) {
    const float q = qm[t];
    float x = 0.0f;
    if (NS >= 0) {
      for (int j = lane; j < len; j += 32) {
        const float y = ci[sw(j)];
        const float d = q - cm[sw(j)];
        if (fabsf(d) <= tol) x = nan_max(x, y);
#pragma unroll
        for (int w = 1; w <= NS; ++w) {
          if (fabsf(d - off[w]) <= tol) {
            x = nan_max(x, shift_mult(ca[sw(j)], w) * y);
          }
        }
      }
    } else {
      for (int s = 0; s < n_windows; ++s) {
        const float o = s == 0 ? 0.0f : pd / (float)s;
        for (int j = lane; j < len; j += 32) {
          if (fabsf((q - cm[sw(j)]) - o) <= tol) {
            x = nan_max(x, window_val(s, ca[sw(j)], ci[sw(j)]));
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x = nan_max(x, __shfl_xor_sync(kFull, x, o));
    }
    if (lane == 0) vm[t] = first ? x : nan_max(vm[t], x);
  }
}

// The wide branch: a warp a (query row, candidate slot) pair, 8 warps a
// block, each warp on a contiguous run of the (b, c) pairs, so that its
// pairs share their query rows.  A pair's library row is staged in the
// warp's shared memory by cp.async in chunks of at most kWideStage peaks
// (the whole row when it fits: then once a pair), four words skipped
// every 32 (sw), double-buffered: the next chunk, or the next pair's row,
// arrives while the current one is searched.  A stage is checked against
// the branch rule; a chunk that passes takes the range search over its
// positive prefix (peak_vmax, a run of consecutive query peaks a lane),
// any other the dense loop (chunk_dense, the lanes on the chunk's peaks,
// every max propagating NaN).  The query
// peaks go in blocks of at most 32 * kWideR, their running vmax in the
// warp's shared memory; a block's terms q_int[i] * vmax[i] are added in
// i order from +0.0, the +-0 ones skipped (exact: the sum is never -0).
template <int NS>
__global__ void __launch_bounds__(kWideWarps * 32, kWideMinBlocks)
    stage1_bounds_wide_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stage = wide_stage(p.kc);
  const int span = wide_span(p.kc);  // words of a staged array
  float* base = smem + warp * wide_warp_words(p.kc);
  float* vm = base + 6 * span;
  const long long warps = (long long)gridDim.x * kWideWarps;
  const long long per_warp = (p.items + warps - 1) / warps;
  const long long first = ((long long)blockIdx.x * kWideWarps + warp) *
                          per_warp;
  const long long last = min(p.items, first + per_warp);
  const int chunks = (p.kc + stage - 1) / stage;
  const int qblocks = (p.kq + 32 * kWideR - 1) / (32 * kWideR);
  const int per = qblocks ? (p.kq + qblocks - 1) / qblocks : 0;
  const int r = (per + 31) / 32;
  // Stages a pair: the row once when it fits one chunk, else its chunks
  // again for each query block.
  const int stages =
      qblocks == 0 ? 0 : (chunks <= 1 ? chunks : qblocks * chunks);

  // This warp's pairs, 32 at a time: the ids of the next 32 in one load
  // a lane; the pairs with an invalid id get their -inf on the way.
  long long look = first, window = 0;
  unsigned ready = 0u;
  int ahead = -1;
  auto next_pair = [&](long long& pair, int& row) -> bool {
    while (ready == 0u) {
      if (look >= last) return false;
      const long long mine = look + lane;
      ahead = -1;
      if (mine < last) {
        const long long id = p.cand[mine];
        if (id < 0) {
          p.out[mine] = -CUDART_INF_F;
        } else {
          ahead = id >= p.n_lib ? p.n_lib - 1 : (int)id;
        }
      }
      ready = __ballot_sync(kFull, ahead >= 0);
      window = look;
      look += 32;
    }
    const int t = __ffs(ready) - 1;
    ready &= ready - 1u;
    pair = window + t;
    row = __shfl_sync(kFull, ahead, t);
    return true;
  };
  // The copies of chunk c of library row `row` into buffer `buf`: 16
  // bytes a copy where the chunk starts 16-byte aligned (every row when Kc
  // is a multiple of 4), its last len % 4 peaks and other rows 4 bytes a
  // copy.
  auto issue = [&](int row, int c, int buf) {
    float* mz = base + buf * 3 * span;
    const int j0 = c * stage;
    const int len = min(stage, p.kc - j0);
    const size_t at = (size_t)row * p.kc + j0;
    const int wide = (at & 3) == 0 ? len & ~3 : 0;
    for (int j = 4 * lane; j < wide; j += 128) {
      cp_async16(mz + sw(j), p.lib_mz + at + j);
      cp_async16(mz + span + sw(j), p.lib_int + at + j);
      cp_async16(mz + 2 * span + sw(j), p.lib_ann + at + j);
    }
    for (int j = wide + lane; j < len; j += 32) {
      cp_async4(mz + sw(j), p.lib_mz + at + j);
      cp_async4(mz + span + sw(j), p.lib_int + at + j);
      cp_async4(mz + 2 * span + sw(j), p.lib_ann + at + j);
    }
    cp_async_commit();
  };

  long long pair;
  int row;
  bool have = next_pair(pair, row);
  int buf = 0;
  if (have && stages) issue(row, 0, buf);
  // The pair's precursors, loaded a pair ahead.
  float q_prec = have ? p.q_prec[pair / p.c] : 0.0f;
  float l_prec = have ? p.lib_prec[row] : 0.0f;
  while (have) {
    long long next;
    int next_row;
    const bool next_have = next_pair(next, next_row);
    const float next_q_prec = next_have ? p.q_prec[next / p.c] : 0.0f;
    const float next_l_prec = next_have ? p.lib_prec[next_row] : 0.0f;
    const long long b = pair / p.c;
    const float pd = (q_prec - l_prec) * p.chg;
    const bool shifted = p.n_shift > 0 && fabsf(pd) >= p.tol;
    constexpr int kNS = NS > 0 ? NS : 0;
    float off[kNS + 1];
    off[0] = 0.0f;
#pragma unroll
    for (int s = 1; s <= kNS; ++s) off[s] = pd / (float)s;
    const float* qm_row = p.q_mz + b * p.kq;
    const float* qi_row = p.q_int + b * p.kq;
    float acc = 0.0f;
    int staged = 0, cur = 0, len = 0, top = 0;
    bool fast = true;
    for (int qb = 0; qb < qblocks; ++qb) {
      const int i0 = qb * per;
      const int cnt = min(per, p.kq - i0);
      const int nk = max(0, min(r, cnt - lane * r));
      for (int c = 0; c < chunks; ++c) {
        if (chunks > 1 || qb == 0) {
          // Stage `staged` of the pair has arrived: the branch rule is
          // checked (its intensities finite, its positive peaks a prefix
          // of the chunk, finite and non-decreasing; peak j against peak
          // j - 1, that one from the lane below).  Where it holds the
          // search runs over that prefix (`len` = its P peaks; +inf on the
          // kReach words after it): a peak of finite intensity <= 0 never
          // raises a maximum, so leaving it out is exact.  Else the dense
          // loop over the chunk.  Then the next stage is copied into the
          // other buffer.
          cp_async_wait_all();
          __syncwarp();
          cur = buf;
          float* mz = base + cur * 3 * span;
          const float* xi = mz + span;
          const int n_chunk = min(stage, p.kc - c * stage);
          bool bad = false;
          int positive = 0;
          float m_last = 0.0f;
          for (int j0 = 0; j0 < n_chunk; j0 += 32) {
            const int j = j0 + lane;
            const float m = j < n_chunk ? mz[sw(j)] : 0.0f;
            const float x = j < n_chunk ? xi[sw(j)] : 0.0f;
            const bool here = x > 0.0f;
            const unsigned pos = __ballot_sync(kFull, here);
            float m_prev = __shfl_up_sync(kFull, m, 1);
            if (lane == 0) m_prev = m_last;
            const bool mine = !(fabsf(x) < CUDART_INF_F) ||
                              (here && !(fabsf(m) < CUDART_INF_F &&
                                         (j == 0 || m_prev <= m)));
            // The positives of these 32 peaks are their first ones, and
            // follow nothing but positives.
            bad = bad || (pos & (pos + 1u)) != 0u || (pos && positive < j0) ||
                  __any_sync(kFull, mine);
            positive += __popc(pos);
            m_last = __shfl_sync(kFull, m, 31);
          }
          fast = !bad;
          len = fast ? positive : n_chunk;
          top = len ? 1 << (31 - __clz(len)) : 0;
          if (fast && lane < kReach) mz[sw(len + lane)] = CUDART_INF_F;
          __syncwarp();
          buf ^= 1;
          if (staged + 1 < stages) {
            issue(row, (staged + 1) % chunks, buf);
          } else if (next_have && stages) {
            issue(next_row, 0, buf);
          }
          ++staged;
        }
        const float* cm = base + cur * 3 * span;
        const float* ci = cm + span;
        const int* ca = reinterpret_cast<const int*>(cm + 2 * span);
        if (!fast) {
          if (NS < 0) {
            chunk_dense<-1>(qm_row + i0, cnt, off, pd,
                            shifted ? p.n_shift + 1 : 1, p.tol, cm, ci, ca,
                            len, c == 0, vm);
          } else if (shifted) {
            chunk_dense<kNS>(qm_row + i0, cnt, off, pd, 0, p.tol, cm, ci,
                             ca, len, c == 0, vm);
          } else {
            chunk_dense<0>(qm_row + i0, cnt, off, pd, 0, p.tol, cm, ci, ca,
                           len, c == 0, vm);
          }
        } else if (NS < 0) {
          for (int k = 0; k < nk; ++k) {
            const int t = lane * r + k;
            const float q = qm_row[i0 + t];
            float v = c == 0 ? 0.0f : vm[t];
            for (int s = 0; s <= (shifted ? p.n_shift : 0); ++s) {
              const float o = s == 0 ? 0.0f : pd / (float)s;
              int at[1] = {0};
              chunk_edges<0>(q, &o, p.tol, cm, len, top, at);
              v = chunk_walk(q, o, p.tol, s, cm, ci, ca, at[0], len, v);
            }
            vm[t] = v;
          }
        } else {
          int edge[kNS + 1], edge0[1];
          float q_prev = CUDART_NAN_F;
          for (int k = 0; k < nk; ++k) {
            const int t = lane * r + k;
            const float q = qm_row[i0 + t];
            float v = c == 0 ? 0.0f : vm[t];
            if (shifted) {
              v = peak_vmax<kNS>(q, q_prev, edge, off, p.tol, cm, ci, ca,
                                 len, top, v);
            } else {
              v = peak_vmax<0>(q, q_prev, edge0, off, p.tol, cm, ci, ca, len,
                               top, v);
            }
            vm[t] = v;
          }
        }
        __syncwarp();
      }
      // The block's terms in i order; the +-0 ones change nothing.
      for (int t0 = 0; t0 < cnt; t0 += 32) {
        const int t = t0 + lane;
        const float term = t < cnt ? qi_row[i0 + t] * vm[t] : 0.0f;
        unsigned m = __ballot_sync(kFull, term != 0.0f);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1u;
          acc = acc + __shfl_sync(kFull, term, src);
        }
      }
      __syncwarp();
    }
    if (lane == 0) p.out[pair] = acc * kInflation;
    pair = next;
    row = next_row;
    have = next_have;
    q_prec = next_q_prec;
    l_prec = next_l_prec;
  }
  cp_async_wait_all();
}

// p.items = b * c pairs here.
template <int NS>
cudaError_t launch_wide(const Params& p, cudaStream_t stream) {
  const auto kernel = stage1_bounds_wide_kernel<NS>;
  const size_t smem = wide_smem_bytes(p.kc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kWideWarps * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (p.items + kWideWarps - 1) / kWideWarps;
  const long long fit = (long long)sms * per_sm;
  kernel<<<(int)(need < fit ? need : fit), kWideWarps * 32, smem, stream>>>(
      p);
  return cudaGetLastError();
}

template <int NS>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  const auto kernel = stage1_bounds_kernel<NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)sms * per_sm;
  const int blocks = (int)(p.items < fit ? p.items : fit);
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (the wide branch where the row padded to
// a power of two passes 256 peaks or the shared memory passes
// kSmemLimit); returns cudaGetLastError() (0 = ok).  All pointers are
// device pointers to contiguous arrays: q_mz, q_int (b, kq); q_prec (b,);
// lib_mz, lib_int, lib_ann (n_lib, kc); lib_prec (n_lib,); cand (b, c)
// int64, -1 = invalid; out (b, c).
int stage1_bounds(const float* q_mz, const float* q_int, const float* q_prec,
                  const float* lib_mz, const float* lib_int,
                  const int* lib_ann, const float* lib_prec,
                  const long long* cand, float* out, int b, int c, int kq,
                  int kc, int n_lib, float tol, int num_shifts,
                  int allow_shift, void* stream) {
  if (b < 0 || c < 0 || kq < 0 || kc < 0 || n_lib < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || c == 0) return (int)cudaSuccess;
  const Widths w = widths(kq, kc);
  const size_t smem = smem_bytes(kq, kc);
  Params p;
  p.q_mz = q_mz;
  p.q_int = q_int;
  p.q_prec = q_prec;
  p.lib_mz = lib_mz;
  p.lib_int = lib_int;
  p.lib_ann = lib_ann;
  p.lib_prec = lib_prec;
  p.cand = cand;
  p.out = out;
  p.c = c;
  p.tiles = (c + kSlots - 1) / kSlots;
  p.items = (long long)b * p.tiles;
  p.kq = kq;
  p.kc = kc;
  p.kcp = w.kcp;
  p.qb = w.qb;
  p.n_lib = n_lib;
  p.n_shift = allow_shift && num_shifts > 1 ? num_shifts - 1 : 0;
  p.tol = tol;
  p.chg = allow_shift ? (float)(num_shifts - 1) : 1.0f;
  const cudaStream_t st = (cudaStream_t)stream;
  if (w.kcp > (1 << kMaxSteps) || smem > kSmemLimit) {
    p.items = (long long)b * c;
    switch (p.n_shift) {
      case 0: return (int)launch_wide<0>(p, st);
      case 1: return (int)launch_wide<1>(p, st);
      case 2: return (int)launch_wide<2>(p, st);
      case 3: return (int)launch_wide<3>(p, st);
      case 4: return (int)launch_wide<4>(p, st);
      default: return (int)launch_wide<-1>(p, st);
    }
  }
  switch (p.n_shift) {
    case 0: return (int)launch<0>(p, smem, st);
    case 1: return (int)launch<1>(p, smem, st);
    case 2: return (int)launch<2>(p, smem, st);
    case 3: return (int)launch<3>(p, smem, st);
    case 4: return (int)launch<4>(p, smem, st);
    default: return (int)launch<-1>(p, smem, st);
  }
}

// Dynamic shared memory of a launch at these widths, and the blocks of the
// two-shift instance that fit on one SM with it (0 if none): for logs.
int stage1_bounds_occupancy(int kq, int kc, int* smem, int* blocks_per_sm) {
  const size_t bytes = smem_bytes(kq, kc);
  *smem = (int)bytes;
  *blocks_per_sm = 0;
  const auto kernel = stage1_bounds_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, bytes);
}

const char* stage1_bounds_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
