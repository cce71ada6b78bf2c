"""Smoke run of the PyTorch port on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py

Standard output holds one summary line a phase (``chip_smoke <phase>:
<seconds> s | <figures> | gates ok``), the total, the card's nvidia-smi
line, the kernels' JSON record and ``{"ok": true, ...}``; everything else
(each kernel case, profiler tables, per-batch figures, what a harness
prints) goes to `build/chip_smoke.log`.  A phase that fails ends the run
with a non-zero exit and no final line, after printing the phase, its
traceback and the log's last lines.  The engine's logging goes to
standard error.

Phases, in the order they run (1-3c, 3d, 3e, 4-6, 7, 8, 7b, 10a, 10b,
11a, 11b, 9, 11c, 9s, 12a, 12d, 12b, 12c), each raising on failure:

1. device: needs CUDA; prints torch/CUDA versions and the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the five CUDA kernels from `ann_solo_tpu_torch/csrc/`
   and the three native C++ library parsers from `csrc/native/` (into
   `build/native/`), one nvcc or g++ per source, all started together;
   a parser that does not build or load fails the run;
3. kernel B1 vs plain: the greedy shifted-dot kernel against its plain
   PyTorch version on the card, at the stage-2 (32,768 pairs) and
   match-extraction (4,096 pairs) shapes of the bench workload plus
   ragged, unequal-width, tie-heavy, K = 20 / 128 and dense (every entry
   positive) cases, non-finite and negative intensities at K = 50 with
   and without shifts and at a dense tolerance (more positive entries
   than the list holds: the recompute path), then the kernel's wide
   branch (K above 128): K = 129
   (ties), 300 and 1,024, a dense K = 200 set (more positive entries
   than its list holds: the overflow path), the engine's full-C greedy
   chunk (8,192 pairs at K = 300), Kq 300 against Kc 200 (zero tails), a
   quarter of the rows shuffled (the dense rule), non-finite m/z and
   precursors with peaks at the float32 window edges (tol 2^-5),
   non-finite and negative intensities with and without shifts (the
   direct rule's +inf entries), a dense K = 300 set whose
   rows all prefer the same column in turn, an odd K = 2,001 (the
   state's layout stays aligned at any K) and K = 9,000 with 40 positive
   peaks a side at a dense tolerance (state in a device-memory
   workspace, the overflow path).  Totals must be equal bit
   for bit (rtol 0: both sum the same float32 terms in the same order)
   and the match tables identical; each case logs its branch, and a wide
   case its pairs on the search and the dense rule (both taken over the
   phase), its positive entries a pair, its time a call and the
   kernel's own (a CUDA graph's replay) beside the bound of what its
   search does on these inputs (`b1_work`), and the old dense count;
3b. kernel B2 vs plain: the probe-gather scan against its plain version at
   the 2.1M-spectrum tile shape (B = 1,024, P = 64, cap = 768, D = 800,
   int8, +-500 Da), bf16 storage with a ppm window, a ragged shape
   (B = 7, cap = 200, D = 100), exact tie-heavy data, exact ragged bf16,
   the tile with every query probing the same 64 lists, phase 8's
   hot-list shape (P = 8), the bench's full scan on the card (a
   1,024-query super-tile, L = 4,096, P = 512, cap = 96, D = 800 int8)
   and phase 9's open level (P = 256, cap = 80, +-300 Da); the two ragged
   cases carry probe ids -1 and L,
   whose slots must be -inf.  The -inf masks must be identical; scores
   bit-identical on exact data, elsewhere within
   2 * D * 2^-24 * max|bf16(q)| * max|v * scale| (two float32 summation
   orders of unit-norm operands; norms measured);
3c. kernel B3 vs plain: the fused chunked scan's (B, n_chunks, 128) rows
   against its plain version, then both finished by the same selection
   (`ivf_chunked_scan_select`, hot lists through B2), at the 2.1M tile
   (B = 1,024, L = 4,096, cap = 768, D = 800, int8, 56 cold + 8 hot
   probes, +-500 Da), bf16 storage with a ppm window (L = 1,024, cap = 256,
   C = 8), exact tie-heavy data, 8 probes (no hot lists, so the
   certificates must fire), the 2.1M tile with every query probing the
   same 56 cold lists (1,024 queries a probed chunk), and D = 100 bf16 on
   random and on exact data.  Rule: the finite-lane masks of the rows are
   identical everywhere.  Exact data: rows and the finished (scores,
   positions, flags) bit-identical.  Random data: >= 99% of (query,
   chunk) rows identical (another float32 summation order can move a
   score across a bf16 rounding boundary), and over the queries neither
   side flags, >= 99.9% of (position, score) lanes equal with every
   16-bit key within one step;
3d. kernel B4 vs plain: rescore stage 1's bounds, through its routing
   (`ops/rescore.py::_stage1_bounds`), against `stage1_bounds_plain` on
   the card: the bench's 4,096 x 512 matrix and its 1,024-candidate leg
   (131,072 library spectra, K = 50, charge 2), a narrow (C = 256) and a
   wide (C = 16,384, mostly -1) window matrix of 1,024 rows, one and five
   and six shifts, shifts off, Kq = 56 against Kc = 70 and Kq = 32
   against Kc = 20; then the rows the main path has and the kernel's
   edges: preprocess's zero tail (bench and window rows), peaks at the
   float32 edges of the windows with duplicated m/z (at tol 2^-5 and at
   0.04 with charge 3), a quarter of the rows shuffled, non-finite m/z
   and precursors, and NaN and +-inf intensities with and without shifts
   (NaN and +inf bounds); then the kernel's wide branch: Kc = 257 (a row
   padded past 256), Kq = Kc = 300 and Kc = 1,024 with a quarter of the
   rows shuffled or with non-finite intensities (rows staged in chunks;
   each line names the staging and the summary line has each wide case's
   time).  Bounds must be equal bit for bit (rtol 0: the same float32
   operations, the sum over query peaks in the stated order), -inf and
   NaN cells included (a NaN's sign and payload aside); the rows and
   pairs on each of the kernel's branches (range search, dense loop) are
   logged and both must be taken, and each case's kernel branch (staged
   or wide).  Phases
   3-3d log each kernel's time
   beside its bound: the larger of its bytes (each input read once, each
   output written once; for B2 and B3 only the lists and chunks this
   run's probes touch, for B4 the library rows its ids name) over 3.35
   TB/s and its operations over the peak rate of their type (bf16 tensor
   cores for B2 and B3, f32 for B1: B1's matrix build alone, since
   the greedy walks only positive entries, and on its wide branch the
   search's subtractions and compares at the f32 instruction rate,
   33.5 T/s (`b1_work`); for B4 the f32 instruction
   rate, 33.5 T/s, and the merge of each pair's sorted peaks that these
   inputs need, beside the old dense count at 67 TFLOP/s; for B5 the
   lanes, the probe table, an id a selected lane and the outputs, and
   about 8 integer instructions a lane at 16.7 T/s);
3e. kernel B5 vs plain: the canonical select (top-k on 16-bit keys, the
   lane-to-id map and the dedup), through its routing
   (`ops/canonical_select.py::canonical_select`), against
   `canonical_select_plain` on the card: the bench's 4,096 x 49,152 lanes
   at k_sel 1,024 (512 candidates, x2) and 2,048 (1,024), phase 7's 2.1M
   tile (1,024 x 49,152) at k_sel 2,048 and at phase 7's own 1,024 (x1),
   phase 10b's 98,304 lanes (P 128 x cap 768), phase 9's open level
   (4,096 lists x cap 80, num_probe 256, k_sel 2,048), every finite lane
   at one score (ties across the threshold), rows with every lane
   masked or fewer finite lanes than k_sel, 256 rows of 196,608 lanes
   (P 256 x cap 768, k_sel 2,048: the kernel's long-row branch), the
   bench's rows at k_sel = MAX_SEL 4,096 (k 2,048) and 1,024 rows of P
   511 x cap 77 lanes (row starts not 16-byte aligned); then the wide
   branch (more than MAX_SEL lanes selected): the bench's rows at k_sel
   4,097 (x1) and 8,192 (k 4,096, x2, as 4,096 candidates select),
   k_sel = n = 65,536 on rows of one score, the long rows at k_sel
   16,384 (keys read from device memory) and two rows at k_sel = n =
   2^22, the kernel's largest.  Scores (as
   bits) and ids must be identical.  Logs each case's time beside its
   bound, the plain chain's time and that of `torch.topk` on the packed
   int64 keys (the kernels record's `library_ms`; the port never calls it
   on the card), its branch, dynamic shared memory and blocks an SM (the
   kernel's own plan and occupancy, which must equal the wrapper's
   `plan`); a wide case's line names its design (passes 1-3 on one block
   a row or split over several, the sort and dedup on one block a row or
   over tiles of items) and the summary line has each wide case's time
   beside `torch.topk`'s;
4. the bench (`ann_solo_tpu_torch.bench.run`, what ``python -m
   ann_solo_tpu_torch.bench`` prints): a 131,072-spectrum library (K = 50
   peaks, hash_len 800), auto num_list, num_probe 512, x2 SOAR
   redundancy, int8 storage, built twice; 4 batches of 4,096 charge-2
   queries, +-500 Da, 512 candidates, fragment tolerance 0.04,
   vectorize -> select -> certificate rescoring, then the 1,024-candidate
   leg; the select is the full-scan regime, on the card each query's 512
   probed lists through B2 and the selection through B5 (no f32 copy of
   the lists, no product over every list).  Then batch 0's select against
   the plain full scan (`_ivf_search_fullscan`) on the card, with the
   select's split on one super-tile (coarse product, probe sort, B2, B5),
   and again at 4,096 candidates (k_sel 8,192 of 49,152 lanes a row: B5's
   wide branch on the main path, its launches counted with B5's).
   Gates: self-match hit rate >= 0.95 per batch; B1, B2, B4 and B5
   launched, B5 in the 4,096-candidate select too; at both widths
   >= 99.9% of (id, score) lanes equal to the plain full scan's, every
   16-bit key within one step, no duplicate ids;
5. preprocess: a raw 4,096-spectrum block through `preprocess_batch`
   (CUDA vs CPU identical) and one more search batch;
6. CUDA vs CPU: the same slice on a 16,384-spectrum index with 256 queries
   on both devices: the same best index for >= 99.9% of queries, scores at
   rtol 1e-5;
7. the big-library slice (SCALE r04's single-chip configuration): a
   2,097,152-spectrum library made and vectorized on the card, an int8
   index of 4,096 lists, num_probe 64, no redundancy (the f32 vectors are
   freed after the build); 4 timed batches of 1,024 queries with 1,024
   candidates through the probe path.  Gates: B2's, B4's and B5's launch
   counts grow during the timed batches; on one batch the probe path agrees with the
   per-query oracle run on the card (>= 99.9% of (id, score) lanes equal,
   every 16-bit key within one step, no duplicate ids); best-match hit
   rate >= 0.95 per batch, or, for a batch below it, no lower than the
   oracle's on the same queries by more than one query.  Then the index
   is saved under build/ (`IvfIndex.save`, about 2.5 GB of int8 lists),
   loaded onto the card and batch 0 selected through the loaded index:
   (ids, scores) identical to the built index's; save and load seconds
   and the file's bytes are logged and the file is deleted.  Then one
   batch runs under torch.profiler, which logs wall and kernel seconds,
   the idle share and the ten costliest kernels;
8. the B3 path at full width: phase 7's index and query batches, with the
   probe path's lane bound (`ops.ivf_probe.MAX_PROBE_LANES`) set below
   P * cap so that `search_device` takes kernel B3 (restored afterwards);
   4 timed batches with stage seconds, flagged queries per batch and the
   B3 and B2 (hot lists) launch counts.  On batch 0 the B3 select is held
   against phase 7's probe path, the on-card per-query oracle and a direct
   call of the plain chunked scan.  Gates: B3's launch count grows; >=
   99.9% of (id, score) lanes equal to the probe path, every 16-bit key
   within one step, no duplicate ids; each batch's best-match hit rate
   equal to phase 7's within one query.  Then one batch of the B3 path
   runs under torch.profiler;
7b. `scale_demo`'s default point (`ann_solo_tpu_torch.scale_demo`, SCALE
   r04's single-chip configuration on its own rows): 2,097,152 unit rows
   of width 800 from `make_gen_rows` (a hash of (row, column)), an int8
   index of 4,096 lists built in memory (the float32 source block freed
   after the build; phase 7's index stays resident), num_probe 64, 1,024
   queries with 1,024 candidates through the probe path.  Gates: B2
   launched; each query's source row among its candidates for >= 0.95 of
   the queries, or, below that, no fewer than the on-card per-query oracle
   finds by more than one query;
9. the engine (`python -m ann_solo_tpu_torch.cli`, called in the process):
   QUALITY r05's corpus (`synthdata.make_corpus`, seed 42: 100,000
   library spectra, 200,000 store rows with decoys, 10,000 queries, 35%
   modified, 5% foreign) written as .splib and .mgf under build/engine/,
   searched with QUALITY r05's ann settings (std 20 ppm, open 300 Da,
   num_probe 256, 1,024 candidates, int8 x2 SOAR lists, 1% FDR), three
   times.  Run A: --model none with no store or index file present (any
   left by an earlier run is removed), which also writes the store and
   both index files; the native parsers must read the library and the
   queries, and the library read's seconds are logged.  Run B: the same
   command with the CLI's default model (--model rf), files present.  Run
   C: the same with --model svm.  Runs B and C read the queries natively
   and no library.  Each logs every stage's seconds (device synchronized
   at each boundary; store and index load or write seconds, FDR feature
   and model seconds apart for each level), each file's bytes, the
   forest's grid winners per fold, queries/s of the search, peak device
   memory, B1's, B4's and B5's launches and the identification counts
   from the mzTab beside the JAX package's (QUALITY_r05.json).  Gates,
   every run: the CLI returns 0; B1, B4 and B5 launched (each open level
   is the full-scan regime: B2 then B5); each charge's open level went through
   `IvfIndex.search_device` and its std level through window rescoring;
   accuracy among confident PSMs >= 0.95; confident PSMs >= 0.9 x the
   9,500 non-foreign queries.  Runs B and C besides: the store and both
   indexes were loaded, not built; no library read, decoy, preprocess or
   index build seconds; confident PSMs at q < 0.01 no fewer than run A's
   less 1%.  Then (phase 9s, after 11c), on a 1,000-peptide corpus (seed 7,
   250 queries), the
   store built twice with run A's settings, through the native reader and
   from the Python reader's spectra: every column identical; and the CLI
   on that corpus: --model none twice on the card, built then loaded,
   identical PSM lines; --model svm and --model rf on the card and with
   --no_gpu (files loaded): the same PSM_IDs and library spectra, q-values
   at rtol 1e-6, every differing line logged; and, each run building its
   own files, on the card and with --no_gpu in --mode ann and bf: the same
   PSM_IDs, the same library spectrum for >= 99.9% of them, identical PSM
   lines wherever it is; then the widths past the kernels' first
   branches (`wide_cuda_vs_cpu`): the library and the first 12 queries at
   --num_candidates 4096 --max_peaks_used 300 --max_peaks_used_library
   300, on the card (files built; B1 and B4 launched, at K = 300 their
   wide branches) and with --no_gpu (files loaded): identical PSM lines.
10a. the streaming switch (run after phase 8, on phase 7's library,
   settings and index): `IvfIndex.load_or_build` with no file present; the
   source block, 2,097,152 x 800 x 4 bytes, exceeds the 4 GiB bound of the
   in-memory build, so it must build through `build_streaming`, and its
   centroids, ids, stored vectors (as bytes), scales and precursors must
   equal phase 7's in-memory index.  Logs its build seconds and peak
   device memory beside phase 7's, then deletes the file;
10b. SCALE r04's single-chip streaming point (SCALE_r04.json
   "single_chip_8m_streaming"; run after 10a, with phase 7's library
   freed): 8,388,608 spectra made on the card as phase 7 makes its own (K =
   50, D = 800), `IvfIndex.build_streaming` re-vectorizing rows from their
   peaks on demand (16,384 lists x cap 768, num_probe 128, x1, int8), then
   4 timed batches of 1,024 queries, 1,024 candidates, +-500 Da, through
   the probe path (B2, then B1) with phase 7's gates: B2's launch count
   grows, batch 0's select equals the on-card per-query oracle on >=
   99.9% of (id, score) lanes with every 16-bit key within one step and no
   duplicate ids, and each batch's best-match hit rate is >= 0.95 or no
   lower than the oracle's by more than one query.  Logs build seconds,
   queries/s, peak device memory for the build and the search and the
   index's bytes.
11a. phase 10b's library and index list-sharded (`parallel/`): a (dp=1,
   lib=4) mesh of the one card (`make_mesh` with the card repeated; each
   shard holds 4,096 lists, the block one chip of a 4-chip deployment
   holds), `ShardedIvfIndex.build_sharded_streaming` given 10b's
   centroids.  Gates: every shard's ids, stored vectors (as bytes),
   scales and precursors equal 10b's index's list range, and the
   centroids 10b's.  Then 10b's 4 query batches (and a warm-up) through
   `ann_open_search_batch` on the sharded index: each shard's probed lists
   through kernel B2 at width 64 (a query probing more than 64 of its 128
   lists in one shard is repaired through the exact chunked scan), merged,
   then B1.  Gates: B2's launch count grows; batch 0's select equals 10b's
   on >= 99.9% of (id, score) lanes with every 16-bit key within one step
   and no duplicate ids; each batch's best-match hit rate equals 10b's
   within one query.  Then 10b's index placed on a (dp=2, lib=2) mesh of
   the card (width 128: no overflow): the placement allocates under 1% of
   the index's bytes (views, no copies), and batch 0's select passes the
   same lane gates.  Logs queries/s beside 10b's, overflowed queries per
   batch, build seconds by stage, peak device memory and B1's launches,
   and profiles one batch (torch.profiler); B2's launches of the timed
   batches count in the kernels record;
11b. SCALE r04's born-sharded point (SCALE_r04.json "born_sharded_build",
   `scale_demo.py` `sharded_main`) on the first 2,097,152 rows of 10b's
   library (10b's and 11a's indexes freed): 512 lists, num_probe 64, x2
   SOAR, int8, k-means of 8 iterations trained sharded, over a (dcn=2,
   dp=1, lib=4) mesh of the card (`make_multislice_mesh`; 8 list shards of
   64 lists, the fullscan regime).  Gates: every shard's vector block is
   629,145,600 bytes and their sum the global block; an in-memory
   `IvfIndex.build` of the same rows given the sharded build's centroids
   equals every shard's arrays over its list range; one batch of 1,024
   queries (1,024 candidates, +-500 Da) selects as that index does (its
   probe path, B2) on >= 99.9% of (id, score) lanes, every 16-bit key
   within one step, no duplicate ids.  Logs build seconds by stage (train,
   assign, plan, pack, place), the build's and the selects' peaks;
11c. (after phase 9's three runs) the CLI with --model none on run A's
   files, `SpectralLibrary._make_library_mesh` patched to a (dp=2, lib=4)
   mesh of the card: each charge's index loaded and placed as a
   `ShardedIvfIndex` (1,024 lists a shard, x2 SOAR, the fullscan regime),
   the open level's batches split over the two replicas.  Gates: the CLI
   returns 0; both indexes loaded and sharded on that mesh; the open level
   went through them; against run A's mzTab the same PSM_IDs, the same
   library spectrum for >= 99.9% of them, identical lines wherever it is
   the same.  Logs search seconds and queries/s.
   Phase 9's small corpus also runs a FASTA library: 50 of its peptides,
   ten to a protein, digested and predicted locally (`io/fasta.py`),
   searched by the CLI in --mode bf on the card and with --no_gpu, each
   building its own store: identical PSM lines;
12a. QUALITY r05 (QUALITY_r05.json) through the port's harness:
   `quality.main` with --reuse-corpus on phase 9's corpus (with its
   truth.json) and QUALITY r05's settings (100,000 peptides, 10,000
   queries, seed 42, --model none, num_probe 256, 1,024 candidates, int8;
   run A's settings hash), both legs and the recall curve, each leg
   timed with its peak device memory, B1's, B4's and B5's launches and
   the regimes (each leg must launch B1 and B4, the ann leg B5).
   Gates: the ann leg loads the store and both indexes (no library read,
   decoy, preprocess or index build seconds) and writes run A's PSM
   lines; the bf leg loads the store and runs every level of both charges
   by window rescoring, launching B1; bf confident PSMs at q < 0.01
   within 1% of QUALITY r05's 9,467 with accuracy >= 0.95;
   ann_vs_bf_ids_ratio >= 0.98; recall@1024 >= 0.97 over all of bf's
   confident PSMs.  Logs every key beside QUALITY r05's counts (not its
   TPU seconds);
12d. the diagnostics on 12a's workdir (`ann_solo_tpu_torch.tools`):
   `bf_profile` on its first 2,048 queries, untraced, then traced
   (`device_trace` around each rescoring call, the traces' device time
   summed by kernel: B1 and B4 against the rest); `probe_diag`
   (probed-list recall of bf's SSMs by depth and ordering, on bf16
   indexes built and written beside the library); `fdr_leak_diag`
   (calibration and foreign leak of both legs).  Gates: both levels
   rescored windows, B1 and B4 launched and hold device time in the
   traces; SSMs
   checked, no recall falls as the depth grows; both legs diagnosed;
12b. the SWEEP harness at its defaults (`sweep.main`: 131,072 Gaussian
   unit vectors of width 800, 1,024 queries, num_list {1,024, 2,048,
   4,096} x num_probe {32, 64, 128, 256}, k = 1,024, seed 11) on the card,
   its grid logged beside SWEEP_r02.json's recalls; then
   `bruteforce_search` on the card and on the CPU on the same inputs.
   Gates: >= 99.9% of the card's top-k ids in the CPU's top-k of the same
   query (their positions are logged: the two f32 products sum in other
   orders and swap neighbouring ranks); no recall@k falls as num_probe
   grows at a fixed num_list;
12c. the mirror plot's matching (`plot.ssm_matches`) for 20 confident
   target PSMs of run A's mzTab (10 unmodified, 10 modified), on the card
   (B1) and on the CPU: identical peak matches; each score logged beside
   the mzTab's.  No render: the card's machine has no matplotlib.

The line before the last is the kernels' JSON record (B1's launches:
phase 4's bench run and phases 12a, 12d and 12c; B2's: phase 4's bench
run, phase 7's and phase 11a's timed batches and phase 7b's run; B3's:
phase 8's; B4's:
phase 4's bench run, phase 7's timed batches, phase 9's three CLI runs
and phases 12a and 12d; B5's: phase 4's bench run, phase 7's and 10b's
timed batches, phase 9's three CLI runs and 12a's ann leg); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

N_LIBRARY = 131072
N_QUERIES = 4096
N_BATCHES = 4
K_PEAKS = 50
HASH_LEN = 800
CHARGE = 2
FRAG_TOL = 0.04
OPEN_TOL_DA = 500.0
NUM_CANDIDATES = 512
WIDE_SELECT_CANDIDATES = 4096  # phase 4's select on B5's wide branch
NUM_PROBE = 512
HIT_RATE_GATE = 0.95

# (name, pairs, query peaks, library peaks, charge, allow_shift, ties,
# fragment tolerance[, variant]).  "dense": a tolerance wider than the m/z
# range, so every one of the K x K entries is positive.  Variants
# (`b1_variant`) edit the rows after `synth_pairs`; "k300_tail" pads its
# 200 library peaks to 300 with zeros (`pad_peaks`).
KERNEL_CASES = (
    ("stage2", 32768, 50, 50, 2, True, False, FRAG_TOL),
    ("matches", 4096, 50, 50, 2, True, True, FRAG_TOL),
    ("noshift_c3", 4096, 50, 50, 3, False, False, FRAG_TOL),
    ("ragged_unequal", 5003, 50, 32, 3, True, True, FRAG_TOL),
    ("k128", 1000, 128, 128, 2, True, False, FRAG_TOL),
    ("k20", 777, 20, 20, 2, True, True, FRAG_TOL),
    ("dense", 1024, 50, 50, 2, True, False, 5000.0),
    ("k129", 1024, 129, 129, 2, True, True, FRAG_TOL),
    ("k300", 1024, 300, 300, 2, True, False, FRAG_TOL),
    ("k1024", 64, 1024, 1024, 2, True, False, FRAG_TOL),
    ("dense_k200", 64, 200, 200, 2, True, False, 5000.0),
    ("k300_chunk", 8192, 300, 300, 2, True, False, FRAG_TOL),
    ("k300_tail", 1024, 300, 200, 2, True, False, FRAG_TOL),
    ("k300_shuffled", 1024, 300, 300, 2, True, False, FRAG_TOL, "shuffled"),
    ("k300_nonfinite", 1024, 300, 300, 2, True, False, 2.0 ** -5,
     "nonfinite"),
    ("k300_intensities", 256, 300, 300, 2, True, False, FRAG_TOL,
     "intensities"),
    ("k50_intensities", 4096, 50, 50, 2, True, False, FRAG_TOL,
     "intensities"),
    ("noshift_k50_intensities", 4096, 50, 50, 2, False, False, FRAG_TOL,
     "intensities"),
    ("dense_k50_intensities", 1024, 50, 50, 2, True, False, 5000.0,
     "intensities"),
    ("noshift_k300_intensities", 256, 300, 300, 2, False, False, FRAG_TOL,
     "intensities"),
    ("dense_k300_skew", 64, 300, 300, 2, True, False, 5000.0, "skew"),
    ("k2001_odd", 16, 2001, 2001, 2, True, False, FRAG_TOL),
    ("k9000_workspace", 2, 9000, 9000, 2, True, False, 5000.0, "few"),
)
# Plain-version comparisons of B1 run in pieces of at most this many
# K x K entries (the k300_chunk case's matrices take gigabytes).
PLAIN_PAIR_ENTRIES = 2 ** 27

# Kernel B2 cases: (name, B, L, P, cap, D, storage, tol_val, tol_mode,
# exact data, probe table).  Probe tables: "random" (each query its own
# lists), "clustered" (every query probes query 0's lists: 1,024 entries a
# probed list), "invalid" (random, with ids -1 and L in a few rows, whose
# slots must all be -inf).  "hot" is phase 8's hot-list scan (8 lists a
# query, about 2 entries a list).
PROBE_CASES = (
    ("tile_2m", 1024, 4096, 64, 768, 800, "int8", OPEN_TOL_DA, "Da", False,
     "random"),
    ("bf16_ppm", 512, 1024, 64, 256, 800, "bf16", 1e5, "ppm", False,
     "random"),
    ("ragged", 7, 64, 16, 200, 100, "int8", 0.0, "Da", False, "invalid"),
    ("exact_ties", 256, 256, 32, 256, 128, "int8", 50.0, "Da", True,
     "random"),
    ("exact_ragged_bf16", 33, 64, 8, 200, 100, "bf16", 50.0, "Da", True,
     "invalid"),
    ("clustered", 1024, 4096, 64, 768, 800, "int8", OPEN_TOL_DA, "Da", False,
     "clustered"),
    ("hot", 1024, 4096, 8, 768, 800, "int8", OPEN_TOL_DA, "Da", False,
     "random"),
    ("bench", 1024, 4096, NUM_PROBE, 96, 800, "int8", OPEN_TOL_DA, "Da",
     False, "random"),
    ("engine", 1024, 4096, 256, 80, 800, "int8", 300.0, "Da", False,
     "random"),
)

# Kernel B5 cases: (name, B, L, P, cap, k_sel, k, redundant, kind).  The
# bench's full scan on the card (4,096 queries, P 512 x cap 96 = 49,152
# lanes, k_sel = R * k for its 512 and 1,024 candidates), phase 7's 2.1M
# tile (P 64 x cap 768) at k_sel 2,048 and as phase 7 runs it (x1, 1,024),
# phase 10b's 8.4M shape (P 128 x cap 768 = 98,304 lanes), phase 9's open
# level (4,096 lists x cap 80 at num_probe 256, k 1,024 of x2 storage, as
# its regime log line reports it), every finite lane at one score, and
# rows with every lane masked or fewer finite lanes than k_sel; then a
# row too long for the keys in shared memory (P 256 x cap 768 = 196,608
# lanes: the kernel's long-row branch), the bench's rows at k_sel =
# MAX_SEL (the largest sort) and rows of P 511 x cap 77 lanes, whose
# starts are not 16-byte aligned; then the wide branch (k_sel above
# MAX_SEL): the bench's rows at 4,097 (x1) and 8,192 (4,096 candidates of
# x2), k_sel = n = 65,536 (P 512 x cap 128) at one score, the long
# rows at 16,384, and k_sel = n = MAX_LANES (2^22 lanes, P 4,096 x cap
# 1,024: the largest row and selection the kernel takes).  Kinds (`synth_select_case`): "copies" (each id in two
# slots, one score), "unique", "ties", "masked".
SELECT_CASES = (
    ("bench_k512", 4096, 4096, NUM_PROBE, 96, 1024, 512, True, "copies"),
    ("bench_k1024", 4096, 4096, NUM_PROBE, 96, 2048, 1024, True, "copies"),
    ("tile_2m", 1024, 4096, 64, 768, 2048, 1024, True, "copies"),
    ("tile_2m_x1", 1024, 4096, 64, 768, 1024, 1024, False, "unique"),
    ("stream_8m", 1024, 16384, 128, 768, 1024, 1024, False, "unique"),
    ("engine", 1024, 4096, 256, 80, 2048, 1024, True, "copies"),
    ("ties", 256, 4096, NUM_PROBE, 96, 1024, 512, True, "ties"),
    ("masked", 256, 4096, NUM_PROBE, 96, 1024, 512, True, "masked"),
    ("long_row", 256, 4096, 256, 768, 2048, 1024, True, "copies"),
    ("k_max", 4096, 4096, NUM_PROBE, 96, 4096, 2048, True, "copies"),
    ("odd", 1024, 4096, 511, 77, 1024, 512, True, "copies"),
    ("k_4097", 1024, 4096, NUM_PROBE, 96, 4097, 4097, False, "unique"),
    ("k_wide", 4096, 4096, NUM_PROBE, 96, 8192, 4096, True, "copies"),
    ("k_all", 256, 4096, 512, 128, 65536, 4096, True, "ties"),
    ("long_k16384", 256, 4096, 256, 768, 16384, 8192, True, "copies"),
    ("k_lanes_max", 2, 4096, 4096, 1024, 1 << 22, 65536, True, "copies"),
)

# Kernel B3 cases: (name, B, L, cold probes, hot probes, cap, D, storage,
# tol_val, tol_mode, k_scan, exact data, every query probes the same
# lists).
SCAN_CASES = (
    ("tile_2m", 1024, 4096, 56, 8, 768, 800, "int8", OPEN_TOL_DA, "Da",
     1024, False, False),
    ("bf16_ppm", 512, 1024, 56, 8, 256, 800, "bf16", 1e5, "ppm", 1024,
     False, False),
    ("exact_ties", 256, 256, 24, 8, 256, 128, "int8", 50.0, "Da", 512, True,
     False),
    ("few_probes", 256, 512, 8, 0, 256, 128, "bf16", 0.0, "Da", 512, False,
     False),
    ("clustered", 1024, 4096, 56, 8, 768, 800, "int8", OPEN_TOL_DA, "Da",
     1024, False, True),
    ("ragged_bf16", 200, 128, 24, 8, 256, 100, "bf16", 50.0, "Da", 512,
     False, False),
    ("exact_ragged_bf16", 200, 128, 24, 8, 256, 100, "bf16", 50.0, "Da", 512,
     True, False),
)

# Kernel B4 cases: (name, B, C, library rows, query peaks, library peaks,
# charge, allow_shift, candidate rows[, options]).  "bench": the bench's
# rescoring matrix (4,096 x 512, then its 1,024-candidate leg); "window":
# contiguous library rows from a random start, -1 past a random width (at
# most C / 8 wide, so a wide row is mostly padding), one row in 16 all -1,
# as the window levels build them (`search._window_cand_matrix`).  Query
# blocks (`ops.stage1_cuda.i_tile`): 7 peaks a thread at K = 50 and 56, 4
# at Kq = 32; Kc = 70 pads the staged row to 128, Kc = 20 to 32; six
# shifts take the kernel's loop over any shift count.  The options (a
# dict of `synth_stage1` keywords, plus "tol" for the fragment tolerance;
# the first ten cases take none, so their inputs are those of earlier
# runs) give the rows the main path really has and the kernel's edges:
# preprocess's zero tail, peaks at the float32 edges of the windows with
# duplicated m/z (at tol = 2^-5 some sit exactly on them), a quarter of
# the rows shuffled (the dense branch), and non-finite m/z and precursors.
# The last three take the kernel's wide branch (`stage1_cuda.branch`): a
# row padded past 256 peaks, Kq = Kc = 300, and Kc = 1,024 with a quarter
# of the rows shuffled (both of its branch rules).
STAGE1_CASES = (
    ("bench_chunk", 4096, 512, 131072, 50, 50, 2, True, "bench"),
    ("bench_1024", 4096, 1024, 131072, 50, 50, 2, True, "bench"),
    ("window_narrow", 1024, 256, 100_000, 50, 50, 2, True, "window"),
    ("window_wide", 1024, 16384, 100_000, 50, 50, 2, True, "window"),
    ("shifts_1", 4096, 512, 131072, 50, 50, 0, True, "bench"),
    ("shifts_5", 1024, 512, 131072, 50, 50, 4, True, "bench"),
    ("noshift", 1024, 512, 131072, 50, 50, 2, False, "bench"),
    ("shifts_6", 256, 512, 131072, 50, 50, 5, True, "bench"),
    ("kq_ne_kc", 1024, 512, 131072, 56, 70, 3, True, "bench"),
    ("k32_k20", 1024, 512, 131072, 32, 20, 2, True, "window"),
    ("bench_tail", 1024, 512, 131072, 50, 50, 2, True, "bench",
     {"tail": True}),
    ("window_tail", 1024, 256, 100_000, 50, 50, 2, True, "window",
     {"tail": True}),
    ("edges_exact", 1024, 512, 16384, 50, 50, 2, True, "bench",
     {"edges": 0.03125, "tol": 0.03125}),
    ("edges_c3", 1024, 512, 16384, 50, 50, 3, True, "bench",
     {"edges": FRAG_TOL}),
    ("shuffled", 1024, 512, 131072, 50, 50, 2, True, "bench",
     {"shuffle": 0.25}),
    ("nonfinite", 512, 512, 131072, 50, 50, 2, True, "bench",
     {"nonfinite": True}),
    ("intensities", 512, 512, 131072, 50, 50, 2, True, "bench",
     {"intensities": True}),
    ("intensities_noshift", 512, 512, 131072, 50, 50, 2, False, "bench",
     {"intensities": True}),
    ("kc_257", 512, 256, 16384, 50, 257, 2, True, "bench"),
    ("kc_300_kq_300", 256, 256, 16384, 300, 300, 2, True, "bench"),
    ("kc_1024", 64, 64, 16384, 50, 1024, 2, True, "bench",
     {"shuffle": 0.25}),
    ("kc_1024_intensities", 64, 64, 16384, 50, 1024, 2, True, "bench",
     {"intensities": True}),
)

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, 700 W) for the
# kernels' bounds: HBM bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s
# outside the tensor cores (an FMA counted as two), and the f32
# instruction rate that a subtraction, a compare or a max issues at: one
# instruction a lane, 128 lanes an SM x 132 SMs x 1.98 GHz, half the
# FLOP rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
F32_INSTR_PER_S = F32_FLOPS / 2
# The int32 instruction rate: 64 lanes an SM x 132 SMs x 1.98 GHz.
INT32_INSTR_PER_S = F32_INSTR_PER_S / 2

# The big-library slice (SCALE r04's single-chip point, scale_demo.py).
N_BIG = 2_097_152
BIG_QUERIES = 1024
BIG_CANDIDATES = 1024

# SCALE r04's single-chip streaming point (SCALE_r04.json
# "single_chip_8m_streaming", phase 10b).
N_STREAM = 8_388_608
STREAM_QUERIES = 1024

# Phase 11a: list shards of 10b's library on the one card (a 4-chip
# deployment's split); phase 11b: SCALE r04's "born_sharded_build"
# (scale_demo.py `sharded_main`): the first 2,097,152 rows, 512 lists,
# num_probe 64, x2, int8, k-means of 8 iterations, over a ('dcn', 'dp',
# 'lib') = (2, 1, 4) mesh; each shard block 629,145,600 bytes.
N_SHARDS_8M = 4
N_BORN = 2_097_152
BORN_SHARD_BYTES = 629_145_600
BORN_KMEANS_ITERS = 8

# The engine (phase 9): QUALITY r05's ann leg (QUALITY_r05.json "corpus"
# and "config", ann_solo_tpu/quality.py:41-64), the repo's 200k canonical
# scale: 100,000 library spectra (charges 2 and 3), 200,000 store rows with
# decoys, 10,000 queries (35% modified, 5% foreign).
ENGINE_PEPTIDES = 100_000
ENGINE_QUERIES = 10_000
ENGINE_SEED = 42
ENGINE_ARGS = [
    "--precursor_tolerance_mass", "20", "--precursor_tolerance_mode", "ppm",
    "--precursor_tolerance_mass_open", "300",
    "--precursor_tolerance_mode_open", "Da",
    "--fragment_mz_tolerance", "0.02", "--allow_peak_shifts",
    "--min_mz_range", "200", "--min_peaks", "5", "--model", "none",
    "--mode", "ann", "--num_list", "0", "--num_probe", "256",
    "--num_candidates", "1024", "--index_dtype", "int8",
    "--ivf_redundancy", "2", "--soar_lambda", "1.0", "--fdr", "0.01",
    "--add_decoys",
]
ENGINE_FDR = 0.01
# The JAX package's identification counts on the same corpus
# (QUALITY_r05.json "ann"): counts, not a speed.
QUALITY_R05_ANN = {"n_confident": 9356, "accuracy": 0.973492945703292,
                   "foreign_leak_rate": 0.07, "empirical_fdp": 0.02651}
ENGINE_ACCURACY_GATE = 0.95
ENGINE_CONFIDENT_GATE = 0.9  # of the non-foreign queries
# Peptides of the small corpus written as the FASTA library of phase 9.
FASTA_PEPTIDES = 50
# Phase 12a: QUALITY r05's harness settings (QUALITY_r05.json "corpus" and
# "config"), which give phase 9's settings hash, and its gates.
QUALITY_ARGS = [
    "--n-peptides", str(ENGINE_PEPTIDES), "--n-queries", str(ENGINE_QUERIES),
    "--seed", str(ENGINE_SEED), "--model", "none", "--num_probe", "256",
    "--num_candidates", "1024", "--index_dtype", "int8",
]
QUALITY_BF_TOLERANCE = 0.01  # bf confident within 1% of QUALITY r05's
QUALITY_RATIO_GATE = 0.98  # ann_vs_bf_ids_ratio
QUALITY_RECALL_GATE = 0.97  # recall@1024


class ScaleConfig:
    """IVF settings of SCALE r04's single-chip configuration."""

    num_list = 4096
    num_probe = 64
    ivf_redundancy = 1


class StreamSwitchConfig(ScaleConfig):
    """Phase 7's settings as `IvfIndex.load_or_build` reads them
    (phase 10a)."""

    index_dtype = "int8"
    min_mz, max_mz, bin_size, hash_len = 11.0, 2010.0, 0.04, HASH_LEN


class Stream8mConfig:
    """IVF settings of SCALE r04's 8.4M-row single-chip streaming point."""

    num_list = 16384
    num_probe = 128
    ivf_redundancy = 1


class BornShardedConfig:
    """IVF settings of SCALE r04's born-sharded point (SOAR on, as the
    config names no soar_lambda)."""

    num_list = 512
    num_probe = 64
    ivf_redundancy = 2


# Standard output carries one summary line a phase; the detail (each
# kernel case, profiler tables, per-batch figures, and whatever a harness
# prints) goes to this log, opened by `main`.
LOG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke.log")
_LOG = None
_STDOUT = sys.stdout
_PHASE = {"label": None, "start": 0.0, "notes": []}


def log(*args):
    """A line of detail: into the log once `main` has opened it."""
    print(*args, file=_LOG or sys.stdout, flush=True)


def note(*parts):
    """Figures for the running phase's summary line."""
    _PHASE["notes"].extend(parts)


def phase(label, fn, *args, **kwargs):
    """Run one phase with its detail and its prints in the log, then print
    its summary line: ``chip_smoke <label>: <seconds> s | <figures> |
    gates ok``.  A phase that raises ends the run (see `main`)."""
    _PHASE.update(label=label, start=time.perf_counter(), notes=[])
    log(f"=== phase {label}")
    with contextlib.redirect_stdout(_LOG or sys.stdout):
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - _PHASE["start"]
    print(" | ".join([f"chip_smoke {label}: {seconds:.1f} s",
                      *_PHASE["notes"], "gates ok"]), file=_STDOUT,
          flush=True)
    return out


class BenchConfig:
    """IVF settings of the bench workload (auto num_list, SOAR on)."""

    num_list = 0
    num_probe = NUM_PROBE
    ivf_redundancy = 2


def time_ms(fn, dev, reps: int) -> float:
    """Mean milliseconds of `fn()` after one warm-up call (CUDA events)."""
    import torch

    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


def time_graph_ms(fn, dev, reps: int) -> float:
    """Mean milliseconds of `fn()` on the device alone: `reps` calls
    captured in one CUDA graph, timed over three replays after one, so
    the host's launch time between calls is left out (on the CPU:
    `time_ms`)."""
    import torch

    if dev.type != "cuda":
        return time_ms(fn, dev, reps)
    fn()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / (3 * reps)


def bound(name, case, ms, n_bytes, ops, flops_per_s):
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    HBM rate and its operations over the peak rate of their type.  Logs
    the kernel's time beside it and returns the record's fields."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"bound {name} {case}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {n_bytes / 1e9:.4f} GB -> {t_bytes:.4f} ms, "
        f"{ops:.4g} ops -> {t_ops:.4f} ms), {100.0 * bound_ms / ms:.2f}% "
        "of the bound")
    return {"bound_ms": bound_ms, "bound_by": bound_by}


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def synth_pairs(rng, p, kq, kc, charge, ties):
    """(query, candidate) pairs with direct, shifted and conflicting peak
    matches; `ties` quantizes intensities so equal scores are common."""
    f32 = np.float32
    q_mz = np.sort(rng.uniform(100, 1500, (p, kq)), 1).astype(f32)
    c_mz = np.sort(rng.uniform(100, 1500, (p, kc)), 1).astype(f32)
    m = min(kq, kc)
    a = min(10, m)
    c_mz[:, :a] = q_mz[:, :a] + rng.uniform(-0.03, 0.03, (p, a))
    mod = rng.choice([0.0, 16.0, 79.97], p).astype(f32)
    b = min(18, m)
    s = rng.integers(1, charge + 1, (p, b - a))
    c_mz[:, a:b] = q_mz[:, a:b] - mod[:, None] / s
    c = min(26, m)  # near-duplicate clusters: one-to-one conflicts
    c_mz[:, b:c] = q_mz[:, b:c] + rng.uniform(0, 0.015, (p, c - b))
    q_mz[:, b + 1:c:2] = q_mz[:, b:c - 1:2] + 0.01
    q_mz, c_mz = np.sort(q_mz, 1), np.sort(c_mz, 1)
    q_int = rng.uniform(0.05, 1.0, (p, kq))
    c_int = rng.uniform(0.05, 1.0, (p, kc))
    if ties:
        q_int, c_int = np.ceil(q_int * 4) / 4, np.ceil(c_int * 4) / 4
    q_prec = rng.uniform(400, 1200, p).astype(f32)
    c_prec = (q_prec - mod / charge).astype(f32)
    return (
        q_mz.astype(f32), q_int.astype(f32), c_mz.astype(f32),
        c_int.astype(f32), rng.integers(0, charge + 1, (p, kc)).astype(
            np.int32), q_prec, c_prec, np.full(p, charge, np.int32),
    )


def b1_variant(rng, pairs, variant, tol, charge):
    """Kernel B1 case edits, in place on `synth_pairs`' NumPy arrays:
    * "edges": for each pair, candidate peaks at the float32 edges of one
      query peak's direct window and of one shift window (`_b1_edges`);
    * "shuffled": a quarter of the candidate rows permuted (off the
      search rule: the dense walk);
    * "nonfinite": "edges", then NaN and +-inf m/z in a sixteenth of the
      candidate rows (the dense walk) and an eighth of the query rows,
      and an infinite library precursor in a few pairs;
    * "intensities": NaN, +-inf or negative intensities in a few query or
      candidate rows (NaN entries, or a gap in the positive prefix); half
      of those query peaks move to an m/z that no candidate peak matches
      at any shift (without shifts their row's entries stay 0, never
      0 * inf), the other half onto a candidate peak's own m/z;
    * "skew": candidate intensities descending along each row, so that at
      a dense tolerance every row prefers the same column in turn;
    * "few": only the first 40 candidate peaks (a prefix: the search
      rule holds) and 40 query peaks of positive intensity, so that at a
      dense tolerance 1,600 positive entries (past the on-chip list) lie
      on 40 rows and columns and the greedy takes 40 steps."""
    q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, _ = pairs
    f32 = np.float32
    p, kc = c_mz.shape
    kq = q_mz.shape[1]
    if variant in ("edges", "nonfinite"):
        _b1_edges(rng, f32(tol), charge, pairs)
    if variant == "shuffled":
        rows = np.nonzero(rng.random(p) < 0.25)[0]
        perm = rng.permuted(np.tile(np.arange(kc), (len(rows), 1)), axis=1)
        for arr in (c_mz, c_int, c_ann):
            arr[rows] = np.take_along_axis(arr[rows], perm, 1)
    if variant == "nonfinite":
        bad = np.array([np.nan, np.inf, -np.inf], f32)
        rows = rng.choice(p, max(1, p // 16), replace=False)
        c_mz[rows, rng.integers(0, kc, len(rows))] = rng.choice(bad, len(rows))
        rows = rng.choice(p, max(1, p // 8), replace=False)
        q_mz[rows, rng.integers(0, kq, len(rows))] = rng.choice(bad, len(rows))
        c_prec[rng.choice(p, max(1, p // 64), replace=False)] = np.inf
    if variant == "intensities":
        bad = np.array([np.nan, np.inf, -np.inf, -0.5], f32)
        for arr, k in ((q_int, kq), (c_int, kc)):
            rows = rng.choice(p, max(4, p // 16), replace=False)
            cols = rng.integers(0, k, len(rows))
            arr[rows, cols] = rng.choice(bad, len(rows))
            if arr is q_int:
                q_mz[rows[::2], cols[::2]] = f32(5000.0)  # past every peak
                near = rows[1::2]
                q_mz[near, cols[1::2]] = c_mz[
                    near, rng.integers(0, kc, len(near))]
    if variant == "skew":
        c_int[:] = -np.sort(-c_int, 1)
    if variant == "few":
        n = min(40, kc, kq)
        c_int[:, n:] = 0.0
        drop = rng.permuted(np.tile(np.arange(kq), (p, 1)), axis=1)[:, n:]
        np.put_along_axis(q_int, drop, f32(0.0), 1)


def _b1_edges(rng, tol, charge, pairs):
    """`b1_variant`'s "edges", in place: for each pair, one query peak of
    intensity 1 and, on both edges of its direct window and of one shift
    window (when |prec_diff| >= tol), the outermost candidate m/z that
    passes the plain float32 test (intensity 1; annotation = the shift,
    so the entry is 1) and the next one out, which fails it; then two
    duplicated m/z, and the row sorted again.  At a tolerance of 2^-5
    the direct window's outermost peaks lie at |q - c| = tol exactly."""
    q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, _ = pairs
    f32 = np.float32
    p, kc = c_mz.shape
    for r in range(p):
        i = rng.integers(0, min(12, q_mz.shape[1]))
        q = q_mz[r, i]
        pd = f32((q_prec[r] - c_prec[r]) * f32(charge))
        shift = int(rng.integers(1, max(charge, 1) + 1))
        windows = [(0, f32(0.0))]
        if abs(pd) >= tol and charge >= 1:
            windows.append((shift, f32(pd / f32(shift))))
        placed = []
        for w, off in windows:
            def passes(c):
                d = f32(q - c)
                return abs(d if w == 0 else f32(d - off)) <= tol
            for out in (-np.inf, np.inf):  # the low and the high edge
                c = f32(f32(q - off) + f32(tol if out > 0 else -tol))
                for _ in range(8):
                    if passes(c):
                        break
                    c = np.nextafter(c, f32(-out))
                for _ in range(8):
                    beyond = np.nextafter(c, f32(out))
                    if not passes(beyond):
                        break
                    c = beyond
                placed += [(c, w, True), (np.nextafter(c, f32(out)), w,
                                          False)]
        at = rng.choice(kc, len(placed) + 2, replace=False)
        for (c, w, passing), j in zip(placed, at):
            c_mz[r, j] = c
            if passing:
                c_int[r, j] = 1.0
                c_ann[r, j] = w
        c_mz[r, at[-2:]] = c_mz[r, at[:2]]
        q_int[r, i] = 1.0
        order = np.argsort(c_mz[r], kind="stable")
        for arr in (c_mz, c_int, c_ann):
            arr[r] = arr[r, order]


def synth_stage1(rng, b, c, n_lib, kq, kc, charge, cand_rows="bench",
                 close_prec=0.25, tail=False, edges=None, shuffle=0.0,
                 nonfinite=False, intensities=False):
    """Kernel B4 inputs in NumPy: a library of `n_lib` spectra (`kc` peaks,
    annotations 0..charge) and `b` queries, each made from a library row
    with direct, shifted (by mod / s, s = 1..charge, as a precursor
    shift of mod makes them) and random peaks, a quarter with the row's
    own precursor (|delta prec| < tol: no shifted terms).  Candidate rows
    are `cand_rows`: "bench" (random ids with the source row among them,
    about 1 in 10 slots -1) or "window" (see STAGE1_CASES).

    Options, off by default (the arrays and the draws from `rng` are then
    those of the call without them):
    * `tail`: every library row and query keeps a random count (1..K) of
      its ascending peaks, then m/z 0, intensity 0, annotation 0, the
      layout of `preprocess_batch`;
    * `edges`: a fragment tolerance; each query's source row gets, for
      one matched query peak, peaks within two ulps of q - off_w +- tol
      for the direct window and one shift window (float32, so some pass
      the plain test exactly at the edge and their neighbours fail it),
      and two duplicated m/z, then is sorted again;
    * `shuffle`: the share of library rows whose peaks are permuted
      (unsorted: the kernel's dense branch);
    * `nonfinite`: NaN and +-inf m/z in about 2% of the library rows and
      an eighth of the queries, and an infinite precursor in a few rows;
    * `intensities`: NaN, +inf and -inf in turn as the intensity of a
      matched peak of the source rows of a sixteenth of the queries (at
      least 3) and of a peak of an eighth of the queries (at least 3),
      half of those moved to an m/z that no library peak matches at any
      shift."""
    f32 = np.float32
    lib_mz = np.sort(rng.uniform(100, 1500, (n_lib, kc)), 1).astype(f32)
    lib_int = rng.uniform(0.05, 1.0, (n_lib, kc)).astype(f32)
    lib_ann = rng.integers(0, charge + 1, (n_lib, kc)).astype(np.int32)
    lib_prec = rng.uniform(400, 1200, n_lib).astype(f32)
    src = rng.integers(0, n_lib, b)
    mod = rng.choice([0.0, 16.0, 79.97], b).astype(f32)
    mod[rng.random(b) < close_prec] = 0.0
    q_mz = rng.uniform(100, 1500, (b, kq)).astype(f32)
    m = min(kq, kc)
    a, d = min(12, m), min(20, m)
    q_mz[:, :a] = lib_mz[src, :a] + rng.uniform(-0.03, 0.03, (b, a))
    s = rng.integers(1, max(charge, 1) + 1, (b, d - a))
    q_mz[:, a:d] = lib_mz[src, a:d] + mod[:, None] / s
    q_mz = np.sort(q_mz, 1)
    q_int = rng.uniform(0.05, 1.0, (b, kq)).astype(f32)
    q_prec = (lib_prec[src] + mod / max(charge, 1)).astype(f32)
    if cand_rows == "bench":
        cand = rng.integers(0, n_lib, (b, c))
        cand[rng.random((b, c)) < 0.1] = -1
        cand[np.arange(b), rng.integers(0, c, b)] = src
    else:
        lo = rng.integers(0, n_lib, b)
        width = rng.integers(0, c // 8 + 1, b)
        width[rng.random(b) < 1 / 16] = 0
        cand = lo[:, None] + np.arange(c)[None]
        cand = np.where((np.arange(c)[None] < width[:, None])
                        & (cand < n_lib), cand, -1)
    if edges is not None:
        _place_edges(rng, f32(edges), charge, q_mz, q_prec, lib_mz, lib_int,
                     lib_ann, lib_prec, src)
    if tail:
        for mz, inten, ann in ((lib_mz, lib_int, lib_ann),
                               (q_mz, q_int, None)):
            n = mz.shape[1]
            pad = np.arange(n)[None] >= rng.integers(1, n + 1, len(mz))[:, None]
            mz[pad] = 0.0
            inten[pad] = 0.0
            if ann is not None:
                ann[pad] = 0
    if shuffle:
        rows = np.nonzero(rng.random(n_lib) < shuffle)[0]
        perm = rng.permuted(np.tile(np.arange(kc), (len(rows), 1)), axis=1)
        for arr in (lib_mz, lib_int, lib_ann):
            arr[rows] = np.take_along_axis(arr[rows], perm, 1)
    if nonfinite:
        bad = np.array([np.nan, np.inf, -np.inf], f32)
        rows = rng.choice(n_lib, max(1, n_lib // 50), replace=False)
        lib_mz[rows, rng.integers(0, kc, len(rows))] = rng.choice(
            bad, len(rows))
        rows = rng.choice(b, max(1, b // 8), replace=False)
        q_mz[rows, rng.integers(0, kq, len(rows))] = rng.choice(bad, len(rows))
        lib_prec[rng.choice(n_lib, max(1, n_lib // 200), replace=False)] = \
            np.inf
    if intensities:
        bad = np.array([np.nan, np.inf, -np.inf], f32)
        rows = np.unique(src[rng.choice(b, max(3, b // 16), replace=False)])
        lib_int[rows, rng.integers(0, a, len(rows))] = bad[
            np.arange(len(rows)) % 3]
        rows = rng.choice(b, max(3, b // 8), replace=False)
        cols = rng.integers(0, kq, len(rows))
        q_int[rows, cols] = bad[np.arange(len(rows)) % 3]
        q_mz[rows[::2], cols[::2]] = f32(5000.0)  # past every peak
    return (q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec,
            cand.astype(np.int64))


def _place_edges(rng, tol, charge, q_mz, q_prec, lib_mz, lib_int, lib_ann,
                 lib_prec, src):
    """`synth_stage1`'s `edges` option, in place: for each query, 12 peaks
    of its source row at the float32 edges of one query peak's direct
    window and of one shift window (q - off +- tol and two ulps either
    side), 2 duplicated m/z, then the row sorted again."""
    f32 = np.float32
    kc = lib_mz.shape[1]
    if kc < 14:
        return
    chg = f32(max(charge, 1))
    for r in range(len(q_mz)):
        row = src[r]
        q = q_mz[r, rng.integers(0, min(12, q_mz.shape[1]))]
        pd = f32((q_prec[r] - lib_prec[row]) * chg)
        shift = rng.integers(1, max(charge, 1) + 1)
        placed = []
        for off in (f32(0.0), f32(pd / f32(shift))):
            for sign in (f32(1.0), f32(-1.0)):
                c0 = f32(f32(q - off) - sign * tol)
                for step in (-2, -1, 0, 1, 2):
                    cv = c0
                    for _ in range(abs(step)):
                        cv = np.nextafter(cv, f32(np.inf if step > 0
                                                  else -np.inf))
                    placed.append(cv)
        at = rng.choice(kc, 14, replace=False)
        picked = rng.choice(len(placed), 12, replace=False)
        lib_mz[row, at[:12]] = np.asarray(placed, f32)[picked]
        lib_mz[row, at[12:]] = lib_mz[row, at[:2]]
        order = np.argsort(lib_mz[row], kind="stable")
        for arr in (lib_mz, lib_int, lib_ann):
            arr[row] = arr[row, order]


def phase_device():
    import torch

    from ann_solo_tpu_torch.device import require_cuda

    dev = require_cuda()
    versions = (f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"{torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(versions)
    log(smi)
    note(versions, smi)
    return dev, smi


PARSERS = ("splib_parser", "sptxt_parser", "mgf_parser")


def phase_build(names=("shifted_dot", "ivf_probe_scan", "ivf_chunked_scan",
                       "stage1_bounds", "canonical_select"),
                parsers=PARSERS):
    """Build every kernel source (one nvcc each) and every native parser
    (one g++ each) at once, then load them; a build that fails raises."""
    from concurrent.futures import ThreadPoolExecutor

    from ann_solo_tpu_torch.io import (
        _native_build,
        mgf_native,
        splib_native,
        sptxt_native,
    )
    from ann_solo_tpu_torch.ops import _build

    cached = {name: _build.library_path(name).exists() for name in names}
    cached.update({name: _native_build.library_path(name).exists()
                   for name in parsers})

    def timed(build, name):
        t0 = time.perf_counter()
        path = build(name)
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + len(parsers)) as pool:
        kernels = [pool.submit(timed, _build.ensure_built, name)
                   for name in names]
        natives = [pool.submit(timed, _native_build.ensure_built, name)
                   for name in parsers]
        kernels = [f.result() for f in kernels]
        natives = [f.result() for f in natives]
    for name, (path, _) in zip(names, kernels):
        _build.load(name)
        log(f"build: {path.name}{' (already built)' if cached[name] else ''}")
        for line in _build.ptxas_report(name):
            log(f"ptxas {name}: {line}")
    for name, (path, sec) in zip(parsers, natives):
        log(f"build: {path.name} in {sec:.2f}s"
            f"{' (already built)' if cached[name] else ''}")
    for module in (splib_native, sptxt_native, mgf_native):
        if not module.available():
            raise AssertionError(f"{module.__name__}: the parser does not "
                                 "load")
    log(f"build: {len(names)} kernels and {len(parsers)} parsers in "
        f"{time.perf_counter() - t0:.2f}s")
    note(f"{len(names)} kernels and {len(parsers)} parsers built "
         f"(nvcc and g++ in parallel) in {time.perf_counter() - t0:.2f} s")


def b1_plain(args, chunk):
    """`shifted_dot_full_plain` over pieces of `chunk` pairs."""
    import torch

    from ann_solo_tpu_torch.ops.shifted_dot import shifted_dot_full_plain

    p = args[0].shape[0]
    parts = [shifted_dot_full_plain(*(a[s:s + chunk] for a in args[:8]),
                                    *args[8:]) for s in range(0, p, chunk)]
    return (torch.cat([t for t, _ in parts]),
            torch.cat([m for _, m in parts]))


def b1_work(args, chunk, list_entries):
    """What B1's wide kernel does for these inputs, from this run's
    arrays (in pieces of `chunk` pairs): the operations of the search
    design, the pairs on the search and the dense rule, the positive
    entries and the pairs whose positive entries overflow the on-chip
    list of `list_entries` (the kernel's plan).  Operations: for a pair on the search rule, each query peak of
    positive intensity takes, in each active window (the direct one; each
    shift s <= charge when |prec_diff| >= tol), a binary search over the
    prefix of positive candidate peaks (bit_length(n_pos) probes) and a
    walk over its passing range plus the failing edge, a subtraction and
    a compare a step (one subtraction more for a shift window); then each
    peak passing any window is evaluated once, 5 operations a window and
    2 for the product (the old count's entry); a query peak of negative
    intensity walks its whole row.  A dense-rule pair: every entry
    evaluated.  The greedy's sort and walk over the positive entries are
    left out."""
    import torch

    from ann_solo_tpu_torch.ops import shifted_dot_cuda
    from ann_solo_tpu_torch.ops.shifted_dot import pair_score_matrix

    qm, qi, cm, ci, ca, qp, cp, chg, tol, num_shifts, shift = args
    p, k = qm.shape
    f32 = torch.float32
    tol_t = torch.tensor(tol, dtype=f32, device=qm.device)
    search = shifted_dot_cuda.search_pairs(qi, cm, ci, tol)
    n_pos = (ci > 0).sum(1)
    pd = (qp - cp) * chg.to(f32)
    shifted = (pd.abs() >= tol_t) & bool(shift and num_shifts > 1)
    n_shift = torch.where(shifted, chg.clamp(0, num_shifts - 1), 0)
    probes = torch.log2(n_pos.to(torch.float64) + 1).ceil()
    per_entry = (5 * (n_shift + 1) + 2).to(torch.float64)
    ops, positives, overflow = 0.0, 0, 0
    cols = torch.arange(k, device=qm.device)
    for s in range(0, p, chunk):
        sl = slice(s, s + chunk)
        diff = qm[sl, :, None] - cm[sl, None, :]
        prefix = (cols[None, :] < n_pos[sl, None])[:, None, :]
        walk = torch.zeros(diff.shape[:2], dtype=torch.float64,
                           device=qm.device)
        any_pass = torch.zeros_like(diff, dtype=torch.bool)
        for w in range(int(n_shift.max()) + 1 if p else 1):
            g = diff if w == 0 else diff - (pd[sl] / torch.tensor(
                float(w), dtype=f32, device=qm.device))[:, None, None]
            active = (n_shift[sl] >= w)[:, None]
            passes = (g.abs() <= tol_t) & prefix & active[:, :, None]
            step_ops = 2 if w == 0 else 3
            walk += torch.where(
                active, (probes[sl, None] + passes.sum(2) + 1) * step_ops,
                0.0)
            any_pass |= passes
        rows = torch.where(
            qi[sl] > 0, walk + any_pass.sum(2) * per_entry[sl, None],
            torch.where(qi[sl] < 0, k * per_entry[sl, None], 0.0))
        ops += float(torch.where(search[sl], rows.sum(1),
                                 k * k * per_entry[sl]).sum())
        n = (pair_score_matrix(*(a[sl] for a in args[:8]), *args[8:])
             > 0).sum((1, 2))
        positives += int(n.sum())
        overflow += int((n > list_entries).sum())
    n_search = int(search.sum())
    return {"ops": ops, "search": n_search, "dense": p - n_search,
            "positives": positives / max(p, 1), "overflow": overflow}


def phase_kernel(dev, cases=KERNEL_CASES, kernel_reps=20, plain_reps=3):
    """Kernel vs plain version on the same tensors; returns the record of
    the stage-2 shape (times) and the largest total difference.  On the
    wide branch each case logs the pairs on the search and the dense rule
    (both must be taken over the phase), its positive entries a pair, its
    pairs past the on-chip list, its time a call through the wrapper and
    the kernel's own (`time_graph_ms`) beside the restated bound
    (`b1_work`); the wide kernel's launch plan at each K, as its library
    reports it (`shifted_dot_cuda.wide_plan`), is logged and must fit the
    card."""
    import torch

    from ann_solo_tpu_torch.ops import shifted_dot_cuda
    from ann_solo_tpu_torch.ops.shifted_dot import (
        pair_score_matrix as shifted_dot_scores_matrix,
    )
    from ann_solo_tpu_torch.ops.shifted_dot_cuda import (
        branch,
        pad_peaks,
        shifted_dot_full,
    )

    plans = {}
    for k, charge in sorted({(max(c[2], c[3]), c[4]) for c in cases
                             if branch(max(c[2], c[3])) == "wide"}):
        plan = plans[k] = shifted_dot_cuda.wide_plan(k, charge + 1)
        if not (plan["blocks_per_sm"] >= 1 and plan["row_depth"] >= 1
                and (plan["smem_bytes"] > 0) != (plan["workspace_bytes"] > 0)
                and plan["workspace_bytes"] % 16 == 0):
            raise AssertionError(f"B1 wide plan at K = {k}: {plan}")
        where = (f"{plan['smem_bytes']} bytes of dynamic shared memory"
                 if plan["smem_bytes"] else
                 f"{plan['workspace_bytes']} bytes of device memory")
        log(f"B1 wide plan at K = {k}: {plan['threads']} threads and "
            f"{where} a block, {plan['blocks_per_sm']} blocks "
            f"({plan['blocks_per_sm'] * plan['threads'] // 32} warps) an "
            f"SM; a list of {plan['list_entries']} entries, "
            f"{plan['row_depth']} cached a row past it")
        note(f"B1 wide at K = {k}: {plan['blocks_per_sm']} blocks of "
             f"{plan['threads']} threads an SM, {where} a block")
    rng = np.random.default_rng(2024)
    record = {"max_abs_err": 0.0}
    rules = np.zeros(2, np.int64)  # wide pairs on the search, dense rule
    for name, p, kq, kc, charge, shift, ties, tol, *rest in cases:
        variant = rest[0] if rest else None
        pairs = synth_pairs(rng, p, kq, kc, charge, ties)
        if variant:
            b1_variant(rng, pairs, variant, tol, charge)
        arrays = [torch.from_numpy(a).to(dev) for a in pairs]
        qm, qi, cm, ci, ca = pad_peaks(*arrays[:5])
        k = qm.shape[1]
        args = (qm, qi, cm, ci, ca, *arrays[5:], tol, charge + 1, shift)
        chunk = max(1, PLAIN_PAIR_ENTRIES // (k * k))
        total, match = shifted_dot_full(*args)
        p_total, p_match = b1_plain(args, chunk)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        both = torch.isfinite(total) & torch.isfinite(p_total)
        err = float((total - p_total)[both].abs().max()) \
            if bool(both.any()) else 0.0
        record["max_abs_err"] = max(record["max_abs_err"], err)
        n_match = int((p_match >= 0).sum())
        nonfinite = ""
        if variant == "intensities":
            # Pairs with an infinite total (a +inf entry taken), and pairs
            # with a non-finite query intensity that still take a finite
            # positive total (without shifts: the direct rule's zeros).
            bad_q = ~torch.isfinite(qi).all(1)
            n_inf = int(torch.isinf(p_total).sum())
            n_kept = int((bad_q & torch.isfinite(p_total)
                          & (p_total > 0)).sum())
            nonfinite = (f"; {n_inf} infinite totals, {n_kept} pairs with "
                         "a non-finite query intensity keep a finite "
                         "positive total")
            if not shift and not (n_inf > 0 and n_kept > 0):
                raise AssertionError(f"B1 {name}: the direct rule is not "
                                     f"exercised{nonfinite}")
        if not (torch.equal(total.view(torch.int32),
                            p_total.view(torch.int32))
                and torch.equal(match, p_match)):
            raise AssertionError(
                f"kernel != plain at {name}: max |d total| {err}, "
                f"{int((total != p_total).sum())} totals and "
                f"{int((match != p_match).sum())} match entries differ"
            )
        ms = time_ms(lambda: shifted_dot_full(*args), dev, kernel_reps)
        plain_ms = time_ms(lambda: b1_plain(args, chunk), dev, plain_reps)
        n_bytes = tensor_bytes(*args[:8], total, match)
        # The old count, at the unpadded widths: per shift a difference,
        # a second difference, |.|, a compare and a max for each of the
        # Kq x Kc entries, then the intensity product (2).  The greedy
        # needs no pass over the matrix (the kernel walks the positive
        # entries).  The register branch keeps it; the wide branch is
        # held to what its search does on these inputs (`b1_work`), at
        # the f32 instruction rate.
        n_shifts = charge + 1 if shift else 1
        old = p * kq * kc * (5 * n_shifts + 2)
        if branch(k) == "wide":
            # Small pair counts finish faster than the wrapper launches
            # them: the kernel's own time is a graph replay's.
            call_ms = ms
            ms = time_graph_ms(lambda: shifted_dot_full(*args), dev,
                               kernel_reps)
            list_entries = plans[k]["list_entries"]
            work = b1_work(args, chunk, list_entries)
            rules += (work["search"], work["dense"])
            fields = bound("B1", name, ms, n_bytes, work["ops"],
                           F32_INSTR_PER_S)
            old_ms = max(n_bytes / HBM_BYTES_PER_S, old / F32_FLOPS) * 1e3
            log(f"bound B1 {name}, the old count: {old:.4g} ops at "
                f"{F32_FLOPS:.3g} FLOP/s -> {old_ms:.4f} ms, "
                f"{100.0 * old_ms / ms:.2f}% of it")
            if fields["bound_ms"] > ms:
                raise AssertionError(f"B1 {name}: {ms:.4f} ms below its "
                                     f"bound {fields['bound_ms']:.4f} ms: "
                                     "the count is wrong")
            n_pos = work["positives"]
            rule = (f"rules: search {work['search']} pairs, dense "
                    f"{work['dense']}; {work['overflow']} pairs past the "
                    f"{list_entries}-entry list; "
                    f"{call_ms:.4f} ms a call through the wrapper")
            note(f"B1 {name}: {ms:.4f} ms ({call_ms:.4f} a call), "
                 f"{100 * fields['bound_ms'] / ms:.2f}% of its "
                 f"{fields['bound_ms']:.4f} ms bound")
        else:
            fields = bound("B1", name, ms, n_bytes, old, F32_FLOPS)
            n_pos = int((shifted_dot_scores_matrix(*args) > 0).sum()) / p
            rule = "rules: none (the register branch)"
        if name == cases[0][0]:  # the stage-2 shape goes in the record
            # The count logged beside it also charges a dense greedy: a
            # compare and a select per entry, once per match and once to
            # stop.
            dense_greedy = (n_match + p) * kq * kc * 2
            log(f"bound B1 {name}, the old count with the dense greedy: "
                f"{old + dense_greedy:.4g} ops -> "
                f"{(old + dense_greedy) / F32_FLOPS * 1e3:.4f} ms")
            record.update(ms=ms, plain_ms=plain_ms, **fields)
            note(f"B1 {name} (P={p}, K={kq}): {ms:.4f} ms, plain "
                 f"{plain_ms:.2f} ms, {100 * fields['bound_ms'] / ms:.2f}% "
                 f"of its {fields['bound_ms']:.4f} ms bound")
        log(f"kernel {name}: P={p} Kq={kq} Kc={kc} K={k} charge={charge} "
            f"shift={shift} ties={ties} tol={tol} variant={variant}: "
            f"identical ({n_match} matches, {n_pos:.1f} positive entries a "
            f"pair); kernel {ms:.4f} ms, "
            f"{100 * fields['bound_ms'] / ms:.2f}% of its "
            f"{fields['bound_ms']:.4f} ms bound, plain {plain_ms:.3f} ms; "
            f"branch {branch(k)}; {rule}{nonfinite}")
    if any(branch(max(c[2], c[3])) == "wide" for c in cases) \
            and not (rules > 0).all():
        raise AssertionError(f"B1 wide: pairs on the search and the dense "
                             f"rule {rules.tolist()}: both must be taken")
    note(f"{len(cases)} cases bit-identical; wide pairs on the search rule "
         f"{rules[0]}, on the dense rule {rules[1]}")
    record["cases"] = [c[0] for c in cases]
    return record


def stage1_work(arrays, n_shifts, shift, tol):
    """What B4's inputs need, from this run's arrays: (operations of the
    search design, operations of the old dense count, rows and pairs on
    each branch).  Operations: for a pair whose row ascends, a merge of
    its Kq query peaks with its n kept peaks in each window it has (the
    direct one; each shift when |prec_diff| >= tol): per step a
    subtraction and a compare, one subtraction more for a shift window;
    for any other row every query peak against every kept peak, per entry
    a subtraction and a compare a window; then Kq products and Kq adds.
    The maxima of passing entries are left out (data-dependent and few).
    The old count: Kq x Kc entries a pair, 5 operations an entry and
    window plus 2 (B1's matrix build)."""
    import torch

    from ann_solo_tpu_torch.ops import stage1_cuda

    q_mz, q_int, q_prec, lib_mz, lib_int, lib_ann, lib_prec, cand = arrays
    kq, kc = q_mz.shape[1], lib_mz.shape[1]
    valid = cand >= 0
    rows = torch.nonzero(valid)[:, 0]
    ids = cand[valid].clamp(max=lib_mz.shape[0] - 1)
    ascending = stage1_cuda.ascending_rows(lib_mz, lib_int)
    kept = (lib_int > 0).sum(1).to(torch.float64)[ids]
    n_shift = n_shifts - 1 if shift and n_shifts > 1 else 0
    chg = float(n_shifts - 1 if shift else 1)
    pd = (q_prec[rows] - lib_prec[ids]) * chg
    extra = n_shift * (pd.abs() >= torch.tensor(
        tol, dtype=torch.float32, device=pd.device)).to(torch.float64)
    fast = ascending[ids]
    ops = torch.where(fast, (kq + kept) * (2 + 3 * extra),
                      kq * kept * (2 + 2 * extra)).sum() + 2 * kq * len(ids)
    n_terms = n_shifts if shift else 1
    old = len(ids) * kq * kc * (5 * n_terms + 2)
    used = torch.unique(ids)
    n_fast_rows = int(ascending[used].sum())
    n_fast_pairs = int(fast.sum())
    return (float(ops), float(old), n_fast_rows, len(used) - n_fast_rows,
            n_fast_pairs, len(ids) - n_fast_pairs)


def stage1_b4_design(kq, kc):
    """Kernel B4's branch at these widths, and for the wide one its
    staging: a warp a pair, the row in chunks of at most WIDE_STAGE peaks
    in shared memory."""
    from ann_solo_tpu_torch.ops import stage1_cuda

    branch = stage1_cuda.branch(kq, kc)
    if branch != "wide":
        return branch
    stage = stage1_cuda.wide_stage(kc)
    return (f"wide (a warp a pair, rows staged in {-(-kc // stage)} "
            f"chunk(s) of <= {stage} peaks, "
            f"{stage1_cuda.wide_smem_bytes(kc)} B a block)")


def phase_stage1_kernel(dev, cases=STAGE1_CASES, kernel_reps=20,
                        plain_reps=2):
    """Phase 3d: kernel B4, through stage 1's routing
    (`rescore._stage1_bounds`: the kernel on the card, the plain version on
    the CPU), against its plain version on the same tensors: bounds equal
    bit for bit, -inf and NaN cells included.  Logs the rows and pairs on each of
    the kernel's branches (`stage1_cuda.ascending_rows`) and gates on both
    being taken over the phase.  Returns the record of the bench chunk
    (times) and the largest difference (0)."""
    import torch

    from ann_solo_tpu_torch.ops import stage1_cuda
    from ann_solo_tpu_torch.ops.rescore import (
        _stage1_bounds,
        stage1_bounds_plain,
    )

    if dev.type == "cuda":
        smem, per_sm = stage1_cuda.occupancy(K_PEAKS, K_PEAKS)
        log(f"B4 occupancy at Kq = Kc = {K_PEAKS}: {smem} bytes of dynamic "
            f"shared memory a block, {per_sm} blocks of "
            f"{stage1_cuda.SLOTS * stage1_cuda.WARPS // 32} warps an SM")
        note(f"B4 at K = {K_PEAKS}: {smem} B of shared memory a block, "
             f"{per_sm * stage1_cuda.SLOTS * stage1_cuda.WARPS // 32} warps "
             "an SM")
    rng = np.random.default_rng(3)
    record = {"max_abs_err": 0.0}
    branches = np.zeros(2, np.int64)  # rows on the range search, dense
    nan_cells = 0
    for name, b, c, n_lib, kq, kc, charge, shift, rows, *rest in cases:
        opts = dict(rest[0]) if rest else {}
        tol = opts.pop("tol", FRAG_TOL)
        arrays = [torch.from_numpy(a).to(dev) for a in synth_stage1(
            rng, b, c, n_lib, kq, kc, charge, rows, **opts)]
        n_shifts = charge + 1
        # The engine's chunk of the plain version
        # (`rescore_candidate_matrix`); the kernel takes the whole matrix.
        args = (*arrays, tol, n_shifts, shift, max(8, min(c, 65536 // b)))
        got = _stage1_bounds(*args)
        want = stage1_bounds_plain(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if not (torch.equal(torch.isinf(got), torch.isinf(want))
                and torch.equal(torch.isnan(got), torch.isnan(want))):
            raise AssertionError(f"B4 {name}: the -inf or NaN cells differ")
        finite = torch.isfinite(want)
        err = float((got[finite] - want[finite]).abs().max()) \
            if bool(finite.any()) else 0.0
        record["max_abs_err"] = max(record["max_abs_err"], err)
        n_nan = int(torch.isnan(want).sum())
        nan_cells += n_nan
        # Equal bit for bit, but for the sign and payload of a NaN.
        differ = (got != want) & ~torch.isnan(want)
        if bool(differ.any()):
            raise AssertionError(
                f"B4 {name}: kernel != plain, max |d| {err}, "
                f"{int(differ.sum())} cells differ")
        if opts.get("intensities") and not (
                n_nan > 0 and bool(torch.isposinf(want).any())):
            raise AssertionError(f"B4 {name}: {n_nan} NaN bounds and no "
                                 "+inf: the non-finite intensities miss")
        ms = time_ms(lambda: _stage1_bounds(*args), dev, kernel_reps)
        plain_ms = time_ms(lambda: stage1_bounds_plain(*args), dev,
                           plain_reps)
        # Bytes: the queries, the ids, the library rows referenced and the
        # output, each once.  Operations: what these inputs need
        # (`stage1_work`), at the f32 instruction rate.
        ops, old, fast_rows, dense_rows, fast_pairs, dense_pairs = \
            stage1_work(arrays, n_shifts, shift, tol)
        branches += (fast_rows, dense_rows)
        n_rows = fast_rows + dense_rows
        n_bytes = (tensor_bytes(*arrays[:3], arrays[7], got)
                   + n_rows * (kc * 12 + 4))
        fields = bound("B4", name, ms, n_bytes, ops, F32_INSTR_PER_S)
        old_ms = max(n_bytes / HBM_BYTES_PER_S, old / F32_FLOPS) * 1e3
        log(f"bound B4 {name}, the old dense count: {old:.4g} ops at "
            f"{F32_FLOPS:.3g} FLOP/s -> {old_ms:.4f} ms, "
            f"{100.0 * old_ms / ms:.2f}% of it")
        if name == cases[0][0]:
            record.update(ms=ms, plain_ms=plain_ms, **fields)
            note(f"B4 {name} ({b} x {c}, K={kq}): {ms:.4f} ms, plain "
                 f"{plain_ms:.2f} ms, {100 * fields['bound_ms'] / ms:.2f}% "
                 f"of its {fields['bound_ms']:.4f} ms bound, "
                 f"{100 * old_ms / ms:.2f}% of the old dense count's "
                 f"{old_ms:.4f} ms")
        log(f"kernel B4 {name}: B={b} C={c} N={n_lib} Kq={kq} Kc={kc} "
            f"shifts={n_shifts} shift={shift} rows={rows} tol={tol} "
            f"options={opts or 'none'}: identical "
            f"({fast_pairs + dense_pairs} valid pairs, {int(finite.sum())} "
            f"finite, {n_nan} NaN; branches: range search {fast_rows} rows / "
            f"{fast_pairs} pairs, dense {dense_rows} rows / {dense_pairs} "
            f"pairs); kernel {ms:.4f} ms, {100 * fields['bound_ms'] / ms:.2f}%"
            f" of its {fields['bound_ms']:.4f} ms bound, plain "
            f"{plain_ms:.3f} ms; branch {stage1_b4_design(kq, kc)}")
        if stage1_cuda.branch(kq, kc) == "wide":
            note(f"B4 {name}: {ms:.4f} ms")
        del arrays, args, got, want
    if not (branches > 0).all():
        raise AssertionError(f"B4: rows on the range search and the dense "
                             f"branch {branches.tolist()}: both must be "
                             "taken")
    note(f"{len(cases)} cases bit-identical, -inf and {nan_cells} NaN "
         f"cells included; rows on the range search {branches[0]}, on the "
         f"dense branch {branches[1]}")
    return record


def synth_probe_case(gen, dev, b, l, p, cap, d, storage, exact):
    """Kernel B2 inputs made on `dev` from `gen`: lists filled to a random
    count of slots (the rest empty, id -1), probe ids ascending.  Exact
    data: storage integers in [-4, 4] (int8) or their eighths (bf16),
    scale 1/8, queries integers / 64.  Otherwise unit-norm queries and
    rows of unit norm after the scale (int8 scale 1 / |row|, bf16 rows of
    norm about 1)."""
    import torch

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    dtype = torch.int8 if storage == "int8" else torch.bfloat16
    if exact:
        vals = torch.randint(-4, 5, (l, cap, d), generator=gen, device=dev,
                             dtype=torch.int8)
        vectors = vals if storage == "int8" else (vals / 8.0).to(dtype)
        scales = torch.full((l, cap), 0.125, device=dev)
        queries = torch.randint(-32, 33, (b, d), generator=gen,
                                device=dev) / 64.0
    else:
        if storage == "int8":
            vectors = torch.randint(-127, 128, (l, cap, d), generator=gen,
                                    device=dev, dtype=torch.int8)
            scales = 1.0 / torch.cat([  # chunked: no full float32 copy
                torch.linalg.vector_norm(vectors[s:s + 64].float(), dim=-1)
                for s in range(0, l, 64)
            ])
        else:
            vectors = (torch.randn((l, cap, d), generator=gen, device=dev)
                       / d ** 0.5).to(dtype)
            scales = torch.ones((l, cap), device=dev)
        queries = torch.randn((b, d), generator=gen, device=dev)
        queries = queries / torch.linalg.vector_norm(queries, dim=1,
                                                     keepdim=True)
    fill = (cap * (0.5 + 0.5 * rand(l))).long().clamp(1, cap)
    slot = torch.arange(cap, device=dev)
    ids = torch.where(
        slot[None, :] < fill[:, None],
        torch.arange(l * cap, device=dev).view(l, cap), -1,
    ).to(torch.int32)
    prec = torch.where(ids >= 0, 400.0 + 800.0 * rand(l, cap), 0.0)
    q_prec = 400.0 + 800.0 * rand(b)
    probe_ids = torch.sort(rand(b, l).topk(p, dim=1).indices, dim=1).values
    return (vectors.contiguous(), ids, prec, scales.float().contiguous(),
            queries.float().contiguous(), q_prec, probe_ids)


def probe_tolerance(vectors, scales, queries):
    """2 * D * 2^-24 * max|bf16(q)| * max|row * scale|: the largest
    difference two float32 summation orders can make in a lane
    (Cauchy-Schwarz bounds sum_d |q_d v_d| by the norms)."""
    import torch

    l, _, d = vectors.shape
    qn = torch.linalg.vector_norm(
        queries.to(torch.bfloat16).float(), dim=1).max()
    rn = max(
        float((torch.linalg.vector_norm(vectors[s:s + 64].float(), dim=-1)
               * scales[s:s + 64]).max())
        for s in range(0, l, 64)
    )
    return 2.0 * d * 2.0 ** -24 * float(qn) * rn


def phase_probe_kernel(dev, cases=PROBE_CASES, kernel_reps=20,
                       plain_reps=1):
    """Kernel B2 vs its plain version on the same tensors; returns the
    record of the first (2.1M tile) shape and the largest difference."""
    import torch

    from ann_solo_tpu_torch.ops import ivf_probe_cuda
    from ann_solo_tpu_torch.ops.ivf_probe import ivf_probe_scan_plain
    from ann_solo_tpu_torch.ops.ivf_probe_cuda import ivf_probe_scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    record = {"max_abs_err": 0.0}
    for (name, b, l, p, cap, d, storage, tol_val, tol_mode, exact,
         table) in cases:
        arrays = synth_probe_case(gen, dev, b, l, p, cap, d, storage, exact)
        vectors, ids, prec, scales, queries, q_prec, probe_ids = arrays
        if table == "clustered":
            probe_ids = probe_ids[:1].expand(b, -1).contiguous()
        elif table == "invalid":
            probe_ids = probe_ids.clone()
            probe_ids[0, 0] = -1
            probe_ids[-1, -1] = l
        args = (vectors, ids, prec, scales, queries, q_prec, float(CHARGE),
                probe_ids, tol_val, tol_mode)
        got = ivf_probe_scan(*args)
        want = ivf_probe_scan_plain(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        masked = torch.isneginf(want)
        if not torch.equal(torch.isneginf(got), masked):
            raise AssertionError(f"B2 masks differ at {name}")
        if table == "invalid" and not bool(
                masked[0, :cap].all() and masked[-1, -cap:].all()):
            raise AssertionError(f"B2 at {name}: an invalid id scored")
        err = float(torch.where(masked, 0.0, got - want).abs().max())
        tol = 0.0 if exact else probe_tolerance(vectors, scales, queries)
        if exact and not torch.equal(got, want):
            raise AssertionError(f"B2 != plain on exact data at {name}: "
                                 f"max |d| {err}")
        if err > tol:
            raise AssertionError(f"B2 vs plain at {name}: max |d| {err} > "
                                 f"tolerance {tol}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        ms = time_ms(lambda: ivf_probe_scan(*args), dev, kernel_reps)
        plain_ms = time_ms(lambda: ivf_probe_scan_plain(*args), dev,
                           plain_reps)
        # Each probed list once (rows, ids, prec, scales), queries, their
        # precursors and probe ids, and the (B, P * cap) output; a bf16
        # multiply-add for each probed slot and dimension.
        listed = probe_ids[(probe_ids >= 0) & (probe_ids < l)]
        n_lists = int(torch.unique(listed).numel())
        n_bytes = (n_lists * cap * (d * vectors.element_size() + 12)
                   + tensor_bytes(queries, q_prec, probe_ids, got))
        ops = 2.0 * b * p * cap * d
        fields = bound("B2", name, ms, n_bytes, ops, BF16_FLOPS)
        if name == cases[0][0]:
            record.update(ms=ms, plain_ms=plain_ms, **fields)
            note(f"B2 {name}: {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                 f"{100 * fields['bound_ms'] / ms:.2f}% of its "
                 f"{fields['bound_ms']:.4f} ms bound")
        log(f"B2 {name}: B={b} L={l} P={p} cap={cap} D={d} {storage} "
            f"window={tol_mode if tol_val > 0 else 'none'} probes={table}: "
            f"{n_lists} lists probed; masks identical "
            f"({float(masked.float().mean()):.3f} masked), max |d| {err:.3g} "
            f"(tolerance {tol:.3g}); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms")
        del arrays, vectors, args, got, want
    if dev.type == "cuda":
        lib = ivf_probe_cuda._library()
        for code, storage in ((0, "int8"), (1, "bf16")):
            log(f"B2 {storage}: {lib.ivf_probe_scan_smem_bytes(code)} bytes "
                "of shared memory a block, "
                f"{lib.ivf_probe_scan_resident_blocks(code)} blocks an SM")
    note(f"{len(cases)} cases: masks identical, max |d| "
         f"{record['max_abs_err']:.3g} within each case's tolerance")
    return record


def split_hot(probe_ids, h):
    """(cold, hot) halves of ascending probe ids: every (P / h)-th id is
    hot, so both halves stay ascending and disjoint; hot is None at h 0."""
    import torch

    if h == 0:
        return probe_ids, None
    step = probe_ids.shape[1] // h
    is_hot = torch.zeros(probe_ids.shape[1], dtype=torch.bool,
                         device=probe_ids.device)
    is_hot[torch.arange(h, device=probe_ids.device) * step] = True
    return (probe_ids[:, ~is_hot].contiguous(),
            probe_ids[:, is_hot].contiguous())


def phase_scan_kernel(dev, cases=SCAN_CASES, kernel_reps=5, plain_reps=1):
    """Kernel B3 vs its plain version on the same tensors, rows and the
    finished selection; returns the record of the first (2.1M tile)
    shape: times and the largest score difference of the finished
    selections."""
    import torch

    from ann_solo_tpu_torch.index.ivf import _key16
    from ann_solo_tpu_torch.ops.ivf_scan import (
        _KEY_NEG_INF,
        chunk_layout,
        ivf_chunked_scan_rows_plain,
        ivf_chunked_scan_select,
    )
    from ann_solo_tpu_torch.ops import ivf_scan_cuda
    from ann_solo_tpu_torch.ops.ivf_scan_cuda import ivf_chunked_scan_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    record = {"max_abs_err": 0.0}
    for (name, b, l, p, h, cap, d, storage, tol_val, tol_mode, k_scan,
         exact, clustered) in cases:
        arrays = synth_probe_case(gen, dev, b, l, p + h, cap, d, storage,
                                  exact)
        vectors, ids, prec, scales, queries, q_prec, probe_ids = arrays
        if clustered:  # every query probes query 0's lists
            probe_ids = probe_ids[:1].expand(b, -1).contiguous()
        cold, hot = split_hot(probe_ids, h)
        probed = torch.zeros((b, l), dtype=torch.uint8, device=dev)
        probed.scatter_(1, cold, 1)
        c, cw, _, n_chunks, pos_bits = chunk_layout(l, cap)
        args = (vectors, ids, prec, scales, queries, q_prec, float(CHARGE),
                probed, tol_val, tol_mode)
        rows = ivf_chunked_scan_rows(*args)
        want = ivf_chunked_scan_rows_plain(*args)
        sel_args = (vectors, ids, prec, scales, queries, q_prec,
                    float(CHARGE), cold, p, k_scan, tol_val, tol_mode)
        s_k, pos_k, f_k = ivf_chunked_scan_select(*sel_args, hot_ids=hot)
        s_p, pos_p, f_p = ivf_chunked_scan_select(
            *sel_args, hot_ids=hot, scan_rows=ivf_chunked_scan_rows_plain)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        def finite(r):
            return (r > -1) & ((r >> pos_bits) > _KEY_NEG_INF)

        if not (torch.equal(finite(rows), finite(want))
                and torch.equal(rows == -1, want == -1)):
            raise AssertionError(f"B3 finite-lane masks differ at {name}")
        same_rows = float((rows == want).all(-1).float().mean())
        clean = ~(f_k | f_p)
        both = clean[:, None] & torch.isfinite(s_k) & torch.isfinite(s_p)
        err = float(torch.where(both, s_k - s_p, 0.0).abs().max())
        same_lanes = float(((s_k == s_p) & (pos_k == pos_p))[clean].float()
                           .mean()) if bool(clean.any()) else 1.0
        key_step = int((_key16(s_k) - _key16(s_p))[clean].abs().max()) \
            if bool(clean.any()) else 0
        if exact and not (torch.equal(rows, want) and torch.equal(s_k, s_p)
                          and torch.equal(pos_k, pos_p)
                          and torch.equal(f_k, f_p)):
            raise AssertionError(
                f"B3 != plain on exact data at {name}: {same_rows} of rows "
                f"equal, {same_lanes} of lanes")
        if same_rows < 0.99 or same_lanes < 0.999 or key_step > 1:
            raise AssertionError(
                f"B3 vs plain at {name}: {same_rows} of rows equal, "
                f"{same_lanes} of lanes, key16 step {key_step}")
        if h == 0 and not bool(f_k.any()):
            raise AssertionError(f"B3 at {name}: no certificate fired")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        ms = time_ms(lambda: ivf_chunked_scan_rows(*args), dev, kernel_reps)
        plain_ms = time_ms(lambda: ivf_chunked_scan_rows_plain(*args), dev,
                           plain_reps)
        # Each chunk some query probes read once (rows, ids, prec,
        # scales), the queries, precursors and bitmap, and the rows out;
        # a bf16 multiply-add for each slot and dimension of each probed
        # (query, chunk) pair.
        hit = probed.view(b, n_chunks, c).amax(2) > 0
        n_bytes = (int(hit.any(0).sum()) * cw
                   * (d * vectors.element_size() + 12)
                   + tensor_bytes(queries, q_prec, probed, rows))
        ops = 2.0 * int(hit.sum()) * cw * d
        fields = bound("B3", name, ms, n_bytes, ops, BF16_FLOPS)
        if dev.type == "cuda":
            lib = ivf_scan_cuda._library()
            code = 0 if storage == "int8" else 1
            log(f"B3 {name}: {lib.ivf_chunked_scan_smem_bytes(code, cw, c)} "
                "bytes of shared memory a block, "
                f"{lib.ivf_chunked_scan_resident_blocks(code, cw, c)} "
                "blocks an SM")
        if name == cases[0][0]:
            record.update(ms=ms, plain_ms=plain_ms, **fields)
            note(f"B3 {name}: {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                 f"{100 * fields['bound_ms'] / ms:.2f}% of its "
                 f"{fields['bound_ms']:.4f} ms bound")
        log(f"B3 {name}: B={b} L={l} P={p}+{h} hot cap={cap} D={d} "
            f"{storage} window={tol_mode if tol_val > 0 else 'none'} "
            f"k_scan={k_scan}{' clustered' if clustered else ''}: "
            f"{int(hit.sum())} probed (query, chunk) pairs of "
            f"{b * n_chunks}; masks identical, rows equal {same_rows:.5f}, "
            f"select lanes equal {same_lanes:.5f} (key16 step {key_step}, "
            f"max |d score| {err:.3g}), flagged {float(f_k.float().mean()):.4f}"
            f" / plain {float(f_p.float().mean()):.4f}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        del arrays, vectors, args, sel_args, rows, want
    note(f"{len(cases)} cases: finite masks identical, exact cases "
         "bit-identical, selections within one key16 step")
    return record


def _lehmer(h):
    """One step of the Park-Miller generator on int64 values in
    [1, 2^31 - 2]: a hash without int64 overflow."""
    return h * 48271 % 2147483647


def synth_select_case(gen, dev, b, l, p, cap, kind):
    """Kernel B5 inputs made on `dev` from `gen`: (flat, probe_ids,
    padded_ids).  padded_ids: a permutation of the ids over the (L, cap)
    slots ("copies": each id twice, as x2 storage holds it), 10% of the
    slots empty (-1); probe_ids ascending.  A lane's score and window mask
    are hashes of (row, id), so both copies of an id carry the same score:
    257 levels in [0.2, 0.7] ("ties": one value), 30% of the ids masked
    ("masked": odd rows keep about 500 finite lanes, even rows none)."""
    import torch

    slots = l * cap
    if kind == "unique":
        ids = torch.randperm(slots, generator=gen, device=dev)
    else:
        half = slots // 2
        ids = torch.cat([torch.randperm(half, generator=gen, device=dev),
                         torch.randperm(slots - half, generator=gen,
                                        device=dev) % half])
    empty = torch.rand(slots, generator=gen, device=dev) < 0.1
    padded_ids = torch.where(empty, -1, ids).to(torch.int32).view(l, cap)
    probe_ids = torch.sort(torch.rand((b, l), generator=gen, device=dev)
                           .topk(p, dim=1).indices, dim=1).values
    lane_ids = padded_ids[probe_ids].view(b, p * cap).to(torch.int64)
    row = torch.arange(b, device=dev)[:, None]
    h = _lehmer(_lehmer((row * 1000003 + lane_ids * 7919) % 2147483629
                        + 1))
    score = 0.2 + torch.round(h.to(torch.float64) / 2 ** 31 * 256) / 512
    h = _lehmer(h)
    finite = (h.to(torch.float64) / 2 ** 31) >= 0.3
    if kind == "ties":
        score = torch.full_like(score, 0.5)
    elif kind == "masked":
        share = 500.0 / (p * cap)
        finite = (h.to(torch.float64) / 2 ** 31 < share) & (row % 2 == 1)
    flat = torch.where((lane_ids >= 0) & finite, score.to(torch.float32),
                       float("-inf"))
    return flat.contiguous(), probe_ids.contiguous(), padded_ids


def phase_select_kernel(dev, cases=SELECT_CASES, kernel_reps=10,
                        plain_reps=2):
    """Phase 3e: kernel B5, through its routing
    (`ops/canonical_select.py::canonical_select`: the kernel on the card),
    against `canonical_select_plain` on the same tensors: scores (as bits)
    and ids identical.  Beside each: the time of `torch.topk` on the
    packed int64 keys (what `canonical_topk` calls; the port's card route
    never does), the library's yardstick.  Returns the record of the
    bench's 512-candidate case."""
    import torch

    from ann_solo_tpu_torch.ops import select_cuda
    from ann_solo_tpu_torch.ops.canonical_select import (
        canonical_select,
        canonical_select_plain,
    )
    from ann_solo_tpu_torch.ops.ivf_scan import _key16

    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    record = {"max_abs_err": 0.0}
    for name, b, l, p, cap, k_sel, k, redundant, kind in cases:
        flat, probe_ids, padded_ids = synth_select_case(gen, dev, b, l, p,
                                                        cap, kind)
        args = (flat, probe_ids, padded_ids, k_sel, k, redundant)
        got_s, got_i = canonical_select(*args)
        want_s, want_i = canonical_select_plain(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        both = torch.isfinite(got_s) & torch.isfinite(want_s)
        err = float(torch.where(both, got_s - want_s, 0.0).abs().max())
        record["max_abs_err"] = max(record["max_abs_err"], err)
        if not (torch.equal(got_s.view(torch.int32),
                            want_s.view(torch.int32))
                and torch.equal(got_i, want_i)):
            raise AssertionError(
                f"B5 != plain at {name}: "
                f"{int((got_i != want_i).sum())} ids and "
                f"{int((got_s.view(torch.int32) != want_s.view(torch.int32)).sum())}"
                f" scores differ, max |d| {err}")
        n = p * cap
        k_eff = min(k_sel, n)
        ms = time_ms(lambda: canonical_select(*args), dev, kernel_reps)
        plain_ms = time_ms(lambda: canonical_select_plain(*args), dev,
                           plain_reps)
        lane_rev = torch.arange(n - 1, -1, -1, device=dev)
        packed = ((_key16(flat) + 1) << 32) | lane_rev[None, :]
        library_ms = time_ms(lambda: torch.topk(packed, k_eff, dim=1),
                             dev, kernel_reps)
        del packed, lane_rev
        # Bytes: the f32 lanes and int64 probe table read once, an int32
        # id a selected lane, the f32 scores and int32 ids written.  Operations: a key, its compare and
        # a count for each lane, about 8 integer instructions.
        n_bytes = b * (4 * n + 8 * p + 4 * k_eff + 8 * k)
        fields = bound("B5", name, ms, n_bytes, 8.0 * b * n,
                       INT32_INSTR_PER_S)
        if name == cases[0][0]:
            record.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          **fields)
            note(f"B5 {name} ({b} x {n} lanes, k_sel {k_sel}): {ms:.4f} "
                 f"ms, plain {plain_ms:.2f} ms, torch.topk "
                 f"{library_ms:.4f} ms, {100 * fields['bound_ms'] / ms:.2f}%"
                 f" of its {fields['bound_ms']:.4f} ms bound")
        n_out = int((want_i >= 0).sum())
        branch, smem = select_cuda.plan(n, k_eff)
        if dev.type == "cuda":
            built = select_cuda.occupancy(n, k_sel)
            if built[:2] != (branch, smem):
                raise AssertionError(f"B5 {name}: the kernel plans {built[:2]}"
                                     f", the wrapper {(branch, smem)}")
            blocks = built[2]
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        else:
            blocks, sms = "not measured", 132
        if branch.startswith("wide"):
            # The wide design this case takes: passes 1-3 on one block a
            # row or split over several, the sort and dedup on one block a
            # row (in shared memory) or over tiles of items.
            group, tiles = select_cuda.wide_grid(b, n, k_eff, sms)
            branch += (f" (passes 1-3 on {tiles} blocks a row, sort and "
                       + ("dedup on one block a row"
                          if k_eff <= select_cuda.ROW_TAIL
                          else f"dedup over tiles of {select_cuda.ITEM_TILE}"
                          " items") + f", {group} rows a group)")
            note(f"B5 {name}: {ms:.4f} ms vs torch.topk {library_ms:.4f} "
                 "ms")
        log(f"kernel B5 {name}: B={b} L={l} P={p} cap={cap} ({n} lanes) "
            f"k_sel={k_sel} k={k} redundant={redundant} kind={kind}: "
            f"identical ({float(torch.isfinite(flat).float().mean()):.3f} "
            f"finite lanes, {n_out} ids out of {b * k}); kernel "
            f"{ms:.4f} ms, {100 * fields['bound_ms'] / ms:.2f}% of its "
            f"{fields['bound_ms']:.4f} ms bound, plain {plain_ms:.3f} ms, "
            f"torch.topk {library_ms:.4f} ms; branch {branch}, {smem} bytes "
            f"of dynamic shared memory a block, {blocks} blocks an SM")
        del flat, probe_ids, padded_ids, args, got_s, got_i, want_s, want_i
    note(f"{len(cases)} cases bit-identical (scores as bits, ids)")
    return record


def _check_outputs(best, score, n_cands, matches, n_lib, n_q,
                   num_candidates=NUM_CANDIDATES):
    assert best.shape == score.shape == n_cands.shape == (n_q,)
    assert np.all((best >= -1) & (best < n_lib))
    hit = best >= 0
    assert np.all(np.isfinite(score[hit])) and np.all(score[hit] >= 0)
    assert np.all(n_cands[hit] > 0) and np.all(n_cands <= num_candidates)
    assert len(matches) == int(hit.sum())
    for m in matches.values():
        assert m.ndim == 2 and m.shape[1] == 2
        assert np.all((m >= 0) & (m < K_PEAKS))
        assert len(np.unique(m[:, 0])) == len(m) == len(np.unique(m[:, 1]))


def phase_slice(dev, n_lib=N_LIBRARY, n_q=N_QUERIES, n_batches=N_BATCHES):
    """Phase 4: the bench workload through `ann_solo_tpu_torch.bench.run`
    (what ``python -m ann_solo_tpu_torch.bench`` prints), then its select
    on batch 0 against the plain full scan (`fullscan_vs_plain`), at 512
    candidates and at 4,096 (`wide_select_vs_plain`: B5's wide branch, its
    launches counted with B5's).  Returns B1's, B2's, B4's and B5's
    launches of the run and the index, library and settings for phase 5."""
    import torch

    from ann_solo_tpu_torch import bench
    from ann_solo_tpu_torch.ops import ivf_probe_cuda, select_cuda, \
        shifted_dot_cuda, stage1_cuda

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    shifted_dot_cuda.LAUNCHES = 0
    ivf_probe_cuda.LAUNCHES = 0
    stage1_cuda.LAUNCHES = 0
    select_cuda.LAUNCHES = 0
    out = bench.run(n_library=n_lib, n_queries=n_q, n_batches=n_batches,
                    device=dev)
    launches = shifted_dot_cuda.LAUNCHES
    b2_launches = ivf_probe_cuda.LAUNCHES
    b4_launches = stage1_cuda.LAUNCHES
    b5_launches = select_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result, hit_rates = out["result"], out["hit_rates"]
    log("slice: " + json.dumps({
        "bench": result, "self_match_hit_rates": hit_rates,
        "max_memory_allocated_bytes": peak, "b1_launches": launches,
        "b2_launches": b2_launches, "b4_launches": b4_launches,
        "b5_launches": b5_launches}))
    stages = result["stages_sec_per_batch"]
    note(f"{result['value']:.2f} q/s ({n_q} queries x {n_batches}, "
         f"{result['num_candidates']} candidates)",
         "a batch: vectorize {vectorize:.4f} + select {ann_select:.4f} + "
         "rescore {rescore:.4f} s".format(**stages),
         f"{result['ref_default_num_candidates']} candidates "
         f"{result['ref_default_queries_per_sec']:.2f} q/s",
         f"hit rates {min(hit_rates):.4f}-{max(hit_rates):.4f}",
         f"build {result['ivf_build_sec_cold']:.2f} s cold, "
         f"{result['ivf_build_sec']:.2f} s again",
         f"peak {peak} bytes",
         f"B1 launched {launches}, B2 {b2_launches}, B4 {b4_launches}, "
         f"B5 {b5_launches}")
    if min(hit_rates) < HIT_RATE_GATE or not result["hit_rate_gate_passed"]:
        raise AssertionError(f"self-match hit rate {hit_rates} < gate")
    if dev.type == "cuda" and min(launches, b2_launches, b4_launches,
                                  b5_launches) <= 0:
        raise AssertionError(f"B1 launched {launches}, B2 {b2_launches}, "
                             f"B4 {b4_launches}, B5 {b5_launches}")
    b5_launches += fullscan_vs_plain(dev, out)
    return launches, b2_launches, b4_launches, b5_launches, out["index"], \
        out["lib"], out["lib_arrays"], out["params"]


def fullscan_vs_plain(dev, out, k=NUM_CANDIDATES, reps=5):
    """The bench's select on batch 0 (`search_device`: on the card the
    probe path, B2 then B5) against the plain full scan
    (`_ivf_search_fullscan`, the dense f32 product over every list) on the
    same device: >= 99.9% of (id, score) lanes equal, every 16-bit key
    within one step, no duplicate ids.  Logs the select's split on one
    super-tile (coarse product, probe sort, B2, B5; CUDA events) and
    each super-tile's share of the batch.  Then the same at 4,096
    candidates (`wide_select_vs_plain`), whose B5 launches it returns."""
    import torch

    from ann_solo_tpu_torch.index import ivf
    from ann_solo_tpu_torch.models.vectorize import (
        device_tables,
        vectorize_batch,
    )
    from ann_solo_tpu_torch.ops.canonical_select import canonical_select
    from ann_solo_tpu_torch.ops.ivf_probe_cuda import ivf_probe_scan
    from ann_solo_tpu_torch.ops.topk import stable_topk_desc

    index, params = out["index"], out["params"]
    _, q_mz, q_int, q_prec = out["batches"][0]
    b = len(q_mz)
    tables = device_tables(params.vectorize, dev)
    queries = vectorize_batch(
        params.vectorize, tables, torch.from_numpy(q_mz).to(dev),
        torch.from_numpy(q_int).to(dev),
        torch.full((b,), K_PEAKS, dtype=torch.int32, device=dev))
    qp = torch.from_numpy(q_prec.astype(np.float32)).to(dev)
    window = dict(q_prec=qp, charge=float(CHARGE), tol_val=OPEN_TOL_DA,
                  tol_mode="Da")
    p = min(index.num_probe, index.num_list)
    args = (float(CHARGE), index.num_probe, k, index.redundancy * k,
            OPEN_TOL_DA, "Da", index.redundancy > 1)
    blocks = index._blocks()

    def select_peak(fn):
        """fn's result and the device memory it allocated at its peak
        above what was allocated before it."""
        if dev.type != "cuda":
            return fn(), 0
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        return out, torch.cuda.max_memory_allocated(dev) - base

    (ids, scores), peak = select_peak(
        lambda: index.search_device(queries, k, **window))
    select_ms = time_ms(lambda: index.search_device(queries, k, **window),
                        dev, reps)
    (p_s, p_ids), plain_peak = select_peak(lambda: ivf._ivf_search_fullscan(
        index.scan_block(), *blocks[1:], queries, qp, *args, True))
    plain_ms = time_ms(lambda: ivf._ivf_search_fullscan(
        index.scan_block(), *blocks[1:], queries, qp, *args, True), dev, 1)
    index._scan_block = None
    same = float(((ids == p_ids.to(torch.int32)) & (scores == p_s))
                 .float().mean())
    key_step = int((ivf._key16(scores) - ivf._key16(p_s)).abs().max())
    dups = _has_duplicates(ids)
    # The split, on the first super-tile of the probe path.
    tq = min(ivf._CHUNK_TQ, b)
    qt, qpt = queries[:tq], qp[:tq]
    centroids = index.centroids
    coarse = qt @ centroids.T
    probe_ids = torch.sort(stable_topk_desc(coarse, p)[1], dim=1).values
    flat = ivf_probe_scan(*blocks[:4], qt, qpt, float(CHARGE), probe_ids,
                          OPEN_TOL_DA, "Da")
    k_eff = min(index.redundancy * k, p * index.padded_ids.shape[1])
    split = {
        "coarse": time_ms(lambda: qt @ centroids.T, dev, reps),
        "probe_sort": time_ms(lambda: torch.sort(
            stable_topk_desc(coarse, p)[1], dim=1).values, dev, reps),
        "b2": time_ms(lambda: ivf_probe_scan(
            *blocks[:4], qt, qpt, float(CHARGE), probe_ids, OPEN_TOL_DA,
            "Da"), dev, reps),
        "b5": time_ms(lambda: canonical_select(
            flat, probe_ids, index.padded_ids, k_eff, k,
            index.redundancy > 1), dev, reps),
    }
    del flat, coarse
    tiles = -(-b // tq)
    log("fullscan vs plain: " + json.dumps({
        "queries": b, "super_tile": tq, "super_tiles": tiles,
        "same_lanes": same, "max_key16_step": key_step,
        "duplicates": dups, "select_ms": select_ms,
        "plain_fullscan_ms": plain_ms,
        "select_peak_bytes_above_base": peak,
        "plain_fullscan_peak_bytes_above_base": plain_peak,
        "split_ms_a_super_tile": split,
        "split_ms_a_batch": {name: v * tiles for name, v in split.items()},
    }))
    note(f"select on the card {select_ms:.2f} ms a batch (plain full scan "
         f"{plain_ms:.2f} ms): a super-tile of {tq} coarse "
         f"{split['coarse']:.3f} + probe sort {split['probe_sort']:.3f} + "
         f"B2 {split['b2']:.3f} + B5 {split['b5']:.3f} ms, x{tiles}",
         f"lanes vs plain full scan {same:.5f}, key16 step {key_step}",
         f"select peak {peak} bytes above its base (plain full scan "
         f"{plain_peak}, its f32 copy of the lists built in the call)")
    if same < 0.999 or key_step > 1 or dups:
        raise AssertionError(
            f"bench select vs the plain full scan: {same} lanes equal, "
            f"key16 step {key_step}, duplicates {dups}")
    return wide_select_vs_plain(dev, index, queries, qp, window, reps)


def wide_select_vs_plain(dev, index, queries, qp, window, reps,
                         k=WIDE_SELECT_CANDIDATES):
    """The bench's select on batch 0 at `k` candidates, what ``--
    num_candidates 4096`` asks of the open level: k_sel = redundancy * k
    (8,192 at x2) of each query's 49,152 lanes, B5's wide branch on the
    card, through `search_device` as the main path calls it, against the
    plain full scan on the same device (>= 99.9% of (id, score) lanes
    equal, every 16-bit key within one step, no duplicate ids).  Returns
    B5's launches in the select (counted from 0 around it)."""
    import torch

    from ann_solo_tpu_torch.index import ivf
    from ann_solo_tpu_torch.ops import select_cuda

    p = min(index.num_probe, index.num_list)
    n = p * index.padded_ids.shape[1]
    k_eff = min(index.redundancy * k, n)
    branch = select_cuda.plan(n, k_eff)[0]
    if not branch.startswith("wide"):
        raise AssertionError(f"{k} candidates: B5's {branch} branch, not "
                             "the wide one")
    select_cuda.LAUNCHES = 0
    ids, scores = index.search_device(queries, k, **window)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = select_cuda.LAUNCHES
    select_ms = time_ms(lambda: index.search_device(queries, k, **window),
                        dev, reps)
    blocks = index._blocks()
    args = (float(CHARGE), index.num_probe, k, index.redundancy * k,
            OPEN_TOL_DA, "Da", index.redundancy > 1)
    p_s, p_ids = ivf._ivf_search_fullscan(
        index.scan_block(), *blocks[1:], queries, qp, *args, True)
    index._scan_block = None
    same = float(((ids == p_ids.to(torch.int32)) & (scores == p_s))
                 .float().mean())
    key_step = int((ivf._key16(scores) - ivf._key16(p_s)).abs().max())
    dups = _has_duplicates(ids)
    filled = float((ids >= 0).float().mean())
    log("wide select vs plain: " + json.dumps({
        "candidates": k, "k_sel": k_eff, "lanes_a_row": n, "branch": branch,
        "b5_launches": launches, "select_ms": select_ms, "same_lanes": same,
        "max_key16_step": key_step, "duplicates": dups,
        "filled_share": filled}))
    note(f"select at {k} candidates (k_sel {k_eff} of {n} lanes, B5 "
         f"{branch}, {launches} launches): {select_ms:.2f} ms a batch, "
         f"lanes vs plain full scan {same:.5f}, key16 step {key_step}")
    if same < 0.999 or key_step > 1 or dups:
        raise AssertionError(
            f"select at {k} candidates vs the plain full scan: {same} lanes "
            f"equal, key16 step {key_step}, duplicates {dups}")
    if dev.type == "cuda" and launches <= 0:
        raise AssertionError(f"select at {k} candidates: B5 launched "
                             f"{launches} times")
    return launches


def synth_raw(rng, lib_arrays, n):
    """Raw (unprocessed) spectra: a library row's peaks with m/z noise and
    scaled intensities, plus weaker random noise peaks, m/z sorted."""
    lib_mz, lib_int, _, lib_prec = lib_arrays
    rows = rng.choice(len(lib_mz), n, replace=False)
    k = lib_mz.shape[1]
    n_noise = 100
    mz = np.concatenate([
        lib_mz[rows] + rng.normal(0, 0.005, (n, k)),
        rng.uniform(101, 1500, (n, n_noise)),
    ], 1).astype(np.float32)
    intensity = np.concatenate([
        2000.0 * lib_int[rows], rng.uniform(1.0, 10.0, (n, n_noise)),
    ], 1).astype(np.float32)
    n_peaks = rng.integers(k + n_noise // 2, k + n_noise + 1, n)
    # Drop a random tail of noise peaks, then sort each row by m/z.
    lane = np.arange(k + n_noise)[None, :]
    mz = np.where(lane < n_peaks[:, None], mz, np.float32(np.inf))
    order = np.argsort(mz, axis=1, kind="stable")
    mz = np.take_along_axis(mz, order, 1)
    intensity = np.take_along_axis(intensity, order, 1)
    mz[lane >= n_peaks[:, None]] = 0.0
    intensity[lane >= n_peaks[:, None]] = 0.0
    prec = (lib_prec[rows] + rng.normal(0, 0.002, n)).astype(np.float32)
    return rows, mz, intensity, n_peaks.astype(np.int32), prec


def phase_preprocess(dev, index, lib, lib_arrays, params, n=N_QUERIES):
    import torch

    from ann_solo_tpu_torch.models.preprocess import (
        PreprocessParams,
        preprocess_batch,
    )
    from ann_solo_tpu_torch.search import ann_open_search_batch

    rng = np.random.default_rng(7)
    rows, mz, intensity, n_peaks, prec = synth_raw(rng, lib_arrays, n)
    raw = (mz, intensity, np.zeros(mz.shape, np.int32), n_peaks, prec,
           np.full(n, CHARGE, np.int32))
    pp = PreprocessParams(max_peaks_used=K_PEAKS)
    out = {}
    for d in (dev, torch.device("cpu")):
        out[d.type] = preprocess_batch(
            pp, *(torch.from_numpy(a).to(d) for a in raw)
        )
    a, b = out[dev.type], out["cpu"]
    for field in ("mz", "n_peaks", "ann_charge", "is_valid"):
        if not torch.equal(getattr(a, field).cpu(), getattr(b, field)):
            raise AssertionError(f"preprocess {field} differs CUDA vs CPU")
    torch.testing.assert_close(a.intensity.cpu(), b.intensity, rtol=0,
                               atol=1e-6)
    best, score, n_cands, matches = ann_open_search_batch(
        index, lib, a.mz, a.intensity, a.n_peaks, prec, CHARGE, params
    )
    _check_outputs(best, score, n_cands, matches, len(lib_arrays[0]), n)
    hit = float(np.mean(best == rows))
    log(f"preprocess: {n} raw spectra, {int(a.is_valid.sum())} valid, "
        f"CUDA == CPU; search self-match hit rate {hit:.4f}")
    note(f"{n} raw spectra, {int(a.is_valid.sum())} valid, CUDA == CPU",
         f"search hit rate {hit:.4f}")
    if hit < HIT_RATE_GATE:
        raise AssertionError(f"preprocessed hit rate {hit} < gate")


def phase_cuda_vs_cpu(dev, n_lib=16384, n_q=256):
    import torch

    from ann_solo_tpu_torch.bench import synth_library, synth_queries
    from ann_solo_tpu_torch.convert import (
        ivf_index_from_numpy,
        library_from_numpy,
        to_numpy,
    )
    from ann_solo_tpu_torch.index.ivf import IvfIndex
    from ann_solo_tpu_torch.models.vectorize import (
        VectorizeParams,
        device_tables,
        vectorize_batch,
    )
    from ann_solo_tpu_torch.search import (
        OpenSearchParams,
        ann_open_search_batch,
    )

    rng = np.random.default_rng(11)
    lib_arrays = synth_library(rng, n_lib)
    lib_mz, lib_int, lib_ann, lib_prec = lib_arrays
    vp = VectorizeParams(11.0, 2010.0, 0.04, HASH_LEN)
    params = OpenSearchParams(vectorize=vp, num_candidates=NUM_CANDIDATES,
                              precursor_tolerance_mass_open=OPEN_TOL_DA,
                              fragment_mz_tolerance=FRAG_TOL)
    vectors = vectorize_batch(
        vp, device_tables(vp, dev), torch.from_numpy(lib_mz).to(dev),
        torch.from_numpy(lib_int).to(dev),
        torch.full((n_lib,), K_PEAKS, device=dev),
    )
    built = IvfIndex.build(
        vectors, BenchConfig(), precursor_mz=lib_prec.astype(np.float32),
        storage_dtype=torch.int8, device=dev,
    )
    arrays = to_numpy(built)
    _, q_mz, q_int, q_prec = synth_queries(rng, lib_arrays, n_q)
    q_n = np.full(n_q, K_PEAKS, np.int32)
    results, seconds = {}, {}
    for d in (dev, torch.device("cpu")):
        index = ivf_index_from_numpy(
            arrays["centroids"], arrays["padded_vectors"],
            arrays["padded_ids"], arrays["padded_prec"],
            arrays["padded_scales"], arrays["num_probe"],
            arrays["redundancy"], d,
        )
        lib = library_from_numpy(lib_mz, lib_int, lib_ann, lib_prec, d)
        t0 = time.perf_counter()
        results[d.type] = ann_open_search_batch(
            index, lib, q_mz, q_int, q_n, q_prec, CHARGE, params
        )
        seconds[d.type] = time.perf_counter() - t0
        log(f"cuda-vs-cpu: {d.type} slice {seconds[d.type]:.2f}s")
    g_best, g_score, _, g_match = results[dev.type]
    c_best, c_score, _, c_match = results["cpu"]
    same = g_best == c_best
    frac = float(np.mean(same))
    log(f"cuda-vs-cpu: {n_lib}-spectrum index, {n_q} queries: same best "
        f"index for {frac:.4f}")
    note(f"{n_lib}-spectrum index, {n_q} queries: same best index for "
         f"{frac:.4f}", f"card {seconds[dev.type]:.2f} s, CPU "
         f"{seconds['cpu']:.2f} s")
    if frac < 0.999:
        raise AssertionError(f"CUDA vs CPU best index agree on {frac}")
    np.testing.assert_allclose(g_score[same], c_score[same], rtol=1e-5)
    for row in np.nonzero(same & (g_best >= 0))[0]:
        got = {tuple(m) for m in g_match[int(row)].tolist()}
        exp = {tuple(m) for m in c_match[int(row)].tolist()}
        if got != exp:
            raise AssertionError(f"CUDA vs CPU matches differ, query {row}")


def synth_library_torch(gen, n, dev, k=K_PEAKS):
    """`synth_library` made on `dev` from `gen` (same distributions)."""
    import torch

    mz = torch.sort(101.0 + 1399.0 * torch.rand(
        (n, k), generator=gen, device=dev), dim=1).values
    intensity = 0.1 + 0.9 * torch.rand((n, k), generator=gen, device=dev)
    intensity = intensity / torch.linalg.vector_norm(intensity, dim=1,
                                                     keepdim=True)
    ann = torch.randint(0, CHARGE + 1, (n, k), generator=gen, device=dev,
                        dtype=torch.int32)
    prec = 400.0 + 800.0 * torch.rand(n, generator=gen, device=dev,
                                      dtype=torch.float64)
    order = torch.sort(prec, stable=True).indices
    return mz[order], intensity[order], ann[order], prec[order]


def synth_queries_torch(gen, lib, n_q):
    """`synth_queries` made on the library's device from `gen`."""
    import torch

    lib_mz, lib_int, _, lib_prec = lib
    n, k = lib_mz.shape
    dev = lib_mz.device
    rows = torch.randperm(n, generator=gen, device=dev)[:n_q]
    q_mz = lib_mz[rows] + 0.005 * torch.randn(
        (n_q, k), generator=gen, device=dev)
    q_int = (lib_int[rows] + 0.02 * torch.randn(
        (n_q, k), generator=gen, device=dev)).abs()
    q_int = q_int / torch.linalg.vector_norm(q_int, dim=1, keepdim=True)
    q_prec = lib_prec[rows] + 0.002 * torch.randn(
        n_q, generator=gen, device=dev, dtype=torch.float64)
    return (rows.cpu().numpy(), torch.sort(q_mz, dim=1).values, q_int,
            q_prec.cpu().numpy())


def big_params():
    """Open-search settings of the big-library phases (7, 8, 10b)."""
    from ann_solo_tpu_torch.models.vectorize import VectorizeParams
    from ann_solo_tpu_torch.search import OpenSearchParams

    return OpenSearchParams(
        vectorize=VectorizeParams(11.0, 2010.0, 0.04, HASH_LEN),
        num_candidates=BIG_CANDIDATES,
        precursor_tolerance_mass_open=OPEN_TOL_DA,
        precursor_tolerance_mode_open="Da",
        fragment_mz_tolerance=FRAG_TOL,
        allow_peak_shifts=True,
    )


def phase_big_slice(dev, n_lib=N_BIG, n_q=BIG_QUERIES, n_batches=N_BATCHES,
                    config=ScaleConfig):
    """The big-library slice through the port's entry points: the library
    made and vectorized on the card, the in-memory build, the probe path
    against the per-query oracle (`big_library_search`), the index file
    round trip, then one batch under torch.profiler."""
    import torch

    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index.ivf import IvfIndex
    from ann_solo_tpu_torch.models.vectorize import (
        device_tables,
        vectorize_batch,
    )

    params = big_params()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4242)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lib_arrays = synth_library_torch(gen, n_lib, dev)
    lib_mz, lib_int, _, lib_prec = lib_arrays
    tables = device_tables(params.vectorize, dev)
    n_peaks = torch.full((n_lib,), K_PEAKS, device=dev)
    chunk = 65536
    lib_vectors = torch.cat([
        vectorize_batch(params.vectorize, tables, lib_mz[s:s + chunk],
                        lib_int[s:s + chunk], n_peaks[s:s + chunk])
        for s in range(0, n_lib, chunk)
    ])
    synchronize(dev)
    t_lib = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = IvfIndex.build(
        lib_vectors, config(), precursor_mz=lib_prec.to(torch.float32),
        storage_dtype=torch.int8, device=dev,
    )
    synchronize(dev)
    t_build = time.perf_counter() - t0
    del lib_vectors  # the f32 source block: the search reads the int8 lists
    build_peak = 0
    if dev.type == "cuda":
        build_peak = torch.cuda.max_memory_allocated(dev)
    l, cap, d = index.padded_vectors.shape
    log(f"big library: {n_lib} spectra made and vectorized in {t_lib:.3f}s; "
        f"IVF build {t_build:.3f}s ({l} lists x cap {cap} x {d}, int8, "
        f"x{index.redundancy}, num_probe {index.num_probe})")
    note(f"build {t_build:.2f} s, peak {build_peak} bytes")
    big = big_library_search(
        dev, "big slice", index, lib_arrays, params, gen, n_q, n_batches,
        {"library_make_vectorize_sec": t_lib, "ivf_build_sec": t_build,
         "build_max_memory_allocated_bytes": build_peak})
    big["build_sec"], big["build_peak"] = t_build, build_peak

    def select_batch0(idx):
        vectors, qp = big["embed"](big["batches"][0])
        return idx.search_device(
            vectors, BIG_CANDIDATES, q_prec=qp, charge=float(CHARGE),
            tol_val=OPEN_TOL_DA, tol_mode="Da")

    index_file_round_trip(dev, index, select_batch0, big["probe"])
    profile_batch(dev, "probe path, last batch",
                  lambda: big["run"](big["batches"][-1]))
    return big


def _has_duplicates(ids):
    """Whether a row of (B, k) ids holds one id (not -1) twice."""
    srt = ids.sort(dim=1).values
    return bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any())


def big_library_search(dev, name, index, lib_arrays, params, gen, n_q,
                       n_batches, extra):
    """Timed open-search batches on a big library's index and their gates.

    `n_batches` batches of `n_q` noised library rows (plus a warm-up)
    through `ann_open_search_batch`, counting B2's launches; batch 0's
    select against the per-query oracle on the card.  Logs one summary
    line (with `extra`) and raises unless B2 launched, >= 99.9% of batch
    0's (id, score) lanes equal the oracle's with every 16-bit key within
    one step and no duplicate ids, and each batch's best-match hit rate is
    >= 0.95 or no lower than the oracle's by more than one query.  Returns
    the index, library, batches and helpers for later phases."""
    import torch

    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index.ivf import _ivf_search_perquery, _key16
    from ann_solo_tpu_torch.models.vectorize import (
        device_tables,
        vectorize_batch,
    )
    from ann_solo_tpu_torch.ops import ivf_probe_cuda, select_cuda, \
        stage1_cuda
    from ann_solo_tpu_torch.ops.rescore import rescore_candidate_matrix
    from ann_solo_tpu_torch.search import LibraryBlock, ann_open_search_batch

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    lib_mz, lib_int, lib_ann, lib_prec = lib_arrays
    n_lib = lib_mz.shape[0]
    tables = device_tables(params.vectorize, dev)
    lib = LibraryBlock(lib_mz, lib_int, lib_ann, lib_prec.to(torch.float32))
    batches = [synth_queries_torch(gen, lib_arrays, n_q)
               for _ in range(n_batches)]
    q_n = np.full(n_q, K_PEAKS, np.int32)

    def run(batch, stages=None):
        _, q_mz, q_int, q_prec = batch
        return ann_open_search_batch(
            index, lib, q_mz, q_int, q_n, q_prec, CHARGE, params,
            stage_seconds=stages,
        )

    run(batches[0])  # warm-up
    synchronize(dev)
    ivf_probe_cuda.LAUNCHES = 0
    stage1_cuda.LAUNCHES = 0
    select_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    outs = [run(batch) for batch in batches]
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    launches = ivf_probe_cuda.LAUNCHES
    b4_launches = stage1_cuda.LAUNCHES
    b5_launches = select_cuda.LAUNCHES
    hit_rates = []
    for batch, (best, score, n_cands, matches) in zip(batches, outs):
        _check_outputs(best, score, n_cands, matches, n_lib, n_q,
                       BIG_CANDIDATES)
        hit_rates.append(float(np.mean(best == batch[0])))
    stages = {}
    run(batches[1 % n_batches], stages)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    def embed(batch):
        """(query vectors, precursor m/z) of a batch on the card."""
        _, q_mz, q_int, q_prec = batch
        vectors = vectorize_batch(params.vectorize, tables, q_mz, q_int,
                                  torch.as_tensor(q_n, device=dev))
        return vectors, torch.as_tensor(q_prec, dtype=torch.float32,
                                        device=dev)

    def select(batch, oracle):
        """(ids, scores) of the select stage alone: `search_device` or the
        per-query oracle."""
        vectors, qp = embed(batch)
        if not oracle:
            return index.search_device(
                vectors, BIG_CANDIDATES, q_prec=qp, charge=float(CHARGE),
                tol_val=OPEN_TOL_DA, tol_mode="Da",
            )
        scores, ids = _ivf_search_perquery(
            index.padded_vectors, index.padded_ids, index.padded_prec,
            index.padded_scales, index.centroids, vectors, qp,
            float(CHARGE), index.num_probe, BIG_CANDIDATES,
            index.redundancy * BIG_CANDIDATES, OPEN_TOL_DA, "Da",
            index.redundancy > 1,
        )
        return ids.to(torch.int32), scores

    def best_match_rate(batch, ids):
        rows, q_mz, q_int, q_prec = batch
        best, _, _ = rescore_candidate_matrix(
            q_mz, q_int, torch.as_tensor(q_prec, dtype=torch.float32,
                                         device=dev),
            lib.mz, lib.intensity, lib.ann_charge, lib.precursor_mz, ids,
            FRAG_TOL, params.num_shifts(CHARGE), params.allow_peak_shifts,
        )
        return float(np.mean(best == rows))

    # The probe path against the per-query oracle on the card, batch 0.
    t0 = time.perf_counter()
    p_ids, p_s = select(batches[0], oracle=False)
    synchronize(dev)
    t_probe = time.perf_counter() - t0
    t0 = time.perf_counter()
    o_ids, o_s = select(batches[0], oracle=True)
    synchronize(dev)
    t_oracle = time.perf_counter() - t0
    same_lane = float(((p_ids == o_ids) & (p_s == o_s)).float().mean())
    key_step = int((_key16(p_s) - _key16(o_s)).abs().max())
    if _has_duplicates(p_ids) or _has_duplicates(o_ids):
        raise AssertionError("a query holds a duplicate id")
    rows0 = torch.as_tensor(batches[0][0], device=dev)
    in_cands = {
        label: float((ids == rows0[:, None]).any(1).float().mean())
        for label, ids in (("probe", p_ids), ("oracle", o_ids))
    }
    oracle_rates = {0: best_match_rate(batches[0], o_ids)}
    for i, rate in enumerate(hit_rates):
        if rate < HIT_RATE_GATE and i not in oracle_rates:
            oracle_rates[i] = best_match_rate(
                batches[i], select(batches[i], oracle=True)[0])
    summary = dict(extra)
    summary.update({
        "n_library": n_lib,
        "index_shape": list(index.padded_vectors.shape),
        "num_probe": index.num_probe,
        "queries_per_batch": n_q,
        "queries_per_sec": n_batches * n_q / elapsed,
        "batch_sec": elapsed / n_batches,
        "stages_sec_per_batch": stages,
        "search_max_memory_allocated_bytes": peak,
        "best_match_hit_rates": hit_rates,
        "oracle_best_match_hit_rates": oracle_rates,
        "source_in_candidates_batch0": in_cands,
        "probe_vs_oracle_same_lanes": same_lane,
        "probe_vs_oracle_max_key16_step": key_step,
        "select_sec_probe_vs_oracle": [t_probe, t_oracle],
        "mean_candidates": float(np.mean(outs[-1][2])),
        "b2_launches": launches,
        "b4_launches": b4_launches,
        "b5_launches": b5_launches,
    })
    log(f"{name}: " + json.dumps(summary))
    oracle_worst = min(oracle_rates.values())
    note(f"{summary['queries_per_sec']:.2f} q/s ({n_batches} x {n_q}, "
         f"{BIG_CANDIDATES} candidates)",
         "a batch {:.4f} s = select {:.4f} + rescore {:.4f} s".format(
             elapsed / n_batches, stages.get("select", 0.0),
             stages.get("rescore", 0.0)),
         f"hit rates {min(hit_rates):.4f}-{max(hit_rates):.4f} (oracle's "
         f"lowest {oracle_worst:.4f})",
         f"lanes vs oracle {same_lane:.5f}", f"search peak {peak} bytes",
         f"B2 launched {launches}, B4 {b4_launches}, B5 {b5_launches}")
    if dev.type == "cuda" and min(launches, b4_launches, b5_launches) <= 0:
        raise AssertionError(f"{name}: kernel B2 launched {launches}, "
                             f"B4 {b4_launches}, B5 {b5_launches}")
    if same_lane < 0.999 or key_step > 1:
        raise AssertionError(
            f"{name}: probe path vs oracle: {same_lane} lanes equal, key16 "
            f"step {key_step}")
    for i, rate in enumerate(hit_rates):
        if rate < HIT_RATE_GATE and rate < oracle_rates[i] - 1.0 / n_q:
            raise AssertionError(
                f"{name}, batch {i}: best-match hit rate {rate} below the "
                f"gate and below the oracle's {oracle_rates[i]}")
    return {"launches": launches, "b4_launches": b4_launches,
            "b5_launches": b5_launches, "index": index, "lib": lib,
            "batches": batches, "run": run, "embed": embed, "select": select,
            "best_match_rate": best_match_rate, "hit_rates": hit_rates,
            "queries_per_sec": summary["queries_per_sec"],
            "probe": (p_ids, p_s), "oracle": (o_ids, o_s)}


def index_file_round_trip(dev, index, select, want, workdir=None):
    """Save `index`, load it onto `dev`, and hold `select(loaded)` against
    `want` = (ids, scores) of the built index: identical.  Logs save and
    load seconds and the file's bytes, then deletes the file."""
    import os

    import torch

    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index.ivf import IvfIndex

    workdir = workdir or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build")
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "big_slice.ivf.npz")
    index.store_fp = "chip_smoke"
    try:
        t0 = time.perf_counter()
        index.save(path)
        t_save = time.perf_counter() - t0
        n_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = IvfIndex.load(path, index.num_probe, dev)
        synchronize(dev)
        t_load = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    ids, scores = select(loaded)
    same = bool(torch.equal(ids, want[0]) and torch.equal(scores, want[1]))
    log("big slice index file: " + json.dumps({
        "save_sec": t_save, "load_sec": t_load, "bytes": n_bytes,
        "loaded_equals_built": same, "store_fp": loaded.store_fp}))
    note(f"index file {n_bytes} bytes: saved {t_save:.2f} s, loaded "
         f"{t_load:.2f} s")
    if not same or loaded.store_fp != "chip_smoke":
        raise AssertionError("the loaded index does not select like the "
                             "built one")


def _lanes_vs(ids, scores, ref_ids, ref_scores, rows=None):
    """(share of equal (id, score) lanes, largest key16 step) of a select
    result against a reference, over `rows` (all queries if None)."""
    from ann_solo_tpu_torch.index.ivf import _key16

    if rows is not None:
        ids, scores = ids[rows], scores[rows]
        ref_ids, ref_scores = ref_ids[rows], ref_scores[rows]
    if ids.numel() == 0:
        return 1.0, 0
    same = float(((ids == ref_ids) & (scores == ref_scores)).float().mean())
    return same, int((_key16(scores) - _key16(ref_scores)).abs().max())


def profile_batch(dev, name, fn):
    """Device time of one batch by kernel (torch.profiler): wall seconds,
    kernel seconds, idle share and the ten costliest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ann_solo_tpu_torch.device import synchronize

    synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time", None)
            if us is None:
                us = e.cuda_time
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e6
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if wall > 0:
        note(f"profiled batch: wall {wall:.4f} s, kernels {busy:.4f} s, "
             f"idle {100 * (1 - busy / wall):.1f}%")
    log(f"profile {name}: " + json.dumps({
        "wall_sec": wall, "kernel_sec": busy,
        "idle_share": 1.0 - busy / wall if wall > 0 else None,
        "top_kernels_sec": [[k[:90], v] for k, v in top],
    }))


def phase_b3_slice(dev, big):
    """The B3 path at full width on phase 7's index and query batches,
    then one batch of it under torch.profiler."""
    import torch

    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index.ivf import (
        _ivf_search_chunked,
        chunked_scan_params,
    )
    from ann_solo_tpu_torch.ops import ivf_probe, ivf_probe_cuda, ivf_scan_cuda

    index, batches, run = big["index"], big["batches"], big["run"]
    l, cap, _ = index.padded_vectors.shape
    n_q = len(batches[0][0])
    n_lib = len(big["lib"].mz)
    bound = ivf_probe.MAX_PROBE_LANES
    ivf_probe.MAX_PROBE_LANES = min(index.num_probe, l) * cap - 1
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run(batches[0])  # warm-up
        synchronize(dev)
        ivf_scan_cuda.LAUNCHES = 0
        ivf_probe_cuda.LAUNCHES = 0
        flagged = []
        t0 = time.perf_counter()
        outs = []
        for batch in batches:
            outs.append(run(batch))
            flagged.append(index._last_chunked_flagged)
        synchronize(dev)
        elapsed = time.perf_counter() - t0
        b3_launches = ivf_scan_cuda.LAUNCHES
        b2_launches = ivf_probe_cuda.LAUNCHES
        hit_rates = []
        for batch, (best, score, n_cands, matches) in zip(batches, outs):
            _check_outputs(best, score, n_cands, matches, n_lib, n_q,
                           BIG_CANDIDATES)
            hit_rates.append(float(np.mean(best == batch[0])))
        stages = {}
        run(batches[1], stages)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)

        t0 = time.perf_counter()
        f_ids, f_s = big["select"](batches[0], oracle=False)
        synchronize(dev)
        t_fused = time.perf_counter() - t0
        flagged0 = index._last_chunked_flagged
        profile_batch(dev, "b3 path, last batch", lambda: run(batches[-1]))
    finally:
        ivf_probe.MAX_PROBE_LANES = bound

    # The plain chunked scan called directly on batch 0.
    vectors, qp = big["embed"](batches[0])
    k_scan = index.redundancy * BIG_CANDIDATES
    pool_g, list_chunk = chunked_scan_params(l, cap, index.num_probe, k_scan,
                                             n_q)
    t0 = time.perf_counter()
    c_s, c_ids, c_flags = _ivf_search_chunked(
        *index._blocks(), vectors, qp, float(CHARGE), index.num_probe,
        BIG_CANDIDATES, k_scan, pool_g, list_chunk, OPEN_TOL_DA, "Da",
        index.redundancy > 1,
    )
    synchronize(dev)
    t_plain = time.perf_counter() - t0
    del vectors

    p_ids, p_s = big["probe"]
    o_ids, o_s = big["oracle"]
    if _has_duplicates(f_ids):
        raise AssertionError("a B3 query holds a duplicate id")
    same_probe, step_probe = _lanes_vs(f_ids, f_s, p_ids, p_s)
    same_oracle, step_oracle = _lanes_vs(f_ids, f_s, o_ids, o_s)
    clean = ~c_flags
    same_plain, step_plain = _lanes_vs(c_ids, c_s, o_ids, o_s, clean)
    summary = {
        "queries_per_sec": len(batches) * n_q / elapsed,
        "batch_sec": elapsed / len(batches),
        "stages_sec_per_batch": stages,
        "flagged_per_batch": flagged,
        "max_memory_allocated_bytes": peak,
        "best_match_hit_rates": hit_rates,
        "phase7_best_match_hit_rates": big["hit_rates"],
        "b3_vs_probe_same_lanes": same_probe,
        "b3_vs_probe_max_key16_step": step_probe,
        "b3_vs_oracle_same_lanes": same_oracle,
        "b3_vs_oracle_max_key16_step": step_oracle,
        "b3_select_flagged_batch0": flagged0,
        "plain_chunked_flagged_batch0": int(c_flags.sum()),
        "plain_chunked_vs_oracle_same_lanes_unflagged": same_plain,
        "plain_chunked_vs_oracle_max_key16_step_unflagged": step_plain,
        "select_sec_b3_vs_plain_chunked": [t_fused, t_plain],
        "plain_chunked_pool_g_list_chunk": [pool_g, list_chunk],
        "mean_candidates": float(np.mean(outs[-1][2])),
        "b3_launches": b3_launches,
        "b2_launches": b2_launches,
    }
    log("b3 slice: " + json.dumps(summary))
    note(f"{summary['queries_per_sec']:.2f} q/s", f"flagged a batch "
         f"{min(flagged)}-{max(flagged)} of {n_q}",
         f"lanes vs probe path {same_probe:.5f}",
         f"B3 launched {b3_launches}, B2 (hot lists) {b2_launches}")
    if b3_launches <= 0 and dev.type == "cuda":
        raise AssertionError("kernel B3 was not launched")
    if same_probe < 0.999 or step_probe > 1:
        raise AssertionError(
            f"B3 path vs probe path: {same_probe} lanes equal, key16 step "
            f"{step_probe}")
    for i, (rate, rate7) in enumerate(zip(hit_rates, big["hit_rates"])):
        if abs(rate - rate7) > 1.0 / n_q:
            raise AssertionError(
                f"batch {i}: B3 path hit rate {rate} vs phase 7's {rate7}")
    return b3_launches


def phase_scale_demo(dev, args=()):
    """Phase 7b: `scale_demo`'s default point (SCALE r04's single-chip
    configuration on its own Gaussian rows) through the function its
    command line runs.  Gates: B2 launched; the source row among a
    query's candidates for >= 0.95 of the queries, or, below that, no
    fewer than the on-card per-query oracle finds by more than one query.
    Returns B2's launches."""
    import torch

    from ann_solo_tpu_torch import scale_demo
    from ann_solo_tpu_torch.index.ivf import _ivf_search_perquery
    from ann_solo_tpu_torch.ops import ivf_probe_cuda

    out_path = os.path.join(_workdir("scale"), "scale.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    parsed = scale_demo.parse_args(
        list(args) + ["--out", out_path]
        + (["--no_gpu"] if dev.type == "cpu" else []))
    ivf_probe_cuda.LAUNCHES = 0
    out = scale_demo.single_chip(parsed, dev)
    launches = ivf_probe_cuda.LAUNCHES
    result, index = out["result"], out["index"]
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    hit = result["source_in_top_candidates"]
    oracle = None
    if hit < HIT_RATE_GATE:
        k = parsed.num_candidates
        _, ids = _ivf_search_perquery(
            index.padded_vectors, index.padded_ids, index.padded_prec,
            index.padded_scales, index.centroids, out["queries"],
            out["q_prec"], float(scale_demo.CHARGE), index.num_probe, k,
            index.redundancy * k, scale_demo.OPEN_TOL_DA, "Da",
            index.redundancy > 1)
        oracle = scale_demo._source_rate(ids.cpu().numpy(),
                                         out["query_rows"])
    log("scale demo: " + json.dumps({
        "result": result, "regime": index.regime(parsed.num_candidates),
        "build_max_memory_allocated_bytes":
            out["build_max_memory_allocated_bytes"],
        "oracle_source_in_top_candidates": oracle, "b2_launches": launches}))
    note(f"{result['n_vectors']} rows, {result['num_list']} lists, "
         f"num_probe {result['num_probe']}: build {result['build_sec']:.2f} "
         f"s, peak {out['build_max_memory_allocated_bytes']} bytes",
         f"select {result['select_queries_per_sec']:.2f} q/s",
         f"source in candidates {hit:.4f}"
         + ("" if oracle is None else f" (oracle {oracle:.4f})"),
         f"B2 launched {launches}")
    if launches <= 0 and dev.type == "cuda":
        raise AssertionError("scale demo: kernel B2 was not launched")
    if oracle is not None and hit < oracle - 1.0 / parsed.n_queries:
        raise AssertionError(f"scale demo: source in candidates {hit}, the "
                             f"oracle's {oracle}")
    del out, index
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def phase_streaming_switch(dev, big, workdir=None,
                           config=StreamSwitchConfig):
    """Phase 10a: `IvfIndex.load_or_build` on phase 7's library and
    settings with no file present must take the streaming build (the f32
    source block exceeds `_STREAM_BUILD_SOURCE_BYTES`) and give phase 7's
    in-memory index, every array identical.  Logs its seconds and peak
    device memory beside phase 7's, then deletes the file."""
    import os
    import types

    import torch

    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index import ivf

    index, lib = big["index"], big["lib"]
    n = lib.mz.shape[0]
    workdir = workdir or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build")
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "streaming_switch.ivf.npz")
    if os.path.exists(path):
        os.remove(path)
    charge_block = types.SimpleNamespace(
        mz=lib.mz, intensity=lib.intensity,
        n_peaks=torch.full((n,), K_PEAKS, device=dev),
        precursor_mz=lib.precursor_mz.cpu().numpy(), n_spectra=n)
    resident = peak = 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    stages, notes = {}, {}
    t0 = time.perf_counter()
    try:
        streamed = ivf.IvfIndex.load_or_build(
            path, charge_block, config(), store_fp="chip_smoke",
            device=dev, stage_seconds=stages, notes=notes)
        synchronize(dev)
        t_total = time.perf_counter() - t0
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
        n_bytes = os.path.getsize(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    same = {
        name: bool(torch.equal(
            getattr(streamed, name).view(torch.uint8)
            if name == "padded_vectors" else getattr(streamed, name),
            getattr(index, name).view(torch.uint8)
            if name == "padded_vectors" else getattr(index, name)))
        for name in ("centroids", "padded_ids", "padded_vectors",
                     "padded_scales", "padded_prec")
    }
    source_bytes = n * HASH_LEN * 4
    log("streaming switch: " + json.dumps({
        "n_library": n, "source_block_bytes": source_bytes,
        "threshold_bytes": ivf._STREAM_BUILD_SOURCE_BYTES,
        "build": notes.get("build"), "stages_sec": stages,
        "load_or_build_sec": t_total,
        "resident_bytes_before": resident,
        "max_memory_allocated_bytes": peak,
        "build_own_peak_bytes": peak - resident,
        "phase7_in_memory_build_sec": big["build_sec"],
        "phase7_in_memory_build_peak_bytes": big["build_peak"],
        "file_bytes": n_bytes, "identical_to_phase7": same}))
    note(f"load_or_build {t_total:.2f} s ({notes.get('build')}), own peak "
         f"{peak - resident} bytes", "every array equal to phase 7's"
         if all(same.values()) else f"differs: {same}")
    if source_bytes <= ivf._STREAM_BUILD_SOURCE_BYTES:
        raise AssertionError("the source block is within the in-memory "
                             "build's bound")
    if notes.get("build") != "streaming":
        raise AssertionError(f"load_or_build built {notes.get('build')!r}")
    if not all(same.values()):
        raise AssertionError(f"streamed index differs from phase 7's: {same}")


def phase_streaming_8m(dev, n_lib=N_STREAM, n_q=STREAM_QUERIES,
                       n_batches=N_BATCHES, config=Stream8mConfig):
    """Phase 10b: SCALE r04's single-chip streaming point.  The library
    made on the card as phase 7 makes its own, `IvfIndex.build_streaming`
    with rows re-vectorized from its peaks on demand, then the timed
    batches and gates of `big_library_search`.  Returns its result (with
    the library's arrays and row accessor) for phases 11a and 11b."""
    import torch

    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index.ivf import IvfIndex
    from ann_solo_tpu_torch.models.vectorize import (
        device_tables,
        vectorize_batch,
    )

    params = big_params()
    gen = torch.Generator(device=dev)
    gen.manual_seed(8388)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lib_arrays = synth_library_torch(gen, n_lib, dev)
    synchronize(dev)
    t_lib = time.perf_counter() - t0
    lib_mz, lib_int, lib_ann, lib_prec = lib_arrays
    tables = device_tables(params.vectorize, dev)
    n_peaks = torch.full((n_lib,), K_PEAKS, device=dev)

    def get_rows(idx):
        rows = idx.clamp(0, n_lib - 1)
        return vectorize_batch(params.vectorize, tables, lib_mz[rows],
                               lib_int[rows], n_peaks[rows])

    resident = build_peak = 0
    if dev.type == "cuda":
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = IvfIndex.build_streaming(
        get_rows, n_lib, HASH_LEN, config(),
        precursor_mz=lib_prec.to(torch.float32), storage_dtype=torch.int8,
        device=dev)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    if dev.type == "cuda":
        build_peak = torch.cuda.max_memory_allocated(dev)
    index_bytes = tensor_bytes(index.padded_vectors, index.padded_ids,
                               index.padded_prec, index.padded_scales,
                               index.centroids)
    l, cap, d = index.padded_vectors.shape
    log(f"streaming 8m: {n_lib} spectra made in {t_lib:.3f}s "
        f"({tensor_bytes(*lib_arrays)} bytes of peaks); streaming build "
        f"{t_build:.3f}s ({l} lists x cap {cap} x {d}, int8, "
        f"x{index.redundancy}, num_probe {index.num_probe}, {index_bytes} "
        "bytes)")
    note(f"streaming build {t_build:.2f} s, peak {build_peak} bytes")
    out = big_library_search(
        dev, "streaming 8m", index, lib_arrays, params, gen, n_q, n_batches,
        {"library_make_sec": t_lib, "library_bytes": tensor_bytes(*lib_arrays),
         "streaming_build_sec": t_build, "index_bytes": index_bytes,
         "resident_bytes_before_build": resident,
         "build_max_memory_allocated_bytes": build_peak})
    out.update(lib_arrays=lib_arrays, get_rows=get_rows, config=config)
    return out


def phase_sharded_8m(dev, s8m, n_shards=N_SHARDS_8M):
    """Phase 11a: phase 10b's library born sharded over a (dp=1, lib=4)
    mesh of the one card, searched through kernel B2 shard by shard, then
    10b's index placed on a (dp=2, lib=2) mesh.  Gates and logs as in the
    module docstring.  Returns B2's launches of the timed batches."""
    import torch

    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.ops import ivf_probe_cuda, shifted_dot_cuda
    from ann_solo_tpu_torch.parallel.mesh import make_mesh
    from ann_solo_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex
    from ann_solo_tpu_torch.search import ann_open_search_batch

    index, lib, batches = s8m["index"], s8m["lib"], s8m["batches"]
    n_lib = lib.mz.shape[0]
    n_q = len(batches[0][0])
    params = big_params()
    q_n = np.full(n_q, K_PEAKS, np.int32)
    mesh = make_mesh(n_shards, dp_size=1, devices=[dev] * n_shards)
    resident = build_peak = 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sharded = ShardedIvfIndex.build_sharded_streaming(
        mesh, s8m["get_rows"], n_lib, HASH_LEN, s8m["config"](),
        precursor_mz=lib.precursor_mz, storage_dtype=torch.int8,
        centroids=index.centroids)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    if dev.type == "cuda":
        build_peak = torch.cuda.max_memory_allocated(dev)
    build_stages = dict(sharded.build_seconds)
    l_l = sharded.lists_per_shard
    same = {"centroids": bool(torch.equal(sharded.centroids,
                                          index.centroids))}
    for s, blk in enumerate(sharded.blocks()):
        lists = slice(s * l_l, (s + 1) * l_l)
        for name, mine, ref in (
                ("ids", blk.ids, index.padded_ids[lists]),
                ("vectors", blk.vectors.view(torch.uint8),
                 index.padded_vectors[lists].view(torch.uint8)),
                ("scales", blk.scales, index.padded_scales[lists]),
                ("prec", blk.prec, index.padded_prec[lists])):
            same[name] = same.get(name, True) and bool(torch.equal(mine, ref))
    regime = sharded._regime_params(n_q, sharded.num_probe,
                                    BIG_CANDIDATES * sharded.redundancy)

    def run(idx, batch, stages=None):
        _, q_mz, q_int, q_prec = batch
        return ann_open_search_batch(idx, lib, q_mz, q_int, q_n, q_prec,
                                     CHARGE, params, stage_seconds=stages)

    def select(idx, batch):
        vectors, qp = s8m["embed"](batch)
        return idx.search_device(vectors, BIG_CANDIDATES, q_prec=qp,
                                 charge=float(CHARGE), tol_val=OPEN_TOL_DA,
                                 tol_mode="Da")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run(sharded, batches[0])  # warm-up
    synchronize(dev)
    ivf_probe_cuda.LAUNCHES = 0
    shifted_dot_cuda.LAUNCHES = 0
    overflow, outs = [], []
    t0 = time.perf_counter()
    for batch in batches:
        outs.append(run(sharded, batch))
        overflow.append(sharded._last_overflow)
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    launches = ivf_probe_cuda.LAUNCHES
    b1_launches = shifted_dot_cuda.LAUNCHES
    hit_rates = []
    for batch, (best, score, n_cands, matches) in zip(batches, outs):
        _check_outputs(best, score, n_cands, matches, n_lib, n_q,
                       BIG_CANDIDATES)
        hit_rates.append(float(np.mean(best == batch[0])))
    stages = {}
    run(sharded, batches[1 % len(batches)], stages)
    search_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    ids, scores = select(sharded, batches[0])
    same_lane, key_step = _lanes_vs(ids, scores, *s8m["probe"])
    dups = _has_duplicates(ids)
    if dev.type == "cuda":
        profile_batch(dev, "sharded 8m, last batch",
                      lambda: run(sharded, batches[-1]))
    del sharded, ids, scores

    # 10b's index placed on a (dp=2, lib=2) mesh: views, no copies.
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    placed = ShardedIvfIndex(
        make_mesh(4, dp_size=2, devices=[dev] * 4), index)
    placed_bytes = (torch.cuda.memory_allocated(dev) - before
                    if dev.type == "cuda" else 0)
    p_ids, p_scores = select(placed, batches[0])
    same_lane_22, key_step_22 = _lanes_vs(p_ids, p_scores, *s8m["probe"])
    dups_22 = _has_duplicates(p_ids)
    regime_22 = placed._regime_params(n_q // 2, placed.num_probe,
                                      BIG_CANDIDATES)
    del placed, p_ids, p_scores
    q_s = len(batches) * n_q / elapsed
    summary = {
        "mesh": mesh.shape, "lists_per_shard": l_l,
        "regime_width_chunk": list(regime),
        "build_sec": t_build, "build_stages_sec": build_stages,
        "resident_bytes_before_build": resident,
        "build_max_memory_allocated_bytes": build_peak,
        "identical_to_10b": same,
        "queries_per_sec": q_s, "phase10b_queries_per_sec":
            s8m["queries_per_sec"],
        "batch_sec": elapsed / len(batches), "stages_sec_per_batch": stages,
        "overflowed_queries_per_batch": overflow,
        "search_max_memory_allocated_bytes": search_peak,
        "best_match_hit_rates": hit_rates,
        "phase10b_best_match_hit_rates": s8m["hit_rates"],
        "vs_10b_same_lanes": same_lane, "vs_10b_max_key16_step": key_step,
        "dp2_lib2": {"regime_width_chunk": list(regime_22),
                     "placement_bytes": placed_bytes,
                     "vs_10b_same_lanes": same_lane_22,
                     "vs_10b_max_key16_step": key_step_22},
        "b2_launches": launches, "b1_launches": b1_launches,
    }
    log("sharded 8m: " + json.dumps(summary))
    note(f"born-sharded build {t_build:.2f} s (" + ", ".join(
        f"{k} {v:.2f}" for k, v in build_stages.items()) + ")",
        f"{q_s:.2f} q/s (10b: {s8m['queries_per_sec']:.2f})",
        f"overflowed {overflow}", f"lanes vs 10b {same_lane:.5f}, (2, 2) "
        f"{same_lane_22:.5f}", f"B2 launched {launches}")
    if not all(same.values()):
        raise AssertionError(f"born-sharded index differs from 10b's: {same}")
    if launches <= 0 and dev.type == "cuda":
        raise AssertionError("sharded 8m: kernel B2 was not launched")
    for name, lanes, step, dup in (("(1, 4)", same_lane, key_step, dups),
                                   ("(2, 2)", same_lane_22, key_step_22,
                                    dups_22)):
        if lanes < 0.999 or step > 1 or dup:
            raise AssertionError(
                f"sharded 8m {name} vs 10b: {lanes} lanes equal, key16 step "
                f"{step}, duplicates {dup}")
    for i, (rate, ref) in enumerate(zip(hit_rates, s8m["hit_rates"])):
        if abs(rate - ref) > 1.0 / n_q:
            raise AssertionError(
                f"sharded 8m batch {i}: hit rate {rate} vs 10b's {ref}")
    if placed_bytes > 0.01 * tensor_bytes(index.padded_vectors):
        raise AssertionError(f"the (2, 2) placement copied {placed_bytes} "
                             "bytes on one card")
    return launches


def phase_born_sharded(dev, s8m, n=N_BORN, n_q=BIG_QUERIES,
                       config=BornShardedConfig, shard_bytes=BORN_SHARD_BYTES,
                       n_iter=BORN_KMEANS_ITERS):
    """Phase 11b: SCALE r04's born-sharded point on the first `n` rows of
    phase 10b's library: `build_sharded_streaming` over a (dcn=2, dp=1,
    lib=4) mesh of the one card with k-means trained sharded, then an
    in-memory `IvfIndex.build` of the same rows given its centroids, and
    one batch selected by both.  Gates and logs as in the module
    docstring."""
    import torch

    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index.ivf import IvfIndex
    from ann_solo_tpu_torch.models.vectorize import (
        device_tables,
        vectorize_batch,
    )
    from ann_solo_tpu_torch.parallel.mesh import make_multislice_mesh
    from ann_solo_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex

    lib_arrays = tuple(a[:n] for a in s8m["lib_arrays"])
    lib_mz, lib_int, _, lib_prec = lib_arrays
    params = big_params()
    tables = device_tables(params.vectorize, dev)
    n_peaks = torch.full((n,), K_PEAKS, device=dev)

    def get_rows(idx):
        rows = idx.clamp(0, n - 1)
        return vectorize_batch(params.vectorize, tables, lib_mz[rows],
                               lib_int[rows], n_peaks[rows])

    mesh = make_multislice_mesh(2, 4, devices=[dev] * 8)
    resident = build_peak = 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sharded = ShardedIvfIndex.build_sharded_streaming(
        mesh, get_rows, n, HASH_LEN, config(),
        precursor_mz=lib_prec.to(torch.float32), storage_dtype=torch.int8,
        n_iter=n_iter)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    if dev.type == "cuda":
        build_peak = torch.cuda.max_memory_allocated(dev)
    blocks = sharded.blocks()
    per_shard = [tensor_bytes(b.vectors) for b in blocks]
    global_bytes = sharded.num_list * sharded.cap * sharded.dim

    chunk = 65536
    vectors = torch.cat([get_rows(torch.arange(s, min(s + chunk, n),
                                               device=dev))
                         for s in range(0, n, chunk)])
    t0 = time.perf_counter()
    ref = IvfIndex.build(vectors, config(),
                         precursor_mz=lib_prec.to(torch.float32),
                         storage_dtype=torch.int8,
                         centroids=sharded.centroids, device=dev)
    synchronize(dev)
    t_ref = time.perf_counter() - t0
    del vectors
    l_l = sharded.lists_per_shard
    same = {}
    for s, blk in enumerate(blocks):
        lists = slice(s * l_l, (s + 1) * l_l)
        for name, mine, want in (
                ("ids", blk.ids, ref.padded_ids[lists]),
                ("vectors", blk.vectors.view(torch.uint8),
                 ref.padded_vectors[lists].view(torch.uint8)),
                ("scales", blk.scales, ref.padded_scales[lists]),
                ("prec", blk.prec, ref.padded_prec[lists])):
            same[name] = same.get(name, True) and bool(torch.equal(mine,
                                                                   want))

    gen = torch.Generator(device=dev)
    gen.manual_seed(2097)
    rows, q_mz, q_int, q_prec = synth_queries_torch(gen, lib_arrays, n_q)
    q_vec = vectorize_batch(params.vectorize, tables, q_mz, q_int,
                            torch.full((n_q,), K_PEAKS, device=dev))
    qp = torch.as_tensor(q_prec, dtype=torch.float32, device=dev)
    selected = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for name, idx in (("sharded", sharded), ("in_memory", ref)):
        idx.search_device(q_vec, BIG_CANDIDATES, q_prec=qp,
                          charge=float(CHARGE), tol_val=OPEN_TOL_DA,
                          tol_mode="Da")  # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        out = idx.search_device(q_vec, BIG_CANDIDATES, q_prec=qp,
                                charge=float(CHARGE), tol_val=OPEN_TOL_DA,
                                tol_mode="Da")
        synchronize(dev)
        selected[name] = out + (time.perf_counter() - t0,)
    select_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    s_ids, s_s, t_sel = selected["sharded"]
    r_ids, r_s, t_ref_sel = selected["in_memory"]
    same_lane, key_step = _lanes_vs(s_ids, s_s, r_ids, r_s)
    dups = _has_duplicates(s_ids)
    rows_d = torch.as_tensor(rows, device=dev)
    in_cands = float((s_ids == rows_d[:, None]).any(1).float().mean())
    summary = {
        "n_vectors": n, "mesh": mesh.shape, "lib_shards":
            sharded.n_list_shards, "lists_per_shard": l_l,
        "cap": sharded.cap, "redundancy": sharded.redundancy,
        "num_probe": sharded.num_probe, "kmeans_iters": n_iter,
        "regime": sharded.regime(BIG_CANDIDATES),
        "in_memory_regime": ref.regime(BIG_CANDIDATES),
        "per_shard_block_bytes": per_shard,
        "global_block_bytes": global_bytes,
        "build_sec": t_build, "build_stages_sec": sharded.build_seconds,
        "resident_bytes_before_build": resident,
        "build_max_memory_allocated_bytes": build_peak,
        "in_memory_build_sec": t_ref,
        "identical_to_in_memory": same,
        "select_sec_sharded_vs_in_memory": [t_sel, t_ref_sel],
        "select_max_memory_allocated_bytes": select_peak,
        "vs_in_memory_same_lanes": same_lane,
        "vs_in_memory_max_key16_step": key_step,
        "source_in_candidates": in_cands,
    }
    log("born sharded: " + json.dumps(summary))
    note(f"build {t_build:.2f} s, {len(per_shard)} shards of "
         f"{per_shard[0]} bytes", f"select {t_sel:.3f} s sharded, "
         f"{t_ref_sel:.3f} s in memory, lanes equal {same_lane:.5f}")
    if shard_bytes is not None and any(b != shard_bytes for b in per_shard):
        raise AssertionError(f"shard blocks {per_shard} != {shard_bytes}")
    if sum(per_shard) != global_bytes:
        raise AssertionError("the shard blocks do not add up to the global "
                             "block")
    if not all(same.values()):
        raise AssertionError(f"born-sharded index differs from the "
                             f"in-memory build: {same}")
    if same_lane < 0.999 or key_step > 1 or dups:
        raise AssertionError(
            f"born sharded vs in-memory select: {same_lane} lanes equal, "
            f"key16 step {key_step}, duplicates {dups}")


def phase_sharded_engine(dev, dp=2, n_shards=4, n_queries=ENGINE_QUERIES,
                         workdir=None):
    """Phase 11c: phase 9's CLI (--model none) on the files run A wrote,
    with `SpectralLibrary._make_library_mesh` patched to a (dp, lib) mesh
    of the one card.  Gates and logs as in the module docstring."""
    import os

    import torch

    from ann_solo_tpu_torch import search
    from ann_solo_tpu_torch.parallel.mesh import make_mesh

    workdir = workdir or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build", "engine")
    lib_path = os.path.join(workdir, "library.splib")
    query_path = os.path.join(workdir, "queries.mgf")
    out = os.path.join(workdir, "out_sharded.mztab")
    mesh = make_mesh(dp * n_shards, dp_size=dp,
                     devices=[dev] * (dp * n_shards))
    real = search.SpectralLibrary.__dict__["_make_library_mesh"]
    search.SpectralLibrary._make_library_mesh = staticmethod(
        lambda device: mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        profile, launches = run_engine_cli(dev, lib_path, query_path, out)
        t_cli = time.perf_counter() - t0
    finally:
        search.SpectralLibrary._make_library_mesh = real
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    totals, counts, notes = (profile["totals"], profile["counts"],
                             profile["notes"])
    got = _psm_rows(out)
    want = _psm_rows(os.path.join(workdir, "out_none.mztab"))
    same = [q for q in want
            if q in got and got[q][LIB_SPECTRUM] == want[q][LIB_SPECTRUM]]
    frac = len(same) / max(len(want), 1)
    differ = [q for q in same if got[q] != want[q]]
    indexes = {k: v for k, v in notes.items() if k.startswith("index")}
    summary = {
        "mesh": mesh.shape, "cli_sec": t_cli, "search_sec": totals["search"],
        "queries_per_sec": n_queries / totals["search"],
        "stages_sec": totals, "indexes": indexes,
        "paths": {k: v for k, v in counts.items() if "level charge" in k},
        "max_memory_allocated_bytes": peak, "b1_launches": launches,
        "n_psms": len(got), "run_a_psms": len(want),
        "same_library_spectrum": frac, "lines_differ_where_same":
            len(differ),
    }
    log("sharded engine: " + json.dumps(summary))
    note(f"search {totals['search']:.2f} s "
         f"({n_queries / totals['search']:.2f} q/s)",
         f"{len(got)} PSMs, {len(differ)} lines differ from run A's")
    for charge in (2, 3):
        info = notes.get(f"index charge {charge}", {})
        if info.get("source") != "loaded":
            raise AssertionError(f"charge {charge}: the index was not loaded "
                                 f"from run A's file: {info}")
        if info.get("sharded", {}).get("mesh") != mesh.shape:
            raise AssertionError(f"charge {charge}: the index is not a "
                                 f"ShardedIvfIndex on {mesh.shape}: {info}")
        if counts.get(f"open level charge {charge}: ivf select", 0) <= 0:
            raise AssertionError(f"charge {charge}: no open-level batch went "
                                 "through the sharded index")
    if launches <= 0 and dev.type == "cuda":
        raise AssertionError("sharded engine: no greedy kernel launched")
    if got.keys() != want.keys():
        raise AssertionError("sharded engine: the PSM_IDs differ from run A's")
    if frac < 0.999 or differ:
        raise AssertionError(
            f"sharded engine: same library spectrum for {frac}, "
            f"{len(differ)} lines differ where it is the same")


def engine_corpus(workdir, n_peptides, n_queries, seed):
    """`synthdata.make_corpus` written as a .splib library, an .mgf query
    file and the truth (`truth.json`, QUALITY's name) under `workdir`;
    returns the first two paths and the truth."""
    import os

    from ann_solo_tpu_torch.io.mgf import write_mgf
    from ann_solo_tpu_torch.io.splib import write_splib
    from ann_solo_tpu_torch.synthdata import make_corpus

    os.makedirs(workdir, exist_ok=True)
    library, queries, truth = make_corpus(np.random.default_rng(seed),
                                          n_peptides, n_queries)
    lib_path = os.path.join(workdir, "library.splib")
    query_path = os.path.join(workdir, "queries.mgf")
    write_splib(library, lib_path)
    write_mgf(queries, query_path)
    with open(os.path.join(workdir, "truth.json"), "w") as f:
        json.dump(truth, f)
    return lib_path, query_path, truth


def run_engine_cli(dev, lib_path, query_path, out_path, extra=()):
    """`ann_solo_tpu_torch.cli.main` in this process on `dev`; returns
    (the stage profile with B4's and B5's launches of the run under
    "b4_launches" and "b5_launches", the B1 launches of the run)."""
    from ann_solo_tpu_torch import cli
    from ann_solo_tpu_torch.ops import select_cuda, shifted_dot_cuda, \
        stage1_cuda
    from ann_solo_tpu_torch.utils.profiling import profiler

    args = [lib_path, query_path, out_path] + ENGINE_ARGS + list(extra)
    if dev.type == "cpu":
        args.append("--no_gpu")
    shifted_dot_cuda.LAUNCHES = 0
    stage1_cuda.LAUNCHES = 0
    select_cuda.LAUNCHES = 0
    rc = cli.main(args)
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    return ({"totals": dict(profiler.totals), "counts": dict(profiler.counts),
             "notes": dict(profiler.notes),
             "b4_launches": stage1_cuda.LAUNCHES,
             "b5_launches": select_cuda.LAUNCHES}, shifted_dot_cuda.LAUNCHES)


def remove_library_files(workdir):
    """Delete the store and index files the engine wrote beside a
    library."""
    import os

    for name in os.listdir(workdir):
        if name.endswith((".store.npz", ".ivf.npz")):
            os.remove(os.path.join(workdir, name))


def engine_run(dev, name, lib_path, query_path, truth, n_queries, model,
               loaded, reference=None):
    """One CLI run of phase 9 on `dev` with `--model model`: logs its
    summary and holds its gates (see the module docstring); `loaded` says
    whether the store and index files must have been read, not built;
    `reference` holds the --model none statistics a model run must keep.
    Returns (the identification statistics, B1's launches, B4's, B5's)."""
    import os
    from types import SimpleNamespace

    import torch

    from ann_solo_tpu_torch.quality import _mztab_stats

    workdir = os.path.dirname(lib_path)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    out_path = os.path.join(workdir, f"out_{model}.mztab")
    t0 = time.perf_counter()
    profile, launches = run_engine_cli(dev, lib_path, query_path, out_path,
                                       ["--model", model])
    t_cli = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stats = _mztab_stats(out_path, truth, SimpleNamespace(fdr=ENGINE_FDR))
    totals, counts, notes = (profile["totals"], profile["counts"],
                             profile["notes"])
    files = {key: {k: note[k] for k in ("source", "file", "bytes")}
             for key, note in notes.items()
             if isinstance(note, dict) and "source" in note}
    summary = {
        "run": name, "model": model,
        "cli_sec": t_cli,
        "stages_sec": totals,
        "search_sec": totals["search"],
        "queries_per_sec": n_queries / totals["search"],
        "files": files,
        "indexes": {k: v for k, v in notes.items() if k.startswith("index")},
        "rf_grid": {k: v for k, v in notes.items() if k.endswith("rf grid")},
        "paths": {k: v for k, v in counts.items() if "level charge" in k},
        "readers": {k: notes.get(k) for k in ("library reader",
                                              "query reader")},
        "library_read_sec": totals.get("library read"),
        "pr7_library_read_sec_python_reader": [25.91, 32.91],
        "max_memory_allocated_bytes": peak,
        "b1_launches": launches,
        "b4_launches": profile["b4_launches"],
        "b5_launches": profile["b5_launches"],
        "identifications": stats,
        "jax_quality_r05_ann": QUALITY_R05_ANN,
    }
    log("engine: " + json.dumps(summary))
    note(f"{name} --model {model}: CLI {t_cli:.2f} s, search "
         f"{totals['search']:.2f} s, {stats['n_confident']} confident "
         f"(accuracy {stats['accuracy']:.5f})")
    if dev.type == "cuda" and min(launches, profile["b4_launches"],
                                  profile["b5_launches"]) <= 0:
        raise AssertionError(f"{name}: the engine launched B1 {launches} "
                             f"times, B4 {profile['b4_launches']}, B5 "
                             f"{profile['b5_launches']}")
    for charge in (2, 3):
        if counts.get(f"open level charge {charge}: ivf select", 0) <= 0:
            raise AssertionError(f"{name}, charge {charge}: no open-level "
                                 "batch went through IvfIndex.search_device")
        if counts.get(f"std level charge {charge}: window rescoring",
                      0) <= 0:
            raise AssertionError(f"{name}, charge {charge}: no std-level "
                                 "batch went through window rescoring")
    if notes.get("query reader") != "native":
        raise AssertionError(
            f"{name}: queries read by {notes.get('query reader')}")
    if notes.get("library reader") != (None if loaded else "native"):
        raise AssertionError(
            f"{name}: library read by {notes.get('library reader')}")
    want = "loaded" if loaded else "built"
    for key in ("store", "index charge 2", "index charge 3"):
        if files.get(key, {}).get("source") != want:
            raise AssertionError(f"{name}: {key} was not {want}: {files}")
    built_stages = [k for k in totals if k.startswith(
        ("library read", "decoys", "library preprocess", "store write",
         "index build", "index write"))]
    if loaded and built_stages:
        raise AssertionError(f"{name}: files present, yet {built_stages}")
    if model != "none" and not (totals.get("std FDR model", 0) > 0
                                and totals.get("open FDR model", 0) > 0):
        raise AssertionError(f"{name}: no model seconds: {totals}")
    if stats["accuracy"] < ENGINE_ACCURACY_GATE:
        raise AssertionError(
            f"{name}: accuracy {stats['accuracy']} < gate "
            f"{ENGINE_ACCURACY_GATE}")
    n_real = sum(1 for v in truth.values() if v is not None)
    if stats["n_confident"] < ENGINE_CONFIDENT_GATE * n_real:
        raise AssertionError(
            f"{name}: {stats['n_confident']} confident PSMs < "
            f"{ENGINE_CONFIDENT_GATE} x {n_real}")
    if reference is not None and (
            stats["n_confident"] < 0.99 * reference["n_confident"]):
        raise AssertionError(
            f"{name}: {stats['n_confident']} confident PSMs, fewer than "
            f"--model none's {reference['n_confident']} less 1%")
    return stats, launches, profile["b4_launches"], profile["b5_launches"]


def phase_engine(dev, n_peptides=ENGINE_PEPTIDES, n_queries=ENGINE_QUERIES,
                 workdir=None):
    """The engine on the card: QUALITY r05's corpus through the port's
    CLI (std level by window rescoring, open level through the IVF
    index).  Run A builds and writes the store and index files with
    --model none; runs B (--model rf, the CLI's default) and C (--model
    svm) read them.  Returns B4's and B5's launches summed over the
    runs."""
    import os

    workdir = workdir or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build", "engine")
    t0 = time.perf_counter()
    lib_path, query_path, truth = engine_corpus(workdir, n_peptides,
                                                n_queries, ENGINE_SEED)
    log("engine corpus: " + json.dumps({
        "n_peptides": n_peptides, "n_queries": n_queries,
        "seed": ENGINE_SEED, "corpus_sec": time.perf_counter() - t0}))
    remove_library_files(workdir)
    args = (lib_path, query_path, truth, n_queries)
    none, _, total, b5_total = engine_run(dev, "run A", *args, "none",
                                          False)
    for name, model in (("run B", "rf"), ("run C", "svm")):
        _, _, b4_launches, b5_launches = engine_run(dev, name, *args, model,
                                                    True, none)
        total += b4_launches
        b5_total += b5_launches
    note(f"B4 launched {total}, B5 {b5_total}")
    return total, b5_total


LIB_SPECTRUM = "opt_ms_run[1]_cv_MS:1003062_spectrum_index"
SCORE, Q = "search_engine_score[1]", "search_engine_score[2]"


def _psm_rows(path):
    """PSM_ID -> {column: value as text} of an mzTab file, read by the
    port's `read_mztab_ssms` (text: equal values compare equal, NaN
    too)."""
    from ann_solo_tpu_torch.io.mztab import read_mztab_ssms

    ssms = read_mztab_ssms(path)
    return {qid: {name: str(col[i]) for name, col in ssms.columns.items()}
            for i, qid in enumerate(ssms.index)}


def store_native_vs_python(dev, lib_path, query_path):
    """The engine's store of one library built twice on `dev`, with phase
    9's settings: through `read_library_file` (which must take the native
    reader) and from the Python reader's iterator; every column must be
    identical."""
    import os

    from ann_solo_tpu_torch.config import config
    from ann_solo_tpu_torch.io import reader, splib
    from ann_solo_tpu_torch.io.store import (
        COLUMN_DTYPES,
        STRING_COLUMNS,
        build_store,
        hyperparameter_hash,
    )
    from ann_solo_tpu_torch.models.preprocess import PreprocessParams
    from ann_solo_tpu_torch.utils.profiling import profiler

    config.parse([lib_path, query_path, "out.mztab"] + ENGINE_ARGS)
    config_hash = hyperparameter_hash(config)
    params = PreprocessParams.from_config(config, is_library=True)
    stores, stages, used = {}, {}, {}
    for name, spectra in (
            ("native", lambda: reader.read_library_file(lib_path)),
            ("python", lambda: splib.read_splib(lib_path))):
        profiler.notes.pop("library reader", None)
        stages[name] = {}
        stores[name] = build_store(
            spectra(), config_hash, os.path.basename(lib_path), params, dev,
            add_decoys=True, stage_seconds=stages[name])
        used[name] = profiler.notes.get("library reader")
    a, b = stores["native"], stores["python"]
    differ = [c for c in (*STRING_COLUMNS, *COLUMN_DTYPES)
              if not np.array_equal(getattr(a, c), getattr(b, c))]
    log("engine store native vs python: " + json.dumps({
        "rows": a.n_spectra, "reader_notes": used, "stages_sec": stages,
        "columns_differ": differ}))
    if used["native"] != "native":
        raise AssertionError("read_library_file did not take the native "
                             "reader")
    if differ or a.n_spectra != b.n_spectra:
        raise AssertionError(f"native vs Python store columns differ: "
                             f"{differ}")


def phase_engine_cuda_vs_cpu(dev, n_peptides=1000, n_queries=250,
                             workdir=None):
    """The CLI on one small corpus, on the card and with --no_gpu: built
    then loaded, both models across devices, and --mode ann and bf with
    each run building its own files (see the module docstring)."""
    import os

    import torch

    workdir = workdir or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build", "engine_small")
    lib_path, query_path, truth = engine_corpus(workdir, n_peptides,
                                                n_queries, 7)
    cpu = torch.device("cpu")
    store_native_vs_python(dev, lib_path, query_path)

    def run(tag, d, extra):
        out = os.path.join(workdir, f"{tag}_{d.type}.mztab")
        t0 = time.perf_counter()
        profile, _ = run_engine_cli(d, lib_path, query_path, out, extra)
        source = profile["notes"]["store"]["source"]
        log(f"engine cuda-vs-cpu: {tag} on {d.type} "
            f"{time.perf_counter() - t0:.1f}s (store {source})")
        return out, profile

    # --model none twice on the card: built, then loaded.
    remove_library_files(workdir)
    built, profile = run("built", dev, [])
    if profile["notes"]["store"]["source"] != "built":
        raise AssertionError("first run: the store was not built")
    loaded, profile = run("loaded", dev, [])
    sources = {k: v["source"] for k, v in profile["notes"].items()
               if isinstance(v, dict) and "source" in v}
    if set(sources.values()) != {"loaded"} or len(sources) < 2:
        raise AssertionError(f"second run: not loaded: {sources}")
    loaded_rows = _psm_rows(loaded)
    if _psm_rows(built) != loaded_rows:
        raise AssertionError("built vs loaded: the PSM lines differ")
    log(f"engine built-vs-loaded: {len(loaded_rows)} identical PSM "
        "lines")
    note(f"{n_peptides} peptides, {n_queries} queries: built vs loaded "
         f"{len(loaded_rows)} identical lines")

    # Both models on the card and on the CPU, files loaded.
    for model in ("svm", "rf"):
        rows = {d.type: _psm_rows(run(model, d, ["--model", model])[0])
                for d in (dev, cpu)}
        got, want = rows[dev.type], rows["cpu"]
        if got.keys() != want.keys():
            raise AssertionError(f"{model}: the PSM_IDs differ, CUDA vs CPU")
        differ = [q for q in want if got[q] != want[q]]
        for q in differ[:10]:
            log(f"engine cuda-vs-cpu: {model}: {q}: card score "
                f"{got[q][SCORE]} q {got[q][Q]} {got[q][LIB_SPECTRUM]}; "
                f"cpu score {want[q][SCORE]} q {want[q][Q]} "
                f"{want[q][LIB_SPECTRUM]}")
        log(f"engine cuda-vs-cpu: {model}: {len(want)} PSMs, "
            f"{len(differ)} lines differ")
        note(f"{model} card vs CPU: {len(differ)} of {len(want)} lines "
             "differ, same spectra")
        if any(got[q][LIB_SPECTRUM] != want[q][LIB_SPECTRUM]
               for q in want):
            raise AssertionError(f"{model}: library spectra differ")
        q_got = np.asarray([float(got[q][Q]) for q in want])
        q_want = np.asarray([float(want[q][Q]) for q in want])
        if not np.allclose(q_got, q_want, rtol=1e-6, atol=0, equal_nan=True):
            raise AssertionError(f"{model}: q-values differ, CUDA vs CPU")

    # Each device building its own store and index, ann and bf.
    for mode in ("ann", "bf"):
        rows = {}
        for d in (dev, cpu):
            remove_library_files(workdir)
            rows[d.type] = _psm_rows(run(mode, d, ["--mode", mode])[0])
        got, want = rows[dev.type], rows["cpu"]
        if got.keys() != want.keys():
            raise AssertionError(f"{mode}: the PSM_IDs differ, CUDA vs CPU")
        same = [q for q in want
                if got[q][LIB_SPECTRUM] == want[q][LIB_SPECTRUM]]
        frac = len(same) / max(len(want), 1)
        differ = [q for q in same if got[q] != want[q]]
        log(f"engine cuda-vs-cpu: {mode}: {len(want)} PSMs, same library "
            f"spectrum for {frac:.4f}, {len(differ)} of those lines differ")
        note(f"{mode} card vs CPU: same spectrum {frac:.4f}")
        if frac < 0.999:
            raise AssertionError(f"{mode}: same library spectrum for {frac}")
        if differ:
            raise AssertionError(f"{mode}: PSM lines differ: {differ[:5]}")

    wide_cuda_vs_cpu(dev, workdir, lib_path, query_path)
    fasta_cuda_vs_cpu(dev, workdir, query_path, truth)


# The wide run of phase 9s: its first queries (the --no_gpu run's time
# grows with K^2 per pair), and the settings past the kernels' first
# branches: k_sel = 2 x 4,096 lanes before dedup, K = 300 for B1 and B4.
WIDE_QUERIES = 12
WIDE_ARGS = ["--num_candidates", "4096", "--max_peaks_used", "300",
             "--max_peaks_used_library", "300"]


def wide_cuda_vs_cpu(dev, workdir, lib_path, query_path,
                     n_queries=WIDE_QUERIES):
    """The CLI on a library and the first `n_queries` spectra of a query
    file at `WIDE_ARGS`, on `dev` (store and index built) and with
    --no_gpu (loaded): identical PSM lines, and on the card B1 and B4
    launched (B1 takes K = 300 on its wide branch, B4 Kc = 300)."""
    import os

    import torch

    from ann_solo_tpu_torch.ops import shifted_dot_cuda, stage1_cuda

    with open(query_path) as f:
        blocks = f.read().split("END IONS\n")
    sub_path = os.path.join(workdir, "queries_wide.mgf")
    with open(sub_path, "w") as f:
        f.write("END IONS\n".join(blocks[:n_queries]) + "END IONS\n")
    remove_library_files(workdir)
    rows, launches = {}, {}
    for d in (dev, torch.device("cpu")):
        out = os.path.join(workdir, f"wide_{d.type}.mztab")
        t0 = time.perf_counter()
        profile, b1 = run_engine_cli(d, lib_path, sub_path, out, WIDE_ARGS)
        source = profile["notes"]["store"]["source"]
        if source != ("built" if d is dev else "loaded"):
            raise AssertionError(f"wide run on {d.type}: store {source}")
        launches[d.type] = (b1, profile["b4_launches"],
                            profile["b5_launches"])
        log(f"engine wide: {d.type} {time.perf_counter() - t0:.1f}s (store "
            f"{source}); B1, B4, B5 launches {launches[d.type]}")
        rows[d.type] = _psm_rows(out)
    got, want = rows[dev.type], rows["cpu"]
    differ = [q for q in want if got.get(q) != want[q]]
    log(f"engine wide: {n_queries} queries {' '.join(WIDE_ARGS)}: "
        f"{len(want)} PSMs, {len(differ)} lines differ; B1 branch "
        f"{shifted_dot_cuda.branch(300)}, B4 branch "
        f"{stage1_cuda.branch(300, 300)}")
    note(f"wide run ({n_queries} queries, {' '.join(WIDE_ARGS)}): "
         f"{len(want)} PSM lines, card vs CPU identical: {not differ}")
    if got.keys() != want.keys() or differ or not want:
        raise AssertionError(f"wide run: {len(differ)} PSM lines differ, "
                             f"{len(got)} vs {len(want)} PSMs")
    if dev.type == "cuda" and min(launches[dev.type][:2]) <= 0:
        raise AssertionError(f"wide run: B1, B4 launches "
                             f"{launches[dev.type][:2]}")


def fasta_cuda_vs_cpu(dev, workdir, query_path, truth):
    """A FASTA library of a corpus's peptides (10 to a protein), searched
    by the CLI on `dev` and with --no_gpu, each building its own store
    from the predicted spectra and searching it exactly (--mode bf: each
    device's own k-means may pick other candidates, as the ann comparison
    of `phase_engine_cuda_vs_cpu` allows): identical PSM lines."""
    import os

    import torch

    fasta = os.path.join(workdir, "proteins.fasta")
    peptides = sorted({p for p in truth.values() if p is not None})
    peptides = peptides[:FASTA_PEPTIDES]
    with open(fasta, "w") as f:
        for i in range(0, len(peptides), 10):
            f.write(f">sp|P{i}|P{i} protein {i}\n"
                    f"{''.join(peptides[i:i + 10])}\n")
    rows = {}
    for d in (dev, torch.device("cpu")):
        remove_library_files(workdir)
        out = os.path.join(workdir, f"fasta_{d.type}.mztab")
        t0 = time.perf_counter()
        profile, _ = run_engine_cli(d, fasta, query_path, out,
                                    ["--mode", "bf"])
        log(f"engine cuda-vs-cpu: fasta on {d.type} "
            f"{time.perf_counter() - t0:.1f}s "
            f"(store {profile['notes']['store']})")
        rows[d.type] = _psm_rows(out)
    got, want = rows[dev.type], rows["cpu"]
    differ = [q for q in want if got.get(q) != want[q]]
    for q in differ[:10]:
        log(f"engine cuda-vs-cpu: fasta: {q}: card "
            + json.dumps({k: v for k, v in (got.get(q) or {}).items()
                          if v != want[q].get(k)})
            + " cpu " + json.dumps({k: v for k, v in want[q].items()
                                    if v != (got.get(q) or {}).get(k)}))
    log(f"engine cuda-vs-cpu: fasta: {len(peptides)} peptides, "
        f"{len(want)} PSMs, {len(differ)} lines differ")
    note(f"FASTA ({len(peptides)} peptides) card vs CPU: {len(want)} PSMs, "
         f"{len(differ)} lines differ")
    if not want or got.keys() != want.keys() or differ:
        raise AssertionError(f"fasta: PSM lines differ, CUDA vs CPU: "
                             f"{differ[:5]}")


def _workdir(name):
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)


def _record(name):
    """A committed JSON record of the JAX package (QUALITY_r05.json,
    SWEEP_r02.json) from the checkout, without its TPU search times."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path) as f:
        record = json.load(f)
    for leg in record.values():
        if isinstance(leg, dict):
            leg.pop("search_seconds", None)
    return record


def phase_quality(dev, args=QUALITY_ARGS, workdir=None, full_size=True):
    """Phase 12a: the port's QUALITY harness (`quality.main`, both legs
    and the recall curve) on phase 9's corpus and files.  Gates as in the
    module docstring (the counts' only with `full_size`).  Returns B1's
    and B4's launches in the two legs and B5's in the ann leg."""
    import os

    import torch

    from ann_solo_tpu_torch import cli, quality
    from ann_solo_tpu_torch.ops import select_cuda, shifted_dot_cuda, \
        stage1_cuda
    from ann_solo_tpu_torch.utils.profiling import profiler

    workdir = workdir or _workdir("engine")
    out = os.path.join(workdir, "quality.json")
    legs, recall = {}, {}
    real_main, real_recall = cli.main, quality._ann_recall_curve

    def peak_reset():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)

    def leg(cli_args):
        mode = cli_args[cli_args.index("--mode") + 1]
        peak_reset()
        shifted_dot_cuda.LAUNCHES = 0
        stage1_cuda.LAUNCHES = 0
        select_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = real_main(cli_args)
        legs[mode] = {
            "cli_sec": time.perf_counter() - t0,
            "b1_launches": shifted_dot_cuda.LAUNCHES,
            "b4_launches": stage1_cuda.LAUNCHES,
            "b5_launches": select_cuda.LAUNCHES,
            "max_memory_allocated_bytes": peak(),
            "totals": dict(profiler.totals),
            "counts": dict(profiler.counts), "notes": dict(profiler.notes),
        }
        return rc

    def timed_recall(*recall_args):
        peak_reset()
        t0 = time.perf_counter()
        curve = real_recall(*recall_args)
        recall.update(sec=time.perf_counter() - t0,
                      max_memory_allocated_bytes=peak())
        return curve

    cli.main, quality._ann_recall_curve = leg, timed_recall
    t0 = time.perf_counter()
    try:
        rc = quality.main(list(args) + [
            "--workdir", workdir, "--out", out, "--reuse-corpus"]
            + (["--no_gpu"] if dev.type == "cpu" else []))
    finally:
        cli.main, quality._ann_recall_curve = real_main, real_recall
    t_total = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"quality.main returned {rc}")
    with open(out) as f:
        results = json.load(f)
    record = _record("QUALITY_r05.json")
    for mode, info in legs.items():
        totals, notes = info["totals"], info["notes"]
        log(f"quality {mode} leg: " + json.dumps({
            "cli_sec": info["cli_sec"], "search_sec": totals["search"],
            "queries_per_sec": results["corpus"]["n_queries"]
            / totals["search"],
            "max_memory_allocated_bytes": info["max_memory_allocated_bytes"],
            "b1_launches": info["b1_launches"],
            "b4_launches": info["b4_launches"],
            "b5_launches": info["b5_launches"], "stages_sec": totals,
            "paths": {k: v for k, v in info["counts"].items()
                      if "level charge" in k},
            "files": {k: {f: v[f] for f in ("source", "file")}
                      for k, v in notes.items()
                      if isinstance(v, dict) and "source" in v},
            "regimes": {k: v.get("regime") for k, v in notes.items()
                        if k.startswith("index charge")},
        }))
    log("quality recall curve: " + json.dumps(recall))
    for mode in ("bf", "ann"):
        info, stats = legs[mode], results[mode]
        note(f"{mode} leg: CLI {info['cli_sec']:.2f} s, search "
             f"{info['totals']['search']:.2f} s, {stats['n_confident']} "
             f"confident (accuracy {stats['accuracy']:.5f}), B1 launched "
             f"{info['b1_launches']}, B4 {info['b4_launches']}, B5 "
             f"{info['b5_launches']}")
    note(f"ann/bf {results['ann_vs_bf_ids_ratio']}", "recall@1024 "
         f"{results['ann_candidate_recall']['recall@1024']}",
         f"recall curve {recall.get('sec', 0.0):.2f} s")
    log("quality: " + json.dumps({"sec": t_total, "port": results,
                                  "jax_quality_r05": record}))

    ann, bf = legs["ann"], legs["bf"]
    files = {k: v.get("source") for k, v in ann["notes"].items()
             if isinstance(v, dict) and "source" in v}
    if files != {"store": "loaded", "index charge 2": "loaded",
                 "index charge 3": "loaded"}:
        raise AssertionError(f"quality ann leg: files not loaded: {files}")
    built = [k for k in ann["totals"] if k.startswith(
        ("library read", "decoys", "library preprocess", "store write",
         "index build", "index write"))]
    if built:
        raise AssertionError(f"quality ann leg: files present, yet {built}")
    got = _psm_rows(os.path.join(workdir, "ann.mztab"))
    if got != _psm_rows(os.path.join(workdir, "out_none.mztab")):
        raise AssertionError("quality ann leg: PSM lines differ from run A's")
    if bf["notes"].get("store", {}).get("source") != "loaded":
        raise AssertionError("quality bf leg: the store was not loaded")
    for charge in (2, 3):
        for level in ("std", "open"):
            key = f"{level} level charge {charge}: "
            if bf["counts"].get(key + "window rescoring", 0) <= 0 \
                    or bf["counts"].get(key + "ivf select", 0):
                raise AssertionError(f"quality bf leg: {key} not by window "
                                     f"rescoring: {bf['counts']}")
    for mode, info in legs.items():
        if dev.type == "cuda" and (info["b1_launches"] <= 0
                                   or info["b4_launches"] <= 0):
            raise AssertionError(
                f"quality {mode} leg: B1 launched {info['b1_launches']} "
                f"times, B4 {info['b4_launches']}")
    if dev.type == "cuda" and ann["b5_launches"] <= 0:
        raise AssertionError("quality ann leg: B5 never launched")
    checked = results["ann_candidate_recall"]["n_bf_ssms_checked"]
    if checked != results["bf"]["n_confident"]:
        raise AssertionError(f"quality: {checked} bf SSMs checked of "
                             f"{results['bf']['n_confident']}")
    if full_size:
        want = record["bf"]["n_confident"]
        n_bf = results["bf"]["n_confident"]
        if abs(n_bf - want) > QUALITY_BF_TOLERANCE * want:
            raise AssertionError(f"quality bf: {n_bf} confident, "
                                 f"QUALITY r05 {want}")
        if results["bf"]["accuracy"] < ENGINE_ACCURACY_GATE:
            raise AssertionError(f"quality bf: accuracy "
                                 f"{results['bf']['accuracy']}")
        if results["ann_vs_bf_ids_ratio"] < QUALITY_RATIO_GATE:
            raise AssertionError(f"quality: ann/bf "
                                 f"{results['ann_vs_bf_ids_ratio']}")
        deep = results["ann_candidate_recall"]["recall@1024"]
        if deep < QUALITY_RECALL_GATE:
            raise AssertionError(f"quality: recall@1024 {deep}")
    return (ann["b1_launches"] + bf["b1_launches"],
            ann["b4_launches"] + bf["b4_launches"], ann["b5_launches"])


def phase_tools(dev, workdir=None, n_queries=2048):
    """Phase 12d: the diagnostics on phase 12a's workdir: `bf_profile` on
    its first `n_queries` queries, untraced and then traced
    (`device_trace`, kernel time summed by name), `probe_diag` and
    `fdr_leak_diag`.  Gates: both levels rescored windows and B1 and B4
    launched, the traces hold B1's, B4's and other kernels' time; SSMs
    were checked and no recall falls as the probe depth grows; both legs'
    calibration curves.  Returns B1's and B4's launches."""
    from ann_solo_tpu_torch.ops import shifted_dot_cuda, stage1_cuda
    from ann_solo_tpu_torch.tools import bf_profile, fdr_leak_diag, probe_diag

    workdir = workdir or _workdir("engine")
    no_gpu = dev.type == "cpu"
    shifted_dot_cuda.LAUNCHES = 0
    stage1_cuda.LAUNCHES = 0
    prof = bf_profile.profile(workdir, n_queries, no_gpu,
                              _workdir("bf_profile_trace"))
    launches = shifted_dot_cuda.LAUNCHES
    b4_launches = stage1_cuda.LAUNCHES
    bf_profile.print_table(prof)
    log("bf_profile: " + json.dumps(prof))
    probe = probe_diag.diagnose(workdir, no_gpu)
    log("probe_diag: " + json.dumps(probe))
    if fdr_leak_diag.main([workdir]) != 0:
        raise AssertionError("fdr_leak_diag failed")
    with open(os.path.join(workdir, "fdr_leak_diag.json")) as f:
        leak = json.load(f)
    legs, trace = prof["legs"], prof["trace"]
    for level in ("std", "open"):
        leg = legs.get(f"{level} window_rescore")
        if not leg or leg["pairs"] <= 0:
            raise AssertionError(f"bf_profile: no {level} window rescoring")
        note(f"{level} window rescoring {leg['sec']:.2f} s, "
             f"{leg['pairs']} pairs in {leg['calls']} calls")
    note(f"bf_profile {prof['n_queries']} queries: search "
         f"{prof['search_sec']:.2f} s, traced {trace['search_sec_traced']:.2f}"
         " s", f"rescoring's device time {trace['device_sec']:.3f} s: B1 "
         f"{trace['b1_sec']:.4f} s ({100 * (trace['b1_share'] or 0):.3g}%), "
         f"B4 {trace['b4_sec']:.4f} s "
         f"({100 * (trace['b4_share'] or 0):.3g}%), the rest "
         f"{trace['other_kernels_sec']:.3f} s",
         f"B1 launched {launches}, B4 {b4_launches}")
    plain = probe["recall"]["plain"]
    note(f"probe_diag {probe['n_checked']} SSMs: probed-list recall "
         f"p<=256 {plain['p<=256']:.4f} (radius "
         f"{probe['recall']['radius']['p<=256']:.4f})")
    note("foreign leak at 1% FDR: " + ", ".join(
        f"{mode} {leak[mode]['calibration'][1]['foreign_leak_rate']}"
        for mode in ("bf", "ann")))
    if dev.type == "cuda" and (launches <= 0 or b4_launches <= 0
                               or trace["b1_sec"] <= 0
                               or trace["b4_sec"] <= 0
                               or trace["other_kernels_sec"] <= 0):
        raise AssertionError(f"bf_profile: B1 launched {launches}, B4 "
                             f"{b4_launches}, trace {trace}")
    if probe["n_checked"] <= 0:
        raise AssertionError("probe_diag checked no SSM")
    for row in probe["recall"].values():
        values = [row[f"p<={p}"] for p in probe_diag.PROBES]
        if values != sorted(values):
            raise AssertionError(f"probe_diag: recall falls with depth: "
                                 f"{probe['recall']}")
    if set(leak) != {"bf", "ann"}:
        raise AssertionError(f"fdr_leak_diag: legs {sorted(leak)}")
    return launches, b4_launches


def phase_sweep(dev, n=131072, n_queries=1024, k=1024,
                num_list=(1024, 2048, 4096), num_probe=(32, 64, 128, 256),
                seed=11):
    """Phase 12b: the port's SWEEP harness in its default (Gaussian
    vectors) mode, then `bruteforce_search` on the card against its CPU
    run on the same inputs.  Gates as in the module docstring."""
    import os

    from ann_solo_tpu_torch import sweep
    from ann_solo_tpu_torch.index.ivf import bruteforce_search

    out = os.path.join(_workdir("sweep"), "sweep.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    rc = sweep.main(
        ["--n", str(n), "--n-queries", str(n_queries), "--k", str(k),
         "--seed", str(seed), "--out", out, "--num-list"]
        + [str(v) for v in num_list] + ["--num-probe"]
        + [str(v) for v in num_probe]
        + (["--no_gpu"] if dev.type == "cpu" else []))
    t_sweep = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"sweep.main returned {rc}")
    with open(out) as f:
        grid = json.load(f)["grid"]
    record = {(e["num_list"], e["num_probe"]): e
              for e in _record("SWEEP_r02.json")["grid"]}
    vectors, _, queries = sweep.gaussian_corpus(n, n_queries, seed)
    times, ids = {}, {}
    for name, d in (("device", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        ids[name] = bruteforce_search(vectors, queries, k, device=d)
        times[name] = time.perf_counter() - t0
    # The share of the card's top-k ids the CPU's top-k of the same query
    # holds (the sets recall is measured against); the positional share
    # is lower: the two f32 products sum in other orders, which swaps
    # neighbouring ranks whose scores differ in the last bits.
    equal = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                           for a, b in zip(ids["device"], ids["cpu"])]))
    positional = float((ids["device"] == ids["cpu"]).mean())
    for entry in grid:
        jax = record.get((entry["num_list"], entry["num_probe"]), {})
        log("sweep: " + json.dumps({
            "port": entry, "jax_sweep_r02": {
                key: v for key, v in jax.items()
                if key.startswith("recall@")}}))
    note(f"sweep.main {t_sweep:.2f} s, {len(grid)} grid points",
         f"bruteforce_search card {times['device']:.3f} s, CPU "
         f"{times['cpu']:.2f} s, {equal:.6f} of ids in the CPU's top-k")
    log("sweep: " + json.dumps({
        "sec": t_sweep, "bruteforce_sec": times,
        "bruteforce_ids_in_cpu_top_k": equal,
        "bruteforce_ids_equal_cpu_position": positional}))
    if equal < 0.999:
        raise AssertionError(f"bruteforce_search: {equal} of the ids in the "
                             "CPU run's top-k")
    for a, b in zip(grid, grid[1:]):
        if a["num_list"] != b["num_list"]:
            continue
        fell = [key for key in a if key.startswith("recall@")
                and b[key] < a[key]]
        if fell:
            raise AssertionError(f"sweep: {fell} fell from num_probe "
                                 f"{a['num_probe']} to {b['num_probe']} at "
                                 f"num_list {a['num_list']}")


def phase_plot_matching(dev, workdir=None, n_each=10):
    """Phase 12c: `plot.ssm_matches` for confident target PSMs of run A's
    mzTab (`n_each` unmodified, `n_each` modified) on the card and on the
    CPU: the peak matches must be identical.  Returns B1's launches of the
    card's run."""
    import os

    from ann_solo_tpu_torch.eval import confident_targets
    from ann_solo_tpu_torch.io.mztab import read_mztab_ssms
    from ann_solo_tpu_torch.ops import shifted_dot_cuda
    from ann_solo_tpu_torch.plot import ssm_matches

    path = os.path.join(workdir or _workdir("engine"), "out_none.mztab")
    confident = confident_targets(read_mztab_ssms(path), ENGINE_FDR)
    shift = np.abs(confident["exp_mass_to_charge"]
                   - confident["calc_mass_to_charge"]) * confident["charge"]
    ids = [confident.index[i] for i in np.nonzero(shift <= 0.1)[0][:n_each]]
    ids += [confident.index[i] for i in np.nonzero(shift > 0.1)[0][:n_each]]
    shifted_dot_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    got = ssm_matches(path, ids, device=dev)
    t_dev = time.perf_counter() - t0
    launches = shifted_dot_cuda.LAUNCHES
    want = ssm_matches(path, ids, device="cpu")
    position = {qid: i for i, qid in enumerate(confident.index)}
    differ = []
    for qid, g, w in zip(ids, got, want):
        same = np.array_equal(g.peak_matches, w.peak_matches)
        if not same:
            differ.append(qid)
        log("plot matching: " + json.dumps({
            "psm": qid, "matches": len(g.peak_matches),
            "identical_to_cpu": same, "score": g.score,
            "cpu_score": w.score, "mztab_score": float(
                confident["search_engine_score[1]"][position[qid]])}))
    log(f"plot matching: {len(ids)} PSMs in {t_dev:.2f}s on {dev.type}, "
        f"B1 launches {launches}, {len(differ)} differ from the CPU's")
    note(f"{len(ids)} PSMs matched in {t_dev:.2f} s, {len(differ)} differ "
         f"from the CPU's", f"B1 launched {launches}")
    if len(ids) != 2 * n_each or differ:
        raise AssertionError(f"plot matching: {len(ids)} PSMs, differ from "
                             f"the CPU's: {differ}")
    if dev.type == "cuda" and launches <= 0:
        raise AssertionError("plot matching: no greedy kernel launched")
    return launches


def run_phases():
    """Every phase in order; returns the kernels' record (the line before
    the last) and the card's nvidia-smi line."""
    import torch

    t_start = time.perf_counter()
    dev, smi = phase("1", phase_device)
    phase("2", phase_build)
    record = phase("3", phase_kernel, dev)
    probe_record = phase("3b", phase_probe_kernel, dev)
    scan_record = phase("3c", phase_scan_kernel, dev)
    stage1_record = phase("3d", phase_stage1_kernel, dev)
    select_record = phase("3e", phase_select_kernel, dev)
    (launches, b2_launches, b4_launches, b5_launches, index, lib,
     lib_arrays, params) = phase("4", phase_slice, dev)
    phase("5", phase_preprocess, dev, index, lib, lib_arrays, params)
    del index, lib
    phase("6", phase_cuda_vs_cpu, dev)
    big = phase("7", phase_big_slice, dev)
    b4_launches += big["b4_launches"]
    b5_launches += big["b5_launches"]
    b3_launches = phase("8", phase_b3_slice, dev, big)
    big_launches = (b2_launches + big["launches"]
                    + phase("7b", phase_scale_demo, dev))
    phase("10a", phase_streaming_switch, dev, big)
    del big  # phases 7 and 8's library, index and batches
    torch.cuda.empty_cache()
    s8m = phase("10b", phase_streaming_8m, dev)
    b5_launches += s8m["b5_launches"]
    big_launches += phase("11a", phase_sharded_8m, dev, s8m)
    del s8m["index"], s8m["run"], s8m["select"], s8m["probe"], s8m["oracle"]
    torch.cuda.empty_cache()
    phase("11b", phase_born_sharded, dev, s8m)
    del s8m
    torch.cuda.empty_cache()
    b4, b5 = phase("9", phase_engine, dev)
    b4_launches += b4
    b5_launches += b5
    phase("11c", phase_sharded_engine, dev)
    phase("9s", phase_engine_cuda_vs_cpu, dev)
    b1, b4, b5 = phase("12a", phase_quality, dev)
    launches += b1
    b4_launches += b4
    b5_launches += b5
    b1, b4 = phase("12d", phase_tools, dev)
    launches += b1
    b4_launches += b4
    phase("12b", phase_sweep, dev)
    launches += phase("12c", phase_plot_matching, dev)
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s",
          file=_STDOUT, flush=True)
    kernels = []
    for name, source, replaces, n, rec in (
            ("shifted_dot_greedy", "shifted_dot.cu",
             "ann_solo_tpu/ops/shifted_dot_pallas.py:35", launches, record),
            ("ivf_probe_scan", "ivf_probe_scan.cu",
             "ann_solo_tpu/ops/ivf_probe_pallas.py:105", big_launches,
             probe_record),
            ("ivf_chunked_scan", "ivf_chunked_scan.cu",
             "ann_solo_tpu/ops/ivf_scan_pallas.py:146", b3_launches,
             scan_record),
            ("stage1_bounds", "stage1_bounds.cu",
             "ann_solo_tpu/ops/rescore.py:60", b4_launches, stage1_record),
            ("canonical_select", "canonical_select.cu",
             "ann_solo_tpu/index/ivf.py:673", b5_launches, select_record)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"ann_solo_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": n,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
        })
        if "cases" in rec:  # the cases held bit-identical to the plain
            kernels[-1]["cases"] = rec["cases"]
    return kernels, smi


def _report_failure():
    """The failing phase, its traceback and the log's last lines on
    standard output."""
    seconds = time.perf_counter() - _PHASE["start"]
    print(f"chip_smoke {_PHASE['label']}: FAILED after {seconds:.1f} s",
          file=_STDOUT)
    print(traceback.format_exc(), file=_STDOUT, end="")
    if _LOG is not None:
        _LOG.flush()
        with open(LOG_PATH) as f:
            tail = f.readlines()[-30:]
        print(f"last lines of {os.path.relpath(LOG_PATH)}:", file=_STDOUT)
        for line in tail:
            print("  " + line.rstrip()[:400], file=_STDOUT)
    _STDOUT.flush()


def main():
    global _LOG
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(2)
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    _LOG = open(LOG_PATH, "w")
    try:
        kernels, smi = run_phases()
    except BaseException:
        _report_failure()
        sys.exit(1)
    finally:
        _LOG.close()
        _LOG = None
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
