"""Smoke run of the PyTorch port on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py

Phases, each raising on failure (non-zero exit, no final line):

1. device: needs CUDA; prints torch/CUDA versions and the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the three CUDA kernels from `ann_solo_tpu_torch/csrc/`
   and the three native C++ library parsers from `csrc/native/` (into
   `build/native/`), one nvcc or g++ per source, all started together;
   a parser that does not build or load fails the run;
3. kernel B1 vs plain: the greedy shifted-dot kernel against its plain
   PyTorch version on the card, at the stage-2 (32,768 pairs) and
   match-extraction (4,096 pairs) shapes of the bench workload plus
   ragged, unequal-width, tie-heavy, K = 20 / 128 and dense (every entry
   positive) cases.  Totals must be equal bit for bit (rtol 0: both sum
   the same float32 terms in the same order) and the match tables
   identical;
3b. kernel B2 vs plain: the probe-gather scan against its plain version at
   the 2.1M-spectrum tile shape (B = 1,024, P = 64, cap = 768, D = 800,
   int8, +-500 Da), bf16 storage with a ppm window, a ragged shape
   (B = 7, cap = 200, D = 100), exact tie-heavy data, exact ragged bf16,
   the tile with every query probing the same 64 lists, and phase 8's
   hot-list shape (P = 8); the two ragged cases carry probe ids -1 and L,
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
   16-bit key within one step.  Phases 3-3c log each kernel's time
   beside its bound: the larger of its bytes (each input read once, each
   output written once; for B2 and B3 only the lists and chunks this
   run's probes touch) over 3.35 TB/s and its operations over the peak
   rate of their type (bf16 tensor cores for B2 and B3, f32 for B1: the
   matrix build alone, since the greedy walks only positive entries);
4. the open-search slice at the bench scale: a 131,072-spectrum library
   (K = 50 peaks, hash_len 800), auto num_list, num_probe 512, x2 SOAR
   redundancy, int8 storage; 4 batches of 4,096 charge-2 queries, +-500 Da,
   512 candidates, fragment tolerance 0.04, certificate rescoring and
   best-pair matches.  Gate: self-match hit rate >= 0.95 per batch; B1's
   launch count must grow during the timed batches;
5. preprocess: a raw 4,096-spectrum block through `preprocess_batch`
   (CUDA vs CPU identical) and one more search batch;
6. CUDA vs CPU: the same slice on a 16,384-spectrum index with 256 queries
   on both devices: the same best index for >= 99.9% of queries, scores at
   rtol 1e-5;
7. the big-library slice (SCALE r04's single-chip configuration): a
   2,097,152-spectrum library made and vectorized on the card, an int8
   index of 4,096 lists, num_probe 64, no redundancy (the f32 vectors are
   freed after the build); 4 timed batches of 1,024 queries with 1,024
   candidates through the probe path.  Gates: B2's launch count grows
   during the timed batches; on one batch the probe path agrees with the
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
   memory, B1's launches and the identification counts from the mzTab
   beside the JAX package's (QUALITY_r05.json).  Gates, every run: the
   CLI returns 0; B1 launched; each charge's open level went through
   `IvfIndex.search_device` and its std level through window rescoring;
   accuracy among confident PSMs >= 0.95; confident PSMs >= 0.9 x the
   9,500 non-foreign queries.  Runs B and C besides: the store and both
   indexes were loaded, not built; no library read, decoy, preprocess or
   index build seconds; confident PSMs at q < 0.01 no fewer than run A's
   less 1%.  Then, on a 4,000-peptide corpus (seed 7, 1,000 queries), the
   store built twice with run A's settings, through the native reader and
   from the Python reader's spectra: every column identical; and the CLI
   on that corpus: --model none twice on the card, built then loaded,
   identical PSM lines; --model svm and --model rf on the card and with
   --no_gpu (files loaded): the same PSM_IDs and library spectra, q-values
   at rtol 1e-6, every differing line logged; and, each run building its
   own files, on the card and with --no_gpu in --mode ann and bf: the same
   PSM_IDs, the same library spectrum for >= 99.9% of them, identical PSM
   lines wherever it is.
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
   timed with its peak device memory, B1's launches and the regimes.
   Gates: the ann leg loads the store and both indexes (no library read,
   decoy, preprocess or index build seconds) and writes run A's PSM
   lines; the bf leg loads the store and runs every level of both charges
   by window rescoring, launching B1; bf confident PSMs at q < 0.01
   within 1% of QUALITY r05's 9,467 with accuracy >= 0.95;
   ann_vs_bf_ids_ratio >= 0.98; recall@1024 >= 0.97 over all of bf's
   confident PSMs.  Logs every key beside QUALITY r05's counts (not its
   TPU seconds);
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

The line before the last is the kernels' JSON record (B1's launches: phase
4's timed batches and phase 12's; B2's: phase 7's and phase 11a's timed
batches); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
NUM_PROBE = 512
HIT_RATE_GATE = 0.95

# (name, pairs, query peaks, library peaks, charge, allow_shift, ties,
# fragment tolerance).  "dense": a tolerance wider than the m/z range, so
# every one of the K x K entries is positive.
KERNEL_CASES = (
    ("stage2", 32768, 50, 50, 2, True, False, FRAG_TOL),
    ("matches", 4096, 50, 50, 2, True, True, FRAG_TOL),
    ("noshift_c3", 4096, 50, 50, 3, False, False, FRAG_TOL),
    ("ragged_unequal", 5003, 50, 32, 3, True, True, FRAG_TOL),
    ("k128", 1000, 128, 128, 2, True, False, FRAG_TOL),
    ("k20", 777, 20, 20, 2, True, True, FRAG_TOL),
    ("dense", 1024, 50, 50, 2, True, False, 5000.0),
)

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

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, 700 W) for the
# kernels' bounds: HBM bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

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


def log(*args):
    print(*args, flush=True)


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


def synth_library(rng, n, k=K_PEAKS):
    """bench.py's `synth_processed`, sorted by precursor m/z."""
    mz = np.sort(rng.uniform(101.0, 1500.0, (n, k)).astype(np.float32), 1)
    intensity = rng.uniform(0.1, 1.0, (n, k)).astype(np.float32)
    intensity /= np.linalg.norm(intensity, axis=1, keepdims=True)
    ann = rng.integers(0, CHARGE + 1, (n, k)).astype(np.int32)
    prec = rng.uniform(400.0, 1200.0, n).astype(np.float64)
    order = np.argsort(prec, kind="stable")
    return mz[order], intensity[order], ann[order], prec[order]


def synth_queries(rng, lib, n_q):
    """Noised copies of library rows (bench.py's query batches)."""
    lib_mz, lib_int, _, lib_prec = lib
    n, k = lib_mz.shape
    rows = rng.choice(n, n_q, replace=False)
    q_mz = lib_mz[rows] + rng.normal(0, 0.005, (n_q, k)).astype(np.float32)
    q_int = np.abs(
        lib_int[rows] + rng.normal(0, 0.02, (n_q, k)).astype(np.float32)
    )
    q_int /= np.linalg.norm(q_int, axis=1, keepdims=True)
    q_prec = lib_prec[rows] + rng.normal(0, 0.002, n_q)
    return rows, np.sort(q_mz, axis=1), q_int, q_prec


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


def phase_device():
    import torch

    from ann_solo_tpu_torch.device import require_cuda

    dev = require_cuda()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    return dev


PARSERS = ("splib_parser", "sptxt_parser", "mgf_parser")


def phase_build(names=("shifted_dot", "ivf_probe_scan", "ivf_chunked_scan"),
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


def phase_kernel(dev, cases=KERNEL_CASES, kernel_reps=20, plain_reps=3):
    """Kernel vs plain version on the same tensors; returns the record of
    the stage-2 shape (times) and the largest total difference."""
    import torch

    from ann_solo_tpu_torch.ops.shifted_dot import (
        pair_score_matrix as shifted_dot_scores_matrix,
        shifted_dot_full_plain,
    )
    from ann_solo_tpu_torch.ops.shifted_dot_cuda import (
        pad_peaks,
        shifted_dot_full,
    )

    rng = np.random.default_rng(2024)
    record = {"max_abs_err": 0.0}
    for name, p, kq, kc, charge, shift, ties, tol in cases:
        arrays = [
            torch.from_numpy(a).to(dev)
            for a in synth_pairs(rng, p, kq, kc, charge, ties)
        ]
        qm, qi, cm, ci, ca = pad_peaks(*arrays[:5])
        args = (qm, qi, cm, ci, ca, *arrays[5:], tol, charge + 1, shift)
        total, match = shifted_dot_full(*args)
        p_total, p_match = shifted_dot_full_plain(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        err = float((total - p_total).abs().max())
        record["max_abs_err"] = max(record["max_abs_err"], err)
        n_match = int((p_match >= 0).sum())
        if not (torch.equal(total, p_total) and torch.equal(match, p_match)):
            raise AssertionError(
                f"kernel != plain at {name}: max |d total| {err}, "
                f"{int((match != p_match).sum())} match entries differ"
            )
        ms = time_ms(lambda: shifted_dot_full(*args), dev, kernel_reps)
        plain_ms = time_ms(
            lambda: shifted_dot_full_plain(*args), dev, plain_reps
        )
        # The function's least work, at the unpadded widths: per shift a
        # difference, a second difference, |.|, a compare and a max for
        # each of the Kq x Kc entries, then the intensity product (2).
        # The greedy needs no pass over the matrix (the kernel walks the
        # positive entries).  The count logged beside it also charges a
        # dense greedy: a compare and a select per entry, once per match
        # and once to stop.
        n_shifts = charge + 1 if shift else 1
        ops = p * kq * kc * (5 * n_shifts + 2)
        dense_greedy = (n_match + p) * kq * kc * 2
        n_bytes = tensor_bytes(*args[:8], total, match)
        fields = bound("B1", name, ms, n_bytes, ops, F32_FLOPS)
        if name == cases[0][0]:  # the stage-2 shape goes in the record
            log(f"bound B1 {name}, the old count with the dense greedy: "
                f"{ops + dense_greedy:.4g} ops -> "
                f"{(ops + dense_greedy) / F32_FLOPS * 1e3:.4f} ms")
            record.update(ms=ms, plain_ms=plain_ms, **fields)
        # Positive entries a pair: the list the kernel walks.
        n_pos = int((shifted_dot_scores_matrix(*args) > 0).sum()) / p
        log(f"kernel {name}: P={p} K={qm.shape[1]} charge={charge} "
            f"shift={shift} ties={ties} tol={tol}: identical ({n_match} "
            f"matches, {n_pos:.1f} positive entries a pair); kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
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
    """The bench workload through the port's entry points."""
    import torch

    from ann_solo_tpu_torch.convert import library_from_numpy
    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index.ivf import IvfIndex
    from ann_solo_tpu_torch.models.vectorize import (
        VectorizeParams,
        device_tables,
        vectorize_batch,
    )
    from ann_solo_tpu_torch.ops import shifted_dot_cuda
    from ann_solo_tpu_torch.search import (
        OpenSearchParams,
        ann_open_search_batch,
    )

    rng = np.random.default_rng(42)
    lib_arrays = synth_library(rng, n_lib)
    lib_mz, lib_int, lib_ann, lib_prec = lib_arrays
    params = OpenSearchParams(
        vectorize=VectorizeParams(11.0, 2010.0, 0.04, HASH_LEN),
        num_candidates=NUM_CANDIDATES,
        precursor_tolerance_mass_open=OPEN_TOL_DA,
        precursor_tolerance_mode_open="Da",
        fragment_mz_tolerance=FRAG_TOL,
        allow_peak_shifts=True,
    )
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tables = device_tables(params.vectorize, dev)
    chunk = 4096
    lib_vectors = torch.cat([
        vectorize_batch(
            params.vectorize, tables,
            torch.from_numpy(lib_mz[s:s + chunk]).to(dev),
            torch.from_numpy(lib_int[s:s + chunk]).to(dev),
            torch.full((len(lib_mz[s:s + chunk]),), K_PEAKS, device=dev),
        )
        for s in range(0, n_lib, chunk)
    ])
    synchronize(dev)
    t_vec = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = IvfIndex.build(
        lib_vectors, BenchConfig(), precursor_mz=lib_prec.astype(np.float32),
        storage_dtype=torch.int8, device=dev,
    )
    synchronize(dev)
    t_build = time.perf_counter() - t0
    l, cap, d = index.padded_vectors.shape
    log(f"library: {n_lib} spectra vectorized in {t_vec:.3f}s; IVF build "
        f"{t_build:.3f}s ({l} lists x cap {cap} x {d}, int8, "
        f"x{index.redundancy}, num_probe {index.num_probe})")
    lib = library_from_numpy(lib_mz, lib_int, lib_ann, lib_prec, dev)
    batches = [synth_queries(rng, lib_arrays, n_q) for _ in range(n_batches)]
    q_n = np.full(n_q, K_PEAKS, np.int32)

    def run(batch, stages=None):
        _, q_mz, q_int, q_prec = batch
        return ann_open_search_batch(
            index, lib, q_mz, q_int, q_n, q_prec, CHARGE, params,
            stage_seconds=stages,
        )

    run(batches[0])  # warm-up (cuBLAS handles, caches)
    synchronize(dev)
    shifted_dot_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    outs = [run(batch) for batch in batches]
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    launches = shifted_dot_cuda.LAUNCHES
    hit_rates = []
    for batch, (best, score, n_cands, matches) in zip(batches, outs):
        _check_outputs(best, score, n_cands, matches, n_lib, n_q)
        hit_rates.append(float(np.mean(best == batch[0])))
    stages = {}
    run(batches[1], stages)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = {
        "queries_per_sec": n_batches * n_q / elapsed,
        "batch_sec": elapsed / n_batches,
        "stages_sec_per_batch": stages,
        "library_vectorize_sec": t_vec,
        "ivf_build_sec": t_build,
        "max_memory_allocated_bytes": peak,
        "self_match_hit_rates": hit_rates,
        "mean_candidates": float(np.mean(outs[-1][2])),
        "kernel_launches": launches,
    }
    log("slice: " + json.dumps(summary))
    if min(hit_rates) < HIT_RATE_GATE:
        raise AssertionError(f"self-match hit rate {hit_rates} < gate")
    if launches <= 0 and dev.type == "cuda":
        raise AssertionError("the greedy kernel was not launched")
    return launches, index, lib, lib_arrays, params


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
    if hit < HIT_RATE_GATE:
        raise AssertionError(f"preprocessed hit rate {hit} < gate")


def phase_cuda_vs_cpu(dev, n_lib=16384, n_q=256):
    import torch

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
    results = {}
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
        log(f"cuda-vs-cpu: {d.type} slice {time.perf_counter() - t0:.2f}s")
    g_best, g_score, _, g_match = results[dev.type]
    c_best, c_score, _, c_match = results["cpu"]
    same = g_best == c_best
    frac = float(np.mean(same))
    log(f"cuda-vs-cpu: {n_lib}-spectrum index, {n_q} queries: same best "
        f"index for {frac:.4f}")
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
    from ann_solo_tpu_torch.ops import ivf_probe_cuda
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
    t0 = time.perf_counter()
    outs = [run(batch) for batch in batches]
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    launches = ivf_probe_cuda.LAUNCHES
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
    })
    log(f"{name}: " + json.dumps(summary))
    if launches <= 0 and dev.type == "cuda":
        raise AssertionError(f"{name}: kernel B2 was not launched")
    if same_lane < 0.999 or key_step > 1:
        raise AssertionError(
            f"{name}: probe path vs oracle: {same_lane} lanes equal, key16 "
            f"step {key_step}")
    for i, rate in enumerate(hit_rates):
        if rate < HIT_RATE_GATE and rate < oracle_rates[i] - 1.0 / n_q:
            raise AssertionError(
                f"{name}, batch {i}: best-match hit rate {rate} below the "
                f"gate and below the oracle's {oracle_rates[i]}")
    return {"launches": launches, "index": index, "lib": lib,
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
    for charge in (2, 3):
        note = notes.get(f"index charge {charge}", {})
        if note.get("source") != "loaded":
            raise AssertionError(f"charge {charge}: the index was not loaded "
                                 f"from run A's file: {note}")
        if note.get("sharded", {}).get("mesh") != mesh.shape:
            raise AssertionError(f"charge {charge}: the index is not a "
                                 f"ShardedIvfIndex on {mesh.shape}: {note}")
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
    (the stage profile, the B1 launches of the run)."""
    from ann_solo_tpu_torch import cli
    from ann_solo_tpu_torch.ops import shifted_dot_cuda
    from ann_solo_tpu_torch.utils.profiling import profiler

    args = [lib_path, query_path, out_path] + ENGINE_ARGS + list(extra)
    if dev.type == "cpu":
        args.append("--no_gpu")
    shifted_dot_cuda.LAUNCHES = 0
    rc = cli.main(args)
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    return ({"totals": dict(profiler.totals), "counts": dict(profiler.counts),
             "notes": dict(profiler.notes)}, shifted_dot_cuda.LAUNCHES)


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
    Returns (the identification statistics, B1's launches)."""
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
        "identifications": stats,
        "jax_quality_r05_ann": QUALITY_R05_ANN,
    }
    log("engine: " + json.dumps(summary))
    if launches <= 0 and dev.type == "cuda":
        raise AssertionError(f"{name}: the engine launched no greedy kernel")
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
    return stats, launches


def phase_engine(dev, n_peptides=ENGINE_PEPTIDES, n_queries=ENGINE_QUERIES,
                 workdir=None):
    """The engine on the card: QUALITY r05's corpus through the port's
    CLI (std level by window rescoring, open level through the IVF
    index).  Run A builds and writes the store and index files with
    --model none; runs B (--model rf, the CLI's default) and C (--model
    svm) read them.  Returns B1's launches summed over the runs."""
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
    none, launches = engine_run(dev, "run A", *args, "none", False)
    total = launches
    for name, model in (("run B", "rf"), ("run C", "svm")):
        _, launches = engine_run(dev, name, *args, model, True, none)
        total += launches
    return total


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


def phase_engine_cuda_vs_cpu(dev, n_peptides=4000, n_queries=1000,
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
        if frac < 0.999:
            raise AssertionError(f"{mode}: same library spectrum for {frac}")
        if differ:
            raise AssertionError(f"{mode}: PSM lines differ: {differ[:5]}")

    fasta_cuda_vs_cpu(dev, workdir, query_path, truth)


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
    launches in the two legs."""
    import os

    import torch

    from ann_solo_tpu_torch import cli, quality
    from ann_solo_tpu_torch.ops import shifted_dot_cuda
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
        t0 = time.perf_counter()
        rc = real_main(cli_args)
        legs[mode] = {
            "cli_sec": time.perf_counter() - t0,
            "b1_launches": shifted_dot_cuda.LAUNCHES,
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
            "b1_launches": info["b1_launches"], "stages_sec": totals,
            "paths": {k: v for k, v in info["counts"].items()
                      if "level charge" in k},
            "files": {k: {f: v[f] for f in ("source", "file")}
                      for k, v in notes.items()
                      if isinstance(v, dict) and "source" in v},
            "regimes": {k: v.get("regime") for k, v in notes.items()
                        if k.startswith("index charge")},
        }))
    log("quality recall curve: " + json.dumps(recall))
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
    if dev.type == "cuda" and bf["b1_launches"] <= 0:
        raise AssertionError("quality bf leg: no greedy kernel launched")
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
    return ann["b1_launches"] + bf["b1_launches"]


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
    if len(ids) != 2 * n_each or differ:
        raise AssertionError(f"plot matching: {len(ids)} PSMs, differ from "
                             f"the CPU's: {differ}")
    if dev.type == "cuda" and launches <= 0:
        raise AssertionError("plot matching: no greedy kernel launched")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    record = phase_kernel(dev)
    probe_record = phase_probe_kernel(dev)
    scan_record = phase_scan_kernel(dev)
    launches, index, lib, lib_arrays, params = phase_slice(dev)
    phase_preprocess(dev, index, lib, lib_arrays, params)
    del index, lib
    phase_cuda_vs_cpu(dev)
    big = phase_big_slice(dev)
    b3_launches = phase_b3_slice(dev, big)
    phase_streaming_switch(dev, big)
    big_launches = big["launches"]
    del big  # phases 7 and 8's library, index and batches
    torch.cuda.empty_cache()
    s8m = phase_streaming_8m(dev)
    big_launches += phase_sharded_8m(dev, s8m)
    del s8m["index"], s8m["run"], s8m["select"], s8m["probe"], s8m["oracle"]
    torch.cuda.empty_cache()
    phase_born_sharded(dev, s8m)
    del s8m
    torch.cuda.empty_cache()
    phase_engine(dev)
    phase_sharded_engine(dev)
    phase_engine_cuda_vs_cpu(dev)
    launches += phase_quality(dev)
    phase_sweep(dev)
    launches += phase_plot_matching(dev)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [
        {
            "name": "shifted_dot_greedy",
            "route": "cuda",
            "source": "ann_solo_tpu_torch/csrc/shifted_dot.cu",
            "replaces": "ann_solo_tpu/ops/shifted_dot_pallas.py:35",
            "launches": launches,
            "max_abs_err": record["max_abs_err"],
            "ms": record["ms"],
            "plain_ms": record["plain_ms"],
            "bound_ms": record["bound_ms"],
            "bound_by": record["bound_by"],
            "library_ms": None,
        },
        {
            "name": "ivf_probe_scan",
            "route": "cuda",
            "source": "ann_solo_tpu_torch/csrc/ivf_probe_scan.cu",
            "replaces": "ann_solo_tpu/ops/ivf_probe_pallas.py:105",
            "launches": big_launches,
            "max_abs_err": probe_record["max_abs_err"],
            "ms": probe_record["ms"],
            "plain_ms": probe_record["plain_ms"],
            "bound_ms": probe_record["bound_ms"],
            "bound_by": probe_record["bound_by"],
            "library_ms": None,
        },
        {
            "name": "ivf_chunked_scan",
            "route": "cuda",
            "source": "ann_solo_tpu_torch/csrc/ivf_chunked_scan.cu",
            "replaces": "ann_solo_tpu/ops/ivf_scan_pallas.py:146",
            "launches": b3_launches,
            "max_abs_err": scan_record["max_abs_err"],
            "ms": scan_record["ms"],
            "plain_ms": scan_record["plain_ms"],
            "bound_ms": scan_record["bound_ms"],
            "bound_by": scan_record["bound_by"],
            "library_ms": None,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
