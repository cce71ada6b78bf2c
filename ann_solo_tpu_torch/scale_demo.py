"""Scale demonstration: a multi-million-vector IVF index on one card.

The port of the repo's `scale_demo.py`, with its options and defaults:
a 2,097,152 x 800 int8 index (4,096 lists, num_probe 64, one copy a
vector) built from unit vectors, then open-search select throughput and
how often each query's source row is among its candidates.

    python -m ann_solo_tpu_torch.scale_demo [--n 2097152] [--out SCALE.json]
        [--streaming | --sharded [--multislice] | --sharded-gpu] [--no_gpu]

* default: the rows generated on the device (`make_gen_rows`) into a
  float32 source block, `IvfIndex.build` in memory, the block freed
  before the search;
* ``--streaming``: `IvfIndex.build_streaming` fetching rows from the
  generator on demand, so no (n, D) block ever exists (for n >= 4M);
* ``--sharded`` (``--multislice``): the born-sharded build
  (`ShardedIvfIndex.build_sharded`) of host-generated rows over a
  ('dp', 'lib') (or ('dcn', 'dp', 'lib')) mesh of `MESH_DEVICES` torch
  devices: the available CUDA devices in turn (on one card, the card
  repeated), or the CPU with ``--no_gpu``;
* ``--sharded-gpu`` (the JAX ``--sharded-tpu``): the born-sharded
  streaming build and the sharded select through `ShardedIvfIndex` on a
  (1, 1) mesh of the card.

Writes `--out` and prints one JSON line with the JAX script's keys;
`metric` names the device, and the ``extrapolation`` block is computed
from the card's own memory and the measured bytes a vector.  Runs on the
CUDA GPU and raises without one, unless ``--no_gpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

D = 800
CHARGE = 2
OPEN_TOL_DA = 500.0
SEARCH_RUNS = 8
MESH_DEVICES = 8  # the JAX script's virtual CPU mesh
_U32 = 0xFFFFFFFF


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 `x` in [0, 2^32) without int64 overflow:
    the constant split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer in int64 masked to 32 bits."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def make_gen_rows(n: int, device):
    """Deterministic unit-vector generator: (M,) row ids -> (M, D) float32
    rows on `device`, the JAX `make_gen_rows`'s.

    Each value is a pure function of (row, column): murmur3's `fmix` of
    the row, xor the column, mixed again (h1), and once more with the
    golden-ratio constant (h2); Box-Muller of the two as float32
    uniforms; each row scaled to unit norm.  So any fetch order returns
    the same rows, which `build_streaming` relies on.  Row ids are
    clamped to [0, n)."""
    cols = torch.arange(D, dtype=torch.int64, device=device)

    def gen_rows(idx):
        idx = torch.as_tensor(idx).to(device=device, dtype=torch.int64)
        idx = idx.clamp(0, n - 1)
        h1 = _fmix(_fmix(idx)[:, None] ^ cols)
        h2 = _fmix(h1 ^ 0x9E3779B9)
        u1 = (h1.to(torch.float32) + 0.5) / 4294967296.0
        u2 = (h2.to(torch.float32) + 0.5) / 4294967296.0
        sub = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            2.0 * math.pi * u2)
        return sub / torch.linalg.vector_norm(sub, dim=1, keepdim=True)

    return gen_rows


class _Config:
    """The IVF settings of the command line."""

    def __init__(self, args, redundancy):
        self.num_list = args.num_list
        self.num_probe = args.num_probe
        self.ivf_redundancy = redundancy


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _queries(args, n, rng, gen_rows, dev):
    """(source rows, unit queries, precursor m/z) of `args.n_queries`
    noised copies of distinct rows: the rows drawn from `rng` as the JAX
    script draws them, the noise from ``default_rng(11)``."""
    b = args.n_queries
    query_rows = rng.choice(n, b, replace=False)
    noise = np.random.default_rng(11).standard_normal((b, D),
                                                      dtype=np.float32)
    q = gen_rows(torch.from_numpy(query_rows)) + 0.02 * torch.from_numpy(
        noise).to(dev)
    return query_rows, q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def _timed_select(index, queries, q_prec, k, dev):
    """(candidate ids of the first call, seconds of one call over
    `SEARCH_RUNS` device-chained calls, seconds of one call with the ids
    copied to the host)."""
    from ann_solo_tpu_torch.device import synchronize

    def select():
        ids, _ = index.search_device(
            queries, k, q_prec=q_prec, charge=float(CHARGE),
            tol_val=OPEN_TOL_DA, tol_mode="Da")
        return ids

    cand = select().cpu().numpy()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(SEARCH_RUNS):
        select()
    synchronize(dev)
    t_device = (time.perf_counter() - t0) / SEARCH_RUNS
    t0 = time.perf_counter()
    for _ in range(SEARCH_RUNS):
        select().cpu().numpy()
    t_host = (time.perf_counter() - t0) / SEARCH_RUNS
    return cand, t_device, t_host


def _source_rate(cand, query_rows) -> float:
    return float(np.mean((cand == query_rows[:, None]).any(axis=1)))


@torch.no_grad()
def single_chip(args, dev):
    """The default and ``--streaming`` points.  Returns the result and,
    for callers that check it further, the index and its queries."""
    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.index.ivf import IvfIndex

    n = args.n
    rng = np.random.default_rng(7)
    prec = np.sort(rng.uniform(400, 1200, n)).astype(np.float32)
    prec_d = torch.from_numpy(prec).to(dev)
    gen_rows = make_gen_rows(n, dev)
    query_rows, queries = _queries(args, n, rng, gen_rows, dev)
    q_prec = prec_d[torch.from_numpy(query_rows).to(dev)]
    config = _Config(args, args.redundancy)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if args.streaming:
        index = IvfIndex.build_streaming(
            gen_rows, n, D, config, precursor_mz=prec_d,
            storage_dtype=torch.int8, device=dev)
    else:
        chunk = 1 << 18
        vectors = torch.cat([
            gen_rows(torch.arange(s, min(s + chunk, n), device=dev))
            for s in range(0, n, chunk)])
        synchronize(dev)
        log(f"generated the {vectors.numel() * 4 / 1e9:.2f} GB float32 "
            f"source block: {time.perf_counter() - t0:.2f}s")
        index = IvfIndex.build(vectors, config, precursor_mz=prec_d,
                               storage_dtype=torch.int8, device=dev)
        del vectors  # the search reads the int8 lists
    synchronize(dev)
    t_build = time.perf_counter() - t0
    build_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else None)
    log(f"{'streaming ' if args.streaming else ''}int8 IVF build "
        f"({index.num_list} lists): {t_build:.2f}s, "
        f"{index.bytes_per_vector:.1f} B/vector, peak device memory "
        f"{build_peak} bytes")

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cand, t_search, t_host = _timed_select(index, queries, q_prec,
                                           args.num_candidates, dev)
    hit = _source_rate(cand, query_rows)
    b = args.n_queries
    log(f"select at {n / 1e6:.1f}M vectors: {b / t_search:.1f} queries/s "
        f"({b / t_host:.1f} with the ids copied to the host), "
        f"source in candidates {hit:.4f}")
    extrapolation = {"device_memory_bytes": None,
                     "select_transient_bytes": None,
                     "per_chip_int8_capacity_vectors": None,
                     "four_chip_capacity_vectors": None}
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        transient = torch.cuda.max_memory_allocated(dev) - resident
        capacity = int((total - transient) / index.bytes_per_vector)
        extrapolation.update(
            device_memory_bytes=total, select_transient_bytes=transient,
            per_chip_int8_capacity_vectors=capacity,
            four_chip_capacity_vectors=4 * capacity)
    extrapolation["note"] = (
        "capacity = (the card's memory less the select's measured "
        "transient bytes) / the measured bytes a vector (list slack and "
        "scales included); lists shard over the cards of a mesh "
        "(parallel/sharded_ivf) with O(k) merges")
    result = {
        "metric": f"{n / 1e6:.1f}M-vector int8 IVF on one "
        f"{_device_name(dev)}"
        + (" (streaming build)" if args.streaming else ""),
        "streaming_build": bool(args.streaming),
        "n_vectors": n,
        "dims": D,
        "num_list": index.num_list,
        "num_probe": args.num_probe,
        "redundancy": args.redundancy,
        "build_sec": t_build,
        "build_vectors_per_sec": n / t_build,
        "index_bytes_per_vector": index.bytes_per_vector,
        "select_queries_per_sec": b / t_search,
        "select_with_host_download_queries_per_sec": b / t_host,
        "select_timing_note": "select_queries_per_sec times "
        f"{SEARCH_RUNS} device-chained search_device calls (ids left on "
        "the device, as the engine's rescoring takes them) and one "
        "synchronize; the host-download figure copies each call's (B, k) "
        "ids to host memory",
        "source_in_top_candidates": hit,
        "certificate_repairs_per_batch": index._last_chunked_flagged,
        "extrapolation": extrapolation,
    }
    return {"result": result, "index": index, "queries": queries,
            "q_prec": q_prec, "query_rows": query_rows,
            "build_max_memory_allocated_bytes": build_peak}


@torch.no_grad()
def sharded_gpu(args, dev):
    """The ``--sharded-gpu`` point: the born-sharded streaming build and
    the sharded select on a (1, 1) mesh of the device."""
    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.parallel.mesh import make_mesh
    from ann_solo_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex

    mesh = make_mesh(1, devices=[dev], dp_size=1)
    n = args.n
    rng = np.random.default_rng(7)
    prec = np.sort(rng.uniform(400, 1200, n)).astype(np.float32)
    gen_rows = make_gen_rows(n, dev)
    t0 = time.perf_counter()
    index = ShardedIvfIndex.build_sharded_streaming(
        mesh, gen_rows, n, D, _Config(args, args.redundancy),
        precursor_mz=prec, storage_dtype=torch.int8,
        n_iter=args.kmeans_iters)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    log(f"born-sharded streaming build: {t_build:.2f}s "
        f"({index.build_seconds}), scale_regime={index.scale_regime}")
    query_rows, queries = _queries(args, n, rng, gen_rows, dev)
    q_prec = torch.from_numpy(prec[query_rows]).to(dev)
    b = args.n_queries
    regime = index._regime_params(b, args.num_probe,
                                  index.redundancy * args.num_candidates)
    cand, t_search, _ = _timed_select(index, queries, q_prec,
                                      args.num_candidates, dev)
    hit = _source_rate(cand, query_rows)
    log(f"sharded select at {n / 1e6:.1f}M rows: {b / t_search:.1f} "
        f"queries/s, source in candidates {hit:.4f}, probe-width "
        f"overflows {index._last_overflow}/{b}")
    result = {
        "metric": f"{n / 1e6:.1f}M-vector int8 IVF through "
        f"ShardedIvfIndex on one {_device_name(dev)} ((1, 1) mesh, "
        "born-sharded streaming build)",
        "n_vectors": n,
        "dims": D,
        "num_list": args.num_list,
        "num_probe": args.num_probe,
        "redundancy": args.redundancy,
        "local_scan_regime": regime[0],
        "build_sec": t_build,
        "build_vectors_per_sec": n / t_build,
        "select_queries_per_sec": b / t_search,
        "source_in_top_candidates": hit,
        "probe_width_overflows": int(index._last_overflow),
    }
    return {"result": result, "index": index}


@torch.no_grad()
def sharded(args, dev):
    """The ``--sharded`` point: host-generated rows (the JAX script's
    NumPy draws) built born sharded over a mesh of `MESH_DEVICES` torch
    devices, then one search of noised copies of its rows."""
    from ann_solo_tpu_torch.device import synchronize
    from ann_solo_tpu_torch.parallel.mesh import (
        make_mesh,
        make_multislice_mesh,
        n_list_shards,
    )
    from ann_solo_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex

    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count)
                   for i in range(MESH_DEVICES)]
    else:
        devices = [dev] * MESH_DEVICES
    if args.multislice:
        mesh = make_multislice_mesh(2, len(devices) // 2, devices=devices)
    else:
        mesh = make_mesh(len(devices), devices=devices)
    lib_shards = n_list_shards(mesh)
    n = args.n
    rng = np.random.default_rng(7)
    log(f"generating {n} x {D} unit vectors on the host")
    vectors = rng.standard_normal((n, D), dtype=np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    prec = np.sort(rng.uniform(400, 1200, n)).astype(np.float32)
    t0 = time.perf_counter()
    index = ShardedIvfIndex.build_sharded(
        mesh, torch.from_numpy(vectors), _Config(args, 2),
        precursor_mz=prec, storage_dtype=torch.int8,
        n_iter=args.kmeans_iters)
    for d in set(mesh.devices.ravel()):
        synchronize(d)
    t_build = time.perf_counter() - t0
    blocks = index.blocks()
    shard_bytes = max(b.vectors.numel() * b.vectors.element_size()
                      for b in blocks)
    global_bytes = index.num_list * index.cap * index.dim
    if shard_bytes * lib_shards != global_bytes:
        raise AssertionError(f"{lib_shards} shard blocks of {shard_bytes} "
                             f"bytes are not the {global_bytes}-byte block")
    log(f"born-sharded build: {t_build:.2f}s, {index.num_list} lists cap "
        f"{index.cap}, a shard block {shard_bytes} bytes of {global_bytes}")
    result = {
        "metric": f"{n / 1e6:.1f}M-vector BORN-SHARDED int8 IVF build over "
        f"a {lib_shards}-shard "
        + ("('dcn', 'dp', 'lib')" if args.multislice else "'lib'")
        + f" mesh of {len(devices)} x {_device_name(dev)}",
        "multislice": bool(args.multislice),
        "n_vectors": n,
        "dims": D,
        "num_list": args.num_list,
        "lib_shards": lib_shards,
        "redundancy": 2,
        "build_sec": t_build,
        "build_rows_per_sec": n / t_build,
        "per_shard_block_bytes": int(shard_bytes),
        "global_block_bytes": int(global_bytes),
    }
    b = args.n_queries
    query_rows = rng.choice(n, b, replace=False)
    queries = vectors[query_rows] + 0.02 * rng.standard_normal(
        (b, D), dtype=np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    cand, _ = index.search_with_scores(
        torch.from_numpy(queries).to(dev), args.num_candidates,
        q_prec=torch.from_numpy(prec[query_rows]).to(dev),
        charge=float(CHARGE), tol_val=OPEN_TOL_DA, tol_mode="Da")
    result["source_in_top_candidates"] = _source_rate(cand, query_rows)
    result["note"] = (
        "each shard block is placed on its mesh device (the shapes "
        "asserted from the placed blocks); equality with the single-device "
        "build is pinned in tests/test_torch_sharded_build.py")
    return {"result": result, "index": index}


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="Multi-million-vector IVF index on one card (the "
        "PyTorch port's SCALE JSON)")
    parser.add_argument("--n", type=int, default=2_097_152)
    parser.add_argument("--num-list", type=int, default=4096)
    parser.add_argument("--num-probe", type=int, default=64)
    parser.add_argument("--num-candidates", type=int, default=1024)
    parser.add_argument("--n-queries", type=int, default=1024)
    parser.add_argument("--out", default="SCALE.json")
    parser.add_argument(
        "--streaming", action="store_true",
        help="build via IvfIndex.build_streaming: rows are generated on "
        "demand, so no (n, D) source block exists (use for n >= 4M)")
    parser.add_argument(
        "--sharded", action="store_true",
        help="born-sharded build of host-generated rows over a mesh of "
        f"{MESH_DEVICES} torch devices")
    parser.add_argument(
        "--multislice", action="store_true",
        help="with --sharded: a 2-slice ('dcn', 'dp', 'lib') mesh")
    parser.add_argument(
        "--sharded-gpu", action="store_true",
        help="born-sharded streaming build and sharded select through "
        "ShardedIvfIndex on a (1, 1) mesh of the card")
    parser.add_argument("--kmeans-iters", type=int, default=8)
    parser.add_argument(
        "--redundancy", type=int, default=1,
        help="stored copies a vector for the single-card points (the "
        "--sharded point always uses 2)")
    parser.add_argument("--no_gpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    return parser.parse_args(args)


def main(args=None) -> int:
    from ann_solo_tpu_torch.device import resolve_device

    parsed = parse_args(args)
    dev = resolve_device("cpu" if parsed.no_gpu else None)
    log(f"device: {_device_name(dev)}")
    if parsed.sharded_gpu:
        out = sharded_gpu(parsed, dev)
    elif parsed.sharded:
        out = sharded(parsed, dev)
    else:
        out = single_chip(parsed, dev)
    result = out["result"]
    with open(parsed.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
