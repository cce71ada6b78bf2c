"""Probe-ordering diagnostic on a QUALITY workdir.

The port of the repo's `tools/probe_diag.py`.  For every brute-force
identified SSM (`bf.mztab` at 1% FDR), it finds the IVF lists that hold
the matched library vector's copies and asks: at probe depth p, is at
least one of those lists probed?  Orderings compared:

* plain       -- top-p by q . c                 (the engine's)
* radius      -- top-p by q . c + r_l           (an inner-product upper
  bound; r_l = the largest residual norm in list l)
* radius-half -- top-p by q . c + 0.5 * r_l     (less conservative)

This is the probed-list recall, an upper bound on candidate recall@k: a
vector no copy of whose list is probed is unreachable at any k.  The
index is the engine's, with the JAX tool's settings (bf16 lists, x2
SOAR, auto num_list): loaded from the workdir or built (and written)
there.  The residuals are computed on the host, one charge at a time.

    python -m ann_solo_tpu_torch.tools.probe_diag <workdir> [--no_gpu]

Prints the recall table and one JSON line.  Runs on the CUDA GPU and
raises without one, unless ``--no_gpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from ann_solo_tpu_torch.tools.bf_profile import Settings

PROBES = (64, 128, 192, 256, 384, 512)
ORDERINGS = ("plain", "radius", "radius-half")


def _list_rank_of_matches(index, library, spectra, wanted, tables,
                          vparams) -> Dict[str, List[int]]:
    """For each (query position, library position) of `wanted`, the
    smallest rank of a list holding the library position, under each
    ordering (10^9 when no list holds it)."""
    from ann_solo_tpu_torch.models.vectorize import vectorize_batch

    centroids = index.centroids.cpu().numpy().astype(np.float32)
    padded_ids = index.padded_ids.cpu().numpy()
    l, cap = padded_ids.shape
    vecs = index.padded_vectors.cpu().to(torch.float32).numpy()
    vecs = vecs * index.padded_scales.cpu().numpy()[:, :, None]
    rn = np.linalg.norm(vecs - centroids[:, None, :], axis=2)
    del vecs
    rn[padded_ids < 0] = 0.0
    r_max = rn.max(axis=1)
    del rn
    print(f"charge {spectra[0].precursor_charge}: L={l} cap={cap} "
          f"r_max mean={r_max.mean():.3f} std={r_max.std():.3f} "
          f"min={r_max.min():.3f} max={r_max.max():.3f}")

    pos_lists: Dict[int, List[int]] = {}
    for li in range(l):
        for s_ in padded_ids[li]:
            if s_ >= 0:
                pos_lists.setdefault(int(s_), []).append(li)

    k_peaks = library._query_params.max_peaks_used
    rows = [i for i, _ in wanted]
    q_mz = np.zeros((len(rows), k_peaks), np.float32)
    q_int = np.zeros((len(rows), k_peaks), np.float32)
    n_peaks = np.zeros(len(rows), np.int32)
    for j, i in enumerate(rows):
        s = spectra[i]
        n = min(s.n_peaks, k_peaks)
        q_mz[j, :n] = s.mz[:n]
        q_int[j, :n] = s.intensity[:n]
        n_peaks[j] = n
    dev = library.device
    qv = vectorize_batch(
        vparams, tables, *(torch.from_numpy(a).to(dev)
                           for a in (q_mz, q_int, n_peaks))).cpu().numpy()
    coarse = qv @ centroids.T  # (B, L)
    found: Dict[str, List[int]] = {}
    for name, bias in (("plain", None), ("radius", r_max),
                       ("radius-half", 0.5 * r_max)):
        sc = coarse if bias is None else coarse + bias[None, :]
        order = np.argsort(-sc, axis=1)
        rank = np.empty_like(order)
        np.put_along_axis(rank, order,
                          np.broadcast_to(np.arange(l), order.shape), axis=1)
        found[name] = [
            min(rank[j, li] for li in pos_lists[pos])
            if pos in pos_lists else 10**9
            for j, (_, pos) in enumerate(wanted)
        ]
    return found


@torch.no_grad()
def diagnose(workdir: str, no_gpu: bool = False) -> dict:
    """{ordering: {"p<=depth": recall}} and the number of SSMs checked."""
    from ann_solo_tpu_torch.config import config
    from ann_solo_tpu_torch.models.vectorize import (
        VectorizeParams,
        device_tables,
    )
    from ann_solo_tpu_torch.quality import _bf_matches, _cli_args
    from ann_solo_tpu_torch.search import SpectralLibrary

    settings = Settings(no_gpu)
    lib_path = os.path.join(workdir, "library.splib")
    query_path = os.path.join(workdir, "queries.mgf")
    config.parse(_cli_args(lib_path, query_path, "unused", "ann", settings))
    bf = _bf_matches(os.path.join(workdir, "bf.mztab"), settings)
    library = SpectralLibrary(lib_path, device="cpu" if no_gpu else None)
    try:
        queries = library._read_and_process_queries(query_path)
        ident_to_row = {str(ident): row for row, ident in
                        enumerate(library._store.identifiers)}
        vparams = VectorizeParams.from_config(config)
        tables = device_tables(vparams, library.device)
        tallies: Dict[str, List[int]] = {name: [] for name in ORDERINGS}
        for charge, spectra in queries.items():
            if charge not in library._ann_indexes:
                continue
            lib = library._get_charge_lib(charge)
            row_to_pos = {int(r): i for i, r in enumerate(lib.rows)}
            wanted = [
                (i, row_to_pos.get(
                    ident_to_row.get(bf.get(s.identifier, ""), -1), -1))
                for i, s in enumerate(spectra) if s.identifier in bf
            ]
            wanted = [(i, pos) for i, pos in wanted if pos >= 0]
            if not wanted:
                continue
            found = _list_rank_of_matches(
                library._ann_indexes[charge], library, spectra, wanted,
                tables, vparams)
            for name in ORDERINGS:
                tallies[name].extend(found[name])
    finally:
        library.shutdown()
    recall = {name: {f"p<={p}": float((np.asarray(found) < p).mean())
                     for p in PROBES}
              for name, found in tallies.items()}
    return {"n_checked": len(tallies["plain"]), "recall": recall}


def main(args=None) -> int:
    parser = argparse.ArgumentParser(
        description="Probed-list recall of bf-identified SSMs by probe "
        "depth and ordering, on a QUALITY workdir")
    parser.add_argument("workdir")
    parser.add_argument("--no_gpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parsed = parser.parse_args(args)
    out = diagnose(parsed.workdir, parsed.no_gpu)
    print(f"n_checked={out['n_checked']}")
    print("ordering    " + "".join(f"  p<={p:4d}" for p in PROBES))
    for name, row in out["recall"].items():
        print(f"{name:<12}" + "".join(f"  {row[f'p<={p}']:.4f}"
                                      for p in PROBES))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
