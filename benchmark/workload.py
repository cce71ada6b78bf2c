"""The cells' files and the generator of their data.

A cell of `BENCHMARK.json` names a configuration (a JSON file of sizes and
settings, `configs/<name>.json`) and a traffic mix (a JSON file of
parameters, `traffic/<name>.json`); its check limits are in
`checks/<cell>.json`.  Everything is found by name, so a new cell is new
files only.

The generator makes, on the card and from one seed, the library of a
configuration (the distributions of the repo's synthetic bench library:
sorted uniform peak m/z, uniform intensities of unit norm, uniform
annotation charges, uniform precursor m/z, rows sorted by precursor) and
a pool of query batches of a traffic mix.  Each batch holds every kind of
query in the mix's exact shares, in a seeded order, and every modified
copy's mass difference comes from a fixed multiset drawn to the mix's
profile, so every seed makes the same amount of each kind of work.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = "benchmark"

# Query kinds of a traffic mix, in the order their codes are given.
KINDS = ("noised", "modified", "foreign")


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(root: str, spec: dict, name: str) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return _read_json(os.path.join(root, entry["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(root: str, name: str) -> dict:
    return _read_json(os.path.join(root, BENCH_DIR, "traffic", f"{name}.json"))


def load_limits(root: str, cell: str) -> Dict[str, float]:
    return _read_json(os.path.join(root, BENCH_DIR, "checks", f"{cell}.json"))


@dataclasses.dataclass
class Library:
    """Library peak blocks on the device, rows sorted by precursor m/z."""

    mz: torch.Tensor  # (N, K) float32, ascending in each row
    intensity: torch.Tensor  # (N, K) float32, unit norm
    ann: torch.Tensor  # (N, K) int32 annotation charge, 0 = none
    prec: torch.Tensor  # (N,) float64


@dataclasses.dataclass
class Batch:
    """One query batch: peaks on the device, the rest on the host."""

    mz: torch.Tensor  # (B, K) float32, ascending in each row
    intensity: torch.Tensor  # (B, K) float32, unit norm
    prec: np.ndarray  # (B,) float64
    source: np.ndarray  # (B,) int64 library row it was made from, -1 none
    kind: np.ndarray  # (B,) int8 index into KINDS


def _uniform(gen, lo_hi, shape, dev, dtype=torch.float32):
    lo, hi = (float(v) for v in lo_hi)
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev,
                                       dtype=dtype)


def _spectra(gen, cfg: dict, n: int, dev):
    """(m/z, intensity, annotation, precursor) of `n` fresh spectra drawn
    from the configuration's distributions (rows in draw order)."""
    k = int(cfg["k_peaks"])
    mz = torch.sort(_uniform(gen, cfg["peak_mz"], (n, k), dev), dim=1).values
    intensity = _uniform(gen, cfg["peak_intensity"], (n, k), dev)
    intensity = intensity / torch.linalg.vector_norm(intensity, dim=1,
                                                     keepdim=True)
    ann = torch.randint(0, int(cfg["charge"]) + 1, (n, k), generator=gen,
                        device=dev, dtype=torch.int32)
    prec = _uniform(gen, cfg["precursor_mz"], (n,), dev, torch.float64)
    return mz, intensity, ann, prec


def make_library(gen, cfg: dict, dev) -> Library:
    mz, intensity, ann, prec = _spectra(gen, cfg, int(cfg["n_library"]), dev)
    order = torch.sort(prec, stable=True).indices
    return Library(mz[order], intensity[order], ann[order], prec[order])


def exact_counts(shares, total: int) -> np.ndarray:
    """Whole counts in the given shares that add up to `total` (largest
    remainders first, ties to the earlier entry)."""
    shares = np.asarray(shares, np.float64)
    raw = shares / shares.sum() * total
    counts = np.floor(raw).astype(np.int64)
    order = np.argsort(-(raw - counts), kind="stable")
    counts[order[:total - counts.sum()]] += 1
    return counts


def _permuted(gen, base: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, len(base)): `base` in an independent random order a row."""
    keys = torch.rand((rows, base.numel()), generator=gen, device=base.device)
    return base[torch.argsort(keys, dim=1)]


def make_pool(gen, lib: Library, cfg: dict, traffic: dict) -> List[Batch]:
    """The traffic mix's pool of query batches, made on the library's
    device in a few large calls."""
    dev = lib.mz.device
    n, k = lib.mz.shape
    n_b, b = int(traffic["pool_batches"]), int(traffic["batch"])
    if b > n:
        raise ValueError(f"a batch of {b} distinct sources needs at least "
                         f"{b} library rows, not {n}")
    unknown = set(traffic["kinds"]) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown query kinds {sorted(unknown)}")
    counts = exact_counts([traffic["kinds"].get(name, 0.0) for name in KINDS],
                          b)
    kind_base = torch.repeat_interleave(
        torch.arange(len(KINDS), device=dev), torch.as_tensor(counts,
                                                              device=dev))
    kind = _permuted(gen, kind_base, n_b)  # (n_b, b)
    source = torch.stack([torch.randperm(n, generator=gen, device=dev)[:b]
                          for _ in range(n_b)])
    mz = lib.mz[source]
    intensity = lib.intensity[source]
    ann = lib.ann[source]
    prec = lib.prec[source]
    charge = int(cfg["charge"])

    n_mod = int(counts[KINDS.index("modified")])
    if n_mod:
        masses = torch.as_tensor(traffic["mod_masses"], dtype=torch.float64,
                                 device=dev)
        per_mass = exact_counts(traffic["mod_weights"], n_mod)
        delta_base = torch.repeat_interleave(
            masses, torch.as_tensor(per_mass, device=dev))
        is_mod = kind == KINDS.index("modified")
        delta = torch.zeros((n_b, b), dtype=torch.float64, device=dev)
        delta[is_mod] = _permuted(gen, delta_base, n_b).reshape(-1)
        # Annotated fragment peaks above a random cut move by delta over
        # their annotation charge, the precursor by delta over its charge.
        cut = torch.randint(0, k, (n_b, b, 1), generator=gen, device=dev)
        moves = ((torch.arange(k, device=dev) >= cut) & (ann >= 1)
                 & is_mod[:, :, None])
        frag_shift = (delta[:, :, None] / ann.clamp(min=1)).to(torch.float32)
        mz = mz + torch.where(moves, frag_shift, 0.0)
        prec = prec + delta / charge

    n_foreign = int(counts[KINDS.index("foreign")])
    if n_foreign:
        is_foreign = kind == KINDS.index("foreign")
        f_mz, f_int, _, f_prec = _spectra(gen, cfg, n_b * n_foreign, dev)
        mz[is_foreign] = f_mz
        intensity[is_foreign] = f_int
        prec[is_foreign] = f_prec
        source = torch.where(is_foreign, -1, source)

    noise = traffic["noise"]
    mz = mz + float(noise["mz_sd"]) * torch.randn(
        mz.shape, generator=gen, device=dev)
    intensity = (intensity + float(noise["intensity_sd"]) * torch.randn(
        intensity.shape, generator=gen, device=dev)).abs()
    intensity = intensity / torch.linalg.vector_norm(intensity, dim=2,
                                                     keepdim=True)
    prec = prec + float(noise["precursor_sd"]) * torch.randn(
        prec.shape, generator=gen, device=dev, dtype=torch.float64)
    # Peaks stay paired with their intensities as the m/z are sorted.
    order = torch.argsort(mz, dim=2)
    mz = mz.gather(2, order)
    intensity = intensity.gather(2, order)

    prec_h = prec.cpu().numpy()
    source_h = source.cpu().numpy().astype(np.int64)
    kind_h = kind.cpu().numpy().astype(np.int8)
    return [Batch(mz[i].contiguous(), intensity[i].contiguous(), prec_h[i],
                  source_h[i], kind_h[i]) for i in range(n_b)]
