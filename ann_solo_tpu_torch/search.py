"""Spectral library search engine (the port of `ann_solo_tpu/search.py`).

`SpectralLibrary` opens the library store (or builds it, with its decoys,
and writes it: `io/store.py::open_or_build_store`), loads or builds an IVF
index for each charge with enough spectra (``--mode ann``,
`IvfIndex.load_or_build`), and runs the standard -> open cascade with FDR
control, on one device:

* the standard level, and every charge without an index, rescore each
  query's whole precursor window (`_rescore_window_ranges`): contiguous
  rows of the m/z-sorted library, found by float64 `searchsorted` on the
  host;
* the open level of an indexed charge runs `ann_open_search_batch`:

  1.  vectorize the queries (hashed, unit-norm vectors);
  2.  select the top `num_candidates` library rows per query from the IVF
      index, with the precursor window fused into the scan;
  3.  rescore the (B, C) candidate matrix exactly with the greedy
      shifted-dot kernel under the optimality certificate;
  4.  extract the greedy peak matches of each query's best pair.

Both kinds of level rescore with `ops/rescore.py::rescore_candidate_matrix`
and extract matches with `best_pair_matches`, which run the greedy
shifted-dot kernel (B1) on the card.  Batches are cut for memory only: a
query's result never depends on the other queries of its batch.

With ``--num_shards`` and more than one CUDA device the engine builds the
JAX engine's (dp, lib) mesh (`_make_library_mesh`): each charge's index is
placed as a `parallel.sharded_ivf.ShardedIvfIndex`, and with dp > 1 each
open-level batch splits over the dp replicas, each running vectorize ->
select -> rescore on its own devices.  On one device, and under
``--no_gpu``, the engine stays unsharded.

Not ported: the JAX engine's pipeline warm-up (compilation) and its
one-resident-index eviction (one card holds every charge's index).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ann_solo_tpu_torch import fdr
from ann_solo_tpu_torch.config import config
from ann_solo_tpu_torch.device import DeviceLike, resolve_device, synchronize
from ann_solo_tpu_torch.index.ivf import (
    IvfIndex,
    ivf_index_filename,
    resolve_soar_lambda,
)
from ann_solo_tpu_torch.io import reader
from ann_solo_tpu_torch.io.store import (
    ChargeBlock,
    SpectralLibraryStore,
    hyperparameter_hash,
    open_or_build_store,
)
from ann_solo_tpu_torch.models.preprocess import (
    PreprocessParams,
    preprocess_batch,
)
from ann_solo_tpu_torch.models.spectrum import (
    Spectrum,
    SpectrumSpectrumMatch,
    pack_spectra,
)
from ann_solo_tpu_torch.models.vectorize import (
    VectorizeParams,
    device_tables,
    vectorize_batch,
)
from ann_solo_tpu_torch.ops.rescore import rescore_candidate_matrix
from ann_solo_tpu_torch.ops.shifted_dot import pair_score_matrix
from ann_solo_tpu_torch.ops.shifted_dot_cuda import (
    pad_peaks,
    shifted_dot_best_match_auto,
)
from ann_solo_tpu_torch.parallel.collectives import on_device
from ann_solo_tpu_torch.parallel.mesh import make_mesh, n_list_shards
from ann_solo_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex
from ann_solo_tpu_torch.utils.profiling import profiler

logger = logging.getLogger(__name__)

_MATCH_CHUNK = 4096  # pairs per match-extraction call
# Queries per open-level ANN call (vectorize, select, rescore, matches).
_ANN_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class OpenSearchParams:
    """Open-search settings (the config keys the JAX engine reads)."""

    vectorize: VectorizeParams = VectorizeParams()
    num_candidates: int = 512
    precursor_tolerance_mass_open: float = 500.0
    precursor_tolerance_mode_open: str = "Da"
    fragment_mz_tolerance: float = 0.04
    allow_peak_shifts: bool = True

    def num_shifts(self, charge: int) -> int:
        return charge + 1 if self.allow_peak_shifts else 1


@dataclasses.dataclass
class LibraryBlock:
    """Per-charge library peak blocks on one device (the JAX
    `_ChargeLibrary.device_arrays`)."""

    mz: torch.Tensor  # (N, K) float32
    intensity: torch.Tensor  # (N, K) float32
    ann_charge: torch.Tensor  # (N, K) int32
    precursor_mz: torch.Tensor  # (N,) float32

    @property
    def device(self) -> torch.device:
        return self.mz.device


def _selection_order(qm, qi, cm, ci, ca, q_prec, c_prec, charges, match,
                     params: OpenSearchParams, charge: int):
    """(match_q, match_c) of each pair in the greedy's selection order.

    The greedy takes entries in (value desc, flat index asc) order, so the
    matched entries sorted by that key are the matches in the order the
    greedy took them: the order of the reference's C++ and of the JAX
    package's plain greedy, which the SSM features sum in."""
    scores = pair_score_matrix(
        qm, qi, cm, ci, ca, q_prec, c_prec, charges,
        params.fragment_mz_tolerance, params.num_shifts(charge),
        params.allow_peak_shifts,
    )
    matched = match >= 0
    values = scores.gather(2, match.clamp(min=0).to(torch.int64)[:, :, None])
    values = torch.where(matched, values[:, :, 0], float("-inf"))
    # A stable sort keeps ascending query peaks (= flat index) on ties.
    order = torch.sort(-values, dim=1, stable=True).indices
    match_c = match.to(torch.int64).gather(1, order)
    match_q = torch.where(match_c >= 0, order, -1)
    return match_q, match_c


def best_pair_matches(lib: LibraryBlock, q_mz, q_int, q_prec,
                      rows: np.ndarray, cand_idx: np.ndarray, charge: int,
                      params: OpenSearchParams) -> Dict[int, np.ndarray]:
    """Greedy peak matches ((M, 2) [query peak, library peak]) of each
    listed query row's best candidate, in the greedy's selection order."""
    dev = lib.device
    matches_by_row: Dict[int, np.ndarray] = {}
    for start in range(0, len(rows), _MATCH_CHUNK):
        r = rows[start:start + _MATCH_CHUNK]
        c = cand_idx[start:start + _MATCH_CHUNK]
        r_d = torch.as_tensor(r, dtype=torch.int64, device=dev)
        c_d = torch.as_tensor(c, dtype=torch.int64, device=dev)
        qm, qi, cm, ci, ca = pad_peaks(
            q_mz.index_select(0, r_d), q_int.index_select(0, r_d),
            lib.mz.index_select(0, c_d), lib.intensity.index_select(0, c_d),
            lib.ann_charge.index_select(0, c_d),
        )
        qp = q_prec.index_select(0, r_d)
        cp = lib.precursor_mz.index_select(0, c_d)
        charges = torch.full((len(r),), charge, dtype=torch.int32, device=dev)
        _, _, match = shifted_dot_best_match_auto(
            qm, qi, cm, ci, ca, qp, cp, charges,
            params.fragment_mz_tolerance, params.num_shifts(charge),
            params.allow_peak_shifts,
        )
        match_q, match_c = _selection_order(
            qm, qi, cm, ci, ca, qp, cp, charges, match, params, charge)
        match_q = match_q.cpu().numpy()
        match_c = match_c.cpu().numpy()
        for j, row in enumerate(r):
            sel = match_q[j] >= 0
            matches_by_row[int(row)] = np.column_stack(
                [match_q[j][sel], match_c[j][sel]]
            )
    return matches_by_row


@torch.no_grad()
def ann_open_search_batch(
    index,  # ann_solo_tpu_torch.index.ivf.IvfIndex on the device
    lib: LibraryBlock,  # the same charge partition's peak blocks
    q_mz, q_int,  # (B, K) float32 query peaks (m/z sorted, 0-padded)
    q_n,  # (B,) valid peak counts
    q_prec,  # (B,) precursor m/z
    charge: int,
    params: OpenSearchParams,
    stage_seconds: Optional[Dict[str, float]] = None,
):
    """ANN open search of one query batch of precursor charge `charge`.

    Returns (best_idx (B,) int64 library row or -1, best_score (B,)
    float64, n_cands (B,) int32, matches_by_row {row: (M, 2) int array}),
    like the JAX engine's ANN branch.  With `stage_seconds` given, the
    device is synchronized at each stage boundary and each stage's wall
    seconds are added under its name.
    """
    dev = lib.device
    q_mz = torch.as_tensor(q_mz).to(device=dev, dtype=torch.float32)
    q_int = torch.as_tensor(q_int).to(device=dev, dtype=torch.float32)
    q_n = torch.as_tensor(q_n).to(device=dev)
    q_prec = torch.as_tensor(np.asarray(q_prec, np.float32)).to(dev)
    clock = [time.perf_counter()]

    def stage(name):
        if stage_seconds is None:
            return
        synchronize(dev)
        now = time.perf_counter()
        stage_seconds[name] = stage_seconds.get(name, 0.0) + now - clock[0]
        clock[0] = now

    vectors = vectorize_batch(
        params.vectorize, device_tables(params.vectorize, dev),
        q_mz, q_int, q_n,
    )
    stage("vectorize")
    cand_ids, _ = index.search_device(
        vectors, params.num_candidates, q_prec=q_prec, charge=float(charge),
        tol_val=float(params.precursor_tolerance_mass_open),
        tol_mode=params.precursor_tolerance_mode_open,
    )
    stage("select")
    best_idx, best_score, n_cands = rescore_candidate_matrix(
        q_mz, q_int, q_prec,
        lib.mz, lib.intensity, lib.ann_charge, lib.precursor_mz,
        cand_ids, params.fragment_mz_tolerance, params.num_shifts(charge),
        params.allow_peak_shifts,
    )
    stage("rescore")
    rows = np.nonzero(best_idx >= 0)[0]
    matches_by_row = best_pair_matches(
        lib, q_mz, q_int, q_prec, rows, best_idx[rows], charge, params
    )
    stage("matches")
    return best_idx, best_score, n_cands, matches_by_row


class _ChargeLibrary:
    """Per-charge library arrays sorted by precursor m/z, with their
    peak blocks on the device."""

    def __init__(self, block: ChargeBlock, device: torch.device):
        order = np.argsort(block.precursor_mz, kind="stable")
        # Drop library spectra that failed preprocessing quality gates
        # (reference spectral_library.py:452-454).
        order = order[block.proc_is_valid[order]]
        self.rows = block.rows[order]  # global store rows
        self.precursor_mz = block.precursor_mz[order].astype(np.float64)
        self.mz = block.proc_mz[order]
        self.intensity = block.proc_intensity[order]
        self.ann_charge = block.proc_ann_charge[order].astype(np.int32)
        self.n_peaks = block.proc_n_peaks[order]
        # Precursor m/z is float32 on the device, float64 on the host.
        self.block = LibraryBlock(
            torch.from_numpy(np.ascontiguousarray(self.mz)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.intensity)).to(device),
            torch.from_numpy(self.ann_charge).to(device),
            torch.from_numpy(self.precursor_mz.astype(np.float32)).to(device),
        )
        self._blocks = {self.block.device: self.block}

    @property
    def n_spectra(self) -> int:
        return len(self.rows)

    def block_on(self, device: torch.device) -> LibraryBlock:
        """The peak blocks on `device` (copied there once, for a dp
        replica's rescoring)."""
        if device not in self._blocks:
            self._blocks[device] = LibraryBlock(
                *(t.to(device) for t in dataclasses.astuple(self.block)))
        return self._blocks[device]


def precursor_window_bounds(
    query_mz: np.ndarray,
    charge: int,
    library_mz_sorted: np.ndarray,
    tol_val: float,
    tol_mode: str,
):
    """Candidate row ranges for a precursor tolerance window, in float64
    on the host.

    Da mode matches the reference's |q - l| * charge <= tol; ppm mode
    |q - l| / l * 1e6 <= tol (spectral_library.py:421-427).  Returns
    (lo, hi) index arrays into the m/z-sorted library.
    """
    query_mz = np.asarray(query_mz, np.float64)
    if tol_mode == "Da":
        delta = tol_val / charge
        lo = np.searchsorted(library_mz_sorted, query_mz - delta, "left")
        hi = np.searchsorted(library_mz_sorted, query_mz + delta, "right")
    elif tol_mode == "ppm":
        # |q - l| <= tol * l / 1e6  <=>  l >= q / (1 + tol/1e6) and
        # l <= q / (1 - tol/1e6).
        scale = tol_val / 10**6
        lo = np.searchsorted(
            library_mz_sorted, query_mz / (1.0 + scale), "left"
        )
        hi = np.searchsorted(
            library_mz_sorted, query_mz / (1.0 - scale), "right"
        )
    else:
        raise ValueError("Unknown precursor tolerance mode")
    return lo.astype(np.int64), hi.astype(np.int64)


def _window_cand_matrix(starts: torch.Tensor, hi: torch.Tensor, width: int):
    """(rows, width) contiguous candidate rows built on the device:
    starts[:, None] + iota, -1 at or past each row's `hi` bound."""
    cand = starts[:, None] + torch.arange(width, device=starts.device)[None]
    return torch.where(cand < hi[:, None], cand, -1)


def _open_search_params(cfg) -> OpenSearchParams:
    open_tol = cfg.precursor_tolerance_mass_open
    return OpenSearchParams(
        vectorize=VectorizeParams.from_config(cfg),
        num_candidates=int(cfg.num_candidates),
        precursor_tolerance_mass_open=(
            float(open_tol) if open_tol is not None else 0.0),
        precursor_tolerance_mode_open=str(
            cfg.precursor_tolerance_mode_open),
        fragment_mz_tolerance=float(cfg.fragment_mz_tolerance),
        allow_peak_shifts=bool(cfg.allow_peak_shifts),
    )


class SpectralLibrary:
    """Spectral library search engine on one device (the JAX
    `SpectralLibrary`, reference spectral_library.py:27-500).

    `device` None means the CUDA GPU (`device.resolve_device`); the CPU
    runs only when asked for by name.
    """

    # Window rescoring shapes (the JAX engine's): rows per device call,
    # the width narrow windows pack at, and the sub-row width wider
    # windows split into.
    _WIN_ROWS = 1024
    _WIN_NARROW = 256
    _WIN_WIDE = 16384

    def __init__(self, filename: str, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        # Refuse an unknown model or file format before any work is done.
        fdr.check_model(config.model if config.model != "none" else None)
        reader.verify_extension(
            [".splib", ".sptxt", ".mgf", ".fasta"], filename
        )
        self._filename = filename
        self._lib_params = PreprocessParams.from_config(
            config, is_library=True
        )
        self._query_params = PreprocessParams.from_config(
            config, is_library=False
        )
        self._params = _open_search_params(config)
        profiler.device = self.device
        stages: Dict[str, float] = {}
        self._store: SpectralLibraryStore = open_or_build_store(
            filename, config, self._lib_params, self.device,
            stage_seconds=stages,
        )
        for name, seconds in stages.items():
            profiler.add(name, seconds)
        profiler.notes["store"] = {
            "source": "loaded" if "store load" in stages else "built",
            "file": os.path.basename(self._store.filename),
            "bytes": os.path.getsize(self._store.filename),
            "rows": self._store.n_spectra,
        }
        self._charge_libs: Dict[int, Optional[_ChargeLibrary]] = {}
        self._ann_indexes: Dict[int, object] = {}
        self._mesh = None
        if config.mode == "ann":
            self._mesh = self._make_library_mesh(self.device)
            self._prepare_ann_indexes()

    @staticmethod
    def _make_library_mesh(device: torch.device):
        """A (dp, lib) mesh of CUDA devices when sharding applies (the JAX
        engine's rules).

        --num_shards > 1 shards each charge's IVF lists over that many
        devices; 0 (the default) uses every device with dp = 1.  When
        --num_shards leaves devices over (4 shards on 8 cards), the
        remainder becomes the 'dp' axis: open-level batches split over
        the replicas.  With one device, and on the CPU (--no_gpu), the
        engine stays unsharded (None).  Tests patch this to a mesh of
        repeated devices.
        """
        if device.type != "cuda":
            return None
        n = int(config.num_shards)
        n_avail = torch.cuda.device_count()
        if n == 0:
            n = n_avail
        if n_avail <= 1:
            return None
        if n > n_avail:
            logger.warning(
                "--num_shards %d > %d available devices; not sharding",
                n, n_avail,
            )
            return None
        dp = n_avail // n if n_avail % n == 0 else 1
        logger.info("Sharding library over %d devices (dp=%d replicas)",
                    n, dp)
        return make_mesh(n * dp, dp_size=dp)

    # ------------------------------------------------------------------ #
    # Library access

    def _get_charge_lib(self, charge: int) -> Optional[_ChargeLibrary]:
        if charge not in self._charge_libs:
            block = self._store.charge_block(charge)
            self._charge_libs[charge] = (
                _ChargeLibrary(block, self.device)
                if block is not None else None
            )
        return self._charge_libs[charge]

    @torch.no_grad()
    def _prepare_ann_indexes(self) -> None:
        """Load or build an IVF index for each charge with enough spectra
        (reference spectral_library.py:91-116); every other charge is
        searched by window rescoring."""
        config_hash = hyperparameter_hash(config)
        # num_list <= 0 is the size-aware auto rule; below its floor of
        # 256 spectra (or below a set num_list) no index is built.
        min_spectra = (
            int(config.num_list) if int(config.num_list) > 0 else 256
        )
        for charge in self._store.charges():
            lib = self._get_charge_lib(charge)
            if lib is None or lib.n_spectra < min_spectra:
                continue
            filename = ivf_index_filename(
                self._filename, config_hash, charge,
                str(config.index_dtype), int(config.ivf_redundancy),
                resolve_soar_lambda(config),
            )
            # Tie the persisted index to the store CONTENT it was built
            # from (the file name only encodes the config hash).
            stages: Dict[str, float] = {}
            build_notes: Dict[str, object] = {}
            index = IvfIndex.load_or_build(
                filename, lib, config,
                store_fp=self._store.source_fingerprint,
                device=self.device, stage_seconds=stages, notes=build_notes,
            )
            for name, seconds in stages.items():
                profiler.add(f"{name} charge {charge}", seconds)
            l, cap, d = index.padded_vectors.shape
            regime = index.regime(self._params.num_candidates)
            profiler.notes[f"index charge {charge}"] = {
                "n_spectra": lib.n_spectra, "num_list": l, "cap": cap,
                "dim": d, "redundancy": index.redundancy,
                "num_probe": index.num_probe, "regime": regime,
                "source": "loaded" if "index load" in stages else "built",
                "file": os.path.basename(filename),
                "bytes": os.path.getsize(filename),
                **build_notes,
            }
            logger.info(
                "Charge %d IVF index (%s): %d spectra, %d lists x cap %d, "
                "num_probe %d, %s regime", charge,
                profiler.notes[f"index charge {charge}"]["source"],
                lib.n_spectra, l, cap, index.num_probe, regime,
            )
            if self._mesh is not None:
                if l % n_list_shards(self._mesh) == 0:
                    index = ShardedIvfIndex(self._mesh, index)
                    profiler.notes[f"index charge {charge}"]["sharded"] = {
                        "mesh": self._mesh.shape,
                        "lists_per_shard": index.lists_per_shard,
                        "regime": index.regime(self._params.num_candidates),
                    }
                else:
                    logger.warning(
                        "num_list=%d not divisible by %d library shards; "
                        "charge %d index stays unsharded",
                        l, n_list_shards(self._mesh), charge,
                    )
            self._ann_indexes[charge] = index

    def shutdown(self) -> None:
        self._charge_libs.clear()
        self._ann_indexes.clear()

    # ------------------------------------------------------------------ #
    # Search

    def search(self, query_filename: str) -> List[SpectrumSpectrumMatch]:
        """Identify all query spectra
        (reference spectral_library.py:193-260)."""
        logger.info("Process file %s", query_filename)
        with profiler.stage("query read + preprocess"):
            query_spectra = self._read_and_process_queries(query_filename)

        identifications: Dict[str, SpectrumSpectrumMatch] = {}
        do_cascade_open = (
            config.precursor_tolerance_mass_open is not None
            and config.precursor_tolerance_mode_open is not None
        )
        n_identified = 0
        for ssm in self._search_cascade(query_spectra, "std"):
            if not do_cascade_open or ssm.q < config.fdr:
                identifications[ssm.query_identifier] = ssm
                n_identified += ssm.q < config.fdr
        logger.info(
            "%d spectra identified after the standard search", n_identified
        )
        if do_cascade_open:
            for charge in list(query_spectra):
                query_spectra[charge] = [
                    s for s in query_spectra[charge]
                    if s.identifier not in identifications
                ]
            for ssm in self._search_cascade(query_spectra, "open"):
                identifications[ssm.query_identifier] = ssm
                n_identified += ssm.q < config.fdr
            logger.info(
                "%d spectra identified after the open search", n_identified
            )
        profiler.log_summary()
        return list(identifications.values())

    @torch.no_grad()
    def _read_and_process_queries(
        self, query_filename: str
    ) -> Dict[int, List[Spectrum]]:
        """Read query spectra, expand unknown charges, group by charge."""
        raw: List[Spectrum] = []
        for query_spectrum in reader.read_query_file(query_filename):
            if query_spectrum.precursor_charge is not None:
                raw.append(query_spectrum)
            else:
                for charge in (2, 3):
                    copy = Spectrum(
                        identifier=query_spectrum.identifier,
                        precursor_mz=query_spectrum.precursor_mz,
                        precursor_charge=charge,
                        mz=query_spectrum.mz,
                        intensity=query_spectrum.intensity,
                        retention_time=query_spectrum.retention_time,
                        index=query_spectrum.index,
                    )
                    raw.append(copy)
        query_spectra: Dict[int, List[Spectrum]] = {}
        # Preprocess on the device in padded batches; keep valid spectra.
        batch_size = 8192
        for start in range(0, len(raw), batch_size):
            chunk = raw[start:start + batch_size]
            packed = pack_spectra(chunk, pad_multiple=512)
            out = preprocess_batch(
                self._query_params, *(torch.from_numpy(a).to(self.device)
                                      for a in (
                    packed.mz, packed.intensity, packed.ann_charge,
                    packed.n_peaks, packed.precursor_mz,
                    packed.precursor_charge,
                ))
            )
            proc_mz = out.mz.cpu().numpy()
            proc_int = out.intensity.cpu().numpy()
            n_peaks = out.n_peaks.cpu().numpy()
            is_valid = out.is_valid.cpu().numpy()
            for i, spectrum in enumerate(chunk):
                if not is_valid[i]:
                    continue
                n = int(n_peaks[i])
                spectrum.mz = proc_mz[i, :n].astype(np.float64)
                spectrum.intensity = proc_int[i, :n].astype(np.float64)
                spectrum.ann_type = None
                spectrum.ann_index = None
                spectrum.ann_charge = None
                query_spectra.setdefault(
                    spectrum.precursor_charge, []
                ).append(spectrum)
        return query_spectra

    def _search_cascade(
        self, query_spectra: Dict[int, List[Spectrum]], mode: str
    ) -> List[SpectrumSpectrumMatch]:
        """One cascade level (reference spectral_library.py:262-326)."""
        num_spectra = sum(len(q) for q in query_spectra.values())
        if mode == "std":
            logger.debug(
                "Process %d query spectra using a standard search "
                "(Δm = %s %s)", num_spectra,
                config.precursor_tolerance_mass,
                config.precursor_tolerance_mode,
            )
        else:
            logger.debug(
                "Process %d query spectra using an open search "
                "(Δm = %s %s)", num_spectra,
                config.precursor_tolerance_mass_open,
                config.precursor_tolerance_mode_open,
            )
        ssms: Dict[str, SpectrumSpectrumMatch] = {}
        batch_size = int(config.batch_size)
        for charge, spectra in query_spectra.items():
            for start in range(0, len(spectra), batch_size):
                batch = spectra[start:start + batch_size]
                for ssm in self._search_batch(batch, charge, mode):
                    if ssm is None:
                        continue
                    # A strict > keeps the first of equal scores.
                    previous = ssms.get(ssm.query_identifier)
                    if (
                        previous is None
                        or ssm.search_engine_score
                        > previous.search_engine_score
                    ):
                        ssms[ssm.query_identifier] = ssm
        logger.info(
            "Filter the spectrum-spectrum matches on FDR (threshold = %s)",
            config.fdr,
        )
        report: Dict[str, object] = {}
        with profiler.stage(f"{mode} FDR"):
            scored = fdr.score_ssms(
                list(ssms.values()),
                config.fdr,
                config.model if config.model != "none" else None,
                mode == "open",
                int(config.fdr_min_group_size),
                config,
                device=self.device,
                report=report,
            )
        profiler.add(f"{mode} FDR features", report.get("features_sec", 0.0))
        if "model_sec" in report:
            profiler.add(f"{mode} FDR model", report["model_sec"])
        if "grid" in report:
            profiler.notes[f"{mode} rf grid"] = report["grid"]
        return scored

    @torch.no_grad()
    def _search_batch(
        self, batch: List[Spectrum], charge: int, mode: str
    ) -> Iterator[Optional[SpectrumSpectrumMatch]]:
        """Match one charge-homogeneous batch of query spectra
        (reference spectral_library.py:328-455)."""
        lib = self._get_charge_lib(charge)
        if lib is None or lib.n_spectra == 0:
            return
        if mode == "std":
            tol_val = float(config.precursor_tolerance_mass)
            tol_mode = str(config.precursor_tolerance_mode)
        elif mode == "open":
            tol_val = float(config.precursor_tolerance_mass_open)
            tol_mode = str(config.precursor_tolerance_mode_open)
        else:
            raise ValueError("Unknown search mode")

        b = len(batch)
        k = self._query_params.max_peaks_used
        q_mz = np.zeros((b, k), np.float32)
        q_int = np.zeros((b, k), np.float32)
        q_n = np.zeros(b, np.int32)
        q_prec = np.zeros(b, np.float64)
        for i, s in enumerate(batch):
            n = min(s.n_peaks, k)
            q_mz[i, :n] = s.mz[:n]
            q_int[i, :n] = s.intensity[:n]
            q_n[i] = n
            q_prec[i] = s.precursor_mz
        dev = self.device
        q_mz_d = torch.from_numpy(q_mz).to(dev)
        q_int_d = torch.from_numpy(q_int).to(dev)
        q_prec_d = torch.from_numpy(q_prec.astype(np.float32)).to(dev)

        if (
            config.mode == "ann"
            and mode == "open"
            and charge in self._ann_indexes
        ):
            # Second filter: ANN neighbors, the precursor window fused
            # into the index scan (spectral_library.py:431-446).
            profiler.count(f"{mode} level charge {charge}: ivf select")
            best_idx = np.full(b, -1, np.int64)
            best_score = np.full(b, -np.inf, np.float64)
            num_candidates_per_query = np.zeros(b, np.int64)
            matches_by_row: Dict[int, np.ndarray] = {}
            index = self._ann_indexes[charge]
            for start in range(0, b, _ANN_CHUNK):
                stop = min(start + _ANN_CHUNK, b)
                for part, block, lo, hi in self._replica_parts(
                        index, lib, start, stop):
                    sl = slice(lo, hi)
                    stages: Dict[str, float] = {}
                    with on_device(block.device):
                        bi, bs, nc, mb = ann_open_search_batch(
                            part, block, q_mz_d[sl], q_int_d[sl],
                            torch.from_numpy(q_n[sl]), q_prec[sl], charge,
                            self._params, stage_seconds=stages,
                        )
                    best_idx[sl], best_score[sl] = bi, bs
                    num_candidates_per_query[sl] = nc
                    matches_by_row.update(
                        {row + lo: m for row, m in mb.items()})
                    for name, seconds in stages.items():
                        profiler.add(f"{mode} {name}", seconds)
        else:
            # First filter only: the precursor window's sorted rows.
            profiler.count(f"{mode} level charge {charge}: window rescoring")
            lo, hi = precursor_window_bounds(
                q_prec, charge, lib.precursor_mz, tol_val, tol_mode
            )
            num_candidates_per_query = hi - lo
            with profiler.stage(f"{mode} window rescoring"):
                best_idx, best_score = self._rescore_window_ranges(
                    q_mz_d, q_int_d, q_prec_d, lib, lo, hi, charge
                )
            # Peak matches of the best pairs only.
            with profiler.stage(f"{mode} matches"):
                rows = np.nonzero(best_idx >= 0)[0]
                matches_by_row = best_pair_matches(
                    lib.block, q_mz_d, q_int_d, q_prec_d, rows,
                    best_idx[rows], charge, self._params,
                )

        for i, query in enumerate(batch):
            if best_idx[i] < 0:
                yield None
                continue
            library_spectrum = self._store.get_spectrum(
                int(lib.rows[best_idx[i]]), processed=True
            )
            yield SpectrumSpectrumMatch(
                query,
                library_spectrum,
                peak_matches=matches_by_row[i],
                search_engine_score=float(best_score[i]),
                num_candidates=int(num_candidates_per_query[i]),
            )

    @staticmethod
    def _replica_parts(index, lib: _ChargeLibrary, start: int, stop: int):
        """(index, library blocks, lo, hi) for each part of query rows
        [start, stop): one part on the engine's device, or, for a sharded
        index with dp > 1 replicas, contiguous parts of ceil(n / dp) rows,
        each searched by its replica's shards and rescored on that
        replica's first device."""
        dp = index.dp if isinstance(index, ShardedIvfIndex) else 1
        if dp == 1:
            return [(index, lib.block, start, stop)]
        step = -(-(stop - start) // dp)
        return [
            (index.replica(d), lib.block_on(index.replica_device(d)),
             lo, min(lo + step, stop))
            for d, lo in enumerate(range(start, stop, step))
        ]

    @torch.no_grad()
    def _rescore_window_ranges(
        self, q_mz, q_int, q_prec, lib, lo, hi, charge
    ):
        """Exact rescoring of contiguous precursor-window row ranges.

        Each query's [lo, hi) range becomes one narrow sub-row of width
        `_WIN_NARROW`, or, when wider, sub-rows of width `_WIN_WIDE`; all
        run through the certificate rescorer of the ANN path, and a
        query's winner is the score maximum over its sub-rows, ties to the
        earliest sub-row (the first-in-row tie rule of the unsplit
        window).  Returns NumPy (best_idx (B,) int64, best_score (B,)
        float64).
        """
        dev = self.device
        q_mz = torch.as_tensor(q_mz).to(dev)
        q_int = torch.as_tensor(q_int).to(dev)
        q_prec = torch.as_tensor(q_prec).to(device=dev, dtype=torch.float32)
        blk = lib.block
        params = self._params
        b = q_mz.shape[0]
        best_idx = np.full(b, -1, np.int64)
        best_score = np.full(b, -np.inf, np.float64)
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)
        widths = hi - lo

        # Expand to (source query, sub-range start) per canonical width.
        narrow_q = np.nonzero((widths > 0) & (widths <= self._WIN_NARROW))[0]
        wide_rows = np.nonzero(widths > self._WIN_NARROW)[0]
        n_sub = -(-widths[wide_rows] // self._WIN_WIDE)
        wide_q = np.repeat(wide_rows, n_sub)
        # Sub-range starts: lo, lo + W, ... per wide query, in order.
        offs = (
            np.arange(len(wide_q))
            - np.repeat(np.cumsum(n_sub) - n_sub, n_sub)
        ) * self._WIN_WIDE
        wide_lo = lo[wide_q] + offs

        def run(sub_q, sub_lo, width):
            for s in range(0, len(sub_q), self._WIN_ROWS):
                rows = sub_q[s:s + self._WIN_ROWS]
                rows_d = torch.from_numpy(rows).to(dev)
                cand = _window_cand_matrix(
                    torch.from_numpy(sub_lo[s:s + self._WIN_ROWS]).to(dev),
                    torch.from_numpy(hi[rows]).to(dev), width,
                )
                idx_g, score_g, _ = rescore_candidate_matrix(
                    q_mz.index_select(0, rows_d),
                    q_int.index_select(0, rows_d),
                    q_prec.index_select(0, rows_d),
                    blk.mz, blk.intensity, blk.ann_charge, blk.precursor_mz,
                    cand, params.fragment_mz_tolerance,
                    params.num_shifts(charge), params.allow_peak_shifts,
                )
                # Sub-rows arrive in range order: a strict > keeps the
                # first maximal sub-row.
                for j, q in enumerate(rows):
                    if score_g[j] > best_score[q]:
                        best_score[q] = score_g[j]
                        best_idx[q] = idx_g[j]

        if len(narrow_q):
            run(narrow_q, lo[narrow_q], self._WIN_NARROW)
        if len(wide_q):
            run(wide_q, wide_lo, self._WIN_WIDE)
        return best_idx, best_score
