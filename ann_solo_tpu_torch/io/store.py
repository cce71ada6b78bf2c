"""Columnar spectral-library store, kept in one file beside the library.

The port of `ann_solo_tpu/io/store.py`: the same columns as the JAX
package's HDF5 store -- raw peaks as flat arrays + offsets, the
preprocessed fixed-width peak blocks (computed once, on the device, in
batches), per-charge row partitions -- as NumPy arrays.  Decoys are
interleaved before each target and drawn from the global NumPy RNG seeded
from `hyperparameter_hash`, exactly as the JAX build draws them, so both
packages hold the same rows in the same order.

`open_or_build_store` pays for the library read, the decoys and the
preprocessing once per library: it writes ``{base}_{hash[:7]}.store.npz``
(NumPy's own format, no pickle; never a name the JAX package reads or
writes) and reuses it while the settings hash, the library's base name
and the library file's content fingerprint all match.  Delete the file to
force a rebuild.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import logging
import os
import time
import zipfile
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ann_solo_tpu_torch.device import synchronize
from ann_solo_tpu_torch.io.files import write_npz_atomically
from ann_solo_tpu_torch.models.preprocess import (
    PreprocessParams,
    preprocess_batch,
)
from ann_solo_tpu_torch.models.spectrum import Spectrum, pack_spectra

logger = logging.getLogger(__name__)

_BUILD_BATCH = 4096


# Columns of the store and their dtypes (the JAX store's datasets);
# `identifiers` and `peptides` are object arrays of str.
STRING_COLUMNS = ("identifiers", "peptides")
COLUMN_DTYPES = {
    "precursor_mz": np.float32, "precursor_charge": np.int32,
    "is_decoy": np.bool_, "peak_offsets": np.int64, "peak_mz": np.float32,
    "peak_intensity": np.float32, "peak_ann_type": np.uint8,
    "peak_ann_index": np.int16, "peak_ann_charge": np.uint8,
    "proc_mz": np.float32, "proc_intensity": np.float32,
    "proc_ann_charge": np.uint8, "proc_n_peaks": np.int32,
    "proc_is_valid": np.bool_,
}
_META_KEYS = ("config_hash", "source_filename", "source_version",
              "source_fingerprint")


def source_fingerprint(path: str) -> str:
    """Cheap content fingerprint of a library file: size + md5 of the
    first 1 MiB and last 64 KiB (the JAX package's, value for value).

    The settings hash alone misses a library file rewritten in place
    (same name, same settings, different spectra), which would silently
    reuse a stale store.  Content changes anywhere move the size or the
    sampled bytes with overwhelming probability for real library files.
    """
    try:
        size = os.path.getsize(path)
        h = hashlib.md5()
        with open(path, "rb") as f:
            h.update(f.read(1 << 20))
            if size > (1 << 20) + (1 << 16):
                f.seek(-(1 << 16), os.SEEK_END)
                h.update(f.read(1 << 16))
        return f"{size}:{h.hexdigest()}"
    except OSError:
        return "null"


def hyperparameter_hash(config) -> str:
    """SHA-1 over the settings that determine store/index contents (the
    JAX package's hash, value for value: it seeds the decoys)."""
    keys = [
        "min_mz", "max_mz", "bin_size", "hash_len", "num_list",
        "min_peaks", "min_mz_range", "min_intensity", "max_peaks_used",
        "max_peaks_used_library", "scaling", "resolution",
        "remove_precursor", "remove_precursor_tolerance",
    ]
    values = {k: config[k] for k in keys}
    # The JAX package's preprocessing revision, part of its hash.
    values["_preprocess_rev"] = 2
    payload = json.dumps(values).encode("utf-8")
    return hashlib.sha1(payload).hexdigest()


class ChargeBlock:
    """All spectra of one precursor charge, as dense arrays."""

    def __init__(self, rows: np.ndarray, store: "SpectralLibraryStore"):
        self.rows = rows  # global row indices into the store
        self.precursor_mz = store.precursor_mz[rows]
        self.is_decoy = store.is_decoy[rows]
        self.proc_mz = store.proc_mz[rows]
        self.proc_intensity = store.proc_intensity[rows]
        self.proc_ann_charge = store.proc_ann_charge[rows]
        self.proc_n_peaks = store.proc_n_peaks[rows]
        self.proc_is_valid = store.proc_is_valid[rows]

    @property
    def n_spectra(self) -> int:
        return len(self.rows)


class SpectralLibraryStore:
    """In-memory columnar library store (the arrays of the JAX package's
    store file, with the same dtypes), built by `build_store` or opened
    from a store file with `SpectralLibraryStore.open`."""

    def __init__(self, columns: Dict[str, np.ndarray], config_hash: str,
                 source_filename: str, source_version: str,
                 source_fingerprint: str = "null",
                 filename: Optional[str] = None):
        self.filename = filename
        self.config_hash = config_hash
        self.source_filename = source_filename
        self._source_version = source_version
        self.source_fingerprint = source_fingerprint
        self.identifiers = columns["identifiers"]
        self.peptides = columns["peptides"]
        self.precursor_mz = columns["precursor_mz"]
        self.precursor_charge = columns["precursor_charge"]
        self.is_decoy = columns["is_decoy"]
        self.peak_offsets = columns["peak_offsets"]
        self.peak_mz = columns["peak_mz"]
        self.peak_intensity = columns["peak_intensity"]
        self.peak_ann_type = columns["peak_ann_type"]
        self.peak_ann_index = columns["peak_ann_index"]
        self.peak_ann_charge = columns["peak_ann_charge"]
        self.proc_mz = columns["proc_mz"]
        self.proc_intensity = columns["proc_intensity"]
        self.proc_ann_charge = columns["proc_ann_charge"]
        self.proc_n_peaks = columns["proc_n_peaks"]
        self.proc_is_valid = columns["proc_is_valid"]
        self._charge_blocks: Dict[int, ChargeBlock] = {}

    @classmethod
    def open(cls, filename: str) -> "SpectralLibraryStore":
        """Read a store file written by `SpectralLibraryStore.save`.

        Raises OSError, ValueError, KeyError or zipfile.BadZipFile on a
        file that is missing, cut short or not a store.  Touches no random
        state.
        """
        with np.load(filename, allow_pickle=False) as f:
            columns = {name: f[name] for name in COLUMN_DTYPES}
            for name in STRING_COLUMNS:
                columns[name] = _unpack_strings(
                    f[name + "_bytes"], f[name + "_offsets"])
            meta = {key: str(f[key][()]) for key in _META_KEYS}
        return cls(columns, meta["config_hash"], meta["source_filename"],
                   meta["source_version"], meta["source_fingerprint"],
                   filename=filename)

    def save(self, filename: str) -> None:
        """Write the store to `filename`: every column with its dtype, the
        strings as UTF-8 bytes + offsets, the four attributes as 0-d
        string arrays.  The file appears under its name only when it is
        complete (temporary name in the same directory, then
        `os.replace`)."""
        arrays = {name: np.asarray(getattr(self, name), dtype)
                  for name, dtype in COLUMN_DTYPES.items()}
        for name in STRING_COLUMNS:
            data, offsets = _pack_strings(getattr(self, name))
            arrays[name + "_bytes"] = data
            arrays[name + "_offsets"] = offsets
        arrays["config_hash"] = np.asarray(str(self.config_hash))
        arrays["source_filename"] = np.asarray(str(self.source_filename))
        arrays["source_version"] = np.asarray(str(self._source_version))
        arrays["source_fingerprint"] = np.asarray(
            str(self.source_fingerprint))
        write_npz_atomically(filename, arrays)
        self.filename = filename

    @property
    def n_spectra(self) -> int:
        return len(self.precursor_mz)

    def charges(self) -> List[int]:
        return sorted(int(c) for c in np.unique(self.precursor_charge))

    def charge_block(self, charge: int) -> Optional[ChargeBlock]:
        """Dense arrays for all spectra with the given precursor charge."""
        if charge not in self._charge_blocks:
            rows = np.nonzero(self.precursor_charge == charge)[0]
            if len(rows) == 0:
                return None
            self._charge_blocks[charge] = ChargeBlock(rows, self)
        return self._charge_blocks[charge]

    def get_spectrum(self, row: int, processed: bool = True) -> Spectrum:
        """Materialize one spectrum (host side, for output/plotting)."""
        if processed:
            n = int(self.proc_n_peaks[row])
            return Spectrum(
                identifier=str(self.identifiers[row]),
                precursor_mz=float(self.precursor_mz[row]),
                precursor_charge=int(self.precursor_charge[row]),
                mz=self.proc_mz[row, :n],
                intensity=self.proc_intensity[row, :n],
                ann_charge=self.proc_ann_charge[row, :n].astype(np.uint8),
                peptide=str(self.peptides[row]),
                is_decoy=bool(self.is_decoy[row]),
                index=row,
            )
        lo, hi = self.peak_offsets[row], self.peak_offsets[row + 1]
        return Spectrum(
            identifier=str(self.identifiers[row]),
            precursor_mz=float(self.precursor_mz[row]),
            precursor_charge=int(self.precursor_charge[row]),
            mz=self.peak_mz[lo:hi],
            intensity=self.peak_intensity[lo:hi],
            ann_type=self.peak_ann_type[lo:hi],
            ann_index=self.peak_ann_index[lo:hi],
            ann_charge=self.peak_ann_charge[lo:hi],
            peptide=str(self.peptides[row]),
            is_decoy=bool(self.is_decoy[row]),
            index=row,
        )

    def get_version(self) -> str:
        """Library version: the source file's UTC modification time."""
        return str(self._source_version)


def _source_version(source_filename: str) -> str:
    # The JAX build stats the library's base name relative to the
    # working directory, so the version is "null" unless the search runs
    # beside the library; the same call keeps the mzTab columns equal.
    try:
        mtime = os.path.getmtime(source_filename)
    except OSError:
        return "null"
    return datetime.datetime.fromtimestamp(
        mtime, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%SZ")


def _pack_strings(strings):
    """(UTF-8 bytes (total,) uint8, offsets (n + 1,) int64) of a sequence
    of str."""
    encoded = [str(s).encode("utf-8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return np.frombuffer(b"".join(encoded), np.uint8), offsets


def _unpack_strings(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """The object array of str that `_pack_strings` packed."""
    blob = data.tobytes()
    out = np.empty(len(offsets) - 1, object)
    out[:] = [blob[lo:hi].decode("utf-8")
              for lo, hi in zip(offsets[:-1], offsets[1:])]
    return out


def _concat(chunks, dtype, shape_tail=()):
    if chunks:
        return np.concatenate(chunks)
    return np.zeros((0,) + tuple(shape_tail), dtype)


def build_store(
    spectra: Iterator[Spectrum],
    config_hash: str,
    source_filename: str,
    params: PreprocessParams,
    device: torch.device,
    add_decoys: bool = False,
    stage_seconds: Optional[Dict[str, float]] = None,
    filename: Optional[str] = None,
    source_fp: Optional[str] = None,
) -> SpectralLibraryStore:
    """Build the store: read spectra, make decoys, preprocess on `device`;
    with `filename` given, also write it there (`SpectralLibraryStore.save`).

    With `stage_seconds` given, the wall seconds spent reading spectra
    ("library read"), making decoys ("decoys"), preprocessing
    ("library preprocess", the device synchronized) and writing the file
    ("store write") are added to it.
    """
    # Decoy shuffling consumes the global NumPy RNG; the JAX build seeds
    # it from the config hash, and so does this one.
    if add_decoys:
        np.random.seed(int(config_hash[:8], 16) & 0x7FFFFFFF)
    seconds = {"library read": 0.0, "decoys": 0.0, "library preprocess": 0.0}
    identifiers: List[str] = []
    peptides: List[str] = []
    precursor_mz: List[float] = []
    precursor_charge: List[int] = []
    is_decoy: List[bool] = []
    mz_chunks: List[np.ndarray] = []
    intensity_chunks: List[np.ndarray] = []
    ann_type_chunks: List[np.ndarray] = []
    ann_index_chunks: List[np.ndarray] = []
    ann_charge_chunks: List[np.ndarray] = []
    lengths: List[int] = []
    processed: List[Dict[str, np.ndarray]] = []
    batch: List[Spectrum] = []

    def flush():
        if not batch:
            return
        t0 = time.perf_counter()
        packed = pack_spectra(batch, pad_multiple=128)
        out = preprocess_batch(
            params, *(torch.from_numpy(a).to(device) for a in (
                packed.mz, packed.intensity, packed.ann_charge,
                packed.n_peaks, packed.precursor_mz,
                packed.precursor_charge,
            ))
        )
        processed.append({
            name: getattr(out, name).cpu().numpy()
            for name in ("mz", "intensity", "ann_charge", "n_peaks",
                         "is_valid")
        })
        batch.clear()
        synchronize(device)
        seconds["library preprocess"] += time.perf_counter() - t0

    def add(spectrum: Spectrum):
        identifiers.append(spectrum.identifier)
        peptides.append(spectrum.peptide or "")
        precursor_mz.append(float(spectrum.precursor_mz))
        precursor_charge.append(int(spectrum.precursor_charge or 0))
        is_decoy.append(bool(spectrum.is_decoy))
        n = spectrum.n_peaks
        lengths.append(n)
        mz_chunks.append(np.asarray(spectrum.mz, np.float32))
        intensity_chunks.append(np.asarray(spectrum.intensity, np.float32))
        ann_type_chunks.append(
            spectrum.ann_type.astype(np.uint8)
            if spectrum.ann_type is not None
            else np.zeros(n, np.uint8)
        )
        ann_index_chunks.append(
            spectrum.ann_index.astype(np.int16)
            if spectrum.ann_index is not None
            else np.zeros(n, np.int16)
        )
        ann_charge_chunks.append(spectrum.annotation_charges())
        batch.append(spectrum)
        if len(batch) >= _BUILD_BATCH:
            flush()

    if add_decoys:
        from ann_solo_tpu_torch.decoy import shuffle_and_reposition

    n_read = 0
    spectra = iter(spectra)
    while True:
        t0 = time.perf_counter()
        spectrum = next(spectra, None)
        seconds["library read"] += time.perf_counter() - t0
        if spectrum is None:
            break
        if add_decoys:
            t0 = time.perf_counter()
            try:
                decoy = shuffle_and_reposition(spectrum)
            except (ValueError, KeyError) as e:
                decoy = None
                logger.warning(
                    "Failed to generate decoy for spectrum %s: %s",
                    spectrum.identifier, e,
                )
            seconds["decoys"] += time.perf_counter() - t0
            if decoy is not None:
                add(decoy)
        add(spectrum)
        n_read += 1
        if n_read % 10000 == 0:
            logger.info("Library spectra read: %d", n_read)
    flush()

    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    k = params.max_peaks_used
    columns = {
        "identifiers": np.asarray(identifiers, object),
        "peptides": np.asarray(peptides, object),
        "precursor_mz": np.asarray(precursor_mz, np.float32),
        "precursor_charge": np.asarray(precursor_charge, np.int32),
        "is_decoy": np.asarray(is_decoy, bool),
        "peak_offsets": offsets,
        "peak_mz": _concat(mz_chunks, np.float32),
        "peak_intensity": _concat(intensity_chunks, np.float32),
        "peak_ann_type": _concat(ann_type_chunks, np.uint8),
        "peak_ann_index": _concat(ann_index_chunks, np.int16),
        "peak_ann_charge": _concat(ann_charge_chunks, np.uint8),
        "proc_mz": _concat([p["mz"] for p in processed], np.float32, (k,)),
        "proc_intensity": _concat(
            [p["intensity"] for p in processed], np.float32, (k,)),
        "proc_ann_charge": _concat(
            [p["ann_charge"] for p in processed], np.uint8, (k,)
        ).astype(np.uint8),
        "proc_n_peaks": _concat(
            [p["n_peaks"] for p in processed], np.int32),
        "proc_is_valid": _concat([p["is_valid"] for p in processed], bool),
    }
    store = SpectralLibraryStore(
        columns, config_hash, source_filename,
        _source_version(source_filename), source_fp or "null",
    )
    if filename is not None:
        t0 = time.perf_counter()
        store.save(filename)
        seconds["store write"] = time.perf_counter() - t0
    if stage_seconds is not None:
        for name, value in seconds.items():
            stage_seconds[name] = stage_seconds.get(name, 0.0) + value
    logger.info("Built spectral library store %s (%d spectra, %d rows)",
                filename or "in memory", n_read, len(identifiers))
    return store


def store_filename(library_filename: str, config_hash: str) -> str:
    """The JAX package's stem with this package's own extension."""
    base = os.path.splitext(library_filename)[0]
    return f"{base}_{config_hash[:7]}.store.npz"


def open_or_build_store(
    library_filename: str,
    config,
    params: PreprocessParams,
    device: torch.device,
    stage_seconds: Optional[Dict[str, float]] = None,
) -> SpectralLibraryStore:
    """Open the store for a library, rebuilding on hash/file mismatch
    (the JAX package's reuse rule): the file is reused only when its
    settings hash, the library's base name and the library file's
    fingerprint all match; a file that cannot be read is rebuilt too.

    With `stage_seconds` given, a reused store adds its "store load"
    seconds to it, a built one `build_store`'s stages.
    """
    from ann_solo_tpu_torch.io.reader import read_library_file

    config_hash = hyperparameter_hash(config)
    filename = store_filename(library_filename, config_hash)
    source_fp = source_fingerprint(library_filename)
    if os.path.isfile(filename):
        try:
            t0 = time.perf_counter()
            store = SpectralLibraryStore.open(filename)
            if (
                store.config_hash == config_hash
                and store.source_filename
                == os.path.basename(library_filename)
                and store.source_fingerprint == source_fp
            ):
                if stage_seconds is not None:
                    stage_seconds["store load"] = (
                        stage_seconds.get("store load", 0.0)
                        + time.perf_counter() - t0)
                return store
            if store.source_fingerprint != source_fp:
                logger.warning(
                    "The library file content changed since the store "
                    "was built; rebuilding"
                )
            else:
                logger.warning(
                    "The spectral library store was created using "
                    "non-compatible settings; rebuilding"
                )
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            logger.warning("Failed to open library store: %s; rebuilding", e)
    else:
        logger.warning("Missing spectral library store; creating %s",
                       filename)
    return build_store(
        read_library_file(library_filename),
        config_hash,
        os.path.basename(library_filename),
        params,
        device,
        add_decoys=bool(config.add_decoys),
        stage_seconds=stage_seconds,
        filename=filename,
        source_fp=source_fp,
    )
