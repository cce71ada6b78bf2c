"""PyTorch vectorize + preprocess vs the JAX package on the same inputs.

Integer outputs and masks must be identical; intensities and vectors agree
at atol 1e-6 (float32 norms summed in another order).
"""

import numpy as np
import pytest
import torch

from ann_solo_tpu.models.preprocess import (
    PreprocessParams as JaxPreprocessParams,
    preprocess_batch as jax_preprocess,
)
from ann_solo_tpu.models.spectrum import Spectrum, pack_spectra
from ann_solo_tpu.models.vectorize import (
    VectorizeParams as JaxVectorizeParams,
    get_dim,
    vectorize_batch as jax_vectorize,
)
from ann_solo_tpu_torch.models.preprocess import (
    PreprocessParams,
    preprocess_batch,
)
from ann_solo_tpu_torch.models.vectorize import (
    VectorizeParams,
    device_tables,
    vectorize_batch,
)

ATOL = 1e-6


def _edge_block(rng, k=50):
    """m/z on, just below and just above float64 bin edges, plus random
    peaks and padded lanes."""
    n_bins, start, _ = get_dim(11.0, 2010.0, 0.04)
    bins = np.concatenate(
        [rng.integers(0, n_bins, 100), n_bins - 1 - rng.integers(0, 50, 50)]
    )
    edges = (start + bins.astype(np.float64) * 0.04).astype(np.float32)
    mz = np.concatenate([
        edges,
        np.nextafter(edges, np.float32(0), dtype=np.float32),
        np.nextafter(edges, np.float32(1e9), dtype=np.float32),
        rng.uniform(5.0, 2100.0, 150).astype(np.float32),
    ])
    rng.shuffle(mz)
    b = len(mz) // k
    mz = np.sort(mz[: b * k].reshape(b, k), axis=1)
    intensity = rng.uniform(0.05, 1.0, (b, k)).astype(np.float32)
    n_peaks = rng.integers(k // 2, k + 1, b).astype(np.int32)
    lane = np.arange(k)[None, :]
    intensity[lane >= n_peaks[:, None]] = 0.0
    return mz, intensity, n_peaks


@pytest.mark.parametrize("norm", [True, False])
def test_vectorize_matches_jax(norm):
    rng = np.random.default_rng(5)
    mz, intensity, n_peaks = _edge_block(rng)
    jparams = JaxVectorizeParams(11.0, 2010.0, 0.04, 800)
    expected = np.asarray(jax_vectorize(
        jparams, jparams.tables(), mz, intensity, n_peaks, norm
    ))
    params = VectorizeParams(11.0, 2010.0, 0.04, 800)
    np.testing.assert_array_equal(
        params.tables().thresholds, jparams.tables().thresholds
    )
    np.testing.assert_array_equal(
        params.tables().bucket, jparams.tables().bucket
    )
    got = vectorize_batch(
        params, device_tables(params, "cpu"), torch.from_numpy(mz),
        torch.from_numpy(intensity), torch.from_numpy(n_peaks), norm,
    ).numpy()
    # Same buckets exactly: the nonzero pattern is identical.
    np.testing.assert_array_equal(got != 0, expected != 0)
    np.testing.assert_allclose(got, expected, atol=ATOL, rtol=0)


def _spectra(rng, n, dup=False):
    out = []
    for i in range(n):
        n_peaks = int(rng.integers(5, 160))
        mz = np.sort(rng.uniform(50.0, 1900.0, n_peaks))
        if dup:  # near-duplicates that merge after rounding
            mz[1::4] = mz[0::4][: len(mz[1::4])] + 0.01
            mz = np.sort(mz)
        intensity = rng.uniform(0.001, 1.0, n_peaks)
        prec = float(rng.uniform(400, 1200))
        mz[: n_peaks // 10] = prec + rng.normal(0, 0.1, n_peaks // 10)
        out.append(Spectrum(f"s{i}", prec, int(rng.integers(1, 4)),
                            np.sort(mz), intensity))
    return out


@pytest.mark.parametrize(
    "kw",
    [
        dict(scaling="rank"),
        dict(scaling="sqrt", max_peaks_used=30),
        dict(scaling="rank", remove_precursor=True,
             remove_precursor_tolerance=0.5),
        dict(scaling=None, resolution=1, min_intensity=0.0),
    ],
    ids=["rank", "sqrt", "remove_precursor", "resolution"],
)
def test_preprocess_matches_jax(kw):
    rng = np.random.default_rng(11)
    spectra = _spectra(rng, 40, dup="resolution" in kw)
    batch = pack_spectra(spectra)
    args = (batch.mz, batch.intensity, batch.ann_charge, batch.n_peaks,
            batch.precursor_mz, batch.precursor_charge)
    exp = jax_preprocess(JaxPreprocessParams(**kw), *args)
    got = preprocess_batch(
        PreprocessParams(**kw), *(torch.from_numpy(a) for a in args)
    )
    np.testing.assert_array_equal(got.is_valid.numpy(), exp.is_valid)
    np.testing.assert_array_equal(got.n_peaks.numpy(), exp.n_peaks)
    np.testing.assert_array_equal(got.mz.numpy(), exp.mz)
    np.testing.assert_array_equal(got.ann_charge.numpy(), exp.ann_charge)
    np.testing.assert_array_equal(
        got.precursor_charge.numpy(), exp.precursor_charge
    )
    np.testing.assert_allclose(
        got.intensity.numpy(), exp.intensity, atol=ATOL, rtol=0
    )
