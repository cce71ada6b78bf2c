"""ANN-SoLo open search in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch counterpart of `ann_solo_tpu` (the JAX package, which stays the
reference this package is tested against).  Modules mirror the JAX layout:
`cli.py` and `config.py` (the command line), `search.py` (the engine: the
std -> open cascade, window rescoring, the ANN open-search batch), `io/`
(readers and writers, the in-memory library store, mzTab), `fdr.py`,
`decoy.py`, `ops/` (shifted-dot rescoring, the CUDA kernels, k-means),
`models/` (the spectrum model, preprocessing, hashed vectorization, SSM
features), `index/` (the IVF index), `parallel/` (meshes of devices) and
the tools around the CLI: `quality.py` and `sweep.py` (the harnesses),
`eval.py` (mzTab statistics) and `plot.py` (the mirror plot).

This package imports torch, numpy and scipy, and nothing of
`ann_solo_tpu`: what it needs from the JAX-free modules there (the
MurmurHash3 bin table, masses, the readers, config, decoys, synthetic
data, the local FASTA predictor) it keeps as its own copy.  Never jax,
ml_dtypes, sklearn, pandas or h5py; matplotlib only to render a plot.
"""

import torch

# Float32 matrix products must run in full float32: the JAX reference
# accumulates its coarse-probe and scan products in float32
# (`preferred_element_type`), and TF32's 10-bit mantissa would change the
# 16-bit scan keys and probe rankings.  Both switches are set explicitly
# rather than trusting PyTorch's defaults (cuDNN's default is TF32 on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
