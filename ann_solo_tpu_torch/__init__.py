"""ANN-SoLo open search in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch counterpart of `ann_solo_tpu` (the JAX package, which stays the
reference this package is tested against).  Modules mirror the JAX layout:
`ops/` (shifted-dot rescoring, its CUDA kernel, k-means), `models/`
(preprocessing and hashed vectorization), `index/` (the IVF index) and
`search.py` (the ANN open-search batch path).

This package imports torch and numpy, and nothing of `ann_solo_tpu`:
what it needs from there (the MurmurHash3 bin table, the proton and
neutron masses) it keeps as its own copy (`ops/murmur.py`,
`io/masses.py`).  Never jax, ml_dtypes, sklearn, pandas or h5py.
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
