"""Deterministic seeding (reference: ann_solo/rndm.py).

The port's copy of `ann_solo_tpu/rndm.py` (the port imports nothing of
the JAX package); `tests/test_torch_engine_io.py` holds it equal.
"""

import os
import random

import numpy as np


def set_seeds(my_seed: int = 42) -> None:
    """Seed Python, NumPy, and the hash seed for reproducible runs."""
    os.environ["PYTHONHASHSEED"] = str(my_seed)
    random.seed(my_seed)
    np.random.seed(my_seed)
