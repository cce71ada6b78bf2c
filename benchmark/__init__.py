"""The benchmark of the PyTorch and CUDA port (`ann_solo_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` on the card: it makes a library
and a pool of query batches from the seed, builds the IVF index, drives
`ann_solo_tpu_torch.search.ann_open_search_batch` in a closed loop for the
window, checks a sample of the answers against the plain reference
(`reference.py`), and prints one JSON line.  `HOWTO.md` says how a cell,
a configuration, a traffic mix or a per-layer metric is added as files.

Nothing here imports JAX or the JAX package, and the reference imports
nothing of the port.
"""
