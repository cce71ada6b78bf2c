"""Spherical k-means for the IVF coarse quantizer, in PyTorch.

Port of `ann_solo_tpu/ops/kmeans.py`.  Vectors are unit norm, so
inner-product assignment is L2 assignment; centroids are renormalized every
iteration.  The per-cluster sums are one-hot matrix products per
4096-row block (deterministic, no atomics).  The random initial centroids
come from `np.random.RandomState(seed)` exactly as in the JAX package, so
both packages start from the same centroids.  Top-k over centroids keeps
`lax.top_k`'s order (ties to the lower index) through stable sorts.
"""

from __future__ import annotations

import numpy as np
import torch

from ann_solo_tpu_torch.ops.topk import stable_topk_desc

_BLOCK = 4096


@torch.no_grad()
def blocked_assign_sums(vectors_padded: torch.Tensor, centroids):
    """Per-cluster (sums (L, D), counts (L,)) under nearest-centroid
    assignment of a zero-row-padded block (rows % 4096 == 0); zero rows
    carry weight 0."""
    n_pad, d = vectors_padded.shape
    l = centroids.shape[0]
    dev = vectors_padded.device
    sums = torch.zeros((l, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((l,), dtype=torch.float32, device=dev)
    cluster_iota = torch.arange(l, device=dev)[None, :]
    for start in range(0, n_pad, _BLOCK):
        block = vectors_padded[start:start + _BLOCK].to(torch.float32)
        ids = (block @ centroids.T).argmax(1)
        w = ((block * block).sum(1) > 0).to(torch.float32)
        onehot = (ids[:, None] == cluster_iota).to(torch.float32) * w[:, None]
        sums = sums + onehot.T @ block
        counts = counts + onehot.sum(0)
    return sums, counts


@torch.no_grad()
def _kmeans_fit(vectors_padded, init_centroids, n_iter: int):
    """`n_iter` blocked spherical k-means steps, then the final nearest-
    centroid assignment of every row."""
    centroids = init_centroids
    for _ in range(n_iter):
        sums, counts = blocked_assign_sums(vectors_padded, centroids)
        counts = counts[:, None]
        new = sums / counts.clamp_min(1.0)
        new = torch.where(counts > 0, new, centroids)  # keep empty clusters
        norms = torch.linalg.vector_norm(new, dim=1, keepdim=True)
        centroids = new / norms.clamp_min(1e-30)
    assignments = torch.cat([
        (vectors_padded[s:s + _BLOCK].to(torch.float32) @ centroids.T)
        .argmax(1)
        for s in range(0, vectors_padded.shape[0], _BLOCK)
    ])
    return centroids, assignments


@torch.no_grad()
def assign_topk_blocked(vectors, centroids, k_choices: int,
                        block: int = 16384) -> torch.Tensor:
    """Top-`k_choices` nearest centroids per vector ((N, A) int64)."""
    return torch.cat([
        stable_topk_desc(
            vectors[s:s + block].to(torch.float32) @ centroids.T, k_choices
        )[1]
        for s in range(0, vectors.shape[0], block)
    ])


@torch.no_grad()
def _soar_rerank_block(vectors, centroids, choices, lam: float):
    v = vectors.to(torch.float32)
    c = centroids[choices]  # (B, A, D)
    s = torch.einsum("bd,bad->ba", v, c)
    r1 = v - c[:, 0, :]
    r1 = r1 / torch.linalg.vector_norm(r1, dim=1, keepdim=True).clamp_min(
        1e-9
    )
    proj = torch.einsum("bad,bd->ba", v[:, None, :] - c, r1)
    obj = s - (lam / 2.0) * proj * proj
    # The primary (rank-0) list is excluded: it sorts last and is dropped.
    obj[:, 0] = float("-inf")
    order = torch.sort(-obj, dim=1, stable=True).indices
    return choices.gather(1, order)[:, :-1]


@torch.no_grad()
def soar_round2_choices(vectors, centroids, choices, lam: float,
                        block: int = 8192) -> torch.Tensor:
    """Candidate lists for the second (SOAR) fill round, best first,
    primary excluded ((N, A - 1)): maximize
    ``v . c_l - (lam / 2) * ((v - c_l) . r1_hat)^2`` over the non-primary
    candidates (Sun et al., NeurIPS 2023; `ops/kmeans.py` in the JAX
    package).  Per-row math, so any block size gives the same ranking."""
    return torch.cat([
        _soar_rerank_block(
            vectors[s:s + block], centroids, choices[s:s + block], lam
        )
        for s in range(0, vectors.shape[0], block)
    ])


@torch.no_grad()
def spherical_kmeans(
    vectors: torch.Tensor,
    n_clusters: int,
    n_iter: int = 25,
    seed: int = 42,
    max_points_per_centroid: int = 0,
):
    """Train spherical k-means on `vectors` (on their device); returns
    (centroids (L, D) float32, assignments (N,)).  With
    `max_points_per_centroid` > 0 the fit runs on a random subsample of at
    most n_clusters * max_points_per_centroid rows (FAISS's rule)."""
    n, d = vectors.shape
    dev = vectors.device
    cap = (
        n_clusters * max_points_per_centroid
        if max_points_per_centroid > 0
        else n
    )
    if n > cap:
        rng_sub = np.random.RandomState(seed + 1)
        sub_idx = np.sort(rng_sub.choice(n, size=cap, replace=False))
        centroids, _ = spherical_kmeans(
            vectors[torch.as_tensor(sub_idx, device=dev)], n_clusters,
            n_iter=n_iter, seed=seed,
        )
        return centroids, assign_topk_blocked(vectors, centroids, 1)[:, 0]
    rng = np.random.RandomState(seed)
    init_idx = rng.choice(n, size=min(n_clusters, n), replace=False)
    init = vectors[torch.as_tensor(init_idx, device=dev)]
    if init.shape[0] < n_clusters:
        # Fewer vectors than clusters: tile with small jitter.
        reps = -(-n_clusters // init.shape[0])
        init = init.repeat(reps, 1)[:n_clusters]
        init = init + torch.as_tensor(
            rng.normal(0, 1e-4, tuple(init.shape)), dtype=torch.float32,
            device=dev,
        )
    init = init.to(torch.float32)
    init = init / torch.linalg.vector_norm(
        init, dim=1, keepdim=True
    ).clamp_min(1e-30)
    n_pad = max(_BLOCK, -(-n // _BLOCK) * _BLOCK)
    padded = vectors
    if n_pad != n:
        padded = torch.zeros((n_pad, d), dtype=vectors.dtype, device=dev)
        padded[:n] = vectors
    centroids, assignments = _kmeans_fit(padded, init, n_iter)
    return centroids, assignments[:n]
