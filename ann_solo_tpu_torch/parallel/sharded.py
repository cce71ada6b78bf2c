"""Library-sharded masked top-k search and k-means step (the port of
`ann_solo_tpu/parallel/sharded.py`).

* `sharded_topk_search`: library rows split over the 'lib' axis, query
  batches over 'dp'; each shard scores its rows with the precursor window
  masked, takes a local top-k, and the per-shard results are gathered
  onto the replica's first device and merged: what crosses devices is
  O(k) per query, never O(N).
* `sharded_kmeans_step`: one spherical k-means update with the rows split
  over the whole mesh; the per-shard cluster sums add up in shard order.
* `sharded_search_step`: both, as the JAX package's multi-chip step.

Each shard's work runs on its own device (`collectives.on_device`); the
devices of a mesh may repeat.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ann_solo_tpu_torch.ops.kmeans import _BLOCK, blocked_assign_sums
from ann_solo_tpu_torch.ops.topk import stable_topk_desc
from ann_solo_tpu_torch.parallel.collectives import all_gather, on_device, psum
from ann_solo_tpu_torch.parallel.mesh import Mesh, replica_devices


def _masked_local_scores(
    queries, query_prec, lib_vectors, lib_prec, charge, tol
):
    """Local scores with the precursor window and all-zero (padding) rows
    masked to -inf."""
    scores = queries @ lib_vectors.T
    window = (query_prec[:, None] - lib_prec[None, :]).abs() * charge <= tol
    valid = (lib_vectors * lib_vectors).sum(1) > 0
    return torch.where(window & valid[None, :], scores, float("-inf"))


@torch.no_grad()
def sharded_topk_search(
    mesh: Mesh,
    lib_vectors,  # (N, D) split over 'lib'
    lib_prec,  # (N,)
    queries,  # (B, D) split over 'dp'
    query_prec,  # (B,)
    k: int,
    charge: float,
    tol: float,
):
    """Masked top-k candidate selection over a (dp, lib) mesh.

    Returns (ids (B, k) int32 global library rows, -1 where fewer than k
    rows are in the window; scores (B, k) float32), on dp replica 0's first
    device.  Equal scores keep the lower row first (`lax.top_k`'s order)."""
    lib_vectors = torch.as_tensor(lib_vectors, dtype=torch.float32)
    lib_prec = torch.as_tensor(lib_prec, dtype=torch.float32)
    queries = torch.as_tensor(queries, dtype=torch.float32)
    query_prec = torch.as_tensor(query_prec, dtype=torch.float32)
    n = lib_vectors.shape[0]
    lib_shards = mesh.shape["lib"]
    dp = mesh.shape["dp"]
    if n % lib_shards:
        raise ValueError("library must pad to the shard count")
    if queries.shape[0] % dp:
        raise ValueError("the query batch must pad to the dp size")
    shard_size = n // lib_shards
    b_l = queries.shape[0] // dp
    grid = replica_devices(mesh)
    out_ids, out_scores = [], []
    for d, devices in enumerate(grid):
        q = queries[d * b_l:(d + 1) * b_l]
        qp = query_prec[d * b_l:(d + 1) * b_l]
        local_s, local_i = [], []
        for s, device in enumerate(devices):
            rows = slice(s * shard_size, (s + 1) * shard_size)
            with on_device(device):
                scores = _masked_local_scores(
                    q.to(device), qp.to(device), lib_vectors[rows].to(device),
                    lib_prec[rows].to(device), charge, tol,
                )
                top_s, top_i = stable_topk_desc(scores, min(k, shard_size))
            local_s.append(top_s)
            local_i.append(top_i + s * shard_size)
        home = devices[0]
        all_s = all_gather(local_s, home)  # (S, B_l, kk)
        all_i = all_gather(local_i, home)
        merged_s = all_s.transpose(0, 1).reshape(b_l, -1)
        merged_i = all_i.transpose(0, 1).reshape(b_l, -1)
        top_s, pos = stable_topk_desc(merged_s, min(k, merged_s.shape[1]))
        top_i = torch.where(top_s > float("-inf"), merged_i.gather(1, pos), -1)
        out_ids.append(top_i.to(torch.int32))
        out_scores.append(top_s)
    home = grid[0][0]
    return (torch.cat([t.to(home) for t in out_ids]),
            torch.cat([t.to(home) for t in out_scores]))


def _split_rows(mesh: Mesh, vectors) -> List[torch.Tensor]:
    """`vectors` (N, D), N a multiple of the mesh size, split over the
    whole mesh row-major; each part zero-padded to a multiple of the
    k-means block (zero rows carry weight 0) and placed on its device
    (devices in row-major mesh order)."""
    devices = list(mesh.devices.ravel())
    n = vectors.shape[0]
    if n % len(devices):
        raise ValueError("rows must pad to the mesh size")
    n_l = n // len(devices)
    n_pad = max(_BLOCK, -(-n_l // _BLOCK) * _BLOCK)
    parts = []
    for i, device in enumerate(devices):
        part = vectors[i * n_l:(i + 1) * n_l].to(device=device,
                                                 dtype=torch.float32)
        parts.append(F.pad(part, (0, 0, 0, n_pad - n_l)))
    return parts


@torch.no_grad()
def _kmeans_update(parts: List[torch.Tensor], centroids: torch.Tensor):
    """One spherical k-means update over row parts on their devices: local
    cluster sums (the single-device fit's blocked one-hot products), their
    sum in part order on the first part's device, the mean, renormalized.
    Empty clusters keep their centroid."""
    sums, counts = [], []
    for part in parts:
        with on_device(part.device):
            s, c = blocked_assign_sums(part, centroids.to(part.device))
        sums.append(s)
        counts.append(c)
    home = parts[0].device
    total = psum(sums, home)
    count = psum(counts, home)[:, None]
    centroids = centroids.to(home)
    new = torch.where(count > 0, total / count.clamp_min(1.0), centroids)
    norms = torch.linalg.vector_norm(new, dim=1, keepdim=True)
    return new / norms.clamp_min(1e-30)


def sharded_kmeans_step(
    mesh: Mesh,
    lib_vectors,  # (N, D) split over the WHOLE mesh
    centroids,  # (L, D) replicated
):
    """One spherical k-means update with library rows split over every
    axis of the mesh; the (L, D + 1) partial sums add up in shard order.
    Returns the new centroids on the mesh's first device."""
    parts = _split_rows(mesh, torch.as_tensor(lib_vectors))
    return _kmeans_update(parts, torch.as_tensor(centroids,
                                                 dtype=torch.float32))


def sharded_search_step(
    mesh: Mesh,
    lib_vectors,
    lib_prec,
    centroids,
    queries,
    query_prec,
    k: int,
    charge: float = 2.0,
    tol: float = 500.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The multi-device step: sharded search, then a k-means update of
    the index quantizer.  Returns (ids, scores, new centroids)."""
    ids, scores = sharded_topk_search(
        mesh, lib_vectors, lib_prec, queries, query_prec, k, charge, tol
    )
    new_centroids = sharded_kmeans_step(mesh, lib_vectors, centroids)
    return ids, scores, new_centroids
