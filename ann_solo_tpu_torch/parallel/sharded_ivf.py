"""List-sharded IVF search and the born-sharded build (the port of
`ann_solo_tpu/parallel/sharded_ivf.py`).

The list-major (L, cap, D) storage of `index/ivf.py` is split by *list*
over the list axes of a mesh (`parallel/mesh.py`): list shard i owns the
i-th contiguous range of L / S lists and their rows; the centroids are
on every device.  Each dp replica takes a contiguous part of the query
batch; every shard of the replica scans the probed lists it owns, takes
a local top-k, and the per-shard results are gathered onto the replica's
first device and merged: O(k) per query crosses devices, whatever the
library's size.  One process drives the mesh (`parallel/collectives.py`).

The shard-local scan takes one of three regimes, by the single-device
index's cost model:

* **fullscan** -- the local block's (128, L_l * cap) float32 score tile
  fits `index.ivf._FULLSCAN_TRANSIENT`: each 128-query tile scores every
  local list in one matrix product (bf16-rounded queries times the float32
  copy of the storage, as `index.ivf._ivf_search_fullscan`), the probe set
  a selection mask;
* **probe** -- bigger local blocks with int8 or bf16 storage: each
  query's probed local lists, ascending, compacted to a static width
  ``w`` (about twice the mean per shard on multi-shard meshes) go through
  kernel B2 (`ops/ivf_probe_cuda.py`; its plain version on the CPU); a
  query probing more than ``w`` local lists is flagged and repaired
  through the chunked regime;
* **chunked** -- the exact fallback (float32 storage, and the repair):
  local lists in chunks, each chunk's canonical top-k merged into a
  running top-k by one sort on (score desc in total order, position
  asc), so the merge is the canonical ranking with no certificates.

Every regime ranks lanes by the single-device order (16-bit bf16 key
desc, then global position; exact float32 scores for f32 storage) and
shards merge in shard-major order, which is global position order, so
results equal the single-device index's.  Not ported: the JAX package's
TPU layout padding of cap and D to multiples of 128 (padded slots are
invalid and padded columns zero; no result depends on them) and its
Pallas-only switches.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ann_solo_tpu_torch.device import synchronize
from ann_solo_tpu_torch.index import ivf as _ivf
from ann_solo_tpu_torch.index.ivf import (
    _KEY16_NINF,
    _STREAM_BLOCK,
    _build_settings,
    _canonical_topk_keys,
    _dedup_topk,
    _key16,
    _pack_group,
    _pack_prec,
    _pad_topk,
    _probe_lists,
    _total_order_key,
    chunked_scan_params,
    plan_assignments_device,
    resolve_num_probe,
    soar_round_choices,
    train_subsample,
)
from ann_solo_tpu_torch.ops.ivf_probe import probe_scan_supported, window_mask
from ann_solo_tpu_torch.ops.ivf_probe_cuda import ivf_probe_scan
from ann_solo_tpu_torch.ops.kmeans import assign_topk_blocked
from ann_solo_tpu_torch.ops.topk import stable_topk_desc
from ann_solo_tpu_torch.parallel.collectives import all_gather, on_device
from ann_solo_tpu_torch.parallel.mesh import (
    Mesh,
    n_list_shards,
    replica_devices,
)
from ann_solo_tpu_torch.parallel.sharded import _kmeans_update, _split_rows

logger = logging.getLogger(__name__)

# Probe-width slack over the per-shard mean probed-list count.
_PROBE_WIDTH_SLACK = 2
_INT32_MAX = np.iinfo(np.int32).max


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _Block(NamedTuple):
    """One list shard's arrays on one device."""

    vectors: torch.Tensor  # (L_l, cap, D) int8 | bfloat16 | float32
    ids: torch.Tensor  # (L_l, cap) int32 global row ids, -1 = empty
    prec: torch.Tensor  # (L_l, cap) float32
    scales: torch.Tensor  # (L_l, cap) float32


def _local_probe_mask(queries, centroids, num_probe: int,
                      lists_per_shard: int, shard: int):
    """(B, L_l) bool: this shard's slice of each query's probed lists (the
    top `num_probe` coarse lists, lower list id first on ties)."""
    l_total = centroids.shape[0]
    b = queries.shape[0]
    probe_ids = stable_topk_desc(queries @ centroids.T,
                                 min(num_probe, l_total))[1]
    probed = torch.zeros((b, l_total), dtype=torch.bool, device=queries.device)
    probed.scatter_(1, probe_ids, True)
    lo = shard * lists_per_shard
    return probed[:, lo:lo + lists_per_shard]


def _select(flat, k_sel: int, cast: bool):
    """Canonical top-k of (B, n) float32 lanes: 16-bit keys for int8/bf16
    storage (scores come back bf16-rounded), exact scores for float32."""
    if cast:
        return _canonical_topk_keys(_key16(flat), k_sel)
    return stable_topk_desc(flat, k_sel)


def _local_scan_fullscan(queries, query_prec, local_probed, block: _Block,
                         scan_block, k_local: int, charge: float,
                         tol_val: float, tol_mode: str):
    """Tiled masked scan of every local list (small local blocks).

    Each 128-query tile scores the whole block as one matrix product on
    `scan_block`, the (L_l * cap, D) float32 copy of the storage; the
    probe, validity and window masks apply to the scores, and the
    selection is canonical.  Score transient: (128, L_l * cap) float32."""
    l_l, cap, _ = block.vectors.shape
    cast = block.vectors.dtype != torch.float32
    q_scan = queries.to(torch.bfloat16).to(torch.float32) if cast else queries
    scales = block.scales.reshape(1, l_l * cap)
    valid = block.ids >= 0
    flat_ids = block.ids.reshape(-1)
    k_t = min(k_local, l_l * cap)
    out_s, out_i = [], []
    for start in range(0, queries.shape[0], _ivf._TILE_Q):
        qt = q_scan[start:start + _ivf._TILE_Q]
        t = qt.shape[0]
        scores = (qt @ scan_block.T) * scales  # (T, L_l * cap)
        mask = local_probed[start:start + t, :, None] & valid[None]
        if tol_val > 0:
            mask &= window_mask(query_prec[start:start + t, None, None],
                                block.prec[None], charge, tol_val, tol_mode)
        mask = mask.reshape(t, l_l * cap)
        if cast:
            keys = torch.where(mask, _key16(scores), _KEY16_NINF)
            top_s, pos = _canonical_topk_keys(keys, k_t)
        else:
            top_s, pos = stable_topk_desc(
                torch.where(mask, scores, float("-inf")), k_t)
        del scores, mask
        top_i = torch.where(top_s > float("-inf"), flat_ids[pos], -1)
        top_s, top_i = _pad_topk(top_s, top_i, k_local)
        out_s.append(top_s)
        out_i.append(top_i)
    return torch.cat(out_s), torch.cat(out_i)


def _local_scan_probe(queries, query_prec, loc_lists, block: _Block,
                      k_local: int, charge: float, tol_val: float,
                      tol_mode: str):
    """Probe-gather local scan (big local blocks, int8/bf16 storage).

    `loc_lists` (B, w) holds each query's probed local list ids ascending
    (the canonical lane order), L_l on empty slots; kernel B2 scores
    exactly those lists' slots, every slot of an empty one -inf, so the
    traffic is B x w x cap x D bytes whatever the local library's size."""
    l_l, cap, _ = block.vectors.shape
    w = loc_lists.shape[1]
    flat = ivf_probe_scan(
        block.vectors, block.ids, block.prec, block.scales, queries,
        query_prec, charge, loc_lists, tol_val, tol_mode,
    )  # (B, w * cap) float32, -inf masked
    top_s, pos = _select(flat, min(k_local, w * cap), cast=True)
    del flat
    rank = pos // cap
    lists = loc_lists.gather(1, rank).clamp_max(l_l - 1)
    top_i = block.ids[lists, pos - rank * cap]
    top_i = torch.where(top_s > float("-inf"), top_i, -1)
    return _pad_topk(top_s, top_i, k_local)


def _local_scan_chunked(queries, query_prec, local_probed, block: _Block,
                        k_local: int, charge: float, tol_val: float,
                        tol_mode: str, chunk_lists: int):
    """Chunked local scan with an exact canonical running merge.

    Local lists go `chunk_lists` at a time (the last chunk's start is
    clamped to the block's end and its re-read lists masked); each
    chunk's canonical top-k_local merges into the running top-k_local by
    one sort on (-score in total order, local position), ascending, which
    is (score desc, position asc): ties resolve as in every other regime.
    Exact with no certificates: a lane outside its own chunk's top-k_local
    is outranked by k_local lanes of that chunk alone."""
    l_l, cap, d = block.vectors.shape
    b = queries.shape[0]
    dev = queries.device
    cast = block.vectors.dtype != torch.float32
    c = min(chunk_lists, l_l)
    n_chunks = -(-l_l // c)
    k_t = min(k_local, c * cap)
    q_scan = queries.to(torch.bfloat16).to(torch.float32) if cast else queries
    iota_c = torch.arange(c, device=dev)
    run_s = torch.full((b, k_local), float("-inf"), device=dev)
    run_pos = torch.full((b, k_local), _INT32_MAX, dtype=torch.int64,
                         device=dev)
    for ci in range(n_chunks):
        start = min(ci * c, l_l - c)
        lists = slice(start, start + c)
        vecs = block.vectors[lists].reshape(c * cap, d).to(torch.float32)
        s = (q_scan @ vecs.T) * block.scales[lists].reshape(1, c * cap)
        fresh = (start + iota_c) >= ci * c
        mask = (local_probed[:, lists, None] & (block.ids[lists] >= 0)[None]
                & fresh[None, :, None])
        if tol_val > 0:
            mask &= window_mask(query_prec[:, None, None],
                                block.prec[lists][None], charge, tol_val,
                                tol_mode)
        flat = torch.where(mask.reshape(b, c * cap), s, float("-inf"))
        del vecs, s, mask
        top_s, pos = _select(flat, k_t, cast)
        cat_s = torch.cat([run_s, top_s], dim=1)
        cat_pos = torch.cat([run_pos, start * cap + pos], dim=1)
        # Ascending (-score, position); -(-inf) = +inf sorts empty lanes
        # last.  Equal packed values are equal (score, position) pairs.
        packed = _total_order_key(-cat_s) * (1 << 32) + cat_pos
        order = torch.topk(packed, k_local, dim=1, largest=False,
                           sorted=True).indices
        run_s = cat_s.gather(1, order)
        run_pos = cat_pos.gather(1, order)
    lists = (run_pos // cap).clamp(0, l_l - 1)
    slots = (run_pos % cap).clamp(0, cap - 1)
    run_i = torch.where(run_s > float("-inf"), block.ids[lists, slots], -1)
    return run_s, run_i


class ShardedIvfIndex:
    """An IVF index with its list blocks placed once across a mesh.

    Made from an `IvfIndex` (placement only) or born sharded by
    `build_sharded` / `build_sharded_streaming`.  Shards on the device the
    source index lives on are views of its blocks when the mesh has one
    device (a repeated device never copies a block); on a mesh of several
    devices every shard gets its own copy, so the source can be freed.
    `search_device` has `IvfIndex.search_device`'s signature and results.
    """

    def __init__(self, mesh: Mesh, index):
        n_lists, cap, d = index.padded_vectors.shape
        n_shards = n_list_shards(mesh)
        if n_lists % n_shards != 0:
            raise ValueError(
                f"num_list={n_lists} must divide list shards={n_shards}"
            )
        lists_per_shard = n_lists // n_shards
        self._init_params(
            mesh, int(index.num_probe), index.redundancy, lists_per_shard,
            cap, d, index.padded_vectors.dtype,
        )
        copy = len(set(mesh.devices.ravel())) > 1
        for s in range(n_shards):
            lists = slice(s * lists_per_shard, (s + 1) * lists_per_shard)
            self._place_shard(s, _Block(
                index.padded_vectors[lists], index.padded_ids[lists],
                index.padded_prec[lists], index.padded_scales[lists],
            ), copy)
        self._place_centroids(index.centroids, copy)

    def _init_params(self, mesh: Mesh, num_probe: int, redundancy: int,
                     lists_per_shard: int, cap: int, d: int,
                     dtype: torch.dtype):
        """Shared bookkeeping and the placement-time scale decision:
        `scale_regime` when a 128-query tile's (T, L_l, cap) float32 score
        block exceeds `index.ivf._FULLSCAN_TRANSIENT`."""
        self.mesh = mesh
        self.num_probe = num_probe
        self.redundancy = max(1, int(redundancy))
        self.lists_per_shard = lists_per_shard
        self.n_list_shards = n_list_shards(mesh)
        self.dp = mesh.shape["dp"]
        self.storage_dtype = dtype
        self.cap = cap
        self.dim = d
        self.scale_regime = (
            lists_per_shard * cap * 4 * _ivf._TILE_Q
            > _ivf._FULLSCAN_TRANSIENT
        )
        self._devices = replica_devices(mesh)  # [dp][shard]
        self._blocks: Dict[Tuple[int, torch.device], _Block] = {}
        self._scan_blocks: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        self._centroids: Dict[torch.device, torch.Tensor] = {}
        # Queries the last search repaired for probe-width overflow.
        self._last_overflow = 0
        # Seconds of the build's stages (born-sharded builds).
        self.build_seconds: Dict[str, float] = {}

    def _place_shard(self, s: int, block: _Block, copy: bool) -> None:
        """Shard `s`'s arrays onto each device that holds it (once per
        device: dp replicas on the same device share one block)."""
        for devices in self._devices:
            device = devices[s]
            if (s, device) not in self._blocks:
                self._blocks[(s, device)] = _Block(
                    *(t.to(device, copy=copy) for t in block))

    def _place_centroids(self, centroids, copy: bool) -> None:
        centroids = torch.as_tensor(centroids)
        for device in set(self.mesh.devices.ravel()):
            self._centroids[device] = centroids.to(
                device=device, dtype=torch.float32, copy=copy)

    @property
    def device(self) -> torch.device:
        """The device results come back on: dp replica 0's first."""
        return self._devices[0][0]

    @property
    def num_list(self) -> int:
        return self.lists_per_shard * self.n_list_shards

    @property
    def centroids(self) -> torch.Tensor:
        """(L, D) float32 centroids on `device`."""
        return self._centroids[self.device]

    def replica_device(self, d: int) -> torch.device:
        return self._devices[d][0]

    def blocks(self, replica: int = 0) -> List[_Block]:
        """Replica `replica`'s shard blocks in shard order."""
        return [self._blocks[(s, device)]
                for s, device in enumerate(self._devices[replica])]

    def host_arrays(self, replica: int = 0) -> Dict[str, torch.Tensor]:
        """The global (L, cap[, D]) arrays on the CPU, shards concatenated
        in order, and the centroids (for tests and checks)."""
        parts = self.blocks(replica)
        out = {name: torch.cat([getattr(p, name).cpu() for p in parts])
               for name in _Block._fields}
        out["centroids"] = self.centroids.cpu()
        return out

    def _scan_block(self, s: int, device: torch.device) -> torch.Tensor:
        """(L_l * cap, D) float32 copy of a shard's storage for the
        fullscan product (cached; int8 and bf16 values convert exactly)."""
        key = (s, device)
        if key not in self._scan_blocks:
            vecs = self._blocks[key].vectors
            self._scan_blocks[key] = vecs.reshape(-1, self.dim).to(
                torch.float32)
        return self._scan_blocks[key]

    def _probe_width(self, p: int) -> int:
        """Static per-shard probe width: all p probes on one list shard;
        else about twice the mean per shard (the binomial tail; overflow
        is repaired)."""
        s = self.n_list_shards
        if s == 1:
            return p
        return min(p, max(16, _next_pow2(-(-_PROBE_WIDTH_SLACK * p // s))))

    def _chunk_lists(self, p: int, k_scan: int, b: int) -> int:
        """Lists per chunk of the chunked regime: `chunked_scan_params`'s
        bound on the (B, C, cap) score block, and the float32 copy of a
        chunk's rows within `index.ivf._CHUNK_TRANSIENT` too (the chunk
        size changes no result)."""
        _, c = chunked_scan_params(self.lists_per_shard, self.cap, p, k_scan,
                                   b)
        rows = max(1, _ivf._CHUNK_TRANSIENT // (self.cap * self.dim * 4))
        return max(1, min(c, rows))

    def _regime_params(self, b_l: int, num_probe: int, k_scan: int):
        """(regime, probe_width, chunk_lists) for a local batch of `b_l`
        queries: the sharded mirror of `IvfIndex.regime`."""
        if not self.scale_regime:
            return "fullscan", 0, 0
        p = min(num_probe if num_probe > 0 else self.num_probe,
                self.lists_per_shard)
        w = self._probe_width(p)
        if probe_scan_supported(self.lists_per_shard, self.cap, w,
                                self.storage_dtype):
            return "probe", w, 0
        return "chunked", 0, self._chunk_lists(p, k_scan, b_l)

    def regime(self, k: int, num_probe: Optional[int] = None) -> str:
        """The shard-local regime of a `_CHUNK_TQ`-query batch at top-`k`:
        "fullscan", "probe" (kernel B2) or "chunked"."""
        num_probe = int(num_probe or self.num_probe)
        return self._regime_params(_ivf._CHUNK_TQ, num_probe,
                                   self.redundancy * k)[0]

    # ------------------------------------------------------------------ #
    # Build

    @classmethod
    def build_sharded(
        cls,
        mesh: Mesh,
        vectors,  # (N, D) rows, on any device
        config,
        precursor_mz=None,
        seed: int = 42,
        storage_dtype: torch.dtype = torch.bfloat16,
        redundancy: Optional[int] = None,
        centroids=None,
        n_iter: int = 25,
    ) -> "ShardedIvfIndex":
        """Build an index born sharded from resident rows: a row accessor
        over `vectors` through `build_sharded_streaming`."""
        vectors = torch.as_tensor(vectors)
        n, d = vectors.shape
        device = replica_devices(mesh)[0][0]

        def get_rows(idx):
            rows = idx.clamp(0, n - 1).to(vectors.device)
            return vectors[rows].to(device=device, dtype=torch.float32)

        return cls.build_sharded_streaming(
            mesh, get_rows, n, d, config, precursor_mz=precursor_mz,
            seed=seed, storage_dtype=storage_dtype, redundancy=redundancy,
            centroids=centroids, n_iter=n_iter,
        )

    @classmethod
    @torch.no_grad()
    def build_sharded_streaming(
        cls,
        mesh: Mesh,
        get_rows,  # (M,) int64 row ids on the mesh's first device -> (M, d)
        n: int,
        d: int,
        config,  # num_list, num_probe[, ivf_redundancy, soar_lambda]
        precursor_mz=None,
        seed: int = 42,
        storage_dtype: torch.dtype = torch.bfloat16,
        redundancy: Optional[int] = None,
        centroids=None,
        n_iter: int = 25,
        group_bytes: int = 1 << 30,
        train_rows_cap: int = 1 << 21,
    ) -> "ShardedIvfIndex":
        """Build an index born sharded over the list axes without the
        (N, D) source block (the JAX `build_sharded_streaming`).

        1. train: spherical k-means on `IvfIndex.build_streaming`'s
           subsample, its rows split over the whole mesh
           (`_train_centroids_sharded`); skipped when `centroids` is
           given;
        2. assign: top-A choices (and SOAR second-round choices) per
           `_STREAM_BLOCK`-row block on the mesh's first device, in the
           single-device builds' matrix-product shapes;
        3. plan: the balanced capped placement (`plan_assignments_device`),
           so placement is byte-identical to `IvfIndex.build_streaming`
           and `IvfIndex.build` given the same centroids;
        4. pack and place, shard by shard: list groups of about
           `group_bytes` fetched through `get_rows` and stored
           (`_pack_group`), the finished block moved to its devices
           before the next shard packs.  Peak memory on the first device:
           one shard block and one group's rows besides the placed shards
           it holds.

        `get_rows` has `IvfIndex.build_streaming`'s contract: rows of
        arbitrary indices, -1 on empty slots (whose rows may hold
        anything), a pure function of the row index.  Stage seconds are
        kept in ``build_seconds``."""
        num_list, soar_lambda, r_eff, cap, n_choices = _build_settings(
            config, n, redundancy)
        lib_shards = n_list_shards(mesh)
        if num_list % lib_shards != 0:
            raise ValueError(
                f"num_list={num_list} must divide list shards={lib_shards}"
            )
        devices = set(mesh.devices.ravel())
        device = replica_devices(mesh)[0][0]
        seconds: Dict[str, float] = {}
        clock = [time.perf_counter()]

        def phase(name):
            for dev in devices:
                synchronize(dev)
            now = time.perf_counter()
            seconds[name] = seconds.get(name, 0.0) + now - clock[0]
            clock[0] = now
            logger.info("sharded streaming build: %s %.1fs", name,
                        seconds[name])

        if centroids is None:
            centroids = cls._train_centroids_sharded(
                mesh, get_rows, n, num_list, seed, n_iter,
                train_rows_cap=train_rows_cap,
            )
        centroids = torch.as_tensor(centroids).to(device=device,
                                                  dtype=torch.float32)
        phase("train")

        ch_parts, soar_parts = [], []
        for start in range(0, n, _STREAM_BLOCK):
            rows = get_rows(torch.arange(start, min(start + _STREAM_BLOCK, n),
                                         device=device))
            ch = assign_topk_blocked(rows, centroids, n_choices)
            ch_parts.append(ch)
            rc = soar_round_choices(rows, centroids, ch, r_eff, soar_lambda)
            if rc is not None:
                soar_parts.append(rc[0])
            del rows
        choices = torch.cat(ch_parts)
        del ch_parts
        round_choices = None
        if soar_parts:
            round_choices = [torch.cat(soar_parts)] + [None] * (r_eff - 2)
            del soar_parts
        phase("assign")
        ids_flat, spilled = plan_assignments_device(
            choices, num_list, cap, r_eff, round_choices=round_choices
        )
        del choices, round_choices
        logger.debug("Sharded IVF build: %d lists (cap %d, x%d), %d spilled",
                     num_list, cap, r_eff, spilled)
        prec = _pack_prec(precursor_mz, ids_flat, num_list, cap)
        ids = ids_flat.view(num_list, cap)
        phase("plan")

        lists_per_shard = num_list // lib_shards
        index = cls.__new__(cls)
        index._init_params(
            mesh, resolve_num_probe(int(config.num_probe), num_list), r_eff,
            lists_per_shard, cap, d, storage_dtype,
        )
        itemsize = torch.empty((), dtype=storage_dtype).element_size()
        group_lists = max(1, int(group_bytes // (cap * d * (4 + itemsize))))
        while lists_per_shard % group_lists:
            group_lists -= 1
        for s in range(lib_shards):
            lo = s * lists_per_shard
            shard_ids = ids[lo:lo + lists_per_shard]
            packed = torch.zeros((lists_per_shard, cap, d), dtype=storage_dtype,
                                 device=device)
            scales = torch.ones((lists_per_shard, cap), dtype=torch.float32,
                                device=device)
            for g0 in range(0, lists_per_shard, group_lists):
                idx = shard_ids[g0:g0 + group_lists].reshape(-1)
                _pack_group(packed, scales, get_rows(idx.to(torch.int64)),
                            idx >= 0, g0)
            phase("pack")
            # Every shard's arrays are its own (the id and precursor
            # tables are cut out of the global ones).
            index._place_shard(s, _Block(
                packed, shard_ids.clone(),
                prec[lo:lo + lists_per_shard].clone(), scales), copy=False)
            del packed, scales
            phase("place")
        index._place_centroids(centroids, copy=False)
        phase("place")
        index.build_seconds = seconds
        return index

    @staticmethod
    @torch.no_grad()
    def _train_centroids_sharded(
        mesh: Mesh, get_rows, n: int, num_list: int, seed: int,
        n_iter: int, train_rows_cap: int = 1 << 21,
    ) -> torch.Tensor:
        """Spherical k-means with the training rows split over the whole
        mesh: `IvfIndex.build_streaming`'s subsample (`train_subsample`),
        `np.random.RandomState(seed)` initial rows
        (normalized on the host), then `n_iter` sharded updates (local
        cluster sums added in shard order).  Returns the centroids on the
        mesh's first device."""
        device = replica_devices(mesh)[0][0]
        train = train_subsample(get_rows, n, num_list, seed, train_rows_cap,
                                device)
        n_rows = train.shape[0]
        rng_init = np.random.RandomState(seed)
        init_rows = rng_init.choice(n_rows, size=min(num_list, n_rows),
                                    replace=False)
        init = train[torch.as_tensor(init_rows, device=device)].cpu().numpy()
        if len(init) < num_list:
            reps = -(-num_list // len(init))
            init = np.tile(init, (reps, 1))[:num_list]
            init = init + rng_init.normal(0, 1e-4, init.shape).astype(
                np.float32)
        init = init / np.maximum(
            np.linalg.norm(init, axis=1, keepdims=True), 1e-30)
        # Zero rows pad to the mesh size (zero rows carry weight 0).
        n_pad = -(-n_rows // mesh.size) * mesh.size
        parts = _split_rows(mesh, F.pad(train, (0, 0, 0, n_pad - n_rows)))
        del train
        centroids = torch.as_tensor(init.astype(np.float32), device=device)
        for _ in range(n_iter):
            centroids = _kmeans_update(parts, centroids)
        return centroids

    # ------------------------------------------------------------------ #
    # Search

    def search(self, queries, k: int, num_probe: int = 0, q_prec=None,
               charge: float = 1.0, tol_val: float = 0.0,
               tol_mode: str = "Da") -> np.ndarray:
        ids, _ = self.search_with_scores(queries, k, num_probe, q_prec,
                                         charge, tol_val, tol_mode)
        return ids

    def search_with_scores(self, queries, k: int, num_probe: int = 0,
                           q_prec=None, charge: float = 1.0,
                           tol_val: float = 0.0, tol_mode: str = "Da"):
        ids, scores = self.search_device(queries, k, num_probe, q_prec,
                                         charge, tol_val, tol_mode)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def search_device(self, queries, k: int, num_probe: Optional[int] = 0,
                      q_prec=None, charge: float = 1.0, tol_val: float = 0.0,
                      tol_mode: str = "Da"):
        """Top-k ids ((B, k) int32, -1 padded) and scores ((B, k) float32)
        per query, in query order, on dp replica 0's first device.

        The batch splits over the dp replicas in contiguous parts
        (zero-padded to equal size); each replica's shards scan, merge and
        repair probe-width overflow (`_search`)."""
        return self._search(range(self.dp), queries, k, num_probe, q_prec,
                            charge, tol_val, tol_mode)

    def replica(self, d: int) -> "_Replica":
        """Replica `d` alone, with `search_device`: the engine runs each dp
        replica's part of a batch on its own devices."""
        return _Replica(self, d)

    @torch.no_grad()
    def _search(self, replicas, queries, k: int, num_probe, q_prec,
                charge: float, tol_val: float, tol_mode: str):
        """`search_device` over the dp replicas `replicas`, in super-tiles
        whose probe-regime score block fits `_PROBE_BLOCK_BYTES` per
        device (`_CHUNK_TQ` queries in the chunked regime)."""
        replicas = list(replicas)
        num_probe = int(num_probe or self.num_probe)
        home = self.replica_device(replicas[0])
        queries = torch.as_tensor(queries).to(device=home,
                                              dtype=torch.float32)
        b = queries.shape[0]
        if b == 0:
            return (torch.zeros((0, k), dtype=torch.int32, device=home),
                    torch.zeros((0, k), dtype=torch.float32, device=home))
        if q_prec is None:
            q_prec = torch.zeros(b, device=home)
            tol_val = 0.0
        q_prec = torch.as_tensor(q_prec).to(device=home, dtype=torch.float32)
        dp = len(replicas)
        k_scan = self.redundancy * k
        b_l = -(-b // dp)
        regime, w, _ = self._regime_params(b_l, num_probe, k_scan)
        if regime == "probe":
            tq_l = min(_ivf._CHUNK_TQ, max(
                1, _ivf._PROBE_BLOCK_BYTES // (w * self.cap * 4)))
        elif regime == "chunked":
            tq_l = min(b_l, _ivf._CHUNK_TQ)
        else:
            tq_l = b_l
        tq = tq_l * dp
        self._last_overflow = 0
        out_i, out_s = [], []
        for start in range(0, b, tq):
            ids, scores = self._search_tile(
                replicas, queries[start:start + tq], q_prec[start:start + tq],
                k, num_probe, k_scan, charge, tol_val, tol_mode,
            )
            out_i.append(ids)
            out_s.append(scores)
        if len(out_i) == 1:
            return out_i[0], out_s[0]
        return torch.cat(out_i), torch.cat(out_s)

    def _search_tile(self, replicas, qt, qpt, k: int, num_probe: int,
                     k_scan: int, charge: float, tol_val: float,
                     tol_mode: str):
        """One super-tile: contiguous zero-padded parts over the replicas,
        each scanned by its shards and merged, with the probe-width
        overflow repair (the flagged queries of a replica run again
        through the exact chunked regime; one flag download a replica)."""
        n = qt.shape[0]
        dp = len(replicas)
        b_l = -(-n // dp)
        if b_l * dp != n:
            qt = F.pad(qt, (0, 0, 0, b_l * dp - n))
            qpt = F.pad(qpt, (0, b_l * dp - n))
        regime, w, chunk_lists = self._regime_params(b_l, num_probe, k_scan)
        home = self.replica_device(replicas[0])
        out_i, out_s = [], []
        for j, d in enumerate(replicas):
            q = qt[j * b_l:(j + 1) * b_l]
            qp = qpt[j * b_l:(j + 1) * b_l]
            ids, scores, overflow = self._scan(
                d, q, qp, k, num_probe, k_scan, charge, tol_val, tol_mode,
                regime, w, chunk_lists,
            )
            if overflow is not None:
                real = max(0, min(b_l, n - j * b_l))  # padding is no query
                rows = torch.nonzero(overflow[:real].cpu()).flatten()
                self._last_overflow += len(rows)
                if len(rows):
                    logger.debug("Sharded probe-width overflow for %d/%d "
                                 "queries; chunked rerun", len(rows), real)
                    rows = rows.to(ids.device)
                    p = min(num_probe, self.lists_per_shard)
                    r_ids, r_scores, _ = self._scan(
                        d, q[rows], qp[rows], k, num_probe, k_scan, charge,
                        tol_val, tol_mode, "chunked", 0,
                        self._chunk_lists(p, k_scan, len(rows)),
                    )
                    ids[rows] = r_ids
                    scores[rows] = r_scores
            out_i.append(ids.to(home))
            out_s.append(scores.to(home))
        return torch.cat(out_i)[:n], torch.cat(out_s)[:n]

    def _scan(self, d: int, queries, q_prec, k: int, num_probe: int,
              k_scan: int, charge: float, tol_val: float, tol_mode: str,
              regime: str, w: int, chunk_lists: int):
        """Replica `d`'s shard-local scans of (B, D) queries and the merge
        on its first device.  Returns (ids (B, k) int32, scores (B, k),
        overflow (B,) bool or None when no query can overflow)."""
        devices = self._devices[d]
        l_l = self.lists_per_shard
        b = queries.shape[0]
        cast = self.storage_dtype != torch.float32
        # Redundant storage: a row's copies may sit in several shards, so
        # R * k entries go through the selections before the dedup.
        k_scan = max(k_scan, k)
        k_local = min(k_scan, l_l * self.cap)
        p = min(num_probe, l_l)
        can_overflow = regime == "probe" and w < p
        parts_s, parts_i, flags = [], [], []
        for s, device in enumerate(devices):
            block = self._blocks[(s, device)]
            centroids = self._centroids[device]
            with on_device(device):
                q = queries.to(device).contiguous()
                qp = q_prec.to(device).contiguous()
                if regime == "probe" and self.n_list_shards == 1:
                    # One list shard: the coarse top-k IS the compaction.
                    loc = _probe_lists(q, centroids, p)
                    top_s, top_i = _local_scan_probe(
                        q, qp, loc, block, k_local, charge, tol_val,
                        tol_mode)
                else:
                    probed = _local_probe_mask(q, centroids, num_probe, l_l,
                                               s)
                    if regime == "probe":
                        iota = torch.arange(l_l, device=device)
                        loc = torch.sort(torch.where(probed, iota, l_l),
                                         dim=1).values[:, :w].contiguous()
                        if can_overflow:
                            flags.append(probed.sum(1) > w)
                        top_s, top_i = _local_scan_probe(
                            q, qp, loc, block, k_local, charge, tol_val,
                            tol_mode)
                    elif regime == "chunked":
                        top_s, top_i = _local_scan_chunked(
                            q, qp, probed, block, k_local, charge, tol_val,
                            tol_mode, chunk_lists)
                    else:
                        top_s, top_i = _local_scan_fullscan(
                            q, qp, probed, block, self._scan_block(s, device),
                            k_local, charge, tol_val, tol_mode)
            parts_s.append(top_s)
            parts_i.append(top_i)
        # The merge: shard-major lanes are in global position order, so the
        # canonical selection's tie-break is the single-device one.
        home = devices[0]
        merged_s = all_gather(parts_s, home).transpose(0, 1).reshape(b, -1)
        merged_i = all_gather(parts_i, home).transpose(0, 1).reshape(b, -1)
        top_s, pos = _select(merged_s, min(k_scan, merged_s.shape[1]), cast)
        top_i = torch.where(top_s > float("-inf"), merged_i.gather(1, pos), -1)
        if k_scan > k or top_s.shape[1] > k:
            top_s, top_i = _dedup_topk(top_s, top_i, k)
        top_s, top_i = _pad_topk(top_s, top_i, k)
        overflow = None
        if can_overflow:
            # A query is flagged when ANY shard truncated its probes.
            overflow = all_gather(flags, home).any(0)
        return top_i.to(torch.int32), top_s, overflow


class _Replica:
    """One dp replica of a `ShardedIvfIndex` (`ShardedIvfIndex.replica`):
    `search_device` runs the whole batch on that replica's shards and
    returns on its first device."""

    def __init__(self, index: ShardedIvfIndex, d: int):
        self._index = index
        self._d = d

    @property
    def device(self) -> torch.device:
        return self._index.replica_device(self._d)

    def search_device(self, queries, k: int, num_probe: Optional[int] = 0,
                      q_prec=None, charge: float = 1.0, tol_val: float = 0.0,
                      tol_mode: str = "Da"):
        return self._index._search([self._d], queries, k, num_probe, q_prec,
                                   charge, tol_val, tol_mode)


def multislice_ivf_search(mesh: Mesh, index, queries, k: int,
                          num_probe: int = 0, q_prec=None,
                          charge: float = 1.0, tol_val: float = 0.0,
                          tol_mode: str = "Da"):
    """Search an `IvfIndex` sharded over a ('dcn', 'dp', 'lib') mesh
    (callers should hold a `ShardedIvfIndex` to keep the blocks placed)."""
    return ShardedIvfIndex(mesh, index).search_with_scores(
        queries, k, num_probe, q_prec, charge, tol_val, tol_mode)


def sharded_ivf_search(mesh: Mesh, index, queries, k: int,
                       num_probe: int = 0, q_prec=None, charge: float = 1.0,
                       tol_val: float = 0.0, tol_mode: str = "Da"):
    """Search an `IvfIndex` with its lists sharded over the mesh; returns
    NumPy ((B, k) ids, (B, k) scores).  num_list must divide the list
    shards (callers should hold a `ShardedIvfIndex` to keep the blocks
    placed)."""
    return ShardedIvfIndex(mesh, index).search_with_scores(
        queries, k, num_probe, q_prec, charge, tol_val, tol_mode)
