"""Plain PyTorch version of the probe-gather IVF scan (kernel B2).

The counterpart of `ann_solo_tpu/ops/ivf_probe_pallas.py`: for each
query and each of its probed lists (ids sorted ascending), the scores of
every slot, bf16(q) . storage accumulated in float32 times the slot's
dequantization scale, with invalid and out-of-window slots at -inf.  The
(B, P * cap) result is in (probe rank, slot) lane order, the canonical
tie-break order every search regime shares; no selection happens here.

The CUDA kernel that replaces the TPU kernel is `csrc/ivf_probe_scan.cu`
(wrapper `ops/ivf_probe_cuda.py`); this module is what it is tested
against and what CPU tensors run, and it builds the kernel's list-major
index of the probe table (`list_probe_entries`).  Of the JAX package's support rules only
two are about the computation and are kept here; the rest sized TPU
memories (scalar-prefetch and VMEM budgets, power-of-two batches, D and
cap multiples of 128) and have no counterpart.
"""

from __future__ import annotations

import torch

# Lanes per query: the (B, P * cap) f32 score block stays <= 16 MB a query
# (`ivf_probe_pallas.py:98`).
MAX_PROBE_LANES = 1 << 22
# Bytes of gathered rows (storage plus their float32 copy) per plain step.
_PLAIN_GATHER_BYTES = 1 << 30


def probe_scan_supported(l: int, cap: int, num_probe: int,
                         dtype: torch.dtype) -> bool:
    """Whether the probe-gather path covers this index.

    float32 storage keeps exact float32 scores (the per-query oracle); the
    bf16 scan and 16-bit keys of this path would change them."""
    if dtype == torch.float32:
        return False
    p = min(num_probe, l)
    return cap > 0 and 1 <= p and p * cap <= MAX_PROBE_LANES


def window_mask(qp, prec, charge: float, tol_val: float, tol_mode: str):
    """Fused precursor-window mask, qp broadcast against prec.

    Da: |qp - prec| * charge <= tol; ppm: |qp - prec| / max(prec, 1e-6)
    * 1e6 <= tol, dividing by a tensor (an IEEE quotient on every
    device)."""
    if tol_mode == "Da":
        return (qp - prec).abs() * charge <= tol_val
    return (qp - prec).abs() / prec.clamp_min(1e-6) * 1e6 <= tol_val


def list_probe_entries(probe_ids, l: int):
    """The (B, P) probe table inverted into each list's entries.

    Returns ``(entries, starts, counts)``: ``entries`` (B * P,) int32 holds
    every entry e = b * P + p once, grouped by list id and ascending within
    a list; list j's are ``entries[starts[j]:starts[j + 1]]``, ``counts[j]``
    of them.  Ids outside [0, L) form a last group, list L, so ``starts``
    is (L + 2,) and ``counts`` (L + 1,), both int32.  One stable sort and
    a search on the device: no host synchronisation."""
    flat = probe_ids.reshape(-1).to(torch.int64)
    key = torch.where((flat >= 0) & (flat < l), flat, l)
    key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        key, torch.arange(l + 2, dtype=torch.int64, device=key.device))
    return (order.to(torch.int32), starts.to(torch.int32),
            starts.diff().to(torch.int32))


@torch.no_grad()
def ivf_probe_scan_plain(
    padded_vectors,  # (L, cap, D) int8 | bfloat16
    padded_ids,  # (L, cap) int32, -1 = empty slot
    padded_prec,  # (L, cap) float32
    padded_scales,  # (L, cap) float32
    queries,  # (B, D) float32
    q_prec,  # (B,) float32
    charge: float,
    probe_ids,  # (B, P) probed list ids, ascending per row
    tol_val: float,
    tol_mode: str,
):
    """(B, P * cap) float32 masked scores, lane p * cap + s for slot s of
    the query's p-th probed list; -inf where the slot is empty, (with
    tol_val > 0) outside the precursor window, or of a probe id outside
    [0, L)."""
    l, cap, d = padded_vectors.shape
    b, p = probe_ids.shape
    q = queries.to(torch.bfloat16).to(torch.float32)
    per_query = p * cap * d * (padded_vectors.element_size() + 4)
    group = max(1, _PLAIN_GATHER_BYTES // per_query)
    out = torch.empty((b, p * cap), dtype=torch.float32,
                      device=queries.device)
    for start in range(0, b, group):
        probes = probe_ids[start:start + group].to(torch.int64)
        g = probes.shape[0]
        listed = ((probes >= 0) & (probes < l)).repeat_interleave(cap, 1)
        probes = probes.clamp(0, l - 1)
        # Exact bf16 x storage products (int8 and bf16 values are exact
        # in float32), accumulated in float32 with TF32 off.
        rows = padded_vectors[probes].to(torch.float32).view(g, p * cap, d)
        scores = torch.bmm(rows, q[start:start + g, :, None])[..., 0]
        scores = scores * padded_scales[probes].view(g, p * cap)
        mask = (padded_ids[probes].view(g, p * cap) >= 0) & listed
        if tol_val > 0:
            mask &= window_mask(
                q_prec[start:start + g, None],
                padded_prec[probes].view(g, p * cap), charge, tol_val,
                tol_mode,
            )
        out[start:start + g] = torch.where(mask, scores, float("-inf"))
    return out
