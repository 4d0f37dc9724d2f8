"""Exact, masked dense neighbour search (counterpart of
``tpu_joints/neighbors/bruteforce.py``).

3-D queries go to the kernels, as the JAX package sends them to its Pallas
kernel: k = 1 to K1 (``pallas_knn.nn1``), 2 <= k <= 32 to K2
(``pallas_knn.knnk``). Every other call (D != 3, such as descriptor
matching, or k > 32, such as the k_max support gathers) computes the
expansion form ``|q|² + |s|² − 2q·s`` clamped at 0, as the JAX path does on
the CPU, and keeps the ``k`` smallest by a stable sort. Either way ties go
to the lowest source index, the result is in ascending order, and slots
without a valid source carry (3e38, 0), the JAX path's padding. ``knn_batched`` is the same search with a leading
batch axis on every argument, entry b searching entry b's sources (what
``jax.vmap`` of the JAX function computes): k = 1 in 3-D is one launch of
K1's batch mode, 2 <= k <= 32 in 3-D ``knn`` per entry (K2 has no batch
mode), k > 32 or D != 3 the expansion form as one batched product.

``exclude_self=True`` (the query is a prefix-aligned view of the source;
source column i is never a neighbour of query row i, PCL's "nearest other
point") always takes the expansion form: the kernels have no
self-exclusion, and the JAX package sends such searches to XLA too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_joints_torch.core.ops import fused_sumsq
from tpu_joints_torch.neighbors.pallas_knn import (INF, MAX_K, knnk, nn1,
                                                   nn1_batched)


# query rows per distance block: bounds the [rows, N] matrix being sorted
_ROWS = 2048


def _drop_self(d: torch.Tensor, r: int) -> torch.Tensor:
    """Distances of query rows r, r+1, ... with source column == row at INF."""
    rows = torch.arange(r, r + d.shape[-2], device=d.device)
    cols = torch.arange(d.shape[-1], device=d.device)
    return torch.where(cols[None, :] == rows[:, None], INF, d)


def knn(query: torch.Tensor, source: torch.Tensor, k: int,
        source_mask: Optional[torch.Tensor] = None,
        exclude_self: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid source points per query row; ``exclude_self`` drops
    source i for query row i (see the module docstring).

    Returns (dist_sq float32[M, k], idx int32[M, k]).
    """
    M, D = query.shape
    N = source.shape[0]
    if k == 1 and D == 3 and not exclude_self:
        return nn1(query, source, source_mask)
    if 2 <= k <= MAX_K and D == 3 and not exclude_self:
        return knnk(query, source, k, source_mask)
    if source_mask is None:
        source_mask = torch.ones(N, dtype=torch.bool, device=source.device)
    # 3-D squared norms as chained FMAs, the way XLA reduces them: with the
    # expansion's cancellation this keeps distances (and so near-tie order
    # and the radius cut) equal to the reference's on the CPU
    sqn = fused_sumsq if D == 3 else (lambda v: (v * v).sum(-1))
    s2 = sqn(source)
    kk = min(k, N)
    ds, js = [], []
    for r in range(0, M, _ROWS):
        q = query[r:r + _ROWS]
        q2 = sqn(q)[:, None]
        d = q2 + s2[None, :] - 2.0 * (q @ source.T)
        d = torch.clamp_min(d, 0.0)
        d = torch.where(source_mask[None, :], d, INF)
        if exclude_self:
            d = _drop_self(d, r)
        v, i = torch.sort(d, dim=1, stable=True)
        ds.append(v[:, :kk])
        js.append(i[:, :kk])
    d = torch.cat(ds) if ds else query.new_zeros((0, kk))
    i = torch.cat(js) if js else query.new_zeros((0, kk), dtype=torch.int64)
    if kk < k:
        d = torch.cat([d, d.new_full((M, k - kk), INF)], 1)
        i = torch.cat([i, i.new_zeros((M, k - kk))], 1)
    i = torch.where(d < INF, i, torch.zeros_like(i))
    return d, i.to(torch.int32)


def knn_batched(query: torch.Tensor, source: torch.Tensor, k: int,
                source_mask: Optional[torch.Tensor] = None,
                exclude_self: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid sources of batch entry b per row of ``query[b]``:
    query [B, M, D], source [B, N, D], source_mask bool[B, N] → (dist_sq
    float32[B, M, k], idx int32[B, M, k], indices within the entry).

    3-D k = 1 goes to kernel K1's batch mode in one launch. A 3-D search
    with 2 <= k <= 32 is :func:`knn` per entry (kernel K2, which has no
    batch mode, once per entry), so it equals B ``knn`` calls. The rest
    (k > 32, or D != 3) is the expansion form of :func:`knn` over the batch,
    whose batched product may round the last bit differently from B
    separate products.
    """
    B, M, D = query.shape
    N = source.shape[1]
    if k == 1 and D == 3 and not exclude_self:
        return nn1_batched(query, source, source_mask)
    if 2 <= k <= MAX_K and D == 3 and not exclude_self:
        masks = [None] * B if source_mask is None else source_mask
        per = [knn(q, s, k, source_mask=m)
               for q, s, m in zip(query, source, masks)]
        return torch.stack([d for d, _ in per]), torch.stack([i for _, i in per])
    if source_mask is None:
        source_mask = torch.ones((B, N), dtype=torch.bool, device=source.device)
    sqn = fused_sumsq if D == 3 else (lambda v: (v * v).sum(-1))
    s2 = sqn(source)
    kk = min(k, N)
    ds, js = [], []
    for r in range(0, M, max(1, _ROWS // B)):
        q = query[:, r:r + max(1, _ROWS // B)]
        d = sqn(q)[:, :, None] + s2[:, None, :] \
            - 2.0 * torch.bmm(q, source.transpose(1, 2))
        d = torch.clamp_min(d, 0.0)
        d = torch.where(source_mask[:, None, :], d, INF)
        if exclude_self:
            d = _drop_self(d, r)
        v, i = torch.sort(d, dim=2, stable=True)
        ds.append(v[:, :, :kk])
        js.append(i[:, :, :kk])
    d = torch.cat(ds, 1) if ds else query.new_zeros((B, 0, kk))
    i = torch.cat(js, 1) if js else query.new_zeros((B, 0, kk), dtype=torch.int64)
    if kk < k:
        d = torch.cat([d, d.new_full((B, M, k - kk), INF)], 2)
        i = torch.cat([i, i.new_zeros((B, M, k - kk))], 2)
    i = torch.where(d < INF, i, torch.zeros_like(i))
    return d, i.to(torch.int32)


def radius_neighbors(query: torch.Tensor, source: torch.Tensor, radius: float,
                     k_max: int, source_mask: Optional[torch.Tensor] = None,
                     exclude_self: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``k_max`` nearest points inside ``radius``; with a leading
    batch axis on every argument, per batch entry. ``exclude_self`` as in
    :func:`knn`.

    Returns (idx int32[M, k_max], valid bool[M, k_max], dist_sq f32[M, k_max]).
    """
    search = knn_batched if query.ndim == 3 else knn
    d, i = search(query, source, k_max, source_mask=source_mask,
                  exclude_self=exclude_self)
    r = np.float32(radius)
    return i, d <= float(r * r), d


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense [M, N] squared distances in the expansion form, clamped at 0
    (small inputs only; counterpart of ``bruteforce.pairwise_sq_dist``)."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    return torch.clamp_min(a2 + b2.T - 2.0 * (a @ b.T), 0.0)
