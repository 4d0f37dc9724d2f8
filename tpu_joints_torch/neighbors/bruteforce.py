"""Exact, masked dense neighbour search (counterpart of
``tpu_joints/neighbors/bruteforce.py``).

``knn(k=1, D=3)`` goes to kernel K1 (``pallas_knn.nn1``). Every other call
(k > 1 or D != 3) computes the expansion form ``|q|² + |s|² − 2q·s``
clamped at 0, as the JAX path does on the CPU, and keeps the ``k`` smallest
by a stable sort: ties go to the lowest source index and the result is in
ascending order. Slots without a valid source carry (3e38, 0), the JAX
path's padding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_joints_torch.core.ops import fused_sumsq
from tpu_joints_torch.neighbors.pallas_knn import INF, nn1


# query rows per distance block: bounds the [rows, N] matrix being sorted
_ROWS = 2048


def knn(query: torch.Tensor, source: torch.Tensor, k: int,
        source_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid source points per query row.

    Returns (dist_sq float32[M, k], idx int32[M, k]).
    """
    M, D = query.shape
    N = source.shape[0]
    if k == 1 and D == 3:
        return nn1(query, source, source_mask)
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


def radius_neighbors(query: torch.Tensor, source: torch.Tensor, radius: float,
                     k_max: int, source_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``k_max`` nearest points inside ``radius``.

    Returns (idx int32[M, k_max], valid bool[M, k_max], dist_sq f32[M, k_max]).
    """
    d, i = knn(query, source, k_max, source_mask=source_mask)
    r = np.float32(radius)
    return i, d <= float(r * r), d
