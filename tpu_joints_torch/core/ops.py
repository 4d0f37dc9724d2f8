"""Small tensor helpers that pin down orders the JAX reference relies on.

* ``top_k``: the reference's ``lax.top_k`` order — descending, ties to the
  lower index (a stable sort; ``torch.topk`` promises no tie order on CUDA).
* ``take``: row ``i`` of ``x`` for a 0-dim index tensor without a host sync.
* ``segment_sum``: per-segment sums over sorted segment ids, each segment
  summed in lane order (no float atomics, so the result is deterministic on
  CUDA and on the CPU equal to the sequential scatter-add XLA runs).
* ``scatter_add``: ``zeros(size).at[index].add(values)`` built on
  ``segment_sum``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along the last axis."""
    if k == 1:
        v, i = x.max(dim=-1, keepdim=True)       # first index of the maximum
        return v, i
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def fused_sumsq(v: torch.Tensor) -> torch.Tensor:
    """Σ v_i² over a last axis of 3 as the chained fused multiply-add
    fma(z, z, fma(y, y, x·x)) — each step's product and sum formed in
    float64 and rounded once to float32, which is how XLA's CPU backend
    reduces a squared 3-vector. Where two candidates tie in exact
    arithmetic (a voxel of two points is equidistant from its centroid),
    the rounding decides the winner, so the order is pinned here."""
    v64 = v.double()
    acc = (v[..., 0] * v[..., 0]).double()
    acc = (v64[..., 1] * v64[..., 1] + acc).to(torch.float32).double()
    return (v64[..., 2] * v64[..., 2] + acc).to(torch.float32)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` along axis 0 for a 0-dim integer tensor ``i``."""
    return x.index_select(0, i.reshape(1).long())[0]


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sums of ``values`` [N] or [N, C] over non-decreasing segment ids
    ``seg`` [N] in [0, num_segments); empty segments sum to 0."""
    lengths = torch.zeros(num_segments, dtype=torch.int64, device=seg.device)
    lengths.scatter_add_(0, seg.long(), torch.ones_like(seg, dtype=torch.int64))
    if values.ndim == 1:
        return torch.segment_reduce(values, "sum", lengths=lengths,
                                    unsafe=True)
    cols = [torch.segment_reduce(values[:, c].contiguous(), "sum",
                                 lengths=lengths, unsafe=True)
            for c in range(values.shape[1])]
    return torch.stack(cols, dim=1)


def scatter_add(index: torch.Tensor, values: torch.Tensor,
                size: int) -> torch.Tensor:
    """``zeros(size).at[index].add(values)``, deterministically, each slot
    summed in the order of ``index``'s lanes."""
    order = torch.argsort(index, stable=True)
    si = index[order]
    boundary = torch.ones_like(si, dtype=torch.bool)
    boundary[1:] = si[1:] != si[:-1]
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    n = index.shape[0]
    sums = segment_sum(values[order], seg, n)
    # slot of each segment; unused segments point at the dump slot ``size``
    slot = torch.full((n,), size, dtype=torch.int64, device=index.device)
    slot.scatter_(0, seg, si.long())
    out = torch.zeros(size + 1, dtype=values.dtype, device=values.device)
    out.scatter_(0, slot, sums)
    return out[:size]
