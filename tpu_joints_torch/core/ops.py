"""Small tensor helpers that pin down orders the JAX reference relies on.

* ``top_k``: the reference's ``lax.top_k`` order — descending, ties to the
  lower index (``torch.topk`` over keys that never tie; it promises no tie
  order of its own on CUDA).
* ``take``: row ``i`` of ``x`` for a 0-dim index tensor without a host sync.
* ``segment_sum``: per-segment sums over sorted segment ids, each segment
  summed in lane order (no float atomics, so the result is deterministic on
  CUDA and on the CPU equal to the sequential scatter-add XLA runs).
* ``scatter_add``: ``zeros(size).at[index].add(values)`` built on
  ``segment_sum``.
* ``tree_map``: a function over the tensor leaves of a result (NamedTuples,
  tuples, lists, dicts).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def top_k(x: torch.Tensor, k: int, largest: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest (or smallest) entries along the
    last axis of a float32 ``x``, in order, ties to the lower index:
    ``lax.top_k(x, k)`` (or ``lax.top_k(-x, k)``). Each entry is keyed by
    its float bits, mapped to an order-preserving integer (-0 folded into
    +0), above its position (complemented for ``largest``), so no two keys
    tie and ``torch.topk``'s order is exact."""
    if x.dtype != torch.float32:
        raise TypeError(f"top_k takes float32, got {x.dtype}")
    if k > x.shape[-1]:
        raise ValueError(f"k={k} exceeds the {x.shape[-1]} candidates")
    if k == 1:                                   # first index of the extreme
        return (x.max(dim=-1, keepdim=True) if largest
                else x.min(dim=-1, keepdim=True))
    bits = (x + 0.0).contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) << 32
    pos = torch.arange(x.shape[-1], device=x.device)
    _, i = torch.topk(key | (0xFFFFFFFF - pos if largest else pos), k,
                      dim=-1, largest=largest)
    return x.gather(-1, i), i


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


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of float32[N], added in the order XLA's CPU
    backend adds ``jnp.cumsum``: the lanes padded to rows of 16, a
    sequential sum inside each row, the same scan over the rows' totals,
    and each row offset by the total of the rows before it. A sequential
    float32 sum rounds differently, and an index drawn by ``searchsorted``
    over the sum moves with it; the 16 steps are explicit elementwise adds,
    so every device adds in this order."""
    n = x.shape[0]
    rows = torch.nn.functional.pad(x, (0, -n % 16)).reshape(-1, 16)
    cols = [rows[:, 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + rows[:, j])
    within = torch.stack(cols, dim=1)
    if within.shape[0] > 1:
        before = xla_cumsum(within[:, 15])[:-1]
        within = torch.cat([within[:1], within[1:] + before[:, None]])
    return within.reshape(-1)[:n]


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
    """``zeros(size).at[index].add(values)`` for values [N] or [N, C],
    deterministically, each slot summed in the order of ``index``'s
    lanes."""
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
    out = values.new_zeros((size + 1,) + values.shape[1:])
    if values.ndim == 1:
        out.scatter_(0, slot, sums)
    else:
        out.index_copy_(0, slot, sums)
    return out[:size]


def tree_map(fn, tree):
    """``fn`` on every tensor or array leaf of NamedTuples, tuples, lists
    and dicts; other leaves pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree
