"""Voxel-hash fixed-radius neighbour search (counterpart of
``tpu_joints/neighbors/grid.py``).

Points are bucketed by a spatial hash of their cell (cell edge = radius),
sorted once, and each query gathers candidates only from the 27 cells that
can hold a neighbour within ``radius``: fixed-width windows of
``bucket_cap`` lanes per bucket, one top-k over the 27·L candidates.

The cell hash is the JAX package's int32 arithmetic written out: the three
products and their xor are taken in int64 and wrapped to int32 explicitly,
``abs`` keeps INT32_MIN negative as int32 ``abs`` does, and the bucket is
the floor remainder (non-negative), as ``jnp``'s ``%`` gives it.

Approximation contract (as the JAX package's): a bucket holding more than
``bucket_cap`` points contributes only its first ``bucket_cap``; distinct
cells may share a bucket (hash collision), and colliding foreign points are
culled by the radius test but occupy candidate slots. With an adequate cap
the result equals the dense search.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu_joints_torch.core.ops import fused_sumsq, top_k

INF = 3.0e38

# large odd primes for the 3-D cell hash (standard spatial-hash constants)
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_INT32_MIN = -(1 << 31)


class VoxelGrid(NamedTuple):
    """Sorted spatial-hash index over a fixed-capacity point set."""

    xyz: torch.Tensor        # [N, 3] points in bucket-sorted order
    order: torch.Tensor      # int32[N] sorted position → original index
    hashes: torch.Tensor     # int32[N] bucket id per sorted point (T = invalid)
    cell_size: float         # float32 value
    table_size: int


def _cell(xyz: torch.Tensor, cell_size: float) -> torch.Tensor:
    """int64 cell coordinates floor(xyz / cell_size), the cast as int32's.
    The divisor is a float32 tensor on ``xyz``'s device: CUDA turns a
    division by a host scalar into a product with its reciprocal, which
    rounds differently."""
    cs = torch.tensor(cell_size, dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz / cs).to(torch.int32).to(torch.int64)


def _cell_hash(cell: torch.Tensor, table_size: int) -> torch.Tensor:
    """Bucket of int64 cells [..., 3] under int32 wrap-around arithmetic."""
    h = (cell[..., 0] * _P1) ^ (cell[..., 1] * _P2) ^ (cell[..., 2] * _P3)
    h = ((h + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)      # wrap to int32
    h = torch.where(h == _INT32_MIN, h, h.abs())
    return torch.remainder(h, table_size)


def build_grid(xyz: torch.Tensor, mask: Optional[torch.Tensor] = None,
               cell_size: float = 0.05, table_size: int = 0) -> VoxelGrid:
    """One stable sort builds the whole index (rebuild per cloud)."""
    N = xyz.shape[0]
    if table_size == 0:
        table_size = 4 * N
    if mask is None:
        mask = torch.ones(N, dtype=torch.bool, device=xyz.device)
    h = _cell_hash(_cell(xyz, cell_size), table_size)
    h = torch.where(mask, h, table_size)       # invalid points sort to the end
    order = torch.argsort(h, stable=True)
    return VoxelGrid(xyz=xyz[order], order=order.to(torch.int32),
                     hashes=h[order].to(torch.int32),
                     cell_size=float(np.float32(cell_size)),
                     table_size=int(table_size))


_OFFSETS = torch.tensor([[dx, dy, dz] for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dz in (-1, 0, 1)])  # [27, 3]


def max_cell_occupancy(grid: VoxelGrid) -> torch.Tensor:
    """Largest number of points sharing one hash bucket (collision chains
    included): the least ``bucket_cap`` that drops no neighbour."""
    h = grid.hashes.long()
    valid = h < grid.table_size
    counts = torch.bincount(torch.where(valid, h, 0),
                            minlength=grid.table_size)
    counts[0] -= (~valid).sum()            # the invalid lanes counted at 0
    return counts.max().to(torch.int32)


def grid_radius_neighbors(grid: VoxelGrid, query: torch.Tensor, radius: float,
                          k_max: int, bucket_cap: int = 32,
                          query_chunk: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-radius search through the grid (radius must be <= cell_size).

    Returns (idx int32[M, k_max] — ORIGINAL point indices, valid bool,
    dist_sq f32), the contract of ``bruteforce.radius_neighbors``: the
    nearest k_max within the radius, ties to the lower candidate slot.
    ``query_chunk`` > 0 runs the queries in blocks of that many rows (the
    [rows, 27·bucket_cap, 3] candidate window is the peak buffer); each
    row's result does not depend on the blocking.
    """
    M = query.shape[0]
    if query_chunk and M > query_chunk:
        parts = [grid_radius_neighbors(grid, query[r:r + query_chunk], radius,
                                       k_max, bucket_cap=bucket_cap)
                 for r in range(0, M, query_chunk)]
        return tuple(torch.cat(p) for p in zip(*parts))
    dev = query.device
    cells = _cell(query, grid.cell_size)[:, None, :] + _OFFSETS.to(dev)[None]
    h = _cell_hash(cells, grid.table_size)                        # [M, 27]

    # distinct neighbour cells may share a bucket (hash collision); their
    # windows are then identical, and duplicates would crowd real
    # neighbours out of the top-k: keep each bucket's first offset only
    ar = torch.arange(27, device=dev)
    dup = (h[:, :, None] == h[:, None, :]) & (ar[:, None] > ar[None, :])
    first = ~dup.any(2)                                           # [M, 27]

    hashes = grid.hashes.long()
    start = torch.searchsorted(hashes, h.contiguous(), side="left")
    lanes = torch.arange(bucket_cap, device=dev)
    widx = torch.clamp(start[..., None] + lanes, 0, hashes.shape[0] - 1)
    same = (hashes[widx] == h[..., None]) & first[..., None]      # [M, 27, L]

    cand = widx.reshape(M, -1)                                    # [M, 27L]
    ok = same.reshape(M, -1)
    d = fused_sumsq(grid.xyz[cand] - query[:, None, :])
    r2 = float(np.float32(radius) * np.float32(radius))
    d = torch.where(ok & (d <= r2), d, INF)

    k = min(k_max, cand.shape[1])
    neg, arg = top_k(-d, k)
    dist_sq = -neg
    idx = grid.order[cand.gather(1, arg)]
    valid = dist_sq <= r2
    if k < k_max:                         # pad out to the requested width
        pad = k_max - k
        idx = torch.cat([idx, idx.new_zeros((M, pad))], 1)
        valid = torch.cat([valid, valid.new_zeros((M, pad))], 1)
        dist_sq = torch.cat([dist_sq, dist_sq.new_full((M, pad), INF)], 1)
    return idx, valid, dist_sq
