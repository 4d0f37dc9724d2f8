"""Pass-through crop, voxel ids, voxel downsampling, uniform sampling and
compaction (counterpart of ``tpu_joints/filters/filters.py``).

Filtering updates masks; voxel aggregation is a stable sort by voxel id plus
in-order segment reductions (``core.ops.segment_sum``: no float atomics).
``compact_indices`` gathers selected lanes into a static capacity, thinning
an overflow uniformly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tpu_joints_torch.core.cloud import SENTINEL, Cloud
from tpu_joints_torch.core.ops import fused_sumsq, segment_sum

_GRID_BITS = 10
_GRID_MAX = (1 << _GRID_BITS) - 1
_INVALID_ID = 1 << 30

_AXES = {"x": 0, "y": 1, "z": 2}


def passthrough(cloud: Cloud, axis: str, lo: float, hi: float) -> Cloud:
    """Axis-aligned crop, PCL PassThrough (a mask update only)."""
    a = cloud.xyz[:, _AXES[axis]]
    return cloud.with_mask((a >= lo) & (a <= hi))


def voxel_ids(xyz: torch.Tensor, mask: torch.Tensor, leaf: float) -> torch.Tensor:
    """int32[N] voxel id per point; invalid points get a sentinel id.
    The grid origin is the masked minimum corner ([B, N] for a batch of
    clouds, each on its own grid)."""
    lo = torch.where(mask[..., None], xyz, SENTINEL).amin(-2, keepdim=True)
    # divide by a device tensor: CUDA turns division by a host scalar into a
    # reciprocal multiply, which can move a point across a voxel boundary
    leaf_t = torch.full((), leaf, dtype=xyz.dtype, device=xyz.device)
    ijk = torch.floor((xyz - lo) / leaf_t).to(torch.int32)
    ijk = torch.clamp(ijk, 0, _GRID_MAX)
    ids = ((ijk[..., 0] << (2 * _GRID_BITS)) | (ijk[..., 1] << _GRID_BITS)
           | ijk[..., 2])
    return torch.where(mask, ids, _INVALID_ID).to(torch.int32)


def _sorted_segments(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of ids; (order, segment index per sorted lane)."""
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    boundary = torch.ones_like(sid, dtype=torch.bool)
    boundary[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    return order, seg


def _segment_min(values: torch.Tensor, seg: torch.Tensor, n: int,
                 init) -> torch.Tensor:
    out = torch.full((n,), init, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg, values, "amin", include_self=True)


def voxel_downsample(cloud: Cloud, leaf: float) -> Cloud:
    """Voxel-grid downsample (PCL VoxelGrid): one centroid per occupied
    voxel, in voxel-id order in a prefix of the lanes; capacity unchanged,
    the rest masked padding."""
    N = cloud.capacity
    order, seg = _sorted_segments(voxel_ids(cloud.xyz, cloud.mask, leaf))
    w = cloud.mask[order].to(torch.float32)
    sums = segment_sum(cloud.xyz[order] * w[:, None], seg, N)
    rgb_sums = segment_sum(cloud.rgb[order] * w[:, None], seg, N)
    cnts = segment_sum(w, seg, N)
    valid = cnts > 0
    denom = torch.clamp_min(cnts, 1.0)[:, None]
    return Cloud(xyz=torch.where(valid[:, None], sums / denom, SENTINEL),
                 mask=valid,
                 rgb=torch.where(valid[:, None], rgb_sums / denom, 0.0))


def uniform_sample_mask(cloud: Cloud, radius: float) -> torch.Tensor:
    """bool[N]: per voxel of size ``radius``, the valid point nearest the
    voxel centroid (PCL UniformSampling); ties to the lowest sorted lane.
    A batch of clouds ([B, N, 3], [B, N]) is sampled in one pass, the voxel
    ids offset per cloud so that no segment spans two clouds."""
    shape = cloud.mask.shape
    ids = voxel_ids(cloud.xyz, cloud.mask, radius)
    if len(shape) == 2:
        ids = ids.long() + (torch.arange(shape[0], device=ids.device)
                            << 31)[:, None]
    ids = ids.reshape(-1)
    N = ids.shape[0]
    order, seg = _sorted_segments(ids)
    xyz_s = cloud.xyz.reshape(N, 3)[order]
    mask_s = cloud.mask.reshape(N)[order]
    w = mask_s.to(torch.float32)
    sums = segment_sum(xyz_s * w[:, None], seg, N)
    cnts = segment_sum(w, seg, N)
    centroid = sums / torch.clamp_min(cnts, 1.0)[:, None]
    d = fused_sumsq(xyz_s - centroid[seg])
    d = torch.where(mask_s, d, 3e38)
    dmin = _segment_min(d, seg, N, float("inf"))
    lane = torch.arange(N, dtype=torch.int64, device=ids.device)
    cand = torch.where(d <= dmin[seg], lane, N)
    winner_lane = _segment_min(cand, seg, N, N)
    is_winner = (lane == winner_lane[seg]) & mask_s
    keep = torch.zeros(N, dtype=torch.bool, device=ids.device)
    keep[order] = is_winner
    return keep.reshape(shape)


def compact_indices(mask: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order-preserving padded compaction to ``capacity`` lanes along the
    last axis: (idx int64[..., capacity], valid bool[..., capacity]). Over
    capacity, Bresenham thinning keeps exactly ``capacity`` evenly spaced
    selections instead of a prefix."""
    sel = mask.to(torch.int32)
    n = sel.sum(-1, keepdim=True)
    rank = torch.cumsum(sel, -1) - 1
    s = torch.full((), float(capacity), dtype=torch.float32,
                   device=mask.device) / torch.clamp_min(n, 1).to(torch.float32)
    r = rank.to(torch.float32)
    mask = mask & (torch.floor(r * s) > torch.floor((r - 1.0) * s))
    N = mask.shape[-1]
    lane = torch.arange(N, dtype=torch.int64, device=mask.device)
    rank2 = torch.cumsum(mask.to(torch.int64), -1) - 1
    target = torch.where(mask, rank2, capacity)
    # kept lanes have unique ranks; dropped ones all land in the dump slot
    idx = torch.zeros(mask.shape[:-1] + (capacity + 1,), dtype=torch.int64,
                      device=mask.device)
    idx = idx.scatter(-1, target, lane.expand_as(target))[..., :capacity]
    n_kept = torch.clamp_max(mask.sum(-1, keepdim=True), capacity)
    valid = torch.arange(capacity, device=mask.device) < n_kept
    return idx, valid


def gather_lanes(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Lanes ``idx`` [..., K] of ``t`` [..., N] or [..., N, C], per leading
    (batch) entry: ``t[idx]`` for one cloud."""
    if idx.ndim == 1:
        return t[idx]
    if t.ndim == idx.ndim:
        return torch.gather(t, -1, idx)
    return torch.gather(t, -2, idx[..., None].expand(*idx.shape, t.shape[-1]))


def compact_cloud(cloud: Cloud, select: torch.Tensor, capacity: int
                  ) -> Tuple[Cloud, torch.Tensor]:
    """Gather selected points into a smaller padded Cloud; also returns the
    original lane index of each output lane (per cloud of a batch)."""
    idx, valid = compact_indices(select & cloud.mask, capacity)
    xyz = torch.where(valid[..., None], gather_lanes(cloud.xyz, idx), SENTINEL)
    rgb = torch.where(valid[..., None], gather_lanes(cloud.rgb, idx), 0.0)
    return Cloud(xyz=xyz, mask=valid, rgb=rgb), idx
