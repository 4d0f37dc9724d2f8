"""Region growing on a coarse 3-D voxel lattice (counterpart of
``tpu_joints/segment/voxel.py``), the bounded-cost crop for unorganized
clouds: no kNN graph.

The crop volume is voxelised at ``leaf`` on a static [G, G, G] grid from the
masked minimum corner; each voxel's mean normal and mean curvature come
from in-order segment sums (``core.ops.scatter_add``). A directed edge u→v
joins occupied 26-adjacent voxels when u may seed (mean curvature below the
threshold) and the mean normals agree within the smoothness angle scaled to
the step's length (``smoothness · leaf·|d| / pitch``, at most 89°: PCL's
bound is an angle per point step). Min-label sweeps with two pointer jumps
label the components; labels go back to the points through their voxel,
then become the smallest member point index (the ``Clusters`` contract, -1
invalid, outside the grid or undersized; sizes are point counts).

Sweep schedule: as the other two region growings (``SWEEPS_PER_CHECK``
sweeps per host read of the last sweep's change flag, never beyond
``max_sweeps``, a chunk that ends at ``max_sweeps`` unchecked;
``region_growing_voxel.host_checks`` counts the reads). A sweep past the
fixed point changes nothing, so the labels equal the reference's, whose
loop stops at the first sweep that changes nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.ops import scatter_add
from tpu_joints_torch.features.eigen3 import norm
from tpu_joints_torch.segment.region_growing import Clusters

SWEEPS_PER_CHECK = 8

# 26-neighbourhood offsets, in the reference's order
_DIRS3 = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0))


def _shift3d(a: torch.Tensor, d, fill) -> torch.Tensor:
    """out[x, y, z] = a[x + dx, y + dy, z + dz] over the first three axes
    (edges → fill)."""
    G = a.shape[:3]
    out = torch.full_like(a, fill)
    dst = tuple(slice(max(-s, 0), n - max(s, 0)) for s, n in zip(d, G))
    src = tuple(slice(max(s, 0), n + min(s, 0)) for s, n in zip(d, G))
    out[dst] = a[src]
    return out


def _sweep(labels, edge_in, occ, G3: int):
    """One min-label sweep over the 26 directions plus two pointer jumps;
    returns (new labels, whether any changed as a bool tensor)."""
    g = labels.shape[0]
    padded = torch.nn.functional.pad(labels, (1, 1, 1, 1, 1, 1), value=G3)
    nb = torch.stack([padded[1 + dx:g + 1 + dx, 1 + dy:g + 1 + dy,
                             1 + dz:g + 1 + dz] for dx, dy, dz in _DIRS3])
    new = torch.minimum(labels, torch.where(edge_in, nb, G3).amin(0))
    # labels are voxel indices, so chasing new[new] splices directed paths
    f = new.reshape(G3)
    for _ in range(2):
        f = torch.minimum(f, f[torch.clamp_max(f, G3 - 1)])
    new = torch.where(occ, f.reshape(g, g, g), G3)
    return new, (new != labels).any()


def region_growing_voxel(cloud: Cloud, normals: torch.Tensor,
                         curvature: torch.Tensor, leaf: float = 0.04,
                         grid: int = 64, smoothness_deg: float = 7.0,
                         curvature_threshold: float = 7.0,
                         min_cluster_size: int = 50, max_sweeps: int = 32,
                         pitch: float = 0.005) -> Clusters:
    """Point-space Clusters of ``cloud`` from the voxel-lattice growth
    (module docstring); arguments as the reference's."""
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    N = xyz.shape[0]
    G3 = grid ** 3

    mn = torch.where(mask[:, None], xyz, 3e38).amin(0)
    # divide by a device tensor: CUDA multiplies by the reciprocal of a
    # host scalar, which can move a point into the next voxel
    leaf_t = torch.full((), leaf, dtype=xyz.dtype, device=dev)
    ci = torch.floor((xyz - mn[None, :]) / leaf_t).to(torch.int64)
    in_grid = mask & ((ci >= 0) & (ci < grid)).all(1)
    vid = (ci[:, 0] * grid + ci[:, 1]) * grid + ci[:, 2]
    vid = torch.where(in_grid, vid, G3)           # sentinel bucket for drops

    w = in_grid.to(torch.float32)
    cnt = scatter_add(vid, w, G3 + 1)[:G3]
    nsum = scatter_add(vid, normals * w[:, None], G3 + 1)[:G3]
    csum = scatter_add(vid, curvature * w, G3 + 1)[:G3]
    occ = (cnt > 0).reshape(grid, grid, grid)
    vnorm = (nsum / torch.clamp_min(norm(nsum, keepdim=True), 1e-12)
             ).reshape(grid, grid, grid, 3)
    vcurv = (csum / torch.clamp_min(cnt, 1.0)).reshape(grid, grid, grid)

    gates = []
    for d in _DIRS3:
        step = leaf * math.sqrt(sum(x * x for x in d))
        eff = min(math.radians(smoothness_deg) * step / pitch,
                  math.radians(89.0))
        # the float32 threshold, held as a Python float that compares alike
        cos_thresh = float(np.float32(math.cos(eff)))
        nb_nrm = _shift3d(vnorm, d, 0.0)
        nb_cur = _shift3d(vcurv, d, 3e38)
        nb_occ = _shift3d(occ, d, False)
        cos = (nb_nrm * vnorm).sum(-1).abs()
        gates.append(occ & nb_occ & (cos >= cos_thresh)
                     & (nb_cur < curvature_threshold))
    edge_in = torch.stack(gates)                  # [26, G, G, G]: d → voxel

    flat_idx = torch.arange(G3, device=dev).reshape(grid, grid, grid)
    vlab = torch.where(occ, flat_idx, G3)
    sweeps = 0
    while sweeps < max_sweeps:
        chunk = min(SWEEPS_PER_CHECK, max_sweeps - sweeps)
        for _ in range(chunk):
            vlab, changed = _sweep(vlab, edge_in, occ, G3)
        sweeps += chunk
        if sweeps >= max_sweeps:
            break
        region_growing_voxel.host_checks += 1
        if not bool(changed):
            break

    # voxel roots back to the points, each root renamed to its cluster's
    # smallest member point index
    proot = torch.where(in_grid, vlab.reshape(G3)[torch.clamp_max(vid, G3 - 1)],
                        G3)
    lane = torch.arange(N, device=dev)
    min_pt = torch.full((G3 + 1,), np.iinfo(np.int32).max, dtype=torch.int64,
                        device=dev).scatter_reduce(0, proot, lane, "amin")
    labels = torch.where(in_grid, min_pt[proot], -1)
    lab = torch.clamp(labels, 0, N - 1)
    sizes = torch.zeros(N, dtype=torch.int64, device=dev).scatter_add_(
        0, lab, (labels >= 0).to(torch.int64))
    big = sizes[lab] >= min_cluster_size
    labels = torch.where((labels >= 0) & big, labels, -1)
    return Clusters(labels=labels.to(torch.int32), sizes=sizes.to(torch.int32))


region_growing_voxel.host_checks = 0
