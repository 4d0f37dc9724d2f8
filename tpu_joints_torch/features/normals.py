"""Surface normals + curvature (counterpart of
``tpu_joints/features/normals.py``): covariance of each point's neighbours,
smallest eigenvector oriented toward the viewpoint, curvature
λ0/(λ0+λ1+λ2). Three supports:

* ``estimate_normals`` — the k nearest valid neighbours (the bank build,
  ``pipelines.detect.detect``, the clustered OBB): one launch of kernel K2
  for 2 <= k <= 32;
* ``estimate_normals_anchored`` — kNN normals at an evenly strided anchor
  subsample (K2), each point taking its nearest anchor's (K1);
* ``estimate_normals_radius`` — the ``k_max`` nearest inside a radius (the
  FPFH chain's), on the sort path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.features.eigen3 import smallest_eigenvector
from tpu_joints_torch.neighbors.bruteforce import knn, radius_neighbors


def _normals_from_neighborhoods(xyz, idx, nvalid, mask, viewpoint,
                                query_xyz=None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, K] neighbour indices into ``xyz`` → (normals [M, 3], curvature
    [M]), oriented from ``query_xyz`` (default ``xyz``: self-neighbourhoods)."""
    if query_xyz is None:
        query_xyz = xyz
    nbr = xyz[idx.long()]
    w = nvalid.to(xyz.dtype)
    cnt = torch.clamp_min(w.sum(1), 1.0)
    mean = (nbr * w[..., None]).sum(1) / cnt[:, None]
    d = (nbr - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", d, d) / cnt[:, None, None]
    normal, vals = smallest_eigenvector(cov)
    flip = (normal * (viewpoint[None, :] - query_xyz)).sum(-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    total = torch.clamp_min(vals[..., 0] + vals[..., 1] + vals[..., 2], 1e-12)
    curvature = torch.clamp_min(vals[..., 2], 0.0) / total
    ok = mask & (nvalid.sum(1) >= 3)
    return (torch.where(ok[:, None], normal, 0.0),
            torch.where(ok, curvature, 0.0))


def _viewpoint(viewpoint, cloud: Cloud) -> torch.Tensor:
    if viewpoint is None:
        return torch.zeros(3, dtype=torch.float32, device=cloud.xyz.device)
    return viewpoint


def estimate_normals(cloud: Cloud, k: int = 40,
                     viewpoint: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN-support normals: (normals float32[N, 3], curvature float32[N])."""
    viewpoint = _viewpoint(viewpoint, cloud)
    d, idx = knn(cloud.xyz, cloud.xyz, k, source_mask=cloud.mask)
    nvalid = (d < 1e30) & cloud.mask[:, None]
    return _normals_from_neighborhoods(cloud.xyz, idx, nvalid, cloud.mask,
                                       viewpoint)


def anchor_lanes(n: int, anchors: int, device="cpu") -> torch.Tensor:
    """int64[anchors] on ``device``: the anchor lanes of the JAX package,
    ``jnp.linspace(0, n - 1, anchors).astype(int32)``. ``linspace``
    computes ``start·(1 − s) + stop·s`` with ``s = i / (anchors − 1)`` in
    float32 and sets the last entry to ``stop``; XLA's CPU compiler folds
    that to ``i · ((n − 1) · (1 / (anchors − 1)))``, each step rounded to
    float32, and truncates. Rounded otherwise, a few lanes move by one (a
    step at x.99998 instead of x + 1). Made on the device, one float32
    product per lane, so that no host array is uploaded."""
    i = torch.arange(anchors, dtype=torch.float32, device=device)
    if anchors == 1:
        return i.long()
    step = np.float32(n - 1) * (np.float32(1.0) / np.float32(anchors - 1))
    return torch.where(i == anchors - 1, float(n - 1), i * float(step)).long()


def estimate_normals_anchored(cloud: Cloud, k: int = 16, anchors: int = 8192,
                              viewpoint: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normals from an anchor subsample: exact k-NN normals at ``anchors``
    evenly strided lanes (kernel K2 for 2 <= k <= 32), each point taking
    its nearest valid anchor's normal and curvature (kernel K1).
    ``anchors >= capacity`` is ``estimate_normals`` exactly."""
    viewpoint = _viewpoint(viewpoint, cloud)
    N = cloud.capacity
    if anchors >= N:
        return estimate_normals(cloud, k=k, viewpoint=viewpoint)
    a_idx = anchor_lanes(N, anchors, cloud.xyz.device)
    a_xyz = cloud.xyz[a_idx]
    a_mask = cloud.mask[a_idx]
    d, idx = knn(a_xyz, cloud.xyz, k, source_mask=cloud.mask)
    a_normals, a_curv = _normals_from_neighborhoods(
        cloud.xyz, idx, (d < 1e30) & a_mask[:, None], a_mask, viewpoint,
        query_xyz=a_xyz)
    d1, nearest = knn(cloud.xyz, a_xyz, 1, source_mask=a_mask)
    nearest = nearest[:, 0].long()
    ok = cloud.mask & (d1[:, 0] < 1e30)
    return (torch.where(ok[:, None], a_normals[nearest], 0.0),
            torch.where(ok, a_curv[nearest], 0.0))


def estimate_normals_radius(cloud: Cloud, radius: float, k_max: int = 64,
                            viewpoint: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radius-support normals: the ``k_max`` nearest valid neighbours inside
    ``radius`` (the FPFH chain's, ``FPFH_demo.cpp:405-428``)."""
    viewpoint = _viewpoint(viewpoint, cloud)
    idx, valid, _ = radius_neighbors(cloud.xyz, cloud.xyz, radius, k_max,
                                     source_mask=cloud.mask)
    return _normals_from_neighborhoods(cloud.xyz, idx,
                                       valid & cloud.mask[:, None],
                                       cloud.mask, viewpoint)
