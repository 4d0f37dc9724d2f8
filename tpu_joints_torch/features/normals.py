"""kNN surface normals + curvature (counterpart of
``tpu_joints/features/normals.py::estimate_normals``): covariance of each
point's k nearest valid neighbours, smallest eigenvector oriented toward the
viewpoint, curvature λ0/(λ0+λ1+λ2). Used by the bank build, the scene side
of ``pipelines.detect.detect`` and the clustered OBB; the neighbour search
(2 <= k <= 32) is one launch of kernel K2."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.features.eigen3 import smallest_eigenvector
from tpu_joints_torch.neighbors.bruteforce import knn


def _normals_from_neighborhoods(xyz, idx, nvalid, mask, viewpoint
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, K] neighbour indices into ``xyz`` → (normals [N, 3], curvature [N])."""
    nbr = xyz[idx.long()]
    w = nvalid.to(xyz.dtype)
    cnt = torch.clamp_min(w.sum(1), 1.0)
    mean = (nbr * w[..., None]).sum(1) / cnt[:, None]
    d = (nbr - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", d, d) / cnt[:, None, None]
    normal, vals = smallest_eigenvector(cov)
    flip = (normal * (viewpoint[None, :] - xyz)).sum(-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    total = torch.clamp_min(vals[..., 0] + vals[..., 1] + vals[..., 2], 1e-12)
    curvature = torch.clamp_min(vals[..., 2], 0.0) / total
    ok = mask & (nvalid.sum(1) >= 3)
    return (torch.where(ok[:, None], normal, 0.0),
            torch.where(ok, curvature, 0.0))


def estimate_normals(cloud: Cloud, k: int = 40,
                     viewpoint: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN-support normals: (normals float32[N, 3], curvature float32[N])."""
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=torch.float32, device=cloud.xyz.device)
    d, idx = knn(cloud.xyz, cloud.xyz, k, source_mask=cloud.mask)
    nvalid = (d < 1e30) & cloud.mask[:, None]
    return _normals_from_neighborhoods(cloud.xyz, idx, nvalid, cloud.mask,
                                       viewpoint)
