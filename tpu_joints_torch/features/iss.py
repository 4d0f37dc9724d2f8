"""ISS 3D keypoints (counterpart of ``tpu_joints/features/iss.py``):
eigenvalue-ratio saliency of each point's radius-support scatter matrix,
then non-maximum suppression on the smallest eigenvalue. Both gathers keep
up to ``k_max`` neighbours other than the point itself, on the sort path
(``bruteforce.knn(exclude_self=True)``)."""
from __future__ import annotations

import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.features.eigen3 import eigvals3x3
from tpu_joints_torch.neighbors.bruteforce import radius_neighbors


def iss_keypoints(cloud: Cloud, salient_radius: float, non_max_radius: float,
                  gamma_21: float = 0.975, gamma_32: float = 0.975,
                  min_neighbors: int = 5, k_max: int = 64) -> torch.Tensor:
    """bool[N] keypoint mask (PCL ``ISSKeypoint3D``, γ21 = γ32 = 0.975 as
    in ``SHOT.cpp:336-344``)."""
    xyz, mask = cloud.xyz, cloud.mask
    idx, within, _ = radius_neighbors(xyz, xyz, salient_radius, k_max,
                                      source_mask=mask, exclude_self=True)
    idx = idx.long()
    w = (within & mask[:, None]).to(torch.float32)
    cnt = w.sum(1)
    rel = (xyz[idx] - xyz[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", rel, rel) / torch.clamp_min(
        cnt, 1.0)[:, None, None]
    vals = eigvals3x3(cov)                        # descending
    l1, l2, l3 = vals[..., 0], vals[..., 1], vals[..., 2]
    salient = ((l2 / torch.clamp_min(l1, 1e-12) < gamma_21)
               & (l3 / torch.clamp_min(l2, 1e-12) < gamma_32)
               & (l3 > 0) & (cnt >= min_neighbors) & mask)
    nidx, nwithin, _ = radius_neighbors(xyz, xyz, non_max_radius, k_max,
                                        source_mask=mask, exclude_self=True)
    nidx = nidx.long()
    nbr_l3 = torch.where(nwithin & mask[:, None] & salient[nidx], l3[nidx],
                         float("-inf"))
    return salient & (l3 >= nbr_l3.amax(1))
