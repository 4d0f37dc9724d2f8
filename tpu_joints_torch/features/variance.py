"""Multi-scale normal-variance descriptor (counterpart of
``tpu_joints/features/variance.py``).

The reference's custom descriptor (``SHOT_VAR.cpp:335-483``): for each
keypoint, at three radii r·(u+1) for u ∈ {0, 1, 2}, gather the radius
neighbourhood, take θ_i = the angle between the keypoint normal and each
neighbour normal, and store the variance of θ over the neighbourhood. A
keypoint with an empty neighbourhood at a scale stores -1 there
(``SHOT_VAR.cpp:447-456``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.neighbors.bruteforce import radius_neighbors

N_SCALES = 3


def compute_variance_descriptor(
    keypoints: Cloud,
    keypoint_normals: torch.Tensor,
    surface: Cloud,
    surface_normals: torch.Tensor,
    radius: float,
    k_max: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (desc float32[M, 3] of θ-variances, valid bool[M])."""
    descs = []
    for u in range(N_SCALES):
        idx, within, _ = radius_neighbors(
            keypoints.xyz, surface.xyz, radius * (u + 1), k_max,
            source_mask=surface.mask)
        valid = within & keypoints.mask[:, None]
        cos = torch.einsum("mkj,mj->mk", surface_normals[idx.long()],
                           keypoint_normals)
        theta = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        w = valid.to(torch.float32)
        cnt = w.sum(1)
        safe = torch.clamp_min(cnt, 1.0)
        mean = (theta * w).sum(1) / safe
        var = ((theta - mean[:, None]) ** 2 * w).sum(1) / safe
        descs.append(torch.where(cnt > 0, var, -1.0))
    return torch.stack(descs, -1), keypoints.mask
