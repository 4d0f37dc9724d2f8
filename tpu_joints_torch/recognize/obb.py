"""PCA oriented bounding box + folded Euler angles (counterpart of
``tpu_joints/recognize/obb.py``): the box of a whole cloud, or of its
largest smooth cluster (k=30 normals and region growing, both on kernel
K2)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.transforms import (
    fold_euler_90, masked_centroid, masked_covariance, masked_minmax,
    quaternion_to_euler, rotation_from_matrix_to_quaternion)
from tpu_joints_torch.features.eigen3 import cross, eigh3x3


class OBB(NamedTuple):
    """position: box centre; rotation [3, 3] (columns = box axes); extents:
    full side lengths; euler: folded roll/pitch/yaw; centroid: cloud mean."""

    position: torch.Tensor
    rotation: torch.Tensor
    extents: torch.Tensor
    euler: torch.Tensor
    centroid: torch.Tensor


def oriented_bounding_box(cloud: Cloud) -> OBB:
    """The PCA box of a cloud, or of each cloud of a batch ([B, N, 3]: every
    field gains a leading B)."""
    centroid = masked_centroid(cloud.xyz, cloud.mask)
    cov = masked_covariance(cloud.xyz, cloud.mask, centroid)
    _, vecs = eigh3x3(cov)
    e0, e1 = vecs[..., :, 0], vecs[..., :, 1]
    R = torch.stack([e0, e1, cross(e0, e1)], dim=-1)
    local = (cloud.xyz - centroid[..., None, :]) @ R
    lo, hi = masked_minmax(local, cloud.mask)
    position = (R @ (0.5 * (lo + hi))[..., None])[..., 0] + centroid
    euler = fold_euler_90(quaternion_to_euler(rotation_from_matrix_to_quaternion(R)))
    return OBB(position=position, rotation=R, extents=hi - lo, euler=euler,
               centroid=centroid)


def oriented_bounding_box_clustered(cloud: Cloud, k: int = 30,
                                    smoothness_deg: float = 5.0,
                                    curvature_threshold: float = 5.0,
                                    min_cluster_size: int = 50) -> OBB:
    """OBB of the largest smooth cluster of ``cloud``, the reference's
    pre-step: re-estimate k=30 normals on the aligned model, region-grow,
    box the dominant cluster only (the first largest, by label). Falls back
    to the whole cloud when no cluster reaches ``min_cluster_size``."""
    from tpu_joints_torch.features.normals import estimate_normals
    from tpu_joints_torch.segment.region_growing import region_growing

    normals, curvature = estimate_normals(cloud, k=k)
    clusters = region_growing(cloud, normals, curvature, k=k,
                              smoothness_deg=smoothness_deg,
                              curvature_threshold=curvature_threshold,
                              min_cluster_size=min_cluster_size)
    best_label = torch.argmax(clusters.sizes)      # first maximum
    in_best = clusters.labels == best_label.to(torch.int32)
    has_cluster = (in_best & cloud.mask).any()
    keep = torch.where(has_cluster, in_best & cloud.mask, cloud.mask)
    return oriented_bounding_box(cloud.with_mask(keep))
