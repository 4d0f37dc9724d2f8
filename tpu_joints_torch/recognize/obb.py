"""PCA oriented bounding box + folded Euler angles (counterpart of
``tpu_joints/recognize/obb.py::oriented_bounding_box``)."""
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
    centroid = masked_centroid(cloud.xyz, cloud.mask)
    cov = masked_covariance(cloud.xyz, cloud.mask, centroid)
    _, vecs = eigh3x3(cov)
    e0, e1 = vecs[:, 0], vecs[:, 1]
    R = torch.stack([e0, e1, cross(e0, e1)], dim=1)
    local = (cloud.xyz - centroid) @ R
    lo, hi = masked_minmax(local, cloud.mask)
    position = R @ (0.5 * (lo + hi)) + centroid
    euler = fold_euler_90(quaternion_to_euler(rotation_from_matrix_to_quaternion(R)))
    return OBB(position=position, rotation=R, extents=hi - lo, euler=euler,
               centroid=centroid)
