"""Sample-consensus plane / cylinder segmentation (counterpart of
``tpu_joints/segment/sac.py``).

Replaces PCL's ``SACSegmentationFromNormals``: every hypothesis is drawn at
once, scored against every point as one [N, H] masked reduction, and the
best one wins — no loop over iterations, no host read.

The draw is the reference's: ``seed`` names the key (``PRNGKey(seed)``),
``core.prng`` reproduces its uniforms and the weighted ``choice`` over the
valid lanes, so both packages test the same hypotheses on the same cloud.
``torch.acos`` and the reference's ``arccos`` differ by units in the last
place, so a lane whose metric sits on the threshold may flip.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_joints_torch.core import prng
from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.ops import take
from tpu_joints_torch.features.eigen3 import cross, norm


class SACResult(NamedTuple):
    """coefficients: plane [4] (n, d) with n·p + d = 0, or cylinder [7]
    (axis point, axis direction, radius) — PCL's coefficient layouts;
    inliers: bool[N]; score: int32 inlier count."""

    coefficients: torch.Tensor
    inliers: torch.Tensor
    score: torch.Tensor


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(norm(v, keepdim=True), 1e-12)


def _draw(cloud: Cloud, seed: int, shape) -> torch.Tensor:
    """Sample indices with probability proportional to the mask."""
    p = cloud.mask.to(torch.float32)
    p = p / torch.clamp_min(p.sum(), 1.0)
    return prng.choice(prng.uniform_on(seed, shape, cloud.xyz.device), p)


def _inliers(dist, cosang, w: float, distance_threshold: float):
    """PCL's weighted sum of euclidean and angular distance, under the
    threshold; the constants rounded to float32 as the reference holds
    them."""
    w = np.float32(w)
    thr = float(np.float32(distance_threshold))
    ang = torch.acos(torch.clamp(cosang, -1.0, 1.0))
    metric = float(np.float32(1.0) - w) * dist + float(w) * ang * thr
    return metric < thr


def sac_plane(cloud: Cloud, normals: torch.Tensor, seed: int = 0,
              n_hypotheses: int = 256, distance_threshold: float = 0.03,
              normal_distance_weight: float = 0.1) -> SACResult:
    """RANSAC plane with normal agreement (PCL SACMODEL_NORMAL_PLANE): a
    point is an inlier when (1-w)·|point-plane distance| + w·(angular
    deviation · threshold) stays under the distance threshold."""
    idx = _draw(cloud, seed, (n_hypotheses, 3))
    a, b, c = (cloud.xyz[idx[:, i]] for i in range(3))
    perp = cross(b - a, c - a)
    n = _normalize(perp)                                   # [H, 3]
    d = -(n * a).sum(-1)                                   # [H]
    degenerate = norm(perp) < 1e-12

    dist = (cloud.xyz @ n.T + d[None, :]).abs()            # [N, H]
    cosang = (normals @ n.T).abs()
    ok = _inliers(dist, cosang, normal_distance_weight,
                  distance_threshold) & cloud.mask[:, None]
    scores = ok.sum(0, dtype=torch.int32)
    scores = torch.where(degenerate, -1, scores)
    best = torch.argmax(scores)                            # first maximum
    coeff = torch.cat([take(n, best), take(d, best)[None]])
    return SACResult(coefficients=coeff, inliers=take(ok.T, best),
                     score=take(scores, best))


def dominant_plane(cloud: Cloud, normals: torch.Tensor,
                   distance_threshold: float,
                   min_fraction: float) -> torch.Tensor:
    """bool[N]: the inliers of the best of 256 plane hypotheses of key 0
    (the same scene gives the same crop) when they are at least
    ``min_fraction`` of the valid points, else none. The decision stays on
    the device."""
    plane = sac_plane(cloud, normals, seed=0, n_hypotheses=256,
                      distance_threshold=distance_threshold)
    n_valid = cloud.mask.sum(dtype=torch.int32)
    dominant = plane.score >= min_fraction * n_valid.to(torch.float32)
    return plane.inliers & dominant


def sac_cylinder(cloud: Cloud, normals: torch.Tensor, seed: int = 0,
                 n_hypotheses: int = 1024, distance_threshold: float = 0.05,
                 normal_distance_weight: float = 0.1,
                 radius_max: float = 0.1) -> SACResult:
    """RANSAC cylinder from two (point, normal) samples (PCL
    SACMODEL_CYLINDER): the axis is ⊥ both surface normals; the axis point
    and radius come from the closest approach of the two normal lines.
    Every hypothesis is scored in one [H, N] pass."""
    idx = _draw(cloud, seed, (n_hypotheses, 2))
    p1, p2 = cloud.xyz[idx[:, 0]], cloud.xyz[idx[:, 1]]
    n1, n2 = normals[idx[:, 0]], normals[idx[:, 1]]

    axis = cross(n1, n2)
    degenerate = norm(axis) < 1e-6
    axis = _normalize(torch.where(
        degenerate[:, None], axis.new_tensor([0.0, 0.0, 1.0]), axis))

    # closest points of lines (p1 - t·n1) and (p2 - s·n2)
    dp = p2 - p1
    a11 = (n1 * n1).sum(-1)
    a12 = -(n1 * n2).sum(-1)
    a22 = (n2 * n2).sum(-1)
    b1 = -(dp * n1).sum(-1)
    b2 = (dp * n2).sum(-1)
    det = a11 * a22 - a12 * a12
    det_safe = torch.where(det.abs() < 1e-12, 1.0, det)
    t = (b1 * a22 - b2 * a12) / det_safe
    s = (a11 * b2 - a12 * b1) / det_safe
    center = 0.5 * ((p1 - t[:, None] * n1) + (p2 - s[:, None] * n2))
    r1 = norm(cross(p1 - center, axis))
    r2 = norm(cross(p2 - center, axis))
    radius = 0.5 * (r1 + r2)
    degenerate = degenerate | (radius > radius_max) | (radius < 1e-6)

    def inlier_mask(cen, ax, rad):
        """cen/ax [..., 1, 3], rad [..., 1] against the [N] cloud."""
        rel = cloud.xyz - cen
        radial = rel - (rel * ax).sum(-1, keepdim=True) * ax
        dist_axis = norm(radial)
        dist = (dist_axis - rad).abs()
        radial_dir = radial / torch.clamp_min(dist_axis, 1e-12)[..., None]
        cosang = (normals * radial_dir).sum(-1).abs()
        return _inliers(dist, cosang, normal_distance_weight,
                        distance_threshold) & cloud.mask

    scores = inlier_mask(center[:, None], axis[:, None],
                         radius[:, None]).sum(1, dtype=torch.int32)
    scores = torch.where(degenerate, -1, scores)
    best = torch.argmax(scores)                            # first maximum
    cen, ax, rad = take(center, best), take(axis, best), take(radius, best)
    return SACResult(coefficients=torch.cat([cen, ax, rad[None]]),
                     inliers=inlier_mask(cen[None], ax[None], rad[None]),
                     score=take(scores, best))
