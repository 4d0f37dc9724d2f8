"""Organized-cloud moments via box filters (counterpart of
``tpu_joints/features/organized.py``).

Per pixel, window sums of (count, x, y, z, xx, xy, xz, yy, yz, zz) over a
(2r+1)² window that shrinks to stay clear of valid-valid depth jumps; the
covariance's smallest eigenvector is the normal. Box sums are separable and
add the window's terms one by one in order, never through a summed-area
table (f32 SATs lose the mm²-scale covariance to cancellation).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_joints_torch.features.eigen3 import eigh3x3


def _window_sum(a: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Zero-padded (2r+1)-tap sum along ``dim`` (negative: counted from the
    last axis), accumulated in tap order."""
    L = a.shape[dim]
    pad = [0, 0] * (-1 - dim) + [r, r]
    p = F.pad(a, pad)
    out = p.narrow(dim, 0, L)
    for t in range(1, 2 * r + 1):
        out = out + p.narrow(dim, t, L)
    return out


def _box_sums(planes: torch.Tensor, r: int) -> torch.Tensor:
    """Separable (2r+1)² box sum of [..., H, W] planes, SAME zero padding."""
    if r == 0:
        return planes
    return _window_sum(_window_sum(planes, r, -2), r, -1)


def _max3x3(a: torch.Tensor) -> torch.Tensor:
    """3x3 SAME max over [..., H, W] planes (the window always holds its
    centre, so the pool's -inf border equals any smaller init value)."""
    H, W = a.shape[-2:]
    return F.max_pool2d(a.reshape(-1, 1, H, W), 3, stride=1,
                        padding=1).reshape(a.shape)


def _safe_radius(z: torch.Tensor, valid: torch.Tensor, r: int,
                 depth_change: float) -> torch.Tensor:
    """Per-pixel Chebyshev distance (−1, capped at r) to the nearest
    valid-valid depth change — PCL's smoothing-size map."""
    big = 3.0e38
    zmax = _max3x3(torch.where(valid, z, -big))
    zmin = -_max3x3(-torch.where(valid, z, big))
    change = (zmax - zmin) > depth_change
    dist = torch.where(change, 0, r + 1).to(torch.int32)
    reach = change.to(torch.float32)
    for s in range(1, r + 1):
        reach = _max3x3(reach)
        dist = torch.minimum(dist, torch.where(reach > 0.5, s, r + 1).to(torch.int32))
    return torch.clamp(dist - 1, 0, r)


def organized_moments(xyz_img: torch.Tensor, valid: torch.Tensor,
                      half_window: int, depth_change: float = 0.02
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(moments float32[10, H, W], r_px int32[H, W]) — per-pixel window sums
    of (count, x, y, z, xx, xy, xz, yy, yz, zz) over that pixel's
    edge-shrunken window, and the half-window it used. A batch of frames
    [B, H, W, 3] gives moments [10, B, H, W] and r_px [B, H, W]."""
    x = torch.where(valid, xyz_img[..., 0], 0.0).to(torch.float32)
    y = torch.where(valid, xyz_img[..., 1], 0.0).to(torch.float32)
    z = torch.where(valid, xyz_img[..., 2], 0.0).to(torch.float32)
    m = valid.to(torch.float32)
    chans = torch.stack([m, x, y, z, x * x, x * y, x * z, y * y, y * z, z * z])
    r_px = _safe_radius(z, valid, half_window, depth_change)
    out = chans  # r == 0: the pixel alone (flagged invalid downstream)
    for r in range(1, half_window + 1):
        out = torch.where((r_px == r)[None], _box_sums(chans, r), out)
    return out, r_px


def _cov_from_moments(S: torch.Tensor):
    """[10, ...] moment vectors → (cov [..., 3, 3], mean [..., 3], count).

    Each entry E[ab] − E[a]E[b] cancels metre-scale moments down to the
    mm²-scale covariance, so it is formed as a fused multiply-add: the
    product and difference in float64, rounded once to float32. That is
    what XLA's fused ``a − b·c`` computes in the reference, and it keeps
    the rounding of ``b·c`` out of the cancellation.
    """
    n = torch.clamp_min(S[0], 1.0)
    mx, my, mz = S[1] / n, S[2] / n, S[3] / n

    def fms(e, a, b):
        return (e.double() - a.double() * b.double()).to(torch.float32)

    cxx = fms(S[4] / n, mx, mx)
    cxy = fms(S[5] / n, mx, my)
    cxz = fms(S[6] / n, mx, mz)
    cyy = fms(S[7] / n, my, my)
    cyz = fms(S[8] / n, my, mz)
    czz = fms(S[9] / n, mz, mz)
    cov = torch.stack([torch.stack([cxx, cxy, cxz], -1),
                       torch.stack([cxy, cyy, cyz], -1),
                       torch.stack([cxz, cyz, czz], -1)], dim=-2)
    return cov, torch.stack([mx, my, mz], -1), S[0]


def estimate_normals_organized(xyz_img: torch.Tensor, valid: torch.Tensor,
                               half_window: int = 5,
                               viewpoint: Optional[torch.Tensor] = None,
                               depth_change: float = 0.02
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normals + curvature of an organized [H, W, 3] cloud from its
    edge-shrunken window moments: (normals float32[H, W, 3], curvature
    float32[H, W]), zero where a pixel's window collapsed on a depth edge
    or holds fewer than 5 points. Normals face ``viewpoint`` (default the
    sensor origin)."""
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=torch.float32, device=xyz_img.device)
    H, W, _ = xyz_img.shape
    S, r_px = organized_moments(xyz_img, valid, half_window, depth_change)
    cov, _, cnt = _cov_from_moments(S.reshape(10, H * W))
    vals, vecs = eigh3x3(cov)
    normal = vecs[:, :, 2].reshape(H, W, 3)       # smallest-eigenvalue axis
    lam = torch.clamp_min(vals, 0.0)
    tot = lam.sum(1)
    curvature = torch.where(tot > 1e-20, lam[:, 2] / torch.clamp_min(tot, 1e-20),
                            0.0).reshape(H, W)
    flip = (normal * (viewpoint - xyz_img)).sum(-1, keepdim=True) < 0
    normal = torch.where(flip, -normal, normal)
    ok = valid & (cnt.reshape(H, W) >= 5.0) & (r_px >= 1)
    return (torch.where(ok[..., None], normal, 0.0),
            torch.where(ok, curvature, 0.0))
