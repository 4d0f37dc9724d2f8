"""SHOT-352 descriptor, "smooth" scheme (counterpart of
``tpu_joints/features/shot.py``).

32 spatial sectors (2 radial × 2 elevation × 8 azimuth, in the keypoint's
LRF) × 11 bins of cos(neighbour normal, LRF z), quadrilinearly interpolated
as one outer-product contraction of four per-neighbour soft-assignment
matrices; the 352-vector is L2-normalised. (The reference's "pcl" scheme is
not on the main path and not ported.)
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.features.eigen3 import norm
from tpu_joints_torch.features.lrf import shot_lrf
from tpu_joints_torch.neighbors.bruteforce import radius_neighbors

N_AZIMUTH = 8
N_ELEVATION = 2
N_RADIAL = 2
N_SHAPE_BINS = 10
N_SLOTS = N_SHAPE_BINS + 1
SHOT_DIM = N_RADIAL * N_ELEVATION * N_AZIMUTH * N_SLOTS  # 352


def _tent(coord: torch.Tensor, n_bins: int, offset: float) -> torch.Tensor:
    """Linear-interpolation weights 1 − |coord − centre| (≥ 0) for bin
    centres at b + offset."""
    centers = torch.arange(n_bins, dtype=coord.dtype, device=coord.device)
    return torch.clamp_min(1.0 - (coord[..., None] - (centers + offset)).abs(),
                           0.0)


def _interp_clamped(coord: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bin centres at b + 0.5, coordinate clamped to [0.5, n_bins - 0.5]."""
    return _tent(torch.clamp(coord, 0.5, n_bins - 0.5), n_bins, 0.5)


def _interp_wrapped(coord: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Periodic bins (azimuth wedges wrap around)."""
    centers = torch.arange(n_bins, dtype=coord.dtype, device=coord.device)
    delta = (coord[..., None] - (centers + 0.5)).abs()
    delta = torch.minimum(delta, n_bins - delta)
    return torch.clamp_min(1.0 - delta, 0.0)


def _interp_integer(coord: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Integer-centred bins 0..n_bins-1 (the cosine axis)."""
    return _tent(coord, n_bins, 0.0)


def shot_histograms_smooth(key_xyz, rf, nbr_xyz, nbr_normals, nbr_valid,
                           radius: float) -> torch.Tensor:
    """Raw (unnormalised) [M, 352] SHOT histograms, smooth scheme."""
    rel = nbr_xyz - key_xyz[:, None, :]
    local = torch.einsum("mij,mkj->mki", rf, rel)
    d = norm(rel)
    valid = nbr_valid & (d > 1e-9) & (d <= radius)

    cos = torch.clamp(torch.einsum("mkj,mj->mk", nbr_normals, rf[:, 2, :]),
                      -1.0, 1.0)
    s_coord = (1.0 + cos) * N_SHAPE_BINS / 2.0
    az = torch.atan2(local[..., 1], local[..., 0])
    a_coord = (az + math.pi) / (2.0 * math.pi) * N_AZIMUTH
    incl = torch.acos(torch.clamp(local[..., 2] / torch.clamp_min(d, 1e-12),
                                  -1.0, 1.0))
    e_coord = incl / (math.pi / 2.0)
    r_coord = d / radius * N_RADIAL

    w = valid.to(torch.float32)
    Ws = _interp_integer(s_coord, N_SLOTS) * w[..., None]
    Wa = _interp_wrapped(a_coord, N_AZIMUTH)
    We = _interp_clamped(e_coord, N_ELEVATION)
    Wr = _interp_clamped(r_coord, N_RADIAL)
    hist = torch.einsum("mkr,mke,mka,mks->mreas", Wr, We, Wa, Ws)
    return hist.reshape(key_xyz.shape[0], SHOT_DIM)


def compute_shot(
    keypoints: Cloud,
    surface: Cloud,
    surface_normals: torch.Tensor,
    radius: float,
    k_max: int = 128,
    neighbors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SHOT for keypoints over a search surface: (desc float32[M, 352]
    L2-normalised, rf float32[M, 3, 3], valid bool[M]). ``neighbors``
    optionally carries a precomputed ``(idx, within)`` radius gather at the
    same radius and k_max."""
    if neighbors is None:
        idx, within, _ = radius_neighbors(keypoints.xyz, surface.xyz, radius,
                                          k_max, source_mask=surface.mask)
    else:
        idx, within = neighbors
    idx = idx.long()
    nbr_valid = within & keypoints.mask[:, None]
    nbr_xyz = surface.xyz[idx]
    nbr_normals = surface_normals[idx]
    rf, rf_ok = shot_lrf(keypoints.xyz, nbr_xyz, nbr_valid, radius)
    hist = shot_histograms_smooth(keypoints.xyz, rf, nbr_xyz, nbr_normals,
                                  nbr_valid, radius)
    n = norm(hist, keepdim=True)
    desc = hist / torch.clamp_min(n, 1e-12)
    valid = keypoints.mask & rf_ok & (n[:, 0] > 1e-12)
    return torch.where(valid[:, None], desc, 0.0), rf, valid
