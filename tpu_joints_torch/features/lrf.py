"""Local reference frames (counterpart of ``tpu_joints/features/lrf.py``).

``shot_lrf``: the SHOT frame — distance-weighted covariance eigenbasis with
majority-vote sign disambiguation. ``board_lrf``: the border-aware BOARD
frame — support-plane z, steepness-weighted margin-normal x with hole
detection over 24 angular sectors. Frames are float32[M, 3, 3] with rows =
(x, y, z) axes. All batched mask arithmetic over [M, K] supports.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from tpu_joints_torch.features.eigen3 import cross, eigh3x3, norm


def _disambiguate(axis: torch.Tensor, rel: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Flip ``axis`` [M, 3] toward the unweighted count majority of the
    support (``>= 0`` votes positive); the weighted projection sum breaks
    exact count ties."""
    dots = torch.einsum("mki,mi->mk", rel, axis)
    votes = nbr_mask(w)
    pos = ((dots >= 0) * votes).sum(1)
    neg = ((dots < 0) * votes).sum(1)
    ssum = (dots * w).sum(1)
    flip = torch.where(pos == neg, ssum < 0, neg > pos)
    return torch.where(flip[:, None], -axis, axis)


def nbr_mask(w: torch.Tensor) -> torch.Tensor:
    """1.0 where a support point is real (weight > 0), else 0."""
    return (w > 0).to(torch.float32)


def shot_lrf(key_xyz: torch.Tensor, nbr_xyz: torch.Tensor,
             nbr_valid: torch.Tensor, radius: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SHOT frames: (rf [M, 3, 3] rows x/y/z, ok bool[M])."""
    rel = nbr_xyz - key_xyz[:, None, :]
    d = norm(rel)
    w = torch.clamp_min(radius - d, 0.0) * nbr_valid.to(torch.float32)
    wsum = torch.clamp_min(w.sum(1), 1e-12)
    cov = torch.einsum("mki,mkj->mij", rel * w[..., None], rel) / wsum[:, None, None]
    _, vecs = eigh3x3(cov)
    x_axis = _disambiguate(vecs[..., :, 0], rel, w)
    z_axis = _disambiguate(vecs[..., :, 2], rel, w)
    rf = torch.stack([x_axis, cross(z_axis, x_axis), z_axis], dim=1)
    return rf, nbr_valid.sum(1) >= 5


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp_min(norm(v, keepdim=True), eps)


def board_lrf(
    key_xyz: torch.Tensor,
    key_normal: torch.Tensor,
    nbr_xyz: torch.Tensor,
    nbr_normal: torch.Tensor,
    nbr_valid: torch.Tensor,
    radius: float,
    margin: float = 0.85,
    n_sectors: int = 24,
    hole_prob: float = 0.2,
    steep_thresh: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BOARD frames (PCL defaults): (rf [M, 3, 3] rows x/y/z, ok bool[M]).

    The support gather must cover the whole radius (a radius search with
    ``k_max`` wide enough to populate the margin annulus).
    """
    M, K, _ = nbr_xyz.shape
    validf = nbr_valid.to(torch.float32)
    nvalid = validf.sum(1)
    rel = (nbr_xyz - key_xyz[:, None, :]) * validf[..., None]
    d = norm(rel)

    # z: support-plane fit, sign-aligned with the summed neighbour normals
    cnt = torch.clamp_min(nvalid, 1.0)
    mean = rel.sum(1) / cnt[:, None]
    cen = (rel - mean[:, None, :]) * validf[..., None]
    cov = torch.einsum("mki,mkj->mij", cen, cen)
    _, vecs = eigh3x3(cov)
    z_axis = vecs[..., :, 2]
    nsum = (nbr_normal * validf[..., None]).sum(1)
    nsum = torch.where(nvalid[:, None] > 0, nsum, key_normal)
    z_axis = torch.where((z_axis * nsum).sum(-1, keepdim=True) < 0,
                         -z_axis, z_axis)

    # deterministic in-plane basis (v, w): v = z × ez, or z × ex near ±ez
    zx, zy, zz = z_axis[:, 0], z_axis[:, 1], z_axis[:, 2]
    zero = torch.zeros_like(zx)
    v1 = torch.stack([zy, -zx, zero], -1)     # cross(z, (0, 0, 1))
    v2 = torch.stack([zero, zz, -zy], -1)     # cross(z, (1, 0, 0))
    v_axis = _normalize(torch.where(norm(v1, keepdim=True) > 1e-3, v1, v2))
    w_axis = cross(z_axis, v_axis)

    # margin annulus + steepness-weighted normal-direction vote
    on_margin = nbr_valid & (d > margin * radius)
    marginf = on_margin.to(torch.float32)
    has_margin = on_margin.any(1)
    ndotz = torch.einsum("mki,mi->mk", nbr_normal, z_axis)
    cosz = ndotz.abs()
    best_cos = torch.where(on_margin, cosz, 2.0).amin(1)
    best_sin = torch.sqrt(torch.clamp_min(
        1.0 - torch.clamp_max(best_cos, 1.0) ** 2, 0.0))
    n_in = nbr_normal - ndotz[..., None] * z_axis[:, None, :]
    mag = norm(n_in)
    u_m = n_in / torch.clamp_min(mag[..., None], 1e-9)
    w_m = mag * marginf
    C = torch.einsum("mk,mki,mkj->mij", w_m, u_m, u_m)
    cvals, cvecs = eigh3x3(C)
    x0 = cvecs[..., :, 0]
    sgn = torch.sign(torch.einsum("mki,mi->m", u_m * w_m[..., None], x0))
    x_steep = x0 * torch.where(sgn == 0, 1.0, sgn)[:, None]
    aniso = cvals[:, 0] / torch.clamp_min(cvals[:, 1], 1e-12)
    # no steep margin normal: direction of the farthest valid point
    w_total = w_m.sum(1)
    far = torch.argmax(torch.where(nbr_valid, d, -1.0), dim=1)
    far_rel = torch.gather(rel, 1, far[:, None, None].expand(M, 1, 3))[:, 0, :]
    far_in = far_rel - (far_rel * z_axis).sum(-1, keepdim=True) * z_axis
    far_norm = norm(far_in, keepdim=True)
    far_dir = torch.where(far_norm > 1e-8,
                          far_in / torch.clamp_min(far_norm, 1e-12), v_axis)
    x_steep = torch.where((w_total > 1e-6)[:, None], x_steep, far_dir)

    # hole detection: longest circular run of empty margin sectors
    phi = torch.atan2(torch.einsum("mki,mi->mk", rel, w_axis),
                      torch.einsum("mki,mi->mk", rel, v_axis))
    sector = torch.clamp(((phi + math.pi) * (n_sectors / (2.0 * math.pi)))
                         .to(torch.int32), 0, n_sectors - 1)
    bins = torch.arange(n_sectors, dtype=torch.int32, device=sector.device)
    occ = ((sector[..., None] == bins) & on_margin[..., None]).any(1)
    occ2 = torch.cat([occ, occ], dim=1)
    empty = (~occ2).to(torch.float32)
    run = torch.zeros(M, dtype=torch.float32, device=occ.device)
    best_len = torch.zeros_like(run)
    best_end = torch.zeros_like(run)
    for t in range(2 * n_sectors):
        run = (run + 1.0) * empty[:, t]
        take = run > best_len
        best_len = torch.where(take, run, best_len)
        best_end = torch.where(take, float(t), best_end)
    best_len = torch.clamp_max(best_len, float(n_sectors))
    hole = has_margin & (best_len >= hole_prob * n_sectors) & (best_len < n_sectors)
    center = ((best_end - (best_len - 1.0) * 0.5 + 0.5)
              * (2.0 * math.pi / n_sectors) - math.pi)
    x_hole = torch.cos(center)[:, None] * v_axis + torch.sin(center)[:, None] * w_axis

    use_hole = hole & (best_sin < steep_thresh)
    x_axis = _normalize(torch.where(use_hole[:, None], x_hole, x_steep))
    rf = torch.stack([x_axis, cross(z_axis, x_axis), z_axis], dim=1)
    ok = (nvalid >= 6) & (use_hole | (aniso >= 3.0))
    return rf, ok
