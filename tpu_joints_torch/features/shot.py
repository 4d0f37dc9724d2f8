"""SHOT-352 descriptor (counterpart of ``tpu_joints/features/shot.py``).

32 spatial sectors (2 radial × 2 elevation × 8 azimuth, in the keypoint's
LRF) × 11 bins of cos(neighbour normal, LRF z); the 352-vector is
L2-normalised. Two interpolation schemes, as in the reference (bank and
scene must use the same one):

* "smooth" (the main path's): separable quadrilinear interpolation, one
  outer-product contraction of four per-neighbour soft-assignment matrices;
* "pcl": PCL's ``interpolateSingleChannel``, additive across dimensions —
  each neighbour's home volume and slot get ``(1 − |shape resid|) +
  Σ_dim home weight`` and one adjacent volume per spatial dimension (and
  one adjacent slot, wrapped ``% 10``) that dimension's residual: four
  contractions over one-hot home assignments. ``tests/golden/
  descriptors.npz`` pins it.
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


def _onehot(b: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer-valued ``b`` over ``n`` classes (a
    comparison: an out-of-range value is all zeros, as ``jax.nn.one_hot``)."""
    return (b.to(torch.int64)[..., None]
            == torch.arange(n, device=b.device)).to(torch.float32)


def shot_histograms_pcl(key_xyz, rf, nbr_xyz, nbr_normals, nbr_valid,
                        radius: float) -> torch.Tensor:
    """Raw (unnormalised) [M, 352] SHOT histograms, PCL's scheme, with its
    edge behaviours: mass decays toward the support's centre, rim and poles
    (no adjacent volume there, the home weight still reduced), the azimuth
    residual is clamped to ±0.5 of a sector, the shape-adjacent slot wraps
    ``% 10``, and neighbours on the LRF z-axis skip the azimuth. Layout:
    volume = azimuth·4 + radial·2 + elevation, 11 slots per volume."""
    pi = math.pi
    r = radius
    rel = nbr_xyz - key_xyz[:, None, :]
    local = torch.einsum("mij,mkj->mki", rf, rel)
    d = norm(rel)
    valid = nbr_valid & (d > 1e-9) & (d <= radius)
    x, y, z = local[..., 0], local[..., 1], local[..., 2]

    # shape (cosine) axis: home slot and the % 10-wrapped adjacent slot
    cos = torch.clamp(torch.einsum("mkj,mj->mk", nbr_normals, rf[:, 2, :]),
                      -1.0, 1.0)
    bin_dist = (1.0 + cos) * N_SHAPE_BINS / 2.0
    step = torch.floor(bin_dist + 0.5)
    resid = bin_dist - step
    adj_slot = torch.where(resid > 0, (step + 1) % N_SHAPE_BINS,
                           (step - 1 + N_SHAPE_BINS) % N_SHAPE_BINS)

    # home spatial volume bits
    az = torch.atan2(y, x)
    sel = torch.clamp(torch.floor((az + pi) / (pi / 4.0)), 0, N_AZIMUTH - 1)
    rbit = d > 0.5 * r
    ebit = z > 0.0

    # per-dimension residuals at PCL's husk, pole and sector boundaries
    rd_out = (d - 0.75 * r) / (0.5 * r)
    rd_in = (d - 0.25 * r) / (0.5 * r)
    home_r = torch.where(rbit,
                         torch.where(d > 0.75 * r, 1.0 - rd_out, 1.0 + rd_out),
                         torch.where(d < 0.25 * r, 1.0 + rd_in, 1.0 - rd_in))
    adj_r = torch.where(rbit, torch.where(d > 0.75 * r, 0.0, -rd_out),
                        torch.where(d < 0.25 * r, 0.0, rd_in))
    incl = torch.acos(torch.clamp(z / torch.clamp_min(d, 1e-12), -1.0, 1.0))
    half_pi = pi / 2.0
    id_lo = (incl - 3.0 * pi / 4.0) / half_pi
    id_hi = (incl - pi / 4.0) / half_pi
    home_e = torch.where(incl > half_pi,
                         torch.where(incl > 3.0 * pi / 4.0, 1.0 - id_lo,
                                     1.0 + id_lo),
                         torch.where(incl < pi / 4.0, 1.0 + id_hi,
                                     1.0 - id_hi))
    adj_e = torch.where(incl > half_pi,
                        torch.where(incl > 3.0 * pi / 4.0, 0.0, -id_lo),
                        torch.where(incl < pi / 4.0, 0.0, id_hi))
    center = -7.0 * pi / 8.0 + sel * (pi / 4.0)
    azd = torch.clamp((az - center) / (pi / 4.0), -0.5, 0.5)
    on_axis = (x == 0.0) & (y == 0.0)
    home_a = torch.where(on_axis, 0.0, 1.0 - azd.abs())
    adj_a = torch.where(on_axis, 0.0, azd.abs())
    adj_sel = torch.where(azd > 0, (sel + 1) % N_AZIMUTH,
                          (sel - 1 + N_AZIMUTH) % N_AZIMUTH)
    int_weight = (1.0 - resid.abs()) + home_r + home_e + home_a

    w = valid.to(torch.float32)[..., None]
    Sh = _onehot(step, N_SLOTS)
    S1 = (Sh * int_weight[..., None]
          + _onehot(adj_slot, N_SLOTS) * resid.abs()[..., None]) * w
    Shw = Sh * w
    Ah = _onehot(sel, N_AZIMUTH)
    Rh = _onehot(rbit, N_RADIAL)
    Eh = _onehot(ebit, N_ELEVATION)
    Aadj = _onehot(adj_sel, N_AZIMUTH) * adj_a[..., None]
    Radj = _onehot(~rbit, N_RADIAL) * adj_r[..., None]
    Eadj = _onehot(~ebit, N_ELEVATION) * adj_e[..., None]

    def ein(a, rr, e, sh):
        return torch.einsum("mka,mkr,mke,mks->mares", a, rr, e, sh)

    hist = (ein(Ah, Rh, Eh, S1) + ein(Aadj, Rh, Eh, Shw)
            + ein(Ah, Radj, Eh, Shw) + ein(Ah, Rh, Eadj, Shw))
    return hist.reshape(key_xyz.shape[0], SHOT_DIM)


def shot_histograms(key_xyz, rf, nbr_xyz, nbr_normals, nbr_valid,
                    radius: float, scheme: str = "smooth") -> torch.Tensor:
    """Raw [M, 352] SHOT histograms; ``scheme`` in {"smooth", "pcl"}."""
    fn = {"smooth": shot_histograms_smooth, "pcl": shot_histograms_pcl}
    if scheme not in fn:
        raise ValueError(f"unknown SHOT scheme {scheme!r}")
    return fn[scheme](key_xyz, rf, nbr_xyz, nbr_normals, nbr_valid, radius)


def compute_shot(
    keypoints: Cloud,
    surface: Cloud,
    surface_normals: torch.Tensor,
    radius: float,
    k_max: int = 128,
    scheme: str = "smooth",
    neighbors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SHOT for keypoints over a search surface: (desc float32[M, 352]
    L2-normalised, rf float32[M, 3, 3], valid bool[M]). ``scheme`` as in
    :func:`shot_histograms`; ``neighbors`` optionally carries a precomputed
    ``(idx, within)`` radius gather at the same radius and k_max."""
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
    hist = shot_histograms(keypoints.xyz, rf, nbr_xyz, nbr_normals,
                           nbr_valid, radius, scheme=scheme)
    n = norm(hist, keepdim=True)
    desc = hist / torch.clamp_min(n, 1e-12)
    valid = keypoints.mask & rf_ok & (n[:, 0] > 1e-12)
    return torch.where(valid[:, None], desc, 0.0), rf, valid
