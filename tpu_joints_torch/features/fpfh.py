"""FPFH-33 descriptor (counterpart of ``tpu_joints/features/fpfh.py``).

PCL's ``FPFHEstimation`` in two passes over radius supports:

1. SPFH — per surface point, the Darboux-frame pair features (θ, α, φ)
   against each non-self radius neighbour, hard-binned into three 11-bin
   histograms, each pair adding ``100 / #non-self neighbours`` (degenerate
   pairs count in the denominator but add nothing).
2. FPFH — per keypoint, the 1/d²-weighted sum of its radius neighbours'
   SPFHs (``d²`` the gather's own squared distance; the keypoint's own SPFH
   never enters), each 11-bin block renormalised to 100.

Blocks are in PCL's order [θ | α | φ]. Binning is a one-hot sum and the
mixing one batched product, over all points at once; a leading batch axis
on every argument runs B clouds in one pass. The radius gathers keep up to
``k_max`` neighbours (192 on the FPFH chain), more than kernel K2 holds, so
they take ``bruteforce.knn``'s sort path, as the JAX package takes XLA.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.features.eigen3 import cross, norm
from tpu_joints_torch.neighbors.bruteforce import radius_neighbors

FPFH_DIM = 33
_NB = 11  # bins per feature


def pair_features(p1, n1, p2, n2):
    """Darboux pair features with PCL ``computePairFeatures`` semantics.

    All inputs broadcastable [..., 3]. Returns (alpha, phi, theta, ok);
    ok=False marks degenerate pairs (zero baseline or normal ∥ baseline),
    which PCL skips."""
    d = p2 - p1
    dist = norm(d)
    du = d / torch.clamp_min(dist, 1e-12)[..., None]
    a1 = (n1 * du).sum(-1)
    a2 = (n2 * du).sum(-1)
    # the source is the point whose normal is less orthogonal to the
    # baseline: PCL swaps when acos|a1| > acos|a2|, i.e. |a1| < |a2|
    swap = a1.abs() < a2.abs()
    ns = torch.where(swap[..., None], n2, n1)
    nt = torch.where(swap[..., None], n1, n2)
    du = torch.where(swap[..., None], -du, du)
    phi = torch.where(swap, -a2, a1)
    ns, du = torch.broadcast_tensors(ns, du)
    v = cross(du, ns)
    vn = norm(v)
    ok = (dist > 1e-9) & (vn > 1e-9)
    v = v / torch.clamp_min(vn, 1e-12)[..., None]
    w = cross(ns, v)
    alpha = (v * nt).sum(-1)
    theta = torch.atan2((w * nt).sum(-1), (ns * nt).sum(-1))
    return alpha, phi, theta, ok


def _hard_bins(alpha, phi, theta):
    """Feature values → int64 bins (PCL's floor, clamped to 0..10). The
    divisor 2π is a device tensor: CUDA would multiply by the reciprocal of
    a host scalar, which can move a value across a bin edge."""
    two_pi = torch.full((), 2.0 * math.pi, dtype=theta.dtype,
                        device=theta.device)

    def bins(x):
        return torch.clamp(torch.floor(x), 0, _NB - 1).to(torch.int64)

    return (bins(_NB * (alpha + 1.0) * 0.5), bins(_NB * (phi + 1.0) * 0.5),
            bins(_NB * (theta + math.pi) / two_pi))


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` per cloud: t [..., N, C], idx [..., M, K] → [..., M, K, C]."""
    if idx.ndim == 2:
        return t[idx]
    b = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return t[b, idx]


def _onehot_sum(b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_k onehot(b[..., k]) · w[..., k] → [..., 11] (a comparison, not a
    scatter: a garbage bin of a masked pair only meets weight 0)."""
    bins = torch.arange(_NB, device=b.device)
    return ((b[..., None] == bins).to(w.dtype) * w[..., None]).sum(-2)


def spfh(query_xyz, query_normals, query_mask, surface_xyz, surface_normals,
         surface_mask, radius: float, k_max: int,
         exclude_self: bool) -> torch.Tensor:
    """Simplified Point Feature Histograms [..., M, 33]: each block sums to
    ``100 · n_accumulated / n_nonself``. ``exclude_self``: the query is a
    prefix-aligned view of the surface (its own point never a neighbour),
    as the JAX package's FPFH passes whenever both are one cloud."""
    idx, within, dist_sq = radius_neighbors(
        query_xyz, surface_xyz, radius, k_max, source_mask=surface_mask,
        exclude_self=exclude_self)
    idx = idx.long()
    alpha, phi, theta, ok = pair_features(
        query_xyz[..., None, :], query_normals[..., None, :],
        _gather(surface_xyz, idx), _gather(surface_normals, idx))
    nonself = within & (dist_sq > 1e-18) & query_mask[..., None]
    w = (nonself & ok).to(torch.float32)
    ba, bp, bt = _hard_bins(alpha, phi, theta)
    # PCL's hist_incr: 100 / #non-self neighbours, degenerate pairs included
    incr = 100.0 / torch.clamp_min(nonself.to(torch.float32).sum(-1), 1.0)
    hists = [_onehot_sum(b, w) * incr[..., None] for b in (bt, ba, bp)]
    return torch.cat(hists, -1)                   # PCL order [θ | α | φ]


def compute_fpfh(keypoints: Cloud, keypoint_normals: torch.Tensor,
                 surface: Cloud, surface_normals: torch.Tensor, radius: float,
                 k_max: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPFH-33 of ``keypoints`` over ``surface`` (one cloud [N, 3] or a
    batch [B, N, 3]): (desc float32[..., M, 33], valid bool[..., M]). The
    surface's SPFHs exclude each point's own lane; the keypoint gather does
    not, and its zero-distance hit (a keypoint on the surface) carries no
    weight. ``keypoint_normals`` is the reference's argument; as there, the
    keypoints' own normals never enter the values."""
    del keypoint_normals
    surf_spfh = spfh(surface.xyz, surface_normals, surface.mask, surface.xyz,
                     surface_normals, surface.mask, radius, k_max,
                     exclude_self=True)
    idx, within, dist_sq = radius_neighbors(
        keypoints.xyz, surface.xyz, radius, k_max, source_mask=surface.mask)
    valid = within & keypoints.mask[..., None] & (dist_sq > 1e-12)
    # PCL's weight is 1/nn_dists, the search's squared distance verbatim
    w = torch.where(valid, 1.0 / torch.clamp_min(dist_sq, 1e-12), 0.0)
    raw = torch.einsum("...mk,...mkf->...mf", w, _gather(surf_spfh, idx.long()))
    blocks = raw.reshape(*raw.shape[:-1], 3, _NB)
    sums = torch.clamp_min(blocks.sum(-1, keepdim=True), 1e-12)
    desc = (blocks / sums * 100.0).reshape(raw.shape)
    ok = keypoints.mask & (valid.sum(-1) > 0)
    return torch.where(ok[..., None], desc, 0.0), ok
