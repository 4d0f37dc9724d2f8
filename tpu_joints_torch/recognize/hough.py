"""Hough-3D correspondence grouping, batched over bank views (counterpart of
``tpu_joints/recognize/hough.py``, where ``detect.py`` vmaps it per view).

Every correspondence votes for the model centroid's scene position in a
64³ accumulator per view (~44 MB for 42 views). The scatter-add is a
deterministic in-order segment sum (``core.ops.scatter_add``); peaks come
from 3³ non-max suppression and ``lax.top_k``'s order (stable sort). With
``split_rotation_modes`` each peak emits its two rotation modes (consensus
anchors, ~45° cones), interleaved as [peak0·mode0, peak0·mode1, ...].
A batch of B scenes folds into the view axis: B·V "views" in frame order,
each frame's V views grouped alone, exactly as a one-frame chain groups
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_joints_torch.core.ops import scatter_add, top_k
from tpu_joints_torch.core.transforms import umeyama
from tpu_joints_torch.recognize.matching import Correspondences

GRID = 64
_MODE_COS = 0.0
_N_ANCHORS = 8
_CONE_COS = 0.7


class Instances(NamedTuple):
    """Per view, up to P instance hypotheses: poses [V, P, 4, 4] model→scene,
    votes [V, P], n_corrs int32[V, P], valid bool[V, P], membership
    bool[V, P, M] (which correspondences support each instance)."""

    poses: torch.Tensor
    votes: torch.Tensor
    n_corrs: torch.Tensor
    valid: torch.Tensor
    membership: torch.Tensor


def model_local_votes(model_keys: torch.Tensor, model_rf: torch.Tensor,
                      model_mask: torch.Tensor) -> torch.Tensor:
    """Per model keypoint [..., Nm], the centroid offset in its LRF."""
    w = model_mask.to(torch.float32)
    centroid = (model_keys * w[..., None]).sum(-2) / torch.clamp_min(
        w.sum(-1), 1.0)[..., None]
    off = centroid[..., None, :] - model_keys
    return torch.einsum("...mij,...mj->...mi", model_rf, off)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [V, N, *rest] gathered at idx [V, ...] along axis 1."""
    V, N = t.shape[:2]
    rest = t.shape[2:]
    flat = t.reshape(V, N, -1)
    g = torch.gather(flat, 1, idx.reshape(V, -1, 1).expand(-1, -1, flat.shape[2]))
    return g.reshape(*idx.shape, *rest)


def _consensus(mem: torch.Tensor, w: torch.Tensor, R_corr: torch.Tensor):
    """Best rotation-coherent subset of each membership row mem [V, P, M]:
    the top-weighted members are tried as anchors, each claiming the
    members within a ~45° cone of its rotation; the anchor with the most
    weighted agreement wins. Returns (cone members, cos to the anchor)."""
    V, P, M = mem.shape
    ww = mem.to(torch.float32) * w[:, None, :]
    _, anchors = top_k(ww, _N_ANCHORS)                          # [V, P, K]
    Rf = R_corr.reshape(V, M, 9)
    Ra = _gather_rows(Rf, anchors)                              # [V, P, K, 9]
    cosang = (torch.einsum("vpkn,vmn->vpkm", Ra, Rf) - 1.0) / 2.0
    agree = (cosang > _CONE_COS) & mem[:, :, None, :]
    score = (agree.to(torch.float32) * w[:, None, None, :]).sum(-1)
    score = torch.where(torch.gather(ww, 2, anchors) > 0.0, score, -1.0)
    best = torch.argmax(score, dim=-1)[..., None, None].expand(V, P, 1, M)
    return (torch.gather(agree, 2, best)[:, :, 0],
            torch.gather(cosang, 2, best)[:, :, 0])


def hough_group(
    scene_keys: torch.Tensor,
    scene_rf: torch.Tensor,
    scene_rf_ok: torch.Tensor,
    model_keys: torch.Tensor,
    model_rf: torch.Tensor,
    model_rf_ok: torch.Tensor,
    model_mask: torch.Tensor,
    corrs: Correspondences,
    bin_size: float = 0.03,
    threshold: float = 3.0,
    max_instances: int = 8,
    use_distance_weight: bool = True,
    split_rotation_modes: bool = False,
) -> Instances:
    """Group correspondences into rigid-instance hypotheses for every view.

    Scene arrays: keys [M, 3], rf [M, 3, 3], rf_ok [M]. Model arrays carry a
    leading view axis: keys [V, Nm, 3], rf [V, Nm, 3, 3], rf_ok/mask
    [V, Nm]; ``corrs`` fields are [V, M]. With B scenes (keys [B, M, 3], rf
    [B, M, 3, 3], rf_ok [B, M]) the model arrays and ``corrs`` carry B·V
    views in frame order, and each frame is grouped on its own, with its
    ``corrs`` laid out as a one-frame match lays them out (its [M, V]
    columns seen as [V, M]): a sum over M adds in another order over
    another shape or layout, and a rank-deficient fit on 3-4 matches turns
    with that last bit, so a batch would hand a frame other candidates than
    its own run.
    """
    if scene_keys.ndim == 3:
        B = scene_keys.shape[0]
        V = model_keys.shape[0] // B
        parts = [hough_group(
            scene_keys[b], scene_rf[b], scene_rf_ok[b],
            *(t[b * V:(b + 1) * V] for t in (model_keys, model_rf,
                                             model_rf_ok, model_mask)),
            Correspondences(*(t[b * V:(b + 1) * V].t().contiguous().t()
                              for t in corrs)),
            bin_size=bin_size, threshold=threshold,
            max_instances=max_instances,
            use_distance_weight=use_distance_weight,
            split_rotation_modes=split_rotation_modes) for b in range(B)]
        return Instances(*(torch.cat(f) for f in zip(*parts)))
    V = model_keys.shape[0]
    M = scene_keys.shape[-2]
    dev = scene_keys.device
    scene_keys, scene_rf_ok = scene_keys[None], scene_rf_ok[None, :]
    mi = corrs.model_idx.long()
    cvalid = (corrs.valid & scene_rf_ok
              & torch.gather(model_rf_ok, 1, mi) & torch.gather(model_mask, 1, mi))
    local = model_local_votes(model_keys, model_rf, model_mask)
    cast = _gather_rows(local, mi)                              # [V, M, 3]
    votes_xyz = scene_keys + torch.einsum("mji,vmj->vmi", scene_rf, cast)

    cv = cvalid.to(torch.float32)
    nvalid = torch.clamp_min(cv.sum(1), 1.0)
    if use_distance_weight:
        w = 1.0 / (1.0 + corrs.dist_sq) * cv
        w = w * (nvalid / torch.clamp_min(w.sum(1), 1e-9))[:, None]
    else:
        w = cv

    wsum = torch.clamp_min(w.sum(1), 1e-6)
    center = (votes_xyz * w[..., None]).sum(1) / wsum[:, None]
    lo = center - (GRID / 2.0) * bin_size
    bin_t = torch.full((), bin_size, dtype=torch.float32, device=dev)
    ijk = torch.floor((votes_xyz - lo[:, None, :]) / bin_t).to(torch.int64)
    ijk = torch.clamp(ijk, 0, GRID - 1)
    flat = (ijk[..., 0] * GRID + ijk[..., 1]) * GRID + ijk[..., 2]   # [V, M]
    G3 = GRID * GRID * GRID
    view_off = torch.arange(V, device=dev)[:, None] * G3
    acc = scatter_add((flat + view_off).reshape(-1), w.reshape(-1), V * G3)
    acc3 = acc.reshape(V, 1, GRID, GRID, GRID)
    pooled = F.max_pool3d(acc3, 3, stride=1, padding=1)
    is_peak = (acc3 >= pooled) & (acc3 >= threshold)
    peak_score = torch.where(is_peak, acc3, -1.0).reshape(V, G3)
    split = split_rotation_modes and max_instances % 2 == 0
    n_peaks = max_instances // 2 if split else max_instances
    top_votes, top_bins = top_k(peak_score, n_peaks)            # [V, Pk]
    membership = (flat[:, None, :] == top_bins[:, :, None]) & cvalid[:, None, :]

    if split:
        # rf rows are axes: scene_rf = model_rf·Rᵀ  ⇒  R = scene_rfᵀ·model_rf
        R_corr = torch.einsum("mts,vmtk->vmsk", scene_rf,
                              _gather_rows(model_rf, mi))
        m1, cos1 = _consensus(membership, w, R_corr)
        m2, _ = _consensus(membership & (cos1 <= _MODE_COS), w, R_corr)
        membership = torch.stack([m1, m2], dim=2).reshape(V, 2 * n_peaks, M)
        top_votes = (membership.to(torch.float32) * w[:, None, :]).sum(-1)
    P = membership.shape[1]
    inst_valid = top_votes >= threshold
    n_corrs = membership.sum(-1, dtype=torch.int32)
    src = _gather_rows(model_keys, mi)[:, None].expand(V, P, M, 3)
    dst = scene_keys[:, None].expand(V, P, M, 3)
    poses = umeyama(src, dst, membership.to(torch.float32) * w[:, None, :])
    return Instances(poses=poses, votes=torch.clamp_min(top_votes, 0.0),
                     n_corrs=n_corrs, valid=inst_valid & (n_corrs >= 3),
                     membership=membership)
