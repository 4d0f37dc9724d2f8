"""Geometric-consistency correspondence grouping (counterpart of
``tpu_joints/recognize/gc.py``; PCL's ``GeometricConsistencyGrouping``, the
reference CLI's ``--algorithm GC``).

Two correspondences are consistent when their scene-side and model-side
keypoint distances agree within ``gc_size``. A fixed ``max_instances``-step
greedy over every view at once: the seed is the still-available
correspondence with the best descriptor distance among those whose
consistent set could clear ``gc_threshold`` (the first maximum of
``-dist``, as ``argmax`` takes it in both packages); its consistent,
available members are pruned ``_REFINE_ROUNDS`` times to those agreeing
with at least ``_KEEP_FRACTION`` of the strongest member's agreement count;
a cluster of at least ``gc_threshold`` members becomes an instance, posed
by ``core.transforms.umeyama``. Every attempt consumes its members and its
seed, so a failed seed is never picked again.
"""
from __future__ import annotations

import torch

from tpu_joints_torch.core.transforms import umeyama
from tpu_joints_torch.features.eigen3 import norm
from tpu_joints_torch.recognize.hough import Instances
from tpu_joints_torch.recognize.matching import Correspondences

_REFINE_ROUNDS = 3
_KEEP_FRACTION = 0.5  # of the strongest member's agreement count


def gc_group(scene_keys: torch.Tensor, model_keys: torch.Tensor,
             model_mask: torch.Tensor, corrs: Correspondences,
             gc_size: float = 0.01, gc_threshold: float = 5.0,
             max_instances: int = 8) -> Instances:
    """Instances per view: scene_keys [M, 3] (or [V, M, 3], one scene per
    view), model_keys [V, Nm, 3], model_mask [V, Nm], ``corrs`` fields
    [V, M]. Returns poses [V, P, 4, 4], votes = n_corrs [V, P], valid
    [V, P], membership [V, P, M]."""
    V, M = corrs.model_idx.shape
    dev = scene_keys.device
    mi = corrs.model_idx.long()
    cvalid = corrs.valid & torch.gather(model_mask, 1, mi)
    corr_dist = torch.where(cvalid, corrs.dist_sq, float("inf"))
    sp = scene_keys.expand(V, M, 3)
    mp = torch.gather(model_keys, 1, mi[..., None].expand(V, M, 3))
    ds = norm(sp[:, :, None, :] - sp[:, None, :, :])
    dm = norm(mp[:, :, None, :] - mp[:, None, :, :])
    pair = cvalid[:, :, None] & cvalid[:, None, :]
    eye = torch.eye(M, dtype=torch.bool, device=dev)
    # a correspondence is always consistent with itself
    consistent = (((ds - dm).abs() < gc_size) & pair) | (eye & cvalid[:, :, None])
    lane = torch.arange(M, device=dev)

    used = torch.zeros(V, M, dtype=torch.bool, device=dev)
    poses, ns, oks, membership = [], [], [], []
    for _ in range(max_instances):
        avail = cvalid & ~used
        support = (consistent & avail[:, None, :]).sum(2)
        qualified = avail & (support >= gc_threshold)
        seed = torch.where(qualified, -corr_dist, float("-inf")).argmax(1)
        members = torch.gather(
            consistent, 1, seed[:, None, None].expand(V, 1, M))[:, 0] & avail
        for _ in range(_REFINE_ROUNDS):
            agree = (consistent & members[:, None, :]).to(torch.float32).sum(2)
            agree = torch.where(members, agree, 0.0)
            peak = torch.clamp_min(agree.amax(1, keepdim=True), 1.0)
            members = members & (agree >= _KEEP_FRACTION * peak)
        n = members.sum(1, dtype=torch.int32)
        ok = (n >= gc_threshold) & torch.gather(qualified, 1, seed[:, None])[:, 0]
        spent = (members | (lane[None, :] == seed[:, None])) & avail
        members = members & ok[:, None]
        poses.append(umeyama(mp, sp, members.to(torch.float32)))
        used = used | members | spent
        ns.append(n)
        oks.append(ok)
        membership.append(members)
    n = torch.stack(ns, 1)
    return Instances(poses=torch.stack(poses, 1), votes=n.to(torch.float32),
                     n_corrs=n, valid=torch.stack(oks, 1),
                     membership=torch.stack(membership, 1))
