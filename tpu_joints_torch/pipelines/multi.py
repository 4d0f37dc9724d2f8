"""Multi-part detection: {chord, stub} × views (counterpart of
``tpu_joints/pipelines/multi.py``).

Every demo program of the original iterates two part banks and keeps the
best-scoring part. Here a part is just more views: the part banks are
concatenated along the view axis, scene features are extracted once, and
matching, grouping and refinement run over all parts' views at once — one
[Ms, P·V·Mk] match product, the Hough grouping over P·V views, the top
``max_candidates`` per part, and all P·C candidates in one folded-row ICP
(kernel K1).

* ``detect_parts_organized`` — raw organized frame, part banks that share
  ONE full CAD (the original's ``stubcad.pcd``): the whole single-part
  machinery (two-tier ICP, coverage ranking and gate) on the pooled field,
  ``detect_with_features(n_parts=P)``.
* ``detect_parts`` — an unorganized cloud, each candidate polished against
  its own part's CAD, one winner per part and the best of them.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from tpu_joints_torch.config import DetectionConfig
from tpu_joints_torch.core import graphs
from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.ops import top_k
from tpu_joints_torch.core.transforms import compose
from tpu_joints_torch.modelbank.bank import _ARRAYS, ModelBank
from tpu_joints_torch.pipelines.detect import (
    DetectionResult, SceneFeatures, _check_devices, _group_all_views,
    _model_at_capacity, _registered_views, _strip_crop, _tier_cfg,
    detect_with_features, match_bank, organized_features, prepare_scene)
from tpu_joints_torch.recognize.hv import verify_hypotheses
from tpu_joints_torch.recognize.icp import _move, icp_multi
from tpu_joints_torch.recognize.obb import OBB, oriented_bounding_box

_BIG = 3.0e38


class MultiPartResult(NamedTuple):
    part: str                        # winning part name
    result: DetectionResult          # its detection result
    per_part: Dict[str, DetectionResult]


def _concat_banks(banks: Dict[str, ModelBank]):
    """Stack part banks along the view axis (shapes must match): (names,
    concatenated bank — its full model is the first bank's —, part models
    [P, Ni, 3] at the views' ICP capacity, their masks [P, Ni])."""
    names = list(banks)
    first = banks[names[0]]
    shape = first.view_xyz.shape
    for n in names[1:]:
        if banks[n].view_xyz.shape != shape:
            raise ValueError(
                "multi-part banks must share view shapes: "
                f"{tuple(shape)} vs {tuple(banks[n].view_xyz.shape)} ({n})")
    shared = ("model_xyz", "model_mask")
    cat = ModelBank(
        **{k: torch.cat([getattr(banks[n], k) for n in names])
           for k in _ARRAYS if k not in shared},
        model_xyz=first.model_xyz, model_mask=first.model_mask,
        params_hash="|".join(banks[n].params_hash for n in names),
        has_model=first.has_model)
    Ni = first.icp_xyz.shape[1]
    pm = [_model_at_capacity(banks[n], Ni) for n in names]
    return (names, cat, torch.stack([x for x, _ in pm]),
            torch.stack([m for _, m in pm]))


# concatenated-bank cache keyed by the part banks' object identities: the
# concat and the shared-CAD equality check (a device→host read) run once
# per bank set, not once per frame. Identity, not params_hash: two banks
# built from different part views share a hash. The entry holds the source
# banks, which also pins their ids.
_CAT_CACHE: Dict[tuple, tuple] = {}


def _cat_for_parts(banks: Dict[str, ModelBank]) -> Tuple[List[str], ModelBank]:
    key = tuple((n, id(banks[n])) for n in banks)
    hit = _CAT_CACHE.get(key)
    if hit is not None:
        return hit[:2]
    names, cat, _, _ = _concat_banks(banks)
    first = banks[names[0]]
    for n in names[1:]:
        if not torch.equal(banks[n].model_xyz, first.model_xyz):
            raise ValueError(
                "detect_parts_organized requires all part banks to share "
                "one full CAD model (the original's stubcad.pcd); build "
                "each part bank with the full joint as model_xyz and the "
                "part's rendered views as views=/poses=. For per-part CAD "
                "semantics use detect_parts.")
    _CAT_CACHE[key] = (names, cat, tuple(banks.values()))
    return names, cat


def _parts_chain(xyz_img, valid, crop_lo, crop_hi, viewpoint, *, cat, cfg,
                 block, half_window, n_parts):
    feats, n_sel = organized_features(xyz_img, valid, cfg, block, half_window,
                                      crop_lo, crop_hi, viewpoint)
    res = detect_with_features(feats, cat, _strip_crop(cfg), n_parts=n_parts)
    return res, n_sel


def _parts(xyz_img, valid, banks, cfg, block, half_window, crop_lo, crop_hi,
           viewpoint):
    """(part names, concatenated bank, the two-part chain bound to all but
    its tensors, those tensors, the static part of a graph's key)."""
    names, cat = _cat_for_parts(banks)
    _check_devices(cat.device, xyz_img, valid, crop_lo, crop_hi, viewpoint)
    cfg = _tier_cfg(cat, cfg)
    chain = functools.partial(_parts_chain, cat=cat, cfg=cfg, block=block,
                              half_window=half_window, n_parts=len(names))
    return (names, cat, chain, (xyz_img, valid, crop_lo, crop_hi, viewpoint),
            (cfg, block, half_window, len(names)))


def detect_parts_organized(
    xyz_img: torch.Tensor,
    valid: torch.Tensor,
    banks: Dict[str, ModelBank],
    cfg: DetectionConfig = DetectionConfig(),
    block: int = 4,
    half_window: int = 5,
    crop_lo: Optional[torch.Tensor] = None,
    crop_hi: Optional[torch.Tensor] = None,
    viewpoint: Optional[torch.Tensor] = None,
):
    """Raw organized frame → best pose over several part banks.

    The original's flagship shape: every demo program loops {chord, stub} × 42
    views against one scene and composes and gates the winner against the
    full joint CAD. All part banks must carry the same full model cloud
    (build each with ``build_bank(full_joint_xyz, views=part_views,
    poses=part_poses, view_capacity=common)``); the two-tier and coverage
    machinery of the single-part pipeline applies unchanged. Every tensor
    argument must live on the banks' device. On a card the whole search is
    one captured CUDA graph (``core/graphs.py``), as the JAX package runs
    it as one program.

    Returns ``(part_names, DetectionResult, n_selected)``; the winner's
    part is ``part_names[int(res.view_idx) // views_per_part]`` and each
    candidate's part is ``res.cand_views // views_per_part``.
    """
    names, cat, chain, args, static = _parts(
        xyz_img, valid, banks, cfg, block, half_window, crop_lo, crop_hi,
        viewpoint)
    res, n_sel = graphs.run("detect_parts_organized", chain, args, static, cat)
    return names, res, n_sel


def _detect_parts_organized_eager(xyz_img, valid, banks, cfg, block=4,
                                  half_window=5, crop_lo=None, crop_hi=None,
                                  viewpoint=None):
    """``detect_parts_organized`` run eagerly on any device."""
    names, _, chain, args, _ = _parts(xyz_img, valid, banks, cfg, block,
                                      half_window, crop_lo, crop_hi, viewpoint)
    res, n_sel = chain(*args)
    return names, res, n_sel


def _detect_parts_device(feats: SceneFeatures, cat: ModelBank,
                         part_models: torch.Tensor,
                         part_models_mask: torch.Tensor, cfg: DetectionConfig,
                         n_parts: int) -> dict:
    """Match → group → per-part top-C → one batched ICP → [pooled
    hypothesis verification] → per-part full-CAD polish → per-part winners;
    every value has a leading part axis."""
    dev = cat.device
    P = n_parts
    Vt = cat.desc.shape[0]          # P·V concatenated views
    V = Vt // P
    Pi = cfg.max_instances_per_view
    C = min(cfg.max_candidates, V * Pi)

    corrs = match_bank(feats.desc, feats.desc_valid, cat.desc, cat.key_valid,
                       cfg)
    inst = _group_all_views(feats, cat, corrs, cfg)

    votes = torch.where(inst.valid, inst.votes, -1.0).reshape(P, V * Pi)
    top_votes, top_flat = top_k(votes, C)               # [P, C]
    local_view = top_flat // Pi                         # [P, C] within part
    part = torch.arange(P, device=dev)[:, None]
    gv = (local_view + V * part).reshape(P * C)
    slot = (top_flat + (V * Pi) * part).reshape(P * C)
    cand_valid = (top_votes > 0.0).reshape(P * C)
    cand_init = inst.poses.reshape(Vt * Pi, 4, 4)[slot]
    cand_ncorrs = inst.n_corrs.reshape(Vt * Pi)[slot]

    icp_kw = dict(max_corr_dist=cfg.icp_max_corr_dist,
                  max_corr_start=cfg.icp_max_corr_start)
    cand_poses, cand_fitness = icp_multi(
        cat.icp_xyz[gv], cat.icp_mask[gv], feats.cloud, cand_init,
        iterations=cfg.icp_iterations,
        point_to_plane=cfg.icp_point_to_plane,
        target_normals=feats.normals if cfg.icp_point_to_plane else None,
        **icp_kw)
    cand_fitness = torch.where(cand_valid, cand_fitness, _BIG)
    if cfg.hv_enabled:
        # one verification over the POOLED P·C candidates, whichever part
        # produced them (P·C > 16 takes the greedy search)
        inst_xyz, inst_mask = _registered_views(cat, gv, cand_poses)
        cand_verified = verify_hypotheses(
            inst_xyz, inst_mask, cand_valid, feats.cloud,
            inlier_threshold=cfg.hv_inlier_threshold,
            outlier_regularizer=cfg.hv_regularizer,
            occlusion_threshold=cfg.hv_occlusion_threshold)
    else:
        cand_verified = cand_valid

    # full-CAD ranking/polish against each candidate's OWN part model
    full_cands = compose(cand_poses, cat.poses[gv])
    part_of = torch.arange(P, device=dev).repeat_interleave(C)
    if cfg.select_by_model_fitness or cfg.final_icp_iterations > 0:
        polished, model_fit = icp_multi(
            part_models[part_of], part_models_mask[part_of], feats.cloud,
            full_cands, iterations=cfg.final_icp_iterations,
            point_to_plane=cfg.final_point_to_plane,
            target_normals=feats.normals, **icp_kw)
        effective = torch.where(cand_valid & cand_verified, model_fit, _BIG)
        use_model = cfg.select_by_model_fitness
    else:
        polished, model_fit = full_cands, cand_fitness
        effective = torch.where(cand_verified, cand_fitness, _BIG)
        use_model = False

    # per-part winner (the original's per-loop best tracking)
    best = effective.reshape(P, C).argmin(1)            # first minimum
    flat_best = best + C * torch.arange(P, device=dev)
    view_pose = cand_poses[flat_best]
    fitness = cand_fitness[flat_best]
    if cfg.final_icp_iterations > 0:
        full_pose = polished[flat_best]
        full_fitness = model_fit[flat_best]
        accepted = full_fitness < cfg.final_accept_fitness
    else:
        full_pose = full_cands[flat_best]
        full_fitness = model_fit[flat_best] if use_model else fitness
        accepted = fitness < cfg.accept_fitness
    accepted = accepted & cand_valid[flat_best] & cand_verified[flat_best]

    win_gv = gv[flat_best]
    aligned_xyz = _move(view_pose, cat.view_xyz[win_gv])
    win_mask = cat.view_mask[win_gv]
    boxes = [oriented_bounding_box(Cloud(
        xyz=aligned_xyz[p], mask=win_mask[p],
        rgb=torch.zeros_like(aligned_xyz[p]))) for p in range(P)]

    return dict(
        full_pose=full_pose, view_pose=view_pose, fitness=fitness,
        full_fitness=full_fitness, accepted=accepted,
        view_idx=local_view.reshape(P * C)[flat_best],
        n_corrs=cand_ncorrs[flat_best],
        cand_poses=cand_poses.reshape(P, C, 4, 4),
        cand_fitness=cand_fitness.reshape(P, C),
        cand_views=local_view,
        cand_valid=cand_valid.reshape(P, C),
        cand_verified=cand_verified.reshape(P, C),
        obb=OBB(*(torch.stack(f) for f in zip(*boxes))),
        correspondences=corrs.valid.reshape(P, V, -1).sum(
            (1, 2), dtype=torch.int32),
        scene_points=feats.cloud.count(),
        scene_keypoints=feats.keys.count(),
    )


def detect_parts(scene: Cloud, banks: Dict[str, ModelBank],
                 cfg: DetectionConfig = DetectionConfig(),
                 viewpoint: Optional[torch.Tensor] = None) -> MultiPartResult:
    """Detect every part bank in the scene; return the best-fitness part.

    Scene features are extracted once and all parts run together (see the
    module docstring). Acceptance stays per part (a scene may hold any
    subset of parts — inspect ``per_part``).

    ``cfg.refine_top`` (two-tier refinement) is ignored here: every
    candidate gets the full refinement budget. ``cfg.rank_scene_coverage``
    is likewise not applied (parts rank by full-model fitness);
    ``cfg.coverage_accept`` is an acceptance gate, and skipping it silently
    would change what "accepted" means, so it raises.
    """
    if cfg.coverage_accept > 0.0:
        raise ValueError(
            "coverage_accept is not supported by detect_parts (no scene "
            "coverage stage); use the single-part detect pipeline or set "
            "coverage_accept=0")
    if not banks:
        raise ValueError("no part banks given")
    names, cat, part_models, part_models_mask = _concat_banks(banks)
    _check_devices(cat.device, scene.xyz, scene.mask, viewpoint)
    feats = prepare_scene(scene, cfg, viewpoint)
    out = _detect_parts_device(feats, cat, part_models, part_models_mask, cfg,
                               len(names))

    fields = [f for f in DetectionResult._fields if f not in ("obb", "metrics")]
    per_part: Dict[str, DetectionResult] = {}
    for p, name in enumerate(names):
        per_part[name] = DetectionResult(
            **{f: out[f][p] for f in fields},
            obb=OBB(*(f[p] for f in out["obb"])),
            metrics={"scene_points": out["scene_points"],
                     "scene_keypoints": out["scene_keypoints"],
                     "correspondences": out["correspondences"][p]})

    # one host read for the choice among parts
    any_valid = out["cand_valid"].any(1)
    score = torch.where(any_valid, out["full_fitness"], _BIG).tolist()
    best = names[min(range(len(names)), key=score.__getitem__)]
    return MultiPartResult(part=best, result=per_part[best], per_part=per_part)
