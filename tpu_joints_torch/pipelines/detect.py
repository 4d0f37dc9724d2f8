"""Raw organized frame → 6D pose (counterpart of
``tpu_joints/pipelines/detect.py``; the organized main path).

  frame → ingest (tile select + moment normals) → uniform keypoints
        → one shared k_max radius gather → SHOT + BOARD frames
        → match against every bank view in one product → Hough per view
        → view-grouped candidate cut → two-tier ICP (k=1 NN kernel)
        → coverage-dominant ranking + coverage gate → composed pose + OBB

No host synchronisation happens between the frame and the result: shapes
are fixed by the config, every branch is on configuration or on host facts
about the bank (``ModelBank.has_model``), and indexing with a computed
index goes through gathers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from tpu_joints_torch.config import DetectionConfig
from tpu_joints_torch.core.cloud import SENTINEL, Cloud
from tpu_joints_torch.core.ops import take, top_k
from tpu_joints_torch.core.transforms import (compose, invert_rigid,
                                              transform_points)
from tpu_joints_torch.features.lrf import board_lrf
from tpu_joints_torch.features.shot import compute_shot
from tpu_joints_torch.filters.filters import compact_cloud, uniform_sample_mask
from tpu_joints_torch.modelbank.bank import ModelBank
from tpu_joints_torch.neighbors.bruteforce import radius_neighbors
from tpu_joints_torch.pipelines.ingest import ingest_organized_blocks
from tpu_joints_torch.recognize.hough import Instances, hough_group
from tpu_joints_torch.recognize.icp import icp_multi, scene_coverage_multi
from tpu_joints_torch.recognize.matching import Correspondences
from tpu_joints_torch.recognize.obb import OBB, oriented_bounding_box

_BIG = 3.0e38


class SceneFeatures(NamedTuple):
    cloud: Cloud
    normals: torch.Tensor      # [N, 3]
    keys: Cloud                # [Ms] keypoints
    desc: torch.Tensor         # [Ms, D]
    desc_valid: torch.Tensor
    rf: torch.Tensor           # [Ms, 3, 3]
    rf_ok: torch.Tensor


class DetectionResult(NamedTuple):
    """Best instance + all refined candidates (C = cfg.max_candidates)."""

    full_pose: torch.Tensor      # [4, 4] CAD model → scene
    view_pose: torch.Tensor      # [4, 4] view cloud → scene
    fitness: torch.Tensor        # winner's view-ICP fitness
    full_fitness: torch.Tensor   # full-CAD fitness at full_pose
    accepted: torch.Tensor
    view_idx: torch.Tensor
    n_corrs: torch.Tensor
    cand_poses: torch.Tensor     # [C, 4, 4] view → scene
    cand_fitness: torch.Tensor   # [C]
    cand_views: torch.Tensor     # [C]
    cand_valid: torch.Tensor     # [C]
    cand_verified: torch.Tensor  # [C] (all valid: HV is not ported)
    obb: OBB
    metrics: dict


def prepare_scene(scene: Cloud, cfg: DetectionConfig,
                  normals: torch.Tensor) -> SceneFeatures:
    """Organized-branch scene features: uniform keypoints → SHOT + voting
    frames, sharing one radius gather when descriptor and frames use the
    same radius and width. ``normals`` come from the organized ingest."""
    if cfg.descriptor != "shot" or cfg.keypoints != "uniform":
        raise NotImplementedError("only SHOT with uniform keypoints is ported")
    if cfg.segment_scene or cfg.remove_plane:
        raise NotImplementedError("the scene crop chain is not ported yet")
    keep = uniform_sample_mask(scene, cfg.scene_ss)
    keys, kidx = compact_cloud(scene, keep, cfg.scene_key_capacity)
    shared = None
    if (cfg.rf_frames == "board" and cfg.rf_rad == cfg.descr_rad
            and cfg.rf_k_max == cfg.k_max):
        sidx, swithin, _ = radius_neighbors(keys.xyz, scene.xyz, cfg.descr_rad,
                                            cfg.k_max, source_mask=scene.mask)
        shared = (sidx, swithin)
    desc, rf, valid = compute_shot(keys, scene, normals, radius=cfg.descr_rad,
                                   k_max=cfg.k_max, neighbors=shared)
    rf_ok = valid
    if cfg.rf_frames != "shot":
        if shared is not None:
            nidx, nwithin = shared
        else:
            nidx, nwithin, _ = radius_neighbors(keys.xyz, scene.xyz, cfg.rf_rad,
                                                cfg.rf_k_max,
                                                source_mask=scene.mask)
        nidx = nidx.long()
        nvalid = nwithin & keys.mask[:, None]
        if cfg.rf_frames == "board":
            rf, rf_ok = board_lrf(keys.xyz, normals[kidx], scene.xyz[nidx],
                                  normals[nidx], nvalid, cfg.rf_rad)
        else:
            raise ValueError(f"unknown rf_frames {cfg.rf_frames!r}")
    return SceneFeatures(cloud=scene, normals=normals, keys=keys, desc=desc,
                         desc_valid=valid, rf=rf, rf_ok=rf_ok)


def _model_at_capacity(bank: ModelBank, n: int):
    """The full CAD cloud stride-subsampled/padded to exactly ``n`` lanes."""
    Nm = bank.model_xyz.shape[0]
    stride = max(1, Nm // n)
    xyz = bank.model_xyz[::stride][:n]
    mask = bank.model_mask[::stride][:n]
    pad = n - xyz.shape[0]
    if pad > 0:
        xyz = torch.cat([xyz, xyz.new_full((pad, 3), SENTINEL)])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    return xyz, mask


def match_bank(scene_desc: torch.Tensor, scene_valid: torch.Tensor,
               bank_desc: torch.Tensor, bank_valid: torch.Tensor,
               cfg: DetectionConfig) -> Correspondences:
    """Nearest bank keypoint per scene keypoint and view, from one
    [Ms, V·Mk] descriptor-distance product; fields are [V, Ms]."""
    if cfg.match_mode != "nn":
        raise NotImplementedError(f"match_mode {cfg.match_mode!r} is not ported yet")
    V, Mk, D = bank_desc.shape
    flat = bank_desc.reshape(V * Mk, D)
    s2 = (scene_desc * scene_desc).sum(-1, keepdim=True)
    b2 = (flat * flat).sum(-1)
    d = s2 + b2[None, :] - 2.0 * (scene_desc @ flat.T)
    d = torch.clamp_min(d, 0.0).reshape(-1, V, Mk)
    d = torch.where(bank_valid[None], d, _BIG)
    d1, idx = d.min(dim=-1)                       # first index of the minimum
    ok = scene_valid[:, None] & (d1 < cfg.match_threshold)
    return Correspondences(model_idx=idx.T, valid=ok.T, dist_sq=d1.T)


def _group_all_views(feats: SceneFeatures, bank: ModelBank,
                     corrs: Correspondences, cfg: DetectionConfig) -> Instances:
    if cfg.algorithm != "hough":
        raise NotImplementedError(f"algorithm {cfg.algorithm!r} is not ported yet")
    return hough_group(
        feats.keys.xyz, feats.rf, feats.rf_ok, bank.key_xyz, bank.rf,
        bank.key_valid, bank.key_valid, corrs,
        bin_size=cfg.cg_size, threshold=cfg.cg_thresh,
        max_instances=cfg.max_instances_per_view,
        use_distance_weight=cfg.use_distance_weight,
        split_rotation_modes=cfg.split_rotation_modes)


def detect_with_features(feats: SceneFeatures, bank: ModelBank,
                         cfg: DetectionConfig) -> DetectionResult:
    """Match → group → refine against the bank."""
    corrs = match_bank(feats.desc, feats.desc_valid, bank.desc,
                       bank.key_valid, cfg)
    inst = _group_all_views(feats, bank, corrs, cfg)
    return refine_instances(feats, bank, inst, corrs.count(), cfg)


def refine_instances(feats: SceneFeatures, bank: ModelBank, inst: Instances,
                     n_corr_total: torch.Tensor,
                     cfg: DetectionConfig) -> DetectionResult:
    """Candidate cut → (two-tier) ICP → full-CAD ranking with scene
    coverage → winner, acceptance gates, OBB."""
    if cfg.hv_enabled or cfg.obb_largest_cluster or cfg.peak_grouped_candidates:
        raise NotImplementedError("HV, clustered OBB and the peak-grouped "
                                  "cut are not ported yet")
    dev = inst.votes.device
    V, P = inst.votes.shape
    C = min(cfg.max_candidates, V * P)
    votes = torch.where(inst.valid, inst.votes, -1.0).reshape(V * P)
    if cfg.view_grouped_candidates and P > 1 and C % P == 0:
        # strongest bin picks the view; ALL of that view's bins enter
        strength = votes.reshape(V, P).amax(1)
        _, top_views = top_k(strength, C // P)
        top_local = (top_views[:, None] * P
                     + torch.arange(P, device=dev)).reshape(C)
        top_votes = votes[top_local]
    else:
        top_votes, top_local = top_k(votes, C)
    cand_views = top_local // P
    cand_valid = top_votes > 0.0
    cand_init = inst.poses.reshape(V * P, 4, 4)[top_local]
    cand_ncorrs = inst.n_corrs.reshape(V * P)[top_local]

    has_model = bank.has_model
    Ni = bank.icp_xyz.shape[1]
    two_tier = 0 < cfg.refine_top < C and cfg.final_icp_iterations > 0 \
        and has_model
    stride = max(1, Ni // cfg.tier1_rows) if two_tier else 1
    t1_view_iters = cfg.icp_iterations
    t1_polish_iters = cfg.final_icp_iterations
    if two_tier:
        if cfg.tier1_view_iterations > 0:
            t1_view_iters = cfg.tier1_view_iterations
        elif cfg.tier1_iterations > 0:
            t1_view_iters = cfg.tier1_iterations
        if cfg.tier1_polish_iterations > 0:
            t1_polish_iters = cfg.tier1_polish_iterations
        elif cfg.tier1_iterations > 0:
            t1_polish_iters = min(cfg.tier1_iterations, cfg.final_icp_iterations)

    icp_kw = dict(max_corr_dist=cfg.icp_max_corr_dist,
                  max_corr_start=cfg.icp_max_corr_start)
    cand_poses, cand_fitness = icp_multi(
        bank.icp_xyz[cand_views][:, ::stride],
        bank.icp_mask[cand_views][:, ::stride],
        feats.cloud, cand_init, iterations=t1_view_iters,
        point_to_plane=cfg.icp_point_to_plane,
        target_normals=feats.normals if cfg.icp_point_to_plane else None,
        with_fitness=not (two_tier and cfg.tier1_skip_view_fitness), **icp_kw)
    cand_fitness = torch.where(cand_valid, cand_fitness, _BIG)
    cand_verified = cand_valid
    effective_fitness = cand_fitness

    full_cands = compose(cand_poses, bank.poses[cand_views])
    coverage = unexplained = None
    in_top = None
    if has_model and (cfg.select_by_model_fitness or cfg.final_icp_iterations > 0):
        Nm = bank.model_xyz.shape[0]
        rows = (Ni + stride - 1) // stride
        m_xyz, m_mask = _model_at_capacity(bank, rows)
        polished, model_fit = icp_multi(
            m_xyz.expand(C, rows, 3), m_mask.expand(C, rows), feats.cloud,
            full_cands, iterations=t1_polish_iters,
            point_to_plane=cfg.final_point_to_plane,
            target_normals=feats.normals, **icp_kw)
        rank_metric = model_fit
        if cfg.rank_scene_coverage:
            cov_cap = min(Nm, 2048) if two_tier else min(Nm, max(4096, Ni))
            c_xyz, c_mask = _model_at_capacity(bank, cov_cap)
            coverage, unexplained = scene_coverage_multi(
                feats.cloud, c_xyz, c_mask, polished, clip=cfg.coverage_clip,
                local=cfg.coverage_local)
            rank_metric = coverage + 0.1 * model_fit
        ranked = torch.where(cand_valid & cand_verified, rank_metric, _BIG)
        if two_tier:
            R = cfg.refine_top
            _, top_r = top_k(-ranked, R)
            m2_xyz, m2_mask = _model_at_capacity(bank, Ni)
            polished2, fit2 = icp_multi(
                m2_xyz.expand(R, Ni, 3), m2_mask.expand(R, Ni), feats.cloud,
                polished[top_r], iterations=cfg.final_icp_iterations,
                point_to_plane=cfg.final_point_to_plane,
                target_normals=feats.normals, **icp_kw)
            rank2 = fit2
            if cfg.rank_scene_coverage:
                c2_xyz, c2_mask = _model_at_capacity(bank, min(Nm, max(4096, Ni)))
                coverage2, unexplained2 = scene_coverage_multi(
                    feats.cloud, c2_xyz, c2_mask, polished2,
                    clip=cfg.coverage_clip, local=cfg.coverage_local)
                rank2 = coverage2 + 0.1 * fit2
                coverage = coverage.index_copy(0, top_r, coverage2)
                unexplained = unexplained.index_copy(0, top_r, unexplained2)
            rank2 = torch.where((cand_valid & cand_verified)[top_r], rank2, _BIG)
            polished = polished.index_copy(0, top_r, polished2)
            model_fit = model_fit.index_copy(0, top_r, fit2)
            # only tier-2 survivors can win, in every selection mode
            ranked = torch.full_like(ranked, _BIG).index_copy(0, top_r, rank2)
            in_top = torch.zeros(C, dtype=torch.bool, device=dev).index_fill(
                0, top_r, True)
            effective_fitness = torch.where(in_top, effective_fitness, _BIG)
        if cfg.select_by_model_fitness:
            effective_fitness = ranked
    else:
        polished, model_fit = full_cands, cand_fitness

    best = torch.argmin(effective_fitness)
    view_idx = take(cand_views, best)
    view_pose = take(cand_poses, best)
    fitness = take(cand_fitness, best)
    if cfg.final_icp_iterations > 0 and has_model:
        full_pose = take(polished, best)
        full_fitness = take(model_fit, best)
        accepted = full_fitness < cfg.final_accept_fitness
    elif cfg.final_icp_iterations > 0:
        full_pose = take(full_cands, best)
        full_fitness = fitness
        accepted = fitness < cfg.accept_fitness
    else:
        full_pose = take(full_cands, best)
        full_fitness = (take(model_fit, best)
                        if has_model and cfg.select_by_model_fitness else fitness)
        accepted = fitness < cfg.accept_fitness
    if two_tier:
        # re-derive the view→scene pose from the tier-2 polished CAD pose
        view_pose = compose(full_pose, invert_rigid(take(bank.poses, view_idx)))
    accepted = accepted & take(cand_valid, best) & take(cand_verified, best)
    if cfg.coverage_accept > 0.0 and has_model:
        if unexplained is None:
            raise ValueError(
                "coverage_accept > 0 requires rank_scene_coverage=True plus a "
                "ranking stage (select_by_model_fitness=True or "
                "final_icp_iterations > 0)")
        # the winner must EXPLAIN the scene: few points far from the model
        accepted = accepted & (take(unexplained, best) < cfg.coverage_accept)

    view_xyz = take(bank.view_xyz, view_idx)
    aligned = Cloud(xyz=transform_points(view_xyz, view_pose),
                    mask=take(bank.view_mask, view_idx),
                    rgb=torch.zeros_like(view_xyz))
    box = oriented_bounding_box(aligned)

    metrics = {
        "scene_points": feats.cloud.count(),
        "scene_keypoints": feats.keys.count(),
        "valid_descriptors": feats.desc_valid.sum(dtype=torch.int32),
        "correspondences": n_corr_total,
        "instances": inst.valid.sum(dtype=torch.int32),
        "best_votes": top_votes.amax(),
    }
    if coverage is not None:
        metrics["best_coverage"] = take(coverage, best)
        metrics["cand_coverage"] = coverage
        metrics["best_unexplained"] = take(unexplained, best)
        metrics["cand_unexplained"] = unexplained
    metrics["cand_full_poses"] = polished if has_model else full_cands
    metrics["cand_full_fitness"] = model_fit if has_model else cand_fitness
    metrics["has_model"] = has_model
    metrics["cand_tier2"] = (in_top if in_top is not None
                             else torch.ones(C, dtype=torch.bool, device=dev))
    return DetectionResult(
        full_pose=full_pose, view_pose=view_pose, fitness=fitness,
        full_fitness=full_fitness, accepted=accepted, view_idx=view_idx,
        n_corrs=take(cand_ncorrs, best), cand_poses=cand_poses,
        cand_fitness=cand_fitness, cand_views=cand_views,
        cand_valid=cand_valid, cand_verified=cand_verified, obb=box,
        metrics=metrics)


def _tier_cfg(bank: ModelBank, cfg: DetectionConfig) -> DetectionConfig:
    """Two-tier refinement off for banks without a full-CAD model."""
    if cfg.refine_top > 0 and not bank.has_model:
        return dataclasses.replace(cfg, refine_top=0)
    return cfg


def detect_organized(
    xyz_img: torch.Tensor,
    valid: torch.Tensor,
    bank: ModelBank,
    cfg: DetectionConfig = DetectionConfig(),
    block: int = 4,
    half_window: int = 5,
    crop_lo: Optional[torch.Tensor] = None,
    crop_hi: Optional[torch.Tensor] = None,
    viewpoint: Optional[torch.Tensor] = None,
):
    """Raw organized frame float32[H, W, 3] + valid bool[H, W] → 6D pose.

    Every tensor argument must live on the bank's device; the chain runs
    there. Returns ``(DetectionResult, n_selected)``. The segmented crop
    chain (``cfg.segment_scene`` / ``cfg.remove_plane``) is not ported yet:
    ``prepare_scene`` raises on it.
    """
    dev = bank.device
    for t in (xyz_img, valid, crop_lo, crop_hi, viewpoint):
        if t is not None and t.device != dev:
            raise ValueError(f"input on {t.device}, bank on {dev}")
    cfg = _tier_cfg(bank, cfg)
    scene, normals, _, n_sel = ingest_organized_blocks(
        xyz_img, valid, block=block, half_window=half_window,
        capacity=cfg.scene_capacity, crop_lo=crop_lo, crop_hi=crop_hi,
        viewpoint=viewpoint)
    feats = prepare_scene(scene, cfg, normals)
    return detect_with_features(feats, bank, cfg), n_sel
