"""Scene → 6D pose (counterpart of ``tpu_joints/pipelines/detect.py``).

Two entry points share everything after the scene features:

* ``detect_organized`` — raw organized frame → ingest (tile select +
  moment normals [+ the crop chain on the tile lattice: RANSAC plane
  removal, lattice region growing, per-cluster curvature filter]) →
  uniform, ISS or lattice keypoints → SHOT (one shared k_max radius
  gather with the BOARD frames) or FPFH-33 (over the keys or the scene) →
  voting frames;
* ``detect`` — an unorganized cloud (the CLI's file-driven flow) → kNN
  normals (kernel K2; or radius, or anchored: K2 + K1) → [RANSAC plane
  removal] → [region-growing crop over a K2 kNN graph or a voxel lattice +
  per-cluster curvature filter] → uniform or ISS keypoints → the same
  features;

then match against every bank view in one product (1-NN gate or 2-NN
ratio) → Hough or geometric-consistency grouping per view →
view-grouped or peak-grouped candidate cut (per
part, when the bank's view axis concatenates several part banks) → two-tier
ICP (kernel K1) → [global hypothesis verification, ``recognize/hv.py``] →
coverage-dominant ranking + coverage gate → composed pose + OBB (of the
whole aligned view, or of its largest smooth cluster: K2 again).
``good_instances`` lists every distinct accepted instance of a result.

``detect_organized_batch`` runs B frames through the same chain at once:
the front end carries the batch as a leading axis or folds it into an axis
it already batches over (keypoints into SHOT's rows, frames into the match
product's rows). From the Hough grouping on, and in the lattice crop
chain, each frame runs on its own inside the batched pass, exactly as its
own run does it: a sum over B frames' rows adds in another order, and a
rank-deficient Hough fit or an ICP from it carries that last bit to another
pose, so a frame's reply would depend on the frames it was batched with.

Shapes are fixed by the config, every branch is on configuration or on
host facts about the bank (``ModelBank.has_model``), and indexing with a
computed index goes through gathers, so the only host synchronisations are
those of the region growing, which reads its convergence flag once every 8
sweeps: the lattice one (``segment/organized.py``) in ``detect_organized``
with ``cfg.segment_scene``, the graph or voxel one
(``segment/region_growing.py``, ``segment/voxel.py``) in ``detect``'s crop
and the graph one in the clustered OBB (on a batch, those reads happen per
frame). ``detect_organized`` without the crop chain never
synchronises.

The JAX package's one-executable programs are captured CUDA graphs on a
card (``core/graphs.py``): ``detect_organized(fused=True)``,
``detect_organized_batch`` (always), ``detect_fused`` (the unorganized
chain whole, without the crop) and ``multi.detect_parts_organized``. A
replay launches one graph and reads the host once only where a region
growing ran (its change flags, one chunk of sweeps into the chain).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu_joints_torch.config import DetectionConfig
from tpu_joints_torch.core import graphs, spans
from tpu_joints_torch.core.cloud import SENTINEL, Cloud
from tpu_joints_torch.core.ops import top_k
from tpu_joints_torch.core.transforms import compose, invert_rigid
from tpu_joints_torch.features.fpfh import compute_fpfh
from tpu_joints_torch.features.iss import iss_keypoints
from tpu_joints_torch.features.lrf import board_lrf, shot_lrf
from tpu_joints_torch.features.normals import (estimate_normals,
                                               estimate_normals_anchored,
                                               estimate_normals_radius)
from tpu_joints_torch.features.shot import compute_shot
from tpu_joints_torch.filters.filters import (compact_cloud, gather_lanes,
                                              uniform_sample_mask)
from tpu_joints_torch.modelbank.bank import ModelBank
from tpu_joints_torch.neighbors.bruteforce import radius_neighbors
from tpu_joints_torch.pipelines.ingest import (ingest_organized_blocks,
                                               ingest_organized_segmented)
from tpu_joints_torch.recognize.gc import gc_group
from tpu_joints_torch.recognize.hough import Instances, hough_group
from tpu_joints_torch.recognize.hv import verify_hypotheses_counted
from tpu_joints_torch.recognize.icp import icp_multi, scene_coverage_multi
from tpu_joints_torch.recognize.matching import Correspondences
from tpu_joints_torch.recognize.obb import (OBB, oriented_bounding_box,
                                            oriented_bounding_box_clustered)
from tpu_joints_torch.segment.region_growing import (cluster_curvature_filter,
                                                     region_growing)
from tpu_joints_torch.segment.sac import dominant_plane
from tpu_joints_torch.segment.voxel import region_growing_voxel

_BIG = 3.0e38
# lattice keys exist only where a sensor grid does: the organized front end
# supplies them to prepare_scene as key_select
_NO_LATTICE = ('keypoints="lattice" requires the organized front end '
               "(detect_organized / ingest_organized_* with key_group > 0)")


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
    cand_verified: torch.Tensor  # [C] HV mask (= cand_valid when HV is off)
    obb: OBB
    metrics: dict


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def metrics_to_json(metrics: dict) -> dict:
    """DetectionResult.metrics → JSON-safe dict: scalars become floats,
    small per-candidate vectors lists; the [C, 4, 4] candidate pose table
    stays out (consumers get the GOOD subset through ``good_instances``)."""
    return {k: (float(a) if a.ndim == 0 else a.tolist())
            for k, a in ((k, _host(v)) for k, v in metrics.items())
            if k != "cand_full_poses"}


def prepare_scene(scene: Cloud, cfg: DetectionConfig,
                  viewpoint: Optional[torch.Tensor] = None,
                  normals: Optional[torch.Tensor] = None,
                  curvature: Optional[torch.Tensor] = None,
                  key_select: Optional[torch.Tensor] = None) -> SceneFeatures:
    """Normals → [plane removal] → [region-growing crop] → keypoints →
    descriptors (SHOT, or FPFH over the keys or the scene) + voting frames,
    sharing one radius gather when SHOT and BOARD frames use the same
    radius and width.

    Pass ``normals``/``curvature`` to skip the estimate (the organized
    ingest computes them on the sensor grid); else they come from the radius
    support (``cfg.normal_radius > 0``), an anchor subsample
    (``cfg.normal_anchors > 0``) or the k nearest. ``key_select`` (bool[N])
    replaces the keypoint detector (uniform sampling, or ISS).

    The stage ``chain.features`` (``core/spans.py``).
    """
    with spans.stage("chain.features", scene.xyz):
        return _prepare_scene(scene, cfg, viewpoint, normals, curvature,
                              key_select)


def _prepare_scene(scene: Cloud, cfg: DetectionConfig, viewpoint, normals,
                   curvature, key_select) -> SceneFeatures:
    if cfg.descriptor not in ("shot", "fpfh"):
        raise ValueError(f"unknown descriptor {cfg.descriptor!r}")
    if scene.xyz.ndim == 3:
        return _prepare_scene_batch(scene, cfg, normals, curvature, key_select)
    if normals is None or curvature is None:
        if cfg.normal_radius > 0.0:
            normals, curvature = estimate_normals_radius(
                scene, radius=cfg.normal_radius, k_max=cfg.k_max,
                viewpoint=viewpoint)
        elif cfg.normal_anchors > 0:
            normals, curvature = estimate_normals_anchored(
                scene, k=cfg.normal_k, anchors=cfg.normal_anchors,
                viewpoint=viewpoint)
        else:
            normals, curvature = estimate_normals(scene, k=cfg.normal_k,
                                                  viewpoint=viewpoint)
    if cfg.remove_plane:
        scene = scene.with_mask(scene.mask & ~dominant_plane(
            scene, normals, cfg.plane_dist, cfg.plane_min_fraction))
    if cfg.segment_scene:
        if cfg.rg_backend == "voxel":
            clusters = region_growing_voxel(
                scene, normals, curvature,
                leaf=cfg.rg_voxel_leaf or 2.0 * cfg.scene_ss,
                grid=cfg.rg_voxel_grid, smoothness_deg=cfg.rg_smoothness_deg,
                curvature_threshold=cfg.rg_curvature,
                min_cluster_size=cfg.rg_min_cluster, pitch=cfg.rg_voxel_pitch)
        elif cfg.rg_backend == "graph":
            clusters = region_growing(
                scene, normals, curvature, k=min(30, cfg.normal_k),
                smoothness_deg=cfg.rg_smoothness_deg,
                curvature_threshold=cfg.rg_curvature,
                min_cluster_size=cfg.rg_min_cluster, max_edge=cfg.rg_max_edge)
        else:
            raise ValueError(f"unknown rg_backend {cfg.rg_backend!r}")
        scene = scene.with_mask(cluster_curvature_filter(
            clusters, curvature, scene.mask, cfg.cluster_max_curvature))

    if key_select is not None:
        keep = key_select & scene.mask
    elif cfg.keypoints == "iss":
        # the reference's ISS radii, parameterised off scene_ss
        keep = iss_keypoints(
            scene, salient_radius=3.0 * cfg.scene_ss,
            non_max_radius=2.0 * cfg.scene_ss, gamma_21=cfg.iss_gamma_21,
            gamma_32=cfg.iss_gamma_32, k_max=cfg.k_max)
    elif cfg.keypoints == "lattice":
        raise ValueError(_NO_LATTICE)
    else:
        keep = uniform_sample_mask(scene, cfg.scene_ss)
    keys, kidx = compact_cloud(scene, keep, cfg.scene_key_capacity)
    shared = None
    if (cfg.descriptor == "shot" and cfg.rf_frames == "board"
            and cfg.rf_rad == cfg.descr_rad and cfg.rf_k_max == cfg.k_max):
        sidx, swithin, _ = radius_neighbors(keys.xyz, scene.xyz, cfg.descr_rad,
                                            cfg.k_max, source_mask=scene.mask)
        shared = (sidx, swithin)
    if cfg.descriptor == "shot":
        desc, rf, valid = compute_shot(keys, scene, normals,
                                       radius=cfg.descr_rad, k_max=cfg.k_max,
                                       neighbors=shared)
        rf_ok = valid
        need_rf = cfg.rf_frames != "shot"
    else:
        desc, valid = _fpfh(keys, kidx, scene, normals, cfg)
        need_rf = True
    if need_rf:
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
        elif cfg.rf_frames == "shot":
            rf, rf_ok = shot_lrf(keys.xyz, scene.xyz[nidx], nvalid, cfg.rf_rad)
        else:
            raise ValueError(f"unknown rf_frames {cfg.rf_frames!r}")
    return SceneFeatures(cloud=scene, normals=normals, keys=keys, desc=desc,
                         desc_valid=valid, rf=rf, rf_ok=rf_ok)


def _fpfh(keys: Cloud, kidx: torch.Tensor, scene: Cloud,
          normals: torch.Tensor, cfg: DetectionConfig):
    """FPFH-33 of the keypoints (one scene or a batch): over the keypoint
    cloud itself (``fpfh_surface="keys"``, the reference's FPFH_demo) or
    over the scene, gathering ``fpfh_k_max`` neighbours (0 = ``k_max``)."""
    key_normals = gather_lanes(normals, kidx)
    if cfg.fpfh_surface == "keys":
        surface, surface_normals = keys, key_normals
    elif cfg.fpfh_surface == "cloud":
        surface, surface_normals = scene, normals
    else:
        raise ValueError(f"unknown fpfh_surface {cfg.fpfh_surface!r}")
    return compute_fpfh(keys, key_normals, surface, surface_normals,
                        radius=cfg.descr_rad, k_max=cfg.fpfh_k_max or cfg.k_max)


def _prepare_scene_batch(scene: Cloud, cfg: DetectionConfig, normals,
                         curvature, key_select) -> SceneFeatures:
    """``prepare_scene`` for B ingested frames (scene [B, N, 3], normals
    [B, N, 3] from the organized front end; no crop): the uniform keypoint
    sampler and the compaction run over the batch (ISS keys are selected
    frame by frame, lattice keys come in as ``key_select`` [B, N]), each
    support gather is one batched search, SHOT and the voting frames, which
    work row by row, take the B·Ms keypoints as rows over the B·N scene
    lanes, and FPFH takes the batch axis whole (each frame's surface its
    own)."""
    if (normals is None or curvature is None or cfg.remove_plane
            or cfg.segment_scene):
        raise NotImplementedError(
            "a batch of frames takes the organized front end's normals and "
            "no crop chain")
    B, N, _ = scene.xyz.shape
    Ms = cfg.scene_key_capacity
    if key_select is not None:
        keep = key_select & scene.mask
    elif cfg.keypoints == "iss":
        keep = torch.stack([iss_keypoints(
            Cloud(*(t[b] for t in scene)), salient_radius=3.0 * cfg.scene_ss,
            non_max_radius=2.0 * cfg.scene_ss, gamma_21=cfg.iss_gamma_21,
            gamma_32=cfg.iss_gamma_32, k_max=cfg.k_max) for b in range(B)])
    elif cfg.keypoints == "lattice":
        raise ValueError(_NO_LATTICE)
    else:
        keep = uniform_sample_mask(scene, cfg.scene_ss)
    keys, kidx = compact_cloud(scene, keep, Ms)
    lane0 = N * torch.arange(B, device=scene.xyz.device)[:, None]

    def support(radius, k_max):
        idx, within, _ = radius_neighbors(keys.xyz, scene.xyz, radius, k_max,
                                          source_mask=scene.mask)
        return ((idx.long() + lane0[:, :, None]).reshape(B * Ms, k_max),
                within.reshape(B * Ms, k_max))

    rows = Cloud(*(t.reshape(B * Ms, *t.shape[2:]) for t in keys))
    flat = Cloud(*(t.reshape(B * N, *t.shape[2:]) for t in scene))
    flat_normals = normals.reshape(B * N, 3)
    shared = None
    if (cfg.descriptor == "shot" and cfg.rf_frames == "board"
            and cfg.rf_rad == cfg.descr_rad and cfg.rf_k_max == cfg.k_max):
        shared = support(cfg.descr_rad, cfg.k_max)
    if cfg.descriptor == "shot":
        desc, rf, valid = compute_shot(
            rows, flat, flat_normals, radius=cfg.descr_rad, k_max=cfg.k_max,
            neighbors=shared or support(cfg.descr_rad, cfg.k_max))
        rf_ok = valid
    else:
        desc, valid = _fpfh(keys, kidx, scene, normals, cfg)
    if cfg.descriptor != "shot" or cfg.rf_frames != "shot":
        nidx, nwithin = shared or support(cfg.rf_rad, cfg.rf_k_max)
        nvalid = nwithin & rows.mask[:, None]
        if cfg.rf_frames == "board":
            rf, rf_ok = board_lrf(
                rows.xyz, flat_normals[(kidx + lane0).reshape(-1)],
                flat.xyz[nidx], flat_normals[nidx], nvalid, cfg.rf_rad)
        elif cfg.rf_frames == "shot":
            rf, rf_ok = shot_lrf(rows.xyz, flat.xyz[nidx], nvalid, cfg.rf_rad)
        else:
            raise ValueError(f"unknown rf_frames {cfg.rf_frames!r}")
    return SceneFeatures(
        cloud=scene, normals=normals, keys=keys, desc=desc.reshape(B, Ms, -1),
        desc_valid=valid.reshape(B, Ms), rf=rf.reshape(B, Ms, 3, 3),
        rf_ok=rf_ok.reshape(B, Ms))


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
    [Ms, V·Mk] descriptor-distance product, gated by ``cfg.match_mode``
    ("nn": absolute threshold; "ratio": d1/d2 <= τ over the two nearest,
    in ``lax.top_k``'s order); fields are [V, Ms]. B scenes
    (``scene_desc [B, Ms, D]``) share the one product, [B·Ms, V·Mk]; the
    fields are then [B·V, Ms], the views of frame b at [b·V, (b+1)·V)."""
    return _per_view(*_match_columns(scene_desc, scene_valid, bank_desc,
                                     bank_valid, cfg), scene_desc.shape[-2])


def _match_columns(scene_desc: torch.Tensor, scene_valid: torch.Tensor,
                   bank_desc: torch.Tensor, bank_valid: torch.Tensor,
                   cfg: DetectionConfig):
    """:func:`match_bank`'s (model_idx, valid, dist_sq), each [B·Ms, V]
    (scene key by view). The view-sharded batch concatenates its model
    shards' along the view axis, which lays them out as one call over every
    view would."""
    V, Mk, D = bank_desc.shape
    if scene_desc.shape[-1] != D:
        raise ValueError(
            f"scene descriptors are {scene_desc.shape[-1]}-D, the bank's "
            f"{D}-D: build the bank with the configuration's descriptor")
    flat = bank_desc.reshape(V * Mk, D)
    scene_desc = scene_desc.reshape(-1, D)
    scene_valid = scene_valid.reshape(-1)
    s2 = (scene_desc * scene_desc).sum(-1, keepdim=True)
    b2 = (flat * flat).sum(-1)
    d = s2 + b2[None, :] - 2.0 * (scene_desc @ flat.T)
    d = torch.clamp_min(d, 0.0).reshape(-1, V, Mk)
    d = torch.where(bank_valid[None], d, _BIG)
    if cfg.match_mode == "nn":
        d1, idx = d.min(dim=-1)                   # first index of the minimum
        ok = scene_valid[:, None] & (d1 < cfg.match_threshold)
    elif cfg.match_mode == "ratio":
        neg2, idx2 = top_k(-d, 2)                 # [Ms, V, 2], ties to low index
        d1, d2 = -neg2[..., 0], -neg2[..., 1]
        idx = idx2[..., 0]
        ok = (scene_valid[:, None]
              & (d1 <= cfg.ratio * cfg.ratio * torch.clamp_min(d2, 1e-20))
              & (d2 < 1e30))
    else:
        raise ValueError(f"unknown match mode {cfg.match_mode!r}")
    return idx, ok, d1


def _per_view(idx: torch.Tensor, ok: torch.Tensor, d1: torch.Tensor,
              Ms: int) -> Correspondences:
    """:func:`_match_columns`' fields [B·Ms, V] as Correspondences
    [B·V, Ms]."""
    V = idx.shape[-1]

    def per_view(t):
        return t.reshape(-1, Ms, V).transpose(1, 2).reshape(-1, Ms)

    return Correspondences(model_idx=per_view(idx), valid=per_view(ok),
                           dist_sq=per_view(d1))


def _group_all_views(feats: SceneFeatures, bank: ModelBank,
                     corrs: Correspondences, cfg: DetectionConfig) -> Instances:
    """Hough voting or geometric-consistency grouping over every view (B
    frames: the bank's views B times, frame by frame)."""
    return _group_views_arrays(feats, bank.key_xyz, bank.rf, bank.key_valid,
                               corrs, cfg)


def _group_views_arrays(feats: SceneFeatures, key_xyz: torch.Tensor,
                        rf: torch.Tensor, key_valid: torch.Tensor,
                        corrs: Correspondences,
                        cfg: DetectionConfig) -> Instances:
    """:func:`_group_all_views` on the per-view arrays of any block of views
    (key_xyz [V, Mk, 3], rf [V, Mk, 3, 3], key_valid [V, Mk]; ``corrs``
    over the same views): the view-sharded batch (``distributed.batch``)
    groups each model shard's own views."""
    n_views = key_xyz.shape[0]
    if feats.keys.xyz.ndim == 3:      # B frames: the bank's views B times
        B = feats.keys.xyz.shape[0]
        key_xyz, rf, key_valid = (t.repeat(B, *[1] * (t.ndim - 1))
                                  for t in (key_xyz, rf, key_valid))
    if cfg.algorithm == "gc":
        scene_keys = feats.keys.xyz
        if scene_keys.ndim == 3:      # every view sees its own frame
            scene_keys = scene_keys.repeat_interleave(n_views, 0)
        return gc_group(scene_keys, key_xyz, key_valid, corrs,
                        gc_size=cfg.cg_size, gc_threshold=cfg.cg_thresh,
                        max_instances=cfg.max_instances_per_view)
    if cfg.algorithm != "hough":
        raise ValueError(f"unknown grouping algorithm {cfg.algorithm!r}")
    return hough_group(
        feats.keys.xyz, feats.rf, feats.rf_ok, key_xyz, rf, key_valid,
        key_valid, corrs,
        bin_size=cfg.cg_size, threshold=cfg.cg_thresh,
        max_instances=cfg.max_instances_per_view,
        use_distance_weight=cfg.use_distance_weight,
        split_rotation_modes=cfg.split_rotation_modes)


def detect_with_features(feats: SceneFeatures, bank: ModelBank,
                         cfg: DetectionConfig,
                         n_parts: int = 1) -> DetectionResult:
    """Match → group → refine against the bank. ``n_parts > 1``: the bank's
    view axis concatenates that many part banks sharing one full CAD (see
    ``refine_instances``). The stages ``chain.match`` (match and grouping)
    and ``chain.refine`` (``core/spans.py``)."""
    with spans.stage("chain.match", feats.desc):
        corrs = match_bank(feats.desc, feats.desc_valid, bank.desc,
                           bank.key_valid, cfg)
        inst = _group_all_views(feats, bank, corrs, cfg)
    n_corr = corrs.valid.reshape(-1, bank.n_views * corrs.valid.shape[1]).sum(
        1, dtype=torch.int32)
    if feats.cloud.xyz.ndim == 2:
        n_corr = n_corr[0]
    with spans.stage("chain.refine", feats.desc):
        return refine_instances(feats, bank, inst, n_corr, cfg,
                                n_parts=n_parts)


def _candidate_cut(inst: Instances, cfg: DetectionConfig, n_parts: int):
    """Top ``max_candidates`` (view, peak) slots per part: (top_flat
    int64[C] into the flattened [V·P] instance table, top_votes [C]), part
    p's candidates at [p·Cp, (p+1)·Cp). Peak-grouped
    (``cfg.peak_grouped_candidates``, with the rotation-mode split): adjacent
    slot pairs are one translation peak's two rotation modes; all (view,
    peak) pairs are ranked together and both modes of the top Cp/2 enter.
    View-grouped (``cfg.view_grouped_candidates``): the strongest bin picks
    the view and all of that view's bins enter; else the plain top-k over
    the part's slots. A batch of frames is cut like parts: ``n_parts``
    counts every (frame, part) group of the folded view axis."""
    dev = inst.votes.device
    V, P = inst.votes.shape
    if V % n_parts:
        raise ValueError(f"bank views ({V}) must split evenly into "
                         f"{n_parts} parts")
    Vp = V // n_parts
    Cp = min(cfg.max_candidates, Vp * P)
    votes = torch.where(inst.valid, inst.votes, -1.0).reshape(n_parts, Vp * P)
    if (cfg.peak_grouped_candidates and cfg.split_rotation_modes
            and P % 2 == 0 and Cp % 2 == 0):
        strength = votes.reshape(n_parts, Vp * P // 2, 2).amax(2)
        _, top_pairs = top_k(strength, Cp // 2)             # [n_parts, Kp]
        top_local = (top_pairs[:, :, None] * 2
                     + torch.arange(2, device=dev)).reshape(n_parts, Cp)
        top_votes = votes.gather(1, top_local)
    elif cfg.view_grouped_candidates and P > 1 and Cp % P == 0:
        strength = votes.reshape(n_parts, Vp, P).amax(2)
        _, top_views = top_k(strength, Cp // P)             # [n_parts, Kv]
        top_local = (top_views[:, :, None] * P
                     + torch.arange(P, device=dev)).reshape(n_parts, Cp)
        top_votes = votes.gather(1, top_local)
    else:
        top_votes, top_local = top_k(votes, Cp)             # [n_parts, Cp]
    top_flat = top_local + (Vp * P) * torch.arange(n_parts, device=dev)[:, None]
    return top_flat.reshape(-1), top_votes.reshape(-1)


def _registered_views(bank: ModelBank, views: torch.Tensor,
                      poses: torch.Tensor):
    """The bank views ``views`` [C] moved by ``poses`` [C, 4, 4]: (xyz
    [C, Nv, 3], mask [C, Nv])."""
    return _register(bank.view_xyz[views], bank.view_mask[views], poses)


def _register(view_xyz: torch.Tensor, view_mask: torch.Tensor,
              poses: torch.Tensor):
    xyz = torch.einsum("cij,cnj->cni", poses[:, :3, :3], view_xyz) \
        + poses[:, None, :3, 3]
    return xyz, view_mask


class BankRows:
    """The per-view rows a refine reads, of the candidate views
    ``views`` [Ct] of ``bank``: ``view_rows(field)`` is
    ``bank.field[views]`` and ``view_rows(field, at)`` the rows of
    candidate positions ``at``. The view-sharded batch hands
    ``refine_candidates`` its own rows object, gathered from the shards
    that own the views."""

    def __init__(self, bank: ModelBank, views: torch.Tensor):
        self.bank = bank
        self.views = views

    def __call__(self, field: str, at: Optional[torch.Tensor] = None):
        views = self.views if at is None else self.views[at]
        return getattr(self.bank, field)[views]


def refine_instances(feats: SceneFeatures, bank: ModelBank, inst: Instances,
                     n_corr_total: torch.Tensor, cfg: DetectionConfig,
                     n_parts: int = 1) -> DetectionResult:
    """Candidate cut → (two-tier) ICP → [hypothesis verification] →
    full-CAD ranking with scene coverage → winner, acceptance gates, OBB.

    ``n_parts > 1``: the bank's view axis is a concatenation of that many
    part banks sharing one full CAD (``pipelines/multi.py``); the cut takes
    ``max_candidates`` per part, so a vote-rich part cannot crowd the other
    out, and every later stage runs on the pooled ``n_parts ·
    max_candidates`` field unchanged. The winner's part is ``view_idx //
    (V / n_parts)``.

    B frames (``feats`` with a leading batch axis, ``inst`` over B·V views
    in frame order): the frames' candidate fields are cut like parts, frame
    b's at [b·C, (b+1)·C), and each frame is refined on its own
    (:func:`refine_candidates`); every leaf of the result gains a leading
    B."""
    B = feats.cloud.xyz.shape[0] if feats.cloud.xyz.ndim == 3 else 1
    Vt, P = inst.votes.shape
    top_flat, top_votes = _candidate_cut(inst, cfg, B * n_parts)
    cand_views = (top_flat // P) % (Vt // B)
    return refine_candidates(feats, bank, BankRows(bank, cand_views), inst,
                             top_flat, top_votes, cand_views, n_corr_total,
                             cfg)


def _verify_candidates(feats: SceneFeatures, view_rows,
                       cand_poses: torch.Tensor, cand_valid: torch.Tensor,
                       cand_views: torch.Tensor, cfg: DetectionConfig):
    """GO-HV over one frame's C candidates registered at their tier-1 view
    poses: (verified bool[C], the ``hv_*`` metrics) — what was judged
    (``hv_views``, ``hv_view_poses``, ``hv_valid``), the verdict
    (``hv_verified``), the counts its cost was made of (``hv_explained``,
    ``hv_outliers``; ``hv_instance_points``, the valid registered points of
    the valid hypotheses) and the search's ``hv_steps`` and
    ``hv_steps_improved``. All stay on the device."""
    inst_xyz, inst_mask = _register(view_rows("view_xyz"),
                                    view_rows("view_mask"), cand_poses)
    verified, counts = verify_hypotheses_counted(
        inst_xyz, inst_mask, cand_valid, feats.cloud,
        inlier_threshold=cfg.hv_inlier_threshold,
        outlier_regularizer=cfg.hv_regularizer,
        occlusion_threshold=cfg.hv_occlusion_threshold)
    metrics = {
        "hv_views": cand_views.to(torch.int32),
        "hv_view_poses": cand_poses,
        "hv_valid": cand_valid,
        "hv_verified": verified,
        "hv_explained": counts["explained"],
        "hv_outliers": counts["outliers"],
        "hv_instance_points": (inst_mask & cand_valid[:, None]).sum(
            dtype=torch.int32),
        "hv_steps": counts["steps"],
        "hv_steps_improved": counts["improved"],
    }
    return verified, metrics


class _FrameRows:
    """A batch's ``view_rows`` seen from one frame: its candidates are the
    batch's [lo, lo + C)."""

    def __init__(self, rows, lo: int, C: int):
        self.rows, self.lo, self.C = rows, lo, C

    def __call__(self, field: str, at: Optional[torch.Tensor] = None):
        if at is None:
            return self.rows(field)[self.lo:self.lo + self.C]
        return self.rows(field, at + self.lo)


def _refine_frames(feats: SceneFeatures, bank: ModelBank, view_rows,
                   inst: Instances, top_flat: torch.Tensor,
                   top_votes: torch.Tensor, cand_views: torch.Tensor,
                   n_corr_total: torch.Tensor,
                   cfg: DetectionConfig) -> DetectionResult:
    """:func:`refine_candidates` of B frames, each frame on its own and as
    its own run refines it; every leaf of the result gains a leading B."""
    B = feats.cloud.xyz.shape[0]
    C = top_flat.shape[0] // B
    V = inst.votes.shape[0] // B
    P = inst.votes.shape[1]
    outs = []
    for b in range(B):
        frame = SceneFeatures(*(
            Cloud(*(t[b] for t in f)) if isinstance(f, Cloud)
            else None if f is None else f[b] for f in feats))
        cut = slice(b * C, (b + 1) * C)
        outs.append(refine_candidates(
            frame, bank, _FrameRows(view_rows, b * C, C),
            Instances(*(t[b * V:(b + 1) * V] for t in inst)),
            top_flat[cut] - b * V * P, top_votes[cut], cand_views[cut],
            n_corr_total[b], cfg))
    first = outs[0]
    return first._replace(
        **{f: torch.stack([getattr(o, f) for o in outs])
           for f in first._fields if f not in ("obb", "metrics")},
        obb=OBB(*(torch.stack(t) for t in zip(*(o.obb for o in outs)))),
        metrics={k: (torch.stack([o.metrics[k] for o in outs])
                     if isinstance(v, torch.Tensor) else v)
                 for k, v in first.metrics.items()})


def refine_candidates(feats: SceneFeatures, bank: ModelBank, view_rows,
                      inst: Instances, top_flat: torch.Tensor,
                      top_votes: torch.Tensor, cand_views: torch.Tensor,
                      n_corr_total: torch.Tensor,
                      cfg: DetectionConfig) -> DetectionResult:
    """Everything of :func:`refine_instances` after the candidate cut:
    ``top_flat`` / ``top_votes`` [B·C] from ``_candidate_cut``,
    ``cand_views`` their bank views, ``view_rows`` their per-view bank rows
    (:class:`BankRows` or the view-sharded batch's gather); ``bank``
    supplies the full CAD, ``has_model`` and the ICP width only.

    B frames (``feats`` with a leading batch axis) are refined frame by
    frame (:func:`_refine_frames`), each exactly as its own run: folded
    into one candidate axis, the ICP's, the coverage's and the box's sums
    over B·C rows add in another order than over C, and an ICP from an
    ill-conditioned Hough start carries that last bit to another pose. The
    body below works on one frame behind a leading frame axis of one."""
    if feats.cloud.xyz.ndim == 3:
        return _refine_frames(feats, bank, view_rows, inst, top_flat,
                              top_votes, cand_views, n_corr_total, cfg)
    dev = inst.votes.device
    B = 1
    Vt, P = inst.votes.shape
    Ct = top_flat.shape[0]                       # candidates of all frames
    C = Ct // B
    frame0 = C * torch.arange(B, device=dev)[:, None]
    cand_valid = top_votes > 0.0
    cand_init = inst.poses.reshape(Vt * P, 4, 4)[top_flat]
    cand_ncorrs = inst.n_corrs.reshape(Vt * P)[top_flat]

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
        view_rows("icp_xyz")[:, ::stride], view_rows("icp_mask")[:, ::stride],
        feats.cloud, cand_init, iterations=t1_view_iters,
        point_to_plane=cfg.icp_point_to_plane,
        target_normals=feats.normals if cfg.icp_point_to_plane else None,
        with_fitness=not (two_tier and cfg.tier1_skip_view_fitness), **icp_kw)
    cand_fitness = torch.where(cand_valid, cand_fitness, _BIG)

    hv_metrics = {}
    if cfg.hv_enabled:
        with spans.stage("chain.hv", cand_poses):
            cand_verified, hv_metrics = _verify_candidates(
                feats, view_rows, cand_poses, cand_valid, cand_views, cfg)
        effective_fitness = torch.where(cand_verified, cand_fitness, _BIG)
    else:
        cand_verified = cand_valid
        effective_fitness = cand_fitness

    full_cands = compose(cand_poses, view_rows("poses"))
    coverage = unexplained = None
    in_top = None
    if has_model and (cfg.select_by_model_fitness or cfg.final_icp_iterations > 0):
        Nm = bank.model_xyz.shape[0]
        rows = (Ni + stride - 1) // stride
        m_xyz, m_mask = _model_at_capacity(bank, rows)
        polished, model_fit = icp_multi(
            m_xyz.expand(Ct, rows, 3), m_mask.expand(Ct, rows), feats.cloud,
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
            _, top_r = top_k(-ranked.reshape(B, C), R)       # per frame
            top_r = (top_r + frame0).reshape(B * R)
            m2_xyz, m2_mask = _model_at_capacity(bank, Ni)
            polished2, fit2 = icp_multi(
                m2_xyz.expand(B * R, Ni, 3), m2_mask.expand(B * R, Ni),
                feats.cloud, polished[top_r],
                iterations=cfg.final_icp_iterations,
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
            in_top = torch.zeros(Ct, dtype=torch.bool, device=dev).index_fill(
                0, top_r, True)
            effective_fitness = torch.where(in_top, effective_fitness, _BIG)
        if cfg.select_by_model_fitness:
            effective_fitness = ranked
    else:
        polished, model_fit = full_cands, cand_fitness

    # the winner of every frame: the first minimum of its candidates
    best = effective_fitness.reshape(B, C).argmin(1) + frame0[:, 0]     # [B]
    view_idx = cand_views[best]
    view_pose = cand_poses[best]
    fitness = cand_fitness[best]
    if cfg.final_icp_iterations > 0 and has_model:
        full_pose = polished[best]
        full_fitness = model_fit[best]
        accepted = full_fitness < cfg.final_accept_fitness
    elif cfg.final_icp_iterations > 0:
        full_pose = full_cands[best]
        full_fitness = fitness
        accepted = fitness < cfg.accept_fitness
    else:
        full_pose = full_cands[best]
        full_fitness = (model_fit[best]
                        if has_model and cfg.select_by_model_fitness else fitness)
        accepted = fitness < cfg.accept_fitness
    if two_tier:
        # re-derive the view→scene pose from the tier-2 polished CAD pose
        view_pose = compose(full_pose, invert_rigid(view_rows("poses", best)))
    accepted = accepted & cand_valid[best] & cand_verified[best]
    if cfg.coverage_accept > 0.0 and has_model:
        if unexplained is None:
            raise ValueError(
                "coverage_accept > 0 requires rank_scene_coverage=True plus a "
                "ranking stage (select_by_model_fitness=True or "
                "final_icp_iterations > 0)")
        # the winner must EXPLAIN the scene: few points far from the model
        accepted = accepted & (unexplained[best] < cfg.coverage_accept)

    view_xyz = view_rows("view_xyz", best)                   # [B, Nv, 3]
    aligned = Cloud(
        xyz=torch.einsum("bnj,bij->bni", view_xyz, view_pose[:, :3, :3])
        + view_pose[:, None, :3, 3],
        mask=view_rows("view_mask", best), rgb=torch.zeros_like(view_xyz))
    if cfg.obb_largest_cluster:
        # the reference's OBB: box the aligned view's dominant smooth
        # cluster (its region growing reads the host: frame by frame)
        boxes = [oriented_bounding_box_clustered(
            Cloud(*(t[b] for t in aligned)),
            min_cluster_size=cfg.rg_min_cluster) for b in range(B)]
        box = OBB(*(torch.stack(f) for f in zip(*boxes)))
    else:
        box = oriented_bounding_box(aligned)

    def per_frame(t):                 # [B·C, ...] → [B, C, ...]
        return t.reshape(B, C, *t.shape[1:])

    metrics = {
        "scene_points": feats.cloud.mask.reshape(B, -1).sum(1, dtype=torch.int32),
        "scene_keypoints": feats.keys.mask.reshape(B, -1).sum(
            1, dtype=torch.int32),
        "valid_descriptors": feats.desc_valid.reshape(B, -1).sum(
            1, dtype=torch.int32),
        "correspondences": n_corr_total.reshape(B),
        "instances": inst.valid.reshape(B, -1).sum(1, dtype=torch.int32),
        "best_votes": per_frame(top_votes).amax(1),
    }
    if coverage is not None:
        metrics["best_coverage"] = coverage[best]
        metrics["cand_coverage"] = per_frame(coverage)
        metrics["best_unexplained"] = unexplained[best]
        metrics["cand_unexplained"] = per_frame(unexplained)
    metrics["cand_full_poses"] = per_frame(polished if has_model else full_cands)
    metrics["cand_full_fitness"] = per_frame(model_fit if has_model
                                             else cand_fitness)
    metrics["cand_tier2"] = per_frame(
        in_top if in_top is not None
        else torch.ones(Ct, dtype=torch.bool, device=dev))
    res = DetectionResult(
        full_pose=full_pose, view_pose=view_pose, fitness=fitness,
        full_fitness=full_fitness, accepted=accepted, view_idx=view_idx,
        n_corrs=cand_ncorrs[best], cand_poses=per_frame(cand_poses),
        cand_fitness=per_frame(cand_fitness), cand_views=per_frame(cand_views),
        cand_valid=per_frame(cand_valid),
        cand_verified=per_frame(cand_verified), obb=box, metrics=metrics)
    res = res._replace(                # one frame: no leading axis
        **{f: getattr(res, f)[0] for f in res._fields
           if f not in ("obb", "metrics")},
        obb=OBB(*(t[0] for t in box)),
        metrics={k: v[0] for k, v in metrics.items()} | hv_metrics)
    res.metrics["has_model"] = has_model
    return res


def good_instances(res: DetectionResult, cfg: DetectionConfig,
                   min_separation: float = 0.05):
    """All distinct GOOD instances of a (one-frame) detection, on the host:
    every candidate that is valid, verified, acceptance-grade (a tier-2
    survivor under two-tier refinement) and passes the gates the winner is
    held to (the fitness gate and, where the coverage was computed, the
    unexplained-fraction gate), taken best first in the winner's rank order
    (coverage + 0.1·fitness) and deduplicated by location: candidates whose
    composed translations lie within ``min_separation`` metres are one
    instance.

    Returns a best-first list of dicts with keys ``pose`` (CAD → scene,
    [4, 4] numpy), ``view_idx``, ``fitness``, ``candidate``. Results without
    a candidate pose table (the multi-part ones) give ``[]``."""
    if "cand_full_poses" not in res.metrics:
        return []
    poses = _host(res.metrics["cand_full_poses"])
    has_model = bool(_host(res.metrics.get("has_model", True)))
    # the winner's acceptance quantity exactly: full-CAD fitness only when a
    # final polish ran on a bank that stores the CAD, else the view fitness
    if cfg.final_icp_iterations > 0 and has_model:
        fitness = _host(res.metrics["cand_full_fitness"])
        gate = cfg.final_accept_fitness
    else:
        fitness = _host(res.cand_fitness)
        gate = cfg.accept_fitness
    ok = _host(res.cand_valid) & _host(res.cand_verified) & (fitness < gate)
    if "cand_tier2" in res.metrics:
        ok &= _host(res.metrics["cand_tier2"])
    if (cfg.coverage_accept > 0.0 and has_model
            and "cand_unexplained" in res.metrics):
        ok &= _host(res.metrics["cand_unexplained"]) < cfg.coverage_accept
    views = _host(res.cand_views)
    if "cand_coverage" in res.metrics:
        order_metric = _host(res.metrics["cand_coverage"]) + 0.1 * fitness
    else:
        order_metric = fitness
    kept = []
    for i in np.argsort(order_metric):
        if not ok[i]:
            continue
        T = poses[i]
        if any(np.linalg.norm(T[:3, 3] - k["pose"][:3, 3]) < min_separation
               for k in kept):
            continue
        kept.append({"pose": T, "view_idx": int(views[i]),
                     "fitness": float(fitness[i]), "candidate": int(i)})
    return kept


def _strip_crop(cfg: DetectionConfig) -> DetectionConfig:
    """The organized front end owns the crop chain; the detection must not
    run it again on the cropped working set."""
    if cfg.segment_scene or cfg.remove_plane:
        return dataclasses.replace(cfg, segment_scene=False,
                                   remove_plane=False)
    return cfg


def organized_features(xyz_img, valid, cfg: DetectionConfig, block: int,
                       half_window: int, crop_lo, crop_hi,
                       viewpoint) -> Tuple[SceneFeatures, torch.Tensor]:
    """Raw organized frame → (SceneFeatures, n_selected): the ingest, with
    the lattice crop chain when cfg asks for it and the lattice keypoints
    with ``cfg.keypoints == "lattice"`` (one per ``cfg.key_group``² tiles),
    then ``prepare_scene``. A batch of frames [B, H, W, 3] runs the crop
    chain frame by frame (its lattice region growing reads the host per
    frame) and stacks the working sets. The ingest is the stage
    ``chain.ingest`` (``core/spans.py``)."""
    kg = cfg.key_group if cfg.keypoints == "lattice" else 0
    with spans.stage("chain.ingest", xyz_img):
        if (cfg.segment_scene or cfg.remove_plane) and xyz_img.ndim == 4:
            frames = [ingest_organized_segmented(
                img, vmask, cfg, block=block, half_window=half_window,
                crop_lo=crop_lo, crop_hi=crop_hi, viewpoint=viewpoint,
                key_group=kg)
                for img, vmask in zip(xyz_img, valid)]
            clouds, *rest = zip(*frames)
            out = (Cloud(*(torch.stack(f) for f in zip(*clouds))),
                   *(torch.stack(t) for t in rest))
        elif cfg.segment_scene or cfg.remove_plane:
            out = ingest_organized_segmented(
                xyz_img, valid, cfg, block=block, half_window=half_window,
                crop_lo=crop_lo, crop_hi=crop_hi, viewpoint=viewpoint,
                key_group=kg)
        else:
            out = ingest_organized_blocks(
                xyz_img, valid, block=block, half_window=half_window,
                capacity=cfg.scene_capacity, crop_lo=crop_lo, crop_hi=crop_hi,
                viewpoint=viewpoint, key_group=kg)
    scene, normals, curvature, n_sel = out[:4]
    key_select = out[4] if kg > 0 else None
    feats = prepare_scene(scene, _strip_crop(cfg), viewpoint, normals,
                          curvature, key_select=key_select)
    return feats, n_sel


def _tier_cfg(bank: ModelBank, cfg: DetectionConfig) -> DetectionConfig:
    """Two-tier refinement off for banks without a full-CAD model."""
    if cfg.refine_top > 0 and not bank.has_model:
        return dataclasses.replace(cfg, refine_top=0)
    return cfg


def _check_devices(dev: torch.device, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"input on {t.device}, bank on {dev}")


def detect(scene: Cloud, bank: ModelBank,
           cfg: DetectionConfig = DetectionConfig(),
           viewpoint: Optional[torch.Tensor] = None,
           scene_normals: Optional[torch.Tensor] = None,
           scene_curvature: Optional[torch.Tensor] = None) -> DetectionResult:
    """One unorganized scene cloud → best 6D pose (plus all candidates).

    Every tensor argument must live on the bank's device; the chain runs
    there. Normals and curvature are estimated (k = ``cfg.normal_k``)
    unless both are given.
    """
    _check_devices(bank.device, scene.xyz, scene.mask, viewpoint,
                   scene_normals, scene_curvature)
    cfg = _tier_cfg(bank, cfg)
    feats = prepare_scene(scene, cfg, viewpoint, scene_normals,
                          scene_curvature)
    return detect_with_features(feats, bank, cfg)


def _fused_chain(xyz, mask, rgb, viewpoint, *, bank, cfg):
    feats = prepare_scene(Cloud(xyz=xyz, mask=mask, rgb=rgb), cfg, viewpoint)
    return detect_with_features(feats, bank, cfg)


def detect_fused(scene: Cloud, bank: ModelBank,
                 cfg: DetectionConfig = DetectionConfig(),
                 viewpoint: Optional[torch.Tensor] = None) -> DetectionResult:
    """Single-dispatch variant of :func:`detect`: on a card the whole
    unorganized chain (normals, keypoints, descriptors, match, group,
    refine) is one captured CUDA graph, replayed for every call with the
    same configuration, shapes and bank (``core/graphs.py``); on the CPU it
    runs eagerly. As the JAX package's ``detect_fused``, it takes the
    configuration as given (no two-tier switch-off for model-less banks).

    Raises ``ValueError`` for ``cfg.segment_scene``: the graph and the voxel
    region growing of the crop read the host once per 8 sweeps inside
    ``prepare_scene`` and are not captured yet (ROADMAP.md, queue 1, item
    20: ``detect_fused`` with the graph and voxel crops); ``detect`` runs
    those configurations.
    """
    if cfg.segment_scene:
        raise ValueError(
            f"detect_fused cannot capture the region-growing crop "
            f"(segment_scene with rg_backend={cfg.rg_backend!r}): its growing "
            f"reads the host once per 8 sweeps inside prepare_scene "
            f"(ROADMAP.md, queue 1, item 20); run detect() for this "
            f"configuration")
    _check_devices(bank.device, scene.xyz, scene.mask, scene.rgb, viewpoint)
    chain = functools.partial(_fused_chain, bank=bank, cfg=cfg)
    return graphs.run("detect_fused", chain,
                      (scene.xyz, scene.mask, scene.rgb, viewpoint), cfg, bank)


def _organized_chain(xyz_img, valid, crop_lo, crop_hi, viewpoint, *, bank,
                     cfg, block, half_window):
    feats, n_sel = organized_features(xyz_img, valid, cfg, block, half_window,
                                      crop_lo, crop_hi, viewpoint)
    return detect_with_features(feats, bank, _strip_crop(cfg)), n_sel


def _organized(xyz_img, valid, bank, cfg, block, half_window, crop_lo,
               crop_hi, viewpoint):
    """(the organized chain bound to all but its tensors, those tensors, the
    static part of a graph's key) of one call."""
    _check_devices(bank.device, xyz_img, valid, crop_lo, crop_hi, viewpoint)
    cfg = _tier_cfg(bank, cfg)
    chain = functools.partial(_organized_chain, bank=bank, cfg=cfg,
                              block=block, half_window=half_window)
    return (chain, (xyz_img, valid, crop_lo, crop_hi, viewpoint),
            (cfg, block, half_window))


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
    fused: bool = False,
):
    """Raw organized frame float32[H, W, 3] + valid bool[H, W] → 6D pose.

    Every tensor argument must live on the bank's device; the chain runs
    there. With ``cfg.segment_scene`` / ``cfg.remove_plane`` the crop chain
    runs on the sensor lattice inside the ingest
    (``ingest_organized_segmented``). With ``fused=True`` the chain on a
    card is one captured CUDA graph (``core/graphs.py``), replayed for every
    frame of the same configuration, shapes and bank: the one-dispatch
    program the JAX package serves and benches. Returns
    ``(DetectionResult, n_selected)``.
    """
    chain, args, static = _organized(xyz_img, valid, bank, cfg, block,
                                     half_window, crop_lo, crop_hi, viewpoint)
    if fused:
        return graphs.run("detect_organized", chain, args, static, bank)
    return chain(*args)


def _check_batch(xyz_imgs: torch.Tensor, valids: torch.Tensor) -> None:
    if xyz_imgs.ndim != 4 or valids.ndim != 3:
        raise ValueError(f"expected [B, H, W, 3] frames and [B, H, W] valids, "
                         f"got {tuple(xyz_imgs.shape)} and {tuple(valids.shape)}")


def detect_organized_batch(
    xyz_imgs: torch.Tensor,
    valids: torch.Tensor,
    bank: ModelBank,
    cfg: DetectionConfig = DetectionConfig(),
    block: int = 4,
    half_window: int = 5,
    crop_lo: Optional[torch.Tensor] = None,
    crop_hi: Optional[torch.Tensor] = None,
    viewpoint: Optional[torch.Tensor] = None,
):
    """B raw organized frames float32[B, H, W, 3] + valids bool[B, H, W] →
    B poses in one pass: the steady state of a server that drains its queue
    into a batch. Every stage takes the batch (see the module docstring);
    the crop chain (``cfg.segment_scene`` / ``cfg.remove_plane``), the
    hypothesis verification and the clustered box run frame by frame inside
    it. Each frame's result equals its own ``detect_organized`` run up to
    the rounding of the batched products. On a card the pass is one
    captured CUDA graph per batch size (``core/graphs.py``), as the JAX
    package runs it as one program.

    Returns ``(DetectionResult, n_selected[B])`` with a leading batch axis
    on every leaf.
    """
    _check_batch(xyz_imgs, valids)
    chain, args, static = _organized(xyz_imgs, valids, bank, cfg, block,
                                     half_window, crop_lo, crop_hi, viewpoint)
    return graphs.run("detect_organized_batch", chain, args, static, bank)


def _detect_organized_batch_eager(xyz_imgs, valids, bank, cfg, block=4,
                                  half_window=5, crop_lo=None, crop_hi=None,
                                  viewpoint=None):
    """``detect_organized_batch`` run eagerly on any device: the mesh path,
    which runs each card's share on that card's own thread, takes it."""
    _check_batch(xyz_imgs, valids)
    chain, args, _ = _organized(xyz_imgs, valids, bank, cfg, block,
                                half_window, crop_lo, crop_hi, viewpoint)
    return chain(*args)
