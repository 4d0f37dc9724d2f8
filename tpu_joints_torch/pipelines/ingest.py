"""Raw organized-frame ingestion (counterpart of
``tpu_joints/pipelines/ingest.py``, ``key_group=0`` route), plain or with
the scene-crop chain run on the tile lattice before compaction.

One point per ``block``×``block`` pixel tile — the valid pixel nearest the
tile mean, ties to the larger pixel index — with normals and curvature from
the shared box-filtered moment maps. Tile reductions are reshape-and-reduce
over the tiles, summing each tile's pixels in row-major order.
``ingest_organized_blocks`` also takes a batch of frames [B, H, W, 3]: every
step works on the last two (pixel or tile) axes, so the batch rides along.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_joints_torch.core.cloud import SENTINEL, Cloud
from tpu_joints_torch.features.eigen3 import eigh3x3
from tpu_joints_torch.features.organized import _cov_from_moments, organized_moments
from tpu_joints_torch.filters.filters import compact_indices, gather_lanes
from tpu_joints_torch.segment.organized import region_growing_lattice
from tpu_joints_torch.segment.region_growing import cluster_curvature_filter
from tpu_joints_torch.segment.sac import dominant_plane


def _tiles(a: torch.Tensor, block: int) -> torch.Tensor:
    H, W = a.shape[-2:]
    return a.reshape(*a.shape[:-2], H // block, block, W // block, block)


def _tile_sum(a: torch.Tensor, block: int) -> torch.Tensor:
    t = _tiles(a, block)
    out = t[..., :, 0, :, 0]
    for i in range(block):
        for j in range(block):
            if i or j:
                out = out + t[..., :, i, :, j]
    return out


def _up(a: torch.Tensor, block: int) -> torch.Tensor:
    return a.repeat_interleave(block, -2).repeat_interleave(block, -1)


def _tile_select(xyz_img, valid, block, crop_lo, crop_hi):
    """Crop + one-winner-per-tile selection on [..., H, W] planes.

    Returns (x, y, z, mask) full-resolution planes, the winning pixel per
    tile ``pix`` int64[..., Hb·Wb], ``got`` bool[..., Hb·Wb] (tile holds a
    valid point) and the tile means (mx, my, mz).
    """
    H, W = xyz_img.shape[-3:-1]
    lead = xyz_img.shape[:-3]
    if H % block or W % block:
        raise ValueError(f"frame {H}x{W} does not tile by {block}")
    mask = valid
    x = torch.where(mask, xyz_img[..., 0], SENTINEL).to(torch.float32)
    y = torch.where(mask, xyz_img[..., 1], SENTINEL).to(torch.float32)
    z = torch.where(mask, xyz_img[..., 2], SENTINEL).to(torch.float32)
    if crop_lo is not None and crop_hi is not None:
        inside = ((x >= crop_lo[0]) & (x <= crop_hi[0])
                  & (y >= crop_lo[1]) & (y <= crop_hi[1])
                  & (z >= crop_lo[2]) & (z <= crop_hi[2]))
        mask = mask & inside
        x = torch.where(mask, x, SENTINEL)
        y = torch.where(mask, y, SENTINEL)
        z = torch.where(mask, z, SENTINEL)

    m = mask.to(torch.float32)
    cnt = _tile_sum(m, block)
    inv = 1.0 / torch.clamp_min(cnt, 1.0)
    mx = _tile_sum(torch.where(mask, x, 0.0), block) * inv
    my = _tile_sum(torch.where(mask, y, 0.0), block) * inv
    mz = _tile_sum(torch.where(mask, z, 0.0), block) * inv
    d2 = ((x - _up(mx, block)) ** 2 + (y - _up(my, block)) ** 2
          + (z - _up(mz, block)) ** 2)
    d2 = torch.where(mask, d2, 3e38)
    tmin = _tiles(d2, block).amin(dim=(-3, -1))
    # the UniformSampling winner: the valid pixel nearest the tile mean,
    # ties broken toward the larger flat pixel index
    winner = (d2 <= _up(tmin, block)) & mask
    pixidx = torch.arange(H * W, device=xyz_img.device).reshape(H, W)
    best_pix = _tiles(torch.where(winner, pixidx, -1), block).amax(dim=(-3, -1))
    got = (cnt > 0).reshape(*lead, -1)
    pix = torch.clamp_min(best_pix.reshape(*lead, -1), 0)
    return x, y, z, mask, pix, got, (mx, my, mz)


def _moment_normals(x, y, z, mask, pix, got, half_window, viewpoint):
    """Positions, viewpoint-oriented normals and curvature λ0/Σλ at the
    ``pix`` pixels; ``ok`` = ``got`` minus pixels whose window collapsed on
    a depth edge or holds < 5 points."""
    H, W = mask.shape[-2:]
    S_img, r_px = organized_moments(torch.stack([x, y, z], -1), mask,
                                    half_window)
    pix = torch.clamp(pix, 0, H * W - 1)

    def at(plane):          # [..., H, W] at the flat pixel indices [..., T]
        return plane.flatten(-2).gather(-1, pix.expand(*plane.shape[:-2], -1))

    cov, _, n_support = _cov_from_moments(at(S_img))
    xyz = torch.stack([at(x), at(y), at(z)], -1)
    vals, vecs = eigh3x3(cov)
    normals = vecs[..., :, 2]
    to_vp = viewpoint - xyz
    normals = torch.where((normals * to_vp).sum(-1, keepdim=True) < 0,
                          -normals, normals)
    lam = torch.clamp_min(vals, 0.0)
    tot = lam.sum(-1)
    curvature = torch.where(tot > 1e-20,
                            lam[..., 2] / torch.clamp_min(tot, 1e-20), 0.0)
    ok = got & (n_support >= 5.0) & (at(r_px) >= 1)
    normals = torch.where(ok[..., None], normals, 0.0)
    curvature = torch.where(ok, curvature, 0.0)
    return xyz, normals, curvature, ok


def ingest_organized_blocks(
    xyz_img: torch.Tensor,
    valid: torch.Tensor,
    block: int = 4,
    half_window: int = 5,
    capacity: Optional[int] = None,
    crop_lo: Optional[torch.Tensor] = None,
    crop_hi: Optional[torch.Tensor] = None,
    viewpoint: Optional[torch.Tensor] = None,
) -> Tuple[Cloud, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Organized [H, W, 3] frame → (scene Cloud, normals, curvature,
    n_selected — occupied tiles before the capacity cut); a batch of frames
    [B, H, W, 3] with valid [B, H, W] gives every result a leading B."""
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=torch.float32, device=xyz_img.device)
    H, W = xyz_img.shape[-3:-1]
    x, y, z, mask, pix, got, _ = _tile_select(xyz_img, valid, block,
                                              crop_lo, crop_hi)
    n_selected = got.sum(-1, dtype=torch.int32)
    if capacity is not None and capacity < (H // block) * (W // block):
        idx, keep = compact_indices(got, capacity)
        pix = gather_lanes(pix, idx)
        got = keep
    xyz, normals, curvature, got = _moment_normals(
        x, y, z, mask, pix, got, half_window, viewpoint)
    scene = Cloud(xyz=torch.where(got[..., None], xyz, SENTINEL), mask=got,
                  rgb=torch.zeros_like(xyz))
    return scene, normals, curvature, n_selected


def _grow_lattice(txyz, tnorm, tcurv, got, Hb: int, Wb: int, cfg):
    """Smooth clusters of the [Hb·Wb] lattice nodes under cfg's gates."""
    return region_growing_lattice(
        txyz.reshape(Hb, Wb, 3), tnorm.reshape(Hb, Wb, 3),
        tcurv.reshape(Hb, Wb), got.reshape(Hb, Wb),
        smoothness_deg=cfg.rg_smoothness_deg,
        curvature_threshold=cfg.rg_curvature,
        min_cluster_size=cfg.rg_min_cluster, max_edge=cfg.rg_max_edge)


def _compact_nodes(txyz, tnorm, tcurv, keep, capacity: int):
    """The kept lattice nodes as (scene Cloud[capacity], normals,
    curvature); an overflow is thinned uniformly along the raster order."""
    idx, ok = compact_indices(keep, capacity)
    xyz = torch.where(ok[:, None], txyz[idx], SENTINEL)
    normals = torch.where(ok[:, None], tnorm[idx], 0.0)
    curvature = torch.where(ok, tcurv[idx], 0.0)
    return (Cloud(xyz=xyz, mask=ok, rgb=torch.zeros_like(xyz)), normals,
            curvature)


def ingest_organized_segmented(
    xyz_img: torch.Tensor,
    valid: torch.Tensor,
    cfg,
    block: int = 4,
    half_window: int = 5,
    crop_lo: Optional[torch.Tensor] = None,
    crop_hi: Optional[torch.Tensor] = None,
    viewpoint: Optional[torch.Tensor] = None,
    key_group: int = 0,
) -> Tuple[Cloud, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Organized ingestion with the reference's scene-crop chain run on the
    sensor tile lattice before compaction: crop → dominant-plane removal
    (``cfg.remove_plane``, 256 RANSAC hypotheses of key 0) → lattice region
    growing + cluster curvature filter (``cfg.segment_scene``). Table and
    clutter go before the working set is cut, so ``cfg.scene_capacity``
    only has to hold the object. Pass the same cfg to the detection with
    both flags off (``detect._strip_crop``).

    Returns (scene Cloud[scene_capacity], normals, curvature, n_selected —
    survivors of the segmentation, before the capacity cut)."""
    if key_group > 0:
        raise NotImplementedError("lattice keypoints are not ported yet "
                                  "(ROADMAP queue 1 item 15)")
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=torch.float32, device=xyz_img.device)
    H, W, _ = xyz_img.shape
    Hb, Wb = H // block, W // block
    x, y, z, mask, pix, got, _ = _tile_select(xyz_img, valid, block,
                                              crop_lo, crop_hi)
    # normals at all tile winners: the lattice nodes
    txyz, tnorm, tcurv, got = _moment_normals(
        x, y, z, mask, pix, got, half_window, viewpoint)

    if cfg.remove_plane:
        nodes = Cloud(xyz=torch.where(got[:, None], txyz, SENTINEL), mask=got,
                      rgb=torch.zeros_like(txyz))
        got = got & ~dominant_plane(nodes, tnorm, cfg.plane_dist,
                                    cfg.plane_min_fraction)

    if cfg.segment_scene:
        clusters = _grow_lattice(txyz, tnorm, tcurv, got, Hb, Wb, cfg)
        keep = cluster_curvature_filter(clusters, tcurv, got,
                                        cfg.cluster_max_curvature)
    else:
        keep = got

    n_selected = keep.sum(dtype=torch.int32)
    return (*_compact_nodes(txyz, tnorm, tcurv, keep, cfg.scene_capacity),
            n_selected)
