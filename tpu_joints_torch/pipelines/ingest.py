"""Raw organized-frame ingestion (counterpart of
``tpu_joints/pipelines/ingest.py``): the tile ingest, plain or with the
scene-crop chain run on the tile lattice before compaction, and the
pixel ingest ``ingest_organized``.

One point per ``block``×``block`` pixel tile — the valid pixel nearest the
tile mean, ties to the larger pixel index — with normals and curvature from
the shared box-filtered moment maps. Tile reductions are reshape-and-reduce
over the tiles, summing each tile's pixels in row-major order (the order of
XLA's ``reduce_window`` on the CPU). With ``key_group > 0`` both tile
ingests also flag one keypoint per ``key_group``×``key_group`` cell of
tiles (``cfg.keypoints == "lattice"``). ``ingest_organized_blocks`` also
takes a batch of frames [B, H, W, 3]: every step works on the last two
(pixel or tile) axes, so the batch rides along.

``ingest_organized`` keeps pixels instead of tiles: organized normals with
a three-round fill of the depth-edge pixels, the crop box, and a uniform
downsample of leaf ``leaf`` to at most ``capacity`` points.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_joints_torch.core.cloud import SENTINEL, Cloud
from tpu_joints_torch.core.ops import fused_sumsq
from tpu_joints_torch.features.eigen3 import eigh3x3
from tpu_joints_torch.features.organized import (_cov_from_moments,
                                                 estimate_normals_organized,
                                                 organized_moments)
from tpu_joints_torch.filters.filters import (compact_indices, gather_lanes,
                                              uniform_sample_mask)
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


def _lattice_key_flags(tmeans, got2d: torch.Tensor, g: int) -> torch.Tensor:
    """One keypoint flag per ``g``×``g`` cell of the tile lattice: in every
    occupied cell, the tile whose mean position is nearest the cell's mean
    position (the UniformSampling winner rule on the lattice), ties to the
    larger flat tile index. The lattice is zero-padded to whole cells.

    Args: tmeans = (mx, my, mz) [..., Hb, Wb] tile-mean planes; got2d
    bool[..., Hb, Wb]. Returns bool[..., Hb, Wb].
    """
    mx, my, mz = tmeans
    Hb, Wb = got2d.shape[-2:]
    pad = (0, -Wb % g, 0, -Hb % g)
    m2 = F.pad(got2d, pad)
    X, Y, Z = (F.pad(torch.where(got2d, t, 0.0), pad) for t in (mx, my, mz))
    Hp, Wp = m2.shape[-2:]
    cnt = _tile_sum(m2.to(torch.float32), g)
    inv = 1.0 / torch.clamp_min(cnt, 1.0)
    cx, cy, cz = (_tile_sum(t, g) * inv for t in (X, Y, Z))
    d2 = ((X - _up(cx, g)) ** 2 + (Y - _up(cy, g)) ** 2
          + (Z - _up(cz, g)) ** 2)
    d2 = torch.where(m2, d2, 3e38)
    cmin = _tiles(d2, g).amin(dim=(-3, -1))
    winner = (d2 <= _up(cmin, g)) & m2
    # exactly one winner per occupied cell: keep the largest flat index
    tidx = torch.arange(Hp * Wp, device=got2d.device).reshape(Hp, Wp)
    best = _tiles(torch.where(winner, tidx, -1), g).amax(dim=(-3, -1))
    flag = winner & (tidx == _up(best, g))
    return flag[..., :Hb, :Wb]


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
    key_group: int = 0,
) -> Tuple[Cloud, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Organized [H, W, 3] frame → (scene Cloud, normals, curvature,
    n_selected — occupied tiles before the capacity cut); with
    ``key_group > 0``, a fifth element: bool lattice keypoint flags aligned
    with the scene lanes. A batch of frames [B, H, W, 3] with valid
    [B, H, W] gives every result a leading B."""
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=torch.float32, device=xyz_img.device)
    H, W = xyz_img.shape[-3:-1]
    Hb, Wb = H // block, W // block
    x, y, z, mask, pix, got, tmeans = _tile_select(xyz_img, valid, block,
                                                   crop_lo, crop_hi)
    key_flag = None
    if key_group > 0:
        key_flag = _lattice_key_flags(
            tmeans, got.reshape(*got.shape[:-1], Hb, Wb),
            key_group).flatten(-2)
    n_selected = got.sum(-1, dtype=torch.int32)
    if capacity is not None and capacity < Hb * Wb:
        idx, keep = compact_indices(got, capacity)
        pix = gather_lanes(pix, idx)
        got = keep
        if key_flag is not None:
            key_flag = gather_lanes(key_flag, idx) & keep
    xyz, normals, curvature, got = _moment_normals(
        x, y, z, mask, pix, got, half_window, viewpoint)
    scene = Cloud(xyz=torch.where(got[..., None], xyz, SENTINEL), mask=got,
                  rgb=torch.zeros_like(xyz))
    if key_flag is not None:
        return scene, normals, curvature, n_selected, key_flag & got
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
    curvature, the node index of each lane); an overflow is thinned
    uniformly along the raster order."""
    idx, ok = compact_indices(keep, capacity)
    xyz = torch.where(ok[:, None], txyz[idx], SENTINEL)
    normals = torch.where(ok[:, None], tnorm[idx], 0.0)
    curvature = torch.where(ok, tcurv[idx], 0.0)
    return (Cloud(xyz=xyz, mask=ok, rgb=torch.zeros_like(xyz)), normals,
            curvature, idx)


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
    survivors of the segmentation, before the capacity cut); with
    ``key_group > 0``, a fifth element: bool[scene_capacity] lattice
    keypoint flags over the segmentation's survivors (a cropped tile never
    seeds a key cell)."""
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=torch.float32, device=xyz_img.device)
    H, W, _ = xyz_img.shape
    Hb, Wb = H // block, W // block
    x, y, z, mask, pix, got, tmeans = _tile_select(xyz_img, valid, block,
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
    scene, normals, curvature, idx = _compact_nodes(txyz, tnorm, tcurv, keep,
                                                    cfg.scene_capacity)
    if key_group > 0:
        # the cell winners are chosen among the survivors by tile mean
        key_flag = _lattice_key_flags(tmeans, keep.reshape(Hb, Wb),
                                      key_group).reshape(-1)
        return scene, normals, curvature, n_selected, key_flag[idx] & scene.mask
    return scene, normals, curvature, n_selected


def _sum3x3(a: torch.Tensor) -> torch.Tensor:
    """3×3 SAME window sum of [..., H, W] planes, zero-padded, the nine
    taps added in row-major order (XLA's ``reduce_window`` on the CPU)."""
    H, W = a.shape[-2:]
    p = F.pad(a, (1, 1, 1, 1))
    out = p[..., 0:H, 0:W]
    for i in range(3):
        for j in range(3):
            if i or j:
                out = out + p[..., i:i + H, j:j + W]
    return out


def _normals_with_fill(xyz_img, valid, half_window, viewpoint):
    """Organized normals + a 3-round border fill. Depth-edge pixels get no
    window (PCL leaves NaN there); a pixel next to covered ones receives
    their averaged, renormalised normal and averaged curvature, and counts
    as covered for the next round. Returns (normals_img [H, W, 3], curv_img
    [H, W], covered bool[H, W])."""
    normals_img, curv_img = estimate_normals_organized(
        xyz_img, valid, half_window=half_window, viewpoint=viewpoint)
    has_n = fused_sumsq(normals_img) > 0.25
    n_fill, c_fill, covered = normals_img, curv_img, has_n
    for _ in range(3):
        cf = covered.to(torch.float32)
        ns = _sum3x3((n_fill * cf[..., None]).movedim(-1, 0)).movedim(0, -1)
        cs = _sum3x3(cf)
        curv_s = _sum3x3(c_fill * cf)
        newly = ~covered & (cs > 0.5)
        avg = ns / torch.clamp_min(cs, 1.0)[..., None]
        # |avg|: the squared norm as XLA's CPU reduction forms it, its root
        # taken in float64 and rounded once (bit-equal to the reference)
        norm = torch.sqrt(fused_sumsq(avg).double()).to(torch.float32)
        avg = avg / torch.clamp_min(norm, 1e-9)[..., None]
        n_fill = torch.where(newly[..., None], avg, n_fill)
        c_fill = torch.where(newly, curv_s / torch.clamp_min(cs, 1.0), c_fill)
        covered = covered | newly
    return n_fill, c_fill, covered


def ingest_organized(
    xyz_img: torch.Tensor,
    valid: torch.Tensor,
    capacity: int = 32768,
    leaf: float = 0.004,
    half_window: int = 5,
    crop_lo: Optional[torch.Tensor] = None,
    crop_hi: Optional[torch.Tensor] = None,
    viewpoint: Optional[torch.Tensor] = None,
) -> Tuple[Cloud, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Organized sensor cloud float32[H, W, 3] + valid bool[H, W] → padded
    working set with normals: filled organized normals, the crop box
    (``crop_lo``/``crop_hi``, the reference's PassThrough chain), the
    ``leaf`` uniform downsample (PCL UniformSampling), then compaction to
    ``capacity`` lanes (an overflow thinned uniformly along the raster
    order). Pixels that still have no normal leave the working set.

    Returns (scene Cloud[capacity], normals float32[capacity, 3],
    curvature float32[capacity], n_selected — survivors before the
    capacity cut).
    """
    H, W, _ = xyz_img.shape
    n_fill, c_fill, covered = _normals_with_fill(
        xyz_img, valid, half_window, viewpoint)
    flat_n = n_fill.reshape(H * W, 3)
    flat_c = c_fill.reshape(H * W)
    mask = valid.reshape(H * W) & covered.reshape(H * W)
    flat_xyz = torch.where(mask[:, None], xyz_img.reshape(H * W, 3),
                           SENTINEL).to(torch.float32)
    if crop_lo is not None and crop_hi is not None:
        inside = ((flat_xyz >= crop_lo) & (flat_xyz <= crop_hi)).all(1)
        mask = mask & inside
        flat_xyz = torch.where(mask[:, None], flat_xyz, SENTINEL)
    full = Cloud(xyz=flat_xyz, mask=mask, rgb=torch.zeros_like(flat_xyz))
    keep = uniform_sample_mask(full, leaf) & mask
    n_selected = keep.sum(dtype=torch.int32)
    idx, got = compact_indices(keep, capacity)
    xyz = torch.where(got[:, None], flat_xyz[idx], SENTINEL)
    normals = torch.where(got[:, None], flat_n[idx], 0.0)
    curvature = torch.where(got, flat_c[idx], 0.0)
    return (Cloud(xyz=xyz, mask=got, rgb=torch.zeros_like(xyz)), normals,
            curvature, n_selected)
