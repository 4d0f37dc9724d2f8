"""ICP refinement, fitness and scene coverage (counterpart of
``tpu_joints/recognize/icp.py``).

The candidate axis is folded into the nearest-neighbour query rows: every
iteration is ONE k=1 search of C·N points against the target — kernel K1
on the card — then a per-candidate Umeyama or point-to-plane solve.
The reference's ``icp_multi_capped`` chunking existed only for a TPU
runtime fault and has no counterpart: ``icp_multi`` is called once; so is
the coverage search, whatever C·S is (the reference streams above 65536
rows to bound a temporary that K1 never forms).

A batch of frames: ``icp_multi`` and ``scene_coverage_multi`` take a target
(scene) Cloud with a leading batch axis, ``xyz [B, Nt, 3]``; the C poses are
then B equal groups in frame order, group b searching frame b — one launch
of K1's batch mode per ICP iteration, and still one folded K1 launch for
the coverage (its source, the model, is shared).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.transforms import (invert_rigid, transform_points,
                                              umeyama)
from tpu_joints_torch.features.eigen3 import cross, norm
from tpu_joints_torch.neighbors.bruteforce import knn, knn_batched

_BIG = 3.0e38


def _corr_thresholds(iterations: int, max_corr_dist: float,
                     max_corr_start: float) -> List[float]:
    """Per-iteration squared correspondence gates (host floats): a
    geometric schedule from ``max_corr_start`` down to ``max_corr_dist``,
    or PCL's constant gate when ``max_corr_start <= 0``."""
    end = np.float32(max_corr_dist)
    if max_corr_start <= 0.0 or iterations <= 1:
        d = np.full((iterations,), end, np.float32)
    else:
        start = np.float32(max_corr_start)
        t = np.arange(iterations, dtype=np.float32) / np.float32(iterations - 1)
        d = (start * (end / start) ** t).astype(np.float32)
    return [float(x) for x in (d * d).astype(np.float32)]


def _rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """exp([ω]×) for [..., 3] rotation vectors (series-guarded at θ→0)."""
    theta = norm(omega)
    small = theta < 1e-6
    t = torch.clamp_min(theta, 1e-20)
    A = torch.where(small, 1.0 - theta ** 2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - theta ** 2 / 24.0, (1.0 - torch.cos(t)) / t ** 2)
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(wx)
    K = torch.stack([torch.stack([zero, -wz, wy], -1),
                     torch.stack([wz, zero, -wx], -1),
                     torch.stack([-wy, wx, zero], -1)], -2)
    I = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return I + A[..., None, None] * K + B[..., None, None] * (K @ K)


def _plane_delta(moved, q, n, w) -> torch.Tensor:
    """Linearised point-to-plane update per candidate: minimise
    Σ w (n·(R p + t − q))² over the twist (ω, t) with a tiny
    Levenberg damping. moved/q/n [C, N, 3], w [C, N] → [C, 4, 4]."""
    r = (n * (q - moved)).sum(-1)
    a = torch.cat([cross(moved, n), n], dim=-1)            # [C, N, 6]
    wa = a * w[..., None]
    H = wa.transpose(-1, -2) @ a                            # [C, 6, 6]
    g = (wa.transpose(-1, -2) @ r[..., None])[..., 0]      # [C, 6]
    tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
    damp = 1e-6 * tr / 6.0 + 1e-12
    I6 = torch.eye(6, dtype=H.dtype, device=H.device)
    # solve_ex skips the host-side error check that solve performs
    xi, _ = torch.linalg.solve_ex(H + damp[:, None, None] * I6, g,
                                  check_errors=False)
    delta = torch.eye(4, dtype=moved.dtype, device=moved.device).repeat(
        moved.shape[0], 1, 1)
    delta[:, :3, :3] = _rodrigues(xi[:, :3])
    delta[:, :3, 3] = xi[:, 3:]
    return delta


def _nn(moved: torch.Tensor, target: Cloud):
    """Nearest target point of every moved source point: (dist² [C, N], idx
    int64[C, N] into ``target.xyz.reshape(-1, 3)``). A batched target
    [B, Nt, 3] serves the C candidates in B groups, each against its own
    frame."""
    C, N, _ = moved.shape
    if target.xyz.ndim == 3:
        B, Nt, _ = target.xyz.shape
        d, i = knn_batched(moved.reshape(B, (C // B) * N, 3), target.xyz, 1,
                           source_mask=target.mask)
        i = i.long() + Nt * torch.arange(B, device=i.device)[:, None, None]
        return d.reshape(C, N), i.reshape(C, N)
    d, i = knn(moved.reshape(C * N, 3), target.xyz, 1, source_mask=target.mask)
    return d[:, 0].reshape(C, N), i[:, 0].reshape(C, N).long()


def _move(Ts: torch.Tensor, src_xyz: torch.Tensor) -> torch.Tensor:
    return torch.einsum("cij,cnj->cni", Ts[:, :3, :3], src_xyz) \
        + Ts[:, None, :3, 3]


def icp_multi(
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    target: Cloud,
    init_T: torch.Tensor,
    iterations: int = 30,
    max_corr_dist: float = _BIG,
    max_corr_start: float = 0.0,
    point_to_plane: bool = False,
    target_normals: Optional[torch.Tensor] = None,
    with_fitness: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ICP of C (source [C, N, 3], mask [C, N], init pose [C, 4, 4]) pairs
    against one target, or against B targets (``target.xyz [B, Nt, 3]``,
    ``target_normals [B, Nt, 3]``; C = B equal groups in frame order).
    Returns (T [C, 4, 4], fitness [C] — PCL mean squared NN distance, zeros
    when ``with_fitness`` is False)."""
    C = src_xyz.shape[0]
    if point_to_plane and target_normals is None:
        raise ValueError("point_to_plane=True requires target_normals")
    if target.xyz.ndim == 3 and C % target.xyz.shape[0]:
        raise ValueError(f"{C} candidates do not split over "
                         f"{target.xyz.shape[0]} frames")
    target_xyz = target.xyz.reshape(-1, 3)
    if target_normals is not None:
        target_normals = target_normals.reshape(-1, 3)
    Ts = init_T.to(torch.float32)
    for max_sq in _corr_thresholds(iterations, max_corr_dist, max_corr_start):
        moved = _move(Ts, src_xyz)
        dist_sq, nn_idx = _nn(moved, target)
        w = (src_mask & (dist_sq <= max_sq) & (dist_sq < _BIG)).to(torch.float32)
        if point_to_plane:
            deltas = _plane_delta(moved, target_xyz[nn_idx],
                                  target_normals[nn_idx], w)
        else:
            deltas = umeyama(moved, target_xyz[nn_idx], w)
        Ts = deltas @ Ts
    if not with_fitness:
        return Ts, torch.zeros(C, dtype=torch.float32, device=Ts.device)
    dist_sq, _ = _nn(_move(Ts, src_xyz), target)
    w = (src_mask & (dist_sq < _BIG)).to(torch.float32)
    fit = (dist_sq * w).sum(1) / torch.clamp_min(w.sum(1), 1.0)
    return Ts, fit


def scene_coverage_multi(
    scene: Cloud,
    model_xyz: torch.Tensor,
    model_mask: torch.Tensor,
    Ts: torch.Tensor,
    clip: float = 0.05,
    explained_dist: float = 0.02,
    local: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """How well the model at each of C poses explains the scene: (coverage
    [C] — mean over valid scene points of min(NN dist², clip²);
    unexplained [C] — fraction of valid scene points farther than
    ``explained_dist`` from the posed model). The pose axis folds into the
    NN rows by moving the scene through each inverse pose.

    ``local=True`` restricts the *unexplained* fraction to scene points
    within the model's own bounding radius (+ ``explained_dist``) of the
    pose's model-frame origin: in a multi-instance scene the global
    fraction is dominated by the other instances' points, the local one
    keeps the single-instance meaning per candidate. Coverage stays global.

    A batched scene (``xyz [B, S, 3]``): the C poses are B equal groups in
    frame order, each moved through its own frame; still one search."""
    C = Ts.shape[0]
    inv = invert_rigid(Ts)
    if scene.xyz.ndim == 3:
        B, S, _ = scene.xyz.shape
        moved = (torch.einsum("bcij,bnj->bcni",
                              inv[:, :3, :3].reshape(B, C // B, 3, 3), scene.xyz)
                 .reshape(C, S, 3) + inv[:, None, :3, 3])
        w = scene.mask.to(torch.float32).repeat_interleave(C // B, 0)
    else:
        S = scene.capacity
        moved = torch.einsum("cij,nj->cni", inv[:, :3, :3], scene.xyz) \
            + inv[:, None, :3, 3]
        w = scene.mask[None, :].to(torch.float32)
    d, _ = knn(moved.reshape(C * S, 3), model_xyz, 1, source_mask=model_mask)
    dist_sq = d[:, 0].reshape(C, S)
    denom = torch.clamp_min(w.sum(1), 1.0)
    c = np.float32(clip)
    e = np.float32(explained_dist)
    coverage = (torch.clamp_max(dist_sq, float(c * c)) * w).sum(1) / denom
    far = (dist_sq > float(e * e)).to(torch.float32)
    if not local:
        return coverage, (far * w).sum(1) / denom
    r = torch.sqrt(torch.where(model_mask, (model_xyz * model_xyz).sum(-1),
                               0.0).amax()) + float(e)
    lw = w * ((moved * moved).sum(-1) <= r * r).to(torch.float32)
    return coverage, (far * lw).sum(1) / torch.clamp_min(lw.sum(1), 1.0)


def fitness_multi(src_xyz: torch.Tensor, src_mask: torch.Tensor, target: Cloud,
                  Ts: torch.Tensor) -> torch.Tensor:
    """PCL fitness of ONE source cloud [N, 3] at C poses [C, 4, 4], in one
    folded k=1 search: mean squared NN distance over the valid source
    points, [C]."""
    moved = torch.einsum("cij,nj->cni", Ts[:, :3, :3], src_xyz) \
        + Ts[:, None, :3, 3]
    dist_sq, _ = _nn(moved, target)
    w = (src_mask[None, :] & (dist_sq < _BIG)).to(torch.float32)
    return (dist_sq * w).sum(1) / torch.clamp_min(w.sum(1), 1.0)


def _nn_correspondences(src_xyz, dst_xyz, dst_mask):
    d, i = knn(src_xyz, dst_xyz, 1, source_mask=dst_mask)
    return d[:, 0], i[:, 0].long()


def fitness_score(source: Cloud, target: Cloud, T: torch.Tensor,
                  max_range: float = _BIG) -> torch.Tensor:
    """PCL ``getFitnessScore``: mean squared NN distance of the transformed
    source points onto the target, over pairs closer than ``max_range``."""
    moved = transform_points(source.xyz, T)
    dist_sq, _ = _nn_correspondences(moved, target.xyz, target.mask)
    with np.errstate(over="ignore"):      # the default range squares to inf
        r_sq = float(np.float32(max_range) * np.float32(max_range))
    w = (source.mask & (dist_sq < r_sq) & (dist_sq < _BIG)).to(torch.float32)
    return (dist_sq * w).sum() / torch.clamp_min(w.sum(), 1.0)


def icp(source: Cloud, target: Cloud, init_T: torch.Tensor,
        iterations: int = 100, max_corr_dist: float = _BIG,
        max_corr_start: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-to-point ICP of ``source`` onto ``target`` from ``init_T``:
    (T [4, 4] total source→target transform, PCL fitness after the last
    iteration)."""
    T = init_T.to(torch.float32)
    for max_sq in _corr_thresholds(iterations, max_corr_dist, max_corr_start):
        moved = transform_points(source.xyz, T)
        dist_sq, nn = _nn_correspondences(moved, target.xyz, target.mask)
        w = (source.mask & (dist_sq <= max_sq) & (dist_sq < _BIG)).to(
            torch.float32)
        T = umeyama(moved, target.xyz[nn], w) @ T
    return T, fitness_score(source, target, T)
