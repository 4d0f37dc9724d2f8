"""Global hypothesis verification (counterpart of
``tpu_joints/recognize/hv.py``; PCL's ``GlobalHypothesesVerification``).

Given H registered instances (model clouds already in scene coordinates),
jointly pick the boolean subset that best explains the scene:

    cost(active) = - #scene points explained by >= 1 active instance
                   + λ_out · Σ_active #unexplained visible model points
                   + λ_mult · #scene points explained by >= 2 active instances

Up to H = 16 all 2^H subsets are evaluated, 256 patterns at a time; above,
a batched single-flip local search from the empty set runs a fixed 2H
steps. Neither reads the device on the host.

The two nearest-neighbour searches behind ``explained`` and ``outliers`` go
to kernel K1: scene → instance h (every instance is its own source cloud) is
ONE launch of K1's batch mode, instance → scene one folded launch of H·Nm
rows. The reference pins both off its kernel for a TPU runtime fault and
computes them in the expansion form; K1 uses the difference form, so a
point within rounding of the inlier threshold can fall on the other side.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.ops import take, top_k
from tpu_joints_torch.neighbors.bruteforce import knn, knn_batched

_BIG = 3.0e38
_PATTERNS = 256        # activation patterns per chunk of the exhaustive sweep


def scene_depth_buffer(scene: Cloud, bins: int = 64
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coarse perspective z-buffer of the scene from the origin: points are
    binned by ray direction (x/z, y/z; the extent adapts to the data), a
    scatter-min keeps the nearest depth per bin, and two 3×3 min-dilations
    close the gaps a sparse working set leaves (conservative for occlusion:
    depths only move nearer).

    Returns (depth [bins·bins] with 3e38 in empty bins, lo [2], scale [2] —
    the (u, v) binning transform)."""
    x, y, z = scene.xyz[:, 0], scene.xyz[:, 1], scene.xyz[:, 2]
    ok = scene.mask & (z > 1e-6)
    zs = torch.clamp_min(z, 1e-6)
    u = torch.where(ok, x / zs, 0.0)
    v = torch.where(ok, y / zs, 0.0)
    lo = torch.stack([torch.where(ok, u, _BIG).amin(),
                      torch.where(ok, v, _BIG).amin()])
    hi = torch.stack([torch.where(ok, u, -_BIG).amax(),
                      torch.where(ok, v, -_BIG).amax()])
    scale = (bins - 1) / torch.clamp_min(hi - lo, 1e-6)
    ui = torch.clamp(((u - lo[0]) * scale[0]).to(torch.int32), 0, bins - 1)
    vi = torch.clamp(((v - lo[1]) * scale[1]).to(torch.int32), 0, bins - 1)
    flat = (vi * bins + ui).long()
    depth = torch.full((bins * bins,), _BIG, dtype=torch.float32,
                       device=z.device)
    depth = depth.scatter_reduce(0, flat, torch.where(ok, z, _BIG), "amin",
                                 include_self=True)
    img = depth.reshape(1, 1, bins, bins)
    for _ in range(2):       # 3×3 SAME min, the border padded with 3e38
        img = -F.max_pool2d(F.pad(-img, (1, 1, 1, 1), value=-_BIG), 3, stride=1)
    return img.reshape(bins * bins), lo, scale


def _occluded(xyz: torch.Tensor, depth: torch.Tensor, lo: torch.Tensor,
              scale: torch.Tensor, occlusion_threshold: float,
              bins: int) -> torch.Tensor:
    """bool[...]: the point lies behind the scene surface seen from the
    origin."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    zs = torch.clamp_min(z, 1e-6)
    ui = torch.clamp(((x / zs - lo[0]) * scale[0]).to(torch.int32), 0, bins - 1)
    vi = torch.clamp(((y / zs - lo[1]) * scale[1]).to(torch.int32), 0, bins - 1)
    front = depth[(vi * bins + ui).long()]
    return (z > front + float(np.float32(occlusion_threshold))) & (front < 1e38)


def _explained_matrix(instances_xyz: torch.Tensor,
                      instances_mask: torch.Tensor, scene: Cloud,
                      inlier_threshold: float,
                      occlusion_threshold: float = 0.0, bins: int = 64
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For H registered instances [H, Nm, 3]: explained bool[H, Ns] — the
    scene point lies within the inlier threshold of instance h; outliers
    f32[H] — the count of *visible* instance points with no scene support
    (with ``occlusion_threshold > 0``, points behind the scene's depth
    buffer are exempt)."""
    H, Nm, _ = instances_xyz.shape
    t = np.float32(inlier_threshold)
    thr_sq = float(t * t)
    # scene → instance h: one batched K1 launch, a source cloud per entry
    d_s, _ = knn_batched(scene.xyz[None].expand(H, -1, -1), instances_xyz, 1,
                         source_mask=instances_mask)
    explained = scene.mask[None, :] & (d_s[..., 0] <= thr_sq)
    # instance → scene: the instances folded into the rows of one launch
    d_m, _ = knn(instances_xyz.reshape(H * Nm, 3), scene.xyz, 1,
                 source_mask=scene.mask)
    outlier = instances_mask & (d_m[:, 0].reshape(H, Nm) > thr_sq)
    if occlusion_threshold > 0.0:
        depth, lo, scale = scene_depth_buffer(scene, bins)
        outlier = outlier & ~_occluded(instances_xyz, depth, lo, scale,
                                       occlusion_threshold, bins)
    return explained, outlier.sum(1, dtype=torch.float32)


def _cost(active_f: torch.Tensor, ex_f: torch.Tensor, out_vec: torch.Tensor,
          outlier_regularizer: float, multiple_assignment_penalty: float
          ) -> torch.Tensor:
    """Cost of each activation pattern in ``active_f`` f32[P, H]: [P]. The
    coverage counts are small integers, exact in float32 in any order."""
    cover = active_f @ ex_f                                    # [P, Ns]
    return (-torch.clamp_max(cover, 1.0).sum(-1)
            + outlier_regularizer * (active_f @ out_vec)
            + multiple_assignment_penalty
            * torch.clamp_min(cover - 1.0, 0.0).sum(-1))


def verify_hypotheses(instances_xyz: torch.Tensor,
                      instances_mask: torch.Tensor,
                      instances_valid: torch.Tensor, scene: Cloud,
                      inlier_threshold: float = 0.005,
                      outlier_regularizer: float = 0.001,
                      multiple_assignment_penalty: float = 1.0,
                      occlusion_threshold: float = 0.0) -> torch.Tensor:
    """bool[H] — the verified-instance mask.

    instances_xyz f32[H, Nm, 3]: registered model clouds in scene
    coordinates; instances_mask bool[H, Nm]; instances_valid bool[H]
    (padding hypotheses are never selected). ``occlusion_threshold > 0``
    turns on the occlusion exemption (the scene must be in camera
    coordinates, the viewpoint at the origin)."""
    explained, outliers = _explained_matrix(
        instances_xyz, instances_mask, scene, inlier_threshold,
        occlusion_threshold=occlusion_threshold)
    return _select_hypotheses(explained, outliers, instances_valid,
                             outlier_regularizer, multiple_assignment_penalty)


def _select_hypotheses(explained: torch.Tensor, outliers: torch.Tensor,
                      instances_valid: torch.Tensor,
                      outlier_regularizer: float = 0.001,
                      multiple_assignment_penalty: float = 1.0
                      ) -> torch.Tensor:
    """The search of :func:`verify_hypotheses` on a given explained
    bool[H, Ns] and outliers f32[H]: exhaustive up to H = 16, greedy above."""
    H = explained.shape[0]
    dev = explained.device
    explained = explained & instances_valid[:, None]
    outliers = torch.where(instances_valid, outliers, float("inf"))
    if H > 16:
        return _greedy_verify(explained, outliers, instances_valid,
                              outlier_regularizer, multiple_assignment_penalty)
    ex_f = explained.to(torch.float32)
    out_vec = torch.where(torch.isfinite(outliers), outliers, 0.0)
    n_patterns = 2 ** H
    chunk_p = min(_PATTERNS, n_patterns)
    shifts = torch.arange(H, device=dev)
    costs, actives = [], []
    for c in range(n_patterns // chunk_p):
        patterns = c * chunk_p + torch.arange(chunk_p, device=dev)
        bits = (patterns[:, None] >> shifts[None, :]) & 1
        active = bits.bool() & instances_valid[None, :]
        cost = _cost(active.to(torch.float32), ex_f, out_vec,
                     outlier_regularizer, multiple_assignment_penalty)
        # a pattern with an invalid bit set duplicates a smaller pattern's
        # cost exactly: the first minimum must win on every device
        _, j = top_k(-cost, 1)
        costs.append(take(cost, j[0]))
        actives.append(take(active, j[0]))
    _, best = top_k(-torch.stack(costs), 1)
    return take(torch.stack(actives), best[0])


def _greedy_verify(explained: torch.Tensor, outliers: torch.Tensor,
                   valid: torch.Tensor, outlier_regularizer: float,
                   multiple_assignment_penalty: float) -> torch.Tensor:
    """Single-flip local search from the empty set: each of the 2H steps
    evaluates all H one-bit flips as one [H, Ns] product and takes the best
    strictly improving one. ``explained`` bool[H, Ns] is already masked by
    validity, ``outliers`` f32[H] is inf on invalid hypotheses."""
    H = explained.shape[0]
    dev = explained.device
    ex_f = explained.to(torch.float32)
    out_vec = torch.where(torch.isfinite(outliers), outliers, 0.0)
    eye = torch.eye(H, dtype=torch.bool, device=dev)
    active = torch.zeros(H, dtype=torch.bool, device=dev)
    cost = _cost(active.to(torch.float32)[None], ex_f, out_vec,
                 outlier_regularizer, multiple_assignment_penalty)[0]
    for _ in range(2 * H):
        # flipping an invalid bit duplicates `active` and never strictly
        # improves, so invalid bits stay off
        flips = torch.logical_xor(active[None, :], eye) & valid[None, :]
        costs = _cost(flips.to(torch.float32), ex_f, out_vec,
                      outlier_regularizer, multiple_assignment_penalty)
        _, j = top_k(-costs, 1)
        cj = take(costs, j[0])
        better = cj < cost - 1e-6
        active = torch.where(better, take(flips, j[0]), active)
        cost = torch.where(better, cj, cost)
    return active
