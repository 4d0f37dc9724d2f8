"""Global hypothesis verification (counterpart of
``tpu_joints/recognize/hv.py``; PCL's ``GlobalHypothesesVerification``).

Given H registered instances (model clouds already in scene coordinates),
jointly pick the boolean subset that best explains the scene:

    cost(active) = - #scene points explained by >= 1 active instance
                   + λ_out · Σ_active #unexplained visible model points
                   + λ_mult · #scene points explained by >= 2 active instances

Up to H = 16 all 2^H subsets are evaluated, 256 patterns at a time; above,
a single-flip local search from the empty set runs a fixed 2H steps: on a
card one launch of a hand-written CUDA kernel (``neighbors/csrc/hv_greedy.cu``,
:func:`hv_greedy`), on the CPU its plain version :func:`_greedy_verify`.
Neither search reads the device on the host.
``verify_hypotheses_counted`` also hands back what the verdict was made of
(explained and outlier counts, steps run and steps that changed the set),
which a served reply carries as its ``hv_*`` metrics.

The two nearest-neighbour searches behind ``explained`` and ``outliers`` go
to kernel K1: scene → instance h (every instance is its own source cloud) is
ONE launch of K1's batch mode, instance → scene one folded launch of H·Nm
rows. The reference pins both off its kernel for a TPU runtime fault and
computes them in the expansion form; K1 uses the difference form, so a
point within rounding of the inlier threshold can fall on the other side.
"""
from __future__ import annotations

from collections import Counter
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.ops import take, top_k
from tpu_joints_torch.neighbors.bruteforce import knn, knn_batched
from tpu_joints_torch.neighbors.pallas_knn import _count_lock, load_library

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
    return verify_hypotheses_counted(
        instances_xyz, instances_mask, instances_valid, scene,
        inlier_threshold, outlier_regularizer, multiple_assignment_penalty,
        occlusion_threshold)[0]


def verify_hypotheses_counted(instances_xyz: torch.Tensor,
                              instances_mask: torch.Tensor,
                              instances_valid: torch.Tensor, scene: Cloud,
                              inlier_threshold: float = 0.005,
                              outlier_regularizer: float = 0.001,
                              multiple_assignment_penalty: float = 1.0,
                              occlusion_threshold: float = 0.0):
    """:func:`verify_hypotheses` and what its verdict was made of, all on
    the device: (verified bool[H], dict(explained int32[H] — the scene
    points within the inlier threshold of each hypothesis, outliers f32[H],
    steps — greedy steps or exhaustive chunks run, improved — those that
    changed the chosen set, both int32 scalars)). Invalid hypotheses count
    0 explained points."""
    explained, outliers = _explained_matrix(
        instances_xyz, instances_mask, scene, inlier_threshold,
        occlusion_threshold=occlusion_threshold)
    verified, steps, improved = _select_hypotheses(
        explained, outliers, instances_valid, outlier_regularizer,
        multiple_assignment_penalty)
    counts = dict(
        explained=(explained & instances_valid[:, None]).sum(
            1, dtype=torch.int32),
        outliers=outliers, steps=steps, improved=improved)
    return verified, counts


def _select_hypotheses(explained: torch.Tensor, outliers: torch.Tensor,
                       instances_valid: torch.Tensor,
                       outlier_regularizer: float = 0.001,
                       multiple_assignment_penalty: float = 1.0):
    """The search of :func:`verify_hypotheses` on a given explained
    bool[H, Ns] and outliers f32[H], exhaustive up to H = 16, greedy above:
    (verified bool[H], steps, improved), the step counts as int32 scalars
    on the device."""
    H = explained.shape[0]
    dev = explained.device
    explained = explained & instances_valid[:, None]
    outliers = torch.where(instances_valid, outliers, float("inf"))
    if H > 16:
        return hv_greedy(explained, outliers, instances_valid,
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
    costs = torch.stack(costs)
    _, best = top_k(-costs, 1)
    # a chunk improves when its minimum is below every earlier chunk's
    earlier = torch.cat([costs.new_full((1,), float("inf")),
                         torch.cummin(costs, 0).values[:-1]])
    improved = (costs < earlier).sum(dtype=torch.int32)
    steps = torch.full((), costs.shape[0], dtype=torch.int32, device=dev)
    return take(torch.stack(actives), best[0]), steps, improved


def _greedy_verify(explained: torch.Tensor, outliers: torch.Tensor,
                   valid: torch.Tensor, outlier_regularizer: float,
                   multiple_assignment_penalty: float):
    """Single-flip local search from the empty set: each of the 2H steps
    evaluates all H one-bit flips as one [H, Ns] product and takes the best
    strictly improving one. ``explained`` bool[H, Ns] is already masked by
    validity, ``outliers`` f32[H] is inf on invalid hypotheses. Returns
    (active bool[H], steps, improved) as :func:`_select_hypotheses` does."""
    H = explained.shape[0]
    dev = explained.device
    ex_f = explained.to(torch.float32)
    out_vec = torch.where(torch.isfinite(outliers), outliers, 0.0)
    eye = torch.eye(H, dtype=torch.bool, device=dev)
    active = torch.zeros(H, dtype=torch.bool, device=dev)
    cost = _cost(active.to(torch.float32)[None], ex_f, out_vec,
                 outlier_regularizer, multiple_assignment_penalty)[0]
    moved = []
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
        moved.append(better)
    steps = torch.full((), 2 * H, dtype=torch.int32, device=dev)
    return active, steps, torch.stack(moved).sum(dtype=torch.int32)


def hv_greedy(explained: torch.Tensor, outliers: torch.Tensor,
              valid: torch.Tensor, outlier_regularizer: float = 0.001,
              multiple_assignment_penalty: float = 1.0):
    """The greedy search of :func:`_greedy_verify` on ``explained``
    bool[[B,] H, Ns] (already masked by validity), ``outliers`` f32[[B,] H]
    (counts; inf on invalid hypotheses) and ``valid`` bool[[B,] H]: (active
    bool[[B,] H], steps, improved int32[[B]]).

    A CPU tensor takes :func:`_greedy_verify`, frame by frame under a
    leading batch axis. A CUDA tensor launches the kernel
    ``neighbors/csrc/hv_greedy.cu`` on the current stream, one CUDA block a
    frame, equal bit for bit while H·Ns < 2^24 (a failed build or launch
    raises). ``hv_greedy.launches`` and ``hv_greedy.by_device`` count the
    launches."""
    if explained.ndim not in (2, 3) or explained.dtype != torch.bool:
        raise ValueError(f"hv_greedy takes explained bool[[B,] H, Ns], got "
                         f"{explained.dtype}{list(explained.shape)}")
    lead, (H, Ns) = tuple(explained.shape[:-2]), explained.shape[-2:]
    if (outliers.shape != lead + (H,) or outliers.dtype != torch.float32
            or valid.shape != lead + (H,) or valid.dtype != torch.bool):
        raise ValueError(f"hv_greedy takes outliers f32{list(lead + (H,))} "
                         f"and valid bool{list(lead + (H,))}, got "
                         f"{outliers.dtype}{list(outliers.shape)} and "
                         f"{valid.dtype}{list(valid.shape)}")
    if not explained.device == outliers.device == valid.device:
        raise ValueError("hv_greedy inputs must share one device")
    args = (outlier_regularizer, multiple_assignment_penalty)
    if explained.device.type == "cpu":
        if not lead:
            return _greedy_verify(explained, outliers, valid, *args)
        per = [_greedy_verify(e, o, v, *args)
               for e, o, v in zip(explained, outliers, valid)]
        return tuple(torch.stack(x) for x in zip(*per))
    if explained.device.type != "cuda":
        raise ValueError(f"hv_greedy runs on cpu or cuda, not "
                         f"{explained.device}")
    if H * Ns >= 1 << 24:
        raise ValueError(f"hv_greedy's counts are exact in float32 below "
                         f"H·Ns = 2^24, got {H}·{Ns}")
    lib = load_library("hv_greedy")
    dev = explained.device
    ex = explained.contiguous().view(torch.uint8)
    out = outliers.contiguous()
    ok = valid.contiguous().view(torch.uint8)
    B = explained.shape[0] if lead else 1
    workspace = torch.empty(B * H * ((Ns + 31) // 32), dtype=torch.int32,
                            device=dev)
    active = torch.empty(lead + (H,), dtype=torch.bool, device=dev)
    steps = torch.empty(lead, dtype=torch.int32, device=dev)
    improved = torch.empty(lead, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.tj_hv_greedy(ex.data_ptr(), out.data_ptr(), ok.data_ptr(),
                              workspace.data_ptr(), active.data_ptr(),
                              steps.data_ptr(), improved.data_ptr(), B, H, Ns,
                              *map(float, args), stream)
    if rc != 0:
        raise RuntimeError(f"hv_greedy kernel launch failed: cudaError_t {rc}")
    with _count_lock:             # K1's: request threads launch concurrently
        _counted.launches += 1
        _counted.by_device[dev.index] += 1
    return active, steps, improved


hv_greedy.launches = 0
hv_greedy.by_device = Counter()
_counted = hv_greedy      # the counters' owner, even while a test wraps it
