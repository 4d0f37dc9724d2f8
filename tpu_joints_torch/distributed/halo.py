"""Ring-sharded neighbour search, ICP and matching for clouds larger than
one device (counterpart of ``tpu_joints/distributed/halo.py``).

A giant cloud is split point-wise over one mesh axis. :func:`ring_knn`
rotates the source blocks around the ring (``ppermute``: each block moves
to the next device with ``.to(..., non_blocking=True)``) and merges a
running top-k with global indices; :func:`ring_icp` does the same for the
nearest neighbour, carrying the coordinates, and solves each rigid update
from ``psum``-reduced Umeyama moments; :func:`halo_radius_neighbors`
exchanges only the boundary bands of slab-sorted shards;
:func:`sharded_match_votes` matches replicated scene descriptors against a
view-sharded bank.

The block math is the JAX package's, which computes it outside any Pallas
call: the expansion form ``|q|² + |s|² − 2q·s`` clamped at 0, masked
sources at ``INF``, and ``lax.top_k``'s order (ascending, ties to the
lower position: ``core.ops.top_k``). It stays plain torch here. Query rows
are taken in blocks of at most ``_BLOCK_ELEMS`` distances, so memory stays
bounded; no result depends on the blocking. All work is issued from the calling thread: each device's
kernels queue on its current stream, and nothing reads a value to the
host.

Inputs are whole tensors on any device; they are placed over ``axis``
(``mesh.device_put``) and the results come back concatenated on its first
device, as the all-gather of a sharded output.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from tpu_joints_torch.core.ops import fused_sumsq, top_k
from tpu_joints_torch.core.transforms import kabsch_rotation
from tpu_joints_torch.distributed.mesh import (Mesh, Sharding, all_gather,
                                               device_put, psum)

INF = 3.0e38
# distances per query block of a shard's step
_BLOCK_ELEMS = 1 << 26


def _sqn(v: torch.Tensor) -> torch.Tensor:
    """Row squared norms as XLA's CPU backend reduces them (chained FMAs
    for 3-vectors)."""
    return fused_sumsq(v) if v.shape[-1] == 3 else (v * v).sum(-1)


def _split(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """``x``'s pieces over ``axis``, on that axis' devices."""
    return device_put(x, Sharding(mesh, axis)).shards()


def _rows(n_cols: int) -> int:
    return max(1, _BLOCK_ELEMS // max(n_cols, 1))


def _expansion(q: torch.Tensor, q2: torch.Tensor, s: torch.Tensor,
               s2: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[rows, N] q2 + s2 − 2 q·sᵀ, clamped at 0, INF on masked sources."""
    d = q2[:, None] + s2[None, :] - 2.0 * (q @ s.T)
    return torch.where(m[None, :], torch.clamp_min(d, 0.0), INF)


def ring_knn(query: torch.Tensor, source: torch.Tensor,
             source_mask: torch.Tensor, k: int, mesh: Mesh,
             axis: str = "model") -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN with query and source both split point-wise over ``axis``
    (sizes divisible by its device count). Source blocks travel around the
    ring; step t of device j merges the block of device (j − t) mod n.

    Returns (dist_sq float32[M, k], idx int32[M, k]) — global source rows,
    on the axis' first device.
    """
    devs = mesh.axis_devices(axis)
    n = len(devs)
    qs, ss, ms = (_split(t, mesh, axis) for t in (query, source, source_mask))
    n_local = ss[0].shape[0]
    q2s = [_sqn(q) for q in qs]
    best = [[(q.new_full((r.shape[0], k), INF),
              torch.zeros((r.shape[0], k), dtype=torch.int64,
                          device=q.device))
             for r in torch.split(q, _rows(n_local))] for q in qs]
    kb = min(k, n_local)
    for step in range(n):
        for j in range(n):
            s, m = ss[j], ms[j]
            s2 = _sqn(s)
            base = ((j - step) % n) * n_local
            R = _rows(n_local)
            for b, r in enumerate(range(0, qs[j].shape[0], R)):
                d = _expansion(qs[j][r:r + R], q2s[j][r:r + R], s, s2, m)
                bd, bp = top_k(d, kb, largest=False)         # the block's own top-k
                cd = torch.cat([best[j][b][0], bd], 1)
                ci = torch.cat([best[j][b][1], bp + base], 1)
                vd, p = top_k(cd, k, largest=False)
                best[j][b] = (vd, ci.gather(1, p))
        if step + 1 < n:       # ppermute j -> j + 1
            ss = [ss[(j - 1) % n].to(devs[j], non_blocking=True)
                  for j in range(n)]
            ms = [ms[(j - 1) % n].to(devs[j], non_blocking=True)
                  for j in range(n)]
    d = all_gather([torch.cat([b[0] for b in bj]) for bj in best])
    i = all_gather([torch.cat([b[1] for b in bj]) for bj in best])
    return d, i.to(torch.int32)


def _ring_nn1_with_coords(qs, ss, ms, devs):
    """Nearest source of every local query over the whole ring, carrying
    the matched coordinates (each device only ever holds one source block,
    so the winner's xyz travels with the running best)."""
    n = len(devs)
    best_d = [q.new_full((q.shape[0],), INF) for q in qs]
    best_q = [torch.zeros_like(q) for q in qs]
    q2s = [_sqn(q) for q in qs]
    for step in range(n):
        for j in range(n):
            s, m, q2 = ss[j], ms[j], q2s[j]
            s2 = _sqn(s)
            R = _rows(s.shape[0])
            for r in range(0, qs[j].shape[0], R):
                d = _expansion(qs[j][r:r + R], q2[r:r + R], s, s2, m)
                dj, a = d.min(dim=1)               # first index of the minimum
                closer = dj < best_d[j][r:r + R]
                best_d[j][r:r + R] = torch.where(closer, dj,
                                                 best_d[j][r:r + R])
                best_q[j][r:r + R] = torch.where(closer[:, None], s[a],
                                                 best_q[j][r:r + R])
        if step + 1 < n:
            ss = [ss[(j - 1) % n].to(devs[j], non_blocking=True)
                  for j in range(n)]
            ms = [ms[(j - 1) % n].to(devs[j], non_blocking=True)
                  for j in range(n)]
    return best_d, best_q


def ring_icp(src_xyz: torch.Tensor, src_mask: torch.Tensor,
             target: torch.Tensor, target_mask: torch.Tensor, mesh: Mesh,
             axis: str = "model", iterations: int = 10,
             max_corr_dist: float = 3.0e38) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-to-point ICP with both clouds split point-wise over ``axis``.

    Per iteration each device's source rows find their target NN around
    the ring (:func:`_ring_nn1_with_coords`); the moments Σw, Σw·p, Σw·q and
    H = Σ w (p − p̄)(q − q̄)ᵀ are psum'd in shard order on the first device,
    which solves the rotation with the closed-form Kabsch of
    ``core.transforms`` (no SVD: its info check would read the host) and
    sends the updated pose to the others.

    Returns (T float32[4, 4], fitness float32 — the mean squared inlier NN
    distance at the final pose), on the axis' first device.
    """
    devs = mesh.axis_devices(axis)
    n = len(devs)
    s_, sm_, t_, tm_ = (_split(t, mesh, axis)
                        for t in (src_xyz, src_mask, target, target_mask))
    smf = [m.to(torch.float32) for m in sm_]
    max_sq = float(np.float32(min(max_corr_dist, 1.0e19)) ** 2)
    dev0 = devs[0]

    def weights(d, j):
        return smf[j] * (d <= max_sq) * (d < INF)

    def moved_by(T):
        Ts = [T.to(d, non_blocking=True) for d in devs]
        return [s_[j] @ Ts[j][:3, :3].T + Ts[j][:3, 3] for j in range(n)]

    T = torch.eye(4, dtype=torch.float32, device=dev0)
    for _ in range(iterations):
        moved = moved_by(T)
        d, q = _ring_nn1_with_coords(moved, t_, tm_, devs)
        w = [weights(d[j], j) for j in range(n)]
        wsum = psum([wj.sum() for wj in w])
        p_bar = psum([(w[j][:, None] * moved[j]).sum(0) for j in range(n)])
        q_bar = psum([(w[j][:, None] * q[j]).sum(0) for j in range(n)])
        wsafe = torch.clamp_min(wsum, 1e-12)
        p_bar, q_bar = p_bar / wsafe, q_bar / wsafe
        pb = [p_bar.to(dv, non_blocking=True) for dv in devs]
        qb = [q_bar.to(dv, non_blocking=True) for dv in devs]
        H = psum([(w[j][:, None] * (moved[j] - pb[j])).T @ (q[j] - qb[j])
                  for j in range(n)])
        R = kabsch_rotation(H.T)          # H here is Σ p qᵀ: Kabsch takes q pᵀ
        delta = torch.eye(4, dtype=torch.float32, device=dev0)
        delta[:3, :3] = R
        delta[:3, 3] = q_bar - R @ p_bar
        T = delta @ T
    moved = moved_by(T)
    d, _ = _ring_nn1_with_coords(moved, t_, tm_, devs)
    w = [weights(d[j], j) for j in range(n)]
    num = psum([(w[j] * torch.clamp_max(d[j], 1e30)).sum() for j in range(n)])
    den = torch.clamp_min(psum([wj.sum() for wj in w]), 1.0)
    return T, num / den


def halo_radius_neighbors(xyz: torch.Tensor, mask: torch.Tensor,
                          radius: float, k_max: int, mesh: Mesh,
                          axis: str = "model", halo: int = 256,
                          slab_axis: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-radius self-neighbourhoods of a slab-sorted cloud split over
    ``axis``, exchanging only boundary bands: each device sends the
    ``halo`` points nearest each of its slab edges (those within
    ``radius`` of the edge count) one ring step each way; the ends of the
    slab line exchange nothing (the wrap-around halos are masked).

    Contract (the JAX package's): ``radius`` must not exceed any slab's
    extent along ``slab_axis``, and ``halo`` must be at least the number
    of points within ``radius`` of a slab edge (a smaller one silently
    truncates). ``halo`` is clamped to the shard size.

    Returns (idx int32[N, k_max] — global rows, valid bool, dist_sq f32)
    on the axis' first device.
    """
    devs = mesh.axis_devices(axis)
    n = len(devs)
    xs, ms = _split(xyz, mesh, axis), _split(mask, mesh, axis)
    n_local = xs[0].shape[0]
    halo = min(halo, n_local)
    r = float(np.float32(radius))
    r2 = float(np.float32(radius) * np.float32(radius))
    to_left, to_right = [], []
    for j in range(n):
        x, m = xs[j], ms[j]
        gidx = j * n_local + torch.arange(n_local, device=x.device)
        c = x[:, slab_axis]
        lo = torch.where(m, c, float("inf")).min()
        hi = torch.where(m, c, float("-inf")).max()
        d_lo = torch.where(m, c - lo, float("inf"))   # above my lower edge
        d_hi = torch.where(m, hi - c, float("inf"))   # below my upper edge
        for d, out in ((d_lo, to_left), (d_hi, to_right)):
            v, sel = top_k(d[None], halo, largest=False)
            out.append((x[sel[0]], m[sel[0]] & (v[0] <= r), gidx[sel[0]]))
    idx, valid, dist = [], [], []
    for j in range(n):
        x, m = xs[j], ms[j]
        dev = x.device
        fl = [t.to(dev, non_blocking=True) for t in to_right[(j - 1) % n]]
        fr = [t.to(dev, non_blocking=True) for t in to_left[(j + 1) % n]]
        fl[1] = fl[1] & (j > 0)                # the slab line is not periodic
        fr[1] = fr[1] & (j < n - 1)
        src = torch.cat([x, fl[0], fr[0]])
        src_m = torch.cat([m, fl[1], fr[1]])
        src_g = torch.cat([j * n_local + torch.arange(n_local, device=dev),
                           fl[2], fr[2]])
        s2, q2 = _sqn(src), _sqn(x)
        R = _rows(src.shape[0])
        for a in range(0, n_local, R):
            d = _expansion(x[a:a + R], q2[a:a + R], src, s2, src_m)
            v, p = top_k(d, k_max, largest=False)
            dist.append(v)
            idx.append(src_g[p])
            valid.append(v <= r2)
    return all_gather(idx).to(torch.int32), all_gather(valid), all_gather(dist)


def sharded_match_votes(scene_desc: torch.Tensor, bank_desc: torch.Tensor,
                        bank_valid: torch.Tensor, threshold: float,
                        mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """Per-view counts int32[V] of scene keypoints whose nearest valid key
    of that view is within the squared-distance ``threshold``, with the
    [V, Mk, D] bank split over ``axis`` by views and the scene descriptors
    replicated; the per-view counts are gathered on the first device."""
    devs = mesh.axis_devices(axis)
    bds, bvs = _split(bank_desc, mesh, axis), _split(bank_valid, mesh, axis)
    votes = []
    for j, dev in enumerate(devs):
        sd, bd = scene_desc.to(dev, non_blocking=True), bds[j]
        Vl, Mk, D = bd.shape
        flat = bd.reshape(Vl * Mk, D)
        d = (sd * sd).sum(-1, keepdim=True) + (flat * flat).sum(-1)[None] \
            - 2.0 * (sd @ flat.T)
        d = torch.clamp_min(d, 0.0).reshape(-1, Vl, Mk)
        d = torch.where(bvs[j][None], d, INF)
        d1 = d.amin(-1)                                   # [Ms, Vl]
        votes.append((d1 < threshold).sum(0, dtype=torch.int32))
    return all_gather(votes)
