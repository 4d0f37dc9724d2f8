"""Region growing on the organized sensor lattice (counterpart of
``tpu_joints/segment/organized.py``).

On a sensor scan the neighbour structure is the pixel lattice, so the
growth relation of ``segment/region_growing.py`` needs no neighbour search:
it is evaluated once per 8-neighbourhood direction as shifted-plane
compares, and the connected components come from iterated min-label
propagation with pointer jumping. A directed edge i→j exists when i may
seed (curvature(i) < threshold), the normals agree within the smoothness
angle and the 3-D edge is shorter than ``max_edge``.

Sweep schedule: the reference loops until a sweep changes nothing or
``max_sweeps`` sweeps ran. A sweep past the fixpoint changes nothing, so
here sweeps run in chunks of ``SWEEPS_PER_CHECK`` with one host read of
the last sweep's change flag after each chunk (the only host
synchronisations of the module; ``region_growing_lattice.host_checks``
counts them), never beyond ``max_sweeps``, and a chunk that ends at
``max_sweeps`` is not checked. The labels equal the reference's whatever
the chunk. With ``SWEEPS_PER_CHECK = 0`` all ``max_sweeps`` sweeps run and
nothing is read: that schedule keeps the frame free of host reads but
launches 64 sweeps where 8 do, and measured slower on an H100 (PERF.md);
``breakdown.py`` sets it to time the two against each other. In a captured
chain (``core/graphs.py``) the sweeps run with no read at all: one chunk
with its change flag kept for the replay, or all ``max_sweeps``.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_joints_torch.core import graphs
from tpu_joints_torch.segment.region_growing import Clusters

# 8-neighbourhood offsets (row, col)
_DIRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))

SWEEPS_PER_CHECK = 8


def _shift2d(a: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """``a`` [H, W, ...] shifted so that out[r, c] = a[r + dr, c + dc]
    (edge → fill), for dr, dc in {-1, 0, 1}."""
    H, W = a.shape[:2]
    out = torch.full_like(a, fill)
    out[max(-dr, 0):H - max(dr, 0), max(-dc, 0):W - max(dc, 0)] = \
        a[max(dr, 0):H + min(dr, 0), max(dc, 0):W + min(dc, 0)]
    return out


def _sweep(labels, edge_in, valid, N):
    """One min-label propagation sweep over the 8 directions plus two
    pointer-jumping steps; labels int64[H, W]. Returns (new labels, whether
    any label changed as a bool tensor)."""
    H, W = labels.shape
    padded = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=N)
    nb = torch.stack([padded[1 + dr:H + 1 + dr, 1 + dc:W + 1 + dc]
                      for dr, dc in _DIRS])
    new = torch.minimum(labels, torch.where(edge_in, nb, N).amin(0))
    # pointer jumping on the flat layout: labels are lattice indices, so
    # chasing new[new] splices directed paths; invalid lanes (label N) read
    # lane N - 1
    f = new.reshape(N)
    for _ in range(2):
        f = torch.minimum(f, f[torch.clamp_max(f, N - 1)])
    new = torch.where(valid, f.reshape(H, W), N)
    return new, (new != labels).any()


def region_growing_lattice(xyz: torch.Tensor, normals: torch.Tensor,
                           curvature: torch.Tensor, valid: torch.Tensor,
                           smoothness_deg: float = 7.0,
                           curvature_threshold: float = 7.0,
                           min_cluster_size: int = 50, max_sweeps: int = 64,
                           max_edge: float = 3.0e38) -> Clusters:
    """Connected smooth regions over an organized [H, W] node lattice.

    xyz/normals float32[H, W, 3]; curvature/valid [H, W]; other parameters
    as in ``region_growing``. Returns Clusters over the flat [H·W] layout
    (labels are flat lattice indices; -1 for invalid or undersized)."""
    H, W = curvature.shape
    N = H * W
    # in float32 as the reference takes them, on the host: a Python float
    # holding that value compares like the float32 scalar
    cos_thresh = float(torch.cos(torch.deg2rad(torch.tensor(
        smoothness_deg, dtype=torch.float32))))
    edge_cap_sq = float(np.float32(min(float(max_edge) ** 2, 1e30)))

    # per-direction growth gates, evaluated once as shifted-plane compares
    gates = []
    for dr, dc in _DIRS:
        nb_xyz = _shift2d(xyz, dr, dc, 3e38)
        nb_nrm = _shift2d(normals, dr, dc, 0.0)
        nb_cur = _shift2d(curvature, dr, dc, 3e38)
        nb_ok = _shift2d(valid, dr, dc, False)
        d2 = ((nb_xyz - xyz) ** 2).sum(-1)
        cos = (nb_nrm * normals).sum(-1).abs()
        gates.append(valid & nb_ok & (d2 < edge_cap_sq) & (cos >= cos_thresh)
                     & (nb_cur < curvature_threshold))
    edge_in = torch.stack(gates)              # [8, H, W]: neighbour d → node

    flat_idx = torch.arange(N, device=valid.device).reshape(H, W)
    labels = torch.where(valid, flat_idx, N)
    chunk_max = SWEEPS_PER_CHECK if SWEEPS_PER_CHECK > 0 else max_sweeps
    sweeps = 0
    fixed = graphs.fixed_sweeps(SWEEPS_PER_CHECK, max_sweeps)
    if fixed is not None:               # a captured chain reads nothing
        for _ in range(fixed):
            labels, changed = _sweep(labels, edge_in, valid, N)
        if fixed < max_sweeps:
            graphs.note_unsettled(changed)
        sweeps = max_sweeps
    while sweeps < max_sweeps:
        chunk = min(chunk_max, max_sweeps - sweeps)
        for _ in range(chunk):
            labels, changed = _sweep(labels, edge_in, valid, N)
        sweeps += chunk
        if sweeps >= max_sweeps:
            break
        region_growing_lattice.host_checks += 1
        if not bool(changed):
            break

    flat = labels.reshape(N)
    vflat = valid.reshape(N)
    lab = torch.clamp_max(flat, N - 1)
    sizes = torch.zeros(N, dtype=torch.int64, device=lab.device).scatter_add_(
        0, lab, vflat.long())
    big = sizes[lab] >= min_cluster_size
    flat = torch.where(vflat & big, flat, -1)
    return Clusters(labels=flat.to(torch.int32), sizes=sizes.to(torch.int32))


region_growing_lattice.host_checks = 0
