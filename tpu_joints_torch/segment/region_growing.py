"""Region growing over a kNN graph + per-cluster curvature filter
(counterpart of ``tpu_joints/segment/region_growing.py``).

Replaces PCL's ``RegionGrowing`` and the reference's mean-curvature cluster
rejection: a directed edge i→n exists when neighbour i may seed
(curvature(i) < curvature_threshold), the normals agree within the
smoothness angle and the edge is shorter than ``max_edge``; min-label
propagation with pointer jumping computes the connected components of that
relation. The kNN graph (2 <= k <= 32) is one launch of kernel K2.

Sweep schedule: the reference loops until a sweep changes nothing or
``max_sweeps`` sweeps ran. A sweep past the fixpoint changes nothing, so
here sweeps run in chunks of ``SWEEPS_PER_CHECK`` with one host read of the
last sweep's change flag after each chunk (the only host synchronisations
of the module), never beyond ``max_sweeps``: the labels equal the
reference's. A chunk that ends at ``max_sweeps`` is not checked. So a call
whose first sweep that changes nothing is sweep s makes ceil(s / 8) host
reads (one fewer when the chunk that holds sweep s ends at ``max_sweeps``);
``region_growing.host_checks`` counts them. In a captured chain
(``core/graphs.py``) the sweeps run with no read: one chunk with its change
flag kept for the replay, or all ``max_sweeps``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_joints_torch.core import graphs
from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.ops import scatter_add
from tpu_joints_torch.neighbors.bruteforce import knn

SWEEPS_PER_CHECK = 8


class Clusters(NamedTuple):
    """labels int32[N]: cluster id = smallest member index, -1 for invalid
    or undersized; sizes int32[N]: size of the cluster with that label id
    (0 elsewhere)."""

    labels: torch.Tensor
    sizes: torch.Tensor


def _sweep(labels, nbr, edge_in, mask, N):
    """One min-label propagation sweep plus two pointer-jumping steps;
    returns (new labels, whether any label changed as a bool tensor)."""
    nbr_lab = torch.where(edge_in, labels[nbr], N)
    new = torch.minimum(labels, nbr_lab.amin(1))
    for _ in range(2):
        new = torch.minimum(new, new[torch.clamp_max(new, N - 1).long()])
    new = torch.where(mask, new, N)
    return new, (new != labels).any()


def region_growing(cloud: Cloud, normals: torch.Tensor,
                   curvature: torch.Tensor, k: int = 30,
                   smoothness_deg: float = 7.0,
                   curvature_threshold: float = 7.0,
                   min_cluster_size: int = 50, max_sweeps: int = 200,
                   max_edge: float = 3.0e38) -> Clusters:
    """Connected smooth regions of ``cloud``; ``max_edge`` (metres) caps the
    length of graph edges so an uncapped kNN cannot bridge disjoint
    structures."""
    N = cloud.capacity
    d, idx = knn(cloud.xyz, cloud.xyz, k, source_mask=cloud.mask)
    nbr = idx.long()
    # d is squared; the cap also excludes the masked-source 3e38 slots
    edge_cap_sq = float(np.float32(min(float(max_edge) ** 2, 1e30)))
    nbr_ok = (d < edge_cap_sq) & cloud.mask[:, None]
    # in float32 as the reference takes it, on the host: a Python float
    # holding that value compares like the float32 scalar
    cos_thresh = float(torch.cos(torch.deg2rad(torch.tensor(
        smoothness_deg, dtype=torch.float32))))
    cos = torch.einsum("nkj,nj->nk", normals[nbr], normals).abs()
    seed_ok = curvature[nbr] < curvature_threshold
    edge_in = nbr_ok & (cos >= cos_thresh) & seed_ok   # idx[n, k] -> n

    arange = torch.arange(N, dtype=torch.int32, device=cloud.xyz.device)
    labels = torch.where(cloud.mask, arange, N)
    sweeps = 0
    fixed = graphs.fixed_sweeps(SWEEPS_PER_CHECK, max_sweeps)
    if fixed is not None:               # a captured chain reads nothing
        for _ in range(fixed):
            labels, changed = _sweep(labels, nbr, edge_in, cloud.mask, N)
        if fixed < max_sweeps:
            graphs.note_unsettled(changed)
        sweeps = max_sweeps
    while sweeps < max_sweeps:
        chunk = min(SWEEPS_PER_CHECK, max_sweeps - sweeps)
        for _ in range(chunk):
            labels, changed = _sweep(labels, nbr, edge_in, cloud.mask, N)
        sweeps += chunk
        if sweeps >= max_sweeps:
            break
        region_growing.host_checks += 1
        if not bool(changed):
            break

    lab = torch.clamp_max(labels, N - 1).long()
    sizes = torch.zeros(N, dtype=torch.int64, device=lab.device).scatter_add_(
        0, lab, cloud.mask.long()).to(torch.int32)
    big = sizes[lab] >= min_cluster_size
    labels = torch.where(cloud.mask & big, labels, -1)
    return Clusters(labels=labels, sizes=sizes)


region_growing.host_checks = 0


def cluster_curvature_filter(clusters: Clusters, curvature: torch.Tensor,
                             mask: torch.Tensor,
                             max_mean_curvature: float = 0.04) -> torch.Tensor:
    """bool[N]: points in clusters whose mean curvature is at most
    ``max_mean_curvature`` (smooth pipe surface passes; weld seams and
    clutter fail). Sums per cluster in lane order, as the reference's
    scatter-add runs on the CPU."""
    N = curvature.shape[0]
    lab = torch.clamp(clusters.labels, 0, N - 1).long()
    valid = mask & (clusters.labels >= 0)
    w = valid.to(torch.float32)
    sums = scatter_add(lab, curvature * w, N)
    cnts = scatter_add(lab, w, N)
    mean = sums / torch.clamp_min(cnts, 1.0)
    keep_cluster = mean <= max_mean_curvature
    return valid & keep_cluster[lab]
