"""Two-layer coarse-to-fine ("cluster tree") view search (counterpart of
``tpu_joints/pipelines/cluster_tree.py``).

The reference's ``FPFH_scenes_clustered.cpp`` first matches a few
cluster-representative poses (``:298-319``), picks the best cluster by ICP
score (``:504-509``), then searches every pose of the chosen clusters
(``:594-628``). Both layers run the standard pipeline
(``detect_with_features``) on gathered view subsets; the cluster choice is
a ``top_k`` and a gather on the device, and the scene features are
extracted once for both layers.

The clusters are a host-side spherical k-means over the bank's camera
viewing directions (a numpy copy of the reference's), whose tables are
uploaded to the bank's device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_joints_torch.config import DetectionConfig
from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.core.ops import top_k
from tpu_joints_torch.modelbank.bank import ModelBank, gather_views
from tpu_joints_torch.pipelines.detect import (DetectionResult,
                                               detect_with_features,
                                               prepare_scene)

_BIG = 3e38


class ViewClusters(NamedTuple):
    """Cluster tables on the bank's device.

    representatives: int32[K] — one view per cluster (closest to centroid).
    members: int32[K, M] — member view indices, padded by repeating the
      representative (duplicated views just duplicate candidates).
    """

    representatives: torch.Tensor
    members: torch.Tensor


def make_view_clusters(bank: ModelBank, n_clusters: int = 3, seed: int = 0,
                       iters: int = 32) -> ViewClusters:
    """Spherical k-means over camera viewing directions (host-side)."""
    poses = bank.poses.cpu().numpy()  # [V, 4, 4] model→camera
    # camera viewing direction in the model frame = R^T @ [0,0,1]
    dirs = poses[:, 2, :3]  # third row of R
    dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    V = dirs.shape[0]
    n_clusters = min(n_clusters, V)

    rng = np.random.default_rng(seed)
    centers = dirs[rng.choice(V, n_clusters, replace=False)]
    for _ in range(iters):
        sim = dirs @ centers.T                      # [V, K]
        assign = sim.argmax(1)
        for k in range(n_clusters):
            sel = dirs[assign == k]
            if len(sel):
                c = sel.mean(0)
                centers[k] = c / max(np.linalg.norm(c), 1e-9)

    sim = dirs @ centers.T
    assign = sim.argmax(1)
    reps, members = [], []
    m_max = max(int((assign == k).sum()) for k in range(n_clusters))
    m_max = max(m_max, 1)
    for k in range(n_clusters):
        idx = np.flatnonzero(assign == k)
        if len(idx) == 0:
            idx = np.array([int(np.argmax(sim[:, k]))])
        rep = idx[int(np.argmax(dirs[idx] @ centers[k]))]
        reps.append(rep)
        pad = np.full(m_max, rep, np.int32)
        pad[: len(idx)] = idx
        members.append(pad)
    return ViewClusters(
        representatives=torch.as_tensor(np.asarray(reps, np.int32),
                                        device=bank.device),
        members=torch.as_tensor(np.stack(members), device=bank.device))


def detect_tree(scene: Cloud, bank: ModelBank, clusters: ViewClusters,
                cfg: DetectionConfig = DetectionConfig(),
                viewpoint: Optional[torch.Tensor] = None,
                n_refine: int = 2) -> DetectionResult:
    """Layer 1 on the representatives → the ``n_refine`` clusters with the
    best candidate fitness → layer 2 on their members. Returns the layer-2
    result with view indices mapped back to the full bank's numbering, and
    ``metrics["cluster_id"]`` / ``["layer1_fitness"]`` of the best cluster.
    For V views in K clusters this matches ~K + n_refine·V/K views."""
    feats = prepare_scene(scene, cfg, viewpoint)
    K = clusters.representatives.shape[0]
    n_refine = min(n_refine, K)

    layer1 = detect_with_features(
        feats, gather_views(bank, clusters.representatives), cfg)
    # per-cluster best candidate fitness (the reference picks the cluster
    # by the lowest layer-1 ICP score)
    fit = torch.where(layer1.cand_valid, layer1.cand_fitness, _BIG)
    own = layer1.cand_views[None, :] == torch.arange(K, device=fit.device)[:, None]
    per_cluster = torch.where(own, fit[None, :], _BIG).amin(1)
    _, top_clusters = top_k(-per_cluster, n_refine)

    member_idx = clusters.members[top_clusters].reshape(-1).long()
    layer2 = detect_with_features(feats, gather_views(bank, member_idx), cfg)
    return layer2._replace(
        view_idx=member_idx[layer2.view_idx],
        cand_views=member_idx[layer2.cand_views],
        metrics={**layer2.metrics, "cluster_id": top_clusters[0],
                 "layer1_fitness": per_cluster[top_clusters[0]]})
