"""Centroid-offset edge detector (counterpart of
``tpu_joints/features/edges.py``).

The reference's hand-rolled detector (``Edge_detection.cpp:108-149``): for
each point take its k nearest neighbours, compute their centroid, and flag
the point as an edge when the offset |centroid - point| exceeds a threshold
on any axis. One batched kNN (kernel K2 for 2 <= k <= 32, the sort path
above) and a reduction.
"""
from __future__ import annotations

import torch

from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.neighbors.bruteforce import knn


def detect_edges(cloud: Cloud, k: int = 100,
                 threshold: float = 0.004) -> torch.Tensor:
    """bool[N]: True where the point is an edge (reference gate 0.004,
    ``Edge_detection.cpp:136-145``; k=100 at ``:116-120``)."""
    d, idx = knn(cloud.xyz, cloud.xyz, k, source_mask=cloud.mask)
    valid = (d < 1e30) & cloud.mask[:, None]
    w = valid.to(torch.float32)
    cnt = torch.clamp_min(w.sum(1), 1.0)
    centroid = (cloud.xyz[idx.long()] * w[..., None]).sum(1) / cnt[:, None]
    offset = (centroid - cloud.xyz).abs()
    return (offset > threshold).any(-1) & cloud.mask
