"""Descriptor nearest-neighbour matching (counterpart of
``tpu_joints/recognize/matching.py``): per scene keypoint, its nearest
model keypoint under an absolute squared-distance gate (``match_nn``) or a
2-NN ratio gate d1/d2 <= τ (``match_ratio``). ``pipelines.detect.match_bank``
runs the same gates against every bank view at once."""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_joints_torch.neighbors.bruteforce import knn


class Correspondences(NamedTuple):
    """Per scene keypoint: nearest model keypoint ``model_idx`` (int64),
    gate passed ``valid`` (bool), squared descriptor distance ``dist_sq``.
    ``match_bank`` returns them with a leading view axis."""

    model_idx: torch.Tensor
    valid: torch.Tensor
    dist_sq: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def match_nn(scene_desc: torch.Tensor, scene_valid: torch.Tensor,
             model_desc: torch.Tensor, model_valid: torch.Tensor,
             max_dist_sq: float = 0.25) -> Correspondences:
    """1-NN matching with an absolute squared-distance gate."""
    d, i = knn(scene_desc, model_desc, 1, source_mask=model_valid)
    ok = scene_valid & (d[:, 0] < max_dist_sq)
    return Correspondences(model_idx=i[:, 0].long(), valid=ok, dist_sq=d[:, 0])


def match_ratio(scene_desc: torch.Tensor, scene_valid: torch.Tensor,
                model_desc: torch.Tensor, model_valid: torch.Tensor,
                ratio: float = 1.0) -> Correspondences:
    """2-NN ratio-test matching: accept when d1/d2 <= ratio (τ = 1, the
    reference's, accepts all but uninformative second neighbours)."""
    d, i = knn(scene_desc, model_desc, 2, source_mask=model_valid)
    d1, d2 = d[:, 0], d[:, 1]
    ok = scene_valid & (d1 <= ratio * ratio * torch.clamp_min(d2, 1e-20)) \
        & (d2 < 1e30)
    return Correspondences(model_idx=i[:, 0].long(), valid=ok, dist_sq=d1)
