"""Descriptor correspondences (counterpart of
``tpu_joints/recognize/matching.py``; only the container is on the main
path — ``pipelines.detect.match_bank`` fills it)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Correspondences(NamedTuple):
    """Per scene keypoint: nearest model keypoint ``model_idx`` (int64),
    gate passed ``valid`` (bool), squared descriptor distance ``dist_sq``.
    ``match_bank`` returns them with a leading view axis."""

    model_idx: torch.Tensor
    valid: torch.Tensor
    dist_sq: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)
