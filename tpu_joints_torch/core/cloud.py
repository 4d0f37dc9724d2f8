"""Padded point-cloud container (counterpart of ``tpu_joints/core/cloud.py``).

A cloud is a fixed-capacity ``[N, 3]`` tensor plus a validity mask; filters
update the mask instead of compacting, and invalid lanes sit at a far-away
sentinel so distance-based ops ignore them even before masking.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Far enough that padded points never enter a real neighbourhood, small
# enough that squared distances stay finite in float32 (3e12 << 3.4e38).
SENTINEL = 1.0e6


class Cloud(NamedTuple):
    """xyz float32[N, 3] (SENTINEL on invalid lanes), mask bool[N],
    rgb float32[N, 3] (zeros when absent)."""

    xyz: torch.Tensor
    mask: torch.Tensor
    rgb: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> torch.Tensor:
        """Number of valid points (int32 tensor, no host sync)."""
        return self.mask.sum(dtype=torch.int32)


def bucket_size(n: int, minimum: int = 256) -> int:
    """Round ``n`` up to a power of two (at least ``minimum``)."""
    size = minimum
    while size < n:
        size *= 2
    return size


def make_cloud(xyz, rgb=None, capacity: Optional[int] = None,
               device="cpu") -> Cloud:
    """Padded Cloud on ``device`` from host arrays, dropping NaN/Inf points."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    if rgb is not None:
        rgb = np.asarray(rgb, dtype=np.float32).reshape(-1, 3)[finite]
    n = xyz.shape[0]
    cap = capacity if capacity is not None else bucket_size(n)
    if n > cap:
        raise ValueError(f"cloud with {n} points exceeds capacity {cap}")
    pad = cap - n
    xyz_p = np.concatenate([xyz, np.full((pad, 3), SENTINEL, np.float32)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    rgb_p = (np.zeros((cap, 3), np.float32) if rgb is None
             else np.concatenate([rgb, np.zeros((pad, 3), np.float32)]))
    return Cloud(xyz=torch.as_tensor(xyz_p, device=device),
                 mask=torch.as_tensor(mask, device=device),
                 rgb=torch.as_tensor(rgb_p, device=device))
