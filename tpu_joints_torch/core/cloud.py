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

    def with_mask(self, mask: torch.Tensor) -> "Cloud":
        """Replace the mask, re-sentineling newly invalid lanes."""
        mask = mask & self.mask
        xyz = torch.where(mask[:, None], self.xyz, SENTINEL)
        return Cloud(xyz=xyz, mask=mask, rgb=self.rgb)


def card_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device when none is
    available raises, so an entry point never carries on on the CPU unless
    the caller asked for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def bucket_size(n: int, minimum: int = 256) -> int:
    """Round ``n`` up to a power of two (at least ``minimum``)."""
    size = minimum
    while size < n:
        size *= 2
    return size


def make_cloud(xyz, rgb=None, capacity: Optional[int] = None,
               device="cuda") -> Cloud:
    """Padded Cloud on ``device`` (the card unless asked otherwise) from host
    arrays, dropping NaN/Inf points."""
    device = card_device(device)
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


def pad_cloud(cloud: Cloud, capacity: int) -> Cloud:
    """``cloud`` grown to ``capacity`` lanes of padding."""
    n = cloud.capacity
    if capacity < n:
        raise ValueError(f"cannot shrink cloud capacity {n} -> {capacity}")
    if capacity == n:
        return cloud
    pad = capacity - n
    return Cloud(xyz=torch.cat([cloud.xyz, cloud.xyz.new_full((pad, 3),
                                                              SENTINEL)]),
                 mask=torch.cat([cloud.mask, cloud.mask.new_zeros(pad)]),
                 rgb=torch.cat([cloud.rgb, cloud.rgb.new_zeros((pad, 3))]))


def to_numpy(cloud: Cloud) -> np.ndarray:
    """The valid points as a compact host array [n, 3]."""
    mask = cloud.mask.cpu().numpy()
    return cloud.xyz.cpu().numpy()[mask]
