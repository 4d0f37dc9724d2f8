"""The reference's random draws, reproduced without JAX.

The reference draws its RANSAC samples with ``jax.random.choice(key, N,
shape, p=p)``, which is

    p_cuml = cumsum(p);  r = p_cuml[-1] * (1 - uniform(key, shape))
    idx = searchsorted(p_cuml, r)          # left side

so the uniforms depend on the key alone and the indices on the frame
through the float32 cumulative sum. ``uniform`` reproduces the uniforms
(threefry2x32 counter mode over the row-major element index, the bits of
the two output words xor-ed, 23 mantissa bits into [1, 2) minus 1: JAX's
default ``jax_threefry_partitionable=True`` scheme) in numpy on the host;
``choice`` reproduces the indices on the tensor's device, with
``core.ops.xla_cumsum`` for the sum.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from tpu_joints_torch.core import graphs
from tpu_joints_torch.core.ops import xla_cumsum

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, on uint32 arrays (wrapping arithmetic)."""
    ks = [np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA)]
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """float32 uniforms in [0, 1) equal to ``jax.random.uniform(
    jax.random.PRNGKey(seed), shape)`` for 0 <= seed < 2**32 and fewer than
    2**32 elements."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(0, seed, np.zeros(n, np.uint32),
                               np.arange(n, dtype=np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


@functools.lru_cache(maxsize=16)
def _uploaded(seed: int, shape: Tuple[int, ...],
              device: torch.device) -> torch.Tensor:
    u = torch.from_numpy(uniform(seed, shape))
    if device.type == "cuda":
        return u.pin_memory().to(device, non_blocking=True)
    return u


def uniform_on(seed: int, shape: Tuple[int, ...],
               device: torch.device) -> torch.Tensor:
    """``uniform(seed, shape)`` on ``device``, made once per (seed, shape,
    device): the draw is a constant of the key, so a frame never copies it.
    The one upload to a card goes through pinned memory without blocking,
    so not even the first frame synchronises for it. A captured graph that
    reads the draw holds it (``graphs.hold``), so the cache may evict it."""
    return graphs.hold(_uploaded(seed, shape, device))


def choice(uniforms: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """int64 indices, shaped like ``uniforms``, that ``jax.random.choice``
    draws from weights ``p`` [N] with these uniforms."""
    p_cuml = xla_cumsum(p)
    r = p_cuml[-1] * (1.0 - uniforms)
    return torch.searchsorted(p_cuml, r)
