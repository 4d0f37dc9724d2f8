"""The reference's working set of a depth frame, worked out from the depth.

The organized ingest keeps one point per block×block pixel tile: the valid
pixel nearest the tile mean (ties to the larger pixel index), kept where
its normal window holds at least 5 valid pixels and does not collapse on a
depth edge (a valid-valid depth change of more than 2 cm in the 3×3
neighbourhood of a pixel shrinks the window of every pixel within reach).
This file states that rule in plain PyTorch, in float32 as the sensor's
points are, so that the tile winners and counts are the rule's own.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SENTINEL = 1.0e6


def unproject(depth: np.ndarray, fov_deg: float) -> np.ndarray:
    """Organized float32[H, W, 3] of a metric depth image, NaN where the
    depth is 0 (no return)."""
    from benchmark.frames import pixel_scales

    depth = np.asarray(depth, np.float32)
    h, w = depth.shape
    xs, ys = pixel_scales(w, h, fov_deg)
    xyz = np.empty((h, w, 3), np.float32)
    xyz[..., 0] = depth * xs[None, :]
    xyz[..., 1] = depth * ys[:, None]
    xyz[..., 2] = depth
    xyz[~np.isfinite(depth) | (depth <= 0)] = np.nan
    return xyz


def tile_block(H: int, W: int, capacity: int) -> int:
    """The tile edge for an H×W frame and a working set of ``capacity``:
    the smallest power of two (at most 16) whose (H / 2·block)·(W /
    2·block) tiles fit the capacity."""
    block = 1
    while block < 16 and (H // (2 * block)) * (W // (2 * block)) > capacity:
        block *= 2
    return block


def _tiles(a, b):
    H, W = a.shape[-2:]
    return a.reshape(*a.shape[:-2], H // b, b, W // b, b)


def _tile_sum(a, b):
    t = _tiles(a, b)
    out = t[..., :, 0, :, 0]
    for i in range(b):
        for j in range(b):
            if i or j:
                out = out + t[..., :, i, :, j]
    return out


def _up(a, b):
    return a.repeat_interleave(b, -2).repeat_interleave(b, -1)


def _max3x3(a):
    H, W = a.shape[-2:]
    return F.max_pool2d(a.reshape(-1, 1, H, W), 3, stride=1,
                        padding=1).reshape(a.shape)


def _window_count(m, r):
    """(2r+1)² box sum of a 0/1 plane, zero padded."""
    k = torch.ones((1, 1, 2 * r + 1, 2 * r + 1), dtype=m.dtype,
                   device=m.device)
    return F.conv2d(m[None, None], k, padding=r)[0, 0]


def working_set(xyz_img: np.ndarray, block: int, capacity: int,
                half_window: int = 5, depth_change: float = 0.02,
                device="cpu") -> torch.Tensor:
    """The kept tile winners of one frame, float64[n, 3]."""
    img = torch.as_tensor(xyz_img, device=device)
    H, W = img.shape[:2]
    mask = torch.isfinite(img).all(-1)
    x, y, z = (torch.where(mask, img[..., i], SENTINEL) for i in range(3))
    m = mask.to(torch.float32)
    inv = 1.0 / torch.clamp_min(_tile_sum(m, block), 1.0)
    mx, my, mz = (_tile_sum(torch.where(mask, c, 0.0), block) * inv
                  for c in (x, y, z))
    d2 = ((x - _up(mx, block)) ** 2 + (y - _up(my, block)) ** 2
          + (z - _up(mz, block)) ** 2)
    d2 = torch.where(mask, d2, 3e38)
    tmin = _tiles(d2, block).amin(dim=(-3, -1))
    winner = (d2 <= _up(tmin, block)) & mask
    pixidx = torch.arange(H * W, device=img.device).reshape(H, W)
    pix = _tiles(torch.where(winner, pixidx, -1), block).amax(
        dim=(-3, -1)).reshape(-1)
    got = pix >= 0
    occupied = int(got.sum())
    if occupied > capacity:
        raise ValueError(f"{occupied} occupied tiles exceed the working set "
                         f"of {capacity}: the reference keeps no thinning")
    # the window radius: one less than the Chebyshev distance to the
    # nearest valid-valid depth change, capped at half_window
    big = 3.0e38
    zv = torch.where(mask, img[..., 2], 0.0)
    zmax = _max3x3(torch.where(mask, zv, -big))
    zmin = -_max3x3(-torch.where(mask, zv, big))
    change = (zmax - zmin) > depth_change
    dist = torch.where(change, 0, half_window + 1).to(torch.int32)
    reach = change.to(torch.float32)
    for s in range(1, half_window + 1):
        reach = _max3x3(reach)
        dist = torch.minimum(dist, torch.where(reach > 0.5, s,
                                               half_window + 1).to(torch.int32))
    r_px = torch.clamp(dist - 1, 0, half_window).reshape(-1)
    p = pix[got]
    r = r_px[p]
    support = torch.zeros_like(p, dtype=torch.float32)
    for rr in range(1, half_window + 1):
        sel = r == rr
        if bool(sel.any()):
            support[sel] = _window_count(m, rr).reshape(-1)[p[sel]]
    ok = (r >= 1) & (support >= 5.0)
    return img.reshape(-1, 3)[p[ok]].double()
