"""Depth-buffer → organized cloud projection + fake scene camera
(counterpart of ``tpu_joints/serve/depth.py``).

The reference's simulation bridge converts the V-REP depth buffer into an
organized XYZ cloud with cached per-pixel x/y scale factors (reference
``ROS_server.cpp:2112-2176``, projection math at ``:2144-2164``). Only that
projection is kept here, as a host-side ingestion utility, plus a
``FakeDepthCamera`` that plays the simulator's role for tests and demos: it
z-buffers a synthetic scene into a depth image so the server can be driven
end to end with no simulator or robot; ``raycast_cylinders`` gives the
dense depth a real sensor returns.

``unproject`` is the served frame's projection as the organized chain
takes it (the port's own; the JAX package does this on the host): one
CUDA kernel (``neighbors/csrc/unproject.cu``) for a frame on a card, its
plain PyTorch version :func:`unproject_reference` for one on the CPU.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_joints_torch.neighbors.pallas_knn import load_library

_count_lock = threading.Lock()


def pixel_scales(
    width: int, height: int, fov_deg: float = 57.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel tangent scale factors (cached by callers, as the reference
    caches its x/y scale tables when the sensor resolution is unchanged).

    Returns (x_scale float32[W], y_scale float32[H]) such that a pixel
    (u, v) at metric depth z unprojects to (z·x_scale[u], z·y_scale[v], z).
    The horizontal FoV is ``fov_deg``; vertical FoV follows the aspect.
    The x scale is negated to match the reference camera frame
    (``ROS_server.cpp:2149``: ``x_scale = -(i - resol_x/2)/f``) so real
    sensor depth yields grasp centroids in the frame the robot expects.
    """
    tan_half = np.tan(np.radians(fov_deg) / 2.0)
    xs = -(2.0 * (np.arange(width) + 0.5) / width - 1.0) * tan_half
    ys = (2.0 * (np.arange(height) + 0.5) / height - 1.0) * tan_half * (height / width)
    return xs.astype(np.float32), ys.astype(np.float32)


def depth_to_cloud(
    depth: np.ndarray,
    fov_deg: float = 57.0,
    near: float = 0.0,
    far: float = 0.0,
    max_valid_depth: Optional[float] = None,
) -> np.ndarray:
    """Unproject a depth image into an organized [H, W, 3] cloud.

    ``depth`` is metric unless ``far > near`` is given, in which case values
    are treated as normalized 0..1 (the simulator's convention) and mapped
    to ``near + d·(far-near)``. Pixels at/after ``max_valid_depth`` (default:
    ``far`` when given) come back as NaN — the organized-cloud convention the
    downstream NaN-mask ingestion expects.
    """
    depth = np.asarray(depth, np.float32)
    h, w = depth.shape
    if far > near:
        z = near + depth * (far - near)
        if max_valid_depth is None:
            max_valid_depth = far * (1.0 - 1e-4)
    else:
        z = depth.copy()
    xs, ys = pixel_scales(w, h, fov_deg)
    xyz = np.empty((h, w, 3), np.float32)
    xyz[..., 0] = z * xs[None, :]
    xyz[..., 1] = z * ys[:, None]
    xyz[..., 2] = z
    invalid = ~np.isfinite(z) | (z <= 0)
    if max_valid_depth is not None:
        invalid |= z >= max_valid_depth
    xyz[invalid] = np.nan
    return xyz


def unproject_scalars(near: float = 0.0, far: float = 0.0
                      ) -> Tuple[np.float32, np.float32, np.float32]:
    """(near, range, max_valid) as float32, rounded as NumPy's weak scalars
    round them in :func:`depth_to_cloud`: ``far - near`` in float64, then
    to float32 for the multiply; ``far·(1 − 1e-4)`` to float32 for the
    compare. A metric frame (``far <= near``) gets (0, 1, +inf):
    ``0 + d·1`` is ``d``, save that −0 becomes +0, invalid either way."""
    if far > near:
        return (np.float32(near), np.float32(far - near),
                np.float32(far * (1.0 - 1e-4)))
    return np.float32(0.0), np.float32(1.0), np.float32(np.inf)


def _check_unproject(depth: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                     block: int) -> None:
    H, W = depth.shape if depth.ndim == 2 else (None, None)
    if H is None or tuple(xs.shape) != (W,) or tuple(ys.shape) != (H,):
        raise ValueError(f"unproject takes depth [H, W], xs [W] and ys [H], "
                         f"got {tuple(depth.shape)}, {tuple(xs.shape)} and "
                         f"{tuple(ys.shape)}")
    if not all(t.dtype == torch.float32 for t in (depth, xs, ys)):
        raise TypeError("unproject takes float32 depth and scales")
    if not depth.device == xs.device == ys.device:
        raise ValueError("unproject inputs must share one device")
    if not 1 <= block <= 16:
        raise ValueError(f"unproject takes 1 <= block <= 16, got {block}")


def unproject_reference(depth: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor, near: float = 0.0, far: float = 0.0,
                        block: int = 1):
    """Plain PyTorch version of the ``unproject`` kernel, the same float32
    operations one by one: :func:`depth_to_cloud`, its finite mask,
    ``nan_to_num`` of the crop and the tile count, as the server's NumPy
    frame computes them (see :func:`unproject`)."""
    _check_unproject(depth, xs, ys, block)
    near32, range32, max32 = (torch.tensor(v) for v in
                              unproject_scalars(near, far))
    H, W = depth.shape
    Hc, Wc = H - H % block, W - W % block
    z = near32 + depth * range32
    x = z * xs[None, :]
    y = z * ys[:, None]
    ok = torch.isfinite(z) & (z > 0) & (z < max32)
    valid = ok & torch.isfinite(x) & torch.isfinite(y)
    xyz = torch.stack([x, y, z], -1)[:Hc, :Wc]
    img = torch.where(ok[:Hc, :Wc, None], torch.nan_to_num(xyz, nan=0.0),
                      0.0)
    vmask = valid[:Hc, :Wc]
    n_tiles = vmask.reshape(Hc // block, block, Wc // block,
                            block).any(3).any(1).sum()
    counts = torch.stack([n_tiles, valid.sum()]).to(torch.int32)
    return img.contiguous(), vmask.contiguous(), counts


def unproject(depth: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
              near: float = 0.0, far: float = 0.0, block: int = 1):
    """A depth frame as the organized chain takes it, on the frame's device.

    ``depth`` float32[H, W] (metric, or normalized 0..1 mapped to
    ``near + d·(far − near)`` when ``far > near``, as in
    :func:`depth_to_cloud`), ``xs`` float32[W] and ``ys`` float32[H] from
    :func:`pixel_scales`, ``block`` the tile edge. Returns ``(img
    float32[Hc, Wc, 3], vmask bool[Hc, Wc], counts int32[2])``, cropped to
    ``Hc = H − H % block``, ``Wc = W − W % block``: ``img`` is
    ``nan_to_num(depth_to_cloud(...))`` of the crop, ``vmask`` where all
    three coordinates are finite, ``counts`` = (block² tiles of the crop
    with a valid pixel, valid pixels of the whole frame). Equal bit for bit
    to the server's NumPy frame.

    A CUDA tensor launches the kernel on the current stream (a failed build
    or launch raises); a CPU tensor takes :func:`unproject_reference`.
    ``unproject.launches`` and ``unproject.by_device`` count the launches.
    """
    _check_unproject(depth, xs, ys, block)
    if depth.device.type == "cpu":
        return unproject_reference(depth, xs, ys, near, far, block)
    if depth.device.type != "cuda":
        raise ValueError(f"unproject runs on cpu or cuda, not {depth.device}")
    lib = load_library("unproject")
    depth, xs, ys = depth.contiguous(), xs.contiguous(), ys.contiguous()
    H, W = depth.shape
    Hc, Wc = H - H % block, W - W % block
    img = torch.empty((Hc, Wc, 3), dtype=torch.float32, device=depth.device)
    vmask = torch.empty((Hc, Wc), dtype=torch.bool, device=depth.device)
    counts = torch.empty(2, dtype=torch.int32, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    with torch.cuda.device(depth.device):
        rc = lib.tj_unproject(depth.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                              img.data_ptr(), vmask.data_ptr(),
                              counts.data_ptr(), H, W, block,
                              *map(float, unproject_scalars(near, far)),
                              stream)
    if rc != 0:
        raise RuntimeError(f"unproject kernel launch failed: cudaError_t {rc}")
    with _count_lock:             # request threads launch concurrently
        unproject.launches += 1
        unproject.by_device[depth.device.index] += 1
    return img, vmask, counts


unproject.launches = 0
unproject.by_device = Counter()


def raycast_cylinders(
    cylinders,
    T_model_to_cam: np.ndarray,
    width: int = 640,
    height: int = 480,
    fov_deg: float = 57.0,
    rects=(),
) -> np.ndarray:
    """Analytic dense depth of finite cylinders — a real-sensor stand-in.

    ``FakeDepthCamera`` splats a point set, which leaves holes between
    samples; a real depth sensor returns depth at *every* pixel covering a
    surface (``ROS_server.cpp:2131-2164`` streams the full buffer). This
    ray-caster produces that dense organized cloud exactly, for tests and
    benchmarks of the organized ingestion path.

    Args:
      cylinders: iterable of (center[3], unit_axis[3], radius, half_length)
        in model frame (lateral surfaces only, like the point generators).
      T_model_to_cam: float32[4, 4].
      rects: iterable of (center[3], u_axis[3], v_axis[3], half_u, half_v)
        bounded planar rectangles in model frame — e.g. the workshop
        table top under the joint in the reference's scenes
        (``Workshop_scene/scene*.pcd``).

    Returns float32[H, W, 3] camera-frame organized cloud, NaN at misses.
    """
    xs, ys = pixel_scales(width, height, fov_deg)
    d = np.stack(
        [np.broadcast_to(xs[None, :], (height, width)),
         np.broadcast_to(ys[:, None], (height, width)),
         np.ones((height, width), np.float32)], axis=-1,
    ).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # camera→model: rays start at the camera origin
    T = np.asarray(T_model_to_cam, np.float64)
    Rmc = T[:3, :3].T
    o_m = -T[:3, :3].T @ T[:3, 3]
    d_m = d @ Rmc.T  # [P, 3]

    best_t = np.full(d.shape[0], np.inf)
    for (c, a, r, h) in cylinders:
        c = np.asarray(c, np.float64)
        a = np.asarray(a, np.float64)
        a = a / np.linalg.norm(a)
        oc = o_m - c
        o_ax = oc @ a            # scalar: shared ray origin
        d_ax = d_m @ a           # [P]
        o_perp = oc - o_ax * a   # [3]
        d_perp = d_m - np.outer(d_ax, a)
        A = np.einsum("ij,ij->i", d_perp, d_perp)
        B = 2.0 * (d_perp @ o_perp)
        C = float(o_perp @ o_perp) - r * r
        disc = B * B - 4.0 * A * C
        hit = (disc >= 0) & (A > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0.0))
        for sign in (-1.0, 1.0):
            t = (-B + sign * sq) / np.maximum(2.0 * A, 1e-12)
            z_ax = o_ax + t * d_ax
            good = hit & (t > 1e-6) & (np.abs(z_ax) <= h)
            best_t = np.where(good & (t < best_t), t, best_t)

    for (c, u, v, hu, hv) in rects:
        c = np.asarray(c, np.float64)
        u = np.asarray(u, np.float64); u = u / np.linalg.norm(u)
        v = np.asarray(v, np.float64); v = v / np.linalg.norm(v)
        n = np.cross(u, v)
        denom = d_m @ n
        # NaN for grazing rays: every comparison below then rejects them
        t = ((c - o_m) @ n) / np.where(np.abs(denom) > 1e-12, denom, np.nan)
        p = o_m + t[:, None] * d_m
        inside = (np.abs((p - c) @ u) <= hu) & (np.abs((p - c) @ v) <= hv)
        good = inside & (t > 1e-6)
        best_t = np.where(good & (t < best_t), t, best_t)

    cam_pts = d * best_t[:, None]
    cam_pts[~np.isfinite(best_t)] = np.nan
    return cam_pts.reshape(height, width, 3).astype(np.float32)


class FakeDepthCamera:
    """Deterministic, repeatable scene source — the V-REP stand-in.

    Splats a world point set into a z-buffered depth image through the same
    pinhole used by :func:`depth_to_cloud`, so
    ``depth_to_cloud(camera.render(pts))`` round-trips the visible points.
    """

    def __init__(self, width: int = 640, height: int = 480, fov_deg: float = 57.0,
                 near: float = 0.05, far: float = 5.0):
        self.width, self.height, self.fov_deg = width, height, fov_deg
        self.near, self.far = near, far
        self._xs, self._ys = pixel_scales(width, height, fov_deg)

    def render(self, cam_xyz: np.ndarray, splat: int = 1) -> np.ndarray:
        """Render camera-frame points into a normalized [H, W] depth image
        (1.0 = background/far), with optional ``splat``-pixel dilation to
        close holes between samples."""
        z = cam_xyz[:, 2]
        keep = (z > self.near) & (z < self.far) & np.isfinite(z)
        pts = cam_xyz[keep]
        z = z[keep]
        tan_half = np.tan(np.radians(self.fov_deg) / 2.0)
        # Inverse of pixel_scales' negated x (reference ROS_server.cpp:2149).
        u = np.floor((1.0 - pts[:, 0] / z / tan_half) * self.width / 2.0).astype(np.int64)
        v = np.floor(
            (pts[:, 1] / z / (tan_half * self.height / self.width) + 1.0)
            * self.height / 2.0
        ).astype(np.int64)
        ok = (u >= 0) & (u < self.width) & (v >= 0) & (v < self.height)
        u, v, z = u[ok], v[ok], z[ok]
        zbuf = np.full(self.height * self.width, np.inf, np.float32)
        for du in range(splat):
            for dv in range(splat):
                uu = np.clip(u + du, 0, self.width - 1)
                vv = np.clip(v + dv, 0, self.height - 1)
                np.minimum.at(zbuf, vv * self.width + uu, z)
        depth = (zbuf.reshape(self.height, self.width) - self.near) / (self.far - self.near)
        depth[~np.isfinite(depth)] = 1.0
        return np.clip(depth, 0.0, 1.0).astype(np.float32)

    def cloud(self, cam_xyz: np.ndarray, splat: int = 1) -> np.ndarray:
        """render() + depth_to_cloud(): organized [H, W, 3] with NaN holes."""
        return depth_to_cloud(
            self.render(cam_xyz, splat=splat),
            fov_deg=self.fov_deg, near=self.near, far=self.far,
        )
