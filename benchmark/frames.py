"""Depth frames of the benchmark's scenes, made on the device from the seed.

A plain PyTorch copy of the port's ``serve/depth.py::raycast_cylinders``
(analytic dense depth of finite cylinders) and of ``synthetic.frame``'s
depth noise (σ along the ray), so the harness makes its own inputs and
never imports the program for them. One raycast of the scene's instances
(copies of the joint, each at its own pose; the nearest hit per ray); then
a pool of noise draws from ``--seed`` (a ``torch.Generator`` on the device,
one call for the whole pool); then depth as a sensor gives it: metric z, 0
where a ray missed. The pool goes to the host once.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

def pose_matrix(ay_deg: float, ax_deg: float, t: Sequence[float]) -> np.ndarray:
    """Model→camera pose: rotate about y, then x, then translate by ``t``
    (``bench.py::_pose``), float32[4, 4]."""
    ay, ax = np.radians(ay_deg), np.radians(ax_deg)
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]], np.float32)
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rx @ Ry
    T[:3, 3] = np.asarray(t, np.float32)
    return T


def pixel_scales(width: int, height: int, fov_deg: float):
    """Per-pixel tangent scales (x negated, the reference camera frame), as
    float32 numpy arrays [W], [H]: pixel (u, v) at depth z unprojects to
    (z·xs[u], z·ys[v], z)."""
    tan_half = np.tan(np.radians(fov_deg) / 2.0)
    xs = -(2.0 * (np.arange(width) + 0.5) / width - 1.0) * tan_half
    ys = (2.0 * (np.arange(height) + 0.5) / height - 1.0) * tan_half * (
        height / width)
    return xs.astype(np.float32), ys.astype(np.float32)


def raycast(cylinders, poses, width: int, height: int, fov_deg: float,
            device) -> torch.Tensor:
    """Camera-frame hit points float32[H, W, 3] (NaN at misses) of the
    lateral surfaces of ``cylinders`` ((center, axis, radius, half_length)
    in the model frame), shown at each model→camera pose of ``poses``
    ([4, 4] for one instance, [K, 4, 4] for K), worked out in float64 on
    ``device``. Each ray keeps its nearest hit over every instance: the
    rays are moved into each instance's model frame in turn, in the order
    given, and a later hit replaces an earlier one only when it is
    strictly nearer."""
    f64 = dict(dtype=torch.float64, device=device)
    xs, ys = pixel_scales(width, height, fov_deg)
    f32 = dict(dtype=torch.float32, device=device)
    # the rays are stacked and normalised in float32, as in the original
    d = torch.stack([torch.as_tensor(xs, **f32)[None, :].expand(height, width),
                     torch.as_tensor(ys, **f32)[:, None].expand(height, width),
                     torch.ones((height, width), **f32)], -1).reshape(-1, 3)
    d = (d / torch.linalg.vector_norm(d, dim=1, keepdim=True)).double()
    best_t = torch.full((d.shape[0],), math.inf, **f64)
    for T in np.asarray(poses, np.float64).reshape(-1, 4, 4):
        T = torch.as_tensor(T, **f64)
        Rmc = T[:3, :3].T
        o_m = -T[:3, :3].T @ T[:3, 3]
        d_m = d @ Rmc.T
        for c, a, r, h in cylinders:
            c = torch.as_tensor(np.asarray(c, np.float64), **f64)
            a = torch.as_tensor(np.asarray(a, np.float64), **f64)
            a = a / torch.linalg.vector_norm(a)
            oc = o_m - c
            o_ax = oc @ a
            d_ax = d_m @ a
            o_perp = oc - o_ax * a
            d_perp = d_m - d_ax[:, None] * a[None, :]
            A = (d_perp * d_perp).sum(1)
            B = 2.0 * (d_perp @ o_perp)
            C = float(o_perp @ o_perp) - r * r
            disc = B * B - 4.0 * A * C
            hit = (disc >= 0) & (A > 1e-12)
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            for sign in (-1.0, 1.0):
                t = (-B + sign * sq) / torch.clamp_min(2.0 * A, 1e-12)
                z_ax = o_ax + t * d_ax
                good = hit & (t > 1e-6) & (z_ax.abs() <= h) & (t < best_t)
                best_t = torch.where(good, t, best_t)
    pts = d * best_t[:, None]
    pts = torch.where(torch.isfinite(best_t)[:, None], pts, torch.nan)
    return pts.reshape(height, width, 3).float()


def noisy_depth(xyz_img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Depth float32[..., H, W] of a raycast ``xyz_img`` [H, W, 3] with the
    noise draws ``sigma`` [..., H, W] along the ray (``synthetic.frame``:
    xyz·(1 + σ / max(z, 0.1))), 0 where the ray missed."""
    z = xyz_img[..., 2]
    hit = torch.isfinite(z)
    zf = torch.where(hit, z, 0.0)
    noisy = zf * (1.0 + sigma / torch.clamp_min(zf, 0.1))
    return torch.where(hit, noisy, 0.0)


class Scene:
    """One configuration's scene: the joint's cylinders in the model frame,
    the instances of the joint it shows (``scene.instances``, a list of
    poses ``{ay_deg, ax_deg, t}``; a configuration that gives one
    ``scene.pose`` shows one instance), the sensor."""

    def __init__(self, config: dict):
        sc, se = config["scene"], config["sensor"]
        self.cylinders = [(c["center"], c["axis"], c["radius"],
                           c["half_length"]) for c in sc["cylinders"]]
        self.sigma = float(sc["depth_sigma_m"])
        self.width, self.height = int(se["width"]), int(se["height"])
        self.fov_deg = float(se["fov_deg"])
        instances = sc["instances"] if "instances" in sc else [sc["pose"]]
        self.poses = np.stack([pose_matrix(p["ay_deg"], p["ax_deg"], p["t"])
                               for p in instances])
        self.pose = self.poses[0]


def make_pool(scene: Scene, n_pool: int, seed: int, device) -> dict:
    """The mix's frames: one raycast, then ``n_pool`` noise draws from
    ``seed``, as depth on the host.

    Returns dict(depth float32[n, H, W] numpy, poses float32[K, 4, 4], the
    true pose of each instance, and pose = poses[0])."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    H, W = scene.height, scene.width
    sigma = torch.randn((n_pool, H, W), generator=gen, device=device,
                        dtype=torch.float32) * scene.sigma
    hit = raycast(scene.cylinders, scene.poses, W, H, scene.fov_deg, device)
    depth = noisy_depth(hit, sigma)
    return dict(depth=depth.cpu().numpy(), poses=scene.poses,
                pose=scene.pose)
