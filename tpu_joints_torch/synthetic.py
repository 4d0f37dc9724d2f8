"""Synthetic frames and the bench joint, in numpy (no JAX).

Copies of ``tpu_joints/serve/depth.py::pixel_scales`` /
``raycast_cylinders`` and of ``bench.py``'s ``_pose``, ``_bench_pose``,
``_joint_parts``/``_joint_model``, ``_CYLINDERS``, ``_TABLE`` and ``_frame``
recipe, so a host without JAX can build the same scenes. The tests hold
every function here equal to its original.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pixel_scales(width: int, height: int, fov_deg: float = 57.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(x_scale float32[W], y_scale float32[H]): pixel (u, v) at depth z
    unprojects to (z·x_scale[u], z·y_scale[v], z); x is negated to match
    the reference camera frame."""
    tan_half = np.tan(np.radians(fov_deg) / 2.0)
    xs = -(2.0 * (np.arange(width) + 0.5) / width - 1.0) * tan_half
    ys = (2.0 * (np.arange(height) + 0.5) / height - 1.0) * tan_half * (height / width)
    return xs.astype(np.float32), ys.astype(np.float32)


def raycast_cylinders(cylinders, T_model_to_cam: np.ndarray, width: int = 640,
                      height: int = 480, fov_deg: float = 57.0,
                      rects=()) -> np.ndarray:
    """Analytic dense depth of finite cylinders (lateral surfaces) and
    bounded rectangles: float32[H, W, 3] camera-frame cloud, NaN at misses.

    cylinders: (center[3], unit_axis[3], radius, half_length) in model frame;
    rects: (center[3], u_axis[3], v_axis[3], half_u, half_v).
    """
    xs, ys = pixel_scales(width, height, fov_deg)
    d = np.stack(
        [np.broadcast_to(xs[None, :], (height, width)),
         np.broadcast_to(ys[:, None], (height, width)),
         np.ones((height, width), np.float32)], axis=-1,
    ).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    T = np.asarray(T_model_to_cam, np.float64)
    Rmc = T[:3, :3].T
    o_m = -T[:3, :3].T @ T[:3, 3]
    d_m = d @ Rmc.T

    best_t = np.full(d.shape[0], np.inf)
    for (c, a, r, h) in cylinders:
        c = np.asarray(c, np.float64)
        a = np.asarray(a, np.float64)
        a = a / np.linalg.norm(a)
        oc = o_m - c
        o_ax = oc @ a
        d_ax = d_m @ a
        o_perp = oc - o_ax * a
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
        u = np.asarray(u, np.float64)
        u = u / np.linalg.norm(u)
        v = np.asarray(v, np.float64)
        v = v / np.linalg.norm(v)
        n = np.cross(u, v)
        denom = d_m @ n
        t = ((c - o_m) @ n) / np.where(np.abs(denom) > 1e-12, denom, np.nan)
        p = o_m + t[:, None] * d_m
        inside = (np.abs((p - c) @ u) <= hu) & (np.abs((p - c) @ v) <= hv)
        good = inside & (t > 1e-6)
        best_t = np.where(good & (t < best_t), t, best_t)

    cam_pts = d * best_t[:, None]
    cam_pts[~np.isfinite(best_t)] = np.nan
    return cam_pts.reshape(height, width, 3).astype(np.float32)


def pose(ay_deg: float, ax_deg: float, t) -> np.ndarray:
    """Model→camera pose: rotate about y, then x, then translate by ``t``."""
    ay, ax = np.radians(ay_deg), np.radians(ax_deg)
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]], np.float32)
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rx @ Ry
    T[:3, 3] = np.asarray(t, np.float32)
    return T


def bench_pose() -> np.ndarray:
    """The fixed bench pose: both chord and stub clearly visible."""
    return pose(35.0, -20.0, [0.02, -0.03, 1.0])


def joint_parts(n_chord: int = 40_000, n_stub: int = 24_000
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The bench pipe joint's (chord, stub) point clouds in the joint frame:
    chord r=0.08 m along x, stub r=0.05 m inclined 30°, with the weld
    cutouts (no surface inside the other part)."""
    rng = np.random.default_rng(7)
    theta = rng.uniform(0, 2 * np.pi, n_chord)
    h = rng.uniform(-0.3, 0.3, n_chord)
    chord = np.stack([h, 0.08 * np.cos(theta), 0.08 * np.sin(theta)], 1)
    theta2 = rng.uniform(0, 2 * np.pi, n_stub)
    h2 = rng.uniform(-0.15, 0.15, n_stub)
    stub_local = np.stack([0.05 * np.cos(theta2), 0.05 * np.sin(theta2), h2], 1)
    a30 = np.radians(30.0)
    R30 = np.array([[np.cos(a30), 0, np.sin(a30)], [0, 1, 0],
                    [-np.sin(a30), 0, np.cos(a30)]], np.float32)
    stub = stub_local @ R30.T + np.array([0, 0, 0.23], np.float32)
    stub_c = np.array([0, 0, 0.23], np.float32)
    stub_ax = np.array([np.sin(a30), 0.0, np.cos(a30)], np.float32)
    rel = chord - stub_c
    t_ax = rel @ stub_ax
    radial = rel - t_ax[:, None] * stub_ax
    hole = (np.linalg.norm(radial, axis=1) < 0.05) & (t_ax > -0.25)
    chord = chord[~hole]
    inside_chord = np.linalg.norm(stub[:, 1:], axis=1) < 0.08
    stub = stub[~inside_chord]
    return chord.astype(np.float32), stub.astype(np.float32)


def joint_model(n_chord: int = 40_000, n_stub: int = 24_000) -> np.ndarray:
    """The full joint CAD cloud (chord + stub)."""
    return np.concatenate(joint_parts(n_chord, n_stub))


_A30 = np.radians(30.0)
CYLINDERS = [
    (np.zeros(3), np.array([1.0, 0.0, 0.0]), 0.08, 0.3),
    (np.array([0.0, 0.0, 0.23]), np.array([np.sin(_A30), 0.0, np.cos(_A30)]),
     0.05, 0.15),
]
# a workshop-table rectangle behind the joint
TABLE = [(np.array([0.0, 0.0, 0.45]), np.array([1.0, 0.0, 0.0]),
          np.array([0.0, 1.0, 0.0]), 0.35, 0.35)]


def frame(T_pose: np.ndarray, seed: int, with_table: bool, width: int = 640,
          height: int = 480):
    """Dense raycast of the joint (+ optional table) with σ = 0.5 mm depth
    noise along the ray from ``seed``: (xyz_img float32[H, W, 3] with
    zeros at misses, valid bool[H, W])."""
    xyz_img = raycast_cylinders(CYLINDERS, T_pose, width=width, height=height,
                                rects=TABLE if with_table else [])
    valid = np.isfinite(xyz_img).all(axis=-1)
    sigma = np.random.default_rng(seed).normal(
        0.0, 5e-4, (height, width)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        xyz_img = xyz_img * (
            1.0 + sigma / np.maximum(xyz_img[..., 2], 0.1))[..., None]
    return np.nan_to_num(xyz_img), valid


def bench_config():
    """``bench.py::_make_config`` at full size — the ``scene_latency``
    chain's configuration, crop flags included (the organized front end
    reads them; ``detect_organized`` itself runs with them off)."""
    from tpu_joints_torch.config import DetectionConfig

    return DetectionConfig(
        descriptor="shot", descr_rad=0.06, model_ss=0.02, scene_ss=0.02,
        normal_k=16, match_mode="nn", match_threshold=0.25, algorithm="hough",
        rf_frames="board", rf_rad=0.06, rf_k_max=96, cg_size=0.05,
        cg_thresh=3.0, icp_iterations=6, icp_point_to_plane=True,
        icp_max_corr_dist=0.02, icp_max_corr_start=0.2,
        final_icp_iterations=6, max_candidates=16, max_instances_per_view=2,
        view_grouped_candidates=True, split_rotation_modes=True,
        refine_top=4, tier1_rows=512, tier1_iterations=4,
        tier1_view_iterations=3, tier1_polish_iterations=4,
        scene_capacity=2560, scene_key_capacity=512, coverage_accept=0.02,
        rg_smoothness_deg=12.0, cluster_max_curvature=0.08, rg_max_edge=0.05,
        remove_plane=True, segment_scene=True, k_max=96)


def bench_bank_kwargs(cfg) -> dict:
    """``build_bank`` arguments of ``bench.py::build_problem`` at full size:
    42 views (level 1) at 128 px, descriptor surface at the working set's
    1 cm resolution."""
    return dict(descriptor=cfg.descriptor, descr_radius=cfg.descr_rad,
                rf_radius=cfg.rf_rad, rf_k_max=cfg.rf_k_max,
                frames=cfg.rf_frames, sampling_radius=cfg.model_ss,
                normal_k=cfg.normal_k, k_max=cfg.k_max, level=1,
                resolution=128, surface_leaf=0.01, key_capacity=256,
                icp_capacity=2048)


# bench.py's crop box around the joint (the PassThrough work volume)
CROP_LO = np.array([-0.45, -0.5, 0.5], np.float32)
CROP_HI = np.array([0.5, 0.45, 1.55], np.float32)
