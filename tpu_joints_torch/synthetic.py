"""Synthetic frames and the bench joint, in numpy (no JAX).

Frames are raycast with ``serve/depth.py::raycast_cylinders`` (the port's
copy of the reference's). Copies of ``bench.py``'s ``_pose``, ``_bench_pose``,
``_joint_parts``/``_joint_model``, ``_CYLINDERS``, ``_TABLE``, ``_frame``,
``build_part_banks`` and the ``_make_config`` recipe with the segmented,
two-part, multi-instance and GO-HV chains' variants of it, of its
two-instance scene and its batch of jittered frames, and of the CLI's scene
recipe
(``tpu_joints/cli/main.py::_detect_one``), so a host without JAX can build
the same scenes. The tests hold every function here equal to its original.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from tpu_joints_torch.serve.depth import raycast_cylinders


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
          height: int = 480, cylinders=None):
    """Dense raycast of the joint (+ optional table) with σ = 0.5 mm depth
    noise along the ray from ``seed``: (xyz_img float32[H, W, 3] with
    zeros at misses, valid bool[H, W]). ``cylinders`` replaces the joint's
    primitives (the two-instance scene)."""
    xyz_img = raycast_cylinders(
        CYLINDERS if cylinders is None else cylinders, T_pose, width=width,
        height=height, rects=TABLE if with_table else [])
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


def fpfh_config():
    """``bench.py``'s ``scene_latency_fpfh`` chain (``FPFH_demo.cpp`` at its
    own parameters): ``bench_config()`` (crop flags on) with FPFH-33 at
    r = 0.15 over the keypoint cloud itself, 192 neighbours, the 2-NN ratio
    gate at τ = 1 and the full 4-iteration tier-1 view budget."""
    import dataclasses

    return dataclasses.replace(
        bench_config(), descriptor="fpfh", match_mode="ratio", ratio=1.0,
        descr_rad=0.15, tier1_view_iterations=4, fpfh_surface="keys",
        fpfh_k_max=192)


def fpfh_bank_recipe(cfg) -> dict:
    """``build_bank`` arguments of ``bench.py``'s FPFH bank at full size for
    ``fpfh_config()``: 42 views (level 1) at 128 px, 1 cm descriptor
    surface, 256 keys, 2048 ICP rows, FPFH over the keys with 192
    neighbours."""
    return dict(descriptor="fpfh", descr_radius=cfg.descr_rad,
                rf_radius=cfg.rf_rad, rf_k_max=cfg.rf_k_max,
                frames=cfg.rf_frames, sampling_radius=cfg.model_ss,
                normal_k=cfg.normal_k, k_max=cfg.k_max, fpfh_surface="keys",
                fpfh_k_max=192, level=1, resolution=128, surface_leaf=0.01,
                key_capacity=256, icp_capacity=2048)


def segmented_config():
    """``bench.py``'s ``scene_latency_segmented`` chain: ``bench_config()``
    (crop flags on) with the full 4-iteration tier-1 view budget — the
    cropped working set enters tier 1 from coarser Hough bins."""
    import dataclasses

    return dataclasses.replace(bench_config(), tier1_view_iterations=4)


def two_part_config():
    """``bench.py``'s ``scene_latency_two_part`` chain: ``bench_config()``
    (crop flags on) with 8 candidates per part, so the pooled field keeps
    the single-part row counts (tier 1 2·8·512 = polish 16·512 = tier 2
    4·2048 = 8192 ICP query rows)."""
    import dataclasses

    return dataclasses.replace(bench_config(), max_candidates=8)


def multi_instance_config():
    """``bench.py``'s ``multi_instance`` chain: the ``scene_latency``
    configuration (crop flags off) with the coverage gate local to each
    candidate's footprint, two translation peaks (four instances) per view,
    the peak-grouped cut of 48 candidates, 12 tier-2 survivors, the full
    tier-1 view budget and an 8192-lane working set with 1024 keys.
    ``icp_allow_pallas=False`` is the original's setting; it is ignored
    here (every k=1 NN runs kernel K1)."""
    import dataclasses

    return dataclasses.replace(
        bench_config(), segment_scene=False, remove_plane=False,
        coverage_local=True, max_instances_per_view=4,
        peak_grouped_candidates=True, max_candidates=48, refine_top=12,
        tier1_view_iterations=4, icp_allow_pallas=False, scene_capacity=8192,
        scene_key_capacity=1024)


def hv_config():
    """``bench.py``'s ``multi_instance_hv`` chain: ``multi_instance_config``
    with the global hypothesis verification on, 1 cm inlier threshold."""
    import dataclasses

    return dataclasses.replace(multi_instance_config(), hv_enabled=True,
                               hv_inlier_threshold=0.01)


def build_part_banks(cfg, device="cuda", level: int = 1,
                     resolution: int = 128, key_capacity: int = 256,
                     icp_capacity: int = 2048) -> dict:
    """``bench.py::build_part_banks``: the {chord, stub} part banks on
    ``device`` (the card unless asked otherwise), each from its own part's
    rendered views at one common view capacity and all carrying the FULL
    joint as ``model_xyz`` — the flagship search shape, whose winner is
    composed and gated against the whole joint's CAD. The defaults are the
    full size (42 views per part at 128 px)."""
    from tpu_joints_torch.core.cloud import bucket_size
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.modelbank.scanner import render_views

    chord, stub = joint_parts()
    full = np.concatenate([chord, stub])
    part_views = {}
    for name, part in (("chord", chord), ("stub", stub)):
        views, poses, _ = render_views(part, level=level,
                                       resolution=resolution)
        part_views[name] = (views, poses)
    vc = bucket_size(max(max(v.shape[0] for v in vs)
                         for vs, _ in part_views.values()))
    kw = dict(bench_bank_kwargs(cfg), key_capacity=key_capacity,
              icp_capacity=icp_capacity)
    del kw["level"], kw["resolution"]
    return {name: build_bank(full, views=vs, poses=ps, view_capacity=vc,
                             device=device, **kw)
            for name, (vs, ps) in part_views.items()}


# bench.py's crop box around the joint (the PassThrough work volume)
CROP_LO = np.array([-0.45, -0.5, 0.5], np.float32)
CROP_HI = np.array([0.5, 0.45, 1.55], np.float32)
# ... and the wide one of its two-instance scene
WIDE_LO = np.array([-0.8, -0.6, 0.5], np.float32)
WIDE_HI = np.array([0.8, 0.6, 1.7], np.float32)


def two_instance_poses() -> Tuple[np.ndarray, np.ndarray]:
    """``bench.py``'s two joint poses (T_a, T_b): separate objects with a
    0.25 m surface gap, each as visible as the single joint."""
    return (pose(25.0, -15.0, [-0.30, -0.16, 1.05]),
            pose(-20.0, 20.0, [0.30, 0.18, 1.00]))


def two_instance_frame(width: int = 640, height: int = 480):
    """``bench.py``'s two-instance frame: both posed copies of the joint as
    one 4-cylinder scene seen from the identity pose, noise seed 77, no
    table. Returns (xyz_img, valid, T_a, T_b)."""
    T_a, T_b = two_instance_poses()
    cyls = [(T[:3, :3] @ c0 + T[:3, 3], T[:3, :3] @ a0, r0, h0)
            for T in (T_a, T_b) for c0, a0, r0, h0 in CYLINDERS]
    xyz_img, valid = frame(np.eye(4, dtype=np.float32), 77, with_table=False,
                           width=width, height=height, cylinders=cyls)
    return xyz_img, valid, T_a, T_b


def batch_frames(xyz_img: np.ndarray, n: int) -> np.ndarray:
    """``bench.py``'s batch of ``n`` frames: the frame plus N(0, 1e-4)
    jitter on every coordinate, seeds 0..n-1; float32[n, H, W, 3]."""
    return np.stack([xyz_img + np.random.default_rng(i).normal(
        0, 1e-4, xyz_img.shape).astype(np.float32) for i in range(n)])


def scene_points(pts: np.ndarray, capacity: int) -> np.ndarray:
    """The CLI's scene recipe before ``make_cloud(capacity=capacity)``: the
    finite points, strided evenly down to ``capacity`` when there are
    more."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(axis=1)]
    if pts.shape[0] > capacity:
        idx = np.linspace(0, pts.shape[0] - 1, capacity).astype(np.int64)
        pts = pts[idx]
    return pts


def generic_config():
    """The generic ``detect`` path's full-size configuration:
    ``bench_config()`` with its widths unchanged (2560 scene lanes, 512
    keys, k_max 96, 16 candidates, two tiers) and the structure of the
    reference's SHOT_demo flow (``tpu_joints/config.py::SHOT_DEMO``):
    region-growing crop over the kNN graph, ratio matching at τ = 1, the
    OBB of the largest cluster, no plane removal."""
    import dataclasses

    return dataclasses.replace(
        bench_config(), segment_scene=True, rg_backend="graph",
        obb_largest_cluster=True, match_mode="ratio", ratio=1.0,
        remove_plane=False)
