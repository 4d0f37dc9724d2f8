"""The CAD side of the reference: the bench joint's point cloud, the CAD
rows a fitness is taken over, and the 42-view bank's poses and clouds.

Plain NumPy copies of the recipes the configuration names (``bench.py``'s
joint; ``render.cpp``'s icosphere views at level 1, 128 px): the joint is
an input the benchmark makes and hands to the program's bank build, and
the reference derives from the same recipe what the bank holds.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def joint_parts(n_chord: int, n_stub: int, seed: int):
    """(chord, stub) float32 clouds in the joint frame: chord r = 0.08 m
    along x, stub r = 0.05 m inclined 30°, weld cutouts removed."""
    rng = np.random.default_rng(seed)
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
    stub = stub[~(np.linalg.norm(stub[:, 1:], axis=1) < 0.08)]
    return chord.astype(np.float32), stub.astype(np.float32)


def joint_model(model: dict) -> np.ndarray:
    """The CAD cloud of a configuration's ``bank.model`` recipe."""
    return np.concatenate(joint_parts(model["n_chord"], model["n_stub"],
                                      model["seed"]))


def cad_rows(model_xyz: np.ndarray, n: int, keep: int = 8192) -> np.ndarray:
    """The CAD rows a fitness over ``n`` rows is taken on: at most ``keep``
    points evenly along the cloud, shuffled by RandomState(0) (any stride is
    then a uniform spatial sample), then every ``len // n``-th row, the
    first ``n``."""
    xyz = np.asarray(model_xyz, np.float32).reshape(-1, 3)
    if xyz.shape[0] > keep:
        xyz = xyz[np.linspace(0, xyz.shape[0] - 1, keep).astype(np.int64)]
    xyz = xyz[np.random.RandomState(0).permutation(xyz.shape[0])]
    return xyz[::max(1, xyz.shape[0] // n)][:n]


def icosphere_vertices(level: int) -> np.ndarray:
    """Unit icosphere vertices, float32; level 1 = 42."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
         [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
         [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(level):
        vlist: List[np.ndarray] = list(verts)
        cache: Dict[tuple, int] = {}
        new_faces = []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = vlist[i] + vlist[j]
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.stack(vlist)
        faces = np.array(new_faces, np.int64)
    return verts.astype(np.float32)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    upish = (np.array([0.0, 0.0, 1.0]) if abs(fwd[2]) < 0.95
             else np.array([0.0, 1.0, 0.0]))
    right = np.cross(fwd, upish)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    R = np.stack([right, up, fwd])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye
    return T


def view_poses(model_xyz: np.ndarray, level: int,
               radius_factor: float = 3.0) -> np.ndarray:
    """Model→view-camera poses float32[V, 4, 4] of the icosphere bank."""
    centroid = model_xyz.mean(0)
    scale = np.linalg.norm(model_xyz - centroid, axis=1).max()
    cams = icosphere_vertices(level) * (radius_factor * scale) + centroid
    return np.stack([_look_at(c.astype(np.float64), centroid.astype(np.float64))
                     for c in cams]).astype(np.float32)


def render_view(model_xyz: np.ndarray, T: np.ndarray, resolution: int,
                fov_deg: float = 57.0) -> np.ndarray:
    """The points of ``model_xyz`` a pinhole z-buffer at pose ``T`` sees, in
    that camera's frame: one bank view's cloud."""
    f = (resolution / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    cx = cy = resolution / 2.0
    cam = model_xyz @ T[:3, :3].T + T[:3, 3]
    z = cam[:, 2]
    front = z > 1e-6
    u = np.clip((f * cam[:, 0] / np.maximum(z, 1e-6) + cx).astype(np.int64),
                0, resolution - 1)
    v = np.clip((f * cam[:, 1] / np.maximum(z, 1e-6) + cy).astype(np.int64),
                0, resolution - 1)
    pix = v * resolution + u
    zbuf = np.full(resolution * resolution, np.inf, np.float32)
    np.minimum.at(zbuf, pix[front], z[front])
    tol = 1e-3 * max(1.0, np.abs(z[front]).max() if front.any() else 1.0)
    visible = front & (z <= zbuf[pix] + tol)
    return cam[visible].astype(np.float32)
