"""Virtual scanner: partial views of a CAD point set from icosphere cameras.

A numpy copy of ``tpu_joints/modelbank/scanner.py`` (``render_views`` and
what it needs, and ``sample_mesh``), so the bank can be built on a host
without JAX. Level 1 = 42 cameras at the tesselated icosphere's vertices
looking at the model centroid; each view is a pinhole z-buffer rendering
back-projected into the camera frame.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def icosphere_vertices(level: int = 1) -> np.ndarray:
    """Unit icosphere vertices; level 0 = 12 (icosahedron), level 1 = 42."""
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
        cache = {}
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



def sample_mesh(xyz: np.ndarray, faces: np.ndarray, n_samples: int,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Area-weighted uniform surface sampling of a triangle mesh."""
    rng = rng or np.random.default_rng(0)
    a, b, c = xyz[faces[:, 0]], xyz[faces[:, 1]], xyz[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / areas.sum()
    fi = rng.choice(len(faces), size=n_samples, p=probs)
    u = rng.uniform(size=(n_samples, 1))
    v = rng.uniform(size=(n_samples, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return (a[fi] + u * (b[fi] - a[fi]) + v * (c[fi] - a[fi])).astype(np.float32)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World→camera rigid transform; the camera looks down +z at target."""
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


def view_poses(model_xyz: np.ndarray, level: int = 1,
               radius_factor: float = 3.0) -> np.ndarray:
    """Model→camera poses, float32[V, 4, 4]; V = 42 at level 1."""
    centroid = model_xyz.mean(0)
    scale = np.linalg.norm(model_xyz - centroid, axis=1).max()
    cams = icosphere_vertices(level) * (radius_factor * scale) + centroid
    return np.stack([_look_at(c.astype(np.float64), centroid.astype(np.float64))
                     for c in cams]).astype(np.float32)


def render_views(model_xyz: np.ndarray, level: int = 1, resolution: int = 100,
                 fov_deg: float = 57.0, radius_factor: float = 3.0
                 ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """(views — float32[Ni, 3] camera-frame clouds, poses float32[V, 4, 4]
    model→camera, entropies float32[V] — covered pixel fraction)."""
    poses = view_poses(model_xyz, level, radius_factor)
    f = (resolution / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    cx = cy = resolution / 2.0
    views: List[np.ndarray] = []
    entropies = []
    for T in poses:
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
        views.append(cam[visible].astype(np.float32))
        entropies.append(np.isfinite(zbuf).mean())
    return views, poses, np.asarray(entropies, np.float32)
