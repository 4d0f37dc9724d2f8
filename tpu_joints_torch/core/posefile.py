"""Ground-truth pose-file parser (a copy of ``tpu_joints/core/posefile.py``).

The reference stores one camera pose per rendered CAD view as 12 floats
(row-major 3x4) per line in ``pose.txt``, parsed with a hand ``sscanf`` loop
at ``SHOT_demo.cpp:204-239`` / ``FPFH_scenes_clustered.cpp:189-224``. Same
format here, plus the 4x4 convenience form.
"""
from __future__ import annotations

from typing import List

import numpy as np


def load_pose_file(path: str) -> np.ndarray:
    """Parse pose.txt → float32[V, 4, 4] homogeneous transforms."""
    poses: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if not vals:
                continue
            if len(vals) == 12:
                M = np.array(vals, np.float32).reshape(3, 4)
                T = np.eye(4, dtype=np.float32)
                T[:3, :] = M
            elif len(vals) == 16:
                T = np.array(vals, np.float32).reshape(4, 4)
            else:
                raise ValueError(f"pose line has {len(vals)} floats, expected 12 or 16")
            poses.append(T)
    return np.stack(poses) if poses else np.zeros((0, 4, 4), np.float32)


def save_pose_file(path: str, poses: np.ndarray) -> None:
    """Write poses as 12 floats per line (row-major 3x4), reference format."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9g}" for v in np.asarray(T)[:3, :].reshape(-1)) + "\n")
