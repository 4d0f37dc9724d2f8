"""Host-side visualization → PNG dumps (a copy of ``tpu_joints/viz/plot.py``).

Replaces the blocking ``PCLVisualizer`` loops that end every reference
program (``SHOT.cpp:524-581``: scene white, model instances red, rotated
model yellow, correspondence lines green; OBB cube at
``FPFH_scenes_clustered.cpp:1154``; histogram plotter commented at
``SHOT.cpp:553-558``) with non-blocking matplotlib figures saved to disk —
the parity artifact is the ``Results/*.png``-style screenshot, not an
interactive window.

matplotlib is imported at the first plot, not with the module: a host
without it (such as a GPU machine with only the port's packages) can import
everything else, and a plot there raises an ``ImportError`` that says so.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported on first use."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _compact(xyz, mask=None):
    xyz = np.asarray(xyz)
    if mask is not None:
        xyz = xyz[np.asarray(mask, bool)]
    return xyz[np.isfinite(xyz).all(axis=1) & (np.abs(xyz) < 1e5).all(axis=1)]


def _obb_corners(center, axes, extents) -> np.ndarray:
    """8 corners of an oriented box; axes are column eigenvectors."""
    center, axes, extents = (np.asarray(a, np.float64) for a in (center, axes, extents))
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    return center[None, :] + (signs * extents[None, :] / 2.0) @ axes.T


_BOX_EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
              (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]


def plot_detection(
    path: str,
    scene_xyz: np.ndarray,
    scene_mask: Optional[np.ndarray] = None,
    instances: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]] = (),
    obb=None,
    corr_lines: Optional[np.ndarray] = None,
    title: str = "",
    max_points: int = 20000,
) -> str:
    """Scene + aligned instances (+ OBB, + correspondence lines) → PNG.

    ``instances`` is a sequence of (xyz, mask) already transformed into the
    scene frame. ``corr_lines`` is float[[L, 2, 3]] segment endpoints.
    ``obb`` is anything with position/rotation/extents attributes
    (recognize.OBB).
    """
    plt = _pyplot()
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")

    pts = _compact(scene_xyz, scene_mask)
    if pts.shape[0] > max_points:
        pts = pts[:: pts.shape[0] // max_points + 1]
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1.0, c="0.55", label="scene")

    colors = ["tab:red", "tab:orange", "tab:purple", "tab:brown", "tab:pink"]
    for i, (ixyz, imask) in enumerate(instances):
        ip = _compact(ixyz, imask)
        if ip.size:
            ax.scatter(ip[:, 0], ip[:, 1], ip[:, 2], s=2.0,
                       c=colors[i % len(colors)], label=f"instance {i}")

    if corr_lines is not None:
        for a, b in np.asarray(corr_lines):
            ax.plot(*zip(a, b), c="tab:green", lw=0.5, alpha=0.6)

    if obb is not None:
        corners = _obb_corners(obb.position, obb.rotation, obb.extents)
        for i, j in _BOX_EDGES:
            ax.plot(*zip(corners[i], corners[j]), c="tab:blue", lw=1.2)

    if pts.size:
        lo, hi = pts.min(0), pts.max(0)
        mid, span = (lo + hi) / 2, (hi - lo).max() / 2 + 1e-6
        ax.set_xlim(mid[0] - span, mid[0] + span)
        ax.set_ylim(mid[1] - span, mid[1] + span)
        ax.set_zlim(mid[2] - span, mid[2] + span)
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_descriptor_histogram(path: str, desc: np.ndarray, index: int = 0,
                              title: str = "") -> str:
    """One keypoint's descriptor as a bar histogram (the reference's
    commented-out ``PCLHistogramVisualizer``, ``SHOT.cpp:553-558``)."""
    plt = _pyplot()
    d = np.asarray(desc)
    if d.ndim == 2:
        d = d[index]
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.bar(np.arange(d.shape[0]), d, width=1.0)
    ax.set_xlabel("bin")
    ax.set_ylabel("value")
    ax.set_title(title or f"descriptor[{index}] ({d.shape[0]} bins)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_clusters(path: str, xyz: np.ndarray, labels: np.ndarray,
                  mask: Optional[np.ndarray] = None, title: str = "") -> str:
    """Segmentation result, one color per cluster (CloudViewer parity,
    ``segmentation.cpp:134-153``)."""
    plt = _pyplot()
    xyz = np.asarray(xyz)
    labels = np.asarray(labels)
    if mask is not None:
        m = np.asarray(mask, bool)
        xyz, labels = xyz[m], labels[m]
    ok = np.isfinite(xyz).all(axis=1) & (np.abs(xyz) < 1e5).all(axis=1)
    xyz, labels = xyz[ok], labels[ok]
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=1.5,
               c=labels % 20, cmap="tab20")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
