"""Rigid-pose math over padded clouds (counterpart of
``tpu_joints/core/transforms.py``). Every function batches over leading
axes; products run in full float32 (TF32 is off package-wide)."""
from __future__ import annotations

import math

import torch

from tpu_joints_torch.core.cloud import SENTINEL
from tpu_joints_torch.features.eigen3 import cross, eigh3x3, norm


def transform_points(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to [..., 3] points."""
    return xyz @ T[:3, :3].T + T[:3, 3]


def masked_centroid(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Centroid over valid points; [3]. Safe for empty masks."""
    w = mask.to(xyz.dtype)
    return (xyz * w[:, None]).sum(0) / torch.clamp_min(w.sum(), 1.0)


def masked_covariance(xyz, mask, centroid=None) -> torch.Tensor:
    """Normalized 3x3 covariance over valid points (PCL-normalized: /count)."""
    if centroid is None:
        centroid = masked_centroid(xyz, mask)
    w = mask.to(xyz.dtype)
    d = (xyz - centroid) * w[:, None]
    return (d.T @ d) / torch.clamp_min(w.sum(), 1.0)


def masked_minmax(xyz: torch.Tensor, mask: torch.Tensor):
    """(min[3], max[3]) over valid points."""
    lo = torch.where(mask[:, None], xyz, SENTINEL).amin(0)
    hi = torch.where(mask[:, None], xyz, -SENTINEL).amax(0)
    return lo, hi


def umeyama(src: torch.Tensor, dst: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares rigid transform T [..., 4, 4], T @ src ≈ dst.

    src/dst [..., N, 3], weights [..., N]; all-zero weights give identity.
    The Kabsch rotation U·diag(1, 1, sign det(UVᵀ))·Vᵀ of the cross
    covariance H = U Σ Vᵀ is formed without an SVD (which would synchronise
    with the host on CUDA): V is the closed-form eigenbasis of HᵀH, and
    u0 = Hv0/|Hv0|, u1 = Gram-Schmidt(Hv1), u2 = u0 × u1. Building u2 as a
    cross product IS the reflection fix: it equals the SVD's third column
    when det H > 0 and its negation otherwise.
    """
    w = weights.to(src.dtype)
    wsum = w.sum(-1)
    safe = wsum > 1e-6
    denom = torch.clamp_min(wsum, 1e-6)[..., None]
    mu_s = (src * w[..., None]).sum(-2) / denom
    mu_d = (dst * w[..., None]).sum(-2) / denom
    s = src - mu_s[..., None, :]
    d = dst - mu_d[..., None, :]
    H = ((d * w[..., None]).transpose(-1, -2) @ s) / denom[..., None]
    # float64 from here to R: HᵀH squares H's condition number, and Hough
    # fits routinely see σ1/σ0 ~ 1e-3 (matches piling onto a few keys).
    # R is invariant to scaling H, so normalise it: the closed form's
    # eigenvalue step clamps p³ at 1e-12, far above mm-scale (HᵀH)³.
    H = H.double()
    H = H / torch.clamp_min(H.abs().amax(dim=(-2, -1), keepdim=True), 1e-300)
    _, V = eigh3x3(H.transpose(-1, -2) @ H)
    HV = H @ V
    h0, h1 = HV[..., :, 0], HV[..., :, 1]
    u0 = h0 / torch.clamp_min(norm(h0, keepdim=True), 1e-30)
    u1 = h1 - (u0 * h1).sum(-1, keepdim=True) * u0
    n1 = norm(u1, keepdim=True)
    # rank-1 H: any unit vector perpendicular to u0 completes the basis
    eye = torch.eye(3, dtype=u0.dtype, device=u0.device)
    alt = cross(u0, eye[0].expand_as(u0))
    alt = torch.where(norm(alt, keepdim=True) > 1e-3, alt,
                      cross(u0, eye[1].expand_as(u0)))
    alt = alt / torch.clamp_min(norm(alt, keepdim=True), 1e-30)
    u1 = torch.where(n1 > 1e-12 * torch.clamp_min(norm(h0, keepdim=True), 1e-30),
                     u1 / torch.clamp_min(n1, 1e-30), alt)
    U = torch.stack([u0, u1, cross(u0, u1)], dim=-1)
    R = (U @ V.transpose(-1, -2)).to(src.dtype)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    T = torch.eye(4, dtype=src.dtype, device=src.device).expand(
        *R.shape[:-2], 4, 4).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    eye = torch.eye(4, dtype=src.dtype, device=src.device)
    return torch.where(safe[..., None, None], T, eye)


def compose(*Ts: torch.Tensor) -> torch.Tensor:
    """compose(A, B) applies B first, then A (batched)."""
    out = Ts[0]
    for T in Ts[1:]:
        out = out @ T
    return out


def invert_rigid(T: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid [..., 4, 4] transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    Ti = torch.eye(4, dtype=T.dtype, device=T.device).expand(T.shape).clone()
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    return Ti


def rotation_from_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [3, 3] → quaternion [w, x, y, z], branch-free."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp_min(1.0 + tr, 1e-12)) / 2.0
    q0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                      (m10 - m01) / (4 * qw)])
    qx = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 1e-12)) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                      (m02 + m20) / (4 * qx)])
    qy = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 1e-12)) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                      (m12 + m21) / (4 * qy)])
    qz = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 1e-12)) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                      (m12 + m21) / (4 * qz), qz])
    cand = torch.stack([q0, q1, q2, q3])
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11])
    q = cand.index_select(0, torch.argmax(pivots).reshape(1))[0]
    return q / norm(q)


def quaternion_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [w, x, y, z] → roll/pitch/yaw (radians), ZYX."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw])


def fold_euler_90(euler: torch.Tensor) -> torch.Tensor:
    """Wrap Euler angles into [-90°, 90°] by ±180° (joint half-turn symmetry)."""
    e = torch.where(euler > math.pi / 2, euler - math.pi, euler)
    return torch.where(e < -math.pi / 2, e + math.pi, e)


def rotation_geodesic_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle between two rotations in degrees."""
    M = Ra.transpose(-1, -2) @ Rb
    c = (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] - 1.0) / 2.0
    return torch.rad2deg(torch.acos(torch.clamp(c, -1.0, 1.0)))
