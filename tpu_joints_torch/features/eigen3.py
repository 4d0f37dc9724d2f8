"""Closed-form batched symmetric 3x3 eigendecomposition.

Counterpart of ``tpu_joints/features/eigen3.py``: trigonometric eigenvalues
(Smith 1961), Cayley-Hamilton product eigenvectors sharpened by one shifted
inverse-iteration step. The same elementwise formulas run on CPU and GPU, so
both devices compute the same thing (``torch.linalg.eigh`` would not).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-12


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` forms it."""
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by the rule of Sarrus (no LU, no sync)."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _eye3(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=A.dtype, device=A.device)


def eigvals3x3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], descending: [..., 3]."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * _eye3(A)
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 0.0))
    r = det3(B) / torch.clamp_min(2.0 * p * p * p, _EPS)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    l0 = q + 2.0 * p * torch.cos(phi)
    l2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l1 = 3.0 * q - l0 - l2
    return torch.stack([l0, l1, l2], dim=-1)


def _eigvec_from_product(A, la, lb, fallback):
    """Unit eigenvector for the eigenvalue not in {la, lb}: the largest
    column of (A - la I)(A - lb I); ``fallback`` when degenerate."""
    I = _eye3(A)
    M = (A - la[..., None, None] * I) @ (A - lb[..., None, None] * I)
    norms = (M * M).sum(dim=-2)
    best = torch.argmax(norms, dim=-1)
    idx = best[..., None, None].expand(*M.shape[:-1], 1)
    v = torch.gather(M, -1, idx)[..., 0]
    n = norm(v, keepdim=True)
    ok = n[..., 0] > 1e-20
    return torch.where(ok[..., None], v / torch.clamp_min(n, _EPS), fallback)


def _adjugate_apply(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """adj(M) @ v for [..., 3, 3] without forming the inverse."""
    c1, c2, c3 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    r1, r2, r3 = cross(c2, c3), cross(c3, c1), cross(c1, c2)
    return torch.stack([(r1 * v).sum(-1), (r2 * v).sum(-1),
                        (r3 * v).sum(-1)], dim=-1)


def _inverse_iteration_polish(A, lam, v, scale):
    """One shifted inverse-iteration step (sign kept consistent with v)."""
    shift = (lam + 1e-6 * scale)[..., None, None]
    x = _adjugate_apply(A - shift * _eye3(A), v)
    n = norm(x, keepdim=True)
    ok = n[..., 0] > 1e-25
    x = torch.where(ok[..., None], x / torch.clamp_min(n, _EPS), v)
    sgn = torch.where((x * v).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return x * sgn


def eigh3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigvals [..., 3] descending, eigvecs [..., 3, 3] with
    ``eigvecs[..., :, i]`` the unit eigenvector of ``eigvals[..., i]``),
    right-handed basis; robust to planes and isotropic neighbourhoods."""
    vals = eigvals3x3(A)
    l0, l1, l2 = vals[..., 0], vals[..., 1], vals[..., 2]
    eye = _eye3(A)
    ex = eye[0].expand(l0.shape + (3,))
    ez = eye[2].expand(l0.shape + (3,))
    v0 = _eigvec_from_product(A, l1, l2, ex)
    v2 = _eigvec_from_product(A, l0, l1, ez)
    scale = torch.maximum(l0.abs(), l2.abs()) + 1e-30
    v0 = _inverse_iteration_polish(A, l0, v0, scale)
    v2 = _inverse_iteration_polish(A, l2, v2, scale)
    # if v2 came out parallel to v0 (degenerate), take any perpendicular
    dot = (v0 * v2).sum(-1, keepdim=True)
    v2p = v2 - dot * v0
    n2 = norm(v2p, keepdim=True)
    alt = cross(v0, ez)
    alt_n = norm(alt, keepdim=True)
    alt2 = cross(v0, ex)
    alt = torch.where(alt_n > 1e-6, alt / torch.clamp_min(alt_n, _EPS),
                      alt2 / torch.clamp_min(norm(alt2, keepdim=True), _EPS))
    v2 = torch.where(n2[..., 0:1] > 1e-6, v2p / torch.clamp_min(n2, _EPS), alt)
    v1 = cross(v2, v0)
    return vals, torch.stack([v0, v1, v2], dim=-1)


def smallest_eigenvector(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unit eigenvector of the smallest eigenvalue, eigenvalues descending)."""
    vals, vecs = eigh3x3(A)
    return vecs[..., :, 2], vals
