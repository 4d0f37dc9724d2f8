"""Descriptor bank: build, load, save (counterpart of
``tpu_joints/modelbank/bank.py``; SHOT descriptors with SHOT or BOARD
voting frames).

The bank is stacked padded tensors — [V, Mk, 352] descriptors, [V, Mk, 3]
keypoints, [V, Mk, 3, 3] frames, [V, 4, 4] poses — on one device, so the
matcher compares a scene with every view in one product. ``.npz`` files
use the reference's layout, so a bank built or saved by the JAX package
loads here (``load_bank`` / ``bank_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu_joints_torch.core.cloud import Cloud, bucket_size, make_cloud
from tpu_joints_torch.features.lrf import board_lrf
from tpu_joints_torch.features.normals import estimate_normals
from tpu_joints_torch.features.shot import compute_shot
from tpu_joints_torch.filters.filters import compact_cloud, uniform_sample_mask
from tpu_joints_torch.modelbank.scanner import render_views
from tpu_joints_torch.neighbors.bruteforce import radius_neighbors

_ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
           "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")


@dataclasses.dataclass(frozen=True)
class ModelBank:
    """Stacked per-view model data, all views padded to one capacity.

    ``model_xyz/model_mask`` hold the (subsampled, shuffled) full CAD cloud
    for the full-model polish and the scene-coverage ranking;
    ``has_model`` says whether it holds any point (read on the host once,
    when the bank is made, so detection never asks the device).
    """

    view_xyz: torch.Tensor   # [V, Nv, 3] partial views (camera frame)
    view_mask: torch.Tensor  # [V, Nv]
    key_xyz: torch.Tensor    # [V, Mk, 3]
    key_valid: torch.Tensor  # [V, Mk] descriptor validity
    desc: torch.Tensor       # [V, Mk, D]
    rf: torch.Tensor         # [V, Mk, 3, 3] voting frames
    poses: torch.Tensor      # [V, 4, 4] model→camera ground truth
    model_xyz: torch.Tensor  # [Nm, 3] full CAD cloud (model frame)
    model_mask: torch.Tensor  # [Nm]
    icp_xyz: torch.Tensor    # [V, Ni, 3] subsampled views for ICP
    icp_mask: torch.Tensor   # [V, Ni]
    params_hash: str = ""
    has_model: bool = True

    @property
    def n_views(self) -> int:
        return self.view_xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.desc.device

    def to_numpy(self) -> dict:
        out = {k: getattr(self, k).cpu().numpy() for k in _ARRAYS}
        out["params_hash"] = np.asarray(self.params_hash)
        return out


def _params_hash(params: dict) -> str:
    return hashlib.sha1(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]


def _subsample_views(view_xyz: np.ndarray, view_mask: np.ndarray,
                     capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Even-stride subsample of each view's valid points for ICP."""
    V, Nv, _ = view_xyz.shape
    cap = min(capacity, Nv)
    out_xyz = np.full((V, cap, 3), 1.0e6, np.float32)
    out_mask = np.zeros((V, cap), bool)
    for v in range(V):
        valid = np.flatnonzero(view_mask[v])
        take = min(cap, valid.size)
        if take:
            sel = valid[np.linspace(0, valid.size - 1, take).astype(np.int64)]
            out_xyz[v, :take] = view_xyz[v, sel]
            out_mask[v, :take] = True
    return out_xyz, out_mask


def bank_from_numpy(arrays: dict, device="cpu") -> ModelBank:
    """ModelBank on ``device`` from a dict of numpy arrays in the ``.npz``
    layout that ``save_bank`` writes (as the reference's does)."""
    t = {k: torch.tensor(np.asarray(arrays[k]), device=device) for k in _ARRAYS}
    return ModelBank(**t, params_hash=str(arrays.get("params_hash", "")),
                     has_model=bool(np.any(arrays["model_mask"])))


def load_bank(path: str, device="cpu") -> ModelBank:
    with np.load(path, allow_pickle=False) as z:
        return bank_from_numpy({k: z[k] for k in z.files}, device=device)


def save_bank(path: str, bank: ModelBank) -> None:
    np.savez_compressed(path, **bank.to_numpy())


def _prefix(cloud: Cloud) -> Cloud:
    """The valid prefix of a compacted cloud at the smallest bucket that
    holds it. Values of every later per-point result are unchanged (padded
    lanes never enter a neighbourhood); only the padding shrinks, which
    keeps the kNN normals from scanning the whole view capacity."""
    cap = min(bucket_size(int(cloud.mask.sum())), cloud.capacity)
    return Cloud(cloud.xyz[:cap], cloud.mask[:cap], cloud.rgb[:cap])


def build_bank(
    model_xyz: np.ndarray,
    descriptor: str = "shot",
    descr_radius: float = 0.02,
    rf_radius: Optional[float] = None,
    frames: str = "shot",
    rf_k_max: int = 256,
    surface_leaf: Optional[float] = None,
    sampling_radius: float = 0.01,
    normal_k: int = 40,
    normal_radius: float = 0.0,
    k_max: int = 128,
    level: int = 1,
    resolution: int = 100,
    view_capacity: Optional[int] = None,
    key_capacity: int = 256,
    icp_capacity: int = 4096,
    views: Optional[List[np.ndarray]] = None,
    poses: Optional[np.ndarray] = None,
    device="cpu",
) -> ModelBank:
    """Render views of a CAD point set and compute its SHOT bank on
    ``device`` — the reference's prep chain (kNN normals, uniform-sampled
    keypoints, SHOT, voting frames of kind ``frames``). Arguments as in the
    reference; ``surface_leaf`` downsamples each view before features."""
    if descriptor != "shot":
        raise NotImplementedError(f"descriptor {descriptor!r} is not ported yet")
    if normal_radius > 0.0:
        raise NotImplementedError("radius normals are not ported yet")
    if frames not in ("shot", "board"):
        raise ValueError(f"unknown frames {frames!r}")
    if rf_radius is None:
        rf_radius = descr_radius
    if views is None or poses is None:
        views, poses, _ = render_views(model_xyz, level=level,
                                       resolution=resolution)
    if view_capacity is None:
        view_capacity = bucket_size(max(max((v.shape[0] for v in views),
                                            default=1), 1))

    cols = {k: [] for k in ("view_xyz", "view_mask", "key_xyz", "key_valid",
                            "desc", "rf")}
    for vxyz in views:
        cloud_full = make_cloud(vxyz, capacity=view_capacity, device=device)
        cloud = cloud_full
        if surface_leaf is not None:
            sel = uniform_sample_mask(cloud_full, surface_leaf)
            cloud, _ = compact_cloud(cloud_full, sel, view_capacity)
        cloud = _prefix(cloud)
        normals, _ = estimate_normals(cloud, k=normal_k)
        keep = uniform_sample_mask(cloud, sampling_radius)
        keys, kidx = compact_cloud(cloud, keep, key_capacity)
        desc, rf, valid = compute_shot(keys, cloud, normals,
                                       radius=descr_radius, k_max=k_max)
        if frames == "board":
            nidx, nwithin, _ = radius_neighbors(
                keys.xyz, cloud.xyz, rf_radius, max(k_max, rf_k_max),
                source_mask=cloud.mask)
            nidx = nidx.long()
            rf, rf_ok = board_lrf(keys.xyz, normals[kidx], cloud.xyz[nidx],
                                  normals[nidx], nwithin & keys.mask[:, None],
                                  rf_radius)
            valid = valid & rf_ok
        cols["view_xyz"].append(cloud_full.xyz)
        cols["view_mask"].append(cloud_full.mask)
        cols["key_xyz"].append(keys.xyz)
        cols["key_valid"].append(valid & keys.mask)
        cols["desc"].append(desc)
        cols["rf"].append(rf)

    params = dict(
        descriptor=descriptor, descr_radius=descr_radius, rf_radius=rf_radius,
        frames=frames, surface_leaf=surface_leaf,
        sampling_radius=sampling_radius, normal_k=normal_k,
        normal_radius=normal_radius, k_max=k_max,
        level=level, resolution=resolution, n_views=len(views),
    )
    # full CAD cloud, at most 8192 points, shuffled so that any prefix or
    # stride is a uniform spatial subsample
    model_xyz = np.asarray(model_xyz, np.float32).reshape(-1, 3)
    if model_xyz.shape[0] > 8192:
        sel = np.linspace(0, model_xyz.shape[0] - 1, 8192).astype(np.int64)
        model_xyz = model_xyz[sel]
    model_xyz = model_xyz[np.random.RandomState(0).permutation(model_xyz.shape[0])]
    model = make_cloud(model_xyz, capacity=max(model_xyz.shape[0], 1),
                       device=device)
    stacked = {k: torch.stack(v) for k, v in cols.items()}
    icp_xyz, icp_mask = _subsample_views(stacked["view_xyz"].cpu().numpy(),
                                         stacked["view_mask"].cpu().numpy(),
                                         icp_capacity)
    return ModelBank(
        **stacked,
        poses=torch.as_tensor(np.asarray(poses, np.float32), device=device),
        model_xyz=model.xyz, model_mask=model.mask,
        icp_xyz=torch.as_tensor(icp_xyz, device=device),
        icp_mask=torch.as_tensor(icp_mask, device=device),
        params_hash=_params_hash(params),
        has_model=bool(model_xyz.shape[0] > 0),
    )
