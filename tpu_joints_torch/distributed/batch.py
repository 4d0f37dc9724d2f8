"""Scene-batch data parallelism and bank sharding (counterpart of
``tpu_joints/distributed/batch.py``).

``detect_batch`` without a mesh, on unplaced inputs, is the reference's
serial scene loop: ``detect`` per scene (what the JAX package's ``vmap`` of
the whole pipeline computes). With a mesh, or on inputs that
:func:`shard_inputs` placed, it runs the view-sharded formulation of the
JAX package's ``_detect_batch_shardmap``, with its collectives written out:

  * the scenes are split over ``data``: each data row works on its own
    scenes, from its own thread (``mesh.run_on``), one scene at a time;
  * a scene's features are computed once, on the row's first device, and
    its descriptors copied to the row's other devices;
  * each model shard (device ``(r, c)``) matches the scene against its own
    block of views (the [Ms, Vl·Mk] descriptor product); only its
    per-(key, view) matches [Ms, Vl] cross to the row's first device, where
    they are concatenated in view order (the all-gather);
  * the grouping, the candidate cut and the refine run there. The grouping
    takes every view's keypoints (gathered once per call) and the matches
    laid out as one call over every view lays them out, so a scene's
    result is bit for bit its single-device ``detect``'s wherever the
    shards' products round as the whole one does. (Grouping each shard's
    views apart, as the JAX package does, is not: PyTorch's CUDA sums over
    a view's keys take an order that depends on how many views the call
    holds and on their layout, and a near-tie among the candidates then
    flips.) The refine reads the bank rows of the cut candidates only:
    each shard gathers the candidates' rows at its own clamped view
    indices, sends them in one copy, and the row's first device keeps each
    candidate's owner's rows. No device holds the whole per-view bank, and
    nothing reads the host for it.

The JAX package's two call forms (GSPMD on placed inputs, ``shard_map``
with ``mesh=``) are this one code path here: there is no compiler to
partition the first.
"""
from __future__ import annotations

import importlib
from typing import List

import torch

from tpu_joints_torch.config import DetectionConfig
from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.distributed.mesh import (MODEL_AXIS, Mesh, Placed,
                                               all_gather, bank_sharding,
                                               device_put, on_device,
                                               replicated, run_on,
                                               scene_sharding)
from tpu_joints_torch.modelbank.bank import _ARRAYS, ModelBank
from tpu_joints_torch.serve.batching import tree_zip

# the package exports a function named like this module
D = importlib.import_module("tpu_joints_torch.pipelines.detect")

# the bank arrays every device holds whole; the rest are split by views
_REPLICATED = ("poses", "model_xyz", "model_mask")
# the per-view rows a refine reads (``detect.BankRows``), poses aside
_ROW_FIELDS = ("view_xyz", "view_mask", "icp_xyz", "icp_mask")


def stack_clouds(clouds: List[Cloud]) -> Cloud:
    """Stack equally padded clouds into a batched Cloud [B, N, …]."""
    return Cloud(*(torch.stack(f) for f in zip(*clouds)))


def shard_inputs(scenes: Cloud, bank: ModelBank, mesh: Mesh) -> tuple:
    """Place a scene batch and a bank on the mesh: the scenes' batch axis
    over ``data``, the bank's per-view arrays over ``model`` by views, and
    ``poses`` and the full CAD on every device. Raises ``ValueError`` when
    the view count does not divide over ``model`` (or the batch over
    ``data``)."""
    return (Cloud(*(device_put(t, scene_sharding(mesh)) for t in scenes)),
            _place_bank(bank, mesh))


def _place_bank(bank: ModelBank, mesh: Mesh) -> ModelBank:
    m = mesh.shape[MODEL_AXIS]
    if bank.n_views % m:
        raise ValueError(f"{bank.n_views} bank views do not split evenly "
                         f"over a model axis of {m}")
    placed = {k: device_put(getattr(bank, k),
                            replicated(mesh) if k in _REPLICATED
                            else bank_sharding(mesh)) for k in _ARRAYS}
    return ModelBank(**placed, params_hash=bank.params_hash,
                     has_model=bank.has_model)


def _stack(results: list, device: torch.device):
    """Per-scene results stacked on ``device`` along a new leading axis
    (non-tensor leaves, such as ``has_model``, from the first)."""
    return tree_zip(lambda ts: torch.stack(
        [t.to(device, non_blocking=True) for t in ts]), results)


def detect_batch(scenes: Cloud, bank: ModelBank,
                 cfg: DetectionConfig = DetectionConfig(),
                 mesh: Mesh = None) -> D.DetectionResult:
    """Batched detection of scenes [B, N, …] (``stack_clouds``): one
    ``DetectionResult`` with a leading B on every leaf.

    Unplaced inputs and no mesh: ``detect`` per scene, on the bank's
    device. With ``mesh``, or on inputs placed by :func:`shard_inputs`: the
    view-sharded formulation (module docstring); the result lies on the
    mesh's first device.
    """
    placed = isinstance(scenes.xyz, Placed) or isinstance(bank.desc, Placed)
    if mesh is None and not placed:
        results = [D.detect(Cloud(*(t[b] for t in scenes)), bank, cfg)
                   for b in range(scenes.xyz.shape[0])]
        return _stack(results, bank.device)
    if mesh is None:
        mesh = (scenes.xyz if isinstance(scenes.xyz, Placed)
                else bank.desc).sharding.mesh
    if not isinstance(scenes.xyz, Placed):
        scenes = Cloud(*(device_put(t, scene_sharding(mesh)) for t in scenes))
    if not isinstance(bank.desc, Placed):
        bank = _place_bank(bank, mesh)
    for t in (*scenes, bank.desc):
        if t.sharding.mesh is not mesh:
            raise ValueError("scenes and bank are placed on another mesh")
    rows = run_on(list(mesh.devices[:, 0]),
                  lambda r, dev: _detect_row(scenes, bank, cfg, mesh, r))
    first = mesh.devices[0, 0]
    return _stack([res for row in rows for res in row], first)


def _local_bank(bank: ModelBank, r: int, c: int) -> ModelBank:
    """Device (r, c)'s ModelBank: its block of views (the replicated poses
    and CAD whole)."""
    return ModelBank(**{k: getattr(bank, k).local(r, c) for k in _ARRAYS},
                     params_hash=bank.params_hash, has_model=bank.has_model)


def _detect_row(scenes: Cloud, bank: ModelBank, cfg: DetectionConfig,
                mesh: Mesh, r: int) -> list:
    """Data row r's scenes, one at a time (module docstring)."""
    m = mesh.shape[MODEL_AXIS]
    devs = list(mesh.devices[r, :])
    dev0 = devs[0]
    banks = [_local_bank(bank, r, c) for c in range(m)]
    Vl = banks[0].n_views
    cfg = D._tier_cfg(banks[0], cfg)
    keys = [all_gather([getattr(b, k) for b in banks])
            for k in ("key_xyz", "rf", "key_valid")]
    xyz, mask, rgb = (t.local(r, 0) for t in scenes)
    out = []
    for b in range(xyz.shape[0]):
        feats = D.prepare_scene(Cloud(xyz[b], mask[b], rgb[b]), cfg)
        cols = []
        for dev, bc in zip(devs, banks):
            with on_device(dev):
                desc, valid = (t.to(dev, non_blocking=True)
                               for t in (feats.desc, feats.desc_valid))
                cols.append(D._match_columns(desc, valid, bc.desc,
                                             bc.key_valid, cfg))
        corrs = D._per_view(*(all_gather(f, dim=1) for f in zip(*cols)),
                            feats.desc.shape[0])
        inst = D._group_views_arrays(feats, *keys, corrs, cfg)
        n_corr = corrs.valid.sum(dtype=torch.int32)
        top_flat, top_votes = D._candidate_cut(inst, cfg, 1)
        P = inst.votes.shape[1]
        cand_views = (top_flat // P) % (Vl * m)
        rows = _shard_rows(banks, devs, cand_views, Vl)
        out.append(D.refine_candidates(feats, banks[0], rows, inst, top_flat,
                                       top_votes, cand_views, n_corr, cfg))
    return out


def _shard_rows(banks: List[ModelBank], devs: List[torch.device],
                cand_views: torch.Tensor, Vl: int):
    """The refine's per-view rows of the candidates ``cand_views`` (global
    views, on the row's first device), gathered from the model shards:
    each shard takes the rows at its clamped local indices, sends them in
    one copy, and the first device keeps the owner's."""
    dev0 = devs[0]
    owner = torch.div(cand_views, Vl, rounding_mode="floor")
    fields = None
    for c, (dev, bc) in enumerate(zip(devs, banks)):
        with on_device(dev):
            local = torch.clamp(cand_views.to(dev, non_blocking=True) - c * Vl,
                                0, Vl - 1)
            got = {k: getattr(bc, k)[local].to(dev0, non_blocking=True)
                   for k in _ROW_FIELDS}
        if fields is None:
            fields = got
            continue
        mine = owner == c
        fields = {k: torch.where(mine.reshape(-1, *[1] * (v.ndim - 1)),
                                 got[k], v) for k, v in fields.items()}
    fields["poses"] = banks[0].poses[cand_views]     # replicated
    return _Rows(fields)


class _Rows:
    """``detect.BankRows``' interface over rows already gathered."""

    def __init__(self, fields: dict):
        self.fields = fields

    def __call__(self, field: str, at=None):
        t = self.fields[field]
        return t if at is None else t[at]
