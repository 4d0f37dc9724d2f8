"""Port parity, ``detect_organized_batch``: B frames through one pass
against the port's own per-frame ``detect_organized`` runs and against the
JAX package's batch (``jax.vmap`` of its fused chain) on the CPU.

Two problems. (1) The two 320×240 frames, the bare-cylinder bank and the
configuration of ``tests/test_segment_organized.py::
test_detect_organized_batch_matches_per_frame``: at that size no Hough peak
reaches the vote threshold in either package, so what is held against JAX
is what is determinate: n_selected, the candidate field, the winning view,
the accept flags and the stage counts. (2) The bench joint at the small
size of ``tests/test_torch_detect.py`` (level-0 bank of the JAX package,
``bench.py``'s chain) on three frames, two of them the bench's jittered
batch frames: the first frame is accepted by both packages.

Tolerances. Batch against the port's per-frame runs: every leaf equal to
the bit. The front end is bit-equal over the batch; from the grouping on
each frame runs on its own exactly as its own run does (a sum over B
frames' rows adds in another order, and a Hough fit on 3-4 matches is
rank-deficient, see ``test_torch_detect.py::test_hough_group_matches``:
its rotation moved by up to 2.0 with that last bit, and a candidate's
refinement with it). JAX's own batch test allows 0.2° and 2 mm on the
winner. Against JAX's batch: accepted frames' poses within 5e-4 (the
single-frame tolerance of ``test_torch_detect.py``)."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_segment_organized import _raycast_frame, _seg_cfg
from tpu_joints.config import DetectionConfig
from tpu_joints.modelbank import build_bank as jbuild_bank
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.filters.filters import (compact_cloud, compact_indices,
                                              uniform_sample_mask)
from tpu_joints_torch.modelbank import bank as tbank
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.pipelines.ingest import ingest_organized_blocks

jdet = importlib.import_module("tpu_joints.pipelines.detect")
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
GEO = dict(block=2, half_window=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(jb):
    return tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")


def _run(imgs, valids, jb, tb, jcfg, tcfg):
    """JAX's batch, the port's batch, the port's per-frame runs and the
    port's bank."""
    jlo, jhi = jnp.asarray(syn.CROP_LO), jnp.asarray(syn.CROP_HI)
    lo, hi = _t(syn.CROP_LO), _t(syn.CROP_HI)
    rj, nj = jdet.detect_organized_batch(
        jnp.asarray(imgs), jnp.asarray(valids), jb, jcfg, crop_lo=jlo,
        crop_hi=jhi, **GEO)
    rt, nt = tdet.detect_organized_batch(_t(imgs), _t(valids), tb, tcfg,
                                         crop_lo=lo, crop_hi=hi, **GEO)
    singles = [tdet.detect_organized(_t(i), _t(v), tb, tcfg, crop_lo=lo,
                                     crop_hi=hi, **GEO)
               for i, v in zip(imgs, valids)]
    return (rj, nj), (rt, nt), singles, tb


@pytest.fixture(scope="module")
def cylinder_problem():
    rngm = np.random.default_rng(7)
    theta = rngm.uniform(0, 2 * np.pi, 1500)
    h = rngm.uniform(-0.3, 0.3, 1500)
    model = np.stack([h, 0.08 * np.cos(theta), 0.08 * np.sin(theta)],
                     1).astype(np.float32)
    cfg = _seg_cfg(descr_rad=0.06, model_ss=0.02, scene_ss=0.02,
                   rf_frames="board", rf_rad=0.06, k_max=64)
    jb = jbuild_bank(model, descriptor="shot", descr_radius=cfg.descr_rad,
                     rf_radius=cfg.rf_rad, frames="board",
                     sampling_radius=cfg.model_ss, normal_k=cfg.normal_k,
                     k_max=cfg.k_max, level=0, resolution=48, key_capacity=32,
                     icp_capacity=512)
    xyz0, valid0, _ = _raycast_frame(segment_table=False)
    T1 = syn.pose(-15.0, 20.0, [-0.03, 0.02, 0.95])
    xyz1 = syn.raycast_cylinders(syn.CYLINDERS, T1, width=320, height=240)
    valid1 = np.isfinite(xyz1).all(axis=-1)
    jcfg = _seg_cfg(
        descr_rad=0.06, model_ss=0.02, scene_ss=0.02, rf_frames="board",
        rf_rad=0.06, cg_size=0.05, icp_iterations=4, max_candidates=4,
        max_instances_per_view=1, k_max=64, scene_key_capacity=128,
        final_icp_iterations=2, segment_scene=False, remove_plane=False)
    tcfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    imgs = np.stack([xyz0, np.nan_to_num(xyz1)])
    valids = np.stack([valid0, valid1])
    return imgs, valids, _run(imgs, valids, jb, _carry(jb), jcfg, tcfg), tcfg


@pytest.fixture(scope="module")
def joint_problem():
    model = syn.joint_model(3000, 1800)
    jb = jbuild_bank(
        model, descriptor="shot", descr_radius=0.06, rf_radius=0.06,
        rf_k_max=96, frames="board", sampling_radius=0.02, normal_k=16,
        k_max=96, level=0, resolution=64, surface_leaf=0.01, key_capacity=64,
        icp_capacity=1024)
    T_gt = syn.bench_pose()
    xyz, valid = syn.frame(T_gt, 42, with_table=False, width=320, height=240)
    jcfg = DetectionConfig(
        descr_rad=0.06, model_ss=0.02, scene_ss=0.03, normal_k=16,
        match_threshold=0.25, rf_frames="board", rf_rad=0.06, rf_k_max=96,
        k_max=96, cg_size=0.05, cg_thresh=3.0, icp_iterations=6,
        icp_point_to_plane=True, icp_max_corr_dist=0.02,
        icp_max_corr_start=0.2, final_icp_iterations=8, max_candidates=16,
        max_instances_per_view=2, view_grouped_candidates=True,
        split_rotation_modes=True, refine_top=4, tier1_rows=512,
        tier1_iterations=4, tier1_view_iterations=3,
        tier1_polish_iterations=4, scene_capacity=3072,
        scene_key_capacity=256, coverage_accept=0.02)
    tcfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    jitter = syn.batch_frames(xyz, 3)
    imgs = np.stack([xyz, jitter[2], jitter[0]])
    valids = np.stack([valid] * 3)
    return (imgs, valids, _run(imgs, valids, jb, _carry(jb), jcfg, tcfg), tcfg,
            T_gt)


def _leaves(res):
    out = {f: getattr(res, f) for f in res._fields if f not in ("obb", "metrics")}
    out.update({f"obb.{f}": getattr(res.obb, f) for f in res.obb._fields})
    out.update({f"metrics.{k}": v for k, v in res.metrics.items()
                if isinstance(v, torch.Tensor)})
    return out


def assert_batch_equals_singles(rt, nt, singles):
    """Every leaf of the batch result has a leading B and equals the
    frame's own ``detect_organized`` run to the bit."""
    B = len(singles)
    assert rt.full_pose.shape == (B, 4, 4) and nt.shape == (B,)
    assert rt.metrics["has_model"] is True
    for b, (r1, n1) in enumerate(singles):
        assert int(nt[b]) == int(n1)
        leaves, own = _leaves(rt), _leaves(r1)
        assert leaves.keys() == own.keys()
        for name, one in own.items():
            a = leaves[name][b]
            assert a.shape == one.shape and a.dtype == one.dtype, name
            assert torch.equal(a, one), (name, b)


@pytest.mark.parametrize("problem", ["cylinder_problem", "joint_problem"])
def test_batch_equals_per_frame_runs(problem, request):
    """The batch against each frame's own run (``assert_batch_equals_singles``);
    only the joint's frames are accepted."""
    imgs, valids, (_, (rt, nt), singles, _), *_ = request.getfixturevalue(problem)
    assert any(bool(r.accepted) for r, _ in singles) == (
        problem == "joint_problem")
    assert_batch_equals_singles(rt, nt, singles)


@pytest.mark.parametrize("problem", ["cylinder_problem", "joint_problem"])
def test_a_frame_does_not_depend_on_its_batch(problem, request):
    """The frames in reverse order, and the last frame with the first
    alone: each frame's leaves are its own run's, whatever it is batched
    with."""
    imgs, valids, (_, _, singles, tb), tcfg, *_ = request.getfixturevalue(
        problem)
    lo, hi = _t(syn.CROP_LO), _t(syn.CROP_HI)
    for order in (list(range(len(imgs)))[::-1], [len(imgs) - 1, 0]):
        rt, nt = tdet.detect_organized_batch(
            _t(imgs[order]), _t(valids[order]), tb, tcfg, crop_lo=lo,
            crop_hi=hi, **GEO)
        assert_batch_equals_singles(rt, nt, [singles[i] for i in order])


@pytest.mark.parametrize("problem", ["cylinder_problem", "joint_problem"])
def test_batch_matches_jax_batch(problem, request):
    fix = request.getfixturevalue(problem)
    ((rj, nj), (rt, nt), _, _) = fix[2]
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(rt.cand_views.numpy(), np.asarray(rj.cand_views))
    np.testing.assert_array_equal(rt.cand_valid.numpy(), np.asarray(rj.cand_valid))
    acc = np.asarray(rj.accepted)
    np.testing.assert_array_equal(rt.accepted.numpy(), acc)
    # a frame both packages reject has no winner worth the name: its best
    # candidate is whichever wrong pose ranks first
    np.testing.assert_array_equal(rt.view_idx.numpy()[acc],
                                  np.asarray(rj.view_idx)[acc])
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        np.testing.assert_array_equal(rt.metrics[k].numpy(),
                                      np.asarray(rj.metrics[k]), err_msg=k)
    for f in ("full_pose", "cand_poses", "fitness"):
        assert getattr(rt, f).shape == np.asarray(getattr(rj, f)).shape, f
    if problem == "joint_problem":
        T_gt = fix[4]
        assert acc[0]
        np.testing.assert_allclose(rt.full_pose.numpy()[acc],
                                   np.asarray(rj.full_pose)[acc], atol=5e-4)
        for pose in rt.full_pose.numpy()[acc]:
            Rd = pose[:3, :3] @ T_gt[:3, :3].T
            rot = np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1)))
            assert rot < 1.0 and np.linalg.norm(pose[:3, 3] - T_gt[:3, 3]) < 0.005


def test_front_end_takes_the_batch(joint_problem):
    """Ingest, keypoint sampling and compaction over [B, ...] equal the
    per-frame calls exactly."""
    imgs, valids, *_ , tcfg, _ = joint_problem
    lo, hi = _t(syn.CROP_LO), _t(syn.CROP_HI)
    sb, nb, cb, selb = ingest_organized_blocks(
        _t(imgs), _t(valids), capacity=tcfg.scene_capacity, crop_lo=lo,
        crop_hi=hi, **GEO)
    keepb = uniform_sample_mask(sb, tcfg.scene_ss)
    keysb, kidxb = compact_cloud(sb, keepb, tcfg.scene_key_capacity)
    assert sb.xyz.shape == (3, tcfg.scene_capacity, 3) and selb.shape == (3,)
    for b in range(3):
        s1, n1, c1, sel1 = ingest_organized_blocks(
            _t(imgs[b]), _t(valids[b]), capacity=tcfg.scene_capacity,
            crop_lo=lo, crop_hi=hi, **GEO)
        assert torch.equal(sb.xyz[b], s1.xyz) and torch.equal(sb.mask[b], s1.mask)
        assert torch.equal(nb[b], n1) and torch.equal(cb[b], c1)
        assert int(selb[b]) == int(sel1)
        keep1 = uniform_sample_mask(s1, tcfg.scene_ss)
        assert torch.equal(keepb[b], keep1) and 100 < int(keep1.sum())
        keys1, kidx1 = compact_cloud(s1, keep1, tcfg.scene_key_capacity)
        assert torch.equal(keysb.xyz[b], keys1.xyz)
        assert torch.equal(keysb.mask[b], keys1.mask)
        assert torch.equal(kidxb[b], kidx1)
    # over capacity: each row thinned on its own count
    m = torch.zeros(2, 50, dtype=torch.bool)
    m[0, ::2] = True
    m[1, 5:45] = True
    idx, ok = compact_indices(m, 16)
    for r in range(2):
        i1, o1 = compact_indices(m[r], 16)
        assert torch.equal(idx[r], i1) and torch.equal(ok[r], o1)


def test_batch_entry_checks(joint_problem):
    imgs, valids, _, tcfg, _ = joint_problem
    bank = tbank.bank_from_numpy(
        {k: np.zeros((1,) + s, t) for k, s, t in [
            ("view_xyz", (8, 3), np.float32), ("view_mask", (8,), bool),
            ("key_xyz", (4, 3), np.float32), ("key_valid", (4,), bool),
            ("desc", (4, 352), np.float32), ("rf", (4, 3, 3), np.float32),
            ("poses", (4, 4), np.float32), ("icp_xyz", (8, 3), np.float32),
            ("icp_mask", (8,), bool)]}
        | {"model_xyz": np.zeros((8, 3), np.float32),
           "model_mask": np.zeros(8, bool), "params_hash": "x"}, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, H, W, 3\]"):
        tdet.detect_organized_batch(_t(imgs[0]), _t(valids[0]), bank, tcfg)
    scene = Cloud(torch.zeros(2, 64, 3), torch.ones(2, 64, dtype=torch.bool),
                  torch.zeros(2, 64, 3))
    with pytest.raises(NotImplementedError, match="batch of frames"):
        tdet.prepare_scene(scene, tcfg)
