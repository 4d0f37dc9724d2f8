"""Port parity, detection chain: scene features, bank matching, Hough
grouping, batched ICP, scene coverage, the end-to-end ``detect_organized``
and the bank build — JAX package vs port on the CPU, same inputs.

Scale: a level-0 bank (12 views at 64 px, ``tests/test_organized.py``-size)
and a 320×240 frame with block 2 / half-window 3, as in
``tests/test_segment_organized.py``'s organized detect tests — but of the
bench joint (chord + inclined stub) rather than the bare cylinder: a bare
cylinder bank on this frame only yields sub-threshold Hough peaks, so there
is no winner whose parity would mean anything. Both packages compute from
the bank JAX built (the port loads its arrays) and from one config.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_joints.config import DetectionConfig
from tpu_joints.modelbank.bank import build_bank as jbuild_bank
from tpu_joints.modelbank.bank import load_bank as jload_bank
from tpu_joints.modelbank.bank import save_bank as jsave_bank
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core.cloud import Cloud
from tpu_joints_torch.modelbank import bank as tbank
from tpu_joints_torch.pipelines import detect as tdet
from tpu_joints_torch.pipelines.ingest import ingest_organized_blocks
from tpu_joints_torch.recognize import icp as ticp
from tpu_joints_torch.recognize.matching import Correspondences

BANK_KW = dict(descriptor="shot", descr_radius=0.06, rf_radius=0.06,
               rf_k_max=96, frames="board", sampling_radius=0.02, normal_k=16,
               k_max=96, level=0, resolution=64, surface_leaf=0.01,
               key_capacity=64, icp_capacity=1024)
# the packages' __init__ re-export functions named like these modules
jdet = importlib.import_module("tpu_joints.pipelines.detect")
jicp = importlib.import_module("tpu_joints.recognize.icp")
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(T, G):
    Rd = T[:3, :3] @ G[:3, :3].T
    return (float(np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1)))),
            float(np.linalg.norm(T[:3, 3] - G[:3, 3])))


@pytest.fixture(scope="module")
def problem():
    """(model, JAX bank, port bank from its arrays, frame, T_gt, cfgs)."""
    model = syn.joint_model(3000, 1800)
    jb = jbuild_bank(model, **BANK_KW)
    tb = tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash})
    T_gt = syn.bench_pose()
    xyz, valid = syn.frame(T_gt, 42, with_table=False, width=320, height=240)
    # bench.py's scene_latency chain at the small size it validates on CPU
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
    return model, jb, tb, xyz, valid, T_gt, jcfg, tcfg


@pytest.fixture(scope="module")
def features(problem):
    """Scene features from both packages on the same frame."""
    _, _, _, xyz, valid, _, jcfg, tcfg = problem
    fj, _ = jdet._organized_features_jit(
        jnp.asarray(xyz), jnp.asarray(valid), jcfg, 2, 3,
        jnp.asarray(syn.CROP_LO), jnp.asarray(syn.CROP_HI), None)
    scene, normals, _, _ = ingest_organized_blocks(
        _t(xyz), _t(valid), block=2, half_window=3,
        capacity=tcfg.scene_capacity, crop_lo=_t(syn.CROP_LO),
        crop_hi=_t(syn.CROP_HI))
    ft = tdet.prepare_scene(scene, tcfg, normals)
    return fj, ft


def _port_features(fj):
    """The JAX package's scene features as port tensors."""
    c = Cloud(_t(fj.cloud.xyz), _t(fj.cloud.mask), _t(fj.cloud.rgb))
    k = Cloud(_t(fj.keys.xyz), _t(fj.keys.mask), _t(fj.keys.rgb))
    return tdet.SceneFeatures(c, _t(fj.normals), k, _t(fj.desc),
                              _t(fj.desc_valid), _t(fj.rf), _t(fj.rf_ok))


def test_shot_and_board_frames_match(features):
    """Keypoints exact; SHOT descriptors and BOARD frames within 1e-4 where
    defined (validity flags equal)."""
    fj, ft = features
    np.testing.assert_array_equal(ft.keys.xyz.numpy(), np.asarray(fj.keys.xyz))
    dv = np.asarray(fj.desc_valid)
    np.testing.assert_array_equal(ft.desc_valid.numpy(), dv)
    np.testing.assert_allclose(ft.desc.numpy()[dv], np.asarray(fj.desc)[dv],
                               rtol=0, atol=1e-4)
    ok = np.asarray(fj.rf_ok)
    np.testing.assert_array_equal(ft.rf_ok.numpy(), ok)
    np.testing.assert_allclose(ft.rf.numpy()[ok], np.asarray(fj.rf)[ok],
                               rtol=0, atol=1e-4)


def test_match_bank_matches(problem, features):
    _, jb, tb, _, _, _, jcfg, tcfg = problem
    fj, _ = features
    cj = jdet.match_bank(fj.desc, fj.desc_valid, jb.desc, jb.key_valid, jcfg)
    ct = tdet.match_bank(_t(fj.desc), _t(fj.desc_valid), tb.desc, tb.key_valid,
                         tcfg)
    v = np.asarray(cj.valid)
    assert v.sum() > 100
    np.testing.assert_array_equal(ct.valid.numpy(), v)
    np.testing.assert_array_equal(ct.model_idx.numpy()[v],
                                  np.asarray(cj.model_idx)[v])
    np.testing.assert_allclose(ct.dist_sq.numpy()[v], np.asarray(cj.dist_sq)[v],
                               rtol=1e-5, atol=1e-6)


def test_hough_group_matches(problem, features):
    """Valid flags and n_corrs equal, votes within 1e-5; poses within 1e-4
    wherever the fit is unique. A fit is unique when the weighted
    cross-covariance H of its members has rank >= 2; when several matches
    pile onto one model keypoint, H has rank 1 (σ1/σ0 ~ 1e-8 measured) and
    any rotation about that axis is a least-squares optimum — the packages
    then return different, equally valid, proper rotations."""
    _, jb, tb, _, _, _, jcfg, tcfg = problem
    fj, _ = features
    cj = jdet.match_bank(fj.desc, fj.desc_valid, jb.desc, jb.key_valid, jcfg)
    ij = jdet._group_all_views(fj, jb, cj, jcfg)
    ct = Correspondences(_t(cj.model_idx).long(), _t(cj.valid), _t(cj.dist_sq))
    it = tdet._group_all_views(_port_features(fj), tb, ct, tcfg)
    valid = np.asarray(ij.valid)
    assert valid.sum() >= 4
    np.testing.assert_array_equal(it.valid.numpy(), valid)
    np.testing.assert_array_equal(it.n_corrs.numpy(), np.asarray(ij.n_corrs))
    np.testing.assert_array_equal(it.membership.numpy(), np.asarray(ij.membership))
    np.testing.assert_allclose(it.votes.numpy(), np.asarray(ij.votes), rtol=1e-5,
                               atol=1e-5)
    key_xyz, scene_keys = np.asarray(jb.key_xyz), np.asarray(fj.keys.xyz)
    mi, mem = np.asarray(cj.model_idx), np.asarray(ij.membership)
    unique = 0
    for v, p in zip(*np.nonzero(valid)):
        R = it.poses.numpy()[v, p, :3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        src = key_xyz[v][mi[v]][mem[v, p]].astype(np.float64)
        dst = scene_keys[mem[v, p]].astype(np.float64)
        sv = np.linalg.svd((dst - dst.mean(0)).T @ (src - src.mean(0)),
                           compute_uv=False)
        if sv[1] > 1e-6 * sv[0]:
            unique += 1
            np.testing.assert_allclose(it.poses.numpy()[v, p],
                                       np.asarray(ij.poses)[v, p], atol=1e-4)
    assert unique >= 2


def _perturbed(T, seed, n):
    """``n`` poses within a few degrees and millimetres of ``T``."""
    from tests.util import random_rotation

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        axis = random_rotation(rng)[:, 0]
        ang = np.radians(rng.uniform(2.0, 5.0))
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        dT = np.eye(4)
        dT[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
        dT[:3, 3] = rng.uniform(-0.01, 0.01, 3)
        out.append(dT @ T)
    return np.stack(out).astype(np.float32)


def test_icp_multi_and_coverage_match(problem, features):
    """The tier-2 polish situation — the full CAD model (stride-subsampled
    to 1024 rows) point-to-plane ICP'd onto the scene from 4 inits a few
    degrees/mm off the true pose — then scene coverage, within 1e-4. The
    JAX CPU path finds each nearest neighbour with the expansion
    |q|²+|s|²−2q·s, the port with kernel K1's exact difference form, so a
    near-tie may pick another point; on a converging problem that moves the
    pose far less than the tolerance. The fitness (mean squared NN distance
    over the whole CAD, its occluded back included) is held at rtol 1e-3:
    measured 5.1e-4 on one of the 4 candidates, where back-side points sit
    near-equidistant from several scene points."""
    _, jb, tb, _, _, T_gt, _, _ = problem
    fj, _ = features
    m_xyz, m_mask = (t.numpy() for t in tdet._model_at_capacity(tb, 1024))
    inits = _perturbed(T_gt, 3, 4)
    src = np.broadcast_to(m_xyz, (4, 1024, 3)).copy()
    msk = np.broadcast_to(m_mask, (4, 1024)).copy()
    kw = dict(iterations=6, max_corr_dist=0.02, max_corr_start=0.2,
              point_to_plane=True)
    Tj, fitj = jicp.icp_multi(jnp.asarray(src), jnp.asarray(msk), fj.cloud,
                              jnp.asarray(inits), target_normals=fj.normals,
                              **kw)
    ft = _port_features(fj)
    Tt, fitt = ticp.icp_multi(_t(src), _t(msk), ft.cloud, _t(inits),
                              target_normals=ft.normals, **kw)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(fitt.numpy(), np.asarray(fitj), rtol=1e-3,
                               atol=1e-7)
    for T in Tt.numpy():   # and the polish really converged
        rot, trans = _err(T, T_gt)
        assert rot < 1.0 and trans < 0.005, (rot, trans)
    model_xyz, model_mask = np.asarray(jb.model_xyz), np.asarray(jb.model_mask)
    covj, unj = jicp.scene_coverage_multi(fj.cloud, jnp.asarray(model_xyz),
                                          jnp.asarray(model_mask), Tj)
    covt, unt = ticp.scene_coverage_multi(ft.cloud, _t(model_xyz),
                                          _t(model_mask), Tt)
    np.testing.assert_allclose(covt.numpy(), np.asarray(covj), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(unt.numpy(), np.asarray(unj), atol=1e-3)


def test_detect_organized_end_to_end(problem):
    """Equal n_selected, candidate field, winning view and accept flag;
    full_pose within 5e-4 (the fused-vs-split tolerance of
    test_segment_organized); both within 1°/5 mm of the ground truth."""
    _, jb, tb, xyz, valid, T_gt, jcfg, tcfg = problem
    rj, nj = jdet.detect_organized(
        jnp.asarray(xyz), jnp.asarray(valid), jb, jcfg, block=2,
        half_window=3, crop_lo=jnp.asarray(syn.CROP_LO),
        crop_hi=jnp.asarray(syn.CROP_HI))
    rt, nt = tdet.detect_organized(
        _t(xyz), _t(valid), tb, tcfg, block=2, half_window=3,
        crop_lo=_t(syn.CROP_LO), crop_hi=_t(syn.CROP_HI))
    assert int(nj) == int(nt)
    np.testing.assert_array_equal(rt.cand_views.numpy(), np.asarray(rj.cand_views))
    assert int(rt.view_idx) == int(rj.view_idx)
    assert bool(rt.accepted) == bool(rj.accepted)
    np.testing.assert_allclose(rt.full_pose.numpy(), np.asarray(rj.full_pose),
                               rtol=0, atol=5e-4)
    for pose in (rt.full_pose.numpy(), np.asarray(rj.full_pose)):
        rot, trans = _err(pose, T_gt)
        assert rot < 1.0 and trans < 0.005, (rot, trans)
    assert bool(rt.accepted)
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k


def test_build_bank_level0_matches(problem):
    """The port's own bank build, array by array against JAX's. Geometry,
    keypoints and validity are exact. Descriptors and frames agree within
    1e-4 on all but a few valid keypoints: the reference's k=16 normals
    select neighbours with XLA's approximate top-k, whose CPU fallback
    orders exact distance ties by neither index (measured: the 16th
    neighbour 125 before 117 at equal distance), so a point's normal can
    differ where a tie sits on the k-th place (one point in 4 of 12 views,
    measured), and with it the descriptors whose support holds that point
    (21 of 723 valid keypoints, up to 6.4e-3)."""
    model, jb, _, _, _, _, _, _ = problem
    tb = tbank.build_bank(model, **BANK_KW)
    for k in ("view_xyz", "view_mask", "key_xyz", "key_valid", "poses",
              "model_xyz", "model_mask", "icp_xyz", "icp_mask"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    kv = np.asarray(jb.key_valid)
    assert kv.sum() > 100
    dd = np.abs(tb.desc.numpy() - np.asarray(jb.desc)).max(-1)[kv]
    rd = np.abs(tb.rf.numpy() - np.asarray(jb.rf)).max(axis=(-1, -2))[kv]
    assert (dd <= 1e-4).mean() >= 0.95 and dd.max() < 1e-2, (dd > 1e-4).sum()
    assert (rd <= 1e-4).mean() >= 0.98 and rd.max() < 1e-2, (rd > 1e-4).sum()
    assert tb.params_hash == jb.params_hash and tb.has_model


def test_bank_npz_interchange(problem, tmp_path):
    """A bank saved by the JAX package loads into the port, and back."""
    _, jb, tb, _, _, _, _, _ = problem
    jsave_bank(str(tmp_path / "jax.npz"), jb)
    loaded = tbank.load_bank(str(tmp_path / "jax.npz"))
    tbank.save_bank(str(tmp_path / "port.npz"), loaded)
    back = jload_bank(str(tmp_path / "port.npz"))
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(loaded, k).numpy(),
                                      np.asarray(getattr(jb, k)))
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(jb, k)))
    assert loaded.params_hash == back.params_hash == jb.params_hash
