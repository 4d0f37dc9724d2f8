"""Port parity, the segmented organized chain: lattice shifts, lattice
region growing, the segmented ingest (RANSAC plane removal + lattice region
growing + curvature filter on the tile lattice) and ``detect_organized``
with the crop flags — JAX package vs port on the CPU, same inputs.

Scale: 320×240 raycast frames of the bench joint on its table, block 2 /
half-window 3 (a 120×160 lattice), and the level-0 bank at 64 px of
``tests/test_torch_detect.py``.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.level0_bank import level0_jax_bank
from tpu_joints.config import DetectionConfig
from tpu_joints.pipelines import ingest as jingest
from tpu_joints.segment import organized as jorg
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.modelbank import bank as tbank
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.pipelines import ingest as tingest
from tpu_joints_torch.segment import organized as torg

jdet = importlib.import_module("tpu_joints.pipelines.detect")
BANK_KW = dict(descriptor="shot", descr_radius=0.06, rf_radius=0.06,
               rf_k_max=96, frames="board", sampling_radius=0.02, normal_k=16,
               k_max=96, level=0, resolution=64, surface_leaf=0.01,
               key_capacity=64, icp_capacity=1024)
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
LO, HI = syn.CROP_LO, syn.CROP_HI


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose_diff(A, B):
    """(rotation angle in rad, translation distance in m) between poses."""
    Rd = A[:3, :3].astype(np.float64) @ B[:3, :3].astype(np.float64).T
    return (float(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1))),
            float(np.linalg.norm(A[:3, 3] - B[:3, 3])))


FILLS = {"xyz": (np.float32, (3,), 3e38), "normals": (np.float32, (3,), 0.0),
         "valid": (bool, (), False), "labels": (np.int32, (), 7 * 9)}


@pytest.mark.parametrize("kind", sorted(FILLS))
@pytest.mark.parametrize("dr,dc", torg._DIRS)
def test_shift2d_matches(dr, dc, kind):
    """out[r, c] = a[r + dr, c + dc] with the edge at the fill, equal for
    the 8 directions and each fill the region growing uses."""
    dtype, tail, fill = FILLS[kind]
    rng = np.random.default_rng(3)
    a = (rng.uniform(size=(7, 9) + tail) * 50).astype(dtype)
    want = np.asarray(jorg._shift2d(jnp.asarray(a), dr, dc,
                                    jnp.asarray(fill, dtype)))
    got = torg._shift2d(_t(a), dr, dc, fill).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def _flat_lattice(H, W, z):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return np.stack([xs * 0.01, ys * 0.01, np.full((H, W), z)],
                    -1).astype(np.float32)


def _synthetic_lattice(case):
    """The three analytic lattices of ``tests/test_segment_organized.py``:
    a depth discontinuity, a high-curvature band, an undersized island."""
    if case == "depth_jump":
        H, W, kw = 16, 32, dict(min_cluster_size=5, max_edge=0.05)
    elif case == "seed_gate":
        H, W, kw = 12, 30, dict(min_cluster_size=5, max_edge=0.05)
    else:
        H, W, kw = 8, 16, dict(min_cluster_size=10, max_edge=0.02)
    xyz = _flat_lattice(H, W, 1.0)
    normals = np.zeros((H, W, 3), np.float32)
    normals[..., 2] = -1.0
    curv = np.zeros((H, W), np.float32)
    valid = np.ones((H, W), bool)
    if case == "depth_jump":
        xyz[:, W // 2:, 2] = 1.2
    elif case == "seed_gate":
        curv[:, W // 2] = 9.0
    else:
        valid[:] = False
        valid[:, :12] = True
        valid[2:4, 14:16] = True
    return xyz, normals, curv, valid, dict(smoothness_deg=10.0,
                                           curvature_threshold=1.0, **kw)


def _both_lattices(xyz, normals, curv, valid, kw):
    want = jorg.region_growing_lattice(
        jnp.asarray(xyz), jnp.asarray(normals), jnp.asarray(curv),
        jnp.asarray(valid), **kw)
    got = torg.region_growing_lattice(_t(xyz), _t(normals), _t(curv),
                                      _t(valid), **kw)
    return want, got


@pytest.mark.parametrize("case", ["depth_jump", "seed_gate", "min_size"])
def test_lattice_region_growing_matches_on_synthetic_lattices(case):
    want, got = _both_lattices(*_synthetic_lattice(case))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    assert got.labels.dtype == torch.int32 and got.sizes.dtype == torch.int32
    assert len(set(got.labels.numpy().tolist()) - {-1}) == \
        (1 if case == "min_size" else 2)


@pytest.fixture(scope="module")
def frame():
    """320×240 frame of the bench joint on its table, as host arrays."""
    T_gt = syn.bench_pose()
    xyz, valid = syn.frame(T_gt, 42, with_table=True, width=320, height=240)
    return xyz, valid, T_gt


@pytest.fixture(scope="module")
def nodes(frame):
    """The frame's 120×160 lattice nodes (every tile, no capacity cut) from
    the JAX package's ingest: xyz, normals, curvature, valid."""
    xyz, valid, _ = frame
    scene, normals, curvature, _ = jingest.ingest_organized_blocks(
        jnp.asarray(xyz), jnp.asarray(valid), block=2, half_window=3,
        capacity=None, crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI))
    return (np.asarray(scene.xyz).reshape(120, 160, 3),
            np.asarray(normals).reshape(120, 160, 3),
            np.asarray(curvature).reshape(120, 160),
            np.asarray(scene.mask).reshape(120, 160))


@pytest.mark.parametrize("sweeps_per_check", [8, 3, 0])
def test_lattice_region_growing_matches_on_raycast_frame(nodes, monkeypatch,
                                                         sweeps_per_check):
    """Labels and sizes equal on the table frame's lattice (table, chord
    and stub as separate clusters), whatever the sweep schedule: a host
    read every 8 or 3 sweeps, or all 64 sweeps with no read. The reads are
    counted, one per checked chunk."""
    kw = dict(smoothness_deg=12.0, curvature_threshold=7.0,
              min_cluster_size=50, max_edge=0.05)
    monkeypatch.setattr(torg, "SWEEPS_PER_CHECK", sweeps_per_check)
    before = torg.region_growing_lattice.host_checks
    want, got = _both_lattices(*nodes, kw)
    reads = torg.region_growing_lattice.host_checks - before
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    assert len(set(got.labels.numpy().tolist()) - {-1}) >= 3
    if sweeps_per_check == 0:
        assert reads == 0
    else:
        assert 1 <= reads <= -(-64 // sweeps_per_check)


def _seg_cfgs(**overrides):
    base = dict(
        descr_rad=0.06, model_ss=0.02, scene_ss=0.03, normal_k=16,
        match_threshold=0.25, rf_frames="board", rf_rad=0.06, rf_k_max=96,
        k_max=96, cg_size=0.05, cg_thresh=3.0, icp_iterations=6,
        icp_point_to_plane=True, icp_max_corr_dist=0.02,
        icp_max_corr_start=0.2, final_icp_iterations=8, max_candidates=16,
        max_instances_per_view=2, view_grouped_candidates=True,
        split_rotation_modes=True, refine_top=4, tier1_rows=512,
        tier1_iterations=4, tier1_view_iterations=4,
        tier1_polish_iterations=4, scene_capacity=3072,
        scene_key_capacity=256, coverage_accept=0.02,
        remove_plane=True, segment_scene=True, rg_smoothness_deg=12.0,
        rg_max_edge=0.05, cluster_max_curvature=0.08, rg_min_cluster=50)
    base.update(overrides)
    jcfg = DetectionConfig(**base)
    return jcfg, tconfig.from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("flags", [(True, True), (True, False), (False, True)])
def test_ingest_organized_segmented_matches(frame, flags):
    """Mask, n_selected and xyz equal; normals and curvature within 1e-5;
    with both stages on, the table is gone and the joint is kept. Also with
    only the plane removal or only the region growing."""
    xyz, valid, _ = frame
    jcfg, tcfg = _seg_cfgs(remove_plane=flags[0], segment_scene=flags[1])
    sj, nj, cj, selj = jingest.ingest_organized_segmented(
        jnp.asarray(xyz), jnp.asarray(valid), jcfg, block=2, half_window=3,
        crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI))
    st, nt, ct, selt = tingest.ingest_organized_segmented(
        _t(xyz), _t(valid), tcfg, block=2, half_window=3, crop_lo=_t(LO),
        crop_hi=_t(HI))
    assert int(selt) == int(selj)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_array_equal(st.xyz.numpy(), np.asarray(sj.xyz))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    if all(flags):
        m = st.mask.numpy()
        joint, _, _, n_joint = tingest.ingest_organized_blocks(
            *(_t(a) for a in syn.frame(syn.bench_pose(), 42, with_table=False,
                                       width=320, height=240)),
            block=2, half_window=3, capacity=tcfg.scene_capacity,
            crop_lo=_t(LO), crop_hi=_t(HI))
        assert m.sum() > 0.7 * int(joint.count())
        assert float((st.xyz.numpy()[m][:, 2] > 1.25).mean()) < 0.05
        assert (np.linalg.norm(nt.numpy()[m], axis=1) > 0.9).all()


def test_ingest_organized_segmented_rejects_lattice_keypoints(frame):
    """The segmented ingest's lattice keys (``key_group=3``) equal the JAX
    package's, and the unorganized ``prepare_scene`` rejects
    ``keypoints="lattice"`` without them (no sensor lattice to select on)."""
    xyz, valid, _ = frame
    jcfg, tcfg = _seg_cfgs()
    *_, kj = jingest.ingest_organized_segmented(
        jnp.asarray(xyz), jnp.asarray(valid), jcfg, block=2, half_window=3,
        key_group=3)
    st, nt, ct, _, kt = tingest.ingest_organized_segmented(
        _t(xyz), _t(valid), tcfg, block=2, half_window=3, key_group=3)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert 0 < int(kt.sum()) < int(st.mask.sum())
    with pytest.raises(ValueError, match="organized front end"):
        tdet.prepare_scene(st, dataclasses.replace(tcfg, keypoints="lattice"),
                           None, nt, ct)


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    jb = level0_jax_bank(tmp_path_factory)
    tb = tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")
    return jb, tb


def test_detect_organized_segmented_end_to_end(frame, banks):
    """The crop flags on: equal n_selected, candidate views, winning view
    and accept flag; full_pose within 1e-3 rad / 1e-4 m of JAX's; both
    accepted and within 1°/5 mm of the ground truth."""
    xyz, valid, T_gt = frame
    jb, tb = banks
    jcfg, tcfg = _seg_cfgs()
    rj, nj = jdet.detect_organized(
        jnp.asarray(xyz), jnp.asarray(valid), jb, jcfg, block=2,
        half_window=3, crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI))
    rt, nt = tdet.detect_organized(
        _t(xyz), _t(valid), tb, tcfg, block=2, half_window=3,
        crop_lo=_t(LO), crop_hi=_t(HI))
    assert int(nj) == int(nt)
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    assert int(rt.view_idx) == int(rj.view_idx)
    assert bool(rt.accepted) == bool(rj.accepted)
    rot, trans = _pose_diff(rt.full_pose.numpy(), np.asarray(rj.full_pose))
    assert rot < 1e-3 and trans < 1e-4, (rot, trans)
    for pose in (rt.full_pose.numpy(), np.asarray(rj.full_pose)):
        r, t = _pose_diff(pose, T_gt)
        assert np.degrees(r) < 1.0 and t < 0.005, (np.degrees(r), t)
    assert bool(rt.accepted)
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k


def test_prepare_scene_remove_plane_matches(frame):
    """The unorganized ``prepare_scene`` with ``remove_plane``: the cloud
    left after the plane removal is equal (same hypotheses drawn over the
    working set's mask), the table is gone."""
    xyz, valid, _ = frame
    jcfg, tcfg = _seg_cfgs(segment_scene=False)
    plain = dataclasses.replace(jcfg, remove_plane=False)
    sj, nj, cj, _ = jingest.ingest_organized_segmented(
        jnp.asarray(xyz), jnp.asarray(valid), plain, block=2, half_window=3,
        crop_lo=jnp.asarray(LO), crop_hi=jnp.asarray(HI))
    fj = jdet.prepare_scene(sj, jcfg, None, nj, cj)
    from tpu_joints_torch.core.cloud import Cloud

    st = Cloud(_t(sj.xyz), _t(sj.mask), _t(sj.rgb))
    ft = tdet.prepare_scene(st, tcfg, None, _t(nj), _t(cj))
    assert 0 < int(ft.cloud.mask.sum()) < 0.6 * int(np.asarray(sj.mask).sum())
    np.testing.assert_array_equal(ft.cloud.mask.numpy(),
                                  np.asarray(fj.cloud.mask))
    np.testing.assert_array_equal(ft.cloud.xyz.numpy(),
                                  np.asarray(fj.cloud.xyz))
    np.testing.assert_array_equal(ft.keys.xyz.numpy(), np.asarray(fj.keys.xyz))
