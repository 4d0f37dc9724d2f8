"""Port parity, the two-part search: bank concatenation, the per-part
candidate cut, ``detect_parts_organized`` and ``detect_parts``, and the part
banks built from caller-supplied views — JAX package vs port on the CPU.

Scale: the knobby joint's {chord + brackets, stub} parts of
``tests/test_multi_part.py`` (level-0 banks at 64 px sharing the full joint
CAD) raycast into a 320×240 frame, block 2 / half-window 3; part banks are
built by the JAX package and carried across with ``bank_from_numpy``.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import (cylinder_points, knobby_joint_parts,
                        knobby_joint_primitives)
from tpu_joints.config import DetectionConfig
from tpu_joints.core.cloud import bucket_size
from tpu_joints.core.cloud import make_cloud as jmake_cloud
from tpu_joints.modelbank import build_bank as jbuild_bank
from tpu_joints.modelbank import render_views as jrender_views
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core.cloud import Cloud, make_cloud
from tpu_joints_torch.modelbank import bank as tbank
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.pipelines import multi as tmulti
from tpu_joints_torch.recognize.hough import Instances

jdet = importlib.import_module("tpu_joints.pipelines.detect")
jmulti = importlib.import_module("tpu_joints.pipelines.multi")
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
PART_KW = dict(descriptor="shot", descr_radius=0.06, rf_radius=0.06,
               rf_k_max=128, frames="board", sampling_radius=0.02,
               normal_k=16, k_max=96, surface_leaf=0.01, key_capacity=48,
               icp_capacity=512)


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(jb):
    """A bank of the JAX package as a port bank on the CPU."""
    return tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")


def _pose_diff(A, B):
    Rd = A[:3, :3].astype(np.float64) @ B[:3, :3].astype(np.float64).T
    return (float(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1))),
            float(np.linalg.norm(A[:3, 3] - B[:3, 3])))


def _cfgs(**kw):
    jcfg = DetectionConfig(**kw)
    return jcfg, tconfig.from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def two_part():
    """(JAX part banks, port part banks, frame with and without the table,
    configs) of ``tests/test_multi_part.py``'s organized two-part problem."""
    from tpu_joints.serve.depth import raycast_cylinders

    rng = np.random.default_rng(7)
    parts = knobby_joint_parts(rng, n_chord=1200, n_stub=800, n_knob=300)
    full = np.concatenate([parts["chord"], parts["stub"]])
    part_views = {n: jrender_views(parts[n], level=0, resolution=64)[:2]
                  for n in ("chord", "stub")}
    vc = bucket_size(max(max(v.shape[0] for v in vs)
                         for vs, _ in part_views.values()))
    jbanks = {n: jbuild_bank(full, views=vs, poses=ps, view_capacity=vc,
                             **PART_KW) for n, (vs, ps) in part_views.items()}
    tbanks = {n: _carry(b) for n, b in jbanks.items()}
    cylinders, rects = knobby_joint_primitives()
    T_pose = syn.bench_pose()
    frames = {}
    for table in (False, True):
        img = raycast_cylinders(cylinders, T_pose, width=320, height=240,
                                rects=list(rects) + (syn.TABLE if table else []))
        frames[table] = (np.nan_to_num(img), np.isfinite(img).all(axis=-1))
    base = dict(
        descriptor="shot", descr_rad=0.06, model_ss=0.02, scene_ss=0.03,
        normal_k=16, match_mode="nn", match_threshold=0.25,
        algorithm="hough", rf_frames="board", rf_rad=0.06, rf_k_max=128,
        cg_size=0.05, cg_thresh=3.0, icp_iterations=6,
        icp_point_to_plane=True, icp_max_corr_dist=0.02,
        icp_max_corr_start=0.2, final_icp_iterations=4, max_candidates=6,
        max_instances_per_view=1, refine_top=2, tier1_rows=512,
        tier1_iterations=4, scene_capacity=2048, scene_key_capacity=192,
        coverage_accept=0.02, k_max=96)
    return dict(parts=parts, full=full, views=part_views, vc=vc,
                jbanks=jbanks, tbanks=tbanks, frames=frames, base=base,
                T_pose=T_pose)


def test_concat_banks_matches(two_part):
    """Names, every array of the concatenated bank, the joined hash and the
    per-part models at ICP capacity are equal."""
    nj, cj, pmj, pmmj = jmulti._concat_banks(two_part["jbanks"])
    nt, ct, pmt, pmmt = tmulti._concat_banks(two_part["tbanks"])
    assert nt == nj == ["chord", "stub"]
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    assert ct.params_hash == cj.params_hash and "|" in ct.params_hash
    assert ct.has_model and ct.n_views == 2 * two_part["tbanks"]["chord"].n_views
    np.testing.assert_array_equal(pmt.numpy(), np.asarray(pmj))
    np.testing.assert_array_equal(pmmt.numpy(), np.asarray(pmmj))


def test_concat_banks_rejects_other_view_shapes(two_part):
    tb = two_part["tbanks"]
    short = dataclasses.replace(tb["stub"], view_xyz=tb["stub"].view_xyz[:, :64],
                                view_mask=tb["stub"].view_mask[:, :64])
    with pytest.raises(ValueError, match="share view shapes"):
        tmulti._concat_banks({"chord": tb["chord"], "stub": short})


def test_cat_for_parts_checks_the_shared_cad_once(two_part, monkeypatch):
    """The concatenation and the shared-CAD check (a host read) run once
    per bank set: the second call returns the cached bank untouched."""
    tb = two_part["tbanks"]
    names, cat = tmulti._cat_for_parts(tb)

    def again(_):
        raise AssertionError("concatenated again")

    monkeypatch.setattr(tmulti, "_concat_banks", again)
    names2, cat2 = tmulti._cat_for_parts(tb)
    assert cat2 is cat and names2 == names


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_per_part_cut_matches(two_part, n_parts, grouped):
    """On the same Instances (the JAX package's, over the concatenated
    bank): candidate views and validity equal JAX's ``refine_instances``,
    plain and view-grouped, pooled (1) and per part (2); with 2 parts each
    half of the field holds its own part's views only."""
    jcfg, tcfg = _cfgs(**{**two_part["base"], "max_instances_per_view": 2,
                          "view_grouped_candidates": grouped,
                          "split_rotation_modes": True,
                          "final_icp_iterations": 1, "icp_iterations": 1,
                          "tier1_iterations": 1})
    _, cat, _, _ = jmulti._concat_banks(two_part["jbanks"])
    img, valid = two_part["frames"][False]
    fj, _ = jdet._organized_features_jit(
        jnp.asarray(img), jnp.asarray(valid), jcfg, 2, 3, None, None, None)
    cj = jdet.match_bank(fj.desc, fj.desc_valid, cat.desc, cat.key_valid, jcfg)
    ij = jdet._group_all_views(fj, cat, cj, jcfg)
    rj = jdet.refine_instances(fj, cat, ij, cj.valid.sum(), jcfg,
                               n_parts=n_parts)
    it = Instances(*(_t(getattr(ij, f)) for f in Instances._fields))
    top_flat, top_votes = tdet._candidate_cut(it, tcfg, n_parts)
    views = (top_flat // 2).numpy()
    np.testing.assert_array_equal(views, np.asarray(rj.cand_views))
    np.testing.assert_array_equal((top_votes > 0).numpy(),
                                  np.asarray(rj.cand_valid))
    assert int((top_votes > 0).sum()) >= 2
    if n_parts == 2:
        Vp = cat.desc.shape[0] // 2
        assert (views[:6] < Vp).all() and (views[6:] >= Vp).all()


def test_candidate_cut_rejects_uneven_parts(two_part):
    z = torch.zeros(5, 2)
    inst = Instances(torch.zeros(5, 2, 4, 4), z, z.int(), z.bool(),
                     torch.zeros(5, 2, 3, dtype=torch.bool))
    with pytest.raises(ValueError, match="split evenly"):
        tdet._candidate_cut(inst, tconfig.DetectionConfig(), 2)


def _crop(table, conv):
    return ((conv(syn.CROP_LO), conv(syn.CROP_HI)) if table else (None, None))


@pytest.mark.parametrize("table", [False, True])
def test_detect_parts_organized_matches(two_part, table):
    """The pooled two-part search on the frame of
    ``tests/test_multi_part.py`` (and, with the table behind the joint,
    through the segmented ingest): names, n_selected, the candidate field
    (views and validity, each half its own part's) and the counts equal
    JAX's; on the plain frame part p's slice of the pooled field also
    equals the port's own single-part run on bank p (views equal, tier-1
    poses within 1e-4), as ``test_multi_part.py`` holds the JAX package.

    Poses are not held against JAX's here: at this scale most Hough peaks
    rest on 3-5 matches over 2 model keypoints, a rank-1 fit whose rotation
    about the axis is arbitrary (see
    ``test_torch_detect.py::test_hough_group_matches``), and neither
    package finds the joint (both reject; measured). The refinement's pose
    parity is ``test_two_part_refinement_matches_on_the_same_instances``."""
    kw = dict(two_part["base"])
    if table:
        kw.update(remove_plane=True, segment_scene=True, rg_smoothness_deg=12.0,
                  rg_max_edge=0.05, cluster_max_curvature=0.08)
    jcfg, tcfg = _cfgs(**kw)
    img, valid = two_part["frames"][table]
    jlo, jhi = _crop(table, jnp.asarray)
    lo, hi = _crop(table, _t)
    nj, rj, sj = jmulti.detect_parts_organized(
        jnp.asarray(img), jnp.asarray(valid), two_part["jbanks"], jcfg,
        block=2, half_window=3, crop_lo=jlo, crop_hi=jhi)
    nt, rt, st = tmulti.detect_parts_organized(
        _t(img), _t(valid), two_part["tbanks"], tcfg, block=2, half_window=3,
        crop_lo=lo, crop_hi=hi)
    assert nt == nj == ["chord", "stub"]
    assert int(st) == int(sj)
    Vp = two_part["tbanks"]["chord"].n_views
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    np.testing.assert_array_equal(rt.cand_valid.numpy(),
                                  np.asarray(rj.cand_valid))
    parts = rt.cand_views.numpy() // Vp
    assert (parts[:6] == 0).all() and (parts[6:] == 1).all()
    assert bool(rt.accepted) == bool(rj.accepted)
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k
    assert float(rt.metrics["best_votes"]) == pytest.approx(
        float(rj.metrics["best_votes"]), rel=1e-5)
    for p, name in enumerate([] if table else nt):
        solo, _ = tdet.detect_organized(
            _t(img), _t(valid), two_part["tbanks"][name], tcfg, block=2,
            half_window=3, crop_lo=lo, crop_hi=hi)
        np.testing.assert_array_equal(
            rt.cand_views[p * 6:(p + 1) * 6].numpy() - p * Vp,
            solo.cand_views.numpy(), err_msg=name)
        np.testing.assert_allclose(rt.cand_poses[p * 6:(p + 1) * 6].numpy(),
                                   solo.cand_poses.numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.fixture(scope="module")
def bench_parts():
    """The bench joint's {chord, stub} part banks at small size (level 0,
    64 px; ``bench.py::build_part_banks`` under BENCH_SMALL) built by the
    JAX package, the same as port banks, and the 320×240 table frame."""
    chord, stub = syn.joint_parts(3000, 1800)
    full = np.concatenate([chord, stub])
    pv = {n: jrender_views(p, level=0, resolution=64)[:2]
          for n, p in (("chord", chord), ("stub", stub))}
    vc = bucket_size(max(max(v.shape[0] for v in vs) for vs, _ in pv.values()))
    jbanks = {n: jbuild_bank(
        full, views=vs, poses=ps, view_capacity=vc, descriptor="shot",
        descr_radius=0.06, rf_radius=0.06, rf_k_max=96, frames="board",
        sampling_radius=0.02, normal_k=16, k_max=96, surface_leaf=0.01,
        key_capacity=64, icp_capacity=1024) for n, (vs, ps) in pv.items()}
    T_gt = syn.bench_pose()
    img, valid = syn.frame(T_gt, 42, with_table=True, width=320, height=240)
    return jbanks, {n: _carry(b) for n, b in jbanks.items()}, img, valid, T_gt


def test_two_part_refinement_matches_on_the_same_instances(bench_parts):
    """``refine_instances(n_parts=2)`` of both packages on the JAX
    package's scene features and Instances over the concatenated bench
    banks (segmented table frame, the bench's chain at small size with 16
    candidates per part): same candidate field, same winning part and view,
    both accepted, full_pose within 1e-3 rad / 1e-4 m (measured 0.0 rad,
    9.2e-6 m), both within 1°/5 mm of the ground truth."""
    jbanks, tbanks, img, valid, T_gt = bench_parts
    jcfg, tcfg = _cfgs(
        descr_rad=0.06, model_ss=0.02, scene_ss=0.03, normal_k=16,
        match_threshold=0.25, rf_frames="board", rf_rad=0.06, rf_k_max=96,
        k_max=96, cg_size=0.05, cg_thresh=3.0, icp_iterations=6,
        icp_point_to_plane=True, icp_max_corr_dist=0.02,
        icp_max_corr_start=0.2, final_icp_iterations=8, max_candidates=16,
        max_instances_per_view=2, view_grouped_candidates=True,
        split_rotation_modes=True, refine_top=4, tier1_rows=512,
        tier1_iterations=4, tier1_view_iterations=4,
        tier1_polish_iterations=4, scene_capacity=3072,
        scene_key_capacity=256, coverage_accept=0.02, remove_plane=True,
        segment_scene=True, rg_smoothness_deg=12.0, rg_max_edge=0.05,
        cluster_max_curvature=0.08)
    _, cat, _, _ = jmulti._concat_banks(jbanks)
    _, tcat = tmulti._cat_for_parts(tbanks)
    fj, _ = jdet._organized_features_jit(
        jnp.asarray(img), jnp.asarray(valid), jcfg, 2, 3,
        jnp.asarray(syn.CROP_LO), jnp.asarray(syn.CROP_HI), None)
    jdcfg, tdcfg = jdet._strip_crop(jcfg), tdet._strip_crop(tcfg)
    cj = jdet.match_bank(fj.desc, fj.desc_valid, cat.desc, cat.key_valid, jdcfg)
    ij = jdet._group_all_views(fj, cat, cj, jdcfg)
    rj = jdet.refine_instances(fj, cat, ij, cj.valid.sum(), jdcfg, n_parts=2)
    ft = tdet.SceneFeatures(
        Cloud(_t(fj.cloud.xyz), _t(fj.cloud.mask), _t(fj.cloud.rgb)),
        _t(fj.normals),
        Cloud(_t(fj.keys.xyz), _t(fj.keys.mask), _t(fj.keys.rgb)),
        _t(fj.desc), _t(fj.desc_valid), _t(fj.rf), _t(fj.rf_ok))
    it = Instances(*(_t(getattr(ij, f)) for f in Instances._fields))
    rt = tdet.refine_instances(ft, tcat, it, _t(cj.valid.sum()), tdcfg,
                               n_parts=2)
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    np.testing.assert_array_equal(rt.cand_valid.numpy(),
                                  np.asarray(rj.cand_valid))
    Vp = tbanks["chord"].n_views
    assert int(rt.view_idx) == int(rj.view_idx)
    assert int(rt.view_idx) // Vp == 0          # the chord's bank wins
    assert bool(rt.accepted) and bool(rj.accepted)
    rot, trans = _pose_diff(rt.full_pose.numpy(), np.asarray(rj.full_pose))
    assert rot < 1e-3 and trans < 1e-4, (rot, trans)
    for pose in (rt.full_pose.numpy(), np.asarray(rj.full_pose)):
        r, t = _pose_diff(pose, T_gt)
        assert np.degrees(r) < 1.0 and t < 0.005, (np.degrees(r), t)


def _cylinder_banks(rng, build):
    chord, _ = cylinder_points(rng, radius=0.05, height=0.6, n=700, axis="x")
    stub, _ = cylinder_points(rng, radius=0.12, height=0.15, n=700, axis="z")
    return stub, {n: build(p) for n, p in (("chord", chord), ("stub", stub))}


PARTS_CFG = dict(
    descriptor="shot", descr_rad=0.12, model_ss=0.04, scene_ss=0.04,
    normal_k=10, match_mode="nn", match_threshold=0.25, algorithm="hough",
    cg_size=0.05, cg_thresh=3.0, icp_iterations=10, max_candidates=2,
    max_instances_per_view=2, scene_capacity=1024, scene_key_capacity=64,
    k_max=24)


def test_detect_parts_organized_rejects_mixed_models():
    """Banks carrying different full models must raise (one polish and
    coverage model serves the whole pooled field)."""
    _, banks = _cylinder_banks(np.random.default_rng(3), lambda p: tbank.build_bank(
        p, descriptor="shot", descr_radius=0.12, sampling_radius=0.04,
        normal_k=10, k_max=24, level=0, resolution=64, key_capacity=48,
        device="cpu"))
    with pytest.raises(ValueError, match="share one full CAD"):
        tmulti.detect_parts_organized(
            torch.zeros(32, 32, 3), torch.zeros(32, 32, dtype=torch.bool),
            banks, tconfig.DetectionConfig(**PARTS_CFG))


def test_detect_parts_picks_right_part():
    """``tests/test_multi_part.py::test_detect_parts_picks_right_part`` in
    both packages on the JAX package's banks: the stub wins, per part the
    same candidate views, winning view and accept flag; the winner's full
    pose within 1e-3 rad / 1e-4 m and its box within 1 mm (the losing
    chord's fit rests on a rank-1 Hough peak: measured 4.2e-3 rad)."""
    stub, jbanks = _cylinder_banks(np.random.default_rng(0), lambda p: jbuild_bank(
        p, descriptor="shot", descr_radius=0.12, sampling_radius=0.04,
        normal_k=10, k_max=24, level=0, resolution=64, key_capacity=48))
    views, _, _ = jrender_views(stub, level=0, resolution=96)
    v = int(np.argmax([w.shape[0] for w in views]))
    jcfg, tcfg = _cfgs(**PARTS_CFG)
    oj = jmulti.detect_parts(jmake_cloud(views[v][:1024], capacity=1024),
                             jbanks, jcfg)
    ot = tmulti.detect_parts(
        make_cloud(views[v][:1024], capacity=1024, device="cpu"),
        {n: _carry(b) for n, b in jbanks.items()}, tcfg)
    assert set(ot.per_part) == {"chord", "stub"}
    assert ot.part == oj.part == "stub"
    assert float(ot.result.fitness) < float(ot.per_part["chord"].fitness)
    for name in ("chord", "stub"):
        rt, rj = ot.per_part[name], oj.per_part[name]
        assert int(rt.view_idx) == int(rj.view_idx), name
        assert bool(rt.accepted) == bool(rj.accepted), name
        np.testing.assert_array_equal(rt.cand_views.numpy(),
                                      np.asarray(rj.cand_views))
    rot, trans = _pose_diff(ot.result.full_pose.numpy(),
                            np.asarray(oj.result.full_pose))
    assert rot < 1e-3 and trans < 1e-4, (rot, trans)
    np.testing.assert_allclose(ot.result.obb.extents.numpy(),
                               np.asarray(oj.result.obb.extents), atol=1e-3)


@pytest.mark.parametrize("field,exc", [("hv_enabled", None),
                                       ("coverage_accept", ValueError)])
def test_detect_parts_refuses_what_it_cannot_honour(two_part, field, exc):
    """``coverage_accept`` has no stage in ``detect_parts`` and raises;
    ``hv_enabled`` runs the pooled verification (once over both parts'
    candidates): nothing matches an all-zero scene, so no candidate is
    valid and none is verified."""
    cfg = tconfig.DetectionConfig(**{**PARTS_CFG, field: 1})
    scene = Cloud(torch.zeros(1024, 3), torch.ones(1024, dtype=torch.bool),
                  torch.zeros(1024, 3))
    if exc is not None:
        with pytest.raises(exc):
            tmulti.detect_parts(scene, two_part["tbanks"], cfg)
        return
    out = tmulti.detect_parts(scene, two_part["tbanks"], cfg)
    for res in out.per_part.values():
        assert res.cand_verified.shape == res.cand_valid.shape == (2,)
        assert res.cand_verified.dtype == torch.bool
        assert not bool((res.cand_verified & ~res.cand_valid).any())
        assert not bool(res.accepted)


def test_build_bank_takes_caller_views(two_part):
    """``build_bank(full, views=, poses=, view_capacity=)`` on a part's
    rendered views against the JAX package's: geometry, keypoints, poses
    and the full model equal, descriptors within 1e-4 on >= 95% of the
    valid keys (the normals' kNN tie order, see
    ``test_torch_detect.py::test_build_bank_level0_matches``)."""
    vs, ps = two_part["views"]["stub"]
    jb = two_part["jbanks"]["stub"]
    tb = tbank.build_bank(two_part["full"], views=vs, poses=ps,
                          view_capacity=two_part["vc"], device="cpu", **PART_KW)
    for k in ("view_xyz", "view_mask", "key_xyz", "key_valid", "poses",
              "model_xyz", "model_mask", "icp_xyz", "icp_mask"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    kv = np.asarray(jb.key_valid)
    dd = np.abs(tb.desc.numpy() - np.asarray(jb.desc)).max(-1)[kv]
    assert kv.sum() > 50 and (dd <= 1e-4).mean() >= 0.95 and dd.max() < 1e-2
    assert tb.params_hash == jb.params_hash and tb.has_model
    assert tb.view_xyz.shape[1] == two_part["vc"]


def test_build_part_banks_share_the_full_joint():
    """``synthetic.build_part_banks`` at small size: two banks of equal
    shapes from different views, both carrying the full bench joint."""
    cfg = syn.two_part_config()
    banks = syn.build_part_banks(cfg, device="cpu", level=0, resolution=64,
                                 key_capacity=64, icp_capacity=1024)
    assert list(banks) == ["chord", "stub"]
    c, s = banks["chord"], banks["stub"]
    assert c.view_xyz.shape == s.view_xyz.shape and c.n_views == 12
    assert c.desc.shape == s.desc.shape == (12, 64, 352)
    assert torch.equal(c.model_xyz, s.model_xyz) and c.has_model
    assert c.model_xyz.shape[0] == 8192
    assert int(c.view_mask.sum()) != int(s.view_mask.sum())
    assert cfg.max_candidates == 8 and cfg.tier1_view_iterations == 3
    assert syn.segmented_config().tier1_view_iterations == 4
    names, cat = tmulti._cat_for_parts(banks)
    assert names == ["chord", "stub"] and cat.n_views == 24
