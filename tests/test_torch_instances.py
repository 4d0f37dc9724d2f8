"""Port parity, multi-instance detection: the peak-grouped candidate cut,
``good_instances`` / ``metrics_to_json``, the two-instance problem of
``tests/test_multi_instance.py`` (level-0 bank, 4096-lane scene) with HV
off, two-tier, peak-grouped and HV on, and the pooled HV of
``detect_parts`` — JAX package vs port on the CPU, banks built by the JAX
package and carried across with ``bank_from_numpy``.

What is held. End to end (each package's own ``detect``): the candidate
field (views, validity), ``cand_verified``, the accept flag and the stage
counts are equal. Poses are held on the SAME Instances (the JAX package's
scene features and Hough output through both ``refine_instances``): one
valid Hough instance of this scene rests on 3 matches, a rank-deficient fit
whose rotation the packages choose differently (0.9 apart; see
``test_torch_detect.py::test_hough_group_matches``), and that candidate's
ICP then lands elsewhere. On shared Instances every valid candidate's
refined pose agrees within 1e-4 (measured 2e-6) and the GOOD lists hold
the same two joints, poses within 1e-4 and fitness within 1e-6. Which of
several candidates on one joint represents it is not held: the scene is two
noise-free copies of the model, so their ranks tie down to rounding."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import cylinder_points, knobby_joint_points, random_rotation
from tpu_joints.config import DetectionConfig
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
CFG = dict(
    descriptor="shot", descr_rad=0.12, model_ss=0.03, scene_ss=0.03,
    normal_k=12, match_mode="nn", match_threshold=0.25, algorithm="hough",
    cg_size=0.05, cg_thresh=3.0, icp_iterations=20, max_candidates=8,
    max_instances_per_view=2, accept_fitness=0.001, scene_capacity=4096,
    scene_key_capacity=768, k_max=96)
VARIANTS = {
    "hv_off": {},
    # refine_top = 4, not the original test's 2: the four candidates on the
    # two (noise-free) joints tie in coverage and differ in fitness by
    # ~1e-9, rounding noise that orders them differently in each package,
    # so a cut of 2 keeps both joints in one and one joint twice in the other
    "two_tier": dict(refine_top=4, final_icp_iterations=6),
    "peak_grouped": dict(split_rotation_modes=True,
                         peak_grouped_candidates=True,
                         max_instances_per_view=4, refine_top=4,
                         final_icp_iterations=6),
    "hv_on": dict(hv_enabled=True, hv_inlier_threshold=0.01),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(jb):
    return tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")


def _cfgs(**kw):
    jcfg = DetectionConfig(**kw)
    return jcfg, tconfig.from_dict(dataclasses.asdict(jcfg))


def _pose(seed, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = random_rotation(np.random.default_rng(seed))
    T[:3, 3] = np.asarray(t, np.float32)
    return T


def _result_to_torch(rj):
    """A JAX DetectionResult as a port one (tensors on the CPU)."""
    return tdet.DetectionResult(
        **{f: _t(getattr(rj, f)) for f in tdet.DetectionResult._fields
           if f not in ("obb", "metrics")},
        obb=tdet.OBB(*(_t(x) for x in rj.obb)),
        metrics={k: _t(v) for k, v in rj.metrics.items()})


@pytest.fixture(scope="module")
def problem():
    """The two-instance problem, each package's end-to-end ``detect`` per
    variant, and both ``refine_instances`` on the JAX package's features
    and Instances."""
    rng = np.random.default_rng(0)
    model_xyz, _ = knobby_joint_points(rng, n_chord=900, n_stub=500,
                                       n_knob=150, jitter=0.0)
    T_a = _pose(7, [-0.35, 0.0, 0.0])
    T_b = _pose(11, [0.35, 0.05, -0.05])
    scene_xyz = np.concatenate([model_xyz @ T_a[:3, :3].T + T_a[:3, 3],
                                model_xyz @ T_b[:3, :3].T + T_b[:3, 3]])
    jb = jbuild_bank(model_xyz, descriptor="shot", descr_radius=0.12,
                     sampling_radius=0.03, normal_k=12, k_max=96, level=0,
                     resolution=96, key_capacity=192)
    tb = _carry(jb)
    js = jmake_cloud(scene_xyz, capacity=4096)
    ts = make_cloud(scene_xyz, capacity=4096, device="cpu")
    jcfg0, _ = _cfgs(**CFG)
    fj = jdet.prepare_scene(js, jcfg0)
    cj = jdet.match_bank(fj.desc, fj.desc_valid, jb.desc, jb.key_valid, jcfg0)
    ft = tdet.SceneFeatures(
        Cloud(_t(fj.cloud.xyz), _t(fj.cloud.mask), _t(fj.cloud.rgb)),
        _t(fj.normals),
        Cloud(_t(fj.keys.xyz), _t(fj.keys.mask), _t(fj.keys.rgb)),
        _t(fj.desc), _t(fj.desc_valid), _t(fj.rf), _t(fj.rf_ok))
    out = {}
    for name, kw in VARIANTS.items():
        jcfg, tcfg = _cfgs(**{**CFG, **kw})
        ij = jdet._group_all_views(fj, jb, cj, jcfg)
        it = Instances(*(_t(getattr(ij, f)) for f in Instances._fields))
        out[name] = dict(
            jcfg=jcfg, tcfg=tcfg, ij=ij, it=it,
            end_j=jdet.detect(js, jb, jcfg), end_t=tdet.detect(ts, tb, tcfg),
            shared_j=jdet.refine_instances(fj, jb, ij, cj.valid.sum(), jcfg),
            shared_t=tdet.refine_instances(ft, tb, it, _t(cj.valid.sum()),
                                           tcfg))
    return out, T_a, T_b


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_candidate_field_end_to_end(problem, name):
    v = problem[0][name]
    rj, rt = v["end_j"], v["end_t"]
    np.testing.assert_array_equal(rt.cand_views.numpy(), np.asarray(rj.cand_views))
    np.testing.assert_array_equal(rt.cand_valid.numpy(), np.asarray(rj.cand_valid))
    np.testing.assert_array_equal(rt.cand_verified.numpy(),
                                  np.asarray(rj.cand_verified))
    assert bool(rt.accepted) and bool(rj.accepted)
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k
    assert int(rt.cand_valid.sum()) >= 4
    if name == "hv_on":       # the joint optimum drops same-spot duplicates
        assert 2 <= int(rt.cand_verified.sum()) < int(rt.cand_valid.sum())
    else:
        assert torch.equal(rt.cand_verified, rt.cand_valid)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_refinement_and_good_list_on_shared_instances(problem, name):
    out, T_a, T_b = problem
    v = out[name]
    rj, rt = v["shared_j"], v["shared_t"]
    ok = np.asarray(rj.cand_valid)
    np.testing.assert_array_equal(rt.cand_views.numpy(), np.asarray(rj.cand_views))
    np.testing.assert_array_equal(rt.cand_valid.numpy(), ok)
    np.testing.assert_array_equal(rt.cand_verified.numpy(),
                                  np.asarray(rj.cand_verified))
    np.testing.assert_array_equal(rt.metrics["cand_tier2"].numpy(),
                                  np.asarray(rj.metrics["cand_tier2"]))
    np.testing.assert_allclose(
        rt.metrics["cand_full_poses"].numpy()[ok],
        np.asarray(rj.metrics["cand_full_poses"])[ok], atol=1e-4)
    gj = jdet.good_instances(rj, v["jcfg"], min_separation=0.2)
    gt = tdet.good_instances(rt, v["tcfg"], min_separation=0.2)
    assert len(gt) == len(gj) == 2
    # the two joints are noise-free copies of one model: their ranks tie to
    # ~1e-9, so which of the two leads the list (and is the winner) is not
    # determinate; the winner is one of the two GOOD poses
    assert min(np.abs(rt.full_pose.numpy() - k["pose"]).max() for k in gj) < 1e-4
    by_place = lambda g: sorted(g, key=lambda k: k["pose"][0, 3])
    for a, b in zip(by_place(gt), by_place(gj)):
        np.testing.assert_allclose(a["pose"], b["pose"], atol=1e-4)
        assert a["fitness"] == pytest.approx(b["fitness"], abs=1e-6)
    # each GOOD instance is one of the two joints, both are covered
    near = {min("ab", key=lambda n: np.linalg.norm(
        k["pose"][:3, 3] - (T_a if n == "a" else T_b)[:3, 3])) for k in gt}
    assert near == {"a", "b"}
    for k in gt:
        T = T_a if k["pose"][0, 3] < 0 else T_b
        assert np.linalg.norm(k["pose"][:3, 3] - T[:3, 3]) < 0.010


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("min_separation", [0.05, 0.2])
def test_good_instances_equal_on_the_same_result(problem, name, min_separation):
    """The host-side list on the JAX package's own result arrays: equal,
    entry by entry; refine_top = 1 reports at most the tier-2 winner."""
    v = problem[0][name]
    for rj in (v["end_j"], v["shared_j"]):
        gj = jdet.good_instances(rj, v["jcfg"], min_separation=min_separation)
        gt = tdet.good_instances(_result_to_torch(rj), v["tcfg"],
                                 min_separation=min_separation)
        assert len(gt) == len(gj) >= 1
        for a, b in zip(gt, gj):
            assert {k: a[k] for k in ("view_idx", "fitness", "candidate")} == \
                {k: b[k] for k in ("view_idx", "fitness", "candidate")}
            np.testing.assert_array_equal(a["pose"], b["pose"])
    if name == "two_tier":      # one tier-2 survivor: at most one instance
        cfg1 = dataclasses.replace(v["tcfg"], refine_top=1)
        rt = _result_to_torch(v["shared_j"])
        one = rt.metrics["cand_tier2"].clone()
        one[one.nonzero()[1:]] = False
        rt.metrics["cand_tier2"] = one
        assert len(tdet.good_instances(rt, cfg1, min_separation)) <= 1
    no_table = _result_to_torch(v["end_j"])
    del no_table.metrics["cand_full_poses"]
    assert tdet.good_instances(no_table, v["tcfg"]) == []


def test_metrics_to_json_matches(problem):
    v = problem[0]["peak_grouped"]
    mj = jdet.metrics_to_json(v["shared_j"].metrics)
    mt = tdet.metrics_to_json(v["shared_t"].metrics)
    assert set(mt) == set(mj) and "cand_full_poses" not in mt
    import json

    json.dumps(mt)
    for k in mj:
        # the unexplained fraction counts scene points beyond 2 cm of the
        # model: a point within rounding of the threshold flips between the
        # packages' distance forms, 1/2000 each (2 flips measured)
        atol = 2e-3 if "unexplained" in k else 1e-4
        np.testing.assert_allclose(np.asarray(mt[k], np.float64),
                                   np.asarray(mj[k], np.float64), atol=atol,
                                   err_msg=k)
    assert isinstance(mt["scene_points"], float)
    assert isinstance(mt["cand_tier2"], list) and len(mt["cand_tier2"]) == 8


def _jax_cut(inst, cfg, n_parts):
    """``top_flat`` as ``tpu_joints/pipelines/detect.py::refine_instances``
    forms it for the peak-grouped cut."""
    import jax

    V, P = inst.votes.shape
    Vp = V // n_parts
    Cp = min(cfg.max_candidates, Vp * P)
    votes = jnp.where(inst.valid, inst.votes, -1.0).reshape(n_parts, Vp * P)
    strength = votes.reshape(n_parts, Vp * P // 2, 2).max(axis=2)
    _, top_pairs = jax.lax.top_k(strength, Cp // 2)
    top_local = (top_pairs[:, :, None] * 2 + jnp.arange(2)).reshape(n_parts, Cp)
    return (top_local + (Vp * P) * jnp.arange(n_parts)[:, None]).reshape(-1)


@pytest.mark.parametrize("n_parts,max_candidates", [(1, 8), (1, 4), (2, 6),
                                                    (3, 4)])
def test_peak_grouped_cut_matches(problem, n_parts, max_candidates):
    """``_candidate_cut`` with the peak-grouped cut: ``top_flat`` equals the
    JAX package's on the same Instances, for one part and for the 12 views
    split into 2 and 3 parts; both modes of a peak enter together."""
    v = problem[0]["peak_grouped"]
    jcfg = dataclasses.replace(v["jcfg"], max_candidates=max_candidates)
    tcfg = dataclasses.replace(v["tcfg"], max_candidates=max_candidates)
    want = np.asarray(_jax_cut(v["ij"], jcfg, n_parts))
    top_flat, top_votes = tdet._candidate_cut(v["it"], tcfg, n_parts)
    np.testing.assert_array_equal(top_flat.numpy(), want)
    assert (top_flat.numpy()[0::2] % 2 == 0).all()
    np.testing.assert_array_equal(top_flat.numpy()[1::2],
                                  top_flat.numpy()[0::2] + 1)
    flat_votes = torch.where(v["it"].valid, v["it"].votes, -1.0).reshape(-1)
    assert torch.equal(top_votes, flat_votes[top_flat])
    if n_parts == 1 and max_candidates == 8:
        np.testing.assert_array_equal(
            top_flat.numpy() // 4, np.asarray(v["shared_j"].cand_views))


def test_peak_cut_equals_view_cut_with_one_peak_per_view(problem):
    """P = 2 (one peak per view): the peak pairs ARE the views."""
    it = problem[0]["peak_grouped"]["it"]
    one_peak = Instances(*(getattr(it, f)[:, :2] for f in Instances._fields))
    base = dict(CFG, split_rotation_modes=True, max_instances_per_view=2)
    by_view, _ = tdet._candidate_cut(one_peak, tconfig.DetectionConfig(
        **base, view_grouped_candidates=True), 1)
    by_peak, _ = tdet._candidate_cut(one_peak, tconfig.DetectionConfig(
        **base, peak_grouped_candidates=True), 1)
    assert torch.equal(by_view, by_peak)


def test_detect_parts_pooled_hv_matches():
    """``tests/test_multi_part.py::test_detect_parts_honors_hv`` in both
    packages on the JAX package's banks: the stub wins, the pooled
    verification rejects at least one valid candidate, and the per-part
    ``cand_verified`` masks are equal."""
    rng = np.random.default_rng(0)
    chord, _ = cylinder_points(rng, radius=0.05, height=0.6, n=700, axis="x")
    stub, _ = cylinder_points(rng, radius=0.12, height=0.15, n=700, axis="z")
    jbanks = {n: jbuild_bank(
        p, descriptor="shot", descr_radius=0.12, sampling_radius=0.04,
        normal_k=10, k_max=24, level=0, resolution=64, key_capacity=48)
        for n, p in (("chord", chord), ("stub", stub))}
    views, _, _ = jrender_views(stub, level=0, resolution=96)
    v = int(np.argmax([w.shape[0] for w in views]))
    jcfg, tcfg = _cfgs(
        descriptor="shot", descr_rad=0.12, model_ss=0.04, scene_ss=0.04,
        normal_k=10, match_mode="nn", match_threshold=0.25, algorithm="hough",
        cg_size=0.05, cg_thresh=3.0, icp_iterations=10, max_candidates=2,
        max_instances_per_view=2, scene_capacity=1024, scene_key_capacity=64,
        k_max=24, hv_enabled=True, hv_inlier_threshold=0.01,
        hv_occlusion_threshold=0.001)
    oj = jmulti.detect_parts(jmake_cloud(views[v][:1024], capacity=1024),
                             jbanks, jcfg)
    ot = tmulti.detect_parts(
        make_cloud(views[v][:1024], capacity=1024, device="cpu"),
        {n: _carry(b) for n, b in jbanks.items()}, tcfg)
    assert ot.part == oj.part == "stub"
    n_valid = n_verified = 0
    for name in ("chord", "stub"):
        rt, rj = ot.per_part[name], oj.per_part[name]
        np.testing.assert_array_equal(rt.cand_valid.numpy(),
                                      np.asarray(rj.cand_valid))
        np.testing.assert_array_equal(rt.cand_verified.numpy(),
                                      np.asarray(rj.cand_verified))
        assert bool(rt.accepted) == bool(rj.accepted)
        n_valid += int(rt.cand_valid.sum())
        n_verified += int(rt.cand_verified.sum())
    assert 0 < n_verified < n_valid


def test_two_instance_recipe_equals_bench():
    """``synthetic``'s two-instance scene and its two configurations are
    ``bench.py``'s (the poses, the 4-cylinder frame of seed 77, the wide
    crop box, the config fields)."""
    bench = pytest.importorskip("bench")
    T_a = bench._pose(25.0, -15.0, [-0.30, -0.16, 1.05])
    T_b = bench._pose(-20.0, 20.0, [0.30, 0.18, 1.00])
    cyls2 = [(T[:3, :3] @ c0 + T[:3, 3], T[:3, :3] @ a0, r0, h0)
             for T in (T_a, T_b) for c0, a0, r0, h0 in bench._CYLINDERS]
    img, valid = bench._frame(np.eye(4, dtype=np.float32), 77,
                              with_table=False, cylinders=cyls2)
    xs, vs, Ta, Tb = syn.two_instance_frame()
    np.testing.assert_array_equal(Ta, T_a)
    np.testing.assert_array_equal(Tb, T_b)
    np.testing.assert_array_equal(xs, img)
    np.testing.assert_array_equal(vs, valid)
    assert 60_000 < int(vs.sum()) < 80_000
    np.testing.assert_array_equal(syn.WIDE_LO,
                                  np.array([-0.8, -0.6, 0.5], np.float32))
    np.testing.assert_array_equal(syn.WIDE_HI,
                                  np.array([0.8, 0.6, 1.7], np.float32))
    det = dataclasses.replace(syn.bench_config(), segment_scene=False,
                              remove_plane=False)
    multi = dataclasses.replace(
        det, coverage_local=True, max_instances_per_view=4,
        peak_grouped_candidates=True, max_candidates=48, refine_top=12,
        tier1_view_iterations=4, icp_allow_pallas=False, scene_capacity=8192,
        scene_key_capacity=1024)
    assert syn.multi_instance_config() == multi
    assert syn.hv_config() == dataclasses.replace(
        multi, hv_enabled=True, hv_inlier_threshold=0.01)
    jitter = syn.batch_frames(xs[:8, :8], 3)
    assert jitter.shape == (3, 8, 8, 3) and jitter.dtype == np.float32
    np.testing.assert_array_equal(
        jitter[2], xs[:8, :8] + np.random.default_rng(2).normal(
            0, 1e-4, (8, 8, 3)).astype(np.float32))
