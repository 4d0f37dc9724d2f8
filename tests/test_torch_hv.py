"""Port parity, hypothesis verification and the ICP module's remaining
functions — JAX package vs port on the CPU, on the inputs of
``tests/test_hv_occlusion.py`` and ``tests/test_recognize.py``.

Tolerances. ``scene_depth_buffer`` / ``_occluded``: exact. ``explained`` /
``outliers`` threshold a nearest-neighbour distance that the JAX package
forms in the expansion form on the CPU and the port in kernel K1's
difference form, so a point within rounding of the threshold may flip: at
most 2 flipped entries per instance are allowed (0 measured on these
inputs). The subset search is held EXACTLY on shared explained / outliers
(the costs are sums of small integers). Fitness, coverage and ICP: 1e-6
absolute on distances² of ~1e-3, 1e-5 on poses."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import joint_points
from tpu_joints.core.cloud import make_cloud as jmake_cloud
from tpu_joints_torch.core.cloud import make_cloud
from tpu_joints_torch.recognize import hv as thv
ticp = importlib.import_module("tpu_joints_torch.recognize.icp")

jhv = importlib.import_module("tpu_joints.recognize.hv")
jicp = importlib.import_module("tpu_joints.recognize.icp")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cylinder(rng, n=800, r=0.06, half=0.2, z0=1.0):
    th = rng.uniform(0, 2 * np.pi, n)
    x = rng.uniform(-half, half, n)
    return np.stack([x, r * np.cos(th), r * np.sin(th) + z0], 1).astype(
        np.float32)


def _clouds(pts, capacity):
    return (jmake_cloud(pts, capacity=capacity),
            make_cloud(pts, capacity=capacity, device="cpu"))


@pytest.fixture(scope="module")
def cylinder():
    model = _cylinder(np.random.default_rng(0))
    return model, _clouds(model[model[:, 2] < 1.0], 1024)


@pytest.fixture(scope="module")
def joint():
    """The hypothesis sets of ``tests/test_recognize.py``: name ->
    (instances [H, 512, 3], masks, valid), over one 512-lane joint scene."""
    rng = np.random.default_rng(0)
    xyz, _ = joint_points(rng, n_chord=250, n_stub=150)
    n = xyz.shape[0]
    pad = ((0, 512 - n), (0, 0))
    good = np.pad(xyz + rng.normal(scale=1e-4, size=xyz.shape).astype(
        np.float32), pad, constant_values=1e6)
    sets = {}
    mask2 = np.zeros((2, 512), bool)
    mask2[:, :n] = True
    sets["real_and_offset"] = (np.stack([good, good + np.float32(0.5)]), mask2,
                               np.ones(2, bool))
    insts = [good] + [good + np.array([o, -o, o], np.float32)
                      for o in (0.3 + 0.05 * h for h in range(1, 24))]
    mask24 = np.zeros((24, 512), bool)
    mask24[:, :n] = True
    valid24 = np.ones(24, bool)
    valid24[-1] = False
    sets["greedy_24"] = (np.stack(insts), mask24, valid24)
    full = np.pad(xyz, pad, constant_values=1e6)
    half_a, half_b = full.copy(), full.copy()
    half_a[n // 2:] = 1e6
    half_b[:n // 2] = 1e6
    mask4 = np.zeros((4, 512), bool)
    mask4[0, :n // 2] = mask4[1, n // 2:n] = True
    mask4[2, :n] = mask4[3, :n] = True
    sets["halves_clutter_full"] = (np.stack([half_a, half_b, full + 0.4, full]),
                                   mask4, np.ones(4, bool))
    # an invalid hypothesis among valid ones: the patterns with its bit set
    # duplicate smaller patterns' costs exactly (ties in every chunk)
    valid4 = np.array([True, False, True, True])
    sets["invalid_bit_ties"] = (sets["halves_clutter_full"][0], mask4, valid4)
    # nine hypotheses: 512 patterns, two chunks of the exhaustive sweep
    nine = np.stack([good + np.float32(0.002 * h) for h in range(3)]
                    + [good + np.float32(0.3 + 0.1 * h) for h in range(6)])
    mask9 = np.zeros((9, 512), bool)
    mask9[:, :n] = True
    valid9 = np.ones(9, bool)
    valid9[4] = False
    sets["nine_two_chunks"] = (nine, mask9, valid9)
    return _clouds(xyz, 512), sets


def test_depth_buffer_and_occlusion_exact(cylinder):
    model, (js, ts) = cylinder
    dj, loj, scj = jhv.scene_depth_buffer(js, bins=64)
    dt, lot, sct = thv.scene_depth_buffer(ts, bins=64)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(lot.numpy(), np.asarray(loj))
    np.testing.assert_array_equal(sct.numpy(), np.asarray(scj))
    filled = dt.numpy()[dt.numpy() < 1e38]
    assert filled.size > 50 and filled.min() > 0.9 and filled.max() < 1.01
    oj = jhv._occluded(jnp.asarray(model), dj, loj, scj, 0.001, 64)
    ot = thv._occluded(_t(model), dt, lot, sct, 0.001, 64)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 100 < int(ot.sum()) < model.shape[0]


@pytest.mark.parametrize("occlusion", [0.0, 0.001])
def test_occlusion_rescues_true_full_model_hypothesis(cylinder, occlusion):
    model, (js, ts) = cylinder
    kw = dict(inlier_threshold=0.005, outlier_regularizer=3.0,
              occlusion_threshold=occlusion)
    pj = jhv.verify_hypotheses(jnp.asarray(model[None]),
                               jnp.ones((1, len(model)), bool),
                               jnp.ones(1, bool), js, **kw)
    pt = thv.verify_hypotheses(_t(model[None]),
                               torch.ones(1, len(model), dtype=torch.bool),
                               torch.ones(1, dtype=torch.bool), ts, **kw)
    assert bool(pt[0]) == bool(pj[0]) == (occlusion > 0.0)


@pytest.mark.parametrize("name", ["real_and_offset", "greedy_24",
                                  "halves_clutter_full", "nine_two_chunks"])
@pytest.mark.parametrize("occlusion", [0.0, 0.001])
def test_explained_matrix_matches(joint, name, occlusion):
    """At most 2 flipped entries per instance (threshold on a distance, see
    the module docstring); the outlier counts move by as many at most."""
    (js, ts), sets = joint
    xyz, mask, _ = sets[name]
    ej, oj = jhv._explained_matrix(jnp.asarray(xyz), jnp.asarray(mask), js,
                                   0.005, 512, occlusion_threshold=occlusion)
    et, ot = thv._explained_matrix(_t(xyz), _t(mask), ts, 0.005,
                                   occlusion_threshold=occlusion)
    assert et.shape == (len(xyz), 512) and ot.shape == (len(xyz),)
    flips = (et.numpy() != np.asarray(ej)).sum(1)
    assert flips.max() <= 2, flips
    assert np.abs(ot.numpy() - np.asarray(oj)).max() <= 2
    assert et[0].sum() > 100


@pytest.mark.parametrize("name", ["real_and_offset", "greedy_24",
                                  "halves_clutter_full", "invalid_bit_ties",
                                  "nine_two_chunks"])
def test_hypothesis_search_exact_on_shared_inputs(joint, name, monkeypatch):
    """Exhaustive (H <= 16) and greedy (H > 16) search: masks equal when
    both packages are fed the JAX package's explained / outliers."""
    (js, ts), sets = joint
    xyz, mask, valid = sets[name]
    ej, oj = jhv._explained_matrix(jnp.asarray(xyz), jnp.asarray(mask), js,
                                   0.005, 512)
    monkeypatch.setattr(jhv, "_explained_matrix", lambda *a, **k: (ej, oj))
    pj = np.asarray(jhv.verify_hypotheses(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(valid), js))
    pt = thv._select_hypotheses(_t(ej), _t(oj), _t(valid), 0.001, 1.0)
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert not pt.numpy()[~valid].any() and pt.numpy().any()
    # both searches on the port's own explained / outliers, end to end
    full = thv.verify_hypotheses(_t(xyz), _t(mask), _t(valid), ts)
    np.testing.assert_array_equal(full.numpy(), pj)
    if len(xyz) <= 16:      # greedy lands on the exhaustive optimum here
        ex = _t(ej) & _t(valid)[:, None]
        out = torch.where(_t(valid), _t(oj), float("inf"))
        g = thv._greedy_verify(ex, out, _t(valid), 0.001, 1.0)
        gj = jhv._greedy_verify(ej & jnp.asarray(valid)[:, None],
                                jnp.where(jnp.asarray(valid), oj, jnp.inf),
                                jnp.asarray(valid), 0.001, 1.0)
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))


@pytest.fixture(scope="module")
def two_objects():
    rng = np.random.default_rng(0)
    xyz, _ = joint_points(rng, n_chord=400, n_stub=250)
    other = xyz + np.array([1.5, 0.0, 0.0], np.float32)
    T_shift = np.eye(4, dtype=np.float32)
    T_shift[:3, 3] = [0.0, 0.12, 0.0]
    T_rot = np.eye(4, dtype=np.float32)
    a = np.radians(7.0)
    T_rot[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]
    T_rot[:3, 3] = [0.01, -0.02, 0.015]
    Ts = np.stack([np.eye(4, dtype=np.float32), T_shift, T_rot])
    return xyz, _clouds(np.concatenate([xyz, other]), 2048), Ts


@pytest.mark.parametrize("local", [False, True])
def test_scene_coverage_multi_matches(two_objects, local):
    xyz, (js, ts), Ts = two_objects
    mask = np.ones(len(xyz), bool)
    cj, uj = jicp.scene_coverage_multi(js, jnp.asarray(xyz), jnp.asarray(mask),
                                       jnp.asarray(Ts), chunk=512, local=local)
    ct, ut = ticp.scene_coverage_multi(ts, _t(xyz), _t(mask), _t(Ts),
                                       local=local)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-7)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-6)
    if local:
        assert float(ut[0]) < 0.01 and float(ut[1]) > 0.1
    else:
        assert float(ut[0]) > 0.4


def test_scene_coverage_batched_scene_equals_per_frame(two_objects):
    """Two frames' scenes stacked, three poses each: equal to the two
    per-frame calls (1e-7)."""
    xyz, (_, ts), Ts = two_objects
    rng = np.random.default_rng(1)
    other = ts._replace(
        xyz=ts.xyz + _t(rng.normal(scale=1e-3, size=ts.xyz.shape).astype(
            np.float32)) * ts.mask[:, None],
        mask=ts.mask & _t(rng.uniform(size=2048) > 0.1))
    both = type(ts)(*(torch.stack(f) for f in zip(ts, other)))
    mask = torch.ones(len(xyz), dtype=torch.bool)
    T2 = _t(np.concatenate([Ts, Ts[::-1]]))
    for local in (False, True):
        cb, ub = ticp.scene_coverage_multi(both, _t(xyz), mask, T2, local=local)
        for b, scene in enumerate((ts, other)):
            c1, u1 = ticp.scene_coverage_multi(scene, _t(xyz), mask,
                                               T2[3 * b:3 * b + 3], local=local)
            np.testing.assert_allclose(cb[3 * b:3 * b + 3].numpy(), c1.numpy(),
                                       atol=1e-7)
            np.testing.assert_allclose(ub[3 * b:3 * b + 3].numpy(), u1.numpy(),
                                       atol=1e-7)


def test_fitness_multi_and_score_match(two_objects):
    xyz, (js, ts), Ts = two_objects
    mask = np.ones(len(xyz), bool)
    mask[::7] = False
    fj = jicp.fitness_multi(jnp.asarray(xyz), jnp.asarray(mask), js,
                            jnp.asarray(Ts), chunk=512)
    ft = ticp.fitness_multi(_t(xyz), _t(mask), ts, _t(Ts))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-6)
    assert float(ft[0]) < 1e-9 < float(ft[1])
    jm, tm = _clouds(xyz, 1024)
    for T, max_range in ((Ts[1], 3.0e38), (Ts[2], 0.05)):
        sj = jicp.fitness_score(jm, js, jnp.asarray(T), max_range=max_range,
                                chunk=512)
        st = ticp.fitness_score(tm, ts, _t(T), max_range=max_range)
        np.testing.assert_allclose(float(st), float(sj), atol=1e-6)
        assert float(st) > 1e-6


@pytest.mark.parametrize("kw", [dict(iterations=10, max_corr_dist=0.02),
                                dict(iterations=6, max_corr_dist=0.02,
                                     max_corr_start=0.1),
                                dict(iterations=4)])
def test_icp_matches(kw):
    """``tests/test_recognize.py``'s outlier-rejection problem: the shift is
    recovered, pose within 1e-5 and fitness within 1e-6 of the JAX
    package's."""
    rng = np.random.default_rng(0)
    xyz, _ = joint_points(rng, n_chord=300, n_stub=200)
    scene_pts = np.concatenate([xyz + [0.005, 0, 0], rng.uniform(
        -2, 2, (300, 3))]).astype(np.float32)
    jm, tm = _clouds(xyz, 1024)
    js, ts = _clouds(scene_pts, 1024)
    Tj, fj = jicp.icp(jm, js, jnp.eye(4), chunk=512, **kw)
    Tt, ft = ticp.icp(tm, ts, torch.eye(4), **kw)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    np.testing.assert_allclose(float(ft), float(fj), atol=1e-6)
    if "max_corr_dist" in kw:
        np.testing.assert_allclose(Tt.numpy()[:3, 3], [0.005, 0, 0], atol=1e-3)
