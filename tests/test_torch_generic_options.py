"""Port parity, the generic ``detect()`` path's remaining options and
utilities: anchored normals (kernels K2 and K1), pass-through and voxel
downsampling, ISS keypoints, the voxel-lattice region growing, GC grouping,
SHOT's "pcl" scheme, organized normals, the cloud and transform helpers and
``gather_views`` — JAX package vs port on the CPU, same inputs — and
``detect()`` end to end with each option.

Scale: the generic path's small problem of ``tests/test_torch_generic.py``
(the 320×240 bench frame's points strided to 3072, 256 keys, the
``synthetic.generic_config`` chain at scene_ss 0.03) on a level-0 SHOT bank
built by the port and handed to the JAX package as the same arrays.

Tolerances. Masks, labels, sizes, indices, flags and counts equal. Anchored
normals within 1e-4 of the JAX package's own ``_normals_from_neighborhoods``
on ``knn_pallas(interpret=True)``'s neighbours (the kernels' difference
form; XLA's CPU expansion can order a k-th neighbour differently, ROADMAP
queue 3). GC poses within 1e-4 (``umeyama`` solves Kabsch without an SVD).
SHOT "pcl" within 2e-5 of the golden file (the JAX test's), 1e-5 of JAX.
Organized normals 1e-5. End to end: candidate views, accept flag and counts
equal; an accepted pose within 5e-4 of JAX's and 1° / 5 mm of the truth.
"""
import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_joints.config import DetectionConfig
from tpu_joints.core import cloud as jcloud
from tpu_joints.core import transforms as jtr
from tpu_joints.features import normals as jnormals
from tpu_joints.features import organized as jorganized
from tpu_joints.features import shot as jshot
from tpu_joints.features.iss import iss_keypoints as jiss
from tpu_joints.filters import filters as jfilters
from tpu_joints.modelbank.bank import ModelBank as JModelBank
from tpu_joints.modelbank.bank import gather_views as jgather_views
from tpu_joints.neighbors import knn as jknn
from tpu_joints.neighbors.pallas_knn import knn_pallas
from tpu_joints.recognize.gc import gc_group as jgc_group
from tpu_joints.recognize.matching import Correspondences as JCorr
from tpu_joints.segment.voxel import region_growing_voxel as jvoxel
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core import cloud as tcloud
from tpu_joints_torch.core import transforms as ttr
from tpu_joints_torch.features import normals as tnormals
from tpu_joints_torch.features import organized as torganized
from tpu_joints_torch.features import shot as tshot
from tpu_joints_torch.features.iss import iss_keypoints
from tpu_joints_torch.filters import filters as tfilters
from tpu_joints_torch.modelbank import bank as tbank
from tpu_joints_torch.neighbors import pallas_knn as pk
from tpu_joints_torch.neighbors.bruteforce import knn
from tpu_joints_torch.recognize.gc import gc_group
from tpu_joints_torch.recognize.matching import Correspondences
from tpu_joints_torch.segment import voxel as tvoxel

jdet = importlib.import_module("tpu_joints.pipelines.detect")
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "descriptors.npz")
CAPACITY = 3072


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(cloud):
    return jcloud.Cloud(*(jnp.asarray(t.numpy()) for t in cloud))


@pytest.fixture(scope="module")
def problem():
    """(port bank, the same arrays as a JAX bank, port scene, JAX scene,
    T_gt, port cfg)."""
    tb = tbank.build_bank(
        syn.joint_model(3000, 1800), descriptor="shot", descr_radius=0.06,
        rf_radius=0.06, rf_k_max=96, frames="board", sampling_radius=0.02,
        normal_k=16, k_max=96, level=0, resolution=64, surface_leaf=0.01,
        key_capacity=64, icp_capacity=1024, device="cpu")
    arrays = tb.to_numpy()
    jb = JModelBank(**{k: jnp.asarray(arrays[k]) for k in ARRAYS},
                    params_hash=tb.params_hash)
    T_gt = syn.bench_pose()
    xyz, valid = syn.frame(T_gt, 42, with_table=False, width=320, height=240)
    scene = tcloud.make_cloud(syn.scene_points(xyz[valid], CAPACITY),
                              capacity=CAPACITY, device="cpu")
    cfg = dataclasses.replace(
        syn.generic_config(), scene_ss=0.03, final_icp_iterations=8,
        scene_capacity=CAPACITY, scene_key_capacity=256)
    return tb, jb, scene, _j(scene), T_gt, cfg


@pytest.fixture(scope="module")
def normals(problem):
    """The port's k = 16 normals of the scene, fed to both packages where a
    stage takes normals."""
    scene = problem[2]
    return tdet.estimate_normals(scene, k=16)


def test_anchored_normals_match(problem):
    """``estimate_normals_anchored`` (1024 anchors of 3072 lanes): the
    anchor lanes equal ``jnp.linspace``'s; normals and curvature within
    1e-4 of the JAX package's ``_normals_from_neighborhoods`` on
    ``knn_pallas(interpret=True)``'s anchor neighbours and nearest anchor;
    on the CPU no kernel launches. ``anchors >= capacity`` is
    ``estimate_normals`` bit for bit."""
    scene, js = problem[2], problem[3]
    N, A = CAPACITY, 1024
    a_idx = np.asarray(jnp.linspace(0, N - 1, A).astype(jnp.int32))
    for n, a in ((N, A), (2560, 1024), (2560, 512), (8192, 4096),
                 (65536, 8192), (307200, 2048), (100, 1)):
        np.testing.assert_array_equal(
            tnormals.anchor_lanes(n, a).numpy(),
            np.asarray(jnp.linspace(0, n - 1, a).astype(jnp.int32)))
    before = (pk.nn1.launches, pk.knnk.launches)
    nt, ct = tnormals.estimate_normals_anchored(scene, k=16, anchors=A)
    assert (pk.nn1.launches, pk.knnk.launches) == before
    a_xyz, a_mask = js.xyz[a_idx], js.mask[a_idx]
    d, idx = knn_pallas(a_xyz, js.xyz, 16, source_mask=js.mask, tm=256,
                        tn=1024, interpret=True)
    an, ac = jnormals._normals_from_neighborhoods(
        js.xyz, idx, (d < 1e30) & a_mask[:, None], a_mask,
        jnp.zeros(3, jnp.float32), query_xyz=a_xyz)
    d1, nn = knn_pallas(js.xyz, a_xyz, 1, source_mask=a_mask, tm=256,
                        tn=1024, interpret=True)
    ok = np.asarray(js.mask & (d1[:, 0] < 1e30))
    want_n = np.where(ok[:, None], np.asarray(an)[np.asarray(nn[:, 0])], 0.0)
    want_c = np.where(ok, np.asarray(ac)[np.asarray(nn[:, 0])], 0.0)
    np.testing.assert_allclose(nt.numpy(), want_n, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct.numpy(), want_c, rtol=0, atol=1e-4)
    full = tnormals.estimate_normals_anchored(scene, k=16, anchors=N)
    for a, b in zip(full, tdet.estimate_normals(scene, k=16)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("axis,lo,hi", [("x", -0.1, 0.05), ("z", 0.9, 1.1)])
def test_passthrough_matches(problem, axis, lo, hi):
    scene, js = problem[2], problem[3]
    got = tfilters.passthrough(scene, axis, lo, hi)
    want = jfilters.passthrough(js, axis, lo, hi)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert 0 < int(got.mask.sum()) < int(scene.mask.sum())


@pytest.mark.parametrize("leaf", [0.01, 0.04])
def test_voxel_downsample_matches(problem, leaf):
    """Centroids in voxel-id order: mask equal, xyz and rgb equal bit for
    bit (in-order segment sums)."""
    scene, js = problem[2], problem[3]
    got = tfilters.voxel_downsample(scene, leaf)
    want = jfilters.voxel_downsample(js, leaf)
    for f in ("mask", "xyz", "rgb"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert 0 < int(got.mask.sum()) < int(scene.mask.sum())


def test_iss_keypoints_match(problem):
    """ISS at the pipeline's radii (3 and 2 × scene_ss, k_max 96): the
    keypoint mask equal."""
    scene, js = problem[2], problem[3]
    got = iss_keypoints(scene, salient_radius=0.09, non_max_radius=0.06,
                        k_max=96)
    want = jiss(js, salient_radius=0.09, non_max_radius=0.06, k_max=96)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 10 < int(got.sum()) < 1000


@pytest.mark.parametrize("leaf", [0.04, 0.06])
def test_region_growing_voxel_matches(problem, normals, leaf):
    """Labels and sizes equal (the port reads the change flag once per 8
    sweeps, then stops; a finished labelling is a fixed point, so the extra
    sweeps change nothing)."""
    scene, js = problem[2], problem[3]
    n, c = normals
    before = tvoxel.region_growing_voxel.host_checks
    got = tvoxel.region_growing_voxel(scene, n, c, leaf=leaf, grid=64,
                                      smoothness_deg=12.0, min_cluster_size=50)
    reads = tvoxel.region_growing_voxel.host_checks - before
    want = jvoxel(js, jnp.asarray(n.numpy()), jnp.asarray(c.numpy()),
                  leaf=leaf, grid=64, smoothness_deg=12.0,
                  min_cluster_size=50)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    assert (got.labels.numpy() >= 0).sum() > 1000
    assert 1 <= reads <= 4


def _gc_problem(seed):
    """Three views of 40 model keys; 48 scene correspondences each: 20 of a
    rigid copy (4 of them noisy), the rest spam; distances ranked so that
    some spam ranks first."""
    rng = np.random.default_rng(seed)
    V, Nm, M = 3, 40, 48
    model = rng.uniform(-0.1, 0.1, (V, Nm, 3)).astype(np.float32)
    mask = rng.uniform(size=(V, Nm)) > 0.05
    ang = rng.uniform(0, np.pi)
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]], np.float32)
    mi = rng.integers(0, Nm, (V, M)).astype(np.int32)
    scene = rng.uniform(-0.2, 0.2, (M, 3)).astype(np.float32)
    true_m = np.arange(20)
    scene[true_m] = model[0, mi[0, true_m]] @ R.T + np.float32([0.3, 0.1, 1.0])
    scene[:4] += rng.normal(0, 0.004, (4, 3)).astype(np.float32)
    valid = rng.uniform(size=(V, M)) > 0.1
    dist = rng.uniform(0, 0.3, (V, M)).astype(np.float32)
    return scene, model, mask, mi, valid, dist


@pytest.mark.parametrize("seed", [0, 1])
def test_gc_group_matches(seed):
    """GC over three views (``jax.vmap`` of the JAX function against the
    port's view axis): valid flags, counts and memberships equal, poses of
    valid instances within 1e-4."""
    import jax

    scene, model, mask, mi, valid, dist = _gc_problem(seed)
    kw = dict(gc_size=0.01, gc_threshold=5.0, max_instances=4)
    want = jax.vmap(lambda m, mm, i, v, d: jgc_group(
        jnp.asarray(scene), m, mm, JCorr(model_idx=i, valid=v, dist_sq=d),
        **kw))(*(jnp.asarray(a) for a in (model, mask, mi, valid, dist)))
    got = gc_group(_t(scene), _t(model), _t(mask),
                   Correspondences(model_idx=_t(mi), valid=_t(valid),
                                   dist_sq=_t(dist)), **kw)
    for f in ("valid", "n_corrs", "votes", "membership"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    ok = np.asarray(want.valid)
    assert ok[0].any()
    np.testing.assert_allclose(got.poses.numpy()[ok],
                               np.asarray(want.poses)[ok], rtol=0, atol=1e-4)


def _golden_shot(xyz, normals, key_idx, radius, make):
    keys = make(xyz[key_idx], capacity=16)
    surface = make(xyz, capacity=512)
    nrm = np.pad(normals, ((0, 512 - xyz.shape[0]), (0, 0)))
    return keys, surface, nrm


def test_shot_pcl_matches_golden_and_jax():
    """SHOT's "pcl" scheme on the golden cloud: within 2e-5 of
    ``tests/golden/descriptors.npz`` (the JAX test's tolerance) and within
    1e-5 of the JAX package's; ``shot_histograms`` dispatches on the
    scheme and refuses an unknown one."""
    g = np.load(GOLDEN)
    n = g["key_idx"].shape[0]
    r = float(g["radius_shot"])
    keys, surface, nrm = _golden_shot(
        g["xyz"], g["normals"], g["key_idx"], r,
        lambda a, capacity: tcloud.make_cloud(a, capacity=capacity,
                                              device="cpu"))
    desc, _, valid = tshot.compute_shot(keys, surface, _t(nrm), radius=r,
                                        k_max=256, scheme="pcl")
    assert bool(valid[:n].all())
    np.testing.assert_allclose(desc.numpy()[:n], g["shot"], atol=2e-5)
    jd, _, _ = jshot.compute_shot(_j(keys), _j(surface), jnp.asarray(nrm),
                                  radius=r, k_max=256, scheme="pcl")
    np.testing.assert_allclose(desc.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="scheme"):
        tshot.shot_histograms(*(torch.zeros(1, 3),) * 2, None, None, None,
                              r, scheme="nope")


def test_estimate_normals_organized_matches():
    """Organized normals of the 320×240 table frame: normals and curvature
    within 1e-5."""
    xyz, valid = syn.frame(syn.bench_pose(), 42, with_table=True, width=320,
                           height=240)
    nj, cj = jorganized.estimate_normals_organized(jnp.asarray(xyz),
                                                   jnp.asarray(valid), 3)
    nt, ct = torganized.estimate_normals_organized(_t(xyz), _t(valid), 3)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    assert (np.linalg.norm(nt.numpy(), axis=-1) > 0.99).sum() > 0.8 * valid.sum()


@pytest.mark.parametrize("what", ["transform_cloud", "cloud_resolution",
                                  "pad_cloud", "to_numpy", "gather_views"])
def test_utilities_match(problem, what):
    """The small helpers: ``transform_cloud`` within 1e-6, the resolution
    (``knn(k=1, exclude_self=True)``: indices equal) within 1e-7,
    ``pad_cloud``, ``to_numpy`` and ``gather_views`` equal."""
    tb, jb, scene, js, T_gt, _ = problem
    if what == "transform_cloud":
        moved = scene.with_mask(scene.mask & (scene.xyz[:, 0] > 0))
        got = ttr.transform_cloud(moved, _t(T_gt))
        want = jtr.transform_cloud(_j(moved), jnp.asarray(T_gt))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                                   rtol=0, atol=1e-6)
    elif what == "cloud_resolution":
        dt, it = knn(scene.xyz, scene.xyz, 1, source_mask=scene.mask,
                     exclude_self=True)
        dj, ij = jknn(js.xyz, js.xyz, 1, source_mask=js.mask,
                      exclude_self=True)
        m = scene.mask.numpy()
        np.testing.assert_array_equal(it.numpy()[m], np.asarray(ij)[m])
        got = ttr.cloud_resolution(scene.xyz, scene.mask, dt[:, 0])
        want = jtr.cloud_resolution(js.xyz, js.mask, dj[:, 0])
        assert float(got) == pytest.approx(float(want), abs=1e-7)
        assert 0.001 < float(got) < 0.02
    elif what == "pad_cloud":
        got = tcloud.pad_cloud(scene, 4096)
        want = jcloud.pad_cloud(js, 4096)
        for f in ("xyz", "mask", "rgb"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        assert tcloud.pad_cloud(scene, CAPACITY) is scene
        with pytest.raises(ValueError, match="shrink"):
            tcloud.pad_cloud(scene, 16)
    elif what == "to_numpy":
        np.testing.assert_array_equal(tcloud.to_numpy(scene),
                                      jcloud.to_numpy(js))
    else:
        idx = [7, 0, 3]
        got = tbank.gather_views(tb, idx)
        want = jgather_views(jb, jnp.asarray(idx))
        for f in ARRAYS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert got.n_views == 3 and got.params_hash == tb.params_hash


@pytest.mark.parametrize("option", [
    {"algorithm": "gc"},
    {"keypoints": "iss"},
    {"rg_backend": "voxel"},
    {"normal_anchors": 1024},
])
def test_detect_option_matches(problem, option):
    """``detect()`` on the small generic cloud with one option: the
    candidate views, accept flag and stage counts equal the JAX package's;
    an accepted pose within 5e-4 of JAX's and within 1° / 5 mm of the
    truth. GC grouping, the voxel crop and the anchored normals are
    accepted in both packages here; ISS at the pipeline's radii (3 and 2 ×
    scene_ss) keeps 18 keys of this sparse cloud and both reject
    (measured)."""
    tb, jb, scene, js, T_gt, cfg = problem
    tcfg = dataclasses.replace(cfg, **option)
    jcfg = DetectionConfig(**dataclasses.asdict(tcfg))
    rj = jdet.detect(js, jb, jcfg)
    rt = tdet.detect(scene, tb, tcfg)
    np.testing.assert_array_equal(rt.cand_views.numpy(),
                                  np.asarray(rj.cand_views))
    assert bool(rt.accepted) == bool(rj.accepted)
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k
    assert bool(rt.accepted) == ("keypoints" not in option)
    if bool(rj.accepted):
        np.testing.assert_allclose(rt.full_pose.numpy(),
                                   np.asarray(rj.full_pose), rtol=0, atol=5e-4)
        P = rt.full_pose.numpy()
        Rd = P[:3, :3] @ T_gt[:3, :3].T
        assert np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1))) < 1.0
        assert np.linalg.norm(P[:3, 3] - T_gt[:3, 3]) < 0.005
