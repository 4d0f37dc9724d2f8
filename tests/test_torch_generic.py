"""Port parity, the generic ``detect`` path: an unorganized scene cloud
through kNN normals (kernel K2), the region-growing crop (K2 graph), ratio
matching, Hough, two-tier ICP (K1) and the clustered OBB (K2) — JAX package
vs port on the CPU, same inputs — plus the entry points' device rules.

Scale: the level-0 bank of ``tests/test_torch_detect.py`` (12 views at
64 px) and a 320×240 frame of the bench joint, its valid points strided to
3072 by the CLI's scene recipe; the configuration is the port's full-size
generic one (``synthetic.generic_config``) at the small sizes that
``tests/test_torch_detect.py`` uses (scene_ss 0.03, 256 keys).
"""
import argparse
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.level0_bank import level0_jax_bank
from tpu_joints.cli.main import _detect_one
from tpu_joints.config import DetectionConfig
from tpu_joints.core.cloud import Cloud as JCloud
from tpu_joints.features import normals as jnormals
from tpu_joints.modelbank.bank import build_bank as jbuild_bank
from tpu_joints.neighbors.pallas_knn import knn_pallas
from tpu_joints.recognize import matching as jmatch
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.core import cloud as tcloud
from tpu_joints_torch.modelbank import bank as tbank
from tpu_joints_torch.neighbors import pallas_knn as pk
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.recognize import matching as tmatch

BANK_KW = dict(descriptor="shot", descr_radius=0.06, rf_radius=0.06,
               rf_k_max=96, frames="board", sampling_radius=0.02, normal_k=16,
               k_max=96, level=0, resolution=64, surface_leaf=0.01,
               key_capacity=64, icp_capacity=1024)
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
CAPACITY = 3072
# the package's __init__ re-exports a function named like this module
jdet = importlib.import_module("tpu_joints.pipelines.detect")


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(T, G):
    Rd = T[:3, :3] @ G[:3, :3].T
    return (float(np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1)))),
            float(np.linalg.norm(T[:3, 3] - G[:3, 3])))


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """(JAX bank, port bank, frame points, T_gt, cfgs, JAX CLI run)."""
    jb = level0_jax_bank(tmp_path_factory)
    tb = tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")
    T_gt = syn.bench_pose()
    xyz, valid = syn.frame(T_gt, 42, with_table=False, width=320, height=240)
    pts = xyz[valid]
    tcfg = dataclasses.replace(
        syn.generic_config(), scene_ss=0.03, final_icp_iterations=8,
        scene_capacity=CAPACITY, scene_key_capacity=256)
    jcfg = DetectionConfig(**dataclasses.asdict(tcfg))
    path = str(tmp_path_factory.mktemp("scene") / "scene.npy")
    np.save(path, pts)
    jscene, _, jres = _detect_one(
        path, {"model": jb}, jcfg,
        argparse.Namespace(use_resolution=False, tree=0))
    return jb, tb, pts, T_gt, jcfg, tcfg, jscene, jres


@pytest.fixture(scope="module")
def scene(problem):
    _, _, pts, _, _, _, _, _ = problem
    return tcloud.make_cloud(syn.scene_points(pts, CAPACITY),
                             capacity=CAPACITY, device="cpu")


@pytest.fixture(scope="module")
def kernel_normals(scene):
    """The JAX package's k = 16 normals and curvature on its own kernel's
    neighbours (``knn_pallas`` in interpret mode: the path it takes on its
    device, in the difference form K2 keeps)."""
    xyz, mask = jnp.asarray(scene.xyz.numpy()), jnp.asarray(scene.mask.numpy())
    d, idx = knn_pallas(xyz, xyz, 16, source_mask=mask, tm=256, tn=1024,
                        interpret=True)
    return jnormals._normals_from_neighborhoods(
        xyz, idx, (d < 1e30) & mask[:, None], mask, jnp.zeros(3, jnp.float32))


@pytest.fixture(scope="module")
def features(problem, scene, kernel_normals):
    """Scene features: the JAX package's ``prepare_scene`` from the kernel
    path's normals, the port's from its own estimate (K2)."""
    _, _, _, _, jcfg, tcfg, jscene, _ = problem
    fj = jdet._prepare_jit(jscene, jcfg, None, *kernel_normals)
    return fj, tdet.prepare_scene(scene, tcfg)


def test_scene_recipe_matches_cli(problem, scene):
    """``synthetic.scene_points`` + ``make_cloud`` give the CLI's cloud."""
    jscene = problem[6]
    for f in ("xyz", "mask", "rgb"):
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(jscene, f)))
    assert int(scene.mask.sum()) == CAPACITY


def test_scene_normals_match(scene, kernel_normals):
    """The port's k = 16 normals and curvature (K2's plain version) within
    1e-4 of the JAX package's on its kernel's neighbours, at every point.

    The JAX package's CPU path (XLA) expands |q|²+|s|²−2q·s instead, whose
    rounding at 1 m depth (|q|² ≈ 1, absolute error ~1e-7 m²) is a few 1e-4
    of a 16th-neighbour distance at this 1 cm spacing, so there a 16th and
    17th neighbour can trade places: against it 8 of 3072 normals differ
    beyond 1e-4 (measured, up to 0.026; the relative gaps between the 16th
    and 17th distances at those points are 8e-5 to 1.5e-3)."""
    n, curv = tdet.estimate_normals(scene, k=16)
    np.testing.assert_allclose(n.numpy(), np.asarray(kernel_normals[0]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(curv.numpy(), np.asarray(kernel_normals[1]),
                               rtol=0, atol=1e-4)
    nx, _ = jnormals.estimate_normals(
        JCloud(*(jnp.asarray(t.numpy()) for t in scene)), k=16,
        allow_pallas=False)
    off = np.abs(n.numpy() - np.asarray(nx)).max(-1) > 1e-4
    assert off.sum() <= 8, off.sum()


def test_prepare_scene_unorganized_matches(features):
    """From the same normals, the crop (region growing + curvature filter)
    and the keypoints are exact; normals, SHOT descriptors and BOARD frames
    within 1e-4 where defined, validity equal."""
    fj, ft = features
    mask = np.asarray(fj.cloud.mask)
    np.testing.assert_array_equal(ft.cloud.mask.numpy(), mask)
    assert 0 < mask.sum() < CAPACITY            # the crop removed something
    np.testing.assert_array_equal(ft.cloud.xyz.numpy(), np.asarray(fj.cloud.xyz))
    np.testing.assert_allclose(ft.normals.numpy(), np.asarray(fj.normals),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ft.keys.xyz.numpy(), np.asarray(fj.keys.xyz))
    dv = np.asarray(fj.desc_valid)
    assert dv.sum() > 50
    np.testing.assert_array_equal(ft.desc_valid.numpy(), dv)
    np.testing.assert_allclose(ft.desc.numpy()[dv], np.asarray(fj.desc)[dv],
                               rtol=0, atol=1e-4)
    ok = np.asarray(fj.rf_ok)
    np.testing.assert_array_equal(ft.rf_ok.numpy(), ok)
    np.testing.assert_allclose(ft.rf.numpy()[ok], np.asarray(fj.rf)[ok],
                               rtol=0, atol=1e-4)


def test_match_bank_ratio_matches(problem, features):
    """The ratio gate at τ = 1 over the two nearest bank keypoints per view
    (``lax.top_k`` order): flags and indices equal, distances within 1e-5."""
    jb, tb, _, _, jcfg, tcfg, _, _ = problem
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


@pytest.mark.parametrize("ratio", [1.0, 0.9])
def test_match_nn_and_ratio_match(ratio):
    """``match_nn`` / ``match_ratio`` on 352-D descriptors (the sort path):
    flags and indices equal, distances within rtol 1e-5."""
    rng = np.random.default_rng(int(ratio * 10))
    sd = rng.normal(size=(120, 352)).astype(np.float32) * 0.05
    md = rng.normal(size=(300, 352)).astype(np.float32) * 0.05
    sv, mv = rng.uniform(size=120) > 0.1, rng.uniform(size=300) > 0.2
    # half the scene descriptors are noisy copies of model descriptors
    sd[:60] = md[rng.choice(300, 60)] + rng.normal(
        size=(60, 352)).astype(np.float32) * 0.02
    pairs = [(jmatch.match_nn(jnp.asarray(sd), jnp.asarray(sv), jnp.asarray(md),
                              jnp.asarray(mv), max_dist_sq=0.5),
              tmatch.match_nn(_t(sd), _t(sv), _t(md), _t(mv), max_dist_sq=0.5)),
             (jmatch.match_ratio(jnp.asarray(sd), jnp.asarray(sv),
                                 jnp.asarray(md), jnp.asarray(mv), ratio=ratio),
              tmatch.match_ratio(_t(sd), _t(sv), _t(md), _t(mv), ratio=ratio))]
    for cj, ct in pairs:
        v = np.asarray(cj.valid)
        assert 0 < v.sum() < 120
        np.testing.assert_array_equal(ct.valid.numpy(), v)
        np.testing.assert_array_equal(ct.model_idx.numpy(), np.asarray(cj.model_idx))
        np.testing.assert_allclose(ct.dist_sq.numpy(), np.asarray(cj.dist_sq),
                                   rtol=1e-5)


def test_detect_end_to_end(problem, scene):
    """The port's ``detect`` against the JAX CLI's: same candidate views,
    winning view and accept flag, full_pose within 5e-4 (as the organized
    path's test), OBB of the largest cluster within 1e-3; both within
    1°/5 mm of the ground truth. On the CPU the wrappers take their plain
    versions, so no kernel launches."""
    _, tb, _, T_gt, _, tcfg, _, rj = problem
    before = (pk.nn1.launches, pk.knnk.launches)
    rt = tdet.detect(scene, tb, tcfg)
    assert (pk.nn1.launches, pk.knnk.launches) == before
    np.testing.assert_array_equal(rt.cand_views.numpy(), np.asarray(rj.cand_views))
    assert int(rt.view_idx) == int(rj.view_idx)
    assert bool(rt.accepted) == bool(rj.accepted)
    np.testing.assert_allclose(rt.full_pose.numpy(), np.asarray(rj.full_pose),
                               rtol=0, atol=5e-4)
    for f in ("position", "extents", "centroid"):
        np.testing.assert_allclose(getattr(rt.obb, f).numpy(),
                                   np.asarray(getattr(rj.obb, f)), rtol=0,
                                   atol=1e-3, err_msg=f)
    for pose in (rt.full_pose.numpy(), np.asarray(rj.full_pose)):
        rot, trans = _err(pose, T_gt)
        assert rot < 1.0 and trans < 0.005, (rot, trans)
    assert bool(rt.accepted)
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert int(rt.metrics[k]) == int(rj.metrics[k]), k


def test_entry_points_need_a_card(monkeypatch, problem, tmp_path):
    """Without a card the entry points raise unless given device="cpu";
    they never carry on on the CPU by themselves."""
    jb = problem[0]
    arrays = {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
    np.savez(tmp_path / "bank.npz", **arrays)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcloud.make_cloud(pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbank.bank_from_numpy(arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbank.load_bank(str(tmp_path / "bank.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbank.build_bank(syn.joint_model(300, 200), **BANK_KW)
    assert tcloud.make_cloud(pts, device="cpu").xyz.device.type == "cpu"
    assert tbank.load_bank(str(tmp_path / "bank.npz"),
                           device="cpu").device.type == "cpu"


def test_detect_rejects_foreign_devices_and_unported_options(problem, scene):
    _, tb, _, _, _, tcfg, _, _ = problem
    with pytest.raises(ValueError, match="bank on cpu"):
        tdet.detect(scene, tb, tcfg, viewpoint=torch.zeros(3, device="meta"))
    # lattice keys need the organized front end, as in the JAX package
    with pytest.raises(ValueError, match="organized front end"):
        tdet.prepare_scene(scene, dataclasses.replace(tcfg, keypoints="lattice"))
    # the voxel region growing, ISS keypoints and radius normals are ported
    # (their parity: tests/test_torch_generic_options.py, test_torch_fpfh.py)
    for kw in ({"rg_backend": "voxel"}, {"keypoints": "iss"},
               {"normal_radius": 0.1}):
        feats = tdet.prepare_scene(scene, dataclasses.replace(tcfg, **kw))
        assert bool((feats.cloud.mask <= scene.mask).all()), kw
        assert bool((feats.keys.mask.sum() > 0)), kw
    for kw, exc in (({"rg_backend": "lattice"}, "rg_backend"),
                    ({"descriptor": "spin"}, "descriptor")):
        with pytest.raises(ValueError, match=exc):
            tdet.prepare_scene(scene, dataclasses.replace(tcfg, **kw))
    # the plane removal is ported: the option runs and only ever drops points
    feats = tdet.prepare_scene(scene, dataclasses.replace(
        tcfg, remove_plane=True, segment_scene=False))
    assert bool((feats.cloud.mask <= scene.mask).all())
    assert tdet._strip_crop(tcfg) == dataclasses.replace(
        tcfg, segment_scene=False, remove_plane=False)
    assert tconfig.from_dict(dataclasses.asdict(tcfg)) == tcfg


def full_size_reference() -> None:
    """The JAX package's own ``detect`` on the generic path's full-size
    cloud and configuration (``synthetic.generic_config``, the 42-view
    bench bank, a 640×480 frame's points strided to 2560), on the CPU:
    prints the gate numbers the port's run on the card is held to. The
    bank build takes tens of minutes on a CPU, so this is no test; run it
    as ``JAX_PLATFORMS=cpu python -m tests.test_torch_generic``."""
    cfg = syn.generic_config()
    jb = jbuild_bank(syn.joint_model(), **syn.bench_bank_kwargs(cfg))
    T_gt = syn.bench_pose()
    xyz, valid = syn.frame(T_gt, 42, with_table=False)
    from tpu_joints.core.cloud import make_cloud

    scene = make_cloud(syn.scene_points(xyz[valid], cfg.scene_capacity),
                       capacity=cfg.scene_capacity)
    res = jdet.detect(scene, jb, DetectionConfig(**dataclasses.asdict(cfg)))
    rot, trans = _err(np.asarray(res.full_pose), T_gt)
    print(f"JAX detect, full size: accepted {bool(res.accepted)}, view "
          f"{int(res.view_idx)}, rot_err {rot:.3f} deg, trans_err "
          f"{trans * 1000:.3f} mm, scene points after the crop "
          f"{int(res.metrics['scene_points'])} of {cfg.scene_capacity}")


if __name__ == "__main__":
    full_size_reference()
