"""Port parity, the distributed batch and the mesh server:
``distributed.detect_batch`` in both of the JAX package's call forms,
``shard_inputs``, ``detect._group_views_arrays`` on a view shard, the
mesh ``DetectionService`` and ``serve --devices``, on an 8-entry CPU mesh
(``[torch.device("cpu")] * 8``) against the JAX package on the suite's
virtual 8-CPU mesh and against the port's single-device paths.

The problem is ``tests/test_distributed.py``'s: its configuration, its
level-0 bank of the synthetic joint (built by the JAX package, carried to
the port as the same arrays) and its four rendered views as scenes.

Tolerances. ``detect_batch`` against the port's own ``detect`` per scene:
views equal, poses rtol 1e-4 / atol 1e-5, fitness rtol 1e-4 / atol 1e-8
(JAX's test, batch against single); the two call forms against each
other: views equal, poses rtol 1e-4 / atol 2e-5, candidate fitness rtol
2e-4 / atol 1e-9 (JAX's test, GSPMD against shard_map); the serial form
bit-equal to ``detect``. Against JAX's sharded batch: views and accept
flags equal, poses within 5e-4 (the single-frame parity tolerance of
``tests/test_torch_detect.py``: the two packages' nearest neighbours and
products round differently). The grouping on a view shard against JAX's:
valid flags, correspondence counts and memberships equal, votes within
1e-5 (``tests/test_torch_detect.py::test_hough_group_matches``). The mesh
server against the single-device service: accept flag and view equal,
within 0.5 deg / 3 mm (``tests/test_serve.py``).
"""
import concurrent.futures
import dataclasses
import importlib
import threading

import numpy as np
import pytest
import torch

from tests.util import joint_points
from tpu_joints.config import DetectionConfig
from tpu_joints.core.cloud import make_cloud as jmake_cloud
from tpu_joints.distributed import (detect_batch as jdetect_batch,
                                    make_mesh as jmake_mesh,
                                    shard_inputs as jshard_inputs,
                                    stack_clouds as jstack_clouds)
from tpu_joints.modelbank import build_bank as jbuild_bank
from tpu_joints.modelbank import render_views as jrender_views
from tpu_joints.serve.depth import raycast_cylinders
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import distributed as tdist
from tpu_joints_torch.core.cloud import Cloud, make_cloud
from tpu_joints_torch.modelbank import bank as tbank
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.recognize.matching import Correspondences
from tpu_joints_torch.serve import DetectionService
from tpu_joints_torch.serve.depth import depth_to_cloud
from tpu_joints_torch.serve.server import depth_block

jdet = importlib.import_module("tpu_joints.pipelines.detect")
tcli = importlib.import_module("tpu_joints_torch.cli.main")
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def problem():
    """(JAX cfg, port cfg, JAX bank, port bank, scene points [4])."""
    cfg = DetectionConfig(
        descriptor="shot", descr_rad=0.12, model_ss=0.04, scene_ss=0.04,
        normal_k=10, match_mode="nn", match_threshold=0.25,
        algorithm="hough", cg_size=0.05, cg_thresh=3.0,
        icp_iterations=5, max_candidates=2, max_instances_per_view=2,
        scene_capacity=512, scene_key_capacity=32, k_max=16,
    )
    rng = np.random.default_rng(0)
    model_xyz, _ = joint_points(rng, n_chord=400, n_stub=250)
    jb = jbuild_bank(
        model_xyz, descriptor="shot", descr_radius=cfg.descr_rad,
        sampling_radius=cfg.model_ss, normal_k=cfg.normal_k, k_max=cfg.k_max,
        level=0, resolution=48, key_capacity=32,
    )
    tb = tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")
    views, _, _ = jrender_views(model_xyz, level=0, resolution=48)
    order = np.argsort([-v.shape[0] for v in views])[:4]
    pts = [np.asarray(views[i][:512], np.float32) for i in order]
    return cfg, tconfig.from_dict(dataclasses.asdict(cfg)), jb, tb, pts


@pytest.fixture(scope="module")
def batches(problem):
    """JAX's sharded batch (4 x 2 mesh, GSPMD form), the port's single
    detects, and the port's batch in its three forms (serial; placed;
    placed with mesh=), on a 4 x 2 mesh of eight CPU entries."""
    jcfg, tcfg, jb, tb, pts = problem
    jbatch, jbank = jshard_inputs(
        jstack_clouds([jmake_cloud(p, capacity=512) for p in pts]), jb,
        jmake_mesh(8, model_parallel=2))
    out_j = jdetect_batch(jbatch, jbank, jcfg)
    clouds = [make_cloud(p, capacity=512, device="cpu") for p in pts]
    single = [tdet.detect(c, tb, tcfg) for c in clouds]
    mesh = tdist.make_mesh(devices=[CPU] * 8, model_parallel=2)
    stacked = tdist.stack_clouds(clouds)
    serial = tdist.detect_batch(stacked, tb, tcfg)
    placed = tdist.shard_inputs(stacked, tb, mesh)
    return dict(jax=out_j, single=single, serial=serial,
                placed=tdist.detect_batch(*placed, tcfg),
                mesh=tdist.detect_batch(*placed, tcfg, mesh=mesh))


def test_detect_batch_matches_single_detect(batches):
    single = batches["single"]
    assert sum(bool(r.accepted) for r in single) >= 1
    for form in ("placed", "mesh"):
        out = batches[form]
        for b, ref in enumerate(single):
            assert int(out.view_idx[b]) == int(ref.view_idx)
            assert bool(out.accepted[b]) == bool(ref.accepted)
            np.testing.assert_allclose(out.full_pose[b].numpy(),
                                       ref.full_pose.numpy(), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(float(out.fitness[b]),
                                       float(ref.fitness), rtol=1e-4,
                                       atol=1e-8)
    a, b = batches["placed"], batches["mesh"]
    np.testing.assert_array_equal(a.view_idx.numpy(), b.view_idx.numpy())
    np.testing.assert_allclose(a.full_pose.numpy(), b.full_pose.numpy(),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(a.cand_fitness.numpy(), b.cand_fitness.numpy(),
                               rtol=2e-4, atol=1e-9)
    # the serial form is detect() per scene
    for b, ref in enumerate(single):
        for f in ("full_pose", "fitness", "view_idx", "cand_poses"):
            np.testing.assert_array_equal(
                getattr(batches["serial"], f)[b].numpy(),
                getattr(ref, f).numpy())


def test_detect_batch_matches_jax(batches):
    out_j, out = batches["jax"], batches["mesh"]
    np.testing.assert_array_equal(out.view_idx.numpy(),
                                  np.asarray(out_j.view_idx))
    np.testing.assert_array_equal(out.accepted.numpy(),
                                  np.asarray(out_j.accepted))
    np.testing.assert_allclose(out.full_pose.numpy(),
                               np.asarray(out_j.full_pose), atol=5e-4)


def test_shard_inputs_places_and_checks(problem):
    """Scenes over data, the bank's per-view arrays over model, poses and
    the CAD whole everywhere; a view count the model axis does not divide
    (12 views over 8) raises."""
    _, _, _, tb, pts = problem
    clouds = tdist.stack_clouds(
        [make_cloud(p, capacity=512, device="cpu") for p in pts])
    mesh = tdist.make_mesh(devices=[CPU] * 8, model_parallel=2)
    scenes, bank = tdist.shard_inputs(clouds, tb, mesh)
    assert scenes.xyz.local(3, 1).shape == (1, 512, 3)
    np.testing.assert_array_equal(scenes.xyz.local(2, 0)[0].numpy(),
                                  clouds.xyz[2].numpy())
    assert bank.desc.local(0, 1).shape[0] == tb.n_views // 2
    np.testing.assert_array_equal(bank.desc.local(3, 1).numpy(),
                                  tb.desc[tb.n_views // 2:].numpy())
    assert bank.poses.local(1, 1).shape == tb.poses.shape
    np.testing.assert_array_equal(bank.desc.gather().numpy(), tb.desc.numpy())
    with pytest.raises(ValueError, match="views"):
        tdist.shard_inputs(clouds, tb, tdist.make_mesh(
            devices=[CPU] * 8, model_parallel=8))


def _port_features(fj):
    c = Cloud(*(_t(a) for a in fj.cloud))
    k = Cloud(*(_t(a) for a in fj.keys))
    return tdet.SceneFeatures(c, _t(fj.normals), k, _t(fj.desc),
                              _t(fj.desc_valid), _t(fj.rf), _t(fj.rf_ok))


def test_group_views_arrays_on_a_view_shard(problem):
    """Each half of the views grouped on its own (a model shard of 2)
    against the JAX package's ``_group_views_arrays`` on the same shard and
    the same correspondences."""
    jcfg, tcfg, jb, tb, pts = problem
    fj = jdet.prepare_scene(jmake_cloud(pts[0], capacity=512), jcfg)
    ft = _port_features(fj)
    Vl = tb.n_views // 2
    n_valid = 0
    for sl in (slice(0, Vl), slice(Vl, None)):
        cj = jdet.match_bank(fj.desc, fj.desc_valid, jb.desc[sl],
                             jb.key_valid[sl], jcfg)
        ij = jdet._group_views_arrays(fj, jb.key_xyz[sl], jb.rf[sl],
                                      jb.key_valid[sl], cj, jcfg)
        ct = Correspondences(_t(cj.model_idx).long(), _t(cj.valid),
                             _t(cj.dist_sq))
        it = tdet._group_views_arrays(ft, tb.key_xyz[sl], tb.rf[sl],
                                      tb.key_valid[sl], ct, tcfg)
        valid = np.asarray(ij.valid)
        n_valid += int(valid.sum())
        assert it.votes.shape[0] == Vl
        np.testing.assert_array_equal(it.valid.numpy(), valid)
        np.testing.assert_array_equal(it.n_corrs.numpy(),
                                      np.asarray(ij.n_corrs))
        np.testing.assert_array_equal(it.membership.numpy(),
                                      np.asarray(ij.membership))
        np.testing.assert_allclose(it.votes.numpy(), np.asarray(ij.votes),
                                   rtol=1e-5, atol=1e-5)
    assert n_valid >= 1


def _frames():
    """``tests/test_serve.py``'s three 160 x 120 depth frames of two
    cylinders."""
    a30 = np.radians(30.0)
    cylinders = [
        (np.zeros(3), np.array([1.0, 0.0, 0.0]), 0.08, 0.3),
        (np.array([0.0, 0.0, 0.23]),
         np.array([np.sin(a30), 0.0, np.cos(a30)]), 0.05, 0.15),
    ]
    frames = []
    for ay_deg in (35.0, -15.0, 10.0):
        ay = np.radians(ay_deg)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                              [-np.sin(ay), 0, np.cos(ay)]], np.float32)
        T[:3, 3] = [0.02, -0.03, 1.0]
        xyz_img = raycast_cylinders(cylinders, T, width=160, height=120)
        frames.append(np.nan_to_num(xyz_img[..., 2]))
    return frames


def test_mesh_service_matches_single_device(problem):
    """3 frames on a data-4 mesh (one device gets none) against the
    single-device batched service; /healthz's device count is the mesh's."""
    _, tcfg, _, tb, _ = problem
    frames = _frames()
    mesh = tdist.make_mesh(devices=[CPU] * 4)
    svc_m = DetectionService(tb, tcfg, batch_max=4, batch_window_ms=30.0,
                             mesh=mesh)
    assert svc_m.devices == 4 and len(svc_m._replicas) == 4
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        outs = list(ex.map(
            lambda d: svc_m.detect_depth(d, near=0.05, far=5.0), frames))
    assert svc_m.n_batched_frames == 3
    svc_1 = DetectionService(tb, tcfg, batch_max=4, batch_window_ms=0.0)
    for i, out in enumerate(outs):
        ref = svc_1.detect_depth(frames[i], near=0.05, far=5.0)
        assert out["accepted"] == ref["accepted"]
        assert out["view_idx"] == ref["view_idx"]
        a, b = np.asarray(out["pose"]), np.asarray(ref["pose"])
        Rd = a[:3, :3] @ b[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1)))
        assert ang < 0.5 and np.linalg.norm(a[:3, 3] - b[:3, 3]) < 3e-3


def test_mesh_service_needs_batching_and_fails_with_a_shard(problem,
                                                            monkeypatch):
    _, tcfg, _, tb, _ = problem
    mesh = tdist.make_mesh(devices=[CPU] * 2)
    with pytest.raises(ValueError, match="batch_max"):
        DetectionService(tb, tcfg, mesh=mesh)
    svc = DetectionService(tb, tcfg, batch_max=2, mesh=mesh)
    calls = []
    real = tdet._detect_organized_batch_eager     # the mesh's eager batch

    def flaky(imgs, *a, **kw):
        calls.append(imgs.shape[0])
        if len(calls) == 2:
            raise RuntimeError("device 1 failed")
        return real(imgs, *a, **kw)

    monkeypatch.setattr(tdet, "_detect_organized_batch_eager", flaky)
    img = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="device 1 failed"):
        svc._mesh_batch(img, np.zeros((2, 16, 16), bool), 2)
    assert calls == [1, 1]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    return []


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.shape == y.shape and torch.equal(x, y)


def test_threaded_issue_equals_the_serial_issue(problem, batches,
                                                monkeypatch):
    """``run_on`` as it runs on a mesh of distinct cards, one thread per
    entry (here keyed by entry, on meshes that name the CPU several times),
    against its one-thread issue: ``detect_batch`` (4 x 2 mesh, both forms)
    and the mesh service's micro-batch (3 frames over a data-4 mesh) equal
    bit for bit, run after run."""
    _, tcfg, _, tb, pts = problem
    mesh = tdist.make_mesh(devices=[CPU] * 8, model_parallel=2)
    placed = tdist.shard_inputs(tdist.stack_clouds(
        [make_cloud(p, capacity=512, device="cpu") for p in pts]), tb, mesh)
    svc = DetectionService(tb, tcfg, batch_max=4,
                           mesh=tdist.make_mesh(devices=[CPU] * 4))
    xyz = [depth_to_cloud(d, fov_deg=57.0, near=0.05, far=5.0)
           for d in _frames()]
    vms = np.stack([np.isfinite(x).all(-1) for x in xyz])
    imgs = np.nan_to_num(np.stack(xyz)).astype(np.float32)
    block = depth_block(*imgs.shape[1:3], tcfg.scene_capacity)
    H, W = (n - n % block for n in imgs.shape[1:3])
    imgs, vms = imgs[:, :H, :W], vms[:, :H, :W]
    serial = svc._mesh_batch(imgs, vms, block)
    issued = []
    real = tdist.mesh._on_device
    monkeypatch.setattr(tdist.mesh, "_issuer", lambda i, d: i)
    monkeypatch.setattr(tdist.mesh, "_on_device", lambda *a: issued.append(
        threading.get_ident()) or real(*a))
    for _ in range(2):
        _assert_bit_equal(tdist.detect_batch(*placed, tcfg), batches["mesh"])
        _assert_bit_equal(tdist.detect_batch(*placed, tcfg, mesh=mesh),
                          batches["mesh"])
        _assert_bit_equal(svc._mesh_batch(imgs, vms, block), serial)
    assert len(issued) == 2 * (4 + 4 + 3) and len(set(issued)) > 1


def test_cli_serve_devices_builds_a_data_mesh(problem, monkeypatch):
    """``serve --devices N`` reaches ``serve_forever`` with a data mesh of N
    cards (0: all visible); with ``--device cpu`` only 1 is accepted."""
    _, _, _, tb, _ = problem
    got = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tbank, "load_bank", lambda path, device: tb)
    monkeypatch.setattr("tpu_joints_torch.serve.serve_forever",
                        lambda bank, cfg, **kw: got.update(kw))
    for n, data in (("0", 4), ("2", 2)):
        tcli.main(["serve", "--bank", "bank.npz", "--batch-max", "8",
                   "--devices", n])
        assert got["mesh"].shape == {"data": data, "model": 1}
        assert [str(d) for d in got["mesh"].devices[:, 0]] == [
            f"cuda:{i}" for i in range(data)]
        assert got["batch_max"] == 8
    tcli.main(["serve", "--bank", "bank.npz"])
    assert got["mesh"] is None
    with pytest.raises(ValueError, match="--devices"):
        tcli.main(["serve", "--bank", "bank.npz", "--batch-max", "8",
                   "--devices", "2", "--device", "cpu"])
