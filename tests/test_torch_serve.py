"""Port parity, the serving layer: ``tests/test_serve.py`` (the mesh cases
excepted: one card has nothing to shard) on the port's server, and the
server, its depth module, its native library, its presets and its CLI
against the JAX package's on the CPU.

Two level-0 banks: ``tests/test_serve.py``'s small service (1024 scene
lanes), built by the JAX package and carried to the port with
``bank_from_numpy(device="cpu")``, and the bench joint's for the bench chain
at test size (``tests/test_torch_batch.py::joint_problem``'s
configuration), built by the port and handed to the JAX package as the same
arrays, for a depth frame that both packages accept. Parity: ``accepted``, ``view_idx``,
``n_corrs`` and the metric counts equal; pose within 5e-4; grasp centroid
within 1e-4 (the port computes it on the host in float32, the reference
with XLA).
"""
import base64
import concurrent.futures
import dataclasses
import importlib
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import joint_cylinders, joint_points
from tpu_joints import native as jnative
from tpu_joints.config import PRESETS as JPRESETS
from tpu_joints.config import DetectionConfig
from tpu_joints.core.io import PointData, save_pcd
from tpu_joints.core.transforms import transform_points
from tpu_joints.modelbank import build_bank as jbuild_bank
from tpu_joints.modelbank import render_views, view_poses
from tpu_joints.modelbank.bank import ModelBank as JModelBank
from tpu_joints.serve import DetectionService as JDetectionService
from tpu_joints.serve import depth as jdepth
from tpu_joints_torch import config as tconfig
from tpu_joints_torch import native as tnative
from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.modelbank import bank as tbank
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")
from tpu_joints_torch.segment import organized as torg
from tpu_joints_torch.serve import (DetectionService, FakeDepthCamera,
                                    depth_to_cloud, make_server)
from tpu_joints_torch.serve import depth as tdepth
from tpu_joints_torch.serve import depth_cases
from tpu_joints_torch.serve.server import depth_block
from tpu_joints_torch.serve.batching import FrameBatcher, to_host

jcli = importlib.import_module("tpu_joints.cli.main")
tcli = importlib.import_module("tpu_joints_torch.cli.main")
ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")
REPO = Path(__file__).resolve().parent.parent


def _carry(jb):
    return tbank.bank_from_numpy(
        {k: np.asarray(getattr(jb, k)) for k in ARRAYS}
        | {"params_hash": jb.params_hash}, device="cpu")


def _port_cfg(cfg):
    return tconfig.from_dict(dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# depth module
# ---------------------------------------------------------------------------

def test_depth_cloud_roundtrip():
    cam = FakeDepthCamera(width=160, height=120, fov_deg=57.0, near=0.05, far=5.0)
    rng = np.random.default_rng(0)
    pts = np.stack([
        rng.uniform(-0.2, 0.2, 400),
        rng.uniform(-0.15, 0.15, 400),
        rng.uniform(0.8, 1.2, 400),
    ], 1).astype(np.float32)
    organized = cam.cloud(pts)
    assert organized.shape == (120, 160, 3)
    got = organized.reshape(-1, 3)
    got = got[np.isfinite(got).all(axis=1)]
    assert got.shape[0] > 100
    # every recovered point lies near some input point (pixel quantization)
    d = np.linalg.norm(got[:, None, :] - pts[None, :, :], axis=-1).min(axis=1)
    assert np.median(d) < 0.02, f"median reprojection error {np.median(d)}"


def test_depth_background_is_nan():
    cam = FakeDepthCamera(width=64, height=48)
    organized = cam.cloud(np.zeros((0, 3), np.float32))
    assert np.isnan(organized).all()


@pytest.mark.parametrize("size", [(160, 120), (64, 48), (7, 5)])
def test_depth_module_matches_jax(size):
    """pixel_scales, depth_to_cloud (metric; normalised; with an explicit
    max_valid_depth) and FakeDepthCamera.render / .cloud bit-equal."""
    W, H = size
    for fov in (57.0, 43.5):
        for a, b in zip(tdepth.pixel_scales(W, H, fov),
                        jdepth.pixel_scales(W, H, fov)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(W)
    depth = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    depth[0, 0], depth[-1, -1] = 1.0, 0.0
    for kw in (dict(), dict(near=0.05, far=5.0),
               dict(near=0.05, far=5.0, max_valid_depth=3.0),
               dict(max_valid_depth=0.5, fov_deg=43.5)):
        np.testing.assert_array_equal(tdepth.depth_to_cloud(depth, **kw),
                                      jdepth.depth_to_cloud(depth, **kw))
    pts = np.stack([rng.uniform(-0.3, 0.3, 500), rng.uniform(-0.2, 0.2, 500),
                    rng.uniform(0.5, 1.5, 500)], 1).astype(np.float32)
    tc = tdepth.FakeDepthCamera(width=W, height=H, near=0.05, far=5.0)
    jc = jdepth.FakeDepthCamera(width=W, height=H, near=0.05, far=5.0)
    for splat in (1, 3):
        np.testing.assert_array_equal(tc.render(pts, splat=splat),
                                      jc.render(pts, splat=splat))
        np.testing.assert_array_equal(tc.cloud(pts, splat=splat),
                                      jc.cloud(pts, splat=splat))


def _numpy_frame(depth, capacity, fov_deg=57.0, near=0.0, far=0.0):
    """The served frame as the service made it on the host before the
    unprojection moved to the device: (block, img, vmask, n_tiles,
    n_valid), NumPy throughout."""
    xyz = depth_to_cloud(depth, fov_deg=fov_deg, near=near, far=far)
    valid = np.isfinite(xyz).all(axis=-1)
    H, W = depth.shape
    block = depth_block(H, W, capacity)
    Hc, Wc = H - H % block, W - W % block
    vmask = valid[:Hc, :Wc]
    n_tiles = int(vmask.reshape(Hc // block, block, Wc // block,
                                block).any((1, 3)).sum())
    return block, np.nan_to_num(xyz[:Hc, :Wc]), vmask, n_tiles, int(valid.sum())


@pytest.mark.parametrize("case", sorted(depth_cases.CASES))
def test_unproject_equals_the_numpy_frame(case, service):
    """The unprojection's plain version, the service's ``_frame`` on the
    CPU (which runs it) and the mesh's host ``_host_frame`` each equal the
    NumPy frame bit for bit: img (as float32 bits: +0 at invalid pixels,
    ±FLT_MAX where a coordinate overflowed), vmask, the tile count of the
    crop and the valid count of the whole frame."""
    depth, kw, capacity = depth_cases.CASES[case]()
    block, img, vmask, n_tiles, n_valid = _numpy_frame(depth, capacity, **kw)
    assert block == {"block8": 8, "block16": 16, "tiny_block1": 1}.get(case, 4)
    assert n_valid > 0
    xs, ys = (torch.from_numpy(t) for t in
              tdepth.pixel_scales(depth.shape[1], depth.shape[0],
                                  kw["fov_deg"]))
    near, far = kw.get("near", 0.0), kw.get("far", 0.0)
    before = tdepth.unproject.launches
    p_img, p_vmask, counts = tdepth.unproject(torch.from_numpy(depth), xs, ys,
                                              near, far, block)
    assert tdepth.unproject.launches == before     # the CPU launches nothing
    svc = DetectionService(service.bank, dataclasses.replace(
        service.cfg, scene_capacity=capacity))
    got = {"plain": (block, p_img, p_vmask, *counts.tolist()),
           "service": svc._frame(depth, **kw),
           "mesh host": svc._host_frame(depth, **kw)}
    for name, (g_block, g_img, g_vmask, g_tiles, g_valid) in got.items():
        g_img, g_vmask = np.asarray(g_img), np.asarray(g_vmask)
        assert (g_block, g_tiles, g_valid) == (block, n_tiles, n_valid), name
        assert g_img.dtype == np.float32 and g_vmask.dtype == bool, name
        np.testing.assert_array_equal(g_img.view(np.uint32),
                                      img.view(np.uint32), err_msg=name)
        np.testing.assert_array_equal(g_vmask, vmask, err_msg=name)


# ---------------------------------------------------------------------------
# native library
# ---------------------------------------------------------------------------

def test_native_matches_jax(tmp_path):
    """The port's build of the reference's C++ source, byte for byte the
    same file, against the JAX package's: ingestion, depth unprojection and
    PCD reading equal."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("no native toolchain")
    assert (REPO / "tpu_joints_torch/native/src/tpujoints_native.cpp"
            ).read_bytes() == (REPO / "tpu_joints/native/src/"
                               "tpujoints_native.cpp").read_bytes()
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(5000, 3)).astype(np.float32)
    xyz[::7] = np.nan
    for cap in (1024, 8192):
        for a, b in zip(tnative.ingest_native(xyz, cap),
                        jnative.ingest_native(xyz, cap)):
            np.testing.assert_array_equal(a, b)
    n_finite = int(np.isfinite(xyz[:100]).all(1).sum())
    out, mask, n = tnative.ingest_native(xyz[:100], 1024)
    assert n == mask.sum() == n_finite and (out[n_finite:] == 1.0e6).all()
    depth = rng.uniform(0.1, 0.9, size=(120, 160)).astype(np.float32)
    depth[5, 5] = 1.0
    np.testing.assert_array_equal(
        tnative.depth_to_cloud_native(depth, 57.0, 0.05, 5.0),
        jnative.depth_to_cloud_native(depth, 57.0, 0.05, 5.0))
    p = str(tmp_path / "c.pcd")
    save_pcd(p, PointData(xyz=xyz[:777], rgb=rng.uniform(
        size=(777, 3)).astype(np.float32)), binary=True)
    (tx, trgb), (jx, jrgb) = tnative.load_pcd_native(p), jnative.load_pcd_native(p)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(trgb, jrgb)


# ---------------------------------------------------------------------------
# the service and the HTTP server (tests/test_serve.py's problem)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    cfg = DetectionConfig(
        descriptor="shot", descr_rad=0.12, model_ss=0.04, scene_ss=0.04,
        normal_k=10, match_mode="nn", match_threshold=0.25,
        algorithm="hough", cg_size=0.05, cg_thresh=3.0,
        icp_iterations=5, max_candidates=2, max_instances_per_view=2,
        scene_capacity=1024, scene_key_capacity=64, k_max=24,
    )
    rng = np.random.default_rng(0)
    model_xyz, _ = joint_points(rng, n_chord=500, n_stub=300)
    jb = jbuild_bank(
        model_xyz, descriptor="shot", descr_radius=cfg.descr_rad,
        sampling_radius=cfg.model_ss, normal_k=cfg.normal_k, k_max=cfg.k_max,
        level=0, resolution=64, key_capacity=48,
    )
    return cfg, model_xyz, jb


@pytest.fixture(scope="module")
def service(problem):
    cfg, model_xyz, jb = problem
    svc = DetectionService(_carry(jb), _port_cfg(cfg))
    svc._model_xyz = model_xyz
    return svc


@pytest.fixture(scope="module")
def server_url(service):
    server = make_server(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    server.shutdown()
    server.server_close()
    t.join(timeout=30)


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _health(url):
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        return json.loads(r.read())


def _view_points(model_xyz):
    views, _, _ = render_views(model_xyz, level=0, resolution=64)
    v = int(np.argmax([w.shape[0] for w in views]))
    return views[v].astype(np.float32)


def _splat_depth(model_xyz):
    """The model at the bank's first view pose, splatted into a 160×120
    depth frame (dense, like a real sensor frame)."""
    poses = view_poses(model_xyz, level=0)
    cam_pts = np.asarray(
        transform_points(jnp.asarray(model_xyz), jnp.asarray(poses[0])))
    cam = FakeDepthCamera(width=160, height=120, near=0.05, far=5.0)
    return cam, cam.render(cam_pts, splat=3)


def test_server_detect_and_health(server_url, service):
    pts = _view_points(service._model_xyz)
    body = {
        "points_b64": base64.b64encode(pts.tobytes()).decode(),
        "points_shape": list(pts.shape),
    }
    status, resp = _post(server_url + "/detect", body)
    assert status == 200, resp
    assert np.asarray(resp["pose"]).shape == (4, 4)
    assert resp["fitness"] < 0.01
    assert "grasp_centroid" in resp and len(resp["grasp_centroid"]) == 3
    assert resp["metrics"]["correspondences"] > 0
    assert resp["latency_ms"] > 0

    health = _health(server_url)
    assert health["status"] == "ok" and health["requests"] >= 1
    assert health["device"] == "cpu" and health["bank_views"] == 12


def test_server_structured_errors(server_url):
    status, resp = _post(server_url + "/detect", {})
    assert status == 400 and "error" in resp

    status, resp = _post(server_url + "/detect", {"points": [[1, 2], [3, 4]]})
    assert status == 400 and "points must be" in resp["error"]

    status, resp = _post(server_url + "/detect", {"depth_b64": "@@",
                                                  "depth_shape": [2, 2]})
    assert status == 400 and "bad 'depth_b64'" in resp["error"]

    status, resp = _post(server_url + "/nope", {})
    assert status == 404


def test_server_depth_request(server_url, service):
    cam, depth = _splat_depth(service._model_xyz)
    body = {
        "depth_b64": base64.b64encode(depth.tobytes()).decode(),
        "depth_shape": list(depth.shape),
        "fov_deg": cam.fov_deg, "near": cam.near, "far": cam.far,
    }
    status, resp = _post(server_url + "/detect", body)
    assert status == 200, resp
    assert resp["metrics"]["scene_points"] > 50


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(tdet, name)

    def counting(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(tdet, name, counting)
    return calls


def test_server_depth_uses_organized_ingest(service, monkeypatch):
    """A dense depth frame enters through ``detect_organized`` (stencil
    normals + per-tile selection on the sensor grid), never the
    stride-subsample fallback, at the block the capacity picks and the
    reference's half-window, as its one-dispatch program (``fused=True``,
    the reference server's call: a captured graph on a card)."""
    calls = _count_calls(monkeypatch, "detect_organized")
    cam, depth = _splat_depth(service._model_xyz)
    out = service.detect_depth(depth, fov_deg=cam.fov_deg, near=cam.near,
                               far=cam.far)
    assert len(calls) == 1, "depth path must use the organized entry"
    args, kw = calls[0]
    assert kw == {"block": 4, "half_window": 5, "fused": True}
    assert args[0].shape == (120, 160, 3) and args[1].dtype == torch.bool
    assert out["metrics"]["scene_points"] > 50


def test_server_depth_sparse_early_out(service, monkeypatch):
    """A depth frame whose valid pixels occupy only a handful of tiles is
    routed to the unordered path on the host: the organized call is never
    made."""
    calls = _count_calls(monkeypatch, "detect_organized")
    depth = np.zeros((120, 160), np.float32)   # 0 = invalid for depth_to_cloud
    depth[60:68, 80:88] = 1.0                  # one dense 8x8 patch: 4 tiles
    out = service.detect_depth(depth, fov_deg=57.0)
    assert calls == [], "sparse frame must take the host early-out"
    assert "pose" in out and "fitness" in out   # structured payload, no crash


def test_server_backpressure_503(server_url, service):
    """Requests beyond the pending bound get an immediate 503, not an
    unbounded queue on the device."""
    n = 0
    while service._slots.acquire(blocking=False):
        n += 1
    try:
        status, resp = _post(server_url + "/detect",
                             {"points": [[0.0, 0.0, 1.0]] * 32})
        assert status == 503 and "error" in resp
        assert _health(server_url)["rejected"] >= 1
    finally:
        for _ in range(n):
            service._slots.release()


def test_server_retries_out_of_memory(server_url, service, monkeypatch):
    """An exhausted allocator gets a bounded retry with backoff, counted in
    /healthz; any other error (a CUDA error is sticky) fails at once with a
    structured 500, after exactly one attempt."""
    real_detect = tdet.detect
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real_detect(*args, **kwargs)

    monkeypatch.setattr(tdet, "detect", flaky)
    monkeypatch.setattr(service, "retry_backoff_s", 0.001)
    pts = np.asarray(service._model_xyz[:600], np.float32)
    before = service.n_retries
    status, resp = _post(server_url + "/detect", {"points": pts.tolist()})
    assert status == 200, resp
    assert calls["n"] == 2
    assert service.n_retries == before + 1
    assert _health(server_url)["retries"] == service.n_retries

    calls["n"] = 0

    def broken(*args, **kwargs):
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access (injected)")

    monkeypatch.setattr(tdet, "detect", broken)
    errors = service.n_errors
    status, resp = _post(server_url + "/detect", {"points": pts.tolist()})
    assert status == 500 and "illegal memory access" in resp["error"]
    assert calls["n"] == 1 and service.n_errors == errors + 1

    def always_oom(*args, **kwargs):
        calls["n"] += 1
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    calls["n"] = 0
    monkeypatch.setattr(tdet, "detect", always_oom)
    status, resp = _post(server_url + "/detect", {"points": pts.tolist()})
    assert status == 500 and "OutOfMemoryError" in resp["error"]
    assert calls["n"] == service.max_retries + 1


def test_server_segmented_depth_uses_lattice_crop(service, monkeypatch):
    """A segmentation-enabled configuration routes depth frames through the
    lattice crop front end, with the crop flags handed to
    ``detect_organized`` intact."""
    seg_cfg = dataclasses.replace(
        service.cfg, segment_scene=True, remove_plane=True,
        rg_smoothness_deg=25.0, rg_max_edge=0.08, rg_min_cluster=30,
        cluster_max_curvature=0.15)
    svc = DetectionService(service.bank, seg_cfg)
    calls = _count_calls(monkeypatch, "detect_organized")
    reads = torg.region_growing_lattice.host_checks

    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.0, 0.0, 1.0]
    xyz_img = tdepth.raycast_cylinders(
        joint_cylinders(), T, width=160, height=120,
        rects=[(np.array([0.0, 0.0, 0.4]), np.array([1.0, 0.0, 0.0]),
                np.array([0.0, 1.0, 0.0]), 0.5, 0.5)])
    depth = np.where(np.isfinite(xyz_img[..., 2]), xyz_img[..., 2], 0.0)
    out = svc.detect_depth(depth)
    assert len(calls) == 1, "segmented cfg must use the organized entry"
    assert calls[0][0][3].segment_scene and calls[0][0][3].remove_plane
    assert torg.region_growing_lattice.host_checks > reads
    assert out["metrics"]["scene_points"] > 30


def _raycast_depths(angles):
    a30 = np.radians(30.0)
    cylinders = [
        (np.zeros(3), np.array([1.0, 0.0, 0.0]), 0.08, 0.3),
        (np.array([0.0, 0.0, 0.23]),
         np.array([np.sin(a30), 0.0, np.cos(a30)]), 0.05, 0.15),
    ]
    frames = []
    for ay_deg in angles:
        ay = np.radians(ay_deg)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                              [-np.sin(ay), 0, np.cos(ay)]], np.float32)
        T[:3, 3] = [0.02, -0.03, 1.0]
        xyz_img = tdepth.raycast_cylinders(cylinders, T, width=160, height=120)
        frames.append(np.nan_to_num(xyz_img[..., 2]))
    return frames


def test_server_micro_batching_coalesces_frames(service):
    """Concurrent depth requests through a batch_max > 1 service coalesce
    into ``detect_organized_batch`` passes, stay on the organized path, and
    every frame's response matches the unbatched service's."""
    frames = _raycast_depths((35.0, -15.0))
    svc_b = DetectionService(service.bank, service.cfg, batch_max=4,
                             batch_window_ms=30.0)
    reqs = [frames[i % 2] for i in range(4)]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(
            lambda d: svc_b.detect_depth(d, near=0.05, far=5.0), reqs))

    assert svc_b.n_requests == 4
    assert svc_b.n_batched_frames == 4
    assert svc_b.n_batches < 4, f"{svc_b.n_batches} passes for 4 frames"
    for i, out in enumerate(outs):
        ref = service.detect_depth(reqs[i], near=0.05, far=5.0)
        assert out["metrics"]["scene_points"] < service.cfg.scene_capacity
        assert out["metrics"]["scene_points"] == ref["metrics"]["scene_points"]
        assert out["accepted"] == ref["accepted"]
        assert out["view_idx"] == ref["view_idx"]
        a, b = np.asarray(out["pose"]), np.asarray(ref["pose"])
        Rd = a[:3, :3] @ b[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1)))
        assert ang < 0.5 and np.linalg.norm(a[:3, 3] - b[:3, 3]) < 3e-3


def test_frame_batcher_error_delivery_and_exact_batches():
    """Batcher contract: errors reach every waiter; a batch holds exactly
    the queued frames (no padding); results map back to their frames,
    torch leaves of NamedTuples and dicts included."""
    calls = []

    def ok_batch(imgs, vms):
        calls.append(imgs.shape[0])
        m = torch.from_numpy(imgs.mean(axis=(1, 2)))
        return {"mean": m, "pair": (m * 2, "tag")}

    fb = FrameBatcher(ok_batch, max_batch=8, window_ms=20.0)
    frames = [np.full((4, 4), float(i), np.float32) for i in range(3)]
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        outs = list(ex.map(lambda f: fb.submit(f, f > -1), frames))
    for i, o in enumerate(outs):
        assert float(o["mean"]) == float(i)
        assert float(o["pair"][0]) == 2.0 * i and o["pair"][1] == "tag"
    assert sum(calls) == 3 and fb.n_batched_frames == 3
    assert fb.n_batches == len(calls)

    def boom(imgs, vms):
        raise RuntimeError("device fell over")

    fb2 = FrameBatcher(boom, max_batch=4, window_ms=5.0)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(fb2.submit, frames[0], frames[0] > -1)
                for _ in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="fell over"):
                f.result(timeout=60)
    with pytest.raises(ValueError, match="max_batch"):
        FrameBatcher(boom, max_batch=0)


def test_frame_batcher_full_batch_ends_the_wait():
    """``max_batch`` queued frames end the leader's wait: two concurrent
    frames with ``max_batch=2`` run as one batch long before a 60 s
    window."""
    import time

    calls = []
    fb = FrameBatcher(lambda imgs, vms: calls.append(len(imgs)) or
                      {"n": torch.zeros(len(imgs))}, max_batch=2,
                      window_ms=60_000.0)
    frame = np.zeros((4, 4), np.float32)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(fb.submit, frame, frame > -1) for _ in range(2)]
        for f in futs:
            f.result(timeout=30)
    assert time.perf_counter() - t0 < 30 and calls == [2]


def test_to_host_keeps_cpu_trees():
    """A tree already on the host comes back as it was: no copy."""
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    tree = {"a": t, "b": (t > 2, 1.5), "c": [np.zeros(2)]}
    out = to_host(tree)
    assert out["a"] is t and out["b"][1] == 1.5 and out["c"][0] is tree["c"][0]


# ---------------------------------------------------------------------------
# against the JAX package's service
# ---------------------------------------------------------------------------

def _assert_replies_match(out, ref):
    assert out["accepted"] == ref["accepted"]
    assert out["view_idx"] == ref["view_idx"]
    assert out["n_corrs"] == ref["n_corrs"]
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert out["metrics"][k] == ref["metrics"][k], k
    np.testing.assert_allclose(out["pose"], ref["pose"], atol=5e-4)
    np.testing.assert_allclose(out["grasp_centroid"], ref["grasp_centroid"],
                               atol=1e-4)
    assert len(out["instances"]) == len(ref["instances"])


def test_detect_points_matches_jax(problem, service):
    cfg, model_xyz, jb = problem
    pts = _view_points(model_xyz)
    ref = JDetectionService(jb, cfg).detect_points(pts)
    out = service.detect_points(pts)
    assert out["accepted"]
    _assert_replies_match(out, ref)


@pytest.fixture(scope="module")
def bench_problem():
    """The bench chain at test size and the level-0 bench-joint bank, and
    JAX's reply to the 320×240 bench frame (noise seed 42) sent as depth:
    the block rule picks block 4 there, the test-size image of the 640×480
    frame's block 8."""
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
    tb = tbank.build_bank(
        syn.joint_model(3000, 1800), descriptor="shot", descr_radius=0.06,
        rf_radius=0.06, rf_k_max=96, frames="board", sampling_radius=0.02,
        normal_k=16, k_max=96, level=0, resolution=64, surface_leaf=0.01,
        key_capacity=64, icp_capacity=1024, device="cpu")
    arrays = tb.to_numpy()
    jb = JModelBank(**{k: jnp.asarray(arrays[k]) for k in ARRAYS},
                    params_hash=tb.params_hash)
    xyz, _ = syn.frame(syn.bench_pose(), 42, with_table=False, width=320,
                       height=240)
    depth = xyz[..., 2]
    ref = JDetectionService(jb, jcfg).detect_depth(depth)
    return jcfg, tb, depth, ref, jb


def test_detect_depth_matches_jax(bench_problem):
    """The depth path end to end: equal to JAX's service, equal bit for bit
    to a direct ``detect_organized`` call on the unprojected frame at the
    server's block, and within 1° / 5 mm of the truth."""
    jcfg, tb, depth, ref, _ = bench_problem
    tcfg = _port_cfg(jcfg)
    out = DetectionService(tb, tcfg).detect_depth(depth)
    assert out["accepted"] and out["metrics"]["scene_points"] > 400
    _assert_replies_match(out, ref)
    xyz = depth_to_cloud(depth)
    valid = np.isfinite(xyz).all(-1)
    direct, _ = tdet.detect_organized(
        torch.from_numpy(np.nan_to_num(xyz)), torch.from_numpy(valid), tb,
        tcfg, block=4, half_window=5)
    np.testing.assert_array_equal(np.asarray(out["pose"], np.float32),
                                  direct.full_pose.numpy())
    T = syn.bench_pose()
    P = np.asarray(out["pose"])
    Rd = P[:3, :3] @ T[:3, :3].T
    assert np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1))) < 1.0
    assert np.linalg.norm(P[:3, 3] - T[:3, 3]) < 0.005


def test_detect_depth_segmented_matches_jax(bench_problem):
    """A segmented configuration served at the block the server's rule
    picks: with 3072 lanes the 320×240 table frame gets block 4, the
    test-size image of the 640×480 frame's block 8 at 2560 lanes. The crop
    chain keeps ~400 lattice nodes there, and both packages reject the
    frame with the same counts (the reference's rule, reproduced, not
    fixed; ``chip_smoke.py`` phase 12.3 serves the configuration at 8192
    lanes, where the rule picks the bench's block)."""
    jcfg, tb, _, _, jb = bench_problem
    seg = dataclasses.replace(
        jcfg, remove_plane=True, segment_scene=True, rg_smoothness_deg=12.0,
        rg_max_edge=0.05, cluster_max_curvature=0.08)
    xyz, valid = syn.frame(syn.bench_pose(), 0, with_table=True, width=320,
                           height=240)
    depth = np.where(valid, xyz[..., 2], 0.0).astype(np.float32)
    ref = JDetectionService(jb, seg).detect_depth(depth)
    out = DetectionService(tb, _port_cfg(seg)).detect_depth(depth)
    assert not out["accepted"] and not ref["accepted"]
    assert 350 < out["metrics"]["scene_points"] < 450
    for k in ("scene_points", "scene_keypoints", "valid_descriptors",
              "correspondences", "instances"):
        assert out["metrics"][k] == ref["metrics"][k], k


def test_unported_preset_fails_at_warmup(service):
    """Every preset is ported now (``fpfh_demo`` is served in
    ``tests/test_torch_fpfh.py``); a preset the bank cannot serve still
    fails at warmup, before any request: ``fpfh_demo``'s FPFH-33 scene
    descriptors against this SHOT-352 bank."""
    svc = DetectionService(service.bank, tconfig.PRESETS["fpfh_demo"])
    with pytest.raises(ValueError, match="33-D.*352-D"):
        svc.warmup()


# ---------------------------------------------------------------------------
# presets and the CLI
# ---------------------------------------------------------------------------

def test_presets_match_jax():
    assert list(tconfig.PRESETS) == list(JPRESETS)
    for name, cfg in tconfig.PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JPRESETS[name]), name


@pytest.mark.parametrize("flags", [
    [],
    ["--preset", "shot_demo", "--no-segment", "--scene_ss", "0.05"],
    ["--preset", "shot_hypothesis", "--algorithm", "GC", "--cg_size", "0.04",
     "--cg_thresh", "4", "--final_icp", "5", "--rg_backend", "voxel"],
    ["--preset", "6dpose", "--model_ss", "0.01", "--rf_rad", "0.03",
     "--descr_rad", "0.05", "--match_threshold", "0.3",
     "--scene_capacity", "4096", "-k", "-c", "-r"],
])
def test_config_from_args_matches_jax(flags):
    argv = ["serve", "--bank", "bank.npz", "--batch-max", "8",
            "--warm-depth", "640x480", *flags]
    targs = tcli.build_parser().parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    assert targs.batch_max == jargs.batch_max == 8
    assert targs.warm_depth == jargs.warm_depth
    assert dataclasses.asdict(tcli._config_from_args(targs)) == \
        dataclasses.asdict(jcli._config_from_args(jargs))


def test_cli_serve_help():
    out = subprocess.run([sys.executable, "-m", "tpu_joints_torch.cli",
                          "serve", "--help"], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--batch-max" in out.stdout and "--warm-depth" in out.stdout


def test_config_from_args_rejects_unknown_preset():
    args = tcli.build_parser().parse_args(["serve", "--bank", "x.npz",
                                           "--preset", "nope"])
    with pytest.raises(SystemExit, match="unknown preset"):
        tcli._config_from_args(args)
