"""The harness's frame copy equals the port's ``synthetic.frame`` and
``raycast_cylinders`` at a small size, for one joint and for the two-joint
frame. The comparison is made here: the harness itself never imports
``synthetic.py`` for its frames. The one-joint pool is pinned bit for bit
by a checksum."""
import hashlib
import json

import numpy as np
import torch

from benchmark import cells, frames
from tpu_joints_torch import synthetic
from tpu_joints_torch.serve.depth import raycast_cylinders

# sha256 of joint_organized's depth pool at 160x120, 3 frames, seed
# 2**31 + 12345, on the CPU, as the one-joint harness made it
ONE_JOINT_POOL_SHA256 = (
    "a8974e8f37bd7aea2e0cfd811c29390abf4ea8d4f69e2d405fdf32c2ef01031b")
TWO_JOINTS = [dict(ay_deg=25.0, ax_deg=-15.0, t=[-0.30, -0.16, 1.05]),
              dict(ay_deg=-20.0, ax_deg=20.0, t=[0.30, 0.18, 1.00])]


def _config(width: int, height: int) -> dict:
    cfg = json.loads((cells.HERE / "configs" / "joint_organized.json")
                     .read_text())
    cfg["sensor"].update(width=width, height=height)
    return cfg


def test_raycast_and_noise_equal_the_originals():
    cfg = json.loads((cells.HERE / "configs" / "joint_organized.json")
                     .read_text())
    scene = frames.Scene(cfg)
    np.testing.assert_array_equal(scene.pose, synthetic.bench_pose())
    W, H = 160, 120
    pts = frames.raycast(scene.cylinders, scene.pose, W, H, scene.fov_deg,
                         "cpu")
    want = raycast_cylinders(synthetic.CYLINDERS, synthetic.bench_pose(),
                             width=W, height=H)
    hit = np.isfinite(want).all(-1)
    np.testing.assert_array_equal(np.isfinite(pts.numpy()).all(-1), hit)
    np.testing.assert_allclose(pts.numpy()[hit], want[hit], rtol=0, atol=3e-7)
    # the noise along the ray, with synthetic.frame's own draw
    seed = 5
    sigma = np.random.default_rng(seed).normal(0.0, 5e-4, (H, W)).astype(
        np.float32)
    xyz, valid = synthetic.frame(synthetic.bench_pose(), seed,
                                 with_table=False, width=W, height=H)
    depth = frames.noisy_depth(pts, torch.as_tensor(sigma)).numpy()
    np.testing.assert_array_equal(depth > 0, valid)
    np.testing.assert_allclose(depth[valid], xyz[..., 2][valid], rtol=0,
                               atol=3e-7)


def test_the_pool_follows_the_seed():
    cfg = json.loads((cells.HERE / "configs" / "joint_organized.json")
                     .read_text())
    cfg["sensor"].update(width=64, height=48)
    scene = frames.Scene(cfg)
    a = frames.make_pool(scene, 3, 2 ** 31 + 12345, "cpu")
    b = frames.make_pool(scene, 3, 2 ** 31 + 12345, "cpu")
    c = frames.make_pool(scene, 3, 2 ** 31 + 12346, "cpu")
    np.testing.assert_array_equal(a["depth"], b["depth"])
    assert not np.array_equal(a["depth"], c["depth"])
    assert a["depth"].shape == (3, 48, 64) and (a["depth"] >= 0).all()


def test_the_one_joint_pool_is_pinned():
    pool = frames.make_pool(frames.Scene(_config(160, 120)), 3,
                            2 ** 31 + 12345, "cpu")
    assert hashlib.sha256(pool["depth"].tobytes()).hexdigest() == \
        ONE_JOINT_POOL_SHA256
    np.testing.assert_array_equal(pool["pose"], synthetic.bench_pose())
    np.testing.assert_array_equal(pool["poses"], synthetic.bench_pose()[None])


def test_a_pose_and_one_instance_give_the_same_pool():
    legacy = _config(64, 48)
    listed = _config(64, 48)
    listed["scene"]["instances"] = [listed["scene"].pop("pose")]
    a = frames.make_pool(frames.Scene(legacy), 2, 2 ** 31 + 3, "cpu")
    b = frames.make_pool(frames.Scene(listed), 2, 2 ** 31 + 3, "cpu")
    for k in ("depth", "pose", "poses"):
        np.testing.assert_array_equal(a[k], b[k])


def test_two_instances_keep_the_nearer_hit():
    cfg = _config(160, 120)
    del cfg["scene"]["pose"]
    cfg["scene"]["instances"] = TWO_JOINTS
    scene = frames.Scene(cfg)
    args = (160, 120, scene.fov_deg, "cpu")
    both = frames.raycast(scene.cylinders, scene.poses, *args).numpy()
    a, b = (frames.raycast(scene.cylinders, T, *args).numpy()
            for T in scene.poses)
    hit_a, hit_b = np.isfinite(a).all(-1), np.isfinite(b).all(-1)
    assert hit_a.any() and hit_b.any()
    pick_a = hit_a & ~(hit_b & (b[..., 2] < a[..., 2]))
    want = np.where(pick_a[..., None], a, b)
    np.testing.assert_array_equal(np.isfinite(both).all(-1), hit_a | hit_b)
    np.testing.assert_array_equal(both[hit_a | hit_b], want[hit_a | hit_b])
    pool = frames.make_pool(scene, 2, 2 ** 31 + 9, "cpu")
    np.testing.assert_array_equal(pool["poses"],
                                  np.stack(synthetic.two_instance_poses()))
    np.testing.assert_array_equal(pool["pose"], pool["poses"][0])
    assert pool["poses"].dtype == np.float32
    np.testing.assert_array_equal(pool["depth"][0] > 0, hit_a | hit_b)


def test_two_instances_equal_the_two_instance_frame():
    """The joint moved into each instance's frame in float64 against
    ``synthetic.two_instance_frame``'s four cylinders posed in float32 and
    seen from the identity pose, with its noise draw (seed 77)."""
    W, H = 160, 120
    cfg = _config(W, H)
    del cfg["scene"]["pose"]
    cfg["scene"]["instances"] = TWO_JOINTS
    scene = frames.Scene(cfg)
    pts = frames.raycast(scene.cylinders, scene.poses, W, H, scene.fov_deg,
                         "cpu")
    sigma = np.random.default_rng(77).normal(0.0, 5e-4, (H, W)).astype(
        np.float32)
    xyz, valid, _, _ = synthetic.two_instance_frame(width=W, height=H)
    depth = frames.noisy_depth(pts, torch.as_tensor(sigma)).numpy()
    both = valid & (depth > 0)
    assert both.sum() > 0.99 * max(valid.sum(), (depth > 0).sum())
    np.testing.assert_allclose(depth[both], xyz[..., 2][both], rtol=0,
                               atol=1e-6)
    noisy = pts.numpy() * (1.0 + sigma / np.maximum(pts.numpy()[..., 2],
                                                    0.1))[..., None]
    np.testing.assert_allclose(noisy[both], xyz[both], rtol=0, atol=1e-6)
