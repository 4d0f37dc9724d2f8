"""The harness's frame copy equals the port's ``synthetic.frame`` and
``raycast_cylinders`` at a small size. The comparison is made here: the
harness itself never imports ``synthetic.py`` for its frames."""
import json

import numpy as np
import torch

from benchmark import cells, frames
from tpu_joints_torch import synthetic
from tpu_joints_torch.serve.depth import raycast_cylinders


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
