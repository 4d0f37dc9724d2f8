"""Depth frames that stress the served frame's unprojection
(``serve/depth.py::unproject``, its kernel and its plain version): sensor
frames, values at the far threshold, non-finite and non-positive depths,
overflowing coordinates, and shapes that crop, that take the kernel's
scalar paths, and that pick each tile edge. numpy only: the CPU parity
tests, the card tests and ``chip_smoke.py`` build their inputs from these
one definitions.

Each case returns ``(depth float32[H, W], kwargs, capacity)``: ``kwargs``
are ``fov_deg``, ``near`` and ``far`` as ``DetectionService.detect_depth``
takes them, ``capacity`` the scene capacity whose ``depth_block`` picks
the tile edge."""
import numpy as np

from tpu_joints_torch import synthetic as syn
from tpu_joints_torch.serve.depth import FakeDepthCamera


def metric_noisy():
    """The bench joint and the table raycast at 640×480 with 0.5 mm noise,
    0 at misses (metric; block 4 at 5,120 lanes)."""
    xyz, valid = syn.frame(syn.bench_pose(), 3, with_table=True)
    depth = np.where(valid, xyz[..., 2], 0.0).astype(np.float32)
    return depth, dict(fov_deg=57.0), 5120


def normalized_threshold():
    """A ``FakeDepthCamera`` frame (normalized, near 0.05, far 5; the
    background at 1.0 maps past the far threshold), its first row replaced
    by the 320 consecutive float32 values around the d that maps to
    ``far·(1 − 1e-4)``: z steps finer than its own ulp there, so the row
    holds z just below, at and just above the threshold (block 4)."""
    near, far = 0.05, 5.0
    cam = FakeDepthCamera(width=320, height=240, near=near, far=far)
    rng = np.random.default_rng(11)
    pts = np.stack([rng.uniform(-0.3, 0.3, 4000), rng.uniform(-0.2, 0.2, 4000),
                    rng.uniform(0.6, 4.99, 4000)], 1).astype(np.float32)
    depth = cam.render(pts, splat=3)
    thr = np.float32(far * (1.0 - 1e-4))
    d = np.float32((float(thr) - near) / (far - near))
    row = [d]
    for _ in range(160):
        row.insert(0, np.nextafter(row[0], np.float32(0)))
        row.append(np.nextafter(row[-1], np.float32(2)))
    depth[0, :] = np.asarray(row[:320], np.float32)
    return depth, dict(fov_deg=57.0, near=near, far=far), 2048


def specials():
    """NaN, ±inf, ±0, negative, subnormal and huge depths (metric) at a
    120° field of view, where z·x_scale overflows to ±inf at 3e38: such a
    pixel is invalid but its clamped coordinate stays in img, as
    ``nan_to_num`` leaves it (block 4)."""
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.2, 3.0, (120, 160)).astype(np.float32)
    values = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, 1e-45,
                       1e-38, 3e38, np.finfo(np.float32).max, 1e30],
                      np.float32)
    at = rng.choice(depth.size, 600, replace=False)
    depth.reshape(-1)[at] = values[np.arange(600) % len(values)]
    depth[:, 0] = 3e38              # the widest x scales
    return depth, dict(fov_deg=120.0), 1024


def crop_483x645():
    """483×645 random depths with a tenth of them 0: the crop at block 4
    drops 3 rows and 1 column, which only the valid count sees; W % 4 != 0
    takes the kernel's scalar loads."""
    rng = np.random.default_rng(7)
    depth = rng.uniform(0.3, 3.0, (483, 645)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    return depth, dict(fov_deg=57.0), 5120


def block8():
    """The bench frame at 2,560 lanes: block 8."""
    depth, kw, _ = metric_noisy()
    return depth, kw, 2560


def block16():
    """The 483×645 frame at 64 lanes: block 16, the largest, whose crop
    (480×640) takes the 16-byte stores under scalar loads."""
    depth, kw, _ = crop_483x645()
    return depth, kw, 64


def tiny_block1():
    """A 5×7 frame at block 1: no crop, every load and store scalar."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(-0.5, 2.0, (5, 7)).astype(np.float32)
    return depth, dict(fov_deg=57.0), 4096


CASES = {f.__name__: f for f in (metric_noisy, normalized_threshold, specials,
                                 crop_483x645, block8, block16, tiny_block1)}
