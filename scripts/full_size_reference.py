"""Full-size reference runs on the CPU for the FPFH chain and the generic
path's options: the numbers ``chip_smoke.py`` phase 13 prints beside the
card's.

    JAX_PLATFORMS=cpu python scripts/full_size_reference.py fpfh [--port-bank]
    JAX_PLATFORMS=cpu python scripts/full_size_reference.py options

``fpfh``: the JAX package builds ``bench.py``'s 42-view FPFH bank
(``synthetic.fpfh_bank_recipe``; tens of minutes on a CPU) and runs its
``detect_organized`` with ``synthetic.fpfh_config`` on the 640×480 table
frame (noise seed 42, ``bench.py``'s crop box, block 4, half-window 5);
the port does the same on the CPU with its own bank. With ``--port-bank``
the JAX package runs on the port's bank instead (minutes).

``options``: the port's ``detect`` on phase 6's cloud (the table-free
frame's points strided to 2560, ``synthetic.generic_config``, the 42-view
bench bank built by the port) with each of the options phase 13.2 drives.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_joints_torch import synthetic as syn  # noqa: E402

ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")


def _err(T, G):
    Rd = np.asarray(T, np.float64)[:3, :3] @ G[:3, :3].T
    return (float(np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1,
                                               1)))),
            float(np.linalg.norm(np.asarray(T)[:3, 3] - G[:3, 3])))


def _report(label, res, n_sel, T, seconds):
    rot, trans = _err(np.asarray(res.full_pose), T)
    m = res.metrics
    print(f"{label}: accepted {bool(res.accepted)}, view {int(res.view_idx)}, "
          f"rot_err {rot:.3f} deg, trans_err {trans * 1000:.3f} mm, "
          f"n_selected {int(n_sel)}, scene points {int(m['scene_points'])}, "
          f"keys {int(m['scene_keypoints'])}, valid descriptors "
          f"{int(m['valid_descriptors'])}, matches {int(m['correspondences'])}"
          f", instances {int(m['instances'])} ({seconds:.0f} s)", flush=True)


def fpfh(port_bank: bool) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import importlib

    import jax.numpy as jnp
    import torch

    from tpu_joints.config import DetectionConfig
    from tpu_joints.modelbank.bank import ModelBank as JModelBank
    from tpu_joints.modelbank.bank import build_bank as jbuild_bank
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect_organized

    jdet = importlib.import_module("tpu_joints.pipelines.detect")
    cfg = syn.fpfh_config()
    T = syn.bench_pose()
    xyz, valid = syn.frame(T, 42, with_table=True)
    t0 = time.time()
    tb = build_bank(syn.joint_model(), **syn.fpfh_bank_recipe(cfg),
                    device="cpu")
    print(f"port bank: {tb.n_views} views in {time.time() - t0:.0f} s",
          flush=True)
    t0 = time.time()
    res, n = detect_organized(
        torch.as_tensor(xyz), torch.as_tensor(valid), tb, cfg, block=4,
        half_window=5, crop_lo=torch.as_tensor(syn.CROP_LO),
        crop_hi=torch.as_tensor(syn.CROP_HI))
    _report("port on the CPU, port bank", res, n, T, time.time() - t0)
    t0 = time.time()
    if port_bank:
        arrays = tb.to_numpy()
        jb = JModelBank(**{k: jnp.asarray(arrays[k]) for k in ARRAYS},
                        params_hash=tb.params_hash)
        which = "port bank"
    else:
        jb = jbuild_bank(syn.joint_model(), **syn.fpfh_bank_recipe(cfg))
        which = "JAX bank"
        print(f"JAX bank: {jb.n_views} views in {time.time() - t0:.0f} s",
              flush=True)
    t0 = time.time()
    jcfg = DetectionConfig(**dataclasses.asdict(cfg))
    res, n = jdet.detect_organized(
        jnp.asarray(xyz), jnp.asarray(valid), jb, jcfg, block=4,
        half_window=5, crop_lo=jnp.asarray(syn.CROP_LO),
        crop_hi=jnp.asarray(syn.CROP_HI))
    _report(f"JAX on the CPU, {which}", res, n, T, time.time() - t0)


def options() -> None:
    import torch

    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect

    cfg = syn.generic_config()
    bank = build_bank(syn.joint_model(), **syn.bench_bank_kwargs(cfg),
                      device="cpu")
    T = syn.bench_pose()
    xyz, valid = syn.frame(T, 42, with_table=False)
    scene = make_cloud(syn.scene_points(xyz[valid], cfg.scene_capacity),
                       capacity=cfg.scene_capacity, device="cpu")
    for opt in ({}, {"normal_anchors": 1024}, {"algorithm": "gc"},
                {"keypoints": "iss"}, {"rg_backend": "voxel"}):
        t0 = time.time()
        res = detect(scene, bank, dataclasses.replace(cfg, **opt))
        _report(f"port on the CPU, {opt or 'phase 6'}", res, torch.tensor(0),
                T, time.time() - t0)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("fpfh", "options"))
    ap.add_argument("--port-bank", action="store_true")
    a = ap.parse_args()
    fpfh(a.port_bank) if a.what == "fpfh" else options()
