"""Full-size reference runs on the CPU for the FPFH chain, the generic
path's options, the command-line flow, the lattice keypoints and the
README's Python API: the numbers ``chip_smoke.py`` phases 13, 14 and 16
print beside the card's.

    JAX_PLATFORMS=cpu python scripts/full_size_reference.py fpfh [--port-bank]
    JAX_PLATFORMS=cpu python scripts/full_size_reference.py options
    JAX_PLATFORMS=cpu python scripts/full_size_reference.py cli
    JAX_PLATFORMS=cpu python scripts/full_size_reference.py lattice
    JAX_PLATFORMS=cpu python scripts/full_size_reference.py api

``fpfh``: the JAX package builds ``bench.py``'s 42-view FPFH bank
(``synthetic.fpfh_bank_recipe``; tens of minutes on a CPU) and runs its
``detect_organized`` with ``synthetic.fpfh_config`` on the 640×480 table
frame (noise seed 42, ``bench.py``'s crop box, block 4, half-window 5);
the port does the same on the CPU with its own bank. With ``--port-bank``
the JAX package runs on the port's bank instead (minutes).

``options``: the port's ``detect`` on phase 6's cloud (the table-free
frame's points strided to 2560, ``synthetic.generic_config``, the 42-view
bench bank built by the port) with each of the options phase 13.2 drives.

``cli``: phase 14.1's files — the bench joint (64,000 points) as
``model.pcd``, the table-free frame's valid points as ``scene.pcd`` — and
the port's CLI building the ``shot_demo`` bank on the CPU (42 views at
100 px, 256 keys); then the JAX package's CLI ``detect --preset shot_demo
--json`` and ``detect --tree 3`` on that bank (16,384 scene lanes), the
results phase 14.1 and 14.2 are held to.

``lattice``: the JAX package's and the port's ``detect_organized`` with
``keypoints="lattice"``, ``key_group=3`` on phase 5's frame
(``bench_config`` without the crop flags) and phase 7's table frame
(``segmented_config``), both on the 42-view bench bank built by the port:
the results phase 14.5 is held to.

``api``: the README's Python API through each package's exports —
``build_bank(model_xyz)`` at its defaults (42 SHOT views; the port builds
it on the CPU and the JAX package loads its arrays),
``make_cloud(scene_xyz, capacity=32768)`` on phase 5's frame's valid
points strided to at most 32,768, ``detect(scene, bank, PRESETS["shot"])``
— the result phase 16 is held to.
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
    sel = "" if n_sel is None else f"n_selected {int(n_sel)}, "
    print(f"{label}: accepted {bool(res.accepted)}, view {int(res.view_idx)}, "
          f"rot_err {rot:.3f} deg, trans_err {trans * 1000:.3f} mm, "
          f"{sel}scene points {int(m['scene_points'])}, "
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
        _report(f"port on the CPU, {opt or 'phase 6'}", res, None, T,
                time.time() - t0)


def cli() -> None:
    import importlib
    import json
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu_joints_torch.cli import main as tmain
    from tpu_joints_torch.core.io import PointData, save_pcd

    jmain = importlib.import_module("tpu_joints.cli.main")
    jmain._sync_platform = lambda: None       # no persistent compile cache
    T = syn.bench_pose()
    xyz, valid = syn.frame(T, 42, with_table=False)
    with tempfile.TemporaryDirectory() as d:
        save_pcd(f"{d}/model.pcd", PointData(xyz=syn.joint_model()))
        save_pcd(f"{d}/scene.pcd", PointData(xyz=xyz[valid]))
        t0 = time.time()
        tmain(["bank", f"{d}/model.pcd", "--out", f"{d}/bank.npz",
               "--preset", "shot_demo", "--device", "cpu"])
        print(f"port CLI bank on the CPU in {time.time() - t0:.0f} s",
              flush=True)
        for extra in ([], ["--tree", "3"]):
            t0 = time.time()
            import contextlib
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jmain.main(["detect", f"{d}/scene.pcd", "--bank",
                            f"{d}/bank.npz", "--preset", "shot_demo",
                            "--json", *extra])
            out = buf.getvalue()
            print(out, end="")
            res = json.loads(out.strip().splitlines()[-1])
            rot, trans = _err(np.asarray(res["pose"]), T)
            view = int(out.split("view=")[1].split()[0])
            print(f"JAX CLI detect {' '.join(extra) or '(one bank)'}: "
                  f"accepted {res['accepted']}, view {view}, rot_err "
                  f"{rot:.3f} deg, trans_err {trans * 1000:.3f} mm "
                  f"({time.time() - t0:.0f} s)", flush=True)


def lattice() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import importlib

    import jax.numpy as jnp
    import torch

    from tpu_joints.config import DetectionConfig
    from tpu_joints.modelbank.bank import ModelBank as JModelBank
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect_organized

    jdet = importlib.import_module("tpu_joints.pipelines.detect")
    T = syn.bench_pose()
    t0 = time.time()
    tb = build_bank(syn.joint_model(), **syn.bench_bank_kwargs(
        syn.bench_config()), device="cpu")
    arrays = tb.to_numpy()
    jb = JModelBank(**{k: jnp.asarray(arrays[k]) for k in ARRAYS},
                    params_hash=tb.params_hash)
    print(f"port bank: {tb.n_views} views in {time.time() - t0:.0f} s",
          flush=True)
    lat = dict(keypoints="lattice", key_group=3)
    for label, table, cfg in (
            ("phase 5 frame", False, dataclasses.replace(
                syn.bench_config(), segment_scene=False, remove_plane=False,
                **lat)),
            ("phase 7 table frame", True, dataclasses.replace(
                syn.segmented_config(), **lat))):
        xyz, valid = syn.frame(T, 42, with_table=table)
        t0 = time.time()
        res, n = detect_organized(
            torch.as_tensor(xyz), torch.as_tensor(valid), tb, cfg, block=4,
            half_window=5, crop_lo=torch.as_tensor(syn.CROP_LO),
            crop_hi=torch.as_tensor(syn.CROP_HI))
        _report(f"port on the CPU, {label}, lattice keys", res, n, T,
                time.time() - t0)
        t0 = time.time()
        res, n = jdet.detect_organized(
            jnp.asarray(xyz), jnp.asarray(valid), jb,
            DetectionConfig(**dataclasses.asdict(cfg)), block=4,
            half_window=5, crop_lo=jnp.asarray(syn.CROP_LO),
            crop_hi=jnp.asarray(syn.CROP_HI))
        _report(f"JAX on the CPU, {label}, lattice keys", res, n, T,
                time.time() - t0)


API_CAPACITY = 32768


def api() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tpu_joints.config import PRESETS as JPRESETS
    from tpu_joints.core.cloud import make_cloud as jmake_cloud
    from tpu_joints.modelbank import ModelBank as JModelBank
    from tpu_joints.pipelines import detect as jdetect
    from tpu_joints_torch.config import PRESETS
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank import build_bank
    from tpu_joints_torch.pipelines import detect

    T = syn.bench_pose()
    xyz, valid = syn.frame(T, 42, with_table=False)
    scene_xyz = syn.scene_points(xyz[valid], API_CAPACITY)
    print(f"scene: {int(valid.sum())} valid points, {len(scene_xyz)} kept",
          flush=True)
    t0 = time.time()
    bank = build_bank(syn.joint_model(), device="cpu")
    print(f"port bank: {bank.n_views} views, desc {tuple(bank.desc.shape)} "
          f"in {time.time() - t0:.0f} s", flush=True)
    t0 = time.time()
    res = detect(make_cloud(scene_xyz, capacity=API_CAPACITY, device="cpu"),
                 bank, PRESETS["shot"])
    _report("port on the CPU, README API", res, None, T, time.time() - t0)
    arrays = bank.to_numpy()
    jb = JModelBank(**{k: jnp.asarray(arrays[k]) for k in ARRAYS},
                    params_hash=bank.params_hash)
    t0 = time.time()
    res = jdetect(jmake_cloud(scene_xyz, capacity=API_CAPACITY), jb,
                  JPRESETS["shot"])
    _report("JAX on the CPU, port bank, README API", res, None, T,
            time.time() - t0)
    print(f"JAX full_pose {np.asarray(res.full_pose).tolist()}, fitness "
          f"{float(res.fitness)}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("fpfh", "options", "cli", "lattice",
                                     "api"))
    ap.add_argument("--port-bank", action="store_true")
    a = ap.parse_args()
    {"fpfh": lambda: fpfh(a.port_bank), "options": options, "cli": cli,
     "lattice": lattice, "api": api}[a.what]()
