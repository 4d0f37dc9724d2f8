"""The served two-instance frame in both packages on the CPU.

``chip_smoke.py`` phase 12.4 serves the bench's two-instance frame as a
640×480 depth image with ``synthetic.hv_config`` (8192 lanes, so the
server's block rule picks block 4); on the card the port's GOOD list of the
unjittered frame holds joint a only, where the raycast cloud of the same
frame lists both. This script runs the JAX package's ``DetectionService``
and the port's on the same depth frame and the same 42-view bench bank
(built by the port on the CPU and handed to the JAX package as the same
arrays), with GO-HV on and off, and prints each GOOD list with the stage
counts (working-set points, keypoints, descriptors, matches, Hough
instances).

Run from the repository root on a CPU host with both packages (the JAX
package's HV holds about 10 GB at this size):

    JAX_PLATFORMS=cpu python scripts/two_instance_served.py [--bank PATH]

``--bank`` keeps the bank as ``.npz`` between runs (built if missing).
"""
import argparse
import dataclasses
import importlib
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_joints.config import DetectionConfig  # noqa: E402
from tpu_joints.modelbank.bank import ModelBank as JModelBank  # noqa: E402
from tpu_joints.pipelines import detect as _jpkg  # noqa: E402,F401
from tpu_joints.serve import DetectionService as JService  # noqa: E402
from tpu_joints_torch import synthetic as syn  # noqa: E402
from tpu_joints_torch.modelbank import bank as tbank  # noqa: E402
tdet = importlib.import_module("tpu_joints_torch.pipelines.detect")  # noqa: E402
from tpu_joints_torch.serve import DetectionService as TService  # noqa: E402

ARRAYS = ("view_xyz", "view_mask", "key_xyz", "key_valid", "desc", "rf",
          "poses", "model_xyz", "model_mask", "icp_xyz", "icp_mask")


def _err(T, G):
    Rd = T[:3, :3].astype(np.float64) @ G[:3, :3].T
    return (float(np.degrees(np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1,
                                               1)))),
            float(np.linalg.norm(T[:3, 3] - G[:3, 3])))


def listed(instances, T_a, T_b):
    out = []
    for k in instances:
        P = np.asarray(k["pose"], np.float64)
        errs = {n: _err(P, T) for n, T in (("a", T_a), ("b", T_b))}
        name, (ang, dt) = min(errs.items(), key=lambda kv: kv[1][1])
        out.append(f"{name} {ang:.3f} deg {dt * 1000:.3f} mm (view "
                   f"{k.get('view_idx')})")
    return "; ".join(out) or "none"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bank", default="")
    ap.add_argument("--hv", default="both", choices=("on", "off", "both"))
    args = ap.parse_args()
    t0 = time.time()
    if args.bank and os.path.exists(args.bank):
        tb = tbank.load_bank(args.bank, device="cpu")
    else:
        tb = tbank.build_bank(syn.joint_model(),
                              **syn.bench_bank_kwargs(syn.bench_config()),
                              device="cpu")
        if args.bank:
            tbank.save_bank(args.bank, tb)
    print(f"bank: {tb.n_views} views, {time.time() - t0:.1f} s", flush=True)
    arrays = tb.to_numpy()
    jb = JModelBank(**{k: jnp.asarray(arrays[k]) for k in ARRAYS},
                    params_hash=tb.params_hash)
    two_h, two_valid, T_a, T_b = syn.two_instance_frame()
    depth = np.where(two_valid, two_h[..., 2], 0.0).astype(np.float32)
    cfgs = {"off": syn.multi_instance_config(), "on": syn.hv_config()}
    for hv in (("off", "on") if args.hv == "both" else (args.hv,)):
        tcfg = cfgs[hv]
        jcfg = DetectionConfig(**dataclasses.asdict(tcfg))
        t1 = time.time()
        ref = JService(jb, jcfg).detect_depth(depth)
        t2 = time.time()
        out = TService(tb, tcfg).detect_depth(depth)
        t3 = time.time()
        print(f"HV {hv}: JAX  GOOD: {listed(ref['instances'], T_a, T_b)}; "
              f"accepted {ref['accepted']}, scene points "
              f"{ref['metrics']['scene_points']} ({t2 - t1:.0f} s)")
        print(f"HV {hv}: port GOOD: {listed(out['instances'], T_a, T_b)}; "
              f"accepted {out['accepted']}, scene points "
              f"{out['metrics']['scene_points']} ({t3 - t2:.0f} s)",
              flush=True)
        for k in ("scene_points", "scene_keypoints", "valid_descriptors",
                  "correspondences", "instances"):
            print(f"   {k}: JAX {ref['metrics'][k]}, port {out['metrics'][k]}")


if __name__ == "__main__":
    main()
