"""Frames of the ``joint_hv.cams2`` cell's pool served by both packages on
the CPU, beside the card's replies to the same frames.

The benchmark makes its frames on the device from the seed, so the frames
and the card's replies come from the card: ``scripts/hv_pool_dump.py``
writes ``hv_frames_<seed>.npz`` (``depth`` float32[n, H, W] of the pool
entries ``index``, ``poses`` the true pose of each joint) and
``hv_replies_<seed>.json`` (the port's reply to entry i under
``alone_<i>``). This script builds the configuration's bank
with the port on the CPU, hands the same arrays to the JAX package, serves
each frame through the JAX package's ``DetectionService`` and the port's
with the configuration's ``DetectionConfig`` (GO-HV on), and prints each
GOOD list against the true joints (``benchmark/configs/joint_hv.json``'s
gate), the card's list beside them.

Run from the repository root on a CPU host with both packages:

    JAX_PLATFORMS=cpu python scripts/hv_pool_served.py FRAMES.npz \\
        REPLIES.json [--frames 0,1] [--bank PATH]

At the cell's size the JAX package's GO-HV holds about 10 GB and its
coverage searches a few GB more. ``--small`` runs the same path at a size
a test host holds (the frames cut to 160×120 by taking every fourth pixel,
a level-0 bank at 64 px, 2,048 lanes): it checks the script, not the cell.
"""
import argparse
import dataclasses
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.reference import hv as ref_hv  # noqa: E402
from benchmark.reference import joint  # noqa: E402
from tpu_joints.config import DetectionConfig  # noqa: E402
from tpu_joints.modelbank.bank import ModelBank as JModelBank  # noqa: E402
from tpu_joints.pipelines import detect as _jpkg  # noqa: E402,F401
from tpu_joints.serve import DetectionService as JService  # noqa: E402
from tpu_joints_torch import config as tconfig  # noqa: E402
from tpu_joints_torch.modelbank import bank as tbank  # noqa: E402
from tpu_joints_torch.serve import DetectionService as TService  # noqa: E402

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "configs", "joint_hv.json")


def listed(reply, poses, gate):
    """The reply's GOOD list as the joints it names ('a', 'b', or '?' for
    none within the gate), with each error."""
    out = []
    for inst in reply["instances"]:
        errs = [ref_hv.rot_trans_err(inst["pose"], G) for G in poses]
        k = min(range(len(poses)), key=lambda k: errs[k][1])
        ok = errs[k][0] <= gate["rot_deg"] and errs[k][1] <= gate["trans_mm"]
        out.append(f"{'ab'[k] if ok else '?'} {errs[k][0]:.2f} deg "
                   f"{errs[k][1]:.2f} mm")
    return "; ".join(out) or "none"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("frames")
    ap.add_argument("replies")
    ap.add_argument("--frames", dest="which", default="",
                    help="pool entries to serve (default: every one dumped)")
    ap.add_argument("--bank", default="")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    cfg = json.load(open(CONFIG))
    data = np.load(args.frames)
    card = json.load(open(args.replies))
    depth, poses = data["depth"], data["poses"]
    index = [int(i) for i in data["index"]] if "index" in data \
        else list(range(depth.shape[0]))
    det = dict(cfg["detection"])
    recipe = dict(cfg["bank"])
    if args.small:
        depth = depth[:, ::4, ::4]
        det.update(scene_capacity=2048, scene_key_capacity=512,
                   max_candidates=24, refine_top=6)
        recipe.update(level=0, resolution=64)
    model = joint.joint_model(recipe.pop("model"))
    if args.bank and os.path.exists(args.bank):
        tb = tbank.load_bank(args.bank, device="cpu")
    else:
        tb = tbank.build_bank(model, device="cpu", **recipe)
        if args.bank:
            tbank.save_bank(args.bank, tb)
    arrays = tb.to_numpy()
    jb = JModelBank(**{k: jnp.asarray(arrays[k]) for k in tbank._ARRAYS},
                    params_hash=tb.params_hash)
    tcfg = tconfig.from_dict(det)
    jcfg = DetectionConfig(**dataclasses.asdict(tcfg))
    fov = float(cfg["sensor"]["fov_deg"])
    jsvc, tsvc = JService(jb, jcfg), TService(tb, tcfg)
    which = [int(s) for s in args.which.split(",")] if args.which else index
    for i in which:
        ref = jsvc.detect_depth(depth[index.index(i)], fov_deg=fov)
        out = tsvc.detect_depth(depth[index.index(i)], fov_deg=fov)
        print(f"frame {i}: JAX (CPU) GOOD: {listed(ref, poses, cfg['gate'])}; "
              f"scene points {ref['metrics']['scene_points']}", flush=True)
        print(f"frame {i}: port (CPU) GOOD: {listed(out, poses, cfg['gate'])}; "
              f"scene points {out['metrics']['scene_points']}", flush=True)
        if not args.small and f"alone_{i}" in card:
            print(f"frame {i}: port (card) GOOD: "
                  f"{listed(card[f'alone_{i}'], poses, cfg['gate'])}")


if __name__ == "__main__":
    main()
