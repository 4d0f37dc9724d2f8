"""Command-line entry points mirroring the reference programs (counterpart
of ``tpu_joints/cli/main.py``): one argparse tree with the reference's flag
names (``SHOT.cpp:81-143``) and presets named after its programs.

    python -m tpu_joints_torch.cli serve --bank bank.npz [--preset P]
        [--batch-max N] [--warm-depth 640x480]   # the ROS detector node, as HTTP

The server runs on the card, with a bank saved by
``modelbank.bank.save_bank`` (either package's ``.npz``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def _add_reference_flags(p: argparse.ArgumentParser) -> None:
    """The reference's flag set, same names (SHOT.cpp:81-143)."""
    p.add_argument("--preset", default="shot",
                   help="reference program preset (shot, shot_segment, "
                        "shot_demo, fpfh_demo, shot_hypothesis, 6dpose)")
    p.add_argument("--algorithm", choices=["Hough", "GC"], default=None)
    p.add_argument("--model_ss", type=float, default=None)
    p.add_argument("--scene_ss", type=float, default=None)
    p.add_argument("--rf_rad", type=float, default=None)
    p.add_argument("--descr_rad", type=float, default=None)
    p.add_argument("--cg_size", type=float, default=None)
    p.add_argument("--cg_thresh", type=float, default=None)
    p.add_argument("--match_threshold", type=float, default=None)
    p.add_argument("--scene_capacity", type=int, default=None)
    p.add_argument("--final_icp", type=int, default=None,
                   dest="final_icp_iterations",
                   help="iterations of composed-pose ICP on the full CAD "
                        "(SHOT_demo's chained refinement; 0 disables)")
    p.add_argument("--no-segment", action="store_true",
                   help="disable region-growing scene segmentation")
    p.add_argument("--rg_backend", choices=["graph", "voxel"], default=None,
                   help="region-growing backend for unorganized scenes: "
                        "'graph' = PCL-style kNN graph; 'voxel' = coarse "
                        "3-D lattice (not ported yet)")
    p.add_argument("-k", dest="use_keypoints", action="store_true",
                   help="(reference -k) show/use keypoints — accepted for parity")
    p.add_argument("-c", dest="show_correspondences", action="store_true",
                   help="(reference -c) visualize correspondence lines")
    p.add_argument("-r", dest="use_resolution", action="store_true",
                   help="(reference -r) scale radii by cloud resolution")


def _config_from_args(args):
    from tpu_joints_torch.config import PRESETS

    cfg = PRESETS.get(args.preset)
    if cfg is None:
        sys.exit(f"unknown preset {args.preset!r}; choose from {sorted(PRESETS)}")
    over = {}
    if args.algorithm:
        over["algorithm"] = args.algorithm.lower()
    for name in ("model_ss", "scene_ss", "rf_rad", "descr_rad", "cg_size",
                 "cg_thresh", "match_threshold", "scene_capacity",
                 "final_icp_iterations"):
        v = getattr(args, name)
        if v is not None:
            over[name] = v
    if getattr(args, "no_segment", False):
        over["segment_scene"] = False
    if getattr(args, "rg_backend", None):
        over["rg_backend"] = args.rg_backend
    return dataclasses.replace(cfg, **over) if over else cfg


def cmd_serve(args) -> None:
    """The streaming detector node as an HTTP server, on the card."""
    from tpu_joints_torch.modelbank.bank import load_bank
    from tpu_joints_torch.serve import serve_forever

    cfg = _config_from_args(args)
    warm = None
    if args.warm_depth:
        w, h = (int(v) for v in args.warm_depth.lower().split("x"))
        warm = (h, w)
    serve_forever(load_bank(args.bank), cfg, host=args.host, port=args.port,
                  grasp_offset=tuple(args.grasp_offset), warm_depth=warm,
                  batch_max=args.batch_max)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpu_joints_torch",
        description="6D pose estimation for industrial pipe joints on an "
                    "NVIDIA GPU",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="HTTP detection server")
    p.add_argument("--bank", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8337)
    p.add_argument("--grasp_offset", type=float, nargs=3, default=[0.0, 0.0, 0.0],
                   help="added to the model centroid before replying "
                        "(the reference offsets x+1, z-0.8)")
    p.add_argument("--warm-depth", dest="warm_depth", default=None,
                   metavar="WxH",
                   help="run the depth-frame path once at startup for this "
                        "sensor shape (e.g. 640x480)")
    p.add_argument("--batch-max", dest="batch_max", type=int, default=1,
                   help="micro-batch up to N concurrent depth frames into "
                        "one pass (1 = streaming)")
    _add_reference_flags(p)
    p.set_defaults(fn=cmd_serve)

    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
