"""Per-stage time of the port's two detection paths on one CUDA card.

    python -m tpu_joints_torch.breakdown [--runs 10]

Builds the 42-view bench bank on the card, then for each path — the
organized ``detect_organized`` chain on a 640×480 frame with the bench
config, and the generic ``detect`` chain on the same frame's points as a
2560-point cloud with ``synthetic.generic_config`` — runs its stages one
after another, synchronising after each:

* wall ms: median over ``--runs`` warm runs of the host clock around the
  stage (launch overhead included);
* device ms and device operations: the profiler's kernel, copy and fill
  time and count of the stage in one more run;

then the whole chain unsynchronised: median, quartiles, min and max wall
ms, device busy ms per frame and peak device memory. Every line names the
card and its power limit. Needs a CUDA device; raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _device(fn):
    """(device ms, device operations) of one call of ``fn``: the profiler's
    kernel, copy and fill time and count (entries without device time, the
    runtime's launch calls, are not counted)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in ka) / 1e3,
            sum(e.count for e in ka))


def _stage_table(stages, runs):
    """[(name, fn)] run in order, each fed the previous outputs through the
    closures → rows of (name, wall ms median, device ms, device
    operations)."""
    walls = {n: [] for n, _ in stages}
    for _ in range(runs + 2):
        for name, fn in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    return [(name, statistics.median(walls[name][2:]), *_device(fn))
            for name, fn in stages]


def _end_to_end(run, runs):
    for _ in range(2):
        run()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    busy, n = _device(run)
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    q = statistics.quantiles(times, n=4)
    return (statistics.median(times), q[0], q[2], min(times), max(times),
            busy, n, torch.cuda.max_memory_allocated() / 2**20)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("the breakdown needs a CUDA device")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.features.normals import estimate_normals
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines import detect as D
    from tpu_joints_torch.pipelines.ingest import ingest_organized_blocks
    from tpu_joints_torch.segment.region_growing import (
        cluster_curvature_filter, region_growing)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    cfg = syn.bench_config()
    org_cfg = dataclasses.replace(cfg, segment_scene=False, remove_plane=False)
    gen_cfg = syn.generic_config()
    bank = build_bank(syn.joint_model(), **syn.bench_bank_kwargs(cfg), device=dev)
    T_gt = syn.bench_pose()
    xyz_h, valid_h = syn.frame(T_gt, 42, with_table=False)
    xyz = torch.as_tensor(xyz_h, device=dev)
    valid = torch.as_tensor(valid_h, device=dev)
    lo = torch.as_tensor(syn.CROP_LO, device=dev)
    hi = torch.as_tensor(syn.CROP_HI, device=dev)
    scene = make_cloud(syn.scene_points(xyz_h[valid_h], gen_cfg.scene_capacity),
                       capacity=gen_cfg.scene_capacity, device=dev)
    s = {}

    def put(**kw):
        s.update(kw)

    organized = [
        ("ingest", lambda: put(ing=ingest_organized_blocks(
            xyz, valid, block=4, half_window=5,
            capacity=org_cfg.scene_capacity, crop_lo=lo, crop_hi=hi))),
        ("prepare", lambda: put(feats=D.prepare_scene(
            s["ing"][0], org_cfg, None, s["ing"][1], s["ing"][2]))),
    ]
    bare = dataclasses.replace(gen_cfg, segment_scene=False)
    generic = [
        ("normals (K2)", lambda: put(nc=estimate_normals(
            scene, k=gen_cfg.normal_k))),
        ("region growing (K2)", lambda: put(clusters=region_growing(
            scene, *s["nc"], k=min(30, gen_cfg.normal_k),
            smoothness_deg=gen_cfg.rg_smoothness_deg,
            curvature_threshold=gen_cfg.rg_curvature,
            min_cluster_size=gen_cfg.rg_min_cluster,
            max_edge=gen_cfg.rg_max_edge))),
        ("curvature filter", lambda: put(crop=scene.with_mask(
            cluster_curvature_filter(s["clusters"], s["nc"][1], scene.mask,
                                     gen_cfg.cluster_max_curvature)))),
        ("features", lambda: put(feats=D.prepare_scene(
            s["crop"], bare, None, *s["nc"]))),
    ]
    for label, c, head in (("organized", org_cfg, organized),
                           ("generic", gen_cfg, generic)):
        tail = [
            ("match", lambda c=c: put(corrs=D.match_bank(
                s["feats"].desc, s["feats"].desc_valid, bank.desc,
                bank.key_valid, c))),
            ("group", lambda c=c: put(inst=D._group_all_views(
                s["feats"], bank, s["corrs"], c))),
            ("refine" + (" + clustered OBB (K2)" if c.obb_largest_cluster
                         else ""), lambda c=c: put(res=D.refine_instances(
                s["feats"], bank, s["inst"], s["corrs"].count(), c))),
        ]
        for name, wall, dev_ms, n in _stage_table(head + tail, args.runs):
            print(f"# breakdown {label} {name}: wall {wall:.3f} ms (median of "
                  f"{args.runs}, synced per stage), device {dev_ms:.3f} ms, "
                  f"{n} device operations [{smi}]", flush=True)
        if label == "organized":
            def run():
                return D.detect_organized(xyz, valid, bank, org_cfg, block=4,
                                          half_window=5, crop_lo=lo, crop_hi=hi)
        else:
            def run():
                return D.detect(scene, bank, gen_cfg)
        med, q1, q3, mn, mx, busy, n, mem = _end_to_end(run, 2 * args.runs)
        print(f"# breakdown {label} end to end: median {med:.3f} ms (quartiles "
              f"{q1:.3f} / {q3:.3f}, min {mn:.3f}, max {mx:.3f}, n = "
              f"{2 * args.runs}); device busy {busy:.3f} ms per frame, {n} "
              f"device operations; peak device memory {mem:.1f} MiB [{smi}]",
              flush=True)


if __name__ == "__main__":
    main()
