"""Per-stage time of the port's detection paths on one CUDA card.

    python -m tpu_joints_torch.breakdown [--runs 10] [--paths organized,generic,segmented,two-part,instances,hv,batch,fpfh]

Builds the 42-view bench bank on the card (and, for the two-part path, the
two 42-view part banks), then for each path — the organized
``detect_organized`` chain on a 640×480 frame with the bench config, the
generic ``detect`` chain on the same frame's points as a 2560-point cloud
with ``synthetic.generic_config``, the segmented ``detect_organized`` chain
on the frame with the table (``synthetic.segmented_config``: its crop chain
split into tile select + node normals, plane removal, lattice region
growing, curvature filter + compaction) and the two-part
``detect_parts_organized`` chain on that frame
(``synthetic.two_part_config``, the 84-view concatenated bank), and, when
asked for, the two-instance frame with ``synthetic.multi_instance_config``
(``instances``), the same with the hypothesis verification on (``hv``:
``synthetic.hv_config``; the verification also alone),
``detect_organized_batch`` on the bench's 8 jittered frames (``batch``) and
the FPFH chain on the frame with the table (``fpfh``: its 42-view bank,
``synthetic.fpfh_bank_recipe``, built on the card, and
``synthetic.fpfh_config``, split like the segmented chain) —
runs its stages one after another, synchronising after each:

* wall ms: median over ``--runs`` warm runs of the host clock around the
  stage (launch overhead included);
* device ms and device operations: the profiler's kernel, copy and fill
  time and count of the stage in one more run;

then the whole chain unsynchronised: median, quartiles, min and max wall
ms, device busy ms per frame and peak device memory. The segmented path is
also run end to end with the lattice region growing never reading the host
(all 64 sweeps, ``segment.organized.SWEEPS_PER_CHECK = 0``) beside its
default of one read per 8 sweeps. Every path runs its eager chain (the
captured graphs of ``core/graphs.py`` are timed by ``chip_smoke.py`` phase
17). Every line names the card and its power limit. Needs a CUDA device;
raises without one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
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


@contextlib.contextmanager
def _sweeps_per_check(lattice, per_check):
    """Run the lattice region growing with another sweep schedule."""
    default = lattice.SWEEPS_PER_CHECK
    lattice.SWEEPS_PER_CHECK = per_check
    try:
        yield
    finally:
        lattice.SWEEPS_PER_CHECK = default


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--paths", default="organized,generic,segmented,two-part")
    args = ap.parse_args()
    want = args.paths.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("the breakdown needs a CUDA device")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import SENTINEL, Cloud, make_cloud
    from tpu_joints_torch.features.normals import estimate_normals
    from tpu_joints_torch.modelbank.bank import build_bank
    D = importlib.import_module("tpu_joints_torch.pipelines.detect")
    from tpu_joints_torch.pipelines import ingest as I
    from tpu_joints_torch.pipelines import multi
    from tpu_joints_torch.pipelines.ingest import ingest_organized_blocks
    from tpu_joints_torch.segment import organized as lattice
    from tpu_joints_torch.segment.region_growing import (
        cluster_curvature_filter, region_growing)
    from tpu_joints_torch.segment.sac import dominant_plane

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

    def organized_head(img, val, c, clo, chi):
        return [
            ("ingest", lambda: put(ing=ingest_organized_blocks(
                img, val, block=4, half_window=5, capacity=c.scene_capacity,
                crop_lo=clo, crop_hi=chi))),
            ("prepare", lambda: put(feats=D.prepare_scene(
                s["ing"][0], c, None, s["ing"][1], s["ing"][2]))),
        ]

    organized = organized_head(xyz, valid, org_cfg, lo, hi)
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
    seg_cfg, two_cfg = syn.segmented_config(), syn.two_part_config()
    tab_h, tab_valid_h = syn.frame(T_gt, 42, with_table=True)
    tab = torch.as_tensor(tab_h, device=dev)
    tab_valid = torch.as_tensor(tab_valid_h, device=dev)
    vp0 = torch.zeros(3, device=dev)

    def nodes():
        x, y, z, mask, pix, got, _ = s["tiles"]
        txyz, tnorm, tcurv, got = I._moment_normals(x, y, z, mask, pix, got,
                                                    5, vp0)
        put(txyz=txyz, tnorm=tnorm, tcurv=tcurv, got=got)

    def plane(c):
        got = s["got"]
        cloud = Cloud(xyz=torch.where(got[:, None], s["txyz"], SENTINEL),
                      mask=got, rgb=torch.zeros_like(s["txyz"]))
        put(got2=got & ~dominant_plane(cloud, s["tnorm"], c.plane_dist,
                                       c.plane_min_fraction))

    def grow(c):
        put(clusters=I._grow_lattice(s["txyz"], s["tnorm"], s["tcurv"],
                                     s["got2"], 120, 160, c))

    def compact(c):
        keep = cluster_curvature_filter(s["clusters"], s["tcurv"], s["got2"],
                                        c.cluster_max_curvature)
        put(ing=I._compact_nodes(s["txyz"], s["tnorm"], s["tcurv"], keep,
                                 c.scene_capacity))

    def segmented_head(c):
        return [
            ("tile select", lambda: put(tiles=I._tile_select(
                tab, tab_valid, 4, lo, hi))),
            ("node normals", nodes),
            ("plane removal", lambda: plane(c)),
            ("lattice region growing", lambda: grow(c)),
            ("curvature filter + compaction", lambda: compact(c)),
            ("prepare", lambda: put(feats=D.prepare_scene(
                s["ing"][0], D._strip_crop(c), None, s["ing"][1],
                s["ing"][2]))),
        ]

    paths = [("organized", org_cfg, organized, bank, 1),
             ("generic", gen_cfg, generic, bank, 1),
             ("segmented", seg_cfg, segmented_head(seg_cfg), bank, 1)]
    if "two-part" in want:
        part_banks = syn.build_part_banks(two_cfg, device=dev)
        _, cat = multi._cat_for_parts(part_banks)
        paths.append(("two-part", two_cfg, segmented_head(two_cfg), cat, 2))
    two_h, two_valid_h, _, _ = syn.two_instance_frame()
    two = torch.as_tensor(two_h, device=dev)
    two_valid = torch.as_tensor(two_valid_h, device=dev)
    wlo = torch.as_tensor(syn.WIDE_LO, device=dev)
    whi = torch.as_tensor(syn.WIDE_HI, device=dev)
    multi_cfg, hv_cfg = syn.multi_instance_config(), syn.hv_config()
    n_batch = 8
    imgs = torch.as_tensor(syn.batch_frames(xyz_h, n_batch), device=dev)
    valids = valid[None].expand(n_batch, -1, -1).contiguous()
    if "fpfh" in want:
        fp_cfg = syn.fpfh_config()
        fbank = build_bank(syn.joint_model(), **syn.fpfh_bank_recipe(fp_cfg),
                           device=dev)
        paths.append(("fpfh", fp_cfg, segmented_head(fp_cfg), fbank, 1))
    paths += [("instances", multi_cfg,
               organized_head(two, two_valid, multi_cfg, wlo, whi), bank, 1),
              ("hv", hv_cfg, organized_head(two, two_valid, hv_cfg, wlo, whi),
               bank, 1),
              ("batch", org_cfg, organized_head(imgs, valids, org_cfg, lo, hi),
               bank, 1)]
    for label, c, head, b, n_parts in paths:
        if label not in want:
            continue
        c = D._strip_crop(c) if label in ("segmented", "two-part",
                                          "fpfh") else c
        tail = [
            ("match", lambda c=c, b=b: put(corrs=D.match_bank(
                s["feats"].desc, s["feats"].desc_valid, b.desc,
                b.key_valid, c))),
            ("group", lambda c=c, b=b: put(inst=D._group_all_views(
                s["feats"], b, s["corrs"], c))),
            ("refine" + (" + clustered OBB (K2)" if c.obb_largest_cluster
                         else ""), lambda c=c, b=b, n=n_parts: put(
                res=D.refine_instances(
                    s["feats"], b, s["inst"],
                    s["corrs"].valid.reshape(
                        n_batch if label == "batch" else 1, -1).sum(
                            1, dtype=torch.int32), c, n_parts=n))),
        ]
        if label == "hv":
            from tpu_joints_torch.recognize.hv import verify_hypotheses

            def verify(c=c, b=b):
                r = s["res"]
                verify_hypotheses(
                    *D._registered_views(b, r.cand_views, r.cand_poses),
                    r.cand_valid, s["feats"].cloud,
                    inlier_threshold=c.hv_inlier_threshold,
                    outlier_regularizer=c.hv_regularizer,
                    occlusion_threshold=c.hv_occlusion_threshold)

            tail.append(("hypothesis verification alone", verify))
        for name, wall, dev_ms, n in _stage_table(head + tail, args.runs):
            print(f"# breakdown {label} {name}: wall {wall:.3f} ms (median of "
                  f"{args.runs}, synced per stage), device {dev_ms:.3f} ms, "
                  f"{n} device operations [{smi}]", flush=True)
        geo = dict(block=4, half_window=5, crop_lo=lo, crop_hi=hi)
        run = {
            "organized": lambda: D.detect_organized(xyz, valid, bank, org_cfg,
                                                    **geo),
            "generic": lambda: D.detect(scene, bank, gen_cfg),
            "segmented": lambda: D.detect_organized(tab, tab_valid, bank,
                                                    seg_cfg, **geo),
            "two-part": lambda: multi._detect_parts_organized_eager(
                tab, tab_valid, part_banks, two_cfg, **geo),
            "instances": lambda: D.detect_organized(
                two, two_valid, bank, multi_cfg, block=4, half_window=5,
                crop_lo=wlo, crop_hi=whi),
            "hv": lambda: D.detect_organized(
                two, two_valid, bank, hv_cfg, block=4, half_window=5,
                crop_lo=wlo, crop_hi=whi),
            "batch": lambda: D._detect_organized_batch_eager(
                imgs, valids, bank, org_cfg, **geo),
            "fpfh": lambda: D.detect_organized(tab, tab_valid, b,
                                               syn.fpfh_config(), **geo),
        }[label]
        default = lattice.SWEEPS_PER_CHECK
        # the segmented chain also with the lattice region growing never
        # reading the host (64 sweeps), before and after the default, in turns
        schedules = (0, default, default, 0) if label == "segmented" \
            else (default,)
        for per_check in schedules:
            note = "" if per_check else " (no host read, 64 sweeps)"
            with _sweeps_per_check(lattice, per_check):
                med, q1, q3, mn, mx, busy, n, mem = _end_to_end(
                    run, 2 * args.runs)
            print(f"# breakdown {label} end to end{note}: median {med:.3f} ms "
                  f"(quartiles {q1:.3f} / {q3:.3f}, min {mn:.3f}, max "
                  f"{mx:.3f}, n = {2 * args.runs}); device busy {busy:.3f} ms "
                  f"per {'batch of 8' if label == 'batch' else 'frame'}, {n} "
                  f"device operations; peak device memory "
                  f"{mem:.1f} MiB [{smi}]", flush=True)
        if label == "segmented":
            for per_check in schedules:
                with _sweeps_per_check(lattice, per_check):
                    (_, wall, dev_ms, n), = _stage_table(
                        [("grow", lambda: grow(c))], args.runs)
                how = (f"{per_check} sweeps per host read" if per_check
                       else "no host read, 64 sweeps")
                print(f"# breakdown lattice region growing alone, {how}: wall "
                      f"{wall:.3f} ms (median of {args.runs}), device "
                      f"{dev_ms:.3f} ms, {n} device operations [{smi}]",
                      flush=True)


if __name__ == "__main__":
    main()
