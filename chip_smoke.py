#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its paths on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
  1. device  — card name and power limit (nvidia-smi);
  2. build   — compiles kernels K1 (nn1.cu) and K2 (knnk.cu) from the
               checkout, one nvcc each, started together;
  3. kernels — K1 and K2 against their plain PyTorch versions on the card
               at the paths' shapes and at edge cases; K1 timed;
  4. bank    — the 42-view SHOT bank of bench.py built on the card: K2
               launches counted (the k=16 normals, one per view) and every
               launch's inputs rechecked against the plain version;
  5. organized path — detect_organized on a 640×480 frame of the bench
               joint with bench.py's scene_latency config: K1 launches and
               host syncs over one run (none allowed), latency over 10
               runs, gate < 1° / < 5 mm, and the same chain at small size
               against the CPU path;
  6. generic path — detect on the same frame's points as an unorganized
               2560-point cloud (the CLI's recipe) with the SHOT_demo-shaped
               config: K1 and K2 launches and host syncs over one run (syncs
               must equal the region-growing schedule's reads), every K2
               launch rechecked, K2 timed at the region-growing and
               clustered-OBB shapes against its plain version and
               cdist+topk, latency over 10 runs, the gate, and the same path
               at small size against the CPU path.
The kernels JSON line and then the card's nvidia-smi name and power limit
come before the last line, which is the JSON result.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import time
import warnings

# H100 SXM published peaks at 700 W (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _err(T, G):
    import numpy as np

    Rd = T[:3, :3] @ G[:3, :3].T
    rot = math.degrees(math.acos(float(np.clip((np.trace(Rd) - 1) / 2, -1, 1))))
    return rot, float(np.linalg.norm(T[:3, 3] - G[:3, 3]))


def _cuda_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, reps):
    """Device time per call of ``fn``: the profiler's sum of kernel time
    over ``reps`` calls (host launch gaps excluded), after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / reps / 1000.0


def _bound(M, N, k):
    """(ms, what bounds it): the least time the card could take for an
    exact kNN of M queries over N sources — each input read once (xyz
    float32, mask byte), each output written once (float32 + int32 per
    slot), 9 fp32 flops per (query, source) pair for the difference-form
    distance — at the published peaks."""
    t_bytes = (12 * M + 13 * N + 8 * M * k) / HBM_BYTES_PER_S
    t_ops = 9 * M * N / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _time_knn(kernel, plain, q, s, m, k, card, label):
    """CUDA-event and profiler times of a kernel, its plain version and
    cdist+topk (two PyTorch calls, unmasked) on the same inputs."""
    import torch

    fns = {"kernel": lambda: kernel(q, s, m),
           "plain": lambda: plain(q, s, m),
           "cdist+topk": lambda: torch.cdist(q, s).topk(k, largest=False)}
    ev = {n: _cuda_ms(f, 20) for n, f in fns.items()}
    dv = {n: _device_ms(f, 20) for n, f in fns.items()}
    bound_ms, bound_by = _bound(q.shape[0], s.shape[0], k)
    print(f"# timing {label} {q.shape[0]}x{s.shape[0]} k={k}: median of 20 "
          f"CUDA-event runs: " + ", ".join(f"{n} {v:.4f} ms" for n, v in ev.items())
          + "; device time per call (profiler, 20 calls): "
          + ", ".join(f"{n} {v:.4f} ms" for n, v in dv.items())
          + f"; bound {bound_ms:.5f} ms ({bound_by}) {card}", flush=True)
    return ev, dv, bound_ms, bound_by


class _Recorder:
    """Wraps ``bruteforce.knnk`` (K2's entry from ``knn``) and keeps every
    call's inputs, so each launch of a path can be rechecked afterwards.
    It launches nothing itself: the wrapped function counts the launches."""

    def __init__(self, bruteforce):
        self.bf, self.real, self.calls = bruteforce, bruteforce.knnk, []

    def __call__(self, query, source, k, source_mask=None):
        self.calls.append((query, source, k, source_mask))
        return self.real(query, source, k, source_mask)

    def __enter__(self):
        self.bf.knnk = self
        return self

    def __exit__(self, *exc):
        self.bf.knnk = self.real


def _check_k2(pk, q, s, k, m, label, card):
    """K2 against its plain version on the same card inputs: 0 index
    mismatches and 0.0 distance difference, ascending rows."""
    import torch

    d, i = pk.knnk(q, s, k, m)
    dr, ir = pk.knnk_reference(q, s, k, m)
    torch.cuda.synchronize()
    mism = int((i != ir).sum())
    err = float((d - dr).abs().max()) if d.numel() else 0.0
    print(f"# K2 {q.shape[0]}x{s.shape[0]} k={k} ({label}): index mismatches "
          f"{mism}, max |dist diff| {err:.3e} {card}", flush=True)
    if mism or err > 0.0 or not bool((d[:, 1:] >= d[:, :-1]).all()):
        raise RuntimeError(f"knnk disagrees with its plain version ({label})")
    return err


def _small_runs(dev, det_cfg, gen_cfg, T_gt, card):
    """The organized and the generic path at small size (320×240 frame,
    level-0 bank) on the card and on the CPU (plain versions): poses within
    2e-3, both accepted, both within the gate."""
    import numpy as np
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.config import DetectionConfig
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect, detect_organized

    def small(cfg, capacity):
        return DetectionConfig(**{**dataclasses.asdict(cfg), "scene_ss": 0.03,
                                  "final_icp_iterations": 8,
                                  "scene_capacity": capacity,
                                  "scene_key_capacity": 256})

    s_org, s_gen = small(det_cfg, 3072), small(gen_cfg, 3072)
    model_s = syn.joint_model(3000, 1800)
    kw = dict(syn.bench_bank_kwargs(s_org), level=0, resolution=64,
              key_capacity=64, icp_capacity=1024)
    xs, vs = syn.frame(T_gt, 42, with_table=False, width=320, height=240)
    pts = syn.scene_points(xs[vs], 3072)
    out = {"organized": {}, "generic": {}}
    for d in (dev, torch.device("cpu")):
        b = build_bank(model_s, **kw, device=d)
        r, _ = detect_organized(
            torch.as_tensor(xs, device=d), torch.as_tensor(vs, device=d), b,
            s_org, block=2, half_window=3,
            crop_lo=torch.as_tensor(syn.CROP_LO, device=d),
            crop_hi=torch.as_tensor(syn.CROP_HI, device=d))
        out["organized"][d.type] = r
        r = detect(make_cloud(pts, capacity=3072, device=d), b, s_gen)
        out["generic"][d.type] = r
    for path, res in out.items():
        poses = {k: r.full_pose.cpu().numpy() for k, r in res.items()}
        diff = float(np.abs(poses["cuda"] - poses["cpu"]).max())
        errs = {k: _err(p, T_gt) for k, p in poses.items()}
        acc = {k: bool(r.accepted) for k, r in res.items()}
        views = {k: int(r.view_idx) for k, r in res.items()}
        print(f"# {path} path small 320x240, card vs CPU (plain versions): max "
              f"|full_pose diff| {diff:.3e}, view {views['cuda']} vs "
              f"{views['cpu']}, accepted {acc['cuda']} vs {acc['cpu']}, "
              f"rot/trans err card {errs['cuda'][0]:.3f} deg "
              f"{errs['cuda'][1] * 1000:.3f} mm, CPU {errs['cpu'][0]:.3f} deg "
              f"{errs['cpu'][1] * 1000:.3f} mm {card}", flush=True)
        # two views can carry the same true pose, so the winning view may
        # differ where their ranks tie to the last bits; the poses may not
        if diff > 2e-3 or not all(acc.values()) or any(
                r >= 1.0 or t >= 0.005 for r, t in errs.values()):
            raise RuntimeError(f"card and CPU disagree on the small {path} path")


def _timed_runs(run, n=10):
    import torch

    for _ in range(2):
        run()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    return res, times


def _gate(label, res, T_gt, times, card, extra=""):
    import numpy as np

    pose = res.full_pose.cpu().numpy()
    rot, trans = _err(pose, T_gt)
    accepted = bool(res.accepted)
    print(f"# {label}: median {statistics.median(times):.3f} ms "
          f"(min {min(times):.3f}, max {max(times):.3f}) over {len(times)} runs, "
          f"{extra}fitness {float(res.fitness):.3e}, full_fitness "
          f"{float(res.full_fitness):.3e}, accepted {accepted}, view "
          f"{int(res.view_idx)}, rot_err {rot:.3f} deg, trans_err "
          f"{trans * 1000:.3f} mm {card}", flush=True)
    if pose.shape != (4, 4) or not np.isfinite(pose).all():
        raise RuntimeError(f"bad pose {pose}")
    if not (accepted and rot < 1.0 and trans < 0.005):
        raise RuntimeError(f"{label} missed the gate: accepted={accepted} "
                           f"rot={rot:.2f} deg trans={trans * 1000:.1f} mm")


def _count_syncs(fn):
    """Run ``fn`` once with synchronisation warnings on; return its result
    and the flagged host synchronisations."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [str(w.message).splitlines()[0] for w in caught
                 if "synchroniz" in str(w.message)]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.neighbors import bruteforce
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines.detect import detect, detect_organized
    from tpu_joints_torch.segment import region_growing as rg

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"# phase 1 device: {kind}; nvidia-smi: {smi}", flush=True)

    # --- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    pk.build_all()
    print(f"# phase 2 build: nn1.cu and knnk.cu compiled (in parallel) and "
          f"bound in {time.perf_counter() - t0:.3f} s {card}", flush=True)

    # --- phase 3: kernels vs plain versions on the card --------------------
    g = torch.Generator().manual_seed(0)

    def pts(n):
        return torch.randn(n, 3, generator=g).to(dev)

    def msk(n, masked):
        return (torch.rand(n, generator=g) >= masked).to(dev)

    max_err_k1 = 0.0
    for M, N, masked, label in [(8192, 2560, 0.0, "ICP"),
                                (40960, 2048, 0.0, "tier-1 coverage"),
                                (10240, 4096, 0.0, "tier-2 coverage"),
                                (70, 100, 0.25, "25% of sources masked"),
                                (5000, 3333, 0.1, "N not a multiple of the tile"),
                                (64, 256, 1.0, "all sources masked")]:
        q, s, m = pts(M), pts(N), msk(N, masked)
        d, i = pk.nn1(q, s, m)
        dr, ir = pk.nn1_reference(q, s, m)
        torch.cuda.synchronize()
        mism = int((i != ir).sum())
        err = float((d - dr).abs().max())
        max_err_k1 = max(max_err_k1, err)
        print(f"# phase 3 K1 {M}x{N} ({label}): index mismatches {mism}, "
              f"max |dist diff| {err:.3e} {card}", flush=True)
        if mism or err > 0.0 or not bool(torch.isfinite(d).all()):
            raise RuntimeError(f"nn1 disagrees with its plain version at {M}x{N}")
    max_err_k2 = 0.0
    for M, N, k, masked, label in [
            (2560, 2560, 16, 0.0, "region-growing shape, random points"),
            (2560, 2560, 2, 0.0, "k = 2"),
            (2560, 2560, 32, 0.0, "k = 32"),
            (100, 20, 32, 0.0, "N < k"),
            (64, 256, 8, 1.0, "all sources masked"),
            (70, 100, 16, 0.25, "25% of sources masked"),
            (5000, 3333, 16, 0.1, "N not a multiple of the tile"),
            (1001, 2048, 8, 0.0, "M not a multiple of the block")]:
        q, s, m = pts(M), pts(N), msk(N, masked)
        max_err_k2 = max(max_err_k2, _check_k2(pk, q, s, k, m, label, card))
        if label == "N < k" or masked == 1.0:
            d, i = pk.knnk(q, s, k, m)
            empty = slice(N, None) if masked < 1.0 else slice(None)
            if not (bool((d[:, empty] == np.float32(3e38)).all())
                    and bool((i[:, empty] == 0).all())):
                raise RuntimeError(f"knnk empty slots are not (3e38, 0) ({label})")
    # exact ties: every source twice, queries on sources; the lower index wins
    s = pts(512).repeat(2, 1)
    q = torch.cat([s[:256], pts(256)])
    max_err_k2 = max(max_err_k2, _check_k2(
        pk, q, s, 16, msk(1024, 0.0), "duplicated sources, exact ties", card))
    d, i = pk.knnk(q, s, 16, None)
    if not bool((i[:256, 0] == torch.arange(256, device=dev)).all()):
        raise RuntimeError("knnk does not break exact ties to the lowest index")
    q, s = pts(8192), pts(2560)
    m = torch.ones(2560, dtype=torch.bool, device=dev)
    ev1, dv1, bound1, by1 = _time_knn(pk.nn1, pk.nn1_reference, q, s, m, 1,
                                      card, "phase 3 K1 (ICP shape)")

    # --- phase 4: the 42-view bank on the card ----------------------------
    cfg = syn.bench_config()
    det_cfg = dataclasses.replace(cfg, segment_scene=False, remove_plane=False)
    torch.cuda.synchronize()
    pk.knnk.launches = 0
    t0 = time.perf_counter()
    with _Recorder(bruteforce) as rec:
        bank = build_bank(syn.joint_model(), **syn.bench_bank_kwargs(cfg),
                          device=dev)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    bank_k2 = pk.knnk.launches
    shapes = sorted({(c[0].shape[0], c[1].shape[0], c[2]) for c in rec.calls})
    print(f"# phase 4 bank: {bank.n_views} views, desc {tuple(bank.desc.shape)}, "
          f"view capacity Nv {bank.view_xyz.shape[1]}, "
          f"{int(bank.key_valid.sum())} valid keys, built in {bank_s:.2f} s; "
          f"K2 launched {bank_k2} times, at shapes (M, N, k) {shapes} {card}",
          flush=True)
    if bank_k2 != bank.n_views or len(rec.calls) != bank_k2:
        raise RuntimeError(f"bank build launched K2 {bank_k2} times, expected "
                           f"one per view ({bank.n_views})")
    for n, (q, s, k, m) in enumerate(rec.calls):
        max_err_k2 = max(max_err_k2, _check_k2(pk, q, s, k, m,
                                               f"bank view {n} normals", card))

    # --- phase 5: the organized path --------------------------------------
    T_gt = syn.bench_pose()
    xyz_h, valid_h = syn.frame(T_gt, 42, with_table=False)
    xyz_img = torch.as_tensor(xyz_h, device=dev)
    valid = torch.as_tensor(valid_h, device=dev)
    lo = torch.as_tensor(syn.CROP_LO, device=dev)
    hi = torch.as_tensor(syn.CROP_HI, device=dev)

    def run_org():
        return detect_organized(xyz_img, valid, bank, det_cfg, block=4,
                                half_window=5, crop_lo=lo, crop_hi=hi)

    pk.nn1.launches = pk.knnk.launches = 0
    (res, n_sel), syncs = _count_syncs(run_org)
    org_k1, org_k2 = pk.nn1.launches, pk.knnk.launches
    print(f"# phase 5 organized path: nn1 launched {org_k1} times, knnk "
          f"{org_k2} times in one detect_organized; host synchronisations "
          f"flagged: {len(syncs)} {card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    if org_k1 == 0:
        raise RuntimeError("the organized path never launched kernel K1")
    if syncs:
        raise RuntimeError("detect_organized synchronised with the host")
    (res, n_sel), times = _timed_runs(run_org)
    _gate("phase 5 organized 640x480", res, T_gt, times, card,
          f"n_selected {int(n_sel)}, ")

    # --- phase 6: the generic path ----------------------------------------
    gen_cfg = syn.generic_config()
    scene = make_cloud(syn.scene_points(xyz_h[valid_h], gen_cfg.scene_capacity),
                       capacity=gen_cfg.scene_capacity, device=dev)

    def run_gen():
        return detect(scene, bank, gen_cfg)

    pk.nn1.launches = pk.knnk.launches = 0
    rg.region_growing.host_checks = 0
    with _Recorder(bruteforce) as rec:
        res, syncs = _count_syncs(run_gen)
    gen_k1, gen_k2 = pk.nn1.launches, pk.knnk.launches
    checks = rg.region_growing.host_checks
    print(f"# phase 6 generic path ({int(scene.mask.sum())} points): nn1 "
          f"launched {gen_k1} times, knnk {gen_k2} times in one detect; host "
          f"synchronisations flagged: {len(syncs)}, region-growing host reads "
          f"(one per 8 sweeps): {checks} {card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    if gen_k1 == 0 or gen_k2 != 4 or len(rec.calls) != 4:
        raise RuntimeError(f"the generic path launched K1 {gen_k1} and K2 "
                           f"{gen_k2} times; expected K1 >= 1 and K2 = 4")
    if len(syncs) != checks:
        raise RuntimeError(f"{len(syncs)} host syncs flagged, but the region "
                           f"growing schedule reads {checks} times")
    labels = ["scene normals", "region-growing graph", "clustered-OBB normals",
              "clustered-OBB graph"]
    for (q, s, k, m), label in zip(rec.calls, labels):
        max_err_k2 = max(max_err_k2, _check_k2(pk, q, s, k, m, label, card))
    q, s, k, m = rec.calls[1]
    ev2, dv2, bound2, by2 = _time_knn(
        lambda a, b, c: pk.knnk(a, b, k, c),
        lambda a, b, c: pk.knnk_reference(a, b, k, c), q, s, m, k, card,
        "phase 6 K2 (region-growing graph)")
    q, s, k, m = rec.calls[3]
    nv = q.shape[0]
    max_err_k2 = max(max_err_k2, _check_k2(
        pk, pts(nv), pts(nv), k, msk(nv, 0.3), "OBB shape, random points", card))
    _time_knn(lambda a, b, c: pk.knnk(a, b, k, c),
              lambda a, b, c: pk.knnk_reference(a, b, k, c), q, s, m, k, card,
              "phase 6 K2 (clustered-OBB graph)")
    res, times = _timed_runs(run_gen)
    _gate("phase 6 generic 640x480", res, T_gt, times, card,
          f"scene points after the crop {int(res.metrics['scene_points'])}, ")

    # --- both paths at small size, card vs CPU ----------------------------
    _small_runs(dev, det_cfg, gen_cfg, T_gt, card)

    print(json.dumps({"kernels": [
        {"name": "nn1", "route": "cuda",
         "source": "tpu_joints_torch/neighbors/csrc/nn1.cu",
         "replaces": "tpu_joints/neighbors/pallas_knn.py:59",
         "launches": org_k1, "max_abs_err": max_err_k1,
         "ms": ev1["kernel"], "plain_ms": ev1["plain"], "bound_ms": bound1,
         "bound_by": by1, "library_ms": None,
         "cdist_topk_ms": ev1["cdist+topk"]},
        {"name": "knnk", "route": "cuda",
         "source": "tpu_joints_torch/neighbors/csrc/knnk.cu",
         "replaces": "tpu_joints/neighbors/pallas_knn.py:65",
         "launches": gen_k2, "max_abs_err": max_err_k2,
         "ms": ev2["kernel"], "plain_ms": ev2["plain"], "bound_ms": bound2,
         "bound_by": by2, "library_ms": None,
         "cdist_topk_ms": ev2["cdist+topk"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
