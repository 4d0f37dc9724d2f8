#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
  1. device  — card name and power limit (nvidia-smi);
  2. build   — compiles kernel K1 (nn1.cu, nvcc sm_90a) from the checkout;
  3. kernel  — K1 against its plain PyTorch version on the card at the main
               path's shapes and at edge cases, then both timed;
  4. bank    — the 42-view SHOT bank of bench.py built on the card;
  5. slice   — detect_organized on a 640×480 frame of the bench joint with
               bench.py's scene_latency config: launches of K1 counted over
               one run, latency over 10 runs, accuracy gate < 1° / < 5 mm,
               and the same chain at small size against the CPU path.
The line before the last holds the card's nvidia-smi name and power
limit; the last line is the JSON result.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import time
import warnings


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


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.config import DetectionConfig
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.neighbors import pallas_knn as k1
    from tpu_joints_torch.pipelines.detect import detect_organized

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"# phase 1 device: {kind}; nvidia-smi: {smi}", flush=True)

    # --- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    k1.load_library()
    print(f"# phase 2 build: nn1.cu compiled and bound in "
          f"{time.perf_counter() - t0:.3f} s {card}", flush=True)

    # --- phase 3: kernel vs plain version on the card ---------------------
    g = torch.Generator().manual_seed(0)
    max_err = 0.0
    for M, N, masked, label in [(8192, 2560, 0.0, "ICP"),
                                (40960, 2048, 0.0, "tier-1 coverage"),
                                (10240, 4096, 0.0, "tier-2 coverage"),
                                (70, 100, 0.25, "25% of sources masked"),
                                (5000, 3333, 0.1, "N not a multiple of the tile"),
                                (64, 256, 1.0, "all sources masked")]:
        q = torch.randn(M, 3, generator=g).to(dev)
        s = torch.randn(N, 3, generator=g).to(dev)
        m = (torch.rand(N, generator=g) >= masked).to(dev)
        d, i = k1.nn1(q, s, m)
        dr, ir = k1.nn1_reference(q, s, m)
        torch.cuda.synchronize()
        mism = int((i != ir).sum())
        err = float((d - dr).abs().max())
        max_err = max(max_err, err)
        print(f"# phase 3 kernel {M}x{N} ({label}): index mismatches {mism}, "
              f"max |dist diff| {err:.3e} {card}", flush=True)
        if mism or err > 0.0 or not bool(torch.isfinite(d).all()):
            raise RuntimeError(f"nn1 disagrees with its plain version at {M}x{N}")
    q = torch.randn(8192, 3, generator=g).to(dev)
    s = torch.randn(2560, 3, generator=g).to(dev)
    m = torch.ones(2560, dtype=torch.bool, device=dev)
    ms_kernel = _cuda_ms(lambda: k1.nn1(q, s, m), 20)
    ms_plain = _cuda_ms(lambda: k1.nn1_reference(q, s, m), 20)
    dev_kernel = _device_ms(lambda: k1.nn1(q, s, m), 20)
    dev_plain = _device_ms(lambda: k1.nn1_reference(q, s, m), 20)
    print(f"# phase 3 timing 8192x2560, median of 20 CUDA-event runs: "
          f"kernel {ms_kernel:.4f} ms, plain PyTorch {ms_plain:.4f} ms; "
          f"device time per call (profiler, 20 calls): kernel "
          f"{dev_kernel:.4f} ms, plain {dev_plain:.4f} ms {card}", flush=True)

    # --- phase 4: the 42-view bank on the card ----------------------------
    cfg = syn.bench_config()
    det_cfg = dataclasses.replace(cfg, segment_scene=False, remove_plane=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = build_bank(syn.joint_model(), **syn.bench_bank_kwargs(cfg), device=dev)
    torch.cuda.synchronize()
    print(f"# phase 4 bank: {bank.n_views} views, desc {tuple(bank.desc.shape)}, "
          f"{int(bank.key_valid.sum())} valid keys, built in "
          f"{time.perf_counter() - t0:.2f} s {card}", flush=True)

    # --- phase 5: the slice ----------------------------------------------
    T_gt = syn.bench_pose()
    xyz_h, valid_h = syn.frame(T_gt, 42, with_table=False)
    xyz_img = torch.as_tensor(xyz_h, device=dev)
    valid = torch.as_tensor(valid_h, device=dev)
    lo = torch.as_tensor(syn.CROP_LO, device=dev)
    hi = torch.as_tensor(syn.CROP_HI, device=dev)

    def run():
        return detect_organized(xyz_img, valid, bank, det_cfg, block=4,
                                half_window=5, crop_lo=lo, crop_hi=hi)

    torch.cuda.synchronize()
    k1.nn1.launches = 0
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, n_sel = run()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = k1.nn1.launches
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    print(f"# phase 5 main path: nn1 launched {launches} times in one "
          f"detect_organized; host synchronisations flagged: {len(syncs)} "
          f"{card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    if launches == 0:
        raise RuntimeError("the main path never launched kernel K1")
    if syncs:
        raise RuntimeError("detect_organized synchronised with the host")

    for _ in range(2):
        run()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, n_sel = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    pose = res.full_pose.cpu().numpy()
    rot, trans = _err(pose, T_gt)
    accepted = bool(res.accepted)
    print(f"# phase 5 slice 640x480: median {statistics.median(times):.3f} ms "
          f"(min {min(times):.3f}, max {max(times):.3f}) over 10 runs, "
          f"n_selected {int(n_sel)}, fitness {float(res.fitness):.3e}, "
          f"full_fitness {float(res.full_fitness):.3e}, accepted {accepted}, "
          f"view {int(res.view_idx)}, rot_err {rot:.3f} deg, "
          f"trans_err {trans * 1000:.3f} mm {card}", flush=True)
    if pose.shape != (4, 4) or not np.isfinite(pose).all():
        raise RuntimeError(f"bad pose {pose}")
    if not (accepted and rot < 1.0 and trans < 0.005):
        raise RuntimeError(f"slice missed the gate: accepted={accepted} "
                           f"rot={rot:.2f} deg trans={trans * 1000:.1f} mm")

    # the same chain at small size on the card and on the CPU (plain versions)
    small = DetectionConfig(**{**dataclasses.asdict(det_cfg), "scene_ss": 0.03,
                               "final_icp_iterations": 8,
                               "scene_capacity": 3072,
                               "scene_key_capacity": 256})
    model_s = syn.joint_model(3000, 1800)
    kw = dict(syn.bench_bank_kwargs(small), level=0, resolution=64,
              key_capacity=64, icp_capacity=1024)
    xs, vs = syn.frame(T_gt, 42, with_table=False, width=320, height=240)
    out = {}
    for d in (dev, torch.device("cpu")):
        b = build_bank(model_s, **kw, device=d)
        r, _ = detect_organized(
            torch.as_tensor(xs, device=d), torch.as_tensor(vs, device=d), b,
            small, block=2, half_window=3,
            crop_lo=torch.as_tensor(syn.CROP_LO, device=d),
            crop_hi=torch.as_tensor(syn.CROP_HI, device=d))
        out[d.type] = (r.full_pose.cpu().numpy(), int(r.view_idx),
                       bool(r.accepted))
    diff = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    errs = {k: _err(v[0], T_gt) for k, v in out.items()}
    print(f"# phase 5 small 320x240, card vs CPU (plain versions): max "
          f"|full_pose diff| {diff:.3e}, view {out['cuda'][1]} vs "
          f"{out['cpu'][1]}, accepted {out['cuda'][2]} vs {out['cpu'][2]}, "
          f"rot/trans err card {errs['cuda'][0]:.3f} deg "
          f"{errs['cuda'][1] * 1000:.3f} mm, CPU {errs['cpu'][0]:.3f} deg "
          f"{errs['cpu'][1] * 1000:.3f} mm {card}", flush=True)
    # two views can carry the same true pose, so the winning view may differ
    # where their ranks tie to the last bits; the poses may not
    if diff > 2e-3 or not (out["cuda"][2] and out["cpu"][2]) or any(
            r >= 1.0 or t >= 0.005 for r, t in errs.values()):
        raise RuntimeError("card and CPU disagree on the small chain")

    print(json.dumps({"kernels": [{
        "name": "nn1", "route": "cuda",
        "source": "tpu_joints_torch/neighbors/csrc/nn1.cu",
        "replaces": "tpu_joints/neighbors/pallas_knn.py:37",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_kernel, "plain_ms": ms_plain}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
