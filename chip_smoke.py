#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its paths on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR

``--against DIR`` also holds another version of the kernels against this
one: DIR (a scratch directory, for example a revision's
``tpu_joints_torch/neighbors/csrc`` written out with ``git archive``) holds
its ``nn1.cu`` and ``knnk.cu`` and any headers they include. They are
built into DIR with this tree's flags in phase 2, beside this tree's
(ptxas's register and spill report of both is printed), checked bit for bit
against the plain version at every timed shape and timed there in turns
with this tree's kernels (other, this, this, other).

Phases (any failure raises and the exit code is non-zero):
  1. device  — card name and power limit (nvidia-smi);
  2. build   — compiles kernels K1 (nn1.cu) and K2 (knnk.cu, both with
               the shared knn_split.cuh) from the checkout, one nvcc each,
               started together (with --against, the other version's too);
  3. kernels — K1 and K2 against their plain PyTorch versions on the card,
               bit for bit, at the paths' shapes, at edge cases, at the
               orders and ties that stress the split sweep and the lane merge
               and at shapes that straddle the split (the inputs of
               tpu_joints_torch/neighbors/knn_cases.py); K1 timed at its
               three path shapes (ICP, both coverage tiers);
  4. bank    — the 42-view SHOT bank of bench.py built on the card: K2
               launches counted (the k=16 normals, one per view), every
               launch's inputs rechecked against the plain version, and K2
               timed on the first launch's inputs at 1024 and 2048 lanes;
  5. organized path — detect_organized on a 640×480 frame of the bench
               joint with bench.py's scene_latency config: K1 launches (by
               shape) and host syncs over one run (none allowed), latency
               over 10 runs, gate < 1° / < 5 mm, and the same chain at small
               size against the CPU path;
  6. generic path — detect on the same frame's points as an unorganized
               2560-point cloud (the CLI's recipe) with the SHOT_demo-shaped
               config: K1 and K2 launches and host syncs over one run (syncs
               must equal the region-growing schedule's reads), every K2
               launch rechecked, K2 timed at the region-growing and
               clustered-OBB shapes against its plain version and
               cdist+topk, latency over 10 runs, the gate, and the same path
               at small size against the CPU path;
  7. segmented organized path — detect_organized on the same pose's frame
               with the workshop table behind the joint and bench.py's
               scene_latency_segmented config (RANSAC plane removal, lattice
               region growing and the curvature filter on the 120×160 tile
               lattice): K1 and K2 launches and host syncs over one run
               (syncs must equal the lattice region growing's reads),
               latency over 10 runs, the gate, and the same chain at small
               size against the CPU path;
  8. two-part path — the {chord, stub} part banks of bench.py built on the
               card (84 K2 launches, every launch's inputs rechecked), their
               concatenation and shared-CAD check made once, then
               detect_parts_organized on the table frame with bench.py's
               scene_latency_two_part config: launches, host syncs (again
               the lattice region growing's reads), latency over 10 runs,
               the gate, the winning part, and the candidate field at small
               size against the CPU path.
Every timing gives the kernel, its plain version and cdist+topk (CUDA
events and profiler device time) beside the bound and the shape's launches
per bank build, organized frame and generic frame. The kernels JSON line
(per kernel: its main shape's numbers, and "timings" for every timed shape)
and then the card's nvidia-smi name and power limit come before the last
line, which is the JSON result.
"""
import argparse
import collections
import ctypes
import dataclasses
import json
import math
import statistics
import subprocess
import time
import warnings
from pathlib import Path

# H100 SXM published peaks at 700 W (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _err(T, G):
    import numpy as np

    Rd = T[:3, :3] @ G[:3, :3].T
    rot = math.degrees(math.acos(float(np.clip((np.trace(Rd) - 1) / 2, -1, 1))))
    return rot, float(np.linalg.norm(T[:3, 3] - G[:3, 3]))


def _event_ms(fn, reps=20):
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


def _device_ms(fn, reps=20):
    """Device time per call of ``fn``: the profiler's sum of kernel time
    over ``reps`` calls (host launch gaps excluded), after one warm-up. A
    profile that caught no device time at all is taken again, up to three
    times, then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages())
        if us > 0:
            return us / reps / 1000.0
    raise RuntimeError("the profiler caught no device time in three tries")


def _bound(M, N, n_valid, k):
    """(ms, what bounds it): the least time the card could take for an
    exact kNN of M queries over N sources of which n_valid are valid — each
    input read once (query xyz, the N mask bytes and the valid sources'
    xyz, float32), each output written once (float32 + int32 per slot), 9
    fp32 flops per (query, valid source) pair for the difference-form
    distance (a masked source can never enter a list) — at the published
    peaks."""
    t_bytes = (12 * M + N + 12 * n_valid + 8 * M * k) / HBM_BYTES_PER_S
    t_ops = 9 * M * n_valid / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _start_other_build(other):
    """Start one nvcc per source, all together, with this tree's flags and
    ptxas's report: the other version's nn1.cu and knnk.cu into ``other``,
    and this tree's again for the report alone. Returns the jobs."""
    from tpu_joints_torch.neighbors import pallas_knn as pk

    jobs = []
    for tag, csrc in (("other", other), ("this", pk._CSRC)):
        for name in pk._ENTRY:
            out = other / f"{tag}_{name}.so"
            cmd = [pk._nvcc(), *pk._NVCC_FLAGS, "-Xptxas", "-v", "-o",
                   str(out), str(csrc / f"{name}.cu")]
            jobs.append((tag, name, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    return jobs


def _finish_other_build(jobs, card):
    """Wait for the builds of ``_start_other_build``, print ptxas's
    register and spill lines, and bind the other version's C entry points:
    {"nn1": fn, "knnk": fn}. Raises with the compiler's output."""
    from tpu_joints_torch.neighbors import pallas_knn as pk

    other = {}
    for tag, name, out, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {tag} {name}.cu:\n"
                               f"{stdout}\n{stderr}")
        for line in (stdout + stderr).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"# ptxas {tag} {name}.cu: {line.strip()} {card}",
                      flush=True)
        if tag == "other":
            entry, argtypes = pk._ENTRY[name]
            fn = getattr(ctypes.CDLL(str(out)), entry)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
            other[name] = fn
    return other


def _other_call(fn, q, s, m, k):
    """Launch the other version's kernel through its C entry point, on
    contiguous inputs: the paths hand the kernels strided views (the
    coverage's stride-sampled model), which only the wrapper copies."""
    import torch

    q, s, m = q.contiguous(), s.contiguous(), m.contiguous()
    M = q.shape[0]
    d = torch.empty((M, k), dtype=torch.float32, device=q.device)
    i = torch.empty((M, k), dtype=torch.int32, device=q.device)
    args = [q.data_ptr(), s.data_ptr(), m.view(torch.uint8).data_ptr(),
            d.data_ptr(), i.data_ptr(), M, s.shape[0]] + ([k] if k > 1 else [])
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the other version's launch failed: cudaError_t {rc}")
    return d, i


def _time_knn(pk, q, s, m, k, card, label, other=None):
    """CUDA-event and profiler times of K1 (k = 1) or K2, its plain
    version and cdist+topk (two PyTorch calls, unmasked) on the same inputs,
    as one row of the kernels line. With ``other`` (the other version's
    entry points), that version is first held against the plain version bit
    for bit, then timed in turns with this one: other, this, this, other;
    the row gives each one's median."""
    import torch

    if m is None:
        m = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    if k == 1:
        kernel, plain = pk.nn1, pk.nn1_reference
    else:
        def kernel(a, b, c):
            return pk.knnk(a, b, k, c)

        def plain(a, b, c):
            return pk.knnk_reference(a, b, k, c)
    fns = {"kernel": lambda: kernel(q, s, m),
           "plain": lambda: plain(q, s, m),
           "cdist+topk": lambda: torch.cdist(q, s).topk(k, largest=False)}
    order = list(fns)
    if other is not None:
        fn = other["nn1" if k == 1 else "knnk"]
        fns["other"] = lambda: _other_call(fn, q, s, m, k)
        (d, i), (dr, ir) = fns["other"](), fns["plain"]()
        if not (torch.equal(d, dr) and torch.equal(i, ir)):
            raise RuntimeError(f"the other version disagrees with the plain "
                               f"version ({label})")
        order = ["other", "kernel", "kernel", "other", "plain", "cdist+topk"]
    ev, dv = collections.defaultdict(list), collections.defaultdict(list)
    for n in order:
        ev[n].append(_event_ms(fns[n]))
        dv[n].append(_device_ms(fns[n]))
    n_valid = int(m.sum())
    bound_ms, bound_by = _bound(q.shape[0], s.shape[0], n_valid, k)
    print(f"# timing {label} {q.shape[0]}x{s.shape[0]} k={k} ({n_valid} of "
          f"{s.shape[0]} sources valid): median of 20 CUDA-event runs, ms: "
          + ", ".join(f"{n} " + " ".join(f"{v:.4f}" for v in vs)
                      for n, vs in ev.items())
          + "; device time per call (profiler, 20 calls), ms: "
          + ", ".join(f"{n} " + " ".join(f"{v:.4f}" for v in vs)
                      for n, vs in dv.items())
          + f"; bound {bound_ms:.5f} ms ({bound_by}) {card}", flush=True)
    row = {"shape": [q.shape[0], s.shape[0], k], "label": label,
           "n_valid": n_valid, "ms": statistics.median(ev["kernel"]),
           "dev_ms": statistics.median(dv["kernel"]),
           "plain_ms": ev["plain"][0], "plain_dev_ms": dv["plain"][0],
           "cdist_topk_ms": ev["cdist+topk"][0],
           "cdist_topk_dev_ms": dv["cdist+topk"][0], "bound_ms": bound_ms,
           "bound_by": bound_by}
    if other is not None:
        row.update(other_ms=statistics.median(ev["other"]),
                   other_dev_ms=statistics.median(dv["other"]))
    return row


class _Recorder:
    """Wraps ``bruteforce.nn1`` and ``bruteforce.knnk`` (K1's and K2's
    entries from ``knn``) and keeps every call's inputs as (query, source,
    k, mask), so each launch of a path can be rechecked and timed
    afterwards. It launches nothing itself: the wrapped functions count the
    launches."""

    def __init__(self, bruteforce):
        self.bf, self.calls = bruteforce, []
        self.real = (bruteforce.nn1, bruteforce.knnk)

    def nn1(self, query, source, source_mask=None):
        self.calls.append((query, source, 1, source_mask))
        return self.real[0](query, source, source_mask)

    def knnk(self, query, source, k, source_mask=None):
        self.calls.append((query, source, k, source_mask))
        return self.real[1](query, source, k, source_mask)

    def k2_calls(self):
        return [c for c in self.calls if c[2] > 1]

    def shapes(self):
        """Launches by shape: {(M, N, k): count}."""
        return collections.Counter((q.shape[0], s.shape[0], k)
                                   for q, s, k, _ in self.calls)

    def __enter__(self):
        self.bf.nn1, self.bf.knnk = self.nn1, self.knnk
        return self

    def __exit__(self, *exc):
        self.bf.nn1, self.bf.knnk = self.real


def _check_knn(pk, q, s, k, m, label, card):
    """K1 (k = 1) or K2 against its plain version on the same card inputs:
    equal bit for bit (``torch.equal`` on distances and indices, so 0 index
    mismatches and 0.0 distance difference), ascending rows."""
    import torch

    if k == 1:
        (d, i), (dr, ir) = pk.nn1(q, s, m), pk.nn1_reference(q, s, m)
    else:
        (d, i), (dr, ir) = pk.knnk(q, s, k, m), pk.knnk_reference(q, s, k, m)
    torch.cuda.synchronize()
    mism = int((i != ir).sum())
    err = float((d - dr).abs().max()) if d.numel() else 0.0
    print(f"# K{min(k, 2)} {q.shape[0]}x{s.shape[0]} k={k} ({label}): index "
          f"mismatches {mism}, max |dist diff| {err:.3e} {card}", flush=True)
    if not (torch.equal(d, dr) and torch.equal(i, ir)) \
            or not bool((d[:, 1:] >= d[:, :-1]).all()):
        raise RuntimeError(f"{'nn1' if k == 1 else 'knnk'} disagrees with its "
                           f"plain version ({label})")
    return err


def _small_runs(dev, det_cfg, gen_cfg, seg_cfg, two_cfg, T_gt, card):
    """The organized, generic and segmented paths at small size (320×240
    frame, level-0 bank) on the card and on the CPU (plain versions): poses
    within 2e-3, both accepted, both within the gate. The two-part path at
    that size finds no acceptable pose on either device (most Hough peaks
    rest on 3-5 matches), so there the candidate field is held equal: the
    views and their validity, each half its own part's."""
    import numpy as np
    import torch

    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.config import DetectionConfig
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.pipelines.detect import detect, detect_organized
    from tpu_joints_torch.pipelines.multi import detect_parts_organized

    def small(cfg, capacity):
        return DetectionConfig(**{**dataclasses.asdict(cfg), "scene_ss": 0.03,
                                  "final_icp_iterations": 8,
                                  "scene_capacity": capacity,
                                  "scene_key_capacity": 256})

    s_org, s_gen = small(det_cfg, 3072), small(gen_cfg, 3072)
    s_seg, s_two = small(seg_cfg, 3072), small(two_cfg, 3072)
    model_s = syn.joint_model(3000, 1800)
    kw = dict(syn.bench_bank_kwargs(s_org), level=0, resolution=64,
              key_capacity=64, icp_capacity=1024)
    xs, vs = syn.frame(T_gt, 42, with_table=False, width=320, height=240)
    xt, vt = syn.frame(T_gt, 42, with_table=True, width=320, height=240)
    pts = syn.scene_points(xs[vs], 3072)
    out = {"organized": {}, "generic": {}, "segmented": {}}
    two = {}
    for d in (dev, torch.device("cpu")):
        b = build_bank(model_s, **kw, device=d)
        geo = dict(block=2, half_window=3,
                   crop_lo=torch.as_tensor(syn.CROP_LO, device=d),
                   crop_hi=torch.as_tensor(syn.CROP_HI, device=d))
        r, _ = detect_organized(torch.as_tensor(xs, device=d),
                                torch.as_tensor(vs, device=d), b, s_org, **geo)
        out["organized"][d.type] = r
        r = detect(make_cloud(pts, capacity=3072, device=d), b, s_gen)
        out["generic"][d.type] = r
        table = (torch.as_tensor(xt, device=d), torch.as_tensor(vt, device=d))
        r, _ = detect_organized(*table, b, s_seg, **geo)
        out["segmented"][d.type] = r
        parts = syn.build_part_banks(s_two, device=d, level=0, resolution=64,
                                     key_capacity=64, icp_capacity=1024)
        _, two[d.type], _ = detect_parts_organized(*table, parts, s_two, **geo)
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
    views = {k: r.cand_views.cpu() for k, r in two.items()}
    ok = {k: r.cand_valid.cpu() for k, r in two.items()}
    half = views["cuda"].shape[0] // 2
    print(f"# two-part path small 320x240, card vs CPU (plain versions): "
          f"candidate views {views['cuda'].tolist()} vs "
          f"{views['cpu'].tolist()}, {int(ok['cuda'].sum())} vs "
          f"{int(ok['cpu'].sum())} valid, accepted "
          f"{bool(two['cuda'].accepted)} vs {bool(two['cpu'].accepted)} {card}",
          flush=True)
    if not (torch.equal(views["cuda"], views["cpu"])
            and torch.equal(ok["cuda"], ok["cpu"])
            and bool((views["cuda"][:half] < 12).all())
            and bool((views["cuda"][half:] >= 12).all())):
        raise RuntimeError("card and CPU disagree on the small two-part "
                           "candidate field")


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
    and the flagged host synchronisations, each with the Python line that
    made it."""
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
    return out, [f"{str(w.message).splitlines()[0]} [{w.filename}:{w.lineno}]"
                 for w in caught if "synchroniz" in str(w.message)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, metavar="DIR",
                    help="directory with another version's nn1.cu and "
                         "knnk.cu, timed in turns with this tree's")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    from tpu_joints_torch import synthetic as syn
    from tpu_joints_torch.core.cloud import make_cloud
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.neighbors import bruteforce
    from tpu_joints_torch.neighbors import knn_cases
    from tpu_joints_torch.neighbors import pallas_knn as pk
    from tpu_joints_torch.pipelines import multi
    from tpu_joints_torch.pipelines.detect import detect, detect_organized
    from tpu_joints_torch.segment import organized as lattice
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
    jobs = _start_other_build(args.against) if args.against else None
    pk.build_all()
    print(f"# phase 2 build: nn1.cu and knnk.cu compiled (in parallel) and "
          f"bound in {time.perf_counter() - t0:.3f} s {card}", flush=True)
    other = _finish_other_build(jobs, card) if jobs else None
    if other:
        print(f"# phase 2 build: the other version ({args.against}) and "
              f"ptxas's report done in {time.perf_counter() - t0:.3f} s {card}",
              flush=True)

    # --- phase 3: kernels vs plain versions on the card --------------------
    g = torch.Generator().manual_seed(0)

    def pts(n):
        return torch.randn(n, 3, generator=g).to(dev)

    def msk(n, masked):
        return (torch.rand(n, generator=g) >= masked).to(dev)

    max_err = {1: 0.0, 2: 0.0}        # K1, K2

    def check(q, s, k, m, label):
        max_err[min(k, 2)] = max(max_err[min(k, 2)],
                                 _check_knn(pk, q, s, k, m, label, card))

    for M, N, masked, label in [(8192, 2560, 0.0, "ICP"),
                                (40960, 2048, 0.0, "tier-1 coverage"),
                                (10240, 4096, 0.0, "tier-2 coverage"),
                                (70, 100, 0.25, "25% of sources masked"),
                                (5000, 3333, 0.1, "N not a multiple of the tile"),
                                (64, 256, 1.0, "all sources masked")]:
        check(pts(M), pts(N), 1, msk(N, masked), label)
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
        check(q, s, k, m, label)
        if label == "N < k" or masked == 1.0:
            d, i = pk.knnk(q, s, k, m)
            empty = slice(N, None) if masked < 1.0 else slice(None)
            if not (bool((d[:, empty] == np.float32(3e38)).all())
                    and bool((i[:, empty] == 0).all())):
                raise RuntimeError(f"knnk empty slots are not (3e38, 0) ({label})")
    # exact ties: every source twice, queries on sources; the lower index wins
    s = pts(512).repeat(2, 1)
    q = torch.cat([s[:256], pts(256)])
    check(q, s, 16, msk(1024, 0.0), "duplicated sources, exact ties")
    d, i = pk.knnk(q, s, 16, None)
    if not bool((i[:256, 0] == torch.arange(256, device=dev)).all()):
        raise RuntimeError("knnk does not break exact ties to the lowest index")
    # orders and sizes that stress the split sweep and the lane merge, for
    # both kernels (sources approaching every query in scan order, all
    # distances tied, a masked twin before each valid source, N = 1, N < k,
    # N = 33), then M around a warp and N around a 32-lane split, and the
    # clustered OBB's shape with 90% of the sources masked
    def on_card(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    for name, case in sorted(knn_cases.CASES.items()):
        for k in (1, 2, 16, 32):
            q, s, m = on_card(case(k))
            check(q, s, k, m, f"{name}, k = {k}")
    for M, N, k, masked in knn_cases.STRADDLE:
        q, s, m = on_card(knn_cases.straddle(M, N, k, masked))
        for kk in (1, k):
            check(q, s, kk, m, f"straddling the split, {masked:.0%} masked")
    timings = {1: [], 2: []}
    for M, N, label in [(8192, 2560, "ICP"), (40960, 2048, "tier-1 coverage"),
                        (10240, 4096, "tier-2 coverage")]:
        timings[1].append(_time_knn(pk, pts(M), pts(N), msk(N, 0.0), 1, card,
                                    f"phase 3 K1 ({label} shape)", other))

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
    launches = {"bank": rec.shapes()}
    print(f"# phase 4 bank: {bank.n_views} views, desc {tuple(bank.desc.shape)}, "
          f"view capacity Nv {bank.view_xyz.shape[1]}, "
          f"{int(bank.key_valid.sum())} valid keys, built in {bank_s:.2f} s; "
          f"K2 launched {bank_k2} times; launches by shape (M, N, k): "
          f"{dict(sorted(launches['bank'].items()))} {card}", flush=True)
    bank_calls = rec.k2_calls()
    if bank_k2 != bank.n_views or len(bank_calls) != bank_k2:
        raise RuntimeError(f"bank build launched K2 {bank_k2} times, expected "
                           f"one per view ({bank.n_views})")
    for n, (q, s, k, m) in enumerate(bank_calls):
        check(q, s, k, m, f"bank view {n} normals")
    for M in (1024, 2048):
        q, s, k, m = next(c for c in bank_calls if c[0].shape[0] == M)
        timings[2].append(_time_knn(pk, q, s, m, k, card,
                                    f"phase 4 K2 (bank normals, {M} lanes)",
                                    other))

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
    with _Recorder(bruteforce) as rec:
        (res, n_sel), syncs = _count_syncs(run_org)
    org_k1, org_k2 = pk.nn1.launches, pk.knnk.launches
    launches["organized"] = rec.shapes()
    print(f"# phase 5 organized path: nn1 launched {org_k1} times, knnk "
          f"{org_k2} times in one detect_organized; launches by shape (M, N, "
          f"k): {dict(sorted(launches['organized'].items()))}; host "
          f"synchronisations flagged: {len(syncs)} {card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    if org_k1 == 0 or org_k2 != 0:
        raise RuntimeError(f"the organized path launched K1 {org_k1} and K2 "
                           f"{org_k2} times; expected K1 >= 1 and K2 = 0")
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
    launches["generic"] = rec.shapes()
    gen_calls = rec.k2_calls()
    print(f"# phase 6 generic path ({int(scene.mask.sum())} points): nn1 "
          f"launched {gen_k1} times, knnk {gen_k2} times in one detect; "
          f"launches by shape (M, N, k): "
          f"{dict(sorted(launches['generic'].items()))}; host "
          f"synchronisations flagged: {len(syncs)}, region-growing host reads "
          f"(one per 8 sweeps): {checks} {card}", flush=True)
    for msg in sorted(set(syncs))[:5]:
        print(f"#   sync: {msg}", flush=True)
    if gen_k1 == 0 or gen_k2 != 4 or len(gen_calls) != 4:
        raise RuntimeError(f"the generic path launched K1 {gen_k1} and K2 "
                           f"{gen_k2} times; expected K1 >= 1 and K2 = 4")
    if len(syncs) != checks:
        raise RuntimeError(f"{len(syncs)} host syncs flagged, but the region "
                           f"growing schedule reads {checks} times")
    labels = ["scene normals", "region-growing graph", "clustered-OBB normals",
              "clustered-OBB graph"]
    for (q, s, k, m), label in zip(gen_calls, labels):
        check(q, s, k, m, label)
    q, s, k, m = gen_calls[1]
    timings[2].append(_time_knn(pk, q, s, m, k, card,
                                "phase 6 K2 (region-growing graph)", other))
    q, s, k, m = gen_calls[3]
    nv = q.shape[0]
    check(pts(nv), pts(nv), k, msk(nv, 0.3), "OBB shape, random points")
    timings[2].append(_time_knn(pk, q, s, m, k, card,
                                "phase 6 K2 (clustered-OBB graph)", other))
    res, times = _timed_runs(run_gen)
    _gate("phase 6 generic 640x480", res, T_gt, times, card,
          f"scene points after the crop {int(res.metrics['scene_points'])}, ")

    # --- phase 7: the segmented organized path ----------------------------
    seg_cfg = syn.segmented_config()
    tab_h, tab_valid_h = syn.frame(T_gt, 42, with_table=True)
    tab_img = torch.as_tensor(tab_h, device=dev)
    tab_valid = torch.as_tensor(tab_valid_h, device=dev)

    def run_seg():
        return detect_organized(tab_img, tab_valid, bank, seg_cfg, block=4,
                                half_window=5, crop_lo=lo, crop_hi=hi)

    def counted(label, run, want_k2):
        """One run of a lattice-cropped path with launches, syncs and the
        lattice region growing's reads counted and held to each other."""
        pk.nn1.launches = pk.knnk.launches = 0
        lattice.region_growing_lattice.host_checks = 0
        with _Recorder(bruteforce) as rec:
            out, syncs = _count_syncs(run)
        k1, k2 = pk.nn1.launches, pk.knnk.launches
        reads = lattice.region_growing_lattice.host_checks
        print(f"# {label}: nn1 launched {k1} times, knnk {k2} times in one "
              f"run; launches by shape (M, N, k): "
              f"{dict(sorted(rec.shapes().items()))}; host synchronisations "
              f"flagged: {len(syncs)}, lattice region-growing host reads (one "
              f"per {lattice.SWEEPS_PER_CHECK} sweeps): {reads} {card}",
              flush=True)
        for msg in sorted(set(syncs))[:5]:
            print(f"#   sync: {msg}", flush=True)
        if k1 == 0 or k2 != want_k2:
            raise RuntimeError(f"{label} launched K1 {k1} and K2 {k2} times; "
                               f"expected K1 >= 1 and K2 = {want_k2}")
        if len(syncs) != reads:
            raise RuntimeError(f"{len(syncs)} host syncs flagged, but the "
                               f"lattice region growing reads {reads} times")
        return out, rec.shapes(), k1

    _, launches["segmented"], seg_k1 = counted(
        "phase 7 segmented organized path", run_seg, 0)
    (res, n_sel), times = _timed_runs(run_seg)
    _gate("phase 7 segmented 640x480 with table", res, T_gt, times, card,
          f"n_selected {int(n_sel)} of "
          f"{int(res.metrics['scene_points'])} scene points, ")

    # --- phase 8: the two-part path ---------------------------------------
    two_cfg = syn.two_part_config()
    torch.cuda.synchronize()
    pk.knnk.launches = 0
    t0 = time.perf_counter()
    with _Recorder(bruteforce) as rec:
        part_banks = syn.build_part_banks(two_cfg, device=dev)
    torch.cuda.synchronize()
    parts_s = time.perf_counter() - t0
    parts_k2 = pk.knnk.launches
    launches["part banks"] = rec.shapes()
    n_part_views = sum(b.n_views for b in part_banks.values())
    print(f"# phase 8 part banks: {list(part_banks)}, {n_part_views} views, "
          f"view capacity Nv {part_banks['chord'].view_xyz.shape[1]}, built in "
          f"{parts_s:.2f} s; K2 launched {parts_k2} times; launches by shape "
          f"(M, N, k): {dict(sorted(launches['part banks'].items()))} {card}",
          flush=True)
    part_calls = rec.k2_calls()
    if parts_k2 != n_part_views or len(part_calls) != parts_k2:
        raise RuntimeError(f"the part banks launched K2 {parts_k2} times, "
                           f"expected one per view ({n_part_views})")
    for n, (q, s, k, m) in enumerate(part_calls):
        check(q, s, k, m, f"part-bank view {n} normals")
    # the concatenation and the shared-CAD check (a host read) happen here,
    # once per bank set; the frames below find them cached
    t0 = time.perf_counter()
    names, cat = multi._cat_for_parts(part_banks)
    torch.cuda.synchronize()
    print(f"# phase 8 concatenated bank: {cat.n_views} views, desc "
          f"{tuple(cat.desc.shape)}, made and checked in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms {card}", flush=True)

    def run_two():
        _, r, n = multi.detect_parts_organized(
            tab_img, tab_valid, part_banks, two_cfg, block=4, half_window=5,
            crop_lo=lo, crop_hi=hi)
        return r, n

    _, launches["two-part"], two_k1 = counted("phase 8 two-part path",
                                              run_two, 0)
    (res, n_sel), times = _timed_runs(run_two)
    Vp = cat.n_views // len(names)
    cand_parts = (res.cand_views // Vp).tolist()
    _gate("phase 8 two-part 640x480 with table", res, T_gt, times, card,
          f"winning part {names[int(res.view_idx) // Vp]}, candidates' parts "
          f"{cand_parts}, n_selected {int(n_sel)}, ")
    if cand_parts != sorted(cand_parts) or len(set(cand_parts)) != len(names):
        raise RuntimeError(f"the pooled field is not one slice per part: "
                           f"{cand_parts}")

    # --- the paths at small size, card vs CPU ------------------------------
    _small_runs(dev, det_cfg, gen_cfg, seg_cfg, two_cfg, T_gt, card)

    # the top-level numbers of each kernel are those of its main shape
    # (K1: ICP; K2: the region-growing graph) and its launches in phase 8
    # (K1: one two-part frame; K2: the part banks' build);
    # "launches_by_path" gives each path's own count, taken from 0 over one
    # run of it, and "timings" lists every shape with its launches per bank
    # build and per frame of each path
    for row in timings[1] + timings[2]:
        row["launches"] = {path: n[tuple(row["shape"])]
                           for path, n in launches.items()}
    main_row = {1: timings[1][0], 2: timings[2][2]}
    kernels = []
    by_path = {
        1: {"organized": org_k1, "generic": gen_k1, "segmented": seg_k1,
            "two-part": two_k1},
        2: {"bank": bank_k2, "organized": org_k2, "generic": gen_k2,
            "segmented": 0, "part banks": parts_k2, "two-part": 0}}
    for kk, name, line, n_launches in ((1, "nn1", 59, two_k1),
                                       (2, "knnk", 65, parts_k2)):
        row = main_row[kk]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpu_joints_torch/neighbors/csrc/{name}.cu",
            "replaces": f"tpu_joints/neighbors/pallas_knn.py:{line}",
            "launches": n_launches, "launches_by_path": by_path[kk],
            "max_abs_err": max_err[kk],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "cdist_topk_ms": row["cdist_topk_ms"],
            "timings": timings[kk]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
